"""Dataset readers: KITTI odometry/raw, EuRoC MAV, ADVIO-style streams.

Port of vil_fusion_tpu/runtime/datasets.py: the same events, bit for bit.
Replaces the reference's rosbag replay (README.md:40-48: kitti_08.bag at
half rate; EuRoC/ADVIO bags for the other rigs) with direct readers over the
published dataset layouts. Point clouds and CSVs go through the native C++
loaders (runtime/native.py); PNG images through runtime/imageio.py (the JAX
package uses PIL, which the port does not import). Deviation: a .jpg image
raises NotImplementedError (KittiOdometry.frame tries it last).

Each reader yields time-ordered sensor events:
    ("imu",   t, acc (3,), gyr (3,))
    ("image", t, img (H, W) float32 [0, 1])
    ("scan",  t, points (N, 3) float32, valid (N,))
so the pipeline consumes any dataset identically (push_imu/push_image/
push_scan).
"""
from __future__ import annotations

import os
import time
from typing import Iterator, Optional

import numpy as np

from vil_fusion_tpu_torch.runtime import imageio, native, transport


def _load_image(path: str) -> np.ndarray:
    """Images are returned as uint8: the tracker normalizes ON DEVICE
    (models/tracker.py), so keeping the sensor's 1-byte pixels on the host
    side quarters the per-frame host->device transfer."""
    if path.endswith(".pgm"):
        f = native.load_pgm(path)  # normalized f32 from the native loader
        return np.clip(f * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    if path.endswith(".png"):
        return imageio.read_grey(path)
    raise NotImplementedError(f"{path}: only PNG and PGM images are decoded")


class KittiOdometry:
    """KITTI odometry layout: sequences/NN/{velodyne/*.bin, image_0/*.png,
    times.txt, calib.txt}; ground truth poses/NN.txt."""

    def __init__(self, root: str, sequence: str = "07",
                 with_images: bool = True, max_scan_points: int = 140_000):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.times = np.loadtxt(os.path.join(self.seq_dir, "times.txt"))
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        self.img_dir = os.path.join(self.seq_dir, "image_0")
        self.with_images = with_images and os.path.isdir(self.img_dir)
        self.max_scan_points = max_scan_points
        self.poses_path = os.path.join(root, "poses", f"{sequence}.txt")

    def __len__(self):
        return len(self.times)

    def ground_truth(self):
        """(N, 3) positions + (N, 3, 3) rotations from poses file (cam0 frame)."""
        P = np.loadtxt(self.poses_path).reshape(-1, 3, 4)
        return P[:, :, 3], P[:, :, :3]

    def frame(self, i: int):
        scan_path = os.path.join(self.velo_dir, f"{i:06d}.bin")
        xyz, _ = native.load_kitti_bin(scan_path, self.max_scan_points)
        img = None
        if self.with_images:
            for ext in (".png", ".pgm", ".jpg"):
                p = os.path.join(self.img_dir, f"{i:06d}{ext}")
                if os.path.exists(p):
                    img = _load_image(p)
                    break
        return float(self.times[i]), xyz, img

    def events(self) -> Iterator[tuple]:
        """KITTI odometry has no IMU: emits scan (+image) per frame."""
        for i in range(len(self)):
            t, xyz, img = self.frame(i)
            valid = np.ones(len(xyz), bool)
            yield ("scan", t, xyz, valid)
            if img is not None:
                yield ("image", t, img)


class KittiRaw:
    """KITTI raw (synced) layout: <date>/<drive>/{velodyne_points, image_00,
    oxts} — oxts provides 100 Hz IMU."""

    def __init__(self, drive_dir: str, max_scan_points: int = 140_000):
        self.dir = drive_dir
        self.max_scan_points = max_scan_points
        self.velo_dir = os.path.join(drive_dir, "velodyne_points", "data")
        self.img_dir = os.path.join(drive_dir, "image_00", "data")
        self.oxts_dir = os.path.join(drive_dir, "oxts", "data")
        self.velo_ts = self._stamps(os.path.join(drive_dir, "velodyne_points", "timestamps.txt"))
        self.img_ts = self._stamps(os.path.join(drive_dir, "image_00", "timestamps.txt"))
        self.oxts_ts = self._stamps(os.path.join(drive_dir, "oxts", "timestamps.txt"))

    @staticmethod
    def _stamps(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                date, time_ = line.split(" ")
                h, m, s = time_.split(":")
                out.append(3600 * int(h) + 60 * int(m) + float(s))
        return np.asarray(out)

    def events(self) -> Iterator[tuple]:
        streams = []
        for i, t in enumerate(self.oxts_ts):
            streams.append((t, "imu", i))
        for i, t in enumerate(self.velo_ts):
            streams.append((t, "scan", i))
        for i, t in enumerate(self.img_ts):
            streams.append((t, "image", i))
        streams.sort()
        for t, kind, i in streams:
            if kind == "imu":
                row = np.loadtxt(os.path.join(self.oxts_dir, f"{i:010d}.txt"))
                # oxts fields: ax, ay, az at 11:14; wx, wy, wz at 17:20
                yield ("imu", t, row[11:14], row[17:20])
            elif kind == "scan":
                xyz, _ = native.load_kitti_bin(
                    os.path.join(self.velo_dir, f"{i:010d}.bin"), self.max_scan_points)
                yield ("scan", t, xyz, np.ones(len(xyz), bool))
            else:
                yield ("image", t, _load_image(os.path.join(self.img_dir, f"{i:010d}.png")))


class EuRoC:
    """EuRoC MAV layout: mav0/{cam0/data + data.csv, imu0/data.csv,
    state_groundtruth_estimate0/data.csv}."""

    def __init__(self, root: str):
        self.mav = os.path.join(root, "mav0")
        imu = native.load_csv_floats(
            os.path.join(self.mav, "imu0", "data.csv"), 7, skip_lines=1)
        self.imu_t = imu[:, 0] * 1e-9
        self.gyr = imu[:, 1:4]
        self.acc = imu[:, 4:7]
        cam_csv = os.path.join(self.mav, "cam0", "data.csv")
        rows = []
        with open(cam_csv) as f:
            next(f)
            for line in f:
                ts, name = line.strip().split(",")[:2]
                rows.append((int(ts) * 1e-9, name))
        self.cam = rows
        self.cam_dir = os.path.join(self.mav, "cam0", "data")

    def ground_truth(self):
        gt = native.load_csv_floats(
            os.path.join(self.mav, "state_groundtruth_estimate0", "data.csv"),
            8, skip_lines=1)
        return gt[:, 0] * 1e-9, gt[:, 1:4], gt[:, 4:8]  # t, p, q(wxyz)

    def events(self) -> Iterator[tuple]:
        streams = [(t, "imu", i) for i, t in enumerate(self.imu_t)]
        streams += [(t, "image", i) for i, (t, _) in enumerate(self.cam)]
        streams.sort()
        for t, kind, i in streams:
            if kind == "imu":
                yield ("imu", t, self.acc[i], self.gyr[i])
            else:
                yield ("image", t, _load_image(
                    os.path.join(self.cam_dir, self.cam[i][1])))


class ADVIO:
    """ADVIO layout (the mask-variant dataset, reference README.md:75-84:
    ADVIO-05 with the Mask-RCNN front end): advio-NN/iphone/{frames.csv,
    accelerometer.csv, gyro.csv, frames/ or frames.mov} and
    ground-truth/pose.csv.

    Accelerometer and gyro are sampled on separate clocks; like the
    reference's estimator-side bundling, the accelerometer is linearly
    interpolated onto the gyro timestamps to form unified IMU events.
    Images: extracted PNG frames under iphone/frames/ are used directly
    (frame NNNNN.png per frames.csv row); decoding frames.mov requires an
    external extraction step (no video decoder is assumed here).

    Optional masks (for mode="mask") live under iphone/masks/ with the same
    numbering; absent masks yield mask=None (plain VIO)."""

    def __init__(self, root: str):
        self.root = root
        ip = os.path.join(root, "iphone")
        acc = np.loadtxt(os.path.join(ip, "accelerometer.csv"), delimiter=",")
        gyr = np.loadtxt(os.path.join(ip, "gyro.csv"), delimiter=",")
        self.imu_t = gyr[:, 0]
        self.gyr = gyr[:, 1:4]
        self.acc = np.stack([
            np.interp(self.imu_t, acc[:, 0], acc[:, 1 + k]) for k in range(3)
        ], axis=-1)
        frames = np.loadtxt(os.path.join(ip, "frames.csv"), delimiter=",")
        self.frame_t = frames[:, 0]
        self.frame_no = frames[:, 1].astype(int)
        self.frames_dir = os.path.join(ip, "frames")
        self.masks_dir = os.path.join(ip, "masks")

    def ground_truth(self):
        """(t, p (N,3), q (N,4) wxyz) from ground-truth/pose.csv
        (columns: time, x, y, z, qw, qx, qy, qz)."""
        gt = np.loadtxt(os.path.join(self.root, "ground-truth", "pose.csv"),
                        delimiter=",")
        return gt[:, 0], gt[:, 1:4], gt[:, 4:8]

    def _frame_path(self, d, no):
        for pat in (f"{no:05d}.png", f"{no:06d}.png", f"{no}.png"):
            p = os.path.join(d, pat)
            if os.path.exists(p):
                return p
        return None

    def events(self) -> Iterator[tuple]:
        streams = [(t, "imu", i) for i, t in enumerate(self.imu_t)]
        streams += [(t, "image", i) for i, t in enumerate(self.frame_t)]
        streams.sort()
        for t, kind, i in streams:
            if kind == "imu":
                yield ("imu", t, self.acc[i], self.gyr[i])
            else:
                p = self._frame_path(self.frames_dir, self.frame_no[i])
                if p is None:
                    continue  # frame not extracted
                img = _load_image(p)
                mp = self._frame_path(self.masks_dir, self.frame_no[i])
                if mp is not None:
                    yield ("image", t, img, _load_image(mp) > 0.5)
                else:
                    yield ("image", t, img)


def replay(pipeline, events: Iterator[tuple], max_events: Optional[int] = None,
           prefetch: bool = True, stats: Optional[dict] = None):
    """Drive a VILFusionPipeline from an event stream (the rosbag-play loop).
    With `prefetch` (default), dataset decode runs in a producer thread and
    events arrive through the native ring bus (runtime/transport.py) so disk
    IO overlaps device compute — the reference's topic transport between its
    four processes (launch/run_fusion.launch:13-36).

    `stats`, if given, receives the replay's layer metrics: events, wall
    seconds, and with `prefetch` the ring's dropped count (0 for a replay),
    the consumer's seconds waiting on the producer and the producer's mean
    and largest lead in events."""
    bus = None
    if prefetch:
        bus = transport.SensorBus().start(events, max_events)
        events = bus.subscribe()
        max_events = None
    n = 0
    # consecutive IMU events are handed over as one push_imu_batch: at
    # 200 Hz the per-sample python call overhead is ~4 ms per frame, pure
    # host tax on the replay loop (propagation semantics are per-sample
    # either way — see push_imu_batch)
    imu_pend: list = []

    def _flush_imu():
        if imu_pend:
            pipeline.push_imu_batch([e[1] for e in imu_pend],
                                    [e[2] for e in imu_pend],
                                    [e[3] for e in imu_pend])
            imu_pend.clear()

    t0 = time.perf_counter()
    try:
        for ev in events:
            kind = ev[0]
            if kind == "imu":
                if hasattr(pipeline, "push_imu_batch"):
                    imu_pend.append(ev)
                else:
                    pipeline.push_imu(ev[1], ev[2], ev[3])
            elif kind == "image":
                _flush_imu()
                pipeline.push_image(ev[1], ev[2],
                                    mask=ev[3] if len(ev) > 3 else None)
            elif kind == "scan":
                _flush_imu()
                pipeline.push_scan(ev[1], ev[2], ev[3])
            n += 1
            if max_events and n >= max_events:
                break
        _flush_imu()
        if hasattr(pipeline, "finalize"):
            pipeline.finalize()  # drain in-flight frames + loop queries
    finally:
        if bus is not None:
            bus.stop()
    if stats is not None:
        stats.update(events=n, wall_s=time.perf_counter() - t0)
        if bus is not None:
            stats.update(dropped=bus.topic.dropped(), wait_s=bus.wait_s,
                         lead_mean=bus.lead_sum / max(1, bus.delivered), lead_max=bus.lead_max)
    return pipeline


def write_kitti_odometry(root: str, sequence: str, times, scans, images=None, poses=None):
    """Write a sequence in the KITTI odometry layout that KittiOdometry reads:
    times.txt, velodyne/NNNNNN.bin (x y z reflectance float32, the points
    given, reflectance 0), image_0/NNNNNN.png (uint8 grey, the port's PNG
    encoder) and poses/NN.txt ((N, 3, 4) rows). `images` and `poses` may be
    None or shorter than the scans."""
    seq = os.path.join(root, "sequences", sequence)
    os.makedirs(os.path.join(seq, "velodyne"), exist_ok=True)
    np.savetxt(os.path.join(seq, "times.txt"), np.asarray(times, np.float64))
    for i, pts in enumerate(scans):
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        raw = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1)
        raw.tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
    if images is not None:
        os.makedirs(os.path.join(seq, "image_0"), exist_ok=True)
        for i, img in enumerate(images):
            imageio.write_png(os.path.join(seq, "image_0", f"{i:06d}.png"),
                              np.asarray(img, np.uint8))
    if poses is not None:
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        np.savetxt(os.path.join(root, "poses", f"{sequence}.txt"),
                   np.asarray(poses, np.float64).reshape(-1, 12))
