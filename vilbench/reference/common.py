"""What both followers share: the frames they sample, the odometry state they
keep before those frames, the scan's points as the reference reads them,
and the odometry check.

The reference follows the program from its own state: before each sampled
frame the harness keeps a copy of the lidar odometry's map and pose (a few
device copies; the copy of one state is about 0.6 MB). After the run the
reference (registration.align, float64) registers the frame's scan, taken
again from the drive, against that map from the state's constant-velocity
prediction, and holds against it both the pose the program delivered for
the frame and the pose its state carried to the next frame. The start (the
odometry's first pose, the identity) and the map's update, which the
following skips, are read as readings in `coverage`: the first delivered
pose and the delivered relative motion over ten frames against the
simulator's ground truth."""
from __future__ import annotations

import numpy as np
import torch

from vilbench.reference import registration as reg

SOURCE_POINTS = 6000  # scan points a registration moves (a stride over the valid ones)


def sample_frames(seed: int, first: int, span: int, samples: int, salt: int) -> list:
    rng = np.random.default_rng([int(seed) % (1 << 63), salt])
    offs = rng.choice(int(span), size=min(int(samples), int(span)), replace=False)
    return sorted(first + int(o) for o in offs)


def keep_odometry(state) -> dict:
    """A copy of the parts of a lidar odometry state the reference reads
    (device copies, enqueued in stream order: nothing waits)."""
    return dict(surf=state.surf_map.detach().clone(), surf_valid=state.surf_map_valid.clone(),
                q=state.q.detach().clone(), p=state.p.detach().clone(),
                q_prev=state.q_prev.detach().clone(), p_prev=state.p_prev.detach().clone())


def state_pose(snap: dict) -> tuple:
    return reg.pose(snap["q"].cpu().numpy(), snap["p"].cpu().numpy())


def scan_points(drive, f: int, rig: dict, device, n_max: int = SOURCE_POINTS):
    """Frame f's scan points (lidar frame) within the rig's range, at most
    `n_max` of them by an even stride, float64 on `device`."""
    pts, val = drive.scan(f)
    pts = np.asarray(pts, np.float64)
    r = np.linalg.norm(pts, axis=-1)
    keep = np.asarray(val, bool) & (r >= rig["lidar_min_range"]) & (r <= rig["lidar_max_range"])
    pts = pts[keep]
    step = max(1, -(-pts.shape[0] // n_max))
    return torch.as_tensor(pts[::step], device=device)


def register(snap: dict, src, arith) -> tuple:
    """Frame f's lidar pose in the odometry's world: its scan `src`
    registered against the kept map `snap` (the state before frame f), from
    the state's constant-velocity prediction."""
    cur = state_pose(snap)
    prev = reg.pose(snap["q_prev"].cpu().numpy(), snap["p_prev"].cpu().numpy())
    pred = reg.compose(cur, reg.compose(reg.inverse(prev), cur))
    tgt = snap["surf"][snap["surf_valid"]]
    T, _ = reg.align(src, tgt, pred, arith)
    return reg.host(T)


def lidar_extrinsic(config: dict) -> tuple:
    """T_bl: the lidar's pose in the IMU (body) frame, from the rig's
    camera-IMU (R_ic, t_ic) and lidar-camera (R_cl, t_cl) extrinsics."""
    r = config["rig"]
    R_ic, t_ic = np.asarray(r["R_ic"], np.float64), np.asarray(r["t_ic"], np.float64)
    R_cl, t_cl = np.asarray(r["R_cl"], np.float64), np.asarray(r["t_cl"], np.float64)
    return R_ic @ R_cl, R_ic @ t_cl + t_ic


def check(value: float, limits: dict, name: str) -> dict:
    return {"value": float(value), "limit": float(limits[name])}


class OdometryFollower:
    """Samples frames of the window and keeps the odometry's state before
    each frame it checks (`want`); `odometry()` checks them."""

    def __init__(self, pipe, drive, config, traffic, seed, first: int, around=(0, 1)):
        chk = traffic["check"]
        self.frames = sample_frames(seed, first + int(chk["first"]), int(chk["span"]),
                                    int(chk["samples"]), 0x5EED)
        self.around = around
        self.want = sorted({f + d for f in self.frames for d in around})
        self.pipe, self.drive, self.config = pipe, drive, config
        self.snaps: dict = {}
        self.program: dict = {}
        self.coverage: dict = {}
        self.first = first

    def before_frame(self, i: int):
        if i in self.want:
            self.snaps[i] = keep_odometry(self.pipe.lidar_state)

    def needs(self, pushed: int) -> bool:
        return pushed <= max(self.want)

    def detach(self):
        """Keep the program's delivered poses; drop the pipeline."""
        out = self.pipe.outputs
        for f in range(len(out.ts)):
            if abs(out.ts[f] - self.drive.t(f)) < 1e-6:
                self.program[f] = dict(lq=np.asarray(out.lidar_q[f], np.float64),
                                       lp=np.asarray(out.lidar_p[f], np.float64),
                                       q=np.asarray(out.vio_q[f], np.float64),
                                       p=np.asarray(out.vio_p[f], np.float64))
        self._detach_more()
        self.pipe = None

    def _detach_more(self):
        pass

    def lidar_truth(self, f: int) -> tuple:
        """Ground truth T_wl of frame f."""
        R, p = self.drive.pose(f)
        return reg.compose((R, p), lidar_extrinsic(self.config))

    def odometry(self, checked: list, control, gaps: dict, device) -> dict:
        """The odometry check at each frame of `checked` (each needs states
        kept before it and after it): the reference's registration (or,
        as the control, the same in `control` arithmetic) against the
        delivered pose and the pose carried to the next frame. Returns the
        reference's poses by frame."""
        rig = self.config["rig"]
        refs = {}
        for f in checked:
            a, b = self.snaps.get(f), self.snaps.get(f + 1)
            if a is None or b is None or f not in self.program:
                continue
            src = scan_points(self.drive, f, rig, device)
            ref = register(a, src, reg.FLOAT64)
            refs[f] = ref
            if control is not None:
                delivered = carried = register(a, src, control)
            else:
                prog = self.program[f]
                delivered = reg.pose(prog["lq"], prog["lp"])
                carried = state_pose(b)
            g = [reg.gaps(delivered, ref), reg.gaps(carried, ref)]
            gaps["odom_pose_gap_m"] = max(gaps["odom_pose_gap_m"], g[0][0], g[1][0])
            gaps["odom_rot_gap_deg"] = max(gaps["odom_rot_gap_deg"], g[0][1], g[1][1])
            self.per_frame.append(dict(f=f, odom=float(f"{max(g[0][0], g[1][0]):.3e}")))
        return refs

    def readings(self):
        """The start and the map's update, which the following skips, as
        readings: the first delivered lidar pose (the identity) and the
        largest gap of the delivered relative motion over ten frames to the
        ground truth's, over the sampled frames."""
        p0 = self.program.get(0)
        start = None if p0 is None else reg.gaps(reg.pose(p0["lq"], p0["lp"]),
                                                  (np.eye(3), np.zeros(3)))
        drift = 0.0
        for f in self.frames:
            a, b = self.program.get(f - 10), self.program.get(f)
            if a is None or b is None:
                continue
            rel = reg.compose(reg.inverse(reg.pose(a["lq"], a["lp"])), reg.pose(b["lq"], b["lp"]))
            true = reg.compose(reg.inverse(self.lidar_truth(f - 10)), self.lidar_truth(f))
            drift = max(drift, reg.gaps(rel, true)[0])
        return dict(start_gap=start, drift_10_frames_m=drift)
