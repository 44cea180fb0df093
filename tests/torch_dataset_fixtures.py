"""On-disk dataset fixtures for the port's reader tests (test_torch_datasets.py;
write_sim_kitti also in test_torch_cuda.py). The KITTI odometry, EuRoC and ADVIO trees are
those of tests/test_datasets.py, as functions of a directory; the KITTI raw
tree (oxts IMU rows, HH:MM:SS.sss stamps, PNG frames) and the simulator's
KITTI sequence are added here. PNG frames are written by PIL, as the
published datasets' encoders write them (adaptive row filters); PIL is
imported where a fixture writes one, so that the card tests, on a machine
without PIL, can use write_sim_kitti."""
import numpy as np


def kitti_odom(tmp_path):
    rng = np.random.default_rng(0)
    seq = tmp_path / "sequences" / "07"
    (seq / "velodyne").mkdir(parents=True)
    (seq / "image_0").mkdir()
    n = 4
    np.savetxt(seq / "times.txt", np.arange(n) * 0.1)
    for i in range(n):
        pts = rng.normal(size=(500, 4)).astype(np.float32)
        pts.tofile(seq / "velodyne" / f"{i:06d}.bin")
        img = (rng.random((60, 80)) * 255).astype(np.uint8)
        with open(seq / "image_0" / f"{i:06d}.pgm", "wb") as f:
            f.write(b"P5\n80 60\n255\n" + img.tobytes())
    poses = np.tile(np.eye(3, 4).reshape(-1), (n, 1))
    poses[:, 3] = np.arange(n) * 1.0  # x translation
    (tmp_path / "poses").mkdir()
    np.savetxt(tmp_path / "poses" / "07.txt", poses)
    return str(tmp_path)


def euroc(tmp_path):
    rng = np.random.default_rng(1)
    mav = tmp_path / "mav0"
    (mav / "imu0").mkdir(parents=True)
    (mav / "cam0" / "data").mkdir(parents=True)
    (mav / "state_groundtruth_estimate0").mkdir()
    t0 = 1_400_000_000_000_000_000
    with open(mav / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        for i in range(20):
            f.write(f"{t0 + i * 5_000_000},0.01,0.02,0.03,0.1,0.2,9.8\n")
    with open(mav / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp,filename\n")
        for i in range(2):
            ts = t0 + i * 50_000_000
            name = f"{ts}.pgm"
            f.write(f"{ts},{name}\n")
            img = (rng.random((48, 64)) * 255).astype(np.uint8)
            with open(mav / "cam0" / "data" / name, "wb") as g:
                g.write(b"P5\n64 48\n255\n" + img.tobytes())
    with open(mav / "state_groundtruth_estimate0" / "data.csv", "w") as f:
        f.write("#ts,px,py,pz,qw,qx,qy,qz\n")
        for i in range(5):
            f.write(f"{t0 + i * 10_000_000},{0.1 * i},0,0,1,0,0,0\n")
    return str(tmp_path)


def advio(tmp_path):
    """Separate acc/gyro clocks, extracted frames, one mask, pose.csv."""
    rng = np.random.default_rng(1)
    ip = tmp_path / "advio-05" / "iphone"
    (ip / "frames").mkdir(parents=True)
    (ip / "masks").mkdir()
    (tmp_path / "advio-05" / "ground-truth").mkdir()
    t0 = 100.0
    # gyro at 100 Hz, accelerometer at 125 Hz (different clocks)
    with open(ip / "gyro.csv", "w") as f:
        for i in range(20):
            f.write(f"{t0 + i * 0.01},{0.01 * i},0.02,0.03\n")
    with open(ip / "accelerometer.csv", "w") as f:
        for i in range(25):
            f.write(f"{t0 + i * 0.008},{0.1},{0.2},{9.8 + 0.01 * i}\n")
    from PIL import Image

    with open(ip / "frames.csv", "w") as f:
        for i in range(3):
            f.write(f"{t0 + 0.02 + i * 0.05},{i}\n")
            arr = (rng.random((48, 64)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(ip / "frames" / f"{i:05d}.png")
    mask = np.zeros((48, 64), np.uint8)
    mask[10:20, 10:20] = 255
    Image.fromarray(mask).save(ip / "masks" / "00001.png")
    with open(tmp_path / "advio-05" / "ground-truth" / "pose.csv", "w") as f:
        for i in range(5):
            f.write(f"{t0 + i * 0.1},{0.2 * i},0,0,1,0,0,0\n")
    return str(tmp_path / "advio-05")


def kitti_raw(tmp_path):
    """KITTI raw (synced) drive: 100 Hz oxts rows (30 fields), 10 Hz scans
    and RGB PNG frames on their own clocks, 'YYYY-MM-DD HH:MM:SS.sssssssss'
    stamps crossing a minute."""
    rng = np.random.default_rng(2)
    drive = tmp_path / "2011_09_26_drive_0001_sync"
    streams = {"oxts": (12, 0.01, 0.0), "velodyne_points": (3, 0.1, 0.004),
               "image_00": (3, 0.1, 0.012)}
    for name, (n, dt, off) in streams.items():
        (drive / name / "data").mkdir(parents=True)
        with open(drive / name / "timestamps.txt", "w") as f:
            for i in range(n):
                s = 59.95 + off + i * dt  # seconds into minute 02 of 13:02
                m, s = divmod(s, 60.0)
                f.write(f"2011-09-26 13:{2 + int(m):02d}:{s:012.9f}\n")
    from PIL import Image

    for i in range(12):
        np.savetxt(drive / "oxts" / "data" / f"{i:010d}.txt", rng.normal(size=(1, 30)))
    for i in range(3):
        rng.normal(size=(300, 4)).astype(np.float32).tofile(
            drive / "velodyne_points" / "data" / f"{i:010d}.bin")
        rgb = (rng.random((30, 40, 3)) * 255).astype(np.uint8)
        Image.fromarray(rgb).save(drive / "image_00" / "data" / f"{i:010d}.png")
    return str(drive)


def write_sim_kitti(root, sim, datasets, n, n_scan=16, width=900, fov_up=15.0,
                    fov_down=-25.0):
    """n simulator scans (RaycastScene, Trajectory(speed=2.0), 10 Hz, sensor
    1.5 m up, 1 cm range noise) as a KITTI odometry sequence "00" through
    the port's writer. Every scan keeps the full ray grid (misses at the
    origin, below the extractor's blind radius), so all files hold the same
    number of points. Returns the body positions relative to frame 0, in
    frame 0's axes."""
    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=2.0))
    ts, scans, poses = [], [], []
    for i in range(n):
        t = 1.0 + 0.1 * i
        R, p = traj.rotation(t), traj.position(t) + np.array([0, 0, 1.5])
        pts, _ = sim.simulate_lidar_scan(scene, R, p, n_scan=n_scan, width=width,
                                         fov_up_deg=fov_up, fov_down_deg=fov_down,
                                         range_noise=0.01, seed=i)
        ts.append(t)
        scans.append(pts)
        poses.append((R, p))
    R0, p0 = poses[0]
    rel = [np.concatenate([R0.T @ R, (R0.T @ (p - p0))[:, None]], 1) for R, p in poses]
    datasets.write_kitti_odometry(str(root), "00", ts, scans, poses=rel)
    return np.stack([r[:, 3] for r in rel])


def events_equal(a, b):
    """Two event lists equal element for element: kinds, times, dtypes,
    shapes and values."""
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert ea[0] == eb[0] and ea[1] == eb[1] and len(ea) == len(eb), (ea[:2], eb[:2])
        for x, y in zip(ea[2:], eb[2:]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (ea[:2], x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y)

