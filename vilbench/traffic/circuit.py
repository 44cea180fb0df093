"""The closed-circuit drive: one generator for every traffic file that names
`"generator": "circuit"`.

A traffic file gives the world (`scene`: urban_block_scene's radius and
angular steps), the route (`route`: a circular lap of `lap_frames` frames
at `frame_hz`, the speed modulation, bob, pitch and roll, each a whole
number of cycles a lap, so the lap closes exactly), how many laps of
LiDAR noise to draw (`noise_laps`) and the warm-up. The configuration file
gives the sensors (`scan`, `camera`, `imu`, `range_noise_m`) and their
mounting (the rig's camera-IMU and lidar-camera extrinsics): the LiDAR
renders from its own origin on the body, the camera from its own.

The noise-free renders of one lap (HDL-64 ranges and, for a camera rig,
uint8 images) and the noise-free IMU of one lap are made once on the run's
device with the frozen simulator (vilbench/sim) and cached under
`cache_dir`; later laps reuse them. The seed sets the IMU's white noise,
the LiDAR's range noise and, where the traffic file gives no
`start_frame`, the start frame on the lap. Frame i of a run is
lap frame (start + i) mod lap_frames, at stream time 1.0 + i / frame_hz;
its noisy scan is bank entry i mod (noise_laps * lap_frames), made in
set-up, so nothing is drawn inside the measured window. `noise_laps` is
sized so that no scan of a window repeats at twice the cell's present
rate.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from vilbench.sim import SOURCE_COMMIT
from vilbench.sim import sim

class PeriodicLoop(sim.LoopTrajectory):
    """sim.LoopTrajectory with every modulation a whole number of cycles a
    lap, so that the pose (and the IMU) at t and t + lap_s are equal."""

    def __init__(self, radius, lap_s, speed_mod, mod_cycles, bob_amp_m, bob_cycles,
                 pitch_amp_rad, pitch_cycles, roll_amp_rad, roll_cycles):
        super().__init__(radius=radius, period=lap_s, speed_mod=speed_mod,
                         mod_period=lap_s / mod_cycles, bob_amp=bob_amp_m,
                         bob_freq=bob_cycles / lap_s, laps=1.0)
        self.pitch = (pitch_amp_rad, 2 * np.pi * pitch_cycles / lap_s)
        self.roll = (roll_amp_rad, 2 * np.pi * roll_cycles / lap_s)

    def rotation(self, t):
        th = self._theta(t)
        yaw = np.arctan2(np.sin(th), np.cos(th))
        t = np.asarray(t, np.float64)
        return sim._ypr_to_R(yaw, self.pitch[0] * np.sin(self.pitch[1] * t),
                             self.roll[0] * np.sin(self.roll[1] * t))


def route(traffic: dict) -> PeriodicLoop:
    r = traffic["route"]
    lap_s = r["lap_frames"] / r["frame_hz"]
    return PeriodicLoop(traffic["scene"]["radius_m"], lap_s, r["speed_mod"], r["mod_cycles"],
                        r["bob_amp_m"], r["bob_cycles"], r["pitch_amp_rad"], r["pitch_cycles"],
                        r["roll_amp_rad"], r["roll_cycles"])


def _cache_key(traffic: dict, config: dict, what: str) -> str:
    r = config["rig"]
    spec = dict(what=what, sim=SOURCE_COMMIT, scene=traffic["scene"], route=traffic["route"],
                scan=config["scan"], camera=config.get("camera"), imu_hz=config["imu"]["rate_hz"],
                mount=[r["R_ic"], r["t_ic"], r["R_cl"], r["t_cl"]])
    return hashlib.sha1(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


def _cached(path: str, make):
    """np.load(path), or make() saved there first (written under a
    temporary name and renamed, so a cut run leaves no half file)."""
    if os.path.exists(path):
        return np.load(path)
    arr = make()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".part.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)
    return arr


class Drive:
    """A run's sensor stream: `frame(i)` for i = 0, 1, ... (the IMU of frame
    0 is empty), `pose(i)` its ground truth (R_wb, p_wb), `start_state()` the
    oracle's (p, q, v) at frame 0."""

    def __init__(self, traffic: dict, config: dict, seed: int, device, cache_dir: str):
        self.traffic, self.config = traffic, config
        r = traffic["route"]
        self.lap = int(r["lap_frames"])
        self.dt = 1.0 / r["frame_hz"]
        self.body_z = r["body_height_m"]
        self.traj = route(traffic)
        self.camera = config.get("camera")
        r = config["rig"]
        R_ic, t_ic = np.asarray(r["R_ic"], np.float64), np.asarray(r["t_ic"], np.float64)
        R_cl, t_cl = np.asarray(r["R_cl"], np.float64), np.asarray(r["t_cl"], np.float64)
        self.T_bc = (R_ic, t_ic)  # the camera's pose on the body
        self.T_bl = (R_ic @ R_cl, R_ic @ t_cl + t_ic)  # the LiDAR's
        dev = torch.device(device)
        rng = np.random.default_rng(int(seed) % (1 << 63))
        drawn = int(rng.integers(self.lap))
        fixed = traffic.get("start_frame")
        self.start = drawn if fixed is None else int(fixed) % self.lap
        scan = config["scan"]
        scene = None

        def raycaster():
            nonlocal scene
            if scene is None:
                sc = traffic["scene"]
                scene = sim.TorchRaycast(sim.urban_block_scene(
                    sc["radius_m"], pillar_step_deg=sc["pillar_step_deg"],
                    box_step_deg=sc["box_step_deg"]), device=dev)
            return scene

        def render_ranges():
            out = np.empty((self.lap, scan["n_scan"] * scan["width"]), np.float32)
            for k in range(self.lap):
                R, p = self._mounted(self._lap_pose(k), self.T_bl)
                out[k] = raycaster().scan_ranges_device(
                    R, p, scan["n_scan"], scan["width"], scan["fov_up_deg"],
                    scan["fov_down_deg"], max_range=scan["max_range"]).cpu().numpy()
            return out

        key = os.path.join(cache_dir, "{}.npy")
        ranges = _cached(key.format(_cache_key(traffic, config, "ranges")), render_ranges)
        self.images = None
        if self.camera is not None:
            c = self.camera

            def render_images():
                out = np.empty((self.lap, c["height"], c["width"]), np.uint8)
                for k in range(self.lap):
                    R, p = self._mounted(self._lap_pose(k), self.T_bc)
                    out[k] = raycaster().image_u8_device(
                        R, p, c["fx"], c["fy"], c["cx"], c["cy"], c["height"],
                        c["width"]).cpu().numpy()
                return out

            self.images = _cached(key.format(_cache_key(traffic, config, "images")),
                                  render_images)
        imu = config["imu"]
        self.imu_per_frame = int(round(imu["rate_hz"] * self.dt))
        lap_imu = _cached(key.format(_cache_key(traffic, config, "imu")), self._render_imu)
        self._lap_imu = lap_imu  # (lap, n, 6) noise-free acc, gyr
        # the noise of the bank: IMU white noise and biases, LiDAR ranges
        self.n_bank = int(traffic["noise_laps"]) * self.lap
        sq = np.sqrt(imu["rate_hz"])
        shape = (self.n_bank, self.imu_per_frame, 3)
        self.acc_noise = rng.normal(0.0, imu["acc_n"] * sq, shape) + np.asarray(imu["bias_a"])
        self.gyr_noise = rng.normal(0.0, imu["gyr_n"] * sq, shape) + np.asarray(imu["bias_g"])
        self.points, self.valid = self._noisy_scans(
            ranges, int(rng.integers(1 << 62)), config["range_noise_m"], dev)

    def _lap_pose(self, k):
        """(R_wb, p_wb) of lap frame k (float64)."""
        s = k * self.dt
        return self.traj.rotation(s), self.traj.position(s) + np.array([0.0, 0.0, self.body_z])

    @staticmethod
    def _mounted(T_wb, T_bs):
        """A sensor's pose in the world from the body's and its mounting."""
        return T_wb[0] @ T_bs[0], T_wb[0] @ T_bs[1] + T_wb[1]

    def _render_imu(self):
        """Noise-free (acc, gyr) of each lap frame's interval: the samples
        after the previous frame's time up to and including the frame's."""
        n = self.imu_per_frame
        out = np.empty((self.lap, n, 6), np.float64)
        for k in range(self.lap):
            for j in range(n):
                s = (k - 1) * self.dt + (j + 1) * self.dt / n
                out[k, j, :3], out[k, j, 3:] = self.traj.imu_sample(s)
        return out

    def _noisy_scans(self, ranges, seed: int, sigma: float, dev):
        """LiDAR-frame float32 points (n_bank, N, 3) and validity (n_bank, N)
        of the bank's scans: the lap's ranges plus N(0, sigma) noise drawn on
        `dev` from `seed`, times the ray grid (misses give (0, 0, 0))."""
        scan = self.config["scan"]
        dirs = torch.as_tensor(sim._lidar_dirs(scan["n_scan"], scan["width"], scan["fov_up_deg"],
                                               scan["fov_down_deg"]).astype(np.float32),
                               device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        n = ranges.shape[1]
        pts = np.empty((self.n_bank, n, 3), np.float32)
        val = np.empty((self.n_bank, n), bool)
        lap_ranges = torch.as_tensor(ranges, device=dev)
        chunk = 64
        for a in range(0, self.n_bank, chunk):
            b = min(a + chunk, self.n_bank)
            idx = torch.as_tensor([self._lap_index(i) for i in range(a, b)], device=dev)
            r = lap_ranges.index_select(0, idx)
            r = r + sigma * torch.randn(r.shape, generator=gen, device=dev)
            ok = torch.isfinite(r)
            p = dirs[None] * torch.where(ok, r, torch.zeros_like(r))[..., None]
            torch.from_numpy(pts[a:b]).copy_(p)
            torch.from_numpy(val[a:b]).copy_(ok)
        return pts, val

    def _lap_index(self, i: int) -> int:
        return (self.start + i) % self.lap

    def t(self, i: int) -> float:
        return 1.0 + i * self.dt

    def pose(self, i: int):
        """Ground truth (R_wb, p_wb) of frame i."""
        return self._lap_pose(self._lap_index(i))

    def start_state(self):
        """(p, q (w, x, y, z), v) of the body at frame 0."""
        s = self._lap_index(0) * self.dt
        R, p = self._lap_pose(self._lap_index(0))
        return p, sim.R_to_q(R), self.traj.velocity(s)

    def imu(self, i: int):
        """(ts, acc, gyr) of frame i's interval (float64), None for frame 0."""
        if i == 0:
            return None
        n = self.imu_per_frame
        ts = self.t(i - 1) + np.arange(1, n + 1) * (self.dt / n)
        raw = self._lap_imu[self._lap_index(i)]
        b = i % self.n_bank
        return ts, raw[:, :3] + self.acc_noise[b], raw[:, 3:] + self.gyr_noise[b]

    def scan(self, i: int):
        """(float32 points (N, 3), bool validity (N,)) of frame i."""
        b = i % self.n_bank
        return self.points[b], self.valid[b]

    def image(self, i: int):
        """uint8 (height, width) image of frame i (None without a camera)."""
        return None if self.images is None else self.images[self._lap_index(i)]


def make(traffic: dict, config: dict, seed: int, device, cache_dir: str) -> Drive:
    return Drive(traffic, config, seed, device, cache_dir)
