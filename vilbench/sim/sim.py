"""Synthetic multi-sensor trajectory simulator (ground-truth oracle for tests).

The reference validates only by rosbag replay (README.md:40-48); it ships zero
automated tests. This module replaces dataset replay for CI: an analytic
smooth trajectory generates exact IMU samples (body rates + specific force),
camera feature tracks with known depth, and LiDAR scans of a synthetic world,
all with known ground truth — so every estimator stage can be golden-tested.

Host-side numpy (float64) on purpose: this is test scaffolding, not the
compute path. This is vil_fusion_tpu/runtime/sim.py, carried over so that
the port needs no jax: the numpy part unchanged (LiDAR scenes, trajectories,
the IMU, landmark and scan simulators and the textured camera render), and
`TorchRaycast` in place of the reference's device raycaster `JaxRaycast`.
The numpy raycast loops over primitives on the host: on the KITTI-scale
circuit scene (`urban_block_scene(100.0, 4.0, 6.0)`, 296 primitives) an
HDL-64 scan takes ~4.6 s and a 1226 x 370 image ~20 s on one host core
(chip_smoke.py, phase 11a), so the circuit replay of
vil_fusion_tpu_torch/tools/run_synthetic.py renders on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

GRAVITY = np.array([0.0, 0.0, 9.81])


def _ypr_to_R(y, p, r):
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def R_to_q(R):
    """Rotation matrix -> (w, x, y, z), w >= 0."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


@dataclass
class TrajectoryConfig:
    """Smooth sinusoidal trajectory: forward motion + lateral/vertical sway + yaw."""

    speed: float = 2.0  # m/s forward
    sway_amp: float = 1.0
    sway_freq: float = 0.25  # Hz
    bob_amp: float = 0.3
    bob_freq: float = 0.4
    yaw_amp: float = 0.4  # rad
    yaw_freq: float = 0.1
    pitch_amp: float = 0.08
    pitch_freq: float = 0.3
    roll_amp: float = 0.06
    roll_freq: float = 0.35


class _TrajectoryBase:
    """Derivatives by central differences over analytic position/rotation."""

    def velocity(self, t, h=1e-5):
        return (self.position(t + h) - self.position(t - h)) / (2 * h)

    def acceleration(self, t, h=1e-4):
        return (self.position(t + h) - 2 * self.position(t) + self.position(t - h)) / (h * h)

    def angular_velocity_body(self, t, h=1e-5):
        """omega such that Rdot = R * skew(omega)."""
        R0 = self.rotation(t - h)
        R1 = self.rotation(t + h)
        Rdot = (R1 - R0) / (2 * h)
        W = self.rotation(t).T @ Rdot
        W = 0.5 * (W - W.T)
        return np.array([W[2, 1], W[0, 2], W[1, 0]])

    def imu_sample(self, t):
        """(acc_body, gyr_body): specific force f = R^T (a_world + G)."""
        R = self.rotation(t)
        acc = R.T @ (self.acceleration(t) + GRAVITY)
        gyr = self.angular_velocity_body(t)
        return acc, gyr

    def pose(self, t):
        """(q wxyz, p) at time t."""
        return R_to_q(self.rotation(t)), self.position(t)


class Trajectory(_TrajectoryBase):
    """Open corridor path: forward motion + lateral/vertical sway + yaw."""

    def __init__(self, cfg: TrajectoryConfig = TrajectoryConfig()):
        self.cfg = cfg

    def position(self, t):
        c = self.cfg
        t = np.asarray(t, dtype=np.float64)
        x = c.speed * t
        y = c.sway_amp * np.sin(2 * np.pi * c.sway_freq * t)
        z = c.bob_amp * np.sin(2 * np.pi * c.bob_freq * t)
        return np.stack([x, y, z], axis=-1)

    def rotation(self, t):
        c = self.cfg
        y = c.yaw_amp * np.sin(2 * np.pi * c.yaw_freq * t)
        p = c.pitch_amp * np.sin(2 * np.pi * c.pitch_freq * t)
        r = c.roll_amp * np.sin(2 * np.pi * c.roll_freq * t)
        return _ypr_to_R(y, p, r)


class LoopTrajectory(_TrajectoryBase):
    """Closed circular circuit with tangent-following yaw — the loop-closure
    path (the reference's KITTI-08-style revisit, README.md:47-55, in
    analytic form). Speed is modulated along the circuit so the IMU
    excitation check (initialStructure estimator.cpp:244-263 analog) passes
    on a cold start; mild bob adds vertical excitation."""

    def __init__(self, radius: float = 12.0, period: float = 35.0,
                 speed_mod: float = 0.25, mod_period: float = 7.0,
                 bob_amp: float = 0.12, bob_freq: float = 0.5,
                 laps: float = 10.0):
        self.radius = radius
        self.period = period
        self.speed_mod = speed_mod
        self.mod_period = mod_period
        self.bob_amp = bob_amp
        self.bob_freq = bob_freq
        self.laps = laps  # informational: callers run t in [0, laps*period)

    def _theta(self, t):
        return (2 * np.pi / self.period) * (
            np.asarray(t, np.float64)
            + self.speed_mod * self.mod_period / (2 * np.pi)
            * np.sin(2 * np.pi * np.asarray(t, np.float64) / self.mod_period))

    def position(self, t):
        th = self._theta(t)
        x = self.radius * np.sin(th)
        y = self.radius * (1.0 - np.cos(th))
        z = self.bob_amp * np.sin(2 * np.pi * self.bob_freq * np.asarray(t, np.float64))
        return np.stack([x, y, z], axis=-1)

    def rotation(self, t):
        # yaw follows the path tangent (d position / d theta direction)
        th = self._theta(t)
        yaw = np.arctan2(np.sin(th), np.cos(th))  # tangent of the circle
        return _ypr_to_R(yaw, 0.015 * np.sin(2.1 * np.asarray(t, np.float64)),
                         0.012 * np.sin(1.7 * np.asarray(t, np.float64)))


def urban_block_scene(radius: float = 12.0,
                      pillar_step_deg: float = 30.0,
                      box_step_deg: float = 45.0) -> "RaycastScene":
    """Structured world around a circular circuit of the given radius
    (center (0, radius)): pillar rings inside and outside the path, boxes at
    varied bearings (x- and y-facing planes for odometry observability),
    bounding walls and ground. The 'urban block' replay world.

    For KITTI-scale circuits (radius ~100 m, >=1 km laps) lower the angular
    steps so structure density along the path stays urban-like
    (pillar_step_deg ~ 4 keeps inter-pillar spacing ~7 m at r=100)."""
    scene = RaycastScene.__new__(RaycastScene)
    c = np.array([0.0, radius])
    scene.wall_y = 2 * radius + 16.0
    scene.wall_h = 6.0
    scene.x_lo, scene.x_hi = -(radius + 28.0), radius + 28.0
    scene.pillar_r = 0.3
    scene.pillar_h = 5.0
    ang = np.deg2rad(np.arange(0, 360, pillar_step_deg))
    inner = c + (radius - 6.0) * np.stack([np.sin(ang), -np.cos(ang)], -1)
    outer = c + (radius + 7.0) * np.stack([np.sin(ang + 0.26), -np.cos(ang + 0.26)], -1)
    scene.pillars = np.concatenate([inner, outer], axis=0)
    angb = np.deg2rad(np.arange(15, 360, box_step_deg))
    bc = c + (radius + 9.0) * np.stack([np.sin(angb), -np.cos(angb)], -1)
    bi = c + (radius - 8.0) * np.stack([np.sin(angb + 0.4), -np.cos(angb + 0.4)], -1)
    boxes = [[x, y, 1.2, 0.9, 2.5] for x, y in bc] + \
            [[x, y, 0.9, 1.3, 3.0] for x, y in bi]
    scene.boxes = np.asarray(boxes)
    return scene


def simulate_imu(traj, t0: float, t1: float, rate: float = 200.0,
                 noise=None, bias_a=None, bias_g=None, seed: int = 0):
    """Sample IMU between t0 and t1 at `rate` Hz (inclusive endpoints).

    Returns (ts, acc (N,3), gyr (N,3)); optionally adds white noise and
    constant biases (ImuNoise-style densities scaled by sqrt(rate)).
    """
    n = int(round((t1 - t0) * rate))
    ts = t0 + np.arange(n + 1) / rate
    acc = np.zeros((n + 1, 3))
    gyr = np.zeros((n + 1, 3))
    for i, t in enumerate(ts):
        acc[i], gyr[i] = traj.imu_sample(t)
    if bias_a is not None:
        acc += bias_a
    if bias_g is not None:
        gyr += bias_g
    if noise is not None:
        rng = np.random.default_rng(seed)
        acc += rng.normal(0, noise.acc_n * np.sqrt(rate), acc.shape)
        gyr += rng.normal(0, noise.gyr_n * np.sqrt(rate), gyr.shape)
    return ts, acc, gyr


@dataclass
class LandmarkWorld:
    """Random 3D landmarks in a corridor around the trajectory, for camera sim."""

    n: int = 500
    x_range: tuple = (-5.0, 120.0)
    y_range: tuple = (-12.0, 12.0)
    z_range: tuple = (-4.0, 8.0)
    seed: int = 0
    points: np.ndarray = field(init=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.points = np.stack(
            [
                rng.uniform(*self.x_range, self.n),
                rng.uniform(*self.y_range, self.n),
                rng.uniform(*self.z_range, self.n),
            ],
            axis=-1,
        )


def project_landmarks(world: LandmarkWorld, R_wb, p_wb, R_bc=np.eye(3), p_bc=np.zeros(3),
                      fov_deg: float = 90.0, min_depth: float = 0.5, max_depth: float = 80.0):
    """Project landmarks into a normalized-plane camera at body pose (R_wb, p_wb).

    Returns (ids, xy_normalized (M,2), depth (M,)). Camera frame: z forward.
    """
    R_wc = R_wb @ R_bc
    p_wc = R_wb @ p_bc + p_wb
    pc = (world.points - p_wc) @ R_wc  # (N, 3) in camera frame
    z = pc[:, 2]
    half_tan = np.tan(np.deg2rad(fov_deg) / 2)
    valid = (z > min_depth) & (z < max_depth)
    xy = pc[:, :2] / np.where(valid, z, 1.0)[:, None]
    valid &= (np.abs(xy[:, 0]) < half_tan) & (np.abs(xy[:, 1]) < half_tan)
    ids = np.nonzero(valid)[0]
    return ids, xy[valid], z[valid]


class RaycastScene:
    """Analytic structured world (ground + walls + cylindrical pillars) with
    exact ray intersection — produces dense, realistic spinning-LiDAR scans
    (planar structure on walls/ground, sharp edges on pillars)."""

    def __init__(self, wall_y: float = 12.0, wall_h: float = 6.0,
                 x_lo: float = -10.0, x_hi: float = 120.0,
                 pillar_r: float = 0.3, pillar_h: float = 5.0, seed: int = 0):
        self.wall_y = wall_y
        self.wall_h = wall_h
        self.x_lo, self.x_hi = x_lo, x_hi
        self.pillar_r = pillar_r
        self.pillar_h = pillar_h
        xs = np.arange(0, 12) * 10.0
        self.pillars = np.array([[x, s] for x in xs for s in (-8.0, 8.0)])
        # boxes give x-facing planes (without them forward translation is
        # unobservable from planar features in a straight corridor)
        self.boxes = np.array(  # (cx, cy, half_x, half_y, height)
            [[x, y, 1.0, 1.0, 2.5] for x in (15.0, 45.0, 75.0, 105.0) for y in (-5.0, 5.0)]
        )

    def raycast(self, origins, dirs, max_range=80.0):
        """origins (N,3), dirs (N,3) unit -> hit range t (N,), inf if miss."""
        n = len(dirs)
        t_best = np.full(n, np.inf)

        def consider(t, ok):
            nonlocal t_best
            t = np.where(ok & (t > 0.1) & (t < max_range), t, np.inf)
            t_best = np.minimum(t_best, t)

        o, d = origins, dirs
        # ground z=0
        with np.errstate(divide="ignore", invalid="ignore"):
            t = -o[:, 2] / d[:, 2]
            hit = o + t[:, None] * d
            consider(t, (d[:, 2] != 0) & (hit[:, 0] > self.x_lo) & (hit[:, 0] < self.x_hi)
                     & (np.abs(hit[:, 1]) < self.wall_y + 1e-6))
            # walls y = +-wall_y
            for wy in (self.wall_y, -self.wall_y):
                t = (wy - o[:, 1]) / d[:, 1]
                hit = o + t[:, None] * d
                consider(t, (d[:, 1] != 0) & (hit[:, 2] > 0) & (hit[:, 2] < self.wall_h)
                         & (hit[:, 0] > self.x_lo) & (hit[:, 0] < self.x_hi))
            # boxes: axis-aligned faces (x-faces, y-faces, top)
            for cx, cy, hx, hy, hz in self.boxes:
                for face_x in (cx - hx, cx + hx):
                    t = (face_x - o[:, 0]) / np.where(d[:, 0] != 0, d[:, 0], 1e-12)
                    hit = o + t[:, None] * d
                    consider(t, (np.abs(d[:, 0]) > 1e-9) & (np.abs(hit[:, 1] - cy) < hy)
                             & (hit[:, 2] > 0) & (hit[:, 2] < hz))
                for face_y in (cy - hy, cy + hy):
                    t = (face_y - o[:, 1]) / np.where(d[:, 1] != 0, d[:, 1], 1e-12)
                    hit = o + t[:, None] * d
                    consider(t, (np.abs(d[:, 1]) > 1e-9) & (np.abs(hit[:, 0] - cx) < hx)
                             & (hit[:, 2] > 0) & (hit[:, 2] < hz))
                t = (hz - o[:, 2]) / np.where(d[:, 2] != 0, d[:, 2], 1e-12)
                hit = o + t[:, None] * d
                consider(t, (np.abs(d[:, 2]) > 1e-9) & (np.abs(hit[:, 0] - cx) < hx)
                         & (np.abs(hit[:, 1] - cy) < hy))
            # pillars: |oxy + t dxy - c| = r
            for c in self.pillars:
                oc = o[:, :2] - c
                a = np.sum(d[:, :2] ** 2, axis=-1)
                b = 2 * np.sum(oc * d[:, :2], axis=-1)
                cc = np.sum(oc * oc, axis=-1) - self.pillar_r**2
                disc = b * b - 4 * a * cc
                ok = (disc > 0) & (a > 1e-12)
                sq = np.sqrt(np.maximum(disc, 0))
                t = (-b - sq) / np.maximum(2 * a, 1e-12)
                hit_z = o[:, 2] + t * d[:, 2]
                consider(t, ok & (hit_z > 0) & (hit_z < self.pillar_h))
        return t_best


def _lidar_dirs(n_scan, width, fov_up_deg, fov_down_deg):
    """(n_scan * width, 3) float64 unit rays of the spinning LiDAR's grid."""
    va = np.deg2rad(np.linspace(fov_up_deg, fov_down_deg, n_scan))
    az = -np.pi + (np.arange(width) + 0.5) / width * 2 * np.pi
    VA, AZ = np.meshgrid(va, az, indexing="ij")
    return np.stack([np.cos(VA) * np.cos(AZ), np.cos(VA) * np.sin(AZ), np.sin(VA)],
                    axis=-1).reshape(-1, 3)


def _camera_dirs(fx, fy, cx, cy, height, width):
    """(height * width, 3) float64 unit rays of a pinhole camera (RDF)."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    dirs_c = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, np.float64)], -1)
    dirs_c /= np.linalg.norm(dirs_c, axis=-1, keepdims=True)
    return dirs_c.reshape(-1, 3)


class TorchRaycast:
    """Device raycast over a RaycastScene: the port of the reference's
    JaxRaycast (vil_fusion_tpu/runtime/sim.py:330-538).

    The scene's pillars and boxes, and one ray grid a sensor, live on
    `device`. Every primitive is evaluated against every ray in float32,
    `chunk` rays at a time (bounded memory: a chunk's pillar and box tests
    are (chunk, P) and (chunk, B) tensors). The pillar quadratic is the
    perpendicular-distance form disc/4 = r^2 |d_xy|^2 - |oc x d_xy|^2,
    which has no catastrophic cancellation in float32 at 100+ m ranges (the
    naive b^2 - 4ac loses ~0.02 m at 80 m). A pose is the only upload of a
    render: `scan_ranges` returns a scan's ranges, `render_image_u8` runs the
    texture, attenuation and uint8 quantization on the device and returns
    the uint8 image. Plain PyTorch: the reference's raycaster is XLA code,
    not a Pallas kernel. Renders run on the caller's current CUDA stream and
    synchronize only that stream, before their host copy."""

    def __init__(self, scene: RaycastScene, device="cuda", chunk: int = 65536):
        self.device = torch.device(device)
        self.chunk = int(chunk)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._pillars = torch.as_tensor(np.asarray(scene.pillars, np.float32).reshape(-1, 2), **f32)
        self._boxes = torch.as_tensor(np.asarray(scene.boxes, np.float32).reshape(-1, 5), **f32)
        # the scene's constants as float32 values (the reference's np.float32)
        c = [np.float32(x) for x in (scene.wall_y, scene.wall_h, scene.x_lo, scene.x_hi,
                                     scene.pillar_r, scene.pillar_h)]
        self._wall_y, self._wall_h, self._x_lo, self._x_hi, _, self._pillar_h = map(float, c)
        self._wall_y_eps = float(c[0] + np.float32(1e-6))
        self._pillar_r2 = float(c[4] * c[4])
        self._grids: dict = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the uploads, before another stream reads them

    def _chunk_ranges(self, o, d, max_range: float):
        """Hit range (C,) of rays o (C, 3) / (1, 3) + t d (C, 3); inf on a miss."""
        inf = torch.tensor(float("inf"), dtype=torch.float32, device=d.device)

        def gate(t, ok):
            return torch.where(ok & (t > 0.1) & (t < max_range), t, inf)

        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        # ground z=0 (0/0 -> nan compares False inside gate)
        t = -o[:, 2] / d[:, 2]
        hit = o + t[:, None] * d
        ok = ((d[:, 2] != 0) & (hit[:, 0] > self._x_lo) & (hit[:, 0] < self._x_hi)
              & (hit[:, 1].abs() < self._wall_y_eps))
        t_best = gate(t, ok)
        # walls y = +-wall_y
        for wy in (self._wall_y, -self._wall_y):
            t = (wy - o[:, 1]) / d[:, 1]
            hit = o + t[:, None] * d
            ok = ((d[:, 1] != 0) & (hit[:, 2] > 0) & (hit[:, 2] < self._wall_h)
                  & (hit[:, 0] > self._x_lo) & (hit[:, 0] < self._x_hi))
            t_best = torch.minimum(t_best, gate(t, ok))
        # boxes, all faces batched over the box axis: (C, B) tests
        cx, cy, hx, hy, hz = self._boxes.unbind(1)
        safe_dx = torch.where(dx != 0, dx, 1e-12)
        safe_dy = torch.where(dy != 0, dy, 1e-12)
        safe_dz = torch.where(dz != 0, dz, 1e-12)
        for s in (-1.0, 1.0):
            t = (cx + s * hx - ox) / safe_dx
            z = oz + t * dz
            ok = (dx.abs() > 1e-9) & ((oy + t * dy - cy).abs() < hy) & (z > 0) & (z < hz)
            t_best = torch.minimum(t_best, gate(t, ok).amin(-1))
            t = (cy + s * hy - oy) / safe_dy
            z = oz + t * dz
            ok = (dy.abs() > 1e-9) & ((ox + t * dx - cx).abs() < hx) & (z > 0) & (z < hz)
            t_best = torch.minimum(t_best, gate(t, ok).amin(-1))
        t = (hz - oz) / safe_dz
        ok = ((dz.abs() > 1e-9) & ((ox + t * dx - cx).abs() < hx)
              & ((oy + t * dy - cy).abs() < hy))
        t_best = torch.minimum(t_best, gate(t, ok).amin(-1))
        # pillars: stable perpendicular-distance quadratic, (C, P)
        a = dx * dx + dy * dy  # (C, 1)
        ocx = ox - self._pillars[:, 0]
        ocy = oy - self._pillars[:, 1]
        bh = ocx * dx + ocy * dy  # b/2
        cross = ocx * dy - ocy * dx
        disc4 = self._pillar_r2 * a - cross * cross
        ok = (disc4 > 0) & (a > 1e-12)
        t = (-bh - torch.sqrt(torch.clamp(disc4, min=0.0))) / torch.clamp(a, min=1e-12)
        hit_z = oz + t * dz
        ok = ok & (hit_z > 0) & (hit_z < self._pillar_h)
        return torch.minimum(t_best, gate(t, ok).amin(-1))

    def _ranges(self, o, d, max_range: float):
        """Hit ranges (N,) of rays (N, 3) from origins (N, 3) or (1, 3)."""
        out = []
        for i in range(0, d.shape[0], self.chunk):
            oc = o if o.shape[0] == 1 else o[i:i + self.chunk]
            out.append(self._chunk_ranges(oc, d[i:i + self.chunk], max_range))
        return torch.cat(out)

    def _host(self, x):
        """x on the host as numpy; on the card a copy into pinned memory
        after which only the current stream is synchronized."""
        if x.device.type != "cuda":
            return x.numpy()
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return h.numpy()

    def _grid(self, key, make):
        if key not in self._grids:
            g = make()
            self._grids[key] = (torch.as_tensor(g.astype(np.float32), device=self.device),
                                g.astype(np.float32))
        return self._grids[key]

    def _pose(self, R, p):
        f32 = dict(dtype=torch.float32, device=self.device)
        return (torch.as_tensor(np.asarray(R, np.float32), **f32),
                torch.as_tensor(np.asarray(p, np.float32).reshape(1, 3), **f32))

    def raycast(self, origins, dirs, max_range=80.0):
        """origins (N, 3), dirs (N, 3) unit -> float32 hit range (N,), inf on a miss."""
        f32 = dict(dtype=torch.float32, device=self.device)
        o = torch.as_tensor(np.asarray(origins, np.float32), **f32)
        d = torch.as_tensor(np.asarray(dirs, np.float32), **f32)
        return self._host(self._ranges(o, d, float(max_range)))

    def scan_ranges_device(self, R_wb, p_wb, n_scan, width, fov_up_deg, fov_down_deg,
                           max_range=80.0):
        """Ranges (n_scan * width,) of a scan on the device; inf on a miss."""
        dirs_b, _ = self._grid(("lidar", n_scan, width, fov_up_deg, fov_down_deg),
                               lambda: _lidar_dirs(n_scan, width, fov_up_deg, fov_down_deg))
        R, p = self._pose(R_wb, p_wb)
        return self._ranges(p, dirs_b @ R.T, float(max_range))

    def scan_ranges(self, R_wb, p_wb, n_scan, width, fov_up_deg, fov_down_deg,
                    max_range=80.0):
        """(float32 ranges (n_scan * width,), float32 body-frame ray grid):
        ranges raycast on the device from the resident grid; inf on a miss."""
        t = self.scan_ranges_device(R_wb, p_wb, n_scan, width, fov_up_deg, fov_down_deg,
                                    max_range)
        return self._host(t), self._grids[("lidar", n_scan, width, fov_up_deg, fov_down_deg)][1]

    def image_u8_device(self, R_wc, p_wc, fx, fy, cx, cy, height, width, max_range=120.0):
        """(height, width) uint8 render on the device: render_camera_image's
        texture, sky value and attenuation, quantized as the replay
        producers do (x 255 + 0.5, clipped)."""
        dirs_c, _ = self._grid(("cam", fx, fy, cx, cy, height, width),
                               lambda: _camera_dirs(fx, fy, cx, cy, height, width))
        R, p = self._pose(R_wc, p_wc)
        d = dirs_c @ R.T
        t = self._ranges(p, d, float(max_range))
        hit = torch.isfinite(t)
        th = torch.where(hit, t, 0.0)
        pts = p + th[:, None] * d
        tex = _texture_field(pts[:, 0], pts[:, 1], pts[:, 2], torch) / (1.0 + ATTENUATION * th)
        img = torch.where(hit, tex, SKY_VALUE)
        return torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8).reshape(height, width)

    def render_image_u8(self, R_wc, p_wc, fx, fy, cx, cy, height, width, max_range=120.0):
        """The uint8 image of image_u8_device on the host."""
        return self._host(self.image_u8_device(R_wc, p_wc, fx, fy, cx, cy, height, width,
                                               max_range))


def simulate_lidar_scan(scene: RaycastScene, R_wb, p_wb, n_scan: int = 32,
                        width: int = 900, fov_up_deg: float = 30.0,
                        fov_down_deg: float = -30.0, max_range: float = 80.0,
                        range_noise: float = 0.0, seed: int = 0):
    """Spinning-LiDAR scan: (n_scan * width, 3) body-frame points + valid mask.

    Ray grid matches models/lidar_features.LidarConfig's (n_scan, width,
    fov) so the simulated scan exercises the extractor's ring model exactly.
    A TorchRaycast scene raycasts on its device from its resident ray grid.
    """
    if isinstance(scene, TorchRaycast):
        t, dirs_b = scene.scan_ranges(
            np.asarray(R_wb, np.float64), np.asarray(p_wb, np.float64),
            n_scan, width, fov_up_deg, fov_down_deg, max_range=max_range)
    else:
        dirs_b = _lidar_dirs(n_scan, width, fov_up_deg, fov_down_deg)
        dirs_w = dirs_b @ R_wb.T
        origins = np.broadcast_to(p_wb, dirs_w.shape)
        t = scene.raycast(origins, dirs_w, max_range=max_range)
    if range_noise > 0:
        rng = np.random.default_rng(seed)
        t = t + rng.normal(0, range_noise, t.shape)
    valid = np.isfinite(t)
    pts_b = dirs_b * np.where(valid, t, 0.0)[:, None]
    return pts_b.astype(np.float32), valid


# camera sensor-model constants of the render
SKY_VALUE = 0.9  # miss pixels
ATTENUATION = 0.004  # 1/(1 + ATTENUATION*range) distance dimming


def _texture_field(x, y, z, xp=np):
    """Smooth multi-scale intensity field over 3D surface points (trackable
    texture for the KLT front end)."""
    v = (0.45
         + 0.18 * xp.sin(1.3 * x) * xp.sin(1.9 * y + 0.7)
         + 0.12 * xp.sin(3.1 * y + 0.3) * xp.cos(2.3 * z)
         + 0.10 * xp.sin(5.7 * x + 2.1 * z)
         + 0.08 * xp.sin(11.0 * x) * xp.sin(9.0 * y) * xp.sin(8.0 * z + 1.0))
    return xp.clip(v, 0.0, 1.0)


def _procedural_texture(pts):
    return _texture_field(pts[:, 0], pts[:, 1], pts[:, 2], np)


def render_camera_image(scene: RaycastScene, R_wc, p_wc, fx, fy, cx, cy,
                        height, width, max_range=120.0):
    """Raycast grayscale image from a camera (RDF, z forward) at (R_wc, p_wc).

    Surfaces carry a procedural texture; misses render as sky (0.9).
    Returns (height, width) float32 in [0, 1]. A TorchRaycast scene renders
    on its device and quantizes to uint8 there (the /255 here keeps the
    float contract; TorchRaycast.render_image_u8 gives the uint8 image)."""
    if isinstance(scene, TorchRaycast):
        return scene.render_image_u8(
            np.asarray(R_wc, np.float64), np.asarray(p_wc, np.float64),
            fx, fy, cx, cy, height, width,
            max_range=max_range).astype(np.float32) / 255.0
    dirs_w = _camera_dirs(fx, fy, cx, cy, height, width) @ R_wc.T
    origins = np.broadcast_to(p_wc, dirs_w.shape)
    t = scene.raycast(origins, dirs_w, max_range=max_range)
    hit = np.isfinite(t)
    pts = origins + np.where(hit, t, 0.0)[:, None] * dirs_w
    img = np.full(len(dirs_w), SKY_VALUE)
    img[hit] = _procedural_texture(pts[hit])
    # mild distance attenuation adds large-scale gradient
    img[hit] *= 1.0 / (1.0 + ATTENUATION * t[hit])
    return img.reshape(height, width).astype(np.float32)


def simulate_lidar_scan_distorted(scene, traj, t_end, frame_dt, body_offset,
                                  n_scan=32, width=900, fov_up_deg=30.0,
                                  fov_down_deg=-30.0, max_range=80.0,
                                  n_segments=10):
    """Rolling-shutter LiDAR: the azimuth sweep spans [t_end - frame_dt,
    t_end]; each azimuth segment is raycast from the sensor pose at its
    capture time and expressed in THAT body frame (raw spinning-lidar
    behavior). Ground truth frame = end-of-scan pose."""
    seg_w = width // n_segments
    pts = np.zeros((n_scan * width, 3), np.float32)
    val = np.zeros((n_scan * width,), bool)
    for g in range(n_segments):
        s_frac = (g + 0.5) / n_segments
        t_g = t_end - (1.0 - s_frac) * frame_dt
        R_g = traj.rotation(t_g)
        p_g = traj.position(t_g) + body_offset
        # a TorchRaycast scene passes through: its resident-grid scan path
        p_full, v_full = simulate_lidar_scan(
            scene, R_g, p_g, n_scan=n_scan, width=width,
            fov_up_deg=fov_up_deg, fov_down_deg=fov_down_deg,
            max_range=max_range)
        cols = slice(g * seg_w, (g + 1) * seg_w)
        m = np.zeros((n_scan, width), bool)
        m[:, cols] = True
        m = m.reshape(-1)
        pts[m] = p_full[m]
        val[m] = v_full[m]
    return pts, val
