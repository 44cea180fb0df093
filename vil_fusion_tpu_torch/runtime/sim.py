"""Synthetic multi-sensor trajectory simulator (ground-truth oracle for tests).

The reference validates only by rosbag replay (README.md:40-48); it ships zero
automated tests. This module replaces dataset replay for CI: an analytic
smooth trajectory generates exact IMU samples (body rates + specific force),
camera feature tracks with known depth, and LiDAR scans of a synthetic world,
all with known ground truth — so every estimator stage can be golden-tested.

Host-side numpy (float64) on purpose: this is test scaffolding, not the
compute path. This is the numpy part of vil_fusion_tpu/runtime/sim.py,
carried over unchanged (LiDAR scene, trajectories, the scan simulators and
the textured camera render) so that the port needs no jax; the IMU and
feature-track simulators and the device raycaster come with the slices that
use them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

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


def simulate_lidar_scan(scene: RaycastScene, R_wb, p_wb, n_scan: int = 32,
                        width: int = 900, fov_up_deg: float = 30.0,
                        fov_down_deg: float = -30.0, max_range: float = 80.0,
                        range_noise: float = 0.0, seed: int = 0):
    """Spinning-LiDAR scan: (n_scan * width, 3) body-frame points + valid mask.

    Ray grid matches models/lidar_features.LidarConfig's (n_scan, width,
    fov) so the simulated scan exercises the extractor's ring model exactly.
    """
    va = np.deg2rad(np.linspace(fov_up_deg, fov_down_deg, n_scan))
    az = -np.pi + (np.arange(width) + 0.5) / width * 2 * np.pi
    VA, AZ = np.meshgrid(va, az, indexing="ij")
    dirs_b = np.stack(
        [np.cos(VA) * np.cos(AZ), np.cos(VA) * np.sin(AZ), np.sin(VA)],
        axis=-1).reshape(-1, 3)
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
    Returns (height, width) float32 in [0, 1]."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    dirs_c = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, np.float64)], -1)
    dirs_c /= np.linalg.norm(dirs_c, axis=-1, keepdims=True)
    dirs_w = dirs_c.reshape(-1, 3) @ R_wc.T
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
