#!/usr/bin/env python3
"""End-position error of the JAX package's lidar odometry on the trajectory
of chip_smoke.py, on the CPU at a reduced scan.

    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode deskew --frames 6

The port's smoke run (chip_smoke.py) bounds the end-position error of its
short deskew and hash-kNN runs from these numbers. The scan is reduced to
32 x 900 with 4,096 / 8,192-point maps so that the run fits a small CPU
machine; trajectory (Trajectory(speed=8.0), 10 Hz, sensor 1.5 m up, first
frame at t = 1.0 s) and HDL-64 field of view are the smoke run's. Modes:
dense (default odometry), deskew (deskew=True on rolling-shutter scans from
simulate_lidar_scan_distorted), hash (use_hash_knn=True). Prints one line
of JSON.
"""
from __future__ import annotations

import argparse
import json

import jax.numpy as jnp
import numpy as np

from vil_fusion_tpu.models import lidar_features as lf
from vil_fusion_tpu.models import lidar_odometry as lo
from vil_fusion_tpu.runtime import sim

FRAME_DT = 0.1
SCAN = dict(n_scan=32, width=900, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0)
MODES = {"dense": {}, "deskew": dict(deskew=True), "hash": dict(use_hash_knn=True)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(MODES), default="dense")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    off = np.array([0.0, 0.0, 1.5])
    cfg = lo.OdomConfig(
        lidar=lf.LidarConfig(n_scan=SCAN["n_scan"], width=SCAN["width"], min_range=1.0,
                             max_range=SCAN["max_range"], fov_up_deg=SCAN["fov_up_deg"],
                             fov_down_deg=SCAN["fov_down_deg"]),
        edge_map_cap=4096, surf_map_cap=8192, **MODES[args.mode])
    state = lo.init_state(cfg)
    errs = []
    for i in range(args.frames):
        t = 1.0 + i * FRAME_DT
        R, p = traj.rotation(t), traj.position(t) + off
        if args.mode == "deskew":
            pts, val = sim.simulate_lidar_scan_distorted(scene, traj, t, FRAME_DT, off, **SCAN)
        else:
            pts, val = sim.simulate_lidar_scan(scene, R, p, **SCAN)
        state, (_, p_est, _, _) = lo.odometry_step(state, jnp.asarray(pts), jnp.asarray(val), cfg)
        if i == 0:
            R0, p0 = R, p
        errs.append(float(np.linalg.norm(np.asarray(p_est) - R0.T @ (p - p0))))
    print(json.dumps(dict(package="vil_fusion_tpu (JAX, CPU)", mode=args.mode,
                          frames=args.frames, scan="32x900", maps="4096/8192",
                          end_err_m=errs[-1], max_err_m=max(errs),
                          travel_m=float(np.linalg.norm(R0.T @ (p - p0))))))


if __name__ == "__main__":
    main()
