#!/usr/bin/env python3
"""End-position errors of the JAX package on the trajectories of
chip_smoke.py, on the CPU at a reduced scan.

    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode deskew --frames 6
    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode vil --frames 34
    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode coldstart --frames 80

The port's smoke run (chip_smoke.py) bounds its end-position errors from
these numbers. Modes dense (default odometry), deskew (deskew=True on
rolling-shutter scans from simulate_lidar_scan_distorted) and hash
(use_hash_knn=True) run lidar odometry alone; the scan is reduced to
32 x 900 with 4,096 / 8,192-point maps so that the run fits a small CPU
machine; trajectory (Trajectory(speed=8.0), 10 Hz, sensor 1.5 m up, first
frame at t = 1.0 s) and HDL-64 field of view are the smoke run's. Mode vil
runs VILFusionPipeline(mode="vil", sync_depth=0) as chip_smoke.py's path
vil does (1226 x 370 images, 200 Hz IMU, oracle initial state, scans
quantized to 2.5 mm) with the same reduced scan and maps, and reports the
estimator's end error. Mode coldstart runs the cold-start rig of
chip_smoke.py (tests/test_e2e_loop.py's: 240 x 320 images, 32 x 600 scans,
LoopTrajectory, no visual loop, sync_depth=0) until the estimator
initializes, and COLD_AFTER_INIT frames more, and reports that frame and the
restarts. Prints one line of JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vil_fusion_tpu.models import lidar_features as lf  # noqa: E402
from vil_fusion_tpu.models import lidar_odometry as lo  # noqa: E402
from vil_fusion_tpu.runtime import sim  # noqa: E402

FRAME_DT = 0.1
SCAN = dict(n_scan=32, width=900, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0)
MODES = {"dense": {}, "deskew": dict(deskew=True), "hash": dict(use_hash_knn=True)}
MAPS = dict(edge_map_cap=4096, surf_map_cap=8192)


def _vil(frames: int) -> dict:
    """chip_smoke.py's path vil through the JAX pipeline at the reduced scan."""
    import chip_smoke as cs
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline

    r_bc = np.array(cs.R_BC)
    rig = RigConfig(
        name="kitti-hdl64",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=cs.FX, fy=cs.FX, cx=cs.CX, cy=cs.CY),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=cs.IMG_H, image_width=cs.IMG_W,
        q_ic=sim.R_to_q(r_bc), t_ic=np.zeros(3), q_cl=sim.R_to_q(r_bc.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=30, n_scan=SCAN["n_scan"], lidar_fov_up=SCAN["fov_up_deg"],
        lidar_fov_down=SCAN["fov_down_deg"], lidar_min_range=1.0,
        lidar_max_range=SCAN["max_range"], use_lidar=True)
    pipe = VILFusionPipeline(rig, mode="vil", sync_depth=0, scan_quant=cs.SCAN_QUANT,
                             odom_overrides=MAPS)
    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    off = np.array([0.0, 0.0, 1.5])
    q0, p0 = traj.pose(1.0)
    pipe.estimator.set_initial_state(p=p0 + off, q=q0, v=traj.velocity(1.0))
    errs = []
    for i in range(frames):
        t = 1.0 + i * FRAME_DT
        R, p = traj.rotation(t), traj.position(t) + off
        if i:
            ts, acc, gyr = sim.simulate_imu(traj, t - FRAME_DT, t, 200.0)
            pipe.push_imu_batch(ts[1:], acc[1:], gyr[1:])
        img = (np.clip(sim.render_camera_image(scene, R @ r_bc, p, cs.FX, cs.FX, cs.CX, cs.CY,
                                               cs.IMG_H, cs.IMG_W), 0.0, 1.0) * 255.0
               ).astype(np.uint8)
        pts, val = sim.simulate_lidar_scan(scene, R, p, **SCAN)
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)
        errs.append(float(np.linalg.norm(pipe.outputs.vio_p[-1] - p)))
    return dict(end_err_m=errs[-1], max_err_m=max(errs), restarts=pipe.restarts,
                err_m=[round(e, 4) for e in errs],
                lidar_err_m=[round(float(np.linalg.norm(
                    lp - traj.rotation(1.0).T @ (traj.position(1.0 + k * FRAME_DT)
                                                 - traj.position(1.0)))), 4)
                    for k, lp in enumerate(pipe.outputs.lidar_p)],
                travel_m=float(np.linalg.norm(traj.position(1.0 + (frames - 1) * FRAME_DT)
                                              - traj.position(1.0))),
                image=f"{cs.IMG_W}x{cs.IMG_H}")


def _coldstart(frames: int) -> dict:
    """chip_smoke.py's cold-start run through the JAX pipeline: the frame at
    which the estimator first initializes (None within `frames`)."""
    import chip_smoke as cs
    from vil_fusion_tpu.models import global_fusion as gf
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline

    rig, odom, gf_kw, traj, scene = cs.cold_start_rig(sim, RigConfig)
    pipe = VILFusionPipeline(rig, mode="vil", sync_depth=0, odom_overrides=odom,
                             gf_cfg=gf.GlobalFusionConfig(**gf_kw))
    init = None
    for i in range(frames):
        t, imu, img, pts, val = cs.cold_start_frame(sim, traj, scene, i)
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)
        if pipe.estimator.initialized and init is None:
            init = i
        if init is not None and i >= init + cs.COLD_AFTER_INIT:
            break
    return dict(init_frame=init, frames_run=i + 1, restarts=pipe.restarts, scan="32x600",
                image="320x240")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(MODES) + ["coldstart", "vil"], default="dense")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    head = dict(package="vil_fusion_tpu (JAX, CPU)", mode=args.mode, frames=args.frames)
    if args.mode == "vil":
        print(json.dumps(dict(head, scan="32x900", maps="4096/8192", **_vil(args.frames))))
        return
    if args.mode == "coldstart":
        print(json.dumps(dict(head, **_coldstart(args.frames))))
        return

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    off = np.array([0.0, 0.0, 1.5])
    cfg = lo.OdomConfig(
        lidar=lf.LidarConfig(n_scan=SCAN["n_scan"], width=SCAN["width"], min_range=1.0,
                             max_range=SCAN["max_range"], fov_up_deg=SCAN["fov_up_deg"],
                             fov_down_deg=SCAN["fov_down_deg"]),
        **MAPS, **MODES[args.mode])
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
    print(json.dumps(dict(head, scan="32x900", maps="4096/8192", end_err_m=errs[-1],
                          max_err_m=max(errs), travel_m=float(np.linalg.norm(R0.T @ (p - p0))))))


if __name__ == "__main__":
    main()
