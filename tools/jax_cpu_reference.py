#!/usr/bin/env python3
"""End-position errors of the JAX package on the trajectories of
chip_smoke.py, on the CPU at a reduced scan.

    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode deskew --frames 6
    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode vil --frames 34
    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode coldstart --frames 80
    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode e2eloop --frames 390
    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode mask --frames 16
    JAX_PLATFORMS=cpu python tools/jax_cpu_reference.py --mode synthetic --frames 16

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
restarts. Mode e2eloop runs tests/test_e2e_loop.py's lap (chip_smoke.py's
phase 9: the cold-start rig with the visual loop, sync_depth=2) and reports
its quantities (initialization frame, loops, first visual-loop frame, the
three ATEs); mode mask runs tests/test_pipeline.py:263's masked sequence
(chip_smoke.py's phase 10) and reports the errors and the tracked features
inside the moving object; mode synthetic runs the cold start of the port's
run_synthetic circuit through both packages on the same events (_synthetic).
Prints one line of JSON.
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


def _e2eloop(frames: int) -> dict:
    """chip_smoke.py's phase 9 (tests/test_e2e_loop.py's lap) through the JAX
    pipeline: loop_lap's quantities and the failures of the test's gates."""
    import chip_smoke as cs
    from vil_fusion_tpu.models import global_fusion as gf
    from vil_fusion_tpu.models import visual_loop as vl
    from vil_fusion_tpu.runtime import tum
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline

    rig, odom, gf_kw, traj, scene = cs.cold_start_rig(sim, RigConfig)
    pipe = VILFusionPipeline(rig, mode="vil", visual_loop=True, sync_depth=2,
                             odom_overrides=odom, gf_cfg=gf.GlobalFusionConfig(**gf_kw),
                             vl_cfg=vl.VisualLoopConfig(**cs.LOOP_VL))
    r = cs.loop_lap(pipe, sim, tum, traj, scene, frames)
    return dict(r, gate_failures=cs.loop_gates(r, frames), keyframes=pipe.visual_loop.n,
                visual_loop_stats=pipe.visual_loop.stats_summary(), scan="32x600",
                image="320x240")


def _mask(frames: int) -> dict:
    """chip_smoke.py's phase 10 through the JAX pipeline."""
    import chip_smoke as cs
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline

    seq, (p0, q0, v0) = cs.mask_frames(sim, frames)
    pipe = VILFusionPipeline(cs.mask_rig(sim, RigConfig), mode="mask")
    pipe.estimator.set_initial_state(p=p0, q=q0, v=v0)
    errs, inside = [], []
    for t, imu, img, mask, box, p in seq:
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        pipe.push_image(t, img, mask=mask)
        errs.append(float(np.linalg.norm(pipe.outputs.vio_p[-1] - p)))
        ts = pipe.tracker_state
        inside.append(cs.mask_inside(np.asarray(ts.xy)[np.asarray(ts.valid)], box))
    return dict(max_err_m=max(errs), end_err_m=errs[-1], inside=inside, restarts=pipe.restarts,
                image="320x240")


def _synthetic(frames: int) -> dict:
    """The cold start of vil_fusion_tpu_torch/tools/run_synthetic.py's
    circuit (radius 100 m, 8 m/s, IMU noise and biases, 1226 x 370 images)
    at the reduced scan and maps, through the JAX package and through the
    port on the CPU, on the same events (rendered once by the port's
    TorchRaycast on the CPU). Per package: the initialization frame, the z
    of every window slot right after the alignment (the world origin is the
    oldest slot and z is vertical; the truth varies by at most 0.24 m, the
    circuit's bob), the newest pose's z and the restarts on every frame.
    sync_depth=0 and no visual loop (neither acts before a loop closes)."""
    import torch

    from vil_fusion_tpu.runtime import datasets as jds
    from vil_fusion_tpu.runtime.config import RigConfig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.runtime import datasets as tds
    from vil_fusion_tpu_torch.runtime import sim as tsim
    from vil_fusion_tpu_torch.runtime.config import RigConfig as TRigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline as TPipeline
    from vil_fusion_tpu_torch.tools import run_synthetic as rs

    radius, speed = 100.0, 8.0
    traj = tsim.LoopTrajectory(radius=radius, period=2 * np.pi * radius / speed)
    scene = tsim.TorchRaycast(tsim.urban_block_scene(radius, pillar_step_deg=4.0,
                                                     box_step_deg=6.0), device="cpu")
    geom = (rs.R_BC, rs.IMG_H, rs.IMG_W, rs.FX, rs.FY, rs.CX, rs.CY)
    events = list(rs.make_events(traj, scene, geom, frames, scan=SCAN))
    out = {}
    for name, make in (("jax", lambda: VILFusionPipeline(
            rs.city_rig(RigConfig, SCAN), mode="vil", sync_depth=0, scan_quant=0.0025,
            odom_overrides=MAPS)),
                       ("port", lambda: TPipeline(
            rs.city_rig(TRigConfig, SCAN), mode="vil", sync_depth=0, scan_quant=0.0025,
            odom_overrides=MAPS, device="cpu"))):
        pipe = make()
        est = pipe.estimator
        rec = {}
        init = est._try_initialize

        def recorded(est=est, init=init, rec=rec):
            ok = init()
            if ok and "align_z" not in rec:
                p = est.window.p
                p = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
                rec["align_z"] = [round(float(z), 4) for z in p[:, 2]]
            return ok

        est._try_initialize = recorded
        (jds if name == "jax" else tds).replay(pipe, iter(events))
        ini = np.asarray(pipe.outputs.initialized, bool)
        out[name] = dict(
            init_frame=int(np.argmax(ini)) if ini.any() else None, restarts=pipe.restarts,
            restart_log=pipe.restart_log, **rec,
            vio_z=[round(float(p[2]), 4) for p in pipe.outputs.vio_p])
    return dict(out, scan="32x900", maps="4096/8192", image=f"{rs.IMG_W}x{rs.IMG_H}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(MODES) + ["coldstart", "e2eloop", "mask", "vil",
                                                       "synthetic"],
                    default="dense")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    head = dict(package="vil_fusion_tpu (JAX, CPU)", mode=args.mode, frames=args.frames)
    if args.mode == "vil":
        print(json.dumps(dict(head, scan="32x900", maps="4096/8192", **_vil(args.frames))))
        return
    if args.mode in ("coldstart", "e2eloop", "mask", "synthetic"):
        run = dict(coldstart=_coldstart, e2eloop=_e2eloop, mask=_mask,
                   synthetic=_synthetic)[args.mode]
        print(json.dumps(dict(head, **run(args.frames))))
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
