"""Run the full vil pipeline over a KITTI-scale synthetic city circuit.

Port of tools/run_synthetic.py: the dataset-replay acceptance run at KITTI
scale without KITTI data: a >= 1 km urban-block raycast circuit (radius
100 m -> 628 m a lap), KITTI sensor shapes (1226 x 370 camera, HDL-64
64 x 1800 scan, 200 Hz IMU with noise and bias, 10 Hz frames), a cold start
(no initial state) and loop closure over the laps, with the simulator's
analytic ground truth:

    python -m vil_fusion_tpu_torch.tools.run_synthetic --laps 2 --out out/city

Frames are rendered by sim.TorchRaycast inside the producer thread of the
ring-bus prefetch (runtime/transport.py), on a CUDA stream of its own that
is synchronized only before each render's host copy, so rendering overlaps
the pipeline's device work. Prints the producer's render ms a frame and
the ring's dropped count (0 for a replay).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

# the KITTI rig: HDL-64 ray grid, cam0 (1226 x 370) intrinsics, camera axes
# in the body frame
SCAN = dict(n_scan=64, width=1800, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0)
IMG_H, IMG_W = 370, 1226
FX = FY = 718.856
CX, CY = 607.19, 185.22
R_BC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])


def make_events(traj, scene, rig_geom, n_frames, frame_dt=0.1, t0=1.0,
                imu_rate=200.0, range_noise=0.02, seed0=0, render_s=None, scan=SCAN):
    """Time-ordered imu/scan/image events for the circuit (generator: frames
    are rendered lazily inside the prefetch producer thread) from a
    sim.TorchRaycast `scene`. On a card the renders run on a stream of their
    own; `render_s`, a list, receives each frame's render seconds; `scan`
    is the LiDAR's ray grid (the HDL-64's by default)."""
    import torch

    from vil_fusion_tpu_torch.runtime import sim

    R_BC, H, W, FX, FY, CX, CY = rig_geom
    noise = type("N", (), dict(acc_n=0.08, gyr_n=0.004))()
    bias_a = np.array([0.05, -0.03, 0.02])
    bias_g = np.array([0.002, -0.001, 0.0015])
    on_card = scene.device.type == "cuda"
    stream = torch.cuda.Stream(scene.device) if on_card else None
    for i in range(n_frames):
        t = t0 + i * frame_dt
        if i > 0:
            ts_i, acc, gyr = sim.simulate_imu(
                traj, t - frame_dt, t, imu_rate, noise=noise,
                bias_a=bias_a, bias_g=bias_g, seed=seed0 + i)
            for k in range(1, len(ts_i)):
                yield ("imu", ts_i[k], acc[k], gyr[k])
        if i and i % 100 == 0:
            print(f"  frame {i}/{n_frames}", file=sys.stderr, flush=True)
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        tr = time.perf_counter()
        with torch.cuda.stream(stream) if on_card else contextlib.nullcontext():
            pts, val = sim.simulate_lidar_scan(scene, R_wb, p_wb, range_noise=range_noise,
                                               seed=seed0 + i, **scan)
            img = scene.render_image_u8(R_wb @ R_BC, p_wb, FX, FY, CX, CY, H, W)
        if render_s is not None:
            render_s.append(time.perf_counter() - tr)
        yield ("scan", t, np.asarray(pts), np.asarray(val))
        yield ("image", t, img)


def city_rig(rig_config, scan=SCAN):
    """The circuit's rig as a `rig_config` (a RigConfig class): cam0 and
    the LiDAR of ray grid `scan`, camera and LiDAR at the body's origin."""
    from vil_fusion_tpu_torch.runtime import sim

    return rig_config(
        name="city",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=FX, fy=FY, cx=CX, cy=CY),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=IMG_H, image_width=IMG_W,
        q_ic=sim.R_to_q(R_BC), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(R_BC.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=30, n_scan=scan["n_scan"],
        lidar_fov_up=scan["fov_up_deg"], lidar_fov_down=scan["fov_down_deg"],
        lidar_min_range=1.0, lidar_max_range=scan["max_range"], use_lidar=True)


def main(argv=None) -> dict:
    """Run the CLI on `argv` (sys.argv[1:] by default); returns the report."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--radius", type=float, default=100.0, help="circuit radius (m)")
    ap.add_argument("--laps", type=float, default=2.0)
    ap.add_argument("--speed", type=float, default=8.0, help="mean speed (m/s)")
    ap.add_argument("--out", default="out/city")
    ap.add_argument("--sync-depth", type=int, default=2)
    ap.add_argument("--frames", type=int, default=None,
                    help="override frame count (default: laps * lap time * 10 Hz)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline and the raycaster (cuda or cpu)")
    args = ap.parse_args(argv)

    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.models import visual_loop as vl
    from vil_fusion_tpu_torch.runtime import datasets, sim, tum, viz
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    rig = city_rig(RigConfig)
    period = 2 * np.pi * args.radius / args.speed
    traj = sim.LoopTrajectory(radius=args.radius, period=period, laps=args.laps)
    # device raycast: the numpy primitive loop takes ~26 s a frame at this
    # scene's ~300 primitives (10+ h for the circuit)
    scene = sim.TorchRaycast(sim.urban_block_scene(
        args.radius, pillar_step_deg=4.0, box_step_deg=6.0), device=args.device)
    n_frames = args.frames or int(args.laps * period * 10)
    path_len = args.laps * 2 * np.pi * args.radius

    # keyframe gates at the reference's defaults (2 m / 10 deg); capacities
    # sized for the circuit
    n_kf_max = int(path_len / 2.0 * 1.5) + 64
    cap = 1 << int(np.ceil(np.log2(n_kf_max)))
    pipe = VILFusionPipeline(
        rig, mode="vil", visual_loop=True, sync_depth=args.sync_depth,
        scan_quant=0.0025,
        gf_cfg=gf.GlobalFusionConfig(node_capacity=cap),
        vl_cfg=vl.VisualLoopConfig(capacity=cap, keyframe_gap=2.0),
        device=args.device)

    print(f"city circuit: {path_len:.0f} m, {n_frames} frames, "
          f"{cap}-slot graphs, device {pipe.device}", flush=True)
    rig_geom = (R_BC, IMG_H, IMG_W, FX, FY, CX, CY)
    render_s: list = []
    events = make_events(traj, scene, rig_geom, n_frames, render_s=render_s)
    stats: dict = {}
    t_start = time.perf_counter()
    datasets.replay(pipe, events, stats=stats)
    wall = time.perf_counter() - t_start

    os.makedirs(args.out, exist_ok=True)
    pipe.outputs.write(args.out, pipe.fusion)
    viz.render_pipeline_report(pipe, args.out)

    gt = {round(1.0 + i * 0.1, 6): traj.position(1.0 + i * 0.1) + np.array([0, 0, 1.5])
          for i in range(n_frames)}
    gt_frames = np.stack([gt[round(t, 6)] for t in pipe.outputs.ts])
    # VIO trajectories are evaluated on initialized frames only — the
    # reference publishes odometry only in NON_LINEAR state (pubOdometry)
    ini = np.asarray(pipe.outputs.initialized, bool)
    # lidar odometry is expressed in the first body frame
    R0 = traj.rotation(pipe.outputs.ts[0])
    lidar_gt = (gt_frames - gt_frames[0]) @ R0
    report = {
        "path_length_m": round(path_len, 1),
        "frames": len(pipe.outputs.ts),
        "frames_initialized": int(ini.sum()),
        "first_initialized_frame": int(np.argmax(ini)) if ini.any() else None,
        "wall_s": round(wall, 1),
        "fps": round(len(pipe.outputs.ts) / wall, 2),
        "render_ms_per_frame": 1e3 * float(np.mean(render_s)) if render_s else None,
        "replay": stats,
        "restarts": pipe.restarts,
        "restart_log": pipe.restart_log,
        "vl_errors": pipe.vl_errors,
        "n_keyframes": pipe.fusion.n_kf if pipe.fusion else 0,
        "n_sc_loops": len(pipe.fusion.loops_found) if pipe.fusion else 0,
        # keyframes and loop edges global fusion lost to its capacities
        "counters": dict(GLOBAL_TIMERS.counters),
        "n_visual_loops": int(pipe.visual_loop.graph.n_loops)
        if pipe.visual_loop is not None else 0,
        "visual_loop_stats": pipe.visual_loop.stats_summary()
        if pipe.visual_loop is not None else None,
        "ate_rmse_vio": tum.ate_rmse(np.stack(pipe.outputs.vio_p)[ini], gt_frames[ini])
        if ini.sum() >= 3 else None,
        "ate_rmse_loop": tum.ate_rmse(np.stack(pipe.outputs.loop_p)[ini], gt_frames[ini])
        if pipe.outputs.loop_p and ini.sum() >= 3 else None,
        "lidar_end_err_m": float(np.linalg.norm(pipe.outputs.lidar_p[-1] - lidar_gt[-1])),
        # p50/p90 are the steady-state decomposition; means include the
        # first calls' set-up
        "timers": {k: {kk: (round(vv, 2) if isinstance(vv, float) else vv)
                       for kk, vv in v.items()}
                   for k, v in GLOBAL_TIMERS.summary().items()},
    }
    if pipe.fusion is not None and pipe.fusion.n_kf:
        gt_kf = np.stack([gt[round(t, 6)] for t in pipe.fusion.kf_ts])
        _, p_kf = pipe.fusion.poses()
        report["ate_rmse_fusion"] = tum.ate_rmse(np.asarray(p_kf), gt_kf)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "timers"}, indent=2))
    print(f"render {report['render_ms_per_frame']:.2f} ms a frame in the producer thread; "
          f"ring dropped {stats.get('dropped')}", flush=True)
    return report


if __name__ == "__main__":
    main()
