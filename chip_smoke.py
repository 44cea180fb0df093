#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vil_fusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, any failure exits non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles csrc/knn.cu with nvcc for sm_90a into build/kernels/;
  3. kernels: every kernel against its plain PyTorch version on the card at
     the main paths' shapes, with CUDA-event timings of kernel and plain
     version and the least time the card could take (bound):
     K1 (grouped kNN) and K2 (exact kNN) in both distance forms on
     simulator-derived maps and random clouds (edge, surf, ICP shapes), K2
     at the depth-association shape (192 rays x 115,200 sphere points,
     k=3) and at the visual loop's densification shape (384 rays x 19,200),
     K1 and K2 in both forms at few-query and ragged shapes (1-513
     queries, 130-115,200 points, k = 1, 3, 8), each record with the kernels
     a call launches as the library counts them at its launch sites (1, or
     2 where the database is split and merged; held against the plan), K3 (sparse Morton kNN) at edge 2048 x 65,536 and surf
     8192 x 131,072 (presorted simulator maps) and on a clustered random
     cloud, strictly against the plain sparse search and against the plain
     exact search inside the radius, with the share of blocks skipped; the
     dense/sparse crossover (K1, K2, K3 at the default and the 4x map
     capacities) and hash kNN against K1;
  4. path "dense": VILFusionPipeline(mode="lidar") at KITTI HDL-64 scale
     (64 x 1800 = 115,200-point scans, 16,384 / 32,768-point maps, default
     global fusion), 5 warm-up + 40 timed scans at 10 Hz, then
     fusion.prewarm() (one ICP loop verification) and finalize();
  5. path "sparse": the same pipeline with sparse_knn=True,
     approx_knn=False and 65,536 / 131,072-point maps, 5 + 20 scans: K3
     launched every timed frame; then three short runs of the remaining
     odometry options: the difference-form dense kNN (knn_form="diff"),
     use_hash_knn=True, and deskew=True (with the exact difference-form
     kNN) on rolling-shutter scans;
  6. path "front end": vil_front_end (tracker, lidar odometry, extrinsic
     glue, depth association) on 1226 x 370 rendered images + HDL-64 scans,
     3 warm-up + 12 timed frames: features tracked, K2 launched at k=3
     every frame, lidar depth against the simulator's own raycast;
  7. path "vil": VILFusionPipeline(mode="vil", sync_depth=0), the whole vil
     frame (tracker, lidar odometry, extrinsic glue, depth association,
     estimator: IMU preintegration, feature ingest, triangulation, bundle
     adjustment, marginalization, slide) on the same rig with 200 Hz IMU,
     oracle initial state, 14 warm-up + 20 timed frames: no restart, the
     fused estimator step on every steady frame, K1 / K2 launched as the
     odometry and the depth association plan them each frame, the end
     error within its bound; then a cold start on tests/test_e2e_loop.py's
     rig (240 x 320, 32 x 600 scans, LoopTrajectory, no visual loop) that
     must initialize within its frame cap and never restart;
  8. path "deferred": phase 7's frames at sync_depth=2 (the bench's
     deployment configuration, with scan_quant=0.0025): every steady frame
     issued and completed two frames later, no restart, K1 / K2 a frame and
     the end error as in phase 7; frames/s at sync_depth 0 and 2 and the
     distance between the two trajectories are printed;
  9. path "loop": tests/test_e2e_loop.py's lap, 390 frames of the cold-start
     rig with the visual loop on its worker thread and sync_depth=2: that
     test's asserts (initialized, no restart, >= 380 outputs, a ScanContext
     and a visual loop, the ATE of the global fusion below the VIO's and
     0.5 m, the rebuilt loop path no worse than 1.05 x the VIO, the VIO error
     down after the relocalization), no worker error, and K2 launched at
     the densification shape (384 extra corners x the 19,200-point scan);
  10. path "mask": mode "mask" on tests/test_pipeline.py:263's sequence with
     a moving textured object and its mask: at most 2 tracked features in
     the object's core on any frame, no restart, error < 0.5 m;
  11. path "replay" (dataset replay): (a) sim.TorchRaycast on the card
     against the numpy raycast on tools/run_synthetic.py's circuit scene, an
     HDL-64 scan and a 1226 x 370 image (tests/test_sim.py's gates), with
     their CUDA-event ms beside the numpy seconds; (b) phase 4's 45 scans
     (valid points only) and 15 of phase 6's images (PNG) written as a KITTI
     odometry sequence under build/ and replayed by
     vil_fusion_tpu_torch.tools.run_dataset (mode "lidar", the native ring
     bus): every frame out, TUM files and report.json written, nothing
     dropped, K1 on every frame after the first, end error within 0.25 m;
     (c) vil_fusion_tpu_torch.tools.run_synthetic over 30 frames of the
     KITTI-scale circuit from a cold start (visual loop, sync_depth=2,
     frames rendered by TorchRaycast in the ring bus's producer thread): no
     restart, no worker error, nothing dropped, K1 and K2 launched, the
     fusion keyframes' ATE and the lidar end error within 0.25 m.
The numpy simulator's frames are made in a pool of processes (the scans
while the kernels build, the lap's frames ahead of phases 7 and 9, phase
11's numpy references after them).
Every path checks that its state tensors are on the card, that its kernels
launched (counts set to 0 just before, read just after), that all poses are
finite and that the end position is within its bound of the simulator's
ground truth. The line before the last is the kernels' JSON record; the
last line is {"ok": true, "device": {...}}. Imports nothing of jax.
"""
from __future__ import annotations

import functools
import itertools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

WARMUP_FRAMES = 5
TIMED_FRAMES = 40
SPARSE_TIMED_FRAMES = 20
FRAME_DT = 0.1
# End-position bound for the 40 + 5 frame run (35 m of travel): a bit over
# twice the JAX package's own end error on this trajectory (0.110 m, CPU,
# 32 x 900 scans); PERF.md ("PyTorch port on H100") records the numbers.
END_ERR_BOUND_M = 0.25
# Bounds of the short runs, from tools/jax_cpu_reference.py (JAX package,
# CPU, 32 x 900 scans): hash 10 frames 0.0126 m, dense 10 frames 0.0116 m,
# deskew 6 frames 0.179 m (its first frames register undeskewed maps).
# The short dense-form runs get 0.10 m, deskew a bit over twice its number.
SHORT_RUNS = {
    "diff": dict(frames=8, bound=0.10, overrides=dict(knn_form="diff")),
    "hash": dict(frames=10, bound=0.10, overrides=dict(use_hash_knn=True)),
    "deskew": dict(frames=6, bound=0.40,
                   overrides=dict(deskew=True, approx_knn=False, knn_form="diff")),
}
FRONT_WARMUP, FRONT_TIMED = 3, 12
# median |lidar depth - raycast z-depth| over strong depths: about twice the
# 0.077 m of this script's first run on an H100 (PERF.md)
DEPTH_ERR_BOUND_M = 0.15
# features per timed frame of the front-end run, of max_cnt = 150: live
# tracks, and tracks carried over from the frame before (mean and least).
# The RANSAC rejects 15-25% of the KLT tracks of this static scene, and a
# frame that loses its strongest corner refills few (the detector's quality
# gate is relative to the strongest free corner), so single frames carry as
# few as 61 tracks while the mean is 114 (first run, PERF.md)
MIN_LIVE, MIN_TRACKED_MEAN, MIN_TRACKED = 100, 100, 50
# path vil: warm-up covers the window's filling (the estimator's first fused
# step is frame K - 1 = 10) and a few steady frames
VIL_WARMUP, VIL_TIMED = 14, 20
IMU_RATE = 200.0
# end-position bound of the vil path: VIL_REF_END_ERR_M is the JAX
# package's own end error over the same 34 frames on the CPU
# (tools/jax_cpu_reference.py --mode vil --frames 34, 32 x 900 scans and
# 4,096 / 8,192-point maps: 0.0402 m before the first bundle adjustment at
# frame 10, 0.4441 m after it, then growing); the bound is about twice it,
# as for the other paths (PERF.md)
VIL_REF_END_ERR_M = 1.9139
VIL_END_ERR_BOUND_M = 4.0
# the cold start: frame cap, frames run after initializing, and the JAX
# package's initialization frame on the CPU
# (tools/jax_cpu_reference.py --mode coldstart --frames 80)
COLD_FRAME_CAP, COLD_AFTER_INIT = 80, 5
COLD_REF_INIT_FRAME = 10
# phase 9: tests/test_e2e_loop.py's lap (one revisit: the loop trajectory's
# period is 350 frames) and its visual-loop database; LOOP_REF the JAX
# package's own numbers on the CPU (tools/jax_cpu_reference.py --mode e2eloop)
LOOP_FRAMES = 390
LOOP_VL = dict(capacity=512, keyframe_gap=0.75)
LOOP_EXTRA_CAP = 384  # VisualLoopConfig.extra_cap: the densification's queries
LOOP_REF = dict(init_frame=10, sc_loops=3, visual_loops=4, loop_frame=363, ate_vio=2.0593,
                ate_fs=0.1191, ate_loop=1.3958)
# phase 10: tests/test_pipeline.py:263's mask run; MASK_REF the JAX
# package's (tools/jax_cpu_reference.py --mode mask)
MASK_FRAMES = 16
MASK_REF = dict(max_err_m=0.1018)
# phase 11: dataset replay. 11a and 11c use the circuit of
# vil_fusion_tpu_torch/tools/run_synthetic.py (urban block around a 100 m
# circle, LoopTrajectory at 8 m/s mean); 11a renders its frame 5. 11b
# replays phase 4's scans and the first images of phase 6 from a KITTI
# odometry sequence on disk; 11c runs the circuit from a cold start.
CIRCUIT = dict(radius=100.0, pillar_step_deg=4.0, box_step_deg=6.0)
CIRCUIT_FRAME = 5
REPLAY_IMAGES = 15
SYNTH_FRAMES = 30
SYNTH_BOUND_M = 0.25  # fusion keyframes' ATE and lidar end error of 11c
# main-path shapes: scan geometry, odometry map capacities, ICP submap
SCAN = dict(n_scan=64, width=1800, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0)
MAP_CAPS = (16384, 32768)
MAP_CAPS_4X = (65536, 131072)
ICP_CLOUDS, CLOUD_PTS = 25, 2048
RADIUS = 3.0  # OdomConfig.max_corr_dist, K3's radius
# few-query and ragged shapes of the kernels phase (random clouds)
RAGGED_NQ, RAGGED_ND, RAGGED_K = (1, 127, 129, 192, 513), (130, 4097, 115200), (1, 3, 8)
IMG_H, IMG_W, FX, CX, CY = 370, 1226, 718.856, 607.19, 185.22
SCAN_QUANT = 0.0025
# H100 SXM peaks for the bounds (NVIDIA data sheet): FP32 on the CUDA cores,
# HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations per (query, column) pair: expanded form 3 mul + 2 add
# (dot), add, mul, sub (= 8; the clamp and the compare are not counted);
# difference form 3 sub + 3 mul + 2 add (= 8)
OPS_PER_PAIR = 8


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _knn_bound(nq: int, nd: int, k: int, pairs: int | None = None, extra_bytes: int = 0):
    """(bound_ms, bound_by) of one kNN call: the larger of the pairs'
    arithmetic (OPS_PER_PAIR float32 operations each) at the FP32 peak and
    of the bytes moved once (queries and database 12 B a point, validity
    1 B, outputs 8 B a neighbour, plus `extra_bytes`) at the HBM peak.
    `pairs` defaults to nq * nd; the sparse search passes the pairs of the
    blocks it does not skip."""
    pairs = nq * nd if pairs is None else pairs
    t_ops = pairs * OPS_PER_PAIR / PEAK_FP32_FLOPS * 1e3
    t_bytes = (nq * 12 + nd * 13 + nq * k * 8 + extra_bytes) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


R_BC = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))  # camera axes in the body frame


def _rig():
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig

    r_bc = np.array(R_BC)
    return RigConfig(
        name="kitti-hdl64",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=FX, fy=FX, cx=CX, cy=CY),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=IMG_H, image_width=IMG_W,
        q_ic=sim.R_to_q(r_bc), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(r_bc.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=30, n_scan=64,
        lidar_fov_up=2.0, lidar_fov_down=-24.8, lidar_min_range=1.0,
        lidar_max_range=80.0, use_lidar=True)


@functools.lru_cache(maxsize=None)
def _kitti_world():
    """The KITTI-rig paths' scene and Trajectory(speed=8.0), once a process."""
    from vil_fusion_tpu_torch.runtime import sim

    return sim.RaycastScene(), sim.Trajectory(sim.TrajectoryConfig(speed=8.0))


def _kitti_pose(i: int):
    """(R_wb, p_wb) of frame i: Trajectory(speed=8.0) at 10 Hz, sensor 1.5 m up."""
    import numpy as np

    traj = _kitti_world()[1]
    t = 1.0 + i * FRAME_DT
    return traj.rotation(t), traj.position(t) + np.array([0.0, 0.0, 1.5])


def _scan_frame(i: int, distorted: bool = False):
    """Frame i of _sequence: (t, points (115200, 3) f32, valid, R_wb, p_wb)."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim

    scene, traj = _kitti_world()
    t = 1.0 + i * FRAME_DT
    R, p = _kitti_pose(i)
    if distorted:
        pts, val = sim.simulate_lidar_scan_distorted(scene, traj, t, FRAME_DT,
                                                     np.array([0.0, 0.0, 1.5]), **SCAN)
    else:
        pts, val = sim.simulate_lidar_scan(scene, R, p, **SCAN)
    return t, pts, val, R, p


def _sequence(n: int, distorted: bool = False):
    """n HDL-64 scans at 10 Hz along Trajectory(speed=8.0), sensor 1.5 m up:
    [(t, points (115200, 3) f32, valid, R_wb, p_wb)]; `distorted` sweeps each
    scan over its frame period (rolling shutter, end-of-scan pose)."""
    return [_scan_frame(i, distorted) for i in range(n)]


def cold_start_rig(sim, rig_cls):
    """tests/test_e2e_loop.py's cold-start rig (240 x 320 pinhole, 32-ring
    scans of 600 columns, hash kNN, the urban block around a 12 m
    LoopTrajectory) for either package: (rig, odometry overrides, global
    fusion keywords, trajectory, scene). `sim` and `rig_cls` are the
    package's simulator module and RigConfig."""
    import numpy as np

    r_bc = np.array(R_BC)
    rig = rig_cls(
        name="loop",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=240, image_width=320,
        q_ic=sim.R_to_q(r_bc), t_ic=np.zeros(3), q_cl=sim.R_to_q(r_bc.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=12, n_scan=32, lidar_fov_up=30.0, lidar_fov_down=-30.0,
        lidar_min_range=1.0, lidar_max_range=80.0, use_lidar=True, depth_min_incidence=0.02)
    odom = dict(width=600, edge_map_cap=4096, surf_map_cap=8192, use_hash_knn=True)
    gf_kw = dict(keyframe_dist=1.5, node_capacity=512, optimize_every=8)
    return rig, odom, gf_kw, sim.LoopTrajectory(radius=12.0, period=35.0), \
        sim.urban_block_scene(12.0)


def cold_start_frame(sim, traj, scene, i):
    """Frame i of the cold-start run: (t, IMU (ts, acc, gyr) since the last
    frame with white noise and constant biases or None, float image, scan
    points, validity)."""
    import numpy as np

    t = 1.0 + i * FRAME_DT
    imu = None
    if i:
        noise = type("Noise", (), dict(acc_n=0.08, gyr_n=0.004))()
        imu = sim.simulate_imu(traj, t - FRAME_DT, t, IMU_RATE, noise=noise,
                               bias_a=np.array([0.05, -0.03, 0.02]),
                               bias_g=np.array([0.002, -0.001, 0.0015]), seed=i)
    R, p = traj.rotation(t), traj.position(t) + np.array([0.0, 0.0, 1.5])
    img = sim.render_camera_image(scene, R @ np.array(R_BC), p, 250.0, 250.0, 160.0, 120.0,
                                  240, 320)
    pts, val = sim.simulate_lidar_scan(scene, R, p, n_scan=32, width=600, range_noise=0.01,
                                       seed=i)
    return t, imu, img, pts, val


def loop_lap(pipe, sim, tum, traj, scene, n_frames, on_frame=None, frame=None):
    """tests/test_e2e_loop.py's lap through `pipe`, either package's
    VILFusionPipeline built on cold_start_rig with the visual loop
    (VisualLoopConfig(capacity=512, keyframe_gap=0.75)): cold start, noisy
    biased IMU, n_frames frames, then finalize(). `on_frame(i)` runs after
    frame i; `frame(i)` gives frame i (cold_start_frame by default).
    Returns that test's quantities: the initialization frame,
    restarts, outputs, ScanContext and visual loops, the first frame with a
    visual loop, the ATEs of the VIO path (initialized frames), of the
    global-fusion keyframes and of the rebuilt loop path, and the VIO error
    around the first visual loop."""
    import numpy as np

    if frame is None:
        def frame(i):
            return cold_start_frame(sim, traj, scene, i)
    gt, vio_errs, loop_frame, init = {}, [], None, None
    for i in range(n_frames):
        t, imu, img, pts, val = frame(i)
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)
        gt[round(t, 6)] = traj.position(t) + np.array([0.0, 0.0, 1.5])
        if init is None and pipe.estimator.initialized:
            init = i
        if pipe.outputs.vio_p and pipe.estimator.initialized:
            vio_errs.append((i, float(np.linalg.norm(
                pipe.outputs.vio_p[-1] - gt[round(pipe.outputs.ts[-1], 6)]))))
        if loop_frame is None and int(pipe.visual_loop.graph.n_loops) >= 1:
            loop_frame = i
        if on_frame is not None:
            on_frame(i)
    pipe.finalize()
    ini = np.asarray(pipe.outputs.initialized, bool)
    gt_frames = np.stack([gt[round(t, 6)] for t in pipe.outputs.ts])[ini]
    _, p_kf = pipe.fusion.poses()
    pre = [e for f, e in vio_errs if loop_frame is not None and loop_frame - 5 <= f <= loop_frame]
    post = [e for f, e in vio_errs if loop_frame is not None and f >= loop_frame + 3]
    return dict(
        init_frame=init, restarts=pipe.restarts, outputs=len(pipe.outputs.ts),
        sc_loops=len(pipe.fusion.loops_found), visual_loops=int(pipe.visual_loop.graph.n_loops),
        loop_frame=loop_frame,
        ate_vio=float(tum.ate_rmse(np.stack(pipe.outputs.vio_p)[ini], gt_frames)),
        ate_fs=float(tum.ate_rmse(np.asarray(p_kf),
                                  np.stack([gt[round(t, 6)] for t in pipe.fusion.kf_ts]))),
        ate_loop=float(tum.ate_rmse(np.stack(pipe.outputs.loop_p)[ini], gt_frames)),
        vio_err_pre_max=max(pre) if pre else None, vio_err_post_min=min(post) if post else None)


def loop_gates(r, n_frames) -> list:
    """tests/test_e2e_loop.py's asserts on loop_lap's result over n_frames
    frames: the failures."""
    bad = []
    if r["init_frame"] is None:
        bad.append("cold-start initialization never fired")
    if r["restarts"]:
        bad.append(f"{r['restarts']} failure-detection restarts")
    if r["outputs"] < n_frames - 10:
        bad.append(f"{r['outputs']} outputs of {n_frames} frames")
    if r["sc_loops"] < 1:
        bad.append("no verified ScanContext loop")
    if r["visual_loops"] < 1 or r["loop_frame"] is None:
        bad.append("no visual loop")
    if not (r["ate_fs"] < r["ate_vio"] and r["ate_fs"] < 0.5):
        bad.append(f"fs_loam_loop ATE {r['ate_fs']:.3f} against VIO {r['ate_vio']:.3f} (< 0.5)")
    if not r["ate_loop"] <= 1.05 * r["ate_vio"]:
        bad.append(f"loop-path ATE {r['ate_loop']:.3f} worse than VIO {r['ate_vio']:.3f}")
    if r["vio_err_post_min"] is not None and not r["vio_err_post_min"] < r["vio_err_pre_max"]:
        bad.append(f"VIO error did not drop after the relocalization: pre "
                   f"{r['vio_err_pre_max']:.2f}, post {r['vio_err_post_min']:.2f}")
    return bad


def mask_rig(sim, rig_cls):
    """tests/test_pipeline.py's synthetic rig without lidar (240 x 320,
    max_cnt 80, min_dist 18) for either package."""
    import numpy as np

    r_bc = np.array(R_BC)
    return rig_cls(
        name="synthetic",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=240, image_width=320, q_ic=sim.R_to_q(r_bc), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(r_bc.T), t_cl=np.zeros(3), max_cnt=80, min_dist=18, n_scan=32,
        lidar_fov_up=30.0, lidar_fov_down=-30.0, lidar_min_range=1.0, lidar_max_range=80.0,
        use_lidar=False)


def _texture(H, W, seed, scale):
    """tests/test_vision.py's smooth random texture: a function (y, x) -> [0, 1)."""
    import numpy as np

    grid = np.random.default_rng(seed).random((H // scale + 2, W // scale + 2))
    gh, gw = grid.shape

    def sample(y, x):
        gy, gx = np.clip(y / scale, 0, gh - 1.001), np.clip(x / scale, 0, gw - 1.001)
        y0, x0 = gy.astype(int), gx.astype(int)
        fy, fx = gy - y0, gx - x0
        return (grid[y0, x0] * (1 - fx) * (1 - fy) + grid[y0, x0 + 1] * fx * (1 - fy)
                + grid[y0 + 1, x0] * (1 - fx) * fy + grid[y0 + 1, x0 + 1] * fx * fy)

    return sample


def mask_frames(sim, n_frames):
    """tests/test_pipeline.py:263's sequence: Trajectory(speed=1.5), 10 Hz,
    a moving 80 x 80 textured object composited into each image with its
    mask. [(t, IMU (ts, acc, gyr) or None, image, mask, object corner,
    ground-truth position)] and the initial (p, q, v)."""
    import numpy as np

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=1.5))
    tex = _texture(120, 120, seed=99, scale=4)
    yy, xx = np.mgrid[0:80, 0:80].astype(np.float64)
    out = []
    for i in range(n_frames):
        t = 1.0 + i * FRAME_DT
        R, p = traj.rotation(t), traj.position(t) + np.array([0.0, 0.0, 1.5])
        img = sim.render_camera_image(scene, R @ np.array(R_BC), p, 250.0, 250.0, 160.0, 120.0,
                                      240, 320).copy()
        ox, oy = 40 + i * 9, 70 + (i % 5) * 4
        img[oy:oy + 80, ox:ox + 80] = tex(yy + i * 2.0, xx + i * 5.0).astype(np.float32)
        mask = np.zeros((240, 320), bool)
        mask[oy:oy + 80, ox:ox + 80] = True
        imu = sim.simulate_imu(traj, t - FRAME_DT, t, IMU_RATE) if i else None
        out.append((t, imu, img, mask, (ox, oy), p))
    q0, p0 = traj.pose(1.0)
    return out, (p0 + np.array([0.0, 0.0, 1.5]), q0, traj.velocity(1.0))


def mask_inside(xy, box):
    """Tracked features inside the un-eroded core (8 px in) of the object."""
    ox, oy = box
    return int(((xy[:, 0] > ox + 8) & (xy[:, 0] < ox + 72)
                & (xy[:, 1] > oy + 8) & (xy[:, 1] < oy + 72)).sum())


def _render(R_wb, p_wb):
    """uint8 camera image (370 x 1226) of the KITTI rig at a body pose."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim

    img = sim.render_camera_image(_kitti_world()[0], R_wb @ np.array(R_BC), p_wb, FX, FX, CX, CY,
                                  IMG_H, IMG_W)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _images(frames):
    """uint8 camera images (370 x 1226) rendered at the frames' poses."""
    return [_render(fr[3], fr[4]) for fr in frames]


@functools.lru_cache(maxsize=None)
def _lap_world():
    """cold_start_rig's trajectory and scene, once a process."""
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig

    return cold_start_rig(sim, RigConfig)[3:]


def _lap_frame(i: int):
    """Frame i of the cold-start rig's sequence (cold_start_frame)."""
    from vil_fusion_tpu_torch.runtime import sim

    return cold_start_frame(sim, *_lap_world(), i)


class _Ahead:
    """Frames computed ahead, in order, by a process pool's imap: frame(i)
    waits for frame i and keeps every frame for later readers."""

    def __init__(self, it):
        self._it, self._got = it, []

    def __call__(self, i):
        while len(self._got) <= i:
            self._got.append(next(self._it))
        return self._got[i]


def _margin_rows(d_ref, k: int):
    """Rows whose first k+1 reference distances are pairwise separated by
    more than 1e-6 relative: there the k-NN set and order are unambiguous."""
    import torch

    d = d_ref[:, : k + 1]
    gaps = d[:, 1:] - d[:, :-1]
    scale = torch.clamp(d[:, 1:], min=1e-12)
    ok = (gaps > 1e-6 * scale) | ~torch.isfinite(d[:, 1:])
    return ok.all(dim=1) & torch.isfinite(d[:, 0])


def _compare(name, d_k, i_k, d_p, i_p, d_p_more, k, rows=None, strict=False, quiet=False):
    """Kernel (d_k, i_k) against plain (d_p, i_p) on `rows` (all by
    default); d_p_more is the plain search with k+1 neighbours for the
    margin test. Distances must agree within 1e-6 of the largest one
    (`strict`: bit for bit). Returns max |d_k - d_p| over finite entries."""
    import torch

    if rows is not None:
        d_k, i_k, d_p, i_p, d_p_more = d_k[rows], i_k[rows], d_p[rows], i_p[rows], d_p_more[rows]
    fin = torch.isfinite(d_p)
    if not torch.equal(fin, torch.isfinite(d_k)):
        raise AssertionError(f"{name}: finite pattern differs from the plain version")
    err = (d_k[fin] - d_p[fin]).abs().max().item() if fin.any() else 0.0
    tol = 0.0 if strict or not fin.any() else 1e-6 * d_p[fin].abs().max().item()
    if err > tol:
        raise AssertionError(f"{name}: max |d2 kernel - plain| = {err} > {tol}")
    clear = _margin_rows(d_p_more, k)
    bad = (i_k[clear] != i_p[clear]).any(dim=1).sum().item()
    if bad:
        raise AssertionError(f"{name}: {bad} of {int(clear.sum())} unambiguous rows "
                             f"pick other neighbours than the plain version")
    if (i_k[~torch.isfinite(d_k)] != 0).any():
        raise AssertionError(f"{name}: missing neighbours must carry index 0")
    if not quiet:
        print(f"  {name}: kernel == plain on {int(clear.sum())}/{clear.numel()} "
              f"unambiguous rows, max |d2 diff| {err:.3g} (tol {tol:.3g})", flush=True)
    return err


def _grouped_bounds(name, d_g, d_x, gate=None):
    """test_pallas_knn.py:149-175 bounds of the grouped search against the
    exact one: >= 99% of rows exact, 5th-neighbour ratio < 1.5."""
    import torch

    rows = torch.ones(d_g.shape[0], dtype=torch.bool, device=d_g.device) if gate is None else gate
    dg, dx = d_g[rows], d_x[rows]
    exact_rows = torch.isclose(dg, dx, rtol=1e-3, atol=1e-2).all(dim=1).float().mean().item()
    ratio = (dg[:, -1] / torch.clamp(dx[:, -1], min=1e-9)).max().item()
    if not (exact_rows > 0.99 and ratio < 1.5):
        raise AssertionError(f"{name}: grouped vs exact: exact rows {exact_rows:.4f} "
                             f"(need > 0.99), 5th-NN ratio {ratio:.3f} (need < 1.5)")
    print(f"  {name}: grouped vs exact on {int(rows.sum())} rows: exact rows "
          f"{exact_rows:.4f}, max 5th-NN ratio {ratio:.3f}", flush=True)


def _kernel_inputs(frames, dev, big=True):
    """Inputs of the kernels phase, as the main paths build them, from
    `frames` (at least ICP_CLOUDS of them): `cases` {edge, surf, icp: (q, db,
    valid on simulator maps, the same three on random clouds, k, grouped)},
    the depth-association rays / sphere / sphere_ok, and with `big` the 4x
    maps (hash-voxel merges of every frame but the query frame) with their
    queries e_q / s_q."""
    import types

    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import lidar_features as lf
    from vil_fusion_tpu_torch.ops import lie, voxel
    from vil_fusion_tpu_torch.runtime import sim

    lcfg = lf.LidarConfig(n_scan=SCAN["n_scan"], width=SCAN["width"], min_range=1.0,
                          max_range=SCAN["max_range"], fov_up_deg=SCAN["fov_up_deg"],
                          fov_down_deg=SCAN["fov_down_deg"])

    def world(fr, x):
        q = torch.as_tensor(sim.R_to_q(fr[3]), dtype=torch.float32, device=dev)
        p = torch.as_tensor(fr[4], dtype=torch.float32, device=dev)
        return lie.qrot(q, x) + p

    def feats(fr):
        pts = torch.from_numpy(fr[1]).to(dev)
        val = torch.from_numpy(fr[2]).to(dev)
        return lf.extract_features(pts, val, lcfg)

    origin = torch.full((3,), -100.0, device=dev)

    def maps(caps, map_frames):
        """Maps as lidar odometry holds them: hash-voxel merges of world
        features of `map_frames` into buffers of capacities `caps`."""
        ecap, scap = caps
        em, eo = torch.zeros((ecap, 3), device=dev), torch.zeros(ecap, dtype=torch.bool, device=dev)
        sm, so = torch.zeros((scap, 3), device=dev), torch.zeros(scap, dtype=torch.bool, device=dev)
        for fr in map_frames:
            f = feats(fr)
            em, eo = voxel.merge_voxel_hash(em, eo, world(fr, f.edge), f.edge_valid, 0.4,
                                            origin, ecap)
            sm, so = voxel.merge_voxel_hash(sm, so, world(fr, f.surf), f.surf_valid, 0.8,
                                            origin, scap)
        return em, eo, sm, so

    edge_map, edge_ok, surf_map, surf_ok = maps(MAP_CAPS, frames[:6])
    fq = feats(frames[6])
    big_maps = e_q = s_q = None
    if big:  # the 4x maps hold the whole sequence except the query frame
        q_idx = len(frames) // 2
        big_maps = maps(MAP_CAPS_4X, frames[:q_idx] + frames[q_idx + 1:])
        fq_big = feats(frames[q_idx])
        e_q = world(frames[q_idx], fq_big.edge).contiguous()
        s_q = world(frames[q_idx], fq_big.surf).contiguous()
    ecap, scap = MAP_CAPS
    # ICP target: 25 keyframe clouds of 2048 subsampled points (51,200)
    n_pts = frames[0][1].shape[0]
    sub = np.linspace(0, n_pts - 8, CLOUD_PTS).astype(np.int64)
    tgt = torch.cat([world(fr, torch.from_numpy(fr[1][sub]).to(dev))
                     for fr in frames[:ICP_CLOUDS]])
    tgt_ok = torch.cat([torch.from_numpy(fr[2][sub]).to(dev) for fr in frames[:ICP_CLOUDS]])
    src = world(frames[12], torch.from_numpy(frames[12][1][sub + 7]).to(dev))

    gen = np.random.default_rng(0)

    def rnd(n):
        return torch.as_tensor(gen.uniform(-50, 50, (n, 3)), dtype=torch.float32, device=dev)

    def rnd_valid(n):
        return torch.as_tensor(gen.random(n) > 0.1, device=dev)

    n_ne, n_ns, n_t = fq.edge.shape[0], fq.surf.shape[0], tgt.shape[0]
    cases = {
        "edge": (world(frames[6], fq.edge).contiguous(), edge_map, edge_ok, rnd(n_ne),
                 rnd(ecap), rnd_valid(ecap), 5, True),
        "surf": (world(frames[6], fq.surf).contiguous(), surf_map, surf_ok, rnd(n_ns),
                 rnd(scap), rnd_valid(scap), 5, True),
        "icp": (src.contiguous(), tgt.contiguous(), tgt_ok, rnd(src.shape[0]), rnd(n_t),
                rnd_valid(n_t), 1, False),
    }
    # depth association: 192 feature rays against the scan on the unit sphere
    scan = torch.from_numpy(frames[6][1]).to(dev)
    r_cl = torch.tensor(R_BC, dtype=torch.float32, device=dev).T
    cloud_cam = scan @ r_cl.T
    z = cloud_cam[:, 2]
    sphere_ok = (torch.from_numpy(frames[6][2]).to(dev) & (z > 0.3)
                 & (cloud_cam[:, 0].abs() < 1.3 * z) & (cloud_cam[:, 1].abs() < 1.3 * z))
    sphere = (cloud_cam / torch.clamp(torch.linalg.norm(cloud_cam, dim=-1), min=1e-6)[:, None])
    xy = torch.as_tensor(gen.uniform([-0.8, -0.25], [0.8, 0.25], (192, 2)), dtype=torch.float32,
                         device=dev)
    rays = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)
    rays = (rays / torch.linalg.norm(rays, dim=-1, keepdim=True)).contiguous()
    return types.SimpleNamespace(cases=cases, rays=rays, sphere=sphere.contiguous(),
                                 sphere_ok=sphere_ok, big=big_maps, e_q=e_q, s_q=s_q,
                                 origin=origin, gen=gen, rnd=rnd, rnd_valid=rnd_valid)


def _densify_inputs(dev, gen):
    """The visual loop's densification call (VisualLoopDB.add_keyframe ->
    depth_association.feature_depth) at the lap's shape: extra_cap = 384
    corner rays inside the 240 x 320 camera's field of view against frame
    0's 32 x 600 scan of cold_start_rig on the unit sphere, with the depth
    association's field-of-view gate. Draws from `gen`."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig

    _, _, _, traj, scene = cold_start_rig(sim, RigConfig)
    _, _, _, pts, val = cold_start_frame(sim, traj, scene, 0)
    cloud = torch.as_tensor(pts, device=dev) @ torch.tensor(R_BC, dtype=torch.float32,
                                                            device=dev)
    z = cloud[:, 2]
    ok = (torch.as_tensor(val, device=dev) & (z > 0.3) & (cloud[:, 0].abs() < 1.3 * z)
          & (cloud[:, 1].abs() < 1.3 * z))
    sphere = cloud / torch.clamp(torch.linalg.norm(cloud, dim=-1), min=1e-6)[:, None]
    xy = torch.as_tensor(gen.uniform([-0.64, -0.48], [0.64, 0.48], (LOOP_EXTRA_CAP, 2)),
                         dtype=torch.float32, device=dev)
    rays = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)
    return (rays / torch.linalg.norm(rays, dim=-1, keepdim=True)).contiguous(), \
        sphere.contiguous(), ok


def _k3_inputs(inp):
    """K3's inputs of the kernels phase from `_kernel_inputs(..., big=True)`:
    {label: (queries, database, validity, presorted)}. The edge and surf
    queries against the 4x and the default-capacity maps, each side
    Morton-sorted as scan_to_map sorts them; and a clustered random cloud
    (40 centres, 2 m spread, 3000 x 20,000) that the wrapper sorts itself.
    Draws from inp.gen."""
    import torch

    from vil_fusion_tpu_torch.ops import knn as knn_plain

    def presorted(q, db, v):
        qp, dp = knn_plain.morton_sort(q), knn_plain.morton_sort(db, v)
        return q[qp].contiguous(), db[dp].contiguous(), v[dp].contiguous(), True

    (e_q, edge_map, edge_ok), (s_q, surf_map, surf_ok) = (inp.cases[n][:3] for n in ("edge", "surf"))
    out = {"edge 4x": presorted(inp.e_q, inp.big[0], inp.big[1]),
           "surf 4x": presorted(inp.s_q, inp.big[2], inp.big[3]),
           "edge": presorted(e_q, edge_map, edge_ok),
           "surf": presorted(s_q, surf_map, surf_ok)}
    gen, dev = inp.gen, inp.e_q.device
    centers = gen.uniform(-40, 40, (40, 3))
    cl_db = torch.as_tensor(centers[gen.integers(0, 40, 20000)] + gen.normal(0, 2.0, (20000, 3)),
                            dtype=torch.float32, device=dev)
    cl_q = torch.as_tensor(centers[gen.integers(0, 40, 3000)] + gen.normal(0, 2.0, (3000, 3)),
                           dtype=torch.float32, device=dev)
    out["clustered random"] = (cl_q, cl_db, inp.rnd_valid(20000), False)
    return out


def _kernel_phase(frames, dev):
    """Phase 3. Returns {kernel name: record} without launch counts."""
    import torch

    from vil_fusion_tpu_torch.ops import hash_knn
    from vil_fusion_tpu_torch.ops import knn as knn_plain
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

    inp = _kernel_inputs(frames, dev)
    cases, rays, sphere, sphere_ok = inp.cases, inp.rays, inp.sphere, inp.sphere_ok
    big, e_q, s_q, origin, gen, rnd, rnd_valid = (inp.big, inp.e_q, inp.s_q, inp.origin, inp.gen,
                                                  inp.rnd, inp.rnd_valid)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    edge_map, edge_ok = cases["edge"][1:3]
    surf_map, surf_ok = cases["surf"][1:3]
    errs = {}
    shapes = {}  # kernel name -> {shape label: dict(ms, plain_ms, bound_ms, bound_by)}

    def note(kname, label, nq, nd, k, call, plain_ms, pairs=None, extra_bytes=0, bound=None,
             shape=None, **more):
        """Time `call` (one wrapper call at this shape) and count the kernels
        it enqueues, read from the library's own counter around one call and
        held against the plan: K3 its box kernel and search (a presorted
        call), K1 / K2 the merge only where the plan splits the database, the
        Morton keys two. `bound` overrides the kNN bound."""
        b_ms, b_by = bound or _knn_bound(nq, nd, k, pairs, extra_bytes)
        ms = _time_ms(call)
        before = kc.kernels_enqueued()
        call()
        per_call = kc.kernels_enqueued() - before
        if kname == "K3":
            planned = kc.sparse_plan(nq, nd, sm_count).kernels
        elif kname == "Morton keys":
            planned = 2
        else:
            planned = 1 + kc.plan(nq, nd, k, sm_count, kname.startswith("K1")).merge
        if per_call != planned:
            raise AssertionError(f"{kname} {label} {nq}x{nd} k={k}: the call enqueued "
                                 f"{per_call} kernels, its plan says {planned}")
        shape = shape or f"{nq}x{nd} k={k}"
        shapes.setdefault(kname, {})[label] = dict(
            shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            launches_per_call=per_call, **more)
        plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
        print(f"  {kname} {label} {shape}: kernel {ms:.4f} ms in {per_call} launch(es), "
              f"plain {plain_txt}, bound {b_ms:.5f} ms by {b_by} (CUDA-event medians)", flush=True)

    # --- K1 / K2, both distance forms, against their plain versions ---
    for form in ("expanded", "diff"):
        for name, (q_s, db_s, v_s, q_r, db_r, v_r, k, grouped) in cases.items():
            kern = kc.knn_grouped if grouped else kc.knn_exact
            plain = kc.knn_grouped_plain if grouped else kc.knn_exact_plain
            kname = ("K1" if grouped else "K2") + (" diff" if form == "diff" else "")
            for variant, (q, db, v) in (("sim", (q_s, db_s, v_s)), ("random", (q_r, db_r, v_r))):
                d_k, i_k = kern(q, db, v, k=k, form=form)
                d_p, i_p = plain(q, db, v, k=k, form=form)
                d_more, _ = plain(q, db, v, k=k + 1, form=form)
                torch.cuda.synchronize()
                label = f"{kname} {name} {variant} {q.shape[0]}x{db.shape[0]} k={k}"
                errs[kname] = max(errs.get(kname, 0.0),
                                  _compare(label, d_k, i_k, d_p, i_p, d_more, k))
                if grouped:
                    d_x, _ = kc.knn_exact_plain(q, db, v, k=k, form=form)
                    gate = None if variant == "random" else d_x[:, -1] < 9.0
                    _grouped_bounds(label, d_k, d_x, gate)
            q, db, v = q_s, db_s, v_s
            plain_ms = _time_ms(lambda: plain(q, db, v, k=k, form=form))
            note(kname, name, q.shape[0], db.shape[0], k,
                 lambda: kern(q, db, v, k=k, form=form), plain_ms)
            if grouped:  # the exact kernel at the association shape (approx_knn=False)
                kx = "K2" + (" diff" if form == "diff" else "")
                d_k, i_k = kc.knn_exact(q, db, v, k=k, form=form)
                d_p, i_p = kc.knn_exact_plain(q, db, v, k=k, form=form)
                d_more, _ = kc.knn_exact_plain(q, db, v, k=k + 1, form=form)
                errs[kx] = max(errs.get(kx, 0.0),
                               _compare(f"{kx} {name} sim k={k}", d_k, i_k, d_p, i_p, d_more, k))
                note(kx, name, q.shape[0], db.shape[0], k,
                     lambda: kc.knn_exact(q, db, v, k=k, form=form), None)

    # --- K2 at the depth-association shape ---
    d_k, i_k = kc.knn_exact(rays, sphere, sphere_ok, k=3)
    d_p, i_p = kc.knn_exact_plain(rays, sphere, sphere_ok, k=3)
    d_more, _ = kc.knn_exact_plain(rays, sphere, sphere_ok, k=4)
    torch.cuda.synchronize()
    errs["K2"] = max(errs["K2"], _compare(f"K2 depth sim {rays.shape[0]}x{sphere.shape[0]} k=3",
                                          d_k, i_k, d_p, i_p, d_more, 3))
    note("K2", "depth", rays.shape[0], sphere.shape[0], 3,
         lambda: kc.knn_exact(rays, sphere, sphere_ok, k=3),
         _time_ms(lambda: kc.knn_exact_plain(rays, sphere, sphere_ok, k=3)))

    # --- K2 at the visual loop's densification shape: the extra corners' rays
    #     (extra_cap = 384) against the lap's 32 x 600 scan on the unit sphere ---
    d_rays, d_sphere, d_ok = _densify_inputs(dev, gen)
    n_ex = d_rays.shape[0]
    d_k, i_k = kc.knn_exact(d_rays, d_sphere, d_ok, k=3)
    d_p, i_p = kc.knn_exact_plain(d_rays, d_sphere, d_ok, k=3)
    d_more, _ = kc.knn_exact_plain(d_rays, d_sphere, d_ok, k=4)
    torch.cuda.synchronize()
    errs["K2 densify"] = _compare(f"K2 densify sim {n_ex}x{d_sphere.shape[0]} k=3", d_k, i_k,
                                  d_p, i_p, d_more, 3)
    note("K2 densify", "densify", n_ex, d_sphere.shape[0], 3,
         lambda: kc.knn_exact(d_rays, d_sphere, d_ok, k=3),
         _time_ms(lambda: kc.knn_exact_plain(d_rays, d_sphere, d_ok, k=3)))

    # --- few and ragged queries, ragged databases: K1 / K2 in both forms ---
    n_ragged, by_kernels = 0, {1: 0, 2: 0}  # shapes, and those of 1 / 2 kernels a call
    for nd in RAGGED_ND:
        db, v = rnd(nd), rnd_valid(nd)
        for nq in RAGGED_NQ:
            q = rnd(nq)
            for k, form, grouped in itertools.product(RAGGED_K, ("expanded", "diff"),
                                                      (True, False)):
                kern = kc.knn_grouped if grouped else kc.knn_exact
                plain = kc.knn_grouped_plain if grouped else kc.knn_exact_plain
                kname = ("K1" if grouped else "K2") + (" diff" if form == "diff" else "")
                before = kc.kernels_enqueued()
                d_k, i_k = kern(q, db, v, k=k, form=form)
                enqueued = kc.kernels_enqueued() - before
                if enqueued != 1 + kc.plan(nq, nd, k, sm_count, grouped).merge:
                    raise AssertionError(f"{kname} ragged {nq}x{nd} k={k}: the call enqueued "
                                         f"{enqueued} kernels against its plan")
                by_kernels[enqueued] += 1
                d_p, i_p = plain(q, db, v, k=k, form=form)
                d_more, _ = plain(q, db, v, k=k + 1, form=form)
                torch.cuda.synchronize()
                errs[kname] = max(errs[kname], _compare(
                    f"{kname} ragged {nq}x{nd} k={k}", d_k, i_k, d_p, i_p, d_more, k, quiet=True))
                n_ragged += 1
    print(f"  K1 / K2, both forms: kernel == plain at {n_ragged} few-query and ragged shapes "
          f"(nq in {RAGGED_NQ}, nd in {RAGGED_ND}, k in {RAGGED_K}); kernels a call, counted "
          f"at the launch sites: 1 at {by_kernels[1]} shapes (no split, no merge), 2 at "
          f"{by_kernels[2]}", flush=True)

    # --- an aside for the reader, no yardstick (two calls and an (Nq, Nd)
    #     matrix in device memory) and never called by the port ---
    def cdist_topk(q, db, v, k):
        d2 = torch.cdist(q, db).square_().masked_fill_(~v[None, :], float("inf"))
        return torch.topk(d2, k, dim=1, largest=False)

    for label, (q, db, v, k) in (("surf", (*cases["surf"][:3], 5)),
                                 ("depth", (rays, sphere, sphere_ok, 3))):
        print(f"  aside: torch.cdist + torch.topk at {label} {q.shape[0]}x{db.shape[0]} k={k}: "
              f"{_time_ms(lambda: cdist_topk(q, db, v, k), reps=10):.4f} ms", flush=True)

    # --- K3: strict against the plain sparse search, exact inside the radius ---
    qt, dt = kc.SPARSE_Q_TILE, kc.SPARSE_DB_TILE
    skip = {}

    def k3_case(label, q, db, v, k, presort):
        kw = dict(radius=RADIUS, q_sorted=presort, db_sorted=presort)
        d_k, i_k = kc.knn_sparse(q, db, v, k=k, **kw)
        d_p, i_p = kc.knn_sparse_plain(q, db, v, k=k, q_tile=qt, db_tile=dt, **kw)
        d_more, _ = kc.knn_sparse_plain(q, db, v, k=k + 1, q_tile=qt, db_tile=dt, **kw)
        torch.cuda.synchronize()
        name = f"K3 {label} {q.shape[0]}x{db.shape[0]} k={k}"
        errs["K3"] = max(errs.get("K3", 0.0),
                         _compare(name, d_k, i_k, d_p, i_p, d_more, k, strict=True))
        # inside the radius K3 is the exact search (difference form)
        d_x, i_x = kc.knn_exact_plain(q, db, v, k=k, form="diff")
        d_x1, _ = kc.knn_exact_plain(q, db, v, k=k + 1, form="diff")
        gate = d_x[:, -1] < RADIUS ** 2
        if not torch.equal(gate, d_k[:, -1] < RADIUS ** 2) or int(gate.sum()) < 50:
            raise AssertionError(f"{name}: gate differs from the exact search's "
                                 f"({int(gate.sum())} rows inside the radius)")
        _compare(name + " vs exact inside the radius", d_k, i_k, d_x, i_x, d_x1, k, rows=gate,
                 strict=True)
        prob = knn_plain.sparse_prepare(q, db, v, qt, dt, q_sorted=presort, db_sorted=presort)
        near = knn_plain.sparse_near(prob.q_lo, prob.q_hi, prob.d_lo, prob.d_hi, RADIUS)
        skip[label] = 1.0 - near.float().mean().item()
        # the near-tile lists that K3's blocks walk, and what 32-query tiles
        # (a warp's, tighter boxes) would give
        q32 = prob.q.view(-1, 32, 3)
        near32 = knn_plain.sparse_near(q32.amin(1), q32.amax(1), prob.d_lo, prob.d_hi, RADIUS)
        lists = [n.sum(1).float() for n in (near, near32)]
        print(f"  {name}: {skip[label]:.4f} of {near.numel()} blocks ({qt} x {dt}) skipped; near "
              f"tiles a query tile mean {lists[0].mean():.2f} max {lists[0].max():.0f} (32-query "
              f"tiles: mean {lists[1].mean():.2f} max {lists[1].max():.0f})", flush=True)
        pairs = int(near.sum().item()) * qt * dt
        boxes = (near.shape[0] + near.shape[1]) * 24
        return q, db, v, pairs, boxes

    k3_inputs = {label: k3_case(label, *args, 5, presort)
                 for label, (*args, presort) in _k3_inputs(inp).items()}
    del k3_inputs["clustered random"]

    # --- the dense / sparse crossover: K1, K2, K3 on the same presorted inputs
    #     (K1 only on the unsorted ones: it is never chosen on sorted buffers) ---
    unsorted = {"edge": cases["edge"][:3], "surf": cases["surf"][:3],
                "edge 4x": (e_q, big[0], big[1]), "surf 4x": (s_q, big[2], big[3])}
    for label, (q, db, v, pairs, boxes) in k3_inputs.items():
        plain_ms = _time_ms(lambda: kc.knn_sparse_plain(q, db, v, k=5, radius=RADIUS, q_tile=qt,
                                                        db_tile=dt, q_sorted=True,
                                                        db_sorted=True), reps=5, warmup=1)
        sort_ms = _time_ms(lambda: (kc.morton_sort(q), kc.morton_sort(db, v)))
        plain_sort_ms = _time_ms(lambda: (knn_plain.morton_sort(q), knn_plain.morton_sort(db, v)))
        note("K3", label, q.shape[0], db.shape[0], 5,
             lambda: kc.knn_sparse(q, db, v, k=5, radius=RADIUS, q_sorted=True, db_sorted=True),
             plain_ms, pairs, boxes,
             skipped=skip[label], sort_ms=sort_ms, plain_sort_ms=plain_sort_ms)
        if label.endswith("4x"):
            uq, udb, uv = unsorted[label]
            note("K2", label, q.shape[0], db.shape[0], 5,
                 lambda: kc.knn_exact(uq, udb, uv, k=5), None)
            note("K1", label, q.shape[0], db.shape[0], 5,
                 lambda: kc.knn_grouped(uq, udb, uv, k=5), None)
    for label in ("edge", "surf", "edge 4x", "surf 4x"):
        k3 = shapes["K3"][label]
        print(f"  crossover {label}: K1 {shapes['K1'][label]['ms']:.4f} ms, K2 "
              f"{shapes['K2'][label]['ms']:.4f} ms, K3 {k3['ms']:.4f} ms (presorted, "
              f"{k3['launches_per_call']} kernels) + Morton sorts of both sides "
              f"{k3['sort_ms']:.4f} ms (plain tensor code {k3['plain_sort_ms']:.4f} ms; skipped "
              f"{k3['skipped']:.4f})", flush=True)

    # --- a presorted K3 call enqueues csrc/knn.cu's kernels and nothing else,
    #     as torch.profiler sees the device ---
    from torch.profiler import ProfilerActivity, profile

    for label in ("edge 4x", "surf 4x"):
        q, db, v = k3_inputs[label][:3]
        kc.knn_sparse(q, db, v, k=5, radius=RADIUS, q_sorted=True, db_sorted=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kc.knn_sparse(q, db, v, k=5, radius=RADIUS, q_sorted=True, db_sorted=True)
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        outside = [n for n in seen if "knn_sparse_kernel" not in n
                   and "knn_sparse_box_kernel" not in n]
        planned = kc.sparse_plan(q.shape[0], db.shape[0], sm_count).kernels
        if outside or sum(seen.values()) != planned:
            raise AssertionError(f"K3 {label}: a presorted call ran {seen} on the device; its "
                                 f"plan says {planned} kernels of csrc/knn.cu")
        print(f"  K3 {label}: torch.profiler sees {sum(seen.values())} kernels of a presorted "
              f"call, all in csrc/knn.cu "
              f"({', '.join(re.sub(r'^void |.anonymous namespace.::|[(].*$', '', n) for n in seen)})",
              flush=True)

    # --- the Morton-key kernels against the plain keys, at the sides the
    #     sparse path sorts ---
    merr = 0
    for label, (pts, ok) in (("surf 4x map", big[2:4]), ("edge 4x map", big[0:2]),
                             ("surf queries", (s_q, None)), ("edge queries", (e_q, None))):
        keys = kc.morton_keys(pts, ok)
        keys_p = knn_plain.morton_keys(pts, ok)
        same_perm = torch.equal(kc.morton_sort(pts, ok), knn_plain.morton_sort(pts, ok))
        torch.cuda.synchronize()
        err = (keys.long() - keys_p.long()).abs().max().item()
        merr = max(merr, err)
        if err or not same_perm:
            raise AssertionError(f"Morton keys {label}: max |key - plain key| {err}, same "
                                 f"permutation {same_perm}")
        n = pts.shape[0]
        moved = n * (12 + 4) + (0 if ok is None else n)  # points and keys once, validity
        print(f"  Morton keys {label} ({n} points): kernel == plain on every key, same "
              f"permutation", flush=True)
        note("Morton keys", label, n, n, 1, lambda: kc.morton_keys(pts, ok),
             _time_ms(lambda: knn_plain.morton_keys(pts, ok)),
             bound=(moved / PEAK_BYTES_PER_S * 1e3, "bytes"), shape=f"{n} points")
    errs["Morton keys"] = merr

    # --- hash kNN (plain tensor code, no kernel) against K1 at the association shapes ---
    hash_ms = {}
    for label, res, rad in (("edge", 0.4, 3), ("surf", 0.8, 2)):
        q, db, v = cases[label][:3]
        hash_ms[label] = _time_ms(lambda: hash_knn.hash_knn(q, db, v, res, origin, k=5, radius=rad))
        print(f"  hash_knn {label} {q.shape[0]}x{db.shape[0]} k=5 radius {rad}: "
              f"{hash_ms[label]:.4f} ms against K1 {shapes['K1'][label]['ms']:.4f} ms", flush=True)

    def record(kname, wrapper, replaces, main):
        s = shapes[kname][main]
        return dict(name=f"{kname} {wrapper}", route="cuda",
                    source="vil_fusion_tpu_torch/csrc/knn.cu", replaces=replaces,
                    max_abs_err=errs[kname], shape=f"{main} {s['shape']}", ms=s["ms"],
                    plain_ms=s["plain_ms"], bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                    library_ms=None, launches_per_call=s["launches_per_call"],
                    shapes=shapes[kname])

    pk = "vil_fusion_tpu/ops/pallas/knn_pallas.py"
    records = {
        "K1": record("K1", "knn_grouped", f"{pk}:202", "surf"),
        "K2": record("K2", "knn_exact", f"{pk}:53", "icp"),
        "K2 densify": record("K2 densify", "knn_exact", f"{pk}:53", "densify"),
        "K3": record("K3", "knn_sparse", f"{pk}:290", "surf 4x"),
        "K1 diff": record("K1 diff", "knn_grouped(form='diff')", f"{pk}:45", "surf"),
        "K2 diff": record("K2 diff", "knn_exact(form='diff')", f"{pk}:45", "icp"),
        "Morton keys": record("Morton keys", "morton_keys", f"{pk}:379", "surf 4x map"),
    }
    records["K1"]["hash_knn_ms"] = hash_ms
    return records


def _counts(kc):
    """Launch counts of the six kernels since the last _reset."""
    return {"K1": kc.knn_grouped.launches - kc.knn_grouped.launches_diff,
            "K2": kc.knn_exact.launches - kc.knn_exact.launches_diff,
            "K3": kc.knn_sparse.launches,
            "K1 diff": kc.knn_grouped.launches_diff, "K2 diff": kc.knn_exact.launches_diff,
            "Morton keys": kc.morton_keys.launches}


def _reset(kc):
    kc.reset_counts()


def _on_card(states, dev):
    import torch

    off = [k for k, v in states.items() if v.device.type != torch.device(dev).type]
    if off:
        raise AssertionError(f"state tensors not on the card: {off}")


def _pose_errors(name, lidar_p, lidar_q, frames, bound):
    """Per-frame position error against the simulator's ground truth in the
    odometry frame (the first body frame); checks shape, finiteness and the
    end-position bound."""
    import numpy as np

    n = len(frames)
    lidar_p, lidar_q = np.stack(lidar_p), np.stack(lidar_q)
    if lidar_p.shape != (n, 3) or not (np.isfinite(lidar_p).all() and np.isfinite(lidar_q).all()):
        raise AssertionError(f"{name}: odometry poses: shape {lidar_p.shape}, finite "
                             f"{np.isfinite(lidar_p).all()}")
    R0, p0 = frames[0][3], frames[0][4]
    gt = np.stack([R0.T @ (fr[4] - p0) for fr in frames])
    errs = np.linalg.norm(lidar_p - gt, axis=1)
    print(f"  {name}: end-position error {errs[-1]:.4f} m (bound {bound} m), "
          f"max {errs.max():.4f} m over {np.linalg.norm(gt[-1]):.1f} m of travel", flush=True)
    if not errs[-1] < bound:
        raise AssertionError(f"{name}: end-position error {errs[-1]:.4f} m >= {bound} m")
    return errs


def _lidar_path(name, frames, warmup, dev, card, overrides=None, need=(), prewarm=False):
    """One run of VILFusionPipeline(mode="lidar") over `frames` (the first
    `warmup` untimed), with `overrides` on the odometry configuration.
    `need` maps kernel names to their least launches per timed frame; 0
    asks for at least one launch in the whole run (the ICP of `prewarm`).
    Returns (launch counts of the run, timed frames per second, pipeline)."""
    import torch

    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    pipe = VILFusionPipeline(_rig(), mode="lidar", odom_overrides=overrides,
                             scan_quant=SCAN_QUANT, device=dev)
    _reset(kc)
    for fr in frames[:warmup]:
        pipe.push_scan(fr[0], fr[1], fr[2])
    torch.cuda.synchronize()
    warm_counts = _counts(kc)
    t0 = time.perf_counter()
    for fr in frames[warmup:]:
        pipe.push_scan(fr[0], fr[1], fr[2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    timed_counts = {k: v - warm_counts[k] for k, v in _counts(kc).items()}
    if prewarm:
        pipe.fusion.prewarm()
    pipe.finalize()
    torch.cuda.synchronize()
    counts = _counts(kc)

    _on_card({**{f"lidar_state.{k}": v for k, v in pipe.lidar_state._asdict().items()},
              **{f"graph.{k}": v for k, v in pipe.fusion.graph._asdict().items()},
              **{f"scdb.{k}": v for k, v in pipe.fusion.scdb._asdict().items()},
              "clouds": pipe.fusion.clouds, "cloud_valid": pipe.fusion.cloud_valid}, dev)
    n_timed = len(frames) - warmup
    for kname, per_frame in dict(need).items():
        least = max(1, per_frame * n_timed)
        got = timed_counts[kname] if per_frame else counts[kname]
        if got < least:
            raise AssertionError(f"{name}: {kname} launched {got} times (need >= {least})")
    import numpy as np

    q_kf, p_kf = pipe.fusion.poses()
    if pipe.fusion.n_kf < 1 or not (np.isfinite(q_kf).all() and np.isfinite(p_kf).all()):
        raise AssertionError(f"{name}: keyframe graph: {pipe.fusion.n_kf} nodes, finite "
                             f"{np.isfinite(p_kf).all()}")
    print(f"  {name}: {len(frames)} frames, {pipe.fusion.n_kf} keyframes, loops "
          f"{pipe.fusion.loops_found}, launches {counts}", flush=True)
    return counts, n_timed / dt, pipe


def _front_end_path(frames, images, dev, card):
    """Phase 6: vil_front_end over `frames` + `images` on the card."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import lidar_odometry as lo
    from vil_fusion_tpu_torch.models import tracker as trk
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime import pipeline as pl
    from vil_fusion_tpu_torch.runtime import sim

    rig = _rig()
    fe = pl.front_end_config(rig, scan_quant=SCAN_QUANT, device=dev)
    ts = trk.init_tracker(IMG_H, IMG_W, fe.tcfg, device=dev)
    ls = lo.init_state(fe.lcfg, device=dev)
    gen = torch.Generator(device=dev)
    host = [(np.clip(np.round(fr[1] * (1.0 / SCAN_QUANT)), -32767, 32767).astype(np.int16),
             np.packbits(fr[2])) for fr in frames]
    _reset(kc)
    outs = []
    t0 = None
    for i, (fr, img, (p16, v8)) in enumerate(zip(frames, images, host)):
        if i == FRONT_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        k2 = kc.knn_exact.launches
        ts, ls, out = pl.vil_front_end(
            ts, ls, torch.from_numpy(img).to(dev), torch.from_numpy(p16).to(dev),
            torch.from_numpy(v8).to(dev), fr[0], fe, frame_index=i, generator=gen)
        if kc.knn_exact.launches != k2 + 1 or kc.knn_exact.last_call != (fe.tcfg.cap, len(fr[2]), 3):
            raise AssertionError(f"front end frame {i}: K2 launches {kc.knn_exact.launches - k2}, "
                                 f"last call {kc.knn_exact.last_call}")
        outs.append(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts(kc)
    n = len(frames)
    if counts["K2"] != n or counts["K1"] < n - 1:
        raise AssertionError(f"front end: launches {counts} over {n} frames")
    _on_card({**{f"tracker.{k}": v for k, v in ts._asdict().items()},
              **{f"lidar.{k}": v for k, v in ls._asdict().items()},
              **{f"out.{k}": v for k, v in outs[-1].items()}}, dev)
    for k in ("ids", "xy", "vel", "depth", "tsh", "q_imu", "p_imu"):
        v = outs[-1][k]
        if v.shape[0] != (4 if k == "q_imu" else 3 if k == "p_imu" else fe.tcfg.cap) \
                or not torch.isfinite(v.float()).all():
            raise AssertionError(f"front end: output {k} has shape {tuple(v.shape)} or "
                                 f"non-finite values")
    _pose_errors("front end", [o["lidar_p"].cpu().numpy() for o in outs],
                 [o["lidar_q"].cpu().numpy() for o in outs], frames, END_ERR_BOUND_M)

    # features: live tracks per frame after warm-up, and lidar depth against
    # the simulator's own raycast along each feature's ray
    scene = sim.RaycastScene()
    r_bc = np.array(R_BC)
    live, tracked, strong_n, depth_errs = [], [], [], []
    for fr, o in list(zip(frames, outs))[FRONT_WARMUP:]:
        valid = o["valid"].cpu().numpy()
        live.append(int(valid.sum()))
        tracked.append(int((valid & (o["track_cnt"].cpu().numpy() > 1)).sum()))
        depth = o["depth"].cpu().numpy()
        strong = valid & (depth > 0)
        strong_n.append(int(strong.sum()))
        xy = o["xy"].cpu().numpy()[strong].astype(np.float64)
        rays = np.concatenate([xy, np.ones((len(xy), 1))], -1)
        norm = np.linalg.norm(rays, axis=-1, keepdims=True)
        dirs_w = (rays / norm) @ (fr[3] @ r_bc).T
        t_hit = scene.raycast(np.broadcast_to(fr[4], dirs_w.shape), dirs_w, max_range=120.0)
        hit = np.isfinite(t_hit)
        depth_errs.append(np.abs(depth[strong][hit] - t_hit[hit] / norm[hit, 0]))
    depth_errs = np.concatenate(depth_errs)
    med = float(np.median(depth_errs)) if len(depth_errs) else float("inf")
    print(f"  front end: live features per timed frame min {min(live)} mean "
          f"{np.mean(live):.1f} of {rig.max_cnt}; tracked from the frame before min "
          f"{min(tracked)} mean {np.mean(tracked):.1f}; strong lidar depths per frame mean "
          f"{np.mean(strong_n):.1f}", flush=True)
    print(f"  front end: median |lidar depth - raycast z-depth| {med:.4f} m over "
          f"{len(depth_errs)} strong depths (bound {DEPTH_ERR_BOUND_M} m), 90th percentile "
          f"{np.percentile(depth_errs, 90):.4f} m", flush=True)
    if min(live) < MIN_LIVE or np.mean(tracked) < MIN_TRACKED_MEAN or min(tracked) < MIN_TRACKED:
        raise AssertionError(f"front end: live {live}, tracked {tracked} of {rig.max_cnt} "
                             f"(need live >= {MIN_LIVE}, tracked mean >= {MIN_TRACKED_MEAN} "
                             f"and min >= {MIN_TRACKED})")
    if len(depth_errs) < 10 * FRONT_TIMED or not med < DEPTH_ERR_BOUND_M:
        raise AssertionError(f"front end: {len(depth_errs)} strong depths, median error {med} m")
    print(f"  front end: {FRONT_TIMED / dt:.3f} frames/s over {FRONT_TIMED} frames after "
          f"{FRONT_WARMUP} warm-up frames, launches {counts} [{card}]", flush=True)
    return counts


def _vil_path(frames, images, dev, card, sync_depth=0):
    """Phase 7 (sync_depth=0) and phase 8 (sync_depth=2, the bench's
    deployment configuration): VILFusionPipeline(mode="vil") over `frames` +
    `images` with 200 Hz IMU from the oracle initial state. With
    sync_depth > 0 every steady frame must be issued (_issue_frame) and
    completed (_complete_frame) sync_depth frames later. Returns (launch
    counts of the run, timed frames/s, the per-frame positions)."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import window
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    name = "vil" if sync_depth == 0 else "deferred"
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    imus = [None] + [sim.simulate_imu(traj, fr[0] - FRAME_DT, fr[0], IMU_RATE)
                     for fr in frames[1:]]
    pipe = VILFusionPipeline(_rig(), mode="vil", sync_depth=sync_depth, scan_quant=SCAN_QUANT,
                             device=dev)
    q0, p0 = traj.pose(frames[0][0])
    pipe.estimator.set_initial_state(p=p0 + np.array([0.0, 0.0, 1.5]), q=q0,
                                     v=traj.velocity(frames[0][0]))
    issued, completed = [], []
    issue, complete = pipe._issue_frame, pipe._complete_frame

    def issue_rec(t, *a):
        issued.append(t)
        return issue(t, *a)

    def complete_rec(rec):
        completed.append(rec["t"])
        return complete(rec)

    pipe._issue_frame, pipe._complete_frame = issue_rec, complete_rec
    _reset(kc)
    keys, per_frame = [], []
    t0 = None
    for i, (fr, img, imu) in enumerate(zip(frames, images, imus)):
        if i == VIL_WARMUP:
            torch.cuda.synchronize()
            GLOBAL_TIMERS.reset()
            t0 = time.perf_counter()
        k1, k2 = _counts(kc)["K1"], _counts(kc)["K2"]
        fused = pipe.estimator.fused_steps
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        pipe.push_scan(fr[0], fr[1], fr[2])
        pipe.push_image(fr[0], img)
        c = _counts(kc)
        per_frame.append((c["K1"] - k1, c["K2"] - k2))
        # K1: the odometry's two association passes (edge, surf) a frame,
        # both passes twice on the cold frames 1 and 2, none on frame 0;
        # K2: one depth association a frame
        want = (0 if i == 0 else 4 if i < 3 else 2, 1)
        if per_frame[-1] != want:
            raise AssertionError(f"{name} frame {i}: K1 / K2 launches {per_frame[-1]}, want "
                                 f"{want}")
        if pipe.restarts:
            raise AssertionError(f"{name} frame {i}: restart {pipe.restart_log}")
        if i >= window.K - 1:
            if pipe.estimator.fused_steps != fused + 1:
                raise AssertionError(f"{name} frame {i}: the steady frame skipped "
                                     f"fused_full_step")
            keys.append(pipe.estimator.last_is_key)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pipe.finalize()
    counts = _counts(kc)
    est = pipe.estimator
    _on_card({**{f"window.{k}": v for k, v in est.window._asdict().items()},
              **{f"feats.{k}": v for k, v in est.feats._asdict().items()},
              **{f"pre.{k}": v for k, v in est.pre._asdict().items()},
              "prior.J": est.prior.J, **{f"tracker.{k}": v for k, v in
                                         pipe.tracker_state._asdict().items()}}, dev)
    steady = [fr[0] for fr in frames[window.K - 1:]]
    if sync_depth and not (issued == completed == steady):
        raise AssertionError(f"{name}: issued {len(issued)}, completed {len(completed)} of the "
                             f"{len(steady)} steady frames")
    vio_p = np.stack(pipe.outputs.vio_p)
    if vio_p.shape != (len(frames), 3) or not (np.isfinite(vio_p).all()
                                              and np.isfinite(np.stack(pipe.outputs.vio_q)).all()):
        raise AssertionError(f"{name}: outputs of shape {vio_p.shape} or not finite")
    errs = np.linalg.norm(vio_p - np.stack([fr[4] for fr in frames]), axis=1)
    lidar_gt = np.stack([frames[0][3].T @ (fr[4] - frames[0][4]) for fr in frames])
    lidar_errs = np.linalg.norm(np.stack(pipe.outputs.lidar_p) - lidar_gt, axis=1)
    stages = GLOBAL_TIMERS.summary()
    print(f"  {name}: sync_depth={sync_depth}, {VIL_TIMED / dt:.3f} frames/s over {VIL_TIMED} "
          f"frames after {VIL_WARMUP} warm-up frames [{card}]", flush=True)
    print(f"  {name}: host ms per timed frame (GLOBAL_TIMERS mean / p50): " + ", ".join(
        f"{k} {stages[k]['mean_ms']:.2f} / {stages[k]['p50_ms']:.2f}"
        for k in ("tracker", "lidar_odometry", "depth_association", "estimator", "feed_uploads",
                  "vil_fused_frame", "global_fusion") if k in stages), flush=True)
    print(f"  {name}: fused steps {est.fused_steps} of {len(steady)} steady frames"
          + (f" (issued {len(issued)}, completed {len(completed)})" if sync_depth else "")
          + f", keyframes {sum(keys)}, non-keyframes {len(keys) - sum(keys)}, restarts "
          f"{pipe.restarts}", flush=True)
    print(f"  {name}: K1 / K2 launches per frame {per_frame} (as planned)", flush=True)
    print(f"  {name}: end-position error {errs[-1]:.4f} m (bound {VIL_END_ERR_BOUND_M} m; JAX "
          f"package on the CPU at 32 x 900 scans: {VIL_REF_END_ERR_M} m), max {errs.max():.4f} m "
          f"over {np.linalg.norm(frames[-1][4] - frames[0][4]):.1f} m of travel; per frame "
          f"{np.round(errs, 4).tolist()}; lidar odometry end error {lidar_errs[-1]:.4f} m",
          flush=True)
    if not errs[-1] < VIL_END_ERR_BOUND_M:
        raise AssertionError(f"{name}: end-position error {errs[-1]:.4f} m >= "
                             f"{VIL_END_ERR_BOUND_M} m")
    return counts, VIL_TIMED / dt, vio_p


def _cold_start(dev, frame=None):
    """Phase 7, second run: the cold start on tests/test_e2e_loop.py's rig
    until the estimator initializes (at most COLD_FRAME_CAP frames), then
    COLD_AFTER_INIT frames more; no restart. `frame(i)` gives frame i
    (cold_start_frame by default). Returns launch counts."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    rig, odom, gf_kw, traj, scene = cold_start_rig(sim, RigConfig)
    pipe = VILFusionPipeline(rig, mode="vil", sync_depth=0, odom_overrides=odom,
                             gf_cfg=gf.GlobalFusionConfig(**gf_kw), device=dev)
    _reset(kc)
    init = None
    t0 = time.perf_counter()
    for i in range(COLD_FRAME_CAP):
        t, imu, img, pts, val = (frame or functools.partial(cold_start_frame, sim, traj,
                                                            scene))(i)
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)
        if pipe.restarts:
            raise AssertionError(f"cold start frame {i}: restart {pipe.restart_log}")
        if pipe.estimator.initialized and init is None:
            init = i
        if init is not None and i >= init + COLD_AFTER_INIT:
            break
    torch.cuda.synchronize()
    if init is None:
        raise AssertionError(f"cold start: not initialized within {COLD_FRAME_CAP} frames")
    p = np.stack(pipe.outputs.vio_p)
    if not np.isfinite(p).all():
        raise AssertionError("cold start: non-finite poses")
    print(f"  cold start: initialized at frame {init} (JAX package on the CPU: frame "
          f"{COLD_REF_INIT_FRAME}; the RANSAC draws from another generator), attempts refused "
          f"before it {pipe.estimator.init_failures}, {i + 1} frames in "
          f"{time.perf_counter() - t0:.1f} s, restarts {pipe.restarts}, fused steps "
          f"{pipe.estimator.fused_steps}", flush=True)
    return _counts(kc)


def _loop_path(dev, card, frame=None):
    """Phase 9: tests/test_e2e_loop.py's lap on the card, visual loop on its
    worker thread, sync_depth=2. Returns launch counts, with "K2 densify" the
    worker's K2 launches at the densification shape (extra corners x this
    frame's scan); fails on any of that test's asserts, on a worker error,
    and if the densification never reached K2. `frame(i)` gives frame i
    (cold_start_frame by default)."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.models import visual_loop as vl
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime import sim, tum
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    rig, odom, gf_kw, traj, scene = cold_start_rig(sim, RigConfig)
    pipe = VILFusionPipeline(rig, mode="vil", visual_loop=True, sync_depth=2,
                             odom_overrides=odom, gf_cfg=gf.GlobalFusionConfig(**gf_kw),
                             vl_cfg=vl.VisualLoopConfig(**LOOP_VL), device=dev)
    _reset(kc)
    GLOBAL_TIMERS.reset()
    marks = {}

    def on_frame(i):
        if i in (LOOP_FRAMES // 4, LOOP_FRAMES // 2, 3 * LOOP_FRAMES // 4):
            marks[i] = time.perf_counter() - t0
            print(f"  loop: frame {i} after {marks[i]:.1f} s", flush=True)

    t0 = time.perf_counter()
    r = loop_lap(pipe, sim, tum, traj, scene, LOOP_FRAMES, on_frame, frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(kc)
    calls = kc.knn_exact.calls_by_stage.get("visual_loop", {})
    n_pts = 32 * 600
    counts["K2 densify"] = calls.get((pipe.visual_loop.cfg.extra_cap, n_pts, 3), 0)
    worker = {k: getattr(kc, w).launches_by_stage.get("visual_loop", 0)
              for k, w in (("K1", "knn_grouped"), ("K2", "knn_exact"), ("K3", "knn_sparse"))}
    stages = GLOBAL_TIMERS.summary()
    st = pipe.visual_loop.stats_summary()
    print(f"  loop: {LOOP_FRAMES} frames in {wall:.1f} s ({LOOP_FRAMES / wall:.3f} frames/s, "
          f"rendering included) [{card}]", flush=True)
    print(f"  loop: initialized at frame {r['init_frame']} (JAX on the CPU: "
          f"{LOOP_REF['init_frame']}), restarts {r['restarts']}, outputs {r['outputs']}, "
          f"ScanContext loops {r['sc_loops']} (JAX {LOOP_REF['sc_loops']}), visual loops "
          f"{r['visual_loops']} (JAX {LOOP_REF['visual_loops']}), first visual loop at frame "
          f"{r['loop_frame']} (JAX {LOOP_REF['loop_frame']})", flush=True)
    print(f"  loop: ATE VIO {r['ate_vio']:.4f} m, fs_loam_loop {r['ate_fs']:.4f} m, loop path "
          f"{r['ate_loop']:.4f} m (JAX: {LOOP_REF['ate_vio']} / {LOOP_REF['ate_fs']} / "
          f"{LOOP_REF['ate_loop']} m); VIO error around the first visual loop: max before "
          f"{r['vio_err_pre_max']}, min after {r['vio_err_post_min']}", flush=True)
    print(f"  loop: visual-loop DB {pipe.visual_loop.n} keyframes, gates {json.dumps(st)}",
          flush=True)
    print(f"  loop: launches {counts}; of them on the worker thread {worker}; K2 calls there "
          f"by shape {calls}; worker errors {pipe.vl_errors}", flush=True)
    print("  loop: host ms per frame (GLOBAL_TIMERS mean / p50 / n): " + ", ".join(
        f"{k} {v['mean_ms']:.2f} / {v['p50_ms']:.2f} / {v['n']}" for k, v in stages.items()),
        flush=True)
    bad = loop_gates(r, LOOP_FRAMES)
    if pipe.vl_errors:
        bad.append(f"{pipe.vl_errors} visual-loop worker errors")
    if counts["K2 densify"] < 1:
        bad.append(f"the densification never launched K2 at ({pipe.visual_loop.cfg.extra_cap}, "
                   f"{n_pts}, 3): {calls}")
    if bad:
        raise AssertionError("loop: " + "; ".join(bad))
    _on_card({"hists": pipe.visual_loop.hists,
              **{f"graph4.{k}": v for k, v in pipe.visual_loop.graph._asdict().items()}}, dev)
    return counts


def _mask_path(dev, card):
    """Phase 10: mode "mask" on tests/test_pipeline.py:263's sequence, 16
    frames from the oracle state: no more than 2 tracked features inside
    the moving object's core on any frame, no restart, error < 0.5 m."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    frames, (p0, q0, v0) = mask_frames(sim, MASK_FRAMES)
    pipe = VILFusionPipeline(mask_rig(sim, RigConfig), mode="mask", device=dev)
    pipe.estimator.set_initial_state(p=p0, q=q0, v=v0)
    errs, inside = [], []
    t0 = time.perf_counter()
    for t, imu, img, mask, box, p in frames:
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        pipe.push_image(t, img, mask=mask)
        errs.append(float(np.linalg.norm(pipe.outputs.vio_p[-1] - p)))
        ts = pipe.tracker_state
        inside.append(mask_inside(ts.xy[ts.valid].cpu().numpy(), box))
    dt = time.perf_counter() - t0
    print(f"  mask: {MASK_FRAMES} frames in {dt:.1f} s; tracked features inside the object per "
          f"frame {inside} (bound 2); error max {max(errs):.4f} m (bound 0.5; JAX on the CPU: "
          f"{MASK_REF['max_err_m']} m), end {errs[-1]:.4f} m; restarts {pipe.restarts}; fused "
          f"steps {pipe.estimator.fused_steps} [{card}]", flush=True)
    if max(inside) > 2 or pipe.restarts or not max(errs) < 0.5:
        raise AssertionError(f"mask: inside {inside}, restarts {pipe.restarts}, errors {errs}")
    _on_card({f"tracker.{k}": v for k, v in pipe.tracker_state._asdict().items()}, dev)


def _circuit_world():
    """11a's scene (tools/run_synthetic.py's circuit) and its frame-5 body pose."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim

    r = CIRCUIT["radius"]
    traj = sim.LoopTrajectory(radius=r, period=2 * np.pi * r / 8.0)
    t = 1.0 + CIRCUIT_FRAME * FRAME_DT
    return (sim.urban_block_scene(r, pillar_step_deg=CIRCUIT["pillar_step_deg"],
                                  box_step_deg=CIRCUIT["box_step_deg"]),
            traj.rotation(t), traj.position(t) + np.array([0.0, 0.0, 1.5]))


def _circuit_numpy(kind: str):
    """11a's numpy reference (in a pool process): the HDL-64 scan or the
    1226 x 370 image of the circuit frame, with its host seconds."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim

    scene, R, p = _circuit_world()
    t0 = time.perf_counter()
    if kind == "scan":
        out = sim.simulate_lidar_scan(scene, R, p, **SCAN)
    else:
        out = sim.render_camera_image(scene, R @ np.array(R_BC), p, FX, FX, CX, CY, IMG_H, IMG_W)
    return out, time.perf_counter() - t0


def _raycast_phase(dev, card, numpy_async):
    """11a: TorchRaycast on the card against the numpy raycast (computed in
    the pool) on the circuit frame, with tests/test_sim.py's gates: scan
    validity agreement > 99.5% and points within 2e-3 m where both hit,
    uint8 images within +-1 grey level on > 99.5% of pixels. Prints the
    CUDA-event ms of a scan and of an image on the card (the device work,
    no host copy) beside the numpy seconds."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim

    scene, R, p = _circuit_world()
    rc = sim.TorchRaycast(scene, device=dev)
    R_c = R @ np.array(R_BC)
    cam = (FX, FX, CX, CY, IMG_H, IMG_W)
    pts, val = sim.simulate_lidar_scan(rc, R, p, **SCAN)
    img = rc.render_image_u8(R_c, p, *cam)
    scan_ms = _time_ms(lambda: rc.scan_ranges_device(R, p, **SCAN), reps=10)
    image_ms = _time_ms(lambda: rc.image_u8_device(R_c, p, *cam), reps=10)
    ((pts_np, val_np), scan_s), (img_np, image_s) = numpy_async.get()
    agree = float((val == val_np).mean())
    both = val & val_np
    err = float(np.abs(pts[both] - pts_np[both]).max())
    u_np = np.clip(img_np * 255.0 + 0.5, 0, 255).astype(np.uint8)
    close = float((np.abs(img.astype(int) - u_np.astype(int)) <= 1).mean())
    print(f"  raycast: circuit scene ({len(scene.pillars)} pillars, {len(scene.boxes)} boxes), "
          f"frame {CIRCUIT_FRAME}: HDL-64 scan {SCAN['n_scan'] * SCAN['width']} rays "
          f"{scan_ms:.3f} ms on the card, numpy {scan_s:.2f} s; {IMG_W} x {IMG_H} image "
          f"{image_ms:.3f} ms on the card, numpy {image_s:.2f} s (CUDA events, median of 10; "
          f"numpy on one host core) [{card}]", flush=True)
    print(f"  raycast: scan validity agreement {agree:.5f} ({int(val.sum())} / "
          f"{int(val_np.sum())} hits), largest point distance {err:.2e} m; image pixels within "
          f"+-1 grey {close:.5f}", flush=True)
    if not (agree > 0.995 and both.sum() > 10000 and err < 2e-3 and close > 0.995):
        raise AssertionError(f"raycast: agreement {agree}, hits {both.sum()}, error {err}, "
                             f"image {close}")


def _replay_path(frames, images, dev, card):
    """11b: phase 4's scans (valid points only, as KITTI stores them) and
    the first REPLAY_IMAGES images of phase 6 (PNG, the port's encoder)
    written as a KITTI odometry sequence under build/, with the simulator's
    poses, then run_dataset.main(mode="lidar") on the card: every frame
    out, the TUM files and report.json written, the ring dropped nothing,
    K1 launched on every frame after the first, end error within
    END_ERR_BOUND_M. Returns the launch counts."""
    import contextlib
    import shutil

    import numpy as np
    import torch

    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime import datasets, tum
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.tools import run_dataset

    root = ROOT / "build" / "smoke_kitti"
    out = root / "out"
    shutil.rmtree(root, ignore_errors=True)
    R0, p0 = frames[0][3], frames[0][4]
    poses = [np.concatenate([R0.T @ fr[3], (R0.T @ (fr[4] - p0))[:, None]], 1) for fr in frames]
    t0 = time.perf_counter()
    datasets.write_kitti_odometry(str(root), "00", [fr[0] for fr in frames],
                                  [fr[1][fr[2]] for fr in frames], images[:REPLAY_IMAGES], poses)
    write_s = time.perf_counter() - t0
    per_frame = []
    step = VILFusionPipeline._process_lidar_only

    def counted(pipe, *a):
        k1 = _counts(kc)["K1"]
        res = step(pipe, *a)
        per_frame.append(_counts(kc)["K1"] - k1)
        return res

    VILFusionPipeline._process_lidar_only = counted
    _reset(kc)
    try:
        out.mkdir(parents=True)
        with open(out / "stdout.txt", "w") as log, contextlib.redirect_stdout(log):
            rep = run_dataset.main(["--dataset", "kitti", "--data", str(root), "--seq", "00",
                                    "--config", str(ROOT / "configs" / "kitti.yaml"),
                                    "--mode", "lidar", "--out", str(out),
                                    "--device", torch.device(dev).type])
    finally:
        VILFusionPipeline._process_lidar_only = step
    torch.cuda.synchronize()
    counts = _counts(kc)
    st = rep["replay"]
    files = ["report.json", "lidar_odometry.txt", "vins_result_no_loop.txt", "trajectories.png",
             "map.png"]
    missing = [f for f in files if not (out / f).is_file()]
    _, ps, qs = tum.read_tum(str(out / "lidar_odometry.txt"))
    print(f"  replay: wrote {len(frames)} scans ({sum(int(fr[2].sum()) for fr in frames)} valid "
          f"points) and {REPLAY_IMAGES} PNG images in {write_s:.2f} s; run_dataset: "
          f"{rep['frames']} frames, {st['events']} events in {st['wall_s']:.2f} s = "
          f"{rep['frames'] / st['wall_s']:.3f} frames/s, {st['events'] / st['wall_s']:.2f} "
          f"events/s; ring dropped {st['dropped']}, consumer waited {st['wait_s']:.3f} s, "
          f"producer lead mean {st['lead_mean']:.2f} max {st['lead_max']} events [{card}]",
          flush=True)
    print(f"  replay: K1 launches per frame {per_frame}; launches {counts}; ATE (report) "
          f"{rep.get('ate_rmse_vio')}", flush=True)
    _pose_errors("replay", list(ps), list(qs), frames, END_ERR_BOUND_M)
    bad = []
    if rep["frames"] != len(frames) or len(ps) != len(frames) or missing:
        bad.append(f"{rep['frames']} frames, {len(ps)} TUM rows, missing {missing}")
    if st["dropped"] or st["events"] != len(frames) + REPLAY_IMAGES:
        bad.append(f"ring dropped {st['dropped']}, {st['events']} events")
    if (len(per_frame) != len(frames) or min(per_frame[1:]) < 1
            or rep["device"] != torch.device(dev).type):
        bad.append(f"K1 per frame {per_frame}, device {rep['device']}")
    if bad:
        raise AssertionError("replay: " + "; ".join(bad))
    return counts


def _synthetic_path(dev, card):
    """11c: run_synthetic.main over SYNTH_FRAMES frames of the KITTI-scale
    circuit: cold start, visual loop, sync_depth=2, frames rendered by
    TorchRaycast in the ring bus's producer thread. Gates: every frame out,
    no restart, no visual-loop worker error, the ring dropped nothing, K1
    and K2 launched, the fusion keyframes' ATE and the lidar end error
    within SYNTH_BOUND_M. Returns the launch counts."""
    import contextlib

    import torch

    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.tools import run_synthetic

    out = ROOT / "build" / "smoke_synthetic"
    out.mkdir(parents=True, exist_ok=True)
    _reset(kc)
    with open(out / "stdout.txt", "w") as log, contextlib.redirect_stdout(log):
        rep = run_synthetic.main(["--frames", str(SYNTH_FRAMES), "--out", str(out),
                                  "--device", torch.device(dev).type])
    torch.cuda.synchronize()
    counts = _counts(kc)
    st = rep["replay"]
    print(f"  synthetic: {rep['frames']} frames in {rep['wall_s']} s = {rep['fps']} frames/s "
          f"(cold start included); render {rep['render_ms_per_frame']:.2f} ms a frame in the "
          f"producer thread (host clock, scan + image); {st['events']} events, ring dropped "
          f"{st['dropped']}, consumer waited {st['wait_s']:.3f} s, producer lead mean "
          f"{st['lead_mean']:.2f} max {st['lead_max']} [{card}]", flush=True)
    print(f"  synthetic: initialized at frame {rep['first_initialized_frame']} "
          f"({rep['frames_initialized']} frames initialized), restarts {rep['restarts']}, "
          f"visual-loop worker errors {rep['vl_errors']}; ATE VIO {rep['ate_rmse_vio']}, "
          f"fusion keyframes {rep.get('ate_rmse_fusion')} m, lidar end error "
          f"{rep['lidar_end_err_m']:.4f} m (bounds {SYNTH_BOUND_M} m); launches {counts}",
          flush=True)
    bad = []
    if rep["frames"] != SYNTH_FRAMES or rep["restarts"] or rep["vl_errors"] or st["dropped"]:
        bad.append(f"{rep['frames']} frames, restarts {rep['restart_log']}, worker errors "
                   f"{rep['vl_errors']}, dropped {st['dropped']}")
    if counts["K1"] < 1 or counts["K2"] < 1:
        bad.append(f"launches {counts}")
    if not (rep.get("ate_rmse_fusion", float("inf")) < SYNTH_BOUND_M
            and rep["lidar_end_err_m"] < SYNTH_BOUND_M):
        bad.append(f"fusion ATE {rep.get('ate_rmse_fusion')}, lidar end error "
                   f"{rep['lidar_end_err_m']}")
    if bad:
        raise AssertionError("synthetic: " + "; ".join(bad))
    return counts


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    card = _card_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    sys.path.insert(0, str(ROOT))
    import vil_fusion_tpu_torch  # noqa: F401  (sets the TF32-off policy)
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # the numpy simulator runs in a pool of processes: the HDL-64 scans while
    # the kernels build, the lap's frames (phases 7 and 9) ahead of their use
    n_procs = max(1, min(6, (os.cpu_count() or 2) - 2))
    pool = multiprocessing.get_context("spawn").Pool(n_procs)
    try:
        return _phases(card, dev, kc, pool, n_procs, t_start)
    finally:
        pool.terminate()
        pool.join()


def _phases(card, dev, kc, pool, n_procs, t_start) -> int:
    """Phases 2-11 of main(), the simulator's frames made in `pool`."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    # in the order they are needed: the scans, the rolling-shutter scans, the
    # camera images (at the trajectory's poses), the lap
    scans = pool.starmap_async(_scan_frame, [(i, False) for i in range(WARMUP_FRAMES
                                                                        + TIMED_FRAMES)])
    distorted_async = pool.starmap_async(
        _scan_frame, [(i, True) for i in range(SHORT_RUNS["deskew"]["frames"])])
    n_img = max(FRONT_WARMUP + FRONT_TIMED, VIL_WARMUP + VIL_TIMED)
    images_async = pool.starmap_async(_render, [_kitti_pose(i) for i in range(n_img)])
    lap = _Ahead(pool.imap(_lap_frame, range(LOOP_FRAMES), chunksize=2))
    circuit_async = pool.map_async(_circuit_numpy, ["scan", "image"], chunksize=1)

    # phase 2: build
    t1 = time.perf_counter()
    kc.build(verbose=True)
    print(f"build: {time.perf_counter() - t1:.2f} s into {kc.BUILD_DIR}", flush=True)
    frames = scans.get()
    print(f"data: {len(frames)} simulated HDL-64 scans in {time.perf_counter() - t0:.1f} s "
          f"({n_procs} processes, beside the build)", flush=True)

    # phase 3: kernels against their plain versions
    print(f"kernels: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    records = _kernel_phase(frames, dev)
    launches = {k: {} for k in records}

    def add(path, counts):
        for k, v in counts.items():
            launches[k][path] = v

    # phase 4: the dense path
    print(f"path dense: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    counts, fps, pipe = _lidar_path("dense", frames, WARMUP_FRAMES, dev, card,
                                    need={"K1": 1, "K2": 0}, prewarm=True)
    _pose_errors("dense", pipe.outputs.lidar_p, pipe.outputs.lidar_q, frames, END_ERR_BOUND_M)
    del pipe
    print(f"  dense: {fps:.3f} frames/s over {TIMED_FRAMES} frames after {WARMUP_FRAMES} "
          f"warm-up frames [{card}]", flush=True)
    add("dense", counts)

    # phase 5: the sparse path and the short runs of the other options
    print(f"path sparse: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    n = WARMUP_FRAMES + SPARSE_TIMED_FRAMES
    counts, fps, pipe = _lidar_path(
        "sparse", frames[:n], WARMUP_FRAMES, dev, card,
        overrides=dict(sparse_knn=True, approx_knn=False, edge_map_cap=MAP_CAPS_4X[0],
                       surf_map_cap=MAP_CAPS_4X[1]), need={"K3": 1, "Morton keys": 4, "K2": 0},
        prewarm=True)
    _pose_errors("sparse", pipe.outputs.lidar_p, pipe.outputs.lidar_q, frames[:n],
                 END_ERR_BOUND_M)
    if counts["K1"] or pipe.lidar_state.surf_map.shape[0] != MAP_CAPS_4X[1]:
        raise AssertionError(f"sparse: K1 launched {counts['K1']} times, surf map "
                             f"{tuple(pipe.lidar_state.surf_map.shape)}")
    print(f"  sparse: {fps:.3f} frames/s over {SPARSE_TIMED_FRAMES} frames after "
          f"{WARMUP_FRAMES} warm-up frames, maps {MAP_CAPS_4X} [{card}]", flush=True)
    add("sparse", counts)
    del pipe
    t0 = time.perf_counter()
    distorted = distorted_async.get()
    print(f"data: {len(distorted)} rolling-shutter HDL-64 scans in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    short_need = {"diff": {"K1 diff": 1}, "hash": {}, "deskew": {"K2 diff": 1}}
    for mode, run in SHORT_RUNS.items():
        seq = distorted if mode == "deskew" else frames[:run["frames"]]
        counts, fps, pipe = _lidar_path(mode, seq, 2, dev, card, overrides=run["overrides"],
                                        need=short_need[mode])
        _pose_errors(mode, pipe.outputs.lidar_p, pipe.outputs.lidar_q, seq, run["bound"])
        if mode == "hash" and (counts["K1"] or counts["K3"] or counts["K1 diff"]):
            raise AssertionError(f"hash: the association reached a kNN kernel: {counts}")
        print(f"  {mode}: {fps:.3f} frames/s over {len(seq) - 2} frames after 2 warm-up "
              f"frames [{card}]", flush=True)
        add(mode, counts)
        del pipe

    # phase 6: the vil frame's front end
    print(f"path front end: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    n = FRONT_WARMUP + FRONT_TIMED
    n_vil = VIL_WARMUP + VIL_TIMED
    t0 = time.perf_counter()
    images = images_async.get()
    print(f"data: {len(images)} rendered {IMG_W} x {IMG_H} images in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    add("front end", _front_end_path(frames[:n], images[:n], dev, card))

    # phase 7: the whole vil frame, then the cold start
    print(f"path vil: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    counts, fps_sync, vio_sync = _vil_path(frames[:n_vil], images[:n_vil], dev, card)
    add("vil", counts)
    add("cold start", _cold_start(dev, lap))

    # phase 8: the same frames at sync_depth=2 (the deferred path)
    print(f"path deferred: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    counts, fps_deferred, vio_deferred = _vil_path(frames[:n_vil], images[:n_vil], dev, card,
                                                   sync_depth=2)
    add("deferred", counts)
    print(f"  deferred: frames/s sync_depth=0 {fps_sync:.3f}, sync_depth=2 {fps_deferred:.3f}; "
          f"largest distance between the two trajectories "
          f"{np.abs(vio_deferred - vio_sync).max():.4f} m (not gated: the card's atomic sums "
          f"make runs differ) [{card}]", flush=True)

    # phase 9: tests/test_e2e_loop.py's lap with the visual loop
    print(f"path loop: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    add("loop", _loop_path(dev, card, lap))

    # phase 10: mode "mask"
    print(f"path mask: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    _mask_path(dev, card)

    # phase 11: dataset replay (the raycaster, run_dataset, run_synthetic)
    print(f"path replay: [{time.perf_counter() - t_start:.1f} s after the device check]",
          flush=True)
    t0 = time.perf_counter()
    _raycast_phase(dev, card, circuit_async)
    add("replay", _replay_path(frames, images, dev, card))
    add("synthetic", _synthetic_path(dev, card))
    print(f"  replay phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    on_path = {"K1": ("dense", "front end", "vil", "deferred", "replay", "synthetic"),
               "K2": ("dense", "sparse", "front end", "vil", "cold start", "deferred", "loop",
                      "synthetic"),
               "K2 densify": ("loop",),
               "K3": ("sparse",), "K1 diff": ("diff",), "K2 diff": ("deskew",),
               "Morton keys": ("sparse",)}
    for kname, rec in records.items():
        rec["launches_by_path"] = launches[kname]
        rec["launches"] = sum(launches[kname].values())
        idle = [p for p in on_path[kname] if launches[kname].get(p, 0) < 1]
        if idle:
            raise AssertionError(f"{kname} was not launched on path(s) {idle}: {launches[kname]}")

    print(f"total: {time.perf_counter() - t_start:.1f} s after the device check", flush=True)
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
