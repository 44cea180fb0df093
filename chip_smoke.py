#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vil_fusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, any failure exits non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles csrc/knn.cu and csrc/eigh.cu with nvcc for sm_90a into
     build/kernels/, the two nvcc processes side by side;
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
     capacities) and hash kNN against K1; the symmetric eigensolver
     (csrc/eigh.cu, the marginalization's eigh: the warp Jacobi at 15, the
     block Householder + QL at 157) against torch.linalg.eigh and float64
     on matrices like the estimator's own (full rank, rank-deficient like a
     prior, repeated eigenvalues, column scales over 11 decades), timed in
     turns with torch.linalg.eigh, and the prior's J^T J and J^T r0 it gives;
  4. path "dense": VILFusionPipeline(mode="lidar") at KITTI HDL-64 scale
     (64 x 1800 = 115,200-point scans, 16,384 / 32,768-point maps, default
     global fusion), 5 warm-up + 40 timed scans at 10 Hz, then
     fusion.prewarm() (one ICP loop verification) and finalize(); every
     frame from the fourth on one replay of the odometry's CUDA graph
     (odometry_step, the reference's jit), equal to its eager body bit for
     bit with the same K1 / K2 launches, and one more replay under
     torch.cuda.set_sync_debug_mode("error");
  5. path "sparse": the same pipeline with sparse_knn=True,
     approx_knn=False and 65,536 / 131,072-point maps, 5 + 20 scans: K3
     launched every timed frame; then three short runs of the remaining
     odometry options: the difference-form dense kNN (knn_form="diff"),
     use_hash_knn=True, and deskew=True (with the exact difference-form
     kNN) on rolling-shutter scans; each run's steady frames replay their
     odometry graph, gated as in phase 4;
  6. path "front end": vil_front_end (tracker, lidar odometry, extrinsic
     glue, depth association) on 1226 x 370 rendered images + HDL-64 scans,
     3 warm-up + 12 timed frames: features tracked, K2 launched at k=3
     every frame, lidar depth against the simulator's own raycast; the
     stage graphs replayed (the tracker's from frame 1, the odometry's from
     frame 3, glue + depth association on every frame), each replay equal
     to its eager body bit for bit with the same kernel launches;
  7. path "vil": VILFusionPipeline(mode="vil", sync_depth=0), the whole vil
     frame (tracker, lidar odometry, extrinsic glue, depth association,
     estimator: IMU preintegration, feature ingest, triangulation, bundle
     adjustment, marginalization, slide) on the same rig with 200 Hz IMU,
     oracle initial state, 14 warm-up + 20 timed frames: no restart, the
     fused estimator step on every steady frame, each one a replay of its
     CUDA graph (the replay count equals the steady frames), every frame's
     stage graphs replayed as in phase 6 and equal to their eager bodies, K1 / K2
     launched as the odometry and the depth association plan them each
     frame, the eigensolver four times a steady frame (twice on each of its
     kernels), the end error within
     its bound; every steady step's graph result bit for bit the eager
     body's on the same inputs (both keyframe decisions among them), one
     replay under torch.cuda.set_sync_debug_mode("error"), the step's host
     launches counted by torch.profiler, the marginalization's own matrices
     through the kernels and torch.linalg.eigh (and timed in turns); with
     --save-window PATH the final window is saved there; then a cold start on
     tests/test_e2e_loop.py's
     rig (240 x 320, 32 x 600 scans, LoopTrajectory, no visual loop) that
     must initialize within its frame cap and never restart;
  8. path "deferred": phase 7's frames at sync_depth=2 (the bench's
     deployment configuration, with scan_quant=0.0025): every steady frame
     issued and completed two frames later, each steady frame exactly one
     replay, of the frame's graph (vil_frame: dequantization, tracker,
     odometry, glue, depth association, readout shift and the estimator's
     step in one CUDA graph, the reference's _vil_frame_program), equal to
     its eager body bit for bit (poses, tracker, maps, estimator state) with
     the same K1 / K2 / eigh launches, no sync under
     torch.cuda.set_sync_debug_mode("error") from a frame's uploads to its
     async copies, the replay and the eager body timed; no restart, K1 / K2
     a frame and the end error as in phase 7;
     frames/s at sync_depth 0 and 2, the host's wait per completed frame
     and the distance between the two trajectories are printed;
  9. path "loop": tests/test_e2e_loop.py's lap, 390 frames of the cold-start
     rig with the visual loop on its worker thread and sync_depth=2: that
     test's asserts (initialized, no restart, >= 380 outputs, a ScanContext
     and a visual loop, the ATE of the global fusion below the VIO's and
     0.5 m, the rebuilt loop path no worse than 1.05 x the VIO, the VIO error
     down after the relocalization), no worker error, K2 launched at
     the densification shape (384 extra corners x the 19,200-point scan),
     and every steady frame's estimator step a graph replay (the frame's
     graph, or the step's own); the worker's graphs (keyframe program, PnP
     RANSAC, 4-DoF solve) replayed, each replay bit for bit its eager body,
     a loop closure's 4-DoF solve one replay once its graph exists, the
     worker's jobs by kind with host ms, their launches under torch.profiler
     over frames 120-144 (a steady keyframe job: fewer than 150) and of the
     last two loop-closing jobs run again after the lap, and the
     lap's frames classed by what they ran (filling, initialization
     attempt, initialization, a first body, a capture, replays) with their
     host seconds;
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
     fusion keyframes' ATE and the lidar end error within 0.25 m (global
     fusion's and the visual-loop worker's graph replays printed);
  12. path "parallel": (a) K1 (surf, edge) and K2 (ICP) over a sequence
     axis in one launch on 8 different simulator maps, bit for bit against
     8 unbatched launches and with a database shared by every sequence,
     against the plain batched version, and at the 180 ragged shapes x 3
     sequences, CUDA-event ms beside 8 unbatched calls; (b)
     odometry_step_batched (torch.func.vmap of the step, one K1 launch a
     call for the batch) over 8 sequences of phase 4's scans, 5 + 10 steps,
     a steady step one replay of its graph, bit for bit its eager body,
     poses within 1e-4 m of each sequence stepped alone, the K1 launches of a
     batched step those of one sequence, aggregate frames/s beside one
     sequence's replayed step; then 3 batched
     steps of the exact kNN (K2); (c) knn_sharded, detect_loop_sharded and
     optimize_sharded at world size 1 over NCCL against knn_exact,
     detect_loop (2,048 slots) and ba.optimize on phase 7's window after
     its 34 frames;
     (d) the same three on 4 spawned ranks over gloo with CUDA tensors on
     the one card against (c); (e) preintegrate(parallel=True) against the
     sequential loop with host ms and device kernels of each.
The numpy simulator's frames are made in a pool of processes (the scans
while the kernels build, the lap's frames ahead of phases 7 and 9, phase
11's numpy references after them).
Every path checks that its state tensors are on the card, that its kernels
launched (counts set to 0 just before, read just after; a graph's kernels
are counted at each replay), that all poses are
finite and that the end position is within its bound of the simulator's
ground truth. The graphs captured in the run are summed up at the end
(nodes, seconds, pool memory). The line before the last is the kernels'
JSON record; the
last line is {"ok": true, "device": {...}}. Imports nothing of jax.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import threading
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
# global fusion's graphs (the reference's jitted keyframe program, submap ICP
# and pose-graph relaxation): phases 7-8 hold every replay against its body
FUSION_GRAPHS = ("keyframe_program", "submap_icp", "posegraph_optimize")
# the visual-loop worker's graphs (phase 9, 11c)
VL_GRAPHS = ("vl_keyframe", "vl_match", "pnp_ransac", "posegraph4dof_optimize")
# phase 12's sharded BA takes phase 7's window after this many frames (all
# of them). On such a weak window another reduction order can flip an LM
# accept / reject: one earlier eigensolver's window put the 4 gloo ranks
# 1.29e-3 from the one-rank LM (rtol 1e-3); on the window this eigensolver
# gives they land 3.1e-4 from it on the CPU, and the JAX package's sharded
# LM equals its one-device LM there (tools/jax_sharded_window.py, PERF.md
# section 6)
SHARDED_WINDOW_FRAMES = 34
IMU_RATE = 200.0
# end-position bound of the vil path: VIL_REF_END_ERR_M is the JAX
# package's own end error over the same 34 frames on the CPU
# (tools/jax_cpu_reference.py --mode vil --frames 34, 32 x 900 scans and
# 4,096 / 8,192-point maps: 0.0402 m before the first bundle adjustment at
# frame 10, 0.4441 m after it, then growing; 1.4363 m after 19 frames); the
# bound is about twice it, as for the other paths (PERF.md)
VIL_REF_END_ERR_M = 1.9139
VIL_END_ERR_BOUND_M = 4.0
# the symmetric eigensolver (csrc/eigh.cu) against torch.linalg.eigh and
# float64: both are backward-stable float32 solvers, each within ~5 n ulps
# of max|S| of the exact eigenvalues (cuSOLVER's syevd lands 4.3e-5 to
# 5.7e-5 from float64 at n = 157-172 on an H100, PERF.md), so the two
# within 1e-4 of max|S| of each other, the kernel (float64 arithmetic on
# float32 storage) within 2e-5 of float64;
# its V diag(S) V^T within 2e-5 of max|A| and V^T V within 2e-5 of I
# (a few hundred rotations a column, each an ulp of random error); the prior it
# gives to test_torch_marginalization.py's tolerances (J^T J within 1e-4 of
# the largest entry of the quadratic, J^T r0 within 1e-3)
EIGH_SIZES = (15, 157)
EIGH_TOL_PLAIN, EIGH_TOL_F64, EIGH_TOL_RECON, EIGH_TOL_ORTH = 1e-4, 2e-5, 2e-5, 2e-5
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
# phase 9 traces the worker's jobs of these lap frames with torch.profiler,
# for the launches a job: steady keyframe jobs (the graphs captured, fewer
# than 50 keyframes in the DB: no BoW query; past them this lap's repetitive
# scene sends every keyframe on to verification); then the lap's last two
# loop-closing jobs again; a steady keyframe job's gate
LOOP_PROFILE_FRAMES = (120, 145)
VL_JOB_LAUNCHES_MAX = 150
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


def _time_ms(fn, reps: int = 20, warmup: int = 3, samples: list | None = None) -> float:
    """Median CUDA-event time of fn() in milliseconds (each call's time
    also appended to `samples`, when given)."""
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
    if samples is not None:
        samples.extend(times)
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


def _eigh_cases(n: int, seed: int):
    """Symmetric float32 test matrices of size n like the marginalization's:
    full rank, rank-deficient (a prior's quadratic: rank n/2), repeated
    eigenvalues, and column scales over 11 decades (the FOCAL^2-scaled
    vision blocks beside the bias blocks)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n + 20, n))
    B = rng.normal(size=(n // 2, n))
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    d = np.repeat(rng.uniform(1.0, 10.0, (n + 2) // 3), 3)[:n]
    C = rng.normal(size=(n, n)) * np.exp(rng.uniform(-8.0, 18.0, n))
    return {"full rank": A.T @ A, "rank n/2": B.T @ B, "repeated": (Q * d) @ Q.T,
            "wide range": C.T @ C / n}


def _eigh_check(label, A, S, V, S_plain):
    """Hold one eigendecomposition (S, V) of A (CUDA tensors) against the
    plain version's eigenvalues and float64 (module constants EIGH_TOL_*).
    Returns the largest eigenvalue error against the plain version."""
    import numpy as np
    import torch

    n = A.shape[-1]
    S64 = np.linalg.eigvalsh(A.double().cpu().numpy())
    s_max = np.abs(S64).max()
    e_plain = (S - S_plain).abs().max().item()
    e_64 = np.abs(S.double().cpu().numpy() - S64).max() / s_max
    e_plain_64 = np.abs(S_plain.double().cpu().numpy() - S64).max() / s_max
    recon = ((V * S[None, :]) @ V.T - A).abs().max().item() / A.abs().max().item()
    orth = (V.T @ V - torch.eye(n, device=A.device)).abs().max().item()
    print(f"  eigh {label}: eigenvalues against torch.linalg.eigh {e_plain / s_max:.3e}, against "
          f"float64 {e_64:.3e} (torch.linalg.eigh {e_plain_64:.3e}) of max|S|; V diag(S) V^T "
          f"{recon:.3e} of max|A|; V^T V - I {orth:.3e}", flush=True)
    if not (e_plain <= EIGH_TOL_PLAIN * s_max and e_64 <= EIGH_TOL_F64
            and recon <= EIGH_TOL_RECON and orth <= EIGH_TOL_ORTH and torch.isfinite(V).all()):
        raise AssertionError(f"eigh {label}: outside the tolerances")
    if not bool((S[1:] >= S[:-1]).all()):
        raise AssertionError(f"eigh {label}: eigenvalues not ascending")
    return e_plain


def _eigh_turns(A, reps: int = 20):
    """CUDA-event times (ms) of csrc/eigh.cu and torch.linalg.eigh on A in
    turns: kernel, library, library, kernel, `reps` calls a turn. Returns
    ({who: median of its 2 x reps calls}, {who: [each turn's median]})."""
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda as ec

    samples = {"kernel": [], "library": []}
    turns = {"kernel": [], "library": []}
    for who in ("kernel", "library", "library", "kernel"):
        fn = ec.eigh if who == "kernel" else ec.eigh_plain
        turns[who].append(_time_ms(lambda: fn(A), reps=reps, samples=samples[who]))
    return {k: sorted(v)[len(v) // 2] for k, v in samples.items()}, turns


def _eigh_bound(n: int):
    """(bound_ms, bound_by) of one n x n eigendecomposition: the larger of
    9 n^3 float32 operations at the FP32 peak and 2 n^2 x 4 B at the HBM
    peak."""
    t_ops = 9 * n ** 3 / PEAK_FP32_FLOPS * 1e3
    t_bytes = 2 * n * n * 4 / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _eigh_phase(dev):
    """Phase 3, the eigensolver: csrc/eigh.cu's two kernels (the warp
    Jacobi at 15, the block Householder + QL at 157) against
    torch.linalg.eigh (their plain version, and the one PyTorch call of the
    same function) and float64 at the estimator's sizes on `_eigh_cases`,
    the work each matrix took, the batched launch, and
    marginalization._quadratic_to_factor on the card against
    test_torch_marginalization.py's invariants; CUDA-event times of kernel
    and torch.linalg.eigh in turns beside the bound max(9 n^3 float32
    operations, 2 n^2 x 4 B). Returns the kernels line's records, "eigh"
    (157) and "eigh warp" (15)."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import marginalization as marg
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda as ec

    shapes, err, work = {}, {}, {}
    for n in EIGH_SIZES:
        err[n] = 0.0
        for name, M in _eigh_cases(n, n).items():
            A = torch.tensor(M, dtype=torch.float32, device=dev)
            st = torch.zeros(1, ec.NSTATS, dtype=torch.int32, device=dev)
            S, V = ec.eigh(A, stats=st)
            S_plain, _ = ec.eigh_plain(A)
            torch.cuda.synchronize()
            err[n] = max(err[n], _eigh_check(f"{n} x {n} {name}", A, S, V, S_plain))
            work[f"{n} {name}"] = st[0].tolist()
        # a batch of the four in one launch: each matrix as alone, bit for bit
        batch = torch.stack([torch.tensor(M, dtype=torch.float32, device=dev)
                             for M in _eigh_cases(n, n).values()])
        Sb, Vb = ec.eigh(batch)
        for b in range(batch.shape[0]):
            S1, V1 = ec.eigh(batch[b])
            if not (torch.equal(Sb[b], S1) and torch.equal(Vb[b], V1)):
                raise AssertionError(f"eigh {n}: batched launch differs from a single one")
        A = torch.tensor(_eigh_cases(n, n)["rank n/2"], dtype=torch.float32, device=dev)
        med, turns = _eigh_turns(A)
        bound = _eigh_bound(n)
        shapes[str(n)] = dict(shape=f"{n}x{n}", ms=med["kernel"], plain_ms=med["library"],
                              bound_ms=bound[0], bound_by=bound[1], library_ms=med["library"],
                              turns=turns)
        print(f"  eigh {n} x {n} rank n/2: kernel {med['kernel']:.4f} ms, torch.linalg.eigh "
              f"{med['library']:.4f} ms (each turn's median: {turns}), bound "
              f"{bound[0]:.7f} ms by {bound[1]} (CUDA-event medians)", flush=True)
    print(f"  eigh work a matrix (eigh_cuda.eigh stats: at 157 QL iterations, rotations, SM "
          f"clocks until the tridiagonal / Q / the last rotation / the end, the producer's "
          f"clocks waiting and in its chains; at 15 Jacobi sweeps, rotations, the end's "
          f"clocks): {work}", flush=True)
    # the prior's factorization through the kernel (test_torch_marginalization.py's
    # test_quadratic_to_factor_invariants: rank 30 of 40; and a prior-sized one)
    rng = np.random.default_rng(0)
    for m, r in ((40, 30), (157, 100)):
        X = rng.normal(size=(r, m)).astype(np.float32)
        Lam = X.T @ X
        g = Lam @ rng.normal(size=m).astype(np.float32)
        J, r0 = marg._quadratic_to_factor(torch.from_numpy(Lam).to(dev),
                                          torch.from_numpy(g).to(dev))
        J, r0 = J.double().cpu().numpy(), r0.double().cpu().numpy()
        e_jj = np.abs(J.T @ J - Lam).max() / np.abs(Lam).max()
        e_jr = np.abs(J.T @ r0 - g).max() / np.abs(g).max()
        print(f"  eigh prior {m} x {m} rank {r}: J^T J {e_jj:.3e} of max|Lam|, J^T r0 "
              f"{e_jr:.3e} of max|g|", flush=True)
        if not (e_jj <= 1e-4 and e_jr <= 1e-3):
            raise AssertionError(f"eigh prior {m}: J^T J / J^T r0 outside 1e-4 / 1e-3")
    replaces = ("vil_fusion_tpu/models/marginalization.py:{} (XLA eigh in {}; not a Pallas "
                "kernel)")
    records = {}
    for key, n, kernel, where in (
            ("eigh", EIGH_SIZES[-1], "hhql_eigh_kernel (Householder + QL, one block a matrix)",
             (35, "_quadratic_to_factor")),
            ("eigh warp", EIGH_SIZES[0], "jacobi_warp_kernel (Jacobi, one warp a matrix)",
             (48, "_schur_eliminate"))):
        sh = shapes[str(n)]
        records[key] = dict(
            name=f"{key} sym_eigh: {kernel}", route="cuda",
            source="vil_fusion_tpu_torch/csrc/eigh.cu", replaces=replaces.format(*where),
            max_abs_err=err[n], shape=sh["shape"], ms=sh["ms"], plain_ms=sh["plain_ms"],
            bound_ms=sh["bound_ms"], bound_by=sh["bound_by"], library_ms=sh["library_ms"],
            launches_per_call=1, turns=sh["turns"],
            work={k: v for k, v in work.items() if k.startswith(f"{n} ")})
    return records


def _cond_phase(dev, card):
    """The conditional node (csrc/cond.cu through graphs.cond) against its
    plain version, the select (both branches, torch.where), on the main
    path's predicate (a 0-d bool) with a one-kernel branch each over an
    operand of the marginal prior's size (172 x 172): a captured step
    replays, with the predicate true and false in turns, bit for bit what
    the select gives, and runs the taken branch only (a device counter a
    branch). Times: the graph's replay (the two set kernels, the two
    conditional nodes, the taken body) and the select, CUDA-event medians.
    Returns the kernel line's record."""
    import torch

    from vil_fusion_tpu_torch.ops.cuda import cond_cuda
    from vil_fusion_tpu_torch.utils import graphs

    hits = torch.zeros(2, dtype=torch.int64, device=dev)

    def t(x):
        hits[0] += 1
        return x + 1.0

    def f(x):
        hits[1] += 1
        return x * 2.0

    def body(pred, x):
        return graphs.cond(pred, t, f, (x,))

    x = torch.randn(172, 172, device=dev)
    preds = [torch.tensor(v, device=dev) for v in (True, False)]
    graphs.step("cond_check", body, (preds[0], x))  # a key's first call runs the body
    graphs.step("cond_check", body, (preds[0], x))  # the second captures
    cs = next(v for k, v in graphs._steps.items() if k[0] == "cond_check")
    err, runs = 0.0, []
    for n in range(6):
        pred = preds[n % 2]
        torch.cuda.synchronize()
        h0 = hits.clone()
        out = graphs.step("cond_check", body, (pred, x + n))
        torch.cuda.synchronize()
        runs.append((hits - h0).tolist())
        ref = body(pred, x + n)  # outside a capture: the select
        err = max(err, (out - ref).abs().max().item())
        if not torch.equal(out, ref):
            raise AssertionError(f"cond: replay {n} differs from the select by {err}")
    if runs != [[1, 0], [0, 1]] * 3:
        raise AssertionError(f"cond: the replays ran the branches {runs}, want the taken one")
    ms = {v: _time_ms(lambda: (cs.static[0].fill_(v), cs.graph.replay())) for v in (True, False)}
    plain_ms = _time_ms(lambda: body(preds[0], x))
    moved = 2 * x.numel() * 4 + 1  # the operand read, the result written, the predicate
    bound = moved / PEAK_BYTES_PER_S * 1e3
    print(f"  cond: conditional node == select bit for bit on 6 replays (true / false in "
          f"turns), each running the taken branch only; replay {ms[True]:.4f} / "
          f"{ms[False]:.4f} ms (true / false), select {plain_ms:.4f} ms, bound {bound:.6f} ms "
          f"(bytes); {cs.stats['nodes']} [{card}]", flush=True)
    return {"cond": dict(
        name="cond graphs.cond: vil_set_conditional_kernel + IF nodes", route="cuda",
        source="vil_fusion_tpu_torch/csrc/cond.cu",
        replaces="vil_fusion_tpu/models/estimator.py:380 (lax.cond; not a Pallas kernel)",
        max_abs_err=err, shape="0-d bool predicate, 172 x 172 operand", ms=ms[True],
        plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None,
        launches_per_call=2, ms_false=ms[False], nodes=cs.stats["nodes"],
        set_kernel_launches_in_check=cond_cuda.begin.launches)}


def _counts(kc):
    """Launch counts of the nine kernels since the last _reset (K1 and K2:
    unbatched launches of the expanded form; no path launches a batched
    call in the difference form). A launch inside a conditional body of a
    graph counts once its replay is settled (graphs.settle: the pipeline
    settles where it reads a frame's results, a run's end settles all)."""
    from vil_fusion_tpu_torch.ops.cuda import cond_cuda, eigh_cuda

    return {"K1": kc.knn_grouped.launches - kc.knn_grouped.launches_diff
            - kc.knn_grouped.launches_batched,
            "K2": kc.knn_exact.launches - kc.knn_exact.launches_diff
            - kc.knn_exact.launches_batched,
            "K3": kc.knn_sparse.launches,
            "K1 diff": kc.knn_grouped.launches_diff, "K2 diff": kc.knn_exact.launches_diff,
            "Morton keys": kc.morton_keys.launches,
            "eigh": eigh_cuda.eigh.launches - eigh_cuda.eigh.launches_warp,
            "eigh warp": eigh_cuda.eigh.launches_warp,
            "cond": cond_cuda.begin.launches}


def _reset(kc):
    """Every kernel's launch count and the graphs' replay counts to 0 (and
    the conditional launches not settled yet dropped)."""
    from vil_fusion_tpu_torch.ops.cuda import cond_cuda, eigh_cuda
    from vil_fusion_tpu_torch.utils import graphs

    kc.reset_counts()
    eigh_cuda.reset_counts()
    cond_cuda.reset_counts()
    graphs.reset_counts()


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
    Every frame from the fourth on must replay the odometry's graph, equal
    to the eager body bit for bit (`_GraphRecorder`), and one more replay
    must not wait for the device (set_sync_debug_mode("error")).
    Returns (launch counts of the run, timed frames per second, pipeline)."""
    import torch

    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.utils import graphs

    pipe = VILFusionPipeline(_rig(), mode="lidar", odom_overrides=overrides,
                             scan_quant=SCAN_QUANT, device=dev)
    _reset(kc)
    n_captures = len(graphs.captures)
    with _GraphRecorder(kc, ("odometry_step",)) as rec:
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
    replays = graphs.replays.get("odometry_step", 0)
    first = graphs.eager_calls.get("odometry_step", 0)
    if prewarm:
        pipe.fusion.prewarm()
    pipe.finalize()
    torch.cuda.synchronize()
    counts = _counts(kc)
    _capture_report(name, graphs.captures[n_captures:])
    # every steady frame one call of the step: a replay, or the first call of
    # a key not seen before (its body)
    if replays + first != len(frames) - 3 or first > 1 or len(rec.calls) != replays:
        raise AssertionError(f"{name}: the odometry's graph replayed {replays} times "
                             f"({len(rec.calls)} recorded), its body ran {first} times, for "
                             f"{len(frames) - 3} steady frames")
    rec.check(name)
    name_, fn, args, _, _, static, _ = rec.calls[-1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        graphs.step(name_, fn, args, static=static)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"  {name}: the odometry's graph replayed on {replays} of {len(frames) - 3} steady "
          f"frames (the first call of a new key runs the body: {first}); a replay under "
          f"torch.cuda.set_sync_debug_mode('error'): no sync", flush=True)

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
    from vil_fusion_tpu_torch.utils import graphs

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
    n_captures = len(graphs.captures)
    with _GraphRecorder(kc, ("track_step", "odometry_step", "glue_depth")) as rec:
        for i, (fr, img, (p16, v8)) in enumerate(zip(frames, images, host)):
            if i == FRONT_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            k2, n_cap = kc.knn_exact.launches, len(graphs.captures)
            ts, ls, out = pl.vil_front_end(
                ts, ls, torch.from_numpy(img).to(dev), torch.from_numpy(p16).to(dev),
                torch.from_numpy(v8).to(dev), fr[0], fe, frame_index=i, generator=gen)
            # one K2 launch a frame; a frame that captures a graph also counts
            # its warm-up calls' launches
            got = kc.knn_exact.launches - k2
            if (not (got == 1 or (got > 1 and len(graphs.captures) > n_cap))
                    or kc.knn_exact.last_call != (fe.tcfg.cap, len(fr[2]), 3)):
                raise AssertionError(f"front end frame {i}: K2 launches "
                                     f"{kc.knn_exact.launches - k2}, last call "
                                     f"{kc.knn_exact.last_call}")
            outs.append(out)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = _counts(kc)
    n = len(frames)
    if counts["K2"] < n or counts["K1"] < n - 1:
        raise AssertionError(f"front end: launches {counts} over {n} frames")
    # the stage graphs: the tracker's from frame 1, the odometry's from frame
    # 3, the glue with the depth association every frame
    names = ("track_step", "odometry_step", "glue_depth")
    calls = _step_calls(names)
    _capture_report("front end", graphs.captures[n_captures:])
    if (calls != {"track_step": n - 1, "odometry_step": n - 3, "glue_depth": n}
            or any(graphs.eager_calls.get(k, 0) > 1 for k in names)):
        raise AssertionError(f"front end: graph calls {calls} (first calls of a key "
                             f"{graphs.eager_calls}) over {n} frames")
    rec.check("front end")
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


def _vil_path(frames, images, dev, card, sync_depth=0, save_window=None):
    """Phase 7 (sync_depth=0) and phase 8 (sync_depth=2, the bench's
    deployment configuration): VILFusionPipeline(mode="vil") over `frames` +
    `images` with 200 Hz IMU from the oracle initial state. With
    sync_depth > 0 every steady frame must be issued (_issue_frame) and
    completed (_complete_frame) sync_depth frames later. Every steady frame
    must replay the estimator's graph; at sync_depth 0 every steady step is
    recorded and checked after the run (`_graph_checks`). With
    `save_window`, the final window is saved there (state_io.to_numpy,
    torch.save). Returns (launch counts of the run, timed frames/s, the
    per-frame positions, the estimator state after SHARDED_WINDOW_FRAMES
    frames, the eigensolver's times on the final window's matrices or
    None)."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import estimator as est_mod
    from vil_fusion_tpu_torch.models import window
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.utils import graphs
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
        if not any(c["name"] == "vil_frame" for c in graphs.captures[n_captures:]):
            return issue(t, *a)
        # a steady frame issued after the frame graph's capture: from its
        # uploads to its outputs' async copies nothing waits for the device
        torch.cuda.set_sync_debug_mode("error")
        try:
            return issue(t, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def complete_rec(rec):
        completed.append(rec["t"])
        return complete(rec)

    pipe._issue_frame, pipe._complete_frame = issue_rec, complete_rec
    steps = []  # the steady steps' (arguments, keywords, outputs), at sync_depth 0
    step = est_mod.fused_full_step

    def step_rec(*a, **kw):
        out = step(*a, **kw)
        if not sync_depth:
            steps.append((a, kw, out, graphs.last_settlement()
                          if graphs.replays.get("fused_full_step", 0) > replays_seen[0] else None))
            replays_seen[0] = graphs.replays.get("fused_full_step", 0)
        return out

    replays_seen = [0]
    fusion_calls = collections.Counter()  # global fusion's calls under sync_debug_mode error
    fusion_strict = [False, False]  # the timed deferred frames; inside a strict call

    def strict(name, fn):
        """fn run under torch.cuda.set_sync_debug_mode("error") during the
        timed deferred frames, and counted there (a call inside another
        keeps the outer one's mode)."""
        def call(*a, **kw):
            if not fusion_strict[0]:
                return fn(*a, **kw)
            fusion_calls[name] += 1
            outer = fusion_strict[1]
            fusion_strict[1] = True
            if not outer:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                if not outer:
                    torch.cuda.set_sync_debug_mode("default")
                fusion_strict[1] = outer
        return call

    if sync_depth:
        from vil_fusion_tpu_torch.models import posegraph as pg_mod

        fusion = pipe.fusion
        fusion.add_frame = strict("add_frame", fusion.add_frame)
        fusion._dispatch_icp = strict("_dispatch_icp", fusion._dispatch_icp)
        patched = [(pg_mod, "add_loop"), (pg_mod, "optimize_bucketed")]
        saved = [getattr(m, k) for m, k in patched]
        for m, k in patched:
            setattr(m, k, strict(k, getattr(m, k)))

    est_mod.fused_full_step = step_rec
    _reset(kc)
    n_captures = len(graphs.captures)
    n_fill = window.K - 1  # frames before the first steady one
    # a steady frame calls the stage graphs and the estimator's (sync_depth
    # 0), or the frame's graph alone (deferred): replays, but for the first
    # call of a key, which runs the body (the frame's body calls the
    # estimator's step then)
    names = ("fused_full_step", "vil_frame", "track_step", "odometry_step", "glue_depth")
    steady_calls = ({"vil_frame": 1} if sync_depth else
                    {"track_step": 1, "odometry_step": 1, "glue_depth": 1,
                     "fused_full_step": 1})
    stages = ("track_step", "odometry_step", "glue_depth") + (("vil_frame",) if sync_depth
                                                              else ()) + FUSION_GRAPHS
    one_replay = 0  # steady frames that were one replay and nothing else
    keys, per_frame, eigh_frame = [], [], []
    t0 = window_state = None
    try:
        with _GraphRecorder(kc, stages) as rec:
            for i, (fr, img, imu) in enumerate(zip(frames, images, imus)):
                if i == VIL_WARMUP:
                    torch.cuda.synchronize()
                    GLOBAL_TIMERS.reset()
                    fusion_strict[0] = bool(sync_depth)
                    t0 = time.perf_counter()
                n_eigh = _counts(kc)["eigh"] + _counts(kc)["eigh warp"]
                before, eager0 = _step_calls(names), dict(graphs.eager_calls)
                replays0 = dict(graphs.replays)
                _vil_frame(pipe, i, fr, img, imu, name, kc, per_frame, keys)
                if i == SHARDED_WINDOW_FRAMES - 1:
                    e = pipe.estimator  # its tensors are never written in place
                    window_state = (e.window, e.feats, e.pre, e.lidar, e.prior)
                eigh_frame.append(_counts(kc)["eigh"] + _counts(kc)["eigh warp"] - n_eigh)
                delta = {k: v - before[k] for k, v in _step_calls(names).items() if v != before[k]}
                want = dict(steady_calls)
                if sync_depth and graphs.eager_calls.get("vil_frame", 0) > eager0.get("vil_frame", 0):
                    want["fused_full_step"] = 1  # the frame's body ran, with the step inside
                if i >= n_fill and delta != want:
                    raise AssertionError(f"{name} frame {i}: graph calls {delta}, want {want}")
                replayed = {k: v - replays0.get(k, 0) for k, v in graphs.replays.items()
                            if v != replays0.get(k, 0) and k in names}
                one_replay += i >= n_fill and replayed == steady_calls
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        est_mod.fused_full_step = step
        fusion_strict[0] = False
        if sync_depth:
            for (m, k), f in zip(patched, saved):
                setattr(m, k, f)
    pipe.finalize()
    torch.cuda.synchronize()
    graphs.settle(wait=True)  # the last replays' conditional launches
    counts = _counts(kc)
    calls, eager = _step_calls(names), dict(graphs.eager_calls)
    new = graphs.captures[n_captures:]
    est = pipe.estimator
    window_state = window_state or (est.window, est.feats, est.pre, est.lidar, est.prior)
    n, n_steady = len(frames), len(frames) - n_fill
    # the stage graphs run on every frame the sync path takes (all at sync_depth
    # 0, the filling frames when deferred): the tracker's from frame 1, the
    # odometry's from frame 3, the glue with the depth association on all
    n_sync = n_fill if sync_depth else n
    n_body = eager.get("vil_frame", 0)  # the frame's body: the estimator's step inside
    want = {"fused_full_step": n_body if sync_depth else n_steady,
            "vil_frame": n_steady if sync_depth else 0,
            "track_step": n_sync - 1, "odometry_step": n_sync - 3, "glue_depth": n_sync}
    # the eigensolver: a marginalization path launches a 157 x 157 on the block
    # kernel and a 15 x 15 on the warp kernel; a replay (of the step's graph or
    # the frame's) runs the taken path only, an eager call of the step (a key's
    # first, or a capture's warm-up) both paths
    replayed = graphs.replays.get("fused_full_step", 0) + graphs.replays.get("vil_frame", 0)
    want_eigh = replayed + 2 * (graphs.eager_calls.get("fused_full_step", 0) + sum(
        c["warmup_calls"] for c in new if c["name"] in ("fused_full_step", "vil_frame")))
    print(f"  {name}: graph calls {calls} (of them a key's first call, its body: {eager}) "
          f"for {n_steady} steady frames of {n}; steady frames that were exactly "
          f"{steady_calls} replayed: {one_replay}; eigh launches {counts['eigh']} (block) + "
          f"{counts['eigh warp']} (warp) (want {want_eigh} each: 1 a replay, the taken path; "
          f"2 an eager call), per frame as settled {eigh_frame}; conditional set kernels "
          f"{counts['cond']}", flush=True)
    print(f"  {name}: global fusion's graphs: replays "
          f"{ {k: graphs.replays.get(k, 0) for k in FUSION_GRAPHS} }, first calls of a key "
          f"{ {k: graphs.eager_calls.get(k, 0) for k in FUSION_GRAPHS} }", flush=True)
    _capture_report(name, new)
    if (calls != want or est.fused_steps != n_steady or counts["eigh"] != want_eigh
            or counts["eigh warp"] != want_eigh or any(v > 1 for v in eager.values())
            or one_replay < n_steady - 2 or counts["cond"] != 2 * replayed):
        raise AssertionError(f"{name}: graph calls {calls} (want {want}), first calls {eager}, "
                             f"{one_replay} steady frames only replays, {est.fused_steps} fused "
                             f"steps, {counts['eigh']} + {counts['eigh warp']} eigh launches for "
                             f"{n_steady} steady frames")
    rec.check(name)
    if sync_depth:
        stages_t = GLOBAL_TIMERS.summary()
        print(f"  {name}: global fusion's calls of the {VIL_TIMED} timed frames under "
              f"torch.cuda.set_sync_debug_mode('error'), no sync: {dict(fusion_calls)}; host ms "
              f"(GLOBAL_TIMERS mean / p50 / max): " + ", ".join(
                  f"{k} {stages_t[k]['mean_ms']:.2f} / {stages_t[k]['p50_ms']:.2f} / "
                  f"{stages_t[k]['max_ms']:.2f}" for k in ("frame_wait", "global_fusion")
                  if k in stages_t) + f" [{card}]",
              flush=True)
        if fusion_calls["add_frame"] < VIL_TIMED - sync_depth:
            raise AssertionError(f"{name}: global fusion ran {dict(fusion_calls)} in the "
                                 f"timed frames")
        rec.times(name, "vil_frame", card)
        print(f"  {name}: {one_replay} of {n_steady} steady frames one replay of the frame's "
              f"graph (the first runs the body, the second captures); from their uploads to "
              f"their async copies no sync under torch.cuda.set_sync_debug_mode('error') "
              f"(every frame after the capture)", flush=True)
    eigh_times = _graph_checks(name, steps, est, card) if steps else None
    if save_window:
        from vil_fusion_tpu_torch.utils import state_io

        Path(save_window).parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: state_io.to_numpy(getattr(est, k))
                    for k in ("window", "feats", "pre", "lidar", "prior")}, save_window)
        print(f"  {name}: the window after {len(frames)} frames saved to {save_window}",
              flush=True)
    return _vil_report(name, pipe, frames, issued, completed, keys, per_frame, counts, dt,
                       sync_depth, card, dev) + (window_state, eigh_times)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    return [x]


def _clone_leaves(x):
    """x with every tensor leaf cloned (tuples, NamedTuples, lists, dicts)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_leaves(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        vals = [_clone_leaves(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def _bits(x):
    """A tensor's bits (floats viewed as integers: NaNs compare too)."""
    import torch

    views = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(views[x.dtype]) if x.dtype in views else x


class _GraphRecorder:
    """Inside `with`: records the graphs.step calls of `names` that replay a
    graph (not a key's first call, which runs the body; arguments, outputs,
    and the kernel launches they counted, as
    `_counts` reads them; None where the call also captured). `check`
    then runs each recorded step's eager body on the same arguments
    (graphs.inline()) and holds its outputs bit for bit, and its kernel
    launches, against the replay's. With `stage` (a worker thread's graphs)
    a replay's launches are read from that launch_stage's counts."""

    def __init__(self, kc, names, stage=None):
        self.kc, self.names, self.calls, self.stage = kc, set(names), [], stage

    def _launch_counts(self):
        """The counts a recorded call's launches are read from: every
        thread's (`_counts`), or with `stage` (a worker thread's calls,
        beside the main thread's launches) the kNN launches counted under
        that launch_stage."""
        if self.stage is None:
            return _counts(self.kc)
        return {k: getattr(self.kc, w).launches_by_stage.get(self.stage, 0)
                for k, w in (("K1", "knn_grouped"), ("K2", "knn_exact"), ("K3", "knn_sparse"),
                             ("Morton keys", "morton_keys"))}

    def __enter__(self):
        from vil_fusion_tpu_torch.utils import graphs

        self.graphs, self.step = graphs, graphs.step

        def rec(name, fn, args, static=(), lock=None):
            if name not in self.names or graphs.capturing() or getattr(graphs._tls, "inline", 0):
                return self.step(name, fn, args, static, lock)
            n_cap, r0 = len(graphs.captures), graphs.replays.get(name, 0)
            c0 = self._launch_counts()
            # global fusion's stores are written in place after the call: keep
            # the arguments as the call saw them
            kept = _clone_leaves(args) if name in FUSION_GRAPHS else args
            out = self.step(name, fn, args, static, lock)
            c1 = self._launch_counts()
            if graphs.replays.get(name, 0) == r0:  # a key's first call: the body ran
                return out
            launched = ({k: c1[k] - c0[k] for k in c1} if len(graphs.captures) == n_cap
                        else None)
            self.calls.append((name, fn, kept, out, launched, static,
                               graphs.last_settlement()))
            return out

        graphs.step = rec
        return self

    def __exit__(self, *exc):
        self.graphs.step = self.step

    def check(self, label):
        """Every recorded replay against the eager body; returns the checked
        calls by step name."""
        import torch

        done, t0 = {}, time.perf_counter()
        torch.cuda.synchronize()
        for n, (name, fn, args, out, launched, _, settled) in enumerate(self.calls):
            c0 = _counts(self.kc)
            with self.graphs.inline():
                ref = fn(*args)
            c1 = _counts(self.kc)
            eager = {k: c1[k] - c0[k] for k in (c1 if launched is None else launched)}
            if launched is not None and settled is not None:
                # the eager body runs both branches of a conditional node, the
                # replay the taken one: add what it ran and what it skipped
                for taken in (True, False):
                    extra = self._applied(settled.launches_of(taken, wait=True))
                    launched = {k: launched[k] + extra[k] for k in launched}
                launched["cond"] = 0  # the set kernels: graphs only
                eager["cond"] = 0
            a, b = _leaves(out), _leaves(ref)
            bad = [i for i, (x, y) in enumerate(zip(a, b))
                   if not (isinstance(x, torch.Tensor) and x.shape == y.shape
                           and x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)))]
            if bad or len(a) != len(b):
                raise AssertionError(f"{label}: replay {n} of {name}: outputs {bad} of "
                                     f"{len(a)} differ from the eager body's ({len(b)})")
            if launched is not None and launched != eager:
                raise AssertionError(f"{label}: replay {n} of {name} counted kernel launches "
                                     f"{launched}, its eager body {eager}")
            done[name] = done.get(name, 0) + 1
        print(f"  {label}: graph = eager body bit for bit, and the same kernel launches (a "
              f"conditional node's taken and skipped bodies together), on every replay: "
              f"{done} ({time.perf_counter() - t0:.1f} s)", flush=True)
        return done

    def _applied(self, launches) -> dict:
        """The launch counts (as _counts reads them) that `launches`, (count,
        args) pairs of a settlement, add (applied to the counters: after the
        run's gates)."""
        c0 = _counts(self.kc)
        for count, a in launches:
            count(*a)
        c1 = _counts(self.kc)
        return {k: c1[k] - c0[k] for k in c1}

    def times(self, label, name, card, reps=5):
        """The last recorded replay of `name` timed again (CUDA-event and host
        medians over `reps` calls) against its eager body (2 calls)."""
        import torch

        _, fn, args, _, _, static, _ = [c for c in self.calls if c[0] == name][-1]
        out = {}
        for kind, call, n in (("graph", lambda: self.step(name, fn, args, static), reps),
                              ("eager", lambda: fn(*args), 2)):
            rows = []
            for _ in range(n):
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                t1 = time.perf_counter()
                ev[0].record()
                with (self.graphs.inline() if kind == "eager" else contextlib.nullcontext()):
                    call()
                ev[1].record()
                t2 = time.perf_counter()
                ev[1].synchronize()
                rows.append((1e3 * (t2 - t1), 1e3 * (time.perf_counter() - t1),
                             ev[0].elapsed_time(ev[1])))
            out[kind] = [sorted(col)[len(col) // 2] for col in zip(*rows)]
        print(f"  {label}: one {name} (medians), host ms to enqueue / until done / CUDA events: "
              + "; ".join(f"{k} " + " / ".join(f"{x:.2f}" for x in v) for k, v in out.items())
              + f" [{card}]", flush=True)
        return out


def _step_calls(names) -> dict:
    """Calls of graphs.step by name since the last _reset: replays, plus the
    first call of each key (its body runs eagerly)."""
    from vil_fusion_tpu_torch.utils import graphs

    return {k: graphs.replays.get(k, 0) + graphs.eager_calls.get(k, 0) for k in names}


def _by_name(caps) -> dict:
    """{graph name: (graphs, pool + static argument MiB)} of capture records."""
    out: dict = {}
    for c in caps:
        n, mib = out.get(c["name"], (0, 0.0))
        out[c["name"]] = (n + 1, round(mib + (c["pool_mib"] or 0.0) + c.get("static_mib", 0.0),
                                       1))
    return out


def _mib(x) -> str:
    return "n/a" if x is None else f"{x:.1f}"


def _capture_report(label, new):
    """One line a graph captured in a run: nodes, seconds, pool memory."""
    for c in new:
        nodes = c["nodes"] or {}
        print(f"  {label}: graph {c['name']}: {nodes.get('total', 'n/a')} nodes "
              f"({nodes.get('kernel', 'n/a')} kernels; {nodes.get('conditional', 0)} "
              f"conditional nodes, {nodes.get('in_bodies', 0)} nodes in their bodies), "
              f"warm-up {c['warmup_s']:.2f} s "
              f"({c['warmup_calls']} calls), capture {c['capture_s']:.2f} s, instantiation "
              f"{c['instantiate_s']:.2f} s, pool {_mib(c['pool_mib'])} MiB, static arguments "
              f"{c.get('static_mib', 0.0):.1f} MiB; captured on thread {c.get('thread')}, "
              f"graph replays during the capture by name {c.get('replays_during')}",
              flush=True)


# launch, copy and wait calls of the CUDA runtime as torch.profiler names them
_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")
_WAIT_KEYS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _graph_checks(name, steps, est, card):
    """Phase 7: every recorded steady step's graph result against the eager
    body (`_fused_full_step_body`) on the same inputs, bit for bit, both
    keyframe decisions among them; one replay's host time, device time and
    host launches (torch.profiler) beside the eager body's; each replay's
    eigh launches those of its taken marginalization path (1 + 1); a
    keyframe replay's and a non-keyframe replay's device time; one replay
    under torch.cuda.set_sync_debug_mode("error"); each marginalization
    path's device time alone (a graph each); the final window's two
    marginalizations: every matrix they hand the eigensolver through the
    kernel against torch.linalg.eigh and float64 (`_eigh_check`), a 15 x 15
    and a 157 x 157 of them timed through both in turns (returned), and each
    prior's factorization against its quadratic: J^T J within 1e-4 of the
    largest entry of Lam and J^T r0 within 1e-3 of g's
    (test_quadratic_to_factor_invariants), or within twice the plain
    version's distance where that is larger (on a real window g is not in
    the numerical range of Lam: the eigenvalues at float32's noise floor
    decide what of g survives, in torch.linalg.eigh too); the priors against the same
    marginalizations in float64 on the CPU are printed, not gated (float32
    lands up to 2.4e-2 from them whatever the eigensolver: the Schur
    elimination before it, test_torch_marginalization.py)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vil_fusion_tpu_torch.models import estimator as est_mod
    from vil_fusion_tpu_torch.models import marginalization as marg
    from vil_fusion_tpu_torch.utils import graphs

    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda

    keys, taken = [], []
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for n, (a, kw, out, settled) in enumerate(steps):
        body = est_mod._fused_full_step_body(*a[:17], run_ba=a[17], cfg=a[18])
        bad = [i for i, (x, y) in enumerate(zip(_leaves(out), _leaves(body)))
               if not torch.equal(x, y)]
        if bad:
            raise AssertionError(f"{name}: steady step {n}: the graph's outputs {bad} differ "
                                 f"from the eager body's")
        keys.append(bool(out[5]["is_key"]))
        if settled is not None:  # a replay: the eigh launches of the path it took
            e0, w0 = eigh_cuda.eigh.launches, eigh_cuda.eigh.launches_warp
            for count, arg in settled.launches_of(True, wait=True):
                count(*arg)
            taken.append((keys[-1], eigh_cuda.eigh.launches - e0 - (
                eigh_cuda.eigh.launches_warp - w0), eigh_cuda.eigh.launches_warp - w0))
    print(f"  {name}: graph = eager body bit for bit on all {len(steps)} steady steps "
          f"(keyframes {sum(keys)}, non-keyframes {len(keys) - sum(keys)}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if len(set(keys)) < 2:
        raise AssertionError(f"{name}: the steady steps hold one keyframe decision: {keys}")
    print(f"  {name}: eigh launches of each replay's taken marginalization path (keyframe, "
          f"block, warp): {taken}", flush=True)
    if not taken or any(t[1:] != (1, 1) for t in taken) or len({t[0] for t in taken}) < 2:
        raise AssertionError(f"{name}: a replay's eigh launches {taken}, want 1 + 1 of the "
                             f"taken path with both decisions replayed")

    # a keyframe replay and a non-keyframe replay timed apart
    by_key = {}
    for k in (True, False):
        a, kw = next((a, kw) for a, kw, out, _ in reversed(steps) if bool(out[5]["is_key"]) == k)
        by_key[k] = _time_ms(lambda: est_mod.fused_full_step(*a, **kw), reps=5, warmup=1)
    print(f"  {name}: one replay of the step's graph, CUDA-event device ms (median of 5): "
          f"keyframe {by_key[True]:.2f}, non-keyframe {by_key[False]:.2f} [{card}]", flush=True)

    a, kw, _, _ = steps[-1]
    times = {}
    for kind, fn, reps in (("graph", lambda: est_mod.fused_full_step(*a, **kw), 5),
                           ("eager", lambda: est_mod._fused_full_step_body(
                               *a[:17], run_ba=a[17], cfg=a[18]), 2)):
        rows = []
        for _ in range(reps):
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t1 = time.perf_counter()
            ev[0].record()
            fn()
            ev[1].record()
            t2 = time.perf_counter()
            ev[1].synchronize()
            t3 = time.perf_counter()
            rows.append((1e3 * (t2 - t1), 1e3 * (t3 - t1), ev[0].elapsed_time(ev[1])))
        times[kind] = [sorted(col)[len(col) // 2] for col in zip(*rows)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("steady_step"):
            est_mod.fused_full_step(*a, **kw)
        torch.cuda.synchronize()

    def inside(ev, keys):
        return sum((c.name in keys) + inside(c, keys) for c in ev.cpu_children)

    rng = [e for e in prof.events() if e.name == "steady_step"]
    launches = {k: sum(inside(e, (k,)) for e in rng) for k in _LAUNCH_KEYS + ("cudaMemcpyAsync",)}
    launches = {k: v for k, v in launches.items() if v}
    print(f"  {name}: one steady step (medians), host ms to enqueue / until done / CUDA events: "
          f"graph " + " / ".join(f"{x:.2f}" for x in times["graph"]) + ", eager body "
          + " / ".join(f"{x:.2f}" for x in times["eager"]) + f" [{card}]", flush=True)
    print(f"  {name}: the step's host launches (torch.profiler, inside the call): {launches}, in "
          f"all {sum(launches.values())}; host waits "
          f"{sum(inside(e, _WAIT_KEYS + ('aten::item',)) for e in rng)}", flush=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        est_mod.fused_full_step(*a, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"  {name}: a replay under torch.cuda.set_sync_debug_mode('error'): no sync",
          flush=True)

    # each marginalization path alone as a graph of its own on the final window
    # (CUDA-event medians, its input copies and output clones included)
    st = (est.window, est.feats, est.pre, est.lidar, est.prior)
    path_ms = {}
    for key in (True, False):
        path = functools.partial(est_mod._marginalize_and_slide, key, cfg=est.cfg)
        path_ms[key] = _time_ms(lambda: graphs.step(f"marginalize_and_slide({key})", path, st,
                                                    static=(est.cfg,)), reps=10)
    print(f"  {name}: the marginalization paths alone (graphs, device ms): keyframe "
          f"{path_ms[True]:.2f}, non-keyframe {path_ms[False]:.2f}; the step's conditional node "
          f"runs the taken one [{card}]", flush=True)

    state, cfg = (est.window, est.feats, est.pre, est.lidar, est.prior), est.cfg

    def priors(st):
        return (marg.marginalize_old(*st, cfg.ba), marg.marginalize_second_new(st[4], st[0]))

    def f64(x):  # a (nested) NamedTuple on the CPU, floating fields in float64
        return type(x)(*(f64(v) if isinstance(v, tuple) else
                         (v.cpu().double() if v.is_floating_point() else v.cpu()) for v in x))

    def invariants(J, r0):
        J = J.double().cpu().numpy()
        return J.T @ J, J.T @ r0.double().cpu().numpy()

    # the matrices the two marginalizations hand the eigensolver (15 x 15
    # Schur blocks, 157 x 157 quadratics) and the quadratics they factor
    mats, quads = [], []
    sym_eigh, to_factor = marg.sym_eigh, marg._quadratic_to_factor

    def eigh_rec(A):
        mats.append(A)
        return sym_eigh(A)

    def factor_rec(Lam, g):
        quads.append((Lam, g))
        return to_factor(Lam, g)

    marg.sym_eigh, marg._quadratic_to_factor = eigh_rec, factor_rec
    try:
        kern = priors(state)
    finally:
        marg.sym_eigh, marg._quadratic_to_factor = sym_eigh, to_factor
    for n, A in enumerate(mats):
        S, V = sym_eigh(A)
        _eigh_check(f"{name} window matrix {n} ({A.shape[0]} x {A.shape[0]})", A, S, V,
                    torch.linalg.eigh(A)[0])
    # the kernels' time on the window's own matrices (marginalize_old's 15 and 157)
    eigh_times = {}
    for A in mats:
        key = f"window {A.shape[0]}x{A.shape[0]}"
        if key not in eigh_times:
            med, turns = _eigh_turns(A.contiguous())
            eigh_times[key] = dict(ms=med["kernel"], library_ms=med["library"], turns=turns)
    print(f"  {name}: eigh on the final window's matrices, kernel / torch.linalg.eigh ms "
          f"(CUDA-event medians in turns): " + ", ".join(
              f"{k} {v['ms']:.4f} / {v['library_ms']:.4f}" for k, v in eigh_times.items())
          + f" [{card}]", flush=True)
    marg.sym_eigh = torch.linalg.eigh
    try:
        plain = priors(state)
        ref = priors(tuple(f64(x) for x in state))
        plain_factors = [to_factor(L, g) for L, g in quads]
    finally:
        marg.sym_eigh = sym_eigh
    for n, ((Lam, g), kf, pf) in enumerate(zip(quads, [to_factor(L, g) for L, g in quads],
                                              plain_factors)):
        L = (0.5 * (Lam + Lam.T)).double().cpu().numpy()
        gn = g.double().cpu().numpy()
        e = {}
        for k, (J, r0) in (("kernel", kf), ("torch.linalg.eigh", pf)):
            jj, jr = invariants(J, r0)
            e[k] = (np.abs(jj - L).max() / np.abs(L).max(),
                    np.abs(jr - gn).max() / np.abs(gn).max())
        print(f"  {name}: the window's quadratic {n} ({L.shape[0]} x {L.shape[0]}) factored, "
              f"J^T J - Lam / J^T r0 - g of their largest entries: "
              + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in e.items()), flush=True)
        if not (e["kernel"][0] <= max(1e-4, 2 * e["torch.linalg.eigh"][0])
                and e["kernel"][1] <= max(1e-3, 2 * e["torch.linalg.eigh"][1])):
            raise AssertionError(f"{name}: the window's quadratic {n} through the kernel: {e}")
    for what, pk, pp, pr in zip(("marginalize_old", "marginalize_second_new"), kern, plain, ref):
        r = invariants(pr.J, pr.r0)
        e = {k: [np.abs(u - v).max() / np.abs(v).max() for u, v in zip(invariants(x.J, x.r0), r)]
             for k, x in (("kernel", pk), ("torch.linalg.eigh", pp))}
        print(f"  {name}: the final window's {what} against float64 (not gated), J^T J / J^T r0 "
              f"of their largest entries: " + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}"
                                                         for k, v in e.items()), flush=True)
    return eigh_times


def _vil_frame(pipe, i, fr, img, imu, name, kc, per_frame, keys):
    """Frame i of `_vil_path`, with its per-frame gates: K1 / K2 launches as
    planned, no restart, the fused step on a steady frame."""
    from vil_fusion_tpu_torch.models import window
    from vil_fusion_tpu_torch.utils import graphs

    k1, k2 = _counts(kc)["K1"], _counts(kc)["K2"]
    fused, n_cap = pipe.estimator.fused_steps, len(graphs.captures)
    if imu is not None:
        pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
    pipe.push_scan(fr[0], fr[1], fr[2])
    pipe.push_image(fr[0], img)
    c = _counts(kc)
    per_frame.append((c["K1"] - k1, c["K2"] - k2))
    # K1: the odometry's two association passes (edge, surf) a frame,
    # both passes twice on the cold frames 1 and 2, none on frame 0;
    # K2: one depth association a frame; a frame that captures a graph also
    # counts its warm-up calls' launches
    want = (0 if i == 0 else 4 if i < 3 else 2, 1)
    captured = len(graphs.captures) > n_cap
    if not (per_frame[-1] == want or captured and all(
            g >= w for g, w in zip(per_frame[-1], want))):
        raise AssertionError(f"{name} frame {i}: K1 / K2 launches {per_frame[-1]}, want "
                             f"{want}")
    if pipe.restarts:
        raise AssertionError(f"{name} frame {i}: restart {pipe.restart_log}")
    if i >= window.K - 1:
        if pipe.estimator.fused_steps != fused + 1:
            raise AssertionError(f"{name} frame {i}: the steady frame skipped "
                                 f"fused_full_step")
        keys.append(pipe.estimator.last_is_key)  # a device tensor: read after the run


def _vil_report(name, pipe, frames, issued, completed, keys, per_frame, counts, dt, sync_depth,
                card, dev):
    """The end of `_vil_path`: states on the card, every steady frame issued
    and completed, finite outputs, the report and the end-error gate."""
    import numpy as np

    from vil_fusion_tpu_torch.models import window
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    est = pipe.estimator
    keys = [bool(k) for k in keys]
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
                  "vil_fused_frame", "frame_wait", "global_fusion") if k in stages), flush=True)
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
    from vil_fusion_tpu_torch.utils import graphs

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
    torch.cuda.synchronize()
    graphs.settle(wait=True)  # the last replays' conditional launches
    return _counts(kc)


def _frame_kind(before, after) -> str:
    """What a lap frame ran, from the counters `_lap_counters` read before
    and after it: "capture" (the frame's or the estimator's graph
    captured), "first body" (a key's first call: the eager body),
    "initialization" (the cold start succeeded: its SfM, alignment and BA),
    "initialization attempt" (refused), "filling" (not initialized yet), or
    "replay"."""
    if after["captures"] > before["captures"]:
        return "capture"
    if after["first bodies"] > before["first bodies"]:
        return "first body"
    if after["initialized"] and not before["initialized"]:
        return "initialization"
    if after["attempts"] > before["attempts"]:
        return "initialization attempt"
    return "replay" if after["initialized"] else "filling"


def _lap_counters(pipe) -> dict:
    from vil_fusion_tpu_torch.utils import graphs

    est = pipe.estimator
    steps = ("vil_frame", "fused_full_step")
    return {"captures": sum(c["name"] in steps for c in graphs.captures),
            "first bodies": sum(graphs.eager_calls.get(k, 0) for k in steps),
            "initialized": bool(est.initialized),
            "attempts": sum(est.init_failures.values()) + int(est.initialized)}


def _job_launches(prof) -> list:
    """(launches, host waits, async copies) of every "visual_loop" range
    (utils/tracing.py: one a worker job) in the trace, in time order: the
    runtime calls of the range's thread that start inside it. Read from the
    profiler's raw events (building its event tree takes minutes on a trace
    of every thread)."""
    import bisect

    import torch

    cpu = torch.autograd.DeviceType.CPU
    jobs, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name == "visual_loop" and e.device_type() == cpu:  # not its device range
            jobs.append((e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif name in _LAUNCH_KEYS or name in _WAIT_KEYS or name == "cudaMemcpyAsync":
            calls.setdefault(e.start_thread_id(), []).append((e.start_ns(), name))
    for rows in calls.values():
        rows.sort()
    out = []
    for t0, t1, tid in sorted(jobs):
        rows = calls.get(tid, [])
        inside = rows[bisect.bisect_left(rows, (t0, "")):bisect.bisect_right(rows, (t1, "~"))]
        out.append((sum(n in _LAUNCH_KEYS for _, n in inside),
                    sum(n in _WAIT_KEYS for _, n in inside),
                    sum(n == "cudaMemcpyAsync" for _, n in inside)))
    return out


def _stats_ms(xs) -> str:
    if not xs:
        return "none"
    xs = sorted(1e3 * x for x in xs)
    return (f"{len(xs)} jobs, mean {sum(xs) / len(xs):.2f} / p50 {xs[len(xs) // 2]:.2f} / "
            f"max {xs[-1]:.2f} ms")


def _log_vl_jobs(pipe) -> list:
    """A list that gets (kind, host s) for each visual-loop job `pipe`'s
    worker runs from now on (its `_visual_loop_step` wrapped). kind:
    "closed" (a loop closed), "verified" (verified, no loop), "keyframe"
    (inserted, nothing verified) or "skipped" (nothing inserted)."""
    log, db, inner = [], pipe.visual_loop, pipe._visual_loop_step

    def step(*args, **kw):
        n0, v0, t0 = db.n, db.stats["verify_attempts"], time.perf_counter()
        drift = inner(*args, **kw)
        kind = ("closed" if drift is not None else "skipped" if db.n == n0
                else "verified" if db.stats["verify_attempts"] > v0 else "keyframe")
        log.append((kind, time.perf_counter() - t0))
        return drift

    pipe._visual_loop_step = step
    return log


def _loop_path(dev, card, frame=None):
    """Phase 9: tests/test_e2e_loop.py's lap on the card, visual loop on its
    worker thread, sync_depth=2. Returns launch counts, with "K2 densify" the
    worker's K2 launches at the densification shape (extra corners x this
    frame's scan); fails on any of that test's asserts, on a worker error,
    and if the densification never reached K2. The worker's graphs
    (VL_GRAPHS) are recorded and every replay held bit for bit against its
    body; the worker's jobs of LOOP_PROFILE_FRAMES are traced for their
    launches (a steady keyframe job: fewer than VL_JOB_LAUNCHES_MAX); the
    lap's frames are classed by what they ran (`_frame_kind`) with their
    host seconds. `frame(i)` gives frame i (cold_start_frame by default)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.models import visual_loop as vl
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime import sim, tum
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.utils import graphs
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    rig, odom, gf_kw, traj, scene = cold_start_rig(sim, RigConfig)
    pipe = VILFusionPipeline(rig, mode="vil", visual_loop=True, sync_depth=2,
                             odom_overrides=odom, gf_cfg=gf.GlobalFusionConfig(**gf_kw),
                             vl_cfg=vl.VisualLoopConfig(**LOOP_VL), device=dev)
    _reset(kc)
    GLOBAL_TIMERS.reset()
    job_log = _log_vl_jobs(pipe)
    marks, kinds, state, jobs_put = {}, [], {}, []
    put = pipe._vl_jobs.put
    pipe._vl_jobs.put = lambda job: (jobs_put.append(job), put(job))[1]
    n_caps = len(graphs.captures)
    try:  # trace the worker's thread too
        prof_cfg = dict(experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    except TypeError:
        prof_cfg = {}

    def on_frame(i):
        now, after = time.perf_counter(), _lap_counters(pipe)
        kinds.append((_frame_kind(state["before"], after), now - state["t"]))
        if i in (LOOP_FRAMES // 4, LOOP_FRAMES // 2, 3 * LOOP_FRAMES // 4):
            marks[i] = now - t0
            print(f"  loop: frame {i} after {marks[i]:.1f} s", flush=True)
        if i + 1 in LOOP_PROFILE_FRAMES:  # the traced window's ends: no job in flight
            pipe._vl_idle.wait(timeout=120.0)
            torch.cuda.synchronize()
            if i + 1 == LOOP_PROFILE_FRAMES[0]:
                state["jobs0"], state["t_prof"] = len(job_log), time.perf_counter()
                state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA], **prof_cfg)
                state["prof"].__enter__()
            else:
                state["prof"].__exit__(None, None, None)
                state["jobs1"] = len(job_log)
                state["t_prof"] = time.perf_counter() - state["t_prof"]
        state["before"], state["t"] = _lap_counters(pipe), time.perf_counter()

    t0 = time.perf_counter()
    state["before"], state["t"] = _lap_counters(pipe), t0
    with _GraphRecorder(kc, VL_GRAPHS, stage="visual_loop") as rec:
        r = loop_lap(pipe, sim, tum, traj, scene, LOOP_FRAMES, on_frame, frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs.settle(wait=True)
    counts = _counts(kc)
    # a steady frame's estimator step: the frame's graph (fused frames) or the
    # step's own, a replay or a key's first call (the frame's body then calls
    # the step)
    c = _step_calls(("fused_full_step", "vil_frame"))
    replays = c["fused_full_step"] + c["vil_frame"] - graphs.eager_calls.get("vil_frame", 0)
    calls = kc.knn_exact.calls_by_stage.get("visual_loop", {})
    n_pts = 32 * 600
    counts["K2 densify"] = calls.get((pipe.visual_loop.cfg.extra_cap, n_pts, 3), 0)
    worker = {k: getattr(kc, w).launches_by_stage.get("visual_loop", 0)
              for k, w in (("K1", "knn_grouped"), ("K2", "knn_exact"), ("K3", "knn_sparse"))}
    stages = GLOBAL_TIMERS.summary()
    st = pipe.visual_loop.stats_summary()
    vl_replays = {k: graphs.replays.get(k, 0) for k in VL_GRAPHS}
    vl_first = {k: graphs.eager_calls.get(k, 0) for k in VL_GRAPHS}
    log = list(job_log)
    print(f"  loop: {LOOP_FRAMES} frames in {wall:.1f} s ({LOOP_FRAMES / wall:.3f} frames/s, "
          f"rendering included; frames {LOOP_PROFILE_FRAMES[0]}-{LOOP_PROFILE_FRAMES[1] - 1} "
          f"traced, {state.get('t_prof', 0.0):.1f} s of it) [{card}]", flush=True)
    worker_caps = [c for c in graphs.captures[n_caps:] if c["name"] in VL_GRAPHS]
    _capture_report("loop", worker_caps)
    # the main thread's frame replays made while a worker capture ran
    beside = {c["name"]: c["replays_during"].get("vil_frame", 0) for c in worker_caps}
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
    print(f"  loop: the worker's graphs: replays {vl_replays}, first calls of a key "
          f"{vl_first}, the main thread's vil_frame replays during each capture {beside}; "
          f"its jobs by kind, host ms (mean / p50 / max): " + "; ".join(
              f"{k} {_stats_ms([x for kk, x in log if kk == k])}"
              for k in ("keyframe", "verified", "closed", "skipped")) + f" [{card}]",
          flush=True)
    print(f"  loop: global fusion's graphs (ICP verifications, relaxations, keyframes): "
          f"replays { {k: graphs.replays.get(k, 0) for k in FUSION_GRAPHS} }, first calls "
          f"of a key { {k: graphs.eager_calls.get(k, 0) for k in FUSION_GRAPHS} }, loops "
          f"accepted {len(pipe.fusion.loops_found)}", flush=True)
    print(f"  loop: the frame's and the estimator's graphs called {replays} times for "
          f"{pipe.estimator.fused_steps} steady frames (replays {dict(graphs.replays)}, first "
          f"calls of a key {dict(graphs.eager_calls)}); eigh launches "
          f"{counts['eigh']} (block) "
          f"+ {counts['eigh warp']} (warp)",
          flush=True)
    by_kind: dict = {}
    for k, dt in kinds:
        n, tot = by_kind.get(k, (0, 0.0))
        by_kind[k] = (n + 1, tot + dt)
    print("  loop: frames by what they ran (frames, host s in all, mean ms; a frame's fetch "
          "and pushes): " + "; ".join(
              f"{k} {n}, {tot:.2f} s, {1e3 * tot / n:.1f}" for k, (n, tot) in by_kind.items())
          + f" [{card}]", flush=True)
    traced_jobs = _job_launches(state["prof"]) if "prof" in state else []
    traced = log[state.get("jobs0", 0):state.get("jobs1", 0)]
    per_kind: dict = {}
    for (kind, dt), (n_l, n_w, n_c) in zip(traced, traced_jobs):
        per_kind.setdefault(kind, []).append((n_l, n_w, n_c, round(1e3 * dt, 2)))
    print(f"  loop: the worker's jobs of frames {LOOP_PROFILE_FRAMES[0]}-"
          f"{LOOP_PROFILE_FRAMES[1] - 1} under torch.profiler: {len(traced_jobs)} traced for "
          f"{len(traced)} logged; (launches incl. graph replays, host waits, async copies, "
          f"host ms) a job by kind {per_kind} [{card}]", flush=True)
    bad = loop_gates(r, LOOP_FRAMES)
    if replays != pipe.estimator.fused_steps or not replays:
        bad.append(f"{replays} graph replays for {pipe.estimator.fused_steps} fused steps")
    if pipe.vl_errors:
        bad.append(f"{pipe.vl_errors} visual-loop worker errors")
    if counts["K2 densify"] < 1:
        bad.append(f"the densification never launched K2 at ({pipe.visual_loop.cfg.extra_cap}, "
                   f"{n_pts}, 3): {calls}")
    if vl_replays["vl_keyframe"] < 1 or vl_replays["pnp_ransac"] < 1:
        bad.append(f"the worker's graphs replayed {vl_replays}")
    if (any(c["thread"] == threading.main_thread().name for c in worker_caps)
            or not any(beside.values())):
        bad.append(f"no worker capture ran beside a main-thread vil_frame replay: "
                   f"{[(c['name'], c['thread'], c['replays_during']) for c in worker_caps]}")
    closes = sum(k == "closed" for k, _ in log)
    if closes >= 2 and vl_replays["posegraph4dof_optimize"] != closes - 1:
        bad.append(f"{closes} loop closures, 4-DoF solve replays {vl_replays}: each closure "
                   f"after the first two calls of its key must be one replay")
    steady = [x[0] for x in per_kind.get("keyframe", [])]
    if len(traced_jobs) != len(traced) or not steady or max(steady) >= VL_JOB_LAUNCHES_MAX:
        bad.append(f"traced jobs {len(traced_jobs)} for {len(traced)} logged; keyframe jobs' "
                   f"launches {steady} (need at least one, each < {VL_JOB_LAUNCHES_MAX})")
    if bad:
        raise AssertionError("loop: " + "; ".join(bad))
    rec.check("loop (the worker's graphs)")

    # the lap's last two loop-closing jobs once more, traced (after the gates)
    again = [job for job, (kind, _) in zip(jobs_put, log) if kind == "closed"][-2:]
    n0, r0 = len(job_log), graphs.replays.get("posegraph4dof_optimize", 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **prof_cfg) as prof:
        for job in again:
            pipe._vl_idle.clear()
            put(job)
            pipe._vl_idle.wait(timeout=120.0)
        torch.cuda.synchronize()
    redo = [(kind, *c, round(1e3 * dt, 2))
            for (kind, dt), c in zip(job_log[n0:], _job_launches(prof))]
    solves = graphs.replays.get("posegraph4dof_optimize", 0) - r0
    print(f"  loop: the last {len(again)} loop-closing jobs run again under torch.profiler: "
          f"(kind, launches incl. graph replays, host waits, async copies, host ms) {redo}; "
          f"4-DoF solve replays {solves} [{card}]", flush=True)
    if pipe.vl_errors or solves != sum(x[0] == "closed" for x in redo):
        raise AssertionError(f"loop: the jobs run again: {redo}, 4-DoF replays {solves}, "
                             f"worker errors {pipe.vl_errors}")
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
    from vil_fusion_tpu_torch.utils import graphs

    out = ROOT / "build" / "smoke_synthetic"
    out.mkdir(parents=True, exist_ok=True)
    _reset(kc)
    with open(out / "stdout.txt", "w") as log, contextlib.redirect_stdout(log):
        rep = run_synthetic.main(["--frames", str(SYNTH_FRAMES), "--out", str(out),
                                  "--device", torch.device(dev).type])
    torch.cuda.synchronize()
    graphs.settle(wait=True)
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
    print(f"  synthetic: global fusion's graphs: replays "
          f"{ {k: graphs.replays.get(k, 0) for k in FUSION_GRAPHS} }, first calls of a key "
          f"{ {k: graphs.eager_calls.get(k, 0) for k in FUSION_GRAPHS} }; the visual-loop "
          f"worker's: replays { {k: graphs.replays.get(k, 0) for k in VL_GRAPHS} }, first "
          f"calls of a key { {k: graphs.eager_calls.get(k, 0) for k in VL_GRAPHS} }",
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


# phase 12: the parallel and batched paths. S sequences of phase 4's scans
# (sequence s starts at frame BATCH_STRIDE s), the batched kernels' shapes,
# the ranks of the gloo run on the one card, the preintegration segment
BATCH_S = 8
BATCH_STRIDE = 3
BATCH_WARMUP, BATCH_TIMED = 5, 10
BATCH_EXACT_STEPS = 3  # the short batched run of the exact kNN (K2)
BATCH_POSE_TOL_M = 1e-4  # a step against the single step (tests/test_parallel.py:169-171)
GLOO_RANKS = 4
GLOO_TIMEOUT_S = 240
SC_CAPACITY = 2048  # GlobalFusionConfig.node_capacity
# tests/test_parallel.py's tolerances of the sharded BA: the full LM loop
# (cost rtol 1e-3 / atol 1e-5, p 5e-3, q 1e-3, inverse depth 5e-3) and one
# GN step at fixed damping (cost rtol 1e-3, p and inverse depth 5e-4)
BA_TOL = dict(cost_rtol=1e-3, cost_atol=1e-5, p=5e-3, q=1e-3, inv_depth=5e-3)
BA_STEP_TOL = dict(cost_rtol=1e-3, cost_atol=0.0, p=5e-4, inv_depth=5e-4)


def _batched_kernel_phase(frames, dev):
    """12a: K1 (surf, edge) and K2 (ICP) over BATCH_S sequences in one
    launch, on BATCH_S different simulator maps (`_kernel_inputs` of the
    sequence starting at frame 2 s): rows bit for bit those of BATCH_S
    unbatched launches and within the unbatched tolerance of the plain
    batched version; a database shared by every sequence (stride 0); the
    180 ragged shapes of phase 3 at S = 3 bit for bit; CUDA-event ms of the
    batched call beside BATCH_S unbatched calls, the bound at BATCH_S x the
    pairs. Returns {kernel name: record} without launch counts."""
    import torch

    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    seqs = [_kernel_inputs(frames[2 * s:], dev, big=False).cases for s in range(BATCH_S)]
    records, shapes, errs = {}, {}, {}
    for kname, case in (("K1 batched", "surf"), ("K1 batched", "edge"), ("K2 batched", "icp")):
        grouped = kname.startswith("K1")
        kern = kc.knn_grouped if grouped else kc.knn_exact
        plain = kc.knn_grouped_plain if grouped else kc.knn_exact_plain
        k = seqs[0][case][6]
        q, db, v = (torch.stack([c[case][j] for c in seqs]).contiguous() for j in range(3))
        S, nq, nd = q.shape[0], q.shape[1], db.shape[1]
        before = kc.kernels_enqueued()
        d, i = kern(q, db, v, k=k)
        per_call = kc.kernels_enqueued() - before
        planned = 1 + kc.plan(nq, nd, k, sm_count, grouped, S).merge
        if per_call != planned:
            raise AssertionError(f"{kname} {case}: the batched call enqueued {per_call} kernels, "
                                 f"its plan says {planned}")
        for s in range(S):
            d1, i1 = kern(q[s], db[s], v[s], k=k)
            if not (torch.equal(d[s], d1) and torch.equal(i[s], i1)):
                raise AssertionError(f"{kname} {case}: sequence {s} differs from its unbatched "
                                     f"launch")
        d_sh, i_sh = kern(q, db[0], v[0], k=k)  # one database shared (stride 0)
        for s in range(S):
            d1, i1 = kern(q[s], db[0], v[0], k=k)
            if not (torch.equal(d_sh[s], d1) and torch.equal(i_sh[s], i1)):
                raise AssertionError(f"{kname} {case}: shared database, sequence {s} differs")
        d_p, i_p = plain(q, db, v, k=k)
        d_m, _ = plain(q, db, v, k=k + 1)
        torch.cuda.synchronize()
        label = f"{kname} {case} {S}x{nq}x{nd} k={k}"
        err = _compare(label + " vs plain batched", d.reshape(-1, k), i.reshape(-1, k),
                       d_p.reshape(-1, k), i_p.reshape(-1, k), d_m.reshape(-1, k + 1), k)
        errs[kname] = max(errs.get(kname, 0.0), err)
        ms = _time_ms(lambda: kern(q, db, v, k=k))
        ms_8 = _time_ms(lambda: [kern(q[s], db[s], v[s], k=k) for s in range(S)])
        plain_ms = _time_ms(lambda: plain(q, db, v, k=k), reps=5, warmup=1)
        b_ms, b_by = _knn_bound(S * nq, S * nd, k, pairs=S * nq * nd)
        shapes.setdefault(kname, {})[case] = dict(
            shape=f"{S}x{nq}x{nd} k={k}", ms=ms, unbatched_x_s_ms=ms_8, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, launches_per_call=per_call)
        print(f"  {label}: == {S} unbatched launches bit for bit (and with a shared database); "
              f"batched {ms:.4f} ms in {per_call} kernel(s) against {S} unbatched calls "
              f"{ms_8:.4f} ms, plain batched {plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} "
              f"(CUDA-event medians)", flush=True)

    # the ragged shapes of phase 3 at S = 3: rows bit for bit, whatever the
    # plan splits under the batch
    n_ragged, split_differs = 0, 0
    for nd in RAGGED_ND:
        db = torch.rand((3, nd, 3), device=dev) * 100 - 50
        v = torch.rand((3, nd), device=dev) < 0.9
        for nq in RAGGED_NQ:
            q = torch.rand((3, nq, 3), device=dev) * 100 - 50
            for k, form, grouped in itertools.product(RAGGED_K, ("expanded", "diff"),
                                                      (True, False)):
                kern = kc.knn_grouped if grouped else kc.knn_exact
                d, i = kern(q, db, v, k=k, form=form)
                for s in range(3):
                    d1, i1 = kern(q[s], db[s], v[s], k=k, form=form)
                    if not (torch.equal(d[s], d1) and torch.equal(i[s], i1)):
                        raise AssertionError(f"batched ragged {nq}x{nd} k={k} {form} grouped="
                                             f"{grouped}: sequence {s} differs")
                split_differs += (kc.plan(nq, nd, k, sm_count, grouped, 3)
                                  != kc.plan(nq, nd, k, sm_count, grouped))
                n_ragged += 1
    print(f"  K1 / K2 batched, both forms: == unbatched launches bit for bit at {n_ragged} "
          f"ragged shapes x S = 3 ({split_differs} of them split the database otherwise under "
          f"the batch)", flush=True)
    pk = "vil_fusion_tpu/ops/pallas/knn_pallas.py"
    for kname, main, replaces in (("K1 batched", "surf", f"{pk}:202"),
                                  ("K2 batched", "icp", f"{pk}:53")):
        m = shapes[kname][main]
        records[kname] = dict(
            name=f"{kname} ({'knn_grouped' if kname[1] == '1' else 'knn_exact'} over a "
                 f"sequence axis, torch.func.vmap rule)", route="cuda",
            source="vil_fusion_tpu_torch/csrc/knn.cu", replaces=replaces,
            max_abs_err=errs[kname], shape=f"{main} {m['shape']}", ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=None, launches_per_call=m["launches_per_call"],
            unbatched_x_s_ms=m["unbatched_x_s_ms"], shapes=shapes[kname])
    return records


def _device_kernels(fn):
    """(device kernels, device ms) that fn() enqueues, as torch.profiler
    sees them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in ev), sum(e.device_time_total for e in ev) / 1e3


def _batched_odometry_path(frames, dev, card, fps_dense):
    """12b: odometry_step_batched over BATCH_S sequences of phase 4's scans
    (sequence s from frame BATCH_STRIDE s), the pipeline's odometry
    configuration (16,384 / 32,768 maps, K1), BATCH_WARMUP + BATCH_TIMED
    steps. Every batched step against odometry_step on each sequence from
    the same state (the batched state's row) and the same scan, within
    BATCH_POSE_TOL_M (free-running, the trajectories would part: one
    rounding apart at a step, a correspondence gate can flip at the next,
    as for any perturbation of the single step; PERF.md, section 6), and the
    batched end errors against the ground truth. The single steps are
    timed for one sequence's rate. Then BATCH_EXACT_STEPS batched steps of
    the exact kNN (K2). Returns the launch counts of the two runs and the
    rates."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import lidar_odometry as lo
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime.pipeline import _odom_config
    from vil_fusion_tpu_torch.utils import graphs

    cfg = _odom_config(_rig(), None)
    n = BATCH_WARMUP + BATCH_TIMED
    pts = torch.stack([torch.stack([torch.from_numpy(frames[BATCH_STRIDE * s + f][1])
                                    for s in range(BATCH_S)]) for f in range(n)]).to(dev)
    val = torch.stack([torch.stack([torch.from_numpy(frames[BATCH_STRIDE * s + f][2])
                                    for s in range(BATCH_S)]) for f in range(n)]).to(dev)
    states = lo.init_state_batched(cfg, BATCH_S, device=dev)
    _reset(kc)
    before_step, outs = [], []
    with _GraphRecorder(kc, ("odometry_step_batched",)) as rec:
        for f in range(n):
            if f == BATCH_WARMUP:
                torch.cuda.synchronize()
                t0, k1_before = time.perf_counter(), kc.knn_grouped.launches_batched
                r_before = graphs.replays.get("odometry_step_batched", 0)
            before_step.append(states)
            states, out = lo.odometry_step_batched(states, pts[f], val[f], cfg, frame_count=f)
            outs.append(out)
        torch.cuda.synchronize()
    dt_b = time.perf_counter() - t0
    timed_replays = graphs.replays.get("odometry_step_batched", 0) - r_before
    if timed_replays != BATCH_TIMED:
        raise AssertionError(f"batched: {timed_replays} odometry_step_batched replays in "
                             f"{BATCH_TIMED} timed steady steps (one a step)")
    k1_batched = (kc.knn_grouped.launches_batched - k1_before) / BATCH_TIMED
    counts = {"batched": {"K1 batched": kc.knn_grouped.launches_batched}}
    rec.check("batched (odometry_step_batched)")  # its eager bodies launch K1 too: counted above
    _on_card({f"states.{k}": v for k, v in states._asdict().items()}, dev)
    # one more step of each kind under the profiler: the card's launches a step
    kern_b, dev_ms_b = _device_kernels(
        lambda: lo.odometry_step_batched(states, pts[n - 1], val[n - 1], cfg, frame_count=n))
    kern_1, dev_ms_1 = _device_kernels(
        lambda: lo.odometry_step(lo.MapState(*(a[0] for a in states)), pts[n - 1, 0],
                                 val[n - 1, 0], cfg, frame_count=n))

    # every batched step against the single step from the same state; the
    # timed steps' single steps give one sequence's rate
    step_err, dt_single, k1_single = 0.0, 0.0, 0
    for f in range(n):
        outs_1 = []
        torch.cuda.synchronize()
        t0, before = time.perf_counter(), kc.knn_grouped.launches
        for s in range(BATCH_S):
            one = lo.MapState(*(a[s] for a in before_step[f]))
            outs_1.append(lo.odometry_step(one, pts[f, s], val[f, s], cfg, frame_count=f)[1])
        torch.cuda.synchronize()
        if f >= BATCH_WARMUP:
            dt_single += time.perf_counter() - t0
            k1_single = (kc.knn_grouped.launches - before) / BATCH_S
        for s, o in enumerate(outs_1):
            step_err = max(step_err, max((a[s] - b).abs().max().item()
                                         for a, b in zip(outs[f], o)))
    p_b = torch.stack([o[1] for o in outs], dim=1)  # (S, steps, 3)
    fin = bool(torch.isfinite(p_b).all())
    if k1_batched != k1_single:
        raise AssertionError(f"batched: {k1_batched} K1 launches a batched step, {k1_single} a "
                             f"single sequence's step")
    if not (fin and step_err <= BATCH_POSE_TOL_M):
        raise AssertionError(f"batched: poses finite {fin}, max |batched step - single step| "
                             f"{step_err} m > {BATCH_POSE_TOL_M} m")
    gt_err = []
    for s in range(BATCH_S):
        f0 = BATCH_STRIDE * s
        R0, p0 = frames[f0][3], frames[f0][4]
        gt = R0.T @ (frames[f0 + n - 1][4] - p0)
        gt_err.append(float(np.linalg.norm(p_b[s, -1].cpu().numpy() - gt)))
    if max(gt_err) >= END_ERR_BOUND_M:
        raise AssertionError(f"batched: end errors {gt_err} >= {END_ERR_BOUND_M} m")
    fps_b = BATCH_S * BATCH_TIMED / dt_b
    fps_1 = BATCH_S * BATCH_TIMED / dt_single
    print(f"  batched: {BATCH_S} sequences x {BATCH_TIMED} timed steps after {BATCH_WARMUP} "
          f"(one odometry_step_batched replay a step): {fps_b:.3f} frames/s aggregate (one "
          f"sequence's odometry_step alone, a replay a step: {fps_1:.3f} frames/s; phase 4's "
          f"dense pipeline {fps_dense:.3f}) [{card}]", flush=True)
    print(f"  batched: every step within {step_err:.3g} m of odometry_step from the same state "
          f"(tolerance {BATCH_POSE_TOL_M} m); end errors against the ground truth "
          f"{np.round(gt_err, 4).tolist()} m (bound {END_ERR_BOUND_M} m); K1 "
          f"{k1_batched:g} launches a batched step (one sequence's step: {k1_single:g}); device "
          f"kernels a step (torch.profiler): batched {kern_b} ({dev_ms_b:.3f} ms of device "
          f"time), one sequence {kern_1} ({dev_ms_1:.3f} ms)", flush=True)

    # the exact kNN over the batch (K2)
    cfg_x = cfg._replace(approx_knn=False)
    states = lo.init_state_batched(cfg_x, BATCH_S, device=dev)
    before = kc.knn_exact.launches_batched
    for f in range(BATCH_EXACT_STEPS):
        states, out = lo.odometry_step_batched(states, pts[f], val[f], cfg_x, frame_count=f)
    torch.cuda.synchronize()
    counts["batched exact"] = {"K2 batched": kc.knn_exact.launches_batched - before}
    if not bool(torch.isfinite(states.p).all()) or counts["batched exact"]["K2 batched"] < 1:
        raise AssertionError(f"batched exact: poses finite {bool(torch.isfinite(states.p).all())},"
                             f" launches {counts['batched exact']}")
    print(f"  batched exact: {BATCH_EXACT_STEPS} steps, K2 batched launches "
          f"{counts['batched exact']['K2 batched']}", flush=True)
    return counts, dict(fps_batched=fps_b, fps_single=fps_1, kernels_batched_step=kern_b,
                        kernels_single_step=kern_1, step_err_m=step_err)


def _sharded_inputs(frames, est, dev):
    """12c / 12d inputs: surf queries and map of phase 3's inputs, a
    ScanContext database of SC_CAPACITY slots holding the descriptors of
    phase 4's scans with the last one as the query, and the estimator state
    phase 7 had after SHARDED_WINDOW_FRAMES frames."""
    import torch

    from vil_fusion_tpu_torch.models import scancontext as sc

    q, db, v = _kernel_inputs(frames, dev, big=False).cases["surf"][:3]
    sdb = sc.init_db(SC_CAPACITY, device=dev)
    descs = [sc.make_descriptor(torch.from_numpy(fr[1]).to(dev), torch.from_numpy(fr[2]).to(dev))
             for fr in frames]
    for d in descs[:-1]:
        sc.add_keyframe(sdb, d)
    return dict(knn=(q, db, v), sc=(sdb, descs[-1]), ba=est)


def _ba_close(name, got, ref, tol, poses=True):
    """Two (state, feats, cost) within the tolerances `tol` (BA_TOL,
    BA_STEP_TOL): the cost, and with `poses` every key of `tol` among p, q
    and inv_depth. Returns the largest |difference| of p, q and the inverse
    depths."""
    import numpy as np

    (st, ft, c), (st_r, ft_r, c_r) = got, ref
    np.testing.assert_allclose(float(c), float(c_r), rtol=tol["cost_rtol"],
                               atol=tol["cost_atol"], err_msg=name)
    pairs = {"p": (st.p, st_r.p), "q": (st.q, st_r.q),
             "inv_depth": (ft.inv_depth, ft_r.inv_depth)}
    for key, (a, b) in pairs.items():
        if poses and key in tol:
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=tol[key],
                                       err_msg=f"{name} {key}")
    return {k: (a.cpu() - b.cpu()).abs().max().item() for k, (a, b) in pairs.items()}


def _ba_step(state, feats, pre, lidar, prior, cfg, lam=1e-4):
    """One GN step at fixed damping on one device: the unsharded
    counterpart of sharded_ba.optimize_step_sharded (the cost before it)."""
    import torch

    from vil_fusion_tpu_torch.models import ba

    sys_ = ba.build_system(state, feats, pre, lidar, prior, cfg)
    delta, delta_d = ba.schur_solve(sys_, torch.as_tensor(lam, dtype=state.p.dtype,
                                                          device=state.p.device), cfg)
    st, ft = ba._apply(state, feats, delta, delta_d, cfg)
    return st, ft, sys_.cost


def _sharded_phase(inp, dev, card, backend="nccl"):
    """12c: knn_sharded, detect_loop_sharded and optimize_sharded at world
    size 1 over NCCL on the card against knn_exact, detect_loop and
    ba.optimize. Returns the sharded results (the reference of 12d).
    `backend` other than NCCL (gloo: a CPU rehearsal) runs on `dev`."""
    import socket

    import torch
    import torch.distributed as dist

    from vil_fusion_tpu_torch.models import ba, scancontext as sc
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.parallel import mesh as mesh_mod
    from vil_fusion_tpu_torch.parallel import sharded_ba, sharded_knn, sharded_sc

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod.make_mesh(1, device=None if backend == "nccl" else dev)
        if mesh.device != torch.device(dev):
            raise AssertionError(f"sharded: the NCCL rank's device is {mesh.device}")
        q, db, v = inp["knn"]
        d_s, i_s = sharded_knn.knn_sharded(mesh, q, db, v, k=5)
        d_x, i_x = kc.knn_exact(q, db, v, k=5)
        if not (torch.equal(d_s, d_x) and torch.equal(i_s, i_x)):
            raise AssertionError("sharded: knn_sharded differs from knn_exact")
        sdb, query = inp["sc"]
        sc_s = sharded_sc.detect_loop_sharded(mesh, sdb, query)
        sc_r = sc.detect_loop(sdb, query)
        if not all(torch.equal(a.reshape(()).to(b.dtype), b.reshape(())) for a, b in zip(sc_s, sc_r)):
            raise AssertionError(f"sharded: detect_loop_sharded {sc_s} != detect_loop {sc_r}")
        cfg = ba.BAConfig()
        step_s = sharded_ba.optimize_step_sharded(mesh, *inp["ba"], cfg)
        d_step = _ba_close("sharded GN step (world 1) vs one step", step_s,
                           _ba_step(*inp["ba"], cfg), BA_STEP_TOL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ba_s = sharded_ba.optimize_sharded(mesh, *inp["ba"], cfg)
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ba_r = ba.optimize(*inp["ba"], cfg)
        torch.cuda.synchronize()
        t_r = time.perf_counter() - t0
        d_ba = _ba_close("sharded BA (world 1) vs ba.optimize", ba_s, ba_r, BA_TOL)
    finally:
        dist.destroy_process_group()
    print(f"  sharded ({backend}, world size 1, {mesh.device}): knn_sharded surf {q.shape[0]}x"
          f"{db.shape[0]} k=5 == knn_exact bit for bit; detect_loop_sharded on {SC_CAPACITY} "
          f"slots ({int(sdb.count)} descriptors) == detect_loop (slot {int(sc_s[0])}, distance "
          f"{float(sc_s[1]):.4f}, shift {int(sc_s[2])}); optimize_sharded against ba.optimize on "
          f"phase 7's window after {SHARDED_WINDOW_FRAMES} frames "
          f"({inp['ba'][1].active.shape[0]} feature slots, "
          f"{cfg.max_iters} LM iterations): max |diff| {_fmt(d_ba)}, cost {float(ba_s[2]):.6g} "
          f"vs {float(ba_r[2]):.6g}; one GN step max |diff| {_fmt(d_step)}; host "
          f"{t_s * 1e3:.1f} / {t_r * 1e3:.1f} ms [{card}]", flush=True)
    return dict(knn=(d_s, i_s), sc=sc_s, ba=ba_s, ba_step=step_s)


def _fmt(diffs):
    return ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())


def _gloo_rank(rank, world, init_file, in_path, out_path, device="cuda:0"):
    """One rank of 12d: the sharded functions over gloo with CUDA tensors
    on the one card (`device`). Imports the port alone."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from vil_fusion_tpu_torch.parallel import mesh as mesh_mod
    from vil_fusion_tpu_torch.parallel import sharded_ba, sharded_knn, sharded_sc
    from vil_fusion_tpu_torch.models import ba, scancontext as sc

    inp = torch.load(in_path, map_location=device, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = mesh_mod.make_mesh(world, device=device)
        out = dict(knn=sharded_knn.knn_sharded(mesh, *inp["knn"], k=5),
                   sc=sharded_sc.detect_loop_sharded(mesh, sc.ScanContextDB(*inp["sc"][0]),
                                                     inp["sc"][1]),
                   ba=sharded_ba.optimize_sharded(mesh, *inp["ba"], ba.BAConfig()),
                   ba_step=sharded_ba.optimize_step_sharded(mesh, *inp["ba"], ba.BAConfig()),
                   jax_imported="jax" in sys.modules)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    torch.save(_to_cpu(out), out_path)


def _to_cpu(x):
    """Tensors of a nested structure of tuples / dicts moved to the CPU."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_to_cpu(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _gloo_phase(inp, ref, dev, card):
    """12d: GLOO_RANKS spawned ranks on the one card over gloo with CUDA
    tensors (file rendezvous under build/), each joined within
    GLOO_TIMEOUT_S; their results against 12c's: the kNN and ScanContext
    bit for bit, one GN step within tests/test_parallel.py's one-step
    tolerances, the full LM loop's cost within its cost tolerance. The LM's
    poses are printed, not gated: on phase 7's window another reduction
    order can flip an accept / reject between the iterations and leaves
    the poses apart by up to a few mm in its weak directions (PERF.md,
    section 6), where the cost agrees."""
    import torch

    work = ROOT / "build" / "smoke_gloo"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()
    sdb, query = inp["sc"]
    in_path = work / "inputs.pt"
    torch.save(_to_cpu(dict(knn=inp["knn"], sc=(tuple(sdb), query), ba=inp["ba"])), in_path)
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_gloo_rank, args=(r, GLOO_RANKS, str(work / "rendezvous"),
                                                  str(in_path), str(work / f"rank{r}.pt"),
                                                  str(dev))) for r in range(GLOO_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            p.join(max(0.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise AssertionError(f"gloo: rank {r} exit code {p.exitcode} (None: hung past "
                                     f"{GLOO_TIMEOUT_S} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    d_ref, i_ref = (t.cpu() for t in ref["knn"])
    for r in range(GLOO_RANKS):
        res = torch.load(work / f"rank{r}.pt", weights_only=False)
        if res["jax_imported"]:
            raise AssertionError(f"gloo: rank {r} imported jax")
        if not (torch.equal(res["knn"][0], d_ref) and torch.equal(res["knn"][1], i_ref)):
            raise AssertionError(f"gloo: rank {r}: knn_sharded differs from 12c's")
        if [float(a) for a in res["sc"]] != [float(a) for a in ref["sc"]]:
            raise AssertionError(f"gloo: rank {r}: detect_loop_sharded {res['sc']} != {ref['sc']}")
        d_step = _ba_close(f"gloo rank {r} optimize_step_sharded vs 12c", res["ba_step"],
                           _to_cpu(ref["ba_step"]), BA_STEP_TOL)
        d_ba = _ba_close(f"gloo rank {r} optimize_sharded vs 12c", res["ba"], _to_cpu(ref["ba"]),
                         BA_TOL, poses=False)
    print(f"  gloo ({GLOO_RANKS} ranks on {dev}): knn_sharded == 12c bit for bit, "
          f"detect_loop_sharded == 12c, one GN step within tests/test_parallel.py's one-step "
          f"tolerances of 12c (max |diff| {_fmt(d_step)}), optimize_sharded's cost "
          f"{float(res['ba'][2]):.6g} against 12c's {float(ref['ba'][2]):.6g} (rtol "
          f"{BA_TOL['cost_rtol']}), its poses apart by {_fmt(d_ba)}; {wall:.1f} s with the "
          f"ranks' start [{card}]", flush=True)


def _preint_phase(dev, card):
    """12e: preintegrate(parallel=True) against the sequential loop on the
    card, tests/test_imu.py:131-161's 64-sample segment with 20 zero-dt
    steps and its tolerances; host ms (median of 10, ending in a
    synchronisation) and device kernels (torch.profiler) of each."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import imu

    rng = np.random.default_rng(7)
    n = 64
    acc = rng.normal([0.2, -0.1, 9.81], 0.4, (n, 3)).astype(np.float32)
    gyr = rng.normal([0.02, 0.3, -0.1], 0.1, (n, 3)).astype(np.float32)
    dt = np.full((n - 1,), 0.005, np.float32)
    dt[-20:] = 0.0
    args = [torch.from_numpy(x).to(dev) for x in
            (acc, gyr, dt, np.array([0.05, -0.02, 0.01], np.float32),
             np.array([0.002, 0.001, -0.003], np.float32))]
    res, host_ms, kernels = {}, {}, {}
    for parallel in (False, True):
        res[parallel] = imu.preintegrate(*args, parallel=parallel)
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imu.preintegrate(*args, parallel=parallel)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        host_ms[parallel] = sorted(times)[len(times) // 2]
        kernels[parallel] = _device_kernels(lambda: imu.preintegrate(*args, parallel=parallel))[0]
    par, seq = res[True], res[False]
    for k, rtol, atol in (("dp", 1e-5, 1e-6), ("dq", 1e-5, 1e-6), ("dv", 1e-5, 1e-6),
                          ("jac", 1e-4, 1e-5), ("cov", 1e-4, 1e-8)):
        np.testing.assert_allclose(getattr(par, k).cpu().numpy(), getattr(seq, k).cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"preintegration {k}")
    print(f"  preintegration (64 samples, 20 zero-dt steps): parallel == sequential within "
          f"tests/test_imu.py's tolerances; host ms (median of 10) parallel "
          f"{host_ms[True]:.3f} / sequential {host_ms[False]:.3f}, device kernels "
          f"{kernels[True]} / {kernels[False]} [{card}]", flush=True)
    return dict(host_ms_parallel=host_ms[True], host_ms_sequential=host_ms[False],
                kernels_parallel=kernels[True], kernels_sequential=kernels[False])


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card.")
    ap.add_argument("--save-window", metavar="PATH", default=None,
                    help="also save phase 7's estimator window after all its frames "
                         "(utils/state_io.to_numpy of window, feats, pre, lidar, prior; "
                         "torch.save) to PATH")
    args = ap.parse_args(argv)

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
        return _phases(card, dev, kc, pool, n_procs, t_start, args.save_window)
    finally:
        pool.terminate()
        pool.join()


def _phases(card, dev, kc, pool, n_procs, t_start, save_window=None) -> int:
    """Phases 2-12 of main(), the simulator's frames made in `pool`;
    `save_window`: where phase 7 saves its final window (or None)."""
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

    # phase 2: build, one nvcc a source, side by side
    from concurrent.futures import ThreadPoolExecutor

    from vil_fusion_tpu_torch.ops.cuda import cond_cuda as cc
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda as ec

    t1 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(b, verbose=True) for b in (kc.build, ec.build, cc.build)]:
            f.result()
    print(f"build: {time.perf_counter() - t1:.2f} s into {kc.BUILD_DIR}", flush=True)
    frames = scans.get()
    print(f"data: {len(frames)} simulated HDL-64 scans in {time.perf_counter() - t0:.1f} s "
          f"({n_procs} processes, beside the build)", flush=True)

    # phase 3: kernels against their plain versions
    print(f"kernels: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    records = _kernel_phase(frames, dev)
    records.update(_eigh_phase(dev))
    records.update(_cond_phase(dev, card))
    launches = {k: {} for k in records}

    def add(path, counts):
        for k, v in counts.items():
            launches[k][path] = v

    # phase 4: the dense path
    print(f"path dense: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    counts, fps_dense, pipe = _lidar_path("dense", frames, WARMUP_FRAMES, dev, card,
                                          need={"K1": 1, "K2": 0}, prewarm=True)
    _pose_errors("dense", pipe.outputs.lidar_p, pipe.outputs.lidar_q, frames, END_ERR_BOUND_M)
    del pipe
    print(f"  dense: {fps_dense:.3f} frames/s over {TIMED_FRAMES} frames after {WARMUP_FRAMES} "
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
    counts, fps_sync, vio_sync, est_state, window_eigh = _vil_path(
        frames[:n_vil], images[:n_vil], dev, card, save_window=save_window)
    for key, n in (("eigh", EIGH_SIZES[-1]), ("eigh warp", EIGH_SIZES[0])):
        records[key]["window"] = window_eigh[f"window {n}x{n}"]
    add("vil", counts)
    add("cold start", _cold_start(dev, lap))

    # phase 8: the same frames at sync_depth=2 (the deferred path)
    print(f"path deferred: [{time.perf_counter() - t_start:.1f} s after the device check]", flush=True)
    counts, fps_deferred, vio_deferred, _, _ = _vil_path(frames[:n_vil], images[:n_vil], dev,
                                                         card, sync_depth=2)
    add("deferred", counts)
    print(f"  deferred: frames/s sync_depth=0 {fps_sync:.3f}, sync_depth=2 {fps_deferred:.3f}; "
          f"largest distance between the two trajectories "
          f"{np.abs(vio_deferred - vio_sync).max():.4e} m (not gated) [{card}]", flush=True)

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

    # phase 12: the parallel and batched paths
    print(f"path parallel: [{time.perf_counter() - t_start:.1f} s after the device check]",
          flush=True)
    t0 = time.perf_counter()
    records.update(_batched_kernel_phase(frames, dev))
    launches.update({k: {} for k in ("K1 batched", "K2 batched")})
    batch_counts, batch_stats = _batched_odometry_path(frames, dev, card, fps_dense)
    for path, c in batch_counts.items():
        add(path, c)
    sharded_inp = _sharded_inputs(frames, est_state, dev)
    sharded_ref = _sharded_phase(sharded_inp, dev, card)
    _gloo_phase(sharded_inp, sharded_ref, dev, card)
    preint_stats = _preint_phase(dev, card)
    records["K1 batched"].update(batched_odometry=batch_stats, preintegration=preint_stats)
    print(f"  parallel phase: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    on_path = {"K1": ("dense", "front end", "vil", "deferred", "replay", "synthetic"),
               "K2": ("dense", "sparse", "front end", "vil", "cold start", "deferred", "loop",
                      "synthetic"),
               "K2 densify": ("loop",),
               "K3": ("sparse",), "K1 diff": ("diff",), "K2 diff": ("deskew",),
               "Morton keys": ("sparse",), "K1 batched": ("batched",),
               "K2 batched": ("batched exact",), "eigh": ("vil", "deferred", "loop"),
               "eigh warp": ("vil", "deferred", "loop"), "cond": ("vil", "deferred", "loop")}
    for kname, rec in records.items():
        rec["launches_by_path"] = launches[kname]
        rec["launches"] = sum(launches[kname].values())
        idle = [p for p in on_path[kname] if launches[kname].get(p, 0) < 1]
        if idle:
            raise AssertionError(f"{kname} was not launched on path(s) {idle}: {launches[kname]}")

    from vil_fusion_tpu_torch.utils import graphs

    caps = graphs.captures
    print(f"graphs: {len(caps)} captured in the run, by name "
          f"{dict(collections.Counter(c['name'] for c in caps))}; warm-up "
          f"{sum(c['warmup_s'] for c in caps):.1f} s, capture {sum(c['capture_s'] for c in caps):.1f}"
          f" s, instantiation {sum(c['instantiate_s'] for c in caps):.1f} s, pools "
          f"{sum(c['pool_mib'] or 0.0 for c in caps):.0f} MiB, static arguments "
          f"{sum(c.get('static_mib', 0.0) for c in caps):.0f} MiB; by name (graphs, pools + "
          f"static MiB) {_by_name(caps)}; the card's peak reserved memory "
          f"{torch.cuda.max_memory_reserved() / 2**20:.0f} MiB [{card}]", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s after the device check", flush=True)
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
