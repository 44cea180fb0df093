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
     k=3), K1 and K2 in both forms at few-query and ragged shapes (1-513
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
     every frame, lidar depth against the simulator's own raycast.
Every path checks that its state tensors are on the card, that its kernels
launched (counts set to 0 just before, read just after), that all poses are
finite and that the end position is within its bound of the simulator's
ground truth. The line before the last is the kernels' JSON record; the
last line is {"ok": true, "device": {...}}. Imports nothing of jax.
"""
from __future__ import annotations

import itertools
import json
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


def _sequence(n: int, distorted: bool = False):
    """n HDL-64 scans at 10 Hz along Trajectory(speed=8.0), sensor 1.5 m up:
    [(t, points (115200, 3) f32, valid, R_wb, p_wb)]; `distorted` sweeps each
    scan over its frame period (rolling shutter, end-of-scan pose)."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    off = np.array([0.0, 0.0, 1.5])
    frames = []
    for i in range(n):
        t = 1.0 + i * FRAME_DT
        R = traj.rotation(t)
        p = traj.position(t) + off
        if distorted:
            pts, val = sim.simulate_lidar_scan_distorted(scene, traj, t, FRAME_DT, off, **SCAN)
        else:
            pts, val = sim.simulate_lidar_scan(scene, R, p, **SCAN)
        frames.append((t, pts, val, R, p))
    return frames


def _images(frames):
    """uint8 camera images (370 x 1226) rendered at the frames' poses."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim

    scene = sim.RaycastScene()
    r_bc = np.array(R_BC)
    return [(np.clip(sim.render_camera_image(scene, fr[3] @ r_bc, fr[4], FX, FX, CX, CY,
                                             IMG_H, IMG_W), 0.0, 1.0) * 255.0).astype(np.uint8)
            for fr in frames]


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
    for fn in (kc.knn_grouped, kc.knn_exact):
        fn.launches = 0
        fn.launches_diff = 0
    kc.knn_sparse.launches = 0
    kc.morton_keys.launches = 0


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

    # phase 2: build
    t0 = time.perf_counter()
    kc.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s into {kc.BUILD_DIR}", flush=True)

    t0 = time.perf_counter()
    frames = _sequence(WARMUP_FRAMES + TIMED_FRAMES)
    print(f"data: {len(frames)} simulated HDL-64 scans in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 3: kernels against their plain versions
    print("kernels:", flush=True)
    records = _kernel_phase(frames, dev)
    launches = {k: {} for k in records}

    def add(path, counts):
        for k, v in counts.items():
            launches[k][path] = v

    # phase 4: the dense path
    print("path dense:", flush=True)
    counts, fps, pipe = _lidar_path("dense", frames, WARMUP_FRAMES, dev, card,
                                    need={"K1": 1, "K2": 0}, prewarm=True)
    _pose_errors("dense", pipe.outputs.lidar_p, pipe.outputs.lidar_q, frames, END_ERR_BOUND_M)
    del pipe
    print(f"  dense: {fps:.3f} frames/s over {TIMED_FRAMES} frames after {WARMUP_FRAMES} "
          f"warm-up frames [{card}]", flush=True)
    add("dense", counts)

    # phase 5: the sparse path and the short runs of the other options
    print("path sparse:", flush=True)
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
    distorted = _sequence(SHORT_RUNS["deskew"]["frames"], distorted=True)
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
    print("path front end:", flush=True)
    n = FRONT_WARMUP + FRONT_TIMED
    t0 = time.perf_counter()
    images = _images(frames[:n])
    print(f"data: {n} rendered {IMG_W} x {IMG_H} images in {time.perf_counter() - t0:.1f} s",
          flush=True)
    add("front end", _front_end_path(frames[:n], images, dev, card))

    on_path = {"K1": ("dense", "front end"), "K2": ("dense", "sparse", "front end"),
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
