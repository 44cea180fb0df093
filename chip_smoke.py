#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vil_fusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, any failure exits non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles csrc/knn.cu with nvcc for sm_90a into build/kernels/;
  3. kernels: K1 (grouped kNN) and K2 (exact kNN) against their plain
     PyTorch versions on the card, at the LiDAR-only path's shapes, on
     simulator-derived maps and on a random case; CUDA-event timings of
     kernel and plain version;
  4. the slice: VILFusionPipeline(mode="lidar") at KITTI HDL-64 scale
     (64 x 1800 = 115,200-point scans, 16,384 / 32,768-point maps, default
     global fusion) fed 5 warm-up + 40 timed simulated scans at 10 Hz,
     then fusion.prewarm() (one ICP loop verification) and finalize();
     checks that every state tensor is on the card, that both kernels ran
     on the main path, that all poses are finite and that the end position
     is within END_ERR_BOUND_M of the simulator's ground truth.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of jax.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

WARMUP_FRAMES = 5
TIMED_FRAMES = 40
FRAME_DT = 0.1
# End-position bound for the 40 + 5 frame run (35 m of travel): a bit over
# twice the JAX package's own end error on this trajectory (0.110 m, CPU,
# 32 x 900 scans); PERF.md ("PyTorch port on H100") records the numbers.
END_ERR_BOUND_M = 0.25
# main-path shapes: scan geometry, odometry map capacities, ICP submap
SCAN = dict(n_scan=64, width=1800, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0)
MAP_CAPS = (16384, 32768)
ICP_CLOUDS, CLOUD_PTS = 25, 2048


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


def _rig():
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig

    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    return RigConfig(
        name="kitti-hdl64",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=370, image_width=1226,
        q_ic=sim.R_to_q(r_bc), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(r_bc.T), t_cl=np.zeros(3),
        max_cnt=150, min_dist=30, n_scan=64,
        lidar_fov_up=2.0, lidar_fov_down=-24.8, lidar_min_range=1.0,
        lidar_max_range=80.0, use_lidar=True)


def _sequence(n: int):
    """n HDL-64 scans at 10 Hz along Trajectory(speed=8.0), sensor 1.5 m up:
    [(t, points (115200, 3) f32, valid, R_wb, p_wb)]."""
    import numpy as np

    from vil_fusion_tpu_torch.runtime import sim

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
    frames = []
    for i in range(n):
        t = 1.0 + i * FRAME_DT
        R = traj.rotation(t)
        p = traj.position(t) + np.array([0.0, 0.0, 1.5])
        pts, val = sim.simulate_lidar_scan(scene, R, p, **SCAN)
        frames.append((t, pts, val, R, p))
    return frames


def _margin_rows(d_ref, k: int):
    """Rows whose first k+1 reference distances are pairwise separated by
    more than 1e-6 relative: there the k-NN set and order are unambiguous."""
    import torch

    d = d_ref[:, : k + 1]
    gaps = d[:, 1:] - d[:, :-1]
    scale = torch.clamp(d[:, 1:], min=1e-12)
    ok = (gaps > 1e-6 * scale) | ~torch.isfinite(d[:, 1:])
    return ok.all(dim=1) & torch.isfinite(d[:, 0])


def _compare(name, d_k, i_k, d_p, i_p, d_p_more, k):
    """Kernel (d_k, i_k) against plain (d_p, i_p); d_p_more is the plain
    exact/grouped search with k+1 neighbours for the margin test. Returns
    max |d_k - d_p| over finite entries."""
    import torch

    fin = torch.isfinite(d_p)
    if not torch.equal(fin, torch.isfinite(d_k)):
        raise AssertionError(f"{name}: finite pattern differs from the plain version")
    err = (d_k[fin] - d_p[fin]).abs().max().item() if fin.any() else 0.0
    tol = 1e-6 * d_p[fin].abs().max().item() if fin.any() else 0.0
    if err > tol:
        raise AssertionError(f"{name}: max |d2 kernel - plain| = {err} > {tol}")
    rows = _margin_rows(d_p_more, k)
    bad = (i_k[rows] != i_p[rows]).any(dim=1).sum().item()
    if bad:
        raise AssertionError(f"{name}: {bad} of {int(rows.sum())} unambiguous rows "
                             f"pick other neighbours than the plain version")
    if (i_k[~torch.isfinite(d_k)] != 0).any():
        raise AssertionError(f"{name}: missing neighbours must carry index 0")
    print(f"  {name}: kernel == plain on {int(rows.sum())}/{rows.numel()} "
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


def _kernel_phase(frames, dev):
    """Phase 3. Returns the per-kernel records (without launch counts)."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.models import lidar_features as lf
    from vil_fusion_tpu_torch.ops import lie, voxel
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime import sim

    lcfg = lf.LidarConfig(n_scan=SCAN["n_scan"], width=SCAN["width"], min_range=1.0,
                          max_range=SCAN["max_range"], fov_up_deg=SCAN["fov_up_deg"],
                          fov_down_deg=SCAN["fov_down_deg"])
    ecap, scap = MAP_CAPS

    def world(fr, x):
        q = torch.as_tensor(sim.R_to_q(fr[3]), dtype=torch.float32, device=dev)
        p = torch.as_tensor(fr[4], dtype=torch.float32, device=dev)
        return lie.qrot(q, x) + p

    def feats(fr):
        pts = torch.from_numpy(fr[1]).to(dev)
        val = torch.from_numpy(fr[2]).to(dev)
        return lf.extract_features(pts, val, lcfg)

    # maps as lidar odometry holds them: hash-voxel merges of world features
    origin = torch.full((3,), -100.0, device=dev)
    edge_map = torch.zeros((ecap, 3), device=dev)
    edge_ok = torch.zeros(ecap, dtype=torch.bool, device=dev)
    surf_map = torch.zeros((scap, 3), device=dev)
    surf_ok = torch.zeros(scap, dtype=torch.bool, device=dev)
    for fr in frames[:6]:
        f = feats(fr)
        edge_map, edge_ok = voxel.merge_voxel_hash(edge_map, edge_ok, world(fr, f.edge),
                                                   f.edge_valid, 0.4, origin, ecap)
        surf_map, surf_ok = voxel.merge_voxel_hash(surf_map, surf_ok, world(fr, f.surf),
                                                   f.surf_valid, 0.8, origin, scap)
    fq = feats(frames[6])
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
    errs = {"K1": 0.0, "K2": 0.0}
    times = {}
    for name, (q_s, db_s, v_s, q_r, db_r, v_r, k, grouped) in cases.items():
        kern = kc.knn_grouped if grouped else kc.knn_exact
        plain = kc.knn_grouped_plain if grouped else kc.knn_exact_plain
        tag = "K1" if grouped else "K2"
        for variant, (q, db, v) in (("sim", (q_s, db_s, v_s)), ("random", (q_r, db_r, v_r))):
            d_k, i_k = kern(q, db, v, k=k)
            d_p, i_p = plain(q, db, v, k=k)
            d_more, _ = plain(q, db, v, k=k + 1)
            torch.cuda.synchronize()
            label = f"{tag} {name} {variant} {q.shape[0]}x{db.shape[0]} k={k}"
            errs[tag] = max(errs[tag], _compare(label, d_k, i_k, d_p, i_p, d_more, k))
            if grouped:
                d_x, _ = kc.knn_exact_plain(q, db, v, k=k)
                gate = None if variant == "random" else d_x[:, -1] < 9.0
                _grouped_bounds(label, d_k, d_x, gate)
        q, db, v = q_s, db_s, v_s
        ms = _time_ms(lambda: kern(q, db, v, k=k))
        plain_ms = _time_ms(lambda: plain(q, db, v, k=k))
        times[name] = (ms, plain_ms)
        print(f"  {tag} {name} {q.shape[0]}x{db.shape[0]} k={k}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (CUDA-event medians)", flush=True)
        if grouped:  # the exact kernel at the association shape (approx_knn=False)
            times[name + "_exact"] = _time_ms(lambda: kc.knn_exact(q, db, v, k=k))
            print(f"  K2 {name} {q.shape[0]}x{db.shape[0]} k={k}: kernel "
                  f"{times[name + '_exact']:.4f} ms (exact association, for comparison)",
                  flush=True)
    return [
        dict(name="K1 knn_grouped", route="cuda", source="vil_fusion_tpu_torch/csrc/knn.cu",
             replaces="vil_fusion_tpu/ops/pallas/knn_pallas.py:202",
             max_abs_err=errs["K1"], ms=times["surf"][0], plain_ms=times["surf"][1],
             shape=f"surf {n_ns}x{scap} k=5",
             edge_ms=times["edge"][0], edge_plain_ms=times["edge"][1]),
        dict(name="K2 knn_exact", route="cuda", source="vil_fusion_tpu_torch/csrc/knn.cu",
             replaces="vil_fusion_tpu/ops/pallas/knn_pallas.py:53",
             max_abs_err=errs["K2"], ms=times["icp"][0], plain_ms=times["icp"][1],
             shape=f"icp {src.shape[0]}x{n_t} k=1",
             edge_ms=times["edge_exact"], surf_ms=times["surf_exact"]),
    ]


def _slice_phase(frames, dev, card):
    """Phase 4. Returns (K1 launches, K2 launches)."""
    import numpy as np
    import torch

    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    pipe = VILFusionPipeline(_rig(), mode="lidar", scan_quant=0.0025, device=dev)
    kc.knn_grouped.launches = 0
    kc.knn_exact.launches = 0
    for fr in frames[:WARMUP_FRAMES]:
        pipe.push_scan(fr[0], fr[1], fr[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr in frames[WARMUP_FRAMES:WARMUP_FRAMES + TIMED_FRAMES]:
        pipe.push_scan(fr[0], fr[1], fr[2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pipe.fusion.prewarm()
    pipe.finalize()
    torch.cuda.synchronize()
    k1, k2 = kc.knn_grouped.launches, kc.knn_exact.launches

    states = {**{f"lidar_state.{k}": v for k, v in pipe.lidar_state._asdict().items()},
              **{f"graph.{k}": v for k, v in pipe.fusion.graph._asdict().items()},
              **{f"scdb.{k}": v for k, v in pipe.fusion.scdb._asdict().items()},
              "clouds": pipe.fusion.clouds, "cloud_valid": pipe.fusion.cloud_valid}
    off = [k for k, v in states.items() if v.device.type != torch.device(dev).type]
    if off:
        raise AssertionError(f"state tensors not on the card: {off}")
    if k1 < TIMED_FRAMES or k2 < 1:
        raise AssertionError(f"main path kernel launches: K1 {k1} (need >= {TIMED_FRAMES}), "
                             f"K2 {k2} (need >= 1)")
    lidar_p = np.stack(pipe.outputs.lidar_p)
    n = WARMUP_FRAMES + TIMED_FRAMES
    if lidar_p.shape != (n, 3) or not np.isfinite(lidar_p).all() \
            or not np.isfinite(np.stack(pipe.outputs.lidar_q)).all():
        raise AssertionError(f"odometry poses: shape {lidar_p.shape}, finite "
                             f"{np.isfinite(lidar_p).all()}")
    q_kf, p_kf = pipe.fusion.poses()
    if pipe.fusion.n_kf < 2 or not (np.isfinite(q_kf).all() and np.isfinite(p_kf).all()):
        raise AssertionError(f"keyframe graph: {pipe.fusion.n_kf} nodes, finite "
                             f"{np.isfinite(p_kf).all()}")
    # odometry frame = first body frame; ground truth expressed there
    R0, p0 = frames[0][3], frames[0][4]
    gt = np.stack([R0.T @ (fr[4] - p0) for fr in frames[:n]])
    errs = np.linalg.norm(lidar_p - gt, axis=1)
    print(f"  slice: {n} frames, {pipe.fusion.n_kf} keyframes, loops "
          f"{pipe.fusion.loops_found}, K1 launches {k1}, K2 launches {k2}", flush=True)
    print(f"  slice: end-position error {errs[-1]:.4f} m (bound {END_ERR_BOUND_M} m), "
          f"max {errs.max():.4f} m over {np.linalg.norm(gt[-1]):.1f} m of travel", flush=True)
    print(f"  slice: {TIMED_FRAMES / dt:.3f} frames/s over {TIMED_FRAMES} frames after "
          f"{WARMUP_FRAMES} warm-up frames [{card}]", flush=True)
    if not errs[-1] < END_ERR_BOUND_M:
        raise AssertionError(f"end-position error {errs[-1]:.4f} m >= {END_ERR_BOUND_M} m")
    return k1, k2


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

    # phase 4: the slice
    print("slice:", flush=True)
    k1, k2 = _slice_phase(frames, dev, card)
    records[0]["launches"] = k1
    records[1]["launches"] = k2

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
