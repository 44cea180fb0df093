#!/usr/bin/env python3
"""Where a frame of the PyTorch port spends its time on the card.

    python3 tools/profile_port.py [--path dense|sparse|front] [--frames 6]

Runs the path of chip_smoke.py of that name (same rig, scans, images and
configuration) for 8 warm-up frames, times `--frames` steady frames with
the host clock (no profiler: starting one costs seconds), then traces the
next `--frames` frames with torch.profiler (CPU + CUDA activities) and
prints: wall time per frame without the profiler, device kernel time per
frame and its share of that wall time (the device's busy share), kernel
launches per frame, the kNN kernels' share of the device time, and the ten kernels with
the most device time. Needs one NVIDIA card; prints the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

WARMUP = 8


def _stepper(path: str, n: int, dev):
    """A function step(i) that processes frame i of `path`, after set-up."""
    import numpy as np
    import torch

    frames = cs._sequence(n)
    if path in ("dense", "sparse"):
        from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

        overrides = None if path == "dense" else dict(
            sparse_knn=True, approx_knn=False, edge_map_cap=cs.MAP_CAPS_4X[0],
            surf_map_cap=cs.MAP_CAPS_4X[1])
        pipe = VILFusionPipeline(cs._rig(), mode="lidar", odom_overrides=overrides,
                                 scan_quant=cs.SCAN_QUANT, device=dev)
        return lambda i: pipe.push_scan(frames[i][0], frames[i][1], frames[i][2])

    from vil_fusion_tpu_torch.models import lidar_odometry as lo
    from vil_fusion_tpu_torch.models import tracker as trk
    from vil_fusion_tpu_torch.runtime import pipeline as pl

    images = cs._images(frames)
    fe = pl.front_end_config(cs._rig(), scan_quant=cs.SCAN_QUANT, device=dev)
    state = [trk.init_tracker(cs.IMG_H, cs.IMG_W, fe.tcfg, device=dev),
             lo.init_state(fe.lcfg, device=dev)]
    gen = torch.Generator(device=dev)
    host = [(np.clip(np.round(fr[1] / cs.SCAN_QUANT), -32767, 32767).astype(np.int16),
             np.packbits(fr[2])) for fr in frames]

    def step(i):
        state[0], state[1], out = pl.vil_front_end(
            state[0], state[1], torch.from_numpy(images[i]).to(dev),
            torch.from_numpy(host[i][0]).to(dev), torch.from_numpy(host[i][1]).to(dev),
            frames[i][0], fe, frame_index=i, generator=gen)
        return out["lidar_p"].cpu()  # the frame's one host read, as the pipeline does

    return step


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("dense", "sparse", "front"), default="dense")
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs._card_line()} | path {args.path}", flush=True)
    dev = torch.device("cuda", 0)
    n = args.frames
    step = _stepper(args.path, WARMUP + 2 * n, dev)
    for i in range(WARMUP):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + n):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(WARMUP + n, WARMUP + 2 * n):
            step(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(f"{args.path}: {wall_ms:.2f} ms/frame wall over {n} frames without the profiler; "
          f"device kernels {dev_us / 1e3 / n:.3f} ms/frame over the next {n} = "
          f"{dev_us / 10 / n / wall_ms:.2f}% busy; {launches / n:.0f} kernel launches/frame",
          flush=True)
    knn = [e for e in kernels if "knn_" in e.key]
    knn_us = sum(e.self_device_time_total for e in knn)
    print(f"  kNN kernels (csrc/knn.cu): {knn_us / 1e3 / n:.3f} ms/frame = "
          f"{100.0 * knn_us / max(dev_us, 1e-9):.2f}% of the device's kernel time in "
          f"{sum(e.count for e in knn) / n:.1f} launches/frame", flush=True)
    for e in sorted(knn, key=lambda e: -e.self_device_time_total):
        print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms/frame  {e.count / n:5.1f} "
              f"calls/frame  {e.key[:80]}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / args.frames:8.3f} ms/frame  "
              f"{e.count / args.frames:7.1f} calls/frame  {e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
