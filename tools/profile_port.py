#!/usr/bin/env python3
"""Where a frame of the PyTorch port spends its time on the card.

    python3 tools/profile_port.py [--path dense|sparse|front|vil|loop] [--frames 6]
                                  [--sync-depth 0|2]

Runs the path of chip_smoke.py of that name (same rig, scans, images, IMU
and configuration) for 8 warm-up frames (14 for vil: the estimator's window
fills at frame 10; 40 for loop, tests/test_e2e_loop.py's lap with the visual
loop on its worker thread and sync_depth=2: the cold start and the window's
filling, then steady frames with keyframe insertion and BoW queries, before
the revisit; its frames are rendered before the timing), times `--frames`
steady frames with
the host clock (no profiler: starting one costs seconds), then traces the
next `--frames` frames with torch.profiler (CPU + CUDA activities) and
prints: wall time per frame without the profiler and the host ms per frame
of each GLOBAL_TIMERS stage over those frames, device kernel time per
frame and its share of that wall time (the device's busy share), kernel
launches per frame (a CUDA graph's replay counts as one launch, its
kernels as device time), launches, host waits and copies per frame inside each
GLOBAL_TIMERS stage (the visual-loop worker's jobs are the stage
"visual_loop"; the trace covers every thread; the loop path also prints
each job's kind and host ms, and each traced job's launches, waits and
copies), the CUDA graphs replayed per frame by name and the kernels'
launches per frame as their wrappers count them (a replay counts the
launches its graph holds), the kNN kernels' share
of the device time, and the ten kernels with the most device time.
`--sync-depth 2` runs the vil path deferred (a steady frame one replay of
the frame's graph). Needs one NVIDIA card; prints the card's name and power
limit first.
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
WARMUP_VIL = 14
WARMUP_LOOP = 40


def _stepper(path: str, n: int, dev, sync_depth: int = 0):
    """A function step(i) that processes frame i of `path`, after set-up."""
    import numpy as np
    import torch

    if path == "loop":
        from vil_fusion_tpu_torch.models import global_fusion as gf
        from vil_fusion_tpu_torch.models import visual_loop as vl
        from vil_fusion_tpu_torch.runtime import sim
        from vil_fusion_tpu_torch.runtime.config import RigConfig
        from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

        rig, odom, gf_kw, traj, scene = cs.cold_start_rig(sim, RigConfig)
        pipe = VILFusionPipeline(rig, mode="vil", visual_loop=True, sync_depth=2,
                                 odom_overrides=odom, gf_cfg=gf.GlobalFusionConfig(**gf_kw),
                                 vl_cfg=vl.VisualLoopConfig(**cs.LOOP_VL), device=dev)
        lap = [cs.cold_start_frame(sim, traj, scene, i) for i in range(n)]

        def step_loop(i):
            t, imu, img, pts, val = lap[i]
            if imu is not None:
                pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
            pipe.push_scan(t, pts, val)
            return pipe.push_image(t, img)

        step_loop.pipe = pipe  # main() waits for its worker at the window's end
        step_loop.jobs = cs._log_vl_jobs(pipe)  # (kind, host s) a worker job
        return step_loop
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
    if path == "vil":
        from vil_fusion_tpu_torch.runtime import sim

        traj = sim.Trajectory(sim.TrajectoryConfig(speed=8.0))
        imus = [None] + [sim.simulate_imu(traj, fr[0] - cs.FRAME_DT, fr[0], cs.IMU_RATE)
                         for fr in frames[1:]]
        pipe = pl.VILFusionPipeline(cs._rig(), mode="vil", sync_depth=sync_depth,
                                    scan_quant=cs.SCAN_QUANT, device=dev)
        q0, p0 = traj.pose(frames[0][0])
        pipe.estimator.set_initial_state(p=p0 + np.array([0.0, 0.0, 1.5]), q=q0,
                                         v=traj.velocity(frames[0][0]))

        def step_vil(i):
            if imus[i] is not None:
                pipe.push_imu_batch(imus[i][0][1:], imus[i][1][1:], imus[i][2][1:])
            pipe.push_scan(frames[i][0], frames[i][1], frames[i][2])
            # reads the frame's pose (sync_depth 0) or the one sync_depth frames back
            return pipe.push_image(frames[i][0], images[i])

        return step_vil
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


# a CUDA graph's replay (the estimator's step) is one cudaGraphLaunch
_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch")
_WAIT_KEYS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _stage_names() -> set:
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    return set(GLOBAL_TIMERS.stats) | {"tracker", "lidar_odometry", "depth_association",
                                       "estimator", "global_fusion", "visual_loop"}


def _count_by_stage(prof, names, keys) -> dict:
    """Events named in `keys` inside each GLOBAL_TIMERS range (utils/tracing.py
    opens a profiler range per stage) of the trace."""
    out = {}

    def count(ev):
        return sum((c.name in keys) + count(c) for c in ev.cpu_children)

    for ev in prof.events():
        if ev.name in names:
            out[ev.name] = out.get(ev.name, 0) + count(ev)
    return out


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("dense", "sparse", "front", "vil", "loop"),
                    default="dense")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--sync-depth", type=int, default=0, help="vil path: the pipeline's "
                    "sync_depth (2: the deferred path, one frame graph a steady frame)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs._card_line()} | path {args.path}", flush=True)
    dev = torch.device("cuda", 0)
    n = args.frames
    warmup = dict(vil=WARMUP_VIL, loop=WARMUP_LOOP).get(args.path, WARMUP)
    step = _stepper(args.path, warmup + 2 * n, dev, args.sync_depth)
    for i in range(warmup):
        step(i)
    torch.cuda.synchronize()
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.utils import graphs

    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    cs._reset(kc)
    before = GLOBAL_TIMERS.summary()
    jobs0 = len(step.jobs) if hasattr(step, "jobs") else 0
    t0 = time.perf_counter()
    for i in range(warmup, warmup + n):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    after = GLOBAL_TIMERS.summary()
    print("  host ms per frame by stage over the timed frames (GLOBAL_TIMERS; the worker's "
          "'visual_loop' runs beside the main thread's stages): " + ", ".join(
              f"{k} {1e3 * (v['total_s'] - before.get(k, {}).get('total_s', 0.0)) / n:.2f}"
              for k, v in after.items()
              if v["n"] != before.get(k, {}).get("n", 0)), flush=True)
    if hasattr(step, "jobs"):
        print(f"  visual-loop worker jobs that ended in the timed frames: (kind, host ms) "
              f"{[(k, round(1e3 * dt, 2)) for k, dt in step.jobs[jobs0:]]}", flush=True)
    graphs.settle(wait=True)  # the conditional bodies' launches of the last replays
    print(f"  graph replays per frame: {({k: v / n for k, v in graphs.replays.items()})} "
          f"(steps that ran their body: {graphs.eager_calls}); kernel launches per frame "
          f"counted by the wrappers (replays included): "
          f"{({k: v / n for k, v in cs._counts(kc).items() if v})}", flush=True)
    try:  # trace the visual-loop worker's thread too
        cfg = dict(experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    except TypeError:
        print("  (this torch profiles the calling thread only)", flush=True)
        cfg = {}
    jobs = GLOBAL_TIMERS.summary().get("visual_loop", {}).get("n", 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **cfg) as prof:
        for i in range(warmup + n, warmup + 2 * n):
            step(i)
        if hasattr(step, "pipe"):  # let the worker's job in flight end inside the trace
            step.pipe._vl_idle.wait(timeout=120.0)
        torch.cuda.synchronize()
    if hasattr(step, "pipe"):
        jobs = GLOBAL_TIMERS.summary().get("visual_loop", {}).get("n", 0) - jobs
        log = step.jobs[len(step.jobs) - jobs:] if jobs else []
        print(f"  visual-loop worker jobs in the traced window: {jobs} (the stage "
              f"'visual_loop' below; its counts are per frame of the window); a job's "
              f"(kind, launches, host waits, async copies, host ms): "
              f"{[(k, *c, round(1e3 * dt, 2)) for (k, dt), c in zip(log, cs._job_launches(prof))]}"
              f"; the worker's graph replays over the timed and traced frames "
              f"{({k: graphs.replays.get(k, 0) for k in cs.VL_GRAPHS})}",
              flush=True)
    events = prof.key_averages()
    stage_names = _stage_names()
    # the stage ranges (utils/tracing.py) show on the device timeline too;
    # they are not kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in stage_names]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key in _LAUNCH_KEYS)
    graph_launches = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    print(f"{args.path}: {wall_ms:.2f} ms/frame wall over {n} frames without the profiler; "
          f"device kernels {dev_us / 1e3 / n:.3f} ms/frame over the next {n} = "
          f"{dev_us / 10 / n / wall_ms:.2f}% busy; {launches / n:.0f} kernel launches/frame "
          f"({graph_launches / n:.1f} of them graph replays)", flush=True)
    syncs = {e.key: e.count for e in events
             if "Memcpy" in e.key or "Synchronize" in e.key or e.key == "aten::item"}
    print(f"  host waits per frame: " + ", ".join(f"{k} {v / n:.1f}" for k, v in
                                                   sorted(syncs.items())), flush=True)
    for what, keys in (("kernel launches", _LAUNCH_KEYS),
                       ("host waits (stream syncs + .item())", _WAIT_KEYS),
                       ("async copies", ("cudaMemcpyAsync",))):
        stages = _count_by_stage(prof, stage_names, keys)
        if stages:
            print(f"  {what} per frame by stage (GLOBAL_TIMERS ranges): " + ", ".join(
                f"{k} {v / n:.1f}" for k, v in stages.items()), flush=True)
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
