#!/usr/bin/env python3
"""What a replay of the vil frame's CUDA graph costs the host.

    python3 tools/graph_launch_cost.py [--reps 10] [--load 6]

Runs chip_smoke.py's vil path deferred (sync_depth=2, the rig and frames of
tools/profile_port.py --path vil) until the frame's graph (`vil_frame`,
utils/graphs.step) is captured and replaying, then times on the host clock
(medians of --reps) the graph's bare replay (torch.cuda.CUDAGraph.replay,
one cudaGraphLaunch):
  * idle: the device idle before the call;
  * behind itself: right after another replay of the same graph, which is
    still running (does the launch wait for it?);
  * after a torch.profiler session of one replay in this process;
  * under host load: --load processes spinning on the CPU;
and, for scale, a whole step call (input copies, replay, output clones)
with the device idle, and the replay's device time (CUDA events). Needs one
NVIDIA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import multiprocessing
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import profile_port as pp  # noqa: E402  (tools/ is on the path as the script's directory)


def _spin(stop):
    while not stop.is_set():
        pass


def _host_ms(fn, reps: int, before=None) -> float:
    """Median host ms of fn() over `reps` calls, `before()` run untimed
    ahead of each (default: wait for the device)."""
    import torch

    out = []
    for _ in range(reps):
        (before or torch.cuda.synchronize)()
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(out)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--load", type=int, default=6, help="spinning processes of the load case")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_launch_cost: no CUDA device", file=sys.stderr)
        return 2
    card = cs._card_line()
    print(f"card: {card}", flush=True)
    from vil_fusion_tpu_torch.utils import graphs

    dev = torch.device("cuda", 0)
    step = pp._stepper("vil", pp.WARMUP_VIL, dev, sync_depth=2)
    for i in range(pp.WARMUP_VIL):
        step(i)
    torch.cuda.synchronize()
    cs_frame = [s for k, s in graphs._steps.items() if k[0] == "vil_frame"]
    if len(cs_frame) != 1:
        print(f"graph_launch_cost: {len(cs_frame)} vil_frame graphs after the warm-up",
              file=sys.stderr)
        return 1
    frame = cs_frame[0]
    g = frame.graph
    nodes = (frame.stats["nodes"] or {}).get("total")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    g.replay()
    ev[1].record()
    ev[1].synchronize()
    device_ms = ev[0].elapsed_time(ev[1])
    rows = {
        "replay, device idle": _host_ms(g.replay, args.reps),
        "replay behind a running replay of itself": _host_ms(g.replay, args.reps,
                                                             before=lambda: (
                                                                 torch.cuda.synchronize(),
                                                                 g.replay())),
        "whole step call (copies, replay, clones), device idle": _host_ms(
            lambda: frame(*_args_of(frame)), args.reps),
    }
    ctx = multiprocessing.get_context("spawn")
    stop = ctx.Event()
    procs = [ctx.Process(target=_spin, args=(stop,), daemon=True) for _ in range(args.load)]
    for p in procs:
        p.start()
    try:
        time.sleep(1.0)
        rows[f"replay, device idle, {args.load} spinning processes"] = _host_ms(g.replay,
                                                                              args.reps)
    finally:
        stop.set()
        for p in procs:
            p.join(timeout=10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        g.replay()
        torch.cuda.synchronize()
    rows["replay, device idle, after a torch.profiler session"] = _host_ms(g.replay, args.reps)
    print(f"vil_frame graph: {nodes} nodes, {device_ms:.2f} ms of device time a replay "
          f"[{card}]", flush=True)
    for k, v in rows.items():
        print(f"  host ms (median of {args.reps}): {k}: {v:.3f}", flush=True)
    return 0


def _args_of(frame):
    """The captured step's own static buffers as its arguments (a replay on
    the inputs it already holds)."""
    from vil_fusion_tpu_torch.utils import graphs

    return graphs._unflatten(frame.spec, iter(frame.static))


if __name__ == "__main__":
    sys.exit(main())
