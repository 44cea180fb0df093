#!/usr/bin/env python3
"""One traced run of a benchmark cell with the program's span log on
through the measured window: where the window's time goes on the device and
the host, on the host clock.

    python3 tools/window_spans.py --workload kitti_lidar.city_laps --seed 7 \
        [--seconds 30] [--record 1] [--out out/window_spans]

Runs `vilbench/run.py`'s run (harness.main, `--trace 1`) unchanged in this
process, with three hooks: recording (`GLOBAL_TIMERS.record`, device timing
on the card) starts at the window's first push and stops after the profiled
sub-window; the run's Record and the profiler's events are kept. Then it
reads the span metrics of vilbench/layer_metrics over the window's spans
(the device interval of a span covers the kernels it enqueued and the
launch gaps between them), host and device ms a scan by span, the window's
breakdown (idle gaps charged to
the innermost span open on the host; host ms by span of the slowest 5% of
scans beside the mean scan's), the share of the harness's push_scan time
that the stages inside the program's "push_scan" span cover, global
fusion's counters (since the process started, and from the window's first
push to the profiled sub-window: the loss counters, the fusion stream found
busy at a keyframe), and the shared-clock check: the spans' device
intervals put on the profiler's clock, and the share of the profiled
device time inside them.
With `--record 0` nothing is recorded (the same run, to time recording's
cost). Prints one JSON line last and writes it to OUT/<workload>_<seed>_<record>.json.
Needs one NVIDIA card.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPAN_METRICS = ("device.window_idle_pct.lidar", "lidar_odometry.device_ms",
                "lidar_odometry.pose_wait_ms", "pipeline.scan_quantize_ms",
                "global_fusion.device_ms.lidar", "lidar_odometry.host_ms",
                "global_fusion.host_ms.lidar", "global_fusion.backlog_wait_ms")


def install_hooks(state: dict, device) -> None:
    """Hook harness and trace: keep the run's Record (state["rec"]); with a
    `device`, record spans from the window's first push (the window's pushes
    pass the follower's hook) to the end of the profiled sub-window
    (state["log"], state["traced"]: its host interval); keep the profiler's
    events (state["events"])."""
    from vilbench import harness, trace as trace_mod
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    class Record(harness.Record):
        def __init__(self, *a):
            super().__init__(*a)
            state["rec"] = self

    push, traced, reduce = harness.Feeder.push, trace_mod.traced, trace_mod.reduce

    def push_hooked(self, hook=None):
        if hook is not None and "counters0" not in state:
            state["counters0"] = dict(GLOBAL_TIMERS.counters)
        if hook is not None and device is not None and "recording" not in state:
            state["recording"] = True
            GLOBAL_TIMERS.record(device)
        return push(self, hook)

    def traced_hooked(feeder, frames, dev):
        state["counters1"] = dict(GLOBAL_TIMERS.counters)
        t0 = time.perf_counter()
        out = traced(feeder, frames, dev)
        state["traced"] = (t0, time.perf_counter())
        if device is not None:
            state["log"] = GLOBAL_TIMERS.stop()
        return out

    def reduce_hooked(events, frames, names):
        events = list(events)
        state["events"] = [(e.name(), str(e.device_type()), e.start_ns(), e.duration_ns(),
                            bool(getattr(e, "is_user_annotation", lambda: False)()))
                           for e in events]
        return reduce(events, frames, names)

    harness.Record, harness.Feeder.push = Record, push_hooked
    trace_mod.traced, trace_mod.reduce = traced_hooked, reduce_hooked


def summarize(state: dict, process_start: float) -> dict:
    """The span metrics, breakdown, coverage and clock check of a hooked run."""
    from vilbench import harness, spans as span_mod
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    rec = state["rec"]
    lo = process_start + rec.setup_s
    hi = lo + rec.window_s
    c0, c1 = state.get("counters0", {}), state.get("counters1", {})
    out = dict(scans_per_s=rec.delivered / rec.window_s, delivered=rec.delivered,
               counters=dict(GLOBAL_TIMERS.counters),
               counters_in_window={k: v - c0.get(k, 0) for k, v in c1.items()})
    log = state.get("log")
    if log is not None:
        rec.spans = span_mod.in_window(log.spans, lo, hi)
        rec.span_window = (lo, hi)
        pushes = {s.sid for s in rec.spans if s.name == "push_scan"}
        stages = sum(s.t1 - s.t0 for s in rec.spans if s.parent in pushes)
        by_span = {}
        for name in sorted({s.name for s in rec.spans}):
            mine = [s for s in rec.spans if s.name == name]
            dev_s = span_mod.device_seconds(mine, name)
            by_span[name] = dict(n=len(mine),
                                 host_ms=1e3 * sum(s.t1 - s.t0 for s in mine) / rec.delivered,
                                 device_ms=None if dev_s is None else 1e3 * dev_s / rec.delivered)
        out.update(spans=len(rec.spans), dropped=log.dropped,
                   stages_of_push=stages / sum(rec.call_s), by_span_per_scan=by_span,
                   window_breakdown=span_mod.window_breakdown(rec.spans, lo, hi))
        a, b = state["traced"]
        out["profiler_clock"] = span_mod.profiler_coverage(
            state.get("events", []), span_mod.in_window(log.spans, a, b))
    out["metrics"] = {}
    for name in SPAN_METRICS:
        v = harness.reader(ROOT, "layer_metrics", name)(rec)
        if v is not None:
            out["metrics"][name] = v
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="kitti_lidar.city_laps")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "window_spans"))
    args = ap.parse_args()

    import torch

    from vilbench import harness

    state: dict = {}
    install_hooks(state, torch.device("cuda") if args.record else None)
    rc = harness.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"], PROCESS_START, ROOT)
    if rc:
        return rc
    out = dict(workload=args.workload, seed=args.seed, record=args.record,
               device=torch.cuda.get_device_name(0), **summarize(state, PROCESS_START))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}_{args.seed}_{args.record}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
