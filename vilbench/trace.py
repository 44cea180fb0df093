"""The traced sub-window: torch.profiler over a few frames after the
measured window, reduced to what the device metrics read.

The profiler's raw events (kineto) give each device operation's interval
(kernels, copies, sets: every CUDA event that is no annotation) and each
host range's (the harness's "vilbench.*" ranges, and the pipeline's stage
ranges, which utils/tracing.py opens under the profiler). From them:
busy seconds (the union of the device intervals inside the traced range),
kernel seconds and counts by name, host launches (kernel launches and CUDA
graph launches), and the idle gaps of the device timeline charged to the
innermost host range open at the gap's middle.
"""
from __future__ import annotations

from collections import defaultdict

WINDOW = "vilbench.traced"
FRAME = "vilbench.frame"
STAGE = "vilbench.trace"  # knn_cuda.launch_stage of the traced frames
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
               "cudaGraphLaunch")


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of `intervals` ((start, end)
    pairs, any order)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if e <= at:
            continue
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def host_segments(ranges, lo: float, hi: float) -> list:
    """[lo, hi] cut into (start, end, name) segments, `name` the innermost
    host range (name, start, end) open there (the one opened last), None
    where none is."""
    bounds = sorted({lo, hi} | {t for _, a, b in ranges for t in (a, b) if lo < t < hi})
    ranges = sorted(ranges, key=lambda r: r[1])
    out, open_, k = [], [], 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        mid = 0.5 * (a + b)
        while k < len(ranges) and ranges[k][1] <= mid:
            open_.append(ranges[k])
            k += 1
        open_ = [r for r in open_ if r[2] > mid]
        out.append((a, b, open_[-1][0] if open_ else None))
    return out


def charge_gaps(gap_list, ranges, lo: float, hi: float) -> dict:
    """Seconds of the gaps charged, piece by piece, to the innermost host
    range open over each piece ("host (no range)" where none is)."""
    segs = host_segments(ranges, lo, hi)
    out: dict = defaultdict(float)
    j = 0
    for s, e in sorted(gap_list):
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            a, b, name = segs[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name or "host (no range)"] += part
            k += 1
    return dict(out)


class Summary:
    """The reduced trace of `frames` frames."""

    def __init__(self, frames: int):
        self.frames = frames
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: dict = {}  # name -> [count, seconds]
        self.launches = 0
        self.knn_calls: dict = {}  # (nq, nd, k) -> calls, K1 and K2 (wrapper counts)
        self.idle_by_host: dict = {}

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v[1]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def reduce(events, frames: int, range_names) -> Summary:
    """A Summary from kineto events (objects with name(), device_type(),
    start_ns(), duration_ns(), is_user_annotation())."""
    out = Summary(frames)
    dev, ranges, window = [], [], None
    for ev in events:
        name = ev.name()
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if str(ev.device_type()).endswith("CUDA"):
            annotation = getattr(ev, "is_user_annotation", None)
            if (annotation is not None and annotation()) or name in range_names \
                    or name == WINDOW:
                continue
            dev.append((s, e, name))
        elif name == WINDOW:
            window = (s, e)
        elif name in LAUNCH_KEYS:
            out.launches += 1
        elif name in range_names:
            ranges.append((name, s, e))
    if window is None:
        raise RuntimeError("the trace has no traced-window range")
    lo, hi = window
    out.window_s = hi - lo
    inside = [(s, e) for s, e, _ in dev if e > lo and s < hi]
    out.busy_s = union_seconds(inside, lo, hi)
    for s, e, name in dev:
        k = out.kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += e - s
    out.idle_by_host = charge_gaps(gaps(inside, lo, hi), ranges, lo, hi)
    return out


def traced(feeder, frames: int, dev) -> Summary:
    """Push `frames` more frames under torch.profiler and reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    on_card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    calls0 = {w: dict(w.calls_by_stage.get(STAGE, {})) for w in (kc.knn_grouped, kc.knn_exact)}
    with kc.launch_stage(STAGE):
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                for _ in range(frames):
                    with record_function(FRAME):
                        feeder.push()
                if on_card:
                    torch.cuda.synchronize(dev)
    names = set(GLOBAL_TIMERS.stats) | {FRAME}
    out = reduce(prof.profiler.kineto_results.events(), frames, names)
    for w in (kc.knn_grouped, kc.knn_exact):
        for shape, n in w.calls_by_stage.get(STAGE, {}).items():
            if len(shape) == 3:  # unbatched (nq, nd, k)
                got = n - calls0[w].get(shape, 0)
                if got:
                    out.knn_calls[shape] = out.knn_calls.get(shape, 0) + got
    return out
