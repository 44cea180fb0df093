"""The program's span log reduced to what the span metrics read.

With recording on (vil_fusion_tpu_torch/utils/tracing.py:
`GLOBAL_TIMERS.record(device)` ... `stop()`), every span of the program
carries its host interval [t0, t1] on time.perf_counter and, on a card, its
device interval [d0, d1] on the same clock: from the event at its entry to
the event at its exit, so it covers the kernels the span enqueued and any
launch gaps between them. A run's `spans` are the log's spans inside the
measured window and `span_window` the window's (start, end) on that clock.

A device interval is no measure of busy time: a span that enqueues nothing
while the device waits for the host (the quantization, a poll) has one as
long as its host interval. The device is known busy where an event is
pending: from its record on the host (a span's t0, its t1) until the device
reaches it (d0, d1), the device is working through what was enqueued before
it. Their union is a lower bound of the busy time (work that ends before
the next event is recorded is not seen; the spans around each graph replay
and host wait keep that small), so the idle share read from it is an upper
bound.

From them, with trace.py's own interval arithmetic: the window's device
idle share, device and host seconds by span, the idle gaps charged to the
innermost span open on the host over each gap, and the ms by span of the
slowest scans beside the mean scan's. `profiler_coverage` puts the spans'
device times on torch.profiler's clock (a span is also a profiler range of
its name) and measures the share of the profiled device time they cover.
"""
from __future__ import annotations

import math
from collections import defaultdict

from vilbench.trace import WINDOW, charge_gaps, gaps, union_seconds


def in_window(spans, lo: float, hi: float) -> list:
    """The spans that start and end inside [lo, hi]."""
    return [s for s in spans if lo <= s.t0 and s.t1 <= hi]


def self_seconds(spans) -> dict:
    """Each span's self time by `sid`: its host duration less its children's
    (a thread's spans nest, so its children never overlap)."""
    out = {s.sid: s.t1 - s.t0 for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.t1 - s.t0
    return out


def device_intervals(spans) -> list:
    return [(s.d0, s.d1) for s in spans if s.d0 is not None and s.d1 is not None]


def pending_intervals(spans) -> list:
    """(record on the host, reached by the device) of every timing event
    the device reached after it was recorded: the device was busy then."""
    out = []
    for s in spans:
        if s.d0 is not None and s.d0 > s.t0:
            out.append((s.t0, s.d0))
        if s.d1 is not None and s.d1 > s.t1:
            out.append((s.t1, s.d1))
    return out


def idle_pct(spans, lo: float, hi: float):
    """Share (%) of [lo, hi] in which no span's timing event is pending
    (module docstring: an upper bound of the device's idle share); None
    without device timing."""
    iv = pending_intervals(spans)
    if not iv or hi <= lo:
        return None
    return 100.0 * (1.0 - union_seconds(iv, lo, hi) / (hi - lo))


def device_seconds(spans, name: str):
    """Summed device intervals of the spans named `name`; None without
    device timing."""
    iv = device_intervals(s for s in spans if s.name == name)
    return sum(e - s for s, e in iv) if iv else None


def window_breakdown(spans, lo: float, hi: float, tail: float = 0.05) -> dict:
    """The window's idle gaps (no span's timing event pending) charged to
    the innermost span open on the host over each piece; and the
    host ms by span (self time) of the mean request and of the slowest
    `tail` of requests (by their top-level spans' summed duration), the
    spans ordered by how much longer they run in the slow ones."""
    idle = charge_gaps(gaps(pending_intervals(spans), lo, hi),
                       [(s.name, s.t0, s.t1) for s in spans], lo, hi)
    own = self_seconds(spans)
    by_req: dict = defaultdict(lambda: defaultdict(float))
    total: dict = defaultdict(float)
    for s in spans:
        if s.request is None:
            continue
        by_req[s.request][s.name] += own[s.sid]
        if s.parent is None:
            total[s.request] += s.t1 - s.t0
    reqs = sorted(total, key=total.get)
    slow = reqs[len(reqs) - max(1, math.ceil(tail * len(reqs))):] if reqs else []
    names = {n for r in reqs for n in by_req[r]}

    def mean_ms(group):
        return {n: 1e3 * sum(by_req[r][n] for r in group) / len(group) for n in names}

    rows = []
    if reqs:
        mean, slow_ms = mean_ms(reqs), mean_ms(slow)
        rows = sorted(([n, mean[n], slow_ms[n]] for n in names), key=lambda r: r[1] - r[2])
    return {"idle_s": sum(idle.values()),
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1]),
            "requests": len(reqs),
            "mean_ms": 1e3 * sum(total.values()) / len(reqs) if reqs else None,
            "tail_ms": 1e3 * sum(total[r] for r in slow) / len(slow) if slow else None,
            "by_span_ms": rows}  # [name, mean request, slowest requests]


def profiler_coverage(events, spans) -> dict:
    """The spans' device intervals on the profiler's clock, against its
    device operations. `events`: (name, device_type, start_ns, duration_ns,
    is_annotation) of kineto's events; `spans`: those recorded inside the
    profiled range. The clock offset is the median, over the spans matched
    to their profiler range (by name, in order), of range start less the
    span's t0. Returns the offset and the offsets' spread; the share of the
    traced range's device-operation time (the union of the operations) that
    lies inside a span's device interval (`share`) and inside a pending
    event's interval (`busy_share`); and the range's busy seconds by each
    account (`profiler_busy_s` from the operations, `busy_s` from the
    pending events)."""
    names = {s.name for s in spans}
    ranges, ops, window = defaultdict(list), [], None
    for name, dev, start, dur, annotation in events:
        a, b = start * 1e-9, (start + dur) * 1e-9
        if not str(dev).endswith("CUDA"):
            if name == WINDOW:
                window = (a, b)
            elif name in names:
                ranges[name].append(a)
        elif not annotation and name not in names and name != WINDOW:
            ops.append((a, b))
    if window is None:
        return {}
    lo, hi = window
    offsets = []
    for name, starts in ranges.items():
        starts = sorted(x for x in starts if lo <= x <= hi)
        mine = sorted(s.t0 for s in spans if s.name == name)
        if len(starts) == len(mine):
            offsets.extend(r - t for r, t in zip(starts, mine))
    if not offsets:
        return {"matched": 0}
    offsets.sort()
    off = offsets[len(offsets) // 2]
    busy = union_seconds(ops, lo, hi)
    pending = [(a + off, b + off) for a, b in pending_intervals(spans)]
    out = {"offset_s": off, "offset_spread_s": offsets[-1] - offsets[0],
           "matched": len(offsets), "profiler_busy_s": busy,
           "busy_s": union_seconds(pending, lo, hi)}
    for key, iv in (("share", [(a + off, b + off) for a, b in device_intervals(spans)]),
                    ("busy_share", pending)):
        # |ops & iv| = |ops| + |iv| - |ops | iv|
        both = busy + union_seconds(iv, lo, hi) - union_seconds(ops + iv, lo, hi)
        out[key] = both / busy if busy > 0 else None
    return out
