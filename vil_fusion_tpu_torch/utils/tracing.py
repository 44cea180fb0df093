"""Structured stage timing (the reference's TicToc, done properly).

The reference wraps every stage in wall-clock `TicToc` stopwatches and logs
via ROS_DEBUG (SURVEY §5 "Tracing"). Here: a process-wide registry of named
timers with mean/median/p90/max/count and optional JSON dump — usable around
device work (call torch.cuda.synchronize() inside the timed block when the
timer must cover kernel time rather than the enqueue).

Percentiles exist because first-call costs (the kernels' build at first use,
allocator warm-up) land inside whatever timer wraps them: a mean over a
replay is polluted by them and decomposes nothing, while p50/p90 give the
steady-state cost. Samples are kept in a bounded
reservoir (`MAX_SAMPLES`, keep-first + wraparound-overwrite) so a million-
frame replay cannot grow memory unboundedly.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

MAX_SAMPLES = 8192


class StageTimers:
    def __init__(self):
        self.stats = defaultdict(
            lambda: {"n": 0, "total": 0.0, "max": 0.0, "samples": []})

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s["n"] += 1
            s["total"] += dt
            s["max"] = max(s["max"], dt)
            if len(s["samples"]) < MAX_SAMPLES:
                s["samples"].append(dt)
            else:  # overwrite cyclically; early compile samples age out
                s["samples"][s["n"] % MAX_SAMPLES] = dt

    def summary(self) -> dict:
        out = {}
        for k, v in self.stats.items():
            sm = sorted(v["samples"])
            n = len(sm)
            out[k] = {
                "n": v["n"],
                "mean_ms": 1e3 * v["total"] / max(v["n"], 1),
                "p50_ms": 1e3 * sm[n // 2] if n else 0.0,
                "p90_ms": 1e3 * sm[min(n - 1, (9 * n) // 10)] if n else 0.0,
                "max_ms": 1e3 * v["max"],
                "total_s": v["total"],
            }
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2, sort_keys=True)

    def reset(self):
        self.stats.clear()


GLOBAL_TIMERS = StageTimers()
timed = GLOBAL_TIMERS.timed
