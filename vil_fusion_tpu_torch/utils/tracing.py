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
reservoir (`MAX_SAMPLES`, keep-first, then overwrite the oldest) so a
million-frame replay cannot grow memory unboundedly. (The reference writes
sample n to slot n % MAX_SAMPLES after counting it, which overwrites slot 1
first and keeps the very first sample a whole extra cycle.)
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch

MAX_SAMPLES = 8192


class StageTimers:
    def __init__(self):
        self.stats = defaultdict(
            lambda: {"n": 0, "total": 0.0, "max": 0.0, "samples": []})

    @contextlib.contextmanager
    def timed(self, name: str):
        """Time the block on the host clock; under torch.profiler the block is
        also a range of that name, so a trace can count the kernels each
        stage launches (tools/profile_port.py)."""
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s["n"] += 1
            s["total"] += dt
            s["max"] = max(s["max"], dt)
            if len(s["samples"]) < MAX_SAMPLES:
                s["samples"].append(dt)
            else:  # overwrite cyclically, oldest first: sample n (1-based)
                # goes to slot (n - 1) % MAX_SAMPLES, so the first samples
                # (the kernels' build at first use) age out first
                s["samples"][(s["n"] - 1) % MAX_SAMPLES] = dt

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
