"""Structured stage timing (the reference's TicToc, done properly), with an
optional span log and device timing.

The reference wraps every stage in wall-clock `TicToc` stopwatches and logs
via ROS_DEBUG (SURVEY §5 "Tracing"). Here: a process-wide registry of named
timers with mean/median/p90/max/count, and of counters. `timed(name)` is the
one API; its span times the block on the host clock (the enqueue of device
work, plus any wait inside the block).

Percentiles exist because first-call costs (the kernels' build at first use,
allocator warm-up) land inside whatever timer wraps them: a mean over a
replay is polluted by them and decomposes nothing, while p50/p90 give the
steady-state cost. Samples are kept in a bounded
reservoir (`MAX_SAMPLES`, keep-first, then overwrite the oldest) so a
million-frame replay cannot grow memory unboundedly. (The reference writes
sample n to slot n % MAX_SAMPLES after counting it, which overwrites slot 1
first and keeps the very first sample a whole extra cycle.)

Recording (`record(device)` ... `stop()`, off by default) also keeps every
span in a bounded log (`LOG_CAPACITY`; later spans are counted as dropped):
its name, its parent (a per-thread stack, so a worker thread nests its own
spans), the request id the pipeline set (`request(rid)`: the sequence
number of the scan or frame), and its host start and end on
`time.perf_counter`. With a CUDA device each span also records a timing
event on its thread's current stream at entry, and one on the same stream at
exit (none while the stream is being captured into a graph). Nothing waits while recording:
`stop()` synchronizes once and resolves the events against one anchor taken
at `record`, so a span's device interval [d0, d1] sits on the host clock:
from the moment the device reached the span's entry to the moment it
finished everything enqueued before the span's exit, launch gaps included.
Off, a span costs two clock reads and one locked update, as before.

Under torch.profiler a span is also a range of its name
(`torch.profiler.record_function`, entered only while a profiler runs), so a
trace can count the kernels each stage launches (tools/profile_port.py) and
put the spans' host stamps on the profiler's clock.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SAMPLES = 8192
LOG_CAPACITY = 1 << 17  # spans a recording keeps; a 30-s lidar window makes ~20,000

_NO_RANGE = contextlib.nullcontext()


class Span(NamedTuple):
    """A span of the log. Host times are time.perf_counter seconds; d0, d1
    the device interval on the same clock (None without device timing or
    while the stream was captured). `parent` is the enclosing span's `sid`
    on the same thread."""
    name: str
    sid: int
    parent: Optional[int]
    request: Optional[int]
    thread: int
    t0: float
    t1: float
    d0: Optional[float] = None
    d1: Optional[float] = None


class SpanLog(NamedTuple):
    """What `stop()` returns: the spans in order of their start and the
    count of spans the full log dropped."""
    spans: list
    dropped: int


class _Recording:
    def __init__(self, device: Optional[torch.device], capacity: int, pool: list):
        self.device = device
        self.timing = device is not None and device.type == "cuda"
        self.capacity = capacity
        self.pool = pool  # spare timing events, shared across recordings
        # [name, sid, parent, request, thread, t0, t1, ev0, ev1]; while the
        # span is open, ev1's slot holds the stream its events go to
        self.log: list = []
        self.taken = 0  # log slots given out (closed or still open)
        self.dropped = 0
        self.anchor = None
        self.t_anchor = 0.0

    def stream(self):
        """The current stream of the recording's device, or None without
        device timing or while it is captured."""
        if not self.timing or torch.cuda.is_current_stream_capturing():
            return None
        return torch.cuda.current_stream(self.device)

    def event(self, stream):
        """A timing event recorded on `stream` (None for None)."""
        if stream is None:
            return None
        ev = self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def device_time(self, ev) -> Optional[float]:
        return None if ev is None else self.t_anchor + 1e-3 * self.anchor.elapsed_time(ev)

    def resolve(self) -> list:
        """The log as Spans (its events given back to the pool)."""
        out = []
        for name, sid, parent, request, thread, t0, t1, e0, e1 in self.log:
            d0, d1 = self.device_time(e0), self.device_time(e1)
            self.pool.extend(e for e in (e0, e1) if e is not None)
            out.append(Span(name, sid, parent, request, thread, t0, t1, d0, d1))
        out.sort(key=lambda s: s.t0)
        return out


class _Request:
    __slots__ = ("tls", "rid", "prev")

    def __init__(self, tls, rid):
        self.tls, self.rid = tls, rid

    def __enter__(self):
        self.prev = getattr(self.tls, "request", None)
        self.tls.request = self.rid

    def __exit__(self, *exc):
        self.tls.request = self.prev


class StageTimers:
    def __init__(self):
        self.stats = defaultdict(
            lambda: {"n": 0, "total": 0.0, "max": 0.0, "samples": []})
        self.counters: dict = defaultdict(int)
        # a pipeline's worker thread times its stage too
        self._lock = threading.Lock()
        self._tls = threading.local()  # the span stack and request id of a thread
        self._rec: Optional[_Recording] = None
        self._pool: list = []

    # -- recording ------------------------------------------------------
    def record(self, device=None) -> None:
        """Start keeping spans (host only, or with device timing on a CUDA
        `device`). Anchors the device clock: synchronize, record an event,
        synchronize, read the host clock."""
        dev = None if device is None else torch.device(device)
        rec = _Recording(dev, LOG_CAPACITY, self._pool)
        if rec.timing:
            torch.cuda.synchronize(dev)
            rec.anchor = torch.cuda.Event(enable_timing=True)
            rec.anchor.record(torch.cuda.current_stream(dev))
            torch.cuda.synchronize(dev)
        rec.t_anchor = time.perf_counter()
        self._rec = rec

    def stop(self) -> SpanLog:
        """Stop recording; synchronize and return the log. Spans still open
        are not in it."""
        rec, self._rec = self._rec, None
        if rec is None:
            return SpanLog([], 0)
        if rec.timing:
            torch.cuda.synchronize(rec.device)
        with self._lock:
            spans = rec.resolve()
        return SpanLog(spans, rec.dropped)

    def request(self, rid):
        """Context: spans opened on this thread inside it carry request id
        `rid`."""
        return _Request(self._tls, rid)

    def _open(self, rec: _Recording):
        with self._lock:
            if rec.taken >= rec.capacity:
                rec.dropped += 1
                return None
            rec.taken += 1
            sid = rec.taken
        tls = self._tls
        stack = tls.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        stack.append(sid)
        stream = rec.stream()
        return [None, sid, parent, getattr(tls, "request", None), threading.get_ident(),
                0.0, 0.0, rec.event(stream), stream]

    # -- spans ----------------------------------------------------------
    @contextlib.contextmanager
    def timed(self, name: str):
        """Time the block on the host clock as stage `name`."""
        rec = self._rec
        entry = self._open(rec) if rec is not None else None
        t0 = time.perf_counter()
        try:
            with (torch.profiler.record_function(name)
                  if _autograd_profiler._is_profiler_enabled else _NO_RANGE):
                yield
        finally:
            t1 = time.perf_counter()
            if entry is not None:
                entry[0], entry[5], entry[6], entry[8] = name, t0, t1, rec.event(entry[8])
                self._tls.stack.pop()
            dt = t1 - t0
            with self._lock:
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
                if entry is not None:
                    rec.log.append(entry)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name` (host counts: no device read)."""
        with self._lock:
            self.counters[name] += n

    def summary(self) -> dict:
        out = {}
        with self._lock:
            items = [(k, dict(v, samples=sorted(v["samples"]))) for k, v in self.stats.items()]
        for k, v in items:
            sm = v["samples"]
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

    def reset(self):
        with self._lock:
            self.stats.clear()
            self.counters.clear()


GLOBAL_TIMERS = StageTimers()
