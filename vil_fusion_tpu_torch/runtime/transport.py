"""Sensor transport over the native ring bus: the deployment data path.

Port of vil_fusion_tpu/runtime/transport.py, with the same wire layout bit
for bit (a buffer packed by either package unpacks in the other).

The reference runs its four stages as separate ROS processes wired by topic
transport (launch/run_fusion.launch:13-36; feature_tracker subscribes IMAGE_
TOPIC, laserMapping subscribes /laser_cloud_*, vins_estimator subscribes
/imu0 — all through roscore's pub/sub). This counterpart keeps compute in
one process (one device stream) but moves sensor IO to a producer
thread that decodes dataset files ahead of time and ships each event through
the native lock-free SPSC ring (native/src/ringbus.cpp) — disk reads, PNG
decode, and .bin parsing overlap with device compute instead of serializing
with it. The bus counts what the replay's layer metrics read: events
delivered, the consumer's seconds spent waiting for the producer, and the
producer's lead (events pending in the ring when the consumer takes one).

One `events` topic (not three) keeps the global time-ordering of the merged
sensor streams intact — SPSC FIFO is exactly the ordering guarantee the
replay loop needs; per-sensor topics would force a re-merge at the consumer.

Producer-side backpressure: the ring's drop-oldest semantics are right for
live sensors but wrong for dataset replay (every frame must arrive), so the
producer spins politely while the ring is full instead of overwriting.
"""
from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

import numpy as np

from vil_fusion_tpu_torch.runtime import native

_KIND_CODES = {"imu": 0, "image": 1, "scan": 2}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}
_DTYPE_CODES = {"f4": 0, "f8": 1, "b1": 2, "i4": 3, "i8": 4, "u1": 5}
_DTYPE_NAMES = {v: np.dtype(k) for k, v in _DTYPE_CODES.items()}


def pack_event(ev: tuple) -> np.ndarray:
    """Serialize ("kind", t, *arrays) to a flat uint8 buffer.
    Layout: int64[kind, n_arrays] then per array int64[dtype, ndim, *shape]
    followed by its raw bytes (8-byte aligned)."""
    kind, arrays = ev[0], ev[2:]
    parts = [np.array([_KIND_CODES[kind], len(arrays)], np.int64).tobytes()]
    for a in arrays:
        a = np.ascontiguousarray(a)
        code = _DTYPE_CODES[a.dtype.str[1:]]
        parts.append(np.array([code, a.ndim, *a.shape], np.int64).tobytes())
        raw = a.tobytes()
        pad = (-len(raw)) % 8
        parts.append(raw + b"\x00" * pad)
    return np.frombuffer(b"".join(parts), np.uint8)


def unpack_event(t: float, buf: np.ndarray) -> tuple:
    """Inverse of pack_event; returns ("kind", t, *arrays), writable (the
    CPU pipeline wraps them in tensors without a copy)."""
    data = bytearray(buf)
    off = 0
    kind_code, n_arrays = np.frombuffer(data, np.int64, 2, off)
    off += 16
    arrays = []
    for _ in range(int(n_arrays)):
        code, ndim = np.frombuffer(data, np.int64, 2, off)
        off += 16
        shape = tuple(int(s) for s in np.frombuffer(data, np.int64, int(ndim), off))
        off += 8 * int(ndim)
        dt = _DTYPE_NAMES[int(code)]
        n = int(np.prod(shape)) if shape else 1
        arrays.append(np.frombuffer(data, dt, n, off).reshape(shape))
        off += ((n * dt.itemsize + 7) // 8) * 8
    return (_KIND_NAMES[int(kind_code)], t, *arrays)


class SensorBus:
    """Producer thread decoding an event iterator into the ring; consumer
    generator yielding the events back in order. slot_bytes must cover the
    largest event (a KITTI 1226x370 float32 image ~1.9 MB; default 8 MB
    leaves headroom for HDL-64 scans and masks)."""

    def __init__(self, slot_bytes: int = 8 << 20, capacity: int = 32):
        self.topic = native.Topic("sensor_events", slot_bytes, capacity)
        self.capacity = capacity
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self.delivered = 0  # events handed to the consumer
        self.wait_s = 0.0  # consumer seconds spent waiting on an empty ring
        self.lead_sum = 0  # sum and max over deliveries of the events pending
        self.lead_max = 0

    def start(self, events: Iterator[tuple],
              max_events: Optional[int] = None) -> "SensorBus":
        def run():
            try:
                n = 0
                for ev in events:
                    if self._done.is_set():  # stop(): the consumer has gone
                        return
                    buf = pack_event(ev)
                    # replay backpressure: never let drop-oldest fire
                    while self.topic.pending() >= self.capacity - 1:
                        if self._done.is_set():
                            return
                        time.sleep(1e-4)
                    self.topic.publish(ev[1], buf)
                    n += 1
                    if max_events and n >= max_events:
                        break
            except BaseException as e:  # surface decode errors to consumer
                self._error = e
            finally:
                self._done.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="sensor-bus-producer")
        self._thread.start()
        return self

    def subscribe(self) -> Iterator[tuple]:
        while True:
            lead = self.topic.pending()
            msg = self.topic.poll()
            if msg is None:
                if self._done.is_set() and self.topic.pending() == 0:
                    break
                t0 = time.perf_counter()
                time.sleep(1e-4)
                self.wait_s += time.perf_counter() - t0
                continue
            self.delivered += 1
            self.lead_sum += lead
            self.lead_max = max(self.lead_max, lead)
            yield unpack_event(*msg)
        if self._error is not None:
            raise self._error

    def stop(self):
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def prefetch(events: Iterator[tuple], slot_bytes: int = 8 << 20,
             capacity: int = 32,
             max_events: Optional[int] = None) -> Iterator[tuple]:
    """Wrap an event iterator so decode runs in a producer thread and events
    arrive through the native ring bus."""
    bus = SensorBus(slot_bytes, capacity).start(events, max_events)
    try:
        yield from bus.subscribe()
    finally:
        bus.stop()
