"""The port's sensor transport (vil_fusion_tpu_torch/runtime/transport.py)
against the JAX package's: the wire layout bit for bit (each package
unpacks the other's buffers), order and values through the ring, a
producer error reaching the consumer, and replay backpressure."""
import time

import numpy as np
import pytest

from vil_fusion_tpu.runtime import transport as jtransport
from vil_fusion_tpu_torch.runtime import transport


def _example_events():
    rng = np.random.default_rng(3)
    evs = []
    t = 0.0
    for i in range(40):
        t += 0.005
        evs.append(("imu", t, rng.normal(size=3), rng.normal(size=3)))
        if i % 4 == 0:
            evs.append(("scan", t, rng.normal(size=(128, 3)).astype(np.float32),
                        rng.random(128) > 0.1))
        if i % 4 == 1:
            img = rng.random((24, 32)).astype(np.float32)
            if i % 8 == 1:
                evs.append(("image", t, img, rng.random((24, 32)) > 0.5))
            else:
                evs.append(("image", t, (img * 255).astype(np.uint8)))
    return evs


def _dtype_events():
    """One event a dtype code (f4 f8 b1 i4 i8 u1), with empty and odd
    lengths so every padding case of the 8-byte alignment shows."""
    rng = np.random.default_rng(4)
    arrs = [rng.normal(size=(3, 5)).astype(np.float32), rng.normal(size=7),
            rng.random(13) > 0.5, rng.integers(-9, 9, (2, 3)).astype(np.int32),
            rng.integers(-9, 9, 3).astype(np.int64), rng.integers(0, 255, (5, 3)).astype(np.uint8),
            np.zeros((0, 3), np.float32), np.ones(1, bool)]
    return [("scan", 0.5 + k, a, arrs[(k + 1) % len(arrs)]) for k, a in enumerate(arrs)]


def _equal(got, want):
    assert got[0] == want[0] and got[1] == want[1] and len(got) == len(want)
    for a, b in zip(got[2:], want[2:]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("events", [_example_events, _dtype_events])
def test_pack_event_bytes_equal_reference(events):
    for ev in events():
        buf = transport.pack_event(ev)
        ref = jtransport.pack_event(ev)
        assert buf.dtype == ref.dtype == np.uint8 and buf.tobytes() == ref.tobytes()
        assert len(buf) % 8 == 0
        _equal(transport.unpack_event(ev[1], ref), ev)  # the reference's buffer here
        _equal(jtransport.unpack_event(ev[1], buf), ev)  # and this package's there


def test_sensor_bus_preserves_order_and_values():
    evs = _example_events()
    # tiny capacity so producer backpressure (no drop-oldest) is exercised
    bus = transport.SensorBus(slot_bytes=1 << 16, capacity=4).start(iter(evs))
    got = list(bus.subscribe())
    bus.stop()
    assert bus.topic.dropped() == 0, "replay transport must never drop"
    assert len(got) == len(evs) == bus.delivered
    for g, e in zip(got, evs):
        _equal(g, e)
    assert bus.lead_max <= 3  # capacity - 1: the producer waits there


def test_transport_propagates_producer_error():
    def bad_iter():
        yield ("imu", 0.1, np.zeros(3), np.zeros(3))
        raise IOError("corrupt file")

    got = []
    with pytest.raises(IOError, match="corrupt file"):
        for ev in transport.prefetch(bad_iter()):
            got.append(ev)
    assert [e[0] for e in got] == ["imu"]  # events before the error still arrive


def test_slow_consumer_loses_no_event():
    """capacity=4 and a consumer slower than the producer: the producer
    waits at capacity - 1 pending events instead of letting drop-oldest
    fire; every event arrives, in order."""
    evs = [("imu", 0.01 * i, np.full(3, i, np.float64), np.zeros(3)) for i in range(60)]
    bus = transport.SensorBus(slot_bytes=1 << 12, capacity=4).start(iter(evs))
    got = []
    for ev in bus.subscribe():
        got.append(ev)
        assert bus.topic.pending() <= 3
        time.sleep(0.002)
    bus.stop()
    assert bus.topic.dropped() == 0
    assert [e[1] for e in got] == [e[1] for e in evs]
    assert [int(e[2][0]) for e in got] == list(range(60))
    assert bus.lead_max == 3  # the producer stayed ahead of the slow consumer


def test_prefetch_max_events():
    evs = _example_events()
    got = list(transport.prefetch(iter(evs), slot_bytes=1 << 16, capacity=8, max_events=7))
    assert len(got) == 7
    for g, e in zip(got, evs):
        _equal(g, e)
