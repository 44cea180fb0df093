"""The port's stage timers and span log (utils/tracing.py): the bounded
sample reservoir overwrites its oldest sample first; recorded spans carry
their parent, request id and self time on each thread; recording off makes
no event and keeps no log; device times sit on the host clock through one
anchor; a small LiDAR pipeline opens its spans with the expected counts,
and global fusion counts what its capacities drop. The last test needs a
card: a span's device interval against CUDA events, and a host wait between
two device spans charged as idle to the span open over it."""
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from vil_fusion_tpu_torch.models import global_fusion as gf
from vil_fusion_tpu_torch.runtime import sim as tsim
from vil_fusion_tpu_torch.runtime.config import RigConfig
from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
from vil_fusion_tpu_torch.utils import tracing
from vilbench import spans as span_mod


def test_reservoir_overwrites_oldest_first(monkeypatch):
    """With room for 4 samples, samples 1-4 fill the slots in order and
    sample n > 4 replaces sample n - 4: slot (n - 1) % 4. (The reference
    writes slot n % 4, so its fifth sample replaced the second and the first
    stayed a whole extra cycle.) n, total and max count every sample."""
    monkeypatch.setattr(tracing, "MAX_SAMPLES", 4)
    timers = tracing.StageTimers()
    values = iter([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0])
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: 0.0)
    expected = {5: [5.0, 2.0, 3.0, 4.0], 6: [5.0, 6.0, 3.0, 4.0], 8: [5.0, 6.0, 7.0, 8.0],
                9: [9.0, 6.0, 7.0, 8.0]}
    for n in range(1, 10):
        v = next(values)
        monkeypatch.setattr(tracing.time, "perf_counter", iter([0.0, v]).__next__)
        with timers.timed("stage"):
            pass
        s = timers.stats["stage"]
        if n <= 4:
            assert s["samples"] == [1.0, 2.0, 3.0, 4.0][:n]
        elif n in expected:
            assert s["samples"] == expected[n], (n, s["samples"])
    assert s["n"] == 9 and s["total"] == 45.0 and s["max"] == 9.0
    summ = timers.summary()["stage"]
    assert summ["n"] == 9 and summ["p50_ms"] == 8000.0


def test_nested_spans_on_two_threads(monkeypatch):
    """Two threads nest spans at once (both inside "inner" at a barrier):
    each span's parent is the enclosing span of its own thread, each carries
    its thread's request id, and a span's self time is its duration less
    its children's. A span outside any request carries None."""
    clock = itertools.count()
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: float(next(clock)))
    timers = tracing.StageTimers()
    timers.record()
    barrier = threading.Barrier(2, timeout=30)

    def work(rid):
        with timers.request(rid):
            with timers.timed("outer"):
                with timers.timed("inner"):
                    barrier.wait()
                with timers.timed("inner2"):
                    pass

    threads = [threading.Thread(target=work, args=(rid,)) for rid in (7, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    with timers.timed("loose"):
        pass
    log = timers.stop()
    assert log.dropped == 0 and len(log.spans) == 7
    assert [s.t0 for s in log.spans] == sorted(s.t0 for s in log.spans)
    by_sid = {s.sid: s for s in log.spans}
    own = span_mod.self_seconds(log.spans)
    for rid in (7, 8):
        mine = {s.name: s for s in log.spans if s.request == rid}
        assert set(mine) == {"outer", "inner", "inner2"}
        outer = mine["outer"]
        assert outer.parent is None
        assert mine["inner"].parent == mine["inner2"].parent == outer.sid
        assert len({s.thread for s in mine.values()}) == 1
        dur = {n: s.t1 - s.t0 for n, s in mine.items()}
        assert own[outer.sid] == dur["outer"] - dur["inner"] - dur["inner2"] > 0
        assert own[mine["inner"].sid] == dur["inner"]
        assert all(by_sid[s.parent].thread == s.thread for s in mine.values() if s.parent)
    loose = next(s for s in log.spans if s.name == "loose")
    assert loose.request is None and loose.parent is None
    assert timers.stats["outer"]["n"] == 2 and timers._rec is None


def test_recording_off_makes_no_event_and_no_log(monkeypatch):
    """Off (the default) a span updates its stage's aggregate and makes no
    CUDA event, no log entry and no profiler range; so does a host-only
    recording but for the log. Under torch.profiler a span is a range of
    its name."""
    def refuse(*a, **k):
        raise AssertionError("made while nothing asked for it")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    timers = tracing.StageTimers()
    for _ in range(3):
        with timers.timed("stage"):
            pass
    assert timers.stats["stage"]["n"] == 3 and timers._rec is None
    assert timers.stop() == tracing.SpanLog([], 0)
    timers.record()  # host only: a log, still no event
    with timers.timed("stage"):
        pass
    log = timers.stop()
    assert [(s.name, s.d0, s.d1) for s in log.spans] == [("stage", None, None)]
    with timers.timed("stage"):  # off again
        pass
    assert timers.stop().spans == [] and timers.stats["stage"]["n"] == 5
    monkeypatch.undo()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.timed("profiled_stage"):
            torch.ones(4).sum()
    assert any(e.name == "profiled_stage" for e in prof.events())


class _FakeEvent:
    """A timing event on a made-up device clock (ms): record() stamps the
    next reading."""
    clock: list = []

    def __init__(self, enable_timing=False):
        self.ms = None

    def record(self, stream=None):
        self.ms = _FakeEvent.clock.pop(0)

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_anchor_arithmetic_and_dropped_spans(monkeypatch):
    """Device stamps land on the host clock as t_anchor + (event - anchor):
    the anchor is recorded between two synchronizations, then the host
    clock is read. A full log counts the spans it drops (no events for
    them), and a span opened while the stream is captured has no device
    interval."""
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    host = iter([100.0, 100.5, 100.7, 101.0, 101.2, 101.5, 101.6, 102.0, 102.1]).__next__
    monkeypatch.setattr(tracing.time, "perf_counter", host)
    # anchor at 1000 ms; span a 1200 -> 1450 ms; span b 1500 -> 1900 ms
    _FakeEvent.clock = [1000.0, 1200.0, 1450.0, 1500.0, 1900.0]
    monkeypatch.setattr(tracing, "LOG_CAPACITY", 3)
    timers = tracing.StageTimers()
    timers.record("cuda")
    with timers.timed("a"):  # host 100.5 -> 100.7
        pass
    with timers.timed("b"):
        pass
    capturing[0] = True
    with timers.timed("captured"):
        pass
    with timers.timed("dropped"):  # the log holds 3
        pass
    log = timers.stop()
    assert log.dropped == 1 and _FakeEvent.clock == []
    a, b, c = log.spans
    assert (a.name, a.t0, a.t1) == ("a", 100.5, 100.7)
    assert a.d0 == pytest.approx(100.2) and a.d1 == pytest.approx(100.45)
    assert b.d0 == pytest.approx(100.5) and b.d1 == pytest.approx(100.9)
    assert c.name == "captured" and c.d0 is None and c.d1 is None
    assert timers.stats["dropped"]["n"] == 1  # the aggregate still counts it
    assert len(timers._pool) == 4  # the resolved events are kept for reuse


R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def test_lidar_pipeline_spans_and_dropped_keyframes():
    """Three quantized 16-ring scans through a LiDAR-only pipeline on the
    CPU with a 2-node graph and a keyframe every 5 cm: each scan's
    push_scan span holds scan_quantize, scan_upload, lidar_odometry (with
    its pose_read inside) and global_fusion, all under its request id; two keyframes run the keyframe
    program and the polls, the third is dropped and counted."""
    rig = RigConfig(
        name="synthetic-16", image_height=240, image_width=320,
        camera=dict(model_type="PINHOLE", projection_parameters=dict(
            fx=250.0, fy=250.0, cx=160.0, cy=120.0), distortion_parameters=dict(
            k1=0.0, k2=0.0, p1=0.0, p2=0.0)), q_ic=tsim.R_to_q(R_BC), t_ic=np.zeros(3),
        q_cl=tsim.R_to_q(R_BC.T), t_cl=np.zeros(3), n_scan=16, lidar_fov_up=15.0,
        lidar_fov_down=-25.0, lidar_min_range=1.0, lidar_max_range=80.0)
    pipe = VILFusionPipeline(
        rig, mode="lidar", scan_quant=0.0025, device="cpu",
        odom_overrides=dict(edge_map_cap=4096, surf_map_cap=8192, edge_cap=512, surf_cap=2048),
        gf_cfg=gf.GlobalFusionConfig(node_capacity=2, loop_capacity=2, cloud_capacity=256,
                                     submap_half_span=1, keyframe_dist=0.05))
    scene = tsim.RaycastScene()
    traj = tsim.Trajectory(tsim.TrajectoryConfig(speed=2.0))
    timers = tracing.GLOBAL_TIMERS
    dropped0 = timers.counters["global_fusion.keyframes_dropped"]
    timers.record()
    try:
        for i in range(3):
            t = 1.0 + 0.1 * i
            pts, val = tsim.simulate_lidar_scan(
                scene, traj.rotation(t), traj.position(t) + np.array([0, 0, 1.5]), n_scan=16,
                width=900, fov_up_deg=15.0, fov_down_deg=-25.0, range_noise=0.01, seed=i)
            pipe.push_scan(t, pts, val)
    finally:
        log = timers.stop()
    names = [s.name for s in log.spans]
    counts = {n: names.count(n) for n in set(names)}
    assert counts == {"push_scan": 3, "scan_quantize": 3, "scan_upload": 3,
                      "lidar_odometry": 3, "lidar_odometry.pose_read": 3, "global_fusion": 3,
                      "global_fusion.keyframe": 2, "global_fusion.poll": 2}, counts
    by_sid = {s.sid: s for s in log.spans}
    for s in log.spans:
        parent = by_sid[s.parent].name if s.parent else None
        assert parent == {"push_scan": None, "lidar_odometry.pose_read": "lidar_odometry",
                          "global_fusion.keyframe": "global_fusion",
                          "global_fusion.poll": "global_fusion"}.get(s.name, "push_scan"), s
    assert sorted({s.request for s in log.spans}) == [0, 1, 2]
    assert {s.name for s in log.spans if s.request == 2} >= {"scan_quantize", "lidar_odometry"}
    assert timers.counters["global_fusion.keyframes_dropped"] == dropped0 + 1
    assert pipe.fusion.n_kf == 2


def test_overwritten_loop_edges_are_counted():
    """Accepted loops past the loop store's capacity overwrite its last slot
    (posegraph._slot) and are counted, on the host."""
    fusion = gf.GlobalFusion(gf.GlobalFusionConfig(node_capacity=8, loop_capacity=2,
                                                   cloud_capacity=8), device="cpu")
    q, p = torch.tensor([1.0, 0, 0, 0]), torch.zeros(3)
    before = tracing.GLOBAL_TIMERS.counters["global_fusion.loops_overwritten"]
    fits = [0.01, 0.02, 9.0, 0.03]  # the third fails ICP's fitness gate
    fusion._pending_icp = [(4 + k, k, q, p, gf._HostCopy(torch.tensor([f])))
                           for k, f in enumerate(fits)]
    fusion._poll_icp(block=True)
    assert len(fusion.loops_found) == 3 and int(fusion.graph.n_loops) == 3
    assert tracing.GLOBAL_TIMERS.counters["global_fusion.loops_overwritten"] == before + 1
    assert fusion.graph.loop_i.tolist() == [0, 3]  # the last slot written over


@pytest.mark.cuda
def test_cuda_device_intervals_and_idle_charge():
    """On a card: a span around torch.cuda._sleep has a device interval
    within 10% of the elapsed time of CUDA events around the kernel; and a
    host sleep of 10 ms between two device spans is device idle (no span's
    event pending), charged to the span open on the host over it
    (vilbench/spans.py, with vilbench/trace.py's gaps and charges)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device timing records CUDA events")
    dev = torch.device("cuda", 0)
    torch.cuda._sleep(1_000_000)  # warm the kernel
    torch.cuda.synchronize(dev)
    timers = tracing.StageTimers()
    timers.record(dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with timers.timed("sleep"):
        e0.record()
        torch.cuda._sleep(20_000_000)
        e1.record()
    torch.cuda.synchronize(dev)  # the device idle before the second part
    with timers.timed("outer"):
        with timers.timed("a"):
            torch.cuda._sleep(200_000)
        with timers.timed("wait"):
            time.sleep(0.01)
        with timers.timed("b"):
            torch.cuda._sleep(200_000)
    log = timers.stop()
    spans = {s.name: s for s in log.spans}
    kernel_s = 1e-3 * e0.elapsed_time(e1)
    sleep = spans["sleep"]
    assert abs((sleep.d1 - sleep.d0) - kernel_s) <= 0.1 * kernel_s, (sleep, kernel_s)
    assert sleep.t0 <= sleep.d0 + 1e-3
    b = span_mod.window_breakdown(log.spans, spans["a"].t0, spans["b"].t1)
    charged = dict(b["idle_gaps"])
    assert charged.get("wait", 0.0) >= 0.008, charged
    assert max(charged, key=charged.get) == "wait", charged
