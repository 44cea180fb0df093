"""The span metrics and the window's breakdown on a synthetic span log
(vilbench/spans.py and the readers that read it): device idle where no
span's timing event is pending, device and host ms a delivered scan,
idle gaps charged to the innermost span open on the host, the slowest
scans' ms by span, and the profiler-clock check."""
import pytest

from vilbench import harness, spans
from vilbench.tests.tiny import ROOT
from vil_fusion_tpu_torch.utils.tracing import Span


def _log():
    """Two scans in a 10-s window, each a push_scan with lidar_odometry
    (pose_read inside) and global_fusion. Scan 0: the replay runs while the
    pose read waits (its entry event pending 1-3 s), global fusion's work
    runs 0.2 s past the push (its exit event pending 5-5.2 s). Scan 1: the
    pose read's event is pending 7-8.5 s. Every other event is reached as
    soon as it is recorded: the device waits for the host there."""
    return [
        Span("push_scan", 1, None, 0, 1, 0.0, 5.0, 0.0, 5.2),
        Span("lidar_odometry", 2, 1, 0, 1, 0.5, 4.0, 0.5, 4.0),
        Span("lidar_odometry.pose_read", 3, 2, 0, 1, 1.0, 4.0, 3.0, 4.0),
        Span("global_fusion", 4, 1, 0, 1, 4.0, 5.0, 4.0, 5.2),
        Span("push_scan", 5, None, 1, 1, 6.0, 9.5, 6.0, 9.5),
        Span("lidar_odometry", 6, 5, 1, 1, 6.0, 9.0, 6.0, 9.0),
        Span("lidar_odometry.pose_read", 7, 6, 1, 1, 7.0, 9.0, 8.5, 9.0),
        Span("global_fusion", 8, 5, 1, 1, 9.0, 9.5, 9.0, 9.5),
    ]


def _rec(**kw):
    rec = harness.Record({}, {})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def read(name, rec):
    return harness.reader(ROOT, "layer_metrics", name)(rec)


def test_span_readers():
    rec = _rec(spans=_log(), span_window=(0.0, 10.0), delivered=2,
               timers={"scan_quantize": {"n": 2, "total_s": 0.004},
                       "lidar_odometry.pose_read": {"n": 2, "total_s": 4.0}})
    # known busy (an event pending): 1-3, 5-5.2, 7-8.5 = 3.7 s of 10
    assert read("device.window_idle_pct.lidar", rec) == pytest.approx(63.0)
    # device intervals: 0.5-4 and 6-9; 4-5.2 and 9-9.5
    assert read("lidar_odometry.device_ms", rec) == pytest.approx(1e3 * 6.5 / 2)
    assert read("global_fusion.device_ms.lidar", rec) == pytest.approx(1e3 * 1.7 / 2)
    assert read("pipeline.scan_quantize_ms", rec) == pytest.approx(2.0)
    assert read("lidar_odometry.pose_wait_ms", rec) == pytest.approx(2e3)


def test_span_readers_without_a_log():
    """A run without recording (the parent's, or --trace 0) reads nothing;
    neither does a host-only log."""
    rec = _rec(delivered=2, timers={})
    for name in ("device.window_idle_pct.lidar", "lidar_odometry.device_ms",
                 "global_fusion.device_ms.lidar", "pipeline.scan_quantize_ms",
                 "lidar_odometry.pose_wait_ms"):
        assert read(name, rec) is None
    host_only = [s._replace(d0=None, d1=None) for s in _log()]
    rec = _rec(spans=host_only, span_window=(0.0, 10.0), delivered=2)
    assert read("device.window_idle_pct.lidar", rec) is None
    assert read("lidar_odometry.device_ms", rec) is None


def test_window_breakdown():
    b = spans.window_breakdown(_log(), 0.0, 10.0, tail=0.5)
    # idle 0-1, 3-5, 5.2-7, 8.5-10, charged to the innermost span on the host
    assert dict(b["idle_gaps"]) == pytest.approx({
        "push_scan": 0.5, "lidar_odometry": 1.5, "lidar_odometry.pose_read": 1.5,
        "global_fusion": 1.5, "host (no range)": 1.3})
    assert b["idle_s"] == pytest.approx(6.3)
    assert b["requests"] == 2 and b["mean_ms"] == pytest.approx(4250.0)
    assert b["tail_ms"] == pytest.approx(5000.0)  # scan 0
    rows = {n: (m, t) for n, m, t in b["by_span_ms"]}  # self times
    assert rows["push_scan"] == pytest.approx((250.0, 500.0))
    assert rows["lidar_odometry"] == pytest.approx((750.0, 500.0))
    assert rows["lidar_odometry.pose_read"] == pytest.approx((2500.0, 3000.0))
    assert rows["global_fusion"] == pytest.approx((750.0, 1000.0))
    assert b["by_span_ms"][0][0] == "lidar_odometry.pose_read"  # the most longer when slow


class _Ev:
    def __init__(self, name, dev, s, e, annotation=False):
        self.row = (name, "DeviceType." + dev, int(s * 1e9), int((e - s) * 1e9), annotation)


def test_profiler_coverage_puts_spans_on_the_profilers_clock():
    """The profiler's clock runs 100 s ahead of the spans': the offset comes
    from the spans' ranges. Of 3.2 s of device operations inside the traced
    range, 2.7 lie inside the spans' device intervals and 2.2 inside their
    pending events' intervals."""
    log = _log()[:4]  # scan 0
    evs = [_Ev("vilbench.traced", "CPU", 100.0, 106.0),
           _Ev("push_scan", "CPU", 100.0, 105.0),
           _Ev("lidar_odometry", "CPU", 100.5, 104.0),
           _Ev("lidar_odometry.pose_read", "CPU", 101.0, 104.0),
           _Ev("global_fusion", "CPU", 104.0, 105.0),
           _Ev("k1", "CUDA", 101.0, 103.0), _Ev("k2", "CUDA", 104.5, 105.2),
           _Ev("k3", "CUDA", 105.5, 106.5),  # outside every span; half outside the range
           _Ev("lidar_odometry", "CUDA", 101.0, 103.0, annotation=True)]
    out = spans.profiler_coverage([e.row for e in evs], log)
    assert out["offset_s"] == pytest.approx(100.0) and out["matched"] == 4
    assert out["offset_spread_s"] == pytest.approx(0.0, abs=1e-6)
    assert out["profiler_busy_s"] == pytest.approx(3.2)
    assert out["share"] == pytest.approx(2.7 / 3.2)
    assert out["busy_share"] == pytest.approx(2.2 / 3.2)
    assert out["busy_s"] == pytest.approx(2.2)
