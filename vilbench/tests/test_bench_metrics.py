"""The metric arithmetic on synthetic events: rates over the whole window,
p95 over every frame, busy and idle from the union of device intervals,
idle gaps charged to host ranges, and the roofline bounds."""
import math

import numpy as np
import pytest

from vilbench import harness, trace
from vilbench.rooflines import eigh, knn, peaks
from vilbench.tests.tiny import ROOT


def _rec(**kw):
    rec = harness.Record({}, {})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def read(kind, name, rec):
    return harness.reader(ROOT, kind, name)(rec)


@pytest.mark.parametrize("name", ["frames_per_s", "scans_per_s"])
def test_rate_over_the_whole_window(name):
    assert read("end_to_end", name, _rec(delivered=250, window_s=20.5)) == 250 / 20.5


def test_latency_over_every_frame():
    lat = list(np.linspace(0.1, 0.3, 201))  # 0.100 .. 0.300 s
    assert read("end_to_end", "frame_latency_p50_ms", _rec(latencies_s=lat)) == pytest.approx(200.0)
    v = read("layer_metrics", "pipeline.frame_latency_p95_ms", _rec(latencies_s=lat))
    assert v == pytest.approx(290.0)
    v = read("layer_metrics", "pipeline.scan_latency_p95_ms", _rec(call_s=lat))
    assert v == pytest.approx(290.0)
    assert read("end_to_end", "frame_latency_p50_ms", _rec(latencies_s=[])) is None


def test_host_timers_per_frame():
    rec = _rec(delivered=200, timers={"frame_wait": {"n": 200, "total_s": 2.0},
                                      "global_fusion": {"n": 200, "total_s": 0.5},
                                      "lidar_odometry": {"n": 200, "total_s": 1.2}})
    assert read("layer_metrics", "pipeline.frame_wait_ms", rec) == pytest.approx(10.0)
    assert read("layer_metrics", "global_fusion.host_ms.vil", rec) == pytest.approx(2.5)
    assert read("layer_metrics", "global_fusion.host_ms.lidar", rec) == pytest.approx(2.5)
    assert read("layer_metrics", "lidar_odometry.host_ms", rec) == pytest.approx(6.0)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert trace.union_seconds(iv, 0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert trace.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert trace.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


class _Ev:
    def __init__(self, name, dev, s, e, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, dev, s, e, annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._e - self._s) * 1e9)

    def is_user_annotation(self):
        return self._a


def test_reduce_busy_idle_and_launches():
    evs = [_Ev(trace.WINDOW, "CPU", 0.0, 1.0), _Ev("frame_wait", "CPU", 0.2, 0.6),
           _Ev("global_fusion", "CPU", 0.7, 0.9), _Ev("cudaGraphLaunch", "CPU", 0.0, 0.01),
           _Ev("cudaLaunchKernel", "CPU", 0.1, 0.11), _Ev("k1", "CUDA", 0.0, 0.3),
           _Ev("k2", "CUDA", 0.25, 0.5), _Ev("frame_wait", "CUDA", 0.2, 0.6),
           _Ev("note", "CUDA", 0.5, 1.0, annotation=True)]
    s = trace.reduce(evs, frames=2, range_names={"frame_wait", "global_fusion"})
    assert s.window_s == pytest.approx(1.0) and s.busy_s == pytest.approx(0.5)
    assert s.launches == 2 and set(s.kernels) == {"k1", "k2"}
    assert s.idle_by_host == pytest.approx({"frame_wait": 0.1, "host (no range)": 0.2,
                                            "global_fusion": 0.2})
    rec = _rec(trace=s)
    assert read("layer_metrics", "device.idle_pct.vil", rec) == pytest.approx(50.0)
    assert read("layer_metrics", "device.kernel_ms_per_frame", rec) == pytest.approx(275.0)
    assert read("layer_metrics", "graphs.launches_per_frame", rec) == 1.0


def test_knn_bound_matches_the_smoke():
    """chip_smoke.py's bounds of PERF.md's kernel table (ms): K1 surf and the
    depth K2, both bound by their operations."""
    assert knn.bound_s(8192, 32768, 5) * 1e3 == pytest.approx(0.03205, rel=1e-3)
    assert knn.bound_s(192, 115200, 3) * 1e3 == pytest.approx(0.00264, rel=1e-2)
    assert eigh.bound_s(157) * 1e3 == pytest.approx(9 * 157 ** 3 / peaks.FP32_FLOPS * 1e3)


def test_rooflines_from_calls_and_kernel_time():
    s = trace.Summary(frames=1)
    s.knn_calls = {(8192, 32768, 5): 2}
    s.kernels = {"void knn_dense_kernel<5, true, false>(...)": [2, 4 * knn.bound_s(8192, 32768, 5)],
                 "void knn_merge_kernel<5>(...)": [0, 0.0], "other": [3, 1.0]}
    assert read("layer_metrics", "knn_roofline.vil", _rec(trace=s)) == pytest.approx(50.0)
    s.kernels = {"hhql_eigh_kernel": [2, 4 * eigh.bound_s(157)],
                 "void jacobi_warp_kernel<float>": [1, 1e9]}
    rec = _rec(trace=s, config={"eigh_sizes": {"hhql_eigh_kernel": 157, "jacobi_warp_kernel": 15}})
    v = read("layer_metrics", "eigh_roofline", rec)
    assert v == pytest.approx(100.0 * (2 * eigh.bound_s(157) + eigh.bound_s(15))
                              / (4 * eigh.bound_s(157) + 1e9))
    assert read("layer_metrics", "knn_roofline.vil", _rec(trace=trace.Summary(1))) is None
    assert not math.isnan(v)
