"""The reader of global fusion's backlog wait (span
"global_fusion.backlog_wait"): host ms a delivered scan over the window;
0 where the span ran only before the window, or never in a program that
bounds the backlog; nothing in a program without the bound, or without
delivered scans."""
import pytest

from vilbench import harness
from vilbench.tests.tiny import ROOT
from vil_fusion_tpu_torch.models.global_fusion import GlobalFusion

NAME = "global_fusion.backlog_wait_ms"


def _rec(**kw):
    rec = harness.Record({}, {})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def read(rec):
    return harness.reader(ROOT, "layer_metrics", NAME)(rec)


def test_ms_a_delivered_scan():
    rec = _rec(delivered=400, timers={"global_fusion.backlog_wait": {"n": 12, "total_s": 0.2},
                                      "global_fusion": {"n": 400, "total_s": 0.6}})
    assert read(rec) == pytest.approx(0.5)
    rec = _rec(delivered=400, timers={"global_fusion.backlog_wait": {"n": 0, "total_s": 0.0}})
    assert read(rec) == 0.0


def test_no_wait_reads_zero_where_the_backlog_is_bounded(monkeypatch):
    rec = _rec(delivered=400, timers={"global_fusion": {"n": 400, "total_s": 0.6}})
    assert read(rec) == 0.0
    monkeypatch.delattr(GlobalFusion, "BACKLOG")
    assert read(rec) is None


def test_nothing_without_delivered_scans():
    assert read(_rec(delivered=0, timers={"global_fusion.backlog_wait": {"n": 1, "total_s": 0.1}})) \
        is None
    assert read(_rec(delivered=0, timers={})) is None
