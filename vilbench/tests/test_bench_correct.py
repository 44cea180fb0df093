"""`correct` on the CPU at a tiny size (tiny.py): a sound run of each cell
is correct, and a run whose timed path is broken underneath is not, once
for each fault a cell can have: a step that returns its state unchanged,
an answer altered where it is produced (a program that fails on its own
under a fault is caught as well: the run prints no result). The cells run
on one chip: no exchange between chips to leave out. Neither has a batch
whose mean half of it could stand in for: a step registers one scan, and
the pose from half of a scan's points is as right as the pose from all of
them. Each run takes three to seven minutes here."""
import time

import pytest
import torch

from vilbench import harness
from vilbench.tests import tiny

SEED = 2**31 + 12345


def run(cell, tmp_path):
    out = harness.run_cell(tiny.spec(cell), SEED, 1.0, False, "cpu", time.perf_counter(),
                           tiny.ROOT, cache_dir=str(tmp_path))
    return out


def _odometry_fault(kind):
    from vil_fusion_tpu_torch.models import lidar_odometry as lo

    orig = lo.odometry_step

    def step(state, points, valid, cfg, frame_count=None, capture_lock=None):
        new, (q, p, qr, pr) = orig(state, points, valid, cfg, frame_count=frame_count,
                                   capture_lock=capture_lock)
        if kind == "unchanged" and frame_count and frame_count > 10:
            return state._replace(frame_count=new.frame_count), (q, p, qr, pr)
        if kind == "altered":
            p = p + torch.tensor([0.1, 0.0, 0.0], dtype=p.dtype, device=p.device)
        return new, (q, p, qr, pr)

    return lo, "odometry_step", step


def _frame_fault(kind):
    from vil_fusion_tpu_torch.runtime import pipeline

    orig = pipeline.vil_frame

    def frame(tracker_state, lidar_state, window, feats, pre, lidarc, prior, img, pts, val,
              *a, **kw):
        res = orig(tracker_state, lidar_state, window, feats, pre, lidarc, prior, img, pts,
                   val, *a, **kw)
        if kind == "unchanged":
            return (tracker_state, lidar_state, window, feats, pre, lidarc, prior) + res[7:]
        if kind == "altered":  # the frame's lidar pose, as the front end delivers it
            front = dict(res[8])
            front["lidar_p"] = front["lidar_p"] + 0.1
            return res[:8] + (front,)
        return res

    return pipeline, "vil_frame", frame


@pytest.mark.parametrize("cell", ["kitti_lidar.city_laps", "kitti_vil.city"])
def test_sound_run_is_correct(cell, tmp_path):
    out = run(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, k) for c in ("kitti_lidar.city_laps", "kitti_vil.city")
                                        for k in ("unchanged", "altered")])
def test_broken_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    mod, name, fn = (_odometry_fault if cell.startswith("kitti_lidar") else _frame_fault)(fault)
    monkeypatch.setattr(mod, name, fn)
    try:
        out = run(cell, tmp_path)
    except RuntimeError:  # the broken program fails on its own (eigh on a stale window)
        return
    assert not out["correct"], out["checks"]
