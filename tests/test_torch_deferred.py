"""The port's deferred frame path (sync_depth > 0), mode "mask" and the
visual loop in the pipeline, on test_torch_vil_pipeline.py's small rig
(160 x 120 images, 16-ring scans quantized to int16, 200 Hz IMU, oracle
initial state, the tracker's RANSAC off in both packages).

Tolerances:
  * sync_depth=2 against sync_depth=0 of the port: 1e-5 m
    (tests/test_pipeline.py:199's check; the same operations in the same
    order, deferred);
  * the port against the reference, both at sync_depth=2, and mode "mask"
    against the reference's: 0.05 m, test_torch_vil_pipeline.py's bound
    (each package's chain of registrations and windows amplifies float32
    differences to 2.3e-2 m, tools/parity_floor.py).
"""
import jax
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import global_fusion as jgf
from vil_fusion_tpu.runtime.config import RigConfig as JRig
from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline as JPipeline
from vil_fusion_tpu_torch.models import visual_loop as tvl
from vil_fusion_tpu_torch.models.window import K

from test_torch_vil_pipeline import GF, H, ODOM, QUANT, RIG_KW, W, _feed, _frames, _oracle, _port
from test_torch_vision import render, smooth_texture

torch.set_num_threads(2)
N_FRAMES = 16


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    yield
    jax.clear_caches()


def _jax(mode="vil", **kw):
    p = JPipeline(JRig(**RIG_KW), mode=mode, f_cap=64, odom_overrides=ODOM,
                  gf_cfg=jgf.GlobalFusionConfig(**GF), scan_quant=QUANT, **kw)
    p.tracker_cfg = p.tracker_cfg._replace(ransac=False)
    return p


class _Snapshots:
    """Wraps a pipeline's _capture: keeps every issued frame's window and
    feature snapshot with a copy of its values at issue time, and counts
    issued and completed frames."""

    def __init__(self, pipe):
        self.kept, self.completed = [], 0
        capture, complete = pipe._capture, pipe._complete_frame

        def capture_rec(rec, *a):
            rec = capture(rec, *a)
            snap = (rec["window"], rec["feats"])
            self.kept.append((snap, [[t.clone() for t in s] for s in snap]))
            return rec

        def complete_rec(rec):
            self.completed += 1
            return complete(rec)

        pipe._capture, pipe._complete_frame = capture_rec, complete_rec


@pytest.fixture(scope="module")
def runs():
    """The reference and the port at sync_depth=2, and the port at
    sync_depth=0, over the same N_FRAMES frames."""
    traj, frames = _frames(N_FRAMES)
    jp, tp, t0 = _jax(sync_depth=2), _port(sync_depth=2), _port()
    snaps = _Snapshots(tp)
    for p in (jp, tp, t0):
        _oracle(p, traj)
    returned = []
    for fr in frames:
        for p in (jp, tp, t0):
            _feed(p, fr)
    for p in (jp, tp, t0):
        returned.append(p.finalize())
    return frames, jp, tp, t0, snaps, returned


def test_deferred_equals_synchronous(runs):
    """The port at sync_depth=2 gives its sync_depth=0 trajectory: every
    steady frame issued and completed two frames later, the same outputs,
    keyframes and fused steps."""
    _, _, tp, t0, snaps, returned = runs
    assert returned[1] is not None
    steady = N_FRAMES - (K - 1)
    assert len(snaps.kept) == snaps.completed == steady
    assert tp.estimator.fused_steps == t0.estimator.fused_steps == steady
    assert len(tp.outputs.ts) == len(t0.outputs.ts) == N_FRAMES and tp._pending == []
    np.testing.assert_allclose(np.stack(tp.outputs.vio_p), np.stack(t0.outputs.vio_p), atol=1e-5)
    np.testing.assert_allclose(np.stack(tp.outputs.lidar_p), np.stack(t0.outputs.lidar_p),
                               atol=1e-5)
    assert tp.outputs.initialized == t0.outputs.initialized == [True] * N_FRAMES
    assert tp.fusion.n_kf == t0.fusion.n_kf and tp.restarts == t0.restarts == 0


def test_deferred_matches_reference(runs):
    """Both packages at sync_depth=2: the same frames output, lidar odometry
    and the estimator within 0.05 m, near the ground truth."""
    frames, jp, tp, _, _, returned = runs
    assert returned[0] is not None and len(jp.outputs.ts) == len(tp.outputs.ts)
    assert jp.restarts == tp.restarts == 0 and jp.fusion.n_kf == tp.fusion.n_kf
    np.testing.assert_allclose(np.stack(tp.outputs.lidar_p), np.stack(jp.outputs.lidar_p),
                               atol=0.05)
    vt = np.stack(tp.outputs.vio_p)
    np.testing.assert_allclose(vt, np.stack(jp.outputs.vio_p), atol=0.05)
    assert np.linalg.norm(vt - np.stack([fr[5] for fr in frames]), axis=1).max() < 0.5


def test_deferred_snapshots_are_not_aliased(runs):
    """The window and feature snapshots an issued frame keeps for its
    completion still hold their issue-time values after every later frame
    (no later step writes a tensor of the estimator's state in place)."""
    _, _, tp, _, snaps, _ = runs
    assert len(snaps.kept) > 2
    for (window, feats), copies in snaps.kept:
        for snap, copy in zip((window, feats), copies):
            for t, c in zip(snap, copy):
                assert torch.equal(t, c)
    assert not torch.equal(snaps.kept[0][0][0].p, tp.estimator.window.p)


def test_vio_with_visual_loop():
    """Mode "vio" with the visual loop (tests/test_pipeline.py:158 on the
    small rig): keyframes inserted past the gap, a loop-corrected output per
    frame, no loop and an identity drift on a path that does not revisit,
    vins_result_loop.txt written."""
    traj, frames = _frames(14)
    pipe = _port(mode="vio", visual_loop=True,
                 vl_cfg=tvl.VisualLoopConfig(capacity=64, keyframe_gap=0.5))
    _oracle(pipe, traj)
    for fr in frames:
        _feed(pipe, fr, scan=False)
    pipe.finalize()
    assert pipe.visual_loop.n >= 2 and int(pipe.visual_loop.graph.n_loops) == 0
    assert len(pipe.outputs.loop_p) == len(pipe.outputs.anchor_kf) == len(pipe.outputs.ts) == 14
    np.testing.assert_allclose(pipe.loop_drift_R, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(np.stack(pipe.outputs.loop_p), np.stack(pipe.outputs.vio_p),
                               atol=1e-6)
    assert pipe.vl_errors == 0 and pipe.restarts == 0


def test_stale_visual_loop_drift_dropped_after_restart(tmp_path):
    """tests/test_pipeline.py:312 on the port: a relocalization drift
    computed against a pre-restart estimator is dropped; a current one is
    applied. Then outputs with loop rows write vins_result_loop.txt."""
    pipe = _port(mode="vio", visual_loop=True, sync_depth=2)
    stale = (np.eye(3) * -1.0, np.array([100.0, 0, 0]))
    pipe._vl_results.put((pipe._gen, stale))
    pipe._gen += 1  # as _restart() does
    p0, q0 = np.zeros(3), np.array([1.0, 0, 0, 0])
    p_out, q_out = pipe._drain_vl_results(p0, q0)
    np.testing.assert_array_equal(p_out, p0)
    np.testing.assert_array_equal(q_out, q0)
    pipe._vl_results.put((pipe._gen, (np.eye(3), np.array([1.0, 2.0, 3.0]))))
    p_out, _ = pipe._drain_vl_results(p0, q0)
    np.testing.assert_allclose(p_out, [1.0, 2.0, 3.0])
    # a restart empties the queue of drifts
    pipe._vl_results.put((pipe._gen, stale))
    pipe._restart(cause="camera_gap")
    assert pipe._vl_results.empty() and pipe.sequence == 1
    pipe._append_outputs(1.0, p0, q0, True, (q0, p0))
    pipe.outputs.write(str(tmp_path))
    assert (tmp_path / "vins_result_loop.txt").exists()


def _masked(frames, size=40):
    """tests/test_pipeline.py:263's moving textured object at half scale:
    (frame, image with the object, its mask, the object's box)."""
    tex = smooth_texture(size + 20, size + 20, seed=99, scale=4)
    out = []
    for i, fr in enumerate(frames):
        ox, oy = 20 + i * 5, 35 + (i % 5) * 2
        img = fr[1].copy()
        obj = render(tex, size, size, shift=(i * 2.5, i * 1.0))
        img[oy:oy + size, ox:ox + size] = (np.clip(obj, 0, 1) * 255).astype(np.uint8)
        mask = np.zeros((H, W), bool)
        mask[oy:oy + size, ox:ox + size] = True
        out.append((fr[:1] + (img,) + fr[2:], mask, (ox, oy)))
    return out


def _inside(xy, box, size=40, margin=4):
    ox, oy = box
    return int(((xy[:, 0] > ox + margin) & (xy[:, 0] < ox + size - margin)
                & (xy[:, 1] > oy + margin) & (xy[:, 1] < oy + size - margin)).sum())


def test_mask_mode_matches_reference():
    """Mode "mask" in both packages: no more than 2 tracked features inside
    the mask's core on any frame, the same count there as the reference,
    no restart, positions within 0.05 m of the reference's and 0.5 m of the
    truth."""
    traj, frames = _frames(12)
    jp, tp = _jax("mask"), _port("mask")
    assert tp.tracker_cfg.mask_gate
    for p in (jp, tp):
        _oracle(p, traj)
    for fr, mask, box in _masked(frames):
        t, img, _, _, imu, _ = fr
        for p in (jp, tp):
            if imu is not None:
                p.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
            p.push_image(t, img, mask=mask)
        xt = tp.tracker_state.xy.numpy()[tp.tracker_state.valid.numpy()]
        xj = np.asarray(jp.tracker_state.xy)[np.asarray(jp.tracker_state.valid)]
        assert _inside(xt, box) == _inside(xj, box) and _inside(xt, box) <= 2
    assert tp.restarts == jp.restarts == 0
    vt = np.stack(tp.outputs.vio_p)
    np.testing.assert_allclose(vt, np.stack(jp.outputs.vio_p), atol=0.05)
    assert np.linalg.norm(vt - np.stack([fr[5] for fr in frames]), axis=1).max() < 0.5
