"""The slice as a whole: the port's VILFusionPipeline in mode "vil"
(sync_depth=0) against vil_fusion_tpu's over the same 14 frames (16-ring
scans quantized to int16, 160 x 120 images, 200 Hz IMU, oracle initial
state), plus mode "vio", the IMU-rate output, the restart seeded from the
lidar odometry, `vil_frame`, and what still raises.

The tracker's RANSAC is off in both pipelines (its samples come from
different generators; its parity is test_torch_vision.py's), and the
odometry uses the exact kNN (JAX on the CPU answers approx_knn=True with
its exact search). Tolerances: lidar odometry positions within 0.05 m of
the reference's: one registration agrees to 1e-4 m from identical maps
(test_torch_lidar_modes.py), and each package's chain of 14 registrations
of 16-ring scans at 4 m/s amplifies the f32 differences (2.3e-2 m at most,
tools/parity_floor.py; test_torch_pipeline.py holds 10 frames at 2 m/s to
0.02 m); estimator positions within 0.05 m per frame: the estimator takes
the front end's outputs, and with 40 features in a 160 x 120 image its
window amplifies their differences (4e-4 to 2.3e-2 m from the first BA on,
where both packages are up to 0.20-0.22 m from the ground truth,
tools/parity_floor.py).
"""
import os

import jax
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import global_fusion as jgf
from vil_fusion_tpu.runtime.config import RigConfig as JRig
from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline as JPipeline
from vil_fusion_tpu_torch.models import global_fusion as tgf
from vil_fusion_tpu_torch.runtime import pipeline as tpipe
from vil_fusion_tpu_torch.runtime import sim as tsim
from vil_fusion_tpu_torch.runtime.config import RigConfig as TRig

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends (the CPU
    backend's JIT is unstable once hundreds of programs accumulate in one
    worker; tests/conftest.py clears after the reference's heavy modules)."""
    yield
    jax.clear_caches()

H, W, F = 120, 160, 100.0
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
RIG_KW = dict(
    name="small",
    camera=dict(model_type="PINHOLE", projection_parameters=dict(fx=F, fy=F, cx=W / 2, cy=H / 2),
                distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
    image_height=H, image_width=W, q_ic=tsim.R_to_q(R_BC), t_ic=np.array([0.1, 0.0, 0.05]),
    q_cl=tsim.R_to_q(R_BC.T), t_cl=np.array([0.0, -0.1, 0.02]), max_cnt=40, min_dist=12,
    n_scan=16, lidar_fov_up=15.0, lidar_fov_down=-15.0, lidar_min_range=1.0,
    lidar_max_range=80.0, use_lidar=True, rolling_shutter=True, tr=0.02, f_threshold=3.0)
ODOM = dict(edge_map_cap=2048, surf_map_cap=4096, edge_cap=256, surf_cap=1024, approx_knn=False)
GF = dict(node_capacity=64, loop_capacity=8, cloud_capacity=512, submap_half_span=3)
QUANT = 0.0025
N_FRAMES = 14
OFF = np.array([0.0, 0.0, 1.5])


def _frames(n, speed=4.0):
    """n frames at 10 Hz along sim.Trajectory: uint8 image, scan, the IMU
    samples since the previous frame, ground-truth position."""
    scene = tsim.RaycastScene()
    traj = tsim.Trajectory(tsim.TrajectoryConfig(speed=speed))
    out = []
    for i in range(n):
        t = 1.0 + 0.1 * i
        R, p = traj.rotation(t), traj.position(t) + OFF
        img = tsim.render_camera_image(scene, R @ R_BC, p, F, F, W / 2, H / 2, H, W)
        pts, val = tsim.simulate_lidar_scan(scene, R, p, n_scan=16, width=900, fov_up_deg=15.0,
                                            fov_down_deg=-15.0, max_range=80.0, seed=i)
        imu = tsim.simulate_imu(traj, t - 0.1, t, 200.0) if i else None
        out.append((t, (np.clip(img, 0, 1) * 255).astype(np.uint8), pts, val, imu, p))
    return traj, out


def _feed(pipe, fr, scan=True):
    t, img, pts, val, imu, _ = fr
    if imu is not None:
        pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
    if scan:
        pipe.push_scan(t, pts.copy(), val.copy())
    return pipe.push_image(t, img)


def _port(mode="vil", **kw):
    p = tpipe.VILFusionPipeline(TRig(**RIG_KW), mode=mode, f_cap=64, odom_overrides=ODOM,
                                gf_cfg=tgf.GlobalFusionConfig(**GF), scan_quant=QUANT,
                                device="cpu", **kw)
    p.tracker_cfg = p.tracker_cfg._replace(ransac=False)
    p.fe = p.fe._replace(tcfg=p.tracker_cfg)
    return p


def _oracle(pipe, traj):
    q0, p0 = traj.pose(1.0)
    pipe.estimator.set_initial_state(p=p0 + OFF, q=q0, v=traj.velocity(1.0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    traj, frames = _frames(N_FRAMES + 1)
    jp = JPipeline(JRig(**RIG_KW), mode="vil", f_cap=64, odom_overrides=ODOM,
                   gf_cfg=jgf.GlobalFusionConfig(**GF), scan_quant=QUANT, sync_depth=0)
    jp.tracker_cfg = jp.tracker_cfg._replace(ransac=False)
    tp = _port()
    for p in (jp, tp):
        _oracle(p, traj)
    hr = []
    for fr in frames[:N_FRAMES]:
        _feed(jp, fr)
        _feed(tp, fr)
    # the IMU-rate output: the next frame's first samples through both
    ts, acc, gyr = frames[N_FRAMES][4]
    for k in range(1, 4):
        hr.append((jp.push_imu(ts[k], acc[k], gyr[k]), tp.push_imu(ts[k], acc[k], gyr[k])))
    dirs = tmp_path_factory.mktemp("jax_out"), tmp_path_factory.mktemp("port_out")
    jp.outputs.write(str(dirs[0]), jp.fusion)
    tp.outputs.write(str(dirs[1]), tp.fusion)
    return traj, frames, jp, tp, hr, dirs


def test_vil_pipeline_matches_reference(runs):
    """Frame by frame: the same frames processed, initialized and restart
    free; lidar odometry and the estimator within 0.05 m of the reference;
    the fused step ran on every steady frame."""
    _, frames, jp, tp, _, _ = runs
    assert len(tp.outputs.ts) == len(jp.outputs.ts) == N_FRAMES
    assert tp.restarts == jp.restarts == 0
    assert tp.outputs.initialized == jp.outputs.initialized == [True] * N_FRAMES
    assert tp.estimator.fused_steps == N_FRAMES - 10
    np.testing.assert_allclose(np.stack(tp.outputs.lidar_p), np.stack(jp.outputs.lidar_p),
                               atol=0.05)
    vt, vj = np.stack(tp.outputs.vio_p), np.stack(jp.outputs.vio_p)
    assert np.isfinite(vt).all() and np.isfinite(np.stack(tp.outputs.vio_q)).all()
    np.testing.assert_allclose(vt, vj, atol=0.05)
    gt = np.stack([fr[5] for fr in frames[:N_FRAMES]])
    assert np.linalg.norm(vt - gt, axis=1).max() < 0.5


def test_outputs_and_imu_rate_pose(runs):
    """write() gives the reference's files (vins_result_no_loop of the
    initialized frames, lidar_odometry, fs_loam_loop) with the same rows;
    push_imu returns the IMU-rate pose, within 0.05 m of the reference's."""
    _, _, jp, tp, hr, dirs = runs
    for name in ("vins_result_no_loop.txt", "lidar_odometry.txt", "fs_loam_loop.txt"):
        a = np.loadtxt(os.path.join(dirs[0], name))
        b = np.loadtxt(os.path.join(dirs[1], name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a[..., 0], b[..., 0])
    for out_j, out_t in hr:
        assert out_t is not None and len(out_t) == 3
        np.testing.assert_allclose(out_t[0], out_j[0], atol=0.05)
        np.testing.assert_allclose(out_t[1], out_j[1], atol=1e-2)


def test_restart_seeds_from_lidar(runs):
    """_restart: a fresh estimator seeded from the lidar odometry's pose and
    velocity (as the reference's; pose within the lidar tolerance, the
    velocity, a difference of two poses over 0.1 s, within 0.5 m/s), the
    cause and failed predicates logged;
    the high-rate output stops until the estimator is solved again."""
    _, _, jp, tp, _, _ = runs
    jp.estimator.fail_mask = tp.estimator.fail_mask = 4
    for p in (jp, tp):
        p._restart()
    assert tp.restarts == 1 and tp.restart_log[-1]["predicates"] == ["position_jump"]
    assert tp.restart_log[-1]["cause"] == jp.restart_log[-1]["cause"] == "estimator_failure"
    assert tp.estimator.initialized and tp.estimator.frame_count == 0
    np.testing.assert_allclose(tp.estimator.window.p[0].numpy(),
                               np.asarray(jp.estimator.window.p[0]), atol=0.05)
    np.testing.assert_allclose(tp.estimator.window.v[0].numpy(),
                               np.asarray(jp.estimator.window.v[0]), atol=0.5)
    assert tp.push_imu(50.0, np.zeros(3), np.zeros(3)) is None


def test_vil_frame_is_the_pipeline_frame():
    """vil_frame (front end + fused_full_step as one function) on the
    pipeline's own states after 11 frames gives the 12th frame the pipeline
    computes (the same operations: atol 1e-5 m)."""
    traj, frames = _frames(12)
    pipe, ref = _port(), _port()
    for p in (pipe, ref):
        _oracle(p, traj)
    for fr in frames[:-1]:
        _feed(pipe, fr)
        _feed(ref, fr)
    _feed(ref, frames[-1])
    t, img, pts, val, imu, _ = frames[-1]
    pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
    est = pipe.estimator
    acc_b, gyr_b, dt_b, n = est._pack_imu(*pipe._imu_segment_for_frame(t))
    pts16 = np.clip(np.round(pts / QUANT), -32767, 32767).astype(np.int16)
    out = tpipe.vil_frame(
        pipe.tracker_state, pipe.lidar_state, est.window, est.feats, est.pre, est.lidar,
        est.prior, torch.from_numpy(img), torch.from_numpy(pts16),
        torch.from_numpy(np.packbits(val)), *(torch.from_numpy(x) for x in (acc_b, gyr_b, dt_b)),
        n, t, pipe.fe, pipe.est_cfg, frame_index=pipe.tracker_frames,
        generator=torch.Generator())
    np.testing.assert_allclose(out[7]["p"].numpy(), ref.outputs.vio_p[-1], atol=1e-5)
    np.testing.assert_allclose(out[8]["lidar_p"].numpy(), ref.outputs.lidar_p[-1], atol=1e-6)
    assert set(out[8]) >= {"ids", "xy", "depth", "q_imu", "p_imu"}


def test_vio_mode_runs():
    """Mode "vio": camera + IMU only (no scans, no global fusion, no lidar
    factor), 12 frames from the oracle state: the fused step runs on the
    steady frames and the trajectory stays finite and near the truth."""
    traj, frames = _frames(12)
    pipe = _port(mode="vio")
    assert pipe.fusion is None and not pipe.est_cfg.ba.use_lidar
    _oracle(pipe, traj)
    for fr in frames:
        _feed(pipe, fr, scan=False)
    assert len(pipe.outputs.ts) == 12 and pipe.restarts == 0
    assert pipe.estimator.fused_steps == 2
    vp = np.stack(pipe.outputs.vio_p)
    assert np.isfinite(vp).all()
    assert np.linalg.norm(vp - np.stack([fr[5] for fr in frames]), axis=1).max() < 0.5


def test_not_ported_paths_raise():
    """mode="mask", sync_depth > 0, visual_loop=True, a dynamic mask and
    the deferred estimator step raise NotImplementedError naming ROADMAP.md."""
    rig = TRig(**RIG_KW)
    for kw in (dict(mode="mask"), dict(sync_depth=2), dict(visual_loop=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe.VILFusionPipeline(rig, device="cpu", **kw)
    pipe = tpipe.VILFusionPipeline(rig, mode="vio", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.push_image(1.0, np.zeros((H, W), np.uint8), mask=np.zeros((H, W), bool))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.estimator.process_frame_device_async()
