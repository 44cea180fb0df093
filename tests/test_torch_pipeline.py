"""The port's LiDAR-only pipeline (`mode="lidar"`) against vil_fusion_tpu,
plus the carried numpy simulator and the scan upload path."""
import os

import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import global_fusion as jgf
from vil_fusion_tpu.runtime import sim as jsim
from vil_fusion_tpu.runtime import tum as jtum
from vil_fusion_tpu.runtime.config import RigConfig as JRig
from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline as JPipeline
from vil_fusion_tpu_torch.models import global_fusion as tgf
from vil_fusion_tpu_torch.runtime import pipeline as tpipe
from vil_fusion_tpu_torch.runtime import sim as tsim
from vil_fusion_tpu_torch.runtime import tum as ttum
from vil_fusion_tpu_torch.runtime.config import RigConfig as TRig
from vil_fusion_tpu_torch.runtime.config import load_rig

torch.set_num_threads(2)

R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
RIG_KW = dict(
    name="synthetic-16",
    camera=dict(model_type="PINHOLE", projection_parameters=dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0),
                distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
    image_height=240, image_width=320,
    q_ic=jsim.R_to_q(R_BC), t_ic=np.zeros(3), q_cl=jsim.R_to_q(R_BC.T), t_cl=np.zeros(3),
    n_scan=16, lidar_fov_up=15.0, lidar_fov_down=-25.0, lidar_min_range=1.0, lidar_max_range=80.0)
ODOM = dict(edge_map_cap=4096, surf_map_cap=8192, edge_cap=512, surf_cap=2048)
GF = dict(node_capacity=64, loop_capacity=8, cloud_capacity=512, submap_half_span=3)
N_FRAMES = 10


def _frames():
    scene = tsim.RaycastScene()
    traj = tsim.Trajectory(tsim.TrajectoryConfig(speed=2.0))
    out = []
    for i in range(N_FRAMES):
        t = 1.0 + 0.1 * i
        R = traj.rotation(t)
        p = traj.position(t) + np.array([0, 0, 1.5])
        pts, val = tsim.simulate_lidar_scan(scene, R, p, n_scan=16, width=900, fov_up_deg=15.0,
                                            fov_down_deg=-25.0, range_noise=0.01, seed=i)
        out.append((t, pts, val, p))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pipelines over the same 10 quantized 16-ring scans (2 m/s, 10 Hz,
    1 cm range noise), outputs written as TUM files."""
    frames = _frames()
    jp = JPipeline(JRig(**RIG_KW), mode="lidar", odom_overrides=ODOM,
                   gf_cfg=jgf.GlobalFusionConfig(**GF), scan_quant=0.0025)
    tp = tpipe.VILFusionPipeline(TRig(**RIG_KW), mode="lidar", odom_overrides=ODOM,
                                 gf_cfg=tgf.GlobalFusionConfig(**GF), scan_quant=0.0025,
                                 device="cpu")
    for t, pts, val, _ in frames:
        jp.push_scan(t, pts.copy(), val.copy())
        tp.push_scan(t, pts.copy(), val.copy())
    jp.finalize()
    assert tp.finalize() is None
    dirs = tmp_path_factory.mktemp("jax_out"), tmp_path_factory.mktemp("port_out")
    jp.outputs.write(str(dirs[0]), jp.fusion)
    tp.outputs.write(str(dirs[1]), tp.fusion)
    return frames, jp, tp, dirs


def test_lidar_trajectory_matches_jax(runs):
    """Every frame's odometry position within 0.02 m of the JAX pipeline's
    and rotation within 0.01 rad: single steps agree to ~1e-6 (see
    test_torch_lidar.py), and the sparse 16-ring registration chain amplifies
    f32 rounding differences to a few mm over 10 frames. Keyframe count
    identical; the port alone stays within 0.1 m of ground truth."""
    frames, jp, tp, _ = runs
    assert len(tp.outputs.ts) == len(jp.outputs.ts) == N_FRAMES
    pj, pt = np.stack(jp.outputs.lidar_p), np.stack(tp.outputs.lidar_p)
    assert np.abs(pt - pj).max() < 0.02, np.abs(pt - pj).max(1)
    qj, qt = np.stack(jp.outputs.lidar_q), np.stack(tp.outputs.lidar_q)
    ang = 2 * np.arccos(np.clip(np.abs(np.sum(qj * qt, axis=1)), 0, 1))
    assert ang.max() < 0.01
    assert tp.fusion.n_kf == jp.fusion.n_kf >= 2
    assert tp.lidar_frames == int(tp.lidar_state.frame_count) == N_FRAMES
    p0 = frames[0][3]
    R0 = tsim.Trajectory(tsim.TrajectoryConfig(speed=2.0)).rotation(frames[0][0])
    gt = np.stack([R0.T @ (f[3] - p0) for f in frames])
    assert np.linalg.norm(pt - gt, axis=1).max() < 0.1


def test_tum_outputs_match(runs):
    """PipelineOutputs.write: the same files, timestamps identical, poses
    within the trajectory tolerance (0.02 m, quaternions 0.01)."""
    _, _, _, (dj, dt) = runs
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt))
    assert {"lidar_odometry.txt", "vins_result_no_loop.txt", "fs_loam_loop.txt"} <= set(names)
    for n in names:
        tj, pj, qj = jtum.read_tum(os.path.join(dj, n))
        tt, pt, qt = ttum.read_tum(os.path.join(dt, n))
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(pt, pj, atol=0.02)
        np.testing.assert_allclose(np.abs(np.sum(qt * qj, axis=1)), 1.0, atol=0.01)


def test_pipeline_state_on_requested_device(runs):
    """Every state tensor lives on the pipeline's device (CPU here)."""
    _, _, tp, _ = runs
    tensors = (list(tp.lidar_state) + list(tp.fusion.graph) + list(tp.fusion.scdb)
               + [tp.fusion.clouds, tp.fusion.cloud_valid])
    assert all(x.device == tp.device for x in tensors)


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (7, 0.02)])
def test_sim_scans_bit_identical(seed, noise):
    """The carried numpy simulator gives the JAX package's scans bit for
    bit (points and validity), with and without seeded range noise."""
    for traj_t, traj_j in ((tsim.Trajectory(), jsim.Trajectory()),
                           (tsim.LoopTrajectory(), jsim.LoopTrajectory())):
        R, p = traj_j.rotation(1.7), traj_j.position(1.7)
        np.testing.assert_array_equal(traj_t.rotation(1.7), R)
        np.testing.assert_array_equal(traj_t.position(1.7), p)
        a = jsim.simulate_lidar_scan(jsim.RaycastScene(), R, p, n_scan=16, width=600,
                                     range_noise=noise, seed=seed)
        b = tsim.simulate_lidar_scan(tsim.RaycastScene(), R, p, n_scan=16, width=600,
                                     range_noise=noise, seed=seed)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(tsim.R_to_q(R), jsim.R_to_q(R))


def test_scan_dequantization_exact():
    """int16 fixed point + MSB-first packbits round-trip: the device
    dequantization equals numpy's unpackbits and the quantized points."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-80, 80, (1001, 3)).astype(np.float32)
    val = rng.random(1001) > 0.3
    q16 = np.clip(np.round(pts / 0.0025), -32767, 32767).astype(np.int16)
    packed = np.packbits(val)
    p, v = tpipe._dequant_scan(torch.from_numpy(q16), torch.from_numpy(packed), 0.0025, 1001)
    np.testing.assert_array_equal(v.numpy(), np.unpackbits(packed)[:1001].astype(bool))
    np.testing.assert_array_equal(p.numpy(), q16.astype(np.float32) * np.float32(0.0025))
    assert np.abs(p.numpy() - pts).max() <= 0.0025 / 2 + 1e-5  # half a step + f32 ulps at 80 m


def test_pipeline_modes_and_imu(tmp_path):
    """Modes "vil", "vio" and "lidar" build; only mode="mask" and
    sync_depth > 0 raise (naming ROADMAP.md); push_imu / push_imu_batch
    buffer, and return no IMU-rate pose before the estimator is solved (nor
    ever in LiDAR-only odometry); load_rig reads a rig YAML with the port's
    own reader."""
    rig = TRig(**RIG_KW)
    for kw in (dict(mode="mask"), dict(mode="vil", sync_depth=1), dict(mode="vio", sync_depth=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe.VILFusionPipeline(rig, device="cpu", **kw)
    for mode in ("vil", "vio"):
        p = tpipe.VILFusionPipeline(rig, mode=mode, device="cpu")
        assert p.estimator.cfg.ba.use_lidar == (mode == "vil") and (p.fusion is None) == (mode == "vio")
        assert p.push_imu(0.0, np.zeros(3), np.zeros(3)) is None and len(p.imu_buf) == 1
    pipe = tpipe.VILFusionPipeline(rig, mode="lidar", odom_overrides=ODOM,
                                   gf_cfg=tgf.GlobalFusionConfig(**GF), device="cpu")
    assert pipe.push_imu(0.0, np.zeros(3), np.zeros(3)) is None
    assert pipe.push_imu_batch(np.arange(3) * 0.005, np.zeros((3, 3)), np.zeros((3, 3))) is None
    assert len(pipe.imu_buf) == 4 and pipe.outputs.ts == []
    y = tmp_path / "rig.yaml"
    y.write_text("name: r16\nlidar:\n  n_scan: 16\n  fov_up: 15.0\nglobal_fusion:\n"
                 "  keyframe_meter_gap: 3.0\n")
    r = load_rig(str(y))
    assert (r.name, r.n_scan, r.lidar_fov_up, r.keyframe_meter_gap) == ("r16", 16, 15.0, 3.0)
