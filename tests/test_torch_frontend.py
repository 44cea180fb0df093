"""The slice as a whole: the port's `vil_front_end` over three small frames
against the JAX package's tracker, lidar odometry, extrinsic glue and depth
association called in the order of its frame program.

16-ring scans and 160 x 120 images come from the numpy simulator (the
port's copy renders the images; it is bit-identical to the JAX package's).
The RANSAC samples are drawn with the JAX key and injected into the port.
On the CPU the JAX package runs its exact XLA kNN, so the port runs
approx_knn=False here. The rig's RANSAC threshold is 3 virtual pixels: with
35 tracks at this image size the hypotheses' inlier counts nearly tie at 1
px, and which one wins then depends on f32 rounding (the RANSAC's own parity
is tested at full threshold in test_torch_vision.py). Tolerances are stated
in the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import depth_association as jda
from vil_fusion_tpu.models import klt as jklt
from vil_fusion_tpu.models import lidar_odometry as jlo
from vil_fusion_tpu.models import tracker as jtrk
from vil_fusion_tpu.runtime import sim as jsim
from vil_fusion_tpu.runtime.config import RigConfig as JRig
from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline as JPipeline
from vil_fusion_tpu_torch.models import lidar_odometry as tlo
from vil_fusion_tpu_torch.models import tracker as ttrk
from vil_fusion_tpu_torch.runtime import pipeline as tpipe
from vil_fusion_tpu_torch.runtime import sim as tsim
from vil_fusion_tpu_torch.runtime.config import RigConfig as TRig
from vil_fusion_tpu_torch.utils import state_io

torch.set_num_threads(2)

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
QUANT = 0.0025


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def frames():
    """Three frames at 10 Hz along the simulator's trajectory at 4 m/s:
    uint8 image, int16 fixed-point scan with bit-packed validity."""
    scene = tsim.RaycastScene()
    traj = tsim.Trajectory(tsim.TrajectoryConfig(speed=4.0))
    out = []
    for k in range(3):
        t = 1.0 + 0.1 * k
        R, p = traj.rotation(t), traj.position(t) + np.array([0, 0, 1.5])
        img = tsim.render_camera_image(scene, R @ R_BC, p, F, F, W / 2, H / 2, H, W)
        pts, val = tsim.simulate_lidar_scan(scene, R, p, n_scan=16, width=900, fov_up_deg=15.0,
                                            fov_down_deg=-15.0, max_range=80.0, seed=k)
        pts16 = np.clip(np.round(pts / QUANT), -32767, 32767).astype(np.int16)
        out.append((t, (np.clip(img, 0, 1) * 255).astype(np.uint8), pts16, np.packbits(val),
                    len(val)))
    return out


def test_front_end_config_matches_reference():
    """front_end_config derives the same tracker and lidar configurations,
    camera model and composed extrinsics (atol 1e-6) as the JAX pipeline's
    constructor; the pipeline class still refuses the modes that need the
    estimator."""
    jp = JPipeline(JRig(**RIG_KW), mode="vil", f_cap=64, odom_overrides=ODOM, scan_quant=QUANT)
    fe = tpipe.front_end_config(TRig(**RIG_KW), f_cap=64, odom_overrides=ODOM, scan_quant=QUANT,
                                device="cpu")
    assert fe.tcfg._asdict() == jp.tracker_cfg._asdict()
    assert fe.lcfg.lidar._asdict() == jp.lidar_cfg.lidar._asdict()
    for k, v in jp.lidar_cfg._asdict().items():
        assert k == "lidar" or getattr(fe.lcfg, k) == v, k
    assert fe.cam._asdict() == jp.cam._asdict()
    assert state_io.camera_to_torch(jp.cam) == fe.cam
    for name in ("q_il", "t_il", "q_li", "t_li", "q_cl", "t_cl"):
        np.testing.assert_allclose(getattr(fe, name).numpy(), np.asarray(getattr(jp, name)),
                                   atol=1e-6, err_msg=name)
    assert fe.tsh_scale == pytest.approx(0.02 / H) and fe.min_incidence == pytest.approx(0.1)
    assert tpipe.frame_seed(1.2345678) == 1234
    for mode in ("vil", "vio", "mask"):
        with pytest.raises(NotImplementedError, match="estimator"):
            tpipe.VILFusionPipeline(TRig(**RIG_KW), mode=mode, device="cpu")


def test_vil_front_end_three_frames(frames):
    """Frame by frame, the port's vil_front_end against the JAX package's
    track_step + odometry_step + _lidar_glue + feature_depth: feature ids,
    valid masks equal; pixels within 0.05 px, normalized coordinates within
    5e-4 (0.05 px / 100 px focal), velocities within 1.5e-2 (that over 0.1 s,
    tripled); lidar pose and the IMU-frame relative pose within 5e-3 m and
    1e-3 in the quaternion (each side runs its own chain of cold
    registrations of a 16-ring scan, a few hundred correspondences, so f32
    differences are amplified as in test_torch_pipeline.py's 6.3 mm; one
    step from identical maps agrees to 1e-4 m, test_torch_lidar_modes.py);
    depth flags (invalid / weak / strong) equal
    and depths within 2e-3 m on at least 95% of the features that have one
    (a 0.05 px ray shift can change one of the 3 neighbours); the readout
    shift within 1e-5 s; the dequantized cloud identical."""
    jp = JPipeline(JRig(**RIG_KW), mode="vil", f_cap=64, odom_overrides=ODOM, scan_quant=QUANT)
    fe = tpipe.front_end_config(TRig(**RIG_KW), f_cap=64, odom_overrides=ODOM, scan_quant=QUANT,
                                device="cpu")
    jts, jls = jp.tracker_state, jp.lidar_state
    tts = ttrk.init_tracker(H, W, fe.tcfg, device="cpu")
    tls = tlo.init_state(fe.lcfg, device="cpu")
    n_depth = 0
    for k, (t, img, pts16, val8, n) in enumerate(frames):
        # --- JAX, in the order of _vil_frame_program ---
        key = jax.random.PRNGKey(tpipe.frame_seed(t))
        jpts = jnp.asarray(pts16).astype(jnp.float32) * QUANT
        jval = jnp.asarray(np.unpackbits(val8)[:n].astype(bool))
        sel = _ransac_sel(jts, img, jp.tracker_cfg, key) if k > 0 else None
        jts, obs = jtrk.track_step(jts, jnp.asarray(img), jnp.float32(t), jp.cam, jp.tracker_cfg,
                                   key=key)
        jls, (lq, lp, lqr, lpr) = jlo.odometry_step(jls, jpts, jval, jp.lidar_cfg)
        q_imu, p_imu, cloud_cam = jp._lidar_glue(lqr, lpr, jpts, jp.q_il, jp.t_il, jp.q_li,
                                                 jp.t_li, jp.q_cl, jp.t_cl)
        depth, _ = jda.feature_depth(obs["xy"], obs["valid"], cloud_cam, jval,
                                     min_incidence=jp.rig.depth_min_incidence)
        tsh = (0.02 / H) * (np.asarray(obs["uv"])[:, 1] - 0.5 * H)
        # --- the port ---
        tts, tls, out = tpipe.vil_front_end(tts, tls, _t(img), _t(pts16), _t(val8), t, fe,
                                            frame_index=k, sel=sel)
        np.testing.assert_array_equal(out["pts"].numpy(), np.asarray(jpts))
        np.testing.assert_array_equal(out["val"].numpy(), np.asarray(jval))
        np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(obs["ids"]))
        v = np.asarray(obs["valid"])
        np.testing.assert_array_equal(out["valid"].numpy(), v)
        np.testing.assert_allclose(out["uv"].numpy()[v], np.asarray(obs["uv"])[v], atol=0.05)
        np.testing.assert_allclose(out["xy"].numpy()[v], np.asarray(obs["xy"])[v], atol=5e-4)
        np.testing.assert_allclose(out["vel"].numpy()[v], np.asarray(obs["vel"])[v], atol=1.5e-2)
        np.testing.assert_allclose(out["tsh"].numpy()[v], tsh[v], atol=1e-5)
        for a, b, tol in ((out["lidar_p"], lp, 5e-3), (out["lidar_q"], lq, 1e-3),
                          (out["p_imu"], p_imu, 5e-3), (out["q_imu"], q_imu, 1e-3)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
        d_t, d_j = out["depth"].numpy(), np.asarray(depth)
        np.testing.assert_array_equal(np.sign(d_t[v]), np.sign(d_j[v]))
        has = v & (d_j != -1.0)
        if has.any():
            assert (np.abs(d_t[has] - d_j[has]) < 2e-3).mean() >= 0.95
        n_depth += int(has.sum())
        assert int(tls.frame_count) == k + 1 and bool(tts.initialized)
    assert v.sum() >= 25 and (np.asarray(obs["track_cnt"])[v] > 1).sum() >= 15
    assert n_depth >= 15  # lidar depth really reached features
    assert np.linalg.norm(out["lidar_p"].numpy()) > 0.5  # and the sensor really moved


def test_vil_front_end_reads_device_counters_and_seeds_itself(frames):
    """Without a host frame index the front end reads both states' device
    counters (first frame: no tracking, no registration), and without
    injected samples it seeds its own generator from the timestamp, so two
    runs give identical results."""
    fe = tpipe.front_end_config(TRig(**RIG_KW), f_cap=64, odom_overrides=ODOM, scan_quant=QUANT,
                                device="cpu")
    runs = []
    for _ in range(2):
        tts = ttrk.init_tracker(H, W, fe.tcfg, device="cpu")
        tls = tlo.init_state(fe.lcfg, device="cpu")
        for t, img, pts16, val8, _n in frames[:2]:
            tts, tls, out = tpipe.vil_front_end(tts, tls, _t(img), _t(pts16), _t(val8), t, fe)
        runs.append(out)
    for name in ("ids", "uv", "depth", "lidar_p", "q_imu"):
        assert torch.equal(runs[0][name], runs[1][name]), name
    assert int(tls.frame_count) == 2 and (runs[0]["ids"] >= 0).sum() >= 25
    assert torch.isfinite(runs[0]["lidar_p"]).all()


def _ransac_sel(state, img, cfg, key):
    """The (128, 8) sample indices the JAX track_step draws in this frame:
    its fit mask (tracked & inside the border) recomputed with the JAX
    package's own functions, then klt.py:240-242's biased permutation."""
    imgf = jnp.asarray(img).astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    pts2, status = jklt.track_pyramidal(state.prev_img, imgf, state.xy, state.valid)
    inb = ((pts2[:, 0] >= 1) & (pts2[:, 0] < W - 2) & (pts2[:, 1] >= 1) & (pts2[:, 1] < H - 2))
    valid = status & state.valid & inb
    u = jax.random.uniform(key, (128, cfg.cap))
    order = jnp.argsort(u - 10.0 * valid[None, :].astype(jnp.float32), axis=1)
    return _t(np.asarray(order[:, :8]))
