"""runtime/checkpoint.py of the port against vil_fusion_tpu's: an estimator
or global-fusion npz written by either package loads into the other with
every array equal (keys, dtypes, values), and the loaded state takes the
same next step as the state carried directly (utils/state_io), bit for
bit. The estimator's window is tests/torch_estimator_problem.py's
perturbed window with a random marginal prior; global fusion holds three
keyframes of random clouds (tests/test_checkpoint.py's case).
"""
import jax.numpy as jnp
import numpy as np
import torch

from vil_fusion_tpu.models import ba as jba
from vil_fusion_tpu.models import estimator as jest
from vil_fusion_tpu.models import global_fusion as jgf
from vil_fusion_tpu.runtime import checkpoint as jck
from vil_fusion_tpu_torch.models import estimator as test_
from vil_fusion_tpu_torch.models import global_fusion as tgf
from vil_fusion_tpu_torch.runtime import checkpoint as tck
from vil_fusion_tpu_torch.utils import state_io

from torch_estimator_problem import K, make_problem, perturb

torch.set_num_threads(2)
F_CAP, IMU_CAP, OBS_CAP = 32, 32, 16
GF = dict(node_capacity=64, loop_capacity=8, cloud_capacity=128)


def _assert_same(a: dict, b: dict, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k], f"{path}{k}.")
        elif isinstance(a[k], list):
            assert len(a[k]) == len(b[k]), path + k
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=path + k)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.asarray(b[k]).dtype, path + k
            np.testing.assert_array_equal(a[k], b[k], err_msg=path + k)
        else:
            assert a[k] == b[k], path + k


def _jax_estimator():
    state, feats, pre, lidar = make_problem(f_cap=F_CAP, imu_cap=IMU_CAP)
    est = jest.VILEstimator(jest.EstimatorConfig(f_cap=F_CAP, imu_cap=IMU_CAP, obs_cap=OBS_CAP))
    window = perturb(state)
    rng = np.random.default_rng(4)
    D = est.prior.J.shape[0]
    est.window, est.feats, est.pre, est.lidar = window, feats, pre, lidar
    est.prior = jba.MargPrior(J=jnp.asarray(rng.normal(0, 0.1, (D, D)), jnp.float32),
                              r0=jnp.asarray(rng.normal(0, 0.1, D), jnp.float32),
                              lin=perturb(state, seed=2), valid=jnp.asarray(True))
    est.frame_count, est.initialized = K - 1, True
    return est


def _port_estimator():
    est = test_.VILEstimator(test_.EstimatorConfig(f_cap=F_CAP, imu_cap=IMU_CAP,
                                                   obs_cap=OBS_CAP), device="cpu")
    est.set_extrinsics(qic=[1.0, 0, 0, 0], tic=np.zeros(3))
    return est


def _step(est):
    """One steady frame with fixed inputs: (p, q, v) and the next window."""
    rng = np.random.default_rng(7)
    n = 21
    acc = np.tile([0.0, 0.0, 9.81], (n, 1)) + rng.normal(0, 0.01, (n, 3))
    gyr = rng.normal(0, 0.01, (n, 3))
    ids = np.arange(12)
    xy = rng.uniform(-0.3, 0.3, (12, 2))
    out = est.process_frame(acc, gyr, np.full(n - 1, 0.005), ids, xy,
                            obs_depth=np.where(ids % 2 == 0, 8.0, 0.0))
    return out, state_io.to_numpy(est.window)


def test_estimator_checkpoint_across_packages(tmp_path):
    je = _jax_estimator()
    ref = state_io.estimator_to_numpy(je)
    p_jax, p_port = str(tmp_path / "jax_est.npz"), str(tmp_path / "port_est.npz")
    jck.save_estimator(je, p_jax)
    te = tck.load_estimator(_port_estimator(), p_jax)
    _assert_same(state_io.estimator_to_numpy(te), ref)
    tck.save_estimator(te, p_port)
    assert sorted(np.load(p_port).files) == sorted(np.load(p_jax).files)
    je2 = jck.load_estimator(jest.VILEstimator(je.cfg), p_port)
    _assert_same(state_io.estimator_to_numpy(je2), ref)
    # the next step: loaded from the reference's file, from the port's own
    # file, and carried directly
    carried = state_io.estimator_load(_port_estimator(), ref)
    own = tck.load_estimator(_port_estimator(), p_port)
    (pose_a, win_a), (pose_b, win_b), (pose_c, win_c) = (_step(e) for e in (te, own, carried))
    for x, y in ((pose_a, pose_c), (pose_b, pose_c)):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    _assert_same(win_a, win_c)
    _assert_same(win_b, win_c)
    assert te.fused_steps == 1 and np.isfinite(pose_a[0]).all()


def _clouds(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(256, 3)) * 10).astype(np.float32) for _ in range(n)]


def test_global_fusion_checkpoint_across_packages(tmp_path):
    clouds = _clouds(5)
    jf = jgf.GlobalFusion(jgf.GlobalFusionConfig(**GF))
    for i in range(3):
        jf.add_frame(np.array([1.0, 0, 0, 0]), np.array([3.0 * i, 0, 0]), clouds[i],
                     np.ones(256, bool), t=1.0 + i)
    jf.flush()
    ref = state_io.global_fusion_to_numpy(jf)
    p_jax, p_port = str(tmp_path / "jax_gf.npz"), str(tmp_path / "port_gf.npz")
    jck.save_global_fusion(jf, p_jax)
    tf = tck.load_global_fusion(tgf.GlobalFusion(tgf.GlobalFusionConfig(**GF), device="cpu"),
                                p_jax)
    got = state_io.global_fusion_to_numpy(tf)
    for k in ("graph", "scdb", "clouds", "cloud_valid", "kf_q_odom", "kf_p_odom", "kf_ts",
              "n_kf", "loops_found"):
        _assert_same({k: got[k]}, {k: ref[k]})
    np.testing.assert_array_equal(tf.last_p, np.asarray(jf.last_p))
    tck.save_global_fusion(tf, p_port)
    assert sorted(np.load(p_port).files) == sorted(np.load(p_jax).files)
    jf2 = jck.load_global_fusion(jgf.GlobalFusion(jgf.GlobalFusionConfig(**GF)), p_port)
    got = state_io.global_fusion_to_numpy(jf2)
    for k in ("graph", "scdb", "clouds", "cloud_valid", "n_kf", "kf_ts", "loops_found"):
        _assert_same({k: got[k]}, {k: ref[k]})
    # the next frames: the keyframe gate's state came along (a frame at the
    # last saved pose is not a keyframe, the one after is), and the loaded
    # and the directly carried port states add the same keyframe
    carried = state_io.global_fusion_load(
        tgf.GlobalFusion(tgf.GlobalFusionConfig(**GF), device="cpu"), ref)
    for f in (tf, carried):
        pts = torch.from_numpy(clouds[3])
        ok = torch.ones(256, dtype=torch.bool)
        f.add_frame(np.array([1.0, 0, 0, 0]), np.array([6.0, 0, 0]), pts, ok)
        assert f.n_kf == 3
        f.add_frame(np.array([1.0, 0, 0, 0]), np.array([9.0, 0, 0]), torch.from_numpy(clouds[4]),
                    ok, t=5.0)
        f.flush()
        assert f.n_kf == 4
    a, b = (state_io.global_fusion_to_numpy(f) for f in (tf, carried))
    for d in (a, b):  # the relaxation counter is not checkpointed (nor in the reference)
        del d["_pending_opt"]
    _assert_same(a, b)
