"""The port's estimator (models/estimator.py) against vil_fusion_tpu: the
per-frame steps on carried state, one fused frame step from a carried
steady state, and the end-to-end check of the estimator slice: an
oracle-initialized LandmarkWorld sequence of K + 4 frames through both
packages' VILEstimator.process_frame with identical observations, held
frame by frame (keyframe decision, so the marginalized frame; every window
slot; failure flags).

Tolerances: feature bookkeeping exact; triangulated inverse depths rtol
1e-4 (inverse iteration on an f32 Cholesky); landmarks and the gauge
transform rtol 1e-5 / atol 1e-5; poses within 1e-3 m / 1e-3 rad
(optimize()'s tolerance in test_torch_ba.py), velocities within 1e-2 m/s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_estimator_problem import make_problem, np_, perturb, to_port

from vil_fusion_tpu.models import ba as jba
from vil_fusion_tpu.models import estimator as jest
from vil_fusion_tpu.ops import lie as jlie
from vil_fusion_tpu.runtime import sim
from vil_fusion_tpu_torch.models import ba as tba
from vil_fusion_tpu_torch.models import estimator as test_
from vil_fusion_tpu_torch.models import window as twin
from vil_fusion_tpu_torch.utils import state_io

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends (the CPU
    backend's JIT is unstable once hundreds of programs accumulate in one
    worker; tests/conftest.py clears after the reference's heavy modules)."""
    yield
    jax.clear_caches()

K = twin.K
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
FRAME_DT = 0.1
F_CAP, OBS_CAP, FEATS_PER_FRAME = 48, 64, 40
N_FRAMES = K + 4


def _select_tracked(ids, prev_ids, cap=FEATS_PER_FRAME):
    """The tracker's budget with track continuity (tests/test_estimator.py)."""
    prev = [i for i in ids if i in prev_ids]
    keep = set((prev + [i for i in ids if i not in prev_ids])[:cap])
    return np.array([i in keep for i in ids])


def _bundles(n_frames=N_FRAMES, seed=0, frame_dt=FRAME_DT, with_lidar=True, lidar_frac=0.6):
    """Per-frame inputs of process_frame along sim.Trajectory: IMU segment,
    budgeted landmark observations with LiDAR depth on `lidar_frac` of them,
    exact LiDAR relative pose."""
    rng = np.random.default_rng(seed)
    traj = sim.Trajectory()
    world = sim.LandmarkWorld(n=400, seed=seed)
    out, prev = [], set()
    for i in range(n_frames):
        t = 1.0 + i * frame_dt
        if i == 0:
            acc = gyr = np.zeros((0, 3))
            dts = np.zeros((0,))
        else:
            ts_i, acc, gyr = sim.simulate_imu(traj, t - frame_dt, t, 200.0)
            dts = np.diff(ts_i)
        ids, xy, z = sim.project_landmarks(world, traj.rotation(t), traj.position(t), R_bc=R_BC)
        keep = _select_tracked(ids.tolist(), prev)
        ids, xy, z = ids[keep], xy[keep], z[keep]
        prev = set(ids.tolist())
        depth = np.where(rng.random(len(ids)) < lidar_frac, z, 0.0)
        lq = lp = None
        if with_lidar and i > 0:
            (qa, pa), (qb, pb) = traj.pose(t - frame_dt), traj.pose(t)
            qr, pr = jlie.pose_between((jnp.asarray(qa, jnp.float32), jnp.asarray(pa, jnp.float32)),
                                       (jnp.asarray(qb, jnp.float32), jnp.asarray(pb, jnp.float32)))
            lq, lp = np.asarray(qr), np.asarray(pr)
        out.append(dict(args=(acc, gyr, dts, ids, xy),
                        kw=dict(obs_depth=depth, lidar_q_rel=lq, lidar_p_rel=lp),
                        gt=traj.pose(t)))
    return out


def _estimators(use_lidar=True):
    jc = jest.EstimatorConfig(ba=jba.BAConfig(use_lidar=use_lidar), f_cap=F_CAP, obs_cap=OBS_CAP)
    tc = test_.EstimatorConfig(ba=tba.BAConfig(use_lidar=use_lidar), f_cap=F_CAP,
                               obs_cap=OBS_CAP)
    je, te = jest.VILEstimator(jc), test_.VILEstimator(tc, device="cpu")
    for e in (je, te):
        e.set_extrinsics(qic=sim.R_to_q(R_BC), tic=np.zeros(3))
    return je, te


class _KeyRecorder:
    """Records the JAX estimator's concrete keyframe decisions (the fused
    step's output and the host path's keyframe_decision)."""

    def __init__(self, mp):
        self.keys = []
        fused, decide = jest.fused_full_step, jest.keyframe_decision

        def fused_rec(*a, **kw):
            out = fused(*a, **kw)
            self.keys.append(bool(out[-1]["is_key"]))
            return out

        def decide_rec(*a, **kw):
            v = decide(*a, **kw)
            if not isinstance(v, jax.core.Tracer):
                self.keys.append(bool(v))
            return v

        mp.setattr(jest, "fused_full_step", fused_rec)
        mp.setattr(jest, "keyframe_decision", decide_rec)


@pytest.fixture(scope="module")
def seq():
    """Both estimators, oracle-initialized at frame 0, over N_FRAMES
    identical bundles; per frame the returned poses, keyframe decisions,
    windows and failure flags."""
    bundles = _bundles()
    je, te = _estimators()
    q0, p0 = bundles[0]["gt"]
    for e in (je, te):
        e.set_initial_state(p=p0, q=q0, v=sim.Trajectory().velocity(1.0))
    rec = []
    with pytest.MonkeyPatch.context() as mp:
        keys = _KeyRecorder(mp)
        for b in bundles:
            n_keys = len(keys.keys)
            pj = je.process_frame(*b["args"], **b["kw"])
            pt = te.process_frame(*b["args"], **b["kw"])
            rec.append(dict(pj=pj, pt=pt, key_j=keys.keys[n_keys] if len(keys.keys) > n_keys
                            else None, key_t=te.last_is_key,
                            wj=state_io.to_numpy(je.window), wt=state_io.to_numpy(te.window),
                            failed=(je.failed, te.failed), gt=b["gt"]))
    return bundles, je, te, rec


def _rot_err(q1, q2):
    dq = jlie.qmul(jlie.qconj(jnp.asarray(q1, jnp.float32)), jnp.asarray(q2, jnp.float32))
    return float(jnp.max(jnp.linalg.norm(jlie.so3_log(dq), axis=-1)))


def test_sequence_matches_reference_frame_by_frame(seq):
    """K + 4 frames: the filling phase, then 5 fused steps. Keyframe
    decisions equal frame by frame (so the same frame is marginalized),
    every window slot's pose within 1e-3 m / 1e-3 rad and velocity within
    1e-2 m/s, no failure in either package, the port within 0.05 m of the
    ground truth; the port ran the fused step on every steady frame."""
    _, je, te, rec = seq
    assert te.fused_steps == N_FRAMES - (K - 1)
    steady = rec[K - 1:]
    assert [r["key_t"] for r in steady] == [r["key_j"] for r in steady]
    assert any(r["key_t"] for r in steady) and not all(r["key_t"] for r in steady)
    for i, r in enumerate(rec):
        assert r["failed"] == (False, False), i
        np.testing.assert_allclose(r["pt"][0], r["pj"][0], atol=1e-3, err_msg=str(i))
        assert _rot_err(r["pt"][1], r["pj"][1]) < 1e-3, i
        np.testing.assert_allclose(r["wt"]["p"], r["wj"]["p"], atol=1e-3, err_msg=str(i))
        np.testing.assert_allclose(r["wt"]["v"], r["wj"]["v"], atol=1e-2, err_msg=str(i))
        assert _rot_err(r["wt"]["q"], r["wj"]["q"]) < 1e-3, i
        assert np.linalg.norm(r["pt"][0] - r["gt"][1]) < 0.05, i


def test_fused_step_from_carried_state(seq):
    """The JAX estimator's steady state carried into a fresh port estimator
    (utils/state_io.estimator_load); one more frame through both: pose,
    cost, keyframe decision, failure mask, and the next window within
    1e-4 m / 1e-4 rad; the marginal prior's J^T J and J^T r0 within 1e-2
    of their largest entries (marginalization's f32 floor,
    test_torch_marginalization.py)."""
    bundles, je, _, _ = seq
    nxt = _bundles(N_FRAMES + 1)[-1]
    te = test_.VILEstimator(test_.EstimatorConfig(f_cap=F_CAP, obs_cap=OBS_CAP), device="cpu")
    state_io.estimator_load(te, state_io.estimator_to_numpy(je))
    with pytest.MonkeyPatch.context() as mp:
        keys = _KeyRecorder(mp)
        pj = je.process_frame(*nxt["args"], **nxt["kw"])
    pt = te.process_frame(*nxt["args"], **nxt["kw"])
    assert te.fused_steps == 1 and te.last_is_key == keys.keys[-1]
    np.testing.assert_allclose(pt[0], pj[0], atol=1e-4)
    assert _rot_err(pt[1], pj[1]) < 1e-4
    np.testing.assert_allclose(te.last_cost, je.last_cost, rtol=1e-2, atol=1e-3)
    assert not te.failed and not je.failed
    np.testing.assert_allclose(np_(te.window.p), np_(je.window.p), atol=1e-4)
    for a, b in ((te.prior.J, je.prior.J),):
        Ja, Jb = np_(a).astype(np.float64), np_(b).astype(np.float64)
        for x, y in ((Ja.T @ Ja, Jb.T @ Jb),
                     (Ja.T @ np_(te.prior.r0), Jb.T @ np_(je.prior.r0))):
            assert np.abs(x - y).max() <= 1e-2 * np.abs(y).max()


def test_ingest_keyframe_triangulate_landmarks(seq):
    """On the JAX estimator's final state carried over: ingest_features of
    a frame with matched tracks, new tracks beyond the free slots, lidar
    depths of both signs (exact); keyframe_decision at every slot;
    triangulate with the depths reset (rtol 1e-4); landmarks_world (rtol
    1e-5 / atol 1e-5)."""
    _, je, _, _ = seq
    feats_j = je.feats
    feats_t = to_port("feats", feats_j)
    rng = np.random.default_rng(3)
    ids_live = np.asarray(feats_j.feat_id)[np.asarray(feats_j.active)]
    ids = np.concatenate([ids_live[:20], 1000 + np.arange(30), -np.ones(14, int)]).astype(np.int32)
    xy = rng.normal(0, 0.3, (OBS_CAP, 2)).astype(np.float32)
    vel = rng.normal(0, 0.1, (OBS_CAP, 2)).astype(np.float32)
    dep = np.where(rng.random(OBS_CAP) < 0.5, rng.uniform(3, 20, OBS_CAP),
                   -rng.uniform(3, 20, OBS_CAP)).astype(np.float32)
    tsh = rng.normal(0, 1e-3, OBS_CAP).astype(np.float32)
    for fc in (3, K - 1):
        out_j = jest.ingest_features(feats_j, *(jnp.asarray(x) for x in (ids, xy, vel, dep)),
                                     jnp.int32(fc), jnp.asarray(tsh))
        out_t = test_.ingest_features(feats_t, *(torch.from_numpy(x) for x in (ids, xy, vel, dep)),
                                      fc, torch.from_numpy(tsh))
        for k in twin.FeatureStore._fields:
            np.testing.assert_array_equal(np_(getattr(out_t, k)), np_(getattr(out_j, k)), k)
        for f in range(K):
            assert bool(test_.keyframe_decision(out_t, f)) == bool(
                jest.keyframe_decision(out_j, jnp.int32(f)))

    win_t = to_port("window", je.window)
    reset = feats_j._replace(inv_depth=jnp.where(feats_j.lidar_flag, feats_j.inv_depth, -1.0))
    tri_j = jest.triangulate(je.window, reset)
    tri_t = test_.triangulate(win_t, to_port("feats", reset))
    dj = np_(tri_j.inv_depth)
    assert (dj > 0).sum() > 10
    np.testing.assert_allclose(np_(tri_t.inv_depth), dj, rtol=1e-4)
    lw_j = jest.landmarks_world(je.window, feats_j, jnp.int32(K - 2))
    lw_t = test_.landmarks_world(win_t, feats_t, K - 2)
    for a, b in zip(lw_t, lw_j):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-5)


def test_gauge_transform_matches_reference(seq):
    """gauge_transform (relocalization feedback) of the carried window and
    prior: the moved window and prior Jacobian as in the reference (rtol
    1e-5 / atol 1e-5), and the BA cost unchanged by it (rtol 1e-4, as
    tests/test_estimator.py asks)."""
    _, je, _, _ = seq
    yaw = np.deg2rad(25.0)
    R_d = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]],
                   np.float32)
    t_d = np.array([3.0, -2.0, 0.5], np.float32)
    wj, pj = jest.gauge_transform(je.window, je.prior, jnp.asarray(R_d), jnp.asarray(t_d))
    w0, p0 = to_port("window", je.window), to_port("prior", je.prior)
    wt, pt = test_.gauge_transform(w0, p0, torch.from_numpy(R_d), torch.from_numpy(t_d))
    for k in ("p", "q", "v"):
        np.testing.assert_allclose(np_(getattr(wt, k)), np_(getattr(wj, k)), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(np_(pt.J), np_(pj.J), rtol=1e-5, atol=1e-5)
    args = (to_port("feats", je.feats), to_port("pre", je.pre), to_port("lidar", je.lidar))
    c0 = tba.total_cost(w0, args[0], args[1], args[2], p0, tba.BAConfig())
    c1 = tba.total_cost(wt, args[0], args[1], args[2], pt, tba.BAConfig())
    np.testing.assert_allclose(float(c1), float(c0), rtol=1e-4, atol=1e-3)


def test_failure_detection_and_no_aliasing():
    """failure_detection's bitmask on crafted states, as the reference's;
    the previous pose taken as a view (window.p[K-1], as the reference
    takes it) keeps its value when the window moves, so the position-jump
    predicate still fires; and fused_full_step writes none of its input
    tensors."""
    state_gt, feats, pre, lidar = make_problem()
    w = to_port("window", state_gt)
    prev_p, prev_q = w.p[K - 1], w.q[K - 1]  # views
    moved = w._replace(p=twin.set_row(w.p, K - 1, w.p[K - 1] + torch.tensor([6.0, 0, 1.5])),
                       ba=twin.set_row(w.ba, K - 1, torch.tensor([3.0, 0, 0])))
    mask_t = int(test_.failure_detection(moved, prev_p, prev_q))
    jw = state_gt._replace(p=jnp.asarray(np_(moved.p)), ba=jnp.asarray(np_(moved.ba)))
    mask_j = int(jest.failure_detection(jw, state_gt.p[K - 1], state_gt.q[K - 1]))
    assert mask_t == mask_j == 1 | 4 | 8
    assert test_.decode_failure(mask_t) == ["acc_bias_norm", "position_jump", "z_jump"]
    assert int(test_.failure_detection(w, prev_p, prev_q)) == 0

    st0 = perturb(state_gt)
    ins = [to_port(k, x) for k, x in zip(("window", "feats", "pre", "lidar"),
                                         (st0, feats, pre, lidar))]
    ins.append(tba.empty_prior(ins[0]))
    before = [state_io.to_numpy(x) for x in ins]
    cfg = test_.EstimatorConfig(f_cap=feats.active.shape[0], imu_cap=32, obs_cap=16)
    z = torch.zeros
    _, _, _, _, _, out = test_.fused_full_step(
        *ins, z((32, 3)), z((32, 3)), z(31), 0, torch.full((16,), -1, dtype=torch.int32),
        z((16, 2)), z((16, 2)), z(16), z(16), torch.tensor([1.0, 0, 0, 0]), z(3),
        torch.tensor(False), True, cfg)
    for x, b in zip(ins, before):
        for k, v in state_io.to_numpy(x).items():
            if isinstance(v, dict):
                continue
            np.testing.assert_array_equal(v, b[k], err_msg=k)
    assert set(out) == {"p", "q", "v", "cost", "failed", "is_key"}


@pytest.mark.slow
def test_cold_start_matches_reference():
    """No oracle state, no lidar (vio): both packages self-initialize (SfM
    with the JAX key's RANSAC samples handed to the port, gyro bias,
    alignment) at the same frame and then track within 1e-2 m of each
    other (the cold start's SfM agrees to ~1e-2, test_torch_initialization.py)."""
    from vil_fusion_tpu_torch.models import initialization as tinit

    bundles = _bundles(n_frames=K + 4, seed=11, frame_dt=0.15, with_lidar=False, lidar_frac=0.0)
    je, te = _estimators(use_lidar=False)

    def try_init(sel=None):
        valid = te.feats.obs_valid & te.feats.active[:, None]
        l_dev, _ = tinit._find_baseline_frame(te.feats.obs, valid)
        both = np_(valid[:, int(l_dev)] & valid[:, K - 1])
        u = jax.random.uniform(jax.random.PRNGKey(te.frame_count), (128, both.shape[0]))
        order = jnp.argsort(u - 10.0 * jnp.asarray(both)[None, :].astype(jnp.float32), axis=1)
        return test_.VILEstimator._try_initialize(te, sel=torch.from_numpy(np.asarray(order[:, :8])))

    te._try_initialize = try_init
    init_j = init_t = None
    for i, b in enumerate(bundles):
        pj = je.process_frame(*b["args"], **b["kw"])
        pt = te.process_frame(*b["args"], **b["kw"])
        if je.initialized and init_j is None:
            init_j = i
        if te.initialized and init_t is None:
            init_t = i
        if init_t is not None and init_j is not None:
            np.testing.assert_allclose(pt[0], pj[0], atol=1e-2)
    assert init_j is not None and init_t == init_j
    assert not je.failed and not te.failed
