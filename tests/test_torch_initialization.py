"""The port's visual-inertial initialization (models/initialization.py)
against vil_fusion_tpu on the simulator's observations (tests/
test_initialization.py's scene: 400 landmarks, frames 0.3 s apart).

The RANSAC's sample indices are drawn with the JAX key the way
vil_fusion_tpu/models/klt.py:240-242 draws them and handed to the port as
`sel`. Tolerances, stated per test: closed-form geometry and the linear
alignments rtol 1e-4 (atol 1e-5); the relative pose and the SfM chain,
which start from an 8-point fundamental matrix that an f32 Cholesky
determines to about 1e-2 in either package (test_torch_vision.py), within
2e-2 of the reference and, as tests/test_initialization.py asks of it,
within 0.02 rad / 0.03 of the ground truth.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import imu as jimu
from vil_fusion_tpu.models import initialization as jinit
from vil_fusion_tpu.models import window as jwin
from vil_fusion_tpu.ops import lie as jlie
from vil_fusion_tpu.runtime import sim
from vil_fusion_tpu_torch.models import initialization as tinit
from vil_fusion_tpu_torch.ops import lie as tlie

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends (the CPU
    backend's JIT is unstable once hundreds of programs accumulate in one
    worker; tests/conftest.py clears after the reference's heavy modules)."""
    yield
    jax.clear_caches()

K = jwin.K
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
FRAME_DT = 0.3


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_sel(key, valid, n_hyp=128):
    """The sample indices as vil_fusion_tpu/models/klt.py:240-242 draws them."""
    u = jax.random.uniform(key, (n_hyp, valid.shape[0]))
    order = jnp.argsort(u - 10.0 * jnp.asarray(valid)[None, :].astype(jnp.float32), axis=1)
    return np.asarray(order[:, :8])


@pytest.fixture(scope="module")
def obs():
    """(F, K, 2) observations + valid of landmarks seen in >= 4 frames, and
    the ground-truth camera rotations / positions."""
    traj = sim.Trajectory()
    world = sim.LandmarkWorld(n=400, seed=0)
    ts = 1.0 + np.arange(K) * FRAME_DT
    f_cap = 160
    o = np.zeros((f_cap, K, 2), np.float32)
    v = np.zeros((f_cap, K), bool)
    per_frame = []
    for t in ts:
        ids, xy, _ = sim.project_landmarks(world, traj.rotation(t), traj.position(t), R_bc=R_BC)
        per_frame.append(dict(zip(ids.tolist(), xy)))
    slot = 0
    for lm in range(400):
        frames = [i for i in range(K) if lm in per_frame[i]]
        if len(frames) < 4 or slot >= f_cap:
            continue
        for i in frames:
            o[slot, i] = per_frame[i][lm]
            v[slot, i] = True
        slot += 1
    Rs = np.stack([traj.rotation(t) @ R_BC for t in ts])
    ps = np.stack([traj.position(t) for t in ts])
    return o, v, Rs, ps


def test_two_view_geometry_matches_reference(obs):
    """triangulate_two_view and decompose_essential at the ground-truth
    essential matrix: depths, cam-2 depths, reprojection errors (rtol 1e-4 /
    atol 1e-5), the same (R, t) up to 1e-5 and the same cheirality score."""
    o, v, Rs, ps = obs
    R = Rs[-1].T @ Rs[0]
    t = Rs[-1].T @ (ps[0] - ps[-1])
    t = (t / np.linalg.norm(t)).astype(np.float32)
    R = R.astype(np.float32)
    both = v[:, 0] & v[:, -1]
    x1, x2 = o[:, 0], o[:, -1]
    outs_j = jinit.triangulate_two_view(jnp.asarray(R), jnp.asarray(t), jnp.asarray(x1),
                                        jnp.asarray(x2))
    outs_t = tinit.triangulate_two_view(_t(R), _t(t), _t(x1), _t(x2))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(_np(a)[both], _np(b)[both], rtol=1e-4, atol=1e-5)
    E = (np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R).astype(np.float32)
    Rj, tj, sj = jinit.decompose_essential(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2),
                                           jnp.asarray(both))
    Rt, tt, st = tinit.decompose_essential(_t(E), _t(x1), _t(x2), _t(both))
    np.testing.assert_allclose(_np(Rt), _np(Rj), atol=1e-5)
    np.testing.assert_allclose(_np(tt), _np(tj), atol=1e-5)
    np.testing.assert_allclose(_np(Rt), R, atol=1e-4)
    assert int(st) == int(sj) == both.sum()


def test_relative_pose_ransac_with_injected_samples(obs):
    """relative_pose_ransac on frames 0 and K-1 with the JAX key's samples:
    inlier masks equal, (R, t) within 2e-2 of the reference's, both within
    0.02 / 0.03 of the ground truth."""
    o, v, Rs, ps = obs
    both = v[:, 0] & v[:, -1]
    key = jax.random.PRNGKey(1)
    Rj, tj, inl_j, nj = jinit.relative_pose_ransac(jnp.asarray(o[:, 0]), jnp.asarray(o[:, -1]),
                                                   jnp.asarray(both), key)
    Rt, tt, inl_t, nt = tinit.relative_pose_ransac(_t(o[:, 0]), _t(o[:, -1]), _t(both),
                                                   sel=_t(_jax_sel(key, both)))
    np.testing.assert_array_equal(_np(inl_t), _np(inl_j))
    np.testing.assert_allclose(_np(Rt), _np(Rj), atol=2e-2)
    np.testing.assert_allclose(_np(tt), _np(tj), atol=2e-2)
    R_gt = Rs[-1].T @ Rs[0]
    t_gt = Rs[-1].T @ (ps[0] - ps[-1])
    np.testing.assert_allclose(_np(Rt), R_gt, atol=0.02)
    np.testing.assert_allclose(_np(tt), t_gt / np.linalg.norm(t_gt), atol=0.03)
    assert int(nt) > 20


def test_pnp_gn_matches_reference(obs):
    """10 Gauss-Newton steps of PnP for frame 5 from a perturbed start,
    against the exact landmarks: pose within 1e-4 of the reference's (and
    1e-3 of the truth)."""
    o, v, Rs, ps = obs
    i = 5
    # landmarks in the world from frame 0's truth + the depth along frame 0's rays
    traj = sim.Trajectory()
    world = sim.LandmarkWorld(n=400, seed=0)
    ids, xy, z = sim.project_landmarks(world, traj.rotation(1.0 + i * FRAME_DT),
                                       traj.position(1.0 + i * FRAME_DT), R_bc=R_BC)
    pts = world.points[ids].astype(np.float32)
    valid = np.ones(len(ids), np.float32)
    q_gt = sim.R_to_q(Rs[i]).astype(np.float32)
    q0 = jlie.qnormalize(jnp.asarray(q_gt) + jnp.asarray([0.0, 0.01, -0.02, 0.01]))
    p0 = ps[i].astype(np.float32) + np.array([0.1, -0.05, 0.08], np.float32)
    qj, pj, rj = jinit.pnp_gn(jnp.asarray(pts), jnp.asarray(xy.astype(np.float32)),
                              jnp.asarray(valid), q0, jnp.asarray(p0))
    qt, pt, rt = tinit.pnp_gn(_t(pts), _t(xy.astype(np.float32)), _t(valid), _t(q0), _t(p0))
    np.testing.assert_allclose(_np(qt), _np(qj), atol=1e-4)
    np.testing.assert_allclose(_np(pt), _np(pj), atol=1e-4)
    np.testing.assert_allclose(_np(pt), ps[i], atol=1e-3)
    assert _np(rt).max() < 1e-4


def test_global_sfm_matches_reference(obs):
    """The whole SfM (baseline frame, relative pose with the JAX key's
    samples, PnP chain, GN + re-triangulation rounds): same baseline frame
    and success, rotations within 2e-2 rad of the reference's, positions
    within 2e-2 of its unit-baseline scale; the port's rotations within
    0.02 rad of the truth (test_initialization.py)."""
    o, v, Rs, ps = obs
    key = jax.random.PRNGKey(0)
    sfm_j, _, _ = jinit.global_sfm(jnp.asarray(o), jnp.asarray(v), key)
    l = int(sfm_j.l_frame)
    both = v[:, l] & v[:, K - 1]
    sfm_t, pts_t, ok_t = tinit.global_sfm(_t(o), _t(v), sel=_t(_jax_sel(key, both)))
    assert sfm_t.l_frame == l and bool(sfm_t.ok) and bool(sfm_j.ok)
    dq = jlie.qmul(jlie.qconj(sfm_j.q), jnp.asarray(_np(sfm_t.q)))
    assert float(jnp.linalg.norm(jlie.so3_log(dq), axis=-1).max()) < 2e-2
    np.testing.assert_allclose(_np(sfm_t.p), _np(sfm_j.p), atol=2e-2)
    for i in range(K):
        R_rel = Rs[l].T @ Rs[i]
        R_est = _np(tlie.q2R(sfm_t.q[i])).astype(np.float64)
        ang = np.arccos(np.clip((np.trace(R_est @ R_rel.T) - 1) / 2, -1, 1))
        assert ang < 0.02, (i, ang)
    assert int(ok_t.sum()) > 50


@pytest.fixture(scope="module")
def align():
    """Preintegrated 0.2 s segments along the trajectory, camera positions
    at 1/4 metric scale (tic = 0), and the metric body-frame relative
    translations a lidar odometry would measure."""
    traj = sim.Trajectory()
    ts = 1.0 + np.arange(K) * 0.2
    q_b = np.stack([sim.R_to_q(traj.rotation(t)) for t in ts]).astype(np.float32)
    p_c = np.stack([0.25 * traj.position(t) for t in ts]).astype(np.float32)
    dp, dv, dts, dq, jq = [np.zeros(3)], [np.zeros(3)], [0.0], [np.array([1.0, 0, 0, 0])], \
        [np.zeros((3, 3))]
    lidar_rel = [np.zeros(3)]
    bg = np.array([0.01, -0.02, 0.015])
    for i in range(1, K):
        t_s, acc, gyr = sim.simulate_imu(traj, ts[i - 1], ts[i], 200.0, bias_g=bg)
        pre = jimu.preintegrate(jnp.asarray(acc, jnp.float32), jnp.asarray(gyr, jnp.float32),
                                jnp.asarray(np.diff(t_s), jnp.float32), jnp.zeros(3),
                                jnp.zeros(3))
        dp.append(pre.dp), dv.append(pre.dv), dts.append(pre.dt_sum), dq.append(pre.dq)
        jq.append(pre.jac[3:6, 12:15])
        lidar_rel.append(traj.rotation(ts[i - 1]).T @ (traj.position(ts[i])
                                                        - traj.position(ts[i - 1])))
    f32 = lambda xs: np.stack([np.asarray(x, np.float32) for x in xs])  # noqa: E731
    return dict(q_b=q_b, p_c=p_c, dp=f32(dp), dv=f32(dv), dt=f32(dts), dq=f32(dq), jq=f32(jq),
                lidar=f32(lidar_rel), valid=np.ones(K, bool), tic=np.zeros(3, np.float32), bg=bg)


def _both(fn_j, fn_t, *args):
    return fn_j(*(jnp.asarray(a) for a in args)), fn_t(*(_t(a) for a in args))


def test_gyro_bias_and_alignments_match_reference(align):
    """solve_gyro_bias (atol 1e-6, and 2e-3 of the true bias),
    linear_alignment, linear_alignment_fixed_scale and refine_gravity
    (both with a free and with a fixed scale): velocities, gravity and scale
    rtol 1e-4 / atol 1e-5 of the reference's."""
    a = align
    qic = sim.R_to_q(R_BC).astype(np.float32)
    q_cam = _np(tlie.qmul(_t(a["q_b"]), _t(qic)[None, :]))
    dbg_j, dbg_t = _both(jinit.solve_gyro_bias, tinit.solve_gyro_bias, q_cam, qic, a["dq"],
                         a["jq"], a["valid"])
    np.testing.assert_allclose(_np(dbg_t), _np(dbg_j), atol=1e-6)
    np.testing.assert_allclose(_np(dbg_t), a["bg"], atol=2e-3)

    common = (a["q_b"], a["p_c"], a["dp"], a["dv"], a["dt"], a["valid"], a["tic"])
    out_j, out_t = _both(jinit.linear_alignment, tinit.linear_alignment, *common)
    for x, y in zip(out_t, out_j):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(out_t[2]), 4.0, rtol=0.02)
    g0 = _np(out_j[1])
    ref_j, ref_t = _both(jinit.refine_gravity, tinit.refine_gravity, *common, g0)
    for x, y in zip(ref_t, ref_j):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-5)

    s_j, n_j = jinit.lidar_scale_estimate(a["p_c"], a["lidar"], a["valid"])
    s_t, n_t = tinit.lidar_scale_estimate(_t(a["p_c"]), _t(a["lidar"]), _t(a["valid"]))
    assert (s_t, n_t) == (s_j, n_j) and n_t >= 3
    s = np.float32(s_t)
    fix_j, fix_t = _both(jinit.linear_alignment_fixed_scale, tinit.linear_alignment_fixed_scale,
                         *common, s)
    for x, y in zip(fix_t, fix_j):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-5)
    rj = jinit.refine_gravity(*(jnp.asarray(c) for c in common), jnp.asarray(_np(fix_j[1])),
                              s_fixed=jnp.float32(s))
    rt = tinit.refine_gravity(*(_t(c) for c in common), _t(_np(fix_j[1])), s_fixed=_t(s))
    for x, y in zip(rt, rj):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(rt[0]), sim.GRAVITY, atol=0.08)


def test_initial_ex_rotation_matches_reference():
    """Camera-IMU rotation from 30 rotation pairs: the nullspace quaternion
    (sign fixed) within 1e-5 of the reference's and 1e-3 rad of the truth."""
    rng = np.random.default_rng(3)
    qic = jnp.asarray(sim.R_to_q(R_BC), jnp.float32)
    th = rng.uniform(-0.3, 0.3, (30, 3)).astype(np.float32)
    q_imu = jlie.so3_exp(jnp.asarray(th))
    q_cam = jlie.qmul(jlie.qmul(jlie.qconj(qic)[None], q_imu), qic[None])
    qj = jinit.initial_ex_rotation(q_cam, q_imu, 30)
    qt = tinit.initial_ex_rotation(_t(q_cam), _t(q_imu), 30)
    np.testing.assert_allclose(_np(qt), _np(qj), atol=1e-5)
    np.testing.assert_allclose(_np(qt), _np(qic), atol=1e-3)
