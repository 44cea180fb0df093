"""The port's window, factors and bundle adjustment (models/window.py,
factors.py, ba.py) against vil_fusion_tpu on the same simulator window
(tests/torch_estimator_problem.py: 32 feature slots, 32-sample IMU
segments), carried to the port with utils/state_io.

Tolerances: factor residuals rtol 1e-5 (atol 1e-5 of the largest entry);
factor Jacobians rtol 1e-4 / atol 1e-5 (of the block's largest entry);
the normal system H, b (and Hpd, Hd, bd) to 1e-4 of max |H| (of each
array's largest entry); optimize() poses within 1e-3 m / 1e-3 rad; depths
held by the lidar flag atol 1e-7 (tests/test_ba.py:189).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_estimator_problem import make_problem, np_, perturb, to_port

from vil_fusion_tpu.models import ba as jba
from vil_fusion_tpu.models import window as jwin
from vil_fusion_tpu.ops import lie as jlie
from vil_fusion_tpu_torch.models import ba as tba
from vil_fusion_tpu_torch.models import window as twin
from vil_fusion_tpu_torch.ops import lie as tlie

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends (the CPU
    backend's JIT is unstable once hundreds of programs accumulate in one
    worker; tests/conftest.py clears after the reference's heavy modules)."""
    yield
    jax.clear_caches()

# every Jacobian column live (extrinsic and time offset estimated)
CFG_ALL = dict(estimate_td=True, estimate_extrinsic=True)


@pytest.fixture(scope="module")
def prob():
    """A perturbed window with a quarter of its features lidar-held and a
    non-zero velocity observation / time shift on every observation (so the
    td columns are live), in both packages, and the JAX results every test
    below compares with (each JAX function compiled once)."""
    state_gt, feats, pre, lidar = make_problem()
    st0 = perturb(state_gt)
    F = feats.active.shape[0]
    rng = np.random.default_rng(5)
    feats = feats._replace(
        lidar_flag=jnp.asarray(np.arange(F) < F // 4),
        vel=jnp.asarray(rng.normal(0, 0.05, feats.vel.shape).astype(np.float32)),
        tshift=jnp.asarray(rng.normal(0, 0.002, feats.tshift.shape).astype(np.float32)))
    prior = jba.empty_prior(st0)
    # the LM runs on exact observations (no velocity, no time shift), as
    # tests/test_ba.py does; see test_optimize_matches_reference
    feats_lm = feats._replace(vel=jnp.zeros_like(feats.vel), tshift=jnp.zeros_like(feats.tshift))
    port = dict(window=to_port("window", st0), feats=to_port("feats", feats),
                feats_lm=to_port("feats", feats_lm),
                pre=to_port("pre", pre), lidar=to_port("lidar", lidar),
                prior=to_port("prior", prior), gt=to_port("window", state_gt))
    jcfg = jba.BAConfig(**CFG_ALL)
    g = jnp.asarray(jcfg.gravity, jnp.float32)
    f32 = jnp.float32
    blocks = jax.jit(lambda s, f, p, l: (
        jba._imu_blocks(s, p, g, f32), jba._lidar_blocks(s, l, f32),
        jba._proj_blocks(s, f, jcfg, f32, 4.0)))(st0, feats, pre, lidar)
    build = jax.jit(jba.build_system, static_argnames=("cfg",))
    res = dict(
        blocks=blocks,
        system=build(st0, feats, pre, lidar, prior, jcfg, 4.0),
        cost=jax.jit(jba.total_cost, static_argnames=("cfg",))(
            st0, feats, pre, lidar, prior, jba.BAConfig(), 4.0),
        opt=jba.optimize(st0, feats_lm, pre, lidar, prior, jba.BAConfig()))
    return dict(jax=(st0, feats, pre, lidar, prior), port=port, ref=res, gt=state_gt)


def _port_args(prob):
    p = prob["port"]
    return p["window"], p["feats"], p["pre"], p["lidar"], p["prior"]


def test_window_retract_and_local_diff(prob):
    """retract by a random D-dim step and local_diff back (rtol 1e-5 /
    atol 1e-6; the pose blocks exactly as lie.pose_retract)."""
    st0 = prob["jax"][0]
    delta = np.random.default_rng(2).normal(0, 0.05, jwin.D).astype(np.float32)
    rj = jwin.retract(st0, jnp.asarray(delta))
    rt = twin.retract(prob["port"]["window"], torch.from_numpy(delta))
    for k in twin.WindowState._fields:
        np.testing.assert_allclose(np_(getattr(rt, k)), np_(getattr(rj, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    dj = jwin.local_diff(rj, st0)
    dt = twin.local_diff(rt, prob["port"]["window"])
    np.testing.assert_allclose(np_(dt), np_(dj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(dt), delta, atol=1e-5)


@pytest.mark.parametrize("kind", ["imu", "lidar", "proj"])
def test_factor_residuals_and_jacobians(prob, kind):
    """Each factor family's weighted residuals and its jacfwd Jacobians over
    the tangent retraction (torch.func.jacfwd under vmap against jax.jacfwd
    under vmap), with every column live."""
    s, f, p, l, _ = _port_args(prob)
    cfg = tba.BAConfig(**CFG_ALL)
    g = torch.tensor(cfg.gravity)
    jimu, jlid, jproj = prob["ref"]["blocks"]
    if kind == "imu":
        (rt, Jt, ixt), (rj, Jj, ixj) = tba._imu_blocks(s, p, g, torch.float32), jimu
        pairs = [(Jt, Jj)]
    elif kind == "lidar":
        (rt, Jt, ixt), (rj, Jj, ixj) = tba._lidar_blocks(s, l, torch.float32), jlid
        pairs = [(Jt, Jj)]
    else:
        rt, Jpt, Jdt, ixt, fit, rhot = tba._proj_blocks(s, f, cfg, torch.float32, 4.0)
        rj, Jpj, Jdj, ixj, fij, rhoj = jproj
        pairs = [(Jpt, Jpj), (Jdt, Jdj)]
        np.testing.assert_array_equal(np_(fit), np_(fij))
        np.testing.assert_allclose(float(rhot), float(rhoj), rtol=1e-5)
        assert (np.abs(np_(Jdj)) > 0).sum() > 100  # free depths have live columns
    np.testing.assert_array_equal(np_(ixt), np_(ixj))
    rj = np_(rj)
    np.testing.assert_allclose(np_(rt), rj, rtol=1e-5, atol=1e-5 * np.abs(rj).max())
    for a, b in pairs:
        b = np_(b)
        np.testing.assert_allclose(np_(a), b, rtol=1e-4, atol=1e-5 * np.abs(b).max())


def test_build_system_matches_reference(prob):
    """The normal system of every factor (prior, IMU, LiDAR, Cauchy-weighted
    projections with the depth Schur blocks) at Cauchy scale 4, and the cost
    of total_cost."""
    sys_t = tba.build_system(*_port_args(prob), tba.BAConfig(**CFG_ALL), 4.0)
    sys_j = prob["ref"]["system"]
    for k in ("H", "b", "Hpd", "Hd", "bd"):
        a, b = np_(getattr(sys_t, k)), np_(getattr(sys_j, k))
        scale = np.abs(np_(sys_j.H)).max() if k in ("H", "b") else np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-4 * scale, (k, np.abs(a - b).max(), scale)
    np.testing.assert_allclose(float(sys_t.cost), float(sys_j.cost), rtol=1e-5)
    cost_t = tba.total_cost(*_port_args(prob), tba.BAConfig(), 4.0)
    np.testing.assert_allclose(float(cost_t), float(prob["ref"]["cost"]), rtol=1e-5)


def test_schur_solve_and_cholesky_fallback(prob):
    """schur_solve on the reference's assembled system, and on a system
    whose pose block is not positive definite: the reference's Cholesky
    holds NaN there and it takes the LU step of the regularized system;
    cholesky_ex gives the port the same step without raising. The damped
    pose system stays ill-conditioned after the Jacobi preconditioning, so
    two f32 factorizations of the same matrix differ at ~1e-3 of the step:
    each package's step is held against the same solve in float64 (the
    port's code on float64 tensors), within 5e-3 of the step's largest
    entry (tools/parity_floor.py: 1.5e-4 to 2.2e-3 for the pose and depth
    steps of six perturbed windows at lam 1e-4, either package in turn the
    worse)."""
    sys_j = prob["ref"]["system"]
    lam = 1e-4
    solve_j = jax.jit(jba.schur_solve, static_argnames=("cfg",))
    for sj in (sys_j, _indefinite(sys_j)):
        st = tba.System(*(torch.from_numpy(np.array(x)) for x in sj))
        dt, ddt = tba.schur_solve(st, torch.tensor(lam), tba.BAConfig())
        d64, dd64 = tba.schur_solve(tba.System(*(x.double() for x in st)),
                                    torch.tensor(lam, dtype=torch.float64), tba.BAConfig())
        dj, ddj = solve_j(sj, jnp.float32(lam), jba.BAConfig())
        for port, ref, exact in ((dt, dj, d64), (ddt, ddj, dd64)):
            port, ref, exact = np_(port), np_(ref), np_(exact)
            scale = np.abs(exact).max()
            err_port, err_ref = np.abs(port - exact).max(), np.abs(ref - exact).max()
            assert np.isfinite(port).all()
            assert err_ref <= 5e-3 * scale and err_port <= 5e-3 * scale, (err_port, err_ref)


def _indefinite(sys):
    """The same (JAX) system with one pose dimension's curvature made
    strongly negative, so the Cholesky factorization of the damped,
    preconditioned block fails."""
    return sys._replace(H=sys.H.at[20, 20].set(-50.0 * jnp.abs(jnp.diag(sys.H)).max()))


@pytest.fixture(scope="module")
def port_opt(prob):
    p = prob["port"]
    return tba.optimize(p["window"], p["feats_lm"], p["pre"], p["lidar"], p["prior"],
                        tba.BAConfig())


def test_optimize_matches_reference(prob, port_opt):
    """The 8-iteration LM (annealed Cauchy, accept/reject on the device,
    re-anchored gauge) from the perturbed window: poses within 1e-3 m /
    1e-3 rad of the JAX result, final cost within 1e-2 of the reference's
    (both end at the f32 floor, a few 1e-3), and the port within 0.05 m of
    the ground truth. On exact observations: with
    noisy ones (the velocity / time-shift noise of the other tests) the f32
    LM ends 6.2e-4 m (reference) and 1.1e-3 m (port) from the float64
    result, and the two f32 runs 1.2e-3 m apart (tools/parity_floor.py)."""
    st, ft, cost = port_opt
    sj, fj, cj = prob["ref"]["opt"]
    np.testing.assert_allclose(np_(st.p), np_(sj.p), atol=1e-3)
    dq = jlie.qmul(jlie.qconj(sj.q), jnp.asarray(np_(st.q)))
    assert float(jnp.max(jnp.linalg.norm(jlie.so3_log(dq), axis=-1))) < 1e-3
    np.testing.assert_allclose(float(cost), float(cj), atol=1e-2)
    assert np.abs(np_(st.p) - np_(prob["gt"].p)).max() < 0.05


def test_lidar_held_depths_constant(prob, port_opt):
    """fix_lidar_depths: depths of lidar-flagged features stay exactly where
    they were (atol 1e-7), the others move, as in the reference."""
    _, ft, _ = port_opt
    _, fj, _ = prob["ref"]["opt"]
    f0 = prob["port"]["feats"]
    d0, d1 = np_(f0.inv_depth), np_(ft.inv_depth)
    held = np_(f0.lidar_flag) & (d0 > 0)
    free = ~np_(f0.lidar_flag) & (d0 > 0) & np_(f0.active)
    assert held.sum() >= 4 and free.sum() >= 10
    np.testing.assert_allclose(d1[held], d0[held], atol=1e-7)
    assert np.abs(d1[free] - d0[free]).max() > 1e-5
    np.testing.assert_allclose(d1, np_(fj.inv_depth), rtol=1e-3, atol=1e-4)


def test_sharded_ba_raises():
    """BAConfig(sharded=True) raises while no mesh is active (the sharded BA
    itself: tests/test_torch_parallel.py) and passes the check with one."""
    from vil_fusion_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="no active mesh"):
        tba.check_config(tba.BAConfig(sharded=True))
    mesh.set_active_mesh(mesh.Mesh(None, 0, 1, torch.device("cpu")))
    try:
        tba.check_config(tba.BAConfig(sharded=True))
    finally:
        mesh.set_active_mesh(None)


def test_re_anchor_restores_frame0(prob):
    """re_anchor puts frame 0 back at its anchor position and yaw, and
    matches the reference (atol 1e-5)."""
    s = prob["port"]["window"]
    st = twin.retract(s, torch.full((twin.D,), 0.02))
    p0, ypr0 = s.p[0].clone(), tlie.R2ypr(tlie.q2R(s.q[0]))
    out = tba.re_anchor(st, p0, ypr0)
    np.testing.assert_allclose(np_(out.p[0]), np_(p0), atol=1e-6)
    np.testing.assert_allclose(np_(tlie.R2ypr(tlie.q2R(out.q[0])))[0], np_(ypr0)[0], atol=1e-3)
    sj = jwin.retract(prob["jax"][0], jnp.full((jwin.D,), 0.02))
    oj = jba.re_anchor(sj, jnp.asarray(np_(p0)), jnp.asarray(np_(ypr0)))
    for k in ("p", "q", "v"):
        np.testing.assert_allclose(np_(getattr(out, k)), np_(getattr(oj, k)), atol=1e-5)


