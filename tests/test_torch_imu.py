"""The port's IMU preintegration (models/imu.py) and the carried IMU and
landmark simulators against vil_fusion_tpu on the same numpy inputs.

Tolerances are those of tests/test_imu.py:152-160: deltas rtol 1e-5 /
atol 1e-6, the 15x15 bias Jacobian rtol 1e-4 / atol 1e-5, the covariance
rtol 1e-4 / atol 1e-8; residual and sqrt-information rtol 1e-5 on values of
order one (atol 1e-5 relative to the largest entry for the weighted ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import imu as jimu
from vil_fusion_tpu.runtime import sim as jsim
from vil_fusion_tpu_torch.models import imu as timu
from vil_fusion_tpu_torch.runtime import sim as tsim

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends (the CPU
    backend's JIT is unstable once hundreds of programs accumulate in one
    worker; tests/conftest.py clears after the reference's heavy modules)."""
    yield
    jax.clear_caches()

NOISE = jimu.ImuNoise()
TNOISE = timu.ImuNoise()


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _segment(n=64, pad=20, seed=7):
    """An imu_cap-shaped segment from the simulator (200 Hz, noisy, biased),
    its last `pad` steps padded with dt = 0 as _pack_imu pads."""
    traj = jsim.Trajectory()
    noise = type("N", (), dict(acc_n=0.08, gyr_n=0.004))()
    ts, acc, gyr = jsim.simulate_imu(traj, 1.0, 1.0 + (n - 1 - pad) / 200.0, 200.0, noise=noise,
                                     bias_a=np.array([0.05, -0.03, 0.02]),
                                     bias_g=np.array([0.002, -0.001, 0.0015]), seed=seed)
    m = len(ts)
    acc_b = np.concatenate([acc, np.repeat(acc[-1:], n - m, 0)]).astype(np.float32)
    gyr_b = np.concatenate([gyr, np.repeat(gyr[-1:], n - m, 0)]).astype(np.float32)
    dt = np.zeros(n - 1, np.float32)
    dt[: m - 1] = np.diff(ts)
    return traj, ts, acc_b, gyr_b, dt


@pytest.fixture(scope="module")
def preint():
    """The same segment and biases through both packages."""
    _, _, acc, gyr, dt = _segment()
    ba = np.array([0.04, -0.02, 0.01], np.float32)
    bg = np.array([0.002, 0.001, -0.003], np.float32)
    j = jimu.preintegrate(*(jnp.asarray(x) for x in (acc, gyr, dt, ba, bg)), NOISE)
    t = timu.preintegrate(*(_t(x) for x in (acc, gyr, dt, ba, bg)), TNOISE)
    return j, t


def test_simulators_match_reference():
    """The carried numpy simulators produce the reference's arrays exactly:
    simulate_imu (with noise and biases), LandmarkWorld, project_landmarks
    and the urban-block scene."""
    traj_j, traj_t = jsim.LoopTrajectory(), tsim.LoopTrajectory()
    noise = type("N", (), dict(acc_n=0.08, gyr_n=0.004))()
    kw = dict(noise=noise, bias_a=np.array([0.05, -0.03, 0.02]), seed=3)
    for a, b in zip(jsim.simulate_imu(traj_j, 1.0, 1.1, 200.0, **kw),
                    tsim.simulate_imu(traj_t, 1.0, 1.1, 200.0, **kw)):
        np.testing.assert_array_equal(a, b)
    wj, wt = jsim.LandmarkWorld(n=300, seed=4), tsim.LandmarkWorld(n=300, seed=4)
    np.testing.assert_array_equal(wj.points, wt.points)
    R, p = traj_j.rotation(2.0), traj_j.position(2.0)
    r_bc = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    for a, b in zip(jsim.project_landmarks(wj, R, p, R_bc=r_bc),
                    tsim.project_landmarks(wt, R, p, R_bc=r_bc)):
        np.testing.assert_array_equal(a, b)
    sj, st = jsim.urban_block_scene(12.0), tsim.urban_block_scene(12.0)
    for k in ("wall_y", "wall_h", "x_lo", "x_hi", "pillar_r", "pillar_h", "pillars", "boxes"):
        np.testing.assert_array_equal(getattr(sj, k), getattr(st, k))


def test_preintegrate_matches_reference(preint):
    """Sequential midpoint preintegration of a 64-sample segment (43 steps
    plus 20 zero-dt padding steps): deltas, bias Jacobian, covariance."""
    j, t = preint
    for k in ("dp", "dq", "dv"):
        np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(t.jac.numpy(), np.asarray(j.jac), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.cov.numpy(), np.asarray(j.cov), rtol=1e-4, atol=1e-8)
    # the sum of the step durations: f32 sums in another order
    np.testing.assert_allclose(float(t.dt_sum), float(j.dt_sum), rtol=1e-6)


def test_padding_steps_are_identity():
    """dt == 0 steps leave the deltas, Jacobian and covariance unchanged
    (the fixed-capacity loop runs them all)."""
    _, _, acc, gyr, dt = _segment(n=48, pad=16)
    z = torch.zeros(3)
    full = timu.preintegrate(_t(acc), _t(gyr), _t(dt), z, z)
    m = int((dt > 0).sum()) + 1
    short = timu.preintegrate(_t(acc[:m]), _t(gyr[:m]), _t(dt[: m - 1]), z, z)
    for k in ("dp", "dq", "dv", "jac", "cov"):
        np.testing.assert_allclose(getattr(full, k).numpy(), getattr(short, k).numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    # the log-depth path: padding leaves are exact identities there too
    full = timu.preintegrate(_t(acc), _t(gyr), _t(dt), z, z, parallel=True)
    short = timu.preintegrate(_t(acc[:m]), _t(gyr[:m]), _t(dt[: m - 1]), z, z, parallel=True)
    for k in ("dp", "dq", "dv", "jac", "cov"):
        np.testing.assert_allclose(getattr(full, k).numpy(), getattr(short, k).numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def _random_segment(n=64, pad=20, seed=7):
    """tests/test_imu.py:131-142's segment: random samples, 63 steps of which
    the last `pad` have dt = 0."""
    rng = np.random.default_rng(seed)
    acc = rng.normal([0.2, -0.1, 9.81], 0.4, (n, 3)).astype(np.float32)
    gyr = rng.normal([0.02, 0.3, -0.1], 0.1, (n, 3)).astype(np.float32)
    dt = np.full((n - 1,), 0.005, np.float32)
    dt[n - 1 - pad:] = 0.0
    ba = np.array([0.05, -0.02, 0.01], np.float32)
    bg = np.array([0.002, 0.001, -0.003], np.float32)
    return acc, gyr, dt, ba, bg


def _assert_preint_close(got, want, what):
    """tests/test_imu.py:152-160's tolerances."""
    for k in ("dp", "dq", "dv"):
        np.testing.assert_allclose(np.asarray(getattr(got, k)), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")
    np.testing.assert_allclose(np.asarray(got.jac), np.asarray(want.jac), rtol=1e-4, atol=1e-5,
                               err_msg=f"{what} jac")
    np.testing.assert_allclose(np.asarray(got.cov), np.asarray(want.cov), rtol=1e-4, atol=1e-8,
                               err_msg=f"{what} cov")


@pytest.mark.parametrize("segment", ["random", "simulator", "no padding", "one step"])
def test_preintegrate_parallel_matches_reference(segment):
    """preintegrate(parallel=True) against the reference's log-depth
    preintegration and its sequential one, and against the port's
    sequential loop, on tests/test_imu.py:131-161's segment (20 zero-dt
    steps), the simulator's noisy, biased segment, a segment without
    padding and a single step; its tolerances."""
    if segment == "simulator":
        _, _, acc, gyr, dt = _segment()
        ba = np.array([0.04, -0.02, 0.01], np.float32)
        bg = np.array([0.002, 0.001, -0.003], np.float32)
    else:
        n, pad = {"random": (64, 20), "no padding": (33, 0), "one step": (2, 0)}[segment]
        acc, gyr, dt, ba, bg = _random_segment(n, pad)
    jx = [jnp.asarray(x) for x in (acc, gyr, dt, ba, bg)]
    tx = [_t(x) for x in (acc, gyr, dt, ba, bg)]
    par = timu.preintegrate(*tx, TNOISE, parallel=True)
    _assert_preint_close(par, jimu.preintegrate(*jx, NOISE, parallel=True), "vs JAX parallel")
    _assert_preint_close(par, jimu.preintegrate(*jx, NOISE), "vs JAX sequential")
    _assert_preint_close(par, timu.preintegrate(*tx, TNOISE), "vs port sequential")
    assert float(par.dt_sum) == float(timu.preintegrate(*tx, TNOISE).dt_sum)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 7, 8, 33, 63])
def test_associative_scan_matches_jax(n):
    """The hand-written log-depth scan combines in jax.lax.associative_scan's
    order: every prefix of a chain of normalized quaternion products within
    1e-6 (values of order one) of JAX's and 1e-5 of the sequential
    products; the (J2 J1, J2 P1 J2^T + P2) pairs within 1e-5 of JAX's (the
    15-term dot products of a 15x15 matmul are summed in another order by
    XLA and by torch's matmul, so each product rounds apart)."""
    rng = np.random.default_rng(n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    J = (np.eye(15) + 0.05 * rng.normal(size=(n, 15, 15))).astype(np.float32)
    P = (0.01 * rng.normal(size=(n, 15, 15))).astype(np.float32)
    P = P @ P.transpose(0, 2, 1)

    from vil_fusion_tpu.ops import lie as jlie
    from vil_fusion_tpu_torch.ops import lie as tlie

    (tq,) = timu.associative_scan(lambda x, y: (tlie.qnormalize(tlie.qmul(x[0], y[0])),), (_t(q),))
    jq = jax.lax.associative_scan(lambda x, y: jlie.qnormalize(jlie.qmul(x, y)), jnp.asarray(q))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
    seq = [q[0]]
    for i in range(1, n):
        seq.append(np.asarray(jlie.qnormalize(jlie.qmul(jnp.asarray(seq[-1]), jnp.asarray(q[i])))))
    np.testing.assert_allclose(tq.numpy(), np.stack(seq), rtol=1e-5, atol=1e-5)

    def comb_t(x, y):
        return y[0] @ x[0], y[0] @ x[1] @ y[0].transpose(-1, -2) + y[1]

    def comb_j(x, y):
        return y[0] @ x[0], y[0] @ x[1] @ jnp.swapaxes(y[0], -1, -2) + y[1]

    tJ, tP = timu.associative_scan(comb_t, (_t(J), _t(P)))
    jJ, jP = jax.lax.associative_scan(comb_j, (jnp.asarray(J), jnp.asarray(P)))
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=1e-5, atol=1e-5)


def test_residual_and_sqrt_information_match_reference(preint):
    """bias_corrected_delta at shifted biases, the 15-dim residual at
    perturbed states (rtol 1e-5, atol 1e-5 of its largest entry) and the
    inverse Cholesky factor of the covariance (rtol 1e-5, atol 1e-5 of its
    largest entry: entries span 1e-1 to 1e4)."""
    j, t = preint
    rng = np.random.default_rng(0)
    dba = rng.normal(0, 0.02, 3).astype(np.float32)
    dbg = rng.normal(0, 0.002, 3).astype(np.float32)
    bj = jimu.bias_corrected_delta(j, j.ba + dba, j.bg + dbg)
    bt = timu.bias_corrected_delta(t, t.ba + _t(dba), t.bg + _t(dbg))
    for a, b in zip(bj, bt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)

    traj = jsim.Trajectory()
    q_i, p_i = traj.pose(1.0)
    q_j, p_j = traj.pose(1.0 + float(j.dt_sum))
    states = [p_i + rng.normal(0, 0.01, 3), q_i, traj.velocity(1.0), dba, dbg,
              p_j, q_j / np.linalg.norm(q_j), traj.velocity(1.2) + 0.01, dba * 2, dbg]
    states = [np.asarray(s, np.float32) for s in states]
    g = np.asarray(jsim.GRAVITY, np.float32)
    rj = np.asarray(jimu.residual(j, *(jnp.asarray(s) for s in states), jnp.asarray(g)))
    rt = timu.residual(t, *(_t(s) for s in states), _t(g)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-5 * np.abs(rj).max())

    sj = np.asarray(jimu.sqrt_information(j))
    st = timu.sqrt_information(t).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5 * np.abs(sj).max())


def test_sqrt_information_not_spd_is_nan():
    """A covariance that is not positive definite gives a NaN factor, as the
    reference's Cholesky does, instead of raising (cholesky_ex)."""
    cov = torch.eye(15)
    cov[3, 3] = -1.0
    pre = timu.Preintegrated(*(torch.zeros(3),) * 3, torch.eye(15), cov, torch.zeros(()),
                             torch.zeros(3), torch.zeros(3))
    assert torch.isnan(timu.sqrt_information(pre)).any()


def test_propagate_state_matches_reference():
    """The high-rate world-frame propagation step (rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=4).astype(np.float32)
    args = [rng.normal(size=3), q / np.linalg.norm(q), rng.normal(size=3),
            rng.normal(0, 0.05, 3), rng.normal(0, 0.01, 3),
            rng.normal([0, 0, 9.8], 0.3), rng.normal(0, 0.2, 3),
            rng.normal([0, 0, 9.8], 0.3), rng.normal(0, 0.2, 3)]
    args = [np.asarray(a, np.float32) for a in args]
    g = np.array([0, 0, 9.81], np.float32)
    oj = jimu.propagate_state(*(jnp.asarray(a) for a in args), jnp.float32(0.005),
                              jnp.asarray(g))
    ot = timu.propagate_state(*(_t(a) for a in args), torch.tensor(0.005), _t(g))
    for a, b in zip(oj, ot):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
