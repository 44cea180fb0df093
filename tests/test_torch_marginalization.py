"""The port's marginalization and window slides (models/marginalization.py)
against vil_fusion_tpu on the same simulator window
(tests/torch_estimator_problem.py), carried with utils/state_io.

The prior's factor J is an eigendecomposition's (arbitrary signs, and an
arbitrary basis of repeated eigenvalues), so the prior is compared by what
is invariant: J^T J and J^T r0, each to 1e-4 of its largest entry (the
normal-system tolerance of test_torch_ba.py), and the linearization point
exactly. marginalize_old is the exception: its Schur elimination of frame 0
inverts eigenvalues of an f32 matrix whose entries reach 1e8, so an f32
run, the reference's included, lands 5e-4 to 4.2e-3 of the largest entry
from the same algorithm in float64 (tools/parity_floor.py); there both
packages are held to the float64 result (the port's code on float64
tensors) and to each other within 1e-2. Slides move and compose arrays: equal, or within rtol 1e-5 /
atol 1e-6 where they compute (depth handover, merged preintegration with
the covariance-derived sqrt-information within 1e-5 of its largest entry,
composed lidar constraints).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_estimator_problem import K, make_problem, np_, perturb, to_port

from vil_fusion_tpu.models import ba as jba
from vil_fusion_tpu.models import imu as jimu
from vil_fusion_tpu.models import marginalization as jmarg
from vil_fusion_tpu_torch.models import ba as tba
from vil_fusion_tpu_torch.models import imu as timu
from vil_fusion_tpu_torch.models import marginalization as tmarg

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends (the CPU
    backend's JIT is unstable once hundreds of programs accumulate in one
    worker; tests/conftest.py clears after the reference's heavy modules)."""
    yield
    jax.clear_caches()

IMU_CAP = 48


@pytest.fixture(scope="module")
def prob():
    """A perturbed window (21-sample IMU segments in 48-sample buffers), its
    features a quarter lidar-held, and one old prior from a first
    marginalization."""
    state_gt, feats, pre, lidar = make_problem(imu_cap=IMU_CAP)
    st0 = perturb(state_gt)
    F = feats.active.shape[0]
    feats = feats._replace(lidar_flag=jnp.asarray(np.arange(F) < F // 4))
    cfg = jba.BAConfig()
    prior0 = jmarg.marginalize_old(st0, feats, pre, lidar, jba.empty_prior(st0), cfg)
    return dict(jax=(st0, feats, pre, lidar, prior0), cfg=cfg,
                port=[to_port(k, x) for k, x in zip(("window", "feats", "pre", "lidar", "prior"),
                                                   (st0, feats, pre, lidar, prior0))])


def _invariants(prior):
    J = np_(prior.J).astype(np.float64)
    return J.T @ J, J.T @ np_(prior.r0)


def _prior_close(pt, pj, tol=1e-4):
    for a, b in zip(_invariants(pt), _invariants(pj)):
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), (np.abs(a - b).max(),
                                                                np.abs(b).max())
    for k in ("p", "q", "v", "ba", "bg", "tic", "qic", "td"):
        np.testing.assert_array_equal(np_(getattr(pt.lin, k)), np_(getattr(pj.lin, k)),
                                      err_msg=k)
    assert bool(pt.valid) == bool(pj.valid)


def _f64(nt):
    return type(nt)(*(_f64(x) if hasattr(x, "_asdict")
                      else (x.double() if x.is_floating_point() else x) for x in nt))


def test_quadratic_to_factor_invariants():
    """J^T J = Lam and J^T r0 = g on a rank-deficient PSD matrix (rtol
    1e-4), as the reference's factorization gives them."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 40)).astype(np.float32)
    Lam = A.T @ A  # rank 30 of 40
    g = Lam @ rng.normal(size=40).astype(np.float32)
    Jt, rt = tmarg._quadratic_to_factor(torch.from_numpy(Lam), torch.from_numpy(g))
    Jj, rj = jmarg._quadratic_to_factor(jnp.asarray(Lam), jnp.asarray(g))
    for J, r in ((np_(Jt), np_(rt)), (np_(Jj), np_(rj))):
        np.testing.assert_allclose(J.T @ J, Lam, atol=1e-4 * np.abs(Lam).max())
        np.testing.assert_allclose(J.T @ r, g, atol=1e-3 * np.abs(g).max())


def test_marginalize_old_matches_reference(prob):
    """Frame 0 marginalized from prior + IMU + LiDAR + projections anchored
    at frame 0 (with an existing prior): the new prior's J^T J, J^T r0 and
    linearization point, against the reference and both against float64
    (1e-2, see the module's docstring)."""
    st0, feats, pre, lidar, prior0 = prob["jax"]
    pj = jmarg.marginalize_old(st0, feats, pre, lidar, prior0, prob["cfg"])
    port = prob["port"]
    pt = tmarg.marginalize_old(*port, tba.BAConfig())
    p64 = tmarg.marginalize_old(*(_f64(x) for x in port), tba.BAConfig())
    _prior_close(pt, pj, tol=1e-2)
    _prior_close(pt, p64, tol=1e-2)
    _prior_close(pj, p64, tol=1e-2)


def test_marginalize_second_new_matches_reference(prob):
    """The second-newest frame eliminated from the prior only."""
    st0, _, _, _, prior0 = prob["jax"]
    pj = jmarg.marginalize_second_new(prior0, st0)
    pt = tmarg.marginalize_second_new(prob["port"][4], prob["port"][0])
    _prior_close(pt, pj)


def _close(a, b, name, sqrt_info=False):
    a, b = np_(a), np_(b)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=name)
    elif sqrt_info:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=name)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


def _slides_close(out_t, out_j):
    for nt_t, nt_j in zip(out_t, out_j):
        for k in nt_t._fields:
            _close(getattr(nt_t, k), getattr(nt_j, k), k, sqrt_info=k == "sqrt_info")


def test_slide_old_matches_reference(prob):
    """MARGIN_OLD: window, preintegration and lidar shifts, the feature
    grid's shift and the depth handover to the new anchor frame."""
    st0, feats, pre, lidar, _ = prob["jax"]
    out_j = jmarg.slide_old(st0, feats, pre, lidar)
    out_t = tmarg.slide_old(*prob["port"][:4])
    _slides_close(out_t, out_j)
    handed = np_(out_t[1].inv_depth)[np_(feats.active & (feats.start == 0))]
    assert (handed > 0).sum() >= 3


@pytest.mark.parametrize("overflow", [False, True])
def test_slide_new_matches_reference(prob, overflow):
    """MARGIN_SECOND_NEW: frame K-2 dropped, its IMU segment merged with the
    newest one and re-integrated, the lidar constraints composed; with
    `overflow` both segments hold 47 of 48 samples, so the merge decimates
    both (the reference's fixed-capacity twist)."""
    st0, feats, pre, lidar, _ = prob["jax"]
    if overflow:
        n = jnp.asarray(np.where(np.arange(K) >= K - 2, IMU_CAP - 1, np.asarray(pre.n_samples)),
                        jnp.int32)
        dt = np.asarray(pre.dt_buf).copy()
        dt[K - 2:, : IMU_CAP - 2] = 0.005
        pre = pre._replace(n_samples=n, dt_buf=jnp.asarray(dt))
    out_j = jax.jit(jmarg.slide_new, static_argnames=("imu_noise", "imu_cap"))(
        st0, feats, pre, lidar, jimu.ImuNoise(), IMU_CAP)
    s, f, _, l, _ = prob["port"]
    out_t = tmarg.slide_new(s, f, to_port("pre", pre), l, timu.ImuNoise(), IMU_CAP)
    _slides_close(out_t, out_j)
    n_merged = int(np_(out_t[2].n_samples)[K - 2])
    assert n_merged == (47 if overflow else 41)
