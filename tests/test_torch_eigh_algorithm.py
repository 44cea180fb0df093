"""The eigensolver kernels' algorithm, on the CPU: the numpy mirror of
csrc/eigh.cu (tests/torch_eigh_reference.py: the warp kernel's Jacobi, the
block kernel's Householder tridiagonalization + implicit QL + Q Z, in the
kernels' precisions) against float64, on the card tests' matrices and on
the matrices the marginalization hands its eigensolver; and the port's
marginalization through the mirror against the JAX package's.

The tolerances are the card's (chip_smoke.py EIGH_*, tests/test_torch_cuda.py):
eigenvalues ascending and within 2e-5 of max|S| of float64's (a float32
solver lands within ~5 n ulps of the largest), V diag(S) V^T within 2e-5
of max|A|, V^T V within 2e-5 of I; the priors to
test_torch_marginalization.py's tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_eigh_reference as ref
from torch_estimator_problem import make_problem, np_, perturb, to_port

from vil_fusion_tpu.models import ba as jba
from vil_fusion_tpu.models import marginalization as jmarg
from vil_fusion_tpu_torch.models import ba as tba
from vil_fusion_tpu_torch.models import marginalization as tmarg

EIGH_TOL_F64, EIGH_TOL_RECON, EIGH_TOL_ORTH = 2e-5, 2e-5, 2e-5
CASES = ["full rank", "rank n/2", "repeated", "wide range"]


def _eigh_case(n, case, seed):
    """tests/test_torch_cuda.py's matrices (float64; the solvers see them
    in float32). n <= 2: a diagonal one."""
    if n <= 2:
        return np.eye(n) * 3.0 + (n == 2)
    rng = np.random.default_rng(seed)
    if case == "full rank":
        A = rng.normal(size=(n + 20, n))
        return A.T @ A
    if case == "rank n/2":
        B = rng.normal(size=(n // 2, n))
        return B.T @ B
    if case == "repeated":
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        return (Q * np.repeat(rng.uniform(1.0, 10.0, (n + 2) // 3), 3)[:n]) @ Q.T
    C = rng.normal(size=(n, n)) * np.exp(rng.uniform(-8.0, 18.0, n))  # "wide range"
    return C.T @ C / n


def _check(A, w, V):
    """The four tolerances of one decomposition (w, V) of the float32 A."""
    A = np.asarray(A, np.float64)
    n = A.shape[0]
    S64 = np.linalg.eigvalsh(A)
    smax = max(np.abs(S64).max(), np.finfo(np.float32).tiny)
    assert w.dtype == np.float32 and V.dtype == np.float32
    assert (w[1:] >= w[:-1]).all()
    assert np.abs(w.astype(np.float64) - S64).max() <= EIGH_TOL_F64 * smax
    Vd, wd = V.astype(np.float64), w.astype(np.float64)
    amax = max(np.abs(A).max(), np.finfo(np.float32).tiny)
    assert np.abs((Vd * wd) @ Vd.T - A).max() <= EIGH_TOL_RECON * amax
    assert np.abs(Vd.T @ Vd - np.eye(n)).max() <= EIGH_TOL_ORTH


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [1, 2, 15, 157, 172])
def test_mirror_holds_the_tolerances(n, case):
    """The kernel that the launcher picks for n (the warp Jacobi up to 32,
    the block Householder + QL above), mirrored, on the card tests'
    matrices."""
    A = _eigh_case(n, case, n).astype(np.float32)
    w, V, (iters, rotations) = ref.eigh(A)
    _check(A, w, V)
    if n > ref.WARP_MAX_N:  # about two QL iterations an eigenvalue
        assert iters <= 4 * n and rotations <= 4 * n * n


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [1, 2, 15])
def test_householder_ql_at_small_n(n, case):
    """The block kernel's algorithm also holds at the warp kernel's sizes
    (it takes every n >= 1; the launcher sends n <= 32 to the warp)."""
    A = _eigh_case(n, case, n).astype(np.float32)
    w, V, _ = ref.householder_ql(A)
    _check(A, w, V)


def test_mirror_lower_triangle_and_order():
    """Only the lower triangle is read; equal eigenvalues keep the lower
    index first; a diagonal matrix comes back sorted with unit vectors."""
    rng = np.random.default_rng(3)
    A = _eigh_case(40, "full rank", 3).astype(np.float32)
    junk = A + np.triu(rng.normal(size=A.shape), 1).astype(np.float32)
    for fn in (ref.householder_ql, ref.jacobi_warp):
        w1, V1, _ = fn(A)
        w2, V2, _ = fn(junk)
        assert np.array_equal(w1, w2) and np.array_equal(V1, V2)
    D = np.diag(np.array([3.0, 1.0, 2.0, 1.0], np.float32))
    for fn in (ref.householder_ql, ref.jacobi_warp):
        w, V, _ = fn(D)
        assert np.array_equal(w, np.array([1.0, 1.0, 2.0, 3.0], np.float32))
        assert np.array_equal(np.abs(V), np.eye(4)[:, [1, 3, 2, 0]])


@pytest.fixture(scope="module")
def window():
    """test_torch_marginalization.py's perturbed window with a first prior
    (JAX and port), and every matrix the port's two marginalizations hand
    sym_eigh on it (the 15 x 15 Schur blocks and the 157 x 157 quadratics)
    with the quadratics (Lam, g) they factor."""
    state_gt, feats, pre, lidar = make_problem(imu_cap=48)
    st0 = perturb(state_gt)
    F = feats.active.shape[0]
    feats = feats._replace(lidar_flag=jnp.asarray(np.arange(F) < F // 4))
    prior0 = jmarg.marginalize_old(st0, feats, pre, lidar, jba.empty_prior(st0), jba.BAConfig())
    jax_state = (st0, feats, pre, lidar, prior0)
    port = [to_port(k, x) for k, x in zip(("window", "feats", "pre", "lidar", "prior"),
                                           jax_state)]
    mats, quads = [], []
    sym_eigh, to_factor = tmarg.sym_eigh, tmarg._quadratic_to_factor

    def eigh_rec(A):
        mats.append(A.numpy().copy())
        return sym_eigh(A)

    def factor_rec(Lam, g):
        quads.append((Lam.numpy().copy(), g.numpy().copy()))
        return to_factor(Lam, g)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmarg, "sym_eigh", eigh_rec)
        mp.setattr(tmarg, "_quadratic_to_factor", factor_rec)
        tmarg.marginalize_old(*port, tba.BAConfig())
        tmarg.marginalize_second_new(port[4], port[0])
    return dict(jax=jax_state, port=port, mats=mats, quads=quads)


def _mirror_sym_eigh(A):
    """ops/linalg.sym_eigh's contract, through the mirror (float32 CPU
    tensors in and out)."""
    w, V, _ = ref.eigh(A.detach().cpu().numpy())
    return torch.from_numpy(w), torch.from_numpy(V)


@pytest.mark.parametrize("index", range(4))
def test_mirror_on_the_window_matrices(window, index):
    """marginalize_old's and marginalize_second_new's Schur block (15) and
    quadratic (157), through the mirror."""
    assert sorted(A.shape[0] for A in window["mats"]) == [15, 15, 157, 157]
    A = window["mats"][index]
    w, V, _ = ref.eigh(A)
    _check(A, w, V)


def _invariants(J, r0):
    J, r0 = np.asarray(J, np.float64), np.asarray(r0, np.float64)
    return J.T @ J, J.T @ r0


@pytest.mark.parametrize("which", ["rank 30 of 40", "window 0", "window 1"])
def test_quadratic_to_factor_through_the_mirror(window, which):
    """_quadratic_to_factor with the mirror as its eigensolver against the
    JAX package's on the same (Lam, g): J^T J within 1e-4 of the largest
    entry of Lam, J^T r0 within 1e-3 of g's (test_torch_marginalization.py's
    test_quadratic_to_factor_invariants), on its rank-deficient matrix and
    on the two quadratics the window's marginalizations factor."""
    if which == "rank 30 of 40":
        rng = np.random.default_rng(0)
        X = rng.normal(size=(30, 40)).astype(np.float32)
        Lam = X.T @ X
        g = Lam @ rng.normal(size=40).astype(np.float32)
    else:
        Lam, g = window["quads"][int(which[-1])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmarg, "sym_eigh", _mirror_sym_eigh)
        Jt, rt = tmarg._quadratic_to_factor(torch.from_numpy(Lam), torch.from_numpy(g))
    Jj, rj = jmarg._quadratic_to_factor(jnp.asarray(Lam), jnp.asarray(g))
    (jj_t, jr_t), (jj_j, jr_j) = _invariants(np_(Jt), np_(rt)), _invariants(np_(Jj), np_(rj))
    assert np.abs(jj_t - jj_j).max() <= 1e-4 * np.abs(jj_j).max()
    assert np.abs(jr_t - jr_j).max() <= 1e-3 * np.abs(jr_j).max()


@pytest.mark.parametrize("what", ["marginalize_old", "marginalize_second_new"])
def test_marginalization_through_the_mirror(window, what):
    """The port's marginalizations with the mirror as sym_eigh against the
    JAX package's: the prior's J^T J and J^T r0 within
    test_torch_marginalization.py's tolerances (1e-2 for marginalize_old,
    whose Schur elimination of the depths sits ~1e-2 from float64 in both
    packages; 1e-4 for marginalize_second_new)."""
    st0, feats, pre, lidar, prior0 = window["jax"]
    port = window["port"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmarg, "sym_eigh", _mirror_sym_eigh)
        if what == "marginalize_old":
            pt = tmarg.marginalize_old(*port, tba.BAConfig())
        else:
            pt = tmarg.marginalize_second_new(port[4], port[0])
    if what == "marginalize_old":
        pj, tol = jmarg.marginalize_old(st0, feats, pre, lidar, prior0, jba.BAConfig()), 1e-2
    else:
        pj, tol = jmarg.marginalize_second_new(prior0, st0), 1e-4
    for a, b in zip(_invariants(np_(pt.J), np_(pt.r0)), _invariants(np_(pj.J), np_(pj.r0))):
        assert np.abs(a - b).max() <= tol * np.abs(b).max()
