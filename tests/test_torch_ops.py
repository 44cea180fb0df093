"""Parity of the port's ops (lie, linalg, voxel) with vil_fusion_tpu.

The same numpy inputs go through the JAX function and its PyTorch
counterpart; each assert states its tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.ops import lie as jlie
from vil_fusion_tpu.ops import linalg as jlinalg
from vil_fusion_tpu.ops import voxel as jvoxel
from vil_fusion_tpu_torch.ops import lie as tlie
from vil_fusion_tpu_torch.ops import linalg as tlinalg
from vil_fusion_tpu_torch.ops import voxel as tvoxel

torch.set_num_threads(2)


def _quats(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[:, :1] < 0, -q, q).astype(np.float32)


def _vecs(n, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, 3))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _both(fn_name, *args):
    """(jax output, torch output) of lie.<fn_name> as numpy arrays."""
    j = getattr(jlie, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else
                                 tuple(jnp.asarray(x) for x in a) for a in args])
    t = getattr(tlie, fn_name)(*[_t(a) if isinstance(a, np.ndarray) else
                                 tuple(_t(x) for x in a) for a in args])
    as_np = (lambda o: tuple(np.asarray(x) for x in o) if isinstance(o, tuple)
             else (np.asarray(o),))
    return as_np(j), tuple(x.numpy() for x in (t if isinstance(t, tuple) else (t,)))


Q1, Q2 = _quats(32, 1), _quats(32, 2)
V1, V2 = _vecs(32, 3), _vecs(32, 4)
THETA = np.random.default_rng(5).uniform(-2, 2, (32, 3)).astype(np.float32)
THETA_SMALL = np.array([[1e-9, -1e-9, 1e-10], [0, 0, 0], [1e-4, 2e-4, -1e-4]], np.float32)
XI = np.random.default_rng(6).uniform(-1, 1, (16, 6)).astype(np.float32)
YPR = np.array([[30.0, 10.0, -20.0], [-80.0, 5.0, 3.0], [170.0, -45.0, 60.0]], np.float32)
DELTA = np.random.default_rng(7).uniform(-0.3, 0.3, (32, 6)).astype(np.float32)

# (function, args, atol): elementwise JAX-vs-port agreement
LIE_CASES = [
    ("skew", (V1,), 1e-6),
    ("qmul", (Q1, Q2), 1e-6),
    ("qconj", (Q1,), 0.0),
    ("qinv", (Q1,), 1e-6),
    ("qnormalize", (Q1 * 3.0,), 1e-6),
    ("positify", (-Q1,), 0.0),
    ("qrot", (Q1, V1), 1e-5),
    ("q2R", (Q1,), 1e-6),
    ("R2q", (np.asarray(jlie.q2R(jnp.asarray(Q1))),), 1e-5),
    ("so3_exp", (THETA,), 1e-5),
    ("so3_exp", (THETA_SMALL,), 1e-7),
    ("so3_log", (Q1,), 1e-4),
    ("so3_exp_matrix", (THETA,), 1e-5),
    ("so3_left_jacobian", (THETA,), 1e-5),
    # Taylor branch only: between it and ~1e-3 rad both packages lose the
    # (1 - cos)/angle^2 coefficient to f32 cancellation, differently
    ("so3_left_jacobian", (THETA_SMALL[:2],), 1e-6),
    ("so3_left_jacobian_inv", (THETA,), 1e-4),
    ("se3_exp", (XI,), 1e-5),
    ("se3_log", (Q1, V1), 1e-4),
    ("Qleft", (Q1,), 1e-6),
    ("Qright", (Q1,), 1e-6),
    ("R2ypr", (np.asarray(jlie.q2R(jnp.asarray(Q1))),), 1e-3),
    ("ypr2R", (YPR,), 1e-5),
    ("g2R", (np.array([0.3, -0.2, 9.7], np.float32),), 1e-5),
    ("pose_apply", ((Q1, V1), V2), 1e-5),
    ("pose_compose", ((Q1, V1), (Q2, V2)), 1e-5),
    ("pose_inverse", ((Q1, V1),), 1e-5),
    ("pose_between", ((Q1, V1), (Q2, V2)), 1e-5),
    ("pose_retract", ((Q1, V1), DELTA), 1e-5),
    ("pose_local", ((Q1, V1), (Q2, V2)), 1e-4),
]


@pytest.mark.parametrize("name,args,atol", LIE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LIE_CASES)])
def test_lie_matches_jax(name, args, atol):
    js, ts = _both(name, *args)
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, atol=atol, rtol=0)


def test_lie_roundtrips():
    """test_lie.py's identities on the port: R2q(q2R(q)) (atol 1e-5),
    so3_log(so3_exp) and se3 log/exp (atol 1e-4), retract/local (1e-4)."""
    q = _t(_quats(64, 0))
    np.testing.assert_allclose(tlie.R2q(tlie.q2R(q)).numpy(), q.numpy(), atol=1e-5)
    th = _t(THETA)
    np.testing.assert_allclose(tlie.so3_log(tlie.so3_exp(th)).numpy(), THETA, atol=1e-4)
    xi = _t(XI)
    np.testing.assert_allclose(tlie.se3_log(*tlie.se3_exp(xi)).numpy(), XI, atol=1e-4)
    pose = (_t(Q1), _t(V1))
    np.testing.assert_allclose(
        tlie.pose_local(pose, tlie.pose_retract(pose, _t(DELTA))).numpy(), DELTA, atol=1e-4)
    for axis in range(3):  # 180-degree rotations hit each Shepperd branch
        theta = np.zeros(3, np.float32)
        theta[axis] = np.pi
        R = tlie.q2R(tlie.so3_exp(_t(theta)))
        np.testing.assert_allclose(tlie.q2R(tlie.R2q(R)).numpy(), R.numpy(), atol=1e-5)


def test_lie_left_jacobian_identity():
    """J_l J_l^-1 = I (atol 1e-5) and exp(theta + J_l^-1 eps) ~ exp(eps)
    exp(theta) for small eps (atol 1e-5), as in test_lie.py."""
    theta = torch.tensor([0.3, -0.5, 0.7])
    Jl = tlie.so3_left_jacobian(theta)
    np.testing.assert_allclose((Jl @ tlie.so3_left_jacobian_inv(theta)).numpy(), np.eye(3),
                               atol=1e-5)
    eps = torch.tensor([1e-3, -2e-3, 1.5e-3])
    lhs = tlie.so3_exp_matrix(theta + torch.linalg.solve(Jl, eps))
    rhs = tlie.so3_exp_matrix(eps) @ tlie.so3_exp_matrix(theta)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)


def test_lie_under_vmap_jacfwd():
    """The pose-graph residual path: torch.func.vmap(jacfwd(...)) over the
    retraction matches a central finite difference (atol 2e-3, f32)."""
    from torch.func import jacfwd, vmap

    q, p = _t(Q1[:4]), _t(V1[:4])

    def f(d, q, p):
        qq, pp = tlie.pose_retract((q, p), d)
        return torch.cat([pp, qq])

    z = torch.zeros(4, 6)
    J = vmap(jacfwd(f))(z, q, p)
    assert J.shape == (4, 7, 6)
    h = 1e-3
    for c in range(6):
        e = torch.zeros(4, 6)
        e[:, c] = h
        fd = (vmap(f)(e, q, p) - vmap(f)(-e, q, p)) / (2 * h)
        np.testing.assert_allclose(J[:, :, c].numpy(), fd.numpy(), atol=2e-3)


def _spd(n, b, seed):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(b, n, n)).astype(np.float32)
    return B @ np.swapaxes(B, 1, 2)


@pytest.mark.parametrize("fn", ["sym3x3_eigvalsh", "sym3x3_principal", "sym3x3_smallest"])
def test_sym3x3_matches_jax_and_eigh(fn):
    """Eigenvalues against JAX and np.linalg.eigvalsh at rtol/atol 2e-4;
    eigenvectors against JAX up to sign where the eigenvalue gap is wide
    (atol 2e-3)."""
    A = _spd(3, 500, 0)
    j = getattr(jlinalg, fn)(jnp.asarray(A))
    t = getattr(tlinalg, fn)(torch.from_numpy(A))
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    lam_ref = np.linalg.eigvalsh(A.astype(np.float64))
    np.testing.assert_allclose(t[0].numpy(), lam_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=2e-4, atol=2e-4)
    if len(t) == 2:
        gap = np.diff(lam_ref, axis=1).min(axis=1) > 1e-2 * lam_ref[:, 2]
        vt, vj = t[1].numpy()[gap], np.asarray(j[1])[gap]
        sign = np.sign(np.sum(vt * vj, axis=-1, keepdims=True))
        np.testing.assert_allclose(vt * sign, vj, atol=2e-3)


def test_sym3x3_degenerate():
    """Isotropic, zero and rank-1 matrices stay finite with unit vectors
    (atol 1e-5), as in test_linalg.py."""
    A = torch.stack([torch.eye(3), torch.zeros(3, 3),
                     torch.from_numpy(np.outer([1., 2, 3], [1., 2, 3]).astype(np.float32))])
    for fn in (tlinalg.sym3x3_principal, tlinalg.sym3x3_smallest):
        lam, v = fn(A)
        assert torch.isfinite(lam).all() and torch.isfinite(v).all()
        np.testing.assert_allclose(torch.linalg.norm(v, dim=-1).numpy(), 1.0, atol=1e-5)


def test_gram3_matches_jax():
    """Gram matrices of (N, 5, 3) neighbour sets, rtol 1e-6."""
    x = np.random.default_rng(2).normal(size=(200, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(tlinalg.gram3(torch.from_numpy(x)).numpy(),
                               np.asarray(jlinalg.gram3(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [3, 6, 9])
def test_solve_spd_unrolled(n):
    """Against float64 numpy and against JAX, rtol/atol 2e-3 (test_linalg.py)."""
    rng = np.random.default_rng(7 + n)
    J = rng.normal(size=(64, 2 * n, n)).astype(np.float32)
    A = np.einsum("bki,bkj->bij", J, J) + 1e-3 * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(64, n)).astype(np.float32)
    x = tlinalg.solve_spd_unrolled(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    x_ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, x_ref, rtol=2e-3, atol=2e-3)
    x_j = np.asarray(jlinalg.solve_spd_unrolled(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, x_j, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# voxel: bit-exact hashing and identical buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [4096, 8192, 32768, 1000])
def test_hash_bucket_bit_exact(capacity):
    """uint32 Murmur3 finalizer emulated in int64: identical buckets."""
    rng = np.random.default_rng(capacity)
    keys = np.concatenate([rng.integers(0, 2**30, 5000), [0, 1, 2**30 - 1, 1023, 2**20]])
    keys = keys.astype(np.int32)
    j = np.asarray(jvoxel.hash_bucket(jnp.asarray(keys), capacity))
    t = tvoxel.hash_bucket(torch.from_numpy(keys), capacity).numpy()
    np.testing.assert_array_equal(t, j)


def _cloud(n, seed, valid_frac=0.8, scale=20.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return pts, rng.random(n) < valid_frac


def test_voxel_downsample_hash_exact():
    """Same representative per bucket, bit for bit."""
    pts, val = _cloud(6000, 1)
    origin = np.full(3, -200.0, np.float32)
    j = jvoxel.voxel_downsample_hash(jnp.asarray(pts), jnp.asarray(val), 0.5,
                                     jnp.asarray(origin), 4096)
    t = tvoxel.voxel_downsample_hash(_t(pts), _t(val), 0.5, _t(origin), 4096)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))


def test_merge_voxel_hash_exact():
    pa, va = _cloud(3000, 2)
    pb, vb = _cloud(2000, 3)
    origin = np.array([-100.0, -90.0, -110.0], np.float32)
    j = jvoxel.merge_voxel_hash(jnp.asarray(pa), jnp.asarray(va), jnp.asarray(pb),
                                jnp.asarray(vb), 0.8, jnp.asarray(origin), 2048)
    t = tvoxel.merge_voxel_hash(_t(pa), _t(va), _t(pb), _t(vb), 0.8, _t(origin), 2048)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))


def test_voxel_downsample_centroids_match():
    """Sorted centroid downsample: same occupancy, centroids atol 1e-5
    (segment sums in another order)."""
    pts, val = _cloud(4000, 4, scale=8.0)
    j = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(val), 0.7, jnp.zeros(3) - 10, 1024)
    t = tvoxel.voxel_downsample(_t(pts), _t(val), 0.7, torch.zeros(3) - 10, 1024)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-5)
    # capacity overflow: filled to capacity, no crash
    t2 = tvoxel.voxel_downsample(_t(pts), torch.ones(4000, dtype=torch.bool), 0.1,
                                 torch.zeros(3) - 10, 64)
    assert int(t2[1].sum()) == 64


def test_compact_and_crop_box_exact():
    pts, val = _cloud(500, 5)
    for cap in (128, 600):
        j = jvoxel.compact(jnp.asarray(pts), jnp.asarray(val), cap)
        t = tvoxel.compact(_t(pts), _t(val), cap)
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    c = np.array([1.0, -2.0, 0.5], np.float32)
    j = jvoxel.crop_box(jnp.asarray(pts), jnp.asarray(val), jnp.asarray(c), 9.0, 256)
    t = tvoxel.crop_box(_t(pts), _t(val), _t(c), 9.0, 256)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
