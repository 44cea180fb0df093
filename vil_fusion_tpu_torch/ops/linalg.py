"""Small closed-form linear algebra for batched geometry.

Port of vil_fusion_tpu/ops/linalg.py: Cardano eigenvalues + cross-product
eigenvectors for thousands of 3x3 covariances per frame, the unrolled
Cholesky solve of the 6x6 Gauss-Newton system, and what the tracker's RANSAC
needs (Cramer 3x3 solve, smallest eigenvector by inverse iteration), and
`sym_eigh`, the dispatcher of the symmetric eigensolver of the
marginalization (the reference's jnp.linalg.eigh).
"""
from __future__ import annotations

import math

import torch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def sym3x3_eigvalsh(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending — Cardano's formula
    (Smith's algorithm)."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    iso = p2 < 1e-20  # (near-)isotropic: all eigenvalues equal q
    p = torch.sqrt(torch.clamp(torch.where(iso, torch.ones_like(p2), p2) / 6.0, min=1e-30))
    inv_p = 1.0 / p
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    half_det = (b00 * c00 - a01 * c01 + a02 * c02) * (inv_p * inv_p * inv_p) * 0.5
    half_det = torch.clamp(half_det, -1.0, 1.0)
    phi = torch.acos(half_det) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    out = torch.stack([e_lo, e_mid, e_hi], dim=-1)
    return torch.where(iso[..., None], q[..., None], out)


def gram3(x):
    """(..., K, 3) -> (..., 3, 3) Gram matrix sum_k x_k x_k^T (6 unique
    entries as elementwise products)."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    g00 = torch.sum(x0 * x0, dim=-1)
    g01 = torch.sum(x0 * x1, dim=-1)
    g02 = torch.sum(x0 * x2, dim=-1)
    g11 = torch.sum(x1 * x1, dim=-1)
    g12 = torch.sum(x1 * x2, dim=-1)
    g22 = torch.sum(x2 * x2, dim=-1)
    row0 = torch.stack([g00, g01, g02], dim=-1)
    row1 = torch.stack([g01, g11, g12], dim=-1)
    row2 = torch.stack([g02, g12, g22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _null_direction(A, lam):
    """Unit null direction of (A - lam I) from the largest-norm cross
    product of its rows; +z where the direction is degenerate."""
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0 = B[..., 0, :]
    r1 = B[..., 1, :]
    r2 = B[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where((n01 >= n02)[..., None] & (n01 >= n12)[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    norm = torch.linalg.norm(best, dim=-1, keepdim=True)
    v = best / torch.clamp(norm, min=1e-12)
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    return torch.where(norm > 1e-10, v, z)


def sym3x3_smallest(A):
    """(eigvals ascending (..., 3), SMALLEST eigenvector (..., 3))."""
    lams = sym3x3_eigvalsh(A)
    return lams, _null_direction(A, lams[..., 0])


def sym3x3_principal(A):
    """(eigvals ascending (..., 3), principal eigenvector (..., 3))."""
    lams = sym3x3_eigvalsh(A)
    return lams, _null_direction(A, lams[..., 2])


def solve_spd_unrolled(A, b):
    """x = A^{-1} b for small SPD systems (n static) via an unrolled scalar
    Cholesky + two triangular solves, batched over leading dims. A
    non-positive pivot is clamped, yielding a finite (if inexact) step."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-20))
        L[j][j] = d
        for i in range(j + 1, n):
            s2 = A[..., i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 / d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def solve3x3(A, b):
    """Batched closed-form 3x3 solve by Cramer's rule (A (..., 3, 3),
    b (..., 3)). Singular A gives non-finite output; callers gate."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / det
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + (a02 * a21 - a01 * a22) * b1 + (a01 * a12 - a02 * a11) * b2)
    x1 = (c01 * b0 + (a00 * a22 - a02 * a20) * b1 + (a02 * a10 - a00 * a12) * b2)
    x2 = (c02 * b0 + (a01 * a20 - a00 * a21) * b1 + (a00 * a11 - a01 * a10) * b2)
    return torch.stack([x0, x1, x2], dim=-1) * inv_det[..., None]


def smallest_eigvec_inverse_iteration(A, iters: int = 4, shift: float = 1e-6):
    """Smallest eigenvector of each symmetric PSD (..., n, n) by inverse
    iteration on one Cholesky factor (factor once, `iters` pairs of
    triangular solves). Assumes the smallest eigenvalue is well separated
    (true for RANSAC nullspace problems; a degenerate hypothesis, whose
    factorization fails, falls back to the identity factor and yields a
    garbage vector that the consensus scoring rejects)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = A + (shift * torch.clamp(tr, min=1e-12) / n) * eye
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0) | ~torch.isfinite(L[..., n - 1, n - 1])
    L = torch.where(bad[..., None, None], eye, L)
    x = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        y = torch.linalg.solve_triangular(L, x[..., None], upper=False)
        z = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
        x = z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True), min=1e-30)
    return x


def sym_eigh(A):
    """(eigenvalues ascending, eigenvectors as columns) of the symmetric
    float32 A (..., n, n), from its lower triangle: on a CUDA tensor the
    kernels of csrc/eigh.cu (ops/cuda/eigh_cuda.eigh, n <= 172: a warp
    Jacobi up to 32, Householder + QL above), which never wait for the
    device; on the CPU their plain version,
    torch.linalg.eigh. Eigenvectors of either carry an arbitrary sign (and
    basis, for a repeated eigenvalue)."""
    if A.device.type == "cpu":
        return torch.linalg.eigh(A)
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda

    return eigh_cuda.eigh(A)


def _horn_basis():
    """C (3, 3, 4, 4) with Horn's 4 x 4 matrix N = sum_ab S_ab C[a, b] of a
    cross-covariance S (Horn 1987, quaternion order w, x, y, z)."""
    import numpy as np

    C = np.zeros((3, 3, 4, 4))
    x, y, z = 0, 1, 2
    for i, j, terms in ((0, 0, ((x, x, 1), (y, y, 1), (z, z, 1))),
                        (0, 1, ((y, z, 1), (z, y, -1))), (0, 2, ((z, x, 1), (x, z, -1))),
                        (0, 3, ((x, y, 1), (y, x, -1))),
                        (1, 1, ((x, x, 1), (y, y, -1), (z, z, -1))),
                        (1, 2, ((x, y, 1), (y, x, 1))), (1, 3, ((z, x, 1), (x, z, 1))),
                        (2, 2, ((x, x, -1), (y, y, 1), (z, z, -1))),
                        (2, 3, ((y, z, 1), (z, y, 1))),
                        (3, 3, ((x, x, -1), (y, y, -1), (z, z, 1)))):
        for a, b, s in terms:
            C[a, b, i, j] = C[a, b, j, i] = s
    return C


_HORN = _horn_basis()


def kabsch_rotation(H, squarings: int = 24):
    """The rotation R maximizing tr(R H^T) over SO(3) for the 3 x 3
    cross-covariance H = sum_k x_k y_k^T (so y ~ R x): the Kabsch solution
    V diag(1, 1, sign det(V U^T)) U^T of H = U S V^T, the reflection fix
    included, which the reference takes from jnp.linalg.svd. Here it is the
    quaternion of the largest eigenvalue of Horn's symmetric 4 x 4 matrix N
    (a quaternion spans SO(3) only, hence no reflection), in float64 by
    repeated squaring of N + ||N|| I (eigenvalues >= 0; `squarings`
    squarings raise the eigenvalue ratio to the power 2^squarings: 24
    separate a gap of 1e-6 of the largest), normalized by the trace every
    three; the eigenvector is the column of the largest diagonal entry. A
    fixed count of small matmuls with no host read and no library solver,
    so a CUDA graph holds it (torch.linalg.svd waits for the device). H = 0
    gives the identity, as the SVD's does. Returns R in H's dtype."""
    from vil_fusion_tpu_torch.ops import lie
    from vil_fusion_tpu_torch.utils.graphs import host_constant

    dev = H.device
    N = torch.einsum("ab,abij->ij", H.to(torch.float64),
                     host_constant(_HORN, torch.float64, dev))
    B = N + (torch.linalg.vector_norm(N) + 1e-300) * host_constant(
        torch.eye(4).tolist(), torch.float64, dev)
    for k in range(squarings):
        if k % 3 == 0:
            B = B / torch.trace(B)
        B = B @ B
    B = B / torch.trace(B)
    col = B.index_select(1, torch.argmax(torch.diagonal(B)).reshape(1))[:, 0]
    q = col / torch.linalg.vector_norm(col)
    return lie.q2R(q).to(H.dtype)
