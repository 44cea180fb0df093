"""A numpy mirror of the eigensolver kernels of csrc/eigh.cu, stage by
stage and in their precisions: float32 where a kernel stores a value,
float64 where it computes one. Numpy only, so that the card tests (run
with --noconftest, no jax) can hold the kernels against it too.

`eigh(A)` dispatches as the kernels' launcher does: n <= WARP_MAX_N to
`jacobi_warp` (parallel cyclic Jacobi, one warp a matrix), larger n to
`householder_ql` (Householder tridiagonalization, implicit QL with
Wilkinson shifts, eigenvectors as Q Z). Both work for any n >= 1. Each
returns (eigenvalues ascending float32 (n,), eigenvectors as the columns of
a float32 (n, n), stats) where stats is (QL iterations or Jacobi sweeps,
rotations). The summation orders differ from the kernels', so the mirror
agrees with a kernel to the tolerances, not bit for bit.
"""
import math

import numpy as np

WARP_MAX_N = 32
MAX_SWEEPS = 30  # Jacobi
MAX_QL_ITERS = 30  # QL iterations an eigenvalue before it is taken as it is
# the sweeps stop once ||off(A)||_F <= TOL ||A||_F: four float32 ulps
TOL = 4.0 * 2.0 ** -24
# a QL off-diagonal entry is zero once |e_m| <= EPS (|d_m| + |d_m+1|): 2^-30,
# 64 times below the float32 resolution of the outputs
EPS = 2.0 ** -30

f32, f64 = np.float32, np.float64


def _symmetric(A):
    """The float32 matrix of A's lower triangle, mirrored."""
    A = np.asarray(A, f32)
    L = np.tril(A)
    return L + np.tril(A, -1).T


def _ranked(w, V):
    """Eigenvalues ascending (ties to the lower index) and V's columns in
    that order."""
    order = np.argsort(w, kind="stable")
    return w[order].astype(f32), V[:, order]


def householder_reduce(A):
    """Stage 1: A (float32, symmetric) -> (d, e, reflectors, tau), with
    A = Q T Q^T, T = tridiag(e, d, e) (float64), Q = H_0 ... H_{n-3} and
    H_k = I - tau_k v_k v_k^T acting on indices k+1..n-1. The trailing
    matrix is float64 (the kernel keeps its lower triangle, packed); v_k,
    scaled to v_k[0] = 1, is rounded to float32, as the kernel stores it
    for stage 2, and tau_k and the update use that rounded v_k, so that H_k
    stays orthogonal."""
    A = A.astype(f64)
    n = A.shape[0]
    d, e, tau = np.zeros(n, f64), np.zeros(n, f64), np.zeros(n, f64)
    refl = []
    for k in range(n - 2):
        x = A[k + 1:, k]
        x0 = x[0]
        ss = np.dot(x[1:], x[1:])
        d[k] = A[k, k]
        v = x.astype(f32)
        if ss == 0.0:  # the column is reduced already
            e[k] = x0
            refl.append(v)
            continue
        alpha = -np.copysign(np.sqrt(x0 * x0 + ss), x0)
        v = (x * (1.0 / (x0 - alpha))).astype(f32)  # v_0 = 1, |v_i| <= 1
        v[0] = 1.0
        vd = v.astype(f64)
        t = 2.0 / np.dot(vd, vd)
        tau[k], e[k] = t, alpha
        refl.append(v)
        At = A[k + 1:, k + 1:]
        p = t * (At @ vd)
        K = 0.5 * t * np.dot(vd, p)
        w = p - K * vd
        A[k + 1:, k + 1:] = At - (np.outer(vd, w) + np.outer(w, vd))
    if n >= 2:
        d[n - 2], d[n - 1], e[n - 2] = A[n - 2, n - 2], A[n - 1, n - 1], A[n - 1, n - 2]
    else:
        d[0] = A[0, 0]
    return d, e, refl, tau


def form_q(refl, tau, n):
    """Q = H_0 ... H_{n-3} in float32 (column j by its own thread in the
    kernel: reflectors from the last to the first, the dot product in
    float64, each update rounded to float32)."""
    Q = np.eye(n, dtype=f32)
    for k in range(n - 3, -1, -1):
        if tau[k] == 0.0:
            continue
        v = refl[k].astype(f64)
        X = Q[k + 1:, :].astype(f64)
        t = tau[k] * (v @ X)
        Q[k + 1:, :] = (X - np.outer(v, t)).astype(f32)
    return Q


def ql_rotations(d, e):
    """Stage 2, the producer: implicit QL with Wilkinson shifts on the
    tridiagonal (d, e) in float64 (Python floats). Returns the eigenvalues
    (float64, unordered), the Givens rotations (i, c, s) in the order the
    kernel streams them, and the QL iterations."""
    n = d.shape[0]
    d, e = [float(x) for x in d], [float(x) for x in e]
    e[n - 1] = 0.0
    rots, iters = [], 0
    for l in range(n):
        it = 0
        while True:
            m = l
            while m < n - 1:
                if not abs(e[m]) > EPS * (abs(d[m]) + abs(d[m + 1])):
                    break
                m += 1
            if m == l or it == MAX_QL_ITERS:
                break
            it += 1
            iters += 1
            g = (d[l + 1] - d[l]) / (2.0 * e[l])
            r = math.sqrt(g * g + 1.0)
            g = d[m] - d[l] + e[l] / (g + math.copysign(r, g))
            s = c = 1.0
            p = 0.0
            i = m - 1
            early = False
            while i >= l:
                f = s * e[i]
                b = c * e[i]
                q = f * f + g * g
                if q == 0.0:  # the chain ends: e_i+1 is zero
                    d[i + 1] -= p
                    e[m] = 0.0
                    early = True
                    break
                # r = sqrt(q), s = f / r, c = g / r; the next g and p through
                # w = 1 / q: g' = c (d_i - g_t) s + 2 c^2 b - b = g X w - b
                inv = 1.0 / math.sqrt(q)
                w = inv * inv
                e[i + 1] = q * inv
                gt = d[i + 1] - p
                X = (d[i] - gt) * f + 2.0 * g * b
                s, c = f * inv, g * inv
                p = (f * X) * w
                d[i + 1] = gt + p
                g = (g * X) * w - b
                rots.append((i, c, s))
                i -= 1
            if early:
                continue
            d[l] -= p
            e[l] = g
            e[m] = 0.0
    return np.array(d, f64), rots, iters


def apply_rotations(Z, rots):
    """Stage 2, the consumers: Z <- Z G_1 G_2 ... in place, each row by its
    own thread. A rotation of columns (i, i+1); column i stays in a float64
    register while the chain walks down (the next rotation is at i - 1),
    every other value is float32 in shared memory."""
    ci, cv = -1, None
    for i, c, s in rots:
        if ci == i + 1:
            z1 = cv
        else:
            if ci >= 0:
                Z[:, ci] = cv.astype(f32)
            z1 = Z[:, i + 1].astype(f64)
        z0 = Z[:, i].astype(f64)
        Z[:, i + 1] = (s * z0 + c * z1).astype(f32)
        ci, cv = i, c * z0 - s * z1
    if ci >= 0:
        Z[:, ci] = cv.astype(f32)
    return Z


def householder_ql(A):
    """The block kernel for one matrix: (w, V, (QL iterations, rotations))."""
    A = _symmetric(A)
    n = A.shape[0]
    d, e, refl, tau = householder_reduce(A)
    Q = form_q(refl, tau, n)
    d, rots, iters = ql_rotations(d, e)
    V = apply_rotations(Q, rots)
    order = np.lexsort((np.arange(n), d))
    return d[order].astype(f32), V[:, order], (iters, len(rots))


def jacobi_warp(A, tol=TOL):
    """The warp kernel for one matrix: parallel cyclic Jacobi (round-robin
    pairs), A and V^T in float32; each rotation's (c, s) and the new
    diagonal computed in float64 and rounded to float32, the rotated
    elements in float32 (each product and sum rounded)."""
    A = _symmetric(A)
    n = A.shape[0]
    Vt = np.eye(n, dtype=f32)
    m = n + (n & 1)
    np_ = m // 2
    stop = tol * tol * np.sum(A.astype(f64) ** 2)
    offmask = ~np.eye(n, dtype=bool)
    sweeps = rotations = 0
    t = np.arange(np_)
    while sweeps < MAX_SWEEPS:
        off = np.sum(A.astype(f64)[offmask] ** 2)
        if not off > stop:
            break
        rotated = False
        for r in range(m - 1):
            p = np.where(t == 0, r, (r + t) % (m - 1))
            q = np.where(t == 0, m - 1, (r - t + (m - 1)) % (m - 1))
            p, q = np.minimum(p, q), np.maximum(p, q)
            keep = q < n
            p, q = p[keep], q[keep]
            apq = A[p, q].astype(f64)
            keep = apq != 0.0
            p, q, apq = p[keep], q[keep], apq[keep]
            if p.size == 0:
                continue
            rotated = True
            rotations += p.size
            app, aqq = A[p, p].astype(f64), A[q, q].astype(f64)
            x, y = aqq - app, 2.0 * apq
            ih = 1.0 / np.sqrt(x * x + y * y)
            u = 0.5 * (np.abs(x) * ih + 1.0)
            ru = 1.0 / np.sqrt(u)
            sn = np.where(x >= 0.0, 0.5, -0.5) * y * ih * ru
            tt = sn * ru
            c, s = (u * ru).astype(f32), sn.astype(f32)
            dp, dq = (app - tt * apq).astype(f32), (aqq + tt * apq).astype(f32)
            cc, ss = c[:, None], s[:, None]
            for M in (A, Vt):  # rows p, q
                x, y = M[p, :], M[q, :]
                M[p, :], M[q, :] = cc * x - ss * y, ss * x + cc * y
            x, y = A[:, p], A[:, q]  # columns p, q
            A[:, p], A[:, q] = x * c - y * s, x * s + y * c
            A[p, p], A[p, q], A[q, p], A[q, q] = dp, 0.0, 0.0, dq
        sweeps += 1
        if not rotated:
            break
    w, V = _ranked(np.diag(A).copy(), Vt.T)
    return w, V, (sweeps, rotations)


def eigh(A):
    """(w ascending float32, V float32 with eigenvectors as columns, stats)
    of the symmetric matrix A from its lower triangle, by the kernel the
    launcher picks for its size."""
    n = np.asarray(A).shape[-1]
    return jacobi_warp(A) if n <= WARP_MAX_N else householder_ql(A)
