"""Plain point-to-plane registration, written for the benchmark alone.

`align(src, tgt, T0, arith)` moves the points `src` (N, 3) onto the
surfaces sampled by `tgt` (M, 3), starting from the pose `T0` = (R, t):
every step finds each moved source point's 5 nearest target points by brute
force, fits a plane to them (the eigenvector of their scatter's smallest
eigenvalue; a fit whose points are not flat, as at a corner, is dropped),
and takes one damped Gauss-Newton step of the Huber-weighted
point-to-plane residuals on the pose's six coordinates. It stops when the
step is below 1e-9 or after `ITERS` steps.

It shares no code with the system under test. Its arithmetic is a
parameter: `FLOAT64` is the reference; `TF32` is its control, the same
computation in float32 with the inputs of every matrix product rounded to
TF32 (10 mantissa bits, as the card's tensor cores round them), which is
the precision below the configurations' float32 with TF32 off. The kNN
takes its squared distances in the expanded form |a|^2 + |b|^2 - 2 a.b,
whose product is such a matrix product.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

K = 5  # neighbours of a plane
ITERS = 30  # Gauss-Newton steps at most
MAX_NEIGHBOUR_M = 2.0  # a plane's farthest neighbour at most this far from the point
PLANE_TOL_M = 0.1  # a plane's neighbours at most this far from it
FLATNESS = 0.03  # and their scatter's smallest eigenvalue at most this share of the middle one
HUBER_M = 0.1
DAMPING = 1e-6


class Arith(NamedTuple):
    dtype: torch.dtype
    tf32: bool


FLOAT64 = Arith(torch.float64, False)
TF32 = Arith(torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away from
    zero), kept in float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, arith: Arith) -> torch.Tensor:
    if arith.tf32:
        return tf32_round(a) @ tf32_round(b)
    return a @ b


def knn(q: torch.Tensor, ref: torch.Tensor, k: int, arith: Arith, chunk: int = 2048):
    """(squared distances (N, k), indices (N, k)) of each row of `q`'s k
    nearest rows of `ref`, by brute force, nearest first."""
    rr = (ref * ref).sum(-1)
    d2s, idxs = [], []
    for a in range(0, q.shape[0], chunk):
        qc = q[a:a + chunk]
        d2 = (qc * qc).sum(-1)[:, None] + rr[None, :] - 2.0 * mm(qc, ref.T, arith)
        v, i = torch.topk(d2, k, dim=1, largest=False)
        d2s.append(v.clamp_min(0.0))
        idxs.append(i)
    return torch.cat(d2s), torch.cat(idxs)


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w)
    W = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-12:
        return eye + W
    return eye + torch.sin(th) / th * W + (1.0 - torch.cos(th)) / th ** 2 * (W @ W)


def planes(y: torch.Tensor, tgt: torch.Tensor, arith: Arith):
    """For each point of `y` (N, 3): the plane of its K nearest target points
    (unit normal (N, 3), centroid (N, 3)) and whether it is one (N,)."""
    d2, idx = knn(y, tgt, K, arith)
    nb = tgt[idx]  # (N, K, 3)
    c = nb.mean(1)
    dev = nb - c[:, None, :]
    cov = dev.transpose(1, 2) @ dev
    lam, vec = torch.linalg.eigh(cov)
    n = vec[..., 0]
    ok = (d2[:, -1] <= MAX_NEIGHBOUR_M ** 2) & (lam[:, 0] <= FLATNESS * lam[:, 1]) & \
        ((dev * n[:, None, :]).sum(-1).abs().amax(1) <= PLANE_TOL_M)
    return n, c, ok


def align(src, tgt, T0, arith: Arith = FLOAT64):
    """The pose (R (3, 3), t (3,)) that puts `src` onto the surfaces of `tgt`,
    from `T0`; and the number of source points on a plane at the end."""
    src = src.to(arith.dtype)
    tgt = tgt.to(arith.dtype)
    R = torch.as_tensor(T0[0], dtype=arith.dtype, device=src.device)
    t = torch.as_tensor(T0[1], dtype=arith.dtype, device=src.device)
    n_ok = 0
    for _ in range(ITERS):
        y = mm(src, R.T, arith) + t
        n, c, ok = planes(y, tgt, arith)
        r = ((y - c) * n).sum(-1)
        w = ok.to(r.dtype) * torch.clamp(HUBER_M / r.abs().clamp_min(1e-12), max=1.0)
        J = torch.cat([torch.linalg.cross(y, n), n], -1)  # d r / d (rotation, translation)
        Jw = J * w[:, None]
        H = mm(Jw.T, J, arith)
        g = mm(Jw.T, r[:, None], arith)[:, 0]
        H = H + DAMPING * torch.diag(torch.diagonal(H) + 1.0)
        step = -torch.linalg.solve(H, g)
        dR = so3_exp(step[:3])
        R, t = dR @ R, dR @ t + step[3:]
        n_ok = int(ok.sum())
        if float(torch.linalg.norm(step)) < 1e-9:
            break
    return (R, t), n_ok


# -- poses as (R, t) in float64 numpy ----------------------------------------

def q_to_R(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in np.asarray(q, np.float64) / np.linalg.norm(q))
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def pose(q, p) -> tuple:
    """(R, t) of a quaternion (w, x, y, z) and a position."""
    return q_to_R(q), np.asarray(p, np.float64).reshape(3)


def compose(a, b) -> tuple:
    return a[0] @ b[0], a[0] @ b[1] + a[1]


def inverse(a) -> tuple:
    return a[0].T, -a[0].T @ a[1]


def host(T) -> tuple:
    return (np.asarray(T[0].detach().cpu().double().numpy() if isinstance(T[0], torch.Tensor)
                       else T[0], np.float64),
            np.asarray(T[1].detach().cpu().double().numpy() if isinstance(T[1], torch.Tensor)
                       else T[1], np.float64))


def gaps(a, b) -> tuple:
    """(distance in m, angle in degrees) between two poses."""
    a, b = host(a), host(b)
    # |R_a - R_b|_F = 2 sqrt(2) sin(angle / 2), exact to rounding at small angles
    s = np.linalg.norm(a[0] - b[0]) / (2.0 * np.sqrt(2.0))
    ang = np.degrees(2.0 * np.arcsin(np.clip(s, 0.0, 1.0)))
    return float(np.linalg.norm(a[1] - b[1])), float(ang)
