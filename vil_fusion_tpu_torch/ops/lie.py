"""Batched Lie-group / quaternion operations (SO(3), SE(3)) on torch tensors.

Port of vil_fusion_tpu/ops/lie.py. Everything is a pure function,
shape-polymorphic over leading batch dimensions, dtype- and device-
preserving, and safe under `torch.func.vmap`/`jacfwd` (no data-dependent
branches; small-angle cases switch with `torch.where` over both branches).

Quaternion convention: Hamilton, stored (w, x, y, z). Rotations act on column
vectors: `qrot(q, v) == q2R(q) @ v`. Poses are (q, p) pairs with
`pose_apply((q, p), x) = qrot(q, x) + p`.
"""
from __future__ import annotations

import math

import torch

from vil_fusion_tpu_torch.utils.graphs import host_constant

# Tangent-space state ordering of the sliding-window estimator.
O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12

_EPS = 1e-8


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def qmul(q1, q2):
    """Hamilton product, (..., 4) x (..., 4) -> (..., 4)."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qinv(q):
    """Inverse of a (possibly non-unit) quaternion."""
    return qconj(q) / torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=_EPS)


def qnormalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def positify(q):
    """Flip sign so w >= 0."""
    return torch.where(q[..., :1] < 0, -q, q)


def qrot(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def q2R(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def R2q(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), branchless
    (all four Shepperd candidates, best-conditioned one selected)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None], q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)))
    return positify(qnormalize(q))


def so3_exp(theta):
    """Axis-angle (..., 3) -> unit quaternion (..., 4), exact with Taylor
    fallback for small angles."""
    angle2 = torch.sum(theta * theta, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle2, min=_EPS * _EPS))
    half = 0.5 * angle
    small = angle2 < 1e-12
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(half))
    return torch.cat([w, k * theta], dim=-1)


def so3_log(q):
    """Unit quaternion (..., 4) -> axis-angle (..., 3)."""
    q = positify(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-8
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS),
                    angle / torch.clamp(vn, min=_EPS))
    return k * q[..., 1:]


def so3_exp_matrix(theta):
    """Axis-angle (..., 3) -> rotation matrix (Rodrigues)."""
    return q2R(so3_exp(theta))


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_left_jacobian(theta):
    """Left Jacobian of SO(3): J_l(theta), (..., 3) -> (..., 3, 3)."""
    angle2 = torch.sum(theta * theta, dim=-1)[..., None, None]
    angle = torch.sqrt(torch.clamp(angle2, min=_EPS * _EPS))
    K = skew(theta)
    K2 = K @ K
    small = angle2 < 1e-10
    a = torch.where(small, 0.5 - angle2 / 24.0,
                    (1.0 - torch.cos(angle)) / torch.clamp(angle2, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - angle2 / 120.0,
                    (angle - torch.sin(angle)) / torch.clamp(angle2 * angle, min=_EPS))
    return _eye3(theta) + a * K + b * K2


def so3_left_jacobian_inv(theta):
    angle2 = torch.sum(theta * theta, dim=-1)[..., None, None]
    angle = torch.sqrt(torch.clamp(angle2, min=_EPS * _EPS))
    K = skew(theta)
    K2 = K @ K
    small = angle2 < 1e-10
    cot_term = torch.where(
        small,
        1.0 / 12.0 + angle2 / 720.0,
        (1.0 / torch.clamp(angle2, min=_EPS))
        - (1.0 + torch.cos(angle)) / torch.clamp(2.0 * angle * torch.sin(angle), min=_EPS),
    )
    return _eye3(theta) - 0.5 * K + cot_term * K2


def se3_exp(xi):
    """se(3) twist (..., 6) [rho, theta] -> pose (q, p)."""
    rho, theta = xi[..., :3], xi[..., 3:]
    q = so3_exp(theta)
    p = torch.einsum("...ij,...j->...i", so3_left_jacobian(theta), rho)
    return q, p


def se3_log(q, p):
    """Pose (q, p) -> twist (..., 6) [rho, theta]."""
    theta = so3_log(q)
    rho = torch.einsum("...ij,...j->...i", so3_left_jacobian_inv(theta), p)
    return torch.cat([rho, theta], dim=-1)


def Qleft(q):
    """Left-multiplication matrix: Qleft(q) @ r == qmul(q, r)."""
    w = q[..., 0]
    v = q[..., 1:]
    top = torch.cat([w[..., None], -v], dim=-1)[..., None, :]
    bottom_left = v[..., :, None]
    bottom_right = w[..., None, None] * _eye3(q) + skew(v)
    bottom = torch.cat([bottom_left, bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def Qright(q):
    """Right-multiplication matrix: Qright(q) @ r == qmul(r, q)."""
    w = q[..., 0]
    v = q[..., 1:]
    top = torch.cat([w[..., None], -v], dim=-1)[..., None, :]
    bottom_left = v[..., :, None]
    bottom_right = w[..., None, None] * _eye3(q) - skew(v)
    bottom = torch.cat([bottom_left, bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Euler (yaw-pitch-roll, degrees)
# ---------------------------------------------------------------------------

def R2ypr(R):
    """Rotation matrix -> (yaw, pitch, roll) in degrees."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) / math.pi * 180.0


def ypr2R(ypr):
    """(yaw, pitch, roll) degrees -> rotation matrix."""
    ypr_rad = ypr / 180.0 * math.pi
    y, p, r = ypr_rad[..., 0], ypr_rad[..., 1], ypr_rad[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    zero = torch.zeros_like(y)
    one = torch.ones_like(y)
    Rz = torch.stack([torch.stack([cy, -sy, zero], dim=-1),
                      torch.stack([sy, cy, zero], dim=-1),
                      torch.stack([zero, zero, one], dim=-1)], dim=-2)
    Ry = torch.stack([torch.stack([cp, zero, sp], dim=-1),
                      torch.stack([zero, one, zero], dim=-1),
                      torch.stack([-sp, zero, cp], dim=-1)], dim=-2)
    Rx = torch.stack([torch.stack([one, zero, zero], dim=-1),
                      torch.stack([zero, cr, -sr], dim=-1),
                      torch.stack([zero, sr, cr], dim=-1)], dim=-2)
    return Rz @ Ry @ Rx


def g2R(g):
    """Rotation taking gravity direction g to +z with zero yaw."""
    ng1 = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=_EPS)
    ng2 = host_constant((0.0, 0.0, 1.0), g.dtype, g.device)
    v = _cross(ng1, ng2)
    c = torch.sum(ng1 * ng2, dim=-1)
    vn = torch.linalg.norm(v, dim=-1)
    angle = torch.atan2(vn, c)
    axis = v / torch.clamp(vn, min=_EPS)[..., None]
    R0 = so3_exp_matrix(axis * angle[..., None])
    yaw = R2ypr(R0)[..., 0]
    zero = torch.zeros_like(yaw)
    return ypr2R(torch.stack([-yaw, zero, zero], dim=-1)) @ R0


# ---------------------------------------------------------------------------
# Pose (q, p) algebra
# ---------------------------------------------------------------------------

def pose_identity(dtype=torch.float32, batch=(), device=None):
    q = torch.zeros(tuple(batch) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    p = torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)
    return q, p


def pose_apply(pose, x):
    q, p = pose
    return qrot(q, x) + p


def pose_compose(pose_a, pose_b):
    """T_a * T_b."""
    qa, pa = pose_a
    qb, pb = pose_b
    return qnormalize(qmul(qa, qb)), qrot(qa, pb) + pa


def pose_inverse(pose):
    q, p = pose
    qi = qconj(q)
    return qi, -qrot(qi, p)


def pose_between(pose_a, pose_b):
    """T_a^{-1} * T_b (relative pose)."""
    return pose_compose(pose_inverse(pose_a), pose_b)


def pose_retract(pose, delta):
    """Right-perturbation retraction: (q, p) ⊞ [dp, dtheta]."""
    q, p = pose
    dp, dth = delta[..., :3], delta[..., 3:]
    return qnormalize(qmul(q, so3_exp(dth))), p + dp


def pose_local(pose_a, pose_b):
    """Inverse retraction: delta such that pose_a ⊞ delta ≈ pose_b."""
    qa, pa = pose_a
    qb, pb = pose_b
    dth = so3_log(qmul(qconj(qa), qb))
    return torch.cat([pb - pa, dth], dim=-1)
