"""IMU preintegration (midpoint) with bias Jacobian + covariance propagation.

Port of vil_fusion_tpu/models/imu.py (the reference's `IntegrationBase`,
integration_base.h:9-209): `_midpoint_step` is one midpoint integration step
with its 15x15 error-state transition, `preintegrate` runs it over a padded
segment, `residual` is `evaluate` (:160-186).

  * Fixed-capacity segments: steps are padded with dt == 0, which is an
    identity update (F = I, V = 0), so no masks are needed. The reference's
    `lax.scan` over the steps is a Python loop over the fixed capacity here.
  * The 15x15 first-order bias Jacobian is propagated analytically (fast
    bias correction inside the BA iteration without re-integrating).
  * State tangent ordering [p, theta, v, ba, bg] = lie.O_P..O_BG.
  * `preintegrate_parallel` (preintegrate(parallel=True)) is the same
    midpoint math in log depth: batched per-step pieces and two associative
    scans (`associative_scan`, jax.lax.associative_scan's combine order).
    The sequential loop stays the default, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vil_fusion_tpu_torch.ops import lie


class ImuNoise(NamedTuple):
    """Continuous-time IMU noise densities (parameters.cpp ACC_N/GYR_N/ACC_W/GYR_W)."""

    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 0.00004
    gyr_w: float = 2.0e-6


class Preintegrated(NamedTuple):
    """Result of preintegrating one IMU segment between two image frames."""

    dp: torch.Tensor  # (..., 3) position delta in frame i
    dq: torch.Tensor  # (..., 4) rotation delta
    dv: torch.Tensor  # (..., 3) velocity delta
    jac: torch.Tensor  # (..., 15, 15) d(state)/d(initial state + biases)
    cov: torch.Tensor  # (..., 15, 15) covariance of the deltas
    dt_sum: torch.Tensor  # (...,) total integration time
    ba: torch.Tensor  # (..., 3) linearization accel bias
    bg: torch.Tensor  # (..., 3) linearization gyro bias


def _noise_cov(noise: ImuNoise, dtype, device) -> torch.Tensor:
    """18x18 discrete noise covariance (integration_base.h:39-46 semantics)."""
    d = torch.tensor(
        [noise.acc_n**2] * 3
        + [noise.gyr_n**2] * 3
        + [noise.acc_n**2] * 3
        + [noise.gyr_n**2] * 3
        + [noise.acc_w**2] * 3
        + [noise.gyr_w**2] * 3,
        dtype=dtype, device=device,
    )
    return torch.diag(d)


def _midpoint_step(carry, inputs, ba, bg, Q18):
    """One midpoint integration step; dt == 0 is an identity update."""
    dp, dq, dv, jac, cov = carry
    acc0, gyr0, acc1, gyr1, dt = inputs
    eye3 = torch.eye(3, dtype=dp.dtype, device=dp.device)

    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    dq_new = lie.qnormalize(lie.qmul(dq, lie.so3_exp(un_gyr * dt)))
    R0 = lie.q2R(dq)
    R1 = lie.q2R(dq_new)
    a0 = acc0 - ba
    a1 = acc1 - ba
    un_acc = 0.5 * (R0 @ a0 + R1 @ a1)
    dp_new = dp + dv * dt + 0.5 * un_acc * dt * dt
    dv_new = dv + un_acc * dt

    # --- discrete error-state transition F (15x15) and noise map V (15x18) ---
    a0h = lie.skew(a0)
    a1h = lie.skew(a1)
    wh = lie.skew(un_gyr)
    I_wdt = eye3 - wh * dt  # d(theta_{k+1})/d(theta_k)
    R1a1 = R1 @ a1h
    dt2 = dt * dt
    Z = torch.zeros_like(eye3)

    F = torch.cat([
        torch.cat([eye3, -0.25 * (R0 @ a0h) * dt2 - 0.25 * R1a1 @ I_wdt * dt2, eye3 * dt,
                   -0.25 * (R0 + R1) * dt2, 0.25 * R1a1 * dt2 * dt], dim=1),
        torch.cat([Z, I_wdt, Z, Z, -eye3 * dt], dim=1),
        torch.cat([Z, -0.5 * (R0 @ a0h) * dt - 0.5 * R1a1 @ I_wdt * dt, eye3,
                   -0.5 * (R0 + R1) * dt, 0.5 * R1a1 * dt * dt], dim=1),
        torch.cat([Z, Z, Z, eye3, Z], dim=1),
        torch.cat([Z, Z, Z, Z, eye3], dim=1),
    ], dim=0)
    V = torch.cat([
        torch.cat([0.25 * R0 * dt2, -0.125 * R1a1 * dt2 * dt, 0.25 * R1 * dt2,
                   -0.125 * R1a1 * dt2 * dt, Z, Z], dim=1),
        torch.cat([Z, 0.5 * eye3 * dt, Z, 0.5 * eye3 * dt, Z, Z], dim=1),
        torch.cat([0.5 * R0 * dt, -0.25 * R1a1 * dt2, 0.5 * R1 * dt, -0.25 * R1a1 * dt2,
                   Z, Z], dim=1),
        torch.cat([Z, Z, Z, Z, eye3 * dt, Z], dim=1),
        torch.cat([Z, Z, Z, Z, Z, eye3 * dt], dim=1),
    ], dim=0)

    jac_new = F @ jac
    cov_new = F @ cov @ F.T + V @ Q18 @ V.T
    return dp_new, dq_new, dv_new, jac_new, cov_new


def preintegrate(acc, gyr, dt, ba, bg, noise: ImuNoise = ImuNoise(),
                 parallel: bool = False) -> Preintegrated:
    """Preintegrate an IMU segment of N+1 samples (N steps).

    acc, gyr: (N+1, 3) samples (body frame, acc includes gravity); dt: (N,)
    step durations, entries may be 0 (identity padding); ba, bg: (3,)
    linearization-point biases. All steps run, padded or not, so the launch
    sequence depends on N only (IntegrationBase::propagate loop,
    integration_base.h:147-158). parallel=True: `preintegrate_parallel`."""
    if parallel:
        return preintegrate_parallel(acc, gyr, dt, ba, bg, noise)
    dtype, dev = acc.dtype, acc.device
    Q18 = _noise_cov(noise, dtype, dev)
    carry = (torch.zeros(3, dtype=dtype, device=dev),
             torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev),
             torch.zeros(3, dtype=dtype, device=dev),
             torch.eye(15, dtype=dtype, device=dev),
             torch.zeros((15, 15), dtype=dtype, device=dev))
    for k in range(dt.shape[0]):
        carry = _midpoint_step(carry, (acc[k], gyr[k], acc[k + 1], gyr[k + 1], dt[k]),
                               ba, bg, Q18)
    dp, dq, dv, jac, cov = carry
    return Preintegrated(dp, dq, dv, jac, cov, torch.sum(dt), ba, bg)


def associative_scan(fn, elems):
    """Inclusive scan of the tuple of tensors `elems` along dim 0 under the
    associative fn(earlier, later), in log depth: the recursion of
    jax.lax.associative_scan (pairs of neighbours combined, the half-length
    scan recursed, the even places filled in), so that every prefix is
    combined in the same order, and rounded the same way, as there."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tuple(e[0:-1:2] for e in elems),
                                  tuple(e[1::2] for e in elems)))
    later = tuple(e[2::2] for e in elems)
    even = fn(tuple(o[:-1] for o in odd), later) if n % 2 == 0 else fn(odd, later)
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(r)
    return tuple(out)


def preintegrate_parallel(acc, gyr, dt, ba, bg, noise: ImuNoise = ImuNoise()) -> Preintegrated:
    """Log-depth preintegration (imu.py:174-276 of the reference): the SAME
    midpoint math as _midpoint_step, restructured so that a segment is a
    few dozen batched launches instead of a loop of N steps:

      1. per-step rotation increments r_k = exp((w_mid_k - bg) dt_k), batched;
      2. prefix rotations dq_k = r_0 x ... x r_k: an associative scan of
         quaternion products (depth log2 N);
      3. dv / dp as (ex/in)clusive cumulative sums of un_acc_k dt_k (the
         midpoint update is affine given the rotations);
      4. the (jacobian, covariance) pair composes associatively,
         (J2, P2) o (J1, P1) = (J2 J1, J2 P1 J2^T + P2), over the per-step
         leaves (F_k, V_k Q V_k^T) built batched: one associative scan of
         15x15 products (depth log2 N).

    dt == 0 padding steps contribute exact identities ((I, 0) leaves,
    identity quaternions), as in the sequential path."""
    dtype, dev = acc.dtype, acc.device
    Q18 = _noise_cov(noise, dtype, dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    a0 = acc[:-1] - ba  # (N, 3)
    a1 = acc[1:] - ba
    un_gyr = 0.5 * (gyr[:-1] + gyr[1:]) - bg  # (N, 3)
    N = a0.shape[0]

    # 1-2: prefix rotations
    r = lie.so3_exp(un_gyr * dt[:, None])  # (N, 4)
    (dq_after,) = associative_scan(lambda x, y: (lie.qnormalize(lie.qmul(x[0], y[0])),), (r,))
    q_id = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev)
    dq_before = torch.cat([q_id[None], dq_after[:-1]], dim=0)
    R0 = lie.q2R(dq_before)  # (N, 3, 3)
    R1 = lie.q2R(dq_after)

    # 3: dv / dp cumulative sums
    un_acc = 0.5 * (torch.einsum("nij,nj->ni", R0, a0) + torch.einsum("nij,nj->ni", R1, a1))
    u = un_acc * dt[:, None]
    dv_before = torch.cumsum(u, dim=0) - u  # exclusive prefix
    dv = torch.sum(u, dim=0)
    dp = torch.sum(dv_before * dt[:, None] + 0.5 * un_acc * dt[:, None] ** 2, dim=0)

    # 4: batched F_k / V_k Q V_k^T leaves (the entries of _midpoint_step)
    a0h = lie.skew(a0)  # (N, 3, 3)
    a1h = lie.skew(a1)
    wh = lie.skew(un_gyr)
    dtc = dt[:, None, None]
    dt2 = dtc * dtc
    I_wdt = eye3[None] - wh * dtc
    R0a0 = R0 @ a0h
    R1a1 = R1 @ a1h
    eyeN = eye3.expand(N, 3, 3)
    Z = torch.zeros_like(eyeN)

    F = torch.cat([
        torch.cat([eyeN, -0.25 * R0a0 * dt2 - 0.25 * (R1a1 @ I_wdt) * dt2, eyeN * dtc,
                   -0.25 * (R0 + R1) * dt2, 0.25 * R1a1 * dt2 * dtc], dim=2),
        torch.cat([Z, I_wdt, Z, Z, -eyeN * dtc], dim=2),
        torch.cat([Z, -0.5 * R0a0 * dtc - 0.5 * (R1a1 @ I_wdt) * dtc, eyeN,
                   -0.5 * (R0 + R1) * dtc, 0.5 * R1a1 * dtc * dtc], dim=2),
        torch.cat([Z, Z, Z, eyeN, Z], dim=2),
        torch.cat([Z, Z, Z, Z, eyeN], dim=2),
    ], dim=1)
    V = torch.cat([
        torch.cat([0.25 * R0 * dt2, -0.125 * R1a1 * dt2 * dtc, 0.25 * R1 * dt2,
                   -0.125 * R1a1 * dt2 * dtc, Z, Z], dim=2),
        torch.cat([Z, 0.5 * eyeN * dtc, Z, 0.5 * eyeN * dtc, Z, Z], dim=2),
        torch.cat([0.5 * R0 * dtc, -0.25 * R1a1 * dt2, 0.5 * R1 * dtc, -0.25 * R1a1 * dt2,
                   Z, Z], dim=2),
        torch.cat([Z, Z, Z, Z, eyeN * dtc, Z], dim=2),
        torch.cat([Z, Z, Z, Z, Z, eyeN * dtc], dim=2),
    ], dim=1)
    VQV = V @ Q18 @ V.transpose(-1, -2)

    def comb(x, y):
        Jx, Px = x
        Jy, Py = y
        return Jy @ Jx, Jy @ Px @ Jy.transpose(-1, -2) + Py

    Jall, Pall = associative_scan(comb, (F, VQV))
    return Preintegrated(dp, lie.qnormalize(dq_after[-1]), dv, Jall[-1], Pall[-1],
                         torch.sum(dt), ba, bg)


def bias_corrected_delta(pre: Preintegrated, ba, bg):
    """First-order bias correction of (dp, dq, dv) (integration_base.h:160-175)."""
    dba = ba - pre.ba
    dbg = bg - pre.bg
    dp = pre.dp + pre.jac[0:3, 9:12] @ dba + pre.jac[0:3, 12:15] @ dbg
    dv = pre.dv + pre.jac[6:9, 9:12] @ dba + pre.jac[6:9, 12:15] @ dbg
    dq = lie.qnormalize(lie.qmul(pre.dq, lie.so3_exp(pre.jac[3:6, 12:15] @ dbg)))
    return dp, dq, dv


def residual(pre: Preintegrated, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j,
             gravity):
    """15-dim preintegration residual (integration_base.h evaluate :160-186).

    A pure function of all states: the factor Jacobians come from
    torch.func.jacfwd over the tangent retraction (models/ba.py)."""
    dp, dq, dv = bias_corrected_delta(pre, ba_i, bg_i)
    qi_inv = lie.qconj(q_i)
    s = pre.dt_sum
    r_p = lie.qrot(qi_inv, 0.5 * gravity * s * s + p_j - p_i - v_i * s) - dp
    r_q = 2.0 * lie.qmul(lie.qconj(dq), lie.qmul(qi_inv, q_j))[..., 1:]
    r_v = lie.qrot(qi_inv, gravity * s + v_j - v_i) - dv
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return torch.cat([r_p, r_q, r_v, r_ba, r_bg], dim=-1)


def sqrt_information(pre: Preintegrated):
    """15x15 sqrt-information from the propagated covariance: the inverse
    Cholesky factor of the symmetrized, eps-regularized covariance
    (Linv.T @ Linv == cov^{-1}; imu_factor.h:55-60 uses LLT of cov^{-1}).

    torch.linalg.cholesky raises on a matrix that is not positive definite,
    where the reference's factor holds NaN; cholesky_ex reports it without a
    host read, and such a factor is set to NaN here, as in the reference."""
    dtype, dev = pre.cov.dtype, pre.cov.device
    eye = torch.eye(15, dtype=dtype, device=dev)
    cov = 0.5 * (pre.cov + pre.cov.transpose(-1, -2))
    cov = cov + eye * 1e-10
    L, info = torch.linalg.cholesky_ex(cov)
    L = torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def propagate_state(p, q, v, ba, bg, acc0, gyr0, acc1, gyr1, dt, gravity):
    """High-rate world-frame state propagation (estimator_node.cpp predict :44-80)."""
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    q_new = lie.qnormalize(lie.qmul(q, lie.so3_exp(un_gyr * dt)))
    un_acc_0 = lie.qrot(q, acc0 - ba) - gravity
    un_acc_1 = lie.qrot(q_new, acc1 - ba) - gravity
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    p_new = p + v * dt + 0.5 * un_acc * dt * dt
    v_new = v + un_acc * dt
    return p_new, q_new, v_new
