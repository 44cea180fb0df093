"""Marginalization (Schur prior) and window sliding.

Port of vil_fusion_tpu/models/marginalization.py (the reference's
marginalization_factor.cpp: preMarginalize :37-173, Hessian assembly
:232-261, Schur complement with eigendecomposition :267-297, prior replay
:333-381; and `slideWindow`, estimator.cpp:1052-1177, with
removeBackShiftDepth, feature_manager.cpp:292-339).

The Hessian assembly reuses ba's factor blocks; the Schur complement and the
(J, r0) re-factorization are two symmetric eigendecompositions of small
dense matrices (torch.linalg.eigh). Eigenvectors carry an arbitrary sign
and, for equal eigenvalues, an arbitrary basis, so what other code may rely
on is J^T J and J^T r0, never J itself. Nothing here writes its inputs.
"""
from __future__ import annotations

import torch

from vil_fusion_tpu_torch.models import ba, factors
from vil_fusion_tpu_torch.models import imu as imu_mod
from vil_fusion_tpu_torch.models.window import (
    D, K, FeatureStore, LidarConstraints, StackedPreint, WindowState, make_segment, set_row,
)
from vil_fusion_tpu_torch.ops import lie

MargPrior = factors.MargPrior
_EIG_EPS = 1e-8  # eigenvalue threshold (marginalization_factor.cpp:267-276)


def _quadratic_to_factor(Lam, g):
    """Express quadratic (Lam, g) as linear factor (J, r0) with J^T J = Lam,
    J^T r0 = g (marginalization_factor.cpp:288-297 semantics)."""
    Lam = 0.5 * (Lam + Lam.T)
    S, V = torch.linalg.eigh(Lam)
    ok = S > _EIG_EPS
    S_sqrt = torch.where(ok, torch.sqrt(torch.clamp(S, min=_EIG_EPS)), 0.0)
    S_inv_sqrt = torch.where(ok, 1.0 / torch.clamp(S_sqrt, min=_EIG_EPS), 0.0)
    J = S_sqrt[:, None] * V.T
    r0 = S_inv_sqrt * (V.T @ g)
    return J, r0


def _schur_eliminate(Lam, g, m_idx, r_idx):
    """Eliminate dims m_idx from (Lam, g) via eigendecomposed pseudo-inverse
    (index tensors or slices)."""
    Lmm = Lam[m_idx][:, m_idx]
    Lmm = 0.5 * (Lmm + Lmm.T)
    S, V = torch.linalg.eigh(Lmm)
    S_inv = torch.where(S > _EIG_EPS, 1.0 / torch.clamp(S, min=_EIG_EPS), 0.0)
    Lmm_inv = (V * S_inv[None, :]) @ V.T
    Lrm = Lam[r_idx][:, m_idx]
    Lrr = Lam[r_idx][:, r_idx]
    Lam_new = Lrr - Lrm @ Lmm_inv @ Lrm.T
    g_new = g[r_idx] - Lrm @ (Lmm_inv @ g[m_idx])
    return Lam_new, g_new


def _shift(a):
    """Slots 0..K-2 <- 1..K-1, slot K-1 duplicated."""
    return torch.cat([a[1:], a[-1:]], dim=0)


def _shifted_state(state: WindowState) -> WindowState:
    """Window layout after MARGIN_OLD."""
    return state._replace(p=_shift(state.p), q=_shift(state.q), v=_shift(state.v),
                          ba=_shift(state.ba), bg=_shift(state.bg))


def marginalize_old(state: WindowState, feats: FeatureStore, pre: StackedPreint,
                    lidar: LidarConstraints, prior: MargPrior, cfg: ba.BAConfig) -> MargPrior:
    """Marginalize frame 0: build the quadratic from every factor touching it
    (prior + IMU slot 1 + LiDAR slot 1 + projections anchored at frame 0),
    eliminate those features' depths then the 15 frame-0 dims, re-factorize,
    and re-index into the slid window (estimator.cpp:862-1046 semantics)."""
    dtype, dev = state.p.dtype, state.p.device
    g_vec = torch.as_tensor(cfg.gravity, dtype=dtype, device=dev)
    F = feats.active.shape[0]

    # prior factor (touches everything)
    Jp = torch.where(prior.valid, 1.0, 0.0).to(dtype) * prior.J
    r_p = factors.marg_prior_residual(prior, state)
    Lam = Jp.T @ Jp
    g = Jp.T @ r_p

    # IMU slot 1 only
    m = (torch.arange(1, K, device=dev) == 1).to(dtype)
    r, J, ix = ba._imu_blocks(state, pre, g_vec, dtype)
    Lam, g = ba.scatter_quadratic(Lam, g, r * m[:, None], J * m[:, None, None], ix, sign=1.0)

    # LiDAR slot 1 only
    if cfg.use_lidar:
        r, J, ix = ba._lidar_blocks(state, lidar, dtype)
        Lam, g = ba.scatter_quadratic(Lam, g, r * m[:, None], J * m[:, None, None], ix,
                                      sign=1.0)

    # projections anchored at frame 0 (depths eliminated on the fly);
    # accumulate_proj_quadratic accumulates b -= J^T r while this function
    # carries g = +J^T r, so its b outputs are negated
    marg_feats = feats._replace(active=feats.active & (feats.start == 0))
    r, Jpse, Jd, ixp, _, _ = ba._proj_blocks(state, marg_feats, cfg, dtype, 1.0)
    zD = torch.zeros((D,), dtype=dtype, device=dev)
    zF = torch.zeros((F,), dtype=dtype, device=dev)
    Lam, bneg, Hpd, Hd, gd_neg = ba.accumulate_proj_quadratic(
        Lam, zD, torch.zeros((D, F), dtype=dtype, device=dev), zF, zF, r, Jpse, Jd, ixp)
    g = g - bneg
    gd = -gd_neg
    inv_Hd = torch.where(Hd > _EIG_EPS, 1.0 / torch.clamp(Hd, min=_EIG_EPS), 0.0)
    Lam = Lam - (Hpd * inv_Hd[None, :]) @ Hpd.T
    g = g - Hpd @ (inv_Hd * gd)

    # eliminate frame-0 dims [0, 15)
    Lam_r, g_r = _schur_eliminate(Lam, g, slice(0, 15), slice(15, D))
    J_small, r0_small = _quadratic_to_factor(Lam_r, g_r)  # (D-15, D-15)

    # re-index into the slid window: old dims 15..15K-1 -> new 0..15(K-1)-1,
    # ext/td dims keep their absolute position 15K..15K+6
    n_f = 15 * (K - 1)  # frame dims remaining
    J_new = torch.zeros((D, D), dtype=dtype, device=dev)
    J_new[:D - 15, :n_f] = J_small[:, :n_f]
    J_new[:D - 15, 15 * K:] = J_small[:, n_f:]
    r0_new = torch.cat([r0_small, torch.zeros(15, dtype=dtype, device=dev)])
    return MargPrior(J=J_new, r0=r0_new, lin=_shifted_state(state),
                     valid=torch.ones((), dtype=torch.bool, device=dev))


def marginalize_second_new(prior: MargPrior, state_after_slide: WindowState) -> MargPrior:
    """Drop the second-newest frame from the prior only (the reference's
    MARGIN_SECOND_NEW path marginalizes just the prior blocks touching that
    frame; its visual observations are discarded, estimator.cpp:875-887)."""
    dtype, dev = prior.J.dtype, prior.J.device
    Jp = torch.where(prior.valid, 1.0, 0.0).to(dtype) * prior.J
    Lam = Jp.T @ Jp
    g = Jp.T @ prior.r0
    drop0 = 15 * (K - 2)
    m_idx = torch.arange(drop0, drop0 + 15, device=dev)
    r_idx = torch.cat([torch.arange(0, drop0, device=dev),
                       torch.arange(drop0 + 15, D, device=dev)])
    Lam_r, g_r = _schur_eliminate(Lam, g, m_idx, r_idx)
    J_small, r0_small = _quadratic_to_factor(Lam_r, g_r)
    # col map: dims < drop0 identity; old frame K-1 dims -> slot K-2; ext/td same
    J_new = torch.zeros((D, D), dtype=dtype, device=dev)
    J_new[:D - 15, :drop0] = J_small[:, :drop0]
    J_new[:D - 15, drop0:drop0 + 15] = J_small[:, drop0:drop0 + 15]
    J_new[:D - 15, 15 * K:] = J_small[:, drop0 + 15:]
    r0_new = torch.cat([r0_small, torch.zeros(15, dtype=dtype, device=dev)])
    return MargPrior(J=J_new, r0=r0_new, lin=state_after_slide, valid=prior.valid)


# ---------------------------------------------------------------------------
# Window sliding (array shifts + feature bookkeeping)
# ---------------------------------------------------------------------------

def _shift_zero(a, dim=0):
    """Shift left along `dim`, zero-filling the last slot."""
    head = a.narrow(dim, 1, a.shape[dim] - 1)
    return torch.cat([head, torch.zeros_like(a.narrow(dim, 0, 1))], dim=dim)


def slide_old(state: WindowState, feats: FeatureStore, pre: StackedPreint,
              lidar: LidarConstraints, imu_noise: imu_mod.ImuNoise = imu_mod.ImuNoise()):
    """MARGIN_OLD slide (estimator.cpp:1055-1116 + removeBackShiftDepth)."""
    dtype, dev = state.p.dtype, state.p.device
    old_q0, old_p0 = state.q[0], state.p[0]
    new_state = _shifted_state(state)

    new_pre = StackedPreint(**{k: _shift_zero(v) for k, v in pre._asdict().items()})
    new_lidar = LidarConstraints(
        q_rel=torch.cat([lidar.q_rel[1:], torch.tensor([[1.0, 0, 0, 0]], dtype=dtype,
                                                       device=dev)], dim=0),
        p_rel=_shift_zero(lidar.p_rel), valid=_shift_zero(lidar.valid))

    # ---- features: depth handover to the new anchor (frame 1's camera) ----
    qic, tic = state.qic, state.tic
    q_c0 = lie.qmul(old_q0, qic)
    p_c0 = lie.qrot(old_q0, tic) + old_p0
    q_c1 = lie.qmul(state.q[1], qic)
    p_c1 = lie.qrot(state.q[1], tic) + state.p[1]

    anchored0 = feats.active & (feats.start == 0)
    obs0 = feats.obs[:, 0]  # (F, 2) anchor observations
    depth0 = 1.0 / torch.clamp(feats.inv_depth, min=1e-6)
    pts_c0 = torch.cat([obs0, torch.ones_like(obs0[:, :1])], dim=-1) * depth0[:, None]
    pts_w = lie.qrot(q_c0[None, :], pts_c0) + p_c0[None, :]
    pts_c1 = lie.qrot(lie.qconj(q_c1)[None, :], pts_w - p_c1[None, :])
    new_depth = pts_c1[:, 2]
    handover_ok = anchored0 & (feats.inv_depth > 0) & (new_depth > 0.1)
    inv_depth_new = torch.where(handover_ok, 1.0 / torch.clamp(new_depth, min=1e-6),
                                torch.where(anchored0, -1.0, feats.inv_depth))
    lidar_flag_new = torch.where(anchored0 & ~handover_ok, False, feats.lidar_flag)

    # shift observation grid left
    ov_new = _shift_zero(feats.obs_valid, 1)
    active_new = feats.active & torch.any(ov_new, dim=1)
    new_feats = FeatureStore(
        active=active_new, start=torch.clamp(feats.start - 1, min=0),
        obs=_shift_zero(feats.obs, 1), obs_valid=ov_new,
        vel=_shift_zero(feats.vel, 1), tshift=_shift_zero(feats.tshift, 1),
        inv_depth=torch.where(active_new, inv_depth_new, -1.0),
        lidar_flag=torch.where(active_new, lidar_flag_new, False),
        feat_id=torch.where(active_new, feats.feat_id, -1))
    return new_state, new_feats, new_pre, new_lidar


def _decimate(acc, gyr, dt, n):
    """2x decimation of one segment's buffers: every other sample kept, dt
    pairs summed, total time preserved (midpoint integration at half rate);
    n is a 0-d tensor."""
    cap = acc.shape[0]
    dev = acc.device
    idx = torch.arange(cap, device=dev)
    src = torch.clamp(idx * 2, 0, cap - 1)
    i1 = idx[: cap - 1]
    dt_src0 = torch.clamp(i1 * 2, 0, cap - 2)
    dt_src1 = torch.clamp(i1 * 2 + 1, 0, cap - 2)
    dt_d = torch.where(i1 * 2 + 1 < n - 1, dt[dt_src0] + dt[dt_src1],
                       torch.where(i1 * 2 < n - 1, dt[dt_src0], 0.0))
    return acc[src], gyr[src], dt_d, torch.div(n + 1, 2, rounding_mode="floor")


def _select(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def slide_new(state: WindowState, feats: FeatureStore, pre: StackedPreint,
              lidar: LidarConstraints, imu_noise: imu_mod.ImuNoise = imu_mod.ImuNoise(),
              imu_cap: int = 64):
    """MARGIN_SECOND_NEW slide: discard frame K-2, merge IMU segments and
    compose LiDAR constraints (estimator.cpp:1119-1162). Counts stay on the
    device: the overflow decimation is selected with torch.where."""
    dtype, dev = state.p.dtype, state.p.device
    i, j = K - 2, K - 1  # merged into slot i

    # ---- IMU merge: samples of segment i + segment j (shared boundary) ----
    n1 = pre.n_samples[i]
    n2 = pre.n_samples[j]
    cap = pre.acc_buf.shape[1]
    seg_i = (pre.acc_buf[i], pre.gyr_buf[i], pre.dt_buf[i], n1)
    seg_j = (pre.acc_buf[j], pre.gyr_buf[j], pre.dt_buf[j], n2)
    # fixed-capacity twist (the reference's vectors are unbounded,
    # estimator.cpp:1122-1133): if the merged buffer would overflow, decimate
    # segment i 2x first; a single pass can still overflow when n2 is near
    # cap, so segment j is decimated too (ceil(n1/2) + ceil(n2/2) - 1 <= cap)
    acc_i, gyr_i, dt_i, n1 = _select(n1 + n2 - 1 > cap, _decimate(*seg_i), seg_i)
    acc_j, gyr_j, dt_j, n2 = _select(n1 + n2 - 1 > cap, _decimate(*seg_j), seg_j)

    idx = torch.arange(cap, device=dev)
    # segment j's samples after the shared boundary, from position n1
    tail_src = torch.clamp(idx - n1 + 1, 0, cap - 1)
    head = (idx < n1)[:, None]
    acc_m = torch.where(head, acc_i, acc_j[tail_src])
    gyr_m = torch.where(head, gyr_i, gyr_j[tail_src])
    # dt buffer: first n1-1 from segment i, then n2-1 from segment j
    capd = pre.dt_buf.shape[1]
    idxd = torch.arange(capd, device=dev)
    srcd = torch.clamp(idxd - (n1 - 1), 0, capd - 1)
    dt_m = torch.where(idxd < n1 - 1, dt_i,
                       torch.where(idxd < n1 - 1 + n2 - 1, dt_j[srcd], 0.0))
    vi = pre.valid[i]
    n_m = torch.where(vi, n1 + n2 - 1, n2)
    acc_m = torch.where(vi, acc_m, acc_j)
    gyr_m = torch.where(vi, gyr_m, gyr_j)
    dt_m = torch.where(vi, dt_m, dt_j)

    seg = make_segment(acc_m, gyr_m, dt_m, n_m, pre.ba[i], pre.bg[i], imu_noise, imu_cap)
    eye15 = torch.eye(15, dtype=dtype, device=dev)
    empty = dict(dq=torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev), jac=eye15,
                 sqrt_info=eye15, valid=torch.zeros((), dtype=torch.bool, device=dev))
    # the reference writes the decimated buffers back before merging; slot j
    # is then cleared and slot i overwritten, so only the merged row remains
    new_pre = StackedPreint(**{
        k: set_row(set_row(v, i, seg[k]), j, empty.get(k, torch.zeros_like(v[j])))
        for k, v in pre._asdict().items()})

    # ---- LiDAR constraint composition T_{i-1,j} = T_{i-1,i} * T_{i,j} ----
    q_c, p_c = lie.pose_compose((lidar.q_rel[i], lidar.p_rel[i]),
                                (lidar.q_rel[j], lidar.p_rel[j]))
    both = lidar.valid[i] & lidar.valid[j]
    new_lidar = LidarConstraints(
        q_rel=set_row(set_row(lidar.q_rel, i, torch.where(both, q_c, lidar.q_rel[j])), j,
                      empty["dq"]),
        p_rel=set_row(set_row(lidar.p_rel, i, torch.where(both, p_c, lidar.p_rel[j])), j, 0.0),
        valid=set_row(set_row(lidar.valid, i, lidar.valid[j]), j, False))

    # ---- state: slot i <- slot j ----
    new_state = state._replace(**{k: set_row(getattr(state, k), i, getattr(state, k)[j])
                                  for k in ("p", "q", "v", "ba", "bg")})

    # ---- features (removeFront): drop obs at frame i, move obs j -> i ----
    def move(a, zero):
        out = a.clone()
        out[:, i] = a[:, j]
        out[:, j] = zero
        return out

    ov_new = move(feats.obs_valid, False)
    active_new = feats.active & torch.any(ov_new, dim=1)
    new_feats = feats._replace(
        obs=move(feats.obs, 0.0), obs_valid=ov_new, vel=move(feats.vel, 0.0),
        tshift=move(feats.tshift, 0.0),
        start=torch.where(feats.start == j, i, feats.start).to(feats.start.dtype),
        active=active_new, feat_id=torch.where(active_new, feats.feat_id, -1),
        inv_depth=torch.where(active_new, feats.inv_depth, -1.0),
        lidar_flag=torch.where(active_new, feats.lidar_flag, False))
    return new_state, new_feats, new_pre, new_lidar
