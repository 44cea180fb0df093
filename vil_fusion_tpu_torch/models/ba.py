"""Sliding-window bundle adjustment: assembly, Schur complement, LM loop.

Port of vil_fusion_tpu/models/ba.py (the reference's `Estimator::optimization`,
estimator.cpp:689-1050, and its Ceres DENSE_SCHUR/DOGLEG solve :838-853):

  * Per-factor residuals + Jacobians: `torch.func.jacfwd` over the tangent
    retraction inside `torch.func.vmap` over the factors (the reference's
    `jax.jacfwd` under `jax.vmap`). Each factor's frames are gathered before
    the vmap, so the vmapped functions index nothing.
  * The Gauss-Newton normal system over the D-dim pose state is assembled by
    scatter-adds of dense factor blocks; the projection factors' 19 pose
    columns are scattered into the D-dim tangent (the reference's one-hot
    matmuls, with the same values) and reduced by one matmul.
  * Inverse depths couple through single-landmark factors only, so H_ll is
    diagonal and the Schur complement is two matmuls.
  * Levenberg-Marquardt with a fixed iteration budget (max 8) and an
    annealed Cauchy scale; acceptance, damping and cost stay on the device
    (torch.where), so an iteration reads nothing on the host.
  * Gauge: after the solve the window is re-anchored to frame 0's
    pre-solve yaw and position (double2vector, estimator.cpp:549-638).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from vil_fusion_tpu_torch.models import factors
from vil_fusion_tpu_torch.models.window import (
    D, K, FeatureStore, LidarConstraints, StackedPreint, WindowState, retract,
)
from vil_fusion_tpu_torch.ops import lie
from vil_fusion_tpu_torch.utils.graphs import host_constant

# MargPrior lives in factors.py; re-export for callers
MargPrior = factors.MargPrior

_PRE_FIELDS = ("dp", "dq", "dv", "jac", "sqrt_info", "dt_sum", "ba", "bg")


def empty_prior(state: WindowState) -> MargPrior:
    f = dict(dtype=state.p.dtype, device=state.p.device)
    return MargPrior(J=torch.zeros((D, D), **f), r0=torch.zeros((D,), **f), lin=state,
                     valid=torch.zeros((), dtype=torch.bool, device=state.p.device))


class BAConfig(NamedTuple):
    max_iters: int = 8
    lm_init: float = 1e-4
    gravity: tuple = (0.0, 0.0, 9.81)
    use_lidar: bool = True
    fix_lidar_depths: bool = True  # SetParameterBlockConstant (estimator.cpp:780-790)
    estimate_td: bool = False
    estimate_extrinsic: bool = False
    # inverse-depth floor: only guards against sign flips (behind-camera);
    # far below any real landmark's inverse depth
    depth_min: float = 1e-4
    # landmark factors sharded over the active mesh (parallel/sharded_ba.py,
    # parallel/mesh.set_active_mesh); the estimator dispatches on it
    sharded: bool = False


class System(NamedTuple):
    H: torch.Tensor  # (D, D)
    b: torch.Tensor  # (D,)
    Hpd: torch.Tensor  # (D, F)
    Hd: torch.Tensor  # (F,)
    bd: torch.Tensor  # (F,)
    cost: torch.Tensor  # ()


def check_config(cfg: BAConfig):
    """BAConfig(sharded=True) needs an active mesh (parallel/mesh.py)."""
    if cfg.sharded:
        from vil_fusion_tpu_torch.parallel import mesh

        mesh.get_active_mesh()  # raises without one


def _frames(state: WindowState, idx) -> dict:
    """The per-frame states of window slots `idx` (a slice or an index tensor)."""
    return dict(p=state.p[idx], q=state.q[idx], v=state.v[idx], ba=state.ba[idx],
                bg=state.bg[idx])


def _with_aux(fn):
    """fn(...) -> r  as  fn(...) -> (r, r), for jacfwd(has_aux=True): one
    evaluation gives the residual and its Jacobian."""
    def both(*args):
        r = fn(*args)
        return r, r
    return both


def _blocks(fn, n, n_delta, in_dims, args, jac: bool, dtype, device):
    """Residuals (n, r), and with `jac` their Jacobians (n, r, n_delta) at
    delta = 0, of fn(delta, *args) vmapped over the n factors."""
    z = torch.zeros((n, n_delta), dtype=dtype, device=device)
    dims = (0,) + tuple(in_dims)
    if jac:
        J, r = vmap(jacfwd(_with_aux(fn), has_aux=True), in_dims=dims)(z, *args)
        return r, J
    return vmap(fn, in_dims=dims)(z, *args), None


# ---------------------------------------------------------------------------
# IMU factors (slots 1..K-1)
# ---------------------------------------------------------------------------

def _imu_res_delta(delta, pre_row, si, sj, g):
    qi, pi = lie.pose_retract((si["q"], si["p"]), delta[0:6])
    vi, bai, bgi = si["v"] + delta[6:9], si["ba"] + delta[9:12], si["bg"] + delta[12:15]
    qj, pj = lie.pose_retract((sj["q"], sj["p"]), delta[15:21])
    vj, baj, bgj = sj["v"] + delta[21:24], sj["ba"] + delta[24:27], sj["bg"] + delta[27:30]
    return factors.imu_residual(pre_row, pi, qi, vi, bai, bgi, pj, qj, vj, baj, bgj, g)


def _imu_blocks(state: WindowState, pre: StackedPreint, g, dtype, jac: bool = True):
    dev = state.p.device
    pre_rows = {k: getattr(pre, k)[1:] for k in _PRE_FIELDS}
    args = (pre_rows, _frames(state, slice(0, K - 1)), _frames(state, slice(1, K)), g)
    r, J = _blocks(_imu_res_delta, K - 1, 30, (0, 0, 0, None), args, jac, dtype, dev)
    slots = torch.arange(1, K, device=dev)[:, None]
    ar = torch.arange(15, device=dev)[None, :]
    ix = torch.cat([15 * (slots - 1) + ar, 15 * slots + ar], dim=1)
    w = pre.valid[1:].to(dtype)
    return r * w[:, None], (None if J is None else J * w[:, None, None]), ix


# ---------------------------------------------------------------------------
# Projection (td) factors over the (F, K) observation grid
# ---------------------------------------------------------------------------

def _proj_res_delta(delta, obs_i, obs_j, vel_i, vel_j, tsh_i, tsh_j,
                    inv_depth, si, sj, ext, depth_free):
    qi, pi = lie.pose_retract((si["q"], si["p"]), delta[0:6])
    qj, pj = lie.pose_retract((sj["q"], sj["p"]), delta[6:12])
    qic, tic = lie.pose_retract((ext["qic"], ext["tic"]), delta[12:18])
    td = ext["td"] + delta[18]
    lam = inv_depth + delta[19] * depth_free
    return factors.projection_td_residual(
        obs_i, obs_j, vel_i, vel_j, lam, pi, qi, pj, qj, tic, qic, td, tsh_i, tsh_j)


def _proj_blocks(state: WindowState, feats: FeatureStore, cfg: BAConfig, dtype,
                 cauchy_c=1.0, jac: bool = True):
    """Every (feature, frame) pair of the window as a factor, row n = f * K + j
    (the reference's meshgrid order). Returns (r, Jp, Jd, ix, f_idx, rho_cost)
    with r and the Jacobians Cauchy-reweighted and masked; Jp, Jd are None
    without `jac`."""
    dev = state.p.device
    F = feats.active.shape[0]
    n_idx = torch.arange(F * K, device=dev)
    f_idx = torch.div(n_idx, K, rounding_mode="floor")
    j_idx = n_idx - K * f_idx
    s_idx = feats.start[f_idx].long()
    valid = (feats.active[f_idx] & feats.obs_valid[f_idx, s_idx]
             & feats.obs_valid[f_idx, j_idx] & (j_idx != s_idx)
             & (feats.inv_depth[f_idx] > 0))
    held = feats.lidar_flag[f_idx] if cfg.fix_lidar_depths else torch.zeros_like(valid)
    depth_free = torch.where(held, 0.0, 1.0).to(dtype)
    ext = dict(qic=state.qic, tic=state.tic, td=state.td)
    args = (feats.obs[f_idx, s_idx], feats.obs[f_idx, j_idx], feats.vel[f_idx, s_idx],
            feats.vel[f_idx, j_idx], feats.tshift[f_idx, s_idx], feats.tshift[f_idx, j_idx],
            feats.inv_depth[f_idx], _frames(state, s_idx), _frames(state, j_idx), ext,
            depth_free)
    r, J = _blocks(_proj_res_delta, F * K, 20, (0,) * 9 + (None, 0), args, jac, dtype, dev)
    # robust reweight (Cauchy, estimator.cpp:760) with annealable scale
    r2 = torch.sum(r * r, dim=-1)
    vmask = valid.to(dtype)
    w = factors.cauchy_weight(r2, cauchy_c) * vmask
    rho_cost = torch.sum(factors.cauchy_rho(r2, cauchy_c) * vmask)
    r = r * w[:, None]
    if J is None:
        return r, None, None, None, f_idx, rho_cost
    if not cfg.estimate_extrinsic:
        J[:, :, 12:18] = 0.0
    if not cfg.estimate_td:
        J[:, :, 18] = 0.0
    J = J * w[:, None, None]
    ar6 = torch.arange(6, device=dev)[None, :]
    ix = torch.cat([15 * s_idx[:, None] + ar6, 15 * j_idx[:, None] + ar6,
                    (15 * K + torch.arange(7, device=dev))[None, :].expand(F * K, 7)], dim=1)
    return r, J[:, :, :19], J[:, :, 19], ix, f_idx, rho_cost


# ---------------------------------------------------------------------------
# LiDAR relative-pose factors (slots 1..K-1)
# ---------------------------------------------------------------------------

def _lidar_res_delta(delta, q_meas, p_meas, si, sj):
    qi, pi = lie.pose_retract((si["q"], si["p"]), delta[0:6])
    qj, pj = lie.pose_retract((sj["q"], sj["p"]), delta[6:12])
    return factors.lidar_rel_residual(q_meas, p_meas, pi, qi, pj, qj)


def _lidar_blocks(state: WindowState, lidar: LidarConstraints, dtype, jac: bool = True):
    dev = state.p.device
    args = (lidar.q_rel[1:], lidar.p_rel[1:], _frames(state, slice(0, K - 1)),
            _frames(state, slice(1, K)))
    r, J = _blocks(_lidar_res_delta, K - 1, 12, (0, 0, 0, 0), args, jac, dtype, dev)
    slots = torch.arange(1, K, device=dev)[:, None]
    ar = torch.arange(6, device=dev)[None, :]
    ix = torch.cat([15 * (slots - 1) + ar, 15 * slots + ar], dim=1)
    w = lidar.valid[1:].to(dtype)
    return r * w[:, None], (None if J is None else J * w[:, None, None]), ix


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

def scatter_quadratic(H, b, r, J, ix, sign: float = -1.0):
    """H += J^T J and b += sign * J^T r, scattered at index array ix (N, d).
    sign -1 is the normal equations' right side; marginalization carries
    g = +J^T r."""
    JTJ = torch.einsum("nrd,nre->nde", J, J)
    JTr = torch.einsum("nrd,nr->nd", J, r)
    n, d = ix.shape
    H = H.index_put((ix[:, :, None].expand(n, d, d), ix[:, None, :].expand(n, d, d)), JTJ,
                    accumulate=True)
    b = b.index_put((ix,), sign * JTr, accumulate=True)
    return H, b


def accumulate_proj_quadratic(H, b, Hpd, Hd, bd, r, Jp, Jd, ix):
    """Projection-factor accumulation over factors laid out as _proj_blocks
    lays them out (row n = f * K + j: each feature's K factors in a row).
    Each factor's 19 pose columns are scattered into the D-dim tangent (the
    reference multiplies by a one-hot selection matrix: the same values,
    since a factor's 19 indices are distinct), so H and b are one matmul
    each; the depth couplings sum each feature's K rows (a reduction in a
    fixed order: the reference's scatter-add, without the CUDA index_add's
    atomics, whose order changes from run to run)."""
    F = Hd.shape[0]
    n, nr, _ = Jp.shape
    Jf = torch.zeros((n, nr, H.shape[0]), dtype=H.dtype, device=H.device)
    Jf = Jf.scatter(2, ix[:, None, :].expand(n, nr, ix.shape[1]), Jp)  # (N, 2, D)
    Jflat = Jf.reshape(n * nr, -1)
    H = H + Jflat.T @ Jflat
    b = b - Jflat.T @ r.reshape(-1)
    JfTJd = torch.einsum("nrD,nr->nD", Jf, Jd)  # (N, D)
    Hpd = Hpd + JfTJd.reshape(F, K, -1).sum(dim=1).T
    Hd = Hd + torch.sum(Jd * Jd, dim=-1).reshape(F, K).sum(dim=1)
    bd = bd - torch.einsum("nr,nr->n", Jd, r).reshape(F, K).sum(dim=1)
    return H, b, Hpd, Hd, bd


def window_system(state: WindowState, pre: StackedPreint, lidar: LidarConstraints,
                  prior: MargPrior, cfg: BAConfig):
    """(H, b, cost) of the factors on the window's frames alone: the
    marginalization prior, IMU and LiDAR (replicated in the sharded BA,
    which adds them on one rank)."""
    dtype, dev = state.p.dtype, state.p.device
    g = host_constant(cfg.gravity, dtype, dev)
    H = torch.zeros((D, D), dtype=dtype, device=dev)
    b = torch.zeros((D,), dtype=dtype, device=dev)

    # marginalization prior (linear factor)
    r_p = factors.marg_prior_residual(prior, state)
    Jp = torch.where(prior.valid, 1.0, 0.0).to(dtype) * prior.J
    H = H + Jp.T @ Jp
    b = b - Jp.T @ r_p
    cost = torch.sum(r_p * r_p)

    # IMU
    r, J, ix = _imu_blocks(state, pre, g, dtype)
    H, b = scatter_quadratic(H, b, r, J, ix)
    cost = cost + torch.sum(r * r)

    # LiDAR inter-frame
    if cfg.use_lidar:
        r, J, ix = _lidar_blocks(state, lidar, dtype)
        H, b = scatter_quadratic(H, b, r, J, ix)
        cost = cost + torch.sum(r * r)
    return H, b, cost


def landmark_system(H, b, cost, state: WindowState, feats: FeatureStore, cfg: BAConfig,
                    cauchy_c=1.0) -> System:
    """Adds the projection factors of `feats` (all slots, or one rank's
    block of them) and their depth couplings to (H, b, cost)."""
    dtype, dev = state.p.dtype, state.p.device
    F = feats.active.shape[0]
    r, Jpse, Jd, ix, _, rho_cost = _proj_blocks(state, feats, cfg, dtype, cauchy_c)
    cost = cost + rho_cost
    Hpd = torch.zeros((D, F), dtype=dtype, device=dev)
    Hd = torch.zeros((F,), dtype=dtype, device=dev)
    bd = torch.zeros((F,), dtype=dtype, device=dev)
    H, b, Hpd, Hd, bd = accumulate_proj_quadratic(H, b, Hpd, Hd, bd, r, Jpse, Jd, ix)
    return System(H, b, Hpd, Hd, bd, cost)


def build_system(state: WindowState, feats: FeatureStore, pre: StackedPreint,
                 lidar: LidarConstraints, prior: MargPrior, cfg: BAConfig,
                 cauchy_c=1.0) -> System:
    H, b, cost = window_system(state, pre, lidar, prior, cfg)
    return landmark_system(H, b, cost, state, feats, cfg, cauchy_c)


def window_cost(state, pre, lidar, prior, cfg: BAConfig):
    """The cost of `window_system`'s factors, without their Jacobians."""
    dtype, dev = state.p.dtype, state.p.device
    g = host_constant(cfg.gravity, dtype, dev)
    r_p = factors.marg_prior_residual(prior, state)
    cost = torch.sum(r_p * r_p)
    r, _, _ = _imu_blocks(state, pre, g, dtype, jac=False)
    cost = cost + torch.sum(r * r)
    if cfg.use_lidar:
        r, _, _ = _lidar_blocks(state, lidar, dtype, jac=False)
        cost = cost + torch.sum(r * r)
    return cost


def landmark_cost(state, feats, cfg: BAConfig, cauchy_c=1.0):
    """The robust cost of the projection factors of `feats`."""
    return _proj_blocks(state, feats, cfg, state.p.dtype, cauchy_c, jac=False)[-1]


def total_cost(state, feats, pre, lidar, prior, cfg: BAConfig, cauchy_c=1.0):
    """Cost only (for LM accept/reject): the residuals of build_system,
    without their Jacobians."""
    return window_cost(state, pre, lidar, prior, cfg) + landmark_cost(state, feats, cfg, cauchy_c)


# ---------------------------------------------------------------------------
# Schur solve + LM loop
# ---------------------------------------------------------------------------

def schur_solve(sys: System, lam, cfg: BAConfig):
    """Eliminate the diagonal depth block, solve the damped pose system,
    back-substitute.

    The FOCAL^2-scaled vision blocks give H entries up to ~1e8, so the
    system is symmetrically Jacobi-preconditioned and one step of iterative
    refinement follows the Cholesky solve. Where the Cholesky factorization
    fails (damping underflowed the f32 SPD margin) the step comes from an LU
    solve of the slightly regularized system, selected with torch.where:
    torch.linalg.cholesky would raise there (the reference's factor holds
    NaN), so cholesky_ex and solve_ex report failure without a host read."""
    HS, bS, inv_Hd = schur_terms(sys.Hpd, sys.Hd, sys.bd, lam)
    delta = damped_solve(sys.H, sys.H - HS, sys.b - bS, lam)
    delta_d = (sys.bd - sys.Hpd.T @ delta) * inv_Hd
    return delta, delta_d


def schur_terms(Hpd, Hd, bd, lam):
    """The depth block's Schur correction to the pose system:
    (Hpd Hd^-1 Hpd^T, Hpd Hd^-1 bd, Hd^-1) with the damped, guarded inverse
    of the diagonal Hd. A sum over landmarks: the sharded BA reduces it."""
    d_ok = Hd > 1e-8
    Hd_safe = torch.where(d_ok, Hd, 1.0) + lam
    inv_Hd = torch.where(d_ok, 1.0 / Hd_safe, 0.0)
    return (Hpd * inv_Hd[None, :]) @ Hpd.T, Hpd @ (bd * inv_Hd), inv_Hd


def damped_solve(H, Hs, bs, lam):
    """The damped, preconditioned, refined solve of the pose system Hs
    delta = bs (damping lam (diag(H) + 1))."""
    dtype, dev = H.dtype, H.device
    damp = lam * (torch.diagonal(H) + 1.0)
    Hs = Hs + torch.diag(damp)
    s = 1.0 / torch.sqrt(torch.abs(torch.diagonal(Hs)) + 1e-10)
    Hn = Hs * s[:, None] * s[None, :]
    bn = bs * s
    L, info = torch.linalg.cholesky_ex(Hn)

    def solve(rhs):
        return torch.cholesky_solve(rhs[:, None], L)[:, 0]

    y = solve(bn)
    y = y + solve(bn - Hn @ y)  # iterative refinement
    bad = (info != 0) | ~torch.isfinite(L[-1, -1])
    eye = torch.eye(Hn.shape[0], dtype=dtype, device=dev)
    y_lu, _ = torch.linalg.solve_ex(torch.where(bad, Hn + eye * 1e-6, Hn), bn)
    y = torch.where(bad, y_lu, y)
    return y * s


def _apply(state: WindowState, feats: FeatureStore, delta, delta_d, cfg: BAConfig):
    new_state = retract(state, delta)
    new_depth = torch.clamp(feats.inv_depth + delta_d, min=cfg.depth_min)
    new_depth = torch.where(feats.inv_depth > 0, new_depth, feats.inv_depth)
    return new_state, feats._replace(inv_depth=new_depth)


def optimize(state: WindowState, feats: FeatureStore, pre: StackedPreint,
             lidar: LidarConstraints, prior: MargPrior, cfg: BAConfig = BAConfig()):
    """LM loop with re-anchoring; returns (state, feats, final_cost). The
    reference's `lax.scan` over the iterations is a host loop; nothing in it
    reads the device."""
    check_config(cfg)
    return lm_loop(state, feats, cfg, lambda st, ft, c: build_system(st, ft, pre, lidar, prior,
                                                                     cfg, c),
                   lambda sys, lam: schur_solve(sys, lam, cfg),
                   lambda st, ft, c: total_cost(st, ft, pre, lidar, prior, cfg, c))


def lm_loop(state: WindowState, feats: FeatureStore, cfg: BAConfig, build, solve, cost_fn):
    """The annealed LM loop of `optimize` over a system builder
    build(state, feats, cauchy_c) -> System, a solver solve(System, lam) ->
    (delta, delta_d) and cost_fn(state, feats, cauchy_c); the sharded BA
    passes its reduced ones. Returns (state, feats, final_cost)."""
    anchor_p0 = state.p[0].clone()
    anchor_ypr0 = lie.R2ypr(lie.q2R(state.q[0]))

    dtype, dev = state.p.dtype, state.p.device
    # graduated non-convexity: anneal the Cauchy scale 16 -> 1 over the first
    # iterations so far-out (but inlier) residuals keep gradient early on
    sched = [max(1.0, 16.0 * 0.25 ** k) for k in range(cfg.max_iters)]
    lam = host_constant(cfg.lm_init, dtype, dev)
    cost = None
    for cauchy_c in sched:
        sys = build(state, feats, cauchy_c)
        delta, delta_d = solve(sys, lam)
        cand_st, cand_ft = _apply(state, feats, delta, delta_d, cfg)
        new_cost = cost_fn(cand_st, cand_ft, cauchy_c)
        accept = (new_cost < sys.cost) & torch.isfinite(new_cost)
        state = WindowState(*(torch.where(accept, b_, a) for a, b_ in zip(state, cand_st)))
        feats = feats._replace(inv_depth=torch.where(accept, cand_ft.inv_depth, feats.inv_depth))
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-7), lam * 8.0)
        cost = torch.where(accept, new_cost, sys.cost)

    state = re_anchor(state, anchor_p0, anchor_ypr0)
    return state, feats, cost


def re_anchor(state: WindowState, anchor_p0, anchor_ypr0) -> WindowState:
    """Fix the 4-dof gauge like double2vector (estimator.cpp:549-638): restore
    frame-0 position and yaw to their pre-solve values."""
    ypr_new = lie.R2ypr(lie.q2R(state.q[0]))
    y_diff = anchor_ypr0[0] - ypr_new[0]
    zero = torch.zeros_like(y_diff)
    rot = lie.ypr2R(torch.stack([y_diff, zero, zero]))
    q_rot = lie.R2q(rot)
    p_new = torch.einsum("ij,kj->ki", rot, state.p - state.p[0]) + anchor_p0
    q_new = lie.qnormalize(lie.qmul(q_rot[None, :], state.q))
    v_new = torch.einsum("ij,kj->ki", rot, state.v)
    return state._replace(p=p_new, q=q_new, v=v_new)
