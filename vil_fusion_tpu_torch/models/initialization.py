"""Visual-inertial initialization: SfM bootstrap + IMU alignment.

Port of vil_fusion_tpu/models/initialization.py (the reference's
initialization stack):
  * relative pose   — initial/solve_5pts: 8-point RANSAC on normalized
    coordinates (models/klt.py) + closed-form essential decomposition with
    cheirality voting.
  * global SfM      — initial/initial_sfm GlobalSFM::construct: baseline
    frame by parallax (estimator.cpp relativePose :461-490), triangulation +
    PnP chain + pose GN with multi-view re-triangulation.
  * gyro bias + velocity/gravity/scale alignment — initial_aligment.cpp
    solveGyroscopeBias :3-44, LinearAlignment :77-160, RefineGravity :162-207.
  * camera-IMU rotation self-calibration — initial_ex_rotation.cpp.

The cold start runs once, so its branches are host branches: the baseline
frame is read to the host and the reference's `lax.cond`s on it become
`if`s; its `fori_loop`s are Python loops. The RANSAC draws from a
torch.Generator, or takes its sample indices as `sel`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from vil_fusion_tpu_torch.models import klt
from vil_fusion_tpu_torch.models.window import K
from vil_fusion_tpu_torch.ops import lie


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Two-view geometry
# ---------------------------------------------------------------------------

def triangulate_two_view(R, t, x1, x2):
    """Per-point least squares under x2_h ~ R x1_h d + t (R, t map cam1
    points into cam2). Returns depth d in cam1, depth in cam2 and the
    reprojection residual in cam2."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Rx1 = x1h @ R.T
    c = _cross(x2h, Rx1)
    ct = _cross(x2h, t)
    # c * d + ct = 0  (3 eqs, 1 unknown)
    d = -torch.sum(c * ct, dim=-1) / torch.clamp(torch.sum(c * c, dim=-1), min=1e-12)
    p2 = Rx1 * d[..., None] + t
    rep = p2[..., :2] / torch.clamp(p2[..., 2:3], min=1e-6) - x2
    return d, p2[..., 2], torch.linalg.norm(rep, dim=-1)


def decompose_essential(E, x1, x2, valid):
    """4-way (R, t) decomposition with cheirality voting (recoverPose analog).

    Returns (R, t, score) mapping cam1 coords to cam2: x2 ~ R x1 + t, |t| = 1.
    The SVD's signs are arbitrary; the four candidates are the same set
    whichever signs it picks."""
    U, _, Vt = torch.linalg.svd(E)
    # keep proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype,
                     device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t1 = U[:, 2]
    cands = [(R1, t1), (R1, -t1), (R2, t1), (R2, -t1)]

    def score(Rt):
        d1, z2, _ = triangulate_two_view(Rt[0], Rt[1], x1, x2)
        return torch.sum((d1 > 0) & (z2 > 0) & valid)

    scores = torch.stack([score(c) for c in cands])
    best = torch.argmax(scores)
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return Rs[best], ts[best], scores[best]


def relative_pose_ransac(x1, x2, valid, generator=None, sel=None, thresh_px=0.6,
                         focal=460.0):
    """solveRelativeRT rebuild: E by 8-point RANSAC + cheirality
    decomposition. Returns (R, t, inliers, n_inliers) with x2 ~ R x1 + t."""
    inl, F = klt.ransac_fundamental(x1, x2, valid, generator=generator, sel=sel,
                                    thresh_px=thresh_px, focal=focal)
    # F on normalized coords scaled by `focal` is E up to the focal factor
    S = torch.diag(torch.tensor([focal, focal, 1.0], dtype=x1.dtype, device=x1.device))
    E = S.T @ F @ S
    R, t, n_good = decompose_essential(E, x1, x2, inl)
    return R, t, inl, n_good


def pnp_gn(pts3d, obs, valid, q0, p0, iters: int = 10):
    """Batched-residual Gauss-Newton PnP: find (q, p) with x ~ proj(R^T(X - p))
    — pose of the CAMERA in the world (solvePnP analog, fixed iterations)."""
    dtype, dev = pts3d.dtype, pts3d.device

    def res_fn(delta, q, p):
        q_, p_ = lie.pose_retract((q, p), delta)
        pc = lie.qrot(lie.qconj(q_)[None, :], pts3d - p_[None, :])
        z = torch.clamp(pc[..., 2], min=1e-4)
        r = pc[..., :2] / z[..., None] - obs
        return (r * valid[:, None]).reshape(-1)

    q, p = q0, p0
    z = torch.zeros(6, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    for _ in range(iters):
        r = res_fn(z, q, p)
        J = jacfwd(res_fn)(z, q, p)
        H = J.T @ J + 1e-6 * eye6
        delta = torch.linalg.solve(H, -J.T @ r)
        q, p = lie.pose_retract((q, p), torch.clamp(delta, -0.5, 0.5))
    # final inlier check
    pc = lie.qrot(lie.qconj(q)[None, :], pts3d - p[None, :])
    zc = torch.clamp(pc[..., 2], min=1e-4)
    rep = torch.linalg.norm(pc[..., :2] / zc[..., None] - obs, dim=-1)
    return q, p, rep


# ---------------------------------------------------------------------------
# Global SfM over the window (GlobalSFM::construct)
# ---------------------------------------------------------------------------

class SfMResult(NamedTuple):
    q: torch.Tensor  # (K, 4) camera-frame rotations (world = frame l camera)
    p: torch.Tensor  # (K, 3) camera positions (up to scale)
    ok: torch.Tensor  # () success flag
    l_frame: int  # baseline frame index


def _find_baseline_frame(feats_obs, feats_valid, min_parallax=0.0217, min_corr=20):
    """relativePose :461-490: first frame l with enough correspondences to the
    newest frame and mean parallax above threshold (30/460). Returns
    (l, found) as device tensors."""
    newest = K - 1
    par_list, cnt_list = [], []
    for l in range(K - 1):
        both = feats_valid[:, l] & feats_valid[:, newest]
        par = torch.linalg.norm(feats_obs[:, l] - feats_obs[:, newest], dim=-1)
        n = torch.sum(both)
        par_list.append(torch.sum(torch.where(both, par, 0.0)) / torch.clamp(n, min=1))
        cnt_list.append(n)
    par = torch.stack(par_list)
    cnt = torch.stack(cnt_list)
    good = (par > min_parallax) & (cnt >= min_corr)
    return torch.argmax(good.to(torch.int32)), torch.any(good)  # first True


def global_sfm(feats_obs, feats_valid, generator=None, sel=None, reproj_iters: int = 12):
    """Pure-visual SfM over the K window frames.

    feats_obs: (F, K, 2) normalized observations; feats_valid: (F, K).
    Returns (SfMResult, pts_w, pts_ok) with camera poses in the frame-l
    camera coordinate system (x_w = R_i x_ci + p_i), translation scale
    |t_{l,newest}| = 1. Reads the baseline frame on the host."""
    dtype, dev = feats_obs.dtype, feats_obs.device
    Fn = feats_obs.shape[0]
    newest = K - 1
    l_dev, found = _find_baseline_frame(feats_obs, feats_valid)
    l = int(l_dev)

    obs_l = feats_obs[:, l]
    obs_n = feats_obs[:, newest]
    both_ln = feats_valid[:, l] & feats_valid[:, newest]
    R_rel, t_rel, inl, n_good = relative_pose_ransac(obs_l, obs_n, both_ln, generator=generator,
                                                     sel=sel)

    # poses: world = camera l frame. x_cn = R_rel x_cl + t_rel
    # => R_n (cam->world) = R_rel^T, p_n = -R_rel^T t_rel
    q = torch.zeros((K, 4), dtype=dtype, device=dev)
    q[:, 0] = 1.0
    p = torch.zeros((K, 3), dtype=dtype, device=dev)
    q[newest] = lie.R2q(R_rel.T)
    p[newest] = -R_rel.T @ t_rel

    # triangulate l<->newest
    ones = torch.ones((Fn, 1), dtype=dtype, device=dev)
    d_l, _, _ = triangulate_two_view(R_rel, t_rel, obs_l, obs_n)
    pts_w = torch.cat([obs_l, ones], -1) * d_l[:, None]
    pts_ok = both_ln & inl & (d_l > 0.05)

    # PnP chain: frames after l (forward), then before l (backward), each
    # followed by fresh triangulation against frame l's camera
    def solve_frame(i, q, p, pts_w, pts_ok, init_slot):
        vis = feats_valid[:, i] & pts_ok
        qi, pi, _ = pnp_gn(pts_w, feats_obs[:, i], vis.to(dtype), q[init_slot], p[init_slot])
        q = q.clone()
        p = p.clone()
        q[i] = qi
        p[i] = pi
        # triangulate new points vs frame l using solved pose i
        R_li = lie.q2R(lie.qmul(lie.qconj(qi), q[l]))  # cam l -> cam i
        t_li = lie.qrot(lie.qconj(qi), p[l] - pi)
        d_new, z2, rep2 = triangulate_two_view(R_li, t_li, obs_l, feats_obs[:, i])
        new_ok = (feats_valid[:, l] & feats_valid[:, i] & ~pts_ok
                  & (d_new > 0.05) & (z2 > 0.05) & (rep2 < 0.02))
        pts_new = torch.cat([obs_l, ones], -1) * d_new[:, None]
        return q, p, torch.where(new_ok[:, None], pts_new, pts_w), pts_ok | new_ok

    for i in range(l + 1, newest):
        q, p, pts_w, pts_ok = solve_frame(i, q, p, pts_w, pts_ok, max(i - 1, 0))
    for i in range(l - 1, -1, -1):
        q, p, pts_w, pts_ok = solve_frame(i, q, p, pts_w, pts_ok, min(i + 1, K - 1))

    # full-SfM refinement: alternate pose GN with multi-view DLT structure
    # re-triangulation (structure triangulated only against frame l is
    # biased at narrow baselines and warps the pose chain)
    mask = torch.ones((K, 6), dtype=dtype, device=dev)
    mask[l] = 0.0

    def sfm_residual(delta_flat, q, p, pts_w, pts_ok):
        qn, pn = lie.pose_retract((q, p), delta_flat.reshape(K, 6) * mask)
        pc = lie.qrot(lie.qconj(qn)[None, :, :], pts_w[:, None, :] - pn[None, :, :])
        z = torch.clamp(pc[..., 2], min=1e-4)
        r = pc[..., :2] / z[..., None] - feats_obs
        w = (feats_valid & pts_ok[:, None]).to(dtype)
        return (r * w[..., None]).reshape(-1)

    eye = torch.eye(K * 6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def gn_step(q, p, pts_w, pts_ok):
        z = torch.zeros(K * 6, dtype=dtype, device=dev)
        r = sfm_residual(z, q, p, pts_w, pts_ok)
        J = jacfwd(sfm_residual)(z, q, p, pts_w, pts_ok)
        H = J.T @ J + 1e-5 * eye
        delta = torch.linalg.solve(H, -J.T @ r)
        return lie.pose_retract((q, p), (delta * mask.reshape(-1)).reshape(K, 6))

    def retriangulate(q, p, pts_w, pts_ok):
        """Multi-view DLT per feature from the current poses; keeps the
        two-view point where DLT lacks support. Gauge: poses+points rescaled
        so |p[newest]| stays 1."""
        R_t = lie.q2R(q).transpose(-1, -2)  # (K, 3, 3) world->cam
        a_u = R_t[None, :, 0] - feats_obs[..., 0:1] * R_t[None, :, 2]
        a_v = R_t[None, :, 1] - feats_obs[..., 1:2] * R_t[None, :, 2]
        b_u = torch.einsum("fkc,kc->fk", a_u, p)
        b_v = torch.einsum("fkc,kc->fk", a_v, p)
        w = feats_valid.to(dtype)[..., None]
        A = torch.cat([a_u * w, a_v * w], dim=1)  # (F, 2K, 3)
        b = torch.cat([b_u * w[..., 0], b_v * w[..., 0]], dim=1)
        AtA = torch.einsum("frc,frd->fcd", A, A) + 1e-6 * eye3
        Atb = torch.einsum("frc,fr->fc", A, b)
        X = torch.linalg.solve(AtA, Atb[..., None])[..., 0]  # (F, 3)
        n_obs = feats_valid.sum(dim=1)
        depth_l = lie.qrot(lie.qconj(q[l]), X - p[l])[..., 2]
        pc = lie.qrot(lie.qconj(q)[None, :, :], X[:, None, :] - p[None, :, :])
        z = torch.clamp(pc[..., 2], min=1e-4)
        rep = torch.linalg.norm(pc[..., :2] / z[..., None] - feats_obs, dim=-1)
        rep_ok = torch.where(feats_valid, rep, 0.0).amax(dim=1) < 0.05
        good = (n_obs >= 2) & (depth_l > 0.05) & rep_ok
        pts_new = torch.where(good[:, None], X, pts_w)
        scale = 1.0 / torch.clamp(torch.linalg.norm(p[newest]), min=1e-6)
        return pts_new * scale, pts_ok | good, scale

    for _ in range(max(1, reproj_iters // 4)):
        for _ in range(4):
            q, p = gn_step(q, p, pts_w, pts_ok)
        pts_w, pts_ok, scale = retriangulate(q, p, pts_w, pts_ok)
        p = p * scale
    ok = found & (n_good > 15)
    return SfMResult(q=q, p=p, ok=ok, l_frame=l), pts_w, pts_ok


# ---------------------------------------------------------------------------
# Visual-IMU alignment (initial_aligment.cpp)
# ---------------------------------------------------------------------------

def solve_gyro_bias(q_cam, qic, pre_dq, pre_jac_q_bg, seg_valid):
    """solveGyroscopeBias :3-44: least squares on rotation preintegration.

    q_cam: (K, 4) camera rotations from SfM; qic camera-IMU rotation.
    Returns delta_bg (3,)."""
    dtype, dev = q_cam.dtype, q_cam.device
    q_b = lie.qmul(q_cam, lie.qconj(qic)[None, :])
    A = torch.zeros((3, 3), dtype=dtype, device=dev)
    b = torch.zeros((3,), dtype=dtype, device=dev)
    for i in range(K - 1):
        w = seg_valid[i + 1].to(dtype)
        q_ij = lie.qmul(lie.qconj(q_b[i]), q_b[i + 1])
        J = pre_jac_q_bg[i + 1]  # d(theta)/d(bg) (3, 3)
        r = 2.0 * lie.qmul(lie.qconj(pre_dq[i + 1]), q_ij)[1:]
        A = A + w * J.T @ J
        b = b + w * J.T @ r
    return torch.linalg.solve(A + 1e-8 * torch.eye(3, dtype=dtype, device=dev), b)


def _precond_solve(A, b):
    """Jacobi-preconditioned solve of the 1e-8-regularized normal equations."""
    n = A.shape[0]
    A = A + 1e-8 * torch.eye(n, dtype=A.dtype, device=A.device)
    s = 1.0 / torch.sqrt(torch.abs(torch.diagonal(A)) + 1e-10)
    return torch.linalg.solve(A * s[:, None] * s[None, :], b * s) * s


def _rows(n_state, dtype, dev):
    return (torch.zeros((6, n_state), dtype=dtype, device=dev),
            torch.zeros((6,), dtype=dtype, device=dev))


def linear_alignment(q_b, p_c, pre_dp, pre_dv, pre_dt, seg_valid, tic, g_norm=9.81):
    """LinearAlignment :77-160: solve velocities (body frame), gravity (world
    = cam-l frame) and metric scale from preintegrated deltas.

    q_b: (K, 4) body rotations in SfM world; p_c: (K, 3) camera positions
    (up to scale). State x = [v_0..v_{K-1} (3K), g (3), s (1)]."""
    dtype, dev = q_b.dtype, q_b.device
    n_state = 3 * K + 4
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    A = torch.zeros((n_state, n_state), dtype=dtype, device=dev)
    b = torch.zeros((n_state,), dtype=dtype, device=dev)
    for i in range(K - 1):
        w = seg_valid[i + 1].to(dtype)
        dt = pre_dt[i + 1]
        RiT = lie.q2R(q_b[i]).T
        Rj = lie.q2R(q_b[i + 1])
        H, z = _rows(n_state, dtype, dev)
        # position rows: dp = Ri^T( s(pc_j - pc_i) - Ri tic + Rj tic
        #                          - v_i dt + 0.5 g dt^2 )  (world gravity +)
        H[0:3, 3 * i: 3 * i + 3] = -dt * eye3
        H[0:3, 3 * K: 3 * K + 3] = 0.5 * dt * dt * RiT
        H[0:3, 3 * K + 3] = RiT @ (p_c[i + 1] - p_c[i])
        z[0:3] = pre_dp[i + 1] + RiT @ Rj @ tic - tic
        # velocity rows: dv = Ri^T( Rj v_j - Ri v_i + g dt )
        H[3:6, 3 * i: 3 * i + 3] = -eye3
        H[3:6, 3 * (i + 1): 3 * (i + 1) + 3] = RiT @ Rj
        H[3:6, 3 * K: 3 * K + 3] = dt * RiT
        z[3:6] = pre_dv[i + 1]
        A = A + w * H.T @ H
        b = b + w * H.T @ z
    x = _precond_solve(A, b)
    return x[: 3 * K].reshape(K, 3), x[3 * K: 3 * K + 3], x[3 * K + 3]


def linear_alignment_fixed_scale(q_b, p_c, pre_dp, pre_dv, pre_dt, seg_valid, tic, s):
    """LinearAlignment with the metric scale KNOWN (vil mode: the lidar
    odometry's relative translations are metric, so s is not estimated from
    the near-degenerate joint system). State x = [v_0..v_{K-1} (3K), g (3)]."""
    dtype, dev = q_b.dtype, q_b.device
    n_state = 3 * K + 3
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    A = torch.zeros((n_state, n_state), dtype=dtype, device=dev)
    b = torch.zeros((n_state,), dtype=dtype, device=dev)
    for i in range(K - 1):
        w = seg_valid[i + 1].to(dtype)
        dt = pre_dt[i + 1]
        RiT = lie.q2R(q_b[i]).T
        Rj = lie.q2R(q_b[i + 1])
        H, z = _rows(n_state, dtype, dev)
        H[0:3, 3 * i: 3 * i + 3] = -dt * eye3
        H[0:3, 3 * K: 3 * K + 3] = 0.5 * dt * dt * RiT
        z[0:3] = pre_dp[i + 1] + RiT @ Rj @ tic - tic - s * RiT @ (p_c[i + 1] - p_c[i])
        H[3:6, 3 * i: 3 * i + 3] = -eye3
        H[3:6, 3 * (i + 1): 3 * (i + 1) + 3] = RiT @ Rj
        H[3:6, 3 * K: 3 * K + 3] = dt * RiT
        z[3:6] = pre_dv[i + 1]
        A = A + w * H.T @ H
        b = b + w * H.T @ z
    x = _precond_solve(A, b)
    return x[: 3 * K].reshape(K, 3), x[3 * K: 3 * K + 3]


def lidar_scale_estimate(p_c, lidar_p_rel, lidar_valid):
    """Metric scale for the SfM translations from the lidar odometry's
    per-segment relative translations (norms are rotation invariant, t_ic
    offsets cancel to first order). Robust median over the window's valid
    segments. Returns (s, n_used) as host numbers."""
    p_c = _host(p_c)
    seg_vis = np.linalg.norm(np.diff(p_c, axis=0), axis=-1)  # (K-1,)
    seg_lid = np.linalg.norm(_host(lidar_p_rel), axis=-1)[1:]  # slot i+1
    ok = _host(lidar_valid)[1:] & (seg_vis > 1e-5) & (seg_lid > 0.02)
    if ok.sum() < 3:
        return -1.0, int(ok.sum())
    return float(np.median(seg_lid[ok] / seg_vis[ok])), int(ok.sum())


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def refine_gravity(q_b, p_c, pre_dp, pre_dv, pre_dt, seg_valid, tic,
                   g0, g_norm=9.81, iters: int = 4, s_fixed=None):
    """RefineGravity :162-207: re-solve with |g| fixed, 2-dof tangent basis.
    With `s_fixed` the scale column is moved to the measurement side (vil
    mode: metric scale pinned by the lidar odometry)."""
    dtype, dev = q_b.dtype, q_b.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    g = g0 / torch.linalg.norm(g0) * g_norm
    n_state = 3 * K + 3  # velocities + dg(2) + s(1; unused if fixed)
    for _ in range(iters):
        # tangent basis of g
        a = g / torch.linalg.norm(g)
        tmp = torch.where(torch.abs(a[2]) > 0.9,
                          torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev),
                          torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev))
        b1 = tmp - a * (a @ tmp)
        b1 = b1 / torch.linalg.norm(b1)
        b2 = _cross(a, b1)
        basis = torch.stack([b1, b2], dim=1)  # (3, 2)

        A = torch.zeros((n_state, n_state), dtype=dtype, device=dev)
        bb = torch.zeros((n_state,), dtype=dtype, device=dev)
        for i in range(K - 1):
            w = seg_valid[i + 1].to(dtype)
            dt = pre_dt[i + 1]
            RiT = lie.q2R(q_b[i]).T
            Rj = lie.q2R(q_b[i + 1])
            H, z = _rows(n_state, dtype, dev)
            H[0:3, 3 * i: 3 * i + 3] = -dt * eye3
            H[0:3, 3 * K: 3 * K + 2] = 0.5 * dt * dt * RiT @ basis
            zp = pre_dp[i + 1] + RiT @ Rj @ tic - tic - 0.5 * dt * dt * RiT @ g
            if s_fixed is None:
                H[0:3, 3 * K + 2] = RiT @ (p_c[i + 1] - p_c[i])
            else:
                zp = zp - s_fixed * RiT @ (p_c[i + 1] - p_c[i])
            z[0:3] = zp
            H[3:6, 3 * i: 3 * i + 3] = -eye3
            H[3:6, 3 * (i + 1): 3 * (i + 1) + 3] = RiT @ Rj
            H[3:6, 3 * K: 3 * K + 2] = dt * RiT @ basis
            z[3:6] = pre_dv[i + 1] - dt * RiT @ g
            A = A + w * H.T @ H
            bb = bb + w * H.T @ z
        x = _precond_solve(A, bb)
        dg = basis @ x[3 * K: 3 * K + 2]
        g = (g + dg) / torch.linalg.norm(g + dg) * g_norm
    v = x[: 3 * K].reshape(K, 3)
    s = (torch.as_tensor(s_fixed, dtype=dtype, device=dev) if s_fixed is not None
         else x[3 * K + 2])
    return g, v, s


def initial_ex_rotation(q_cam_rel, q_imu_rel, n_pairs=None):
    """Camera-IMU rotation self-calibration (initial_ex_rotation.cpp:14-25):
    stack Qleft(q_imu) - Qright(q_cam) and take the nullspace vector (the
    smallest right singular vector, sign fixed by positify)."""
    A = (lie.Qleft(q_imu_rel) - lie.Qright(q_cam_rel)).reshape(-1, 4)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    return lie.positify(lie.qnormalize(Vt[-1]))
