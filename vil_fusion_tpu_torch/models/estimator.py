"""Sliding-window visual-inertial-LiDAR estimator (orchestration).

Port of vil_fusion_tpu/models/estimator.py (the reference's `Estimator`,
estimator.{h,cpp}: processIMU :103-137, processImage :139-236, solveOdometry
:492-503, slideWindow :1052-1177, failureDetection :640-686, and the feature
manager, feature_manager.cpp: addFeatureCheckParallax :44-105, triangulate
:218-270).

`fused_full_step` is the whole steady-state frame (IMU segment, feature
ingest, keyframe decision, triangulation, BA, marginalization, slide); the
host-side `VILEstimator` drives it once per synchronized bundle, and runs
the filling phase and the cold start itself.

Where the reference branches on device values with `lax.cond`, this port
branches on the host:
  * `run_ba` (BA + failure detection) is a host flag, True on the steady
    path;
  * the keyframe decision, which picks the marginalization path, is read
    once per frame on the host (`bool(is_key)`) after the BA is enqueued;
    the frame already reads its pose, cost and failure mask there.
No window tensor is written in place: every update makes a new tensor
(window.set_row), so views taken before an update (the failure check's
previous pose) keep their values.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vil_fusion_tpu_torch.models import ba
from vil_fusion_tpu_torch.models import imu as imu_mod
from vil_fusion_tpu_torch.models import initialization as init_mod
from vil_fusion_tpu_torch.models import marginalization as marg
from vil_fusion_tpu_torch.models.window import (
    D, K, FeatureStore, LidarConstraints, StackedPreint, WindowState, init_features,
    init_lidar_constraints, init_preint, init_window, make_segment, set_preint_row, set_row,
)
from vil_fusion_tpu_torch.ops import lie
from vil_fusion_tpu_torch.ops.linalg import smallest_eigvec_inverse_iteration

MIN_PARALLAX = 10.0 / 460.0  # parameters.cpp MIN_PARALLAX / FOCAL_LENGTH


class EstimatorConfig(NamedTuple):
    ba: ba.BAConfig = ba.BAConfig()
    f_cap: int = 128  # feature slots (reference tracks MAX_CNT=200 / frame)
    imu_cap: int = 64  # IMU samples per inter-frame segment (merge headroom)
    obs_cap: int = 128  # per-frame feature observations
    imu_noise: imu_mod.ImuNoise = imu_mod.ImuNoise()
    min_parallax: float = MIN_PARALLAX
    min_track_for_nonkey: int = 20  # addFeatureCheckParallax :60
    tri_min_depth: float = 0.1


# ---------------------------------------------------------------------------
# per-frame steps
# ---------------------------------------------------------------------------

def propagate_from_segment(state: WindowState, seg_dp, seg_dq, seg_dv, seg_dt,
                           slot_prev: int, gravity):
    """IMU mechanization of the new frame's state from the preintegrated
    segment (estimator.cpp processIMU world-frame propagation :120-135)."""
    p_i = state.p[slot_prev]
    q_i = state.q[slot_prev]
    v_i = state.v[slot_prev]
    q_j = lie.qnormalize(lie.qmul(q_i, seg_dq))
    v_j = v_i - gravity * seg_dt + lie.qrot(q_i, seg_dv)
    p_j = p_i + v_i * seg_dt - 0.5 * gravity * seg_dt * seg_dt + lie.qrot(q_i, seg_dp)
    return p_j, q_j, v_j


def ingest_features(feats: FeatureStore, ids, xy, vel, depth, fc: int,
                    tshift=None) -> FeatureStore:
    """Associate incoming per-frame observations (M,) with feature slots by
    id; allocate free slots for new tracks; inject LiDAR depth for new
    tracks (feature_manager addFeatureCheckParallax :44-79 rebuild). `fc` is
    the current frame slot; ids == -1 marks empty rows."""
    F = feats.active.shape[0]
    dev = ids.device
    present = ids >= 0

    # --- match against existing slots (first matching slot) ---
    eq = (feats.feat_id[:, None] == ids[None, :]) & feats.active[:, None] & present[None, :]
    has_match = torch.any(eq, dim=0)  # (M,)
    match_slot = torch.argmax(eq.to(torch.int32), dim=0)  # (M,)

    # --- allocate slots for new tracks (stable: free slots in order) ---
    is_new = present & ~has_match
    free = ~feats.active
    free_slots = torch.argsort((~free).to(torch.int32), stable=True)  # free first
    n_free = torch.sum(free)
    new_rank = torch.cumsum(is_new.to(torch.int32), dim=0) - 1  # (M,)
    can_alloc = is_new & (new_rank < n_free)
    alloc_slot = free_slots[torch.clamp(new_rank, 0, F - 1)]

    slot = torch.where(has_match, match_slot, torch.where(can_alloc, alloc_slot, F))
    # scatter with an overflow row F, dropped afterwards

    def put(a, v, col=None):
        out = torch.cat([a, torch.zeros_like(a[:1])], dim=0)
        if col is None:
            out[slot] = v
        else:
            out[slot, col] = v
        return out[:F]

    def pad_at(a):
        return torch.cat([a, torch.zeros_like(a[:1])], dim=0)[slot]

    if tshift is None:
        tshift = torch.zeros_like(xy[:, 0])
    # lidar depth injection for NEW tracks only (depth is anchored at the
    # start frame, feature_manager.cpp:74-79). Sign convention from
    # feature_depth: positive = strong incidence -> constant-depth feature
    # (lidar_flag); negative (< -2 m) = grazing incidence -> the depth only
    # initializes inv_depth and BA refines it.
    mag = torch.abs(depth)
    new_depth_val = torch.where(mag >= 2.0, 1.0 / torch.clamp(mag, min=1e-3), -1.0)
    return FeatureStore(
        active=put(feats.active, present),
        start=put(feats.start, torch.where(has_match, pad_at(feats.start),
                                           fc).to(feats.start.dtype)),
        obs=put(feats.obs, xy, fc), obs_valid=put(feats.obs_valid, present, fc),
        vel=put(feats.vel, vel, fc), tshift=put(feats.tshift, tshift, fc),
        inv_depth=put(feats.inv_depth, torch.where(has_match, pad_at(feats.inv_depth),
                                                   new_depth_val)),
        lidar_flag=put(feats.lidar_flag, torch.where(has_match, pad_at(feats.lidar_flag),
                                                     depth > 0)),
        feat_id=put(feats.feat_id, torch.where(present, ids, -1).to(feats.feat_id.dtype)))


def keyframe_decision(feats: FeatureStore, fc: int, min_parallax: float = MIN_PARALLAX,
                      min_track: int = 20):
    """True (0-d bool tensor) if the SECOND-newest frame is a keyframe
    (addFeatureCheckParallax :44-105 + compensatedParallax2)."""
    f2 = max(fc - 2, 0)
    f1 = max(fc - 1, 0)
    both = feats.active & feats.obs_valid[:, f2] & feats.obs_valid[:, f1]
    par = torch.linalg.norm(feats.obs[:, f2] - feats.obs[:, f1], dim=-1)
    n_both = torch.sum(both)
    mean_par = torch.sum(torch.where(both, par, 0.0)) / torch.clamp(n_both, min=1)
    tracked = torch.sum(feats.active & feats.obs_valid[:, fc] & (feats.start < fc))
    return (fc < 2) | (tracked < min_track) | (n_both == 0) | (mean_par >= min_parallax)


def _camera_poses(state: WindowState):
    q_c = lie.qmul(state.q, state.qic[None, :])  # (K, 4)
    p_c = lie.qrot(state.q, state.tic.expand(K, 3)) + state.p
    return q_c, p_c


def triangulate(state: WindowState, feats: FeatureStore, min_depth: float = 0.1) -> FeatureStore:
    """Multi-view DLT triangulation for features without depth
    (feature_manager.cpp triangulate :218-270; skips lidar-depthed tracks).

    Anchor camera = camera at the start frame; A X = 0 with A built from
    every observation's projective rows, solved by inverse iteration on the
    batched 4x4 normal matrices (ops/linalg)."""
    q_c, p_c = _camera_poses(state)
    start = feats.start.long()
    q_a = q_c[start]  # (F, 4)
    p_a = p_c[start]
    # T_j<-anchor: x_j = R_cj^T (R_ca x_a + p_ca - p_cj)
    R_rel = lie.q2R(lie.qmul(lie.qconj(q_c)[None], q_a[:, None]))  # (F, K, 3, 3)
    t_rel = lie.qrot(lie.qconj(q_c)[None], p_a[:, None] - p_c[None])  # (F, K, 3)
    P = torch.cat([R_rel, t_rel[..., None]], dim=-1)  # (F, K, 3, 4)
    u = feats.obs[..., 0:1]
    v = feats.obs[..., 1:2]
    w = feats.obs_valid.to(feats.obs.dtype)[..., None]
    row_u = (u * P[:, :, 2] - P[:, :, 0]) * w  # (F, K, 4)
    row_v = (v * P[:, :, 2] - P[:, :, 1]) * w
    A = torch.cat([row_u, row_v], dim=1)  # (F, 2K, 4)
    AtA = A.transpose(-1, -2) @ A
    n_obs = torch.sum(feats.obs_valid, dim=1)
    X = smallest_eigvec_inverse_iteration(AtA)
    depth = X[:, 2] / torch.where(torch.abs(X[:, 3]) > 1e-12, X[:, 3], 1e-12)

    need = feats.active & (feats.inv_depth <= 0) & (n_obs >= 2) & ~feats.lidar_flag
    ok = need & (depth > min_depth) & torch.isfinite(depth)
    inv_depth = torch.where(ok, 1.0 / torch.clamp(depth, min=min_depth), feats.inv_depth)
    return feats._replace(inv_depth=inv_depth)


def landmarks_world(state: WindowState, feats: FeatureStore, slot: int):
    """World-frame 3D points of depth-resolved features observed at `slot`,
    plus their normalized obs there (pubKeyframe export, visualization.cpp
    :385-440). Returns (pts_w (F, 3), obs_xy (F, 2), ids (F,), valid (F,),
    observed (F,))."""
    F = feats.active.shape[0]
    rows = torch.arange(F, device=feats.obs.device)
    q_c, p_c = _camera_poses(state)
    s = feats.start.long()
    anchor_obs = feats.obs[rows, s]
    depth = 1.0 / torch.clamp(feats.inv_depth, min=1e-6)
    pts_c = torch.cat([anchor_obs, torch.ones_like(anchor_obs[:, :1])], dim=-1) * depth[:, None]
    pts_w = lie.qrot(q_c[s], pts_c) + p_c[s]
    valid = (feats.active & (feats.inv_depth > 0)
             & feats.obs_valid[rows, s] & feats.obs_valid[:, slot])
    observed = feats.active & feats.obs_valid[:, slot]
    return pts_w, feats.obs[:, slot], feats.feat_id, valid, observed


def gauge_transform(window: WindowState, prior, R_d, t_d):
    """Re-anchor the whole window by a yaw+translation transform — the VIO
    gauge freedom (relocalization feedback, estimator.cpp setReloFrame
    :1188-1206). Exact for every factor: the marginalization prior keeps its
    value by moving its linearization point and rotating the position and
    velocity columns of its Jacobian."""
    dtype, dev = window.p.dtype, window.p.device
    R_d = torch.as_tensor(R_d, dtype=dtype, device=dev)
    t_d = torch.as_tensor(t_d, dtype=dtype, device=dev)
    q_d = lie.R2q(R_d)

    def move(st: WindowState) -> WindowState:
        return st._replace(p=st.p @ R_d.T + t_d[None, :],
                           q=lie.qnormalize(lie.qmul(q_d[None, :], st.q)),
                           v=st.v @ R_d.T)

    G = torch.eye(D, dtype=dtype, device=dev)
    for i in range(K):
        G[15 * i:15 * i + 3, 15 * i:15 * i + 3] = R_d.T
        G[15 * i + 6:15 * i + 9, 15 * i + 6:15 * i + 9] = R_d.T
    return move(window), prior._replace(J=prior.J @ G, lin=move(prior.lin))


# failure_detection bitmask layout (nonzero == failed); FAIL_NAMES decodes a
# host-fetched mask into the predicate names for restart-cause reporting
FAIL_NAMES = {1: "acc_bias_norm", 2: "gyr_bias_norm", 4: "position_jump",
              8: "z_jump", 16: "rotation_jump"}


def decode_failure(mask: int):
    return [name for bit, name in FAIL_NAMES.items() if int(mask) & bit]


def failure_detection(state: WindowState, state_prev_p, state_prev_q):
    """Divergence detector (estimator.cpp failureDetection :640-686): bias
    norms, translation/z jumps, rotation jump. Returns an int32 bitmask of
    the fired predicates (0 == healthy)."""
    big_ba = torch.linalg.norm(state.ba[K - 1]) > 2.5
    big_bg = torch.linalg.norm(state.bg[K - 1]) > 1.0
    dp = state.p[K - 1] - state_prev_p
    big_jump = torch.linalg.norm(dp) > 5.0
    big_z = torch.abs(dp[2]) > 1.0
    dq = lie.qmul(lie.qconj(state_prev_q), state.q[K - 1])
    big_rot = torch.linalg.norm(lie.so3_log(dq)) > 0.87  # ~50 deg
    i32 = torch.int32
    return (big_ba.to(i32) | (big_bg.to(i32) << 1) | (big_jump.to(i32) << 2)
            | (big_z.to(i32) << 3) | (big_rot.to(i32) << 4))


# ---------------------------------------------------------------------------
# The full-window frame step
# ---------------------------------------------------------------------------

def fused_full_step(window: WindowState, feats: FeatureStore, pre: StackedPreint,
                    lidar: LidarConstraints, prior,
                    acc_b, gyr_b, dt_b, n_imu,  # padded IMU segment buffers + count
                    ids_b, xy_b, vel_b, dep_b, tsh_b,  # padded feature observations
                    lidar_q_rel, lidar_p_rel, lidar_valid,
                    run_ba: bool, cfg: EstimatorConfig):
    """The entire full-window frame: IMU segment + propagate + lidar
    constraint + feature ingest + keyframe decision + triangulate + BA +
    marginalize + slide.

    `n_imu` is the segment's sample count (a host int or a 0-d tensor);
    `lidar_valid` a 0-d bool tensor; `run_ba` a host bool (initialized: BA +
    failure detection). Returns (window, feats, pre, lidar, prior, outputs)
    with outputs {p, q, v, cost, failed} of the newest frame, before the
    slide, as device tensors, and is_key, the keyframe decision read on the
    host."""
    fc = K - 1
    dtype, dev = window.p.dtype, window.p.device
    gravity = torch.as_tensor(cfg.ba.gravity, dtype=dtype, device=dev)
    n_imu = torch.as_tensor(n_imu, dtype=torch.int32, device=dev)

    # --- IMU segment into slot K-1 + state propagation ---
    seg = make_segment(acc_b, gyr_b, dt_b, n_imu, window.ba[fc - 1], window.bg[fc - 1],
                       cfg.imu_noise, cfg.imu_cap)
    pre = set_preint_row(pre, fc, seg)
    has_imu = n_imu > 0
    p_j, q_j, v_j = propagate_from_segment(window, seg["dp"], seg["dq"], seg["dv"],
                                           seg["dt_sum"], fc - 1, gravity)
    window = window._replace(
        p=set_row(window.p, fc, torch.where(has_imu, p_j, window.p[fc])),
        q=set_row(window.q, fc, torch.where(has_imu, q_j, window.q[fc])),
        v=set_row(window.v, fc, torch.where(has_imu, v_j, window.v[fc])),
        ba=set_row(window.ba, fc, window.ba[fc - 1]),
        bg=set_row(window.bg, fc, window.bg[fc - 1]))

    # --- lidar inter-frame constraint ---
    lidar = LidarConstraints(
        q_rel=set_row(lidar.q_rel, fc, torch.where(lidar_valid, lidar_q_rel, lidar.q_rel[fc])),
        p_rel=set_row(lidar.p_rel, fc, torch.where(lidar_valid, lidar_p_rel, lidar.p_rel[fc])),
        valid=set_row(lidar.valid, fc, lidar_valid))

    # --- features + keyframe decision ---
    feats = ingest_features(feats, ids_b, xy_b, vel_b, dep_b, fc, tsh_b)
    is_key = keyframe_decision(feats, fc, cfg.min_parallax, cfg.min_track_for_nonkey)

    # --- triangulate + BA (only when initialized) ---
    prev_p = window.p[K - 1].clone()
    prev_q = window.q[K - 1].clone()
    if run_ba:
        feats = triangulate(window, feats, cfg.tri_min_depth)
        window, feats, cost = _optimize(window, feats, pre, lidar, prior, cfg.ba)
        failed = failure_detection(window, prev_p, prev_q)
    else:
        cost = torch.zeros((), dtype=dtype, device=dev)
        failed = torch.zeros((), dtype=torch.int32, device=dev)

    out_p = window.p[K - 1].clone()
    out_q = window.q[K - 1].clone()
    out_v = window.v[K - 1].clone()

    # --- marginalize + slide (keyframe vs non-keyframe path) ---
    key = bool(is_key)  # the step's host read: it picks the marginalization path
    window, feats, pre, lidar, prior = _marginalize_and_slide(
        key, window, feats, pre, lidar, prior, cfg)
    outputs = dict(p=out_p, q=out_q, v=out_v, cost=cost, failed=failed, is_key=key)
    return window, feats, pre, lidar, prior, outputs


def _optimize(window, feats, pre, lidar, prior, cfg: ba.BAConfig):
    """The BA of a frame: landmark-sharded over the active mesh with
    cfg.sharded (estimator.py:343-350 of the reference), else ba.optimize."""
    if cfg.sharded:
        from vil_fusion_tpu_torch.parallel import sharded_ba

        return sharded_ba.optimize_on_active_mesh(window, feats, pre, lidar, prior, cfg)
    return ba.optimize(window, feats, pre, lidar, prior, cfg)


def _marginalize_and_slide(is_key: bool, window, feats, pre, lidar, prior,
                           cfg: EstimatorConfig):
    if is_key:
        new_prior = marg.marginalize_old(window, feats, pre, lidar, prior, cfg.ba)
        window, feats, pre, lidar = marg.slide_old(window, feats, pre, lidar, cfg.imu_noise)
        return window, feats, pre, lidar, new_prior
    window, feats, pre, lidar = marg.slide_new(window, feats, pre, lidar, cfg.imu_noise,
                                               cfg.imu_cap)
    return window, feats, pre, lidar, marg.marginalize_second_new(prior, window)


# ---------------------------------------------------------------------------
# Host-side estimator
# ---------------------------------------------------------------------------

class VILEstimator:
    """Single-controller rebuild of the estimator node (estimator_node.cpp).

    Call `process_frame` (host arrays) or `process_frame_device` (padded
    tensors) once per synchronized bundle. During the filling phase (first K
    frames) states are propagated by IMU only; once the window is full,
    every frame runs triangulate -> BA -> marginalize -> slide. `device`
    places every state tensor."""

    def __init__(self, cfg: EstimatorConfig = EstimatorConfig(), dtype=torch.float32,
                 device="cuda"):
        ba.check_config(cfg.ba)
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.window = init_window(dtype, self.device)
        self.feats = init_features(cfg.f_cap, dtype, self.device)
        self.pre = init_preint(cfg.imu_cap, dtype, self.device)
        self.lidar = init_lidar_constraints(dtype, self.device)
        self.prior = ba.empty_prior(self.window)
        self.frame_count = 0  # host-side (mirrors Estimator::frame_count)
        self.initialized = False
        self.failed = False
        self.fail_mask = 0  # failure_detection bitmask of the failing frame
        self.last_cost = 0.0
        self.last_is_key = None  # keyframe decision of the last frame
        self.fused_steps = 0  # frames that ran fused_full_step
        self.init_failures: dict = {}  # cold-start attempts refused, by gate
        self.gravity = torch.as_tensor(cfg.ba.gravity, dtype=dtype, device=self.device)

    def _t(self, x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype or self.dtype, device=self.device)

    # -- bootstrap helpers ---------------------------------------------------
    def set_initial_state(self, p, q, v, ba_=None, bg=None):
        """Oracle/LiDAR bootstrap: set frame-0 state (the init module provides
        the visual-inertial alignment path)."""
        z3 = np.zeros(3)
        w = self.window
        self.window = w._replace(
            p=set_row(w.p, 0, self._t(p)), q=set_row(w.q, 0, self._t(q)),
            v=set_row(w.v, 0, self._t(v)),
            ba=set_row(w.ba, 0, self._t(z3 if ba_ is None else ba_)),
            bg=set_row(w.bg, 0, self._t(z3 if bg is None else bg)))
        self.initialized = True

    def apply_drift(self, R_d, t_d):
        """Relocalization feedback: move the window + marg prior into the
        loop-corrected frame (a pure gauge transform, see gauge_transform)."""
        self.window, self.prior = gauge_transform(self.window, self.prior, self._t(R_d),
                                                  self._t(t_d))

    def set_extrinsics(self, qic, tic, td=0.0):
        self.window = self.window._replace(qic=self._t(qic), tic=self._t(tic), td=self._t(td))

    # -- per-frame processing ------------------------------------------------
    def process_frame(self, imu_acc, imu_gyr, imu_dt, obs_ids, obs_xy,
                      obs_vel=None, obs_depth=None, lidar_q_rel=None,
                      lidar_p_rel=None, obs_tshift=None):
        """One synchronized frame bundle (host arrays). Returns (p, q, v) of
        the newest frame as numpy arrays.

        imu_acc/imu_gyr: (n, 3) samples since previous frame (empty for first).
        obs_ids/obs_xy: per-frame feature observations (normalized plane).
        lidar_*_rel: relative body pose from LiDAR odometry since prev frame.
        """
        M = self.cfg.obs_cap
        ids_b = np.full((M,), -1, np.int32)
        xy_b = np.zeros((M, 2), np.float32)
        vel_b = np.zeros((M, 2), np.float32)
        dep_b = np.zeros((M,), np.float32)
        tsh_b = np.zeros((M,), np.float32)
        m = min(len(obs_ids), M)
        ids_b[:m] = obs_ids[:m]
        xy_b[:m] = obs_xy[:m]
        if obs_vel is not None:
            vel_b[:m] = obs_vel[:m]
        if obs_depth is not None:
            dep_b[:m] = obs_depth[:m]
        if obs_tshift is not None:
            tsh_b[:m] = obs_tshift[:m]
        acc_b, gyr_b, dt_b, n_imu = self._pack_imu(imu_acc, imu_gyr, imu_dt)
        has_lidar = lidar_q_rel is not None and min(self.frame_count, K - 1) > 0
        return self.process_frame_device(
            self._t(acc_b), self._t(gyr_b), self._t(dt_b), n_imu,
            self._t(ids_b, torch.int32), self._t(xy_b), self._t(vel_b), self._t(dep_b),
            lidar_q_rel=self._t(lidar_q_rel) if has_lidar else None,
            lidar_p_rel=self._t(lidar_p_rel) if has_lidar else None, tsh=self._t(tsh_b))

    def process_frame_device(self, acc_b, gyr_b, dt_b, n_imu: int, ids, xy, vel, dep,
                             lidar_q_rel=None, lidar_p_rel=None, tsh=None):
        """One frame from fixed-capacity device tensors (tracker outputs flow
        straight in: obs_cap-length rows, ids == -1 marks empty slots;
        `n_imu` is the host count of _pack_imu). The steady state runs
        fused_full_step and reads (p, q, v, cost, failed) in one host copy;
        the filling phase and the cold start run here. Returns (p, q, v) of
        the newest frame as numpy arrays."""
        cfg = self.cfg
        fc = min(self.frame_count, K - 1)
        has_lidar = lidar_q_rel is not None
        if tsh is None:
            tsh = torch.zeros_like(dep)

        # --- steady state: the fused frame step ---
        if self.frame_count >= K - 1 and self.initialized:
            out = self.process_frame_device_async(acc_b, gyr_b, dt_b, n_imu, ids, xy, vel, dep,
                                                  lidar_q_rel, lidar_p_rel, tsh)
            host = torch.cat([out["p"], out["q"], out["v"], out["cost"][None],
                              out["failed"].to(self.dtype)[None]]).cpu().numpy()
            self.absorb_result(host[10], host[11])
            return host[0:3], host[3:7], host[7:10]

        # --- filling phase / cold start: host-orchestrated path ---
        if fc > 0 and n_imu > 0:
            seg = self._store_segment(acc_b, gyr_b, dt_b, n_imu, fc)
            p_j, q_j, v_j = propagate_from_segment(self.window, seg["dp"], seg["dq"],
                                                   seg["dv"], seg["dt_sum"], fc - 1,
                                                   self.gravity)
            w = self.window
            self.window = w._replace(
                p=set_row(w.p, fc, p_j), q=set_row(w.q, fc, q_j), v=set_row(w.v, fc, v_j),
                ba=set_row(w.ba, fc, w.ba[fc - 1]), bg=set_row(w.bg, fc, w.bg[fc - 1]))
        if has_lidar and fc > 0:
            self.lidar = LidarConstraints(
                q_rel=set_row(self.lidar.q_rel, fc, lidar_q_rel),
                p_rel=set_row(self.lidar.p_rel, fc, lidar_p_rel),
                valid=set_row(self.lidar.valid, fc, True))
        self.feats = ingest_features(self.feats, ids, xy, vel, dep, fc, tsh)

        if self.frame_count < K - 1:
            self.frame_count += 1
            return self._current_pose(fc)

        # --- cold start: visual-inertial initialization (initialStructure) ---
        if not self.initialized:
            self._try_initialize()
        if self.initialized:
            prev_p = self.window.p[K - 1].clone()
            prev_q = self.window.q[K - 1].clone()
            self.feats = triangulate(self.window, self.feats, cfg.tri_min_depth)
            self.window, self.feats, cost = _optimize(self.window, self.feats, self.pre,
                                                      self.lidar, self.prior, cfg.ba)
            self.last_cost = float(cost)
            mask = int(failure_detection(self.window, prev_p, prev_q))
            if mask:
                self.failed = True
                self.fail_mask = mask

        is_key = bool(keyframe_decision(self.feats, fc, cfg.min_parallax,
                                        cfg.min_track_for_nonkey))
        self.last_is_key = is_key
        self.window, self.feats, self.pre, self.lidar, self.prior = _marginalize_and_slide(
            is_key, self.window, self.feats, self.pre, self.lidar, self.prior, cfg)
        return self._current_pose(K - 1)

    def process_frame_device_async(self, acc_b, gyr_b, dt_b, n_imu: int, ids, xy, vel, dep,
                                   lidar_q_rel=None, lidar_p_rel=None, tsh=None) -> dict:
        """The steady-state fused step without reading its results: enqueues
        fused_full_step and returns its output dict of device tensors (p, q,
        v, cost, failed, is_key). The caller fetches out["cost"] and
        out["failed"] later and passes them to `absorb_result` (deferred
        failure detection, the reference's sync_depth > 0 path). The
        keyframe decision that picks the marginalization path is still read
        on the host inside the step; everything after it is deferred."""
        if not (self.frame_count >= K - 1 and self.initialized):
            raise ValueError("process_frame_device_async needs an initialized, full window")
        has_lidar = lidar_q_rel is not None
        if not has_lidar:
            lidar_q_rel = torch.tensor([1.0, 0, 0, 0], dtype=self.dtype, device=self.device)
            lidar_p_rel = torch.zeros(3, dtype=self.dtype, device=self.device)
        if tsh is None:
            tsh = torch.zeros_like(dep)
        (self.window, self.feats, self.pre, self.lidar, self.prior,
         out) = fused_full_step(
            self.window, self.feats, self.pre, self.lidar, self.prior,
            acc_b, gyr_b, dt_b, n_imu, ids, xy, vel, dep, tsh, lidar_q_rel, lidar_p_rel,
            torch.tensor(has_lidar, device=self.device), True, self.cfg)
        self.fused_steps += 1
        self.last_is_key = out["is_key"]
        return out

    def absorb_result(self, host_cost, host_failed):
        """Record a frame result read by the caller. host_failed is the
        failure_detection bitmask (nonzero == failed), kept on `fail_mask`
        for restart-cause logging."""
        self.last_cost = float(host_cost)
        if int(host_failed):
            self.failed = True
            self.fail_mask = int(host_failed)

    def _pack_imu(self, acc, gyr, dts):
        """Pad/decimate raw IMU arrays into fixed-capacity numpy buffers;
        returns (acc_b, gyr_b, dt_b, n) with n a host int."""
        cap = self.cfg.imu_cap
        n = len(acc)
        if n > cap:
            stride = -(-n // cap)  # ceil: decimate, preserving total time
            keep = np.arange(0, n, stride)
            cum = np.concatenate([[0.0], np.cumsum(dts[: n - 1])])
            acc = acc[keep]
            gyr = gyr[keep]
            dts = np.diff(np.concatenate([cum[keep], cum[-1:]]))
            n = len(acc)
        acc_b = np.zeros((cap, 3), np.float32)
        gyr_b = np.zeros((cap, 3), np.float32)
        dt_b = np.zeros((cap - 1,), np.float32)
        if n:
            acc_b[:n] = acc
            gyr_b[:n] = gyr
            acc_b[n:] = acc[-1]
            gyr_b[n:] = gyr[-1]
            dt_b[: n - 1] = dts[: n - 1]
        return acc_b, gyr_b, dt_b, n

    def _store_segment(self, acc_b, gyr_b, dt_b, n, slot):
        seg = make_segment(acc_b, gyr_b, dt_b,
                           torch.tensor(n, dtype=torch.int32, device=self.device),
                           self.window.ba[slot], self.window.bg[slot],
                           self.cfg.imu_noise, self.cfg.imu_cap)
        self.pre = set_preint_row(self.pre, slot, seg)
        return seg

    def _try_initialize(self, sel=None) -> bool:
        """Cold-start init (estimator.cpp initialStructure :237-381 +
        visualInitialAlign :383-459): SfM over the window, gyro-bias solve,
        re-preintegration, linear alignment, gravity-frame alignment. The
        SfM's RANSAC draws from a generator seeded with the frame count (the
        reference keys it the same way); `sel` injects its sample indices."""
        cfg = self.cfg

        # IMU excitation check (:244-263): enough acceleration variance
        dv_norm = torch.linalg.norm(self.pre.dv, dim=-1).cpu().numpy()
        dt_sum = self.pre.dt_sum.cpu().numpy()
        valid_seg = self.pre.valid.cpu().numpy()
        mean_g = dv_norm[valid_seg] / np.maximum(dt_sum[valid_seg], 1e-6)
        if valid_seg.sum() < K - 1 or np.std(mean_g) < 0.15:
            return self._init_failed("imu_excitation")

        gen = None
        if sel is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.frame_count)
        sfm, pts_w, pts_ok = init_mod.global_sfm(
            self.feats.obs, self.feats.obs_valid & self.feats.active[:, None],
            generator=gen, sel=sel)
        if not bool(sfm.ok):
            return self._init_failed("sfm")

        qic = self.window.qic
        tic = self.window.tic
        # body rotations in the SfM (cam-l) frame
        q_b = lie.qnormalize(lie.qmul(sfm.q, lie.qconj(qic)[None, :]))

        # gyro bias from rotation-only preintegration, then re-preintegrate
        dbg = init_mod.solve_gyro_bias(sfm.q, qic, self.pre.dq, self.pre.jac[:, 3:6, 12:15],
                                       self.pre.valid)
        dbg_np = dbg.cpu().numpy()
        if not np.all(np.isfinite(dbg_np)):
            return self._init_failed("gyro_bias_not_finite")
        # physical plausibility: MEMS gyro biases are < ~0.1 rad/s; a large
        # estimate means the SfM rotation chain is junk
        if float(np.linalg.norm(dbg_np)) > 0.5:
            return self._init_failed("gyro_bias_norm")
        self._repropagate(torch.zeros(3, dtype=self.dtype, device=self.device), dbg)

        # vil mode: pin the metric scale from the lidar odometry's relative
        # translations (the joint [v, g, s] solve is near-degenerate under
        # sustained turning)
        s_lidar, _ = init_mod.lidar_scale_estimate(sfm.p, self.lidar.p_rel, self.lidar.valid)
        g_norm = float(np.linalg.norm(np.asarray(cfg.ba.gravity, np.float32)))
        pre = self.pre
        if s_lidar > 0:
            s_t = torch.tensor(s_lidar, dtype=self.dtype, device=self.device)
            v_b, g_est = init_mod.linear_alignment_fixed_scale(
                q_b, sfm.p, pre.dp, pre.dv, pre.dt_sum, pre.valid, tic, s_t)
            s = s_lidar
        else:
            v_b, g_est, s = init_mod.linear_alignment(
                q_b, sfm.p, pre.dp, pre.dv, pre.dt_sum, pre.valid, tic)
        if abs(float(torch.linalg.norm(g_est)) - g_norm) > 1.5 or float(s) < 0:
            return self._init_failed("gravity_or_scale")
        g_ref, v_b, s = init_mod.refine_gravity(
            q_b, sfm.p, pre.dp, pre.dv, pre.dt_sum, pre.valid, tic, g_est, g_norm,
            s_fixed=(torch.tensor(s_lidar, dtype=self.dtype, device=self.device)
                     if s_lidar > 0 else None))
        s = float(s)
        if s <= 0:
            return self._init_failed("refined_scale")

        # ---- visualInitialAlign: rotate everything into the gravity frame ----
        R0 = lie.g2R(g_ref)  # cam-l frame -> gravity-aligned world
        ypr0 = lie.R2ypr(R0 @ lie.q2R(q_b[0]))
        zero = torch.zeros_like(ypr0[0])
        R0 = lie.ypr2R(torch.stack([-ypr0[0], zero, zero])) @ R0
        q_R0 = lie.R2q(R0)

        p_b = s * sfm.p - lie.qrot(q_b, tic.expand(K, 3))
        p_new = lie.qrot(q_R0[None, :], p_b - p_b[0:1])
        q_new = lie.qnormalize(lie.qmul(q_R0[None, :], q_b))
        v_new = lie.qrot(q_new, v_b)  # body-frame vel -> world

        # vil-mode metric cross-check: the lidar odometry is metric, so the
        # recovered scale must agree with the accumulated lidar translation
        lid_ok = self.lidar.valid.cpu().numpy()
        if lid_ok.sum() >= 3:
            lid = float(np.linalg.norm(self.lidar.p_rel.cpu().numpy(), axis=-1)[lid_ok].sum())
            seg = np.linalg.norm(np.diff(p_new.cpu().numpy(), axis=0), axis=-1)
            vis = float(seg[lid_ok[1:]].sum())
            if lid > 1.0 and not (0.6 < vis / lid < 1.7):
                return self._init_failed("lidar_scale_check")

        self.window = self.window._replace(
            p=p_new, q=q_new, v=v_new,
            ba=torch.zeros((K, 3), dtype=self.dtype, device=self.device),
            bg=dbg.to(self.dtype).expand(K, 3).clone())
        # reset depths (re-triangulated with metric poses); keep lidar depths
        self.feats = self.feats._replace(
            inv_depth=torch.where(self.feats.lidar_flag, self.feats.inv_depth, -1.0))
        self.feats = triangulate(self.window, self.feats, cfg.tri_min_depth)
        self.prior = ba.empty_prior(self.window)
        self.initialized = True
        return True

    def _init_failed(self, gate: str) -> bool:
        """Count a cold-start attempt refused at `gate` (init_failures)."""
        self.init_failures[gate] = self.init_failures.get(gate, 0) + 1
        return False

    def _repropagate(self, ba_new, bg_new):
        """Re-preintegrate all segments with new biases (repropagate
        integration_base.h:130-145)."""
        rows = [make_segment(self.pre.acc_buf[i], self.pre.gyr_buf[i], self.pre.dt_buf[i],
                             self.pre.n_samples[i], ba_new, bg_new, self.cfg.imu_noise,
                             self.cfg.imu_cap) for i in range(K)]
        pre = StackedPreint(**{k: torch.stack([r[k] for r in rows]) for k in self.pre._fields})
        self.pre = pre._replace(valid=pre.n_samples > 0)

    def _current_pose(self, slot):
        w = self.window
        host = torch.cat([w.p[slot], w.q[slot], w.v[slot]]).cpu().numpy()
        return host[0:3], host[3:7], host[7:10]
