"""Sliding-window state layout for the visual-inertial-LiDAR estimator.

Port of vil_fusion_tpu/models/window.py (the reference's window arrays,
estimator.h:29-147: Ps/Rs/Vs/Bas/Bgs[WINDOW_SIZE+1], tic/ric, td,
pre_integrations, lidarConstraints) as NamedTuples of tensors. The BA
solver's tangent packs every non-landmark state into one D-dim vector:

  frame i (i in [0, K)):  [15*i, 15*i+15) = [dp, dtheta, dv, dba, dbg]
  camera-IMU extrinsic:   [15*K, 15*K+6)  = [dt_ic, dtheta_ic]
  time offset td:         [15*K + 6]

Landmark inverse depths form a separate F-dim tangent eliminated by Schur
complement (H_ll is diagonal).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from vil_fusion_tpu_torch.models import imu as imu_mod
from vil_fusion_tpu_torch.ops import lie

WINDOW_SIZE = 10  # parameters.h:24
K = WINDOW_SIZE + 1


class WindowState(NamedTuple):
    p: torch.Tensor  # (K, 3)
    q: torch.Tensor  # (K, 4)
    v: torch.Tensor  # (K, 3)
    ba: torch.Tensor  # (K, 3)
    bg: torch.Tensor  # (K, 3)
    tic: torch.Tensor  # (3,)  camera-IMU translation
    qic: torch.Tensor  # (4,)  camera-IMU rotation
    td: torch.Tensor  # ()    camera-IMU time offset


class FeatureStore(NamedTuple):
    """Fixed-capacity feature tracks (feature_manager.h:57-115 rebuild)."""

    active: torch.Tensor  # (F,) bool — slot in use
    start: torch.Tensor  # (F,) int32 — window index of first observation
    obs: torch.Tensor  # (F, K, 2) normalized-plane coords
    obs_valid: torch.Tensor  # (F, K) bool
    vel: torch.Tensor  # (F, K, 2) normalized-plane velocity (for td)
    # per-observation time shift in seconds: -td_at_capture + TR*row_norm
    # (rolling shutter, projection_td_factor.cpp:51-52)
    tshift: torch.Tensor  # (F, K)
    inv_depth: torch.Tensor  # (F,) inverse depth at start frame
    lidar_flag: torch.Tensor  # (F,) bool — depth from LiDAR, held constant in BA
    feat_id: torch.Tensor  # (F,) int32 — global track id (-1 = empty)


class StackedPreint(NamedTuple):
    """Preintegrated IMU per window slot i (segment frame i-1 -> i; slot 0
    unused). Raw sample buffers are kept (fixed capacity) so segments can be
    merged and re-integrated on non-keyframe marginalization
    (estimator.cpp:1143-1177)."""

    dp: torch.Tensor  # (K, 3)
    dq: torch.Tensor  # (K, 4)
    dv: torch.Tensor  # (K, 3)
    jac: torch.Tensor  # (K, 15, 15)
    sqrt_info: torch.Tensor  # (K, 15, 15)
    dt_sum: torch.Tensor  # (K,)
    ba: torch.Tensor  # (K, 3) linearization biases
    bg: torch.Tensor  # (K, 3)
    acc_buf: torch.Tensor  # (K, CAP, 3) raw samples
    gyr_buf: torch.Tensor  # (K, CAP, 3)
    dt_buf: torch.Tensor  # (K, CAP-1)
    n_samples: torch.Tensor  # (K,) int32 — valid samples in buffer
    valid: torch.Tensor  # (K,) bool — segment exists


class LidarConstraints(NamedTuple):
    """Per-slot relative body pose from LiDAR odometry
    (lidarConstraint_base.h:9-27): slot i holds the measured T_{i-1,i} in the
    IMU frame; composed on non-keyframe merge (estimator.cpp:1143-1145)."""

    q_rel: torch.Tensor  # (K, 4)
    p_rel: torch.Tensor  # (K, 3)
    valid: torch.Tensor  # (K,) bool


def pose_dim(k: int = K) -> int:
    return 15 * k + 7


D = pose_dim()


def _unit_q(n, dtype, device):
    q = torch.zeros((n, 4), dtype=dtype, device=device)
    q[:, 0] = 1.0
    return q


def init_window(dtype=torch.float32, device="cuda") -> WindowState:
    f = dict(dtype=dtype, device=device)
    return WindowState(
        p=torch.zeros((K, 3), **f), q=_unit_q(K, dtype, device), v=torch.zeros((K, 3), **f),
        ba=torch.zeros((K, 3), **f), bg=torch.zeros((K, 3), **f),
        tic=torch.zeros(3, **f), qic=torch.tensor([1.0, 0, 0, 0], **f),
        td=torch.zeros((), **f),
    )


def init_features(capacity: int, dtype=torch.float32, device="cuda") -> FeatureStore:
    f = dict(dtype=dtype, device=device)
    return FeatureStore(
        active=torch.zeros(capacity, dtype=torch.bool, device=device),
        start=torch.zeros(capacity, dtype=torch.int32, device=device),
        obs=torch.zeros((capacity, K, 2), **f),
        obs_valid=torch.zeros((capacity, K), dtype=torch.bool, device=device),
        vel=torch.zeros((capacity, K, 2), **f),
        tshift=torch.zeros((capacity, K), **f),
        inv_depth=torch.full((capacity,), -1.0, **f),
        lidar_flag=torch.zeros(capacity, dtype=torch.bool, device=device),
        feat_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
    )


def init_preint(imu_cap: int = 64, dtype=torch.float32, device="cuda") -> StackedPreint:
    f = dict(dtype=dtype, device=device)
    eye = torch.eye(15, **f).expand(K, 15, 15).clone()
    return StackedPreint(
        dp=torch.zeros((K, 3), **f), dq=_unit_q(K, dtype, device), dv=torch.zeros((K, 3), **f),
        jac=eye, sqrt_info=eye.clone(), dt_sum=torch.zeros((K,), **f),
        ba=torch.zeros((K, 3), **f), bg=torch.zeros((K, 3), **f),
        acc_buf=torch.zeros((K, imu_cap, 3), **f), gyr_buf=torch.zeros((K, imu_cap, 3), **f),
        dt_buf=torch.zeros((K, imu_cap - 1), **f),
        n_samples=torch.zeros((K,), dtype=torch.int32, device=device),
        valid=torch.zeros((K,), dtype=torch.bool, device=device),
    )


def init_lidar_constraints(dtype=torch.float32, device="cuda") -> LidarConstraints:
    return LidarConstraints(
        q_rel=_unit_q(K, dtype, device),
        p_rel=torch.zeros((K, 3), dtype=dtype, device=device),
        valid=torch.zeros((K,), dtype=torch.bool, device=device),
    )


def make_segment(acc, gyr, dt, n_samples, ba, bg, noise, imu_cap: int):
    """Build one StackedPreint row (a dict of tensors) from padded raw
    buffers; `n_samples` is a 0-d int32 tensor."""
    pre = imu_mod.preintegrate(acc, gyr, dt, ba, bg, noise)
    return dict(
        dp=pre.dp, dq=pre.dq, dv=pre.dv, jac=pre.jac,
        sqrt_info=imu_mod.sqrt_information(pre), dt_sum=pre.dt_sum,
        ba=ba, bg=bg, acc_buf=acc, gyr_buf=gyr, dt_buf=dt,
        n_samples=n_samples, valid=n_samples > 0,
    )


def set_row(a, i, v):
    """A copy of `a` with row i set to v (the reference's a.at[i].set(v));
    the input is never written, so views of it stay what they were."""
    out = a.clone()
    out[i] = v
    return out


def set_preint_row(pre: StackedPreint, i: int, row: dict) -> StackedPreint:
    """A copy of `pre` with slot i replaced by a make_segment row."""
    return StackedPreint(**{k: set_row(v, i, row[k]) for k, v in pre._asdict().items()})


# ---------------------------------------------------------------------------
# Tangent retraction over the whole window
# ---------------------------------------------------------------------------

def retract(state: WindowState, delta) -> WindowState:
    """Apply a D-dim tangent step (pose blocks use the reference's
    PoseLocalParameterization: p + dp, q * exp(dtheta))."""
    blocks = delta[: 15 * K].reshape(K, 15)
    q_new, p_new = lie.pose_retract((state.q, state.p), blocks[:, 0:6])  # [dp, dtheta]
    ext = delta[15 * K: 15 * K + 6]
    qic_new, tic_new = lie.pose_retract((state.qic, state.tic), ext)
    return WindowState(
        p=p_new, q=q_new,
        v=state.v + blocks[:, 6:9],
        ba=state.ba + blocks[:, 9:12],
        bg=state.bg + blocks[:, 12:15],
        tic=tic_new, qic=qic_new,
        td=state.td + delta[15 * K + 6],
    )


def local_diff(state: WindowState, ref: WindowState):
    """D-dim tangent such that ref ⊞ delta ≈ state (for the marg prior)."""
    pose_d = lie.pose_local((ref.q, ref.p), (state.q, state.p))  # (K, 6)
    blocks = torch.cat([pose_d, state.v - ref.v, state.ba - ref.ba, state.bg - ref.bg],
                       dim=-1)  # (K, 15)
    ext_d = lie.pose_local((ref.qic, ref.tic), (state.qic, state.tic))
    return torch.cat([blocks.reshape(-1), ext_d, (state.td - ref.td)[None]])
