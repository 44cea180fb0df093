"""Factor residuals for the sliding-window estimator.

Port of vil_fusion_tpu/models/factors.py (the reference's factor library):
  * IMU factor          — imu_factor.h:12-64 (15-dim, sqrt-info weighted)
  * projection-td       — projection_td_factor.{h,cpp} (2-dim reprojection
                          with time-offset velocity compensation)
  * LiDAR relative pose — lidar_factor.h:12-83 (6-dim between consecutive
                          window frames, fixed sqrt-info)
  * marginalization prior — marginalization_factor.cpp:333-381 (linear replay)

Every residual is a pure function of the window state, safe under
torch.func.vmap / jacfwd (models/ba.py takes the Jacobians that way).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vil_fusion_tpu_torch.models import imu as imu_mod
from vil_fusion_tpu_torch.models.window import WindowState, local_diff
from vil_fusion_tpu_torch.ops import lie

FOCAL_LENGTH = 460.0  # parameters.h:25
PROJ_SQRT_INFO = FOCAL_LENGTH / 1.5  # projection_factor.cpp sqrt_info

# lidar_factor.h fixed weights: translation 10, rotation 100.
LIDAR_SQRT_INFO = np.array([10.0, 10.0, 10.0, 100.0, 100.0, 100.0], dtype=np.float32)


def imu_residual(pre_row, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, gravity):
    """Weighted 15-dim preintegration residual for one window segment
    (`pre_row` a dict of one StackedPreint slot's tensors)."""
    pre = imu_mod.Preintegrated(
        dp=pre_row["dp"], dq=pre_row["dq"], dv=pre_row["dv"], jac=pre_row["jac"],
        cov=None,  # unused by residual
        dt_sum=pre_row["dt_sum"], ba=pre_row["ba"], bg=pre_row["bg"],
    )
    r = imu_mod.residual(pre, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, gravity)
    return pre_row["sqrt_info"] @ r


def projection_td_residual(xy_i, xy_j, vel_i, vel_j, inv_depth,
                           p_i, q_i, p_j, q_j, tic, qic, td,
                           tshift_i=0.0, tshift_j=0.0):
    """2-dim reprojection residual with td + rolling-shutter compensation
    (projection_td_factor.cpp:51-52: pts_td = pts - (td - td_i + TR/ROW *
    row_i) * velocity). `tshift` carries the per-observation constant part;
    zero for global-shutter rigs with constant td. Observation i is the
    anchor (start) frame holding the inverse depth."""
    xy_i_td = xy_i - (td + tshift_i) * vel_i
    xy_j_td = xy_j - (td + tshift_j) * vel_j
    pts_i = torch.cat([xy_i_td, torch.ones_like(xy_i_td[..., :1])], dim=-1)
    depth = 1.0 / torch.clamp(inv_depth, min=1e-4)
    pts_cam_i = pts_i * depth
    pts_imu_i = lie.qrot(qic, pts_cam_i) + tic
    pts_w = lie.qrot(q_i, pts_imu_i) + p_i
    pts_imu_j = lie.qrot(lie.qconj(q_j), pts_w - p_j)
    pts_cam_j = lie.qrot(lie.qconj(qic), pts_imu_j - tic)
    z_j = torch.clamp(pts_cam_j[..., 2], min=1e-4)
    r = pts_cam_j[..., :2] / z_j[..., None] - xy_j_td
    return PROJ_SQRT_INFO * r


def lidar_rel_residual(q_meas, p_meas, p_i, q_i, p_j, q_j):
    """6-dim relative-pose residual between consecutive window frames vs the
    LiDAR odometry measurement expressed in the IMU frame (lidar_factor.h:40-71).
    Order: [translation, rotation], weighted by LIDAR_SQRT_INFO."""
    q_ij = lie.qmul(lie.qconj(q_i), q_j)
    p_ij = lie.qrot(lie.qconj(q_i), p_j - p_i)
    r_t = p_ij - p_meas
    r_q = 2.0 * lie.qmul(lie.qconj(q_meas), q_ij)[..., 1:]
    w = torch.as_tensor(LIDAR_SQRT_INFO, dtype=p_i.dtype, device=p_i.device)
    return w * torch.cat([r_t, r_q], dim=-1)


class MargPrior(NamedTuple):
    """Linearized Gaussian prior left by marginalization
    (linearized_jacobians/residuals, marginalization_factor.cpp:267-297).

    r(x) = r0 + J @ local_diff(x, x_lin); rows beyond `rank` are zero.
    Pose-state part only (depths of marginalized features are eliminated)."""

    J: torch.Tensor  # (D, D)
    r0: torch.Tensor  # (D,)
    lin: WindowState  # linearization point
    valid: torch.Tensor  # () bool — prior exists


def marg_prior_residual(prior: MargPrior, state: WindowState):
    dx = local_diff(state, prior.lin)
    r = prior.r0 + prior.J @ dx
    return torch.where(prior.valid, r, torch.zeros_like(r))


def cauchy_weight(r2, c=1.0):
    """Cauchy IRLS reweight sqrt(rho'(s)) (ceres CauchyLoss(1.0) on
    projection factors, estimator.cpp:760)."""
    return 1.0 / torch.sqrt(1.0 + r2 / (c * c))


def cauchy_rho(r2, c=1.0):
    """True Cauchy robust cost rho(s) = c^2 log(1 + s/c^2), used for LM
    accept/reject: it stays sensitive for saturated residuals."""
    return c * c * torch.log1p(r2 / (c * c))
