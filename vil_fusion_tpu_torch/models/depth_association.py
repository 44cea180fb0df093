"""LiDAR-to-visual feature depth association on the unit sphere.

Port of vil_fusion_tpu/models/depth_association.py (the reference's
`getFeatureDepth`): project the FOV-filtered LiDAR cloud (already in the
camera frame) and the visual features onto the unit sphere, find each
feature's 3 nearest cloud points (the kNN dispatcher: K2, the exact CUDA
kNN, on the card), intersect the feature's view ray with the 3-point plane,
and gate the result like the reference:
  * reject if the 3 NN ranges spread more than 2 m
  * clamp the intersection depth into [min, max] NN range
  * require signed ray scale s > 0.5 and depth > 2 m
"""
from __future__ import annotations

import torch

from vil_fusion_tpu_torch.ops.cuda import knn_cuda as knn_ops  # CUDA kernels on the card, plain on CPU

# minimum |cos| between the view ray and the 3-NN plane normal (~6 deg off
# the surface plane); see the grazing-incidence classification below
MIN_INCIDENCE = 0.1


def feature_depth(feat_xy, feat_valid, cloud_cam, cloud_valid, min_incidence=None):
    """feat_xy (N, 2) normalized-plane feature coords, cloud_cam (M, 3)
    LiDAR points in the camera frame; min_incidence: strong/weak threshold
    (rig knob; None = module default).

    Returns (depth (N,), ok (N,)): z-depth along the optical axis, positive
    for a STRONG (steep-incidence) depth, negated for a WEAK (grazing) one,
    which only initializes the inverse depth downstream; -1 where invalid."""
    # FOV filter: points in front of the camera within ~52 deg half-angle
    z = cloud_cam[:, 2]
    ok_pt = cloud_valid & (z > 0.3)
    safe_z = torch.where(ok_pt, z, torch.ones_like(z))
    xz = cloud_cam[:, 0] / safe_z
    yz = cloud_cam[:, 1] / safe_z
    ok_pt = ok_pt & (torch.abs(xz) < 1.3) & (torch.abs(yz) < 1.3)

    rng = torch.linalg.norm(cloud_cam, dim=-1)
    sphere_pts = cloud_cam / torch.clamp(rng, min=1e-6)[:, None]

    rays = torch.cat([feat_xy, torch.ones_like(feat_xy[:, :1])], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)

    d2, idx = knn_ops.knn(rays.contiguous(), sphere_pts.contiguous(), ok_pt, k=3)
    idx = idx.to(torch.int64)
    found = torch.isfinite(d2).all(dim=-1) & feat_valid
    nn = cloud_cam[idx]  # (N, 3, 3) actual 3D points
    nn_rng = rng[idx]  # (N, 3)
    rng_min = torch.min(nn_rng, dim=-1).values
    rng_max = torch.max(nn_rng, dim=-1).values

    # range-spread gate (2 m)
    spread_ok = (rng_max - rng_min) < 2.0

    # ray-plane intersection: s such that s*ray lies on the plane of the 3 NN
    v1 = nn[:, 1] - nn[:, 0]
    v2 = nn[:, 2] - nn[:, 0]
    n = torch.linalg.cross(v1, v2, dim=-1)
    denom = torch.einsum("ni,ni->n", n, rays)
    s = torch.einsum("ni,ni->n", n, nn[:, 0]) / torch.where(
        torch.abs(denom) > 1e-6, denom, torch.full_like(denom, 1e-6))
    s_ok = s > 0.5

    # grazing-incidence classification: along view rays < ~6 deg off the
    # local surface plane the depth error is range_noise / sin(incidence)
    # and the NN-band clamp below then underestimates depth systematically.
    # STRONG depths are returned positive (held constant in BA downstream);
    # WEAK ones negated (inverse-depth initialization only).
    if min_incidence is None:
        min_incidence = MIN_INCIDENCE
    n_norm = torch.linalg.norm(n, dim=-1)
    incidence = torch.abs(denom) / torch.clamp(n_norm, min=1e-9)
    strong = incidence > min_incidence

    # clamp into the NN range band
    s = torch.minimum(torch.maximum(s, rng_min), rng_max)
    depth = s * rays[:, 2]  # z-depth along the optical axis
    ok = found & spread_ok & s_ok & (depth > 2.0)  # min-depth gate
    signed = torch.where(strong, depth, -depth)  # weak < -2; sentinel is -1
    return torch.where(ok, signed, torch.full_like(signed, -1.0)), ok
