"""LiDAR edge/planar feature extraction as range-image tensor ops.

Port of vil_fusion_tpu/models/lidar_features.py (F-LOAM-style extractor):
per-ring azimuth ordering becomes a fixed (n_scan, width) polar range image,
the 11-point curvature circular-shift sums along azimuth, and per-sector
max-curvature picking windowed NMS + top-k per sector. Static shapes; no
host reads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vil_fusion_tpu_torch.ops import voxel as voxel_ops

_INT32_MAX = 2**31 - 1


class LidarConfig(NamedTuple):
    n_scan: int = 64
    width: int = 1800  # azimuth bins (0.2 deg)
    n_sectors: int = 6
    min_range: float = 3.0  # blind radius
    max_range: float = 90.0
    fov_up_deg: float = 2.0  # generic linear ring model (HDL-64: +2 .. -24.8)
    fov_down_deg: float = -24.8
    edge_per_sector: int = 4  # top-k edges per (ring, sector) after NMS
    edge_curv_min: float = 0.1
    surf_curv_max: float = 0.05
    nms_window: int = 11  # neighbor suppression span (5 each side)
    edge_cap: int = 2048
    surf_cap: int = 8192
    surf_voxel: float = 0.4


class LidarFeatures(NamedTuple):
    edge: torch.Tensor  # (edge_cap, 3)
    edge_valid: torch.Tensor  # (edge_cap,)
    surf: torch.Tensor  # (surf_cap, 3)
    surf_valid: torch.Tensor  # (surf_cap,)


def project_range_image(points, valid, cfg: LidarConfig):
    """Bucket a raw scan into a (n_scan, width) polar image; the nearest
    point wins each cell.

    Deviation from the JAX reference, which resolves points within 1e-3 m of
    a cell's nearest range "arbitrarily" (a scatter with duplicate targets):
    here the lowest point index among them wins, so CUDA and CPU runs agree.

    Returns (img_xyz (S, W, 3), img_valid (S, W))."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.linalg.norm(points, dim=-1)
    valid = valid & (r > cfg.min_range) & (r < cfg.max_range)
    va = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    ring_f = (cfg.fov_up_deg - va) / (cfg.fov_up_deg - cfg.fov_down_deg) * (cfg.n_scan - 1)
    ring = torch.round(ring_f).to(torch.int64)
    valid = valid & (ring >= 0) & (ring < cfg.n_scan)
    az = torch.atan2(y, x)  # [-pi, pi)
    col = torch.floor((az + math.pi) / (2 * math.pi) * cfg.width).to(torch.int64)
    col = torch.clamp(col, 0, cfg.width - 1)
    n_cells = cfg.n_scan * cfg.width
    cell = torch.where(valid, ring * cfg.width + col, torch.full_like(ring, n_cells))

    img_r = torch.full((n_cells + 1,), 1e9, dtype=points.dtype, device=points.device)
    img_r.scatter_reduce_(0, cell, torch.where(valid, r, torch.full_like(r, 1e9)),
                          reduce="amin", include_self=True)
    win = valid & (r <= img_r[cell] + 1e-3)
    # deterministic tie-break: lowest point index among the cell's winners
    n = points.shape[0]
    tag = torch.where(win, torch.arange(n, device=points.device),
                      torch.full((n,), _INT32_MAX, dtype=torch.int64, device=points.device))
    first = torch.full((n_cells + 1,), _INT32_MAX, dtype=torch.int64, device=points.device)
    first.scatter_reduce_(0, cell, tag, reduce="amin", include_self=True)
    pick = win & (tag == first[cell])
    tgt = torch.where(pick, cell, torch.full_like(cell, n_cells))
    img_xyz = torch.zeros((n_cells + 1, 3), dtype=points.dtype, device=points.device)
    img_xyz[tgt] = points
    img_valid = torch.zeros((n_cells + 1,), dtype=torch.bool, device=points.device)
    img_valid[tgt] = pick
    return (img_xyz[:-1].reshape(cfg.n_scan, cfg.width, 3),
            img_valid[:-1].reshape(cfg.n_scan, cfg.width))


def curvature_image(img_xyz, img_valid, cfg: LidarConfig):
    """11-point curvature along azimuth, circular (360 deg scans), with LOAM
    occlusion and grazing-incidence rejection.

    curv = |sum_{j in +-5, j != 0} (p_j - p_0)|^2, valid only where all 10
    neighbors exist; -1 where invalid."""
    half = (cfg.nms_window - 1) // 2
    acc = torch.zeros_like(img_xyz)
    all_valid = img_valid
    for j in range(1, half + 1):
        for s in (j, -j):
            acc = acc + torch.roll(img_xyz, s, dims=1)
            all_valid = all_valid & torch.roll(img_valid, s, dims=1)
    acc = acc - (2 * half) * img_xyz
    curv = torch.sum(acc * acc, dim=-1)

    # occlusion rejection: far side of a range discontinuity
    r = torch.linalg.norm(img_xyz, dim=-1)
    r_next = torch.roll(r, -1, dims=1)
    r_prev = torch.roll(r, 1, dims=1)
    pair_next = img_valid & torch.roll(img_valid, -1, dims=1)
    pair_prev = img_valid & torch.roll(img_valid, 1, dims=1)
    disc_far_right = pair_next & (r - r_next > 0.5)
    disc_far_left = pair_prev & (r - r_prev > 0.5)
    occluded = torch.zeros_like(img_valid)
    for j in range(half + 1):
        occluded = occluded | torch.roll(disc_far_right, -j, dims=1)
        occluded = occluded | torch.roll(disc_far_left, j, dims=1)
    # parallel-beam (grazing incidence) rejection
    grazing = (pair_next & pair_prev
               & (torch.abs(r_next - r) > 0.02 * r)
               & (torch.abs(r_prev - r) > 0.02 * r))
    all_valid = all_valid & ~occluded & ~grazing
    return torch.where(all_valid, curv, torch.full_like(curv, -1.0)), all_valid


def extract_features(points, valid, cfg: LidarConfig = LidarConfig()) -> LidarFeatures:
    """Full extraction: range image -> curvature -> sector top-k edges + surf."""
    img_xyz, img_valid = project_range_image(points, valid, cfg)
    curv, curv_valid = curvature_image(img_xyz, img_valid, cfg)

    # edges: windowed NMS then per-sector top-k
    half = (cfg.nms_window - 1) // 2
    pooled = curv
    for j in range(1, half + 1):
        pooled = torch.maximum(pooled, torch.maximum(torch.roll(curv, j, 1),
                                                     torch.roll(curv, -j, 1)))
    is_peak = (curv >= pooled) & (curv > cfg.edge_curv_min) & curv_valid
    edge_score = torch.where(is_peak, curv, torch.full_like(curv, -1.0))
    sector_w = cfg.width // cfg.n_sectors
    es = edge_score[:, : sector_w * cfg.n_sectors].reshape(cfg.n_scan, cfg.n_sectors, sector_w)
    # lax.top_k order: descending, ties to the lower index (a stable sort)
    top_v, top_i = torch.sort(es, dim=-1, descending=True, stable=True)
    top_v = top_v[..., : cfg.edge_per_sector]
    top_i = top_i[..., : cfg.edge_per_sector]
    sec_base = torch.arange(cfg.n_sectors, device=points.device)[None, :, None] * sector_w
    cols = top_i + sec_base
    rows = torch.arange(cfg.n_scan, device=points.device)[:, None, None].expand_as(cols)
    edge_pts = img_xyz[rows.reshape(-1), cols.reshape(-1)]
    edge_ok = (top_v > 0).reshape(-1)
    edge, edge_valid = voxel_ops.compact(edge_pts, edge_ok, cfg.edge_cap)

    # planar: low-curvature cells, hash voxel-downsampled to capacity
    surf_mask = curv_valid & (curv >= 0) & (curv < cfg.surf_curv_max) & ~is_peak
    flat_pts = img_xyz.reshape(-1, 3)
    flat_ok = surf_mask.reshape(-1)
    origin = torch.full((3,), -200.0, dtype=points.dtype, device=points.device)
    surf, surf_valid = voxel_ops.voxel_downsample_hash(
        flat_pts, flat_ok, cfg.surf_voxel, origin, cfg.surf_cap)
    return LidarFeatures(edge, edge_valid, surf, surf_valid)
