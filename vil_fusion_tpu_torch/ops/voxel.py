"""Fixed-capacity voxel-grid operations (downsampling, crop, compaction).

Port of vil_fusion_tpu/ops/voxel.py: every function returns a
fixed-capacity buffer plus a validity mask, the framework-wide convention
for dynamic cardinality. No function reads a device value on the host.
"""
from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1
_U32 = 0xFFFFFFFF


def compact(points, valid, capacity: int):
    """Stable-compact valid rows to the front of a fixed-capacity buffer.

    Returns (out (capacity, D), out_valid (capacity,))."""
    n = points.shape[0]
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    k = min(capacity, n)
    sel = order[:k]
    # out of place (a concatenation of the rows and zeros), so that
    # torch.func.vmap batches the function
    pad = capacity - k
    out = torch.cat([points[sel], points.new_zeros((pad,) + tuple(points.shape[1:]))])
    out_valid = torch.cat([valid[sel], valid.new_zeros((pad,))])
    return out, out_valid


def _voxel_key(points, origin, inv_res, grid_dim):
    """Quantize points into a linear voxel key within a grid_dim^3 grid."""
    ijk = torch.floor((points - origin) * inv_res).to(torch.int32)
    ijk = torch.clamp(ijk, 0, grid_dim - 1)
    return (ijk[:, 0] * grid_dim + ijk[:, 1]) * grid_dim + ijk[:, 2]


def _mul_u32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64: split c in 16-bit
    halves so no intermediate leaves int64 (x * c itself can exceed 2^63)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash_bucket(key, capacity: int):
    """Murmur3-finalizer bucket index for a linear voxel key — the uint32
    arithmetic of vil_fusion_tpu/ops/voxel.py:hash_bucket emulated in int64
    (masked to 32 bits after every step), bit-exact with it."""
    k = key.to(torch.int64) & _U32
    k = k ^ (k >> 16)
    k = _mul_u32(k, 0x85EBCA6B)
    k = k ^ (k >> 13)
    k = _mul_u32(k, 0xC2B2AE35)
    k = k ^ (k >> 16)
    return k % capacity


def voxel_downsample(points, valid, resolution: float, origin, capacity: int,
                     grid_dim: int = 1024):
    """Centroid voxel-grid downsample into a fixed-capacity buffer (exact
    centroids for up to `capacity` occupied voxels, in voxel-key order).

    Returns (out (capacity, 3), out_valid (capacity,))."""
    key = _voxel_key(points, origin, 1.0 / resolution, grid_dim)
    key = torch.where(valid, key, torch.full_like(key, _INT32_MAX))  # invalid last
    order = torch.argsort(key, stable=True)
    skey = key[order]
    spts = points[order]
    svalid = valid[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=points.device),
                       skey[1:] != skey[:-1]]) & svalid
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    rank = torch.where(svalid, rank, torch.full_like(rank, capacity))
    rank = torch.clamp(rank, max=capacity)  # voxels beyond capacity -> overflow
    seg_sum = torch.zeros((capacity + 1, 3), dtype=points.dtype, device=points.device)
    seg_sum.index_add_(0, rank, torch.where(svalid[:, None], spts, torch.zeros_like(spts)))
    seg_cnt = torch.zeros((capacity + 1,), dtype=points.dtype, device=points.device)
    seg_cnt.index_add_(0, rank, svalid.to(points.dtype))
    out = seg_sum[:capacity] / torch.clamp(seg_cnt[:capacity, None], min=1.0)
    out_valid = seg_cnt[:capacity] > 0
    out = torch.where(out_valid[:, None], out, torch.zeros_like(out))
    return out, out_valid


def voxel_downsample_hash(points, valid, resolution: float, origin,
                          capacity: int, grid_dim: int = 1024):
    """Sort-free voxel downsample: voxel key hashed into `capacity` buckets,
    one representative point per bucket — the lowest-index valid point that
    hashes there (scatter-min of the point index, then a collision-free
    scatter of the winners)."""
    n = points.shape[0]
    key = _voxel_key(points, origin, 1.0 / resolution, grid_dim)
    h = hash_bucket(key, capacity)
    tag = torch.where(valid, torch.arange(n, device=points.device),
                      torch.full((n,), _INT32_MAX, dtype=torch.int64, device=points.device))
    # out of place throughout, so that torch.func.vmap batches the function
    slot_min = torch.full((capacity,), _INT32_MAX, dtype=torch.int64, device=points.device)
    slot_min = slot_min.scatter_reduce(0, h, tag, reduce="amin", include_self=True)
    win = valid & (tag == slot_min[h])
    tgt = torch.where(win, h, torch.full_like(h, capacity))
    # winners are unique per slot; the losers' rows all land in the dropped
    # overflow slot `capacity`
    out = torch.zeros((capacity + 1, 3), dtype=points.dtype, device=points.device)
    out = out.index_put((tgt,), points)
    ov = torch.zeros((capacity + 1,), dtype=torch.bool, device=points.device)
    ov = ov.index_put((tgt,), win)
    return out[:capacity], ov[:capacity]


def merge_voxel_hash(points_a, valid_a, points_b, valid_b, resolution, origin,
                     capacity: int, grid_dim: int = 1024):
    """Union + hash voxel downsample (sort-free map update)."""
    pts = torch.cat([points_a, points_b], dim=0)
    val = torch.cat([valid_a, valid_b], dim=0)
    return voxel_downsample_hash(pts, val, resolution, origin, capacity, grid_dim)


def crop_box(points, valid, center, half_extent, capacity: int):
    """Keep points within an axis-aligned box around `center`, compacted."""
    inside = torch.all(torch.abs(points - center) <= half_extent, dim=-1) & valid
    return compact(points, inside, capacity)


def merge_voxel(points_a, valid_a, points_b, valid_b, resolution, origin,
                capacity: int, grid_dim: int = 1024):
    """Union of two point buffers followed by voxel downsample (map update)."""
    pts = torch.cat([points_a, points_b], dim=0)
    val = torch.cat([valid_a, valid_b], dim=0)
    return voxel_downsample(pts, val, resolution, origin, capacity, grid_dim)
