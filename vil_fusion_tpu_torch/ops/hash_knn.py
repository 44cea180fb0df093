"""k-nearest-neighbour lookup in a voxel-hash table (O(1) per query).

Port of vil_fusion_tpu/ops/hash_knn.py (plain tensor code there as here; it
reaches no kernel). The LiDAR maps kept by ops/voxel.voxel_downsample_hash
are spatial hash tables: slot hash_bucket(voxel_key(p)) holds at most one
point of that voxel. kNN becomes a gather of the (2r+1)^3 neighbour buckets
per query followed by one small top-k.

Approximations against the exact kNN (all gated downstream by the
correspondence checks): candidates only within +-r voxels; a hash collision
may hide a true neighbour (a far voxel aliased into a probed bucket is
rejected by the voxel check).
"""
from __future__ import annotations

import torch

from vil_fusion_tpu_torch.ops.voxel import hash_bucket


def hash_knn(queries, table_pts, table_valid, resolution: float, origin, k: int = 5,
             radius: int = 2, grid_dim: int = 1024):
    """queries (Nq, 3); table_pts (C, 3) / table_valid (C,) the hash-table
    buffer and `origin` (3,) the origin it was built with; `radius`
    neighbour cells each side. Returns (dists2 (Nq, k), idx (Nq, k) int32)
    like ops.knn.knn (inf and index 0 = missing)."""
    C = table_pts.shape[0]
    dev = queries.device
    r = torch.arange(-radius, radius + 1, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    ijk = torch.floor((queries - origin) / resolution).to(torch.int32)
    ijk = torch.clamp(ijk, 0, grid_dim - 1)
    nb = ijk[:, None, :] + offs[None, :, :]  # (Nq, M, 3)
    in_grid = torch.all((nb >= 0) & (nb < grid_dim), dim=-1)
    key = (nb[..., 0] * grid_dim + nb[..., 1]) * grid_dim + nb[..., 2]  # int32, wraps
    slot = hash_bucket(key.reshape(-1), C).reshape(nb.shape[:2])
    cand = table_pts[slot]  # (Nq, M, 3)
    cand_ok = table_valid[slot] & in_grid
    # the candidate must lie in the probed voxel (collision check)
    cand_ijk = torch.floor((cand - origin) / resolution).to(torch.int32)
    cand_ok = cand_ok & torch.all(cand_ijk == nb, dim=-1)
    d2 = torch.sum((cand - queries[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(cand_ok, d2, torch.full_like(d2, float("inf")))
    top_d, arg = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    idx = torch.gather(slot, 1, arg)
    idx = torch.where(torch.isfinite(top_d), idx, torch.zeros_like(idx))
    return top_d, idx.to(torch.int32)
