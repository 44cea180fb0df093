"""Multi-device kNN: LiDAR map points sharded over the mesh.

Port of vil_fusion_tpu/parallel/sharded_knn.py. Each rank computes an exact
local top-k of the (replicated) queries against its block of the map (K2,
`knn_cuda.knn`, on the card); the global top-k is a k-wide all_gather and a
merge. Traffic per query is O(k) instead of O(map).
"""
import torch

from vil_fusion_tpu_torch.ops.cuda import knn_cuda as knn_ops
from vil_fusion_tpu_torch.parallel.mesh import Mesh, all_gather, shard_rows


def knn_sharded(mesh: Mesh, queries, database, db_valid, k: int = 5, tile: int = 2048):
    """queries (Nq, 3), database (Nd, 3) and db_valid (Nd,) replicated on
    every rank; each rank searches its rows of the database (`shard_rows`).

    Returns (dists2 (Nq, k), global_idx (Nq, k) int32), the same on every
    rank. The merge is a stable sort of the shard-major concatenation of
    the ranks' lists, so ties keep the lower rank, as lax.top_k keeps the
    lower position; a missing neighbour keeps its shard's base index, as in
    the reference."""
    n_shard = database.shape[0] // mesh.size
    db_loc, valid_loc = shard_rows(mesh, database), shard_rows(mesh, db_valid)
    d2, idx = knn_ops.knn(queries, db_loc, valid_loc, k=k, tile=min(tile, n_shard))
    gidx = idx + mesh.rank * n_shard
    nq = queries.shape[0]
    # (size, Nq, k) -> (Nq, size k), shard-major
    d2_cat = all_gather(mesh, d2).permute(1, 0, 2).reshape(nq, -1)
    gi_cat = all_gather(mesh, gidx).permute(1, 0, 2).reshape(nq, -1)
    srt, arg = torch.sort(d2_cat, dim=1, stable=True)
    return srt[:, :k].contiguous(), torch.gather(gi_cat, 1, arg[:, :k])
