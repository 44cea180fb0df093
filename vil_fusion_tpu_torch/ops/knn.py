"""Plain PyTorch k-nearest-neighbour search: exact and grouped-approximate.

Port of vil_fusion_tpu/ops/knn.py (the tiled exact search) plus the plain
form of the grouped merge that vil_fusion_tpu/ops/pallas/knn_pallas.py
(`_knn_kernel_grouped`) runs on the TPU. These are the CPU path of the
dispatcher in ops/cuda/knn_cuda.py and the references its CUDA kernels are
held against; the CUDA main path never calls them.

Distances use the expanded form |q|^2 + |d|^2 - 2 q.d of the deployed
kernels, evaluated elementwise in float32 in a fixed order
((x*x + y*y) + z*z, (qx*dx + qy*dy) + qz*dz, (|q|^2 + |d|^2) - 2 dot), which
is the order csrc/knn.cu rounds in: kernel and plain version give the same
bits for the same distance. Invalid database points get +inf and are never
selected. Host contract (knn_pallas.py:193-199, knn.py:86-87): rows sorted
ascending, distances clamped at >= 0, inf and index 0 for a missing
neighbour. Indices are int32.
"""
from __future__ import annotations

import torch

GROUP = 128  # columns per group of the grouped merge (the TPU's lane width)


def _sqnorm(x):
    return x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]


def _dist2(q, qn, d, dn):
    """(Nq, T) squared distances; dn is +inf for invalid columns."""
    dot = q[:, 0:1] * d[None, :, 0] + q[:, 1:2] * d[None, :, 1] + q[:, 2:3] * d[None, :, 2]
    return torch.clamp((qn[:, None] + dn[None, :]) - 2.0 * dot, min=0.0)


def _db_norms(database, db_valid):
    return torch.where(db_valid, _sqnorm(database),
                       torch.full_like(database[:, 0], float("inf")))


def _finish(best_d, best_i):
    best_i = torch.where(torch.isfinite(best_d), best_i, torch.zeros_like(best_i))
    return best_d, best_i.to(torch.int32)


def knn(queries, database, db_valid, k: int = 5, tile: int = 2048):
    """Exact k nearest database points per query, the database scanned in
    tiles of `tile` columns with a running top-k (the full (Nq, Nd) matrix
    is never built).

    Returns (dists2 (Nq, k) float32, idx (Nq, k) int32)."""
    q = queries.float()
    db = database.float()
    nq, nd = q.shape[0], db.shape[0]
    qn = _sqnorm(q)
    dn_all = _db_norms(db, db_valid)
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=q.device)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=q.device)
    for s in range(0, nd, tile):
        e = min(s + tile, nd)
        dist = _dist2(q, qn, db[s:e], dn_all[s:e])
        idx = torch.arange(s, e, device=q.device).expand(nq, e - s)
        cat_d = torch.cat([best_d, dist], dim=1)
        cat_i = torch.cat([best_i, idx], dim=1)
        best_d, arg = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, arg)
    return _finish(best_d, best_i)


def knn_grouped(queries, database, db_valid, k: int = 5, q_chunk: int = 1024):
    """Grouped approximate kNN — the semantics of the TPU's
    `_knn_kernel_grouped`: the database splits into groups of GROUP
    consecutive columns (group of column c is c // GROUP), each group keeps
    its two nearest columns, and the result is the top-k of the union of
    those candidates. Differs from the exact kNN only where more than two of
    a query's k nearest fall in one group (bounded: the slot is filled by
    the next-best candidate of another group).

    Queries are processed `q_chunk` rows at a time to bound memory."""
    q = queries.float()
    db = database.float()
    nq, nd = q.shape[0], db.shape[0]
    dev = q.device
    pad = (-nd) % GROUP
    dn = _db_norms(db, db_valid)
    if pad:
        db = torch.cat([db, torch.zeros((pad, 3), dtype=db.dtype, device=dev)])
        dn = torch.cat([dn, torch.full((pad,), float("inf"), device=dev)])
    n_groups = db.shape[0] // GROUP
    base = torch.arange(n_groups, device=dev)[:, None] * GROUP  # (G, 1)
    qn = _sqnorm(q)
    kk = min(k, 2 * n_groups)
    out_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.zeros((nq, k), dtype=torch.int64, device=dev)
    for s in range(0, nq, q_chunk):
        e = min(s + q_chunk, nq)
        dist = _dist2(q[s:e], qn[s:e], db, dn).view(e - s, n_groups, GROUP)
        g_d, g_a = torch.topk(dist, min(2, GROUP), dim=2, largest=False, sorted=True)
        cand_d = g_d.reshape(e - s, -1)
        cand_i = (g_a + base).reshape(e - s, -1)
        top_d, arg = torch.topk(cand_d, kk, dim=1, largest=False, sorted=True)
        out_d[s:e, :kk] = top_d
        out_i[s:e, :kk] = torch.gather(cand_i, 1, arg)
    return _finish(out_d, out_i)
