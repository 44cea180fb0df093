"""Plain PyTorch k-nearest-neighbour search: exact, grouped-approximate and
sparse (Morton-sorted, box-skipping).

Port of vil_fusion_tpu/ops/knn.py (the tiled exact search) plus the plain
forms of what vil_fusion_tpu/ops/pallas/knn_pallas.py runs on the TPU: the
grouped merge (`_knn_kernel_grouped`) and the sparse search
(`knn_pallas_sparse` / `_sparse_knn_kernel`, with its Morton helpers). These
are the CPU path of the dispatcher in ops/cuda/knn_cuda.py and the
references its CUDA kernels are held against; the CUDA main path calls
none of them (the sparse search's Morton keys, tile boxes, padding and
finishing step are csrc/knn.cu kernels there, the sort itself
torch.argsort).

Distance forms (`form=`), both elementwise in float32 in a fixed order that
csrc/knn.cu repeats, so kernel and plain version give the same bits:
  "expanded"  |q|^2 + |d|^2 - 2 q.d, the reference's mxu=True form:
              (x*x + y*y) + z*z, (qx*dx + qy*dy) + qz*dz,
              (|q|^2 + |d|^2) - 2 dot, clamped at 0;
  "diff"      the reference's mxu=False form (`_pair_dist2`), three squared
              differences: ((qx-dx)^2 + (qy-dy)^2) + (qz-dz)^2.
Invalid database points get +inf and are never selected. Host contract
(knn_pallas.py:193-199, :478-493, knn.py:86-87): rows sorted ascending,
distances clamped at >= 0, inf and index 0 for a missing neighbour. Indices
are int32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

GROUP = 128  # columns per group of the grouped merge (the TPU's lane width)


def _sqnorm(x):
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def _check_form(form: str):
    if form not in ("expanded", "diff"):
        raise ValueError(f"form={form!r}: expected 'expanded' or 'diff'")


def _dist2(q, qn, d, dn, form: str = "expanded"):
    """(..., Nq, T) squared distances of q (..., Nq, 3) to d (..., T, 3)
    (leading dims broadcast); dn is +inf for invalid columns."""
    if form == "diff":
        dx = q[..., :, None, 0] - d[..., None, :, 0]
        dy = q[..., :, None, 1] - d[..., None, :, 1]
        dz = q[..., :, None, 2] - d[..., None, :, 2]
        dist = dx * dx + dy * dy + dz * dz
        return torch.where(torch.isfinite(dn)[..., None, :], dist,
                           torch.full_like(dist, float("inf")))
    dot = (q[..., :, None, 0] * d[..., None, :, 0] + q[..., :, None, 1] * d[..., None, :, 1]
           + q[..., :, None, 2] * d[..., None, :, 2])
    return torch.clamp((qn[..., :, None] + dn[..., None, :]) - 2.0 * dot, min=0.0)


def _db_norms(database, db_valid):
    return torch.where(db_valid, _sqnorm(database),
                       torch.full_like(database[..., 0], float("inf")))


def _lead(queries, database):
    """The batch shape of a call: queries (*B, Nq, 3) and database
    (*B, Nd, 3), either side without B (shared by every sequence)."""
    return torch.broadcast_shapes(queries.shape[:-2], database.shape[:-2])


def _finish(best_d, best_i):
    best_i = torch.where(torch.isfinite(best_d), best_i, torch.zeros_like(best_i))
    return best_d, best_i.to(torch.int32)


def knn(queries, database, db_valid, k: int = 5, tile: int = 2048,
        form: str = "expanded"):
    """Exact k nearest database points per query, the database scanned in
    tiles of `tile` columns with a running top-k (the full (Nq, Nd) matrix
    is never built).

    Batched: queries (*B, Nq, 3), database (*B, Nd, 3) and db_valid
    (*B, Nd), a side without B shared by every sequence; row s of the
    result is bit for bit the unbatched call on sequence s.

    Returns (dists2 (*B, Nq, k) float32, idx (*B, Nq, k) int32)."""
    _check_form(form)
    q = queries.float()
    db = database.float()
    lead = _lead(q, db)
    nq, nd = q.shape[-2], db.shape[-2]
    qn = _sqnorm(q)
    dn_all = _db_norms(db, db_valid)
    best_d = torch.full(lead + (nq, k), float("inf"), dtype=torch.float32, device=q.device)
    best_i = torch.zeros(lead + (nq, k), dtype=torch.int64, device=q.device)
    for s in range(0, nd, tile):
        e = min(s + tile, nd)
        dist = _dist2(q, qn, db[..., s:e, :], dn_all[..., s:e], form)
        idx = torch.arange(s, e, device=q.device).expand(lead + (nq, e - s))
        cat_d = torch.cat([best_d, dist.expand(lead + (nq, e - s))], dim=-1)
        cat_i = torch.cat([best_i, idx], dim=-1)
        best_d, arg = torch.topk(cat_d, k, dim=-1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, -1, arg)
    return _finish(best_d, best_i)


def knn_grouped(queries, database, db_valid, k: int = 5, q_chunk: int = 1024,
                form: str = "expanded"):
    """Grouped approximate kNN — the semantics of the TPU's
    `_knn_kernel_grouped`: the database splits into groups of GROUP
    consecutive columns (group of column c is c // GROUP), each group keeps
    its two nearest columns, and the result is the top-k of the union of
    those candidates. Differs from the exact kNN only where more than two of
    a query's k nearest fall in one group (bounded: the slot is filled by
    the next-best candidate of another group).

    Queries are processed `q_chunk` rows at a time to bound memory.
    Batched as `knn`: queries (*B, Nq, 3), database (*B, Nd, 3), db_valid
    (*B, Nd), a side without B shared; rows equal the unbatched calls'."""
    _check_form(form)
    q = queries.float()
    db = database.float()
    lead = _lead(q, db)
    nq, nd = q.shape[-2], db.shape[-2]
    dev = q.device
    pad = (-nd) % GROUP
    dn = _db_norms(db, db_valid)
    if pad:
        db = torch.cat([db, torch.zeros(db.shape[:-2] + (pad, 3), dtype=db.dtype, device=dev)],
                       dim=-2)
        dn = torch.cat([dn, torch.full(dn.shape[:-1] + (pad,), float("inf"), device=dev)],
                       dim=-1)
    n_groups = db.shape[-2] // GROUP
    base = torch.arange(n_groups, device=dev)[:, None] * GROUP  # (G, 1)
    qn = _sqnorm(q)
    kk = min(k, 2 * n_groups)
    out_d = torch.full(lead + (nq, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.zeros(lead + (nq, k), dtype=torch.int64, device=dev)
    for s in range(0, nq, q_chunk):
        e = min(s + q_chunk, nq)
        dist = _dist2(q[..., s:e, :], qn[..., s:e], db, dn, form)
        dist = dist.expand(lead + dist.shape[-2:]).reshape(lead + (e - s, n_groups, GROUP))
        g_d, g_a = torch.topk(dist, min(2, GROUP), dim=-1, largest=False, sorted=True)
        cand_d = g_d.reshape(lead + (e - s, -1))
        cand_i = (g_a + base).reshape(lead + (e - s, -1))
        top_d, arg = torch.topk(cand_d, kk, dim=-1, largest=False, sorted=True)
        out_d[..., s:e, :kk] = top_d
        out_i[..., s:e, :kk] = torch.gather(cand_i, -1, arg)
    return _finish(out_d, out_i)


# ---------------------------------------------------------------------------
# Sparse search: Morton order, tile boxes, block skipping
# ---------------------------------------------------------------------------

def _spread3(x):
    """Interleave the low 10 bits of x with two zero bits (Morton helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_keys(pts, origin, cell: float):
    """30-bit 3-D Morton code per point (1024 cells/axis of size `cell`)."""
    c = torch.clamp(((pts - origin) / cell).to(torch.int32), 0, 1023)
    return _spread3(c[:, 0]) | (_spread3(c[:, 1]) << 1) | (_spread3(c[:, 2]) << 2)


def morton_keys(pts, valid=None, cell: float = 2.0):
    """The keys `morton_sort` sorts by (int32): `_morton_keys` from the
    least valid point minus 1e-3, and 0x7FFFFFFF for an invalid point
    (knn_pallas.py:379-391)."""
    p32 = pts.float()
    if p32.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=p32.device)
    inf = torch.full_like(p32, float("inf"))
    finite = p32 if valid is None else torch.where(valid[:, None], p32, inf)
    origin = torch.min(finite, dim=0).values - 1e-3
    keys = _morton_keys(p32, origin, cell)
    if valid is not None:
        keys = torch.where(valid, keys, torch.full_like(keys, 0x7FFFFFFF))
    return keys


def morton_sort(pts, valid=None, cell: float = 2.0):
    """Spatial (Morton) sort permutation (int64, stable); invalid points
    sort to the end. Callers may sort once and reuse the order across
    several searches: rigid motion keeps the tiles compact."""
    return torch.argsort(morton_keys(pts, valid, cell), stable=True)


def _tile_aabb(pts, valid, tile: int):
    """Per-tile bounding box (lo, hi), each (n_tiles, 3), of the valid
    points; a tile without valid points has the box (+inf, -inf)."""
    t = pts.reshape(-1, tile, 3)
    v = valid.reshape(-1, tile, 1)
    inf = torch.full_like(t, float("inf"))
    lo = torch.min(torch.where(v, t, inf), dim=1).values
    hi = torch.max(torch.where(v, t, -inf), dim=1).values
    return lo, hi


def sparse_near(q_lo, q_hi, d_lo, d_hi, radius: float):
    """(n_q_tiles, n_db_tiles) bool: the gap between the two tiles' boxes is
    within `radius`. Per axis max(dlo - qhi, qlo - dhi, 0), squared and
    summed in x, y, z order, compared `<= radius^2` in float32: the
    arithmetic of knn_pallas.py:306-311, which csrc/knn.cu repeats."""
    g = torch.clamp(torch.maximum(d_lo[None, :, :] - q_hi[:, None, :],
                                  q_lo[:, None, :] - d_hi[None, :, :]), min=0.0)
    d2box = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
    return d2box <= float(radius) ** 2


class SparseProblem(NamedTuple):
    """A sparse search laid out for the tiles: both sides in Morton order
    and padded to whole tiles, with the tiles' boxes and the permutations
    that lead back to the caller's order (None where the caller sorted)."""
    q: torch.Tensor  # (n_q_tiles * q_tile, 3)
    db: torch.Tensor  # (n_db_tiles * db_tile, 3)
    db_valid: torch.Tensor
    q_lo: torch.Tensor
    q_hi: torch.Tensor
    d_lo: torch.Tensor
    d_hi: torch.Tensor
    q_perm: Optional[torch.Tensor]
    d_perm: Optional[torch.Tensor]
    nq: int


def sparse_prepare(queries, database, db_valid, q_tile: int, db_tile: int,
                   cell: float = 2.0, q_sorted: bool = False,
                   db_sorted: bool = False) -> SparseProblem:
    """Sort (unless the caller did), pad and box both sides
    (knn_pallas.py:415-443). Queries are padded with the last sorted point
    so the pad tile stays compact; the database with invalid zeros."""
    q32, db32 = queries.float(), database.float()
    nq, nd = q32.shape[0], db32.shape[0]
    q_perm = d_perm = None
    if not q_sorted:
        q_perm = morton_sort(q32, cell=cell)
        q32 = q32[q_perm]
    if not db_sorted:
        d_perm = morton_sort(db32, db_valid, cell=cell)
        db32, db_valid = db32[d_perm], db_valid[d_perm]
    pad_q, pad_d = (-nq) % q_tile, (-nd) % db_tile
    if pad_q:
        q32 = torch.cat([q32, q32[-1:].expand(pad_q, 3)])
    if pad_d:
        db32 = torch.cat([db32, db32.new_zeros((pad_d, 3))])
        db_valid = torch.cat([db_valid, db_valid.new_zeros(pad_d)])
    q_lo, q_hi = _tile_aabb(q32, torch.ones_like(q32[:, 0], dtype=torch.bool), q_tile)
    d_lo, d_hi = _tile_aabb(db32, db_valid, db_tile)
    return SparseProblem(q32.contiguous(), db32.contiguous(), db_valid.contiguous(),
                         q_lo.contiguous(), q_hi.contiguous(), d_lo.contiguous(),
                         d_hi.contiguous(), q_perm, d_perm, nq)


def sparse_finish(prob: SparseProblem, out_d, out_i):
    """Rows of the tiled problem (ascending, indices into the sorted
    database) back to the caller's order (knn_pallas.py:478-493)."""
    out_i = out_i.to(torch.int64)
    if prob.q_perm is not None:
        inv = torch.empty_like(prob.q_perm)
        inv[prob.q_perm] = torch.arange(prob.nq, device=inv.device)
        out_d, out_i = out_d[inv], out_i[inv]
    else:
        out_d, out_i = out_d[:prob.nq], out_i[:prob.nq]
    if prob.d_perm is not None:
        out_i = prob.d_perm[out_i]
    return _finish(torch.clamp(out_d, min=0.0), out_i)


def sparse_search_plain(prob: SparseProblem, k: int, radius: float, q_tile: int,
                        db_tile: int, scan: int = 2048):
    """Exact top-k over the (query tile, db tile) blocks that pass
    `sparse_near`; a skipped block contributes +inf. Difference-form
    distances. Returns rows of the tiled problem (ascending, sorted-database
    indices, index 0 where missing). `scan` columns are scored at a time."""
    q, db = prob.q, prob.db
    nqp, ndp = q.shape[0], db.shape[0]
    dev = q.device
    near = sparse_near(prob.q_lo, prob.q_hi, prob.d_lo, prob.d_hi, radius)
    near_rows = near[torch.arange(nqp, device=dev) // q_tile]  # (rows, n_db_tiles)
    dn = torch.where(prob.db_valid, torch.zeros_like(db[:, 0]),
                     torch.full_like(db[:, 0], float("inf")))
    best_d = torch.full((nqp, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.zeros((nqp, k), dtype=torch.int64, device=dev)
    step = max(db_tile, scan // db_tile * db_tile)
    for s in range(0, ndp, step):
        e = min(s + step, ndp)
        cols = torch.arange(s, e, device=dev)
        dist = _dist2(q, None, db[s:e], dn[s:e], "diff")
        block_near = near_rows[:, cols // db_tile]
        dist = torch.where(block_near, dist, torch.full_like(dist, float("inf")))
        cat_d = torch.cat([best_d, dist], dim=1)
        cat_i = torch.cat([best_i, cols.expand(nqp, e - s)], dim=1)
        best_d, arg = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, arg)
    best_i = torch.where(torch.isfinite(best_d), best_i, torch.zeros_like(best_i))
    return best_d, best_i


def knn_sparse(queries, database, db_valid, k: int = 5, radius: float = 3.0,
               q_tile: int = 128, db_tile: int = 128, cell: float = 2.0,
               q_sorted: bool = False, db_sorted: bool = False):
    """Plain version of the sparse kNN (the reference's `knn_pallas_sparse`
    with its deployed mxu=False, unpacked merge): exact for every neighbour
    within `radius`; farther ones may be missing (+inf), so callers gate on
    d2 < radius^2. Same tiles and skip rule as the CUDA kernel, hence equal
    to it on every row, not only inside the radius. Correctness never
    depends on the sort; only the share of skipped blocks does.

    Returns (dists2 (Nq, k) float32, idx (Nq, k) int32) in the caller's
    order (of the given order where q_sorted / db_sorted)."""
    prob = sparse_prepare(queries, database, db_valid, q_tile, db_tile, cell,
                          q_sorted, db_sorted)
    out_d, out_i = sparse_search_plain(prob, k, radius, q_tile, db_tile)
    return sparse_finish(prob, out_d, out_i)
