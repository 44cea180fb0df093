"""ScanContext place recognition, tensorized.

Port of vil_fusion_tpu/models/scancontext.py: 20 rings x 60 sectors max-z
polar descriptor, ring-key candidate gate over the whole database (dense
distances instead of a kd-tree) and an all-60-shift columnwise-cosine
search against the candidates.

The database is updated in place (`add_keyframe` writes the slot at
`count` and bumps `count`, all on the device with no host read) and the
same ScanContextDB is returned; `with_keyframe` makes the updated copy.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

N_RING = 20
N_SECTOR = 60
MAX_RADIUS = 80.0
SC_DIST_THRES = 0.2
NUM_EXCLUDE_RECENT = 30
NUM_CANDIDATES = 10  # ring-key candidates


class ScanContextDB(NamedTuple):
    desc: torch.Tensor  # (C, N_RING, N_SECTOR)
    ring_key: torch.Tensor  # (C, N_RING)
    count: torch.Tensor  # () int32


def init_db(capacity: int = 4096, dtype=torch.float32, device="cuda") -> ScanContextDB:
    return ScanContextDB(
        desc=torch.zeros((capacity, N_RING, N_SECTOR), dtype=dtype, device=device),
        ring_key=torch.zeros((capacity, N_RING), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_descriptor(points, valid):
    """(N, 3) body-frame scan -> (N_RING, N_SECTOR) max-height image
    (+2 m sensor-height offset)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y)
    az = torch.atan2(y, x)
    ring = torch.floor(r / MAX_RADIUS * N_RING).to(torch.int64)
    sector = torch.floor((az + math.pi) / (2 * math.pi) * N_SECTOR).to(torch.int64)
    sector = torch.clamp(sector, 0, N_SECTOR - 1)
    ok = valid & (r > 0.1) & (r < MAX_RADIUS) & (ring >= 0) & (ring < N_RING)
    cell = torch.where(ok, ring * N_SECTOR + sector, torch.full_like(ring, N_RING * N_SECTOR))
    img = torch.zeros((N_RING * N_SECTOR + 1,), dtype=points.dtype, device=points.device)
    img.scatter_reduce_(0, cell, torch.where(ok, z + 2.0, torch.zeros_like(z)),
                        reduce="amax", include_self=True)
    return img[:-1].reshape(N_RING, N_SECTOR)


def ring_key(desc):
    return torch.mean(desc, dim=-1)


def _insert_slot(db: ScanContextDB, desc):
    """(whether the DB has room, the slot (1,) int64, the row to write): a
    full DB writes its last row again."""
    cap = db.desc.shape[0]
    ok = db.count < cap
    i = torch.clamp(db.count, max=cap - 1).to(torch.int64).reshape(1)
    return ok, i, torch.where(ok, desc, db.desc.index_select(0, i)[0])


def add_keyframe(db: ScanContextDB, desc) -> ScanContextDB:
    """Insert at `count` in place; a full DB drops the insert (clamping the
    index while growing `count` would leave the current query in the last
    slot and defeat the recency exclusion)."""
    ok, i, desc_w = _insert_slot(db, desc)
    db.desc.index_copy_(0, i, desc_w[None])
    db.ring_key.index_copy_(0, i, ring_key(desc_w)[None])
    db.count.add_(ok.to(db.count.dtype))
    return db


def with_keyframe(db: ScanContextDB, desc) -> ScanContextDB:
    """A new ScanContextDB: `db` after add_keyframe(db, desc), which is
    left as it is."""
    ok, i, desc_w = _insert_slot(db, desc)
    return ScanContextDB(desc=db.desc.index_copy(0, i, desc_w[None]),
                         ring_key=db.ring_key.index_copy(0, i, ring_key(desc_w)[None]),
                         count=db.count + ok.to(db.count.dtype))


def detect_loop(db: ScanContextDB, query):
    """Returns (best_idx, best_dist, best_shift_sectors) as device scalars.

    Ring-key candidate gate -> all-shift columnwise-cosine distance -> min
    over candidates, excluding the NUM_EXCLUDE_RECENT most recent keyframes;
    the caller applies the SC_DIST_THRES acceptance gate. Candidate ties
    (the +inf of unusable slots) go to the lower index, as lax.top_k does."""
    idx = torch.arange(db.desc.shape[0], device=query.device)
    return best_candidate(db.desc, db.ring_key, idx < db.count - NUM_EXCLUDE_RECENT, query)


def best_candidate(desc, ring_keys, usable, query):
    """The search of `detect_loop` over the rows `desc` / `ring_keys` with
    the mask `usable`: (row, distance, shift) of the best of the
    NUM_CANDIDATES (or fewer, if there are fewer rows) nearest ring keys.
    parallel/sharded_sc.py runs it on a rank's rows."""
    qk = ring_key(query)
    rk_d = torch.linalg.norm(ring_keys - qk[None, :], dim=-1)
    rk_d = torch.where(usable, rk_d, torch.full_like(rk_d, float("inf")))
    srt, order = torch.sort(rk_d, stable=True)
    cand = order[:NUM_CANDIDATES]
    cand_ok = torch.isfinite(srt[:NUM_CANDIDATES])

    shifts = torch.stack([torch.roll(query, s, dims=1) for s in range(N_SECTOR)])  # (S, R, W)
    cand_desc = desc[cand]  # (Ncand, R, W)
    num = torch.einsum("crw,srw->csw", cand_desc, shifts)
    cn = torch.linalg.norm(cand_desc, dim=1)  # (Ncand, W)
    qn = torch.linalg.norm(shifts, dim=1)  # (S, W)
    denom = cn[:, None, :] * qn[None, :, :]
    col_ok = denom > 1e-6
    cos = torch.where(col_ok, num / torch.clamp(denom, min=1e-6), torch.zeros_like(num))
    n_cols = torch.clamp(torch.sum(col_ok, dim=-1), min=1)
    dist = 1.0 - torch.sum(cos, dim=-1) / n_cols  # (Ncand, S)
    dist_min, shift_arg = torch.min(dist, dim=-1)
    dist_min = torch.where(cand_ok, dist_min, torch.full_like(dist_min, float("inf")))
    b = torch.argmin(dist_min).reshape(1)  # read by index_select: x[b] reads b on the host
    return (cand.index_select(0, b)[0], dist_min.index_select(0, b)[0],
            shift_arg.index_select(0, b)[0])


def shift_to_yaw(shift):
    """Sector shift -> initial yaw estimate for ICP."""
    return shift.to(torch.float32) * (2.0 * math.pi / N_SECTOR)
