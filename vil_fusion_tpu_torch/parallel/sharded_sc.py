"""Multi-device ScanContext retrieval: database rows sharded over the mesh.

Port of vil_fusion_tpu/parallel/sharded_sc.py. Each rank scores the
(replicated) query against the ring-key candidates among its block of
descriptors across all 60 shifts; the global best is an argmin over the
all_gathered (size, 3) rows of the ranks' bests: O(1) traffic a query
against an arbitrarily large place-recognition database.
"""
import torch

from vil_fusion_tpu_torch.models import scancontext as sc
from vil_fusion_tpu_torch.parallel.mesh import Mesh, all_gather, shard_rows


def detect_loop_sharded(mesh: Mesh, db: sc.ScanContextDB, query):
    """db.desc / db.ring_key replicated on every rank (capacity divisible by
    the mesh size), each rank searching its rows; db.count replicated.
    Returns (best_idx, best_dist, best_shift) as device scalars, the same on
    every rank. A rank's candidates are its own rows under the global
    recency exclusion; ties between ranks go to the lowest rank, as
    jnp.argmin keeps the first."""
    shard = db.desc.shape[0] // mesh.size
    base = mesh.rank * shard
    desc_loc, rk_loc = shard_rows(mesh, db.desc), shard_rows(mesh, db.ring_key)
    idx = torch.arange(shard, device=query.device) + base
    cand, dist, shift = sc.best_candidate(desc_loc, rk_loc,
                                          idx < db.count - sc.NUM_EXCLUDE_RECENT, query)
    loc_best = torch.stack([dist, (cand + base).to(torch.float32), shift.to(torch.float32)])
    allb = all_gather(mesh, loc_best)  # (size, 3)
    w = torch.argmin(allb[:, 0])
    return allb[w, 1].to(torch.int32), allb[w, 0], allb[w, 2].to(torch.int32)
