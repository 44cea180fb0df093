"""K3's every-row reference for the tests, in plain PyTorch (no JAX, so
that the card tests can import it too).

`lex_reference` is the sparse search of ops/knn.py written plainly with
ties to the lower index: the plain version's sorted, padded and boxed
problem (sparse_prepare) at K3's 128 x 128 tiles, every column of the near
blocks, a stable sort, then sparse_finish. The kernels order a row by
(distance, index), so they equal it on every row, indices included.
"""
import torch

from vil_fusion_tpu_torch.ops import knn as tknn


def lex_reference(q, db, v, k, radius, q_sorted, db_sorted):
    """(d2 (nq, k) float32, idx (nq, k) int32) in the caller's order."""
    prob = tknn.sparse_prepare(q, db, v, 128, 128, q_sorted=q_sorted, db_sorted=db_sorted)
    near = tknn.sparse_near(prob.q_lo, prob.q_hi, prob.d_lo, prob.d_hi, radius)
    nqp, ndp = prob.q.shape[0], prob.db.shape[0]
    dev = q.device
    dn = torch.where(prob.db_valid, torch.zeros(ndp, device=dev),
                     torch.full((ndp,), float("inf"), device=dev))
    dist = tknn._dist2(prob.q, None, prob.db, dn, "diff")
    near_rows = near[torch.arange(nqp, device=dev) // 128][:, torch.arange(ndp, device=dev) // 128]
    dist = torch.where(near_rows, dist, torch.full_like(dist, float("inf")))
    order = torch.argsort(dist, dim=1, stable=True)[:, :k]
    d, i = torch.gather(dist, 1, order), order
    if d.shape[1] < k:
        d = torch.cat([d, torch.full((nqp, k - d.shape[1]), float("inf"), device=dev)], 1)
        i = torch.cat([i, torch.zeros((nqp, k - i.shape[1]), dtype=i.dtype, device=dev)], 1)
    i = torch.where(torch.isfinite(d), i, torch.zeros_like(i))
    return tknn.sparse_finish(prob, d, i)
