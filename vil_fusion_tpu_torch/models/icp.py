"""Point-to-point ICP with fixed iterations (loop verification).

Port of vil_fusion_tpu/models/icp.py: exact 1-NN (K2 on the card) +
weighted Kabsch per iteration, fixed iteration count, no early exit and no
host read.
"""
from __future__ import annotations

import torch

from vil_fusion_tpu_torch.ops import lie
from vil_fusion_tpu_torch.ops.cuda import knn_cuda as knn_ops  # CUDA kernels on the card, plain on CPU


def icp_point2point(src, src_valid, tgt, tgt_valid, q_init, p_init,
                    max_corr_dist: float = 10.0, iters: int = 25):
    """Returns (q, p, fitness): transform mapping src into the tgt frame and
    the mean squared correspondence distance (inf when under 30% of the
    valid source points match)."""
    dtype = src.dtype

    def weights(d2):
        return (src_valid & torch.isfinite(d2) & (d2 < max_corr_dist**2)).to(dtype)

    q, p = q_init, p_init
    for _ in range(iters):
        src_w = lie.qrot(q, src) + p
        d2, idx = knn_ops.knn(src_w, tgt, tgt_valid, k=1)
        d2 = d2[:, 0]
        nn = tgt[idx[:, 0].to(torch.int64)]
        w = weights(d2)
        wsum = torch.clamp(torch.sum(w), min=1.0)
        # weighted Kabsch on (src_w -> nn)
        mu_s = torch.sum(src_w * w[:, None], dim=0) / wsum
        mu_t = torch.sum(nn * w[:, None], dim=0) / wsum
        X = (src_w - mu_s) * w[:, None]
        Y = nn - mu_t
        H = X.T @ Y
        U, _, Vt = torch.linalg.svd(H)
        # reflection fix: the result is independent of the SVD's sign choices
        d = torch.sign(torch.linalg.det(Vt.T @ U.T))
        S = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
        R_d = Vt.T @ S @ U.T
        t_d = mu_t - R_d @ mu_s
        q_d = lie.R2q(R_d)
        q, p = lie.qnormalize(lie.qmul(q_d, q)), lie.qrot(q_d, p) + t_d
    src_w = lie.qrot(q, src) + p
    d2, _ = knn_ops.knn(src_w, tgt, tgt_valid, k=1)
    d2 = d2[:, 0]
    w = weights(d2)
    matched = torch.clamp(torch.sum(w), min=1.0)
    fitness = torch.sum(torch.where(w > 0, d2, torch.zeros_like(d2))) / matched
    enough = torch.sum(w) > 0.3 * torch.clamp(torch.sum(src_valid), min=1)
    return q, p, torch.where(enough, fitness, torch.full_like(fitness, float("inf")))
