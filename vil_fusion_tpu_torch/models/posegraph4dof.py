"""4-DoF pose graph (yaw + xyz; pitch/roll fixed from VIO).

Port of vil_fusion_tpu/models/posegraph4dof.py (the reference's visual-loop
pose graph, pose_graph.cpp optimize4DoF :406-582 with FourDOFError /
FourDOFWeightError, pose_graph.h:161-250): sequential edges to up to 4
back-neighbours plus loop edges, yaw as the only rotational freedom, the
drift (yaw + t) of a solve applied to later frames.

Batched Gauss-Newton with a block-Jacobi PCG over (x, y, z, yaw) per node,
as the reference. Its `fori_loop`s are host loops with every step on the
device (no host read); the vmapped `jax.jacfwd` of the 8-dim edge residual
is written out analytically; `.at[].add` is `index_add`, which sums in
atomic order on CUDA. `add_node` / `add_loop` return a new graph and leave
their input unchanged, so a graph taken before a solve stays valid for
`drift_transform`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vil_fusion_tpu_torch.ops import lie

SEQ_NEIGHBORS = 4  # sequential edges span (pose_graph.cpp:436-470)


class PoseGraph4DoF(NamedTuple):
    p: torch.Tensor  # (N, 3) positions
    yaw: torch.Tensor  # (N,) radians
    pitch: torch.Tensor  # (N,) fixed (from VIO)
    roll: torch.Tensor  # (N,)
    seq: torch.Tensor  # (N,) int32 session id: sequential edges never cross it
    # immutable VIO poses at insertion: the sequential edges' measurements
    vio_p: torch.Tensor  # (N, 3)
    vio_yaw: torch.Tensor  # (N,)
    n_nodes: torch.Tensor  # () int32
    loop_i: torch.Tensor  # (L,) int32
    loop_j: torch.Tensor
    loop_t: torch.Tensor  # (L, 3) relative translation in frame i
    loop_yaw: torch.Tensor  # (L,) relative yaw
    loop_valid: torch.Tensor
    n_loops: torch.Tensor


def init_graph(capacity: int = 4096, loop_capacity: int = 256, dtype=torch.float32,
               device="cuda") -> PoseGraph4DoF:
    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    i32 = dict(dtype=torch.int32, device=device)
    return PoseGraph4DoF(
        p=z(capacity, 3), yaw=z(capacity), pitch=z(capacity), roll=z(capacity),
        seq=torch.zeros((capacity,), **i32), vio_p=z(capacity, 3), vio_yaw=z(capacity),
        n_nodes=torch.zeros((), **i32),
        loop_i=torch.zeros((loop_capacity,), **i32), loop_j=torch.zeros((loop_capacity,), **i32),
        loop_t=z(loop_capacity, 3), loop_yaw=z(loop_capacity),
        loop_valid=torch.zeros((loop_capacity,), dtype=torch.bool, device=device),
        n_loops=torch.zeros((), **i32))


def _slot(counter, cap):
    return torch.clamp(counter, max=cap - 1).to(torch.int64).reshape(1)


def _put(a, i, v):
    """a with row i (a 1-element index tensor) replaced by v (out of place)."""
    return a.index_copy(0, i, torch.as_tensor(v, dtype=a.dtype, device=a.device).reshape(
        (1,) + a.shape[1:]))


def add_node(graph: PoseGraph4DoF, p, yaw, pitch, roll, seq: int = 0) -> PoseGraph4DoF:
    """Append a node: `p` / `yaw` are both its initial state and its VIO
    measurement pose (callers insert raw VIO keyframe poses)."""
    i = _slot(graph.n_nodes, graph.p.shape[0])
    return graph._replace(
        p=_put(graph.p, i, p), yaw=_put(graph.yaw, i, yaw), pitch=_put(graph.pitch, i, pitch),
        roll=_put(graph.roll, i, roll), seq=_put(graph.seq, i, seq),
        vio_p=_put(graph.vio_p, i, p), vio_yaw=_put(graph.vio_yaw, i, yaw),
        n_nodes=graph.n_nodes + 1)


def add_loop(graph: PoseGraph4DoF, i, j, t_rel, yaw_rel) -> PoseGraph4DoF:
    """Append a loop edge from node i to node j."""
    k = _slot(graph.n_loops, graph.loop_i.shape[0])
    return graph._replace(
        loop_i=_put(graph.loop_i, k, i), loop_j=_put(graph.loop_j, k, j),
        loop_t=_put(graph.loop_t, k, t_rel), loop_yaw=_put(graph.loop_yaw, k, yaw_rel),
        loop_valid=_put(graph.loop_valid, k, True), n_loops=graph.n_loops + 1)


def _R_ypr(yaw, pitch, roll):
    ypr = torch.stack([yaw, pitch, roll], dim=-1) * (180.0 / math.pi)
    return lie.ypr2R(ypr)


def _edge_residual_jacobian(p_i, yaw_i, pr_i, p_j, yaw_j, t_m, yaw_m):
    """FourDOFError (pose_graph.h:161-199) of E edges and its Jacobian in
    (p_i, yaw_i, p_j, yaw_j): the translation in node i's full rotation (yaw
    free, pitch / roll fixed) minus the measurement, and the wrapped yaw
    difference. Returns r (E, 4), J (E, 4, 8)."""
    R_i = _R_ypr(yaw_i, pr_i[:, 0], pr_i[:, 1])
    d = p_j - p_i
    RT = R_i.transpose(1, 2)
    r_t = torch.einsum("eij,ej->ei", RT, d) - t_m
    r_y = torch.remainder(yaw_j - yaw_i - yaw_m + math.pi, 2 * math.pi) - math.pi
    # dR/dyaw = dRz/dyaw Ry Rx = G R with G = [[0, -1, 0], [1, 0, 0], [0, 0, 0]]
    # (Rz' = G Rz), so d(R^T d)/dyaw = R^T G^T d with G^T d = (d_y, -d_x, 0)
    gd = torch.stack([d[:, 1], -d[:, 0], torch.zeros_like(d[:, 0])], dim=-1)
    dyaw_i = torch.einsum("eij,ej->ei", RT, gd)
    J_t = torch.cat([-RT, dyaw_i[:, :, None], RT, torch.zeros_like(dyaw_i[:, :, None])], dim=2)
    J_y = torch.tensor([0.0, 0, 0, -1, 0, 0, 0, 1], dtype=p_i.dtype, device=p_i.device)
    J = torch.cat([J_t, J_y.expand(p_i.shape[0], 1, 8)], dim=1)
    return torch.cat([r_t, r_y[:, None]], dim=-1), J


# VINS-Mono semantics (pose_graph.h FourDOFError): translation residual in
# metres with unit weight, yaw residual divided by 10 degrees -> 5.73 / rad
SEQ_W = np.array([1.0, 1.0, 1.0, 5.73], np.float32)
LOOP_W = np.array([1.0, 1.0, 1.0, 5.73], np.float32)
PRIOR_W = 1e4


def _guard(x):
    """x where |x| > 1e-12, else 1e-12 (the reference's division guard)."""
    return torch.where(torch.abs(x) > 1e-12, x, torch.full_like(x, 1e-12))


def optimize(graph: PoseGraph4DoF, gn_iters: int = 10, cg_iters: int = 64,
             lm_lambda: float = 0.02) -> PoseGraph4DoF:
    """optimize4DoF :406-582: sequential 4-neighbour edges + loop edges,
    batched GN + block-Jacobi PCG over (x, y, z, yaw) per node, annealed
    Huber on the loop edges, LM damping relative to the block diagonal.
    Returns a new graph with the solved p and yaw."""
    N = graph.p.shape[0]
    dtype, dev = graph.p.dtype, graph.p.device
    active = (torch.arange(N, device=dev) < graph.n_nodes).to(dtype)[:, None]

    # sequential edges (i, i + k), k = 1..SEQ_NEIGHBORS, measured from the
    # immutable insert-time VIO poses
    idx = torch.arange(N, device=dev)
    seq_i = idx.repeat(SEQ_NEIGHBORS)
    seq_j = torch.cat([torch.clamp(idx + k, max=N - 1) for k in range(1, SEQ_NEIGHBORS + 1)])
    seq_valid = ((seq_j < graph.n_nodes) & (seq_j > seq_i)
                 & (graph.seq[seq_i] == graph.seq[seq_j]))
    R_i0 = _R_ypr(graph.vio_yaw[seq_i], graph.pitch[seq_i], graph.roll[seq_i])
    seq_t = torch.einsum("nji,nj->ni", R_i0, graph.vio_p[seq_j] - graph.vio_p[seq_i])
    seq_yaw = graph.vio_yaw[seq_j] - graph.vio_yaw[seq_i]

    ei = torch.cat([seq_i, graph.loop_i.to(torch.int64)])
    ej = torch.cat([seq_j, graph.loop_j.to(torch.int64)])
    t_m = torch.cat([seq_t, graph.loop_t])
    yaw_m = torch.cat([seq_yaw, graph.loop_yaw])
    loop_ok = graph.loop_valid & (graph.loop_j < graph.n_nodes)
    valid = torch.cat([seq_valid, loop_ok]).to(dtype)[:, None]
    n_seq = seq_i.shape[0]
    w = torch.cat([torch.as_tensor(SEQ_W, device=dev).expand(n_seq, 4),
                   torch.as_tensor(LOOP_W, device=dev).expand(graph.loop_i.shape[0], 4)]).to(dtype)
    is_loop = torch.arange(ei.shape[0], device=dev) >= n_seq
    pr = torch.stack([graph.pitch, graph.roll], dim=-1)
    eye4 = torch.eye(4, dtype=dtype, device=dev)

    def scatter(rows_i, rows_j):
        """Per-node sums of per-edge blocks at the edges' i and j nodes."""
        out = torch.zeros((N,) + rows_i.shape[1:], dtype=dtype, device=dev)
        return out.index_add(0, ei, rows_i).index_add(0, ej, rows_j)

    p, yaw = graph.p, graph.yaw
    for it in range(gn_iters):
        r, J = _edge_residual_jacobian(p[ei], yaw[ei], pr[ei], p[ej], yaw[ej], t_m, yaw_m)
        # annealed Huber on loop edges (FourDOFWeightError)
        rn = torch.sqrt(torch.sum((w * r) ** 2, dim=-1) + 1e-12)
        delta_h = max(4.0, 1e4 * float(np.float32(0.1) ** np.float32(it)))
        rob = torch.where(is_loop & (rn > delta_h), delta_h / rn, torch.ones_like(rn))
        wr = w * rob[:, None] * valid
        r = r * wr
        J = J * wr[:, :, None]

        JTr = torch.einsum("erd,er->ed", J, r)
        b = -scatter(JTr[:, :4], JTr[:, 4:])
        prior_r = torch.cat([p[0] - graph.p[0], (yaw[0] - graph.yaw[0])[None]])
        b = b.index_add(0, idx[:1], (-PRIOR_W * prior_r)[None])

        Ji, Jj = J[:, :, :4], J[:, :, 4:]
        Pblk = scatter(torch.einsum("erd,erc->edc", Ji, Ji), torch.einsum("erd,erc->edc", Jj, Jj))
        Pblk = Pblk.index_add(0, idx[:1], (PRIOR_W * eye4)[None])
        # LM damping relative to the block diagonal: undamped GN oscillates
        # on long chains through the yaw-translation coupling
        diag_damp = lm_lambda * torch.diagonal(Pblk, dim1=1, dim2=2)
        Pblk = Pblk + torch.diag_embed(diag_damp) + 1e-4 * eye4
        Pinv = torch.linalg.inv_ex(Pblk)[0]

        def matvec(v):
            ve = torch.cat([v[ei], v[ej]], dim=-1)
            u = torch.einsum("erd,ed->er", J, ve)
            JTu = torch.einsum("erd,er->ed", J, u)
            out = scatter(JTu[:, :4], JTu[:, 4:])
            out = out.index_add(0, idx[:1], PRIOR_W * v[:1])
            out = out + diag_damp * v  # LM damping (matches the preconditioner)
            return (out + 1e-6 * v) * active

        def apply_P(v):
            return torch.einsum("nde,ne->nd", Pinv, v) * active

        x = torch.zeros((N, 4), dtype=dtype, device=dev)
        r_cg = b * active
        z_cg = apply_P(r_cg)
        pdir = z_cg
        rz = torch.sum(r_cg * z_cg)
        for _ in range(cg_iters):
            Ap = matvec(pdir)
            alpha = rz / _guard(torch.sum(pdir * Ap))
            x = x + alpha * pdir
            r_cg = r_cg - alpha * Ap
            z_new = apply_P(r_cg)
            rz_new = torch.sum(r_cg * z_new)
            beta = rz_new / _guard(rz)
            pdir = z_new + beta * pdir
            rz = rz_new
        x = torch.clamp(x, -2.0, 2.0) * active
        p, yaw = p + x[:, :3], yaw + x[:, 3]
    return graph._replace(p=p, yaw=yaw)


def drift_transform(graph_before: PoseGraph4DoF, graph_after: PoseGraph4DoF, node: int):
    """(yaw_drift, R, t_drift) applied to frames after the optimized span
    (pose_graph.cpp:552-574), as device tensors."""
    dyaw = graph_after.yaw[node] - graph_before.yaw[node]
    zero = torch.zeros_like(dyaw)
    R = _R_ypr(dyaw, zero, zero)
    dt = graph_after.p[node] - R @ graph_before.p[node]
    return dyaw, R, dt
