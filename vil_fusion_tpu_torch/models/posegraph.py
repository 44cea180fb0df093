"""SE(3) pose-graph optimization: batched GN + block-Jacobi PCG.

Port of vil_fusion_tpu/models/posegraph.py: a full batched Gauss-Newton
relinearization per update, H·v computed edge-wise (gather -> per-edge
12-dim matvec -> scatter-add), solved by PCG with a 6x6 block-Jacobi
preconditioner. Edge Jacobians come from `torch.func.vmap(jacfwd(...))` of
the residual, like the reference's `vmap(jacfwd(...))`.

`add_node` / `add_loop` write their slot in place (index from the device
counters, no host read) and return the same PoseGraph; `optimize` returns
a new one. Scatter-adds are `index_add_`, which sums in atomic order on
CUDA: results differ from the CPU's in the last bits.
"""
from __future__ import annotations

from typing import NamedTuple

import functools

import numpy as np
import torch
from torch.func import jacfwd, vmap

from vil_fusion_tpu_torch.ops import lie
from vil_fusion_tpu_torch.utils import graphs
from vil_fusion_tpu_torch.utils.graphs import host_constant


class PoseGraph(NamedTuple):
    q: torch.Tensor  # (N, 4) node rotations
    p: torch.Tensor  # (N, 3)
    n_nodes: torch.Tensor  # () int32
    odo_q: torch.Tensor  # (N, 4) T_{i-1 -> i} measurement (slot i)
    odo_p: torch.Tensor  # (N, 3)
    loop_i: torch.Tensor  # (L,) int32
    loop_j: torch.Tensor  # (L,)
    loop_q: torch.Tensor  # (L, 4) T_{i -> j} measurement
    loop_p: torch.Tensor  # (L, 3)
    loop_valid: torch.Tensor  # (L,)
    n_loops: torch.Tensor  # () int32


def _qid(n, dtype, device):
    q = torch.zeros((n, 4), dtype=dtype, device=device)
    q[:, 0] = 1.0
    return q


def init_graph(capacity: int = 4096, loop_capacity: int = 512, dtype=torch.float32,
               device="cuda") -> PoseGraph:
    return PoseGraph(
        q=_qid(capacity, dtype, device), p=torch.zeros((capacity, 3), dtype=dtype, device=device),
        n_nodes=torch.zeros((), dtype=torch.int32, device=device),
        odo_q=_qid(capacity, dtype, device),
        odo_p=torch.zeros((capacity, 3), dtype=dtype, device=device),
        loop_i=torch.zeros((loop_capacity,), dtype=torch.int32, device=device),
        loop_j=torch.zeros((loop_capacity,), dtype=torch.int32, device=device),
        loop_q=_qid(loop_capacity, dtype, device),
        loop_p=torch.zeros((loop_capacity, 3), dtype=dtype, device=device),
        loop_valid=torch.zeros((loop_capacity,), dtype=torch.bool, device=device),
        n_loops=torch.zeros((), dtype=torch.int32, device=device),
    )


def _slot(counter, cap):
    return torch.clamp(counter, max=cap - 1).to(torch.int64).reshape(1)


def add_node(graph: PoseGraph, q_abs, p_abs, q_rel, p_rel) -> PoseGraph:
    """Append a node with its absolute initial pose and the odometry edge
    from the previous node (in place)."""
    i = _slot(graph.n_nodes, graph.q.shape[0])
    graph.q.index_copy_(0, i, q_abs.reshape(1, 4))
    graph.p.index_copy_(0, i, p_abs.reshape(1, 3))
    graph.odo_q.index_copy_(0, i, q_rel.reshape(1, 4))
    graph.odo_p.index_copy_(0, i, p_rel.reshape(1, 3))
    graph.n_nodes.add_(1)
    return graph


def add_loop(graph: PoseGraph, i: int, j: int, q_rel, p_rel) -> PoseGraph:
    """Append a loop edge T_{i -> j} (in place; `i`, `j` host ints)."""
    k = _slot(graph.n_loops, graph.loop_i.shape[0])
    graph.loop_i.index_fill_(0, k, int(i))  # host ints: a fill, no upload
    graph.loop_j.index_fill_(0, k, int(j))
    graph.loop_q.index_copy_(0, k, q_rel.reshape(1, 4))
    graph.loop_p.index_copy_(0, k, p_rel.reshape(1, 3))
    graph.loop_valid.index_fill_(0, k, True)
    graph.n_loops.add_(1)
    return graph


def _edge_residual(delta12, q_i, p_i, q_j, p_j, q_m, p_m):
    """6-dim between-factor residual with retraction deltas (12)."""
    qi, pi = lie.pose_retract((q_i, p_i), delta12[:6])
    qj, pj = lie.pose_retract((q_j, p_j), delta12[6:])
    r_t = lie.qrot(lie.qconj(qi), pj - pi) - p_m
    r_q = 2.0 * lie.qmul(lie.qconj(q_m), lie.qmul(lie.qconj(qi), qj))[1:]
    return torch.cat([r_t, r_q])


# Default sqrt-information [trans(3), rot(3)] (the reference's calibration).
ODO_W = np.array([20.0, 20.0, 20.0, 200.0, 200.0, 200.0], np.float32)
LOOP_W = np.array([20.0, 20.0, 20.0, 50.0, 50.0, 50.0], np.float32)
PRIOR_W = 1e4


def _gather_edges(graph: PoseGraph, q, p):
    """(ei, ej, q_m, p_m, w (E, 6), valid (E,)) for odometry + loop edges."""
    N = q.shape[0]
    dev, dtype = p.device, p.dtype
    idx = torch.arange(N, device=dev)
    odo_valid = (idx >= 1) & (idx < graph.n_nodes)
    ei = torch.cat([idx - 1, graph.loop_i.to(torch.int64)])
    ej = torch.cat([idx, graph.loop_j.to(torch.int64)])
    q_m = torch.cat([graph.odo_q, graph.loop_q])
    p_m = torch.cat([graph.odo_p, graph.loop_p])
    loop_ok = graph.loop_valid & (graph.loop_i < graph.n_nodes) & (graph.loop_j < graph.n_nodes)
    valid = torch.cat([odo_valid, loop_ok])
    L = graph.loop_i.shape[0]
    w = torch.cat([host_constant(ODO_W, dtype, dev).expand(N, 6),
                   host_constant(LOOP_W, dtype, dev).expand(L, 6)])
    ei = torch.clamp(ei, min=0)
    return ei, ej, q_m, p_m, w, valid


_edge_jacobian = vmap(jacfwd(_edge_residual))
_edge_residual_v = vmap(_edge_residual)


def optimize(graph: PoseGraph, gn_iters: int = 6, cg_iters: int = 32,
             capture_lock=None) -> PoseGraph:
    """Batched GN over all nodes (the isamUpdate replacement). On the card
    one graph replay ("posegraph_optimize", keyed on the iteration counts and
    the graph's shapes: one key a bucket of optimize_bucketed, captured with
    `capture_lock` held), the reference's jit with static gn_iters /
    cg_iters."""
    if graphs.use_graph(graph.p):
        body = functools.partial(_optimize_body, gn_iters=gn_iters, cg_iters=cg_iters)
        q, p = graphs.step("posegraph_optimize", body, (graph,), static=(gn_iters, cg_iters),
                           lock=capture_lock)
    else:
        q, p = _optimize_body(graph, gn_iters, cg_iters)
    return graph._replace(q=q, p=p)


def _optimize_body(graph: PoseGraph, gn_iters: int, cg_iters: int):
    """optimize's (q, p), eagerly."""
    N = graph.q.shape[0]
    dtype, dev = graph.p.dtype, graph.p.device
    node_active = (torch.arange(N, device=dev) < graph.n_nodes).to(dtype)[:, None]
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    q, p = graph.q, graph.p
    for it in range(gn_iters):
        ei, ej, q_m, p_m, w, valid = _gather_edges(graph, q, p)
        z = torch.zeros((ei.shape[0], 12), dtype=dtype, device=dev)
        args = (z, q[ei], p[ei], q[ej], p[ej], q_m, p_m)
        r = _edge_residual_v(*args)  # (E, 6)
        J = _edge_jacobian(*args)  # (E, 6, 12)
        # annealed Huber on loop edges: quadratic first, robust later
        is_loop = torch.arange(r.shape[0], device=dev) >= N
        rn = torch.sqrt(torch.sum((w * r) ** 2, dim=-1) + 1e-12)
        delta_h = max(4.0, 1e4 * 0.1 ** it)
        rob = torch.where(is_loop & (rn > delta_h), delta_h / rn, torch.ones_like(rn))
        wr = w * rob[:, None] * valid[:, None].to(dtype)
        r = r * wr
        J = J * wr[:, :, None]

        # gradient b = -sum J^T r, scattered to nodes
        JTr = torch.einsum("erd,er->ed", J, r)
        b = torch.zeros((N, 6), dtype=dtype, device=dev)
        b.index_add_(0, ei, -JTr[:, :6])
        b.index_add_(0, ej, -JTr[:, 6:])
        d0 = lie.pose_local((graph.q[0], graph.p[0]), (q[0], p[0]))
        b[0] -= PRIOR_W * d0

        # block-Jacobi preconditioner: 6x6 per node
        JTJ_ii = torch.einsum("erd,erc->edc", J[:, :, :6], J[:, :, :6])
        JTJ_jj = torch.einsum("erd,erc->edc", J[:, :, 6:], J[:, :, 6:])
        Pblk = torch.zeros((N, 6, 6), dtype=dtype, device=dev)
        Pblk.index_add_(0, ei, JTJ_ii)
        Pblk.index_add_(0, ej, JTJ_jj)
        Pblk[0] += PRIOR_W * eye6
        Pblk = Pblk + 1e-4 * eye6
        Pinv = torch.linalg.inv_ex(Pblk).inverse  # no error check: no host sync

        def matvec(v):
            ve = torch.cat([v[ei], v[ej]], dim=-1)  # (E, 12)
            u = torch.einsum("erd,ed->er", J, ve)
            JTu = torch.einsum("erd,er->ed", J, u)
            out = torch.zeros((N, 6), dtype=dtype, device=dev)
            out.index_add_(0, ei, JTu[:, :6])
            out.index_add_(0, ej, JTu[:, 6:])
            out[0] += PRIOR_W * v[0]
            out = out + 1e-6 * v  # tiny damping for disconnected nodes
            return out * node_active

        def apply_P(v):
            return torch.einsum("nde,ne->nd", Pinv, v) * node_active

        # PCG
        x = torch.zeros((N, 6), dtype=dtype, device=dev)
        r_cg = b * node_active
        z_cg = apply_P(r_cg)
        pdir = z_cg
        rz = torch.sum(r_cg * z_cg)
        for _ in range(cg_iters):
            Ap = matvec(pdir)
            denom = torch.sum(pdir * Ap)
            alpha = rz / torch.where(torch.abs(denom) > 1e-12, denom, torch.full_like(denom, 1e-12))
            x = x + alpha * pdir
            r_new = r_cg - alpha * Ap
            z_new = apply_P(r_new)
            rz_new = torch.sum(r_new * z_new)
            beta = rz_new / torch.where(torch.abs(rz) > 1e-12, rz, torch.full_like(rz, 1e-12))
            pdir = z_new + beta * pdir
            r_cg, rz = r_new, rz_new
        x = torch.clamp(x, -1.0, 1.0)
        q, p = lie.pose_retract((q, p), x * node_active)
    return q, p


def optimize_bucketed(graph: PoseGraph, n_active: int, gn_iters: int = 6,
                      cg_iters: int = 32, min_bucket: int = 64,
                      capture_lock=None) -> PoseGraph:
    """optimize() on the smallest power-of-2 node slice covering the active
    nodes: GN/PCG cost is linear in the node capacity, so a 50-keyframe
    graph is not solved inside a 2048-slot buffer. `n_active` is the
    host-side node count (reading graph.n_nodes would synchronise)."""
    cap = graph.q.shape[0]
    bucket = min_bucket
    while bucket < min(n_active, cap):
        bucket *= 2
    if bucket >= cap:
        return optimize(graph, gn_iters, cg_iters, capture_lock)
    sub = graph._replace(q=graph.q[:bucket], p=graph.p[:bucket],
                         odo_q=graph.odo_q[:bucket], odo_p=graph.odo_p[:bucket])
    out = optimize(sub, gn_iters, cg_iters, capture_lock)
    q = graph.q.clone()
    p = graph.p.clone()
    q[:bucket] = out.q
    p[:bucket] = out.p
    return graph._replace(q=q, p=p)
