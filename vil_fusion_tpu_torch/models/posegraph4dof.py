"""4-DoF pose graph (yaw + xyz; pitch/roll fixed from VIO).

Port of vil_fusion_tpu/models/posegraph4dof.py (the reference's visual-loop
pose graph, pose_graph.cpp optimize4DoF :406-582 with FourDOFError /
FourDOFWeightError, pose_graph.h:161-250): sequential edges to up to 4
back-neighbours plus loop edges, yaw as the only rotational freedom, the
drift (yaw + t) of a solve applied to later frames.

Batched Gauss-Newton with a block-Jacobi PCG over (x, y, z, yaw) per node,
as the reference. Its `fori_loop`s are host loops with every step on the
device (no host read), captured on the card as one CUDA graph
(`utils/graphs.step`, the reference's jit); the vmapped `jax.jacfwd` of the
8-dim edge residual is written out analytically; `.at[].add` is a sum in a
fixed order (`_optimize_body`). `add_node` / `add_loop` return a new graph
and leave their input unchanged, so a graph taken before a solve stays
valid for `drift_transform`.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from vil_fusion_tpu_torch.ops import lie
from vil_fusion_tpu_torch.utils import graphs
from vil_fusion_tpu_torch.utils.graphs import host_constant

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
    J_y = host_constant((0.0, 0, 0, -1, 0, 0, 0, 1), p_i.dtype, p_i.device)
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


@functools.lru_cache(maxsize=None)
def _seq_edges(n: int):
    """The sequential edges of an n-node graph, (i, i + k) for k = 1..4 (j
    clamped to n - 1, as the reference), as host arrays: seq_i, seq_j, and
    the (n, D) table of the rows that sum into each node, where the rows
    are the edges' i-side blocks, then their j-side blocks, then a zero row
    (index 2 E) that pads the table: a node's i-side rows first, in edge
    order, then its j-side rows."""
    idx = np.arange(n)
    seq_i = np.tile(idx, SEQ_NEIGHBORS)
    seq_j = np.concatenate([np.minimum(idx + k, n - 1) for k in range(1, SEQ_NEIGHBORS + 1)])
    E = seq_i.shape[0]
    rows = [[] for _ in range(n)]
    for e, i in enumerate(seq_i):
        rows[i].append(e)
    for e, j in enumerate(seq_j):
        rows[j].append(E + e)
    table = np.full((n, max(len(r) for r in rows)), 2 * E, np.int64)
    for i, r in enumerate(rows):
        table[i, :len(r)] = r
    return seq_i, seq_j, table


def optimize(graph: PoseGraph4DoF, gn_iters: int = 10, cg_iters: int = 64,
             lm_lambda: float = 0.02) -> PoseGraph4DoF:
    """optimize4DoF :406-582: sequential 4-neighbour edges + loop edges,
    batched GN + block-Jacobi PCG over (x, y, z, yaw) per node, annealed
    Huber on the loop edges, LM damping relative to the block diagonal.
    Returns a new graph with the solved p and yaw. On the card one graph
    replay ("posegraph4dof_optimize", keyed on the iteration counts, the
    damping and the graph's capacities), the reference's jit with static
    gn_iters / cg_iters / lm_lambda. No lock is taken for its capture: its
    callers (the pipeline's visual-loop steps) hold the pipeline's step
    lock."""
    if graphs.use_graph(graph.p):
        body = functools.partial(_optimize_body, gn_iters=gn_iters, cg_iters=cg_iters,
                                 lm_lambda=lm_lambda)
        p, yaw = graphs.step("posegraph4dof_optimize", body, (graph,),
                             static=(gn_iters, cg_iters, float(lm_lambda)))
    else:
        p, yaw = _optimize_body(graph, gn_iters, cg_iters, lm_lambda)
    return graph._replace(p=p, yaw=yaw)


def _optimize_body(graph: PoseGraph4DoF, gn_iters: int, cg_iters: int, lm_lambda: float):
    """optimize's solved (p, yaw): reads nothing on the host and copies no
    host data to the device (its index tables and constants are
    `host_constant`s). The per-node sums of edge blocks are in a fixed
    order (a table gather for the sequential edges, a one-hot product for
    the loop edges) where the reference scatters with `.at[].add`: an
    index_add on the card sums in atomic order, and a replay would not be
    bit for bit its body."""
    N, L = graph.p.shape[0], graph.loop_i.shape[0]
    dtype, dev = graph.p.dtype, graph.p.device
    seq_i_np, seq_j_np, table_np = _seq_edges(N)
    n_seq = seq_i_np.shape[0]
    idx = host_constant(np.arange(N), torch.int64, dev)
    active = (idx < graph.n_nodes).to(dtype)[:, None]

    # sequential edges (i, i + k), k = 1..SEQ_NEIGHBORS, measured from the
    # immutable insert-time VIO poses
    seq_i = host_constant(seq_i_np, torch.int64, dev)
    seq_j = host_constant(seq_j_np, torch.int64, dev)
    table = host_constant(table_np, torch.int64, dev)
    seq_valid = ((seq_j < graph.n_nodes) & (seq_j > seq_i)
                 & (graph.seq[seq_i] == graph.seq[seq_j]))
    R_i0 = _R_ypr(graph.vio_yaw[seq_i], graph.pitch[seq_i], graph.roll[seq_i])
    seq_t = torch.einsum("nji,nj->ni", R_i0, graph.vio_p[seq_j] - graph.vio_p[seq_i])
    seq_yaw = graph.vio_yaw[seq_j] - graph.vio_yaw[seq_i]

    loop_i, loop_j = graph.loop_i.to(torch.int64), graph.loop_j.to(torch.int64)
    ei = torch.cat([seq_i, loop_i])
    ej = torch.cat([seq_j, loop_j])
    t_m = torch.cat([seq_t, graph.loop_t])
    yaw_m = torch.cat([seq_yaw, graph.loop_yaw])
    loop_ok = graph.loop_valid & (graph.loop_j < graph.n_nodes)
    valid = torch.cat([seq_valid, loop_ok]).to(dtype)[:, None]
    w = torch.cat([host_constant(SEQ_W, dtype, dev).expand(n_seq, 4),
                   host_constant(LOOP_W, dtype, dev).expand(L, 4)])
    is_loop = host_constant(np.arange(n_seq + L) >= n_seq, torch.bool, dev)
    pr = torch.stack([graph.pitch, graph.roll], dim=-1)
    eye4 = host_constant(np.eye(4), dtype, dev)
    # (N, L) one-hots of the loop edges' nodes
    onehot_i = (loop_i[None, :] == idx[:, None]).to(dtype)
    onehot_j = (loop_j[None, :] == idx[:, None]).to(dtype)

    def scatter(rows_i, rows_j):
        """Per-node sums of per-edge blocks at the edges' i and j nodes."""
        tail = rows_i.shape[1:]
        flat_i, flat_j = rows_i.reshape(rows_i.shape[0], -1), rows_j.reshape(rows_j.shape[0], -1)
        stacked = torch.cat([flat_i[:n_seq], flat_j[:n_seq], torch.zeros_like(flat_i[:1])])
        out = stacked[table].sum(dim=1)
        out = out + onehot_i @ flat_i[n_seq:] + onehot_j @ flat_j[n_seq:]
        return out.reshape((N,) + tail)

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
        b = torch.cat([b[:1] - PRIOR_W * prior_r[None], b[1:]])

        Ji, Jj = J[:, :, :4], J[:, :, 4:]
        Pblk = scatter(torch.einsum("erd,erc->edc", Ji, Ji), torch.einsum("erd,erc->edc", Jj, Jj))
        Pblk = torch.cat([Pblk[:1] + PRIOR_W * eye4[None], Pblk[1:]])
        # LM damping relative to the block diagonal: undamped GN oscillates
        # on long chains through the yaw-translation coupling
        diag_damp = lm_lambda * torch.diagonal(Pblk, dim1=1, dim2=2)
        Pblk = Pblk + torch.diag_embed(diag_damp) + 1e-4 * eye4
        Pinv = torch.linalg.inv_ex(Pblk)[0]  # no error check: no host read

        def matvec(v):
            ve = torch.cat([v[ei], v[ej]], dim=-1)
            u = torch.einsum("erd,ed->er", J, ve)
            JTu = torch.einsum("erd,er->ed", J, u)
            out = scatter(JTu[:, :4], JTu[:, 4:])
            out = torch.cat([out[:1] + PRIOR_W * v[:1], out[1:]])
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
    return p, yaw


def drift_transform(graph_before: PoseGraph4DoF, graph_after: PoseGraph4DoF, node: int):
    """(yaw_drift, R, t_drift) applied to frames after the optimized span
    (pose_graph.cpp:552-574), as device tensors."""
    dyaw = graph_after.yaw[node] - graph_before.yaw[node]
    zero = torch.zeros_like(dyaw)
    R = _R_ypr(dyaw, zero, zero)
    dt = graph_after.p[node] - R @ graph_before.p[node]
    return dyaw, R, dt
