"""Global fusion: keyframe gating + ScanContext loops + ICP + pose graph.

Port of vil_fusion_tpu/models/global_fusion.py. One host loop: every
keyframe appends a graph node, inserts its ScanContext descriptor and
queries for a loop; accepted candidates run ICP verification against a
submap and a pose-graph relaxation. Keyframe clouds live in a
fixed-capacity device store.

Loop queries and ICP verdicts are read back asynchronously: their scalars
are copied into pinned host memory with non_blocking copies behind a
recorded CUDA event, and resolved only once `event.query()` says they have
landed — a keyframe never waits for the device to drain (the reference's
loop-detection and ICP workers are asynchronous to graph building too).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from vil_fusion_tpu_torch.models import icp as icp_mod
from vil_fusion_tpu_torch.models import posegraph as pg
from vil_fusion_tpu_torch.models import scancontext as sc
from vil_fusion_tpu_torch.ops import lie


class _HostCopy:
    """Asynchronous device -> host copy of a few tensors. On CUDA the copy
    goes to pinned memory behind an event; on the CPU it is immediate."""

    def __init__(self, *tensors):
        self._event = None
        if tensors[0].is_cuda:
            self.values = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                           for t in tensors]
            for h, t in zip(self.values, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self.values = [t.clone() for t in tensors]

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        return self.values


def _linspace_idx(n: int, cap: int, device):
    """Cloud subsample indices floor(j (n - 1) / (cap - 1)), j < cap, in exact
    integer arithmetic. The reference's float32 jnp.linspace(...).astype
    rounds a few of them one lower (3 of 2048 at n = 115,200)."""
    j = torch.arange(cap, dtype=torch.int64, device=device)
    return (j * (n - 1)) // max(cap - 1, 1)


def _keyframe_program(graph, db, clouds, cloud_valid, q_prev_kf, p_prev_kf,
                      q_dev, p_dev, pts, val, i: int, first: bool):
    """The keyframe hot path: odometry-edge glue + graph node append +
    ScanContext insert/detect + cloud subsample/store. `i` is the host
    keyframe index. Graph, database and cloud store are updated in place."""
    if first:
        q_rel = torch.tensor([1.0, 0, 0, 0], dtype=clouds.dtype, device=clouds.device)
        p_rel = torch.zeros(3, dtype=clouds.dtype, device=clouds.device)
        q_abs, p_abs = q_dev, p_dev
    else:
        q_rel, p_rel = lie.pose_between((q_prev_kf, p_prev_kf), (q_dev, p_dev))
        q_abs, p_abs = lie.pose_compose((graph.q[i - 1], graph.p[i - 1]), (q_rel, p_rel))
    graph = pg.add_node(graph, q_abs, p_abs, q_rel, p_rel)
    desc = sc.make_descriptor(pts, val)
    db = sc.add_keyframe(db, desc)
    cand, dist, shift = sc.detect_loop(db, desc)
    idx = _linspace_idx(pts.shape[0], clouds.shape[1], pts.device)
    clouds[i] = pts[idx]
    cloud_valid[i] = val[idx]
    return graph, db, clouds, cloud_valid, cand, dist, shift


def _submap_icp(qs, ps, clouds, cloud_valid, ks, dup, i: int, j: int, yaw0: float):
    """Submap assembly around keyframe j + ICP verification of keyframe i.
    `ks` is the fixed-length clamped index span around j; `dup` masks
    clamp-duplicated entries."""
    q_j, p_j = qs[j], ps[j]
    q_rel, p_rel = lie.pose_between((q_j, p_j), (qs[ks], ps[ks]))  # (K, 4), (K, 3)
    tgt = (lie.qrot(q_rel[:, None, :], clouds[ks]) + p_rel[:, None, :]).reshape(-1, 3)
    tgtv = (cloud_valid[ks] & ~dup[:, None]).reshape(-1)

    # two initial guesses, keep the better fit: (a) the graph relative pose;
    # (b) the same translation with the yaw replaced by the SC shift estimate
    q0, p0 = lie.pose_between((q_j, p_j), (qs[i], ps[i]))
    yaw_q0 = lie.R2ypr(lie.q2R(q0))[0] * (math.pi / 180.0)
    yaw0_t = torch.as_tensor(yaw0, dtype=qs.dtype, device=qs.device)
    z = torch.zeros_like(yaw0_t)
    q_corr = lie.so3_exp(torch.stack([z, z, yaw0_t - yaw_q0]))
    q0b = lie.qnormalize(lie.qmul(q_corr, q0))

    src, srcv = clouds[i], cloud_valid[i]
    qa, pa, fa = icp_mod.icp_point2point(src, srcv, tgt, tgtv, q0, p0)
    qb, pb, fb = icp_mod.icp_point2point(src, srcv, tgt, tgtv, q0b, p0)
    pick_a = fa <= fb
    return (torch.where(pick_a, qa, qb), torch.where(pick_a, pa, pb),
            torch.minimum(fa, fb))


class GlobalFusionConfig(NamedTuple):
    keyframe_dist: float = 2.0  # m
    keyframe_angle: float = 10.0 * np.pi / 180.0
    sc_dist_thres: float = sc.SC_DIST_THRES
    icp_fitness_max: float = 0.3
    submap_half_span: int = 12  # +-keyframes in the ICP target (reference 25)
    node_capacity: int = 2048
    loop_capacity: int = 256
    cloud_capacity: int = 2048  # stored points per keyframe (subsampled)
    optimize_every: int = 4  # keyframes between relaxations


class GlobalFusion:
    """Host orchestration of keyframes, loop queries and graph relaxation."""

    def __init__(self, cfg: GlobalFusionConfig = GlobalFusionConfig(),
                 dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.graph = pg.init_graph(cfg.node_capacity, cfg.loop_capacity, dtype, self.device)
        self.scdb = sc.init_db(cfg.node_capacity, dtype, self.device)
        self.clouds = torch.zeros((cfg.node_capacity, cfg.cloud_capacity, 3), dtype=dtype,
                                  device=self.device)
        self.cloud_valid = torch.zeros((cfg.node_capacity, cfg.cloud_capacity),
                                       dtype=torch.bool, device=self.device)
        self.kf_q_odom = []  # odometry pose at each keyframe (host list)
        self.kf_p_odom = []
        self.kf_ts = []  # keyframe timestamps (for TUM export / ATE)
        self.n_kf = 0
        self.last_q = None
        self.last_p = None
        self.loops_found = []  # (i, j) pairs accepted
        self._pending_opt = 0
        self._pending_sc = []  # in-flight loop queries: (i, _HostCopy)
        self._pending_icp = []  # in-flight ICP verifications: (i, j, q, p, _HostCopy)

    def _dev(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype).to(self.device)

    @staticmethod
    def _host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    # ------------------------------------------------------------------
    def is_keyframe(self, q, p) -> bool:
        if self.last_q is None:
            return True
        q = np.asarray(q)
        lq = np.asarray(self.last_q)
        dp = np.linalg.norm(np.asarray(p) - np.asarray(self.last_p))
        dth = 2.0 * np.arccos(np.clip(np.abs(np.dot(q, lq)), 0.0, 1.0))
        return dp > self.cfg.keyframe_dist or dth > self.cfg.keyframe_angle

    def add_frame(self, q_odom, p_odom, scan_points, scan_valid,
                  t: Optional[float] = None) -> Optional[tuple]:
        """Feed one odometry pose (host arrays or tensors; the pipeline
        passes host arrays it already read) + body-frame scan (tensors).
        Returns (i, j) if a loop was accepted this keyframe, else None.
        Non-keyframes are ignored."""
        q_np = self._host(q_odom)
        p_np = self._host(p_odom)
        if not self.is_keyframe(q_np, p_np):
            return None
        cfg = self.cfg
        i = self.n_kf
        if i >= cfg.node_capacity:
            return None  # graph full

        (self.graph, self.scdb, self.clouds, self.cloud_valid, cand, dist,
         shift) = _keyframe_program(
            self.graph, self.scdb, self.clouds, self.cloud_valid,
            self._dev(self.last_q if i else q_np), self._dev(self.last_p if i else p_np),
            self._dev(q_np), self._dev(p_np),
            scan_points.to(self.device, self.dtype), scan_valid.to(self.device),
            i, i == 0)
        self.last_q = q_np
        self.last_p = p_np
        self.kf_q_odom.append(q_np)
        self.kf_p_odom.append(p_np)
        self.kf_ts.append(float(t) if t is not None else float(i))
        self.n_kf += 1

        # start the host copy of this keyframe's loop query now; resolve
        # queries only once their copies have landed
        self._pending_sc.append((i, _HostCopy(cand, dist, shift)))
        res_icp = self._poll_icp()
        res_sc = self._poll_sc()
        result = res_sc if res_sc is not None else res_icp

        self._pending_opt += 1
        # relaxation is a no-op until the first loop edge exists
        if self.loops_found and (
                result is not None or self._pending_opt >= cfg.optimize_every):
            self.graph = pg.optimize_bucketed(self.graph, self.n_kf)
            self._pending_opt = 0
        return result

    def prewarm(self) -> None:
        """Run the rare-event paths (ICP loop verification, graph
        relaxation) once before the steady state, discarding their results:
        on the card this is the first launch of K2 and of the solver
        kernels. Requires at least one keyframe."""
        if self.n_kf < 1:
            return
        self._dispatch_icp(self.n_kf - 1, max(self.n_kf - 2, 0), 0.0)
        self._pending_icp.pop()[4].get()
        g = pg.optimize_bucketed(self.graph, self.n_kf)
        _HostCopy(g.p[:1]).get()

    def _poll_sc(self, block: bool = False) -> Optional[tuple]:
        """Resolve every queued loop query whose host copy has landed
        (never blocks unless `block`). Returns the last accepted loop."""
        result = None
        while self._pending_sc:
            if not block and not self._pending_sc[0][1].ready():
                break
            r = self._resolve_sc(self._pending_sc.pop(0))
            result = r if r is not None else result
        return result

    def _resolve_sc(self, pending) -> Optional[tuple]:
        """Gate a completed loop query on distance and dispatch its ICP
        verification (resolved by _poll_icp when its fitness lands)."""
        i, copy = pending
        cand, dist, shift = copy.get()
        if float(dist) >= self.cfg.sc_dist_thres:
            return None
        j = int(cand)
        yaw0 = float(int(shift)) * (2.0 * np.pi / sc.N_SECTOR)
        self._dispatch_icp(i, j, yaw0)
        return self._poll_icp()

    def flush(self) -> Optional[tuple]:
        """Resolve all in-flight loop queries + ICP verifications (end of a
        sequence / shutdown)."""
        res_sc = self._poll_sc(block=True)
        res_icp = self._poll_icp(block=True)
        result = res_icp if res_icp is not None else res_sc
        if result is not None:
            self.graph = pg.optimize_bucketed(self.graph, self.n_kf)
            self._pending_opt = 0
        return result

    # ------------------------------------------------------------------
    def _dispatch_icp(self, i: int, j: int, yaw0: float) -> None:
        """ICP of keyframe i against the +-submap_half_span submap around j;
        the fitness is read by _poll_icp once its host copy lands."""
        cfg = self.cfg
        ks = np.clip(np.arange(j - cfg.submap_half_span,
                               j + cfg.submap_half_span + 1), 0, self.n_kf - 1)
        dup = np.zeros(len(ks), bool)
        dup[1:] = ks[1:] == ks[:-1]  # clamp duplicates (ks is nondecreasing)
        q_fit, p_fit, fitness = _submap_icp(
            self.graph.q, self.graph.p, self.clouds, self.cloud_valid,
            torch.as_tensor(ks, dtype=torch.int64).to(self.device),
            torch.as_tensor(dup).to(self.device), i, j, yaw0)
        self._pending_icp.append((i, j, q_fit, p_fit, _HostCopy(fitness)))

    def _poll_icp(self, block: bool = False) -> Optional[tuple]:
        """Accept every completed ICP verification whose fitness passes
        (never blocks unless `block`). Returns the last accepted loop."""
        result = None
        while self._pending_icp:
            if not block and not self._pending_icp[0][4].ready():
                break
            i, j, q_fit, p_fit, copy = self._pending_icp.pop(0)
            f = float(copy.get()[0])
            if np.isfinite(f) and f <= self.cfg.icp_fitness_max:
                self.graph = pg.add_loop(self.graph, j, i, q_fit, p_fit)
                result = (i, j)
                self.loops_found.append(result)
        return result

    # ------------------------------------------------------------------
    def poses(self):
        """(q (n, 4), p (n, 3)) numpy arrays of the optimized keyframe
        trajectory."""
        n = self.n_kf
        return self.graph.q[:n].cpu().numpy(), self.graph.p[:n].cpu().numpy()
