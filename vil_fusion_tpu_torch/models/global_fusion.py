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
Host values go up the same way (`graphs.upload`: pinned memory,
non_blocking), so no call waits for the frames in flight, but `flush`,
`prewarm`, `poses` and the blocking polls.

On a CUDA device global fusion enqueues all of its device work on a stream
of its own (SC-A-LOAM's loop detection, ICP and pose-graph threads run
apart from its odometry too): a keyframe's stream waits for what the
caller's stream has enqueued so far (the scan's dequantization and
odometry), and the caller's next odometry step no longer queues behind the
keyframe's ICP verification or relaxation. Readers of the device state
(`poses`, `flush`, a checkpoint's save: `fence`) make the caller's stream
wait for the fusion stream; state put in from outside (a checkpoint's load:
`adopt_state`) is held for the fusion stream. The stream's backlog is
bounded: keyframe i is enqueued only once keyframe i - BACKLOG's work has
finished (span "global_fusion.backlog_wait"), so every loop query and ICP
verdict is still resolved in order, at a bounded lag. On the CPU there is
no stream and every path runs as it did.

On a CUDA device the reference's jitted programs replay CUDA graphs
(utils/graphs.step): the keyframe program's pure part ("keyframe_program":
edge glue, node values, descriptor, the loop query on the database with the
keyframe inserted, cloud subsample), whose three row writes (graph node,
database row, cloud) then run in place on the device index; the submap ICP
("submap_icp", keyed on the submap's shapes); the pose graph's relaxation
("posegraph_optimize", one key a bucket).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from vil_fusion_tpu_torch.models import icp as icp_mod
from vil_fusion_tpu_torch.models import posegraph as pg
from vil_fusion_tpu_torch.models import scancontext as sc
from vil_fusion_tpu_torch.ops import lie
from vil_fusion_tpu_torch.utils import graphs
from vil_fusion_tpu_torch.utils.graphs import host_constant
from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS


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
        """The host values: waits for the copy unless it has landed."""
        if self._event is not None and not self._event.query():
            self._event.synchronize()
        return self.values


def _linspace_idx(n: int, cap: int, device):
    """Cloud subsample indices floor(j (n - 1) / (cap - 1)), j < cap, in exact
    integer arithmetic. The reference's float32 jnp.linspace(...).astype
    rounds a few of them one lower (3 of 2048 at n = 115,200)."""
    j = torch.arange(cap, dtype=torch.int64, device=device)
    return (j * (n - 1)) // max(cap - 1, 1)


def _row(x, i):
    """x[i] for a host int or a 0-d int tensor `i` (a captured step's number
    leaf): index_select reads no index on the host."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1))[0]
    return x[i]


def _keyframe_values(gq, gp, db, q_prev_kf, p_prev_kf, q_dev, p_dev, pts, val, i,
                     first: bool, cap: int):
    """The pure part of the keyframe program: (q_abs, p_abs, q_rel, p_rel)
    of the new node, its ScanContext descriptor, the loop query (cand,
    dist, shift) against the database with that descriptor inserted, and
    the cloud's `cap` subsampled rows with their validity. Writes nothing."""
    if first:
        q_rel = host_constant((1.0, 0.0, 0.0, 0.0), pts.dtype, pts.device)
        p_rel = torch.zeros(3, dtype=pts.dtype, device=pts.device)
        q_abs, p_abs = q_dev, p_dev
    else:
        q_rel, p_rel = lie.pose_between((q_prev_kf, p_prev_kf), (q_dev, p_dev))
        q_abs, p_abs = lie.pose_compose((_row(gq, i - 1), _row(gp, i - 1)), (q_rel, p_rel))
    desc = sc.make_descriptor(pts, val)
    cand, dist, shift = sc.detect_loop(sc.with_keyframe(db, desc), desc)
    idx = _linspace_idx(pts.shape[0], cap, pts.device)
    return q_abs, p_abs, q_rel, p_rel, desc, cand, dist, shift, pts[idx], val[idx]


def _keyframe_program(graph, db, clouds, cloud_valid, q_prev_kf, p_prev_kf,
                      q_dev, p_dev, pts, val, i: int, first: bool, capture_lock=None):
    """The keyframe hot path: odometry-edge glue + graph node append +
    ScanContext insert/detect + cloud subsample/store. `i` is the host
    keyframe index. Graph, database and cloud store are updated in place.
    On the card the pure part replays its graph ("keyframe_program", keyed
    on `first`, captured with `capture_lock` held); the three row writes
    follow it on the device."""
    fn = functools.partial(_keyframe_values, first=first, cap=clouds.shape[1])
    args = (graph.q, graph.p, db, q_prev_kf, p_prev_kf, q_dev, p_dev, pts, val, i)
    if graphs.use_graph(pts):
        out = graphs.step("keyframe_program", fn, args, static=(first, clouds.shape[1]),
                          lock=capture_lock)
    else:
        out = fn(*args)
    q_abs, p_abs, q_rel, p_rel, desc, cand, dist, shift, rows, rows_valid = out
    graph = pg.add_node(graph, q_abs, p_abs, q_rel, p_rel)
    db = sc.add_keyframe(db, desc)
    clouds[i] = rows
    cloud_valid[i] = rows_valid
    return graph, db, clouds, cloud_valid, cand, dist, shift


def _submap_icp_body(qs, ps, clouds, cloud_valid, ks, dup, i, j, yaw0):
    """_submap_icp's body: `i`, `j` host ints or 0-d int tensors, `yaw0` a
    host float or a 0-d tensor."""
    q_j, p_j = _row(qs, j), _row(ps, j)
    q_rel, p_rel = lie.pose_between((q_j, p_j), (qs[ks], ps[ks]))  # (K, 4), (K, 3)
    tgt = (lie.qrot(q_rel[:, None, :], clouds[ks]) + p_rel[:, None, :]).reshape(-1, 3)
    tgtv = (cloud_valid[ks] & ~dup[:, None]).reshape(-1)

    # two initial guesses, keep the better fit: (a) the graph relative pose;
    # (b) the same translation with the yaw replaced by the SC shift estimate
    q0, p0 = lie.pose_between((q_j, p_j), (_row(qs, i), _row(ps, i)))
    yaw_q0 = lie.R2ypr(lie.q2R(q0))[0] * (math.pi / 180.0)
    yaw0_t = (yaw0.to(qs.dtype) if isinstance(yaw0, torch.Tensor)
              else torch.full((), yaw0, dtype=qs.dtype, device=qs.device))
    z = torch.zeros_like(yaw0_t)
    q_corr = lie.so3_exp(torch.stack([z, z, yaw0_t - yaw_q0]))
    q0b = lie.qnormalize(lie.qmul(q_corr, q0))

    src, srcv = _row(clouds, i), _row(cloud_valid, i)
    qa, pa, fa = icp_mod.icp_point2point(src, srcv, tgt, tgtv, q0, p0)
    qb, pb, fb = icp_mod.icp_point2point(src, srcv, tgt, tgtv, q0b, p0)
    pick_a = fa <= fb
    return (torch.where(pick_a, qa, qb), torch.where(pick_a, pa, pb),
            torch.minimum(fa, fb))


def _submap_icp(qs, ps, clouds, cloud_valid, ks, dup, i: int, j: int, yaw0: float,
                capture_lock=None):
    """Submap assembly around keyframe j + ICP verification of keyframe i.
    `ks` is the fixed-length clamped index span around j; `dup` masks
    clamp-duplicated entries. On the card one graph replay ("submap_icp",
    keyed on the submap's shapes; i, j and yaw0 are its number leaves)."""
    args = (qs, ps, clouds, cloud_valid, ks, dup, i, j, yaw0)
    if graphs.use_graph(qs):
        return graphs.step("submap_icp", _submap_icp_body, args, lock=capture_lock)
    return _submap_icp_body(*args)


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

    # keyframes whose device work may still be in flight on the fusion stream
    # when the next one is enqueued: room for one ICP verification and
    # relaxation burst (~35 ms on an H100) while a loop closure lags the
    # odometry by at most ~10 scans at KITTI's keyframe spacing
    BACKLOG = 4

    def __init__(self, cfg: GlobalFusionConfig = GlobalFusionConfig(),
                 dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._done = collections.deque()  # an event a keyframe in flight, oldest first
        self.max_in_flight = 0  # the most keyframes ever in flight on the stream
        with self._on_stream():
            self.graph = pg.init_graph(cfg.node_capacity, cfg.loop_capacity, dtype,
                                       self.device)
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
        # held while a graph of global fusion is captured (a pipeline whose
        # visual-loop worker enqueues on the same device sets its step lock)
        self.capture_lock = None

    @contextlib.contextmanager
    def _on_stream(self):
        """Enqueue the block's device work on the fusion stream, after what
        the caller's stream has enqueued so far (on the CPU: as it is)."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield

    def fence(self) -> None:
        """Make the caller's stream wait for the device work global fusion
        has enqueued, before it reads the graph, database or clouds (no host
        wait; nothing on the CPU)."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def adopt_state(self) -> None:
        """Hold the memory of device state another stream made (a
        checkpoint's load) for the fusion stream: the allocator gives it to
        no other stream's tensors until the fusion stream's work on it has
        finished. The fusion stream's next work waits for the caller's."""
        if self.stream is not None:
            for t in (*self.graph, *self.scdb, self.clouds, self.cloud_valid):
                t.record_stream(self.stream)

    def _admit(self) -> None:
        """Before a keyframe is enqueued: count "global_fusion.stream_busy"
        if the previous keyframe's work has not finished, and wait (span
        "global_fusion.backlog_wait") for the one BACKLOG keyframes back if
        it has not. The stream runs in order, so the finished events are at
        the deque's front."""
        done = self._done
        while done and done[0].query():
            done.popleft()
        if done:
            GLOBAL_TIMERS.count("global_fusion.stream_busy")
        if len(done) >= self.BACKLOG:
            with GLOBAL_TIMERS.timed("global_fusion.backlog_wait"):
                done.popleft().synchronize()
        self.max_in_flight = max(self.max_in_flight, len(done) + 1)

    def _mark_done(self) -> None:
        """Record the end of this keyframe's work on the fusion stream."""
        if self.stream is not None:
            ev = torch.cuda.Event()
            ev.record(self.stream)
            self._done.append(ev)

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
        Non-keyframes are ignored; keyframes past `node_capacity` are
        dropped and counted ("global_fusion.keyframes_dropped"). Spans:
        "global_fusion.keyframe" (the keyframe program), ".poll" (the loop
        queries' and ICP verdicts' polls, which dispatch ".icp"), ".relax"
        (the pose graph's relaxation), ".backlog_wait" (on the card: the wait
        for the keyframe BACKLOG back, see `_admit`; counter
        "global_fusion.stream_busy")."""
        q_np = self._host(q_odom)
        p_np = self._host(p_odom)
        if not self.is_keyframe(q_np, p_np):
            return None
        cfg = self.cfg
        i = self.n_kf
        if i >= cfg.node_capacity:
            GLOBAL_TIMERS.count("global_fusion.keyframes_dropped")
            return None  # graph full

        pts = scan_points.to(self.device, self.dtype)
        val = scan_valid.to(self.device)
        if self.stream is not None:  # made on the caller's stream, read on the fusion stream
            pts.record_stream(self.stream)
            val.record_stream(self.stream)
        self._admit()
        with self._on_stream():
            result = self._keyframe(q_np, p_np, pts, val, i, t)
            self._mark_done()
        return result

    def _keyframe(self, q_np, p_np, pts, val, i: int, t) -> Optional[tuple]:
        """add_frame's device work for keyframe i, on the current stream."""
        cfg = self.cfg
        with GLOBAL_TIMERS.timed("global_fusion.keyframe"):
            # the four poses in one pinned, non-blocking upload
            poses = graphs.upload(np.concatenate(
                [self.last_q if i else q_np, self.last_p if i else p_np, q_np, p_np]),
                self.device, self.dtype)
            (self.graph, self.scdb, self.clouds, self.cloud_valid, cand, dist,
             shift) = _keyframe_program(
                self.graph, self.scdb, self.clouds, self.cloud_valid,
                poses[0:4], poses[4:7], poses[7:11], poses[11:14], pts, val,
                i, i == 0, self.capture_lock)
        self.last_q = q_np
        self.last_p = p_np
        self.kf_q_odom.append(q_np)
        self.kf_p_odom.append(p_np)
        self.kf_ts.append(float(t) if t is not None else float(i))
        self.n_kf += 1

        # start the host copy of this keyframe's loop query now; resolve
        # queries only once their copies have landed
        self._pending_sc.append((i, _HostCopy(cand, dist, shift)))
        with GLOBAL_TIMERS.timed("global_fusion.poll"):
            res_icp = self._poll_icp()
            res_sc = self._poll_sc()
        result = res_sc if res_sc is not None else res_icp

        self._pending_opt += 1
        # relaxation is a no-op until the first loop edge exists
        if self.loops_found and (
                result is not None or self._pending_opt >= cfg.optimize_every):
            with GLOBAL_TIMERS.timed("global_fusion.relax"):
                self.graph = pg.optimize_bucketed(self.graph, self.n_kf,
                                                  capture_lock=self.capture_lock)
            self._pending_opt = 0
        return result

    def prewarm(self) -> None:
        """Run the rare-event paths (ICP loop verification, graph
        relaxation) once before the steady state, discarding their results:
        on the card this is the first launch of K2 and of the solver
        kernels. Requires at least one keyframe."""
        if self.n_kf < 1:
            return
        with self._on_stream():
            self._dispatch_icp(self.n_kf - 1, max(self.n_kf - 2, 0), 0.0)
            self._pending_icp.pop()[4].get()
            g = pg.optimize_bucketed(self.graph, self.n_kf, capture_lock=self.capture_lock)
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
        sequence / shutdown). The caller's stream then waits for the fusion
        stream."""
        with self._on_stream():
            res_sc = self._poll_sc(block=True)
            res_icp = self._poll_icp(block=True)
            result = res_icp if res_icp is not None else res_sc
            if result is not None:
                self.graph = pg.optimize_bucketed(self.graph, self.n_kf,
                                                  capture_lock=self.capture_lock)
                self._pending_opt = 0
        self.fence()
        return result

    # ------------------------------------------------------------------
    def _dispatch_icp(self, i: int, j: int, yaw0: float) -> None:
        """ICP of keyframe i against the +-submap_half_span submap around j;
        the fitness is read by _poll_icp once its host copy lands."""
        cfg = self.cfg
        with GLOBAL_TIMERS.timed("global_fusion.icp"):
            ks = np.clip(np.arange(j - cfg.submap_half_span,
                                   j + cfg.submap_half_span + 1), 0, self.n_kf - 1)
            dup = np.zeros(len(ks), bool)
            dup[1:] = ks[1:] == ks[:-1]  # clamp duplicates (ks is nondecreasing)
            ks_dev = graphs.upload(ks, self.device, torch.int64)
            dup_dev = graphs.upload(dup, self.device, torch.bool)
            q_fit, p_fit, fitness = _submap_icp(
                self.graph.q, self.graph.p, self.clouds, self.cloud_valid, ks_dev, dup_dev,
                i, j, yaw0, self.capture_lock)
        self._pending_icp.append((i, j, q_fit, p_fit,
                                  _HostCopy(fitness)))

    def _poll_icp(self, block: bool = False) -> Optional[tuple]:
        """Accept every completed ICP verification whose fitness passes
        (never blocks unless `block`). Returns the last accepted loop. Past
        the loop store's capacity an edge overwrites its last slot
        (posegraph._slot), counted as "global_fusion.loops_overwritten"."""
        result = None
        while self._pending_icp:
            if not block and not self._pending_icp[0][4].ready():
                break
            i, j, q_fit, p_fit, copy = self._pending_icp.pop(0)
            f = float(copy.get()[0])
            if np.isfinite(f) and f <= self.cfg.icp_fitness_max:
                if len(self.loops_found) >= self.graph.loop_i.shape[0]:
                    GLOBAL_TIMERS.count("global_fusion.loops_overwritten")
                self.graph = pg.add_loop(self.graph, j, i, q_fit, p_fit)
                result = (i, j)
                self.loops_found.append(result)
        return result

    # ------------------------------------------------------------------
    def poses(self):
        """(q (n, 4), p (n, 3)) numpy arrays of the optimized keyframe
        trajectory."""
        self.fence()
        n = self.n_kf
        return self.graph.q[:n].cpu().numpy(), self.graph.p[:n].cpu().numpy()
