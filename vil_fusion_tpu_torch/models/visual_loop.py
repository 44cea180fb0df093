"""Visual loop closure: keyframe database, BoW detection, geometric
verification, 4-DoF graph integration, relocalization, save/load.

Port of vil_fusion_tpu/models/visual_loop.py (the reference's pose_graph
node):
  * keyframe build: corners + BRIEF for the window's points and for extra
    corners (keyframe.cpp:14-42, 75-113), extra corners with a LiDAR depth
    added as 3-D anchors;
  * detectLoop: top-4 BoW query with recency exclusion and two score gates
    (pose_graph.cpp:307-389) over LSH words (models/brief.py);
  * findConnection: Hamming matching (< 80, ratio test) + PnP RANSAC against
    the current keyframe's 3-D points + yaw / translation gates
    (keyframe.cpp:200-256, :472-517);
  * the 4-DoF pose graph and its drift (models/posegraph4dof.py);
  * savePoseGraph / loadPoseGraph (pose_graph.cpp:701-874) as an npz whose
    keys are the reference's, so either package loads the other's file.

The split is the reference's: the keyframe store is numpy on the host; the
BoW histograms (capacity x 16,384 float32) and the graph live on `device`.
Small pose algebra on the host runs on CPU float32 tensors, as the
reference's float32 arrays. The RANSAC of `find_connection` draws from a
CPU torch.Generator seeded with the DB's call count (the reference keys
its threefry the same way); `sel=` injects the sample indices.

The reference's jitted programs are CUDA graphs on the card
(`utils/graphs.step`; the first call of a key runs the body, the second
captures, later calls replay): the keyframe's descriptors, extra corners,
their rays, the densification's depths and the BoW histogram
(`_keyframe_values`, graph "vl_keyframe"; one host read follows, then the
store's numpy bookkeeping), a verification's Hamming match ("vl_match") and
PnP RANSAC ("pnp_ransac", its uniforms drawn on the host before the replay
and uploaded with the verification's inputs; the seeds' and the relative
pose's small algebra on the host) and the 4-DoF solve
("posegraph4dof_optimize"). The CPU runs the
same bodies eagerly. No lock is taken for their captures: the pipeline
calls the DB with its step lock held (models/posegraph4dof.py). Host
arrays go to the card through pinned memory without waiting
(`graphs.upload`).

Two deviations from the reference, each a fix of a reference bug (and two
of placement: the RANSAC's uniforms are drawn on the host before the PnP
graph, and the extra corners are lifted to rays on the device, inside the
keyframe program, where the reference lifts them on the host):
  * the drift bound of `find_connection` (a share of the path between the
    two keyframes, counted by their indices) applies to loops within one
    session only: between two sessions the index distance says nothing of
    the path, and the bound rejected loops that stitch them (a camera gap
    that ends a session leaves its last keyframe metres from the next
    session's first); those are held to the flat 20 m gate;
  * the densification's `feature_depth` uses the rig's depth_min_incidence
    (`min_incidence=`), as the frame's own depth association does; the
    reference calls it with the module default.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from vil_fusion_tpu_torch.models import brief, cameras, depth_association
from vil_fusion_tpu_torch.models import posegraph4dof as pg4
from vil_fusion_tpu_torch.ops import image as im
from vil_fusion_tpu_torch.ops import lie
from vil_fusion_tpu_torch.utils import graphs

MIN_LOOP_NUM = 25  # keyframe.cpp MIN_LOOP_NUM
MAX_YAW_DEG = 30.0
MAX_TRANS = 20.0
RECENT_EXCLUDE = 50  # pose_graph.cpp detectLoop skips the last 50


class VisualLoopConfig(NamedTuple):
    capacity: int = 2048
    win_cap: int = 256  # 3-D-anchored descriptors a keyframe: window landmarks
    # plus lidar-depthed extra corners (the Hamming stage needs >= MIN_LOOP_NUM
    # of these to match)
    extra_cap: int = 384  # extra corners (reference: 500)
    score_best: float = 0.05  # detectLoop tier-1 gate on the top score
    score_min: float = 0.015  # detectLoop tier-2 gate on runner-up scores
    top_k: int = 4  # BoW query width (db.query(..., 4, ...))
    keyframe_gap: float = 1.0  # m between loop keyframes (SKIP_DIS analog)
    pnp_ransac_hyp: int = 64
    pnp_inlier_px: float = 10.0 / 460.0  # solvePnPRansac reprojectionError
    # (keyframe.cpp:227-232, on the virtual-focal normalized plane)


def _f32(x):
    """Host array -> CPU float32 tensor (the host's small pose algebra)."""
    return torch.as_tensor(np.asarray(x, np.float32))


def _ypr_deg(q):
    """(yaw, pitch, roll) in degrees of a host quaternion, float32."""
    return lie.R2ypr(lie.q2R(_f32(q))).numpy()


def _qmul_np(a, b):
    return lie.qmul(_f32(a), _f32(b)).numpy()


def _to_bits(x):
    """x as int32 rows of its bits (float32 viewed, bool and int32 cast), for
    one host read of several leaves."""
    if x.dtype == torch.float32:
        return x.reshape(-1).view(torch.int32)
    return x.reshape(-1).to(torch.int32)


def _from_bits(host, shapes_dtypes):
    """Split one host read of `_to_bits` rows back into numpy arrays."""
    out, o = [], 0
    for shape, dtype in shapes_dtypes:
        n = int(np.prod(shape))
        part = host[o:o + n].reshape(shape)
        o += n
        out.append(part.view(np.float32) if dtype == np.float32 else part.astype(dtype))
    return out


class KeyframeValues(NamedTuple):
    """What the keyframe program computes (`_keyframe_values`)."""
    win_desc: torch.Tensor  # (win_cap, 8) int32 BRIEF of the window points
    extra_desc: torch.Tensor  # (extra_cap, 8) int32 BRIEF of the extra corners
    extra_valid: torch.Tensor  # (extra_cap,) bool
    extra_xy: torch.Tensor  # (extra_cap, 2) the extra corners' normalized rays
    depth: Optional[torch.Tensor]  # (extra_cap,) feature_depth of the rays (with a cloud)
    depth_ok: Optional[torch.Tensor]  # (extra_cap,) bool
    hist: torch.Tensor  # (N_WORDS,) the BoW histogram over both descriptor sets
    host: torch.Tensor  # the leaves above but the histogram, as int32 bits (`_to_bits`)


def _lift(cam, px):
    """Normalized rays (x / z, y / z) of pixels (N, 2), z clamped at 1e-6:
    the reference's `_lift`, on the tensor's device."""
    ray = cameras.lift(cam, px)
    z = torch.clamp(ray[:, 2], min=1e-6)
    return ray[:, :2] / z[:, None]


def _keyframe_values(img, wxy, wval, cloud_cam, cloud_valid, cam, cfg: "VisualLoopConfig",
                     min_incidence=None) -> KeyframeValues:
    """The keyframe program's pure part (add_keyframe's device work): the
    window points' descriptors, the extra corners (detected independently of
    the window points, keyframe.cpp computeBRIEFPoint) with their
    descriptors and rays, their lidar depths where `cloud_cam` is given
    (camera-frame cloud; None: no densification), and the BoW histogram
    over both descriptor sets. Writes nothing; reads nothing on the host."""
    dev = img.device
    wdesc = brief.brief_descriptors(img, wxy, wval)
    exy, evalid = im.detect_features(
        img, torch.zeros((1, 2), dtype=torch.float32, device=dev),
        torch.zeros((1,), dtype=torch.bool, device=dev), max_pts=cfg.extra_cap, min_dist=10)
    edesc = brief.brief_descriptors(img, exy, evalid)
    ray = _lift(cam, exy)
    dep = okd = None
    if cloud_cam is not None:
        dep, okd = depth_association.feature_depth(ray, evalid, cloud_cam, cloud_valid,
                                                   min_incidence=min_incidence)
    words = brief.words_of(torch.cat([wdesc, edesc], dim=0))
    hist = brief.word_histogram(words, torch.cat([wval, evalid], dim=0))
    host = torch.cat([_to_bits(x) for x in (wdesc, edesc, evalid, ray, dep, okd)
                      if x is not None])
    return KeyframeValues(wdesc, edesc, evalid, ray, dep, okd, hist, host)


def _match_values(desc_a, valid_a, desc_b, valid_b):
    """brief.match's gate `ok` and one int64 row (idx, ok) for the host."""
    idx, ok = brief.match(desc_a, valid_a, desc_b, valid_b)
    return ok, torch.cat([idx, ok.to(torch.int64)])


def match_values(desc_a, valid_a, desc_b, valid_b):
    """`_match_values`; on the card one replay of its graph ("vl_match",
    keyed on the shapes): a verification's Hamming match, some forty small
    kernels eagerly."""
    args = (desc_a, valid_a, desc_b, valid_b)
    if graphs.use_graph(desc_a):
        return graphs.step("vl_match", _match_values, args)
    return _match_values(*args)


def keyframe_values(img, wxy, wval, cloud_cam, cloud_valid, cam, cfg: "VisualLoopConfig",
                    min_incidence=None) -> KeyframeValues:
    """`_keyframe_values`; on the card one replay of its graph
    ("vl_keyframe", keyed on the camera, the configuration, the depth
    threshold, whether a cloud is given, and the shapes)."""
    fn = functools.partial(_keyframe_values, cam=cam, cfg=cfg, min_incidence=min_incidence)
    args = (img, wxy, wval, cloud_cam, cloud_valid)
    if graphs.use_graph(img):
        return graphs.step("vl_keyframe", fn, args,
                           static=(cam, cfg, min_incidence, cloud_cam is not None))
    return fn(*args)


class VisualLoopDB:
    """Host-side keyframe store with device-resident BoW histograms and
    4-DoF graph. `min_incidence` is the rig's depth_min_incidence (None:
    depth association's default)."""

    def __init__(self, cfg: VisualLoopConfig = VisualLoopConfig(), dtype=torch.float32,
                 qic=None, tic=None, min_incidence: Optional[float] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.min_incidence = min_incidence
        # camera-IMU extrinsic: keyframe poses are BODY poses, matching and
        # PnP work in the camera frame
        self.qic = np.asarray([1.0, 0, 0, 0] if qic is None else qic, np.float32)
        self.tic = np.asarray([0.0, 0, 0] if tic is None else tic, np.float32)
        C = cfg.capacity
        self.hists = torch.zeros((C, brief.N_WORDS), dtype=dtype, device=self.device)
        self.win_desc = np.zeros((C, cfg.win_cap, 8), np.int32)
        self.win_pts3d = np.zeros((C, cfg.win_cap, 3), np.float32)  # world
        self.win_valid = np.zeros((C, cfg.win_cap), bool)
        self.extra_desc = np.zeros((C, cfg.extra_cap, 8), np.int32)
        self.extra_xy = np.zeros((C, cfg.extra_cap, 2), np.float32)  # normalized
        self.extra_valid = np.zeros((C, cfg.extra_cap), bool)
        self.q = np.zeros((C, 4), np.float32)
        self.p = np.zeros((C, 3), np.float32)
        # immutable insert-time (VIO) copies: sync_from_graph recomputes the
        # corrected q / p / win_pts3d from these, so corrections never compound
        self.vio_q = np.zeros((C, 4), np.float32)
        self.vio_pts3d = np.zeros((C, cfg.win_cap, 3), np.float32)
        self.seq = np.zeros((C,), np.int32)  # the graph's session ids, on the host
        self.graph = pg4.init_graph(C, dtype=dtype, device=self.device)
        self.n = 0
        self._ransac_calls = 0
        # per-gate counts and distributions of every query and verification
        self.stats = {
            "queries": 0, "kill_recent": 0, "kill_score_best": 0,
            "kill_score_second": 0, "detect_pass": 0,
            "verify_attempts": 0, "kill_hamming": 0, "kill_pnp": 0,
            "kill_yaw_trans": 0, "accepted": 0,
            "best_scores": [], "second_scores": [], "hamming_matches": [], "pnp_inliers": [],
        }

    def _dev(self, x, dtype=None):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return graphs.upload(x, self.device, dtype)

    # ------------------------------------------------------------------
    def add_keyframe(self, img, q_wb, p_wb, pts3d_w, pts2d_px, pts_valid, cam,
                     sequence: int = 0, cloud_cam=None, cloud_valid=None):
        """Build and insert a keyframe; returns its index (None when full).

        img: (H, W) image (numpy or tensor); pts3d_w: window landmarks
        (world); pts2d_px: their pixel coordinates. cloud_cam / cloud_valid:
        this frame's camera-frame LiDAR cloud (device tensors), whose depths
        turn extra corners into more 3-D anchors. `sequence` tags the
        session: sequential graph edges never cross sessions. The device
        work is `keyframe_values` (a graph replay on the card), then one
        host read."""
        cfg = self.cfg
        if self.n >= cfg.capacity:
            return None
        i = self.n
        img = self._dev(img, torch.float32)

        # window-point descriptors; extra corners, detected independently
        # of the window points (keyframe.cpp computeBRIEFPoint); with a
        # cloud, their lidar depths
        wn = min(len(pts2d_px), cfg.win_cap)
        wxy = np.zeros((cfg.win_cap, 2), np.float32)
        wval = np.zeros((cfg.win_cap,), bool)
        wxy[:wn] = pts2d_px[:wn]
        wval[:wn] = pts_valid[:wn]
        densify = cloud_cam is not None and wn < cfg.win_cap
        kv = keyframe_values(img, graphs.upload(wxy, self.device),
                             graphs.upload(wval, self.device),
                             cloud_cam if densify else None, cloud_valid if densify else None,
                             cam, cfg, self.min_incidence)
        E = cfg.extra_cap
        parts = [((cfg.win_cap, 8), np.int32), ((E, 8), np.int32), ((E,), bool),
                 ((E, 2), np.float32)] + ([((E,), np.float32), ((E,), bool)] if densify else [])
        host = _from_bits(kv.host.cpu().numpy(), parts)  # the keyframe's one host read
        wdesc, edesc_np, evalid_np, ray = host[:4]
        self.win_desc[i] = wdesc
        self.win_pts3d[i, :wn] = pts3d_w[:wn]
        self.win_valid[i] = wval
        self.extra_desc[i] = edesc_np
        self.extra_xy[i] = ray
        self.extra_valid[i] = evalid_np

        # lidar-depthed extras -> more 3-D anchors in the window set
        if densify:
            dep, okd = host[4], host[5]
            # strong (positive) depths only: grazing depths are bias-prone
            # and these points anchor the loop PnP
            okd = okd & (dep > 0)
            sel = np.nonzero(okd)[0][: cfg.win_cap - wn]
            if len(sel):
                R_wb = lie.q2R(_f32(q_wb)).numpy().astype(np.float64)
                R_ic = lie.q2R(_f32(self.qic)).numpy().astype(np.float64)
                R_wc = R_wb @ R_ic
                p_wc = R_wb @ self.tic.astype(np.float64) + np.asarray(p_wb, np.float64)
                pc = np.concatenate([ray[sel] * dep[sel, None], dep[sel, None]], axis=1)
                m = len(sel)
                self.win_desc[i, wn:wn + m] = edesc_np[sel]
                self.win_pts3d[i, wn:wn + m] = pc @ R_wc.T + p_wc
                self.win_valid[i, wn:wn + m] = True

        # BoW histogram over all descriptors
        self.hists[i] = kv.hist

        self.q[i] = np.asarray(q_wb)
        self.p[i] = np.asarray(p_wb)
        self.vio_q[i] = np.asarray(q_wb)
        self.vio_pts3d[i] = self.win_pts3d[i]
        ypr = _ypr_deg(q_wb) * np.pi / 180.0
        node = graphs.upload(np.concatenate([np.asarray(p_wb, np.float32),
                                             np.asarray(ypr, np.float32)]), self.device)
        self.graph = pg4.add_node(self.graph, node[:3], node[3], node[4], node[5],
                                  graphs.upload(np.int32(sequence), self.device))
        self.seq[i] = sequence
        self.n += 1
        return i

    # ------------------------------------------------------------------
    def detect_candidates(self, i_query: int):
        """Two-tier top-k BoW query with recency exclusion (detectLoop
        :307-389): the best candidate must score > score_best and at least
        one runner-up > score_min; the gated candidates are returned
        earliest first (the reference's min_index scan picks the first)."""
        cfg = self.cfg
        st = self.stats
        st["queries"] += 1
        if i_query <= RECENT_EXCLUDE:
            st["kill_recent"] += 1
            return []
        scores = brief.bow_scores(self.hists[i_query], self.hists).cpu().numpy().copy()
        scores[max(0, i_query - RECENT_EXCLUDE):] = -1.0  # db.query max_id
        top = np.argsort(scores)[::-1][: cfg.top_k]
        top_s = scores[top]
        st["best_scores"].append(float(top_s[0]))
        st["second_scores"].append(float(top_s[1]) if len(top_s) > 1 else -1.0)
        if top_s[0] < cfg.score_best:
            st["kill_score_best"] += 1
            return []
        ok = top_s > cfg.score_min
        if not ok[1:].any():  # need a second independent candidate
            st["kill_score_second"] += 1
            return []
        st["detect_pass"] += 1
        return sorted(int(j) for j in top[ok])

    def detect(self, i_query: int):
        """Earliest gated candidate (min_index scan) or None."""
        cands = self.detect_candidates(i_query)
        return cands[0] if cands else None

    def detect_and_verify(self, i_query: int):
        """Detection + geometric verification: gated candidates are tried
        earliest first until one verifies. Returns (i_old, q_rel, p_rel) or
        None."""
        for cand in self.detect_candidates(i_query):
            conn = self.find_connection(i_query, cand)
            if conn is not None:
                return cand, conn[0], conn[1]
        return None

    def find_connection(self, i_cur: int, i_old: int, sel=None):
        """Geometric verification (findConnection keyframe.cpp:259-519):
        Hamming match of the current keyframe's window descriptors against
        the old keyframe's extra descriptors, then PnP RANSAC of the
        current 3-D points against the old normalized observations; accept
        on the inlier count and the yaw / translation gates.

        `sel` (n_hyp, 6) injects the RANSAC's sample indices (else its
        uniforms are drawn here, on the host, and uploaded with the PnP's
        inputs). Returns None or (q_old_cur, p_old_cur) as numpy: the
        current keyframe's pose in the old keyframe's frame."""
        cfg = self.cfg
        st = self.stats
        st["verify_attempts"] += 1
        dev = self.device
        ok, host = match_values(
            graphs.upload(self.win_desc[i_cur], dev), graphs.upload(self.win_valid[i_cur], dev),
            graphs.upload(self.extra_desc[i_old], dev), graphs.upload(self.extra_valid[i_old], dev))
        host = host.cpu().numpy()  # one read: the matches and the gate
        N = cfg.win_cap
        idx, ok_np = host[:N], host[N:] > 0
        n_match = int(ok_np.sum())
        st["hamming_matches"].append(n_match)
        if n_match < MIN_LOOP_NUM:
            st["kill_hamming"] += 1
            return None
        pts3d = self.win_pts3d[i_cur]  # current-world landmarks
        obs_old = self.extra_xy[i_old][idx]  # matched normalized obs in the old camera

        # PnP RANSAC for the old CAMERA in the current world, from two seeds:
        # the old keyframe's stored pose (exact without drift) and the
        # current keyframe's camera pose (within metres of the solution
        # under accumulated drift: a loop means "same place")
        self._ransac_calls += 1
        u = None
        if sel is None:
            u = ransac_uniforms(cfg.pnp_ransac_hyp, N,
                                torch.Generator().manual_seed(self._ransac_calls))
        # the seeds' small pose algebra on the host (CPU float32)
        ext = (_f32(self.qic), _f32(self.tic))
        q_cur, p_cur = _f32(self.q[i_cur]), _f32(self.p[i_cur])
        q0, p0 = lie.pose_compose((_f32(self.q[i_old]), _f32(self.p[i_old])), ext)
        q0b, p0b = lie.pose_compose((q_cur, p_cur), ext)
        parts = [pts3d, obs_old, q0, p0, q0b, p0b] + ([] if u is None else [u])
        flat = graphs.upload(np.concatenate([np.asarray(x, np.float32).reshape(-1)
                                             for x in parts]), dev)  # one upload
        o = [0]

        def take(*shape):
            n = int(np.prod(shape))
            o[0] += n
            return flat[o[0] - n:o[0]].reshape(shape)

        pts3d_d, obs_d = take(N, 3), take(N, 2)
        q0, p0, q0b, p0b = take(4), take(3), take(4), take(3)
        u_d = None if u is None else take(cfg.pnp_ransac_hyp, N)
        q_pnp_c, p_pnp_c, inl = pnp_ransac(
            pts3d_d, obs_d, ok, q0, p0, q0_alt=q0b, p0_alt=p0b, n_hyp=cfg.pnp_ransac_hyp,
            inlier_tol=cfg.pnp_inlier_px, u=u_d, sel=sel)
        host = torch.cat([inl.sum().to(torch.float32)[None], q_pnp_c, p_pnp_c]).cpu()  # one read
        n_inl = int(host[0])
        # back to a body pose; relative pose T_old_cur = T_old^-1 T_cur (host)
        q_pnp, p_pnp = lie.pose_compose((host[1:5], host[5:8]), lie.pose_inverse(ext))
        q_rel, p_rel = (x.numpy() for x in lie.pose_between((q_pnp, p_pnp), (q_cur, p_cur)))
        st["pnp_inliers"].append(n_inl)
        if n_inl < MIN_LOOP_NUM or n_inl < 0.45 * n_match:
            # count gate = reference (MIN_LOOP_NUM); the fraction floor is
            # the reference's own guard against false candidates in a
            # repetitive scene
            st["kill_pnp"] += 1
            return None
        ypr = _ypr_deg(q_rel)
        # |yaw| / ||t|| gates at the reference's constants plus its drift-model
        # bound (~8% of the path between the keyframes + slack), within a
        # session only: across sessions the indices do not measure the path
        t_bound = MAX_TRANS
        if self.seq[i_cur] == self.seq[i_old]:
            path_since = abs(i_cur - i_old) * cfg.keyframe_gap
            t_bound = min(MAX_TRANS, max(2.0, 0.08 * path_since + 2.0 * cfg.keyframe_gap))
        if abs(ypr[0]) > MAX_YAW_DEG or float(np.linalg.norm(p_rel)) > t_bound:
            st["kill_yaw_trans"] += 1
            return None
        st["accepted"] += 1
        return q_rel, p_rel

    def close_loop(self, i_cur: int, i_old: int, q_rel, p_rel):
        """Add the loop edge (4-DoF form) and re-optimize the graph."""
        ypr_rel = _ypr_deg(q_rel)
        edge = graphs.upload(np.append(np.asarray(p_rel, np.float32).reshape(3),
                                       np.float32(np.deg2rad(ypr_rel[0]))), self.device)
        ij = graphs.upload(np.array([i_old, i_cur], np.int32), self.device)
        self.graph = pg4.add_loop(self.graph, ij[0], ij[1], edge[:3], edge[3])
        self.graph = pg4.optimize(self.graph)
        return self.graph

    def apply_drift_to_vio(self, R_d, dyaw: float, t_d):
        """Relocalization bookkeeping: when the estimator window is
        re-anchored by the loop drift, the insert-time (VIO-frame) records,
        the graph's vio_p / vio_yaw and this store's vio_q / vio_pts3d, move
        into the corrected frame too. A global yaw + t transform keeps every
        relative measurement, so the graph's solution is unchanged."""
        n = self.n
        if n == 0:
            return
        R_d = np.asarray(R_d, np.float32)
        t_d = np.asarray(t_d, np.float32)
        g = self.graph
        vio_p_new = g.vio_p[:n].cpu().numpy() @ R_d.T + t_d
        vio_p = g.vio_p.clone()
        vio_p[:n] = self._dev(vio_p_new)
        vio_yaw = g.vio_yaw.clone()
        vio_yaw[:n] += float(np.float32(dyaw))
        self.graph = g._replace(vio_p=vio_p, vio_yaw=vio_yaw)
        half = 0.5 * float(dyaw)
        qz = np.asarray([np.cos(half), 0.0, 0.0, np.sin(half)], np.float32)
        self.vio_q[:n] = _qmul_np(np.broadcast_to(qz, (n, 4)), self.vio_q[:n])
        self.vio_pts3d[:n] = self.vio_pts3d[:n] @ R_d.T + t_d

    def sync_from_graph(self):
        """updatePath / updatePoses analog (pose_graph.cpp:526-576): pull the
        optimized node poses into the keyframe store and move each
        keyframe's world landmarks by its node's yaw + t correction,
        recomputed from the immutable insert-time copies."""
        n = self.n
        if n == 0:
            return
        g = self.graph
        p_new = g.p[:n].cpu().numpy().astype(np.float32)
        dyaw = (g.yaw[:n] - g.vio_yaw[:n]).cpu().numpy().astype(np.float32)
        c, s = np.cos(dyaw), np.sin(dyaw)
        R = np.zeros((n, 3, 3), np.float32)
        R[:, 0, 0] = c
        R[:, 0, 1] = -s
        R[:, 1, 0] = s
        R[:, 1, 1] = c
        R[:, 2, 2] = 1.0
        t = p_new - np.einsum("nij,nj->ni", R, g.vio_p[:n].cpu().numpy().astype(np.float32))
        self.p[:n] = p_new
        self.win_pts3d[:n] = np.einsum("nij,nkj->nki", R, self.vio_pts3d[:n]) + t[:, None, :]
        half = 0.5 * dyaw
        qz = np.stack([np.cos(half), np.zeros_like(half), np.zeros_like(half), np.sin(half)],
                      axis=-1)
        self.q[:n] = _qmul_np(qz, self.vio_q[:n])

    # ------------------------------------------------------------------
    def stats_summary(self) -> dict:
        """Kill counts per gate plus distributions (p50 / p90 / max) of the
        BoW scores, Hamming survivors and PnP inliers actually observed."""
        st = self.stats

        def dist(xs):
            if not xs:
                return None
            s = sorted(xs)
            n = len(s)
            return {"n": n, "p50": round(float(s[n // 2]), 4),
                    "p90": round(float(s[min(n - 1, (9 * n) // 10)]), 4),
                    "max": round(float(s[-1]), 4)}

        out = {k: v for k, v in st.items() if isinstance(v, int)}
        out["win_landmarks"] = dist(st.get("win_landmarks", []))
        out["best_score"] = dist(st["best_scores"])
        out["second_score"] = dist(st["second_scores"])
        out["hamming_survivors"] = dist(st["hamming_matches"])
        out["pnp_inlier_count"] = dist(st["pnp_inliers"])
        out["gates"] = {"score_best": self.cfg.score_best, "score_min": self.cfg.score_min,
                        "min_loop_num": MIN_LOOP_NUM}
        return out

    def save(self, path: str):
        """savePoseGraph analog (pose_graph.cpp:701-755); the reference's keys."""
        n = self.n
        g = {k: v.cpu().numpy() for k, v in self.graph._asdict().items()}
        np.savez_compressed(
            path, n=n, hists=self.hists[:n].cpu().numpy(),
            win_desc=self.win_desc[:n], win_pts3d=self.win_pts3d[:n],
            win_valid=self.win_valid[:n], extra_desc=self.extra_desc[:n],
            extra_xy=self.extra_xy[:n], extra_valid=self.extra_valid[:n],
            q=self.q[:n], p=self.p[:n], vio_q=self.vio_q[:n], vio_pts3d=self.vio_pts3d[:n],
            graph_p=g["p"], graph_yaw=g["yaw"], graph_pitch=g["pitch"],
            graph_roll=g["roll"], graph_seq=g["seq"], graph_vio_p=g["vio_p"],
            graph_vio_yaw=g["vio_yaw"])

    def load(self, path: str):
        """loadPoseGraph analog (pose_graph.cpp:756-874)."""
        d = np.load(path)
        n = int(d["n"])
        self.n = n
        self.hists[:n] = self._dev(d["hists"])
        for k in ("win_desc", "win_pts3d", "win_valid", "extra_desc", "extra_xy",
                  "extra_valid", "q", "p"):
            getattr(self, k)[:n] = d[k]
        self.vio_q[:n] = d["vio_q"] if "vio_q" in d else d["q"]
        self.vio_pts3d[:n] = d["vio_pts3d"] if "vio_pts3d" in d else d["win_pts3d"]

        def put(a, key):
            if key not in d:
                return a
            a = a.clone()
            a[: len(d[key])] = self._dev(d[key], a.dtype)
            return a

        if "graph_seq" in d:
            self.seq[: len(d["graph_seq"])] = d["graph_seq"]
        g = self.graph
        self.graph = g._replace(
            p=put(g.p, "graph_p"), yaw=put(g.yaw, "graph_yaw"), pitch=put(g.pitch, "graph_pitch"),
            roll=put(g.roll, "graph_roll"), seq=put(g.seq, "graph_seq"),
            vio_p=put(g.vio_p, "graph_vio_p"), vio_yaw=put(g.vio_yaw, "graph_vio_yaw"),
            n_nodes=torch.tensor(n, dtype=torch.int32, device=self.device))


def _pnp_gn(pts3d, obs, masks, q, p, iters: int):
    """initialization.pnp_gn for B poses at once (q (B, 4), p (B, 3), masks
    (B, N) weighting the correspondences) with its Jacobian written out:
    r = proj(R^T (X - p)) - obs under the right-perturbation retraction
    (dp, dtheta), d(R^T (X - p)) / d(dp, dtheta) = [-R^T | [R^T (X - p)]x].
    torch.func's transforms keep process-wide forward-AD levels that two
    threads cannot use at once, and this runs on the visual-loop worker
    beside the estimator's jacfwd. Returns (q, p, reprojection errors (B, N))."""
    dtype, dev = pts3d.dtype, pts3d.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def camera(q, p):
        return lie.qrot(lie.qconj(q)[:, None, :], pts3d[None] - p[:, None, :])

    for _ in range(iters):
        pc = camera(q, p)  # (B, N, 3)
        ok = (pc[..., 2] > 1e-4).to(dtype)  # where the depth clamp passes the derivative
        inv = 1.0 / torch.clamp(pc[..., 2], min=1e-4)
        r = (pc[..., :2] * inv[..., None] - obs) * masks[..., None]
        zero = torch.zeros_like(inv)
        dproj = torch.stack([torch.stack([inv, zero, -pc[..., 0] * inv * inv * ok], -1),
                             torch.stack([zero, inv, -pc[..., 1] * inv * inv * ok], -1)], -2)
        RT = lie.q2R(q).transpose(1, 2)[:, None].expand(-1, pc.shape[1], -1, -1)
        J = dproj @ torch.cat([-RT, lie.skew(pc)], dim=-1) * masks[..., None, None]
        H = torch.einsum("bnri,bnrj->bij", J, J) + 1e-6 * eye6
        delta = torch.linalg.solve_ex(H, -torch.einsum("bnri,bnr->bi", J, r))[0]
        q, p = lie.pose_retract((q, p), torch.clamp(delta, -0.5, 0.5))
    pc = camera(q, p)
    z = torch.clamp(pc[..., 2], min=1e-4)
    return q, p, torch.linalg.norm(pc[..., :2] / z[..., None] - obs, dim=-1)


def ransac_uniforms(n_hyp: int, n: int, generator=None):
    """The PnP RANSAC's uniforms (n_hyp, n) on the host (CPU float32), from
    `generator`: `pnp_ransac`'s draws, taken before its graph."""
    return torch.rand((n_hyp, n), generator=generator, dtype=torch.float32)


def pnp_ransac(pts3d, obs, valid, q0, p0, q0_alt=None, p0_alt=None, n_hyp: int = 64,
               inlier_tol: float = 3.0 / 460.0, generator=None, sel=None, u=None):
    """Batched PnP RANSAC (PnPRANSAC keyframe.cpp:200-256): each hypothesis
    refines from a prior pose on a random 6-point subset (6 GN iterations),
    then the best-by-inliers pose is refined three times on its growing
    inlier set. With (q0_alt, p0_alt) the hypotheses alternate between the
    two seeds (even -> q0 / p0, odd -> alt).

    `sel` (n_hyp, 6) gives the samples (the body runs eagerly); else each
    hypothesis takes the 6 valid correspondences of smallest uniform in `u`
    (n_hyp, N) (invalid ones sort last), by default drawn on the host from
    `generator` (`ransac_uniforms`). On the card that runs as one replay of
    the graph "pnp_ransac" (keyed on n_hyp, inlier_tol and N). Returns (q,
    p, inliers)."""
    if q0_alt is None:
        q0_alt, p0_alt = q0, p0
    if sel is not None:
        sel = torch.as_tensor(sel, dtype=torch.int64, device=pts3d.device)
        return _pnp_ransac_sel(pts3d, obs, valid, q0, p0, q0_alt, p0_alt, sel, n_hyp,
                               inlier_tol)
    if u is None:
        u = ransac_uniforms(n_hyp, pts3d.shape[0], generator).to(pts3d.device, pts3d.dtype)
    args = (pts3d, obs, valid, q0, p0, q0_alt, p0_alt, u)
    body = functools.partial(_pnp_ransac_body, n_hyp=n_hyp, inlier_tol=inlier_tol)
    if graphs.use_graph(pts3d):
        return graphs.step("pnp_ransac", body, args, static=(n_hyp, float(inlier_tol)))
    return body(*args)


def _pnp_ransac_body(pts3d, obs, valid, q0, p0, q0_alt, p0_alt, u, n_hyp: int,
                     inlier_tol: float):
    """pnp_ransac on the uniforms `u`: reads nothing on the host."""
    sel = torch.argsort(u - 10.0 * valid[None, :].to(u.dtype), dim=1, stable=True)[:, :6]
    return _pnp_ransac_sel(pts3d, obs, valid, q0, p0, q0_alt, p0_alt, sel, n_hyp, inlier_tol)


def _pnp_ransac_sel(pts3d, obs, valid, q0, p0, q0_alt, p0_alt, sel, n_hyp: int,
                    inlier_tol: float):
    """pnp_ransac on the samples `sel` (n_hyp, 6) int64."""
    N = pts3d.shape[0]
    dtype, dev = pts3d.dtype, pts3d.device
    masks = torch.zeros((n_hyp, N), dtype=dtype, device=dev).scatter(
        1, sel, 1.0) * valid.to(dtype)[None, :]
    a = graphs.host_constant(np.arange(n_hyp) % 2, dtype, dev)[:, None]
    qs = lie.qnormalize(q0[None] * (1.0 - a) + q0_alt[None] * a)
    ps = p0[None] * (1.0 - a) + p0_alt[None] * a
    qs, ps, rep = _pnp_gn(pts3d, obs, masks, qs, ps, iters=6)
    # the best hypothesis by inliers; index_select reads no index on the host
    b = torch.argmax((valid[None] & (rep < inlier_tol)).sum(dim=1)).reshape(1)
    q, p = qs.index_select(0, b), ps.index_select(0, b)
    # iterated refinement on the growing inlier set (solvePnPRansac's
    # internal LM refinement does the same)
    for _ in range(3):
        _, _, rep = _pnp_gn(pts3d, obs, masks[:1], q, p, iters=0)
        q, p, _ = _pnp_gn(pts3d, obs, (valid[None] & (rep < inlier_tol)).to(dtype), q, p, iters=8)
    _, _, rep = _pnp_gn(pts3d, obs, masks[:1], q, p, iters=0)
    return q[0], p[0], valid & (rep[0] < inlier_tol)
