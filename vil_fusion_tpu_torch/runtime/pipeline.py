"""The VIL-Fusion pipeline: sensors in, trajectories out.

Port of vil_fusion_tpu/runtime/pipeline.py (the reference's ROS graph as a
single-controller, frame-synchronous pipeline):

  camera ─┐                 ┌─ tracker (KLT+RANSAC) ── features ─┐
  lidar ──┼─ sync (±0.03 s) ┼─ feature extraction + scan-to-map ─┼─ estimator ─ odometry ─ global fusion
  imu ────┘                 └─ depth association (unit sphere) ──┘

Modes "vil" (camera + IMU + LiDAR), "vio" (camera + IMU), "mask" (VIO
with dynamic-object masks) and "lidar" (F-LOAM + SC-A-LOAM: odometry and
global fusion only). With sync_depth=0 every frame's host consequences
(failure restart, high-rate reseed, global fusion, visual loop, outputs)
happen in that frame; with sync_depth=N > 0 steady frames are issued and
completed N frames later (the reference's deferred path). The visual loop
closure runs with any of the camera modes. `vil_front_end` is steps 1-4 of
the reference's vil frame program (tracker, lidar odometry, extrinsic glue,
depth association) and `vil_frame` the whole program with the estimator's
fused step.

Failure handling: the estimator's failureDetection triggers a clearState
reboot seeded from the LiDAR odometry pose; a camera-stream gap triggers
the same restart.
"""
from __future__ import annotations

import os
import queue
import threading
import traceback
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from vil_fusion_tpu_torch.models import ba
from vil_fusion_tpu_torch.models import cameras as cam_mod
from vil_fusion_tpu_torch.models import depth_association
from vil_fusion_tpu_torch.models import estimator as est_mod
from vil_fusion_tpu_torch.models import global_fusion as gf
from vil_fusion_tpu_torch.models import lidar_features as lf
from vil_fusion_tpu_torch.models import lidar_odometry as lo
from vil_fusion_tpu_torch.models import posegraph4dof as pg4
from vil_fusion_tpu_torch.models import tracker as trk
from vil_fusion_tpu_torch.models.imu import ImuNoise
from vil_fusion_tpu_torch.ops import lie
from vil_fusion_tpu_torch.runtime import tum
from vil_fusion_tpu_torch.runtime.config import RigConfig
from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS


def _dequant_scan(pts_i16, val_packed, quant: float, n: int):
    """int16 fixed-point points + bit-packed validity -> (f32 points, bool
    mask), on the tensors' device. numpy packbits is MSB-first."""
    pts = pts_i16.to(torch.float32) * quant
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=val_packed.device)
    bits = (val_packed[:, None] >> shifts) & 1
    return pts, (bits.reshape(-1) > 0)[:n]


class FrontEnd(NamedTuple):
    """What `vil_front_end` needs besides the frame: camera model, tracker
    and odometry configurations, and the rig's constant extrinsics as
    tensors on the device (composed once, as the reference hoists them)."""
    cam: tuple
    tcfg: trk.TrackerConfig
    lcfg: lo.OdomConfig
    q_il: torch.Tensor  # lidar -> IMU (q_ic * q_cl)
    t_il: torch.Tensor
    q_li: torch.Tensor  # its inverse
    t_li: torch.Tensor
    q_cl: torch.Tensor  # lidar points -> camera frame
    t_cl: torch.Tensor
    scan_quant: float  # metres per int16 step of a quantized scan
    tsh_scale: float  # rolling-shutter readout time per row (TR / ROW), 0 = global shutter
    min_incidence: float  # strong/weak threshold of the lidar depth


def front_end_config(rig: RigConfig, f_cap: int = 128, mask_gate: bool = False,
                     odom_overrides: Optional[dict] = None, scan_quant: float = 0.0,
                     device="cuda") -> FrontEnd:
    """The front end's configuration for a rig, as the reference's pipeline
    derives it: tracker capacity max_cnt * 1.25 rounded up to 64 slots (at
    least f_cap), lidar configuration from the rig's scanner, extrinsics
    composed from q_ic/t_ic and q_cl/t_cl."""
    cap = max(-(-int(rig.max_cnt * 1.25) // 64) * 64, f_cap)
    tcfg = trk.TrackerConfig(max_cnt=rig.max_cnt, min_dist=rig.min_dist, cap=cap,
                             use_clahe=rig.equalize, f_thresh_px=rig.f_threshold,
                             mask_gate=mask_gate)
    f32 = dict(dtype=torch.float32, device=device)
    if rig.q_cl is not None:
        q_cl, t_cl = torch.as_tensor(rig.q_cl, **f32), torch.as_tensor(rig.t_cl, **f32)
    else:
        q_cl, t_cl = torch.tensor([1.0, 0, 0, 0], **f32), torch.zeros(3, **f32)
    q_ic, t_ic = torch.as_tensor(rig.q_ic, **f32), torch.as_tensor(rig.t_ic, **f32)
    q_il, t_il = lie.pose_compose((q_ic, t_ic), (q_cl, t_cl))
    q_li, t_li = lie.pose_inverse((q_il, t_il))
    tsh_scale = (rig.tr / rig.image_height if rig.rolling_shutter and rig.tr != 0.0 else 0.0)
    return FrontEnd(cam=cam_mod.from_config(rig.camera), tcfg=tcfg,
                    lcfg=_odom_config(rig, odom_overrides), q_il=q_il, t_il=t_il, q_li=q_li,
                    t_li=t_li, q_cl=q_cl, t_cl=t_cl, scan_quant=float(scan_quant),
                    tsh_scale=float(tsh_scale), min_incidence=float(rig.depth_min_incidence))


def _odom_config(rig: RigConfig, odom_overrides: Optional[dict]) -> lo.OdomConfig:
    cfg = lo.OdomConfig(
        lidar=lf.LidarConfig(
            n_scan=rig.n_scan, width=1800 if rig.n_scan >= 64 else 900,
            min_range=rig.lidar_min_range, max_range=rig.lidar_max_range,
            fov_up_deg=rig.lidar_fov_up, fov_down_deg=rig.lidar_fov_down))
    if odom_overrides:
        lidar_kw = {k: v for k, v in odom_overrides.items() if k in lf.LidarConfig._fields}
        odom_kw = {k: v for k, v in odom_overrides.items() if k in lo.OdomConfig._fields}
        if lidar_kw:
            odom_kw["lidar"] = cfg.lidar._replace(**lidar_kw)
        cfg = cfg._replace(**odom_kw)
    return cfg


def frame_seed(t: float) -> int:
    """The frame's RANSAC seed, derived on the host from the float64
    timestamp: floor(t * 1000) & 0x7FFFFFFF (the reference derives its key
    from the same expression on the device)."""
    return int(np.floor(float(t) * 1e3)) & 0x7FFFFFFF


def _track(tracker_state: trk.TrackerState, img, t: float, fe: FrontEnd,
           initialized: Optional[bool], generator=None, sel=None, dyn_mask=None):
    """Step 1 of the vil frame: the tracker, its RANSAC drawing from
    `generator` reseeded from frame_seed(t) (made on the image's device when
    None), or from the sample indices `sel`."""
    if sel is None:
        if generator is None:
            generator = torch.Generator(device=img.device)
        generator.manual_seed(frame_seed(t))
    return trk.track_step(tracker_state, img, t, fe.cam, fe.tcfg, dyn_mask=dyn_mask,
                          generator=generator, sel=sel, initialized=initialized)


def _glue(lqr, lpr, pts, fe: FrontEnd):
    """Step 3: the lidar relative pose through the extrinsics into the IMU
    frame, and the cloud into the camera frame."""
    qt, pt = lie.pose_compose((fe.q_il, fe.t_il), (lqr, lpr))
    q_imu, p_imu = lie.pose_compose((qt, pt), (fe.q_li, fe.t_li))
    return q_imu, p_imu, lie.qrot(fe.q_cl[None, :], pts) + fe.t_cl[None, :]


def vil_front_end(tracker_state: trk.TrackerState, lidar_state: lo.MapState, img, pts, val,
                  t: float, fe: FrontEnd, frame_index: Optional[int] = None,
                  generator: Optional[torch.Generator] = None, sel=None):
    """The vil frame up to the estimator's door: tracker -> lidar odometry
    -> extrinsic glue -> depth association -> rolling-shutter shift (steps
    1-4 of the reference's frame program; `vil_frame` adds the estimator).

    img (H, W) uint8 or float; pts (N, 3) float32, or int16 fixed point
    with `val` bit-packed (dequantized here with fe.scan_quant); t the
    frame's timestamp (host float). `frame_index` is the host count of
    frames already processed (0 on the first): it stands for both states'
    device counters, so no frame reads the device; None reads them. The
    RANSAC draws from `generator`, reseeded from `frame_seed(t)`; a
    generator is made on the image's device when none is given. `sel`
    injects the sample indices instead (tests).

    Returns (tracker_state, lidar_state, out) with out a dict: ids, xy, vel,
    depth, tsh, q_imu, p_imu (what the estimator step takes), plus valid,
    uv, track_cnt, lidar_q, lidar_p, lidar_q_rel, lidar_p_rel and the f32 cloud
    (pts, val) for global fusion."""
    if pts.dtype == torch.int16:
        pts, val = _dequant_scan(pts, val, fe.scan_quant, pts.shape[0])
    started = None if frame_index is None else frame_index > 0
    tracker_state, obs = _track(tracker_state, img, t, fe, started, generator, sel)
    lidar_state, (lq, lp, lqr, lpr) = lo.odometry_step(lidar_state, pts, val, fe.lcfg,
                                                       frame_count=frame_index)
    q_imu, p_imu, cloud_cam = _glue(lqr, lpr, pts, fe)
    depth, _ = depth_association.feature_depth(obs["xy"], obs["valid"], cloud_cam, val,
                                               min_incidence=fe.min_incidence)
    # rolling-shutter readout shift TR * (row - ROW / 2) / ROW
    tsh = fe.tsh_scale * (obs["uv"][:, 1] - 0.5 * img.shape[0])
    out = dict(ids=obs["ids"], xy=obs["xy"], vel=obs["vel"], depth=depth, tsh=tsh,
               q_imu=q_imu, p_imu=p_imu, valid=obs["valid"], uv=obs["uv"],
               track_cnt=obs["track_cnt"],
               lidar_q=lq, lidar_p=lp, lidar_q_rel=lqr, lidar_p_rel=lpr, pts=pts, val=val)
    return tracker_state, lidar_state, out


def vil_frame(tracker_state: trk.TrackerState, lidar_state: lo.MapState,
              window, feats, pre, lidarc, prior, img, pts, val, acc_b, gyr_b, dt_b,
              n_imu: int, t: float, fe: FrontEnd, ecfg: est_mod.EstimatorConfig,
              frame_index: Optional[int] = None, generator: Optional[torch.Generator] = None,
              sel=None):
    """The whole steady-state vil frame (the reference's _vil_frame_program,
    pipeline.py:110-172): vil_front_end (tracker, lidar odometry, extrinsic
    glue, depth association), then estimator.fused_full_step (IMU segment,
    feature ingest, keyframe decision, triangulation, BA, marginalization,
    slide). A plain function: the reference compiles it into one program.

    acc_b, gyr_b (imu_cap, 3), dt_b (imu_cap - 1,) are the padded IMU
    segment on the device and n_imu its host sample count
    (VILEstimator._pack_imu); the other arguments are vil_front_end's and
    the estimator's states. Returns (tracker_state, lidar_state, window,
    feats, pre, lidarc, prior, out, front) with out fused_full_step's
    outputs and front vil_front_end's."""
    tracker_state, lidar_state, front = vil_front_end(
        tracker_state, lidar_state, img, pts, val, t, fe, frame_index, generator, sel)
    window, feats, pre, lidarc, prior, out = est_mod.fused_full_step(
        window, feats, pre, lidarc, prior, acc_b, gyr_b, dt_b, n_imu,
        front["ids"], front["xy"], front["vel"], front["depth"], front["tsh"],
        front["q_imu"], front["p_imu"], torch.ones((), dtype=torch.bool, device=img.device),
        True, ecfg)
    return tracker_state, lidar_state, window, feats, pre, lidarc, prior, out, front


# -- numpy quaternion kit of the host-side high-rate propagator: the
# IMU-rate predict() path runs at 100-500 Hz, where a device round trip per
# sample would dominate -------------------------------------------------------
def _np_qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _np_qrot(q, v):
    w, xyz = q[0], q[1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _np_so3_exp_q(phi):
    a = np.linalg.norm(phi)
    if a < 1e-8:
        q = np.array([1.0, 0.5 * phi[0], 0.5 * phi[1], 0.5 * phi[2]])
    else:
        q = np.concatenate([[np.cos(0.5 * a)], np.sin(0.5 * a) * phi / a])
    return q / np.linalg.norm(q)


def _np_q2R(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _np_R2q(R):
    w = 0.5 * np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
    q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                  (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w)])
    return q / np.linalg.norm(q)


def _np_propagate(p, q, v, ba_, bg_, acc0, gyr0, acc1, gyr1, dt, g):
    """numpy mirror of imu.propagate_state (estimator_node.cpp predict :44-80)."""
    un_gyr = 0.5 * (gyr0 + gyr1) - bg_
    q_new = _np_qmul(q, _np_so3_exp_q(un_gyr * dt))
    q_new = q_new / np.linalg.norm(q_new)
    un_acc = 0.5 * (_np_qrot(q, acc0 - ba_) + _np_qrot(q_new, acc1 - ba_)) - g
    p_new = p + v * dt + 0.5 * un_acc * dt * dt
    v_new = v + un_acc * dt
    return p_new, q_new, v_new


@dataclass
class PipelineOutputs:
    ts: list = field(default_factory=list)
    vio_p: list = field(default_factory=list)  # no-loop trajectory
    vio_q: list = field(default_factory=list)
    loop_p: list = field(default_factory=list)  # drift-corrected (visual loop)
    loop_q: list = field(default_factory=list)
    lidar_p: list = field(default_factory=list)
    lidar_q: list = field(default_factory=list)
    # per-frame attachment to the latest visual-loop keyframe: its index in
    # the keyframe DB and the frame's pose relative to it at output time, so
    # rebuild_loop_path() can rewrite the past trajectory from the optimized
    # 4-DoF graph (pose_graph.cpp updatePath)
    anchor_kf: list = field(default_factory=list)
    anchor_rel: list = field(default_factory=list)  # (R_rel, p_rel) or None
    # per-frame estimator-initialized flag: the reference publishes VIO
    # odometry only in NON_LINEAR state (pubOdometry, visualization.cpp), so
    # pre-initialization rows are left out of the VIO trajectories
    initialized: list = field(default_factory=list)

    def rebuild_loop_path(self, db):
        """Rewrite loop_p / loop_q from the optimized keyframe poses
        (pose_graph.cpp updatePath). Idempotent: anchor_rel is immutable,
        db.q / db.p are the current optimized poses."""
        if db is None or not self.anchor_kf:
            return
        for k, (a, rel) in enumerate(zip(self.anchor_kf, self.anchor_rel)):
            if a < 0 or rel is None:
                continue
            R_a = _np_q2R(np.asarray(db.q[a], np.float64))
            R_rel, p_rel = rel
            self.loop_p[k] = R_a @ p_rel + np.asarray(db.p[a], np.float64)
            self.loop_q[k] = _np_R2q(R_a @ R_rel)

    def write(self, out_dir: str, fusion: Optional[gf.GlobalFusion] = None):
        """The reference's TUM outputs: vins_result_no_loop and
        vins_result_loop (initialized frames only), lidar_odometry and
        fs_loam_loop."""
        os.makedirs(out_dir, exist_ok=True)
        ini = self.initialized or [True] * len(self.ts)
        sel = [k for k, ok in enumerate(ini) if ok]
        tum.write_tum(os.path.join(out_dir, "vins_result_no_loop.txt"),
                      [self.ts[k] for k in sel], [self.vio_p[k] for k in sel],
                      [self.vio_q[k] for k in sel])
        if self.loop_p:
            tum.write_tum(os.path.join(out_dir, "vins_result_loop.txt"),
                          [self.ts[k] for k in sel], [self.loop_p[k] for k in sel],
                          [self.loop_q[k] for k in sel])
        tum.write_tum(os.path.join(out_dir, "lidar_odometry.txt"),
                      self.ts, self.lidar_p, self.lidar_q)
        if fusion is not None and fusion.n_kf:
            q_all, p_all = fusion.poses()
            tum.write_tum(os.path.join(out_dir, "fs_loam_loop.txt"),
                          fusion.kf_ts, p_all, q_all)


def _fetch_async(tensors):
    """Start the host copies of `tensors`: (host tensors, CUDA event to wait
    on before reading them, or None on the CPU). On the card the copies go
    into pinned buffers, ordered on the current stream."""
    if not tensors[0].is_cuda:
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class VILFusionPipeline:
    """Modes of the reference: "vil" (camera + IMU + LiDAR), "vio" (no
    lidar), "lidar" (LiDAR-only odometry + global fusion) and "mask"
    (dynamic-scene VIO: the tracker keeps features off the masks pushed
    with the images).

    sync_depth=0 completes every frame's host consequences (failure
    restart, high-rate reseed, global fusion, visual loop, outputs) in that
    frame. With sync_depth=N, steady frames are issued (`_issue_frame`) and
    completed N frames later (`_complete_frame`), their results copied to
    the host in between; the cold start and the window's filling run
    synchronously. The port's fused estimator step still reads its keyframe
    decision on the host each frame (VILEstimator.process_frame_device_async).

    visual_loop=True adds the visual loop closure (models/visual_loop.py):
    keyframe BRIEF / BoW detection, PnP verification, the 4-DoF graph and
    relocalization feedback into the estimator window. With sync_depth > 0
    it runs on a worker thread, issuing on the main thread's CUDA stream;
    `vl_errors` counts the worker's exceptions (each is printed and skipped,
    as in the reference).

    `device` places every state tensor (tracker, maps, estimator window,
    pose graphs, ScanContext and keyframe databases, keyframe clouds);
    images and scans are uploaded to it as they are pushed."""

    SYNC_WINDOW = 0.03  # camera-lidar pairing (feature_tracker_node.cpp:225)
    CAMERA_GAP_RESTART = 1.0  # stream watchdog (restart path)

    def __init__(self, rig: RigConfig, mode: str = "vil", f_cap: int = 128,
                 sc_capacity: int = 1024, visual_loop: bool = False,
                 gf_cfg: Optional[gf.GlobalFusionConfig] = None, vl_cfg=None,
                 odom_overrides: Optional[dict] = None, sync_depth: int = 0,
                 ba_overrides: Optional[dict] = None, scan_quant: float = 0.0,
                 device="cuda"):
        if mode not in ("vil", "vio", "lidar", "mask"):
            raise ValueError(f"unknown mode {mode!r}")
        self.rig = rig
        self.mode = mode
        self.scan_quant = float(scan_quant)
        self.device = torch.device(device)
        use_lidar = mode in ("vil", "lidar")
        self.lidar_cfg = _odom_config(rig, odom_overrides)
        self.lidar_state = lo.init_state(self.lidar_cfg, device=self.device)
        # host mirror of lidar_state.frame_count: the first-frame and warm
        # branches of odometry_step read it without a device sync
        self.lidar_frames = 0

        if gf_cfg is None:
            gf_cfg = gf.GlobalFusionConfig(
                keyframe_dist=rig.keyframe_meter_gap,
                keyframe_angle=np.deg2rad(rig.keyframe_deg_gap),
                sc_dist_thres=rig.sc_dist_thres,
                node_capacity=sc_capacity)
        self.fusion = gf.GlobalFusion(gf_cfg, device=self.device) if use_lidar else None

        if mode != "lidar":
            self.fe = front_end_config(rig, f_cap=f_cap, mask_gate=mode == "mask",
                                       odom_overrides=odom_overrides,
                                       scan_quant=scan_quant, device=self.device)
            self.tracker_cfg = self.fe.tcfg
            self.tracker_state = trk.init_tracker(rig.image_height, rig.image_width,
                                                  self.tracker_cfg, device=self.device)
            self.tracker_frames = 0  # host mirror of tracker_state.initialized
            self.generator = torch.Generator(device=self.device)
            # ba_overrides: BAConfig fields the rig YAML does not carry
            self.est_cfg = est_mod.EstimatorConfig(
                ba=ba.BAConfig(
                    use_lidar=mode == "vil",
                    max_iters=rig.max_num_iterations,
                    estimate_td=rig.estimate_td,
                    estimate_extrinsic=rig.estimate_extrinsic,
                    gravity=(0.0, 0.0, rig.g_norm),
                    **(ba_overrides or {})),
                f_cap=f_cap, obs_cap=self.tracker_cfg.cap,  # == tracker cap (device handoff)
                imu_noise=ImuNoise(rig.acc_n, rig.gyr_n, rig.acc_w, rig.gyr_w),
                min_parallax=rig.keyframe_parallax / 460.0)
            self.estimator = self._new_estimator()

        self.sync_depth = max(0, int(sync_depth))
        self._pending: list = []  # in-flight frame records (sync_depth > 0)
        self._gen = 0  # restart generation: in-flight frames of an older one are stale
        self._imu_hist: list = []  # retained samples for the deferred high-rate reseed
        self.sequence = 0  # session id of the visual loop's graph (new_sequence)

        # visual loop closure: place recognition + 4-DoF graph + drift feedback
        self.visual_loop = None
        self.vl_errors = 0  # exceptions caught in the visual-loop worker
        if visual_loop and mode != "lidar":
            from vil_fusion_tpu_torch.models import visual_loop as vl

            self.visual_loop = vl.VisualLoopDB(
                vl.VisualLoopConfig(capacity=sc_capacity) if vl_cfg is None else vl_cfg,
                qic=rig.q_ic, tic=rig.t_ic, min_incidence=rig.depth_min_incidence,
                device=self.device)
            self.loop_drift_R = np.eye(3, dtype=np.float32)
            self.loop_drift_t = np.zeros(3, np.float32)
            self._last_kf_p = None
            # _vl_lock guards the DB's poses, which _append_loop_output reads
            # while a loop closes; _vl_step_lock serializes whole steps of the
            # worker and of the main thread's synchronous frames
            self._vl_lock = threading.Lock()
            self._vl_step_lock = threading.Lock()
            self._vl_jobs: Optional[queue.Queue] = None
            self._vl_results: queue.Queue = queue.Queue()
            self._vl_idle = threading.Event()
            self._vl_idle.set()
            if self.sync_depth > 0:
                # the reference's pose_graph process() thread: keyframe BRIEF,
                # BoW query, PnP verification and the 4-DoF solve run off the
                # odometry path; accepted drifts apply at a later completed frame
                self._vl_jobs = queue.Queue()
                threading.Thread(target=self._vl_worker, daemon=True,
                                 name="visual-loop-worker").start()

        # host-side queues ("topics")
        self.imu_buf: list = []  # (t, acc, gyr)
        self.image_buf: list = []  # (t, img, mask)
        self.scan_buf: list = []
        self.last_image_t = None
        self.last_processed_t = None
        self.outputs = PipelineOutputs()
        self.restarts = 0
        # per-restart cause record: which failure_detection predicate(s)
        # fired / which watchdog, at what stream time, how long after the
        # estimator (re)initialized
        self.restart_log: list = []
        self._init_t: Optional[float] = None  # last (re)initialization time
        self._hr = None  # high-rate propagator state
        self._imu_boundary = None  # last sample of the previous IMU segment
        self._lidar_pose = (np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32))

    def _new_estimator(self) -> est_mod.VILEstimator:
        est = est_mod.VILEstimator(self.est_cfg, device=self.device)
        est.set_extrinsics(qic=self.rig.q_ic, tic=self.rig.t_ic, td=self.rig.td)
        return est

    # ------------------------------------------------------------------
    def push_imu(self, t, acc, gyr):
        """Buffer the sample. In the camera modes returns the IMU-rate pose
        estimate (p, q, v) once the estimator is initialized, else None
        (pubLatestOdometry / predict(), estimator_node.cpp:44-80);
        LiDAR-only odometry has no IMU-rate pose."""
        return self.push_imu_batch([t], [acc], [gyr])

    def push_imu_batch(self, ts, acc, gyr):
        """Feed a contiguous IMU segment in one call. Returns the high-rate
        pose after the last sample (propagation is still per sample)."""
        ts = np.asarray(ts, np.float64)
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        rows = list(zip(ts.tolist(), acc, gyr))
        self.imu_buf.extend(rows)
        if self.mode == "lidar":
            return None
        # retained history for the deferred reseed (re-propagation from a
        # frame solved sync_depth frames ago; estimator_node update())
        self._imu_hist.extend(rows)
        if len(self._imu_hist) > 4096:
            del self._imu_hist[:2048]
        out = None
        for k in range(len(rows)):
            out = self._propagate_high_rate(rows[k][0], acc[k], gyr[k])
        return out

    def _propagate_high_rate(self, t, acc, gyr):
        hr = self._hr
        if hr is None or not self.estimator.initialized:
            return None
        dt = t - hr["t"]
        if dt <= 0 or dt > 1.0:
            self._hr = None
            return None
        p, q, v = _np_propagate(
            hr["p"], hr["q"], hr["v"], hr["ba"], hr["bg"],
            hr["acc"], hr["gyr"], np.asarray(acc, np.float64),
            np.asarray(gyr, np.float64), dt, np.asarray(self.est_cfg.ba.gravity, np.float64))
        self._hr = dict(t=t, p=p, q=q, v=v, ba=hr["ba"], bg=hr["bg"],
                        acc=np.asarray(acc, np.float64), gyr=np.asarray(gyr, np.float64))
        return p, q, v

    def _reset_high_rate(self, t):
        """Re-seed the high-rate propagator from the latest solved state
        (one host read of the slot's p, q, v, ba, bg)."""
        est = self.estimator
        slot = est_mod.K - 2 if est.frame_count >= est_mod.K - 1 else max(
            min(est.frame_count, est_mod.K - 1) - 1, 0)
        if self.imu_buf:
            acc, gyr = self.imu_buf[-1][1], self.imu_buf[-1][2]
        else:
            acc = np.asarray([0.0, 0, 9.81], np.float32)
            gyr = np.zeros(3, np.float32)
        w = est.window
        host = torch.cat([w.p[slot], w.q[slot], w.v[slot], w.ba[slot], w.bg[slot]]).cpu().numpy()
        self._hr = dict(t=t, p=host[0:3], q=host[3:7], v=host[7:10], ba=host[10:13],
                        bg=host[13:16], acc=np.asarray(acc, np.float32),
                        gyr=np.asarray(gyr, np.float32))

    def _reset_high_rate_from(self, t, p, q, v, ba_, bg_):
        """Re-seed the high-rate propagator from a frame solved sync_depth
        frames ago, then re-propagate the retained IMU samples up to now
        (estimator_node.cpp update() :84-97)."""
        hist = [s for s in self._imu_hist if s[0] > t + 1e-9]
        anchor = None
        for s in self._imu_hist:
            if s[0] <= t + 1e-9:
                anchor = s
        if anchor is None:
            acc0, gyr0 = np.array([0.0, 0, 9.81]), np.zeros(3)
        else:
            acc0, gyr0 = anchor[1], anchor[2]
        hr = dict(t=float(t), p=np.asarray(p, np.float64), q=np.asarray(q, np.float64),
                  v=np.asarray(v, np.float64), ba=np.asarray(ba_, np.float64),
                  bg=np.asarray(bg_, np.float64), acc=acc0, gyr=gyr0)
        g = np.asarray(self.est_cfg.ba.gravity, np.float64)
        for (ts_, acc, gyr) in hist:
            dt = ts_ - hr["t"]
            if dt <= 0 or dt > 1.0:
                hr.update(t=ts_, acc=acc, gyr=gyr)
                continue
            pn, qn, vn = _np_propagate(hr["p"], hr["q"], hr["v"], hr["ba"], hr["bg"],
                                       hr["acc"], hr["gyr"], acc, gyr, dt, g)
            hr.update(t=ts_, p=pn, q=qn, v=vn, acc=acc, gyr=gyr)
        self._hr = hr

    def push_image(self, t, img, mask=None):
        """Queue a camera image (H, W) uint8 or float numpy array and
        process what can be paired. `mask` (H, W) bool marks dynamic
        objects: mode "mask" keeps features off it."""
        # stream watchdog: a long camera gap restarts the estimator
        if self.last_image_t is not None and t - self.last_image_t > self.CAMERA_GAP_RESTART:
            self._restart(cause="camera_gap")
        self.last_image_t = float(t)
        self.image_buf.append((float(t), img, mask))
        return self._try_process()

    def push_scan(self, t, points, valid):
        """Queue a scan and process what can be paired. With scan_quant > 0
        a float numpy scan is quantized to int16 fixed point (scan_quant
        metres per step) with bit-packed validity before upload, as in the
        reference."""
        if (self.scan_quant and isinstance(points, np.ndarray)
                and points.dtype != np.int16):
            points = np.clip(np.round(points * (1.0 / self.scan_quant)),
                             -32767, 32767).astype(np.int16)
            valid = np.packbits(np.asarray(valid, bool))
        self.scan_buf.append((float(t), points, valid))
        return self._try_process()

    def _scan_dev(self, pts, val):
        """Upload a scan: int16 fixed-point + bit-packed validity are
        dequantized on the device; float points pass through."""
        if getattr(pts, "dtype", None) == np.int16:
            n = pts.shape[0]
            return _dequant_scan(torch.from_numpy(pts).to(self.device),
                                 torch.from_numpy(val).to(self.device),
                                 self.scan_quant, n)
        return (torch.as_tensor(np.asarray(pts), dtype=torch.float32).to(self.device),
                torch.as_tensor(np.asarray(val), dtype=torch.bool).to(self.device))

    def _image_dev(self, img):
        img_dev = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return img_dev.to(torch.float32) if img_dev.dtype == torch.float64 else img_dev

    # ------------------------------------------------------------------
    def _restart(self, cause: str = "estimator_failure"):
        """restart_callback analog (estimator_node.cpp:199-218): flush and
        reinitialize the estimator; tracker and maps survive. In "vil" the
        reboot is seeded from the surviving LiDAR odometry pose, so the
        estimator resumes in the same world frame. In-flight frames and
        loop drifts of the failed estimator become stale."""
        t_now = self.last_processed_t if self.last_processed_t is not None \
            else self.last_image_t
        entry = dict(t=t_now, cause=cause,
                     since_init_s=(None if self._init_t is None or t_now is None
                                   else round(t_now - self._init_t, 2)))
        if cause == "estimator_failure":
            entry["predicates"] = est_mod.decode_failure(self.estimator.fail_mask)
        self.restart_log.append(entry)
        self._init_t = None
        self.estimator = self._new_estimator()
        if self.mode == "vil" and self.lidar_frames > 1:
            ls = self.lidar_state
            dt = 0.1
            rel_p = lie.pose_between((ls.q_prev, ls.p_prev), (ls.q, ls.p))[1]
            host = torch.cat([ls.p, ls.q, lie.qrot(ls.q_prev, rel_p) / dt]).cpu().numpy()
            self.estimator.set_initial_state(p=host[0:3], q=host[3:7], v=host[7:10])
        self._hr = None
        self.restarts += 1
        self._gen += 1
        self.sequence += 1  # new_sequence()
        # drop loop drifts computed against the failed estimator's frame
        # (the reference's clearState empties the relo buffer the same way)
        if self.visual_loop is not None:
            while not self._vl_results.empty():
                self._vl_results.get()

    def _pop_imu_until(self, t):
        seg = [s for s in self.imu_buf if s[0] <= t + 1e-9]
        self.imu_buf = [s for s in self.imu_buf if s[0] > t + 1e-9]
        return seg

    def _imu_segment_for_frame(self, t):
        """Samples spanning the FULL inter-frame interval: the boundary
        sample consumed by the previous frame is re-used as this segment's
        first sample, and the last interval is extended to the frame time
        (getMeasurements boundary handling, estimator_node.cpp:100-155)."""
        seg = self._pop_imu_until(t)
        prev = self._imu_boundary
        if prev is not None and (not seg or prev[0] < seg[0][0] - 1e-9):
            seg = [prev] + seg
        if seg:
            self._imu_boundary = seg[-1]
        if not seg:
            return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
        ts_ = np.array([s[0] for s in seg])
        acc = np.stack([s[1] for s in seg])
        gyr = np.stack([s[2] for s in seg])
        dts = np.diff(ts_)
        if t - ts_[-1] > 1e-6:
            # extend to the frame epoch with a held last sample
            acc = np.concatenate([acc, acc[-1:]])
            gyr = np.concatenate([gyr, gyr[-1:]])
            dts = np.concatenate([dts, [t - ts_[-1]]])
        return acc, gyr, dts

    def _imu_for_frame(self, t):
        """The frame's padded IMU segment on the device and its host count."""
        acc_b, gyr_b, dt_b, n_imu = self.estimator._pack_imu(*self._imu_segment_for_frame(t))
        f32 = dict(dtype=torch.float32, device=self.device)
        return (torch.as_tensor(acc_b, **f32), torch.as_tensor(gyr_b, **f32),
                torch.as_tensor(dt_b, **f32), n_imu)

    def _try_process(self):
        if self.mode == "lidar":
            if not self.scan_buf:
                return None
            t, pts, val = self.scan_buf.pop(0)
            return self._process_lidar_only(t, pts, val)
        need_scan = self.mode == "vil"
        if not self.image_buf:
            return None
        if need_scan and not self.scan_buf:
            return None
        t_img, img, mask = self.image_buf[0]
        scan = None
        if need_scan:
            # camera-lidar pairing within the sync window (:220-263)
            t_s = self.scan_buf[0][0]
            if t_s < t_img - self.SYNC_WINDOW:
                self.scan_buf.pop(0)
                return self._try_process()
            if t_s <= t_img + self.SYNC_WINDOW:
                scan = self.scan_buf.pop(0)
            # else: no matching scan; proceed VIO-style
        self.image_buf.pop(0)
        return self._process_frame(t_img, img, mask, scan)

    # ------------------------------------------------------------------
    def _process_lidar_only(self, t, pts, val):
        pts_dev, val_dev = self._scan_dev(pts, val)
        with GLOBAL_TIMERS.timed("lidar_odometry"):
            self.lidar_state, (q, p, _, _) = lo.odometry_step(
                self.lidar_state, pts_dev, val_dev, self.lidar_cfg,
                frame_count=self.lidar_frames)
            self.lidar_frames += 1
            # the frame's one host read: the pose, for outputs and the
            # keyframe gate
            qp = torch.cat([q, p]).cpu().numpy()
        q_np, p_np = qp[:4], qp[4:]
        with GLOBAL_TIMERS.timed("global_fusion"):
            self.fusion.add_frame(q_np, p_np, pts_dev, val_dev, t=t)
        self.outputs.ts.append(t)
        self.outputs.lidar_p.append(p_np)
        self.outputs.lidar_q.append(q_np)
        self.outputs.vio_p.append(p_np)
        self.outputs.vio_q.append(q_np)
        self.outputs.initialized.append(True)  # lidar odometry is always initialized
        return p_np, q_np

    def _process_frame(self, t, img, mask, scan):
        """Synchronous frame, or (sync_depth > 0 with an initialized, full
        window) issue now and complete the frame sync_depth frames back."""
        est = self.estimator
        if self.sync_depth == 0 or not (est.initialized and est.frame_count >= est_mod.K - 1):
            # the cold start and the filling phase are host-orchestrated anyway
            self._drain_pending()
            return self._process_frame_sync(t, img, mask, scan)
        self._pending.append(self._issue_frame(t, img, mask, scan))
        if len(self._pending) > self.sync_depth:
            return self._complete_frame(self._pending.pop(0))
        return None

    def finalize(self):
        """Drain the in-flight frames, the visual-loop worker and the
        in-flight loop queries and ICP verifications (call once at the end
        of a replay). Returns the last completed frame's (p, q) or None."""
        out = self._drain_pending()
        if self.fusion is not None:
            self.fusion.flush()
        if self.visual_loop is not None and self._vl_jobs is not None:
            # wait for the worker to go idle, then apply any accepted drift
            # to the estimator (outputs are rewritten below)
            self._vl_idle.wait(timeout=120.0)
            while not self._vl_results.empty():
                gen, drift = self._vl_results.get()
                if gen == self._gen:
                    self._apply_reloc_drift(drift, np.zeros(3), np.array([1.0, 0, 0, 0]))
        # pose_graph.cpp updatePath: the loop-corrected trajectory from the
        # optimized 4-DoF graph, so corrections reach past frames
        self.outputs.rebuild_loop_path(self.visual_loop)
        return out

    def _drain_pending(self):
        out = None
        while self._pending:
            out = self._complete_frame(self._pending.pop(0))
        return out

    def _append_outputs(self, t, p_est, q_est, initialized: bool, lidar_pose):
        self.outputs.ts.append(t)
        self.outputs.vio_p.append(p_est)
        self.outputs.vio_q.append(q_est)
        self.outputs.initialized.append(initialized)
        if self.visual_loop is not None:
            self._append_loop_output(p_est, q_est)
        self.outputs.lidar_q.append(lidar_pose[0])
        self.outputs.lidar_p.append(lidar_pose[1])
        self.last_processed_t = t

    def _append_loop_output(self, p_est, q_est):
        """Append the loop-corrected output plus its keyframe attachment
        (anchor index + relative pose) for rebuild_loop_path."""
        db = self.visual_loop
        self.outputs.loop_p.append(self.loop_drift_R @ p_est + self.loop_drift_t)
        self.outputs.loop_q.append(_np_R2q(self.loop_drift_R @ _np_q2R(q_est)))
        with self._vl_lock:  # db.q / db.p may be mid-rewrite in the worker
            n = db.n
            if n > 0:
                a = n - 1
                q_a = np.asarray(db.q[a], np.float64).copy()
                p_a = np.asarray(db.p[a], np.float64).copy()
        if n > 0:
            R_a = _np_q2R(q_a)
            self.outputs.anchor_kf.append(a)
            self.outputs.anchor_rel.append(
                (R_a.T @ _np_q2R(np.asarray(q_est, np.float64)),
                 R_a.T @ (np.asarray(p_est, np.float64) - p_a)))
        else:
            self.outputs.anchor_kf.append(-1)
            self.outputs.anchor_rel.append(None)

    # -- the deferred path (sync_depth > 0) ------------------------------
    def _issue_frame(self, t, img, mask, scan):
        """Enqueue one steady frame: tracker -> lidar odometry -> depth
        association -> the estimator's fused step, and start the host
        copies of what its completion reads. Host-side consequences run in
        _complete_frame, sync_depth frames later."""
        img_dev = self._image_dev(img)
        rec: dict = dict(t=t, img=img_dev, gen=self._gen, scan=None, drift_R=None,
                         drift_t=None)
        if (self.mode == "vil" and scan is not None and mask is None
                and self.tracker_frames == self.lidar_frames):
            return self._issue_frame_fused(rec, t, img_dev, scan)
        fe, est = self.fe, self.estimator
        with GLOBAL_TIMERS.timed("tracker"):
            self.tracker_state, obs = _track(
                self.tracker_state, img_dev, t, fe, self.tracker_frames > 0, self.generator,
                dyn_mask=None if mask is None else torch.as_tensor(mask, device=self.device))
            self.tracker_frames += 1
        lidar_q_rel = lidar_p_rel = None
        dep_dev = torch.zeros((self.tracker_cfg.cap,), dtype=torch.float32, device=self.device)
        if scan is not None:
            pts_dev, val_dev = self._scan_dev(scan[1], scan[2])
            with GLOBAL_TIMERS.timed("lidar_odometry"):
                self.lidar_state, (lq, lp, lqr, lpr) = lo.odometry_step(
                    self.lidar_state, pts_dev, val_dev, self.lidar_cfg,
                    frame_count=self.lidar_frames)
                self.lidar_frames += 1
            lidar_q_rel, lidar_p_rel, cloud_cam = _glue(lqr, lpr, pts_dev, fe)
            with GLOBAL_TIMERS.timed("depth_association"):
                dep_dev, _ = depth_association.feature_depth(
                    obs["xy"], obs["valid"], cloud_cam, val_dev, min_incidence=fe.min_incidence)
            rec["scan"] = (lq, lp, pts_dev, val_dev)
        acc_b, gyr_b, dt_b, n_imu = self._imu_for_frame(t)
        tsh_dev = None
        if fe.tsh_scale != 0.0:  # rolling shutter: readout shift TR*(row-ROW/2)/ROW
            tsh_dev = fe.tsh_scale * (obs["uv"][:, 1] - 0.5 * self.rig.image_height)
        with GLOBAL_TIMERS.timed("estimator"):
            out = est.process_frame_device_async(
                acc_b, gyr_b, dt_b, n_imu, obs["ids"], obs["xy"], obs["vel"], dep_dev,
                lidar_q_rel=lidar_q_rel, lidar_p_rel=lidar_p_rel, tsh=tsh_dev)
        return self._capture(rec, out, obs["ids"], dep_dev)

    def _issue_frame_fused(self, rec, t, img_dev, scan):
        """The steady vil frame in one call of `vil_frame` (the reference's
        one-program frame, _vil_frame_program)."""
        est = self.estimator
        _t_s, pts, val = scan
        with GLOBAL_TIMERS.timed("feed_uploads"):
            # quantized scans upload raw (int16 + packed bits), vil_frame
            # dequantizes on the device and returns the f32 cloud
            if getattr(pts, "dtype", None) == np.int16:
                pts_dev = torch.from_numpy(pts).to(self.device)
                val_dev = torch.from_numpy(val).to(self.device)
            else:
                pts_dev, val_dev = self._scan_dev(pts, val)
            acc_b, gyr_b, dt_b, n_imu = self._imu_for_frame(t)
        with GLOBAL_TIMERS.timed("vil_fused_frame"):
            (self.tracker_state, self.lidar_state, est.window, est.feats, est.pre, est.lidar,
             est.prior, out, front) = vil_frame(
                self.tracker_state, self.lidar_state, est.window, est.feats, est.pre,
                est.lidar, est.prior, img_dev, pts_dev, val_dev, acc_b, gyr_b, dt_b, n_imu,
                t, self.fe, self.est_cfg, frame_index=self.lidar_frames,
                generator=self.generator)
        self.tracker_frames += 1
        self.lidar_frames += 1
        est.fused_steps += 1
        est.last_is_key = out["is_key"]
        rec["scan"] = (front["lidar_q"], front["lidar_p"], front["pts"], front["val"])
        return self._capture(rec, out, front["ids"], front["depth"])

    def _capture(self, rec, out, obs_ids, obs_dep):
        """Keep the issued frame's state snapshot (newest frame slid to slot
        K - 2; no tensor of it is written in place later) and start the host
        copies its completion reads."""
        w = self.estimator.window
        slot = est_mod.K - 2
        rec.update(window=w, feats=self.estimator.feats)
        fetch = [out["p"], out["q"], out["v"], out["cost"], out["failed"],
                 w.ba[slot], w.bg[slot], obs_ids, obs_dep]
        if rec["scan"] is not None:
            fetch += [rec["scan"][0], rec["scan"][1]]
        rec["fetch"], rec["event"] = _fetch_async(fetch)
        return rec

    def _complete_frame(self, rec):
        """Deferred host-side half of a frame: wait for its copies, then
        failure handling, global fusion, the visual loop, outputs."""
        if rec["event"] is not None:
            rec["event"].synchronize()
        host = [h.numpy() for h in rec["fetch"]]
        p_est, q_est, v_est = host[0], host[1], host[2]
        if rec["gen"] == self._gen:
            if self._init_t is None:
                self._init_t = rec["t"]  # the deferred path implies initialized
            self.estimator.absorb_result(host[3], host[4])
            if self.estimator.failed:
                # failureDetection reboot, sync_depth frames late (the
                # reference's detection is equally asynchronous)
                self._restart()
            else:
                self._reset_high_rate_from(rec["t"], p_est, q_est, v_est, host[5], host[6])
        live = rec["gen"] == self._gen  # _restart above bumps it

        # global fusion is lidar-driven and survives estimator restarts
        if rec["scan"] is not None:
            self._lidar_pose = (host[9], host[10])
            if self.fusion is not None:
                with GLOBAL_TIMERS.timed("global_fusion"):
                    self.fusion.add_frame(host[9], host[10], rec["scan"][2], rec["scan"][3],
                                          t=rec["t"])

        # the snapshot predates any loop drift accepted while the frame was
        # in flight: apply it
        if rec["drift_R"] is not None:
            R_d0, t_d0 = rec["drift_R"], rec["drift_t"]
            p_est = R_d0 @ p_est + t_d0
            q_est = _np_R2q(R_d0 @ _np_q2R(q_est))

        if (self.visual_loop is not None and live
                and self.estimator.initialized and not self.estimator.failed):
            p_est, q_est = self._drain_vl_results(p_est, q_est)
            # gate on the main thread (host floats only), at most one job at
            # a time: the reference's process() thread consumes keyframes
            # serially and drops to the newest while busy
            gap = self.visual_loop.cfg.keyframe_gap
            if (self._vl_idle.is_set() and self._vl_jobs.empty()
                    and (self._last_kf_p is None
                         or np.linalg.norm(p_est - self._last_kf_p) >= gap)):
                self._vl_idle.clear()
                self._vl_jobs.put(dict(
                    gen=self._gen, img=rec["img"], p_est=p_est, q_est=q_est,
                    window=rec["window"], feats=rec["feats"],
                    pre_drift=(rec["drift_R"], rec["drift_t"]), fresh=(host[7], host[8]),
                    scan=None if rec["scan"] is None else (rec["scan"][2], rec["scan"][3])))
                self._last_kf_p = np.asarray(p_est)

        self._append_outputs(rec["t"], p_est, q_est, True, self._lidar_pose)
        return p_est, q_est

    # -- the synchronous frame -------------------------------------------
    def _process_frame_sync(self, t, img, mask, scan):
        """One camera frame (with its paired scan in "vil"): tracker, lidar
        odometry, extrinsic glue, depth association, IMU segment, estimator
        (fused_full_step once initialized with a full window), global fusion,
        restart on failure, the visual loop, outputs. Returns the frame's
        (p, q)."""
        fe, est, dev = self.fe, self.estimator, self.device
        img_dev = self._image_dev(img)
        # 1. visual tracking
        with GLOBAL_TIMERS.timed("tracker"):
            self.tracker_state, obs = _track(
                self.tracker_state, img_dev, t, fe, self.tracker_frames > 0, self.generator,
                dyn_mask=None if mask is None else torch.as_tensor(mask, device=dev))
            self.tracker_frames += 1

        # 2-4. lidar odometry, extrinsic glue, depth association
        lidar_q_rel = lidar_p_rel = None
        dep_dev = torch.zeros((self.tracker_cfg.cap,), dtype=torch.float32, device=dev)
        pts_dev = val_dev = None
        if scan is not None:
            pts_dev, val_dev = self._scan_dev(scan[1], scan[2])
            with GLOBAL_TIMERS.timed("lidar_odometry"):
                self.lidar_state, (lq, lp, lqr, lpr) = lo.odometry_step(
                    self.lidar_state, pts_dev, val_dev, self.lidar_cfg,
                    frame_count=self.lidar_frames)
                self.lidar_frames += 1
            lidar_q_rel, lidar_p_rel, cloud_cam = _glue(lqr, lpr, pts_dev, fe)
            with GLOBAL_TIMERS.timed("depth_association"):
                dep_dev, _ = depth_association.feature_depth(
                    obs["xy"], obs["valid"], cloud_cam, val_dev, min_incidence=fe.min_incidence)

        # 5. IMU segment (full-interval spanning, boundary-sample reuse) and
        #    the estimator: tracker outputs are fixed-capacity device tensors
        #    and the estimator's obs_cap is the tracker cap, so nothing is
        #    repacked
        acc_b, gyr_b, dt_b, n_imu = self._imu_for_frame(t)
        tsh_dev = None
        if fe.tsh_scale != 0.0:  # rolling shutter: readout shift TR*(row-ROW/2)/ROW
            tsh_dev = fe.tsh_scale * (obs["uv"][:, 1] - 0.5 * self.rig.image_height)
        with GLOBAL_TIMERS.timed("estimator"):
            p_est, q_est, _ = est.process_frame_device(
                acc_b, gyr_b, dt_b, n_imu, obs["ids"], obs["xy"], obs["vel"], dep_dev,
                lidar_q_rel=lidar_q_rel, lidar_p_rel=lidar_p_rel, tsh=tsh_dev)

        if scan is not None:
            qp = torch.cat([lq, lp]).cpu().numpy()
            self._lidar_pose = (qp[:4], qp[4:])
            with GLOBAL_TIMERS.timed("global_fusion"):
                self.fusion.add_frame(qp[:4], qp[4:], pts_dev, val_dev, t=t)
        if est.failed:
            self._restart()  # failureDetection reboot (estimator.cpp:212-219)
        elif est.initialized:
            if self._init_t is None:
                self._init_t = t
            self._reset_high_rate(t)

        # 6. visual loop closure: keyframe-gated BRIEF / BoW detection + PnP
        #    verification + 4-DoF graph + relocalization feedback
        est = self.estimator
        if (self.visual_loop is not None and est.initialized
                and est.frame_count >= est_mod.K - 1):
            drift = self._visual_loop_step(
                img_dev, p_est, q_est,
                fresh=(obs["ids"].cpu().numpy(), dep_dev.cpu().numpy()),
                scan=None if scan is None else (pts_dev, val_dev))
            if drift is not None:
                p_est, q_est = self._apply_reloc_drift(drift, p_est, q_est)

        self._append_outputs(t, p_est, q_est, bool(est.initialized), self._lidar_pose)
        return p_est, q_est

    # -- the visual loop -------------------------------------------------
    def _vl_worker(self):
        """The visual-loop worker (the pose_graph node's process() thread).
        It issues on the default stream, as the main thread does, so its
        kernels are ordered after the frames whose snapshots it reads; its
        jobs are timed, and its kNN launches counted, under the stage
        "visual_loop"."""
        from vil_fusion_tpu_torch.ops.cuda import knn_cuda

        with knn_cuda.launch_stage("visual_loop"):
            while True:
                job = self._vl_jobs.get()
                try:
                    with GLOBAL_TIMERS.timed("visual_loop"):
                        drift = self._visual_loop_step(
                            job["img"], job["p_est"], job["q_est"], window=job["window"],
                            feats=job["feats"], pre_drift=job["pre_drift"],
                            fresh=job["fresh"], scan=job["scan"], gate=False)
                    if drift is not None:
                        self._vl_results.put((job["gen"], drift))
                except Exception as e:  # never kill the pipeline from the worker
                    self.vl_errors += 1
                    traceback.print_exc()
                    print(f"visual-loop worker error (continuing): {e}", flush=True)
                finally:
                    self._vl_idle.set()

    def _drain_vl_results(self, p_est, q_est):
        """Apply every drift the worker produced since the last frame,
        skipping any computed against a pre-restart estimator."""
        while not self._vl_results.empty():
            gen, drift = self._vl_results.get()
            if gen == self._gen:
                p_est, q_est = self._apply_reloc_drift(drift, p_est, q_est)
        return p_est, q_est

    def _apply_reloc_drift(self, drift, p_est, q_est):
        """Relocalization feedback (setReloFrame :1188-1206 + relo factors
        :799-836): re-anchor the VIO window, the high-rate propagator and
        every in-flight frame record into the loop-corrected frame."""
        R_d, t_d = drift
        self.estimator.apply_drift(R_d, t_d)
        p_est = R_d @ p_est + t_d
        q_est = _np_R2q(R_d @ _np_q2R(q_est))
        for pr in self._pending:
            if pr["drift_R"] is None:
                pr["drift_R"], pr["drift_t"] = R_d.copy(), t_d.copy()
            else:
                pr["drift_R"] = R_d @ pr["drift_R"]
                pr["drift_t"] = R_d @ pr["drift_t"] + t_d
        if self._hr is not None:
            hr = self._hr
            hr["p"] = R_d @ hr["p"] + t_d
            hr["q"] = _np_R2q(R_d @ _np_q2R(hr["q"]))
            hr["v"] = R_d @ hr["v"]
        if self._last_kf_p is not None:
            self._last_kf_p = R_d @ self._last_kf_p + t_d
        return p_est, q_est

    def _visual_loop_step(self, img, p_est, q_est, window=None, feats=None,
                          pre_drift=(None, None), fresh=None, scan=None, gate=True):
        """Keyframe insert (gated) + detection + verification + 4-DoF drift
        update (pose_graph node process() + optimize4DoF).

        window / feats: the estimator snapshot taken when the frame was
        issued (deferred path), by default the live estimator state.
        pre_drift: loop drift accepted while the snapshot was in flight (its
        landmarks are still in the pre-drift frame; p_est / q_est arrive
        corrected). fresh: (ids, depths) of this frame's observations.

        Returns None, or the accepted loop's (R_d, t_d) yaw + translation
        drift for relocalization feedback into the estimator window."""
        with self._vl_step_lock:
            return self._visual_loop_locked(img, p_est, q_est, window, feats, pre_drift,
                                            fresh, scan, gate)

    def _visual_loop_locked(self, img, p_est, q_est, window, feats, pre_drift, fresh, scan,
                            gate):
        db = self.visual_loop
        gap = db.cfg.keyframe_gap  # SKIP_DIS analog
        if gate and self._last_kf_p is not None and np.linalg.norm(p_est - self._last_kf_p) < gap:
            return None
        est = self.estimator
        window = est.window if window is None else window
        feats = est.feats if feats is None else feats
        # the frame step already slid the window: the newest frame's
        # observations and state are at slot K - 2
        pts_w_all, obs_all, ids, valid, observed = est_mod.landmarks_world(
            window, feats, est_mod.K - 2)
        host = torch.cat([pts_w_all.double(), obs_all.double(), ids[:, None].double(),
                          valid[:, None].double(), observed[:, None].double()],
                         dim=1).cpu().numpy()  # one read; float64 holds the ids exactly
        pts_w_all, obs_all = host[:, 0:3].astype(np.float32), host[:, 3:5].astype(np.float32)
        ids_all, valid, observed = host[:, 5].astype(np.int64), host[:, 6] > 0, host[:, 7] > 0
        if pre_drift[0] is not None:
            pts_w_all = pts_w_all @ pre_drift[0].T + pre_drift[1]
        # prefer THIS frame's lidar depths for the exported landmarks: anchor
        # inverse depths decay through marginalization handovers, a fresh
        # depth is rigidly consistent with the keyframe pose; features seen
        # now with a fresh depth but no estimator depth are exported too
        has_fresh = np.zeros(len(ids_all), bool)
        if fresh is not None:
            fids, fdep = fresh
            fok = (fids >= 0) & (fdep > 0)
            lut = {int(i): float(d) for i, d in zip(fids[fok], fdep[fok])}
            z = np.array([lut.get(int(i), -1.0) for i in ids_all], np.float32)
            has_fresh = observed & (z > 0)
            if has_fresh.any():
                R_wb = _np_q2R(np.asarray(q_est, np.float64))
                R_wc = R_wb @ _np_q2R(np.asarray(self.rig.q_ic, np.float64))
                p_wc = R_wb @ np.asarray(self.rig.t_ic, np.float64) + p_est
                rays = np.concatenate([obs_all[has_fresh],
                                       np.ones((int(has_fresh.sum()), 1), np.float32)], -1)
                pts_w_all[has_fresh] = (rays * z[has_fresh, None]) @ R_wc.T + p_wc
        export = valid | has_fresh
        # exportable window landmarks a keyframe: the Hamming gate needs
        # >= MIN_LOOP_NUM matches of these
        db.stats.setdefault("win_landmarks", []).append(int(export.sum()))
        if export.sum() < 10:
            db.stats["skip_few_landmarks"] = db.stats.get("skip_few_landmarks", 0) + 1
            return None
        pts_w = pts_w_all[export]
        obs_xy = obs_all[export].astype(np.float32)
        # pixel coordinates of the observations, for their descriptors
        px = cam_mod.project(self.fe.cam, torch.from_numpy(
            np.concatenate([obs_xy, np.ones((len(obs_xy), 1), np.float32)], -1))).numpy()
        # this frame's camera-frame cloud: lidar-depthed extra corners become
        # more 3-D anchors (VisualLoopDB.add_keyframe)
        cloud_cam = cloud_val = None
        if scan is not None:
            cloud_cam = lie.qrot(self.fe.q_cl[None, :], scan[0]) + self.fe.t_cl[None, :]
            cloud_val = scan[1]
        i_cur = db.add_keyframe(img, q_est, p_est, pts_w, px, np.ones(len(px), bool),
                                self.fe.cam, sequence=self.sequence,
                                cloud_cam=cloud_cam, cloud_valid=cloud_val)
        if i_cur is None:
            return None  # keyframe DB full
        if gate:
            self._last_kf_p = np.asarray(p_est)  # gate on a successful insert
        hit = db.detect_and_verify(i_cur)
        if hit is None:
            return None
        cand, q_rel, p_rel = hit
        graph_before = db.graph
        # the main thread reads db.q / db.p for its frames' keyframe anchors
        with self._vl_lock:
            db.close_loop(i_cur, cand, q_rel, p_rel)
            # drift: corrected keyframe pose against its VIO pose (:552-574)
            dyaw, R_d, t_d = pg4.drift_transform(graph_before, db.graph, i_cur)
            R_d, t_d = R_d.cpu().numpy(), t_d.cpu().numpy()
            # move the insert-time (VIO-frame) records into the corrected
            # frame (the estimator is about to be re-anchored by the same
            # transform), then pull the optimized poses into the store
            db.apply_drift_to_vio(R_d, float(dyaw), t_d)
            db.sync_from_graph()
        # with relocalization feedback the window itself is re-anchored, so no
        # residual display drift remains
        self.loop_drift_R = np.eye(3, dtype=np.float32)
        self.loop_drift_t = np.zeros(3, np.float32)
        return R_d, t_d
