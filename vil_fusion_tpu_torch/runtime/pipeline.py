"""The VIL-Fusion pipeline: sensors in, trajectories out.

Port of vil_fusion_tpu/runtime/pipeline.py (the reference's ROS graph as a
single-controller, frame-synchronous pipeline):

  camera ─┐                 ┌─ tracker (KLT+RANSAC) ── features ─┐
  lidar ──┼─ sync (±0.03 s) ┼─ feature extraction + scan-to-map ─┼─ estimator ─ odometry ─ global fusion
  imu ────┘                 └─ depth association (unit sphere) ──┘

Modes "vil" (camera + IMU + LiDAR), "vio" (camera + IMU) and "lidar"
(F-LOAM + SC-A-LOAM: odometry and global fusion only) run, synchronously
(the reference's sync_depth=0): every frame's host consequences (failure
restart, high-rate reseed, global fusion, outputs) happen in that frame.
`vil_front_end` is steps 1-4 of the reference's vil frame program (tracker,
lidar odometry, extrinsic glue, depth association) and `vil_frame` the
whole program with the estimator's fused step. Not ported yet (ROADMAP.md):
mode "mask", the deferred path (sync_depth > 0) and the visual loop.

Failure handling: the estimator's failureDetection triggers a clearState
reboot seeded from the LiDAR odometry pose; a camera-stream gap triggers
the same restart.
"""
from __future__ import annotations

import os
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
    lidar_p: list = field(default_factory=list)
    lidar_q: list = field(default_factory=list)
    # per-frame estimator-initialized flag: the reference publishes VIO
    # odometry only in NON_LINEAR state (pubOdometry, visualization.cpp), so
    # pre-initialization rows are left out of the VIO trajectory
    initialized: list = field(default_factory=list)

    def write(self, out_dir: str, fusion: Optional[gf.GlobalFusion] = None):
        """The reference's TUM outputs: vins_result_no_loop (initialized
        frames only), lidar_odometry and fs_loam_loop. The visual-loop
        trajectory vins_result_loop comes with the visual loop's port."""
        os.makedirs(out_dir, exist_ok=True)
        ini = self.initialized or [True] * len(self.ts)
        sel = [k for k, ok in enumerate(ini) if ok]
        tum.write_tum(os.path.join(out_dir, "vins_result_no_loop.txt"),
                      [self.ts[k] for k in sel], [self.vio_p[k] for k in sel],
                      [self.vio_q[k] for k in sel])
        tum.write_tum(os.path.join(out_dir, "lidar_odometry.txt"),
                      self.ts, self.lidar_p, self.lidar_q)
        if fusion is not None and fusion.n_kf:
            q_all, p_all = fusion.poses()
            tum.write_tum(os.path.join(out_dir, "fs_loam_loop.txt"),
                          fusion.kf_ts, p_all, q_all)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, section 1: modules still to port); the "
        f"modes 'vil', 'vio' (with sync_depth=0) and 'lidar' run")


class VILFusionPipeline:
    """Modes of the reference: "vil" (camera + IMU + LiDAR), "vio" (no
    lidar), "lidar" (LiDAR-only odometry + global fusion) and "mask"
    (dynamic-scene VIO). "vil" and "vio" run synchronously (sync_depth=0:
    each frame's host consequences happen in that frame); "mask",
    sync_depth > 0 and the visual loop raise NotImplementedError.

    `device` places every state tensor (tracker, maps, estimator window,
    pose graph, ScanContext database, keyframe clouds); images and scans are
    uploaded to it as they are pushed."""

    SYNC_WINDOW = 0.03  # camera-lidar pairing (feature_tracker_node.cpp:225)
    CAMERA_GAP_RESTART = 1.0  # stream watchdog (restart path)

    def __init__(self, rig: RigConfig, mode: str = "vil", f_cap: int = 128,
                 sc_capacity: int = 1024, visual_loop: bool = False,
                 gf_cfg: Optional[gf.GlobalFusionConfig] = None,
                 odom_overrides: Optional[dict] = None, sync_depth: int = 0,
                 ba_overrides: Optional[dict] = None, scan_quant: float = 0.0,
                 device="cuda"):
        if mode not in ("vil", "vio", "lidar", "mask"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "mask":
            raise _not_ported("mode='mask' (dynamic-scene VIO with the mask gate)")
        if sync_depth > 0:
            raise _not_ported(f"sync_depth={sync_depth} (the deferred frame program)")
        if visual_loop:
            raise _not_ported("visual_loop=True (the visual loop closure)")
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
            self.fe = front_end_config(rig, f_cap=f_cap, odom_overrides=odom_overrides,
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

        # host-side queues ("topics")
        self.imu_buf: list = []  # (t, acc, gyr)
        self.image_buf: list = []
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
        """Buffer the sample. In "vil" / "vio" returns the IMU-rate pose
        estimate (p, q, v) once the estimator is initialized, else None
        (pubLatestOdometry / predict(), estimator_node.cpp:44-80);
        LiDAR-only odometry has no IMU-rate pose."""
        self.imu_buf.append((float(t), np.asarray(acc), np.asarray(gyr)))
        if self.mode == "lidar":
            return None
        return self._propagate_high_rate(float(t), np.asarray(acc), np.asarray(gyr))

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

    def push_image(self, t, img, mask=None):
        """Queue a camera image (H, W) uint8 or float numpy array and
        process what can be paired. `mask` belongs to mode "mask" (not
        ported) and must be None."""
        if mask is not None:
            raise _not_ported("a dynamic-object mask (mode='mask')")
        # stream watchdog: a long camera gap restarts the estimator
        if self.last_image_t is not None and t - self.last_image_t > self.CAMERA_GAP_RESTART:
            self._restart(cause="camera_gap")
        self.last_image_t = float(t)
        self.image_buf.append((float(t), img))
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

    # ------------------------------------------------------------------
    def _restart(self, cause: str = "estimator_failure"):
        """restart_callback analog (estimator_node.cpp:199-218): flush and
        reinitialize the estimator; tracker and maps survive. In "vil" the
        reboot is seeded from the surviving LiDAR odometry pose, so the
        estimator resumes in the same world frame."""
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
        t_img, img = self.image_buf[0]
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
        return self._process_frame_sync(t_img, img, scan)

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

    def _process_frame_sync(self, t, img, scan):
        """One camera frame (with its paired scan in "vil"): tracker, lidar
        odometry, extrinsic glue, depth association, IMU segment, estimator
        (fused_full_step once initialized with a full window), global fusion,
        restart on failure, outputs. Returns the frame's (p, q)."""
        fe, est, dev = self.fe, self.estimator, self.device
        img_dev = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        if img_dev.dtype == torch.float64:
            img_dev = img_dev.to(torch.float32)
        # 1. visual tracking
        with GLOBAL_TIMERS.timed("tracker"):
            self.tracker_state, obs = _track(self.tracker_state, img_dev, t, fe,
                                             self.tracker_frames > 0, self.generator)
            self.tracker_frames += 1

        # 2-4. lidar odometry, extrinsic glue, depth association
        lidar_q_rel = lidar_p_rel = None
        depth = None
        if scan is not None:
            _t_s, pts, val = scan
            pts_dev, val_dev = self._scan_dev(pts, val)
            with GLOBAL_TIMERS.timed("lidar_odometry"):
                self.lidar_state, (lq, lp, lqr, lpr) = lo.odometry_step(
                    self.lidar_state, pts_dev, val_dev, self.lidar_cfg,
                    frame_count=self.lidar_frames)
                self.lidar_frames += 1
            lidar_q_rel, lidar_p_rel, cloud_cam = _glue(lqr, lpr, pts_dev, fe)
            with GLOBAL_TIMERS.timed("depth_association"):
                depth, _ = depth_association.feature_depth(
                    obs["xy"], obs["valid"], cloud_cam, val_dev,
                    min_incidence=fe.min_incidence)

        # 5. IMU segment (full-interval spanning, boundary-sample reuse) and
        #    the estimator: tracker outputs are fixed-capacity device tensors
        #    and the estimator's obs_cap is the tracker cap, so nothing is
        #    repacked
        acc, gyr, dts = self._imu_segment_for_frame(t)
        acc_b, gyr_b, dt_b, n_imu = est._pack_imu(acc, gyr, dts)
        dep_dev = depth if depth is not None else torch.zeros(
            (self.tracker_cfg.cap,), dtype=torch.float32, device=dev)
        tsh_dev = None
        if fe.tsh_scale != 0.0:  # rolling shutter: readout shift TR*(row-ROW/2)/ROW
            tsh_dev = fe.tsh_scale * (obs["uv"][:, 1] - 0.5 * self.rig.image_height)
        f32 = dict(dtype=torch.float32, device=dev)
        with GLOBAL_TIMERS.timed("estimator"):
            p_est, q_est, _ = est.process_frame_device(
                torch.as_tensor(acc_b, **f32), torch.as_tensor(gyr_b, **f32),
                torch.as_tensor(dt_b, **f32), n_imu, obs["ids"], obs["xy"], obs["vel"],
                dep_dev, lidar_q_rel=lidar_q_rel, lidar_p_rel=lidar_p_rel, tsh=tsh_dev)

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

        self.outputs.ts.append(t)
        self.outputs.vio_p.append(p_est)
        self.outputs.vio_q.append(q_est)
        self.outputs.initialized.append(bool(self.estimator.initialized))
        self.outputs.lidar_q.append(self._lidar_pose[0])
        self.outputs.lidar_p.append(self._lidar_pose[1])
        self.last_processed_t = t
        return p_est, q_est

    def finalize(self):
        """Resolve the in-flight loop queries and ICP verifications (call
        once at the end of a replay)."""
        if self.fusion is not None:
            self.fusion.flush()
        return None
