"""The VIL-Fusion pipeline: the LiDAR-only mode and the vil frame's front end.

Port of the `mode="lidar"` path of vil_fusion_tpu/runtime/pipeline.py (the
reference's F-LOAM + SC-A-LOAM executable): every pushed scan runs one
lidar-odometry step (feature extraction, scan-to-map Gauss-Newton, map
update) and feeds global fusion (keyframes, ScanContext loops, ICP
verification, pose graph).

`vil_front_end` is the first four of the five steps of the reference's vil
frame program (tracker, lidar odometry, extrinsic glue, depth association):
the reference's feature-tracker process. The fifth step, the estimator, is
not ported yet, so the modes "vil", "vio" and "mask" of the pipeline class
still raise.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from vil_fusion_tpu_torch.models import cameras as cam_mod
from vil_fusion_tpu_torch.models import depth_association
from vil_fusion_tpu_torch.models import global_fusion as gf
from vil_fusion_tpu_torch.models import lidar_features as lf
from vil_fusion_tpu_torch.models import lidar_odometry as lo
from vil_fusion_tpu_torch.models import tracker as trk
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


def vil_front_end(tracker_state: trk.TrackerState, lidar_state: lo.MapState, img, pts, val,
                  t: float, fe: FrontEnd, frame_index: Optional[int] = None,
                  generator: Optional[torch.Generator] = None, sel=None):
    """The vil frame up to the estimator's door: tracker -> lidar odometry
    -> extrinsic glue -> depth association -> rolling-shutter shift (steps
    1-4 of the reference's frame program; the fused estimator step that
    consumes the result is the next slice of the port).

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
    if sel is None:
        if generator is None:
            generator = torch.Generator(device=img.device)
        generator.manual_seed(frame_seed(t))
    started = None if frame_index is None else frame_index > 0
    tracker_state, obs = trk.track_step(tracker_state, img, t, fe.cam, fe.tcfg,
                                        generator=generator, sel=sel, initialized=started)
    lidar_state, (lq, lp, lqr, lpr) = lo.odometry_step(lidar_state, pts, val, fe.lcfg,
                                                       frame_count=frame_index)
    # lidar relative pose through the extrinsics into the IMU frame, and the
    # cloud into the camera frame
    qt, pt = lie.pose_compose((fe.q_il, fe.t_il), (lqr, lpr))
    q_imu, p_imu = lie.pose_compose((qt, pt), (fe.q_li, fe.t_li))
    cloud_cam = lie.qrot(fe.q_cl[None, :], pts) + fe.t_cl[None, :]
    depth, _ = depth_association.feature_depth(obs["xy"], obs["valid"], cloud_cam, val,
                                               min_incidence=fe.min_incidence)
    # rolling-shutter readout shift TR * (row - ROW / 2) / ROW
    tsh = fe.tsh_scale * (obs["uv"][:, 1] - 0.5 * img.shape[0])
    out = dict(ids=obs["ids"], xy=obs["xy"], vel=obs["vel"], depth=depth, tsh=tsh,
               q_imu=q_imu, p_imu=p_imu, valid=obs["valid"], uv=obs["uv"],
               track_cnt=obs["track_cnt"],
               lidar_q=lq, lidar_p=lp, lidar_q_rel=lqr, lidar_p_rel=lpr, pts=pts, val=val)
    return tracker_state, lidar_state, out


@dataclass
class PipelineOutputs:
    ts: list = field(default_factory=list)
    vio_p: list = field(default_factory=list)  # no-loop trajectory
    vio_q: list = field(default_factory=list)
    lidar_p: list = field(default_factory=list)
    lidar_q: list = field(default_factory=list)

    def write(self, out_dir: str, fusion: Optional[gf.GlobalFusion] = None):
        """The reference's TUM outputs of the LiDAR-only mode
        (vins_result_no_loop, lidar_odometry, fs_loam_loop; the visual-loop
        trajectory vins_result_loop comes with the visual loop's port)."""
        os.makedirs(out_dir, exist_ok=True)
        tum.write_tum(os.path.join(out_dir, "vins_result_no_loop.txt"),
                      self.ts, self.vio_p, self.vio_q)
        tum.write_tum(os.path.join(out_dir, "lidar_odometry.txt"),
                      self.ts, self.lidar_p, self.lidar_q)
        if fusion is not None and fusion.n_kf:
            q_all, p_all = fusion.poses()
            tum.write_tum(os.path.join(out_dir, "fs_loam_loop.txt"),
                          fusion.kf_ts, p_all, q_all)


class VILFusionPipeline:
    """Modes of the reference: "vil", "vio", "lidar", "mask". Only "lidar"
    (LiDAR-only odometry + global fusion) is ported; the others need the
    estimator and raise NotImplementedError (their front end is
    `vil_front_end`).

    `device` places every state tensor (maps, pose graph, ScanContext
    database, keyframe clouds); scans are uploaded to it in push_scan."""

    def __init__(self, rig: RigConfig, mode: str = "lidar", sc_capacity: int = 1024,
                 gf_cfg: Optional[gf.GlobalFusionConfig] = None,
                 odom_overrides: Optional[dict] = None, scan_quant: float = 0.0,
                 device="cuda"):
        if mode != "lidar":
            raise NotImplementedError(
                f"mode={mode!r} needs the estimator, which is not ported yet "
                f"(ROADMAP.md, modules still to port); only mode='lidar' runs, and "
                f"vil_front_end() runs the frame up to the estimator")
        self.rig = rig
        self.mode = mode
        self.scan_quant = float(scan_quant)
        self.device = torch.device(device)
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
        self.fusion = gf.GlobalFusion(gf_cfg, device=self.device)

        # host-side queues ("topics")
        self.imu_buf: list = []  # (t, acc, gyr)
        self.scan_buf: list = []
        self.outputs = PipelineOutputs()

    # ------------------------------------------------------------------
    def push_imu(self, t, acc, gyr):
        """Buffer one IMU sample. LiDAR-only odometry does not use it and no
        IMU-rate pose exists in this mode, so this returns None."""
        self.imu_buf.append((float(t), np.asarray(acc), np.asarray(gyr)))
        return None

    def push_imu_batch(self, ts, acc, gyr):
        """Buffer a contiguous IMU segment in one call; returns None."""
        self.imu_buf.extend(zip(np.asarray(ts, np.float64).tolist(),
                                np.asarray(acc, np.float64), np.asarray(gyr, np.float64)))
        return None

    def push_scan(self, t, points, valid):
        """Queue a scan and process it. With scan_quant > 0 a float numpy scan
        is quantized to int16 fixed point (scan_quant metres per step) with
        bit-packed validity before upload, as in the reference."""
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

    def _try_process(self):
        if not self.scan_buf:
            return None
        t, pts, val = self.scan_buf.pop(0)
        return self._process_lidar_only(t, pts, val)

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
        self.outputs.vio_q.append(q_np)  # lidar odometry is always initialized
        return p_np, q_np

    def finalize(self):
        """Resolve the in-flight loop queries and ICP verifications (call
        once at the end of a replay)."""
        self.fusion.flush()
        return None
