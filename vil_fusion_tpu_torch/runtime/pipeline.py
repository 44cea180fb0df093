"""The VIL-Fusion pipeline, LiDAR-only slice: scans in, trajectories out.

Port of the `mode="lidar"` path of vil_fusion_tpu/runtime/pipeline.py (the
reference's F-LOAM + SC-A-LOAM executable): every pushed scan runs one
lidar-odometry step (feature extraction, scan-to-map Gauss-Newton, map
update) and feeds global fusion (keyframes, ScanContext loops, ICP
verification, pose graph). The other modes ("vil", "vio", "mask") need the
estimator and visual front end, which are not ported yet, and raise.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from vil_fusion_tpu_torch.models import global_fusion as gf
from vil_fusion_tpu_torch.models import lidar_features as lf
from vil_fusion_tpu_torch.models import lidar_odometry as lo
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
    (LiDAR-only odometry + global fusion) is ported; the others raise
    NotImplementedError.

    `device` places every state tensor (maps, pose graph, ScanContext
    database, keyframe clouds); scans are uploaded to it in push_scan."""

    def __init__(self, rig: RigConfig, mode: str = "lidar", sc_capacity: int = 1024,
                 gf_cfg: Optional[gf.GlobalFusionConfig] = None,
                 odom_overrides: Optional[dict] = None, scan_quant: float = 0.0,
                 device="cpu"):
        if mode != "lidar":
            raise NotImplementedError(
                f"mode={mode!r} needs the estimator and visual front end, which "
                f"are not ported yet (ROADMAP.md, modules still to port); "
                f"only mode='lidar' runs")
        self.rig = rig
        self.mode = mode
        self.scan_quant = float(scan_quant)
        self.device = torch.device(device)
        self.lidar_cfg = lo.OdomConfig(
            lidar=lf.LidarConfig(
                n_scan=rig.n_scan, width=1800 if rig.n_scan >= 64 else 900,
                min_range=rig.lidar_min_range, max_range=rig.lidar_max_range,
                fov_up_deg=rig.lidar_fov_up, fov_down_deg=rig.lidar_fov_down))
        if odom_overrides:
            lidar_kw = {k: v for k, v in odom_overrides.items()
                        if k in lf.LidarConfig._fields}
            odom_kw = {k: v for k, v in odom_overrides.items()
                       if k in lo.OdomConfig._fields}
            if lidar_kw:
                odom_kw["lidar"] = self.lidar_cfg.lidar._replace(**lidar_kw)
            self.lidar_cfg = self.lidar_cfg._replace(**odom_kw)
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
