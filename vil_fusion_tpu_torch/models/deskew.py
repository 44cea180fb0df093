"""Point-cloud deskew (spinning-LiDAR motion compensation).

Port of vil_fusion_tpu/models/deskew.py: per-point scan time from azimuth,
constant-velocity motion model from a relative pose over the scan period,
se(3)-interpolated correction to the scan-END frame, all points at once.
"""
from __future__ import annotations

import math

import torch

from vil_fusion_tpu_torch.ops import lie


def deskew_points(points, valid, q_rel, p_rel):
    """Deskew a body-frame scan to its end-of-scan frame.

    points (N, 3): raw points whose azimuth encodes capture time (the sweep
    runs azimuth -pi -> pi over the frame period). q_rel, p_rel: sensor
    motion over the scan period (T_{start -> end}). A point captured at
    fraction s needs the remaining motion applied inversely:
    p_end = exp((s - 1) * log(T_rel)) p. Invalid points pass through."""
    az = torch.atan2(points[:, 1], points[:, 0])
    s = (az + math.pi) / (2.0 * math.pi)  # capture-time fraction in [0, 1)
    xi = lie.se3_log(q_rel, p_rel)  # (6,)
    q_c, p_c = lie.se3_exp((s - 1.0)[:, None] * xi[None, :])
    out = lie.qrot(q_c, points) + p_c
    return torch.where(valid[:, None], out, points)
