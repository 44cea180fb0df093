"""TUM-format trajectory IO + ATE evaluation.

The reference writes three TUM trajectories for offline comparison (C17):
VIO-only `vins_result_no_loop.txt` (parameters.cpp:64-71), loop-corrected
`vins_result_loop.txt` (pose_graph.cpp:153-170), global `fs_loam_loop.txt`
(poseGraphOptimization.cpp:85-107,253-290). This module provides the writers
plus the evo-style ATE evaluation the reference leaves to external tools.
"""
from __future__ import annotations

import numpy as np


def write_tum(path: str, ts, ps, qs):
    """qs in (w, x, y, z); TUM wants (x, y, z, qx, qy, qz, qw)."""
    with open(path, "w") as f:
        for t, p, q in zip(ts, ps, qs):
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def read_tum(path: str):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    ts = data[:, 0]
    ps = data[:, 1:4]
    qs = np.stack([data[:, 7], data[:, 4], data[:, 5], data[:, 6]], axis=-1)
    return ts, ps, qs


def umeyama_alignment(x, y, with_scale: bool = False):
    """Least-squares similarity transform aligning x -> y (evo-style SE(3)/
    Sim(3) alignment for ATE)."""
    mu_x = x.mean(0)
    mu_y = y.mean(0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / len(x)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = (np.trace(np.diag(S) @ D) / (xc**2).sum() * len(x)) if with_scale else 1.0
    t = mu_y - s * R @ mu_x
    return R, t, s


def ate_rmse(ps_est, ps_gt, align: bool = True, with_scale: bool = False):
    """Absolute trajectory error RMSE after (optional) alignment."""
    ps_est = np.asarray(ps_est, np.float64)
    ps_gt = np.asarray(ps_gt, np.float64)
    if align:
        R, t, s = umeyama_alignment(ps_est, ps_gt, with_scale)
        ps_est = (s * (R @ ps_est.T)).T + t
    err = np.linalg.norm(ps_est - ps_gt, axis=-1)
    return float(np.sqrt((err**2).mean()))


def associate(ts_a, ts_b, max_dt: float = 0.02):
    """Timestamp association (TUM associate.py behavior): nearest pairing."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        while j + 1 < len(ts_b) and abs(ts_b[j + 1] - t) <= abs(ts_b[j] - t):
            j += 1
        if abs(ts_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia), np.asarray(ib)
