"""Config system: per-rig YAML -> frozen config objects.

Rebuild of the reference's two-tier config (C16):
  * OpenCV-FileStorage YAML per rig (vins_estimator/parameters.cpp:45-155,
    feature_tracker/parameters.cpp:40-95): topics, camera model/intrinsics,
    camera-IMU extrinsics, tracker params, solver budgets, IMU noise, td.
  * rosparam second YAML for LiDAR/ScanContext/keyframe params
    (config/kitti/velodyne_param_64.yaml, read at featureExtraction.hpp:43-52,
    poseGraphOptimization.cpp:634-658).

Here both collapse into one YAML per rig under configs/, parsed into the
typed configs of each subsystem.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

try:
    import yaml  # optional; the subset reader below covers the rig files

    _HAVE_YAML = True
except Exception:  # pragma: no cover
    _HAVE_YAML = False


def _simple_yaml_load(text: str) -> dict:
    """Minimal YAML subset fallback (scalars, nested dicts, flat lists)."""
    root: dict = {}
    stack = [(-1, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.lstrip().partition(":")
        while stack and indent <= stack[-1][0] and len(stack) > 1:
            stack.pop()
        parent = stack[-1][1]
        val = val.strip()
        if not val:
            child: dict = {}
            parent[key] = child
            stack.append((indent, child))
        else:
            if val.startswith("["):
                parent[key] = [float(x) for x in val.strip("[]").split(",") if x.strip()]
            else:
                try:
                    parent[key] = int(val)
                except ValueError:
                    try:
                        parent[key] = float(val)
                    except ValueError:
                        parent[key] = val.strip("'\"")
    return root


def load_yaml(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    if _HAVE_YAML:
        return yaml.safe_load(text)
    return _simple_yaml_load(text)


@dataclass(frozen=True)
class RigConfig:
    """One sensor rig (the reference ships kitti/euroc/daheng/iphone/mynteye)."""

    name: str
    camera: dict  # camera model dict (cameras.from_config)
    image_height: int
    image_width: int
    # camera-IMU extrinsic (R_ic rows, t_ic) — extrinsicRotation/Translation
    q_ic: np.ndarray
    t_ic: np.ndarray
    # camera-LiDAR extrinsic (LIDAR_CAMERA_EX)
    q_cl: Optional[np.ndarray] = None
    t_cl: Optional[np.ndarray] = None
    # IMU noise (acc_n, gyr_n, acc_w, gyr_w)
    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 4e-5
    gyr_w: float = 2e-6
    g_norm: float = 9.81
    # tracker
    max_cnt: int = 150
    min_dist: int = 30
    freq: int = 10
    f_threshold: float = 1.0
    equalize: bool = False
    # estimator budgets
    max_solver_time: float = 0.04
    max_num_iterations: int = 8
    keyframe_parallax: float = 10.0  # pixels at FOCAL 460
    estimate_extrinsic: bool = False
    estimate_td: bool = False
    td: float = 0.0
    rolling_shutter: bool = False  # parameters.cpp ROLLING_SHUTTER
    tr: float = 0.0  # rolling-shutter readout time (s), parameters.cpp TR
    use_lidar: bool = True
    # depth association: minimum |cos(view ray, surface normal)| for a lidar
    # depth to be held CONSTANT in BA (the reference's
    # SetParameterBlockConstant semantics); below it the depth only
    # initializes the inverse depth (grazing depths are bias-prone — see
    # models/depth_association.py). A sensor-geometry property: lower it for
    # small indoor rigs whose triangulation is weak and surfaces close.
    depth_min_incidence: float = 0.1
    # lidar
    n_scan: int = 64
    lidar_fov_up: float = 2.0
    lidar_fov_down: float = -24.8
    lidar_min_range: float = 3.0
    lidar_max_range: float = 90.0
    # global fusion
    keyframe_meter_gap: float = 2.0
    keyframe_deg_gap: float = 10.0
    sc_dist_thres: float = 0.2
    # misc
    raw: dict = field(default_factory=dict)


def _rotmat_to_q(R):
    from vil_fusion_tpu_torch.runtime.sim import R_to_q

    return R_to_q(np.asarray(R, np.float64).reshape(3, 3))


def load_rig(path: str) -> RigConfig:
    d = load_yaml(path)
    name = d.get("name", "unnamed")
    cam = d.get("camera", d)
    ex = d.get("extrinsic", {})
    R_ic = np.asarray(ex.get("extrinsicRotation", np.eye(3).ravel().tolist()),
                      np.float64).reshape(3, 3)
    t_ic = np.asarray(ex.get("extrinsicTranslation", [0.0, 0.0, 0.0]), np.float64)
    q_cl = t_cl = None
    if "lidar_camera_rotation" in ex:
        R_cl = np.asarray(ex["lidar_camera_rotation"], np.float64).reshape(3, 3)
        q_cl = _rotmat_to_q(R_cl)
        t_cl = np.asarray(ex.get("lidar_camera_translation", [0, 0, 0]), np.float64)
    imu = d.get("imu", {})
    trk = d.get("tracker", {})
    est = d.get("estimator", {})
    lid = d.get("lidar", {})
    gfu = d.get("global_fusion", {})
    return RigConfig(
        name=name, camera=cam,
        image_height=int(d.get("image_height", cam.get("image_height", 480))),
        image_width=int(d.get("image_width", cam.get("image_width", 752))),
        q_ic=_rotmat_to_q(R_ic), t_ic=t_ic, q_cl=q_cl, t_cl=t_cl,
        acc_n=float(imu.get("acc_n", 0.08)), gyr_n=float(imu.get("gyr_n", 0.004)),
        acc_w=float(imu.get("acc_w", 4e-5)), gyr_w=float(imu.get("gyr_w", 2e-6)),
        g_norm=float(imu.get("g_norm", 9.81)),
        max_cnt=int(trk.get("max_cnt", 150)), min_dist=int(trk.get("min_dist", 30)),
        freq=int(trk.get("freq", 10)), f_threshold=float(trk.get("F_threshold", 1.0)),
        equalize=bool(trk.get("equalize", False)),
        max_solver_time=float(est.get("max_solver_time", 0.04)),
        max_num_iterations=int(est.get("max_num_iterations", 8)),
        keyframe_parallax=float(est.get("keyframe_parallax", 10.0)),
        estimate_extrinsic=bool(est.get("estimate_extrinsic", False)),
        estimate_td=bool(est.get("estimate_td", False)),
        td=float(est.get("td", 0.0)),
        rolling_shutter=bool(est.get("rolling_shutter", False)),
        tr=float(est.get("rolling_shutter_tr", est.get("tr", 0.0))),
        use_lidar=bool(est.get("use_lidar", True)),
        n_scan=int(lid.get("n_scan", 64)),
        lidar_fov_up=float(lid.get("fov_up", 2.0)),
        lidar_fov_down=float(lid.get("fov_down", -24.8)),
        lidar_min_range=float(lid.get("min_range", 3.0)),
        lidar_max_range=float(lid.get("max_range", 90.0)),
        keyframe_meter_gap=float(gfu.get("keyframe_meter_gap", 2.0)),
        keyframe_deg_gap=float(gfu.get("keyframe_deg_gap", 10.0)),
        sc_dist_thres=float(gfu.get("sc_dist_thres", 0.2)),
        raw=d,
    )
