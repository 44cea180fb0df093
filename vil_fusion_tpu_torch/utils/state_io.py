"""Carry SLAM state between the reference (vil_fusion_tpu) and the port.

The system has no learned weights: its odometry maps, pose graph,
ScanContext database and keyframe cloud store are what two runs have to
agree on (and, with the visual front end, the tracker's slot store and the
camera parameters). These helpers turn state given as numpy arrays (the JAX package's
NamedTuples convert with np.asarray, so no jax import is needed here) into
the port's tensors on a given device, and back.
"""
from __future__ import annotations

import numpy as np
import torch

from vil_fusion_tpu_torch.models import cameras
from vil_fusion_tpu_torch.models import global_fusion as gf
from vil_fusion_tpu_torch.models.posegraph import PoseGraph
from vil_fusion_tpu_torch.models.scancontext import ScanContextDB


def _np(v):
    """Array (numpy, jax or torch) -> a numpy copy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v)


def to_numpy(state) -> dict:
    """NamedTuple of arrays (numpy, jax or torch) -> {field: numpy array}."""
    return {k: _np(v) for k, v in state._asdict().items()}


def to_torch(cls, arrays, device="cuda"):
    """{field: array} (or a NamedTuple of arrays) -> cls of tensors on
    `device`; dtypes are kept (float32, int32, bool). E.g.
    `to_torch(lidar_odometry.MapState, to_numpy(jax_state))`, or
    `to_torch(tracker.TrackerState, to_numpy(jax_tracker_state))`."""
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    return cls(**{k: torch.from_numpy(np.array(arrays[k])).to(device) for k in cls._fields})


def camera_to_torch(cam):
    """Camera parameters of either package (a NamedTuple of Python numbers
    and tuples, named PinholeCamera, MeiCamera, EquidistantCamera or
    ScaramuzzaCamera) -> the port's camera model of the same name. The
    models hold no tensors, so there is no device to choose."""
    cls = getattr(cameras, type(cam).__name__)
    return cls(**{f: (tuple(float(x) for x in v) if isinstance(v, (tuple, list, np.ndarray))
                      else float(v))
                  for f, v in cam._asdict().items()})


_FUSION_HOST = ("kf_q_odom", "kf_p_odom", "kf_ts", "n_kf", "last_q", "last_p",
                "loops_found", "_pending_opt")


def global_fusion_to_numpy(fusion) -> dict:
    """Buffers + host bookkeeping of a GlobalFusion (either package's) as
    numpy arrays and plain Python values. In-flight loop queries are not
    carried: flush() the source first."""
    return dict(
        graph=to_numpy(fusion.graph), scdb=to_numpy(fusion.scdb),
        clouds=_np(fusion.clouds), cloud_valid=_np(fusion.cloud_valid),
        **{k: _host_copy(getattr(fusion, k)) for k in _FUSION_HOST})


def _host_copy(v):
    if isinstance(v, list):
        return [_host_copy(x) for x in v]
    if v is None or isinstance(v, (int, float, tuple)):
        return v
    return _np(v)


def global_fusion_load(fusion: gf.GlobalFusion, arrays: dict) -> gf.GlobalFusion:
    """Overwrite a port GlobalFusion's state with `arrays` (as produced by
    global_fusion_to_numpy), placing tensors on the fusion's device."""
    dev = fusion.device
    fusion.graph = to_torch(PoseGraph, arrays["graph"], dev)
    fusion.scdb = to_torch(ScanContextDB, arrays["scdb"], dev)
    fusion.clouds = torch.from_numpy(np.array(arrays["clouds"])).to(dev)
    fusion.cloud_valid = torch.from_numpy(np.array(arrays["cloud_valid"])).to(dev)
    for k in _FUSION_HOST:
        setattr(fusion, k, _host_copy(arrays[k]))
    fusion._pending_sc = []
    fusion._pending_icp = []
    return fusion
