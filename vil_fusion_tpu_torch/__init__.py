"""vil_fusion_tpu_torch — PyTorch + CUDA port of vil_fusion_tpu.

Ported so far: the pipeline's "vil" (camera + IMU + LiDAR) and "vio" modes,
synchronously (sync_depth=0), and its LiDAR-only mode ("lidar": feature
extraction, scan-to-map odometry with all its options, global fusion with
ScanContext, ICP loop verification and pose graph). The vil frame is the
front end (`runtime.pipeline.vil_front_end`: tracker, lidar odometry,
extrinsic glue, depth association) and the estimator's fused step
(`models.estimator.fused_full_step`: IMU preintegration, feature ingest,
triangulation, bundle adjustment, marginalization, window slide), with the
cold-start initialization. The kNN kernels (grouped, exact and sparse
Morton, `csrc/knn.cu`, bound in `ops/cuda/knn_cuda.py`) are hand-written
CUDA; everything else is plain PyTorch. Module layout and names mirror
`vil_fusion_tpu`, which stays the reference. This package imports torch
and numpy, never jax. Entry points place their tensors on `device="cuda"`
unless the caller asks for another device.
"""

__version__ = "0.1.0"

import torch as _torch

# Precision policy (mirror of vil_fusion_tpu/__init__.py, which forces
# float32 matmuls on the TPU): TF32 keeps ~3 decimal digits, which corrupts
# the expanded-form kNN distances |q|^2 + |d|^2 - 2 q.d (the TPU's bf16
# default lost ~0.5 m^2 there) and the Gauss-Newton / pose-graph solves.
# Both flags are process-wide, set once at import.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from vil_fusion_tpu_torch.runtime.config import RigConfig, load_rig  # noqa: E402,F401


def make_pipeline(rig_path: str, mode: str = "vil", **kw):
    """Load a rig YAML and build the pipeline (modes "vil", "vio", "lidar")."""
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    return VILFusionPipeline(load_rig(rig_path), mode=mode, **kw)
