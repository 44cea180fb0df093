#!/usr/bin/env python3
"""Host cost of the port's estimator components, on the CPU.

    python tools/estimator_host_cost.py [--f-cap 128] [--obs-cap 192] [--threads 1]

Runs an oracle-initialized VILEstimator (device "cpu") over K + 1 frames of
the simulator's landmark world (the bundles of tests/test_torch_cuda.py),
then times each component of the steady frame on its state and counts the
operations it runs (torch.profiler, CPU activity): the 64-sample
preintegration, the three factor families' blocks with and without their
jacfwd Jacobians, build_system, total_cost, the 8-iteration optimize,
marginalize_old, slide_new. Also counts the operations of the IMU and
projection blocks that run through `prims::` decompositions under
functorch. Host milliseconds on this CPU and operation counts only: no
device number (tools/profile_port.py measures the card). Prints one line
per component.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# operations that launch no kernel on a card: views, metadata, and the CPU's
# conversions of Python scalars
_NO_KERNEL = {
    "aten::view", "aten::select", "aten::slice", "aten::expand", "aten::unsqueeze",
    "aten::reshape", "aten::_reshape_alias", "aten::as_strided", "aten::squeeze", "aten::t",
    "aten::transpose", "aten::permute", "aten::alias", "aten::detach", "aten::lift_fresh",
    "aten::_unsafe_view", "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::resize_", "aten::result_type", "aten::unbind", "aten::narrow", "aten::split",
    "aten::chunk", "aten::item", "aten::_local_scalar_dense", "aten::contiguous",
    "aten::broadcast_tensors", "aten::diagonal", "aten::mT", "aten::movedim", "aten::to",
    "aten::_to_copy", "aten::copy_", "aten::is_same_size", "aten::_has_same_storage_numel",
    "aten::_fw_primal", "aten::_make_dual", "aten::_unpack_dual",
}


def _ops(fn):
    """(innermost operations that would launch a kernel, operations in
    prims:: decompositions) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    n = prims = 0
    for ev in prof.events():
        if ev.name.startswith("prims::"):
            prims += 1
        inner = not any(c.name.startswith(("aten::", "prims::")) for c in ev.cpu_children)
        if ev.name.startswith(("aten::", "prims::")) and ev.name not in _NO_KERNEL and inner:
            n += 1
    return n, prims


def _ms(fn, reps: int = 3) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f-cap", type=int, default=128)
    ap.add_argument("--obs-cap", type=int, default=192)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()

    import numpy as np
    import torch

    import test_torch_cuda as cuda_tests
    from vil_fusion_tpu_torch.models import ba
    from vil_fusion_tpu_torch.models import estimator as est_mod
    from vil_fusion_tpu_torch.models import marginalization as marg
    from vil_fusion_tpu_torch.models import window as win

    torch.set_num_threads(args.threads)
    bundles, (p0, q0, v0), qic = cuda_tests._estimator_bundles(est_mod.K + 1)
    cfg = est_mod.EstimatorConfig(f_cap=args.f_cap, obs_cap=args.obs_cap)
    est = est_mod.VILEstimator(cfg, device="cpu")
    est.set_extrinsics(qic=qic, tic=np.zeros(3))
    est.set_initial_state(p=p0, q=q0, v=v0)
    for frame_args, kw in bundles:
        est.process_frame(*frame_args, **kw)

    w, f, pre, lid, prior = est.window, est.feats, est.pre, est.lidar, est.prior
    g = torch.tensor(cfg.ba.gravity)
    f32 = torch.float32
    parts = {
        "preintegration (make_segment)": lambda: win.make_segment(
            pre.acc_buf[3], pre.gyr_buf[3], pre.dt_buf[3], pre.n_samples[3], pre.ba[3],
            pre.bg[3], cfg.imu_noise, cfg.imu_cap),
        "imu blocks + jacfwd": lambda: ba._imu_blocks(w, pre, g, f32),
        "imu residuals": lambda: ba._imu_blocks(w, pre, g, f32, jac=False),
        "lidar blocks + jacfwd": lambda: ba._lidar_blocks(w, lid, f32),
        "projection blocks + jacfwd": lambda: ba._proj_blocks(w, f, cfg.ba, f32, 4.0),
        "projection residuals": lambda: ba._proj_blocks(w, f, cfg.ba, f32, 4.0, jac=False),
        "build_system": lambda: ba.build_system(w, f, pre, lid, prior, cfg.ba, 4.0),
        "total_cost": lambda: ba.total_cost(w, f, pre, lid, prior, cfg.ba, 4.0),
        "optimize (8 LM iterations)": lambda: ba.optimize(w, f, pre, lid, prior, cfg.ba),
        "marginalize_old": lambda: marg.marginalize_old(w, f, pre, lid, prior, cfg.ba),
        "slide_new": lambda: marg.slide_new(w, f, pre, lid, cfg.imu_noise, cfg.imu_cap),
    }
    print(f"estimator host cost on the CPU ({args.threads} thread(s)), {args.f_cap} feature "
          f"slots, {args.obs_cap} observations, {cfg.imu_cap}-sample IMU buffers", flush=True)
    for name, fn in parts.items():
        n, prims = _ops(fn)
        print(f"  {name}: {_ms(fn, 1 if name.startswith('optimize') else 3):.1f} ms, "
              f"{n} innermost operations that launch a kernel on a card, {prims} in prims:: "
              f"decompositions", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
