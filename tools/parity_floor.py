#!/usr/bin/env python3
"""How far the f32 estimator of either package sits from float64, and how
far the port's vil pipeline sits from the JAX package's: the measurements
behind the tolerances of the estimator's parity tests. CPU only.

    JAX_PLATFORMS=cpu python tools/parity_floor.py [--skip-pipeline]

On the window of tests/torch_estimator_problem.py (32 feature slots), for
the JAX package (f32) and the port (f32), the largest difference from the
port's code on float64 tensors, relative to the largest entry:
  * schur_solve of the assembled system at lam 1e-4, six perturbed windows
    (pose step and depth step);
  * marginalize_old: J^T J and J^T r0 of the prior, from an empty prior and
    from the prior that first marginalization leaves;
  * optimize() with velocity / time-shift noise on every observation: the
    final poses' distance (m) from the float64 run.
Then both pipelines over tests/test_torch_vil_pipeline.py's 14 frames (its
rig and helpers, the tracker's RANSAC off): the
largest per-frame distance of the lidar odometry and of the estimator's
positions (m). Prints one line per measurement.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def _f64(nt):
    return type(nt)(*(_f64(x) if hasattr(x, "_asdict")
                      else (x.double() if x.is_floating_point() else x) for x in nt))


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _invariants(prior):
    from torch_estimator_problem import np_

    J = np_(prior.J).astype("float64")
    return J.T @ J, J.T @ np_(prior.r0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-pipeline", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from torch_estimator_problem import make_problem, np_, perturb, to_port

    from vil_fusion_tpu.models import ba as jba
    from vil_fusion_tpu.models import marginalization as jmarg
    from vil_fusion_tpu_torch.models import ba as tba
    from vil_fusion_tpu_torch.models import marginalization as tmarg

    torch.set_num_threads(2)
    kinds = ("window", "feats", "pre", "lidar", "prior")
    state_gt, feats, pre, lidar = make_problem()
    build = jax.jit(jba.build_system, static_argnames=("cfg",))
    solve = jax.jit(jba.schur_solve, static_argnames=("cfg",))
    lam = 1e-4
    for seed in range(1, 7):
        st0 = perturb(state_gt, seed=seed)
        sj = build(st0, feats, pre, lidar, jba.empty_prior(st0), jba.BAConfig(), 4.0)
        st = tba.System(*(torch.from_numpy(np.array(x)) for x in sj))
        port = tba.schur_solve(st, torch.tensor(lam), tba.BAConfig())
        exact = tba.schur_solve(tba.System(*(x.double() for x in st)),
                                torch.tensor(lam, dtype=torch.float64), tba.BAConfig())
        ref = solve(sj, jnp.float32(lam), jba.BAConfig())
        for name, k in (("pose", 0), ("depth", 1)):
            print(f"schur_solve window {seed} {name} step: JAX f32 {_rel(np_(ref[k]), np_(exact[k])):.3g}, "
                  f"port f32 {_rel(np_(port[k]), np_(exact[k])):.3g} of the float64 step's largest "
                  f"entry", flush=True)

    state_gt, feats, pre, lidar = make_problem(imu_cap=48)
    st0 = perturb(state_gt)
    F = feats.active.shape[0]
    feats = feats._replace(lidar_flag=jnp.asarray(np.arange(F) < F // 4))
    prior = jba.empty_prior(st0)
    for label in ("from an empty prior", "with the first marginalization's prior"):
        pj = jmarg.marginalize_old(st0, feats, pre, lidar, prior, jba.BAConfig())
        ins = [to_port(k, x) for k, x in zip(kinds, (st0, feats, pre, lidar, prior))]
        pt = tmarg.marginalize_old(*ins, tba.BAConfig())
        p64 = tmarg.marginalize_old(*(_f64(x) for x in ins), tba.BAConfig())
        e = [(_rel(a, c), _rel(b, c)) for a, b, c in zip(_invariants(pj), _invariants(pt),
                                                          _invariants(p64))]
        print(f"marginalize_old {label}: J^T J JAX f32 {e[0][0]:.3g} port f32 {e[0][1]:.3g}; "
              f"J^T r0 JAX f32 {e[1][0]:.3g} port f32 {e[1][1]:.3g} of the float64 prior's "
              f"largest entry", flush=True)
        prior = pj

    state_gt, feats, pre, lidar = make_problem()
    st0 = perturb(state_gt)
    rng = np.random.default_rng(5)
    feats = feats._replace(
        lidar_flag=jnp.asarray(np.arange(F) < F // 4),
        vel=jnp.asarray(rng.normal(0, 0.05, feats.vel.shape).astype(np.float32)),
        tshift=jnp.asarray(rng.normal(0, 0.002, feats.tshift.shape).astype(np.float32)))
    prior = jba.empty_prior(st0)
    sj, _, _ = jba.optimize(st0, feats, pre, lidar, prior, jba.BAConfig())
    ins = [to_port(k, x) for k, x in zip(kinds, (st0, feats, pre, lidar, prior))]
    s32, _, _ = tba.optimize(*ins, tba.BAConfig())
    s64, _, _ = tba.optimize(*(_f64(x) for x in ins), tba.BAConfig())
    d = lambda a, b: float(np.abs(np_(a.p).astype(np.float64) - np_(b.p)).max())  # noqa: E731
    print(f"optimize with noisy observations: JAX f32 {d(sj, s64):.3g} m, port f32 "
          f"{d(s32, s64):.3g} m from the float64 run; JAX f32 to port f32 {d(s32, sj):.3g} m",
          flush=True)

    if not args.skip_pipeline:
        import test_torch_vil_pipeline as tv
        from vil_fusion_tpu.models import global_fusion as jgf
        from vil_fusion_tpu.runtime.config import RigConfig as JRig
        from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline as JPipeline

        traj, frames = tv._frames(tv.N_FRAMES)
        jp = JPipeline(JRig(**tv.RIG_KW), mode="vil", f_cap=64, odom_overrides=tv.ODOM,
                       gf_cfg=jgf.GlobalFusionConfig(**tv.GF), scan_quant=tv.QUANT,
                       sync_depth=0)
        jp.tracker_cfg = jp.tracker_cfg._replace(ransac=False)
        tp = tv._port()
        for pipe in (jp, tp):
            tv._oracle(pipe, traj)
        for fr in frames:
            tv._feed(jp, fr)
            tv._feed(tp, fr)
        lid = np.abs(np.stack(tp.outputs.lidar_p) - np.stack(jp.outputs.lidar_p)).max()
        vio = np.linalg.norm(np.stack(tp.outputs.vio_p) - np.stack(jp.outputs.vio_p), axis=1)
        gt = np.stack([fr[5] for fr in frames[:tv.N_FRAMES]])
        print(f"vil pipeline, {tv.N_FRAMES} frames: lidar odometry within {lid:.3g} m of the JAX "
              f"package's, estimator positions {vio.max():.3g} m (from frame 10 on: "
              f"{vio[10:].min():.3g}-{vio[10:].max():.3g} m); from the ground truth: JAX "
              f"{np.linalg.norm(np.stack(jp.outputs.vio_p) - gt, axis=1).max():.3g} m, port "
              f"{np.linalg.norm(np.stack(tp.outputs.vio_p) - gt, axis=1).max():.3g} m",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
