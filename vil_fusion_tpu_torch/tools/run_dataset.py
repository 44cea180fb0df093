"""Run the VIL-Fusion pipeline on a dataset and write trajectories + report.

Port of tools/run_dataset.py, the replacement for the reference's
`roslaunch sensor_fusion run_fusion.launch` + `rosbag play` workflow
(README.md:40-48), with the same flags plus --device:

    python -m vil_fusion_tpu_torch.tools.run_dataset --dataset kitti \\
        --data /path/to/kitti --seq 07 --config configs/kitti.yaml \\
        --mode vil --out out/kitti07

    python -m vil_fusion_tpu_torch.tools.run_dataset --dataset euroc \\
        --data /path/to/MH_01 --config configs/euroc.yaml --mode vio \\
        --out out/mh01 --device cpu

Writes the TUM trajectories (vins_result_no_loop / vins_result_loop /
lidar_odometry / fs_loam_loop), renders the visualization suite, and
reports ATE RMSE against ground truth when the dataset provides it, with
the replay's transport metrics (events, ring drops, producer lead).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> dict:
    """Run the CLI on `argv` (sys.argv[1:] by default); returns the report."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset",
                    choices=["kitti", "kitti_raw", "euroc", "advio"],
                    required=True)
    ap.add_argument("--data", required=True, help="dataset root")
    ap.add_argument("--seq", default="07", help="KITTI sequence")
    ap.add_argument("--config", required=True, help="rig YAML")
    ap.add_argument("--mode", default="vil",
                    choices=["vil", "vio", "lidar", "mask"])
    ap.add_argument("--out", default="out")
    ap.add_argument("--max-events", type=int, default=None)
    ap.add_argument("--visual-loop", action="store_true")
    ap.add_argument("--sync-depth", type=int, default=2,
                    help="cross-frame stage overlap depth (0 = synchronous)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline's state (cuda or cpu)")
    args = ap.parse_args(argv)

    from vil_fusion_tpu_torch.runtime import datasets, tum, viz
    from vil_fusion_tpu_torch.runtime.config import load_rig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    rig = load_rig(args.config)
    pipe = VILFusionPipeline(rig, mode=args.mode, visual_loop=args.visual_loop,
                             sync_depth=args.sync_depth, device=args.device)

    if args.dataset == "kitti":
        ds = datasets.KittiOdometry(args.data, args.seq)
    elif args.dataset == "kitti_raw":
        ds = datasets.KittiRaw(args.data)
    elif args.dataset == "advio":
        # the mask-variant dataset (reference README.md:75-84): masks under
        # iphone/masks/ flow through replay() into push_image(mask=...)
        ds = datasets.ADVIO(args.data)
    else:
        ds = datasets.EuRoC(args.data)

    stats: dict = {}
    datasets.replay(pipe, ds.events(), max_events=args.max_events, stats=stats)

    os.makedirs(args.out, exist_ok=True)
    pipe.outputs.write(args.out, pipe.fusion)
    viz.render_pipeline_report(pipe, args.out)

    report = {"frames": len(pipe.outputs.ts), "restarts": pipe.restarts,
              "restart_log": pipe.restart_log, "device": str(pipe.device),
              "replay": stats, "timers": GLOBAL_TIMERS.summary()}
    if pipe.visual_loop is not None:
        report["n_visual_loops"] = int(pipe.visual_loop.graph.n_loops)
        report["visual_loop_stats"] = pipe.visual_loop.stats_summary()
    try:
        gt = ds.ground_truth()
        # initialized frames only (reference pubOdometry gating)
        ini = np.asarray(pipe.outputs.initialized, bool)
        est_p = np.asarray(pipe.outputs.vio_p)
        ts = np.asarray(pipe.outputs.ts)
        if args.dataset in ("euroc", "advio"):
            t_gt, p_gt, _ = gt
            ia, ib = tum.associate(ts[ini], t_gt, 0.02)
            report["ate_rmse_vio"] = tum.ate_rmse(est_p[ini][ia], p_gt[ib])
        else:
            p_gt, _ = gt
            n = min(len(est_p), len(p_gt))
            m = ini[:n]
            report["ate_rmse_vio"] = tum.ate_rmse(est_p[:n][m], p_gt[:n][m])
        if pipe.fusion is not None and pipe.fusion.n_kf:
            report["n_loop_closures"] = len(pipe.fusion.loops_found)
    except Exception as e:  # ground truth optional
        report["ate_note"] = f"no ground truth evaluated: {e}"

    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
