"""The reference of the lidar configurations.

Odometry (common.OdometryFollower): at `samples` frames of the window,
drawn from the seed, the scan registered in float64 against the program's
own map and prediction before the frame, held against the pose the program
delivered and the pose its state carried on (`odom_pose_gap_m`,
`odom_rot_gap_deg`).

Loop closures, read and not compared: at most `loops` of the loop edges
global fusion accepted in the run, drawn from the seed. ScanContext
proposed the pair and ICP measured the edge, keyframe i's pose in keyframe
j's frame. The reference places frame(j)'s whole scan in the world at its
ground-truth pose and registers frame(i)'s scan against it from frame(i)'s
ground-truth pose (both scans taken again from the drive); the gap of the
pose the program's edge gives frame(i) goes into `coverage`. It has no
limit: the control (this registration in TF32) lands within centimetres of
the ground truth, under the program's own ICP error (PERF.md), so no limit
can lie between them. A laps run that accepts no loop is not correct. The
pose graph's relaxation is not checked (PERF.md)."""
from __future__ import annotations

import numpy as np
import torch

from vilbench.reference import common
from vilbench.reference import registration as reg

TARGET_POINTS = 40000  # points of the loop's target scan


class Follower(common.OdometryFollower):
    def __init__(self, pipe, drive, config, traffic, seed, first: int):
        super().__init__(pipe, drive, config, traffic, seed, first, around=(0, 1))
        self.seed = int(seed)
        self.n_loops = int(traffic["check"].get("loops", 0))
        self.loops: list = []

    def _detach_more(self):
        fu = self.pipe.fusion
        cap = fu.graph.loop_q.shape[0]
        # the store's last slot is overwritten by every loop past it
        n = min(len(fu.loops_found), cap - 1)
        lq = fu.graph.loop_q[:n].cpu().numpy()
        lp = fu.graph.loop_p[:n].cpu().numpy()
        dt = self.drive.dt
        for k in range(n):
            i, j = fu.loops_found[k]
            fi = int(round((fu.kf_ts[i] - self.drive.t(0)) / dt))
            fj = int(round((fu.kf_ts[j] - self.drive.t(0)) / dt))
            self.loops.append(dict(i=i, j=j, fi=fi, fj=fj, q=lq[k], p=lp[k]))

    def compare(self, limits: dict, control=None) -> dict:
        device = next(iter(self.snaps.values()))["surf"].device if self.snaps else "cpu"
        gaps = dict(odom_pose_gap_m=0.0, odom_rot_gap_deg=0.0)
        loop_gap = [0.0, 0.0]
        self.per_frame = []
        refs = self.odometry(self.frames, control, gaps, device)
        rng = np.random.default_rng([self.seed % (1 << 63), 0x100B])
        picked = sorted(rng.choice(len(self.loops), size=min(self.n_loops, len(self.loops)),
                                   replace=False)) if self.loops else []
        rig = self.config["rig"]
        for k in picked:
            e = self.loops[k]
            Tj, Ti = self.lidar_truth(e["fj"]), self.lidar_truth(e["fi"])
            src = common.scan_points(self.drive, e["fi"], rig, device)
            tgt = common.scan_points(self.drive, e["fj"], rig, device, TARGET_POINTS)
            tgt = tgt @ torch.as_tensor(Tj[0].T, device=device) + \
                torch.as_tensor(Tj[1], device=device)
            ref = reg.host(reg.align(src, tgt, Ti, reg.FLOAT64)[0])
            cand = (reg.host(reg.align(src, tgt, Ti, control)[0]) if control is not None
                    else reg.compose(Tj, reg.pose(e["q"], e["p"])))
            g = reg.gaps(cand, ref)
            T0 = reg.compose(reg.inverse(Tj), Ti)
            loop_gap = [max(loop_gap[0], g[0]), max(loop_gap[1], g[1])]
            self.per_frame.append(dict(loop=(e["i"], e["j"]), gap=float(f"{g[0]:.3e}"),
                                       truth_m=float(f"{np.linalg.norm(T0[1]):.3e}")))
        self.coverage = dict(scans=len(refs), loops_found=len(self.loops), loops=len(picked),
                             loop_gap_m=loop_gap[0], loop_rot_gap_deg=loop_gap[1],
                             **self.readings(), per_frame=self.per_frame)
        if len(refs) < len(self.frames):
            gaps["odom_pose_gap_m"] = float("inf")  # a sampled scan was not delivered
        if self.n_loops and not picked:
            gaps["odom_pose_gap_m"] = float("inf")  # a laps run closed no loop
        return {k: common.check(v, limits, k) for k, v in gaps.items()}
