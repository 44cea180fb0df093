"""The reference of the vil configurations.

The lidar odometry inside the frame graph (common.OdometryFollower): at
`samples` frames f of the window, drawn from the seed, and at f - 1, the
scan registered in float64 against the program's own map and prediction
before the frame, held against the lidar pose the program delivered and
the pose its state carried on (`odom_pose_gap_m`, `odom_rot_gap_deg`).

The estimator's answer, the body pose the pipeline delivers for each frame
(two frames later under `sync_depth=2`): its motion from frame f - 1 to
frame f against the motion of the reference's two registrations, taken
into the body frame by the rig's lidar extrinsic (`est_motion_gap_m`,
`est_motion_rot_gap_deg`). A pose that is stale, belongs to another frame,
or was altered where it was produced moves by a frame's travel (0.8 m at
8 m/s) or by the alteration away from it. The estimator's window, its
marginalization prior and depths are judged only through that pose
(PERF.md)."""
from __future__ import annotations

import torch

from vilbench.reference import common
from vilbench.reference import registration as reg


class Follower(common.OdometryFollower):
    def __init__(self, pipe, drive, config, traffic, seed, first: int):
        super().__init__(pipe, drive, config, traffic, seed, first, around=(-1, 0, 1))
        self.key_flags: list = []

    def before_frame(self, i: int):
        super().before_frame(i)
        # the estimator's keyframe decisions, a reading beside the rate: its
        # keyframe path is the cheaper of the two (a device copy a frame)
        key = self.pipe.estimator.last_is_key
        if i >= self.first and isinstance(key, torch.Tensor):
            self.key_flags.append(key.clone())

    def compare(self, limits: dict, control=None) -> dict:
        device = next(iter(self.snaps.values()))["surf"].device if self.snaps else "cpu"
        gaps = dict(odom_pose_gap_m=0.0, odom_rot_gap_deg=0.0, est_motion_gap_m=0.0,
                    est_motion_rot_gap_deg=0.0)
        self.per_frame = []
        checked = sorted({g for f in self.frames for g in (f - 1, f)})
        refs = self.odometry(checked, control, gaps, device)
        T_bl = common.lidar_extrinsic(self.config)
        rig = self.config["rig"]
        n_est = 0
        for f in self.frames:
            if f - 1 not in refs or f not in refs or f - 1 not in self.program \
                    or f not in self.program:
                continue
            if control is not None:
                a = common.register(self.snaps[f - 1],
                                    common.scan_points(self.drive, f - 1, rig, device), control)
                b = common.register(self.snaps[f],
                                    common.scan_points(self.drive, f, rig, device), control)
                cand = reg.compose(T_bl, reg.compose(reg.compose(reg.inverse(a), b),
                                                     reg.inverse(T_bl)))
            else:
                pa, pb = self.program[f - 1], self.program[f]
                cand = reg.compose(reg.inverse(reg.pose(pa["q"], pa["p"])),
                                   reg.pose(pb["q"], pb["p"]))
            lidar_motion = reg.compose(reg.inverse(refs[f - 1]), refs[f])
            ref = reg.compose(T_bl, reg.compose(lidar_motion, reg.inverse(T_bl)))
            g = reg.gaps(cand, ref)
            gaps["est_motion_gap_m"] = max(gaps["est_motion_gap_m"], g[0])
            gaps["est_motion_rot_gap_deg"] = max(gaps["est_motion_rot_gap_deg"], g[1])
            true = reg.compose(reg.inverse(self.drive.pose(f - 1)), self.drive.pose(f))
            self.per_frame.append(dict(
                f=f, est=[float(f"{x:.3e}") for x in g],
                est_truth=[float(f"{x:.3e}") for x in reg.gaps(cand, true)],
                ref_truth=[float(f"{x:.3e}") for x in reg.gaps(ref, true)]))
            n_est += 1
        keys = [bool(k) for k in self.key_flags]
        self.coverage = dict(scans=len(refs), estimator=n_est,
                             keyframe_share=sum(keys) / max(1, len(keys)), **self.readings(),
                             per_frame=self.per_frame)
        if n_est < len(self.frames):
            gaps["est_motion_gap_m"] = float("inf")  # a sampled frame was not delivered
        return {k: common.check(v, limits, k) for k, v in gaps.items()}
