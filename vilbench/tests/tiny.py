"""A cell's spec cut to a size the CPU runs in minutes: a 16 x 900 scan, a
160 x 120 camera, the 25 m block, short warm-up and checks, and limits of
its own, set from the readings of sound runs and faults at this size
(PERF.md). The harness, the generator and the reference run on it
unchanged."""
from __future__ import annotations

import copy
import os

from vilbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


LIMITS = dict(odom_pose_gap_m=0.05, odom_rot_gap_deg=0.2, est_motion_gap_m=0.3,
              est_motion_rot_gap_deg=2.0)


# cells whose pieces vilbench/ keeps but BENCHMARK.json does not hold (PERF.md)
LEFT_OUT = {"kitti_vil.city": dict(name="kitti_vil.city", config="kitti_vil", traffic="city",
                                   chips=1)}
CHECKS = {"lidar": ("odom_pose_gap_m", "odom_rot_gap_deg"),
          "vil": ("odom_pose_gap_m", "odom_rot_gap_deg", "est_motion_gap_m",
                  "est_motion_rot_gap_deg")}


def spec(cell: str) -> dict:
    s = copy.deepcopy(harness.load_cell(ROOT, cell, LEFT_OUT.get(cell)))
    s["limits"] = {k: LIMITS[k] for k in CHECKS[s["config"]["reference"]]}
    c, t = s["config"], s["traffic"]
    c["rig"].update(image_height=120, image_width=160, n_scan=16, min_dist=6,
                    camera=dict(c["rig"]["camera"], projection_parameters=dict(
                        fx=93.8, fy=93.8, cx=80.0, cy=60.0)))
    c["scan"].update(n_scan=16, width=900)
    if c.get("camera"):
        c["camera"].update(height=120, width=160, fx=93.8, fy=93.8, cx=80.0, cy=60.0)
    c["pipeline"]["sc_capacity"] = 256
    t["scene"] = {"radius_m": 25.0, "pillar_step_deg": 16.0, "box_step_deg": 24.0}
    t["route"].update(lap_frames=196, mod_cycles=3, bob_cycles=10, pitch_cycles=7, roll_cycles=5)
    t["warmup_frames"] = min(t["warmup_frames"], 13)
    t["traced_frames"] = 2
    t["check"].update(samples=2, first=1, span=4, loops=0)  # a 1-s window closes no loop here
    if t.get("posegraph_warm"):
        t["posegraph_warm"] = {"frames_per_s": 2.0, "keyframes_per_frame": 0.4}
    return s
