"""A frozen copy of vil_fusion_tpu_torch/runtime/sim.py (commit c7c7b8c): the
benchmark's world, trajectories, IMU and raycast, kept apart so that a later
change to the port's simulator does not move the yardstick."""

SOURCE_COMMIT = "c7c7b8c1efe348ecf35e3e1e559fe25979e6471d"
