"""Sequence-parallel LiDAR odometry over the mesh.

Port of vil_fusion_tpu/parallel/batched_odometry.py: S independent sequences
(dataset evaluation sweeps, multi-robot logs, parameter searches) with the
sequence axis split over the ranks. Each rank steps its own sequences with
`odometry_step_batched` (one K1 / K2 launch over them); there is no
communication.
"""
from typing import Optional

from vil_fusion_tpu_torch.models import lidar_odometry as lo
from vil_fusion_tpu_torch.parallel.mesh import Mesh, shard_rows


def shard_states(mesh: Mesh, states: lo.MapState) -> lo.MapState:
    """This rank's sequences of a batched MapState (every leaf's rows), on
    the rank's device."""
    return lo.MapState(*(shard_rows(mesh, a).to(mesh.device) for a in states))


def odometry_step_sharded(mesh: Mesh, states: lo.MapState, points, valid,
                          cfg: lo.OdomConfig = lo.OdomConfig(),
                          frame_count: Optional[int] = None):
    """One step of S sequences, S split over the ranks. `states` holds this
    rank's sequences (`shard_states`); `points` (S, N, 3) / `valid` (S, N)
    are the whole batch, of which the rank takes its rows. Returns this
    rank's (states, outputs), as odometry_step_batched does for its rows
    (on a card a steady step replays that step's graph)."""
    points = shard_rows(mesh, points).to(mesh.device)
    valid = shard_rows(mesh, valid).to(mesh.device)
    return lo.odometry_step_batched(states, points, valid, cfg, frame_count=frame_count)
