"""Process-group helpers for multi-device scaling.

Port of vil_fusion_tpu/parallel/mesh.py. The reference shards the
data-parallel axes of the workload over a `jax.sharding.Mesh`; here one
process a device joins a `torch.distributed` process group, and a `Mesh` is
that group seen from one rank:

  * landmark / factor blocks of the BA Hessian -> all_reduce (sharded_ba)
  * LiDAR map points for kNN                   -> local top-k + all_gather merge
  * ScanContext database rows                  -> local candidates + all_gather
  * sequences of batched odometry              -> rows a rank, no collective

Every rank holds the global (replicated) tensors; `shard_rows` takes this
rank's contiguous block of rows, the counterpart of
`NamedSharding(mesh, P(AXIS))`. Nothing here sets a process group up: the
caller runs `torch.distributed.init_process_group` (its address, world size
and rank) first.
"""
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

AXIS = "shard"  # single data axis: factors / map points / database rows


class Mesh(NamedTuple):
    """One rank's view of the process group the sharded code runs over."""

    group: Optional[object]  # the torch.distributed group (None: the default group)
    rank: int  # this process's rank in the group
    size: int  # ranks in the group
    device: torch.device  # where this rank's tensors live


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the first `n_devices` ranks (default: the whole world)
    of the initialized default process group.

    NCCL ranks run on `cuda:{LOCAL_RANK}` (the environment's, else the rank
    modulo the visible cards) unless `device` names one; any other backend
    (gloo) runs on the device the caller names, which it must name. Every
    rank calls this (a smaller mesh is a new group, a collective call);
    ranks beyond the first n get None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = n_devices or world
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if device is None:
        if dist.get_backend() != "nccl":
            raise ValueError(f"make_mesh: the {dist.get_backend()} backend runs on the device "
                             "the caller names (device=...)")
        local = os.environ.get("LOCAL_RANK", dist.get_rank() % max(1, torch.cuda.device_count()))
        device = torch.device("cuda", int(local))
    rank = dist.get_rank()
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group, rank, n, torch.device(device))


_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]):
    """Install the mesh used by sharded code paths selected via config flags
    (e.g. BAConfig.sharded) that cannot carry a Mesh object themselves."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh() -> Mesh:
    if _ACTIVE_MESH is None:
        raise RuntimeError("no active mesh: call parallel.mesh.set_active_mesh")
    return _ACTIVE_MESH


def shard_rows(mesh: Mesh, x):
    """This rank's contiguous block of the rows of `x` (a view): rows
    [rank n, (rank + 1) n) of n = rows / size. Raises where the rows do not
    divide by the mesh size."""
    rows = x.shape[0]
    if rows % mesh.size:
        raise ValueError(f"shard_rows: {rows} rows do not divide by the mesh size {mesh.size}")
    n = rows // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def all_gather(mesh: Mesh, x):
    """(size, *x.shape): every rank's `x` (at least 1-d), in rank order, on
    every rank."""
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    # all_gather_into_tensor is named all_gather_single in newer torch
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=mesh.group)
    return out.reshape((mesh.size,) + tuple(x.shape))


def all_reduce_sum(mesh: Mesh, x):
    """The sum of every rank's `x` (a new tensor), on every rank."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x
