"""Multi-device sliding-window BA: feature factors sharded over the mesh.

Port of vil_fusion_tpu/parallel/sharded_ba.py. The BA Hessian assembly is a
map-reduce over factors (the reference does it on 4 pthreads,
marginalization_factor.cpp:232-261): each rank assembles the normal-equation
contribution of its block of landmarks, and the (D, D) pose system is summed
with `all_reduce` (the reference's `psum`).

Landmark depths stay on their rank (H_ll is diagonal, so the Schur
complement's per-landmark elimination never crosses ranks); the only
traffic is the reduction of the pose system, its Schur correction and the
costs each iteration. The window state and the LM scalars are replicated:
the reduced costs are the same on every rank, so every rank takes the same
accept branch.

Deviations from the reference: the factors on the window's frames alone
(marginalization prior, IMU, LiDAR) are added once, on rank 0, where the
reference adds them at 1/N weight on every device (so at world size 1 this
is `ba.optimize` bit for bit); the reduction order is gloo's or NCCL's, not
XLA's.
"""
import torch

from vil_fusion_tpu_torch.models import ba
from vil_fusion_tpu_torch.models.window import D, FeatureStore, WindowState
from vil_fusion_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce_sum,
                                                get_active_mesh, shard_rows)


def build_system_sharded(mesh: Mesh, state: WindowState, feats_shard: FeatureStore, pre, lidar,
                         prior, cfg: ba.BAConfig, cauchy_c=1.0) -> ba.System:
    """This rank's landmark blocks plus (on rank 0) the window's factors,
    the pose system (H, b) and the cost summed over the ranks: the sharded
    image of ba.System, with (Hpd, Hd, bd) of the rank's landmarks."""
    if mesh.rank == 0:
        H, b, cost = ba.window_system(state, pre, lidar, prior, cfg)
    else:
        H = torch.zeros((D, D), dtype=state.p.dtype, device=state.p.device)
        b = torch.zeros((D,), dtype=state.p.dtype, device=state.p.device)
        cost = torch.zeros((), dtype=state.p.dtype, device=state.p.device)
    sys = ba.landmark_system(H, b, cost, state, feats_shard, cfg, cauchy_c)
    return sys._replace(H=all_reduce_sum(mesh, sys.H), b=all_reduce_sum(mesh, sys.b),
                        cost=all_reduce_sum(mesh, sys.cost))


def schur_solve_sharded(mesh: Mesh, sys: ba.System, lam, cfg: ba.BAConfig):
    """Sharded mirror of ba.schur_solve: the per-landmark elimination is
    local, its correction to the pose system one reduction, the damped solve
    replicated (the same on every rank), the back-substitution local."""
    HS, bS, inv_Hd = ba.schur_terms(sys.Hpd, sys.Hd, sys.bd, lam)
    delta = ba.damped_solve(sys.H, sys.H - all_reduce_sum(mesh, HS),
                            sys.b - all_reduce_sum(mesh, bS), lam)
    return delta, (sys.bd - sys.Hpd.T @ delta) * inv_Hd


def total_cost_sharded(mesh: Mesh, state, feats_shard, pre, lidar, prior, cfg: ba.BAConfig,
                       cauchy_c=1.0):
    cost = ba.landmark_cost(state, feats_shard, cfg, cauchy_c)
    if mesh.rank == 0:
        cost = ba.window_cost(state, pre, lidar, prior, cfg) + cost
    return all_reduce_sum(mesh, cost)


def _lm_loop_body(mesh: Mesh, state, feats_shard, pre, lidar, prior, cfg: ba.BAConfig):
    """The full annealed LM loop of ba.optimize on this rank's landmarks."""
    return ba.lm_loop(
        state, feats_shard, cfg,
        lambda st, ft, c: build_system_sharded(mesh, st, ft, pre, lidar, prior, cfg, c),
        lambda sys, lam: schur_solve_sharded(mesh, sys, lam, cfg),
        lambda st, ft, c: total_cost_sharded(mesh, st, ft, pre, lidar, prior, cfg, c))


def _shard_feats(mesh: Mesh, feats: FeatureStore) -> FeatureStore:
    return FeatureStore(*(shard_rows(mesh, a) for a in feats))


def _gather_depths(mesh: Mesh, feats: FeatureStore, ft_shard: FeatureStore) -> FeatureStore:
    """The whole store on every rank: the LM changes the inverse depths
    alone, so the ranks' blocks of them are gathered back."""
    return feats._replace(inv_depth=all_gather(mesh, ft_shard.inv_depth).reshape(-1))


def optimize_sharded(mesh: Mesh, state, feats, pre, lidar, prior, cfg: ba.BAConfig):
    """Drop-in for ba.optimize with the landmark factors split over `mesh`.
    Every rank passes the whole (replicated) window and feature store and
    takes its block of feature rows (`shard_rows`: the slots must divide by
    the mesh size). Returns (state, feats, cost), the same on every rank,
    feats the whole store."""
    st, ft, cost = _lm_loop_body(mesh, state, _shard_feats(mesh, feats), pre, lidar, prior, cfg)
    return st, _gather_depths(mesh, feats, ft), cost


def optimize_on_active_mesh(state, feats, pre, lidar, prior, cfg: ba.BAConfig):
    """ba.optimize replacement used by the estimator when cfg.sharded is
    set: the mesh comes from parallel.mesh.set_active_mesh."""
    return optimize_sharded(get_active_mesh(), state, feats, pre, lidar, prior, cfg)


def optimize_step_sharded(mesh: Mesh, state, feats, pre, lidar, prior, cfg: ba.BAConfig,
                          lam=1e-4):
    """One sharded GN step at fixed damping (kept for tests and
    measurements; the deployment path is optimize_sharded). Returns
    (state, feats, cost) with the cost before the step."""
    ft_shard = _shard_feats(mesh, feats)
    sys = build_system_sharded(mesh, state, ft_shard, pre, lidar, prior, cfg)
    lam_ = torch.as_tensor(lam, dtype=state.p.dtype, device=state.p.device)
    delta, delta_d = schur_solve_sharded(mesh, sys, lam_, cfg)
    new_state, new_ft = ba._apply(state, ft_shard, delta, delta_d, cfg)
    return new_state, _gather_depths(mesh, feats, new_ft), sys.cost
