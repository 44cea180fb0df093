"""Checkpoint / resume of the pipeline's state.

Port of vil_fusion_tpu/runtime/checkpoint.py: every subsystem's state is a
fixed-shape tree of tensors, so a checkpoint is one flat npz per
subsystem: the estimator (window, features, preintegration, lidar
constraints, marginal prior, host counters) and global fusion (pose graph,
ScanContext database, keyframe clouds, host bookkeeping). The visual-loop
database has its own save / load (models/visual_loop.py).

Keys are the reference's (`window.p`, `feats.inv_depth`, `prior.lin.q`,
`meta.frame_count`, `graph.n_nodes`, `scdb.desc`, `kf_q`, ...), so a file
written by either package loads into the other. Loaded tensors take the
dtype and device of the object they load into.
"""
from __future__ import annotations

import numpy as np
import torch

from vil_fusion_tpu_torch.models.factors import MargPrior


def _flatten(tree, prefix=""):
    """Nested NamedTuples / dicts of arrays -> {"a.b.c": numpy array}."""
    out = {}
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten_into(template, flat, prefix=""):
    """A tree shaped like `template` with its leaves from `flat`, each leaf a
    tensor of the template leaf's dtype on its device."""
    if hasattr(template, "_asdict"):
        return type(template)(**{k: _unflatten_into(v, flat, f"{prefix}{k}.")
                                 for k, v in template._asdict().items()})
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}.") for k, v in template.items()}
    return torch.as_tensor(np.asarray(flat[prefix[:-1]]), dtype=template.dtype,
                           device=template.device)


def save_pytree(path: str, tree):
    np.savez_compressed(path, **_flatten(tree))


def load_pytree(path: str, template):
    return _unflatten_into(template, dict(np.load(path)))


def save_estimator(est, path: str):
    """Persist a VILEstimator's solver state."""
    save_pytree(path, dict(
        window=est.window, feats=est.feats, pre=est.pre, lidar=est.lidar,
        prior=dict(J=est.prior.J, r0=est.prior.r0, lin=est.prior.lin, valid=est.prior.valid),
        meta=dict(frame_count=np.int64(est.frame_count),
                  initialized=np.bool_(est.initialized))))


def load_estimator(est, path: str):
    flat = dict(np.load(path))
    est.window = _unflatten_into(est.window, flat, "window.")
    est.feats = _unflatten_into(est.feats, flat, "feats.")
    est.pre = _unflatten_into(est.pre, flat, "pre.")
    est.lidar = _unflatten_into(est.lidar, flat, "lidar.")
    est.prior = MargPrior(
        J=_unflatten_into(est.prior.J, flat, "prior.J."),
        r0=_unflatten_into(est.prior.r0, flat, "prior.r0."),
        lin=_unflatten_into(est.window, flat, "prior.lin."),
        valid=_unflatten_into(est.prior.valid, flat, "prior.valid."))
    est.frame_count = int(flat["meta.frame_count"])
    est.initialized = bool(flat["meta.initialized"])
    return est


def save_global_fusion(fusion, path: str):
    fusion.fence()  # the keyframes, loop edges and relaxations in flight land first
    save_pytree(path, dict(
        graph=fusion.graph, scdb=fusion.scdb, clouds=fusion.clouds,
        cloud_valid=fusion.cloud_valid,
        kf_q=np.asarray(fusion.kf_q_odom), kf_p=np.asarray(fusion.kf_p_odom),
        kf_ts=np.asarray(fusion.kf_ts),
        loops=np.asarray(fusion.loops_found, np.int64).reshape(-1, 2),
        last_q=np.asarray(fusion.last_q if fusion.last_q is not None else []),
        last_p=np.asarray(fusion.last_p if fusion.last_p is not None else []),
        n_kf=np.int64(fusion.n_kf)))


def load_global_fusion(fusion, path: str):
    flat = dict(np.load(path))
    fusion.graph = _unflatten_into(fusion.graph, flat, "graph.")
    fusion.scdb = _unflatten_into(fusion.scdb, flat, "scdb.")
    fusion.clouds = _unflatten_into(fusion.clouds, flat, "clouds.")
    fusion.cloud_valid = _unflatten_into(fusion.cloud_valid, flat, "cloud_valid.")
    fusion.kf_q_odom = [q for q in flat["kf_q"]]
    fusion.kf_p_odom = [p for p in flat["kf_p"]]
    fusion.kf_ts = [float(t) for t in flat.get("kf_ts", [])]
    fusion.loops_found = [tuple(int(x) for x in row)
                          for row in flat.get("loops", np.zeros((0, 2)))]
    if flat.get("last_q") is not None and flat["last_q"].size:
        fusion.last_q = flat["last_q"]
        fusion.last_p = flat["last_p"]
    fusion.n_kf = int(flat["n_kf"])
    fusion.adopt_state()
    return fusion
