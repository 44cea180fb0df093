"""Sequence-batched LiDAR odometry (models/lidar_odometry.py
odometry_step_batched / init_state_batched) and the batched K1 / K2 behind
it, on the CPU.

The batched step is torch.func.vmap over the single-sequence step; the kNN
wrappers' vmap rule turns every K1 / K2 call into one call over the
sequences (one launch on the card; the plain batched versions here). Held
against: the JAX package's odometry_step_batched on tests/test_parallel.py's
16 x 360 rig (S = 4, the exact kNN in both: JAX on the CPU answers
approx_knn=True with its exact search), 1e-4 m (tests/test_parallel.py:
169-171); the port's own single-sequence steps, 1e-4 m (the batched
reductions sum in another order, so poses differ by float32 rounding, 1e-5
m after four steps), and 1e-5 m for one step from the same state; the
plain batched kNN bit for bit against per-sequence calls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import lidar_features as jlf
from vil_fusion_tpu.models import lidar_odometry as jlo
from vil_fusion_tpu.runtime import sim
from vil_fusion_tpu_torch.models import lidar_features as tlf
from vil_fusion_tpu_torch.models import lidar_odometry as tlo
from vil_fusion_tpu_torch.ops import knn as knn_plain
from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

torch.set_num_threads(2)

S = 4
LIDAR = dict(n_scan=16, width=360, fov_up_deg=20.0, fov_down_deg=-20.0, min_range=1.0,
             edge_cap=256, surf_cap=1024)
MAPS = dict(edge_map_cap=2048, surf_map_cap=4096)
TOL_M = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def scans():
    """(steps, S, N, 3) points and (steps, S, N) validity: sequence s
    starts at tests/test_parallel.py:152-157's pose and moves 0.3 m a step
    along x."""
    scene = sim.RaycastScene()
    out = [[sim.simulate_lidar_scan(scene, np.eye(3), np.array([3.0 + 2 * s + 0.3 * f, 0.5 * s,
                                                                1.5]),
                                    n_scan=16, width=360, fov_up_deg=20.0, fov_down_deg=-20.0)
            for s in range(S)] for f in range(4)]
    pts = np.stack([[np.asarray(p) for p, _ in row] for row in out]).astype(np.float32)
    val = np.stack([[np.asarray(v) for _, v in row] for row in out])
    return pts, val


def _tcfg(**over):
    return tlo.OdomConfig(lidar=tlf.LidarConfig(**LIDAR), **{**MAPS, **over})


def _run_batched(cfg, pts, val, steps, before=None):
    """The batched run's final states and outputs; `before` collects the
    states each step starts from."""
    states = tlo.init_state_batched(cfg, S, device="cpu")
    outs = []
    for f in range(steps):
        if before is not None:
            before.append(states)
        states, out = tlo.odometry_step_batched(states, torch.from_numpy(pts[f]),
                                                torch.from_numpy(val[f]), cfg, frame_count=f)
        outs.append(out)
    return states, outs


def _run_single(cfg, pts, val, steps, s):
    st = tlo.init_state(cfg, device="cpu")
    outs = []
    for f in range(steps):
        st, out = tlo.odometry_step(st, torch.from_numpy(pts[f, s]), torch.from_numpy(val[f, s]),
                                    cfg, frame_count=f)
        outs.append(out)
    return st, outs


def test_batched_step_matches_reference(scans):
    """odometry_step_batched at S = 4 against the JAX package's
    odometry_step_batched, two steps (tests/test_parallel.py:138-171)."""
    pts, val = scans
    jcfg = jlo.OdomConfig(lidar=jlf.LidarConfig(**LIDAR), approx_knn=False, **MAPS)
    jst = jlo.init_state_batched(jcfg, S)
    for f in range(2):
        jst, jout = jlo.odometry_step_batched(jst, jnp.asarray(pts[f]), jnp.asarray(val[f]), jcfg)
    tst, touts = _run_batched(_tcfg(approx_knn=False), pts, val, 2)
    np.testing.assert_allclose(touts[-1][1].numpy(), np.asarray(jout[1]), atol=TOL_M)
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), atol=TOL_M)
    np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), atol=TOL_M)
    np.testing.assert_array_equal(tst.frame_count.numpy(), np.asarray(jst.frame_count))


MODES = {"default K1": {}, "exact K2": dict(approx_knn=False),
         "sparse K3": dict(sparse_knn=True, approx_knn=False), "hash": dict(use_hash_knn=True),
         "deskew": dict(deskew=True), "diff form": dict(knn_form="diff")}


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_step_matches_single_steps(scans, mode):
    """Four batched steps (the first frame, two cold frames, a warm frame
    that re-ranks the cached candidates) against each sequence stepped
    alone: every pose output and the maps' validity; and every batched step
    against odometry_step from the same state (the batched state's row) on
    the same scan, within 1e-5 m (only the batched reductions' rounding
    separates them: 6e-7 m at most on 16 x 900 scans, on a CPU)."""
    pts, val = scans
    cfg = _tcfg(**MODES[mode])
    steps = 4
    before = []
    bst, bouts = _run_batched(cfg, pts, val, steps, before)
    for f in range(steps):
        for s in range(S):
            one = tlo.MapState(*(a[s] for a in before[f]))
            _, o = tlo.odometry_step(one, torch.from_numpy(pts[f, s]),
                                     torch.from_numpy(val[f, s]), cfg, frame_count=f)
            for a, b in zip(bouts[f], o):
                np.testing.assert_allclose(a[s].numpy(), b.numpy(), atol=1e-5,
                                           err_msg=f"{mode}: step {f} from the same state")
    for s in range(S):
        st, outs = _run_single(cfg, pts, val, steps, s)
        for f in range(steps):
            for a, b in zip(bouts[f], outs[f]):
                np.testing.assert_allclose(a[s].numpy(), b.numpy(), atol=TOL_M,
                                           err_msg=f"{mode}: sequence {s}, step {f}")
        np.testing.assert_allclose(bst.p[s].numpy(), st.p.numpy(), atol=TOL_M)
        assert int(bst.frame_count[s]) == int(st.frame_count) == steps
        # the maps hold the same cells: a cell can change only where a
        # point sits on a voxel boundary within the poses' rounding
        agree = (bst.surf_map_valid[s] == st.surf_map_valid).float().mean().item()
        assert agree > 0.999, f"{mode}: surf map validity agrees on {agree:.4f} of its slots"


def test_init_state_batched():
    """init_state broadcast to S sequences with storage of their own, as
    the JAX package's init_state_batched."""
    cfg = _tcfg()
    b = tlo.init_state_batched(cfg, S, device="cpu")
    one = tlo.init_state(cfg, device="cpu")
    j = jlo.init_state_batched(jlo.OdomConfig(lidar=jlf.LidarConfig(**LIDAR), **MAPS), S)
    for name, a, o, ja in zip(tlo.MapState._fields, b, one, j):
        assert a.shape == (S,) + o.shape and a.dtype == o.dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja), err_msg=name)
        for s in range(S):
            assert torch.equal(a[s], o), name
    b.p[0, 0] = 1.0
    assert float(b.p[1, 0]) == 0.0  # rows are not views of one another


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("form", ["expanded", "diff"])
@pytest.mark.parametrize("nq,nd,k", [(50, 700, 5), (129, 300, 3), (7, 1000, 1)])
def test_plain_batched_knn(grouped, form, nq, nd, k):
    """The plain batched K1 / K2 (the CPU path and the card's reference):
    each sequence's rows bit for bit the unbatched call's, with per-sequence
    sides, with a database shared by all sequences, and through
    torch.func.vmap of the wrappers (the vmap rule's one batched call)."""
    rng = np.random.default_rng(nq + nd + k)
    q = torch.from_numpy(rng.uniform(-20, 20, (3, nq, 3)).astype(np.float32))
    db = torch.from_numpy(rng.uniform(-20, 20, (3, nd, 3)).astype(np.float32))
    v = torch.from_numpy(rng.random((3, nd)) > 0.2)
    plain = knn_plain.knn_grouped if grouped else knn_plain.knn
    wrapper = kc.knn_grouped if grouped else kc.knn_exact
    d, i = plain(q, db, v, k=k, form=form)
    d_sh, i_sh = plain(q, db[1], v[1], k=k, form=form)
    d_vm, i_vm = torch.func.vmap(lambda a, b, c: wrapper(a, b, c, k=k, form=form))(q, db, v)
    d_vs, i_vs = torch.func.vmap(lambda a: wrapper(a, db[1], v[1], k=k, form=form))(q)
    for s in range(3):
        d1, i1 = plain(q[s], db[s], v[s], k=k, form=form)
        d2, i2 = plain(q[s], db[1], v[1], k=k, form=form)
        for got, want in ((d[s], d1), (i[s], i1), (d_vm[s], d1), (i_vm[s], i1),
                          (d_sh[s], d2), (i_sh[s], i2), (d_vs[s], d2), (i_vs[s], i2)):
            assert torch.equal(got, want)
