"""The port's parallel/ modules (mesh, sharded_knn, sharded_sc, sharded_ba,
batched_odometry) on four gloo ranks on the CPU, against the JAX package's
on make_mesh(4) (four of tests/conftest.py's virtual CPU devices) and
against the port's single-device functions.

The ranks are spawned processes (tests/torch_parallel_worker.py, which
imports no jax) with a file rendezvous in a temporary directory, spawned
once for the module and joined with a timeout; the JAX references are
computed (jitted) while they run. The BA problem is
tests/torch_estimator_problem.py's simulator window at 64 feature slots
(16 a rank), perturbed by 1 cm / 0.1 degree / 1 cm/s, with observations
off by 1e-3 on the normalized plane (about half a pixel), so that the
optimum's cost stays of order 1e2 and rtol compares something. The full LM
loop's poses move with any change of summation order along the window's
weak directions: on this window with other noise draws and perturbations
the JAX package's own sharded and unsharded results end up to 2.6e-3 m
apart and the two packages' unsharded ones up to 5.6e-3 m (on a CPU);
on this draw they are 4.6e-4 / 1.7e-3 m apart, within the tolerances
below with room, and the one-step test holds the assembly and solve
tightly. The odometry runs the exact kNN (JAX on the CPU answers
approx_knn=True with its exact search). Tolerances are
tests/test_parallel.py's: the sharded kNN's distances rtol 1e-3 / atol
5e-3 against JAX (and bit for bit against the port's own exact kNN, whose
per-column distances it shares), ScanContext index and shift equal and
distance atol 1e-5; one GN step: cost rtol 1e-3, positions and inverse
depths atol 5e-4; the full LM loop: cost rtol 1e-3 / atol 1e-5, p 5e-3,
q 1e-3, inverse depth 5e-3 (gloo's all_reduce and XLA's psum sum in other
orders); the estimator option: cost rtol 1e-3, p 1e-3; batched odometry
1e-4 m.
"""
import functools
import multiprocessing
import os
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_worker as worker  # noqa: E402
from torch_estimator_problem import make_problem, perturb  # noqa: E402

from vil_fusion_tpu.models import ba as jba  # noqa: E402
from vil_fusion_tpu.models import lidar_features as jlf  # noqa: E402
from vil_fusion_tpu.models import lidar_odometry as jlo  # noqa: E402
from vil_fusion_tpu.models import scancontext as jsc  # noqa: E402
from vil_fusion_tpu.parallel import batched_odometry as jbo  # noqa: E402
from vil_fusion_tpu.parallel import mesh as jmesh  # noqa: E402
from vil_fusion_tpu.parallel import sharded_ba as jsba  # noqa: E402
from vil_fusion_tpu.parallel.sharded_knn import knn_sharded as jknn_sharded  # noqa: E402
from vil_fusion_tpu.parallel.sharded_sc import detect_loop_sharded as jdetect  # noqa: E402
from vil_fusion_tpu.runtime import sim  # noqa: E402
from vil_fusion_tpu_torch.models import ba as tba  # noqa: E402
from vil_fusion_tpu_torch.models import lidar_features as tlf  # noqa: E402
from vil_fusion_tpu_torch.models import lidar_odometry as tlo  # noqa: E402
from vil_fusion_tpu_torch.models import scancontext as tsc  # noqa: E402
from vil_fusion_tpu_torch.ops.cuda import knn_cuda as tkc  # noqa: E402
from vil_fusion_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from vil_fusion_tpu_torch.utils import state_io  # noqa: E402

WORLD = 4
JOIN_TIMEOUT_S = 120
LIDAR = dict(n_scan=16, width=360, fov_up_deg=20.0, fov_down_deg=-20.0, min_range=1.0,
             edge_cap=256, surf_cap=1024)
ODOM = dict(edge_map_cap=2048, surf_map_cap=4096, approx_knn=False)
N_SEQ, ODOM_STEPS = 8, 2

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends."""
    yield
    jax.clear_caches()


def spawn(target, args_of_rank, tmp):
    """Start target(rank, WORLD, init_file, *args_of_rank(rank)) in WORLD
    spawned processes (join them with `join`)."""
    ctx = multiprocessing.get_context("spawn")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=target, args=(r, WORLD, init_file, *args_of_rank(r)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def join(procs, timeout=JOIN_TIMEOUT_S):
    """Join every rank within `timeout` seconds of this call; a rank that
    hangs is killed and fails the caller."""
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            p.join(max(0.0, deadline - time.monotonic()))
            assert p.exitcode == 0, f"rank {r}: exit code {p.exitcode} (None: still running)"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


@functools.lru_cache(maxsize=None)
def _ba_problem():
    """(window, feats, pre, lidar, prior) as JAX NamedTuples."""
    state_gt, feats, pre, lidar = make_problem(f_cap=64)
    st0 = perturb(state_gt, pos_sig=0.01, rot_sig=0.002, vel_sig=0.01)
    noise = np.random.default_rng(5).normal(0, 1e-3, feats.obs.shape).astype(np.float32)
    feats = feats._replace(obs=feats.obs + jnp.asarray(noise))
    return st0, feats, pre, lidar, jba.empty_prior(st0)


def _scans():
    scene = sim.RaycastScene()
    kw = dict(n_scan=16, width=360, fov_up_deg=20.0, fov_down_deg=-20.0)
    sc_scans = [sim.simulate_lidar_scan(scene, np.eye(3), np.array([1.2 * i, 0.1 * i, 1.5]), **kw)
                for i in range(40)]
    query = sim.simulate_lidar_scan(scene, np.eye(3), np.array([2.5, 0.25, 1.5]), **kw)
    odom = [sim.simulate_lidar_scan(scene, np.eye(3), np.array([3.0 + 2 * s, 0.5 * s, 1.5]), **kw)
            for s in range(N_SEQ)]
    return sc_scans, query, odom


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    knn = dict(db=rng.uniform(-50, 50, (2048, 3)).astype(np.float32),
               valid=rng.random(2048) > 0.1,
               q=rng.uniform(-50, 50, (128, 3)).astype(np.float32))
    sc_scans, query, odom = _scans()
    names = ("window", "feats", "pre", "lidar", "prior")
    ba = {k: state_io.to_numpy(x) for k, x in zip(names, _ba_problem())}
    return dict(
        knn=knn, ba=ba,
        sc=dict(capacity=256, scans=[(np.asarray(p), np.asarray(v)) for p, v in sc_scans],
                query=(np.asarray(query[0]), np.asarray(query[1]))),
        odom=dict(lidar=LIDAR, cfg=ODOM, steps=ODOM_STEPS,
                  points=np.stack([np.asarray(p) for p, _ in odom]).astype(np.float32),
                  valid=np.stack([np.asarray(v) for _, v in odom])))


def _jax_references(inputs, mesh):
    """The JAX package's sharded functions on make_mesh(4), jitted."""
    K, S, O = inputs["knn"], inputs["sc"], inputs["odom"]
    ref = {"knn": jax.jit(lambda q, db, v: jknn_sharded(mesh, q, db, v, k=5))(
        *(jnp.asarray(K[k]) for k in ("q", "db", "valid")))}
    jdb = jsc.init_db(S["capacity"])
    for pts, val in S["scans"]:
        jdb = jsc.add_keyframe(jdb, jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(val)))
    ref["sc"] = jdetect(mesh, jdb, jsc.make_descriptor(*(jnp.asarray(a) for a in S["query"])))
    ref["ba_step"] = jax.jit(lambda *a: jsba.optimize_step_sharded(
        mesh, *a, jba.BAConfig(max_iters=1)))(*_ba_problem())
    ref["ba_full"] = jax.jit(lambda *a: jsba.optimize_sharded(
        mesh, *a, jba.BAConfig(max_iters=8)))(*_ba_problem())
    ref["ba_4"] = jax.jit(lambda *a: jba.optimize(*a, jba.BAConfig(max_iters=4)))(*_ba_problem())
    jcfg = jlo.OdomConfig(lidar=jlf.LidarConfig(**LIDAR), **ODOM)
    states = jbo.shard_states(mesh, jlo.init_state_batched(jcfg, N_SEQ))
    for _ in range(ODOM_STEPS):
        states, out = jbo.odometry_step_sharded(mesh, states, jnp.asarray(O["points"]),
                                                jnp.asarray(O["valid"]), jcfg)
    ref["odom"] = (states, out)
    return jax.block_until_ready(ref)


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    """(the four ranks' results, the JAX references): the ranks are spawned
    once for the module and run while the references are computed."""
    tmp = str(tmp_path_factory.mktemp("gloo"))
    in_path = os.path.join(tmp, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    procs = spawn(worker.run, lambda r: (in_path, os.path.join(tmp, f"rank{r}.pkl")), tmp)
    try:
        ref = _jax_references(inputs, jmesh.make_mesh(WORLD))
    finally:
        join(procs)
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out, ref


@pytest.fixture(scope="module")
def ranks(run):
    return run[0]


@pytest.fixture(scope="module")
def jref(run):
    return run[1]


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        for a, b in zip(jax.tree.leaves(ranks[0][key]), jax.tree.leaves(r[key])):
            np.testing.assert_array_equal(a, b, err_msg=f"{key}: ranks differ")
    return ranks[0][key]


def test_mesh_and_rows(ranks):
    """make_mesh: the rank, the size and the named device; it raises for a
    world smaller than asked and where gloo is given no device; shard_rows
    raises on rows that do not divide; no process group: make_mesh raises;
    no active mesh: get_active_mesh and BAConfig(sharded=True) raise; no
    rank imported jax."""
    for r, res in enumerate(ranks):
        assert res["mesh"] == (r, WORLD, "cpu")
        assert res["too_many_raises"] and res["no_device_raises"] and res["rows_raise"]
        assert res["no_mesh_raises"]
        assert res["jax_imported"] is False
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh(WORLD)
    with pytest.raises(RuntimeError, match="no active mesh"):
        tmesh.get_active_mesh()
    with pytest.raises(RuntimeError, match="no active mesh"):
        tba.check_config(tba.BAConfig(sharded=True))


def test_knn_sharded(ranks, inputs, jref):
    """knn_sharded on 4 ranks: bit for bit the port's exact kNN over the
    whole map (indices too: ties keep the lower rank, i.e. the lower
    index), and within tests/test_parallel.py's tolerance of the JAX
    package's knn_sharded on make_mesh(4)."""
    d2, idx = _same_on_every_rank(ranks, "knn")
    q, db, v = (inputs["knn"][k] for k in ("q", "db", "valid"))
    d_ref, i_ref = tkc.knn_exact(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(v),
                                 k=5)
    np.testing.assert_array_equal(d2, d_ref.numpy())
    np.testing.assert_array_equal(idx, i_ref.numpy())
    d_j, _ = jref["knn"]
    np.testing.assert_allclose(d2, np.asarray(d_j), rtol=1e-3, atol=5e-3)
    got = ((q[:, None, :] - db[idx]) ** 2).sum(-1)
    np.testing.assert_allclose(got, np.asarray(d_j), rtol=1e-3, atol=5e-3)


def test_detect_loop_sharded(ranks, inputs, jref):
    """detect_loop_sharded on 4 ranks equals the port's detect_loop and the
    JAX package's detect_loop_sharded on make_mesh(4) (tests/test_parallel.py's
    40-keyframe database of 256 slots)."""
    i_sh, d_sh, s_sh = _same_on_every_rank(ranks, "sc")
    S = inputs["sc"]
    tdb = tsc.init_db(S["capacity"], device="cpu")
    for pts, val in S["scans"]:
        tsc.add_keyframe(tdb, tsc.make_descriptor(torch.from_numpy(pts), torch.from_numpy(val)))
    tq = tsc.make_descriptor(*(torch.from_numpy(a) for a in S["query"]))
    i_t, d_t, s_t = tsc.detect_loop(tdb, tq)
    assert int(i_sh) == int(i_t) and int(s_sh) == int(s_t)
    assert float(d_sh) == float(d_t)
    i_j, d_j, s_j = jref["sc"]
    assert int(i_sh) == int(i_j) and int(s_sh) == int(s_j)
    np.testing.assert_allclose(float(d_sh), float(d_j), atol=1e-5)


def _port_problem():
    return tuple(state_io.to_torch(c, state_io.to_numpy(x), "cpu") for c, x in zip(
        (tba.WindowState, tba.FeatureStore, tba.StackedPreint, tba.LidarConstraints,
         tba.MargPrior), _ba_problem()))


def test_optimize_step_sharded(ranks, jref):
    """One sharded GN step at fixed damping on 4 ranks against the JAX
    package's optimize_step_sharded on make_mesh(4) and against the port's
    build_system + schur_solve + _apply on one device."""
    res = _same_on_every_rank(ranks, "ba_step")
    st_j, ft_j, cost_j = jref["ba_step"]
    np.testing.assert_allclose(res["cost"], float(cost_j), rtol=1e-3)
    np.testing.assert_allclose(res["p"], np.asarray(st_j.p), atol=5e-4)
    np.testing.assert_allclose(res["inv_depth"], np.asarray(ft_j.inv_depth), atol=5e-4)
    st, ft, pre, lidar, prior = _port_problem()
    tcfg = tba.BAConfig(max_iters=1)
    sys_ = tba.build_system(st, ft, pre, lidar, prior, tcfg, 1.0)
    delta, delta_d = tba.schur_solve(sys_, torch.tensor(1e-4), tcfg)
    ref_st, ref_ft = tba._apply(st, ft, delta, delta_d, tcfg)
    np.testing.assert_allclose(res["cost"], float(sys_.cost), rtol=1e-3)
    np.testing.assert_allclose(res["p"], ref_st.p.numpy(), atol=5e-4)
    np.testing.assert_allclose(res["inv_depth"], ref_ft.inv_depth.numpy(), atol=5e-4)


def test_optimize_sharded(ranks, jref):
    """The full annealed LM loop (accept / reject, the Cauchy schedule,
    re-anchoring) on 4 ranks against the JAX package's optimize_sharded on
    make_mesh(4) and the port's ba.optimize on one device."""
    res = _same_on_every_rank(ranks, "ba_full")
    st_j, ft_j, cost_j = jref["ba_full"]
    st_t, ft_t, cost_t = tba.optimize(*_port_problem(), tba.BAConfig(max_iters=8))
    for name, (p, q, d, c) in (("JAX", (st_j.p, st_j.q, ft_j.inv_depth, cost_j)),
                               ("port", (st_t.p, st_t.q, ft_t.inv_depth, cost_t))):
        np.testing.assert_allclose(res["cost"], float(c), rtol=1e-3, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(res["p"], np.asarray(p), atol=5e-3, err_msg=name)
        np.testing.assert_allclose(res["q"], np.asarray(q), atol=1e-3, err_msg=name)
        np.testing.assert_allclose(res["inv_depth"], np.asarray(d), atol=5e-3, err_msg=name)


def test_optimize_on_active_mesh(ranks, jref):
    """BAConfig(sharded=True, max_iters=4) through the estimator's BA
    dispatch on the active mesh (4 ranks) against the unsharded ba.optimize
    of the JAX package (as tests/test_parallel.py:74-97 holds its own) and
    of the port."""
    res = _same_on_every_rank(ranks, "ba_active")
    st_j, _, cost_j = jref["ba_4"]
    st_t, _, cost_t = tba.optimize(*_port_problem(), tba.BAConfig(max_iters=4))
    for name, (p, c) in (("JAX", (st_j.p, cost_j)), ("port", (st_t.p, cost_t))):
        np.testing.assert_allclose(res["cost"], float(c), rtol=1e-3, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(res["p"], np.asarray(p), atol=1e-3, err_msg=name)


def test_odometry_step_sharded(ranks, inputs, jref):
    """8 sequences over 4 ranks (2 a rank, one batched step each) for 2
    steps: each rank's sequences against the JAX package's
    odometry_step_sharded on make_mesh(4) and the port's single-sequence
    odometry_step, 1e-4 m (tests/test_parallel.py:169-171)."""
    O = inputs["odom"]
    got_p = np.concatenate([r["odom"]["p"] for r in ranks])
    got_out = np.concatenate([r["odom"]["out_p"] for r in ranks])
    assert got_p.shape == (N_SEQ, 3)
    states, out = jref["odom"]
    np.testing.assert_allclose(got_p, np.asarray(states.p), atol=1e-4)
    np.testing.assert_allclose(got_out, np.asarray(out[1]), atol=1e-4)
    tcfg = tlo.OdomConfig(lidar=tlf.LidarConfig(**LIDAR), **ODOM)
    for s in (0, 3, 7):
        st = tlo.init_state(tcfg, device="cpu")
        for f in range(ODOM_STEPS):
            st, _ = tlo.odometry_step(st, torch.from_numpy(O["points"][s]),
                                      torch.from_numpy(O["valid"][s]), tcfg, frame_count=f)
        np.testing.assert_allclose(got_p[s], st.p.numpy(), atol=1e-4)


@pytest.mark.slow
def test_pipeline_sharded_ba_deployed_e2e(tmp_path):
    """The counterpart of tests/test_parallel.py's deployed mode: the port's
    VILFusionPipeline driven over tests/test_pipeline.py's 28 frames with
    ba_overrides={"sharded": True} on 4 gloo ranks reproduces the unsharded
    pipeline's trajectory within 2e-2 m (reduction order compounds through
    28 frames of LM and marginalization); no restart."""
    tmp = str(tmp_path)
    join(spawn(worker.run_pipeline, lambda r: (os.path.join(tmp, f"rank{r}.pkl"),), tmp),
         timeout=1800)
    with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
        res = pickle.load(f)
    assert res["restarts"] == 0 and res["jax_imported"] is False
    p_ref, restarts = worker.drive_pipeline(None)
    assert restarts == 0
    assert len(res["vio_p"]) == len(p_ref) == 28
    np.testing.assert_allclose(res["vio_p"], p_ref, atol=2e-2)
