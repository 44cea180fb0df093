"""Loop-closure stack of the port against vil_fusion_tpu: ScanContext, ICP,
the pose graph and global fusion's keyframe / submap-ICP programs.
Fixtures follow test_loops.py; tolerances are stated in each assert."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import global_fusion as jgf
from vil_fusion_tpu.models import icp as jicp
from vil_fusion_tpu.models import posegraph as jpg
from vil_fusion_tpu.models import scancontext as jsc
from vil_fusion_tpu.ops import lie as jlie
from vil_fusion_tpu.runtime import sim
from vil_fusion_tpu_torch.models import global_fusion as tgf
from vil_fusion_tpu_torch.models import icp as ticp
from vil_fusion_tpu_torch.models import posegraph as tpg
from vil_fusion_tpu_torch.models import scancontext as tsc
from vil_fusion_tpu_torch.utils import state_io

torch.set_num_threads(2)


def _scan_at(scene, R, p):
    return sim.simulate_lidar_scan(scene, R, p, n_scan=32, width=900, fov_up_deg=30.0,
                                   fov_down_deg=-30.0, max_range=80.0)


def _yaw_R(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def revisit_scans():
    """test_loops.py:27-45: 40 keyframes along a path, then a revisit of
    keyframe 2's place with a 90-degree yaw."""
    scene = sim.RaycastScene()
    p0 = np.array([20.0, 2.0, 1.5])
    scans = [_scan_at(scene, _yaw_R(0.05 * i), p0 + np.array([1.2 * i, 0.1 * i, 0.0]))
             for i in range(40)]
    query = _scan_at(scene, _yaw_R(np.pi / 2), p0 + np.array([2.4, 0.2, 0.0]))
    return scans, query


def test_scancontext_descriptor_matches(revisit_scans):
    """Descriptor (max height per polar cell) and ring key: exact."""
    scans, query = revisit_scans
    for pts, val in scans[:3] + [query]:
        dj = np.asarray(jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(val)))
        dt = tsc.make_descriptor(_t(pts), _t(val))
        np.testing.assert_array_equal(dt.numpy(), dj)
        np.testing.assert_allclose(tsc.ring_key(dt).numpy(), np.asarray(jsc.ring_key(dj)),
                                   rtol=1e-6)


def test_scancontext_insert_and_detect_match(revisit_scans):
    """Insert 40 keyframes, detect the yawed revisit: the same candidate and
    shift, distance within 1e-5; the database itself exact; the port meets
    test_loops.py's acceptance (dist < SC_DIST_THRES, |idx - 2| <= 2, yaw
    error < 0.3 rad)."""
    scans, query = revisit_scans
    jdb, tdb = jsc.init_db(256), tsc.init_db(256, device="cpu")
    for pts, val in scans:
        jdb = jsc.add_keyframe(jdb, jsc.make_descriptor(jnp.asarray(pts), jnp.asarray(val)))
        tdb = tsc.add_keyframe(tdb, tsc.make_descriptor(_t(pts), _t(val)))
    assert int(tdb.count) == 40
    np.testing.assert_array_equal(tdb.desc.numpy(), np.asarray(jdb.desc))
    np.testing.assert_allclose(tdb.ring_key.numpy(), np.asarray(jdb.ring_key), rtol=1e-6)
    qj = jsc.make_descriptor(jnp.asarray(query[0]), jnp.asarray(query[1]))
    qt = tsc.make_descriptor(_t(query[0]), _t(query[1]))
    ij, dj, sj = jsc.detect_loop(jdb, qj)
    it, dt, st = tsc.detect_loop(tdb, qt)
    assert int(it) == int(ij) and int(st) == int(sj)
    assert abs(float(dt) - float(dj)) < 1e-5
    assert float(dt) < tsc.SC_DIST_THRES and abs(int(it) - 2) <= 2
    yaw_err = (float(tsc.shift_to_yaw(st)) - np.pi / 2 + np.pi) % (2 * np.pi) - np.pi
    assert abs(yaw_err) < 0.3


def test_scancontext_full_db_and_recency():
    """A full database drops inserts without moving count past capacity;
    with fewer than NUM_EXCLUDE_RECENT + 1 entries nothing is usable (inf),
    exactly as in JAX."""
    rng = np.random.default_rng(0)
    descs = rng.uniform(0, 3, (5, tsc.N_RING, tsc.N_SECTOR)).astype(np.float32)
    jdb, tdb = jsc.init_db(4), tsc.init_db(4, device="cpu")
    for d in descs:
        jdb = jsc.add_keyframe(jdb, jnp.asarray(d))
        tdb = tsc.add_keyframe(tdb, _t(d))
    assert int(tdb.count) == int(jdb.count) == 4
    np.testing.assert_array_equal(tdb.desc.numpy(), np.asarray(jdb.desc))
    ij, dj, _ = jsc.detect_loop(jsc.init_db(64), jnp.asarray(descs[0]))
    it, dt, _ = tsc.detect_loop(tsc.init_db(64, device="cpu"), _t(descs[0]))
    assert np.isinf(float(dt)) and np.isinf(float(dj)) and int(it) == int(ij)


def _icp_fixture():
    """test_loops.py:61-82: two walls + ground, source offset by a known
    transform."""
    rng = np.random.default_rng(0)
    n = 1200
    tgt = np.concatenate([
        np.stack([rng.uniform(-10, 10, n), rng.uniform(-8, 8, n), np.zeros(n)], -1),
        np.stack([rng.uniform(-10, 10, n), np.full(n, 8.0), rng.uniform(0, 4, n)], -1),
        np.stack([np.full(n, 10.0), rng.uniform(-8, 8, n), rng.uniform(0, 4, n)], -1),
    ]).astype(np.float32)
    q_true = np.asarray(jlie.so3_exp(jnp.asarray([0.03, -0.02, 0.3], jnp.float32)))
    p_true = np.array([0.8, -0.5, 0.2], np.float32)
    R_true = np.asarray(jlie.q2R(jnp.asarray(q_true)))
    src = ((tgt[::2] - p_true) @ R_true).astype(np.float32)
    return src, tgt, q_true, p_true


def test_icp_matches():
    """Pose within 1e-4 m / 1e-4 rad of JAX's, fitness within 1e-5 of it
    (both converge to the f32 rounding floor, a few 1e-6 m^2); the port
    meets test_loops.py's acceptance (fitness < 0.05, 0.05 m,
    0.02 rad)."""
    src, tgt, q_true, p_true = _icp_fixture()
    qj, pj, fj = jicp.icp_point2point(jnp.asarray(src), jnp.ones(len(src), bool),
                                      jnp.asarray(tgt), jnp.ones(len(tgt), bool),
                                      jnp.asarray([1.0, 0, 0, 0]), jnp.zeros(3))
    qt, pt, ft = ticp.icp_point2point(_t(src), torch.ones(len(src), dtype=torch.bool),
                                      _t(tgt), torch.ones(len(tgt), dtype=torch.bool),
                                      torch.tensor([1.0, 0, 0, 0]), torch.zeros(3))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    assert 2 * np.arccos(min(1.0, abs(float(np.dot(qt.numpy(), np.asarray(qj)))))) < 1e-4
    assert abs(float(ft) - float(fj)) < 1e-5
    assert float(ft) < 0.05 and np.linalg.norm(pt.numpy() - p_true) < 0.05
    assert 2 * np.arccos(min(1.0, abs(float(np.dot(qt.numpy(), q_true))))) < 0.02


def test_icp_too_few_matches_is_inf():
    """Under 30% of the valid source matched within max_corr_dist: inf, as
    in JAX."""
    src, tgt, _, _ = _icp_fixture()
    far = src + 500.0
    args_j = (jnp.asarray(far), jnp.ones(len(src), bool), jnp.asarray(tgt),
              jnp.ones(len(tgt), bool), jnp.asarray([1.0, 0, 0, 0]), jnp.zeros(3))
    _, _, fj = jicp.icp_point2point(*args_j, iters=3)
    _, _, ft = ticp.icp_point2point(_t(far), torch.ones(len(src), dtype=torch.bool), _t(tgt),
                                    torch.ones(len(tgt), dtype=torch.bool),
                                    torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), iters=3)
    assert np.isinf(float(ft)) and np.isinf(float(fj))


def _square_graph_measurements():
    """test_loops.py:85-121: a square path with drifting odometry and one
    loop edge back to the start, as numpy measurements."""
    n_side, yaw_step = 10, np.pi / 2
    q = np.array([1.0, 0, 0, 0], np.float32)
    p = np.zeros(3, np.float32)
    gt = [(jnp.asarray(q), jnp.asarray(p))]
    nodes = [(q, p, q, np.zeros(3, np.float32))]
    qa, pa = jnp.asarray(q), jnp.asarray(p)
    for k in range(4 * n_side):
        q_rel_gt = (jlie.so3_exp(jnp.asarray([0.0, 0.0, yaw_step], jnp.float32))
                    if (k + 1) % n_side == 0 else jnp.asarray([1.0, 0, 0, 0], jnp.float32))
        p_rel_gt = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
        gt.append(jlie.pose_compose(gt[-1], (q_rel_gt, p_rel_gt)))
        p_rel = p_rel_gt + jnp.asarray([0.01, 0.004, 0.0], jnp.float32)
        q_rel = jlie.qmul(q_rel_gt, jlie.so3_exp(jnp.asarray([0.0, 0.0, 0.006], jnp.float32)))
        qa, pa = jlie.pose_compose((qa, pa), (q_rel, p_rel))
        nodes.append(tuple(np.asarray(x) for x in (qa, pa, q_rel, p_rel)))
    n = 4 * n_side
    loop = tuple(np.asarray(x) for x in jlie.pose_between(gt[0], gt[n]))
    return nodes, loop, n, np.asarray(gt[n][1])


@pytest.fixture(scope="module")
def square_graphs():
    nodes, loop, n, p_gt_n = _square_graph_measurements()
    jg, tg = jpg.init_graph(256, 32), tpg.init_graph(256, 32, device="cpu")
    for qa, pa, qr, pr in nodes:
        jg = jpg.add_node(jg, *(jnp.asarray(x) for x in (qa, pa, qr, pr)))
        tg = tpg.add_node(tg, *(_t(x) for x in (qa, pa, qr, pr)))
    jg = jpg.add_loop(jg, jnp.int32(0), jnp.int32(n), jnp.asarray(loop[0]), jnp.asarray(loop[1]))
    tg = tpg.add_loop(tg, 0, n, _t(loop[0]), _t(loop[1]))
    return jg, tg, n, p_gt_n


def test_posegraph_build_matches(square_graphs):
    """add_node / add_loop leave identical graphs (exact)."""
    jg, tg, _, _ = square_graphs
    a, b = state_io.to_numpy(jg), state_io.to_numpy(tg)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("bucketed", [True, False])
def test_posegraph_optimize_matches(square_graphs, bucketed):
    """optimize_bucketed (64-slot bucket of a 256-slot graph) and the full
    optimize: positions within 1e-4 of JAX's, |<q_port, q_jax>| within 1e-5
    of 1 (test_loops.py:124-148 tolerances); the loop closes (drift after <
    0.2 x before)."""
    jg, tg, n, p_gt_n = square_graphs
    if bucketed:
        oj, ot = jpg.optimize_bucketed(jg, n + 1), tpg.optimize_bucketed(tg, n + 1)
    else:
        oj, ot = jpg.optimize(jg), tpg.optimize(tg)
    assert ot.q.shape == tg.q.shape
    np.testing.assert_allclose(ot.p[: n + 1].numpy(), np.asarray(oj.p[: n + 1]), atol=1e-4)
    dots = np.abs(np.sum(ot.q[: n + 1].numpy() * np.asarray(oj.q[: n + 1]), axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)
    before = np.linalg.norm(tg.p[n].numpy() - p_gt_n)
    after = np.linalg.norm(ot.p[n].numpy() - p_gt_n)
    assert before > 0.3 and after < 0.2 * before


@pytest.fixture(scope="module")
def fusion_pair():
    """JAX and port GlobalFusion fed the same 6 keyframes (odometry = ground
    truth along a straight path, 2.5 m apart)."""
    scene = sim.RaycastScene()
    kw = dict(node_capacity=64, loop_capacity=8, cloud_capacity=1024, submap_half_span=3)
    jf = jgf.GlobalFusion(jgf.GlobalFusionConfig(**kw))
    tf = tgf.GlobalFusion(tgf.GlobalFusionConfig(**kw), device="cpu")
    for i in range(6):
        R, p = _yaw_R(0.04 * i), np.array([10.0 + 2.5 * i, 0.5, 1.5])
        q = sim.R_to_q(R).astype(np.float32)
        pts, val = _scan_at(scene, R, p)
        jf.add_frame(jnp.asarray(q), jnp.asarray(p, jnp.float32), jnp.asarray(pts),
                     jnp.asarray(val), t=float(i))
        tf.add_frame(q, p.astype(np.float32), _t(pts), _t(val), t=float(i))
    jf.flush()
    tf.flush()
    return jf, tf


def test_global_fusion_keyframes_match(fusion_pair):
    """Keyframe gate, graph, ScanContext database and cloud store agree:
    bookkeeping exact, graph poses atol 1e-5, descriptors exact, clouds
    exact (the subsample indices agree at 28,800 points / 1024 slots)."""
    jf, tf = fusion_pair
    assert tf.n_kf == jf.n_kf == 6 and tf.kf_ts == jf.kf_ts
    a, b = state_io.global_fusion_to_numpy(jf), state_io.global_fusion_to_numpy(tf)
    for k in ("n_nodes", "n_loops", "loop_valid"):
        np.testing.assert_array_equal(b["graph"][k], a["graph"][k])
    for k in ("q", "p", "odo_q", "odo_p"):
        np.testing.assert_allclose(b["graph"][k], a["graph"][k], atol=1e-5)
    np.testing.assert_array_equal(b["scdb"]["desc"], a["scdb"]["desc"])
    np.testing.assert_array_equal(b["scdb"]["count"], a["scdb"]["count"])
    np.testing.assert_array_equal(b["cloud_valid"], a["cloud_valid"])
    np.testing.assert_array_equal(b["clouds"], a["clouds"])
    qj, pj = jf.poses()
    qt, pt = tf.poses()
    np.testing.assert_allclose(pt, pj, atol=1e-5)


def test_submap_icp_from_carried_state(fusion_pair):
    """Carry the JAX fusion state into a fresh port GlobalFusion (state_io)
    and verify keyframe 5 against the submap around keyframe 1 in both: pose
    within 1e-3 m / 1e-3 rad, fitness within rtol 1e-2 (25 ICP iterations of
    f32 Kabsch on 7k points)."""
    jf, _ = fusion_pair
    tf = tgf.GlobalFusion(tgf.GlobalFusionConfig(**jf.cfg._asdict()), device="cpu")
    state_io.global_fusion_load(tf, state_io.global_fusion_to_numpy(jf))
    assert tf.n_kf == 6
    i, j, yaw0 = 5, 1, 0.2
    ks = np.clip(np.arange(j - 3, j + 4), 0, 5)
    dup = np.zeros(len(ks), bool)
    dup[1:] = ks[1:] == ks[:-1]
    qj, pj, fj = jgf._submap_icp(jf.graph.q, jf.graph.p, jf.clouds, jf.cloud_valid,
                                 jnp.asarray(ks, jnp.int32), jnp.asarray(dup), jnp.int32(i),
                                 jnp.int32(j), jnp.asarray(yaw0, jnp.float32))
    qt, pt, ft = tgf._submap_icp(tf.graph.q, tf.graph.p, tf.clouds, tf.cloud_valid,
                                 torch.from_numpy(ks), torch.from_numpy(dup), i, j, yaw0)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    assert 2 * np.arccos(min(1.0, abs(float(np.dot(qt.numpy(), np.asarray(qj)))))) < 1e-3
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-2)
    tf.prewarm()  # the port's rare-event path runs on carried state too
    assert tf._pending_icp == []
