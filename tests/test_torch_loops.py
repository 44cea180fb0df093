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


def _kabsch_svd(H):
    """The reference's Kabsch (models/icp.py): V diag(1, 1, d) U^T of the
    SVD H = U S V^T, d = sign det(V U^T), in float64 numpy."""
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    return Vt.T @ np.diag([1.0, 1.0, d]) @ U.T


@pytest.mark.parametrize("case", ["random", "near-planar", "reflected", "noisy"])
def test_kabsch_rotation_matches_svd(case):
    """ops/linalg.kabsch_rotation (Horn's quaternion by repeated squaring,
    the capturable replacement of the reference's torch / jnp SVD) against
    numpy's SVD Kabsch with the reflection fix: within 1e-9 in float64 and
    2e-6 in float32 (the input rounded to float32) on random point pairs,
    a near-planar cloud (one singular value 1e-6 of the others), a
    reflected one (det H < 0, where the fix picks the proper rotation) and
    heavy noise; always a rotation (R^T R = I within 1e-6, det 1)."""
    rng = np.random.default_rng(["random", "near-planar", "reflected", "noisy"].index(case))
    x = rng.normal(size=(200, 3))
    if case == "near-planar":
        x[:, 2] *= 1e-6
    R_true = np.asarray(jlie.q2R(jlie.qnormalize(jnp.asarray(rng.normal(size=4)))), np.float64)
    y = x @ R_true.T
    if case == "reflected":
        y = y * np.array([1.0, 1.0, -1.0])
    if case == "noisy":
        y = y + rng.normal(scale=2.0, size=y.shape)
    xc, yc = x - x.mean(0), y - y.mean(0)
    H = xc.T @ yc
    want = _kabsch_svd(H)
    if case == "reflected":
        assert np.linalg.det(H) < 0
    got = ticp.linalg.kabsch_rotation(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9)
    got32 = ticp.linalg.kabsch_rotation(torch.from_numpy(H.astype(np.float32))).numpy()
    np.testing.assert_allclose(got32, _kabsch_svd(H.astype(np.float32).astype(np.float64)),
                               atol=2e-6)
    np.testing.assert_allclose(got32.T @ got32, np.eye(3), atol=1e-6)
    assert abs(np.linalg.det(got32) - 1.0) < 1e-6


def test_kabsch_rotation_of_nothing_is_identity():
    """No correspondence (H = 0, every ICP weight 0): the identity, as the
    reference's SVD of a zero matrix gives (U = V = I, d = 1)."""
    assert torch.equal(ticp.linalg.kabsch_rotation(torch.zeros(3, 3)), torch.eye(3))
    U, _, Vt = (np.asarray(a) for a in jnp.linalg.svd(jnp.zeros((3, 3))))
    np.testing.assert_array_equal(Vt.T @ U.T, np.eye(3))


def _next_keyframe(jf, tf, k):
    """Keyframe number `k` of fusion_pair's path (a pose and a scan)."""
    scene = sim.RaycastScene()
    R, p = _yaw_R(0.04 * k), np.array([10.0 + 2.5 * k, 0.5, 1.5])
    pts, val = _scan_at(scene, R, p)
    return sim.R_to_q(R).astype(np.float32), p.astype(np.float32), pts, val


@pytest.mark.parametrize("first", [True, False], ids=["first", "not-first"])
def test_keyframe_program_matches(fusion_pair, first):
    """The port's _keyframe_program (its pure part through the step
    wrapper's body on the CPU, then the three in-place row writes) against
    the reference's jitted program on the same state: the first keyframe of
    an empty fusion, and keyframe 6 after fusion_pair's six (the JAX state
    carried over). Graph poses within 1e-5, the database's ring keys
    (means) within rtol 1e-6, the rest of the graph and the database, the
    clouds and the loop query's candidate and shift exact, its distance
    within rtol 1e-6."""
    jf, _ = fusion_pair
    cfg = tgf.GlobalFusionConfig(**jf.cfg._asdict())
    tf = tgf.GlobalFusion(cfg, device="cpu")
    jcfg = jgf.GlobalFusionConfig(**jf.cfg._asdict())
    jg, jdb = jpg.init_graph(cfg.node_capacity, cfg.loop_capacity), jsc.init_db(cfg.node_capacity)
    jc = jnp.zeros((cfg.node_capacity, cfg.cloud_capacity, 3))
    jv = jnp.zeros((cfg.node_capacity, cfg.cloud_capacity), bool)
    i = 0
    q_prev, p_prev = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    if not first:
        state_io.global_fusion_load(tf, state_io.global_fusion_to_numpy(jf))
        jg, jdb, jc, jv = jf.graph, jf.scdb, jf.clouds, jf.cloud_valid
        i, q_prev, p_prev = jf.n_kf, jf.last_q, jf.last_p
    assert jcfg == jf.cfg
    q, p, pts, val = _next_keyframe(jf, tf, i)
    if first:
        q_prev, p_prev = q, p
    jout = jgf._keyframe_program(jg, jdb, jc, jv, *(jnp.asarray(x) for x in (q_prev, p_prev, q, p)),
                                 jnp.asarray(pts), jnp.asarray(val), jnp.int32(i), first)
    tout = tgf._keyframe_program(tf.graph, tf.scdb, tf.clouds, tf.cloud_valid,
                                 *(_t(x) for x in (q_prev, p_prev, q, p)), _t(pts), _t(val),
                                 i, first)
    a, b = state_io.to_numpy(jout[0]), state_io.to_numpy(tout[0])
    for k in a:
        if k in ("q", "p", "odo_q", "odo_p"):
            np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    a, b = state_io.to_numpy(jout[1]), state_io.to_numpy(tout[1])
    for k in a:  # ring keys are means: rtol 1e-6, as test_scancontext_insert_and_detect_match
        if k == "ring_key":
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for x, y in zip(tout[2:4], jout[2:4]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(tout[4]) == int(jout[4]) and int(tout[6]) == int(jout[6])
    np.testing.assert_allclose(float(tout[5]), float(jout[5]), rtol=1e-6)


def test_keyframe_values_write_nothing(fusion_pair):
    """The keyframe program's pure part (what the card's graph replays)
    leaves the graph, the database and the clouds as they were, and its
    loop query equals detect_loop after an in-place insert."""
    jf, _ = fusion_pair
    tf = tgf.GlobalFusion(tgf.GlobalFusionConfig(**jf.cfg._asdict()), device="cpu")
    state_io.global_fusion_load(tf, state_io.global_fusion_to_numpy(jf))
    before = state_io.global_fusion_to_numpy(tf)
    q, p, pts, val = _next_keyframe(jf, tf, tf.n_kf)
    out = tgf._keyframe_values(tf.graph.q, tf.graph.p, tf.scdb, _t(jf.last_q), _t(jf.last_p),
                               _t(q), _t(p), _t(pts), _t(val), torch.tensor(tf.n_kf),
                               first=False, cap=tf.clouds.shape[1])
    after = state_io.global_fusion_to_numpy(tf)
    for k in ("clouds", "cloud_valid"):
        np.testing.assert_array_equal(after[k], before[k])
    for part in ("graph", "scdb"):
        for k in before[part]:
            np.testing.assert_array_equal(after[part][k], before[part][k])
    db = tsc.add_keyframe(tsc.ScanContextDB(*(x.clone() for x in tf.scdb)), out[4])
    for x, y in zip(out[5:8], tsc.detect_loop(db, out[4])):
        assert torch.equal(x, y)


def test_submap_icp_takes_number_leaves(fusion_pair):
    """_submap_icp's body with i, j and yaw0 as 0-d tensors (how the card's
    graph holds them) gives what it gives with host numbers, bit for bit."""
    jf, _ = fusion_pair
    tf = tgf.GlobalFusion(tgf.GlobalFusionConfig(**jf.cfg._asdict()), device="cpu")
    state_io.global_fusion_load(tf, state_io.global_fusion_to_numpy(jf))
    ks = torch.from_numpy(np.clip(np.arange(-2, 5), 0, 5))
    dup = torch.zeros(7, dtype=torch.bool)
    dup[1:] = ks[1:] == ks[:-1]
    args = (tf.graph.q, tf.graph.p, tf.clouds, tf.cloud_valid, ks, dup)
    a = tgf._submap_icp(*args, 5, 1, 0.2)
    b = tgf._submap_icp_body(*args, torch.tensor(5, dtype=torch.int32),
                             torch.tensor(1, dtype=torch.int32), torch.tensor(0.2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_add_frame_from_tensors_or_host_arrays():
    """GlobalFusion.add_frame fed the odometry poses as tensors and as host
    arrays (what the pipeline passes) builds the same graph, database and
    clouds, bit for bit."""
    scene = sim.RaycastScene()
    kw = dict(node_capacity=32, loop_capacity=4, cloud_capacity=512, submap_half_span=2)
    fs = [tgf.GlobalFusion(tgf.GlobalFusionConfig(**kw), device="cpu") for _ in range(2)]
    for i in range(4):
        R, p = _yaw_R(0.05 * i), np.array([5.0 + 3.0 * i, 0.0, 1.5])
        q = sim.R_to_q(R).astype(np.float32)
        pts, val = _scan_at(scene, R, p)
        fs[0].add_frame(q, p.astype(np.float32), _t(pts), _t(val), t=float(i))
        fs[1].add_frame(torch.from_numpy(q), torch.from_numpy(p.astype(np.float32)), _t(pts),
                        _t(val), t=float(i))
    a, b = (state_io.global_fusion_to_numpy(f) for f in fs)
    assert fs[0].n_kf == fs[1].n_kf == 4
    for part in ("graph", "scdb"):
        for k in a[part]:
            np.testing.assert_array_equal(b[part][k], a[part][k], err_msg=k)
    np.testing.assert_array_equal(b["clouds"], a["clouds"])
    np.testing.assert_array_equal(b["cloud_valid"], a["cloud_valid"])


def test_scancontext_with_keyframe_is_the_insert(revisit_scans):
    """sc.with_keyframe (the keyframe graph's copy) equals the in-place
    add_keyframe, and leaves its database as it was; also when full."""
    scans, _ = revisit_scans
    for cap, n in ((8, 3), (2, 3)):
        db = tsc.init_db(cap, device="cpu")
        for pts, val in scans[:n]:
            desc = tsc.make_descriptor(_t(pts), _t(val))
            before = [x.clone() for x in db]
            new = tsc.with_keyframe(db, desc)
            assert all(torch.equal(x, y) for x, y in zip(db, before))
            db = tsc.add_keyframe(db, desc)
            assert all(torch.equal(x, y) for x, y in zip(new, db))


def test_cpu_fusion_has_no_stream(fusion_pair):
    """On the CPU global fusion has no stream and records no event: prewarm
    (an ICP verification and a relaxation, results dropped) leaves graph,
    database and clouds as they were, bit for bit, and poses() reads the
    graph."""
    _, tf = fusion_pair
    assert tf.stream is None and not tf._done and tf.max_in_flight == 1
    before = state_io.global_fusion_to_numpy(tf)
    tf.prewarm()
    after = state_io.global_fusion_to_numpy(tf)
    for part in ("graph", "scdb"):
        for k in before[part]:
            np.testing.assert_array_equal(after[part][k], before[part][k], err_msg=k)
    np.testing.assert_array_equal(after["clouds"], before["clouds"])
    assert tf.stream is None and not tf._done and not tf._pending_icp
    q, p = tf.poses()
    np.testing.assert_array_equal(p, before["graph"]["p"][:tf.n_kf])
    np.testing.assert_array_equal(q, before["graph"]["q"][:tf.n_kf])


class _StandInEvent:
    """A CUDA event's stand-in: `passed` until synchronize() makes it so."""

    def __init__(self, passed: bool):
        self.passed, self.waits = passed, 0

    def query(self):
        return self.passed

    def synchronize(self):
        self.waits += 1
        self.passed = True


@pytest.mark.parametrize("passed", [False, True], ids=["outstanding", "passed"])
def test_backlog_waits_for_the_keyframe_backlog_back(monkeypatch, passed):
    """The fusion stream's backlog with stand-in events for the keyframes'
    done events. Every keyframe's work outstanding: keyframe i waits inside
    the span "global_fusion.backlog_wait" exactly when i >= BACKLOG, and for
    keyframe i - BACKLOG's event alone; "global_fusion.stream_busy" counts
    every keyframe after the first; never more than BACKLOG keyframes in
    flight. Every keyframe's work finished: no wait, no count, one in
    flight."""
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    scene = sim.RaycastScene()
    kw = dict(node_capacity=32, loop_capacity=4, cloud_capacity=256, submap_half_span=2)
    f = tgf.GlobalFusion(tgf.GlobalFusionConfig(**kw), device="cpu")
    events = []

    def mark_done():
        events.append(_StandInEvent(passed))
        f._done.append(events[-1])

    monkeypatch.setattr(f, "_mark_done", mark_done)
    backlog = tgf.GlobalFusion.BACKLOG
    for i in range(backlog + 3):
        waits0 = GLOBAL_TIMERS.summary().get("global_fusion.backlog_wait", {}).get("n", 0)
        busy0 = GLOBAL_TIMERS.counters["global_fusion.stream_busy"]
        R, p = _yaw_R(0.05 * i), np.array([5.0 + 3.0 * i, 0.0, 1.5])
        pts, val = _scan_at(scene, R, p)
        f.add_frame(sim.R_to_q(R).astype(np.float32), p.astype(np.float32), _t(pts), _t(val),
                    t=float(i))
        waited = GLOBAL_TIMERS.summary().get("global_fusion.backlog_wait", {}).get("n", 0) - waits0
        busy = GLOBAL_TIMERS.counters["global_fusion.stream_busy"] - busy0
        assert f.n_kf == i + 1 and len(events) == i + 1
        if passed:
            assert waited == 0 and busy == 0
        else:
            assert waited == int(i >= backlog) and busy == int(i >= 1)
            assert [k for k, e in enumerate(events) if e.waits] == list(range(i - backlog + 1))
            assert len(f._done) == min(i + 1, backlog)
    assert all(e.waits <= 1 for e in events)
    assert f.max_in_flight == (1 if passed else backlog)
