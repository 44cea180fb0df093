"""models/visual_loop.py of the port against vil_fusion_tpu's.

Keyframes rendered by the simulator (240 x 320, tests/test_visual_loop.py's
camera and keyframe inputs) go into both databases: descriptors, validity,
word histograms and the graph bit for bit, 3-D anchors and normalized
extra corners equal. Verification (`find_connection`) takes the RANSAC
samples the JAX key draws, injected with `sel=`: the same Hamming
survivors and PnP inliers, the relative pose within 1e-4 (float32 PnP
Gauss-Newton on the same samples). The loop bookkeeping (`close_loop`,
`apply_drift_to_vio`, `sync_from_graph`) follows the reference within
1e-4 m / rad (the 4-DoF solve, test_torch_posegraph4dof.py: 1e-5), the
two-tier detection gates exactly, and `save` / `load` carry a database
across the packages both ways.

The reference's jitted programs, which the port replays as CUDA graphs on
the card: the keyframe program's pure part (`_keyframe_values`) against the
reference's pieces (bit for bit, the densification's depths within 1e-5),
the PnP RANSAC on uniforms drawn before its graph (bit for bit the port on
the JAX key's samples; the same draws as the generator path), and the DB's
programs through their graph path (graphs.step mocked on the CPU) on a
worker thread holding a step lock, bit for bit the eager DB.

Left out of the parity cases: a loop between two sessions, where the port
drops the reference's drift bound (a fixed reference bug, tested on the
port alone below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import brief as jb
from vil_fusion_tpu.models import cameras as jcam
from vil_fusion_tpu.models import visual_loop as jvl
from vil_fusion_tpu.ops import image as jim
from vil_fusion_tpu.runtime import sim
from vil_fusion_tpu_torch.models import brief as tb
from vil_fusion_tpu_torch.models import visual_loop as tvl
from vil_fusion_tpu_torch.utils import state_io

torch.set_num_threads(2)
H, W = 240, 320
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
CAM_J = jcam.PinholeCamera(fx=250.0, fy=250.0, cx=W / 2, cy=H / 2)
CAM_T = state_io.camera_to_torch(CAM_J)
CFG = dict(capacity=16, win_cap=64, extra_cap=128)
# keyframe poses (position, yaw): two views of one place, one elsewhere
POSES = (([3.0, 0.0, 1.5], 0.0), ([3.1, 0.05, 1.5], 0.02), ([6.0, 3.0, 1.5], 0.3))


def _keyframe(p_wb, yaw, pose_offset=np.zeros(3)):
    """tests/test_visual_loop.py's keyframe inputs: window points are the
    detected corners with their raycast depth; `pose_offset` moves the
    stored position only (the verification then measures it as the
    keyframes' displacement)."""
    scene = sim.RaycastScene()
    c, s = np.cos(yaw), np.sin(yaw)
    R_wb = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    R_wc = R_wb @ R_BC
    img = sim.render_camera_image(scene, R_wc, p_wb, 250.0, 250.0, W / 2, H / 2, H, W)
    pxj, pval = jim.detect_features(jnp.asarray(img), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                                    max_pts=64, min_dist=16)
    px = np.asarray(pxj)[np.asarray(pval)]
    dirs_c = np.concatenate([(px - [W / 2, H / 2]) / 250.0, np.ones((len(px), 1))], -1)
    dirs_c /= np.linalg.norm(dirs_c, axis=-1, keepdims=True)
    dirs_w = dirs_c @ R_wc.T
    t = scene.raycast(np.broadcast_to(p_wb, dirs_w.shape), dirs_w)
    hit = np.isfinite(t)
    pts3d = p_wb + t[hit, None] * dirs_w[hit]
    return (img.astype(np.float32), sim.R_to_q(R_wb), np.asarray(p_wb, np.float64) + pose_offset,
            pts3d.astype(np.float32), px[hit].astype(np.float32), np.ones(hit.sum(), bool))


def _dbs():
    kw = dict(qic=sim.R_to_q(R_BC), tic=np.zeros(3))
    return (jvl.VisualLoopDB(jvl.VisualLoopConfig(**CFG), **kw),
            tvl.VisualLoopDB(tvl.VisualLoopConfig(**CFG), device="cpu", **kw))


def _jax_sel(call, valid, n_hyp=64):
    """pnp_ransac's samples under the reference's key PRNGKey(call)."""
    u = jax.random.uniform(jax.random.PRNGKey(call), (n_hyp, len(valid)))
    return np.asarray(jnp.argsort(u - 10.0 * jnp.asarray(valid)[None, :].astype(jnp.float32),
                                  axis=1)[:, :6])


def _assert_db_equal(dt, dj, atol=0.0):
    assert dt.n == dj.n
    for k in ("win_desc", "win_valid", "extra_desc", "extra_valid"):
        np.testing.assert_array_equal(getattr(dt, k), getattr(dj, k), err_msg=k)
    for k in ("win_pts3d", "extra_xy", "q", "p", "vio_q", "vio_pts3d"):
        np.testing.assert_allclose(getattr(dt, k), getattr(dj, k), atol=atol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(dt.hists.numpy(), np.asarray(dj.hists))
    for f in jvl.pg4.PoseGraph4DoF._fields:
        np.testing.assert_allclose(getattr(dt.graph, f).numpy(), np.asarray(getattr(dj.graph, f)),
                                   atol=atol, rtol=0, err_msg=f)


@pytest.fixture(scope="module")
def filled():
    """Both databases after the three keyframes of POSES."""
    dj, dt = _dbs()
    for p, yaw in POSES:
        args = _keyframe(np.array(p), yaw)
        assert dj.add_keyframe(*args, CAM_J) == dt.add_keyframe(*args, CAM_T)
    return dj, dt


def test_add_keyframe_matches_reference(filled):
    dj, dt = filled
    _assert_db_equal(dt, dj)
    assert dt.n == 3 and dt.win_valid[:3].sum(axis=1).min() >= 25


def test_add_keyframe_densifies_from_lidar():
    """With this frame's camera-frame cloud, extra corners with a strong
    LiDAR depth fill the window slots past the landmarks, with the same
    descriptors and 3-D points as the reference's (min_incidence=0.1: the
    reference's module default, which the port takes from the rig)."""
    dj, dt = _dbs()
    dt.min_incidence = 0.1
    p_wb, yaw = np.array(POSES[0][0]), POSES[0][1]
    args = list(_keyframe(p_wb, yaw))
    args[3], args[4], args[5] = args[3][:20], args[4][:20], args[5][:20]
    pts, val = sim.simulate_lidar_scan(sim.RaycastScene(), np.eye(3), p_wb, n_scan=32,
                                       width=600, seed=0)
    cloud = (pts @ R_BC).astype(np.float32)  # body (lidar) frame -> camera frame
    dj.add_keyframe(*args, CAM_J, cloud_cam=jnp.asarray(cloud), cloud_valid=jnp.asarray(val))
    dt.add_keyframe(*args, CAM_T, cloud_cam=torch.from_numpy(cloud),
                    cloud_valid=torch.from_numpy(val))
    assert dj.win_valid[0].sum() > 30
    _assert_db_equal(dt, dj, atol=1e-5)


def test_find_connection_with_injected_samples(filled):
    """Verification of keyframe 1 against keyframe 0 (the same place) and
    against keyframe 2 (another place), each package on the same RANSAC
    samples: the same gate decisions, survivors and inliers, the same
    relative pose."""
    dj, dt = filled
    for i_cur, i_old in ((1, 0), (0, 1), (2, 0)):
        _, ok = jb.match(*(jnp.asarray(x) for x in (
            dj.win_desc[i_cur], dj.win_valid[i_cur], dj.extra_desc[i_old],
            dj.extra_valid[i_old])))
        calls = dj.__dict__.get("_ransac_calls", 0) + 1
        cj = dj.find_connection(i_cur, i_old)
        ct = dt.find_connection(i_cur, i_old, sel=_jax_sel(calls, np.asarray(ok)))
        assert dt.stats["hamming_matches"] == dj.stats["hamming_matches"]
        assert dt.stats["pnp_inliers"] == dj.stats["pnp_inliers"]
        assert (cj is None) == (ct is None)
        if cj is not None:
            np.testing.assert_allclose(ct[0], cj[0], atol=1e-4)
            np.testing.assert_allclose(ct[1], cj[1], atol=1e-4)
    assert dt.stats["accepted"] >= 1 and dt.stats["kill_hamming"] + dt.stats["kill_pnp"] >= 1


def test_close_loop_drift_and_sync_match_reference(filled):
    """close_loop -> drift_transform -> apply_drift_to_vio -> sync_from_graph
    on both databases with one loop edge of a given relative pose."""
    fj, ft = filled
    dj, dt = _dbs()
    for k in ("win_desc", "win_pts3d", "win_valid", "extra_desc", "extra_xy", "extra_valid",
              "q", "p", "vio_q", "vio_pts3d"):
        getattr(dj, k)[:] = getattr(fj, k)
        getattr(dt, k)[:] = getattr(fj, k)
    dj.n = dt.n = fj.n
    dj.graph, dj.hists = fj.graph, fj.hists
    dt.graph, dt.hists = ft.graph, ft.hists.clone()
    q_rel = np.array([np.cos(0.05), 0.0, 0.0, np.sin(0.05)], np.float32)
    p_rel = np.array([0.3, -0.2, 0.05], np.float32)
    gj0, gt0 = dj.graph, dt.graph
    dj.close_loop(2, 0, q_rel, p_rel)
    dt.close_loop(2, 0, q_rel, p_rel)
    yj, Rj, tj = (np.asarray(x) for x in jvl.pg4.drift_transform(gj0, dj.graph, 2))
    yt, Rt, tt = (x.numpy() for x in tvl.pg4.drift_transform(gt0, dt.graph, 2))
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-4)
    dj.apply_drift_to_vio(Rj, float(yj), tj)
    dt.apply_drift_to_vio(Rj, float(yj), tj)
    dj.sync_from_graph()
    dt.sync_from_graph()
    _assert_db_equal(dt, dj, atol=1e-4)
    assert int(dt.graph.n_loops) == 1 and np.abs(dt.p[2] - ft.p[2]).max() > 1e-3


def test_detect_two_tier_gates_match_reference():
    """tests/test_visual_loop.py:150's histograms in both databases: the
    earliest qualifying candidate, the runner-up gate, the best-score gate
    and the recency exclusion decide alike, with the same stats."""
    dj, dt = (jvl.VisualLoopDB(jvl.VisualLoopConfig(capacity=128)),
              tvl.VisualLoopDB(tvl.VisualLoopConfig(capacity=128), device="cpu"))
    dj.n = dt.n = 60
    i_q = 56

    def set_hist(i, s):
        h = np.zeros(tb.N_WORDS, np.float32)
        h[0] = s
        h[i + 1] = np.sqrt(max(1.0 - s ** 2, 0.0))
        dj.hists = dj.hists.at[i].set(jnp.asarray(h))
        dt.hists[i] = torch.from_numpy(h)

    set_hist(i_q, 1.0)
    want = []
    for sets, expect in ((((5, 0.30), (2, 0.10)), 2), (((2, 0.005),), None),
                         (((5, 0.04), (2, 0.03)), None),
                         (((5, 0.0), (2, 0.0), (10, 0.5), (55, 0.5)), None)):
        for i, s in sets:
            set_hist(i, s)
        got = (dt.detect(i_q), dj.detect(i_q))
        want.append(expect)
        assert got == (expect, expect)
    assert dt.detect_candidates(30) == dj.detect_candidates(30) == []
    st_t, st_j = dt.stats_summary(), dj.stats_summary()
    assert st_t == st_j


def test_save_load_across_packages(filled, tmp_path):
    """A database saved by either package loads into the other with every
    array equal, and both answer the same queries."""
    fj, ft = filled
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    fj.save(pj)
    ft.save(pt)
    dj, dt = _dbs()
    dt.load(pj)
    dj.load(pt)
    _assert_db_equal(dt, fj)
    _assert_db_equal(ft, dj)
    for i in range(3):
        assert dt.detect_candidates(i) == dj.detect_candidates(i)


def test_cross_session_loop_not_bound_by_drift():
    """The fixed reference bug: two keyframes of one view, the second
    stored 6 m from its landmarks, so the verification measures a 6 m
    displacement between them (as across a camera gap that ends a session).
    The reference's drift bound (a share of the path between the keyframes'
    indices, here 2.08 m) rejects the stitching loop; the port accepts it
    between two sessions (the flat 20 m gate remains) and still rejects it
    within one session."""
    p_wb, yaw = np.array(POSES[0][0]), POSES[0][1]
    offset = np.array([6.0, 0.0, 0.0])
    results = []
    for seq in (1, 0):
        _, dt = _dbs()
        dt.add_keyframe(*_keyframe(p_wb, yaw), CAM_T, sequence=0)
        dt.add_keyframe(*_keyframe(p_wb, yaw, offset), CAM_T, sequence=seq)
        results.append((dt.find_connection(1, 0), dt.stats))
    (hit, st), (miss, st_same) = results
    assert hit is not None and np.linalg.norm(hit[1] - offset) < 0.1, (hit, st)
    assert miss is None and st_same["kill_yaw_trans"] == 1


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.3), (2, 0.6)])
def test_pnp_ransac_matches_reference(seed, outliers):
    """pnp_ransac on synthetic correspondences (120 points in front of the
    camera, 1e-3 of observation noise, a share of gross outliers, 10% of the
    slots invalid), both seeds 0.3 m / 0.1 rad off the truth, the port on
    the JAX key's samples: the same inliers, the pose within 1e-4; the port
    writes its Jacobian out where the reference takes jax.jacfwd."""
    rng = np.random.default_rng(seed)
    N = 120
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-2, 2, N), rng.uniform(4, 12, N)], -1)
    R_t = np.asarray(jvl.lie.ypr2R(jnp.asarray([12.0, -4.0, 3.0])), np.float64)
    q_t, p_t = sim.R_to_q(R_t), np.array([0.4, -0.2, 0.1])
    pc = (pts - p_t) @ R_t
    obs = pc[:, :2] / pc[:, 2:] + rng.normal(0, 1e-3, (N, 2))
    bad = rng.random(N) < outliers
    obs[bad] += rng.uniform(-0.3, 0.3, (int(bad.sum()), 2))
    valid = rng.random(N) > 0.1
    q0 = jvl.lie.qmul(jnp.asarray(q_t, jnp.float32), jvl.lie.so3_exp(jnp.asarray([0.1, 0, 0.05])))
    p0 = jnp.asarray(p_t + [0.3, 0.0, -0.1], jnp.float32)
    args = [pts.astype(np.float32), obs.astype(np.float32), valid]
    qj, pj, inl_j = jvl.pnp_ransac(*(jnp.asarray(x) for x in args), q0, p0, q0_alt=q0,
                                   p0_alt=p0, n_hyp=64, inlier_tol=10 / 460,
                                   key=jax.random.PRNGKey(seed + 1))
    qt, pt, inl_t = tvl.pnp_ransac(*(torch.from_numpy(np.array(x)) for x in args),
                                   torch.from_numpy(np.array(q0)), torch.from_numpy(np.array(p0)),
                                   n_hyp=64, inlier_tol=10 / 460, sel=_jax_sel(seed + 1, valid))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(np.abs(qt.numpy() @ np.asarray(qj)), 1.0, atol=1e-6)
    assert inl_t.sum() >= 0.8 * (valid & ~bad).sum()


def _cloud(p_wb):
    """tests/test_visual_loop.py's densification scan at p_wb, in the camera
    frame (device-less numpy: points (M, 3), validity (M,))."""
    pts, val = sim.simulate_lidar_scan(sim.RaycastScene(), np.eye(3), p_wb, n_scan=32,
                                       width=600, seed=0)
    return (pts @ R_BC).astype(np.float32), val


@pytest.mark.parametrize("with_cloud", [False, True])
def test_keyframe_values_match_reference(with_cloud):
    """The keyframe program's pure part (`_keyframe_values`) against the
    reference's pieces on the same inputs: window and extra descriptors,
    the extra corners' validity, their rays (the reference lifts them on
    the host, the port on the device) and the BoW histogram bit for bit;
    with a cloud, feature_depth's mask equal and its depths within 1e-5;
    the inputs are left as they were (the program writes nothing)."""
    from vil_fusion_tpu.models import depth_association as jda

    cfg = tvl.VisualLoopConfig(**CFG)
    p_wb, yaw = np.array(POSES[0][0]), POSES[0][1]
    img, _, _, _, px, pval = _keyframe(p_wb, yaw)
    wn = min(len(px), cfg.win_cap)
    wxy = np.zeros((cfg.win_cap, 2), np.float32)
    wval = np.zeros(cfg.win_cap, bool)
    wxy[:wn], wval[:wn] = px[:wn], pval[:wn]
    cloud = _cloud(p_wb) if with_cloud else (None, None)
    args = [torch.from_numpy(img), torch.from_numpy(wxy), torch.from_numpy(wval)] + [
        None if c is None else torch.from_numpy(c) for c in cloud]
    kept = [None if a is None else a.clone() for a in args]
    kv = tvl._keyframe_values(*args, CAM_T, cfg, min_incidence=0.1)
    for a, b in zip(args, kept):
        assert (a is None and b is None) or torch.equal(a, b)

    jimg = jnp.asarray(img)
    wdesc = jb.brief_descriptors(jimg, jnp.asarray(wxy), jnp.asarray(wval))
    exy, evalid = jim.detect_features(jimg, jnp.zeros((1, 2), jnp.float32),
                                      jnp.zeros((1,), bool), max_pts=cfg.extra_cap, min_dist=10)
    edesc = jb.brief_descriptors(jimg, exy, evalid)
    ray = jvl.VisualLoopDB._lift(None, CAM_J, np.asarray(exy))
    hist = jb.word_histogram(jb.words_of(jnp.concatenate([wdesc, edesc])),
                             jnp.concatenate([jnp.asarray(wval), evalid]))
    for got, want in ((kv.win_desc, wdesc), (kv.extra_desc, edesc), (kv.extra_valid, evalid),
                      (kv.extra_xy, ray), (kv.hist, hist)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if with_cloud:
        dep, okd = jda.feature_depth(jnp.asarray(ray), evalid, jnp.asarray(cloud[0]),
                                     jnp.asarray(cloud[1]))
        np.testing.assert_array_equal(kv.depth_ok.numpy(), np.asarray(okd))
        np.testing.assert_allclose(kv.depth.numpy(), np.asarray(dep), atol=1e-5, rtol=0)
        assert int(okd.sum()) > 10
    else:
        assert kv.depth is None and kv.depth_ok is None
    # the one host read holds every leaf but the histogram
    parts = [kv.win_desc, kv.extra_desc, kv.extra_valid, kv.extra_xy, kv.depth, kv.depth_ok]
    assert kv.host.shape == (sum(x.numel() for x in parts if x is not None),)


def test_db_programs_through_the_graph_path_on_a_worker(monkeypatch):
    """The DB's programs through their graph path (graphs.use_graph mocked
    true, graphs.step a stand-in that records the call and runs the body
    inline), called on a worker thread that holds a step lock, as the
    pipeline's worker does: the keyframe program a keyframe, the Hamming
    match a verification, the PnP RANSAC a verification past the Hamming
    gate and the 4-DoF solve a loop closure, none taking a lock
    (lock=None), each keyed on its static arguments; the database ends bit
    for bit as the eager one."""
    from vil_fusion_tpu_torch.utils import graphs

    inputs = [_keyframe(np.array(p), yaw) for p, yaw in POSES]
    cloud = [torch.from_numpy(c) for c in _cloud(np.array(POSES[0][0]))]

    def run(db):
        out = []
        for k, args in enumerate(inputs):
            a = list(args)
            if k == 0:
                a[3], a[4], a[5] = a[3][:20], a[4][:20], a[5][:20]
            db.add_keyframe(*a, CAM_T, cloud_cam=cloud[0] if k == 0 else None,
                            cloud_valid=cloud[1] if k == 0 else None)
        out.append(db.find_connection(1, 0))
        out.append(db.find_connection(2, 0))
        db.close_loop(2, 0, np.array([np.cos(0.05), 0, 0, np.sin(0.05)], np.float32),
                      np.array([0.3, -0.2, 0.05], np.float32))
        return out

    _, eager = _dbs()
    want = run(eager)
    calls, step_lock, errors = [], __import__("threading").Lock(), []

    def step(name, fn, args, static=(), lock=None):
        hash(static)
        calls.append((name, static, lock, step_lock.locked()))
        with graphs.inline():
            return fn(*args)

    monkeypatch.setattr(graphs, "use_graph", lambda x: True)
    monkeypatch.setattr(graphs, "step", step)
    _, db = _dbs()
    got = []

    def worker():
        try:
            with step_lock:
                got.extend(run(db))
        except Exception as e:  # surfaced below
            errors.append(e)

    t = __import__("threading").Thread(target=worker)
    t.start()
    t.join(timeout=120.0)
    assert not t.is_alive() and not errors, errors
    names = [c[0] for c in calls]
    middle = " ".join(names[3:-1]).replace("vl_match pnp_ransac", "V").split()
    assert names[:3] == ["vl_keyframe"] * 3 and names[-1] == "posegraph4dof_optimize"
    assert set(middle) <= {"V", "vl_match"} and len(middle) == 2 and "V" in middle, names
    assert all(lock is None and held for _, _, lock, held in calls)
    cfg = db.cfg
    assert [c[1] for c in calls[:3]] == [(CAM_T, cfg, None, True)] + [(CAM_T, cfg, None, False)] * 2
    assert calls[3][1] == () and calls[4][1] == (cfg.pnp_ransac_hyp, cfg.pnp_inlier_px)
    assert calls[-1][1] == (10, 64, 0.02)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    _assert_db_equal(db, eager)
    assert int(db.graph.n_loops) == 1 and db.seq[:3].tolist() == [0, 0, 0]


def _pnp_case(seed, outliers):
    """test_pnp_ransac_matches_reference's synthetic correspondences: numpy
    (pts, obs, valid), the seeds (q0, p0) and the outliers' mask."""
    rng = np.random.default_rng(seed)
    N = 120
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-2, 2, N), rng.uniform(4, 12, N)], -1)
    R_t = np.asarray(jvl.lie.ypr2R(jnp.asarray([12.0, -4.0, 3.0])), np.float64)
    q_t, p_t = sim.R_to_q(R_t), np.array([0.4, -0.2, 0.1])
    pc = (pts - p_t) @ R_t
    obs = pc[:, :2] / pc[:, 2:] + rng.normal(0, 1e-3, (N, 2))
    bad = rng.random(N) < outliers
    obs[bad] += rng.uniform(-0.3, 0.3, (int(bad.sum()), 2))
    valid = rng.random(N) > 0.1
    q0 = jvl.lie.qmul(jnp.asarray(q_t, jnp.float32), jvl.lie.so3_exp(jnp.asarray([0.1, 0, 0.05])))
    p0 = jnp.asarray(p_t + [0.3, 0.0, -0.1], jnp.float32)
    return (pts.astype(np.float32), obs.astype(np.float32), valid), (q0, p0), bad


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.3), (2, 0.6)])
def test_pnp_ransac_on_drawn_uniforms_matches_reference(seed, outliers):
    """pnp_ransac given the RANSAC's uniforms `u` (drawn before its graph):
    with the JAX key's uniforms, bit for bit the port on the JAX key's
    samples (`sel=`), the reference's inliers and its pose within 1e-4."""
    (pts, obs, valid), (q0, p0), bad = _pnp_case(seed, outliers)
    key = jax.random.PRNGKey(seed + 1)
    u = np.asarray(jax.random.uniform(key, (64, len(valid))))
    qj, pj, inl_j = jvl.pnp_ransac(jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valid), q0, p0,
                                   q0_alt=q0, p0_alt=p0, n_hyp=64, inlier_tol=10 / 460, key=key)
    t = [torch.from_numpy(np.array(x)) for x in (pts, obs, valid, q0, p0)]
    got = tvl.pnp_ransac(*t, n_hyp=64, inlier_tol=10 / 460, u=torch.from_numpy(u))
    ref = tvl.pnp_ransac(*t, n_hyp=64, inlier_tol=10 / 460, sel=_jax_sel(seed + 1, valid))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(pj), atol=1e-4)
    assert got[2].sum() >= 0.8 * (valid & ~bad).sum()


def test_pnp_ransac_graph_path_draws_the_generator_samples(monkeypatch):
    """The uniforms drawn before the graph (`ransac_uniforms` from a
    generator seeded as find_connection seeds it) are the draws the
    generator path makes: the same result bit for bit, by the eager body
    and through the graph path (graphs.step mocked: one "pnp_ransac" call
    keyed on (n_hyp, inlier_tol))."""
    from vil_fusion_tpu_torch.utils import graphs

    (pts, obs, valid), (q0, p0), _ = _pnp_case(1, 0.3)
    t = [torch.from_numpy(np.array(x)) for x in (pts, obs, valid, q0, p0)]
    kw = dict(n_hyp=64, inlier_tol=10 / 460)
    want = tvl.pnp_ransac(*t, **kw, generator=torch.Generator().manual_seed(7))
    u = tvl.ransac_uniforms(64, len(valid), torch.Generator().manual_seed(7))
    calls = []

    def step(name, fn, args, static=(), lock=None):
        calls.append((name, static, lock))
        with graphs.inline():
            return fn(*args)

    monkeypatch.setattr(graphs, "use_graph", lambda x: True)
    monkeypatch.setattr(graphs, "step", step)
    got = tvl.pnp_ransac(*t, **kw, u=u)
    assert calls == [("pnp_ransac", (64, 10 / 460), None)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
