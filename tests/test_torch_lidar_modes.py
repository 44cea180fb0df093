"""The optional modes of the port's LiDAR odometry (sparse kNN, deskew, hash
kNN) against vil_fusion_tpu, and the modules they bring along.

Scans come from the numpy simulator at the small configuration of
test_lidar.py (32 x 900). On the CPU the JAX package answers
`knn(radius=...)` with its exact XLA search and does not presort; the port
runs its plain sparse search (presorted once per frame). Both are exact
inside the correspondence gate, so gated correspondences and poses are
compared. Tolerances are stated in each test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import deskew as jdk
from vil_fusion_tpu.models import lidar_features as jlf
from vil_fusion_tpu.models import lidar_odometry as jlo
from vil_fusion_tpu.ops import hash_knn as jhk
from vil_fusion_tpu.ops import lie as jlie
from vil_fusion_tpu.ops import voxel as jvox
from vil_fusion_tpu.runtime import sim as jsim
from vil_fusion_tpu_torch.models import deskew as tdk
from vil_fusion_tpu_torch.models import lidar_features as tlf
from vil_fusion_tpu_torch.models import lidar_odometry as tlo
from vil_fusion_tpu_torch.ops import hash_knn as thk
from vil_fusion_tpu_torch.ops import lie as tlie
from vil_fusion_tpu_torch.runtime import sim as tsim
from vil_fusion_tpu_torch.utils import state_io

torch.set_num_threads(2)

CFG_KW = dict(n_scan=32, width=900, min_range=1.0, max_range=80.0, fov_up_deg=30.0,
              fov_down_deg=-30.0, edge_cap=512, surf_cap=2048, edge_per_sector=6)
JCFG, TCFG = jlf.LidarConfig(**CFG_KW), tlf.LidarConfig(**CFG_KW)
ODOM_KW = dict(edge_map_cap=4096, surf_map_cap=8192, edge_map_voxel=0.3, surf_map_voxel=0.5)
OFF = np.array([0, 0, 1.5])
FRAME_DT = 0.15


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _distorted(sim_mod, traj, t):
    return sim_mod.simulate_lidar_scan_distorted(
        sim_mod.RaycastScene(), traj, t, FRAME_DT, OFF, n_scan=32, width=900,
        fov_up_deg=30.0, fov_down_deg=-30.0, max_range=80.0)


def test_distorted_scan_simulator_is_identical():
    """The port's copy of simulate_lidar_scan_distorted gives the same
    points and mask, bit for bit, as the JAX package's."""
    jt = jsim.Trajectory(jsim.TrajectoryConfig(speed=6.0))
    tt = tsim.Trajectory(tsim.TrajectoryConfig(speed=6.0))
    pj, vj = _distorted(jsim, jt, 1.0)
    pt, vt = _distorted(tsim, tt, 1.0)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() > 10000


def test_se3_log_exp_match():
    """se3_log / se3_exp (what deskew interpolates with) against JAX: atol
    1e-6, on a batch of twists including the zero twist."""
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.4, (64, 6)).astype(np.float32)
    xi[0] = 0.0
    qj, pj = jlie.se3_exp(jnp.asarray(xi))
    qt, pt = tlie.se3_exp(_t(xi))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(tlie.se3_log(qt, pt).numpy(), np.asarray(jlie.se3_log(qj, pj)),
                               atol=2e-6)
    np.testing.assert_allclose(tlie.se3_log(qt, pt).numpy(), xi, atol=1e-5)


def test_deskew_points_matches_and_corrects():
    """deskew_points on a distorted scan with the true scan motion
    (test_lidar.py:117): within 1e-5 m of JAX on every point (f32
    trigonometry on 80 m ranges), invalid points untouched, and the
    corrected points land back on the scene's surfaces (median distance
    under 0.3 of the raw scan's)."""
    traj = jsim.Trajectory(jsim.TrajectoryConfig(speed=6.0))
    t_end = 1.0
    pts, val = _distorted(jsim, traj, t_end)
    R_e, p_e = traj.rotation(t_end), traj.position(t_end) + OFF
    R_s, p_s = traj.rotation(t_end - FRAME_DT), traj.position(t_end - FRAME_DT) + OFF
    start = (np.float32(jsim.R_to_q(R_s)), np.float32(p_s))
    end = (np.float32(jsim.R_to_q(R_e)), np.float32(p_e))
    q_rel, p_rel = jlie.pose_between(tuple(map(jnp.asarray, start)), tuple(map(jnp.asarray, end)))
    out_j = np.asarray(jdk.deskew_points(jnp.asarray(pts), jnp.asarray(val), q_rel, p_rel))
    tq, tp = tlie.pose_between(tuple(map(_t, start)), tuple(map(_t, end)))
    out_t = tdk.deskew_points(_t(pts), _t(val), tq, tp).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_array_equal(out_t[~val], pts[~val])

    def surf_dist(body_pts):
        W = body_pts @ R_e.T + p_e
        return np.minimum(np.abs(W[:, 2]), np.abs(np.abs(W[:, 1]) - 12.0))

    assert np.median(surf_dist(out_t[val])) < 0.3 * np.median(surf_dist(pts[val]))


@pytest.mark.parametrize("radius,res,k", [(2, 0.8, 5), (3, 0.4, 5), (1, 0.8, 3)])
def test_hash_knn_matches(radius, res, k):
    """hash_knn on a voxel-hash table built by the JAX package: the same
    found mask, distances within 1e-5 (the same subtraction and sum), and
    the same slots wherever the k+1 nearest candidates are 1e-6 apart."""
    rng = np.random.default_rng(7)
    cloud = rng.uniform(-12, 12, (6000, 3)).astype(np.float32)
    cloud[:, 2] *= 0.2
    origin = np.full(3, -100.0, np.float32)
    table, tv = jvox.voxel_downsample_hash(jnp.asarray(cloud), jnp.ones(6000, bool), res,
                                           jnp.asarray(origin), 4096)
    q = rng.uniform(-12, 12, (700, 3)).astype(np.float32)
    q[:, 2] *= 0.2
    d_j, i_j = jhk.hash_knn(jnp.asarray(q), table, tv, res, jnp.asarray(origin), k=k,
                            radius=radius)
    d_t, i_t = thk.hash_knn(_t(q), _t(table), _t(tv), res, _t(origin), k=k, radius=radius)
    d_j, i_j, d_t, i_t = np.asarray(d_j), np.asarray(i_j), d_t.numpy(), i_t.numpy()
    assert d_t.dtype == np.float32 and i_t.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_j))
    fin = np.isfinite(d_j)
    assert fin.all(1).sum() > 300
    np.testing.assert_allclose(d_t[fin], d_j[fin], atol=1e-5)
    d6 = thk.hash_knn(_t(q), _t(table), _t(tv), res, _t(origin), k=k + 1, radius=radius)[0].numpy()
    clear = fin.all(1) & np.all(np.diff(d6, axis=1) > 1e-6, axis=1)
    assert clear.sum() > 200
    np.testing.assert_array_equal(i_t[clear], i_j[clear])
    assert (i_t[~fin] == 0).all()


def _jax_run(cfg, scans, n):
    state = jlo.init_state(cfg)
    states, poses = [state], []
    for pts, val in scans[:n]:
        state, (q, p, _, _) = jlo.odometry_step(state, jnp.asarray(pts), jnp.asarray(val), cfg)
        states.append(state)
        poses.append((np.asarray(q), np.asarray(p)))
    return states, poses


@pytest.fixture(scope="module")
def scans():
    """5 distorted scans at 6 m/s, 0.15 s frames (test_lidar.py:147)."""
    traj = jsim.Trajectory(jsim.TrajectoryConfig(speed=6.0))
    return [_distorted(jsim, traj, i * FRAME_DT) for i in range(5)]


@pytest.mark.parametrize("mode", ["sparse_knn", "deskew", "use_hash_knn"])
def test_mode_step_from_carried_state(scans, mode):
    """Carry the JAX maps and poses after 4 frames of a run in `mode` into
    the port and step both once in that mode. Both sides are exact inside
    the correspondence gate, but they round distances differently, so a few
    borderline correspondences (a gate at its threshold, a 5th neighbour
    tied with the 6th) differ: position within 1e-4 m, quaternion within
    5e-5 (measured 3e-5 m and 1.2e-5; the dense step's test allows 1e-3).
    Map validity equal on at least 99.9% of the slots and at least 99.9% of
    the map coordinates within 1e-3 m (a 3e-5 m pose offset moves a point
    across a voxel border; a voxel whose two candidates tie keeps the other
    one). The
    sparse search runs here at its card tiles (128 x 128) through the
    presorted path."""
    kw = dict(ODOM_KW, approx_knn=False, **{mode: True})
    jcfg, tcfg = jlo.OdomConfig(lidar=JCFG, **kw), tlo.OdomConfig(lidar=TCFG, **kw)
    states, poses = _jax_run(jcfg, scans, 5)
    ts = state_io.to_torch(tlo.MapState, state_io.to_numpy(states[4]), "cpu")
    pts, val = scans[4]
    ts2, (q, p, _, _) = tlo.odometry_step(ts, _t(pts), _t(val), tcfg, frame_count=4)
    q_j, p_j = poses[4]
    np.testing.assert_allclose(p.numpy(), p_j, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), q_j, atol=5e-5)
    a, b = state_io.to_numpy(states[5]), state_io.to_numpy(ts2)
    for m in ("edge_map", "surf_map"):
        assert (b[m + "_valid"] == a[m + "_valid"]).mean() >= 0.999
        assert (np.abs(b[m] - a[m]) <= 1e-3).mean() >= 0.999
    assert int(b["frame_count"]) == 5


def test_sparse_correspondences_equal_exact(scans):
    """The gated correspondences of one association pass are the same set
    with the sparse search (presorted, as scan_to_map runs it) as with the
    exact search: same ok mask after undoing the sort; on the rows with the
    same five neighbours (at least 99% of the gated rows) normals within
    1e-6 and offsets within 1e-5."""
    cfg = jlo.OdomConfig(lidar=JCFG, approx_knn=False, **ODOM_KW)
    states, _ = _jax_run(cfg, scans, 3)
    st = state_io.to_torch(tlo.MapState, state_io.to_numpy(states[3]), "cpu")
    pts, val = scans[3]
    feats = tlf.extract_features(_t(pts), _t(val), TCFG)
    tcfg_x = tlo.OdomConfig(lidar=TCFG, approx_knn=False, **ODOM_KW)
    tcfg_s = tcfg_x._replace(sparse_knn=True)
    s_w = tlie.qrot(st.q, feats.surf) + st.p
    d_x, i_x = tlo._map_knn(s_w, st.surf_map, st.surf_map_valid, tcfg_x, 0.5, 2, None)
    n_x, off_x, ok_x = tlo.surf_correspondences(s_w, feats.surf_valid, st.surf_map, d_x, i_x, tcfg_x)
    from vil_fusion_tpu_torch.ops.knn import morton_sort
    sp, mp = morton_sort(s_w, feats.surf_valid), morton_sort(st.surf_map, st.surf_map_valid)
    d_s, i_s = tlo._map_knn(s_w[sp], st.surf_map[mp], st.surf_map_valid[mp], tcfg_s, 0.5, 2, None,
                            presorted=True)
    n_s, off_s, ok_s = tlo.surf_correspondences(s_w[sp], feats.surf_valid[sp], st.surf_map[mp],
                                                d_s, i_s, tcfg_s)
    inv = torch.argsort(sp)
    assert ok_x.sum() > 300 and torch.equal(ok_s[inv], ok_x)
    # the two searches round their distances differently (difference form
    # against expanded form), so a 5th and 6th neighbour that tie within
    # rounding may swap: compare the fits on rows with the same neighbour set
    same = (torch.sort(mp[i_s.long()][inv], dim=1).values
            == torch.sort(i_x.long(), dim=1).values).all(1)
    ok = ok_x & same
    assert ok.sum() >= 0.99 * ok_x.sum()
    sign = torch.sign((n_s[inv][ok] * n_x[ok]).sum(-1, keepdim=True))
    np.testing.assert_allclose((n_s[inv][ok] * sign).numpy(), n_x[ok].numpy(), atol=1e-6)
    np.testing.assert_allclose((off_s[inv][ok] * sign[:, 0]).numpy(), off_x[ok].numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["sparse_knn", "deskew", "use_hash_knn"])
def test_mode_sequence_drift(scans, mode):
    """The port's own 5-frame run in each mode from an empty map (host
    frame-count mirror, first-frame branch, deskew's drop of frame 0 at
    frame 1): every position within 0.35 m of the simulator's ground truth
    (test_lidar.py:179's bound) and within 0.05 m of the JAX run in the same
    mode (exact map search on both sides)."""
    kw = dict(ODOM_KW, approx_knn=False, **{mode: True})
    jcfg, tcfg = jlo.OdomConfig(lidar=JCFG, **kw), tlo.OdomConfig(lidar=TCFG, **kw)
    _, poses = _jax_run(jcfg, scans, 5)
    traj = jsim.Trajectory(jsim.TrajectoryConfig(speed=6.0))
    state = tlo.init_state(tcfg, device="cpu")
    R0, p0 = traj.rotation(0.0), traj.position(0.0) + OFF
    for i, (pts, val) in enumerate(scans):
        state, (q, p, _, _) = tlo.odometry_step(state, _t(pts), _t(val), tcfg, frame_count=i)
        p_gt = R0.T @ (traj.position(i * FRAME_DT) + OFF - p0)
        assert np.linalg.norm(p.numpy() - p_gt) < 0.35, (i, p, p_gt)
        assert np.linalg.norm(p.numpy() - poses[i][1]) < 0.05, (i, p, poses[i][1])
    assert int(state.frame_count) == 5
