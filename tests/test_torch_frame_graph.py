"""The reference's compiled frame programs in the port: the pure bodies that
the card captures as CUDA graphs (utils/graphs.step), on the CPU.

  * `vil_frame` (its body `vil_frame_body`, the graph of a steady deferred
    frame) against the JAX package's `_vil_frame_program` for 3 steady
    frames from the same state, the tracker's RANSAC fed the JAX key's
    uniforms;
  * the RANSAC's uniform draw, split out of the step (a graph cannot hold
    the generator), against the draw inside it: bit for bit;
  * the host branch keys of the odometry (frames 0-4, deskew on and off)
    and the tracker (its first frame) against the reference's predicates;
  * `graphs.step` inline inside another capture, and the kNN wrappers'
    scratch buffers refusing to grow while capturing (the capture state
    mocked).

The state after 10 frames (oracle start, 160 x 120 images, quantized
16-ring scans, 64 feature slots: test_torch_vil_pipeline.py's rig with the
RANSAC on) comes from the port's pipeline and is carried into the JAX
package's NamedTuples; each steady frame starts both packages from the
reference's state after the frame before. On the CPU the JAX package
answers approx=True with its exact kNN, so both run approx_knn=False.
Tolerances, as test_torch_frontend.py, test_torch_cuda.py's front end and
test_torch_vil_pipeline.py hold the same quantities: the dequantized cloud
and the feature ids equal; depth flags (invalid / weak / strong) equal on
95% of the features (a 0.05 px shift of a track can move a depth across
the incidence or spread gate) and depths within 2e-3 m on 95% of those
with one in both; lidar pose within 5e-3 m and 1e-3 in the quaternion; the
estimator's newest position and every window position within 0.05 m; the
keyframe decision and the failure mask equal; the marginal prior's J^T J
within 1e-2 of its largest entry (test_torch_estimator.py) and J^T r0, the
marginalized factors' leftover gradient at the f32 solution and the least
stable part of the prior, within 1.5e-1 (on this rig the two packages'
estimator steps leave it up to 6.1e-2 apart even on identical inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import factors as jfac
from vil_fusion_tpu.models import lidar_odometry as jlo
from vil_fusion_tpu.models import tracker as jtrk
from vil_fusion_tpu.models import window as jwin
from vil_fusion_tpu.runtime import pipeline as jpipe
from vil_fusion_tpu.runtime.config import RigConfig as JRig
from vil_fusion_tpu_torch.models import klt
from vil_fusion_tpu_torch.models import lidar_odometry as tlo
from vil_fusion_tpu_torch.models import tracker as ttrk
from vil_fusion_tpu_torch.ops.cuda import knn_cuda
from vil_fusion_tpu_torch.runtime import pipeline as tpipe
from vil_fusion_tpu_torch.runtime import sim as tsim
from vil_fusion_tpu_torch.runtime.config import RigConfig as TRig
from vil_fusion_tpu_torch.utils import graphs, state_io

torch.set_num_threads(2)

H, W, F = 120, 160, 100.0
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
RIG_KW = dict(
    name="small",
    camera=dict(model_type="PINHOLE", projection_parameters=dict(fx=F, fy=F, cx=W / 2, cy=H / 2),
                distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
    image_height=H, image_width=W, q_ic=tsim.R_to_q(R_BC), t_ic=np.array([0.1, 0.0, 0.05]),
    q_cl=tsim.R_to_q(R_BC.T), t_cl=np.array([0.0, -0.1, 0.02]), max_cnt=40, min_dist=12,
    n_scan=16, lidar_fov_up=15.0, lidar_fov_down=-15.0, lidar_min_range=1.0,
    lidar_max_range=80.0, use_lidar=True, rolling_shutter=True, tr=0.02, f_threshold=3.0)
ODOM = dict(edge_map_cap=2048, surf_map_cap=4096, edge_cap=256, surf_cap=1024, approx_knn=False)
QUANT = 0.0025
FILL = 10  # frames before the first steady one (the window's filling)
STEADY = 3
OFF = np.array([0.0, 0.0, 1.5])


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    yield
    jax.clear_caches()


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(n):
    """n frames at 10 Hz along sim.Trajectory at 4 m/s: uint8 image,
    int16 scan with packed validity, the IMU samples since the frame
    before."""
    scene = tsim.RaycastScene()
    traj = tsim.Trajectory(tsim.TrajectoryConfig(speed=4.0))
    out = []
    for i in range(n):
        t = 1.0 + 0.1 * i
        R, p = traj.rotation(t), traj.position(t) + OFF
        img = tsim.render_camera_image(scene, R @ R_BC, p, F, F, W / 2, H / 2, H, W)
        pts, val = tsim.simulate_lidar_scan(scene, R, p, n_scan=16, width=900, fov_up_deg=15.0,
                                            fov_down_deg=-15.0, max_range=80.0, seed=i)
        imu = tsim.simulate_imu(traj, t - 0.1, t, 200.0) if i else None
        out.append((t, (np.clip(img, 0, 1) * 255).astype(np.uint8), pts, val, imu))
    return traj, out


def _to_jax(cls, arrays):
    """{field: numpy array} (state_io.to_numpy) -> the JAX package's cls;
    the prior's `lin` is a window."""
    return cls(**{k: (_to_jax(jwin.WindowState, v) if isinstance(v, dict) else jnp.asarray(v))
                  for k, v in arrays.items()})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _prior_close(pt, pj):
    """The marginal prior by J^T J and J^T r0 (eigenvectors' signs are
    arbitrary), each against the largest entry of the reference's."""
    Ja, Jb = _np(pt.J).astype(np.float64), _np(pj.J).astype(np.float64)
    for (x, y), tol in (((Ja.T @ Ja, Jb.T @ Jb), 1e-2),
                        ((Ja.T @ _np(pt.r0), Jb.T @ _np(pj.r0)), 1.5e-1)):
        err = np.abs(x - y).max() / np.abs(y).max()
        print(f"prior: {err:.3e} of the largest entry (tolerance {tol})")
        assert err <= tol


def test_frame_body_matches_vil_frame_program():
    """Three steady frames, each from the same state in both packages (the
    reference's state after the frame before, carried into the port): the
    port's vil_frame (on the CPU its pure body, the graph's content)
    against the reference's _vil_frame_program, to the tolerances of the
    module docstring."""
    traj, frames = _frames(FILL + STEADY)
    pipe = tpipe.VILFusionPipeline(TRig(**RIG_KW), mode="vil", f_cap=64, odom_overrides=ODOM,
                                   scan_quant=QUANT, device="cpu")
    q0, p0 = traj.pose(1.0)
    pipe.estimator.set_initial_state(p=p0 + OFF, q=q0, v=traj.velocity(1.0))
    for t, img, pts, val, imu in frames[:FILL]:
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        pipe.push_scan(t, pts.copy(), val.copy())
        pipe.push_image(t, img)
    est = pipe.estimator
    assert est.initialized and est.frame_count == FILL and pipe.lidar_frames == FILL
    assert pipe.tracker_cfg.ransac

    jp = jpipe.VILFusionPipeline(JRig(**RIG_KW), mode="vil", f_cap=64, odom_overrides=ODOM,
                                 scan_quant=QUANT)
    assert jp.tracker_cfg._asdict() == pipe.tracker_cfg._asdict()
    j_cls = (jtrk.TrackerState, jlo.MapState, jwin.WindowState, jwin.FeatureStore,
             jwin.StackedPreint, jwin.LidarConstraints, jfac.MargPrior)
    state = [state_io.to_numpy(x) for x in (pipe.tracker_state, pipe.lidar_state, est.window,
                                             est.feats, est.pre, est.lidar, est.prior)]
    t_cls = (ttrk.TrackerState, tlo.MapState) + tuple(type(x) for x in (
        est.window, est.feats, est.pre, est.lidar, est.prior))
    n_depth = 0
    for k, (t, img, pts, val, imu) in enumerate(frames[FILL:]):
        pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        acc_b, gyr_b, dt_b, n_imu = est._pack_imu(*pipe._imu_segment_for_frame(t))
        pts16 = np.clip(np.round(pts / QUANT), -32767, 32767).astype(np.int16)
        val8 = np.packbits(val)
        # the reference's header row and its RANSAC key, derived in-program
        # from the float32 timestamp
        blk = np.zeros((est.cfg.imu_cap + 1, 7), np.float32)
        blk[:-1, 0:3], blk[:-1, 3:6], blk[:len(dt_b), 6] = acc_b, gyr_b, dt_b
        blk[-1, :5] = (t, n_imu, pipe.fe.tsh_scale, QUANT, pipe.rig.depth_min_incidence)
        key = jax.random.PRNGKey(jnp.floor(jnp.float32(t) * 1e3).astype(jnp.int32) & 0x7FFFFFFF)
        u = _t(jax.random.uniform(key, (klt.N_HYP, pipe.tracker_cfg.cap)))
        js = [_to_jax(c, a) for c, a in zip(j_cls, state)]
        ts = [state_io.to_torch(c, a, "cpu") for c, a in zip(t_cls, state)]
        jout = jpipe._vil_frame_program(
            *js, jnp.asarray(img), jnp.asarray(pts16), jnp.asarray(val8), jnp.asarray(blk),
            jp.q_il, jp.t_il, jp.q_li, jp.t_li, jp.q_cl, jp.t_cl,
            jp.cam, jp.tracker_cfg, jp.lidar_cfg, jp.est_cfg)
        tout = tpipe.vil_frame(*ts, _t(img), _t(pts16), _t(val8), _t(acc_b), _t(gyr_b),
                               _t(dt_b), n_imu, t, pipe.fe, pipe.est_cfg,
                               frame_index=FILL + k, u=u)
        jo, lq, lp, ids, depth, jpts, jval = jout[7:]
        tw, out, front = tout[2:7], tout[7], tout[8]
        # the front end
        np.testing.assert_array_equal(front["pts"].numpy(), np.asarray(jpts))
        np.testing.assert_array_equal(front["val"].numpy(), np.asarray(jval))
        np.testing.assert_array_equal(front["ids"].numpy(), np.asarray(ids))
        v = front["valid"].numpy()
        d_t, d_j = front["depth"].numpy(), np.asarray(depth)
        assert (np.sign(d_t[v]) == np.sign(d_j[v])).mean() >= 0.95
        has = v & (d_j != -1.0) & (d_t != -1.0)
        assert (np.abs(d_t[has] - d_j[has]) < 2e-3).mean() >= 0.95
        n_depth += int(has.sum())
        np.testing.assert_allclose(front["lidar_p"].numpy(), np.asarray(lp), atol=5e-3)
        np.testing.assert_allclose(front["lidar_q"].numpy(), np.asarray(lq), atol=1e-3)
        # the whole frame
        np.testing.assert_allclose(out["p"].numpy(), np.asarray(jo["p"]), atol=0.05)
        np.testing.assert_allclose(tw[0].p.numpy(), np.asarray(jout[2].p), atol=0.05)
        assert bool(out["is_key"]) == bool(jo["is_key"])
        assert int(out["failed"]) == int(jo["failed"]) == 0
        _prior_close(tw[4], jout[6])
        # the next frame starts from the reference's state in both
        state = [state_io.to_numpy(x) for x in jout[:7]]
    assert n_depth >= 15 and v.sum() >= 25 and bool(tw[4].valid)


def test_ransac_uniforms_keep_the_generator_stream():
    """The uniforms drawn outside the step (klt.ransac_uniforms, the
    pipeline's ransac_uniforms reseeded from frame_seed) are the draws
    that ransac_sample(generator=) made inside it, bit for bit, in the same
    order over consecutive frames; the sample indices and a whole
    track_step from them are the same; `sel=` still wins."""
    rng = np.random.default_rng(0)
    valid = _t(rng.random(64) < 0.6)
    g_old, g_new = torch.Generator(), torch.Generator()
    g_old.manual_seed(7), g_new.manual_seed(7)
    for _ in range(3):  # consecutive draws of one stream
        n = valid.shape[0]
        u_old = torch.rand((klt.N_HYP, n), generator=g_old)  # the draw inside the old step
        u = klt.ransac_uniforms(n, klt.N_HYP, g_new)
        assert torch.equal(u, u_old)
        assert torch.equal(klt.ransac_sample(valid, klt.N_HYP, u=u),
                           torch.argsort(u_old - 10.0 * valid[None, :].float(), dim=1)[:, :8])
    tcfg = ttrk.TrackerConfig(cap=64, max_cnt=40, min_dist=12, f_thresh_px=3.0)
    gen = torch.Generator()
    u = tpipe.ransac_uniforms(1.2345678, tcfg, "cpu", gen)
    assert torch.equal(u, torch.rand((klt.N_HYP, 64),
                                     generator=torch.Generator().manual_seed(1234)))
    assert tpipe.ransac_uniforms(1.0, tcfg, "cpu", gen, sel=torch.zeros(1)) is None
    assert tpipe.ransac_uniforms(1.0, tcfg._replace(ransac=False), "cpu", gen) is None
    # a track_step with the generator against one with its uniforms
    _, frames = _frames(2)
    cam = tpipe.front_end_config(TRig(**RIG_KW), f_cap=64, device="cpu").cam
    outs = []
    for how in ("generator", "u"):
        st = ttrk.init_tracker(H, W, tcfg, device="cpu")
        for i, (t, img, *_rest) in enumerate(frames):
            g = torch.Generator().manual_seed(tpipe.frame_seed(t))
            kw = (dict(generator=g) if how == "generator"
                  else dict(u=klt.ransac_uniforms(64, klt.N_HYP, g)))
            st, obs = ttrk.track_step(st, _t(img), t, cam, tcfg, initialized=i > 0, **kw)
        outs.append((st, obs))
    la, lb = [], []
    graphs._flatten(outs[0], la), graphs._flatten(outs[1], lb)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
    assert int((outs[0][1]["ids"] >= 0).sum()) >= 20


@pytest.mark.parametrize("deskew", [False, True])
def test_host_branch_keys_match_the_reference(deskew):
    """lidar_odometry.branches(frame_count) at frames 0-4 against the
    reference's predicates on its int32 device counter (the first-frame
    cond lidar_odometry.py:383, `warm` :378, deskew's drop of frame 0 at
    :397); only frames >= 3 reach the steady key the graph is captured
    for. The tracker's first frame (state.initialized False) takes the
    eager branch, and a device read of the counters gives the host
    mirrors' results (odometry frames 0-4 and the tracker's first two on a
    small scan)."""
    cfg = tlo.OdomConfig()._replace(deskew=deskew)
    for fc in range(5):
        c = jnp.int32(fc)
        ref = (bool(c > 0), bool(c >= 3), bool(deskew and bool(c == 1)))
        assert tuple(tlo.branches(fc, cfg)) == ref
        assert (tlo.branches(fc, cfg) == tlo.STEADY) == (fc >= 3)
    fe = tpipe.front_end_config(TRig(**RIG_KW), f_cap=64, odom_overrides=dict(ODOM, deskew=deskew),
                                device="cpu")
    _, frames = _frames(5)
    runs = []
    for host in (True, False):
        ls = tlo.init_state(fe.lcfg, device="cpu")
        st = ttrk.init_tracker(H, W, fe.tcfg, device="cpu")
        poses = []
        for i, (t, img, pts, val, _imu) in enumerate(frames):
            ls, (q, p, _, _) = tlo.odometry_step(ls, _t(pts), _t(val), fe.lcfg,
                                                 frame_count=i if host else None)
            poses.append(torch.cat([q, p]))
            if i < 2:
                u = tpipe.ransac_uniforms(t, fe.tcfg, "cpu")
                st, obs = ttrk.track_step(st, _t(img), t, fe.cam, fe.tcfg, u=u,
                                          initialized=(i > 0) if host else None)
                poses.append(obs["uv"].flatten())
        runs.append(poses)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_step_runs_inline_inside_another_capture(monkeypatch):
    """graphs.step called while this thread captures another step (the
    capture state mocked: torch's capture query and the recording list)
    runs its body inline, with CPU tensors that a capture of its own would
    refuse, and caches nothing; a kernel launch counted there is recorded
    for the outer graph's replays. `graphs.inline()` runs every step
    inline too. Without the capture state the step refuses CPU tensors."""
    x = torch.arange(3.0)
    n_steps = len(graphs._steps)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(graphs._tls, "capturing", [], raising=False)
    assert graphs.capturing()
    out = graphs.step("inner", lambda a, b: (a + 1, b), (x, None), static=(1,))
    assert torch.equal(out[0], x + 1) and out[1] is None
    seen = []
    graphs.record_launch(seen.append, "k1")
    assert seen == [] and graphs._tls.capturing == [(seen.append, ("k1",))]
    monkeypatch.setattr(graphs._tls, "capturing", None)
    assert not graphs.capturing()
    with graphs.inline():
        assert torch.equal(graphs.step("inner", lambda a: a * 2, (x,)), x * 2)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.step("inner", lambda a: a * 2, (x,))
    assert len(graphs._steps) == n_steps
    # None leaves keep their place in a step's structure
    leaves = []
    spec = graphs._flatten((x, None, {"a": None}), leaves)
    assert len(leaves) == 1 and graphs._unflatten(spec, iter(leaves))[1:] == (None, {"a": None})


def test_knn_buffers_refuse_to_grow_while_capturing(monkeypatch):
    """knn_cuda._scratch / _counters grow outside a capture (the old buffer
    stays alive for the graphs that point at it) and raise inside one,
    where the new buffer would come from the graph's private pool; a
    buffer large enough is handed out while capturing too."""
    dev = torch.device("cpu")
    monkeypatch.setattr(knn_cuda, "_scratch_bufs", {})
    monkeypatch.setattr(knn_cuda, "_counter_bufs", {})
    monkeypatch.setattr(knn_cuda, "_retired", [])
    a = knn_cuda._scratch(dev, 100)
    c = knn_cuda._counters(dev, 10)
    assert a.numel() >= 100 and c.numel() >= 10 and not c.any()
    b = knn_cuda._scratch(dev, 1 << 20)
    assert b.numel() >= 1 << 20 and knn_cuda._retired == [a]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(graphs._tls, "capturing", [], raising=False)
    assert knn_cuda._scratch(dev, 1000) is b and knn_cuda._counters(dev, 10) is c
    with pytest.raises(RuntimeError, match="capture"):
        knn_cuda._scratch(dev, 1 << 21)
    with pytest.raises(RuntimeError, match="capture"):
        knn_cuda._counters(dev, 1 << 20)
    assert knn_cuda._scratch_bufs[dev] is b and knn_cuda._counter_bufs[dev] is c
    monkeypatch.setattr(graphs._tls, "capturing", None)


@pytest.mark.parametrize("sync_depth", [0, 2])
def test_pipeline_replays_the_reference_programs(monkeypatch, sync_depth):
    """Which graphs each pipeline frame replays, on the CPU with
    graphs.use_graph mocked true and graphs.step a stand-in that counts a
    replay and runs the body inline (as a capture takes in a nested step):
    the filling frames replay the stage graphs (the tracker's from frame 1,
    the odometry's from frame 3, the glue with the depth association on
    every frame); a steady frame replays those and the estimator's step at
    sync_depth 0, and exactly one graph, the frame's, at sync_depth 2.
    Global fusion's graphs come on top: one keyframe program a keyframe
    (when the frame completes), no ICP and no relaxation without a loop."""
    replays = []

    def step(name, fn, args, static=(), lock=None):
        if getattr(graphs._tls, "inline", 0):
            return fn(*args)
        hash(static)  # the key must be hashable
        replays.append(name)
        with graphs.inline():
            return fn(*args)

    monkeypatch.setattr(graphs, "use_graph", lambda x: True)
    monkeypatch.setattr(graphs, "step", step)
    traj, frames = _frames(FILL + STEADY)
    pipe = tpipe.VILFusionPipeline(TRig(**RIG_KW), mode="vil", f_cap=64, odom_overrides=ODOM,
                                   scan_quant=QUANT, sync_depth=sync_depth, device="cpu")
    q0, p0 = traj.pose(1.0)
    pipe.estimator.set_initial_state(p=p0 + OFF, q=q0, v=traj.velocity(1.0))
    stages = ["track_step", "odometry_step", "glue_depth"]
    for i, (t, img, pts, val, imu) in enumerate(frames):
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        n = len(replays)
        pipe.push_scan(t, pts.copy(), val.copy())
        pipe.push_image(t, img)
        got = [r for r in replays[n:]
               if r not in ("keyframe_program", "submap_icp", "posegraph_optimize")]
        if i < FILL:
            want = [s for s, first in zip(stages, (1, 3, 0)) if i >= first]
        else:
            want = ["vil_frame"] if sync_depth else stages + ["fused_full_step"]
        assert got == want, (i, got)
    pipe.finalize()
    assert pipe.estimator.fused_steps == STEADY and pipe.restarts == 0
    assert len(pipe.outputs.ts) == FILL + STEADY
    assert replays.count("keyframe_program") == pipe.fusion.n_kf > 1
    assert "submap_icp" not in replays and "posegraph_optimize" not in replays


def test_step_captures_a_key_at_its_second_call(monkeypatch):
    """graphs.step runs a key's first call eagerly and captures at the
    second (scans of a size that never comes back are never captured), then
    replays; keys beyond MAX_GRAPHS graphs of a name keep running eagerly.
    The capture is mocked (CapturedStep and the device check): what is held
    is the policy and the counts."""
    made = []

    class Fake:
        def __init__(self, name, fn, args, lock=None):
            made.append(name)
            self.fn, self.stats = fn, dict(name=name)

        def __call__(self, *args):
            graphs.replays[made[-1]] = graphs.replays.get(made[-1], 0) + 1
            return self.fn(*args)

    for attr, value in (("CapturedStep", Fake), ("_check_device", lambda name, leaves: None),
                        ("_steps", {}), ("_seen", set()), ("_graphs_by_name", {}),
                        ("captures", []), ("MAX_GRAPHS", 2)):
        monkeypatch.setattr(graphs, attr, value)
    graphs.reset_counts()
    x = torch.ones(3)
    for n in range(3):  # one key: eager, capture + replay, replay
        assert torch.equal(graphs.step("s", lambda a: a + 1, (x,), static=(1,)), x + 1)
    assert made == ["s"] and graphs.replays == {"s": 2} and graphs.eager_calls == {"s": 1}
    for size in range(4, 12):  # a new shape every call: never captured
        graphs.step("s", lambda a: a * 2, (torch.ones(size),), static=(1,))
    assert made == ["s"] and graphs.eager_calls == {"s": 9}
    for _ in range(2):  # a second repeated key: the name's second graph
        graphs.step("s", lambda a: a, (x,), static=(2,))
    for _ in range(3):  # a third: over MAX_GRAPHS, eager
        graphs.step("s", lambda a: a, (x,), static=(3,))
    assert made == ["s", "s"] and graphs.eager_calls == {"s": 13}
    assert graphs.replays == {"s": 3} and len(graphs.captures) == 2
    graphs.reset_counts()
    assert graphs.replays == {} and graphs.eager_calls == {}
