"""One rank of the port's parallel/ modules over a gloo process group on the
CPU, for tests/test_torch_parallel.py (which spawns four of them).

Imports the port, numpy and the standard library only: a rank checks that
jax stays out of its interpreter. Inputs and results travel as pickled
dicts of numpy arrays.
"""
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    return t.detach().cpu().numpy()


def _raises(fn, exc, text):
    """The message of the `exc` that fn() raises (None if it does not)."""
    try:
        fn()
    except exc as e:
        return text in str(e)
    return False


def run(rank: int, world: int, init_file: str, in_path: str, out_path: str):
    torch.set_num_threads(1)
    from vil_fusion_tpu_torch.models import ba, estimator
    from vil_fusion_tpu_torch.models import lidar_features as lf
    from vil_fusion_tpu_torch.models import lidar_odometry as lo
    from vil_fusion_tpu_torch.models import scancontext as sc
    from vil_fusion_tpu_torch.models.factors import MargPrior
    from vil_fusion_tpu_torch.models.window import (FeatureStore, LidarConstraints, StackedPreint,
                                                    WindowState)
    from vil_fusion_tpu_torch.parallel import batched_odometry as bo
    from vil_fusion_tpu_torch.parallel import mesh as mesh_mod
    from vil_fusion_tpu_torch.parallel import sharded_ba, sharded_knn, sharded_sc
    from vil_fusion_tpu_torch.utils import state_io

    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    out = {}
    try:
        out["no_device_raises"] = _raises(lambda: mesh_mod.make_mesh(world), ValueError,
                                          "names")
        out["too_many_raises"] = _raises(lambda: mesh_mod.make_mesh(world + 1, device="cpu"),
                                         ValueError, f"need {world + 1} devices, have {world}")
        mesh = mesh_mod.make_mesh(world, device="cpu")
        out["mesh"] = (mesh.rank, mesh.size, str(mesh.device))
        out["rows_raise"] = _raises(lambda: mesh_mod.shard_rows(mesh, torch.zeros(world + 1)),
                                    ValueError, "do not divide")

        # kNN over the map's blocks
        q, db, v = (torch.from_numpy(inp["knn"][k]) for k in ("q", "db", "valid"))
        d2, idx = sharded_knn.knn_sharded(mesh, q, db, v, k=5)
        out["knn"] = (_np(d2), _np(idx))

        # ScanContext over the database's blocks
        sdb = sc.init_db(inp["sc"]["capacity"], device="cpu")
        for pts, val in inp["sc"]["scans"]:
            sc.add_keyframe(sdb, sc.make_descriptor(torch.from_numpy(pts), torch.from_numpy(val)))
        query = sc.make_descriptor(*(torch.from_numpy(a) for a in inp["sc"]["query"]))
        out["sc"] = tuple(_np(t) for t in sharded_sc.detect_loop_sharded(mesh, sdb, query))

        # bundle adjustment over the landmarks' blocks
        P = inp["ba"]
        prob = (state_io.to_torch(WindowState, P["window"], "cpu"),
                state_io.to_torch(FeatureStore, P["feats"], "cpu"),
                state_io.to_torch(StackedPreint, P["pre"], "cpu"),
                state_io.to_torch(LidarConstraints, P["lidar"], "cpu"),
                state_io.to_torch(MargPrior, P["prior"], "cpu"))

        def keep(res):
            st, ft, cost = res
            return dict(p=_np(st.p), q=_np(st.q), inv_depth=_np(ft.inv_depth), cost=_np(cost))

        out["ba_step"] = keep(sharded_ba.optimize_step_sharded(mesh, *prob, ba.BAConfig(max_iters=1)))
        out["ba_full"] = keep(sharded_ba.optimize_sharded(mesh, *prob, ba.BAConfig(max_iters=8)))
        cfg = ba.BAConfig(max_iters=4, sharded=True)
        out["no_mesh_raises"] = _raises(lambda: ba.check_config(cfg), RuntimeError, "no active mesh")
        mesh_mod.set_active_mesh(mesh)
        try:
            ba.check_config(cfg)
            out["ba_active"] = keep(estimator._optimize(*prob, cfg))
        finally:
            mesh_mod.set_active_mesh(None)

        # sequences over the ranks
        O = inp["odom"]
        ocfg = lo.OdomConfig(lidar=lf.LidarConfig(**O["lidar"]), **O["cfg"])
        states = bo.shard_states(mesh, lo.init_state_batched(ocfg, O["points"].shape[0],
                                                             device="cpu"))
        pts, val = torch.from_numpy(O["points"]), torch.from_numpy(O["valid"])
        for f in range(O["steps"]):
            states, res = bo.odometry_step_sharded(mesh, states, pts, val, ocfg, frame_count=f)
        out["odom"] = dict(p=_np(states.p), q=_np(states.q), out_p=_np(res[1]))
        out["jax_imported"] = "jax" in sys.modules
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def pipeline_frames(n_frames: int = 28):
    """tests/test_pipeline.py:174-201's sequence with the port's simulator:
    (t, imu, image, points, valid) at 10 Hz along Trajectory(speed=1.5)."""
    from vil_fusion_tpu_torch.runtime import sim

    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=1.5))
    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    frames = []
    for i in range(n_frames):
        t = 1.0 + i * 0.1
        imu = sim.simulate_imu(traj, t - 0.1, t, 200.0) if i else None
        R_wb = traj.rotation(t)
        p_wb = traj.position(t) + np.array([0, 0, 1.5])
        img = np.asarray(sim.render_camera_image(scene, R_wb @ r_bc, p_wb, 250.0, 250.0, 160.0,
                                                 120.0, 240, 320))
        pts, val = sim.simulate_lidar_scan(scene, R_wb, p_wb, n_scan=32, width=900,
                                           fov_up_deg=30.0, fov_down_deg=-30.0, max_range=80.0)
        frames.append((t, imu, img, np.asarray(pts), np.asarray(val)))
    return traj, frames


def drive_pipeline(ba_overrides, device="cpu"):
    """The port's VILFusionPipeline (mode "vil", tests/test_pipeline.py's
    rig) over `pipeline_frames`, from the oracle state; the VIO positions."""
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    rig = RigConfig(
        name="synthetic",
        camera=dict(model_type="PINHOLE", projection_parameters=dict(fx=250.0, fy=250.0,
                                                                     cx=160.0, cy=120.0),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=240, image_width=320, q_ic=sim.R_to_q(r_bc), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(r_bc.T), t_cl=np.zeros(3), max_cnt=80, min_dist=18, n_scan=32,
        lidar_fov_up=30.0, lidar_fov_down=-30.0, lidar_min_range=1.0, lidar_max_range=80.0,
        use_lidar=True)
    traj, frames = pipeline_frames()
    pipe = VILFusionPipeline(rig, mode="vil", ba_overrides=ba_overrides, device=device)
    q0, p0 = traj.pose(1.0)
    pipe.estimator.set_initial_state(p=p0 + np.array([0, 0, 1.5]), q=q0, v=traj.velocity(1.0))
    for (t, imu, img, pts, val) in frames:
        if imu is not None:
            ts_i, acc, gyr = imu
            for k in range(1, len(ts_i)):
                pipe.push_imu(ts_i[k], acc[k], gyr[k])
        pipe.push_scan(t, pts, val)
        pipe.push_image(t, img)
    pipe.finalize()
    return np.asarray(pipe.outputs.vio_p), pipe.restarts


def run_pipeline(rank: int, world: int, init_file: str, out_path: str):
    """One rank of the pipeline with ba_overrides={"sharded": True} on a
    mesh of every rank."""
    torch.set_num_threads(1)
    from vil_fusion_tpu_torch.parallel import mesh as mesh_mod

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh_mod.set_active_mesh(mesh_mod.make_mesh(world, device="cpu"))
        vio_p, restarts = drive_pipeline({"sharded": True})
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(dict(vio_p=vio_p, restarts=restarts, jax_imported="jax" in sys.modules), f)
