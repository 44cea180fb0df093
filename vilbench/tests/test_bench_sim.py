"""The frozen simulator: TorchRaycast against the numpy raycast at a tiny
size, and the periodic route closing its lap exactly."""
import numpy as np

from vilbench.sim import sim
from vilbench.tests import tiny
from vilbench.traffic import circuit


def test_torch_raycast_matches_numpy():
    scene = sim.urban_block_scene(25.0, pillar_step_deg=16.0, box_step_deg=24.0)
    ray = sim.TorchRaycast(scene, device="cpu")
    traj = circuit.route(tiny.spec("kitti_lidar.city_laps")["traffic"])
    for s in (0.0, 3.3, 11.1):
        R, p = traj.rotation(s), traj.position(s) + np.array([0.0, 0.0, 1.5])
        kw = dict(n_scan=16, width=180, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0)
        pts_t, val_t = sim.simulate_lidar_scan(ray, R, p, **kw)
        pts_n, val_n = sim.simulate_lidar_scan(scene, R, p, **kw)
        assert val_t.sum() > 100 and (val_t == val_n).mean() > 0.999
        both = val_t & val_n
        assert np.abs(pts_t[both] - pts_n[both]).max() < 2e-3
        img_t = sim.render_camera_image(ray, R, p, 40.0, 40.0, 40.0, 30.0, 60, 80)
        img_n = sim.render_camera_image(scene, R, p, 40.0, 40.0, 40.0, 30.0, 60, 80)
        assert np.mean(np.abs(img_t - img_n) > 2.0 / 255.0) < 0.01


def test_route_closes_its_lap():
    t = tiny.spec("kitti_vil.city")["traffic"]
    traj = circuit.route(t)
    lap_s = t["route"]["lap_frames"] / t["route"]["frame_hz"]
    for s in (0.0, 1.7, 5.05):
        assert np.allclose(traj.position(s), traj.position(s + lap_s), atol=1e-9)
        assert np.allclose(traj.rotation(s), traj.rotation(s + lap_s), atol=1e-9)
        a0, g0 = traj.imu_sample(s)
        a1, g1 = traj.imu_sample(s + lap_s)
        assert np.allclose(a0, a1, atol=1e-4) and np.allclose(g0, g1, atol=1e-6)
