"""The port's device raycaster (sim.TorchRaycast) on the CPU against the
numpy raycast and the JAX package's JaxRaycast, with tests/test_sim.py's
gates: hit/miss agreement > 99.5%, ranges within 1e-3 m where both hit,
scans within 2e-3 m, uint8 images within +-1 grey level on > 99.5% of
pixels; and the port's run_synthetic.make_events against the reference
tool's for 2 frames of a small circuit."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from vil_fusion_tpu.runtime import sim as jsim
from vil_fusion_tpu_torch.runtime import sim as tsim
from vil_fusion_tpu_torch.tools import run_synthetic

REPO = Path(__file__).resolve().parents[1]
SCENES = [pytest.param(lambda m: m.RaycastScene(), (30.0, 0.0), id="corridor"),
          pytest.param(lambda m: m.urban_block_scene(20.0, pillar_step_deg=10.0,
                                                     box_step_deg=15.0), (0.0, 2.0),
                       id="urban")]


def _rays(center, n, seed):
    rng = np.random.default_rng(seed)
    p = np.array([center[0], center[1], 1.4])
    d = rng.normal(size=(n, 3))
    d[:, 2] *= 0.3  # mostly horizontal, like real sensors
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(p, d.shape).copy(), d


def _ranges_agree(t_a, t_b, least_hits=500):
    hit_a, hit_b = np.isfinite(t_a), np.isfinite(t_b)
    assert (hit_a == hit_b).mean() > 0.995
    both = hit_a & hit_b
    assert both.sum() > least_hits
    assert np.abs(t_a[both] - t_b[both]).max() < 1e-3


def _u8(img):
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("scene_fn,center", SCENES)
def test_torch_raycast_parity(scene_fn, center):
    scene = scene_fn(tsim)
    rc = tsim.TorchRaycast(scene, device="cpu", chunk=512)
    o, d = _rays(center, 2048, seed=3)
    t = rc.raycast(o, d, max_range=80.0)
    assert t.dtype == np.float32 and t.shape == (2048,)
    _ranges_agree(t, scene.raycast(o, d, max_range=80.0))
    _ranges_agree(t, jsim.JaxRaycast(scene_fn(jsim), chunk=512).raycast(o, d, max_range=80.0))


@pytest.mark.parametrize("scene_fn,center", SCENES)
def test_torch_scan_and_image_match(scene_fn, center):
    scene = scene_fn(tsim)
    rc = tsim.TorchRaycast(scene, device="cpu", chunk=1024)
    jrc = jsim.JaxRaycast(scene_fn(jsim), chunk=1024)
    R = tsim._ypr_to_R(0.4, 0.02, -0.01)
    p = np.array([center[0] + 2.0, center[1] + 1.0, 1.5])
    scan = dict(n_scan=16, width=300, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=60.0)
    pts, val = tsim.simulate_lidar_scan(rc, R, p, **scan)
    assert pts.dtype == np.float32 and pts.shape == (4800, 3)
    for ref in (tsim.simulate_lidar_scan(scene, R, p, **scan),
                jsim.simulate_lidar_scan(jrc, R, p, **scan)):
        assert (val == ref[1]).mean() > 0.995
        both = val & ref[1]
        assert both.sum() > 1000
        assert np.abs(pts[both] - ref[0][both]).max() < 2e-3
    cam = (120.0, 120.0, 80.0, 60.0, 120, 160)
    img = tsim.render_camera_image(rc, R, p, *cam)
    assert img.dtype == np.float32 and img.shape == (120, 160)
    u = _u8(img)
    np.testing.assert_array_equal(u, rc.render_image_u8(R, p, *cam))
    for ref in (tsim.render_camera_image(scene, R, p, *cam),
                jsim.render_camera_image(jrc, R, p, *cam)):
        assert (np.abs(u.astype(int) - _u8(ref).astype(int)) <= 1).mean() > 0.995


def test_distorted_scan_passes_raycaster_through():
    scene = tsim.urban_block_scene(20.0, pillar_step_deg=10.0, box_step_deg=15.0)
    rc = tsim.TorchRaycast(scene, device="cpu", chunk=2048)
    traj = tsim.LoopTrajectory(radius=20.0, period=30.0)
    kw = dict(n_scan=8, width=200, fov_up_deg=2.0, fov_down_deg=-24.8, n_segments=4)
    p_t, v_t = tsim.simulate_lidar_scan_distorted(rc, traj, 1.3, 0.1, np.array([0, 0, 1.5]), **kw)
    p_n, v_n = tsim.simulate_lidar_scan_distorted(scene, traj, 1.3, 0.1, np.array([0, 0, 1.5]),
                                                  **kw)
    assert (v_t == v_n).mean() > 0.995 and np.abs(p_t[v_t & v_n] - p_n[v_t & v_n]).max() < 2e-3
    assert len(rc._grids) == 1  # the scan path's resident grid, not per-call uploads


def _reference_tool():
    spec = importlib.util.spec_from_file_location("ref_run_synthetic",
                                                  REPO / "tools" / "run_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_events_match_reference_tool():
    """2 frames of a 20 m circuit through the port's make_events
    (TorchRaycast on the CPU) and the reference tool's (JaxRaycast): the same
    event kinds and times, IMU bit for bit, HDL-64 scans and 60 x 80 images
    within the gates above."""
    r_bc = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    geom = (r_bc, 60, 80, 60.0, 60.0, 40.0, 30.0)
    traj = tsim.LoopTrajectory(radius=20.0, period=2 * np.pi * 20.0 / 8.0)

    def scene(m):
        return m.urban_block_scene(20.0, pillar_step_deg=10.0, box_step_deg=15.0)

    render_s = []
    port = list(run_synthetic.make_events(traj, tsim.TorchRaycast(scene(tsim), device="cpu"),
                                          geom, 2, render_s=render_s))
    ref = list(_reference_tool().make_events(traj, jsim.JaxRaycast(scene(jsim)), geom, 2))
    assert len(render_s) == 2
    assert [e[:2] for e in port] == [e[:2] for e in ref]
    assert [e[0] for e in port] == ["scan", "image"] + ["imu"] * 20 + ["scan", "image"]
    for a, b in zip(port, ref):
        if a[0] == "imu":
            for x, y in zip(a[2:], b[2:]):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        elif a[0] == "scan":
            (pa, va), (pb, vb) = a[2:], b[2:]
            assert pa.shape == pb.shape == (115200, 3) and pa.dtype == pb.dtype == np.float32
            assert (va == vb).mean() > 0.995
            assert np.abs(pa[va & vb] - pb[va & vb]).max() < 2e-3
        else:
            assert a[2].dtype == b[2].dtype == np.uint8 and a[2].shape == (60, 80)
            assert (np.abs(a[2].astype(int) - b[2].astype(int)) <= 1).mean() > 0.995
