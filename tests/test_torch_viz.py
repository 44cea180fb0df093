"""The port's plots (vil_fusion_tpu_torch/runtime/viz.py, rasterized with
numpy, no matplotlib): the four plots of tests/test_pipeline.py's
test_viz_renders and render_pipeline_report write PNG files that the
port's decoder and PIL both read, with the trajectory's pixels drawn."""
from types import SimpleNamespace

import numpy as np
import torch
from PIL import Image

from vil_fusion_tpu_torch.runtime import imageio, viz
from vil_fusion_tpu_torch.runtime.pipeline import PipelineOutputs


def _read_both(path):
    mine = imageio.read_png(str(path))
    pil = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(mine, pil)
    return mine


def _vertex_colors(img, panel_args, xy):
    """Colours of the pixels a Panel with these arguments maps xy to."""
    panel = viz.Panel(np.zeros_like(img), *panel_args)
    px = np.rint(panel.to_px(xy)).astype(int)
    return img[px[:, 1], px[:, 0]]


def test_viz_renders(tmp_path):
    rng = np.random.default_rng(0)
    ps = np.cumsum(rng.normal(0, 0.2, (50, 3)), 0)
    viz.plot_trajectories({"a": ps, "b": ps + 0.1}, str(tmp_path / "t.png"))
    viz.plot_map(rng.normal(0, 5, (500, 3)).astype(np.float32), np.ones(500, bool),
                 ps, str(tmp_path / "m.png"))
    viz.plot_loops(ps, [(0, 40), (5, 45)], str(tmp_path / "l.png"))
    Rs = np.tile(np.eye(3), (10, 1, 1))
    viz.plot_frusta(Rs, ps[:10], str(tmp_path / "f.png"))
    imgs = {}
    for f in ("t.png", "m.png", "l.png", "f.png"):
        assert (tmp_path / f).stat().st_size > 1000
        imgs[f] = _read_both(tmp_path / f)
    # every vertex of trajectory "a" is drawn in its colour or "b"'s (drawn over it)
    got = _vertex_colors(imgs["t.png"], (24, 24, 676, 552, np.concatenate([ps, ps + 0.1])[:, :2]),
                         ps[:, :2])
    assert all(tuple(c) in {tuple(viz.CYCLE[0]), tuple(viz.CYCLE[1])} for c in got)
    # the loop plot: trajectory in blue, chord ends in green
    got = _vertex_colors(imgs["l.png"], (24, 24, 912, 912, ps[:, :2]), ps[:, :2])
    assert all(tuple(c) in {tuple(viz.BLUE), tuple(viz.GREEN)} for c in got)
    assert tuple(got[40]) == tuple(viz.GREEN)
    # the map: the red trajectory over points coloured by height
    m = imgs["m.png"]
    assert (m == viz.RED).all(-1).sum() > 200
    assert len(np.unique(m.reshape(-1, 3), axis=0)) > 50
    # the frusta: red wireframes beside the blue path
    assert (imgs["f.png"] == viz.RED).all(-1).sum() > 500


def test_render_pipeline_report(tmp_path):
    """The report of a lidar-mode pipeline's state (host outputs, maps and
    graph as tensors): trajectories, map and loops files."""
    rng = np.random.default_rng(1)
    out = PipelineOutputs()
    for k in range(20):
        p = np.array([0.5 * k, np.sin(0.3 * k), 0.01 * k], np.float32)
        out.ts.append(0.1 * k)
        for lst in (out.vio_p, out.lidar_p):
            lst.append(p)
        out.initialized.append(True)
    surf = torch.as_tensor(rng.normal(0, 5, (256, 3)), dtype=torch.float32)
    pipe = SimpleNamespace(
        outputs=out,
        lidar_state=SimpleNamespace(surf_map=surf, surf_map_valid=torch.arange(256) < 200),
        fusion=SimpleNamespace(n_kf=20, loops_found=[(2, 18)],
                               poses=lambda: (None, np.stack(out.lidar_p))))
    viz.render_pipeline_report(pipe, str(tmp_path / "report"))
    for f in ("trajectories.png", "map.png", "loops.png"):
        img = _read_both(tmp_path / "report" / f)
        assert (img != 255).any(-1).sum() > 500, f
