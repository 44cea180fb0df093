"""Offline visualization (the rviz topic suite, rendered to files).

Port of vil_fusion_tpu/runtime/viz.py: the same plots in the same files,
rasterized with numpy and written as PNG through runtime/imageio.py, since
the port runs where matplotlib is not installed. Deviation: the plots carry
no text (no axis labels, ticks, titles or legend labels: the `title`
arguments are kept for the reference's signatures and not drawn); a legend
is a colour swatch a series, in the order the series were given.

  * plot_trajectories: N named trajectories, top-down + altitude profile
  * plot_map: LiDAR map points coloured by height + trajectory overlay
  * plot_loops: trajectory with loop-closure chords
  * plot_frusta: camera poses as frustum wireframes (oblique 3D view)
"""
from __future__ import annotations

import os

import numpy as np

from vil_fusion_tpu_torch.runtime import imageio

# matplotlib's default colour cycle (tab10), then the map's height colours
# (viridis at 0, 1/4, 1/2, 3/4, 1)
CYCLE = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
                  [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127]], np.uint8)
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98],
                     [253, 231, 37]], np.float64)
RED, GREEN, BLUE = np.array([214, 39, 40]), np.array([44, 160, 44]), np.array([31, 119, 180])
_FRAME = np.array([40, 40, 40], np.uint8)
_MARGIN = 24


class Panel:
    """A rectangle of the canvas with a linear map from data (x, y) to
    pixels (y up); `equal` keeps one scale for both axes."""

    def __init__(self, canvas, x0, y0, w, h, xy, equal=True):
        self.canvas, self.x0, self.y0, self.w, self.h = canvas, x0, y0, w, h
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        xy = xy[np.isfinite(xy).all(1)]
        lo, hi = (xy.min(0), xy.max(0)) if len(xy) else (np.zeros(2), np.ones(2))
        span = np.maximum(hi - lo, 1e-6)
        lo, span = lo - 0.05 * span, span * 1.1
        sx, sy = (w - 1) / span[0], (h - 1) / span[1]
        if equal:
            sx = sy = min(sx, sy)
        self.lo, self.scale = lo, np.array([sx, sy])
        # the data centred in the panel
        self.pad = np.array([(w - 1 - span[0] * sx) / 2, (h - 1 - span[1] * sy) / 2])
        canvas[y0, x0:x0 + w] = _FRAME
        canvas[y0 + h - 1, x0:x0 + w] = _FRAME
        canvas[y0:y0 + h, x0] = _FRAME
        canvas[y0:y0 + h, x0 + w - 1] = _FRAME

    def to_px(self, xy):
        """(N, 2) data -> (N, 2) float pixel (column, row)."""
        p = (np.asarray(xy, np.float64).reshape(-1, 2) - self.lo) * self.scale
        return np.stack([self.x0 + self.pad[0] + p[:, 0],
                         self.y0 + self.h - 1 - self.pad[1] - p[:, 1]], 1)

    def _stamp(self, px, colors, size):
        """Paint size x size pixel squares at px (N, 2) float, inside the frame."""
        colors = np.broadcast_to(np.asarray(colors, np.uint8), (len(px), 3))
        ok = np.isfinite(px).all(1)
        px, colors = np.rint(px[ok]).astype(np.int64), colors[ok]
        r0 = -(size // 2)
        for dy in range(r0, r0 + size):
            for dx in range(r0, r0 + size):
                c, r = px[:, 0] + dx, px[:, 1] + dy
                m = ((c > self.x0) & (c < self.x0 + self.w - 1)
                     & (r > self.y0) & (r < self.y0 + self.h - 1))
                self.canvas[r[m], c[m]] = colors[m]

    def dots(self, xy, colors, size=1):
        """The points in `colors` ((3,) or (N, 3)), size x size pixels each."""
        self._stamp(self.to_px(xy), colors, size)

    def lines(self, a, b, color, width=1):
        """Segments a[i] -> b[i] ((N, 2) data), sampled at half-pixel steps."""
        pa, pb = self.to_px(a), self.to_px(b)
        ok = np.isfinite(pa).all(1) & np.isfinite(pb).all(1)
        pa, pb = pa[ok], pb[ok]
        if not len(pa):
            return
        n = np.ceil(2 * np.abs(pb - pa).max(1)).astype(np.int64) + 1
        seg = np.repeat(np.arange(len(pa)), n)
        frac = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(
            np.maximum(n - 1, 1), n)
        self._stamp(pa[seg] + frac[:, None] * (pb - pa)[seg], color, width)

    def polyline(self, xy, color, width=1):
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        if len(xy) == 1:
            self.dots(xy, color, width)
        self.lines(xy[:-1], xy[1:], color, width)


def _canvas(w, h):
    return np.full((h, w, 3), 255, np.uint8)


def _legend(canvas, x0, y0, n):
    """One colour swatch a series, top-left of a panel (no labels)."""
    for k in range(n):
        canvas[y0 + 6 + 10 * k:y0 + 12 + 10 * k, x0 + 6:x0 + 22] = CYCLE[k % len(CYCLE)]


def _height_colors(z):
    """(N,) heights -> (N, 3) uint8 viridis colours over the heights' range."""
    z = np.asarray(z, np.float64)
    lo, hi = (z.min(), z.max()) if len(z) else (0.0, 1.0)
    f = np.clip((z - lo) / max(hi - lo, 1e-9), 0.0, 1.0) * (len(_VIRIDIS) - 1)
    i = np.minimum(f.astype(np.int64), len(_VIRIDIS) - 2)
    w = (f - i)[:, None]
    return np.rint(_VIRIDIS[i] * (1 - w) + _VIRIDIS[i + 1] * w).astype(np.uint8)


def plot_trajectories(named_trajs: dict, path: str, title: str = "trajectories"):
    """named_trajs: {label: (N, 3) positions}: top-down (x, y) on the left,
    altitude z against the frame index on the right."""
    trajs = [np.asarray(ps, np.float64).reshape(-1, 3) for ps in named_trajs.values()]
    canvas = _canvas(1440, 600)
    allp = np.concatenate(trajs) if trajs else np.zeros((0, 3))
    top = Panel(canvas, _MARGIN, _MARGIN, 700 - _MARGIN, 600 - 2 * _MARGIN, allp[:, :2])
    prof = np.concatenate([np.stack([np.arange(len(p)), p[:, 2]], 1) for p in trajs]) \
        if trajs else np.zeros((0, 2))
    side = Panel(canvas, 740, _MARGIN, 1440 - 740 - _MARGIN, 600 - 2 * _MARGIN, prof,
                 equal=False)
    for k, ps in enumerate(trajs):
        color = CYCLE[k % len(CYCLE)]
        top.polyline(ps[:, :2], color, width=2)
        side.polyline(np.stack([np.arange(len(ps)), ps[:, 2]], 1), color, width=1)
    _legend(canvas, _MARGIN, _MARGIN, len(trajs))
    imageio.write_png(path, canvas)


def plot_map(map_pts, map_valid, traj_ps, path: str, title: str = "map"):
    """Map points coloured by height (viridis), the trajectory in red."""
    pts = np.asarray(map_pts, np.float64).reshape(-1, 3)[np.asarray(map_valid, bool).reshape(-1)]
    traj_ps = np.asarray(traj_ps, np.float64).reshape(-1, 3)
    canvas = _canvas(1080, 960)
    panel = Panel(canvas, _MARGIN, _MARGIN, 1080 - 2 * _MARGIN, 960 - 2 * _MARGIN,
                  np.concatenate([pts[:, :2], traj_ps[:, :2]]))
    if len(pts):
        panel.dots(pts[:, :2], _height_colors(pts[:, 2]))
    if len(traj_ps):
        panel.polyline(traj_ps[:, :2], RED, width=2)
    imageio.write_png(path, canvas)


def plot_loops(traj_ps, loop_pairs, path: str, title: str = "loop closures"):
    """loop_pairs: [(i, j), ...] indices into traj_ps: the trajectory in blue,
    each loop a green chord with its two ends marked."""
    ps = np.asarray(traj_ps, np.float64).reshape(-1, 3)
    canvas = _canvas(960, 960)
    panel = Panel(canvas, _MARGIN, _MARGIN, 960 - 2 * _MARGIN, 960 - 2 * _MARGIN, ps[:, :2])
    panel.polyline(ps[:, :2], BLUE, width=1)
    pairs = np.asarray(loop_pairs, np.int64).reshape(-1, 2)
    if len(pairs):
        panel.lines(ps[pairs[:, 0], :2], ps[pairs[:, 1], :2], GREEN, width=1)
        panel.dots(ps[pairs.reshape(-1), :2], GREEN, size=5)
    imageio.write_png(path, canvas)


def _frustum_lines(R_wc, p_wc, scale=0.6, aspect=0.75):
    """Camera frustum wireframe segments (CameraPoseVisualization analog)."""
    w = scale
    h = scale * aspect
    d = scale * 1.2
    corners = np.array([[-w, -h, d], [w, -h, d], [w, h, d], [-w, h, d]])
    cw = corners @ R_wc.T + p_wc
    segs = []
    for k in range(4):
        segs.append((p_wc, cw[k]))
        segs.append((cw[k], cw[(k + 1) % 4]))
    return segs


def _oblique(xyz, azim_deg=-60.0, elev_deg=30.0):
    """Orthographic view of (N, 3) points from matplotlib's default 3D
    angle: (N, 2) screen coordinates."""
    a, e = np.deg2rad(azim_deg), np.deg2rad(elev_deg)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a), np.cos(e)])
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    return np.stack([xyz @ right, xyz @ up], 1)


def plot_frusta(Rs_wc, ps_wc, path: str, title: str = "camera poses"):
    """The camera path in blue and each pose's frustum wireframe in red."""
    ps = np.asarray(ps_wc, np.float64).reshape(-1, 3)
    segs = [s for R, p in zip(np.asarray(Rs_wc, np.float64), ps) for s in _frustum_lines(R, p)]
    a = np.array([s[0] for s in segs]).reshape(-1, 3)
    b = np.array([s[1] for s in segs]).reshape(-1, 3)
    canvas = _canvas(1080, 960)
    panel = Panel(canvas, _MARGIN, _MARGIN, 1080 - 2 * _MARGIN, 960 - 2 * _MARGIN,
                  _oblique(np.concatenate([ps, a, b])))
    panel.polyline(_oblique(ps), BLUE, width=1)
    if len(segs):
        panel.lines(_oblique(a), _oblique(b), RED, width=1)
    imageio.write_png(path, canvas)


def render_pipeline_report(pipeline, out_dir: str):
    """One-call dump of every visualization the pipeline can produce."""
    os.makedirs(out_dir, exist_ok=True)
    o = pipeline.outputs
    ini = o.initialized or [True] * len(o.ts)
    sel = [k for k, ok in enumerate(ini) if ok]
    trajs = {"vio": [o.vio_p[k] for k in sel]}
    if o.loop_p:
        trajs["loop-corrected"] = [o.loop_p[k] for k in sel]
    if o.lidar_p:
        trajs["lidar-odom"] = o.lidar_p
    if trajs["vio"]:
        plot_trajectories(trajs, os.path.join(out_dir, "trajectories.png"))
    ls = pipeline.lidar_state
    valid = ls.surf_map_valid.cpu().numpy()
    if int(valid.sum()):
        plot_map(ls.surf_map.cpu().numpy(), valid, o.lidar_p,
                 os.path.join(out_dir, "map.png"))
    if pipeline.fusion is not None and pipeline.fusion.n_kf:
        _, p_all = pipeline.fusion.poses()
        plot_loops(p_all, pipeline.fusion.loops_found,
                   os.path.join(out_dir, "loops.png"))
