"""Visual feature tracker: KLT tracking + Shi-Tomasi refill + RANSAC gating.

Port of vil_fusion_tpu/models/tracker.py (the reference's FeatureTracker:
readImage, rejectWithF, setMask, undistortedPoints, and the mask-gated
dynamic-scene variant). Fixed-capacity slot store (cap features); the
reference's per-frame dynamic vectors are masked tensors, its id counter and
track lengths live in the state.

Runs eagerly. The reference's `lax.cond` on `state.initialized` is a host
branch here: `track_step` takes `initialized` as a host bool (callers keep a
host mirror, so no frame reads the device); when None it is read from the
device (one synchronisation).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vil_fusion_tpu_torch.models import cameras, klt
from vil_fusion_tpu_torch.ops import image as im


class TrackerConfig(NamedTuple):
    max_cnt: int = 150  # MAX_CNT (kitti_config max_cnt)
    min_dist: int = 30  # MIN_DIST
    cap: int = 256  # feature slots
    use_clahe: bool = False  # EQUALIZE
    ransac: bool = True
    f_thresh_px: float = 1.0  # F_THRESHOLD
    focal: float = 460.0
    mask_gate: bool = False  # dynamic-scene (Mask-RCNN) variant
    epipolar_reject_px: float = 1.0  # rejectWithF_mask threshold


class TrackerState(NamedTuple):
    prev_img: torch.Tensor  # (H, W)
    xy: torch.Tensor  # (cap, 2) pixel positions in prev_img
    valid: torch.Tensor  # (cap,)
    ids: torch.Tensor  # (cap,) int32
    track_cnt: torch.Tensor  # (cap,) int32
    prev_und: torch.Tensor  # (cap, 2) normalized coords
    next_id: torch.Tensor  # () int32
    prev_time: torch.Tensor  # ()
    initialized: torch.Tensor  # () bool


def init_tracker(height: int, width: int, cfg: TrackerConfig, dtype=torch.float32,
                 device="cuda") -> TrackerState:
    return TrackerState(
        prev_img=torch.zeros((height, width), dtype=dtype, device=device),
        xy=torch.zeros((cfg.cap, 2), dtype=dtype, device=device),
        valid=torch.zeros((cfg.cap,), dtype=torch.bool, device=device),
        ids=torch.full((cfg.cap,), -1, dtype=torch.int32, device=device),
        track_cnt=torch.zeros((cfg.cap,), dtype=torch.int32, device=device),
        prev_und=torch.zeros((cfg.cap, 2), dtype=dtype, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        prev_time=torch.zeros((), dtype=dtype, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def _undistort(cam, xy):
    ray = cameras.lift(cam, xy)
    z = torch.clamp(ray[..., 2], min=1e-6)
    return ray[..., :2] / z[..., None]


def _scatter_rows(base, slot, rows, cap: int):
    """base (cap, ...) with rows written at `slot`; slot == cap drops the row
    (all dropped rows share that overflow slot)."""
    out = torch.cat([base, torch.zeros_like(base[:1])], dim=0)
    out[slot] = rows
    return out[:cap]


def track_step(state: TrackerState, img, t, cam, cfg: TrackerConfig,
               dyn_mask: Optional[torch.Tensor] = None, generator=None, sel=None,
               initialized: Optional[bool] = None):
    """One frame: returns (new_state, obs) where obs is a dict with per-slot
    ids/valid/uv pixels/normalized xy/velocity/track_cnt.

    Accepts uint8 images and normalizes on the device. `t` is a float or a
    0-d tensor. `generator` (a torch.Generator on the image's device) or
    `sel` ((128, 8) sample indices) feed the RANSAC; `dyn_mask` (H, W), True
    on dynamic objects, feeds the mask gate. `initialized` is the host
    mirror of state.initialized."""
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) * (1.0 / 255.0)
    dtype = img.dtype
    dev = img.device
    img_p = im.clahe(img) if cfg.use_clahe else img
    if initialized is None:
        initialized = bool(state.initialized)
    t = torch.as_tensor(t, dtype=dtype, device=dev)

    H, W = img.shape
    cap = cfg.cap

    if initialized:
        pts2, status = klt.track_pyramidal(state.prev_img, img_p, state.xy, state.valid)
        tracked = status & state.valid
    else:
        pts2, tracked = state.xy, torch.zeros_like(state.valid)

    # dynamic-object gating: drop tracked points on the (eroded) mask
    gate = cfg.mask_gate and dyn_mask is not None
    if gate:
        er = 1.0 - im.max_pool_same(dyn_mask.to(dtype), 5)  # erode free space 5 px
        mval, _ = im.bilinear_sample(er, pts2)
        on_clean = mval > 0.5
    else:
        on_clean = torch.ones((cap,), dtype=torch.bool, device=dev)

    # border rejection
    inb = ((pts2[:, 0] >= 1) & (pts2[:, 0] < W - 2)
           & (pts2[:, 1] >= 1) & (pts2[:, 1] < H - 2))
    tracked = tracked & inb

    # fundamental-matrix RANSAC on undistorted coords (rejectWithF)
    und_prev = _undistort(cam, state.xy)
    und_cur = _undistort(cam, pts2)
    if cfg.ransac:
        fit_mask = tracked & on_clean  # mask variant: F from clean points only
        inl, Fm = klt.ransac_fundamental(
            und_prev, und_cur, fit_mask, generator=generator, sel=sel,
            thresh_px=cfg.f_thresh_px, focal=cfg.focal)
        n_fit = torch.sum(fit_mask)
        if cfg.mask_gate:
            # epipolar rejection of ALL tracked points against the clean F
            # (kills "hidden" dynamic points)
            one = torch.ones((cap, 1), dtype=dtype, device=dev)
            ph1 = torch.cat([und_prev * cfg.focal, one], -1)
            ph2 = torch.cat([und_cur * cfg.focal, one], -1)
            Fx1 = ph1 @ Fm.T
            Ftx2 = ph2 @ Fm
            d2 = (torch.sum(ph2 * Fx1, -1) ** 2 /
                  torch.clamp(Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2
                              + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2, min=1e-12))
            tracked = tracked & (d2 < cfg.epipolar_reject_px ** 2) & on_clean
        else:
            tracked = tracked & torch.where(n_fit >= 8, inl, tracked)
    else:
        tracked = tracked & on_clean

    track_cnt = torch.where(tracked, state.track_cnt + 1, torch.zeros_like(state.track_cnt))

    # --- refill with new detections (setMask + goodFeaturesToTrack) ---
    n_tracked = torch.sum(tracked)
    det_xy, det_ok = im.detect_features(img_p, pts2, tracked, max_pts=cap,
                                        min_dist=cfg.min_dist)
    if gate:
        dval, _ = im.bilinear_sample(dyn_mask.to(dtype), det_xy)
        det_ok = det_ok & (dval < 0.5)
    budget = torch.clamp(cfg.max_cnt - n_tracked, min=0)
    det_rank = torch.cumsum(det_ok, 0) - 1
    det_take = det_ok & (det_rank < budget)

    # allocate free slots for new detections
    free = ~tracked
    free_slots = torch.argsort((~free).to(torch.int8), stable=True)
    n_free = torch.sum(free)
    new_rank = torch.cumsum(det_take, 0) - 1
    can = det_take & (new_rank < n_free)
    slot = torch.where(can, free_slots[torch.clamp(new_rank, 0, cap - 1)],
                       torch.full_like(new_rank, cap))

    xy_new = _scatter_rows(pts2, slot, det_xy, cap)
    valid_new = _scatter_rows(tracked, slot, det_take, cap)
    new_ids_vals = state.next_id + new_rank.to(torch.int32)
    ids_new = _scatter_rows(
        torch.where(tracked, state.ids, torch.full_like(state.ids, -1)), slot,
        torch.where(can, new_ids_vals, torch.full_like(new_ids_vals, -1)), cap)
    cnt_new = _scatter_rows(track_cnt, slot, torch.ones_like(track_cnt), cap)
    next_id = state.next_id + torch.sum(can).to(torch.int32)

    und_new = _undistort(cam, xy_new)
    dt = torch.clamp(t - state.prev_time, min=1e-6)
    was_tracked = _scatter_rows(tracked, slot, torch.zeros_like(tracked), cap)
    prev_und_for = _scatter_rows(state.prev_und, slot, torch.zeros_like(state.prev_und), cap)
    if initialized:
        vel = torch.where(was_tracked[:, None], (und_new - prev_und_for) / dt,
                          torch.zeros_like(und_new))
    else:
        vel = torch.zeros_like(und_new)

    new_state = TrackerState(
        prev_img=img_p, xy=xy_new, valid=valid_new, ids=ids_new,
        track_cnt=cnt_new, prev_und=und_new, next_id=next_id,
        prev_time=t, initialized=torch.ones((), dtype=torch.bool, device=dev))
    obs = dict(ids=torch.where(valid_new, ids_new, torch.full_like(ids_new, -1)),
               valid=valid_new, uv=xy_new, xy=und_new, vel=vel, track_cnt=cnt_new)
    return new_state, obs
