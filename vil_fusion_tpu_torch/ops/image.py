"""Image operations for the visual front end (plain PyTorch).

Port of vil_fusion_tpu/ops/image.py, which replaces the OpenCV primitives of
the reference's tracker: pyramids by average pooling, Sobel gradients and
box sums by shift-and-add, bilinear sampling by gathers, non-maximum
suppression by separable max pooling; all static-shape and batched.

Convention: grayscale images (H, W) float32; points are (x, y) = (col, row).

Precision: every stencil here is shift-and-add in float32; no convolution
is called, so cuDNN's TF32 default never applies. (The reference's one
reduced-precision opt-out, `_conv2`, serves no function of this module.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample(img, xy):
    """Sample img (H, W) at xy (..., 2) float positions; clamps to border.

    Returns (values (...,), in_bounds (...,))."""
    H, W = img.shape
    x = xy[..., 0]
    y = xy[..., 1]
    inb = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return val, inb


def sobel(img):
    """(Ix, Iy) Sobel gradients, scaled 1/8 (derivative of intensity/px);
    zero padding."""
    p = F.pad(img, (1, 1, 1, 1))
    tl, tc, tr = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
    ml, mr = p[1:-1, :-2], p[1:-1, 2:]
    bl, bc, br = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
    ix = ((tr - tl) + 2.0 * (mr - ml) + (br - bl)) * 0.125
    iy = ((bl - tl) + 2.0 * (bc - tc) + (br - tr)) * 0.125
    return ix, iy


def box_filter(img, radius: int):
    """Sum over (2r+1)^2 window, separable shift-and-add (zero-padded)."""
    H, W = img.shape
    p = F.pad(img, (0, 0, radius, radius))
    tmp = p[:H]
    for d in range(1, 2 * radius + 1):
        tmp = tmp + p[d:d + H]
    p = F.pad(tmp, (radius, radius, 0, 0))
    out = p[:, :W]
    for d in range(1, 2 * radius + 1):
        out = out + p[:, d:d + W]
    return out


def avg_pool2(img):
    """2x2 average pooling (pyramid downsample)."""
    H, W = img.shape
    return img[: H // 2 * 2, : W // 2 * 2].reshape(H // 2, 2, W // 2, 2).mean((1, 3))


def build_pyramid(img, levels: int):
    """[img, img/2, img/4, ...]."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(avg_pool2(pyr[-1]))
    return pyr


def max_pool_same(img, radius: int):
    """Separable max pool over a (2r+1)^2 window, -inf outside the image."""
    w = 2 * radius + 1
    x = img[None, None]
    x = F.max_pool2d(x, kernel_size=(w, 1), stride=1, padding=(radius, 0))
    x = F.max_pool2d(x, kernel_size=(1, w), stride=1, padding=(0, radius))
    return x[0, 0]


def shi_tomasi_response(img, window_radius: int = 1):
    """Min-eigenvalue of the structure tensor (goodFeaturesToTrack score)."""
    ix, iy = sobel(img)
    a = box_filter(ix * ix, window_radius)
    b = box_filter(ix * iy, window_radius)
    c = box_filter(iy * iy, window_radius)
    tr = a + c
    # the correctly rounded float32 square root, as the reference's: taken in
    # float64 and rounded once. torch's float32 sqrt on the CPU (MKL's vector
    # library) is one ulp off on ~0.7% of inputs, and where the two
    # eigenvalues nearly cancel an error in det_part is the whole result.
    disc = torch.clamp((a - c) ** 2 + 4 * b * b, min=0.0)
    det_part = torch.sqrt(disc.double()).to(disc.dtype)
    return 0.5 * (tr - det_part)


def clahe(img, grid: int = 8, clip_limit: float = 3.0, bins: int = 128):
    """True CLAHE (cv::createCLAHE(3.0, 8x8)): per-tile clip-limited
    histogram -> CDF lookup tables, bilinearly blended between the 4
    neighbouring tiles per pixel, with intra-bin interpolation so float
    imagery is not quantized to `bins` levels. Input/output float [0, 1]."""
    H, W = img.shape
    th, tw = -(-H // grid), -(-W // grid)
    Hp, Wp = th * grid, tw * grid
    imgp = F.pad(img[None, None], (0, Wp - W, 0, Hp - H), mode="replicate")[0, 0]
    tiles = imgp.reshape(grid, th, grid, tw).permute(0, 2, 1, 3)
    tiles = tiles.reshape(grid * grid, th * tw)
    idx = torch.clamp((tiles * bins).to(torch.int64), 0, bins - 1)
    hist = torch.zeros((grid * grid, bins), dtype=img.dtype, device=img.device)
    hist.scatter_add_(1, idx, torch.ones_like(tiles))
    # clip + uniform redistribution of the excess (single pass, as OpenCV)
    limit = max(clip_limit * (th * tw) / bins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / bins
    cdf = torch.cumsum(hist, dim=-1)
    cdf_min = cdf[:, :1]
    denom = torch.clamp(cdf[:, -1:] - cdf_min, min=1.0)
    flat = ((cdf - cdf_min) / denom).reshape(-1)  # (T * B,) in [0, 1]

    # tile-space pixel coords (tile centres at integer coords)
    yy = (torch.arange(H, dtype=img.dtype, device=img.device) + 0.5) / th - 0.5
    xx = (torch.arange(W, dtype=img.dtype, device=img.device) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, grid - 1)
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, grid - 1)
    y1 = torch.clamp(y0 + 1, max=grid - 1)
    x1 = torch.clamp(x0 + 1, max=grid - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]
    # intra-bin interpolation: value v sits between bin centres b and b+1
    bf = torch.clamp(img * bins - 0.5, 0.0, bins - 1.001)
    b0 = bf.to(torch.int64)
    fb = bf - b0
    b1 = torch.clamp(b0 + 1, max=bins - 1)

    def tile_val(ty, tx):
        base = (ty[:, None] * grid + tx[None, :]) * bins
        return flat[base + b0] * (1.0 - fb) + flat[base + b1] * fb

    v00 = tile_val(y0, x0)
    v01 = tile_val(y0, x1)
    v10 = tile_val(y1, x0)
    v11 = tile_val(y1, x1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def clahe_like(img, grid: int = 8, clip: float = 0.03):
    """Cheap local contrast normalization standing in for cv::CLAHE:
    per-tile mean/std normalization blended bilinearly."""
    H, W = img.shape
    th, tw = H // grid, W // grid
    tiles = img[: th * grid, : tw * grid].reshape(grid, th, grid, tw)
    mean = tiles.mean((1, 3))
    std = tiles.std((1, 3), correction=0) + clip

    def up(a):  # half-pixel-centre linear resize, edges clamped
        return F.interpolate(a[None, None], size=(H, W), mode="bilinear",
                             align_corners=False)[0, 0]

    out = (img - up(mean)) / up(std)
    return (out - out.min()) / (out.max() - out.min() + 1e-6)


def detect_features(img, occupied_xy, occupied_valid, max_pts: int, min_dist: int = 30,
                    quality: float = 0.01, block: int = 3):
    """Shi-Tomasi corners with min-dist suppression and existing-track
    masking (FeatureTracker::setMask + goodFeaturesToTrack).

    occupied_xy (M, 2) / occupied_valid (M,): existing feature positions.
    Returns (xy (max_pts, 2), valid (max_pts,)), strongest first."""
    H, W = img.shape
    dev = img.device
    resp = shi_tomasi_response(img, block // 2)
    neg = torch.full_like(resp, -1.0)
    r = torch.arange(H, device=dev)[:, None]
    c = torch.arange(W, device=dev)[None, :]
    border = 8
    resp = torch.where((r < border) | (r >= H - border) | (c < border) | (c >= W - border),
                       neg, resp)
    # suppress around existing features: splat + dilate
    ox = torch.clamp(occupied_xy[:, 0].to(torch.int64), 0, W - 1)
    oy = torch.clamp(occupied_xy[:, 1].to(torch.int64), 0, H - 1)
    occ = torch.zeros(H * W, dtype=img.dtype, device=dev)
    occ.scatter_reduce_(0, oy * W + ox, occupied_valid.to(img.dtype), reduce="amax",
                        include_self=True)
    occ = max_pool_same(occ.reshape(H, W), min_dist)
    resp = torch.where(occ > 0, neg, resp)
    # quality gate relative to max response
    resp = torch.where(resp > quality * torch.max(resp), resp, neg)
    # min-dist NMS between new detections: local max over the min_dist window
    nms_r = min_dist // 2
    pooled = max_pool_same(resp, nms_r)
    resp = torch.where(resp >= pooled, resp, neg)
    # top-k via per-tile reduction: two NMS survivors never share an
    # (nms_r x nms_r) tile (except exact ties), so the per-tile max is exact
    # and the global top-k runs over the tile maxima only
    T = max(nms_r, 1)
    Hp = -(-H // T) * T
    Wp = -(-W // T) * T
    resp_p = F.pad(resp, (0, Wp - W, 0, Hp - H), value=-1.0)
    band = resp_p.reshape(Hp // T, T, Wp)
    rmax, rarg = torch.max(band, dim=1)  # row within band
    tile = rmax.reshape(Hp // T, Wp // T, T)
    tmax, carg = torch.max(tile, dim=2)  # col within tile
    gx = torch.arange(Wp // T, device=dev)[None, :] * T + carg
    gy = torch.arange(Hp // T, device=dev)[:, None] * T + torch.gather(rarg, 1, gx)
    k = min(max_pts, tmax.numel())
    # stable descending sort: equal responses keep tile order
    vals, sel = torch.sort(tmax.reshape(-1), descending=True, stable=True)
    vals, sel = vals[:k], sel[:k]
    xy = torch.stack([gx.reshape(-1)[sel].to(img.dtype),
                      gy.reshape(-1)[sel].to(img.dtype)], dim=-1)
    if k < max_pts:
        xy = torch.cat([xy, xy.new_zeros((max_pts - k, 2))])
        vals = torch.cat([vals, vals.new_full((max_pts - k,), -1.0)])
    return xy, vals > 0
