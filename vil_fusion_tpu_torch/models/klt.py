"""Pyramidal Lucas-Kanade tracking + batched RANSAC fundamental matrix.

Port of vil_fusion_tpu/models/klt.py (the reference tracker's
cv::calcOpticalFlowPyrLK(21x21, 3 levels) and rejectWithF). The reference
vmaps a per-feature solver; here every step carries the feature axis
explicitly: patches are (N, S, S) gathers, the refinement levels' window
sampling is a batched `Wy @ R @ Wx^T` (float32 matmuls, no TF32), and the
Newton steps are 2x2 closed forms over the batch. Fixed pyramid levels and
iteration counts; RANSAC is a fixed batch of hypotheses + argmax.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vil_fusion_tpu_torch.ops import image as im
from vil_fusion_tpu_torch.ops import linalg as fast_linalg


def _patches(stack_padded, centers, size: int, pad: int):
    """(N, C, size, size) bilinear patches of a (C, Hp, Wp) channel stack
    centred at fractional `centers` (N, 2), given in UNPADDED image
    coordinates: one (size+1)^2 integer gather per feature + a 4-tap mix.

    The stack is edge-padded by `pad` >= size//2 + 1 so the gather never
    clamps (clamping would misalign template and current patches near the
    borders of coarse levels)."""
    r = size // 2
    tl = centers - r + pad  # top-left (x, y) in padded coords
    tl_i = torch.floor(tl)
    fx = (tl[:, 0] - tl_i[:, 0])[:, None, None, None]
    fy = (tl[:, 1] - tl_i[:, 1])[:, None, None, None]
    y0 = torch.clamp(tl_i[:, 1].to(torch.int64), 0, stack_padded.shape[1] - size - 1)
    x0 = torch.clamp(tl_i[:, 0].to(torch.int64), 0, stack_padded.shape[2] - size - 1)
    ar = torch.arange(size + 1, device=centers.device)
    rows = (y0[:, None] + ar)[:, :, None]  # (N, size+1, 1)
    cols = (x0[:, None] + ar)[:, None, :]  # (N, 1, size+1)
    raw = stack_padded[:, rows, cols].permute(1, 0, 2, 3)  # (N, C, size+1, size+1)
    return ((1 - fx) * (1 - fy) * raw[:, :, :size, :size]
            + fx * (1 - fy) * raw[:, :, :size, 1:]
            + (1 - fx) * fy * raw[:, :, 1:, :size]
            + fx * fy * raw[:, :, 1:, 1:])


def _epad(a, pad: int):
    return F.pad(a[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def track_pyramidal(img1, img2, pts, valid, win_radius: int = 10, iters: int = 10,
                    levels: int = 4, taper: bool = True, region: bool = True):
    """Track pts (N, 2) from img1 to img2. Returns (new_pts (N, 2), status (N,)).

    `iters` is the budget at the COARSEST level; with `taper` (deployed
    default) finer levels run a tapering count. The coarsest level gathers
    the current patch from the image every iteration; with `region` the
    refinement levels gather one (S + 2M + 1)^2 region per feature and
    sample the window from it by interpolation matmuls, the residual motion
    clamped to the margin M (a track that needs more fails the final
    appearance check instead of diverging). `taper=False` runs the full
    budget at every level."""
    dtype = img1.dtype
    dev = img1.device
    pyr1 = im.build_pyramid(img1, levels)
    pyr2 = im.build_pyramid(img2, levels)
    grads1 = [im.sobel(p) for p in pyr1]

    S = 2 * win_radius + 1
    M = 5
    SR = S + 2 * M + 1  # region side (= 32 at the default win_radius 10)
    PAD = win_radius + M + 2
    guess = pts / (2.0 ** (levels - 1))

    dgrid = torch.arange(S, dtype=dtype, device=dev) - win_radius
    sgrid = torch.arange(S, dtype=dtype, device=dev)
    rgrid = torch.arange(SR, dtype=dtype, device=dev)
    g_ok = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)

    for lvl in range(levels - 1, -1, -1):
        # taper: full budget at the coarsest level, >= 4 at the finest
        lvl_iters = (max(iters - 2 * (levels - 1 - lvl), min(iters, 4))
                     if taper else iters)
        p1_l = pts / (2.0 ** lvl)
        Hl, Wl = pyr1[lvl].shape  # unpadded level dims for in-bounds masks
        tpl_stack = torch.stack([_epad(pyr1[lvl], PAD), _epad(grads1[lvl][0], PAD),
                                 _epad(grads1[lvl][1], PAD)])
        i2 = _epad(pyr2[lvl], PAD)

        def wmask(p):
            # separable in-bounds weights: padded content must NOT enter the
            # normal equations (replicated edges are fabricated data)
            px = p[:, 0:1] + dgrid
            py = p[:, 1:2] + dgrid
            wx = ((px >= 0) & (px <= Wl - 1.001)).to(dtype)
            wy = ((py >= 0) & (py <= Hl - 1.001)).to(dtype)
            return wy[:, :, None] * wx[:, None, :]

        tpl = _patches(tpl_stack, p1_l, S, PAD)
        t, gx, gy = tpl[:, 0], tpl[:, 1], tpl[:, 2]
        w = wmask(p1_l)
        gxx = torch.sum(w * gx * gx, dim=(1, 2))
        gxy = torch.sum(w * gx * gy, dim=(1, 2))
        gyy = torch.sum(w * gy * gy, dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        g_ok = det > 1e-8
        inv = torch.where(g_ok, 1.0 / torch.clamp(det, min=1e-8), torch.zeros_like(det))

        def newton(cur, wm2):
            e = (t - cur) * w * wm2
            bx = torch.sum(gx * e, dim=(1, 2))
            by = torch.sum(gy * e, dim=(1, 2))
            dx = inv * (gyy * bx - gxy * by)
            dy = inv * (-gxy * bx + gxx * by)
            return torch.stack([dx, dy], dim=-1)

        p2 = guess
        if lvl == levels - 1 or not region:
            # coarsest level: the initial displacement is unbounded, so the
            # current patch is re-gathered from the image every iteration
            for _ in range(lvl_iters):
                cur = _patches(i2[None], p2, S, PAD)[:, 0]
                p2 = p2 + newton(cur, wmask(p2))
        else:
            # refinement levels: ONE region gather per feature, then every
            # Newton iteration samples the window as Wy @ R @ Wx^T with
            # banded (S, SR) bilinear weights
            tl = torch.floor(guess - win_radius - M)  # region top-left (x, y)
            ry = torch.clamp(tl[:, 1].to(torch.int64) + PAD, 0, i2.shape[0] - SR - 1)
            rx = torch.clamp(tl[:, 0].to(torch.int64) + PAD, 0, i2.shape[1] - SR - 1)
            ar = torch.arange(SR, device=dev)
            R = i2[(ry[:, None] + ar)[:, :, None], (rx[:, None] + ar)[:, None, :]]
            anchor = torch.stack([(rx - PAD).to(dtype), (ry - PAD).to(dtype)], dim=-1)
            for _ in range(lvl_iters):
                off = torch.clamp(p2 - win_radius - anchor, 0.0, 2.0 * M + 0.999)
                Wx = torch.clamp(1.0 - torch.abs(
                    rgrid[None, None, :] - (off[:, 0, None, None] + sgrid[None, :, None])),
                    min=0.0)
                Wy = torch.clamp(1.0 - torch.abs(
                    rgrid[None, None, :] - (off[:, 1, None, None] + sgrid[None, :, None])),
                    min=0.0)
                cur = Wy @ R @ Wx.mT
                p2c = anchor + off + win_radius  # clamped effective position
                p2 = p2 + newton(cur, wmask(p2c))
        guess = p2
        if lvl > 0:
            guess = guess * 2.0

    H, W = img1.shape
    inb = ((guess[:, 0] >= 1) & (guess[:, 0] < W - 1)
           & (guess[:, 1] >= 1) & (guess[:, 1] < H - 1))

    # final appearance check: mean abs residual over the window
    tp = _patches(_epad(pyr1[0], PAD)[None], pts, S, PAD)[:, 0]
    cp = _patches(_epad(pyr2[0], PAD)[None], guess, S, PAD)[:, 0]
    res = torch.mean(torch.abs(tp - cp), dim=(1, 2))
    status = valid & g_ok & inb & (res < 0.25)
    return guess, status


N_HYP = 128  # hypotheses of the tracker's RANSAC (the reference's n_hyp)


def ransac_uniforms(n: int, n_hyp: int = N_HYP, generator=None, device=None):
    """The RANSAC's draw: (n_hyp, n) uniform numbers in [0, 1) from
    `generator` (a torch.Generator on `device`, or the global generator),
    as the reference draws jax.random.uniform(key, (n_hyp, N)). Made outside
    a captured step and passed in (a graph cannot hold the generator)."""
    return torch.rand((n_hyp, n), generator=generator, device=device)


def ransac_sample(valid, n_hyp: int, generator=None, u=None):
    """(n_hyp, 8) sample indices: biased random permutations, valid points
    first, from the uniforms `u` (n_hyp, N) or, when None, a draw of
    `ransac_uniforms` from `generator`."""
    if u is None:
        u = ransac_uniforms(valid.shape[0], n_hyp, generator, valid.device)
    order = torch.argsort(u - 10.0 * valid[None, :].to(u.dtype), dim=1)
    return order[:, :8]


def ransac_fundamental(x1, x2, valid, generator=None, sel=None, n_hyp: int = N_HYP,
                       thresh_px: float = 1.0, focal: float = 460.0, u=None):
    """Batched 8-point RANSAC on normalized-plane coordinates x1, x2 (N, 2);
    returns (inlier_mask (N,), best_F (3, 3)). Fixed hypothesis count +
    argmax instead of adaptive early exit.

    The samples come from the uniforms `u` or from `generator` (see
    ransac_sample) unless `sel` (n_hyp, 8) gives them: the reference draws
    with another generator, so a comparison against it hands both the same
    uniforms or indices."""
    N = x1.shape[0]
    dtype = x1.dtype
    dev = x1.device
    # virtual pinhole pixels (translation drops out of F estimation)
    p1 = x1 * focal
    p2 = x2 * focal
    if sel is None:
        sel = ransac_sample(valid, n_hyp, generator, u)
    a1 = p1[sel]  # (B, 8, 2)
    a2 = p2[sel]

    def hartley(p):
        c = p.mean(dim=1, keepdim=True)
        s = math.sqrt(2.0) / (torch.linalg.norm(p - c, dim=-1).mean(dim=1, keepdim=True) + 1e-9)
        return (p - c) * s[..., None], c[:, 0], s[:, 0]

    n1, c1, s1 = hartley(a1)
    n2, c2, s2 = hartley(a2)

    x1_, y1_ = n1[..., 0], n1[..., 1]
    x2_, y2_ = n2[..., 0], n2[..., 1]
    A = torch.stack([x2_ * x1_, x2_ * y1_, x2_, y2_ * x1_, y2_ * y1_, y2_,
                     x1_, y1_, torch.ones_like(x1_)], dim=-1)  # (B, 8, 9)
    AtA = torch.einsum("bri,brj->bij", A, A)
    # nullspace via Cholesky inverse iteration
    f = fast_linalg.smallest_eigvec_inverse_iteration(AtA)
    Fn = f.reshape(-1, 3, 3)
    # rank-2 projection without SVD: v3 = smallest right-singular vector
    # (smallest eigenvector of F^T F, closed form), F2 = F (I - v3 v3^T)
    _, v3 = fast_linalg.sym3x3_smallest(torch.einsum("bki,bkj->bij", Fn, Fn))
    Fn = Fn - torch.einsum("bij,bj,bk->bik", Fn, v3, v3)

    # denormalize: F = T2^T Fn T1  with T = [[s,0,-s cx],[0,s,-s cy],[0,0,1]]
    def make_T(c, s):
        T = torch.zeros((c.shape[0], 3, 3), dtype=dtype, device=dev)
        T[:, 0, 0] = s
        T[:, 1, 1] = s
        T[:, 2, 2] = 1.0
        T[:, 0, 2] = -s * c[:, 0]
        T[:, 1, 2] = -s * c[:, 1]
        return T

    Fm = make_T(c2, s2).mT @ Fn @ make_T(c1, s1)  # (B, 3, 3)

    # Sampson distance of ALL points under each hypothesis
    one = torch.ones((N, 1), dtype=dtype, device=dev)
    ph1 = torch.cat([p1, one], dim=-1)  # (N, 3)
    ph2 = torch.cat([p2, one], dim=-1)
    Fx1 = torch.einsum("bij,nj->bni", Fm, ph1)
    Ftx2 = torch.einsum("bji,nj->bni", Fm, ph2)
    num = torch.einsum("ni,bni->bn", ph2, Fx1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    d2 = num / torch.clamp(den, min=1e-12)  # (B, N)
    inl = (d2 < thresh_px ** 2) & valid[None, :]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts).reshape(1)  # the first of equal counts
    # a gather (indexing by a 0-d tensor would read it on the host)
    return inl.index_select(0, best)[0], Fm.index_select(0, best)[0]
