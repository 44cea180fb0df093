"""The visual front end of the port (image ops, camera models, KLT, RANSAC,
tracker, depth association) against vil_fusion_tpu.

Inputs come from numpy with a seed (tests/test_vision.py's textures and
scenes) and go through the JAX function and its counterpart. JAX's threefry
and a torch.Generator cannot agree, so the RANSAC sample indices are computed
with the JAX key the way klt.py does and handed to the port as `sel`.
Tolerances are stated in each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import cameras as jcam
from vil_fusion_tpu.models import depth_association as jda
from vil_fusion_tpu.models import klt as jklt
from vil_fusion_tpu.models import tracker as jtrk
from vil_fusion_tpu.ops import image as jim
from vil_fusion_tpu.ops import linalg as jla
from vil_fusion_tpu.runtime import sim as jsim
from vil_fusion_tpu_torch.models import cameras as tcam
from vil_fusion_tpu_torch.models import depth_association as tda
from vil_fusion_tpu_torch.models import klt as tklt
from vil_fusion_tpu_torch.models import tracker as ttrk
from vil_fusion_tpu_torch.ops import image as tim
from vil_fusion_tpu_torch.ops import linalg as tla
from vil_fusion_tpu_torch.runtime import sim as tsim
from vil_fusion_tpu_torch.utils import state_io

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def smooth_texture(H, W, seed=0, scale=8):
    """tests/test_vision.py's continuous random texture."""
    rng = np.random.default_rng(seed)
    gh, gw = H // scale + 2, W // scale + 2
    grid = rng.random((gh, gw))

    def sample(y, x):
        gy = np.clip(y / scale, 0, gh - 1.001)
        gx = np.clip(x / scale, 0, gw - 1.001)
        y0, x0 = gy.astype(int), gx.astype(int)
        fy, fx = gy - y0, gx - x0
        return (grid[y0, x0] * (1 - fx) * (1 - fy) + grid[y0, x0 + 1] * fx * (1 - fy)
                + grid[y0 + 1, x0] * (1 - fx) * fy + grid[y0 + 1, x0 + 1] * fx * fy)

    return sample


def render(sample, H, W, shift=(0.0, 0.0)):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    return sample(yy + shift[1], xx + shift[0]).astype(np.float32)


IMG = render(smooth_texture(120, 160, seed=3), 120, 160)


# ---------------------------------------------------------------------------
# ops/image.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args,atol", [
    ("sobel", (), 1e-6), ("box_filter", (2,), 1e-5), ("avg_pool2", (), 1e-7),
    ("max_pool_same", (3,), 0.0), ("shi_tomasi_response", (1,), 1e-6),
    ("clahe", (), 2e-5), ("clahe_like", (), 2e-5)])
def test_image_op_matches(name, args, atol):
    """Each stencil / pooling / equalization function against JAX on one
    160 x 120 texture: the same shift-and-add order, so sums agree within
    float32 rounding (atol as given; max pooling exactly; the two CLAHEs
    within 2e-5 of a [0, 1] output, their cumulative sums round differently)."""
    out_j = getattr(jim, name)(jnp.asarray(IMG), *args)
    out_t = getattr(tim, name)(_t(IMG), *args)
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    for a, b in zip(out_j, out_t):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)


def test_bilinear_sample_and_pyramid_match():
    """bilinear_sample (values within 1e-6, in-bounds mask equal, including
    points outside the image) and build_pyramid (4 levels, within 1e-7)."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-5, 170, (300, 2)).astype(np.float32)
    vj, ij = jim.bilinear_sample(jnp.asarray(IMG), jnp.asarray(xy))
    vt, it = tim.bilinear_sample(_t(IMG), _t(xy))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for a, b in zip(jim.build_pyramid(jnp.asarray(IMG), 4), tim.build_pyramid(_t(IMG), 4)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7)


def test_clahe_single_tile_spec():
    """tests/test_vision.py:238's independent numpy evaluation of the CLAHE
    spec on a single tile: atol 2e-3 as there."""
    rng = np.random.default_rng(3)
    img = rng.beta(2.0, 5.0, (64, 64)).astype(np.float32)
    bins, clip_limit = 128, 3.0
    out = tim.clahe(_t(img), grid=1, clip_limit=clip_limit, bins=bins).numpy()
    idx = np.clip((img * bins).astype(int), 0, bins - 1)
    hist = np.bincount(idx.ravel(), minlength=bins).astype(np.float64)
    limit = max(clip_limit * img.size / bins, 1.0)
    hist = np.minimum(hist, limit) + np.maximum(hist - limit, 0.0).sum() / bins
    cdf = np.cumsum(hist)
    lut = (cdf - cdf[0]) / max(cdf[-1] - cdf[0], 1.0)
    bf = np.clip(img * bins - 0.5, 0.0, bins - 1.001)
    b0 = bf.astype(int)
    ref = lut[b0] * (1 - (bf - b0)) + lut[np.minimum(b0 + 1, bins - 1)] * (bf - b0)
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_detect_features_matches():
    """detect_features on test_vision.py:94's texture, without and with
    occupied points: the same positions in the same order and the same
    valid mask (responses agree to rounding, corners are tie-free), and the
    min-distance property holds."""
    H, W = 240, 320
    img = render(smooth_texture(H, W, seed=3), H, W)
    xy_j, v_j = jim.detect_features(jnp.asarray(img), jnp.zeros((8, 2)), jnp.zeros(8, bool),
                                    max_pts=64, min_dist=20)
    xy_t, v_t = tim.detect_features(_t(img), torch.zeros((8, 2)), torch.zeros(8, dtype=torch.bool),
                                    max_pts=64, min_dist=20)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    v = np.asarray(v_j)
    np.testing.assert_array_equal(xy_t.numpy()[v], np.asarray(xy_j)[v])
    pts = xy_t.numpy()[v]
    assert len(pts) > 10
    dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    np.fill_diagonal(dist, 1e9)
    assert dist.min() >= 10 - 1e-3
    occ = pts[:4].astype(np.float32)
    xy2_j, v2_j = jim.detect_features(jnp.asarray(img), jnp.asarray(occ), jnp.ones(4, bool),
                                      max_pts=64, min_dist=20)
    xy2_t, v2_t = tim.detect_features(_t(img), _t(occ), torch.ones(4, dtype=torch.bool),
                                      max_pts=64, min_dist=20)
    np.testing.assert_array_equal(v2_t.numpy(), np.asarray(v2_j))
    np.testing.assert_array_equal(xy2_t.numpy()[np.asarray(v2_j)], np.asarray(xy2_j)[np.asarray(v2_j)])
    d = np.linalg.norm(xy2_t.numpy()[np.asarray(v2_j)][:, None] - occ[None, :], axis=-1)
    assert d.min() > 20 - 1e-3


# ---------------------------------------------------------------------------
# ops/linalg.py additions
# ---------------------------------------------------------------------------

def test_solve3x3_and_inverse_iteration_match():
    """solve3x3 against JAX (rtol 1e-5 on well-conditioned systems) and
    against numpy; smallest_eigvec_inverse_iteration against JAX up to sign
    (atol 1e-4) and against numpy's eigh on matrices with a separated
    smallest eigenvalue (|cos| > 0.9999)."""
    rng = np.random.default_rng(4)
    A = (rng.normal(size=(50, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    x_t = tla.solve3x3(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(x_t, np.asarray(jla.solve3x3(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_t, np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0],
                               rtol=1e-3, atol=1e-4)
    Q = np.linalg.qr(rng.normal(size=(40, 9, 9)))[0]
    lam = np.concatenate([np.full((40, 1), 1e-3), rng.uniform(1.0, 5.0, (40, 8))], 1)
    M = (Q * lam[:, None, :]) @ np.swapaxes(Q, 1, 2)
    M = (0.5 * (M + np.swapaxes(M, 1, 2))).astype(np.float32)
    v_t = tla.smallest_eigvec_inverse_iteration(_t(M)).numpy()
    v_j = np.asarray(jla.smallest_eigvec_inverse_iteration(jnp.asarray(M)))
    sign = np.sign(np.sum(v_t * v_j, -1, keepdims=True))
    np.testing.assert_allclose(v_t * sign, v_j, atol=1e-4)
    assert np.abs(np.sum(v_t * Q[:, :, 0], -1)).min() > 0.9999


# ---------------------------------------------------------------------------
# models/cameras.py
# ---------------------------------------------------------------------------

def _scaramuzza_kw():
    a0, a2 = -200.0, 0.002
    rho = np.linspace(0.5, 300, 400)
    theta = np.arctan2(a0 + a2 * rho * rho, rho)
    coeff = np.polyfit(theta, rho, 8)[::-1]
    return dict(poly=(a0, 0.0, a2), inv_poly=tuple(coeff), c=1.0, d=0.0, e=0.0, xc=400.0, yc=400.0)


CAMS = {
    "pinhole": ("PinholeCamera", dict(fx=460.0, fy=460.0, cx=320.0, cy=240.0, k1=-0.28, k2=0.07,
                                      p1=1e-4, p2=-2e-5), 0.1),
    "mei": ("MeiCamera", dict(xi=1.0, k1=-0.1, k2=0.02, p1=0.0, p2=0.0, gamma1=670.0,
                              gamma2=670.0, u0=320.0, v0=240.0), 0.2),
    "equidistant": ("EquidistantCamera", dict(k2=-0.01, k3=0.003, k4=-0.001, k5=0.0002, mu=300.0,
                                              mv=300.0, u0=320.0, v0=240.0), 0.1),
    "scaramuzza": ("ScaramuzzaCamera", _scaramuzza_kw(), None),
}


@pytest.mark.parametrize("model", list(CAMS))
def test_camera_model_matches_and_round_trips(model):
    """project and lift of each camera model against JAX (pixels within
    2e-3 px, rays within 2e-5; the lifts iterate a fixed count), and
    test_vision.py's round trip project(lift(project(P))) == project(P)
    within its tolerance (scaramuzza: rays within cos > 0.999)."""
    cls, kw, atol_px = CAMS[model]
    cj, ct = getattr(jcam, cls)(**kw), getattr(tcam, cls)(**kw)
    rng = np.random.default_rng(1)
    if model == "scaramuzza":
        pts = rng.normal(size=(100, 3)) * np.array([1.0, 1.0, 0.5])
        pts[:, 2] = np.abs(pts[:, 2]) + 1.0
    else:
        z = rng.uniform(1.0, 20.0, 200)
        pts = np.stack([rng.uniform(-0.7, 0.7, 200) * z, rng.uniform(-0.7, 0.7, 200) * z, z], -1)
    pts = pts.astype(np.float32)
    px_j = np.asarray(jcam.project(cj, jnp.asarray(pts)))
    px_t = tcam.project(ct, _t(pts))
    np.testing.assert_allclose(px_t.numpy(), px_j, atol=2e-3)
    ray_t = tcam.lift(ct, _t(px_j))
    np.testing.assert_allclose(ray_t.numpy(), np.asarray(jcam.lift(cj, jnp.asarray(px_j))),
                               atol=2e-5)
    if atol_px is None:
        d = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        assert float(np.sum(d * ray_t.numpy(), -1).min()) > 0.999
    else:
        np.testing.assert_allclose(tcam.project(ct, ray_t).numpy(), px_j, atol=atol_px)


def test_camera_from_config_matches():
    """from_config builds the same model with the same parameters as the
    JAX package from camodocal-style dictionaries of all four model types,
    and rejects an unknown type."""
    cfgs = [
        dict(model_type="PINHOLE", projection_parameters=dict(fx=718.856, fy=718.856, cx=607.19,
                                                              cy=185.22),
             distortion_parameters=dict(k1=-0.1, k2=0.01, p1=0.0, p2=1e-4)),
        dict(model_type="MEI", mirror_parameters=dict(xi=1.1),
             distortion_parameters=dict(k1=-0.1, k2=0.02, p1=0.0, p2=0.0),
             projection_parameters=dict(gamma1=670.0, gamma2=671.0, u0=320.0, v0=240.0)),
        dict(model_type="KANNALA_BRANDT",
             projection_parameters=dict(k2=-0.01, k3=0.003, k4=-0.001, k5=0.0002, mu=300.0,
                                        mv=301.0, u0=320.0, v0=240.0)),
        dict(model_type="SCARAMUZZA", poly_parameters=dict(p0=-200.0, p1=0.0, p2=0.002),
             inv_poly_parameters=dict(p0=300.0, p1=200.0, p2=10.0),
             affine_parameters=dict(ac=1.0, ad=0.0, ae=0.0, cx=400.0, cy=401.0)),
    ]
    for d in cfgs:
        cj, ct = jcam.from_config(d), tcam.from_config(d)
        assert type(cj).__name__ == type(ct).__name__
        for f in cj._fields:
            np.testing.assert_allclose(np.asarray(getattr(ct, f), np.float64),
                                       np.asarray(getattr(cj, f), np.float64), rtol=1e-7, err_msg=f)
    with pytest.raises((ValueError, KeyError)):
        tcam.from_config(dict(model_type="FISHEYE9"))


# ---------------------------------------------------------------------------
# models/klt.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(iters=10, levels=4, taper=False),
                                dict(region=False), dict(levels=3, win_radius=7)])
def test_klt_matches_and_recovers_shift(kw):
    """track_pyramidal on test_vision.py:114's shifted texture against JAX:
    positions within 0.02 px on every track both sides accept, status equal
    wherever the final residual is not within 1e-3 of its 0.25 threshold
    (every track here), and the known shift recovered (mean flow within
    0.25 px, spread under 1 px)."""
    H, W = 240, 320
    tex = smooth_texture(H, W, seed=4, scale=6)
    shift = (7.3, -4.6)
    img1, img2 = render(tex, H, W), render(tex, H, W, shift=shift)
    xy, valid = jim.detect_features(jnp.asarray(img1), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                                    max_pts=48, min_dist=15)
    p_j, s_j = jklt.track_pyramidal(jnp.asarray(img1), jnp.asarray(img2), xy, valid, **kw)
    p_t, s_t = tklt.track_pyramidal(_t(img1), _t(img2), _t(xy), _t(valid), **kw)
    s_j, s_t = np.asarray(s_j), s_t.numpy()
    np.testing.assert_array_equal(s_t, s_j)
    assert s_t.sum() > 15
    np.testing.assert_allclose(p_t.numpy()[s_t], np.asarray(p_j)[s_t], atol=0.02)
    flow = p_t.numpy()[s_t] - np.asarray(xy)[s_t]
    np.testing.assert_allclose(flow.mean(0), [-shift[0], -shift[1]], atol=0.25)
    assert np.abs(flow - flow.mean(0)).max() < 1.0


def _two_view(seed=5, n=200, n_out=60):
    """tests/test_vision.py:169's two views with 30% gross outliers."""
    rng = np.random.default_rng(seed)
    pts3 = rng.uniform([-5, -5, 4], [5, 5, 20], (n, 3))
    t = np.array([0.5, 0.1, 0.0])
    x1 = (pts3[:, :2] / pts3[:, 2:3]).astype(np.float32)
    p2 = pts3 - t
    x2 = (p2[:, :2] / p2[:, 2:3]).astype(np.float32)
    out_idx = rng.choice(n, n_out, replace=False)
    x2[out_idx] += (rng.uniform(0.05, 0.2, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))).astype(np.float32)
    is_out = np.zeros(n, bool)
    is_out[out_idx] = True
    return x1, x2, is_out


def _jax_sel(key, valid, n_hyp=128):
    """The sample indices as vil_fusion_tpu/models/klt.py:240-242 draws them."""
    u = jax.random.uniform(key, (n_hyp, valid.shape[0]))
    order = jnp.argsort(u - 10.0 * jnp.asarray(valid)[None, :].astype(jnp.float32), axis=1)
    return np.asarray(order[:, :8])


def test_ransac_fundamental_with_injected_samples():
    """ransac_fundamental with the JAX key's sample indices handed to the
    port: inlier masks equal, F equal up to scale and sign, compared as
    K^T F K with K = diag(focal, focal, 1) so that its elements share one
    scale (F lives in virtual pixels; its (2, 2) element is focal^2 times
    less determined than its upper block), unit norm, atol 2e-2: the
    nullspace comes from an f32 Cholesky of A^T A (the condition number
    squared), which determines it to about 1e-2, and the two packages'
    factorizations round differently. Both lie that close to the true
    essential matrix [t]x of the scene, which is the check that this
    tolerance hides no fault. Outliers rejected as in test_vision.py:169."""
    x1, x2, is_out = _two_view()
    valid = np.ones(200, bool)
    valid[:7] = False
    key = jax.random.PRNGKey(0)
    inl_j, F_j = jklt.ransac_fundamental(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key)
    inl_t, F_t = tklt.ransac_fundamental(_t(x1), _t(x2), _t(valid), sel=_t(_jax_sel(key, valid)))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    K = np.diag([460.0, 460.0, 1.0])
    Fj, Ft = K @ np.asarray(F_j, np.float64) @ K, K @ F_t.numpy().astype(np.float64) @ K
    Fj, Ft = Fj / np.linalg.norm(Fj), Ft / np.linalg.norm(Ft)
    np.testing.assert_allclose(Ft * np.sign(np.sum(Ft * Fj)), Fj, atol=2e-2)
    E = np.array([[0.0, 0.0, 0.1], [0.0, 0.0, -0.5], [-0.1, 0.5, 0.0]])  # [t]x, t = (.5, .1, 0)
    E /= np.linalg.norm(E)
    for Fx in (Fj, Ft):
        np.testing.assert_allclose(Fx * np.sign(np.sum(Fx * E)), E, atol=2e-2)
    inl = inl_t.numpy()
    assert not inl[~valid].any()
    assert inl[~is_out & valid].mean() > 0.9 and inl[is_out].mean() < 0.1


def test_ransac_fundamental_with_generator():
    """With its own torch.Generator the port draws other samples than JAX
    but reaches the same verdict (inliers > 0.9 kept, outliers < 0.1
    accepted), reproducibly from the seed; invalid points are never
    sampled while 8 valid ones exist."""
    x1, x2, is_out = _two_view(seed=8)
    valid = np.ones(200, bool)
    valid[::9] = False
    g = torch.Generator().manual_seed(1234)
    inl, F = tklt.ransac_fundamental(_t(x1), _t(x2), _t(valid), generator=g)
    inl2, F2 = tklt.ransac_fundamental(_t(x1), _t(x2), _t(valid),
                                       generator=torch.Generator().manual_seed(1234))
    assert torch.equal(inl, inl2) and torch.equal(F, F2)
    inl = inl.numpy()
    assert inl[~is_out & valid].mean() > 0.9 and inl[is_out].mean() < 0.1
    sel = tklt.ransac_sample(_t(valid), 128, torch.Generator().manual_seed(5))
    assert sel.shape == (128, 8) and _t(valid)[sel].all()


# ---------------------------------------------------------------------------
# models/tracker.py
# ---------------------------------------------------------------------------

def _frame_key(t):
    return jax.random.PRNGKey(int(np.floor(t * 1e3)) & 0x7FFFFFFF)


@pytest.mark.parametrize("mode", ["plain", "ransac", "mask_clahe"])
def test_track_step_three_frames(mode):
    """track_step over 3 frames of a moving texture against JAX (uint8
    images in, RANSAC samples injected from the JAX key): ids, valid masks
    and track counts equal, pixel positions within 0.05 px, normalized
    coordinates within 2e-4, velocities within 5e-3 (0.05 px / 300 px focal
    / 0.1 s, tripled). The carried tracker state crosses packages through
    state_io. `mask_clahe` runs the mask gate with a dynamic-object mask and
    CLAHE."""
    H, W = 240, 320
    tex = smooth_texture(H, W, seed=6, scale=6)
    shifts = [(0.0, 0.0), (3.0, 2.0), (6.5, 3.0)]
    imgs = [np.clip(render(tex, H, W, shift=s) * 255.0, 0, 255).astype(np.uint8) for s in shifts]
    kw = dict(max_cnt=60, min_dist=20, cap=128, ransac=mode != "plain",
              mask_gate=mode == "mask_clahe", use_clahe=mode == "mask_clahe")
    cam_kw = dict(fx=300.0, fy=300.0, cx=W / 2, cy=H / 2)
    cj, ct = jcam.PinholeCamera(**cam_kw), tcam.PinholeCamera(**cam_kw)
    jcfg, tcfg = jtrk.TrackerConfig(**kw), ttrk.TrackerConfig(**kw)
    sj = jtrk.init_tracker(H, W, jcfg)
    st = ttrk.init_tracker(H, W, tcfg, device="cpu")
    dyn = np.zeros((H, W), bool)
    dyn[60:140, 200:300] = True
    n_seen = 0
    for k, img in enumerate(imgs):
        t = 0.1 * (k + 1)
        key = _frame_key(t)
        mask_j = jnp.asarray(dyn) if mode == "mask_clahe" else None
        mask_t = _t(dyn) if mode == "mask_clahe" else None
        und_prev = jtrk._undistort(cj, sj.xy)
        sj_prev = sj
        sj, oj = jtrk.track_step(sj, jnp.asarray(img), jnp.float32(t), cj, jcfg, dyn_mask=mask_j,
                                 key=key)
        # the RANSAC's valid mask is internal to track_step; recompute it as
        # tracker.py does to draw the same samples
        sel = None
        if kw["ransac"] and k > 0:
            sel = _ransac_sel(sj_prev, img, cj, jcfg, mask_j, key)
        st, ot = ttrk.track_step(st, _t(img), t, ct, tcfg, dyn_mask=mask_t, sel=sel,
                                 initialized=k > 0)
        for name in ("ids", "valid", "track_cnt"):
            np.testing.assert_array_equal(ot[name].numpy(), np.asarray(oj[name]), err_msg=name)
        v = np.asarray(oj["valid"])
        np.testing.assert_allclose(ot["uv"].numpy()[v], np.asarray(oj["uv"])[v], atol=0.05)
        np.testing.assert_allclose(ot["xy"].numpy()[v], np.asarray(oj["xy"])[v], atol=2e-4)
        np.testing.assert_allclose(ot["vel"].numpy()[v], np.asarray(oj["vel"])[v], atol=5e-3)
        n_seen = max(n_seen, int((np.asarray(oj["track_cnt"])[v] > 1).sum()))
        assert int(st.next_id) == int(sj.next_id) and bool(st.initialized)
        del und_prev
    assert n_seen > 20  # tracks really survived across frames
    if mode == "mask_clahe":
        uv = ot["uv"].numpy()[ot["valid"].numpy()].astype(int)
        assert not dyn[uv[:, 1], uv[:, 0]].any()
    # the state crosses packages: JAX state -> port tensors, field by field
    back = state_io.to_torch(ttrk.TrackerState, state_io.to_numpy(sj), "cpu")
    for f in ("ids", "valid", "track_cnt", "next_id", "initialized"):
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    np.testing.assert_allclose(back.prev_img.numpy(), st.prev_img.numpy(), atol=2e-5)


def _ransac_sel(state, img, cam, cfg, dyn_mask, key):
    """The (n_hyp, 8) indices the JAX track_step draws in this frame: its
    fit mask (tracked & in border & on clean background) recomputed with the
    JAX package's own functions, then klt.py's biased permutation."""
    imgf = jnp.asarray(img).astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    img_p = jim.clahe(imgf) if cfg.use_clahe else imgf
    pts2, status = jklt.track_pyramidal(state.prev_img, img_p, state.xy, state.valid)
    tracked = status & state.valid
    H, W = imgf.shape
    if cfg.mask_gate and dyn_mask is not None:
        er = 1.0 - jim.max_pool_same(dyn_mask.astype(jnp.float32), 5)
        on_clean = jim.bilinear_sample(er, pts2)[0] > 0.5
    else:
        on_clean = jnp.ones((cfg.cap,), bool)
    inb = ((pts2[:, 0] >= 1) & (pts2[:, 0] < W - 2) & (pts2[:, 1] >= 1) & (pts2[:, 1] < H - 2))
    return _t(_jax_sel(key, np.asarray(tracked & inb & on_clean)))


def test_render_camera_image_is_identical():
    """The port's copy of render_camera_image (numpy path) gives the same
    image, bit for bit, as the JAX package's, with sky and textured
    surfaces both present."""
    traj = jsim.Trajectory(jsim.TrajectoryConfig(speed=8.0))
    R_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    R, p = traj.rotation(1.0) @ R_bc, traj.position(1.0) + np.array([0, 0, 1.5])
    args = (R, p, 100.0, 100.0, 80.0, 60.0, 120, 160)
    a = jsim.render_camera_image(jsim.RaycastScene(), *args)
    b = tsim.render_camera_image(tsim.RaycastScene(), *args)
    np.testing.assert_array_equal(b, a)
    assert b.shape == (120, 160) and b.dtype == np.float32
    assert (b == np.float32(tsim.SKY_VALUE)).any() and b.std() > 0.02


# ---------------------------------------------------------------------------
# models/depth_association.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_incidence", [None, 0.5])
def test_feature_depth_matches(min_incidence):
    """feature_depth on test_vision.py:216's plane at z = 10 plus a steep
    ground plane (so both strong and weak depths occur): ok masks equal,
    signed depths within 1e-4 m of JAX, plane depth within 0.2 m, far rays
    never beyond the NN band."""
    rng = np.random.default_rng(7)
    m = 2000
    wall = np.stack([rng.uniform(-6, 6, m), rng.uniform(-4, 1.2, m), np.full(m, 10.0)], -1)
    gx, gz = rng.uniform(-6, 6, m), rng.uniform(3, 10, m)
    ground = np.stack([gx, np.full(m, 1.5), gz], -1)
    cloud = np.concatenate([wall, ground]).astype(np.float32)
    cv = rng.random(2 * m) > 0.05
    feats = np.concatenate([rng.uniform(-0.3, 0.3, (20, 2)) * [1, 0.3],
                            np.stack([rng.uniform(-0.3, 0.3, 12), rng.uniform(0.2, 0.4, 12)], -1),
                            np.full((4, 2), 5.0)]).astype(np.float32)
    fv = np.ones(len(feats), bool)
    fv[3] = False
    d_j, ok_j = jda.feature_depth(jnp.asarray(feats), jnp.asarray(fv), jnp.asarray(cloud),
                                  jnp.asarray(cv), min_incidence=min_incidence)
    d_t, ok_t = tda.feature_depth(_t(feats), _t(fv), _t(cloud), _t(cv), min_incidence=min_incidence)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    ok = ok_t.numpy()
    assert ok[:20].sum() >= 17 and not ok[3]
    np.testing.assert_allclose(np.abs(d_t.numpy()[:20][ok[:20]]), 10.0, atol=0.2)
    assert (d_t.numpy()[~ok] == -1.0).all() and np.abs(d_t.numpy()).max() <= 15.0
    if min_incidence is not None:
        assert (d_t.numpy()[ok] < -2.0).any() and (d_t.numpy()[ok] > 2.0).any()
