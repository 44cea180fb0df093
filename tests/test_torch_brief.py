"""models/brief.py of the port against vil_fusion_tpu's: BRIEF descriptors,
Hamming distances, matching, LSH words and word histograms bit for bit
(the port evaluates its samples with the reference's roundings,
brief._sample), BoW scores within rtol 1e-6.

Inputs are numpy from a seed: textures of tests/test_torch_vision.py and a
raycast image of the simulator (flat surfaces, where a < b turns on the
last bit of the interpolation), with corners from the reference's
detector plus random keypoints inside and outside the image.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.models import brief as jb
from vil_fusion_tpu.ops import image as jim
from vil_fusion_tpu.runtime import sim as jsim
from vil_fusion_tpu_torch.models import brief as tb

from test_torch_vision import render, smooth_texture

torch.set_num_threads(2)
H, W = 120, 160
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def _t(x):
    return torch.from_numpy(np.array(x))


def _image(kind, seed):
    if kind == "texture":
        return render(smooth_texture(H, W, seed=seed, scale=6), H, W) * 255.0
    c, s = np.cos(0.3 * seed), np.sin(0.3 * seed)
    R_wb = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return jsim.render_camera_image(jsim.RaycastScene(), R_wb @ R_BC,
                                    np.array([3.0 + seed, 0.5, 1.5]), 100.0, 100.0,
                                    W / 2, H / 2, H, W).astype(np.float32)


def _keypoints(img, seed, n_rand=48):
    xy, val = jim.detect_features(jnp.asarray(img), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                                  max_pts=128, min_dist=8)
    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.asarray(xy),
                          rng.uniform([-5, -5], [W + 5, H + 5], (n_rand, 2)).astype(np.float32)])
    valid = np.concatenate([np.asarray(val), rng.random(n_rand) > 0.2])
    return pts, valid


@pytest.fixture(scope="module")
def descs():
    """(image kind, seed) -> (JAX descriptors, port descriptors, validity)."""
    out = {}
    for kind, seed in (("texture", 0), ("texture", 1), ("raycast", 0), ("raycast", 2)):
        img = _image(kind, seed)
        pts, valid = _keypoints(img, seed)
        dj = np.asarray(jb.brief_descriptors(jnp.asarray(img), jnp.asarray(pts),
                                             jnp.asarray(valid)))
        dt = tb.brief_descriptors(torch.from_numpy(img), torch.from_numpy(pts),
                                  torch.from_numpy(valid)).numpy()
        out[kind, seed] = dj, dt, valid
    return out


def test_pattern_and_word_tables_are_the_reference_constants():
    np.testing.assert_array_equal(tb._PATTERN_NP, jb._PATTERN_NP)
    np.testing.assert_array_equal(tb._WORD_SEL_NP, jb._WORD_SEL_NP)
    assert (tb.N_WORDS, tb.N_BITS) == (jb.N_WORDS, jb.N_BITS)


@pytest.mark.parametrize("key", [("texture", 0), ("texture", 1), ("raycast", 0), ("raycast", 2)])
def test_descriptors_bit_equal(descs, key):
    """Every 32-bit lane equal, negative lanes (bit 31 set) included."""
    dj, dt, valid = descs[key]
    assert dt.dtype == np.int32 and dt.shape == dj.shape
    np.testing.assert_array_equal(dt, dj)
    assert (dj < 0).any() and (dj[~valid] == 0).all()


def test_hamming_match_words_histogram_bit_equal(descs):
    """hamming_matrix, match (idx, ok), words_of and word_histogram equal,
    between two images' descriptors and between shuffled copies (exact
    Hamming ties: argmin keeps the lower index); bow_scores within rtol
    1e-6."""
    (a, _, va), (b, _, vb) = descs["raycast", 0], descs["texture", 1]
    rng = np.random.default_rng(5)
    perm = rng.permutation(len(a))
    cases = [(a, va, b, vb), (a, va, a[perm], va[perm]), (b, vb, np.concatenate([b, b]),
                                                          np.concatenate([vb, vb]))]
    for x, vx, y, vy in cases:
        hj = np.asarray(jb.hamming_matrix(jnp.asarray(x), jnp.asarray(y)))
        ht = tb.hamming_matrix(_t(x), _t(y)).numpy()
        np.testing.assert_array_equal(ht, hj)
        ij, okj = jb.match(jnp.asarray(x), jnp.asarray(vx), jnp.asarray(y), jnp.asarray(vy))
        it, okt = tb.match(_t(x), _t(vx), _t(y), _t(vy))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    hists_j, hists_t = [], []
    for dj, _, v in descs.values():
        wj = np.asarray(jb.words_of(jnp.asarray(dj)))
        wt = tb.words_of(_t(dj))
        np.testing.assert_array_equal(wt.numpy(), wj)
        hists_j.append(jb.word_histogram(jnp.asarray(wj), jnp.asarray(v)))
        hists_t.append(tb.word_histogram(wt, _t(v)))
        np.testing.assert_array_equal(hists_t[-1].numpy(), np.asarray(hists_j[-1]))
    sj = np.asarray(jb.bow_scores(hists_j[0], jnp.stack(hists_j)))
    st = tb.bow_scores(hists_t[0], torch.stack(hists_t)).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-6)
    assert st[0] == pytest.approx(1.0, abs=1e-6) and (st[1:] < 0.9).all()


def test_popcount_and_single_bit_flip():
    """tests/test_visual_loop.py's Hamming checks on the port: distance 0 to
    itself, 1 after one flipped bit, in any lane including the sign bit."""
    rng = np.random.default_rng(2)
    a = rng.integers(-(2**31), 2**31 - 1, (10, 8), dtype=np.int32)
    d = tb.hamming_matrix(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert (np.diagonal(d) == 0).all()
    for lane, bit in ((0, 0), (3, 17), (7, 31)):
        b = a.copy()
        b[0, lane] ^= np.int32(-(2**31)) if bit == 31 else np.int32(1 << bit)
        assert tb.hamming_matrix(torch.from_numpy(a[:1]), torch.from_numpy(b[:1])).item() == 1
