"""Binary descriptors: BRIEF extraction, Hamming matching, bag-of-words scoring.

Port of vil_fusion_tpu/models/brief.py (the reference's place-recognition
primitives: BRIEF from a fixed random pattern, brute-force Hamming matching
with the < 80 gate and a ratio test, and random bit-sampling LSH words with
cosine scoring over dense word histograms in place of DBoW2's vocabulary).

Descriptors are (n, 8) int32 lanes of 32 comparison bits each. The
reference packs and shifts them as uint32, whose arithmetic torch supports
only in part, so this port computes on int64 masked to 32 bits and wraps
to int32 explicitly. With the samples rounded as the reference's compiled
program rounds them (`_sample`), descriptors, Hamming distances, word ids
and matches are bit for bit the reference's on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from vil_fusion_tpu_torch.ops import image as im

N_BITS = 256
# multi-table bit-sampling LSH: T tables of B raw descriptor bits each
N_TABLES = 4
BITS_PER_TABLE = 12
N_WORDS = N_TABLES << BITS_PER_TABLE  # 16384 histogram bins
_PATTERN_SEED = 7
_MASK32 = 0xFFFFFFFF


def _brief_pattern(dtype=np.float32):
    """Fixed 256-pair sampling pattern within a 31x31 patch (isotropic
    gaussian, like the classic BRIEF pattern file): the reference's numpy
    constant, seed 7."""
    rng = np.random.default_rng(_PATTERN_SEED)
    return np.clip(rng.normal(0, 6.5, (N_BITS, 2, 2)), -15, 15).astype(dtype)


_PATTERN_NP = _brief_pattern()


def _word_projection():
    """Per-table random bit positions (seed 11): table t's word is the B raw
    descriptor bits at these positions (bit-sampling LSH)."""
    rng = np.random.default_rng(11)
    return rng.choice(N_BITS, size=(N_TABLES, BITS_PER_TABLE), replace=False).astype(np.int32)


_WORD_SEL_NP = _word_projection()


def _to_int32(v):
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _lanes(desc):
    """(..., 8) int32 descriptors -> int64 lanes holding the unsigned bits."""
    return desc.to(torch.int64) & _MASK32


def _fma(a, b, c):
    """float32 a * b + c rounded once: the float64 product of two float32
    values is exact."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _sample(img, xy):
    """im.bilinear_sample's value as the reference's compiled program
    evaluates it: the interpolation's last three products contracted into
    fused multiply-adds (XLA does so when it fuses the descriptor program).
    A comparison a < b between two samples of a flat region turns on the
    last bit, so descriptors are bit for bit the reference's only with the
    same roundings."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    ofx, ofy = 1 - fx, 1 - fy
    s = _fma(img[y0, x0] * ofx, ofy, img[y0, x0 + 1] * fx * ofy)
    s = _fma(img[y0 + 1, x0] * ofx, fy, s)
    return _fma(img[y0 + 1, x0 + 1] * fx, fy, s)


def brief_descriptors(img, xy, valid):
    """(H, W) float image, (N, 2) keypoints, (N,) validity -> (N, 8) int32
    packed BRIEF (bit j of lane l: pair 32 l + j compares a < b) on the box
    filtered image; invalid rows are 0."""
    # the reference's program divides by 25 as a product with the float32
    # reciprocal
    sm = im.box_filter(img, 2) * float(np.float32(1.0) / np.float32(25.0))
    pat = torch.as_tensor(_PATTERN_NP, device=img.device)  # (256, 2, 2)
    a = _sample(sm, xy[:, None, :] + pat[None, :, 0, :])
    b = _sample(sm, xy[:, None, :] + pat[None, :, 1, :])
    bits = (a < b).to(torch.int64).reshape(-1, 8, 32)
    weights = torch.ones(32, dtype=torch.int64, device=img.device) << torch.arange(
        32, device=img.device)
    desc = _to_int32((bits * weights).sum(dim=-1))
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def _popcount32(x):
    """Set bits of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK32) >> 24


def hamming_matrix(a, b):
    """(N, 8) x (M, 8) int32 -> (N, M) int32 Hamming distances."""
    x = _lanes(a)[:, None, :] ^ _lanes(b)[None, :, :]
    return _popcount32(x).sum(dim=-1).to(torch.int32)


def match(desc_a, valid_a, desc_b, valid_b, max_dist: int = 80, ratio: float = 0.9):
    """Best match per row with the reference's Hamming < 80 gate plus its
    ratio test against the second-best match (best < ratio * second).
    Returns (idx (N,) int64, ok (N,) bool); ties go to the lower index."""
    d = hamming_matrix(desc_a, desc_b)
    big = torch.full_like(d, 10_000)
    d = torch.where(valid_b[None, :], d, big)
    idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    d_wo = d.scatter(1, idx[:, None], 10_000)
    second = torch.min(d_wo, dim=1).values
    ok = valid_a & (best < max_dist) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return idx, ok


# ---------------------------------------------------------------------------
# LSH bag-of-words (DBoW2 replacement)
# ---------------------------------------------------------------------------

def words_of(desc):
    """(N, 8) packed descriptors -> (N, T) int32 word ids, table t's ids
    offset into [t << B, (t + 1) << B) so one histogram holds all tables."""
    dev = desc.device
    bit_idx = torch.arange(N_BITS, device=dev)
    bits = (_lanes(desc)[:, bit_idx // 32] >> (bit_idx % 32)) & 1  # (N, 256)
    group = bits[:, torch.as_tensor(_WORD_SEL_NP, dtype=torch.int64, device=dev)]  # (N, T, B)
    weights = torch.ones(BITS_PER_TABLE, dtype=torch.int64, device=dev) << torch.arange(
        BITS_PER_TABLE, device=dev)
    w = (group * weights).sum(dim=-1)
    offs = torch.arange(N_TABLES, dtype=torch.int64, device=dev) << BITS_PER_TABLE
    return (w + offs[None, :]).to(torch.int32)


def word_histogram(words, valid):
    """(N, T) word ids -> (N_WORDS,) L2-normalized float32 histogram over all
    tables."""
    wflat = torch.where(valid[:, None], words, N_WORDS - 1).reshape(-1).to(torch.int64)
    h = torch.zeros(N_WORDS, dtype=torch.float32, device=words.device).index_add_(
        0, wflat, valid[:, None].expand(words.shape).reshape(-1).to(torch.float32))
    return h / torch.clamp(torch.linalg.norm(h), min=1e-6)


def bow_scores(query_hist, db_hists):
    """Cosine similarity against the whole database: the inverted-file
    query (TemplatedDatabase.h) collapsed into one matrix-vector product."""
    return db_hists @ query_hist
