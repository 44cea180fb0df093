"""The launch plan of the dense CUDA kNN kernels (K1 grouped, K2 exact) and
the rule by which they split the database and merge, on the CPU.

`knn_cuda.plan` is a pure function of (nq, nd, k, SM count, kernel), so its
invariants are checked here without a card. The kernels themselves run only
on a card (tests/test_torch_cuda.py). What the split rests on is pinned down
here on seeded clouds with exact ties: the top-k of every chunk of the plan
(K1: of the top-2 of its whole 128-column groups), merged pairwise in
ascending order with ties to the lower index, is the unsplit result; it is
ops/knn.py's `knn` / `knn_grouped` distance for distance, and the reference
package's Pallas kernels (interpret mode) give the same distances. Also
here: the lower bound the kernels scan with never exceeds the exact
distance of either form.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vil_fusion_tpu.ops.pallas.knn_pallas import knn_pallas

from vil_fusion_tpu_torch.ops import knn as knn_plain
from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

H100_SMS = 132
MAIN_SHAPES = [
    (8192, 32768, 5),  # surf association
    (2048, 16384, 5),  # edge association
    (2048, 51200, 1),  # ICP
    (192, 115200, 3),  # depth association
    (8192, 131072, 5),  # surf, 4x map
    (2048, 65536, 5),  # edge, 4x map
]
RAGGED = [(nq, nd, k) for nq in (1, 127, 129, 192) for nd in (1, 130, 115200) for k in (1, 8)]


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("sm_count", [H100_SMS, 108])
@pytest.mark.parametrize("nq,nd,k", MAIN_SHAPES + RAGGED + [(300, 1000, 8), (77, 130, 3),
                                                            (115200, 130, 5)])
def test_plan_invariants(nq, nd, k, sm_count, grouped):
    """Chunks are whole 128-column groups that cover the database with none
    empty, the split asks for no more chunks than 8 blocks an SM need and
    keeps the least chunk length of the kernel, a merge is launched exactly
    when the database is split, and the grid fills the card where the shape
    has the work for it."""
    p = kc.plan(nq, nd, k, sm_count, grouped)
    groups = max(1, -(-nd // 128))
    least = kc.min_chunk_groups(k, grouped)
    assert p.chunk % 128 == 0 and p.chunk > 0
    assert p.n_split * p.chunk >= nd
    assert (p.n_split - 1) * p.chunk < max(nd, 1)  # no empty chunk
    q_blocks = max(1, -(-nq // 128))
    assert 1 <= p.n_split <= -(-kc._BLOCKS_PER_SM * sm_count // q_blocks)
    assert p.n_split == 1 or p.chunk // 128 >= least
    assert p.merge == (p.n_split > 1)
    if -(-nq // 128) * (groups // least) >= sm_count:
        assert -(-nq // 128) * p.n_split >= sm_count


def test_plan_main_shapes_on_h100():
    """The plan at the main paths' shapes on 132 SMs: every one splits the
    database and fills the card; the depth call (192 queries, K2) is held to
    chunks of two groups, not to one chunk a group; K1 gets chunks of at
    least four groups at k = 5 (three to fill its list); a tiny problem is
    one kernel, no merge."""
    for nq, nd, k in MAIN_SHAPES:
        for grouped in (True, False):
            p = kc.plan(nq, nd, k, H100_SMS, grouped)
            assert p.merge and -(-nq // 128) * p.n_split >= H100_SMS
    depth = kc.plan(192, 115200, 3, H100_SMS)
    assert depth.n_split <= 450 < 900 and depth.chunk >= 256
    assert kc.min_chunk_groups(5, True) == 4 and kc.min_chunk_groups(5, False) == 2
    assert kc.plan(2048, 16384, 5, H100_SMS, True).chunk >= 512
    assert kc.plan(77, 130, 3, H100_SMS) == kc.Plan(1, 256, False)
    assert kc.plan(0, 0, 1, H100_SMS).n_split == 1


# --- the split and merge rule ---------------------------------------------

def _top(drow, cols, k):
    """The k nearest of the finite columns `cols` of one row of distances,
    ascending by (distance, index)."""
    cols = cols[np.isfinite(drow[cols])]
    return [(drow[c], c) for c in cols[np.lexsort((cols, drow[cols]))][:k]]


def _chunk_topk(drow, c0, c1, k, grouped):
    """Top-k of columns [c0, c1); grouped: of the top-2 of each 128-column
    group (c0 is a multiple of 128)."""
    cols = np.arange(c0, c1)
    if grouped:
        cols = np.array([c for g0 in range(c0, c1, 128)
                         for _, c in _top(drow, np.arange(g0, min(g0 + 128, c1)), 2)], np.int64)
    return _top(drow, cols, k)


def _merge2(a, b, k):
    """Two ascending lists into one, ties to the lower index."""
    out = []
    while len(out) < k and (a or b):
        take_a = bool(a) and (not b or a[0] <= b[0])  # tuples: distance, then index
        out.append((a if take_a else b)[0])
        a, b = (a[1:], b) if take_a else (a, b[1:])
    return out


def _split_and_merge(dist, k, grouped, p):
    """(distances, indices) of the plan `p`: per-chunk top-k, then pairwise
    merges; inf and index 0 for a missing neighbour."""
    out_d = np.full((dist.shape[0], k), np.inf, np.float32)
    out_i = np.zeros((dist.shape[0], k), np.int64)
    nd = dist.shape[1]
    for row, drow in enumerate(dist):
        lists = [_chunk_topk(drow, c0, min(c0 + p.chunk, nd), k, grouped)
                 for c0 in range(0, p.n_split * p.chunk, p.chunk)]
        while len(lists) > 1:
            lists = [_merge2(lists[j], lists[j + 1] if j + 1 < len(lists) else [], k)
                     for j in range(0, len(lists), 2)]
        for s, (d, i) in enumerate(lists[0]):
            out_d[row, s], out_i[row, s] = d, i
    return out_d, out_i


def _tied_cloud(nq, nd, seed):
    """Queries, database and validity with exact ties: a fifth of the
    database points are copies of others, a fifth of the queries sit on a
    database point (distance 0 after the clamp), coordinates on a coarse
    grid so that distinct points tie too."""
    rng = np.random.default_rng(seed)
    db = np.round(rng.uniform(-20, 20, (nd, 3)) * 2) / 2
    dup = rng.integers(0, nd, nd // 5)
    db[rng.integers(0, nd, nd // 5)] = db[dup]
    q = np.round(rng.uniform(-20, 20, (nq, 3)) * 2) / 2
    q[: nq // 5] = db[rng.integers(0, nd, nq // 5)]
    return q.astype(np.float32), db.astype(np.float32), rng.random(nd) < 0.85


@pytest.mark.parametrize("form", ["expanded", "diff"])
@pytest.mark.parametrize("nq,nd,k,grouped,plan", [
    (24, 1500, 5, False, kc.Plan(3, 512, True)),
    (24, 1500, 5, True, kc.Plan(3, 512, True)),
    (16, 1300, 3, False, kc.Plan(11, 128, True)),  # more chunks than a power of two
    (16, 1300, 1, False, kc.Plan(6, 256, True)),
    (12, 5000, 2, True, kc.Plan(40, 128, True)),  # more than 32 chunks: lanes fold runs
    (12, 5000, 8, False, kc.Plan(40, 128, True)),
    (20, 300, 5, True, kc.Plan(1, 384, False)),  # one kernel, no merge
    (20, 130, 8, True, None),  # fewer candidates than k; the plan's own choice
    (20, 700, 4, False, None),
])
def test_split_merge_rule_matches_plain(nq, nd, k, grouped, plan, form):
    """Per-chunk top-k then pairwise merges, on the plain version's own
    distances, give the unsplit result, the plain version's distances bit
    for bit and the (distance, index)-ordered neighbours: ties go to the
    lower index, a missing neighbour is inf / 0, invalid points are never
    selected. The reference package's Pallas kernel (interpret mode) finds
    the same distances: the clouds lie on a half-metre grid inside 20 m, so
    every distance is exact in float32 in either form and no tolerance is
    needed."""
    q, db, valid = _tied_cloud(nq, nd, nq + nd + k)
    tq, tdb, tv = torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(valid)
    dn = knn_plain._db_norms(tdb, tv)
    dist = knn_plain._dist2(tq, knn_plain._sqnorm(tq), tdb, dn, form).numpy()
    p = plan or kc.plan(nq, nd, k, H100_SMS, grouped)
    assert p.n_split * p.chunk >= nd and (p.n_split - 1) * p.chunk < nd
    d_e, i_e = _split_and_merge(dist, k, grouped, p)
    d_r, i_r = _split_and_merge(dist, k, grouped, kc.Plan(1, -(-nd // 128) * 128, False))
    np.testing.assert_array_equal(d_e, d_r)
    np.testing.assert_array_equal(i_e, i_r)
    assert (d_e[:, 0] == 0).any()  # queries on database points: the clamp and ties at 0
    with np.errstate(invalid="ignore"):
        assert k == 1 or (np.diff(d_e, axis=1) == 0).any()  # ties were exercised
    fn = knn_plain.knn_grouped if grouped else knn_plain.knn
    d_p, i_p = fn(tq, tdb, tv, k=k, form=form)
    np.testing.assert_array_equal(d_p.numpy(), d_e)
    fin = np.isfinite(d_e)
    assert valid[i_e[fin]].all() and (i_p.numpy()[~fin] == 0).all()
    # the plain version's neighbours lie at the same distances (its choice among ties is free)
    np.testing.assert_array_equal(np.take_along_axis(dist, i_p.numpy().astype(np.int64), 1)[fin],
                                  d_e[fin])
    d_j, _ = knn_pallas(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid), k=k, q_tile=8,
                        db_tile=512, interpret=True, mxu=form == "expanded", grouped=grouped)
    np.testing.assert_array_equal(np.asarray(d_j), d_e)


def _f32_fma(a, b, c):
    """float32 fma through float64: the product of two float32 is exact in
    float64, the sum is rounded once there and once to float32."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("form", ["expanded", "diff"])
@pytest.mark.parametrize("scale", [0.5, 50.0, 300.0, 5000.0])
def test_scan_bound_is_a_lower_bound(scale, form):
    """The dense kernels scan with csrc/knn.cu's scan_bound, an FMA chain on
    the shrunk norms, and update exactly only where it passes: it must never
    exceed the plain version's distance of either form (or a neighbour could
    be missed), near and far from the origin, for coincident and distant
    pairs, and stay within 2^-17 (|q|^2 + |d|^2) of it (or it would pass
    everything)."""
    rng = np.random.default_rng(int(scale * 10))
    f32 = np.float32
    db = rng.uniform(-scale, scale, (3000, 3)).astype(f32)
    q = rng.uniform(-scale, scale, (400, 3)).astype(f32)
    q[:200] = db[rng.integers(0, 3000, 200)] + rng.normal(0, 1e-3 * scale, (200, 3)).astype(f32)
    q[:20] = db[:20]  # coincident pairs
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    qn, dn = knn_plain._sqnorm(tq).numpy(), knn_plain._sqnorm(tdb).numpy()
    if form == "diff":
        exact = knn_plain._dist2(tq, None, tdb, torch.from_numpy(dn), "diff").numpy()
    else:  # before the clamp, which only raises it
        dot = (q[:, 0:1] * db[None, :, 0] + q[:, 1:2] * db[None, :, 1]) + q[:, 2:3] * db[None, :, 2]
        exact = (qn[:, None] + dn[None, :]) - f32(2.0) * dot
        assert exact.dtype == np.float32
    shrink = f32(1.0) - f32(2.0 ** -18)
    bound = _f32_fma(dn[None, :], shrink, (qn * shrink)[:, None])
    for axis in range(3):
        bound = _f32_fma(-q[:, axis:axis + 1], f32(2.0) * db[None, :, axis], bound)
    assert (bound <= exact).all()
    assert (exact - bound <= f32(2.0 ** -17) * (qn[:, None] + dn[None, :])).all()
