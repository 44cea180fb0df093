"""The sparse (Morton-sorted, box-skipping) kNN and the difference-form
distance of the port against vil_fusion_tpu.

The JAX side runs as its own tests run it on the CPU: `knn_pallas_sparse`
and `knn_pallas(mxu=False)` in interpret mode at the small tiles of
tests/test_pallas_knn.py. On the CPU the port runs its plain versions; the
CUDA kernel is held against the same plain versions on a card by
test_torch_cuda.py. Also here, without a card: K3's launch plan, its
every-row reference (torch_sparse_reference.py, ties to the lower index)
against the plain version and the reference, and the Morton keys at their
edge cases.
Tolerances are stated in each test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu.ops import knn as knn_xla
from vil_fusion_tpu.ops.pallas import knn_pallas as kp
from vil_fusion_tpu_torch.ops import knn as tknn
from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

torch.set_num_threads(2)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _clustered(seed, n_centers, nd, nq, valid_gt=0.1):
    """tests/test_pallas_knn.py's clustered cloud (like a lidar map), so that
    block skipping actually happens."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (n_centers, 3))
    db = (centers[rng.integers(0, n_centers, nd)] + rng.normal(0, 2.0, (nd, 3))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, nq)] + rng.normal(0, 2.0, (nq, 3))).astype(np.float32)
    return q, db, rng.random(nd) > valid_gt


@pytest.mark.parametrize("seed,n_centers,nd,nq,k", [(3, 20, 3000, 300, 5), (13, 15, 2000, 256, 5),
                                                   (21, 12, 1500, 200, 3)])
def test_plain_sparse_matches_pallas_sparse(seed, n_centers, nd, nq, k):
    """Plain K3 vs knn_pallas_sparse(interpret=True) at q_tile=64,
    db_tile=256, radius 3 (test_pallas_knn.py:27-54): the gates
    d2[:, -1] < r^2 are equal, distances agree to rtol 1e-4 / atol 1e-3 and
    indices are equal inside the gate. Outside the gate both sides skip the
    same blocks (same tiles, same box test), so missing neighbours (inf)
    coincide too; and inside the gate K3 equals the exact search."""
    q, db, v = _clustered(seed, n_centers, nd, nq)
    d_ref, i_ref = kp.knn_pallas_sparse(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v), k=k,
                                        radius=3.0, q_tile=64, db_tile=256, cell=2.0,
                                        interpret=True)
    d, i = tknn.knn_sparse(*_t(q, db, v), k=k, radius=3.0, q_tile=64, db_tile=256, cell=2.0)
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == (nq, k)
    d, i, d_ref, i_ref = d.numpy(), i.numpy(), np.asarray(d_ref), np.asarray(i_ref)
    gate = d_ref[:, -1] < 9.0
    np.testing.assert_array_equal(d[:, -1] < 9.0, gate)
    assert gate.sum() > 50
    np.testing.assert_allclose(d[gate], d_ref[gate], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(i[gate], i_ref[gate])
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(d_ref))
    d_x, i_x = knn_xla.knn(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v), k=k)
    np.testing.assert_allclose(d[gate], np.asarray(d_x)[gate], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(i[gate], np.asarray(i_x)[gate])
    assert (d[np.isfinite(d)] >= 0).all() and (np.diff(d, axis=1)[np.isfinite(d[:, 1:])] >= 0).all()
    assert (i[~np.isfinite(d)] == 0).all() and v[i[np.isfinite(d)]].all()


def test_plain_sparse_presorted_flags():
    """q_sorted/db_sorted with the caller applying morton_sort itself
    (test_pallas_knn.py:57-81): bit-equal to the self-sorting path after
    undoing the caller's permutations, and equal to JAX's presorted run
    inside the gate (rtol 1e-4 / atol 1e-3, indices equal)."""
    rng = np.random.default_rng(9)
    q = rng.uniform(-30, 30, (200, 3)).astype(np.float32)
    db = rng.uniform(-30, 30, (2000, 3)).astype(np.float32)
    v = rng.random(2000) > 0.2
    tq, tdb, tv = _t(q, db, v)
    kw = dict(k=4, radius=5.0, q_tile=64, db_tile=256)
    d_self, i_self = tknn.knn_sparse(tq, tdb, tv, **kw)
    qp, dp = tknn.morton_sort(tq), tknn.morton_sort(tdb, tv)
    d_s, i_s = tknn.knn_sparse(tq[qp], tdb[dp], tv[dp], q_sorted=True, db_sorted=True, **kw)
    inv = torch.argsort(qp)
    d_back, i_back = d_s[inv], dp[i_s.long()][inv]
    assert torch.equal(d_back, d_self)
    fin = torch.isfinite(d_self)
    assert torch.equal(i_back[fin], i_self.long()[fin])
    jq, jd = kp.morton_sort(jnp.asarray(q)), kp.morton_sort(jnp.asarray(db), jnp.asarray(v))
    d_j, i_j = kp.knn_pallas_sparse(jnp.asarray(q)[jq], jnp.asarray(db)[jd], jnp.asarray(v)[jd],
                                    q_sorted=True, db_sorted=True, interpret=True, **kw)
    gate = np.asarray(d_j)[:, -1] < 25.0
    assert gate.sum() > 50
    np.testing.assert_allclose(d_s.numpy()[gate], np.asarray(d_j)[gate], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(i_s.numpy()[gate], np.asarray(i_j)[gate])


def test_plain_sparse_all_invalid_db():
    """All-invalid database (test_pallas_knn.py:84-89): every distance inf,
    every index 0, as from JAX."""
    d_j, i_j = kp.knn_pallas_sparse(jnp.zeros((70, 3)), jnp.ones((500, 3)), jnp.zeros(500, bool),
                                    k=3, radius=2.0, q_tile=64, db_tile=128, interpret=True)
    d, i = tknn.knn_sparse(torch.zeros((70, 3)), torch.ones((500, 3)),
                           torch.zeros(500, dtype=torch.bool), k=3, radius=2.0, q_tile=64,
                           db_tile=128)
    assert torch.isinf(d).all() and (i == 0).all()
    assert not np.isfinite(np.asarray(d_j)).any() and (np.asarray(i_j) == 0).all()


@pytest.mark.parametrize("with_valid", [False, True])
def test_morton_sort_and_tile_boxes_match(with_valid):
    """morton_sort: the same permutation as JAX's (both sorts are stable, so
    equal keys keep their order too); `_morton_keys` equal; `_tile_aabb`
    equal to JAX's first three columns (its fourth is padding), including
    the (+inf, -inf) box of a tile without valid points."""
    rng = np.random.default_rng(17)
    pts = rng.uniform(-60, 60, (1536, 3)).astype(np.float32)
    v = (rng.random(1536) > 0.3) if with_valid else None
    jv = None if v is None else jnp.asarray(v)
    tv = None if v is None else torch.from_numpy(v)
    perm_j = np.asarray(kp.morton_sort(jnp.asarray(pts), jv, cell=2.0))
    perm_t = tknn.morton_sort(torch.from_numpy(pts), tv, cell=2.0).numpy()
    np.testing.assert_array_equal(perm_t, perm_j)
    origin = pts.min(0) - 1e-3
    np.testing.assert_array_equal(
        tknn._morton_keys(torch.from_numpy(pts), torch.from_numpy(origin), 2.0).numpy(),
        np.asarray(kp._morton_keys(jnp.asarray(pts), jnp.asarray(origin), 2.0)))
    valid = np.ones(1536, bool) if v is None else v.copy()
    valid[256:512] = False  # one all-invalid tile
    sp, sv = pts[perm_j], valid[perm_j]
    lo_j, hi_j = kp._tile_aabb(jnp.asarray(sp), jnp.asarray(sv), 256)
    lo_t, hi_t = tknn._tile_aabb(torch.from_numpy(sp), torch.from_numpy(sv), 256)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j)[:, :3])
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j)[:, :3])
    assert np.isposinf(lo_t.numpy()).any() == (~sv.reshape(-1, 256)).all(1).any()


def test_sparse_skip_rule_and_padding():
    """The skip rule's arithmetic (per axis max(dlo - qhi, qlo - dhi, 0),
    squared, summed, <= r^2) on hand-made boxes, including a box at exactly
    the radius (kept) and an empty (+inf, -inf) box (skipped); queries are
    padded with the last sorted point, the database with invalid points."""
    q_lo = torch.tensor([[0.0, 0.0, 0.0]])
    q_hi = torch.tensor([[1.0, 1.0, 1.0]])
    d_lo = torch.tensor([[4.0, 0.0, 0.0], [4.0, 5.0, 0.0], [0.5, 0.5, 0.5], [float("inf")] * 3,
                         [-9.0, 0.0, 0.0]])
    d_hi = torch.tensor([[5.0, 1.0, 1.0], [5.0, 6.0, 1.0], [0.6, 0.6, 0.6], [float("-inf")] * 3,
                         [-2.5, 1.0, 1.0]])
    near = tknn.sparse_near(q_lo, q_hi, d_lo, d_hi, 3.0)
    assert near.tolist() == [[True, False, True, False, True]]
    q, db, v = _clustered(5, 6, 300, 70)
    prob = tknn.sparse_prepare(*_t(q, db, v), q_tile=64, db_tile=128)
    assert prob.q.shape == (128, 3) and prob.db.shape == (384, 3) and prob.nq == 70
    assert torch.equal(prob.q[70:], prob.q[69:70].expand(58, 3))
    assert not prob.db_valid[300:].any()
    assert prob.q_lo.shape == (2, 3) and prob.d_hi.shape == (3, 3)


@pytest.mark.parametrize("grouped", [False, True])
def test_plain_diff_form_matches_pallas(grouped):
    """The difference form (`form="diff"`) of the plain exact and grouped
    searches vs knn_pallas(interpret=True, mxu=False): distances rtol 1e-4 /
    atol 1e-3 (the same three squared differences, summed in another order);
    indices identical on rows whose candidates are 1e-3 apart. The
    difference form has no cancellation, so against a float64 brute force
    it is tighter than the expanded form."""
    rng = np.random.default_rng(11 + grouped)
    q = rng.uniform(-50, 50, (256, 3)).astype(np.float32)
    db = rng.uniform(-50, 50, (4096, 3)).astype(np.float32)
    v = rng.random(4096) > 0.1
    d_ref, i_ref = kp.knn_pallas(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v), k=5,
                                 q_tile=128, db_tile=512, interpret=True, grouped=grouped,
                                 mxu=False)
    fn = tknn.knn_grouped if grouped else tknn.knn
    d, i = fn(*_t(q, db, v), k=5, form="diff")
    d_ref = np.asarray(d_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-4, atol=1e-3)
    d6 = fn(*_t(q, db, v), k=6, form="diff")[0].numpy()
    margin = np.all(np.diff(d6, axis=1) > np.maximum(d6[:, 1:], 1e-6) * 1e-3, axis=1)
    assert margin.sum() > 150
    np.testing.assert_array_equal(i.numpy()[margin], np.asarray(i_ref)[margin])
    if not grouped:
        d64 = ((q[:, None, :].astype(np.float64) - db[None, v, :]) ** 2).sum(-1)
        ref = np.sort(d64, axis=1)[:, :5]
        err_diff = np.abs(d.numpy() - ref).max()
        err_exp = np.abs(tknn.knn(*_t(q, db, v), k=5)[0].numpy() - ref).max()
        assert err_diff <= err_exp and err_diff < 1e-4


def test_form_argument_is_checked():
    """An unknown distance form raises in the plain searches and in the
    dispatcher, before any search runs."""
    q, db, v = _t(np.zeros((4, 3), np.float32), np.ones((8, 3), np.float32), np.ones(8, bool))
    for fn in (tknn.knn, tknn.knn_grouped, kc.knn):
        with pytest.raises(ValueError, match="form"):
            fn(q, db, v, k=2, form="mxu")


def test_dispatcher_radius_never_grouped():
    """With `radius`, `q_sorted` or `db_sorted` the dispatcher never takes
    the grouped search, whatever `approx` says (the grouped merge is wrong
    on spatially sorted buffers): radius -> sparse, sorted flags alone ->
    exact."""
    q, db, v = _t(*_clustered(2, 8, 1500, 100))
    dp = tknn.morton_sort(db, v)
    sdb, sv = db[dp], v[dp]
    d, i = kc.knn(q, sdb, sv, k=5, approx=True, db_sorted=True)
    d_x, i_x = tknn.knn(q, sdb, sv, k=5)
    assert torch.equal(d, d_x) and torch.equal(i, i_x)
    d, i = kc.knn(q, sdb, sv, k=5, approx=True, radius=3.0, db_sorted=True)
    d_s, i_s = tknn.knn_sparse(q, sdb, sv, k=5, radius=3.0, db_sorted=True)
    assert torch.equal(d, d_s) and torch.equal(i, i_s)
    gate = d_x[:, -1] < 9.0
    assert gate.sum() > 20 and torch.equal(d[gate], tknn.knn(q, sdb, sv, k=5, form="diff")[0][gate])


def test_sparse_wrapper_passes_tiles_on_cpu():
    """K3's wrapper takes the plain version for CPU tensors, passes the tile
    arguments through (so small tiles can be tested without a card), and
    counts no launch; its defaults are the card's tiles."""
    assert kc.SPARSE_Q_TILE == 128 and kc.SPARSE_DB_TILE % 128 == 0
    q, db, v = _t(*_clustered(4, 10, 1200, 150))
    n = kc.knn_sparse.launches
    d, i = kc.knn_sparse(q, db, v, k=5, radius=3.0, q_tile=32, db_tile=64)
    d_p, i_p = tknn.knn_sparse(q, db, v, k=5, radius=3.0, q_tile=32, db_tile=64)
    assert torch.equal(d, d_p) and torch.equal(i, i_p) and kc.knn_sparse.launches == n
    d_big = tknn.knn_sparse(q, db, v, k=5, radius=3.0, q_tile=128, db_tile=128)[0]
    gate = d_big[:, -1] < 9.0
    assert torch.equal(d[gate], d_big[gate])  # tiles change what is skipped, not the answer
    assert torch.isfinite(d_big).sum() >= torch.isfinite(d).sum()


# ---------------------------------------------------------------------------
# K3's launch plan, its every-row reference (tests/torch_sparse_reference.py)
# and the Morton keys of its key kernel
# ---------------------------------------------------------------------------

H100_SMS = 132
K3_SHAPES = [(8192, 131072), (2048, 65536), (8192, 32768), (2048, 16384),  # main
             (3000, 20000), (1, 130), (127, 1), (129, 129), (100000, 1000),  # ragged
             (20000, 65536), (0, 100), (5, 0), (0, 0), (1, 1)]  # many queries; degenerate


@pytest.mark.parametrize("sm_count", [H100_SMS, 108])
@pytest.mark.parametrize("nq,nd", K3_SHAPES)
def test_sparse_plan(nq, nd, sm_count):
    """`knn_cuda.sparse_plan` is a pure function of the shape and the SM
    count: one block row a query tile of 128; as many blocks a tile as the
    card has SMs for each tile, at least one, and no more than give every
    group of 8 one database tile; the box kernel only where the database has
    a tile; no kernel without a query. The scratch holds the boxes and,
    with a split, the groups' lists."""
    how = kc.sparse_plan(nq, nd, sm_count)
    assert how == kc.sparse_plan(nq, nd, sm_count)
    assert how.kernels == (0 if nq == 0 else 1 + (nd > 0))
    if nq == 0:
        return
    assert how.blocks == -(-nq // 128) and how.db_tiles == -(-nd // 128)
    assert how.n_split >= 1 and (how.n_split == 1 or how.blocks * how.n_split <= sm_count)
    assert (how.n_split - 1) * kc.SPARSE_GROUPS < max(1, how.db_tiles)
    assert how.n_split == max(1, min(sm_count // how.blocks, -(-how.db_tiles // 8)))
    if sm_count == H100_SMS and (nq, nd) in K3_SHAPES[:4]:  # one wave of 128 blocks
        assert how.blocks * how.n_split == 128
    lists = how.blocks * how.n_split * 8 * 5 * 128 if how.n_split > 1 else 0
    assert kc.sparse_scratch_bytes(how, 5) == 32 * how.db_tiles + 8 * lists
    assert kc.sparse_plan(nq, nd, sm_count, db_tile=256).db_tiles == -(-nd // 256)


def _tied_clustered(seed, n_centers, nd, nq, valid_gt=0.1):
    """_clustered on a 0.25 m grid, with duplicated database points and
    queries on database points: exact ties between neighbours."""
    q, db, v = _clustered(seed, n_centers, nd, nq, valid_gt)
    rng = np.random.default_rng(seed + 1)
    db = np.round(db * 4) / 4
    db[rng.integers(0, nd, nd // 5)] = db[rng.integers(0, nd, nd // 5)]
    q = np.round(q * 4) / 4
    q[: nq // 4] = db[rng.integers(0, nd, nq // 4)]
    return q.astype(np.float32), db.astype(np.float32), v


@pytest.mark.parametrize("seed,nq,nd,k,presort,radius", [
    (31, 300, 3000, 5, False, 3.0),  # the wrapper sorts both sides
    (32, 257, 2001, 8, True, 3.0),  # presorted, ragged on both sides
    (33, 129, 700, 1, False, 3.0),
    (34, 1, 130, 3, True, 3.0),  # one query, two database tiles
    (35, 200, 1500, 4, False, 0.0),  # radius 0: only exact hits
    (36, 200, 1500, 5, False, 60.0),  # every block near: one long list
])
def test_sparse_model_matches_plain_and_pallas(seed, nq, nd, k, presort, radius):
    """K3's every-row reference (torch_sparse_reference.lex_reference: the
    plain problem at 128 x 128 tiles, ties to the lower index, as the
    kernels order a row) on clustered clouds with exact ties: equal to the
    plain version (knn_sparse at 128 x 128 tiles) distance for distance on
    every row and index for index wherever the k+1 nearest are distinct;
    inside the radius equal to the reference's
    knn_pallas_sparse(interpret=True) at the same tiles (rtol 1e-4 / atol
    1e-3, the tolerance of the tests above; indices equal where the k+1
    nearest are 1e-3 apart)."""
    from torch_sparse_reference import lex_reference

    q, db, v = _tied_clustered(seed, 10, nd, nq)
    tq, tdb, tv = _t(q, db, v)
    if presort:
        qp, dp = tknn.morton_sort(tq), tknn.morton_sort(tdb, tv)
        tq, tdb, tv = tq[qp].contiguous(), tdb[dp].contiguous(), tv[dp].contiguous()
    kw = dict(q_sorted=presort, db_sorted=presort)
    d_m, i_m = lex_reference(tq, tdb, tv, k, radius, presort, presort)
    assert d_m.dtype == torch.float32 and i_m.dtype == torch.int32 and d_m.shape == (nq, k)
    d_p, i_p = tknn.knn_sparse(tq, tdb, tv, k=k, radius=radius, q_tile=128, db_tile=128, **kw)
    assert torch.equal(d_m, d_p)
    d_more = tknn.knn_sparse(tq, tdb, tv, k=k + 1, radius=radius, q_tile=128, db_tile=128, **kw)[0]
    distinct = ((d_more[:, 1:] > d_more[:, :-1]) | torch.isinf(d_more[:, 1:])).all(1)
    assert torch.equal(i_m[distinct], i_p[distinct])
    ties = (d_m[:, 1:] == d_m[:, :-1]) & torch.isfinite(d_m[:, 1:])
    assert k == 1 or radius == 0.0 or ties.any()  # the cloud really has ties
    assert (i_m[torch.isinf(d_m)] == 0).all() and tv[i_m[torch.isfinite(d_m)].long()].all()
    d_j, i_j = kp.knn_pallas_sparse(jnp.asarray(tq.numpy()), jnp.asarray(tdb.numpy()),
                                    jnp.asarray(tv.numpy()), k=k, radius=radius, q_tile=128,
                                    db_tile=128, interpret=True, **kw)
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    r2 = max(radius, 1e-3) ** 2
    gate = d_j[:, -1] < r2
    np.testing.assert_array_equal(d_m.numpy()[:, -1] < r2, gate)
    np.testing.assert_allclose(d_m.numpy()[gate], d_j[gate], rtol=1e-4, atol=1e-3)
    dm = d_more.numpy()
    clear = gate & np.all(np.diff(dm, axis=1) > 1e-3, axis=1)
    np.testing.assert_array_equal(i_m.numpy()[clear], i_j[clear])
    if radius > 0:
        assert gate.sum() > 0


@pytest.mark.parametrize("case", ["random", "all invalid", "one point", "cell boundaries",
                                  "beyond 1023 cells", "no mask"])
def test_morton_keys_edge_cases(case):
    """The port's Morton keys and sort (ops/knn.py:morton_keys /
    morton_sort, the CUDA dispatcher's plain versions) against the JAX
    package's `_morton_keys` / `morton_sort`: keys equal, 0x7FFFFFFF for an
    invalid point, and the same permutation (both sorts are stable)."""
    rng = np.random.default_rng(41)
    pts = rng.uniform(-60, 60, (1000, 3)).astype(np.float32)
    valid = rng.random(1000) > 0.3
    if case == "all invalid":
        valid[:] = False
    elif case == "one point":
        pts, valid = pts[:1], np.ones(1, bool)
    elif case == "cell boundaries":  # origin 0 exactly, points on and just below 2 m multiples
        cells = rng.integers(0, 40, (600, 3)).astype(np.float32) * 2
        below = np.nextafter(cells, np.float32(-1))
        pts = np.concatenate([[[0.001] * 3], cells[:300], below[300:]]).astype(np.float32)
        valid = np.ones(len(pts), bool)
    elif case == "beyond 1023 cells":  # up to 2500 cells an axis; invalid points below the origin
        pts = rng.uniform(-50, 5000, (1000, 3)).astype(np.float32)
        pts[valid] = np.abs(pts[valid])
    jv = None if case == "no mask" else jnp.asarray(valid)
    tv = None if case == "no mask" else torch.from_numpy(valid)
    keys = tknn.morton_keys(torch.from_numpy(pts), tv, cell=2.0).numpy()
    ok = np.ones(len(pts), bool) if tv is None else valid
    if ok.any():
        origin = pts[ok].min(0) - np.float32(1e-3)
        ref = np.asarray(kp._morton_keys(jnp.asarray(pts), jnp.asarray(origin), 2.0))
        np.testing.assert_array_equal(keys[ok], ref[ok])
    assert (keys[~ok] == 0x7FFFFFFF).all() and (keys[ok] < 1 << 30).all()
    if case == "beyond 1023 cells":
        assert (keys[ok] == 0x3FFFFFFF).any()  # clamped to cell 1023 on every axis
    perm = tknn.morton_sort(torch.from_numpy(pts), tv, cell=2.0).numpy()
    np.testing.assert_array_equal(perm, np.asarray(kp.morton_sort(jnp.asarray(pts), jv, cell=2.0)))
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    torch_keys = kc.morton_keys(torch.from_numpy(pts), tv)  # the CPU route of the dispatcher
    assert torch.equal(torch_keys, torch.from_numpy(keys))


@pytest.mark.parametrize("cell,ok", [(2.0, True), (1.0, True), (0.5, True), (4.0, True),
                                     (1.5, False), (3.0, False), (0.0, False), (-2.0, False),
                                     (float("inf"), False)])
def test_morton_cell_must_be_power_of_two_on_cuda(cell, ok):
    """The Morton-key kernel divides by `cell`; the plain version on a CUDA
    tensor multiplies by its float32 reciprocal, which agrees on every key
    only for a power of two. So the CUDA route refuses any other cell
    (`check_cell`), while the CPU route, the plain version, takes any cell
    and agrees with the JAX package's keys at 1.5 too."""
    if ok:
        kc.check_cell(cell)
    else:
        with pytest.raises(ValueError, match="power of two"):
            kc.check_cell(cell)
    if cell == 1.5:
        rng = np.random.default_rng(43)
        pts = rng.uniform(-60, 60, (500, 3)).astype(np.float32)
        origin = pts.min(0) - np.float32(1e-3)
        keys = kc.morton_keys(torch.from_numpy(pts), None, cell=cell).numpy()
        np.testing.assert_array_equal(
            keys, np.asarray(kp._morton_keys(jnp.asarray(pts), jnp.asarray(origin), cell)))
