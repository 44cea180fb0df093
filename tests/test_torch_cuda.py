"""The port on a CUDA card: the K1/K2/K3 kernels (both distance forms of K1
and K2) and the Morton-key kernels against their plain versions at the main paths' shapes, the
dispatcher's routing on the card, the LiDAR-only slice, the vil front end and
one fused estimator step on the card against the same code on the CPU, the
batched K1 / K2 launch (a sequence axis, and torch.func.vmap of the
wrappers) against unbatched launches and batched odometry against single
steps, the
deferred pipeline (sync_depth=2) on the card against the CPU, the Schur
solve's Cholesky fallback on the card, the device raycaster against itself
on the CPU, a KITTI odometry replay into a pipeline on the card, the
symmetric eigensolver kernels (csrc/eigh.cu) against torch.linalg.eigh,
float64 and their numpy mirror (tests/torch_eigh_reference.py), and a graph
capture of them against an eager call, the estimator's captured step
(utils/graphs.py) against its eager body: over a sequence with both keyframe
decisions, after the state is rebound, with no sync, without aliasing its
outputs, and a small vil pipeline's stage graphs and frame graph (the
reference's jits) replay by replay against their eager bodies; the visual
loop's graphs (keyframe program, PnP RANSAC, 4-DoF solve) and the batched
odometry step's against their bodies, with no sync in a replay.

Imports torch and numpy only (a CUDA machine need not have jax). Every
test needs a card and skips without one. Where jax is not installed, skip
tests/conftest.py (it configures jax):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kNN kernels have no CPU mode")
    return torch.device("cuda", 0)


def _data(nq, nd, seed, lo=-50.0, hi=50.0, valid_frac=0.9):
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (nq, 3)).astype(np.float32)
    db = rng.uniform(lo, hi, (nd, 3)).astype(np.float32)
    return q, db, rng.random(nd) < valid_frac


def _margin_rows(d, k):
    d = d[:, : k + 1]
    gap_ok = (d[:, 1:] - d[:, :-1]) > 1e-6 * torch.clamp(d[:, 1:], min=1e-12)
    return (gap_ok | ~torch.isfinite(d[:, 1:])).all(1) & torch.isfinite(d[:, 0])


@pytest.mark.parametrize("form", ["expanded", "diff"])
@pytest.mark.parametrize("nq,nd,k,grouped", [
    (2048, 16384, 5, True),  # edge association
    (8192, 32768, 5, True),  # surf association
    (2048, 51200, 1, False),  # ICP
    (8192, 32768, 5, False),  # exact association (approx_knn=False)
    (192, 115200, 3, False),  # depth association
    (384, 19200, 3, False),  # the visual loop's densification (extra corners x e2e scan)
    (300, 1000, 8, False),
    (77, 130, 3, True),
] + [(nq, nd, k, grouped)  # few and ragged queries, ragged databases, one chunk to the cap
     for nq in (1, 127, 129, 192, 513) for nd in (130, 4097, 115200) for k in (1, 3, 8)
     for grouped in (True, False)])
def test_cuda_kernel_matches_plain(cuda_device, nq, nd, k, grouped, form):
    """Kernel and plain version round identically in both distance forms:
    distances equal within 1e-6 of the largest distance, indices identical
    on rows whose k+1 nearest are 1e-6 relative apart, index 0 where no
    neighbour; one launch counted per call (and as a difference-form launch
    where it is one), which enqueues as many kernels as the plan says (the
    library counts them where it launches them)."""
    q, db, v = (torch.from_numpy(x).to(cuda_device) for x in _data(nq, nd, nq + nd))
    kern = kc.knn_grouped if grouped else kc.knn_exact
    plain = kc.knn_grouped_plain if grouped else kc.knn_exact_plain
    before, before_diff, before_kernels = kern.launches, kern.launches_diff, kc.kernels_enqueued()
    d, i = kern(q, db, v, k=k, form=form)
    sm_count = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert kc.kernels_enqueued() - before_kernels == 1 + kc.plan(nq, nd, k, sm_count, grouped).merge
    assert kern.launches == before + 1
    assert kern.launches_diff == before_diff + (form == "diff")
    assert kern.last_call == (nq, nd, k)
    d_p, i_p = plain(q, db, v, k=k, form=form)
    d_m, _ = plain(q, db, v, k=k + 1, form=form)
    torch.cuda.synchronize()
    fin = torch.isfinite(d_p)
    assert torch.equal(fin, torch.isfinite(d))
    assert (d[fin] - d_p[fin]).abs().max().item() <= 1e-6 * d_p[fin].max().item()
    rows = _margin_rows(d_m, k)
    assert rows.float().mean().item() > 0.95
    assert torch.equal(i[rows], i_p[rows])
    assert (i[~torch.isfinite(d)] == 0).all()


@pytest.mark.parametrize("form", ["expanded", "diff"])
@pytest.mark.parametrize("nq,nd,k,grouped", [
    (513, 4097, 5, True), (513, 4097, 5, False), (192, 40000, 3, False), (2048, 16384, 1, False),
    (129, 130, 8, True),
])
def test_cuda_kernel_ties_to_lower_index(cuda_device, nq, nd, k, grouped, form):
    """Duplicated database points, queries on database points and a coarse
    coordinate grid give exact ties: the kernel's distances equal the plain
    version's bit for bit on every row, and its indices are the (distance,
    index)-ordered ones (of the groups' top-2 for K1), computed here from the
    plain version's distance matrix with stable sorts."""
    from vil_fusion_tpu_torch.ops import knn as knn_plain

    rng = np.random.default_rng(nq + nd)
    db = np.round(rng.uniform(-20, 20, (nd, 3)) * 2) / 2
    db[rng.integers(0, nd, nd // 5)] = db[rng.integers(0, nd, nd // 5)]
    q = np.round(rng.uniform(-20, 20, (nq, 3)) * 2) / 2
    q[: nq // 5] = db[rng.integers(0, nd, nq // 5)]
    q, db, v = (torch.from_numpy(x).to(cuda_device)
                for x in (q.astype(np.float32), db.astype(np.float32), rng.random(nd) < 0.85))
    kern = kc.knn_grouped if grouped else kc.knn_exact
    plain = kc.knn_grouped_plain if grouped else kc.knn_exact_plain
    d, i = kern(q, db, v, k=k, form=form)
    d_p, _ = plain(q, db, v, k=k, form=form)
    assert torch.equal(d, d_p)
    dist = knn_plain._dist2(q, knn_plain._sqnorm(q), db, knn_plain._db_norms(db, v), form)
    cols = torch.arange(nd, device=cuda_device).expand(nq, nd)
    if grouped:
        pad = (-nd) % 128
        dist = torch.nn.functional.pad(dist, (0, pad), value=float("inf")).view(nq, -1, 128)
        g_d, g_a = torch.sort(dist, dim=2, stable=True)
        dist = g_d[:, :, :2].reshape(nq, -1)
        cols = (g_a[:, :, :2] + 128 * torch.arange(dist.shape[1] // 2,
                                                   device=cuda_device)[None, :, None]).reshape(nq, -1)
    kk = min(k, dist.shape[1])
    d_r, order = torch.sort(dist, dim=1, stable=True)
    i_r = torch.gather(cols, 1, order)[:, :kk]
    i_r = torch.where(torch.isfinite(d_r[:, :kk]), i_r, torch.zeros_like(i_r))
    assert torch.equal(d[:, :kk], d_r[:, :kk])
    assert torch.equal(i[:, :kk].long(), i_r)
    assert (d[:, 0] == 0).any() and (k == 1 or (d[:, 1:] == d[:, :-1]).any())


@pytest.mark.parametrize("form", ["expanded", "diff"])
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("nq,nd,k", [(8192, 32768, 5), (2048, 16384, 5), (2048, 51200, 1),
                                     (1, 130, 3), (127, 4097, 8), (513, 115200, 1),
                                     (192, 115200, 3), (77, 130, 3)])
def test_cuda_batched_launch_equals_unbatched(cuda_device, nq, nd, k, grouped, form, batch):
    """K1 / K2 over a sequence axis in one launch: row s bit for bit the
    unbatched launch on sequence s (distances and indices), with
    per-sequence databases and with one database shared by every sequence
    (stride 0); one launch counted for the batch, whose kernels are the
    batched plan's (one, or two with the merge); and equal to the plain
    batched version within the unbatched kernel's tolerance."""
    rng = np.random.default_rng(batch * 7 + nq + nd)
    q = torch.from_numpy(rng.uniform(-50, 50, (batch, nq, 3)).astype(np.float32)).to(cuda_device)
    db = torch.from_numpy(rng.uniform(-50, 50, (batch, nd, 3)).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.random((batch, nd)) < 0.9).to(cuda_device)
    kern = kc.knn_grouped if grouped else kc.knn_exact
    sm_count = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    before, before_kernels = kern.launches, kc.kernels_enqueued()
    d, i = kern(q, db, v, k=k, form=form)
    assert kern.launches == before + 1
    assert kc.kernels_enqueued() - before_kernels == \
        1 + kc.plan(nq, nd, k, sm_count, grouped, batch).merge
    assert kern.last_call == (batch, nq, nd, k)
    d_sh, i_sh = kern(q, db[0], v[0], k=k, form=form)
    for s in range(batch):
        d1, i1 = kern(q[s], db[s], v[s], k=k, form=form)
        assert torch.equal(d[s], d1) and torch.equal(i[s], i1), f"sequence {s}"
        d2, i2 = kern(q[s], db[0], v[0], k=k, form=form)
        assert torch.equal(d_sh[s], d2) and torch.equal(i_sh[s], i2), f"shared, sequence {s}"
    plain = kc.knn_grouped_plain if grouped else kc.knn_exact_plain
    d_p, _ = plain(q, db, v, k=k, form=form)
    fin = torch.isfinite(d_p)
    assert torch.equal(fin, torch.isfinite(d))
    assert (d[fin] - d_p[fin]).abs().max().item() <= 1e-6 * d_p[fin].max().item()


@pytest.mark.parametrize("grouped", [True, False])
def test_cuda_vmap_rule_is_one_launch(cuda_device, grouped):
    """torch.func.vmap of the wrappers is the batched launch: one counted
    launch for 8 sequences, rows equal to the unbatched launches', with a
    vmapped and with a shared database, and nested vmap (4 x 2)."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.uniform(-50, 50, (8, 2048, 3)).astype(np.float32)).to(cuda_device)
    db = torch.from_numpy(rng.uniform(-50, 50, (8, 16384, 3)).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.random((8, 16384)) < 0.9).to(cuda_device)
    kern = kc.knn_grouped if grouped else kc.knn_exact

    def call(a, b, c):
        return kern(a, b, c, k=5)

    for args, in_dims in (((q, db, v), 0), ((q, db[3], v[3]), (0, None, None))):
        before = kern.launches
        d, i = torch.func.vmap(call, in_dims=in_dims)(*args)
        assert kern.launches == before + 1
        for s in range(8):
            d1, i1 = call(q[s], *(a[s] if in_dims == 0 else a for a in args[1:]))
            assert torch.equal(d[s], d1) and torch.equal(i[s], i1)
    before = kern.launches
    d, i = torch.func.vmap(torch.func.vmap(call))(q.view(4, 2, 2048, 3), db.view(4, 2, 16384, 3),
                                                  v.view(4, 2, 16384))
    assert kern.launches == before + 1 and d.shape == (4, 2, 2048, 5)
    d1, i1 = call(q[5], db[5], v[5])
    assert torch.equal(d[2, 1], d1) and torch.equal(i[2, 1], i1)


def test_cuda_batched_odometry_graph_equals_body(cuda_device):
    """odometry_step_batched's graph on the card (S = 3, 16 x 360 scans, K1,
    7 steps: frames 0-2 the host branches' bodies, frame 3 the steady key's
    first call, frame 4 its capture): every replay bit for bit the eager
    vmapped body (graphs.inline()) from the same states, its batched K1
    launches counted a replay as by the body, and a replay under
    torch.cuda.set_sync_debug_mode("error") raises nothing."""
    from vil_fusion_tpu_torch.models import lidar_features as lf
    from vil_fusion_tpu_torch.models import lidar_odometry as lo
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.utils import graphs

    cfg = lo.OdomConfig(lidar=lf.LidarConfig(n_scan=16, width=360, fov_up_deg=20.0,
                                             fov_down_deg=-20.0, min_range=1.0, edge_cap=256,
                                             surf_cap=1024), edge_map_cap=2048, surf_map_cap=4096)
    scene = sim.RaycastScene()
    steps = 7
    scans = [[sim.simulate_lidar_scan(scene, np.eye(3), np.array([3.0 + 2 * s + 0.3 * f, 0.5 * s,
                                                                  1.5]), n_scan=16, width=360,
                                      fov_up_deg=20.0, fov_down_deg=-20.0) for s in range(3)]
             for f in range(steps)]
    pts = torch.from_numpy(np.stack([[p for p, _ in r] for r in scans]).astype(np.float32))
    val = torch.from_numpy(np.stack([[v for _, v in r] for r in scans]))
    pts, val = pts.to(cuda_device), val.to(cuda_device)
    states = lo.init_state_batched(cfg, 3, device=cuda_device)
    r0 = graphs.replays.get("odometry_step_batched", 0)
    for f in range(steps):
        prev = states
        n_cap, k0 = len(graphs.captures), kc.knn_grouped.launches_batched
        with _sync_mode("error" if f == steps - 1 else None):
            states, out = lo.odometry_step_batched(states, pts[f], val[f], cfg, frame_count=f)
        k_graph = kc.knn_grouped.launches_batched - k0
        k0 = kc.knn_grouped.launches_batched
        with graphs.inline():
            want_states, want = lo.odometry_step_batched(prev, pts[f], val[f], cfg,
                                                         frame_count=f)
        assert _equal_leaves((states, out), (want_states, want)), f
        if f >= 3 and len(graphs.captures) == n_cap:
            assert k_graph == kc.knn_grouped.launches_batched - k0 > 0, f
    # replays from the capture on (frame 4, or 3 where an earlier test made
    # the key's first call)
    assert graphs.replays.get("odometry_step_batched", 0) - r0 >= steps - 4


def test_cuda_batched_odometry_matches_single(cuda_device):
    """odometry_step_batched on the card (S = 3, 16 x 360 scans, K1): one K1
    launch a call over the three sequences (as many as one sequence's step
    makes, a steady single step replaying its graph), every step's poses
    within 1e-4 m of odometry_step on each sequence from the same state
    (the batched state's row)."""
    from vil_fusion_tpu_torch.models import lidar_features as lf
    from vil_fusion_tpu_torch.models import lidar_odometry as lo
    from vil_fusion_tpu_torch.runtime import sim

    cfg = lo.OdomConfig(lidar=lf.LidarConfig(n_scan=16, width=360, fov_up_deg=20.0,
                                             fov_down_deg=-20.0, min_range=1.0, edge_cap=256,
                                             surf_cap=1024), edge_map_cap=2048, surf_map_cap=4096)
    scene = sim.RaycastScene()
    scans = [[sim.simulate_lidar_scan(scene, np.eye(3), np.array([3.0 + 2 * s + 0.3 * f, 0.5 * s,
                                                                  1.5]), n_scan=16, width=360,
                                      fov_up_deg=20.0, fov_down_deg=-20.0) for s in range(3)]
             for f in range(4)]
    pts = torch.from_numpy(np.stack([[p for p, _ in r] for r in scans]).astype(np.float32))
    val = torch.from_numpy(np.stack([[v for _, v in r] for r in scans]))
    pts, val = pts.to(cuda_device), val.to(cuda_device)
    states = lo.init_state_batched(cfg, 3, device=cuda_device)
    from vil_fusion_tpu_torch.utils import graphs

    for f in range(4):
        before = kc.knn_grouped.launches
        prev = states
        states, out = lo.odometry_step_batched(states, pts[f], val[f], cfg, frame_count=f)
        batched = kc.knn_grouped.launches - before
        for s in range(3):
            before, n_cap = kc.knn_grouped.launches, len(graphs.captures)
            _, o = lo.odometry_step(lo.MapState(*(a[s] for a in prev)), pts[f, s], val[f, s], cfg,
                                    frame_count=f)
            single = kc.knn_grouped.launches - before
            if len(graphs.captures) > n_cap:  # the step's graph captured: its warm-up calls
                single //= 1 + graphs.captures[-1]["warmup_calls"]  # launched as much each
            assert batched == single
            for a, b in zip(out, o):
                torch.testing.assert_close(a[s], b, atol=1e-4, rtol=0)


def _clustered(nq, nd, seed, n_centers=40):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (n_centers, 3))
    db = (centers[rng.integers(0, n_centers, nd)] + rng.normal(0, 2.0, (nd, 3))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, nq)] + rng.normal(0, 2.0, (nq, 3))).astype(np.float32)
    return q, db, rng.random(nd) > 0.1


@pytest.mark.parametrize("nq,nd,k,db_tile,presort", [
    (2048, 65536, 5, 128, True),  # edge association, 4x map, presorted as in scan_to_map
    (8192, 131072, 5, 128, True),  # surf association, 4x map
    (3000, 20000, 5, 128, False),  # ragged sizes, the wrapper sorts
    (300, 3000, 3, 256, False),  # wider database tile
    (130, 2000, 8, 128, False),
] + [(nq, 20001, k, 128, presort)  # few and ragged queries, a database of no whole tiles
     for nq in (1, 127, 129, 3000) for k in (1, 4, 8) for presort in (True, False)])
def test_cuda_sparse_kernel_matches_plain(cuda_device, nq, nd, k, db_tile, presort):
    """K3 against its plain version with the same tiles: distances equal
    bit for bit on every row (same skip rule, same rounding), indices equal
    on unambiguous rows, index 0 where missing; inside the radius equal to
    the plain exact search in the difference form; one launch counted, and
    the kernels the call enqueues are those of the plan (two Morton-key
    kernels a side the wrapper sorts)."""
    from vil_fusion_tpu_torch.ops import knn as knn_plain

    q, db, v = (torch.from_numpy(x).to(cuda_device) for x in _clustered(nq, nd, nq + nd))
    if presort:
        qp, dp = knn_plain.morton_sort(q), knn_plain.morton_sort(db, v)
        q, db, v = q[qp].contiguous(), db[dp].contiguous(), v[dp].contiguous()
    kw = dict(radius=3.0, db_tile=db_tile, q_sorted=presort, db_sorted=presort)
    before, before_kernels = kc.knn_sparse.launches, kc.kernels_enqueued()
    d, i = kc.knn_sparse(q, db, v, k=k, **kw)
    assert kc.knn_sparse.launches == before + 1 and kc.knn_sparse.last_call == (nq, nd, k)
    sm_count = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert kc.kernels_enqueued() - before_kernels \
        == kc.sparse_plan(nq, nd, sm_count, db_tile).kernels + (0 if presort else 4)
    d_p, i_p = kc.knn_sparse_plain(q, db, v, k=k, q_tile=128, **kw)
    d_m, _ = kc.knn_sparse_plain(q, db, v, k=k + 1, q_tile=128, **kw)
    torch.cuda.synchronize()
    assert torch.equal(d, d_p)
    rows = _margin_rows(d_m, k)
    assert torch.equal(i[rows], i_p[rows])
    assert (i[~torch.isfinite(d)] == 0).all() and v[i[torch.isfinite(d)].long()].all()
    d_x, i_x = kc.knn_exact_plain(q, db, v, k=k, form="diff")
    d_x1, _ = kc.knn_exact_plain(q, db, v, k=k + 1, form="diff")
    gate = d_x[:, -1] < 9.0
    assert gate.any() and torch.equal(gate, d[:, -1] < 9.0)
    assert torch.equal(d[gate], d_x[gate])
    clear = gate & _margin_rows(d_x1, k)
    assert torch.equal(i[clear], i_x[clear])


def _tied(nq, nd, seed):
    """_clustered on a 0.25 m grid with duplicated database points and
    queries on database points: exact ties."""
    q, db, v = _clustered(nq, nd, seed)
    rng = np.random.default_rng(seed + 1)
    db = np.round(db * 4) / 4
    db[rng.integers(0, nd, nd // 5)] = db[rng.integers(0, nd, nd // 5)]
    q = np.round(q * 4) / 4
    q[: nq // 4] = db[rng.integers(0, nd, nq // 4)]
    return q.astype(np.float32), db.astype(np.float32), v


@pytest.mark.parametrize("case,nq,nd,radius", [
    ("tied", 1, 1000, 3.0), ("tied", 127, 1000, 3.0), ("tied", 129, 20001, 3.0),
    ("tied", 3000, 20001, 3.0),
    ("all invalid", 300, 5000, 3.0),
    ("tied", 500, 6000, 0.0),  # radius 0
    ("tied", 300, 6000, 1e4),  # every block near
    ("clustered", 3000, 20000, 12.0),  # long near lists
])
@pytest.mark.parametrize("presort", [True, False])
def test_cuda_sparse_rows_exact(cuda_device, case, nq, nd, radius, presort):
    """K3 on every row, for k = 1..8: distances and indices equal bit for bit
    to the plain search written with ties to the lower index
    (tests/torch_sparse_reference.py, which orders a row by (distance,
    index) as the kernels do), distances equal to the plain version's on
    every row, and inside the radius equal to the plain exact search
    (difference form). The plan splits these tiles over 1 to 20 blocks, so
    the last block's merge of the split is held too."""
    from torch_sparse_reference import lex_reference

    data = _clustered(nq, nd, nq + nd) if case == "clustered" else _tied(nq, nd, nq + nd)
    q, db, v = (torch.from_numpy(x).to(cuda_device) for x in data)
    if case == "all invalid":
        v = torch.zeros_like(v)
    if presort:
        qp, dp = kc.morton_sort(q), kc.morton_sort(db, v)
        q, db, v = q[qp].contiguous(), db[dp].contiguous(), v[dp].contiguous()
    kw = dict(q_sorted=presort, db_sorted=presort)
    for k in range(1, 9):
        d, i = kc.knn_sparse(q, db, v, k=k, radius=radius, **kw)
        d_l, i_l = lex_reference(q, db, v, k, radius, presort, presort)
        d_p, _ = kc.knn_sparse_plain(q, db, v, k=k, radius=radius, q_tile=128, db_tile=128, **kw)
        torch.cuda.synchronize()
        assert torch.equal(d, d_l) and torch.equal(i, i_l), f"k={k}"
        assert torch.equal(d, d_p), f"k={k}"
        if case == "all invalid":
            assert torch.isinf(d).all() and (i == 0).all()
            continue
        d_x, _ = kc.knn_exact_plain(q, db, v, k=k, form="diff")
        gate = d_x[:, -1] < radius ** 2
        assert torch.equal(gate, d[:, -1] < radius ** 2) and torch.equal(d[gate], d_x[gate])


@pytest.mark.parametrize("n,masked", [(1, True), (1000, True), (1000, False), (131072, True),
                                      (65537, False), (5000, "none valid")])
def test_cuda_morton_keys_match_plain(cuda_device, n, masked):
    """The Morton-key kernels against the plain keys on the card, bit for
    bit, and the sort built on them against the plain sort: the same
    permutation; one launch counted, two kernels enqueued. A cell that is
    not a power of two raises (the plain CUDA keys multiply by its
    reciprocal, the kernel divides)."""
    from vil_fusion_tpu_torch.ops import knn as knn_plain

    rng = np.random.default_rng(n)
    pts = torch.from_numpy(rng.uniform(-80, 2200, (n, 3)).astype(np.float32)).to(cuda_device)
    valid = None
    if masked:
        valid = torch.from_numpy(rng.random(n) > (1.1 if masked == "none valid" else 0.3))
        valid = valid.to(cuda_device)
    before, before_kernels = kc.morton_keys.launches, kc.kernels_enqueued()
    keys = kc.morton_keys(pts, valid)
    assert kc.morton_keys.launches == before + 1 and kc.kernels_enqueued() - before_kernels == 2
    assert torch.equal(keys, knn_plain.morton_keys(pts, valid))
    assert torch.equal(kc.morton_sort(pts, valid), knn_plain.morton_sort(pts, valid))
    with pytest.raises(ValueError, match="power of two"):
        kc.morton_keys(pts, valid, cell=1.5)


def test_cuda_dispatcher_routes(cuda_device):
    """On the card `knn(radius=...)` launches K3 whatever `approx` says, and
    never K1 on sorted inputs (q_sorted / db_sorted without radius go to
    K2); the difference form reaches K1/K2 through `form`; K3 refuses tiles
    its kernel does not take; an all-invalid database answers inf / 0."""
    from vil_fusion_tpu_torch.ops import knn as knn_plain

    q, db, v = (torch.from_numpy(x).to(cuda_device) for x in _clustered(500, 6000, 3))
    dp = knn_plain.morton_sort(db, v)
    sdb, sv = db[dp].contiguous(), v[dp].contiguous()
    n1, n2, n3 = kc.knn_grouped.launches, kc.knn_exact.launches, kc.knn_sparse.launches
    d_s, _ = kc.knn(q, sdb, sv, k=5, radius=3.0, approx=True, db_sorted=True)
    assert (kc.knn_grouped.launches, kc.knn_exact.launches, kc.knn_sparse.launches) \
        == (n1, n2, n3 + 1)
    d_x, _ = kc.knn(q, sdb, sv, k=5, approx=True, db_sorted=True)
    assert (kc.knn_grouped.launches, kc.knn_exact.launches) == (n1, n2 + 1)
    gate = d_x[:, -1] < 9.0
    assert gate.sum() > 20
    np.testing.assert_allclose(d_s[gate].cpu().numpy(), d_x[gate].cpu().numpy(), rtol=1e-4,
                               atol=1e-3)  # difference form against expanded form
    kc.knn(q, db, v, k=5, approx=True, form="diff")
    assert kc.knn_grouped.launches == n1 + 1 and kc.knn_grouped.launches_diff >= 1
    with pytest.raises(ValueError, match="q_tile"):
        kc.knn_sparse(q, db, v, k=5, q_tile=64)
    with pytest.raises(ValueError, match="form"):
        kc.knn(q, db, v, k=5, form="packed")
    d, i = kc.knn(q, db, torch.zeros_like(v), k=3, radius=2.0)
    assert torch.isinf(d).all() and (i == 0).all()


def test_cuda_kernel_edge_cases(cuda_device):
    """All-invalid database and fewer valid points than k, on the card; k
    beyond the kernels' register lists is refused."""
    q = torch.zeros((70, 3), device=cuda_device)
    for kern in (kc.knn_grouped, kc.knn_exact):
        d, i = kern(q, torch.ones((500, 3), device=cuda_device),
                    torch.zeros(500, dtype=torch.bool, device=cuda_device), k=3)
        assert torch.isinf(d).all() and (i == 0).all()
        valid = torch.zeros(600, dtype=torch.bool, device=cuda_device)
        valid[5] = valid[17] = True
        d, i = kern(q[:8].contiguous(), torch.ones((600, 3), device=cuda_device), valid, k=4)
        assert (torch.isfinite(d).sum(1) == 2).all()
        assert set(i[0, :2].tolist()) == {5, 17}
    with pytest.raises(ValueError):
        kc.knn_exact(q, q, torch.ones(70, dtype=torch.bool, device=cuda_device), k=9)


def test_cuda_slice_matches_cpu(cuda_device):
    """The LiDAR-only pipeline on the card against the same pipeline on the
    CPU (8 quantized 16-ring scans, small maps): positions within 0.02 m per
    frame (f32 sums in other orders, amplified along the registration
    chain), the same keyframes, both kernels launched, state on the card."""
    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    rig = RigConfig(name="synthetic-16", camera={}, image_height=240, image_width=320,
                    q_ic=np.array([1.0, 0, 0, 0]), t_ic=np.zeros(3), n_scan=16,
                    lidar_fov_up=15.0, lidar_fov_down=-25.0, lidar_min_range=1.0,
                    lidar_max_range=80.0)
    kw = dict(odom_overrides=dict(edge_map_cap=4096, surf_map_cap=8192, edge_cap=512,
                                  surf_cap=2048),
              gf_cfg=gf.GlobalFusionConfig(node_capacity=64, loop_capacity=8,
                                           cloud_capacity=512, submap_half_span=3),
              scan_quant=0.0025)
    pipes = [VILFusionPipeline(rig, mode="lidar", device=d, **kw) for d in ("cpu", cuda_device)]
    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=2.0))
    k1 = kc.knn_grouped.launches
    for i in range(8):
        t = 1.0 + 0.1 * i
        pts, val = sim.simulate_lidar_scan(scene, traj.rotation(t),
                                           traj.position(t) + np.array([0, 0, 1.5]),
                                           n_scan=16, width=900, fov_up_deg=15.0,
                                           fov_down_deg=-25.0, range_noise=0.01, seed=i)
        for p in pipes:
            p.push_scan(t, pts.copy(), val.copy())
    k2 = kc.knn_exact.launches
    pipes[1].fusion.prewarm()
    for p in pipes:
        p.finalize()
    assert kc.knn_grouped.launches - k1 >= 14 and kc.knn_exact.launches > k2
    cpu, gpu = (np.stack(p.outputs.lidar_p) for p in pipes)
    assert np.isfinite(gpu).all() and np.abs(gpu - cpu).max() < 0.02
    assert pipes[0].fusion.n_kf == pipes[1].fusion.n_kf
    assert all(x.is_cuda for x in list(pipes[1].lidar_state) + list(pipes[1].fusion.graph))


LAP_RADIUS, LAP_SPEED = 12.0, 6.0  # m, m/s: 0.6 m a scan, 126 scans a lap
LAP_SCANS = 150  # the lap and 24 scans past its start: 12 loop queries on the revisit


def _lap_pipelines(device):
    """The LiDAR-only pipeline of test_cuda_slice_matches_cpu on a 12-m
    circuit: a keyframe every 1 m, so every second scan (dp 1.2 m against
    0.6 m on the scan between: far from the 1-m gate either way; 5.7 deg of
    yaw, under the 10-deg gate). The ScanContext database's last 30
    keyframes are excluded, so keyframe 63, back at the start, is the first
    that can match. The 16-ring scans' clouds are sparse: true revisits fit at
    0.2-1.2 (mean squared metres), so the fitness gate is 2.5."""
    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    rig = RigConfig(name="synthetic-16", camera={}, image_height=240, image_width=320,
                    q_ic=np.array([1.0, 0, 0, 0]), t_ic=np.zeros(3), n_scan=16,
                    lidar_fov_up=15.0, lidar_fov_down=-25.0, lidar_min_range=1.0,
                    lidar_max_range=80.0)
    cfg = gf.GlobalFusionConfig(keyframe_dist=1.0, icp_fitness_max=2.5, node_capacity=128,
                                loop_capacity=32, cloud_capacity=512, submap_half_span=3)
    return VILFusionPipeline(
        rig, mode="lidar", device=device, gf_cfg=cfg, scan_quant=0.0025,
        odom_overrides=dict(edge_map_cap=4096, surf_map_cap=8192, edge_cap=512, surf_cap=2048))


def _lap_scans():
    from vil_fusion_tpu_torch.runtime import sim

    scene = sim.urban_block_scene(LAP_RADIUS)
    traj = sim.LoopTrajectory(radius=LAP_RADIUS, period=2 * np.pi * LAP_RADIUS / LAP_SPEED,
                              speed_mod=0.0)
    for i in range(LAP_SCANS):
        t = 1.0 + 0.1 * i
        pts, val = sim.simulate_lidar_scan(scene, traj.rotation(t),
                                           traj.position(t) + np.array([0, 0, 1.5]),
                                           n_scan=16, width=900, fov_up_deg=15.0,
                                           fov_down_deg=-25.0, range_noise=0.01, seed=i)
        yield t, pts, val


@pytest.fixture(scope="module")
def lap_runs(tmp_path_factory):
    """The lap through the pipeline on the card (scan after scan, nothing
    waiting between them: its fusion stream runs beside the odometry), with
    a checkpoint of its global fusion saved right after the first keyframe
    that dispatched an ICP verification and the state the fusion's stream
    left then; the lap on the card with global fusion on the caller's
    stream (no stream of its own: every keyframe's work in front of the next
    scan's odometry); the lap on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kNN kernels have no CPU mode")
    from vil_fusion_tpu_torch.runtime import checkpoint
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    scans = list(_lap_scans())
    dev = torch.device("cuda", 0)
    gpu, inline = _lap_pipelines(dev), _lap_pipelines(dev)
    inline.fusion.fence()
    inline.fusion.stream = None
    fusion, dispatched = gpu.fusion, []
    dispatch = fusion._dispatch_icp

    def record_dispatch(i, j, yaw0):
        dispatched.append((i, j))
        return dispatch(i, j, yaw0)

    fusion._dispatch_icp = record_dispatch
    path = str(tmp_path_factory.mktemp("lap") / "fusion.npz")
    saved = None
    busy0 = GLOBAL_TIMERS.counters["global_fusion.stream_busy"]
    for k, (t, pts, val) in enumerate(scans):
        gpu.push_scan(t, pts, val)
        if k == 8:  # the ICP and relaxation graphs captured before the revisit
            fusion.prewarm()
            fusion.prewarm()
            dispatched.clear()
        if saved is None and dispatched:
            checkpoint.save_global_fusion(fusion, path)
            fusion.fence()
            saved = dict(graph=[x.clone() for x in fusion.graph],
                         scdb=[x.clone() for x in fusion.scdb], clouds=fusion.clouds.clone(),
                         cloud_valid=fusion.cloud_valid.clone(), n_kf=fusion.n_kf,
                         loops=list(fusion.loops_found))
    busy = GLOBAL_TIMERS.counters["global_fusion.stream_busy"] - busy0
    gpu.finalize()
    for t, pts, val in scans:
        inline.push_scan(t, pts, val)
    inline.finalize()
    cpu = _lap_pipelines("cpu")
    for t, pts, val in scans:
        cpu.push_scan(t, pts, val)
    cpu.finalize()
    return dict(gpu=gpu, inline=inline, cpu=cpu, busy=busy, path=path, saved=saved)


def test_cuda_lap_loops_match_cpu(lap_runs):
    """The lap's global fusion on its own stream against the same on the
    caller's stream and against the CPU's, which resolves every loop query
    at its keyframe: the same keyframes and the same accepted loops after
    finalize(); the same odometry bit for bit as on the caller's stream
    (the fusion stream's graphs, replayed beside the odometry's, write
    nothing of it); keyframe poses within 0.05 m of both (a relaxation runs
    at the keyframe whose poll finds a loop's copy landed, which the
    device's timing decides: 0.013 m apart on the card), odometry within
    0.05 m of the CPU's (float32 sums that round apart on the two devices,
    amplified along 150 registrations: 0.035 m by the lap's end with or
    without the fusion stream; test_cuda_slice_matches_cpu holds 8 scans
    to 0.02 m). The stream was found busy at some keyframe, and never more
    than BACKLOG keyframes were in flight."""
    from vil_fusion_tpu_torch.models import global_fusion as gf

    gpu, inline, cpu = lap_runs["gpu"], lap_runs["inline"], lap_runs["cpu"]
    assert gpu.fusion.n_kf == inline.fusion.n_kf == cpu.fusion.n_kf >= 70
    loops = set(cpu.fusion.loops_found)
    assert set(gpu.fusion.loops_found) == set(inline.fusion.loops_found) == loops
    assert len(loops) >= 5
    o_gpu, o_inline, o_cpu = (np.stack(p.outputs.lidar_p) for p in (gpu, inline, cpu))
    p_gpu, p_inline, p_cpu = (p.fusion.poses()[1] for p in (gpu, inline, cpu))
    assert np.array_equal(o_gpu, o_inline)
    assert np.abs(p_gpu - p_inline).max() < 0.05
    assert np.isfinite(o_gpu).all() and np.abs(o_gpu - o_cpu).max() < 0.05
    assert np.isfinite(p_gpu).all() and np.abs(p_gpu - p_cpu).max() < 0.05
    assert lap_runs["busy"] > 0
    assert 1 <= gpu.fusion.max_in_flight <= gf.GlobalFusion.BACKLOG
    assert not gpu.fusion._pending_sc and not gpu.fusion._pending_icp


def test_cuda_checkpoint_after_icp_dispatch(lap_runs):
    """A checkpoint saved right after a keyframe that dispatched an ICP
    verification (its keyframe program, ICP and any relaxation still on the
    fusion stream) holds the state that stream left: loaded into a fresh
    GlobalFusion on the card, graph, database and clouds equal it bit for
    bit."""
    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.runtime import checkpoint

    saved = lap_runs["saved"]
    assert saved is not None
    f = gf.GlobalFusion(lap_runs["gpu"].fusion.cfg, device=torch.device("cuda", 0))
    checkpoint.load_global_fusion(f, lap_runs["path"])
    assert f.n_kf == saved["n_kf"] and f.loops_found == saved["loops"]
    f.fence()
    for a, b in ((f.graph, saved["graph"]), (f.scdb, saved["scdb"])):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(f.clouds, saved["clouds"])
    assert torch.equal(f.cloud_valid, saved["cloud_valid"])


def test_cuda_front_end_matches_cpu(cuda_device):
    """vil_front_end on the card against the same function on the CPU over 3
    small frames (16-ring scans, 160 x 120 images; RANSAC off, because with
    40 tracks its hypotheses' inlier counts nearly tie and the winner then
    depends on the device's rounding): feature ids equal, pixels within
    0.05 px, lidar pose within 5e-3 m, depth flags equal on 95% of the
    features; K1 and K2 (k=3) launched, K2 once a frame (replays of the
    glue + depth association graph) besides a capture's warm-up calls."""
    from vil_fusion_tpu_torch.models import lidar_odometry as lo
    from vil_fusion_tpu_torch.models import tracker as trk
    from vil_fusion_tpu_torch.runtime import pipeline as pl
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig

    H, W, F = 120, 160, 100.0
    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    rig = RigConfig(
        name="small", camera=dict(model_type="PINHOLE",
                                  projection_parameters=dict(fx=F, fy=F, cx=W / 2, cy=H / 2),
                                  distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=H, image_width=W, q_ic=sim.R_to_q(r_bc), t_ic=np.zeros(3),
        q_cl=sim.R_to_q(r_bc.T), t_cl=np.zeros(3), max_cnt=40, min_dist=12, n_scan=16,
        lidar_fov_up=15.0, lidar_fov_down=-15.0, lidar_min_range=1.0, lidar_max_range=80.0)
    from vil_fusion_tpu_torch.utils import graphs

    odom = dict(edge_map_cap=2048, surf_map_cap=4096, edge_cap=256, surf_cap=1024)
    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=4.0))
    results = []
    k1, k2, n_cap = kc.knn_grouped.launches, kc.knn_exact.launches, len(graphs.captures)
    for dev in ("cpu", cuda_device):
        fe = pl.front_end_config(rig, f_cap=64, odom_overrides=odom, device=dev)
        fe = fe._replace(tcfg=fe.tcfg._replace(ransac=False))
        ts = trk.init_tracker(H, W, fe.tcfg, device=dev)
        ls = lo.init_state(fe.lcfg, device=dev)
        outs = []
        for k in range(3):
            t = 1.0 + 0.1 * k
            R, p = traj.rotation(t), traj.position(t) + np.array([0, 0, 1.5])
            img = sim.render_camera_image(scene, R @ r_bc, p, F, F, W / 2, H / 2, H, W)
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            pts, val = sim.simulate_lidar_scan(scene, R, p, n_scan=16, width=900,
                                               fov_up_deg=15.0, fov_down_deg=-15.0, seed=k)
            ts, ls, out = pl.vil_front_end(ts, ls, torch.from_numpy(img).to(dev),
                                           torch.from_numpy(pts).to(dev),
                                           torch.from_numpy(val).to(dev), t, fe, frame_index=k)
            outs.append({n: v.cpu().numpy() for n, v in out.items()})
        results.append(outs)
    # one K2 a frame on the card, and one in each warm-up call of the glue +
    # depth association graph where it was captured here
    warm = sum(c["warmup_calls"] for c in graphs.captures[n_cap:] if c["name"] == "glue_depth")
    assert kc.knn_grouped.launches - k1 >= 2 and kc.knn_exact.launches - k2 == 3 + warm
    assert kc.knn_exact.last_call == (64, 16 * 900, 3)
    for a, b in zip(*results):
        np.testing.assert_array_equal(b["ids"], a["ids"])
        v = a["valid"]
        np.testing.assert_allclose(b["uv"][v], a["uv"][v], atol=0.05)
        np.testing.assert_allclose(b["lidar_p"], a["lidar_p"], atol=5e-3)
        assert (np.sign(b["depth"][v]) == np.sign(a["depth"][v])).mean() >= 0.95


def _estimator_bundles(n_frames, seed=0):
    """process_frame inputs along sim.Trajectory (port-only: 200 Hz IMU,
    40 budgeted landmark observations a frame, lidar depth on 60% of them,
    exact lidar relative poses) and the initial ground-truth state."""
    from vil_fusion_tpu_torch.ops import lie
    from vil_fusion_tpu_torch.runtime import sim

    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    rng = np.random.default_rng(seed)
    traj = sim.Trajectory()
    world = sim.LandmarkWorld(n=400, seed=seed)
    out, prev = [], set()
    for i in range(n_frames):
        t = 1.0 + 0.1 * i
        acc = gyr = np.zeros((0, 3))
        dts = np.zeros((0,))
        if i:
            ts_i, acc, gyr = sim.simulate_imu(traj, t - 0.1, t, 200.0)
            dts = np.diff(ts_i)
        ids, xy, z = sim.project_landmarks(world, traj.rotation(t), traj.position(t), R_bc=r_bc)
        order = [k for k, i_ in enumerate(ids) if i_ in prev] + \
            [k for k, i_ in enumerate(ids) if i_ not in prev]
        keep = np.zeros(len(ids), bool)
        keep[order[:40]] = True
        ids, xy, z = ids[keep], xy[keep], z[keep]
        prev = set(ids.tolist())
        kw = dict(obs_depth=np.where(rng.random(len(ids)) < 0.6, z, 0.0))
        if i:
            (qa, pa), (qb, pb) = traj.pose(t - 0.1), traj.pose(t)
            f = dict(dtype=torch.float32)
            qr, pr = lie.pose_between((torch.tensor(qa, **f), torch.tensor(pa, **f)),
                                      (torch.tensor(qb, **f), torch.tensor(pb, **f)))
            kw.update(lidar_q_rel=qr.numpy(), lidar_p_rel=pr.numpy())
        out.append(((acc, gyr, dts, ids, xy), kw))
    q0, p0 = traj.pose(1.0)
    return out, (p0, q0, traj.velocity(1.0)), sim.R_to_q(r_bc)


def test_cuda_schur_solve_cholesky_fallback(cuda_device):
    """schur_solve on the card: on a damped SPD system it agrees with the CPU
    (rtol 1e-3 of the step's largest entry: f32 factorizations of another
    library), and on a system whose pose block is not positive definite the
    Cholesky failure is caught without a host read or an exception and the
    LU step of the regularized system is taken, finite and as on the CPU."""
    from vil_fusion_tpu_torch.models import ba

    rng = np.random.default_rng(0)
    A = rng.normal(size=(300, ba.D)).astype(np.float32)
    H = A.T @ A
    Hpd = rng.normal(0, 0.1, (ba.D, 40)).astype(np.float32)
    Hd = rng.uniform(1.0, 5.0, 40).astype(np.float32)
    b = rng.normal(size=ba.D).astype(np.float32)
    bd = rng.normal(size=40).astype(np.float32)
    bad = H.copy()
    bad[20, 20] = -50.0 * np.abs(np.diag(H)).max()
    for Hm in (H, bad):
        outs = []
        for dev in ("cpu", cuda_device):
            s = ba.System(*(torch.from_numpy(x).to(dev) for x in (Hm, b, Hpd, Hd, bd)),
                          torch.zeros((), device=dev))
            d, dd = ba.schur_solve(s, torch.tensor(1e-4, device=dev), ba.BAConfig())
            outs.append((d.cpu().numpy(), dd.cpu().numpy()))
        for a, c in zip(*outs):
            assert np.isfinite(c).all()
            np.testing.assert_allclose(c, a, atol=1e-3 * np.abs(a).max())


def test_cuda_fused_step_matches_cpu(cuda_device):
    """One estimator.fused_full_step on the card against the same step on
    the CPU from the same steady state (an oracle-initialized estimator run
    on the CPU over K + 2 frames, carried with utils/state_io): pose within
    1e-3 m, the same keyframe decision, no failure; every state on the
    card."""
    from vil_fusion_tpu_torch.models import estimator as est_mod
    from vil_fusion_tpu_torch.utils import state_io

    bundles, (p0, q0, v0), qic = _estimator_bundles(est_mod.K + 3)
    cfg = est_mod.EstimatorConfig(f_cap=48, obs_cap=64)
    cpu = est_mod.VILEstimator(cfg, device="cpu")
    cpu.set_extrinsics(qic=qic, tic=np.zeros(3))
    cpu.set_initial_state(p=p0, q=q0, v=v0)
    for args, kw in bundles[:-1]:
        cpu.process_frame(*args, **kw)
    gpu = est_mod.VILEstimator(cfg, device=cuda_device)
    state_io.estimator_load(gpu, state_io.estimator_to_numpy(cpu))
    args, kw = bundles[-1]
    out_c = cpu.process_frame(*args, **kw)
    out_g = gpu.process_frame(*args, **kw)
    assert gpu.fused_steps == 1 and bool(gpu.last_is_key) == bool(cpu.last_is_key)
    assert not gpu.failed and not cpu.failed
    np.testing.assert_allclose(out_g[0], out_c[0], atol=1e-3)
    np.testing.assert_allclose(out_g[1], out_c[1], atol=1e-3)
    assert all(x.is_cuda for x in list(gpu.window) + list(gpu.feats) + list(gpu.pre))


def test_cuda_deferred_pipeline_matches_cpu(cuda_device):
    """VILFusionPipeline(mode="vil", sync_depth=2) on the card against the
    same pipeline on the CPU (tests/test_torch_deferred.py's small rig: 160
    x 120 images, quantized 16-ring scans, oracle state, 14 frames, the
    tracker's RANSAC off): the steady frames issued and completed through
    the pinned host copies, lidar and estimator positions within 0.05 m of
    the CPU's (float32 sums in other orders along 14 registrations of
    16-ring scans at 4 m/s: test_torch_vil_pipeline.py's bound between the
    packages for the same reason), the same keyframes, no restart, K2
    launched."""
    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    H, W, F = 120, 160, 100.0
    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    rig = RigConfig(
        name="small", camera=dict(model_type="PINHOLE",
                                  projection_parameters=dict(fx=F, fy=F, cx=W / 2, cy=H / 2),
                                  distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=H, image_width=W, q_ic=sim.R_to_q(r_bc), t_ic=np.array([0.1, 0.0, 0.05]),
        q_cl=sim.R_to_q(r_bc.T), t_cl=np.array([0.0, -0.1, 0.02]), max_cnt=40, min_dist=12,
        n_scan=16, lidar_fov_up=15.0, lidar_fov_down=-15.0, lidar_min_range=1.0,
        lidar_max_range=80.0, f_threshold=3.0)
    pipes = []
    for dev in ("cpu", cuda_device):
        p = VILFusionPipeline(
            rig, mode="vil", f_cap=64, sync_depth=2, scan_quant=0.0025, device=dev,
            odom_overrides=dict(edge_map_cap=2048, surf_map_cap=4096, edge_cap=256,
                                surf_cap=1024, approx_knn=False),
            gf_cfg=gf.GlobalFusionConfig(node_capacity=64, loop_capacity=8, cloud_capacity=512,
                                         submap_half_span=3))
        p.tracker_cfg = p.tracker_cfg._replace(ransac=False)
        p.fe = p.fe._replace(tcfg=p.tracker_cfg)
        pipes.append(p)
    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=4.0))
    q0, p0 = traj.pose(1.0)
    for p in pipes:
        p.estimator.set_initial_state(p=p0 + np.array([0, 0, 1.5]), q=q0, v=traj.velocity(1.0))
    k1, k2 = kc.knn_grouped.launches, kc.knn_exact.launches
    for i in range(14):
        t = 1.0 + 0.1 * i
        R, pos = traj.rotation(t), traj.position(t) + np.array([0, 0, 1.5])
        img = (np.clip(sim.render_camera_image(scene, R @ r_bc, pos, F, F, W / 2, H / 2, H, W),
                       0, 1) * 255).astype(np.uint8)
        pts, val = sim.simulate_lidar_scan(scene, R, pos, n_scan=16, width=900, fov_up_deg=15.0,
                                           fov_down_deg=-15.0, max_range=80.0, seed=i)
        imu = sim.simulate_imu(traj, t - 0.1, t, 200.0) if i else None
        for p in pipes:
            if imu is not None:
                p.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
            p.push_scan(t, pts.copy(), val.copy())
            p.push_image(t, img)
    for p in pipes:
        assert p.finalize() is not None
    assert kc.knn_exact.launches - k2 >= 14 and kc.knn_grouped.launches - k1 == 0
    cpu, gpu = pipes
    assert gpu.estimator.fused_steps == cpu.estimator.fused_steps == 14 - 10
    assert len(gpu.outputs.ts) == len(cpu.outputs.ts) == 14 and gpu.restarts == cpu.restarts == 0
    for k in ("lidar_p", "vio_p"):
        a, b = (np.stack(getattr(p.outputs, k)) for p in (gpu, cpu))
        print(f"{k}: card against CPU, max |difference| {np.abs(a - b).max():.4g} m")
        np.testing.assert_allclose(a, b, atol=0.05)
    assert gpu.fusion.n_kf == cpu.fusion.n_kf
    assert all(x.is_cuda for x in list(gpu.estimator.window) + list(gpu.tracker_state))


def test_cuda_torch_raycast_matches_cpu(cuda_device):
    """sim.TorchRaycast on the card against itself on the CPU, with
    tests/test_sim.py's gates: hit agreement > 99.5% and ranges within
    1e-3 m on random rays, scans within 2e-3 m, uint8 images within +-1
    grey level on > 99.5% of pixels; the grids stay on the card."""
    from vil_fusion_tpu_torch.runtime import sim

    scene = sim.urban_block_scene(20.0, pillar_step_deg=10.0, box_step_deg=15.0)
    gpu, cpu = (sim.TorchRaycast(scene, device=d) for d in (cuda_device, "cpu"))
    rng = np.random.default_rng(3)
    d = rng.normal(size=(20000, 3))
    d[:, 2] *= 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.array([0.0, 2.0, 1.4]), d.shape)
    t_g, t_c = gpu.raycast(o, d), cpu.raycast(o, d)
    hit_g, hit_c = np.isfinite(t_g), np.isfinite(t_c)
    assert (hit_g == hit_c).mean() > 0.995 and (hit_g & hit_c).sum() > 5000
    assert np.abs(t_g[hit_g & hit_c] - t_c[hit_g & hit_c]).max() < 1e-3
    R, p = sim._ypr_to_R(0.4, 0.02, -0.01), np.array([2.0, 3.0, 1.5])
    scan = dict(n_scan=64, width=1800, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0)
    (pg, vg), (pc, vc) = (sim.simulate_lidar_scan(rc, R, p, **scan) for rc in (gpu, cpu))
    assert (vg == vc).mean() > 0.995 and np.abs(pg[vg & vc] - pc[vg & vc]).max() < 2e-3
    cam = (718.856, 718.856, 607.19, 185.22, 370, 1226)
    ig, ic = (rc.render_image_u8(R, p, *cam) for rc in (gpu, cpu))
    assert ig.shape == (370, 1226) and ig.dtype == np.uint8
    assert (np.abs(ig.astype(int) - ic.astype(int)) <= 1).mean() > 0.995
    assert all(g.is_cuda for g, _ in gpu._grids.values())


def test_cuda_replay_kitti_lidar(cuda_device, tmp_path):
    """A 6-frame simulator KITTI odometry sequence on disk through replay
    (prefetch=True: the native ring bus) into a mode "lidar" pipeline on the
    card: every event delivered, nothing dropped, K1 launched, the state on
    the card, positions within 0.02 m of the same replay on the CPU and
    within 0.1 m of the truth."""
    from torch_dataset_fixtures import write_sim_kitti

    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.runtime import datasets, sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    gt = write_sim_kitti(tmp_path, sim, datasets, 6)
    rig = RigConfig(name="synthetic-16", camera={}, image_height=240, image_width=320,
                    q_ic=np.array([1.0, 0, 0, 0]), t_ic=np.zeros(3), n_scan=16,
                    lidar_fov_up=15.0, lidar_fov_down=-25.0, lidar_min_range=1.0,
                    lidar_max_range=80.0)
    out = {}
    k1 = kc.knn_grouped.launches
    for dev in ("cpu", cuda_device):
        pipe = VILFusionPipeline(
            rig, mode="lidar", device=dev,
            odom_overrides=dict(edge_map_cap=4096, surf_map_cap=8192, edge_cap=512,
                                surf_cap=2048),
            gf_cfg=gf.GlobalFusionConfig(node_capacity=64, loop_capacity=8, cloud_capacity=512,
                                         submap_half_span=3))
        stats = {}
        datasets.replay(pipe, datasets.KittiOdometry(str(tmp_path), "00").events(),
                        prefetch=True, stats=stats)
        assert stats["events"] == 6 and stats["dropped"] == 0
        out[str(dev)] = np.stack(pipe.outputs.lidar_p)
    assert kc.knn_grouped.launches - k1 >= 10
    assert all(x.is_cuda for x in list(pipe.lidar_state) + list(pipe.fusion.graph))
    gpu = out[str(cuda_device)]
    assert np.isfinite(gpu).all() and np.abs(gpu - out["cpu"]).max() < 0.02
    assert np.linalg.norm(gpu - gt, axis=1).max() < 0.1


# the eigensolver's tolerances (chip_smoke.py EIGH_*: both float32 solvers
# within ~5 n ulps of max|S| of the exact eigenvalues)
EIGH_TOL_PLAIN, EIGH_TOL_F64, EIGH_TOL_RECON, EIGH_TOL_ORTH = 1e-4, 2e-5, 2e-5, 2e-5


def _eigh_case(n, case, seed):
    rng = np.random.default_rng(seed)
    if case == "full rank":
        A = rng.normal(size=(n + 20, n))
        return A.T @ A
    if case == "rank n/2":
        B = rng.normal(size=(n // 2, n))
        return B.T @ B
    if case == "repeated":
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        return (Q * np.repeat(rng.uniform(1.0, 10.0, (n + 2) // 3), 3)[:n]) @ Q.T
    C = rng.normal(size=(n, n)) * np.exp(rng.uniform(-8.0, 18.0, n))  # "wide range"
    return C.T @ C / n


@pytest.mark.parametrize("case", ["full rank", "rank n/2", "repeated", "wide range"])
@pytest.mark.parametrize("n", [1, 2, 15, 157, 172])
def test_cuda_eigh_matches_plain(cuda_device, n, case):
    """csrc/eigh.cu against torch.linalg.eigh and float64 at the
    estimator's sizes (15 on the warp kernel, 157 on the block kernel), the
    largest it takes (172) and the smallest: eigenvalues ascending, within
    1e-4 of max|S| of torch.linalg.eigh's and 2e-5 of float64's, V diag(S) V^T within
    2e-5 of max|A|, V^T V within 2e-5 of I; one launch counted; the same
    matrices in one batched launch give each one's result bit for bit."""
    from vil_fusion_tpu_torch.ops import linalg
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda

    M = _eigh_case(n, case, n) if n > 2 else np.eye(n) * 3.0 + (n == 2)
    A = torch.tensor(M, dtype=torch.float32, device=cuda_device)
    before = eigh_cuda.eigh.launches
    S, V = linalg.sym_eigh(A)
    assert eigh_cuda.eigh.launches == before + 1
    S0, _ = torch.linalg.eigh(A)
    S64 = np.linalg.eigvalsh(A.double().cpu().numpy())
    smax = np.abs(S64).max()
    assert (S[1:] >= S[:-1]).all()
    assert (S - S0).abs().max().item() <= EIGH_TOL_PLAIN * smax
    assert np.abs(S.double().cpu().numpy() - S64).max() <= EIGH_TOL_F64 * smax
    R = (V * S[None, :]) @ V.T
    assert (R - A).abs().max().item() <= EIGH_TOL_RECON * A.abs().max().item()
    assert (V.T @ V - torch.eye(n, device=cuda_device)).abs().max().item() <= EIGH_TOL_ORTH
    batch = torch.stack([A, A.flip(0).flip(1), 2.0 * A])
    Sb, Vb = eigh_cuda.eigh(batch)
    for b in range(3):
        S1, V1 = eigh_cuda.eigh(batch[b])
        assert torch.equal(Sb[b], S1) and torch.equal(Vb[b], V1)


@pytest.mark.parametrize("case", ["full rank", "rank n/2", "repeated", "wide range"])
@pytest.mark.parametrize("n", [15, 157, 172])
def test_cuda_eigh_matches_mirror(cuda_device, n, case):
    """csrc/eigh.cu against its numpy mirror (tests/torch_eigh_reference.py:
    the same stages in the same precisions, the sums in another order) on
    the same matrix: eigenvalues within 2e-5 of max|S| of the mirror's, the
    kernel's V diag(S) V^T within 2e-5 of max|A| of the mirror's (the
    eigenvectors of a cluster may take another basis), and the work, (QL
    iterations, rotations) or (Jacobi sweeps, rotations), within 25% of the
    mirror's; the launch counted on the kernel of its size."""
    from torch_eigh_reference import eigh as mirror_eigh

    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda

    M = _eigh_case(n, case, n).astype(np.float32)
    A = torch.tensor(M, device=cuda_device)
    stats = torch.zeros(1, eigh_cuda.NSTATS, dtype=torch.int32, device=cuda_device)
    warp0 = eigh_cuda.eigh.launches_warp
    S, V = eigh_cuda.eigh(A, stats=stats)
    assert eigh_cuda.eigh.launches_warp == warp0 + (n <= eigh_cuda.WARP_MAX_N)
    w, Vm, work = mirror_eigh(M)
    S, V = S.double().cpu().numpy(), V.double().cpu().numpy()
    smax = np.abs(w).max()
    assert np.abs(S - w).max() <= EIGH_TOL_F64 * smax
    Vm = Vm.astype(np.float64)
    R, Rm = (V * S) @ V.T, (Vm * w) @ Vm.T
    assert np.abs(R - Rm).max() <= EIGH_TOL_RECON * np.abs(M).max()
    got = stats[0, :2].tolist()
    for g, m in zip(got, work):
        assert abs(g - m) <= 0.25 * m, (got, work)


@pytest.mark.parametrize("n", [15, 157])
def test_cuda_eigh_graph_replay_equals_eager(cuda_device, n):
    """A torch.cuda.CUDAGraph captured around the kernel replays, on a new
    matrix copied into its input, bit for bit what an eager call gives."""
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda

    A = torch.tensor(_eigh_case(n, "full rank", n), dtype=torch.float32, device=cuda_device)
    eigh_cuda.eigh(A)  # build and opt into the shared memory outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        S_g, V_g = eigh_cuda.eigh(A)
    B = torch.tensor(_eigh_case(n, "rank n/2", n + 1), dtype=torch.float32, device=cuda_device)
    A.copy_(B)
    g.replay()
    S, V = eigh_cuda.eigh(B)
    torch.cuda.synchronize()
    assert torch.equal(S_g, S) and torch.equal(V_g, V)


def test_cuda_eigh_refuses(cuda_device):
    """The wrapper raises on what the kernel does not take: float64, n above
    172, a non-square matrix."""
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda

    for bad in (torch.eye(4, dtype=torch.float64, device=cuda_device),
                torch.eye(173, device=cuda_device), torch.ones(3, 4, device=cuda_device)):
        with pytest.raises(ValueError):
            eigh_cuda.eigh(bad)


@pytest.fixture(scope="module")
def gpu_sequence():
    """An oracle-initialized estimator on the card at the deployed width
    (EstimatorConfig defaults, 128 observation slots) over K + 8 frames of
    _estimator_bundles; every fused step recorded (arguments, keywords,
    outputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step runs only on the card")
    from vil_fusion_tpu_torch.models import estimator as est_mod

    bundles, (p0, q0, v0), qic = _estimator_bundles(est_mod.K + 8)
    est = est_mod.VILEstimator(est_mod.EstimatorConfig(), device="cuda")
    est.set_extrinsics(qic=qic, tic=np.zeros(3))
    est.set_initial_state(p=p0, q=q0, v=v0)
    steps, step = [], est_mod.fused_full_step

    def rec(*a, **kw):
        out = step(*a, **kw)
        steps.append((a, kw, out))
        return out

    est_mod.fused_full_step = rec
    try:
        for args, kw in bundles:
            est.process_frame(*args, **kw)
    finally:
        est_mod.fused_full_step = step
    torch.cuda.synchronize()
    return est, steps, bundles


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    return [x]


def _body(a):
    from vil_fusion_tpu_torch.models import estimator as est_mod

    return est_mod._fused_full_step_body(*a[:17], run_ba=a[17], cfg=a[18])


def test_cuda_graph_step_equals_body(gpu_sequence):
    """Every steady step of the sequence (9 frames, both keyframe
    decisions) went through its graph (the first call of the key runs the
    body, the others replay), and each step's outputs equal the eager
    body's on the same inputs bit for bit (the step has no atomics: two
    eager runs are identical); the eigensolver's launches are counted at
    each replay that ran their marginalization path: 2 a step (the taken
    path's 157 x 157 and 15 x 15), settled once the replay's keyframe
    decision has landed on the host, and the conditional node's set kernel
    twice a replay."""
    from vil_fusion_tpu_torch.models import estimator as est_mod
    from vil_fusion_tpu_torch.ops.cuda import cond_cuda, eigh_cuda
    from vil_fusion_tpu_torch.utils import graphs

    est, steps, _ = gpu_sequence
    assert len(steps) == est.fused_steps == 9
    keys = []
    for a, kw, out in steps:
        for x, y in zip(_leaves(out), _leaves(_body(a))):
            assert torch.equal(x, y)
        keys.append(bool(out[5]["is_key"]))
    assert any(keys) and not all(keys)
    graphs.settle(wait=True)
    r0, e0 = graphs.replays.get("fused_full_step", 0), eigh_cuda.eigh.launches
    w0, c0 = eigh_cuda.eigh.launches_warp, cond_cuda.begin.launches
    a, kw, out = steps[-1]
    again = est_mod.fused_full_step(*a, **kw)
    assert graphs.replays["fused_full_step"] == r0 + 1 and cond_cuda.begin.launches == c0 + 2
    assert graphs.settle(wait=True) == 1
    assert eigh_cuda.eigh.launches == e0 + 2
    assert eigh_cuda.eigh.launches_warp == w0 + 1  # the taken path's 15 x 15 Schur block
    for x, y in zip(_leaves(again), _leaves(out)):
        assert torch.equal(x, y)


def test_cuda_graph_after_rebinds(gpu_sequence):
    """Host code rebinds the state between steps (a relocalization's
    apply_drift, set_initial_state, a restart's new estimator): the next
    step's graph replay equals the eager body from the rebound state, bit
    for bit, with no new capture."""
    from vil_fusion_tpu_torch.models import estimator as est_mod
    from vil_fusion_tpu_torch.utils import graphs
    from vil_fusion_tpu_torch.utils import state_io

    est, steps, bundles = gpu_sequence
    n_captures = len(graphs.captures)
    a, kw, _ = steps[-1]
    seg = a[5:]  # the last frame's segment and observations
    yaw = 0.3
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    est.apply_drift(R, np.array([1.0, -2.0, 0.5]))
    fresh = est_mod.VILEstimator(est.cfg, device="cuda")  # a restart's estimator
    state_io.estimator_load(fresh, state_io.estimator_to_numpy(est))
    fresh.set_initial_state(p=np.array([0.5, 0.0, 0.0]), q=np.array([1.0, 0, 0, 0]),
                            v=np.zeros(3))
    for e in (est, fresh):
        args = (e.window, e.feats, e.pre, e.lidar, e.prior) + seg
        out = est_mod.fused_full_step(*args, **kw)
        for x, y in zip(_leaves(out), _leaves(_body(args))):
            assert torch.equal(x, y)
    assert len(graphs.captures) == n_captures


def test_cuda_graph_outputs_not_aliased(gpu_sequence):
    """A step's outputs are fresh tensors: later replays (the frames a
    deferred pipeline has in flight) leave them as they were, and no
    output shares storage with another step's."""
    from vil_fusion_tpu_torch.models import estimator as est_mod

    _, steps, _ = gpu_sequence
    a1, kw, _ = steps[-2]
    a2, _, _ = steps[-1]
    out1 = est_mod.fused_full_step(*a1, **kw)
    snap = [x.clone() for x in _leaves(out1)]
    out2 = est_mod.fused_full_step(*a2, **kw)
    est_mod.fused_full_step(*a1, **kw)
    torch.cuda.synchronize()
    for x, y in zip(_leaves(out1), snap):
        assert torch.equal(x, y)
    ptrs = {x.data_ptr() for x in _leaves(out1) if x.numel()}
    assert not ptrs & {x.data_ptr() for x in _leaves(out2) if x.numel()}


def test_cuda_graph_replay_has_no_sync(gpu_sequence):
    """A replay of the captured step under
    torch.cuda.set_sync_debug_mode("error") raises nothing: it copies its
    inputs, replays and clones its outputs without a host wait."""
    from vil_fusion_tpu_torch.models import estimator as est_mod

    _, steps, _ = gpu_sequence
    a, kw, _ = steps[-1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        est_mod.fused_full_step(*a, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_cuda_marginalization_through_the_kernel(gpu_sequence):
    """The sequence's final window marginalized on the card, both paths:
    every matrix the marginalizations hand the eigensolver (the 15 x 15
    Schur blocks, the 157 x 157 quadratics) through the kernel against
    torch.linalg.eigh and float64 (the tolerances above), and each
    quadratic's factor against it: J^T J within 1e-4 of the largest entry
    of Lam, J^T r0 within 1e-3 of g's (test_quadratic_to_factor_invariants
    of test_torch_marginalization.py), or within twice the distance of the
    factor through torch.linalg.eigh where that is larger (a real window's
    g is not in the numerical range of Lam: the eigenvalues at float32's
    noise floor decide what of g survives, whatever the solver)."""
    from vil_fusion_tpu_torch.models import marginalization as marg
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda

    est, _, _ = gpu_sequence
    mats, quads = [], []
    to_factor = marg._quadratic_to_factor

    def eigh_rec(A):
        mats.append(A)
        return eigh_cuda.eigh(A)

    def factor_rec(Lam, g):
        quads.append((Lam, g))
        return to_factor(Lam, g)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(marg, "sym_eigh", eigh_rec)
        mp.setattr(marg, "_quadratic_to_factor", factor_rec)
        marg.marginalize_old(est.window, est.feats, est.pre, est.lidar, est.prior, est.cfg.ba)
        marg.marginalize_second_new(est.prior, est.window)
    assert sorted(A.shape[0] for A in mats) == [15, 15, 157, 157] and len(quads) == 2
    for A in mats:
        n = A.shape[0]
        S, V = eigh_cuda.eigh(A)
        S64 = np.linalg.eigvalsh(A.double().cpu().numpy())
        smax = np.abs(S64).max()
        assert (S - torch.linalg.eigh(A)[0]).abs().max().item() <= EIGH_TOL_PLAIN * smax
        assert np.abs(S.double().cpu().numpy() - S64).max() <= EIGH_TOL_F64 * smax
        R = (V * S[None, :]) @ V.T
        assert (R - A).abs().max().item() <= EIGH_TOL_RECON * A.abs().max().item()
        assert (V.T @ V - torch.eye(n, device=A.device)).abs().max().item() <= EIGH_TOL_ORTH
    for Lam, g in quads:
        L = (0.5 * (Lam + Lam.T)).double().cpu().numpy()
        gn = g.double().cpu().numpy()
        errs = []
        for solver in (eigh_cuda.eigh, torch.linalg.eigh):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(marg, "sym_eigh", solver)
                J, r0 = to_factor(Lam, g)
            J, r0 = J.double().cpu().numpy(), r0.double().cpu().numpy()
            errs.append((np.abs(J.T @ J - L).max() / np.abs(L).max(),
                         np.abs(J.T @ r0 - gn).max() / np.abs(gn).max()))
        (jj, jr), (jj_p, jr_p) = errs
        assert jj <= max(1e-4, 2 * jj_p) and jr <= max(1e-3, 2 * jr_p)


def _small_vil_rig():
    """test_cuda_deferred_pipeline_matches_cpu's rig: 160 x 120 images,
    16-ring scans, exact kNN, 64 feature slots."""
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig

    H, W, F = 120, 160, 100.0
    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    return RigConfig(
        name="small", camera=dict(model_type="PINHOLE",
                                  projection_parameters=dict(fx=F, fy=F, cx=W / 2, cy=H / 2),
                                  distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=H, image_width=W, q_ic=sim.R_to_q(r_bc), t_ic=np.array([0.1, 0.0, 0.05]),
        q_cl=sim.R_to_q(r_bc.T), t_cl=np.array([0.0, -0.1, 0.02]), max_cnt=40, min_dist=12,
        n_scan=16, lidar_fov_up=15.0, lidar_fov_down=-15.0, lidar_min_range=1.0,
        lidar_max_range=80.0, f_threshold=3.0, rolling_shutter=True, tr=0.02)


class _StepRecorder:
    """graphs.step wrapped: the replays of `names` recorded (name, body,
    arguments, outputs, the K1 / K2 / eigh launches the replay counted)."""

    def __init__(self, monkeypatch, names):
        from vil_fusion_tpu_torch.ops.cuda import eigh_cuda
        from vil_fusion_tpu_torch.utils import graphs

        self.calls, step = [], graphs.step

        def counts():
            return (kc.knn_grouped.launches, kc.knn_exact.launches, eigh_cuda.eigh.launches)

        def rec(name, fn, args, static=(), lock=None):
            if name not in names or graphs.capturing() or getattr(graphs._tls, "inline", 0):
                return step(name, fn, args, static, lock)
            n_cap, c0, r0 = len(graphs.captures), counts(), graphs.replays.get(name, 0)
            out = step(name, fn, args, static, lock)
            c1 = counts()
            if graphs.replays.get(name, 0) > r0:  # not a key's first call (the body)
                self.calls.append((name, fn, args, out, None if len(graphs.captures) > n_cap
                                   else tuple(b - a for a, b in zip(c0, c1)),
                                   graphs.last_settlement()))
            return out

        self.counts = counts
        monkeypatch.setattr(graphs, "step", rec)

    def _applied(self, launches):
        """The launch counts `launches` ((count, args) pairs) add."""
        c0 = self.counts()
        for count, a in launches:
            count(*a)
        return tuple(b - a for a, b in zip(c0, self.counts()))

    def check(self):
        """Each replay against its eager body: outputs bit for bit, the same
        kernel launches counted, but for the conditional bodies: the eager
        body runs both branches, the replay the taken one."""
        from vil_fusion_tpu_torch.utils import graphs

        for name, fn, args, out, launched, settled in self.calls:
            c0 = self.counts()
            with graphs.inline():
                ref = fn(*args)
            eager = tuple(b - a for a, b in zip(c0, self.counts()))
            if launched is not None and settled is not None:
                taken = self._applied(settled.launches_of(True, wait=True))
                skipped = self._applied(settled.launches_of(False))
                launched = tuple(x + y + z for x, y, z in zip(launched, taken, skipped))
            assert launched is None or launched == eager, (name, launched, eager)
            a, b = _leaves(out), _leaves(ref)
            assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), name


def _small_vil_frames(n, speed=4.0):
    from vil_fusion_tpu_torch.runtime import sim

    H, W, F = 120, 160, 100.0
    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=speed))
    out = []
    for i in range(n):
        t = 1.0 + 0.1 * i
        R, pos = traj.rotation(t), traj.position(t) + np.array([0, 0, 1.5])
        img = (np.clip(sim.render_camera_image(scene, R @ r_bc, pos, F, F, W / 2, H / 2, H, W),
                       0, 1) * 255).astype(np.uint8)
        pts, val = sim.simulate_lidar_scan(scene, R, pos, n_scan=16, width=900, fov_up_deg=15.0,
                                           fov_down_deg=-15.0, max_range=80.0, seed=i)
        out.append((t, img, pts, val, sim.simulate_imu(traj, t - 0.1, t, 200.0) if i else None))
    return traj, out


@pytest.mark.parametrize("sync_depth", [0, 2])
def test_cuda_frame_graphs_equal_eager(cuda_device, monkeypatch, sync_depth):
    """VILFusionPipeline(mode="vil") on the card over 14 frames of the small
    rig with the tracker's RANSAC on: at sync_depth 0 every frame calls
    the stage graphs (the tracker's from frame 1, the odometry's from frame
    3, glue + depth association on all) and each steady frame the
    estimator's too; at sync_depth 2 a steady frame is one call of the
    frame's graph, with no sync from its uploads to its async copies
    (set_sync_debug_mode("error") after the capture). A call replays, but
    for a key's first, which runs the body (the frame's body then calls the
    estimator's step). Every replay equals its eager body bit for bit and
    counts the K1 / K2 / eigh launches the body makes."""
    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline
    from vil_fusion_tpu_torch.utils import graphs

    names = ("track_step", "odometry_step", "glue_depth", "vil_frame")
    rec = _StepRecorder(monkeypatch, names)
    pipe = VILFusionPipeline(
        _small_vil_rig(), mode="vil", f_cap=64, sync_depth=sync_depth, scan_quant=0.0025,
        device=cuda_device,
        odom_overrides=dict(edge_map_cap=2048, surf_map_cap=4096, edge_cap=256, surf_cap=1024,
                            approx_knn=False),
        gf_cfg=gf.GlobalFusionConfig(node_capacity=64, loop_capacity=8, cloud_capacity=512,
                                     submap_half_span=3))
    traj, frames = _small_vil_frames(14)
    q0, p0 = traj.pose(1.0)
    pipe.estimator.set_initial_state(p=p0 + np.array([0, 0, 1.5]), q=q0, v=traj.velocity(1.0))
    issue = pipe._issue_frame

    def issue_checked(*a):
        if "vil_frame" not in graphs.replays:  # the first steady frame captures
            return issue(*a)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return issue(*a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    pipe._issue_frame = issue_checked
    graphs.reset_counts()

    def calls():  # replays, and first calls of a key (their bodies run), of the frame's steps
        return {k: graphs.replays.get(k, 0) + graphs.eager_calls.get(k, 0)
                for k in (set(graphs.replays) | set(graphs.eager_calls))
                & {*names, "fused_full_step"}}

    for i, (t, img, pts, val, imu) in enumerate(frames):
        if imu is not None:
            pipe.push_imu_batch(imu[0][1:], imu[1][1:], imu[2][1:])
        before, body0 = calls(), graphs.eager_calls.get("vil_frame", 0)
        pipe.push_scan(t, pts.copy(), val.copy())
        pipe.push_image(t, img)
        delta = {k: v - before.get(k, 0) for k, v in calls().items() if v != before.get(k, 0)}
        if i < 10:
            want = {k: 1 for k, first in (("track_step", 1), ("odometry_step", 3),
                                          ("glue_depth", 0)) if i >= first}
        elif sync_depth:
            want = {"vil_frame": 1}
            if graphs.eager_calls.get("vil_frame", 0) > body0:  # the body ran, step inside
                want["fused_full_step"] = 1
        else:
            want = {"track_step": 1, "odometry_step": 1, "glue_depth": 1, "fused_full_step": 1}
        assert delta == want, (i, delta)
    pipe.finalize()
    assert pipe.restarts == 0 and pipe.estimator.fused_steps == 4
    if sync_depth:  # a key's first call runs the body, the second captures
        assert graphs.replays.get("vil_frame", 0) >= 3
    assert len(rec.calls) == sum(n for k, n in graphs.replays.items() if k in names)
    rec.check()


def test_cuda_cond_replays_the_taken_branch(cuda_device):
    """graphs.cond inside a captured step: a conditional node whose replay
    runs the taken branch only. The branches write distinct values and
    bump their own slot of a device counter; over replays with the
    predicate flipped only the taken branch's slot grows, the outputs equal
    the eager select's (both branches, torch.where) bit for bit, and an
    output that is an operand is not overwritten by the other branch. The
    launches recorded in a body count at the replays that ran it, once
    their predicates have landed (graphs.settle), and the graph's nodes
    count the bodies' (2 conditional nodes outside)."""
    from vil_fusion_tpu_torch.ops.cuda import cond_cuda
    from vil_fusion_tpu_torch.utils import graphs

    hits = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    seen = []

    def branch(k, val):
        def fn(x, y):
            hits[k] += 1
            graphs.record_launch(seen.append, k)
            return x * val + 1.0, y  # y: an operand, returned as it is
        return fn

    def body(pred, x, y):
        a, b = graphs.cond(pred, branch(0, 2.0), branch(1, -3.0), (x * 1.0, y))
        return a + 0.5, b * 1.0

    x = torch.arange(6, dtype=torch.float32, device=cuda_device)
    y = torch.full((3,), 7.0, device=cuda_device)
    n_cap = len(graphs.captures)
    graphs.step("cond_test", body, (torch.tensor(True, device=cuda_device), x, y))  # the body
    torch.cuda.synchronize()
    hits.zero_()
    seen.clear()
    graphs.settle(wait=True)
    c0 = cond_cuda.begin.launches
    for k, flag in enumerate((True, False, False, True, False)):
        pred = torch.tensor(flag, device=cuda_device)
        out = graphs.step("cond_test", body, (pred, x + k, y))  # the first captures
        ref = body(pred, x + k, y)
        torch.cuda.synchronize()
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], y), k
    stats = graphs.captures[n_cap]
    assert stats["nodes"]["conditional"] == 2 and stats["nodes"]["in_bodies"] > 0
    # the capture's 2 warm-up calls and the 5 eager references ran both
    # branches, the capture none; the 5 replays ran one branch each
    assert hits.tolist() == [2 + 5 + 2, 2 + 5 + 3], hits.tolist()
    assert torch.equal(y, torch.full((3,), 7.0, device=cuda_device))
    graphs.settle(wait=True)
    assert sorted(seen) == sorted([0, 1] * (2 + 5) + [0, 1, 1, 0, 1]), seen
    assert cond_cuda.begin.launches == c0 + 2 * 5


def test_cuda_global_fusion_graphs_without_sync(cuda_device):
    """GlobalFusion on the card: after the graphs of its keyframe program,
    submap ICP and relaxation are captured, keyframes, an ICP dispatch, a
    loop edge and a relaxation run under torch.cuda.set_sync_debug_mode(
    "error") without raising (the test's direct calls on the fusion's own
    stream, as global fusion makes them); the graph, database and clouds equal those
    of the same keyframes through the eager bodies (graphs.inline())."""
    from vil_fusion_tpu_torch.models import global_fusion as gf
    from vil_fusion_tpu_torch.models import posegraph as pg
    from vil_fusion_tpu_torch.runtime import sim
    from vil_fusion_tpu_torch.utils import graphs

    scene = sim.RaycastScene()
    cfg = gf.GlobalFusionConfig(node_capacity=64, loop_capacity=8, cloud_capacity=1024,
                                submap_half_span=3)
    scans = []
    for i in range(9):
        yaw = 0.04 * i
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        p = np.array([10.0 + 2.5 * i, 0.5, 1.5])
        pts, val = sim.simulate_lidar_scan(scene, R, p, n_scan=16, width=900, fov_up_deg=15.0,
                                           fov_down_deg=-15.0, max_range=80.0, seed=i)
        scans.append((sim.R_to_q(R).astype(np.float32), p.astype(np.float32),
                      torch.from_numpy(pts).to(cuda_device), torch.from_numpy(val).to(cuda_device)))

    q_id = torch.tensor([1.0, 0.0, 0.0, 0.0], device=cuda_device)

    def run(eager):
        f, icps = gf.GlobalFusion(cfg, device=cuda_device), []
        f.stream.wait_stream(torch.cuda.current_stream())  # the scans' uploads
        for i, (q, p, pts, val) in enumerate(scans):
            strict = not eager and i >= 4  # the graphs exist from the fourth keyframe on
            # the direct calls on the fusion's stream, where global fusion runs them
            with (graphs.inline() if eager else _sync_mode("error" if strict else None),
                  torch.cuda.stream(f.stream)):
                f.add_frame(q, p, pts, val, t=float(i))
                if i >= 2:  # the ICP and the relaxation: the first call runs the body,
                    f._dispatch_icp(i, 0, 0.1)  # the second captures
                    icps.append(f._pending_icp.pop())  # never accepted: no loop edge
                    f.graph = pg.optimize_bucketed(f.graph, f.n_kf)
        with (_sync_mode("error") if not eager else graphs.inline(),
              torch.cuda.stream(f.stream)):
            f.graph = pg.add_loop(f.graph, 0, 8, q_id, torch.zeros(3, device=cuda_device))
        f.flush()
        torch.cuda.synchronize()
        return f, icps

    (g, icp_g), (e, icp_e) = run(False), run(True)
    for a, b in zip(icp_g, icp_e):  # (i, j, q, p, fitness): bit for bit
        assert a[:2] == b[:2] and torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
        assert torch.equal(a[4].get()[0], b[4].get()[0])
    for name in ("keyframe_program", "submap_icp", "posegraph_optimize"):
        assert graphs.replays.get(name, 0) > 0, name
    # bit for bit, but the relaxed poses: optimize's index_add_ sums in
    # atomic order on the card (within 1e-5 m / 1e-5 of the quaternion)
    for a, b in ((g.graph, e.graph), (g.scdb, e.scdb)):
        for k, x, y in zip(a._fields, a, b):
            if k in ("q", "p"):
                assert (x - y).abs().max().item() <= 1e-5, k
            else:
                assert torch.equal(x, y), k
    assert torch.equal(g.clouds, e.clouds) and torch.equal(g.cloud_valid, e.cloud_valid)
    assert len(icp_g) == len(icp_e) == 7 and g.n_kf == e.n_kf == 9


class _sync_mode:
    """torch.cuda.set_sync_debug_mode(mode) inside the block (None: as it is)."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        if self.mode:
            torch.cuda.set_sync_debug_mode(self.mode)

    def __exit__(self, *exc):
        if self.mode:
            torch.cuda.set_sync_debug_mode("default")


def _vl_frames(n):
    """n keyframes of one place (tests/test_visual_loop.py's camera, 240 x
    320): (image, window pixels (64, 2), their validity, camera-frame cloud,
    its validity), the window points the port's corners."""
    from vil_fusion_tpu_torch.ops import image as im
    from vil_fusion_tpu_torch.runtime import sim

    scene = sim.RaycastScene()
    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    out = []
    for k in range(n):
        yaw, p = 0.01 * k, np.array([3.0 + 0.05 * k, 0.02 * k, 1.5])
        R_wb = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                         [0, 0, 1]])
        img = sim.render_camera_image(scene, R_wb @ r_bc, p, 250.0, 250.0, 160.0, 120.0, 240,
                                      320).astype(np.float32)
        xy, ok = im.detect_features(torch.from_numpy(img), torch.zeros((1, 2)),
                                    torch.zeros(1, dtype=torch.bool), max_pts=64, min_dist=16)
        pts, val = sim.simulate_lidar_scan(scene, R_wb, p, n_scan=32, width=600, seed=k)
        out.append((img, xy.numpy(), ok.numpy(), (pts @ r_bc).astype(np.float32), val))
    return out


def _equal_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        (x is None and y is None) or (x.shape == y.shape and x.dtype == y.dtype
                                      and torch.equal(x, y)) for x, y in zip(la, lb))


def test_cuda_capture_on_a_thread_beside_replays(cuda_device):
    """The visual-loop worker's pattern on the card: a graph captured on a
    second thread (thread-local capture mode) while the main thread keeps
    replaying its own graph. The capture's stats name the second thread
    and count the main thread's replays made while it ran; both graphs'
    outputs equal their bodies'; the capture's memory is read from its
    private pool."""
    import threading

    from vil_fusion_tpu_torch.utils import graphs

    x = torch.linspace(0.0, 1.0, 4096, device=cuda_device)

    def main_body(a):
        return torch.sin(a * 2.0 + 1.0)

    def worker_body(a):
        for _ in range(1500):  # a capture of some tenths of a second
            a = a * 1.0001 + 1e-4
        return a

    for _ in range(2):  # the main thread's graph: the body, then the capture
        graphs.step("main_graph", main_body, (x,))
    n_cap, out, errors = len(graphs.captures), [], []

    def worker():
        try:
            for _ in range(2):  # the body, then the capture
                out.append(graphs.step("worker_graph", worker_body, (x,)))
        except Exception as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=worker, name="capturing-worker")
    t.start()
    while t.is_alive():
        got = graphs.step("main_graph", main_body, (x,))
    t.join()
    assert not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(got, main_body(x))
    with graphs.inline():
        want = worker_body(x)
    assert all(torch.equal(o, want) for o in out)
    stats = [c for c in graphs.captures[n_cap:] if c["name"] == "worker_graph"]
    assert len(stats) == 1 and stats[0]["thread"] == "capturing-worker"
    assert stats[0]["replays_during"].get("main_graph", 0) > 0, stats[0]
    assert stats[0]["pool_mib"] is not None and stats[0]["pool_mib"] > 0


def test_cuda_visual_loop_graphs_equal_bodies(cuda_device):
    """The visual loop's graphs on the card: the keyframe program
    ("vl_keyframe"), the Hamming match ("vl_match"), the PnP RANSAC
    ("pnp_ransac") and the 4-DoF solve
    ("posegraph4dof_optimize") each called five times (the first runs the
    body, the second captures): every replay bit for bit its eager body
    (graphs.inline()) on the same inputs, and a replay of each under
    torch.cuda.set_sync_debug_mode("error") raises nothing (the 4-DoF
    solve's batched 4 x 4 inverse, torch.linalg.inv_ex, waits for nothing
    either, eager or captured)."""
    from vil_fusion_tpu_torch.models import cameras
    from vil_fusion_tpu_torch.models import posegraph4dof as pg4
    from vil_fusion_tpu_torch.models import visual_loop as vl
    from vil_fusion_tpu_torch.utils import graphs

    cam = cameras.PinholeCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0)
    cfg = vl.VisualLoopConfig(capacity=16, win_cap=64, extra_cap=128)
    dev = cuda_device
    r0 = dict(graphs.replays)
    for k, (img, xy, ok, cloud, cval) in enumerate(_vl_frames(5)):
        args = [torch.from_numpy(x).to(dev) for x in (img, xy, ok, cloud, cval)]
        with _sync_mode("error" if k >= 3 else None):
            got = vl.keyframe_values(*args, cam, cfg, 0.1)
        with graphs.inline():
            want = vl.keyframe_values(*args, cam, cfg, 0.1)
        assert _equal_leaves(got, want), k
        assert int(want.depth_ok.sum()) > 0
    rng = np.random.default_rng(0)
    for k in range(5):
        d = [torch.from_numpy(rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32)).to(dev)
             for n in (64, 128)]
        v = [torch.from_numpy(rng.random(n) > 0.1).to(dev) for n in (64, 128)]
        with _sync_mode("error" if k >= 3 else None):
            got = vl.match_values(d[0], v[0], d[1], v[1])
        with graphs.inline():
            want = vl.match_values(d[0], v[0], d[1], v[1])
        assert _equal_leaves(got, want), k
    N = cfg.win_cap
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-2, 2, N), rng.uniform(4, 12, N)], -1)
    obs = pts[:, :2] / pts[:, 2:] + rng.normal(0, 1e-3, (N, 2))
    t = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (pts, obs)]
    valid = torch.from_numpy(rng.random(N) > 0.1).to(dev)
    q0 = torch.tensor([1.0, 0.02, 0.0, 0.01], device=dev)
    p0 = torch.tensor([0.2, 0.0, -0.1], device=dev)
    for k in range(5):
        u = vl.ransac_uniforms(64, N, torch.Generator().manual_seed(k)).to(dev)
        with _sync_mode("error" if k >= 3 else None):
            got = vl.pnp_ransac(*t, valid, q0, p0, n_hyp=64, inlier_tol=10 / 460, u=u)
        with graphs.inline():
            want = vl.pnp_ransac(*t, valid, q0, p0, n_hyp=64, inlier_tol=10 / 460, u=u)
        assert _equal_leaves(got, want), k
    g = pg4.init_graph(256, 16, device=dev)
    p, yaw = np.zeros(3, np.float32), 0.0
    for i in range(40):
        g = pg4.add_node(g, torch.from_numpy(p.copy()).to(dev), yaw, 0.02, -0.01)
        yaw += 0.01
        p = p + np.array([np.cos(yaw), np.sin(yaw), 0.0], np.float32)
    for k in range(5):
        gk = pg4.add_loop(g, 0, 39 - k, torch.tensor([39.0 - k, 0.0, 0.0], device=dev), 0.0)
        with _sync_mode("error" if k >= 3 else None):
            got = pg4.optimize(gk)
        with graphs.inline():
            want = pg4.optimize(gk)
        assert torch.equal(got.p, want.p) and torch.equal(got.yaw, want.yaw), k
    assert float(torch.linalg.norm(got.p[35] - torch.tensor([35.0, 0, 0], device=dev))) < 1.0
    blocks = torch.eye(4, device=dev).expand(256, 4, 4) * 3.0
    with _sync_mode("error"):
        inv = torch.linalg.inv_ex(blocks)[0]
    torch.testing.assert_close(inv, torch.eye(4, device=dev).expand(256, 4, 4) / 3.0)
    for name in ("vl_keyframe", "vl_match", "pnp_ransac", "posegraph4dof_optimize"):
        assert graphs.replays.get(name, 0) - r0.get(name, 0) >= 4, name


def test_cuda_visual_loop_db_graph_path_equals_eager(cuda_device):
    """A VisualLoopDB on the card, four keyframes (one densified from its
    cloud), verifications and a loop closure through the graphs, against
    the same calls through the eager bodies (graphs.inline()): every store
    array, the histograms and the 4-DoF graph bit for bit."""
    from vil_fusion_tpu_torch.models import cameras
    from vil_fusion_tpu_torch.models import visual_loop as vl
    from vil_fusion_tpu_torch.utils import graphs

    cam = cameras.PinholeCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0)
    frames = _vl_frames(4)
    from vil_fusion_tpu_torch.runtime import sim

    r_bc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    q_bc = sim.R_to_q(r_bc)

    def run(eager):
        db = vl.VisualLoopDB(vl.VisualLoopConfig(capacity=16, win_cap=64, extra_cap=128),
                             qic=q_bc, tic=np.zeros(3), min_incidence=0.1, device=cuda_device)
        with graphs.inline() if eager else _sync_mode(None):
            for k, (img, xy, ok, cloud, cval) in enumerate(frames):
                px = xy[ok]
                pts3d = np.concatenate([(px - [160.0, 120.0]) / 250.0, np.ones((len(px), 1))],
                                       -1) * 8.0 @ r_bc.T
                db.add_keyframe(img, np.array([1.0, 0, 0, 0]), np.array([3.0, 0, 1.5]),
                                pts3d.astype(np.float32), px, np.ones(len(px), bool), cam,
                                cloud_cam=torch.from_numpy(cloud).to(cuda_device) if k == 0
                                else None,
                                cloud_valid=torch.from_numpy(cval).to(cuda_device) if k == 0
                                else None)
            conns = [db.find_connection(i, j) for i, j in ((1, 0), (2, 0), (3, 1))]
            db.close_loop(3, 0, np.array([1.0, 0, 0, 0], np.float32),
                          np.array([0.1, 0.0, 0.0], np.float32))
        torch.cuda.synchronize()
        return db, conns

    (g, cg), (e, ce) = run(False), run(True)
    for k in ("win_desc", "win_pts3d", "win_valid", "extra_desc", "extra_xy", "extra_valid",
              "q", "p", "vio_q", "vio_pts3d", "seq"):
        assert np.array_equal(getattr(g, k), getattr(e, k)), k
    assert torch.equal(g.hists, e.hists)
    assert all(torch.equal(a, b) for a, b in zip(g.graph, e.graph))
    assert g.stats == e.stats and len(cg) == len(ce)
