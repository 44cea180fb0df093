"""The port on a CUDA card: the K1/K2/K3 kernels (both distance forms of K1
and K2) and the Morton-key kernels against their plain versions at the main paths' shapes, the
dispatcher's routing on the card, the LiDAR-only slice, the vil front end and
one fused estimator step on the card against the same code on the CPU, the
deferred pipeline (sync_depth=2) on the card against the CPU, the Schur
solve's Cholesky fallback on the card, the device raycaster against itself
on the CPU, and a KITTI odometry replay into a pipeline on the card.

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


def test_cuda_front_end_matches_cpu(cuda_device):
    """vil_front_end on the card against the same function on the CPU over 3
    small frames (16-ring scans, 160 x 120 images; RANSAC off, because with
    40 tracks its hypotheses' inlier counts nearly tie and the winner then
    depends on the device's rounding): feature ids equal, pixels within
    0.05 px, lidar pose within 5e-3 m, depth flags equal on 95% of the
    features; K1 and K2 (k=3) launched."""
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
    odom = dict(edge_map_cap=2048, surf_map_cap=4096, edge_cap=256, surf_cap=1024)
    scene = sim.RaycastScene()
    traj = sim.Trajectory(sim.TrajectoryConfig(speed=4.0))
    results = []
    k1, k2 = kc.knn_grouped.launches, kc.knn_exact.launches
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
    assert kc.knn_grouped.launches - k1 >= 2 and kc.knn_exact.launches - k2 == 3
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
    assert gpu.fused_steps == 1 and gpu.last_is_key == cpu.last_is_key
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
