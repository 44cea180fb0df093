"""The port on a CUDA card: K1/K2 kernels against their plain versions at the
main path's shapes, and the LiDAR-only slice on the card against the same
slice on the CPU.

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
        pytest.skip("needs a CUDA device: the K1/K2 kernels have no CPU mode")
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


@pytest.mark.parametrize("nq,nd,k,grouped", [
    (2048, 16384, 5, True),  # edge association
    (8192, 32768, 5, True),  # surf association
    (2048, 51200, 1, False),  # ICP
    (8192, 32768, 5, False),  # exact association (approx_knn=False)
    (300, 1000, 8, False),
    (77, 130, 3, True),
])
def test_cuda_kernel_matches_plain(cuda_device, nq, nd, k, grouped):
    """Kernel and plain version round identically: distances equal within
    1e-6 of the largest distance, indices identical on rows whose k+1
    nearest are 1e-6 relative apart, index 0 where no neighbour; one launch
    counted per call."""
    q, db, v = (torch.from_numpy(x).to(cuda_device) for x in _data(nq, nd, nq + nd))
    kern = kc.knn_grouped if grouped else kc.knn_exact
    plain = kc.knn_grouped_plain if grouped else kc.knn_exact_plain
    before = kern.launches
    d, i = kern(q, db, v, k=k)
    assert kern.launches == before + 1
    d_p, i_p = plain(q, db, v, k=k)
    d_m, _ = plain(q, db, v, k=k + 1)
    torch.cuda.synchronize()
    fin = torch.isfinite(d_p)
    assert torch.equal(fin, torch.isfinite(d))
    assert (d[fin] - d_p[fin]).abs().max().item() <= 1e-6 * d_p[fin].max().item()
    rows = _margin_rows(d_m, k)
    assert rows.float().mean().item() > 0.95
    assert torch.equal(i[rows], i_p[rows])
    assert (i[~torch.isfinite(d)] == 0).all()


def test_cuda_kernel_edge_cases(cuda_device):
    """All-invalid database and fewer valid points than k, on the card; the
    dispatcher refuses the unported sparse kernel (radius) on CUDA."""
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
    with pytest.raises(NotImplementedError):
        kc.knn(q, q, torch.ones(70, dtype=torch.bool, device=cuda_device), radius=3.0)
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
