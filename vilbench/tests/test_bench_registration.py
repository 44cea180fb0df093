"""The reference's registration (vilbench/reference/registration.py) on a
synthetic street of planes: in float64 it finds a known pose to a
micrometre; its control, the same computation with TF32-rounded matrix
products, lands centimetres or more away at world coordinates of 100 m,
where the expanded kNN distances lose their last metres."""
import numpy as np
import torch

from vilbench.reference import registration as reg


def street(rng, n=20000, origin=(100.0, 60.0, 0.0)):
    """Points on a ground plane, two walls and boxes across the road."""
    o = np.asarray(origin)
    parts = [np.c_[rng.uniform(-30, 30, n // 4), rng.uniform(-10, 10, n // 4), np.zeros(n // 4)],
             np.c_[rng.uniform(-30, 30, n // 4), np.full(n // 4, 10.0), rng.uniform(0, 6, n // 4)],
             np.c_[rng.uniform(-30, 30, n // 4), np.full(n // 4, -9.0), rng.uniform(0, 5, n // 4)]]
    for x in (-20.0, -5.0, 12.0, 25.0):
        m = n // 16
        parts.append(np.c_[np.full(m, x), rng.uniform(-9, -6, m), rng.uniform(0, 3, m)])
    return np.concatenate(parts) + o


def test_align_finds_a_known_pose():
    rng = np.random.default_rng(7)
    tgt = street(rng, origin=(0.0, 0.0, 0.0))
    R_true = reg.q_to_R(np.array([1.0, 0.002, -0.004, 0.01]))
    t_true = np.array([0.4, -0.3, 0.05])
    # source: the street seen from the true pose (its points in that frame)
    world = street(rng, 8000, origin=(0.0, 0.0, 0.0))
    src = (world - t_true) @ R_true
    T, n_ok = reg.align(torch.as_tensor(src), torch.as_tensor(tgt),
                        (np.eye(3), np.zeros(3)), reg.FLOAT64)
    d, a = reg.gaps(reg.host(T), (R_true, t_true))
    # planes sampled apart in source and target: a millimetre of bias at their edges
    assert n_ok > 7000 and d < 3e-3 and a < 2e-2, (d, a)


def test_tf32_control_lands_away():
    """A sensor 117 m from the world's origin, as the odometry's are."""
    rng = np.random.default_rng(8)
    origin = np.array([100.0, 60.0, 0.0])
    tgt = street(rng, origin=origin)
    src = street(rng, 8000, origin=origin) - origin
    T64, _ = reg.align(torch.as_tensor(src), torch.as_tensor(tgt), (np.eye(3), origin),
                       reg.FLOAT64)
    T32, _ = reg.align(torch.as_tensor(src), torch.as_tensor(tgt), (np.eye(3), origin),
                       reg.TF32)
    d64 = reg.gaps(reg.host(T64), (np.eye(3), origin))[0]
    d32 = reg.gaps(reg.host(T32), reg.host(T64))[0]
    assert d64 < 3e-3 and d32 > 10 * d64, (d64, d32)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -9, 3.14159265], dtype=torch.float32)
    y = reg.tf32_round(x)
    assert y[0] == 1.0 and y[2] == x[2]
    assert abs(float(y[3]) - 3.14159265) < 2.0 ** -10 * 4
    assert torch.all((y.view(torch.int32) & 0x1FFF) == 0)
