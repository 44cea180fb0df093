"""kNN of the port: plain versions against vil_fusion_tpu, the dispatcher's
routing and the host contract. The CUDA kernels themselves are tested on a
card by test_torch_cuda.py.

The JAX side runs as its own tests run it on the CPU: the XLA kNN and the
Pallas kernels in interpret mode with small tiles. Tolerances are stated
in each assert.
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


def _data(nq, nd, seed, lo=-20.0, hi=20.0, valid_frac=0.9):
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (nq, 3)).astype(np.float32)
    db = rng.uniform(lo, hi, (nd, 3)).astype(np.float32)
    return q, db, rng.random(nd) < valid_frac


def _resolve(q, db, idx):
    return ((q[:, None, :] - db[idx]) ** 2).sum(-1)


@pytest.mark.parametrize("k,tile", [(5, 2048), (5, 512), (3, 128), (1, 2048)])
def test_plain_exact_matches_xla(k, tile):
    """Plain exact vs ops.knn.knn (XLA, HIGHEST dot): distances rtol 1e-4 /
    atol 1e-3 (test_pallas_knn.py:19), indices resolve to those distances."""
    q, db, v = _data(300, 3000, 0)
    d_ref, _ = knn_xla.knn(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v), k=k)
    d, i = tknn.knn(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(v), k=k, tile=tile)
    assert d.dtype == torch.float32 and i.dtype == torch.int32 and d.shape == (300, k)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_resolve(q, db, i.numpy()), np.asarray(d_ref), rtol=1e-4, atol=1e-3)
    assert v[i.numpy()].all()  # invalid points are never selected


def test_plain_exact_matches_pallas_unpacked():
    """Plain exact vs knn_pallas(packed=False) in interpret mode, rtol 1e-4 /
    atol 1e-3; identical indices where neighbours are 1e-3 apart."""
    q, db, v = _data(256, 2000, 11)
    d_ref, i_ref = kp.knn_pallas(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v), k=5,
                                 q_tile=128, db_tile=512, interpret=True)
    d, i = tknn.knn(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(v), k=5)
    d_ref = np.asarray(d_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-4, atol=1e-3)
    margin = np.all(np.diff(d_ref, axis=1) > d_ref[:, -1:] * 1e-3, axis=1)
    assert margin.sum() > 150
    np.testing.assert_array_equal(i.numpy()[margin], np.asarray(i_ref)[margin])


def test_plain_grouped_matches_pallas_grouped():
    """Plain grouped vs the TPU grouped kernel (knn_pallas(grouped=True,
    mxu=True), interpret mode, q_tile=128, db_tile=512). The TPU kernel packs
    distances into int32 keys (quantized to 2^-14 relative at db_tile 512)
    and rounds the expanded form in another order (a few ulps of
    |q|^2 + |d|^2 ~ 1e4 here): distances rtol 3e-4 / atol 2e-3, indices
    identical on rows whose grouped candidates are 1e-3 apart
    (test_pallas_knn.py:102-122)."""
    q, db, v = _data(256, 4096, 3, -50.0, 50.0)
    d_ref, i_ref = kp.knn_pallas(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v), k=5,
                                 q_tile=128, db_tile=512, interpret=True, grouped=True,
                                 mxu=True)
    d, i = tknn.knn_grouped(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(v), k=5)
    d_ref = np.asarray(d_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=3e-4, atol=2e-3)
    d6, _ = tknn.knn_grouped(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(v), k=6)
    d6 = d6.numpy()
    margin = np.all(np.diff(d6, axis=1) > np.maximum(d6[:, 1:], 1e-6) * 1e-3, axis=1)
    assert margin.sum() > 150
    np.testing.assert_array_equal(i.numpy()[margin], np.asarray(i_ref)[margin])


def test_plain_grouped_bounded_approximation():
    """The grouped semantics against exact: >= 99% of rows exact (isclose
    rtol 1e-3 / atol 1e-2) and 5th-neighbour ratio < 1.5
    (test_pallas_knn.py:149-175, on its inputs), with indices resolving to
    the returned distances (rtol 2e-3 / atol 2e-2)."""
    rng = np.random.default_rng(3)
    q = rng.uniform(-50, 50, (512, 3)).astype(np.float32)
    db = rng.uniform(-50, 50, (8192, 3)).astype(np.float32)
    v = rng.random(8192) > 0.1
    d_g, i_g = tknn.knn_grouped(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(v))
    d_r, _ = knn_xla.knn(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v), k=5)
    d_g, d_r = d_g.numpy(), np.asarray(d_r)
    assert np.isclose(d_g, d_r, rtol=1e-3, atol=1e-2).all(1).mean() > 0.99
    assert (d_g[:, -1] / np.maximum(d_r[:, -1], 1e-9)).max() < 1.5
    np.testing.assert_allclose(np.sort(_resolve(q, db, i_g.numpy()), 1), d_g, rtol=2e-3, atol=2e-2)


def test_grouped_overflow_semantics():
    """Three nearest neighbours in one 128-column group: the grouped search
    keeps two of them and fills the slot from another group (exactly the
    TPU kernel's documented approximation); exact keeps all three."""
    db = np.full((256, 3), 100.0, np.float32)
    db[:, 0] += np.arange(256)
    db[3] = [1.0, 0, 0]
    db[9] = [2.0, 0, 0]
    db[40] = [3.0, 0, 0]  # same group (0) as 3 and 9
    db[200] = [4.0, 0, 0]  # group 1
    q = np.zeros((1, 3), np.float32)
    v = np.ones(256, bool)
    args = (torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(v))
    d_x, i_x = tknn.knn(*args, k=3)
    d_g, i_g = tknn.knn_grouped(*args, k=3)
    assert i_x[0].tolist() == [3, 9, 40]
    assert i_g[0].tolist() == [3, 9, 200]
    np.testing.assert_allclose(d_g[0].numpy(), [1.0, 4.0, 16.0], rtol=0, atol=0)


@pytest.mark.parametrize("fn", [tknn.knn, tknn.knn_grouped])
def test_host_contract_edge_cases(fn):
    """All-invalid database: every distance inf, every index 0. Fewer valid
    points than k: exactly those found, the rest inf/0 (test_pallas_knn.py
    :84-99). Rows ascending, distances >= 0."""
    q = torch.zeros((70, 3))
    d, i = fn(q, torch.ones((500, 3)), torch.zeros(500, dtype=torch.bool), k=3)
    assert torch.isinf(d).all() and (i == 0).all()
    valid = torch.zeros(600, dtype=torch.bool)
    valid[5] = valid[17] = True
    d, i = fn(torch.zeros((8, 3)), torch.ones((600, 3)), valid, k=4)
    assert (torch.isfinite(d).sum(1) == 2).all()
    assert set(i[0, :2].tolist()) == {5, 17} and (i[:, 2:] == 0).all()
    q, db, v = _data(64, 700, 4)
    d, _ = fn(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(v), k=5)
    assert (d >= 0).all() and (torch.diff(d, dim=1) >= 0).all()


def test_dispatcher_routes_cpu_to_plain():
    """On CPU tensors: approx=True is the plain grouped search, radius= the
    plain sparse search (whatever approx says), otherwise the plain exact
    one; all bit-equal to the plain function called directly, and no kernel
    launch is counted."""
    q, db, v = (torch.from_numpy(x) for x in _data(100, 1500, 5))
    n1, n2 = kc.knn_grouped.launches, kc.knn_exact.launches
    for approx, ref in ((True, tknn.knn_grouped), (False, tknn.knn)):
        d, i = kc.knn(q, db, v, k=5, approx=approx)
        d_r, i_r = ref(q, db, v, k=5)
        assert torch.equal(d, d_r) and torch.equal(i, i_r)
    n3 = kc.knn_sparse.launches
    d_r, i_r = tknn.knn_sparse(q, db, v, k=2, radius=3.0)
    for approx in (False, True):
        d, i = kc.knn(q, db, v, k=2, radius=3.0, approx=approx)
        assert torch.equal(d, d_r) and torch.equal(i, i_r)
    assert (kc.knn_grouped.launches, kc.knn_exact.launches,
            kc.knn_sparse.launches) == (n1, n2, n3)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel path checks its inputs before building anything: a CPU
    tensor handed to it raises instead of falling back."""
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kc._launch(q, q, torch.ones(4, dtype=torch.bool), 3, grouped=True, form="expanded")
    with pytest.raises(ValueError, match="CUDA"):
        kc._check(q, q, torch.ones(4, dtype=torch.bool), 3)
