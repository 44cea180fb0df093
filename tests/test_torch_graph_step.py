"""The pieces of the captured estimator step that the CPU can run:
ops/linalg.sym_eigh (the eigensolver's dispatcher) against
torch.linalg.eigh and the reference's jnp.linalg.eigh, the graph module's
argument flattening, host constants and launch counting
(utils/graphs.py), and the CUDA-only entry points refusing CPU tensors.
The kernel itself and the graph replays are held on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: sym_eigh on the CPU is torch.linalg.eigh, bit for bit; against
the reference's eigh (another LAPACK path) the eigenvalues within 1e-5 of
the largest and the reconstruction V diag(S) V^T within 1e-5 of max|A|
(float32, n <= 157: a few ulps times sqrt(n)).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_fusion_tpu_torch.models.window import (
    FeatureStore, WindowState, init_features, init_window,
)
from vil_fusion_tpu_torch.ops import linalg
from vil_fusion_tpu_torch.ops.cuda import eigh_cuda
from vil_fusion_tpu_torch.utils import graphs


def _sym(n, seed, rank=None):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(rank or n + 5, n)).astype(np.float32)
    return A.T @ A


@pytest.mark.parametrize("n,rank", [(15, None), (157, None), (157, 60)])
def test_sym_eigh_cpu_is_torch_eigh(n, rank):
    """On a CPU tensor the dispatcher is the plain version, bit for bit, and
    agrees with the reference's jnp.linalg.eigh (full rank and a PSD matrix
    of rank 60 like a marginalization prior's)."""
    A = _sym(n, n, rank)
    S, V = linalg.sym_eigh(torch.from_numpy(A))
    S0, V0 = torch.linalg.eigh(torch.from_numpy(A))
    assert torch.equal(S, S0) and torch.equal(V, V0)
    Sj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    np.testing.assert_allclose(S.numpy(), Sj, atol=1e-5 * np.abs(Sj).max())
    R = (V.numpy() * S.numpy()[None, :]) @ V.numpy().T
    np.testing.assert_allclose(R, A, atol=1e-5 * np.abs(A).max())


def test_sym_eigh_batched_reads_the_lower_triangle():
    """A leading batch dimension, and only the lower triangle read (an
    upper triangle of garbage changes nothing), as torch.linalg.eigh."""
    A = np.stack([_sym(15, s) for s in range(3)])
    junk = A + np.triu(np.full((15, 15), 7.0, np.float32), 1)
    S, V = linalg.sym_eigh(torch.from_numpy(junk))
    for b in range(3):
        S0, _ = torch.linalg.eigh(torch.from_numpy(A[b]))
        assert torch.equal(S[b], S0)


def test_eigh_cuda_refuses_cpu_tensors():
    """The CUDA wrapper takes nothing but CUDA float32 (..., n, n) with
    n <= 172: a CPU tensor raises instead of falling back."""
    with pytest.raises(ValueError, match="CUDA"):
        eigh_cuda.eigh(torch.eye(4))
    assert eigh_cuda.MAX_N == 172 and eigh_cuda.eigh_plain is torch.linalg.eigh


def test_flatten_round_trip():
    """graphs._flatten / _unflatten: NamedTuples (nested), tuples, dicts and
    numbers keep their structure and leaves; the structure is hashable (it
    keys the graph cache)."""
    w = init_window(device="cpu")
    f = init_features(4, device="cpu")
    args = (w, f, (w.p, 3), {"a": w.q, "b": True}, 2.5)
    leaves = []
    spec = graphs._flatten(args, leaves)
    hash(spec)
    out = graphs._unflatten(spec, iter(leaves))
    assert type(out[0]) is WindowState and type(out[1]) is FeatureStore
    assert out[2][1] == 3 and out[3]["b"] is True and out[4] == 2.5
    assert all(a is b for a, b in zip(out[0], w)) and out[3]["a"] is w.q
    assert len(leaves) == len(w) + len(f) + 2 + 2 + 1
    sig = tuple(graphs._signature(x) for x in leaves)
    assert sig[-1] is float and sig[0] == ((11, 3), torch.float32, torch.device("cpu"))
    with pytest.raises(TypeError):
        graphs._signature("text")


def test_host_constant_is_made_once():
    """host_constant gives the same tensor for the same (values, dtype,
    device), built from tuples, lists or numpy arrays alike, with the
    values of torch.tensor."""
    a = graphs.host_constant((0.0, 0.0, 9.81), torch.float32, "cpu")
    b = graphs.host_constant([0.0, 0.0, 9.81], torch.float32, torch.device("cpu"))
    c = graphs.host_constant(np.array([0.0, 0.0, 9.81]), torch.float32, "cpu")
    assert a is b is c
    assert torch.equal(a, torch.tensor([0.0, 0.0, 9.81]))
    d = graphs.host_constant((0.0, 0.0, 9.81), torch.float64, "cpu")
    assert d is not a and d.dtype == torch.float64
    m = graphs.host_constant(np.diag([1.0, 2.0]), torch.float32, "cpu")
    assert torch.equal(m, torch.diag(torch.tensor([1.0, 2.0])))


def test_record_launch_counts_outside_a_capture():
    """A wrapper's launch is counted at once when no graph is being
    captured (on this thread); the eigensolver's counts reset to 0."""
    seen = []
    graphs.record_launch(lambda *a: seen.append(a), 157, 1)
    assert seen == [(157, 1)]
    eigh_cuda.reset_counts()
    graphs.record_launch(eigh_cuda._count)
    assert eigh_cuda.eigh.launches == 1
    eigh_cuda.reset_counts()
    assert eigh_cuda.eigh.launches == 0


def test_step_refuses_cpu_tensors():
    """graphs.step captures only CUDA work: CPU tensors raise (the callers
    run their eager body on the CPU), and nothing is cached."""
    n_before = len(graphs._steps)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.step("test", lambda x: x + 1, (torch.ones(3),), lock=threading.Lock())
    assert len(graphs._steps) == n_before


def test_pipeline_upload_on_cpu():
    """runtime.pipeline._upload: a host array on the CPU device is the
    array's values (the card's path goes through pinned memory)."""
    from vil_fusion_tpu_torch.runtime.pipeline import _upload

    x = np.arange(12, dtype=np.int16).reshape(4, 3)[:, ::2]
    t = _upload(x, torch.device("cpu"))
    assert t.dtype == torch.int16 and np.array_equal(t.numpy(), x)
