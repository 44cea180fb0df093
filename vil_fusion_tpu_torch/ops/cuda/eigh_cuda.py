"""The CUDA wrapper of the symmetric eigensolver (csrc/eigh.cu).

`eigh(A)` is `torch.linalg.eigh(A)` for float32 symmetric matrices of size
n <= MAX_N (172, the estimator's pose dimension) with any leading batch
dims: eigenvalues ascending and eigenvectors as the columns of V, from the
lower triangle. One launch covers the batch, by one of two kernels:
n <= WARP_MAX_N (the 15 x 15 Schur block) a parallel Jacobi, one warp a
matrix; larger n (the 157 x 157 prior) a Householder tridiagonalization and
implicit QL, one block a matrix (tests/torch_eigh_reference.py mirrors
both). It stands where the reference calls XLA's `jnp.linalg.eigh`
(vil_fusion_tpu/models/marginalization.py:35 and :48); ops/linalg.sym_eigh
routes a CUDA tensor here and a CPU tensor to the plain version,
`eigh_plain` (torch.linalg.eigh). Unlike torch.linalg.eigh on the card, the
kernel never waits for the device, so a CUDA graph can hold it.

The kernel is compiled with nvcc for sm_90a into build/kernels/ at first use
(ops/cuda/nvcc.py) and bound with ctypes, launched on the current stream,
`cudaGetLastError` checked after the launch. Importing this module builds
nothing. There is no fallback: a CUDA tensor runs the kernel or raises.
"""
import ctypes
from pathlib import Path

import torch

from vil_fusion_tpu_torch.ops.cuda import nvcc
from vil_fusion_tpu_torch.utils import graphs

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "eigh.cu"
MAX_N = 172
WARP_MAX_N = 32  # csrc/eigh.cu's warp kernel takes n <= 32, its block kernel the rest
NSTATS = 8  # stats a matrix (csrc/eigh.cu NSTATS)
# the Jacobi sweeps stop once ||off(A)||_F <= TOL ||A||_F: four float32 ulps
TOL = 4.0 * 2.0 ** -24

eigh_plain = torch.linalg.eigh

_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile csrc/eigh.cu (once per source/flag content) and load it;
    verbose=True adds `-Xptxas -v` and prints its report."""
    global _lib
    if _lib is not None and not verbose:
        return _lib
    out, log, secs = nvcc.compile_library(SOURCE, "vil_eigh", verbose)
    if verbose:
        report = "\n".join(f"  {ln.strip()}" for ln in log.splitlines()
                           if "Used" in ln or "spill" in ln)
        print(f"nvcc {SOURCE.name}: {secs:.2f} s\n{report}", flush=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.vil_eigh_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 5)
    lib.vil_eigh_ring_bytes.restype = ctypes.c_int
    fn.restype = ctypes.c_int
    if lib.vil_eigh_warp_max_n() != WARP_MAX_N or lib.vil_eigh_nstats() != NSTATS:
        raise RuntimeError(f"{SOURCE.name}: warp kernel n <= {lib.vil_eigh_warp_max_n()}, "
                           f"{lib.vil_eigh_nstats()} stats; the wrapper has {WARP_MAX_N}, {NSTATS}")
    _lib = lib
    return lib


def _count(warp: bool = False):
    with graphs.count_lock:
        eigh.launches += 1
        eigh.launches_warp += warp


def reset_counts():
    with graphs.count_lock:
        eigh.launches = 0
        eigh.launches_warp = 0


def eigh(A: torch.Tensor, stats: torch.Tensor = None):
    """(S ascending (..., n), V (..., n, n)) of the symmetric float32 A
    (..., n, n) on the card, one launch for every matrix of the batch.
    `stats`, an int32 CUDA tensor of (batch, NSTATS), receives what each
    matrix took: the work, (QL iterations, Givens rotations) for n >
    WARP_MAX_N or (Jacobi sweeps, rotations), the SM clock cycles from the
    kernel's start until the tridiagonal, Q and the last rotation are done
    and until the end, then the cycles the QL producer waited for room in
    its ring and spent in its chains (the warp kernel: 0, 0, 0, the end, 0,
    0).
    `eigh.launches` counts every launch, `eigh.launches_warp` those of the
    warp kernel."""
    if not A.is_cuda:
        raise ValueError(f"eigh_cuda.eigh needs a CUDA tensor, got {A.device}")
    if A.dtype != torch.float32:
        raise ValueError(f"eigh_cuda.eigh takes float32, got {A.dtype}")
    if A.ndim < 2 or A.shape[-1] != A.shape[-2] or not 1 <= A.shape[-1] <= MAX_N:
        raise ValueError(f"eigh_cuda.eigh takes (..., n, n) with 1 <= n <= {MAX_N}, "
                         f"got {tuple(A.shape)}")
    n = A.shape[-1]
    lead = tuple(A.shape[:-2])
    batch = 1
    for d in lead:
        batch *= d
    S = torch.empty(lead + (n,), dtype=torch.float32, device=A.device)
    V = torch.empty(lead + (n, n), dtype=torch.float32, device=A.device)
    if batch == 0:
        return S, V
    if stats is not None and (not stats.is_cuda or stats.dtype != torch.int32
                              or not stats.is_contiguous() or stats.numel() != NSTATS * batch):
        raise ValueError(f"stats must be a contiguous int32 CUDA tensor of {batch} x {NSTATS}")
    lib = build()
    a = A.contiguous()
    # the block kernel's rotation ring (from its producer warp to the others)
    ring = (torch.empty(batch * lib.vil_eigh_ring_bytes() // 8, dtype=torch.float64,
                        device=A.device) if n > WARP_MAX_N else None)
    with torch.cuda.device(A.device):
        err = lib.vil_eigh_launch(
            a.data_ptr(), batch, n, TOL, S.data_ptr(), V.data_ptr(),
            None if ring is None else ring.data_ptr(),
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vil_eigh_launch failed with cudaError {err} (batch={batch}, n={n})")
    graphs.record_launch(_count, n <= WARP_MAX_N)
    return S, V


# launches counted where the kernel is launched (or, inside a captured graph,
# at each replay: utils/graphs.record_launch)
reset_counts()
