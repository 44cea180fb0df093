"""kNN dispatcher and the CUDA wrappers of K1 (grouped), K2 (exact) and K3
(sparse).

Counterpart of vil_fusion_tpu/ops/pallas/knn_pallas.py: `knn` keeps the
dispatcher's signature (knn_pallas.py:496-528) and routes by the tensors'
device. On CUDA, `radius=` goes to K3 (`knn_sparse`, replacing
`_sparse_knn_kernel`: Morton-sorted sides, far blocks skipped, difference-
form distances), `approx=True` to K1 (`knn_grouped`, replacing
`_knn_kernel_grouped`) and everything else to K2 (`knn_exact`, replacing
`_knn_kernel`); K1 and K2 take `form="expanded"` (the reference's mxu=True
form, the default) or `form="diff"` (its mxu=False form). A CPU tensor goes
to the plain PyTorch versions in ops/knn.py, re-exported here as
`knn_grouped_plain` / `knn_exact_plain` / `knn_sparse_plain`.

The kernels are CUDA C++ (csrc/knn.cu), compiled with nvcc for sm_90a into
build/kernels/ at first use and bound with ctypes: pointers from
`data_ptr()`, the stream from `torch.cuda.current_stream()`. Importing this
module builds nothing. There is no fallback: a CUDA tensor either runs the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from vil_fusion_tpu_torch.ops import knn as knn_plain

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "knn.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_K = 8
_THREADS = 128  # threads per block and columns per group (csrc/knn.cu)

# The split of the database over gridDim.y: blocks of 128 threads (one query
# each) an SM that it aims at, for K1 / K2 (`plan`, tuned on an H100 with
# tools/knn_kernel_bench.py --sweep) and for K3's tiles
_BLOCKS_PER_SM = 8

# K3's tiles on this card: a block of 128 Morton-consecutive queries against
# 128-column database tiles (the reference's 512 x 1024 were sized for VMEM;
# smaller tiles have tighter boxes and skip more)
SPARSE_Q_TILE = 128
SPARSE_DB_TILE = 128

knn_exact_plain = knn_plain.knn
knn_grouped_plain = knn_plain.knn_grouped
knn_sparse_plain = knn_plain.knn_sparse

_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile csrc/knn.cu (once per source/flag content) and load it.

    verbose=True adds `-Xptxas -v` and prints nvcc's report (registers,
    shared memory, spills) for the instances of the main paths (k = 1, 3,
    5). Returns the loaded library."""
    global _lib
    if _lib is not None and not verbose:
        return _lib
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libvil_knn_{tag}.so"
    if not out.exists() or verbose:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *flags, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) on {SOURCE}:\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        if verbose:
            print(f"nvcc {SOURCE.name}: {time.perf_counter() - t0:.2f} s", flush=True)
            print(_ptxas_summary(res.stdout + res.stderr), flush=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.vil_knn_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    fn = lib.vil_knn_sparse_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    lib.vil_knn_kernels_enqueued.argtypes = []
    lib.vil_knn_kernels_enqueued.restype = ctypes.c_longlong
    _lib = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '\w*?(knn_(?:sparse_partial|dense|merge)_kernel)"
                    r"ILi(\d)E(?:Lb([01])ELb([01])E)?")


def _ptxas_summary(log: str, ks=(1, 3, 5)) -> str:
    """Registers / spills / shared memory of the kernel instances with k in
    `ks`, from nvcc's -Xptxas -v report, and the count of instances that
    spill among all of them."""
    out, label, spilling = [], None, 0
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            kind = ""
            if m.group(3):
                kind = ((", grouped" if m.group(3) == "1" else ", exact")
                        + (", diff" if m.group(4) == "1" else ", expanded"))
            label = f"{m.group(1)}<k={m.group(2)}{kind}>" if int(m.group(2)) in ks else None
        elif "spill" in line:
            spilling += "0 bytes spill stores, 0 bytes spill loads" not in line
            if label:
                out.append(f"  {label}: {line.split(':', 1)[-1].strip()}")
        elif label and "Used" in line:
            out.append(f"  {label}: {line.split(':', 1)[-1].strip()}")
    out.append(f"  instances that spill, all k: {spilling}")
    return "\n".join(out)


class Plan(NamedTuple):
    """How one K1 / K2 call is launched: a block of 128 threads, one query
    each, for every (128 queries, chunk)."""
    n_split: int  # chunks of the database, one block row each (gridDim.y)
    chunk: int  # columns a chunk, whole 128-column groups
    merge: bool  # a second kernel merges the chunks' lists (n_split > 1)


def min_chunk_groups(k: int, grouped: bool) -> int:
    """Least 128-column groups a chunk: every chunk fills its list anew, K1
    with two candidates a group, K2 within its first group, and until then
    every column goes through the update. One group more than that."""
    return (-(-k // 2) if grouped else 1) + 1


def plan(nq: int, nd: int, k: int, sm_count: int, grouped: bool = False) -> Plan:
    """The launch plan from the shape, the kernel and the card's SM count
    alone.

    As many chunks as `_BLOCKS_PER_SM` blocks an SM ask for, none shorter
    than `min_chunk_groups` and none empty. A problem too small to split
    runs as one kernel that writes the result itself."""
    groups = max(1, -(-nd // _THREADS))
    want = min(-(-_BLOCKS_PER_SM * sm_count // max(1, -(-nq // _THREADS))),
               max(1, groups // min_chunk_groups(k, grouped)))
    chunk_groups = -(-groups // want)
    n_split = -(-groups // chunk_groups)
    return Plan(n_split, chunk_groups * _THREADS, n_split > 1)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernels_enqueued() -> int:
    """Kernels that the library has enqueued since it was loaded, counted in
    csrc/knn.cu beside each launch: the difference around one wrapper call
    is the number of kernels that call cost."""
    return build().vil_knn_kernels_enqueued()


def _check(queries, database, db_valid, k: int):
    for name, t in (("queries", queries), ("database", database), ("db_valid", db_valid)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.dtype != torch.float32 or database.dtype != torch.float32:
        raise ValueError("queries and database must be float32")
    if db_valid.dtype != torch.bool:
        raise ValueError("db_valid must be bool")
    if queries.ndim != 2 or queries.shape[1] != 3 or database.ndim != 2 \
            or database.shape[1] != 3 or db_valid.shape != (database.shape[0],):
        raise ValueError(f"shapes: queries {tuple(queries.shape)}, database "
                         f"{tuple(database.shape)}, db_valid {tuple(db_valid.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}")


def _launch(queries, database, db_valid, k: int, grouped: bool, form: str):
    _check(queries, database, db_valid, k)
    knn_plain._check_form(form)
    lib = build()
    dev = queries.device
    nq, nd = queries.shape[0], database.shape[0]
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    how = plan(nq, nd, k, _sm_count(dev), grouped)
    part_d = part_i = None  # the chunks' lists, where a merge reads them
    if how.merge:
        part_d = torch.empty((nq, how.n_split, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((nq, how.n_split, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.vil_knn_launch(
            queries.data_ptr(), database.data_ptr(), db_valid.data_ptr(), nq, nd, k,
            int(grouped), int(form == "diff"), how.chunk, how.n_split,
            part_d.data_ptr() if how.merge else None,
            part_i.data_ptr() if how.merge else None,
            out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vil_knn_launch failed with cudaError {err} "
                           f"(nq={nq}, nd={nd}, k={k}, grouped={grouped}, form={form}, "
                           f"plan={tuple(how)})")
    return out_d, out_i


def knn_grouped(queries, database, db_valid, k: int = 5, form: str = "expanded"):
    """K1: grouped approximate kNN (semantics of ops/knn.py:knn_grouped).
    CUDA tensors launch csrc/knn.cu; CPU tensors take the plain version."""
    if queries.device.type == "cpu":
        return knn_grouped_plain(queries, database, db_valid, k=k, form=form)
    out = _launch(queries, database, db_valid, k, grouped=True, form=form)
    knn_grouped.launches += 1
    knn_grouped.launches_diff += form == "diff"
    knn_grouped.last_call = (queries.shape[0], database.shape[0], k)
    return out


knn_grouped.launches = 0  # kernel launches, both forms
knn_grouped.launches_diff = 0  # those with form="diff"
knn_grouped.last_call = None  # (Nq, Nd, k) of the latest launch


def knn_exact(queries, database, db_valid, k: int = 5, tile: int = 2048,
              form: str = "expanded"):
    """K2: exact kNN, ties to the lower index. CUDA tensors launch
    csrc/knn.cu (`tile` is the plain version's scan tile); CPU tensors take
    the plain version."""
    if queries.device.type == "cpu":
        return knn_exact_plain(queries, database, db_valid, k=k, tile=tile, form=form)
    out = _launch(queries, database, db_valid, k, grouped=False, form=form)
    knn_exact.launches += 1
    knn_exact.launches_diff += form == "diff"
    knn_exact.last_call = (queries.shape[0], database.shape[0], k)
    return out


knn_exact.launches = 0
knn_exact.launches_diff = 0
knn_exact.last_call = None


def sparse_search_cuda(prob: knn_plain.SparseProblem, k: int, radius: float, db_tile: int):
    """K3's kernel on a prepared problem (ops/knn.py:sparse_prepare, query
    tile 128): the CUDA counterpart of `sparse_search_plain`. Returns rows of
    the tiled problem (ascending, sorted-database indices, index 0 where
    missing). Counts one launch."""
    lib = build()
    dev = prob.q.device
    nqp, ndp = prob.q.shape[0], prob.db.shape[0]
    n_split = min(ndp // db_tile,
                  max(1, -(-_BLOCKS_PER_SM * _sm_count(dev) // (nqp // _THREADS))))
    out_d = torch.empty((nqp, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nqp, k), dtype=torch.int32, device=dev)
    part_d = torch.empty((nqp, n_split, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nqp, n_split, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.vil_knn_sparse_launch(
            prob.q.data_ptr(), prob.db.data_ptr(), prob.db_valid.data_ptr(),
            prob.q_lo.data_ptr(), prob.q_hi.data_ptr(), prob.d_lo.data_ptr(),
            prob.d_hi.data_ptr(), nqp, ndp, k, db_tile, n_split, float(radius) ** 2,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vil_knn_sparse_launch failed with cudaError {err} "
                           f"(nq={nqp}, nd={ndp}, k={k}, db_tile={db_tile})")
    knn_sparse.launches += 1
    return out_d, out_i


def knn_sparse(queries, database, db_valid, k: int = 5, radius: float = 3.0,
               q_tile: int = SPARSE_Q_TILE, db_tile: int = SPARSE_DB_TILE,
               cell: float = 2.0, q_sorted: bool = False, db_sorted: bool = False):
    """K3: kNN exact for every neighbour within `radius` (farther ones may
    come back missing; callers gate on d2 < radius^2). Semantics of
    ops/knn.py:knn_sparse, whose Morton sort, tile boxes and finishing step
    this shares (plain tensor code, as in the reference); the block-skipping
    search itself is the CUDA kernel. On CUDA q_tile must be 128 (one query
    per thread) and db_tile a multiple of 128. CPU tensors take the plain
    version."""
    if queries.device.type == "cpu":
        return knn_sparse_plain(queries, database, db_valid, k=k, radius=radius,
                                q_tile=q_tile, db_tile=db_tile, cell=cell,
                                q_sorted=q_sorted, db_sorted=db_sorted)
    _check(queries, database, db_valid, k)
    if q_tile != _THREADS or db_tile <= 0 or db_tile % _THREADS:
        raise ValueError(f"on CUDA q_tile must be {_THREADS} and db_tile a multiple "
                         f"of {_THREADS}, got {q_tile} and {db_tile}")
    nq = queries.shape[0]
    if nq == 0 or database.shape[0] == 0:
        return (torch.full((nq, k), float("inf"), device=queries.device),
                torch.zeros((nq, k), dtype=torch.int32, device=queries.device))
    prob = knn_plain.sparse_prepare(queries, database, db_valid, q_tile, db_tile, cell,
                                    q_sorted, db_sorted)
    out_d, out_i = sparse_search_cuda(prob, k, radius, db_tile)
    knn_sparse.last_call = (nq, database.shape[0], k)
    return knn_plain.sparse_finish(prob, out_d, out_i)


knn_sparse.launches = 0
knn_sparse.last_call = None


def knn(queries, database, db_valid, k: int = 5, tile: int = 4096,
        radius: float | None = None,
        q_sorted: bool = False, db_sorted: bool = False,
        approx: bool = False, form: str = "expanded"):
    """Dispatch (signature of knn_pallas.knn plus `form`). With `radius`
    results are only guaranteed exact for neighbours within that distance:
    K3, whatever `approx` says (the grouped merge is wrong on spatially
    sorted buffers, so K1 is never chosen with radius, q_sorted or
    db_sorted). Otherwise K1 for approx=True and K2 for the rest, in the
    distance form `form`. q_sorted/db_sorted: that side is already in Morton
    order (ops/knn.py:morton_sort) and results come back in the given order."""
    if radius is not None:
        return knn_sparse(queries, database, db_valid, k=k, radius=radius,
                          q_sorted=q_sorted, db_sorted=db_sorted)
    if approx and not (q_sorted or db_sorted):
        return knn_grouped(queries, database, db_valid, k=k, form=form)
    return knn_exact(queries, database, db_valid, k=k, tile=min(tile, 2048), form=form)
