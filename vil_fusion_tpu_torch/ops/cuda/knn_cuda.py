"""kNN dispatcher and the CUDA wrappers of K1 (grouped), K2 (exact), K3
(sparse) and of the Morton keys that K3's callers sort by.

Counterpart of vil_fusion_tpu/ops/pallas/knn_pallas.py: `knn` keeps the
dispatcher's signature (knn_pallas.py:496-528) and routes by the tensors'
device. On CUDA, `radius=` goes to K3 (`knn_sparse`, replacing
`_sparse_knn_kernel` with its tile boxes, padding and finishing step:
Morton-sorted sides, far blocks skipped, difference-form distances),
`approx=True` to K1 (`knn_grouped`, replacing `_knn_kernel_grouped`) and
everything else to K2 (`knn_exact`, replacing `_knn_kernel`); K1 and K2
take `form="expanded"` (the reference's mxu=True form, the default) or
`form="diff"` (its mxu=False form). `morton_sort` (knn_pallas.py:379) keeps
the plain version's signature: its keys are a kernel, the sort stays
`torch.argsort`. A CPU tensor goes to the plain PyTorch versions in
ops/knn.py, re-exported here as `knn_grouped_plain` / `knn_exact_plain` /
`knn_sparse_plain` / `morton_keys_plain`.

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
import math
import os
import re
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
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
# K3's blocks hold SPARSE_GROUPS groups of 128 threads (csrc/knn.cu)
SPARSE_GROUPS = 8
_MORTON_SCRATCH_BYTES = 3 * 4 * 256  # the key kernels' partial minima

knn_exact_plain = knn_plain.knn
knn_grouped_plain = knn_plain.knn_grouped
knn_sparse_plain = knn_plain.knn_sparse
morton_keys_plain = knn_plain.morton_keys

_lib = None
_scratch_bufs: dict = {}
_counter_bufs: dict = {}
# Threads that launch on one device share its scratch buffers: a call's
# kernels are enqueued under this lock, so no other call's land between them
# on the stream. The launch counts below are updated under it too.
_launch_lock = threading.Lock()
_stage = threading.local()


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
    fn = lib.vil_knn_sparse
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    fn = lib.vil_morton_keys
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    lib.vil_knn_kernels_enqueued.argtypes = []
    lib.vil_knn_kernels_enqueued.restype = ctypes.c_longlong
    _lib = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '\w*?(knn_(?:sparse|dense|merge)_kernel)"
                    r"ILi(\d)E(?:Lb([01])ELb([01])E)?")


def _ptxas_summary(log: str, ks=(1, 3, 5)) -> str:
    """Registers / spills / shared memory of the kernel instances with k in
    `ks`, from nvcc's -Xptxas -v report, and the count of instances that
    spill among all of them."""
    out, label, spilling, name = [], None, [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if "Compiling entry function" in line:
            label = None
            name = line.split("'")[1] if "'" in line else line
        if m:
            kind = ""
            if m.group(3):
                kind = ((", grouped" if m.group(3) == "1" else ", exact")
                        + (", diff" if m.group(4) == "1" else ", expanded"))
            label = f"{m.group(1)}<k={m.group(2)}{kind}>" if int(m.group(2)) in ks else None
        elif "spill" in line:
            if "0 bytes spill stores, 0 bytes spill loads" not in line:
                spilling.append(name)
            if label:
                out.append(f"  {label}: {line.split(':', 1)[-1].strip()}")
        elif label and "Used" in line:
            out.append(f"  {label}: {line.split(':', 1)[-1].strip()}")
    out.append(f"  instances that spill, all k: {len(spilling)} {spilling}")
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


class SparsePlan(NamedTuple):
    """How one K3 call is launched: n_split blocks of SPARSE_GROUPS x 128
    threads a query tile of 128."""
    n_split: int  # blocks a query tile (gridDim.y), which deal its near list out
    blocks: int  # query tiles (gridDim.x)
    db_tiles: int  # database tiles, one box each
    kernels: int  # kernels the call enqueues: the box kernel (with a tile), the search


def sparse_plan(nq: int, nd: int, sm_count: int, db_tile: int = SPARSE_DB_TILE) -> SparsePlan:
    """K3's launch plan from the shape and the card's SM count alone (the
    near-tile lists are never read on the host).

    A block fills an SM, so a query tile gets as many blocks as the card
    has SMs for each tile, and no more than it takes to give every group
    of the split one database tile where all are near. With a split the
    tile's last block merges the blocks' lists inside the search kernel.
    No query: nothing is launched."""
    if nq <= 0:
        return SparsePlan(0, 0, 0, 0)
    blocks, db_tiles = -(-nq // _THREADS), -(-nd // db_tile)
    n_split = max(1, min(sm_count // blocks, -(-db_tiles // SPARSE_GROUPS)))
    return SparsePlan(n_split, blocks, db_tiles, 1 + (db_tiles > 0))


def sparse_scratch_bytes(how: SparsePlan, k: int) -> int:
    """K3's scratch: 32 B of box a database tile, and with a split the
    groups' lists, (distance, index) for k neighbours of 128 rows."""
    lists = how.blocks * how.n_split * SPARSE_GROUPS * k * _THREADS if how.n_split > 1 else 0
    return 32 * how.db_tiles + 8 * lists


def _scratch(dev: torch.device, nbytes: int) -> torch.Tensor:
    """A device buffer of at least `nbytes`, kept per device and grown when
    too small: K3's tile boxes and lists and the Morton keys' partial
    minima. The kernels that use it run on the caller's current stream in
    the order they were enqueued, so one buffer serves them all."""
    buf = _scratch_bufs.get(dev)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8, device=dev)
        _scratch_bufs[dev] = buf
    return buf


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """K3's per-query-tile counts of finished blocks: int32 zeros, kept per
    device (the search kernel leaves them 0) and replaced by zeros when too
    short."""
    buf = _counter_bufs.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _counter_bufs[dev] = buf
    return buf


def kernels_enqueued() -> int:
    """Kernels that the library has enqueued since it was loaded, counted in
    csrc/knn.cu beside each launch: the difference around one wrapper call
    is the number of kernels that call cost."""
    return build().vil_knn_kernels_enqueued()


@contextmanager
def launch_stage(name: str):
    """Count this thread's launches inside the block under `name` too
    (`<wrapper>.launches_by_stage[name]`, with the shapes of its calls in
    `<wrapper>.calls_by_stage[name]`), beside the wrapper's total. A
    pipeline's worker thread counts its launches apart this way."""
    prev = getattr(_stage, "name", None)
    _stage.name = name
    try:
        yield
    finally:
        _stage.name = prev


def _count(fn, shape, diff: bool = False):
    """One launch of wrapper `fn` at `shape` (Nq, Nd, k) or (n,)."""
    with _launch_lock:
        fn.launches += 1
        fn.launches_diff += diff
        fn.last_call = shape
        name = getattr(_stage, "name", None)
        if name is not None:
            fn.launches_by_stage[name] = fn.launches_by_stage.get(name, 0) + 1
            calls = fn.calls_by_stage.setdefault(name, {})
            calls[shape] = calls.get(shape, 0) + 1


def reset_counts():
    """Set every wrapper's launch counts to 0."""
    with _launch_lock:
        for fn in (knn_grouped, knn_exact, knn_sparse, morton_keys):
            fn.launches = 0
            fn.launches_diff = 0
            fn.last_call = None
            fn.launches_by_stage = {}
            fn.calls_by_stage = {}


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
    with _launch_lock, torch.cuda.device(dev):
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
    _count(knn_grouped, (queries.shape[0], database.shape[0], k), form == "diff")
    return out


def knn_exact(queries, database, db_valid, k: int = 5, tile: int = 2048,
              form: str = "expanded"):
    """K2: exact kNN, ties to the lower index. CUDA tensors launch
    csrc/knn.cu (`tile` is the plain version's scan tile); CPU tensors take
    the plain version."""
    if queries.device.type == "cpu":
        return knn_exact_plain(queries, database, db_valid, k=k, tile=tile, form=form)
    out = _launch(queries, database, db_valid, k, grouped=False, form=form)
    _count(knn_exact, (queries.shape[0], database.shape[0], k), form == "diff")
    return out


def check_cell(cell: float):
    """The key kernel divides by `cell`; the plain version on a CUDA tensor
    multiplies by its float32 reciprocal. The two agree on every key only
    for a power of two (2.0 throughout the port), so another cell raises."""
    if not (cell > 0 and math.isfinite(cell) and math.frexp(cell)[0] == 0.5):
        raise ValueError(f"on CUDA the Morton cell must be a power of two, got {cell}")


def morton_keys(pts, valid=None, cell: float = 2.0):
    """30-bit Morton keys (int32) of points (n, 3) in 1024 cells an axis of
    size `cell` from the least valid point minus 1e-3; 0x7FFFFFFF for an
    invalid point (semantics of ops/knn.py:morton_keys). CUDA tensors launch
    csrc/knn.cu's two key kernels and count one launch (`cell` a power of
    two: `check_cell`); CPU tensors take the plain version."""
    if pts.device.type == "cpu":
        return morton_keys_plain(pts, valid, cell)
    check_cell(cell)
    if not pts.is_cuda or pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be an (n, 3) CUDA tensor, got {tuple(pts.shape)} on "
                         f"{pts.device}")
    if valid is not None and (valid.device != pts.device or valid.dtype != torch.bool
                              or valid.shape != (pts.shape[0],)):
        raise ValueError(f"valid must be an (n,) bool tensor on {pts.device}")
    pts = pts.float().contiguous()  # no copy where they already are
    valid = None if valid is None else valid.contiguous()
    dev, n = pts.device, pts.shape[0]
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return keys
    lib = build()
    with _launch_lock, torch.cuda.device(dev):
        err = lib.vil_morton_keys(pts.data_ptr(), None if valid is None else valid.data_ptr(),
                                  n, float(cell), _scratch(dev, _MORTON_SCRATCH_BYTES).data_ptr(),
                                  keys.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vil_morton_keys failed with cudaError {err} (n={n}, cell={cell})")
    _count(morton_keys, (n,))
    return keys


def morton_sort(pts, valid=None, cell: float = 2.0):
    """Spatial (Morton) sort permutation (int64, stable; invalid points
    last): the plain version's (ops/knn.py:morton_sort) signature and
    permutation. On CUDA the keys are `morton_keys`'s kernels and the sort
    `torch.argsort(stable=True)`; CPU tensors take the plain version."""
    if pts.device.type == "cpu":
        return knn_plain.morton_sort(pts, valid, cell)
    return torch.argsort(morton_keys(pts, valid, cell), stable=True)


def knn_sparse(queries, database, db_valid, k: int = 5, radius: float = 3.0,
               q_tile: int = SPARSE_Q_TILE, db_tile: int = SPARSE_DB_TILE,
               cell: float = 2.0, q_sorted: bool = False, db_sorted: bool = False):
    """K3: kNN exact for every neighbour within `radius` (farther ones may
    come back missing; callers gate on d2 < radius^2). Semantics of
    ops/knn.py:knn_sparse, equal to it on every row. On CUDA the whole call
    is csrc/knn.cu's box kernel and search (`sparse_plan`): the tile boxes,
    the padding and the finishing step are in the kernels; a side that is
    not `*_sorted` is Morton-sorted first (`morton_sort`) and read through
    its permutation. q_tile must be 128 (one query a thread) and db_tile a
    multiple of 128. CPU tensors take the plain version."""
    if queries.device.type == "cpu":
        return knn_sparse_plain(queries, database, db_valid, k=k, radius=radius,
                                q_tile=q_tile, db_tile=db_tile, cell=cell,
                                q_sorted=q_sorted, db_sorted=db_sorted)
    _check(queries, database, db_valid, k)
    if q_tile != _THREADS or db_tile <= 0 or db_tile % _THREADS:
        raise ValueError(f"on CUDA q_tile must be {_THREADS} and db_tile a multiple "
                         f"of {_THREADS}, got {q_tile} and {db_tile}")
    dev = queries.device
    nq, nd = queries.shape[0], database.shape[0]
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    how = sparse_plan(nq, nd, _sm_count(dev), db_tile)
    if how.kernels == 0:
        return out_d, out_i
    q_perm = None if q_sorted else morton_sort(queries, cell=cell)
    d_perm = None if db_sorted or nd == 0 else morton_sort(database, db_valid, cell=cell)
    lib = build()
    with _launch_lock, torch.cuda.device(dev):
        err = lib.vil_knn_sparse(
            queries.data_ptr(), None if q_perm is None else q_perm.data_ptr(), nq,
            database.data_ptr(), db_valid.data_ptr(), None if d_perm is None else d_perm.data_ptr(),
            nd, k, db_tile, how.n_split, float(radius) ** 2,
            _scratch(dev, sparse_scratch_bytes(how, k)).data_ptr(),
            _counters(dev, how.blocks).data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vil_knn_sparse failed with cudaError {err} "
                           f"(nq={nq}, nd={nd}, k={k}, db_tile={db_tile}, plan={tuple(how)})")
    _count(knn_sparse, (nq, nd, k))
    return out_d, out_i


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


# launches (every thread): `launches` in all, `launches_diff` of them with
# form="diff", `last_call` the (Nq, Nd, k) of the latest, and per
# launch_stage name the count and the shapes
reset_counts()
