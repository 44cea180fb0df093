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
build/kernels/ at first use (ops/cuda/nvcc.py) and bound with ctypes: pointers from
`data_ptr()`, the stream from `torch.cuda.current_stream()`. Importing this
module builds nothing. There is no fallback: a CUDA tensor either runs the
kernel or raises.
"""
import ctypes
import functools
import math
import re
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from vil_fusion_tpu_torch.ops import knn as knn_plain
from vil_fusion_tpu_torch.ops.cuda import nvcc
from vil_fusion_tpu_torch.utils import graphs

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "knn.cu"
BUILD_DIR, NVCC_FLAGS = nvcc.BUILD_DIR, nvcc.NVCC_FLAGS  # (the tools build older sources)
MAX_K = 8
_THREADS = 128  # threads per block and columns per group (csrc/knn.cu)

# The custom ops below read their type annotations at definition: this module
# has no `from __future__ import annotations`.

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
# buffers replaced by larger ones: a captured graph may still point at them
_retired: list = []
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
    out, log, secs = nvcc.compile_library(SOURCE, "vil_knn", verbose)
    if verbose:
        print(f"nvcc {SOURCE.name}: {secs:.2f} s", flush=True)
        print(_ptxas_summary(log), flush=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.vil_knn_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 3
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


def plan(nq: int, nd: int, k: int, sm_count: int, grouped: bool = False,
         batch: int = 1) -> Plan:
    """The launch plan from the shape, the kernel, the card's SM count and
    the number of sequences of a batched launch alone.

    As many chunks as `_BLOCKS_PER_SM` blocks an SM ask for, counting the
    blocks of every sequence, none shorter than `min_chunk_groups` and none
    empty. A problem too small to split runs as one kernel that writes the
    result itself. The split changes no row (the top-k of a union is the
    top-k of its parts', and K1's groups never straddle a chunk)."""
    groups = max(1, -(-nd // _THREADS))
    want = min(-(-_BLOCKS_PER_SM * sm_count // (max(1, -(-nq // _THREADS)) * max(1, batch))),
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


def _grow(bufs: dict, dev: torch.device, what: str, make):
    """Replace the per-device buffer in `bufs` by `make()`, keeping the old
    one alive (a graph captured with it still uses it). Refused while this
    thread captures a graph: the new buffer would come from the graph's
    private pool (a step's eager warm-up calls size the buffers first)."""
    if graphs.capturing():
        raise RuntimeError(f"knn_cuda: the {what} buffer would grow inside a graph capture")
    if dev in bufs:
        _retired.append(bufs[dev])
    bufs[dev] = make()
    return bufs[dev]


def _scratch(dev: torch.device, nbytes: int) -> torch.Tensor:
    """A device buffer of at least `nbytes`, kept per device and grown when
    too small (not while capturing: `_grow`): K3's tile boxes and lists and
    the Morton keys' partial minima. The kernels that use it run on the
    caller's current stream in the order they were enqueued, so one buffer
    serves them all (global fusion's own stream calls K2 alone, which takes
    none)."""
    buf = _scratch_bufs.get(dev)
    if buf is None or buf.numel() < nbytes:
        buf = _grow(_scratch_bufs, dev, "scratch", lambda: torch.empty(
            max(nbytes, 1 << 16), dtype=torch.uint8, device=dev))
    return buf


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """K3's per-query-tile counts of finished blocks: int32 zeros, kept per
    device (the search kernel leaves them 0) and replaced by zeros when too
    short (not while capturing: `_grow`)."""
    buf = _counter_bufs.get(dev)
    if buf is None or buf.numel() < n:
        buf = _grow(_counter_bufs, dev, "counter", lambda: torch.zeros(
            max(n, 1024), dtype=torch.int32, device=dev))
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


def _count(fn, shape, diff: bool = False, batched: bool = False):
    """One launch of wrapper `fn` at `shape` (Nq, Nd, k), (S, Nq, Nd, k)
    for a batched launch over S sequences, or (n,). The wrappers call it
    through `graphs.record_launch`: inside a captured graph at each replay,
    under the replaying thread's launch_stage."""
    with _launch_lock:
        fn.launches += 1
        fn.launches_diff += diff
        fn.launches_batched += batched
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
            fn.launches_batched = 0
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


def _batch_view(t, base_ndim: int, lead: tuple):
    """(stride, one sequence, view) of one side of a batched call: its
    leading dims flattened to one sequence a row, the elements between two
    sequences and the first sequence (what the checks look at); or stride 0
    and the side itself where it has none (shared by every sequence)."""
    if t.ndim == base_ndim:
        return 0, t, t
    if tuple(t.shape[:-base_ndim]) != lead:
        raise ValueError(f"batch dims {tuple(t.shape[:-base_ndim])}, expected {lead} or none")
    flat = t.reshape((-1,) + tuple(t.shape[-base_ndim:]))
    return flat[0].numel(), flat[0], flat


def _launch(queries, database, db_valid, k: int, grouped: bool, form: str):
    """One launch of K1 / K2 over every sequence of the call: queries
    (*B, Nq, 3), database (*B, Nd, 3), db_valid (*B, Nd), a side without B
    shared by all sequences (stride 0). Returns (*B, Nq, k)."""
    lead = () if queries.ndim == 2 and database.ndim == 2 and db_valid.ndim == 1 else tuple(
        torch.broadcast_shapes(queries.shape[:-2], database.shape[:-2], db_valid.shape[:-1]))
    q_stride, q1, q = _batch_view(queries, 2, lead)
    db_stride, db1, db = _batch_view(database, 2, lead)
    v_stride, v1, v = _batch_view(db_valid, 1, lead)
    _check(q1, db1, v1, k)
    knn_plain._check_form(form)
    dev = queries.device
    batch = math.prod(lead)
    nq, nd = queries.shape[-2], database.shape[-2]
    out_d = torch.empty(lead + (nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty(lead + (nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    lib = build()
    how = plan(nq, nd, k, _sm_count(dev), grouped, batch)
    part_d = part_i = None  # the chunks' lists, where a merge reads them
    if how.merge:
        part_d = torch.empty((batch, nq, how.n_split, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((batch, nq, how.n_split, k), dtype=torch.int32, device=dev)
    with _launch_lock, torch.cuda.device(dev):
        err = lib.vil_knn_launch(
            q.data_ptr(), db.data_ptr(), v.data_ptr(), nq, nd, k,
            int(grouped), int(form == "diff"), how.chunk, how.n_split, batch,
            q_stride, db_stride, v_stride,
            part_d.data_ptr() if how.merge else None,
            part_i.data_ptr() if how.merge else None,
            out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vil_knn_launch failed with cudaError {err} "
                           f"(batch={batch}, nq={nq}, nd={nd}, k={k}, grouped={grouped}, "
                           f"form={form}, plan={tuple(how)})")
    return out_d, out_i


def _to_front(t, dim, size: int, base_ndim: int):
    """A vmap rule's argument with the vmapped dim first; an argument not
    vmapped at this level stays shared (no leading dims) or is expanded to
    `size` (leading dims of an outer level)."""
    if dim is not None:
        return t.movedim(dim, 0)
    if t.ndim == base_ndim:
        return t
    return t.unsqueeze(0).expand((size,) + tuple(t.shape))


def _in_transform() -> bool:
    """Inside torch.func.vmap (or another torch.func transform): a wrapper
    goes through its custom op, whose vmap rule batches it. Outside, it
    calls the implementation directly: the custom op's dispatch costs more
    host time than a small launch takes on the card."""
    return torch._C._are_functorch_transforms_active()


def _knn_dense_impl(queries, database, db_valid, k, grouped, form, tile):
    """K1 (`grouped`) or K2 over leading batch dims: the CUDA kernels' one
    launch for every sequence on CUDA tensors (counted once), the plain
    batched versions on CPU tensors."""
    if queries.device.type == "cpu":
        if grouped:
            return knn_grouped_plain(queries, database, db_valid, k=k, form=form)
        return knn_exact_plain(queries, database, db_valid, k=k, tile=tile, form=form)
    out = _launch(queries.contiguous(), database.contiguous(), db_valid.contiguous(), k,
                  grouped, form)
    shape = (queries.shape[-2], database.shape[-2], k)
    lead = out[0].shape[:-2]
    graphs.record_launch(_count, knn_grouped if grouped else knn_exact,
                         (math.prod(lead),) + shape if lead else shape, form == "diff",
                         bool(lead))
    return out


@torch.library.custom_op("vil_fusion_torch::knn_dense", mutates_args=())
def _knn_dense(queries: torch.Tensor, database: torch.Tensor, db_valid: torch.Tensor, k: int,
               grouped: bool, form: str, tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`_knn_dense_impl` as an operator that torch.func.vmap batches with
    one call (the rule below): on the card one launch for the sequences."""
    return _knn_dense_impl(queries, database, db_valid, k, grouped, form, tile)


def _dense(*args):
    return _knn_dense(*args) if _in_transform() else _knn_dense_impl(*args)


@_knn_dense.register_vmap
def _knn_dense_vmap(info, in_dims, queries, database, db_valid, k, grouped, form, tile):
    n = info.batch_size
    out = _knn_dense(_to_front(queries, in_dims[0], n, 2), _to_front(database, in_dims[1], n, 2),
                     _to_front(db_valid, in_dims[2], n, 1), k, grouped, form, tile)
    return out, (0, 0)


def knn_grouped(queries, database, db_valid, k: int = 5, form: str = "expanded"):
    """K1: grouped approximate kNN (semantics of ops/knn.py:knn_grouped).
    CUDA tensors launch csrc/knn.cu; CPU tensors take the plain version.
    Leading batch dims (queries (*B, Nq, 3), database (*B, Nd, 3), db_valid
    (*B, Nd), a side without them shared) and torch.func.vmap are one
    launch over the sequences."""
    return _dense(queries, database, db_valid, k, True, form, 0)


def knn_exact(queries, database, db_valid, k: int = 5, tile: int = 2048,
              form: str = "expanded"):
    """K2: exact kNN, ties to the lower index. CUDA tensors launch
    csrc/knn.cu (`tile` is the plain version's scan tile); CPU tensors take
    the plain version. Batched as `knn_grouped`."""
    return _dense(queries, database, db_valid, k, False, form, tile)


def check_cell(cell: float):
    """The key kernel divides by `cell`; the plain version on a CUDA tensor
    multiplies by its float32 reciprocal. The two agree on every key only
    for a power of two (2.0 throughout the port), so another cell raises."""
    if not (cell > 0 and math.isfinite(cell) and math.frexp(cell)[0] == 0.5):
        raise ValueError(f"on CUDA the Morton cell must be a power of two, got {cell}")


def _loop_vmap(op):
    """A vmap rule for `op` that calls it once for each sequence and stacks
    the results: K3 and the Morton keys have no batched launch yet."""
    def rule(info, in_dims, *args):
        outs = [op(*(a if d is None else a.select(d, s) for a, d in zip(args, in_dims)))
                for s in range(info.batch_size)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
        return torch.stack(outs), 0
    op.register_vmap(rule)
    return op


def _morton_keys_impl(pts, valid, cell: float):
    if pts.device.type == "cpu":
        return morton_keys_plain(pts, valid, cell)
    return _morton_keys_cuda(pts, valid, cell)


@torch.library.custom_op("vil_fusion_torch::morton_keys", mutates_args=())
def _morton_keys(pts: torch.Tensor, valid: Optional[torch.Tensor], cell: float) -> torch.Tensor:
    return _morton_keys_impl(pts, valid, cell)


def morton_keys(pts, valid=None, cell: float = 2.0):
    """30-bit Morton keys (int32) of points (n, 3) in 1024 cells an axis of
    size `cell` from the least valid point minus 1e-3; 0x7FFFFFFF for an
    invalid point (semantics of ops/knn.py:morton_keys). CUDA tensors launch
    csrc/knn.cu's two key kernels and count one launch (`cell` a power of
    two: `check_cell`); CPU tensors take the plain version. Under
    torch.func.vmap one call a sequence."""
    return (_morton_keys if _in_transform() else _morton_keys_impl)(pts, valid, float(cell))


def _morton_keys_cuda(pts, valid, cell: float):
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
    graphs.record_launch(_count, morton_keys, (n,))
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
    multiple of 128. CPU tensors take the plain version. Under
    torch.func.vmap one call a sequence."""
    return (_knn_sparse if _in_transform() else _knn_sparse_impl)(
        queries, database, db_valid, k, float(radius), q_tile, db_tile, float(cell), q_sorted,
        db_sorted)


@torch.library.custom_op("vil_fusion_torch::knn_sparse", mutates_args=())
def _knn_sparse(queries: torch.Tensor, database: torch.Tensor, db_valid: torch.Tensor, k: int,
                radius: float, q_tile: int, db_tile: int, cell: float, q_sorted: bool,
                db_sorted: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return _knn_sparse_impl(queries, database, db_valid, k, radius, q_tile, db_tile, cell,
                            q_sorted, db_sorted)


def _knn_sparse_impl(queries, database, db_valid, k, radius, q_tile, db_tile, cell, q_sorted,
                     db_sorted):
    if queries.device.type == "cpu":
        return knn_sparse_plain(queries, database, db_valid, k=k, radius=radius,
                                q_tile=q_tile, db_tile=db_tile, cell=cell,
                                q_sorted=q_sorted, db_sorted=db_sorted)
    return _knn_sparse_cuda(queries, database, db_valid, k, radius, q_tile, db_tile, cell,
                            q_sorted, db_sorted)


def _knn_sparse_cuda(queries, database, db_valid, k, radius, q_tile, db_tile, cell, q_sorted,
                     db_sorted):
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
    graphs.record_launch(_count, knn_sparse, (nq, nd, k))
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


_loop_vmap(_morton_keys)
_loop_vmap(_knn_sparse)

# launches (every thread): `launches` in all, `launches_diff` of them with
# form="diff", `launches_batched` of them over a sequence axis (one launch
# for the batch), `last_call` the (Nq, Nd, k) (batched: (S, Nq, Nd, k)) of
# the latest, and per launch_stage name the count and the shapes
reset_counts()
