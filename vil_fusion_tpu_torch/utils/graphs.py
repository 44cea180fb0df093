"""CUDA graphs of the port's pure steps: the counterpart of the reference's
`jax.jit` (models/estimator.py:279, `static_argnames=("cfg",)`).

`step(name, fn, args, static)` runs the pure function `fn(*args)` of
tensors and (Named)tuples / dicts of tensors as one captured CUDA graph,
keyed on (name, `static`, the arguments' structure, shapes, dtypes and
device) as the jit keys on its static arguments and shapes. The first call
with a key runs `fn` eagerly (a shape seen once, such as a scan of a size
that never comes back, is not worth a capture and its private memory
pool); the second captures, unless MAX_GRAPHS graphs of that name exist
already (then the key keeps running `fn`). A capture:

  * the arguments are cloned into static buffers (a Python number becomes a
    0-d int32 / float32 / bool tensor);
  * a few eager calls on a side stream warm the step up (the kernels'
    builds, cuBLAS / cuSOLVER handles, functorch, `host_constant`s); the
    step is pure, so their outputs are dropped and no state changes;
  * one call is captured (`capture_error_mode="thread_local"`), holding
    `lock` where another thread enqueues on the same device (a thread that
    holds that lock already, as the visual-loop worker holds the pipeline's
    step lock through its job, passes none). A capture holds its key's
    lock only: other threads replay their graphs meanwhile.

Every call from the capture on copies its arguments into the static
buffers (`copy_`, or `fill_` for a number), replays the graph (a span
"graph.<name>" of utils/tracing.py: with device timing, its device interval
is the replay's) and returns clones of the outputs. Copying on every call means that host code may
rebind the state between calls (a restart, a relocalization's gauge
transform, a checkpoint's restore) without telling anyone; cloning means
that no output aliases a buffer the next replay overwrites, so snapshots
and frames in flight keep their values. A failed capture raises: there is
no eager fallback.

A step called while this thread warms up or captures another step (the
frame's graph takes in the estimator's step) runs its body inline: its
kernels become part of the outer graph, and no second capture is started
(CUDA refuses a nested one). Inside `with inline():` every step of this
thread runs its eager body (to hold a graph against it).

`cond(pred, true_fn, false_fn, operands)` is the port's `lax.cond`: while
this thread captures through `step` it records a conditional node (two IF
bodies, on `pred` and on its negation), so a replay runs the taken branch
only; elsewhere (the CPU, the warm-up calls, the eager bodies) both
branches run and torch.where selects, with no host read.

Kernel wrappers count their launches through `record_launch`: while this
thread captures, a launch is recorded and counted again at each replay of
the graph (the replay launches it), else it is counted at once. A launch
recorded inside a conditional body counts only at the replays that ran the
body: a replay copies its predicates into pinned memory behind an event,
and `settle()` counts those launches once the copy has landed (the
pipeline calls it where it reads the frame's results anyway; it never
waits unless asked to).
`host_constant` gives a step the tensors it would otherwise copy from host
data on every call (a blocking copy on a CUDA device, and not allowed while
capturing): made once per (values, dtype, device); `upload` copies host
data a step's caller passes in through pinned memory, without waiting.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

count_lock = threading.Lock()  # kernel wrappers update their launch counts under it
_tls = threading.local()

# replays and eager calls (a key's first call, or one over MAX_GRAPHS) by
# step name, and the capture record of every captured step
replays: dict = {}
eager_calls: dict = {}
captures: list = []
MAX_GRAPHS = 16  # graphs kept a step name
_steps: dict = {}
_seen: set = set()  # keys called once
_graphs_by_name: dict = {}
_key_locks: dict = {}  # held while a key captures
_steps_lock = threading.Lock()


def use_graph(x: torch.Tensor) -> bool:
    """Whether a step on tensor `x` replays its CUDA graph: `x` on a CUDA
    device (elsewhere the caller runs the step's body)."""
    return x.is_cuda


@contextmanager
def inline():
    """Run every `step` of this thread inline (its eager body) inside the
    block."""
    _tls.inline = getattr(_tls, "inline", 0) + 1
    try:
        yield
    finally:
        _tls.inline -= 1


def capturing() -> bool:
    """Whether this thread is capturing a graph through `step`."""
    return (getattr(_tls, "capturing", None) is not None
            and torch.cuda.is_current_stream_capturing())


def record_launch(count: Callable, *args):
    """A kernel wrapper's launch count, `count(*args)`: recorded while this
    thread captures a graph through `step` (and counted at each replay, or
    inside a conditional body at each replay that ran the body), else
    counted now."""
    if not capturing():
        count(*args)
    elif getattr(_tls, "branch", None):
        _tls.cond_launches.append((count, args, tuple(_tls.branch)))
    else:
        _tls.capturing.append((count, args))


# -- conditional nodes ---------------------------------------------------------

def _select(pred, a: list, b: list) -> list:
    """torch.where(pred, x, y) leaf by leaf; a leaf both sides share is
    taken as it is."""
    return [x if x is y else torch.where(pred, x, y) for x, y in zip(a, b)]


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, operands: tuple):
    """true_fn(*operands) where the 0-d bool `pred` holds, else
    false_fn(*operands): the reference's lax.cond. Both functions are pure
    and return the same structure of tensors (shapes and dtypes alike).

    While this thread captures through `step`: a conditional node, two IF
    bodies (on `pred`, then on its negation) recorded by ops/cuda/cond_cuda
    (csrc/cond.cu); a replay runs the taken body only. The false body
    copies its outputs into the true body's, which hold the result after
    the node; a true output that shares storage with an operand or with an
    earlier output is cloned first, so that copy writes no input of the
    step. A failed capture raises. Elsewhere both functions run and every
    output is selected with torch.where on `pred` (nothing is read on the
    host)."""
    if not capturing():
        leaves_t: list = []
        spec = _flatten(true_fn(*operands), leaves_t)
        leaves_f: list = []
        if _flatten(false_fn(*operands), leaves_f) != spec:
            raise ValueError("graphs.cond: the branches return different structures")
        return _unflatten(spec, iter(_select(pred, leaves_t, leaves_f)))
    from vil_fusion_tpu_torch.ops.cuda import cond_cuda

    ops: list = []
    _flatten(operands, ops)
    storages = {x.untyped_storage().data_ptr() for x in ops if isinstance(x, torch.Tensor)}
    k = len(_tls.preds)
    _tls.preds.append(pred)
    spec, outs = None, None
    for branch, fn in enumerate((true_fn, false_fn)):
        with cond_cuda.body(pred, branch == 1, _tls.body_pools) as body:
            _tls.bodies.append(body)
            _tls.branch = getattr(_tls, "branch", []) + [(k, branch)]
            try:
                leaves: list = []
                s = _flatten(fn(*operands), leaves)
                if any(not isinstance(x, torch.Tensor) for x in leaves):
                    raise TypeError("graphs.cond: a branch returned a leaf that is no tensor")
                if branch == 0:
                    spec, outs, seen = s, [], set(storages)
                    for x in leaves:
                        ptr = x.untyped_storage().data_ptr()
                        outs.append(x.clone() if ptr in seen else x)
                        seen.add(ptr)
                else:
                    if s != spec or any(a.shape != b.shape or a.dtype != b.dtype
                                        for a, b in zip(outs, leaves)):
                        raise ValueError("graphs.cond: the branches return different "
                                         "structures")
                    for a, b in zip(outs, leaves):
                        a.copy_(b)
            finally:
                _tls.branch = _tls.branch[:-1]
    return _unflatten(spec, iter(outs))


class _Settlement:
    """The conditional launches of one replay: its predicates copied into
    pinned memory behind an event; `ready()` once they have landed."""

    def __init__(self, preds: list, launches: list):
        self.launches = launches
        self.host = torch.empty((len(preds),), dtype=torch.bool, pin_memory=True)
        for i, p in enumerate(preds):
            self.host[i:i + 1].copy_(p.reshape(1), non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def ready(self) -> bool:
        return self.event.query()

    def launches_of(self, taken: bool = True, wait: bool = False) -> list:
        """(count, args) of the launches in the bodies this replay ran
        (`taken`) or skipped."""
        if wait:
            self.event.synchronize()
        flags = self.host.tolist()
        return [(c, a) for c, a, conds in self.launches
                if all(flags[i] == (b == 0) for i, b in conds) == taken]


_pending: list = []  # replays whose conditional launches are not counted yet
_pending_lock = threading.Lock()


def settle(wait: bool = False) -> int:
    """Count the conditional launches of every replay whose predicates have
    landed on the host (with `wait`, of every replay: a host wait).
    Returns the replays settled."""
    with _pending_lock:
        done = [s for s in _pending if wait or s.ready()]
        for s in done:
            _pending.remove(s)
    for s in done:
        for count, a in s.launches_of(wait=wait):
            count(*a)
    return len(done)


def last_settlement():
    """The settlement of this thread's last replay (None where its graph
    holds no conditional node)."""
    return getattr(_tls, "last_settlement", None)


def _freeze(x):
    if isinstance(x, np.ndarray):
        x = x.tolist()
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return float(x) if isinstance(x, (np.floating, float)) else x


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def host_constant(values, dtype, device) -> torch.Tensor:
    """The tensor of the host `values` (a number, a nested tuple / list, a
    numpy array) as `dtype` on `device`, made at the first call for these
    (values, dtype, device) and shared by every later one. Callers read it
    and never write it."""
    return _constant(_freeze(values), dtype, torch.device(device))


def upload(x, device, dtype=None) -> torch.Tensor:
    """The host array `x` (as `dtype`, converted on the host) on `device`. On
    the card through pinned memory and without waiting for the stream (a
    pageable copy would wait for every kernel enqueued before it). The
    caller keeps no buffer: the copy records an event on the pinned block,
    and the caching host allocator reuses it only once that event has
    passed."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    t = t if dtype is None else t.to(dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# -- flattening of the arguments and outputs -----------------------------------

_NONE = ("none",)


def _flatten(x, leaves: list):
    """The structure of x (hashable) with its leaves appended to `leaves`:
    tuples, NamedTuples, lists and dicts are containers, None is an empty
    one, anything else a leaf."""
    if x is None:
        return _NONE
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return (dict, tuple(x.keys()), tuple(_flatten(v, leaves) for v in x.values()))
    leaves.append(x)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    if spec == _NONE:
        return None
    if spec[0] is dict:
        return dict(zip(spec[1], (_unflatten(s, it) for s in spec[2])))
    kind, kids = spec
    vals = [_unflatten(s, it) for s in kids]
    if kind in (tuple, list):
        return kind(vals)
    return kind(*vals)  # a NamedTuple


_NUMBER_DTYPES = {bool: torch.bool, int: torch.int32, float: torch.float32}


def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if type(x) in _NUMBER_DTYPES:
        return type(x)
    raise TypeError(f"graphs.step takes tensors and numbers as leaves, got {type(x)}")


def _graph_nodes(graph, bodies=()) -> Optional[dict]:
    """Nodes of a captured graph by type (kernel, memcpy, memset,
    conditional, other), its conditional bodies' included ("in_bodies":
    theirs alone), through libcuda's cuGraphGetNodes; None where this torch
    does not keep the graph or a body could not be read."""
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    if any(b is None for b in bodies):
        return None
    drv = ctypes.CDLL("libcuda.so.1")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset", 13: "conditional"}
    out = {"total": 0, "in_bodies": 0}
    for g in (raw, *bodies):
        n = ctypes.c_size_t(0)
        if drv.cuGraphGetNodes(ctypes.c_void_p(g), None, ctypes.byref(n)) != 0:
            return None
        nodes = (ctypes.c_void_p * n.value)()
        if drv.cuGraphGetNodes(ctypes.c_void_p(g), nodes, ctypes.byref(n)) != 0:
            return None
        out["total"] += int(n.value)
        out["in_bodies"] += int(n.value) if g != raw else 0
        t = ctypes.c_int(0)
        for node in nodes:
            drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
            k = kinds.get(t.value, "other")
            out[k] = out.get(k, 0) + 1
    return out


def _pool_bytes(graph, body_pools=()) -> Optional[int]:
    """Bytes of the segments of `graph`'s private memory pool and of its
    conditional bodies' pools (torch.cuda.MemPool); None where the
    allocator's snapshot does not name the pool of a segment."""
    pools = {tuple(graph.pool()), *(tuple(p.id) for p in body_pools)}
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) in pools)


def _check_device(name: str, leaves: list) -> torch.device:
    """The one CUDA device of the tensors in `leaves`, else ValueError."""
    devs = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"graphs.step({name!r}) needs its tensors on one CUDA device, "
                         f"got {devs}")
    return next(iter(devs))


class CapturedStep:
    """fn(*args) captured once as a CUDA graph and replayed (module
    docstring). `stats`: warm-up, capture and instantiation seconds, the
    graph's nodes by type, the device memory of its private pool (its
    segments, MiB; None where this torch does not name a segment's pool)
    and of its static argument buffers (MiB), the capturing thread's name,
    and the replays of every graph (other threads' included) made while
    the capture ran, by name."""

    def __init__(self, name: str, fn: Callable, args: tuple, warmup: int = 2,
                 lock=None):
        leaves: list = []
        self.spec = _flatten(args, leaves)
        self.name = name
        self.span = "graph." + name
        self.device = _check_device(name, leaves)
        self.static = [x.clone() if isinstance(x, torch.Tensor)
                       else torch.full((), x, dtype=_NUMBER_DTYPES[type(x)], device=self.device)
                       for x in leaves]
        self.launches = []
        self._lock = threading.Lock()
        static_args = _unflatten(self.spec, iter(self.static))
        with torch.cuda.device(self.device), (lock if lock is not None else nullcontext()):
            t0 = time.perf_counter()
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with inline(), torch.cuda.stream(side):
                for _ in range(warmup):
                    fn(*static_args)
            main.wait_stream(side)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with count_lock:
                replays0 = dict(replays)
            try:
                graph = torch.cuda.CUDAGraph(keep_graph=True)
            except TypeError:
                graph = torch.cuda.CUDAGraph()
            _tls.capturing, _tls.cond_launches, _tls.preds = [], [], []
            _tls.bodies, _tls.body_pools = [], []
            # cuBLAS takes its workspace by (handle, stream): every graph
            # captured on the one capture stream would share the workspace
            # of the first, and two of them replayed at once on two streams
            # (global fusion's beside the odometry's) would write it both.
            # Dropped here, it is allocated again inside this capture, from
            # this graph's private pool.
            torch._C._cuda_clearCublasWorkspaces()
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    out = fn(*static_args)
            finally:
                self.launches, _tls.capturing = _tls.capturing, None
                self.cond_launches, self.preds = _tls.cond_launches, _tls.preds
                self.body_pools, bodies = _tls.body_pools, _tls.bodies
            t2 = time.perf_counter()
            with count_lock:
                during = {k: v - replays0.get(k, 0) for k, v in replays.items()
                          if v != replays0.get(k, 0)}
            nodes = _graph_nodes(graph, bodies)
            if hasattr(graph, "instantiate"):
                graph.instantiate()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            pool = _pool_bytes(graph, self.body_pools)
        self.graph = graph
        out_leaves: list = []
        self.out_spec = _flatten(out, out_leaves)
        self.out = out_leaves
        self.stats = dict(name=name, warmup_s=t1 - t0, warmup_calls=warmup, capture_s=t2 - t1,
                          instantiate_s=t3 - t2, nodes=nodes,
                          pool_mib=None if pool is None else pool / 2**20,
                          thread=threading.current_thread().name, replays_during=during,
                          static_mib=sum(x.numel() * x.element_size()
                                         for x in self.static) / 2**20)

    def __call__(self, *args):
        leaves: list = []
        if _flatten(args, leaves) != self.spec:
            raise ValueError(f"graphs.step({self.name!r}): arguments of another structure")
        with self._lock:
            for s, x in zip(self.static, leaves):
                if isinstance(x, torch.Tensor):
                    if x.device != self.device:
                        raise ValueError(f"graphs.step({self.name!r}): an argument on {x.device}")
                    s.copy_(x)
                else:
                    s.fill_(x)
            with GLOBAL_TIMERS.timed(self.span):
                self.graph.replay()
            for count, a in self.launches:
                count(*a)
            settlement = None
            if self.preds:  # counted by settle() once the predicates land
                settlement = _Settlement(self.preds, self.cond_launches)
                with _pending_lock:
                    _pending.append(settlement)
            _tls.last_settlement = settlement
            out = [o.clone() if isinstance(o, torch.Tensor) else o for o in self.out]
        with count_lock:
            replays[self.name] = replays.get(self.name, 0) + 1
        return _unflatten(self.out_spec, iter(out))


def step(name: str, fn: Callable, args: tuple, static=(), lock=None):
    """fn(*args) through its CUDA graph, captured at the second call for this
    (name, static, argument signature): returns fresh output tensors. The
    first call, and every call of a key beyond MAX_GRAPHS graphs of `name`,
    runs fn(*args) eagerly (`eager_calls`). `static` holds what fn closes
    over and the graph depends on (the reference's static arguments); `lock`
    is held while capturing. Inside another step's warm-up or capture on
    this thread, fn(*args) runs inline (its kernels join the outer graph)."""
    if getattr(_tls, "inline", 0) or capturing():
        return fn(*args)
    leaves: list = []
    spec = _flatten(args, leaves)
    _check_device(name, leaves)
    key = (name, static, spec, tuple(_signature(x) for x in leaves))
    # a capture holds its key's lock only: another thread replays, or
    # captures another key, meanwhile (a thread that holds `lock` already,
    # as the visual-loop worker holds the pipeline's step lock, passes none)
    with _steps_lock:
        key_lock = _key_locks.setdefault(key, threading.Lock())
    with key_lock:
        with _steps_lock:
            cs = _steps.get(key)
            capture = (cs is None and key in _seen
                       and _graphs_by_name.get(name, 0) < MAX_GRAPHS)
            if capture:
                _graphs_by_name[name] = _graphs_by_name.get(name, 0) + 1
            _seen.add(key)
        if capture:
            try:
                cs = CapturedStep(name, fn, args, lock=lock)
            except BaseException:  # the key stays without a graph, its slot free
                with _steps_lock:
                    _graphs_by_name[name] -= 1
                raise
            with _steps_lock:
                _steps[key] = cs
                captures.append(cs.stats)
    if cs is None:
        with count_lock:
            eager_calls[name] = eager_calls.get(name, 0) + 1
        return fn(*args)
    return cs(*args)


def reset_counts():
    """Set the replay and eager-call counts to 0, and drop the conditional
    launches not settled yet (the captured graphs stay)."""
    with count_lock:
        replays.clear()
        eager_calls.clear()
    with _pending_lock:
        _pending.clear()
