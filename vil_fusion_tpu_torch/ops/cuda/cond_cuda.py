"""The CUDA wrapper of the conditional nodes (csrc/cond.cu) that
utils/graphs.cond records while a graph is captured: the port's `lax.cond`
(the reference's keyframe decision, vil_fusion_tpu/models/estimator.py:380).

`body(pred, negate)` is a context manager: on entry, the capturing current
stream receives the source's one-thread kernel, which sets a conditional
handle from the 0-d bool `pred` (negated with `negate`), and an IF node
behind it; inside, the current stream is a side stream that captures into
the node's body, and the caching allocator serves this thread from
`pool` (a torch.cuda.MemPool that the captured graph keeps: the body's
addresses stay its own); on exit the body's capture ends. The stream's
later work depends on the node. A replay runs the body only where the
handle is set. `begin.launches` counts the set kernel's launches (through
graphs.record_launch: at each replay of the graph that holds it).

The source is compiled with nvcc for sm_90a into build/kernels/ at first
use (ops/cuda/nvcc.py) and bound with ctypes; importing this module builds
nothing. The card's PyTorch (2.11) has no `begin_capture_to_if_node`;
CUDA >= 12.4 is needed. A failure raises: there is no fallback.
"""
import ctypes
import threading
from contextlib import contextmanager
from pathlib import Path

import torch

from vil_fusion_tpu_torch.ops.cuda import nvcc
from vil_fusion_tpu_torch.utils import graphs

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "cond.cu"
CAPTURE_THREAD_LOCAL = 1  # cudaStreamCaptureModeThreadLocal, as graphs.step captures

_lib = None
_tls = threading.local()


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile csrc/cond.cu (once per source/flag content) and load it."""
    global _lib
    if _lib is not None and not verbose:
        return _lib
    out, log, secs = nvcc.compile_library(SOURCE, "vil_cond", verbose)
    if verbose:
        report = "\n".join(f"  {ln.strip()}" for ln in log.splitlines()
                           if "Used" in ln or "spill" in ln)
        print(f"nvcc {SOURCE.name}: {secs:.2f} s\n{report}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.vil_cond_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_void_p)]
    lib.vil_cond_begin.restype = ctypes.c_int
    lib.vil_cond_end.argtypes = [ctypes.c_void_p]
    lib.vil_cond_end.restype = ctypes.c_int
    lib.vil_cond_runtime_version.restype = ctypes.c_int
    _lib = lib
    return lib


def _count():
    with graphs.count_lock:
        begin.launches += 1


def reset_counts():
    with graphs.count_lock:
        begin.launches = 0


def _body_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's side stream on `device` that captures the bodies."""
    streams = getattr(_tls, "streams", None)
    if streams is None:
        streams = _tls.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def begin(pred: torch.Tensor, negate: bool, body_stream: torch.cuda.Stream) -> int:
    """Append the set kernel and an IF node on `pred` (negated with
    `negate`) to the graph the current stream captures, and start capturing
    `body_stream` into the node's body; returns the body graph's handle."""
    if not pred.is_cuda or pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"cond_cuda.begin takes a one-element CUDA bool tensor, got "
                         f"{pred.dtype} {tuple(pred.shape)} on {pred.device}")
    lib = build()
    out = ctypes.c_void_p(0)
    err = lib.vil_cond_begin(torch.cuda.current_stream(pred.device).cuda_stream,
                             pred.data_ptr(), int(negate), body_stream.cuda_stream,
                             CAPTURE_THREAD_LOCAL, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"vil_cond_begin failed with cudaError {err} (CUDA runtime "
                           f"{lib.vil_cond_runtime_version()})")
    graphs.record_launch(_count)
    return out.value


def end(body_stream: torch.cuda.Stream) -> None:
    """End the capture of `body_stream` into its body."""
    err = build().vil_cond_end(body_stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"vil_cond_end failed with cudaError {err}")


@contextmanager
def body(pred: torch.Tensor, negate: bool, pools: list):
    """The IF body on `pred` (negated with `negate`) of the graph this
    thread captures, as the module docstring says; yields the body graph's
    handle. `pools` holds the capture's torch.cuda.MemPool for the bodies
    (made at the first body of a capture)."""
    if not pools:
        pools.append(torch.cuda.MemPool())
    stream = _body_stream(pred.device)
    handle = begin(pred, negate, stream)
    try:
        with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pools[0]):
            yield handle
    finally:
        end(stream)


# launches counted at each replay of a graph that holds the set kernel
reset_counts()
