"""kNN dispatcher and the CUDA wrappers of K1 (grouped) and K2 (exact).

Counterpart of vil_fusion_tpu/ops/pallas/knn_pallas.py: `knn` keeps the
dispatcher's signature (knn_pallas.py:496-528) and routes by the tensors'
device. On CUDA, `approx=True` goes to K1 (`knn_grouped`, replacing
`_knn_kernel_grouped`) and everything else to K2 (`knn_exact`, replacing
`_knn_kernel` packed+mxu); `radius` (the Morton-sorted sparse kernel K3) is
not ported yet and raises. A CPU tensor goes to the plain PyTorch versions
in ops/knn.py, re-exported here as `knn_grouped_plain` / `knn_exact_plain`.

The kernels are CUDA C++ (csrc/knn.cu), compiled with nvcc for sm_90a into
build/kernels/ at first use and bound with ctypes: pointers from
`data_ptr()`, the stream from `torch.cuda.current_stream()`. Importing this
module builds nothing. There is no fallback: a CUDA tensor either runs the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from vil_fusion_tpu_torch.ops import knn as knn_plain

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "knn.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_K = 8
_THREADS = 128  # queries per block and columns per group (csrc/knn.cu)
_BLOCKS_PER_SM = 8  # database split target: enough blocks to fill the card

knn_exact_plain = knn_plain.knn
knn_grouped_plain = knn_plain.knn_grouped

_lib = None


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile csrc/knn.cu (once per source/flag content) and load it.

    verbose=True adds `-Xptxas -v` and prints nvcc's report (registers,
    shared memory, spills per kernel). Returns the loaded library."""
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
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _ptxas_summary(log: str, ks=(1, 5)) -> str:
    """Registers / spills / shared memory of the kernel instances the LiDAR
    path uses (k in `ks`), from nvcc's -Xptxas -v report."""
    out, label = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(knn_(?:partial|merge)_kernel)ILi(\d)E"
                      r"(?:Lb([01])E)?", line)
        if m:
            kind = {"1": ", grouped", "0": ", exact"}.get(m.group(3), "")
            label = f"{m.group(1)}<k={m.group(2)}{kind}>" if int(m.group(2)) in ks else None
        elif label and ("Used" in line or "spill" in line):
            out.append(f"  {label}: {line.split(':', 1)[-1].strip()}")
    return "\n".join(out)


def _split(nq: int, nd: int, device) -> tuple[int, int]:
    """(n_split, chunk): database chunks of whole 128-column groups, enough
    of them that (query blocks x chunks) fills the card."""
    n_qb = -(-nq // _THREADS)
    groups = max(1, -(-nd // _THREADS))
    target = _BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
    n_split = min(groups, max(1, -(-target // n_qb)))
    chunk_groups = -(-groups // n_split)
    return -(-groups // chunk_groups), chunk_groups * _THREADS


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


def _launch(queries, database, db_valid, k: int, grouped: bool):
    _check(queries, database, db_valid, k)
    lib = build()
    dev = queries.device
    nq, nd = queries.shape[0], database.shape[0]
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    n_split, chunk = _split(nq, nd, dev)
    part_d = torch.empty((nq, n_split, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nq, n_split, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vil_knn_launch(
            queries.data_ptr(), database.data_ptr(), db_valid.data_ptr(),
            nq, nd, k, int(grouped), chunk, n_split,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vil_knn_launch failed with cudaError {err} "
                           f"(nq={nq}, nd={nd}, k={k}, grouped={grouped})")
    return out_d, out_i


def knn_grouped(queries, database, db_valid, k: int = 5):
    """K1: grouped approximate kNN (semantics of ops/knn.py:knn_grouped).
    CUDA tensors launch csrc/knn.cu; CPU tensors take the plain version."""
    if queries.device.type == "cpu":
        return knn_grouped_plain(queries, database, db_valid, k=k)
    out = _launch(queries, database, db_valid, k, grouped=True)
    knn_grouped.launches += 1
    return out


knn_grouped.launches = 0


def knn_exact(queries, database, db_valid, k: int = 5, tile: int = 2048):
    """K2: exact kNN, ties to the lower index. CUDA tensors launch
    csrc/knn.cu (`tile` is the plain version's scan tile); CPU tensors take
    the plain version."""
    if queries.device.type == "cpu":
        return knn_exact_plain(queries, database, db_valid, k=k, tile=tile)
    out = _launch(queries, database, db_valid, k, grouped=False)
    knn_exact.launches += 1
    return out


knn_exact.launches = 0


def knn(queries, database, db_valid, k: int = 5, tile: int = 4096,
        radius: float | None = None,
        q_sorted: bool = False, db_sorted: bool = False,
        approx: bool = False):
    """Dispatch (signature of knn_pallas.knn): K1 for approx=True, K2
    otherwise. `radius` selects the sparse Morton/AABB kernel on the TPU,
    which is not ported: on CUDA it raises NotImplementedError; on the CPU
    the exact search is exact within any radius, as on the JAX CPU path.
    q_sorted/db_sorted only concern that sparse kernel."""
    if radius is not None and queries.device.type != "cpu":
        raise NotImplementedError(
            "knn(radius=...) needs K3, the sparse Morton kNN, which is not "
            "ported yet (ROADMAP.md, TPU kernels still to port)")
    if approx:
        return knn_grouped(queries, database, db_valid, k=k)
    return knn_exact(queries, database, db_valid, k=k, tile=min(tile, 2048))
