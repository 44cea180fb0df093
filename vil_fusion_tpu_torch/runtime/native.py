"""ctypes bindings for the native runtime (ring bus + sensor IO).

Port of vil_fusion_tpu/runtime/native.py. The C++ sources
(native/src/ringbus.cpp, native/src/sensor_io.cpp) are the reference's,
byte for byte; at first use they are compiled with g++ (the flags of
native/Makefile) into build/native/ at the repository root and the library
is loaded by its absolute path.

Deviation from the reference: a failed build raises with the compiler's
output instead of falling back to Python silently, as the CUDA kernels do
(ops/cuda/knn_cuda.py). The Python versions are kept as the plain versions
the tests hold the library against: `PlainTopic` (a deque),
`load_kitti_bin_plain` (np.fromfile), `load_csv_floats_plain` (np.loadtxt)
and `load_pgm_plain`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import deque
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parents[1] / "native" / "src"
SOURCES = (SOURCE_DIR / "ringbus.cpp", SOURCE_DIR / "sensor_io.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_lib = None
_build_lock = threading.Lock()


def library_path() -> Path:
    """Where build() puts the library: one file per source/flag content."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvilrt_{h.hexdigest()[:12]}.so"


def build() -> ctypes.CDLL:
    """Compile the native library (once per source content) and load it.
    Raises RuntimeError with the compiler's output if g++ fails."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                                 capture_output=True, text=True, timeout=300)
            if res.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({res.returncode}) on {SOURCE_DIR}:\n"
                                   f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.topic_create.restype = ctypes.c_void_p
        lib.topic_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
        lib.topic_destroy.restype = None
        lib.topic_destroy.argtypes = [ctypes.c_void_p]
        lib.topic_publish.restype = ctypes.c_int
        lib.topic_publish.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                      ctypes.c_void_p, ctypes.c_uint32]
        lib.topic_poll.restype = ctypes.c_int
        lib.topic_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                                   ctypes.c_void_p, ctypes.c_uint32]
        lib.topic_pending.restype = ctypes.c_uint64
        lib.topic_pending.argtypes = [ctypes.c_void_p]
        lib.topic_dropped.restype = ctypes.c_uint64
        lib.topic_dropped.argtypes = [ctypes.c_void_p]
        lib.load_kitti_bin.restype = ctypes.c_int64
        lib.load_kitti_bin.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int64]
        lib.load_csv_floats.restype = ctypes.c_int64
        lib.load_csv_floats.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.load_pgm.restype = ctypes.c_int64
        lib.load_pgm.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return lib


class Topic:
    """Typed message channel on the native lock-free SPSC ring
    (drop-oldest when full). Payloads are numpy arrays of at most
    slot_bytes bytes."""

    def __init__(self, name: str, slot_bytes: int, capacity: int = 256):
        self.name = name
        self.slot_bytes = slot_bytes
        self._lib = build()
        self._h = self._lib.topic_create(name.encode(), slot_bytes, capacity)
        if not self._h:
            raise MemoryError(f"topic_create({name!r}, {slot_bytes}, {capacity}) failed")

    def publish(self, timestamp: float, payload: np.ndarray) -> bool:
        buf = np.ascontiguousarray(payload)
        return bool(self._lib.topic_publish(
            self._h, float(timestamp), buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes))

    def poll(self, dtype=np.uint8) -> Optional[tuple]:
        """Returns (timestamp, array) or None."""
        out = np.empty(self.slot_bytes, np.uint8)
        ts = ctypes.c_double()
        n = self._lib.topic_poll(self._h, ctypes.byref(ts),
                                 out.ctypes.data_as(ctypes.c_void_p), self.slot_bytes)
        if n <= 0:
            return None
        return ts.value, out[:n].view(dtype)

    def pending(self) -> int:
        return int(self._lib.topic_pending(self._h))

    def dropped(self) -> int:
        return int(self._lib.topic_dropped(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.topic_destroy(self._h)
            self._h = None


class PlainTopic:
    """Plain version of Topic: a bounded deque with the same drop-oldest
    and oversize semantics (the reference's Python fallback)."""

    def __init__(self, name: str, slot_bytes: int, capacity: int = 256):
        self.name = name
        self.slot_bytes = slot_bytes
        self._q = deque(maxlen=capacity)
        self._dropped = 0

    def publish(self, timestamp: float, payload: np.ndarray) -> bool:
        buf = np.ascontiguousarray(payload)
        if buf.nbytes > self.slot_bytes:
            return False
        if len(self._q) == self._q.maxlen:
            self._dropped += 1
        self._q.append((float(timestamp), buf.copy()))
        return True

    def poll(self, dtype=np.uint8) -> Optional[tuple]:
        if not self._q:
            return None
        ts, buf = self._q.popleft()
        return ts, buf.reshape(-1).view(dtype)

    def pending(self) -> int:
        return len(self._q)

    def dropped(self) -> int:
        return self._dropped


def load_kitti_bin(path: str, max_pts: int = 200_000):
    """(xyz (n, 3) float32, intensity (n,)) from a velodyne .bin."""
    xyz = np.empty((max_pts, 3), np.float32)
    inten = np.empty((max_pts,), np.float32)
    n = build().load_kitti_bin(path.encode(), xyz.ctypes.data_as(ctypes.c_void_p),
                               inten.ctypes.data_as(ctypes.c_void_p), max_pts)
    if n < 0:
        raise FileNotFoundError(path)
    return xyz[:n], inten[:n]


def load_kitti_bin_plain(path: str, max_pts: int = 200_000):
    raw = np.fromfile(path, np.float32).reshape(-1, 4)[:max_pts]
    return np.ascontiguousarray(raw[:, :3]), np.ascontiguousarray(raw[:, 3])


def load_csv_floats(path: str, n_cols: int, max_rows: int = 1_000_000,
                    skip_lines: int = 0):
    out = np.empty((max_rows, n_cols), np.float64)
    n = build().load_csv_floats(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                                n_cols, max_rows, skip_lines)
    if n < 0:
        raise FileNotFoundError(path)
    return out[:n]


def load_csv_floats_plain(path: str, n_cols: int, max_rows: int = 1_000_000,
                          skip_lines: int = 0):
    return np.loadtxt(path, delimiter=",", skiprows=skip_lines,
                      usecols=range(n_cols), ndmin=2)[:max_rows]


def load_pgm(path: str, max_h: int = 2048, max_w: int = 2048):
    """Binary PGM (P5) as float32 in [0, 1]."""
    out = np.zeros((max_h, max_w), np.float32)
    r = build().load_pgm(path.encode(), out.ctypes.data_as(ctypes.c_void_p), max_h, max_w)
    if r < 0:
        raise IOError(f"failed to read PGM {path}")
    h, w = int(r >> 32), int(r & 0xFFFFFFFF)
    return np.ascontiguousarray(out[:h, :w])


def load_pgm_plain(path: str):
    with open(path, "rb") as f:
        if f.readline().strip() != b"P5":
            raise IOError(f"not a binary PGM: {path}")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
    # the library's float arithmetic: one float32 reciprocal, one product
    return data.astype(np.float32) * (np.float32(1.0) / np.float32(maxval))
