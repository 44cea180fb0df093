"""nvcc builds of the port's CUDA sources (csrc/*.cu) into shared libraries
with a plain C interface under build/kernels/, at first use: one library per
(source, flags) content, so an edited source builds anew and an unchanged
one is loaded as it is. The wrappers (knn_cuda, eigh_cuda) load the library
with ctypes. A compiler failure raises with nvcc's output."""
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def compile_library(source: Path, stem: str, verbose: bool = False):
    """(path of lib{stem}_{content hash}.so, nvcc's output or None, seconds)
    for `source`. The library is compiled when it is not there yet, or
    always with `verbose` (which adds `-Xptxas -v`, whose report is the
    output returned)."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists() and not verbose:
        return out, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([nvcc, *flags, "-o", str(tmp), str(source)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {source}:\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr, time.perf_counter() - t0
