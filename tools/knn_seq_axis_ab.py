#!/usr/bin/env python3
"""Does the sequence axis of csrc/knn.cu cost an unbatched K1 / K2 launch
anything? The parent's source and the package's, built alike, launched
with the same plan at chip_smoke.py's main shapes (simulator maps), in
turns (parent, package, package, parent) on the same inputs.

    git show <parent>:vil_fusion_tpu_torch/csrc/knn.cu > build/knn_parent.cu
    python3 tools/knn_seq_axis_ab.py --parent build/knn_parent.cu

The parent's vil_knn_launch has no batch and no strides; the package's is
called with a batch of 1 and strides 0. Prints, per shape, the device ms of
a launch (CUDA events around 200 back-to-back calls of the C entry point,
median of the turns) for both, and whether the rows are equal bit for bit.
With --parent-pkg DIR (the parent's vil_fusion_tpu_torch unpacked there:
`git archive <parent> vil_fusion_tpu_torch | tar -x -C DIR`) also the
wrapper call as chip_smoke.py times it (CUDA events around one call, which
hold the wrapper's host time, median of 20), the parent's knn_cuda.py
against the package's, in turns. Needs one NVIDIA card; prints the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import multiprocessing
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPS = 200
TURNS = 3


def _build_parent(src: Path, kc) -> ctypes.CDLL:
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = kc.BUILD_DIR / f"libvil_knn_parent_{tag}.so"
    kc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        subprocess.run([nvcc, *kc.NVCC_FLAGS, "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.vil_knn_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
    lib.vil_knn_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--parent-pkg", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knn_seq_axis_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs._card_line()
    print(card, flush=True)
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

    dev = torch.device("cuda", 0)
    new, old = kc.build(), _build_parent(args.parent, kc)
    with multiprocessing.get_context("spawn").Pool(6) as pool:
        frames = pool.starmap(cs._scan_frame, [(i, False) for i in range(cs.ICP_CLOUDS + 1)])
    inp = cs._kernel_inputs(frames, dev, big=False)
    cases = {name: c[:3] + c[6:8] for name, c in inp.cases.items()}
    cases["depth"] = (inp.rays, inp.sphere, inp.sphere_ok, 3, False)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, (q, db, v, k, grouped) in cases.items():
        nq, nd = q.shape[0], db.shape[0]
        how = kc.plan(nq, nd, k, sm, grouped)
        outs = {}
        for side in ("parent", "package"):
            outs[side] = (torch.empty((nq, k), device=dev), torch.empty((nq, k), dtype=torch.int32,
                                                                        device=dev))
        part = (torch.empty((nq, how.n_split, k), device=dev),
                torch.empty((nq, how.n_split, k), dtype=torch.int32, device=dev))
        ptrs = (q.data_ptr(), db.data_ptr(), v.data_ptr())

        def launch(side):
            o = outs[side]
            if side == "parent":
                err = old.vil_knn_launch(*ptrs, nq, nd, k, int(grouped), 0, how.chunk, how.n_split,
                                         part[0].data_ptr(), part[1].data_ptr(), o[0].data_ptr(),
                                         o[1].data_ptr(), stream)
            else:
                err = new.vil_knn_launch(*ptrs, nq, nd, k, int(grouped), 0, how.chunk, how.n_split,
                                         1, 0, 0, 0, part[0].data_ptr(), part[1].data_ptr(),
                                         o[0].data_ptr(), o[1].data_ptr(), stream)
            if err:
                raise RuntimeError(f"{side} vil_knn_launch: cudaError {err}")

        times = {"parent": [], "package": []}
        for _ in range(TURNS):
            for side in ("parent", "package", "package", "parent"):
                launch(side)
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(REPS):
                    launch(side)
                b.record()
                b.synchronize()
                times[side].append(a.elapsed_time(b) / REPS)
        same = all(torch.equal(x, y) for x, y in zip(outs["parent"], outs["package"]))
        med = {s: sorted(t)[len(t) // 2] for s, t in times.items()}
        print(f"{name} {nq}x{nd} k={k} {'K1' if grouped else 'K2'} plan {tuple(how)}: device ms a "
              f"launch parent {med['parent']:.4f}, package {med['package']:.4f} "
              f"({med['package'] / med['parent']:.3f}x); rows bit for bit {same} [{card}]",
              flush=True)
        if not same:
            return 1
    if args.parent_pkg:
        _wrapper_ab(args.parent_pkg, cases, kc, card)
    return 0


def _wrapper_ab(pkg: Path, cases, kc, card):
    """The parent's knn_cuda.py (loaded from `pkg` under another name; it
    builds its own csrc/knn.cu) against the package's wrappers."""
    import importlib.util

    import torch

    path = pkg / "vil_fusion_tpu_torch" / "ops" / "cuda" / "knn_cuda.py"
    spec = importlib.util.spec_from_file_location("parent_knn_cuda", path)
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    for name, (q, db, v, k, grouped) in cases.items():
        fns = {side: (m.knn_grouped if grouped else m.knn_exact) for side, m in
               (("parent", parent), ("package", kc))}
        times = {"parent": [], "package": []}
        for _ in range(TURNS):
            for side in ("parent", "package", "package", "parent"):
                times[side].append(cs._time_ms(lambda: fns[side](q, db, v, k=k)))
        d0, i0 = fns["parent"](q, db, v, k=k)
        d1, i1 = fns["package"](q, db, v, k=k)
        same = torch.equal(d0, d1) and torch.equal(i0, i1)
        med = {s: sorted(t)[len(t) // 2] for s, t in times.items()}
        print(f"{name} {q.shape[0]}x{db.shape[0]} k={k}: wrapper call ms parent {med['parent']:.4f}, "
              f"package {med['package']:.4f} ({med['package'] / med['parent']:.3f}x); rows bit for "
              f"bit {same} [{card}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
