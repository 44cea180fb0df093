#!/usr/bin/env python3
"""Time csrc/eigh.cu against an older eigh.cu and torch.linalg.eigh on one
CUDA card, in turns, at the estimator's sizes.

    git show <commit>:vil_fusion_tpu_torch/csrc/eigh.cu > build/eigh_old.cu
    python3 tools/eigh_kernel_bench.py --legacy build/eigh_old.cu [--sizes 15 157]

The older source must have the first kernel's C interface
(`vil_eigh_launch(a, batch, n, tol, w, v, vt_scratch, sweeps, stream)` and
`vil_eigh_v_smem_max_n()`). Both are built with nvcc into build/kernels/.
For every size and every matrix of chip_smoke._eigh_cases: each solver
but the library checked against float64 (chip_smoke._eigh_check's
tolerances), the work it took, and CUDA-event medians of `--reps` calls a turn in the order old,
new, library, library, new, old. Prints the card's name and power limit;
`--report DIR` also writes the results as eigh_bench.json there.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _legacy(path: Path):
    """The older library's launch as a function of A (n, n) -> (S, V,
    sweeps)."""
    import torch

    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda as ec
    from vil_fusion_tpu_torch.ops.cuda import nvcc

    out, log, secs = nvcc.compile_library(path, "vil_eigh_legacy", verbose=True)
    print(f"nvcc {path.name}: {secs:.2f} s\n" + "\n".join(
        f"  {ln.strip()}" for ln in log.splitlines() if "Used" in ln or "spill" in ln),
        flush=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.vil_eigh_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    lib.vil_eigh_v_smem_max_n.restype = ctypes.c_int

    def call(A, sweeps=None):
        n = A.shape[-1]
        S = torch.empty(n, dtype=torch.float32, device=A.device)
        V = torch.empty(n, n, dtype=torch.float32, device=A.device)
        scratch = (torch.empty(n * (n | 1), dtype=torch.float32, device=A.device)
                   if n > lib.vil_eigh_v_smem_max_n() else None)
        err = fn(A.data_ptr(), 1, n, ec.TOL, S.data_ptr(), V.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 None if sweeps is None else sweeps.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"legacy vil_eigh_launch: cudaError {err}")
        return S, V

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legacy", type=Path, default=None, help="an older eigh.cu")
    ap.add_argument("--sizes", type=int, nargs="+", default=[15, 157])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("eigh_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vil_fusion_tpu_torch.ops.cuda import eigh_cuda as ec

    card = cs._card_line()
    print(card, flush=True)
    ec.build(verbose=True)
    old = _legacy(args.legacy) if args.legacy else None
    dev = torch.device("cuda", 0)
    solvers = {"new": ec.eigh, "library": ec.eigh_plain}
    if old:
        solvers["old"] = old
    order = [w for w in ("old", "new", "library", "library", "new", "old") if w in solvers]
    results = {}
    for n in args.sizes:
        for name, M in cs._eigh_cases(n, n).items():
            A = torch.tensor(M, dtype=torch.float32, device=dev)
            st = torch.zeros(1, ec.NSTATS, dtype=torch.int32, device=dev)
            sw = torch.zeros(1, dtype=torch.int32, device=dev)
            S_plain, _ = ec.eigh_plain(A)
            for who in ("new", "old")[:len(solvers) - 1]:
                S, V = solvers[who](A, stats=st) if who == "new" else solvers[who](A, sweeps=sw)
                torch.cuda.synchronize()
                cs._eigh_check(f"{who} {n} x {n} {name}", A, S, V, S_plain)
            samples = {w: [] for w in solvers}
            turns = {w: [] for w in solvers}
            for who in order:
                fn = solvers[who]
                turns[who].append(cs._time_ms(lambda: fn(A), reps=args.reps,
                                              samples=samples[who]))
            row = {w: sorted(v)[len(v) // 2] for w, v in samples.items()}
            row.update(turns=turns, work_new=st[0].tolist())
            if old:
                row["sweeps_old"] = int(sw.item())
            results[f"{n} {name}"] = row
            print(f"eigh {n} x {n} {name}: " + ", ".join(
                f"{w} {row[w]:.4f} ms" for w in solvers) + f" (turns {turns}); work new "
                f"{row['work_new']}" + (f", old sweeps {row['sweeps_old']}" if old else "")
                + f" [{card}]", flush=True)
    if args.report:
        args.report.mkdir(parents=True, exist_ok=True)
        (args.report / "eigh_bench.json").write_text(json.dumps(
            dict(card=card, results=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
