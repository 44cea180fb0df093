#!/usr/bin/env python3
"""Anatomy and A/B of the kNN kernels (K1 grouped, K2 exact; K3 with --sparse) on the card.

    python3 tools/knn_kernel_bench.py [--legacy OLD.cu] [--sweep] [--sass] [--sparse]

At the five main shapes of chip_smoke.py (surf and edge association, ICP,
depth association, exact search at surf; simulator-derived inputs) and in
both distance forms it prints, per call: the CUDA-event median of the
wrapper call, and from torch.profiler the device time of each kernel by
name (partial and merge kernel apart). Also nvcc's registers / shared
memory / spills for the instances in use (k = 1, 3, 5).

--legacy OLD.cu   a source with the first port's C interface
                  (vil_knn_launch with chunk and n_split; 8 blocks an SM,
                  one thread a query, serial merge), built into a scratch
                  library and timed in turns with the package's kernels
                  (old, new, new, old) on the same inputs; results are
                  compared bit for bit on distances.
--sweep           times every database split of the package's kernels at
                  each shape beside the plan's choice (the library's entry
                  point called directly with each split); with --sparse
                  blocks a K3 query tile 1, 2, 4, 8, 16 and the plan's.
--sass            cuobjdump -sass of each built library: the opcode
                  histogram of the innermost loop that reads shared memory,
                  for the K1 (k=5) and K2 (k=1, 3) instances; the full
                  listing of those instances goes to the report directory.
--report DIR      where the report (everything printed, as
                  knn_kernel_bench.log) and the SASS listings go; default out/.
--only-legacy     with --legacy: take the old library apart and skip the
                  package's kernels.
--sparse          K3 instead of K1 / K2: at the four K3 shapes of
                  chip_smoke.py (edge / surf at the 4x and the default map
                  capacities, presorted simulator maps, k=5, radius 3) and
                  on its clustered cloud (unsorted), the call as the
                  package makes it and, with --legacy, the call as the old
                  library made it (ops/knn.py's sparse_prepare, the old
                  vil_knn_sparse_launch, sparse_finish), in turns (old,
                  new, new, old) with rows compared bit for bit; for each,
                  the kernels a call enqueues by name with their device us
                  (torch.profiler), the host us of the call's parts back to
                  back, and the Morton sort of a 131,072-point map.
Needs one NVIDIA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

LEGACY_BLOCKS_PER_SM = 8


class _Tee:
    """stdout that also appends to a file (the report outlives a long run)."""

    def __init__(self, stream, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        self.stream, self.file = stream, open(path, "w")

    def write(self, text):
        self.file.write(text)
        self.file.flush()
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def _nvcc(source: Path, out: Path):
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run([nvcc, *kc.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}\n{res.stderr}")
    return res.stdout + res.stderr


class Legacy:
    """The first port's library: one launch function, plan of 8 blocks an SM."""

    def __init__(self, source: Path, sm_count: int):
        self.so = ROOT / "build" / "kernels" / "bench_legacy.so"
        self.log = _nvcc(source, self.so)
        self.lib = ctypes.CDLL(str(self.so))
        self.lib.vil_knn_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                                            + [ctypes.c_void_p] * 5)
        self.lib.vil_knn_launch.restype = ctypes.c_int
        if hasattr(self.lib, "vil_knn_sparse_launch"):  # the first K3 interface
            self.lib.vil_knn_sparse_launch.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float]
                + [ctypes.c_void_p] * 5)
            self.lib.vil_knn_sparse_launch.restype = ctypes.c_int
        self.sm_count = sm_count

    def split(self, nq: int, nd: int):
        import torch

        torch.cuda.get_device_properties(0)  # the first port asked the card at every call
        groups = max(1, -(-nd // 128))
        target = LEGACY_BLOCKS_PER_SM * self.sm_count
        n_split = min(groups, max(1, -(-target // -(-nq // 128))))
        chunk_groups = -(-groups // n_split)
        return -(-groups // chunk_groups), chunk_groups * 128

    def __call__(self, q, db, v, k, grouped, form):
        """One call as the first port's wrapper made it: per-tensor checks,
        four allocations, the launch inside a device context."""
        import torch

        for t in (q, db, v):
            if not t.is_cuda or t.device != q.device or not t.is_contiguous():
                raise ValueError("CUDA, one device, contiguous")
        if q.dtype != torch.float32 or db.dtype != torch.float32 or v.dtype != torch.bool \
                or q.ndim != 2 or q.shape[1] != 3 or db.ndim != 2 or db.shape[1] != 3 \
                or v.shape != (db.shape[0],) or not 1 <= k <= 8 or form not in ("expanded", "diff"):
            raise ValueError("dtype, shape, k or form")
        nq, nd = q.shape[0], db.shape[0]
        n_split, chunk = self.split(nq, nd)
        out_d = torch.empty((nq, k), dtype=torch.float32, device=q.device)
        out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
        part_d = torch.empty((nq, n_split, k), dtype=torch.float32, device=q.device)
        part_i = torch.empty((nq, n_split, k), dtype=torch.int32, device=q.device)
        with torch.cuda.device(q.device):
            err = self.lib.vil_knn_launch(
                q.data_ptr(), db.data_ptr(), v.data_ptr(), nq, nd, k, int(grouped),
                int(form == "diff"), chunk, n_split, part_d.data_ptr(), part_i.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"legacy vil_knn_launch: cudaError {err}")
        return out_d, out_i

    def sparse_search(self, prob, k: int, radius: float):
        """The old K3 search on a prepared problem (128 x 128 tiles), as the
        old wrapper launched it: 8 blocks an SM over the database tiles,
        four allocations, the partial kernel and the merge."""
        import torch

        dev = prob.q.device
        nqp, ndp = prob.q.shape[0], prob.db.shape[0]
        n_split = min(ndp // 128, max(1, -(-LEGACY_BLOCKS_PER_SM * self.sm_count // (nqp // 128))))
        out_d = torch.empty((nqp, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((nqp, k), dtype=torch.int32, device=dev)
        part_d = torch.empty((nqp, n_split, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((nqp, n_split, k), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = self.lib.vil_knn_sparse_launch(
                prob.q.data_ptr(), prob.db.data_ptr(), prob.db_valid.data_ptr(),
                prob.q_lo.data_ptr(), prob.q_hi.data_ptr(), prob.d_lo.data_ptr(),
                prob.d_hi.data_ptr(), nqp, ndp, k, 128, n_split, float(radius) ** 2,
                part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"legacy vil_knn_sparse_launch: cudaError {err}")
        return out_d, out_i

    def knn_sparse(self, q, db, v, k: int, radius: float, q_sorted: bool, db_sorted: bool):
        """The old K3 call: the plain tensor code's sort, padding and boxes
        (ops/knn.py:sparse_prepare), the old kernels, sparse_finish."""
        from vil_fusion_tpu_torch.ops import knn as knn_plain

        prob = knn_plain.sparse_prepare(q, db, v, 128, 128, q_sorted=q_sorted,
                                        db_sorted=db_sorted)
        return knn_plain.sparse_finish(prob, *self.sparse_search(prob, k, radius))


def _by_kernel(fn, reps: int = 20):
    """{kernel name (shortened): (device microseconds a call, launches a
    call)} from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key)
            us, n = out.get(name, (0.0, 0.0))
            out[name] = (us + e.self_device_time_total / reps, n + e.count / reps)
    return out


def _host_us(fn, n: int = 200):
    """(host microseconds a call to enqueue, wall microseconds a call) of n
    calls made back to back, as a frame makes them."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / n, (time.perf_counter() - t0) * 1e6 / n


def _batch_ms(fn, n: int = 20):
    """Milliseconds a call of n calls made back to back between two CUDA
    events: the device's time where the device is the slower side."""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _fmt_kernels(t):
    return ", ".join(f"{n} {us:.2f} us" + (f" (x{c:g})" if c != 1 else "")
                     for n, (us, c) in sorted(t.items())) or "no device time seen"


def _sass_report(so: Path, tag: str, wanted, out: Path):
    """Opcode histogram of the innermost shared-memory loop of each kernel
    whose demangled-ish name matches one of `wanted` (regexes on the mangled
    name)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True)
    if res.returncode != 0:
        print(f"sass {tag}: cuobjdump failed: {res.stderr.strip()[:200]}", flush=True)
        return
    funcs = re.split(r"\n\s*Function : ", res.stdout)[1:]
    keep = []
    for body in funcs:
        name = body.split("\n", 1)[0].strip()
        label = next((w for w in wanted if re.search(w, name)), None)
        if label is None:
            continue
        keep.append("Function : " + body)
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;/]+?) ;", body)]
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\(\S+\)|0x([0-9a-f]+))", text)
            if m and m.group(1) and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))

        def ops(lo, hi):
            h = collections.Counter()
            for a, text in ins:
                if lo <= a <= hi:
                    op = re.sub(r"^@!?U?P\d+\s+", "", text).split()[0]
                    h[op.split(".")[0] + ("." + op.split(".")[1] if op.startswith("LDS") and "." in op else "")] += 1
            return h

        with_lds = [(hi - lo, lo, hi) for lo, hi in loops
                    if any(k.startswith("LDS") for k in ops(lo, hi))]
        print(f"sass {tag} {name[:100]}: {len(ins)} instructions, {len(loops)} backward "
              f"branches", flush=True)
        for span, lo, hi in sorted(with_lds)[:2]:
            h = ops(lo, hi)
            n_lds = sum(v for k, v in h.items() if k.startswith("LDS"))
            print(f"    loop {lo:#x}-{hi:#x}: {sum(h.values())} instructions, {n_lds} LDS: "
                  + " ".join(f"{k}={v}" for k, v in h.most_common()), flush=True)
    (out / f"sass_{tag}.txt").write_text("\n".join(keep))


LEGACY_SASS = [r"knn_partial_kernelILi5ELb1ELb0E", r"knn_partial_kernelILi3ELb0ELb0E",
               r"knn_partial_kernelILi1ELb0ELb0E", r"knn_merge_kernelILi3E"]


def _shapes(dev):
    inp = cs._kernel_inputs(cs._sequence(cs.ICP_CLOUDS), dev, big=False)
    return {"surf K1": (*inp.cases["surf"][:3], 5, True),
            "edge K1": (*inp.cases["edge"][:3], 5, True),
            "icp K2": (*inp.cases["icp"][:3], 1, False),
            "depth K2": (inp.rays, inp.sphere, inp.sphere_ok, 3, False),
            "surf K2": (*inp.cases["surf"][:3], 5, False)}


def _legacy_anatomy(args, kc, sm_count, dev, card) -> int:
    legacy = Legacy(args.legacy, sm_count)
    print(f"legacy {args.legacy}:\n{kc._ptxas_summary(legacy.log)}", flush=True)
    if args.sass:
        _sass_report(legacy.so, "legacy", LEGACY_SASS, args.report)
    for label, (q, db, v, k, grouped) in _shapes(dev).items():
        for form in ("expanded", "diff"):
            old = lambda: legacy(q, db, v, k, grouped, form)  # noqa: E731
            print(f"{label} {form} {q.shape[0]}x{db.shape[0]} k={k}: old {cs._time_ms(old):.4f} ms "
                  f"(split {legacy.split(q.shape[0], db.shape[0])}); "
                  f"{_fmt_kernels(_by_kernel(old))} [{card}]", flush=True)
    return 0


def _sparse_sweep(kc, q, db, v, radius, sm_count):
    """Blocks a query tile (the split of its near list over gridDim.y, merged
    by the tile's last block) from 1, the whole list on one block, up to 16,
    the library's entry point called directly on a presorted problem (an
    unsorted case is sorted first), against the plan's choice."""
    import torch

    lib, dev = kc.build(), q.device
    nq, nd = q.shape[0], db.shape[0]
    pl = kc.sparse_plan(nq, nd, sm_count)
    out_d = torch.empty((nq, 5), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, 5), dtype=torch.int32, device=dev)

    def call(n_split):
        how = pl._replace(n_split=n_split)
        err = lib.vil_knn_sparse(
            q.data_ptr(), None, nq, db.data_ptr(), v.data_ptr(), None, nd, 5, 128, n_split,
            float(radius) ** 2, kc._scratch(dev, kc.sparse_scratch_bytes(how, 5)).data_ptr(),
            kc._counters(dev, how.blocks).data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"vil_knn_sparse: cudaError {err}")

    def rows_of(n_split):
        call(n_split)
        return out_d.clone(), out_i.clone()

    ref = rows_of(1)
    rows = {}
    for n in sorted({1, 2, 4, 8, 16, pl.n_split}):
        same = all(torch.equal(a, b) for a, b in zip(rows_of(n), ref))
        rows[n] = (_batch_ms(lambda: call(n)),
                   sum(us for name, (us, _) in _by_kernel(lambda: call(n)).items()
                       if "knn_sparse" in name), same)
    print("    sweep (blocks a query tile: ms a call back to back / device us of the box and "
          "search kernels / rows equal to 1 block's; entry point alone): "
          + " ".join(f"{n}:{ms:.4f}/{us:.2f}/{same}" for n, (ms, us, same) in rows.items())
          + f"; the plan's {pl.n_split}", flush=True)


def _sparse(args, kc, sm_count, dev, card) -> int:
    """--sparse: K3, old against new (see the module's docstring)."""
    import torch

    from vil_fusion_tpu_torch.ops import knn as knn_plain

    legacy = Legacy(args.legacy, sm_count) if args.legacy else None
    if legacy is not None and not hasattr(legacy.lib, "vil_knn_sparse_launch"):
        raise RuntimeError(f"{args.legacy} has no vil_knn_sparse_launch")
    new = not args.only_legacy
    if new:
        kc.build(verbose=True)
    inp = cs._kernel_inputs(cs._sequence(cs.WARMUP_FRAMES + cs.TIMED_FRAMES), dev)
    cases = {label: (*c, cs.RADIUS) for label, c in cs._k3_inputs(inp).items()}
    # the long lists: every block of surf 4x near, and the clustered cloud
    # with a radius that keeps most blocks
    cases["surf 4x, every block near"] = (*cases["surf 4x"][:4], 1e4)
    cases["clustered random, radius 12"] = (*cases["clustered random"][:4], 12.0)
    for label, (q, db, v, presorted, radius) in cases.items():
        kw = dict(k=5, radius=radius, q_sorted=presorted, db_sorted=presorted)
        calls = {}
        if legacy is not None:
            calls["old"] = lambda: legacy.knn_sparse(q, db, v, **kw)  # noqa: E731
        if new:
            calls["new"] = lambda: kc.knn_sparse(q, db, v, **kw)  # noqa: E731
        head = (f"K3 {label} {q.shape[0]}x{db.shape[0]} k=5 radius {radius:g} "
                f"({'presorted' if presorted else 'unsorted'})")
        if len(calls) == 2:
            t = [cs._time_ms(calls[n]) for n in ("old", "new", "new", "old")]
            d_o, i_o = calls["old"]()
            d_n, i_n = calls["new"]()
            torch.cuda.synchronize()
            print(f"{head}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms, "
                  f"ratio {(t[1] + t[2]) / (t[0] + t[3]):.3f}; rows bit-equal: distances "
                  f"{torch.equal(d_o, d_n)}, indices {torch.equal(i_o, i_n)} [{card}]", flush=True)
        else:
            (name, f), = calls.items()
            print(f"{head}: {name} {cs._time_ms(f):.4f} ms [{card}]", flush=True)
        for name, f in calls.items():
            ks = _by_kernel(f)
            host, wall = _host_us(f)
            knn_us = sum(us for n, (us, _) in ks.items() if "knn_" in n or "morton" in n)
            print(f"    {name}: {sum(c for _, c in ks.values()):g} kernels a call, device "
                  f"{sum(us for us, _ in ks.values()):.2f} us ({knn_us:.2f} in csrc/knn.cu); "
                  f"back to back: host {host:.1f} us a call, wall {wall:.1f} us a call; "
                  f"{_fmt_kernels(ks)}", flush=True)
        if legacy is not None:
            prob = knn_plain.sparse_prepare(q, db, v, 128, 128, q_sorted=presorted,
                                            db_sorted=presorted)
            out = legacy.sparse_search(prob, 5, radius)
            parts = {"prepare": lambda: knn_plain.sparse_prepare(  # noqa: E731
                         q, db, v, 128, 128, q_sorted=presorted, db_sorted=presorted),
                     "kernels": lambda: legacy.sparse_search(prob, 5, radius),  # noqa: E731
                     "finish": lambda: knn_plain.sparse_finish(prob, *out)}  # noqa: E731
            print("    old call's parts, host us a call back to back: "
                  + ", ".join(f"{n} {_host_us(f)[0]:.1f}" for n, f in parts.items()), flush=True)
        if new and args.sweep:
            if not presorted:  # the same problem in Morton order: the same near lists
                qp, dp = kc.morton_sort(q), kc.morton_sort(db, v)
                q, db, v = q[qp].contiguous(), db[dp].contiguous(), v[dp].contiguous()
            _sparse_sweep(kc, q, db, v, radius, sm_count)
    db, v = inp.big[2], inp.big[3]
    sorts = {"old (plain tensor code)": lambda: knn_plain.morton_sort(db, v)}
    if new:
        sorts["new (key kernels + stable argsort)"] = lambda: kc.morton_sort(db, v)
    for name, f in sorts.items():
        ks = _by_kernel(f)
        print(f"Morton sort of {db.shape[0]} points, {name}: {cs._time_ms(f):.4f} ms, "
              f"{sum(c for _, c in ks.values()):g} kernels, device "
              f"{sum(us for us, _ in ks.values()):.2f} us; {_fmt_kernels(ks)} [{card}]", flush=True)
    if new:
        same = torch.equal(knn_plain.morton_sort(db, v), kc.morton_sort(db, v))
        print(f"Morton sort: permutations equal {same}", flush=True)
    return 0


PACKAGE_SASS = [r"knn_dense_kernelILi5ELb1ELb0E", r"knn_dense_kernelILi1ELb0ELb0E",
                r"knn_dense_kernelILi3ELb0ELb0E", r"knn_merge_kernelILi3E"]


def _launch_split(lib, q, db, v, k, grouped, form, n_split, chunk):
    """The package's vil_knn_launch with a split of the caller's choosing."""
    import torch

    nq = q.shape[0]
    out_d = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    part_d = torch.empty((nq, n_split, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((nq, n_split, k), dtype=torch.int32, device=q.device)
    err = lib.vil_knn_launch(
        q.data_ptr(), db.data_ptr(), v.data_ptr(), nq, db.shape[0], k, int(grouped),
        int(form == "diff"), chunk, n_split, 1, 0, 0, 0, part_d.data_ptr(), part_i.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"vil_knn_launch: cudaError {err}")
    return out_d, out_i


def _sweep(kc, q, db, v, k, grouped, form, pl):
    """Every database split of the package's kernels at one shape."""
    lib = kc.build()
    groups = -(-db.shape[0] // 128)
    rows = {}
    for want in (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 1024):
        cg = -(-groups // min(want, groups))
        n_split = -(-groups // cg)
        if n_split not in rows:
            rows[n_split] = _batch_ms(lambda: _launch_split(lib, q, db, v, k, grouped, form,
                                                            n_split, cg * 128))
    best = min(rows, key=rows.get)
    print(f"    sweep (n_split: ms a call back to back): "
          + " ".join(f"{s}:{ms:.4f}" for s, ms in rows.items())
          + f"; best {best} at {rows[best]:.4f}, the plan's own {pl.n_split} at "
          f"{rows.get(pl.n_split, float('nan')):.4f}", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legacy", type=Path)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only-legacy", action="store_true")
    ap.add_argument("--sparse", action="store_true")
    ap.add_argument("--report", type=Path, default=ROOT / "out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knn_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.stdout = _Tee(sys.stdout, args.report / "knn_kernel_bench.log")
    card = cs._card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    from vil_fusion_tpu_torch.ops.cuda import knn_cuda as kc

    if args.sparse:
        return _sparse(args, kc, sm_count, dev, card)
    if args.only_legacy:
        return _legacy_anatomy(args, kc, sm_count, dev, card)
    kc.build(verbose=True)
    if args.sass:
        _sass_report(max(kc.BUILD_DIR.glob("libvil_knn_*.so"), key=lambda p: p.stat().st_mtime),
                     "package", PACKAGE_SASS, args.report)
    legacy = None
    if args.legacy:
        legacy = Legacy(args.legacy, sm_count)
        print(f"legacy {args.legacy} built", flush=True)
    shapes = _shapes(dev)
    for label, (q, db, v, k, grouped) in shapes.items():
        nq, nd = q.shape[0], db.shape[0]
        for form in ("expanded", "diff"):
            kern = kc.knn_grouped if grouped else kc.knn_exact
            new = lambda: kern(q, db, v, k=k, form=form)  # noqa: E731
            head = f"{label} {form} {nq}x{nd} k={k}"
            pl = kc.plan(nq, nd, k, sm_count, grouped)
            if legacy is None:
                print(f"{head}: new {cs._time_ms(new):.4f} ms, plan {tuple(pl)}; "
                      f"{_fmt_kernels(_by_kernel(new))} [{card}]", flush=True)
            else:
                old = lambda: legacy(q, db, v, k, grouped, form)  # noqa: E731
                t = [cs._time_ms(f) for f in (old, new, new, old)]
                d_o, i_o = old()
                d_n, i_n = new()
                torch.cuda.synchronize()
                same_i = (i_o == i_n).all(dim=1).float().mean().item()
                print(f"{head}: old {t[0]:.4f} / {t[3]:.4f} ms (split {legacy.split(nq, nd)}), "
                      f"new {t[1]:.4f} / {t[2]:.4f} ms (plan {tuple(pl)}), ratio "
                      f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}; distances bit-equal "
                      f"{torch.equal(d_o, d_n)}, rows with equal indices {same_i:.5f} [{card}]",
                      flush=True)
                for name, f in (("old", old), ("new", new)):
                    host, wall = _host_us(f)
                    print(f"    {name}: {_fmt_kernels(_by_kernel(f))}; back to back: host "
                          f"{host:.1f} us a call, wall {wall:.1f} us a call", flush=True)
            if args.sweep:
                _sweep(kc, q, db, v, k, grouped, form, pl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
