#!/usr/bin/env python3
"""Two trees of the port on one card, in turns, through one profile harness.

    python3 tools/ab_profile.py --parent DIR [--path loop] [--frames 24]
                                [--turns 5] [--out out/ab_profile]

Runs `tools/profile_port.py --path PATH --frames FRAMES` (a fresh process a
run) alternately on the tree DIR ("parent", e.g. `git archive` of the
parent commit unpacked under `out/`) and on this checkout ("change"), in
the order parent, change, change, parent, parent, change, ... until each
side has run TURNS times. Both sides run this checkout's harness
(`tools/profile_port.py` and `chip_smoke.py` are copied into DIR first), so
only the package under test differs. Writes each run's output to
OUT_<n>_<side>.txt and prints one line a run (wall ms a frame, device
kernel ms a frame, busy share, host ms a frame by GLOBAL_TIMERS stage over
the timed frames) and, last, one JSON object with each side's runs and
medians. Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HARNESS = ("tools/profile_port.py", "chip_smoke.py")

_WALL = re.compile(r"^\w+: ([0-9.]+) ms/frame wall over \d+ frames without the profiler; "
                   r"device kernels ([0-9.]+) ms/frame over the next \d+ = ([0-9.]+)% busy",
                   re.M)
_STAGES = re.compile(r"host ms per frame by stage over the timed frames \([^)]*\): (.*)$", re.M)


def parse(text: str) -> dict:
    """wall_ms, device_ms, busy_pct and host ms a frame by stage of one
    profile_port run's output (None where a line is missing)."""
    m = _WALL.search(text)
    out = dict(wall_ms=None, device_ms=None, busy_pct=None, stages_ms={})
    if m:
        out.update(wall_ms=float(m[1]), device_ms=float(m[2]), busy_pct=float(m[3]))
    s = _STAGES.search(text)
    if s:
        for part in s[1].split(", "):
            name, _, ms = part.rpartition(" ")
            out["stages_ms"][name] = float(ms)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--path", default="loop")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--out", default="out/ab_profile")
    args = ap.parse_args()
    parent = args.parent.resolve()
    for f in HARNESS:
        shutil.copy(ROOT / f, parent / f)
    trees = {"parent": parent, "change": ROOT}
    order = [("parent", "change", "change", "parent")[i % 4] for i in range(2 * args.turns)]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs: dict = {"parent": [], "change": []}
    for n, side in enumerate(order):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "tools/profile_port.py", "--path", args.path,
                            "--frames", str(args.frames)], cwd=trees[side],
                           capture_output=True, text=True)
        Path(f"{out}_{n}_{side}.txt").write_text(p.stdout + p.stderr)
        r = dict(parse(p.stdout), rc=p.returncode, s=round(time.perf_counter() - t0, 1))
        runs[side].append(r)
        print(f"run {n} {side}: rc {r['rc']} in {r['s']} s; wall {r['wall_ms']} ms/frame, "
              f"device {r['device_ms']} ms/frame, busy {r['busy_pct']}%; host ms a frame by "
              f"stage {r['stages_ms']}", flush=True)
    summary = {}
    for side, rs in runs.items():
        ok = [r for r in rs if r["wall_ms"] is not None]
        summary[side] = dict(
            runs=len(rs), failed=len(rs) - len(ok),
            wall_ms_median=statistics.median(r["wall_ms"] for r in ok) if ok else None,
            device_ms_median=statistics.median(r["device_ms"] for r in ok) if ok else None,
            busy_pct_median=statistics.median(r["busy_pct"] for r in ok) if ok else None,
            stages_ms_median={k: statistics.median(r["stages_ms"].get(k, 0.0) for r in ok)
                              for k in sorted({k for r in ok for k in r["stages_ms"]})})
    print(json.dumps(dict(path=args.path, frames=args.frames, order=order, runs=runs,
                          summary=summary)), flush=True)
    return 0 if all(r["rc"] == 0 for rs in runs.values() for r in rs) else 1


if __name__ == "__main__":
    sys.exit(main())
