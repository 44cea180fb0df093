"""The port's benchmark: one run of one cell.

A cell (BENCHMARK.json `workloads`) names a configuration
(vilbench/configs/<config>.json: the rig, the pipeline's settings, the
reference that judges it) and a traffic mix (vilbench/traffic/<traffic>.json,
read by the generator module it names under vilbench/traffic/). The
end-to-end metrics are read by vilbench/end_to_end/<name>.py and the
per-layer metrics by vilbench/layer_metrics/<name>.py, each a `read(rec)`
of the run's record (`Record`); the limits of the correctness numbers are
vilbench/checks/<cell>.json. So a cell or a metric is added with files of
its own and entries in BENCHMARK.json.

A run: build the pipeline of vil_fusion_tpu_torch, make the drive from the
seed (cached lap renders plus the seed's noise), warm up every graph the
window uses (the filling frames, the frame graph's body and capture,
global fusion's prewarm twice, the pose graph's buckets), then push frames
in a closed loop for `--seconds`: the next frame's events go in when the
pipeline's last call returns. Counters and host timers are read over the
window. With `--trace 1` a torch.profiler sub-window of the traffic's
`traced_frames` frames follows the window (nothing is timed after it starts).
Then the pipeline is drained and freed, and the reference
(vilbench/reference/<kind>.py) judges the frames it followed.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "vil_fusion_tpu")


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(root: str, name: str, entry: dict | None = None) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, traffic,
    metric entries and check limits. `entry` stands in for a cell that
    BENCHMARK.json does not hold (a test's); its limits are the caller's."""
    bench = load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if entry is None and name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = entry or cells[name]
    base = os.path.join(root, "vilbench")
    with open(os.path.join(base, "configs", cell["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(base, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits = {}
    if entry is None:
        with open(os.path.join(base, "checks", name + ".json")) as f:
            limits = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def reader(root: str, kind: str, name: str):
    """The `read` function of vilbench/<kind>/<name>.py (a metric's name may
    hold dots, so the file is loaded by its path)."""
    path = os.path.join(root, "vilbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"vilbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: vil_fusion_tpu_torch is not vil_fusion_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Record:
    """What the metric readers read. Times are host seconds
    (time.perf_counter), latencies and host timers per frame in ms."""

    def __init__(self, config: dict, traffic: dict):
        self.config, self.traffic = config, traffic
        self.setup_s = None
        self.window_s = None
        self.delivered = 0  # frames whose pose was delivered inside the window
        self.latencies_s: list = []  # push of the frame's first event -> its pose
        self.call_s: list = []  # duration of each push_scan call inside the window
        self.timers: dict = {}  # GLOBAL_TIMERS stage -> {"n", "total_s"} over the window
        self.in_window: dict = {}  # graph captures and eager graph-step calls in the window
        self.trace = None  # trace.Summary of the traced sub-window (--trace 1)


def _timers(summary: dict) -> dict:
    return {k: (v["n"], v["total_s"]) for k, v in summary.items()}


def _graph_counts(graphs) -> tuple:
    return len(graphs.captures), dict(graphs.eager_calls)


def build_pipeline(config: dict, device):
    """The configuration's VILFusionPipeline (and its RigConfig)."""
    import numpy as np

    from vilbench.sim import sim
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    r = dict(config["rig"])
    r["q_ic"] = sim.R_to_q(np.asarray(r.pop("R_ic"), np.float64))
    r["q_cl"] = sim.R_to_q(np.asarray(r.pop("R_cl"), np.float64))
    r["t_ic"] = np.asarray(r["t_ic"], np.float64)
    r["t_cl"] = np.asarray(r["t_cl"], np.float64)
    rig = RigConfig(**r)
    p = config["pipeline"]
    pipe = VILFusionPipeline(rig, mode=p["mode"], sync_depth=p["sync_depth"],
                             visual_loop=p["visual_loop"], scan_quant=p["scan_quant"],
                             sc_capacity=p["sc_capacity"], device=device)
    return pipe, rig


class Feeder:
    """Pushes frame i's events (IMU batch, scan, image) into the pipeline and
    keeps, per frame, the time of its first push and of its pose's return."""

    def __init__(self, pipe, drive, with_imu: bool, with_image: bool):
        self.pipe, self.drive = pipe, drive
        self.with_imu, self.with_image = with_imu, with_image
        self.pushed = 0  # frames pushed
        self.start: list = []  # host time of each frame's first push
        self.done: list = []  # host time its pose came back (None while in flight)
        self.call_s: list = []  # (end time, duration) of each push_scan
        self._next = 0  # the oldest frame whose pose has not come back

    def push(self, hook=None):
        i = self.pushed
        d, pipe = self.drive, self.pipe
        t = d.t(i)
        if hook is not None:
            hook(i)
        n0 = len(pipe.outputs.ts)
        t0 = time.perf_counter()
        self.start.append(t0)
        self.done.append(None)
        if self.with_imu:
            imu = d.imu(i)
            if imu is not None:
                pipe.push_imu_batch(*imu)
        pts, val = d.scan(i)
        pipe.push_scan(t, pts, val)
        t1 = time.perf_counter()
        self.call_s.append((t1, t1 - t0))
        if self.with_image:
            pipe.push_image(t, d.image(i))
        t1 = time.perf_counter()
        self.pushed += 1
        for _ in range(len(pipe.outputs.ts) - n0):  # poses come back in push order
            self.done[self._next] = t1
            self._next += 1


def _warm_fusion(pipe, traffic: dict, seconds: float, warm_frames: int):
    """Global fusion's once-only work before the window: the prewarm (one
    ICP verification and one relaxation) twice, so that both graphs are
    captured; and every pose-graph bucket that the window reaches at twice
    the traffic's expected rate, each optimized twice (body, then capture),
    the results dropped."""
    from vil_fusion_tpu_torch.models import posegraph as pg

    fusion = pipe.fusion
    if fusion is None:
        return
    if traffic.get("prewarm_fusion"):
        fusion.prewarm()
        fusion.prewarm()
    w = traffic.get("posegraph_warm")
    if not w:
        return
    n_max = fusion.n_kf + int(math.ceil(2.0 * w["frames_per_s"] * seconds
                                        * w["keyframes_per_frame"])) + warm_frames
    cap = fusion.graph.q.shape[0]
    bucket = 64
    while True:
        for _ in range(2):
            g = pg.optimize_bucketed(fusion.graph, min(bucket, cap),
                                     capture_lock=fusion.capture_lock)
        del g
        if bucket >= min(n_max, cap):
            break
        bucket *= 2


def _log(process_start: float, what: str):
    print(f"vilbench: {time.perf_counter() - process_start:8.2f} s  {what}", file=sys.stderr,
          flush=True)


QUIET_FRAMES = 8  # warm-up ends after this many frames without a capture or eager step


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, process_start: float,
             root: str, control: str = "none", cache_dir: str | None = None) -> dict:
    """One run; returns the result object (without printing it). Renders
    are cached in `cache_dir` (vilbench/.cache under `root` by default).
    `control` "lower" runs the control of `correct` after the check: the
    reference one precision lower (TF32), put in the program's place; its
    numbers decide `correct` and the program's are kept as
    `program_checks`."""
    import numpy as np
    import torch

    from vilbench import trace as trace_mod
    from vil_fusion_tpu_torch.utils import graphs
    from vil_fusion_tpu_torch.utils.tracing import GLOBAL_TIMERS

    config, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    rec = Record(config, traffic)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def log(what):
        _log(process_start, what)

    pipe, rig = build_pipeline(config, dev)
    log("pipeline built")
    gen = importlib.import_module("vilbench.traffic." + traffic["generator"])
    drive = gen.make(traffic, config, seed, dev,
                     cache_dir or os.path.join(root, "vilbench", ".cache"))
    log(f"drive made (start frame {drive.start} of a {drive.lap}-frame lap)")
    mode = config["pipeline"]["mode"]
    if config["pipeline"].get("oracle_start"):
        p0, q0, v0 = drive.start_state()
        pipe.estimator.set_initial_state(p=p0, q=q0, v=v0)
    feeder = Feeder(pipe, drive, with_imu=mode != "lidar", with_image=mode != "lidar")
    follower = importlib.import_module("vilbench.reference." + config["reference"]).Follower(
        pipe, drive, config, traffic, seed, first=int(traffic["warmup_frames"]) + QUIET_FRAMES)

    # at least the traffic's warm-up frames, then until QUIET_FRAMES frames in
    # a row captured no graph and ran no step's body
    warm, quiet = int(traffic["warmup_frames"]), 0
    while feeder.pushed < warm or quiet < QUIET_FRAMES:
        before = _graph_counts(graphs)
        feeder.push()
        quiet = quiet + 1 if _graph_counts(graphs) == before else 0
    sync()
    log(f"{feeder.pushed} warm-up frames pushed")
    _warm_fusion(pipe, traffic, seconds, feeder.pushed)
    sync()
    log("global fusion warmed up")
    graphs.settle(wait=on_card)
    caps0, eager0 = _graph_counts(graphs)
    timers0 = _timers(GLOBAL_TIMERS.summary())
    restarts0 = pipe.restarts
    fusion0 = (pipe.fusion.n_kf, len(pipe.fusion.loops_found)) if pipe.fusion else (0, 0)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the measured window ------------------------------------------------
    first_frame = feeder.pushed
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while time.perf_counter() < t_end:
        feeder.push(follower.before_frame)
    t_stop = time.perf_counter()
    rec.setup_s = t_start - process_start
    rec.window_s = t_stop - t_start
    # ------------------------------------------------------------------------

    timers1 = _timers(GLOBAL_TIMERS.summary())
    caps1, eager1 = _graph_counts(graphs)
    rec.in_window = dict(
        captures=caps1 - caps0,
        captured=[c["name"] for c in graphs.captures[caps0:]],
        eager_calls=sum(eager1.values()) - sum(eager0.values()),
        eager_by_name={k: v - eager0.get(k, 0) for k, v in eager1.items()
                       if v != eager0.get(k, 0)})
    rec.timers = {k: {"n": n - timers0.get(k, (0, 0.0))[0],
                      "total_s": s - timers0.get(k, (0, 0.0))[1]}
                  for k, (n, s) in timers1.items()}
    frames = range(first_frame, feeder.pushed)
    log(f"window closed: {len(frames)} frames pushed in {rec.window_s:.3f} s; host ms a frame "
        "by stage: " + ", ".join(f"{k} {1e3 * t['total_s'] / max(1, len(frames)):.2f}"
                                 for k, t in rec.timers.items() if t["n"]))
    got = [i for i in range(len(feeder.done))
           if feeder.done[i] is not None and t_start <= feeder.done[i] <= t_stop]
    rec.delivered = len(got)
    rec.latencies_s = [feeder.done[i] - feeder.start[i] for i in got]
    rec.call_s = [d for (end, d) in feeder.call_s[first_frame:] if end <= t_stop]
    poses_bad = sum(1 for k in got if not np.all(np.isfinite(pipe.outputs.vio_p[k])))
    restarts = pipe.restarts - restarts0
    if pipe.fusion is not None:
        log(f"global fusion in the window: {pipe.fusion.n_kf - fusion0[0]} keyframes, "
            f"{len(pipe.fusion.loops_found) - fusion0[1]} loops accepted")
    # frames the reference follows that the window did not reach
    while follower.needs(feeder.pushed):
        feeder.push(follower.before_frame)
    sync()
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    if trace:
        rec.trace = trace_mod.traced(feeder, int(traffic["traced_frames"]), dev)
        log("traced sub-window reduced")
    pipe.finalize()
    sync()
    graphs.settle(wait=on_card)
    follower.detach()
    attempted = len(frames)
    del feeder, pipe, drive
    if on_card:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")

    metrics = {}
    for kind, entries in (("end_to_end", spec["end_to_end"]), ("layer_metrics", spec["per_layer"])):
        if (kind == "end_to_end") == bool(trace):
            continue
        for m in entries:
            v = reader(root, kind, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    log("reference following the program")
    from vilbench.reference import registration

    checks = follower.compare(spec["limits"])
    coverage, program_checks = follower.coverage, None
    if control == "lower":  # the program's readings, then the control's, from one run
        program_checks = checks
        checks = follower.compare(spec["limits"], control=registration.TF32)
    log(f"reference done: {coverage}")
    if program_checks is not None:
        log(f"control done: {follower.coverage}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = dict(platform="gpu" if on_card else dev.type,
                       kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
                       count=int(cell.get("chips", 1)), memory_peak_bytes=int(memory_peak))
    out = dict(correct=bool(correct), attempted=attempted, failed=poses_bad + restarts,
               metrics=metrics, device=device_info)
    if rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["in_window"] = rec.in_window
    out["coverage"] = coverage
    if program_checks is not None:
        out["program_checks"] = program_checks
    out["checks"] = checks  # last: the numbers compared, each beside its limit
    return out


def main(argv, process_start: float, root: str) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("none", "lower"), default="none",
                    help="after the check, the control of `correct` (PERF.md): the reference "
                         "one precision lower (TF32) in the program's place decides `correct`")
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the pipeline's host work runs on the
    # main thread, and idle CPU thread pools spinning beside it on the
    # machine's shared cores slow it by turns
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    spec = load_cell(root, args.workload)
    import torch

    torch.set_num_threads(1)
    chips = int(spec["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vilbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import vil_fusion_tpu_torch  # noqa: F401  (the system under test; a checkout without it fails here)

    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", process_start, root,
                   control=args.control)
    found = forbidden_modules()
    if found:
        print(f"vilbench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps({"in_window": out["in_window"]}), flush=True)
    for name, c in (out.get("program_checks") or {}).items():
        print(f"program check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
