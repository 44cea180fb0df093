#!/usr/bin/env python3
"""The estimator's keyframe decision as a CUDA graph conditional node
against the device select it replaced, on the card.

    python3 tools/cond_ab.py

Runs an oracle-initialized estimator at the deployed width
(EstimatorConfig defaults) over tests/test_torch_cuda.py's K + 8 frames and
keeps each fused step's inputs. Then, on the final window:

  * each marginalization path alone as a graph of its own, and both inside
    one graphs.cond graph with the predicate true and false (CUDA-event
    medians): what the conditional node adds around the taken path;
  * on the last keyframe step and the last non-keyframe step, the captured
    step with the conditional node (`fused_full_step`) against the same
    step captured with the device select (both paths and torch.where on
    every field), timed in turns on the same inputs (cond, select, select,
    cond; CUDA-event medians of 5), their outputs compared bit for bit;
  * each of those four replays under torch.profiler: device kernel ms and
    kernels a replay, and the kernels with the most device time.

Needs one NVIDIA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import functools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402


def _select(is_key, window, feats, pre, lidar, prior, cfg):
    """The device select the node replaced: both paths, torch.where on
    every field."""
    from vil_fusion_tpu_torch.models import estimator as est_mod
    from vil_fusion_tpu_torch.utils import graphs

    st = (window, feats, pre, lidar, prior)
    a, b = [], []
    spec = graphs._flatten(est_mod._marginalize_and_slide(True, *st, cfg), a)
    graphs._flatten(est_mod._marginalize_and_slide(False, *st, cfg), b)
    return graphs._unflatten(spec, iter(graphs._select(is_key, a, b)))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import test_torch_cuda as tc
    from vil_fusion_tpu_torch.models import estimator as est_mod
    from vil_fusion_tpu_torch.utils import graphs

    if not torch.cuda.is_available():
        print("cond_ab: no CUDA device", file=sys.stderr)
        return 2
    card = cs._card_line()
    print(f"card: {card}", flush=True)
    bundles, (p0, q0, v0), qic = tc._estimator_bundles(est_mod.K + 8)
    est = est_mod.VILEstimator(est_mod.EstimatorConfig(), device="cuda")
    est.set_extrinsics(qic=qic, tic=np.zeros(3))
    est.set_initial_state(p=p0, q=q0, v=v0)
    steps, step = [], est_mod.fused_full_step

    def rec(*a, **kw):
        out = step(*a, **kw)
        steps.append((a, out))
        return out

    est_mod.fused_full_step = rec
    try:
        for args, kw in bundles:
            est.process_frame(*args, **kw)
    finally:
        est_mod.fused_full_step = step
    torch.cuda.synchronize()
    print(f"steady steps' keyframe decisions: {[bool(o[5]['is_key']) for _, o in steps]}",
          flush=True)

    # the paths alone and inside one conditional node, on the final window
    cfg, dev = est.cfg, est.window.p.device
    st = (est.window, est.feats, est.pre, est.lidar, est.prior)
    preds = {v: torch.tensor(v, device=dev) for v in (True, False)}
    runs = {"keyframe path alone": lambda: graphs.step(
                "cond_ab path", functools.partial(est_mod._marginalize_and_slide, True, cfg=cfg),
                st, static=(True, cfg)),
            "non-keyframe path alone": lambda: graphs.step(
                "cond_ab path", functools.partial(est_mod._marginalize_and_slide, False, cfg=cfg),
                st, static=(False, cfg))}
    for v in (True, False):
        runs[f"both in a conditional node, predicate {v}"] = functools.partial(
            lambda v: graphs.step("cond_ab cond", functools.partial(
                est_mod._marginalize_and_slide_cond, cfg=cfg), (preds[v],) + st,
                static=(cfg,)), v)
    for label, fn in runs.items():
        fn(), fn()  # the body, then the capture
        print(f"{label}: {cs._time_ms(fn, reps=10, warmup=2):.3f} ms (CUDA events, median "
              f"of 10) [{card}]", flush=True)

    # the whole step: conditional node against device select, in turns
    cond_fn = est_mod._marginalize_and_slide_cond

    def call(kind, a):
        body = functools.partial(est_mod._fused_full_step_body, run_ba=a[17], cfg=a[18])
        if kind == "cond":
            return graphs.step("fused_full_step", body, a[:17], static=(a[17], a[18]))
        est_mod._marginalize_and_slide_cond = _select  # read when the graph is captured
        try:
            return graphs.step("cond_ab select", body, a[:17], static=(a[17], a[18]))
        finally:
            est_mod._marginalize_and_slide_cond = cond_fn

    picks = {k: next(a for a, o in reversed(steps) if bool(o[5]["is_key"]) == k)
             for k in (True, False)}
    for kind in ("cond", "select"):
        call(kind, picks[True]), call(kind, picks[True])
    for k, a in picks.items():
        outs = [call(kind, a) for kind in ("cond", "select")]
        same = all(torch.equal(x, y) for x, y in zip(cs._leaves(outs[0]), cs._leaves(outs[1])))
        ms: dict = {}
        for kind in ("cond", "select", "select", "cond"):
            ms.setdefault(kind, []).append(cs._time_ms(lambda: call(kind, a), reps=5, warmup=1))
        print(f"{'keyframe' if k else 'non-keyframe'} step: device ms (CUDA events, medians of "
              f"5, in turns) conditional node {ms['cond']}, device select {ms['select']}; "
              f"outputs equal bit for bit: {same} [{card}]", flush=True)
    for k, a in picks.items():
        for kind in ("cond", "select"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call(kind, a)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            print(f"  {'keyframe' if k else 'non-keyframe'} step, {kind}: device kernel ms "
                  f"{sum(e.self_device_time_total for e in ev) / 1e3:.3f}, kernels "
                  f"{sum(e.count for e in ev)}", flush=True)
            for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
                print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  "
                      f"{e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
