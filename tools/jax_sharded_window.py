#!/usr/bin/env python3
"""The bundle adjustment of both packages on a window the port saved, on
the CPU: the JAX package's sharded LM (`parallel/sharded_ba.optimize_sharded`
over a 4-device mesh) against its one-device LM (`models/ba.optimize`), and
the port's `optimize_sharded` on 4 gloo ranks (spawned processes that
import no jax) against its one-rank `ba.optimize`.

    python3 chip_smoke.py --save-window build/window34.pt   # on the card
    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tools/jax_sharded_window.py build/window34.pt

The file holds `utils/state_io.to_numpy` of the estimator's window, feats,
pre, lidar and prior (torch.save). Prints each LM's final cost, each
sharded cost's relative distance from its package's one-device cost against
tests/test_parallel.py's rtol (1e-3), and the largest pose and inverse-depth
differences.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NAMES = ("window", "feats", "pre", "lidar", "prior")


def _port_state(saved, device="cpu"):
    from vil_fusion_tpu_torch.models import window as twin
    from vil_fusion_tpu_torch.models.factors import MargPrior
    from vil_fusion_tpu_torch.utils import state_io

    classes = (twin.WindowState, twin.FeatureStore, twin.StackedPreint, twin.LidarConstraints,
               MargPrior)
    return [state_io.to_torch(c, saved[k], device) for c, k in zip(classes, NAMES)]


def _port_rank(rank, world, init_file, window, out_path):
    """One gloo rank of the port's optimize_sharded on the CPU."""
    import torch
    import torch.distributed as dist

    from vil_fusion_tpu_torch.models import ba
    from vil_fusion_tpu_torch.parallel import mesh as mesh_mod
    from vil_fusion_tpu_torch.parallel import sharded_ba

    torch.set_num_threads(1)
    state = _port_state(torch.load(window, weights_only=False))
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        st, ft, cost = sharded_ba.optimize_sharded(mesh_mod.make_mesh(world, device="cpu"),
                                                   *state, ba.BAConfig())
    finally:
        dist.destroy_process_group()
    torch.save(dict(p=st.p, q=st.q, inv_depth=ft.inv_depth, cost=cost, jax="jax" in sys.modules),
               out_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("window", type=Path)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--port-ranks", type=int, default=4)
    args = ap.parse_args(argv)

    import multiprocessing
    import tempfile

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from vil_fusion_tpu.models import ba as jba
    from vil_fusion_tpu.models import window as jwin
    from vil_fusion_tpu.models.factors import MargPrior
    from vil_fusion_tpu.parallel import mesh as jmesh
    from vil_fusion_tpu.parallel.sharded_ba import optimize_sharded
    from vil_fusion_tpu_torch.models import ba as tba

    saved = torch.load(args.window, weights_only=False)
    classes = (jwin.WindowState, jwin.FeatureStore, jwin.StackedPreint, jwin.LidarConstraints,
               MargPrior)

    def to_jax(cls, d):
        return cls(**{k: (to_jax(jwin.WindowState, v) if isinstance(v, dict) else jnp.asarray(v))
                      for k, v in d.items()})

    state = [to_jax(c, saved[k]) for c, k in zip(classes, NAMES)]
    cfg = jba.BAConfig()
    mesh = jmesh.make_mesh(args.devices)
    st_s, ft_s, c_s = optimize_sharded(mesh, *state, cfg)
    st_r, ft_r, c_r = jba.optimize(*state, cfg)
    st_p, ft_p, c_p = tba.optimize(*_port_state(saved), tba.BAConfig())
    with tempfile.TemporaryDirectory() as work:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_port_rank, args=(
            r, args.port_ranks, f"{work}/rendezvous", str(args.window), f"{work}/rank{r}.pt"))
            for r in range(args.port_ranks)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(600)
            if proc.exitcode != 0:
                raise RuntimeError(f"a port rank ended with {proc.exitcode}")
        ranks = [torch.load(f"{work}/rank{r}.pt", weights_only=False)
                 for r in range(args.port_ranks)]
    c_s, c_r, c_p = float(c_s), float(c_r), float(c_p)
    c_ps = float(ranks[0]["cost"])
    rel = abs(c_s - c_r) / abs(c_r)
    print(f"window {args.window} ({saved['feats']['active'].sum()} active feature slots of "
          f"{saved['feats']['active'].shape[0]}); {jax.device_count()} CPU devices")
    print(f"JAX sharded LM ({args.devices} devices) cost {c_s:.6f}, JAX one-device LM cost "
          f"{c_r:.6f}: relative distance {rel:.3e} ({'within' if rel <= 1e-3 else 'beyond'} "
          f"tests/test_parallel.py's rtol 1e-3)")
    rel_p = abs(c_ps - c_p) / abs(c_p)
    print(f"port sharded LM ({args.port_ranks} gloo ranks, CPU) cost {c_ps:.6f}, port one-rank "
          f"LM cost {c_p:.6f}: relative distance {rel_p:.3e} "
          f"({'within' if rel_p <= 1e-3 else 'beyond'} rtol 1e-3); the ranks' costs "
          f"{[float(r['cost']) for r in ranks]}, jax in a rank: "
          f"{any(r['jax'] for r in ranks)}; port one-rank against the JAX one-device LM "
          f"{abs(c_p - c_r) / abs(c_r):.3e}")
    for name, a, b in (("p", ranks[0]["p"], st_p.p), ("q", ranks[0]["q"], st_p.q),
                       ("inv_depth", ranks[0]["inv_depth"], ft_p.inv_depth)):
        print(f"  port sharded - one-rank {name}: max |diff| {(a - b).abs().max().item():.4g}")
    for name, a, b in (("p", st_s.p, st_r.p), ("q", st_s.q, st_r.q),
                       ("inv_depth", ft_s.inv_depth, ft_r.inv_depth)):
        print(f"  JAX sharded - one-device {name}: max |diff| "
              f"{np.abs(np.asarray(a) - np.asarray(b)).max():.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
