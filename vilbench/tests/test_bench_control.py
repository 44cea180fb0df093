"""The control of `correct` on the card, at each cell's own size on three
seeds: the reference one precision lower (TF32), put in the program's
place, comes out not correct, while the program's own readings from the
same run stay within the limits. A 2-s window: the sampled frames past it
are pushed after it, so every check runs as in a full run (about a minute
a seed). Run on the card with
`python -m pytest vilbench/tests/test_bench_control.py -m cuda`."""
import time

import pytest

from vilbench import harness
from vilbench.tests.tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_bench(ROOT)["workloads"]])
def test_control_is_not_correct(cell, card):
    spec = harness.load_cell(ROOT, cell)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = harness.run_cell(spec, seed, 2.0, False, card, time.perf_counter(), ROOT,
                               control="lower")
        assert not out["correct"], (seed, out["checks"])
        prog = out["program_checks"]
        assert all(c["value"] <= c["limit"] for c in prog.values()), (seed, prog)
