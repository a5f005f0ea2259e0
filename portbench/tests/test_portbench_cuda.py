"""On the card, at the cells' own sizes: the program's readings keep the
limits, and the control's and the planted fault's fail them, on three seeds
(the readings the limits were set from are in PERF.md). Run:
python -m pytest --noconftest -q -m cuda portbench/tests/test_portbench_cuda.py"""
import pytest
import torch

from portbench import control
from portbench.harness import checks, manifest
from portbench.tests.tiny import ROOT

SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["uc2-finetune", "m3p-finetune", "uc2-eval", "m3p-eval"])
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    limits = manifest.cell(ROOT, cell).limits
    for seed in SEEDS:
        r = control.readings(ROOT, cell, seed, 3.0, "cuda")
        sides = {k: checks.verdict(v, limits)[0] for k, v in r.items()
                 if k != "seed"}
        assert sides.pop("program"), r
        assert not any(sides.values()), r
