"""On the card, at a size a test run holds (100,000 x 128 points, 1,000
queries, the configurations' own index arguments, 4,096 pivots; the
probed cell with deep5m's 256-point shortlists and 36 probes, at rung
(64, 40)): the program's run is
correct and the control, the reference computed in TF32 in its place, is
not. ``python3 -m pytest -m cuda portbench/tests`` on a machine with a
GPU; skipped without one."""

import pytest
import torch

from portbench.reference import control
from portbench.run import run_cell

from . import tinyroot


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def small_root(tmp_path):
    return tinyroot.make(tmp_path, points=100_000, dim=128, queries=1000,
                         clusters=1000, pivots=4096, rung=(24, 12),
                         small_index=False, probe=(256, 36), probed_rung=(64, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.batch", "tinyp.probed", "tiny.online"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_fails_and_program_passes_on_the_card(card, small_root, cell, seed):
    out = run_cell(small_root, cell, seed, 1.0, False, card, family=control)
    assert not out["correct"], out["checks"]
    out = run_cell(small_root, cell, seed, 1.0, False, card)
    assert out["correct"], out["checks"]
