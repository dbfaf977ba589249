"""The generators: the same seed gives the same data; the sizes are a
fixed set for every seed."""

import numpy as np
import pytest
import torch

from portbench.lib.seeds import derive
from portbench.lib.layout import Layout

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]
SPEC = {"points": 3000, "dim": 8, "queries": 250, "clusters": 30, "noise": 0.05}


@pytest.mark.parametrize("gen", ["clustered", "heavy_tailed"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, -3, 2**70])
def test_same_seed_same_data(gen, seed):
    mod = Layout(ROOT).module("data", gen)
    a = mod.make(SPEC, seed, torch.device("cpu"))
    b = mod.make(SPEC, seed, torch.device("cpu"))
    c = mod.make(SPEC, seed + 1, torch.device("cpu"))
    assert a[0].shape == (3000, 8) and a[1].shape == (250, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_derive_separates_streams():
    assert derive(5, "a") != derive(5, "b") != derive(6, "a")
    assert 0 <= derive(-1, "a") < 2**63


def test_heavy_tailed_sizes_are_fixed():
    mod = Layout(ROOT).module("data", "heavy_tailed")
    w = 1.0 / (np.arange(30) + 10.0)
    s = mod.shares(3000, w)
    assert s.sum() == 3000 and np.all(np.diff(s) <= 0)
    assert np.abs(s - 3000 * w / w.sum()).max() < 1.0


def test_clustered_assignment_is_even():
    mod = Layout(ROOT).module("data", "clustered")
    g = torch.Generator().manual_seed(1)
    a = mod.even_assign(3001, 30, g, "cpu")
    counts = torch.bincount(a, minlength=30)
    assert counts.min() == 100 and counts.max() == 101
