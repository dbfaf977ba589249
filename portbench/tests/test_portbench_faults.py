"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have (one chip: no exchange between chips
to leave out), and so does the control, the reference computed in TF32
in the program's place. The card check is skipped (``run_cell`` on the
CPU at a tiny size); everything else is a whole run."""

import numpy as np
import pytest
import torch

from portbench.reference import control
from portbench.run import run_cell

from . import tinyroot

CPU = torch.device("cpu")


def _wrap_ann_batch(monkeypatch, change):
    from hnsw_rs_tpu_torch import HNSW

    orig = HNSW.ann_batch

    def broken(self, queries, n, ef, max_iters=None):
        d, i = orig(self, queries, n, ef, max_iters=max_iters)
        return change(self, d, i)

    monkeypatch.setattr(HNSW, "ann_batch", broken)


def _half_left_out(index, d, i):
    b = d.shape[0] // 2
    return d[:b], i[:b]


def _answer_altered(index, d, i):
    i = i.copy()
    i[:, 0] = (i[:, 0] + 1) % len(index)
    return d, i


def _beam_step_unchanged(monkeypatch):
    from hnsw_rs_tpu_torch import search

    monkeypatch.setattr(search, "_beam_merge",
                        lambda beam_d2, beam_ids, beam_exp, ring, *a, **k:
                        (beam_d2, beam_ids, beam_exp, ring))


def _build_step_unchanged(monkeypatch):
    """The build runs, then hands back the graph as it found it: every
    layer's adjacency empty."""
    from hnsw_rs_tpu_torch.models import hnsw

    orig = hnsw.build_index

    def broken(*a, **kw):
        graph, ep, packed0, creps = orig(*a, **kw)
        graph.adjs = [torch.full_like(adj, -1) for adj in graph.adjs]
        return graph, ep, packed0, creps

    monkeypatch.setattr(hnsw, "build_index", broken)


FAULTS = {
    "half_left_out": lambda mp: _wrap_ann_batch(mp, _half_left_out),
    "answer_altered": lambda mp: _wrap_ann_batch(mp, _answer_altered),
    "beam_step_unchanged": _beam_step_unchanged,
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", list(tinyroot.CELLS))
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = tinyroot.make(tmp_path)
    FAULTS[fault](monkeypatch)
    out = run_cell(root, cell, 5, 0.2, False, CPU)
    assert not out["correct"], out["checks"]


def test_build_step_unchanged_is_not_correct(tmp_path, monkeypatch):
    root = tinyroot.make(tmp_path)
    _build_step_unchanged(monkeypatch)
    out = run_cell(root, "tiny.build", 5, 0.2, False, CPU)
    assert not out["correct"], out["checks"]
    assert out["checks"]["recall_at_10"]["value"] < 0.99


@pytest.mark.parametrize("cell", list(tinyroot.CELLS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tmp_path, cell, seed):
    root = tinyroot.make(tmp_path)
    out = run_cell(root, cell, seed, 0.2, False, CPU, family=control)
    dist = out["checks"]["dist_err"]
    assert not out["correct"] and dist["value"] > dist["limit"], out["checks"]
    assert np.isfinite(dist["value"])
