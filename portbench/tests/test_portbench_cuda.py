"""On the card, at a size a test run holds (100,000 x 128 points, 1,000
queries, the configurations' own index arguments, 4,096 pivots; the
probed cell with deep5m's 256-point shortlists and 36 probes, at rung
(64, 40); the cosine cell as the first): the program's run is correct
and the control, the reference computed in TF32 in its place, is not.
The frozen normalization equals the port's on the card. With four cards,
a four-chip cell hands its family four distinct cards and reports the
fullest card's peak, and the trace names each record's card.
``python3 -m pytest -m cuda portbench/tests`` on a machine with a GPU;
skipped without one (the four-card tests without four)."""

import json

import numpy as np
import pytest
import torch

from portbench.lib.trace import busy_window_s, profile_span
from portbench.reference import control
from portbench.reference.norm import normalize
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
@pytest.mark.parametrize("cell", ["tiny.batch", "tinyp.probed", "tiny.online",
                                  "tinyc.batch"])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_fails_and_program_passes_on_the_card(card, small_root, cell, seed):
    out = run_cell(small_root, cell, seed, 1.0, False, card, family=control)
    assert not out["correct"], out["checks"]
    out = run_cell(small_root, cell, seed, 1.0, False, card)
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 16, 10_000])
@pytest.mark.parametrize("d", [100, 128])
def test_normalize_matches_the_port_on_the_card(card, rows, d):
    from hnsw_rs_tpu_torch.ops.distance import normalize as port_normalize

    x = np.random.default_rng(rows + d).normal(size=(rows, d)).astype(np.float32)
    x[0] = 0.0  # a zero row passes through
    t = torch.from_numpy(x).to(card)
    ref, port = normalize(t), port_normalize(t)
    assert torch.equal(ref.view(torch.int32), port.view(torch.int32))


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    return [torch.device("cuda", i) for i in range(4)]


@pytest.mark.cuda
def test_a_four_chip_cell_gets_four_cards_and_the_fullest_peak(four_cards, tmp_path):
    root = tinyroot.make(tmp_path)
    block = 256 << 20
    cell = tinyroot.add_stub_cell(root, chips=4, block=block)
    out = run_cell(root, cell, 2**31 + 37, 1.0, False, four_cards[0])
    assert out["correct"], out["checks"]
    seen = json.loads((root / "seen.json").read_text())
    assert seen["devices"] == [str(d) for d in four_cards]
    peaks = [torch.cuda.max_memory_allocated(d) for d in four_cards]
    assert peaks[3] >= 4 * block
    assert out["device"]["count"] == 4
    assert out["device"]["memory_peak_bytes"] == max(peaks)


@pytest.mark.cuda
def test_the_trace_names_each_records_card(four_cards):
    xs = [torch.randn(2048, 2048, device=d) for d in four_cards]
    _, tr = profile_span(lambda: [x @ x for x in xs for _ in range(4)], four_cards)
    assert tr["devices"] == [0, 1, 2, 3]
    seen = {e["device_index"] for e in tr["events"] if e["device"]}
    assert seen == {0, 1, 2, 3}
    busy, window = busy_window_s(tr)
    assert 0 < busy <= window
