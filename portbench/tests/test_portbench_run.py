"""run.py's refusals: no card, JAX-side modules; a whole run on the CPU
through ``run_cell`` (the card check is the only part skipped)."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.lib.cell import cell_devices
from portbench.run import forbidden_modules, run_cell

from . import tinyroot


@pytest.mark.parametrize("mods, found", [
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["hnsw_rs_tpu.models.hnsw"], ["hnsw_rs_tpu"]),
    (["hnsw_rs_tpu_torch", "hnsw_rs_tpu_torch.search", "jaxtyping", "jax_x"], []),
])
def test_forbidden_modules_compares_whole_top_level_names(mods, found):
    assert forbidden_modules(mods) == found


def test_run_fails_without_a_card():
    p = subprocess.run(
        [sys.executable, str(tinyroot.ROOT / "portbench/run.py"), "--workload",
         "sift1m.batch", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA device" in p.stderr


@pytest.mark.parametrize("cell", list(tinyroot.CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_on_the_cpu(tmp_path, cell, trace):
    root = tinyroot.make(tmp_path)
    out = run_cell(root, cell, 2**31 + 17, 0.3, bool(trace), torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert list(out["checks"]) == ["recall_at_10", "dist_err", "bad_rows",
                                   "dup_rows", "unsorted_rows"]
    json.dumps(out)
    if trace:
        assert "breakdown" in out and out["device"]["window_s"] > 0
    else:
        assert "setup_s" in out["metrics"] and "recall_at_10" in out["metrics"]


def test_tiny_run_loads_nothing_of_jax(tmp_path):
    root = tinyroot.make(tmp_path)
    code = (f"import sys; sys.path.insert(0, {str(tinyroot.ROOT)!r})\n"
            "import torch\n"
            "from pathlib import Path\n"
            "from portbench.run import run_cell, forbidden_modules\n"
            f"out = run_cell(Path({str(root)!r}), 'tinyp.probed', 3, 0.2, False,"
            " torch.device('cpu'))\n"
            "print(out['correct'], forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split()[-2:] == ["True", "[]"]


@pytest.mark.parametrize("cell, metric", [("tiny.batch", "l2"),
                                          ("tinyc.batch", "cosine")])
def test_the_index_gets_the_configurations_metric(tmp_path, monkeypatch, cell, metric):
    from hnsw_rs_tpu_torch import HNSW

    seen = []
    init = HNSW.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        seen.append(self.params.metric)

    monkeypatch.setattr(HNSW, "__init__", spy)
    root = tinyroot.make(tmp_path)
    out = run_cell(root, cell, 2**31 + 23, 0.3, False, torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert seen == [metric]


def test_a_cells_devices_follow_its_chips():
    assert cell_devices(torch.device("cuda", 0), 4) == [
        torch.device("cuda", i) for i in range(4)]
    assert cell_devices(torch.device("cuda", 0), 1) == [torch.device("cuda", 0)]
    assert cell_devices(torch.device("cpu"), 4) == [torch.device("cpu")] * 4


@pytest.mark.parametrize("trace", [0, 1])
def test_a_four_chip_cell_hands_its_family_four_devices(tmp_path, trace):
    root = tinyroot.make(tmp_path)
    cell = tinyroot.add_stub_cell(root, chips=4)
    out = run_cell(root, cell, 2**31 + 31, 0.3, bool(trace), torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert json.loads((root / "seen.json").read_text()) == {
        "devices": ["cpu"] * 4, "metric": "l2"}
    assert out["device"]["count"] == 4
