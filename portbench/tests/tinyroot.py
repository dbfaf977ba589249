"""A copy of the benchmark with tiny cells added as new files and
``BENCHMARK.json`` entries only, the way a new cell is added: configurations
``tiny`` (the ``sift1m`` layout), ``tinyp`` (the ``deep5m`` layout, the
probed route) and ``tinyc`` (the ``sift1m`` layout under ``metric``
``"cosine"``), one cell per traffic kind and a cosine batch cell; and
on request a cell on four chips whose family records what it is given."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL_INDEX = {"m": 8, "ef_cons": 32,
               "cluster_kwargs": {"pool_p": 16, "points_per_cluster": 32,
                                  "fanout": 3, "select_alg4": False,
                                  "merge_slots": 16}}
CELLS = {"tiny.batch": ("tiny", "batch", "sift1m.batch"),
         "tinyp.probed": ("tinyp", "batch", "deep5m.probed"),
         "tiny.online": ("tiny", "online", "sift1m.online"),
         "tiny.build": ("tiny", "build", "sift1m.build"),
         "tinyc.batch": ("tinyc", "batch", "sift1m.batch")}


def make(dest: Path, points: int = 4000, dim: int = 16, queries: int = 200,
         clusters: int = 40, pivots: int = 256, rung=(32, 40),
         small_index: bool = True, probe=(32, 6), probed_rung=None) -> Path:
    """Copy ``BENCHMARK.json`` and ``portbench/`` to ``dest`` and add the
    tiny cells; returns ``dest``. ``small_index=False`` keeps the
    configurations' own M, ef_cons and cluster arguments; ``probe`` is
    ``tinyp``'s (shortlist, probes) and ``probed_rung`` its cell's rung
    (``rung`` by default)."""
    dest = Path(dest)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg_dir, wl_dir = dest / "portbench/configs", dest / "portbench/workloads"
    for name, base, fin, extra in (
            ("tiny", "sift1m", {"pivots": pivots}, {}),
            ("tinyp", "deep5m", {"pivots": pivots, "pivot_cover": 0.5,
                                 "pivot_shortlist": probe[0]}, {}),
            ("tinyc", "sift1m", {"pivots": pivots}, {"metric": "cosine"})):
        cfg = json.loads((cfg_dir / f"{base}.json").read_text())
        cfg.update(name=name, points=points, dim=dim, queries=queries, **extra)
        cfg["data"]["clusters"] = clusters
        cfg["index"].update(SMALL_INDEX if small_index else {}, finalize=fin)
        if "serve_probes" in cfg["index"]:
            cfg["index"]["serve_probes"] = probe[1]
        (cfg_dir / f"{name}.json").write_text(json.dumps(cfg, indent=1))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for cell, (config, traffic, like) in CELLS.items():
        wl = json.loads((wl_dir / f"{like}.json").read_text())
        r = probed_rung if config == "tinyp" and probed_rung else rung
        wl.update(config=config, rung={"ef": r[0], "max_iters": r[1]})
        (wl_dir / f"{cell}.json").write_text(json.dumps(wl, indent=1))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": f"a tiny {like}"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


# the stub family's source; ``{block}`` is filled in by ``add_stub_cell``
STUB = '''"""A family for tests: writes the devices and the metric it is handed to
``seen.json`` at the checkout's root, keeps (i + 1) * BLOCK bytes on the
i-th device and touches each block on every search, and serves through
``hnsw_cluster`` on the first device."""

import json
from pathlib import Path

import torch

from portbench.lib.layout import Layout

ROOT = Path(__file__).resolve().parents[2]
BLOCK = {block}
HNSW = Layout(ROOT).module("indexes", "hnsw_cluster")


class Index:
    def __init__(self, hnsw, blocks):
        self.hnsw, self.blocks = hnsw, blocks


def build(config, train, devices):
    (ROOT / "seen.json").write_text(json.dumps(
        {{"devices": [str(d) for d in devices], "metric": config["metric"]}}))
    blocks = [torch.zeros((i + 1) * BLOCK, dtype=torch.uint8, device=d)
              for i, d in enumerate(devices)]
    index, spans = HNSW.build(config, train, devices)
    return Index(index, blocks), spans


def search(index, queries, k, rung):
    for b in index.blocks:
        b.add_(1)
    return HNSW.search(index.hnsw, queries, k, rung)
'''


def add_stub_cell(dest: Path, chips: int, block: int = 1024) -> str:
    """Add the configuration ``tinys`` (``tiny`` served by the stub family
    above, which keeps ``block`` bytes a device) and the batch cell
    ``tinys.batch`` on ``chips`` chips, as files and ``BENCHMARK.json``
    entries only; returns the cell's name."""
    dest = Path(dest)
    bench_dir = dest / "portbench"
    (bench_dir / "indexes/stub.py").write_text(STUB.format(block=block))
    cfg = json.loads((bench_dir / "configs/tiny.json").read_text())
    cfg["name"] = "tinys"
    cfg["index"]["family"] = "stub"
    (bench_dir / "configs/tinys.json").write_text(json.dumps(cfg, indent=1))
    wl = json.loads((bench_dir / "workloads/tiny.batch.json").read_text())
    wl["config"] = "tinys"
    (bench_dir / "workloads/tinys.batch.json").write_text(json.dumps(wl, indent=1))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tinys.batch", "config": "tinys",
                               "traffic": "batch", "chips": chips,
                               "why": f"a tiny batch cell on {chips} chips"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.batch" in m.get("workloads", []):
            m["workloads"].append("tinys.batch")
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return "tinys.batch"
