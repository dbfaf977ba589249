"""A copy of the benchmark with tiny cells added as new files and
``BENCHMARK.json`` entries only, the way a new cell is added: configurations
``tiny`` (the ``sift1m`` layout) and ``tinyp`` (the ``deep5m`` layout, the
probed route) and one cell per traffic kind."""

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
         "tiny.build": ("tiny", "build", "sift1m.build")}


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
    for name, base, fin in (
            ("tiny", "sift1m", {"pivots": pivots}),
            ("tinyp", "deep5m", {"pivots": pivots, "pivot_cover": 0.5,
                                 "pivot_shortlist": probe[0]})):
        cfg = json.loads((cfg_dir / f"{base}.json").read_text())
        cfg.update(name=name, points=points, dim=dim, queries=queries)
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
