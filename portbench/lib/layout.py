"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic kind, index
family, data generator or metric sits in a file of its own, named after
it, so a new cell or metric is new files plus new ``BENCHMARK.json``
entries and no edit:

- ``portbench/configs/<config>.json``
- ``portbench/workloads/<cell>.json``
- ``portbench/traffic/<kind>.py``      (``run(cell) -> record``)
- ``portbench/indexes/<family>.py``    (``build(config, train, devices)``,
  ``search``)
- ``portbench/data/<generator>.py``    (``make(spec, seed, device)``)
- ``portbench/metrics/<metric>.py``    (``read(record) -> float | None``)
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = "portbench"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Layout:
    """The benchmark's files under one checkout root."""

    def __init__(self, root: Path | str):
        self.root = Path(root).resolve()
        self.bench = self.root / BENCH_DIR
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _file(self, folder: str, name: str, suffix: str) -> Path:
        if not _NAME.match(name):
            raise ValueError(f"not a benchmark name: {name!r}")
        path = self.bench / folder / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} file for {name!r}: {path}")
        return path

    def _json(self, folder: str, name: str) -> dict:
        with open(self._file(folder, name, ".json")) as f:
            return json.load(f)

    def module(self, folder: str, name: str):
        """Load ``portbench/<folder>/<name>.py`` by its path (names may
        hold dots, so it is not imported as a package member)."""
        path = self._file(folder, name, ".py")
        mod_name = f"portbench_{folder}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell_entry(self, cell: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == cell:
                return w
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")

    def workload(self, cell: str) -> dict:
        """The cell's workload file, checked against its
        ``BENCHMARK.json`` entry."""
        entry = self.cell_entry(cell)
        wl = self._json("workloads", cell)
        for key in ("config", "traffic"):
            if wl.get(key) != entry[key]:
                raise ValueError(f"{cell}: workload file says {key}="
                                 f"{wl.get(key)!r}, BENCHMARK.json {entry[key]!r}")
        return wl

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports:
        those whose ``workloads`` list names it, or that have none."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]
