"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's data on the card from the seed, builds the index
through ``hnsw_rs_tpu_torch``'s public API, warms up, measures for
``--seconds``, judges every answer due against the plain reference
(``portbench/reference``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and ``checks`` (each
number compared, with its limit), which also go to standard error.
Exits non-zero, printing no result, without a card, with too few cards,
or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the JAX side of the repo: its top-level names, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "hnsw_rs_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole, so ``hnsw_rs_tpu_torch`` is not ``hnsw_rs_tpu``) that
    belong to JAX or the JAX package."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float | None = None, family=None) -> dict:
    """One run; returns the result object (without printing). ``device``
    gives the kind: a ``cuda`` run takes ``cuda:0`` ... ``cuda:chips-1``, a
    CPU run as many stand-ins of the CPU. ``family`` replaces the
    configuration's index family (the control)."""
    import torch

    from portbench.lib.cell import Cell
    from portbench.lib.layout import Layout
    from portbench.lib.trace import breakdown, busy_window_s
    from portbench.reference.judge import Reference, limits, verdict

    t_start = time.perf_counter() if t_start is None else t_start
    layout = Layout(root)
    entry = layout.cell_entry(name)
    cell = Cell(layout, name, seed, seconds, trace, device, family)
    if cell.cards:
        torch.cuda.init()
    for d in cell.cards:
        torch.cuda.reset_peak_memory_stats(d)
    traffic = layout.module("traffic", cell.workload["traffic"])
    record = traffic.run(cell)
    record["setup_s"] = record["window_start"] - t_start
    cell.drain()
    # the fullest card's peak
    peak = max((torch.cuda.max_memory_allocated(d) for d in cell.cards), default=0)
    answers = record.pop("answers")
    gc.collect()
    if cell.cards:
        torch.cuda.empty_cache()  # every card's cache
    numbers = Reference(cell.train, cell.queries, cell.k, cell.device,
                        cell.config["metric"]).judge(answers)
    del answers
    record["judge"] = numbers
    correct, checks = verdict(numbers, limits(cell.config["check"]))

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in layout.metrics(name, kind):
        v = layout.module("metrics", m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cell.cards else cell.device.type,
           "kind": (torch.cuda.get_device_name(cell.device)
                    if cell.cards else cell.device.type),
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(numbers["attempted"]),
           "failed": int(numbers["bad_rows"]), "metrics": metrics, "device": dev}
    if trace and record.get("trace"):
        dev["busy_s"], dev["window_s"] = busy_window_s(record["trace"])
        out["breakdown"] = breakdown(record["trace"])
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib.layout import Layout

    chips = int(Layout(ROOT).cell_entry(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX-side modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
