"""Run the control in the program's place: the reference computed in
TF32 (``portbench/reference/control.py``) in the stored space of the
configuration's metric, driven by a cell's own traffic at the cell's own
size and judged as a run is. It has to come out not correct. Prints one
JSON line of judged numbers per seed.

    python3 portbench/control.py --workload sift1m.batch --seeds 1,2,3 --seconds 3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from portbench.lib.layout import Layout
    from portbench.reference import control
    from portbench.run import run_cell

    chips = int(Layout(ROOT).cell_entry(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"control: the cell needs {chips} CUDA device(s)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(ROOT, args.workload, seed, args.seconds, False, dev,
                       family=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"], "checks": out["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
