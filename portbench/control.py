"""The output check's control and its readings at a cell's own size.

    python3 portbench/control.py --workload bed_dm6.pe100 \
        --seeds 11,12,13 --seconds 5 [--sound]

Runs the cell as `run.py` does, with the program's mapping options
changed by the configuration's `control` (one guarantee of the
configuration broken), or with `--sound` as configured, once a seed in
this one process, and prints one JSON line a run: the seed, `correct`
and every number the check compared. The benchmark's own runs never run
it; tests/test_portbench_run.py runs the same control on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.harness import run_cell
    from portbench.spec import Spec
    spec = Spec(ROOT)
    conf = spec.config(spec.cell(args.workload)["config"])
    options = None if args.sound else conf["control"]
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(spec, args.workload, seed, args.seconds, False,
                     options=options)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": options, "correct": r["correct"],
                          "checks": {k: c["value"] for k, c in
                                     r["checks"].items()},
                          "metrics": {k: m["value"] for k, m in
                                      r["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
