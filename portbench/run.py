"""Benchmark of chromap_tpu_torch, the PyTorch and CUDA port: one run of
one cell of BENCHMARK.json, from the root of a checkout.

    python3 portbench/run.py --workload bed_dm6.pe100 --seed 12345 \
        --seconds 20 --trace 0

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted` and `failed` (reads in the window's passes, and of those in
passes that did not finish), `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks`: each number the output check compared,
beside its limit, which also end standard error. Exits non-zero and
prints no result when no CUDA card is visible, when the cell needs more
cards than there are, when the run imported JAX or the JAX package, or
when anything fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import torch

        from portbench.harness import run_cell
        from portbench.spec import Spec
        spec = Spec(ROOT)
        chips = spec.cell(args.workload)["chips"]
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible")
        if torch.cuda.device_count() < chips:
            raise RuntimeError(f"{args.workload} needs {chips} cards, "
                               f"{torch.cuda.device_count()} are visible")
        result = run_cell(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except Exception:
        traceback.print_exc()
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
