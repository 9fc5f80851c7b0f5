"""The whole seeding step on one chunk, plus only the stops that are
named: the counterpart of tools/device_full_time.py.

    python -m chromap_tpu_torch.tools.full_time [--stops probe,cluster]
        [--cache DIR] [--rows 32768] [--reps 20] [--split]
        [--torch-device {cuda,cpu}]

Same data, columns and method as tools/stage_profile.py (one JSON line
per stop, the full step last as "FULL"), for the named stops alone: a
measure-change loop turns around without running all fourteen. Deltas
are taken between the stops that ran.
"""

from __future__ import annotations

import argparse
import sys

from ..ops.device_seed import STAGES
from .stage_profile import add_chunk_args, run_stops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_chunk_args(ap)
    ap.add_argument("--stops", default="",
                    help="comma-separated stops to time before the full "
                    f"step, of {', '.join(STAGES[:-1])}")
    args = ap.parse_args(argv)
    stops = [s for s in args.stops.split(",") if s]
    bad = [s for s in stops if s not in STAGES]
    if bad:
        ap.error(f"unknown stops {bad}")
    stops.sort(key=STAGES.index)
    run_stops(args, stops + [None], "full_time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
