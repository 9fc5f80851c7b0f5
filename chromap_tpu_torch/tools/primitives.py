"""The library ops the port's seeding step runs between its kernels, each
timed alone at the step's own sizes: the counterpart of
tools/device_primitives.py.

    python -m chromap_tpu_torch.tools.primitives [--cache DIR]
        [--torch-device {cuda,cpu}]

Sizes: a chunk of 32,768 reads (the pipeline's 16,384-pair chunk) has
Mtot = 851,968 minimizer slots and Htot = 983,040 hit slots; NK is the
number of keys of the index of the set `--cache` names (by default the
bench's set: about 500k keys on its 1.5 Mb genome core; 31,831,587 on
chip_smoke.py's 141 Mb set). The ops, on seeded random operands:

  sort_u64 over Mtot + NK (the merged-sort probe) and over Htot (the hit
  sort), searchsorted_u64 of Mtot queries in NK keys, u32 and u64 gathers
  of Mtot and of Htot elements from an NK table, `_scatter_rows` of Htot
  words into the (HCAP + 1) x rows cluster tile, `index_add_` of Mtot
  deltas into Htot + 1 slots, the tiled `_cumsum1d` (Mtot),
  `_cummax1d` (Htot) and `_cummin1d_rev_u64` (Mtot + NK), and a chain
  of 100 elementwise int32 ops over Mtot (50 times an xor and an add,
  each a launch that reads and writes 4 bytes an element).

The u64 ops go through ops/u64.py's helpers, sign flips included. Each
op is timed by chromap_tpu_torch/bench.py `time_ms` (CUDA events, median
of 10 calls after warm-up, behind a spin kernel so the events see device
time) and printed as one JSON line with its bytes bound: each operand
read once and each output written once (a gather's table: the entries
this run's indices touch) over 3.35 TB/s. On the CPU the host clock
times the plain torch ops and no bound is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROWS = 32768


def index_keys(cache: str) -> int:
    """The number of keys of a set's index (only that array is read)."""
    import numpy as np
    with np.load(os.path.join(cache, "index")) as data:
        return int(data["hash_keys"].shape[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cache", default="",
                    help="data set directory (default: the bench's set)")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"),
                    default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .. import bench
    from ..ops import device_seed as ds
    from ..ops.u64 import MAX64, MIN64, searchsorted_u64, sort_u64
    dev = bench.open_device(args.torch_device)
    cache = args.cache or bench.default_cache()
    if not args.cache:
        bench.ensure_data(cache)
    nk = index_keys(cache)
    B = ROWS
    Mtot, Htot = ds.MZ_PER_READ * B, ds.HITS_PER_READ * B
    tile = (ds.HCAP + 1) * B
    print(json.dumps(dict(tool="primitives", rows=B, Mtot=Mtot, Htot=Htot,
                          NK=nk, device=bench.device_banner(dev))),
          flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def words(n):
        return torch.randint(MIN64, MAX64, (n,), generator=g, device=dev,
                             dtype=torch.int64)

    def ints(n, hi, dtype=torch.int64):
        return torch.randint(0, hi, (n,), generator=g, device=dev,
                             dtype=dtype)

    def op(name, fn, nbytes, n):
        ms = bench.time_ms(fn, device=dev)
        row = dict(op=name, n=n, ms=ms)
        if dev.type == "cuda":
            row.update(bytes=nbytes, bound_ms=bench.bound(nbytes)[0])
            row["bound_share"] = row["bound_ms"] / ms
        print(json.dumps(row), flush=True)

    def touched(idx, width):
        return int(torch.unique(idx).numel()) * width

    merged = words(Mtot + nk)
    op(f"sort_u64 x{Mtot + nk} (merged probe: Mtot + NK)",
       lambda: sort_u64(merged), 16 * (Mtot + nk), Mtot + nk)
    hits = words(Htot)
    op(f"sort_u64 x{Htot} (hit sort: Htot)", lambda: sort_u64(hits),
       16 * Htot, Htot)
    keys = sort_u64(words(nk))
    queries = words(Mtot)
    op(f"searchsorted_u64 {Mtot} queries in {nk} keys",
       lambda: searchsorted_u64(keys, queries), 8 * nk + 16 * Mtot, Mtot)
    tbl32 = ints(nk, 1 << 31, torch.int32)
    tbl64 = words(nk)
    for n, label in ((Mtot, "Mtot"), (Htot, "Htot")):
        idx = ints(n, nk)
        op(f"u32 gather x{n} ({label}) from {nk}", lambda: tbl32[idx],
           8 * n + 4 * n + touched(idx, 4), n)
        op(f"u64 gather x{n} ({label}) from {nk}", lambda: tbl64[idx],
           8 * n + 8 * n + touched(idx, 8), n)
    dest = ints(Htot, tile + 1)
    op(f"_scatter_rows x{Htot} (Htot) into {tile}",
       lambda: ds._scatter_rows(hits, dest, tile), 16 * Htot + 8 * tile,
       Htot)
    starts = torch.sort(ints(Mtot, Htot + 1)).values
    deltas = ints(Mtot, 1 << 20, torch.int32)
    op(f"index_add_ x{Mtot} (Mtot) into {Htot + 1}",
       lambda: torch.zeros(Htot + 1, dtype=torch.int32, device=dev)
       .index_add_(0, starts, deltas), 12 * Mtot + 4 * (Htot + 1), Mtot)
    small = ints(Mtot, 4, torch.int32)
    op(f"_cumsum1d x{Mtot} (Mtot)", lambda: ds._cumsum1d(small),
       8 * Mtot, Mtot)
    runs = ints(Htot, Htot, torch.int32)
    op(f"_cummax1d x{Htot} (Htot)", lambda: ds._cummax1d(runs), 8 * Htot,
       Htot)
    op(f"_cummin1d_rev_u64 x{Mtot + nk} (Mtot + NK)",
       lambda: ds._cummin1d_rev_u64(merged), 16 * (Mtot + nk), Mtot + nk)
    x = ints(Mtot, 1 << 30, torch.int32)

    def elem100():
        a = x
        for _ in range(50):
            a = (a ^ 0x1E3779B9) + 0x3C6EF372
        return a
    op(f"100 elementwise int32 ops on ({Mtot},)", elem100, 100 * 8 * Mtot,
       Mtot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
