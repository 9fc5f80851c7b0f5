"""Per-stage timing of the port's seeding step on one chunk: the
counterpart of tools/device_stage_profile.py.

    python -m chromap_tpu_torch.tools.stage_profile [--cache DIR]
        [--rows 32768] [--reps 20] [--split] [--reads PREFIX]
        [--torch-device {cuda,cpu}]

For every stop of `STAGES`, in order, it builds the step truncated there
(`_build_step(..., stop=s)`, never through `_cached_step`, whose cache
the mapper uses) and runs it on one chunk of the set's reads: `--rows`
reads (default 32,768, the pipeline's 16,384-pair chunk, so Mtot 851,968,
Htot 983,040 and captot 65,536), read pairs interleaved as the pipeline
packs them. It prints one JSON line per stop:

  cum_ms       the truncated step's host clock, from its call until its
               checkpoint (for the full step, its download) is copied to
               the host, median of `--reps` after a warm-up call
  delta_ms     cum_ms less the previous stop's
  kernel_ms    device time of the kernels of one more call, by
               torch.profiler (memory copies included), and `launches`
               their count; `kernel_delta_ms` less the previous stop's
  own          launches of the hand-written kernels in that call, from
               their wrappers' counts

The step makes hundreds of launches and is host-bound, so CUDA events
placed between stages would time the host's launch gaps: each truncated
step is timed whole instead, and the device time is read from the
profiler's kernel events. Delta i is an in-context cost: what stage i
adds to the step, launch overhead included. On the CPU (`--torch-device
cpu`) the host clock times the plain versions and no device time is
measured (kernel_ms null).

`--cache` names a data set made by `python -m chromap_tpu_torch.bench`
or `chip_smoke.py` (ref.fa, index, <reads>1.fq, <reads>2.fq); by default
the bench's set, made if absent. `--split` runs the Hi-C step (drop-off
verification) at e = 4, the `--preset hic` threshold; BED runs e = 8.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from ..ops.device_seed import STAGES

def add_chunk_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--cache", default="",
                    help="data set directory (default: the bench's set)")
    ap.add_argument("--reads", default="r",
                    help="reads are <cache>/<reads>1.fq and <reads>2.fq")
    ap.add_argument("--rows", type=int, default=32768,
                    help="reads in the chunk (two per pair)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--split", action="store_true",
                    help="the Hi-C step (drop-off verification, e = 4)")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"),
                    default="cuda")


def read_chunk(cache: str, rows: int, reads: str = "r"):
    """(rows, L) u8 codes and (rows,) lengths: the first rows // 2 pairs
    of the set, read 1 then read 2 of each pair, padded with N."""
    import numpy as np
    tbl = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        tbl[c] = i
    seqs = []
    with open(os.path.join(cache, f"{reads}1.fq"), "rb") as f1, \
            open(os.path.join(cache, f"{reads}2.fq"), "rb") as f2:
        while len(seqs) < rows:
            recs = [(f.readline(), f.readline(), f.readline(), f.readline())
                    for f in (f1, f2)]
            if not recs[0][1]:
                break
            seqs += [tbl[np.frombuffer(r[1].rstrip(), np.uint8)]
                     for r in recs]
    seqs = seqs[:rows]
    if len(seqs) < rows:
        raise SystemExit(f"{cache}: {len(seqs)} reads, fewer than --rows "
                         f"{rows}")
    L = max(len(s) for s in seqs)
    codes = np.full((rows, L), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = s
    return codes, np.array([len(s) for s in seqs], np.int32)


def load_set(cache: str):
    """(index, reference sequences) of a data set."""
    from ..index.index import MinimizerIndex
    from ..io.fastx import load_all_sequences
    index = MinimizerIndex.load(os.path.join(cache, "index"))
    refs = [bytes(r.seq) for r in
            load_all_sequences(os.path.join(cache, "ref.fa"))]
    return index, refs


class Chunk:
    """One chunk on the device, and truncated steps over it."""

    def __init__(self, args):
        import torch

        from .. import bench
        from ..ops import device_seed as ds
        from ..ops.u64 import from_numpy_u32
        self.dev = bench.open_device(args.torch_device)
        cache = args.cache or bench.default_cache()
        if not args.cache:
            bench.ensure_data(cache)
        codes, lengths = read_chunk(cache, args.rows, args.reads)
        index, refs = load_set(cache)
        self.split = args.split
        self.e = 4 if args.split else 8
        self.seeder = ds.DeviceSeeder(index, refs, self.e, 2, (500, 1000),
                                      device=self.dev, split=args.split)
        B, L = codes.shape
        self.B, self.L = B, L
        self.sizes = dict(L=L, B=B, Mtot=ds.MZ_PER_READ * B,
                          Htot=ds.HITS_PER_READ * B,
                          captot=ds.CANDS_PER_READ * B)
        self.rw = from_numpy_u32(ds._pack_reads(codes)).to(self.dev)
        self.lengths = torch.from_numpy(lengths).to(self.dev)
        self.header = dict(
            cache=cache, rows=B, L=L, split=args.split, e=self.e,
            keys=int(self.seeder.hash_keys.numel()),
            occurrences=int(self.seeder.occurrences.numel()), **{
                k: v for k, v in self.sizes.items() if k not in ("L", "B")},
            device=bench.device_banner(self.dev))

    def step(self, stop):
        from ..ops import device_seed as ds
        s = self.seeder
        fn = ds._build_step(s.k, s.w, s.e, s.f0, s.f1, s.min_num_seeds,
                            s.num_refs, s.split, stop=stop)
        args = (self.rw, self.lengths) + s._index_operands()
        return lambda: fn(*args, **self.sizes)


def kernel_wrappers() -> dict:
    """The hand-written kernels' wrappers by name; each counts its own
    launches in `.launches`."""
    from ..ops import dense_minimizer as dm
    from ..ops import device_seed as ds
    from ..ops import myers as my
    return {"dense_minimizer": dm.dense_minimizer, "myers": my.myers,
            "cluster_scan": ds.cluster_scan,
            "myers_dropoff": my.myers_dropoff,
            "index_probe": ds.index_probe}


def expected_launches(stop, split: bool) -> dict:
    """The hand-written kernels a CUDA step with the default probe,
    truncated at `stop`, launches: A from `kmer` on, E from `probe` on,
    C from `cluster` on, and B (BED) or D twice (split: the primary pass
    and the 5'-gap retry) only in the full step."""
    i = STAGES.index(stop)
    return {"dense_minimizer": int(i >= STAGES.index("kmer")),
            "myers": int(stop is None and not split),
            "cluster_scan": int(i >= STAGES.index("cluster")),
            "myers_dropoff": 2 * int(stop is None and split),
            "index_probe": int(i >= STAGES.index("probe"))}


def host_ms(call, reps: int, dev) -> float:
    """Median ms of call() until its first output is on the host."""
    import torch
    call()[0].cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()[0].cpu()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def kernel_events(call) -> list:
    """(device us, count, name) of each kernel and copy that one call()
    ran on the card, by torch.profiler, largest first. Raises when the
    profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    return rows


def profile_call(call, dev):
    """(kernel ms, launches, own launches) of one call: the device time
    of its kernels and copies by torch.profiler (None on the CPU), and
    the launches of each hand-written kernel from its wrapper's count."""
    wrappers = kernel_wrappers()
    before = {n: fn.launches for n, fn in wrappers.items()}
    if dev.type != "cuda":
        call()[0].cpu()
        kernel_ms = launches = None
    else:
        rows = kernel_events(lambda: call()[0].cpu())
        kernel_ms = sum(r[0] for r in rows) / 1e3
        launches = sum(r[1] for r in rows)
    own = {n: fn.launches - before[n] for n, fn in wrappers.items()}
    return kernel_ms, launches, own


def run_stops(args, stops, tool: str) -> list:
    """Time and profile the chunk's step truncated at each of `stops`;
    prints a header line and one JSON line per stop, returns the rows."""
    chunk = Chunk(args)
    print(json.dumps(dict(tool=tool, **chunk.header)), flush=True)
    out, prev = [], None
    for stop in stops:
        call = chunk.step(stop)
        cum = host_ms(call, args.reps, chunk.dev)
        kernel_ms, launches, own = profile_call(call, chunk.dev)
        row = dict(stop=stop or "FULL", cum_ms=cum,
                   delta_ms=cum - (prev["cum_ms"] if prev else 0.0),
                   kernel_ms=kernel_ms,
                   kernel_delta_ms=(None if kernel_ms is None else
                                    kernel_ms - (prev["kernel_ms"]
                                                 if prev else 0.0)),
                   launches=launches, own=own)
        print(json.dumps(row), flush=True)
        out.append(row)
        prev = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_chunk_args(ap)
    run_stops(ap.parse_args(argv), STAGES, "stage_profile")
    return 0


if __name__ == "__main__":
    sys.exit(main())
