"""Maps the bench's set host-only and with the device, byte-compares the
two BED files and prints both rates: the counterpart of
tools/device_bench_parity.py.

    python -m chromap_tpu_torch.tools.bench_parity [num_pairs] [runs]
        [batch_size] [--cache DIR] [--torch-device {cuda,cpu}]

num_pairs (default 20,000) picks the bench set (the bench's 1.5 Mb
genome core), simulated and indexed as chromap_tpu_torch/bench.py does
when absent; `--cache` takes another directory, such as the bench's
own 100,000-pair set (num_pairs 100000); runs (default 3) is the
best of N for each rate; batch_size sets the device chunk in pairs (by
default the pipeline's 16,384). Each run maps through a fresh
MappingPipeline with the candidate cache off (as a `--device` run always
has it). Exits 1 when the BED files differ; raises when a device run
seeded no chunk on `--torch-device` or the card is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .. import bench


def main(argv=None, genome_core: int = bench.GENOME_CORE) -> int:
    """`genome_core` lets a caller in the same process pick a set other
    than the bench's genome."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("num_pairs", type=int, nargs="?", default=20_000)
    ap.add_argument("runs", type=int, nargs="?", default=3)
    ap.add_argument("batch_size", type=int, nargs="?", default=0)
    ap.add_argument("--cache", default="")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"),
                    default="cuda")
    args = ap.parse_args(argv)

    dev = bench.open_device(args.torch_device)
    cache = args.cache or bench.default_cache(args.num_pairs, genome_core)
    bench.ensure_data(cache, args.num_pairs, genome_core)
    banner = bench.device_banner(dev)
    if "nvidia_smi" in banner:
        print(banner["nvidia_smi"], flush=True)
    common = dict(cache=cache, reads="r", torch_device=args.torch_device,
                  batch=args.batch_size)
    paths = {n: os.path.join(cache, f"parity_{n}.bed")
             for n in ("host", "dev")}
    host = bench.best_of(args.runs, out=paths["host"], use_device=False,
                         **common)
    devrun = bench.best_of(args.runs, out=paths["dev"], use_device=True,
                           **common)
    same = bench.same_bytes(paths["host"], paths["dev"])
    reads = 2 * args.num_pairs
    print(f"host: {reads / host['wall']:,.0f} reads/s  device: "
          f"{reads / devrun['wall']:,.0f} reads/s  parity: "
          f"{'OK' if same else 'MISMATCH'}", flush=True)
    print(json.dumps(dict(
        tool="bench_parity", pairs=args.num_pairs, cache=cache,
        host_reads_per_s=reads / host["wall"],
        device_reads_per_s=reads / devrun["wall"],
        device_chunks=devrun["device_chunks"], bed_bytes=os.path.getsize(
            paths["host"]), parity=same, device=banner)), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
