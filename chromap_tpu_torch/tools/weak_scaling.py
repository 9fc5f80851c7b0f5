"""Weak scaling of the seeding step over mesh shards: the counterpart of
tools/weak_scaling.py.

    python -m chromap_tpu_torch.tools.weak_scaling [--out FILE]
        [--per-device-reads 2048] [--cache DIR] [--torch-device {cuda,cpu}]

`MeshSeeder` (ops/device_seed.py) at 1, 2 and 4 shards with a fixed
number of reads per shard S (weak scaling: n * S reads in all), on the
first n * S reads of a data set (read pairs interleaved as the pipeline
packs them) against its index (k = 17, w = 7, e = 8). `--cache` names
the set as for tools/stage_profile.py: by default the bench's set, made
if absent; `chip_smoke.py` runs it on its 141 Mb set, where each shard probes
the whole 31.8M-key index (kernel E on CUDA). Shard i runs on card
i % (cards visible): on a machine with one card every shard is a shard
of cuda:0; with several, every card is used. On the CPU (`--torch-device
cpu`) the shards are shards of the CPU. Each size's wall is the median
of 5 submit + resolve calls (upload, steps, downloads and the join, all
on the host clock) after a warm-up call.

As in the JAX tool, per_read_us = wall / (n * S) and efficiency_n =
min over sizes of per_read_us / per_read_us_n (at most 1 by
construction). One JSON line per size; `--out` writes them, with the
parameters, to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

SHARDS = (1, 2, 4)
REPS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--per-device-reads", type=int, default=2048)
    ap.add_argument("--cache", default="",
                    help="data set directory (default: the bench's set)")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"),
                    default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .. import bench
    from ..ops import device_seed as ds
    from .stage_profile import kernel_wrappers, load_set, read_chunk
    dev = bench.open_device(args.torch_device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    banner = bench.device_banner(dev)
    cache = args.cache or bench.default_cache()
    if not args.cache:
        bench.ensure_data(cache)
    index, ref_seqs = load_set(cache)
    S = args.per_device_reads
    codes, _ = read_chunk(cache, S * SHARDS[-1])
    L = codes.shape[1]
    wrappers = kernel_wrappers()
    print(json.dumps(dict(tool="weak_scaling", per_device_reads=S,
                          cache=cache, keys=int(index.hash_keys.shape[0]),
                          cards=cards, device=banner)), flush=True)

    results = []
    for n in SHARDS:
        devices = [torch.device(dev.type, i % cards) if dev.type == "cuda"
                   else dev for i in range(n)]
        seeder = ds.MeshSeeder(index, ref_seqs, 8, 2, (500, 1000), devices)
        B = S * n
        rw = ds._pack_reads(codes[:B])
        before = {k: fn.launches for k, fn in wrappers.items()}
        res = seeder.resolve(seeder.submit_packed(rw, B, L))
        launches = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        if res[3]:
            raise RuntimeError(f"{n} shards: a shard went over its budget")
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            seeder.resolve(seeder.submit_packed(rw, B, L))
            times.append(time.perf_counter() - t0)
        wall = statistics.median(times)
        results.append(dict(devices=n, reads=B, wall_s=wall,
                            per_read_us=1e6 * wall / B,
                            cards_used=len(set(devices)),
                            launches_per_call=launches))
        del seeder
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    best = min(r["per_read_us"] for r in results)
    for row in results:
        row["weak_scaling_efficiency"] = best / row["per_read_us"]
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"metric": "device seeding weak scaling (MeshSeeder; "
                                 "efficiency = best per-read time / "
                                 "per-read time, <= 1 by construction)",
                       "per_device_reads": S, "cache": cache,
                       "device": banner, "results": results}, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
