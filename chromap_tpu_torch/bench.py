"""Benchmark of the port: paired-end mapping throughput in reads/s, as one
JSON line -- the counterpart of the repository's `bench.py`.

    python -m chromap_tpu_torch.bench                       # on the card
    python -m chromap_tpu_torch.bench --torch-device cpu    # plain versions
    python -m chromap_tpu_torch.bench --cache _smoke --genome-core 96000000 \
        --runs 2                            # chip_smoke.py's 141 Mb set

It simulates a deterministic ATAC-like paired-end set (tests/simulate.py:
seed 7, reads of 100 bases with up to 3 mismatches and 2% indel reads
over a repeat-holding genome of `--genome-core` bases), indexes it with
the port (k = 17, w = 7), and maps it with `MappingPipeline` (`-l 2000`,
engine "auto", the native engine on every host core), best of N runs,
each through a fresh pipeline:

  host      the native host engine alone (`use_device=False`)
  device    the device-chunk scheduler (hybrid.py): the host maps the
            first chunk of every group, the device seeds and verifies the
            others (`use_device=True` on `--torch-device`)

Both take the candidate cache off (a `--device` run always does), so the
two BED files must be byte-equal; the bench fails when they differ, when
a device run seeded no chunk on the device, or when `--torch-device cuda`
finds no card. `value` is the device's rate whenever the device ran,
never the larger of the two; `CHROMAP_TPU_BENCH_DEVICE=0` benches the
host alone. The scored set is `--pairs` pairs (default 100,000); the
small set, its first fifth (20,000 pairs), rides along as `small_*`.

`extra.myers_band_cells_per_s` is kernel B (csrc/myers.cu) alone at N =
2^18 candidates, L = 100, e = 8: N * L * (2e + 1) band cells per launch,
timed with CUDA events over a chain of launches, printed with its share
of the bytes bound (PERF.md section 6). One CUDA kernel stands for both of
the JAX bench's Myers routes, so the JAX bench's second figure
(`myers_pallas_band_cells_per_s`) has no counterpart. On the CPU the same
figure is the plain version's rate at N = 2^12, with no bound share.

`reference_same_run_reads_per_s` needs a reference chromap binary at
/tmp/refbuild/chromap; without it those keys are left out and one line on
stderr says so.

Data lives under the temporary directory (`chromap_tpu_torch_bench_*`),
apart from the JAX bench's; `--cache DIR` takes another directory, and
reuses data that `chip_smoke.py` made there (same simulation, same
marker).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

PAIRS = 100_000
GENOME_CORE = 1_500_000
REF_BINARY = "/tmp/refbuild/chromap"
# H100 SXM data sheet: 3.35 TB/s HBM3; 67 T/s is the float32 rate outside
# the tensor cores, used for the 32-bit integer instructions the kernels
# issue. The true integer issue rate is lower (64 INT32 lanes per SM and
# clock against 128 FP32: ~16.7 T/s at 1.98 GHz), so a bound stays a
# lower bound on time, and a kernel of integer work can sit well above it.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def default_cache(pairs: int = PAIRS, genome_core: int = GENOME_CORE) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"chromap_tpu_torch_bench_{genome_core}_{pairs}")


def ensure_data(cache: str, pairs: int = PAIRS,
                genome_core: int = GENOME_CORE) -> None:
    """Simulate and index the set in `cache` unless its marker is there
    (the marker `chip_smoke.py` writes for the same simulation)."""
    marker = os.path.join(cache, f"ready_{genome_core}_{pairs}")
    if os.path.exists(marker):
        return
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from simulate import write_simulated_dataset

    from .config import IndexConfig
    from .pipeline import construct_index
    write_simulated_dataset(cache, num_pairs=pairs, seed=7, read_length=100,
                            genome_core=genome_core, max_mismatches=3,
                            indel_rate=0.02)
    with contextlib.redirect_stderr(io.StringIO()):
        construct_index(IndexConfig(
            reference_file_path=os.path.join(cache, "ref.fa"),
            index_output_file_path=os.path.join(cache, "index"),
            num_threads=os.cpu_count() or 1))
    with open(marker, "w") as f:
        f.write("ok")


def ensure_small(cache: str, pairs: int) -> None:
    """`small_r1.fq` / `small_r2.fq`: the first `pairs` pairs of the
    set's reads, beside its reference and index."""
    marker = os.path.join(cache, f"small_{pairs}")
    if os.path.exists(marker):
        return
    for i in (1, 2):
        with open(os.path.join(cache, f"r{i}.fq"), "rb") as f:
            lines = f.read().split(b"\n")[:4 * pairs]
        with open(os.path.join(cache, f"small_r{i}.fq"), "wb") as f:
            f.write(b"\n".join(lines) + b"\n")
    with open(marker, "w") as f:
        f.write("ok")


def _seeded_chunks() -> int:
    """Chunks the process's cached seeders have seeded within budget."""
    from .ops import device_seed as ds
    return sum(s.stats["chunks"] - s.stats["over_chunks"]
               for s in ds._seeder_cache.values())


def map_once(cache: str, reads: str, out: str, use_device: bool,
             torch_device: str, batch: int = 0) -> dict:
    """One mapping run of `<reads>1.fq` / `<reads>2.fq` through a fresh
    MappingPipeline (the native engine's random stream carries over
    between calls on one engine). Returns the wall seconds of
    map_paired_end, the pipeline's own "Mapped all reads" seconds, the
    chunks the device seeded, and the run's log."""
    from .config import MappingConfig
    from .pipeline import MappingPipeline
    cfg = MappingConfig(
        reference_file_path=os.path.join(cache, "ref.fa"),
        index_file_path=os.path.join(cache, "index"),
        read_file1_paths=[os.path.join(cache, f"{reads}1.fq")],
        read_file2_paths=[os.path.join(cache, f"{reads}2.fq")],
        mapping_output_file_path=out, max_insert_size=2000,
        use_device=use_device, torch_device=torch_device, cache_off=True,
        engine="auto", num_threads=os.cpu_count() or 1)
    if batch:
        cfg.device_batch_size = batch
    err = io.StringIO()
    before = _seeded_chunks()
    with contextlib.redirect_stderr(err):
        pipeline = MappingPipeline(cfg)
        t0 = time.perf_counter()
        pipeline.map_paired_end()
        wall = time.perf_counter() - t0
    text = err.getvalue()
    m = re.search(r"Mapped all reads in ([0-9.]+)s", text)
    run = dict(wall=wall, mapped_s=float(m.group(1)) if m else None,
               device_chunks=_seeded_chunks() - before, log=text)
    if use_device:
        kind = "CUDA" if torch_device == "cuda" else "CPU (plain torch)"
        if (f"Using {kind} device seeding" not in text
                or run["device_chunks"] < 1):
            raise RuntimeError(
                f"the device run of {reads}*.fq seeded no chunk on "
                f"{torch_device} ({run['device_chunks']} chunks); its "
                "rate would be the host's:\n" + text[-3000:])
    return run


def best_of(runs: int, **kw) -> dict:
    """The fastest of `runs` map_once runs (the first also pays the
    seeder build and the index upload)."""
    best = None
    for _ in range(runs):
        run = map_once(**kw)
        if best is None or run["wall"] < best["wall"]:
            best = run
    return best


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def reference_same_run(cache: str, pairs: int):
    """reads/s of a single-thread reference chromap on the same set in
    the same run, or None (with a line on stderr) when the binary is
    absent."""
    if not os.path.exists(REF_BINARY):
        log(f"bench: no reference chromap at {REF_BINARY}; "
            "reference_same_run_reads_per_s left out")
        return None
    idx = os.path.join(cache, "ref.index")
    if not os.path.exists(idx):
        subprocess.run([REF_BINARY, "-i", "-r", os.path.join(cache, "ref.fa"),
                        "-o", idx], capture_output=True, check=True)
    best = None
    for _ in range(2):
        out = subprocess.run(
            [REF_BINARY, "-x", idx, "-r", os.path.join(cache, "ref.fa"),
             "-1", os.path.join(cache, "r1.fq"),
             "-2", os.path.join(cache, "r2.fq"), "-l", "2000", "--BED",
             "-t", "1", "-o", os.path.join(cache, "ref_same_run.bed")],
            capture_output=True, check=True)
        m = re.search(rb"Mapped all reads in ([0-9.]+)s", out.stderr)
        if not m:
            raise RuntimeError("the reference chromap printed no mapping "
                               "time:\n" + out.stderr.decode()[-2000:])
        best = min(best or float("inf"), float(m.group(1)))
    return 2 * pairs / best


def bound(nbytes: float, ops: float = 0.0):
    """The least time (ms) a function could take on the card: the larger
    of its bytes (each input read once, each output written once) over
    the HBM rate and its 32-bit operations over OPS_PER_S. Returns (ms,
    "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def myers_cost(L: int, N: int, e: int):
    """(bytes, operations) of one kernel B launch at (L, N, e): both code
    planes read, both outputs written; per row the Peq update (10), text
    select (5), the Myers step (~12) and shifts (5), the 2e-cell band
    scan ~8 each and the 2e init rows ~10."""
    nbytes = 4 * ((L + 2 * e) * N + L * N) + 4 * 2 * N
    ops = N * (L * 32 + 2 * e * 8 + 2 * e * 10)
    return nbytes, ops


def time_ms(fn, reps: int = 10, warmup: int = 2, between=None,
            device="cuda") -> float:
    """Median milliseconds of one fn() call. On CUDA by events around
    each call, with a spin kernel holding the stream while the host
    enqueues every timed call, so the events see device time and not the
    host's launch overhead; `between()`, if given, runs before each call,
    outside the events. On the CPU by the host clock."""
    import torch
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(reps):
            if between is not None:
                between()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(400_000_000)              # ~0.2 s of cycles
    for a, b in events:
        if between is not None:
            between()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def myers_cells_per_s(dev) -> dict:
    """Kernel B's band cells per second at L = 100, e = 8 on seeded
    random codes: N = 2^18 on CUDA (CUDA events around a chain of 20
    launches after a warm-up, behind a spin kernel so the events see
    device time), N = 2^12 on the CPU (host clock, median of 3)."""
    import numpy as np
    import torch

    from .ops import myers as my
    e, L = 8, 100
    N = 1 << 18 if dev.type == "cuda" else 1 << 12
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.integers(0, 4, (L + 2 * e, N),
                                      dtype=np.int32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 4, (L, N), dtype=np.int32)).to(dev)
    cells = N * L * (2 * e + 1)
    if dev.type == "cuda":
        chain = 20
        n0 = my.myers.launches
        for _ in range(3):
            my.myers(p, t, e, L)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(100_000_000)
        a.record()
        for _ in range(chain):
            my.myers(p, t, e, L)
        b.record()
        torch.cuda.synchronize()
        if my.myers.launches - n0 != chain + 3:
            raise RuntimeError("kernel B did not launch on every call")
        ms = a.elapsed_time(b) / chain
    else:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            my.myers(p, t, e, L)
            times.append(time.perf_counter() - t0)
        ms = 1e3 * statistics.median(times)
    res = dict(cells_per_s=cells / (ms * 1e-3), ms=ms, lanes=N)
    if dev.type == "cuda":
        bms, by = bound(*myers_cost(L, N, e))
        res.update(bound_ms=bms, bound_by=by, share=bms / ms)
        if bms > ms:
            raise RuntimeError(
                f"kernel B read {ms:.4f} ms per launch, under its {by} "
                f"bound of {bms:.4f} ms: the timing is wrong")
    return res


def open_device(name: str):
    """The torch device `name` ("cuda" raises without a card), with the
    kernels built from csrc/ on CUDA (one nvcc each, at once)."""
    from .ops import _build
    dev = _build.resolve_device(name)
    if dev.type == "cuda":
        _build.build()
    return dev


def device_banner(dev) -> dict:
    """Where a run's numbers come from: the card's name and power limit
    as nvidia-smi prints them, or the CPU."""
    if dev.type != "cuda":
        return {"torch_device": "cpu"}
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"torch_device": "cuda", "name": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.splitlines()[dev.index or 0]}


def main(argv=None, batch: int = 0) -> int:
    """The bench; `batch` (pairs per device chunk, default the pipeline's
    16384) lets a caller in the same process run it on a set too small
    for the default chunk to reach the device."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--genome-core", type=int, default=GENOME_CORE)
    ap.add_argument("--cache", default="",
                    help="data directory (default: under the temporary "
                    "directory, one per --pairs and --genome-core)")
    ap.add_argument("--torch-device", choices=("cuda", "cpu"),
                    default="cuda")
    ap.add_argument("--runs", type=int, default=0,
                    help="runs per rate (default: 3 on the scored set, 5 "
                    "on the small set); each run on a large set also pays "
                    "a pipeline's index load")
    args = ap.parse_args(argv)

    use_device = os.environ.get("CHROMAP_TPU_BENCH_DEVICE", "1") == "1"
    dev = open_device(args.torch_device)          # no card: raises here
    cache = args.cache or default_cache(args.pairs, args.genome_core)
    ensure_data(cache, args.pairs, args.genome_core)
    small = args.pairs // 5
    ensure_small(cache, small)
    banner = device_banner(dev)
    if "nvidia_smi" in banner:
        print(banner["nvidia_smi"], flush=True)

    common = dict(cache=cache, torch_device=args.torch_device,
                  batch=batch)
    out = {n: os.path.join(cache, f"bench_{n}.bed")
           for n in ("host", "dev", "small_host", "small_dev")}
    host = best_of(args.runs or 3, reads="r", out=out["host"],
                   use_device=False, **common)
    host_rps = 2 * args.pairs / host["wall"]
    extra = {"host_only_reads_per_s": host_rps}
    if host["mapped_s"]:
        extra["host_mapped_only_reads_per_s"] = 2 * args.pairs / \
            host["mapped_s"]
    ref_rps = reference_same_run(cache, args.pairs)
    if ref_rps:
        extra["reference_same_run_reads_per_s"] = ref_rps
        if host["mapped_s"]:
            extra["vs_reference_mapped_only"] = \
                extra["host_mapped_only_reads_per_s"] / ref_rps
    scored = host_rps
    if use_device:
        devrun = best_of(args.runs or 3, reads="r", out=out["dev"],
                         use_device=True, **common)
        scored = 2 * args.pairs / devrun["wall"]
        extra["device_reads_per_s"] = scored
        extra["vs_host_only"] = scored / host_rps
        extra["device_chunks"] = devrun["device_chunks"]
        extra["small_host_reads_per_s"] = 2 * small / best_of(
            args.runs or 5, reads="small_r", out=out["small_host"],
            use_device=False, **common)["wall"]
        small_dev = best_of(args.runs or 5, reads="small_r",
                            out=out["small_dev"], use_device=True, **common)
        extra["small_dev_reads_per_s"] = 2 * small / small_dev["wall"]
        extra["small_device_chunks"] = small_dev["device_chunks"]
        for a, b in (("host", "dev"), ("small_host", "small_dev")):
            if not same_bytes(out[a], out[b]):
                raise SystemExit(f"bench: the device BED {out[b]} differs "
                                 f"from the host-only BED {out[a]}")
        extra["bed_byte_equal"] = True
        cells = myers_cells_per_s(dev)
        extra["myers_band_cells_per_s"] = cells["cells_per_s"]
        extra["myers_lanes"] = cells["lanes"]
        if "share" in cells:
            extra["myers_band_cells_bound_share"] = cells["share"]
            extra["myers_bound_by"] = cells["bound_by"]
    if ref_rps:
        extra["vs_reference_same_run"] = scored / ref_rps
    print(json.dumps({
        "metric": "reads/s (ATAC-like paired-end, simulated genome, "
                  "chromap_tpu_torch)",
        "value": scored, "unit": "reads/s",
        "pairs": args.pairs, "genome_core": args.genome_core,
        "device": banner if use_device else {"torch_device": "none"},
        "extra": extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
