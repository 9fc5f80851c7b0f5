#!/usr/bin/env python3
"""Smoke run of chromap_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order (any failure exits non-zero before the last line):

  kernels  builds the four CUDA kernels of csrc/ (one nvcc each, all at
           once), launches each on CUDA tensors at its path's shapes
           (seeded numpy inputs) and holds it against its plain torch
           version on the same tensors: exact equality, since every output
           is an integer. Times both with CUDA events (median of >= 10
           launches after warm-up). The drop-off kernel runs at the Hi-C
           path's two shapes (L = 100, e = 4, and the 5'-gap retry's
           L = 84), with planted junctions so that lanes stop early, and
           once more with texts equal to the patterns' diagonal, so that
           no lane stops. For every kernel it also prints what bounds
           it: ptxas' registers and shared memory, resident blocks per
           SM, the achieved GB/s, and a cold time (a 128 MiB write
           between launches evicts the 50 MB L2).
  path     the paired-end --device BED flow at realistic scale: simulates a
           ~141 Mb one-chromosome genome and 100,000 pairs, builds the
           index with the port's CLI (-i), and maps in-process four times
           in turns -- host-only (cache off), CUDA device seeding (the
           main path's run, whose kernel launches are counted), device
           again with the seeder resident, host again. All four BED files
           must be byte-equal, at least one chunk must be seeded on the
           device, and every kernel must launch in the main path's run.
  hic      the Hi-C flow (--preset hic: e = 4, MAPQ 1, split alignment,
           pairs output, low-memory mode) on the same genome and index.
           hic_r1.fq / hic_r2.fq are the path's pairs with bases 60-99 of
           every fourth read 1 replaced by 40 bases from a seeded random
           place of the genome (ligation-junction reads, so the drop-off
           kernel's early stop and the 5'-gap retry fire). Maps in turns
           host-only, CUDA device seeding (the Hi-C path's run, launches
           counted from 0), device again with the seeder resident. The
           three .pairs files must be byte-equal and non-empty, a chunk
           must be seeded on the device, and the minimizer, cluster and
           drop-off kernels must each launch.
  chunk    one 16384-pair chunk of the path's data, and one of the Hi-C
           reads in split mode, seeded by the port on CUDA and by its
           plain path on the CPU: the downloads must be byte-equal.

It prints the card (nvidia-smi name and power limit) first and again
before the JSON line of per-kernel numbers, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
It exits non-zero, printing no result, when torch.cuda is unavailable or
the package cannot be imported. The data lives under _smoke/ and the
kernel builds under chromap_tpu_torch/_build/, both ignored by git.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "_smoke")

# H100 SXM data sheet: 3.35 TB/s HBM3; 67 T/s is the float32 rate outside
# the tensor cores, used for the 32-bit integer instructions these kernels
# issue. The true integer issue rate is lower (64 INT32 lanes per SM and
# clock against 128 FP32: ~16.7 T/s at 1.98 GHz), so the bound stays a
# lower bound on time, and a kernel of integer work can sit well above it.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

REPLACES = {
    "dense_minimizer": "chromap_tpu/ops/pallas_dense.py:157",
    "myers": "chromap_tpu/ops/pallas_myers.py:39",
    "cluster_scan": "chromap_tpu/ops/device_seed.py:227",
    "myers_dropoff": "chromap_tpu/ops/pallas_myers.py:222",
}
KERNEL_SOURCES = (("dense_minimizer", "dense_minimizer.cu"),
                  ("myers", "myers.cu"),
                  ("cluster_scan", "cluster_scan.cu"),
                  ("myers_dropoff", "myers_dropoff.cu"))


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, reps: int = 10, warmup: int = 2, between=None) -> float:
    """Median milliseconds of one call of fn, by CUDA events. A spin
    kernel holds the stream while the host enqueues every timed call, so
    the events see device time and not the host's launch overhead.
    `between()`, if given, runs before each call, outside the events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(2_000_000_000)           # about a second of cycles
    for a, b in events:
        if between is not None:
            between()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return -1
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max().item()) if d.numel() else 0)
    return err


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------

def kernel_inputs_dense(rng, L: int, B: int):
    import numpy as np
    import torch
    codes = rng.integers(0, 4, (L, B)).astype(np.int32)
    codes[rng.random((L, B)) < 0.01] = 4                  # N bases
    homo = rng.random(B) < 0.02                           # window ties
    codes[10:40, homo] = codes[10, homo]
    lengths = np.full((1, B), L, np.int32)
    short = rng.random(B) < 0.05
    lengths[0, short] = rng.integers(30, L, int(short.sum()))
    for b in np.flatnonzero(short):
        codes[lengths[0, b]:, b] = 4
    return (torch.from_numpy(codes).cuda(), torch.from_numpy(lengths).cuda())


def dense_cost(codes_T, lengths, k: int, w: int):
    """(bytes, 32-bit ops) the dense front end needs on these inputs."""
    import torch
    L, B = codes_T.shape
    valid = codes_T < 4
    idx = torch.arange(L, device=codes_T.device)[:, None]
    last_bad = torch.cummax(torch.where(valid, -1, idx), 0).values
    n_kmer = int(((idx - last_bad) >= k).sum().item())
    nbytes = 4 * (L * B + B) + 4 * (3 * L * B + 2 * B)
    # per position: rolling registers and run (~8); per window offset
    # two 64-bit hash loads and compares (~12); per valid k-mer three
    # Hash64 of ~14 u64 ops each (2 instructions per u64 op) and packing
    ops = L * B * (8 + 12 * min(w, L - 1) + 16) + n_kmer * (3 * 14 * 2 + 8)
    return nbytes, ops


def kernel_inputs_myers(rng, L: int, N: int, e: int):
    import numpy as np
    import torch
    pats = rng.integers(0, 4, (N, L + 2 * e)).astype(np.int32)
    pats[rng.random(pats.shape) < 0.002] = 4
    texts = pats[:, e:e + L].copy()
    # half the candidates carry a few substitutions and maybe an indel,
    # the rest are unrelated sequence (distance far past e)
    near = rng.random(N) < 0.5
    nsub = rng.integers(0, e + 2, N)
    for n in np.flatnonzero(near):
        for _ in range(nsub[n]):
            texts[n, rng.integers(0, L)] = rng.integers(0, 4)
        if rng.random() < 0.2:
            q = rng.integers(1, L - 1)
            texts[n, q:] = pats[n, e + q + 1:e + L + 1]
    far = ~near
    texts[far] = rng.integers(0, 4, (int(far.sum()), L))
    return (torch.from_numpy(np.ascontiguousarray(pats.T)).cuda(),
            torch.from_numpy(np.ascontiguousarray(texts.T)).cuda())


def myers_cost(L: int, N: int, e: int):
    nbytes = 4 * ((L + 2 * e) * N + L * N) + 4 * 2 * N
    # per row: Peq update (10), text select (5), the Myers step (~12),
    # shifts (5); the 2e-cell band scan ~8 each; the 2e init rows ~10
    ops = N * (L * 32 + 2 * e * 8 + 2 * e * 10)
    return nbytes, ops


def kernel_inputs_dropoff(rng, L: int, N: int, e: int):
    """Split candidates: half near copies (a few substitutions, some
    with an indel), a quarter spliced at a ligation junction (unrelated
    sequence from a random base on, so the lane stops there), a quarter
    unrelated."""
    import numpy as np
    import torch
    pats = rng.integers(0, 4, (N, L + 2 * e)).astype(np.int32)
    pats[rng.random(pats.shape) < 0.002] = 4
    texts = pats[:, e:e + L].copy()
    kind = rng.integers(0, 4, N)
    nsub = rng.integers(0, e + 2, N)
    for n in np.flatnonzero(kind <= 1):
        for _ in range(nsub[n]):
            texts[n, rng.integers(0, L)] = rng.integers(0, 4)
        if rng.random() < 0.2:
            q = rng.integers(1, L - 1)
            texts[n, q:] = pats[n, e + q + 1:e + L + 1]
    junction = rng.integers(0, L, N)
    spliced = ((np.arange(L)[None, :] >= junction[:, None])
               & (kind == 2)[:, None])
    texts[spliced] = rng.integers(0, 4, int(spliced.sum()))
    far = kind == 3
    texts[far] = rng.integers(0, 4, (int(far.sum()), L))
    return (torch.from_numpy(np.ascontiguousarray(pats.T)).cuda(),
            torch.from_numpy(np.ascontiguousarray(texts.T)).cuda())


def dropoff_cost(rml, L: int, e: int):
    """(bytes, 32-bit ops) of one drop-off pass on these inputs: a lane
    that stops at step i has read the 2e init rows and i + 1 rows of
    each operand (rml = i), one that never stops L rows."""
    import torch
    N = rml.shape[0]
    steps = int(torch.clamp(rml.to(torch.int64) + 1, max=L).sum().item())
    nbytes = 4 * (2 * e * N + 2 * steps) + 4 * 3 * N
    # per row ~34 (the Myers step, the violation test and the Peq
    # update); the 2e init rows ~10 and the 2e-cell band scan ~8 each
    ops = steps * 34 + N * (2 * e * 10 + 2 * e * 8 + 8)
    return nbytes, ops


def kernel_inputs_cluster(rng, H: int, B: int):
    import numpy as np
    import torch
    words = np.full((H + 1, B), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    # most reads hold a few dozen hits, some fill the tile
    counts = rng.integers(0, 40, B)
    full = rng.random(B) < 0.1
    counts[full] = rng.integers(40, H + 1, int(full.sum()))
    for b in range(B):
        n = int(counts[b])
        if n == 0:
            continue
        strand = rng.integers(0, 2, n).astype(np.uint64)
        rid = rng.integers(0, 3, n).astype(np.uint64)
        # clustered starts: runs of equal or near positions with jumps
        base = rng.integers(0, 1 << 30)
        steps = np.where(rng.random(n) < 0.7, rng.integers(0, 3, n),
                         rng.integers(5, 5000, n))
        start = (base + np.cumsum(steps)).astype(np.uint64) & np.uint64(
            0xFFFFFFFF)
        w = ((np.uint64(b) << np.uint64(47)) | (strand << np.uint64(46))
             | (rid << np.uint64(32)) | start)
        words[:n, b] = np.sort(w)
    mm = rng.integers(1, 40, B).astype(np.int32)
    req = np.clip(mm - rng.integers(0, 3, B), 1, 2).astype(np.int32)
    return (torch.from_numpy(words.view(np.int64)).cuda(),
            torch.from_numpy(mm).cuda(), torch.from_numpy(req).cuda())


def cluster_cost(H: int, B: int):
    nbytes = 8 * (H + 1) * B + 4 * 2 * B + H * B * (1 + 8)
    # per slot: 64-bit compares and u32 sums (~14), the state update
    # (~14), the packed candidate (~4), counted in 32-bit instructions
    ops = H * B * 32
    return nbytes, ops


def check_kernel(label: str, wrapper, kernel, plain, cost, note) -> dict:
    """Launch a kernel and its plain version on the same CUDA tensors,
    require equal outputs, time both, and log one line. `wrapper` holds
    the launch count; `cost` is (bytes, ops); `note(outputs)` adds a
    word about the data."""
    import torch
    n0 = wrapper.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    equal = all(torch.equal(g, x) for g, x in zip(got, want))
    err = max_abs_err(got, want)
    ms, plain_ms = time_cuda(kernel), time_cuda(plain)
    bms, by = bound(*cost)
    log(f"{label}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"launches={wrapper.launches - n0} equal={equal} max_abs_err={err} "
        f"bound_ms={bms:.4f} ({by}; {cost[0] / 1e6:.1f} MB, "
        f"{cost[1] / 1e9:.2f} G ops) {note(got)}")
    if not equal:
        raise AssertionError(f"{label}: kernel differs from its plain "
                             "version")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                max_abs_err=err, nbytes=cost[0])


def kernel_detail(label: str, name: str, L: int, r: dict, fn, flush) -> None:
    """Log what bounds a kernel: achieved GB/s warm and cold (`flush` is
    overwritten before each cold launch), and the resident blocks per SM
    from its C entry's occupancy query."""
    from chromap_tpu_torch.ops import _build
    blocks, threads, smem, tile = _build.occupancy(name, L)
    unit = "reads a tile" if name == "dense_minimizer" else "ring stages"
    cold_ms = time_cuda(fn, between=flush.zero_)
    t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
    gbs = [r["nbytes"] / (t * 1e-3) / 1e9 for t in (r["ms"], cold_ms)]
    log(f"{label}: {gbs[0]:.0f} GB/s warm, {gbs[1]:.0f} GB/s cold "
        f"(cold_ms={cold_ms:.4f}, a {flush.numel() >> 20} MiB write "
        f"before each launch); resident blocks per SM {blocks} of "
        f"{threads} threads, {smem} B shared memory a block, {tile} {unit}"
        + ("; faster than its bytes bound warm: the 50 MB L2 served it"
           if r["ms"] < t_bytes else ""))


def phase_kernels(results: dict) -> None:
    import numpy as np
    import torch
    from chromap_tpu_torch.ops import dense_minimizer as dm
    from chromap_tpu_torch.ops import device_seed as ds
    from chromap_tpu_torch.ops import myers as my

    rng = np.random.default_rng(7)
    L, B = 100, 32768
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    # kernel A at the main path's (k, w), then at the index preset for
    # fragments over 80 bases
    for k, w in ((17, 7), (23, 11)):
        c, n = kernel_inputs_dense(rng, L, B)
        r = check_kernel(
            f"kernel A dense_minimizer k={k} w={w} L={L} B={B}",
            dm.dense_minimizer,
            lambda: dm.dense_minimizer(c, n, k, w, L),
            lambda: dm.dense_minimizer_plain(c, n, k, w, L),
            dense_cost(c, n, k, w),
            lambda o: f"minimizers={int(o[3].sum())} "
                      f"bad_reads={int(o[4].sum())}")
        if "dense_minimizer" not in results:
            kernel_detail(f"kernel A k={k} w={w}", "dense_minimizer", L, r,
                          lambda: dm.dense_minimizer(c, n, k, w, L), flush)
            results["dense_minimizer"] = r

    N, e = 65536, 8
    p, t = kernel_inputs_myers(rng, L, N, e)
    results["myers"] = check_kernel(
        f"kernel B myers N={N} L={L} e={e}", my.myers,
        lambda: my.myers(p, t, e, L), lambda: my.myers_plain(p, t, e, L),
        myers_cost(L, N, e), lambda o: f"within_e={int((o[0] <= e).sum())}")
    kernel_detail(f"kernel B L={L}", "myers", L, results["myers"],
                  lambda: my.myers(p, t, e, L), flush)

    H = ds.HCAP
    words, mm, req = kernel_inputs_cluster(rng, H, B)
    results["cluster_scan"] = check_kernel(
        f"kernel C cluster_scan H+1={H + 1} B={B}", ds.cluster_scan,
        lambda: ds.cluster_scan(words, mm, req, e),
        lambda: ds.cluster_scan_plain(words, mm, req, e),
        cluster_cost(H, B), lambda o: f"emitted={int(o[0].sum())}")
    kernel_detail(f"kernel C H+1={H + 1}", "cluster_scan", L,
                  results["cluster_scan"],
                  lambda: ds.cluster_scan(words, mm, req, e), flush)

    # kernel D at the Hi-C path's shapes: the primary pass over the whole
    # read, then the 5'-gap retry over rows g.. of the same planes
    e = 4
    g = 20 - e
    p, t = kernel_inputs_dropoff(rng, L, N, e)
    for key, pp, tt, ln in (("myers_dropoff", p, t, L),
                            ("myers_dropoff_retry", p[g:], t[g:], L - g)):
        rml = my.myers_dropoff_plain(pp, tt, e, ln)[2]
        results[key] = check_kernel(
            f"kernel D myers_dropoff N={N} L={ln} e={e}", my.myers_dropoff,
            lambda: my.myers_dropoff(pp, tt, e, ln),
            lambda: my.myers_dropoff_plain(pp, tt, e, ln),
            dropoff_cost(rml, ln, e),
            lambda o: f"stopped_early={int((o[2] < ln).sum())} "
                      f"negated={int((o[1] < 0).sum())}")
        kernel_detail(f"kernel D L={ln}", "myers_dropoff", ln, results[key],
                      lambda: my.myers_dropoff(pp, tt, e, ln), flush)
    # the primary pass's planes with texts = the patterns' diagonal: no
    # lane stops, so every warp runs the whole read (early-stop divergence
    # is gone; what remains is the per-row latency and issue)
    tf = p[e:e + L].contiguous()
    check_kernel(
        f"kernel D myers_dropoff full read N={N} L={L} e={e}",
        my.myers_dropoff, lambda: my.myers_dropoff(p, tf, e, L),
        lambda: my.myers_dropoff_plain(p, tf, e, L),
        dropoff_cost(torch.full((N,), L, dtype=torch.int32), L, e),
        lambda o: f"stopped_early={int((o[2] < L).sum())}")


# ---------------------------------------------------------------------
# phase: path
# ---------------------------------------------------------------------

def make_data(genome_core: int, pairs: int) -> None:
    marker = os.path.join(DATA, f"ready_{genome_core}_{pairs}")
    if not os.path.exists(marker):
        for name in ("hic_r1.fq", "hic_r2.fq"):   # made from the old reads
            if os.path.exists(os.path.join(DATA, name)):
                os.remove(os.path.join(DATA, name))
        make_path_data(genome_core, pairs, marker)
    make_hic_reads()


def make_path_data(genome_core: int, pairs: int, marker: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from simulate import write_simulated_dataset
    os.makedirs(DATA, exist_ok=True)
    t0 = time.time()
    write_simulated_dataset(DATA, num_pairs=pairs, seed=7,
                            read_length=100, genome_core=genome_core,
                            max_mismatches=3, indel_rate=0.02)
    log(f"simulated genome_core={genome_core} pairs={pairs} in "
        f"{time.time() - t0:.1f}s")
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "chromap_tpu_torch.cli", "-i",
         "-t", str(os.cpu_count() or 1),
         "-r", os.path.join(DATA, "ref.fa"),
         "-o", os.path.join(DATA, "index")],
        cwd=ROOT, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"index build failed:\n{res.stderr[-4000:]}")
    log(f"index built by the port's CLI in {time.time() - t0:.1f}s: "
        + " | ".join(l for l in res.stderr.splitlines()
                     if "minimizers" in l or "Saved" in l))
    with open(marker, "w") as f:
        f.write("ok")


HIC_JUNCTION = 60   # read-1 bases from here on come from elsewhere


def make_hic_reads() -> None:
    """hic_r1.fq / hic_r2.fq: the path's pairs, with bases 60.. of every
    fourth read 1 replaced by as many bases from a seeded random place of
    the genome -- a ligation junction inside the read, as Hi-C's
    chimeric reads carry. Read 2 is unchanged."""
    import shutil

    import numpy as np
    out1 = os.path.join(DATA, "hic_r1.fq")
    out2 = os.path.join(DATA, "hic_r2.fq")
    if os.path.exists(out1) and os.path.exists(out2):
        return
    t0 = time.time()
    with open(os.path.join(DATA, "ref.fa"), "rb") as f:
        first = f.read().split(b">")[1]
    genome = first.split(b"\n", 1)[1].replace(b"\n", b"").upper()
    with open(os.path.join(DATA, "r1.fq"), "rb") as f:
        lines = f.read().split(b"\n")
    nrec = len(lines) // 4
    rng = np.random.default_rng(11)
    spliced = 0
    for r in range(0, nrec, 4):
        seq = lines[4 * r + 1]
        n = len(seq) - HIC_JUNCTION
        if n <= 0:
            continue
        st = int(rng.integers(0, len(genome) - n))
        lines[4 * r + 1] = seq[:HIC_JUNCTION] + genome[st:st + n]
        spliced += 1
    with open(out1 + ".tmp", "wb") as f:
        f.write(b"\n".join(lines))
    shutil.copyfile(os.path.join(DATA, "r2.fq"), out2)
    os.replace(out1 + ".tmp", out1)
    log(f"hic reads: {spliced} of {nrec} read-1s spliced at base "
        f"{HIC_JUNCTION} in {time.time() - t0:.1f}s")


def map_once(use_device: bool, out: str, preset: str | None = None,
             reads: str = "r"):
    """One in-process mapping run of `reads`1.fq / `reads`2.fq. Without a
    preset: BED with `-l 2000`; with one: the CLI's `--preset` defaults.
    The candidate cache is off in every run (--device turns it off)."""
    import contextlib
    import io

    from chromap_tpu_torch.config import MappingConfig, apply_preset
    from chromap_tpu_torch.pipeline import MappingPipeline

    cfg = MappingConfig(
        reference_file_path=os.path.join(DATA, "ref.fa"),
        index_file_path=os.path.join(DATA, "index"),
        read_file1_paths=[os.path.join(DATA, f"{reads}1.fq")],
        read_file2_paths=[os.path.join(DATA, f"{reads}2.fq")],
        mapping_output_file_path=out,
        use_device=use_device, torch_device="cuda", cache_off=True,
        device_batch_size=16384, num_threads=os.cpu_count() or 1)
    if preset is None:
        cfg.max_insert_size = 2000
    else:
        apply_preset(cfg, preset)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        t0 = time.time()
        pipe = MappingPipeline(cfg)
        t1 = time.time()
        pipe.map_paired_end()
        t2 = time.time()
    return t1 - t0, t2 - t1, err.getvalue()


def phase_path(results: dict, genome_core: int, pairs: int) -> None:
    import torch
    from chromap_tpu_torch.ops import dense_minimizer as dm
    from chromap_tpu_torch.ops import device_seed as ds
    from chromap_tpu_torch.ops import myers as my

    # runs in turns: host, device (the main path's run: launch counts
    # from 0 just before, read just after; it also builds the seeder and
    # uploads the index), device again with the seeder resident, host
    # again -- the second host and device runs are the warm pair
    names = ("host", "device", "device_warm", "host_warm")
    paths = {n: os.path.join(DATA, f"{n}.bed") for n in names}
    walls, logs = {}, {}
    _, walls["host"], _ = map_once(False, paths["host"])
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    for fn in (dm.dense_minimizer, my.myers, ds.cluster_scan):
        fn.launches = 0
    _, walls["device"], logs["device"] = map_once(True, paths["device"])
    launches = {"dense_minimizer": dm.dense_minimizer.launches,
                "myers": my.myers.launches,
                "cluster_scan": ds.cluster_scan.launches}
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated() - mem0
    seeder = next(iter(ds._seeder_cache.values()))
    st = dict(seeder.stats)
    _, walls["device_warm"], _ = map_once(True, paths["device_warm"])
    _, walls["host_warm"], _ = map_once(False, paths["host_warm"])
    reads = 2 * pairs
    log("path: map wall (reads/s): " + " | ".join(
        f"{n} {walls[n]:.3f}s ({reads / walls[n]:.0f})" for n in names)
        + "; the first device run includes the seeder build and index "
        "upload")
    fb = st["fallback_rows"] / st["rows"] if st["rows"] else 0.0
    log(f"path: device chunks {st['chunks']} of {-(-pairs // 16384)} "
        f"(over budget, mapped on host: {st['over_chunks']}); rows seeded "
        f"{st['rows']}, flagged FLAG_FALLBACK {st['fallback_rows']} "
        f"({100 * fb:.3f}%)")
    log(f"path: launches on the main path {json.dumps(launches)}")
    log(f"path: device memory held by the seeder {held / 2**20:.1f} MiB, "
        f"peak allocated {peak / 2**20:.1f} MiB")
    if "Using CUDA device seeding" not in logs["device"]:
        raise AssertionError("the device run did not seed on CUDA:\n"
                             + logs["device"][-3000:])
    outs = {}
    for n in names:
        with open(paths[n], "rb") as f:
            outs[n] = f.read()
    same = len(set(outs.values())) == 1
    log(f"path: BED bytes {len(outs['host'])} in all four runs: {same}, "
        f"lines={outs['host'].count(b'\n')}")
    if not same:
        raise AssertionError("a device BED differs from the host-only BED")
    if not outs["host"]:
        raise AssertionError("no mappings written")
    if st["chunks"] - st["over_chunks"] < 1:
        raise AssertionError("no chunk was seeded on the device")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    results["launches"] = launches


# ---------------------------------------------------------------------
# phase: hic
# ---------------------------------------------------------------------

def phase_hic(results: dict, pairs: int) -> None:
    import torch
    from chromap_tpu_torch.ops import dense_minimizer as dm
    from chromap_tpu_torch.ops import device_seed as ds
    from chromap_tpu_torch.ops import myers as my
    from chromap_tpu_torch.pipeline import MappingPipeline

    # runs in turns: host, device (the Hi-C path's run: launch counts
    # from 0 just before, read just after; it builds the split seeder),
    # device again with the seeder resident
    names = ("host", "device", "device_warm")
    paths = {n: os.path.join(DATA, f"hic_{n}.pairs") for n in names}
    walls, logs, mapper = {}, {}, {}
    # the wall inside _map_pairs_hybrid (device seeding, the native
    # finish, and the CPU chunks) against the rest of the records flow
    # (FASTQ records, one PairsRecord per mapping, low-memory spill and
    # merge, writing)
    hybrid = MappingPipeline._map_pairs_hybrid
    spent = [0.0]

    def timed(self, *a, **kw):
        t0 = time.time()
        try:
            return hybrid(self, *a, **kw)
        finally:
            spent[0] += time.time() - t0

    def run(name: str, use_device: bool) -> None:
        spent[0] = 0.0
        MappingPipeline._map_pairs_hybrid = timed
        try:
            _, walls[name], logs[name] = map_once(use_device, paths[name],
                                                  "hic", "hic_r")
        finally:
            MappingPipeline._map_pairs_hybrid = hybrid
        mapper[name] = spent[0]

    run("host", False)
    torch.cuda.reset_peak_memory_stats()
    wrappers = {"dense_minimizer": dm.dense_minimizer, "myers": my.myers,
                "cluster_scan": ds.cluster_scan,
                "myers_dropoff": my.myers_dropoff}
    for fn in wrappers.values():
        fn.launches = 0
    run("device", True)
    launches = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    seeder = next(iter(ds._seeder_cache.values()))
    st = dict(seeder.stats)
    run("device_warm", True)
    reads = 2 * pairs
    log("hic: map wall (reads/s): " + " | ".join(
        f"{n} {walls[n]:.3f}s ({reads / walls[n]:.0f})" for n in names)
        + "; the first device run includes the split seeder's build and "
        "index upload")
    log("hic: of which in _map_pairs_hybrid (seeding, native finish, CPU "
        "chunks): " + " | ".join(
            f"{n} {mapper[n]:.3f}s" for n in names)
        + "; the rest is the Python records flow")
    fb = st["fallback_rows"] / st["rows"] if st["rows"] else 0.0
    log(f"hic: seeder split={seeder.split} e={seeder.e}; device chunks "
        f"{st['chunks']} of {-(-pairs // 16384)} (over budget, mapped on "
        f"host: {st['over_chunks']}); rows seeded {st['rows']}, flagged "
        f"FLAG_FALLBACK {st['fallback_rows']} ({100 * fb:.3f}%)")
    log(f"hic: launches on the Hi-C path {json.dumps(launches)}")
    log(f"hic: peak device memory allocated {peak / 2**20:.1f} MiB")
    if "Using CUDA device seeding" not in logs["device"]:
        raise AssertionError("the Hi-C device run did not seed on CUDA:\n"
                             + logs["device"][-3000:])
    outs = {}
    for n in names:
        with open(paths[n], "rb") as f:
            outs[n] = f.read()
    same = len(set(outs.values())) == 1
    records = sum(1 for line in outs["host"].splitlines()
                  if not line.startswith(b"#"))
    log(f"hic: pairs bytes {len(outs['host'])} in all three runs: {same}, "
        f"records={records}")
    if not same:
        raise AssertionError("a device .pairs differs from the host-only one")
    if not outs["host"]:
        raise AssertionError("no pairs written")
    if st["chunks"] - st["over_chunks"] < 1:
        raise AssertionError("no Hi-C chunk was seeded on the device")
    for name in ("dense_minimizer", "cluster_scan", "myers_dropoff"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "Hi-C path")
    if not seeder.split or launches["myers"]:
        raise AssertionError("the Hi-C path did not seed in split mode")
    results["hic_launches"] = launches


# ---------------------------------------------------------------------
# phase: chunk
# ---------------------------------------------------------------------

def read_chunk(pairs: int, reads: str = "r"):
    import numpy as np
    tbl = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        tbl[c] = i
    rows = []
    with open(os.path.join(DATA, f"{reads}1.fq"), "rb") as f1, \
            open(os.path.join(DATA, f"{reads}2.fq"), "rb") as f2:
        for _ in range(pairs):
            for f in (f1, f2):
                f.readline()
                rows.append(tbl[np.frombuffer(f.readline().rstrip(),
                                              np.uint8)])
                f.readline()
                f.readline()
    return np.stack(rows)


def phase_chunk(results: dict) -> None:
    from chromap_tpu_torch.index.index import MinimizerIndex
    from chromap_tpu_torch.io.fastx import load_all_sequences

    index = MinimizerIndex.load(os.path.join(DATA, "index"))
    ref_seqs = [bytes(r.seq) for r in
                load_all_sequences(os.path.join(DATA, "ref.fa"))]
    # the BED path's chunk (e = 8), then the Hi-C path's in split mode
    # (e = 4, drop-off verification with the 5'-gap retry)
    chunk_once("chunk", index, ref_seqs, "r", 8, False)
    chunk_once("chunk hic", index, ref_seqs, "hic_r", 4, True)


def chunk_once(label: str, index, ref_seqs, reads: str, e: int,
               split: bool) -> None:
    import numpy as np
    import torch
    from chromap_tpu_torch.ops import device_seed as ds

    codes = read_chunk(16384, reads)
    B, L = codes.shape
    rw = ds._pack_reads(codes)
    outs = {}
    for dev in ("cuda", "cpu"):
        seeder = ds.DeviceSeeder(index, ref_seqs, e, 2, (500, 1000),
                                 device=dev, split=split)
        if dev == "cuda" and not split:
            tier = {torch.int32: "u32", torch.int64: "u64"}
            log(f"{label}: index tiers offcnt {tier[seeder.offcnt.dtype]}, "
                f"occurrences {tier[seeder.occurrences.dtype]} "
                f"({seeder.hash_keys.numel()} keys, "
                f"{seeder.occurrences.numel()} occurrences)")
        t0 = time.time()
        h = seeder.submit_packed(rw, B, L)
        r = seeder.resolve(h)
        dt = time.time() - t0
        (dl, full, _, _), _, _ = h
        outs[dev] = (dl.cpu().numpy().tobytes(),
                     full.cpu().numpy().tobytes(), r)
        if dev == "cuda":
            steps = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.time()
                seeder.resolve(seeder.submit_packed(rw, B, L))
                steps.append(time.time() - t0)
            step_s = statistics.median(steps)
            log(f"{label}: CUDA step (submit+resolve) {1e3 * step_s:.2f} ms "
                f"median of 5 ({B} rows, L={L}, e={e}, split={split}); "
                f"first call {1e3 * dt:.1f} ms")
            profile_step(seeder, rw, B, L, label)
            del seeder
            torch.cuda.empty_cache()
        else:
            log(f"{label}: CPU plain step {1e3 * dt:.1f} ms")
    same = outs["cuda"][:2] == outs["cpu"][:2]
    total = int(np.frombuffer(outs["cuda"][0][:4], np.uint32)[0])
    res = outs["cuda"][2]
    log(f"{label}: (dl, full) CUDA vs CPU plain byte-equal={same} "
        f"candidates={total} batch_over={res[3]}")
    if not same:
        raise AssertionError(f"{label}: CUDA chunk download differs from "
                             "the CPU plain path")
    if split:
        if res[3]:
            raise AssertionError(f"{label}: the chunk went over budget")
        # primary read_mapping_length: bits 17..24 of the split word
        rml0 = (res[2][1] >> np.uint64(17)) & np.uint64(0xFF)
        share = float(np.mean(rml0 < L)) if rml0.size else 0.0
        log(f"{label}: candidates whose primary drop-off pass stopped "
            f"early (rml < L): {int((rml0 < L).sum())} of {rml0.size} "
            f"({100 * share:.2f}%)")
        if share <= 0:
            raise AssertionError(f"{label}: no drop-off lane stopped early")


def profile_step(seeder, rw, B: int, L: int, label: str = "chunk") -> None:
    """Kernel time of one seeding step by kernel name (torch.profiler),
    and the device's busy share of the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        seeder.resolve(seeder.submit_packed(rw, B, L))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        log(f"{label} profile: no device time recorded")
        return
    rows.sort(reverse=True)
    tot = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    log(f"{label} profile: {tot:.3f} ms of kernels in {launches}"
        f" launches over a {wall_ms:.2f} ms step (device busy "
        f"{100 * tot / wall_ms:.1f}%, idle {100 - 100 * tot / wall_ms:.1f}%;"
        f" the profiler's own overhead included); top kernels:")
    # the top kernels, then the hand-written ones further down
    own = ("dense_minimizer_kernel", "myers_kernel", "myers_dropoff_kernel",
           "cluster_scan_kernel")
    for i, (us, n, key) in enumerate(rows):
        if i < 14 or any(k in key for k in own):
            log(f"  {us / 1e3:9.3f} ms  {100 * us / 1e3 / tot:5.1f}%  "
                f"x{n:<4d} {key[:100]}")


# ---------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,path,hic,chunk")
    ap.add_argument("--genome-core", type=int, default=96_000_000)
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas' whole report for all four kernels "
                    "(by default only its register and shared-memory "
                    "lines)")
    ap.add_argument("--make-data", action="store_true",
                    help=argparse.SUPPRESS)  # the data child process
    args = ap.parse_args()
    phases = args.phases.split(",")
    if args.make_data:
        sys.path.insert(0, ROOT)
        make_data(args.genome_core, args.pairs)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    try:
        from chromap_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: cannot import chromap_tpu_torch ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 2

    t_start = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    results: dict = {}
    ok = True
    # the data (simulation + the port's index build) is made by a child
    # process while this one builds and checks the kernels
    data = None
    if {"path", "hic", "chunk"} & set(phases):
        data = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--make-data",
             "--genome-core", str(args.genome_core),
             "--pairs", str(args.pairs)], cwd=ROOT, start_new_session=True)
    try:
        build_s = _build.build()
        log(f"kernel build: {build_s:.1f}s for {', '.join(_build.KERNELS)} "
            f"({' '.join(_build.NVCC_FLAGS)})")
        for name in _build.KERNELS:
            log(f"ptxas {name}:\n"
                + _build.ptxas_report(name, summary=not args.ptxas))
        if "kernels" in phases:
            phase_kernels(results)
    except Exception:
        traceback.print_exc()
        ok = False
    if data is not None:
        if not ok:
            import signal
            os.killpg(data.pid, signal.SIGKILL)   # with its index build
        if data.wait() != 0 and ok:
            log(f"chip_smoke: data generation failed (rc {data.returncode})")
            ok = False
    for name, fn in (("path", lambda: phase_path(results, args.genome_core,
                                                 args.pairs)),
                     ("hic", lambda: phase_hic(results, args.pairs)),
                     ("chunk", lambda: phase_chunk(results))):
        if ok and name in phases:
            try:
                fn()
            except Exception:
                traceback.print_exc()
                ok = False
    log(f"elapsed {time.time() - t_start:.1f}s")
    if not ok:
        log("chip_smoke: FAILED")
        return 1

    # launches: the drop-off kernel's from the Hi-C path's run, the
    # others' from the BED path's run
    launches = dict(results.get("launches", {}))
    launches["myers_dropoff"] = results.get("hic_launches", {}).get(
        "myers_dropoff", 0)
    kern = []
    for name, src in KERNEL_SOURCES:
        r = results.get(name, {})
        kern.append({"name": name, "route": "cuda",
                     "source": f"chromap_tpu_torch/csrc/{src}",
                     "replaces": REPLACES[name],
                     "launches": launches.get(name, 0),
                     "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"), "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
