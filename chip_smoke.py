#!/usr/bin/env python3
"""Smoke run of chromap_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order (any failure exits non-zero before the last line):

  kernels  builds the five CUDA kernels of csrc/ (one nvcc each, all at
           once), launches each on CUDA tensors at its path's shapes
           (seeded numpy inputs) and holds it against its plain torch
           version on the same tensors: exact equality, since every output
           is an integer. Times both with CUDA events (median of >= 10
           launches after warm-up). The drop-off kernel runs at the Hi-C
           path's two shapes (L = 100, e = 4, and the 5'-gap retry's
           L = 84), with planted junctions so that lanes stop early, and
           once more with texts equal to the patterns' diagonal, so that
           no lane stops. Kernel E (the index probe) runs on 31.8M
           uniform keys, a 141 Mb genome's index, and a chunk's 851,968
           queries, beside torch searchsorted as the library yardstick.
           For every kernel it also prints what bounds it: ptxas'
           registers and shared memory, resident blocks per
           SM, the achieved GB/s, and a cold time (a 128 MiB write
           between launches evicts the 50 MB L2).
  path     the paired-end --device BED flow at realistic scale: simulates a
           ~141 Mb one-chromosome genome and 100,000 pairs, builds the
           index with the port's CLI (-i), and maps in-process four times
           in turns -- host-only (cache off), CUDA device seeding (the
           main path's run, whose kernel launches are counted), device
           again with the seeder resident, host again. All four BED files
           must be byte-equal, at least one chunk must be seeded on the
           device, and every kernel must launch in the main path's run:
           kernel E once a chunk seeded, which the traced run's counter
           seeder.probe_kernel must also count, as many as chunks.dev.
  hic      the Hi-C flow (--preset hic: e = 4, MAPQ 1, split alignment,
           pairs output, low-memory mode) on the same genome and index.
           hic_r1.fq / hic_r2.fq are the path's pairs with bases 60-99 of
           every fourth read 1 replaced by 40 bases from a seeded random
           place of the genome (ligation-junction reads, so the drop-off
           kernel's early stop and the 5'-gap retry fire). Maps in turns
           host-only, CUDA device seeding (the Hi-C path's run, launches
           counted from 0), device again with the seeder resident. The
           three .pairs files must be byte-equal and non-empty, a chunk
           must be seeded on the device, the minimizer, cluster and
           drop-off kernels must each launch, and kernel E once a chunk,
           as the path phase checks it.
  batch    the batch engine (--engine batch) on the path's genome and
           index with the first 20,000 pairs (batch_r1.fq, batch_r2.fq),
           in turns: host, --device (kernel B's launches counted from 0),
           --device again, the native engine. The device BEDs must equal
           the host batch BED and kernel B must launch; whether the batch
           BED equals the native one is printed. Prints each run's wall
           and time split, the candidates sent to kernel B and to numpy,
           kernel B at the largest launch's shape against its plain
           version, the upload of its host rows; then the native engine's
           map_pairs_device on 16,384 pairs on CUDA against its numpy
           form (equal arrays and stats).
  flows    the single-device flows that tests/golden/ pins, in-process
           through the port's CLI with --device --torch-device cuda
           --device-batch-size 512 on tests/simulate.py's sets: presets,
           PAF, SAM, barcodes with summary, --chr-order, single-end,
           --read-format, the batch engine's four goldens, --num-shards
           then --merge-shards, and cache-active data against a host
           --no-cache run; then the reference chromap's BED and pairs
           goldens on tests/data/ with a device batch of two pairs. Each
           output must equal its golden; each seeder flow must seed a
           chunk on the card, each batch flow launch kernel B.
  chunk    one 16384-pair chunk of the path's data, and one of the Hi-C
           reads in split mode, seeded by the port on CUDA (kernel E's
           probe) and by its plain path on the CPU (the merged sort):
           both downloads must be byte-equal. Times and profiles the CUDA
           step, and times the probe alone on the 141 Mb index: kernel E
           must equal the merged sort, searchsorted its yardstick.
  mesh     the data mesh (parallel/sharding.py, MeshSeeder) rehearsed as
           shards of the one card: sharded_myers over [cuda:0, cuda:0] at
           N = 65536 equal to kernel B's plain version; the chunk phase's
           BED and split chunks through MeshSeeder over 2 and 4 shards of
           cuda:0 (and over every card when there are two or more), each
           resolved chunk equal to DeviceSeeder's, no shard over budget,
           timed and profiled against the single seeder; and the path's
           100k BED pairs through MappingPipeline with a 2-shard
           MeshSeeder, byte-equal to the host-only BED with every chunk
           sharded and each kernel launched once per shard per chunk.
  tools    the port's bench and measurement tools, each run as `python -m
           chromap_tpu_torch.<module>` in a subprocess from the repository
           root on the card (any nonzero exit fails the phase), every line
           they print relayed with a `tools <name>|` prefix: the bench at
           its defaults (data under _smoke/bench/) and on the path's 141 Mb
           set, whose scored value must be the card's rate with
           byte-equal BED files; stage_profile on the path's set in BED
           mode and in split mode on the Hi-C reads, each stop's
           hand-written kernel launches checked against its stages, the
           full step's kernel time within 10% of the chunk phase's
           profile and the probe stop within 20% of kernel E alone;
           full_time with the probe and cluster stops on the bench's set;
           primitives at the 141 Mb index's key count; bench_parity on
           the bench's 100k pairs (byte-equal BED files); weak_scaling at
           1, 2 and 4 shards of the card on the 141 Mb set, one launch of
           A, B and C per shard per call.

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

REPLACES = {
    "dense_minimizer": "chromap_tpu/ops/pallas_dense.py:157",
    "myers": "chromap_tpu/ops/pallas_myers.py:39",
    "cluster_scan": "chromap_tpu/ops/device_seed.py:227",
    "myers_dropoff": "chromap_tpu/ops/pallas_myers.py:222",
    # no Pallas kernel: the JAX program's merged-sort probe
    "index_probe": "chromap_tpu/ops/device_seed.py:387",
}
KERNEL_SOURCES = (("dense_minimizer", "dense_minimizer.cu"),
                  ("myers", "myers.cu"),
                  ("cluster_scan", "cluster_scan.cu"),
                  ("myers_dropoff", "myers_dropoff.cu"),
                  ("index_probe", "index_probe.cu"))


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return -1
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max().item()) if d.numel() else 0)
    return err


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


def kernel_inputs_probe(k: int, nk: int = 31_800_000):
    """Kernel E's operands at the main path's shape, on the card: nk
    sorted distinct uniform 2k-bit keys (a 141 Mb genome's index holds
    31.8M), u64 offcnt words, its bucket table, and a chunk's 851,968
    queries, 60% of them keys and 3% invalid (UMAX64)."""
    import numpy as np
    import torch
    from chromap_tpu_torch.ops import device_seed as ds
    g = torch.Generator(device="cuda").manual_seed(13)
    keys = torch.unique(torch.randint(0, 1 << (2 * k), (nk + nk // 50,),
                                      device="cuda", generator=g))[:nk]
    offcnt = torch.randint(0, 1 << 62, (nk,), device="cuda", generator=g)
    table = torch.from_numpy(ds.index_probe_table(
        keys.cpu().numpy().view(np.uint64), k)).to("cuda")
    M = ds.MZ_PER_READ * 32768
    q = torch.randint(0, 1 << (2 * k), (M,), device="cuda", generator=g)
    pick = torch.rand(M, device="cuda", generator=g)
    q = torch.where(pick < 0.6, keys[torch.randint(
        0, nk, (M,), device="cuda", generator=g)], q)
    return keys, offcnt, torch.where(pick < 0.97, q, -1), table


def probe_cost(q, offcnt):
    """Kernel E's bytes: each query read and its off, cnt and found
    written (21 B), and for each valid query its two bucket bounds, one
    key and one offcnt word; no arithmetic to speak of."""
    valid = int((q != -1).sum())
    return (21 * q.numel() + valid * (16 + offcnt.element_size()), 0)


def check_kernel(label: str, wrapper, kernel, plain, cost, note) -> dict:
    """Launch a kernel and its plain version on the same CUDA tensors,
    require equal outputs, time both, and log one line. `wrapper` holds
    the launch count; `cost` is (bytes, ops); `note(outputs)` adds a
    word about the data."""
    import torch
    from chromap_tpu_torch.bench import bound, time_ms
    n0 = wrapper.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    equal = all(torch.equal(g, x) for g, x in zip(got, want))
    err = max_abs_err(got, want)
    ms, plain_ms = time_ms(kernel), time_ms(plain)
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
    from chromap_tpu_torch.bench import bound, time_ms
    from chromap_tpu_torch.ops import _build
    blocks, threads, smem, tile = _build.occupancy(name, L)
    unit = {"dense_minimizer": "reads a tile",
            "index_probe": "(no tile)"}.get(name, "ring stages")
    cold_ms = time_ms(fn, between=flush.zero_)
    t_bytes = bound(r["nbytes"])[0]
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
    from chromap_tpu_torch.bench import myers_cost, time_ms
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

    # kernel E at the main path's shape: a 141 Mb genome's index (31.8M
    # uniform keys, k = 17, u64 offcnt) and a chunk's 851,968 queries;
    # its plain version is the merged sort, the library yardstick
    # searchsorted and gather
    keys, offcnt, q, table = kernel_inputs_probe(17)
    results["index_probe"] = check_kernel(
        f"kernel E index_probe M={q.numel()} NK={keys.numel()}",
        ds.index_probe, lambda: ds.index_probe(keys, offcnt, q, table, 17),
        lambda: ds.index_probe_plain(keys, offcnt, q, 17),
        probe_cost(q, offcnt), lambda o: f"found={int(o[2].sum())}")
    kernel_detail("kernel E", "index_probe", L, results["index_probe"],
                  lambda: ds.index_probe(keys, offcnt, q, table, 17), flush)
    valid = q != -1
    results["index_probe"]["library_ms"] = time_ms(
        lambda: ds._probe_gather(offcnt, *ds._probe_searchsorted(
            keys, q, valid)))
    log(f"kernel E yardstick: torch searchsorted and gather "
        f"{results['index_probe']['library_ms']:.4f} ms; the merged sort "
        f"(E's plain version) {results['index_probe']['plain_ms']:.4f} ms")
    del keys, offcnt, q, table
    torch.cuda.empty_cache()

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
        for name in ("hic_r1.fq", "hic_r2.fq", "batch_r1.fq",
                     "batch_r2.fq"):                # made from the old reads
            if os.path.exists(os.path.join(DATA, name)):
                os.remove(os.path.join(DATA, name))
        make_path_data(genome_core, pairs, marker)
    make_hic_reads()
    make_batch_reads()
    make_flows_data()


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


BATCH_PAIRS = 20_000  # the batch engine maps in Python around numpy


def make_batch_reads() -> None:
    """batch_r1.fq / batch_r2.fq: the first BATCH_PAIRS pairs of the
    path's reads (the batch engine's phase: the full index, fewer
    reads)."""
    for i in (1, 2):
        out = os.path.join(DATA, f"batch_r{i}.fq")
        if os.path.exists(out):
            continue
        with open(os.path.join(DATA, f"r{i}.fq"), "rb") as f:
            lines = f.read().split(b"\n")[:4 * BATCH_PAIRS]
        with open(out + ".tmp", "wb") as f:
            f.write(b"\n".join(lines) + b"\n")
        os.replace(out + ".tmp", out)


FLOWS = os.path.join(DATA, "flows")        # tests/simulate.py's 5000 pairs
FLOWS_MC = os.path.join(DATA, "flows_mc")  # and its multi-chromosome set
DUP = os.path.join(DATA, "flows_dup")      # 200 pairs repeated 30 times
# the bundled reads of tests/data/ (10 pairs, written by the reference
# chromap's test suite), linked in as r1.fq / r2.fq / ref.fa
FLOWS_REF = os.path.join(DATA, "flows_ref")


def make_flows_data() -> None:
    """The simulated sets that tests/golden/ pins (5000 pairs with
    barcodes; the multi-chromosome set) and tests/data/, each indexed by
    the port's CLI, and a duplicate-heavy set that activates the
    candidate cache."""
    marker = os.path.join(FLOWS, "ready")
    if os.path.exists(marker):
        return
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from simulate import (write_simulated_barcodes, write_simulated_dataset,
                          write_simulated_multichrom_dataset)
    write_simulated_dataset(FLOWS)
    write_simulated_barcodes(FLOWS)
    write_simulated_multichrom_dataset(FLOWS_MC)
    os.makedirs(FLOWS_REF, exist_ok=True)
    for src, name in (("ref.fa", "ref.fa"), ("read1.fq", "r1.fq"),
                      ("read2.fq", "r2.fq")):
        if not os.path.exists(os.path.join(FLOWS_REF, name)):
            os.symlink(os.path.join(ROOT, "tests", "data", src),
                       os.path.join(FLOWS_REF, name))
    for d in (FLOWS, FLOWS_MC, FLOWS_REF):
        subprocess.run(
            [sys.executable, "-m", "chromap_tpu_torch.cli", "-i",
             "-r", os.path.join(d, "ref.fa"), "-o", os.path.join(d, "index")],
            cwd=ROOT, check=True, capture_output=True)
    os.makedirs(DUP, exist_ok=True)
    for i in (1, 2):
        with open(os.path.join(FLOWS, f"r{i}.fq")) as f:
            lines = f.read().splitlines()
        recs = [lines[j:j + 4] for j in range(0, 800, 4)]
        with open(os.path.join(DUP, f"r{i}.fq"), "w") as f:
            for n in range(30 * len(recs)):
                r = recs[n % len(recs)]
                f.write(f"@dup{n}\n{r[1]}\n+\n{r[3]}\n")
    for name in ("index", "ref.fa"):
        if not os.path.exists(os.path.join(DUP, name)):
            os.symlink(os.path.join(FLOWS, name), os.path.join(DUP, name))
    with open(marker, "w") as f:
        f.write("ok")


def map_once(use_device: bool, out: str, preset: str | None = None,
             reads: str = "r", engine: str = "auto"):
    """One in-process mapping run of `reads`1.fq / `reads`2.fq. Without a
    preset: BED with `-l 2000`; with one: the CLI's `--preset` defaults.
    The candidate cache is off in every run (--device turns it off).
    Returns (init s, map s, the run's log, the pipeline)."""
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
        device_batch_size=16384, num_threads=os.cpu_count() or 1,
        engine=engine)
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
    return t1 - t0, t2 - t1, err.getvalue(), pipe


def traced_counters(run, walls, logs, name) -> dict:
    """Run one mapping `run()` with the tracer on; its (wall, log) go to
    walls[name], logs[name]. Returns the pass's counters."""
    from chromap_tpu_torch import tracing
    os.environ[tracing.SWITCH] = "1"
    try:
        _, walls[name], logs[name], _ = run()
    finally:
        os.environ.pop(tracing.SWITCH, None)
    return tracing.last_pass()["counters"]


def check_probe_kernel(label: str, launches: dict, st: dict,
                       counters: dict) -> None:
    """Kernel E launched once for each chunk the seeder ran, and the
    tracer counted each such chunk in seeder.probe_kernel, as many as
    chunks.dev."""
    log(f"{label}: kernel E launches {launches['index_probe']}, chunks "
        f"seeded {st['chunks']}; counters seeder.probe_kernel "
        f"{counters.get('seeder.probe_kernel')}, chunks.dev "
        f"{counters.get('chunks.dev')}")
    if not (launches["index_probe"] == st["chunks"]
            == counters.get("seeder.probe_kernel")
            == counters.get("chunks.dev")):
        raise AssertionError(f"{label}: kernel E did not probe every "
                             "device chunk once")


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
    _, walls["host"], _, _ = map_once(False, paths["host"])
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    for fn in (dm.dense_minimizer, my.myers, ds.cluster_scan,
               ds.index_probe):
        fn.launches = 0
    counters = traced_counters(
        lambda: map_once(True, paths["device"]), walls, logs, "device")
    launches = {"dense_minimizer": dm.dense_minimizer.launches,
                "myers": my.myers.launches,
                "cluster_scan": ds.cluster_scan.launches,
                "index_probe": ds.index_probe.launches}
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated() - mem0
    seeder = next(iter(ds._seeder_cache.values()))
    st = dict(seeder.stats)
    check_probe_kernel("path", launches, st, counters)
    _, walls["device_warm"], _, _ = map_once(True, paths["device_warm"])
    _, walls["host_warm"], _, _ = map_once(False, paths["host_warm"])
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
    from chromap_tpu_torch.ops import device_seed as ds
    from chromap_tpu_torch.pipeline import MappingPipeline
    from chromap_tpu_torch.tools.stage_profile import kernel_wrappers

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

    def run(name: str, use_device: bool) -> dict:
        spent[0] = 0.0
        MappingPipeline._map_pairs_hybrid = timed
        try:
            counters = traced_counters(
                lambda: map_once(use_device, paths[name], "hic", "hic_r"),
                walls, logs, name)
        finally:
            MappingPipeline._map_pairs_hybrid = hybrid
        mapper[name] = spent[0]
        return counters

    run("host", False)
    torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    counters = run("device", True)
    launches = {n: fn.launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    seeder = next(iter(ds._seeder_cache.values()))
    st = dict(seeder.stats)
    check_probe_kernel("hic", launches, st, counters)
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
# phase: batch
# ---------------------------------------------------------------------

def host_median(fn, reps: int = 5) -> float:
    """Median seconds of fn() by the host clock, each call ended by a
    synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return statistics.median(times)


def phase_batch(results: dict) -> None:
    import numpy as np
    import torch
    from chromap_tpu_torch.batch import verify as bv
    from chromap_tpu_torch.bench import myers_cost
    from chromap_tpu_torch.ops import myers as my

    # runs in turns, all -l 2000 with the cache off: host --engine batch,
    # --engine batch --device (kernel B's launches counted from 0 just
    # before, read just after), the same again, the native engine
    names = ("host", "device", "device_warm", "native")
    paths = {n: os.path.join(DATA, f"batch_{n}.bed") for n in names}
    walls, logs, calls, split = {}, {}, {}, {}
    largest = {}
    wrapped = my.banded_distance_batch

    def keep_largest(p, t, e, device="cuda"):
        if len(p) > len(largest.get("p", ())):
            largest.update(p=p, t=t, e=e)
        return wrapped(p, t, e, device=device)

    for n in names:
        bv.myers_batch.calls = {"device": [], "numpy": []}
        if n == "device":
            my.myers.launches = 0
            my.banded_distance_batch = keep_largest
        try:
            _, walls[n], logs[n], pipe = map_once(
                n.startswith("device"), paths[n], reads="batch_r",
                engine="auto" if n == "native" else "batch")
        finally:
            my.banded_distance_batch = wrapped
        if n == "device":
            launches = my.myers.launches
        calls[n] = bv.myers_batch.calls
        if pipe.batch_mapper is not None:
            split[n] = dict(pipe.batch_mapper.seconds)
    native_pipe = pipe
    reads = 2 * BATCH_PAIRS
    log("batch: map wall (reads/s): " + " | ".join(
        f"{n} {walls[n]:.3f}s ({reads / walls[n]:.0f})" for n in names)
        + "; host/device/device_warm are --engine batch, native is the "
        "native host engine")
    for n in names[:3]:
        c, sp = calls[n], split[n]
        rest = sp["total"] - sp["seed"] - sp["gather"] - sp["myers"]
        log(f"batch {n}: candidates to kernel B {sum(c['device'])} in "
            f"{len(c['device'])} launches (N {c['device']}), to numpy "
            f"{sum(c['numpy'])} in {len(c['numpy'])} calls; time split "
            + ", ".join(f"{k} {v:.3f}s" for k, v in sp.items())
            + f"; the rest of total {rest:.3f}s (classification, replay, "
            "selection, traceback, emission)")
    log(f"batch: launches of kernel B in the device run {launches}")
    if "Using CUDA Myers verification (batch engine)" not in logs["device"]:
        raise AssertionError("the batch device run did not verify on "
                             "CUDA:\n" + logs["device"][-3000:])
    outs = {}
    for n in names:
        with open(paths[n], "rb") as f:
            outs[n] = f.read()
    same = outs["device"] == outs["host"] == outs["device_warm"]
    log(f"batch: BED bytes {len(outs['host'])}, lines "
        f"{outs['host'].count(b'\n')}; device runs equal the host batch "
        f"run: {same}")
    if not same:
        raise AssertionError("a batch-engine device BED differs from the "
                             "host batch BED")
    if not outs["host"]:
        raise AssertionError("the batch engine wrote no mappings")
    if launches <= 0:
        raise AssertionError("kernel myers never launched in the batch "
                             "engine's device run")
    if outs["native"] == outs["host"]:
        log("batch: the batch engine's BED equals the native engine's")
    else:
        a, b = outs["host"].splitlines(), outs["native"].splitlines()
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        log(f"batch: the batch engine's BED differs from the native "
            f"engine's ({len(a)} against {len(b)} lines); first at line "
            f"{i + 1}: batch {a[i] if i < len(a) else b'<end>'!r} native "
            f"{b[i] if i < len(b) else b'<end>'!r}")
    results["batch_launches"] = launches

    # kernel B at the batch engine's largest launch, and what its host
    # rows cost on the way to the card
    p, t, e = largest["p"], largest["t"], largest["e"]
    N, L = t.shape
    up_u8 = host_median(lambda: (torch.from_numpy(p).cuda(),
                                 torch.from_numpy(t).cuda()))
    up_i32 = host_median(lambda: (
        torch.from_numpy(np.ascontiguousarray(p.T, dtype=np.int32)).cuda(),
        torch.from_numpy(np.ascontiguousarray(t.T, dtype=np.int32)).cuda()))
    call = host_median(lambda: my.banded_distance_batch(p, t, e))
    log(f"batch: kernel B's largest launch N={N} L={L} e={e}: uint8 rows "
        f"to the card {1e3 * up_u8:.3f} ms ({(p.nbytes + t.nbytes) / 1e6:.1f}"
        f" MB), int32 planes widened and transposed on the host "
        f"{1e3 * up_i32:.3f} ms ({4 * (p.nbytes + t.nbytes) / 1e6:.1f} MB); "
        f"the whole banded_distance_batch call {1e3 * call:.3f} ms (host "
        "clock, median of 5)")
    pt = torch.from_numpy(np.ascontiguousarray(p.T, dtype=np.int32)).cuda()
    tt = torch.from_numpy(np.ascontiguousarray(t.T, dtype=np.int32)).cuda()
    results["myers_batch_shape"] = check_kernel(
        f"kernel B myers at the batch engine's shape N={N} L={L} e={e}",
        my.myers, lambda: my.myers(pt, tt, e, L),
        lambda: my.myers_plain(pt, tt, e, L), myers_cost(L, N, e),
        lambda o: f"within_e={int((o[0] <= e).sum())}")
    results["myers_batch_shape"].update(N=N, up_u8_ms=1e3 * up_u8,
                                        call_ms=1e3 * call)

    # the native engine's device entry: C++ collects the work, kernel B
    # verifies it, C++ finishes; equal to the numpy form. Each call takes
    # a fresh engine: an engine's random stream carries over between
    # calls.
    from chromap_tpu_torch.native import NativeEngine, _ptr
    from chromap_tpu_torch.utils import encode_sequence
    raw = []
    for i in (1, 2):
        with open(os.path.join(DATA, f"batch_r{i}.fq"), "rb") as f:
            seqs = f.read().split(b"\n")[1::4][:16384]
        chunk = len(seqs)
        off = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in seqs], out=off[1:])
        raw += [b"".join(seqs), off]
    ref_codes = np.concatenate([encode_sequence(x)
                                for x in native_pipe.ref_seqs])
    got = {}
    for dev in ("cuda", None):
        engine = NativeEngine(native_pipe.cfg, native_pipe.index,
                              native_pipe.ref_seqs)
        engine.set_cache_off()
        n0 = my.myers.launches
        t0 = time.time()
        got[dev] = engine.map_pairs_device(
            raw[0], _ptr(raw[1]), raw[2], _ptr(raw[3]), chunk, 0, 0,
            ref_codes, device=dev)
        torch.cuda.synchronize()
        log(f"batch: map_pairs_device({chunk} pairs, device={dev!r}) "
            f"{time.time() - t0:.3f}s, kernel B launches "
            f"{my.myers.launches - n0}, records {len(got[dev][0]['rid'])}")
    (a, sa), (b, sb) = got["cuda"], got[None]
    same = (np.array_equal(sa, sb) and a.keys() == b.keys()
            and all(np.array_equal(a[k], b[k]) for k in a))
    log(f"batch: map_pairs_device on CUDA equals the numpy form: {same}")
    if not same or not len(a["rid"]):
        raise AssertionError("map_pairs_device on CUDA differs from its "
                             "numpy form")


# ---------------------------------------------------------------------
# phase: flows
# ---------------------------------------------------------------------

GOLDEN = os.path.join(ROOT, "tests", "golden")
BARCODES = ["-b", "{d}/bc.fq", "--barcode-whitelist", "{d}/whitelist.txt"]
# (golden, data, paired, arguments, engine): the single-device flows that
# tests/test_torch_device_flows.py and tests/test_torch_batch.py pin on
# the CPU
FLOW_CASES = [
    ("sim_atac.bed", FLOWS, True, ["--preset", "atac"], "seeder"),
    ("sim_chip.bed", FLOWS, True,
     ["-l", "2000", "--remove-pcr-duplicates", "--low-mem"], "seeder"),
    ("sim_trim.paf", FLOWS, True, ["--trim-adapters", "--PAF"], "seeder"),
    ("sim_pe.sam", FLOWS, True, ["--SAM"], "seeder"),
    ("sim_barcode.bed", FLOWS, True,
     BARCODES + ["--remove-pcr-duplicates", "--Tn5-shift", "-l", "2000",
                 "--summary", "{out}.csv"], "seeder"),
    ("sim_chrorder.bed", FLOWS_MC, True,
     ["--chr-order", "{d}/chr_order.txt"], "seeder"),
    ("sim_se_barcode.bed", FLOWS, False,
     BARCODES + ["--remove-pcr-duplicates"], "seeder"),
    ("sim_se_bc.sam", FLOWS, False, BARCODES + ["--SAM"], "seeder"),
    ("sim_readformat.bed", FLOWS, True,
     ["-b", "{d}/bc.fq", "--read-format", "r1:5:84,r2:0:79,bc:0:7"],
     "seeder"),
    ("sim_default.bed", FLOWS, True, ["--engine", "batch"], "batch"),
    ("sim_chip.bed", FLOWS, True,
     ["--engine", "batch", "-l", "2000", "--remove-pcr-duplicates"],
     "batch"),
    ("sim_n3.bed", FLOWS, True, ["--engine", "batch", "-n", "3", "-q", "0"],
     "batch"),
    ("sim_alloc.bed", FLOWS, True,
     ["--engine", "batch", "--allocate-multi-mappings", "-q", "0"], "batch"),
]
FLOW_DEVICE = ["--device", "--torch-device", "cuda",
               "--device-batch-size", "512"]
# (golden, paired, arguments): the reference chromap's BED and pairs
# goldens on tests/data/ (tests/test_parity.py's cases), mapped with a
# device batch of two pairs so that the 10-pair set reaches the seeder
REF_CASES = [
    ("se.bed", False, []),
    ("pe.bed", True, []),
    ("atac-equiv.bed", True, ["-l", "2000", "--trim-adapters",
                              "--remove-pcr-duplicates", "--Tn5-shift",
                              "--BED"]),
    ("chip-equiv.bed", True, ["-l", "2000", "--remove-pcr-duplicates",
                              "--BED"]),
    ("hic.pairs", True, ["-e", "4", "-q", "1", "--split-alignment",
                         "--pairs"]),
]
REF_DEVICE = ["--device", "--torch-device", "cuda", "--device-batch-size",
              "2"]


def cli_run(argv) -> str:
    """The port's CLI in this process; returns its log."""
    import contextlib
    import io

    from chromap_tpu_torch import cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.parse_args_and_run(argv)
    if rc != 0:
        raise RuntimeError(f"CLI {argv} returned {rc}:\n"
                           + err.getvalue()[-3000:])
    return err.getvalue()


def flow_run(d: str, out: str, extra, paired: bool = True):
    """One device flow; returns (its log, chunks the device seeded that
    came back within budget, kernel B launches, wall s)."""
    from chromap_tpu_torch.ops import device_seed as ds
    from chromap_tpu_torch.ops import myers as my

    def seeded():
        return {id(s): s.stats["chunks"] - s.stats["over_chunks"]
                for s in ds._seeder_cache.values()}

    argv = ["-x", f"{d}/index", "-r", f"{d}/ref.fa", "-1", f"{d}/r1.fq"]
    if paired:
        argv += ["-2", f"{d}/r2.fq"]
    argv += ["-o", out] + [a.format(d=d, out=out) for a in extra]
    before, n0, t0 = seeded(), my.myers.launches, time.time()
    text = cli_run(argv)
    wall = time.time() - t0
    chunks = sum(v - before.get(k, 0) for k, v in seeded().items())
    return text, chunks, my.myers.launches - n0, wall


def phase_flows(results: dict) -> None:
    bad = []
    launches = 0
    t_phase = time.time()

    def check(name, ok, note, on_card=True, what="the golden"):
        log(f"flows {name}: {note} equal to {what}: {ok}")
        if not (ok and on_card):
            bad.append(name)

    def golden(name):
        with open(os.path.join(GOLDEN, name), "rb") as f:
            return f.read()

    for name, d, paired, extra, kind in FLOW_CASES:
        out = os.path.join(DATA, f"flow_{kind}_{name}")
        text, chunks, n_b, wall = flow_run(d, out, extra + FLOW_DEVICE,
                                           paired)
        launches += n_b
        with open(out, "rb") as f:
            ok = f.read() == golden(name)
        if name == "sim_barcode.bed":
            with open(out + ".csv") as f:
                ours = sorted(f.read().splitlines())
            want = sorted(golden("sim_barcode_summary.csv").decode()
                          .splitlines())
            ok = ok and ours == want
        if kind == "seeder":
            on_card = chunks >= 1 and "Using CUDA device seeding" in text
        else:
            on_card = n_b >= 1 and "Using CUDA Myers verification" in text
        check(f"{kind} {name}", ok, f"{wall:.2f}s, device chunks {chunks}, "
              f"kernel B launches {n_b}, on the card {on_card};", on_card)

    for name, paired, extra in REF_CASES:
        out = os.path.join(DATA, f"flow_ref_{name}")
        text, chunks, _, wall = flow_run(FLOWS_REF, out, extra + REF_DEVICE,
                                         paired)
        with open(out, "rb") as f:
            ok = f.read() == golden(name)
        on_card = chunks >= 1 and "Using CUDA device seeding" in text
        check(f"tests/data {name}", ok, f"{wall:.2f}s, device chunks "
              f"{chunks}, on the card {on_card};", on_card,
              "the reference chromap's golden")

    # --num-shards 2 on the device, then --merge-shards
    out = os.path.join(DATA, "flow_sharded.bed")
    chunks = 0
    for i in range(2):
        _, c, _, _ = flow_run(FLOWS, out, ["--num-shards", "2",
                                           "--shard-index", str(i)]
                              + FLOW_DEVICE)
        chunks += c
    cli_run(["-x", f"{FLOWS}/index", "-r", f"{FLOWS}/ref.fa", "-o", out,
             "--merge-shards", f"{out}.shard0.temp0,{out}.shard1.temp0"])
    with open(out, "rb") as f:
        ok = f.read() == golden("sim_default.bed")
    check("sharded sim_default.bed", ok, f"device chunks {chunks};",
          chunks >= 1)

    # cache-active data: --device (cache off) equals host --no-cache
    outs = {}
    for tag, extra in (("host", ["--no-cache"]), ("device", FLOW_DEVICE)):
        out = os.path.join(DATA, f"flow_cache_{tag}.bed")
        _, c, _, _ = flow_run(DUP, out, ["--read-batch-size", "1000"]
                              + extra)
        with open(out, "rb") as f:
            outs[tag] = f.read()
    check("cache-active (device vs host --no-cache)",
          outs["device"] == outs["host"] and bool(outs["host"]),
          f"device chunks {c};", c >= 1, "the host run")
    log(f"flows: {len(FLOW_CASES) + len(REF_CASES) + 2} flows in "
        f"{time.time() - t_phase:.1f}s, kernel B launches {launches}")
    if bad:
        raise AssertionError(f"flows that failed: {bad}")


# ---------------------------------------------------------------------
# phase: chunk
# ---------------------------------------------------------------------

def read_chunk(pairs: int, reads: str = "r"):
    """(2 * pairs, L) u8 codes of the first pairs of `<reads>1/2.fq`,
    read 1 then read 2 of each pair (tools/stage_profile.py's reader)."""
    from chromap_tpu_torch.tools.stage_profile import read_chunk as rc
    return rc(DATA, 2 * pairs, reads)[0]


def phase_chunk(results: dict) -> None:
    from chromap_tpu_torch.index.index import MinimizerIndex
    from chromap_tpu_torch.io.fastx import load_all_sequences

    index = MinimizerIndex.load(os.path.join(DATA, "index"))
    ref_seqs = [bytes(r.seq) for r in
                load_all_sequences(os.path.join(DATA, "ref.fa"))]
    # the BED path's chunk (e = 8), then the Hi-C path's in split mode
    # (e = 4, drop-off verification with the 5'-gap retry)
    results["chunk"] = chunk_once("chunk", index, ref_seqs, "r", 8, False)
    chunk_once("chunk hic", index, ref_seqs, "hic_r", 4, True)


def chunk_once(label: str, index, ref_seqs, reads: str, e: int,
               split: bool) -> dict:
    """One 16384-pair chunk through the step on CUDA (kernel E) and on
    the CPU (the merged sort): both downloads must be byte-equal, and the
    CUDA step must launch kernel E once. Returns the CUDA step's kernel
    ms under the profiler, and the probes alone."""
    import numpy as np
    import torch
    from chromap_tpu_torch.ops import device_seed as ds

    codes = read_chunk(16384, reads)
    B, L = codes.shape
    rw = ds._pack_reads(codes)
    outs, steps, kept = {}, {}, {}
    probe = "default"
    for dev in ("cuda", "cpu"):
        seeder = ds.DeviceSeeder(index, ref_seqs, e, 2, (500, 1000),
                                 device=dev, split=split)
        t0 = time.time()
        n0 = ds.index_probe.launches
        h = seeder.submit_packed(rw, B, L)
        r = seeder.resolve(h)
        dt = time.time() - t0
        e_launches = ds.index_probe.launches - n0
        if e_launches != int(dev == "cuda"):
            raise AssertionError(f"{label} {dev}: kernel E launched "
                                 f"{e_launches} times")
        (dl, full, _, _), _, _ = h
        outs[probe, dev] = (dl.cpu().numpy().tobytes(),
                            full.cpu().numpy().tobytes(), r)
        if dev == "cpu":
            log(f"{label} {probe}: CPU plain step {1e3 * dt:.1f} ms")
            continue
        e_table = seeder.probe_table
        nb = e_table.numel() - 1
        log(f"{label}: kernel E's table tbits={nb.bit_length() - 1}, "
            f"{e_table.numel() * 4 / 2**20:.1f} MiB, "
            f"{seeder.hash_keys.numel() / nb:.2f} keys a bucket")
        if not split:
            tier = {torch.int32: "u32", torch.int64: "u64"}
            log(f"{label}: index tiers offcnt "
                f"{tier[seeder.offcnt.dtype]}, occurrences "
                f"{tier[seeder.occurrences.dtype]} "
                f"({seeder.hash_keys.numel()} keys, "
                f"{seeder.occurrences.numel()} occurrences)")
        step_s = host_median(
            lambda: seeder.resolve(seeder.submit_packed(rw, B, L)))
        steps[probe] = 1e3 * step_s
        log(f"{label} {probe}: CUDA step (submit+resolve) "
            f"{1e3 * step_s:.2f} ms median of 5 ({B} rows, L={L}, "
            f"e={e}, split={split}); first call {1e3 * dt:.1f} ms")
        kept[probe] = profile_step(seeder, rw, B, L, f"{label} {probe}")
        if not split:
            kept["probe_alone_ms"] = time_probes(seeder, label)
        del seeder
        torch.cuda.empty_cache()
    want = outs["default", "cuda"]
    same = {k: v[:2] == want[:2] for k, v in outs.items()}
    total = int(np.frombuffer(want[0][:4], np.uint32)[0])
    res = want[2]
    log(f"{label}: (dl, full) byte-equal to the CUDA default step (kernel "
        "E): " + ", ".join(f"{p} {d} {v}" for (p, d), v in same.items())
        + f"; candidates={total} batch_over={res[3]}; steps "
        + ", ".join(f"{p} {ms:.2f} ms" for p, ms in steps.items()))
    if not all(same.values()):
        raise AssertionError(f"{label}: a chunk download differs from the "
                             "CUDA default step's")
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
    return kept


def time_probes(seeder, label: str) -> dict:
    """The index probe alone, by CUDA events, on the seeder's index at a
    chunk's query count (26 per read, as in the step), each with its
    offcnt gather: kernel E (over the CUDA seeder's bucket table), the
    merged sort (E's plain version) and searchsorted, the library's
    yardstick, on seeded queries of which about 60% are index keys and
    3% invalid (UMAX64). E must equal the merged sort on off, cnt and
    found; searchsorted must agree on found and cnt, and on off for every
    valid query."""
    import torch
    from chromap_tpu_torch.bench import time_ms
    from chromap_tpu_torch.ops import device_seed as ds
    from chromap_tpu_torch.ops.u64 import UMAX64

    M = ds.MZ_PER_READ * 32768
    nk = seeder.hash_keys.numel()
    keys, offcnt, k = seeder.hash_keys, seeder.offcnt, seeder.k
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randint(0, 1 << (2 * k), (M,), device="cuda", generator=g)
    pick = torch.rand(M, device="cuda", generator=g)
    q = torch.where(pick < 0.6, keys[torch.randint(
        0, nk, (M,), device="cuda", generator=g)], q)
    valid = pick < 0.97
    q = torch.where(valid, q, UMAX64)

    def gathered(loc_found):
        loc, found = loc_found
        return (*ds._probe_gather(offcnt, loc, found), found)

    probes = {
        "kernel E": lambda: ds.index_probe(keys, offcnt, q,
                                           seeder.probe_table, k),
        "merge-sort": lambda: ds.index_probe_plain(keys, offcnt, q, k),
        "searchsorted": lambda: gathered(
            ds._probe_searchsorted(keys, q, valid))}
    got = {n: f() for n, f in probes.items()}
    want = got["merge-sort"]
    exact = all(torch.equal(a, b) for a, b in zip(got["kernel E"], want))
    agree = exact and all(
        torch.equal(v[1], want[1]) and torch.equal(v[2], want[2])
        and torch.equal(torch.where(valid, v[0], 0),
                        torch.where(valid, want[0], 0))
        for v in got.values())
    ms = {n: time_ms(f) for n, f in probes.items()}
    log(f"{label}: the probe alone, with its offcnt gather, over {M} "
        f"queries and {nk} keys (CUDA events, median of 10): " + ", ".join(
            f"{n} {t:.4f} ms" for n, t in ms.items())
        + f"; found {int(want[2].sum())}; kernel E equals the merged sort: "
        f"{exact}; all three agree: {agree}")
    if not agree:
        raise AssertionError(f"{label}: the probes disagree")
    return ms


# ---------------------------------------------------------------------
# phase: mesh
# ---------------------------------------------------------------------

def phase_mesh(results: dict, pairs: int) -> None:
    import torch
    from chromap_tpu_torch.index.index import MinimizerIndex
    from chromap_tpu_torch.io.fastx import load_all_sequences

    launches = {"sharded_myers": mesh_sharded_myers()}
    index = MinimizerIndex.load(os.path.join(DATA, "index"))
    ref_seqs = [bytes(r.seq) for r in
                load_all_sequences(os.path.join(DATA, "ref.fa"))]
    card = torch.device("cuda", 0)
    meshes = [("2 shards on cuda:0", [card] * 2),
              ("4 shards on cuda:0", [card] * 4)]
    if torch.cuda.device_count() >= 2:
        from chromap_tpu_torch.parallel.sharding import make_data_mesh
        meshes.append((f"{torch.cuda.device_count()} cards",
                       make_data_mesh(None, "cuda")))
    else:
        log("mesh: one card visible; the mesh over distinct cards is not "
            "run")
    # the BED path's chunk (e = 8), then the Hi-C path's in split mode
    mesh_chunk("BED", index, ref_seqs, "r", 8, False, meshes)
    mesh_chunk("Hi-C split", index, ref_seqs, "hic_r", 4, True, meshes)
    launches.update(mesh_path(index, ref_seqs, pairs))
    log(f"mesh: launches in the mesh phase {json.dumps(launches)}")
    results["mesh_launches"] = launches


def mesh_sharded_myers() -> int:
    """sharded_myers over [cuda:0, cuda:0] at the BED step's kernel B
    shape: equal to kernel B's plain version on the whole batch, and its
    accepted count to the numpy form's. Returns kernel B's launches."""
    import numpy as np
    import torch
    from chromap_tpu_torch.ops import myers as my
    from chromap_tpu_torch.parallel.sharding import sharded_myers

    N, L, e = 65536, 100, 8
    p, t = kernel_inputs_myers(np.random.default_rng(13), L, N, e)
    pn, tn = p.cpu().numpy(), t.cpu().numpy()
    devices = [torch.device("cuda", 0)] * 2
    n0 = my.myers.launches
    errors, ends, accepted = sharded_myers(devices, pn, tn, e, L)
    n_launch = my.myers.launches - n0
    want = [x.cpu().numpy() for x in my.myers_plain(p, t, e, L)]
    np_err, _ = my.banded_distance_batch_numpy(pn.T, tn.T, e)
    same = (np.array_equal(errors, want[0]) and np.array_equal(ends, want[1])
            and accepted == int((np_err <= e).sum()))
    ms = 1e3 * host_median(lambda: sharded_myers(devices, pn, tn, e, L))
    ms1 = 1e3 * host_median(lambda: [x.cpu() for x in my.myers(
        torch.from_numpy(pn).cuda(), torch.from_numpy(tn).cuda(), e, L)])
    log(f"mesh sharded_myers N={N} L={L} e={e} over 2 shards on cuda:0: "
        f"equal to kernel B's plain version and accepted={accepted} equal "
        f"to banded_distance_batch_numpy's: {same}; kernel B launches "
        f"{n_launch}; the call {ms:.3f} ms against one unsharded upload + "
        f"launch + download {ms1:.3f} ms (host clock, median of 5)")
    if not same or n_launch != 2:
        raise AssertionError("sharded_myers differs from kernel B's plain "
                             "version or the numpy form")
    return n_launch


def _flat(res):
    meta, pos, cmeta, over = res
    return [meta, pos] + (list(cmeta) if isinstance(cmeta, tuple)
                          else [cmeta]) + [over]


def mesh_chunk(label: str, index, ref_seqs, reads: str, e: int, split: bool,
               meshes) -> None:
    """The path's 16384-pair chunk through MeshSeeder over each device
    list: the resolved arrays must equal DeviceSeeder's on CUDA, and no
    shard may go over its budget. Step times (host clock, median of 5)
    against the single seeder's, and each step under the profiler."""
    import numpy as np
    import torch
    from chromap_tpu_torch.ops import device_seed as ds

    codes = read_chunk(16384, reads)
    B, L = codes.shape
    rw = ds._pack_reads(codes)
    args = (index, ref_seqs, e, 2, (500, 1000))
    single = ds.DeviceSeeder(*args, device="cuda", split=split)
    want = _flat(single.resolve(single.submit_packed(rw, B, L)))
    steps = {"single": 1e3 * host_median(
        lambda: single.resolve(single.submit_packed(rw, B, L)))}
    del single
    torch.cuda.empty_cache()
    for name, devices in meshes:
        for dev in set(devices):
            torch.cuda.reset_peak_memory_stats(dev)
        mesh = ds.MeshSeeder(*args, devices, split=split)
        handle = mesh.submit_packed(rw, B, L)
        got = _flat(mesh.resolve(handle))
        over = [i for i, (dl, _, _, _) in enumerate(handle[0])
                if dl.numpy()[1]]
        if over:
            raise AssertionError(f"mesh {label} {name}: shard(s) {over} of "
                                 f"{len(devices)} over their flat budget")
        same = (len(got) == len(want) and got[-1] == want[-1]
                and all(np.array_equal(a, b)
                        for a, b in zip(got[:-1], want[:-1])))
        steps[name] = 1e3 * host_median(
            lambda: mesh.resolve(mesh.submit_packed(rw, B, L)))
        peak = ", ".join(
            f"{d}: {torch.cuda.max_memory_allocated(d) / 2**20:.1f} MiB"
            for d in sorted(set(devices), key=str))
        totals = [int(dl.numpy()[0]) for dl, _, _, _ in handle[0]]
        log(f"mesh {label} {name}: resolved arrays equal to the single "
            f"seeder's on CUDA: {same}; candidates per shard {totals}; step "
            f"(submit+resolve) {steps[name]:.2f} ms against the single "
            f"seeder's {steps['single']:.2f} ms (host clock, median of 5); "
            f"peak device memory {peak}")
        if not same:
            raise AssertionError(f"mesh {label} {name}: the mesh's resolved "
                                 "chunk differs from the single seeder's")
        profile_step(mesh, rw, B, L, f"mesh {label} {name}")
        del mesh, handle
        torch.cuda.empty_cache()


def mesh_path(index, ref_seqs, pairs: int) -> dict:
    """The path's 100k BED pairs through MappingPipeline with a 2-shard
    MeshSeeder on cuda:0 (handed to the pipeline in place of the cached
    seeder, as --mesh-devices 2 would on two cards): byte-equal to the
    host-only BED, every chunk sharded, each kernel launched once per
    shard per device chunk. Returns the launches of the first run."""
    import torch
    from chromap_tpu_torch.ops import device_seed as ds
    from chromap_tpu_torch.tools.stage_profile import (expected_launches,
                                                       kernel_wrappers)

    host = os.path.join(DATA, "host.bed")
    if not os.path.exists(host):
        map_once(False, host)
    card = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(card)
    mesh = ds.MeshSeeder(index, ref_seqs, 8, 2, (500, 1000), [card] * 2)
    wrappers = kernel_wrappers()
    cached = ds.get_device_seeder
    ds.get_device_seeder = lambda *a, **kw: mesh
    walls, launches, st = [], None, None
    try:
        for run in range(2):
            if run == 0:
                for fn in wrappers.values():
                    fn.launches = 0
            out = os.path.join(DATA, f"mesh_{run}.bed")
            _, wall, text, _ = map_once(True, out)
            walls.append(wall)
            if run == 0:
                launches = {n: fn.launches for n, fn in wrappers.items()}
                st = dict(mesh.stats)
            if "(2-device data mesh)" not in text:
                raise AssertionError("the mesh run did not seed through the "
                                     "2-shard mesh:\n" + text[-3000:])
            with open(out, "rb") as f, open(host, "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"mesh run {run}: the BED differs "
                                         "from the host-only BED")
    finally:
        ds.get_device_seeder = cached
    peak = torch.cuda.max_memory_allocated(card) / 2**20
    log(f"mesh path: {pairs} pairs through a 2-shard MeshSeeder on cuda:0, "
        f"map wall {walls[0]:.3f}s then {walls[1]:.3f}s (the seeder built "
        f"before), BED byte-equal to the host-only run; stats of the first "
        f"run {json.dumps(st)}; launches {json.dumps(launches)} over "
        f"{st['chunks']} device chunks x 2 shards; peak device memory "
        f"{peak:.1f} MiB")
    if st["chunks"] - st["over_chunks"] < 1 or st["unsharded_chunks"]:
        raise AssertionError("the mesh run seeded no chunk, or left one "
                             "unsharded")
    shard = expected_launches(None, False)
    for name, n in launches.items():
        if n != 2 * st["chunks"] * shard[name]:
            raise AssertionError(f"kernel {name}: {n} launches, not one per "
                                 "shard per device chunk")
    return {f"path_{n}": v for n, v in launches.items()}


def profile_step(seeder, rw, B: int, L: int, label: str = "chunk"):
    """Kernel time of one seeding step by kernel name (torch.profiler,
    through tools/stage_profile.py `kernel_events`), and the device's
    busy share of the step's wall time. Returns the kernel ms."""
    from chromap_tpu_torch.tools.stage_profile import kernel_events
    walls = []

    def step():
        t0 = time.time()
        seeder.resolve(seeder.submit_packed(rw, B, L))
        walls.append(1e3 * (time.time() - t0))
    rows = kernel_events(step)
    wall_ms = walls[0]
    tot = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    log(f"{label} profile: {tot:.3f} ms of kernels in {launches}"
        f" launches over a {wall_ms:.2f} ms step (device busy "
        f"{100 * tot / wall_ms:.1f}%, idle {100 - 100 * tot / wall_ms:.1f}%;"
        f" the profiler's own overhead included); top kernels:")
    # the top kernels, then the hand-written ones further down
    own = ("dense_minimizer_kernel", "myers_kernel", "myers_dropoff_kernel",
           "cluster_scan_kernel", "index_probe_kernel")
    for i, (us, n, key) in enumerate(rows):
        if i < 14 or any(k in key for k in own):
            log(f"  {us / 1e3:9.3f} ms  {100 * us / 1e3 / tot:5.1f}%  "
                f"x{n:<4d} {key[:100]}")
    return tot


# ---------------------------------------------------------------------
# phase: tools
# ---------------------------------------------------------------------

def run_tool(label: str, module: str, *args, timeout: int = 300) -> list:
    """`python -m chromap_tpu_torch.<module> args` from the repository
    root. Logs every line it prints (prefixed), raises on a nonzero exit,
    and returns its JSON lines."""
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", f"chromap_tpu_torch.{module}"]
        + [str(a) for a in args], cwd=ROOT, capture_output=True, text=True,
        timeout=timeout)
    for line in res.stdout.splitlines():
        log(f"tools {label}| {line}")
    log(f"tools {label}: rc {res.returncode} in {time.time() - t0:.1f}s")
    if res.returncode != 0:
        raise AssertionError(f"tools {label} failed (rc {res.returncode}):\n"
                             + res.stderr[-3000:])
    return [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]


def check_stops(label: str, rows, split: bool) -> None:
    """Each stop launched the hand-written kernels its stages hold
    (tools/stage_profile.py `expected_launches`) and saw device time."""
    from chromap_tpu_torch.ops.device_seed import STAGES
    from chromap_tpu_torch.tools.stage_profile import expected_launches
    for row, stop in zip(rows, STAGES):
        want = expected_launches(stop, split)
        if row["own"] != want or not row["kernel_ms"]:
            raise AssertionError(f"tools {label} stop {row['stop']}: "
                                 f"launches {row['own']}, wanted {want}")


def check_bench(label: str, line: dict) -> None:
    extra = line["extra"]
    if (line["value"] != extra.get("device_reads_per_s")
            or line["device"]["torch_device"] != "cuda"
            or not extra.get("bed_byte_equal")):
        raise AssertionError(f"tools {label}: the scored value is not the "
                             "card's rate, or the BED files differ")


def phase_tools(results: dict, genome_core: int, pairs: int) -> None:
    """The port's bench and tools as a user runs them, each a subprocess
    on the card: the bench at its defaults (1.5 Mb genome core, 100k
    pairs, the small set its first 20k) and on the path's 141 Mb set,
    the stage profile on the 141 Mb set in BED and split mode (Hi-C
    reads), the full step with the probe and cluster stops on the
    bench's set, the library ops at the 141 Mb index's NK, bench_parity
    on the bench's set and weak scaling at 1, 2 and 4 shards of the card
    on the 141 Mb set. The bench's data lives under _smoke/bench. The
    stage profile's full step must agree with the chunk phase's profile
    of the same step within 10%, and its probe stop with the probe alone
    within 20%, when the chunk phase ran."""
    from chromap_tpu_torch.tools.stage_profile import expected_launches
    bench_dir = os.path.join(DATA, "bench")
    check_bench("bench", run_tool("bench", "bench", "--cache",
                                  bench_dir)[-1])
    # best of 2: each run here also loads the 141 Mb index
    check_bench("bench 141 Mb", run_tool(
        "bench 141 Mb", "bench", "--cache", DATA, "--genome-core",
        genome_core, "--pairs", pairs, "--runs", 2)[-1])
    stages = {}
    for label, split in (("stage_profile BED", False),
                         ("stage_profile split", True)):
        rows = run_tool(label, "tools.stage_profile", "--cache", DATA,
                        *(["--split", "--reads", "hic_r"] if split else []))
        check_stops(label, rows[1:], split)
        stages[label] = rows[1:]
    run_tool("full_time", "tools.full_time", "--cache", bench_dir,
             "--stops", "probe,cluster")
    chunk = results.get("chunk", {})
    probe, whole = (next(r for r in stages["stage_profile BED"]
                         if r["stop"] == name) for name in ("probe", "FULL"))
    if chunk.get("default"):
        k, want = whole["kernel_ms"], chunk["default"]
        log(f"tools cross-check: stage_profile's full step {k:.3f} ms of "
            f"kernels against the chunk phase's profile {want:.3f} ms of "
            "the same step")
        if abs(k / want - 1) > 0.1:
            raise AssertionError("tools stage_profile: the full step's "
                                 "kernel time is more than 10% from the "
                                 "chunk phase's profile")
    if "probe_alone_ms" in chunk:
        alone = chunk["probe_alone_ms"]["kernel E"]
        d = probe["kernel_delta_ms"]
        log(f"tools cross-check: the probe stop adds {d:.3f} ms of kernels "
            f"({probe['delta_ms']:.3f} ms host clock); kernel E "
            f"alone {alone:.3f} ms")
        if abs(d / alone - 1) > 0.2:
            raise AssertionError("tools stage_profile: the probe stop is "
                                 "more than 20% from the probe alone")
    if not ("default" in chunk and "probe_alone_ms" in chunk):
        log("tools cross-check: the chunk phase did not run; not compared")
    run_tool("primitives", "tools.primitives", "--cache", DATA)
    parity = run_tool("bench_parity", "tools.bench_parity", 100_000,
                      "--cache", bench_dir)[-1]
    if not parity["parity"]:
        raise AssertionError("tools bench_parity: the BED files differ")
    shard = expected_launches(None, False)
    for row in run_tool("weak_scaling", "tools.weak_scaling", "--cache",
                        DATA)[1:]:
        n = row["devices"]
        if row["launches_per_call"] != {k: n * v for k, v in shard.items()}:
            raise AssertionError(f"tools weak_scaling at {n} shards: "
                                 f"launches {row['launches_per_call']}")


# ---------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="kernels,path,hic,batch,flows,chunk,mesh,"
                    "tools")
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
    if {"path", "hic", "batch", "flows", "chunk", "mesh", "tools"} \
            & set(phases):
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
                     ("batch", lambda: phase_batch(results)),
                     ("flows", lambda: phase_flows(results)),
                     ("chunk", lambda: phase_chunk(results)),
                     ("mesh", lambda: phase_mesh(results, args.pairs)),
                     ("tools", lambda: phase_tools(results, args.genome_core,
                                                   args.pairs))):
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
    # others' from the BED path's run; kernel B's adds those of the batch
    # engine's device run
    launches = dict(results.get("launches", {}))
    launches["myers_dropoff"] = results.get("hic_launches", {}).get(
        "myers_dropoff", 0)
    launches["myers"] = (launches.get("myers", 0)
                         + results.get("batch_launches", 0))
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
                     "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms")})
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
