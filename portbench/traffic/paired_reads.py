"""The one generator of the benchmark's traffic: a simulated genome and
paired-end FASTQ lanes, all drawn from seeds with numpy in bulk.

`write_genome` is a frozen copy of the genome half of the repository's
`tests/simulate.py` `write_simulated_dataset`: a random core, a segmental
duplication of 2/15 of it, a random tail of 1/3, and 30 N bases, written
as FASTA in lines of 70 bases. For the same core and seed it writes the
same bytes (tests/test_portbench_traffic.py).

`write_lanes` draws the reads. It keeps that simulator's read model --
uniform fragment lengths and positions, read 1 from the fragment's start
and read 2 from the reverse complement of its end, 0 to `mismatches_max`
random substitutions a read, some reads with one deletion inside and a
random base appended, one quality string a pair -- and the junction of
`chip_smoke.py` `make_hic_reads` (read 1's bases from `junction_at` on
taken from a random place of the genome), and adds PCR duplicates
(pairs that copy an earlier pair's fragment) and adapter-trimmed pairs
(short fragments, both reads cut to the fragment). It draws in bulk, not
pair by pair, so it makes other reads than that simulator for the same
seed; the share of each kind is an exact count, so every seed gives the
same sizes in another order.

A mix file sets these parameters; `lanes` lists one entry per FASTQ
pair, each with its `pairs` and any parameter it sets apart from the
mix's own.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.arange(256, dtype=np.uint8)
COMP[list(b"ACGTN")] = list(b"TGCAN")
DEFAULTS = dict(read_length=100, fragment_min=150, fragment_max=499,
                mismatches_max=2, indel_share=0.0, pcr_dup_share=0.0,
                trimmed_share=0.0, trimmed_min=40, trimmed_max=99,
                junction_share=0.0, junction_at=60)
NAME_DIGITS = 7
ROWS_PER_BLOCK = 1 << 16


def write_genome(path: str, genome_core: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, genome_core)
    genome = np.concatenate([base,
                             base[genome_core // 3: genome_core // 3
                                  + genome_core * 2 // 15],
                             rng.integers(0, 4, genome_core // 3)])
    garr = ACGT[genome]
    del base, genome
    for p in rng.integers(0, len(garr), 30):
        garr[p] = ord("N")
    n = len(garr)
    rows = -(-n // 70)
    padded = np.full(rows * 70, ord("\n"), dtype=np.uint8)
    padded[:n] = garr
    lines = np.full((rows, 71), ord("\n"), dtype=np.uint8)
    lines[:, :70] = padded.reshape(rows, 70)
    # the last line holds its n - 70 (rows - 1) bases and a newline
    last = n - (rows - 1) * 70
    body = np.concatenate([lines[:-1].reshape(-1), lines[-1, :last],
                           lines[-1, 70:]])
    with open(path, "wb") as f:
        f.write(b">chr1\n")
        f.write(body.tobytes())


def read_genome(path: str) -> np.ndarray:
    """The bases of the first FASTA record as a uint8 array."""
    with open(path, "rb") as f:
        first = f.read().split(b">")[1]
    seq = first.split(b"\n", 1)[1].replace(b"\n", b"")
    return np.frombuffer(seq, dtype=np.uint8)


def _exact(rng, n: int, share: float) -> np.ndarray:
    """A mask of exactly round(share * n) of n rows, drawn from rng."""
    mask = np.zeros(n, dtype=bool)
    mask[rng.choice(n, int(round(share * n)), replace=False)] = True
    return mask


def _mutate(rng, seq: np.ndarray, rl: np.ndarray, p: dict) -> None:
    """Substitutions, then one deletion in an exact share of the reads,
    in place; `seq` holds each row's read in its first rl bases."""
    n, L = seq.shape
    rows = np.arange(n)
    count = rng.integers(0, p["mismatches_max"] + 1, n)
    at = rng.integers(0, rl[:, None], (n, max(1, p["mismatches_max"])))
    base = ACGT[rng.integers(0, 4, at.shape)]
    for j in range(p["mismatches_max"]):
        sel = count > j
        seq[rows[sel], at[sel, j]] = base[sel, j]
    indel = np.flatnonzero(_exact(rng, n, p["indel_share"]))
    if len(indel):
        r = rl[indel]
        q = rng.integers(10, r - 10)
        col = np.arange(L)[None, :]
        src = np.minimum(col + (col >= q[:, None]), L - 1)
        moved = np.take_along_axis(seq[indel], src, axis=1)
        moved[np.arange(len(indel)), r - 1] = ACGT[rng.integers(0, 4,
                                                               len(indel))]
        seq[indel] = moved


def _fastq(names: np.ndarray, mate: bytes, seq: np.ndarray,
           qual: np.ndarray, rl: np.ndarray) -> bytes:
    """FASTQ records `@<name>/<mate>`, each read its first rl bases."""
    n, L = seq.shape
    head = np.concatenate([np.full((n, 1), ord("@"), np.uint8), names,
                           np.tile(np.frombuffer(b"/" + mate + b"\n",
                                                 np.uint8), (n, 1))], axis=1)
    H = head.shape[1]
    size = H + 2 * rl + 4
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(size, out=offs[1:])
    out = np.empty(int(offs[-1]), dtype=np.uint8)
    sep = np.frombuffer(b"\n+\n", np.uint8)
    nl = np.frombuffer(b"\n", np.uint8)
    for lo in range(0, n, ROWS_PER_BLOCK):
        hi = min(n, lo + ROWS_PER_BLOCK)
        for r in np.unique(rl[lo:hi]):
            idx = lo + np.flatnonzero(rl[lo:hi] == r)
            m = len(idx)
            block = np.concatenate([head[idx], seq[idx, :r],
                                    np.tile(sep, (m, 1)), qual[idx, :r],
                                    np.tile(nl, (m, 1))], axis=1)
            out[offs[idx][:, None] + np.arange(block.shape[1])] = block
    return out.tobytes()


def make_lane(rng, genome: np.ndarray, pairs: int, first: int, p: dict
              ) -> Dict[str, object]:
    """One lane of `pairs` pairs named from pair number `first` on:
    FASTQ bytes of both mates, each pair's fragment root (the pair whose
    fragment a PCR duplicate copies, else itself) and the fragment's
    start and end in the genome."""
    n, L, G = pairs, p["read_length"], len(genome)
    frag = rng.integers(p["fragment_min"], p["fragment_max"] + 1, n)
    short = _exact(rng, n, p["trimmed_share"])
    frag[short] = rng.integers(p["trimmed_min"], p["trimmed_max"] + 1,
                               int(short.sum()))
    pos = rng.integers(0, G - frag)
    root = np.arange(n)
    dup = 1 + np.flatnonzero(_exact(rng, n - 1, p["pcr_dup_share"]))
    root[dup] = rng.integers(0, dup)
    while True:
        nxt = root[root]
        if np.array_equal(nxt, root):
            break
        root = nxt
    pos, frag = pos[root], frag[root]
    rl = np.minimum(frag, L)
    col = np.arange(L)[None, :]
    seq1 = genome[np.minimum(pos[:, None] + col, G - 1)]
    seq2 = COMP[genome[np.maximum(pos[:, None] + frag[:, None] - 1 - col,
                                  0)]]
    _mutate(rng, seq1, rl, p)
    _mutate(rng, seq2, rl, p)
    J = p["junction_at"]
    junc = np.flatnonzero(_exact(rng, n, p["junction_share"]) & (rl > J))
    if len(junc):
        span = rl[junc] - J
        st = rng.integers(0, G - span)
        cols = np.arange(L - J)[None, :]
        take = genome[np.minimum(st[:, None] + cols, G - 1)]
        keep = cols < span[:, None]
        seg = seq1[junc, J:]
        seg[keep] = take[keep]
        seq1[junc, J:] = seg
    qual = (33 + rng.integers(20, 40, (n, L))).astype(np.uint8)
    digits = np.char.zfill(np.arange(first, first + n).astype(str),
                           NAME_DIGITS)
    names = np.frombuffer(("".join("p" + d for d in digits)).encode(),
                          np.uint8).reshape(n, NAME_DIGITS + 1)
    return {"r1": _fastq(names, b"1", seq1, qual, rl),
            "r2": _fastq(names, b"2", seq2, qual, rl),
            "root": root + first,
            "frag": np.stack([pos, pos + frag], axis=1)}


def write_lanes(out_dir: str, genome_path: str, mix: dict, seed: int
                ) -> List[dict]:
    """Write each lane of `mix` as lane<i>_1.fq / lane<i>_2.fq, the pairs'
    fragment roots as roots.npy and their fragments' starts and ends as
    frags.npy; returns the lanes' file paths and pair counts."""
    os.makedirs(out_dir, exist_ok=True)
    genome = read_genome(genome_path)
    rng = np.random.default_rng(seed)
    lanes, roots, frags, first = [], [], [], 0
    for i, lane in enumerate(mix["lanes"]):
        p = {**DEFAULTS, **{k: v for k, v in mix.items()
                            if k in DEFAULTS}, **lane}
        made = make_lane(rng, genome, lane["pairs"], first, p)
        paths = [os.path.join(out_dir, f"lane{i}_{m}.fq") for m in (1, 2)]
        for path, key in zip(paths, ("r1", "r2")):
            with open(path, "wb") as f:
                f.write(made[key])
        roots.append(made["root"])
        frags.append(made["frag"])
        lanes.append({"r1": paths[0], "r2": paths[1],
                      "pairs": lane["pairs"]})
        first += lane["pairs"]
    np.save(os.path.join(out_dir, "roots.npy"), np.concatenate(roots))
    np.save(os.path.join(out_dir, "frags.npy"), np.concatenate(frags))
    return lanes
