"""Single-cell traffic: `paired_reads`' lanes, and for each lane a cell
barcode read as 10x Chromium sequences it, all drawn from seeds with numpy
in bulk.

The mix states all four of its barcode keys, each from the source of the
deployment it stands for (a kit's documentation, a public dataset's cell
count and barcode-correction rate): there are no defaults. The whitelist
holds `whitelist_size` distinct random barcodes of `barcode_length`
bases, drawn from a fixed seed, so every run of a mix reads the same
whitelist, as every sample of a kit does. A run's `cells` of its entries
carry reads, drawn from the run's seed, as a sample's few thousand cells
use few of a kit's; each pair takes one of them, and a PCR duplicate
takes its original's, as a copy of one molecule carries one barcode. An
exact share `barcode_error_share` of the barcode reads then has one base
replaced by another, a sequencing error that leaves it one substitution
from its entry. The reads themselves are those `paired_reads.write_lanes` writes
for the same seed; the barcodes come from another stream of it.

Beside the FASTQ: `lane<i>_bc.fq` (each record named as its pair, mate
3), `whitelist.txt` (one barcode a line) and `barcodes.npy`, each pair's
true entry as a row of the whitelist. Each lane gets `bc` and `whitelist`.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from portbench.traffic import paired_reads

KEYS = ("barcode_length", "whitelist_size", "cells", "barcode_error_share")
WHITELIST_SEED = 0


def draw_whitelist(size: int, length: int, seed: int) -> np.ndarray:
    """`size` distinct barcodes of `length` bases as rows of ACGT bytes."""
    if not 1 <= length <= 31:
        raise ValueError(f"barcode_length {length} is not in 1-31")
    if size > 4 ** length // 2:
        raise ValueError(f"{size} barcodes of {length} bases: too many")
    rng = np.random.default_rng(seed)
    keys = np.empty(0, dtype=np.int64)
    while len(keys) < size:
        keys = np.unique(np.concatenate(
            [keys, rng.integers(0, 4 ** length, 2 * size)]))
    keys = rng.permutation(keys)[:size]
    shifts = 2 * np.arange(length - 1, -1, -1)
    return paired_reads.ACGT[(keys[:, None] >> shifts) & 3]


def write_lanes(out_dir: str, genome_path: str, mix: dict, seed: int
                ) -> List[dict]:
    """paired_reads.write_lanes, then the barcode reads and whitelist;
    returns its lanes, each with `bc` and `whitelist`."""
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise KeyError("the mix states no " + ", ".join(missing))
    lanes = paired_reads.write_lanes(out_dir, genome_path, mix, seed)
    L = mix["barcode_length"]
    whitelist = draw_whitelist(mix["whitelist_size"], L, WHITELIST_SEED)
    wl_path = os.path.join(out_dir, "whitelist.txt")
    with open(wl_path, "wb") as f:
        f.write(np.concatenate(
            [whitelist, np.full((len(whitelist), 1), ord("\n"), np.uint8)],
            axis=1).tobytes())
    roots = np.load(os.path.join(out_dir, "roots.npy"))
    n = len(roots)
    rng = np.random.default_rng([seed, 3])
    cells = rng.choice(len(whitelist), mix["cells"], replace=False)
    entry = cells[rng.integers(0, len(cells), n)][roots]
    seq = whitelist[entry]
    err = np.flatnonzero(paired_reads._exact(rng, n,
                                             mix["barcode_error_share"]))
    at = rng.integers(0, L, len(err))
    # another base: a shift of 1-3 in the order ACGT
    code = np.searchsorted(paired_reads.ACGT, seq[err, at])
    seq[err, at] = paired_reads.ACGT[(code + rng.integers(1, 4, len(err)))
                                     % 4]
    qual = (33 + rng.integers(20, 40, (n, L))).astype(np.uint8)
    digits = np.char.zfill(np.arange(n).astype(str),
                           paired_reads.NAME_DIGITS)
    names = np.frombuffer(("".join("p" + d for d in digits)).encode(),
                          np.uint8).reshape(n, paired_reads.NAME_DIGITS + 1)
    rl = np.full(n, L)
    first = 0
    for i, lane in enumerate(lanes):
        rows = slice(first, first + lane["pairs"])
        path = os.path.join(out_dir, f"lane{i}_bc.fq")
        with open(path, "wb") as f:
            f.write(paired_reads._fastq(names[rows], b"3", seq[rows],
                                        qual[rows], rl[rows]))
        lane.update(bc=path, whitelist=wl_path)
        first += lane["pairs"]
    np.save(os.path.join(out_dir, "barcodes.npy"), entry)
    return lanes
