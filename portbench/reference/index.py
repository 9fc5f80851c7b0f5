"""The reference's own minimizer index, built from the FASTA alone.

The same contract as the port's index (sorted distinct minimizer hashes,
each with its occurrences in (hash, hit) order, index.cc:12-89), built
with the frozen numpy minimizer code of this package in blocks of the
genome (which bounds its memory), and kept as .npy files that later runs
open memory-mapped. A block is computed over its bases plus a margin
on each side and keeps only the hits inside it: emission at a position
depends on the w windows around it and on runs of valid bases counted up
to w + k, so a margin far wider than that gives the whole-sequence result
(tests/test_portbench_reference.py holds the two equal).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .minimizer_vector import generate_minimizer_arrays_fast
from .utils import encode_sequence

BLOCK = 4_000_000
MARGIN = 4096
FILES = ("hash_keys", "counts", "occurrences")


def read_fasta(path: str) -> List[Tuple[bytes, bytes]]:
    """(name, sequence) of every record, the name up to the first
    whitespace."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for chunk in data.split(b">")[1:]:
        head, _, body = chunk.partition(b"\n")
        out.append((head.split()[0], body.replace(b"\n", b"")))
    return out


def _block_minimizers(rid: int, codes: np.ndarray, lo: int, s: int,
                      e: int, k: int, w: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Hits of the bases s..e of sequence rid, from codes[lo:] with a
    margin on each side."""
    h, hits = generate_minimizer_arrays_fast(codes, 0, k, w)
    pos = (hits >> np.uint64(1)) & np.uint64(0xFFFFFFFF)
    keep = (pos >= np.uint64(s - lo)) & (pos < np.uint64(e - lo))
    shift = np.uint64((rid << 33) | (lo << 1))
    return h[keep], hits[keep] + shift


class MinimizerIndex:
    """lookup(hash) -> occurrences, over arrays that may be memory-mapped."""

    def __init__(self, k: int, w: int, hash_keys, counts, occurrences):
        self.kmer_size = k
        self.window_size = w
        self.hash_keys = hash_keys
        self.counts = counts
        self.occurrences = occurrences
        self.offsets = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.offsets[1:])

    def lookup(self, minimizer_hash: int) -> Optional[np.ndarray]:
        key = np.uint64(minimizer_hash)
        i = int(np.searchsorted(self.hash_keys, key))
        if i >= len(self.hash_keys) or self.hash_keys[i] != key:
            return None
        return np.asarray(self.occurrences[self.offsets[i]:
                                           self.offsets[i + 1]])


def build(seqs: List[bytes], k: int, w: int
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    parts = []
    for rid, seq in enumerate(seqs):
        codes = encode_sequence(seq)
        for s in range(0, len(codes), BLOCK):
            e = min(s + BLOCK, len(codes))
            lo, hi = max(0, s - MARGIN), min(len(codes), e + MARGIN)
            parts.append(_block_minimizers(rid, codes[lo:hi], lo, s, e, k,
                                           w))
    hashes = np.concatenate([p[0] for p in parts])
    hits = np.concatenate([p[1] for p in parts])
    del parts
    order = np.lexsort((hits, hashes))
    hashes, hits = hashes[order], hits[order]
    keys, counts = np.unique(hashes, return_counts=True)
    return keys, counts.astype(np.uint32), hits


def load_or_build(fasta: str, out_dir: str, k: int, w: int
                  ) -> MinimizerIndex:
    """The index of `fasta` kept in `out_dir`, built on first use."""
    done = os.path.join(out_dir, f"ready_k{k}_w{w}")
    if not os.path.exists(done):
        os.makedirs(out_dir, exist_ok=True)
        arrays = build([s for _, s in read_fasta(fasta)], k, w)
        for name, arr in zip(FILES, arrays):
            np.save(os.path.join(out_dir, name + ".npy"), arr)
        with open(done, "w") as f:
            f.write("ok\n")
    arrs = [np.load(os.path.join(out_dir, n + ".npy"), mmap_mode="r")
            for n in FILES]
    return MinimizerIndex(k, w, *arrs)
