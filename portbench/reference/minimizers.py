"""Minimizer extraction.

Produces (hash, hit) pairs with exactly the reference's emission semantics
(minimizer_generator.cc:7-139): canonical-strand double-hashed window
minimizers with duplicate emission, ambiguous-base resets, symmetric-kmer
skipping, and the first-window / end-of-sequence special cases.

Two implementations:
  * `generate_minimizers` — exact host oracle (state machine, per sequence).
  * `kmer_hashes` — vectorized per-position hash/strand precompute shared by
    the oracle and the device path (ops/minimizer_scan.py builds on it).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .utils import hash64_np

UMAX = 0xFFFFFFFFFFFFFFFF

# Reusable uint64 buffer arena: on this host, first-touch page faults on
# fresh large allocations dominate genome-scale runs, so scratch buffers are
# recycled across calls (keyed by length).
_ARENA: dict = {}


def _arena_take(n: int) -> np.ndarray:
    bucket = _ARENA.get(n)
    if bucket:
        return bucket.pop()
    return np.empty(n, dtype=np.uint64)


def _arena_give(arr: np.ndarray) -> None:
    _ARENA.setdefault(len(arr), []).append(arr)


def kmer_hashes(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-position canonical kmer hash.

    Returns (hash, strand, symmetric) arrays of length len(codes):
      hash[p]   : double-Hash64 of the canonical kmer ending at p, or UMAX if
                  fewer than k unambiguous bases end at p.
      strand[p] : 1 if the reverse-complement hash is canonical, else 0.
      symmetric[p] : True where fwd kmer equals its reverse complement (these
                  positions do not occupy a window slot).
    """
    n = len(codes)
    mask = np.uint64((1 << (2 * k)) - 1)
    if n < k:
        return (np.full(n, UMAX, dtype=np.uint64),
                np.zeros(n, dtype=np.uint8), np.zeros(n, dtype=bool))

    valid_base = codes < 4
    last_invalid = np.maximum.accumulate(
        np.where(~valid_base, np.arange(n), -1))
    run = np.arange(n) - last_invalid

    # Packed kmer values via binary doubling: V_m[p] = value of the m bases
    # ending at p; V_{m1+m2}[p] = V_{m1}[p-m2] << (2*m2) | V_{m2}[p]. N bases
    # contribute 0 here, but positions whose kmer spans an N have run < k and
    # are masked invalid below (matching the reference's register persistence
    # across Ns -- only run >= k positions are ever read).
    b = np.where(valid_base, codes, 0).astype(np.uint64)
    brc = np.where(valid_base, codes ^ 3, 3).astype(np.uint64)

    scratch = _arena_take(n)

    def combine(v1: np.ndarray, m1: int, v2: np.ndarray, m2: int,
                reverse: bool, out: np.ndarray = None) -> np.ndarray:
        """Window value for [p-m1-m2+1 .. p]: earlier part v1 (length m1,
        taken at p-m2), later part v2 (length m2, taken at p)."""
        if out is None:
            out = _arena_take(n)
        t = scratch[m2:]
        if reverse:
            np.left_shift(v2[m2:], np.uint64(2 * m1), out=t)
            np.bitwise_or(t, v1[:-m2], out=out[m2:])
        else:
            np.left_shift(v1[:-m2], np.uint64(2 * m2), out=t)
            np.bitwise_or(t, v2[m2:], out=out[m2:])
        out[:m2] = v2[:m2]  # garbage prefix; masked by run < k
        return out

    def packed_values(vals: np.ndarray, reverse: bool) -> np.ndarray:
        needed = {1 << b for b in range(k.bit_length()) if k & (1 << b)}
        pieces = {1: vals}
        m = 1
        while m * 2 <= k:
            recycled = None
            if m > 1 and m not in needed:
                recycled = pieces.pop(m)
                pieces[2 * m] = combine(recycled, m, recycled, m, reverse,
                                        out=recycled)
            else:
                pieces[2 * m] = combine(pieces[m], m, pieces[m], m, reverse)
            m *= 2
        acc = None
        acc_len = 0
        for bit in reversed(range(k.bit_length())):
            p = 1 << bit
            if k & p:
                if acc is None:
                    acc, acc_len = pieces.pop(p), p
                    if acc is vals:  # k == 1 edge case
                        acc = acc.copy()
                else:
                    acc = combine(acc, acc_len, pieces[p], p, reverse, out=acc)
                    acc_len += p
        for arr in pieces.values():
            if arr is not vals:
                _arena_give(arr)
        np.bitwise_and(acc, mask, out=acc)
        return acc

    with np.errstate(over="ignore"):
        fwd = packed_values(b, reverse=False)
        rc = packed_values(brc, reverse=True)

    kmer_valid = run >= k
    symmetric = (fwd == rc) & kmer_valid

    hf = hash64_np(fwd, mask)
    hr = hash64_np(rc, mask)
    strand = (hr < hf).astype(np.uint8) ^ 1  # 1 when rc canonical? see below
    # reference: strand = 0 if Hash64(fwd) < Hash64(rc) else 1
    strand = np.where(hf < hr, 0, 1).astype(np.uint8)
    canonical = np.where(hf < hr, hf, hr)
    h = hash64_np(canonical, mask)
    h = np.where(kmer_valid & ~symmetric, h, np.uint64(UMAX))
    return h, strand, symmetric


def run_state_machine(hashes: np.ndarray, strands: np.ndarray,
                      symmetric: np.ndarray, valid_base: np.ndarray,
                      start: int, end: int, sequence_index: int, k: int,
                      w: int, initial_unambiguous_length: int = 0,
                      emit_final_flush: bool = True) -> List[Tuple[int, int]]:
    """Exact emission state machine over precomputed per-position hashes.

    Iterates positions [start, end); pass initial_unambiguous_length =
    run-length ending at start-1 when starting mid-sequence (used by the
    vectorized path's tie-region fallback).
    """
    out: List[Tuple[int, int]] = []
    buffer = [(UMAX, UMAX)] * w
    min_seed = (UMAX, UMAX)
    min_position = 0
    position_in_buffer = 0
    unambiguous_length = initial_unambiguous_length
    seq_hi = sequence_index << 33

    for p in range(start, end):
        if valid_base[p]:
            if symmetric[p]:
                # symmetric kmer: does not occupy a window slot
                unambiguous_length += 1
                continue
            unambiguous_length += 1
            if unambiguous_length >= k:
                cur = (int(hashes[p]), seq_hi | (p << 1) | int(strands[p]))
            else:
                cur = (UMAX, UMAX)
        else:
            unambiguous_length = 0
            cur = (UMAX, UMAX)

        buffer[position_in_buffer] = cur
        if (unambiguous_length == w + k - 1 and min_seed[0] != UMAX
                and min_seed[0] < cur[0]):
            # First full window: flush duplicates of the min collected so far.
            for j in range(position_in_buffer + 1, w):
                if min_seed[0] == buffer[j][0] and buffer[j][1] != min_seed[1]:
                    out.append(buffer[j])
            for j in range(position_in_buffer):
                if min_seed[0] == buffer[j][0] and buffer[j][1] != min_seed[1]:
                    out.append(buffer[j])

        if cur[0] <= min_seed[0]:
            if unambiguous_length >= w + k and min_seed[0] != UMAX:
                out.append(min_seed)
            min_seed = cur
            min_position = position_in_buffer
        elif position_in_buffer == min_position:
            # the old min just slid out of the window
            if unambiguous_length >= w + k - 1 and min_seed[0] != UMAX:
                out.append(min_seed)
            min_seed = (UMAX, UMAX)
            for j in range(position_in_buffer + 1, w):
                if min_seed[0] >= buffer[j][0]:
                    min_seed = buffer[j]
                    min_position = j
            for j in range(position_in_buffer + 1):
                if min_seed[0] >= buffer[j][0]:
                    min_seed = buffer[j]
                    min_position = j
            if unambiguous_length >= w + k - 1 and min_seed[0] != UMAX:
                for j in range(position_in_buffer + 1, w):
                    if min_seed[0] == buffer[j][0] and min_seed[1] != buffer[j][1]:
                        out.append(buffer[j])
                for j in range(position_in_buffer + 1):
                    if min_seed[0] == buffer[j][0] and min_seed[1] != buffer[j][1]:
                        out.append(buffer[j])

        position_in_buffer += 1
        if position_in_buffer == w:
            position_in_buffer = 0

    if emit_final_flush and min_seed[0] != UMAX:
        out.append(min_seed)
    return out


def generate_minimizers(codes: np.ndarray, sequence_index: int, k: int,
                        w: int) -> List[Tuple[int, int]]:
    """Exact oracle. Returns list of (hash, hit) in emission order.

    hit = (sequence_index << 33) | (end_position << 1) | strand.
    """
    n = len(codes)
    hashes, strands, symmetric = kmer_hashes(codes, k)
    valid_base = codes < 4
    return run_state_machine(hashes, strands, symmetric, valid_base, 0, n,
                             sequence_index, k, w)


def generate_minimizers_arrays(codes: np.ndarray, sequence_index: int, k: int,
                               w: int) -> Tuple[np.ndarray, np.ndarray]:
    pairs = generate_minimizers(codes, sequence_index, k, w)
    if not pairs:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64))
    h = np.array([p[0] for p in pairs], dtype=np.uint64)
    hits = np.array([p[1] for p in pairs], dtype=np.uint64)
    return h, hits
