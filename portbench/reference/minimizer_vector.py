"""Vectorized minimizer extraction with exact tie-region fallback.

The sequential queue algorithm (index/minimizers.py `run_state_machine`)
maintains the invariant min_seed == min(last w slots). In the absence of
equal finite hashes within distance w, its emitted set has a closed form
per position j (derived from displacement/exit/flush timing):

  R = first t in (j, j+w] with H[t] < H[j]
  L = last  t in (j-w, j) with H[t] < H[j];  a = L + w (or j if no L)
  - displaced at R:   emitted iff a <= R-1 and run[R] >= w+k
  - exits at j+w:     emitted iff run[j+w] >= w+k-1        (no R)
  - reaches EOF:      emitted iff a <= n-1                 (no R, j+w > n-1)

Equal hashes within distance w (RC-palindromic kmers at ~4^-(k/2) rate, or
repeats) perturb the sequential timing, so spans around each tie pair are
recomputed with the exact state machine and spliced in; everything else
comes from the closed form. Output equals the oracle exactly (fuzz-tested),
in position order outside tie regions.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .minimizers import (UMAX, generate_minimizers, kmer_hashes,
                                run_state_machine)


def _closed_form_emissions(hashes: np.ndarray, run: np.ndarray, k: int,
                           w: int, seg_end: np.ndarray = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (emit_mask, tie_mask). tie_mask marks j that has an equal
    finite hash within distance w (either direction).

    seg_end[j] is the last position of the logical sequence containing j;
    pass it when several reads are concatenated with >= w ambiguous-base
    separators (the separators guarantee displacement/lookback never cross
    a segment boundary, so only the exit/flush conditions need seg_end).
    """
    n = len(hashes)
    idx = np.arange(n)
    INF = np.int64(n + w + 1)
    finite = hashes != np.uint64(UMAX)
    if seg_end is None:
        seg_end = np.full(n, n - 1, dtype=np.int64)

    r_off = np.full(n, INF, dtype=np.int64)
    l_off = np.full(n, INF, dtype=np.int64)
    tie = np.zeros(n, dtype=bool)
    for d in range(1, w + 1):
        if d > n - 1:
            break
        lt = hashes[d:] < hashes[:n - d]
        eq = (hashes[d:] == hashes[:n - d]) & finite[d:]
        if eq.any():
            ties_at = np.flatnonzero(eq)
            tie[ties_at] = True
            tie[ties_at + d] = True
        np.minimum(r_off[:n - d], np.where(lt, d, INF), out=r_off[:n - d])
        if d <= w - 1:
            lt_l = hashes[:n - d] < hashes[d:]
            np.minimum(l_off[d:], np.where(lt_l, d, INF), out=l_off[d:])

    a = np.where(l_off >= INF, idx, idx - l_off + w)
    r_time = idx + r_off
    has_r = r_off <= w

    run_at = np.zeros(n + w + 1, dtype=np.int64)
    run_at[:n] = run

    disp = has_r & (a <= r_time - 1) & (
        run_at[np.minimum(r_time, n - 1)] >= w + k)
    exit_time = idx + w
    can_exit = (~has_r) & (exit_time <= seg_end)
    exit_emit = can_exit & (run_at[np.minimum(exit_time, n - 1)] >= w + k - 1)
    flush = (~has_r) & (exit_time > seg_end) & (a <= seg_end)
    emit = (disp | exit_emit | flush) & finite
    return emit, tie


def emitted_positions_vector(codes: np.ndarray, k: int, w: int
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]:
    """Returns (positions, hashes, strands, run, tie_positions)."""
    n = len(codes)
    hashes, strands, symmetric = kmer_hashes(codes, k)
    valid_base = codes < 4
    last_invalid = np.maximum.accumulate(
        np.where(~valid_base, np.arange(n), -1))
    run = np.arange(n) - last_invalid
    emit, tie = _closed_form_emissions(hashes, run, k, w)
    return emit, hashes, strands, run, tie


def generate_minimizer_arrays_fast(codes: np.ndarray, sequence_index: int,
                                   k: int, w: int
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized extraction, exact; returns (hashes, hits) uint64 arrays.

    Tie regions are recomputed via the exact state machine and spliced in
    (position order is preserved outside spans; within a span the oracle's
    own emission order is kept)."""
    n = len(codes)
    hashes, strands, symmetric = kmer_hashes(codes, k)
    if symmetric.any():
        # even-k symmetric kmers skip buffer slots; rare -- full oracle
        pairs = generate_minimizers(codes, sequence_index, k, w)
        return (np.array([p[0] for p in pairs], dtype=np.uint64),
                np.array([p[1] for p in pairs], dtype=np.uint64))
    valid_base = codes < 4
    last_invalid = np.maximum.accumulate(
        np.where(~valid_base, np.arange(n), -1))
    run = np.arange(n) - last_invalid
    emit, tie = _closed_form_emissions(hashes, run, k, w)

    def hits_for(positions: np.ndarray) -> np.ndarray:
        return ((np.uint64(sequence_index) << np.uint64(33))
                | (positions.astype(np.uint64) << np.uint64(1))
                | strands[positions].astype(np.uint64))

    tie_pos = np.flatnonzero(tie)
    if len(tie_pos) == 0:
        positions = np.flatnonzero(emit)
        return hashes[positions], hits_for(positions)

    # Build invalidated spans [t-w, t+w] around tie positions, merged.
    starts = np.maximum(tie_pos - w, 0)
    ends = np.minimum(tie_pos + w, n - 1)
    spans: List[Tuple[int, int]] = []
    cur_s, cur_e = int(starts[0]), int(ends[0])
    for s, e in zip(starts[1:], ends[1:]):
        if s <= cur_e + 1:
            cur_e = max(cur_e, int(e))
        else:
            spans.append((cur_s, cur_e))
            cur_s, cur_e = int(s), int(e)
    spans.append((cur_s, cur_e))

    out_h: List[np.ndarray] = []
    out_t: List[np.ndarray] = []
    emit_positions = np.flatnonzero(emit)
    prev = 0
    warmup = 2 * (w + k)
    for (rs, re) in spans:
        lo = np.searchsorted(emit_positions, prev)
        hi = np.searchsorted(emit_positions, rs)
        seg = emit_positions[lo:hi]
        out_h.append(hashes[seg])
        out_t.append(hits_for(seg))
        o_start = max(0, rs - warmup)
        o_end = min(n, re + w + 1)
        init_run = int(run[o_start - 1]) if o_start > 0 else 0
        emissions = run_state_machine(
            hashes, strands, symmetric, valid_base, o_start, o_end,
            sequence_index, k, w,
            initial_unambiguous_length=init_run,
            emit_final_flush=(o_end == n))
        kept = [(h, hit) for (h, hit) in emissions
                if rs <= ((hit >> 1) & 0xFFFFFFFF) <= re]
        if kept:
            out_h.append(np.array([x[0] for x in kept], dtype=np.uint64))
            out_t.append(np.array([x[1] for x in kept], dtype=np.uint64))
        prev = re + 1
    lo = np.searchsorted(emit_positions, prev)
    seg = emit_positions[lo:]
    out_h.append(hashes[seg])
    out_t.append(hits_for(seg))
    return np.concatenate(out_h), np.concatenate(out_t)
