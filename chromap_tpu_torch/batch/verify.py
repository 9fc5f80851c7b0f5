"""Batched candidate verification and traceback.

All candidates of a read batch are verified in one Myers kernel dispatch
(kernel B of ops/myers.py on the torch device -- its plain version with
--torch-device cpu -- or vectorized numpy below 4,096 candidates). The
reference's SIMD lane-group iteration decides *which* candidates count
(its per-group count-threshold early exit), so a cheap host replay walks
the candidate order per read over the precomputed distances and
reproduces the exact draft-mapping lists and best/second-best counters.

Traceback (start-position recovery for reported mappings) is the reverse
Myers pass, batched the same way, with the raw-byte Hamming fast path
applied vectorized.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..mapping.generate import DraftMapping, VerifyState
from ..ops import myers

U32 = 0xFFFFFFFF
# smaller batches stay on the host (the JAX package's size rule)
MIN_DEVICE_BATCH = 4096


def myers_batch(patterns: np.ndarray, texts: np.ndarray, e: int,
                device: Optional[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(errors, ends) of every candidate: on `device` (None: the host)
    from MIN_DEVICE_BATCH candidates on, else by numpy. `calls` records
    each call's candidate count by route."""
    if device is not None and len(patterns) >= MIN_DEVICE_BATCH:
        myers_batch.calls["device"].append(len(patterns))
        return myers.banded_distance_batch(patterns, texts, e, device=device)
    myers_batch.calls["numpy"].append(len(patterns))
    return myers.banded_distance_batch_numpy(patterns, texts, e)


myers_batch.calls = {"device": [], "numpy": []}


@dataclass
class CandidateWork:
    """Flattened candidate verification work items for one strand side."""

    read_index: np.ndarray      # per candidate
    cand_position: np.ndarray   # uint64 rid<<32|pos (raw candidate)
    cand_count: np.ndarray      # uint8
    valid: np.ndarray           # IsValidCandidate mask
    errors: np.ndarray          # filled by verification
    end_pos: np.ndarray


def replay_read(vs: VerifyState, e: int, num_lanes: int,
                strand_negative: bool, read_length: int,
                cand_positions: np.ndarray, cand_counts: np.ndarray,
                valid: np.ndarray, errors: np.ndarray,
                end_positions: np.ndarray) -> None:
    """Replay the grouped-SIMD iteration for one read+strand using
    precomputed distances (draft_mapping_generator.cc:159-357).

    Appends draft mappings to vs and updates the best counters.
    """
    mappings = (vs.negative_mappings if strand_negative
                else vs.positive_mappings)
    n = len(cand_positions)
    use_groups = n >= num_lanes

    threshold = 0
    group: List[int] = []
    i = 0
    while i < n:
        if cand_counts[i] < threshold:
            break
        if not valid[i]:
            i += 1
            continue
        group.append(i)
        i += 1
        if use_groups and len(group) < num_lanes:
            continue
        if not use_groups:
            # scalar path: process immediately, no threshold updates
            ci = group.pop()
            num_errors = int(errors[ci])
            if num_errors <= e:
                DraftVerifier.update_counters(vs, num_errors)
                pos = int(cand_positions[ci])
                if strand_negative:
                    draft = pos - read_length + 1 - e + int(end_positions[ci])
                else:
                    draft = pos - e + int(end_positions[ci])
                mappings.append(DraftMapping(num_errors, draft))
            continue
        for ci in group:
            num_errors = int(errors[ci])
            if num_errors <= e:
                DraftVerifier.update_counters(vs, num_errors)
                pos = int(cand_positions[ci])
                if strand_negative:
                    draft = pos - read_length + 1 - e + int(end_positions[ci])
                else:
                    draft = pos - e + int(end_positions[ci])
                mappings.append(DraftMapping(num_errors, draft))
            else:
                threshold = int(cand_counts[ci])
        group = []

    # tail (grouped mode): no threshold logic
    for ci in group:
        if use_groups:
            num_errors = int(errors[ci])
            if num_errors <= e:
                DraftVerifier.update_counters(vs, num_errors)
                pos = int(cand_positions[ci])
                if strand_negative:
                    draft = pos - read_length + 1 - e + int(end_positions[ci])
                else:
                    draft = pos - e + int(end_positions[ci])
                mappings.append(DraftMapping(num_errors, draft))


class DraftVerifier:
    @staticmethod
    def update_counters(vs: VerifyState, num_errors: int) -> None:
        if num_errors < vs.min_num_errors:
            vs.second_min_num_errors = vs.min_num_errors
            vs.num_second_best_mappings = vs.num_best_mappings
            vs.min_num_errors = num_errors
            vs.num_best_mappings = 1
        elif num_errors == vs.min_num_errors:
            vs.num_best_mappings += 1
        elif num_errors == vs.second_min_num_errors:
            vs.num_second_best_mappings += 1
        elif num_errors < vs.second_min_num_errors:
            vs.num_second_best_mappings = 1
            vs.second_min_num_errors = num_errors


def gather_pattern_codes(ref_codes_concat: np.ndarray,
                         ref_concat_offsets: np.ndarray, rids: np.ndarray,
                         window_starts: np.ndarray,
                         window_length: int) -> np.ndarray:
    """Gather (N, window_length) uint8 code windows from the concatenated
    reference. window_starts are per-sequence positions."""
    base = ref_concat_offsets[rids] + window_starts
    idx = base[:, None] + np.arange(window_length)[None, :]
    return ref_codes_concat[idx]


def traceback_batch(e: int, min_errors: np.ndarray,
                    pattern_codes: np.ndarray, text_codes: np.ndarray,
                    pattern_raw: np.ndarray, text_raw: np.ndarray,
                    read_length: int) -> np.ndarray:
    """Vectorized BandedTraceback (alignment.cc:656-718).

    pattern_*: (N, read_length + 2e); text_*: (N, read_length). The raw
    byte arrays feed the Hamming fast path (raw equality, including case),
    the code arrays feed the reverse Myers pass.
    Returns mapping start offsets in [0, 2e].
    """
    n = len(min_errors)
    out = np.full(n, e, dtype=np.int32)
    zero = min_errors == 0
    ham = (pattern_raw[:, e:e + read_length] != text_raw).sum(axis=1)
    ham_hit = (~zero) & (ham == min_errors)
    need_dp = ~(zero | ham_hit)
    if not need_dp.any():
        return out
    rows = np.flatnonzero(need_dp)
    # reverse Myers: pattern reversed, text reversed; the scan rules differ
    # from the forward kernel so the sweep is inlined in _traceback_scan
    rp = pattern_codes[rows, ::-1]
    rt = text_codes[rows, ::-1]
    starts = _traceback_scan(e, rp, rt, min_errors[rows], read_length)
    out[rows] = starts
    return out


def _traceback_scan(e: int, patterns: np.ndarray, texts: np.ndarray,
                    target_errors: np.ndarray, L: int) -> np.ndarray:
    """Reverse-DP scan: returns start = 2e-(1+i) for the qualifying band
    offset per the reference's early-return-at-centre rule."""
    n = len(patterns)
    U32m = np.uint32(0xFFFFFFFF)
    highest = np.uint32(1 << (2 * e))
    peq = np.zeros((5, n), dtype=np.uint32)
    for i in range(2 * e):
        row = patterns[:, i]
        for c in range(5):
            peq[c] = np.where(row == c, peq[c] | highest, peq[c])
        peq >>= np.uint32(1)
    vp = np.zeros(n, dtype=np.uint32)
    vn = np.zeros(n, dtype=np.uint32)
    num_err = np.zeros(n, dtype=np.int32)
    with np.errstate(over="ignore"):
        for i in range(L):
            row = patterns[:, i + 2 * e]
            for c in range(5):
                peq[c] = np.where(row == c, peq[c] | highest, peq[c])
            t = texts[:, i]
            x = np.select([t == c for c in range(5)],
                          [peq[c] for c in range(5)])
            x = (x | vn).astype(np.uint32)
            d0 = (((vp + (x & vp)) & U32m) ^ vp) | x
            hn = vp & d0
            hp = (vn | (~(vp | d0) & U32m)).astype(np.uint32)
            x2 = d0 >> np.uint32(1)
            vn = x2 & hp
            vp = (hn | (~(x2 | hp) & U32m)).astype(np.uint32)
            num_err += 1 - (d0 & 1).astype(np.int32)
            peq >>= np.uint32(1)
    start = np.full(n, 2 * e, dtype=np.int32)
    done = np.zeros(n, dtype=bool)
    for i in range(2 * e):
        num_err = (num_err + ((vp >> np.uint32(i)) & 1).astype(np.int32)
                   - ((vn >> np.uint32(i)) & 1).astype(np.int32))
        eq = (num_err == target_errors) & ~done
        start = np.where(eq, 2 * e - (1 + i), start)
        if i + 1 == e:
            done |= eq
    return start
