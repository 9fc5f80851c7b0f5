"""Vectorized candidate generation over a read batch.

Reproduces the per-read seeding semantics (candidate_processor.cc,
index.cc:237-349) with batch array operations:
  - index probes become one binary search over the sorted hash array,
  - occurrence expansion becomes repeat/gather,
  - clustering becomes segmented boundary detection over sorted hits.

Reads whose clustering can hit the sequential-only path (the
`minimizer_count >= num_minimizers && pos > best_local + e` split
condition, cluster count saturation, or an empty first round requiring the
high-frequency retry) are flagged and recomputed exactly by the per-read
reference path; everything else is produced here bit-identically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..index.index import MinimizerIndex
from ..ops.minimizer_vector import BatchMinimizers

U32 = 0xFFFFFFFF


@dataclass
class BatchCandidates:
    """Per-read candidate lists in flattened arrays, one set per strand."""

    pos_positions: np.ndarray   # uint64 (rid<<32 | start)
    pos_counts: np.ndarray      # uint8 supporting-minimizer counts
    pos_starts: np.ndarray      # per-read segment starts into the above
    pos_nums: np.ndarray        # per-read lengths
    neg_positions: np.ndarray
    neg_counts: np.ndarray
    neg_starts: np.ndarray
    neg_nums: np.ndarray
    repetitive_seed_length: np.ndarray  # per-read uint32
    needs_fallback: np.ndarray  # bool per read: recompute with exact path


def _cluster_sorted_hits(hits: np.ndarray, seg_ids: np.ndarray,
                         error_threshold: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]:
    """Cluster sorted hits within segments (read or read-strand groups).

    Returns (cluster_pos, cluster_count, cluster_size, cluster_seg,
    cluster_span) where cluster_pos is the best (longest-run) hit value,
    cluster_count the best run length, cluster_size the number of hits in
    the cluster, and cluster_span the position span (for fallback
    detection of the num_minimizers split condition).
    """
    n = len(hits)
    if n == 0:
        z64 = np.empty(0, dtype=np.uint64)
        zi = np.empty(0, dtype=np.int64)
        return z64, zi, zi, zi, zi
    h = hits.astype(np.int64)  # values < 2^63 (rid < 2^31)
    new_cluster = np.ones(n, dtype=bool)
    same_seg = seg_ids[1:] == seg_ids[:-1]
    new_cluster[1:] = (~same_seg) | ((h[1:] - h[:-1]) > error_threshold)
    cluster_id = np.cumsum(new_cluster) - 1
    num_clusters = int(cluster_id[-1]) + 1

    # run-length encode equal consecutive values within clusters
    new_run = np.ones(n, dtype=bool)
    new_run[1:] = (h[1:] != h[:-1]) | new_cluster[1:]
    run_id = np.cumsum(new_run) - 1
    run_starts = np.flatnonzero(new_run)
    run_lengths = np.diff(np.append(run_starts, n))
    run_cluster = cluster_id[run_starts]
    run_value = hits[run_starts]

    # per cluster: first run with max length
    # order runs by (cluster, -length, start) and take first per cluster
    order = np.lexsort((run_starts, -run_lengths, run_cluster))
    rc_sorted = run_cluster[order]
    first_of_cluster = np.ones(len(order), dtype=bool)
    first_of_cluster[1:] = rc_sorted[1:] != rc_sorted[:-1]
    sel = order[first_of_cluster]
    # sel indexes runs; map back per cluster in cluster order
    sel_cluster = run_cluster[sel]
    best_value = np.empty(num_clusters, dtype=np.uint64)
    best_len = np.empty(num_clusters, dtype=np.int64)
    best_value[sel_cluster] = run_value[sel]
    best_len[sel_cluster] = run_lengths[sel]

    cluster_starts = np.flatnonzero(new_cluster)
    cluster_sizes = np.diff(np.append(cluster_starts, n))
    cluster_seg = seg_ids[cluster_starts]
    cluster_last = np.append(cluster_starts[1:], n) - 1
    span = h[cluster_last] - h[cluster_starts]
    return best_value, best_len, cluster_sizes, cluster_seg, span


class BatchSeeder:
    def __init__(self, index: MinimizerIndex, error_threshold: int,
                 min_num_seeds_required: int,
                 max_seed_frequencies: Tuple[int, int]):
        self.index = index
        self.e = error_threshold
        self.min_num_seeds = min_num_seeds_required
        self.f0, self.f1 = max_seed_frequencies

    def generate(self, bm: BatchMinimizers, num_reads: int) -> BatchCandidates:
        index = self.index
        k = index.kmer_size
        w = index.window_size

        mz_read = np.repeat(np.arange(num_reads), bm.counts)
        n_mz = len(bm.hashes)

        idx = np.searchsorted(index.hash_keys, bm.hashes)
        idx_c = np.minimum(idx, len(index.hash_keys) - 1)
        found = (idx < len(index.hash_keys)) & (index.hash_keys[idx_c]
                                                == bm.hashes)
        occ_count = np.where(found, index.counts[idx_c], 0).astype(np.int64)
        occ_offset = index.offsets[idx_c].astype(np.int64)

        keep = found & (occ_count < self.f0) & (occ_count > 0)
        repetitive = found & (occ_count >= self.f0)

        # per-read first-round hit existence
        hits_per_read = np.bincount(mz_read[keep],
                                    weights=occ_count[keep],
                                    minlength=num_reads).astype(np.int64)
        empty_round1 = hits_per_read == 0

        # repetitive seed stats per read (round 1 semantics)
        rep_len, rep_count = self._repetitive_stats(bm, mz_read, repetitive,
                                                    num_reads, k, w)

        # fallback set: empty first round (high-frequency retry runs the
        # exact path; rare) -- plus cluster-level conditions detected later
        needs_fallback = empty_round1.copy()

        positions, strands_pos, mz_of_hit = self._expand_hits(
            bm, keep, occ_count, occ_offset, k)
        hit_read = mz_read[mz_of_hit]

        num_minimizers = bm.counts
        num_required = np.maximum(
            np.minimum(num_minimizers - rep_count, self.min_num_seeds), 1)

        out = {}
        for strand_positive in (True, False):
            mask = strands_pos if strand_positive else ~strands_pos
            sub_pos = positions[mask]
            sub_read = hit_read[mask]
            order = np.lexsort((sub_pos, sub_read))
            sub_pos = sub_pos[order]
            sub_read = sub_read[order]
            (c_pos, c_count, c_size, c_read, c_span) = _cluster_sorted_hits(
                sub_pos, sub_read, self.e)
            req = num_required[c_read]
            emit_mask = c_size >= req
            # sequential-only split condition risk: the cluster collected at
            # least num_minimizers hits and spans more than e
            risk = (c_size >= num_minimizers[c_read]) & (c_span > self.e)
            # uint8 wrap of Candidate.count
            risk |= c_count > 255
            # uint32 wrap zone: `prev_pos + e` overflow changes the
            # sequential boundary test for positions near 2^32
            risk |= (c_pos & np.uint64(U32)) > np.uint64(U32 - 512)
            if risk.any():
                needs_fallback[np.unique(c_read[risk])] = True
            keep_c = emit_mask
            out[strand_positive] = (c_pos[keep_c],
                                    np.minimum(c_count[keep_c], 255),
                                    c_read[keep_c])

        def pack(vals, counts, reads):
            nums = np.bincount(reads, minlength=num_reads).astype(np.int64)
            starts = np.zeros(num_reads, dtype=np.int64)
            np.cumsum(nums[:-1], out=starts[1:])
            return vals, counts.astype(np.uint8), starts, nums

        pv, pc, ps, pn = pack(*out[True])
        nv, nc, ns, nn = pack(*out[False])
        return BatchCandidates(
            pos_positions=pv, pos_counts=pc, pos_starts=ps, pos_nums=pn,
            neg_positions=nv, neg_counts=nc, neg_starts=ns, neg_nums=nn,
            repetitive_seed_length=rep_len,
            needs_fallback=needs_fallback)

    def _repetitive_stats(self, bm: BatchMinimizers, mz_read: np.ndarray,
                          repetitive: np.ndarray, num_reads: int, k: int,
                          w: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-read repetitive seed length/count (index.cc:507-523).

        Minimizer lists are in ascending position order per read, matching
        the sequential accumulator's visit order.
        """
        rep_idx = np.flatnonzero(repetitive)
        rep_len = np.zeros(num_reads, dtype=np.int64)
        rep_count = np.bincount(mz_read[rep_idx], minlength=num_reads)
        if len(rep_idx) == 0:
            return rep_len, rep_count
        rp_read = mz_read[rep_idx]
        rp_pos = (bm.hits[rep_idx] >> np.uint64(1)).astype(np.int64) \
            & 0xFFFFFFFF
        first = np.ones(len(rep_idx), dtype=bool)
        prev = np.empty(len(rep_idx), dtype=np.int64)
        prev[1:] = rp_pos[:-1]
        prev[0] = 1 << 40
        # "first" in the reference is prev_position > read_position (initial
        # UINT32_MAX), which also retriggers if positions decrease mid-list.
        first[1:] = (rp_read[1:] != rp_read[:-1]) | (prev[1:] > rp_pos[1:])
        diff = rp_pos - prev
        contrib = np.where(first, k,
                           np.where(diff < k + w - 1, diff, k))
        np.add.at(rep_len, rp_read, contrib)
        return rep_len, rep_count

    def _expand_hits(self, bm: BatchMinimizers, keep: np.ndarray,
                     occ_count: np.ndarray, occ_offset: np.ndarray,
                     k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Expand kept minimizers into candidate positions.

        Returns (candidate_positions u64, strand_positive mask,
        minimizer_row per hit)."""
        kept_rows = np.flatnonzero(keep)
        counts = occ_count[kept_rows]
        total = int(counts.sum())
        if total == 0:
            return (np.empty(0, np.uint64), np.empty(0, bool),
                    np.empty(0, np.int64))
        mz_of_hit = np.repeat(kept_rows, counts)
        group_start = np.zeros(len(kept_rows), dtype=np.int64)
        np.cumsum(counts[:-1], out=group_start[1:])
        within = np.arange(total) - np.repeat(group_start, counts)
        occ_idx = np.repeat(occ_offset[kept_rows], counts) + within
        ref_hits = self.index.occurrences[occ_idx]

        read_hits = bm.hits[mz_of_hit]
        ref_pos = (ref_hits >> np.uint64(1)).astype(np.int64) & U32
        read_pos = (read_hits >> np.uint64(1)).astype(np.int64) & U32
        same_strand = (ref_hits & np.uint64(1)) == (read_hits & np.uint64(1))
        start = np.where(same_strand, ref_pos - read_pos,
                         ref_pos + read_pos - k + 1) & U32
        rid = (ref_hits >> np.uint64(33)).astype(np.int64)
        cand = (rid.astype(np.uint64) << np.uint64(32)) | start.astype(np.uint64)
        return cand, same_strand, mz_of_hit
