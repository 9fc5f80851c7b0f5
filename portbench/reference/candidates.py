"""Candidate generation from minimizer hits.

Host-exact implementation of the reference's seeding layer
(candidate_processor.cc, index.cc:237-523): two-round frequency-capped hit
collection, clustering of sorted hits into candidates within the error
threshold, paired-end mate rescue, and paired candidate intersection.

All position arithmetic deliberately wraps at 32 bits to match the
reference's uint32 semantics.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .index import MinimizerIndex

U32 = 0xFFFFFFFF
UMAX = 0xFFFFFFFFFFFFFFFF


@dataclass
class Candidate:
    position: int  # (rid << 32) | ref_start_position
    count: int     # number of supporting minimizers (uint8 saturating in C++)

    @property
    def rid(self) -> int:
        return self.position >> 32

    @property
    def ref_position(self) -> int:
        return self.position & U32

    def sort_key(self):
        # Candidate::operator< : higher count first, then lower position
        return (-self.count, self.position)


@dataclass
class ReadSeedState:
    """Per-read seeding scratch (analog of MappingMetadata's seeding part)."""

    minimizers: List[Tuple[int, int]] = field(default_factory=list)  # (hash, hit)
    positive_hits: List[int] = field(default_factory=list)
    negative_hits: List[int] = field(default_factory=list)
    positive_candidates: List[Candidate] = field(default_factory=list)
    negative_candidates: List[Candidate] = field(default_factory=list)
    positive_candidates_buffer: List[Candidate] = field(default_factory=list)
    negative_candidates_buffer: List[Candidate] = field(default_factory=list)
    repetitive_seed_length: int = 0

    def num_candidates(self) -> int:
        return len(self.positive_candidates) + len(self.negative_candidates)

    def move_candidates_to_buffer(self) -> None:
        self.positive_candidates_buffer = self.positive_candidates
        self.negative_candidates_buffer = self.negative_candidates
        self.positive_candidates = []
        self.negative_candidates = []


def _candidate_position_from_hits(kmer_size: int, reference_hit: int,
                                  read_hit: int) -> int:
    ref_pos = (reference_hit >> 1) & U32
    read_pos = (read_hit >> 1) & U32
    same_strand = (reference_hit & 1) == (read_hit & 1)
    if same_strand:
        start = (ref_pos - read_pos) & U32
    else:
        start = (ref_pos + read_pos - kmer_size + 1) & U32
    rid = reference_hit >> 33
    return (rid << 32) | start


class RepetitiveSeedAccumulator:
    """Tracks total repetitive-seed-covered length (index.cc:507-523)."""

    def __init__(self, kmer_size: int, window_size: int):
        self.k = kmer_size
        self.w = window_size
        self.length = 0
        self.count = 0
        self.prev_position = U32 + 1  # larger than any uint32

    def update(self, read_position: int) -> None:
        if self.prev_position > read_position:
            self.length += self.k
        else:
            if read_position < self.prev_position + self.k + self.w - 1:
                self.length += read_position - self.prev_position
            else:
                self.length += self.k
        self.prev_position = read_position
        self.count += 1


class CandidateGenerator:
    def __init__(self, index: MinimizerIndex, error_threshold: int,
                 min_num_seeds_required: int, max_seed_frequencies: Tuple[int, int]):
        self.index = index
        self.error_threshold = error_threshold
        self.min_num_seeds = min_num_seeds_required
        self.max_seed_frequencies = max_seed_frequencies

    # ---------------- hit collection (index.cc:237-349) ----------------

    def _collect_hits(self, minimizers: List[Tuple[int, int]],
                      max_seed_frequency: int, repetitive_seed_frequency: int,
                      use_heap_merge: bool) -> Tuple[List[int], List[int], int, int]:
        """Returns (positive_hits, negative_hits, repetitive_seed_length,
        repetitive_seed_count), hits sorted ascending."""
        index = self.index
        k = index.kmer_size
        rep = RepetitiveSeedAccumulator(k, index.window_size)

        pos_lists: List[List[int]] = [[] for _ in minimizers] if use_heap_merge else []
        neg_lists: List[List[int]] = [[] for _ in minimizers] if use_heap_merge else []
        positive_hits: List[int] = []
        negative_hits: List[int] = []
        sorted_flag = True

        for mi, (mhash, read_hit) in enumerate(minimizers):
            occ = index.lookup(mhash)
            if occ is None:
                continue
            plist = pos_lists[mi] if use_heap_merge else positive_hits
            nlist = neg_lists[mi] if use_heap_merge else negative_hits
            num_occ = len(occ)
            read_pos = (read_hit >> 1) & U32
            if num_occ == 1:
                ref_hit = int(occ[0])
                cand = _candidate_position_from_hits(k, ref_hit, read_hit)
                if (ref_hit & 1) == (read_hit & 1):
                    plist.append(cand)
                else:
                    nlist.append(cand)
                continue
            if num_occ < max_seed_frequency:
                for ref_hit_np in occ:
                    ref_hit = int(ref_hit_np)
                    cand = _candidate_position_from_hits(k, ref_hit, read_hit)
                    if (ref_hit & 1) == (read_hit & 1):
                        if ((ref_hit >> 1) & U32) < read_pos:
                            sorted_flag = False
                        plist.append(cand)
                    else:
                        nlist.append(cand)
            if num_occ >= repetitive_seed_frequency:
                rep.update(read_pos)

        if use_heap_merge:
            if not sorted_flag:
                for lst in pos_lists:
                    lst.sort()
            positive_hits = list(heapq.merge(*pos_lists))
            negative_hits = list(heapq.merge(*neg_lists))
        else:
            positive_hits.sort()
            negative_hits.sort()
        return positive_hits, negative_hits, rep.length, rep.count

    # ------------- clustering (candidate_processor.cc:283-342) -------------

    def _cluster_hits(self, num_seeds_required: int, num_minimizers: int,
                      hits: List[int]) -> List[Candidate]:
        candidates: List[Candidate] = []
        hits = hits + [UMAX]
        if len(hits) <= 1:
            return candidates
        e = self.error_threshold
        minimizer_count = 1
        equal_count = 1
        best_equal_count = 1
        previous_hit = hits[0]
        prev_rid = previous_hit >> 32
        prev_pos = previous_hit & U32
        best_local_hit = hits[0]
        for pi in range(1, len(hits)):
            cur = hits[pi]
            cur_rid = cur >> 32
            cur_pos = cur & U32
            if (cur_rid != prev_rid or cur_pos > ((prev_pos + e) & U32)
                    or (minimizer_count >= num_minimizers
                        and cur_pos > ((best_local_hit + e) & U32))):
                if minimizer_count >= num_seeds_required:
                    # uint8 assignment wraps mod 256 in the reference
                    candidates.append(Candidate(position=best_local_hit,
                                                count=best_equal_count & 0xFF))
                minimizer_count = 1
                equal_count = 1
                best_equal_count = 1
                best_local_hit = cur
            else:
                if cur == best_local_hit:
                    equal_count += 1
                    best_equal_count += 1
                elif cur == previous_hit:
                    equal_count += 1
                    if equal_count > best_equal_count:
                        best_local_hit = previous_hit
                        best_equal_count = equal_count
                else:
                    equal_count = 1
                minimizer_count += 1
            previous_hit = cur
            prev_rid = cur_rid
            prev_pos = cur_pos
        return candidates

    # ---------------- main entry (candidate_processor.cc:12-71) ------------

    def generate(self, state: ReadSeedState) -> None:
        f0, f1 = self.max_seed_frequencies
        ph, nh, rep_len, rep_count = self._collect_hits(
            state.minimizers, max_seed_frequency=f0,
            repetitive_seed_frequency=f0, use_heap_merge=False)
        state.repetitive_seed_length = rep_len

        use_high_frequency = False
        if len(ph) + len(nh) == 0:
            ph, nh, rep_len, rep_count = self._collect_hits(
                state.minimizers, max_seed_frequency=f1,
                repetitive_seed_frequency=f0, use_heap_merge=True)
            state.repetitive_seed_length = rep_len
            use_high_frequency = True
            if len(ph) == 0 or len(nh) == 0:
                use_high_frequency = False

        num_required = len(state.minimizers) - rep_count
        num_required = max(num_required, 1)
        num_required = min(num_required, self.min_num_seeds)
        if use_high_frequency:
            num_required = self.min_num_seeds

        state.positive_hits = ph
        state.negative_hits = nh
        state.positive_candidates = self._cluster_hits(
            num_required, len(state.minimizers), ph)
        state.negative_candidates = self._cluster_hits(
            num_required, len(state.minimizers), nh)

    # ------------- mate rescue (index.cc:351-489, cp.cc:75-281) ------------

    def _rescue_hits_one_strand(self, strand_negative: bool, search_range: int,
                                minimizers: List[Tuple[int, int]],
                                mate_candidates: List[Candidate],
                                rep_accum_state: List[int]) -> Tuple[int, List[int]]:
        """Windowed occurrence search near mate candidates.

        Returns (max_minimizer_count or -max on abort, hits). Also adds to
        repetitive seed length via rep_accum_state=[length] in place.
        """
        index = self.index
        k = index.kmer_size
        f0 = self.max_seed_frequencies[0]

        max_count = 0
        best_candidate_num = 0
        for c in mate_candidates:
            if c.count > max_count:
                max_count = c.count
                best_candidate_num = 1
            elif c.count == max_count:
                best_candidate_num += 1

        too_many = (best_candidate_num >= 300 or len(mate_candidates) > f0)
        too_many_low_support = (max_count <= self.min_num_seeds
                                and best_candidate_num >= 200)
        if too_many or too_many_low_support:
            return -max_count, []

        boundaries: List[Tuple[int, int]] = []
        for c in mate_candidates:
            if c.count == max_count:
                start = 0 if c.position < search_range else c.position - search_range
                boundaries.append((start, c.position + search_range))
        if not boundaries:
            return max_count, []

        merged = [boundaries[0]]
        for b in boundaries[1:]:
            if merged[-1][1] < b[0]:
                merged.append(b)
            else:
                merged[-1] = (merged[-1][0], b[1])

        rep = RepetitiveSeedAccumulator(k, index.window_size)
        hits: List[int] = []
        want_same = not strand_negative  # kPositive wants same-strand hits
        want_bit = None  # computed per minimizer below
        for (mhash, read_hit) in minimizers:
            occ = index.lookup(mhash)
            if occ is None:
                continue
            read_pos = (read_hit >> 1) & U32
            if len(occ) == 1:
                ref_hit = int(occ[0])
                on_same = (ref_hit & 1) == (read_hit & 1)
                if on_same == want_same:
                    hits.append(_candidate_position_from_hits(k, ref_hit, read_hit))
                continue
            num_occ = len(occ)
            occ_cand = (occ >> np.uint64(1)).astype(np.int64)
            if want_same:
                strand_ok = (occ & np.uint64(1)) == np.uint64(read_hit & 1)
            else:
                strand_ok = (occ & np.uint64(1)) != np.uint64(read_hit & 1)
            prev_l = 0
            for (bstart, bend) in merged:
                # the reference's manual binary search: its final midpoint m
                # can land one entry *before* the boundary start, and the
                # collection scans forward from m -- reproduced exactly
                lo, m, hi = prev_l, 0, num_occ - 1
                while lo <= hi:
                    m = (lo + hi) // 2
                    cand_pos = int(occ_cand[m])
                    if cand_pos < bstart:
                        lo = m + 1
                    elif cand_pos > bstart:
                        hi = m - 1
                    else:
                        break
                prev_l = m
                end = int(np.searchsorted(occ_cand[m:], bend, side="right")) + m
                sel = np.flatnonzero(strand_ok[m:end]) + m
                if len(sel):
                    ref_pos = occ_cand[sel] & U32
                    if want_same:
                        starts = (ref_pos - read_pos) & U32
                    else:
                        starts = (ref_pos + read_pos - k + 1) & U32
                    rids = (occ[sel] >> np.uint64(33)).astype(np.int64)
                    cands = (rids << 32) | starts
                    hits.extend(int(c) for c in cands)
            if num_occ >= f0:
                rep.update(read_pos)
        hits.sort()
        rep_accum_state[0] = rep.length
        return max_count, hits

    def supplement_candidates(self, search_range: int,
                              state1: ReadSeedState, state2: ReadSeedState) -> int:
        """Mate rescue for both ends. Returns 1 if MAPQ should be forced to 0."""
        augment = {0: ([], []), 1: ([], [])}  # mate -> (aug_pos, aug_neg)
        ret = 0
        for mate, (state, mate_state) in enumerate(((state1, state2),
                                                    (state2, state1))):
            mm_count = len(state.minimizers)
            augment_flag = True
            for c in state.positive_candidates:
                if c.count >= mm_count // 2:
                    augment_flag = False
                    break
            if augment_flag:
                for c in state.negative_candidates:
                    if c.count >= mm_count // 2:
                        augment_flag = False
                        break
            if not augment_flag:
                continue

            positive_rescue_result = 0
            negative_rescue_result = 0
            aug_pos, aug_neg = augment[mate]
            if mate_state.positive_candidates:
                # Mate mapped on +: this read should map on -, search minus hits.
                rep_box = [state.repetitive_seed_length]
                positive_rescue_result, hits = self._rescue_hits_one_strand(
                    strand_negative=True, search_range=search_range,
                    minimizers=state.minimizers,
                    mate_candidates=mate_state.positive_candidates,
                    rep_accum_state=rep_box)
                state.repetitive_seed_length = rep_box[0]
                aug_neg.extend(self._cluster_hits(1, mm_count, hits))
            if mate_state.negative_candidates:
                rep_box = [state.repetitive_seed_length]
                negative_rescue_result, hits = self._rescue_hits_one_strand(
                    strand_negative=False, search_range=search_range,
                    minimizers=state.minimizers,
                    mate_candidates=mate_state.negative_candidates,
                    rep_accum_state=rep_box)
                state.repetitive_seed_length = rep_box[0]
                aug_pos.extend(self._cluster_hits(1, mm_count, hits))
            if (((positive_rescue_result < 0 and negative_rescue_result > 0
                  and -positive_rescue_result >= negative_rescue_result)
                 or (positive_rescue_result > 0 and negative_rescue_result < 0
                     and positive_rescue_result <= -negative_rescue_result))
                    and len(state.positive_candidates) + len(state.negative_candidates) == 0):
                ret = 1

        for mate, state in ((0, state1), (1, state2)):
            aug_pos, aug_neg = augment[mate]
            if aug_pos:
                state.positive_candidates = self._merge_candidates(
                    state.positive_candidates, aug_pos)
            if aug_neg:
                state.negative_candidates = self._merge_candidates(
                    state.negative_candidates, aug_neg)
        return ret

    def _merge_candidates(self, c1: List[Candidate],
                          c2: List[Candidate]) -> List[Candidate]:
        """Sorted merge deduping within error_threshold (cp.cc:344-414)."""
        if not c1:
            return c2
        e = self.error_threshold
        out: List[Candidate] = []

        def try_push(c: Candidate) -> None:
            if not out or c.position > out[-1].position + e:
                out.append(c)

        i = j = 0
        while i < len(c1) and j < len(c2):
            if c1[i].position == c2[j].position:
                if not out or c1[i].position > out[-1].position + e:
                    out.append(c1[i] if c1[i].count > c2[j].count else c2[j])
                i += 1
                j += 1
            elif c1[i].position < c2[j].position:
                try_push(c1[i])
                i += 1
            else:
                try_push(c2[j])
                j += 1
        while i < len(c1):
            try_push(c1[i])
            i += 1
        while j < len(c2):
            try_push(c2[j])
            j += 1
        return out

    # ------- paired-end intersection (candidate_processor.cc:416-484) -------

    def reduce_candidates_paired(self, max_insert_size: int,
                                 state1: ReadSeedState, state2: ReadSeedState) -> None:
        state1.move_candidates_to_buffer()
        state2.move_candidates_to_buffer()
        p1, n2 = self._reduce_one_direction(
            max_insert_size, state1.positive_candidates_buffer,
            state2.negative_candidates_buffer)
        n1, p2 = self._reduce_one_direction(
            max_insert_size, state1.negative_candidates_buffer,
            state2.positive_candidates_buffer)
        state1.positive_candidates = p1
        state1.negative_candidates = n1
        state2.positive_candidates = p2
        state2.negative_candidates = n2

    def _reduce_one_direction(self, dist: int, candidates1: List[Candidate],
                              candidates2: List[Candidate]
                              ) -> Tuple[List[Candidate], List[Candidate]]:
        filtered1: List[Candidate] = []
        filtered2: List[Candidate] = []
        i1 = i2 = 0
        num_unpaired1 = num_unpaired2 = 0
        threshold = 5
        max_count1 = 6
        max_count2 = 6
        previous_end_i2 = 0
        while i1 < len(candidates1) and i2 < len(candidates2):
            c1 = candidates1[i1]
            c2 = candidates2[i2]
            if c1.position > c2.position + dist:
                if (i2 >= previous_end_i2 and num_unpaired2 < threshold
                        and (c1.position >> 32) == (c2.position >> 32)
                        and c2.count >= max_count2):
                    filtered2.append(c2)
                    num_unpaired2 += 1
                i2 += 1
            elif c2.position > c1.position + dist:
                if (num_unpaired1 < threshold
                        and (c1.position >> 32) == (c2.position >> 32)
                        and c1.count >= max_count1):
                    filtered1.append(c1)
                    num_unpaired1 += 1
                i1 += 1
            else:
                filtered1.append(c1)
                if c1.count > max_count1:
                    max_count1 = c1.count
                current_i2 = i2
                while (current_i2 < len(candidates2)
                       and candidates2[current_i2].position <= c1.position + dist):
                    if current_i2 >= previous_end_i2:
                        filtered2.append(candidates2[current_i2])
                        if candidates2[current_i2].count > max_count2:
                            max_count2 = candidates2[current_i2].count
                    current_i2 += 1
                previous_end_i2 = current_i2
                i1 += 1
        return filtered1, filtered2
