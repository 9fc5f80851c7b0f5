"""Draft mapping generation (candidate verification) and best-mapping
selection with MAPQ.

Mirrors draft_mapping_generator.cc and mapping_generator.h. The reference's
SIMD lane grouping changes *which* candidates are verified (the per-group
count-threshold early exit), so the grouping semantics are reproduced here
even though this host path verifies lanes sequentially; the Pallas device
kernel batches the same groups across reads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .candidates import Candidate, ReadSeedState
from .verify import (banded_align, banded_align_dropoff,
                     banded_align_dropoff_3end, banded_traceback,
                     get_longest_match_length)

U32 = 0xFFFFFFFF


@dataclass
class DraftMapping:
    num_errors: int
    position: int  # (rid << 32) | ref_end_position

    @property
    def rid(self) -> int:
        return self.position >> 32

    @property
    def ref_position(self) -> int:
        return self.position & U32


@dataclass
class VerifyState:
    """Per-read verification results (MappingMetadata's alignment part)."""

    positive_mappings: List[DraftMapping] = field(default_factory=list)
    negative_mappings: List[DraftMapping] = field(default_factory=list)
    positive_split_sites: List[int] = field(default_factory=list)
    negative_split_sites: List[int] = field(default_factory=list)
    min_num_errors: int = 0
    num_best_mappings: int = 0
    second_min_num_errors: int = 0
    num_second_best_mappings: int = 0

    def num_draft_mappings(self) -> int:
        return len(self.positive_mappings) + len(self.negative_mappings)


class DraftMappingGenerator:
    def __init__(self, error_threshold: int, split_alignment: bool,
                 output_format: str):
        self.e = error_threshold
        self.split_alignment = split_alignment
        self.output_format = output_format
        if error_threshold < 8:
            self.num_vpu_lanes = 8
        elif error_threshold < 16:
            self.num_vpu_lanes = 4
        else:
            self.num_vpu_lanes = 0

    def _is_valid_candidate(self, rid: int, position: int, read_length: int,
                            ref_lengths: List[int]) -> bool:
        ref_len = ref_lengths[rid]
        if (position < self.e or position >= ref_len
                or position + read_length + self.e >= ref_len):
            return False
        return True

    def generate(self, read: bytes, negative_read: bytes,
                 seed_state: ReadSeedState, reference_seqs: List[bytes],
                 ref_lengths: List[int]) -> VerifyState:
        vs = VerifyState()
        vs.min_num_errors = self.e + 1
        vs.num_best_mappings = 0
        vs.second_min_num_errors = self.e + 1
        vs.num_second_best_mappings = 0

        num_minimizers = len(seed_state.minimizers)
        if not self.split_alignment and self._try_all_minimizer_shortcut(
                read, seed_state, num_minimizers, ref_lengths, vs):
            return vs

        seed_state.positive_candidates.sort(key=Candidate.sort_key)
        seed_state.negative_candidates.sort(key=Candidate.sort_key)

        if self.split_alignment:
            self._verify_scalar(False, read, negative_read, seed_state,
                                reference_seqs, ref_lengths, vs)
            self._verify_scalar(True, read, negative_read, seed_state,
                                reference_seqs, ref_lengths, vs)
            return vs

        for strand_negative, cands in ((False, seed_state.positive_candidates),
                                       (True, seed_state.negative_candidates)):
            if self.num_vpu_lanes == 0 or len(cands) < self.num_vpu_lanes:
                self._verify_scalar(strand_negative, read, negative_read,
                                    seed_state, reference_seqs, ref_lengths, vs)
            else:
                self._verify_grouped(strand_negative, read, negative_read,
                                     seed_state, reference_seqs, ref_lengths, vs)
        return vs

    # ---- shortcut when a single candidate is supported by all minimizers ----

    def _try_all_minimizer_shortcut(self, read: bytes, seed_state: ReadSeedState,
                                    num_minimizers: int, ref_lengths: List[int],
                                    vs: VerifyState) -> bool:
        if seed_state.num_candidates() != 1:
            return False
        read_length = len(read)
        hit_index = -1
        hit_strand_negative = False
        num_hits = 0
        for i, c in enumerate(seed_state.positive_candidates):
            if c.count == num_minimizers:
                hit_index = i
                num_hits += 1
        for i, c in enumerate(seed_state.negative_candidates):
            if c.count == num_minimizers:
                hit_index = i
                hit_strand_negative = True
                num_hits += 1
        if num_hits != 1:
            return False

        vs.min_num_errors = 0
        vs.num_best_mappings = 1
        vs.num_second_best_mappings = 0

        cands = (seed_state.negative_candidates if hit_strand_negative
                 else seed_state.positive_candidates)
        cand = cands[hit_index]
        rid = cand.rid
        if hit_strand_negative:
            position = (cand.ref_position - read_length + 1) & U32
        else:
            position = cand.ref_position
        if not self._is_valid_candidate(rid, position, read_length, ref_lengths):
            return False
        if hit_strand_negative:
            vs.negative_mappings.append(DraftMapping(0, cand.position))
        else:
            vs.positive_mappings.append(
                DraftMapping(0, (cand.position + read_length - 1) & 0xFFFFFFFFFFFFFFFF))
        return True

    # -------------------- shared best-counter update --------------------

    @staticmethod
    def _update_counters(vs: VerifyState, num_errors: int) -> None:
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

    # ----------------- grouped (SIMD-equivalent) verification ---------------

    def _verify_grouped(self, strand_negative: bool, read: bytes,
                        negative_read: bytes, seed_state: ReadSeedState,
                        reference_seqs: List[bytes], ref_lengths: List[int],
                        vs: VerifyState) -> None:
        e = self.e
        lanes = self.num_vpu_lanes
        cands = (seed_state.negative_candidates if strand_negative
                 else seed_state.positive_candidates)
        mappings = vs.negative_mappings if strand_negative else vs.positive_mappings
        read_length = len(read)
        text = negative_read if strand_negative else read

        group: List[Candidate] = []
        group_patterns: List[bytes] = []
        threshold = 0
        ci = 0
        while ci < len(cands):
            cand = cands[ci]
            if cand.count < threshold:
                break
            rid = cand.rid
            position = cand.ref_position
            if strand_negative:
                position = (position - read_length + 1) & U32
            if not self._is_valid_candidate(rid, position, read_length, ref_lengths):
                ci += 1
                continue
            ref = reference_seqs[rid]
            group.append(cand)
            group_patterns.append(ref[position - e: position - e + read_length + 2 * e])
            ci += 1
            if len(group) < lanes:
                continue

            for li in range(lanes):
                num_errors, end_pos = banded_align(e, group_patterns[li], text,
                                                   read_length)
                if num_errors <= e:
                    self._update_counters(vs, num_errors)
                    if strand_negative:
                        pos = (group[li].position - read_length + 1 - e + end_pos)
                    else:
                        pos = group[li].position - e + end_pos
                    mappings.append(DraftMapping(num_errors, pos))
                else:
                    threshold = group[li].count
            group = []
            group_patterns = []

        # tail: processed without threshold updates (dmg.cc:308-356)
        for li in range(len(group)):
            num_errors, end_pos = banded_align(e, group_patterns[li], text,
                                               read_length)
            if num_errors <= e:
                self._update_counters(vs, num_errors)
                if strand_negative:
                    pos = group[li].position - read_length + 1 - e + end_pos
                else:
                    pos = group[li].position - e + end_pos
                mappings.append(DraftMapping(num_errors, pos))

    # ------------------------- scalar verification --------------------------

    def _verify_scalar(self, strand_negative: bool, read: bytes,
                       negative_read: bytes, seed_state: ReadSeedState,
                       reference_seqs: List[bytes], ref_lengths: List[int],
                       vs: VerifyState) -> None:
        e = self.e
        cands = (seed_state.negative_candidates if strand_negative
                 else seed_state.positive_candidates)
        mappings = vs.negative_mappings if strand_negative else vs.positive_mappings
        split_sites = (vs.negative_split_sites if strand_negative
                       else vs.positive_split_sites)
        read_length = len(read)
        text = negative_read if strand_negative else read

        threshold = 0
        best_mapping_longest_match = 0
        for cand in cands:
            if cand.count < threshold:
                break
            rid = cand.rid
            position = cand.ref_position
            if strand_negative:
                position = (position - read_length + 1) & U32
            if not self._is_valid_candidate(rid, position, read_length, ref_lengths):
                continue
            ref = reference_seqs[rid]
            pattern = ref[position - e: position - e + read_length + 2 * e]

            mapping_end_position = read_length
            gap_beginning = 0
            allow_gap_beginning = 20 - e
            mapping_length_threshold = 30
            actual_num_errors = 0
            read_mapping_length = 0
            longest_match = 0

            if self.split_alignment:
                if not strand_negative:
                    num_errors, mapping_end_position, read_mapping_length = \
                        banded_align_dropoff(e, pattern, text, read_length)
                    if mapping_end_position < 0 and allow_gap_beginning > 0:
                        backup = (num_errors, -mapping_end_position,
                                  read_mapping_length)
                        pattern2 = ref[position - e + allow_gap_beginning:
                                       position - e + allow_gap_beginning
                                       + (read_length - allow_gap_beginning) + 2 * e]
                        num_errors, mapping_end_position, read_mapping_length = \
                            banded_align_dropoff(
                                e, pattern2, text[allow_gap_beginning:],
                                read_length - allow_gap_beginning)
                        if num_errors > e or mapping_end_position < 0:
                            num_errors, mapping_end_position, read_mapping_length = backup
                        else:
                            gap_beginning = allow_gap_beginning
                            mapping_end_position += gap_beginning
                            read_mapping_length += gap_beginning
                else:
                    num_errors, mapping_end_position, read_mapping_length = \
                        banded_align_dropoff_3end(e, pattern, text, read_length)
                    if mapping_end_position < 0 and allow_gap_beginning > 0:
                        backup = (num_errors, -mapping_end_position,
                                  read_mapping_length)
                        num_errors, mapping_end_position, read_mapping_length = \
                            banded_align_dropoff_3end(
                                e, pattern, text,
                                read_length - allow_gap_beginning)
                        if num_errors > e or mapping_end_position < 0:
                            num_errors, mapping_end_position, read_mapping_length = backup
                        else:
                            gap_beginning = allow_gap_beginning
                            mapping_end_position += gap_beginning
                            read_mapping_length += gap_beginning

                if (mapping_end_position + 1 - e - num_errors - gap_beginning
                        >= mapping_length_threshold):
                    actual_num_errors = num_errors
                    num_errors = -(mapping_end_position - e - num_errors
                                   - gap_beginning)
                    if len(cands) > 200:
                        ref_at = ref[position:position + read_length]
                        longest_match = get_longest_match_length(
                            ref_at, text, read_length)
                else:
                    num_errors = e + 1
                    actual_num_errors = e + 1
            else:
                num_errors, mapping_end_position = banded_align(
                    e, pattern, text, read_length)

            if num_errors <= e:
                if num_errors < vs.min_num_errors:
                    vs.second_min_num_errors = vs.min_num_errors
                    vs.num_second_best_mappings = vs.num_best_mappings
                    vs.min_num_errors = num_errors
                    vs.num_best_mappings = 1
                    if self.split_alignment:
                        if len(cands) > 50:
                            threshold = cand.count
                        else:
                            threshold = cand.count // 2
                        if (vs.second_min_num_errors < vs.min_num_errors + e // 2
                                and best_mapping_longest_match > longest_match
                                and len(cands) > 200):
                            vs.second_min_num_errors = vs.min_num_errors
                    best_mapping_longest_match = longest_match
                elif num_errors == vs.min_num_errors:
                    vs.num_best_mappings += 1
                elif num_errors == vs.second_min_num_errors:
                    vs.num_second_best_mappings += 1
                elif num_errors < vs.second_min_num_errors:
                    vs.num_second_best_mappings = 1
                    vs.second_min_num_errors = num_errors

                if not strand_negative:
                    mappings.append(DraftMapping(
                        num_errors, cand.position - e + mapping_end_position))
                else:
                    if self.split_alignment and self.output_format != "sam":
                        mappings.append(DraftMapping(
                            num_errors, cand.position - gap_beginning))
                    else:
                        mappings.append(DraftMapping(
                            num_errors, cand.position - read_length + 1 - e
                            + mapping_end_position))

                if self.split_alignment:
                    split_sites.append(((actual_num_errors & 0xFF) << 24)
                                       | ((gap_beginning & 0xFF) << 16)
                                       | (read_mapping_length & 0xFFFF))
