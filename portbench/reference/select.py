"""Best-mapping selection, reference start/end recovery, and MAPQ.

Mirrors mapping_generator.h: reservoir sampling of tied best mappings,
pair enumeration per strand combination, BandedTraceback-based position
recovery, and the (deliberately quirky, parity-critical) MAPQ formulas
including uint8 wrap-around behavior.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from .config import MappingConfig
from .candidates import ReadSeedState
from .generate import DraftMapping, VerifyState
from .records import PEBedRecord, PairsRecord, clip_mapq
from .rng import MT19937, uniform_int
from .verify import banded_align, banded_traceback

U32 = 0xFFFFFFFF


def _u8(x: int) -> int:
    return x & 0xFF


def _trunc(x: float) -> int:
    return int(x)  # C++ double->int conversion truncates toward zero


@dataclass
class MappingInMem:
    read_id: int = 0
    rid: int = 0
    ref_start: int = 0
    ref_end: int = 0
    strand_negative: bool = False
    mapq: int = 0
    read_name: bytes = b""
    read_length: int = 0
    barcode_key: int = 0
    is_unique: bool = True
    sequence: bytes = b""
    read_split_site: int = 0

    def fragment_length(self) -> int:
        return (self.ref_end - self.ref_start + 1) & 0xFFFF

    def strand_bit(self) -> int:
        return 0 if self.strand_negative else 1


def adjust_gap_beginning(strand_negative: bool, ref: bytes, read: bytes,
                         gap_beginning: int, read_end: int,
                         ref_start_position: int, ref_end_position: int
                         ) -> Tuple[int, int]:
    """Extend through the 5' gap by direct base comparison
    (alignment.cc:24-83). Returns (new_gap_beginning, new_ref_boundary)."""
    def eq(a: int, b: int) -> bool:
        # read[i] == ref[j] allowing lowercase reference
        return a == b or a == (b - 0x61 + 0x41 if 0x61 <= b <= 0x7A else -1)

    if not strand_negative:
        if gap_beginning <= 0:
            return gap_beginning, ref_start_position
        i = gap_beginning - 1
        j = ref_start_position - 1
        while i >= 0 and j >= 0:
            if not eq(read[i], ref[j]):
                break
            i -= 1
            j -= 1
        return i + 1, j + 1

    if gap_beginning <= 0:
        return gap_beginning, ref_end_position
    i = read_end + 1
    j = ref_end_position + 1
    while i < len(read) and j < len(ref):
        if not eq(read[i], ref[j]):
            break
        i += 1
        j += 1
    new_gap = gap_beginning + i - (read_end + 1)
    return new_gap, j - 1


class BestMappingSelector:
    def __init__(self, cfg: MappingConfig, reference_seqs: List[bytes],
                 ref_lengths: List[int],
                 pairs_custom_rid_rank: Optional[List[int]] = None):
        self.cfg = cfg
        self.reference_seqs = reference_seqs
        self.ref_lengths = ref_lengths
        self.pairs_custom_rid_rank = pairs_custom_rid_rank

    # ------------------- position recovery (mg.h:655-917) -------------------

    def get_ref_start_end(self, mapping: DraftMapping, mm: MappingInMem) -> None:
        cfg = self.cfg
        e = cfg.error_threshold
        rid = mapping.rid
        ref_position = mapping.ref_position
        ref = self.reference_seqs[rid]
        ref_len = self.ref_lengths[rid]

        full_read_length = mm.read_length
        read_length = mm.read_length
        min_num_errors = mapping.num_errors

        split_site = 0 if not mm.strand_negative else mm.read_length
        gap_beginning = 0
        actual_num_errors = 0
        if cfg.split_alignment:
            split_site = mm.read_split_site & 0xFFFF
            gap_beginning = (mm.read_split_site >> 16) & 0xFF
            actual_num_errors = (mm.read_split_site >> 24) & 0xFF
            read_length = split_site - gap_beginning

        if ref_position + 1 > read_length + e:
            vws = ref_position + 1 - read_length - e
        else:
            vws = 0
        if ref_position + e >= ref_len:
            vws = (ref_len - e - read_length) & U32
        # The reference's < 0 check is dead code (vws is uint32); extreme
        # cases would index out of bounds there (UB). We clamp for safety.
        if vws > ref_len:
            vws = 0

        if not mm.strand_negative:
            if not cfg.split_alignment:
                start = banded_traceback(e, min_num_errors, ref[vws:],
                                         mm.sequence, read_length)
            else:
                start = banded_traceback(e, actual_num_errors, ref[vws:],
                                         mm.sequence[gap_beginning:], read_length)
            if gap_beginning > 0:
                gap_beginning, new_ref_start = adjust_gap_beginning(
                    False, ref, mm.sequence, gap_beginning, read_length - 1,
                    vws + start, ref_position)
                start = new_ref_start - vws
            mm.ref_start = vws + start
            mm.ref_end = ref_position
            return

        read_start_site = full_read_length - split_site
        start = e
        end = ref_position - vws + 1
        if not cfg.split_alignment:
            start = banded_traceback(e, min_num_errors, ref[vws:],
                                     mm.sequence[read_start_site:], read_length)
        else:
            _, end_pos = banded_align(e, ref[vws:vws + read_length + 2 * e],
                                      mm.sequence[read_start_site:], read_length)
            end = end_pos + 1
        if gap_beginning > 0:
            gap_beginning, new_ref_end = adjust_gap_beginning(
                True, ref, mm.sequence[read_start_site:], gap_beginning,
                read_length - 1, vws + start, vws + end)
            end = new_ref_end - vws + 1
        mm.ref_start = vws + start
        mm.ref_end = vws + end - 1

    # --------------------------- MAPQ (mg.h:919-1192) -----------------------

    def mapq_single_end(self, strand_negative: bool, num_errors: int,
                        alignment_length: int, read_length: int,
                        max_num_error_difference: int, vs: VerifyState,
                        seed_state: ReadSeedState) -> int:
        cfg = self.cfg
        mapq_coef_length = 50
        mapq_coef_fraction = int(math.log(mapq_coef_length))

        if not cfg.split_alignment:
            alignment_length = max(alignment_length, read_length)

        alignment_identity = 1.0 - num_errors / alignment_length
        if cfg.split_alignment:
            alignment_identity = (-num_errors) / alignment_length
            if alignment_identity > 1:
                alignment_identity = 1.0

        mapq = 0
        second_min_num_errors = vs.second_min_num_errors
        if vs.num_best_mappings <= 1:
            if second_min_num_errors > num_errors + max_num_error_difference:
                second_min_num_errors = num_errors + max_num_error_difference
            tmp = (1.0 if alignment_length < mapq_coef_length
                   else mapq_coef_fraction / math.log(alignment_length))
            tmp *= alignment_identity * alignment_identity
            mapq = _trunc(5 * 6.02 * (second_min_num_errors - num_errors)
                          * tmp * tmp + 0.499)

        if vs.num_second_best_mappings > 0:
            mapq -= _trunc(4.343 * math.log(vs.num_second_best_mappings + 1)
                           + 0.499)
        if mapq > 60:
            mapq = 60
        if mapq < 0:
            mapq = 0

        rep_len = seed_state.repetitive_seed_length
        if rep_len > 0:
            frac_rep = rep_len / read_length
            if rep_len >= read_length:
                frac_rep = 0.999
            if alignment_identity <= 0.95:
                mapq = _trunc(mapq * (1 - math.sqrt(frac_rep)) + 0.499)
            elif alignment_identity <= 0.97:
                mapq = _trunc(mapq * (1 - frac_rep) + 0.499)
            elif alignment_identity >= 0.999:
                mapq = _trunc(mapq * (1 - frac_rep * frac_rep * frac_rep
                                      * frac_rep) + 0.499)
            else:
                mapq = _trunc(mapq * (1 - frac_rep * frac_rep) + 0.499)

        if (cfg.split_alignment
                and alignment_length < read_length - cfg.error_threshold
                and second_min_num_errors != num_errors):
            if (rep_len >= alignment_length and rep_len < read_length
                    and alignment_length < read_length // 3):
                mapq = 0
            diff = second_min_num_errors - num_errors
            num_candidates = (len(seed_state.negative_candidates)
                              if strand_negative
                              else len(seed_state.positive_candidates))
            if (second_min_num_errors - num_errors
                    <= cfg.error_threshold * 3 // 4 and num_candidates >= 5):
                mapq -= num_candidates // 5 // diff
            if mapq < 0:
                mapq = 0
            if (vs.num_second_best_mappings > 0
                    and second_min_num_errors - num_errors
                    <= cfg.error_threshold * 3 // 4):
                mapq //= vs.num_second_best_mappings // diff + 1
        return _u8(mapq)

    def mapq_paired_end(self, first_strand_negative: bool,
                        second_strand_negative: bool, read1_num_errors: int,
                        read2_num_errors: int, read1_alignment_length: int,
                        read2_alignment_length: int, read1_length: int,
                        read2_length: int, force_mapq: int,
                        pe_state: "PairedVerifyState",
                        seed1: ReadSeedState, seed2: ReadSeedState
                        ) -> Tuple[int, int, int]:
        """Returns (mapq, mapq1, mapq2)."""
        cfg = self.cfg
        vs1 = pe_state.vs1
        vs2 = pe_state.vs2

        mapq_pe = 0
        min_num_unpaired_sum_errors = (vs1.min_num_errors + vs2.min_num_errors
                                       + 3)
        if pe_state.num_best_mappings <= 1:
            adjusted_second = min(pe_state.second_min_sum_errors,
                                  min_num_unpaired_sum_errors)
            mapq_pe = _u8(_trunc(5 * 6.02 * (adjusted_second
                                             - pe_state.min_sum_errors) / 1
                                 + 0.499))
            if pe_state.num_second_best_mappings > 0:
                mapq_pe = _u8(mapq_pe - _trunc(
                    4.343 * math.log(pe_state.num_second_best_mappings + 1)
                    + 0.499))
            if mapq_pe > 60:
                mapq_pe = 60

            rep_len = (seed1.repetitive_seed_length
                       + seed2.repetitive_seed_length)
            if rep_len > 0:
                total_read_length = float(read1_length + read2_length)
                frac_rep = rep_len / total_read_length
                if rep_len >= total_read_length:
                    frac_rep = 0.999
                id1 = 1.0 - read1_num_errors / max(read1_length,
                                                   read1_alignment_length)
                id2 = 1.0 - read2_num_errors / max(read2_length,
                                                   read2_alignment_length)
                identity = min(id1, id2)
                if identity <= 0.95:
                    mapq_pe = _u8(_trunc(mapq_pe * (1 - math.sqrt(frac_rep))
                                         + 0.499))
                elif identity <= 0.97:
                    mapq_pe = _u8(_trunc(mapq_pe * (1 - frac_rep) + 0.499))
                elif identity >= 0.999:
                    mapq_pe = _u8(_trunc(mapq_pe * (1 - frac_rep ** 4) + 0.499))
                else:
                    mapq_pe = _u8(_trunc(mapq_pe * (1 - frac_rep * frac_rep)
                                         + 0.499))

        mapq1 = self.mapq_single_end(first_strand_negative, read1_num_errors,
                                     read1_alignment_length, read1_length, 2,
                                     vs1, seed1)
        mapq2 = self.mapq_single_end(second_strand_negative, read2_num_errors,
                                     read2_alignment_length, read2_length, 2,
                                     vs2, seed2)

        if not cfg.split_alignment:
            if mapq1 > mapq_pe:
                pass
            elif mapq_pe < mapq1 + mapq_pe * 0.65:
                mapq1 = _u8(_trunc(float(mapq_pe)))
            else:
                mapq1 = _u8(_trunc(mapq1 + mapq_pe * 0.65))
            if mapq2 > mapq_pe:
                pass
            elif mapq_pe < mapq2 + mapq_pe * 0.65:
                mapq2 = _u8(_trunc(float(mapq_pe)))
            else:
                mapq2 = _u8(_trunc(mapq2 + mapq_pe * 0.65))

        mapq1 = _u8(_trunc(mapq1 * 1.2))
        if mapq1 > 60:
            mapq1 = 60
        mapq2 = _u8(_trunc(mapq2 * 1.2))
        if mapq2 > 60:
            mapq2 = 60

        mapq = min(mapq1, mapq2)
        if mapq < 60 and 0 <= force_mapq < mapq:
            mapq = force_mapq
        return mapq, mapq1, mapq2

    # -------------------- paired-end selection (mg.h:159-653) ---------------

    def select_paired_end(self, pair_ctx: "PairContext",
                          pe_state: "PairedVerifyState",
                          generator: MT19937, force_mapq: int,
                          emit: Callable[[int, object], None],
                          forced_best: Optional[int] = None) -> None:
        """`forced_best` (not in the original) reports that tied best
        mapping instead of drawing one from `generator`, so that a caller
        can enumerate every mapping a random draw could report."""
        cfg = self.cfg
        pe_state.min_sum_errors = 2 * cfg.error_threshold + 1
        pe_state.num_best_mappings = 0
        pe_state.second_min_sum_errors = 2 * cfg.error_threshold + 1
        pe_state.num_second_best_mappings = 0

        directions = [(False, True), (True, False)]
        if cfg.split_alignment:
            directions += [(False, False), (True, True)]

        for (f_neg, s_neg) in directions[:2]:
            self._enumerate_pairs(f_neg, s_neg, pair_ctx, pe_state)
        if cfg.split_alignment:
            for (f_neg, s_neg) in directions[2:]:
                self._enumerate_pairs(f_neg, s_neg, pair_ctx, pe_state)

        if pe_state.num_best_mappings > cfg.drop_repetitive_reads:
            return

        best_indices = list(range(cfg.max_num_best_mappings))
        if forced_best is not None:
            best_indices = [forced_best]
        elif pe_state.num_best_mappings > cfg.max_num_best_mappings:
            for i in range(cfg.max_num_best_mappings,
                           pe_state.num_best_mappings):
                j = uniform_int(generator, 0, i)
                if j < cfg.max_num_best_mappings:
                    best_indices[j] = i
            best_indices.sort()

        to_report = min(cfg.max_num_best_mappings, pe_state.num_best_mappings)
        counters = [0, 0]
        for di, (f_neg, s_neg) in enumerate(directions):
            if di > 0 and counters[1] == to_report:
                break
            self._process_pe_direction(f_neg, s_neg, pair_ctx, pe_state,
                                       best_indices, counters, to_report,
                                       force_mapq, emit)

    def _enumerate_pairs(self, first_negative: bool, second_negative: bool,
                         ctx: "PairContext", pe: "PairedVerifyState") -> None:
        cfg = self.cfg
        min_overlap = cfg.min_read_length
        m1 = (ctx.vs1.negative_mappings if first_negative
              else ctx.vs1.positive_mappings)
        m2 = (ctx.vs2.negative_mappings if second_negative
              else ctx.vs2.positive_mappings)
        best = pe.best_mappings(first_negative, second_negative)

        if cfg.split_alignment:
            if not m1 or not m2:
                return
            for i1, dm1 in enumerate(m1):
                if dm1.num_errors != ctx.vs1.min_num_errors:
                    continue
                for i2, dm2 in enumerate(m2):
                    if dm2.num_errors != ctx.vs2.min_num_errors:
                        continue
                    best.append((i1, i2))
                    pe.min_sum_errors = (ctx.vs1.min_num_errors
                                         + ctx.vs2.min_num_errors)
                    pe.num_best_mappings += 1
            return

        read1_length = ctx.read1_length
        read2_length = ctx.read2_length
        i1 = i2 = 0
        while i1 < len(m1) and i2 < len(m2):
            p1 = m1[i1].position
            p2 = m2[i2].position
            if ((first_negative and p1 > p2 + cfg.max_insert_size - read2_length)
                    or (not first_negative
                        and p1 > p2 + read1_length - min_overlap)):
                i2 += 1
            elif ((not first_negative
                   and p2 > p1 + cfg.max_insert_size - read1_length)
                  or (first_negative
                      and p2 > p1 + read2_length - min_overlap)):
                i1 += 1
            else:
                current_i2 = i2
                while current_i2 < len(m2):
                    pc2 = m2[current_i2].position
                    in_range = ((not first_negative
                                 and pc2 <= p1 + cfg.max_insert_size
                                 - read1_length)
                                or (first_negative
                                    and pc2 <= p1 + read2_length - min_overlap))
                    if not in_range:
                        break
                    cur_sum = m1[i1].num_errors + m2[current_i2].num_errors
                    if cur_sum < pe.min_sum_errors:
                        pe.second_min_sum_errors = pe.min_sum_errors
                        pe.num_second_best_mappings = pe.num_best_mappings
                        pe.min_sum_errors = cur_sum
                        pe.num_best_mappings = 1
                        best.clear()
                        best.append((i1, current_i2))
                    elif cur_sum == pe.min_sum_errors:
                        pe.num_best_mappings += 1
                        best.append((i1, current_i2))
                    elif cur_sum == pe.second_min_sum_errors:
                        pe.num_second_best_mappings += 1
                    elif cur_sum < pe.second_min_sum_errors:
                        pe.second_min_sum_errors = cur_sum
                        pe.num_second_best_mappings = 1
                    current_i2 += 1
                i1 += 1

    def _process_pe_direction(self, first_negative: bool, second_negative: bool,
                              ctx: "PairContext", pe: "PairedVerifyState",
                              best_indices: List[int], counters: List[int],
                              to_report: int, force_mapq: int,
                              emit: Callable[[int, object], None]) -> None:
        cfg = self.cfg
        m1 = (ctx.vs1.negative_mappings if first_negative
              else ctx.vs1.positive_mappings)
        m2 = (ctx.vs2.negative_mappings if second_negative
              else ctx.vs2.positive_mappings)
        ss1 = (ctx.vs1.negative_split_sites if first_negative
               else ctx.vs1.positive_split_sites)
        ss2 = (ctx.vs2.negative_split_sites if second_negative
               else ctx.vs2.positive_split_sites)
        best = pe.best_mappings(first_negative, second_negative)

        is_unique = 1 if (pe.num_best_mappings == 1
                          or ctx.vs1.num_best_mappings == 1
                          or ctx.vs2.num_best_mappings == 1) else 0

        mm1 = MappingInMem(read_id=ctx.read_id, read_name=ctx.read1_name,
                           read_length=ctx.read1_length,
                           barcode_key=ctx.barcode_key,
                           strand_negative=first_negative)
        mm2 = MappingInMem(read_id=ctx.read_id, read_name=ctx.read2_name,
                           read_length=ctx.read2_length,
                           barcode_key=ctx.barcode_key,
                           strand_negative=second_negative)

        for (i1, i2) in best:
            cur_sum = m1[i1].num_errors + m2[i2].num_errors
            if cur_sum > pe.min_sum_errors:
                continue
            if counters[0] == best_indices[counters[1]]:
                mm1.rid = m1[i1].rid
                mm2.rid = m2[i2].rid
                mm1.sequence = (ctx.negative_read1 if first_negative
                                else ctx.read1)
                mm2.sequence = (ctx.negative_read2 if second_negative
                                else ctx.read2)
                if cfg.split_alignment:
                    mm1.read_split_site = ss1[i1]
                    mm2.read_split_site = ss2[i2]
                self.get_ref_start_end(m1[i1], mm1)
                self.get_ref_start_end(m2[i2], mm2)
                mapq, mapq1, mapq2 = self.mapq_paired_end(
                    first_negative, second_negative, m1[i1].num_errors,
                    m2[i2].num_errors, mm1.fragment_length(),
                    mm2.fragment_length(), ctx.read1_length, ctx.read2_length,
                    force_mapq, pe, ctx.seed1, ctx.seed2)
                mm1.mapq = mapq
                mm2.mapq = mapq
                mm1.is_unique = bool(is_unique)
                mm2.is_unique = bool(is_unique)
                self._emit_pe_record(mm1, mm2, mapq1, mapq2, ctx, emit)
                counters[1] += 1
                if counters[1] == min(cfg.max_num_best_mappings,
                                      pe.num_best_mappings):
                    break
            counters[0] += 1

    def _emit_pe_record(self, mm1: MappingInMem, mm2: MappingInMem,
                        mapq1: int, mapq2: int, ctx: "PairContext",
                        emit: Callable[[int, object], None]) -> None:
        cfg = self.cfg
        fmt = cfg.output_format
        first_positive = not mm1.strand_negative
        if first_positive:
            frag_start = mm1.ref_start
            frag_length = (mm2.ref_end - mm1.ref_start + 1) & 0xFFFF
        else:
            frag_start = mm2.ref_start
            frag_length = (mm1.ref_end - mm2.ref_start + 1) & 0xFFFF
        pos_alen = (mm1.fragment_length() if first_positive
                    else mm2.fragment_length())
        neg_alen = (mm1.fragment_length() if mm1.strand_negative
                    else mm2.fragment_length())
        direction = 1 if first_positive else 0
        is_unique = 1 if mm1.is_unique else 0

        if fmt in ("bed", "tagalign"):
            emit(mm1.rid, PEBedRecord(
                read_id=mm1.read_id, barcode=mm1.barcode_key,
                start=frag_start, length=frag_length,
                mapq=clip_mapq(mm1.mapq), direction=direction,
                is_unique=is_unique, num_dups=1,
                positive_alignment_length=pos_alen,
                negative_alignment_length=neg_alen,
                has_barcode=ctx.has_barcode))
            return
        if fmt == "pairs":
            strand1 = mm1.strand_bit()
            strand2 = mm2.strand_bit()
            position1 = (mm1.ref_end if mm1.strand_negative else mm1.ref_start)
            position2 = (mm2.ref_end if mm2.strand_negative else mm2.ref_start)
            rid1, rid2 = mm1.rid, mm2.rid
            rank = self.pairs_custom_rid_rank
            rid1_rank = rank[rid1] if rank else rid1
            rid2_rank = rank[rid2] if rank else rid2
            is_rid1_smaller = (rid1_rank < rid2_rank
                               or (rid1 == rid2 and position1 < position2))
            if not is_rid1_smaller:
                rid1, rid2 = rid2, rid1
                position1, position2 = position2, position1
                strand1, strand2 = strand2, strand1
            emit(rid1, PairsRecord(
                read_id=mm1.read_id, read_name=mm1.read_name,
                barcode=mm1.barcode_key, rid1=rid1, rid2=rid2, pos1=position1,
                pos2=position2, strand1=strand1, strand2=strand2,
                mapq=mm1.mapq & 0xFF, is_unique=is_unique, num_dups=1))
            return
        raise ValueError(f"Paired-end selection does not support {fmt}")


@dataclass
class PairedVerifyState:
    vs1: VerifyState
    vs2: VerifyState
    min_sum_errors: int = 0
    second_min_sum_errors: int = 0
    num_best_mappings: int = 0
    num_second_best_mappings: int = 0
    f1r2: List[Tuple[int, int]] = field(default_factory=list)
    f2r1: List[Tuple[int, int]] = field(default_factory=list)
    f1f2: List[Tuple[int, int]] = field(default_factory=list)
    r1r2: List[Tuple[int, int]] = field(default_factory=list)

    def best_mappings(self, first_negative: bool, second_negative: bool):
        if not first_negative:
            return self.f1f2 if not second_negative else self.f1r2
        return self.f2r1 if not second_negative else self.r1r2


@dataclass
class PairContext:
    read_id: int
    read1_name: bytes
    read2_name: bytes
    read1: bytes
    read2: bytes
    negative_read1: bytes
    negative_read2: bytes
    read1_length: int
    read2_length: int
    qual1: Optional[bytes]
    qual2: Optional[bytes]
    barcode_key: int
    has_barcode: bool
    seed1: ReadSeedState
    seed2: ReadSeedState
    vs1: VerifyState
    vs2: VerifyState
