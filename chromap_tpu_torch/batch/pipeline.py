"""Batched mapping pipeline: vectorized seeding + device verification with
exact per-read fallback.

This path handles the bulk non-split formats (BED/TagAlign/PAF). Reads that
trigger sequential-only seeding behavior (tie minimizers, cluster split
conditions, mate-rescue supplementation, high-frequency retry) are remapped
through the exact per-read path, so batch output is bit-identical to the
reference pipeline.

The Myers batch runs on cfg.torch_device under --device (kernel B, or its
plain version on the CPU) and in numpy otherwise. `seconds` splits the
mapper's wall time: seeding (minimizers and candidates), the pattern and
text gather, the Myers calls (transfers included), and the total, whose
rest is classification, replay, selection, traceback and emission.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..config import MappingConfig
from ..index.index import MinimizerIndex
from ..io.fastx import SequenceRecord
from ..mapping.candidates import Candidate, CandidateGenerator, ReadSeedState
from ..mapping.generate import DraftMappingGenerator, VerifyState
from ..mapping.rng import MT19937
from ..mapping.select import BestMappingSelector, PairContext, PairedVerifyState
from ..ops.minimizer_vector import (BatchMinimizers,
                                    batch_extract_minimizer_arrays)
from ..utils import encode_sequence
from .seeding import BatchCandidates, BatchSeeder
from .verify import gather_pattern_codes, myers_batch, replay_read

U32 = 0xFFFFFFFF


class BatchMapper:
    def __init__(self, cfg: MappingConfig, index: MinimizerIndex,
                 reference_seqs: List[bytes], ref_lengths: List[int],
                 selector: BestMappingSelector,
                 candidate_generator: CandidateGenerator,
                 draft_generator: DraftMappingGenerator):
        self.cfg = cfg
        self.index = index
        self.ref_lengths = ref_lengths
        self.selector = selector
        self.candidate_generator = candidate_generator
        self.draft_generator = draft_generator
        self.seeder = BatchSeeder(index, cfg.error_threshold,
                                  cfg.min_num_seeds_required_for_mapping,
                                  tuple(cfg.max_seed_frequencies))
        # concatenated reference codes for vectorized pattern gathers
        self.ref_offsets = np.zeros(len(reference_seqs) + 1, dtype=np.int64)
        np.cumsum(ref_lengths, out=self.ref_offsets[1:])
        self.ref_codes = np.concatenate(
            [encode_sequence(s) for s in reference_seqs]) \
            if reference_seqs else np.empty(0, np.uint8)
        self.ref_raw = (np.frombuffer(b"".join(reference_seqs), dtype=np.uint8)
                        if reference_seqs else np.empty(0, np.uint8))
        self.ref_lengths_arr = np.asarray(ref_lengths, dtype=np.int64)
        self.device = cfg.torch_device if cfg.use_device else None
        self.seconds = dict(seed=0.0, gather=0.0, myers=0.0, total=0.0)

        self.stats_num_candidates = 0
        self.stats_num_mappings = 0
        self.stats_num_mapped_reads = 0
        self.stats_num_uniquely_mapped = 0
        self.stats_cache_hits_batch = 0
        self._cache = None
        self._cache_update_threshold = 0
        self._fallback_history = {}

    # ------------------------------------------------------------------
    def _candidates_from_arrays(self, bc: BatchCandidates,
                                i: int) -> Tuple[List[Candidate], List[Candidate]]:
        ps, pn = int(bc.pos_starts[i]), int(bc.pos_nums[i])
        ns, nn = int(bc.neg_starts[i]), int(bc.neg_nums[i])
        pos = [Candidate(int(bc.pos_positions[j]), int(bc.pos_counts[j]))
               for j in range(ps, ps + pn)]
        neg = [Candidate(int(bc.neg_positions[j]), int(bc.neg_counts[j]))
               for j in range(ns, ns + nn)]
        return pos, neg

    def _needs_supplement(self, bc: BatchCandidates, bm: BatchMinimizers,
                          i: int) -> bool:
        """augment_flag: no candidate supported by >= half the minimizers
        (candidate_processor.cc:135-155)."""
        half = int(bm.counts[i]) // 2
        ps, pn = int(bc.pos_starts[i]), int(bc.pos_nums[i])
        for j in range(ps, ps + pn):
            if bc.pos_counts[j] >= half:
                return False
        ns, nn = int(bc.neg_starts[i]), int(bc.neg_nums[i])
        for j in range(ns, ns + nn):
            if bc.neg_counts[j] >= half:
                return False
        return True

    def _candidates_need_supplement(self, state: ReadSeedState,
                                    bm: BatchMinimizers, i: int) -> bool:
        half = int(bm.counts[i]) // 2
        for c in state.positive_candidates:
            if c.count >= half:
                return False
        for c in state.negative_candidates:
            if c.count >= half:
                return False
        return True

    # ------------------------------------------------------------------
    def map_pairs(self, batch1: List[SequenceRecord],
                  batch2: List[SequenceRecord], generator: MT19937,
                  emit: Callable[[int, object], None],
                  trim: bool, cache=None,
                  cache_update_threshold: int = 0) -> None:
        t0 = time.perf_counter()
        try:
            self._map_pairs(batch1, batch2, generator, emit, trim, cache,
                            cache_update_threshold)
        finally:
            self.seconds["total"] += time.perf_counter() - t0

    def _map_pairs(self, batch1, batch2, generator, emit, trim, cache,
                   cache_update_threshold) -> None:
        from ..pipeline import trim_adapter_paired

        cfg = self.cfg
        n_pairs = len(batch1)
        active: List[int] = []
        for i, (r1, r2) in enumerate(zip(batch1, batch2)):
            if (r1.length < cfg.min_read_length
                    or r2.length < cfg.min_read_length):
                continue
            r1.prepare_negative()
            r2.prepare_negative()
            if trim:
                trim_adapter_paired(r1, r2, cfg.min_read_length)
            active.append(i)
        if not active:
            return

        reads1 = [batch1[i].codes() for i in active]
        reads2 = [batch2[i].codes() for i in active]
        k = self.index.kmer_size
        w = self.index.window_size
        t0 = time.perf_counter()
        bm1 = batch_extract_minimizer_arrays(reads1, k, w)
        bm2 = batch_extract_minimizer_arrays(reads2, k, w)
        bc1 = self.seeder.generate(bm1, len(active))
        bc2 = self.seeder.generate(bm2, len(active))
        self.seconds["seed"] += time.perf_counter() - t0

        def cache_query(bm: BatchMinimizers, a: int, read_len: int):
            if cache is None or bm.counts[a] == 0:
                return -1, None, None, 0
            s = int(bm.starts[a])
            c = int(bm.counts[a])
            return cache.query(bm.hashes[s:s + c], bm.hits[s:s + c], read_len)

        # classify pairs: batch-eligible vs exact fallback
        seed_states: List[Optional[Tuple[ReadSeedState, ReadSeedState]]] = []
        fallback_flags = np.zeros(len(active), dtype=bool)
        force_mapqs = np.full(len(active), -1, dtype=np.int64)
        history: List[Tuple[int, tuple]] = []  # (pair order preserved)
        for a in range(len(active)):
            i = active[a]
            if bm1.counts[a] == 0 or bm2.counts[a] == 0:
                seed_states.append(None)
                continue
            q1, cpos1, cneg1, crep1 = cache_query(bm1, a, batch1[i].length)
            q2, cpos2, cneg2, crep2 = cache_query(bm2, a, batch2[i].length)
            if (q1 == -1 and bc1.needs_fallback[a]) \
                    or (q2 == -1 and bc2.needs_fallback[a]):
                # the exact path re-queries the cache itself and does its own
                # hit counting / history recording
                fallback_flags[a] = True
                seed_states.append(None)
                continue
            if q1 >= 0 or q2 >= 0:
                self.stats_cache_hits_batch += 1
            s1 = ReadSeedState()
            s2 = ReadSeedState()
            if q1 >= 0:
                s1.positive_candidates = cpos1
                s1.negative_candidates = cneg1
                s1.repetitive_seed_length = crep1
            else:
                s1.positive_candidates, s1.negative_candidates = \
                    self._candidates_from_arrays(bc1, a)
                s1.repetitive_seed_length = int(bc1.repetitive_seed_length[a])
            if q2 >= 0:
                s2.positive_candidates = cpos2
                s2.negative_candidates = cneg2
                s2.repetitive_seed_length = crep2
            else:
                s2.positive_candidates, s2.negative_candidates = \
                    self._candidates_from_arrays(bc2, a)
                s2.repetitive_seed_length = int(bc2.repetitive_seed_length[a])
            if cache is not None and i < cache_update_threshold:
                sa1, ca1 = int(bm1.starts[a]), int(bm1.counts[a])
                sa2, ca2 = int(bm2.starts[a]), int(bm2.counts[a])
                history.append((i, (
                    (bm1.hashes[sa1:sa1 + ca1], bm1.hits[sa1:sa1 + ca1],
                     s1.positive_candidates, s1.negative_candidates,
                     s1.repetitive_seed_length),
                    (bm2.hashes[sa2:sa2 + ca2], bm2.hits[sa2:sa2 + ca2],
                     s2.positive_candidates, s2.negative_candidates,
                     s2.repetitive_seed_length))))
            n1 = s1.num_candidates()
            n2 = s2.num_candidates()
            if not cfg.split_alignment:
                sup1 = self._candidates_need_supplement(s1, bm1, a) and n2 > 0
                sup2 = self._candidates_need_supplement(s2, bm2, a) and n1 > 0
                if sup1 or sup2:
                    # mate rescue in place; minimizer lists needed
                    s1.minimizers = bm1.read_minimizers(a)
                    s2.minimizers = bm2.read_minimizers(a)
                    result = self.candidate_generator.supplement_candidates(
                        2 * cfg.max_insert_size, s1, s2)
                    if result != 0:
                        force_mapqs[a] = 0
                    n1 = s1.num_candidates()
                    n2 = s2.num_candidates()
            if n1 > 0 and n2 > 0 and not cfg.split_alignment:
                self.candidate_generator.reduce_candidates_paired(
                    cfg.max_insert_size, s1, s2)
            if s1.num_candidates() == 0 or s2.num_candidates() == 0:
                seed_states.append(None)
                continue
            seed_states.append((s1, s2))

        # candidate verification for batch-eligible pairs; exact fallback
        # is interleaved in pair order so the shared mt19937 stream is
        # consumed in the reference's order
        self._cache = cache
        self._cache_update_threshold = cache_update_threshold
        self._fallback_history = {}
        self._verify_and_select(active, batch1, batch2, bm1, bm2, seed_states,
                                fallback_flags, force_mapqs, generator, emit)

        # cache updates in pair order, end1 then end2, including entries
        # recorded by exact-fallback pairs
        if cache is not None:
            merged = {i: hh for (i, hh) in history}
            merged.update(self._fallback_history)
            for i in sorted(merged.keys()):
                for entry in merged[i]:
                    if entry is not None:
                        h, t, pc, nc, rep = entry
                        cache.update(h, t, pc, nc, rep)
            self._fallback_history = {}

    # ------------------------------------------------------------------
    def _verify_and_select(self, active, batch1, batch2, bm1, bm2,
                           seed_states, fallback_flags, force_mapqs,
                           generator, emit):
        cfg = self.cfg
        e = cfg.error_threshold

        # Collect verification work: for each eligible pair, both ends, both
        # strands, candidates in sorted (count desc, position) order.
        work_patterns: List[np.ndarray] = []
        work_texts: List[np.ndarray] = []
        work_meta: List[Tuple[int, int, int, int]] = []  # (a, end, strandneg, ci)
        per_read_cands: dict = {}

        text_cache: dict = {}

        num_refs = len(self.ref_lengths)
        for a, ss in enumerate(seed_states):
            if ss is None:
                continue
            for end, (state, rec) in enumerate(
                    ((ss[0], batch1[active[a]]), (ss[1], batch2[active[a]]))):
                read_length = rec.length
                state.positive_candidates.sort(key=Candidate.sort_key)
                state.negative_candidates.sort(key=Candidate.sort_key)
                for strandneg, cands in ((0, state.positive_candidates),
                                         (1, state.negative_candidates)):
                    # small candidate lists dominate; plain Python beats
                    # numpy-array construction overhead here
                    arr_pos = [c.position for c in cands]
                    arr_cnt = [c.count for c in cands]
                    rids = [p >> 32 for p in arr_pos]
                    if strandneg:
                        pos = [((p & U32) - read_length + 1) & U32
                               for p in arr_pos]
                    else:
                        pos = [p & U32 for p in arr_pos]
                    valid = []
                    for ci in range(len(arr_pos)):
                        rid = rids[ci]
                        if rid >= num_refs:
                            valid.append(False)
                            continue
                        rl = self.ref_lengths[rid]
                        p = pos[ci]
                        valid.append(e <= p < rl
                                     and p + read_length + e < rl)
                    per_read_cands[(a, end, strandneg)] = (arr_pos, arr_cnt,
                                                          valid, pos, rids,
                                                          read_length)

        # shortcut detection must run per read before building work: the
        # all-minimizer single-candidate shortcut skips verification
        shortcut: dict = {}
        for a, ss in enumerate(seed_states):
            if ss is None:
                continue
            for end, state in enumerate(ss):
                num_minimizers = int((bm1 if end == 0 else bm2).counts[a])
                vs = VerifyState()
                vs.min_num_errors = e + 1
                vs.second_min_num_errors = e + 1
                rec = (batch1 if end == 0 else batch2)[active[a]]
                if not cfg.split_alignment and self._try_shortcut(
                        state, num_minimizers, rec.length, a, end, vs,
                        per_read_cands):
                    shortcut[(a, end)] = vs
                else:
                    shortcut[(a, end)] = None

        t0 = time.perf_counter()
        for (a, end, strandneg), (arr_pos, arr_cnt, valid, pos, rids,
                                  read_length) in per_read_cands.items():
            if shortcut.get((a, end)) is not None:
                continue
            rec = (batch1 if end == 0 else batch2)[active[a]]
            key = (a, end, strandneg)
            text = rec.negative_codes() if strandneg else rec.codes()
            for ci in range(len(arr_pos)):
                if not valid[ci]:
                    continue
                work_meta.append((a, end, strandneg, ci))
                start = self.ref_offsets[rids[ci]] + pos[ci] - e
                work_patterns.append(
                    self.ref_codes[start:start + read_length + 2 * e])
                work_texts.append(text)
        self.seconds["gather"] += time.perf_counter() - t0

        if work_meta:
            lengths = {len(t) for t in work_texts}
            # bucket by read length
            results_err = np.empty(len(work_meta), dtype=np.int32)
            results_end = np.empty(len(work_meta), dtype=np.int32)
            meta_arr = np.arange(len(work_meta))
            tl = np.array([len(t) for t in work_texts])
            for L in lengths:
                t0 = time.perf_counter()
                rows = np.flatnonzero(tl == L)
                pats = np.stack([work_patterns[r] for r in rows])
                txts = np.stack([work_texts[r] for r in rows])
                t1 = time.perf_counter()
                err, endp = myers_batch(pats, txts, e, self.device)
                self.seconds["gather"] += t1 - t0
                self.seconds["myers"] += time.perf_counter() - t1
                results_err[rows] = err
                results_end[rows] = endp

        # replay per read-end and assemble VerifyStates
        vs_map: dict = {}
        work_by_read: dict = {}
        for wi, (a, end, strandneg, ci) in enumerate(work_meta):
            work_by_read.setdefault((a, end, strandneg), []).append((ci, wi))

        num_lanes = cfg.num_vpu_lanes()
        for a, ss in enumerate(seed_states):
            if ss is None:
                continue
            for end, state in enumerate(ss):
                vs = shortcut.get((a, end))
                if vs is not None:
                    vs_map[(a, end)] = vs
                    continue
                vs = VerifyState()
                vs.min_num_errors = e + 1
                vs.second_min_num_errors = e + 1
                for strandneg in (0, 1):
                    key = (a, end, strandneg)
                    if key not in per_read_cands:
                        continue
                    (arr_pos, arr_cnt, valid, pos, rids,
                     read_length) = per_read_cands[key]
                    n = len(arr_pos)
                    errors = np.full(n, e + 1, dtype=np.int32)
                    ends = np.zeros(n, dtype=np.int32)
                    for (ci, wi) in work_by_read.get(key, []):
                        errors[ci] = results_err[wi]
                        ends[ci] = results_end[wi]
                    replay_read(vs, e, num_lanes, bool(strandneg),
                                read_length, arr_pos, arr_cnt, valid,
                                errors, ends)
                vs_map[(a, end)] = vs

        # Phase A: choose reported pairs in pair order (the shared mt19937
        # stream must be consumed in the reference's order), interleaving
        # exact fallback pairs which emit immediately. Position recovery is
        # deferred so all tracebacks run as one batch (Phase B), then MAPQ
        # and record emission complete per pair (Phase C). Which pair is
        # reported never depends on recovered positions.
        from ..mapping.select import ChoosingSelector
        chooser = ChoosingSelector(cfg)
        pending = []  # (a, pe_state, emissions)
        for a, i in enumerate(active):
            rec1 = batch1[i]
            rec2 = batch2[i]
            if fallback_flags[a]:
                self._map_pair_exact(rec1, rec2, generator, emit, pair_index=i)
                continue
            ss = seed_states[a]
            if ss is None:
                continue
            vs1 = vs_map[(a, 0)]
            vs2 = vs_map[(a, 1)]
            self.stats_num_candidates += (ss[0].num_candidates()
                                          + ss[1].num_candidates())
            if vs1.num_draft_mappings() == 0 or vs2.num_draft_mappings() == 0:
                continue
            if not cfg.split_alignment:
                vs1.positive_mappings.sort(key=lambda m: m.position)
                vs1.negative_mappings.sort(key=lambda m: m.position)
                vs2.positive_mappings.sort(key=lambda m: m.position)
                vs2.negative_mappings.sort(key=lambda m: m.position)
            pe_state = PairedVerifyState(vs1=vs1, vs2=vs2)
            chooser.set_read_lengths(rec1.length, rec2.length)
            emissions = chooser.choose_paired_end(pe_state, generator,
                                                  int(force_mapqs[a]))
            if pe_state.num_best_mappings == 1:
                self.stats_num_uniquely_mapped += 2
            self.stats_num_mappings += 2 * min(pe_state.num_best_mappings,
                                               cfg.max_num_best_mappings)
            if pe_state.num_best_mappings > 0:
                self.stats_num_mapped_reads += 2
            if emissions:
                pending.append((a, pe_state, emissions))

        if pending:
            self._resolve_and_emit(pending, active, batch1, batch2,
                                   seed_states, emit)

    def _resolve_and_emit(self, pending, active, batch1, batch2, seed_states,
                          emit) -> None:
        """Phases B+C: batch traceback for all reported ends, then MAPQ and
        record emission per pair."""
        from ..mapping.select import MappingInMem
        from .verify import traceback_batch

        cfg = self.cfg
        e = cfg.error_threshold

        # collect traceback work items
        work = []  # (key fields per end)
        for (a, pe_state, emissions) in pending:
            rec1 = batch1[active[a]]
            rec2 = batch2[active[a]]
            for pi, pe in enumerate(emissions):
                for end, (draft, neg, rec) in enumerate(
                        ((pe.draft1, pe.first_negative, rec1),
                         (pe.draft2, pe.second_negative, rec2))):
                    work.append((a, pi, end, draft, neg, rec))

        # bucket by read length
        by_len = {}
        for wi, (a, pi, end, draft, neg, rec) in enumerate(work):
            by_len.setdefault(rec.length, []).append(wi)

        starts_out = np.zeros(len(work), dtype=np.int64)
        vws_out = np.zeros(len(work), dtype=np.int64)
        for L, rows in by_len.items():
            n = len(rows)
            pat_codes = np.empty((n, L + 2 * e), dtype=np.uint8)
            pat_raw = np.empty((n, L + 2 * e), dtype=np.uint8)
            txt_codes = np.empty((n, L), dtype=np.uint8)
            txt_raw = np.empty((n, L), dtype=np.uint8)
            targets = np.empty(n, dtype=np.int32)
            for j, wi in enumerate(rows):
                (a, pi, end, draft, neg, rec) = work[wi]
                rid = draft.rid
                ref_position = draft.ref_position
                ref_len = self.ref_lengths[rid]
                if ref_position + 1 > L + e:
                    vws = ref_position + 1 - L - e
                else:
                    vws = 0
                if ref_position + e >= ref_len:
                    vws = (ref_len - e - L) & U32
                if vws > ref_len:
                    vws = 0
                vws_out[wi] = vws
                base = int(self.ref_offsets[rid]) + vws
                pat_codes[j] = self.ref_codes[base:base + L + 2 * e]
                pat_raw[j] = self.ref_raw[base:base + L + 2 * e]
                if neg:
                    txt_raw[j] = np.frombuffer(rec.negative(), dtype=np.uint8)
                    txt_codes[j] = rec.negative_codes()
                else:
                    txt_raw[j] = np.frombuffer(bytes(rec.seq), dtype=np.uint8)
                    txt_codes[j] = rec.codes()
                targets[j] = draft.num_errors
            starts = traceback_batch(e, targets, pat_codes, txt_codes,
                                     pat_raw, txt_raw, L)
            for j, wi in enumerate(rows):
                starts_out[wi] = starts[j]

        # Phase C: per pair, build records
        resolved = {}
        for wi, (a, pi, end, draft, neg, rec) in enumerate(work):
            ref_start = int(vws_out[wi]) + int(starts_out[wi])
            ref_end = draft.ref_position
            resolved[(a, pi, end)] = (ref_start, ref_end)

        for (a, pe_state, emissions) in pending:
            i = active[a]
            rec1 = batch1[i]
            rec2 = batch2[i]
            ss = seed_states[a]
            for pi, pe in enumerate(emissions):
                mm1 = MappingInMem(read_id=rec1.read_id, read_name=rec1.name,
                                   read_length=rec1.length,
                                   strand_negative=pe.first_negative,
                                   is_unique=bool(pe.is_unique))
                mm2 = MappingInMem(read_id=rec1.read_id, read_name=rec2.name,
                                   read_length=rec2.length,
                                   strand_negative=pe.second_negative,
                                   is_unique=bool(pe.is_unique))
                mm1.ref_start, mm1.ref_end = resolved[(a, pi, 0)]
                mm2.ref_start, mm2.ref_end = resolved[(a, pi, 1)]
                mapq, mapq1, mapq2 = self.selector.mapq_paired_end(
                    pe.first_negative, pe.second_negative,
                    pe.draft1.num_errors, pe.draft2.num_errors,
                    mm1.fragment_length(), mm2.fragment_length(),
                    rec1.length, rec2.length, pe.force_mapq, pe_state,
                    ss[0], ss[1])
                mm1.mapq = mapq
                mm2.mapq = mapq
                self.selector._emit_pe_record(mm1, mm2, mapq1, mapq2,
                                              _EmitCtx(False), emit)


    def _try_shortcut(self, state: ReadSeedState, num_minimizers: int,
                      read_length: int, a: int, end: int, vs: VerifyState,
                      per_read_cands: dict) -> bool:
        """All-minimizer single-candidate shortcut (dmg.cc:72-157)."""
        from ..mapping.generate import DraftMapping

        if state.num_candidates() != 1:
            return False
        hit_negative = False
        num_hits = 0
        cand = None
        for c in state.positive_candidates:
            if c.count == num_minimizers:
                cand = c
                num_hits += 1
        for c in state.negative_candidates:
            if c.count == num_minimizers:
                cand = c
                hit_negative = True
                num_hits += 1
        if num_hits != 1:
            return False
        vs.min_num_errors = 0
        vs.num_best_mappings = 1
        vs.num_second_best_mappings = 0
        rid = cand.rid
        position = cand.ref_position
        if hit_negative:
            position = (position - read_length + 1) & U32
        e = self.cfg.error_threshold
        ref_len = self.ref_lengths[rid] if rid < len(self.ref_lengths) else 0
        if (position < e or position >= ref_len
                or position + read_length + e >= ref_len):
            return False
        if hit_negative:
            vs.negative_mappings.append(DraftMapping(0, cand.position))
        else:
            vs.positive_mappings.append(
                DraftMapping(0, cand.position + read_length - 1))
        return True

    def _map_pair_exact(self, rec1: SequenceRecord, rec2: SequenceRecord,
                        generator: MT19937, emit,
                        pair_index: int = -1) -> None:
        """Exact per-read path for fallback pairs (same as slow pipeline)."""
        cfg = self.cfg
        from ..index.minimizers import generate_minimizers

        k = self.index.kmer_size
        w = self.index.window_size
        seed1 = ReadSeedState()
        seed2 = ReadSeedState()
        seed1.minimizers = generate_minimizers(rec1.codes(), 0, k, w)
        seed2.minimizers = generate_minimizers(rec2.codes(), 0, k, w)
        if not seed1.minimizers or not seed2.minimizers:
            return

        fb_entries = [None, None]
        any_hit = False
        for slot, (seed, rec) in enumerate(((seed1, rec1), (seed2, rec2))):
            h = np.array([m[0] for m in seed.minimizers], dtype=np.uint64)
            t = np.array([m[1] for m in seed.minimizers], dtype=np.uint64)
            hit = -1
            if self._cache is not None:
                hit, cpos, cneg, crep = self._cache.query(h, t, rec.length)
            if hit >= 0:
                seed.positive_candidates = cpos
                seed.negative_candidates = cneg
                seed.repetitive_seed_length = crep
                any_hit = True
            else:
                self.candidate_generator.generate(seed)
            fb_entries[slot] = (h, t, seed.positive_candidates,
                               seed.negative_candidates,
                               seed.repetitive_seed_length)
        if any_hit:
            self.stats_cache_hits_batch += 1
        if (self._cache is not None and pair_index >= 0
                and pair_index < self._cache_update_threshold):
            self._fallback_history[pair_index] = tuple(fb_entries)
        n1 = seed1.num_candidates()
        n2 = seed2.num_candidates()
        supplement_result = 0
        if not cfg.split_alignment:
            supplement_result = self.candidate_generator.supplement_candidates(
                2 * cfg.max_insert_size, seed1, seed2)
            n1 = seed1.num_candidates()
            n2 = seed2.num_candidates()
        if n1 > 0 and n2 > 0 and not cfg.split_alignment:
            self.candidate_generator.reduce_candidates_paired(
                cfg.max_insert_size, seed1, seed2)
            n1 = seed1.num_candidates()
            n2 = seed2.num_candidates()
        if n1 == 0 or n2 == 0:
            return
        self.stats_num_candidates += n1 + n2
        read1 = bytes(rec1.seq)
        read2 = bytes(rec2.seq)
        negative_read1 = rec1.negative()
        negative_read2 = rec2.negative()
        ref_seqs = self.selector.reference_seqs
        vs1 = self.draft_generator.generate(read1, negative_read1, seed1,
                                            ref_seqs, self.ref_lengths)
        vs2 = self.draft_generator.generate(read2, negative_read2, seed2,
                                            ref_seqs, self.ref_lengths)
        if vs1.num_draft_mappings() == 0 or vs2.num_draft_mappings() == 0:
            return
        if not cfg.split_alignment:
            vs1.positive_mappings.sort(key=lambda m: m.position)
            vs1.negative_mappings.sort(key=lambda m: m.position)
            vs2.positive_mappings.sort(key=lambda m: m.position)
            vs2.negative_mappings.sort(key=lambda m: m.position)
        force_mapq = 0 if supplement_result != 0 else -1
        ctx = PairContext(
            read_id=rec1.read_id, read1_name=rec1.name, read2_name=rec2.name,
            read1=read1, read2=read2, negative_read1=negative_read1,
            negative_read2=negative_read2, read1_length=rec1.length,
            read2_length=rec2.length,
            qual1=bytes(rec1.qual) if rec1.qual else None,
            qual2=bytes(rec2.qual) if rec2.qual else None,
            barcode_key=0, has_barcode=False, seed1=seed1, seed2=seed2,
            vs1=vs1, vs2=vs2)
        pe_state = PairedVerifyState(vs1=vs1, vs2=vs2)
        self.selector.select_paired_end(ctx, pe_state, generator, force_mapq,
                                        emit)
        if pe_state.num_best_mappings == 1:
            self.stats_num_uniquely_mapped += 2
        self.stats_num_mappings += 2 * min(pe_state.num_best_mappings,
                                           cfg.max_num_best_mappings)
        if pe_state.num_best_mappings > 0:
            self.stats_num_mapped_reads += 2


class _EmitCtx:
    __slots__ = ("has_barcode",)

    def __init__(self, has_barcode: bool):
        self.has_barcode = has_barcode
