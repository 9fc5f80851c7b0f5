"""The plain reference mapper: one read pair at a time, in numpy and
Python, from the frozen copies in this package (the per-read engine's
seeding, candidate generation, verification, selection and MAPQ,
mapping_generator.h and chromap.h MapPairedEndReads), with the candidate
cache off as the port's device runs have it.

Where the port draws one of several tied best mappings from its random
stream, `map_pair` returns every one of them: which one a run reports
depends on every pair mapped before it, so any of them is right.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .candidates import CandidateGenerator, ReadSeedState
from .config import MappingConfig
from .generate import DraftMappingGenerator
from .minimizers import generate_minimizers
from .rng import MT19937
from .select import BestMappingSelector, PairContext, PairedVerifyState
from .utils import encode_sequence, reverse_complement_ascii


class Read:
    """One FASTQ record: the name up to the first whitespace, the bases
    and the qualities."""

    def __init__(self, name: bytes, seq: bytes, qual: Optional[bytes],
                 read_id: int):
        self.name = name
        self.seq = seq
        self.qual = qual
        self.read_id = read_id
        self.length = len(seq)
        self.negative = reverse_complement_ascii(seq)

    def codes(self) -> np.ndarray:
        return encode_sequence(self.seq)


class ReferenceMapper:
    def __init__(self, cfg: MappingConfig, index, ref_seqs: List[bytes]):
        if (cfg.trim_adapters or not cfg.is_bulk_data
                or cfg.max_num_best_mappings != 1
                or cfg.output_format not in ("bed", "pairs")):
            raise NotImplementedError(
                "the reference maps bulk pairs to BED or pairs without "
                "adapter trimming, one best mapping a pair")
        self.cfg = cfg
        self.k, self.w = index.kmer_size, index.window_size
        self.candidates = CandidateGenerator(
            index, cfg.error_threshold,
            cfg.min_num_seeds_required_for_mapping,
            tuple(cfg.max_seed_frequencies))
        self.drafts = DraftMappingGenerator(
            cfg.error_threshold, cfg.split_alignment, cfg.output_format)
        rank = (list(range(len(ref_seqs)))
                if cfg.output_format == "pairs" else None)
        # the selector slices a chromosome from the mapping to its end
        # (ref[vws:]), a copy of up to the whole chromosome for bytes and
        # none for a memoryview, which it reads alike
        self.selector = BestMappingSelector(
            cfg, [memoryview(s) for s in ref_seqs],
            [len(s) for s in ref_seqs], rank)
        self.ref_seqs = ref_seqs

    def map_pair(self, r1: Read, r2: Read) -> List[object]:
        """Every record the pair may be reported as ([] if unmapped)."""
        cfg = self.cfg
        if (r1.length < cfg.min_read_length
                or r2.length < cfg.min_read_length):
            return []
        seed1, seed2 = ReadSeedState(), ReadSeedState()
        seed1.minimizers = generate_minimizers(r1.codes(), 0, self.k, self.w)
        seed2.minimizers = generate_minimizers(r2.codes(), 0, self.k, self.w)
        if not seed1.minimizers or not seed2.minimizers:
            return []
        self.candidates.generate(seed1)
        self.candidates.generate(seed2)
        supplement = 0
        if not cfg.split_alignment:
            supplement = self.candidates.supplement_candidates(
                2 * cfg.max_insert_size, seed1, seed2)
            if seed1.num_candidates() > 0 and seed2.num_candidates() > 0:
                self.candidates.reduce_candidates_paired(
                    cfg.max_insert_size, seed1, seed2)
        if seed1.num_candidates() == 0 or seed2.num_candidates() == 0:
            return []
        vs1 = self.drafts.generate(r1.seq, r1.negative, seed1,
                                   self.ref_seqs,
                                   [len(s) for s in self.ref_seqs])
        vs2 = self.drafts.generate(r2.seq, r2.negative, seed2,
                                   self.ref_seqs,
                                   [len(s) for s in self.ref_seqs])
        if vs1.num_draft_mappings() == 0 or vs2.num_draft_mappings() == 0:
            return []
        if not cfg.split_alignment:
            for vs in (vs1, vs2):
                vs.positive_mappings.sort(key=lambda m: m.position)
                vs.negative_mappings.sort(key=lambda m: m.position)
        ctx = PairContext(
            read_id=r1.read_id, read1_name=r1.name, read2_name=r2.name,
            read1=r1.seq, read2=r2.seq, negative_read1=r1.negative,
            negative_read2=r2.negative, read1_length=r1.length,
            read2_length=r2.length, qual1=r1.qual, qual2=r2.qual,
            barcode_key=0, has_barcode=False, seed1=seed1, seed2=seed2,
            vs1=vs1, vs2=vs2)
        force_mapq = 0 if supplement != 0 else -1
        records: List[object] = []
        choice, tied = 0, 1
        while choice < tied:
            state = PairedVerifyState(vs1=vs1, vs2=vs2)
            self.selector.select_paired_end(
                ctx, state, MT19937(11), force_mapq,
                lambda rid, rec: records.append((rid, rec)),
                forced_best=choice)
            if state.num_best_mappings > cfg.drop_repetitive_reads:
                return []
            tied = state.num_best_mappings
            choice += 1
        return records
