"""End-to-end mapping pipelines (analog of chromap.h MapSingleEndReads /
MapPairedEndReads).

The host pipeline streams read batches, runs seeding -> verification ->
selection per read, accumulates per-rid records, then post-processes
(Tn5 / dedup / allocation) and writes output. The device path routes
the batch hot loops (minimizers, index probe, Myers) through PyTorch and
the CUDA kernels of ops/ (the plain torch versions with --torch-device cpu) and
falls back to this exact host path per-read where capacities overflow.
"""

from __future__ import annotations

import contextlib
import gzip
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from . import tracing
from .config import IndexConfig, MappingConfig
from .hybrid import Chunk, DeviceChunks, Flow
from .index.index import MinimizerIndex, build_index
from .index.minimizers import generate_minimizers
from .io.fastx import (FastxReader, MultiFileFastxStream, SequenceRecord,
                       load_all_sequences)
from .io.seqformat import ReadFormat
from .io.writers import MappingFileWriter
from .mapping.candidates import CandidateGenerator, ReadSeedState
from .mapping.generate import DraftMappingGenerator
from .mapping.postprocess import (allocate_multi_mappings, apply_tn5_shift,
                                  remove_pcr_duplicates, sort_mappings)
from .mapping.rng import MT19937
from .mapping.select import (BestMappingSelector, PairContext,
                             PairedVerifyState)
from .native import NativeFastxPairStream, NativeReadBatch
from .utils import generate_seed_from_codes, reverse_complement_ascii


def log(msg: str) -> None:
    print(msg, file=sys.stderr)


def _blob(reads) -> Tuple[bytes, np.ndarray]:
    """Reads (bytes or bytearrays) as one blob of bases and its n+1 int64
    offsets, the form the native engine takes."""
    offsets = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in reads], out=offsets[1:])
    return b"".join(reads), offsets


def _starts_fastq(path: str) -> bool:
    """Whether the file's first byte, after gunzip, is a FASTQ '@'."""
    with open(path, "rb") as raw:
        if raw.read(2) != b"\x1f\x8b":
            raw.seek(0)
            return raw.read(1) == b"@"
        raw.seek(0)
        with gzip.GzipFile(fileobj=raw) as f:
            return f.read(1) == b"@"


def construct_index(cfg: IndexConfig) -> None:
    t0 = time.time()
    records = load_all_sequences(cfg.reference_file_path)
    log(f"Loaded all sequences in {time.time() - t0:.2f}s, "
        f"number of sequences: {len(records)}.")
    idx = build_index([r.codes() for r in records], cfg.kmer_size,
                      cfg.window_size,
                      num_threads=getattr(cfg, "num_threads", 1))
    log(idx.statistics_string(len(records),
                              sum(r.length for r in records)))
    idx.save(cfg.index_output_file_path)
    log(f"Saved index in {time.time() - t0:.2f}s.")


def trim_adapter_paired(rec1: SequenceRecord, rec2: SequenceRecord,
                        min_read_length: int) -> None:
    """Adapter trimming by read-pair overlap merge (chromap.cc:176-289)."""
    raw1, raw2 = bytes(rec1.seq), bytes(rec2.seq)
    swapped = len(raw1) > len(raw2)
    read1 = raw2 if swapped else raw1
    negative_read2 = (rec1 if swapped else rec2).negative()
    read1_length = min(len(raw1), len(raw2))
    read2_length = max(len(raw1), len(raw2))

    min_overlap_length = min_read_length
    seed_length = min_overlap_length // 2
    error_threshold_for_merging = 1

    for si in range(error_threshold_for_merging + 1):
        seed = read1[si * seed_length: (si + 1) * seed_length]
        if len(seed) < seed_length:
            break
        seed_start_position = negative_read2.find(seed)
        while seed_start_position != -1:
            before_ok = seed_start_position >= si * seed_length
            overlap_ok = (read2_length - seed_start_position
                          + seed_length * si) >= min_overlap_length
            if not (before_ok and overlap_ok):
                seed_start_position = negative_read2.find(
                    seed, seed_start_position + 1)
                continue
            can_merge = True
            num_errors = 0
            for i in range(seed_length * si):
                if (negative_read2[seed_start_position - si * seed_length + i]
                        != read1[i]):
                    num_errors += 1
                if num_errors > error_threshold_for_merging:
                    can_merge = False
                    break
            if can_merge:
                i = seed_length
                while (i + seed_start_position < read2_length
                       and si * seed_length + i < read1_length):
                    if (negative_read2[seed_start_position + i]
                            != read1[si * seed_length + i]):
                        num_errors += 1
                    if num_errors > error_threshold_for_merging:
                        can_merge = False
                        break
                    i += 1
            if can_merge:
                overlap_length = (read2_length - seed_start_position
                                  + si * seed_length)
                read2_offset = 0
                if overlap_length > read1_length:
                    read2_offset = overlap_length - read1_length
                    overlap_length = read1_length
                if not swapped:
                    rec1.trim_to(overlap_length)
                    rec2.trim_to(overlap_length + read2_offset)
                else:
                    rec1.trim_to(overlap_length + read2_offset)
                    rec2.trim_to(overlap_length)
                return
            seed_start_position = negative_read2.find(
                seed, seed_start_position + 1)


class MappingPipeline:
    def __init__(self, cfg: MappingConfig):
        self.cfg = cfg
        self._device_seeder = None
        self._device_chunks = None
        self.batch_mapper = None  # the batch engine of the last paired run
        if cfg.use_device:
            # fail before any mapping when the asked-for device, or the
            # asked-for number of them, is absent, even if no chunk would
            # have reached it
            from .ops.device_seed import resolve_device
            from .parallel.sharding import make_data_mesh
            resolve_device(cfg.torch_device)
            if cfg.mesh_devices > 1:
                make_data_mesh(cfg.mesh_devices, cfg.torch_device)
        if getattr(cfg, "device_batch_size", 0) > 16384:
            # the device program's hit-sort key carries 15 row bits
            # (2 reads/pair), so one dispatch holds <= 16384 pairs
            log("WARNING: device_batch_size capped at 16384 pairs "
                "(device hit-sort row budget).")
            cfg.device_batch_size = 16384
        self.read_format = (ReadFormat.parse(cfg.read_format)
                            if cfg.read_format else ReadFormat())

        t0 = time.time()
        self.reference = load_all_sequences(cfg.reference_file_path)
        if cfg.debug_cache:
            # reference listing in load order (--debug-cache,
            # chromap.h:646-652)
            for i, rec in enumerate(self.reference):
                name = rec.name.decode() if isinstance(rec.name, bytes) \
                    else rec.name
                print(f"[DEBUG][INDEX] seq_i = {i} , seq_i_name = {name}")
        self.custom_rid_rank: Optional[List[int]] = None
        if cfg.custom_rid_order_file_path:
            self.custom_rid_rank = self._load_rid_ranks(
                cfg.custom_rid_order_file_path)
            reordered: List[SequenceRecord] = list(self.reference)
            for i, rec in enumerate(self.reference):
                reordered[self.custom_rid_rank[i]] = rec
            self.reference = reordered
        self.ref_names = [r.name for r in self.reference]
        self.ref_seqs = [bytes(r.seq) for r in self.reference]
        self.ref_lengths = [r.length for r in self.reference]
        log(f"Loaded all sequences in {time.time() - t0:.2f}s, "
            f"number of sequences: {len(self.reference)}.")
        if (cfg.use_device and cfg.error_threshold < 16
                and (cfg.native_engine_eligible(paired=True)
                     or cfg.native_engine_eligible(paired=False))):
            # a run whose chunks may reach the seeder fails here, before
            # any output, when it lies beyond the packed-candidate format
            from .ops.device_seed import check_packed_bounds
            check_packed_bounds(len(self.reference), cfg.max_seed_frequencies)

        self.pairs_custom_rid_rank: Optional[List[int]] = None
        if cfg.output_format == "pairs":
            if cfg.pairs_flipping_custom_rid_order_file_path:
                self.pairs_custom_rid_rank = self._load_rid_ranks(
                    cfg.pairs_flipping_custom_rid_order_file_path)
            else:
                self.pairs_custom_rid_rank = list(range(len(self.reference)))

        self.index = MinimizerIndex.load(cfg.index_file_path)
        log(f"Kmer size: {self.index.kmer_size}, "
            f"window size: {self.index.window_size}.")

        # ---- single-cell barcode subsystem (chromap.h:754-761) ----
        self.barcode_length = 0
        self.whitelist = None
        self.translator = None
        self.summary = None
        self.kminhash_per_barcode = {}
        self.num_barcode_in_whitelist = 0
        self.num_corrected_barcode = 0
        if not cfg.is_bulk_data:
            from .barcode.whitelist import (BarcodeWhitelist,
                                            sample_barcode_length)
            self.barcode_length = sample_barcode_length(
                cfg.barcode_file_paths[0], self.read_format.bc)
            if cfg.barcode_whitelist_file_path:
                self.whitelist = BarcodeWhitelist(self.barcode_length)
                n = self.whitelist.load(cfg.barcode_whitelist_file_path)
                log(f"Loaded {n} barcodes.")
                self.whitelist.compute_abundance(
                    cfg.barcode_file_paths, self.read_format.bc,
                    max_num_samples=20_000_000,
                    batch_size=cfg.read_batch_size,
                    skip_barcode_check=cfg.skip_barcode_check)
                log(f"Computed barcode abundance using "
                    f"{self.whitelist.num_sample_barcodes} barcodes.")
        if cfg.barcode_translate_table_file_path:
            from .barcode.translate import BarcodeTranslator
            self.translator = BarcodeTranslator(
                cfg.barcode_translate_table_file_path)
        if cfg.summary_metadata_file_path:
            from .summary import SummaryMetadata
            self.summary = SummaryMetadata(self.barcode_length)

        self.candidate_generator = CandidateGenerator(
            self.index, cfg.error_threshold,
            cfg.min_num_seeds_required_for_mapping,
            tuple(cfg.max_seed_frequencies))
        from .cache import MMCache
        # single-end uses a fixed 2000003-slot cache in the reference
        # (chromap.h:291); paired-end uses the configured size
        self.cache_paired = MMCache(cfg.cache_size)
        self.cache_paired.set_kmer_length(self.index.kmer_size)
        self.cache_single = MMCache(2000003)
        self.cache_single.set_kmer_length(self.index.kmer_size)
        if cfg.debug_cache:
            self.cache_paired.debug = True
            self.cache_single.debug = True
        # --device forces the cache off: mmcache hits are only
        # approximately equal to fresh candidate generation, so a
        # cache-free run is the configuration whose output is invariant
        # to which engine maps each chunk (and to the hybrid scheduler's
        # adaptive chunk assignment). Reachable on the host via
        # --no-cache for byte-comparison.
        self._cache_off = bool(getattr(cfg, "cache_off", False)
                               or cfg.use_device)
        if self._cache_off:
            self.cache_paired.disabled = True
            self.cache_single.disabled = True
            if cfg.use_device and not getattr(cfg, "cache_off", False):
                log("Device mode: candidate cache disabled "
                    "(deterministic chunk scheduling).")
        self.cache_hits = 0
        self.draft_generator = DraftMappingGenerator(
            cfg.error_threshold, cfg.split_alignment, cfg.output_format)
        self.selector = BestMappingSelector(cfg, self.ref_seqs,
                                            self.ref_lengths,
                                            self.pairs_custom_rid_rank)

        # native engine constructed at init (probe-table build is setup
        # cost, like the reference's index load -- not mapping time)
        self._native_engine = None
        self._native_engine_err = None
        if (cfg.native_engine_eligible(paired=True)
                or cfg.native_engine_eligible(paired=False)):
            try:
                from .native import NativeEngine
                self._native_engine = NativeEngine(cfg, self.index,
                                                   self.ref_seqs)
                if cfg.debug_cache:
                    self._native_engine.set_debug_cache()
                if self._cache_off:
                    self._native_engine.set_cache_off()
            except Exception as exc:
                self._native_engine_err = exc

        # stats (chromap.h:202-206)
        self.num_reads = 0
        self.num_candidates = 0
        self.num_mappings = 0
        self.num_mapped_reads = 0
        self.num_uniquely_mapped_reads = 0

        self.mappings_on_refs: List[List[object]] = [
            [] for _ in self.reference]
        self.temp_shard_paths: List[str] = []
        self.num_mappings_in_mem = 0
        # reference budgets are bytes (1 GiB, or 0.5 GiB for SAM/PAF/pairs,
        # chromap.h:782-788); expressed here as record counts
        if cfg.low_mem_max_records:
            self.max_mappings_in_mem = cfg.low_mem_max_records
        elif cfg.output_format in ("sam", "paf", "pairs"):
            self.max_mappings_in_mem = (1 << 29) // 64
        else:
            self.max_mappings_in_mem = (1 << 30) // 16

    def _load_rid_ranks(self, path: str) -> List[int]:
        """Custom chromosome order file -> rank per current rid
        (chromap.cc:867-914)."""
        with open(path, "rb") as f:
            ordered_names = [line.split()[0] for line in f if line.strip()]
        name_to_rid = {r.name: i for i, r in enumerate(self.reference)}
        ranks = [-1] * len(self.reference)
        next_rank = 0
        for name in ordered_names:
            if name in name_to_rid:
                ranks[name_to_rid[name]] = next_rank
                next_rank += 1
        for rid in range(len(self.reference)):
            if ranks[rid] == -1:
                ranks[rid] = next_rank
                next_rank += 1
        return ranks

    # ------------------------------ single-end ------------------------------

    def _make_writer(self) -> MappingFileWriter:
        return MappingFileWriter(
            self.cfg, self.ref_names, self.ref_lengths,
            cell_barcode_length=self.barcode_length,
            barcode_translator=self.translator,
            pairs_custom_rid_rank=self.pairs_custom_rid_rank,
            summary=self.summary)

    def _process_barcode(self, rec_bc) -> Tuple[bool, int]:
        """Correct the barcode (mutating it) and return (whitelisted, key)."""
        cfg = self.cfg
        whitelisted = True
        if self.whitelist is not None:
            stats = [self.num_barcode_in_whitelist, self.num_corrected_barcode]
            whitelisted = self.whitelist.correct_barcode(
                rec_bc, cfg.barcode_correction_error_threshold,
                cfg.barcode_correction_probability_threshold, stats)
            self.num_barcode_in_whitelist, self.num_corrected_barcode = stats
        key = generate_seed_from_codes(rec_bc.codes(), 0, self.barcode_length)
        return whitelisted, key

    @tracing.traced_pass
    def map_single_end(self) -> None:
        cfg = self.cfg
        writer = self._make_writer()
        writer.output_header()

        k = self.index.kmer_size
        w = self.index.window_size
        stream = MultiFileFastxStream(cfg.read_file1_paths, self.read_format.r1)
        stream_bc = (MultiFileFastxStream(cfg.barcode_file_paths,
                                          self.read_format.bc)
                     if not cfg.is_bulk_data else None)

        def emit(rid: int, record: object) -> None:
            self.mappings_on_refs[rid].append(record)
            self.num_mappings_in_mem += 1

        native_engine = None
        if cfg.native_engine_eligible(paired=False):
            native_engine = self._native_engine
            if native_engine is not None:
                log("Using native host engine.")
            else:
                log(f"Native engine unavailable "
                    f"({self._native_engine_err}); "
                    "falling back to Python engine.")
        if cfg.use_device and native_engine is None:
            raise RuntimeError(
                "--device needs the native engine"
                + (f" ({self._native_engine_err})"
                   if self._native_engine_err else "")
                + "; refusing to map on the host instead")

        # full-native fast path: native FASTQ IO + mapping + postprocess
        if (native_engine is not None and not cfg.read_format
                and self.summary is None and not cfg.allocate_multi_mappings
                and not cfg.matrix_output_prefix
                and not cfg.low_memory_mode
                and cfg.is_bulk_data and cfg.num_shards == 1
                and cfg.output_format in ("bed", "tagalign")):
            self._map_full_native(native_engine, paired=False)
            return

        t_map = time.time()
        while True:
            with tracing.span("records.read"):
                batch = stream.read_batch(cfg.read_batch_size)
                batch_bc = (stream_bc.read_batch(cfg.read_batch_size)
                            if stream_bc else None)
            if batch_bc is not None and len(batch_bc) != len(batch):
                raise RuntimeError("Numbers of reads and barcodes don't match!")
            if not batch:
                break
            if self.cfg.num_shards > 1:
                keep = [i for i, r in enumerate(batch)
                        if r.read_id % self.cfg.num_shards
                        == self.cfg.shard_index]
                batch = [batch[i] for i in keep]
                if batch_bc is not None:
                    batch_bc = [batch_bc[i] for i in keep]
            self.num_reads += len(batch)
            from .summary import TOTAL
            threshold = self.cache_single.get_update_threshold(
                len(batch), self.num_reads, False, 0.01)
            self._debug_threshold(threshold)
            if native_engine is not None:
                if cfg.output_format in ("paf", "sam"):
                    self._map_batch_native_se_records(native_engine, batch,
                                                      threshold, emit,
                                                      batch_bc)
                elif batch_bc is not None:
                    self._map_batch_native_se_barcoded(
                        native_engine, batch, batch_bc, threshold, emit)
                else:
                    self._map_batch_native_se(native_engine, batch,
                                              threshold, emit)
                self._maybe_spill()
                log(f"Mapped {len(batch)} reads.")
                continue
            history = ([{}] if threshold > 0 else None)
            nonwhitelist_count = 0
            for bi, rec in enumerate(batch):
                barcode_key = 0
                whitelisted = True
                if batch_bc is not None:
                    whitelisted, barcode_key = self._process_barcode(
                        batch_bc[bi])
                if not (whitelisted or cfg.output_mappings_not_in_whitelist):
                    nonwhitelist_count += 1
                    continue
                if self.summary is not None and batch_bc is not None:
                    self.summary.update_count(barcode_key, TOTAL, 1)
                if rec.length < cfg.min_read_length:
                    continue
                self._map_one_single_end(rec, k, w, emit, barcode_key,
                                         batch_bc is not None,
                                         read_index=bi, history=history,
                                         threshold=threshold)
            if history is not None:
                for bi in sorted(history[0].keys()):
                    h, t, pc, nc, rep = history[0][bi]
                    self.cache_single.update(h, t, pc, nc, rep)
            if self.summary is not None:
                if cfg.is_bulk_data:
                    self.summary.update_count(0, TOTAL, len(batch))
                else:
                    self.summary.update_nonwhitelist(TOTAL, nonwhitelist_count)
            self._maybe_spill()
            log(f"Mapped {len(batch)} reads.")
        log(f"Mapped all reads in {time.time() - t_map:.2f}s.")
        self._output_stats()
        self._postprocess_and_write(writer)
        self._output_summary()
        self._debug_cache_stats(native_engine, paired=False)
        writer.close()

    def _map_one_single_end(self, rec: SequenceRecord, k: int, w: int,
                            emit, barcode_key: int = 0,
                            has_barcode: bool = False, read_index: int = 0,
                            history=None, threshold: int = 0) -> None:
        cfg = self.cfg
        seed_state = ReadSeedState()
        seed_state.minimizers = generate_minimizers(rec.codes(), 0, k, w)
        if not seed_state.minimizers:
            return
        self._seed_with_cache(seed_state, rec.length, self.cache_single,
                              history, read_index, threshold, 0)
        if seed_state.num_candidates() == 0:
            return
        self.num_candidates += seed_state.num_candidates()
        read = bytes(rec.seq)
        negative_read = rec.negative()
        vs = self.draft_generator.generate(read, negative_read, seed_state,
                                           self.ref_seqs, self.ref_lengths)
        if vs.num_draft_mappings() == 0:
            return
        self.selector.select_single_end(
            rec.read_id, rec.name, read, negative_read,
            bytes(rec.qual) if rec.qual else None, barcode_key, has_barcode,
            seed_state, vs, emit)
        self.num_mappings += min(vs.num_best_mappings,
                                 cfg.max_num_best_mappings)
        self.num_mapped_reads += 1
        if vs.num_best_mappings == 1:
            self.num_uniquely_mapped_reads += 1

    # ------------------------------ paired-end ------------------------------

    @tracing.traced_pass
    def map_paired_end(self) -> None:
        cfg = self.cfg
        writer = self._make_writer()
        writer.output_header()

        k = self.index.kmer_size
        w = self.index.window_size
        stream1 = MultiFileFastxStream(cfg.read_file1_paths, self.read_format.r1)
        stream2 = MultiFileFastxStream(cfg.read_file2_paths, self.read_format.r2)
        stream_bc = (MultiFileFastxStream(cfg.barcode_file_paths,
                                          self.read_format.bc)
                     if not cfg.is_bulk_data else None)

        def emit(rid: int, record: object) -> None:
            self.mappings_on_refs[rid].append(record)
            self.num_mappings_in_mem += 1

        native_engine = None
        if cfg.native_engine_eligible(paired=True):
            native_engine = self._native_engine
            if native_engine is not None:
                if self.custom_rid_rank is not None:
                    # paired-end only: the reference's single-end rerank
                    # call site runs before candidates exist (chromap.h:
                    # 418-419) and is a no-op
                    native_engine.set_rid_rank(self.custom_rid_rank)
                log("Using native host engine.")
            elif cfg.use_device:
                log(f"Native engine unavailable "
                    f"({self._native_engine_err}).")
            else:
                log(f"Native engine unavailable "
                    f"({self._native_engine_err}); "
                    "falling back to batch engine.")

        # full-native fast path: native FASTQ IO + mapping + postprocess
        if (native_engine is not None and not cfg.read_format
                and cfg.is_bulk_data and cfg.num_shards == 1
                and self.summary is None and not cfg.allocate_multi_mappings
                and not cfg.matrix_output_prefix
                and not cfg.low_memory_mode
                and cfg.output_format in ("bed", "tagalign")):
            # low-memory runs take the records path below, which spills
            # sorted shards and k-way merges them at output
            self._map_paired_end_full_native(native_engine)
            return
        # under --device the batch engine maps only when it was asked for
        # (--engine batch): a native engine that was chosen and failed to
        # load raises, the run never switches engines on its own
        use_batch = (native_engine is None
                     and cfg.batch_engine_eligible(paired=True)
                     and not (cfg.use_device
                              and cfg.native_engine_eligible(paired=True)))
        if cfg.use_device and not use_batch and native_engine is None:
            raise RuntimeError(
                "--device needs the native engine"
                + (f" ({self._native_engine_err})"
                   if self._native_engine_err else "")
                + "; refusing to map on the host instead")

        batch_mapper = None
        if use_batch:
            from .batch.pipeline import BatchMapper
            batch_mapper = BatchMapper(cfg, self.index, self.ref_seqs,
                                       self.ref_lengths, self.selector,
                                       self.candidate_generator,
                                       self.draft_generator)
            if cfg.use_device:
                kind = ("CUDA" if cfg.torch_device == "cuda"
                        else "CPU (plain torch)")
                log(f"Using {kind} Myers verification (batch engine).")

        native_reads = self._native_pair_stream(native_engine)
        generator = MT19937(11)
        t_map = time.time()
        while True:
            with tracing.span("records.read"):
                if native_reads is not None:
                    batch1, batch2 = native_reads.read_batch(
                        cfg.read_batch_size)
                    batch_bc = None
                    tracing.count("records.native_batches")
                else:
                    batch1 = stream1.read_batch(cfg.read_batch_size)
                    batch2 = stream2.read_batch(cfg.read_batch_size)
                    batch_bc = (stream_bc.read_batch(cfg.read_batch_size)
                                if stream_bc else None)
            if len(batch1) != len(batch2) or (
                    batch_bc is not None and len(batch_bc) != len(batch1)):
                raise RuntimeError("Numbers of reads and barcodes don't match!")
            if not batch1:
                break
            batch1, batch2, batch_bc = self._shard_filter_pairs(
                batch1, batch2, batch_bc)
            self.num_reads += 2 * len(batch1)
            threshold = self.cache_paired.get_update_threshold(
                len(batch1), self.num_reads, True, cfg.cache_update_param)
            self._debug_threshold(threshold)
            if (native_engine is not None and batch_bc is not None
                    and cfg.output_format in ("bed", "tagalign")):
                self._map_batch_native_barcoded(native_engine, batch1,
                                                batch2, batch_bc, threshold,
                                                emit)
            elif (native_engine is not None
                  and cfg.output_format == "paf"):
                self._map_batch_native_paf(native_engine, batch1, batch2,
                                           threshold, emit, batch_bc)
            elif (native_engine is not None
                  and cfg.output_format == "sam"):
                self._map_batch_native_sam(native_engine, batch1, batch2,
                                           threshold, emit, batch_bc)
            elif (native_engine is not None
                  and cfg.output_format == "pairs"):
                self._map_batch_native_pairs(native_engine, batch1, batch2,
                                             threshold, emit, batch_bc)
            elif native_engine is not None:
                self._map_batch_native(native_engine, batch1, batch2,
                                       threshold, emit)
            elif batch_mapper is not None:
                batch_mapper.map_pairs(batch1, batch2, generator, emit,
                                       trim=cfg.trim_adapters,
                                       cache=self.cache_paired,
                                       cache_update_threshold=threshold)
                if self.summary is not None:
                    from .summary import CACHEHIT, TOTAL
                    self.summary.update_count(0, TOTAL, len(batch1))
                    self.summary.update_count(
                        0, CACHEHIT, batch_mapper.stats_cache_hits_batch)
                self.cache_hits += batch_mapper.stats_cache_hits_batch
                batch_mapper.stats_cache_hits_batch = 0
            else:
                from .summary import CACHEHIT, TOTAL
                history = ([{}, {}] if threshold > 0 else None)
                nonwhitelist_count = 0
                batch_cache_hits_prev = self.cache_hits
                for bi, (rec1, rec2) in enumerate(zip(batch1, batch2)):
                    barcode_key = 0
                    whitelisted = True
                    if batch_bc is not None:
                        whitelisted, barcode_key = self._process_barcode(
                            batch_bc[bi])
                    if not (whitelisted
                            or cfg.output_mappings_not_in_whitelist):
                        nonwhitelist_count += 1
                        continue
                    if self.summary is not None and batch_bc is not None:
                        self.summary.update_count(barcode_key, TOTAL, 1)
                    self._pair_cache_miss = 2
                    self._pair_mapped = False
                    self._map_one_paired_end(rec1, rec2, k, w, generator,
                                             emit, barcode_key,
                                             batch_bc is not None,
                                             pair_index=bi, history=history,
                                             threshold=threshold)
                    if (self.summary is not None and not cfg.is_bulk_data
                            and self._pair_mapped
                            and self._pair_cache_miss < 2):
                        self.summary.update_count(barcode_key, CACHEHIT, 1)
                if history is not None:
                    # reference updates end1 then end2 per pair, in order
                    for bi in sorted(history[0].keys() | history[1].keys()):
                        for slot in (0, 1):
                            entry = history[slot].get(bi)
                            if entry is not None:
                                h, t, pc, nc, rep = entry
                                self.cache_paired.update(h, t, pc, nc, rep)
                if self.summary is not None:
                    if cfg.is_bulk_data:
                        self.summary.update_count(0, TOTAL, len(batch1))
                        self.summary.update_count(
                            0, CACHEHIT,
                            self.cache_hits - batch_cache_hits_prev)
                    else:
                        self.summary.update_nonwhitelist(TOTAL,
                                                         nonwhitelist_count)
            self._maybe_spill()
            log(f"Mapped {len(batch1)} read pairs.")
        if native_reads is not None:
            native_reads.close()
        if batch_mapper is not None:
            self.num_candidates += batch_mapper.stats_num_candidates
            self.num_mappings += batch_mapper.stats_num_mappings
            self.num_mapped_reads += batch_mapper.stats_num_mapped_reads
            self.num_uniquely_mapped_reads += \
                batch_mapper.stats_num_uniquely_mapped
            log("Batch engine time: " + ", ".join(
                f"{k} {v:.3f}s" for k, v in batch_mapper.seconds.items()))
        self.batch_mapper = batch_mapper
        log(f"Mapped all reads in {time.time() - t_map:.2f}s.")
        self._output_stats()
        if not cfg.is_bulk_data:
            log(f"Number of barcodes in whitelist: "
                f"{self.num_barcode_in_whitelist}.")
            log(f"Number of corrected barcodes: "
                f"{self.num_corrected_barcode}.")
        self._postprocess_and_write(writer)
        self._output_summary()
        self._debug_cache_stats(native_engine, paired=True)
        writer.close()

    def _native_pair_stream(self, native_engine):
        """The paired records loop's reads, read natively as blobs of bases
        and names (NativeFastxPairStream), where every batch goes to
        _map_batch_native or _map_batch_native_pairs as is: the native
        engine maps, the inputs are FASTQ as written (no --read-format),
        bulk (no barcodes, whose correction needs the records) and not
        sharded, and the output is BED, TagAlign or .pairs (SAM and PAF
        take per-read bases and qualities). None keeps the Python reader
        and its SequenceRecords."""
        cfg = self.cfg
        if (native_engine is None or cfg.read_format
                or not cfg.is_bulk_data or cfg.num_shards != 1
                or cfg.output_format not in ("bed", "tagalign", "pairs")
                or not all(map(_starts_fastq, cfg.read_file1_paths
                               + cfg.read_file2_paths))):
            return None
        return NativeFastxPairStream(cfg.read_file1_paths,
                                     cfg.read_file2_paths)

    @staticmethod
    def _minimizer_arrays(minimizers):
        h = np.array([m[0] for m in minimizers], dtype=np.uint64)
        t = np.array([m[1] for m in minimizers], dtype=np.uint64)
        return h, t

    def _seed_with_cache(self, seed: ReadSeedState, read_len: int, cache,
                         history, read_index: int, threshold: int,
                         history_slot: int) -> int:
        """Query the cache, falling back to candidate generation; record
        history for later cache updates. Returns the cache slot index (-1
        on miss)."""
        h, t = self._minimizer_arrays(seed.minimizers)
        hidx, pos, neg, rep = cache.query(h, t, read_len)
        if hidx == -1:
            self.candidate_generator.generate(seed)
        else:
            seed.positive_candidates = pos
            seed.negative_candidates = neg
            seed.repetitive_seed_length = rep
        if history is not None and read_index < threshold:
            history[history_slot][read_index] = (
                h, t, seed.positive_candidates, seed.negative_candidates,
                seed.repetitive_seed_length)
        return hidx

    def _map_one_paired_end(self, rec1: SequenceRecord, rec2: SequenceRecord,
                            k: int, w: int, generator: MT19937, emit,
                            barcode_key: int = 0,
                            has_barcode: bool = False,
                            pair_index: int = 0,
                            history=None, threshold: int = 0) -> None:
        cfg = self.cfg
        if (rec1.length < cfg.min_read_length
                or rec2.length < cfg.min_read_length):
            return
        rec1.prepare_negative()
        rec2.prepare_negative()
        if cfg.trim_adapters:
            trim_adapter_paired(rec1, rec2, cfg.min_read_length)

        seed1 = ReadSeedState()
        seed2 = ReadSeedState()
        seed1.minimizers = generate_minimizers(rec1.codes(), 0, k, w)
        seed2.minimizers = generate_minimizers(rec2.codes(), 0, k, w)
        if not seed1.minimizers or not seed2.minimizers:
            return

        cq1 = self._seed_with_cache(seed1, rec1.length, self.cache_paired,
                                    history, pair_index, threshold, 0)
        cq2 = self._seed_with_cache(seed2, rec2.length, self.cache_paired,
                                    history, pair_index, threshold, 1)
        cache_miss = (1 if cq1 == -1 else 0) + (1 if cq2 == -1 else 0)
        if cq1 >= 0 or cq2 >= 0:
            self.cache_hits += 1
            if (self.summary is not None and not cfg.is_bulk_data
                    and cfg.output_num_uniq_cache_slots):
                sketch = self.kminhash_per_barcode.get(barcode_key)
                if sketch is None:
                    from .summary import KMinHash
                    sketch = KMinHash(self.cfg.k_for_minhash,
                                      self.cfg.cache_size)
                    self.kminhash_per_barcode[barcode_key] = sketch
                if cq1 >= 0:
                    sketch.add(cq1)
                if cq2 >= 0:
                    sketch.add(cq2)
        self._pair_cache_miss = cache_miss
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
        self.num_candidates += n1 + n2

        if self.custom_rid_rank is not None:
            # chromap.h:1060-1074 reranks candidate rids to the custom order
            # before verification (paired-end only; the single-end call site
            # runs before candidates exist and is a no-op)
            for state in (seed1, seed2):
                for cands in (state.positive_candidates,
                              state.negative_candidates):
                    for c in cands:
                        rid = self.custom_rid_rank[c.position >> 32]
                        c.position = (c.position & 0xFFFFFFFF) | (rid << 32)

        read1 = bytes(rec1.seq)
        read2 = bytes(rec2.seq)
        negative_read1 = rec1.negative()
        negative_read2 = rec2.negative()

        vs1 = self.draft_generator.generate(read1, negative_read1, seed1,
                                            self.ref_seqs, self.ref_lengths)
        vs2 = self.draft_generator.generate(read2, negative_read2, seed2,
                                            self.ref_seqs, self.ref_lengths)
        if vs1.num_draft_mappings() == 0 or vs2.num_draft_mappings() == 0:
            return

        if not cfg.split_alignment:
            vs1.positive_mappings.sort(key=lambda m: m.position)
            vs1.negative_mappings.sort(key=lambda m: m.position)
            vs2.positive_mappings.sort(key=lambda m: m.position)
            vs2.negative_mappings.sort(key=lambda m: m.position)

        force_mapq = -1
        if supplement_result != 0:
            force_mapq = 0

        ctx = PairContext(
            read_id=rec1.read_id, read1_name=rec1.name, read2_name=rec2.name,
            read1=read1, read2=read2, negative_read1=negative_read1,
            negative_read2=negative_read2, read1_length=rec1.length,
            read2_length=rec2.length,
            qual1=bytes(rec1.qual) if rec1.qual else None,
            qual2=bytes(rec2.qual) if rec2.qual else None,
            barcode_key=barcode_key, has_barcode=has_barcode,
            seed1=seed1, seed2=seed2, vs1=vs1, vs2=vs2)
        pe_state = PairedVerifyState(vs1=vs1, vs2=vs2)
        self.selector.select_paired_end(ctx, pe_state, generator, force_mapq,
                                        emit)

        if pe_state.num_best_mappings == 1:
            self.num_uniquely_mapped_reads += 2
        self.num_mappings += 2 * min(pe_state.num_best_mappings,
                                     self.cfg.max_num_best_mappings)
        if pe_state.num_best_mappings > 0:
            self.num_mapped_reads += 2
            self._pair_mapped = True

    # --------------------------- shared post steps ---------------------------

    def _debug_threshold(self, threshold: int) -> None:
        if self.cfg.debug_cache:
            # per-batch threshold trace (--debug-cache, chromap.h:888)
            print(f"[DEBUG][UPDATE] update_threshold = {threshold}")

    def _debug_cache_stats(self, native_engine, paired: bool = True) -> None:
        """End-of-run per-slot cache dump (--debug-cache, chromap.h:1402)."""
        if not self.cfg.debug_cache:
            return
        if native_engine is not None:
            native_engine.cache_print_stats()
        elif paired:
            self.cache_paired.print_stats()
        else:
            self.cache_single.print_stats()

    def _output_stats(self) -> None:
        log(f"Number of reads: {self.num_reads}.")
        log(f"Number of mapped reads: {self.num_mapped_reads}.")
        log(f"Number of uniquely mapped reads: "
            f"{self.num_uniquely_mapped_reads}.")
        log(f"Number of reads have multi-mappings: "
            f"{self.num_mapped_reads - self.num_uniquely_mapped_reads}.")
        log(f"Number of candidates: {self.num_candidates}.")
        log(f"Number of mappings: {self.num_mappings}.")

    def _stash_bed_rows(self, rid_a, out, oid, bcs, se: bool) -> None:
        """Collect one batch's SE/PE BED rows as a structured spill chunk
        (the array analog of the record emit loops)."""
        from .io.lowmem import PE_SPILL_DT, SE_SPILL_DT
        n = len(rid_a)
        arr = np.zeros(n, dtype=SE_SPILL_DT if se else PE_SPILL_DT)
        j = out["read_id"]
        arr["read_id"] = oid[j]
        if bcs is not None:
            arr["barcode"] = bcs[j]
            arr["hasbc"] = 1
        arr["start"] = out["start"]
        arr["length"] = out["flen"]
        arr["mapq"] = out["mapq"]
        arr["dir"] = out["dir"]
        arr["uniq"] = out["uniq"]
        arr["dups"] = 1
        if not se:
            arr["posalen"] = out["posalen"]
            arr["negalen"] = out["negalen"]
        chunks = getattr(self, "_spill_chunks", None)
        if chunks is None:
            chunks = self._spill_chunks = []
        chunks.append((rid_a.astype(np.int64), arr))
        self.num_mappings_in_mem += n

    def _array_spill_ok(self) -> bool:
        """BED-family low-mem/shard runs collect mapping rows as numpy
        chunks and spill them vectorized (spill_pe_arrays); record objects
        remain for text formats, the matrix, and allocation."""
        cfg = self.cfg
        return ((cfg.low_memory_mode or cfg.num_shards > 1)
                and cfg.output_format in ("bed", "tagalign")
                and not cfg.matrix_output_prefix
                and not cfg.allocate_multi_mappings)

    @tracing.traced("lowmem.spill")
    def _spill_now(self, base) -> None:
        from .io.lowmem import spill_mappings, spill_bed_arrays
        files = len(self.temp_shard_paths)
        chunks = getattr(self, "_spill_chunks", None)
        if chunks:
            spill_bed_arrays(self.cfg, chunks, len(self.ref_names),
                             self.temp_shard_paths, base=base)
            chunks.clear()
            if any(self.mappings_on_refs):  # defensive: mixed emitters
                spill_mappings(self.cfg, self.mappings_on_refs,
                               self.temp_shard_paths, base=base)
        else:
            spill_mappings(self.cfg, self.mappings_on_refs,
                           self.temp_shard_paths, base=base)
        tracing.count("lowmem.spills", len(self.temp_shard_paths) - files)

    def _maybe_spill(self) -> None:
        """Spill sorted shards when over budget (low-memory mode)."""
        cfg = self.cfg
        if not (cfg.low_memory_mode or cfg.num_shards > 1):
            return
        if self.num_mappings_in_mem <= self.max_mappings_in_mem:
            return
        base = None
        if cfg.num_shards > 1:
            base = f"{cfg.mapping_output_file_path}.shard{cfg.shard_index}"
        self._spill_now(base)
        if (len(self.temp_shard_paths) > 850
                and len(self.temp_shard_paths) % 10 == 1):
            # past 850 temp files, double the per-file volume so the file
            # count stays bounded (chromap.h:1263-1267)
            self.max_mappings_in_mem <<= 1
            log(f"Used {len(self.temp_shard_paths)} temp files. Double the "
                f"temp file volume to {self.max_mappings_in_mem}")
        self.num_mappings_in_mem = 0

    def _map_paired_end_full_native(self, engine) -> None:
        """The paired-end full-native flow (`_map_full_native`)."""
        self._map_full_native(engine, paired=True)

    def _map_full_native(self, engine, paired: bool) -> None:
        """Native FASTQ reading, mapping (cn_map_pairs or cn_map_single),
        postprocess and write, with no Python per-read or per-record
        objects anywhere on the hot path; under --device the chunks go
        through the device-chunk scheduler."""
        import ctypes as _ct

        from .native import NativeFastxReader, native_postprocess_write

        cfg = self.cfg
        t_map = time.time()
        outs: List[dict] = []
        if paired:
            files = list(zip(cfg.read_file1_paths, cfg.read_file2_paths))
            map_raw = engine.map_pairs_raw
            map_seeded = engine.map_pairs_dev_seeded
            pack = engine.lib.cn_pack_reads
            cache, update_param = self.cache_paired, cfg.cache_update_param
        else:
            files = [(path,) for path in cfg.read_file1_paths]
            map_raw = engine.map_single_raw
            map_seeded = engine.map_single_dev_seeded
            pack = engine.lib.cn_pack_reads_se
            cache, update_param = self.cache_single, 0.01

        def account(out_stats):
            out, stats = out_stats
            outs.append(out)
            self.num_candidates += int(stats[0])
            self.num_mappings += int(stats[1])
            self.num_mapped_reads += int(stats[2])
            self.num_uniquely_mapped_reads += int(stats[3])
            self.cache_hits += int(stats[4])

        def map_host(chunk):
            account(map_raw(*chunk.args(), chunk.n, chunk.base_read_id,
                            chunk.threshold))

        def finish(chunk, meta, cand_pos, cand_meta):
            account(map_seeded(*chunk.args(), chunk.n, chunk.base_read_id,
                               meta, cand_pos, cand_meta))

        def chunks(batch_n: int):
            """The reads in batches of batch_n, each a chunk that points
            into its readers' buffers (valid until the batch after
            next)."""
            base_read_id = 0
            for paths in files:
                stream = self._PrefetchStream(
                    [NativeFastxReader(path) for path in paths], batch_n)
                try:
                    while True:
                        batches = stream.next()
                        n = batches[0][0]
                        if any(b[0] != n for b in batches):
                            raise RuntimeError(
                                "Numbers of reads and barcodes don't match!")
                        if n == 0:
                            break
                        self.num_reads += len(paths) * n
                        threshold = cache.get_update_threshold(
                            n, self.num_reads, paired, update_param)
                        self._debug_threshold(threshold)
                        ends = tuple(
                            (b, np.ctypeslib.as_array(
                                _ct.cast(o, _ct.POINTER(_ct.c_int64)),
                                shape=(n + 1,)))
                            for _, b, o in batches)
                        yield Chunk(ends, base_read_id, threshold,
                                    tracing.chunk_ids(1))
                        base_read_id += n
                        log(f"Mapped {n} read pairs." if paired
                            else f"Mapped {n} reads.")
                finally:
                    # also when a device error propagates (it is never
                    # turned into a host run)
                    stream.close()

        hyb = self._hybrid()
        flow = Flow(pack, map_host, finish, copy=True)
        if self._seeds_on_device(paired):
            with contextlib.closing(chunks(hyb.size(len(files[0])))) as it:
                hyb.run(it, flow, flush=self._hybrid_flush)
        else:
            for chunk in chunks(cfg.read_batch_size):
                hyb.map_host(flow, chunk)
        log(f"Mapped all reads in {time.time() - t_map:.2f}s.")
        self._output_stats()

        with tracing.span("output.concat"):
            arrays = {key: (np.concatenate([o[key] for o in outs])
                            if outs else np.empty(0))
                      for key in ("rid", "read_id", "start", "flen", "mapq",
                                  "dir", "uniq", "posalen", "negalen")}
        with tracing.span("output.native"):
            written, uni, multi = native_postprocess_write(
                cfg, self.ref_names, arrays, tn5=cfg.tn5_shift,
                dedup=cfg.remove_pcr_duplicates, se_mode=not paired)
        if cfg.remove_pcr_duplicates:
            log(f"{uni + multi} mappings left after deduplication.")
        log(f"# uni-mappings: {uni}, # multi-mappings: {multi}, "
            f"total: {uni + multi}.")
        log(f"Number of output mappings (passed filters): {written}")
        self._debug_cache_stats(engine, paired=paired)

    class _PrefetchStream:
        """Reads the next FASTQ batch on a worker thread while the current
        one maps (chromap.h:871-877's load/map overlap); safe because the
        native reader ping-pongs its batch buffers. On a single-core host
        the thread only adds contention, so it reads inline instead."""

        def __init__(self, readers, batch_n: int):
            import os as _os
            self.readers = readers
            self.batch_n = batch_n
            self.ex = None
            self.fut = None
            ncpu = _os.cpu_count() or 1
            if ncpu > 1:
                from concurrent.futures import ThreadPoolExecutor
                # one worker per file when cores allow: r1/r2 parse
                # concurrently, the analog of the reference's parallel
                # input-parsing tasks (chromap.cc:53-83)
                self.ex = ThreadPoolExecutor(
                    max_workers=min(len(readers), max(1, ncpu - 1)))
                self.fut = self._submit()

        def _submit(self):
            return [self.ex.submit(r.read_batch, self.batch_n)
                    for r in self.readers]

        def _read(self):
            return [r.read_batch(self.batch_n) for r in self.readers]

        @tracing.traced("fastq.wait")
        def next(self):
            if self.ex is None:
                return self._read()
            res = [f.result() for f in self.fut]
            if res[0][0] > 0:
                self.fut = self._submit()
            return res

        def close(self):
            if self.ex is not None:
                self.ex.shutdown(wait=True)
            for r in self.readers:
                r.close()

    def _get_seeder(self):
        """The (process-cached) device seeder on cfg.torch_device, or None
        when the configuration routes every chunk to the host (e >= 16).
        A seeder that fails to build raises: the run never drops to the
        host on its own. Index/reference tensors stay resident on the
        device across pipelines over the same index."""
        if self._device_seeder is None:
            cfg = self.cfg
            if cfg.error_threshold >= 16:
                # the device program holds the band in 32-bit words
                self._device_seeder = False
                return None
            from .ops.device_seed import get_device_seeder
            # the device program works in index space (candidate rids come
            # from the index), so its reference gathers must use the load
            # order even when --chr-order reordered self.ref_seqs; the
            # native finish reranks candidate rids after reduction exactly
            # like the host path (engine.cpp cn_set_rid_rank)
            seed_refs = self.ref_seqs
            if self.custom_rid_rank is not None:
                seed_refs = [self.ref_seqs[r] for r in self.custom_rid_rank]
            key = []
            import os as _os
            for path in (cfg.index_file_path, cfg.reference_file_path):
                key.append(path)
                key.append(_os.path.getmtime(path))
            self._device_seeder = get_device_seeder(
                self.index, seed_refs, cfg.error_threshold,
                cfg.min_num_seeds_required_for_mapping,
                cfg.max_seed_frequencies, cache_key=tuple(key),
                mesh_devices=cfg.mesh_devices,
                split=cfg.split_alignment, device=cfg.torch_device)
            kind = ("CUDA" if self._device_seeder.device.type == "cuda"
                    else "CPU (plain torch)")
            n_dev = getattr(self._device_seeder, "n_dev", 1)
            mesh_note = (f" ({n_dev}-device data mesh)" if n_dev > 1
                         else "")
            log(f"Using {kind} device seeding + verification{mesh_note}.")
        return self._device_seeder or None

    def _hybrid(self) -> DeviceChunks:
        """The pipeline's device-chunk scheduler (hybrid.py); its group
        size carries over from pass to pass."""
        if self._device_chunks is None:
            self._device_chunks = DeviceChunks(
                self._get_seeder, self.cfg.device_batch_size,
                self.cfg.read_batch_size)
        return self._device_chunks

    def _hybrid_tuner(self):
        """The scheduler's tuner; `.g` is the group size it has set."""
        return self._hybrid().tuner

    def _hybrid_flush(self, flow, final: bool) -> None:
        """One group of a full-native flow (`DeviceChunks.flush`). It is
        a method of the pipeline so that a caller can time those groups
        apart from `_map_pairs_hybrid`, inside which the records flows'
        groups run."""
        self._hybrid().flush(flow, final)

    def _seeds_on_device(self, paired: bool) -> bool:
        """Whether a flow's chunks go through the device-chunk scheduler.
        Single-end runs with --split-alignment or --chr-order stay on the
        host: the reference's single-end rerank call site is a no-op
        (chromap.h:418-419), so the host gathers the reordered reference
        at index-space rids, which the index-space seeder would not."""
        cfg = self.cfg
        return cfg.use_device and (paired or not (
            cfg.split_alignment or cfg.custom_rid_order_file_path))

    def _map_batch_chunks(self, ends, base_read_id: int, threshold: int,
                          flow) -> None:
        """Map a records batch (`ends` as in hybrid.Chunk): on the host
        in one call, or, under --device and with more reads than one
        chunk holds, chunk by chunk through the device-chunk scheduler,
        each chunk taking the cache-update threshold's share that falls
        in it."""
        hyb = self._hybrid()
        n = len(ends[0][1]) - 1
        C = hyb.size(len(ends))
        if not (self._seeds_on_device(paired=len(ends) == 2) and n > C):
            hyb.map_host(flow, Chunk(ends, base_read_id, threshold,
                                     tracing.chunk_ids(1)))
            return
        c0 = tracing.chunk_ids(-(-n // C))
        hyb.run((Chunk(tuple((b, o[s:min(s + C, n) + 1]) for b, o in ends),
                       base_read_id + s,
                       max(0, min(threshold - s, C, n - s)),
                       c0 + s // C)
                 for s in range(0, n, C)), flow)

    class _HybridInfo:
        """Per-batch side channels stitched across hybrid chunks (the
        engine's getters only cover its last call)."""

        def __init__(self):
            self.flags = None
            self.tl1 = None
            self.tl2 = None
            self.aux = None

    @staticmethod
    def _merge_sam_aux(auxes):
        """Concatenate per-chunk (cigar_buf, cigar_off, md_buf, md_off,
        nm) streams, rebasing the offset arrays."""
        cig = [a[0] for a in auxes]
        nm = [a[4] for a in auxes]
        cig_off = [np.zeros(1, dtype=np.int64)]
        md_off = [np.zeros(1, dtype=np.int64)]
        cbase = 0
        mbase = 0
        for a in auxes:
            cig_off.append(a[1][1:] + cbase)
            cbase += int(a[1][-1])
            md_off.append(a[3][1:] + mbase)
            mbase += int(a[3][-1])
        md = b"".join(a[2] for a in auxes)
        return (np.concatenate(cig) if cig else np.empty(0, np.uint32),
                np.concatenate(cig_off), md, np.concatenate(md_off),
                np.concatenate(nm) if nm else np.empty(0, np.uint16))

    @tracing.traced("hybrid")
    def _map_pairs_hybrid(self, engine, reads1, reads2, base_read_id: int,
                          threshold: int, full: bool = False,
                          sam: bool = False, want_info: bool = False):
        """map_pairs_raw / map_pairs_full_raw over a records batch
        (barcoded, low-mem, summary, PAF/SAM/pairs), its device-eligible
        chunks seeded on the card (`_map_batch_chunks`). reads1 and
        reads2 are each a blob of bases (bytes, or a pointer into a
        native reader's buffers) and its n+1 int64 offsets (_blob). The
        scheduler selects in chunk order, so the mapping records equal
        the host-only call's.

        Returns (out, stats) -- plus a _HybridInfo when want_info (per-
        pair cache-hit flags, trimmed lengths, merged SAM aux)."""
        n = len(reads1[1]) - 1
        outs, auxes = [], []
        stats = np.zeros(5, dtype=np.int64)
        info = self._HybridInfo() if want_info else None
        if info is not None:
            info.flags = np.zeros(n, dtype=np.uint8)
            if self.cfg.trim_adapters:
                info.tl1 = np.zeros(n, dtype=np.uint16)
                info.tl2 = np.zeros(n, dtype=np.uint16)

        def keep(chunk, out, st, aux=None):
            outs.append(out)
            stats[:] += st
            if sam:
                auxes.append(aux if aux is not None else engine.get_sam_aux())
            if info is None:
                return
            s = chunk.base_read_id - base_read_id
            info.flags[s:s + chunk.n] = engine.get_pair_flags()[:chunk.n]
            if info.tl1 is not None:
                t1, t2 = engine.get_pair_trimmed_lengths()
                info.tl1[s:s + chunk.n] = t1[:chunk.n]
                info.tl2[s:s + chunk.n] = t2[:chunk.n]

        def map_host(chunk):
            args = (*chunk.args(), chunk.n, chunk.base_read_id,
                    chunk.threshold)
            if full:
                keep(chunk, *engine.map_pairs_full_raw(*args, sam_aux=sam))
            else:
                keep(chunk, *engine.map_pairs_raw(*args))

        def finish(chunk, meta, cand_pos, cand_meta):
            seeded = (engine.map_pairs_dev_seeded_full if full
                      else engine.map_pairs_dev_seeded)
            keep(chunk, *seeded(*chunk.args(), chunk.n, chunk.base_read_id,
                                meta, cand_pos, cand_meta))

        self._map_batch_chunks(
            (reads1, reads2), base_read_id, threshold,
            Flow(engine.lib.cn_pack_reads, map_host, finish))
        out = {key: np.concatenate([o[key] for o in outs])
               for key in outs[0]}
        if info is None:
            return out, stats
        if full and sam:
            info.aux = self._merge_sam_aux(auxes)
        return out, stats, info

    @tracing.traced("hybrid")
    def _map_single_hybrid(self, engine, reads, base_read_id: int,
                           threshold: int, sam: bool = False):
        """map_single_raw over a records batch, `reads` a blob of bases
        and its offsets (_blob), its device-eligible chunks seeded on the
        card (`_map_batch_chunks`). Returns (out, stats[, aux])."""
        outs, auxes = [], []
        stats = np.zeros(5, dtype=np.int64)

        def keep(out_stats):
            out, st = out_stats
            outs.append(out)
            stats[:] += st
            if sam:
                auxes.append(engine.get_sam_aux())

        def map_host(chunk):
            keep(engine.map_single_raw(*chunk.args(), chunk.n,
                                       chunk.base_read_id, chunk.threshold))

        def finish(chunk, meta, cand_pos, cand_meta):
            keep(engine.map_single_dev_seeded(*chunk.args(), chunk.n,
                                              chunk.base_read_id, meta,
                                              cand_pos, cand_meta))

        self._map_batch_chunks(
            (reads,), base_read_id, threshold,
            Flow(engine.lib.cn_pack_reads_se, map_host, finish))
        out = {key: np.concatenate([o[key] for o in outs])
               for key in outs[0]}
        if not sam:
            return out, stats
        return out, stats, self._merge_sam_aux(auxes)

    def _map_batch_native(self, engine, batch1, batch2, threshold,
                          emit) -> None:
        """Map one batch through the C++ host engine."""
        from .mapping.records import PEBedRecord
        from .summary import CACHEHIT, TOTAL

        with tracing.span("records.pack"):
            if isinstance(batch1, NativeReadBatch):
                reads1 = batch1.bases, batch1.offsets
                reads2 = batch2.bases, batch2.offsets
                orig_ids = batch1.read_ids()
            else:
                reads1 = _blob([r.seq for r in batch1])
                reads2 = _blob([r.seq for r in batch2])
                # sharded batches have strided read ids: map indices
                # explicitly
                orig_ids = np.asarray([r.read_id for r in batch1],
                                      dtype=np.uint32)
        out, stats = self._map_pairs_hybrid(engine, reads1, reads2, 0,
                                            threshold)
        with tracing.span("records.emit"):
            rid_a = out["rid"]
            if self._array_spill_ok():
                self._stash_bed_rows(rid_a, out, orig_ids, None, se=False)
            else:
                for i in range(len(rid_a)):
                    rec = PEBedRecord(
                        read_id=int(orig_ids[int(out["read_id"][i])]),
                        barcode=0,
                        start=int(out["start"][i]),
                        length=int(out["flen"][i]),
                        mapq=int(out["mapq"][i]),
                        direction=int(out["dir"][i]),
                        is_unique=int(out["uniq"][i]), num_dups=1,
                        positive_alignment_length=int(out["posalen"][i]),
                        negative_alignment_length=int(out["negalen"][i]))
                    emit(int(rid_a[i]), rec)
        self.num_candidates += int(stats[0])
        self.num_mappings += int(stats[1])
        self.num_mapped_reads += int(stats[2])
        self.num_uniquely_mapped_reads += int(stats[3])
        self.cache_hits += int(stats[4])
        if self.summary is not None:
            self.summary.update_count(0, TOTAL, len(batch1))
            self.summary.update_count(0, CACHEHIT, int(stats[4]))

    def _native_barcode_prefilter(self, batch1, batch2, batch_bc):
        """Extract/correct every barcode and keep whitelisted pairs for the
        native mapper. Returns (reads1, reads2, barcode_keys, sel_indices)
        where sel_indices are positions into the input batch; also updates
        per-barcode summary TOTAL counts.

        Vectorized exact-whitelist fast path (chromap.cc:589-593): pack
        every barcode, one searchsorted against the sorted whitelist; only
        N-containing or non-exact barcodes take the per-read correction
        (chromap.cc:572-799)."""
        cfg = self.cfg
        nb = len(batch_bc)
        blen = self.barcode_length
        exact = np.zeros(nb, dtype=bool)
        keys = np.zeros(nb, dtype=np.uint64)
        if nb:
            from .utils import encode_sequence
            buf = b"".join(bytes(rec.seq[:blen]) for rec in batch_bc)
            if len(buf) == nb * blen:
                codes_mat = encode_sequence(buf).reshape(nb, blen)
            elif self.whitelist is not None:
                # a short barcode read: per-record fallback
                codes_mat = np.stack(
                    [rec.codes()[:blen] for rec in batch_bc])
            else:
                codes_mat = None
            if codes_mat is not None:
                weights = (np.uint64(4)
                           ** np.arange(blen - 1, -1, -1, dtype=np.uint64))
                keys = (np.where(codes_mat < 4, codes_mat, 0)
                        .astype(np.uint64) @ weights)
                if self.whitelist is not None:
                    clean = (codes_mat < 4).all(axis=1) & \
                        (codes_mat.shape[1] == blen)
                    wl = self.whitelist.sorted_keys()
                    loc = np.searchsorted(wl, keys)
                    loc = (np.minimum(loc, len(wl) - 1) if len(wl)
                           else loc)
                    exact = clean & (wl[loc] == keys if len(wl) else False)
                    self.num_barcode_in_whitelist += int(exact.sum())
                else:
                    # no whitelist: the packed key IS the barcode
                    # (generate_seed_from_codes maps N/out-of-range to 0)
                    exact[:] = True

        keep = np.ones(nb, dtype=bool)
        nonwhitelist_count = 0
        nonexact = np.flatnonzero(~exact)
        if len(nonexact):
            keys = keys.copy()
            for bi in nonexact.tolist():
                whitelisted, barcode_key = self._process_barcode(
                    batch_bc[bi])
                keys[bi] = barcode_key
                if not (whitelisted
                        or cfg.output_mappings_not_in_whitelist):
                    keep[bi] = False
                    nonwhitelist_count += 1
        orig_ids = np.flatnonzero(keep).tolist()
        reads1 = [bytes(batch1[i].seq) for i in orig_ids]
        reads2 = [bytes(batch2[i].seq) for i in orig_ids]
        barcodes = keys[keep].tolist()
        if self.summary is not None:
            from .summary import TOTAL
            if barcodes:
                uk, cnt = np.unique(np.asarray(barcodes, dtype=np.uint64),
                                    return_counts=True)
                for key, c in zip(uk.tolist(), cnt.tolist()):
                    self.summary.update_count(int(key), TOTAL, int(c))
            self.summary.update_nonwhitelist(TOTAL, nonwhitelist_count)
        return reads1, reads2, barcodes, orig_ids

    def _native_barcode_cachehits(self, engine, out, num_pairs,
                                  barcodes, flags=None) -> None:
        """Per-barcode CACHEHIT summary counts from the native engine's
        per-pair flags (summary_metadata.h:17-25 semantics: a mapped pair
        whose either end hit the candidate cache)."""
        if self.summary is None:
            return
        from .summary import CACHEHIT
        hits = engine.get_pair_flags() if flags is None else flags
        mapped = np.zeros(num_pairs, dtype=bool)
        mapped[out["read_id"]] = True
        for j in np.flatnonzero(mapped & (hits[:num_pairs] > 0)):
            self.summary.update_count(barcodes[int(j)], CACHEHIT, 1)

    def _map_batch_native_barcoded(self, engine, batch1, batch2, batch_bc,
                                   threshold, emit) -> None:
        """Barcoded (single-cell) batch through the C++ mapper: barcode
        extraction/correction/translation stays in Python, pairs that pass
        the whitelist map natively, records carry the barcode key for
        cell-level dedup and fragment output downstream."""
        from .mapping.records import PEBedRecord

        with tracing.span("records.pack"):
            reads1, reads2, barcodes, sel = self._native_barcode_prefilter(
                batch1, batch2, batch_bc)
            blob1, blob2 = _blob(reads1), _blob(reads2)
        if not reads1:
            return
        out, stats, info = self._map_pairs_hybrid(engine, blob1, blob2,
                                                  0, threshold,
                                                  want_info=True)
        with tracing.span("records.emit"):
            self._native_barcode_cachehits(engine, out, len(reads1),
                                           barcodes, flags=info.flags)
            rid_a = out["rid"]
            oid = np.asarray([batch1[bi].read_id for bi in sel],
                             dtype=np.uint32)
            bcs = np.asarray(barcodes, dtype=np.uint64)
            idx = out["read_id"]
            if self._array_spill_ok():
                self._stash_bed_rows(rid_a, out, oid, bcs, se=False)
            else:
                for i in range(len(rid_a)):
                    j = int(idx[i])
                    rec = PEBedRecord(
                        read_id=int(oid[j]), barcode=int(bcs[j]),
                        start=int(out["start"][i]),
                        length=int(out["flen"][i]),
                        mapq=int(out["mapq"][i]),
                        direction=int(out["dir"][i]),
                        is_unique=int(out["uniq"][i]), num_dups=1,
                        positive_alignment_length=int(out["posalen"][i]),
                        negative_alignment_length=int(out["negalen"][i]),
                        has_barcode=True)
                    emit(int(rid_a[i]), rec)
        self.num_candidates += int(stats[0])
        self.num_mappings += int(stats[1])
        self.num_mapped_reads += int(stats[2])
        self.num_uniquely_mapped_reads += int(stats[3])
        self.cache_hits += int(stats[4])

    def _map_batch_native_paf(self, engine, batch1, batch2, threshold,
                              emit, batch_bc=None) -> None:
        """Paired-end PAF through the C++ mapper. The reference stores the
        pair MAPQ in both per-end slots and scrambles the length fields
        (mapping_generator.cc:146-169); the record construction mirrors
        select.py's per-read emission exactly. Barcoded runs prefilter on
        the whitelist; trimmed runs take per-pair lengths from the engine."""
        from .mapping.records import PairedPafRecord, clip_mapq

        cfg = self.cfg
        with tracing.span("records.pack"):
            if batch_bc is not None:
                reads1, reads2, barcodes, sel = \
                    self._native_barcode_prefilter(batch1, batch2, batch_bc)
                base_read_id = 0
            else:
                reads1 = [bytes(r.seq) for r in batch1]
                reads2 = [bytes(r.seq) for r in batch2]
                barcodes = None
                sel = list(range(len(batch1)))
                base_read_id = batch1[0].read_id if batch1 else 0
            blob1, blob2 = _blob(reads1), _blob(reads2)
        if not reads1:
            return
        out, stats, info = self._map_pairs_hybrid(engine, blob1, blob2,
                                                  base_read_id, threshold,
                                                  want_info=True)
        with tracing.span("records.emit"):
            if batch_bc is not None:
                self._native_barcode_cachehits(engine, out, len(reads1),
                                               barcodes, flags=info.flags)
            tl1, tl2 = info.tl1, info.tl2
            rid_a = out["rid"]
            o_read_id = out["read_id"].tolist()
            o_rid = rid_a.tolist()
            o_start = out["start"].tolist()
            o_mapq = out["mapq"].tolist()
            o_dir, o_uniq = out["dir"].tolist(), out["uniq"].tolist()
            o_pal = out["posalen"].tolist()
            o_nal = out["negalen"].tolist()
            o_flen = out["flen"].tolist()
            for i in range(len(rid_a)):
                j = o_read_id[i] - base_read_id
                bj = sel[j]
                mapq = o_mapq[i]
                l1 = int(tl1[j]) if tl1 is not None else len(reads1[j])
                l2 = int(tl2[j]) if tl2 is not None else len(reads2[j])
                emit(o_rid[i], PairedPafRecord(
                    read_id=int(batch1[bj].read_id),
                    read1_name=batch1[bj].name, read2_name=batch2[bj].name,
                    read1_length=l1, read2_length=l2,
                    start=o_start[i],
                    negative_alignment_length=o_pal[i],
                    length=o_nal[i],
                    positive_alignment_length=o_flen[i],
                    mapq=mapq, mapq1=clip_mapq(mapq), mapq2=clip_mapq(mapq),
                    direction=o_dir[i],
                    is_unique=o_uniq[i], num_dups=1))
        self.num_candidates += int(stats[0])
        self.num_mappings += int(stats[1])
        self.num_mapped_reads += int(stats[2])
        self.num_uniquely_mapped_reads += int(stats[3])
        self.cache_hits += int(stats[4])

    def _map_batch_native_sam(self, engine, batch1, batch2, threshold,
                              emit, batch_bc=None) -> None:
        """Paired-end SAM through the C++ mapper: positions, CIGAR, NM and
        MD come from the native affine semi-global recover path; flags,
        mate fields, sequence orientation and qualities are assembled here
        exactly as the per-read path does (select.py SAM emission).
        Barcoded runs prefilter on the whitelist; trimmed runs slice the
        sequences/qualities to the engine's per-pair trimmed lengths."""
        from .mapping.cigar import sequence_length_from_cigar
        from .mapping.records import SamRecord

        cfg = self.cfg
        if not getattr(engine, "_sam_params_set", False):
            engine.set_sam_params()
            engine._sam_params_set = True

        with tracing.span("records.pack"):
            if batch_bc is not None:
                reads1, reads2, barcodes, sel = \
                    self._native_barcode_prefilter(batch1, batch2, batch_bc)
                base_read_id = 0
            else:
                reads1 = [bytes(r.seq) for r in batch1]
                reads2 = [bytes(r.seq) for r in batch2]
                barcodes = None
                sel = list(range(len(batch1)))
                base_read_id = batch1[0].read_id if batch1 else 0
            blob1, blob2 = _blob(reads1), _blob(reads2)
        if not reads1:
            return
        out, stats, info = self._map_pairs_hybrid(engine, blob1, blob2,
                                                  base_read_id, threshold,
                                                  full=True, sam=True,
                                                  want_info=True)
        with tracing.span("records.emit"):
            if batch_bc is not None:
                self._native_barcode_cachehits(engine, out, len(reads1),
                                               barcodes, flags=info.flags)
            tl1, tl2 = info.tl1, info.tl2
            cig_buf, cig_off, md_buf, md_off, nm_arr = info.aux
            rid_a = out["rid"]
            # row-wise python lists beat per-element numpy scalar conversion
            # in this per-record loop
            o_read_id = out["read_id"].tolist()
            o_dir = out["dir"].tolist()
            o_rid = rid_a.tolist()
            o_rs1, o_re1 = out["rs1"].tolist(), out["re1"].tolist()
            o_rs2, o_re2 = out["rs2"].tolist(), out["re2"].tolist()
            o_mapq, o_uniq = out["mapq"].tolist(), out["uniq"].tolist()
            cig_list = cig_buf.tolist()
            cig_off_l = cig_off.tolist()
            nm_list = nm_arr.tolist()
            prev_read_id = None
            occurrence = 0
            for i in range(len(rid_a)):
                j = o_read_id[i] - base_read_id
                bj = sel[j]
                read_id = int(batch1[bj].read_id)
                occurrence = occurrence + 1 if read_id == prev_read_id else 0
                prev_read_id = read_id
                first_negative = o_dir[i] == 0
                rid = o_rid[i]
                rs1, re1 = o_rs1[i], o_re1[i]
                rs2, re2 = o_rs2[i], o_re2[i]
                mapq = o_mapq[i]
                uniq = o_uniq[i]
                barcode = int(barcodes[j]) if barcodes is not None else 0
                tlen = (re1 - rs2 + 1) if first_negative else (re2 - rs1 + 1)
                flag1, flag2 = 3, 3
                if first_negative:
                    flag1 |= 0x10
                    flag2 |= 0x20
                else:
                    flag1 |= 0x20
                    flag2 |= 0x10
                flag1 |= 0x40
                flag2 |= 0x80
                if occurrence >= 1:
                    flag1 |= 0x100
                    flag2 |= 0x100
                for (end, rec, flagv, pos, mpos, neg, tl) in (
                        (0, batch1[bj], flag1, rs1, rs2, first_negative,
                         int(tl1[j]) if tl1 is not None else None),
                        (1, batch2[bj], flag2, rs2, rs1, not first_negative,
                         int(tl2[j]) if tl2 is not None else None)):
                    k = 2 * i + end
                    cigar = cig_list[cig_off_l[k]:cig_off_l[k + 1]]
                    md = md_buf[md_off[k]:md_off[k + 1]]
                    full = bytes(rec.seq)
                    qual = bytes(rec.qual or b"")
                    if tl is not None and tl < len(full):
                        # adapter-trimmed: the record carries the trimmed
                        # prefix (TrimSequenceAt shrinks seq+qual in place)
                        full = full[:tl]
                        qual = qual[:tl]
                    if neg:
                        seq = reverse_complement_ascii(full)
                        qual = qual[::-1]
                    else:
                        seq = full
                    ncons = sequence_length_from_cigar(cigar)
                    if ncons != len(seq):
                        seq, qual = seq[:ncons], qual[:ncons]
                    strand_bit = 0 if neg else 1
                    emit(rid, SamRecord(
                        read_id=read_id, read_name=rec.name, barcode=barcode,
                        num_dups=1, pos=pos, rid=rid, mpos=mpos, mrid=rid,
                        tlen=tlen if strand_bit else -tlen, flag=flagv,
                        direction=strand_bit, is_unique=uniq, mapq=mapq,
                        NM=nm_list[k], cigar=cigar, MD=md,
                        sequence=seq, qual=qual))
        self.num_candidates += int(stats[0])
        self.num_mappings += int(stats[1])
        self.num_mapped_reads += int(stats[2])
        self.num_uniquely_mapped_reads += int(stats[3])
        self.cache_hits += int(stats[4])

    def _map_batch_native_pairs(self, engine, batch1, batch2, threshold,
                                emit, batch_bc=None) -> None:
        """4DN pairs (non-split) through the C++ mapper: per-end positions
        come from the extended outputs; rid flipping by the custom order
        follows pairs_mapping.h / select.py exactly. Barcoded runs
        prefilter on the whitelist and carry the barcode key."""
        from .mapping.records import PairsRecord

        if self.cfg.split_alignment and \
                not getattr(engine, "_split_mode_set", False):
            engine.set_split_mode()
            engine._split_mode_set = True

        barcodes = None
        with tracing.span("records.pack"):
            if isinstance(batch1, NativeReadBatch):
                blob1 = batch1.bases, batch1.offsets
                blob2 = batch2.bases, batch2.offsets
                base_read_id = batch1.first_id
                names = batch1.names
                name_at = batch1.name_offsets.tolist()

                def read_of(j):
                    return (base_read_id + j,
                            names[name_at[j]:name_at[j + 1]])
            else:
                if batch_bc is not None:
                    reads1, reads2, barcodes, sel = \
                        self._native_barcode_prefilter(batch1, batch2,
                                                       batch_bc)
                    base_read_id = 0
                else:
                    reads1 = [r.seq for r in batch1]
                    reads2 = [r.seq for r in batch2]
                    sel = range(len(batch1))
                    base_read_id = batch1[0].read_id if batch1 else 0
                blob1, blob2 = _blob(reads1), _blob(reads2)

                def read_of(j):
                    rec = batch1[sel[j]]
                    return int(rec.read_id), rec.name
        n = len(blob1[1]) - 1
        if not n:
            return
        out, stats, info = self._map_pairs_hybrid(engine, blob1, blob2,
                                                  base_read_id, threshold,
                                                  full=True,
                                                  want_info=True)
        with tracing.span("records.emit"):
            if batch_bc is not None:
                self._native_barcode_cachehits(engine, out, n,
                                               barcodes, flags=info.flags)
            rank = self.pairs_custom_rid_rank
            rid_a = out["rid"]
            o_read_id = out["read_id"].tolist()
            o_rid, o_rid2 = rid_a.tolist(), out["rid2"].tolist()
            o_dir, o_dir2 = out["dir"].tolist(), out["dir2"].tolist()
            o_rs1, o_re1 = out["rs1"].tolist(), out["re1"].tolist()
            o_rs2, o_re2 = out["rs2"].tolist(), out["re2"].tolist()
            o_mapq, o_uniq = out["mapq"].tolist(), out["uniq"].tolist()
            for i in range(len(rid_a)):
                j = o_read_id[i] - base_read_id
                read_id, read_name = read_of(j)
                rid = o_rid[i]
                first_negative = o_dir[i] == 0
                second_negative = o_dir2[i] == 0
                strand1 = 0 if first_negative else 1
                strand2 = 0 if second_negative else 1
                pos1 = o_re1[i] if first_negative else o_rs1[i]
                pos2 = o_re2[i] if second_negative else o_rs2[i]
                rid1, rid2 = rid, o_rid2[i]
                r1_rank = rank[rid1] if rank else rid1
                r2_rank = rank[rid2] if rank else rid2
                if not (r1_rank < r2_rank or (rid1 == rid2 and pos1 < pos2)):
                    pos1, pos2 = pos2, pos1
                    strand1, strand2 = strand2, strand1
                emit(rid1, PairsRecord(
                    read_id=read_id, read_name=read_name,
                    barcode=(int(barcodes[j]) if barcodes is not None else 0),
                    rid1=rid1, rid2=rid2, pos1=pos1, pos2=pos2,
                    strand1=strand1, strand2=strand2,
                    mapq=o_mapq[i],
                    is_unique=o_uniq[i], num_dups=1))
        self.num_candidates += int(stats[0])
        self.num_mappings += int(stats[1])
        self.num_mapped_reads += int(stats[2])
        self.num_uniquely_mapped_reads += int(stats[3])
        self.cache_hits += int(stats[4])

    def _map_batch_native_se(self, engine, batch, threshold, emit) -> None:
        """Map one single-end batch through the C++ host engine."""
        from .mapping.records import SEBedRecord
        from .summary import CACHEHIT, TOTAL

        with tracing.span("records.pack"):
            reads = _blob([bytes(r.seq) for r in batch])
            orig_ids = np.asarray([r.read_id for r in batch],
                                  dtype=np.uint32)
        out, stats = self._map_single_hybrid(engine, reads, 0, threshold)
        with tracing.span("records.emit"):
            rid_a = out["rid"]
            if self._array_spill_ok():
                self._stash_bed_rows(rid_a, out, orig_ids, None, se=True)
            else:
                for i in range(len(rid_a)):
                    rec = SEBedRecord(
                        read_id=int(orig_ids[int(out["read_id"][i])]),
                        barcode=0,
                        start=int(out["start"][i]),
                        length=int(out["flen"][i]),
                        mapq=int(out["mapq"][i]),
                        direction=int(out["dir"][i]),
                        is_unique=int(out["uniq"][i]), num_dups=1)
                    emit(int(rid_a[i]), rec)
        self.num_candidates += int(stats[0])
        self.num_mappings += int(stats[1])
        self.num_mapped_reads += int(stats[2])
        self.num_uniquely_mapped_reads += int(stats[3])
        self.cache_hits += int(stats[4])
        if self.summary is not None:
            self.summary.update_count(0, TOTAL, len(batch))
            self.summary.update_count(0, CACHEHIT, int(stats[4]))

    def _map_batch_native_se_barcoded(self, engine, batch, batch_bc,
                                      threshold, emit) -> None:
        """Barcoded single-end batch through the C++ mapper; per-barcode
        summary TOTAL counts update here (the single-end per-read path
        tracks no per-barcode cache hits, and neither does this one)."""
        import ctypes as _ct

        from .mapping.records import SEBedRecord

        cfg = self.cfg
        with tracing.span("records.pack"):
            reads, barcodes, orig_ids = [], [], []
            nonwhitelist_count = 0
            for bi, rec in enumerate(batch):
                whitelisted, barcode_key = self._process_barcode(
                    batch_bc[bi])
                if not (whitelisted or cfg.output_mappings_not_in_whitelist):
                    nonwhitelist_count += 1
                    continue
                reads.append(bytes(rec.seq))
                barcodes.append(barcode_key)
                orig_ids.append(rec.read_id)
            if self.summary is not None:
                from .summary import TOTAL
                for key in barcodes:
                    self.summary.update_count(key, TOTAL, 1)
                self.summary.update_nonwhitelist(TOTAL, nonwhitelist_count)
            if not reads:
                return
        out, stats = self._map_single_hybrid(engine, _blob(reads), 0,
                                             threshold)
        with tracing.span("records.emit"):
            rid_a = out["rid"]
            if self._array_spill_ok():
                self._stash_bed_rows(rid_a, out,
                                     np.asarray(orig_ids, dtype=np.uint32),
                                     np.asarray(barcodes, dtype=np.uint64),
                                     se=True)
            else:
                for i in range(len(rid_a)):
                    j = int(out["read_id"][i])
                    emit(int(rid_a[i]), SEBedRecord(
                        read_id=int(orig_ids[j]), barcode=int(barcodes[j]),
                        start=int(out["start"][i]),
                        length=int(out["flen"][i]),
                        mapq=int(out["mapq"][i]),
                        direction=int(out["dir"][i]),
                        is_unique=int(out["uniq"][i]), num_dups=1,
                        has_barcode=True))
        self.num_candidates += int(stats[0])
        self.num_mappings += int(stats[1])
        self.num_mapped_reads += int(stats[2])
        self.num_uniquely_mapped_reads += int(stats[3])
        self.cache_hits += int(stats[4])

    def _map_batch_native_se_records(self, engine, batch, threshold,
                                     emit, batch_bc=None) -> None:
        """Single-end PAF/SAM through the C++ mapper (select.py
        _make_se_record field-for-field); barcoded runs prefilter on the
        whitelist and carry the barcode key (SAM CB:Z tag)."""
        import ctypes as _ct

        from .mapping.cigar import sequence_length_from_cigar
        from .mapping.records import PafRecord, SamRecord, clip_mapq

        cfg = self.cfg
        sam = cfg.output_format == "sam"
        if sam and not getattr(engine, "_sam_params_set", False):
            engine.set_sam_params()
            engine._sam_params_set = True

        if batch_bc is not None:
            sel, barcodes = [], []
            nonwhitelist_count = 0
            for bi, rec in enumerate(batch):
                whitelisted, barcode_key = self._process_barcode(
                    batch_bc[bi])
                if not (whitelisted
                        or cfg.output_mappings_not_in_whitelist):
                    nonwhitelist_count += 1
                    continue
                sel.append(bi)
                barcodes.append(barcode_key)
            if self.summary is not None:
                from .summary import TOTAL
                for key in barcodes:
                    self.summary.update_count(key, TOTAL, 1)
                self.summary.update_nonwhitelist(TOTAL, nonwhitelist_count)
            batch = [batch[bi] for bi in sel]
            if not batch:
                return
        else:
            barcodes = None

        base_read_id = 0 if batch_bc is not None else (
            batch[0].read_id if batch else 0)
        with tracing.span("records.pack"):
            reads = [bytes(r.seq) for r in batch]
            n = len(reads)
            blob = _blob(reads)
        if sam:
            out, stats, aux = self._map_single_hybrid(
                engine, blob, base_read_id, threshold, sam=True)
        else:
            out, stats = self._map_single_hybrid(
                engine, blob, base_read_id, threshold)
            aux = None
        with tracing.span("records.emit"):
            if self.summary is not None and batch_bc is None \
                    and cfg.is_bulk_data:
                from .summary import CACHEHIT, TOTAL
                self.summary.update_count(0, TOTAL, n)
                self.summary.update_count(0, CACHEHIT, int(stats[4]))
            rid_a = out["rid"]
            prev_read_id = None
            occurrence = 0
            for i in range(len(rid_a)):
                j = int(out["read_id"][i]) - base_read_id
                rec = batch[j]
                read_id = int(rec.read_id)
                occurrence = occurrence + 1 if read_id == prev_read_id else 0
                prev_read_id = read_id
                neg = int(out["dir"][i]) == 0
                mapq = int(out["mapq"][i])
                barcode = int(barcodes[j]) if barcodes is not None else 0
                if not sam:
                    emit(int(rid_a[i]), PafRecord(
                        read_id=read_id, read_name=rec.name,
                        read_length=len(reads[j]), start=int(out["start"][i]),
                        length=int(out["flen"][i]), mapq=clip_mapq(mapq),
                        direction=int(out["dir"][i]),
                        is_unique=int(out["uniq"][i]), num_dups=1))
                    continue
                cig_buf, cig_off, md_buf, md_off, nm_arr = aux
                cigar = [int(c) for c in cig_buf[cig_off[i]:cig_off[i + 1]]]
                md = md_buf[md_off[i]:md_off[i + 1]]
                seq = rec.negative() if neg else bytes(reads[j])
                qual = bytes(rec.qual or b"")
                if neg and qual:
                    qual = qual[::-1]
                ncons = sequence_length_from_cigar(cigar)
                if ncons != len(seq):
                    seq, qual = seq[:ncons], qual[:ncons]
                flag = 0x10 if neg else 0
                if occurrence >= 1:
                    flag |= 0x100
                emit(int(rid_a[i]), SamRecord(
                    read_id=read_id, read_name=rec.name, barcode=barcode,
                    num_dups=1,
                    pos=int(out["start"][i]), rid=int(rid_a[i]), mpos=0,
                    mrid=-1, tlen=0, flag=flag,
                    direction=0 if neg else 1,
                    is_unique=int(out["uniq"][i]), mapq=mapq,
                    NM=int(nm_arr[i]), cigar=cigar, MD=md, sequence=seq,
                    qual=qual))
        self.num_candidates += int(stats[0])
        self.num_mappings += int(stats[1])
        self.num_mapped_reads += int(stats[2])
        self.num_uniquely_mapped_reads += int(stats[3])
        self.cache_hits += int(stats[4])

    def _shard_filter_pairs(self, batch1, batch2, batch_bc):
        """Multi-host sharding: keep reads assigned to this shard
        (interleaved by global read index)."""
        cfg = self.cfg
        if cfg.num_shards <= 1:
            return batch1, batch2, batch_bc
        keep = [i for i, r in enumerate(batch1)
                if r.read_id % cfg.num_shards == cfg.shard_index]
        b1 = [batch1[i] for i in keep]
        b2 = [batch2[i] for i in keep] if batch2 is not None else None
        bb = [batch_bc[i] for i in keep] if batch_bc is not None else None
        return b1, b2, bb

    def _postprocess_and_write(self, writer: MappingFileWriter) -> None:
        cfg = self.cfg
        if cfg.num_shards > 1:
            # sharded run: emit sorted spill shards only; a merge invocation
            # (--merge-shards) unifies shards from all hosts
            base = f"{cfg.mapping_output_file_path}.shard{cfg.shard_index}"
            self._spill_now(base)
            log(f"Shard {cfg.shard_index}/{cfg.num_shards} wrote "
                f"{len(self.temp_shard_paths)} spill files at {base}.temp*")
            self.temp_shard_paths.clear()
            return
        if cfg.low_memory_mode:
            from .io.lowmem import merge_and_output_low_memory
            if self.num_mappings_in_mem > 0 or not self.temp_shard_paths:
                self._spill_now(None)
                self.num_mappings_in_mem = 0
            with tracing.span("lowmem.merge"):
                num_uni, num_multi, num_passing = \
                    merge_and_output_low_memory(
                        cfg, self.temp_shard_paths, writer,
                        whitelist=self.whitelist, summary=self.summary,
                        engine=self._native_engine)
            tracing.count("lowmem.merge_rows_out", num_passing)
            log(f"# uni-mappings: {num_uni}, # multi-mappings: {num_multi}, "
                f"total: {num_uni + num_multi}.")
            log(f"Number of output mappings (passed filters): {num_passing}")
            return
        # output.sort holds the Tn5 shift and the dedup here: the dedup
        # sorts as it goes
        with tracing.span("output.sort"):
            if cfg.tn5_shift:
                n = apply_tn5_shift(self.mappings_on_refs)
                log(f"# shifted mappings: {n}.")
            if cfg.remove_pcr_duplicates:
                n = remove_pcr_duplicates(self.mappings_on_refs)
                log(f"{n} mappings left after deduplication.")
            else:
                sort_mappings(self.mappings_on_refs)
            if cfg.allocate_multi_mappings:
                allocate_multi_mappings(self.mappings_on_refs,
                                        cfg.multi_mapping_allocation_distance,
                                        cfg.multi_mapping_allocation_seed)
                sort_mappings(self.mappings_on_refs)
        with tracing.span("output.write"):
            writer.output_mappings(self.mappings_on_refs)
        log(f"Number of output mappings (passed filters): "
            f"{writer.num_mappings_passing_filters}")
        if cfg.matrix_output_prefix:
            from .matrix import FeatureBarcodeMatrix
            fbm = FeatureBarcodeMatrix(
                cfg.cell_by_bin, cfg.bin_size,
                cfg.multi_mapping_allocation_distance,
                cfg.depth_cutoff_to_call_peak, self.barcode_length,
                self.translator)
            fbm.output_feature_matrix(self.ref_names, self.ref_lengths,
                                      self.mappings_on_refs,
                                      cfg.matrix_output_prefix)
            log("Wrote feature-barcode matrix.")

    def _output_summary(self) -> None:
        cfg = self.cfg
        if self.summary is None:
            return
        from .summary import CARDINALITY, parse_frip_est_params
        if cfg.output_format == "sam" and not cfg.is_bulk_data:
            pass
        if cfg.output_format == "sam":
            self.summary.adjust_paired_end_overcount()
        output_cache_slots = (cfg.output_num_uniq_cache_slots
                              and bool(cfg.summary_metadata_file_path))
        if output_cache_slots:
            for barcode, sketch in self.kminhash_per_barcode.items():
                self.summary.update_count(barcode, CARDINALITY,
                                          sketch.compute_cardinality())
        self.summary.output(
            cfg.summary_metadata_file_path,
            has_whitelist=(bool(cfg.barcode_whitelist_file_path)
                           and not cfg.output_mappings_not_in_whitelist),
            coeffs=parse_frip_est_params(cfg.frip_est_params),
            with_cache_slots=output_cache_slots,
            translator=self.translator)
