"""Configuration dataclasses (analog of index_parameters.h /
mapping_parameters.h) and preset application."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class IndexConfig:
    kmer_size: int = 17
    window_size: int = 7
    reference_file_path: str = ""
    index_output_file_path: str = ""
    num_threads: int = 1


@dataclass
class MappingConfig:
    error_threshold: int = 8
    match_score: int = 1
    mismatch_penalty: int = 4
    gap_open_penalties: List[int] = field(default_factory=lambda: [6, 6])
    gap_extension_penalties: List[int] = field(default_factory=lambda: [1, 1])
    min_num_seeds_required_for_mapping: int = 2
    max_seed_frequencies: List[int] = field(default_factory=lambda: [500, 1000])

    cache_size: int = 4000003
    # --no-cache (extension): disable the candidate cache. Forced on by
    # --device: mmcache hits are only approximately equal to fresh
    # candidate generation (mmcache.hpp:119-185 shifts cached candidates),
    # so a cache-free run is the configuration whose output is invariant
    # to which engine (CPU or device) maps each chunk.
    cache_off: bool = False
    cache_update_param: float = 0.01
    debug_cache: bool = False
    frip_est_params: str = "-1.0996;4.2391;3.0164e-05;-2.1087e-04;-5.5825e-05"
    output_num_uniq_cache_slots: bool = True
    k_for_minhash: int = 250

    max_num_best_mappings: int = 1
    max_insert_size: int = 1000
    mapq_threshold: int = 30
    num_threads: int = 1
    min_read_length: int = 30
    barcode_correction_error_threshold: int = 1
    barcode_correction_probability_threshold: float = 0.9
    multi_mapping_allocation_distance: int = 0
    multi_mapping_allocation_seed: int = 11
    drop_repetitive_reads: int = 500000

    trim_adapters: bool = False
    remove_pcr_duplicates: bool = False
    remove_pcr_duplicates_at_bulk_level: bool = True
    is_bulk_data: bool = True
    allocate_multi_mappings: bool = False
    only_output_unique_mappings: bool = True
    output_mappings_not_in_whitelist: bool = False
    tn5_shift: bool = False
    split_alignment: bool = False
    output_format: str = "bed"  # bed | tagalign | paf | sam | pairs
    low_memory_mode: bool = False
    cell_by_bin: bool = False
    bin_size: int = 5000
    depth_cutoff_to_call_peak: int = 3
    # accepted but unused, exactly like the reference (mapping_parameters.h:
    # 61-62 are parsed by the driver and never read)
    peak_min_length: int = 30
    peak_merge_max_length: int = 30
    matrix_output_prefix: str = ""

    reference_file_path: str = ""
    index_file_path: str = ""
    read_file1_paths: List[str] = field(default_factory=list)
    read_file2_paths: List[str] = field(default_factory=list)
    barcode_file_paths: List[str] = field(default_factory=list)
    barcode_whitelist_file_path: str = ""
    read_format: str = ""
    mapping_output_file_path: str = ""
    custom_rid_order_file_path: str = ""
    pairs_flipping_custom_rid_order_file_path: str = ""
    barcode_translate_table_file_path: str = ""
    summary_metadata_file_path: str = ""
    skip_barcode_check: bool = False

    # device execution knobs (no analog in the reference)
    use_device: bool = False          # seed + verify chunks on the device
    # torch device of the seeding step: "cuda" launches the CUDA kernels,
    # "cpu" runs their plain torch versions (tests); never chosen
    # implicitly -- "cuda" without a card raises
    torch_device: str = "cuda"
    device_batch_size: int = 16384    # read pairs per device dispatch
    read_batch_size: int = 500000
    low_mem_max_records: int = 0  # 0 = derive from the reference's budgets
    # device mesh of the seeder, as in the JAX package: 0 = every visible
    # device of torch_device's type (CUDA: every card; CPU: one), 1 = one
    # device, N > 1 = the read batch sharded over N (parallel/sharding.py)
    mesh_devices: int = 0
    # multi-host sharded operation: each shard maps reads with
    # read_index %% num_shards == shard_index and emits sorted spill shards;
    # a final merge invocation unifies them (parallel/shards.py)
    num_shards: int = 1
    shard_index: int = 0
    # engine: "auto" prefers native (C++ host runtime) then batch for bulk
    # non-split formats; "per_read" forces the exact sequential path
    engine: str = "auto"

    def native_engine_eligible(self, paired: bool) -> bool:
        if self.engine in ("per_read", "batch"):
            return False

        if self.split_alignment and self.output_format != "pairs":
            # split (drop-off) alignment is native for the Hi-C pairs flow
            return False
        if self.output_format not in ("bed", "tagalign", "paf", "sam",
                                       "pairs"):
            return False
        if self.error_threshold >= 32:
            # the native scalar kernels extend to a 64-bit band word
            # (2e+1 <= 63 bits; the reference's SIMD-only design stops at
            # e < 16, alignment.cc:144-150); e >= 32 takes the exact
            # per-read path
            return False
        return True

    def batch_engine_eligible(self, paired: bool) -> bool:
        if self.engine == "per_read":
            return False
        if self.split_alignment or self.output_format == "sam":
            return False
        if not self.is_bulk_data:
            return False
        if self.error_threshold >= 16:
            return False
        if self.custom_rid_order_file_path:
            return False
        return True

    def num_vpu_lanes(self) -> int:
        if self.error_threshold < 8:
            return 8
        if self.error_threshold < 16:
            return 4
        return 0


def apply_preset(cfg: MappingConfig, preset: str) -> None:
    """Presets per chromap_driver.cc:247-275."""
    if preset == "atac":
        cfg.max_insert_size = 2000
        cfg.trim_adapters = True
        cfg.remove_pcr_duplicates = True
        cfg.remove_pcr_duplicates_at_bulk_level = False
        cfg.tn5_shift = True
        cfg.output_format = "bed"
        cfg.low_memory_mode = True
    elif preset == "chip":
        cfg.max_insert_size = 2000
        cfg.remove_pcr_duplicates = True
        cfg.low_memory_mode = True
        cfg.output_format = "bed"
    elif preset == "hic":
        cfg.error_threshold = 4
        cfg.mapq_threshold = 1
        cfg.split_alignment = True
        cfg.low_memory_mode = True
        cfg.output_format = "pairs"
    else:
        raise ValueError(f"Unrecognized preset parameters {preset}")
