"""Command-line driver (analog of chromap_driver.cc).

Supports the reference's option surface: index construction (-i) and
mapping with presets, output format flags, paired/single-end inputs,
barcodes, and the development options.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .config import IndexConfig, MappingConfig, apply_preset
from .io.fastx import expand_input_globs

# capability-parity target: reference chromap 0.3.3-r521 (chromap.h:37)
VERSION = "0.3.3-r521-torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="chromap-tpu-torch",
        description="Fast alignment and preprocessing of chromatin "
                    "profiles, with device seeding in PyTorch and CUDA")
    p.add_argument("-v", "--version", action="store_true",
                   help="print version")
    # Indexing
    p.add_argument("-i", "--build-index", action="store_true")
    p.add_argument("--min-frag-length", type=int, default=None)
    p.add_argument("-k", "--kmer", type=int, default=None)
    p.add_argument("-w", "--window", type=int, default=None)
    # Mapping
    p.add_argument("--preset", type=str, default=None)
    p.add_argument("--split-alignment", action="store_true")
    p.add_argument("-e", "--error-threshold", type=int, default=None)
    p.add_argument("-s", "--min-num-seeds", type=int, default=None)
    p.add_argument("-f", "--max-seed-frequencies", type=str, default=None)
    p.add_argument("-l", "--max-insert-size", type=int, default=None)
    p.add_argument("-q", "--MAPQ-threshold", type=int, default=None)
    p.add_argument("--min-read-length", type=int, default=None)
    p.add_argument("--trim-adapters", action="store_true")
    p.add_argument("--remove-pcr-duplicates", action="store_true")
    p.add_argument("--remove-pcr-duplicates-at-bulk-level", action="store_true")
    p.add_argument("--remove-pcr-duplicates-at-cell-level", action="store_true")
    p.add_argument("--Tn5-shift", action="store_true")
    p.add_argument("--low-mem", action="store_true")
    p.add_argument("--bc-error-threshold", type=int, default=None)
    p.add_argument("--bc-probability-threshold", type=float, default=None)
    p.add_argument("-t", "--num-threads", type=int, default=1)
    p.add_argument("--frip-est-params", type=str, default=None)
    p.add_argument("--turn-off-num-uniq-cache-slots", action="store_true")
    # Input
    p.add_argument("-r", "--ref", type=str, default=None)
    p.add_argument("-x", "--index", type=str, default=None)
    p.add_argument("-1", "--read1", type=str, default=None)
    p.add_argument("-2", "--read2", type=str, default=None)
    p.add_argument("-b", "--barcode", type=str, default=None)
    p.add_argument("--barcode-whitelist", type=str, default=None)
    p.add_argument("--read-format", type=str, default=None)
    # Output
    p.add_argument("-o", "--output", type=str, default=None)
    p.add_argument("--output-mappings-not-in-whitelist", action="store_true")
    p.add_argument("--chr-order", type=str, default=None)
    p.add_argument("--BED", action="store_true")
    p.add_argument("--TagAlign", action="store_true")
    p.add_argument("--SAM", action="store_true")
    p.add_argument("--PAF", action="store_true")
    p.add_argument("--pairs", action="store_true")
    p.add_argument("--pairs-natural-chr-order", type=str, default=None)
    p.add_argument("--barcode-translate", type=str, default=None)
    p.add_argument("--summary", type=str, default=None)
    p.add_argument("--skip-barcode-check", action="store_true")
    # Development options
    p.add_argument("-A", "--match-score", type=int, default=None)
    p.add_argument("-B", "--mismatch-penalty", type=int, default=None)
    p.add_argument("-O", "--gap-open-penalties", type=str, default=None)
    p.add_argument("-E", "--gap-extension-penalties", type=str, default=None)
    p.add_argument("-n", "--max-num-best-mappings", type=int, default=None)
    p.add_argument("--multi-mapping-allocation-distance", type=int, default=None)
    p.add_argument("--multi-mapping-allocation-seed", type=int, default=None)
    p.add_argument("--drop-repetitive-reads", type=int, default=None)
    p.add_argument("--allocate-multi-mappings", action="store_true")
    p.add_argument("--cache-size", type=int, default=None)
    p.add_argument("--cache-update-param", type=float, default=None)
    p.add_argument("--debug-cache", action="store_true")
    # extension: disable the candidate cache (forced on by --device; a
    # host --no-cache run byte-matches a --device run on any data)
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--k-for-minhash", type=int, default=None)
    # Peak / feature-matrix options (dormant in the reference; functional here)
    p.add_argument("--matrix-output-prefix", type=str, default=None)
    p.add_argument("--cell-by-bin", action="store_true")
    p.add_argument("--bin-size", type=int, default=None)
    p.add_argument("--depth-cutoff", type=int, default=None)
    # parsed-but-unused in the reference too (mapping_parameters.h:61-62 are
    # never read by feature_barcode_matrix.cc); kept for CLI parity
    p.add_argument("--peak-min-length", type=int, default=None)
    p.add_argument("--peak-merge-max-length", type=int, default=None)
    # device execution
    p.add_argument("--device", action="store_true",
                   help="seed and verify read chunks on the device "
                        "(CUDA kernels)")
    p.add_argument("--torch-device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="torch device of --device seeding: cuda (kernels) "
                        "or cpu (their plain torch versions)")
    p.add_argument("--device-batch-size", type=int, default=None,
                   help="read pairs per device dispatch (default 8192)")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="devices the --device seeding shards each chunk "
                        "over: 0 = every visible device of --torch-device "
                        "(cuda: every card; cpu: one), 1 = one, N > 1 = "
                        "the first N (cpu: N shards on the CPU)")
    p.add_argument("--engine", type=str, default="auto",
                   choices=["auto", "native", "batch", "per_read"],
                   help="mapping engine selection")
    p.add_argument("--read-batch-size", type=int, default=None,
                   help="reads per processing batch (default 500000)")
    p.add_argument("--num-shards", type=int, default=1,
                   help="multi-host sharding: total shard count")
    p.add_argument("--shard-index", type=int, default=0,
                   help="multi-host sharding: this host's shard index")
    p.add_argument("--merge-shards", type=str, default=None,
                   help="comma-separated spill shard files to merge into -o")
    return p


def _split_csv(value: str) -> List[str]:
    return [v for v in value.split(",") if v]


def _echo_mapping_parameters(cfg: MappingConfig, args) -> None:
    """Echo the effective parameter set to stderr (reproducibility aid;
    mirrors chromap_driver.cc:572-700)."""
    err = sys.stderr
    print(f"Parameters: error threshold: {cfg.error_threshold}, "
          f"min-num-seeds: {cfg.min_num_seeds_required_for_mapping}, "
          f"max-seed-frequency: {cfg.max_seed_frequencies[0]},"
          f"{cfg.max_seed_frequencies[1]}, "
          f"max-num-best-mappings: {cfg.max_num_best_mappings}, "
          f"max-insert-size: {cfg.max_insert_size}, "
          f"MAPQ-threshold: {cfg.mapq_threshold}, "
          f"min-read-length: {cfg.min_read_length}, "
          f"bc-error-threshold: {cfg.barcode_correction_error_threshold}, "
          f"bc-probability-threshold: "
          f"{cfg.barcode_correction_probability_threshold:.2f}", file=err)
    print(f"Number of threads: {cfg.num_threads}", file=err)
    print("Analyze bulk data." if cfg.is_bulk_data
          else "Analyze single-cell data.", file=err)
    print("Will try to remove adapters on 3'." if cfg.trim_adapters
          else "Won't try to remove adapters on 3'.", file=err)
    print("Will remove PCR duplicates after mapping."
          if cfg.remove_pcr_duplicates
          else "Won't remove PCR duplicates after mapping.", file=err)
    print("Will remove PCR duplicates at bulk level."
          if cfg.remove_pcr_duplicates_at_bulk_level
          else "Will remove PCR duplicates at cell level.", file=err)
    print("Will allocate multi-mappings after mapping."
          if cfg.allocate_multi_mappings
          else "Won't allocate multi-mappings after mapping.", file=err)
    if cfg.only_output_unique_mappings:
        print("Only output unique mappings after mapping.", file=err)
    if not cfg.output_mappings_not_in_whitelist:
        print("Only output mappings of which barcodes are in whitelist.",
              file=err)
    else:
        print("No filtering of mappings based on whether their barcodes "
              "are in whitelist.", file=err)
    if cfg.max_num_best_mappings > cfg.drop_repetitive_reads:
        print(f"WARNING: you want to drop mapped reads with more than "
              f"{cfg.drop_repetitive_reads} mappings. But you want to output "
              f"top {cfg.max_num_best_mappings} best mappings. In this case, "
              f"only reads with <={cfg.drop_repetitive_reads} best mappings "
              f"will be output.", file=err)
        cfg.max_num_best_mappings = cfg.drop_repetitive_reads
    if cfg.tn5_shift:
        print("Perform Tn5 shift.", file=err)
    if cfg.split_alignment:
        print("Allow split alignment.", file=err)
    fmt_names = {"bed": "BED/BEDPE", "tagalign": "TagAlign/PairedTagAlign",
                 "paf": "PAF", "sam": "SAM", "pairs": "pairs"}
    print(f"Output mappings in {fmt_names[cfg.output_format]} format.",
          file=err)
    print(f"Reference file: {cfg.reference_file_path}", file=err)
    print(f"Index file: {cfg.index_file_path}", file=err)
    for i, path in enumerate(cfg.read_file1_paths):
        print(f"{i + 1}th read 1 file: {path}", file=err)
    for i, path in enumerate(cfg.read_file2_paths):
        print(f"{i + 1}th read 2 file: {path}", file=err)
    for i, path in enumerate(cfg.barcode_file_paths):
        print(f"{i + 1}th cell barcode file: {path}", file=err)
    if cfg.barcode_whitelist_file_path:
        print(f"Cell barcode whitelist file: "
              f"{cfg.barcode_whitelist_file_path}", file=err)
    print(f"Output file: {cfg.mapping_output_file_path}", file=err)
    if cfg.matrix_output_prefix:
        print(f"Matrix output prefix: {cfg.matrix_output_prefix}", file=err)


def parse_args_and_run(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.version:
        print(VERSION, file=sys.stderr)
        return 0

    if args.build_index:
        icfg = IndexConfig()
        if args.num_threads:
            icfg.num_threads = args.num_threads
        if args.min_frag_length is not None:
            if args.min_frag_length <= 60:
                icfg.kmer_size, icfg.window_size = 17, 7
            elif args.min_frag_length <= 80:
                icfg.kmer_size, icfg.window_size = 19, 10
            else:
                icfg.kmer_size, icfg.window_size = 23, 11
        if args.kmer is not None:
            icfg.kmer_size = args.kmer
        if args.window is not None:
            icfg.window_size = args.window
        if not args.ref or not args.output:
            parser.error("index construction requires -r and -o")
        icfg.reference_file_path = args.ref
        icfg.index_output_file_path = args.output
        print("Build index for the reference.", file=sys.stderr)
        print(f"Kmer length: {icfg.kmer_size}, window size: "
              f"{icfg.window_size}", file=sys.stderr)
        print(f"Reference file: {icfg.reference_file_path}", file=sys.stderr)
        print(f"Output file: {icfg.index_output_file_path}", file=sys.stderr)
        from .pipeline import construct_index
        construct_index(icfg)
        return 0

    cfg = MappingConfig()
    if args.merge_shards:
        return _run_merge_shards(args)
    if args.preset:
        apply_preset(cfg, args.preset)
    if args.error_threshold is not None:
        cfg.error_threshold = args.error_threshold
    if args.min_num_seeds is not None:
        cfg.min_num_seeds_required_for_mapping = args.min_num_seeds
    if args.max_seed_frequencies is not None:
        cfg.max_seed_frequencies = [int(v) for v in
                                    _split_csv(args.max_seed_frequencies)]
    if args.max_insert_size is not None:
        cfg.max_insert_size = args.max_insert_size
    if args.MAPQ_threshold is not None:
        cfg.mapq_threshold = args.MAPQ_threshold
    if args.min_read_length is not None:
        cfg.min_read_length = args.min_read_length
    if args.trim_adapters:
        cfg.trim_adapters = True
    if args.remove_pcr_duplicates:
        cfg.remove_pcr_duplicates = True
    if args.remove_pcr_duplicates_at_bulk_level:
        cfg.remove_pcr_duplicates_at_bulk_level = True
    if args.remove_pcr_duplicates_at_cell_level:
        cfg.remove_pcr_duplicates_at_bulk_level = False
    if args.Tn5_shift:
        cfg.tn5_shift = True
    if args.low_mem:
        cfg.low_memory_mode = True
    if args.split_alignment:
        cfg.split_alignment = True
    if args.bc_error_threshold is not None:
        cfg.barcode_correction_error_threshold = args.bc_error_threshold
    if args.bc_probability_threshold is not None:
        cfg.barcode_correction_probability_threshold = \
            args.bc_probability_threshold
    cfg.num_threads = args.num_threads
    if args.frip_est_params is not None:
        cfg.frip_est_params = args.frip_est_params
    if args.turn_off_num_uniq_cache_slots:
        cfg.output_num_uniq_cache_slots = False
    if args.match_score is not None:
        cfg.match_score = args.match_score
    if args.mismatch_penalty is not None:
        cfg.mismatch_penalty = args.mismatch_penalty
    if args.gap_open_penalties is not None:
        cfg.gap_open_penalties = [int(v) for v in
                                  _split_csv(args.gap_open_penalties)]
    if args.gap_extension_penalties is not None:
        cfg.gap_extension_penalties = [int(v) for v in
                                       _split_csv(args.gap_extension_penalties)]
    if args.max_num_best_mappings is not None:
        cfg.max_num_best_mappings = args.max_num_best_mappings
    if args.multi_mapping_allocation_distance is not None:
        cfg.multi_mapping_allocation_distance = \
            args.multi_mapping_allocation_distance
    if args.multi_mapping_allocation_seed is not None:
        cfg.multi_mapping_allocation_seed = args.multi_mapping_allocation_seed
    if args.drop_repetitive_reads is not None:
        cfg.drop_repetitive_reads = args.drop_repetitive_reads
    if args.allocate_multi_mappings:
        cfg.allocate_multi_mappings = True
        cfg.only_output_unique_mappings = False
    if args.cache_size is not None:
        cfg.cache_size = args.cache_size
    if args.cache_update_param is not None:
        cfg.cache_update_param = args.cache_update_param
    if args.debug_cache:
        cfg.debug_cache = True
    if args.no_cache:
        cfg.cache_off = True
    if args.k_for_minhash is not None:
        cfg.k_for_minhash = args.k_for_minhash
    if args.matrix_output_prefix:
        cfg.matrix_output_prefix = args.matrix_output_prefix
    if args.cell_by_bin:
        cfg.cell_by_bin = True
    if args.bin_size is not None:
        cfg.bin_size = args.bin_size
    if args.depth_cutoff is not None:
        cfg.depth_cutoff_to_call_peak = args.depth_cutoff
    if args.peak_min_length is not None:
        cfg.peak_min_length = args.peak_min_length
    if args.peak_merge_max_length is not None:
        cfg.peak_merge_max_length = args.peak_merge_max_length

    if args.BED:
        cfg.output_format = "bed"
    elif args.TagAlign:
        cfg.output_format = "tagalign"
    elif args.SAM:
        cfg.output_format = "sam"
    elif args.PAF:
        cfg.output_format = "paf"
    elif args.pairs:
        cfg.output_format = "pairs"

    if not args.ref or not args.index or not args.read1 or not args.output:
        parser.error("mapping requires -r, -x, -1 and -o")
    cfg.reference_file_path = args.ref
    cfg.index_file_path = args.index
    cfg.read_file1_paths = expand_input_globs(_split_csv(args.read1))
    if args.read2:
        cfg.read_file2_paths = expand_input_globs(_split_csv(args.read2))
    if args.barcode:
        cfg.barcode_file_paths = expand_input_globs(_split_csv(args.barcode))
        cfg.is_bulk_data = False
    if args.barcode_whitelist:
        cfg.barcode_whitelist_file_path = args.barcode_whitelist
    if args.read_format:
        cfg.read_format = args.read_format
    cfg.mapping_output_file_path = args.output
    if args.chr_order:
        cfg.custom_rid_order_file_path = args.chr_order
    if args.pairs_natural_chr_order:
        cfg.pairs_flipping_custom_rid_order_file_path = \
            args.pairs_natural_chr_order
    if args.barcode_translate:
        cfg.barcode_translate_table_file_path = args.barcode_translate
    if args.summary:
        cfg.summary_metadata_file_path = args.summary
    if args.skip_barcode_check:
        cfg.skip_barcode_check = True
    if args.output_mappings_not_in_whitelist:
        cfg.output_mappings_not_in_whitelist = True
    cfg.use_device = args.device
    if args.device_batch_size is not None:
        if args.device_batch_size <= 0:
            parser.error("--device-batch-size must be positive")
        cfg.device_batch_size = args.device_batch_size
    cfg.torch_device = args.torch_device
    if args.mesh_devices < 0:
        parser.error("--mesh-devices must be >= 0")
    cfg.mesh_devices = args.mesh_devices
    cfg.engine = args.engine
    import os as _os
    if _os.environ.get("CHROMAP_TPU_LOWMEM_MAX_RECORDS"):
        # test hook: force tiny spill shards to exercise the low-memory
        # temp-file path on small datasets
        cfg.low_mem_max_records = int(
            _os.environ["CHROMAP_TPU_LOWMEM_MAX_RECORDS"])
    if args.read_batch_size is not None:
        cfg.read_batch_size = args.read_batch_size
    cfg.num_shards = args.num_shards
    cfg.shard_index = args.shard_index

    print("Start to map reads.", file=sys.stderr)
    _echo_mapping_parameters(cfg, args)

    from .pipeline import MappingPipeline
    pipeline = MappingPipeline(cfg)
    if cfg.read_file2_paths:
        pipeline.map_paired_end()
    else:
        pipeline.map_single_end()
    return 0


def _run_merge_shards(args) -> int:
    """Merge sorted spill shards (possibly from several hosts) into the
    final output."""
    import glob as _g

    from .config import MappingConfig, apply_preset
    from .io.fastx import load_all_sequences
    from .io.writers import MappingFileWriter
    from .parallel.shards import merge_shards

    cfg = MappingConfig()
    if args.preset:
        apply_preset(cfg, args.preset)
    if args.MAPQ_threshold is not None:
        cfg.mapq_threshold = args.MAPQ_threshold
    if args.remove_pcr_duplicates:
        cfg.remove_pcr_duplicates = True
    if args.Tn5_shift:
        cfg.tn5_shift = True
    if args.BED:
        cfg.output_format = "bed"
    elif args.TagAlign:
        cfg.output_format = "tagalign"
    elif args.SAM:
        cfg.output_format = "sam"
    elif args.PAF:
        cfg.output_format = "paf"
    elif args.pairs:
        cfg.output_format = "pairs"
    cfg.mapping_output_file_path = args.output

    shard_paths = []
    for token in args.merge_shards.split(","):
        matches = sorted(_g.glob(token)) if any(c in token for c in "*?[")             else [token]
        shard_paths.extend(matches)
    reference = load_all_sequences(args.ref)
    ref_names = [r.name for r in reference]
    ref_lengths = [r.length for r in reference]
    pairs_rank = (list(range(len(reference)))
                  if cfg.output_format == "pairs" else None)
    writer = MappingFileWriter(cfg, ref_names, ref_lengths,
                               pairs_custom_rid_rank=pairs_rank)
    writer.output_header()
    num_uni, num_multi, num_passing = merge_shards(cfg, shard_paths, writer)
    writer.close()
    print(f"# uni-mappings: {num_uni}, # multi-mappings: {num_multi}, "
          f"total: {num_uni + num_multi}.", file=sys.stderr)
    print(f"Number of output mappings (passed filters): {num_passing}",
          file=sys.stderr)
    return 0


def main() -> None:
    sys.exit(parse_args_and_run())


if __name__ == "__main__":
    main()
