"""Native host engine bindings (ctypes over the C ABI in engine.cpp).

The shared library is built on demand with g++ -O3 and cached next to the
source; set CHROMAP_TPU_NO_NATIVE=1 to disable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent import futures
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from .. import tracing

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "engine.cpp")
_SO = os.path.join(_HERE, "_engine.so")

_lib = None


def _cpu_supports(flag: str) -> bool:
    try:
        with open("/proc/cpuinfo") as f:
            return flag in f.read()
    except OSError:
        return False


def _build_cmd() -> List[str]:
    cmd = ["g++", "-O3", "-std=c++17", "-fopenmp-simd", "-shared", "-fPIC"]
    # vectorizes the Hash64 lanes in GenerateMinimizers (4x uint64 with
    # AVX2, 8x with AVX-512) and widens the u32 Myers lane groups
    if (_cpu_supports("avx512f") and _cpu_supports("avx512bw")
            and _cpu_supports("avx512dq") and _cpu_supports("avx512vl")):
        cmd += ["-mavx512f", "-mavx512bw", "-mavx512dq", "-mavx512vl",
                "-mprefer-vector-width=512"]
    elif _cpu_supports("avx2"):
        cmd.append("-mavx2")
    if os.environ.get("CHROMAP_TPU_NATIVE_ASAN") == "1":
        # sanitizer build (the reference's `make asan=1`); run python with
        # LD_PRELOAD=$(g++ -print-file-name=libasan.so) to load it
        cmd += ["-fsanitize=address", "-g"]
    cmd += ["-o", _SO, _SRC, "-lz"]
    return cmd


def _build(cmd: List[str]) -> None:
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    # cache key: rebuild whenever the flags change, not just the source
    with open(_SO + ".flags", "w") as f:
        f.write(" ".join(cmd))


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("CHROMAP_TPU_NO_NATIVE") == "1":
        return None
    try:
        cmd = _build_cmd()
        stale = (not os.path.exists(_SO)
                 or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
        if not stale:
            try:
                with open(_SO + ".flags") as f:
                    stale = f.read() != " ".join(cmd)
            except OSError:
                stale = True
        if stale:
            _build(cmd)
        lib = ctypes.CDLL(_SO)
    except Exception as exc:  # pragma: no cover - environment dependent
        print(f"chromap-tpu: native engine unavailable ({exc}); "
              "using Python engines", file=sys.stderr)
        return None

    lib.cn_create.restype = ctypes.c_void_p
    lib.cn_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
    ]
    lib.cn_destroy.argtypes = [ctypes.c_void_p]
    lib.cn_set_num_threads.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cn_map_pairs.restype = ctypes.c_int64
    lib.cn_map_pairs.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.cn_phase1_run.restype = ctypes.c_void_p
    lib.cn_phase1_run.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.cn_phase1_finish.restype = ctypes.c_int64
    lib.cn_phase1_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ] + [ctypes.c_void_p] * 10
    lib.cn_pack_reads.restype = ctypes.c_int64
    lib.cn_pack_reads.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
    lib.cn_pack_reads_se.restype = ctypes.c_int64
    lib.cn_pack_reads_se.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p]
    lib.cn_map_single_dev.restype = ctypes.c_int64
    lib.cn_map_single_dev.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ] + [ctypes.c_void_p] * 8
    lib.cn_fastx_open.restype = ctypes.c_void_p
    lib.cn_fastx_open.argtypes = [ctypes.c_char_p]
    lib.cn_fastx_close.argtypes = [ctypes.c_void_p]
    lib.cn_fastx_read_batch.restype = ctypes.c_int64
    lib.cn_fastx_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    lib.cn_fastx_read_batch_named.restype = ctypes.c_int64
    lib.cn_fastx_read_batch_named.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.cn_collect_pairs.restype = ctypes.c_int64
    lib.cn_collect_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.cn_map_pairs_ext.restype = ctypes.c_int64
    lib.cn_map_pairs_ext.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.cn_map_pairs_dev.restype = ctypes.c_int64
    lib.cn_map_pairs_dev.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.cn_map_pairs_dev_full.restype = ctypes.c_int64
    lib.cn_map_pairs_dev_full.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ] + [ctypes.c_void_p] * 21
    lib.cn_map_pairs_full.restype = ctypes.c_int64
    lib.cn_map_pairs_full.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ] + [ctypes.c_void_p] * 19 + [ctypes.c_void_p]
    lib.cn_set_sam_params.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6
    lib.cn_set_split_mode.argtypes = [ctypes.c_void_p]
    lib.cn_set_debug_cache.argtypes = [ctypes.c_void_p]
    lib.cn_set_cache_off.argtypes = [ctypes.c_void_p]
    lib.cn_cache_print_stats.argtypes = [ctypes.c_void_p]
    lib.cn_get_pair_flags.restype = ctypes.c_int64
    lib.cn_get_pair_flags.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.cn_get_pair_trimmed_lengths.restype = ctypes.c_int64
    lib.cn_get_pair_trimmed_lengths.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16))]
    lib.cn_set_rid_rank.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int32]
    lib.cn_get_sam_aux.restype = ctypes.c_int64
    lib.cn_get_sam_aux.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.cn_map_single.restype = ctypes.c_int64
    lib.cn_map_single.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.cn_index_begin.restype = ctypes.c_void_p
    lib.cn_index_begin.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.cn_index_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_uint32]
    lib.cn_index_finalize.restype = ctypes.c_int64
    lib.cn_index_finalize.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.cn_index_export.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.cn_index_destroy.argtypes = [ctypes.c_void_p]
    lib.cn_postprocess_write.restype = ctypes.c_int64
    lib.cn_postprocess_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.cn_lowmem_merge_bed.restype = ctypes.c_int64
    lib.cn_lowmem_merge_bed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.cn_lowmem_merge_pairs.restype = ctypes.c_int64
    lib.cn_lowmem_merge_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.cn_get_lowmem_summary.restype = ctypes.c_int64
    lib.cn_get_lowmem_summary.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeEngine:
    """Paired-end bulk mapping through the C++ engine."""

    def __init__(self, cfg, index, reference_seqs: List[bytes]):
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native engine unavailable")
        self.cfg = cfg
        # keep buffers alive
        self._hash_keys = np.ascontiguousarray(index.hash_keys)
        self._offsets = np.ascontiguousarray(index.offsets.astype(np.uint64))
        self._counts = np.ascontiguousarray(index.counts.astype(np.uint32))
        self._occ = np.ascontiguousarray(index.occurrences)
        # trailing sentinel for the traceback window's legitimate over-read
        self._ref_bytes = b"".join(reference_seqs) + b"N" * 64
        self._ref_offsets = np.zeros(len(reference_seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in reference_seqs],
                  out=self._ref_offsets[1:])
        self.ctx = self.lib.cn_create(
            _ptr(self._hash_keys), _ptr(self._offsets), _ptr(self._counts),
            len(self._hash_keys), _ptr(self._occ), self._ref_bytes,
            _ptr(self._ref_offsets), len(reference_seqs), index.kmer_size,
            index.window_size, cfg.error_threshold,
            cfg.min_num_seeds_required_for_mapping,
            cfg.max_seed_frequencies[0], cfg.max_seed_frequencies[1],
            cfg.max_num_best_mappings, cfg.max_insert_size,
            cfg.min_read_length, cfg.drop_repetitive_reads, cfg.cache_size,
            1 if cfg.trim_adapters else 0)
        nt = getattr(cfg, "num_threads", 1) or 1
        if nt > 1:
            self.lib.cn_set_num_threads(self.ctx, int(nt))

    def __del__(self):
        if getattr(self, "ctx", None) and self.lib is not None:
            self.lib.cn_destroy(self.ctx)
            self.ctx = None

    def map_pairs_raw(self, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr,
                      n: int, base_read_id: int,
                      cache_update_threshold: int) -> Tuple[dict, np.ndarray]:
        cap = max(1, n * max(1, self.cfg.max_num_best_mappings))
        out = {
            "rid": np.empty(cap, dtype=np.int32),
            "read_id": np.empty(cap, dtype=np.uint32),
            "start": np.empty(cap, dtype=np.uint32),
            "flen": np.empty(cap, dtype=np.uint16),
            "mapq": np.empty(cap, dtype=np.uint8),
            "dir": np.empty(cap, dtype=np.uint8),
            "uniq": np.empty(cap, dtype=np.uint8),
            "posalen": np.empty(cap, dtype=np.uint16),
            "negalen": np.empty(cap, dtype=np.uint16),
        }
        stats = np.zeros(5, dtype=np.int64)
        count = self.lib.cn_map_pairs(
            self.ctx, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr,
            n, base_read_id, cache_update_threshold,
            _ptr(out["rid"]), _ptr(out["read_id"]), _ptr(out["start"]),
            _ptr(out["flen"]), _ptr(out["mapq"]), _ptr(out["dir"]),
            _ptr(out["uniq"]), _ptr(out["posalen"]), _ptr(out["negalen"]),
            _ptr(stats))
        for key in out:
            out[key] = out[key][:count]
        return out, stats


    def map_single_raw(self, r_bytes, r_off_ptr, n: int, base_read_id: int,
                       cache_update_threshold: int) -> Tuple[dict, np.ndarray]:
        """Single-end mapping (mapping_generator.h:114-157 selection)."""
        cap = max(1, n * max(1, self.cfg.max_num_best_mappings))
        out = {
            "rid": np.empty(cap, dtype=np.int32),
            "read_id": np.empty(cap, dtype=np.uint32),
            "start": np.empty(cap, dtype=np.uint32),
            "flen": np.empty(cap, dtype=np.uint16),
            "mapq": np.empty(cap, dtype=np.uint8),
            "dir": np.empty(cap, dtype=np.uint8),
            "uniq": np.empty(cap, dtype=np.uint8),
        }
        stats = np.zeros(5, dtype=np.int64)
        count = self.lib.cn_map_single(
            self.ctx, r_bytes, r_off_ptr, n, base_read_id,
            cache_update_threshold,
            _ptr(out["rid"]), _ptr(out["read_id"]), _ptr(out["start"]),
            _ptr(out["flen"]), _ptr(out["mapq"]), _ptr(out["dir"]),
            _ptr(out["uniq"]), _ptr(stats))
        for key in out:
            out[key] = out[key][:count]
        out["posalen"] = np.zeros(count, dtype=np.uint16)
        out["negalen"] = np.zeros(count, dtype=np.uint16)
        return out, stats

    def map_single_dev_seeded(self, r_bytes, r_off_ptr, n: int,
                              base_read_id: int, read_meta: np.ndarray,
                              cand_pos: np.ndarray, cand_meta: np.ndarray
                              ) -> Tuple[dict, np.ndarray]:
        """Single-end finish from device-computed seeding + verification."""
        read_meta = np.ascontiguousarray(read_meta, dtype=np.uint64)
        cand_pos = np.ascontiguousarray(cand_pos, dtype=np.uint64)
        cand_meta = np.ascontiguousarray(cand_meta, dtype=np.uint32)
        cap = max(1, n * max(1, self.cfg.max_num_best_mappings))
        out = {
            "rid": np.empty(cap, dtype=np.int32),
            "read_id": np.empty(cap, dtype=np.uint32),
            "start": np.empty(cap, dtype=np.uint32),
            "flen": np.empty(cap, dtype=np.uint16),
            "mapq": np.empty(cap, dtype=np.uint8),
            "dir": np.empty(cap, dtype=np.uint8),
            "uniq": np.empty(cap, dtype=np.uint8),
        }
        stats = np.zeros(5, dtype=np.int64)
        count = self.lib.cn_map_single_dev(
            self.ctx, r_bytes, r_off_ptr, n, base_read_id,
            _ptr(read_meta), _ptr(cand_pos), _ptr(cand_meta),
            _ptr(out["rid"]), _ptr(out["read_id"]), _ptr(out["start"]),
            _ptr(out["flen"]), _ptr(out["mapq"]), _ptr(out["dir"]),
            _ptr(out["uniq"]), _ptr(stats))
        for key in out:
            out[key] = out[key][:count]
        out["posalen"] = np.zeros(count, dtype=np.uint16)
        out["negalen"] = np.zeros(count, dtype=np.uint16)
        return out, stats

    def map_pairs_full_raw(self, r1_bytes, r1_off_ptr, r2_bytes,
                           r2_off_ptr, n: int, base_read_id: int,
                           cache_update_threshold: int,
                           sam_aux: bool = False):
        cap = max(1, n * max(1, self.cfg.max_num_best_mappings))
        out = {
            "rid": np.empty(cap, dtype=np.int32),
            "read_id": np.empty(cap, dtype=np.uint32),
            "start": np.empty(cap, dtype=np.uint32),
            "flen": np.empty(cap, dtype=np.uint16),
            "mapq": np.empty(cap, dtype=np.uint8),
            "dir": np.empty(cap, dtype=np.uint8),
            "uniq": np.empty(cap, dtype=np.uint8),
            "posalen": np.empty(cap, dtype=np.uint16),
            "negalen": np.empty(cap, dtype=np.uint16),
            "rs1": np.empty(cap, dtype=np.uint32),
            "re1": np.empty(cap, dtype=np.uint32),
            "rs2": np.empty(cap, dtype=np.uint32),
            "re2": np.empty(cap, dtype=np.uint32),
            "err1": np.empty(cap, dtype=np.uint8),
            "err2": np.empty(cap, dtype=np.uint8),
            "mapq1": np.empty(cap, dtype=np.uint8),
            "mapq2": np.empty(cap, dtype=np.uint8),
            "rid2": np.empty(cap, dtype=np.int32),
            "dir2": np.empty(cap, dtype=np.uint8),
        }
        stats = np.zeros(5, dtype=np.int64)
        count = self.lib.cn_map_pairs_full(
            self.ctx, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr,
            n, base_read_id, cache_update_threshold,
            _ptr(out["rid"]), _ptr(out["read_id"]), _ptr(out["start"]),
            _ptr(out["flen"]), _ptr(out["mapq"]), _ptr(out["dir"]),
            _ptr(out["uniq"]), _ptr(out["posalen"]), _ptr(out["negalen"]),
            _ptr(out["rs1"]), _ptr(out["re1"]), _ptr(out["rs2"]),
            _ptr(out["re2"]), _ptr(out["err1"]), _ptr(out["err2"]),
            _ptr(out["mapq1"]), _ptr(out["mapq2"]), _ptr(out["rid2"]),
            _ptr(out["dir2"]), _ptr(stats))
        for key in out:
            out[key] = out[key][:count]
        aux = None
        if sam_aux:
            cb = ctypes.POINTER(ctypes.c_uint32)()
            co = ctypes.POINTER(ctypes.c_int64)()
            mb = ctypes.POINTER(ctypes.c_char)()
            mo = ctypes.POINTER(ctypes.c_int64)()
            nm = ctypes.POINTER(ctypes.c_uint16)()
            mdl = ctypes.c_int64()
            n_rec = self.lib.cn_get_sam_aux(
                self.ctx, ctypes.byref(cb), ctypes.byref(co),
                ctypes.byref(mb), ctypes.byref(mo), ctypes.byref(nm),
                ctypes.byref(mdl))
            co_a = np.ctypeslib.as_array(co, shape=(n_rec + 1,)).copy()
            cb_a = (np.ctypeslib.as_array(cb, shape=(int(co_a[-1]),)).copy()
                    if co_a[-1] else np.empty(0, np.uint32))
            mo_a = np.ctypeslib.as_array(mo, shape=(n_rec + 1,)).copy()
            md_b = ctypes.string_at(mb, mdl.value) if mdl.value else b""
            nm_a = (np.ctypeslib.as_array(nm, shape=(n_rec,)).copy()
                    if n_rec else np.empty(0, np.uint16))
            aux = (cb_a, co_a, md_b, mo_a, nm_a)
        return out, stats, aux

    def phase1_run(self, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr,
                   n: int, cache_update_threshold: int):
        """Seed + verify one chunk into a detached state (selection later
        via phase1_finish, in chunk order)."""
        return self.lib.cn_phase1_run(self.ctx, r1_bytes, r1_off_ptr,
                                      r2_bytes, r2_off_ptr, n,
                                      cache_update_threshold)

    def phase1_finish(self, handle, n: int,
                      base_read_id: int) -> Tuple[dict, np.ndarray]:
        """Selection + records for a phase1_run chunk (frees it)."""
        cap = max(1, n * max(1, self.cfg.max_num_best_mappings))
        out = {
            "rid": np.empty(cap, dtype=np.int32),
            "read_id": np.empty(cap, dtype=np.uint32),
            "start": np.empty(cap, dtype=np.uint32),
            "flen": np.empty(cap, dtype=np.uint16),
            "mapq": np.empty(cap, dtype=np.uint8),
            "dir": np.empty(cap, dtype=np.uint8),
            "uniq": np.empty(cap, dtype=np.uint8),
            "posalen": np.empty(cap, dtype=np.uint16),
            "negalen": np.empty(cap, dtype=np.uint16),
        }
        stats = np.zeros(5, dtype=np.int64)
        count = self.lib.cn_phase1_finish(
            self.ctx, handle, base_read_id,
            _ptr(out["rid"]), _ptr(out["read_id"]), _ptr(out["start"]),
            _ptr(out["flen"]), _ptr(out["mapq"]), _ptr(out["dir"]),
            _ptr(out["uniq"]), _ptr(out["posalen"]), _ptr(out["negalen"]),
            _ptr(stats))
        for key in out:
            out[key] = out[key][:count]
        return out, stats

    def lowmem_merge_bed(self, cfg, ref_names, shard_paths,
                         cell_barcode_length: int, whitelist,
                         want_summary: bool):
        """Native k-way merge + streaming dedup + Tn5 + BED/TagAlign write
        of sorted temp shards (io/lowmem.py CTSH1 format, BED-family
        tags); the exact semantics of merge_and_output_low_memory.
        Returns (num_uni, num_multi, num_passing, summary_items) where
        summary_items is [(barcode, mapped, dup, lowmapq), ...]."""
        names_bytes = b"".join(ref_names)
        name_offsets = np.zeros(len(ref_names) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in ref_names], out=name_offsets[1:])
        enc = [p.encode() for p in shard_paths]
        paths_bytes = b"".join(enc)
        path_offsets = np.zeros(len(enc) + 1, dtype=np.int64)
        np.cumsum([len(p) for p in enc], out=path_offsets[1:])
        dedup_bulk = (cfg.remove_pcr_duplicates and not cfg.is_bulk_data
                      and cfg.remove_pcr_duplicates_at_bulk_level)
        wl_keys = wl_counts = None
        wl_n = 0
        if dedup_bulk and whitelist is not None and whitelist.table:
            wl_keys = np.fromiter(whitelist.table.keys(), dtype=np.uint64,
                                  count=len(whitelist.table))
            wl_counts = np.fromiter(whitelist.table.values(),
                                    dtype=np.int64,
                                    count=len(whitelist.table))
            order = np.argsort(wl_keys)
            wl_keys = np.ascontiguousarray(wl_keys[order])
            wl_counts = np.ascontiguousarray(wl_counts[order])
            wl_n = len(wl_keys)
        stats = np.zeros(3, dtype=np.int64)
        fmt = 0 if cfg.output_format == "bed" else 1
        res = self.lib.cn_lowmem_merge_bed(
            self.ctx, cfg.mapping_output_file_path.encode(), fmt,
            paths_bytes, _ptr(path_offsets), len(enc),
            cfg.mapq_threshold, 1 if cfg.tn5_shift else 0,
            1 if cfg.remove_pcr_duplicates else 0, 1 if dedup_bulk else 0,
            names_bytes, _ptr(name_offsets), len(ref_names),
            cell_barcode_length,
            _ptr(wl_keys) if wl_keys is not None else None,
            _ptr(wl_counts) if wl_counts is not None else None, wl_n,
            1 if want_summary else 0, _ptr(stats))
        if res < 0:
            raise IOError(f"native low-mem merge failed ({res})")
        items = []
        if want_summary:
            kp = ctypes.POINTER(ctypes.c_uint64)()
            cp = ctypes.POINTER(ctypes.c_int64)()
            nk = self.lib.cn_get_lowmem_summary(self.ctx,
                                                ctypes.byref(kp),
                                                ctypes.byref(cp))
            for i in range(nk):
                items.append((int(kp[i]), int(cp[3 * i]),
                              int(cp[3 * i + 1]), int(cp[3 * i + 2])))
        return int(stats[0]), int(stats[1]), int(stats[2]), items

    def lowmem_merge_pairs(self, cfg, ref_names, shard_paths, whitelist,
                           want_summary: bool):
        """Native k-way merge + dedup + append-after-header write of
        4DN-pairs temp shards (tag 6). Returns
        (num_uni, num_multi, num_passing, summary_items)."""
        names_bytes = b"".join(ref_names)
        name_offsets = np.zeros(len(ref_names) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in ref_names], out=name_offsets[1:])
        enc = [p.encode() for p in shard_paths]
        paths_bytes = b"".join(enc)
        path_offsets = np.zeros(len(enc) + 1, dtype=np.int64)
        np.cumsum([len(p) for p in enc], out=path_offsets[1:])
        dedup_bulk = (cfg.remove_pcr_duplicates and not cfg.is_bulk_data
                      and cfg.remove_pcr_duplicates_at_bulk_level)
        wl_keys = wl_counts = None
        wl_n = 0
        if dedup_bulk and whitelist is not None and whitelist.table:
            wl_keys = np.fromiter(whitelist.table.keys(), dtype=np.uint64,
                                  count=len(whitelist.table))
            wl_counts = np.fromiter(whitelist.table.values(),
                                    dtype=np.int64,
                                    count=len(whitelist.table))
            order = np.argsort(wl_keys)
            wl_keys = np.ascontiguousarray(wl_keys[order])
            wl_counts = np.ascontiguousarray(wl_counts[order])
            wl_n = len(wl_keys)
        stats = np.zeros(3, dtype=np.int64)
        res = self.lib.cn_lowmem_merge_pairs(
            self.ctx, cfg.mapping_output_file_path.encode(),
            paths_bytes, _ptr(path_offsets), len(enc),
            cfg.mapq_threshold,
            1 if cfg.remove_pcr_duplicates else 0, 1 if dedup_bulk else 0,
            names_bytes, _ptr(name_offsets), len(ref_names),
            _ptr(wl_keys) if wl_keys is not None else None,
            _ptr(wl_counts) if wl_counts is not None else None, wl_n,
            1 if want_summary else 0, _ptr(stats))
        if res < 0:
            raise IOError(f"native pairs merge failed ({res})")
        items = []
        if want_summary:
            kp = ctypes.POINTER(ctypes.c_uint64)()
            cp = ctypes.POINTER(ctypes.c_int64)()
            nk = self.lib.cn_get_lowmem_summary(self.ctx,
                                                ctypes.byref(kp),
                                                ctypes.byref(cp))
            for i in range(nk):
                items.append((int(kp[i]), int(cp[3 * i]),
                              int(cp[3 * i + 1]), int(cp[3 * i + 2])))
        return int(stats[0]), int(stats[1]), int(stats[2]), items

    def set_rid_rank(self, ranks: List[int]) -> None:
        """Custom chromosome order: rank per original rid (--chr-order)."""
        self._rid_rank = np.asarray(ranks, dtype=np.int32)
        self.lib.cn_set_rid_rank(self.ctx, _ptr(self._rid_rank),
                                 len(self._rid_rank))

    def get_pair_trimmed_lengths(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-pair read lengths after adapter trimming (last paired call)."""
        p1 = ctypes.POINTER(ctypes.c_uint16)()
        p2 = ctypes.POINTER(ctypes.c_uint16)()
        n = self.lib.cn_get_pair_trimmed_lengths(self.ctx, ctypes.byref(p1),
                                                 ctypes.byref(p2))
        if not n:
            return np.empty(0, np.uint16), np.empty(0, np.uint16)
        return (np.ctypeslib.as_array(p1, shape=(n,)).copy(),
                np.ctypeslib.as_array(p2, shape=(n,)).copy())

    def get_pair_flags(self) -> np.ndarray:
        """Per-pair flags from the last paired mapping call (bit0 = cache
        hit on either end)."""
        fp = ctypes.POINTER(ctypes.c_uint8)()
        n = self.lib.cn_get_pair_flags(self.ctx, ctypes.byref(fp))
        return (np.ctypeslib.as_array(fp, shape=(n,)).copy()
                if n else np.empty(0, np.uint8))

    def get_sam_aux(self):
        """CIGAR/NM/MD streams recorded by the last SAM-mode mapping call."""
        cb = ctypes.POINTER(ctypes.c_uint32)()
        co = ctypes.POINTER(ctypes.c_int64)()
        mb = ctypes.POINTER(ctypes.c_char)()
        mo = ctypes.POINTER(ctypes.c_int64)()
        nm = ctypes.POINTER(ctypes.c_uint16)()
        mdl = ctypes.c_int64()
        n_rec = self.lib.cn_get_sam_aux(
            self.ctx, ctypes.byref(cb), ctypes.byref(co), ctypes.byref(mb),
            ctypes.byref(mo), ctypes.byref(nm), ctypes.byref(mdl))
        co_a = np.ctypeslib.as_array(co, shape=(n_rec + 1,)).copy()
        cb_a = (np.ctypeslib.as_array(cb, shape=(int(co_a[-1]),)).copy()
                if co_a[-1] else np.empty(0, np.uint32))
        mo_a = np.ctypeslib.as_array(mo, shape=(n_rec + 1,)).copy()
        md_b = ctypes.string_at(mb, mdl.value) if mdl.value else b""
        nm_a = (np.ctypeslib.as_array(nm, shape=(n_rec,)).copy()
                if n_rec else np.empty(0, np.uint16))
        return cb_a, co_a, md_b, mo_a, nm_a

    def set_split_mode(self):
        self.lib.cn_set_split_mode(self.ctx)

    def set_debug_cache(self):
        """--debug-cache verbose tracing (mmcache.hpp:300-330 analog)."""
        self.lib.cn_set_debug_cache(self.ctx)

    def set_cache_off(self):
        """Disable the candidate cache for this run (--device /
        --no-cache): mmcache hits are only approximately equal to fresh
        candidate generation, so a cache-free run is the configuration
        whose output is invariant to which engine maps each chunk."""
        self.lib.cn_set_cache_off(self.ctx)

    def cache_print_stats(self):
        """Per-slot cache stats dump (mmcache.hpp:371-386 format)."""
        self.lib.cn_cache_print_stats(self.ctx)

    def set_sam_params(self):
        cfg = self.cfg
        go = list(getattr(cfg, "gap_open_penalties", [6, 6]))
        ge = list(getattr(cfg, "gap_extension_penalties", [1, 1]))
        self.lib.cn_set_sam_params(
            self.ctx, int(getattr(cfg, "match_score", 1)),
            int(getattr(cfg, "mismatch_penalty", 4)),
            int(go[0]), int(go[1]), int(ge[0]), int(ge[1]))

    def map_pairs_dev_seeded(self, r1_bytes, r1_off_ptr, r2_bytes,
                             r2_off_ptr, n: int, base_read_id: int,
                             read_meta: np.ndarray, cand_pos: np.ndarray,
                             cand_meta: np.ndarray) -> Tuple[dict, np.ndarray]:
        """Finish mapping from device-computed seeding + verification
        (ops/device_seed.py): reduce, selection, MAPQ, records run natively;
        flagged pairs re-run the exact host path. In split mode cand_meta
        is (cand_meta, cand_split) carrying the packed drop-off results."""
        cand_split = None
        if isinstance(cand_meta, tuple):
            cand_meta, cand_split = cand_meta
            cand_split = np.ascontiguousarray(cand_split, dtype=np.uint64)
        read_meta = np.ascontiguousarray(read_meta, dtype=np.uint64)
        cand_pos = np.ascontiguousarray(cand_pos, dtype=np.uint64)
        cand_meta = np.ascontiguousarray(cand_meta, dtype=np.uint32)
        cap = max(1, n * max(1, self.cfg.max_num_best_mappings))
        out = {
            "rid": np.empty(cap, dtype=np.int32),
            "read_id": np.empty(cap, dtype=np.uint32),
            "start": np.empty(cap, dtype=np.uint32),
            "flen": np.empty(cap, dtype=np.uint16),
            "mapq": np.empty(cap, dtype=np.uint8),
            "dir": np.empty(cap, dtype=np.uint8),
            "uniq": np.empty(cap, dtype=np.uint8),
            "posalen": np.empty(cap, dtype=np.uint16),
            "negalen": np.empty(cap, dtype=np.uint16),
        }
        stats = np.zeros(5, dtype=np.int64)
        count = self.lib.cn_map_pairs_dev(
            self.ctx, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr,
            n, base_read_id, _ptr(read_meta), _ptr(cand_pos),
            _ptr(cand_meta),
            _ptr(out["rid"]), _ptr(out["read_id"]), _ptr(out["start"]),
            _ptr(out["flen"]), _ptr(out["mapq"]), _ptr(out["dir"]),
            _ptr(out["uniq"]), _ptr(out["posalen"]), _ptr(out["negalen"]),
            _ptr(stats),
            _ptr(cand_split) if cand_split is not None else None)
        for key in out:
            out[key] = out[key][:count]
        return out, stats

    def map_pairs_dev_seeded_full(self, r1_bytes, r1_off_ptr, r2_bytes,
                                  r2_off_ptr, n: int, base_read_id: int,
                                  read_meta: np.ndarray,
                                  cand_pos: np.ndarray,
                                  cand_meta: np.ndarray):
        """Device-seeded finish with the extended per-end outputs
        (PAF/pairs/SAM flows on the device path); split mode passes
        cand_meta as (cand_meta, cand_split)."""
        cand_split = None
        if isinstance(cand_meta, tuple):
            cand_meta, cand_split = cand_meta
            cand_split = np.ascontiguousarray(cand_split, dtype=np.uint64)
        read_meta = np.ascontiguousarray(read_meta, dtype=np.uint64)
        cand_pos = np.ascontiguousarray(cand_pos, dtype=np.uint64)
        cand_meta = np.ascontiguousarray(cand_meta, dtype=np.uint32)
        cap = max(1, n * max(1, self.cfg.max_num_best_mappings))
        out = {
            "rid": np.empty(cap, dtype=np.int32),
            "read_id": np.empty(cap, dtype=np.uint32),
            "start": np.empty(cap, dtype=np.uint32),
            "flen": np.empty(cap, dtype=np.uint16),
            "mapq": np.empty(cap, dtype=np.uint8),
            "dir": np.empty(cap, dtype=np.uint8),
            "uniq": np.empty(cap, dtype=np.uint8),
            "posalen": np.empty(cap, dtype=np.uint16),
            "negalen": np.empty(cap, dtype=np.uint16),
            "rs1": np.empty(cap, dtype=np.uint32),
            "re1": np.empty(cap, dtype=np.uint32),
            "rs2": np.empty(cap, dtype=np.uint32),
            "re2": np.empty(cap, dtype=np.uint32),
            "err1": np.empty(cap, dtype=np.uint8),
            "err2": np.empty(cap, dtype=np.uint8),
            "mapq1": np.empty(cap, dtype=np.uint8),
            "mapq2": np.empty(cap, dtype=np.uint8),
            "rid2": np.empty(cap, dtype=np.int32),
            "dir2": np.empty(cap, dtype=np.uint8),
        }
        stats = np.zeros(5, dtype=np.int64)
        count = self.lib.cn_map_pairs_dev_full(
            self.ctx, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr,
            n, base_read_id, _ptr(read_meta), _ptr(cand_pos),
            _ptr(cand_meta),
            _ptr(out["rid"]), _ptr(out["read_id"]), _ptr(out["start"]),
            _ptr(out["flen"]), _ptr(out["mapq"]), _ptr(out["dir"]),
            _ptr(out["uniq"]), _ptr(out["posalen"]), _ptr(out["negalen"]),
            _ptr(out["rs1"]), _ptr(out["re1"]), _ptr(out["rs2"]),
            _ptr(out["re2"]), _ptr(out["err1"]), _ptr(out["err2"]),
            _ptr(out["mapq1"]), _ptr(out["mapq2"]), _ptr(out["rid2"]),
            _ptr(out["dir2"]), _ptr(stats),
            _ptr(cand_split) if cand_split is not None else None)
        for key in out:
            out[key] = out[key][:count]
        return out, stats

    def map_pairs_device(self, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr,
                         n: int, base_read_id: int,
                         cache_update_threshold: int, ref_codes: np.ndarray,
                         device=None) -> Tuple[dict, np.ndarray]:
        """C++ collects the verification work, the Myers batch runs on
        the torch `device` (kernel B on CUDA, its plain version on the
        CPU; None: the numpy form on the host), and C++ finishes
        selection with the precomputed distances. `ref_codes` is the
        concatenated reference as uint8 codes."""
        ps_p = ctypes.POINTER(ctypes.c_int64)()
        to_p = ctypes.POINTER(ctypes.c_int32)()
        tl_p = ctypes.POINTER(ctypes.c_int32)()
        tc_p = ctypes.POINTER(ctypes.c_uint8)()
        tc_len = ctypes.c_int64()
        n_items = self.lib.cn_collect_pairs(
            self.ctx, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr, n,
            ctypes.byref(ps_p), ctypes.byref(to_p), ctypes.byref(tl_p),
            ctypes.byref(tc_p), ctypes.byref(tc_len))

        errors = np.full(max(1, n_items), 0, dtype=np.int32)
        ends = np.zeros(max(1, n_items), dtype=np.int32)
        if n_items > 0:
            pattern_starts = np.ctypeslib.as_array(ps_p, shape=(n_items,))
            text_offsets = np.ctypeslib.as_array(to_p, shape=(n_items,))
            text_lengths = np.ctypeslib.as_array(tl_p, shape=(n_items,))
            text_codes = np.ctypeslib.as_array(tc_p, shape=(tc_len.value,))
            e = self.cfg.error_threshold
            from ..ops import myers
            for L in np.unique(text_lengths):
                rows = np.flatnonzero(text_lengths == L)
                pat_idx = (pattern_starts[rows, None]
                           + np.arange(L + 2 * e)[None, :])
                pats = ref_codes[pat_idx]
                txt_idx = (text_offsets[rows, None]
                           + np.arange(L)[None, :])
                txts = text_codes[txt_idx]
                if device is not None:
                    err, endp = myers.banded_distance_batch(
                        pats, txts, e, device=device)
                else:
                    err, endp = myers.banded_distance_batch_numpy(
                        pats, txts, e)
                errors[rows] = err
                ends[rows] = endp

        cap = max(1, n * max(1, self.cfg.max_num_best_mappings))
        out = {
            "rid": np.empty(cap, dtype=np.int32),
            "read_id": np.empty(cap, dtype=np.uint32),
            "start": np.empty(cap, dtype=np.uint32),
            "flen": np.empty(cap, dtype=np.uint16),
            "mapq": np.empty(cap, dtype=np.uint8),
            "dir": np.empty(cap, dtype=np.uint8),
            "uniq": np.empty(cap, dtype=np.uint8),
            "posalen": np.empty(cap, dtype=np.uint16),
            "negalen": np.empty(cap, dtype=np.uint16),
        }
        stats = np.zeros(5, dtype=np.int64)
        count = self.lib.cn_map_pairs_ext(
            self.ctx, r1_bytes, r1_off_ptr, r2_bytes, r2_off_ptr,
            n, base_read_id, cache_update_threshold, _ptr(errors), _ptr(ends),
            _ptr(out["rid"]), _ptr(out["read_id"]), _ptr(out["start"]),
            _ptr(out["flen"]), _ptr(out["mapq"]), _ptr(out["dir"]),
            _ptr(out["uniq"]), _ptr(out["posalen"]), _ptr(out["negalen"]),
            _ptr(stats))
        for key in out:
            out[key] = out[key][:count]
        return out, stats


class NativeFastxReader:
    """Batched FASTQ(.gz) reader; batches stay in native buffers and are
    passed to cn_map_pairs by pointer (no Python copies)."""

    def __init__(self, path: str):
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native library unavailable")
        self.path = path
        self.handle = self.lib.cn_fastx_open(path.encode())
        if not self.handle:
            raise FileNotFoundError(path)

    def close(self):
        if self.handle:
            self.lib.cn_fastx_close(self.handle)
            self.handle = None

    def read_batch(self, max_n: int):
        """Returns (n, seq_bytes_ptr, offsets_ptr); pointers are valid until
        the next read_batch call."""
        seq_ptr = ctypes.c_char_p()
        off_ptr = ctypes.POINTER(ctypes.c_int64)()
        n = self.lib.cn_fastx_read_batch(self.handle, max_n,
                                         ctypes.byref(seq_ptr),
                                         ctypes.byref(off_ptr))
        return n, seq_ptr, ctypes.cast(off_ptr, ctypes.c_void_p)

    def read_batch_named(self, max_n: int):
        """Up to max_n reads with their names, parsed as io/fastx.py's
        FastxReader parses them: (n, bases, offsets, names, name_offsets).
        `bases` points into the reader's buffers and `offsets` (n+1 int64)
        is a view of them, both valid until the second call after this
        one; `names` is a copy. Fewer than max_n reads means the file has
        ended. A malformed record raises ValueError."""
        seq_ptr = ctypes.c_char_p()
        off_ptr = ctypes.POINTER(ctypes.c_int64)()
        name_ptr = ctypes.c_void_p()
        name_off_ptr = ctypes.POINTER(ctypes.c_int64)()
        err = ctypes.c_char_p()
        n = self.lib.cn_fastx_read_batch_named(
            self.handle, max_n, ctypes.byref(seq_ptr), ctypes.byref(off_ptr),
            ctypes.byref(name_ptr), ctypes.byref(name_off_ptr),
            ctypes.byref(err))
        if n < 0:
            msg = f"{err.value.decode(errors='replace')} in {self.path!r}"
            raise ValueError(msg) if n == -1 else EOFError(msg)
        offsets = np.ctypeslib.as_array(off_ptr, shape=(n + 1,))
        name_offsets = np.ctypeslib.as_array(name_off_ptr, shape=(n + 1,))
        size = int(name_offsets[n])
        names = ctypes.string_at(name_ptr, size) if size else b""
        return n, seq_ptr, offsets, names, name_offsets


class NativeReadBatch:
    """One batch of a NativeFastxStream: its reads' bases as one blob with
    n+1 int64 offsets, their names likewise, and the id of the first read
    (the ids run on by one)."""

    __slots__ = ("bases", "offsets", "names", "name_offsets", "first_id")

    def __init__(self, bases, offsets, names, name_offsets, first_id):
        self.bases = bases
        self.offsets = offsets
        self.names = names
        self.name_offsets = name_offsets
        self.first_id = first_id

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def read_ids(self) -> np.ndarray:
        return np.arange(self.first_id, self.first_id + len(self),
                         dtype=np.uint32)


def _join_parts(parts):
    """One batch out of the parts that several files gave it: the bases
    and names copied out of each reader's buffers and their offsets
    shifted."""
    bases, offs, names, name_offs = [], [], [], []
    shift = name_shift = 0
    for _, seq_ptr, o, nm, no in parts:
        size = int(o[-1])
        bases.append(ctypes.string_at(seq_ptr, size))
        offs.append(o[:-1] + shift)
        names.append(nm)
        name_offs.append(no[:-1] + name_shift)
        shift += size
        name_shift += len(nm)
    offs.append(np.array([shift], dtype=np.int64))
    name_offs.append(np.array([name_shift], dtype=np.int64))
    return (b"".join(bases), np.concatenate(offs), b"".join(names),
            np.concatenate(name_offs))


class NativeFastxStream:
    """io/fastx.py's MultiFileFastxStream read natively: the same batches
    (filled across file boundaries up to the batch size, read ids running
    on across files), each a NativeReadBatch. A batch from one file keeps
    its bases in that reader's buffers, so it is valid until the second
    read_batch call after it; one that spans files is a copy."""

    def __init__(self, paths: List[str]):
        self._paths = list(paths)
        self._path_index = 0
        self._reader: Optional[NativeFastxReader] = None
        self._ended: List[NativeFastxReader] = []
        self._next_id = 0

    def read_batch(self, batch_size: int) -> NativeReadBatch:
        # readers that ended in the last batch still hold its reads
        self._close_ended()
        parts = []
        got = 0
        while got < batch_size:
            if self._reader is None:
                if self._path_index >= len(self._paths):
                    break
                self._reader = NativeFastxReader(
                    self._paths[self._path_index])
                self._path_index += 1
            part = self._reader.read_batch_named(batch_size - got)
            if part[0] < batch_size - got:
                self._ended.append(self._reader)
                self._reader = None
            if part[0]:
                parts.append(part)
                got += part[0]
        if len(parts) == 1:
            _, bases, offsets, names, name_offsets = parts[0]
        elif parts:
            bases, offsets, names, name_offsets = _join_parts(parts)
        else:
            bases, offsets, names, name_offsets = (
                b"", np.zeros(1, dtype=np.int64), b"",
                np.zeros(1, dtype=np.int64))
        batch = NativeReadBatch(bases, offsets, names, name_offsets,
                                self._next_id)
        self._next_id += got
        return batch

    def _close_ended(self) -> None:
        for reader in self._ended:
            reader.close()
        self._ended = []

    def close(self) -> None:
        self._close_ended()
        if self._reader is not None:
            self._reader.close()
            self._reader = None


class NativeFastxPairStream:
    """The two mates' NativeFastxStreams of a paired run, read at once (a
    native read drops the GIL): each read_batch gives the batches the two
    streams give one after the other."""

    def __init__(self, paths1: List[str], paths2: List[str]):
        self._streams = (NativeFastxStream(paths1), NativeFastxStream(paths2))
        self._mate = ThreadPoolExecutor(max_workers=1)

    def read_batch(self, batch_size: int):
        mate = self._mate.submit(self._streams[1].read_batch, batch_size)
        try:
            batch1 = self._streams[0].read_batch(batch_size)
        finally:
            # no reader closes while the mate's read runs
            futures.wait([mate])
        return batch1, mate.result()

    def close(self) -> None:
        self._mate.shutdown()
        for stream in self._streams:
            stream.close()

    def __del__(self):
        self.close()


def native_postprocess_write(cfg, ref_names: List[bytes], arrays: dict,
                             tn5: bool, dedup: bool,
                             se_mode: bool = False) -> Tuple[int, int, int]:
    """Sort/Tn5/dedup/filter/write PE (or SE) records natively. Returns
    (written, uni, multi). With tracing on, the stages' own clock stamps
    become the spans output.sort (the Tn5 shift and the sort) and
    output.write (the dedup, fused with the filter, format and write),
    children of the span open around the call."""
    lib = load_library()
    names_bytes = b"".join(ref_names)
    name_offsets = np.zeros(len(ref_names) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in ref_names], out=name_offsets[1:])
    n = len(arrays["rid"])
    # written, uni, multi, then the three stamps of cn_postprocess_write
    stats = np.zeros(6, dtype=np.int64)
    fmt = 0 if cfg.output_format == "bed" else 1
    res = lib.cn_postprocess_write(
        cfg.mapping_output_file_path.encode(), fmt, cfg.mapq_threshold,
        1 if tn5 else 0, 1 if dedup else 0, 1 if se_mode else 0, names_bytes,
        _ptr(name_offsets), len(ref_names), _ptr(arrays["rid"]),
        _ptr(arrays["read_id"]), _ptr(arrays["start"]), _ptr(arrays["flen"]),
        _ptr(arrays["mapq"]), _ptr(arrays["dir"]), _ptr(arrays["uniq"]),
        _ptr(arrays["posalen"]), _ptr(arrays["negalen"]), n, _ptr(stats))
    if res < 0:
        raise IOError(f"cannot write {cfg.mapping_output_file_path}")
    if tracing.TRACER.on:
        t0, t1, t2 = stats[3:].tolist()
        tracing.add("output.sort", t0, t1)
        tracing.add("output.write", t1, t2)
    return int(stats[0]), int(stats[1]), int(stats[2])


def native_build_index_arrays(reference_codes, k: int, w: int,
                              num_threads: int = 1):
    """Minimizer collection + (hash, hit) sort + unique/count pass in C++
    (the exact Index::Construct pipeline, index.cc:12-89). Returns
    (hash_keys, offsets, counts, occurrences) or None when the native
    library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    b = lib.cn_index_begin(k, w, int(num_threads))
    try:
        for seq_index, codes in enumerate(reference_codes):
            arr = np.ascontiguousarray(codes, dtype=np.uint8)
            lib.cn_index_add(b, _ptr(arr), len(arr), seq_index)
        num_keys = ctypes.c_int64()
        total = lib.cn_index_finalize(b, ctypes.byref(num_keys))
        if total == 0:
            raise ValueError("Reference produced no minimizers")
        hash_keys = np.empty(num_keys.value, dtype=np.uint64)
        offsets = np.empty(num_keys.value, dtype=np.uint64)
        counts = np.empty(num_keys.value, dtype=np.uint32)
        occurrences = np.empty(total, dtype=np.uint64)
        lib.cn_index_export(b, _ptr(hash_keys), _ptr(offsets), _ptr(counts),
                            _ptr(occurrences))
        return hash_keys, offsets, counts, occurrences
    finally:
        lib.cn_index_destroy(b)
