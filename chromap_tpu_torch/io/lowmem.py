"""Low-memory mode: sorted spill shards + streaming k-way merge output.

Mirrors mapping_writer.h:166-402 and temp_mapping.h: when in-memory
mappings exceed the budget they are sorted per-rid and spilled to a temp
shard; at the end all shards are k-way merged with streaming PCR dedup
(keeping the highest-mapq duplicate; bulk-level barcode selection for
single-cell data), mapq filtering, and Tn5 shifting.

Shards are block-buffered binary record streams (the analog of the
reference's raw-struct temp files, temp_mapping.h:21-105): per rid a u64
count followed by the records in their binary codec (records.py), written
and read through fixed-size buffers so neither side ever holds more than
one block per shard in memory. The merge's total buffer budget mirrors the
reference's 10 GiB (1 GiB for SAM/pairs/PAF) cap (mapping_writer.h:
179-184). The same merge generalizes to multi-host sorted-shard merging
(each host spills its shards; one merge pass unifies them).
"""

from __future__ import annotations

import heapq
import os
import struct

import numpy as np
from typing import Iterator, List, Optional, Tuple

from .. import tracing
from ..config import MappingConfig
from ..mapping.records import RECORD_CODECS, RECORD_TAGS
from ..summary import DUP, LOWMAPQ, MAPPED

_U64 = struct.Struct("<Q")
_MAGIC = b"CTSH1\x00"
_WRITE_BLOCK = 1 << 18          # flush granularity (256 KiB)
_MAX_RECORD_BYTES = 1 << 16     # decode refill threshold (any record fits)
_MERGE_BUDGET = 10 << 30        # reference merge budgets
_MERGE_BUDGET_TEXT = 1 << 30    # SAM / pairs / PAF


class TempMappingShard:
    def __init__(self, path: str, read_block: int = 1 << 22):
        self.path = path
        self.read_block = max(read_block, 2 * _MAX_RECORD_BYTES)

    @staticmethod
    def write(path: str, mappings_on_refs: List[List[object]]) -> None:
        tag = 0
        for lst in mappings_on_refs:
            if lst:
                tag = RECORD_TAGS[type(lst[0])]
                break
        buf = bytearray()
        buf += _MAGIC
        buf += bytes([tag])
        buf += _U64.pack(len(mappings_on_refs))
        with open(path, "wb") as f:
            for lst in mappings_on_refs:
                buf += _U64.pack(len(lst))
                for m in lst:
                    m.to_binary(buf)
                    if len(buf) >= _WRITE_BLOCK:
                        f.write(buf)
                        buf.clear()
            if buf:
                f.write(buf)

    def iterate(self) -> Iterator[Tuple[int, object]]:
        """Streaming decode: holds at most one read block in memory."""
        with open(self.path, "rb", buffering=0) as f:
            buf = bytearray(f.read(self.read_block))
            off = 0

            def ensure(n: int) -> bool:
                nonlocal buf, off
                if len(buf) - off >= n:
                    return True
                del buf[:off]
                off = 0
                chunk = f.read(self.read_block)
                if chunk:
                    buf += chunk
                return len(buf) >= n

            if not ensure(len(_MAGIC) + 1 + 8):
                return
            if bytes(buf[:len(_MAGIC)]) != _MAGIC:
                raise IOError(f"bad temp shard header in {self.path}")
            off = len(_MAGIC)
            tag = buf[off]
            off += 1
            (num_rids,) = _U64.unpack_from(buf, off)
            off += 8
            if tag == 0:
                return
            decode = RECORD_CODECS[tag][1]
            for rid in range(num_rids):
                ensure(8)
                (count,) = _U64.unpack_from(buf, off)
                off += 8
                for _ in range(count):
                    ensure(_MAX_RECORD_BYTES)
                    m, off = decode(memoryview(buf), off)
                    yield rid, m


# packed layouts of _PE_S ("<IQIHBBBBHHB") / _SE_S ("<IQIHBBBBB")
# (records.py) as numpy dtypes so whole spill chunks pack without
# per-record struct calls
PE_SPILL_DT = np.dtype({
    "names": ["read_id", "barcode", "start", "length", "mapq", "dir",
              "uniq", "dups", "posalen", "negalen", "hasbc"],
    "formats": ["<u4", "<u8", "<u4", "<u2", "u1", "u1", "u1", "u1",
                "<u2", "<u2", "u1"],
    "offsets": [0, 4, 12, 16, 18, 19, 20, 21, 22, 24, 26],
    "itemsize": 27})
SE_SPILL_DT = np.dtype({
    "names": ["read_id", "barcode", "start", "length", "mapq", "dir",
              "uniq", "dups", "hasbc"],
    "formats": ["<u4", "<u8", "<u4", "<u2", "u1", "u1", "u1", "u1", "u1"],
    "offsets": [0, 4, 12, 16, 18, 19, 20, 21, 22],
    "itemsize": 23})
# _PAIRS_S ("<IQiiIIBBBBB", records.py): a .pairs row's fixed bytes, which
# its u16-length-prefixed read name follows in a shard
PAIRS_SPILL_DT = np.dtype({
    "names": ["read_id", "barcode", "rid1", "rid2", "pos1", "pos2",
              "strand1", "strand2", "mapq", "uniq", "dups"],
    "formats": ["<u4", "<u8", "<i4", "<i4", "<u4", "<u4", "u1", "u1", "u1",
                "u1", "u1"],
    "offsets": [0, 4, 12, 16, 20, 24, 28, 29, 30, 31, 32],
    "itemsize": 33})


def _spill_base(cfg: MappingConfig, base: str) -> str:
    if base is None:
        base = cfg.mapping_output_file_path
    if base in ("/dev/stdout", "/dev/stderr"):
        base = "chromap_output"
    return base


def spill_bed_arrays(cfg: MappingConfig, chunks: List[tuple], num_refs: int,
                     shard_paths: List[str], base: str = None) -> None:
    """Vectorized spill of SE/PE BED rows collected as (rid array,
    structured record array) chunks -- the array analog of
    spill_mappings: one lexsort by (rid, sort_key) and one CTSH1 shard,
    byte-identical to the record-object path's."""
    rid = (np.concatenate([c[0] for c in chunks]) if chunks
           else np.empty(0, np.int64))
    arr = (np.concatenate([c[1] for c in chunks]) if chunks
           else np.empty(0, PE_SPILL_DT))
    path = f"{_spill_base(cfg, base)}.temp{len(shard_paths)}"
    with open(path, "wb") as f:
        if len(arr) == 0:
            # mirror TempMappingShard.write for an all-empty spill
            f.write(_MAGIC + bytes([0]) + _U64.pack(num_refs))
            f.write(_U64.pack(0) * num_refs)
            shard_paths.append(path)
            return
        se = arr.dtype.itemsize == SE_SPILL_DT.itemsize
        keys = ([] if se else [arr["negalen"], arr["posalen"]]) + \
            [arr["read_id"], arr["uniq"], arr["dir"], arr["mapq"]]
        if arr["hasbc"][0]:
            keys.append(arr["barcode"])
        keys += [arr["length"], arr["start"], rid]
        order = np.lexsort(keys)
        rid_s = rid[order]
        arr_s = np.ascontiguousarray(arr[order])
        counts = np.bincount(rid_s, minlength=num_refs)
        bounds = np.zeros(num_refs + 1, dtype=np.int64)
        np.cumsum(counts, out=bounds[1:])
        raw = arr_s.tobytes()
        isz = arr.dtype.itemsize
        f.write(_MAGIC + bytes([1 if se else 2]) + _U64.pack(num_refs))
        for r in range(num_refs):
            f.write(_U64.pack(int(counts[r])))
            if counts[r]:
                f.write(raw[bounds[r] * isz:bounds[r + 1] * isz])
    tracing.count("lowmem.spill_rows", len(arr))
    shard_paths.append(path)


def spill_pairs_arrays(cfg: MappingConfig, chunks: List[tuple],
                       num_refs: int, shard_paths: List[str],
                       base: str = None) -> None:
    """Spill of .pairs rows collected as (rid1 array, PAIRS_SPILL_DT rows,
    names blob as uint8, name starts, name lengths) chunks -- the array
    analog of spill_mappings over PairsRecords, byte-identical to it: the
    native cn_spill_pairs sorts the rows stably by (rid1,
    PairsRecord.sort_key), so full ties keep their emit order as list.sort
    does, and writes the tag-6 CTSH1 shard."""
    from ..native import _ptr, load_library

    lib = load_library()
    if lib is None:
        raise RuntimeError(".pairs array spill needs the native engine")

    def joined(parts, dtype) -> np.ndarray:
        parts = list(parts)
        return np.ascontiguousarray(
            np.concatenate(parts) if parts else np.empty(0, dtype), dtype)

    rid = joined((c[0] for c in chunks), np.int64)
    rows = joined((c[1] for c in chunks), PAIRS_SPILL_DT)
    names = joined((c[2] for c in chunks), np.uint8)
    shift = np.cumsum([0] + [len(c[2]) for c in chunks[:-1]])
    starts = joined((c[3] + s for c, s in zip(chunks, shift)), np.int64)
    lens = joined((c[4] for c in chunks), np.int64)
    if not len(rid) == len(rows) == len(starts) == len(lens) or (
            len(lens) and (starts.min() < 0 or lens.min() < 0
                           or (starts + lens).max() > len(names))):
        raise ValueError(".pairs spill rows and their names do not match")
    path = f"{_spill_base(cfg, base)}.temp{len(shard_paths)}"
    written = lib.cn_spill_pairs(path.encode(), num_refs, len(rid),
                                 _ptr(rid), _ptr(rows), _ptr(names),
                                 _ptr(starts), _ptr(lens))
    if written == -1:
        raise ValueError("a .pairs row with its rid out of range or a read "
                         "name over 65535 bytes")
    if written < 0:
        raise OSError(f"cannot write the spill file {path}")
    tracing.count("lowmem.spill_rows", len(rid))
    shard_paths.append(path)


def spill_mappings(cfg: MappingConfig, mappings_on_refs: List[List[object]],
                   shard_paths: List[str], base: str = None) -> None:
    from ..mapping.postprocess import sort_mappings

    sort_mappings(mappings_on_refs)
    path = f"{_spill_base(cfg, base)}.temp{len(shard_paths)}"
    TempMappingShard.write(path, mappings_on_refs)
    tracing.count("lowmem.spill_rows", sum(map(len, mappings_on_refs)))
    shard_paths.append(path)
    for lst in mappings_on_refs:
        lst.clear()


def _find_best_dup(whitelist, dups: List[object]) -> object:
    """FindBestMappingIndexFromDuplicates (mapping_writer.h:128-165):
    highest num_dups, ties by barcode abundance."""
    best = 0
    best_abundance = (whitelist.table.get(getattr(dups[0], "barcode", 0), 0)
                      if whitelist is not None else 0)
    for i in range(1, len(dups)):
        abundance = (whitelist.table.get(getattr(dups[i], "barcode", 0), 0)
                     if whitelist is not None else 0)
        if (dups[i].num_dups > dups[best].num_dups
                or (dups[i].num_dups == dups[best].num_dups
                    and abundance > best_abundance)):
            best = i
            best_abundance = abundance
    return dups[best]


def merge_and_output_low_memory(cfg: MappingConfig, shard_paths: List[str],
                                writer, whitelist=None, summary=None,
                                engine=None) -> Tuple[int, int, int]:
    """Returns (num_uni, num_multi, num_passing_filters)."""
    if not shard_paths:
        return 0, 0, 0

    # BED-family and pairs shards merge natively (engine.cpp
    # cn_lowmem_merge_bed / cn_lowmem_merge_pairs, identical semantics);
    # the remaining text-record formats and barcode translation take the
    # per-record path below
    if (engine is not None
            and cfg.output_format in ("bed", "tagalign", "pairs")
            and getattr(writer, "barcode_translator", None) is None):
        tags = set()
        ok = True
        for p in shard_paths:
            try:
                with open(p, "rb") as f:
                    hdr = f.read(7)
            except OSError:
                ok = False
                break
            if len(hdr) < 7 or hdr[:6] != _MAGIC:
                ok = False
                break
            if hdr[6] != 0:
                tags.add(hdr[6])
        want_tags = {6} if cfg.output_format == "pairs" else {1, 2}
        if ok and len(tags) <= 1 and tags <= want_tags:
            try:
                if cfg.output_format == "pairs":
                    # the pairs header is already written through the
                    # Python writer; flush it so the native append lands
                    # after it
                    writer._f.flush()
                    uni, multi, passing, items = engine.lowmem_merge_pairs(
                        cfg, writer.ref_names, shard_paths, whitelist,
                        summary is not None)
                else:
                    uni, multi, passing, items = engine.lowmem_merge_bed(
                        cfg, writer.ref_names, shard_paths,
                        writer.cell_barcode_length, whitelist,
                        summary is not None)
            except Exception as exc:
                import sys
                print(f"chromap-tpu: native low-mem merge failed "
                      f"({exc}); using the per-record merge",
                      file=sys.stderr)
            else:
                if summary is not None:
                    for key, mapped, dup, lowmapq in items:
                        summary.update_count(key, MAPPED, mapped)
                        if dup:
                            summary.update_count(key, DUP, dup)
                        if lowmapq:
                            summary.update_count(key, LOWMAPQ, lowmapq)
                for p in shard_paths:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                shard_paths.clear()
                return uni, multi, passing

    tracing.count("lowmem.merge_per_record")
    # per-shard read-buffer size under the reference's merge memory budget
    # (mapping_writer.h:179-184: 10 GiB, 1 GiB for text-record formats)
    budget = (_MERGE_BUDGET_TEXT
              if cfg.output_format in ("sam", "pairs", "paf")
              else _MERGE_BUDGET)
    read_block = min(1 << 22, max(2 * _MAX_RECORD_BYTES,
                                  budget // max(1, len(shard_paths))))
    shards = [TempMappingShard(p, read_block) for p in shard_paths]

    def keyed(shard_index: int):
        for rid, m in shards[shard_index].iterate():
            yield (rid, m.sort_key(), shard_index, m)

    merged = heapq.merge(*[keyed(i) for i in range(len(shards))])

    dedup_bulk = (cfg.remove_pcr_duplicates and not cfg.is_bulk_data
                  and cfg.remove_pcr_duplicates_at_bulk_level)

    last_rid = -1
    last_mapping: Optional[object] = None
    num_last_dups = 0
    num_uni = 0
    num_multi = 0
    num_passing = 0
    bulk_dups: List[object] = []

    def flush_last():
        nonlocal last_mapping, num_uni, num_multi, num_passing
        if last_mapping is None:
            return
        m = last_mapping
        if dedup_bulk and bulk_dups:
            m = _find_best_dup(whitelist, bulk_dups)
            bulk_dups.clear()
        if m.mapq >= cfg.mapq_threshold:
            m.num_dups = min(255, num_last_dups)
            if cfg.tn5_shift:
                m.tn5_shift()
            writer.append_mapping(last_rid, m)
            num_passing += 1
            if summary is not None:
                summary.update_count(getattr(m, "barcode", 0), DUP,
                                     num_last_dups - 1)
        elif summary is not None:
            summary.update_count(getattr(m, "barcode", 0), LOWMAPQ,
                                 num_last_dups)
        if summary is not None:
            summary.update_count(getattr(m, "barcode", 0), MAPPED,
                                 num_last_dups)
        if m.is_unique == 1:
            num_uni += 1
        else:
            num_multi += 1

    import copy

    for (rid, _key, _si, m) in merged:
        dup_cell = (last_mapping is not None
                    and m.dup_key() == last_mapping.dup_key())
        dup_bulk = (last_mapping is not None and dedup_bulk
                    and m.same_position_key()
                    == last_mapping.same_position_key())
        is_dup = (last_rid == rid and (dup_cell or dup_bulk))
        if cfg.remove_pcr_duplicates and is_dup:
            num_last_dups += 1
            if dedup_bulk:
                if (bulk_dups
                        and m.dup_key() == bulk_dups[-1].dup_key()):
                    # the reference assigns the incoming record then does
                    # num_dups_ += 1, so the count is incoming+1 (not
                    # accumulated) -- reproduced as-is
                    rec = copy.copy(m)
                    rec.num_dups = m.num_dups + 1
                    bulk_dups[-1] = rec
                else:
                    rec = copy.copy(m)
                    rec.num_dups = 1
                    bulk_dups.append(rec)
            if m.mapq > last_mapping.mapq:
                last_mapping = copy.copy(m)
        else:
            flush_last()
            last_mapping = copy.copy(m)
            last_rid = rid
            num_last_dups = 1
            if dedup_bulk:
                rec = copy.copy(m)
                rec.num_dups = 1
                bulk_dups.append(rec)

    flush_last()

    for p in shard_paths:
        os.remove(p)
    shard_paths.clear()
    return num_uni, num_multi, num_passing
