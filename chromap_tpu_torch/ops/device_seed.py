"""Device-resident seeding + verification in PyTorch: the counterpart of
chromap_tpu/ops/device_seed.py.

One call of the step takes a batch of 2-bit-packed reads and produces,
on the device, what the native finish stage needs per read:

  minimizers   kernel A (ops/dense_minimizer.py): canonical k-mer hashes
               and closed-form window-minimizer emission over the (L, B)
               code plane
  index probe  lower_bound of every minimizer hash in the sorted key
               array by one merged u64 sort (`_probe_merge_sort`), or
               searchsorted when the hash is too wide to pack (k > 22 at
               large batches) or CHROMAP_TPU_PROBE=sortss forces it; with
               CHROMAP_TPU_PROBE=bucket, a binary search bounded by a
               bucket table over the top hash bits (`bucket_probe_table`)
  expansion    ragged occurrence-list gather with the uint32 candidate
               arithmetic of index.cc:491-505
  clustering   kernel C (`cluster_scan`): the exact sequential cluster
               loop (candidate_processor.cc:283-342), one read per thread
  verification kernel B (ops/myers.py): banded Myers edit distance over
               every candidate; in split mode (Hi-C) kernel D instead,
               drop-off Myers (ops/myers.py `myers_dropoff`), twice per
               candidate: the whole read and the read past a 5' gap

The stages between the kernels are torch library ops (sort, cumsum,
gather, scatter, index_add_) on flat arrays, shaped exactly like the JAX
program, so the download -- `[total, over, meta(B), cand32...]` as u32,
plus the `full` candidate stream -- is byte-equal to the JAX seeder's.
All u64/u32 words are carried in signed tensors (see ops/u64.py). Every
shape is static: nothing in the step waits for the device.

Reads the vector path cannot reproduce exactly -- hash ties inside a
window, symmetric k-mers, per-read hit/candidate-capacity overflows,
empty-first-round frequency escalation -- are flagged FLAG_FALLBACK and
re-run through the exact host path by the native finish stage; a batch
over its flat budgets comes back as `batch_over` and maps on the host.
That routing is part of the algorithm. A failing kernel or device is
not routed anywhere: it raises.

`DeviceSeeder` runs the step on one device; `MeshSeeder` splits each
batch's rows over a list of devices (`--mesh-devices`), as the JAX
package's MeshSeeder shards them over its data mesh.
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Tuple

import numpy as np
import torch

from ..parallel.sharding import make_data_mesh
from . import _build
from ._build import resolve_device
from .dense_minimizer import dense_minimizer
from .myers import myers, myers_dropoff
from .u64 import (M32, MAX64, MIN32, MIN64, UMAX64, from_numpy_u32,
                  from_numpy_u64, i32_bits, mask_bits, searchsorted_u64,
                  sort_u64, srl64, u32_of)

I32 = torch.int32
I64 = torch.int64

# read-meta flag bits (must match engine.cpp DevSeedView)
FLAG_FALLBACK = 1  # exact host path required for this read's pair
FLAG_AUGMENT = 2   # no candidate supported by >= half the minimizers

# capacities, as in the JAX program: per-read hit/candidate caps bound the
# dense cluster stage (overflow -> exact host path per pair); the flat caps
# are per-batch-read averages (overflow -> whole batch to the host engine)
HCAP = 128          # per-read hits (both strands)
CCAP = 16           # per-read candidates per strand
MZ_PER_READ = 26    # flat minimizer budget per read
HITS_PER_READ = 30  # flat hit budget per read
CANDS_PER_READ = 2  # flat candidate budget per read
# candidates per read carried in the single download; the rest of a
# larger total is read from the second (`full`) array
DL_CANDS_PER_READ = 2


# ---------------------------------------------------------------------
# kernel C: the cluster scan
# ---------------------------------------------------------------------

def cluster_scan_plain(words_ext: torch.Tensor, mm_count: torch.Tensor,
                       num_required: torch.Tensor, e: int):
    """`_cluster_scan_W` in plain torch ops, on any device. words_ext:
    (H+1, B) u64-in-int64 sorted hit words, slot-major. Returns (emit
    (H, B) bool, cand (H, B) int64)."""
    H1, B = words_ext.shape
    mm = mm_count.to(I32)
    req = num_required.to(I32)
    one = torch.ones(B, dtype=I32, device=words_ext.device)
    min_cnt, eq_cnt, best_eq = one, one, one
    best = prev = words_ext[0]
    emits, cands = [], []
    for i in range(1, H1):
        cur = words_ext[i]
        cur_lo = cur & M32
        boundary = ((srl64(cur, 32) != srl64(prev, 32))
                    | (cur_lo > ((prev & M32) + e) & M32)
                    | ((min_cnt >= mm) & (cur_lo > ((best & M32) + e) & M32)))
        emits.append(boundary & (min_cnt >= req) & (best != UMAX64))
        cands.append((best & mask_bits(47))
                     | ((best_eq & 0xFF).to(I64) << 47))
        # non-boundary update (candidate_processor.cc:311-331)
        is_best = cur == best
        is_prev = cur == prev
        eq_new = torch.where(is_best | is_prev, eq_cnt + 1, one)
        promote = ~is_best & is_prev & (eq_new > best_eq)
        best_eq_new = torch.where(is_best, best_eq + 1,
                                  torch.where(promote, eq_new, best_eq))
        best_new = torch.where(promote, prev, best)
        min_cnt = torch.where(boundary, one, min_cnt + 1)
        eq_cnt = torch.where(boundary, one, eq_new)
        best_eq = torch.where(boundary, one, best_eq_new)
        best = torch.where(boundary, cur, best_new)
        prev = cur
    return torch.stack(emits), torch.stack(cands)


def cluster_scan(words_ext: torch.Tensor, mm_count: torch.Tensor,
                 num_required: torch.Tensor, e: int):
    """Cluster scan; kernel C (csrc/cluster_scan.cu) on CUDA, the plain
    version on the CPU."""
    H1, B = words_ext.shape
    if words_ext.device.type == "cpu":
        return cluster_scan_plain(words_ext, mm_count, num_required, e)
    if (words_ext.dtype != I64 or mm_count.dtype != I32
            or num_required.dtype != I32):
        raise ValueError("cluster_scan: int64 words and int32 counts "
                         "required")
    _build.cuda_operands("cluster_scan", words_ext, mm_count, num_required)
    emit = torch.empty((H1 - 1, B), dtype=torch.bool, device=words_ext.device)
    cand = torch.empty((H1 - 1, B), dtype=I64, device=words_ext.device)
    _build.launch("cluster_scan", words_ext, mm_count, num_required, emit,
                  cand, H1 - 1, B, e)
    cluster_scan.launches += 1
    return emit, cand


cluster_scan.launches = 0


# ---------------------------------------------------------------------
# stages between the kernels
# ---------------------------------------------------------------------

def _unpack_codes_T(packed, nmask, B: int, L: int):
    """Transposed unpack: (B, W)/(B, WN) u32 words (int64 carriers) ->
    (L, B) int32 codes with 4 at N positions (kernel A's layout)."""
    cols = torch.arange(L, device=packed.device)
    code2 = (packed.T[cols // 16] >> (2 * (cols % 16))[:, None]) & 3
    nbit = (nmask.T[cols // 32] >> (cols % 32)[:, None]) & 1
    return torch.where(nbit == 1, 4, code2).to(I32)


def _cumsum1d(x):
    """Inclusive cumsum of a 1-D vector in its own dtype (int32 sums wrap
    as in the JAX program; torch would otherwise widen to int64)."""
    return torch.cumsum(x, 0, dtype=x.dtype)


_SCAN_WIDTH = 2048


def _scan1d(x, op, fill: int):
    """Inclusive 1-D scan, op = torch.cummax or torch.cummin, through a
    (rows, 2048) tile: torch scans one long row in one block (95 ms for
    the 32.7M-word probe of a 141 Mb genome's index on an H100), while
    the tile's rows scan in parallel and a short scan of the row ends
    carries across rows. `fill` is the op's identity for the padding."""
    n = x.shape[0]
    if n <= _SCAN_WIDTH:
        return op(x, 0).values
    rows = -(-n // _SCAN_WIDTH)
    x2 = torch.cat([x, x.new_full((rows * _SCAN_WIDTH - n,), fill)])
    within = op(x2.reshape(rows, _SCAN_WIDTH), 1).values
    carry = op(within[:, -1], 0).values
    offs = torch.cat([x.new_full((1,), fill), carry[:-1]])
    comb = torch.maximum if op is torch.cummax else torch.minimum
    return comb(within, offs[:, None]).reshape(-1)[:n]


def _cummax1d(x):
    """Inclusive cummax of a 1-D int32 vector."""
    return _scan1d(x, torch.cummax, -(1 << 31))


def _cummin1d_rev_u64(x):
    """Suffix (right-to-left inclusive) unsigned cummin of a 1-D u64
    vector carried in int64 (bit 63 flipped: the signed order is then
    the unsigned one)."""
    s = (x ^ MIN64).flip(0)
    return _scan1d(s, torch.cummin, MAX64).flip(0) ^ MIN64


def _scatter_rows(values, dest, n: int, fill=0):
    """out[dest[j]] = values[j] over an (n,) vector; dest == n drops (a
    spare slot, sliced off: index_put_ has no drop mode)."""
    out = torch.full((n + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[dest] = values
    return out[:n]


def _probe_merge_sort(hash_keys, mz_h, Mtot: int, ib: int):
    """lower_bound + key-present bit for every query hash in the sorted
    key array via ONE merged u64 sort: pack hash<<(ib+1) | is_key<<ib |
    idx (idx for queries only; requires 2k + 1 + ib <= 64), sort, count
    keys by an exclusive prefix sum, and scatter each query's
    (key-prefix count | found << 31) back to its slot. Queries carry flag
    0 so they sort before equal keys (side='left'); `found` rides a
    suffix cummin of the key hashes. Invalid (UMAX64) queries shift to
    all-ones top bits and sort last (the unsigned sort of ops/u64.py);
    the caller masks their loc and found bit."""
    dev = mz_h.device
    shift_p = ib + 1
    packed_q = (mz_h << shift_p) | torch.arange(Mtot, device=dev, dtype=I64)
    packed_k = (hash_keys << shift_p) | (1 << ib)
    s = sort_u64(torch.cat([packed_q, packed_k]))
    is_key = (srl64(s, ib) & 1).to(I32)
    pk = _cumsum1d(is_key) - is_key                # keys strictly before
    hash_only = srl64(s, shift_p)
    next_key_hash = _cummin1d_rev_u64(
        torch.where(is_key == 1, hash_only, UMAX64))
    found = (next_key_hash == hash_only).to(I32)
    qidx = torch.where(is_key == 0, s & mask_bits(ib), Mtot)
    return _scatter_rows(pk | (found << 31), qidx, Mtot)


def bucket_probe_table(keys: np.ndarray, k: int):
    """The bucketed probe's table over sorted u64 `keys` (nk > 0), as the
    JAX seeder builds it: bucket b of the top `tbits` bits of the 2k-bit
    hash holds keys table[b]..table[b + 1] - 1. Returns (table int32
    (2^tbits + 1,), shift = 2k - tbits, depth = the halvings that bound
    a search inside the largest bucket)."""
    nk = len(keys)
    tbits = min(22, max(10, int(np.ceil(np.log2(nk))) + 2))
    # the search compares only the low `shift` bits via a u32 key copy,
    # so the bucket must pin the rest: tbits >= 2k - 32
    tbits = max(tbits, 2 * k - 32)
    shift = max(0, 2 * k - tbits)
    nb = 1 << tbits
    bounds = np.arange(nb + 1, dtype=np.uint64) << np.uint64(shift)
    table = np.searchsorted(keys, bounds, side="left").astype(np.int32)
    max_bucket = int(np.max(table[1:] - table[:-1]))
    depth = max(1, int(np.ceil(np.log2(max(max_bucket, 1)))) + 1)
    return table, shift, depth


def _probe_bucketed(probe_table, keys_lo, mz_h, mz_valid, shift: int,
                    depth: int):
    """lower_bound of every query hash by a binary search inside its
    bucket (the JAX seeder's bucketed probe): 2 + depth gathers of int32
    words. Hash64 output is uniform, so `depth` halvings bound every
    bucket; inside one bucket the keys share their top bits, so the
    search compares the low `shift` (<= 32) bits of `keys_lo`, the keys'
    u32 low words. Returns (loc int32 clamped to nk - 1, found)."""
    nk = keys_lo.shape[0]
    nb = probe_table.shape[0] - 1
    smask = (1 << shift) - 1 if shift < 32 else M32
    ql = mz_h & smask                                 # non-negative int64
    bk = torch.clamp(srl64(mz_h, shift), max=nb - 1)
    lo = probe_table[bk]
    hi0 = probe_table[bk + 1]
    hi = hi0
    for _ in range(depth):
        upd = lo < hi
        mid = (lo + hi) >> 1                          # nk < 2^31: no wrap
        gk = u32_of(keys_lo[torch.clamp(mid, max=nk - 1)]) & smask
        right = gk < ql
        lo = torch.where(upd & right, mid + 1, lo)
        hi = torch.where(upd & ~right, mid, hi)
    # the bucket pins the top bits, so a low-bits match at the converged
    # lower bound is an exact key match
    loc = torch.clamp(lo, max=nk - 1)
    found = ((lo < hi0) & ((u32_of(keys_lo[loc]) & smask) == ql)
             & mz_valid)
    return loc, found


def _flat_compact_T(mask_T, cap: int):
    """Transposed-layout flat compaction: mask_T is (S, B) slot-major.
    Output order: read 0's set slots in ascending slot order, then read
    1's, ...; the returned source indices address the slot-major flat
    space (slot * B + read). Returns (src int64 (cap,), total int32)."""
    S, B = mask_T.shape
    dev = mask_T.device
    within = torch.cumsum(mask_T.to(I32), 0, dtype=I32)  # per-read rank
    col_tot = within[-1]
    col_off = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                         _cumsum1d(col_tot)[:-1]])
    dest = (within + col_off[None, :] - 1).reshape(-1)
    total = col_off[-1] + col_tot[-1]
    src = torch.arange(S * B, dtype=I64, device=dev)
    fd = torch.where(mask_T.reshape(-1) & (dest < cap), dest.to(I64), cap)
    return _scatter_rows(src, fd, cap), total


def _gather_ref_windows(ref_words, ref_nwords, pstart, span: int,
                        captot: int):
    """Gather span-base reference windows from 2-bit packed words.

    ref_words: (GW,) u32 words as int32 (16 bases each); ref_nwords:
    (GN,) u32 N-bitmaps as int32 (32 bases each); pstart: (captot,) int64
    base offsets (clamped valid). Returns (captot, span) int32 codes with
    4 at N positions."""
    dev = pstart.device
    cols = torch.arange(span, device=dev)
    nw = span // 16 + 2
    rem = pstart & 15
    gidx = torch.clamp((pstart >> 4)[:, None]
                       + torch.arange(nw, device=dev)[None, :],
                       0, ref_words.shape[0] - 1)
    gw = u32_of(ref_words[gidx])                     # (captot, nw)
    lo = gw[:, :-1] >> (2 * rem)[:, None]
    hi_part = torch.where((rem == 0)[:, None], 0,
                          (gw[:, 1:] << ((32 - 2 * rem) % 32)[:, None]) & M32)
    aligned = lo | hi_part                           # (captot, nw - 1)
    code2 = (aligned[:, cols // 16] >> (2 * (cols % 16))[None, :]) & 3

    nnw = span // 32 + 2
    nrem = pstart & 31
    nidx = torch.clamp((pstart >> 5)[:, None]
                       + torch.arange(nnw, device=dev)[None, :],
                       0, ref_nwords.shape[0] - 1)
    gn = u32_of(ref_nwords[nidx])
    nlo = gn[:, :-1] >> nrem[:, None]
    nhi = torch.where((nrem == 0)[:, None], 0,
                      (gn[:, 1:] << ((32 - nrem) % 32)[:, None]) & M32)
    naligned = nlo | nhi
    nbit = (naligned[:, cols // 32] >> (cols % 32)[None, :]) & 1
    return torch.where(nbit == 1, 4, code2).to(I32)


def _gather_read_rows(packed, nmask, rows, L: int):
    """Per-candidate read codes gathered from the 2-bit packed words.

    packed: (B, W) u32 (int64 carrier); nmask: (B, WN); rows: (captot,)
    read rows. Returns (captot, L) int32 codes with 4 at N positions."""
    cols = torch.arange(L, device=packed.device)
    pw = packed[rows]
    nm = nmask[rows]
    code2 = (pw[:, cols // 16] >> (2 * (cols % 16))[None, :]) & 3
    nbit = (nm[:, cols // 32] >> (cols % 32)[None, :]) & 1
    return torch.where(nbit == 1, 4, code2).to(I32)


# ---------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------

def _pack_dropoff(err, end, rml):
    """One drop-off result in 25 bits: err (clipped to 0..127), the sign
    of end << 7, min(|end|, 511) << 8, rml (clipped to 0..255) << 17."""
    return (torch.clamp(err, 0, 127).to(I64)
            | ((end < 0).to(I64) << 7)
            | (torch.clamp(end.abs(), max=511).to(I64) << 8)
            | (torch.clamp(rml, 0, 255).to(I64) << 17))


def _build_step(k: int, w: int, e: int, f0: int, f1: int, min_seeds: int,
                num_refs: int, split: bool = False, probe=None):
    """Returns the batch step; the index/reference tensors are arguments,
    as in the JAX program. `split` verifies with drop-off Myers (Hi-C)
    instead of banded Myers. `probe` picks the index probe: None the
    merged sort (searchsorted where the hash is too wide to pack),
    "sortss" searchsorted always, (shift, depth) the bucketed search,
    which takes the `probe_table` and `keys_lo` tensors."""

    def step(rw, lengths, hash_keys, offcnt, occurrences,
             ref_words, ref_nwords, ref_lens, ref_offsets,
             probe_table=None, keys_lo=None, *,
             L: int, B: int, Mtot: int, Htot: int, captot: int):
        # rw: (B, W + WN) u32 rows as int32: W 2-bit-code words, then WN
        # N-bitmap words. The hit sort key packs row<<47 | strand<<46 |
        # rid<<32 | start with all-ones as the invalid sentinel, so rows
        # use bits 47..62; 2^15 keeps a spare bit.
        assert B <= (1 << 15), "packed hit-sort key carries 15 row bits"
        dev = rw.device
        W = (L + 15) // 16
        rw64 = u32_of(rw)
        packed = rw64[:, :W]
        nmask = rw64[:, W:]

        # ---- kernel A: minimizer front end over the (L, B) plane -------
        codes_T = _unpack_codes_T(packed, nmask, B, L)
        len_row = lengths.to(I32).reshape(1, B).contiguous()
        hlo_T, hhi_T, emit_T, mm_row, bad_row = dense_minimizer(
            codes_T, len_row, k, w, L)
        mm_count = mm_row[0]
        bad_mz = (bad_row[0] != 0) | (lengths != L)

        # ---- per-read minimizer compaction -----------------------------
        # (MZ, B) slot-major planes: slot d of lane b is the read's d-th
        # minimizer in position order. One scatter of the emitted
        # positions gives what the JAX program's MZ one-hot sums give
        # (empty slots 0); reads with more than MZ minimizers route to the
        # exact host path.
        MZ = Mtot // B
        emit_m = emit_T != 0
        rank = torch.cumsum(emit_m.to(I32), 0, dtype=I32) - 1
        lane = torch.arange(B, device=dev, dtype=I64)[None, :]
        pos_col = torch.arange(L, device=dev, dtype=I32)[:, None]
        dest = torch.where(emit_m & (rank < MZ), rank.to(I64) * B + lane,
                           MZ * B).reshape(-1)
        c_lo = u32_of(_scatter_rows(hlo_T.reshape(-1), dest, MZ * B)
                      ).reshape(MZ, B)
        c_hi = u32_of(_scatter_rows(hhi_T.reshape(-1), dest, MZ * B)
                      ).reshape(MZ, B)
        c_pos = _scatter_rows(pos_col.expand(L, B).reshape(-1), dest,
                              MZ * B).reshape(MZ, B)
        bad_mz = bad_mz | (mm_count > MZ)
        mz_valid2 = (torch.arange(MZ, device=dev, dtype=I32)[:, None]
                     < torch.clamp(mm_count, max=MZ)[None, :])
        mz_h2 = torch.where(mz_valid2,
                            c_lo | ((c_hi & 0x7FFFFFFF) << 32), UMAX64)
        # expansion metadata: row<<9 | pos<<1 | strand (row = lane)
        meta2 = (lane << 9) | (c_pos.to(I64) << 1) | (c_hi >> 31)
        mz_h = mz_h2.reshape(-1)                              # (Mtot,)
        mz_valid = mz_valid2.reshape(-1)
        mz_packmeta = meta2.reshape(-1)

        # ---- index probe -------------------------------------------------
        ib = max(1, (Mtot - 1).bit_length())
        nk = hash_keys.shape[0]
        if isinstance(probe, tuple):
            loc, found = _probe_bucketed(probe_table, keys_lo, mz_h,
                                         mz_valid, *probe)
        elif 2 * k + 1 + ib <= 64 and probe != "sortss":
            lf = _probe_merge_sort(hash_keys, mz_h, Mtot, ib)
            loc = torch.clamp(lf & 0x7FFFFFFF, max=nk - 1)
            found = ((lf & MIN32) != 0) & mz_valid
        else:
            # hash too wide to pack with the query index (k > 22 at
            # large batches), or forced: unsigned searchsorted
            loc = torch.clamp(searchsorted_u64(hash_keys, mz_h), max=nk - 1)
            found = (hash_keys[loc] == mz_h) & mz_valid
        oc = offcnt[loc.to(I64)]
        if offcnt.dtype == I32:
            # u32 offcnt tier (offsets < 2^20)
            oc = u32_of(oc)
            off = oc >> 12
        else:
            off = srl64(oc, 12)
        cnt = torch.where(found, (oc & 0xFFF).to(I32), 0)

        # round-1 frequency cap (candidate_processor.cc:24-32)
        cnt2 = cnt.reshape(MZ, B)
        cnt_eff2 = torch.where(cnt2 < f0, cnt2, 0)
        total_rd = cnt_eff2.sum(0, dtype=I32)
        # empty round 1 with a round-2 cap that would admit hits:
        # frequency escalation -> exact host path
        esc_any = ((cnt2 > 0) & (cnt2 < f1)).any(0)
        round2 = (total_rd == 0) & esc_any
        overflow_rd = total_rd > HCAP

        # ---- repetitive-seed stats (index.cc:507-523) ---------------------
        rep_mask = found.reshape(MZ, B) & (cnt2 >= f0)
        prev_incl = torch.cummax(torch.where(rep_mask, c_pos, -1), 0).values
        prev_pos = torch.cat([torch.full((1, B), -1, dtype=I32, device=dev),
                              prev_incl[:-1]])
        gap = (c_pos - prev_pos).to(I64) & M32             # as u32
        inc = torch.where(prev_pos < 0, k,
                          torch.where(gap < k + w - 1, gap, k))
        rep_len = torch.where(rep_mask, inc, 0).sum(0) & M32
        rep_count = rep_mask.sum(0, dtype=I32)
        num_required = torch.clamp(mm_count - rep_count, 1,
                                   min_seeds).to(I32)

        # ---- flat occurrence expansion (index.cc:237-349) ----------------
        # per-hit-slot owner metadata and occurrence index from
        # per-minimizer DELTAS added at segment starts and prefix-summed
        # over hit slots; int32 wrap in the deltas cancels in the
        # mod-2^32 prefix sum, as in the JAX program
        cnt_eff = cnt_eff2.reshape(-1)
        hcum = _cumsum1d(cnt_eff)
        total_hits = hcum[-1]
        hbase = hcum - cnt_eff
        slots = torch.arange(Htot, device=dev, dtype=I32)
        slot_ok = slots < torch.clamp(total_hits, max=Htot)
        meta_s = i32_bits(mz_packmeta)
        dval = i32_bits(off) - hbase
        zero1 = torch.zeros(1, dtype=I32, device=dev)
        dm = meta_s - torch.cat([zero1, meta_s[:-1]])
        dd = dval - torch.cat([zero1, dval[:-1]])
        starts = torch.clamp(hbase, max=Htot).to(I64)
        metaH = _cumsum1d(torch.zeros(Htot + 1, dtype=I32, device=dev)
                          .index_add_(0, starts, dm)[:Htot])
        dH = _cumsum1d(torch.zeros(Htot + 1, dtype=I32, device=dev)
                       .index_add_(0, starts, dd)[:Htot])
        occ_idx = torch.clamp(dH + slots, 0, occurrences.shape[0] - 1)
        occ = occurrences[occ_idx.to(I64)]
        meta_i = u32_of(metaH)
        hit_row = meta_i >> 9
        read_pos = (meta_i >> 1) & 0xFF
        m_strand = meta_i & 1

        if occurrences.dtype == I32:
            # u32 occurrence tier (genome < 2^24 bases, <= 128 sequences):
            # rid<<25 | pos<<1 | strand
            occ = u32_of(occ)
            rid = occ >> 25
            ref_pos = (occ >> 1) & 0xFFFFFF
        else:
            rid = srl64(occ, 33) & M32
            ref_pos = srl64(occ, 1) & M32
        same = (occ & 1) == m_strand
        start = torch.where(same, (ref_pos - read_pos) & M32,
                            (ref_pos + read_pos - (k - 1)) & M32)
        hit_hi = torch.where(same, rid, rid | (1 << 31))
        hit_hi = torch.where(slot_ok, hit_hi, M32)
        hit_lo = torch.where(slot_ok, start, M32)

        # ---- sort + scatter to the dense (H+1, B) cluster tile ----------
        # single-key u64 sort: row(15) | strand(1) | rid(14) | start(32)
        key1 = torch.where(
            slot_ok,
            (hit_row << 47) | ((hit_hi >> 31) << 46)
            | ((hit_hi & 0x3FFF) << 32) | hit_lo,
            UMAX64)
        skey = sort_u64(key1)
        srow_raw = srl64(skey, 47)
        s_row = torch.clamp(srow_raw, max=B - 1)
        # hits per read are contiguous after the sort; the in-read rank
        # is the slot minus the first slot of the row's sorted run
        row_change = srow_raw != torch.cat(
            [torch.full((1,), -1, dtype=I64, device=dev), srow_raw[:-1]])
        run_start = _cummax1d(torch.where(row_change, slots, -1))
        dest_in = (slots - run_start).to(I64)
        okd = slot_ok & (dest_in >= 0) & (dest_in < HCAP) & (srow_raw < B)
        flatd = torch.where(okd, dest_in * B + s_row, (HCAP + 1) * B)
        # the never-written last row is the all-ones sentinel that closes
        # each read's final cluster
        dense_w = _scatter_rows(skey, flatd, (HCAP + 1) * B,
                                fill=UMAX64).reshape(HCAP + 1, B)

        # ---- kernel C: cluster (exact sequential semantics) --------------
        cl_emit, cl_w = cluster_scan(dense_w, mm_count.contiguous(),
                                     num_required, e)
        # cl_w: start(32) | rid(14) | strand(1) | count<<47

        neg_w = srl64(cl_w, 46) & 1
        n_pos = (cl_emit & (neg_w == 0)).sum(0, dtype=I32)
        n_neg = (cl_emit & (neg_w == 1)).sum(0, dtype=I32)
        cand_over = (n_pos > CCAP) | (n_neg > CCAP)

        fallback = bad_mz | round2 | overflow_rd | cand_over
        n_pos = torch.where(fallback, 0, n_pos)
        n_neg = torch.where(fallback, 0, n_neg)

        # augment trigger (candidate_processor.cc:86-103): no candidate
        # supported by >= half the minimizers
        half = (mm_count // 2).to(I64)
        cnt_w = srl64(cl_w, 47) & 0xFF
        supported = cl_emit & (cnt_w >= half[None, :])
        augment = ~supported.any(0)

        # ---- per-read candidate compaction --------------------------------
        # emitted candidates per non-fallback read are <= 2*CCAP (the
        # cand_over gate): one scatter by in-read rank gives the JAX
        # program's 2*CCAP one-hot sums
        emit_sel = cl_emit & ~fallback[None, :]
        crank = torch.cumsum(emit_sel.to(I32), 0, dtype=I32) - 1
        cdest = torch.where(emit_sel & (crank < 2 * CCAP),
                            crank.to(I64) * B + lane,
                            2 * CCAP * B).reshape(-1)
        pre_w = _scatter_rows(cl_w.reshape(-1), cdest, 2 * CCAP * B)
        n_emit = n_pos + n_neg
        pre_valid = (torch.arange(2 * CCAP, device=dev, dtype=I32)[:, None]
                     < n_emit[None, :])
        csrc, total_cands = _flat_compact_T(pre_valid, captot)
        sel_real = torch.arange(captot, device=dev, dtype=I32) < total_cands
        sc_w = pre_w[csrc]
        sc_lo = sc_w & M32
        sc_cnt = srl64(sc_w, 47) & 0xFF
        sc_row = csrc % B

        # ---- kernel B: verification (alignment.cc:141-192) ---------------
        crid = srl64(sc_w, 32) & 0x3FFF
        cneg = srl64(sc_w, 46) & 1
        pos64 = torch.where(cneg == 1, (sc_lo - (L - 1)) & M32, sc_lo)
        rid_c = torch.clamp(crid, max=num_refs - 1)
        rl = torch.where(crid < num_refs, ref_lens[rid_c], 0)
        vvalid = (sel_real & (crid < num_refs)
                  & (pos64 >= e) & (pos64 < rl) & (pos64 + L + e < rl))
        pstart = torch.where(vvalid, ref_offsets[rid_c] + pos64 - e, 0)
        patterns = _gather_ref_windows(ref_words, ref_nwords, pstart,
                                       L + 2 * e, captot)
        tex = _gather_read_rows(packed, nmask, sc_row, L)
        negm = (cneg == 1)[:, None]
        if split:
            # split (drop-off) verification (draft_mapping_generator.cc:
            # 410-555): per candidate, the drop-off kernel from the
            # matching read end plus the unconditional 5'-gap retry.
            # Dropoff3End(p, t) == Dropoff(reverse(p), reverse(t)), and
            # reverse(neg_read) == complement(read), so negative
            # candidates take the same forward kernel over reversed
            # windows and complemented (unreversed) read codes; the retry
            # is the kernel over the planes' rows g.. (a leading-dim
            # slice: contiguous, no copy)
            patterns0_T = torch.where(negm, patterns.flip(1),
                                      patterns).T.contiguous()
            texts0_T = torch.where(negm & (tex < 4), tex ^ 3,
                                   tex).T.contiguous()
            g = 20 - e  # allow_gap_beginning
            primary = myers_dropoff(patterns0_T, texts0_T, e, L)
            retry = myers_dropoff(patterns0_T[g:], texts0_T[g:], e, L - g)
            cand2 = _pack_dropoff(*primary) | (_pack_dropoff(*retry) << 25)
            cand2 = torch.where(sel_real, cand2, 0)
            err_p = endp_p = 0
        else:
            tex_rev = tex.flip(1)
            rc = torch.where(tex_rev < 4, tex_rev ^ 3, tex_rev)
            text_sel = torch.where(negm, rc, tex)
            err, endp = myers(patterns.T.contiguous(),
                              text_sel.T.contiguous(), e, L)
            # err clamps at e+1 (only <= e is ever consumed); endp is
            # band-relative (end - (L-1) in [0, 2e])
            err_p = torch.clamp(err, 0, e + 1).to(I64)
            endp_p = torch.clamp(endp - (L - 1), 0, 2 * e).to(I64)

        # ---- packed outputs -------------------------------------------------
        flags = (fallback.to(I64) * FLAG_FALLBACK
                 | augment.to(I64) * FLAG_AUGMENT)
        read_meta = (torch.clamp(mm_count, max=255).to(I64)
                     | (torch.clamp(rep_len, max=511) << 8)
                     | (flags << 17)
                     | (n_pos.to(I64) << 19)
                     | (n_neg.to(I64) << 24))
        cand = (sc_lo | (crid << 32) | (sc_cnt << 46) | (err_p << 54)
                | (endp_p << 59))
        cand = torch.where(sel_real, cand, 0)
        batch_over = (total_hits > Htot) | (total_cands > captot)
        # download: ONE stream [total, over, meta(B), cand32(upc*dlcap)];
        # the full candidate stream is the second array, read only for
        # chunks whose total exceeds the download cap
        dlcap = (captot * DL_CANDS_PER_READ) // CANDS_PER_READ
        header = torch.stack([total_cands.to(I32), batch_over.to(I32)])
        if split:
            # split candidates carry a second u64 (the packed drop-off
            # results); interleaved, each candidate is 4 consecutive u32s
            cand32 = torch.stack([cand, cand2], 1).view(I32).reshape(-1)
            upc = 4
        else:
            cand32 = cand.contiguous().view(I32)  # (lo, hi) u32 per word
            upc = 2
        return (torch.cat([header, i32_bits(read_meta),
                           cand32[:upc * dlcap]]), cand32)

    return step


@functools.lru_cache(maxsize=8)
def _cached_step(k, w, e, f0, f1, min_seeds, num_refs, split=False,
                 probe=None):
    return _build_step(k, w, e, f0, f1, min_seeds, num_refs, split, probe)


def unpack_download(meta32: np.ndarray, cand64: np.ndarray, L: int):
    """Unpack the device download (u32 per read, u64 per candidate) to the
    wide DevSeedView layout the C++ finish stage consumes
    (engine.cpp:1407-1455)."""
    mm = meta32 & 0xFF
    rep = (meta32 >> 8) & 0x1FF
    flags = (meta32 >> 17) & 0x3
    npos = (meta32 >> 19) & 0x1F
    nneg = (meta32 >> 24) & 0x1F
    meta_np = (mm.astype(np.uint64)
               | (rep.astype(np.uint64) << np.uint64(8))
               | (flags.astype(np.uint64) << np.uint64(24))
               | (npos.astype(np.uint64) << np.uint64(32))
               | (nneg.astype(np.uint64) << np.uint64(40)))
    pos_np = cand64 & np.uint64(0x3FFFFFFFFFFF)  # rid<<32 | start
    cnt_np = ((cand64 >> np.uint64(46)) & np.uint64(0xFF)).astype(np.uint32)
    err_np = ((cand64 >> np.uint64(54)) & np.uint64(0x1F)).astype(np.uint32)
    endp_np = np.minimum(
        ((cand64 >> np.uint64(59)) & np.uint64(0x1F)).astype(np.uint32)
        + (L - 1), 255)
    cmeta_np = (cnt_np | (err_np << 8) | (endp_np << 16)).astype(np.uint32)
    return meta_np, pos_np, cmeta_np


def _pack_reads(codes: np.ndarray):
    """(B, L) u8 codes -> (B, W+WN) u32: per row W 2-bit-code words then WN
    N-bitmap words (the cn_pack_reads upload layout). numpy reference
    implementation; the pipeline packs in C++ straight from the FASTQ
    buffers."""
    B, L = codes.shape
    W = (L + 15) // 16
    WN = (L + 31) // 32
    pad = np.zeros((B, 16 * W - L), np.uint8)
    c = np.concatenate([codes, pad], axis=1)
    c2 = (c & 3).astype(np.uint32).reshape(B, W, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    packed = (c2 << shifts).sum(axis=2, dtype=np.uint32)
    padn = np.zeros((B, 32 * WN - L), np.uint8)
    n = np.concatenate([codes >= 4, padn.astype(bool)], axis=1)
    n2 = n.astype(np.uint32).reshape(B, WN, 32)
    nshifts = np.arange(32, dtype=np.uint32)[None, None, :]
    nmask = (n2 << nshifts).sum(axis=2, dtype=np.uint32)
    return np.concatenate([packed, nmask], axis=1)


def _pack_genome(ref_codes: np.ndarray):
    """(G,) u8 codes -> ((GW,) u32 2-bit words, (GN,) u32 N-bitmaps)."""
    G = len(ref_codes)
    GW = (G + 15) // 16 + 2
    GN = (G + 31) // 32 + 2
    c = np.zeros(16 * GW, np.uint8)
    c[:G] = ref_codes & 3
    c2 = c.astype(np.uint32).reshape(GW, 16)
    words = (c2 << (2 * np.arange(16, dtype=np.uint32))[None, :]).sum(
        axis=1, dtype=np.uint32)
    n = np.zeros(32 * GN, bool)
    n[:G] = ref_codes >= 4
    n2 = n.astype(np.uint32).reshape(GN, 32)
    nwords = (n2 << np.arange(32, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32)
    return words, nwords


# ---------------------------------------------------------------------
# the seeder
# ---------------------------------------------------------------------

def index_tiers(max_offset: int, max_occ_pos: int, num_refs: int):
    """(offcnt in u32, occurrences in u32): the narrow tiers hold offsets
    < 2^20, and positions < 2^24 on <= 128 sequences. The tiers change
    only the width of the gathered words, never the result."""
    return (max_offset < (1 << 20),
            num_refs <= 128 and max_occ_pos < (1 << 24))


def seeder_arrays_from_numpy(index, ref_seqs) -> dict:
    """The seeder's index/reference arrays, as numpy, from the same
    `index` (hash_keys, offsets, counts, occurrences) and `ref_seqs` the
    JAX seeder takes. Keys: hash_keys u64, offcnt u32|u64, occurrences
    u32|u64, ref_words/ref_nwords u32, ref_lens/ref_offsets int64."""
    num_refs = len(ref_seqs)
    off = np.asarray(index.offsets, dtype=np.uint64)
    cnt = np.asarray(index.counts, dtype=np.uint64)
    offcnt = (off << np.uint64(12)) | np.minimum(cnt, 0xFFF)
    occ = np.asarray(index.occurrences, dtype=np.uint64)
    occ_rid = occ >> np.uint64(33)
    occ_pos = (occ >> np.uint64(1)) & np.uint64(0xFFFFFFFF)
    off32, occ32 = index_tiers(int(off.max()) if off.size else 0,
                               int(occ_pos.max()) if occ.size else 0,
                               num_refs)
    if off32:
        offcnt = offcnt.astype(np.uint32)
    if occ32:
        occ = ((occ_rid << np.uint64(25)) | (occ_pos << np.uint64(1))
               | (occ & np.uint64(1))).astype(np.uint32)
    tbl = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        tbl[c] = i
    for i, c in enumerate(b"acgt"):
        tbl[c] = i
    ref_codes = tbl[np.frombuffer(b"".join(ref_seqs), np.uint8)]
    words, nwords = _pack_genome(ref_codes)
    lens = np.array([len(s) for s in ref_seqs], dtype=np.int64)
    offr = np.zeros(num_refs, dtype=np.int64)
    np.cumsum(lens[:-1], out=offr[1:])
    return {"hash_keys": np.asarray(index.hash_keys, dtype=np.uint64),
            "offcnt": offcnt, "occurrences": occ, "ref_words": words,
            "ref_nwords": nwords, "ref_lens": lens, "ref_offsets": offr}


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint64:
        t = from_numpy_u64(a)
    elif a.dtype == np.uint32:
        t = from_numpy_u32(a)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def check_packed_bounds(num_refs: int, max_seed_frequencies) -> None:
    """Raise when a run lies beyond the step's packed-candidate format:
    rids in 14 bits (fewer than 16384 reference sequences), occurrence
    counts saturating at 12 bits (a max seed frequency of at most 4000;
    anything >= f1 behaves identically)."""
    if num_refs >= (1 << 14):
        raise ValueError(
            f"device seeding supports < 16384 reference sequences (packed "
            f"candidate format); the reference has {num_refs}")
    f1 = int(max_seed_frequencies[1])
    if f1 > 4000:
        raise ValueError(
            f"device seeding requires max seed frequency <= 4000 (12-bit "
            f"saturating counts); -f asks for {f1}")


# the index/reference tensors, in the step's argument order
INDEX_TENSORS = ("hash_keys", "offcnt", "occurrences", "ref_words",
                 "ref_nwords", "ref_lens", "ref_offsets", "probe_table",
                 "keys_lo")


def _wait_download(dl_host, event) -> np.ndarray:
    if event is not None:
        event.synchronize()
    return dl_host.numpy().view(np.uint32)


class DeviceSeeder:
    """Holds the device-resident index/reference and runs the batch step
    on `device` ("cuda" launches the kernels; "cpu" runs their plain
    versions).

    Per-read capacities (HCAP hits, CCAP candidates/strand) route
    overflowing reads to the exact host path; the flat per-batch budgets
    (minimizers/hits/candidates) trade device memory against whole-batch
    fallback, never correctness.
    """

    def __init__(self, index, ref_seqs, error_threshold: int,
                 min_num_seeds: int, max_seed_frequencies,
                 device="cuda", split: bool = False):
        self.device = resolve_device(device)
        self.split = bool(split)
        self.k = int(index.kmer_size)
        self.w = int(index.window_size)
        self.e = int(error_threshold)
        self.f0 = int(max_seed_frequencies[0])
        self.f1 = int(max_seed_frequencies[1])
        self.min_num_seeds = int(min_num_seeds)
        self.num_refs = len(ref_seqs)
        check_packed_bounds(self.num_refs, max_seed_frequencies)
        if not 0 <= self.e <= 15:
            raise ValueError("device verification holds the band in 32 "
                             "bits: error threshold must be < 16")
        arrays = seeder_arrays_from_numpy(index, ref_seqs)
        for name, arr in arrays.items():
            setattr(self, name, _to_tensor(arr, self.device))
        # the index probe, read from CHROMAP_TPU_PROBE when the seeder is
        # built: the merged sort by default; "bucket" builds the bucket
        # table and the keys' u32 low words; "sortss" forces searchsorted
        keys = arrays["hash_keys"]
        mode = os.environ.get("CHROMAP_TPU_PROBE")
        self.probe = "sortss" if mode == "sortss" else None
        self.probe_table = self.keys_lo = None
        if len(keys) > 0 and mode == "bucket":
            table, shift, depth = bucket_probe_table(keys, self.k)
            self.probe = (shift, depth)
            self.probe_table = _to_tensor(table, self.device)
            self.keys_lo = _to_tensor(
                (keys & np.uint64(M32)).astype(np.uint32), self.device)
        self._lengths_cache = {}
        # resolved chunks, of which over a flat budget (mapped on the
        # host), and their rows, of which flagged FLAG_FALLBACK
        self.stats = dict(chunks=0, over_chunks=0, rows=0, fallback_rows=0)
        self._step = _cached_step(self.k, self.w, self.e, self.f0, self.f1,
                                  self.min_num_seeds, self.num_refs,
                                  self.split, self.probe)

    def submit(self, codes: np.ndarray, lengths: np.ndarray):
        """Dispatch one batch of (B, L) u8 codes; returns an opaque
        handle for `resolve`."""
        B, L = codes.shape
        return self.submit_packed(_pack_reads(codes), B, L,
                                  lengths=lengths)

    def submit_packed(self, rw: np.ndarray, B: int, L: int,
                      lengths: np.ndarray | None = None):
        """Dispatch a prepacked (B, W+WN) u32 batch (cn_pack_reads
        layout). The upload is copied before this returns (the caller's
        pack buffers are a reused ring); on CUDA the step and the
        download are queued on the device's current stream and an event
        marks the download's end. With lengths=None all reads are length
        L."""
        rw_t = from_numpy_u32(np.asarray(rw).reshape(B, -1))
        return (self._dispatch(self.device, self._index_operands(), rw_t,
                               lengths, B, L), CANDS_PER_READ * B, L)

    def _index_operands(self):
        return tuple(getattr(self, name) for name in INDEX_TENSORS)

    def _lengths(self, dev, B: int, L: int, lengths):
        if lengths is not None:
            return torch.as_tensor(np.asarray(lengths, dtype=np.int32),
                                   device=dev)
        lend = self._lengths_cache.get((dev, B, L))
        if lend is None:
            # a blocking upload: complete before any stream reads it
            lend = torch.full((B,), L, dtype=I32).to(dev)
            self._lengths_cache[(dev, B, L)] = lend
        return lend

    def _dispatch(self, dev, index_t, rw_t, lengths, B: int, L: int,
                  stream=None):
        """Queue the step over the B rows of `rw_t` (int32 on the CPU) on
        `dev`, with the index/reference tensors `index_t` on that device.
        On CUDA every copy, launch and the event run with `dev` current
        and on `stream` (None: the device's current stream). Returns
        (download, full, B, event); on CUDA the download is a pinned host
        tensor that `event` marks complete."""
        sizes = dict(L=L, B=B, Mtot=MZ_PER_READ * B, Htot=HITS_PER_READ * B,
                     captot=CANDS_PER_READ * B)
        if dev.type != "cuda":
            dl, full = self._step(rw_t.clone(),
                                  self._lengths(dev, B, L, lengths),
                                  *index_t, **sizes)
            return dl, full, B, None
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            staged = torch.empty(rw_t.shape, dtype=I32, pin_memory=True)
            staged.copy_(rw_t)
            dl, full = self._step(staged.to(dev, non_blocking=True),
                                  self._lengths(dev, B, L, lengths),
                                  *index_t, **sizes)
            dl_host = torch.empty(dl.shape, dtype=I32, pin_memory=True)
            dl_host.copy_(dl, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return dl_host, full, B, event

    def download_bytes(self, handle) -> int:
        """Bytes of a submitted batch's download."""
        return handle[0][0].nbytes

    def resolve(self, handle
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
        """Blocks on a submitted batch. Returns (read_meta u64 (B,),
        cand_pos u64, cand_meta u32, batch_overflow) in the wide
        DevSeedView layout the C++ finish stage consumes; candidates are
        row-major (read, strand, position-order). In split mode cand_meta
        is the tuple (cand_meta, cand_split u64) for the split-aware
        finish. Safe to call from another thread than the one that
        submitted."""
        (dl_host, full, B, event), captot, L = handle
        dl_np = _wait_download(dl_host, event)
        self.stats["chunks"] += 1
        if dl_np[1]:
            # flat budget exceeded: caller maps this batch on the host
            self.stats["over_chunks"] += 1
            return None, None, None, True
        return self._unpack(dl_np[2:2 + B],
                            self._candidates(dl_np, full, B, captot), L)

    def _candidates(self, dl_np, full, B: int, captot: int) -> np.ndarray:
        """One step's candidate words as u64: from its download when the
        total fits the download cap, else from its `full` stream."""
        total = int(dl_np[0])
        upc = 4 if self.split else 2  # u32s per candidate
        if total <= (captot * DL_CANDS_PER_READ) // CANDS_PER_READ:
            return dl_np[2 + B:2 + B + upc * total].view(np.uint64)
        return full[:upc * total].cpu().numpy().view(np.uint64)

    def _unpack(self, meta32, cand64, L: int):
        self.stats["rows"] += len(meta32)
        self.stats["fallback_rows"] += int(
            np.count_nonzero((meta32 >> 17) & FLAG_FALLBACK))
        if self.split:
            # interleaved (cand, split-ext) u64 pairs
            meta_np, pos_np, cmeta_np = unpack_download(
                meta32, cand64[0::2], L)
            return (meta_np, pos_np,
                    (cmeta_np, np.ascontiguousarray(cand64[1::2])), False)
        meta_np, pos_np, cmeta_np = unpack_download(meta32, cand64, L)
        return meta_np, pos_np, cmeta_np, False

    def seed_and_verify(self, codes: np.ndarray, lengths: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
        """Synchronous submit + resolve."""
        return self.resolve(self.submit(codes, lengths))


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its index spelt out ("cuda" is the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class MeshSeeder(DeviceSeeder):
    """The seeder over a data mesh, the counterpart of the JAX
    MeshSeeder: each chunk's rows split into n contiguous ranges of
    B // n, one per entry of `devices`, and each range runs the step at
    its own size and flat budgets on its device, under its own stream,
    into its own download. `resolve` joins the ranges in order, which
    restores the chunk's read order; one range over its budget sends the
    whole chunk to the host. The index and reference tensors are held
    once per distinct device, so entries that name the same device share
    them: several entries of one card rehearse a mesh there, as JAX's
    virtual CPU devices do. One process drives every device; the
    per-range totals are read on the host."""

    def __init__(self, index, ref_seqs, error_threshold: int,
                 min_num_seeds: int, max_seed_frequencies, devices,
                 split: bool = False):
        devices = [_indexed(resolve_device(d)) for d in devices]
        if not devices:
            raise ValueError("MeshSeeder needs at least one device")
        super().__init__(index, ref_seqs, error_threshold, min_num_seeds,
                         max_seed_frequencies, device=devices[0],
                         split=split)
        self.devices = devices
        self.n_dev = len(devices)
        first = self._index_operands()
        self._replicas = {self.device: first}
        for dev in devices:
            if dev not in self._replicas:
                self._replicas[dev] = tuple(
                    None if t is None else t.to(dev) for t in first)
        self._streams = [torch.cuda.Stream(dev) if dev.type == "cuda"
                         else None for dev in devices]
        for dev in self._replicas:
            if dev.type == "cuda":
                # the replicas are whole before another stream reads them
                torch.cuda.synchronize(dev)
        # chunks whose rows did not split over the shards
        self.stats["unsharded_chunks"] = 0

    def submit_packed(self, rw: np.ndarray, B: int, L: int,
                      lengths: np.ndarray | None = None):
        """Dispatch every shard of the batch before waiting on any. A
        batch whose rows do not split evenly runs the single-device step
        on the first device, as in the JAX package."""
        n = self.n_dev
        if B % n:
            self.stats["unsharded_chunks"] += 1
            if self.stats["unsharded_chunks"] == 1:
                print(f"MeshSeeder: a chunk of {B} rows does not split "
                      f"over {n} shards; such chunks run the single-device "
                      f"step on {self.device} (the pipeline's default chunk "
                      "of 32768 rows never splits over 3)", file=sys.stderr)
            return super().submit_packed(rw, B, L, lengths=lengths)
        Bs = B // n
        rw_t = from_numpy_u32(np.asarray(rw).reshape(B, -1))
        shards = []
        for i, (dev, stream) in enumerate(zip(self.devices, self._streams)):
            rows = slice(i * Bs, (i + 1) * Bs)
            shards.append(self._dispatch(
                dev, self._replicas[dev], rw_t[rows],
                None if lengths is None else np.asarray(lengths)[rows],
                Bs, L, stream))
        return shards, CANDS_PER_READ * Bs, L

    def download_bytes(self, handle) -> int:
        if not isinstance(handle[0], list):
            return super().download_bytes(handle)
        return sum(shard[0].nbytes for shard in handle[0])

    def resolve(self, handle):
        shards, captot_s, L = handle
        if not isinstance(shards, list):
            return super().resolve(handle)
        dls = [_wait_download(dl, event) for dl, _, _, event in shards]
        self.stats["chunks"] += 1
        if any(dl[1] for dl in dls):
            self.stats["over_chunks"] += 1
            return None, None, None, True
        meta32 = np.concatenate([dl[2:2 + Bs]
                                 for dl, (_, _, Bs, _) in zip(dls, shards)])
        cand64 = np.concatenate([
            self._candidates(dl, full, Bs, captot_s)
            for dl, (_, full, Bs, _) in zip(dls, shards)])
        return self._unpack(meta32, cand64, L)


_seeder_cache: dict = {}


def get_device_seeder(index, ref_seqs, error_threshold: int,
                      min_num_seeds: int, max_seed_frequencies,
                      cache_key=None, mesh_devices: int = 0,
                      split: bool = False, device="cuda") -> DeviceSeeder:
    """Process-wide seeder cache. `cache_key` identifies the
    index/reference content (e.g. (index_path, mtime, ref_path, mtime));
    None disables caching. mesh_devices, as in the JAX package: 0 = all
    visible devices of `device`'s type (every card on CUDA, one on the
    CPU), 1 = one device, N > 1 = a MeshSeeder over make_data_mesh(N)."""
    n = mesh_devices or len(make_data_mesh(None, device))

    def build():
        if n > 1:
            return MeshSeeder(index, ref_seqs, error_threshold,
                              min_num_seeds, max_seed_frequencies,
                              make_data_mesh(n, device), split=split)
        return DeviceSeeder(index, ref_seqs, error_threshold, min_num_seeds,
                            max_seed_frequencies, device=device, split=split)

    if cache_key is None:
        return build()
    key = (cache_key, int(error_threshold), int(min_num_seeds),
           tuple(int(f) for f in max_seed_frequencies), n, split,
           str(device), os.environ.get("CHROMAP_TPU_PROBE"))
    seeder = _seeder_cache.get(key)
    if seeder is None:
        seeder = build()
        _seeder_cache.clear()  # one resident index at a time
        _seeder_cache[key] = seeder
    return seeder
