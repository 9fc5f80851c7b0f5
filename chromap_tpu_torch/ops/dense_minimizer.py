"""Fused minimizer front end: the counterpart of chromap_tpu/ops/
pallas_dense.py.

`dense_minimizer(codes_T, lengths_row, k, w, L)` takes the JAX public
layout -- (L, B) int32 codes with 4 = N, (1, B) int32 read lengths -- and
returns the five outputs of `dense_minimizer_device`:

  hlo   (L, B) i32  hash bits 0..31 (-1 at invalid positions)
  hhi   (L, B) i32  hash bits 32..55 | strand << 31 (-1 at invalid)
  emit  (L, B) i32  minimizer emission mask
  mm    (1, B) i32  per-read minimizer count
  bad   (1, B) i32  per-read (window hash tie | symmetric k-mer) flag

On a CUDA tensor it launches the hand-written kernel
(csrc/dense_minimizer.cu); on a CPU tensor it runs
`dense_minimizer_plain`, the same function in plain torch ops written
after the jnp stages `_kmer_stage` / `_emission_stage`. Any k <= 28 and
any B are covered: the TPU package's `B % 1024` and `2k > 32` gates only
chose between two bit-identical forms.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .u64 import UMAX64, i32_bits, lt_u64, mask_bits

I32 = torch.int32
I64 = torch.int64


def hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    """Invertible mix within `mask` bits (utils.h:76-85) on u64 values
    carried in int64. Each shifted term is masked before the sum, so no
    intermediate leaves [0, 2^57) and int64 never overflows; the low
    bits equal the uint64 computation's."""
    key = ((~key & mask) + ((key << 21) & mask)) & mask
    key = key ^ (key >> 24)
    key = (key + ((key << 3) & mask) + ((key << 8) & mask)) & mask
    key = key ^ (key >> 14)
    key = (key + ((key << 2) & mask) + ((key << 4) & mask)) & mask
    key = key ^ (key >> 28)
    key = (key + ((key << 31) & mask)) & mask
    return key


def _down(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """Plane whose row p holds a[p - d] (`fill` in the first d rows)."""
    d = min(d, a.shape[0])
    if d == 0:
        return a
    pad = torch.full((d,) + a.shape[1:], fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[:-d]], 0)


def _up(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """Plane whose row p holds a[p + d] (`fill` in the last d rows)."""
    if d == 0:
        return a
    pad = torch.full((d,) + a.shape[1:], fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a[d:], pad], 0)


def kmer_stage_T(codes_T: torch.Tensor, k: int):
    """Per-position canonical hash/strand over an (L, B) code plane
    (minimizer_generator.cc:30-64; `_kmer_stage` transposed). Returns
    (hash u64-in-int64 with UMAX64 at invalid positions, strand bool,
    symmetric bool, run int64)."""
    L = codes_T.shape[0]
    dev = codes_T.device
    mask = mask_bits(2 * k)
    codes = codes_T.to(I64)
    valid = codes < 4
    idx = torch.arange(L, device=dev, dtype=I64)[:, None]
    last_invalid = torch.cummax(
        torch.where(valid, torch.full_like(codes, -1), idx.expand_as(codes)),
        0).values
    run = idx - last_invalid

    b = torch.where(valid, codes, 0)
    brc = torch.where(valid, codes ^ 3, 3)
    fwd = torch.zeros_like(codes)
    rc = torch.zeros_like(codes)
    for i in range(k):                      # base p - i
        fwd = fwd | (_down(b, i, 0) << (2 * i))
        rc = rc | (_down(brc, i, 0) << (2 * (k - 1 - i)))

    ok = run >= k
    hf = hash64(fwd, mask)
    hr = hash64(rc, mask)
    strand = hf >= hr                       # both < 2^56: signed == unsigned
    symmetric = ok & (fwd == rc)
    h = hash64(torch.where(strand, hr, hf), mask)
    h = torch.where(ok & ~symmetric, h, UMAX64)
    return h, strand, symmetric, run


def emission_stage_T(h: torch.Tensor, run: torch.Tensor,
                     lengths: torch.Tensor, k: int, w: int):
    """Closed-form minimizer emission over (L, B) planes (see
    ops/minimizer_vector.py for the derivation; `_emission_stage`
    transposed). Returns (emit bool, tie bool)."""
    L, B = h.shape
    dev = h.device
    idx = torch.arange(L, device=dev, dtype=I64)[:, None]
    INF = L + w + 1
    finite = h != UMAX64
    seg_end = (lengths.to(I64) - 1)[None, :]

    r_off = torch.full((L, B), INF, dtype=I64, device=dev)
    l_off = torch.full((L, B), INF, dtype=I64, device=dev)
    tie = torch.zeros((L, B), dtype=torch.bool, device=dev)
    for d in range(1, min(w, L - 1) + 1):
        hs = _up(h, d, UMAX64)
        lt = lt_u64(hs, h)
        eq = (hs == h) & _up(finite, d, False)
        tie = tie | eq | _down(eq, d, False)
        r_off = torch.minimum(r_off, torch.where(lt, d, INF))
        if d <= w - 1:
            lt_l = lt_u64(_down(h, d, UMAX64), h)
            l_off = torch.minimum(l_off, torch.where(lt_l, d, INF))

    a = torch.where(l_off >= INF, idx, idx - l_off + w)
    r_time = idx + r_off
    has_r = r_off <= w
    run_pad = torch.cat([run, torch.zeros((w + 1, B), dtype=run.dtype,
                                          device=dev)], 0)
    run_at_r = torch.gather(run_pad, 0, torch.clamp(r_time, max=L + w))
    disp = has_r & (a <= r_time - 1) & (run_at_r >= w + k)
    exit_time = (idx + w).expand(L, B)
    run_at_exit = torch.gather(run_pad, 0, exit_time)
    can_exit = ~has_r & (exit_time <= seg_end)
    exit_emit = can_exit & (run_at_exit >= w + k - 1)
    flush = ~has_r & (exit_time > seg_end) & (a <= seg_end)
    emit = (disp | exit_emit | flush) & finite
    return emit, tie


def dense_minimizer_plain(codes_T: torch.Tensor, lengths_row: torch.Tensor,
                          k: int, w: int, L: int
                          ) -> Tuple[torch.Tensor, ...]:
    """The kernel's function in plain torch ops, on any device."""
    h, strand, symmetric, run = kmer_stage_T(codes_T, k)
    emit, tie = emission_stage_T(h, run, lengths_row.reshape(-1), k, w)
    inval = h == UMAX64
    hlo = i32_bits(torch.where(inval, -1, h))
    hhi = i32_bits(torch.where(inval, -1,
                               (h >> 32) | (strand.to(I64) << 31)))
    mm = emit.sum(0, dtype=I32).reshape(1, -1)
    bad = (tie | symmetric).any(0).to(I32).reshape(1, -1)
    return hlo, hhi, emit.to(I32), mm, bad


def dense_minimizer(codes_T: torch.Tensor, lengths_row: torch.Tensor,
                    k: int, w: int, L: int) -> Tuple[torch.Tensor, ...]:
    """Minimizer front end; kernel on CUDA, plain version on the CPU."""
    if not 1 <= k <= 28 or w < 1:
        raise ValueError(f"dense_minimizer: needs 1 <= k <= 28, w >= 1 "
                         f"(k={k}, w={w})")
    B = codes_T.shape[1]
    if codes_T.shape != (L, B) or lengths_row.numel() != B:
        raise ValueError("dense_minimizer: codes_T must be (L, B) and "
                         "lengths_row (1, B)")
    if codes_T.device.type == "cpu":
        return dense_minimizer_plain(codes_T, lengths_row, k, w, L)
    if codes_T.dtype != I32 or lengths_row.dtype != I32:
        raise ValueError("dense_minimizer: int32 operands required")
    _build.cuda_operands("dense_minimizer", codes_T, lengths_row)
    hlo = torch.empty((L, B), dtype=I32, device=codes_T.device)
    hhi = torch.empty_like(hlo)
    emit = torch.empty_like(hlo)
    mm = torch.empty((1, B), dtype=I32, device=codes_T.device)
    bad = torch.empty_like(mm)
    _build.launch("dense_minimizer", codes_T, lengths_row, hlo, hhi, emit,
                  mm, bad, L, B, k, w)
    dense_minimizer.launches += 1
    return hlo, hhi, emit, mm, bad


dense_minimizer.launches = 0
