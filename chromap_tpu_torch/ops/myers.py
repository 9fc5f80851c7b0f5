"""Batched banded Myers bit-parallel edit distance: the counterpart of
chromap_tpu/ops/pallas_myers.py (`_myers_kernel`, `myers_jnp`,
`myers_dropoff_jnp`, `banded_distance_batch`,
`banded_distance_batch_numpy`).

`myers(patterns_T, texts_T, e, read_length)` takes the JAX public layout
-- (L + 2e, N) and (L, N) int32 codes, one candidate per column -- and
returns (min_err, end_pos), (N,) int32 each, exact for distance <= e. On
a CUDA tensor it launches the hand-written kernel (csrc/myers.cu); on a
CPU tensor it runs `myers_plain`, the same recurrence in torch ops.

`myers_dropoff(...)`, same layout, is the split-alignment (drop-off)
form: each candidate stops at the first step whose error passes 2e and
keeps the step before. It returns (min_err, end_pos, read_mapping_length)
with end_pos negated on an early failure or a mapped length under 30
(read_length > 60). CUDA tensors launch csrc/myers_dropoff.cu; CPU
tensors run `myers_dropoff_plain`.

The band (2e + 1 <= 31 diagonals) is a uint32 word. The plain versions
carry it in int64 as a non-negative u32 value, masking after each `+`
and `~`, which reproduces the uint32 (and JAX int32) wrap exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build
from .u64 import M32

I32 = torch.int32
I64 = torch.int64


def _set_highest(peq, row, highest: int):
    return [torch.where(row == c, peq[c] | highest, peq[c])
            for c in range(5)]


def _peq_init(pat, e: int):
    """Peq words from the first 2e pattern rows: inserting at the top bit
    and shifting once per later row leaves row i's bit at position i
    (alignment.cc's direct placement)."""
    peq = [pat.new_zeros(pat.shape[1])] * 5
    for i in range(2 * e):
        peq = [p >> 1 for p in _set_highest(peq, pat[i], 1 << (2 * e))]
    return peq


def _step(peq, prow, t, vp, vn, e: int):
    """One Myers column: pattern row `prow` enters the band's top bit,
    text codes `t` select the match words, VP/VN advance. Returns (the
    Peq words shifted for the next row, d0, vp, vn)."""
    peq = _set_highest(peq, prow, 1 << (2 * e))
    x = torch.where(t == 0, peq[0],
        torch.where(t == 1, peq[1],
        torch.where(t == 2, peq[2],
        torch.where(t == 3, peq[3], peq[4]))))
    x = x | vn
    d0 = (((vp + (x & vp)) & M32) ^ vp) | x
    hn = vp & d0
    hp = vn | (~(vp | d0) & M32)
    x2 = d0 >> 1
    return ([p >> 1 for p in peq], d0, hn | (~(x2 | hp) & M32), x2 & hp)


def _band_scan(vp, vn, num_err, band_start, e: int):
    """(min_err, end_pos) over the band's 2e cells past `band_start`;
    ties prefer the diagonal (j + 1 == e)."""
    min_err, end_pos = num_err, band_start
    for j in range(2 * e):
        num_err = num_err + ((vp >> j) & 1).to(I32) - ((vn >> j) & 1).to(I32)
        better = (num_err < min_err) | ((num_err == min_err) & (j + 1 == e))
        end_pos = torch.where(better, band_start + 1 + j, end_pos)
        min_err = torch.minimum(min_err, num_err)
    return min_err, end_pos


def myers_plain(patterns_T: torch.Tensor, texts_T: torch.Tensor, e: int,
                read_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops, on any device."""
    L = read_length
    n = patterns_T.shape[1]
    dev = patterns_T.device
    pat = patterns_T.to(I64)
    txt = texts_T.to(I64)
    peq = _peq_init(pat, e)
    vp = vn = torch.zeros(n, dtype=I64, device=dev)
    num_err = torch.zeros(n, dtype=I32, device=dev)
    for i in range(L):
        peq, d0, vp, vn = _step(peq, pat[i + 2 * e], txt[i], vp, vn, e)
        num_err = num_err + 1 - (d0 & 1).to(I32)
    return _band_scan(vp, vn, num_err,
                      torch.full((n,), L - 1, dtype=I32, device=dev), e)


def myers_dropoff_plain(patterns_T: torch.Tensor, texts_T: torch.Tensor,
                        e: int, read_length: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The drop-off kernel's function in plain torch ops, on any device
    (pallas_myers.py `myers_dropoff_jnp`): a lane that violates at step i
    freezes with the state of step i - 1 by masking."""
    L = read_length
    n = patterns_T.shape[1]
    dev = patterns_T.device
    pat = patterns_T.to(I64)
    txt = texts_T.to(I64)
    peq = _peq_init(pat, e)
    vp = vn = torch.zeros(n, dtype=I64, device=dev)
    num_err = torch.zeros(n, dtype=I32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    stop_i = torch.full((n,), L, dtype=I32, device=dev)
    fail = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(L):
        peq, d0, vp_new, vn_new = _step(peq, pat[i + 2 * e], txt[i], vp, vn,
                                        e)
        num_new = num_err + 1 - (d0 & 1).to(I32)
        violate = active & (num_new > 2 * e)
        active = active & ~violate
        vp = torch.where(active, vp_new, vp)
        vn = torch.where(active, vn_new, vn)
        num_err = torch.where(active, num_new, num_err)
        stop_i = torch.where(violate, i, stop_i)
        if i < 4 * e and i < L // 2:
            fail = fail | violate
    min_err, end_pos = _band_scan(vp, vn, num_err, stop_i - 1, e)
    neg = fail | ((end_pos + 1 - e - min_err < 30) & (L > 60))
    return min_err, torch.where(neg, -end_pos, end_pos), stop_i


def _check_operands(what: str, patterns_T, texts_T, e: int, L: int) -> None:
    n = patterns_T.shape[1]
    if not 0 <= e <= 15:
        raise ValueError(f"{what}: the band needs 0 <= e <= 15 (e={e})")
    if patterns_T.shape != (L + 2 * e, n) or texts_T.shape != (L, n):
        raise ValueError(f"{what}: patterns_T must be (L+2e, N) and "
                         "texts_T (L, N)")
    if patterns_T.device.type != "cpu":
        if patterns_T.dtype != I32 or texts_T.dtype != I32:
            raise ValueError(f"{what}: int32 operands required")
        _build.cuda_operands(what, patterns_T, texts_T)


def myers_dropoff(patterns_T: torch.Tensor, texts_T: torch.Tensor, e: int,
                  read_length: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drop-off Myers batch; kernel on CUDA, plain version on the CPU.
    The 3'-end form and the gap retries are this function over reversed
    or row-sliced operands (a slice of the leading dimension stays
    contiguous)."""
    L = read_length
    _check_operands("myers_dropoff", patterns_T, texts_T, e, L)
    if patterns_T.device.type == "cpu":
        return myers_dropoff_plain(patterns_T, texts_T, e, L)
    n = patterns_T.shape[1]
    errors = torch.empty(n, dtype=I32, device=patterns_T.device)
    endpos = torch.empty_like(errors)
    rml = torch.empty_like(errors)
    _build.launch("myers_dropoff", patterns_T, texts_T, errors, endpos, rml,
                  L, n, e)
    myers_dropoff.launches += 1
    return errors, endpos, rml


myers_dropoff.launches = 0


def myers(patterns_T: torch.Tensor, texts_T: torch.Tensor, e: int,
          read_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded Myers batch; kernel on CUDA, plain version on the CPU."""
    L = read_length
    _check_operands("myers", patterns_T, texts_T, e, L)
    if patterns_T.device.type == "cpu":
        return myers_plain(patterns_T, texts_T, e, L)
    n = patterns_T.shape[1]
    errors = torch.empty(n, dtype=I32, device=patterns_T.device)
    endpos = torch.empty_like(errors)
    _build.launch("myers", patterns_T, texts_T, errors, endpos, L, n, e)
    myers.launches += 1
    return errors, endpos


myers.launches = 0


def banded_distance_batch(patterns: np.ndarray, texts: np.ndarray, e: int,
                          device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper, the entry of the batch engine and of the native
    engine's `map_pairs_device`: (N, L+2e) / (N, L) code rows (uint8) ->
    (errors, ends) as numpy int32, computed on `device` -- kernel B on
    CUDA (asking for CUDA without a card raises), the plain version on the
    CPU. The rows go to the device as they are and are transposed and
    widened to the kernel's int32 (rows, N) planes there: a uint8 upload
    moves a quarter of the bytes of an int32 one. Any N: no padding."""
    n, lp = patterns.shape
    L = texts.shape[1]
    assert lp == L + 2 * e
    dev = _build.resolve_device(device)
    planes = []
    for rows in (patterns, texts):
        up = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        planes.append(torch.empty((up.shape[1], n), dtype=I32,
                                  device=dev).copy_(up.T))
    errors, endpos = myers(planes[0], planes[1], e, L)
    return errors.cpu().numpy(), endpos.cpu().numpy()


def banded_distance_batch_numpy(patterns: np.ndarray, texts: np.ndarray,
                                e: int) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized numpy implementation (uint32 exact), the JAX package's
    own: the batch engine's form below its device size rule and the
    tests' reference."""
    n, lp = patterns.shape
    L = texts.shape[1]
    U32 = np.uint32(0xFFFFFFFF)
    highest = np.uint32(1 << (2 * e))
    peq = np.zeros((5, n), dtype=np.uint32)
    for i in range(2 * e):
        row = patterns[:, i]
        for c in range(5):
            peq[c] = np.where(row == c, peq[c] | highest, peq[c])
        peq >>= np.uint32(1)
    vp = np.zeros(n, dtype=np.uint32)
    vn = np.zeros(n, dtype=np.uint32)
    num_err = np.zeros(n, dtype=np.int32)
    with np.errstate(over="ignore"):
        for i in range(L):
            row = patterns[:, i + 2 * e]
            for c in range(5):
                peq[c] = np.where(row == c, peq[c] | highest, peq[c])
            t = texts[:, i]
            x = np.select([t == c for c in range(5)],
                          [peq[c] for c in range(5)])
            x = (x | vn).astype(np.uint32)
            d0 = (((vp + (x & vp)) & U32) ^ vp) | x
            hn = vp & d0
            hp = (vn | (~(vp | d0) & U32)).astype(np.uint32)
            x2 = d0 >> np.uint32(1)
            vn = x2 & hp
            vp = (hn | (~(x2 | hp) & U32)).astype(np.uint32)
            num_err += 1 - (d0 & 1).astype(np.int32)
            peq >>= np.uint32(1)
    band_start = L - 1
    min_err = num_err.copy()
    end_pos = np.full(n, band_start, dtype=np.int32)
    for i in range(2 * e):
        num_err = (num_err + ((vp >> np.uint32(i)) & 1).astype(np.int32)
                   - ((vn >> np.uint32(i)) & 1).astype(np.int32))
        better = (num_err < min_err) | ((num_err == min_err) & (i + 1 == e))
        end_pos = np.where(better, band_start + 1 + i, end_pos)
        min_err = np.minimum(min_err, num_err)
    return min_err.astype(np.int32), end_pos.astype(np.int32)
