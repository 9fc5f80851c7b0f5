"""Core scalar/vector utilities shared across the framework.

Semantics mirror the reference implementation's packing/hashing contracts
(chromap's src/utils.h:76-137, hit_utils.h:8-23) but are implemented
natively for numpy batch processing.
"""

from __future__ import annotations

import numpy as np

UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
U32_MASK = 0xFFFFFFFF

# Base encoding: A/a=0, C/c=1, G/g=2, T/t=3, everything else 4 (ambiguous).
_CHAR_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
                   ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _CHAR_TO_CODE[ord(_ch)] = _code

_CODE_TO_CHAR = np.frombuffer(b"ACGTNNNN", dtype=np.uint8)


def encode_sequence(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3 bases, 4 ambiguous)."""
    if isinstance(seq, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(seq, dtype=np.uint8)
    else:
        arr = seq
    return _CHAR_TO_CODE[arr]


def decode_sequence(codes: np.ndarray) -> bytes:
    return _CODE_TO_CHAR[np.minimum(codes, 7)].tobytes()


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space; ambiguous (4) maps to 3^4=7 -> 'N'.

    Matches the reference convention of complementing via XOR with 3
    (sequence_batch.h:123-134): code 4 becomes 7 which decodes to 'N'.
    """
    return (codes ^ np.uint8(3))[::-1] | (codes[::-1] >= 4) * np.uint8(4)


def reverse_complement_ascii(seq: bytes) -> bytes:
    codes = encode_sequence(seq)
    rc = np.where(codes[::-1] < 4, codes[::-1] ^ 3, 7).astype(np.uint8)
    return _CODE_TO_CHAR[rc].tobytes()


def hash64(key: int, mask: int) -> int:
    """Invertible 64-bit mix hash, applied within `mask` bits.

    Same transform family as the reference (utils.h:76-85); operates on
    Python ints for exactness.
    """
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def hash64_np(keys: np.ndarray, mask: np.uint64) -> np.ndarray:
    """Vectorized hash64 over uint64 arrays (in-place temporaries to stay
    memory-bandwidth friendly on genome-scale inputs)."""
    u = np.uint64
    with np.errstate(over="ignore"):
        k = keys.astype(np.uint64, copy=True)
        t = np.left_shift(k, u(21))
        np.subtract(t, k, out=t)
        np.subtract(t, u(1), out=t)          # (~k + (k<<21)) == (k<<21) - k - 1
        np.bitwise_and(t, mask, out=t)
        k, t = t, k
        np.right_shift(k, u(24), out=t)
        np.bitwise_xor(k, t, out=k)
        np.left_shift(k, u(3), out=t)
        np.add(t, k, out=t)
        np.left_shift(k, u(8), out=k)
        np.add(k, t, out=k)
        np.bitwise_and(k, mask, out=k)
        np.right_shift(k, u(14), out=t)
        np.bitwise_xor(k, t, out=k)
        np.left_shift(k, u(2), out=t)
        np.add(t, k, out=t)
        np.left_shift(k, u(4), out=k)
        np.add(k, t, out=k)
        np.bitwise_and(k, mask, out=k)
        np.right_shift(k, u(28), out=t)
        np.bitwise_xor(k, t, out=k)
        np.left_shift(k, u(31), out=t)
        np.add(k, t, out=k)
        np.bitwise_and(k, mask, out=k)
    return k


def generate_seed_from_codes(codes: np.ndarray, start: int, seed_length: int) -> int:
    """2-bit pack `seed_length` bases starting at `start`; N and out-of-range
    bases contribute 0 (i.e. 'A'). Mirrors utils.h:111-129."""
    seed = 0
    n = len(codes)
    for i in range(seed_length):
        p = start + i
        base = int(codes[p]) if p < n else 0
        if base >= 4:
            base = 0
        seed = ((seed << 2) | base) & 0xFFFFFFFFFFFFFFFF
    return seed


def pack_hit(sequence_index: int, position: int, strand_negative: bool) -> int:
    """hit = (seq_index << 33) | (end_position << 1) | strand."""
    return ((sequence_index << 32 | position) << 1) | (1 if strand_negative else 0)


def hit_sequence_index(hit: int) -> int:
    return hit >> 33


def hit_position(hit: int) -> int:
    return (hit >> 1) & U32_MASK


def hit_is_negative(hit: int) -> bool:
    return (hit & 1) == 1
