"""Myers bit-parallel banded edit-distance verification (host-exact path).

Semantics mirror alignment.cc:141-784: band of 2e+1 diagonals packed in a
32-bit word, early termination, end-position scan with the center-diagonal
tie preference, drop-off variants for split alignment, and the traceback
that recovers start positions (with the raw-byte Hamming fast path).

The device path lives in ops/pallas_myers.py; this module is the oracle and
the small-input fallback.
"""

from __future__ import annotations

from typing import Tuple

from .utils import _CHAR_TO_CODE

U32 = 0xFFFFFFFF
U64 = 0xFFFFFFFFFFFFFFFF


def _code(c: int) -> int:
    return _CHAR_TO_CODE[c]


def banded_align(error_threshold: int, pattern: bytes, text: bytes,
                 read_length: int) -> Tuple[int, int]:
    """Align text (read) against pattern (ref window of read_length+2e).

    Returns (min_num_errors, mapping_end_position). mapping_end_position is
    relative to the pattern start. Returns e+1 errors when dropped.
    """
    e = error_threshold
    # word width follows the band: u32 for e < 16 (reference semantics),
    # u64 for e < 32 (matches the native 64-bit-band kernels), and a
    # wide-enough Python integer beyond (the Myers recurrences are
    # word-size-agnostic as long as the word holds 2e+1 band bits)
    mask = U32 if e < 16 else (U64 if e < 32 else (1 << (2 * e + 2)) - 1)
    peq = [0, 0, 0, 0, 0]
    for i in range(2 * e):
        peq[_code(pattern[i])] |= 1 << i
    highest = 1 << (2 * e)
    vp = vn = 0
    num_errors = 0
    for i in range(read_length):
        peq[_code(pattern[i + 2 * e])] |= highest
        x = peq[_code(text[i])] | vn
        d0 = (((vp + (x & vp)) & mask) ^ vp) | x
        hn = vp & d0
        hp = (vn | ~(vp | d0)) & mask
        x = d0 >> 1
        vn = x & hp
        vp = (hn | ~(x | hp)) & mask
        num_errors += 1 - (d0 & 1)
        if num_errors > 3 * e:
            return e + 1, read_length - 1
        for ai in range(5):
            peq[ai] >>= 1
    band_start = read_length - 1
    min_errors = num_errors
    end_position = band_start
    for i in range(2 * e):
        num_errors += (vp >> i) & 1
        num_errors -= (vn >> i) & 1
        if num_errors < min_errors or (num_errors == min_errors and i + 1 == e):
            min_errors = num_errors
            end_position = band_start + 1 + i
    return min_errors, end_position


def banded_align_dropoff(error_threshold: int, pattern: bytes, text: bytes,
                         read_length: int) -> Tuple[int, int, int]:
    """Drop-off variant from the 5' end (alignment.cc:197-283).

    Returns (min_num_errors, mapping_end_position, read_mapping_length);
    mapping_end_position is negated when the alignment failed early.
    """
    e = error_threshold
    # word width follows the band: u32 for e < 16 (reference semantics),
    # u64 for e < 32 (matches the native 64-bit-band kernels), and a
    # wide-enough Python integer beyond (the Myers recurrences are
    # word-size-agnostic as long as the word holds 2e+1 band bits)
    mask = U32 if e < 16 else (U64 if e < 32 else (1 << (2 * e + 2)) - 1)
    peq = [0, 0, 0, 0, 0]
    for i in range(2 * e):
        peq[_code(pattern[i])] |= 1 << i
    highest = 1 << (2 * e)
    vp = vn = 0
    prev_vp = prev_vn = 0
    num_errors = 0
    prev_num_errors = 0
    fail_beginning = False
    i = 0
    while i < read_length:
        peq[_code(pattern[i + 2 * e])] |= highest
        x = peq[_code(text[i])] | vn
        d0 = (((vp + (x & vp)) & mask) ^ vp) | x
        hn = vp & d0
        hp = (vn | ~(vp | d0)) & mask
        x = d0 >> 1
        prev_vn, prev_vp = vn, vp
        vn = x & hp
        vp = (hn | ~(x | hp)) & mask
        prev_num_errors = num_errors
        num_errors += 1 - (d0 & 1)
        if num_errors > 2 * e:
            if i < 4 * e and i < read_length // 2:
                fail_beginning = True
            break
        for ai in range(5):
            peq[ai] >>= 1
        i += 1
    else:
        i = read_length
    if i < read_length:
        num_errors = prev_num_errors
        vn, vp = prev_vn, prev_vp
    else:
        i = read_length
    band_start = i - 1
    min_errors = num_errors
    read_mapping_length = i
    end_position = band_start
    for j in range(2 * e):
        num_errors += (vp >> j) & 1
        num_errors -= (vn >> j) & 1
        if num_errors < min_errors or (num_errors == min_errors and j + 1 == e):
            min_errors = num_errors
            end_position = band_start + 1 + j
    if fail_beginning or (read_length > 60
                          and end_position + 1 - e - min_errors < 30):
        end_position = -end_position
    return min_errors, end_position, read_mapping_length


def banded_align_dropoff_3end(error_threshold: int, pattern: bytes, text: bytes,
                              read_length: int) -> Tuple[int, int, int]:
    """Drop-off variant scanning from the 3' end (alignment.cc:285-376)."""
    e = error_threshold
    # word width follows the band: u32 for e < 16 (reference semantics),
    # u64 for e < 32 (matches the native 64-bit-band kernels), and a
    # wide-enough Python integer beyond (the Myers recurrences are
    # word-size-agnostic as long as the word holds 2e+1 band bits)
    mask = U32 if e < 16 else (U64 if e < 32 else (1 << (2 * e + 2)) - 1)
    peq = [0, 0, 0, 0, 0]
    for i in range(2 * e):
        peq[_code(pattern[read_length + 2 * e - 1 - i])] |= 1 << i
    highest = 1 << (2 * e)
    vp = vn = 0
    prev_vp = prev_vn = 0
    num_errors = 0
    prev_num_errors = 0
    fail_beginning = False
    i = 0
    while i < read_length:
        peq[_code(pattern[read_length - 1 - i])] |= highest
        x = peq[_code(text[read_length - 1 - i])] | vn
        d0 = (((vp + (x & vp)) & mask) ^ vp) | x
        hn = vp & d0
        hp = (vn | ~(vp | d0)) & mask
        x = d0 >> 1
        prev_vn, prev_vp = vn, vp
        vn = x & hp
        vp = (hn | ~(x | hp)) & mask
        prev_num_errors = num_errors
        num_errors += 1 - (d0 & 1)
        if num_errors > 2 * e:
            if i < 4 * e and i < read_length // 2:
                fail_beginning = True
            break
        for ai in range(5):
            peq[ai] >>= 1
        i += 1
    else:
        i = read_length
    if i < read_length:
        num_errors = prev_num_errors
        vn, vp = prev_vn, prev_vp
    else:
        i = read_length
    band_start = i - 1
    min_errors = num_errors
    read_mapping_length = i
    end_position = band_start
    for j in range(2 * e):
        num_errors += (vp >> j) & 1
        num_errors -= (vn >> j) & 1
        if num_errors < min_errors or (num_errors == min_errors and j + 1 == e):
            min_errors = num_errors
            end_position = band_start + 1 + j
    if fail_beginning or (read_length > 60
                          and end_position + 1 - e - min_errors < 30):
        end_position = -end_position
    return min_errors, end_position, read_mapping_length


def banded_traceback(error_threshold: int, min_num_errors: int, pattern: bytes,
                     text: bytes, read_length: int) -> int:
    """Recover the mapping start offset within [0, 2e] (alignment.cc:656-718).

    `pattern` is the reference window beginning at verification start; the
    Hamming fast path uses raw byte equality, as in the reference.
    """
    e = error_threshold
    # word width follows the band: u32 for e < 16 (reference semantics),
    # u64 for e < 32 (matches the native 64-bit-band kernels), and a
    # wide-enough Python integer beyond (the Myers recurrences are
    # word-size-agnostic as long as the word holds 2e+1 band bits)
    mask = U32 if e < 16 else (U64 if e < 32 else (1 << (2 * e + 2)) - 1)
    if min_num_errors == 0:
        return e
    error_count = 0
    for i in range(read_length):
        if pattern[i + e] != text[i]:
            error_count += 1
    if error_count == min_num_errors:
        return e
    peq = [0, 0, 0, 0, 0]
    for i in range(2 * e):
        peq[_code(pattern[read_length - 1 + 2 * e - i])] |= 1 << i
    highest = 1 << (2 * e)
    vp = vn = 0
    num_errors = 0
    for i in range(read_length):
        peq[_code(pattern[read_length - 1 - i])] |= highest
        x = peq[_code(text[read_length - 1 - i])] | vn
        d0 = (((vp + (x & vp)) & mask) ^ vp) | x
        hn = vp & d0
        hp = (vn | ~(vp | d0)) & mask
        x = d0 >> 1
        vn = x & hp
        vp = (hn | ~(x | hp)) & mask
        num_errors += 1 - (d0 & 1)
        for ai in range(5):
            peq[ai] >>= 1
    start = 2 * e
    for i in range(2 * e):
        num_errors += (vp >> i) & 1
        num_errors -= (vn >> i) & 1
        if num_errors == min_num_errors:
            start = 2 * e - (1 + i)
            if i + 1 == e:
                return start
    return start


def get_longest_match_length(pattern: bytes, text: bytes, read_length: int) -> int:
    # Note: the reference never resets `tmp` on mismatch
    # (alignment.cc:7-22); reproduced as-is for parity.
    max_match = 0
    tmp = 0
    for i in range(read_length):
        if _code(pattern[i]) == _code(text[i]):
            tmp += 1
        elif tmp > max_match:
            max_match = tmp
    return max(max_match, tmp)
