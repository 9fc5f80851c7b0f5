"""Mersenne Twister (mt19937) plus the libstdc++ distribution algorithms.

The reference relies on std::mt19937 with libstdc++'s
uniform_int_distribution / discrete_distribution for reservoir sampling of
tied best mappings and multi-mapping allocation. Reproducing the exact
random streams requires reimplementing those algorithms (they are
implementation-defined in C++, but fixed in libstdc++).
"""

from __future__ import annotations

from typing import List, Sequence


class MT19937:
    N = 624
    M = 397
    MATRIX_A = 0x9908B0DF
    UPPER_MASK = 0x80000000
    LOWER_MASK = 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        self.mt = [0] * self.N
        self.mti = self.N
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            self.mt[i] = (1812433253 * (self.mt[i - 1]
                                        ^ (self.mt[i - 1] >> 30)) + i) & 0xFFFFFFFF

    def _generate(self) -> None:
        for i in range(self.N):
            y = ((self.mt[i] & self.UPPER_MASK)
                 | (self.mt[(i + 1) % self.N] & self.LOWER_MASK))
            nxt = self.mt[(i + self.M) % self.N] ^ (y >> 1)
            if y & 1:
                nxt ^= self.MATRIX_A
            self.mt[i] = nxt
        self.mti = 0

    def __call__(self) -> int:
        if self.mti >= self.N:
            self._generate()
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y


def uniform_int(gen: MT19937, a: int, b: int) -> int:
    """libstdc++ uniform_int_distribution(a, b)(gen) for 32-bit urng."""
    urngrange = 0xFFFFFFFF  # max - min
    urange = b - a
    if urngrange > urange:
        uerngrange = urange + 1
        scaling = urngrange // uerngrange
        past = uerngrange * scaling
        while True:
            ret = gen()
            if ret < past:
                break
        return a + ret // scaling
    if urngrange == urange:
        return a + gen()
    raise NotImplementedError("urange > urngrange not needed for 32-bit ranges")


def generate_canonical_double(gen: MT19937) -> float:
    """libstdc++ std::generate_canonical<double, 53>(mt19937).

    b = 53 bits, R = 2^32, k = ceil(53/32) = 2 draws.
    """
    r = 4294967296.0
    ret = 0.0
    factor = 1.0
    for _ in range(2):
        ret += gen() * factor
        factor *= r
    ret /= factor
    if ret >= 1.0:
        ret = 0.9999999999999999  # nextafter(1,0); unreachable in practice
    return ret


def discrete_distribution(gen: MT19937, weights: Sequence[float]) -> int:
    """libstdc++ discrete_distribution(weights)(gen).

    Draws p in [0,1) via generate_canonical * sum, then finds the bucket by
    cumulative sums (upper_bound on the CDF).
    """
    total = float(sum(weights))
    probs = [w / total for w in weights]
    # libstdc++ stores cumulative probabilities and does upper_bound
    cp: List[float] = []
    acc = 0.0
    for p in probs:
        acc += p
        cp.append(acc)
    p = generate_canonical_double(gen)
    # upper_bound over cp[:-1] semantics: find first cum > p
    lo, hi = 0, len(cp) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if cp[mid] > p:
            hi = mid
        else:
            lo = mid + 1
    return lo
