"""The bytes each hand-written kernel of the port needs for one launch,
and the card's published bandwidth: the benchmark's own copy of the bytes
half of `chip_smoke.py`'s `dense_cost`, `cluster_cost` and `dropoff_cost`
and of `chromap_tpu_torch/bench.py`'s `myers_cost` (each input byte read
once, each output byte written once; tests/test_portbench_costs.py holds
them equal to the originals).

Only bytes bound these kernels here. Their operation counts are estimates,
and the card's rate for the 32-bit integer work they do (about 16.7 T/s)
is not the 67 T/s float32 rate that the port's bench uses as its peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the 700 W limit
HBM_BYTES_PER_S = 3.35e12


def dense_minimizer_bytes(L: int, B: int) -> int:
    """Kernel A over (L, B) int32 codes: codes and lengths in; hash low,
    hash high and emit planes and two per-read words out."""
    return 4 * (L * B + B) + 4 * (3 * L * B + 2 * B)


def cluster_scan_bytes(H: int, B: int) -> int:
    """Kernel C over (H + 1, B) u64 hit words: words and two per-read
    counts in; (H, B) emit bytes and u64 candidates out."""
    return 8 * (H + 1) * B + 4 * 2 * B + H * B * (1 + 8)


def myers_bytes(L: int, N: int, e: int) -> int:
    """Kernel B over N candidates: both int32 code planes in, errors and
    end positions out."""
    return 4 * ((L + 2 * e) * N + L * N) + 4 * 2 * N


def myers_dropoff_bytes(steps: int, N: int, e: int) -> int:
    """Kernel D over N lanes that ran `steps` rows in all (a lane that
    stops at row i reads i + 1 rows of each plane, one that never stops
    L): the 2e init rows and those rows of both planes in, three words a
    lane out."""
    return 4 * (2 * e * N + 2 * steps) + 4 * 3 * N
