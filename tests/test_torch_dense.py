"""chromap_tpu_torch/ops/dense_minimizer.py (kernel A's plain version)
against the JAX package's dense front end: the jnp stages `_kmer_stage` /
`_emission_stage` and the Pallas kernel `dense_minimizer_device` in
interpret mode, on the same seeded inputs. Every output is an integer, so
every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chromap_tpu.ops import device_seed as jds
from chromap_tpu.ops.pallas_dense import LANE_TILE, dense_minimizer_device
from chromap_tpu_torch.ops import dense_minimizer as dm

UMAX = np.uint64(0xFFFFFFFFFFFFFFFF)
W_MAX = 11                                     # widest window tested


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; torch's default of
    one thread per core in each worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _codes(rng, B, L, k, n_rate=0.01):
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < n_rate] = 4
    codes[0, :k + 2] = 4                       # leading N run
    codes[1, L - (k + 1):] = 4                 # trailing N run
    codes[2, 10:90] = 4                        # long N run
    codes[3, 5:40] = codes[3, 5]               # homopolymer: window ties
    codes[4, :] = np.tile([0, 1, 2, 3], L)[:L]
    lengths = np.full((B,), L, np.int32)
    for r in rng.integers(5, B, 40):           # short reads, N-padded
        ln = int(rng.integers(k + W_MAX, L))
        codes[r, ln:] = 4
        lengths[r] = ln
    return codes, lengths


def _port(codes, lengths, k, w):
    B, L = codes.shape
    out = dm.dense_minimizer(
        torch.from_numpy(codes.T.astype(np.int32).copy()),
        torch.from_numpy(lengths.reshape(1, B).copy()), k, w, L)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("k,w", [(17, 7), (19, 5), (23, 11)])
def test_dense_plain_matches_jax(k, w):
    rng = np.random.default_rng(11 + k)
    B, L = LANE_TILE, 100
    codes, lengths = _codes(rng, B, L, k)
    hlo, hhi, emit, mm, bad = _port(codes, lengths, k, w)

    # the jnp stages ((B, L) layout, u64 hash plane)
    h, strand, symmetric, run = jds._kmer_stage(jnp.asarray(codes), k)
    j_emit, tie = jds._emission_stage(h, run, jnp.asarray(lengths), k, w)
    h = np.asarray(h)
    finite = h != UMAX
    lo = hlo.T.view(np.uint32)
    hi = hhi.T.view(np.uint32)
    got_h = (lo.astype(np.uint64)
             | ((hi & np.uint32(0x7FFFFFFF)).astype(np.uint64)
                << np.uint64(32)))
    np.testing.assert_array_equal(got_h[finite], h[finite])
    np.testing.assert_array_equal((hi >> 31)[finite],
                                  np.asarray(strand)[finite])
    assert (lo[~finite] == 0xFFFFFFFF).all()
    assert (hi[~finite] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(emit.T != 0, np.asarray(j_emit))
    np.testing.assert_array_equal(mm[0], np.asarray(j_emit).sum(axis=1))
    np.testing.assert_array_equal(
        bad[0] != 0, np.asarray((tie | symmetric).any(axis=1)))
    assert bad[0, 3] == 1 and mm.sum() > 0

    # the Pallas kernel in interpret mode: all five planes, bit for bit
    p = dense_minimizer_device(jnp.asarray(codes.T.astype(np.int32)),
                               jnp.asarray(lengths.reshape(1, B)), k, w, L,
                               interpret=True)
    for name, a, b in zip(("hlo", "hhi", "emit", "mm", "bad"),
                          (hlo, hhi, emit, mm, bad), p):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("k,w", [(15, 10), (16, 5), (28, 3)])
def test_dense_plain_other_k(k, w):
    """k <= 16 (hash within one 32-bit word), even k (symmetric k-mers)
    and the widest k: the port covers every k <= 28 in one form."""
    rng = np.random.default_rng(k * 31 + w)
    B, L = 256, 64
    codes, lengths = _codes(rng, B, L, k, n_rate=0.02)
    _assert_matches_jnp_stages(codes, lengths, k, w)


@pytest.mark.parametrize("L,k,w", [(30, 17, 7), (30, 12, 4), (230, 17, 7),
                                   (230, 23, 11)])
def test_dense_plain_at_path_extremes(L, k, w):
    """The shortest and longest reads the seeding step sends to the card
    (30 <= L <= 230), at which kernel A sizes its shared-memory tile."""
    rng = np.random.default_rng(L * 7 + k)
    codes, lengths = _codes(rng, 128, L, k, n_rate=0.02)
    _assert_matches_jnp_stages(codes, lengths, k, w)


@pytest.mark.parametrize("L", [10, 20])
def test_dense_plain_reads_shorter_than_k(L):
    """Planes with fewer positions than k (the wrapper takes any L >= 1):
    no k-mer fits at L = 10, one window's worth at L = 20."""
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 4, (16, L)).astype(np.uint8)
    codes[0] = 4
    _assert_matches_jnp_stages(codes, np.full((16,), L, np.int32), 17, 7)


def _assert_matches_jnp_stages(codes, lengths, k, w):
    hlo, hhi, emit, mm, bad = _port(codes, lengths, k, w)
    h, strand, symmetric, run = jds._kmer_stage(jnp.asarray(codes), k)
    j_emit, tie = jds._emission_stage(h, run, jnp.asarray(lengths), k, w)
    h = np.asarray(h)
    finite = h != UMAX
    got_h = (hlo.T.view(np.uint32).astype(np.uint64)
             | ((hhi.T.view(np.uint32) & np.uint32(0x7FFFFFFF))
                .astype(np.uint64) << np.uint64(32)))
    np.testing.assert_array_equal(got_h[finite], h[finite])
    np.testing.assert_array_equal((hhi.T.view(np.uint32) >> 31)[finite],
                                  np.asarray(strand)[finite])
    np.testing.assert_array_equal(emit.T != 0, np.asarray(j_emit))
    np.testing.assert_array_equal(mm[0], np.asarray(j_emit).sum(axis=1))
    np.testing.assert_array_equal(
        bad[0] != 0, np.asarray((tie | symmetric).any(axis=1)))


def test_dense_wrapper_checks():
    codes = torch.zeros((10, 4), dtype=torch.int32)
    lengths = torch.full((1, 4), 10, dtype=torch.int32)
    with pytest.raises(ValueError):
        dm.dense_minimizer(codes, lengths, 29, 5, 10)
    with pytest.raises(ValueError):
        dm.dense_minimizer(codes, lengths, 17, 5, 12)
    before = dm.dense_minimizer.launches
    dm.dense_minimizer(codes, lengths, 5, 3, 10)
    assert dm.dense_minimizer.launches == before   # the CPU runs no kernel

