"""chromap_tpu_torch/ops/myers.py (kernel B's plain version) against the
JAX package's banded Myers: `myers_jnp` (the function the seeding step
runs) and the uint32 numpy reference `banded_distance_batch_numpy`, plus
the per-candidate oracle `banded_align` where the distance is within e.
Integer outputs: every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chromap_tpu.mapping.verify import banded_align
from chromap_tpu.ops.pallas_myers import (banded_distance_batch_numpy,
                                          myers_jnp)
from chromap_tpu_torch.ops import myers as my


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; torch's default of
    one thread per core in each worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(rng, n, L, e):
    """Reference windows (n, L+2e) and reads (n, L): near copies with
    substitutions and indels, exact copies, N bases, unrelated reads."""
    pats = rng.integers(0, 4, (n, L + 2 * e)).astype(np.uint8)
    pats[rng.random(pats.shape) < 0.003] = 4
    texts = pats[:, e:e + L].copy()
    for i in range(n):
        kind = i % 5
        if kind == 1:
            for _ in range(rng.integers(1, e + 3)):
                texts[i, rng.integers(0, L)] = rng.integers(0, 5)
        elif kind == 2 and L > 2 and e > 0:             # deletion
            q = int(rng.integers(1, L - 1))
            texts[i, q:] = pats[i, e + q + 1:e + L + 1]
        elif kind == 3 and L > 2:                       # insertion
            q = int(rng.integers(1, L - 1))
            texts[i, q + 1:] = pats[i, e + q:e + L - 1]
            texts[i, q] = rng.integers(0, 4)
        elif kind == 4:
            texts[i] = rng.integers(0, 4, L)
    return pats, texts


# (e, L): e = 0 is a one-cell band with no Peq init rows; L = 30 and 230
# are the shortest and longest reads the seeding step sends
@pytest.mark.parametrize("e,L", [(1, 100), (4, 100), (8, 100), (15, 100),
                                 (0, 100), (4, 30), (8, 230)],
                         ids=["1", "4", "8", "15", "0", "4-L30", "8-L230"])
def test_myers_plain_matches_jax(e, L):
    rng = np.random.default_rng(100 + e + (L != 100) * L)
    n = 640
    pats, texts = _batch(rng, n, L, e)
    pt = torch.from_numpy(np.ascontiguousarray(pats.T, dtype=np.int32))
    tt = torch.from_numpy(np.ascontiguousarray(texts.T, dtype=np.int32))
    err, endp = my.myers(pt, tt, e, L)
    assert err.dtype == torch.int32 and endp.dtype == torch.int32

    j_err, j_end = myers_jnp(jnp.asarray(pats.T.astype(np.int32)),
                             jnp.asarray(texts.T.astype(np.int32)), e, L)
    np.testing.assert_array_equal(err.numpy(), np.asarray(j_err))
    np.testing.assert_array_equal(endp.numpy(), np.asarray(j_end))

    n_err, n_end = banded_distance_batch_numpy(pats, texts, e)
    np.testing.assert_array_equal(err.numpy(), n_err)
    np.testing.assert_array_equal(endp.numpy(), n_end)
    # a fifth of the reads are exact copies; with e > 0 the edited ones
    # mostly stay within the band as well
    assert (err.numpy() <= e).sum() > (n // 4 if e else n // 8)

    # the host wrapper (numpy in, numpy out) agrees with the plain call
    h_err, h_end = my.banded_distance_batch(pats, texts, e)
    np.testing.assert_array_equal(h_err, err.numpy())
    np.testing.assert_array_equal(h_end, endp.numpy())


@pytest.mark.parametrize("e", [2, 8])
def test_myers_plain_matches_oracle(e):
    """Within the threshold, distance and end position equal the
    per-candidate reference alignment (alignment.cc:141-192)."""
    rng = np.random.default_rng(7 + e)
    n, L = 60, 48
    pats, texts = _batch(rng, n, L, e)
    err, endp = my.banded_distance_batch(pats, texts, e)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    checked = 0
    for i in range(n):
        ne, end = banded_align(e, acgt[pats[i]].tobytes(),
                               acgt[texts[i]].tobytes(), L)
        if ne <= e:
            assert (err[i], endp[i]) == (ne, end)
            checked += 1
        else:
            assert err[i] > e
    assert checked > n // 3


def test_myers_wrapper_checks():
    pt = torch.zeros((20, 3), dtype=torch.int32)
    tt = torch.zeros((10, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        my.myers(pt, tt, 16, 10)            # band wider than 32 bits
    with pytest.raises(ValueError):
        my.myers(pt, tt, 4, 10)             # (L + 2e) rows required
    before = my.myers.launches
    err, _ = my.myers(pt, tt, 5, 10)
    assert (err == 0).all()
    assert my.myers.launches == before      # the CPU runs no kernel
