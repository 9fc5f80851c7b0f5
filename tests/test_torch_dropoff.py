"""chromap_tpu_torch/ops/myers.py drop-off Myers (the split-alignment
kernel's plain version) against the JAX package's `myers_dropoff_jnp`, the
function the split seeding step runs, over a grid of band widths and read
lengths (L on both sides of 60) and over the 5'-gap retry's row slices;
and against the per-candidate scalar kernels `banded_align_dropoff` and,
through Dropoff3End(p, t) == Dropoff(reverse(p), reverse(t)),
`banded_align_dropoff_3end`. Integer outputs: every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chromap_tpu.ops.pallas_myers import myers_dropoff_jnp
from chromap_tpu_torch.mapping.verify import (banded_align_dropoff,
                                              banded_align_dropoff_3end)
from chromap_tpu_torch.ops import myers as my

ACGT = np.frombuffer(b"ACGTN", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; torch's default of
    one thread per core in each worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(rng, n, L, e):
    """Reference windows (n, L+2e) and reads (n, L): exact and near
    copies, indels, N bases in both, unrelated reads, reads spliced at a
    ligation junction (the copy ends at a random base and unrelated
    sequence follows), a mismatch at the first base, and reads that match
    no base of their window."""
    pats = rng.integers(0, 4, (n, L + 2 * e)).astype(np.uint8)
    pats[rng.random(pats.shape) < 0.003] = 4
    texts = pats[:, e:e + L].copy()
    for i in range(n):
        kind = i % 8
        if kind == 1:
            for _ in range(rng.integers(1, e + 3)):
                texts[i, rng.integers(0, L)] = rng.integers(0, 5)
        elif kind == 2:                                  # deletion
            q = int(rng.integers(1, L - 1))
            src = pats[i, e + q + 1:e + L + 1]          # e = 0: one short
            texts[i, q:q + len(src)] = src
        elif kind == 3:                                  # insertion
            q = int(rng.integers(1, L - 1))
            texts[i, q + 1:] = pats[i, e + q:e + L - 1]
            texts[i, q] = rng.integers(0, 4)
        elif kind == 4:
            texts[i] = rng.integers(0, 4, L)
        elif kind in (5, 6):                             # junction
            q = int(rng.integers(0, L))
            texts[i, q:] = rng.integers(0, 4, L - q)
            if kind == 6:
                texts[i, rng.integers(0, L, 2)] = 4
        elif kind == 7 and i % 16 == 15:
            # every base differs from every window base: the error rises
            # each step and the lane stops at step 2e
            pats[i], texts[i] = 0, 1
        elif kind == 7:
            texts[i, 0] = (pats[i, e] + 1) % 4
    return pats, texts


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a.T, dtype=np.int32))


def _jax(pats_T, texts_T, e, L):
    return [np.asarray(x) for x in myers_dropoff_jnp(
        jnp.asarray(pats_T.numpy()), jnp.asarray(texts_T.numpy()), e, L)]


@pytest.mark.parametrize("L", [40, 61, 100, 150])
@pytest.mark.parametrize("e", [0, 1, 4, 8, 15])
def test_dropoff_plain_matches_jax(e, L):
    rng = np.random.default_rng(1000 * e + L)
    n = 400
    pats, texts = _batch(rng, n, L, e)
    pt, tt = _T(pats), _T(texts)
    got = my.myers_dropoff(pt, tt, e, L)
    assert all(x.dtype == torch.int32 and x.shape == (n,) for x in got)
    for a, b in zip(got, _jax(pt, tt, e, L)):
        np.testing.assert_array_equal(a.numpy(), b)
    rml = got[2].numpy()
    assert (rml < L).any() and (rml == L).any()
    if L > 60:
        assert (got[1].numpy() < 0).any()
    # the 5'-gap retry: the same planes past their first g rows, as the
    # split seeding step passes them (a leading-dim slice, no copy)
    g = 20 - e
    if g < L:
        rp, rt = pt[g:], tt[g:]
        assert rp.is_contiguous() and rp.data_ptr() == pt[g].data_ptr()
        got = my.myers_dropoff(rp, rt, e, L - g)
        for a, b in zip(got, _jax(rp, rt, e, L - g)):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("e,L", [(0, 40), (4, 100), (8, 61), (15, 80)])
def test_dropoff_plain_matches_scalar(e, L):
    """Each candidate against the scalar kernels of mapping/verify.py: the
    5' form directly, the 3' form over reversed operands."""
    rng = np.random.default_rng(50 + e)
    n = 64
    pats, texts = _batch(rng, n, L, e)
    err, end, rml = (x.numpy() for x in
                     my.myers_dropoff(_T(pats), _T(texts), e, L))
    rerr, rend, rrml = (x.numpy() for x in my.myers_dropoff(
        _T(pats[:, ::-1]), _T(texts[:, ::-1]), e, L))
    for i in range(n):
        p, t = ACGT[pats[i]].tobytes(), ACGT[texts[i]].tobytes()
        assert (err[i], end[i], rml[i]) == banded_align_dropoff(e, p, t, L)
        assert (rerr[i], rend[i], rrml[i]) == \
            banded_align_dropoff_3end(e, p, t, L)


def test_dropoff_stop_at_first_step():
    """e = 0 and a mismatch at base 0: the lane stops at step 0, so the
    band starts at -1 and rml is 0; for L > 60 the end is negated (to +1),
    for L <= 60 it stays -1."""
    for L, want_end in ((61, 1), (60, -1)):
        pats = np.zeros((1, L), np.uint8)
        texts = np.zeros((1, L), np.uint8)
        texts[0, 0] = 1
        err, end, rml = (int(x[0]) for x in
                         my.myers_dropoff(_T(pats), _T(texts), 0, L))
        assert (err, end, rml) == (0, want_end, 0)
        p, t = ACGT[pats[0]].tobytes(), ACGT[texts[0]].tobytes()
        assert banded_align_dropoff(0, p, t, L) == (0, want_end, 0)


def test_dropoff_wrapper_checks():
    pt = torch.zeros((20, 3), dtype=torch.int32)
    tt = torch.zeros((10, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        my.myers_dropoff(pt, tt, 16, 10)    # band wider than 32 bits
    with pytest.raises(ValueError):
        my.myers_dropoff(pt, tt, 4, 10)     # (L + 2e) rows required
    before = my.myers_dropoff.launches
    err, end, rml = my.myers_dropoff(pt, tt, 5, 10)
    assert (err == 0).all() and (rml == 10).all()
    assert my.myers_dropoff.launches == before  # the CPU runs no kernel
