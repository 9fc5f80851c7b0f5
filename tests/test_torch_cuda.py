"""The CUDA kernels of chromap_tpu_torch against their plain versions on the
same CUDA tensors, and the seeder on the card against the seeder on the
CPU. A CUDA kernel has no CPU form, so every test here needs a card and is
skipped without one; on a machine with a card run

    python -m pytest tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package (the card's machine has
no JAX): the CPU side of each comparison is the port's own plain path,
which tests/test_torch_*.py hold against the JAX package."""

import numpy as np
import pytest
import torch

from chromap_tpu_torch.index.index import build_index
from chromap_tpu_torch.ops import dense_minimizer as dm
from chromap_tpu_torch.ops import device_seed as ds
from chromap_tpu_torch.ops import myers as my
from chromap_tpu_torch.ops.u64 import from_numpy_u64

pytestmark = pytest.mark.cuda

E, MIN_SEEDS, F = 8, 2, (500, 1000)
UMAX = np.uint64(0xFFFFFFFFFFFFFFFF)
B2C = np.frombuffer(b"ACGTN", np.uint8)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU form")
    return torch.device("cuda")


def _shifted(t):
    """A contiguous copy of `t` whose data starts one element past a
    16-byte boundary (a view at storage offset 1)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _codes(rng, B, L, k):
    codes = rng.integers(0, 4, (B, L)).astype(np.int32)
    codes[rng.random((B, L)) < 0.01] = 4
    codes[3, 5:40] = codes[3, 5]                       # window ties
    lengths = np.full((B,), L, np.int32)
    for r in rng.integers(4, B, 40):
        ln = int(rng.integers(k + 11, L))
        codes[r, ln:] = 4
        lengths[r] = ln
    return codes, lengths


@pytest.mark.parametrize("k,w", [(17, 7), (23, 11), (12, 4), (28, 3)])
def test_dense_kernel_equals_plain(card, k, w):
    rng = np.random.default_rng(k + w)
    B, L = 3000, 100                                   # B % 1024 != 0
    codes, lengths = _codes(rng, B, L, k)
    ct = torch.from_numpy(codes.T.copy()).to(card)
    lt = torch.from_numpy(lengths.reshape(1, B)).to(card)
    before = dm.dense_minimizer.launches
    got = dm.dense_minimizer(ct, lt, k, w, L)
    assert dm.dense_minimizer.launches == before + 1
    want = dm.dense_minimizer_plain(ct, lt, k, w, L)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,w", [(17, 7), (23, 11), (28, 3), (12, 4)])
@pytest.mark.parametrize("L", [30, 100, 230])
@pytest.mark.parametrize("B", [1, 31, 33, 3000])
def test_dense_kernel_tiles(card, B, L, k, w):
    """Kernel A's shared-memory tiles: a partial tile of reads (B % 32),
    rows that are not 16-byte aligned (B % 4), the shortest and longest
    reads the seeding step sends (L = 230 needs more than 48 KB of shared
    memory), an all-N read, a read that is N from base k on, and a
    homopolymer (hash ties in every window)."""
    rng = np.random.default_rng(B * 1000 + L + k)
    codes = rng.integers(0, 4, (B, L)).astype(np.int32)
    codes[rng.random((B, L)) < 0.01] = 4
    lengths = np.full((B,), L, np.int32)
    for r in range(B):
        kind = r % 5
        if kind == 1:
            codes[r] = 4
        elif kind == 2:
            codes[r, k:] = 4
            lengths[r] = k
        elif kind == 3:
            codes[r] = codes[r, 0] % 4
        elif kind == 4:
            ln = int(rng.integers(1, L + 1))
            codes[r, ln:] = 4
            lengths[r] = ln
    ct = torch.from_numpy(codes.T.copy()).to(card)
    lt = torch.from_numpy(lengths.reshape(1, B)).to(card)
    before = dm.dense_minimizer.launches
    got = dm.dense_minimizer(ct, lt, k, w, L)
    assert dm.dense_minimizer.launches == before + 1
    want = dm.dense_minimizer_plain(ct, lt, k, w, L)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("e", [0, 4, 15])
@pytest.mark.parametrize("L", [61, 100, 230])
@pytest.mark.parametrize("n", [1, 127, 129, 4097])
def test_dropoff_kernel_ring(card, n, L, e):
    """Kernel D's row ring: N around the 128-lane block, L + 2e rows not a
    multiple of the ring's depth, the primary pass and the retry's L - g;
    launches in which every lane stops as early as it can (at step 2e:
    step 0 for e = 0), in which no lane stops (texts = the patterns'
    diagonal), and a mix with junctions."""
    rng = np.random.default_rng(n + 10 * L + e)
    pats = rng.integers(0, 4, (L + 2 * e, n)).astype(np.int32)
    pats[rng.random(pats.shape) < 0.003] = 4
    diag = pats[e:e + L].copy()
    mixed = diag.copy()
    flip = rng.random((L, n)) < 0.03
    mixed[flip] = rng.integers(0, 5, int(flip.sum()))
    junction = rng.integers(0, L, n)
    spliced = (np.arange(L)[:, None] >= junction[None, :]) \
        & (np.arange(n) % 3 == 0)
    mixed[spliced] = rng.integers(0, 4, int(spliced.sum()))
    g = 20 - e
    for kind, p_np, t_np in (("stop", np.zeros_like(pats),
                              np.ones_like(diag)),
                             ("full", pats, diag), ("mixed", pats, mixed)):
        pt = torch.from_numpy(p_np).to(card)
        tt = torch.from_numpy(t_np).to(card)
        for p, t, ln in ((pt, tt, L), (pt[g:], tt[g:], L - g)):
            got = my.myers_dropoff(p, t, e, ln)
            want = my.myers_dropoff_plain(p, t, e, ln)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (kind, ln)
            if kind == "stop":
                assert bool((got[2] == 2 * e).all())
            if kind == "full":
                assert bool((got[2] == ln).all())


def test_kernel_occupancy_queries(card):
    """The occupancy entries that chip_smoke.py reports: kernel A's tile
    shrinks to fit shared memory and still fits at least one block."""
    from chromap_tpu_torch.ops import _build
    for L in (30, 100, 230, 5000):
        blocks, threads, smem, tile = _build.occupancy("dense_minimizer", L)
        assert blocks >= 1 and threads == 256 and 1 <= tile <= 32
    assert _build.occupancy("dense_minimizer", 100)[3] == 32
    blocks, threads, smem, stages = _build.occupancy("myers_dropoff", 100)
    assert blocks >= 1 and smem == 4 * stages * 2 * threads
    # B's and C's rings: stages of whole rows of the block's columns (both
    # planes for B; C also holds two 16-row flag buffers)
    blocks, threads, smem, stages = _build.occupancy("myers", 100)
    assert blocks >= 1 and stages >= 2 and smem % (4 * stages * 2 * threads) == 0
    blocks, threads, smem, stages = _build.occupancy("cluster_scan", 100)
    ring = smem - 2 * 16 * threads
    assert blocks >= 1 and stages >= 2 and ring % (8 * stages * threads) == 0


@pytest.mark.parametrize("e", [0, 1, 4, 8, 15])
@pytest.mark.parametrize("L", [30, 100, 150, 230])
@pytest.mark.parametrize("n", [1, 127, 129, 4097, 5000])
def test_myers_kernel_equals_plain(card, n, L, e):
    """Kernel B's block ring: N around the 128-lane block and N % 4 != 0
    (rows that are not 16-byte aligned), L + 2e rows not a multiple of a
    stage, N bases and codes outside 0..4 on both sides."""
    rng = np.random.default_rng(n + 10 * L + e)
    pats = rng.integers(0, 5, (L + 2 * e, n)).astype(np.int32)
    pats[rng.random(pats.shape) < 0.005] = -1
    texts = pats[e:e + L].copy()
    flip = rng.random((L, n)) < 0.03
    texts[flip] = rng.integers(0, 8, int(flip.sum()))
    texts[:, ::7] = rng.integers(0, 4, (L, len(range(0, n, 7))))
    pt, tt = torch.from_numpy(pats).to(card), torch.from_numpy(texts).to(card)
    before = my.myers.launches
    got = my.myers(pt, tt, e, L)
    assert my.myers.launches == before + 1
    want = my.myers_plain(pt, tt, e, L)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(my.myers(_shifted(pt), _shifted(tt), e, L), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("e,L,n", [(0, 61, 1000), (1, 100, 4097),
                                   (4, 100, 65536), (4, 84, 65536),
                                   (8, 150, 5000), (15, 60, 3001)])
def test_myers_dropoff_kernel_equals_plain(card, e, L, n):
    """Drop-off kernel against its plain version: near copies, reads that
    turn into unrelated sequence at a junction (lanes stop early), N bases
    on both sides, a mismatch at base 0, N not a multiple of the block;
    also over the row slice [g:] that the 5'-gap retry passes."""
    rng = np.random.default_rng(100 + e)
    pats = rng.integers(0, 4, (L + 2 * e, n)).astype(np.int32)
    pats[rng.random(pats.shape) < 0.003] = 4
    texts = pats[e:e + L].copy()
    flip = rng.random((L, n)) < 0.02
    texts[flip] = rng.integers(0, 5, int(flip.sum()))
    junction = rng.integers(0, L, n)
    rows = np.arange(L)[:, None]
    spliced = (rows >= junction[None, :]) & (np.arange(n) % 3 == 0)
    texts[spliced] = rng.integers(0, 4, int(spliced.sum()))
    texts[0, 1::7] = (pats[e, 1::7] + 1) % 4
    pt, tt = torch.from_numpy(pats).to(card), torch.from_numpy(texts).to(card)
    g = 20 - e
    for p, t, ln in ((pt, tt, L), (pt[g:], tt[g:], L - g)):
        before = my.myers_dropoff.launches
        got = my.myers_dropoff(p, t, e, ln)
        assert my.myers_dropoff.launches == before + 1
        want = my.myers_dropoff_plain(p, t, e, ln)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert bool((got[2] < ln).any()) and bool((got[2] == ln).any())


@pytest.mark.parametrize("e", [0, 8, 15])
@pytest.mark.parametrize("H1", [2, 17, ds.HCAP + 1])
@pytest.mark.parametrize("B", [1, 127, 129, 3001])
def test_cluster_kernel_equals_plain(card, B, H1, e):
    """Kernel C's block ring: B around the 128-read block, odd B (rows
    that are not 16-byte aligned), H + 1 not a multiple of a stage or of
    the 16-row flag flush; columns full to H, all-ones columns, starts
    near 2^32 (the u32 wrap of prev + e)."""
    rng = np.random.default_rng(20 + e + 7 * H1 + B)
    H = H1 - 1
    words = np.full((H + 1, B), UMAX, np.uint64)
    for b in range(B):
        n = (H if b % 5 == 1 else 0 if b % 5 == 2
             else int(rng.integers(0, H + 1)) if b % 9 == 0
             else int(rng.integers(0, min(40, H) + 1)))
        if n:
            start = (np.uint64(rng.choice([0, (1 << 32) - 50]))
                     + np.cumsum(rng.integers(0, 4, n)).astype(np.uint64)) \
                & np.uint64(0xFFFFFFFF)
            w = ((np.uint64(b) << np.uint64(47))
                 | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(46))
                 | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(32))
                 | start)
            words[:n, b] = np.sort(w)
    mm = torch.from_numpy(rng.integers(1, 40, B).astype(np.int32)).to(card)
    req = torch.clamp(mm - 1, 1, 2).to(torch.int32)
    wt = from_numpy_u64(words).to(card)
    before = ds.cluster_scan.launches
    got = ds.cluster_scan(wt, mm, req, e)
    assert ds.cluster_scan.launches == before + 1
    want = ds.cluster_scan_plain(wt, mm, req, e)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(ds.cluster_scan(_shifted(wt), mm, req, e), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [4096, 4097, 100003])
def test_banded_distance_batch_from_host_rows(card, n):
    """The batch engine's entry: uint8 (N, L+2e) / (N, L) host rows go to
    the card, are transposed and widened there, and kernel B's result
    equals the uint32 numpy form; one launch per call."""
    rng = np.random.default_rng(n)
    L, e = 100, 8
    pats = rng.integers(0, 4, (n, L + 2 * e)).astype(np.uint8)
    pats[rng.random(pats.shape) < 0.003] = 4
    texts = pats[:, e:e + L].copy()
    edit = rng.random((n, L)) < 0.03
    texts[edit] = rng.integers(0, 5, int(edit.sum()))
    texts[::5] = rng.integers(0, 4, (len(range(0, n, 5)), L))
    before = my.myers.launches
    got = my.banded_distance_batch(pats, texts, e)
    assert my.myers.launches == before + 1
    want = my.banded_distance_batch_numpy(pats, texts, e)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert (got[0] <= e).any() and (got[0] > e).any()


def _probe_world(case, k, wide, M, dev, rng):
    """(keys, offcnt, queries, table) on `dev` for kernel E: sorted
    distinct 2k-bit keys (one, two, a sparse index with a crowded bucket
    and both ends of the range, or uniform), offcnt words in the u32 or
    u64 tier, and queries of which a third are keys, a tenth invalid
    (UMAX64), the rest random, the first and last key among them."""
    top = 1 << (2 * k)
    if case == "one":
        keys = np.array([rng.integers(1, top - 1)], np.uint64)
    elif case == "two":
        keys = np.sort(rng.choice(top, 2, replace=False)).astype(np.uint64)
    elif case == "crowded":
        base = int(rng.integers(0, top - 1000))
        keys = np.unique(np.concatenate([
            rng.choice(top, 40, replace=False),
            base + rng.choice(1000, 60, replace=False), [0, top - 1]])
            .astype(np.uint64))
    else:
        keys = np.unique(rng.integers(0, top, 20000, dtype=np.uint64))
    nk = len(keys)
    if wide:
        words = rng.integers(0, 1 << 62, nk, dtype=np.uint64) << np.uint64(2)
        offcnt = from_numpy_u64(words | np.uint64(1 << 63))
    else:
        offcnt = torch.from_numpy(
            rng.integers(0, 1 << 32, nk, dtype=np.int64).astype(np.int32))
    q = rng.integers(0, top, M, dtype=np.uint64)
    q[: M // 3] = rng.choice(keys, M // 3)
    q[M // 3:M // 3 + 2] = keys[[0, -1]]
    q[-M // 10:] = UMAX
    table = torch.from_numpy(ds.index_probe_table(keys, k))
    return tuple(t.to(dev) for t in (from_numpy_u64(keys), offcnt,
                                     from_numpy_u64(q), table))


@pytest.mark.parametrize("wide", [False, True], ids=["u32", "u64"])
@pytest.mark.parametrize("case", ["one", "two", "crowded", "uniform"])
@pytest.mark.parametrize("k", [15, 17, 21, 23])
def test_index_probe_kernel_equals_plain(card, k, case, wide):
    """Kernel E against its plain version (the merged sort) on the same
    CUDA tensors: off, cnt and found equal, one launch."""
    rng = np.random.default_rng(100 * k + len(case) + 2 * wide)
    keys, offcnt, q, table = _probe_world(case, k, wide, 4099, card, rng)
    before = ds.index_probe.launches
    got = ds.index_probe(keys, offcnt, q, table, k)
    assert ds.index_probe.launches == before + 1
    want = ds.index_probe_plain(keys, offcnt, q, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[2].sum()) >= 4099 // 3


def test_index_probe_kernel_at_a_141mb_index(card):
    """Kernel E at the main path's shape: 31.8M uniform keys (a 141 Mb
    genome's index at k = 17), u64 offcnt, 851,968 queries (a chunk of
    32,768 reads), against the merged sort on the card."""
    k, nk, M = 17, 31_800_000, ds.MZ_PER_READ * 32768
    g = torch.Generator(device=card).manual_seed(17)
    keys = torch.unique(torch.randint(0, 1 << (2 * k), (nk + nk // 50,),
                                      device=card, generator=g))[:nk]
    offcnt = torch.randint(0, 1 << 62, (nk,), device=card, generator=g)
    table = torch.from_numpy(ds.index_probe_table(
        keys.cpu().numpy().view(np.uint64), k)).to(card)
    assert table.numel() == (1 << 22) + 1
    q = torch.randint(0, 1 << (2 * k), (M,), device=card, generator=g)
    pick = torch.rand(M, device=card, generator=g)
    q = torch.where(pick < 0.6, keys[torch.randint(0, nk, (M,), device=card,
                                                   generator=g)], q)
    q = torch.where(pick > 0.97, -1, q)
    got = ds.index_probe(keys, offcnt, q, table, k)
    want = ds.index_probe_plain(keys, offcnt, q, k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2].sum()) > M // 2


def test_wrappers_refuse_bad_operands(card):
    codes = torch.zeros((10, 8), dtype=torch.int64, device=card)
    lengths = torch.full((1, 8), 10, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        dm.dense_minimizer(codes, lengths, 5, 3, 10)
    pt = torch.zeros((8, 20), dtype=torch.int32, device=card).T
    with pytest.raises(ValueError):
        my.myers(pt, torch.zeros((4, 8), dtype=torch.int32, device=card),
                 2, 4)
    keys = torch.arange(5, dtype=torch.int64, device=card)
    offcnt = torch.zeros(5, dtype=torch.int64, device=card)
    table = torch.zeros(1025, dtype=torch.int32, device=card)
    q = torch.zeros(7, dtype=torch.int64, device=card)
    for args in ((keys, offcnt, q, None), (keys, offcnt, q.to(torch.int32),
                                           table),
                 (keys, offcnt[:4], q, table), (keys, offcnt, q, table[:-1]),
                 (keys, offcnt, q[::2], table)):
        with pytest.raises(ValueError):
            ds.index_probe(*args, 17)


@pytest.fixture(scope="module")
def small_world():
    rng = np.random.default_rng(7)
    core = rng.integers(0, 4, 12000, dtype=np.uint8)
    rep = core[500:700]
    genome = np.concatenate([core, rep, core[3000:5000], rep, rep])
    ref_codes = [genome, rng.integers(0, 4, 4000, dtype=np.uint8)]
    return (build_index(ref_codes, 17, 7), ref_codes,
            [B2C[g].tobytes() for g in ref_codes])


def _reads(ref_codes, rng, B, L):
    reads = np.empty((B, L), np.uint8)
    for i in range(B):
        g = ref_codes[i % 2]
        st = int(rng.integers(0, len(g) - L))
        r = g[st:st + L].copy()
        r[rng.integers(0, L, 3)] = rng.integers(0, 4, 3)
        if i % 13 == 0:
            r[rng.integers(0, L)] = 4
        if i % 19 == 0:
            r[10:30] = r[9]
        if i % 2:
            r = np.where(r[::-1] < 4, r[::-1] ^ 3, 4).astype(np.uint8)
        reads[i] = r
    return reads


@pytest.mark.parametrize("B,L,tiers", [(96, 80, None), (1 << 15, 48, None),
                                       (2048, 100, (False, False))])
def test_seeder_card_equals_cpu(card, small_world, monkeypatch, B, L,
                                tiers):
    index, ref_codes, ref_seqs = small_world
    if tiers is not None:
        monkeypatch.setattr(ds, "index_tiers", lambda *a: tiers)
    reads = _reads(ref_codes, np.random.default_rng(B), B, L)
    rw = ds._pack_reads(reads)
    outs, launches = [], []
    for dev in (card, "cpu"):
        seeder = ds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F,
                                 device=dev)
        before = ds.index_probe.launches
        handle = seeder.submit_packed(rw, B, L)
        res = seeder.resolve(handle)
        launches.append(ds.index_probe.launches - before)
        (dl, full, _, _), _, _ = handle
        outs.append((dl.cpu().numpy().tobytes(), full.cpu().numpy().tobytes(),
                     res))
    # the card's default probe is kernel E, the CPU's the merged sort
    assert launches == [1, 0]
    assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1]
    for a, b in zip(outs[0][2][:3], outs[1][2][:3]):
        np.testing.assert_array_equal(a, b)


def test_submit_copies_the_upload_before_it_returns(card, small_world):
    """On the card, as on the CPU (tests/test_torch_seed.py): a chunk's
    pack buffer overwritten right after `submit_packed` returns, while
    its step may still run, leaves the result equal to a fresh submit's,
    in the single-device seeder and over two shards of the card."""
    index, ref_codes, ref_seqs = small_world
    B, L = 1 << 15, 100
    rw = ds._pack_reads(_reads(ref_codes, np.random.default_rng(43), B, L))
    seeders = [ds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F,
                               device=card),
               ds.MeshSeeder(index, ref_seqs, E, MIN_SEEDS, F, [card] * 2)]
    for seeder in seeders:
        buf = rw.copy()
        handle = seeder.submit_packed(buf, B, L)
        buf[:] = np.uint32(0xFFFFFFFF)
        got = seeder.resolve(handle)
        want = seeder.resolve(seeder.submit_packed(rw.copy(), B, L))
        assert got[3] is False and want[3] is False
        assert len(got[1]) > 0
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("e", [4, 8])
def test_split_seeder_card_equals_cpu(card, small_world, e):
    """Split (drop-off) mode, every fourth read spliced at a junction: the
    CUDA download equals the CPU plain path's, and the drop-off kernel
    launched twice (primary and 5'-gap retry)."""
    index, ref_codes, ref_seqs = small_world
    B, L = 4096, 100
    rng = np.random.default_rng(e)
    reads = _reads(ref_codes, rng, B, L)
    for i in range(0, B, 4):
        st = int(rng.integers(0, len(ref_codes[0]) - 40))
        reads[i, L - 40:] = ref_codes[0][st:st + 40]
    rw = ds._pack_reads(reads)
    outs = []
    for dev in (card, "cpu"):
        seeder = ds.DeviceSeeder(index, ref_seqs, e, MIN_SEEDS, F,
                                 device=dev, split=True)
        before = (my.myers_dropoff.launches, ds.index_probe.launches)
        handle = seeder.submit_packed(rw, B, L)
        res = seeder.resolve(handle)
        (dl, full, _, _), _, _ = handle
        outs.append((dl.cpu().numpy().tobytes(), full.cpu().numpy().tobytes(),
                     res, (my.myers_dropoff.launches - before[0],
                           ds.index_probe.launches - before[1])))
    assert outs[0][3] == (2, 1) and outs[1][3] == (0, 0)
    assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1]
    a, b = outs[0][2], outs[1][2]
    for x, y in zip(a[:2] + a[2], b[:2] + b[2]):
        np.testing.assert_array_equal(x, y)
    rml0 = (a[2][1] >> np.uint64(17)) & np.uint64(0xFF)
    assert (rml0 < L).any()


def _flat(res):
    meta, pos, cmeta, over = res
    return [meta, pos] + (list(cmeta) if isinstance(cmeta, tuple)
                          else [cmeta]) + [over]


@pytest.mark.parametrize("split", [False, True], ids=["bed", "split"])
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_seeder_card_equals_cpu(card, small_world, monkeypatch, n,
                                     split):
    """n shards of one card, each on its own stream: every shard's
    download equals the CPU mesh's, the resolved chunk equals the card's
    single seeder's, kernel A launches once per shard, and with no
    candidate in the capped downloads each shard's `full` stream (written
    on its own stream) gives the same chunk."""
    index, ref_codes, ref_seqs = small_world
    e = 4 if split else 8
    B, L = 4096, 100
    reads = _reads(ref_codes, np.random.default_rng(n), B, L)
    rw = ds._pack_reads(reads)
    args = (index, ref_seqs, e, MIN_SEEDS, F)
    mesh = ds.MeshSeeder(*args, [card] * n, split=split)
    assert len(mesh._replicas) == 1 and len(set(mesh._streams)) == n
    before = dm.dense_minimizer.launches, ds.index_probe.launches
    handle = mesh.submit_packed(rw, B, L)
    got = _flat(mesh.resolve(handle))
    assert dm.dense_minimizer.launches - before[0] == n
    assert ds.index_probe.launches - before[1] == n
    cpu = ds.MeshSeeder(*args, ["cpu"] * n, split=split)
    chandle = cpu.submit_packed(rw, B, L)
    for (dl, full, _, _), (cdl, cfull, _, _) in zip(handle[0], chandle[0]):
        assert dl.numpy().tobytes() == cdl.numpy().tobytes()
        assert full.cpu().numpy().tobytes() == cfull.numpy().tobytes()
    single = ds.DeviceSeeder(*args, device=card, split=split)
    want = _flat(single.resolve(single.submit_packed(rw, B, L)))
    assert got[-1] is False and want[-1] is False
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(ds, "DL_CANDS_PER_READ", 0)
    again = _flat(mesh.resolve(mesh.submit_packed(rw, B, L)))
    for a, b in zip(again[:-1], want[:-1]):
        np.testing.assert_array_equal(a, b)


def test_sharded_myers_on_card(card):
    """sharded_myers over two shards of the card equals kernel B's plain
    version on the whole batch, with one launch per shard."""
    from chromap_tpu_torch.parallel.sharding import sharded_myers
    rng = np.random.default_rng(3)
    n, L, e = 4098, 100, 8
    pats = rng.integers(0, 4, (L + 2 * e, n)).astype(np.int32)
    txts = pats[e:e + L].copy()
    txts[:, ::3] = rng.integers(0, 4, (L, len(txts[0, ::3])))
    before = my.myers.launches
    errors, ends, accepted = sharded_myers([card] * 2, pats, txts, e, L)
    assert my.myers.launches - before == 2
    want = my.myers_plain(torch.from_numpy(pats), torch.from_numpy(txts), e,
                          L)
    np.testing.assert_array_equal(errors, want[0].numpy())
    np.testing.assert_array_equal(ends, want[1].numpy())
    assert accepted == int((want[0] <= e).sum()) and 0 < accepted < n


def test_tools_launch_the_kernels_each_stop_implies(card, tmp_path, capsys):
    """stage_profile on the card, in BED and split mode, at a small size:
    each stop launches the hand-written kernels its stages hold -- A from
    `kmer` on, C from `cluster` on, B (BED) or D twice (split: the primary
    pass and the 5'-gap retry) only in the full step -- and the profiler
    sees device time at every stop. weak_scaling at 1, 2 and 4 shards of
    the card launches A, B and C once per shard per call."""
    import argparse
    import json

    from chromap_tpu_torch import bench
    from chromap_tpu_torch.tools import stage_profile, weak_scaling
    bench.ensure_data(str(tmp_path), 2000, 50_000)
    for split in (False, True):
        ap = argparse.ArgumentParser()
        stage_profile.add_chunk_args(ap)
        args = ap.parse_args(["--cache", str(tmp_path), "--rows", "1024",
                              "--reps", "1"] + (["--split"] if split else []))
        rows = stage_profile.run_stops(args, ds.STAGES, "stage_profile")
        for row, stop in zip(rows, ds.STAGES):
            want = stage_profile.expected_launches(stop, split)
            assert row["own"] == want, (stop, row["own"])
            assert row["kernel_ms"] > 0 and row["launches"] > 0
        assert rows[-1]["launches"] > rows[0]["launches"]
    capsys.readouterr()
    weak_scaling.main(["--per-device-reads", "256", "--cache", str(tmp_path)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["device"]["torch_device"] == "cuda"
    shard = stage_profile.expected_launches(None, False)
    for row in lines[1:]:
        n = row["devices"]
        assert row["launches_per_call"] == {k: n * v
                                            for k, v in shard.items()}
