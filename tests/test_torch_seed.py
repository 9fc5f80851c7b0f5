"""chromap_tpu_torch/ops/device_seed.py against the JAX package's seeding
program on the same inputs: kernel C's plain version against
`_cluster_scan_W`, the probe and the tiled scans, the index build, and the
whole step -- the port's DeviceSeeder on the CPU must download the same
bytes `(dl, full)` as the JAX DeviceSeeder, including with the u64 index
tiers forced on the port's side, on the k > 22 searchsorted probe, under
both CHROMAP_TPU_PROBE switches (the bucketed probe and forced
searchsorted), and in split (drop-off) mode on reads spliced at a
ligation junction."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))

from test_device_seed import _simulate_reads, _to_seq  # noqa: E402

from chromap_tpu.index.index import build_index as jax_build_index  # noqa
from chromap_tpu.ops import device_seed as jds  # noqa: E402
from chromap_tpu_torch.index.index import build_index  # noqa: E402
from chromap_tpu_torch.ops import device_seed as tds  # noqa: E402
from chromap_tpu_torch.ops.u64 import (from_numpy_u64,  # noqa: E402
                                       to_numpy_u64)

E, MIN_SEEDS, F = 8, 2, (500, 1000)
UMAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; torch's default of
    one thread per core in each worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _genome(seed: int, core_len: int):
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 4, core_len, dtype=np.uint8)
    rep = core[500:700]
    genome = np.concatenate([core, rep, core[3000:5000], rep, rep])
    return [genome, rng.integers(0, 4, 4000, dtype=np.uint8)]


@pytest.fixture(scope="module")
def small_world():
    """The small_world reference of test_device_seed.py, indexed by the
    port's own copy of build_index."""
    ref_codes = _genome(7, 12000)
    index = build_index(ref_codes, 17, 7)
    return index, ref_codes, [_to_seq(g) for g in ref_codes]


def _downloads(index, ref_seqs, reads, monkeypatch=None, tiers=None):
    """(dl, full) of one chunk from both seeders, as numpy uint32."""
    B, L = reads.shape
    rw = jds._pack_reads(reads)
    js = jds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F,
                          use_pallas=False)
    jhandle = js.submit_packed(rw, B, L)
    (dl, full, _), _, _ = jhandle
    if tiers is not None:
        monkeypatch.setattr(tds, "index_tiers", lambda *a: tiers)
    ts = tds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F, device="cpu")
    handle = ts.submit_packed(rw, B, L)
    (tdl, tfull, _, _), _, _ = handle
    return ((np.asarray(dl), np.asarray(full)),
            (tdl.numpy().view(np.uint32), tfull.numpy().view(np.uint32)),
            ts, handle, js.resolve(jhandle))


# ---------------------------------------------------------------------
# pieces of the step
# ---------------------------------------------------------------------

def _cluster_inputs(seed: int, B: int, H: int = tds.HCAP):
    rng = np.random.default_rng(seed)
    words = np.full((H + 1, B), UMAX, np.uint64)
    counts = np.minimum(rng.integers(0, 40, B), H)    # 0: all-ones column
    counts[: B // 8] = rng.integers(min(40, H), H + 1, B // 8)  # full to H
    for b in range(B):
        n = int(counts[b])
        if n == 0:
            continue
        strand = rng.integers(0, 2, n).astype(np.uint64)
        rid = rng.integers(0, 3, n).astype(np.uint64)
        steps = np.where(rng.random(n) < 0.7, rng.integers(0, 3, n),
                         rng.integers(5, 40, n))
        # starts near 2^32 exercise the u32 wrap of `prev + e`
        base = int(rng.choice([0, (1 << 32) - 60, rng.integers(0, 1 << 31)]))
        start = (np.uint64(base) + np.cumsum(steps).astype(np.uint64)) \
            & np.uint64(0xFFFFFFFF)
        w = ((np.uint64(b) << np.uint64(47)) | (strand << np.uint64(46))
             | (rid << np.uint64(32)) | start)
        words[:n, b] = np.sort(w)
    mm = rng.integers(1, 40, B).astype(np.int32)
    req = np.clip(mm - rng.integers(0, 3, B), 1, 2).astype(np.int32)
    return words, mm, req


# seeds 4 and 5: the shortest tiles (H + 1 = 2 and 17 rows) at e = 15
@pytest.mark.parametrize("seed,e", [(1, 8), (2, 4), (3, 0), (4, 15),
                                    (5, 15)])
def test_cluster_scan_plain_matches_jax(seed, e):
    H = {4: 1, 5: 16}.get(seed, tds.HCAP)
    words, mm, req = _cluster_inputs(seed, 384, H)
    j_emit, j_cand = jds._cluster_scan_W(jnp.asarray(words), jnp.asarray(mm),
                                         jnp.asarray(req), e)
    t_emit, t_cand = tds.cluster_scan(from_numpy_u64(words),
                                      torch.from_numpy(mm),
                                      torch.from_numpy(req), e)
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
    np.testing.assert_array_equal(to_numpy_u64(t_cand), np.asarray(j_cand))
    assert t_emit.any()


def test_probe_merge_sort_matches_jax():
    rng = np.random.default_rng(11)
    k, nk, M = 17, 7919, 2048
    keys = np.sort(rng.choice(1 << (2 * k), size=nk,
                              replace=False).astype(np.uint64))
    q = rng.integers(0, 1 << (2 * k), size=M, dtype=np.uint64)
    q[: M // 2] = rng.choice(keys, size=M // 2)       # hits, duplicates
    q[-19:] = UMAX                                    # invalid lanes
    ib = max(1, (M - 1).bit_length())
    want = np.asarray(jds._probe_merge_sort(jnp.asarray(keys),
                                            jnp.asarray(q), M, ib))
    got = tds._probe_merge_sort(from_numpy_u64(keys), from_numpy_u64(q),
                                M, ib).numpy()
    np.testing.assert_array_equal(got, want)
    loc = got & 0x7FFFFFFF
    np.testing.assert_array_equal(loc[:-19],
                                  np.searchsorted(keys, q, "left")[:-19])
    assert (loc[-19:] == nk).all()


@pytest.mark.parametrize("n", [1000, 2048, 70001])
def test_tiled_scans_match_jax(n):
    """The (rows, 2048)-tiled cummax / unsigned suffix cummin against the
    JAX helpers and numpy, below, at and above one tile."""
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    x[: n // 7] |= np.uint64(1) << np.uint64(63)
    x[n // 3: n // 3 + 5] = UMAX
    got = to_numpy_u64(tds._cummin1d_rev_u64(from_numpy_u64(x)))
    np.testing.assert_array_equal(
        got, np.asarray(jds._cummin1d_rev_u64(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.minimum.accumulate(x[::-1])[::-1])
    y = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    got = tds._cummax1d(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jds._cummax1d(jnp.asarray(y))))
    np.testing.assert_array_equal(got, np.maximum.accumulate(y))


def test_gather_read_rows_matches_unpack():
    rng = np.random.default_rng(3)
    B, L = 64, 100
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.03] = 4
    rw = torch.from_numpy(tds._pack_reads(codes).view(np.int32)) \
        .to(torch.int64) & 0xFFFFFFFF
    W = (L + 15) // 16
    rows = torch.from_numpy(rng.integers(0, B, 200))
    got = tds._gather_read_rows(rw[:, :W], rw[:, W:], rows, L).numpy()
    np.testing.assert_array_equal(got, codes[rows.numpy()].astype(np.int32))
    np.testing.assert_array_equal(
        tds._unpack_codes_T(rw[:, :W], rw[:, W:], B, L).numpy(),
        codes.T.astype(np.int32))


@pytest.mark.parametrize("k,w", [(17, 7), (23, 11)])
def test_index_build_matches_jax(k, w):
    ref_codes = _genome(9, 30000)
    ref_codes[0][100:160] = 4                          # an N run
    a = build_index(ref_codes, k, w)
    b = jax_build_index(ref_codes, k, w)
    for name in ("hash_keys", "offsets", "counts", "occurrences"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.kmer_size, a.window_size) == (b.kmer_size, b.window_size)


# ---------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------

@pytest.mark.parametrize("B,L", [(96, 80), (1 << 15, 48)])
def test_seeder_download_matches_jax(small_world, B, L):
    index, ref_codes, ref_seqs = small_world
    reads = _simulate_reads(ref_codes, np.random.default_rng(5), B, L)
    (dl, full), (tdl, tfull), ts, handle, j_res = _downloads(
        index, ref_seqs, reads)
    assert tdl.tobytes() == dl.tobytes()
    assert tfull.tobytes() == full.tobytes()
    assert dl[0] > 0 and dl[1] == 0
    # resolve unpacks to the same wide view as the JAX seeder's, also
    # through seed_and_verify, which uploads per-read lengths
    results = [ts.resolve(handle)]
    if B < 1024:
        results.append(ts.seed_and_verify(reads, np.full(B, L)))
    for res in results:
        assert res[3] is False and j_res[3] is False
        for a, b in zip(res[:3], j_res[:3]):
            np.testing.assert_array_equal(a, b)
    n = len(results)
    assert ts.stats["chunks"] == n and ts.stats["rows"] == n * B
    assert ts.stats["fallback_rows"] == n * int(
        np.count_nonzero((results[0][0] >> 24) & tds.FLAG_FALLBACK))


def test_seeder_u64_tiers_match_jax(small_world, monkeypatch):
    """The u64 offcnt/occurrence tiers (offsets >= 2^20 or positions >=
    2^24 on real genomes) forced on the port's side only: the download
    bytes must not change."""
    index, ref_codes, ref_seqs = small_world
    reads = _simulate_reads(ref_codes, np.random.default_rng(8), 256, 100)
    (dl, full), (tdl, tfull), ts, _, _ = _downloads(
        index, ref_seqs, reads, monkeypatch, tiers=(False, False))
    assert ts.offcnt.dtype == torch.int64
    assert ts.occurrences.dtype == torch.int64
    assert tdl.tobytes() == dl.tobytes()
    assert tfull.tobytes() == full.tobytes()


def test_index_tiers_rule():
    """u32 offcnt needs offsets < 2^20; u32 occurrences need positions
    < 2^24 on at most 128 sequences (the JAX seeder's rule)."""
    assert tds.index_tiers(0, 0, 1) == (True, True)
    assert tds.index_tiers((1 << 20) - 1, (1 << 24) - 1, 128) == (True, True)
    assert tds.index_tiers(1 << 20, 0, 1) == (False, True)
    assert tds.index_tiers(0, 1 << 24, 1) == (True, False)
    assert tds.index_tiers(0, 0, 129) == (True, False)


def test_seeder_wide_hash_probe_matches_jax():
    """k = 23 at 8192 rows: 2k + 1 + ib > 64, so both programs take the
    searchsorted probe instead of the packed merge sort."""
    ref_codes = _genome(13, 12000)
    index = build_index(ref_codes, 23, 11)
    ref_seqs = [_to_seq(g) for g in ref_codes]
    B, L = 8192, 60
    assert 2 * 23 + 1 + (tds.MZ_PER_READ * B - 1).bit_length() > 64
    reads = _simulate_reads(ref_codes, np.random.default_rng(4), B, L)
    (dl, full), (tdl, tfull), _, _, _ = _downloads(index, ref_seqs, reads)
    assert tdl.tobytes() == dl.tobytes()
    assert tfull.tobytes() == full.tobytes()
    assert dl[0] > 0


@pytest.mark.parametrize("k,w", [(17, 7), (23, 11)])
def test_bucket_probe_table_matches_jax(monkeypatch, k, w):
    """The bucket table, shift and depth against the JAX seeder's, and
    the table's meaning: bucket b holds the keys whose top hash bits are
    b."""
    monkeypatch.setenv("CHROMAP_TPU_PROBE", "bucket")
    ref_codes = _genome(21, 20000)
    index = build_index(ref_codes, k, w)
    js = jds.DeviceSeeder(index, [_to_seq(g) for g in ref_codes], E,
                          MIN_SEEDS, F, use_pallas=False)
    keys = np.asarray(index.hash_keys, dtype=np.uint64)
    table, shift, depth = tds.bucket_probe_table(keys, k)
    assert (shift, depth) == js._probe
    np.testing.assert_array_equal(table, np.asarray(js.probe_table))
    assert table.dtype == np.int32 and table[0] == 0
    assert table[-1] == len(keys) and 2 * k - shift >= 10
    bucket = keys >> np.uint64(shift)
    np.testing.assert_array_equal(
        np.repeat(np.arange(len(table) - 1), np.diff(table)), bucket)
    assert np.diff(table).max() <= 1 << (depth - 1)


def _probe_downloads(monkeypatch, mode, index, ref_seqs, reads):
    """(dl, full) bytes of one chunk from the JAX seeder and the port's
    with CHROMAP_TPU_PROBE=mode set on both sides (the JAX step re-traced
    under it), and the port's seeder."""
    B, L = reads.shape
    rw = jds._pack_reads(reads)
    monkeypatch.setenv("CHROMAP_TPU_PROBE", mode)
    monkeypatch.setattr(jds, "_jitted_step",
                        jds._jitted_step.__wrapped__)   # trace anew
    js = jds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F,
                          use_pallas=False)
    (dl, full, _), _, _ = js.submit_packed(rw, B, L)
    ts = tds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F, device="cpu")
    (tdl, tfull, _, _), _, _ = ts.submit_packed(rw, B, L)
    return ((np.asarray(dl).tobytes(), np.asarray(full).tobytes()),
            (tdl.numpy().tobytes(), tfull.numpy().tobytes()), ts)


@pytest.mark.parametrize("mode", ["bucket", "sortss"])
@pytest.mark.parametrize("B,L", [(96, 80), (1 << 15, 48)])
def test_seeder_probe_switch_matches_jax(small_world, monkeypatch, mode, B,
                                         L):
    """CHROMAP_TPU_PROBE=bucket (the bucketed search) and =sortss
    (searchsorted forced): the port's download equals the JAX seeder's
    under the same switch and the port's merge-sort download."""
    index, ref_codes, ref_seqs = small_world
    reads = _simulate_reads(ref_codes, np.random.default_rng(5), B, L)
    rw = tds._pack_reads(reads)
    merge = tds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F, device="cpu")
    assert merge.probe is None
    (mdl, mfull, _, _), _, _ = merge.submit_packed(rw, B, L)
    want, got, ts = _probe_downloads(monkeypatch, mode, index, ref_seqs,
                                     reads)
    if mode == "bucket":
        assert isinstance(ts.probe, tuple) and ts.keys_lo.dtype == torch.int32
        assert ts.probe_table.numel() == (1 << (2 * 17 - ts.probe[0])) + 1
    else:
        assert ts.probe == "sortss" and ts.probe_table is None
    assert got == want
    assert got == (mdl.numpy().tobytes(), mfull.numpy().tobytes())
    assert np.frombuffer(got[0][:4], np.uint32)[0] > 0


def test_probe_switch_keys_the_caches(small_world, monkeypatch):
    """A seeder built under one CHROMAP_TPU_PROBE is not served to a run
    under another, and the step is built per probe."""
    index, _, ref_seqs = small_world
    seeders = []
    for mode in (None, "bucket", "sortss"):
        if mode is None:
            monkeypatch.delenv("CHROMAP_TPU_PROBE", raising=False)
        else:
            monkeypatch.setenv("CHROMAP_TPU_PROBE", mode)
        seeders.append(tds.get_device_seeder(
            index, ref_seqs, E, MIN_SEEDS, F, cache_key=("probe-test",),
            device="cpu"))
    assert [s.probe is None for s in seeders] == [True, False, False]
    assert len({id(s) for s in seeders}) == 3
    assert len({id(s._step) for s in seeders}) == 3
    tds._seeder_cache.clear()


def _spliced_reads(ref_codes, seed: int, B: int, L: int):
    """Simulated reads, every fourth spliced at a ligation junction: its
    last 40 bases come from a random place of the first sequence."""
    rng = np.random.default_rng(seed)
    reads = _simulate_reads(ref_codes, rng, B, L)
    g = ref_codes[0]
    for i in range(0, B, 4):
        st = int(rng.integers(0, len(g) - 40))
        reads[i, L - 40:] = g[st:st + 40]
    return reads


@pytest.mark.parametrize("e", [4, 8])
def test_split_seeder_download_matches_jax(small_world, monkeypatch, e):
    """Split (drop-off) mode: the download -- 4 u32 per candidate, the
    second u64 packing the primary and 5'-gap retry results -- and the
    `resolve` tuple (cand_meta, cand_split) equal the JAX split seeder's."""
    index, ref_codes, ref_seqs = small_world
    B, L = 96, 100
    reads = _spliced_reads(ref_codes, 5, B, L)
    rw = jds._pack_reads(reads)
    js = jds.DeviceSeeder(index, ref_seqs, e, MIN_SEEDS, F, use_pallas=False,
                          split=True)
    jhandle = js.submit_packed(rw, B, L)
    (dl, full, _), _, _ = jhandle
    ts = tds.DeviceSeeder(index, ref_seqs, e, MIN_SEEDS, F, device="cpu",
                          split=True)
    handle = ts.submit_packed(rw, B, L)
    (tdl, tfull, _, _), _, _ = handle
    assert tdl.numpy().tobytes() == np.asarray(dl).tobytes()
    assert tfull.numpy().tobytes() == np.asarray(full).tobytes()
    total = int(dl[0])
    assert total > 0 and dl[1] == 0
    assert len(dl) == 2 + B + 4 * tds.DL_CANDS_PER_READ * B
    got, want = ts.resolve(handle), js.resolve(jhandle)
    assert got[3] is False and want[3] is False
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert isinstance(got[2], tuple) and len(got[2]) == 2
    for a, b in zip(got[2], want[2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the junction reads stop early: some primary read_mapping_length
    # (bits 17..24 of the split word) falls short of L
    rml0 = (got[2][1] >> np.uint64(17)) & np.uint64(0xFF)
    assert (rml0 < L).any() and (rml0 == L).any()
    # with no candidate in the single download, resolve reads them all
    # from the `full` stream and returns the same
    monkeypatch.setattr(tds, "DL_CANDS_PER_READ", 0)
    res = ts.resolve(ts.submit_packed(rw, B, L))
    for a, b in zip(res[:2] + res[2], want[:2] + want[2]):
        np.testing.assert_array_equal(a, b)


def test_seeder_refuses_cuda_without_card(small_world):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    index, _, ref_seqs = small_world
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.get_device_seeder(index, ref_seqs, E, MIN_SEEDS, F,
                              mesh_devices=2, device="cuda")
