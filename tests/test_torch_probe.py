"""The index probe of chromap_tpu_torch/ops/device_seed.py on the CPU:
kernel E's bucket table (`index_probe_table`) and the search the kernel
runs inside each bucket, written here in numpy, against the merged sort
(`_probe_merge_sort`) and unsigned searchsorted, on loc, found, off and
cnt; the plain probe (`index_probe_plain`, what `index_probe` runs for
CPU tensors) against the same; and the tracer's `seeder.probe_kernel`
counter, one a chunk whose probe launched kernel E. Kernel E itself runs
only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from chromap_tpu_torch import tracing
from chromap_tpu_torch.index.index import build_index
from chromap_tpu_torch.ops import device_seed as ds
from chromap_tpu_torch.ops.u64 import (UMAX64, from_numpy_u32,
                                       from_numpy_u64, searchsorted_u64)

UMAX = np.uint64(0xFFFFFFFFFFFFFFFF)
B2C = np.frombuffer(b"ACGTN", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _keys(case: str, k: int, rng) -> np.ndarray:
    """Sorted distinct 2k-bit keys: one, two, a sparse index (most
    buckets empty) with one crowded bucket and both ends of the hash
    range, or a few thousand uniform ones."""
    top = 1 << (2 * k)
    if case == "one":
        keys = [int(rng.integers(1, top - 1))]
    elif case == "two":
        keys = rng.choice(top, size=2, replace=False)
    elif case == "crowded":
        base = int(rng.integers(0, top - 1000))
        keys = np.concatenate([
            rng.choice(top, size=40, replace=False),
            base + rng.choice(1000, size=60, replace=False),
            [0, top - 1]])
    else:
        keys = rng.choice(top, size=5000, replace=False)
    return np.unique(np.asarray(keys, dtype=np.uint64))


def _offcnt(nk: int, wide: bool, rng):
    """(numpy words, torch carrier): offset << 12 | count in the u32 tier
    (offsets < 2^20) or the u64 tier (any offset, top bit included)."""
    if wide:
        w = rng.integers(0, 1 << 63, nk, dtype=np.uint64) << np.uint64(1)
        w |= rng.integers(0, 2, nk, dtype=np.uint64)
        return w, from_numpy_u64(w)
    w = ((rng.integers(0, 1 << 20, nk, dtype=np.uint64) << np.uint64(12))
         | rng.integers(0, 1 << 12, nk, dtype=np.uint64)).astype(np.uint32)
    return w, from_numpy_u32(w)


def _queries(keys: np.ndarray, k: int, M: int, rng) -> np.ndarray:
    """Keys (repeated), values below the first key and past the last,
    random hashes, and UMAX64 invalid slots."""
    top = 1 << (2 * k)
    q = rng.integers(0, top, M, dtype=np.uint64)
    q[: M // 3] = rng.choice(keys, size=M // 3)
    q[M // 3] = 0
    q[M // 3 + 1] = keys[0]
    q[M // 3 + 2] = keys[-1]
    q[M // 3 + 3] = min(int(keys[-1]) + 1, top - 1)
    q[M // 3 + 4] = max(int(keys[0]) - 1, 0)
    q[-M // 10:] = UMAX
    return q


def _table_search(table: np.ndarray, keys: np.ndarray, q: np.ndarray,
                  k: int):
    """What kernel E does, in numpy: the lower bound inside the query's
    bucket of the table (clamped to nk - 1), found where the key there
    equals the query; invalid queries take nk - 1 and not found."""
    nb = len(table) - 1
    shift = max(0, 2 * k - (nb.bit_length() - 1))
    nk = len(keys)
    valid = q != UMAX
    b = np.minimum(q >> np.uint64(shift), np.uint64(nb - 1)).astype(np.int64)
    lo, hi = table[b].astype(np.int64), table[b + 1].astype(np.int64)
    loc = lo.copy()
    for j in range(int((hi - lo).max(initial=0))):
        idx = lo + j
        loc += (idx < hi) & (keys[np.minimum(idx, nk - 1)] < q)
    found = (loc < hi) & (keys[np.minimum(loc, nk - 1)] == q) & valid
    return np.where(valid, np.minimum(loc, nk - 1), nk - 1), found


def _gather(words: np.ndarray, loc: np.ndarray, found: np.ndarray):
    oc = words[loc].astype(np.uint64)
    off = (oc >> np.uint64(12)).view(np.int64)
    cnt = np.where(found, (oc & np.uint64(0xFFF)).astype(np.int32), 0)
    return off, cnt


@pytest.mark.parametrize("wide", [False, True], ids=["u32", "u64"])
@pytest.mark.parametrize("case", ["one", "two", "crowded", "uniform"])
@pytest.mark.parametrize("k", [15, 17, 21, 23])
def test_table_search_equals_merge_sort_and_searchsorted(k, case, wide):
    rng = np.random.default_rng(1000 * k + len(case) + wide)
    keys = _keys(case, k, rng)
    nk = len(keys)
    words, offcnt = _offcnt(nk, wide, rng)
    M = 3000
    q = _queries(keys, k, M, rng)
    valid = q != UMAX
    kt, qt = from_numpy_u64(keys), from_numpy_u64(q)

    # the merged sort, as the step ran it before kernel E
    ib = max(1, (M - 1).bit_length())
    assert 2 * k + 1 + ib <= 64
    lf = ds._probe_merge_sort(kt, qt, M, ib).numpy()
    loc_ms = np.minimum(lf & 0x7FFFFFFF, nk - 1)
    found_ms = (lf < 0) & valid
    # unsigned searchsorted
    ss = searchsorted_u64(kt, qt).numpy()
    loc_ss = np.minimum(ss, nk - 1)
    found_ss = (keys[loc_ss] == q) & valid
    # kernel E's table and search
    table = ds.index_probe_table(keys, k)
    loc_t, found_t = _table_search(table, keys, q, k)

    for loc, found in ((loc_ss, found_ss), (loc_t, found_t)):
        np.testing.assert_array_equal(loc, loc_ms)
        np.testing.assert_array_equal(found, found_ms)
    assert (loc_t[~valid] == nk - 1).all() and not found_t[~valid].any()
    assert found_t.sum() >= M // 3

    # the plain probe: off, cnt and found of the merged sort's loc
    off, cnt, found = ds.index_probe_plain(kt, offcnt, qt, k)
    want_off, want_cnt = _gather(words, loc_ms, found_ms)
    np.testing.assert_array_equal(found.numpy(), found_ms)
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    assert off.dtype == torch.int64 and cnt.dtype == torch.int32


@pytest.mark.parametrize("nk", [1, 2, 255, 4096, 70001])
@pytest.mark.parametrize("k", [4, 15, 17, 23])
def test_index_probe_table_bounds_each_bucket(k, nk):
    """table[b] counts the keys below b << shift; tbits follows nk alone
    (10 to 22 bits), and bucket b holds exactly the keys whose top bits
    are b."""
    rng = np.random.default_rng(nk + k)
    top = 1 << (2 * k)
    keys = np.sort(rng.choice(top, size=min(nk, top), replace=False)
                   .astype(np.uint64))
    table = ds.index_probe_table(keys, k)
    nb = len(table) - 1
    tbits = nb.bit_length() - 1
    assert table.dtype == np.int32 and nb == 1 << tbits
    assert tbits == min(22, max(10, int(np.ceil(np.log2(len(keys)))) + 2))
    shift = max(0, 2 * k - tbits)
    assert (nb << shift) >= top
    bounds = np.arange(nb + 1, dtype=np.uint64) << np.uint64(shift)
    np.testing.assert_array_equal(table, np.searchsorted(keys, bounds))
    np.testing.assert_array_equal(
        np.repeat(np.arange(nb), np.diff(table)),
        (keys >> np.uint64(shift)).astype(np.int64))


def test_plain_probe_takes_searchsorted_when_the_hash_is_too_wide():
    """k = 23 at more than 2^17 queries: the 46-bit hash does not pack
    with the query index, so the plain probe takes searchsorted; kernel
    E's table search agrees with it."""
    k, M = 23, (1 << 17) + 5
    rng = np.random.default_rng(23)
    keys = _keys("uniform", k, rng)
    words, offcnt = _offcnt(len(keys), True, rng)
    q = _queries(keys, k, M, rng)
    assert 2 * k + 1 + max(1, (M - 1).bit_length()) > 64
    off, cnt, found = ds.index_probe_plain(from_numpy_u64(keys), offcnt,
                                           from_numpy_u64(q), k)
    loc, want_found = _table_search(ds.index_probe_table(keys, k), keys, q,
                                    k)
    want_off, want_cnt = _gather(words, loc, want_found)
    np.testing.assert_array_equal(found.numpy(), want_found)
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)


def test_index_probe_on_the_cpu_is_the_plain_probe():
    """CPU tensors take the plain version without a table, and count no
    launch."""
    rng = np.random.default_rng(3)
    keys = _keys("uniform", 17, rng)
    _, offcnt = _offcnt(len(keys), False, rng)
    qt = from_numpy_u64(_queries(keys, 17, 2000, rng))
    kt = from_numpy_u64(keys)
    before = ds.index_probe.launches
    got = ds.index_probe(kt, offcnt, qt, None, 17)
    want = ds.index_probe_plain(kt, offcnt, qt, 17)
    assert ds.index_probe.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2].sum()) > 0 and bool((qt == UMAX64).any())


@pytest.fixture(scope="module")
def small_world():
    rng = np.random.default_rng(7)
    core = rng.integers(0, 4, 12000, dtype=np.uint8)
    genome = np.concatenate([core, core[500:700], core[3000:5000]])
    return build_index([genome], 17, 7), [B2C[genome].tobytes()], genome


def _reads(genome, B: int, L: int, rng) -> np.ndarray:
    starts = rng.integers(0, len(genome) - L, B)
    reads = np.stack([genome[s:s + L] for s in starts]).astype(np.uint8)
    reads[rng.random((B, L)) < 0.01] = rng.integers(0, 4)
    return reads


def test_probe_kernel_counter_one_a_chunk_through_kernel_e(
        small_world, monkeypatch):
    """A traced pass counts `seeder.probe_kernel` once for each chunk
    whose step launched kernel E (here a stand-in that counts a launch
    and runs the plain probe, as no card is at hand), and never on the
    plain CPU path."""
    index, ref_seqs, genome = small_world
    B, L = 256, 100
    rw = ds._pack_reads(_reads(genome, B, L, np.random.default_rng(9)))
    seeder = ds.DeviceSeeder(index, ref_seqs, 8, 2, (500, 1000),
                             device="cpu")
    assert seeder.probe_table is None

    @tracing.traced_pass
    def one_pass(chunks):
        return [seeder.resolve(seeder.submit_packed(rw, B, L))
                for _ in range(chunks)]

    monkeypatch.setenv(tracing.SWITCH, "1")
    plain = one_pass(2)
    assert "seeder.probe_kernel" not in tracing.last_pass()["counters"]

    def stand_in(hash_keys, offcnt, mz_h, table, k):
        stand_in.launches += 1
        return ds.index_probe_plain(hash_keys, offcnt, mz_h, k)
    stand_in.launches = 0
    monkeypatch.setattr(ds, "index_probe", stand_in)
    got = one_pass(3)
    counters = tracing.last_pass()["counters"]
    assert stand_in.launches == 3
    assert counters["seeder.probe_kernel"] == 3
    for a, b in zip(got[0][:3], plain[0][:3]):
        np.testing.assert_array_equal(a, b)
