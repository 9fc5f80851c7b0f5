"""The reference's own index: built in blocks with margins, it equals
the index of the whole sequence at once."""

import numpy as np
import pytest

from portbench.reference import index as ri
from portbench.reference.minimizer_vector import \
    generate_minimizer_arrays_fast
from portbench.reference.utils import encode_sequence


def _genome(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, 150_000)
    g = np.concatenate([base, base[30_000:50_000], rng.integers(0, 4, 40_000)])
    arr = np.frombuffer(b"ACGT", dtype=np.uint8)[g].copy()
    arr[rng.integers(0, len(arr), 200)] = ord("N")
    arr[7_000:7_050] = ord("N")
    return arr.tobytes()


def _whole(seqs, k, w):
    hs, ts = [], []
    for rid, s in enumerate(seqs):
        h, t = generate_minimizer_arrays_fast(encode_sequence(s), rid, k, w)
        hs.append(h)
        ts.append(t)
    h, t = np.concatenate(hs), np.concatenate(ts)
    order = np.lexsort((t, h))
    keys, counts = np.unique(h[order], return_counts=True)
    return keys, counts.astype(np.uint32), t[order]


def test_blocks_equal_the_whole(monkeypatch):
    monkeypatch.setattr(ri, "BLOCK", 20_000)
    monkeypatch.setattr(ri, "MARGIN", 500)
    seqs = [_genome(1), _genome(2)[:60_000]]
    got = ri.build(seqs, 17, 7)
    want = _whole(seqs, 17, 7)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_saved_index_looks_up(tmp_path):
    fasta = tmp_path / "g.fa"
    fasta.write_bytes(b">c1 x\n" + _genome(3) + b"\n>c2\n" + _genome(4)
                      + b"\n")
    idx = ri.load_or_build(str(fasta), str(tmp_path / "idx"), 17, 7)
    keys, counts, occ = _whole([s for _, s in ri.read_fasta(str(fasta))],
                               17, 7)
    for i in (0, 5, len(keys) - 1):
        off = int(counts[:i].sum())
        assert np.array_equal(idx.lookup(int(keys[i])),
                              occ[off:off + counts[i]])
    absent = int(keys[-1]) + 1
    assert idx.lookup(absent) is None
    assert [n for n, _ in ri.read_fasta(str(fasta))] == [b"c1", b"c2"]
