"""The traffic generator: the genome is the repository simulator's, byte
for byte; the reads follow the mix's parameters with exact counts."""

import filecmp
import os
import sys

import numpy as np
import pytest

from portbench.traffic import paired_reads as pr

from conftest import ROOT

sys.path.insert(0, os.path.join(ROOT, "tests"))


@pytest.mark.parametrize("core,seed", [(30_000, 123), (300_001, 7)])
def test_genome_equals_the_simulator(tmp_path, core, seed):
    from simulate import write_simulated_dataset
    write_simulated_dataset(str(tmp_path), num_pairs=1, genome_core=core,
                            seed=seed)
    pr.write_genome(str(tmp_path / "copy.fa"), core, seed)
    assert filecmp.cmp(tmp_path / "ref.fa", tmp_path / "copy.fa",
                       shallow=False)


def _records(path):
    lines = open(path, "rb").read().split(b"\n")
    return [lines[i:i + 4] for i in range(0, len(lines) - 1, 4)]


def test_reads_follow_the_mix(tmp_path):
    pr.write_genome(str(tmp_path / "g.fa"), 200_000, 3)
    genome = pr.read_genome(str(tmp_path / "g.fa")).tobytes()
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    mix = {"mismatches_max": 2, "indel_share": 0.0, "pcr_dup_share": 0.1,
           "trimmed_share": 0.3, "junction_share": 0.0,
           "lanes": [{"pairs": 500, "trimmed_share": 0.0},
                     {"pairs": 2000}]}
    lanes = pr.write_lanes(str(tmp_path / "r"), str(tmp_path / "g.fa"),
                           mix, 2 ** 40 + 1)
    roots = np.load(tmp_path / "r" / "roots.npy")
    assert len(roots) == 2500
    assert (roots[500:] != np.arange(500, 2500)).sum() == 200
    r1 = _records(lanes[0]["r1"]) + _records(lanes[1]["r1"])
    r2 = _records(lanes[0]["r2"]) + _records(lanes[1]["r2"])
    lengths = np.array([len(r[1]) for r in r1])
    assert (lengths[:500] == 100).all()
    short = lengths[500:] < 100
    # trimmed pairs drawn as 30% of the lane; PCR copies share them
    assert 0.25 < short.mean() < 0.35
    assert lengths.min() >= 40
    for i, (a, b) in enumerate(zip(r1, r2)):
        assert a[0] == b"@p%07d/1" % i and b[0] == b"@p%07d/2" % i
        assert a[3] == b[3] and len(a[1]) == len(b[1]) == len(a[3])
    # read 1 from the fragment's start, read 2 the reverse complement of
    # its end: each within 2 substitutions of the genome somewhere
    # frags.npy holds each fragment's true start and end, where they lie
    frags = np.load(tmp_path / "r" / "frags.npy")
    assert frags.shape == (2500, 2)
    for a, b, (start, end) in list(zip(r1, r2, frags))[:50]:
        s1, s2 = a[1], b[1].translate(comp)[::-1]
        p = _best(genome, s1)
        q = _best(genome, s2)
        assert p[1] <= 2 and q[1] <= 2
        at1 = genome[start:start + len(s1)]
        at2 = genome[end - len(s2):end]
        assert sum(x != y for x, y in zip(s1, at1)) <= 2
        assert sum(x != y for x, y in zip(s2, at2)) <= 2


def _best(genome, s):
    """(position, mismatches) of the best ungapped placement of s by its
    first 20 bases (exact seed)."""
    best = (-1, 99)
    for seed_at in (0, 40, len(s) - 20):
        k = s[seed_at:seed_at + 20]
        i = genome.find(k)
        while i != -1:
            p = i - seed_at
            mm = sum(x != y for x, y in zip(s, genome[p:p + len(s)]))
            best = min(best, (p, mm), key=lambda t: t[1])
            i = genome.find(k, i + 1)
    return best


def test_junction_share_is_exact(tmp_path):
    pr.write_genome(str(tmp_path / "g.fa"), 200_000, 4)
    genome = pr.read_genome(str(tmp_path / "g.fa")).tobytes()
    mix = {"mismatches_max": 0, "junction_share": 0.25,
           "lanes": [{"pairs": 400}]}
    lanes = pr.write_lanes(str(tmp_path / "r"), str(tmp_path / "g.fa"),
                           mix, 9)
    joined = 0
    for a in _records(lanes[0]["r1"]):
        joined += genome.find(a[1]) == -1
    assert joined == 100
