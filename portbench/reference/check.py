"""What decides `correct`: a sample of the pass's read pairs, drawn from
the seed, mapped by the plain reference, held against the output file
that the port's last timed pass wrote.

BED with PCR duplicates removed keeps one line per fragment (chromosome,
start, end): of the pairs mapped there, the one with the highest MAPQ and
then the higher strand, with their number as its count. A line sums
pairs the sample may not hold, so the sample takes, besides pairs drawn
from the seed, every pair of their PCR families (the pairs that copy the
same drawn fragment) and every other pair whose true fragment, as the
generator drew it, starts and ends within 2 x NEAR bases of one of
theirs: the only pairs that can map to the same place. Against that,
each line of a sampled pair's fragment is compared exactly: present when
the sample's best MAPQ there reaches the threshold, with that MAPQ, the
sample's count and the strand of its best; and a sampled pair that the
reference leaves unmapped, tied or under the threshold must have no
line at any of its mappings, nor within NEAR bases of its true fragment,
that no pair of the sample accounts for. `.pairs` lines carry the read
name, so each sampled pair's line is compared whole. A pair with tied
best mappings may be reported as any of them. Besides, the whole output
is held to the guarantees of the configuration: sorted, one line per
fragment or read, nothing under the MAPQ threshold.

Every number is a count of lines or pairs at fault; each limit is 0.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np

from .config import MappingConfig, apply_preset
from .index import load_or_build, read_fasta
from .mapper import Read, ReferenceMapper

SAMPLE_PAIRS = 2000
NEAR = 10


def reference_config(conf: dict) -> MappingConfig:
    cfg = MappingConfig()
    if conf.get("preset"):
        apply_preset(cfg, conf["preset"])
    for key, value in conf.get("options", {}).items():
        setattr(cfg, key, value)
    return cfg


def near_pairs(frags: np.ndarray, centres: np.ndarray, radius: int
               ) -> np.ndarray:
    """Pair numbers whose true fragment starts and ends within `radius`
    bases of those of some row of `centres`."""
    order = np.argsort(frags[:, 0], kind="stable")
    starts = frags[order, 0]
    lo = np.searchsorted(starts, centres[:, 0] - radius, "left")
    hi = np.searchsorted(starts, centres[:, 0] + radius, "right")
    found = [np.empty(0, dtype=np.int64)]
    for end, a, b in zip(centres[:, 1], lo, hi):
        cand = order[a:b]
        found.append(cand[np.abs(frags[cand, 1] - end) <= radius])
    return np.unique(np.concatenate(found))


def draw(seed: int, roots: np.ndarray, frags: np.ndarray, families: bool
         ) -> Tuple[np.ndarray, np.ndarray]:
    """(the sampled pair numbers, the pairs to map): SAMPLE_PAIRS pairs
    drawn from the seed and, with `families`, every pair of the PCR
    family of each; to map besides, with `families`, every pair whose
    true fragment lies within 2 x NEAR bases of a sampled one's."""
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(roots), min(SAMPLE_PAIRS, len(roots)),
                      replace=False)
    if not families:
        pick = np.sort(pick)
        return pick, pick
    pick = np.flatnonzero(np.isin(roots, roots[pick]))
    near = near_pairs(frags, np.unique(frags[pick], axis=0), 2 * NEAR)
    return pick, np.union1d(pick, near)


def read_pairs(lanes: List[dict], wanted: np.ndarray
               ) -> Dict[int, Tuple[Read, Read]]:
    """The FASTQ records of the wanted pair numbers (lanes in order)."""
    out: Dict[int, Tuple[Read, Read]] = {}
    first = 0
    for lane in lanes:
        local = wanted[(wanted >= first) & (wanted < first + lane["pairs"])]
        if len(local):
            mates = []
            for path in (lane["r1"], lane["r2"]):
                with open(path, "rb") as f:
                    mates.append(f.read().split(b"\n"))
            for i in local:
                j = 4 * int(i - first)
                out[int(i)] = tuple(
                    Read(m[j][1:].split()[0], m[j + 1], m[j + 3], int(i))
                    for m in mates)
        first += lane["pairs"]
    return out


def pairs_line(rec, ref_names: List[bytes]) -> bytes:
    """A PairsRecord as the port's writer prints it (io/writers.py)."""
    return (rec.read_name + b"\t" + ref_names[rec.rid1] + b"\t"
            + str(rec.pos1 + 1).encode() + b"\t" + ref_names[rec.rid2]
            + b"\t" + str(rec.pos2 + 1).encode() + b"\t"
            + (b"+" if rec.strand1 > 0 else b"-") + b"\t"
            + (b"+" if rec.strand2 > 0 else b"-") + b"\tUU\t"
            + str(rec.mapq).encode() + b"\t" + str(rec.mapq).encode())


def _lines(path: str):
    """The output's lines; none when the pass left no output."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            yield from f


def compare_bed(path: str, ref_names: List[bytes],
                expected: Dict[int, list], sampled: np.ndarray,
                frags: np.ndarray, thr: int
                ) -> Tuple[Dict[str, int], Dict[str, int]]:
    rank = {n: i for i, n in enumerate(ref_names)}
    out: Dict[tuple, tuple] = {}
    unsorted = dup_lines = low = 0
    prev = None
    for line in _lines(path):
        c = line.rstrip(b"\n").split(b"\t")
        key = (c[0], int(c[1]), int(c[2]))
        order = (rank.get(c[0], -1), key[1], key[2])
        unsorted += prev is not None and order < prev
        prev = order
        dup_lines += key in out
        mapq = int(c[4])
        low += mapq < thr
        out[key] = (mapq, 1 if c[5] == b"+" else 0, int(c[6]))
    # the generator's fragments lie on the genome's one chromosome
    chrom = ref_names[0]
    lines = np.array(sorted(k[1:] for k in out if k[0] == chrom),
                     dtype=np.int64).reshape(-1, 2)

    def key(rid, r):
        return (ref_names[rid], r.start, r.start + r.length)
    members: Dict[tuple, List[Tuple[int, int]]] = {}
    tied = set()
    for recs in expected.values():
        if len(recs) == 1:
            members.setdefault(key(*recs[0]), []).append(
                (recs[0][1].mapq, recs[0][1].direction))
        elif recs and max(r.mapq for _, r in recs) >= thr:
            tied.update(key(*rec) for rec in recs)
    shown = {k for k, m in members.items()
             if max(q for q, _ in m) >= thr} | tied
    missing = mapq = count = strand = extra = compared = 0
    for i in sampled:
        recs = expected[int(i)]
        if len(recs) == 1 and recs[0][1].mapq >= thr:
            continue
        if recs and max(r.mapq for _, r in recs) >= thr:
            continue
        near = near_pairs(lines, frags[int(i)][None, :], NEAR)
        keys = {key(*rec) for rec in recs} | {
            (chrom, int(s), int(e)) for s, e in lines[near]}
        extra += any(k in out and k not in shown for k in keys)
    for k in {key(*expected[int(i)][0]) for i in sampled
              if len(expected[int(i)]) == 1} & shown - tied:
        compared += 1
        got = out.get(k)
        if got is None:
            missing += 1
            continue
        best = max(q for q, _ in members[k])
        mapq += got[0] != best
        count += got[2] != min(255, len(members[k]))
        strand += got[0] == best and got[1] != max(
            d for q, d in members[k] if q == best)
    checks = {"missing": missing, "mapq_differ": mapq,
              "count_differ": count, "strand_differ": strand,
              "extra": extra, "unsorted": unsorted,
              "dup_lines": dup_lines, "under_mapq": low}
    return checks, {"compared": compared, "tied_keys": len(tied),
                    "lines": len(out)}


def compare_pairs(path: str, ref_names: List[bytes],
                  expected: Dict[int, list], names: Dict[int, bytes],
                  thr: int) -> Tuple[Dict[str, int], Dict[str, int]]:
    rank = {n: i for i, n in enumerate(ref_names)}
    out: Dict[bytes, bytes] = {}
    unsorted = dup_lines = low = 0
    prev = None
    for line in _lines(path):
        if line.startswith(b"#"):
            continue
        line = line.rstrip(b"\n")
        c = line.split(b"\t")
        order = (rank.get(c[1], -1), rank.get(c[3], -1), int(c[2]),
                 int(c[4]))
        unsorted += prev is not None and order < prev
        prev = order
        dup_lines += c[0] in out
        low += int(c[8]) < thr
        out[c[0]] = line
    missing = differ = extra = compared = tied = 0
    for i, recs in expected.items():
        tied += len(recs) > 1
        allowed = {pairs_line(r, ref_names) for _, r in recs
                   if r.mapq >= thr}
        absent_ok = not recs or any(r.mapq < thr for _, r in recs)
        compared += bool(allowed)
        got = out.get(names[i])
        if got is None:
            missing += not absent_ok
        elif got not in allowed:
            if allowed:
                differ += 1
            else:
                extra += 1
    checks = {"missing": missing, "differ": differ, "extra": extra,
              "unsorted": unsorted, "dup_lines": dup_lines,
              "under_mapq": low}
    return checks, {"compared": compared, "tied": tied, "lines": len(out)}


def check(conf: dict, fasta: str, index_dir: str, lanes: List[dict],
          out_path: str, seed: int
          ) -> Tuple[Dict[str, int], Dict[str, object]]:
    """(numbers compared, each with limit 0; facts about the check). The
    lanes' directory holds the generator's roots.npy and frags.npy."""
    t0 = time.perf_counter()
    cfg = reference_config(conf)
    g = conf["genome"]
    records = read_fasta(fasta)
    ref_names = [n for n, _ in records]
    index = load_or_build(fasta, index_dir, g["kmer_size"],
                          g["window_size"])
    t_index = time.perf_counter() - t0
    truth = os.path.dirname(lanes[0]["r1"])
    frags = np.load(os.path.join(truth, "frags.npy"))
    sampled, mapped = draw(seed, np.load(os.path.join(truth, "roots.npy")),
                           frags, cfg.remove_pcr_duplicates)
    reads = read_pairs(lanes, mapped)
    mapper = ReferenceMapper(cfg, index, [s for _, s in records])
    expected = {i: mapper.map_pair(*reads[i]) for i in reads}
    if cfg.output_format == "bed" and cfg.remove_pcr_duplicates:
        checks, info = compare_bed(out_path, ref_names, expected, sampled,
                                   frags, cfg.mapq_threshold)
    elif cfg.output_format == "pairs":
        checks, info = compare_pairs(
            out_path, ref_names, expected,
            {i: r[0].name for i, r in reads.items()}, cfg.mapq_threshold)
    else:
        raise NotImplementedError(
            f"no comparison for {cfg.output_format} output")
    checks["compared_under_half"] = int(2 * info["compared"] < len(sampled))
    checks["output_absent"] = int(not os.path.exists(out_path))
    info.update(sampled=len(sampled), mapped=len(mapped), index_s=t_index,
                reference_s=time.perf_counter() - t0)
    return checks, info
