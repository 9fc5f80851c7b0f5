"""The `.pairs` spill as arrays against the spill of records. From the
same mapper output (the `out` arrays the native engine returns), the
array path (pipeline.py `_pairs_spill_chunk`, then io/lowmem.py
`spill_pairs_arrays`) and the record path (`_emit_pairs_records`, one
`PairsRecord` a mapping, then `spill_mappings`) write the same shard, byte
for byte: over rows that tie on the whole sort key (emit order holds),
read names of 0, 1 and 300 bytes, barcodes set and unset, several rids
of which some stay empty, an all-empty spill, and a custom rid rank under
which the end order leaves pos1 > pos2. Every case spills two batches at
once, as a spill after several batches does."""

from pathlib import Path

import numpy as np
import pytest

from chromap_tpu_torch import pipeline, tracing
from chromap_tpu_torch.config import MappingConfig
from chromap_tpu_torch.io import lowmem

CASES = {
    # name: (reference count, rids the ends take, name lengths, barcoded,
    #        rows a batch, rid rank or None for the natural order)
    "ties": (3, [0, 1, 2], [12], False, 40, None),
    "names_0_1_300": (3, [0, 1, 2], [0, 1, 300], False, 60, None),
    "barcodes_set": (4, [0, 1, 2, 3], [9, 17], True, 80, None),
    "barcodes_unset": (4, [0, 1, 2, 3], [9, 17], False, 80, None),
    "rids_some_empty": (8, [1, 4, 6], [5, 21], False, 90, None),
    "all_empty": (5, [0, 1], [7], False, 0, None),
    "custom_rank": (4, [0, 1, 2, 3], [11], True, 120, [2, 3, 0, 1]),
}
READS = 30  # reads a batch


def _batch(rng, first_id, rids, name_lens, barcoded, rows, ties):
    """One batch as _map_batch_native_pairs sees it after the hybrid."""
    names = [bytes(rng.integers(33, 127, size=name_lens[i % len(name_lens)],
                                dtype=np.uint8)) for i in range(READS)]
    # positions in a narrow range, so ends and whole sort keys meet
    rs1 = rng.integers(0, 60, size=rows).astype(np.uint32)
    rs2 = rng.integers(0, 60, size=rows).astype(np.uint32)
    out = {
        "read_id": (first_id + rng.integers(0, READS, size=rows))
        .astype(np.uint32),
        "rid": rng.choice(rids, size=rows).astype(np.int32),
        "rid2": rng.choice(rids, size=rows).astype(np.int32),
        "dir": rng.integers(0, 2, size=rows).astype(np.uint8),
        "dir2": rng.integers(0, 2, size=rows).astype(np.uint8),
        "rs1": rs1, "re1": rs1 + rng.integers(0, 5, size=rows).astype(
            np.uint32),
        "rs2": rs2, "re2": rs2 + rng.integers(0, 5, size=rows).astype(
            np.uint32),
        "mapq": rng.integers(0, 3, size=rows).astype(np.uint8),
        "uniq": rng.integers(0, 2, size=rows).astype(np.uint8),
    }
    if ties:
        # rows four times over each, told apart only by uniq (0, 1, 0, 1:
        # any other order of the four shows in the bytes)
        for key in out:
            if key != "uniq":
                out[key] = np.repeat(out[key][:rows // 4], 4)
        out["uniq"] = (np.arange(rows) % 2).astype(np.uint8)
    barcodes = (rng.integers(0, 2 ** 40, size=READS).tolist() if barcoded
                else None)
    read_ids = np.arange(first_id, first_id + READS, dtype=np.uint32)
    names, name_at = pipeline._blob(names)
    j = out["read_id"].astype(np.int64) - first_id
    return out, j, read_ids, names, name_at, barcodes


@pytest.mark.parametrize("case", sorted(CASES))
def test_array_spill_equals_record_spill(case, tmp_path, monkeypatch):
    num_refs, rids, name_lens, barcoded, rows, rank = CASES[case]
    rank = rank or list(range(num_refs))
    rng = np.random.default_rng(sorted(CASES).index(case))
    batches = [_batch(rng, first, rids, name_lens, barcoded, rows,
                      case == "ties") for first in (0, 1000)]

    on_refs = [[] for _ in range(num_refs)]
    chunks = []
    for batch in batches:
        pipeline._emit_pairs_records(
            *batch, rank, lambda rid, rec: on_refs[rid].append(rec))
        chunks.append(pipeline._pairs_spill_chunk(*batch, rank))
    records = [r for lst in on_refs for r in lst]
    assert len(records) == 2 * rows
    assert sum(map(len, (c[0] for c in chunks))) == 2 * rows
    if case == "custom_rank":
        assert any(r.pos1 > r.pos2 for r in records)
    if case == "names_0_1_300":
        assert {len(r.read_name) for r in records} == {0, 1, 300}

    cfg = MappingConfig()
    paths_rec, paths_arr = [], []

    @tracing.traced_pass
    def spill_both():
        lowmem.spill_mappings(cfg, on_refs, paths_rec,
                              base=str(tmp_path / "rec"))
        lowmem.spill_pairs_arrays(cfg, chunks, num_refs, paths_arr,
                                  base=str(tmp_path / "arr"))

    monkeypatch.setenv(tracing.SWITCH, "1")
    spill_both()
    # each path counts its rows
    assert tracing.last_pass()["counters"]["lowmem.spill_rows"] == 4 * rows
    shard = Path(paths_arr[0]).read_bytes()
    assert shard == Path(paths_rec[0]).read_bytes()
    assert shard[6] == (6 if rows else 0)


@pytest.mark.parametrize("bad", ["name_over_65535", "rid_out_of_range"])
def test_array_spill_refuses_what_a_shard_cannot_hold(bad, tmp_path):
    """A shard holds a name's length in a u16 and rows of the references
    it counts: the record path fails there (struct.error), so does this
    one, and writes no shard."""
    rng = np.random.default_rng(5)
    out, j, read_ids, names, name_at, _ = _batch(
        rng, 0, [0, 1], [70000 if bad == "name_over_65535" else 4],
        False, 10, False)
    chunk = pipeline._pairs_spill_chunk(out, j, read_ids, names, name_at,
                                        None, [0, 1])
    paths = []
    with pytest.raises(ValueError):
        lowmem.spill_pairs_arrays(
            MappingConfig(), [chunk], 1 if bad == "rid_out_of_range" else 2,
            paths, base=str(tmp_path / "arr"))
    assert paths == [] and not list(tmp_path.iterdir())
