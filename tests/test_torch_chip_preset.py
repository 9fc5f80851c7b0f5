"""`--preset chip` as chromap publishes it (`-l 2000
--remove-pcr-duplicates --low-mem --BED`) through the port's CLI with
`--device --torch-device cpu`: the records flow, the array spill and the
native merge with its PCR dedup. On tests/simulate.py's small genome,
with reads drawn as the benchmark's pe100 mix draws them (10% PCR
duplicates, spread over the whole file), its BED equals, byte for byte,
that of the same reads with `--low-mem` off (the full-native flow),
whether it spills once at the end or into several files that split PCR
families; the benchmark's plain reference (portbench/reference/check.py)
finds no fault in it; the tracer's low-memory counters agree with what
was spilled and written; and a native merge that fails is counted when
the per-record merge takes its place, with the same bytes."""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from simulate import write_simulated_dataset  # noqa: E402

from chromap_tpu_torch import cli, pipeline, tracing  # noqa: E402
from chromap_tpu_torch.io import lowmem  # noqa: E402
from chromap_tpu_torch.native import NativeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import check as refcheck  # noqa: E402
from portbench.traffic.paired_reads import write_lanes  # noqa: E402

PAIRS = 3000
SEED = 2 ** 33 + 14
CHIP = ["--preset", "chip"]
# the preset's flags without --low-mem
FULL_NATIVE = ["-l", "2000", "--remove-pcr-duplicates", "--BED"]
DEVICE_ARGS = ["--device", "--torch-device", "cpu",
               "--device-batch-size", "256", "-t", "2"]
# read batches of 600 pairs and a spill whenever more than 500 rows
# wait: a file for each of the five batches
READ_BATCH = 600
SMALL_BUDGET = "500"
SPILLS = {"derived": ([], 1),
          "spills": (["--read-batch-size", str(READ_BATCH)],
                     PAIRS // READ_BATCH)}
SEEDED = "Using CPU (plain torch) device seeding"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchchip")
    write_simulated_dataset(str(d), num_pairs=0)
    with open(ROOT / "portbench" / "traffic" / "pe100.json") as f:
        mix = json.load(f)
    mix["lanes"] = [{"pairs": PAIRS}]
    lanes = write_lanes(str(d / "reads"), str(d / "ref.fa"), mix, SEED)
    assert cli.parse_args_and_run(["-i", "-r", str(d / "ref.fa"),
                                   "-o", str(d / "index")]) == 0
    return d, lanes


def _map(d, lanes, name, flags, env=None, patches=()):
    """One in-process CLI run with the tracer on: its output's bytes, its
    pass's counters, and what the spill functions were handed."""
    out = d / name
    seen = {"files": 0, "rows": 0, "stashed": 0}
    spill = lowmem.spill_bed_arrays
    stash = pipeline.MappingPipeline._stash_bed_rows

    def spy_spill(cfg, chunks, num_refs, shard_paths, base=None):
        before = len(shard_paths)
        spill(cfg, chunks, num_refs, shard_paths, base)
        seen["files"] += len(shard_paths) - before
        seen["rows"] += sum(len(c[1]) for c in chunks)

    def spy_stash(self, rid_a, *args, **kwargs):
        seen["stashed"] += len(rid_a)
        return stash(self, rid_a, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tracing.SWITCH, "1")
        for key, value in (env or {}).items():
            mp.setenv(key, value)
        mp.setattr(lowmem, "spill_bed_arrays", spy_spill)
        mp.setattr(pipeline.MappingPipeline, "_stash_bed_rows", spy_stash)
        for owner, attr, value in patches:
            mp.setattr(owner, attr, value)
        log = io.StringIO()
        with contextlib.redirect_stderr(log):
            rc = cli.parse_args_and_run(
                ["-x", str(d / "index"), "-r", str(d / "ref.fa"),
                 "-1", lanes[0]["r1"], "-2", lanes[0]["r2"],
                 "-o", str(out)] + flags + DEVICE_ARGS)
    assert rc == 0, log.getvalue()
    assert SEEDED in log.getvalue(), log.getvalue()
    return {"out": out.read_bytes(), "seen": seen,
            "counters": tracing.last_pass()["counters"]}


@pytest.fixture(scope="module")
def runs(data):
    d, lanes = data

    def fail(*args, **kwargs):
        raise RuntimeError("planted failure of the native merge")
    # two of torch's threads, as the other tests' CLI subprocesses take
    # (OMP_NUM_THREADS=2): beside the other test workers, a pool of one
    # thread a core spends most of its time waiting for cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        runs = {"full_native": _map(d, lanes, "full.bed", FULL_NATIVE)}
        for case, (flags, _) in SPILLS.items():
            env = ({"CHROMAP_TPU_LOWMEM_MAX_RECORDS": SMALL_BUDGET}
                   if case == "spills" else None)
            runs[case] = _map(d, lanes, f"{case}.bed", CHIP + flags, env)
        runs["merge_failed"] = _map(
            d, lanes, "failed.bed", CHIP,
            patches=[(NativeEngine, "lowmem_merge_bed", fail)])
    finally:
        torch.set_num_threads(threads)
    return runs


def test_the_reads_hold_pcr_families_across_read_batches(data):
    d, lanes = data
    roots = np.load(Path(lanes[0]["r1"]).parent / "roots.npy")
    dup = np.flatnonzero(roots != np.arange(len(roots)))
    assert len(dup) > PAIRS // 20
    # a duplicate in another read batch, so in another spill file, than
    # the pair it copies
    assert np.any(dup // READ_BATCH != roots[dup] // READ_BATCH)


def test_full_native_flow_takes_no_spill(runs):
    run = runs["full_native"]
    assert run["seen"] == {"files": 0, "rows": 0, "stashed": 0}
    assert not any(k.startswith("lowmem.") for k in run["counters"])


@pytest.mark.parametrize("case", sorted(SPILLS))
def test_preset_chip_equals_the_full_native_flow(runs, case):
    run = runs[case]
    assert run["seen"]["files"] == SPILLS[case][1]
    assert run["out"] == runs["full_native"]["out"]
    assert run["out"].count(b"\n") > PAIRS // 2


@pytest.mark.parametrize("case", sorted(SPILLS))
def test_counters_agree_with_the_files(runs, case):
    run = runs[case]
    counters, seen = run["counters"], run["seen"]
    assert counters["chunks.dev"] > 0
    assert counters["lowmem.spills"] == seen["files"] == SPILLS[case][1]
    assert counters["lowmem.spill_rows"] == seen["rows"] == seen["stashed"]
    assert counters["lowmem.merge_rows_out"] == run["out"].count(b"\n")
    assert counters.get("lowmem.merge_per_record", 0) == 0


def test_failed_native_merge_is_counted_and_changes_nothing(runs):
    run = runs["merge_failed"]
    assert run["counters"]["lowmem.merge_per_record"] == 1
    assert run["out"] == runs["derived"]["out"]
    assert run["counters"]["lowmem.merge_rows_out"] == \
        run["out"].count(b"\n")


def test_plain_reference_finds_no_fault(data, runs):
    d, lanes = data
    with open(ROOT / "portbench" / "configs" / "chip_dm6.json") as f:
        conf = json.load(f)
    checks, info = refcheck.check(conf, str(d / "ref.fa"),
                                  str(d / "refindex"), lanes,
                                  str(d / "derived.bed"), SEED)
    assert info["compared"] > 0
    assert checks == {k: 0 for k in checks}, (checks, info)
