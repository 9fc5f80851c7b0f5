"""The cell chip_dm6.pe100, `--preset chip` as published (`--low-mem`
on), at the CPU's size (conftest.py's tiny copy): a sound run comes out
correct, the control and the planted faults of test_portbench_run.py do
not, a traced run reports every per-layer metric of the cell, and the
cell's new readers compute their numbers from a recorded pass
(record_chip_spans.json) and read nothing where the program recorded
nothing.

The cell's host rates spread too widely on the card to bound them (over
half their bound of 0.25), so, as in bed_dm6.pe100, its end-to-end
metric is the card's kernel time and the host rates are per-layer
metrics (`program.*.chip`)."""

import json
import os

import pytest

import test_portbench_run as planted
from conftest import HERE
from portbench import harness
from portbench.harness import run_cell
from portbench.spec import Spec
from chromap_tpu_torch import pipeline
from chromap_tpu_torch.io import lowmem

CELL = "chip_dm6.pe100"

with open(os.path.join(HERE, "record_chip_spans.json")) as f:
    RECORD = json.load(f)

PASS_S = 10.0 + 9.0
WANT_SPANS = {
    "lowmem.spill_share": (0.5 + 0.4) / PASS_S,
    "lowmem.merge_share": (0.3 + 0.25) / PASS_S,
    "lowmem.merge_ns_per_row": (0.3 + 0.25) * 1e9 / (500000 + 500000),
    "records.pack_share": (0.8 + 0.7) / PASS_S,
    "records.read_share.chip": (4.0 + 3.5) / PASS_S,
}
# readers of the seeder's and engine's counts, of the device trace and of
# the passes after the profiled ones, which a profile without spans still
# carries
WANT_OTHER = {
    "hybrid.device_chunk_share.chip": (28 + 28) / (31 + 31),
    "device.idle_share.chip": 1 - 0.2 / 8.0,
    "program.reads_per_s.chip": 8e6 / 80.0,
    "program.core_s_per_mread.chip": 96.0 / 8.0,
}
WANT = {**WANT_SPANS, **WANT_OTHER}


def test_the_cell_reports_the_cards_kernel_time_and_setup():
    assert {m["name"] for m in Spec().metrics(CELL, False)} == {
        "device_kernel_ms_per_mread", "setup_s"}


def test_the_new_metrics_read_the_cell_alone():
    spec = Spec()
    assert set(WANT) <= {m["name"] for m in spec.metrics(CELL, True)}
    for m in spec.data["per_layer"]:
        if m["name"] in WANT:
            assert m["workloads"] == [CELL]
            assert m["moves"] == "device_kernel_ms_per_mread"


def test_sound_run_is_correct(tiny_root, monkeypatch):
    """The cell's passes take the records flow, the array spill and the
    native merge: never the full-native flow, never the per-record merge."""
    def no_full_native(self, engine):
        raise AssertionError("--preset chip took the full-native flow")

    def no_record_merge(self):
        raise AssertionError("the merge took the per-record path")
    monkeypatch.setattr(pipeline.MappingPipeline,
                        "_map_paired_end_full_native", no_full_native)
    monkeypatch.setattr(lowmem.TempMappingShard, "iterate", no_record_merge)
    result = planted.run(tiny_root, CELL)
    assert result["correct"], result["checks"]
    # on the CPU no kernel runs: the card's kernel time stays unread
    assert set(result["metrics"]) == {"setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_control_is_not_correct(tiny_root):
    spec = Spec(tiny_root)
    control = spec.config(spec.cell(CELL)["config"])["control"]
    assert control == {"remove_pcr_duplicates": False}
    result = planted.run(tiny_root, CELL, options=control)
    assert not result["correct"]


def _state_unchanged(monkeypatch):
    planted._after_warm(monkeypatch, pipeline.MappingPipeline,
                        "map_paired_end", lambda orig: lambda self: None)


FAULTS = {
    "state_unchanged": (_state_unchanged, {"missing"}),
    "half_the_batch_left_out": (
        lambda mp: planted._engine_outputs(mp, planted.ALL_CALLS,
                                           planted._drop_half),
        {"missing"}),
    "altered_answer": (
        lambda mp: planted._engine_outputs(mp, planted.DEVICE_CALLS,
                                           planted._move_one_base),
        {"missing", "differ"}),
    "inflated_mapq": (
        lambda mp: planted._engine_outputs(mp, planted.ALL_CALLS,
                                           planted._mapq_60),
        {"mapq_differ", "extra", "differ"}),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_caught(tiny_root, monkeypatch, fault):
    plant, caught_by = FAULTS[fault]
    plant(monkeypatch)
    result = planted.run(tiny_root, CELL)
    assert not result["correct"]
    assert planted.failed_checks(result) & caught_by


def test_traced_run_reports_every_per_layer_metric(tiny_root, monkeypatch):
    # one profiled pass, then untraced ones for the `program.` rates: a
    # window of several passes, so that one follows the profiled pass on
    # a loaded host too
    monkeypatch.setattr(harness, "TRACE_CAP_S", 0.0)
    spec = Spec(tiny_root)
    result = run_cell(spec, CELL, planted.SEED, 10.0, True, device="cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {
        m["name"] for m in spec.metrics(CELL, True)}
    assert 0 < result["metrics"]["lowmem.merge_share"]["value"] < 1
    assert result["metrics"]["lowmem.merge_ns_per_row"]["value"] > 0


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_the_record(name):
    assert Spec().reader(name).read(RECORD) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_in_an_empty_run(name):
    empty = {"passes": [], "trace": {}, "kernel_bytes": {}}
    assert Spec().reader(name).read(empty) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_profile_without_spans(name):
    """A program that prints HYBRID_PROFILE without spans and counters
    (the parent of the tracer), or none in a pass, gives the span and
    counter readers nothing to read, and raises nothing."""
    rec = json.loads(json.dumps(RECORD))
    for p in rec["passes"]:
        for key in ("spans", "counters", "pass_s"):
            del p["hybrid_profile"][key]
    rec["passes"].append({"hybrid_profile": None, "seeder": {},
                          "engine": {}})
    want = WANT_OTHER.get(name)
    got = Spec().reader(name).read(rec)
    assert got is None if want is None else got == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(WANT_SPANS))
def test_reader_finds_nothing_without_the_lowmem_counters(name):
    """A program whose spill and merge have spans but no counters (the
    parent of this cell) reads no rate per row, and every share."""
    rec = json.loads(json.dumps(RECORD))
    for p in rec["passes"]:
        p["hybrid_profile"]["counters"] = {
            k: v for k, v in p["hybrid_profile"]["counters"].items()
            if not k.startswith("lowmem.")}
    got = Spec().reader(name).read(rec)
    if name == "lowmem.merge_ns_per_row":
        assert got is None
    else:
        assert got == pytest.approx(WANT[name])
