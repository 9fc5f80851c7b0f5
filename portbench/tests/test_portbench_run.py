"""Whole runs of each cell on the CPU at a small size: sound, they come
out correct; with the timed path broken underneath, or with the control
in the program's place, `correct` comes out false.

The faults, planted in the port for the window's passes: a pass that
returns at once and leaves the output as it was (a step that returns its
state unchanged); every second pair of each chunk's answers dropped (half
of the batch left out); every device-seeded answer moved by one base (an
answer altered where it is produced); every answer's MAPQ set to 60
(multi-mappers and low-quality pairs reported as unique, the selection
and MAPQ layer altered). One-card cells have no exchange between chips
to leave out.

The control breaks one guarantee that the configuration states, the
cheaper step a later change might take: BED without PCR duplicate
removal, Hi-C without split alignment (kernel D and the 5' retry off).
On the card it runs at the cells' own size with `python3
portbench/control.py`.
"""

import numpy as np
import pytest

from portbench.harness import run_cell
from portbench.spec import Spec
from chromap_tpu_torch import native, pipeline

CELLS = ("bed_dm6.pe100", "hic_dm6.junction25")
SEED = 2 ** 33 + 5


def run(root, cell, options=None, seed=SEED):
    return run_cell(Spec(root), cell, seed, 0.5, False, device="cpu",
                    options=options)


def failed_checks(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result = run(tiny_root, cell)
    assert result["correct"], result["checks"]
    # on the CPU no kernel runs: a metric of the device trace stays unread
    assert set(result["metrics"]) == {
        m["name"] for m in Spec(tiny_root).metrics(cell, False)
        if m["source"] != "device_trace"}
    assert "setup_s" in result["metrics"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def _after_warm(monkeypatch, owner, attr, make):
    """Replace owner.attr by make(orig) from its second call on (the
    warm pass runs the sound program)."""
    orig = getattr(owner, attr)
    calls = {"n": 0}
    broken = make(orig)

    def wrapped(*a, **kw):
        calls["n"] += 1
        return (orig if calls["n"] == 1 else broken)(*a, **kw)
    monkeypatch.setattr(owner, attr, wrapped)


def _engine_outputs(monkeypatch, calls, change):
    """Apply change(out) to the answers of each engine call in `calls`,
    from the window on."""
    seen = {"warm_done": False}
    orig_pass = pipeline.MappingPipeline.map_paired_end

    def pass_(self):
        orig_pass(self)
        seen["warm_done"] = True
    monkeypatch.setattr(pipeline.MappingPipeline, "map_paired_end", pass_)
    for call in calls:
        orig = getattr(native.NativeEngine, call)

        def make(orig):
            def wrapped(eng, *a, **kw):
                res = orig(eng, *a, **kw)
                if seen["warm_done"]:
                    change(res[0])
                return res
            return wrapped
        monkeypatch.setattr(native.NativeEngine, call, make(orig))


ALL_CALLS = ("map_pairs_raw", "map_pairs_full_raw", "map_pairs_dev_seeded",
             "map_pairs_dev_seeded_full")
DEVICE_CALLS = ("map_pairs_dev_seeded", "map_pairs_dev_seeded_full")


def _drop_half(out):
    keep = out["read_id"] % 2 == 0
    for key in out:
        out[key] = out[key][keep]


def _mapq_60(out):
    out["mapq"][:] = 60


def _move_one_base(out):
    for key in ("start", "rs1"):
        if key in out:
            out[key] += 1


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_is_caught(tiny_root, cell, monkeypatch):
    _after_warm(monkeypatch, pipeline.MappingPipeline, "map_paired_end",
                lambda orig: lambda self: None)
    result = run(tiny_root, cell)
    assert not result["correct"]
    assert "missing" in failed_checks(result)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_caught(tiny_root, cell, monkeypatch):
    _engine_outputs(monkeypatch, ALL_CALLS, _drop_half)
    result = run(tiny_root, cell)
    assert not result["correct"]
    assert "missing" in failed_checks(result)


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_caught(tiny_root, cell, monkeypatch):
    _engine_outputs(monkeypatch, DEVICE_CALLS, _move_one_base)
    result = run(tiny_root, cell)
    assert not result["correct"]
    assert failed_checks(result) & {"missing", "differ"}


@pytest.mark.parametrize("cell", CELLS)
def test_inflated_mapq_is_caught(tiny_root, cell, monkeypatch):
    _engine_outputs(monkeypatch, ALL_CALLS, _mapq_60)
    result = run(tiny_root, cell)
    assert not result["correct"]
    assert failed_checks(result) & {"mapq_differ", "extra", "differ"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    spec = Spec(tiny_root)
    control = spec.config(spec.cell(cell)["config"])["control"]
    result = run(tiny_root, cell, options=control)
    assert not result["correct"]


def test_same_seed_same_reads(tiny_root):
    import json
    import os
    spec = Spec(tiny_root)
    from portbench.harness import ensure_genome, make_reads
    conf = spec.config("bed_dm6")
    data = os.path.join(spec.base, "_data")
    gdir = ensure_genome(data, conf["genome"], 2)
    mix = spec.mix("pe100")
    fasta = os.path.join(gdir, "ref.fa")
    read = []
    for sub, seed in (("a", 7), ("b", 7), ("c", 8)):
        lanes = make_reads(spec, os.path.join(data, sub), "c", mix, fasta,
                           seed)
        read.append(open(lanes[0]["r1"], "rb").read())
        if sub == "a":
            a, roots_a = lanes, np.load(os.path.join(
                os.path.dirname(lanes[0]["r1"]), "roots.npy"))
        elif sub == "b":
            roots_b = np.load(os.path.join(os.path.dirname(lanes[0]["r1"]),
                                           "roots.npy"))
        else:
            c = lanes
    assert read[0] == read[1] != read[2]
    assert json.dumps([x["pairs"] for x in a]) == json.dumps(
        [x["pairs"] for x in c])
    assert np.array_equal(roots_a, roots_b)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(tiny_root, cell, monkeypatch):
    from portbench import harness
    # one profiled pass, then untraced ones for the `program.` rates
    monkeypatch.setattr(harness, "TRACE_CAP_S", 0.0)
    spec = Spec(tiny_root)
    result = run_cell(spec, cell, SEED, 4.0, True, device="cpu")
    assert result["correct"], result["checks"]
    want = {m["name"] for m in spec.metrics(cell, True)}
    got = set(result["metrics"])
    # on the CPU no kernel runs: the device's numbers stay unread
    device_only = {n for n in want if "_roofline" in n
                   or n.startswith("library.")}
    assert got == want - device_only
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
