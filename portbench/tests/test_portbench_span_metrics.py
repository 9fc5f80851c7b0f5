"""The per-layer readers of the program's own spans and counters compute
their numbers from a recorded run whose HYBRID_PROFILE lines carry
`spans`, `counters` and `pass_s` (record_spans.json), and read nothing
from a program that prints no such keys."""

import json
import os

import pytest

from portbench.spec import Spec

from conftest import HERE

with open(os.path.join(HERE, "record_spans.json")) as f:
    RECORD = json.load(f)

WANT = {
    "records.read_share": (0.3 + 0.1) / (2.0 + 1.6),
    "records.emit_share": (0.2 + 0.3) / (2.0 + 1.6),
    "program.unspanned_share": (0.04 + 0.06) / (2.0 + 1.6),
    "program.unspanned_share.bed": (0.04 + 0.06) / (2.0 + 1.6),
    "hybrid.read_wait_ms_per_chunk": (0.06 + 0.09) * 1e3 / (30 + 30),
    "hybrid.group_mean": (30 + 35) / (8 + 7),
    "output.sort_share": (0.14 + 0.10) / (2.0 + 1.6),
    "output.write_share": (0.14 + 0.08) / (2.0 + 1.6),
}

# readers of the keys HYBRID_PROFILE printed before the spans, which the
# line keeps, derived from the spans and counters
LEGACY = {
    "hybrid.blocked_share": (0.1 + 0.1) / (1.0 + 1.0),
    "native.finish_ms_per_chunk": (0.6 + 0.6) * 1e3 / (20 + 20),
    "seeder.submit_ms_per_chunk": (0.2 + 0.2) * 1e3 / (20 + 20),
}


@pytest.mark.parametrize("name", sorted(WANT) + sorted(LEGACY))
def test_reader_on_the_record(name):
    want = {**WANT, **LEGACY}[name]
    assert Spec().reader(name).read(RECORD) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_in_an_empty_run(name):
    empty = {"passes": [], "trace": {}, "kernel_bytes": {}}
    assert Spec().reader(name).read(empty) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_in_a_profile_without_spans(name):
    """A program that prints HYBRID_PROFILE without spans and counters
    (the line before the program's tracer), or prints none in a pass,
    reads nothing, and raises nothing."""
    rec = json.loads(json.dumps(RECORD))
    for p in rec["passes"]:
        for key in ("spans", "counters", "pass_s"):
            del p["hybrid_profile"][key]
    rec["passes"].append({"hybrid_profile": None})
    assert Spec().reader(name).read(rec) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_skips_a_pass_without_a_profile(name):
    rec = json.loads(json.dumps(RECORD))
    rec["passes"].append({"hybrid_profile": None})
    assert Spec().reader(name).read(rec) == pytest.approx(WANT[name])
