"""The port's measurement layer on the CPU, at small sizes: the `stop`
checkpoints of chromap_tpu_torch/ops/device_seed.py `_build_step` against
the JAX package's, and the bench and tools of chromap_tpu_torch/ run
under `--torch-device cpu` (the plain versions of the kernels), each to
its end: as `python -m`, or in this process where a test passes a size
that only a caller in the same process can set.

The checkpoint sums are compared at every stop but `kmer` and
`emission`: there the JAX program (use_pallas=False, its route on the
CPU) sums arrays that the port's fused kernel A never builds (`h`,
`strand`, `run` and the (B, L) emission plane of the unfused stages), so
the two programs keep different live outputs at those two stops. Every
other stop sums the same quantities in both programs and must agree
exactly (32-bit wrapping sums of integers)."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_device_seed import _simulate_reads  # noqa: E402
from test_torch_seed import _genome, _spliced_reads  # noqa: E402

from chromap_tpu.ops import device_seed as jds  # noqa: E402
from chromap_tpu_torch.index.index import build_index  # noqa: E402
from chromap_tpu_torch.ops import device_seed as tds  # noqa: E402
from chromap_tpu_torch.ops.u64 import from_numpy_u32  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="2")
E, MIN_SEEDS, F = 8, 2, (500, 1000)
B, L = 128, 100


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    ref_codes = _genome(7, 12000)
    index = build_index(ref_codes, 17, 7)
    seqs = [np.frombuffer(b"ACGTN", np.uint8)[g].tobytes() for g in ref_codes]
    return index, ref_codes, seqs


def _jax_stage_profile():
    spec = importlib.util.spec_from_file_location(
        "jax_device_stage_profile", ROOT / "tools" / "device_stage_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage_names_match_the_jax_tool():
    from chromap_tpu_torch.tools import stage_profile
    jax_stages = _jax_stage_profile().STAGES
    assert list(tds.STAGES) == jax_stages
    assert list(stage_profile.STAGES) == jax_stages
    with pytest.raises(ValueError):
        tds._build_step(17, 7, E, *F, MIN_SEEDS, 2, stop="verify")


def _port_call(seeder, rw, split: bool, stop):
    step = tds._build_step(seeder.k, seeder.w, seeder.e, seeder.f0,
                           seeder.f1, seeder.min_num_seeds, seeder.num_refs,
                           split, stop=stop)
    lengths = torch.full((B,), L, dtype=torch.int32)
    return step(from_numpy_u32(rw), lengths, *seeder._index_operands(),
                L=L, B=B, Mtot=tds.MZ_PER_READ * B,
                Htot=tds.HITS_PER_READ * B, captot=tds.CANDS_PER_READ * B)


@pytest.fixture(scope="module")
def bed_case(world):
    index, ref_codes, ref_seqs = world
    reads = _simulate_reads(ref_codes, np.random.default_rng(5), B, L)
    rw = tds._pack_reads(reads)
    port = tds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F, device="cpu")
    js = jds.DeviceSeeder(index, ref_seqs, E, MIN_SEEDS, F,
                          use_pallas=False)
    return rw, port, js


@pytest.mark.parametrize("stop", [s for s in tds.STAGES
                                  if s not in (None, "kmer", "emission")])
def test_stage_out_matches_jax(bed_case, stop):
    rw, port, js = bed_case
    sums, pad = _port_call(port, rw, False, stop)
    step = jds._build_step(js.k, js.w, js.e, js.f0, js.f1, js.min_num_seeds,
                           js.num_refs, False, stop=stop)
    jsums, _ = step(rw, np.full(B, L, np.int32), js.hash_keys, js.offcnt,
                    js.occurrences, js.ref_words, js.ref_nwords, js.ref_lens,
                    js.ref_offsets, L=L, B=B, Mtot=tds.MZ_PER_READ * B,
                    Htot=tds.HITS_PER_READ * B, captot=tds.CANDS_PER_READ * B)
    assert pad.shape == (1,)
    got = sums.numpy().astype(np.uint64)
    assert got.tolist() == np.asarray(jsums).astype(np.uint64).tolist()
    assert got.any()


@pytest.mark.parametrize("split", [False, True])
def test_every_stop_runs_and_none_is_the_download(world, split):
    """Every stop, in BED and split mode, returns its sums; stop=None
    returns the seeder's own download byte for byte."""
    index, ref_codes, ref_seqs = world
    reads = _spliced_reads(ref_codes, 5, B, L)
    rw = tds._pack_reads(reads)
    seeder = tds.DeviceSeeder(index, ref_seqs, 4 if split else E, MIN_SEEDS,
                              F, device="cpu", split=split)
    for stop in tds.STAGES[:-1]:
        sums, _ = _port_call(seeder, rw, split, stop)
        assert sums.dtype == torch.int64 and sums.ndim == 1
        assert int(sums.min()) >= 0 and int(sums.max()) < (1 << 32)
    dl, full = _port_call(seeder, rw, split, None)
    (want_dl, want_full, _, _), _, _ = seeder.submit_packed(rw, B, L)
    assert dl.numpy().tobytes() == want_dl.numpy().tobytes()
    assert full.numpy().tobytes() == want_full.numpy().tobytes()


# ---------------------------------------------------------------------
# the bench and the tools, run as a user runs them, on the CPU
# ---------------------------------------------------------------------

SET = ["--genome-core", "50000"]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _in_process(main, argv, **kw):
    """main(argv, **kw) in this process; (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv], **kw)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """The bench on a 2,000-pair set of a 50 kb genome core, on the CPU,
    in this process: one run per rate, and device chunks of 128 pairs so
    that both sets reach the seeder (the default 16,384-pair chunk would
    leave a set this small on the host, and the bench would fail)."""
    from chromap_tpu_torch import bench
    cache = tmp_path_factory.mktemp("torchbench") / "set"
    rc, out, err = _in_process(
        bench.main, ["--torch-device", "cpu", "--pairs", 2000, *SET,
                     "--cache", cache, "--runs", 1], batch=128)
    assert rc == 0, err[-3000:]
    return cache, out, err


def test_bench_prints_one_json_line(bench_run):
    cache, stdout, stderr = bench_run
    last = stdout.strip().splitlines()[-1]
    line = json.loads(last)
    assert len(_json_lines(stdout)) == 1
    extra = line["extra"]
    for key in ("host_only_reads_per_s", "host_mapped_only_reads_per_s",
                "device_reads_per_s", "small_host_reads_per_s",
                "small_dev_reads_per_s", "myers_band_cells_per_s",
                "vs_host_only"):
        assert extra[key] > 0, key
    assert line["unit"] == "reads/s" and line["metric"]
    assert line["value"] == extra["device_reads_per_s"]
    assert line["device"] == {"torch_device": "cpu"}
    assert extra["device_chunks"] >= 1 and extra["small_device_chunks"] >= 1
    assert "vs_baseline" not in line
    assert "reference_same_run_reads_per_s" not in extra
    assert "no reference chromap" in stderr
    for a, b in (("host", "dev"), ("small_host", "small_dev")):
        host = (cache / f"bench_{a}.bed").read_bytes()
        assert host and host == (cache / f"bench_{b}.bed").read_bytes()


def test_bench_on_cuda_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would not fail")
    res = subprocess.run(
        [sys.executable, "-m", "chromap_tpu_torch.bench", "--torch-device",
         "cuda", "--pairs", "2000", *SET, "--cache", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, env=ENV)
    assert res.returncode != 0
    assert not _json_lines(res.stdout)
    assert "torch.cuda is not available" in res.stderr
    assert not list(tmp_path.iterdir())         # failed before any work


TOOLS = {
    "stage_profile": ["--rows", 256, "--reps", 1],
    "stage_profile_split": ["--rows", 256, "--reps", 1, "--split"],
    "full_time": ["--rows", 256, "--reps", 1, "--stops", "cluster,probe"],
    "primitives": [],
    "bench_parity": [2000, 1, 128],
    "weak_scaling": ["--per-device-reads", 64, "--out", "{tmp}/scaling.json"],
}


@pytest.fixture(scope="module")
def tool_runs(bench_run, tmp_path_factory):
    """Every tool on the bench's set, on the CPU: each but bench_parity a
    `python -m` subprocess, all started at once, and bench_parity in this
    process meanwhile (its set's 50 kb genome core is not the bench's
    default); {name: (rc, (stdout, stderr))}."""
    from chromap_tpu_torch.tools import bench_parity
    cache, _, _ = bench_run
    tmp = tmp_path_factory.mktemp("tools")
    common = ["--cache", str(cache), "--torch-device", "cpu"]
    procs = {}
    for name, args in TOOLS.items():
        if name == "bench_parity":
            continue
        args = [str(a).format(tmp=tmp) for a in args]
        procs[name] = subprocess.Popen(
            [sys.executable, "-m",
             "chromap_tpu_torch.tools." + name.replace("_split", "")]
            + args + common, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)
    try:
        rc, out, err = _in_process(bench_parity.main,
                                   TOOLS["bench_parity"] + common,
                                   genome_core=50_000)
        runs = {"bench_parity": (rc, (out, err))}
        runs.update({name: (p.communicate(timeout=300), p.returncode)[::-1]
                     for name, p in procs.items()})
        return runs, tmp
    finally:
        for p in procs.values():
            p.kill()


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_on_the_cpu(tool_runs, name):
    runs, tmp = tool_runs
    rc, (out, err) = runs[name]
    assert rc == 0, err[-3000:]
    lines = _json_lines(out)
    assert lines[-1 if name == "bench_parity" else 0]["device"] == \
        {"torch_device": "cpu"}
    if name.startswith("stage_profile"):
        assert [r["stop"] for r in lines[1:]] == \
            [s or "FULL" for s in tds.STAGES]
        assert all(r["cum_ms"] > 0 and r["kernel_ms"] is None
                   for r in lines[1:])
        assert lines[0]["split"] == (name == "stage_profile_split")
    elif name == "full_time":
        assert [r["stop"] for r in lines[1:]] == ["probe", "cluster", "FULL"]
    elif name == "primitives":
        ops = [r["op"] for r in lines[1:]]
        assert len(ops) == 13 and ops[0].startswith("sort_u64 x")
        assert lines[0]["NK"] > 0
    elif name == "bench_parity":
        assert "parity: OK" in out and lines[-1]["parity"]
        assert lines[-1]["device_chunks"] >= 1
    else:
        rows = lines[1:]
        assert [r["devices"] for r in rows] == [1, 2, 4]
        assert max(r["weak_scaling_efficiency"] for r in rows) == 1.0
        saved = json.loads((tmp / "scaling.json").read_text())
        assert [r["devices"] for r in saved["results"]] == [1, 2, 4]
