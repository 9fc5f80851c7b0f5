"""The port's batch engine (chromap_tpu_torch/batch/) against the JAX
package's on the same inputs: `myers_batch` on both of its routes (the
torch device, here the plain version on the CPU, and numpy) against
`banded_distance_batch_numpy`, the port's numpy copy, `traceback_batch`,
`BatchSeeder` and `BatchMapper.map_pairs` on simulated reads, and
`NativeEngine.map_pairs_device`. Then `--engine batch` through the port's
CLI, host and `--device --torch-device cpu`, against the reference
chromap goldens, and the engine rules around it. Every output is an
integer or a record of integers and strings: every comparison is exact."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from simulate import write_simulated_dataset  # noqa: E402

from chromap_tpu.batch import pipeline as jpipe  # noqa: E402
from chromap_tpu.batch import seeding as jseed  # noqa: E402
from chromap_tpu.batch import verify as jver  # noqa: E402
from chromap_tpu.ops import pallas_myers  # noqa: E402
from chromap_tpu_torch.batch import pipeline as tpipe  # noqa: E402
from chromap_tpu_torch.batch import seeding as tseed  # noqa: E402
from chromap_tpu_torch.batch import verify as tver  # noqa: E402
from chromap_tpu_torch.ops import myers as my  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="2")
B2C = np.frombuffer(b"ACGTN", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; torch's default of
    one thread per core in each worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(rng, n, L, e):
    """Reference windows (n, L+2e) and reads (n, L) as uint8 codes: exact
    and near copies (substitutions, an indel), N bases, unrelated reads."""
    pats = rng.integers(0, 4, (n, L + 2 * e)).astype(np.uint8)
    pats[rng.random(pats.shape) < 0.003] = 4
    texts = pats[:, e:e + L].copy()
    kind = np.arange(n) % 4
    edit = (rng.random((n, L)) < 0.03) & (kind == 1)[:, None]
    texts[edit] = rng.integers(0, 5, int(edit.sum()))
    for i in np.flatnonzero(kind == 2)[:200 if e else 0]:    # deletion
        q = int(rng.integers(1, L - 1))
        texts[i, q:] = pats[i, e + q + 1:e + L + 1]
    far = kind == 3
    texts[far] = rng.integers(0, 4, (int(far.sum()), L))
    return pats, texts


@pytest.mark.parametrize("e", [0, 4, 8, 15])
@pytest.mark.parametrize("L", [30, 100, 150])
@pytest.mark.parametrize("n", [1, 4095, 4096, 5000])
def test_myers_batch_matches_jax(n, L, e):
    """Both routes of the port's `myers_batch` against the JAX numpy
    reference; the device route is taken from 4,096 candidates on."""
    rng = np.random.default_rng(n + 7 * L + e)
    pats, texts = _batch(rng, n, L, e)
    want = pallas_myers.banded_distance_batch_numpy(pats, texts, e)
    tver.myers_batch.calls = {"device": [], "numpy": []}
    for device in ("cpu", None):
        before = my.myers.launches
        got = tver.myers_batch(pats, texts, e, device)
        assert my.myers.launches == before       # the CPU runs no kernel
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    on_device = n >= tver.MIN_DEVICE_BATCH
    assert tver.myers_batch.calls == {
        "device": [n] if on_device else [],
        "numpy": [n] if on_device else [n, n]}
    if n > 1:
        assert (want[0] <= e).any() and (want[0] > e).any()


@pytest.mark.parametrize("e", [0, 3, 15])
def test_numpy_copy_matches_jax(e):
    """The port's copy of `banded_distance_batch_numpy`, with codes
    outside 0..4 on both sides."""
    rng = np.random.default_rng(40 + e)
    pats, texts = _batch(rng, 777, 61, e)
    pats[rng.random(pats.shape) < 0.01] = 7
    texts[rng.random(texts.shape) < 0.01] = 9
    got = my.banded_distance_batch_numpy(pats, texts, e)
    want = pallas_myers.banded_distance_batch_numpy(pats, texts, e)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_banded_distance_batch_needs_the_asked_for_device():
    """The entry runs on CUDA unless the caller asks for the CPU; without
    a card, asking for CUDA raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pats, texts = _batch(np.random.default_rng(1), 8, 30, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        my.banded_distance_batch(pats, texts, 2)
    got = my.banded_distance_batch(pats, texts, 2, device="cpu")
    want = pallas_myers.banded_distance_batch_numpy(pats, texts, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("e", [2, 8])
def test_traceback_batch_matches_jax(e):
    """Start recovery of the reported mappings: zero-error, Hamming and
    reverse-Myers rows, raw bytes with lower case."""
    rng = np.random.default_rng(60 + e)
    L, n = 80, 3000
    pats, texts = _batch(rng, n, L, e)
    # reads that start off the band's centre: shifted windows, some with
    # a substitution
    shift = rng.integers(-e, e + 1, n)
    for i in range(0, n, 3):
        texts[i] = pats[i, e + shift[i]:e + shift[i] + L]
        if i % 2:
            texts[i, rng.integers(0, L)] = rng.integers(0, 4)
    err, _ = pallas_myers.banded_distance_batch_numpy(pats, texts, e)
    keep = err <= e
    pats, texts, err = pats[keep], texts[keep], err[keep]
    pat_raw = B2C[pats].copy()
    pat_raw[rng.random(pat_raw.shape) < 0.01] += 32     # lower case
    txt_raw = B2C[texts]
    got = tver.traceback_batch(e, err, pats, texts, pat_raw, txt_raw, L)
    want = jver.traceback_batch(e, err, pats, texts, pat_raw, txt_raw, L)
    np.testing.assert_array_equal(got, want)
    assert (err == 0).any() and (err > 0).any()
    assert len(np.unique(got)) > 2


@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("simbatch")
    write_simulated_dataset(str(d))
    subprocess.run([sys.executable, "-m", "chromap_tpu_torch.cli", "-i",
                    "-r", f"{d}/ref.fa", "-o", f"{d}/index"],
                   check=True, capture_output=True, cwd=ROOT, env=ENV)
    return d


def _pipeline(pkg: str, d, engine="batch", **kw):
    """The package's MappingPipeline on the simulated set (host, batch
    engine by default) and its first 600 pairs as that package's
    records."""
    import importlib
    config = importlib.import_module(f"{pkg}.config")
    pipeline = importlib.import_module(f"{pkg}.pipeline")
    fastx = importlib.import_module(f"{pkg}.io.fastx")
    cfg = config.MappingConfig(
        reference_file_path=f"{d}/ref.fa", index_file_path=f"{d}/index",
        read_file1_paths=[f"{d}/r1.fq"], read_file2_paths=[f"{d}/r2.fq"],
        mapping_output_file_path=f"{d}/unused.bed", engine=engine, **kw)
    pipe = pipeline.MappingPipeline(cfg)
    reads = [fastx.MultiFileFastxStream([f"{d}/r{i}.fq"]).read_batch(600)
             for i in (1, 2)]
    return cfg, pipe, reads


def test_batch_seeder_matches_jax(sim_data):
    """BatchSeeder over the minimizers of 600 pairs' reads: every array
    of BatchCandidates equals the JAX seeder's."""
    from chromap_tpu.ops import minimizer_vector as jmv
    from chromap_tpu_torch.ops import minimizer_vector as tmv
    _, jp, (j1, j2) = _pipeline("chromap_tpu", sim_data)
    _, tp, (t1, t2) = _pipeline("chromap_tpu_torch", sim_data)
    k, w = tp.index.kmer_size, tp.index.window_size
    jbm = jmv.batch_extract_minimizer_arrays(
        [r.codes() for r in j1 + j2], k, w)
    tbm = tmv.batch_extract_minimizer_arrays(
        [r.codes() for r in t1 + t2], k, w)
    args = (8, 2, (500, 1000))
    want = jseed.BatchSeeder(jp.index, *args).generate(jbm, 1200)
    got = tseed.BatchSeeder(tp.index, *args).generate(tbm, 1200)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.pos_positions.size and got.neg_positions.size


@pytest.mark.parametrize("device", [None, "cpu"])
def test_batch_mapper_matches_jax(sim_data, device):
    """BatchMapper.map_pairs on 600 pairs: the emitted records equal the
    JAX mapper's, in order; with `device` the Myers batch runs through
    kernel B's plain version."""

    def run(pkg, mapper_mod, **kw):
        import importlib
        rng_mod = importlib.import_module(f"{pkg}.mapping.rng")
        cfg, pipe, (r1, r2) = _pipeline(pkg, sim_data, **kw)
        mapper = mapper_mod.BatchMapper(
            cfg, pipe.index, pipe.ref_seqs, pipe.ref_lengths, pipe.selector,
            pipe.candidate_generator, pipe.draft_generator)
        out = []
        mapper.map_pairs(r1, r2, rng_mod.MT19937(11),
                         lambda rid, rec: out.append(
                             (rid, type(rec).__name__,
                              dataclasses.astuple(rec))),
                         trim=False)
        return out, mapper

    want, _ = run("chromap_tpu", jpipe)
    kw = ({} if device is None
          else dict(use_device=True, torch_device=device))
    tver.myers_batch.calls = {"device": [], "numpy": []}
    got, mapper = run("chromap_tpu_torch", tpipe, **kw)
    assert got == want and len(got) > 500
    # 600 pairs hold fewer than 4,096 candidates: numpy on both routes
    assert tver.myers_batch.calls["device"] == []
    assert mapper.device == device
    assert mapper.seconds["total"] >= mapper.seconds["seed"] > 0


def _map(d, out, extra, env=ENV):
    args = [sys.executable, "-m", "chromap_tpu_torch.cli",
            "-x", f"{d}/index", "-r", f"{d}/ref.fa",
            "-1", f"{d}/r1.fq", "-2", f"{d}/r2.fq", "-o", str(out)] + extra
    return subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                          env=env)


CASES = [
    ("sim_default.bed", []),
    ("sim_chip.bed", ["-l", "2000", "--remove-pcr-duplicates"]),
    ("sim_n3.bed", ["-n", "3", "-q", "0"]),
    ("sim_alloc.bed", ["--allocate-multi-mappings", "-q", "0"]),
]
DEVICE_ARGS = ["--device", "--torch-device", "cpu"]


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("golden,extra", CASES, ids=[c[0] for c in CASES])
def test_cli_batch_engine_matches_golden(sim_data, golden_dir, tmp_path,
                                         golden, extra, device):
    out = tmp_path / golden
    res = _map(sim_data, out, ["--engine", "batch"] + extra
               + (DEVICE_ARGS if device else []))
    assert res.returncode == 0, res.stderr
    line = "Using CPU (plain torch) Myers verification (batch engine)"
    assert (line in res.stderr) == device, res.stderr
    assert "Batch engine time:" in res.stderr
    assert out.read_bytes() == (golden_dir / golden).read_bytes()


def test_engine_rules(sim_data, golden_dir, tmp_path):
    """A native engine that fails to load hands a host run to the batch
    engine (as in the JAX package) but fails a --device run; --engine
    per_read --device raises; CUDA without a card fails before mapping."""
    no_native = dict(ENV, CHROMAP_TPU_NO_NATIVE="1")
    out = tmp_path / "fallback.bed"
    res = _map(sim_data, out, [], env=no_native)
    assert res.returncode == 0, res.stderr
    assert "falling back to batch engine" in res.stderr
    assert out.read_bytes() == \
        (golden_dir / "sim_default.bed").read_bytes()
    for extra, env in ((DEVICE_ARGS, no_native),
                       (["--engine", "per_read"] + DEVICE_ARGS, ENV)):
        res = _map(sim_data, tmp_path / "refused.bed", extra, env=env)
        assert res.returncode != 0
        assert "--device needs the native engine" in res.stderr
    if not torch.cuda.is_available():
        out = tmp_path / "cuda.bed"
        res = _map(sim_data, out, ["--engine", "batch", "--device",
                                   "--torch-device", "cuda"])
        assert res.returncode != 0
        assert "CUDA device requested" in res.stderr
        assert "Mapped" not in res.stderr
        assert not out.exists() or out.stat().st_size == 0


@pytest.mark.parametrize("device", [None, "cpu"])
def test_map_pairs_device_matches_jax(sim_data, device):
    """NativeEngine.map_pairs_device on 2,000 pairs: C++ collects the
    work, the Myers batch runs on `device` (None: numpy), C++ finishes;
    the arrays and stats equal the JAX engine's with use_pallas=False."""
    from chromap_tpu.native import _ptr as jptr
    from chromap_tpu_torch.native import _ptr
    from chromap_tpu_torch.utils import encode_sequence
    res = []
    for pkg, ptr in (("chromap_tpu", jptr), ("chromap_tpu_torch", _ptr)):
        _, pipe, _ = _pipeline(pkg, sim_data, engine="auto")
        engine = pipe._native_engine
        reads = []
        for i in (1, 2):
            with open(f"{sim_data}/r{i}.fq", "rb") as f:
                seqs = f.read().split(b"\n")[1::4][:2000]
            off = np.zeros(len(seqs) + 1, dtype=np.int64)
            np.cumsum([len(s) for s in seqs], out=off[1:])
            reads += [b"".join(seqs), off]
        ref_codes = np.concatenate([encode_sequence(s)
                                    for s in pipe.ref_seqs])
        call = (reads[0], ptr(reads[1]), reads[2], ptr(reads[3]), 2000,
                0, 0, ref_codes)
        if pkg == "chromap_tpu":
            res.append(engine.map_pairs_device(*call, use_pallas=False))
        else:
            res.append(engine.map_pairs_device(*call, device=device))
    (want, wstats), (got, gstats) = res
    np.testing.assert_array_equal(gstats, wstats)
    assert got.keys() == want.keys() and len(got["rid"]) > 1000
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
