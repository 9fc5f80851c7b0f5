"""The port's main path end to end on the CPU: `python -m
chromap_tpu_torch.cli --device --torch-device cpu` maps the 5000-pair
simulated set through the plain versions of the kernels, and its BED must
byte-match the reference chromap golden (which the JAX package's device
path matches too). The Hi-C flow (`--preset hic`: split alignment, pairs
output, low-memory mode) goes through the split seeder the same way and
must byte-match its goldens, plain, with `--chr-order` /
`--pairs-natural-chr-order`, and barcoded, its `.pairs` rows kept as
arrays up to the spill file. Also pinned: thread-count
invariance, that a device failure raises instead of mapping on the host,
that CUDA without a card raises, that `--mesh-devices 0` is one device
on the CPU, that runs beyond the step's packed-candidate format fail
before any output, and that the package neither imports nor needs JAX or
the JAX package (on the device path and through the batch engine)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from simulate import (write_simulated_barcodes,  # noqa: E402
                      write_simulated_dataset,
                      write_simulated_multichrom_dataset)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "chromap_tpu_torch"
DEVICE_ARGS = ["--device", "--torch-device", "cpu",
               "--device-batch-size", "512"]
# the CLI subprocesses get the same two torch threads as the fixture below
ENV = dict(os.environ, OMP_NUM_THREADS="2")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; torch's default of
    one thread per core in each worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("simtorch")
    write_simulated_dataset(str(d))
    write_simulated_barcodes(str(d))
    for pkg, name in (("chromap_tpu_torch", "index"),
                      ("chromap_tpu", "index_jax")):
        subprocess.run([sys.executable, "-m", f"{pkg}.cli", "-i",
                        "-r", f"{d}/ref.fa", "-o", f"{d}/{name}"],
                       check=True, capture_output=True, cwd=ROOT, env=ENV)
    return d


@pytest.fixture(scope="module")
def mc_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("simtorchmc")
    write_simulated_multichrom_dataset(str(d))
    subprocess.run([sys.executable, "-m", "chromap_tpu_torch.cli", "-i",
                    "-r", f"{d}/ref.fa", "-o", f"{d}/index"],
                   check=True, capture_output=True, cwd=ROOT, env=ENV)
    return d


# runs the CLI with the tracer on, then prints how many PairsRecords the
# run made
COUNT_PAIRS_RECORDS = (
    "import sys\n"
    "from chromap_tpu_torch import cli\n"
    "from chromap_tpu_torch.mapping.records import PairsRecord\n"
    "made, init = [], PairsRecord.__init__\n"
    "def counted(self, *args, **kwargs):\n"
    "    made.append(1)\n"
    "    init(self, *args, **kwargs)\n"
    "PairsRecord.__init__ = counted\n"
    "rc = cli.parse_args_and_run(sys.argv[1:])\n"
    "print(f'PAIRS_RECORDS {len(made)}', file=sys.stderr)\n"
    "sys.exit(rc)\n")


def _map(d, out, extra, ref=None, index=None, count_pairs_records=False):
    args = ([sys.executable, "-c", COUNT_PAIRS_RECORDS]
            if count_pairs_records
            else [sys.executable, "-m", "chromap_tpu_torch.cli"]) + [
        "-x", str(index or f"{d}/index"), "-r", str(ref or f"{d}/ref.fa"),
        "-1", f"{d}/r1.fq", "-2", f"{d}/r2.fq", "-o", str(out)] + extra
    env = dict(ENV, CHROMAP_TPU_HYBRID_PROFILE="1") if count_pairs_records \
        else ENV
    return subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                          env=env)


def test_port_index_file_matches_jax_cli(sim_data):
    assert (sim_data / "index").read_bytes() == \
        (sim_data / "index_jax").read_bytes()


def test_cli_device_cpu_matches_golden(sim_data, golden_dir, tmp_path):
    out = tmp_path / "dev.bed"
    res = _map(sim_data, out, DEVICE_ARGS)
    assert res.returncode == 0, res.stderr
    assert "Using CPU (plain torch) device seeding" in res.stderr
    assert out.read_bytes() == (golden_dir / "sim_default.bed").read_bytes()


HIC_CASES = [
    ("sim_hic.pairs", "sim_data", ["--preset", "hic"]),
    ("sim_chrorder.pairs", "mc_data",
     ["--preset", "hic", "--chr-order", "{d}/chr_order.txt",
      "--pairs-natural-chr-order", "{d}/chr_order2.txt"]),
    ("sim_bc.pairs", "sim_data",
     ["--preset", "hic", "-b", "{d}/bc.fq",
      "--barcode-whitelist", "{d}/whitelist.txt"]),
]


@pytest.mark.parametrize("golden,data,extra", HIC_CASES,
                         ids=[c[0] for c in HIC_CASES])
def test_cli_hic_device_cpu_matches_golden(golden, data, extra, request,
                                           golden_dir, tmp_path):
    """Split alignment on the device path: drop-off Myers and the 5'-gap
    retry per candidate, the split download, the pairs records flow with
    its rows kept as arrays up to the spill file (one
    records.pairs_array_batches a batch that held reads, no PairsRecord
    made) and the native merge."""
    d = request.getfixturevalue(data)
    out = tmp_path / golden
    res = _map(d, out, [a.format(d=d) for a in extra] + DEVICE_ARGS,
               count_pairs_records=True)
    assert res.returncode == 0, res.stderr
    assert "Using CPU (plain torch) device seeding" in res.stderr
    assert out.read_bytes() == (golden_dir / golden).read_bytes()
    (line,) = [json.loads(text.split(" ", 1)[1])
               for text in res.stderr.splitlines()
               if text.startswith("HYBRID_PROFILE ")]
    counters = line["counters"]
    assert counters["records.pairs_array_batches"] == \
        line["spans"]["records.read"][0] - 1
    assert "lowmem.merge_per_record" not in counters
    assert "PAIRS_RECORDS 0" in res.stderr.splitlines()


def test_cli_device_threads_invariant(sim_data, tmp_path):
    outs = {}
    for t in ("1", "3"):
        out = tmp_path / f"t{t}.bed"
        res = _map(sim_data, out, ["-t", t, "-n", "4"] + DEVICE_ARGS)
        assert res.returncode == 0, res.stderr
        outs[t] = out.read_bytes()
    assert outs["1"] == outs["3"] and outs["1"]


def test_device_failure_raises(sim_data, tmp_path, monkeypatch):
    """A failing dispatch is an error, never a silent host run."""
    from chromap_tpu_torch.config import MappingConfig
    from chromap_tpu_torch.ops import device_seed
    from chromap_tpu_torch.pipeline import MappingPipeline

    calls = {"n": 0}
    orig = device_seed.DeviceSeeder.submit_packed

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected device failure")
        return orig(self, *a, **kw)

    monkeypatch.setattr(device_seed.DeviceSeeder, "submit_packed", flaky)
    d = sim_data
    cfg = MappingConfig(
        reference_file_path=f"{d}/ref.fa", index_file_path=f"{d}/index",
        read_file1_paths=[f"{d}/r1.fq"], read_file2_paths=[f"{d}/r2.fq"],
        mapping_output_file_path=str(tmp_path / "flaky.bed"),
        use_device=True, torch_device="cpu", device_batch_size=512)
    with pytest.raises(RuntimeError, match="injected device failure"):
        MappingPipeline(cfg).map_paired_end()
    assert calls["n"] == 2


def test_cuda_without_card_raises(sim_data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "cuda.bed"
    res = _map(sim_data, out, ["--device", "--torch-device", "cuda"])
    assert res.returncode != 0
    assert "CUDA device requested" in res.stderr
    assert not out.exists() or out.stat().st_size == 0


def test_mesh_devices_zero_is_every_cpu_device(sim_data, golden_dir,
                                               tmp_path):
    """--mesh-devices 0 means every visible device of the type, as in the
    JAX package; on the CPU that is one, so no mesh is built."""
    out = tmp_path / "mesh0.bed"
    res = _map(sim_data, out, DEVICE_ARGS + ["--mesh-devices", "0"])
    assert res.returncode == 0, res.stderr
    assert "Using CPU (plain torch) device seeding + verification." \
        in res.stderr
    assert "data mesh" not in res.stderr
    assert out.read_bytes() == (golden_dir / "sim_default.bed").read_bytes()


@pytest.mark.parametrize("many_refs,bound", [
    (False, "max seed frequency <= 4000"),
    (True, "< 16384 reference sequences")],
    ids=["max-seed-frequency", "reference-sequences"])
def test_device_bounds_fail_before_mapping(many_refs, bound, sim_data,
                                           tmp_path):
    """A --device run beyond the step's packed-candidate format -- -f
    500,5000, or a reference of 16,384 sequences (rids need 15 bits) --
    fails when the reference is loaded, before any output."""
    d = sim_data
    ref, index, extra = f"{d}/ref.fa", f"{d}/index", ["-f", "500,5000"]
    if many_refs:
        ref, index, extra = tmp_path / "many.fa", tmp_path / "many.idx", []
        rng = np.random.default_rng(1)
        ref.write_text("".join(
            f">s{i}\n{''.join('ACGT'[c] for c in row)}\n"
            for i, row in enumerate(rng.integers(0, 4, (1 << 14, 24)))))
        subprocess.run([sys.executable, "-m", "chromap_tpu_torch.cli", "-i",
                        "-r", str(ref), "-o", str(index)], check=True,
                       capture_output=True, cwd=ROOT, env=ENV)
    out = tmp_path / "bound.bed"
    res = _map(d, out, extra + DEVICE_ARGS, ref=ref, index=index)
    assert res.returncode != 0
    assert bound in res.stderr, res.stderr
    assert "Mapped" not in res.stderr
    assert not out.exists() or out.stat().st_size == 0


def test_port_runs_without_jax(sim_data, golden_dir, tmp_path):
    """With `jax` and `chromap_tpu` unimportable, the port still builds
    its index and maps the set through the device path, and through the
    batch engine with its Myers batch on the device."""
    d = sim_data
    outs = [tmp_path / "nojax.bed", tmp_path / "nojax_batch.bed"]
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['chromap_tpu'] = None\n"
        "sys.argv = ['chromap_tpu_torch.cli'] + sys.argv[1:]\n"
        "runpy.run_module('chromap_tpu_torch.cli', run_name='__main__')\n")
    maps = [["-x", str(tmp_path / "idx"), "-r", f"{d}/ref.fa",
             "-1", f"{d}/r1.fq", "-2", f"{d}/r2.fq", "-o", str(out)]
            + DEVICE_ARGS for out in outs]
    maps[1] += ["--engine", "batch"]
    for args in [["-i", "-r", f"{d}/ref.fa", "-o", str(tmp_path / "idx")]] \
            + maps:
        res = subprocess.run([sys.executable, "-c", code] + args,
                             capture_output=True, text=True, cwd=ROOT,
                             env=ENV)
        assert res.returncode == 0, res.stderr
    assert "Using CPU (plain torch) Myers verification (batch engine)" \
        in res.stderr
    for out in outs:
        assert out.read_bytes() == \
            (golden_dir / "sim_default.bed").read_bytes()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 30
    bad = []
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "chromap_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {name}")
        text = f.read_text()
        for needle in ("import jax", "from jax", "chromap_tpu.",
                       "from chromap_tpu "):
            if needle in text.replace("chromap_tpu_torch", ""):
                bad.append(f"{f.relative_to(ROOT)}: text {needle!r}")
    assert not bad, bad
