"""The port's data mesh (chromap_tpu_torch/parallel/sharding.py and
`MeshSeeder` in ops/device_seed.py) against the JAX package on the CPU,
where a mesh is n entries of the one CPU device, as JAX's are n virtual
CPU devices (tests/conftest.py gives JAX eight). Every output is an
integer, so every comparison is exact:

- `sharded_myers` over 8 shards against JAX's on its 8-device mesh;
- `MeshSeeder` over 2 and 4 shards against the port's `DeviceSeeder`
  and JAX's `MeshSeeder`, in BED and in split mode; with no candidate in
  the capped downloads (every shard read from its `full` stream); with
  one shard over its flat budget (the whole chunk goes to the host); and
  with a batch whose rows do not split (the single-device step, counted);
- through the CLI: `--mesh-devices 2` maps the BED and Hi-C goldens and
  logs the mesh; a 2-shard pipeline run equals the host-only run (the
  port's counterpart of __graft_entry__.dryrun_multichip); a mesh wider
  than the visible cards fails before any mapping; and the two-shard
  `--num-shards` map and `--merge-shards` of tests/test_sharding.py."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from simulate import write_simulated_dataset  # noqa: E402
from test_device_seed import _simulate_reads, _to_seq  # noqa: E402
from test_torch_seed import _genome, _spliced_reads  # noqa: E402

from chromap_tpu.ops import device_seed as jds  # noqa: E402
from chromap_tpu.ops.pallas_myers import \
    banded_distance_batch_numpy  # noqa: E402
from chromap_tpu.parallel import sharding as jsh  # noqa: E402
from chromap_tpu_torch.index.index import build_index  # noqa: E402
from chromap_tpu_torch.ops import device_seed as tds  # noqa: E402
from chromap_tpu_torch.parallel import sharding as tsh  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="2")
MIN_SEEDS, F = 2, (500, 1000)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite's workers share the machine's cores; torch's default of
    one thread per core in each worker would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_world():
    """test_torch_seed.py's reference: one sequence whose 200-base repeat
    occurs four times, and one of 4000 bases."""
    ref_codes = _genome(7, 12000)
    index = build_index(ref_codes, 17, 7)
    return index, ref_codes, [_to_seq(g) for g in ref_codes]


def _flat(res):
    """A resolve tuple with split mode's (cand_meta, cand_split) flattened."""
    meta, pos, cmeta, over = res
    return [meta, pos] + (list(cmeta) if isinstance(cmeta, tuple)
                          else [cmeta]) + [over]


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) and got[-1] == want[-1]
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------
# sharded_myers and make_data_mesh
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n_dev,e,L", [(8, 4, 40), (2, 8, 100)])
def test_sharded_myers_matches_jax(n_dev, e, L):
    """tests/test_sharding.py's case (and one at the BED path's e and L):
    the port over n CPU shards against JAX over n virtual CPU devices."""
    import jax
    assert len(jax.devices()) >= n_dev
    n = 16 * n_dev
    rng = np.random.default_rng(0)
    pats = rng.integers(0, 4, (n, L + 2 * e)).astype(np.uint8)
    txts = pats[:, e:e + L].copy()
    for i in range(0, n, 2):
        txts[i, rng.integers(0, L)] = (txts[i, 0] + 1) % 4
    txts[1::4] = rng.integers(0, 4, (len(txts[1::4]), L))  # far past e
    pt, tt = pats.T.astype(np.int32), txts.T.astype(np.int32)
    want = jsh.sharded_myers(jsh.make_data_mesh(n_dev), pt, tt, e, L)
    got = tsh.sharded_myers(tsh.make_data_mesh(n_dev, "cpu"), pt, tt, e, L)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    exp_err, exp_end = banded_distance_batch_numpy(pats, txts, e)
    ok = exp_err <= e
    np.testing.assert_array_equal(got[0][ok], exp_err[ok])
    np.testing.assert_array_equal(got[1][ok], exp_end[ok])
    assert got[2] == want[2] == int(ok.sum()) and 0 < got[2] < n
    with pytest.raises(ValueError, match="do not split"):
        tsh.sharded_myers(tsh.make_data_mesh(3, "cpu"), pt, tt, e, L)


def test_make_data_mesh(monkeypatch):
    """CPU: n entries of the CPU device (None: one). CUDA: the first n
    visible cards (None: all); more than are visible raises, naming both
    counts. The card count is faked: only device objects are made."""
    cpu = torch.device("cpu")
    assert tsh.make_data_mesh(None, "cpu") == [cpu]
    assert tsh.make_data_mesh(4, "cpu") == [cpu] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tsh.make_data_mesh(None, "cuda") == [
        torch.device("cuda", i) for i in range(3)]
    assert tsh.make_data_mesh(2, "cuda") == [torch.device("cuda", 0),
                                             torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="4 CUDA devices.*3 visible"):
        tsh.make_data_mesh(4, "cuda")


# ---------------------------------------------------------------------
# MeshSeeder
# ---------------------------------------------------------------------

def _reads(ref_codes, split: bool, B: int = 96, L: int = 100):
    if split:
        return _spliced_reads(ref_codes, 5, B, L)
    return _simulate_reads(ref_codes, np.random.default_rng(5), B, L)


@pytest.mark.parametrize("split", [False, True], ids=["bed", "split"])
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_seeder_matches_single_and_jax(small_world, n, split):
    """n contiguous shards of one chunk: the resolved arrays equal the
    port's single seeder's and JAX's MeshSeeder's on n devices."""
    index, ref_codes, ref_seqs = small_world
    e = 4 if split else 8
    reads = _reads(ref_codes, split)
    B, L = reads.shape
    rw = tds._pack_reads(reads)
    mesh = tds.MeshSeeder(index, ref_seqs, e, MIN_SEEDS, F,
                          tsh.make_data_mesh(n, "cpu"), split=split)
    handle = mesh.submit_packed(rw, B, L)
    assert len(handle[0]) == n and handle[1] == tds.CANDS_PER_READ * B // n
    got = mesh.resolve(handle)
    single = tds.DeviceSeeder(index, ref_seqs, e, MIN_SEEDS, F,
                              device="cpu", split=split)
    jmesh = jds.MeshSeeder(index, ref_seqs, e, MIN_SEEDS, F, num_devices=n,
                           use_pallas=False, split=split)
    assert jmesh.n_dev == n
    _assert_same(got, single.resolve(single.submit_packed(rw, B, L)))
    _assert_same(got, jmesh.resolve(jmesh.submit_packed(rw, B, L)))
    assert got[3] is False and len(got[1]) > 0
    assert mesh.stats == dict(chunks=1, over_chunks=0, rows=B,
                              fallback_rows=single.stats["fallback_rows"],
                              unsharded_chunks=0)
    # shards that name one device share one replica of the index
    assert mesh.n_dev == n and len(mesh._replicas) == 1
    assert mesh._replicas[mesh.device][0] is mesh.hash_keys


@pytest.mark.parametrize("split", [False, True], ids=["bed", "split"])
def test_mesh_seeder_reads_every_shard_from_full(small_world, monkeypatch,
                                                 split):
    """With no candidate in the capped downloads, each shard's candidates
    come from its own `full` stream, and the result is unchanged."""
    index, ref_codes, ref_seqs = small_world
    e = 4 if split else 8
    reads = _reads(ref_codes, split)
    B, L = reads.shape
    rw = tds._pack_reads(reads)
    mesh = tds.MeshSeeder(index, ref_seqs, e, MIN_SEEDS, F,
                          tsh.make_data_mesh(2, "cpu"), split=split)
    want = mesh.resolve(mesh.submit_packed(rw, B, L))
    monkeypatch.setattr(tds, "DL_CANDS_PER_READ", 0)
    handle = mesh.submit_packed(rw, B, L)
    for dl, full, Bs, _ in handle[0]:
        assert len(dl) == 2 + Bs and int(dl[0]) > 0
    _assert_same(mesh.resolve(handle), want)


def test_mesh_seeder_shard_over_budget(small_world):
    """A shard over its flat hit budget (30 hits per read of the shard)
    sends the whole chunk to the host, though the chunk as one batch is
    within its own: shard 0 holds reads of the four-copy repeat, the rest
    unrelated sequence. JAX's MeshSeeder agrees."""
    index, ref_codes, ref_seqs = small_world
    n, Bs, L = 4, 48, 100
    rng = np.random.default_rng(3)
    g = ref_codes[0]
    reads = rng.integers(0, 4, (n * Bs, L)).astype(np.uint8)
    for i, s in enumerate(rng.integers(500, 600, Bs)):
        reads[i] = g[s:s + L]
    rw = tds._pack_reads(reads)
    B = n * Bs
    mesh = tds.MeshSeeder(index, ref_seqs, 8, MIN_SEEDS, F,
                          tsh.make_data_mesh(n, "cpu"))
    handle = mesh.submit_packed(rw, B, L)
    got = mesh.resolve(handle)
    assert got == (None, None, None, True)
    assert [int(dl[1]) for dl, _, _, _ in handle[0]] == [1, 0, 0, 0]
    assert mesh.stats["over_chunks"] == 1 and mesh.stats["rows"] == 0
    single = tds.DeviceSeeder(index, ref_seqs, 8, MIN_SEEDS, F,
                              device="cpu")
    assert single.resolve(single.submit_packed(rw, B, L))[3] is False
    jmesh = jds.MeshSeeder(index, ref_seqs, 8, MIN_SEEDS, F, num_devices=n,
                           use_pallas=False)
    assert jmesh.resolve(jmesh.submit_packed(rw, B, L))[3] is True


def test_mesh_seeder_uneven_batch(small_world, capsys):
    """Rows that do not split over the shards run the single-device
    step on the first device, as in the JAX package: counted per chunk,
    logged once."""
    index, ref_codes, ref_seqs = small_world
    reads = _reads(ref_codes, False, B=98)
    B, L = reads.shape
    rw = tds._pack_reads(reads)
    mesh = tds.MeshSeeder(index, ref_seqs, 8, MIN_SEEDS, F,
                          tsh.make_data_mesh(4, "cpu"))
    single = tds.DeviceSeeder(index, ref_seqs, 8, MIN_SEEDS, F,
                              device="cpu")
    want = single.resolve(single.submit_packed(rw, B, L))
    for _ in range(2):
        handle = mesh.submit_packed(rw, B, L)
        assert not isinstance(handle[0], list)
        _assert_same(mesh.resolve(handle), want)
    assert mesh.stats["unsharded_chunks"] == 2
    assert mesh.stats["chunks"] == 2 and mesh.stats["rows"] == 2 * B
    assert capsys.readouterr().err.count("does not split over 4") == 1


def test_get_device_seeder_mesh_devices(small_world):
    """mesh_devices as in the JAX package: 0 = every visible device of
    the type (one on the CPU), 1 = one, N > 1 = a MeshSeeder over N; the
    seeder cache keys on the count."""
    index, _, ref_seqs = small_world
    seeders = {n: tds.get_device_seeder(index, ref_seqs, 8, MIN_SEEDS, F,
                                        cache_key=("mesh-test",),
                                        mesh_devices=n, device="cpu")
               for n in (0, 1, 2)}
    assert type(seeders[0]) is tds.DeviceSeeder
    assert seeders[1] is seeders[0]
    assert isinstance(seeders[2], tds.MeshSeeder) and seeders[2].n_dev == 2
    assert seeders[2].devices == [torch.device("cpu")] * 2
    tds._seeder_cache.clear()


# ---------------------------------------------------------------------
# through the CLI and the pipeline
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("simtorchmesh")
    write_simulated_dataset(str(d))
    subprocess.run([sys.executable, "-m", "chromap_tpu_torch.cli", "-i",
                    "-r", f"{d}/ref.fa", "-o", f"{d}/index"],
                   check=True, capture_output=True, cwd=ROOT, env=ENV)
    return d


def _cli(args):
    res = subprocess.run([sys.executable, "-m", "chromap_tpu_torch.cli"]
                         + [str(a) for a in args], capture_output=True,
                         text=True, cwd=ROOT, env=ENV)
    assert res.returncode == 0, res.stderr
    return res


@pytest.mark.parametrize("golden,extra", [
    ("sim_default.bed", []), ("sim_hic.pairs", ["--preset", "hic"])])
def test_cli_mesh_matches_golden(golden, extra, sim_data, golden_dir,
                                 tmp_path):
    d = sim_data
    out = tmp_path / golden
    res = _cli(["-x", f"{d}/index", "-r", f"{d}/ref.fa", "-1", f"{d}/r1.fq",
                "-2", f"{d}/r2.fq", "-o", out, "--device", "--torch-device",
                "cpu", "--device-batch-size", "512", "--mesh-devices", "2"]
               + extra)
    assert ("Using CPU (plain torch) device seeding + verification "
            "(2-device data mesh).") in res.stderr
    assert out.read_bytes() == (golden_dir / golden).read_bytes()


def _write_dryrun_set(td: Path, n_pairs: int, L: int = 100):
    """__graft_entry__.dryrun_multichip's data: a 120 kb random genome
    and simulated fragments with a few substitutions per read."""
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 120_000, dtype=np.uint8)
    (td / "ref.fa").write_text(
        ">chr1\n" + "".join("ACGT"[c] for c in genome) + "\n")
    with open(td / "r1.fq", "w") as f1, open(td / "r2.fq", "w") as f2:
        for i in range(n_pairs):
            st = rng.integers(0, len(genome) - 420)
            frag = genome[st:st + rng.integers(2 * L, 400)].copy()
            a, b = frag[:L].copy(), (frag[-L:][::-1] ^ 3) % 4
            for _ in range(rng.integers(0, 3)):
                a[rng.integers(0, L)] = rng.integers(0, 4)
                b[rng.integers(0, L)] = rng.integers(0, 4)
            for f, r, m in ((f1, a, 1), (f2, b, 2)):
                s = "".join("ACGT"[c] for c in r)
                f.write(f"@p{i}/{m}\n{s}\n+\n{'I' * L}\n")


def test_pipeline_mesh_equals_host(tmp_path, capsys):
    """The port's dryrun_multichip: MappingPipeline with a 2-shard mesh
    (device chunks of 128 pairs) writes the host-only run's bytes."""
    from chromap_tpu_torch.config import IndexConfig, MappingConfig
    from chromap_tpu_torch.pipeline import MappingPipeline, construct_index

    n_dev = 2
    _write_dryrun_set(tmp_path, 128 * n_dev * 3)
    construct_index(IndexConfig(
        reference_file_path=str(tmp_path / "ref.fa"),
        index_output_file_path=str(tmp_path / "index")))
    outs = {}
    for tag, dev in (("mesh", True), ("host", False)):
        cfg = MappingConfig(
            reference_file_path=str(tmp_path / "ref.fa"),
            index_file_path=str(tmp_path / "index"),
            read_file1_paths=[str(tmp_path / "r1.fq")],
            read_file2_paths=[str(tmp_path / "r2.fq")],
            mapping_output_file_path=str(tmp_path / f"{tag}.bed"),
            use_device=dev, torch_device="cpu", device_batch_size=128,
            mesh_devices=n_dev)
        pipe = MappingPipeline(cfg)
        capsys.readouterr()
        pipe.map_paired_end()
        outs[tag] = (tmp_path / f"{tag}.bed").read_bytes()
        if dev:
            assert f"({n_dev}-device data mesh)" in capsys.readouterr().err
            st = pipe._device_seeder.stats
            assert st["chunks"] - st["over_chunks"] >= 1
            assert st["unsharded_chunks"] == 0
    tds._seeder_cache.clear()
    assert outs["mesh"] == outs["host"] and outs["host"].count(b"\n") > 300


def test_mesh_wider_than_cards_fails_before_mapping(sim_data, tmp_path,
                                                   monkeypatch):
    """--mesh-devices 2 on CUDA with one card visible raises in
    MappingPipeline.__init__, before any output exists (the card is
    faked, so the check is the mesh's, not the missing card's)."""
    from chromap_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    d = sim_data
    out = tmp_path / "mesh.bed"
    with pytest.raises(ValueError, match="2 CUDA devices.*1 visible"):
        cli.parse_args_and_run([
            "-x", f"{d}/index", "-r", f"{d}/ref.fa", "-1", f"{d}/r1.fq",
            "-2", f"{d}/r2.fq", "-o", str(out), "--device",
            "--torch-device", "cuda", "--mesh-devices", "2"])
    assert not out.exists()


def test_two_shard_map_merge_equals_single_run(data_dir, golden_dir,
                                               tmp_path):
    """tests/test_sharding.py's multi-host case through the port: the
    bundled reads mapped in 2 shards, then merged, equal the reference
    chromap's single-run chip-equiv.bed."""
    _cli(["-i", "-r", data_dir / "ref.fa", "-o", tmp_path / "index"])
    out = tmp_path / "sharded.bed"
    base = ["-x", tmp_path / "index", "-r", data_dir / "ref.fa",
            "-1", data_dir / "read1.fq", "-2", data_dir / "read2.fq",
            "-l", "2000", "--remove-pcr-duplicates", "-o", out]
    for i in range(2):
        _cli(base + ["--num-shards", "2", "--shard-index", str(i)])
    _cli(["--merge-shards", f"{out}.shard0.temp0,{out}.shard1.temp0",
          "--remove-pcr-duplicates", "-l", "2000", "--BED",
          "-r", data_dir / "ref.fa", "-o", out])
    assert out.read_bytes() == (golden_dir / "chip-equiv.bed").read_bytes()
