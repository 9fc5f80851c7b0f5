"""The benchmark's copy of the kernels' byte costs equals the bytes
half of the originals (chip_smoke.py, chromap_tpu_torch/bench.py)."""

import pytest
import torch

import chip_smoke
from chromap_tpu_torch import bench
from portbench import costs


@pytest.mark.parametrize("L,B", [(100, 32768), (150, 1000), (30, 7)])
def test_dense_minimizer(L, B):
    codes = torch.zeros((L, B), dtype=torch.int32)
    assert costs.dense_minimizer_bytes(L, B) == chip_smoke.dense_cost(
        codes, None, 17, 7)[0]


@pytest.mark.parametrize("H,B", [(128, 32768), (16, 100)])
def test_cluster_scan(H, B):
    assert costs.cluster_scan_bytes(H, B) == chip_smoke.cluster_cost(H,
                                                                     B)[0]


@pytest.mark.parametrize("L,N,e", [(100, 65536, 8), (150, 10, 4)])
def test_myers(L, N, e):
    assert costs.myers_bytes(L, N, e) == bench.myers_cost(L, N, e)[0]


@pytest.mark.parametrize("L,e", [(100, 4), (84, 4), (60, 8)])
def test_myers_dropoff(L, e):
    rml = torch.tensor([0, 3, L - 1, L + 5, 17], dtype=torch.int32)
    steps = int(torch.clamp(rml.long() + 1, max=L).sum())
    assert costs.myers_dropoff_bytes(steps, 5, e) == chip_smoke.dropoff_cost(
        rml, L, e)[0]
