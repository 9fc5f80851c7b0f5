"""Multi-device scaling: the counterpart of the data mesh of
chromap_tpu/parallel/sharding.py.

Read mapping has one natural scaling axis, the read/candidate batch. A
data mesh is a list of devices (`make_data_mesh`); the read batch shards
over it in contiguous ranges while the index and reference replicate
(ops/device_seed.py `MeshSeeder`), and `sharded_myers` is the
verification step sharded the same way. One process drives every device
and sums the per-shard totals on the host, where the JAX package reduces
them with a psum. The host-level blocks (`--num-shards`, and the merge of
their spill shards) are in parallel/shards.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops._build import resolve_device
from ..ops.myers import myers


def make_data_mesh(num_devices: Optional[int] = None,
                   device="cuda") -> List[torch.device]:
    """The devices to shard over: on CUDA the first `num_devices` visible
    cards (None: all of them), raising when fewer are visible; on the CPU
    `num_devices` entries of the one CPU device (None: one), the
    counterpart of JAX's virtual CPU devices."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if num_devices is None else num_devices
        if n < 1:
            raise ValueError(f"a data mesh needs at least one device ({n})")
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count()
    n = have if num_devices is None else num_devices
    if not 1 <= n <= have:
        raise ValueError(f"a data mesh of {n} CUDA devices was asked for; "
                         f"{have} visible")
    return [torch.device("cuda", i) for i in range(n)]


def sharded_myers(devices, patterns_T: np.ndarray, texts_T: np.ndarray,
                  e: int, read_length: int
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The banded Myers verification sharded over `devices`:
    patterns_T (L+2e, N) and texts_T (L, N) int32 codes, N divisible by
    the number of shards. Shard i takes columns [i*N/n, (i+1)*N/n) on
    devices[i] (kernel B on CUDA, its plain version on the CPU). Returns
    (errors, end_positions, num_accepted) as numpy, in column order,
    with num_accepted (errors <= e) summed over the shards."""
    n = len(devices)
    N = patterns_T.shape[1]
    if n < 1 or N % n:
        raise ValueError(f"sharded_myers: {N} columns do not split over "
                         f"{n} shards")
    Ns = N // n
    parts = []
    for i, dev in enumerate(devices):
        cols = slice(i * Ns, (i + 1) * Ns)
        p, t = (torch.from_numpy(np.ascontiguousarray(a[:, cols],
                                                      dtype=np.int32)).to(dev)
                for a in (patterns_T, texts_T))
        errors, ends = myers(p, t, e, read_length)
        parts.append((errors, ends, (errors <= e).sum()))
    return (np.concatenate([p[0].cpu().numpy() for p in parts]),
            np.concatenate([p[1].cpu().numpy() for p in parts]),
            sum(int(p[2]) for p in parts))
