"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` into its own
shared library with a plain C interface, and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<digest>.so
         csrc/<name>.cu

The library name carries a digest of the source and the flags, so an
edited source is never served by a stale build. ptxas' report (registers,
shared memory and spills of each kernel) is kept beside the library as
`<library>.ptxas`. `build()` starts one `nvcc` per missing library, all
at once, and waits for them. Nothing but this package's sources is
compiled, and the build directory is listed in `.gitignore`. Nothing
here runs at import time.

Every C entry point takes device pointers and a `cudaStream_t` as
`void*`, launches on that stream without synchronising, and returns
`cudaGetLastError()`; `launch()` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("dense_minimizer", "myers", "myers_dropoff", "cluster_scan",
           "index_probe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def so_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel whose library is missing, one `nvcc`
    per source, all started together. Returns the wall seconds spent."""
    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = so_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc()] + NVCC_FLAGS + [
            "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        with open(out + ".ptxas", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.time() - t0


def ptxas_report(name: str, summary: bool = True) -> str:
    """ptxas' report from the build of kernel `name`; with summary=True
    only each kernel's name and its "Used N registers, ... smem" line."""
    with open(so_path(name) + ".ptxas") as f:
        log = f.read()
    if not summary:
        return log.strip()
    lines = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            lines.append(line.split("'")[1] if "'" in line else line)
        elif "Used" in line and "registers" in line:
            lines.append("  " + line.split(":", 1)[-1].strip())
    return "\n".join(lines)


def occupancy(name: str, L: int):
    """(resident blocks per SM, threads per block, shared memory bytes per
    block, reads a tile or ring stages) of kernel `name` launched at read
    length L, from its C entry `<name>_occupancy`
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
    device)."""
    lib = load(name)
    fn = getattr(lib, f"{name}_occupancy")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    rc = fn(int(L), ctypes.addressof(out))
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name}_occupancy: CUDA error {rc} ({msg})")
    return tuple(out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = so_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def launch(name: str, *args) -> None:
    """Call the C entry point `name` of library `name`: tensors pass as
    device pointers, ints as C ints, then the current stream of the first
    tensor's device. The call runs with that device current, since the
    entries query and set per-device attributes on the runtime's current
    device. Raises when the entry reports a CUDA error (a launch that was
    refused never runs, and a later synchronize would not say so)."""
    import torch
    lib = load(name)
    fn = getattr(lib, name)
    is_t = [isinstance(a, torch.Tensor) for a in args]
    fn.argtypes = [ctypes.c_void_p if t else ctypes.c_int
                   for t in is_t] + [ctypes.c_void_p]
    dev = next(a for a, t in zip(args, is_t) if t).device
    with torch.cuda.device(dev):
        rc = fn(*[a.data_ptr() if t else int(a)
                  for a, t in zip(args, is_t)],
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def resolve_device(device):
    """The torch device for `device`; raises when CUDA is asked for and
    absent (the port never moves to the CPU on its own)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available (pass --torch-device cpu to run the "
                           "plain path on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def cuda_operands(what: str, *tensors) -> None:
    """Wrapper-side checks: every operand a contiguous tensor on one CUDA
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
