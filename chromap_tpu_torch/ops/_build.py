"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` into its own
shared library with a plain C interface, and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<digest>.so csrc/<name>.cu

The library name carries a digest of the source and the flags, so an
edited source is never served by a stale build. `build()` starts one
`nvcc` per missing library, all at once, and waits for them. Nothing but
this package's sources is compiled, and the build directory is listed in
`.gitignore`. Nothing here runs at import time.

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
KERNELS = ("dense_minimizer", "myers", "myers_dropoff", "cluster_scan")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _flags(verbose: bool):
    return NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])


def so_path(name: str, verbose: bool = False) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(_flags(verbose)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> float:
    """Compile every named kernel whose library is missing, one `nvcc`
    per source, all started together. Returns the wall seconds spent;
    with verbose=True prints ptxas' register and spill report."""
    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = so_path(name, verbose)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc()] + _flags(verbose) + [
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
        os.replace(tmp, out)
        if verbose and log.strip():
            print(f"[nvcc {name}]\n{log.strip()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.time() - t0


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
    tensor's device. Raises when the entry reports a CUDA error (a launch
    that was refused never runs, and a later synchronize would not say
    so)."""
    import torch
    lib = load(name)
    fn = getattr(lib, name)
    is_t = [isinstance(a, torch.Tensor) for a in args]
    fn.argtypes = [ctypes.c_void_p if t else ctypes.c_int
                   for t in is_t] + [ctypes.c_void_p]
    dev = next(a for a, t in zip(args, is_t) if t).device
    rc = fn(*[a.data_ptr() if t else int(a) for a, t in zip(args, is_t)],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def cuda_operands(what: str, *tensors) -> None:
    """Wrapper-side checks: every operand a contiguous tensor on one CUDA
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
