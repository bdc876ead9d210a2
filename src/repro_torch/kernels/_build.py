"""Build and load the port's CUDA kernels: ``nvcc`` by hand into one shared
library per source, each with a plain C interface loaded through ``ctypes``.

The build happens at first use, never at import, into
``build/repro_torch/<key>/`` at the root of the checkout (listed in
``.gitignore``).  ``<key>`` hashes the sources, the shared header and the
compiler flags, so a changed source rebuilds and an unchanged one loads the
existing libraries.  All sources compile in parallel, one ``nvcc`` each.
Only sources in ``csrc/`` are used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gptq_gemv", "gptq_matmul", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# what the last build did: seconds spent in nvcc (0 when the libraries
# already existed), the compiler's output (ptxas register/spill report)
BUILD_INFO: dict = {"seconds": None, "log": "", "dir": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def build_key() -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every missing library (in parallel) and return their
    directory.  Raises with the compiler's output if a build fails."""
    out = BUILD_ROOT / build_key()
    missing = [s for s in SOURCES if not (out / f"lib{s}.so").exists()]
    BUILD_INFO["dir"] = str(out)
    if not missing:
        if BUILD_INFO["seconds"] is None:
            BUILD_INFO["seconds"] = 0.0
        return out
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for name in missing:
            tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for name, tmp, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"== {name}.cu ==\n{log}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out / f"lib{name}.so")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = "\n".join(logs)
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return _LIBS[name]


def dtype_code(dtype: torch.dtype) -> int:
    """Storage-type code of ``csrc/common.cuh`` (float32 0, bfloat16 1)."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}")


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every operand on the current CUDA device and contiguous; returns the
    device.  Raises on what the kernel does not take."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: expected CUDA or CPU tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise RuntimeError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise RuntimeError(f"{name}: operand of shape {tuple(t.shape)} "
                               f"is not contiguous")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise RuntimeError(f"{name}: operands on {dev} but the current "
                           f"device is cuda:{torch.cuda.current_device()}")
    return dev


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    """Raise if the C entry point reported a refused launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
