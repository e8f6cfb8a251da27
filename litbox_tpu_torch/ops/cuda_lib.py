"""Build and load the port's CUDA kernels.

All `csrc/*.cu` files are compiled by ONE `nvcc` call for sm_90a into a
shared library with a plain C interface, loaded with ctypes. The library
lives in `litbox_tpu_torch/_build/<hash>/`, keyed on a hash of the sources
and flags, so it is rebuilt only when they change. Nothing here runs at
import time: the first kernel launch builds and loads.

Every C entry point returns `cudaGetLastError()` after its launch;
`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "liblitbox_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "litbox_attnscan_rows": [_P] * 7 + [_I] * 6 + [_P],
    "litbox_shear": [_P] * 3 + [_I] * 6 + [_P],
    "litbox_shear_reduce": [_P] * 3 + [_I] * 9 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / digest.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, float | None, str]:
    """Compile the kernels if the library for these sources is missing.

    Returns (library path, nvcc seconds or None when it was already built,
    nvcc's output including the ptxas register report)."""
    path = library_path()
    if path.exists():
        return path, None, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    (path.parent / "nvcc.log").write_text(log)
    return path, seconds, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.litbox_cuda_error_string.argtypes = [ctypes.c_int]
    lib.litbox_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().litbox_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}: {msg}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: the wrappers then take their
    plain PyTorch version. Any other placement goes to the kernel or raises."""
    return all(x.device.type == "cpu" for x in tensors)


def require_cuda_float32(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on one CUDA device."""
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if x.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA or CPU tensors, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
