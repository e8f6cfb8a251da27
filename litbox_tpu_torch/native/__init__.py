"""The host's native EXR decoder (counterpart of the JAX package's native/).

`exr_native.cpp` decodes scanline EXRs (FLOAT/HALF channels, NONE/ZIPS/ZIP)
with a thread pool across blocks and across files, behind a plain C ABI
loaded with ctypes. It is built with g++ at first use into
`litbox_tpu_torch/_build/<hash>/`, keyed on a hash of the source and flags;
nothing is built when the package is imported. A failed build raises with
the compiler's message.

`read_exr_rgb_native` returns None for a file the decoder does not take
(not an EXR, RLE, no R, G and B channels); `io.read_image_linear` then
reads it with the Python codec.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "exr_native.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
LIB_NAME = "libexr_native.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / digest.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the decoder unless the library for this source exists."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded decoder, built on first use."""
    lib = ctypes.CDLL(str(build()))
    lib.exr_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.exr_probe.restype = ctypes.c_int
    lib.exr_read_rgb.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    lib.exr_read_rgb.restype = ctypes.c_int
    lib.exr_read_rgb_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.exr_read_rgb_batch.restype = ctypes.c_int
    return lib


def read_exr_rgb_native(path: str) -> np.ndarray | None:
    """(H, W, 3) float32, or None for a file the decoder does not take."""
    lib = get_lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.exr_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), dtype=np.float32)
    rc = lib.exr_read_rgb(path.encode(),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def read_exr_rgb_batch_native(paths: list[str], height: int, width: int) -> np.ndarray | None:
    """Parallel decode of same-sized EXRs -> (N, H, W, 3); None when there
    are no paths or any file fails to decode."""
    if not paths:
        return None
    lib = get_lib()
    out = np.empty((len(paths), height, width, 3), dtype=np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    failures = lib.exr_read_rgb_batch(
        arr, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out[0].size)
    return out if failures == 0 else None
