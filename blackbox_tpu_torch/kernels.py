"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into ``_build/`` beside
this file (listed in ``.gitignore``).  The library name carries a hash
of the sources, so an edited kernel is rebuilt and a stale library is
never loaded.  The library is bound with ctypes: every pointer and the
stream are ``c_void_p``, and every launcher returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import: the CPU tests import every module, and the
machine they run on has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("labelprop.cu", "medians.cu", "gather.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (in, out, H, W, steps, big, stream)
    "bbt_label_propagate": (_P, _P, _I, _I, _I, _I, _P),
    # (in, out, H, W, k, stream)
    "bbt_median_filter": (_P, _P, _I, _I, _I, _P),
    # (im0, im1, im2, out0, out1, out2, n_img, y0, x0, n_active, N, H, W,
    #  size, stream)
    "bbt_gather_windows": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                           _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ with the CUDA toolkit's nvcc")


def build() -> Path:
    """Compile ``csrc/`` into ``_build/`` unless this exact source set
    is built already; returns the library path."""
    files = [CSRC / s for s in SOURCES] + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for f in files:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    lib_path = BUILD / f"libbbt_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD.mkdir(exist_ok=True)
    # build under a private name, then rename: a concurrent build never
    # loads a half-written library
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.bbt_error_string.argtypes = [ctypes.c_int]
        handle.bbt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = lib().bbt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err}: {msg}")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Validate kernel operands: CUDA, one device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must be CUDA tensors on "
                             f"one device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
