"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into ``_build/`` beside
this file (listed in ``.gitignore``).  The library name carries a hash
of the sources, so an edited kernel is rebuilt and a stale library is
never loaded.  The library is bound with ctypes: every pointer and the
stream are ``c_void_p``, and every launcher returns
``cudaGetLastError()``, which :func:`launch` turns into an exception.

Every wrapper of a kernel launches it through :func:`launch`, which
validates the operands, runs the launcher on PyTorch's current stream
and counts the call in :data:`launches` under the wrapper's name.

Nothing here runs at import: the CPU tests import every module, and the
machine they run on has no ``nvcc``.
"""

from __future__ import annotations

import collections
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
SOURCES = ("labelprop.cu", "medians.cu", "gather.cu", "fft.cu", "detect.cu",
           "lacosmic.cu", "upsample.cu", "fillholes.cu", "stackmedian.cu",
           "warp.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (in, out, work scratch, H, W, steps, big, stream)
    "bbt_label_propagate": (_P, _P, _P, _I, _I, _I, _I, _P),
    # (in, out, H, W, k, stream)
    "bbt_median_filter": (_P, _P, _I, _I, _I, _P),
    # (im0, im1, im2, out0, out1, out2, n_img, y0, x0, n_active, N, H, W,
    #  size, stream)
    "bbt_gather_windows": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                           _I, _I, _P),
    # (xr, xi, yr, yi, tmp_r, tmp_i, twa_re, twa_im, twb_re, twb_im,
    #  N1, N2, k, L, inverse, scale, stream)
    "bbt_fft_cols": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _F, _P),
    # (img, std, excl, taps (host), ntaps, nsigma, absval, iters, H, W,
    #  det scratch, work scratch, seg, count, stream)
    "bbt_fused_detect": (_P, _P, _P, _P, _I, _F, _I, _I, _I, _I, _P, _P, _P,
                         _P, _P),
    # (clean, Hs, Ws, inm, H, W, crm, rdn, out_clean, out_crm, scratch,
    #  counts, total, Hp, Wp, halo, sigclip, sigclip * sigfrac, objlim,
    #  stream)
    "bbt_lacosmic_iter": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _F, _F, _F, _P),
    # (meshes, Wy, Wx, out, up scratch, bands scratch, n, H, W, ny, nx,
    #  stream)
    "bbt_upsample_mesh": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (mask, out, scratch, planes, H, W, iterations, stream)
    "bbt_fill_holes": (_P, _P, _P, _I, _I, _I, _I, _P),
    # (in, out, N, M, stream)
    "bbt_stack_median": (_P, _P, _I, _I, _P),
    # (srcs, dsts, fill pointers, words (host), nn, ys, xs, nx, step,
    #  1 / step, H, W, Hs, strips (host), nstrips, taps (host), kmin, nk,
    #  a, 1 / a, axis, stream)
    "bbt_warp_pass": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _F, _I, _I, _I,
                      _P, _I, _P, _I, _I, _I, _F, _I, _P),
}

# each wrapper's name (the key of its count in ``launches``) and the
# launcher it calls
LAUNCHERS = {
    "label_propagate": "bbt_label_propagate",
    "median_filter": "bbt_median_filter",
    "gather_slot_windows": "bbt_gather_windows",
    "fft_cols_split": "bbt_fft_cols",
    "fused_detect": "bbt_fused_detect",
    "lacosmic_fused": "bbt_lacosmic_iter",
    "upsample_mesh": "bbt_upsample_mesh",
    "fill_holes": "bbt_fill_holes",
    "stack_median": "bbt_stack_median",
    "warp_pass": "bbt_warp_pass",
}

# launcher calls by wrapper name, since import or the last ``clear()``
launches: collections.Counter = collections.Counter()

_handle: ctypes.CDLL | None = None


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
    # one nvcc per source, all started together, then one link; build
    # under private names and rename: a concurrent build never loads a
    # half-written library
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD / f"{Path(src).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
               str(CSRC / src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    try:
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib_path)
    return lib_path


def _lib() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _handle
    if _handle is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.bbt_error_string.argtypes = [ctypes.c_int]
        handle.bbt_error_string.restype = ctypes.c_char_p
        _handle = handle
    return _handle


def launch(name: str, operands, *args) -> None:
    """Run wrapper ``name``'s launcher on ``args`` and the current stream
    of the operands' device, and count the call in ``launches``.

    ``operands`` are the call's tensors: CUDA, on one device and
    contiguous, or a ``ValueError`` before anything is built or loaded.
    A CUDA error the launcher reports raises a ``RuntimeError``."""
    dev = operands[0].device
    for t in operands:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must be CUDA tensors on "
                             f"one device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    with torch.cuda.device(dev):
        err = getattr(_lib(), LAUNCHERS[name])(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = _lib().bbt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    launches[name] += 1


def host_floats(values) -> ctypes.Array:
    """A host float32 array of ``values``, for a launcher argument that
    the launcher copies into its kernel's parameters."""
    return (ctypes.c_float * len(values))(*values)


def host_ints(values) -> ctypes.Array:
    """A host int32 array of ``values``, as :func:`host_floats`."""
    return (ctypes.c_int * len(values))(*values)


def host_pointers(values) -> ctypes.Array:
    """A host array of device pointers (ints, None for a null one), as
    :func:`host_floats`."""
    return (ctypes.c_void_p * len(values))(*values)
