"""Per-source window gathers over the fixed-capacity slot axis (port of
:mod:`blackbox_tpu.ops.windows`).

The catalog stages (segment moments, aperture photometry) read a small
square window around every slot of a fixed-capacity catalog.  On the
card the windows are copied by the CUDA kernel ``csrc/gather.cu``,
which reads the live-slot count from device memory itself: slots at or
past it come back as zeros, and no host sync is needed.

The JAX package's ``chunked_slot_map`` skips whole 2048-slot chunks
past the live count (``lax.cond``); here the per-slot math is one plain
batch over the slot axis (20000 x 32² float32 is 82 MB).  JAX computes
every slot of a chunk that starts below the count, so the two agree on
slots ``< n_active`` only — callers gate every later use on that.
"""

from __future__ import annotations

import torch

from blackbox_tpu_torch import kernels


def _widen(im: torch.Tensor) -> torch.Tensor:
    """4-byte copy of an image (bool/int -> int32, float -> float32)."""
    if im.element_size() == 4:
        return im
    if im.element_size() > 4:
        raise TypeError(f"gather_slot_windows: unsupported 8-byte dtype "
                        f"{im.dtype}; cast explicitly if lossy is ok")
    return im.to(torch.float32 if im.is_floating_point() else torch.int32)


def _gather_plain(imgs, y0, x0, size: int, n_active):
    H, W = imgs[0].shape
    N = y0.shape[0]
    y0c = torch.clamp(y0.long(), 0, H - size)
    x0c = torch.clamp(x0.long(), 0, W - size)
    g = torch.arange(size, device=y0.device)
    rows = (y0c[:, None] + g[None, :])[:, :, None]          # (N, s, 1)
    cols = (x0c[:, None] + g[None, :])[:, None, :]          # (N, 1, s)
    outs = tuple(im[rows, cols] for im in imgs)
    if n_active is not None:
        live = (torch.arange(N, device=y0.device) < n_active)[:, None, None]
        outs = tuple(torch.where(live, o, torch.zeros((), dtype=o.dtype,
                                                      device=o.device))
                     for o in outs)
    return outs


def gather_slot_windows(images, y0, x0, size: int, n_active=None):
    """Gather (N, size, size) windows from each (H, W) image at shared
    starts, clipped like ``lax.dynamic_slice``.

    images   : one (H, W) tensor or a tuple of up to three (shared shape).
    y0, x0   : (N,) integer starts.
    n_active : None (all slots live) or a 0-d integer tensor; slots at
               or past it return zeros.
    Returns the stack, or a tuple of stacks matching ``images``.  CPU
    tensors take the plain version; CUDA tensors run the kernel.
    """
    single = not isinstance(images, (tuple, list))
    imgs = (images,) if single else tuple(images)
    H, W = imgs[0].shape
    if any(im.shape != (H, W) for im in imgs) or not 1 <= len(imgs) <= 3:
        raise ValueError("gather_slot_windows: 1-3 images of one (H, W)")
    if not 1 <= size <= min(H, W):
        raise ValueError(f"gather_slot_windows: size {size} outside "
                         f"1..{min(H, W)}")
    dtypes = tuple(im.dtype for im in imgs)
    if imgs[0].device.type == "cpu":
        outs = _gather_plain(tuple(_widen(im) for im in imgs), y0, x0, size,
                             n_active)
    else:
        outs = _gather_cuda(tuple(_widen(im).contiguous() for im in imgs),
                            y0, x0, size, n_active)
    outs = tuple(o.to(dt) for o, dt in zip(outs, dtypes))
    return outs[0] if single else outs


def _gather_cuda(imgs, y0, x0, size: int, n_active):
    H, W = imgs[0].shape
    N = y0.shape[0]
    y0 = y0.to(torch.int32).contiguous()
    x0 = x0.to(torch.int32).contiguous()
    nact = None
    if n_active is not None:
        nact = torch.as_tensor(n_active, dtype=torch.int32,
                               device=y0.device).reshape(1)
    kernels.require_cuda("gather_slot_windows", *imgs, y0, x0,
                         *(() if nact is None else (nact,)))
    outs = tuple(torch.empty((N, size, size), dtype=im.dtype,
                             device=im.device) for im in imgs)
    ptr = [im.data_ptr() for im in imgs] + [None] * (3 - len(imgs))
    optr = [o.data_ptr() for o in outs] + [None] * (3 - len(imgs))
    with torch.cuda.device(y0.device):
        kernels.check(kernels.lib().bbt_gather_windows(
            *ptr, *optr, len(imgs), y0.data_ptr(), x0.data_ptr(),
            None if nact is None else nact.data_ptr(), N, H, W, size,
            kernels.stream_of(y0)), "gather_slot_windows")
    gather_slot_windows.launches += 1
    return outs


gather_slot_windows.launches = 0
