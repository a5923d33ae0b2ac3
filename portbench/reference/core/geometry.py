"""CCD channel geometry (port of :mod:`blackbox_tpu.core.geometry`).

The MeerLICHT/BlackGEM detector is one CCD read out through
``ny x nx = 2 x 8`` amplifier channels.  Frames live as channel stacks
``(n_chan, ysize_chan, xsize_chan)``; the 2-D mosaic is assembled for
the full-frame stages.  Channel indices on the mosaic are::

    [ 8  9 10 11 12 13 14 15]     (top row,   y-mirrored readout)
    [ 0  1  2  3  4  5  6  7]     (bottom row)

The dataclass, its host slice tables (numpy slices of the raw and the
reduced mosaic, as the reference's ``define_sections`` gives them) and
the two canonical instruments are copies of the JAX package's (held
equal by ``tests/test_torch_import.py``); the layout
transforms work on torch tensors (on any device) and, for the host
code copied from the JAX package (the synthetic generator), on numpy
arrays, as the JAX package's work on both of its array kinds.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch


def _permute(a, dims):
    return a.permute(*dims) if isinstance(a, torch.Tensor) else \
        a.transpose(dims)


def _cat(parts, axis):
    return torch.cat(parts, dim=axis) if isinstance(parts[0], torch.Tensor) \
        else np.concatenate(parts, axis=axis)


@dataclasses.dataclass(frozen=True)
class CCDGeometry:
    """Static description of the raw-frame channel layout."""

    ny: int = 2            # channel rows on the CCD (must be 2: mirror readout)
    nx: int = 8            # channel columns
    ysize_chan: int = 5280  # rows in one channel's data section
    xsize_chan: int = 1320  # columns in one channel's data section
    ysize_os: int = 20      # horizontal-overscan rows per channel
    xsize_os: int = 32      # vertical-overscan columns per channel
    # contaminated pixels cut at the data-adjacent edge of the overscans
    ncut_vert: int = 5
    ncut_hori: int = 10

    def __post_init__(self):
        if self.ny != 2:
            raise ValueError("CCDGeometry requires ny == 2 (mirror readout)")

    @property
    def n_chan(self) -> int:
        return self.ny * self.nx

    @property
    def dy(self) -> int:
        """Full channel height in the raw mosaic (data + horizontal os)."""
        return self.ysize_chan + self.ysize_os

    @property
    def dx(self) -> int:
        """Full channel width in the raw mosaic (data + vertical os)."""
        return self.xsize_chan + self.xsize_os

    @property
    def raw_shape(self) -> tuple[int, int]:
        return (self.ny * self.dy, self.nx * self.dx)

    @property
    def red_shape(self) -> tuple[int, int]:
        """Shape of the reduced (overscan-stripped) image."""
        return (self.ny * self.ysize_chan, self.nx * self.xsize_chan)

    @property
    def chan_shape(self) -> tuple[int, int, int]:
        return (self.n_chan, self.ysize_chan, self.xsize_chan)

    @property
    def os_vert_width(self) -> int:
        """Usable vertical-overscan columns after edge cuts."""
        return max(self.xsize_os - self.ncut_vert - 1, 0)

    @property
    def os_hori_height(self) -> int:
        """Usable horizontal-overscan rows after edge cuts."""
        return max(self.ysize_os - self.ncut_hori, 0)

    # ---- host-side slice tables (numpy indexing on the raw mosaic) -----

    @cached_property
    def chan_sec(self) -> tuple:
        """Per-channel slices incl. overscans (reference ``chan_sec``)."""
        dy, dx = self.dy, self.dx
        return tuple(
            (slice(iy * dy, (iy + 1) * dy), slice(ix * dx, (ix + 1) * dx))
            for iy in range(self.ny) for ix in range(self.nx)
        )

    @cached_property
    def data_sec(self) -> tuple:
        """Per-channel data-section slices in the raw mosaic."""
        out = []
        for iy in range(self.ny):
            y0 = self._data_y0(iy)
            for ix in range(self.nx):
                x0 = ix * self.dx
                out.append((slice(y0, y0 + self.ysize_chan),
                            slice(x0, x0 + self.xsize_chan)))
        return tuple(out)

    @cached_property
    def os_sec_vert(self) -> tuple:
        """Usable vertical-overscan slices (full channel height)."""
        dy, dx = self.dy, self.dx
        x_lo = self.xsize_chan + self.ncut_vert
        return tuple(
            (slice(iy * dy, (iy + 1) * dy),
             slice(ix * dx + x_lo, (ix + 1) * dx - 1))
            for iy in range(self.ny) for ix in range(self.nx)
        )

    @cached_property
    def os_sec_hori(self) -> tuple:
        """Usable horizontal-overscan slices (full channel width): the
        rows farthest from the data section (the ``ncut_hori`` rows next
        to the data are flux-contaminated)."""
        dy, dx = self.dy, self.dx
        h = self.os_hori_height
        out = []
        for iy in range(self.ny):
            # bottom row: strip above the data, keep its top rows; top
            # row: strip below the data, keep its bottom rows
            y0 = dy - h if iy == 0 else dy
            for ix in range(self.nx):
                out.append((slice(y0, y0 + h),
                            slice(ix * dx, (ix + 1) * dx)))
        return tuple(out)

    @cached_property
    def data_sec_red(self) -> tuple:
        """Per-channel slices in the reduced (overscan-stripped) mosaic."""
        out = []
        for iy in range(self.ny):
            y0 = iy * self.ysize_chan
            for ix in range(self.nx):
                x0 = ix * self.xsize_chan
                out.append((slice(y0, y0 + self.ysize_chan),
                            slice(x0, x0 + self.xsize_chan)))
        return tuple(out)

    def _data_y0(self, iy: int) -> int:
        """Raw-mosaic row where channel-row ``iy``'s data section starts:
        bottom channels hold their data first, top channels their
        overscan (towards the centre) first."""
        return iy * self.dy + (self.ysize_os if iy == 1 else 0)

    @cached_property
    def chan_is_top(self) -> np.ndarray:
        """Per-channel mosaic row parity: True for the top row, the
        mirror readout."""
        return np.repeat(np.arange(self.ny) == 1, self.nx)

    def split_raw(self, raw):
        """Raw mosaic -> (chan_data, os_vert, os_hori) stacks.

        chan_data : (n_chan, ysize_chan, xsize_chan)
        os_vert   : (n_chan, dy, os_vert_width)   usable v-overscan columns
        os_hori   : (n_chan, os_hori_height, dx)  usable h-overscan rows

        Stacks are in mosaic orientation (no flips); channel ``c`` is
        ``(iy, ix) = divmod(c, nx)`` with the bottom row first.
        """
        ny, nx, dy, dx = self.ny, self.nx, self.dy, self.dx
        chans = _permute(raw.reshape(ny, dy, nx, dx), (0, 2, 1, 3))
        chans = chans.reshape(self.n_chan, dy, dx)
        ych, xch = self.ysize_chan, self.xsize_chan
        chan_data = _cat([chans[:nx, :ych, :xch],
                          chans[nx:, self.ysize_os:, :xch]], 0)
        os_vert = chans[:, :, xch + self.ncut_vert:dx - 1]
        if isinstance(os_vert, torch.Tensor):
            os_vert = os_vert.contiguous()
        # keep the rows farthest from the data section (nearest the CCD
        # centre): bottom channels -> last rows, top channels -> first
        h = self.os_hori_height
        os_hori = _cat([chans[:nx, dy - h:dy, :], chans[nx:, 0:h, :]], 0)
        return chan_data, os_vert, os_hori

    def assemble(self, chan_data):
        """Channel stack (n_chan, ych, xch) -> reduced mosaic."""
        ny, nx = self.ny, self.nx
        ych, xch = chan_data.shape[1], chan_data.shape[2]
        return _permute(chan_data.reshape(ny, nx, ych, xch),
                        (0, 2, 1, 3)).reshape(ny * ych, nx * xch)

    def disassemble(self, mosaic):
        """Reduced mosaic -> channel stack (inverse of :meth:`assemble`)."""
        ny, nx = self.ny, self.nx
        ych, xch = self.ysize_chan, self.xsize_chan
        return _permute(mosaic.reshape(ny, ych, nx, xch),
                        (0, 2, 1, 3)).reshape(ny * nx, ych, xch)


# canonical instruments ------------------------------------------------------

MEERLICHT = CCDGeometry()  # 10600 x 10816 raw, 10560 x 10560 reduced

# small geometry for tests: same structure, ~1000x fewer pixels
TINY = CCDGeometry(ysize_chan=66, xsize_chan=40, ysize_os=12, xsize_os=14,
                   ncut_vert=3, ncut_hori=4)
