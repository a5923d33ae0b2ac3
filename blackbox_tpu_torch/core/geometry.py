"""CCD channel geometry (port of :mod:`blackbox_tpu.core.geometry`).

The MeerLICHT/BlackGEM detector is one CCD read out through
``ny x nx = 2 x 8`` amplifier channels.  Frames live as channel stacks
``(n_chan, ysize_chan, xsize_chan)``; the 2-D mosaic is assembled for
the full-frame stages.  Channel indices on the mosaic are::

    [ 8  9 10 11 12 13 14 15]     (top row,   y-mirrored readout)
    [ 0  1  2  3  4  5  6  7]     (bottom row)

The dataclass and the two canonical instruments are copies of the JAX
package's (held equal by ``tests/test_torch_import.py``); the layout
transforms work on torch tensors.
"""

from __future__ import annotations

import dataclasses

import torch


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

    def split_raw(self, raw: torch.Tensor):
        """Raw mosaic -> (chan_data, os_vert, os_hori) stacks.

        chan_data : (n_chan, ysize_chan, xsize_chan)
        os_vert   : (n_chan, dy, os_vert_width)   usable v-overscan columns
        os_hori   : (n_chan, os_hori_height, dx)  usable h-overscan rows

        Stacks are in mosaic orientation (no flips); channel ``c`` is
        ``(iy, ix) = divmod(c, nx)`` with the bottom row first.
        """
        ny, nx, dy, dx = self.ny, self.nx, self.dy, self.dx
        chans = raw.reshape(ny, dy, nx, dx).permute(0, 2, 1, 3)
        chans = chans.reshape(self.n_chan, dy, dx)
        ych, xch = self.ysize_chan, self.xsize_chan
        chan_data = torch.cat([chans[:nx, :ych, :xch],
                               chans[nx:, self.ysize_os:, :xch]], dim=0)
        os_vert = chans[:, :, xch + self.ncut_vert:dx - 1].contiguous()
        # keep the rows farthest from the data section (nearest the CCD
        # centre): bottom channels -> last rows, top channels -> first
        h = self.os_hori_height
        os_hori = torch.cat([chans[:nx, dy - h:dy, :], chans[nx:, 0:h, :]],
                            dim=0)
        return chan_data, os_vert, os_hori

    def assemble(self, chan_data: torch.Tensor) -> torch.Tensor:
        """Channel stack (n_chan, ych, xch) -> reduced mosaic."""
        ny, nx = self.ny, self.nx
        ych, xch = chan_data.shape[1], chan_data.shape[2]
        return (chan_data.reshape(ny, nx, ych, xch).permute(0, 2, 1, 3)
                .reshape(ny * ych, nx * xch))

    def disassemble(self, mosaic: torch.Tensor) -> torch.Tensor:
        """Reduced mosaic -> channel stack (inverse of :meth:`assemble`)."""
        ny, nx = self.ny, self.nx
        ych, xch = self.ysize_chan, self.xsize_chan
        return (mosaic.reshape(ny, ych, nx, xch).permute(0, 2, 1, 3)
                .reshape(ny * nx, ych, xch))


# canonical instruments ------------------------------------------------------

MEERLICHT = CCDGeometry()  # 10600 x 10816 raw, 10560 x 10560 reduced

# small geometry for tests: same structure, ~1000x fewer pixels
TINY = CCDGeometry(ysize_chan=66, xsize_chan=40, ysize_os=12, xsize_os=14,
                   ncut_vert=3, ncut_hori=4)
