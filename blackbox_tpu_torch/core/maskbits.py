"""Mask bit definitions (copy of :mod:`blackbox_tpu.core.maskbits`).

Copied, not imported: importing anything from ``blackbox_tpu`` imports
jax.  ``tests/test_torch_import.py`` holds the values equal.
"""

from __future__ import annotations

BAD = 1            # static bad pixel (from the bad-pixel-mask file) / non-finite
COSMIC = 2         # cosmic ray (L.A.Cosmic)
SATURATED = 4      # above the per-channel saturation threshold
SAT_CONNECTED = 8  # connected to a saturated pixel (bleed/halo)
SATELLITE = 16     # satellite trail
EDGE = 32          # detector edge / no data
CROSSTALK = 64     # crosstalk victim of a saturated source channel

ALL = BAD | COSMIC | SATURATED | SAT_CONNECTED | SATELLITE | EDGE | CROSSTALK

# default sum of bits discarded in co-addition
DISCARD_DEFAULT = 63

# name -> bit, in header-reporting order
BITS = {
    "bad": BAD,
    "cosmic": COSMIC,
    "saturated": SATURATED,
    "saturated-connected": SAT_CONNECTED,
    "satellite": SATELLITE,
    "edge": EDGE,
    "crosstalk": CROSSTALK,
}
