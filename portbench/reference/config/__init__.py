"""Settings of the reduction (copies of :mod:`blackbox_tpu.config`).

``base.py`` (``get_par``, ``Settings``) and ``defaults.py``
(``ReductionSettings`` with the measured per-channel gains and
saturation levels) are copies of the JAX package's modules, held equal
by ``tests/test_torch_import.py``; importing those imports jax.  The
per-telescope L.A.Cosmic clip level and master-bias switch are named
here once, from the default settings.
"""

from portbench.reference.config.base import get_par, Settings  # noqa: F401
from portbench.reference.config.defaults import (  # noqa: F401
    GAIN, SATLEVEL, ReductionSettings, BuildRefSettings, default_settings,
)

SIGCLIP = ReductionSettings().sigclip
SUBTRACT_MBIAS = ReductionSettings().subtract_mbias
