"""Per-telescope instrument constants the reduction reads.

Copies of the measured ML1/BG channel gains and saturation levels in
:mod:`blackbox_tpu.config.defaults` and of its ``get_par`` lookup
(:mod:`blackbox_tpu.config.base`): importing those modules imports jax.
``tests/test_torch_import.py`` holds the copies equal.
"""

from __future__ import annotations

from typing import Any, Mapping

# measured e-/ADU channel gains
GAIN = {
    "ML1": [2.112, 2.125, 2.130, 2.137, 2.156, 2.158, 2.163, 2.164,
            2.109, 2.124, 2.126, 2.132, 2.136, 2.154, 2.155, 2.157],
    "BG2": [2.694, 2.685, 2.691, 2.661, 2.655, 2.673, 2.695, 2.659,
            2.654, 2.748, 2.712, 2.717, 2.714, 2.702, 2.673, 2.743],
    "BG3": [2.614, 2.609, 2.634, 2.647, 2.600, 2.616, 2.683, 2.649,
            2.680, 2.679, 2.644, 2.604, 2.615, 2.633, 2.615, 2.714],
    "BG4": [2.415, 2.393, 2.365, 2.333, 2.340, 2.320, 2.348, 2.389,
            2.395, 2.403, 2.381, 2.350, 2.362, 2.369, 2.391, 2.430],
}

# raw-ADU saturation levels per channel
SATLEVEL = {
    "ML1": [5.89e4, 5.94e4, 5.82e4, 5.59e4, 5.60e4, 5.63e4, 5.60e4, 5.75e4,
            5.88e4, 5.81e4, 5.71e4, 5.65e4, 5.59e4, 5.60e4, 5.59e4, 5.65e4],
    "BG2": [3.84e4, 3.77e4, 3.75e4, 3.79e4, 3.79e4, 3.80e4, 3.75e4, 3.93e4,
            4.50e4, 4.08e4, 4.08e4, 4.09e4, 4.07e4, 3.95e4, 4.15e4, 4.37e4],
    "BG3": [3.96e4, 3.83e4, 3.79e4, 3.77e4, 3.81e4, 3.83e4, 3.74e4, 3.94e4,
            4.00e4, 3.98e4, 4.13e4, 4.29e4, 4.29e4, 4.22e4, 4.13e4, 4.38e4],
    "BG4": [4.11e4, 4.09e4, 4.16e4, 4.29e4, 4.32e4, 4.29e4, 4.23e4, 4.41e4,
            4.66e4, 4.60e4, 4.53e4, 4.67e4, 4.66e4, 4.65e4, 4.64e4, 4.66e4],
}

# L.A.Cosmic clip level and master-bias switch per telescope family
SIGCLIP = {"ML1": 15.0, "BG": 20.0}
SUBTRACT_MBIAS = {"ML1": False, "BG": True}


def get_par(par: Any, tel: str) -> Any:
    """Resolve a possibly telescope-keyed parameter for telescope ``tel``
    (a dict falls back by prefix: ``'BG3'`` -> ``'BG'``)."""
    if isinstance(par, Mapping):
        if tel in par:
            return par[tel]
        for n in range(len(tel) - 1, 0, -1):
            key = tel[:n]
            if key in par:
                return par[key]
        raise KeyError(f"parameter has no entry for telescope {tel!r}: {par}")
    return par
