"""PSF model parameters (counterpart of :mod:`blackbox_tpu.ops.psf`).

Only the static parameters are here, so that a reduction context
carries every field of the JAX package's; the PSF fit and PSF
photometry are not ported yet (``ReduceContext.fit_psf`` must be False).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PSFParams:
    size: int = 25            # vignette / PSF stamp size (odd)
    poldeg: int = 2           # spatial polynomial degree
    snr_min: float = 20.0     # star selection
    elong_max: float = 1.5
    niter: int = 3            # reweighting iterations
    chi2_clip: float = 10.0   # reject stars with chi2/dof above this
    sat_frac: float = 0.8     # peak above sat_frac*satlevel rejected
