"""Default settings tree.

Capability-parity with the reference's ``Settings/set_blackbox.py`` and
``Settings/set_buildref.py``; measured per-channel constants (gains,
saturation levels) are instrument facts taken from the reference settings
(Settings/set_blackbox.py:241-311).  Anything path-like defaults to local
test locations and is overridden per deployment.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from portbench.reference.config.base import Settings
from portbench.reference.core.geometry import CCDGeometry, MEERLICHT

# measured e-/ADU channel gains (set_blackbox.py:241-288)
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

# raw-ADU saturation levels per channel (set_blackbox.py:302-311)
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

# reduced-mosaic section used for flat normalisation (set_blackbox.py:324-327)
FLAT_NORM_SEC = {
    "ML1": (slice(6600, 9240), slice(5280, 7920)),
    "BG2": (slice(500, 2000), slice(1320, 6600)),
    "BG3": (slice(300, 1200), slice(5280, 10000)),
    "BG4": (slice(2640, 5280), slice(3960, 7920)),
}


@dataclasses.dataclass
class ReductionSettings(Settings):
    """Per-frame reduction settings (reference set_blackbox.py parity)."""

    geometry: CCDGeometry = MEERLICHT
    pixscale: float = 0.5642       # [arcsec/pix] (set_zogy contract)

    # reduction step switches (set_blackbox.py:19-42)
    img_reduce: bool = True
    cat_extract: bool = True
    trans_extract: bool = True
    force_reproc_new: bool = False
    create_ref: bool = False
    create_master: bool = True
    subtract_mbias: Any = dataclasses.field(
        default_factory=lambda: {"ML1": False, "BG": True})
    detect_sats: bool = True
    correct_nonlin: bool = False
    create_mdark: bool = False

    # master-frame windows (set_blackbox.py:47-49)
    cal_window: Any = dataclasses.field(
        default_factory=lambda: {"bias": 3, "dark": 3, "flat": 7})
    ncal_max: Any = dataclasses.field(
        default_factory=lambda: {"bias": 20, "dark": 20, "flat": 15})

    # vertical-overscan polynomial degree (set_blackbox.py:52)
    voscan_poldeg: int = 3

    # crosstalk coefficient file (set_blackbox.py:179-182); None = skip
    xtalk_file: Optional[str] = None

    # L.A.Cosmic (set_blackbox.py:211-218)
    sigclip: Any = dataclasses.field(
        default_factory=lambda: {"ML1": 15.0, "BG": 20.0})
    sigfrac: float = 0.01
    objlim: float = 3.0
    niter: int = 3
    sepmed: bool = False

    # satellite-trail detection (set_blackbox.py:222-228).  The device
    # Radon detector runs at 8x binning: the FFT cost drops 4x and
    # measured sensitivity to faint trails IMPROVES (line noise
    # averages down faster than the diluted signal; 2-sigma/px trails
    # detected at bin 8, missed at bin 4).  The reference bins 2x for
    # the much slower acstools Hough path.
    use_unet_sat: bool = True       # U-Net segmentation (ASTA-equivalent)
    detect_sat_segments: bool = False
    # partial-trail (segment) detection: the band-Radon detector over
    # an overlapping half-stride tile grid, covering short streaks
    # (~1/4 of a line) the full-frame statistic is blind to — the one
    # regime where the reference's ASTA CNN beats the full-frame Radon
    # path (blackbox.py:4112-4117).  Cross-tile NMS dedups against the
    # full-frame detections so NSATS stays a physical count.  Costs
    # ~2.25 full-frame Radon equivalents (~80 ms at 10560² on v5e);
    # off by default — enable where recall on short streaks beats
    # specificity (ops/satdet.py::detect_trail_segments).
    sat_bin: int = 16               # binning for trail detection
                                    # (16x since round 4: -9 ms
                                    # in-context AND finds a 1.2-sigma
                                    # full trail that 8x misses —
                                    # line noise averages down faster
                                    # than the signal dilutes; cost is
                                    # a ~2x wider rasterised mask)
    sat_model_path: Optional[str] = None

    # per-channel constants
    gain: Any = dataclasses.field(default_factory=lambda: dict(GAIN))
    satlevel: Any = dataclasses.field(default_factory=lambda: dict(SATLEVEL))
    flat_norm_sec: Any = dataclasses.field(
        default_factory=lambda: dict(FLAT_NORM_SEC))

    # evening-flat rejection (set_blackbox.py:330-331)
    flat_reject_eve: Any = dataclasses.field(
        default_factory=lambda: {"ML": False, "BG": True})

    # detection / photometry (reference defers these to set_zogy)
    bkg_boxsize: int = 256
    bkg_filtersize: int = 3
    bkg_nsigma: float = 3.0
    subimage_size: int = 1024
    size_vignet: int = 99
    det_nsigma: float = 1.5         # detection threshold in background sigma
    det_npix_min: int = 3
    max_sources: int = 20000        # static catalog capacity per frame
    apphot_radii: Any = dataclasses.field(
        default_factory=lambda: [0.66, 1.5, 5.0])  # x FWHM

    # calibration file locations (resolved per deployment);
    # bad_pixel_mask may be one path or a {filter: path} dict of FITS
    # masks on the reduced mosaic (set_blackbox.py:187-196);
    # nonlin_corr_file holds the (C, D) fractional-correction
    # polynomial coefficients (.npy) applied when correct_nonlin is on
    cal_dir: Optional[str] = None
    bad_pixel_mask: Any = None
    nonlin_corr_file: Any = None

    # data layout roots (set_blackbox.py:89-153)
    run_dir: Optional[str] = None
    raw_dir: Optional[str] = None
    red_dir: Optional[str] = None
    master_dir: Optional[str] = None
    ref_dir: Optional[str] = None
    tmp_dir: Optional[str] = None
    keep_tmp: bool = False

    # quicklook products at publication (reference jpg per product,
    # blackbox.py:862-928, and transient PNG thumbnails, 2674-2826)
    make_quicklooks: bool = True
    size_thumbnails: int = 100      # [pix] transient thumbnail cutouts

    # processing resources
    nproc: int = 1
    device_batch: int = 1           # frames stacked per device step
    # persistent XLA compilation cache: the TPU compiler's autotune is
    # a per-module-hash lottery (same program, up to 35% executable
    # spread — PERF_NOTES.md); caching pins the compile across runs.
    # True = auto dir fingerprinted by host CPU, str = explicit dir,
    # False/None = off
    compile_cache: Any = True

    # observatory sites per telescope (lat, lon[deg E], height[m]) —
    # MeerLICHT @ Sutherland, BlackGEM @ La Silla
    site: Any = dataclasses.field(default_factory=lambda: {
        "ML": (-32.3799, 20.8112, 1802.0),
        "BG": (-29.2575, -70.7380, 2383.0),
    })

    # photometric calibration
    zp_default: Any = dataclasses.field(
        default_factory=lambda: {"u": 22.4, "g": 23.3, "q": 23.7, "r": 22.9,
                                 "i": 22.3, "z": 21.4})


@dataclasses.dataclass
class BuildRefSettings(Settings):
    """Reference-image co-addition settings (set_buildref.py parity)."""

    combine_type: str = "clipped"          # :39
    max_spread_seeing: float = 0.3         # :45
    A_range: Any = dataclasses.field(
        default_factory=lambda: (0.3, 5.1, 0.1))       # :48-53
    nsigma_range: Any = dataclasses.field(
        default_factory=lambda: (2.5, 3.6, 0.5))
    nmin_4clipping: int = 5
    masktype_discard: int = 63             # :57
    center_type: str = "grid"              # :61
    imagesize_type: str = "input"          # :66
    pixscale_out: float = 0.5642           # :70-73 (arcsec/pix, manual)
    back_type: str = "blackbox"            # :79
    scale_zps: bool = True                 # :83
    seeing_max: Any = dataclasses.field(
        default_factory=lambda: {"u": 4.0, "g": 4.0, "q": 4.0, "r": 4.0,
                                 "i": 4.0, "z": 4.0})  # :90-92
    limmag_target: Any = dataclasses.field(
        default_factory=lambda: {"u": 21.0, "g": 22.3, "q": 22.7, "r": 22.0,
                                 "i": 21.5, "z": 20.5})  # :106
    nimages_min: int = 3                   # :111
    nimages_max: int = 40                  # :116
    dlimmag_proj_min: float = 0.05         # :121-126
    dlimmag_min: float = 0.1


@dataclasses.dataclass
class FrameworkSettings(Settings):
    reduce: ReductionSettings = dataclasses.field(
        default_factory=ReductionSettings)
    buildref: BuildRefSettings = dataclasses.field(
        default_factory=BuildRefSettings)
    telescope: str = "ML1"


def default_settings(telescope: str = "ML1", **kw) -> FrameworkSettings:
    return FrameworkSettings(telescope=telescope, **kw)
