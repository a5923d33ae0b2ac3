"""The two sides of the comparison, and what every entry's inputs hold.

One code serves both sides: the program under test
(``blackbox_tpu_torch``) and the plain reference
(``portbench.reference``) have the same modules and the same public
functions, so an entry (``portbench/entries/<entry>.py``) is built from
a :class:`Package` of either.

Two changes of a side, each a context manager over a :class:`Package`,
stand beside them:

- :func:`bfloat16_frame`, the control: the overscan-corrected channel
  stacks held in bfloat16, the step below the configuration's float32.
- :func:`ulp_frame`, a sound witness that is not bit-exact: the same
  stacks moved by one or two float32 units in the last place, as a
  reordered sum or a fused pass would move them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import numpy as np
import torch

PROGRAM = "blackbox_tpu_torch"
REFERENCE = "portbench.reference"


class Package:
    """The modules of one side, by the port's layout."""

    def __init__(self, root: str):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")
        self.root = root
        self.geometry = mod("core.geometry")
        self.reduce = mod("pipeline.reduce")
        self.subtract = mod("pipeline.subtract")
        self.cosmics = mod("ops.cosmics")
        self.detection = mod("ops.detection")
        self.warp = mod("ops.warp")
        self.stats = mod("ops.stats")

    def geom(self, config):
        return getattr(self.geometry, config["geometry"])

    def context(self, config):
        """The configuration's ReduceContext: the telescope's defaults
        with the file's gains, saturation levels and settings."""
        return self.reduce.ReduceContext.from_defaults(
            self.geom(config), config["telescope"],
            gains=tuple(float(g) for g in config["gains"]),
            satlevel_adu=tuple(float(s) for s in config["satlevel_adu"]),
            lac_params=self.cosmics.LACosmicParams(**config["lacosmic"]),
            det_params=self.detection.DetectParams(**config["detect"]))


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides;
    an entry may add fields of its own."""
    pool: list                  # [(chan, os_vert, os_hori)] raw frames
    mbias: torch.Tensor
    mflat: torch.Tensor
    xtalk: np.ndarray


@contextlib.contextmanager
def _overscan_corrected(pkg: Package, change):
    mod = pkg.reduce
    orig = mod.overscan_correct

    def changed(*args, **kwargs):
        chan, os_stats = orig(*args, **kwargs)
        return change(chan), os_stats

    mod.overscan_correct = changed
    try:
        yield
    finally:
        mod.overscan_correct = orig


def bfloat16_frame(pkg: Package):
    """The control: ``pkg`` with its overscan-corrected channel stacks
    held in bfloat16, the step below the configuration's float32 that a
    change would take to halve the calibration's traffic."""
    return _overscan_corrected(
        pkg, lambda chan: chan.to(torch.bfloat16).to(torch.float32))


def ulp_frame(pkg: Package):
    """The witness: ``pkg`` with every overscan-corrected value times
    (1 + 2**-23) in float32, one or two units in the last place."""
    return _overscan_corrected(pkg, lambda chan: chan * (1.0 + 2.0 ** -23))
