"""The two sides of the comparison, and what every entry's inputs hold.

One code serves both sides: the program under test
(``blackbox_tpu_torch``) and the plain reference
(``portbench.reference``) have the same modules and the same public
functions, so an entry (``portbench/entries/<entry>.py``) is built from
a :class:`Package` of either.

Two changes of a side, each a context manager over a :class:`Package`,
stand beside them.  The rule: the control holds the entry's own float32
stage one step lower, in bfloat16, and the witness, a sound change that
is not bit-exact, moves the same stage by one float32 unit in the last
place, as a reordered sum or a fused pass would move it.  Every entry
module declares its own as ``control(pkg)`` and ``witness(pkg)``; the
stage of the entries on raw frames is the overscan-corrected channel
stacks, and theirs are these two:

- :func:`bfloat16_frame`, the control: those stacks held in bfloat16.
- :func:`ulp_frame`, the witness: those stacks moved by one or two
  float32 units in the last place.
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
        self.root = root
        self.geometry = self.module("core.geometry")
        self.reduce = self.module("pipeline.reduce")
        self.subtract = self.module("pipeline.subtract")
        self.cosmics = self.module("ops.cosmics")
        self.detection = self.module("ops.detection")
        self.warp = self.module("ops.warp")
        self.stats = self.module("ops.stats")

    def module(self, name: str):
        """The side's module ``name`` by its path inside the package,
        such as ``pipeline.masters``: an entry reaches any module of
        either side this way."""
        return importlib.import_module(f"{self.root}.{name}")

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
    an entry may add fields of its own.  An entry on raw frames fills
    all four; another leaves the masters and crosstalk out."""
    pool: list                  # one entry call's input each: raw frames
    mbias: torch.Tensor | None = None
    mflat: torch.Tensor | None = None
    xtalk: np.ndarray | None = None


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

