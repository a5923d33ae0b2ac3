"""Entry ``stack-median``: ``stats.median(stack, axis=0)``, a stack of
channel stacks reduced pixel by pixel to its median, as a master bias
is made.  A rehearsal of an entry that is not a frame reduction, added
to a copy of the benchmark by new files alone
(``test_portbench_manifest.py``); no cell of ``BENCHMARK.json`` drives
it.

Its traffic file gives ``frames`` (the stack's depth), ``level_adu``
(the range of the channels' levels) and ``read_noise_adu``.  It
declares what the benchmark's tests need of an entry: :func:`tiny`,
:func:`control`, :func:`witness`, ``FAULTS`` and ``PROGRAM_VALUES``.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import compare, frames
from portbench.package import Inputs, Package
from portbench.reference.core import geometry

# the median runs inside no span or counter of the program
PROGRAM_VALUES = frozenset()


def tiny(config: dict, traffic: dict) -> tuple:
    """The cell cut to the port's TINY geometry for the CPU tests."""
    config["geometry"] = "TINY"
    return config, traffic


def inputs(config: dict, traffic: dict, seed: int, device,
           pool: int) -> Inputs:
    """``pool`` stacks of ``frames`` channel stacks, from the seed."""
    C, h, w = getattr(geometry, config["geometry"]).chan_shape
    lo, hi = traffic["level_adu"]
    x = Inputs([])
    for i in range(pool):
        gen = frames.generator(seed, 3, i, device=device)
        level = lo + (hi - lo) * torch.rand((C, 1, 1), generator=gen,
                                            device=gen.device)
        x.pool.append(level + traffic["read_noise_adu"] * torch.randn(
            (traffic["frames"], C, h, w), generator=gen, device=gen.device))
    return x


class Entry:
    """A stack -> its median over the stack's axis."""

    def __init__(self, pkg: Package, config, traffic, inputs: Inputs,
                 device):
        self.stats = pkg.stats

    def __call__(self, stack) -> dict:
        return {"median": self.stats.median(stack, axis=0)}


def numbers(got: dict, want: dict) -> dict:
    """``median_rel``: the largest gap of the median, in units of the
    reference's median value."""
    scale = float(want["median"].abs().median())
    return {"median_rel": float(compare.gap(got["median"],
                                            want["median"]).max()) / scale}


@contextlib.contextmanager
def _median(pkg: Package, make):
    """``pkg``'s ``stats.median`` replaced by ``make(original)``."""
    orig = pkg.stats.median
    pkg.stats.median = make(orig)
    try:
        yield
    finally:
        pkg.stats.median = orig


def control(pkg: Package):
    """The stack held in bfloat16, the step below float32."""
    return _median(pkg, lambda f: lambda x, axis=None: f(
        x.to(torch.bfloat16).to(torch.float32), axis=axis))


def witness(pkg: Package):
    """The stack times (1 + 2**-23) in float32: a unit in the last
    place."""
    return _median(pkg, lambda f: lambda x, axis=None: f(
        x * (1.0 + 2.0 ** -23), axis=axis))


def stale(pkg: Package):
    """A step that returns its state unchanged: each call hands on the
    previous call's median."""
    def make(f):
        held = []

        def median(x, axis=None):
            held.append(f(x, axis=axis))
            return held.pop(0) if len(held) > 1 else held[0]
        return median
    return _median(pkg, make)


def altered_pixel(pkg: Package):
    """An answer altered where it is produced: one pixel of the median,
    by 100 ADU."""
    def make(f):
        def median(x, axis=None):
            out = f(x, axis=axis).clone()
            out.view(-1)[out.numel() // 3] += 100.0
            return out
        return median
    return _median(pkg, make)


FAULTS = (stale, altered_pixel)
