"""Planted faults of the entries on raw frames: each a context manager
factory over a :class:`~portbench.package.Package` that breaks the
timed path underneath, as a later change could, for the benchmark's
tests to see ``correct`` come out false.

An entry module names its own in ``FAULTS``: ``reduce`` the first four
below, ``science`` all five.  An entry of another kind declares faults
of its own path; :func:`patched` is the way to plant one.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(mod, attr, make):
    """``mod.attr`` replaced by ``make(original)`` while inside."""
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def stale(pkg):
    """A step that returns its state unchanged: calibration hands on
    the first frame's result for every frame."""
    def make(orig):
        seen = []

        def step(*a, **k):
            if not seen:
                seen.append(orig(*a, **k))
            return seen[0]
        return step
    stack = contextlib.ExitStack()
    for mod in (pkg.reduce, pkg.subtract):
        stack.enter_context(patched(mod, "calibrate_detector", make))
    return stack


def _catalog_fault(pkg, change):
    def make(orig):
        def step(*a, **k):
            out = orig(*a, **k)
            change(out["cat"])
            return out
        return step
    stack = contextlib.ExitStack()
    for mod in (pkg.reduce, pkg.subtract):
        stack.enter_context(patched(mod, "extract_catalog", make))
    return stack


def half(pkg):
    """Half of the batch left out: every other source of the catalog."""
    def change(cat):
        cat["valid"] = cat["valid"] & (
            torch.arange(cat["valid"].shape[0]) % 2 == 0)
    return _catalog_fault(pkg, change)


def altered_flux(pkg):
    """An answer altered where it is produced: one source's PSF flux,
    by ten of its errors."""
    def change(cat):
        i = int(torch.nonzero(cat["valid"])[0])
        cat["flux_psf"][i] += 10 * cat["fluxerr_psf"][i].abs()
    return _catalog_fault(pkg, change)


def altered_pixel(pkg):
    """An answer altered where it is produced: one pixel of the
    calibrated image, by 100 e-."""
    def make(orig):
        def step(*a, **k):
            sci, mask, stats = orig(*a, **k)
            sci = sci.clone()
            sci[sci.shape[0] // 2, sci.shape[1] // 3] += 100.0
            return sci, mask, stats
        return step
    stack = contextlib.ExitStack()
    for mod in (pkg.reduce, pkg.subtract):
        stack.enter_context(patched(mod, "calibrate_detector", make))
    return stack


def altered_transient(pkg):
    """An answer altered where it is produced: one transient's PSF
    flux, by ten of its errors."""
    def make(orig):
        def step(*a, **k):
            cat, n = orig(*a, **k)
            i = int(torch.nonzero(cat["valid"])[0])
            cat["flux_psf"][i] += 10 * cat["fluxerr_psf"][i].abs()
            return cat, n
        return step
    return patched(pkg.subtract, "extract_transients", make)
