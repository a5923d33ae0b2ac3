"""The device program of one master, ``pipeline.masters.build_master``,
against the benchmark's plain reference (``portbench/reference/
pipeline/masters.py``), through ``MasterStore._build``, and under the
port's spans and counters.

Tolerances.  Masters are exact: order statistics of the same values,
the same equations in the same order (the reference takes its stack
median one channel at a time).  ``gaincf``, ``medsec`` and the other
statistics are held at rtol 1e-6, room for means summed in another
order; a stack held in bfloat16 misses it.
"""

import os
import sys

import numpy as np
import pytest
import torch

from blackbox_tpu_torch.core.geometry import TINY
from blackbox_tpu_torch.io.fits import Header
from blackbox_tpu_torch.io.rice import read_rice, write_rice
from blackbox_tpu_torch.orchestration.masterstore import MasterStore
from blackbox_tpu_torch.orchestration.paths import DataTree
from blackbox_tpu_torch.pipeline import masters
from blackbox_tpu_torch.pipeline.headers import stamp_master
from blackbox_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.reference.core import geometry as ref_geometry  # noqa: E402
from portbench.reference.pipeline import masters as ref  # noqa: E402

RTOL = 1e-6
NAN_AT = (0, 30, 20)    # outside the flat's section, strips and chain
H, W = TINY.red_shape
CENTRAL = (slice(H // 2 - H // 8, H // 2 + H // 8),   # a flat's default
           slice(W // 2 - W // 8, W // 2 + W // 8))   # section
# the master path's device reads: each statistic but the frame count,
# and the master
HOST_READS = {"bias": 5, "flat": 4, "dark": 3}
SPANS = {"bias": {"master", "master.stack", "master.median",
                  "master.stats"},
         "flat": {"master", "master.stack", "master.median",
                  "master.normalise", "master.gaincf", "master.stats"}}


def _frames(kind: str, n: int, seed: int = 0, nan: bool = True) -> list:
    """``n`` seeded (C, ych, xch) frames in e-: bias-like (0 +- 12,
    a few hot pixels) or flat-like (a level each frame, a 1 % pixel
    response, Poisson-like noise); one NaN pixel in the first."""
    g = torch.Generator().manual_seed(seed)
    shape = TINY.chan_shape
    if kind == "bias":
        out = [12.0 * torch.randn(shape, generator=g) for _ in range(n)]
        for f in out:
            f.view(-1)[torch.randint(f.numel(), (5,), generator=g)] += 5e3
    else:
        resp = 1 + 0.01 * torch.randn(shape, generator=g)
        resp = resp * (1 + 0.01 * torch.linspace(-1, 1, shape[0]))[
            :, None, None]
        out = []
        for i in range(n):
            level = 1e4 + 3e4 * float(torch.rand((), generator=g))
            f = level * resp
            out.append(f + f.sqrt() * torch.randn(shape, generator=g))
    if nan:
        out[0][NAN_AT] = float("nan")
    return out


def _same(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (a != a) & (b != b)).all())


def _stats_close(got: dict, want: dict) -> bool:
    if set(got) != set(want):
        return False
    return all(torch.allclose(got[k].double(), want[k].double(), rtol=RTOL,
                              atol=0.0, equal_nan=True) for k in want)


@pytest.mark.parametrize("n", [3, 15, 20])
@pytest.mark.parametrize("kind", ["bias", "flat", "dark"])
def test_build_master_matches_the_reference(kind, n):
    frames = _frames("flat" if kind == "flat" else "bias", n, seed=n)
    exptimes = torch.linspace(30.0, 90.0, n) if kind == "dark" else None
    rgeom = ref_geometry.TINY
    want_m, want_s = ref.build_master(kind, list(frames), rgeom,
                                      exptimes=exptimes)
    got_m, got_s = masters.build_master(kind, list(frames), TINY,
                                        exptimes=exptimes)
    assert _same(got_m, want_m)
    assert bool(torch.isnan(got_m[NAN_AT]))
    assert _stats_close(got_s, want_s)
    # the tolerance is tight enough that a stack held in bfloat16 fails
    low = [f.to(torch.bfloat16).to(torch.float32) for f in frames]
    low_m, low_s = ref.build_master(kind, low, rgeom, exptimes=exptimes)
    assert not _same(low_m, want_m)
    assert not _stats_close(low_s, want_s)


@pytest.mark.parametrize("kind", ["bias", "flat"])
def test_build_master_is_master_bias_or_flat(kind):
    """build_master stacks, takes the flat's default section, calls the
    kind's function, and empties the frames list."""
    frames = _frames(kind, 4, seed=7)
    cube = torch.stack(frames)
    if kind == "bias":
        want_m, want_s = masters.master_bias(cube)
    else:
        want_m, want_s = masters.master_flat(cube, TINY, CENTRAL)
    handed = list(frames)
    got_m, got_s = masters.build_master(kind, handed, TINY)
    assert handed == []
    assert _same(got_m, want_m)
    assert set(got_s) == set(want_s)
    for k in want_s:
        assert _same(got_s[k], want_s[k]), k


def _rice_frames(tmp_path, kind: str, n: int) -> list:
    """``n`` TINY frames written as Rice mosaics: [(path, header)]."""
    files = []
    for i, f in enumerate(_frames(kind, n, seed=11, nan=False)):
        h = Header()
        h["IMAGETYP"] = (kind, "")
        h["EXPTIME"] = (30.0 + 10 * i, "")
        h["RA"], h["DEC"] = (150.0 + 0.01 * i, ""), (-30.0, "")
        h["MJD-OBS"] = (60000.1 + 0.001 * i, "")
        path = str(tmp_path / f"{kind}_{i:02d}_red.fits.fz")
        write_rice(path, TINY.assemble(f).numpy(), h, qlevel=32.0)
        files.append((path, h))
    return files


@pytest.mark.parametrize("kind", ["bias", "flat", "dark"])
def test_masterstore_build_is_the_direct_master(tmp_path, kind):
    """``MasterStore._build`` on Rice frames: the master and the
    master's header cards of the kind's function called directly on
    the same decoded frames; its device reads counted."""
    files = _rice_frames(tmp_path, kind, 5)
    store = MasterStore(DataTree(str(tmp_path), "ML1"), "ML1", device="cpu")
    with timing.recording(cuda=False) as rec:
        data, h = store._build(kind, files, None, "ML1", TINY, None)
        spans, counters = rec.drain()

    cube = torch.stack([TINY.disassemble(torch.as_tensor(
        np.asarray(read_rice(p)[0], np.float32))) for p, _ in files])
    if kind == "bias":
        master, stats = masters.master_bias(cube)
    elif kind == "flat":
        master, stats = masters.master_flat(cube, TINY, CENTRAL)
    else:
        master, stats = masters.master_dark(
            cube, torch.tensor([30.0 + 10 * i for i in range(5)]))
    assert np.array_equal(data, TINY.assemble(master).numpy(),
                          equal_nan=True)
    want = stamp_master(Header(), kind, {k: v.numpy()
                                         for k, v in stats.items()})
    for key in want.keys():
        assert h[key] == want[key], key
    assert h["NUSED"] == 5 and h["IMAGETYP"] == f"m{kind}"
    assert counters["host.reads"] == HOST_READS[kind]
    assert counters["master.frames"] == 5
    assert {s.name for s in spans} >= {"master", "master.median"}


@pytest.mark.parametrize("kind", ["bias", "flat"])
def test_master_spans_and_counter(kind):
    """Under ``recording()``: the root span ``master`` with its
    attributes over the stage spans, and ``master.frames``.  Outside
    it the same master, and nothing recorded."""
    n = 6
    frames = _frames(kind, n, seed=3)
    with timing.recording(cuda=False) as rec:
        got_m, got_s = masters.build_master(kind, list(frames), TINY)
        spans, counters = rec.drain()
    names = [s.name for s in spans]
    assert set(names) == SPANS[kind]
    assert all(names.count(x) == 1 for x in SPANS[kind])
    root = spans[0]
    assert root.name == "master" and root.parent is None
    assert root.attrs == {"imgtype": kind, "frames": n,
                          "planes": TINY.n_chan}
    assert all(s.frame == root.id for s in spans)
    assert all(s.parent is not None for s in spans[1:])
    assert counters == {"master.frames": n}

    assert timing.Recorder.active is None
    off_m, off_s = masters.build_master(kind, list(frames), TINY)
    assert rec.drain() == ([], {})
    assert _same(off_m, got_m)
    for k in got_s:
        assert _same(off_s[k], got_s[k]), k
