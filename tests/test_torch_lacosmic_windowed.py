"""The windowed and pre-screened L.A.Cosmic rounds, the JAX package's
default, against the JAX package.

Both packages' default ``lacosmic`` (a scalar read noise takes the
windowed rounds) run on the same numpy scene at ``cell=16``, on a
150 x 230 frame whose sides are not multiples of the cell: the JAX one
under ``jax.jit`` on the CPU, the port with its plain versions of K2 and
K4.  Cleaned pixels, mask and per-round counts are held bit for bit
(order statistics and the same float32 steps on the same inputs).

The scene is ``torch_parity.track_scene``: ``cosmic_scene`` with twelve
2-px-wide tracks of 2e4-6e4 e- added, and ``sigclip=6, objlim=2``:
cleaning a track's core in round 1 leaves its wings significant, so
round 2 detects new pixels in its windows (the stock scene finds
nothing after round 1).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import assert_exact, n, t  # noqa: E402
from torch_parity import track_scene  # noqa: E402
from blackbox_tpu.ops import cosmics as jcos  # noqa: E402
from blackbox_tpu_torch.ops import cosmics  # noqa: E402

H, W = 150, 230
RDNOISE = 6.0
BASE = dict(cell=16, sigclip=6.0, objlim=2.0, strip_rows=66)


def scene():
    """The track scene at this file's frame size."""
    return track_scene(7, H, W)


def _border(img):
    """Hits in the frame's corners and in its outer three rows and
    columns."""
    for y, x in ((0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1), (1, 40),
                 (2, 97), (H - 2, 150), (H - 3, 61), (70, 1), (33, W - 2),
                 (120, 2), (88, W - 3)):
        img[y, x] += 2.5e4
    return img


def _adjacent(img):
    """Hits on both sides of cell borders (x = 64, y = 48), so that two
    or four neighbouring windows change and their scatter regions
    overlap around the new pixels."""
    for y, x in ((40, 63), (40, 64), (41, 64), (47, 100), (48, 100),
                 (47, 127), (48, 128), (47, 128), (100, 79), (101, 80)):
        img[y, x] += 3e4
    return img


def _nan(img):
    """NaN pixels beside two cosmic hits."""
    img[60, 60] += 3e4
    img[60, 61] = np.nan
    img[110, 170] += 3e4
    img[111, 170] = np.nan
    img[109, 171] = np.nan
    return img


def _tail(img):
    """A hit in the last active cell of the track scene."""
    img[140, 220:222] += 3e4
    return img


CASES = {
    "tracks": (scene, {}, None),
    "border": (lambda: _border(scene()), {}, None),
    "adjacent": (lambda: _adjacent(scene()), {}, None),
    # chunks of 7 over an nact (61) that is not a multiple of 7
    "chunk7": (lambda: _adjacent(scene()), dict(window_chunk=7), None),
    # a cap of 57 whose last chunk of 5 starts clamped at cap - 5, as
    # lax.dynamic_slice_in_dim clamps it, and a hit in the last active
    # cell, which that chunk then never visits
    "chunk_tail": (lambda: _tail(scene()),
                   dict(window_chunk=5, max_cells=57), None),
    "max_cells": (scene, dict(max_cells=2), None),
    "prescreen": (scene, dict(prescreen=True), None),
    "nan": (lambda: _nan(scene()), {}, None),
    "inmask": (scene, {}, (slice(40, 60), slice(90, 130))),
}


@pytest.fixture
def passes(monkeypatch):
    """Each ``_windowed_pass``'s info (nact, branch, chunks, changed)."""
    infos = []
    orig = cosmics._windowed_pass

    def keep(*a, **k):
        out = orig(*a, **k)
        infos.append(out[2])
        return out

    monkeypatch.setattr(cosmics, "_windowed_pass", keep)
    return infos


def _inputs(case):
    make, kw, block = CASES[case]
    img = make()
    inmask = np.zeros((H, W), bool)
    if block is not None:
        inmask[block] = True
    return img, inmask, {**BASE, **kw}


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_lacosmic_matches_jax(case, passes):
    img, inmask, kw = _inputs(case)
    want = jax.jit(lambda a, m, r: jcos.lacosmic(
        a, m, r, jcos.LACosmicParams(**kw)))(
            jnp.asarray(img), jnp.asarray(inmask), jnp.float32(RDNOISE))
    got = cosmics.lacosmic(t(img), t(inmask), torch.tensor(RDNOISE),
                           cosmics.LACosmicParams(**kw))
    assert_exact(got[2], want[2], "counts")
    assert_exact(got[1], want[1], "crmask")
    assert_exact(got[0], want[0], "clean")
    counts = n(got[2])
    assert counts[0] > 0 and counts[1] > 0, counts
    branches = {i["branch"] for i in passes}
    if case == "max_cells":
        assert branches == {"dense"}, passes
    else:
        assert branches == {"windowed"}, passes
    first = passes[0]
    if case == "chunk7":
        assert first["nact"] % 7 and first["chunks"] == -(-first["nact"]
                                                         // 7), passes
    if case == "chunk_tail":
        # the last chunk starts below nact but runs past the cap of 57,
        # so it is the clamped one: the hit in the last active cell stays
        # uncleaned in both packages (a fault of the reference, matched),
        # where the dense rounds clean it
        last = 5 * (first["chunks"] - 1)
        assert last < first["nact"] <= 57 < last + 5, passes
        dense = cosmics.lacosmic(t(img), t(inmask), RDNOISE,
                                 cosmics.LACosmicParams(**kw,
                                                        windowed=False))
        assert n(got[0])[140, 221] > 3e4 > n(dense[0])[140, 221]
    if case == "nan":
        assert np.isnan(n(got[0])).sum() == 3
    if case == "inmask":
        assert not n(got[1])[40:60, 90:130].any()


def test_windowed_matches_dense_rounds(passes):
    """The port's windowed rounds against its own dense rounds on the
    track scene: the same function, bit for bit, with at least one
    windowed detection round."""
    img, inmask, kw = _inputs("adjacent")
    got = cosmics.lacosmic(t(img), t(inmask), RDNOISE,
                           cosmics.LACosmicParams(**kw))
    dense = cosmics.lacosmic(t(img), t(inmask), RDNOISE,
                             cosmics.LACosmicParams(**kw, windowed=False))
    for a, b, what in zip(got, dense, ("clean", "crmask", "counts")):
        assert_exact(a, b, what)
    assert len(passes) == 3 and all(i["branch"] == "windowed"
                                    for i in passes)
    assert n(got[2])[1] > 0
    p = dataclasses.replace(cosmics.LACosmicParams(**kw), prescreen=True)
    for a, b, what in zip(cosmics.lacosmic(t(img), t(inmask), RDNOISE, p),
                          dense, ("clean", "crmask", "counts")):
        assert_exact(a, b, f"prescreen {what}")
