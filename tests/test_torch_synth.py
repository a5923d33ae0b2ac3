"""The port's device-side synthetic frame (synth/device.py) against the
JAX package's: same shapes and layout contract, same statistics of
sky, bias and sources.  The random bits differ (torch.Generator vs
jax.random), so the comparison is of distributions, not pixels."""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

import torch_parity  # noqa: E402,F401  (pins torch threads)
from blackbox_tpu.core.geometry import TINY as JTINY  # noqa: E402
from blackbox_tpu.synth.device import make_science_device as jmake  # noqa: E402
from blackbox_tpu_torch.core.geometry import TINY  # noqa: E402
from blackbox_tpu_torch.synth.device import make_science_device  # noqa: E402


def test_shapes_and_stats_match_jax():
    kw = dict(nstars=30, ncosmics=5, trail=True, nsat=1, sky_e=300.0)
    got = make_science_device(torch.Generator().manual_seed(0), TINY, **kw)
    want = jmake(jax.random.PRNGKey(0), JTINY, **kw)
    for g, w in zip(got[:3], want[:3]):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
    assert len(got[3]["x"]) == len(want[3]["x"]) == 31
    # overscans: bias level 7000..8000 ADU and 4..6 ADU read noise in both
    for g, w in zip(got[1:3], want[1:3]):
        assert 6800 < float(g.mean()) < 8200 and 6800 < float(w.mean()) < 8200
    # data sections: bias + sky/gain, the same within the bias spread
    sky = [float(np.median(np.asarray(c) - np.asarray(v).mean(axis=(1, 2),
                                                             keepdims=True)))
           for c, v in ((got[0], got[1]), (want[0], want[1]))]
    assert all(120 < s < 160 for s in sky), sky          # 300 e- / ~2.1


def test_split_assemble_round_trip(rng):
    from blackbox_tpu.core.geometry import TINY as JG
    raw = rng.normal(size=JG.raw_shape).astype(np.float32)
    got = TINY.split_raw(torch.from_numpy(raw))
    for g, w in zip(got, JG.split_raw(raw)):
        np.testing.assert_array_equal(g.numpy(), w)
    mosaic = rng.normal(size=JG.red_shape).astype(np.float32)
    ch = TINY.disassemble(torch.from_numpy(mosaic))
    np.testing.assert_array_equal(ch.numpy(), JG.disassemble(mosaic))
    np.testing.assert_array_equal(TINY.assemble(ch).numpy(), mosaic)
