"""The port's CUDA kernels against their plain PyTorch versions, on the
card: bit for bit, at edge-case shapes.  Marked ``cuda``: they skip
where torch sees no CUDA device.  This file imports no jax, so it runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    nan = torch.isnan(a) & torch.isnan(b) if a.is_floating_point() else None
    eq = a == b if nan is None else (a == b) | nan
    assert bool(eq.all())


SHAPES = [(5, 7), (70, 130), (257, 1031)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [3, 5, 7])
def test_median_kernel(dev, shape, k):
    from blackbox_tpu_torch.ops import filters
    g = torch.Generator(device=dev).manual_seed(k)
    img = 100 + 20 * torch.randn(shape, generator=g, device=dev)
    img[shape[0] // 2, shape[1] // 2] = float("nan")
    img[0, -1] = 1e30
    before = filters.median_filter.launches
    _same(filters.median_filter(img, k), filters._median_plain(img, k, 64))
    assert filters.median_filter.launches == before + 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("iters", [1, 24, 32, 40])
def test_label_kernel(dev, shape, iters):
    from blackbox_tpu_torch.ops import labeling
    g = torch.Generator(device=dev).manual_seed(iters)
    mask = torch.rand(shape, generator=g, device=dev) > 0.45
    H, W = shape
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=dev).reshape(H, W)
    lab0 = torch.where(mask, idx, H * W + 2)
    _same(labeling.label_propagate(lab0, iters),
          labeling._label_propagate_plain(lab0, iters))


@pytest.mark.parametrize("size", [1, 32, 96])
def test_gather_kernel(dev, size):
    from blackbox_tpu_torch.ops import windows
    g = torch.Generator(device=dev).manual_seed(size)
    H, W = 300, 420
    img = torch.randn((H, W), generator=g, device=dev)
    seg = torch.randint(0, 9999, (H, W), generator=g, device=dev,
                        dtype=torch.int32)
    msk = img > 0
    N = 301
    y0 = torch.randint(-9, H + 9, (N,), generator=g, device=dev)
    x0 = torch.randint(-9, W + 9, (N,), generator=g, device=dev)
    for nact in (None, torch.tensor(0, device=dev),
                 torch.tensor(N - 57, device=dev)):
        got = windows.gather_slot_windows((img, seg, msk), y0, x0, size,
                                          n_active=nact)
        ref = windows._gather_plain(
            (img, seg, msk.to(torch.int32)), y0, x0, size, nact)
        _same(got[0], ref[0])
        _same(got[1], ref[1])
        _same(got[2], ref[2].to(torch.bool))


def test_reduce_tiny_card_matches_cpu(dev):
    """The whole slice on a TINY frame: kernels on the card against the
    plain versions on the CPU (masks and counts exact)."""
    import numpy as np
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.pipeline.reduce import (ReduceContext,
                                                    make_reduce_fn)
    from blackbox_tpu_torch.synth.device import make_science_device
    fn = make_reduce_fn(ReduceContext.from_defaults(TINY))
    gen = torch.Generator().manual_seed(5)
    chan, osv, osh, _ = make_science_device(gen, TINY, nstars=40,
                                            ncosmics=12, nsat=2)
    xt = np.random.default_rng(0).uniform(-2e-4, 2e-4, (16, 16)).astype(
        np.float32)
    cpu = fn(chan, osv, osh, None, None, None, xt)
    gpu = fn(chan.to(dev), osv.to(dev), osh.to(dev), None, None, None, xt)
    assert torch.equal(cpu["mask"], gpu["mask"].cpu())
    assert torch.equal(cpu["seg_nsources"], gpu["seg_nsources"].cpu())
    for k in ("nobjects", "ncosmics", "nsats", "nobj_sat"):
        assert int(cpu["stats"][k]) == int(gpu["stats"][k]), k
    atol = 1e-3 + 1e-5 * float(cpu["stats"]["biasm"].abs().max())
    torch.testing.assert_close(gpu["image"].cpu(), cpu["image"], rtol=1e-5,
                               atol=atol)
