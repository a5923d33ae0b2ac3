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


def _same_bits(a, b):
    """As ``_same``, and float zeros must agree in sign."""
    _same(a, b)
    if a.dtype == torch.float32:
        nan = torch.isnan(a) & torch.isnan(b)
        assert bool(((a.view(torch.int32) == b.view(torch.int32))
                     | nan).all())


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


@pytest.mark.parametrize("shape", [(64, 128), (257, 1031), (300, 1024)])
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("fill", ["sprinkled", "plateau"])
def test_median_kernel_special_values(dev, shape, k, fill):
    """K2 on frames with 1% NaN, +inf and -inf each, or with constant
    plateaus and few-valued ties, at widths that do and do not take the
    16-byte path, and from an address that is not 16-byte aligned."""
    from blackbox_tpu_torch.ops import filters
    H, W = shape
    g = torch.Generator(device=dev).manual_seed(H + k)
    img = 100 + 20 * torch.randn(shape, generator=g, device=dev)
    if fill == "sprinkled":
        for v in (float("nan"), float("inf"), -float("inf")):
            hit = torch.rand(shape, generator=g, device=dev) < 0.01
            img = torch.where(hit, torch.full_like(img, v), img)
    else:
        img[:, : W // 3] = 5.0
        img[H // 2:, W // 2:] = torch.round(img[H // 2:, W // 2:] / 20)
        img[: H // 4] = -1.0
    want = filters._median_plain(img, k, 64)
    _same(filters.median_filter(img, k), want)
    buf = torch.empty(H * W + 1, device=dev)
    moved = buf[1:].view(H, W)
    moved.copy_(img)
    _same(filters.median_filter(moved, k), want)


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


def _label_mask(kind, shape, g, dev):
    H, W = shape
    m = torch.zeros(shape, dtype=torch.bool, device=dev)
    if kind == "random":
        m = torch.rand(shape, generator=g, device=dev) > 0.45
    elif kind == "rectangle":               # wider than 2 x 64 steps
        m[20:H - 30, 15:W - 40] = True
    elif kind == "trail":                   # a long diagonal, 2 px wide
        i = torch.arange(min(H, W) - 1, device=dev)
        m[i, i] = True
        m[i, i + 1] = True
    elif kind == "foreground":
        m[:] = True
    elif kind == "sparse":                  # a few blobs, most tiles empty
        for y, x in ((40, 50), (41, 300), (200, 420), (290, 5)):
            m[max(y - 3, 0):y + 4, max(x - 5, 0):x + 5] = True
    return m


@pytest.mark.parametrize("shape", [(300, 457), (260, 460)])
@pytest.mark.parametrize("iters", [1, 16, 32, 48, 64])
@pytest.mark.parametrize("kind", ["random", "rectangle", "trail",
                                  "background", "foreground", "sparse"])
def test_label_kernel_cases(dev, kind, iters, shape):
    """K1's tiles, work list, shrinking region and stop rule, bit for bit
    against the plain version: blobs wider than 2 x iters, which never
    go still, empty and full frames, a sparse map, on frames that are
    not a multiple of either tile side, with rows of 4-byte and of
    16-byte alignment; one launch up to 64 steps."""
    from blackbox_tpu_torch.ops import labeling
    g = torch.Generator(device=dev).manual_seed(iters)
    mask = _label_mask(kind, shape, g, dev)
    H, W = shape
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=dev).reshape(H, W)
    lab0 = torch.where(mask, idx, H * W + 2)
    before = labeling.label_propagate.launches
    _same(labeling.label_propagate(lab0, iters),
          labeling._label_propagate_plain(lab0, iters))
    assert labeling.label_propagate.launches == before + 1


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
    ctx = ReduceContext.from_defaults(TINY)
    gen = torch.Generator().manual_seed(5)
    chan, osv, osh, _ = make_science_device(gen, TINY, nstars=40,
                                            ncosmics=12, nsat=2)
    xt = np.random.default_rng(0).uniform(-2e-4, 2e-4, (16, 16)).astype(
        np.float32)
    cpu = make_reduce_fn(ctx, device="cpu")(chan, osv, osh, None, None,
                                            None, xt)
    gpu = make_reduce_fn(ctx)(chan, osv, osh, None, None, None, xt)
    assert gpu["image"].device.type == "cuda"
    assert torch.equal(cpu["mask"], gpu["mask"].cpu())
    assert torch.equal(cpu["seg_nsources"], gpu["seg_nsources"].cpu())
    for k in ("nobjects", "ncosmics", "nsats", "nobj_sat"):
        assert int(cpu["stats"][k]) == int(gpu["stats"][k]), k
    atol = 1e-3 + 1e-5 * float(cpu["stats"]["biasm"].abs().max())
    torch.testing.assert_close(gpu["image"].cpu(), cpu["image"], rtol=1e-5,
                               atol=atol)
    assert int(cpu["stats"]["psf_nstars"]) == int(gpu["stats"]["psf_nstars"])


@pytest.mark.parametrize("N", [96, 160, 168, 352, 384, 1024, 2688, 10752])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernel(dev, N, inverse):
    """K6 against its plain version: every supported odd factor, N1 from
    8 to 1024, column counts that do and do not fill a block."""
    from blackbox_tpu_torch.ops import fft
    g = torch.Generator(device=dev).manual_seed(N + inverse)
    for L in ((1, 37, 128) if N <= 2688 else (64,)):
        xr = torch.randn((N, L), generator=g, device=dev)
        xi = torch.randn((N, L), generator=g, device=dev)
        scale = 1.0 / N if inverse else 1.0
        before = fft.fft_cols_split.launches
        got = fft.fft_cols_split(xr, xi, inverse, scale)
        assert fft.fft_cols_split.launches == before + 1
        ref = fft._fft_cols_plain(xr, xi, inverse, scale)
        _same(got[0], ref[0])
        _same(got[1], ref[1])


@pytest.mark.parametrize("N", [168, 96, 224, 1024, 6144, 4096, 8192])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernel_block_shapes(dev, N, inverse):
    """K6's radix blocks (C = 16, 8, 4, 2, 1 columns for N1 <= 512,
    1024, 2048, 4096, 8192), the short last group of every k mod 3, with
    and without step A (N2 = 1; N2 = 3, 7 and 21 with it), at column
    counts around each block width."""
    from blackbox_tpu_torch.ops import fft
    g = torch.Generator(device=dev).manual_seed(N + inverse)
    for L in (1, 3, 7, 8, 9, 15, 16, 17, 33):
        xr = torch.randn((N, L), generator=g, device=dev)
        xi = torch.randn((N, L), generator=g, device=dev)
        scale = 1.0 / N if inverse else 1.0
        got = fft.fft_cols_split(xr, xi, inverse, scale)
        ref = fft._fft_cols_plain(xr, xi, inverse, scale)
        _same(got[0], ref[0])
        _same(got[1], ref[1])


def test_fft2_kernel_is_a_dft(dev):
    """fft2_split on the card, unscrambled, against torch.fft.fft2 (a
    check of the algorithm, not of the bits: 2e-5 of the spectrum's
    scale, float32 transforms of 10^5 points), and the inverse
    round trip."""
    from blackbox_tpu_torch.ops import fft
    g = torch.Generator(device=dev).manual_seed(1)
    xr = torch.randn((384, 1024), generator=g, device=dev)
    xi = torch.randn((384, 1024), generator=g, device=dev)
    yr, yi = fft.fft2_split(xr, xi)
    want = torch.fft.fft2(torch.complex(xr, xi))
    got = fft.unscramble2(yr, yi)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 2e-5 * scale
    zr, zi = fft.ifft2_split(yr, yi)
    assert float((zr - xr).abs().max()) < 1e-5
    assert float((zi - xi).abs().max()) < 1e-5


def _detect_inputs(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    H, W = shape
    img = torch.randn(shape, generator=g, device=dev)
    ys = torch.randint(0, H, (max(H * W // 400, 1),), generator=g,
                       device=dev)
    xs = torch.randint(0, W, ys.shape, generator=g, device=dev)
    img[ys, xs] += 40.0
    img[0, :] += 5.0                         # a source on the border row
    std = 0.5 + torch.rand(shape, generator=g, device=dev)
    std[H // 3, W // 3] = float("nan")
    std[H // 2, W // 2] = 0.0
    excl = torch.rand(shape, generator=g, device=dev) > 0.97
    return img, std, excl


@pytest.mark.parametrize("shape", [(5, 7), (70, 130), (257, 1031),
                                   (600, 530)])
@pytest.mark.parametrize("form", ["detect", "transient", "bare"])
def test_detect_kernel(dev, shape, form):
    """K5 against its plain version in the detection form (9 taps, std
    map, exclusion, 32 steps), the transient form (|x|, no taps, no std,
    exclusion, 48 steps) and a bare form (no std, no exclusion)."""
    from blackbox_tpu_torch.ops import detection
    img, std, excl = _detect_inputs(dev, shape, sum(shape))
    taps = detection.gaussian_taps(3.0)
    args = {"detect": (img, std, excl, taps, 1.5, 32, False),
            "transient": (3.0 * img, None, excl, None, 6.0, 48, True),
            "bare": (img, None, None, taps, 2.0, 24, False)}[form]
    before = detection.fused_detect.launches
    seg, n = detection.fused_detect(*args[:5], iters=args[5],
                                    absval=args[6])
    assert detection.fused_detect.launches == before + 1
    seg_p, n_p = detection._fused_detect_plain(*args)
    _same(seg, seg_p)
    _same(n, n_p)
    assert n.device.type == "cuda"


def _detect_case(kind, shape, g, dev):
    """Image, std map and exclusion of one K5 case on the card."""
    H, W = shape
    img = torch.randn(shape, generator=g, device=dev)
    std = 0.8 + 0.4 * torch.rand(shape, generator=g, device=dev)
    excl = torch.zeros(shape, dtype=torch.bool, device=dev)
    if kind == "empty":
        img.zero_()
    elif kind == "full":
        img.fill_(50.0)
    elif kind == "sparse":                  # most tiles hold no detection
        for y, x in ((10, 12), (40, 300), (200, 420), (290, 5)):
            img[max(y - 2, 0):y + 3, max(x - 3, 0):x + 4] += 30.0
    elif kind == "border":                  # every edge and corner
        img[0, 20:30] += 40.0
        img[H - 1, 100:140] += 40.0
        img[30:50, 0] += 40.0
        img[5:9, W - 1] += 40.0
        img[0, 0] = img[H - 1, W - 1] = 90.0
    elif kind == "nanstd":                  # NaN and 0 in the std map
        img[20:26, 30:36] += 30.0
        std[22, 32] = float("nan")
        std[50:53, 100:103] = 0.0
        std[torch.rand(shape, generator=g, device=dev) < 0.02] = float("nan")
        img[60, 70] = float("nan")
    elif kind == "excl":                    # exclusions over sources
        img[30:40, 20:60] += 30.0
        excl[33:36, :] = True
        excl |= torch.rand(shape, generator=g, device=dev) < 0.05
    return img, std, excl


def _misaligned(x):
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte boundary
    (for bool, 1 byte past)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("fwhm", [3.0, 4.5])
@pytest.mark.parametrize("align", [16, 4])
@pytest.mark.parametrize("iters", [1, 24, 32, 48, 56, 64])
@pytest.mark.parametrize("kind", ["empty", "full", "sparse", "border",
                                  "nanstd", "excl"])
def test_detect_kernel_cases(dev, kind, iters, align, fwhm):
    """K5's scan and listed-tile steps bit for bit against the plain
    version, in the detection and the transient form, on empty, full
    and sparse frames, sources on the border, NaN and 0 in the std map
    and exclusions, with rows of 16-byte and of 4-byte alignment, a
    filter of 9 and of 13 taps (FWHM 3 and 4.5 px); one call up to 64
    steps (two launches; 16 x 16 tiles above 60 steps)."""
    from blackbox_tpu_torch.ops import detection
    g = torch.Generator(device=dev).manual_seed(iters + len(kind))
    img, std, excl = _detect_case(kind, (300, 460), g, dev)
    if align == 4:
        img, std, excl = (_misaligned(x) for x in (img, std, excl))
        assert img.data_ptr() % 16 != 0
    taps = detection.gaussian_taps(fwhm)
    assert len(taps) == {3.0: 9, 4.5: 13}[fwhm]
    for args in ((img, std, excl, taps, 1.5, iters, False),
                 (3.0 * img if align == 16 else _misaligned(3.0 * img),
                  None, excl, None, 6.0, iters, True)):
        before = detection.fused_detect.launches
        seg, n = detection.fused_detect(*args[:5], iters=iters,
                                        absval=args[6])
        assert detection.fused_detect.launches == before + 1
        seg_p, n_p = detection._fused_detect_plain(*args)
        _same(seg, seg_p)
        _same(n, n_p)


def test_detect_segments_switch(dev, monkeypatch):
    """BBTPU_PALLAS_DETECT=1 routes detect_segments through K5 on a
    frame of at least 512 x 512, with the same segments as the route
    through K1."""
    from blackbox_tpu_torch.ops import detection
    img, std, excl = _detect_inputs(dev, (600, 530), 4)
    p = detection.DetectParams()
    monkeypatch.delenv("BBTPU_PALLAS_DETECT", raising=False)
    seg0, n0 = detection.detect_segments(img, std, excl, p)
    monkeypatch.setenv("BBTPU_PALLAS_DETECT", "1")
    before = detection.fused_detect.launches
    seg1, n1 = detection.detect_segments(img, std, excl, p)
    assert detection.fused_detect.launches == before + 1
    _same(seg1, seg0)
    assert int(n1) == int(n0)


def test_science_tiny_card_matches_cpu(dev):
    """The TINY science step with the split FFT: the card (K1, K2, K4,
    K6) against the CPU (plain versions).  The transforms are bit-equal;
    the small DFT matmuls and reductions round differently, so the maps
    are held at the CPU parity tests' tolerances
    (tests/test_torch_science.py) and the catalog's counts exactly."""
    import numpy as np
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.ops import fft, warp
    from blackbox_tpu_torch.ops.zogy import ZogyParams
    from blackbox_tpu_torch.pipeline import subtract
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext
    from blackbox_tpu_torch.synth.device import make_science_device
    ctx = ReduceContext.from_defaults(TINY)
    gen = torch.Generator().manual_seed(11)
    chan, osv, osh, _ = make_science_device(gen, TINY, nstars=40,
                                            ncosmics=4, nsat=0)
    H, W = TINY.red_shape
    step, fr = 32, 1.6
    gy = np.arange(0, H + step, step, dtype=np.float32)
    gx = np.arange(0, W + step, step, dtype=np.float32)
    sy = np.broadcast_to(gy[:, None] + 3, (len(gy), len(gx))).copy()
    sx = np.broadcast_to(gx[None, :] - 2, (len(gy), len(gx))).copy()
    ranges = warp.grid_shift_ranges(sy, sx, step=step)
    outs = {}
    for device in ("cpu", "cuda"):
        front, back = subtract.make_science_programs(
            ctx, zogy_params=ZogyParams(fft="split"), remap_ranges=ranges,
            remap_step=step, device=device)
        ref = front(chan, osv, osh, None, None, None)
        roll = lambda a: torch.roll(a, (3, -2), (0, 1))  # noqa: E731
        cat = ref["cat"]
        before = fft.fft_cols_split.launches
        b = back(ref["sub"], ref["bkg_std"], ref["mask"], ref["psf_centre"],
                 cat, ref["stats"]["bkg_std"], roll(ref["sub"] * fr),
                 roll(ref["bkg_std"] * fr), roll(ref["mask"]), (sy, sx),
                 ref["psf_centre"], ref["stats"]["bkg_std"] * fr,
                 {"x": cat["x"], "y": cat["y"], "flux": cat["flux_psf"] * fr,
                  "fluxerr": cat["fluxerr_psf"] * fr, "valid": cat["valid"]})
        if device == "cuda":
            assert b["D"].device.type == "cuda"
            # five 2-D transforms: at 132 rows the squared kernels take
            # the full-frame path (kernel_stamp 256 exceeds the frame)
            assert fft.fft_cols_split.launches == before + 10
        outs[device] = b
    cpu, gpu = outs["cpu"], outs["cuda"]
    for k in ("D", "Fpsf"):
        scale = float(cpu[k].abs().max())
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=0,
                                   atol=2e-4 * scale)
    # Scorr inside the 26-px border band (the PSF stamp's width, under
    # the EDGE bit in production): at the frame edge V[S] is a few
    # near-cancelling sums and its rounding moved 9 edge pixels by more
    interior = (slice(26, -26), slice(26, -26))
    torch.testing.assert_close(gpu["Scorr"].cpu()[interior],
                               cpu["Scorr"][interior], rtol=0.05, atol=3e-3)
    gs, cs = gpu["trans_stats"], cpu["trans_stats"]
    assert int(gs["t_ntrans"]) == int(cs["t_ntrans"])
    # every matched star's flux ratio is 1.6 to a few ulps here, so the
    # 3-MAD clip (a MAD at the ulp level) keeps a rounding-dependent
    # subset: the counts are not compared, the ratio is
    assert min(int(gs["z_nmatch"]), int(cs["z_nmatch"])) >= 10
    assert abs(float(gs["z_fratio"]) / float(cs["z_fratio"]) - 1) < 1e-5
    assert abs(float(gs["z_fratio"]) / fr - 1) < 0.05


def _k7_inputs(dev, shape, seed):
    """Sky + cosmic hits; a NaN and an inmask block with one-pixel holes
    (a hole whose pixel is flagged has an all-bad 5x5 neighbourhood);
    the left third of the frame is constant, so sp == 0 there."""
    g = torch.Generator(device=dev).manual_seed(seed)
    H, W = shape
    img = 300.0 + 17.0 * torch.randn(shape, generator=g, device=dev)
    img[:, : W // 3] = 300.0
    n = max(H * W // 500, 1)
    ys = torch.randint(0, H, (n,), generator=g, device=dev)
    xs = torch.randint(0, W, (n,), generator=g, device=dev)
    img[ys, xs] += 2e4
    inm = torch.zeros(shape, dtype=torch.bool, device=dev)
    for y in range(4, H - 9, 23):
        for x in range(4, W - 9, 31):
            inm[y:y + 9, x:x + 9] = True
            inm[y + 4, x + 4] = False
    if H > 20 and W > 20:
        img[H // 2, W // 2] = float("nan")
    return img, inm


@pytest.mark.parametrize("shape", [(5, 7), (70, 130), (300, 1031),
                                   (264, 1536)])
@pytest.mark.parametrize("thresholds", ["production", "zero"])
def test_lacosmic_kernel(dev, shape, thresholds):
    """K7 over 3 iterations against its plain version: widths that are
    and are not a multiple of 512, a NaN, all-bad neighbourhoods, and
    (at zero thresholds) gt ties, sp == 0 == sigclip, on the constant
    third of the frame."""
    from blackbox_tpu_torch.ops import lacosmic_fused as K7
    img, inm = _k7_inputs(dev, shape, sum(shape))
    kw = (dict(sigclip=15.0, sigfrac=0.01, objlim=3.0)
          if thresholds == "production"
          else dict(sigclip=0.0, sigfrac=0.0, objlim=0.0))
    rdn = torch.tensor(6.0, device=dev)
    before = K7.lacosmic_fused.launches
    got = K7.lacosmic_fused(img, inm, rdn, niter=3, **kw)
    assert K7.lacosmic_fused.launches == before + 3
    want = K7._lacosmic_plain(img, inm, rdn, niter=3, **kw)
    for a, b in zip(got, want):
        _same(a, b)
    assert got[0].device.type == "cuda"


def _k7_case(kind, dev):
    """A (70, 130) sky with stars and isolated cosmics, plus the case's
    specials (as tests/test_torch_lacosmic_fused.py's predicate frames)."""
    H, W = 70, 130
    g = torch.Generator(device=dev).manual_seed(len(kind))
    img = 100.0 + 10.0 * torch.randn((H, W), generator=g, device=dev)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    for y, x in ((10, 12), (48, 95)):
        img += 4e3 * torch.exp(-0.5 * ((yy - y) ** 2 + (xx - x) ** 2) / 2.0)
    img += 3e4 * torch.exp(-0.5 * ((yy - 60) ** 2 + (xx - 20) ** 2) / 0.8)
    for y, x in ((5, 30), (20, 8), (53, 60), (15, 110)):
        img[y, x] += 2e4
    inm = torch.zeros((H, W), dtype=torch.bool, device=dev)
    rdn = 6.0
    if kind == "zeros":
        img[2:8, 2:8] = 0.0
        img[12, 30] = -0.0
        img[torch.rand((H, W), generator=g, device=dev) < 0.03] = -0.0
    elif kind == "nan":
        img[18, 25] = float("nan")
        img[3, 50] = float("nan")
    elif kind == "inf":
        img[8, 40] = float("inf")
        img[30, 10] = float("-inf")
    elif kind == "ties":
        img[20:23, 30:33] = 1e30
        img[5, 5] = 1e30
    elif kind == "huge":
        img[10, 20] = 2.0 ** 100
        img[25, 40] = -3e38
        img[30, 5] = 1e35
    elif kind == "clustered":
        img[10:13, 30:34] += 2e4
        img[11, 35] += 2e4
        img[46:48, 72:74] += 3e4
    elif kind == "allbad":
        inm[5:14, 20:29] = True
        img[9, 24] += 2e4
        inm[30:36, 40:46] = True
        img[32, 38] += 2e4
    elif kind == "rdn_nan":
        rdn = float("nan")
    elif kind == "rdn_inf":
        rdn = float("inf")
    elif kind == "overflow":
        from torch_parity import K7_OVERFLOW_PATCH
        img[10:32, 15:37] = 100.0
        img[18:24, 23:30] = torch.from_numpy(K7_OVERFLOW_PATCH).to(dev)
        rdn = 0.0
    return img, inm, torch.tensor(rdn, device=dev)


K7_THRESHOLDS = {"production": (15.0, 0.01, 3.0), "zero": (0.0, 0.0, 0.0),
                 "objlim_nan": (15.0, 0.01, float("nan"))}


@pytest.mark.parametrize("thresholds", list(K7_THRESHOLDS))
@pytest.mark.parametrize("kind", ["plain", "zeros", "nan", "inf", "ties",
                                  "huge", "clustered", "allbad", "rdn_nan",
                                  "rdn_inf", "overflow"])
def test_lacosmic_kernel_skip_cases(dev, kind, thresholds):
    """K7's sparse 7x7 median and sparse clean over 3 iterations against
    the plain version, bit for bit, on +-0, NaN, +-inf, 1e30 ties with
    the blend's BIG, values around the skip tests' 2^100 bound, clustered
    hits, all-bad neighbourhoods, a NaN and an infinite read noise, a
    ratio m3 / noise that overflows and a NaN objlim (the frames of
    tests/test_torch_lacosmic_fused.py, on which each clause of the skip
    tests is needed); the first iteration lists pixels for both where
    both have work, and at the production thresholds no iteration lists
    all (under a NaN read noise or objlim the 7x7 median runs
    everywhere)."""
    from blackbox_tpu_torch.ops import lacosmic_fused as K7
    img, inm, rdn = _k7_case(kind, dev)
    sigclip, sigfrac, objlim = K7_THRESHOLDS[thresholds]
    got = K7._run_cuda(img, inm, rdn, sigclip, sigfrac, objlim, 3)
    want = K7._lacosmic_plain(img, inm, rdn, sigclip, sigfrac, objlim, 3)
    for a, b in zip(got[:3], want):
        _same_bits(a, b)
    Hp, Wp = K7.padded_shape(*img.shape)
    He, We = Hp + 2 * K7.HALO, Wp + 2 * K7.HALO
    listed = got[3].tolist()
    if kind != "rdn_inf":
        assert listed[0][0] > 0 and listed[0][1] > 0
    for n7, nc in listed:
        assert 0 <= n7 <= He * We and 0 <= nc <= Hp * Wp
        if kind == "rdn_nan" or thresholds == "objlim_nan":
            assert n7 == He * We
        elif thresholds == "production":
            assert n7 < He * We and nc < Hp * Wp


@pytest.mark.parametrize("thresholds", list(K7_THRESHOLDS))
def test_lacosmic_iteration_from_mask(dev, thresholds):
    """One K7 iteration from a cosmic mask that holds NaN, 0.5, 2.0 and
    1e30 (outside the [0, 1] the clean's skip test asks of its 5x5
    window) against the plain iteration on the padded planes, bit for
    bit."""
    import torch.nn.functional as F
    from blackbox_tpu_torch.ops import lacosmic_fused as K7
    img, inm, rdn = _k7_case("plain", dev)
    H, W = img.shape
    Hp, Wp = K7.padded_shape(H, W)
    crm = torch.zeros((Hp, Wp), device=dev)
    crm[12, 20] = float("nan")
    crm[25, 33] = 2.0
    crm[30, 50] = 1e30
    crm[8, 8] = 0.5
    total = torch.zeros((), dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    got = K7._iter_cuda(img, inm.view(torch.uint8), crm, rdn,
                        *K7_THRESHOLDS[thresholds], (Hp, Wp), total, counts)

    def pad(x):
        return F.pad(x[None], (0, Wp - W, 0, Hp - H), mode="replicate")[0]

    want = K7._iter_plain(pad(img), pad(inm.float()), crm, rdn,
                          *K7_THRESHOLDS[thresholds])
    for a, b in zip(got, want):
        _same_bits(a, b)
    assert int(counts[1]) > 0


@pytest.mark.parametrize("shape, box, nmesh", [
    ((200, 650), 128, 1),          # a mesh of one row
    ((520, 650), 130, 2),
    ((1024, 1024), 128, 1),
    ((257, 1031), 64, 3),
])
def test_upsample_kernel(dev, shape, box, nmesh):
    """K3 against its plain version, bit for bit, and against the
    matmul pair at 1e-3 e- on a 200 e- mesh."""
    from blackbox_tpu_torch.ops import upsample
    from blackbox_tpu_torch.ops.background import _catmull_rom_matrix
    g = torch.Generator(device=dev).manual_seed(box)
    H, W = shape
    ny, nx = H // box, W // box
    meshes = tuple(200.0 + 5.0 * torch.randn((ny, nx), generator=g,
                                             device=dev)
                   for _ in range(nmesh))
    Wy = torch.tensor(_catmull_rom_matrix(H, ny, box), device=dev)
    Wx = torch.tensor(_catmull_rom_matrix(W, nx, box), device=dev)
    before = upsample.upsample_mesh.launches
    got = upsample.upsample_mesh(meshes, Wy, Wx, (H, W))
    assert upsample.upsample_mesh.launches == before + 1
    want = upsample._upsample_plain(meshes, Wy, Wx, (H, W))
    for a, b, m in zip(got, want, meshes):
        _same(a, b)
        assert float((a - Wy @ m @ Wx.T).abs().max()) < 1e-3


def _weights(kind, n_out, n_mesh, g, dev):
    """Catmull-Rom weights (bands of 4), random weights in bands of 6
    with a zero inside each (the union of 4 columns' bands stays within
    the kernel's 8 registers), or dense random weights (the full range,
    the kernel's global-memory path)."""
    from blackbox_tpu_torch.ops.background import _catmull_rom_matrix
    if kind == "catmull":
        return torch.tensor(_catmull_rom_matrix(n_out, n_mesh,
                                                n_out // n_mesh), device=dev)
    w = torch.randn((n_out, n_mesh), generator=g, device=dev)
    if kind == "dense":
        return w
    lo = (torch.arange(n_out, device=dev) * (n_mesh - 6)) // max(n_out - 1, 1)
    j = torch.arange(n_mesh, device=dev)[None]
    band = (j >= lo[:, None]) & (j < lo[:, None] + 6) & (j != lo[:, None] + 2)
    return torch.where(band, w, 0.0)


@pytest.mark.parametrize("W", [1028, 1030])
@pytest.mark.parametrize("weights", ["catmull", "banded", "dense"])
@pytest.mark.parametrize("mesh_kind", ["finite", "inf", "nan"])
def test_upsample_kernel_bands(dev, W, weights, mesh_kind):
    """K3's band-limited sums against its plain version, bit for bit:
    bands wider than 4 and the dense range, meshes with an inf or a NaN
    (0 * inf must give NaN where the dense sum has it), widths that do
    and do not take the 16-byte path."""
    from blackbox_tpu_torch.ops import upsample
    g = torch.Generator(device=dev).manual_seed(W)
    H, ny, nx = 300, 7, 12
    mesh = 200.0 + 5.0 * torch.randn((ny, nx), generator=g, device=dev)
    if mesh_kind != "finite":
        mesh[3, 5] = float(mesh_kind)
    other = 100.0 + torch.randn((ny, nx), generator=g, device=dev)
    Wy = _weights(weights, H, ny, g, dev)
    Wx = _weights(weights, W, nx, g, dev)
    got = upsample.upsample_mesh((mesh, other), Wy, Wx, (H, W))
    want = upsample._upsample_plain((mesh, other), Wy, Wx, (H, W))
    for a, b in zip(got, want):
        _same(a, b)
    assert bool(torch.isfinite(got[1]).all())
    assert bool(torch.isfinite(got[0]).all()) == (mesh_kind == "finite")


def _to(x, device):
    """Tensors (in dicts and dataclasses too) moved to ``device``."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), device)
            for f in dataclasses.fields(x)})
    return x


def test_resamplers_card_matches_cpu(dev):
    """The gather resamplers and the two-pass remap on the card against
    the CPU, on a rotated mapping: nearest samples exactly, Lanczos
    sums at rtol 1e-5 of the frame's level."""
    import numpy as np
    from blackbox_tpu_torch.astro.wcs import TanWCS
    from blackbox_tpu_torch.ops import warp
    H = W = 256
    wn = TanWCS.simple(150.0, -30.0, 0.5642, (H, W))
    wr = TanWCS.simple(150.0015, -29.9985, 0.5642, (H, W), rot_deg=3.0)
    g = torch.Generator().manual_seed(4)
    img = 100 + 10 * torch.randn((H, W), generator=g)
    mask = (torch.rand((H, W), generator=g) < 0.05).to(torch.uint8) * 4
    ys, xs = (torch.from_numpy(a) for a in warp.remap_grid(wr, wn, (H, W)))
    atol = 1e-5 * float(img.abs().max())
    got = warp.lanczos_resample(img.to(dev), ys.to(dev), xs.to(dev))
    torch.testing.assert_close(got.cpu(), warp.lanczos_resample(img, ys, xs),
                               rtol=1e-5, atol=atol)
    _same(warp.nearest_resample(mask.to(dev), ys.to(dev), xs.to(dev)).cpu(),
          warp.nearest_resample(mask, ys, xs))
    grid = warp.remap_grid_coarse(wr, wn, (H, W), step=32)
    margin = warp.grid_row_margin(grid[0], step=32)
    modes, fills = ("lanczos", "nearest"), (0.0, 64)
    cpu = warp.resample_blocked((img, mask), modes, fills, grid,
                                block_rows=64, margin=margin)
    gpu = warp.resample_blocked((img.to(dev), mask.to(dev)), modes, fills,
                                grid, block_rows=64, margin=margin)
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-5, atol=atol)
    _same(gpu[1].cpu(), cpu[1])
    sy, sx, _, _ = grid
    ranges = warp.grid_shift_ranges(sy, sx, step=32, blocks=8)
    coarse = (torch.tensor(sy, dtype=torch.float32),
              torch.tensor(sx, dtype=torch.float32), 32)
    cpu = warp.warp_shift2pass((img, mask), modes, fills, coarse, ranges)
    gpu = warp.warp_shift2pass((img.to(dev), mask.to(dev)), modes, fills,
                               (coarse[0].to(dev), coarse[1].to(dev), 32),
                               ranges)
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], rtol=1e-5, atol=atol)
    _same(gpu[1].cpu(), cpu[1])


def _port_product(img, wcs):
    """Background, detection, photometry and PSF of one synthetic frame
    by the port on the CPU, as a SubtractionInput."""
    from blackbox_tpu_torch.ops.background import background_mesh, mini2back
    from blackbox_tpu_torch.ops.detection import (DetectParams,
                                                  detect_segments,
                                                  moments_shape,
                                                  segment_catalog)
    from blackbox_tpu_torch.ops.photometry import aperture_photometry
    from blackbox_tpu_torch.ops.psf import (PSFParams, build_psf,
                                            psf_photometry)
    from blackbox_tpu_torch.pipeline.subtract import SubtractionInput
    img = torch.as_tensor(img)
    mesh, stdm = background_mesh(img, None, 64)
    bkg = mini2back(mesh, img.shape, 64)
    bstd = mini2back(stdm, img.shape, 64)
    sub = img - bkg
    params = DetectParams(nsigma=2.0, max_sources=256, label_iters=32)
    seg, n = detect_segments(sub, bstd, None, params)
    cat = segment_catalog(sub, bstd, seg, n, params)
    cat.update(moments_shape(cat))
    flux, ferr = aperture_photometry(sub, bstd, cat["x"], cat["y"],
                                     (2.0, 5.0, 12.0))
    cat["snr"] = flux[:, -1] / torch.clamp(ferr[:, -1], min=1e-9)
    model = build_psf(sub, bstd, cat, tuple(img.shape),
                      PSFParams(size=25, poldeg=1, snr_min=10.0))
    fpsf, fpsferr = psf_photometry(sub, bstd, model, cat["x"], cat["y"])
    return SubtractionInput(
        image=img, bkg=bkg, bkg_std=bstd,
        mask=torch.zeros(img.shape, dtype=torch.uint8), psf=model, wcs=wcs,
        cat_x=cat["x"].numpy(), cat_y=cat["y"].numpy(),
        cat_flux=fpsf.numpy(), cat_fluxerr=fpsferr.numpy(),
        cat_valid=cat["valid"].numpy())


@pytest.mark.parametrize("kind", ["shift2pass", "blocked"])
def test_run_subtraction_card_matches_cpu(dev, kind):
    """run_subtraction on both remap branches (a few-pixel pointing
    offset, a 3-degree rotation), the card against the CPU at the CPU
    parity tests' tolerances (tests/test_torch_subtract.py)."""
    import numpy as np
    from blackbox_tpu_torch.astro.wcs import TanWCS
    from blackbox_tpu_torch.pipeline import subtract
    from blackbox_tpu_torch.synth.generator import star_image
    H = W = 256
    ra, dec, rot = {"shift2pass": (150.0 + 1.9 / 3600, -30.0 - 1.2 / 3600,
                                   0.0),
                    "blocked": (150.0015, -29.9985, 3.0)}[kind]
    w_new = TanWCS.simple(150.0, -30.0, 0.5642, (H, W))
    w_ref = TanWCS.simple(ra, dec, 0.5642, (H, W), rot_deg=rot)
    rng = np.random.default_rng(42)
    xn, yn = rng.uniform(30, W - 30, 25), rng.uniform(30, H - 30, 25)
    fl = np.exp(rng.uniform(np.log(8e3), np.log(8e4), 25))
    xr, yr = w_ref.sky2pix(*w_new.pix2sky(xn, yn))
    tx, ty = 101.4, 166.8
    img_n = rng.poisson(star_image((H, W), np.stack(
        [xn, yn, fl, np.full(25, 3.2)], 1), moffat_beta=20.0) + 60.0
        + star_image((H, W), [[tx, ty, 4e4, 3.2]], moffat_beta=20.0))
    img_r = rng.poisson(star_image((H, W), np.stack(
        [xr, yr, fl * 1.8, np.full(25, 2.6)], 1), moffat_beta=20.0) + 110.0)
    new = _port_product(img_n.astype(np.float32), w_new)
    ref = _port_product(img_r.astype(np.float32), w_ref)
    cpu = subtract.run_subtraction(new, ref)
    gpu = subtract.run_subtraction(_to(new, dev), _to(ref, dev))
    assert gpu.D.device.type == "cuda"
    for k in ("z_fratio", "z_fratio_std", "z_dxrms", "z_dyrms", "z_nmatch",
              "t_ntrans", "t_npos", "t_nneg", "t_nvetted"):
        assert gpu.stats[k] == cpu.stats[k], k
    scale = float(cpu.D.abs().max())
    torch.testing.assert_close(gpu.D.cpu(), cpu.D, rtol=0, atol=2e-4 * scale)
    torch.testing.assert_close(gpu.Scorr.cpu(), cpu.Scorr, rtol=0.05,
                               atol=3e-3)
    for k in ("valid", "sign"):
        _same(gpu.trans_cat[k].cpu(), cpu.trans_cat[k])
    v = cpu.trans_cat["valid"]
    d = torch.hypot(gpu.trans_cat["x"].cpu()[v] - tx,
                    gpu.trans_cat["y"].cpu()[v] - ty)
    assert float(d.min()) < 1.5


def test_process_file_card_matches_cpu(dev, tmp_path):
    """One TINY object frame through the port's Pipeline on the card and
    on the CPU, in two copies of one raw tree: the same status, product
    names, keywords and flags, integer keywords and the mask bit for
    bit."""
    import os
    import shutil
    import numpy as np
    from blackbox_tpu_torch.config.defaults import ReductionSettings
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.io.rice import read_rice
    from blackbox_tpu_torch.orchestration.paths import DataTree
    from blackbox_tpu_torch.pipeline.driver import Pipeline
    from blackbox_tpu_torch.synth.observation import write_observation
    raw = os.path.join("ML1", "raw", "ML1_20260301_231200.fits")
    src = tmp_path / "raw"
    write_observation(str(src / raw), TINY, np.random.default_rng(5),
                      "object", mjd_start=61100.97, nstars=40, ncosmics=10,
                      trail=False, nsat=0, sky_e=300.0)
    s = ReductionSettings(geometry=TINY, create_ref=True,
                          make_quicklooks=False)
    res = {}
    for device in ("cpu", "cuda"):
        root = str(tmp_path / device)
        shutil.copytree(src, root)
        pipe = Pipeline(DataTree(root, "ML1"), "ML1", s, device=device)
        res[device] = (root, pipe.process_file(os.path.join(root, raw)))
    (rc, cpu), (rg, gpu) = res["cpu"], res["cuda"]
    assert cpu.status == gpu.status == "reduced", (cpu.error, gpu.error)
    assert [os.path.relpath(p, rc) for p in cpu.products] == \
        [os.path.relpath(p, rg) for p in gpu.products]
    assert set(cpu.header.keys()) == set(gpu.header.keys())
    for k in cpu.header.keys():
        a, b = cpu.header[k], gpu.header[k]
        if not isinstance(a, float):
            assert type(a) is type(b) and a == b, k
    mask = [p for p in cpu.products if p.endswith("_mask.fits.fz")]
    assert len(mask) == 1
    a, _ = read_rice(mask[0])
    b, _ = read_rice(os.path.join(rg, os.path.relpath(mask[0], rc)))
    assert np.array_equal(a, b)


# ------------------------------------------------------------- co-add

COADD_HW = 256


def _coadd_inputs(mini: bool):
    """Five dithered, rotated inputs of one field (the port's RefInputs
    on the CPU): a bright star, a saturated footprint near a block seam
    with an outlier inside its protection zone, a cosmic, and a
    background STD that is the Catmull-Rom upsample of a mini mesh
    (carried along when ``mini``)."""
    import numpy as np
    from blackbox_tpu_torch.astro.wcs import TanWCS
    from blackbox_tpu_torch.core import maskbits as mb
    from blackbox_tpu_torch.ops.background import mini2back
    from blackbox_tpu_torch.pipeline.buildref import RefInput
    from blackbox_tpu_torch.synth.generator import star_image
    H = W = COADD_HW
    rng = np.random.default_rng(12)
    out_wcs = TanWCS.simple(150.0, -30.0, 0.5642, (H, W))
    inputs = []
    for i in range(5):
        w = TanWCS.simple(150.0 + 1e-4 * i, -30.0 - 5e-5 * i, 0.5642,
                          (H, W), rot_deg=0.3 * i)
        xi, yi = w.sky2pix(*out_wcs.pix2sky(128.0, 128.0))
        zp = 25.0 - 0.1 * i
        img = star_image((H, W), [[float(xi), float(yi),
                                   2e4 / 10 ** (0.04 * i), 3.0]])
        img = (img + rng.normal(0, 4.0, (H, W))).astype(np.float32)
        mask = np.zeros((H, W), np.uint8)
        mask[61:64, 100:103] = mb.SATURATED
        if i == 1:
            img[70, 101] += 160.0
        if i == 2:
            img[200, 40] += 500.0
        stdm = (4.0 + 0.5 * rng.random((8, 8))).astype(np.float32)
        std = mini2back(torch.from_numpy(stdm), (H, W), 32)
        kw = dict(bkg_std_mini=stdm, bkg_boxsize=32) if mini else {}
        inputs.append(RefInput(image=torch.from_numpy(img), bkg_std=std,
                               mask=torch.from_numpy(mask), wcs=w, zp=zp,
                               fwhm_pix=2.5, **kw))
    return inputs, out_wcs


def _coadd_close(got, want, what, flips=0.0):
    """Masks equal.  Clip decisions equal and weight sums within 1e-5 of
    themselves but on at most ``flips`` of the pixels: the card's and
    the CPU's coordinate planes round differently, so a clip at its
    threshold may flip, and a nearest-sampled std pixel at a half-pixel
    tie may take its neighbour.  Elsewhere the background STD within
    1e-5 of itself and the images within 1e-5 of themselves plus 1e-5
    of the image's largest value (the remap's card-against-CPU
    tolerance, test_resamplers_card_matches_cpu: the card's and the
    CPU's sin round differently)."""
    import numpy as np
    g = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
         for k, v in got.items() if k in ("image", "wsum", "nclipped",
                                          "mask", "bkg_std")}
    w = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
         for k, v in want.items() if k in g}
    np.testing.assert_array_equal(g["mask"], w["mask"], err_msg=what)
    tie = ((g["nclipped"].astype(np.int32) != w["nclipped"].astype(np.int32))
           | ~np.isclose(g["wsum"], w["wsum"], rtol=1e-5, atol=0))
    assert tie.mean() <= flips, (what, int(tie.sum()))
    same = ~tie
    np.testing.assert_allclose(g["image"][same], w["image"][same],
                               rtol=1e-5, atol=1e-5 * np.abs(w["image"]).max(),
                               err_msg=what)
    np.testing.assert_allclose(g["bkg_std"][same], w["bkg_std"][same],
                               rtol=1e-5, err_msg=what + " bkg_std")


@pytest.mark.parametrize("remap", ["shift2pass", "gather"])
def test_coadd_card_matches_cpu(dev, remap):
    """The resident co-add on the card against the CPU."""
    from blackbox_tpu_torch.pipeline.buildref import coadd_field
    inputs, wcs = _coadd_inputs(False)
    shape = (COADD_HW, COADD_HW)
    gpu = coadd_field(inputs, wcs, shape, remap=remap)
    assert gpu["image"].device.type == "cuda"
    cpu = coadd_field(inputs, wcs, shape, remap=remap, device="cpu")
    _coadd_close(gpu, cpu, remap, flips=1e-3)
    assert int(gpu["nclipped"].sum()) > 0


@pytest.mark.parametrize("remap", ["shift2pass", "gather"])
@pytest.mark.parametrize("std", ["full", "mini"])
def test_blocked_card_matches_cpu_and_resident(dev, remap, std):
    """The blocked co-add on the card against the CPU, and against the
    resident co-add on the card (tests/test_coadd.py's contract: clip
    flips on at most 1e-3 of the pixels, the image within 0.05 e-)."""
    import numpy as np
    from blackbox_tpu_torch.pipeline.buildref import (coadd_field,
                                                      coadd_field_blocked)
    inputs, wcs = _coadd_inputs(std == "mini")
    shape = (COADD_HW, COADD_HW)
    kw = dict(block_rows=64, pad_rows=16, remap=remap)
    gpu = coadd_field_blocked(inputs, wcs, shape, **kw)
    cpu = coadd_field_blocked(inputs, wcs, shape, device="cpu", **kw)
    _coadd_close(gpu, cpu, f"{remap} {std}", flips=1e-3)
    res = coadd_field(inputs, wcs, shape, remap=remap)
    flip = gpu["nclipped"] != res["nclipped"].cpu().numpy()
    assert flip.mean() < 1e-3
    d = np.abs(gpu["image"] - res["image"].cpu().numpy())[~flip]
    assert d.max() < 0.05, d.max()
    np.testing.assert_array_equal(gpu["mask"], res["mask"].cpu().numpy())


def test_blocked_instrumented_on_card(dev):
    """instrument=True on the card: the stage breakdown, and the outputs
    of the pipelined run unchanged."""
    import numpy as np
    from blackbox_tpu_torch.pipeline.buildref import coadd_field_blocked
    inputs, wcs = _coadd_inputs(True)
    shape = (COADD_HW, COADD_HW)
    a = coadd_field_blocked(inputs, wcs, shape, block_rows=64, pad_rows=16)
    b = coadd_field_blocked(inputs, wcs, shape, block_rows=64, pad_rows=16,
                            instrument=True)
    assert b["timings"]["nblocks"] == 4 and b["timings"]["compute_s"] > 0
    for k in ("image", "wsum", "nclipped", "mask", "bkg_std"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_blocked_mini_std_against_full_res_on_card(dev):
    """The mini-mesh std source against the full-res planes on the card.
    The full-res planes are mini2back's (Wy @ mesh) @ Wx.T over all
    rows; the mini source computes the same product over a slab's rows.
    cuBLAS picks its kernel by shape and could round the shorter product
    differently, so the outputs are held at the card-against-CPU
    tolerances (chip_smoke.py phase 8 prints whether the full-width
    co-adds are bit-identical)."""
    from blackbox_tpu_torch.pipeline.buildref import coadd_field_blocked
    shape = (COADD_HW, COADD_HW)
    kw = dict(block_rows=64, pad_rows=16)
    full = coadd_field_blocked(_coadd_inputs(False)[0], _coadd_inputs(
        False)[1], shape, **kw)
    inputs, wcs = _coadd_inputs(True)
    mini = coadd_field_blocked(inputs, wcs, shape, **kw)
    _coadd_close(mini, full, "mini vs full", flips=1e-3)
