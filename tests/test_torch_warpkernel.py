"""K10 (``csrc/warp.cu``), the two-pass shifted-add remap, against the
plain route of ``ops/warp.warp_shift2pass``.

On the CPU (tier 1): the plain route is the one taken there, and the
route goes on the ``warp`` span; what K10 takes, what dtypes it leaves
to the plain route and what it refuses; the host's packing of the
strips and shift factors against ``pass_axis``'s split and
``pass_strip``'s factors; the fills' bits; and a model of the kernel's
schedule (``k10_model``: its strip lookup, clamps, staged taps, nearest
taps and fills, pixel by pixel) against the plain route bit for bit on
every case the card runs.

On the card (``-m cuda``): the kernel against the plain route on the
card, bit for bit, on the same cases and on strips whose ranges reach
past what a tile stages, two launches a call; a call beyond K10's
tables raises; and the ``warp`` span's route in a TINY science
program.  This file imports no
jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_warpkernel.py -q
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blackbox_tpu_torch import kernels  # noqa: E402
from blackbox_tpu_torch.core import maskbits  # noqa: E402
from blackbox_tpu_torch.ops import warp  # noqa: E402
from portbench.frames import registration  # noqa: E402

STEP = 32
SCIENCE = ("lanczos", "nearest", "nearest")


def _weights(n_out, n_nodes, step=STEP):
    Wm = np.zeros((n_out, n_nodes), np.float32)
    f = np.arange(n_out, dtype=np.float64) / step
    i0 = np.minimum(f.astype(np.int64), n_nodes - 2)
    tt = (f - i0).astype(np.float32)
    Wm[np.arange(n_out), i0] = 1.0 - tt
    Wm[np.arange(n_out), i0 + 1] = tt
    return Wm


def _planes(shape, dtypes, seed):
    """Source planes: a smooth frame with stars (float32), then noise
    maps and sparse masks of the given dtypes."""
    g = torch.Generator().manual_seed(seed)
    H, W = shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    out = []
    for k, dt in enumerate(dtypes):
        if dt == torch.float32 and k == 0:
            img = 100 + 5 * torch.sin(yy / 17) + 4 * torch.cos(xx / 23)
            for yc, xc in ((0.3 * H, 0.3 * W), (0.6 * H, 0.5 * W),
                           (0.95 * H, 0.2 * W)):
                img += 900 * torch.exp(-((yy - yc) ** 2 + (xx - xc) ** 2)
                                       / 8)
            out.append(img + torch.randn((H, W), generator=g))
        elif dt == torch.float32:
            out.append(1 + torch.rand((H, W), generator=g))
        elif dt == torch.bool:
            out.append(torch.rand((H, W), generator=g) < 0.1)
        else:
            hi = 200 if torch.iinfo(dt).max < 300 else 30000
            lo = -100 if torch.iinfo(dt).min < 0 else 0
            v = torch.randint(lo, hi, (H, W), generator=g).to(dt)
            out.append(torch.where(torch.rand((H, W), generator=g) < 0.1,
                                   v, torch.zeros((), dtype=dt)))
    return out


# name: (frame (H, W), source rows, grid form, registration, strips,
#        modes, dtypes, fills)
CASES = {
    "science": ((200, 232), 200, "step", (0.05, (3.2, -2.7)), 8, SCIENCE,
                (torch.float32, torch.float32, torch.uint8),
                (0.0, "sr", maskbits.EDGE)),
    "matmul": ((200, 232), 200, "matmul", (0.05, (3.2, -2.7)), 1, SCIENCE,
               (torch.float32, torch.float32, torch.uint8),
               (0.0, 1.5, maskbits.EDGE)),
    "planes": ((200, 232), 200, "planes", (0.05, (3.2, -2.7)), 8, SCIENCE,
               (torch.float32, torch.float32, torch.uint8),
               (0.0, 1.5, maskbits.EDGE)),
    "lanczos only": ((200, 232), 200, "step", (0.05, (3.2, -2.7)), 8,
                     ("lanczos",), (torch.float32,), (0.0,)),
    "lanczos and mask": ((200, 232), 200, "step", (0.05, (3.2, -2.7)), 1,
                         ("lanczos", "nearest"),
                         (torch.float32, torch.uint8), (0.0, 64)),
    # buildref's blocked combiner: a slab taller than the block it feeds,
    # coordinates local to the slab
    "slab": ((160, 232), 230, "slab", (0.05, (3.2, 31.3)), 1, SCIENCE,
             (torch.float32, torch.float32, torch.uint8),
             (0.0, 0.0, maskbits.EDGE)),
    # an integer shift: every sample exactly on a tap, and on the frame's
    # last row and column
    "on taps": ((200, 232), 200, "step", (0.0, (-2.0, 3.0)), 1, SCIENCE,
                (torch.float32, torch.float32, torch.uint8),
                (-1.0, "sr", maskbits.EDGE)),
    # half-pixel offsets: rint's ties, and the nearest planes' -0.5 edge
    "half pixels": ((200, 232), 200, "step", (0.0, (0.5, -0.5)), 4,
                    SCIENCE, (torch.float32, torch.float32, torch.uint8),
                    (0.0, 2.5, maskbits.EDGE)),
    # 7 strips over 233 columns and 201 rows, a steeper rotation
    "uneven strips": ((201, 233), 201, "step", (0.3, (1.7, 0.4)), 7,
                      SCIENCE, (torch.float32, torch.float32, torch.uint8),
                      (0.0, 1.5, maskbits.EDGE)),
    # nearest planes of two and one bytes, ahead of the Lanczos plane
    "nearest widths": ((200, 232), 200, "planes", (0.05, (3.2, -2.7)), 8,
                       ("nearest", "lanczos", "nearest"),
                       (torch.int16, torch.float32, torch.bool),
                       (-7, 0.5, True)),
    # a float32 nearest plane and a signed byte
    "signed nearest": ((200, 232), 200, "step", (0.05, (3.2, -2.7)), 8,
                       ("lanczos", "nearest", "nearest"),
                       (torch.float32, torch.int8, torch.float32),
                       (0.0, -3, 2.0)),
}


def _wide(ranges):
    """The strips' row ranges stretched far past the remap's shifts,
    alternately down and up: a 32-column tile over two strips then spans
    ~380 rows, more than a tile stages, and one inside a strip ~190."""
    ry, rx = ranges
    return ([(r0 - 180, r1) if b % 2 else (r0, r1 + 180)
             for b, (r0, r1) in enumerate(ry)], rx)


def _case(name, dev):
    """(srcs, modes, fills, grid, ranges) of a case on ``dev``."""
    (H, W), Hs, form, (rot, off), blocks, modes, dtypes, fills = CASES[name]
    srcs = [p.to(dev) for p in _planes((Hs, W), dtypes, seed=len(name))]
    sy, sx, _ = registration((H, W), rot, off, STEP)
    ranges = warp.grid_shift_ranges(sy, sx, step=STEP, blocks=blocks)
    if blocks == 1:
        ranges = (tuple(ranges[0]), tuple(ranges[1]))
    if form == "step":
        grid = (torch.from_numpy(sy).to(dev), torch.from_numpy(sx).to(dev),
                STEP)
    else:
        wy = torch.from_numpy(_weights(H, sy.shape[0])).to(dev)
        wx = torch.from_numpy(_weights(W, sy.shape[1])).to(dev)
        sy_t, sx_t = torch.from_numpy(sy).to(dev), torch.from_numpy(sx).to(dev)
        if form == "matmul":
            grid = (sy_t, sx_t, wy, wx)
        else:
            grid = (warp.upsample_grid(sy_t, wy, wx),
                    warp.upsample_grid(sx_t, wy, wx))
    fills = tuple(torch.tensor(1.25, device=dev) if f == "sr" else f
                  for f in fills)
    return tuple(srcs), modes, fills, grid, ranges


def k10_model(srcs, modes, fills, grid, ranges, a: int = 3):
    """K10's schedule in PyTorch: each pass takes each pixel's strip by
    the kernel's lookup ``((i + 1) * B - 1) // n`` from the packed
    strips, its shift factors from the packed table, its taps at
    clamped indices over the strip's range in ascending order, one
    clamped tap for a nearest plane, and pass 2 the fills from their
    packed bits.  Its arithmetic is the plain route's on the tensors'
    device; on the card the kernel takes ``pid / a`` and the lerp's
    ``/ step`` as PyTorch's CUDA division by a scalar does (a multiply
    by the reciprocal), which the card's plain route does too."""
    Hs, W = srcs[0].shape
    dev = srcs[0].device
    if len(grid) == 4:
        ys, xs = (warp.upsample_grid(torch.as_tensor(c, dtype=torch.float32),
                                     grid[2], grid[3]) for c in grid[:2])
    elif len(grid) == 3:
        ys, xs = (warp.upsample_lerp(torch.as_tensor(c), int(grid[2]), Hs,
                                     W) for c in grid[:2])
    else:
        ys, xs = grid
    H = ys.shape[0]
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    order = ([i for i, m in enumerate(modes) if m == "lanczos"]
             + [i for i, m in enumerate(modes) if m == "nearest"])
    nl = sum(m == "lanczos" for m in modes)

    def one_pass(planes, r, n_perp, axis):
        strips = warp.k10_strips(r, n_perp)
        kmin, taps = warp.k10_taps(strips, a)
        tab = torch.tensor(taps, dtype=torch.float32).reshape(-1, 3)
        st = torch.tensor(strips)
        i = torch.arange(n_perp)
        b = ((i + 1) * len(strips) - 1) // n_perp
        r0, r1, c0 = (st[b, c].reshape((1, -1) if axis == 0 else (-1, 1))
                      for c in (1, 2, 3))
        d = ys - yy.float() if axis == 0 else xs - xx.float()
        n_src = planes[0].shape[axis]

        def tap(p, s):
            if axis == 0:
                return p[torch.clamp(yy + s, 0, n_src - 1), xx]
            return p[yy, torch.clamp(xx + s, 0, n_src - 1)]

        outs = []
        if nl:
            d0 = d - c0
            pid = math.pi * d0
            s_pi = torch.sin(pid)
            s_pa = torch.sin(pid / a)
            c_pa = torch.cos(pid / a)
            norm = torch.zeros_like(d)
            accs = [torch.zeros_like(d) for _ in range(nl)]
            for s in range(int(st[:, 1].min()), int(st[:, 2].max()) + 1):
                on = (s >= r0) & (s <= r1)
                k = s - c0
                f = tab[torch.clamp(k - kmin, 0, len(tab) - 1)]
                ds = d0 - k
                num = (f[..., 0] * s_pi) * (s_pa * f[..., 1]
                                            - c_pa * f[..., 2])
                w = torch.where(torch.abs(ds) < 1e-7, 1.0,
                                num / torch.clamp((math.pi * ds) ** 2,
                                                  min=1e-7))
                w = torch.where(torch.abs(ds) < a, w, 0.0)
                norm = torch.where(on, norm + w, norm)
                accs = [torch.where(on, acc + w * tap(p, s), acc)
                        for acc, p in zip(accs, planes)]
            norm = torch.where(norm == 0, 1.0, norm)
            outs = [acc / norm for acc in accs]
        n0, n1 = r0 + a - 1, r1 - a + 1
        si = torch.clamp(torch.round(d).to(torch.int64), n0, n1)
        outs += [torch.where(n0 <= n1, tap(p, si), torch.zeros((), dtype=p.dtype))
                 for p in planes[nl:]]
        return outs

    mid = one_pass([srcs[i] for i in order], ranges[0], W, 0)
    res = one_pass(mid, ranges[1], H, 1)
    inb_l = (ys >= 0) & (ys <= Hs - 1) & (xs >= 0) & (xs <= W - 1)
    inb_n = ((ys >= -0.5) & (ys <= Hs - 0.5) & (xs >= -0.5)
             & (xs <= W - 0.5))
    out = [None] * len(srcs)
    for k, (i, v) in enumerate(zip(order, res)):
        dt = srcs[i].dtype
        held, bits = warp._fill_word(fills[i], dt, dev)
        fill = held.reshape(()) if held is not None else torch.tensor(
            [bits], dtype=torch.int32).view(torch.uint8)[
            :torch.empty((), dtype=dt).element_size()].view(dt).reshape(())
        out[i] = torch.where(inb_l if k < nl else inb_n, v.to(dt),
                             fill.to(dev))
    return tuple(out)


def _bits(t):
    """A tensor's bytes, for a bit-for-bit comparison (NaNs and the signs
    of zeros included)."""
    return t.contiguous().view(torch.uint8)


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_plain(case):
    """The kernel's schedule, modelled on the CPU, equals the plain
    route bit for bit, and every case reaches the fills."""
    srcs, modes, fills, grid, ranges = _case(case, "cpu")
    assert warp._k10_plan(srcs, modes, grid, ranges) is not None
    want = warp._shift2pass_plain(srcs, modes, fills, grid, ranges)
    _same_bits(k10_model(srcs, modes, fills, grid, ranges), want)
    nearest = modes.index("nearest") if "nearest" in modes else None
    if nearest is not None and case not in ("half pixels", "slab"):
        fill = torch.as_tensor(fills[nearest]).to(srcs[nearest].dtype)
        assert bool((want[nearest] == fill).any())


def test_plain_route_on_the_cpu(monkeypatch):
    """CPU tensors take the plain route: the same tensors as
    ``_shift2pass_plain``, no launch, and the library never loaded."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "_lib", no_library)
    srcs, modes, fills, grid, ranges = _case("science", "cpu")
    assert warp.shift2pass_route(srcs, modes, grid, ranges) == "plain"
    before = dict(kernels.launches)
    got = warp.warp_shift2pass(srcs, modes, fills, grid, ranges)
    _same_bits(got, warp._shift2pass_plain(srcs, modes, fills, grid, ranges))
    assert dict(kernels.launches) == before


def _altered(name):
    """A call K10 does not take, and what makes it so."""
    srcs, modes, fills, grid, ranges = _case("science", "cpu")
    ry, rx = ranges
    if name == "float64 Lanczos plane":
        srcs = (srcs[0].double(),) + srcs[1:]
    elif name == "int32 nearest plane":
        srcs = srcs[:2] + (srcs[2].int(),)
    elif name == "float64 nearest plane":
        srcs = (srcs[0], srcs[1].double(), srcs[2])
    elif name == "float64 coordinate planes":
        ys, xs = warp.upsample_lerp(grid[0], STEP, *srcs[0].shape), \
            warp.upsample_lerp(grid[1], STEP, *srcs[0].shape)
        grid = (ys.double(), xs.double())
    elif name == "five Lanczos planes":
        srcs, modes = (srcs[0],) * 5, ("lanczos",) * 5
    elif name == "two Lanczos planes":
        srcs, modes = srcs[:1] * 2 + srcs[2:], ("lanczos", "lanczos",
                                                "nearest")
    elif name == "no Lanczos plane":
        srcs, modes = srcs[1:], ("nearest", "nearest")
    elif name == "three nearest planes":
        srcs, modes = srcs + srcs[2:], SCIENCE + ("nearest",)
    elif name == "shapes differ":
        srcs = (srcs[0], srcs[1][:-1], srcs[2])
    elif name == "unknown mode":
        modes = ("lanczos", "cubic", "nearest")
    elif name == "too few nodes":
        grid = (grid[0][:-2], grid[1][:-2], STEP)
    elif name == "grid narrower than the sources":
        srcs = tuple(torch.nn.functional.pad(s[None].float(), (0, 32))[0]
                     .to(s.dtype) for s in srcs)
    elif name == "too many strips":
        ry = [ry[0]] * (warp.K10_STRIPS + 1)
    elif name == "range too wide":
        rx = [(r0 - warp.K10_SHIFTS, r1) for r0, r1 in rx]
    return srcs, modes, grid, (ry, rx)


@pytest.mark.parametrize("name", [
    "float64 Lanczos plane", "int32 nearest plane", "float64 nearest plane",
    "float64 coordinate planes"])
def test_kernel_leaves_to_the_plain_route(name):
    """A plane or coordinate dtype K10 does not move leaves the call to
    the plain route, on the card as on the CPU."""
    srcs, modes, grid, ranges = _altered(name)
    assert warp._k10_plan(srcs, modes, grid, ranges) is None


@pytest.mark.parametrize("name", [
    "five Lanczos planes", "two Lanczos planes", "no Lanczos plane",
    "three nearest planes", "shapes differ", "unknown mode",
    "too few nodes", "grid narrower than the sources", "too many strips",
    "range too wide"])
def test_kernel_refuses_what_it_cannot_take(name):
    """A call of K10's dtypes that K10 cannot take raises ValueError:
    on the card it fails loudly instead of running plain."""
    srcs, modes, grid, ranges = _altered(name)
    with pytest.raises(ValueError):
        warp._k10_plan(srcs, modes, grid, ranges)


def test_wide_ranges_stay_in_the_tables():
    """Strips stretched past a tile's stage stay within K10's tables,
    and the kernel's schedule equals the plain route on them bit for
    bit (the card's ``test_wide_span_on_card`` runs them)."""
    srcs, modes, fills, grid, ranges = _case("science", "cpu")
    ranges = _wide(ranges)
    _, _, passes = warp._k10_plan(srcs, modes, grid, ranges)
    ry = ranges[0]
    assert max(r1 for _, r1 in ry) - min(r0 for r0, _ in ry) > 320
    assert len(passes[0][2]) // 3 <= warp.K10_SHIFTS
    _same_bits(k10_model(srcs, modes, fills, grid, ranges),
               warp._shift2pass_plain(srcs, modes, fills, grid, ranges))


def test_route_goes_on_the_warp_span():
    """The route lands on the innermost open span if it is ``warp``,
    and nowhere else."""
    from blackbox_tpu_torch.utils import timing
    srcs, modes, fills, grid, ranges = _case("science", "cpu")
    with timing.recording(cuda=False) as rec:
        with timing.span("warp"):
            warp.warp_shift2pass(srcs, modes, fills, grid, ranges)
        with timing.span("warp"), timing.span("other"):
            warp.warp_shift2pass(srcs, modes, fills, grid, ranges)
        spans, _ = rec.drain()
    assert [(s.name, s.attrs.get("route")) for s in spans] == [
        ("warp", "plain"), ("warp", None), ("other", None)]


@pytest.mark.parametrize("n", [1, 3, 7, 8, 64, 233, 10560])
@pytest.mark.parametrize("B", [1, 2, 7, 8, 64])
def test_strip_packing_matches_pass_axis(n, B):
    """Each index's strip by the kernel's lookup is the strip whose
    slice ``pass_axis`` gives it; each strip's centre is
    ``pass_strip``'s (Python's floor division, negative ranges too); and
    every shift of every strip finds its factors in the table, as
    ``pass_strip`` computes them and PyTorch rounds them."""
    rng = np.random.default_rng(n * 100 + B)
    r = [(int(lo), int(lo + w)) for lo, w in
         zip(rng.integers(-12, 6, B), rng.integers(5, 14, B))]
    strips = warp.k10_strips(r if B > 1 else r[0], n)
    assert len(strips) == B
    for b, (start, r0, r1, c0) in enumerate(strips):
        assert (r0, r1) == r[b]
        assert start == (b * n) // B
        assert c0 == math.floor((r0 + r1) / 2)
        # pass_axis's slice of strip b
        for i in range((b * n) // B, ((b + 1) * n) // B):
            assert ((i + 1) * B - 1) // n == b
    kmin, taps = warp.k10_taps(strips)
    tab = torch.tensor(taps, dtype=torch.float32).reshape(-1, 3)
    got = torch.from_numpy(np.asarray(kernels.host_floats(taps),
                                      np.float32)).reshape(-1, 3)
    assert torch.equal(got, tab)
    a = 3
    for _, r0, r1, c0 in strips:
        for s in range(r0, r1 + 1):
            sgn = float((-1.0) ** ((s - c0) % 2))
            want = [a * sgn, float(math.cos(math.pi * (s - c0) / a)),
                    float(math.sin(math.pi * (s - c0) / a))]
            assert torch.equal(tab[s - c0 - kmin],
                               torch.tensor(want, dtype=torch.float32))


@pytest.mark.parametrize("fill,dtype", [
    (0.0, torch.float32), (1.5, torch.float32), (-1.0, torch.float32),
    (float("nan"), torch.float32), (maskbits.EDGE, torch.uint8),
    (300, torch.uint8), (-3, torch.int8), (-7, torch.int16),
    (True, torch.bool), (np.float32(2.5), torch.float32),
    (torch.tensor(0.75), torch.float32)])
def test_fill_words(fill, dtype):
    """A host fill's bits are ``torch.as_tensor(fill).to(dtype)``'s, as
    the plain route converts it, in a signed 32-bit word."""
    held, bits = warp._fill_word(fill, dtype, "cpu")
    assert held is None and -2 ** 31 <= bits < 2 ** 31
    want = torch.as_tensor(fill).to(dtype).reshape(1)
    size = want.element_size()
    got = torch.tensor([bits], dtype=torch.int32).view(torch.uint8)[:size]
    assert torch.equal(got, want.view(torch.uint8))


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(dev, case):
    """K10 against the plain route on the card, bit for bit, in two
    launches."""
    srcs, modes, fills, grid, ranges = _case(case, dev)
    assert warp.shift2pass_route(srcs, modes, grid, ranges) == "kernel"
    before = kernels.launches["warp_pass"]
    got = warp.warp_shift2pass(srcs, modes, fills, grid, ranges)
    assert kernels.launches["warp_pass"] == before + 2
    _same_bits(got, warp._shift2pass_plain(srcs, modes, fills, grid,
                                           ranges))


@pytest.mark.cuda
def test_kernel_at_frame_scale_on_card(dev):
    """The science remap at a quarter of the mosaic (5280², 8 strips at
    0.05 deg and the cell's offset), where the strips span ~1.2 px of
    row shift each and tiles straddle strip bounds."""
    H = W = 5280
    sy, sx, _ = registration((H, W), 0.05, (3.2, -2.7), STEP)
    ranges = warp.grid_shift_ranges(sy, sx, step=STEP, blocks=8)
    srcs = tuple(p.to(dev) for p in _planes(
        (H, W), (torch.float32, torch.float32, torch.uint8), seed=23))
    grid = (torch.from_numpy(sy).to(dev), torch.from_numpy(sx).to(dev), STEP)
    fills = (0.0, torch.tensor(3.5, device=dev), maskbits.EDGE)
    before = kernels.launches["warp_pass"]
    got = warp.warp_shift2pass(srcs, SCIENCE, fills, grid, ranges)
    assert kernels.launches["warp_pass"] == before + 2
    _same_bits(got, warp._shift2pass_plain(srcs, SCIENCE, fills, grid,
                                           ranges))


@pytest.mark.cuda
def test_wide_span_on_card(dev):
    """Strips whose ranges reach past what a tile stages: those tiles
    read their taps from device memory, the others from the stage, and
    the result is the plain route's bit for bit, in two launches."""
    srcs, modes, fills, grid, ranges = _case("science", dev)
    ranges = _wide(ranges)
    before = kernels.launches["warp_pass"]
    got = warp.warp_shift2pass(srcs, modes, fills, grid, ranges)
    assert kernels.launches["warp_pass"] == before + 2
    _same_bits(got, warp._shift2pass_plain(srcs, modes, fills, grid,
                                           ranges))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["range too wide", "too many strips",
                                  "two Lanczos planes"])
def test_refused_call_raises_on_card(dev, name):
    """A call beyond K10's tables or planes raises on the card, and
    launches nothing: it does not run plain."""
    srcs, modes, grid, ranges = _altered(name)
    srcs = tuple(s.to(dev) for s in srcs)
    grid = tuple(g.to(dev) if isinstance(g, torch.Tensor) else g
                 for g in grid)
    fills = (0.0,) * len(srcs)
    before = kernels.launches["warp_pass"]
    with pytest.raises(ValueError):
        warp.warp_shift2pass(srcs, modes, fills, grid, ranges)
    assert kernels.launches["warp_pass"] == before


@pytest.mark.cuda
def test_unrouted_call_runs_plain_on_card(dev):
    """A float64 plane on the card takes the plain route: no launch."""
    srcs, modes, fills, grid, ranges = _case("science", dev)
    srcs = (srcs[0].double(),) + srcs[1:]
    assert warp.shift2pass_route(srcs, modes, grid, ranges) == "plain"
    before = kernels.launches["warp_pass"]
    got = warp.warp_shift2pass(srcs, modes, fills, grid, ranges)
    assert kernels.launches["warp_pass"] == before
    _same_bits(got, warp._shift2pass_plain(srcs, modes, fills, grid,
                                           ranges))


@pytest.mark.cuda
def test_science_warp_span_route_on_card(dev):
    """A TINY science program on the card: its ``warp`` span carries
    ``route="kernel"`` and the remap is two K10 launches."""
    from blackbox_tpu_torch.core.geometry import TINY
    from blackbox_tpu_torch.pipeline import subtract
    from blackbox_tpu_torch.pipeline.reduce import ReduceContext
    from blackbox_tpu_torch.synth.device import make_science_device
    from blackbox_tpu_torch.utils import timing
    ctx = ReduceContext.from_defaults(TINY)
    gen = torch.Generator(device=dev).manual_seed(5)
    raw = make_science_device(gen, TINY, nstars=40, ncosmics=12, nsat=2)[:3]
    H, W = TINY.red_shape
    sy, sx, _ = registration((H, W), 0.05, (3.2, -2.7), STEP)
    front, back = subtract.make_science_programs(
        ctx, None, remap_ranges=warp.grid_shift_ranges(sy, sx, step=STEP,
                                                       blocks=8),
        remap_step=STEP, device=dev)
    f = front(*raw, None, None, None)
    cat = f["cat"]
    ref = (f["sub"], f["bkg_std"], f["mask"], (sy, sx), f["psf_centre"],
           f["stats"]["bkg_std"],
           {"x": cat["x"], "y": cat["y"], "flux": cat["flux_psf"],
            "fluxerr": cat["fluxerr_psf"], "valid": cat["valid"]})
    before = kernels.launches["warp_pass"]
    with timing.recording() as rec:
        back(f["sub"], f["bkg_std"], f["mask"], f["psf_centre"], cat,
             f["stats"]["bkg_std"], *ref)
        spans, _ = rec.drain()
    assert kernels.launches["warp_pass"] == before + 2
    assert [s.attrs.get("route") for s in spans if s.name == "warp"] == [
        "kernel"]
