"""The fused L.A.Cosmic iteration (port of
:mod:`blackbox_tpu.pallas.lacosmic`, the TPU kernel ``_iter_kernel``).

This is the function the JAX package runs under
``LACosmicParams(use_pallas=True)``, and it is NOT the dense path of
:mod:`blackbox_tpu_torch.ops.cosmics`:

- every iteration re-cleans every flagged pixel, and all ``niter``
  iterations run;
- its masks are float32 arithmetic: ``gt(a, b) = 0.5 * (sign(a - b) + 1)``
  is 0.5 where ``a == b`` and NaN where either is NaN, and the cosmic
  mask it carries between iterations holds those values;
- the masked 5x5 clean falls back to the CLAMPED 5x5 median;
- the frame is edge-padded to ``padded_shape(H, W)`` and stays that size
  between iterations, so the columns and rows past the frame are
  computed like any other after the first iteration, and the last few
  columns of the result depend on the padded width.

One iteration's output depends on its inputs within 9 px (masked clean
2, over the two dilations 3, over ``sp`` and ``f`` 4), so it is the
stencil pipeline over the edge-extended (Hp, Wp) arrays evaluated with
any halo of at least 9: the TPU kernel's tiling plays no part.

On the card :func:`lacosmic_fused` runs the CUDA kernels of
``csrc/lacosmic.cu`` (four launches an iteration through device memory,
the 7x7 median and the masked clean only on the pixels whose result
they can change; the launch counter counts iterations).  Its plain version
:func:`_iter_plain` runs the same comparator programs as whole-strip
elementwise min/max.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blackbox_tpu_torch import kernels
from blackbox_tpu_torch.ops.filters import (_median_plain, apply_ops,
                                            transposition_pairs)

HALO = 12          # halo of every strip / extended domain (>= 9 needed)
STRIP_ROWS = 128   # rows of one strip of the plain version
BIG = 1e30         # value of a masked pixel in the masked median


def padded_shape(H: int, W: int) -> tuple[int, int]:
    """(Hp, Wp) the TPU wrapper pads a frame to: rows to a multiple of 8,
    columns to a multiple of 512 (a numeric rule of the result, copied
    from ``lacosmic_pallas``)."""
    return -(-H // 8) * 8, -(-W // 512) * 512


# ---- plain version -------------------------------------------------------

def _edge(a: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(a[None], (p, p, p, p), mode="replicate")[0]


def _median_edge(a: torch.Tensor, k: int) -> torch.Tensor:
    """k x k median with edge-padded reads: K2's plain median (the
    sorted-column networks of ``median_networks.cuh``) on the padded
    slab.  The TPU kernel sorts all k*k values; every correct network
    gives the same median, NaN included."""
    p = k // 2
    return _median_plain(_edge(a, p), k, a.shape[0])[p:-p, p:-p]


def _views5(a: torch.Tensor) -> list:
    h, w = a.shape
    ap = _edge(a, 2)
    return [ap[dy:dy + h, dx:dx + w] for dy in range(5) for dx in range(5)]


def _dilate(m: torch.Tensor, k: int) -> torch.Tensor:
    """Max over the k x k neighbours, from 0, zero outside."""
    p = k // 2
    h, w = m.shape
    mp = F.pad(m, (p, p, p, p))
    out = torch.zeros_like(m)
    for dy in range(k):
        for dx in range(k):
            out = torch.maximum(out, mp[dy:dy + h, dx:dx + w])
    return out


def _sign(d: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0)."""
    return torch.where(d > 0, 1.0, torch.where(d < 0, -1.0, d))


def _gt(a, b):
    return 0.5 * (_sign(a - b) + 1.0)


def _laplacian(v: torch.Tensor) -> torch.Tensor:
    up = torch.roll(v, 1, 0)
    dn = torch.roll(v, -1, 0)
    lf = torch.roll(v, 1, 1)
    rt = torch.roll(v, -1, 1)
    pos = lambda a: torch.clamp(a, min=0.0)  # noqa: E731
    return 0.25 * (pos(2 * v - up - lf) + pos(2 * v - up - rt)
                   + pos(2 * v - dn - lf) + pos(2 * v - dn - rt))


def _masked_median5(a, bad, fallback):
    """The TPU kernel's masked 5x5 median, in its arithmetic: bad values
    blended to BIG, a full odd-even transposition sort of the 25, the
    good count as a float sum, ranks picked by 0/1-weighted sums."""
    bv = _views5(bad)
    vals = [v + b * (BIG - v) for v, b in zip(_views5(a), bv)]
    vs = apply_ops(vals, [("ce", x, y) for x, y in transposition_pairs(25)])
    n = bv[0].new_zeros(())
    for b in bv:
        n = n + (1.0 - b)
    i_lo = torch.floor(torch.clamp(n - 1.0, min=0.0) * 0.5)
    i_hi = torch.floor(n * 0.5)
    lo = torch.zeros_like(a)
    hi = torch.zeros_like(a)
    for r, vr in enumerate(vs):
        lo = lo + (1.0 - torch.clamp(torch.abs(i_lo - r), max=1.0)) * vr
        hi = hi + (1.0 - torch.clamp(torch.abs(i_hi - r), max=1.0)) * vr
    med = 0.5 * lo + 0.5 * hi
    has = torch.clamp(n, max=1.0)
    return has * med + (1.0 - has) * fallback


def _tile_iter(clean, inm, crm, rdn, sigclip, sigfrac, objlim):
    """One iteration on a haloed slab, in the TPU kernel's order of
    operations; only the slab's centre (HALO in from each side) is
    exact."""
    m5 = torch.clamp(_median_edge(clean, 5), min=1e-5)
    noise = torch.sqrt(m5 + rdn * rdn)
    s = _laplacian(clean) / (2.0 * noise)
    sp = s - _median_edge(s, 5)
    m3 = _median_edge(clean, 3)
    m37 = _median_edge(m3, 7)
    f = torch.clamp((m3 - m37) / noise, min=0.01)

    good = 1.0 - inm
    cosm = _gt(sp, sigclip) * _gt(sp / f, objlim) * good
    cosm = _dilate(cosm, 3) * _gt(sp, sigclip) * good
    cosm = _dilate(cosm, 5) * _gt(sp, sigclip * sigfrac) * good
    crm2 = torch.maximum(crm, cosm)
    repl = _masked_median5(clean, torch.maximum(crm2, inm), m5)
    return clean + crm2 * (repl - clean), crm2


def _iter_plain(clean, inm, crm, rdn, sigclip: float, sigfrac: float,
                objlim: float):
    """Plain version of one K7 iteration on (Hp, Wp) float32 planes:
    row strips with a HALO-row halo over the edge-extended planes."""
    Hp, Wp = clean.shape
    P = HALO
    ext = [_edge(x, P) for x in (clean, inm, crm)]
    out_c = torch.empty_like(clean)
    out_m = torch.empty_like(clean)
    for r0 in range(0, Hp, STRIP_ROWS):
        r1 = min(r0 + STRIP_ROWS, Hp)
        c, i, m = (x[r0:r1 + 2 * P] for x in ext)
        c2, m2 = _tile_iter(c, i, m, rdn, sigclip, sigfrac, objlim)
        out_c[r0:r1] = c2[P:-P, P:-P]
        out_m[r0:r1] = m2[P:-P, P:-P]
    return out_c, out_m


# ---- the kernel ------------------------------------------------------------

def _iter_cuda(clean, inm, crm, rdn, sigclip: float, sigfrac: float,
               objlim: float, padded, total, counts):
    """One K7 iteration through the four launches of csrc/lacosmic.cu.

    clean  : the (H, W) frame (first iteration) or the last iteration's
             (Hp, Wp) result; the kernels read it at clamped coordinates,
             which is the edge padding to (Hp, Wp).
    inm    : (H, W) uint8 mask, 0 or 1, read the same way.
    crm    : the last iteration's (Hp, Wp) mask, or None (zeros).
    padded : (Hp, Wp).
    total  : int32 device scalar; the kernel adds the frame's count of
             crm2 > 0.5 to it.
    counts : int32 (2,) device tensor; receives the number of pixels
             the kernel listed for the 7x7 median and for the masked
             clean.

    Scratch planes span the (Hp + 2 HALO, Wp + 2 HALO) extended domain.
    Returns the (Hp, Wp) cleaned frame and cosmic mask.
    """
    Hp, Wp = padded
    H, W = inm.shape
    He, We = Hp + 2 * HALO, Wp + 2 * HALO
    dev = clean.device
    ops = [t for t in (clean, inm, crm, rdn, total, counts) if t is not None]
    kernels.require_cuda("lacosmic_fused", *ops)
    scratch = torch.empty((6, He, We), dtype=torch.float32, device=dev)
    out_c = torch.empty(padded, dtype=torch.float32, device=dev)
    out_m = torch.empty(padded, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().bbt_lacosmic_iter(
            clean.data_ptr(), *clean.shape, inm.data_ptr(), H, W,
            None if crm is None else crm.data_ptr(), rdn.data_ptr(),
            out_c.data_ptr(), out_m.data_ptr(), scratch.data_ptr(),
            counts.data_ptr(), total.data_ptr(), Hp, Wp, HALO,
            float(sigclip), float(sigclip * sigfrac), float(objlim),
            kernels.stream_of(clean)), "lacosmic_fused")
    return out_c, out_m


def _inputs(data, inmask, rdnoise):
    """The mask (zeros if None) and the scalar read noise of a call,
    checked."""
    if inmask is None:
        inmask = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    if inmask.shape != data.shape:
        raise ValueError(f"lacosmic_fused: inmask {tuple(inmask.shape)} "
                         f"for data {tuple(data.shape)}")
    rdn = torch.as_tensor(rdnoise, dtype=torch.float32, device=data.device)
    if rdn.numel() != 1:
        raise ValueError("lacosmic_fused: the read noise must be a scalar")
    return inmask, rdn.reshape(())


def _run(data, inmask, rdnoise, sigclip, sigfrac, objlim, niter, step):
    H, W = data.shape
    Hp, Wp = padded_shape(H, W)
    dev = data.device
    inmask, rdn = _inputs(data, inmask, rdnoise)

    def pad(x):
        return F.pad(x[None], (0, Wp - W, 0, Hp - H), mode="replicate")[0]

    clean = pad(data.to(torch.float32)).contiguous()
    inm = pad(inmask.to(torch.float32)).contiguous()
    crm = torch.zeros_like(clean)
    counts = []
    prev = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(niter):
        clean, crm = step(clean, inm, crm, rdn, sigclip, sigfrac, objlim)
        tot = torch.sum(crm[:H, :W] > 0.5, dtype=torch.int32)
        counts.append(tot - prev)
        prev = tot
    return clean[:H, :W], crm[:H, :W] > 0.5, torch.stack(counts)


def _lacosmic_plain(data, inmask, rdnoise, sigclip: float = 15.0,
                    sigfrac: float = 0.01, objlim: float = 3.0,
                    niter: int = 3):
    """Plain version of :func:`lacosmic_fused` (any device)."""
    return _run(data, inmask, rdnoise, sigclip, sigfrac, objlim, niter,
                _iter_plain)


def lacosmic_fused(data, inmask, rdnoise, sigclip: float = 15.0,
                   sigfrac: float = 0.01, objlim: float = 3.0,
                   niter: int = 3):
    """L.A.Cosmic by ``niter`` fused iterations (``lacosmic_pallas``).

    data    : (H, W) float32 [e-]
    inmask  : (H, W) bool, pixels excluded from detection, or None
    rdnoise : scalar read noise [e-]

    Returns (cleaned, crmask bool, per-iteration new-detection counts).
    CPU tensors take the plain version; CUDA tensors run the kernel.
    """
    if data.dim() != 2:
        raise ValueError("lacosmic_fused: (H, W) image expected")
    if data.device.type == "cpu":
        return _lacosmic_plain(data, inmask, rdnoise, sigclip, sigfrac,
                               objlim, niter)
    return _run_cuda(data, inmask, rdnoise, sigclip, sigfrac, objlim,
                     niter)[:3]


def _run_cuda(data, inmask, rdnoise, sigclip, sigfrac, objlim, niter):
    """The kernel's iteration loop: what :func:`_run` does around the plain
    iterations, without materialising the padding.  The kernels read the
    frame and the mask at clamped coordinates (the edge padding to
    :func:`padded_shape`) and count crm2 > 0.5 on the frame into
    ``totals[i]`` (the plain version's ``torch.sum`` of iteration i).
    Returns what :func:`lacosmic_fused` returns and, fourth, the (niter,
    2) int32 counts of pixels each iteration listed for the 7x7 median
    and for the masked clean."""
    H, W = data.shape
    inmask, rdn = _inputs(data, inmask, rdnoise)
    if inmask.dtype != torch.bool:
        raise ValueError("lacosmic_fused: the mask must be bool on the card")
    clean = data.to(torch.float32).contiguous()
    inm = inmask.contiguous().view(torch.uint8)
    crm = None
    totals = torch.zeros(niter, dtype=torch.int32, device=data.device)
    listed = torch.empty((niter, 2), dtype=torch.int32, device=data.device)
    for i in range(niter):
        clean, crm = _iter_cuda(clean, inm, crm, rdn, sigclip, sigfrac,
                                objlim, padded_shape(H, W), totals[i],
                                listed[i])
        lacosmic_fused.launches += 1
    counts = torch.diff(totals, prepend=totals.new_zeros(1))
    return clean[:H, :W], crm[:H, :W] > 0.5, counts, listed


lacosmic_fused.launches = 0
