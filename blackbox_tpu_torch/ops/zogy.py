"""ZOGY optimal image subtraction (port of :mod:`blackbox_tpu.ops.zogy`).

The statistic chain of Zackay, Ofek & Gal-Yam (2016, ApJ 830:27):

    D̂  = (f_r P̂_r N̂ − f_n P̂_n R̂) / √(σ_n² f_r² |P̂_r|² + σ_r² f_n² |P̂_n|²)
    Ŝ  = F_D P̂_D* D̂
    Scorr = S / √V[S],   V[S] = k_n²⊗V_N + k_r²⊗V_R + V_ast

PSFs enter as small stamps and are embedded into full-frame OTFs by
small separable DFTs.  Two implementations of the transforms, as in
the JAX package (``ZogyParams.fft``):

* ``"split"``: every spectral plane is a split (re, im) float32 pair in
  the scrambled layout of :mod:`blackbox_tpu_torch.ops.fft`, whose
  column transforms run on the CUDA kernel ``csrc/fft.cu`` (the port of
  the TPU kernel ``pallas/fft.py``) — 6 column launches per production
  subtraction (3 two-dimensional transforms);
* ``"xla"``: complex64 ``torch.fft`` on rfft half planes (the JAX
  package computes this path with ``jnp.fft``, outside any kernel).

``"auto"`` takes ``"split"`` for tensors on a CUDA device at
production scale (``min(H, W) >= 1024`` and ``pad_fast``), ``"xla"``
elsewhere.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from blackbox_tpu_torch.ops.fft import (fft2_split, ifft2_split, mirror_perm,
                                        spectrum_freqs)
from blackbox_tpu_torch.ops.stats import nanmedian, nanstd
from blackbox_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class ZogyParams:
    eps: float = 1e-12        # denominator floor
    dx: float = 0.25          # astrometric rms [pix] between new and ref
    dy: float = 0.25
    fratio_floor: float = 1e-3
    # support [px] assumed for k_n/k_r when squaring them for the V[S]
    # source-noise term: the squares are built on a kernel_stamp²
    # aliased grid and expanded by small separable DFTs (0 = exact
    # full-frame round trip)
    kernel_stamp: int = 256
    # zero-pad the frames to the next FFT-friendly size (changes the
    # outputs in the ~PSF-wide border band, inside the EDGE mask)
    pad_fast: bool = True
    # pack pairs of real transforms into single complex transforms
    # (xla path; the split path always packs)
    pack_fft: bool = True
    # "split", "xla" or "auto" (see the module note)
    fft: str = "auto"

    @classmethod
    def from_reference(cls, ref):
        """The same parameters from a JAX ``ZogyParams``, read by field
        name."""
        return cls(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(cls)})


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _pad_to(a, Hp, Wp):
    """Zero-pad an (H, W) plane at the bottom/right to (Hp, Wp)."""
    H, W = a.shape
    return F.pad(a, (0, Wp - W, 0, Hp - H))


def _pad_edge_to(a, Hp, Wp):
    """Edge-replicate an (H, W) plane at the bottom/right to (Hp, Wp)."""
    H, W = a.shape
    rows = torch.clamp(torch.arange(Hp, device=a.device), max=H - 1)
    cols = torch.clamp(torch.arange(Wp, device=a.device), max=W - 1)
    return a[rows][:, cols]


def psf_to_otf(psf_stamp, shape, full: bool = False):
    """OTF of a centred (S, S) PSF stamp on an (H, W) frame grid, by two
    small separable complex DFT matmuls.  full=False returns the rfft
    half plane (W//2+1 columns); full=True the complete spectrum, built
    by exact hermitian mirroring of the half plane."""
    H, W = shape
    dev = psf_stamp.device
    S = psf_stamp.shape[-1]
    c = S // 2
    u = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    y = (torch.arange(S, dtype=torch.float32, device=dev) - c)[None, :]
    Ey = torch.exp(-2j * math.pi / H * (u * y))                # (H, S)
    ncol = W // 2 + 1
    v = torch.arange(ncol, dtype=torch.float32, device=dev)[None, :]
    x = (torch.arange(S, dtype=torch.float32, device=dev) - c)[:, None]
    Ex = torch.exp(-2j * math.pi / W * (x * v))                # (S, ncol)
    mid = torch.matmul(psf_stamp.to(torch.complex64), Ex)      # (S, ncol)
    half = torch.matmul(Ey, mid)                               # (H, ncol)
    return hermitian_full(half, W) if full else half


def otf_to_psf_stamp(otf, shape, S: int):
    """Centred (S, S) PSF stamp from a full-frame OTF (rfft half plane or
    full spectrum) by two small separable DFT matmuls."""
    H, W = shape
    dev = otf.device
    c = S // 2
    y = (torch.arange(S, dtype=torch.float32, device=dev) - c)[:, None]
    u = torch.arange(H, dtype=torch.float32, device=dev)[None, :]
    Ey = torch.exp(2j * math.pi / H * (y * u))                 # (S, H)
    ncol = otf.shape[-1]
    v = torch.arange(ncol, dtype=torch.float32, device=dev)[:, None]
    x = (torch.arange(S, dtype=torch.float32, device=dev) - c)[None, :]
    Ex = torch.exp(2j * math.pi / W * (v * x))                 # (ncol, S)
    if ncol != W:
        # rfft half plane: interior columns stand for their conjugate
        # mirror too, so they count twice in the real part
        colw = torch.full((ncol, 1), 2.0, dtype=torch.float32, device=dev)
        colw[0] = 1.0
        if W % 2 == 0:
            colw[-1] = 1.0
        Ex = colw * Ex
    mid = torch.matmul(Ey, otf.to(torch.complex64))            # (S, ncol)
    out = torch.matmul(mid, Ex)                                # (S, S)
    return torch.real(out) / (H * W)


def hermitian_full(half, W: int):
    """Expand an rfft half plane (H, W//2+1) to the full W-column
    spectrum of a real signal: A(u, c) = conj(A(-u, W-c)), bit-exact."""
    Wr = half.shape[1]
    tail = torch.conj(torch.flip(half[:, 1:W - Wr + 1], [1]))  # W-1..Wr
    tail = torch.roll(torch.flip(tail, [0]), 1, 0)             # u -> -u
    return torch.cat([half, tail], dim=1)


def fast_fft_size(n: int) -> int:
    """Smallest m >= n of the form 2^a·{1,3,5,7,11,21} (copy of the JAX
    package's; the padded size changes the outputs)."""
    best = None
    for m in (1, 3, 5, 7, 11, 21):
        c = m
        while c < n:
            c <<= 1
        if best is None or c < best:
            best = c
    return best


def split_fft_size(n: int) -> int:
    """Smallest fast FFT size >= n that is also a multiple of 128 (each
    axis takes a turn as the column axis of the split transform)."""
    m = fast_fft_size(n)
    while m % 128:
        m = fast_fft_size(m + 1)
    return m


def _kernel_sq_stamps(psf_new, psf_ref, fn, fr, sn, sr, eps, K):
    """K×K aliased stamps of k_n², k_r²: the kernels' frequency
    responses evaluated on a K×K grid and inverse-transformed (the true
    kernels folded with period K)."""
    Pn = psf_to_otf(psf_new, (K, K))
    Pr = psf_to_otf(psf_ref, (K, K))
    Pn2 = torch.abs(Pn) ** 2
    Pr2 = torch.abs(Pr) ** 2
    den = sn ** 2 * fr ** 2 * Pr2 + sr ** 2 * fn ** 2 * Pn2 + eps
    kn = torch.fft.irfft2(fn * fr ** 2 * torch.conj(Pn) * Pr2 / den,
                          s=(K, K))
    kr = torch.fft.irfft2(fr * fn ** 2 * torch.conj(Pr) * Pn2 / den,
                          s=(K, K))
    # irfft2 leaves the kernel centre at (0, 0); fftshift moves it to
    # (K//2, K//2), the centre convention psf_to_otf expects
    return torch.fft.fftshift(kn) ** 2, torch.fft.fftshift(kr) ** 2


def _kernel_sq_otfs(psf_new, psf_ref, fn, fr, sn, sr, eps, K, shape,
                    full: bool = False):
    """Full-frame spectra of k_n², k_r² from the K×K aliased stamps."""
    kn2, kr2 = _kernel_sq_stamps(psf_new, psf_ref, fn, fr, sn, sr, eps, K)
    return (psf_to_otf(kn2, shape, full=full),
            psf_to_otf(kr2, shape, full=full))


def _signed_freqs(N: int, device):
    """Scrambled-layout frequency of each physical row, in the SIGNED
    (fftfreq-style) convention: f - N for f > N/2."""
    f = spectrum_freqs(N).astype(np.int64)
    return torch.from_numpy(np.where(f > N // 2, f - N, f).astype(
        np.float32)).to(device)


def _otf_scr(psf_stamp, shape):
    """Split (re, im) OTF planes of a centred real stamp in the
    TRANSPOSED SCRAMBLED layout of :func:`fft2_split`:
    plane[p, q] = OTF[fu[q], fv[p]] with fu/fv = ``spectrum_freqs``.
    Signed frequencies keep the plane hermitian to f32 equality."""
    Hp, Wp = shape
    dev = psf_stamp.device
    S = psf_stamp.shape[-1]
    c = S // 2
    fu = _signed_freqs(Hp, dev)                                # (Hp,)
    fv = _signed_freqs(Wp, dev)                                # (Wp,)
    y = torch.arange(S, dtype=torch.float32, device=dev) - c
    ay = (-2 * math.pi / Hp) * fu[:, None] * y[None, :]        # (Hp, S)
    ax = (-2 * math.pi / Wp) * fv[:, None] * y[None, :]        # (Wp, S)
    eyr, eyi = torch.cos(ay), torch.sin(ay)
    exr, exi = torch.cos(ax), torch.sin(ax)
    pT = psf_stamp.to(torch.float32).T                         # [x, y]
    mr = torch.matmul(exr, pT)                                 # (Wp, S)
    mi = torch.matmul(exi, pT)
    re = torch.matmul(mr, eyr.T) - torch.matmul(mi, eyi.T)     # (Wp, Hp)
    im = torch.matmul(mr, eyi.T) + torch.matmul(mi, eyr.T)
    return re, im


def _otf_scr_to_stamp(ar, ai, shape, S: int):
    """Centred (S, S) real stamp from split scrambled-layout spectrum
    planes — the split twin of :func:`otf_to_psf_stamp`."""
    Hp, Wp = shape
    dev = ar.device
    c = S // 2
    fu = _signed_freqs(Hp, dev)
    fv = _signed_freqs(Wp, dev)
    tt = torch.arange(S, dtype=torch.float32, device=dev) - c
    ay = (2 * math.pi / Hp) * fu[:, None] * tt[None, :]        # (Hp, S)
    ax = (2 * math.pi / Wp) * fv[:, None] * tt[None, :]        # (Wp, S)
    eyr, eyi = torch.cos(ay), torch.sin(ay)
    exr, exi = torch.cos(ax), torch.sin(ax)
    cr = torch.matmul(exr.T, ar) - torch.matmul(exi.T, ai)     # (S, Hp)
    ci = torch.matmul(exr.T, ai) + torch.matmul(exi.T, ar)
    dr = torch.matmul(cr, eyr) - torch.matmul(ci, eyi)         # (S, S)
    return dr.T / (Hp * Wp)


def _grad(img):
    gy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    gx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    return gy, gx


def _zogy_split(new, ref, psf_new, psf_ref, sn, sr, fn, fr,
                var_new, var_ref, var_bkg_new, var_bkg_ref,
                p: ZogyParams, want_psf_d: bool):
    """zogy_subtract on the split-real FFT: every spectral plane is a
    split (re, im) f32 pair in the transposed scrambled layout.  The
    packed forward fft2_split(new, ref) carries both spectra, separated
    by one hermitian-mirror gather; each pair of real inverses rides one
    ifft2_split of Y = A + iB."""
    dev = new.device
    H, W = new.shape
    Hp, Wp = split_fft_size(H), split_fft_size(W)
    shape = (Hp, Wp)
    if (Hp, Wp) != (H, W):
        new, ref = _pad_to(new, Hp, Wp), _pad_to(ref, Hp, Wp)
        var_new = None if var_new is None else _pad_to(var_new, Hp, Wp)
        var_ref = None if var_ref is None else _pad_to(var_ref, Hp, Wp)

    mpr = torch.from_numpy(mirror_perm(Wp)).to(dev)
    mpc = torch.from_numpy(mirror_perm(Hp)).to(dev)

    def _cm(ar, ai, br, bi):
        return ar * br - ai * bi, ar * bi + ai * br

    def _unpack(ar, ai):
        """Spectra of the two real frames packed in one forward
        transform: A = (Z + M(Z))/2, B = -i(Z - M(Z))/2, M(Z) = conj(Z
        at negated frequencies)."""
        gr = ar[mpr][:, mpc]
        gi = ai[mpr][:, mpc]
        return ((0.5 * (ar + gr), 0.5 * (ai - gi)),
                (0.5 * (ai + gi), 0.5 * (gr - ar)))

    # each forward or inverse 2-D transform (K6's pair of column
    # passes on the card) is a span
    def _fwd(ar, ai):
        with span("zogy.fft"):
            return fft2_split(ar, ai)

    def _inv(yr, yi):
        with span("zogy.fft"):
            return ifft2_split(yr, yi)

    def _inv_pair(A, B):
        """Two real inverses in one transform: for hermitian A, B the
        inverse of Y = A + iB has re = a, im = b."""
        (Ar, Ai), (Br, Bi) = A, B
        return _inv(Ar - Bi, Ai + Br)

    Zr, Zi = _fwd(new.contiguous(), ref.contiguous())   # (Wp, Hp)
    (Nr, Ni), (Rr, Ri) = _unpack(Zr, Zi)

    pn = _otf_scr(psf_new, shape)
    pr_ = _otf_scr(psf_ref, shape)

    fn = _f32(fn, dev)
    fr = torch.clamp(_f32(fr, dev), min=p.fratio_floor)
    sn = torch.clamp(_f32(sn, dev), min=1e-6)
    sr = torch.clamp(_f32(sr, dev), min=1e-6)

    Pn2 = pn[0] ** 2 + pn[1] ** 2
    Pr2 = pr_[0] ** 2 + pr_[1] ** 2
    den = sn ** 2 * fr ** 2 * Pr2 + sr ** 2 * fn ** 2 * Pn2 + p.eps
    sq = torch.sqrt(den)

    t1 = _cm(pr_[0], pr_[1], Nr, Ni)
    t2 = _cm(pn[0], pn[1], Rr, Ri)
    D_hat = ((fr * t1[0] - fn * t2[0]) / sq,
             (fr * t1[1] - fn * t2[1]) / sq)
    F_D = fn * fr / torch.sqrt(sn ** 2 * fr ** 2 + sr ** 2 * fn ** 2)

    # matched-filter kernels (conj(P) folds in as a sign flip on im)
    cn = fn * fr ** 2 * Pr2 / den
    cr_ = fr * fn ** 2 * Pn2 / den
    kn_hat = (cn * pn[0], -cn * pn[1])
    kr_hat = (cr_ * pr_[0], -cr_ * pr_[1])

    npx = Hp * Wp

    def _k2_scr():
        K = p.kernel_stamp
        if K and K < min(H, W):
            kn2, kr2 = _kernel_sq_stamps(
                psf_new, psf_ref, fn, fr, sn, sr, p.eps, K)
        else:
            # full-frame kernels: one packed inverse gives both, one
            # packed forward re-transforms the squares (exact path)
            kn, kr = _inv_pair(kn_hat, kr_hat)
            return _unpack(*_fwd(kn ** 2, kr ** 2))
        return _otf_scr(kn2, shape), _otf_scr(kr2, shape)

    D = None
    if var_new is not None or var_ref is not None:
        kn2_hat, kr2_hat = _k2_scr()
        vcap = 1e4 * (sn ** 2 + sr ** 2)
        Vn = (sn ** 2 * torch.ones(shape, device=dev) if var_new is None
              else torch.clamp(torch.minimum(var_new, vcap), min=0.0))
        Vr = (sr ** 2 * torch.ones(shape, device=dev) if var_ref is None
              else torch.clamp(torch.minimum(var_ref, vcap), min=0.0))
        Vn_hat, Vr_hat = _unpack(*_fwd(Vn.contiguous(), Vr.contiguous()))
        a = _cm(kn2_hat[0], kn2_hat[1], *Vn_hat)
        b = _cm(kr2_hat[0], kr2_hat[1], *Vr_hat)
        D, V_src = _inv_pair(D_hat, (a[0] + b[0], a[1] + b[1]))
    else:
        sum_kn2 = torch.sum(kn_hat[0] ** 2 + kn_hat[1] ** 2) / npx
        sum_kr2 = torch.sum(kr_hat[0] ** 2 + kr_hat[1] ** 2) / npx
        vbn = sn ** 2 if var_bkg_new is None else var_bkg_new
        vbr = sr ** 2 if var_bkg_ref is None else var_bkg_ref
        if getattr(vbn, "ndim", 0) == 2 and tuple(vbn.shape) != shape:
            vbn = _pad_edge_to(vbn, Hp, Wp)
        if getattr(vbr, "ndim", 0) == 2 and tuple(vbr.shape) != shape:
            vbr = _pad_edge_to(vbr, Hp, Wp)
        V_src = vbn * sum_kn2 + vbr * sum_kr2
        if var_bkg_new is not None or var_bkg_ref is not None:
            kn2_hat, kr2_hat = _k2_scr()
            a = _cm(kn2_hat[0], kn2_hat[1], Nr, Ni)
            b = _cm(kr2_hat[0], kr2_hat[1], Rr, Ri)
            D, src = _inv_pair(D_hat, (a[0] + b[0], a[1] + b[1]))
            V_src = V_src + torch.clamp(src, min=0.0)
    if D is None:
        D = _inv(*D_hat)[0]

    Sn, Sr = _inv_pair(_cm(kn_hat[0], kn_hat[1], Nr, Ni),
                       _cm(kr_hat[0], kr_hat[1], Rr, Ri))
    S = Sn - Sr

    dSn_dy, dSn_dx = _grad(Sn)
    dSr_dy, dSr_dx = _grad(Sr)
    V_ast = (p.dx ** 2 * (dSn_dx ** 2 + dSr_dx ** 2)
             + p.dy ** 2 * (dSn_dy ** 2 + dSr_dy ** 2))

    V_S = V_src + V_ast
    Scorr = S / torch.sqrt(torch.clamp(V_S, min=p.eps))

    F_S = torch.sum(fn ** 2 * fr ** 2 * Pn2 * Pr2 / den) / npx
    F_S = torch.clamp(F_S, min=p.eps)
    Fpsf = S / F_S
    Fpsferr = torch.sqrt(torch.clamp(V_S, min=p.eps)) / F_S

    def _crop(a):
        return a[:H, :W] if (Hp, Wp) != (H, W) else a

    out = {"D": _crop(D), "S": _crop(S), "Scorr": _crop(Scorr),
           "Fpsf": _crop(Fpsf), "Fpsferr": _crop(Fpsferr),
           "F_D": F_D, "F_S": F_S}
    if want_psf_d:
        c = fn * fr / (F_D * sq)
        pd = _cm(pn[0], pn[1], pr_[0], pr_[1])
        out["psf_D"] = _otf_scr_to_stamp(c * pd[0], c * pd[1], shape,
                                         psf_new.shape[-1])
    return out


def zogy_subtract(new, ref, psf_new, psf_ref, sn, sr,
                  fn=1.0, fr=1.0, var_new=None, var_ref=None,
                  var_bkg_new=None, var_bkg_ref=None,
                  params: ZogyParams = ZogyParams(),
                  want_psf_d: bool = True):
    """Optimal subtraction of a registered (ref -> new grid) image pair.

    new, ref : (H, W) background-subtracted images [e-]
    psf_new, psf_ref : (S, S) unit-sum PSF stamps on the same grid
    sn, sr   : scalar background STDs [e-]
    fn, fr   : flux zeropoint scalings (fr/fn = flux ratio ref/new)
    var_new, var_ref : optional explicit (H, W) variance maps
    var_bkg_new, var_bkg_ref : optional smooth background-variance maps
        (or scalars): the production path, V = V_bkg + max(source, 0)
        with the source term from the images' own spectra (ignored when
        var_new/var_ref are given)
    want_psf_d : include the difference PSF stamp ``psf_D``

    Returns dict with D, S, Scorr, Fpsf, Fpsferr, F_D, F_S (and psf_D).
    """
    p = params
    dev = new.device
    H, W = new.shape
    impl = p.fft
    if impl == "auto":
        impl = ("split" if dev.type == "cuda" and min(H, W) >= 1024
                and p.pad_fast else "xla")
    if impl == "split":
        return _zogy_split(new, ref, psf_new, psf_ref, sn, sr, fn, fr,
                           var_new, var_ref, var_bkg_new, var_bkg_ref,
                           p, want_psf_d)
    Hp = fast_fft_size(H) if p.pad_fast else H
    Wp = fast_fft_size(W) if p.pad_fast else W
    shape = (Hp, Wp)
    if (Hp, Wp) != (H, W):
        new = _pad_to(new, Hp, Wp)
        ref = _pad_to(ref, Hp, Wp)
        var_new = None if var_new is None else _pad_to(var_new, Hp, Wp)
        var_ref = None if var_ref is None else _pad_to(var_ref, Hp, Wp)

    pack = p.pack_fft
    Wr = Wp // 2 + 1

    # the spectral algebra runs on rfft half planes; packed transforms
    # unpack to half right after the forward and re-mirror before the
    # inverse

    # each pair of transforms (and the single inverse) is a span
    def _fwd_pair(a, b):
        """Forward half-plane spectra of two real frames."""
        with span("zogy.fft"):
            if not pack:
                return torch.fft.rfft2(a), torch.fft.rfft2(b)
            Z = torch.fft.fft2(torch.complex(a, b))
            Zh = Z[:, :Wr]
            # Z(-k) on the half plane only: columns (W - v) mod W for v
            # in [0, Wr) are [0, W-1, ..., W-Wr+1]; rows (H - u) mod H
            cols = torch.cat([Z[:, :1], torch.flip(Z[:, Wp - Wr + 1:], [1])],
                             1)
            Zc = torch.conj(torch.roll(torch.flip(cols, [0]), 1, 0))
            return 0.5 * (Zh + Zc), -0.5j * (Zh - Zc)

    def _inv_pair(A, B):
        """Two real inverse transforms from half-plane spectra."""
        with span("zogy.fft"):
            if not pack:
                return (torch.fft.irfft2(A, s=shape),
                        torch.fft.irfft2(B, s=shape))
            head = A + 1j * B
            # tail of A+iB at mirrored frequencies: conj((A - iB)[-u,
            # W-v])
            t = torch.conj(torch.flip((A - 1j * B)[:, 1:Wp - Wr + 1], [1]))
            t = torch.roll(torch.flip(t, [0]), 1, 0)
            Y = torch.fft.ifft2(torch.cat([head, t], dim=1))
            return torch.real(Y), torch.imag(Y)

    def _inv_one(A):
        with span("zogy.fft"):
            return torch.fft.irfft2(A, s=shape)

    N_hat, R_hat = _fwd_pair(new, ref)
    Pn = psf_to_otf(psf_new, shape)
    Pr = psf_to_otf(psf_ref, shape)

    fn = _f32(fn, dev)
    fr = torch.clamp(_f32(fr, dev), min=p.fratio_floor)
    sn = torch.clamp(_f32(sn, dev), min=1e-6)
    sr = torch.clamp(_f32(sr, dev), min=1e-6)

    Pn2 = torch.abs(Pn) ** 2
    Pr2 = torch.abs(Pr) ** 2
    den = sn ** 2 * fr ** 2 * Pr2 + sr ** 2 * fn ** 2 * Pn2 + p.eps
    sq = torch.sqrt(den)

    D_hat = (fr * Pr * N_hat - fn * Pn * R_hat) / sq
    F_D = fn * fr / torch.sqrt(sn ** 2 * fr ** 2 + sr ** 2 * fn ** 2)
    P_D_hat = fn * fr * Pn * Pr / (F_D * sq)

    kn_hat = fn * fr ** 2 * torch.conj(Pn) * Pr2 / den
    kr_hat = fr * fn ** 2 * torch.conj(Pr) * Pn2 / den

    # rfft half-plane column weights for full-spectrum sums
    colw = torch.full((Wr,), 2.0, dtype=torch.float32, device=dev)
    colw[0] = 1.0
    if Wp % 2 == 0:
        colw[-1] = 1.0

    def _spec_mean(x):
        return torch.sum(colw * x) / (Hp * Wp)

    def _k2_hats():
        K = params.kernel_stamp
        if K and K < min(H, W):
            return _kernel_sq_otfs(
                psf_new, psf_ref, fn, fr, sn, sr, p.eps, K, shape)
        kn, kr = _inv_pair(kn_hat, kr_hat)
        return _fwd_pair(kn ** 2, kr ** 2)

    D = None
    if var_new is not None or var_ref is not None:
        kn2_hat, kr2_hat = _k2_hats()
        # variance maps are clamped: a few huge sentinel pixels would
        # corrupt the f32 transform frame-wide
        vcap = 1e4 * (sn ** 2 + sr ** 2)
        Vn = (sn ** 2 * torch.ones(shape, device=dev) if var_new is None
              else torch.clamp(torch.minimum(var_new, vcap), min=0.0))
        Vr = (sr ** 2 * torch.ones(shape, device=dev) if var_ref is None
              else torch.clamp(torch.minimum(var_ref, vcap), min=0.0))
        Vn_hat, Vr_hat = _fwd_pair(Vn, Vr)
        D, V_src = _inv_pair(D_hat, kn2_hat * Vn_hat + kr2_hat * Vr_hat)
    else:
        sum_kn2 = _spec_mean(torch.abs(kn_hat) ** 2)
        sum_kr2 = _spec_mean(torch.abs(kr_hat) ** 2)
        vbn = sn ** 2 if var_bkg_new is None else var_bkg_new
        vbr = sr ** 2 if var_bkg_ref is None else var_bkg_ref
        if getattr(vbn, "ndim", 0) == 2 and tuple(vbn.shape) != shape:
            vbn = _pad_edge_to(vbn, Hp, Wp)
        if getattr(vbr, "ndim", 0) == 2 and tuple(vbr.shape) != shape:
            vbr = _pad_edge_to(vbr, Hp, Wp)
        V_src = vbn * sum_kn2 + vbr * sum_kr2
        if var_bkg_new is not None or var_bkg_ref is not None:
            kn2_hat, kr2_hat = _k2_hats()
            D, src = _inv_pair(D_hat, kn2_hat * N_hat + kr2_hat * R_hat)
            V_src = V_src + torch.clamp(src, min=0.0)
    if D is None:
        D = _inv_one(D_hat)

    Sn, Sr = _inv_pair(kn_hat * N_hat, kr_hat * R_hat)
    S = Sn - Sr

    dSn_dy, dSn_dx = _grad(Sn)
    dSr_dy, dSr_dx = _grad(Sr)
    V_ast = (p.dx ** 2 * (dSn_dx ** 2 + dSr_dx ** 2)
             + p.dy ** 2 * (dSn_dy ** 2 + dSr_dy ** 2))

    V_S = V_src + V_ast
    Scorr = S / torch.sqrt(torch.clamp(V_S, min=p.eps))

    F_S = _spec_mean(fn ** 2 * fr ** 2 * Pn2 * Pr2 / den)
    F_S = torch.clamp(F_S, min=p.eps)
    Fpsf = S / F_S
    Fpsferr = torch.sqrt(torch.clamp(V_S, min=p.eps)) / F_S

    def _crop(a):
        return a[:H, :W] if (Hp, Wp) != (H, W) else a

    out = {"D": _crop(D), "S": _crop(S), "Scorr": _crop(Scorr),
           "Fpsf": _crop(Fpsf), "Fpsferr": _crop(Fpsferr),
           "F_D": F_D, "F_S": F_S}
    if want_psf_d:
        out["psf_D"] = otf_to_psf_stamp(P_D_hat, shape, psf_new.shape[-1])
    return out


def flux_ratio(flux_new, flux_ref, snr_new, snr_ref, valid,
               snr_min: float = 20.0):
    """Clipped-median flux ratio fr/fn from matched PSF-star fluxes.
    Returns (fratio, fratio_std, nkeep)."""
    ok = (valid & (snr_new > snr_min) & (snr_ref > snr_min)
          & (flux_new > 0) & (flux_ref > 0))
    r = torch.where(ok, flux_new / torch.clamp(flux_ref, min=1e-9),
                    float("nan"))
    med = nanmedian(r)
    mad = nanmedian(torch.abs(r - med)) * 1.4826
    keep = ok & (torch.abs(r - med) < 3.0 * torch.clamp(mad, min=1e-6))
    r2 = torch.where(keep, r, float("nan"))
    return (torch.nan_to_num(nanmedian(r2), nan=1.0),
            torch.nan_to_num(nanstd(r2), nan=0.0),
            torch.sum(keep, dtype=torch.int32))
