"""Split-real mixed-radix FFT along axis 0 (port of
:mod:`blackbox_tpu.pallas.fft`).

A complex (N, L) signal travels as two float32 planes (re, im), and
each column is transformed on its own.  N = N2·N1 with N1 = 2^k and
N2 ∈ {1, 3, 5, 7, 11, 21}; writing the input row n = n1 + N1·n2 and
the output k = r + N2·m:

  step A:  A[r·N1+n1] = Σ_n2 x[n2·N1+n1]·W_N2^{n2 r} · W_N^{n1 r}
  step B:  per group r, radix-2 DIF over n1 (natural in, bit-rev out)

so physical row r·N1 + bitrev(m) holds X[r + N2·m] — the "scrambled"
layout.  Nothing unscrambles it on the science path: the spectral
algebra is elementwise, the OTF planes are built in the layout
(:func:`spectrum_freqs`) and the inverse (DIT radix-2, then the
conjugate step A) takes it natively and returns natural rows.  A 2-D
transform is column pass -> transpose -> column pass
(:func:`fft2_split`), its inverse the mirror (:func:`ifft2_split`).

:func:`fft_cols_split` is the wrapper of the CUDA kernel
``csrc/fft.cu`` (the port of the TPU kernel ``_fft_kernel``) and, for
CPU tensors, of its plain version :func:`_fft_cols_plain`, which runs
the same algorithm with the same f32 tables, operation by operation,
on whole planes.  The plan and table helpers are copies of the JAX
package's (``tests/test_torch_import.py`` holds them equal).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from blackbox_tpu_torch import kernels

_ODD = (21, 11, 7, 5, 3, 1)


def plan(N: int) -> tuple[int, int, int]:
    """Factor N = N2 · 2^k with N2 the largest factor from the
    supported odd set.  Returns (N1, N2, k); raises if the remaining
    cofactor is not a power of two or is < 8."""
    for q in _ODD:
        if N % q == 0:
            N1 = N // q
            if N1 >= 8 and (N1 & (N1 - 1)) == 0:
                return N1, q, N1.bit_length() - 1
    raise ValueError(f"unsupported FFT size {N}: need N = q·2^k, "
                     f"q ∈ {_ODD}, 2^k >= 8")


def _bitrev(n: int, k: int) -> np.ndarray:
    out = np.zeros(n, np.int64)
    for i in range(n):
        b, x = 0, i
        for _ in range(k):
            b = (b << 1) | (x & 1)
            x >>= 1
        out[i] = b
    return out


@functools.lru_cache(maxsize=32)
def spectrum_perm(N: int) -> np.ndarray:
    """perm with X_natural[j] = scrambled[perm[j]] along one axis."""
    N1, N2, k = plan(N)
    br = _bitrev(N1, k)
    j = np.arange(N)
    r = j % N2
    m = j // N2
    return r * N1 + br[m]


@functools.lru_cache(maxsize=32)
def spectrum_freqs(N: int) -> np.ndarray:
    """Frequency index (0..N-1) of each PHYSICAL row of the scrambled
    spectrum — the inverse permutation of :func:`spectrum_perm`."""
    p = spectrum_perm(N)
    inv = np.empty(N, np.int64)
    inv[p] = np.arange(N)
    return inv


@functools.lru_cache(maxsize=32)
def mirror_perm(N: int) -> np.ndarray:
    """Physical index of the NEGATED frequency for each physical row of
    the scrambled spectrum (the hermitian-unpack gather)."""
    f = spectrum_freqs(N)
    P = spectrum_perm(N)
    return P[(N - f) % N]


def _tables(N: int, inverse: bool):
    """Host-side twiddle tables for one axis length.

    Returns (twA_re, twA_im, twB_re, twB_im, w21) —
    twA: (N, 1) step-A twiddle in physical row order r·N1+n1;
    twB: (max(k-1,1)·N1, 1) per-stage full-length butterfly twiddles
         (top half of each 2h block = 1, bottom = W_{2h}^j), stage s
         (DIF order, h = N1>>(s+1)) at rows [s·N1, (s+1)·N1);
    w21: (N2, N2) complex128 DFT constants.
    """
    N1, N2, k = plan(N)
    sign = 1.0 if inverse else -1.0
    n1 = np.arange(N1)
    r = np.arange(N2)
    twA = np.exp(sign * 2j * np.pi * np.outer(r, n1) / N)   # (N2, N1)
    twA = twA.reshape(-1, 1)
    nstage = max(k - 1, 1)
    twB = np.ones((nstage, N1), np.complex128)
    for s in range(k - 1):
        h = N1 >> (s + 1)
        j = np.arange(N1)
        jh = j % (2 * h)
        tw = np.exp(sign * 2j * np.pi * (jh - h) / (2 * h))
        twB[s] = np.where(jh < h, 1.0, tw)
    twB = twB.reshape(-1, 1)
    w21 = np.exp(sign * 2j * np.pi * np.outer(r, r) / N2)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return (f32(twA.real), f32(twA.imag),
            f32(twB.real), f32(twB.imag), w21)


@functools.lru_cache(maxsize=16)
def _device_tables(N: int, inverse: bool, device: str):
    """The f32 tables of :func:`_tables` on ``device``: twA and twB as
    flat (re, im) planes, and the DFT_N2 constants rounded to f32
    (the values the TPU kernel embeds as f32 immediates) as an
    (N2, N2, 2) tensor plus the same numbers as Python floats."""
    twa_re, twa_im, twb_re, twb_im, w21 = _tables(N, inverse)
    w32 = np.stack([w21.real, w21.imag], -1).astype(np.float32)
    dev = torch.device(device)
    return (torch.from_numpy(twa_re.reshape(-1)).to(dev),
            torch.from_numpy(twa_im.reshape(-1)).to(dev),
            torch.from_numpy(twb_re.reshape(-1)).to(dev),
            torch.from_numpy(twb_im.reshape(-1)).to(dev),
            torch.from_numpy(w32).to(dev), w32.tolist())


def dft_constants(N2: int, inverse: bool) -> np.ndarray:
    """The (N2, N2, 2) float32 DFT_N2 constants of :func:`_tables`
    (w[n2][r] as (re, im)), the values the kernel multiplies by."""
    w21 = _tables(8 * N2, inverse)[4]
    return np.stack([w21.real, w21.imag], -1).astype(np.float32)


def dft_pair_masks(N2: int, inverse: bool) -> list[int]:
    """For each input i of the DFT_N2, a bit mask over the output pairs
    (j, N2 - j), j = 1 .. (N2 - 1) // 2: bit 16 + j is set when the
    constant the pair's second output multiplies input i by equals the
    first's bit for bit, and bit j when it is, bit for bit, the first's
    conjugate (the same real part, the negated imaginary part).  The
    kernel then shares the pair's term, or its four products, which
    changes no rounding: (-b)·x is -(b·x) and a - (-p) is a + p."""
    w = dft_constants(N2, inverse).view(np.uint32)
    neg = np.uint32(0x80000000)
    masks = []
    for i in range(N2):
        m = 0
        for j in range(1, (N2 + 1) // 2):
            a, b = ((w[j][i], w[N2 - j][i]) if inverse
                    else (w[i][j], w[i][N2 - j]))
            if a[0] == b[0] and a[1] == b[1]:
                m |= 1 << (16 + j)
            elif a[0] == b[0] and a[1] == (b[1] ^ neg):
                m |= 1 << j
        masks.append(m)
    return masks


def dft_constants_source() -> str:
    """Text of ``csrc/fft_constants.cuh``: the DFT_N2 constants of
    :func:`dft_constants` for every odd factor and both directions as
    exact hexadecimal float literals in ``__constant__`` arrays, read by
    ``dft_c<N2, inverse>(i)`` (element i of w flattened as (re, im)
    pairs), and the masks of :func:`dft_pair_masks` as
    ``dft_pairs<N2, inverse>(i)``.  The kernel calls both with indices
    that unrolling makes constant."""
    out = ["// Generated by "
           "blackbox_tpu_torch.ops.fft.dft_constants_source();",
           "// tests/test_torch_fft.py holds this file equal to it and its",
           "// values equal to ops/fft.py::_tables bit for bit.  Each table",
           "// is w[n2][r] as (re, im) pairs, row-major: the float64",
           "// exp(-+2 pi i n2 r / N2) rounded to float32.",
           "#pragma once", "",
           "template <int N2, bool kInverse>",
           "__device__ __forceinline__ float dft_c(int i);",
           "template <int N2, bool kInverse>",
           "__device__ __forceinline__ unsigned dft_pairs(int i);", ""]
    for q in _ODD[:-1][::-1]:
        for inverse in (False, True):
            name = f"kDft{q}{'Inv' if inverse else 'Fwd'}"
            inv = "true" if inverse else "false"
            vals = [float(v).hex() + "f"
                    for v in dft_constants(q, inverse).reshape(-1)]
            masks = dft_pair_masks(q, inverse)
            out.append(f"__constant__ float {name}[{len(vals)}] = {{")
            for i in range(0, len(vals), 3):
                out.append("    " + ", ".join(vals[i:i + 3]) + ",")
            out += ["};",
                    "template <> __device__ __forceinline__ float",
                    f"dft_c<{q}, {inv}>(int i) {{ return {name}[i]; }}",
                    "template <> __device__ __forceinline__ unsigned",
                    f"dft_pairs<{q}, {inv}>(int i) {{",
                    "  switch (i) {"]
            out += [f"    case {i}: return {m:#x}u;"
                    for i, m in enumerate(masks[:-1])]
            out += [f"    default: return {masks[-1]:#x}u;", "  }", "}", ""]
    return "\n".join(out)


def _cmul(vr, vi, tr, ti):
    """(vr + i·vi) · (tr + i·ti), each product and sum rounded."""
    return vr * tr - vi * ti, vr * ti + vi * tr


def _butterfly(vr, vi, h: int):
    """One radix-2 add/sub round on (G, N1, L) planes viewed as
    (G, blocks, 2h, L): out = concat([a+b, a-b])."""
    G, N1, L = vr.shape
    b = N1 // (2 * h)
    vr4 = vr.reshape(G, b, 2 * h, L)
    vi4 = vi.reshape(G, b, 2 * h, L)
    ar, br_ = vr4[:, :, :h], vr4[:, :, h:]
    ai, bi = vi4[:, :, :h], vi4[:, :, h:]
    nr = torch.cat([ar + br_, ar - br_], dim=2)
    ni = torch.cat([ai + bi, ai - bi], dim=2)
    return nr.reshape(G, N1, L), ni.reshape(G, N1, L)


def _dft_n2(xs, w, transpose: bool):
    """The DFT_N2 of step A over the N2 row groups ``xs``: output group
    r sums w[n2][r]·xs[n2] (w[r][n2] when ``transpose``) in n2 order."""
    out = []
    N2 = len(xs)
    for r in range(N2):
        acc_r = acc_i = None
        for n2 in range(N2):
            wr, wi = w[r][n2] if transpose else w[n2][r]
            xr, xi = xs[n2]
            tr = wr * xr - wi * xi
            ti = wr * xi + wi * xr
            acc_r = tr if acc_r is None else acc_r + tr
            acc_i = ti if acc_i is None else acc_i + ti
        out.append((acc_r, acc_i))
    return out


def _fft_cols_plain(xr, xi, inverse: bool, scale: float):
    """Plain version of :func:`fft_cols_split`: the kernel's algorithm
    on whole planes (step A as N2² scalar-weighted adds, radix-2 stages
    by reshape), with the kernel's tables and operation order."""
    N, L = xr.shape
    N1, N2, k = plan(N)
    twa_re, twa_im, twb_re, twb_im, _, w = _device_tables(
        N, inverse, str(xr.device))
    scale = float(np.float32(scale))
    vr = xr.reshape(N2, N1, L)
    vi = xi.reshape(N2, N1, L)
    ta = (twa_re.reshape(N2, N1, 1), twa_im.reshape(N2, N1, 1))
    tb = (twb_re.reshape(-1, 1, N1, 1), twb_im.reshape(-1, 1, N1, 1))

    def radix2(vr, vi):
        if not inverse:
            for s in range(k):
                h = N1 >> (s + 1)
                vr, vi = _butterfly(vr, vi, h)
                if h > 1:
                    vr, vi = _cmul(vr, vi, tb[0][s], tb[1][s])
        else:
            for s in range(k - 1, -1, -1):
                h = N1 >> (s + 1)
                if h > 1:
                    vr, vi = _cmul(vr, vi, tb[0][s], tb[1][s])
                vr, vi = _butterfly(vr, vi, h)
        return vr, vi

    if not inverse:
        if N2 > 1:
            a = _dft_n2([(vr[n2], vi[n2]) for n2 in range(N2)], w, False)
            vr = torch.stack([p[0] for p in a])
            vi = torch.stack([p[1] for p in a])
            vr, vi = _cmul(vr, vi, *ta)
        vr, vi = radix2(vr, vi)
    else:
        vr, vi = radix2(vr, vi)
        if N2 > 1:
            br_, bi = _cmul(vr, vi, *ta)
            a = _dft_n2([(br_[r], bi[r]) for r in range(N2)], w, True)
            vr = torch.stack([p[0] for p in a])
            vi = torch.stack([p[1] for p in a])
        if scale != 1.0:
            vr = vr * scale
            vi = vi * scale
    return vr.reshape(N, L), vi.reshape(N, L)


def fft_cols_split(xr, xi, inverse: bool = False, scale: float = 1.0):
    """1-D FFT along axis 0 of a split-complex (N, L) float32 pair.

    Forward: natural rows in -> SCRAMBLED spectral rows out (physical
    row r·N1+bitrev(m) holds X[r+N2·m]; :func:`spectrum_freqs` gives
    each row's frequency).  Inverse: scrambled rows in -> natural rows
    out, multiplied by ``scale`` (pass 1/N for a true inverse).
    Returns (yr, yi).  CPU tensors take the plain version; CUDA tensors
    run the kernel ``csrc/fft.cu`` (two launches: the step-A pass and
    the radix-2 pass).
    """
    N, L = xr.shape
    if xi.shape != (N, L):
        raise ValueError("fft_cols_split: re/im shape mismatch")
    plan(N)
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError("fft_cols_split: float32 planes expected")
    if xr.device.type == "cpu":
        return _fft_cols_plain(xr, xi, inverse, scale)
    return _fft_cols_cuda(xr.contiguous(), xi.contiguous(), inverse, scale)


def _fft_cols_cuda(xr, xi, inverse: bool, scale: float):
    N, L = xr.shape
    N1, N2, k = plan(N)
    # the DFT_N2 constants are compiled in (csrc/fft_constants.cuh)
    twa_re, twa_im, twb_re, twb_im = _device_tables(
        N, inverse, str(xr.device))[:4]
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    tmp_r = torch.empty_like(xr)
    tmp_i = torch.empty_like(xi)
    kernels.launch("fft_cols_split", (xr, xi, twa_re),
                   xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                   tmp_r.data_ptr(), tmp_i.data_ptr(), twa_re.data_ptr(),
                   twa_im.data_ptr(), twb_re.data_ptr(), twb_im.data_ptr(),
                   N1, N2, k, L, int(inverse), float(np.float32(scale)))
    return yr, yi


def fft2_split(xr, xi):
    """2-D FFT of a split-complex (H, W) pair.

    Returns (Yr, Yi) in TRANSPOSED SCRAMBLED layout: shape (W, H);
    element [p, q] is the spectrum at frequency
    (u, v) = (spectrum_freqs(H)[q], spectrum_freqs(W)[p]).
    """
    yr, yi = fft_cols_split(xr, xi)                            # axis 0
    yr, yi = yr.T.contiguous(), yi.T.contiguous()              # (W, H)
    return fft_cols_split(yr, yi)                              # axis 1


def ifft2_split(yr, yi, scale: bool = True):
    """Inverse of :func:`fft2_split`: (W, H) transposed-scrambled in,
    natural (H, W) out; divides by H·W when ``scale``."""
    W, H = yr.shape
    s = 1.0 / W if scale else 1.0
    zr, zi = fft_cols_split(yr, yi, inverse=True, scale=s)     # axis 1
    zr, zi = zr.T.contiguous(), zi.T.contiguous()              # (H, W)
    s = 1.0 / H if scale else 1.0
    return fft_cols_split(zr, zi, inverse=True, scale=s)       # axis 0


def unscramble2(yr, yi):
    """Natural-order complex spectrum from :func:`fft2_split` output —
    test glue (two gathers + a transpose), never on the science path."""
    W, H = yr.shape
    pr = torch.from_numpy(spectrum_perm(W)).to(yr.device)
    pc = torch.from_numpy(spectrum_perm(H)).to(yr.device)
    z = torch.complex(yr, yi)[pr][:, pc].T
    return z
