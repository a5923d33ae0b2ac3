"""2-D median filters and small stencils (port of
:mod:`blackbox_tpu.ops.filters`).

The comparator-network builders are copies of the JAX package's (pure
Python, but their module imports jax); ``tests/test_torch_import.py``
holds them equal.  :func:`median_filter` runs, on the card, the CUDA
kernel ``csrc/medians.cu``, which applies the SAME networks — the
sorted-column median — written out by :func:`median_network_source`
into ``csrc/median_networks.cuh``.  Its plain version runs the networks
as elementwise min/max over row strips (a k=7 ``unfold`` of the whole
10560² frame would take 22 GB).

Border semantics: the outermost ``k//2`` rows/columns keep the input.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from blackbox_tpu_torch import kernels

MEDIAN_KS = (3, 5, 7)     # window sizes the CUDA kernel is built for


# ---- comparator networks (copies of blackbox_tpu.ops.filters) ---------

@lru_cache(maxsize=None)
def transposition_pairs(n: int) -> tuple:
    """Odd-even transposition sort pairs (n passes)."""
    pairs = []
    for pas in range(n):
        for i in range(pas % 2, n - 1, 2):
            pairs.append((i, i + 1))
    return tuple(pairs)


def prune_pairs(pairs, needed_wires) -> tuple:
    """Prune a comparator network to the ops feeding ``needed_wires``.

    Returns ops ('ce'|'min'|'max', a, b): 'min' -> a = min(a, b),
    'max' -> b = max(a, b), 'ce' -> both.
    """
    needed = set(needed_wires)
    ops = []
    for a, b in reversed(pairs):
        na, nb = a in needed, b in needed
        if not (na or nb):
            continue
        if na and nb:
            ops.append(("ce", a, b))
        elif na:
            ops.append(("min", a, b))
        else:
            ops.append(("max", a, b))
        needed.add(a)
        needed.add(b)
    return tuple(reversed(ops))


def _oe_merge_pairs(L1, L2, pairs) -> list:
    """Batcher odd-even merge of two sorted wire lists (appends the
    compare-exchange pairs; returns the merged wire list)."""
    n1, n2 = len(L1), len(L2)
    if n1 == 0:
        return list(L2)
    if n2 == 0:
        return list(L1)
    if n1 == 1 and n2 == 1:
        pairs.append((L1[0], L2[0]))
        return [L1[0], L2[0]]
    E = _oe_merge_pairs(L1[0::2], L2[0::2], pairs)
    O = _oe_merge_pairs(L1[1::2], L2[1::2], pairs)
    res = [E[0]]
    i = 0
    while i < len(O) and i + 1 < len(E):
        pairs.append((O[i], E[i + 1]))
        res.append(O[i])
        res.append(E[i + 1])
        i += 1
    res.extend(O[i:])
    res.extend(E[i + 1:])
    return res


@lru_cache(maxsize=None)
def sorted_column_network(k: int) -> tuple:
    """Merge network over a k x k window with SHARED sorted columns.

    Wire numbering: ``dx * k + r`` = rank-r element of the column at
    horizontal offset dx.  Returns (merge_pairs, sorted_wire_order).
    """
    pairs: list = []
    cols = [[dx * k + r for r in range(k)] for dx in range(k)]
    while len(cols) > 1:
        nxt = []
        for i in range(0, len(cols) - 1, 2):
            nxt.append(_oe_merge_pairs(cols[i], cols[i + 1], pairs))
        if len(cols) % 2:
            nxt.append(cols[-1])
        cols = nxt
    return tuple(pairs), tuple(cols[0])


@lru_cache(maxsize=None)
def sc_select_ops(k: int, ranks: tuple) -> tuple:
    """Pruned sorted-column network for the given sorted ranks.

    Returns (ops, wires) — after ``apply_ops``, sorted rank ``ranks[i]``
    sits on wire ``wires[i]``.
    """
    pairs, order = sorted_column_network(k)
    wires = tuple(order[r] for r in ranks)
    return prune_pairs(pairs, wires), wires


def apply_ops(vals: list, ops) -> list:
    """Run a comparator program on a list of same-shape tensors
    (``torch.minimum``/``maximum`` propagate NaN, like ``jnp``'s)."""
    v = list(vals)
    for kind, a, b in ops:
        if kind == "ce":
            lo = torch.minimum(v[a], v[b])
            v[b] = torch.maximum(v[a], v[b])
            v[a] = lo
        elif kind == "min":
            v[a] = torch.minimum(v[a], v[b])
        else:
            v[b] = torch.maximum(v[a], v[b])
    return v


def median_network_source() -> str:
    """Text of ``csrc/median_networks.cuh``: the k x k median networks
    of :func:`sc_select_ops` as CUDA, for every k in MEDIAN_KS."""
    out = [
        "// Generated by blackbox_tpu_torch.ops.filters."
        "median_network_source();",
        "// tests/test_torch_filters.py holds this file equal to it.",
        "// MedianNet<K>::select(v) runs the pruned sorted-column merge",
        "// network on wires v[dx*K + r] (rank r of the sorted column at",
        "// offset dx) and returns the k*k//2-th order statistic.",
        "#pragma once",
        "",
        "// min/max that propagate NaN, like torch.minimum / jnp.minimum",
        "__device__ __forceinline__ float bbt_min(float a, float b) {",
        "  return (a < b || a != a) ? a : b;",
        "}",
        "__device__ __forceinline__ float bbt_max(float a, float b) {",
        "  return (a > b || a != a) ? a : b;",
        "}",
        "__device__ __forceinline__ void bbt_ce(float& a, float& b) {",
        "  const float lo = bbt_min(a, b);",
        "  b = bbt_max(a, b);",
        "  a = lo;",
        "}",
        "",
        "template <int K> struct MedianNet;",
    ]
    for k in MEDIAN_KS:
        ops, wires = sc_select_ops(k, (k * k // 2,))
        out += ["", f"template <> struct MedianNet<{k}> {{",
                "  static __device__ __forceinline__ float select("
                f"float (&v)[{k * k}]) {{"]
        for kind, a, b in ops:
            if kind == "ce":
                out.append(f"    bbt_ce(v[{a}], v[{b}]);")
            elif kind == "min":
                out.append(f"    v[{a}] = bbt_min(v[{a}], v[{b}]);")
            else:
                out.append(f"    v[{b}] = bbt_max(v[{a}], v[{b}]);")
        out += [f"    return v[{wires[0]}];", "  }", "};"]
    return "\n".join(out) + "\n"


# ---- median filters -----------------------------------------------------

def _strips(H: int, p: int, strip_rows: int):
    """Interior row ranges [r0, r1) covering rows p .. H-p-1."""
    for r0 in range(p, H - p, strip_rows):
        yield r0, min(r0 + strip_rows, H - p)


def _median_plain(img: torch.Tensor, k: int, strip_rows: int):
    """Plain version of :func:`median_filter`: the sorted-column
    networks as elementwise min/max over interior row strips."""
    H, W = img.shape
    p = k // 2
    out = img.clone()
    col_ops = [("ce", a, b) for a, b in transposition_pairs(k)]
    ops, wires = sc_select_ops(k, (k * k // 2,))
    for r0, r1 in _strips(H, p, strip_rows):
        s = img[r0 - p:r1 + p]
        h = r1 - r0
        colv = apply_ops([s[dy:dy + h] for dy in range(k)], col_ops)
        views = [colv[r][:, dx:dx + W - 2 * p]
                 for dx in range(k) for r in range(k)]
        out[r0:r1, p:W - p] = apply_ops(views, ops)[wires[0]]
    return out


def median_filter(img: torch.Tensor, k: int, strip_rows: int = 264):
    """k x k median filter (k in MEDIAN_KS); borders keep the input.

    CPU tensors take the plain strip version; CUDA tensors run the
    kernel ``csrc/medians.cu`` (same networks, bit-identical).
    """
    if k not in MEDIAN_KS:
        raise ValueError(f"median_filter: k={k} not in {MEDIAN_KS}")
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError("median_filter: (H, W) float32 image expected")
    if img.device.type == "cpu":
        return _median_plain(img, k, strip_rows)
    img = img.contiguous()
    kernels.require_cuda("median_filter", img)
    H, W = img.shape
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        kernels.check(kernels.lib().bbt_median_filter(
            img.data_ptr(), out.data_ptr(), H, W, k,
            kernels.stream_of(img)), "median_filter")
    median_filter.launches += 1
    return out


median_filter.launches = 0


def median_filter_sep(img: torch.Tensor, k: int, strip_rows: int = 264):
    """Separable k x k median: the k-median along y, then along x.

    The astroscrappy ``sepmed`` variant, plain PyTorch on every device
    (the JAX package has no kernel for it): the full odd-even
    transposition network of k values, as the JAX package runs it, on
    interior row strips; the outer ``k//2`` border keeps the input.
    """
    H, W = img.shape
    p = k // 2
    ops = [("ce", a, b) for a, b in transposition_pairs(k)]
    out = img.clone()
    for r0, r1 in _strips(H, p, strip_rows):
        s = img[r0 - p:r1 + p]
        h = r1 - r0
        col = apply_ops([s[dy:dy + h] for dy in range(k)], ops)[p]
        out[r0:r1, p:W - p] = apply_ops(
            [col[:, dx:dx + W - 2 * p] for dx in range(k)], ops)[p]
    return out


def masked_median_filter(img: torch.Tensor, bad: torch.Tensor, k: int = 5,
                         strip_rows: int = 264, fallback=None):
    """k x k median over neighbours where ``bad`` is False.

    An even count of good pixels gives ``0.5 * (lo + hi)``; a window
    with no good pixel (or a NaN median) takes ``fallback`` (default:
    the input); the outer ``k//2`` border keeps the input.  Plain
    PyTorch on every device (the JAX package has no kernel for it).
    """
    H, W = img.shape
    p = k // 2
    big = torch.finfo(img.dtype).max
    fb = img if fallback is None else fallback
    out = img.clone()
    pairs, order = sorted_column_network(k)
    col_ops = [("ce", a, b) for a, b in transposition_pairs(k)]
    merge_ops = [("ce", a, b) for a, b in pairs]
    Wi = W - 2 * p
    for r0, r1 in _strips(H, p, strip_rows):
        h = r1 - r0
        s = img[r0 - p:r1 + p]
        bs = bad[r0 - p:r1 + p]
        # bad -> +big BEFORE the shared column sorts, so good values
        # sort below every masked one and the ranks below n stay valid
        bcol = [bs[dy:dy + h] for dy in range(k)]
        colv = apply_ops([torch.where(b, big, s[dy:dy + h])
                          for dy, b in enumerate(bcol)], col_ops)
        views = [colv[r][:, dx:dx + Wi] for dx in range(k) for r in range(k)]
        sw = apply_ops(views, merge_ops)
        vs = torch.stack([sw[w] for w in order])
        ngood = sum((~b[:, dx:dx + Wi]).to(torch.int32)
                    for b in bcol for dx in range(k))
        i_lo = torch.clamp(ngood - 1, min=0) // 2
        i_hi = ngood // 2
        lo = vs.gather(0, i_lo[None].long())[0]
        hi = vs.gather(0, i_hi[None].long())[0]
        med = torch.where(ngood > 0, 0.5 * (lo + hi), torch.nan)
        med = torch.where(torch.isnan(med), fb[r0:r1, p:W - p], med)
        out[r0:r1, p:W - p] = med
    return out


def laplacian_subsampled(img: torch.Tensor) -> torch.Tensor:
    """L+ of the 2x-subsampled image, rebinned back (van Dokkum 2001 §3),
    in closed form: the mean of the four subpixel positive Laplacians.
    The frame-border ring is zeroed."""
    v = img
    up = torch.roll(v, 1, 0)
    dn = torch.roll(v, -1, 0)
    lf = torch.roll(v, 1, 1)
    rt = torch.roll(v, -1, 1)
    l00 = 2 * v - up - lf
    l01 = 2 * v - up - rt
    l10 = 2 * v - dn - lf
    l11 = 2 * v - dn - rt
    lplus = 0.25 * (l00.clamp(min=0.0) + l01.clamp(min=0.0)
                    + l10.clamp(min=0.0) + l11.clamp(min=0.0))
    lplus[0, :] = 0.0
    lplus[-1, :] = 0.0
    lplus[:, 0] = 0.0
    lplus[:, -1] = 0.0
    return lplus


def dilate(m: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Boolean dilation with a k x k structure (outside = False)."""
    x = m.to(torch.float32)[None, None]
    return F.max_pool2d(x, k, stride=1, padding=k // 2)[0, 0] > 0.5
