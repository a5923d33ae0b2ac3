"""2-D median filters and small stencils (port of
:mod:`blackbox_tpu.ops.filters`).

The comparator-network builders are copies of the JAX package's (pure
Python, but their module imports jax); ``tests/test_torch_import.py``
holds them equal.  :func:`median_filter` runs, on the card, the CUDA
kernel ``csrc/medians.cu``, which applies the tile programs of
:func:`tile_median_ops` (several overlapping windows a thread), written
out by :func:`median_network_source` into ``csrc/median_networks.cuh``.
Its plain version runs the JAX package's sorted-column networks as
elementwise min/max over row strips (a k=7 ``unfold`` of the whole
10560² frame would take 22 GB).  Both are exact order statistics with
NaN-propagating min/max, so they agree bit for bit up to the sign of a
zero.

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
    (``torch.minimum``/``maximum`` propagate NaN, like ``jnp``'s).

    Besides 'ce', 'min' and 'max', a tile program
    (:func:`tile_median_ops`) holds ('copy', a, b): b = a, where b may
    be a wire past the end of ``vals``; the list grows to hold it."""
    v = list(vals)
    for kind, a, b in ops:
        if kind == "ce":
            lo = torch.minimum(v[a], v[b])
            v[b] = torch.maximum(v[a], v[b])
            v[a] = lo
        elif kind == "min":
            v[a] = torch.minimum(v[a], v[b])
        elif kind == "max":
            v[b] = torch.maximum(v[a], v[b])
        else:
            v.extend([None] * (b + 1 - len(v)))
            v[b] = v[a]
    return v


def comparator_cost(ops) -> int:
    """min/max instructions of a comparator program: two a
    compare-exchange, one a 'min' or 'max', none a copy."""
    return sum({"ce": 2, "min": 1, "max": 1}.get(op[0], 0) for op in ops)


# ---- tile networks of the CUDA kernel -----------------------------------
#
# The kernel (csrc/medians.cu) gives each thread a tile of th x tw
# outputs, whose windows overlap, and runs one comparator program on the
# (k+th-1) x (k+tw-1) patch of input pixels under them: the separable
# sorting-network approach of A. Adams, "Fast Median Filters Using
# Separable Sorting Networks", ACM TOG 40(4), 2021.  The program sorts
# the pixels that all windows of the tile share once, then splits the
# tile in two along its longer side and merges each half's further
# shared pixels into a copy of that list, down to single windows.  A
# sorted column segment shared by several windows is sorted once.
# After every merge it forgets what cannot be the median: in a sorted
# subset S of a window of n values whose median has rank m, the value of
# rank r in S has a rank in [r, r + n - |S|] in the window, so only the
# ranks m - (n - |S|) .. m of S can be the median; the values below are
# counted out of the window and the target rank drops by as many.  The
# whole program is then pruned jointly for the tile's outputs.

MEDIAN_TILE = (2, 4)      # outputs of one kernel thread: rows, columns


def _oe_sort(wires: list, pairs: list) -> list:
    """Batcher odd-even merge sort of a wire list (appends the pairs;
    returns the sorted wire order)."""
    if len(wires) <= 1:
        return list(wires)
    h = len(wires) // 2
    return _oe_merge_pairs(_oe_sort(wires[:h], pairs),
                           _oe_sort(wires[h:], pairs), pairs)


class _TileProgram:
    """The unpruned program of :func:`tile_median_ops`.  Wire
    ``y * (k + tw - 1) + x`` is patch pixel (y, x); merges work in
    place, so a list that two halves of a tile use is copied to fresh
    wires first, and a pixel that two windows' sorts take is copied at
    the start of the program."""

    def __init__(self, k: int, th: int, tw: int):
        self.k, self.th, self.tw = k, th, tw
        self.pw = k + tw - 1
        self.n, self.m = k * k, k * k // 2
        self.nw = (k + th - 1) * self.pw
        self.head, self.ops = [], []
        self.used, self.cores = set(), {}
        self.outs = {}

    def fresh(self, wire: int, head: bool = False) -> int:
        (self.head if head else self.ops).append(("copy", wire, self.nw))
        self.nw += 1
        return self.nw - 1

    def ces(self, pairs):
        self.ops.extend(("ce", a, b) for a, b in pairs)

    def forget(self, wires: list, st: list) -> list:
        """Keep the ranks of a sorted subset that can be the median;
        ``st`` counts the values already dropped below and above."""
        n, m = self.n - st[0] - st[1], self.m - st[0]
        lo = max(0, m - (n - len(wires)))
        hi = min(len(wires) - 1, m)
        st[0] += lo
        st[1] += len(wires) - 1 - hi
        return wires[lo:hi + 1]

    def merge(self, a: list, b: list, st: list) -> list:
        pairs: list = []
        merged = _oe_merge_pairs(a, b, pairs)
        self.ces(pairs)
        return self.forget(merged, st)

    def raw_sorted(self, x: int, r0: int, r1: int) -> list:
        """Patch column x, rows r0..r1, sorted."""
        wires = []
        for y in range(r0, r1 + 1):
            w = y * self.pw + x
            wires.append(self.fresh(w, head=True) if w in self.used else w)
            self.used.add(w)
        pairs: list = []
        wires = _oe_sort(wires, pairs)
        self.ces(pairs)
        return wires

    def column(self, x: int, r0: int, r1: int) -> list:
        """Column x, rows r0..r1, sorted; where the rows hold the rows
        th-1 .. k-1 that every window of the tile covers, those are
        sorted once and the rest merged into a copy."""
        c0, c1 = self.th - 1, self.k - 1
        if not (r0 <= c0 and c1 <= r1 and (r0, r1) != (c0, c1)):
            return self.raw_sorted(x, r0, r1)
        if x not in self.cores:
            self.cores[x] = self.raw_sorted(x, c0, c1)
        col = [self.fresh(w) for w in self.cores[x]]
        for a, b in ((r0, c0 - 1), (c1 + 1, r1)):
            if a <= b:
                pairs: list = []
                col = _oe_merge_pairs(col, self.raw_sorted(x, a, b), pairs)
                self.ces(pairs)
        return col

    def rect(self, r0, r1, c0, c1, st) -> list:
        """Patch rows r0..r1 x columns c0..c1, sorted and forgetting."""
        if r0 > r1 or c0 > c1:
            return []
        cur = [self.forget(self.column(x, r0, r1), st)
               for x in range(c0, c1 + 1)]
        while len(cur) > 1:
            nxt = [self.merge(cur[i], cur[i + 1], st)
                   for i in range(0, len(cur) - 1, 2)]
            cur = nxt + cur[len(nxt) * 2:]
        return cur[0]

    def node(self, t0, t1, u0, u1, kept, st, prev):
        """Outputs rows t0..t1-1 x columns u0..u1-1: their shared pixels
        (``prev``, the parent's, sorted in ``kept``) and the rest."""
        k = self.k
        r0, r1, c0, c1 = t1 - 1, t0 + k - 1, u1 - 1, u0 + k - 1
        if r0 > r1 or c0 > c1:          # a tile wider than the window
            kept, here = [], None
        elif prev is None:
            kept, here = self.rect(r0, r1, c0, c1, st), (r0, r1, c0, c1)
        else:
            p0, p1, q0, q1 = prev
            new = ([(r0, p0 - 1, c0, c1), (p1 + 1, r1, c0, c1)]
                   if (q0, q1) == (c0, c1) else
                   [(r0, r1, c0, q0 - 1), (r0, r1, q1 + 1, c1)])
            for rect in new:
                part = self.rect(*rect, st)
                if part:
                    kept = self.merge(kept, part, st)
            here = (r0, r1, c0, c1)
        if (t1 - t0, u1 - u0) == (1, 1):
            assert len(kept) == 1
            self.outs[t0, u0] = kept[0]
            return
        if t1 - t0 >= u1 - u0:
            tm = (t0 + t1) // 2
            halves = [(t0, tm, u0, u1), (tm, t1, u0, u1)]
        else:
            um = (u0 + u1) // 2
            halves = [(t0, t1, u0, um), (t0, t1, um, u1)]
        for i, half in enumerate(halves):
            mine = kept if i == 1 else [self.fresh(w) for w in kept]
            self.node(*half, mine, list(st), here)


def _prune_program(ops, outs) -> tuple:
    """:func:`prune_pairs` for a program with copies: the ops that feed
    ``outs``, a compare-exchange with one live output made a min or a
    max."""
    needed = set(outs)
    kept = []
    for kind, a, b in reversed(ops):
        if kind == "copy":
            if b in needed:
                kept.append((kind, a, b))
                needed.discard(b)
                needed.add(a)
            continue
        na, nb = a in needed, b in needed
        if na or nb:
            kept.append(("ce" if na and nb else "min" if na else "max", a, b))
            needed.update((a, b))
    return tuple(reversed(kept))


@lru_cache(maxsize=None)
def tile_median_ops(k: int, th: int, tw: int) -> tuple:
    """Comparator program of the k x k medians of a th x tw output tile.

    Returns (ops, outs, nwires): wires 0 .. (k+th-1)*(k+tw-1) - 1 are
    the patch pixels under the tile, row-major; after ``apply_ops`` the
    median of the window at tile offset (t, u) sits on wire
    ``outs[t * tw + u]``.  Under NaN-propagating min/max it is NaN
    exactly where that window holds a NaN (every output depends on every
    pixel of its window)."""
    b = _TileProgram(k, th, tw)
    b.node(0, th, 0, tw, None, [0, 0], None)
    outs = tuple(b.outs[t, u] for t in range(th) for u in range(tw))
    return _prune_program(b.head + b.ops, outs), outs, b.nw


def _op_line(kind, a, b) -> str:
    """One op of a comparator program as a line of CUDA on ``v``."""
    if kind == "ce":
        return f"    bbt_ce(v[{a}], v[{b}]);"
    if kind == "min":
        return f"    v[{a}] = bbt_min(v[{a}], v[{b}]);"
    if kind == "max":
        return f"    v[{b}] = bbt_max(v[{a}], v[{b}]);"
    return f"    v[{b}] = v[{a}];"


def median_network_source() -> str:
    """Text of ``csrc/median_networks.cuh``: the NaN-propagating
    min/max, the k x k median networks of :func:`sc_select_ops` (K7's
    sorted-column merge) and the tile programs of
    :func:`tile_median_ops` (K2), as CUDA, for every k in MEDIAN_KS."""
    th, tw = MEDIAN_TILE
    out = [
        "// Generated by blackbox_tpu_torch.ops.filters."
        "median_network_source();",
        "// tests/test_torch_filters.py holds this file equal to it.",
        "// MedianNet<K>::select(v) runs the pruned sorted-column merge",
        "// network on wires v[dx*K + r] (rank r of the sorted column at",
        "// offset dx) and returns the k*k//2-th order statistic.",
        "// MedianTile<K>::run(ld, o) runs the tile program of",
        "// tile_median_ops(K, TH, TW) on the (K+TH-1) x (K+TW-1) patch",
        "// that ld(y, x) reads, loading each pixel just before its first",
        "// use, and writes the TH x TW medians to o, row-major.",
        "#pragma once",
        "",
        "// one instruction each (sm_80 and later): NaN if either input is",
        "// NaN, like torch.minimum / jnp.minimum",
        "__device__ __forceinline__ float bbt_min(float a, float b) {",
        "  float r;",
        '  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));',
        "  return r;",
        "}",
        "__device__ __forceinline__ float bbt_max(float a, float b) {",
        "  float r;",
        '  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));',
        "  return r;",
        "}",
        "__device__ __forceinline__ void bbt_ce(float& a, float& b) {",
        "  const float lo = bbt_min(a, b);",
        "  b = bbt_max(a, b);",
        "  a = lo;",
        "}",
        "",
        "template <int K> struct MedianNet;",
        "template <int K> struct MedianTile;",
    ]

    for k in MEDIAN_KS:
        ops, wires = sc_select_ops(k, (k * k // 2,))
        out += ["", f"template <> struct MedianNet<{k}> {{",
                "  static __device__ __forceinline__ float select("
                f"float (&v)[{k * k}]) {{"]
        out += [_op_line(*op) for op in ops]
        out += [f"    return v[{wires[0]}];", "  }", "};"]
    for k in MEDIAN_KS:
        ops, outs, nw = tile_median_ops(k, th, tw)
        pw = k + tw - 1
        # a patch pixel, or a copy of one made at the start, is loaded
        # just before its first use
        pixel = {w: divmod(w, pw) for w in range((k + th - 1) * pw)}
        body = []
        for kind, a, b in ops:
            if kind == "copy" and a in pixel and b not in pixel:
                pixel[b] = pixel[a]
                continue
            for w in (a,) if kind == "copy" else (a, b):
                if w in pixel:
                    y, x = pixel.pop(w)
                    body.append(f"    v[{w}] = ld({y}, {x});")
            body.append(_op_line(kind, a, b))
        out += ["", f"template <> struct MedianTile<{k}> {{",
                f"  static constexpr int TH = {th}, TW = {tw};",
                f"  // {comparator_cost(ops)} min/max for {th * tw} "
                "outputs",
                "  template <class Load>",
                "  static __device__ __forceinline__ void run(const Load& ld,"
                f" float (&o)[{th * tw}]) {{",
                f"    float v[{nw}];"]
        out += body
        out += [f"    o[{i}] = v[{w}];" for i, w in enumerate(outs)]
        out += ["  }", "};"]
    return "\n".join(out) + "\n"


# ---- stack-median networks of the CUDA kernel K9 -----------------------
#
# The kernel (csrc/stackmedian.cu) gives each thread a column of an
# (N, M) stack and selects ranks (N-1)//2 and N//2 of its N values, the
# two that jnp.median averages.  The network merges the values pairwise
# up a balanced tree (Batcher's odd-even merge) and after every merge
# forgets the ranks that can be neither, as the tile programs do
# (_TileProgram.forget, here for two target ranks); it is then pruned to
# the comparators that feed the two wires.

STACK_MEDIAN_MAX = 32     # longest stack the kernel is built for


@lru_cache(maxsize=None)
def stack_median_ops(n: int) -> tuple:
    """Comparator program that leaves ranks (n-1)//2 and n//2 of n
    values on two wires.  Returns (ops, (lo_wire, hi_wire)); for odd n
    the two are one wire."""
    # values still in play, and the two target ranks among them
    state = {"left": n, "lo": (n - 1) // 2, "hi": n // 2}

    def forget(wires):
        # rank r of a sorted subset of s of them has a rank in
        # [r, r + left - s] among all of them
        s, left = len(wires), state["left"]
        a = max(0, state["lo"] - (left - s))
        b = min(s - 1, state["hi"])
        state["lo"] -= a
        state["hi"] -= a
        state["left"] -= a + s - 1 - b
        return wires[a:b + 1]

    pairs: list = []
    cur = [[w] for w in range(n)]
    while len(cur) > 1:
        nxt = [forget(_oe_merge_pairs(cur[i], cur[i + 1], pairs))
               for i in range(0, len(cur) - 1, 2)]
        cur = nxt + cur[len(nxt) * 2:]
    wires = (cur[0][0], cur[0][-1])
    return prune_pairs(pairs, wires), wires


def stack_median_source() -> str:
    """Text of ``csrc/stack_median_networks.cuh``: the networks of
    :func:`stack_median_ops` as CUDA, for N = 1 .. STACK_MEDIAN_MAX."""
    out = [
        "// Generated by blackbox_tpu_torch.ops.filters."
        "stack_median_source();",
        "// tests/test_torch_stackmedian.py holds this file equal to it.",
        "// StackMedian<N>::select(v, lo, hi) runs the pruned network of",
        "// stack_median_ops(N) on the N values of a column, in place, and",
        "// returns its ranks (N-1)/2 and N/2.",
        "#pragma once",
        "",
        '#include "median_networks.cuh"',
        "",
        "template <int N> struct StackMedian;",
    ]
    for n in range(1, STACK_MEDIAN_MAX + 1):
        ops, (lo, hi) = stack_median_ops(n)
        out += ["", f"template <> struct StackMedian<{n}> {{",
                f"  // {comparator_cost(ops)} min/max",
                "  static __device__ __forceinline__ void select("
                f"float (&v)[{n}], float& lo, float& hi) {{"]
        out += [_op_line(*op) for op in ops]
        out += [f"    lo = v[{lo}];", f"    hi = v[{hi}];", "  }", "};"]
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
    kernel ``csrc/medians.cu`` (other networks, the same values).
    """
    if k not in MEDIAN_KS:
        raise ValueError(f"median_filter: k={k} not in {MEDIAN_KS}")
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError("median_filter: (H, W) float32 image expected")
    if img.device.type == "cpu":
        return _median_plain(img, k, strip_rows)
    img = img.contiguous()
    H, W = img.shape
    out = torch.empty_like(img)
    kernels.launch("median_filter", (img, out), img.data_ptr(),
                   out.data_ptr(), H, W, k)
    return out


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
                         strip_rows: int = 264, fallback=None,
                         nan_fallback: bool = True):
    """k x k median over neighbours where ``bad`` is False.

    An even count of good pixels gives ``0.5 * (lo + hi)``; a window
    with no good pixel takes ``fallback`` (default: the input), and so
    does a NaN median unless ``nan_fallback`` is False (the JAX
    package's windowed form, ``_win_masked_median``, keeps it); the
    outer ``k//2`` border keeps the input.  Plain PyTorch on every
    device (the JAX package has no kernel for it).
    """
    H, W = img.shape
    p = k // 2
    fb = img if fallback is None else fallback
    out = img.clone()
    for r0, r1 in _strips(H, p, strip_rows):
        out[r0:r1, p:W - p] = masked_median_rows(
            img[r0 - p:r1 + p], bad[r0 - p:r1 + p], k,
            fb[r0:r1, p:W - p], nan_fallback)
    return out


def masked_median_rows(s: torch.Tensor, bs: torch.Tensor, k: int,
                       fallback: torch.Tensor, nan_fallback: bool = True):
    """The masked k x k medians of the interior of ``s`` (..., h + k - 1,
    w + k - 1), bad where ``bs`` is True: (..., h, w), ``fallback``
    where no pixel is good (and where the median is NaN, with
    ``nan_fallback``).  Leading dimensions are a batch (the windows of
    :mod:`blackbox_tpu_torch.ops.cosmics`)."""
    p = k // 2
    h = s.shape[-2] - 2 * p
    Wi = s.shape[-1] - 2 * p
    big = torch.finfo(s.dtype).max
    pairs, order = sorted_column_network(k)
    col_ops = [("ce", a, b) for a, b in transposition_pairs(k)]
    merge_ops = [("ce", a, b) for a, b in pairs]
    # bad -> +big BEFORE the shared column sorts, so good values sort
    # below every masked one and the ranks below n stay valid
    bcol = [bs[..., dy:dy + h, :] for dy in range(k)]
    colv = apply_ops([torch.where(b, big, s[..., dy:dy + h, :])
                      for dy, b in enumerate(bcol)], col_ops)
    views = [colv[r][..., dx:dx + Wi] for dx in range(k) for r in range(k)]
    sw = apply_ops(views, merge_ops)
    vs = torch.stack([sw[w] for w in order])
    ngood = sum((~b[..., dx:dx + Wi]).to(torch.int32)
                for b in bcol for dx in range(k))
    i_lo = torch.clamp(ngood - 1, min=0) // 2
    i_hi = ngood // 2
    lo = vs.gather(0, i_lo[None].long())[0]
    hi = vs.gather(0, i_hi[None].long())[0]
    if nan_fallback:
        med = torch.where(ngood > 0, 0.5 * (lo + hi), torch.nan)
        return torch.where(torch.isnan(med), fallback, med)
    return torch.where(ngood > 0, 0.5 * (lo + hi), fallback)


def laplacian_subsampled(img: torch.Tensor, ring=None) -> torch.Tensor:
    """L+ of the 2x-subsampled image, rebinned back (van Dokkum 2001 §3),
    in closed form: the mean of the four subpixel positive Laplacians.
    The frame-border ring is zeroed, or the pixels of the bool map
    ``ring`` (a column block's share of its frame's ring, or a batch of
    windows' share: the neighbours then wrap inside each window, as in
    the JAX package's ``_win_laplacian``)."""
    v = img
    up = torch.roll(v, 1, -2)
    dn = torch.roll(v, -1, -2)
    lf = torch.roll(v, 1, -1)
    rt = torch.roll(v, -1, -1)
    l00 = 2 * v - up - lf
    l01 = 2 * v - up - rt
    l10 = 2 * v - dn - lf
    l11 = 2 * v - dn - rt
    lplus = 0.25 * (l00.clamp(min=0.0) + l01.clamp(min=0.0)
                    + l10.clamp(min=0.0) + l11.clamp(min=0.0))
    if ring is not None:
        return torch.where(ring, 0.0, lplus)
    lplus[0, :] = 0.0
    lplus[-1, :] = 0.0
    lplus[:, 0] = 0.0
    lplus[:, -1] = 0.0
    return lplus


def dilate(m: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Boolean dilation with a k x k structure (outside = False) of an
    (H, W) mask or of a batch (..., H, W), each plane on its own."""
    x = m.to(torch.float32).reshape(-1, 1, *m.shape[-2:])
    return (F.max_pool2d(x, k, stride=1, padding=k // 2) > 0.5).reshape(
        m.shape)


def fixpix(img: torch.Tensor, mask_bad: torch.Tensor, k: int = 5,
           strip_rows: int = 264, iterations: int = 2) -> torch.Tensor:
    """Interpolate masked pixels from their good neighbours (the co-add's
    input preparation): masked pixels take the masked k x k median of
    their good neighbours (:func:`masked_median_filter`); a second pass
    fills pixels whose whole neighbourhood was bad."""
    out = img
    bad = mask_bad
    for _ in range(iterations):
        repl = masked_median_filter(out, bad, k, strip_rows)
        out = torch.where(bad, repl, out)
        # pixels still at the fallback (all-bad neighbourhood) stay bad
        bad = bad & (repl == img)
    return out
