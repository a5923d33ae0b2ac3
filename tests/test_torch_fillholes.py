"""The hole fill's kernel (K8, ``csrc/fillholes.cu``) on the CPU: the
formulation it runs, held bit for bit against the plain version
(``ops/morphology._fill_holes``), which the card tests hold the kernel
against and the CPU tests hold against the JAX package.

* :func:`carry_sweeps`: each sweep as the sequential carry recurrence
  ``c <- O & (R | c)`` along its lines, the equivalence with the
  log-doubling scan that the kernel relies on.
* :func:`packed_model`: the kernel's schedule on 32-pixel words: the
  pack, each vertical sweep as segment sums, the warp's scan of the
  segments (a lane's fold, then five shuffles) and a rescan, each
  horizontal sweep as the add-carry chain inside a word and the 32
  lanes' generate/propagate addition across words, and the unpack.
"""

import numpy as np
import pytest
import torch

from blackbox_tpu_torch import kernels
from blackbox_tpu_torch.ops import morphology as M

FULL = np.uint64(0xFFFFFFFF)
LANES = np.arange(32, dtype=np.uint64)


def spiral(n: int) -> np.ndarray:
    """Nested square walls with one gap each, the gaps at alternate
    corners: the flood from the border turns at every wall, so a round
    of four sweeps reaches one more ring (n = 40 differs at 1, 2, 3 and
    4 rounds)."""
    m = np.zeros((n, n), bool)
    for k, r in enumerate(range(1, n // 2 - 1, 2)):
        m[r, r:n - r] = m[n - 1 - r, r:n - r] = True
        m[r:n - r, r] = m[r:n - r, n - 1 - r] = True
        if k % 2:
            m[n - 1 - r, n - 2 - r] = False
        else:
            m[r, r + 1] = False
    return m


def carry_sweeps(m: torch.Tensor, iterations: int) -> torch.Tensor:
    """The four sweeps as sequential carry scans along each line."""
    O = ~m
    R = O.clone()
    R[..., 1:-1, 1:-1] = False                     # the border's seeds
    for _ in range(max(iterations, 1)):
        for dim, back in ((-2, False), (-2, True), (-1, False), (-1, True)):
            n = m.shape[dim]
            c = torch.zeros_like(O.select(dim, 0))
            for k in (range(n - 1, -1, -1) if back else range(n)):
                c = O.select(dim, k) & (R.select(dim, k) | c)
                R.select(dim, k).copy_(c)
    return m | (O & ~R)


# ------------------------------------------------------- the packed model

def _brev(x):
    out = np.zeros_like(x)
    for i in range(32):
        out |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(31 - i)
    return out


def _ballot(bits):
    """(rows, 32) 0/1 lanes -> (rows,) masks"""
    return (bits.astype(np.uint64) << LANES).sum(1, dtype=np.uint64)


def _row_sweep(O, R):
    """The right sweep of every row of (rows, nw) words, 32 words a
    run: the kernel's carry_fill."""
    rows, nw = O.shape
    out = np.empty_like(R)
    cin = np.zeros(rows, np.uint64)
    for w0 in range(0, nw, 32):
        n = min(32, nw - w0)
        o = np.zeros((rows, 32), np.uint64)
        r = np.zeros((rows, 32), np.uint64)
        o[:, :n], r[:, :n] = O[:, w0:w0 + n], R[:, w0:w0 + n]
        s = o & r
        g = _ballot((o + s) >> np.uint64(32))
        p = _ballot(o == FULL)
        t = (p | g) + g + cin
        into = (t ^ (p | g) ^ g) & FULL
        cin = t >> np.uint64(32)
        c = (into[:, None] >> LANES) & np.uint64(1)
        res = o & (s | (((o + s + c) & FULL) ^ o ^ s))
        out[:, w0:w0 + n] = res[:, :n]
    return out


def _scan_carries(A, B):
    """Carry-ins of (S, lines) segment transfers in scan order, as a
    warp scans them: lane l folds segments [l K, l K + K), the lanes'
    folds are scanned by shfl_up steps, then each lane walks its own."""
    S = A.shape[0]
    K = -(-S // 32)
    la = np.zeros((32,) + A.shape[1:], np.uint64)
    lb = np.full((32,) + A.shape[1:], FULL)
    for lane in range(32):
        for j in range(min(S, lane * K), min(S, lane * K + K)):
            la[lane] = A[j] | (B[j] & la[lane])
            lb[lane] &= B[j]
    off = 1
    while off < 32:
        a2, b2 = la[:-off].copy(), lb[:-off].copy()
        la[off:] |= lb[off:] & a2
        lb[off:] &= b2
        off *= 2
    cins = np.empty_like(A)
    for lane in range(32):
        c = la[lane - 1] if lane else np.zeros_like(la[0])
        for j in range(min(S, lane * K), min(S, lane * K + K)):
            cins[j] = c
            c = A[j] | (B[j] & c)
    return cins


def _column_sweep(O, R, L, down):
    """A vertical sweep of (P, H, nw) words: segments of L rows summed,
    scanned, rescanned."""
    H = O.shape[1]
    segs = [range(y0, min(H, y0 + L)) for y0 in range(0, H, L)]
    if not down:
        segs = [s[::-1] for s in segs[::-1]]
    A, B = [], []
    for seg in segs:
        a = np.zeros_like(O[:, 0])
        b = np.full_like(O[:, 0], FULL)
        for y in seg:
            a = O[:, y] & (R[:, y] | a)
            b &= O[:, y]
        A.append(a)
        B.append(b)
    cins = _scan_carries(np.stack(A), np.stack(B))
    R = R.copy()
    for seg, c in zip(segs, cins):
        for y in seg:
            c = O[:, y] & (R[:, y] | c)
            R[:, y] = c
    return R


def packed_model(m: torch.Tensor, iterations: int,
                 threads: int) -> torch.Tensor:
    """The kernel's schedule with ``threads`` resident threads (which
    set the segments, as the launcher does)."""
    H, W = m.shape[-2], m.shape[-1]
    P = m.numel() // (H * W)
    nw = -(-W // 32)
    bits = np.zeros((P, H, nw * 32), np.uint64)
    bits[..., :W] = m.reshape(P, H, W).numpy()
    words = (bits.reshape(P, H, nw, 32) << LANES).sum(-1, dtype=np.uint64)
    valid = np.full(nw, FULL)
    if W % 32:
        valid[-1] = (1 << (W % 32)) - 1
    O = ~words & valid
    border = np.zeros((H, nw), np.uint64)
    border[[0, -1]] = FULL
    border[:, 0] |= np.uint64(1)
    border[:, (W - 1) // 32] |= np.uint64(1 << ((W - 1) % 32))
    R = O & border
    S = min(H, max(1, threads // (P * nw)))
    L = -(-H // S)
    for _ in range(max(iterations, 1)):
        R = _column_sweep(O, R, L, True)
        R = _column_sweep(O, R, L, False)
        rows = R.reshape(-1, nw)
        rows = _row_sweep(O.reshape(-1, nw), rows)
        rows = _brev(_row_sweep(_brev(O.reshape(-1, nw)[:, ::-1]),
                                _brev(rows[:, ::-1])))[:, ::-1]
        R = rows.reshape(P, H, nw)
    out = (~R & valid)[..., None] >> LANES & np.uint64(1)
    out = out.reshape(P, H, nw * 32)[..., :W].astype(bool)
    return torch.from_numpy(out).reshape(m.shape)


# ------------------------------------------------------------------ tests

def _masks():
    g = np.random.default_rng(17)
    blobs = g.random((2, 45, 70)) > 0.55
    blobs[:, 10:20, 30:44] = True
    blobs[:, 13:17, 35:39] = False                 # a hole
    cases = {
        "random": torch.from_numpy(blobs),
        "sparse": torch.from_numpy(g.random((37, 33)) > 0.8),
        "spiral": torch.from_numpy(spiral(40)),
        "spiral_wide": torch.from_numpy(np.pad(spiral(40), ((3, 4), (50, 9)))),
    }
    corridor = np.zeros((5, 1320), bool)          # reached only from x = 0,
    corridor[[1, 3]] = True                       # through word 32
    corridor[2, 1100] = True
    cases["corridor_1320"] = torch.from_numpy(corridor)
    cases["random_1320"] = torch.from_numpy(g.random((7, 1320)) > 0.45)
    for shape in [(1, 40), (2, 33), (40, 1), (35, 2), (5, 31), (6, 32),
                  (3, 4, 33)]:
        cases[f"odd_{'x'.join(map(str, shape))}"] = torch.from_numpy(
            g.random(shape) > 0.4)
    return cases


MASKS = _masks()


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_carry_sweeps_match_plain(name, iterations):
    m = MASKS[name]
    assert torch.equal(carry_sweeps(m, iterations),
                       M._fill_holes(m, iterations))


# one segment a line, and a few rows a segment: schedules the card's
# hundreds of thousands of resident threads do not reach at these shapes
@pytest.mark.parametrize("threads", [1, 96])
@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("name", ["corridor_1320", "odd_3x4x33", "random",
                                  "spiral"])
def test_kernel_schedule_model_matches_plain(name, iterations, threads):
    m = MASKS[name]
    assert torch.equal(packed_model(m, iterations, threads),
                       M._fill_holes(m, iterations))


def test_spiral_needs_every_round():
    """A kernel that flooded to completion would fail the spiral cases:
    one, two and three rounds give three different masks."""
    m = MASKS["spiral"]
    outs = [M._fill_holes(m, it) for it in (1, 2, 3)]
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[1], outs[2])


def test_cpu_tensor_takes_plain_route(monkeypatch):
    def refuse(*_):
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(kernels, "build", refuse)
    monkeypatch.setattr(kernels, "_lib", refuse)
    before = kernels.launches["fill_holes"]
    m = MASKS["random"]
    assert torch.equal(M.fill_holes(m, 1), M._fill_holes(m, 1))
    assert kernels.launches["fill_holes"] == before
