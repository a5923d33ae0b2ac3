"""The stack-median kernel's networks (K9, ``csrc/stackmedian.cu``) and
the route that ``ops.stats.median`` takes to it, on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py -k
stack_median`` holds it to the sort route there).  Here a small
interpreter runs the comparator program of ``filters.stack_median_ops``,
which ``csrc/stack_median_networks.cuh`` writes out, with the kernel's
NaN flag and its rounding of ``(lo + hi) * 0.5``, and holds it to the
order statistics and to ``jnp.median`` bit for bit."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from blackbox_tpu_torch import kernels  # noqa: E402
from blackbox_tpu_torch.ops import filters, stats  # noqa: E402

MAX_N = filters.STACK_MEDIAN_MAX


def run_program(ops, cols):
    """The comparator program on the rows of ``cols`` ((n, M) numpy):
    min and max as the kernel's bbt_min / bbt_max (NaN if either input
    is NaN)."""
    v = [row.copy() for row in cols]
    for kind, a, b in ops:
        if kind == "ce":
            v[a], v[b] = np.minimum(v[a], v[b]), np.maximum(v[a], v[b])
        elif kind == "min":
            v[a] = np.minimum(v[a], v[b])
        elif kind == "max":
            v[b] = np.maximum(v[a], v[b])
        else:
            raise AssertionError(f"unexpected op {kind}")
    return v


def kernel_median(cols):
    """What K9 writes for each column of the float32 (n, M) ``cols``."""
    ops, (lo, hi) = filters.stack_median_ops(cols.shape[0])
    v = run_program(ops, cols)
    with np.errstate(over="ignore", invalid="ignore"):
        mid = (v[lo] + v[hi]) * np.float32(0.5)
    return np.where(np.isnan(cols).any(axis=0), np.float32(np.nan), mid)


def test_stack_median_header_is_generated():
    """csrc/stack_median_networks.cuh is stack_median_source() verbatim
    (regenerate it from that function after a network change)."""
    import blackbox_tpu_torch
    path = os.path.join(os.path.dirname(blackbox_tpu_torch.__file__),
                        "csrc", "stack_median_networks.cuh")
    with open(path) as f:
        assert f.read() == filters.stack_median_source()


@pytest.mark.parametrize("n", range(1, 21))
def test_network_selects_middle_ranks_on_zero_one_inputs(n):
    """Every 0-1 column of n values: the two output wires hold ranks
    (n-1)//2 and n//2 (by the 0-1 principle, then on every input)."""
    ops, (lo, hi) = filters.stack_median_ops(n)
    bits = ((np.arange(2 ** n)[None, :] >> np.arange(n)[:, None]) & 1)
    cols = bits.astype(np.uint8)
    v = run_program(ops, cols)
    ones = cols.sum(axis=0)
    # rank r of the sorted column is 1 exactly where n - ones <= r
    assert np.array_equal(v[lo], (n - ones <= (n - 1) // 2).astype(cols.dtype))
    assert np.array_equal(v[hi], (n - ones <= n // 2).astype(cols.dtype))


def _columns(n, case, rng, m=301):
    x = rng.normal(100.0, 20.0, (n, m)).astype(np.float32)
    if case == "tied":
        x = rng.integers(-2, 3, (n, m)).astype(np.float32)
        x[:, :10] = 7.0                           # columns of one value
    elif case == "inf":
        hit = rng.random((n, m)) < 0.2
        x = np.where(hit, np.where(rng.random((n, m)) < 0.5, -np.inf,
                                   np.inf), x).astype(np.float32)
        x[:, :5] = np.inf
        x[:, 5:10] = -np.inf
        x[: n // 2, 10:15] = -np.inf              # -inf against +inf
        x[n // 2:, 10:15] = np.inf
    elif case == "huge":
        big = np.finfo(np.float32).max
        x = (big * rng.uniform(0.9, 1.0, (n, m))).astype(np.float32)
        x[:, :10] = big                           # odd n: lo + hi is inf
        x[:, 10:20] *= -1
    elif case == "nan":
        x[rng.random((n, m)) < 0.02] = np.nan
        x[0, :5] = np.nan                         # NaN in one frame
        x[:, 5:10] = np.nan                       # NaN in every frame
    return x


CASES = ["random", "tied", "inf", "huge", "nan"]


def _same_bits(got, want):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32),
                          want[~nan].view(np.int32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", range(1, MAX_N + 1))
def test_network_median_is_jnp_median(n, case):
    """The kernel's arithmetic on random, tied, infinite, huge and NaN
    columns: the two middle order statistics, and jnp.median's bits
    (and the sort route's), NaN where a column holds one."""
    rng = np.random.default_rng(1000 * n + CASES.index(case))
    x = _columns(n, case, rng)
    ops, (lo, hi) = filters.stack_median_ops(n)
    v = run_program(ops, x)
    xs = np.sort(x, axis=0)                       # NaN sorts last
    ok = ~np.isnan(x).any(axis=0)
    assert np.array_equal(v[lo][ok], xs[(n - 1) // 2][ok])
    assert np.array_equal(v[hi][ok], xs[n // 2][ok])
    got = kernel_median(x)
    _same_bits(got, np.asarray(jnp.median(jnp.asarray(x), axis=0)))
    _same_bits(got, stats.median(torch.from_numpy(x), axis=0).numpy())
    if case == "nan":
        assert np.isnan(got[:10]).all()
    if case == "huge" and n % 2:
        assert np.isposinf(got[:10]).all()


def test_network_costs():
    """Pruned to the two middle ranks, the networks stay below a full
    odd-even merge sort, and at the masters' depths (15, 20) below the
    counts the kernel's design assumes."""
    for n in range(2, MAX_N + 1):
        pairs: list = []
        filters._oe_sort(list(range(n)), pairs)
        ops, _ = filters.stack_median_ops(n)
        assert filters.comparator_cost(ops) <= 2 * len(pairs), n
    assert filters.comparator_cost(filters.stack_median_ops(15)[0]) == 84
    assert filters.comparator_cost(filters.stack_median_ops(20)[0]) == 128


def test_route_rule():
    """The kernel takes a CUDA float32 stack reduced along axis 0 of
    1 .. 32; the sort takes everything else, CPU tensors included."""
    f32 = torch.float32
    for shape in ((20, 16, 5280, 1320), (15, 16, 5280, 1320), (9, 41, 41),
                  (1, 7), (32,)):
        assert stats.stack_route("cuda", f32, shape, 0) == "kernel", shape
    sort = [("cpu", f32, (20, 100), 0),           # a CPU tensor
            ("cuda", f32, (20, 100), None),       # over all elements
            ("cuda", f32, (20, 100), 1),          # another axis
            ("cuda", f32, (20, 100), -2),
            ("cuda", f32, (33, 100), 0),          # a long axis
            ("cuda", torch.float64, (20, 100), 0),
            ("cuda", torch.bfloat16, (20, 100), 0),
            ("cuda", f32, (0, 100), 0),           # empty
            ("cuda", f32, (20, 0), 0),
            ("cuda", f32, (2, 2 ** 31), 0),       # past the launcher's int
            ("meta", f32, (20, 100), 0)]
    for args in sort:
        assert stats.stack_route(*args) == "sort", args
    x = torch.zeros((20, 5))
    assert stats.median_route(x, 0) == "sort"
    before = kernels.launches["stack_median"]
    assert torch.equal(stats.median(x, axis=0), torch.zeros(5))
    assert kernels.launches["stack_median"] == before


def test_stack_median_span_names_route():
    """The master.median span carries the route and the depth."""
    from blackbox_tpu_torch.pipeline import masters
    from blackbox_tpu_torch.utils import timing
    cube = torch.randn((5, 2, 3, 4))
    with timing.recording(cuda=False) as rec:
        got = masters.stack_median(cube)
        spans, _ = rec.drain()
    assert torch.equal(got, stats.median(cube, axis=0))
    spans = [s for s in spans if s.name == "master.median"]
    assert [(s.attrs["route"], s.attrs["N"]) for s in spans] == [("sort", 5)]

