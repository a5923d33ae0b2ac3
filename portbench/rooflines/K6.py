"""K6, the column FFT of a split-complex pair (``csrc/fft.cu``: step A,
then the radix-2 stages), through ``ops.fft.fft_cols_split``.

Two float32 planes read once and two written once; step A's DFT_N2 at
the instructions the kernel shares among output pairs
(``dft_pair_masks``) and a twiddle a point, then ``k`` radix-2 stages
of an add/sub and a twiddle a point."""

from portbench.reference.ops import fft

WRAPPER = ("ops.fft", "fft_cols_split")
KERNELS = ("step_a_fwd", "step_a_inv", "radix2_kernel")

_DFT = {}


def dft_ops(N2: int) -> int:
    """Float instructions of one column's DFT_N2: output 0's terms at 8
    each, then for each pair of outputs and input 16 for two terms of
    their own, 10 for one shared term and 12 for shared products."""
    if N2 not in _DFT:
        ops = 8 * N2
        for m in fft.dft_pair_masks(N2, False):
            for j in range(1, N2 // 2 + 1):
                ops += (12 if m >> j & 1 else 10 if m >> (16 + j) & 1
                        else 16)
        _DFT[N2] = ops
    return _DFT[N2]


def record(args: dict, out) -> dict:
    N, L = args["xr"].shape
    return {"N": N, "L": L}


def work(rec: dict):
    N, L = rec["N"], rec["L"]
    _, N2, k = fft.plan(N)
    pts = float(N) * L
    return 16.0 * pts, pts * (dft_ops(N2) / N2 + 6.0) + pts * k * 8.0, 0.0
