"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W), and the
least time of a piece of work against them.

NVIDIA's H100 data sheet and Hopper white paper: 3.35 TB/s of HBM3;
128 float32 lanes an SM at the boost clock, so 33.5e12 float32
instructions a second (the sheet's 67 TFLOP/s counts an FMA as two
flops; a min, a max, a multiply or an add is one instruction); 64 int32
lanes an SM, 16.75e12 int32 instructions a second.  A card set below
700 W runs slower under load: the harness prints the card's power limit
beside its numbers.
"""

HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 33.5e12
I32_INSTR_PER_S = 16.75e12


def least_s(nbytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0):
    """(seconds, what bounds them): the larger of the bytes moved at the
    HBM rate and the operations at their instruction rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_INSTR_PER_S + i32_ops / I32_INSTR_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
