"""Per-channel gain correction, ADU -> e- (port of
:mod:`blackbox_tpu.ops.gain`)."""

from __future__ import annotations

import torch


def gain_correct(chan_data, os_vert, os_hori, gains):
    """Multiply the three channel stacks by the per-channel gains (C,)."""
    g = torch.as_tensor(gains, dtype=chan_data.dtype,
                        device=chan_data.device)[:, None, None]
    return chan_data * g, os_vert * g, os_hori * g
