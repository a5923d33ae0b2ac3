"""Initial mask construction: bad pixels, saturation, crosstalk victims
(port of :mod:`blackbox_tpu.ops.masking`).

* non-finite pixels -> zeroed and flagged ``bad``;
* per-channel saturation threshold ``satlevel_adu * gain - BIASM`` [e-];
* crosstalk victims: each source channel's saturation footprint is
  stamped into all other channels, y-flipped across readout rows;
* saturated-connected pixels by one 3x3 dilation, then closing + hole
  fill of the combined blob.
"""

from __future__ import annotations

import torch

from blackbox_tpu_torch.core import maskbits
from blackbox_tpu_torch.ops.morphology import satcon_close_fill


def build_mask(chan_data, bpm, satlevel_adu, gains, biasm, nx: int = 8,
               fill_iters: int = 1):
    """Build the initial uint8 mask stack and clean the data stack.

    chan_data   : (C, ych, xch) calibrated data [e-]
    bpm         : (C, ych, xch) uint8 static bad-pixel mask or None
    satlevel_adu: (C,) raw-ADU saturation levels
    gains       : (C,) e-/ADU
    biasm       : (C,) mean vertical-overscan level [e-] (BIASM1..16)

    Returns (chan_data, mask, stats); stats carries SATLEV1..16, the mean
    SATURATE level, the saturated-pixel mask and N-INFNAN.
    """
    dev = chan_data.device
    if bpm is None:
        mask = torch.zeros(chan_data.shape, dtype=torch.uint8, device=dev)
    else:
        mask = torch.as_tensor(bpm, device=dev).to(torch.uint8)

    nonfinite = ~torch.isfinite(chan_data)
    chan_data = torch.where(nonfinite, 0.0, chan_data)
    mask = torch.where(nonfinite & (mask == 0), mask | maskbits.BAD, mask)

    satlevel_e = (torch.as_tensor(satlevel_adu, dtype=torch.float32,
                                  device=dev)
                  * torch.as_tensor(gains, dtype=torch.float32, device=dev)
                  - biasm)                                        # (C,)
    mask_sat = chan_data >= satlevel_e[:, None, None]

    # crosstalk victims: a channel is a victim where any OTHER channel
    # of its row saturates, or any channel of the other row does
    # (y-flipped: the two rows read out in mirror)
    bot, top = mask_sat[:nx], mask_sat[nx:]
    any_bot_fl = torch.any(bot.flip(1), dim=0)
    any_top_fl = torch.any(top.flip(1), dim=0)
    victims = torch.cat([_union_excl_self(bot) | any_top_fl[None],
                         _union_excl_self(top) | any_bot_fl[None]], dim=0)
    mask = torch.where(victims, mask | maskbits.CROSSTALK, mask)
    mask = torch.where(mask_sat, mask | maskbits.SATURATED, mask)

    satcon_add, filled = satcon_close_fill(mask_sat, fill_iters)
    mask = torch.where(satcon_add, mask | maskbits.SAT_CONNECTED, mask)
    mask = torch.where(filled & (mask == 0),
                       torch.tensor(maskbits.SAT_CONNECTED,
                                    dtype=torch.uint8, device=dev), mask)

    stats = {
        "satlev": satlevel_e,                 # (C,) SATLEV1..16 [e-]
        "saturate": torch.mean(satlevel_e),   # SATURATE
        "mask_sat": mask_sat,                 # for NOBJ-SAT counting
        "n_infnan": torch.sum(nonfinite, dtype=torch.int32),  # N-INFNAN
    }
    return chan_data, mask, stats


def _union_excl_self(stack):
    """OR over the leading axis, excluding each element itself."""
    cnt = torch.sum(stack, dim=0, dtype=torch.int32)
    return (cnt - stack.to(torch.int32)) > 0
