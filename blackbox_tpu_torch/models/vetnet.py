"""VetNet: real/bogus transient classification, the MeerCRAB equivalent
(port of :mod:`blackbox_tpu.models.vetnet`).

A small CNN over (N, S, S, 4) NEW/REF/D/SCORR cutout stacks returns
P(real), the ``CLASS_REAL`` column and the ``MC-P`` contract, with the
JAX package's synthetic training loop (real = PSF-shaped residual in
D/SCORR; bogus = cosmic spikes, dipoles from registration error, hot
columns, noise flukes).  The layers are ``torch.nn``'s, named as the
flax modules are, so a flax parameter tree carries across with
:func:`blackbox_tpu_torch.models.trailnet.from_jax_params`, and
:func:`save_params` / :func:`load_params` write and read the JAX
package's flax weight files.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blackbox_tpu_torch.models.trailnet import (  # noqa: F401
    _lecun_init, fit, from_jax_params, read_params, write_params)
from blackbox_tpu_torch.ops.stats import median


class VetNet(nn.Module):
    """Small CNN: (B, S, S, 4) cutouts -> logit of P(real)."""

    def __init__(self, feats: tuple = (16, 32, 64)):
        super().__init__()
        cin = 4
        for i, f in enumerate(feats):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, f, 3, padding=1))
            cin = f
        self.nconv = len(feats)
        self.Dense_0 = nn.Linear(cin, 32)
        self.Dense_1 = nn.Linear(32, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.nconv):
            x = F.max_pool2d(F.relu(getattr(self, f"Conv_{i}")(x)), 2)
        x = torch.mean(x, dim=(2, 3))              # global average pool
        return self.Dense_1(F.relu(self.Dense_0(x)))[:, 0]


STAMP = 32

# Default CLASS_REAL cut: the conventional MeerCRAB operating point
# (the JAX package's; its synthetic injection campaign cannot place an
# upper threshold).  The driver stores the full CLASS_REAL column, so
# consumers can always re-cut.
RECOMMENDED_THRESHOLD = 0.5


def _norm(c):
    """Each channel of each (N, S, S, C) stamp to its clipped robust
    z-score / 10, medians as ``jnp.median`` takes them."""
    N, S, S2, C = c.shape
    flat = c.permute(0, 3, 1, 2).reshape(N, C, S * S2)
    med = median(flat, axis=2)
    mad = median(torch.abs(flat - med[..., None]), axis=2) * 1.4826 + 1e-6
    med = med[:, None, None, :]
    mad = mad[:, None, None, :]
    return torch.clamp((c - med) / mad, -10.0, 10.0) / 10.0


def make_stamps(new_img, ref_img, D, scorr, xs, ys, stamp: int = STAMP):
    """(N, S, S, 4) normalised cutout stacks around candidates, each
    window's corner rounded and clipped into the frame."""
    H, W = D.shape
    dev = D.device
    half = stamp // 2
    xs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    ys = torch.as_tensor(ys, dtype=torch.float32, device=dev)
    x0 = torch.clamp(torch.round(xs).to(torch.int64) - half, 0, W - stamp)
    y0 = torch.clamp(torch.round(ys).to(torch.int64) - half, 0, H - stamp)
    ar = torch.arange(stamp, device=dev)
    iy = (y0[:, None] + ar)[:, :, None]
    ix = (x0[:, None] + ar)[:, None, :]
    return _norm(torch.stack([img[iy, ix]
                              for img in (new_img, ref_img, D, scorr)],
                             dim=-1))


def score_transients(params, new_img, ref_img, D, scorr, xs, ys,
                     stamp: int = STAMP):
    """P(real) per candidate — the MC-P column — on the maps' device."""
    stamps = make_stamps(new_img, ref_img, D, scorr, xs, ys, stamp)
    model = VetNet().to(D.device)
    model.load_state_dict(params)
    with torch.no_grad():
        return torch.sigmoid(model.eval()(stamps))


def init_params(generator: torch.Generator) -> dict:
    """Random VetNet parameters (a state dict on the CPU)."""
    return _lecun_init(VetNet(), generator)


def save_params(path: str, params):
    """VetNet parameters (a state dict) as the JAX package's flax file."""
    write_params(path, params, VetNet())


def load_params(path: str) -> dict:
    """VetNet parameters from a file either package's ``save_params``
    wrote, held to the VetNet template (Dense kernels in their own
    layout)."""
    return read_params(path, VetNet())


# ----------------------------------------------------------- training

def _gauss(size, x, y, fwhm, amp):
    s = fwhm / 2.355
    g = np.arange(size)
    return amp * np.exp(-0.5 * (((g[None, :] - x) / s) ** 2
                                + ((g[:, None] - y) / s) ** 2))


def synth_batch(rng: np.random.Generator, n: int, stamp: int = STAMP):
    """Synthetic (stamps, labels): real transients vs artefact classes."""
    X = np.zeros((n, stamp, stamp, 4), np.float32)
    y = np.zeros(n, np.float32)
    c = stamp / 2
    for i in range(n):
        fwhm = rng.uniform(2.2, 4.5)
        noise = lambda s=1.0: rng.normal(0, s, (stamp, stamp))  # noqa
        ref = noise() + _gauss(stamp, *rng.uniform(4, stamp - 4, 2),
                               fwhm, rng.uniform(0, 30))
        new = ref + noise()
        kind = rng.integers(0, 5)
        if kind == 0:                       # REAL: PSF-shaped in new+D
            amp = rng.uniform(6, 60)
            dx, dy = rng.uniform(-1, 1, 2)
            src = _gauss(stamp, c + dx, c + dy, fwhm, amp)
            new = new + src
            D = src + noise()
            S = src / max(amp, 1) * rng.uniform(6, 25) + noise()
            y[i] = 1.0
        elif kind == 1:                     # cosmic spike: 1-2 px, sharp
            D = noise()
            S = noise()
            xi, yi = rng.integers(stamp // 2 - 2, stamp // 2 + 3, 2)
            for img in (new, D, S):
                img[yi, xi] += rng.uniform(20, 200)
        elif kind == 2:                     # dipole (registration error)
            amp = rng.uniform(10, 60)
            off = rng.uniform(0.6, 1.6)
            pos = _gauss(stamp, c - off, c, fwhm, amp)
            neg = _gauss(stamp, c + off, c, fwhm, amp)
            D = pos - neg + noise()
            S = (pos - neg) / 3.0 + noise()
            new = new + pos - neg
        elif kind == 3:                     # hot column / streak
            D = noise()
            S = noise()
            col = rng.integers(stamp // 2 - 2, stamp // 2 + 3)
            for img in (new, D, S):
                img[:, col] += rng.uniform(5, 40)
        else:                               # pure noise fluke
            D = noise()
            S = noise()
            S[stamp // 2, stamp // 2] += rng.uniform(5, 8)
        X[i, :, :, 0] = new
        X[i, :, :, 1] = ref
        X[i, :, :, 2] = D
        X[i, :, :, 3] = S
    return X, y


def train(steps: int = 400, batch: int = 32, lr: float = 1e-3,
          seed: int = 0, stamp: int = STAMP, log_every: int = 100,
          device="cuda", generator: torch.Generator | None = None,
          params: dict | None = None) -> dict:
    """Synthetic real/bogus training; returns params.

    The batches come from ``np.random.default_rng(seed)``, as in the JAX
    package; the start is ``params``, or parameters drawn from
    ``generator`` (``torch.Generator().manual_seed(seed)`` if None).
    """
    rng = np.random.default_rng(seed)
    if params is None:
        params = init_params(generator if generator is not None
                             else torch.Generator().manual_seed(seed))
    return fit(VetNet(), params, lambda: synth_batch(rng, batch, stamp),
               steps, lr, _norm, device, log_every, "vetnet")

