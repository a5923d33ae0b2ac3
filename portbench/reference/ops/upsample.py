"""Background-mesh upsample ``Wy @ mesh @ Wx.T`` (port of
:mod:`blackbox_tpu.pallas.upsample`, the TPU kernel ``_up_kernel``).

:func:`upsample_mesh` runs the CUDA kernel ``csrc/upsample.cu`` on the
card and its plain version :func:`_upsample_plain` on the CPU.  The
plain version is the kernel's arithmetic: both products accumulated in
ascending index order from zero, one rounded multiply and one rounded
add a term.  The kernel skips the terms whose weight is zero (outside
each row's :func:`weight_bands`) where the other factor is finite,
which changes at most the sign of a zero, so the two agree bit for bit
up to that sign.  Against a matmul (XLA's, or ``torch.matmul``) only
the order of the float32 sums differs.
"""

from __future__ import annotations

import torch



def _operands(meshes, Wy, Wx):
    dev = meshes[0].device

    def f32(x):
        # numpy weights may be read-only (cached): copy them over
        x = x if isinstance(x, torch.Tensor) else torch.tensor(x)
        return x.to(device=dev, dtype=torch.float32)

    m = (f32(meshes[0])[None] if len(meshes) == 1
         else torch.stack([f32(x) for x in meshes]))
    return m.contiguous(), f32(Wy), f32(Wx)


def _upsample_plain(meshes, Wy, Wx, out_shape):
    """Plain version of :func:`upsample_mesh`: whole-plane
    multiply-adds, one per term, in the kernel's index order."""
    m, wy, wx = _operands(meshes, Wy, Wx)
    H, W = out_shape
    outs = []
    for mesh in m:
        up = torch.zeros((H, mesh.shape[1]), dtype=torch.float32,
                         device=m.device)
        for i in range(mesh.shape[0]):
            up = up + wy[:, i, None] * mesh[i][None, :]
        out = torch.zeros((H, W), dtype=torch.float32, device=m.device)
        for j in range(mesh.shape[1]):
            out += up[:, j, None] * wx[None, :, j]
        outs.append(out)
    return tuple(outs)


def upsample_mesh(meshes, Wy, Wx, out_shape):
    """Evaluate ``Wy @ mesh @ Wx.T`` for each mesh.

    meshes    : tuple of (ny, nx) float32 meshes on one device
    Wy, Wx    : (H, ny) / (W, nx) Catmull-Rom weights (tensors or numpy)
    out_shape : (H, W)

    Returns a tuple of (H, W) float32 maps.  This copy takes the plain
    version on every device.
    """
    return _upsample_plain(meshes, Wy, Wx, out_shape)


def weight_bands(w: torch.Tensor) -> torch.Tensor:
    """(n, 2) int64 bands [lo, hi] of the nonzero entries of each row of
    an (n, m) weight matrix (a NaN counts as nonzero; a row of zeros
    gives lo = m, hi = -1): the rule by which the kernel limits its sums
    (``csrc/upsample.cu``), which finds the bands on the card itself.
    Summing only the band, in ascending order, gives the dense sum up to
    the sign of a zero wherever the other factor is finite."""
    nz = w != 0
    idx = torch.arange(w.shape[1], device=w.device)
    return torch.stack([torch.where(nz, idx, w.shape[1]).amin(1),
                        torch.where(nz, idx, -1).amax(1)], 1)
