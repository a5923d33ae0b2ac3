"""PSF model (de)serialisation in the PSFEx `_psf.fits` spirit.

The reference reads PSFEx models back from disk for co-add clipping and
PSF-star work (reference buildref.py:3328-3366, zogy get_psf_ima);
our :class:`PSFModel` ships the same information — polynomial basis
images + poldeg/polzero/polscal sampling — as one image extension plus
keywords, so any consumer can reconstruct the spatially-varying PSF.
"""

from __future__ import annotations

import numpy as np

from blackbox_tpu_torch.io.fits import Header, read_fits, write_image
from blackbox_tpu_torch.ops.psf import PSFModel


def psf_to_hdu(model: PSFModel):
    h = Header()
    h["POLDEG"] = (int(model.poldeg), "spatial polynomial degree")
    h["POLZERO1"] = (float(model.polzero_x), "x zero point")
    h["POLZERO2"] = (float(model.polzero_y), "y zero point")
    h["POLSCAL1"] = (float(model.polscal_x), "x scale")
    h["POLSCAL2"] = (float(model.polscal_y), "y scale")
    h["PSFSTARS"] = (int(model.nstars), "stars used in fit")
    h["PSFCHI2"] = (round(float(model.chi2), 4), "median reduced chi2")
    h["EXTNAME"] = ("PSF_DATA", "")
    # the model's tensors may lie on the card
    return model.basis.detach().cpu().numpy().astype(np.float32), h


def write_psf(path: str, model: PSFModel, header: Header | None = None):
    basis, h = psf_to_hdu(model)
    write_image(path, None, header or Header(),
                extensions=[("image", basis, h)])


def read_psf(path: str, device="cuda") -> PSFModel:
    """The model in ``path`` with its tensors on ``device`` (the card
    unless the caller asks for another)."""
    import torch

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    for data, h in read_fits(path):
        if h.get("EXTNAME", "").strip() == "PSF_DATA":
            return PSFModel(
                basis=torch.as_tensor(np.asarray(data, np.float32),
                                      device=device),
                polzero_x=f32(h["POLZERO1"]),
                polzero_y=f32(h["POLZERO2"]),
                polscal_x=f32(h["POLSCAL1"]),
                polscal_y=f32(h["POLSCAL2"]),
                poldeg=int(h["POLDEG"]),
                nstars=torch.tensor(int(h["PSFSTARS"]), dtype=torch.int32,
                                    device=device),
                chi2=f32(h["PSFCHI2"]))
    raise ValueError(f"{path}: no PSF_DATA extension")
