"""TrailNet: U-Net satellite-trail segmentation, the ASTA equivalent (port
of :mod:`blackbox_tpu.models.trailnet`).

Binned image in, per-pixel trail probability out, mask by threshold and
area filtering: the JAX package's network (conv-conv-pool down,
transpose-conv skip-concat up) as ``torch.nn`` modules, computing NCHW
inside and keeping the JAX contract, tiles (B, H, W) in and logits
(B, H, W) out.  The convolutions are cuDNN's on the card (TF32 is off
for the package); the area filter's labels run through the label
propagation kernel (``csrc/labelprop.cu``).

Parameters are state dicts.  Submodules carry the flax module names
(``ConvBlock_0.Conv_0``, ``ConvTranspose_1``, ``Conv_0``), so a flax
parameter tree carries across path for path (:func:`from_jax_params`):
a Conv kernel (kh, kw, in, out) becomes (out, in, kh, kw); a
ConvTranspose kernel (kh, kw, in, out) becomes (in, out, kh, kw)
MIRRORED in both spatial axes, because flax's ``ConvTranspose``
(``transpose_kernel=False``) correlates the dilated input with the
kernel as stored, while ``conv_transpose2d`` is the adjoint of a
convolution and applies its kernel mirrored.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blackbox_tpu_torch.ops.stats import median


class ConvBlock(nn.Module):
    def __init__(self, cin: int, feats: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, feats, 3, padding=1)
        self.Conv_1 = nn.Conv2d(feats, feats, 3, padding=1)

    def forward(self, x):
        return F.relu(self.Conv_1(F.relu(self.Conv_0(x))))


class TrailUNet(nn.Module):
    """Small U-Net: logits of per-pixel trail probability.

    x : (B, H, W), H and W divisible by 2^(len(feats) - 1).
    Returns logits (B, H, W).
    """

    def __init__(self, feats: Sequence[int] = (16, 32, 64)):
        super().__init__()
        self.depth = len(feats) - 1
        cin = 1
        for i, f in enumerate(feats):            # encoder, then bottleneck
            self.add_module(f"ConvBlock_{i}", ConvBlock(cin, f))
            cin = f
        for j, f in enumerate(reversed(feats[:-1])):
            self.add_module(f"ConvTranspose_{j}",
                            nn.ConvTranspose2d(cin, f, 2, stride=2))
            self.add_module(f"ConvBlock_{len(feats) + j}",
                            ConvBlock(2 * f, f))
            cin = f
        self.Conv_0 = nn.Conv2d(cin, 1, 1)

    def forward(self, x):
        x = x[:, None]
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"ConvBlock_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = getattr(self, f"ConvBlock_{self.depth}")(x)
        for j, skip in enumerate(reversed(skips)):
            x = getattr(self, f"ConvTranspose_{j}")(x)
            x = torch.cat([x, skip], dim=1)
            x = getattr(self, f"ConvBlock_{self.depth + 1 + j}")(x)
        return self.Conv_0(x)[:, 0]


@dataclasses.dataclass
class TrailNetConfig:
    bin_factor: int = 4
    tile: int = 256              # inference tile size (binned pixels)
    threshold: float = 0.5
    min_area: int = 40           # binned pixels (ASTA area_threshold)


def _normalise(tiles):
    """Each (T, T) tile of ``tiles`` (B, T, T) to its clipped robust
    z-score / 25, medians as ``jnp.median`` takes them (the mean of the
    two middle values of the even count)."""
    flat = tiles.reshape(tiles.shape[0], -1)
    med = median(flat, axis=1)[:, None, None]
    mad = median(torch.abs(tiles - med).reshape(flat.shape),
                 axis=1)[:, None, None] * 1.4826 + 1e-6
    return torch.clamp((tiles - med) / mad, -5.0, 25.0) / 25.0


def model_from(params, device) -> TrailUNet:
    """A TrailUNet on ``device`` holding the state dict ``params``."""
    model = TrailUNet().to(device)
    model.load_state_dict(params)
    return model.eval()


def trail_probability(params, image, cfg: TrailNetConfig = TrailNetConfig()):
    """The U-Net's trail probability of each binned pixel, (Hb, Wb):
    the image binned, cut into normalised tiles, run as one batch on
    the image's device."""
    from blackbox_tpu_torch.ops.satdet import _bin2d

    B = _bin2d(image, cfg.bin_factor)
    Hb, Wb = B.shape
    T = cfg.tile
    ny = -(-Hb // T)
    nx = -(-Wb // T)
    Bp = F.pad(B, (0, nx * T - Wb, 0, ny * T - Hb))
    tiles = Bp.reshape(ny, T, nx, T).permute(0, 2, 1, 3).reshape(
        ny * nx, T, T)
    with torch.no_grad():
        logits = model_from(params, image.device)(_normalise(tiles))
    prob = torch.sigmoid(logits)
    return prob.reshape(ny, nx, T, T).permute(0, 2, 1, 3).reshape(
        ny * T, nx * T)[:Hb, :Wb]


def area_filter(binmask, min_area: int):
    """``binmask`` without its 8-connected components of fewer than
    ``min_area`` pixels, labelled by bounded min-label propagation (64
    steps, as ASTA's area_threshold runs in the JAX package: a blob
    longer than that splits into fragments each far above min_area)."""
    from blackbox_tpu_torch.ops.labeling import label_components
    lab = label_components(binmask, iters=64).reshape(-1).long()
    areas = torch.zeros(binmask.numel() + 2, dtype=torch.int32,
                        device=binmask.device).index_add_(
        0, lab, binmask.reshape(-1).to(torch.int32))
    return binmask & (areas[lab] >= min_area).reshape(binmask.shape)


def segment_trails(params, image, cfg: TrailNetConfig = TrailNetConfig()):
    """Full-frame trail mask via tiled U-Net inference.

    image : (H, W) calibrated frame; the network runs on its device.
    Returns (mask bool (H, W), n_pix: the binned pixels masked).
    """
    binmask = trail_probability(params, image, cfg) > cfg.threshold
    if cfg.min_area > 1:
        binmask = area_filter(binmask, cfg.min_area)
    # unbin with kron-style expansion (reference np.kron)
    f = cfg.bin_factor
    big = binmask.repeat_interleave(f, 0).repeat_interleave(f, 1)
    H, W = image.shape
    out = torch.zeros((H, W), dtype=torch.bool, device=image.device)
    h, w = min(H, big.shape[0]), min(W, big.shape[1])
    out[:h, :w] = big[:h, :w]
    return out, torch.sum(binmask)


# ----------------------------------------------------- parameters

def _lecun_init(model: nn.Module, generator: torch.Generator) -> dict:
    """The model's state dict drawn as flax draws it: every kernel from
    a normal of variance 1/fan_in, every bias zero."""
    state = {}
    for name, p in model.state_dict().items():
        if name.endswith("bias"):
            state[name] = torch.zeros_like(p)
            continue
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        fan_in = (p.shape[1] if isinstance(mod, nn.Linear)
                  else p[:1].numel() if isinstance(mod, nn.Conv2d)
                  else p.shape[0] * p[0, 0].numel())   # ConvTranspose2d
        state[name] = torch.randn(p.shape, generator=generator) \
            / np.sqrt(fan_in)
    return state


def init_params(generator: torch.Generator) -> dict:
    """Random U-Net parameters (a state dict on the CPU)."""
    return _lecun_init(TrailUNet(), generator)


def _layer_kind(name: str) -> str:
    if name.startswith("ConvTranspose"):
        return "transpose"
    return "dense" if name.startswith("Dense") else "conv"


def _kernel_to_torch(kind: str, k: np.ndarray) -> np.ndarray:
    if kind == "dense":                          # (in, out) -> (out, in)
        return k.T
    if kind == "transpose":                      # mirrored, (in, out, kh, kw)
        return k[::-1, ::-1].transpose(2, 3, 0, 1)
    return k.transpose(3, 2, 0, 1)               # (out, in, kh, kw)


def _kernel_shape_flax(kind: str, shape) -> tuple:
    if kind == "dense":
        return (shape[1], shape[0])
    if kind == "transpose":
        return (shape[2], shape[3], shape[0], shape[1])
    return (shape[2], shape[3], shape[1], shape[0])


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _state_from_flat(flat: dict) -> dict:
    state = {}
    for path, leaf in flat.items():
        a = np.array(leaf, np.float32)
        key = ".".join(path[:-1])
        if path[-1] == "kernel":
            a = _kernel_to_torch(_layer_kind(path[-2]), a)
            state[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(a))
        else:
            state[key + ".bias"] = torch.from_numpy(a)
    return state


def from_jax_params(params) -> dict:
    """A flax parameter tree (``{"params": {...}}`` or its inside, leaves
    as arrays) as this package's state dict: the weight carrier between
    the two packages."""
    tree = params["params"] if "params" in params else params
    return _state_from_flat(dict(_flatten(tree)))


def _flax_template(model: nn.Module) -> dict:
    """{flax key path: zeros of the flax shape} of the model's
    parameters: flax initialises biases to zero."""
    out = {}
    for name, p in model.state_dict().items():
        parts = tuple(name.split("."))
        if parts[-1] == "bias":
            out[parts[:-1] + ("bias",)] = np.zeros(p.shape, np.float32)
        else:
            shape = _kernel_shape_flax(_layer_kind(parts[-2]), p.shape)
            out[parts[:-1] + ("kernel",)] = np.zeros(shape, np.float32)
    return out


def convert_keras_weights(h5_path: str) -> dict:
    """Port a keras U-Net weight file (the production ASTA model) onto
    TrailUNet, as the JAX package ports it onto its flax model: keras
    Conv2D kernels (kh, kw, in, out) are taken as they are,
    Conv2DTranspose kernels (kh, kw, OUT, IN) get their channel axes
    swapped, each assigned to the flax layer of the same topological
    rank with strict shape checks, and the flax tree carried across by
    :func:`from_jax_params`.  The transposed kernels are not mirrored,
    as in the JAX package: a keras transposed convolution applies its
    kernel mirrored relative to flax's, so the result reproduces the JAX
    package's network, not keras's.  The file is read by the port's own
    HDF5 reader (:mod:`blackbox_tpu_torch.io.hdf5`), so no ``h5py`` is
    needed; a format it does not read raises ``ValueError``.
    """
    from blackbox_tpu_torch.io import hdf5

    flat = _flax_template(TrailUNet())
    ours = sorted(flat.keys(), key=lambda kp: _layer_order(kp))

    kio = []
    f = hdf5.open(h5_path)
    root = f["model_weights"] if "model_weights" in f else f
    names = list(root.attrs.get("layer_names", [])) or list(root)
    for name in names:
        name = name.decode() if isinstance(name, bytes) else name
        if name not in root:
            continue
        grp = root[name]
        ds = {}
        grp.visititems(
            lambda p, obj: ds.__setitem__(p.rsplit("/", 1)[-1], obj)
            if hasattr(obj, "shape") else None)
        if "kernel:0" in ds:
            b = ds.get("bias:0")
            kio.append((name, np.array(ds["kernel:0"]),
                        np.array(b) if b is not None else None))

    kernels = [kp for kp in ours if kp[-1] == "kernel"]
    if len(kio) != len(kernels):
        raise ValueError(
            f"keras model has {len(kio)} weighted layers; TrailUNet "
            f"has {len(kernels)} — topology mismatch")
    out = dict(flat)
    for kp, (name, kern, bias) in zip(kernels, kio):
        want = flat[kp].shape
        if kern.shape != want:
            swapped = np.swapaxes(kern, -1, -2)
            if "transpose" in name.lower() and swapped.shape == want:
                kern = swapped        # keras Conv2DTranspose (.., out, in)
            else:
                raise ValueError(
                    f"layer {name}: kernel {kern.shape} != {want}")
        out[kp] = np.asarray(kern, np.float32)
        bkey = kp[:-1] + ("bias",)
        if bias is not None and bkey in flat:
            if bias.shape != flat[bkey].shape:
                raise ValueError(
                    f"layer {name}: bias {bias.shape} != "
                    f"{flat[bkey].shape}")
            out[bkey] = np.asarray(bias, np.float32)
    return _state_from_flat(out)


def _layer_order(key_path) -> tuple:
    """Topological sort key for TrailUNet parameter paths."""
    def num(s, pre):
        try:
            return int(s.replace(pre, "") or 0)
        except ValueError:
            return 0

    parts = [str(p) for p in key_path]
    # encoder ConvBlock_0..1, bottleneck ConvBlock_2, decoder pairs
    # (ConvTranspose_i interleaved with ConvBlock_3..), final Conv_0
    rank = []
    for p in parts:
        if p.startswith("ConvBlock_"):
            i = num(p, "ConvBlock_")
            rank.append(2 * i if i <= 2 else 5 + 2 * (i - 3) + 1)
        elif p.startswith("ConvTranspose_"):
            rank.append(5 + 2 * num(p, "ConvTranspose_"))
        elif p.startswith("Conv_") and "Block" not in p:
            rank.append(100 + num(p, "Conv_"))
    return (tuple(rank), parts[-2] if len(parts) > 1 else "",
            parts[-1])


def _kernel_to_flax(kind: str, w: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_kernel_to_torch`."""
    if kind == "dense":
        return w.T
    if kind == "transpose":
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    return w.transpose(2, 3, 1, 0)


def to_jax_params(params: dict) -> dict:
    """The inverse of :func:`from_jax_params`: a state dict as the flax
    tree ``{"params": {...}}``, float32 numpy leaves, kernels in flax's
    layout (transposed kernels mirrored back), every map's keys sorted
    as ``jax.tree_util`` leaves a tree."""
    tree: dict = {}
    for name, v in params.items():
        parts = name.split(".")
        a = v.detach().cpu().numpy().astype(np.float32)
        if parts[-1] == "weight":
            a = _kernel_to_flax(_layer_kind(parts[-2]), a)
            parts[-1] = "kernel"
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(a)

    def ordered(d):
        return {k: ordered(d[k]) if isinstance(d[k], dict) else d[k]
                for k in sorted(d)}
    return {"params": ordered(tree)}


def write_params(path: str, params: dict, model: nn.Module) -> None:
    """``params`` (a state dict of ``model``) as the flax msgpack file
    the JAX package's ``save_params`` writes and its ``load_params``
    reads (:mod:`blackbox_tpu_torch.io.flaxmsgpack`)."""
    from blackbox_tpu_torch.io import flaxmsgpack
    want = {k: tuple(p.shape) for k, p in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != want:
        raise ValueError(f"not a {type(model).__name__} state dict: "
                         f"{sorted(set(got.items()) ^ set(want.items()))} "
                         f"differ from its keys and shapes")
    with open(path, "wb") as fh:
        fh.write(flaxmsgpack.encode(to_jax_params(params)))


def read_params(path: str, model: nn.Module) -> dict:
    """A state dict of ``model`` from ``path``: a flax msgpack file (as
    the JAX package's ``save_params`` and :func:`write_params` write
    it), its leaves held to ``model``'s flax template (every key
    present, none extra, shapes equal) and carried across by
    :func:`from_jax_params`; or a zip, a state dict that ``torch.save``
    wrote (the port's files before it wrote flax's format)."""
    from blackbox_tpu_torch.io import flaxmsgpack
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] == b"PK\x03\x04":
        return torch.load(path, map_location="cpu", weights_only=True)
    if not data or not (0x80 <= data[0] <= 0x8F or data[0] in (0xDE, 0xDF)):
        raise ValueError(f"{path}: neither a flax msgpack map nor a torch "
                         f"zip file")
    tree = flaxmsgpack.decode(data)
    if list(tree) != ["params"] or not isinstance(tree["params"], dict):
        raise ValueError(f"{path}: top-level keys {list(tree)}, expected "
                         f"['params']")
    flat = dict(_flatten(tree["params"]))
    template = _flax_template(model)
    if flat.keys() != template.keys():
        raise ValueError(
            f"{path}: not a {type(model).__name__}: missing "
            f"{sorted('/'.join(k) for k in template.keys() - flat.keys())}, "
            f"extra {sorted('/'.join(k) for k in flat.keys() - template.keys())}")
    for k, want in template.items():
        leaf = flat[k]
        if not isinstance(leaf, np.ndarray) or leaf.shape != want.shape:
            raise ValueError(
                f"{path}: {'/'.join(k)} is "
                f"{getattr(leaf, 'shape', type(leaf).__name__)}, "
                f"expected {want.shape}")
    state = _state_from_flat(flat)
    return {k: state[k] for k in model.state_dict()}


def save_params(path: str, params):
    """U-Net parameters (a state dict) as the JAX package's flax file."""
    write_params(path, params, TrailUNet())


def load_params(path: str) -> dict:
    """U-Net parameters from a file either package's ``save_params``
    wrote (:func:`read_params`)."""
    return read_params(path, TrailUNet())


# --------------------------------------------------------- training

def synth_batch(rng: np.random.Generator, n: int, size: int = 256,
                p_trail: float = 0.7):
    """Synthetic binned tiles + trail masks for self-training."""
    from blackbox_tpu_torch.synth.generator import star_image

    xs = np.zeros((n, size, size), np.float32)
    ys = np.zeros((n, size, size), np.float32)
    for i in range(n):
        img = rng.normal(0.0, 1.0, (size, size)).astype(np.float32)
        nst = rng.integers(3, 25)
        st = np.stack([rng.uniform(5, size - 5, nst),
                       rng.uniform(5, size - 5, nst),
                       np.exp(rng.uniform(np.log(30), np.log(3000), nst)),
                       rng.uniform(0.8, 1.5, nst)], 1)
        img += star_image((size, size), st).astype(np.float32)
        if rng.random() < p_trail:
            x0, y0 = rng.uniform(0, size, 2)
            ang = rng.uniform(0, np.pi)
            amp = rng.uniform(2.0, 15.0)
            width = rng.uniform(0.6, 2.0)
            yy, xx = np.mgrid[0:size, 0:size]
            d = np.abs(np.cos(ang) * (yy - y0) - np.sin(ang) * (xx - x0))
            img += amp * np.exp(-0.5 * (d / width) ** 2)
            ys[i] = (d < 2.0 * width).astype(np.float32)
        xs[i] = img
    return xs, ys


def fit(model: nn.Module, params: dict, batches, steps: int, lr: float,
        norm, device, log_every: int, tag: str) -> dict:
    """Adam on the mean binary cross-entropy of ``model`` (moved to
    ``device``, starting from ``params``) over ``steps`` batches drawn
    by ``batches()`` as numpy (x, y); returns the state dict on the
    CPU."""
    model = model.to(device)
    model.load_state_dict(params)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for i in range(steps):
        x, y = batches()
        x = torch.from_numpy(x).to(device)
        y = torch.from_numpy(y).to(device)
        loss = F.binary_cross_entropy_with_logits(model(norm(x)), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if log_every and i % log_every == 0:
            print(f"{tag} step {i}: loss {float(loss.detach()):.4f}")
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def train(steps: int = 300, batch: int = 8, lr: float = 3e-4,
          seed: int = 0, size: int = 128, log_every: int = 50,
          device="cuda", generator: torch.Generator | None = None,
          params: dict | None = None) -> dict:
    """Self-contained training on synthetic trails; returns params.

    The batches come from ``np.random.default_rng(seed)``, as in the JAX
    package; the start is ``params``, or parameters drawn from
    ``generator`` (``torch.Generator().manual_seed(seed)`` if None).
    """
    rng = np.random.default_rng(seed)
    if params is None:
        params = init_params(generator if generator is not None
                             else torch.Generator().manual_seed(seed))
    return fit(TrailUNet(), params, lambda: synth_batch(rng, batch, size),
               steps, lr, _normalise, device, log_every, "trailnet")
