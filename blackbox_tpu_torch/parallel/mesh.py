"""Device meshes for frame batches and frame tiles (port of
:mod:`blackbox_tpu.parallel.mesh`).

Two parallel axes, as in the JAX package:

* **batch (data) parallel**: a stack of frames split over the ``data``
  axis; each device reduces its frames one after another
  (:func:`make_batched_reduce`), so a frame's result is bit for bit the
  single-frame program's.
* **spatial (tile) parallel**: one mosaic split into column blocks over
  the ``tile`` axis for the stencil stages, each block padded with its
  neighbours' edge columns (:func:`halo_exchange_cols`).

A mesh is an (n_data, n_tile) grid of ``torch.device``s.  A device may
appear more than once (four tile shards on one card, eight on the CPU
in the tests): blocks on one device run one after another on its
stream, blocks on distinct devices overlap, each on its own stream.
Where the JAX package replicates a tile-sharded program over the data
axis, here the mesh's first row runs it, and the result is gathered
onto that row's first device.  Collectives become copies: an
``all_gather`` is a ``torch.cat`` onto one device, a ``ppermute`` a
``.to(device, non_blocking=True)`` of the neighbour's edge columns.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch

AXES = ("data", "tile")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (n_data, n_tile) grid of devices; ``shape`` maps each axis
    name to its size, as a JAX mesh's does."""

    devices: tuple          # n_data rows of n_tile torch.devices

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "tile": len(self.devices[0])}

    def axis_devices(self, axis_name: str) -> list:
        """The devices along one axis: the first column for ``data``,
        the first row for ``tile``."""
        if axis_name == "data":
            return [row[0] for row in self.devices]
        if axis_name == "tile":
            return list(self.devices[0])
        raise ValueError(f"mesh axis {axis_name!r} not in {AXES}")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: int, n_tile: int = 1, devices=None) -> Mesh:
    """An (n_data, n_tile) mesh over the first ``n_data * n_tile`` of
    ``devices`` (default: every visible CUDA device; an explicit list
    may repeat a device)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "to build a mesh elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = n_data * n_tile
    if n < 1 or len(devices) < n:
        raise ValueError(f"make_mesh: {n_data} x {n_tile} needs {n} "
                         f"devices, got {len(devices)}")
    return Mesh(tuple(tuple(devices[i * n_tile:(i + 1) * n_tile])
                      for i in range(n_data)))


# ---- column blocks --------------------------------------------------------

def split_cols(x: torch.Tensor, devices) -> list:
    """``x`` (H, W) as len(devices) equal column blocks, block i on
    devices[i]."""
    n = len(devices)
    W = x.shape[1]
    if W % n:
        raise ValueError(f"width {W} does not split into {n} column "
                         "blocks")
    w = W // n
    return [x[:, i * w:(i + 1) * w].to(d).contiguous()
            for i, d in enumerate(devices)]


def join_cols(blocks, device) -> torch.Tensor:
    """The frame the column ``blocks`` make, on ``device`` (the
    ``all_gather``)."""
    return torch.cat([b.to(device, non_blocking=True) for b in blocks],
                     dim=1)


def _neighbour_cols(blocks, halo: int, left_edge, right_edge) -> list:
    """Each block padded with ``halo`` columns of its neighbours; the
    outer blocks take ``left_edge(block)`` / ``right_edge(block)``."""
    n = len(blocks)
    if any(halo > b.shape[1] for b in blocks):
        raise ValueError(f"halo {halo} is wider than a column block")
    out = []
    for i, b in enumerate(blocks):
        left = (blocks[i - 1][:, -halo:].to(b.device, non_blocking=True)
                if i > 0 else left_edge(b))
        right = (blocks[i + 1][:, :halo].to(b.device, non_blocking=True)
                 if i < n - 1 else right_edge(b))
        out.append(torch.cat([left, b, right], dim=1))
    return out


def halo_exchange_cols(blocks, halo: int) -> list:
    """Pad each column block with ``halo`` columns from its neighbours:
    (H, W_local) -> (H, W_local + 2*halo).  The outermost blocks repeat
    their own border column (the single-device edge padding)."""
    return _neighbour_cols(blocks, halo,
                           lambda b: b[:, :1].expand(-1, halo),
                           lambda b: b[:, -1:].expand(-1, halo))


def sharded_stencil(fn, mesh: Mesh, halo: int, axis_name: str = "tile"):
    """Wrap ``fn(padded_block) -> block`` as a column-sharded stencil.

    ``fn`` receives a block padded by ``halo`` columns on both sides and
    returns the unpadded-width result.  The returned function takes an
    (H, W) frame and gives the frame of the results, on the axis's first
    device.
    """
    devs = mesh.axis_devices(axis_name)

    def run(img):
        blocks = halo_exchange_cols(split_cols(img, devs), halo)
        return join_cols([fn(b) for b in blocks], devs[0])

    return run


def lacosmic_sharded(data, inmask, rdnoise, mesh: Mesh, params=None,
                     halo: int = 32, axis_name: str = "tile"):
    """L.A.Cosmic over a column-sharded mosaic: each block runs the
    dense rounds with a ``halo``-column exchange and the border masks
    in frame coordinates.

    The chain's influence radius is 9 px a round (detection 7, clean
    2), so ``halo >= 9 * niter + 3`` columns make the result the
    single-device dense path's.  ``rdnoise`` is a scalar (a float or a
    0-d tensor), as the JAX package's closure takes it.  The fused
    kernel (``use_pallas``) and the windowed rounds are off here, as in
    the JAX package.  The plain masked clean launches the same kernels
    for every row strip whatever its width, so a block takes strips
    n_blocks times as tall: the blocks together launch what the whole
    frame would, and the values do not depend on the strips.  Returns
    (clean, crmask) on the axis's first device.
    """
    from blackbox_tpu_torch.ops.cosmics import LACosmicParams, lacosmic

    devs = mesh.axis_devices(axis_name)
    p = params or LACosmicParams()
    p = dataclasses.replace(p, windowed=False, use_pallas=False,
                            strip_rows=p.strip_rows * len(devs))
    need = 9 * p.niter + 3
    if halo < need:
        raise ValueError(f"halo {halo} < influence radius {need}")
    H, W_total = data.shape
    if inmask is None:
        inmask = torch.zeros((H, W_total), dtype=torch.bool,
                             device=data.device)
    blocks = halo_exchange_cols(split_cols(data, devs), halo)
    mblocks = halo_exchange_cols(split_cols(inmask, devs), halo)
    w = W_total // len(devs)
    cleans, crms = [], []
    for i, (b, m) in enumerate(zip(blocks, mblocks)):
        rd = rdnoise.to(b.device) if torch.is_tensor(rdnoise) else rdnoise
        with _on(b.device):
            # the padded block's first column in frame coordinates
            clean, crm, _ = lacosmic(b, m, rd, p,
                                     coords=(i * w - halo, W_total))
        cleans.append(clean[:, halo:-halo])
        crms.append(crm[:, halo:-halo])
    return join_cols(cleans, devs[0]), join_cols(crms, devs[0])


def median3x3_sharded(img, mesh: Mesh, axis_name: str = "tile"):
    """3x3 median filter over a column-sharded mosaic (halo = 1), with
    ``jnp.median``'s semantics (NaN if the window holds one)."""
    from blackbox_tpu_torch.ops.stats import median

    def stencil(padded):
        H, Wp = padded.shape
        pv = torch.cat([padded[:1], padded, padded[-1:]], dim=0)
        views = [pv[dy:dy + H, dx:dx + Wp - 2]
                 for dy in range(3) for dx in range(3)]
        return median(torch.stack(views, 0), axis=0)

    return sharded_stencil(stencil, mesh, halo=1, axis_name=axis_name)(img)


# ---- frame batches --------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(batch, mesh: Mesh) -> list:
    """Split a leading-batch pytree (tensors or arrays in tuples, lists,
    dicts) over the mesh's ``data`` axis: one pytree a data-axis
    device, holding its contiguous share of the batch, on it."""
    devs = mesh.axis_devices("data")
    leaves = []
    _tree_map(leaves.append, batch)
    B = leaves[0].shape[0]
    if B % len(devs):
        raise ValueError(f"batch of {B} does not split over {len(devs)} "
                         "data-axis devices")
    n = B // len(devs)
    return [_tree_map(lambda x, i=i, d=d: torch.as_tensor(
                x[i * n:(i + 1) * n]).to(d), batch)
            for i, d in enumerate(devs)]


def _on(device):
    """The CUDA device context of ``device`` (nothing for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def map_batch(per_frame, mesh: Mesh, batch, replicated=()) -> list:
    """``per_frame(*frame, *replicated)`` for every frame of ``batch``
    (a tuple of leading-batch tensors), the batch split over the mesh's
    ``data`` axis (:func:`shard_batch`) and ``replicated`` (tensors or
    None) copied to every device.  Each device runs its frames one after
    another, in order; distinct devices run in threads of their own, on
    their own streams.  Returns the per-frame results in batch order."""
    shards = shard_batch(tuple(batch), mesh)
    devs = mesh.axis_devices("data")
    work: dict = {}
    k = 0
    for dev, shard in zip(devs, shards):
        for j in range(shard[0].shape[0]):
            work.setdefault(dev, []).append(
                (k, tuple(x[j] for x in shard)))
            k += 1

    def run(dev):
        with _on(dev), torch.inference_mode():
            rep = _tree_map(lambda x: torch.as_tensor(x).to(dev),
                            tuple(replicated))
            done = [(i, per_frame(*frame, *rep)) for i, frame in work[dev]]
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            return done

    if len(work) == 1:
        results = [run(next(iter(work)))]
    else:
        with ThreadPoolExecutor(max_workers=len(work)) as ex:
            results = list(ex.map(run, list(work)))
    out = [None] * k
    for done in results:
        for i, r in done:
            out[i] = r
    return out


def make_batched_reduce(ctx, mesh: Mesh, with_catalog: bool = True):
    """Multi-frame reduce, the batch split over the mesh's ``data`` axis.

    Returns ``fn(chan (B, C, y, x), osv, osh, mbias=None, mflat=None,
    bpm=None, xtalk_coeffs=None, nonlin_coeffs=None) -> list`` of B
    per-frame dicts ``{"image", "mask", "stats", "cat", "ext"}``
    (``"cat"``, the extraction's stats and its whole output ``"ext"``,
    which ``process_file(device_override=...)`` takes, with
    ``with_catalog``), each on the
    device that reduced it and bit for bit the single-frame program's
    (:func:`blackbox_tpu_torch.pipeline.reduce.make_reduce_fn`).  The
    calibration arrays are copied to every device.  Under a process
    group (:func:`blackbox_tpu_torch.parallel.distributed.init_multihost`)
    the batch is split into one contiguous share a rank, each rank
    reduces its own share on its mesh, and the other ranks' frames are
    None in its list.
    """
    from blackbox_tpu_torch.parallel.distributed import process_rank
    from blackbox_tpu_torch.pipeline.reduce import (calibrate_detector,
                                                    extract_catalog)

    def one(chan, osv, osh, mbias, mflat, bpm, xt, nl):
        sci, mask_m, stats = calibrate_detector(ctx, chan, osv, osh, mbias,
                                                mflat, bpm, xt, nl)
        out = {"image": sci, "mask": mask_m, "stats": stats}
        if with_catalog:
            ext = extract_catalog(ctx, sci, mask_m)
            out["stats"] = {**stats, **ext["stats"]}
            out["cat"] = ext["cat"]
            out["ext"] = ext
        return out

    def fn(chan, osv, osh, mbias=None, mflat=None, bpm=None,
           xtalk_coeffs=None, nonlin_coeffs=None):
        B = chan.shape[0]
        rank, world = process_rank()
        if B % world:
            raise ValueError(f"batch of {B} does not split over {world} "
                             "ranks")
        lo, hi = rank * B // world, (rank + 1) * B // world
        mine = map_batch(one, mesh, (chan[lo:hi], osv[lo:hi], osh[lo:hi]),
                         (mbias, mflat, bpm, xtalk_coeffs, nonlin_coeffs))
        return [None] * lo + mine + [None] * (B - hi)

    return fn
