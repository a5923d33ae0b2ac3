"""Multi-process initialisation (port of
:mod:`blackbox_tpu.parallel.distributed`).

The JAX package forms its process group with ``jax.distributed``; here
it is a ``torch.distributed`` group: gloo carries CPU tensors and, where
CUDA and NCCL are present, NCCL carries CUDA ones.  Arguments default
to the SLURM environment, as in the JAX package, so the cluster
adapter's sbatch scripts need no extra plumbing.  Under a group,
:func:`blackbox_tpu_torch.parallel.mesh.make_batched_reduce` gives each
rank its own share of a batch.
"""

from __future__ import annotations

import logging
import os
import re

import torch

log = logging.getLogger("blackbox_tpu_torch")


def _first_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist ('n[01-03],m05' -> 'n01')."""
    m = re.match(r"([^,\[]+)(\[([^\]]+)\])?", nodelist)
    if not m:
        return nodelist.split(",")[0]
    base, _, rng = m.groups()
    if not rng:
        return base
    first = re.split("[,-]", rng)[0]
    return base + first


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   port: int = 8476) -> bool:
    """Form a ``torch.distributed`` group from the arguments or the
    SLURM environment.

    ``coordinator`` is "host:port" of rank 0.  Returns True if a
    multi-process group was formed (or already exists), False for a
    single process (no-op).
    """
    import torch.distributed as dist

    if num_processes is None:
        num_processes = int(os.environ.get("SLURM_NTASKS", "1") or 1)
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if process_id is None:
        process_id = int(os.environ.get("SLURM_PROCID", "0") or 0)
    if coordinator is None:
        nodelist = os.environ.get("SLURM_JOB_NODELIST", "")
        host = _first_host(nodelist) if nodelist else "127.0.0.1"
        coordinator = f"{host}:{port}"
    backend = ("cpu:gloo,cuda:nccl"
               if torch.cuda.is_available() and dist.is_nccl_available()
               else "gloo")
    log.info("torch.distributed.init_process_group(%s, tcp://%s, n=%d, "
             "rank=%d)", backend, coordinator, num_processes, process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def process_rank() -> tuple:
    """(rank, world size) of this process: (0, 1) outside a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
