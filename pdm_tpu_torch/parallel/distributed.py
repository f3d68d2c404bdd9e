"""Multi-process start and data-parallel sampling.

Counterpart of ``pdm_tpu/parallel/distributed.py``. One process runs per
card (``torchrun --nproc_per_node N``); :func:`initialize_multihost`
joins them in one torch.distributed process group, over which
``parallel.mesh`` builds the ('data', 'model') mesh.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import DeviceLike
from .mesh import ITEM_6B, batch_sharding, check_batch_divisible


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = 1800.0,
    device: DeviceLike = None,
) -> None:
    """Start the default process group from the arguments or from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``). A no-op for one process and when the
    group is already up.

    ``coordinator_address`` is ``host:port`` (TCP rendezvous) or an
    ``init_method`` URL such as ``file:///path``. The backend is NCCL when
    the process runs on the card (a card is there and ``device`` is not
    the CPU), after ``torch.cuda.set_device(LOCAL_RANK)`` so that every
    device resolved later is this rank's card, and gloo on the CPU; a
    failure to start raises. ``timeout_s`` bounds each collective."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if torch.cuda.is_available() and (
            device is None or torch.device(device).type == "cuda"):
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))


def sharded_sampler(sampler, mesh, partition: str = "data"):
    """A copy of the sampler sharded over the mesh.

    ``partition="data"``: the reverse process's batch axis shards over
    'data'. Each rank steps its rows of every global batch (its own x_T
    and noise, cut from the global batch's draws), the analytic denoiser
    over the whole (replicated) dataset; ``batch_sample`` gathers the
    batch, so every rank returns all of it. ``batch_size`` is the only
    divisibility precondition, checked first. ``"spatial"`` (the image H
    axis over 'model') is not ported (ROADMAP.md §1 item 6b)."""
    check_batch_divisible(sampler.batch_size, mesh, what="sample.batch_size")
    if partition == "data":
        return dataclasses.replace(sampler, batch_sharding=batch_sharding(mesh))
    if partition != "spatial":
        raise ValueError(
            f"unknown sampler partition {partition!r} (data|spatial)")
    raise NotImplementedError(f"sharded_sampler(partition='spatial'): {ITEM_6B}")
