"""Multi-process start and sharded sampling.

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
from torch import Tensor

from ..core.device import DeviceLike
from ..core.draws import SlicedGenerator
from .collectives import all_gather_dim
from .mesh import (
    BatchSharding, batch_sharding, check_batch_divisible, unet_with_sp,
)


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


class SpatialSharding(BatchSharding):
    """The batch over 'data' and the image rows (NCHW dim 2) over 'model':
    this rank's rows of its images. ``shard`` cuts a (B, C, H, W) tensor
    to them, ``gather`` puts the global batch back together on every rank
    (rows over the model group, then images over the data group), and the
    generator draws the global batch's values and keeps both cuts."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.model_size, self.model_index = mesh.model_size, mesh.model_index

    def row_slice(self, h: int) -> slice:
        if h % self.model_size:
            raise ValueError(f"spatial sampling: the image's {h} rows do not "
                             f"split over the model axis ({self.model_size})")
        n = h // self.model_size
        return slice(self.model_index * n, (self.model_index + 1) * n)

    def local_shape(self, n: int, obj_size):
        c, h, *rest = obj_size
        return (n // self.size, c, h // self.model_size, *rest)

    def shard(self, x):
        return super().shard(x)[:, :, self.row_slice(x.shape[2])]

    def gather(self, x: Tensor, dim: int = 2) -> Tensor:
        mesh = self.mesh
        x = all_gather_dim(x.contiguous(), mesh.model_group, mesh.model_size,
                           dim, mesh.model_stats)
        return mesh.all_gather(x)

    def shard_steps(self, x: Tensor) -> Tensor:
        return super().shard_steps(x)[:, :, :, self.row_slice(x.shape[3])]

    def gather_steps(self, x: Tensor) -> Tensor:
        return self.gather(x.transpose(0, 1), dim=3).transpose(0, 1)

    def generator(self, generator, n: int):
        if generator is None:
            return generator
        r = self.rows(n)
        return SlicedGenerator(generator, n, r.start, r.stop,
                               cut=(2, self.model_size, self.model_index))


def sharded_sampler(sampler, mesh, partition: str = "data"):
    """A copy of the sampler sharded over the mesh.

    ``partition="data"``: the reverse process's batch axis shards over
    'data'. Each rank steps its rows of every global batch (its own x_T
    and noise, cut from the global batch's draws), the analytic denoiser
    over the whole (replicated) dataset; ``batch_sample`` gathers the
    batch, so every rank returns all of it. ``"spatial"``: also the image
    rows over 'model', through the spatial-parallel UNet
    (``mesh.unet_with_sp``): each rank steps its rows of its images (x_T
    and every step's noise cut from the global draws) and the result is
    gathered, so every rank returns the whole batch. Where the model axis
    does not divide the image's rows, every level of the UNet runs whole
    on every rank of a model group (the layout's rule for such a level),
    so each rank steps the whole images with the UNet itself and only the
    data axis is gathered. It needs a UNet
    (``UNetDDPM``): the analytic TrueDDPM has no spatial activations, and
    raises JAX's error. ``batch_size`` is the first precondition, checked
    first."""
    check_batch_divisible(sampler.batch_size, mesh, what="sample.batch_size")
    if partition == "data":
        return dataclasses.replace(sampler, batch_sharding=batch_sharding(mesh))
    if partition != "spatial":
        raise ValueError(
            f"unknown sampler partition {partition!r} (data|spatial)")
    module = getattr(sampler.ddpm, "module", None)
    if module is None or not hasattr(module, "down_blocks"):
        raise ValueError(
            "spatial-parallel sampling needs a module-backed DDPM "
            "(UNetDDPM); this model has no spatial activations to shard")
    if mesh.shape["model"] <= 1:
        return dataclasses.replace(sampler, batch_sharding=batch_sharding(mesh))
    from ..models.unet_ddpm import UNetDDPM
    from .model_parallel import refuse_fused_block

    refuse_fused_block()
    if sampler.obj_size[1] % mesh.model_size:
        # every level runs whole on every rank of a model group: the UNet
        # itself over the data axis
        return dataclasses.replace(sampler, batch_sharding=batch_sharding(mesh))
    ddpm = sampler.ddpm
    sp = UNetDDPM(ddpm.scheduler, unet_with_sp(module, mesh),
                  ddpm.parametrization, ddpm.tau_scale, device=ddpm.device,
                  params=ddpm.params)
    return dataclasses.replace(sampler, ddpm=sp, batch_sharding=SpatialSharding(mesh))
