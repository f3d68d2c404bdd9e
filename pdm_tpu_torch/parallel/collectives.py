"""The port's collectives, their byte bill, and a link-time projection.

Counterpart of ``pdm_tpu/parallel/collectives.py``. JAX reads its
collectives back out of the compiled HLO that GSPMD partitioned
(``collective_bytes``); nothing partitions the port's programs, so every
cross-rank call of the port goes through :func:`all_reduce` and
:func:`all_gather` here, and each adds its payload to the
:class:`CollectiveStats` it is given (the mesh's, ``Mesh.stats``), under
the kind JAX's parser uses. The bytes counted are JAX's: the RESULT's size
on one rank (the whole array for an all-reduce, the gathered array for
an all-gather). A train step's bill is then read off the counter, where
JAX reads it off the HLO.

Which collective each backend runs (the same code runs on both):

* NCCL (the card): ``all_reduce`` with SUM or MAX in place, and the list
  form of ``all_gather`` into views of one contiguous buffer. Both run on
  the card in the caller's stream order: c10d makes NCCL's stream wait
  for the current stream and the current stream wait for the result, so
  the port's kernels, which launch on ``torch.cuda.current_stream()``,
  need no extra synchronisation. No call is left asynchronous.
* gloo (the CPU tests; two ranks sharing one card in ``chip_smoke.py``,
  where NCCL refuses two ranks on one device): the same two calls. gloo
  runs SUM and MAX all-reduce and the list-form all-gather on CPU tensors
  (torch 2.13, checked by the CPU tests) and on CUDA tensors, which gloo
  itself copies through host memory (torch 2.11 on the H100 machine,
  checked by ``chip_smoke.py`` phase 20b); the port stages nothing
  through the host itself. The port
  uses no ``reduce_scatter``, the one collective whose gloo form on CUDA
  tensors nothing here checks: FSDP all-reduces the gradient and
  all-gathers the updated shards (``diffusion/trainer.py``).

A collective over no group (a mesh without a process group: one rank
outside ``torch.distributed``, or a rank the mesh leaves out) does
nothing and counts nothing. A failed collective raises (c10d's error, or
its timeout); nothing retries it.

The projection (:func:`link_seconds`, :func:`project_step`) keeps JAX's
bandwidth-optimal ring volumes (``ici_seconds``); its link figure is an
argument whose default is NVIDIA's H100 SXM data sheet figure for NVLink
4, not a measurement: 18 links of 25 GB/s each direction, 450 GB/s each
direction in all.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import Tensor

# H100 SXM data sheet: NVLink 4, 900 GB/s bidirectional per card, i.e.
# 450 GB/s each direction over its 18 links
H100_NVLINK_BW = 450e9  # bytes/s, one direction, all links of one card


@dataclass
class CollectiveStats:
    """Per-kind totals of the collectives one rank issued (bytes of each
    call's result on that rank, and calls)."""

    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def __getitem__(self, kind: str) -> int:
        return self.bytes_by_kind.get(kind, 0)

    def counts(self, kind: str) -> int:
        return self.count_by_kind.get(kind, 0)

    def add(self, kind: str, n_bytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + int(n_bytes)
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def reset(self) -> None:
        self.bytes_by_kind.clear()
        self.count_by_kind.clear()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: Tensor, group, stats: Optional[CollectiveStats] = None,
               op: str = "sum") -> Tensor:
    """``t`` reduced in place over ``group`` (op "sum" or "max"); returns
    it. A no-op when ``group`` is None."""
    if group is None:
        return t
    dist.all_reduce(t, op=_OPS[op], group=group)
    if stats is not None:
        stats.add("all-reduce", t.numel() * t.element_size())
    return t


def all_gather(t: Tensor, group, size: int,
               stats: Optional[CollectiveStats] = None) -> Tensor:
    """The ``size`` ranks' ``t`` (equal shapes) concatenated along dim 0
    in rank order of ``group``. Returns ``t`` when ``group`` is None."""
    if group is None:
        return t
    t = t.contiguous()
    out = torch.empty((size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather(list(out.chunk(size)), t, group=group)
    if stats is not None:
        stats.add("all-gather", out.numel() * out.element_size())
    return out


def barrier(group=None) -> None:
    """Every rank of ``group`` (the world by default) waits for the rest;
    a no-op outside ``torch.distributed``."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=group)


# ---------------------------------------------------------------------
# link-time projection
# ---------------------------------------------------------------------


def link_seconds(
    kind: str,
    per_rank_bytes: float,
    axis_size: int,
    link_bw: float = H100_NVLINK_BW,
    bidirectional: bool = True,
) -> float:
    """Wall seconds for one collective of ``per_rank_bytes`` (the result
    size :class:`CollectiveStats` counts) over a ring of ``axis_size``
    ranks: JAX's ``ici_seconds`` volumes. In units of the result size V:
    all-reduce 2(N-1)/N V, all-gather (N-1)/N V, reduce-scatter (N-1) V
    (its result is one shard), collective-permute V, all-to-all (N-1)/N
    V; a bidirectional ring doubles the effective bandwidth."""
    if axis_size <= 1:
        return 0.0
    n = axis_size
    factor = {
        "all-reduce": 2.0 * (n - 1) / n,
        "all-gather": (n - 1) / n,
        "reduce-scatter": float(n - 1),
        "collective-permute": 1.0,
        "all-to-all": (n - 1) / n,
    }[kind]
    bw = link_bw * (2.0 if bidirectional else 1.0)
    return per_rank_bytes * factor / bw


def project_step(stats: CollectiveStats, axis_size: int,
                 link_bw: float = H100_NVLINK_BW) -> Dict[str, float]:
    """Per-kind and total projected link seconds for one step's bill."""
    out: Dict[str, float] = {}
    for kind, b in stats.bytes_by_kind.items():
        out[kind] = link_seconds(kind, b, axis_size, link_bw)
    out["total"] = sum(out.values())
    return out
