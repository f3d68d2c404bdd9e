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

The model axis (``parallel/model_parallel.py``) adds two differentiable
calls over a mesh's model group: :func:`gather_along` (an all-gather of
any dimension: channels under tensor parallelism, image rows under
spatial parallelism) and :func:`halo_rows` (the neighbours' boundary
rows of a row-sharded image, which GSPMD sends with collective-permutes).
Both run the list-form all-gather, the one gather both backends run on
CUDA tensors, and their backwards run the all-gather or the all-reduce
again. A halo is counted under JAX's kind "collective-permute", with the
bytes of the rows a rank receives from its neighbours (what a permute
moves); the all-gather that carries them moves the boundary rows of every
rank of the group. The mesh keeps the model axis's bill apart from the
data axis's (``Mesh.model_stats``), so that :func:`project_step` prices
each over its own ring.

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


def all_gather_dim(t: Tensor, group, size: int, dim: int,
                   stats: Optional[CollectiveStats] = None) -> Tensor:
    """The ``size`` ranks' ``t`` concatenated along ``dim`` in rank order;
    ``t`` when ``group`` is None."""
    if group is None:
        return t
    dim = dim % t.ndim
    out = all_gather(t.movedim(dim, 0), group, size, stats)
    return out.movedim(0, dim)


class _GatherAlong(torch.autograd.Function):
    """All-gather along ``dim``; the backward all-reduces the gradient and
    takes this rank's slice (each rank's gradient of the gathered tensor
    is its own part of the sum)."""

    @staticmethod
    def forward(ctx, t, dim, group, size, index, stats):
        ctx.dim, ctx.group, ctx.size, ctx.index = dim, group, size, index
        ctx.stats, ctx.n = stats, t.shape[dim]
        return all_gather_dim(t, group, size, dim, stats)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous(), ctx.group, ctx.stats)
        g = g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n)
        return g, None, None, None, None, None


def gather_along(t: Tensor, dim: int, group, size: int, index: int,
                 stats: Optional[CollectiveStats] = None) -> Tensor:
    """Differentiable all-gather of ``t`` along ``dim`` over ``group``
    (this rank's place ``index`` of ``size``). Every rank uses the
    gathered tensor for its own part of the result, so the gradient is
    the sum over the ranks: the backward all-reduces it, then keeps this
    rank's slice (a reduce-scatter)."""
    if group is None:
        return t
    return _GatherAlong.apply(t, dim, group, size, index, stats)


def _permute_bytes(t: Tensor, n_rows: int, dim: int) -> int:
    return t.numel() // t.shape[dim] * n_rows * t.element_size()


class _HaloRows(torch.autograd.Function):
    """``t`` with ``top`` rows of the previous rank above it and ``bottom``
    rows of the next rank below it along ``dim`` (zeros at the image's
    edges). The backward sends each halo row's gradient back to the rank
    it came from and adds it there."""

    @staticmethod
    def forward(ctx, t, dim, top, bottom, group, size, index, stats):
        ctx.args = (dim, top, bottom, group, size, index, stats)
        n = t.shape[dim]
        # each rank's boundary rows: its first ``bottom`` (the previous
        # rank's lower halo) and its last ``top`` (the next rank's upper)
        edge = torch.cat([t.narrow(dim, 0, bottom), t.narrow(dim, n - top, top)],
                         dim)
        rows = all_gather_dim(edge, group, size, dim).chunk(size, dim)
        if stats is not None:
            stats.add("collective-permute", _permute_bytes(t, top + bottom, dim))
        parts = []
        if top:
            parts.append(rows[index - 1].narrow(dim, bottom, top) if index > 0
                         else torch.zeros_like(t.narrow(dim, 0, top)))
        parts.append(t)
        if bottom:
            parts.append(rows[index + 1].narrow(dim, 0, bottom)
                         if index < size - 1
                         else torch.zeros_like(t.narrow(dim, 0, bottom)))
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        dim, top, bottom, group, size, index, stats = ctx.args
        n = g.shape[dim] - top - bottom
        g_top, g_mid = g.narrow(dim, 0, top), g.narrow(dim, top, n)
        g_bot = g.narrow(dim, top + n, bottom)
        # the gradient of the rows this rank took from its neighbours
        sent = all_gather_dim(torch.cat([g_top, g_bot], dim).contiguous(),
                              group, size, dim).chunk(size, dim)
        if stats is not None:
            stats.add("collective-permute", _permute_bytes(g, top + bottom, dim))
        dx = g_mid.clone()
        if bottom and index > 0:  # our first rows were the previous one's lower halo
            dx.narrow(dim, 0, bottom).add_(sent[index - 1].narrow(dim, top, bottom))
        if top and index < size - 1:  # our last rows were the next one's upper
            dx.narrow(dim, n - top, top).add_(sent[index + 1].narrow(dim, 0, top))
        return dx, None, None, None, None, None, None, None


def halo_rows(t: Tensor, dim: int, top: int, bottom: int, group, size: int,
              index: int, stats: Optional[CollectiveStats] = None) -> Tensor:
    """Differentiable halo exchange of a tensor whose ``dim`` is cut into
    contiguous slices over ``group`` in rank order: ``top`` rows of the
    previous rank above it, ``bottom`` rows of the next one below it,
    zeros beyond the first and last ranks. Every rank enters the
    all-gather, the first and the last included."""
    if t.shape[dim] < max(top, bottom):
        raise ValueError(f"a halo of {max(top, bottom)} rows needs at least "
                         f"as many rows a rank: {t.shape[dim]}")
    return _HaloRows.apply(t, dim, top, bottom, group, size, index, stats)


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
    """Per-kind and total projected link seconds for one step's bill
    over a ring of ``axis_size``. A halo is priced as JAX's
    collective-permute of the rows a rank receives, not as the all-gather
    of every rank's boundary rows that :func:`halo_rows` runs, whose bytes
    grow with the ring."""
    out: Dict[str, float] = {}
    for kind, b in stats.bytes_by_kind.items():
        out[kind] = link_seconds(kind, b, axis_size, link_bw)
    out["total"] = sum(out.values())
    return out
