"""Random draws over a batch that do not depend on how it is split.

Under a data mesh each rank holds a slice of a global batch, and what a
run draws must not depend on the number of ranks (JAX's threefry is
partitionable: a sharded draw equals the whole one). A
:class:`SlicedGenerator` stands in for a ``torch.Generator`` where a draw
has the batch as its leading axis: :func:`batch_rand` and
:func:`batch_randn` draw the global batch's values from the generator, as
one process does, and keep this rank's rows. With a plain generator they
are ``torch.rand`` and ``torch.randn``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import Tensor


class SlicedGenerator:
    """``generator`` over a global batch of ``batch`` rows, of which this
    rank keeps ``[lo, hi)``."""

    def __init__(self, generator: torch.Generator, batch: int, lo: int, hi: int):
        self.generator, self.batch, self.lo, self.hi = generator, batch, lo, hi

    @property
    def device(self) -> torch.device:
        return self.generator.device


AnyGenerator = Union[torch.Generator, SlicedGenerator, None]


def _draw(fn, shape: Sequence[int], generator: AnyGenerator, **kw) -> Tensor:
    if not isinstance(generator, SlicedGenerator):
        return fn(tuple(shape), generator=generator, **kw)
    if shape[0] != generator.hi - generator.lo:
        raise ValueError(f"a draw of {shape[0]} rows from a generator that "
                         f"keeps {generator.hi - generator.lo}")
    full = fn((generator.batch, *shape[1:]), generator=generator.generator, **kw)
    return full[generator.lo:generator.hi]


def batch_rand(shape: Sequence[int], generator: AnyGenerator,
               device=None, dtype: Optional[torch.dtype] = None) -> Tensor:
    """U[0, 1) of ``shape`` (batch first)."""
    return _draw(torch.rand, shape, generator, device=device, dtype=dtype)


def batch_randn(shape: Sequence[int], generator: AnyGenerator,
                device=None, dtype: Optional[torch.dtype] = None) -> Tensor:
    """N(0, 1) of ``shape`` (batch first)."""
    return _draw(torch.randn, shape, generator, device=device, dtype=dtype)
