"""Timing helpers that wait for the card.

Counterpart of ``pdm_tpu/utils/timing.py``. PyTorch returns from a CUDA
call before the card has run it, so a host clock measures the enqueue
unless the timed region ends in a synchronize. :func:`sync` waits for
every card that holds a tensor of a tree; :class:`Timer` reads the host
clock and, on a card, CUDA events on the current stream beside it.
"""

from __future__ import annotations

import time
from typing import Any, Iterator, Optional

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree: Any) -> None:
    """Wait until the work producing ``tree``'s tensors is done: one
    ``torch.cuda.synchronize`` per card that holds one of them (nothing
    for CPU tensors, which are ready when returned)."""
    for index in sorted({t.device.index or 0 for t in _tensors(tree)
                         if t.device.type == "cuda"}):
        torch.cuda.synchronize(index)


class Timer:
    """``with Timer() as t: ...``: ``t.elapsed`` is the host's seconds,
    after waiting for ``sync_tree`` when given. With ``device`` a CUDA
    device, CUDA events on its current stream also bracket the region and
    ``t.device_elapsed`` is the card's seconds between them (None
    otherwise)."""

    def __init__(self, sync_tree: Any = None,
                 device: Optional[torch.device] = None):
        self._sync_tree = sync_tree
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = device
        self.device_elapsed: Optional[float] = None

    def __enter__(self):
        if self._cuda:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if self._sync_tree is not None:
            sync(self._sync_tree)
        if self._cuda:
            self._events[1].synchronize()
            self.device_elapsed = self._events[0].elapsed_time(
                self._events[1]) / 1e3
        self.elapsed = time.perf_counter() - self.start
        return False
