"""Profiling and tracing.

Counterpart of ``pdm_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` trace of the region (the card's
  kernels too, when there is one), written to ``logdir`` as a Chrome
  trace (``chrome://tracing`` or Perfetto read it);
* ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``);
* ``PhaseTimer``: wall time per named phase, waiting for the card's work
  on a ``sync_tree`` before the clock stops; ``summary()`` and
  ``report()`` give the JAX package's keys and layout.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator

import torch

from .timing import sync


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the region and write ``logdir/trace_<pid>_<n>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profiler trace."""
    with torch.profiler.record_function(name):
        yield


class PhaseTimer:
    """Accumulates wall time per named phase.

    with timer.phase("train_step", sync_tree=metrics): ...
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_tree: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_tree is not None:
                sync(sync_tree)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = [f"{'phase':<24} {'count':>8} {'mean ms':>10} {'total s':>10}"]
        for name, row in sorted(self.summary().items()):
            lines.append(
                f"{name:<24} {row['count']:>8} {row['mean_ms']:>10.2f} "
                f"{row['total_s']:>10.2f}"
            )
        return "\n".join(lines)
