"""Freeze the configured sampler's step into a serving artifact.

    python -m pdm_tpu_torch.scripts.export_sampler --dataset_name cifar10 \\
        --sample.noise_schedule_type entropy --sample.n_steps 50 \\
        --out serving/cifar10_entropy50.pt2

Counterpart of ``scripts/export_sampler.py``: its config flags and
``--out`` (default ``serving/{experiment}_{schedule}{n_steps}.pt2``), plus
``--device`` (the card by default). The sampler comes from
``scripts/sample.py::build_sampler``; ``utils/serving.py::export_sampler``
writes a ``torch.export`` program of one step with the step tables and a
``.json`` manifest beside it. A serving process replays it with
``load_exported`` after ``import pdm_tpu_torch.ops``, with no checkpoint or
config; the environment settings read while tracing (``PDM_FUSED_BLOCK``,
``PDM_BOLTZMANN_PRECISION``) are baked into the program.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from ..config.config import Config
from ..config.loader import with_config
from ..utils.serving import export_sampler
from ._common import ensure_dirs
from .sample import build_sampler


def split_out(argv: Sequence[str]):
    """(the --out path or "", the other arguments), as the JAX script
    splits its flag from the config flags."""
    argv = list(argv)
    for i, a in enumerate(argv):
        if a == "--out":
            if i + 1 >= len(argv):
                sys.exit("usage: export_sampler [--out PATH] [--device D] "
                         "[config flags]")
            return argv[i + 1], argv[:i] + argv[i + 2:]
        if a.startswith("--out="):
            return a.split("=", 1)[1], argv[:i] + argv[i + 1:]
    return "", argv


@with_config()
def _export(config: Config, out: str = "", device=None) -> str:
    sampler = build_sampler(config, device=device)
    out = out or (f"serving/{config.experiment_name}_"
                  f"{config.sample.noise_schedule_type}{config.sample.n_steps}.pt2")
    ensure_dirs(os.path.dirname(out) or ".")
    path = export_sampler(sampler, out)
    size = os.path.getsize(path)
    print(f"exported {path} ({size / 1e6:.1f} MB) + {path}.json")
    return path


def main(argv: Optional[Sequence[str]] = None) -> str:
    out, rest = split_out(sys.argv[1:] if argv is None else argv)
    return _export(argv=rest, out=out)


if __name__ == "__main__":
    main()
