"""Serving export: a sampler's step frozen into a ``torch.export`` program.

Counterpart of ``pdm_tpu/utils/serving.py``. JAX exports the sampler's
whole ``scan`` as one StableHLO program with its draws inside. Here a
program is one step of the reverse process (the denoiser call and the
update, ``diffusion/sampling.py``'s step modules, its weights or dataset
held as the program's parameters and buffers), and the loaded sampler
loops over the step tables stored beside it: an unrolled export grows
with the steps (tens of thousands of nodes at 50 UNet steps), a step does
not. Heun exports two programs, the looped step and the peeled final
step (``x.pt2`` and ``x.final.pt2``).

``export_sampler(sampler, path)`` writes the program with
``torch.export.save`` (the step tables and the manifest in its
``extra_files``) and the manifest beside it as ``path + ".json"``, with
JAX's keys. ``load_exported(path)`` returns ``(fn, manifest)``: ``fn(seed)``
draws x_T and, for ``ddpm``, each step's noise from
``torch.Generator(device).manual_seed(seed)`` through
``core/draws.py::batch_randn`` in ``batch_sample``'s order, so that
``fn(7)`` equals ``sampler.batch_sample(torch.Generator(dev).manual_seed(7))["x"]``;
``fn.replay(x_init, noise=None)`` takes explicit draws instead. Both run
the loop :func:`run_steps`, which ``batch_sample`` runs too.

The programs call the port's kernels through the ``pdm::`` custom ops
(``ops/library.py``), so an artifact replays after ``import
pdm_tpu_torch.ops``, which registers them; it needs no checkpoint and no
config. What the trace read is baked into the program: ``PDM_FUSED_BLOCK``
(the whole attention block, row 5, or rows 1 and 3),
``PDM_BOLTZMANN_PRECISION`` (row 7's mode and the dataset's pack), the
attention gate's choice on the static shapes, the batch size and the
device. ``track_states`` is not exported, as in JAX. A sampler with
``batch_sharding`` is refused: the export is one program on one device.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from ..core.device import resolve_device
from ..core.draws import batch_randn

# the custom ops an exported step may call (ops/library.py registers them)
OP_NAMES = ("attention_fwd", "group_norm_act", "attention_block_fwd",
            "boltzmann_moments")

ENTRY = ("serve(seed) -> x: x_T (and, for ddpm, each step's noise) from "
         "torch.Generator(device).manual_seed(seed), then the step program "
         "over the stored step tables; replays after `import "
         "pdm_tpu_torch.ops` (the pdm:: custom ops), with no checkpoint or "
         "config")


def run_steps(step_type: str, step: Callable, final: Optional[Callable],
              rows: Tensor, xt: Tensor, draw: Callable[[], Tensor],
              noise: Optional[Tensor] = None,
              call: Optional[Callable] = None,
              keep: Optional[Callable[[Tensor], None]] = None) -> Tensor:
    """The reverse process's loop: step i takes ``rows[i]`` (its row of the
    step tables, hottest first) and xt, and for ``ddpm`` its noise
    (``noise[i]``, else ``draw()`` at that point), for ``dpmpp_2m`` the
    previous step's x0 (zeros at first); Heun's last row goes to ``final``.
    ``call(fn, *args)`` makes each call (a checkpoint under remat);
    ``keep`` sees each step's output."""
    n = rows.shape[0]
    call = call or (lambda fn, *args: fn(*args))
    keep = keep or (lambda x: None)
    if step_type == "dpmpp_2m":
        x0_prev = torch.zeros_like(xt)
        for i in range(n):
            xt, x0_prev = call(step, rows[i], xt, x0_prev)
            keep(xt)
    elif step_type == "heun":
        for i in range(n - 1):
            xt = call(step, rows[i], xt)
            keep(xt)
        xt = call(final, rows[n - 1], xt)
        keep(xt)
    elif step_type == "ddpm":
        for i in range(n):
            xi = noise[i] if noise is not None else draw()
            xt = call(step, rows[i], xt, xi)
            keep(xt)
    else:
        for i in range(n):
            xt = call(step, rows[i], xt)
            keep(xt)
    return xt


def _files(path: str, step_type: str) -> Tuple[str, ...]:
    """The artifact's programs: the step, and Heun's final step beside it
    (``x.pt2`` -> ``x.final.pt2``)."""
    if step_type != "heun":
        return (path,)
    return path, os.path.splitext(path)[0] + ".final.pt2"


def export_sampler(sampler, path: str) -> str:
    """Export ``sampler``'s step (and Heun's final step) to ``path`` (a
    ``.pt2`` archive) plus the ``path``.json manifest; returns the path.
    Traced under ``torch.no_grad()`` on the sampler's device, the one
    platform the program runs on."""
    from ..diffusion.sampling import (
        STEP_MODULES, HeunFinalStep, _step_tables, step_rows,
    )

    if sampler.batch_sharding is not None:
        raise ValueError("export_sampler exports one program on one device; "
                         "a sampler with batch_sharding "
                         "(parallel.sharded_sampler) runs one per rank")
    dev = sampler.device
    rows = step_rows(_step_tables(sampler._grid()))
    shape = (sampler.batch_size, *sampler.obj_size)
    half = sampler.precision == "half"
    xt = torch.zeros(shape, dtype=torch.float32, device=dev)
    # the noise or the previous x0: a tensor of its own (an input that
    # aliases xt would be traced as the same input)
    extra = ((torch.zeros_like(xt),)
             if sampler.step_type in ("ddpm", "dpmpp_2m") else ())
    with torch.no_grad():
        programs = [torch.export.export(
            STEP_MODULES[sampler.step_type](sampler.ddpm, half),
            (rows[0], xt, *extra), strict=False)]
        if sampler.step_type == "heun":
            programs.append(torch.export.export(
                HeunFinalStep(sampler.ddpm, half), (rows[-1], xt),
                strict=False))
    files = _files(path, sampler.step_type)
    manifest = {
        "entry": ENTRY,
        "batch_size": sampler.batch_size,
        "n_steps": sampler.n_steps,
        "step_type": sampler.step_type,
        "obj_size": list(sampler.obj_size),
        "precision": sampler.precision,
        "platforms": [dev.type],
        "out_shape": list(shape),
        "programs": [os.path.basename(f) for f in files],
    }
    inner = {"manifest.json": json.dumps(manifest),
             "tables.json": json.dumps(rows.cpu().tolist())}
    for ep, f in zip(programs, files):
        torch.export.save(ep, f, extra_files=inner)
    manifest["bytes"] = sum(os.path.getsize(f) for f in files)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def _require_ops() -> None:
    missing = [name for name in OP_NAMES if not hasattr(torch.ops.pdm, name)]
    if missing:
        raise RuntimeError(
            f"the exported sampler calls the custom ops pdm::{missing[0]} "
            f"(and the others of pdm_tpu_torch/ops/library.py), which are not "
            f"registered: `import pdm_tpu_torch.ops` before load_exported")


def load_exported(path: str):
    """Rehydrate an exported sampler: returns ``fn(seed) -> (batch,
    *obj_size)`` fp32 and the manifest. ``fn.replay(x_init, noise=None)``
    runs the same loop on given draws (``noise`` (n_steps, B, ...) for
    ``ddpm``); ``fn.programs`` holds the loaded step module(s). It runs on the platform the program was exported for: the
    current card for ``cuda``."""
    _require_ops()
    inner = {"manifest.json": "", "tables.json": ""}
    step = torch.export.load(path, extra_files=inner)
    manifest = json.loads(inner["manifest.json"])
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            manifest = json.load(f)
    dev = resolve_device("cpu" if manifest["platforms"] == ["cpu"] else None)
    rows = torch.tensor(json.loads(inner["tables.json"]), dtype=torch.float32,
                        device=dev)
    step_type = manifest["step_type"]
    programs = [step.module()]
    if step_type == "heun":
        programs.append(torch.export.load(_files(path, step_type)[1]).module())
    final = programs[1] if len(programs) > 1 else None
    shape = tuple(manifest["out_shape"])

    def run(x_init: Tensor, noise: Optional[Tensor],
            generator: Optional[torch.Generator]) -> Tensor:
        def draw():
            return batch_randn(shape, generator, device=dev,
                               dtype=torch.float32)

        with torch.inference_mode():  # as batch_sample
            return run_steps(step_type, programs[0], final, rows,
                             x_init.to(dev, torch.float32), draw, noise)

    def replay(x_init: Tensor, noise: Optional[Tensor] = None) -> Tensor:
        if step_type == "ddpm":
            want = (rows.shape[0], *shape)
            if noise is None or tuple(noise.shape) != want:
                raise ValueError(f"a ddpm replay takes noise of shape {want}")
            noise = noise.to(dev, torch.float32)
        return run(x_init, noise, None)

    def fn(seed: int) -> Tensor:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return run(batch_randn(shape, gen, device=dev, dtype=torch.float32),
                   None, gen)

    fn.replay = replay
    fn.programs = tuple(programs)
    return fn, manifest
