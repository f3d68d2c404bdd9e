"""Turn a JAX trainer's orbax checkpoint into the port's, so the port's
``sample`` and ``compute_fid`` read a JAX-trained model and its trainer
resumes from it.

The JAX trainer writes ``{checkpoint_dir}/step_{n}/`` (orbax, the
TrainState's step, params, ema_params and optax state) and publishes n in
``latest.txt`` (``pdm_tpu/diffusion/trainer.py``). This writes the port
trainer's ``{out}/step_{n}/state.pt`` and ``{out}/latest.txt``: params and
EMA through ``models.weights.from_flax_params``, Adam's count and moments
(optax's ``mu`` / ``nu``) as the port optimizer's state. The model is
built from the config (``ddpm.unet_config``, on the CPU) for its
parameter order.

The checkpoint is read with ``tensorstore`` alone, the storage library
orbax writes through: ``_METADATA`` (JSON) names every leaf by its key
path, and each leaf is a zarr array under that path joined with ``.``,
in an OCDBT store when ``use_ocdbt`` is set. Neither orbax nor JAX is
imported. ``tensorstore`` is imported when this runs, not before: the
port needs it nowhere else, and the card machine does not have it.

    python -m pdm_tpu_torch.scripts.convert_orbax_checkpoint \\
        [--src DIR] [--step N] [--out DIR] [config flags]

``--src`` and ``--out`` default to the config's ``checkpoint_dir`` (the
same directory both trainers use), ``--step`` to ``--src``'s latest.txt.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..config.config import Config
from ..config.loader import (
    load_config, parse_args_from_config, update_config_from_args,
)
from ..diffusion.trainer import DDPMTrainer
from ..models.from_config import ddpm_from_config
from ..models.weights import from_flax_params


def _adam_state(tree) -> Optional[Mapping]:
    """optax's ScaleByAdamState (a dict of count, mu and nu as read
    back) inside the optimizer state."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for node in tree:
            found = _adam_state(node)
            if found is not None:
                return found
    return None


def _read_orbax(path: str) -> dict:
    """The tree an orbax ``StandardCheckpointer`` saved at ``path``, as
    nested dicts of numpy arrays (sequence indices become string keys;
    leaves saved as None are left out)."""
    import tensorstore as ts  # optional: only this bridge needs it

    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    tree: dict = {}
    for leaf in meta["tree_metadata"].values():
        if leaf["value_metadata"].get("skip_deserialize"):
            continue
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        name = ".".join(keys)
        if meta.get("use_ocdbt", True):
            kvstore = {"driver": "ocdbt", "base": f"file://{path}",
                       "path": name}
        else:
            kvstore = {"driver": "file", "path": os.path.join(path, name)}
        store = ts.open({"driver": driver, "kvstore": kvstore},
                        open=True).result()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.array(store.read().result())
    return tree


def convert(config: Config, src: str, out: str, step: Optional[int] = None
            ) -> int:
    """Write the port's ``out/step_{step}/state.pt`` and ``latest.txt``
    from the JAX checkpoint ``src/step_{step}``; returns the step."""
    if step is None:
        with open(os.path.join(src, "latest.txt")) as f:
            step = int(f.read().strip())
    raw = _read_orbax(os.path.abspath(os.path.join(src, f"step_{step}")))
    tc = config.ddpm_training
    trainer = DDPMTrainer(
        ddpm_from_config(config, device="cpu"),
        learning_rate=tc.learning_rate, weight_decay=tc.weight_decay,
        betas=tuple(tc.betas), warmup_steps=tc.warmup_steps,
        total_iters=tc.total_iters, checkpoint_dir=out)
    state = trainer.init_state(from_flax_params(raw["params"]))
    ema = from_flax_params(raw["ema_params"])
    with torch.no_grad():
        for name, t in state.ema_params.items():
            t.copy_(ema[name])
    adam = _adam_state(raw["opt_state"])
    if adam is not None:
        mu, nu = from_flax_params(adam["mu"]), from_flax_params(adam["nu"])
        count = torch.tensor(float(adam["count"]), dtype=torch.float32)
        for name, p in state.params.items():
            state.optimizer.state[p] = {"step": count.clone(),
                                        "exp_avg": mu[name].clone(),
                                        "exp_avg_sq": nu[name].clone()}
    state.step = int(raw["step"])
    trainer.save_checkpoint(state, step)
    return step


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--src", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--step", type=int, default=None)
    args, rest = parser.parse_known_args(argv)
    config = load_config()
    update_config_from_args(config, parse_args_from_config(config, rest))
    src = args.src or config.checkpoint_dir
    out = args.out or config.checkpoint_dir
    step = convert(config, src, out, args.step)
    print(f"converted {src}/step_{step} -> {out}/step_{step}/state.pt")
    return step


if __name__ == "__main__":
    main()
