"""LeNet (MLP) classifier and feature head, with its trainer and its .npz.

Counterpart of ``pdm_tpu/models/lenet.py``: the FID feature extractor for
MNIST, a 1024 -> 300 -> 100 -> 10 MLP with ReLU whose features are the
last hidden layer. Layers ``fc_0``, ``fc_1`` and ``fc_last`` carry the JAX
module's names.

The .npz is the JAX package's format, so either package reads the other's
file: keys ``['fc_0']/['kernel']`` and ``['fc_0']/['bias']`` (the repr of
flax's tree path), each kernel (in, out), the transpose of an
``nn.Linear`` weight. It is read and written with numpy alone.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..core.device import DeviceLike, resolve_device

ADAM_EPS = 1e-8  # optax.adam's default, as its betas (0.9, 0.999)


class LeNet(nn.Module):
    def __init__(self, in_dim: int = 1024, out_dim: int = 10,
                 inter_dims: Sequence[int] = (300, 100)):
        super().__init__()
        dims = [in_dim, *inter_dims]
        self.inter_dims = tuple(inter_dims)
        for i in range(len(inter_dims)):
            setattr(self, f"fc_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.fc_last = nn.Linear(dims[-1], out_dim)

    def forward(self, x: Tensor, *, features_only: bool = False) -> Tensor:
        h = x.reshape(x.shape[0], -1)
        for i in range(len(self.inter_dims)):
            h = F.relu(getattr(self, f"fc_{i}")(h))
        if features_only:
            return h
        return self.fc_last(h)


@torch.no_grad()
def init_lenet(model: LeNet, generator: torch.Generator) -> LeNet:
    """flax Dense's initialisers, drawn from ``generator`` layer by layer:
    kernels lecun-normal (a normal truncated at +-2 sigma', sigma' =
    sqrt(1 / fan_in) / 0.8796...), biases 0."""
    from .unet_ddpm import lecun_sigma

    for layer in model.children():
        sigma = lecun_sigma(layer.weight)
        w = torch.empty(layer.weight.shape, dtype=torch.float32,
                        device=generator.device)
        nn.init.trunc_normal_(w, 0.0, sigma, -2.0 * sigma, 2.0 * sigma,
                              generator=generator)
        layer.weight.copy_(w)
        layer.bias.zero_()
    return model


def train_lenet(
    generator: torch.Generator,
    images,
    labels,
    eval_images=None,
    eval_labels=None,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    epochs: int = 10,
    verbose: bool = True,
    device: DeviceLike = None,
) -> LeNet:
    """Adam (optax's defaults) and cross-entropy over ``epochs`` passes of
    ``n // batch_size`` full batches. The weights and each epoch's
    permutation come from ``generator`` (a CPU generator; the permutation
    is moved to the data). Runs on ``device``: the card unless
    ``device="cpu"``. Returns the trained module in eval mode."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(dev)
    y = torch.as_tensor(np.asarray(labels)).long().to(dev)
    n = x.shape[0]
    model = init_lenet(LeNet(in_dim=x[0].numel()), generator).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=ADAM_EPS)
    steps_per_epoch = n // batch_size
    for epoch in range(epochs):
        perm = torch.randperm(n, generator=generator).to(dev)
        tot_loss = torch.zeros((), device=dev)
        tot_acc = torch.zeros((), device=dev)
        model.train()
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            logits = model(x[idx])
            loss = F.cross_entropy(logits, y[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot_loss += loss.detach()
            tot_acc += (logits.argmax(-1) == y[idx]).float().mean()
        if verbose:
            msg = (f"epoch {epoch + 1}/{epochs} "
                   f"loss {float(tot_loss) / steps_per_epoch:.4f} "
                   f"acc {float(tot_acc) / steps_per_epoch:.4f}")
            if eval_images is not None:
                el, ea = evaluate_lenet(model, eval_images, eval_labels)
                msg += f" | eval loss {el:.4f} acc {ea:.4f}"
            print(msg)
    return model.eval()


@torch.no_grad()
def evaluate_lenet(model: LeNet, images, labels):
    """(mean cross-entropy, accuracy) of ``model`` on the set, as floats."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(images), dtype=torch.float32).to(dev)
    y = torch.as_tensor(np.asarray(labels)).long().to(dev)
    logits = model.eval()(x)
    return (float(F.cross_entropy(logits, y)),
            float((logits.argmax(-1) == y).float().mean()))


def save_lenet(model: LeNet, path: str) -> None:
    arrays = {}
    for name, layer in model.named_children():
        arrays[f"['{name}']/['kernel']"] = layer.weight.detach().cpu().numpy().T
        arrays[f"['{name}']/['bias']"] = layer.bias.detach().cpu().numpy()
    np.savez(path, **arrays)


def lenet_from_flax_params(params) -> Dict[str, Tensor]:
    """JAX's LeNet parameter tree ({'fc_0': {'kernel', 'bias'}, ...}) ->
    the port's state dict (fp32 CPU tensors, kernels transposed)."""
    sd = {}
    for name, leaves in params.items():
        sd[f"{name}.weight"] = torch.from_numpy(
            np.array(leaves["kernel"], dtype=np.float32).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(leaves["bias"], dtype=np.float32))
    return sd


def load_lenet(path: str, device: DeviceLike = None) -> LeNet:
    """A LeNet from the JAX-format .npz (written by either package), on
    ``device`` (the card unless ``device="cpu"``), in eval mode."""
    dev = resolve_device(device)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as raw:
        for key in raw.files:
            layer, leaf = (re.sub(r".*?\['(.*?)'\]", r"\1", p)
                           for p in key.split("/"))
            params.setdefault(layer, {})[leaf] = raw[key]
    inter = [params[f"fc_{i}"]["bias"].shape[0]
             for i in range(len(params) - 1)]
    model = LeNet(in_dim=params["fc_0"]["kernel"].shape[0],
                  out_dim=params["fc_last"]["bias"].shape[0],
                  inter_dims=inter)
    model.load_state_dict(lenet_from_flax_params(params), strict=True)
    return model.to(dev).eval()
