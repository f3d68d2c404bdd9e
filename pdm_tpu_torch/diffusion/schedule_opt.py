"""Differentiable noise-schedule optimization.

Counterpart of ``pdm_tpu/diffusion/schedule_opt.py``. Optimizes the
``(n_steps,)`` log-temperature knot vector of the sampling schedule by
gradient descent on a distributional loss (multi-scale RBF MMD against
training data), with a sort projection for monotonicity and clamping to
the scheduler's range. The reverse process is the sampler's own loop
(``diffusion/sampling.py::_sample_loop``), run under grad: autograd
differentiates through it as ``jax.grad`` does through the JAX scan.

Through ``TrueDDPM`` the gradient reaches the Boltzmann moments' VJP
(``ops/boltzmann.py::PosteriorMean``: a kernel on the card); through a
UNet it reaches the attention and GroupNorm kernels' backward, with
``remat`` checkpointing each step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core.device import DeviceLike, resolve_device
from ..models.base import DDPM
from ..ops.mmd import mmd_rbf
from .sampling import _sample_loop, _step_tables
from .trainer import clip_by_global_norm

DEFAULT_SIGMAS = (0.01, 0.05, 0.1, 0.5)


def sample_with_grid(
    ddpm: DDPM,
    log_temp_grid: Tensor,
    generator: Optional[torch.Generator],
    sample_shape: Tuple[int, ...],
    step_type: str = "ddim",
    remat: bool = False,
    *,
    x_init: Optional[Tensor] = None,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Reverse process on an explicit (differentiable) log-temp grid, on
    the grid's device, the model in fp32 (JAX's ``half=False``).

    ``x_init`` (sample_shape) and, for 'ddpm', ``noise`` (n_steps,
    *sample_shape) replace the generator's draws. ``remat`` checkpoints
    each reverse step so the backward recomputes one forward at a time
    instead of storing all of them: required for UNet-scale models. JAX
    keeps it off for TrueDDPM (its remat of the streaming posterior gave
    NaN gradients), and so do its callers here."""
    dev = log_temp_grid.device
    if x_init is None:
        x_init = torch.randn(sample_shape, generator=generator, device=dev,
                             dtype=torch.float32)
    x_init = x_init.to(dev, torch.float32)
    if noise is not None:
        noise = noise.to(dev, torch.float32)
    x, _ = _sample_loop(ddpm, _step_tables(log_temp_grid), x_init, step_type,
                        False, False, generator, noise, remat=remat)
    return x


class Knots:
    """The knot vector and its optimizer: the JAX step's projection (sort,
    then clip to ``clip_range``) and ``optax.chain(clip_by_global_norm,
    adam)`` (the trainer's optax-form clip; torch's Adam, whose defaults
    and update are optax's)."""

    def __init__(self, init_log_temp, learning_rate: float, grad_clip: float,
                 clip_range: Optional[Tuple[float, float]],
                 device: torch.device):
        self.log_temp = torch.as_tensor(
            init_log_temp, dtype=torch.float32,
            device=device).clone().requires_grad_(True)
        self.grad_clip = grad_clip
        self.clip_range = clip_range
        self.opt = torch.optim.Adam([self.log_temp], lr=learning_rate)

    def projected(self) -> Tensor:
        """The knots sorted and clipped (a new tensor, no graph)."""
        with torch.no_grad():
            lt = torch.sort(self.log_temp).values
            if self.clip_range is not None:
                lt = torch.clamp(lt, self.clip_range[0], self.clip_range[1])
        return lt

    def project(self) -> Tensor:
        """Project the knots in place; returns them (the leaf to
        differentiate)."""
        with torch.no_grad():
            self.log_temp.copy_(self.projected())
        return self.log_temp

    def update(self, grad: Tensor) -> None:
        """One clip-then-Adam step with the knots' gradient."""
        grad = grad.clone()
        clip_by_global_norm([grad], self.grad_clip)
        self.log_temp.grad = grad
        self.opt.step()


def optimize_schedule(
    ddpm: DDPM,
    train_data,
    init_log_temp,
    *,
    n_iters: int = 1000,
    batch_size: int = 1024,
    learning_rate: float = 1e-3,
    step_type: str = "ddim",
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
    clip_range: Optional[Tuple[float, float]] = None,
    grad_clip: float = 1.0,
    generator: Optional[torch.Generator] = None,
    log_every: int = 100,
    verbose: bool = True,
    feature_fn: Optional[Callable[[Tensor], Tensor]] = None,
    remat: bool = False,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Returns {"log_temp": optimized grid, "history": per-iter MMD}.

    Each iteration, as the JAX step: sort and clip the knots, the MMD
    between a generated batch and a random data batch (after the optional
    differentiable ``feature_fn``, e.g. a LeNet's feature head), its
    gradient in the knots, then optax's ``clip_by_global_norm`` and
    ``adam``. Runs on ``device`` (the model's by default, else the card);
    the data batches and the sampler's noise come from ``generator`` (on
    that device; seed 0 when None)."""
    dev = resolve_device(device if device is not None
                         else getattr(ddpm, "device", None))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    data = torch.as_tensor(train_data, dtype=torch.float32, device=dev)
    obj_size = tuple(data.shape[1:])
    data2d = data.reshape(data.shape[0], -1)
    n = data.shape[0]

    knots = Knots(init_log_temp, learning_rate, grad_clip, clip_range, dev)

    def loss_fn(lt: Tensor) -> Tensor:
        gen = sample_with_grid(ddpm, lt, generator, (batch_size, *obj_size),
                               step_type, remat=remat)
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=dev)
        ref = data2d[idx]
        if feature_fn is not None:
            gen2d = feature_fn(gen)
            ref2d = feature_fn(ref.reshape(batch_size, *obj_size))
        else:
            gen2d, ref2d = gen.reshape(batch_size, -1), ref
        return mmd_rbf(gen2d, ref2d, sigmas=tuple(sigmas))

    history = []
    for i in range(n_iters):
        log_temp = knots.project()
        loss = loss_fn(log_temp)
        (grad,) = torch.autograd.grad(loss, [log_temp])
        knots.update(grad)
        history.append(float(loss.detach()))
        if verbose and (i + 1) % log_every == 0:
            print(f"iter {i + 1}/{n_iters} mmd {history[-1]:.6f}")
    return {"log_temp": knots.projected().cpu().numpy(),
            "history": np.asarray(history)}
