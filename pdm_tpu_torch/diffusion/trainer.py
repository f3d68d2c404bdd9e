"""DDPM trainer for the UNet: noise draw, forward, MSE, backward, global-norm
clipping, Adam, EMA, checkpoints with auto-resume.

Counterpart of ``pdm_tpu/diffusion/trainer.py``, with the same optimizer
chain (``make_optimizer``: clip by global norm, coupled L2 weight decay,
Adam with eps 1e-8, then the learning rate, constant when there is no
warmup), the same loss (MSE of the fp32 network output against the
parametrization target of uniform-tau noised data), the same EMA
(``optax.incremental_update``: a lerp toward the new parameters by
1 - decay) and the same checkpoint contract (``step_{n}`` directories,
``latest.txt`` written only after a save is complete, ``keep_checkpoints``
retention that never touches the published save).

Mixed precision as flax does it: the trainer keeps fp32 master parameters
(``TrainState.params``); the module's weights, in its compute dtype, are
copies refreshed after every optimizer step, and the gradients are the
module's gradients cast to fp32 (the VJP of flax's cast at use). An fp32
module is the same code with casts that do nothing.

Randomness comes from ``torch.Generator``s: a step draws its noise (tau,
then eps) and its dropout masks from the generator it is given, or takes
``tau`` and ``eps`` explicitly. ``train`` seeds one generator per step
from (seed, step), so a resumed run draws what an uninterrupted one does.

State is updated in place: ``train_step`` returns the state it was given,
advanced one step.

Not ported (see ROADMAP.md): ``mesh``, ``fsdp`` and ``model_partition``
(torch.distributed), host-resident data and the ``timer`` hook. JAX's
``noise_rng_impl``, ``dropout_rng_impl`` and ``compiler_options`` choose a
JAX PRNG or XLA flags and have no counterpart; ``data_layout`` has none
either, since the port's UNet takes NCHW (in channels_last memory) and
no layout transpose is ever applied.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core.temperature import alpha_bar_from_log_temp
from ..models.predictions import training_target
from ..models.unet_ddpm import UNetDDPM

ADAM_EPS = 1e-8  # optax.scale_by_adam's default


@dataclasses.dataclass
class TrainState:
    """``params`` and ``ema_params`` are fp32 tensors keyed as the module's
    ``named_parameters``; ``optimizer`` is the Adam over ``params`` and
    holds the moments (the JAX ``opt_state``)."""

    step: int
    params: Dict[str, Tensor]
    ema_params: Dict[str, Tensor]
    optimizer: torch.optim.Adam


def warmup_linear_decay(
    learning_rate: float, warmup_steps: int, total_iters: int
) -> Callable[[int], float]:
    """Linear 0 -> lr over warmup, then linear lr -> 0 at total_iters."""

    def schedule(count: int) -> float:
        count = float(count)
        warm = count / max(1.0, warmup_steps)
        decay = max(0.0, (total_iters - count)
                    / max(1.0, total_iters - warmup_steps))
        return learning_rate * (warm if count < warmup_steps else decay)

    return schedule


def learning_rate_schedule(
    learning_rate: float, warmup_steps: int, total_iters: int
) -> Callable[[int], float]:
    """The rate that update ``count`` applies (0 for the first), as the JAX
    ``make_optimizer`` schedules it: :func:`warmup_linear_decay` with a
    warmup, else constant. (With no warmup the JAX trainer logs the decay
    schedule's rate while it applies the constant one; the port logs the
    rate it applies.)"""
    if warmup_steps > 0:
        return warmup_linear_decay(learning_rate, warmup_steps, total_iters)
    return lambda count: learning_rate


def make_optimizer(
    params: List[Tensor],
    learning_rate: float,
    weight_decay: float,
    betas: Tuple[float, float],
) -> torch.optim.Adam:
    """Adam over ``params`` with coupled L2 weight decay (added to the
    gradient before the moments, as ``optax.add_decayed_weights`` before
    ``scale_by_adam``) and eps 1e-8. The JAX chain's other links are
    :func:`clip_by_global_norm`, first, and the rate of
    :func:`learning_rate_schedule`, set before each step."""
    return torch.optim.Adam(params, lr=learning_rate, betas=betas,
                            eps=ADAM_EPS, weight_decay=weight_decay)


def clip_by_global_norm(grads: List[Tensor], max_norm: float) -> Tensor:
    """``optax.clip_by_global_norm`` in place: each g becomes
    ``g / norm * max_norm`` when ``norm >= max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the unclipped norm
    (``optax.global_norm``). The choice is made on the device: no host
    sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if max_norm > 0:
        keep = norm < max_norm
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        limit = torch.full((), max_norm, dtype=norm.dtype, device=norm.device)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, limit))
    return norm


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of training step ``step``, seeded from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


@dataclasses.dataclass
class DDPMTrainer:
    ddpm: UNetDDPM
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    warmup_steps: int = 5000
    total_iters: int = 1_500_000
    grad_clip: float = 10.0
    ema_decay: float = 0.9999
    checkpoint_dir: Optional[str] = None
    eval_steps: int = 50_000
    eval_fn: Optional[Callable[[UNetDDPM, int], Dict[str, float]]] = None
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None
    checkpoint_every: Optional[int] = None  # defaults to eval_steps
    # keep this many newest complete checkpoints (the published one always
    # survives); None keeps everything
    keep_checkpoints: Optional[int] = None
    horizontal_flip: bool = False
    # split each batch into this many sequential micro-batches; their fp32
    # gradients are summed and averaged before one optimizer step
    grad_accum: int = 1

    def __post_init__(self):
        self.learning_rate_at = learning_rate_schedule(
            self.learning_rate, self.warmup_steps, self.total_iters)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_state(self, params: Optional[Mapping[str, Tensor]] = None
                   ) -> TrainState:
        """fp32 masters from ``params`` (a state dict such as
        ``from_flax_params``' or an fp32 checkpoint; it is copied without
        rounding) or, when None, from the module's own weights; the module
        is then loaded from them. A bf16 module's own weights are already
        rounded, so pass the fp32 parameters where there are any."""
        module = self.ddpm.module
        names = [name for name, _ in module.named_parameters()]
        src = dict(module.named_parameters()) if params is None else params
        if set(src) != set(names):
            raise KeyError(f"params do not match the module: missing "
                           f"{sorted(set(names) - set(src))}, unexpected "
                           f"{sorted(set(src) - set(names))}")
        device = self.ddpm.device
        masters = {name: src[name].detach().to(device=device,
                                               dtype=torch.float32, copy=True)
                   for name in names}
        ema = {name: t.clone() for name, t in masters.items()}
        opt = make_optimizer(list(masters.values()), self.learning_rate,
                             self.weight_decay, self.betas)
        state = TrainState(step=0, params=masters, ema_params=ema,
                           optimizer=opt)
        self._load_module(state)
        return state

    def _load_module(self, state: TrainState) -> None:
        """The module's weights (compute dtype) from the fp32 masters."""
        with torch.no_grad():
            torch._foreach_copy_(list(self.ddpm.module.parameters()),
                                 list(state.params.values()))

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def loss_fn(self, x0: Tensor, generator: Optional[torch.Generator] = None,
                tau: Optional[Tensor] = None,
                eps: Optional[Tensor] = None) -> Tensor:
        """MSE of the network output against the parametrization target.
        ``x0`` is NCHW; tau, then eps, then the dropout masks are drawn
        from ``generator`` unless given."""
        sched = self.ddpm.scheduler
        tau, eps, xt = sched.add_noise(x0, tau, generator=generator, eps=eps)
        ab = alpha_bar_from_log_temp(sched.log_temp_from_tau(tau))
        pred = self.ddpm.module(xt, tau, generator)
        target = training_target(x0, eps, ab, self.ddpm.parametrization)
        return torch.mean(torch.square(pred - target.to(pred.dtype)))

    def _grads(self, x0, generator, tau, eps) -> Tuple[Tensor, List[Tensor]]:
        """Mean loss and fp32 gradients over ``grad_accum`` micro-batches."""
        module = self.ddpm.module
        params = list(module.parameters())
        a = self.grad_accum
        if x0.shape[0] % a:
            raise ValueError(f"batch {x0.shape[0]} is not divisible by "
                             f"grad_accum={a}")
        m = x0.shape[0] // a
        loss_sum, grads = None, None
        for i in range(a):
            sl = slice(i * m, (i + 1) * m)
            loss = self.loss_fn(
                x0[sl], generator, None if tau is None else tau[sl],
                None if eps is None else eps[sl])
            loss.backward()
            g = [p.grad.float() for p in params]
            module.zero_grad(set_to_none=True)
            if grads is None:
                loss_sum, grads = loss.detach(), g
            else:
                loss_sum = loss_sum + loss.detach()
                torch._foreach_add_(grads, g)
        if a > 1:
            torch._foreach_mul_(grads, 1.0 / a)
            loss_sum = loss_sum * (1.0 / a)
        return loss_sum, grads

    def train_step(
        self, state: TrainState, x0: Tensor,
        generator: Optional[torch.Generator] = None, *,
        tau: Optional[Tensor] = None, eps: Optional[Tensor] = None,
    ) -> Tuple[TrainState, Dict[str, object]]:
        """One optimizer step on the NCHW batch ``x0``. Puts the module in
        train mode (it stays there; ``ddpm.eval()`` ends it). Returns the
        state and {"loss", "grad_norm"} as 0-d device tensors (grad_norm of
        the unclipped gradients) and the applied "learning_rate"."""
        module = self.ddpm.module
        if not module.training:
            module.train()
        module.zero_grad(set_to_none=True)
        loss, grads = self._grads(x0, generator, tau, eps)
        grad_norm = clip_by_global_norm(grads, self.grad_clip)
        masters = list(state.params.values())
        for p, g in zip(masters, grads):
            p.grad = g
        lr = self.learning_rate_at(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        for p in masters:
            p.grad = None
        with torch.no_grad():
            torch._foreach_copy_(list(module.parameters()), masters)
            torch._foreach_lerp_(list(state.ema_params.values()), masters,
                                 1.0 - self.ema_decay)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "learning_rate": lr}

    # ------------------------------------------------------------------
    # checkpoints (torch files; resume contract = the JAX trainer's)
    # ------------------------------------------------------------------

    def save_checkpoint(self, state: TrainState, step: int) -> None:
        """Write ``step_{step}/state.pt`` (blocking), then publish it in
        ``latest.txt`` and prune to ``keep_checkpoints``."""
        if self.checkpoint_dir is None:
            return
        path = os.path.join(self.checkpoint_dir, f"step_{step}")
        os.makedirs(path, exist_ok=True)
        payload = {
            "step": state.step,
            "params": {k: v.detach().cpu() for k, v in state.params.items()},
            "ema_params": {k: v.detach().cpu()
                           for k, v in state.ema_params.items()},
            "optimizer": state.optimizer.state_dict(),
        }
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        latest = os.path.join(self.checkpoint_dir, "latest.txt")
        with open(latest + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(latest + ".tmp", latest)
        self._prune_checkpoints(published=step)

    def _prune_checkpoints(self, published: int) -> None:
        """Delete ``step_{n}`` dirs beyond the ``keep_checkpoints`` newest.
        Only steps older than the published one are candidates, and the
        published one counts toward the budget and always survives."""
        if self.keep_checkpoints is None or self.checkpoint_dir is None:
            return
        steps = []
        for name in os.listdir(self.checkpoint_dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and int(m.group(1)) < published:
                steps.append(int(m.group(1)))
        steps.sort(reverse=True)
        for s in steps[max(self.keep_checkpoints - 1, 0):]:
            shutil.rmtree(os.path.join(self.checkpoint_dir, f"step_{s}"),
                          ignore_errors=True)

    def latest_checkpoint_step(self) -> Optional[int]:
        if self.checkpoint_dir is None:
            return None
        latest = os.path.join(self.checkpoint_dir, "latest.txt")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            return int(f.read().strip())

    def load_checkpoint(self, state: TrainState, step: int) -> TrainState:
        """Restore ``step_{step}`` into ``state`` (its tensors keep their
        device) and reload the module's weights from the masters."""
        path = os.path.join(self.checkpoint_dir, f"step_{step}", "state.pt")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for key in ("params", "ema_params"):
                dst, src = getattr(state, key), payload[key]
                if set(dst) != set(src):
                    raise KeyError(f"checkpoint {path} {key} do not match "
                                   f"the model")
                for name, t in dst.items():
                    t.copy_(src[name])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        self._load_module(state)
        return state

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def train(
        self,
        data: Tensor,
        batch_size: int,
        total_iters: Optional[int] = None,
        seed: int = 0,
        log_every: int = 100,
        params: Optional[Mapping[str, Tensor]] = None,
    ) -> TrainState:
        """Training loop over ``data`` (N, C, H, W) on the model's device,
        with auto-resume from ``latest.txt``. Step ``it`` draws its batch
        indices, flips, noise and dropout masks from
        ``step_generator(seed, it)``. ``params`` as in :meth:`init_state`.
        The module is back in eval mode when it returns."""
        total = total_iters or self.total_iters
        if batch_size % self.grad_accum:
            raise ValueError(f"batch_size={batch_size} is not divisible by "
                             f"grad_accum={self.grad_accum}")
        device = self.ddpm.device
        if data.device != device:
            raise ValueError(f"data must be on the model's device {device}: "
                             f"{data.device}")
        state = self.init_state(params)
        start = 0
        resume = self.latest_checkpoint_step()
        if resume is not None:
            state = self.load_checkpoint(state, resume)
            start = resume
        n = data.shape[0]
        ckpt_every = self.checkpoint_every or self.eval_steps
        self.ddpm.train()
        try:
            for it in range(start + 1, total + 1):
                gen = step_generator(seed, it, device)
                idx = torch.randint(0, n, (batch_size,), generator=gen,
                                    device=device)
                x0 = data.index_select(0, idx)
                if self.horizontal_flip:
                    flip = torch.rand((batch_size,), generator=gen,
                                      device=device) < 0.5
                    x0 = torch.where(flip[:, None, None, None], x0.flip(-1), x0)
                state, metrics = self.train_step(state, x0, gen)
                if self.log_fn is not None and it % log_every == 0:
                    self.log_fn(it, {k: float(v) for k, v in metrics.items()})
                if it % ckpt_every == 0:
                    self.save_checkpoint(state, it)
                if self.eval_fn is not None and it % self.eval_steps == 0:
                    ema_ddpm = self.ddpm.with_params(state.ema_params)
                    eval_metrics = self.eval_fn(ema_ddpm, it)
                    if self.log_fn is not None and eval_metrics:
                        self.log_fn(it, eval_metrics)
        finally:
            self.ddpm.eval()
        return state
