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

``train`` takes the dataset on the model's device, or a
``utils.data.HostResidentData`` kept in host memory: then step ``it``
gathers the rows ``np.random.default_rng((seed, it))`` names
(:func:`host_batch_indices`; with seed 0 the JAX trainer's own stream, so
both packages train on the same rows) and the flip still comes from the
step's generator. A ``timer`` (``utils.profiling.PhaseTimer``) times the
"data" and "train_step" phases of each step, the latter up to the card's
completion of the step.

State is updated in place: ``train_step`` returns the state it was given,
advanced one step.

Over a data mesh (``train(mesh=)``, ``parallel/``) every rank runs this
loop with the same seeds. Step ``it`` draws the global batch's indices,
flips, tau, eps and dropout masks from the step's generator, as one
process does, and each rank keeps its rows of every micro-batch
(``core/draws.py``), so the run does not depend on the number of ranks;
a host-resident dataset gathers only the rank's rows. The fp32
gradients and the loss are all-reduced in one flat buffer (one call a
step) and averaged, then clipped and stepped identically on every rank.
``fsdp=True`` keeps the fp32 masters, the EMA and both Adam moments
sharded: each parameter is cut along the dimension JAX's ``_with_fsdp``
picks for it in JAX's layout (``parallel.mesh.port_params_sharding``), so a
rank holds 1/R of every parameter with such a dimension and the whole of
the rest (as JAX leaves them); after each step one all-gather of the
updated shards refreshes the module's compute-dtype weights. Unlike
JAX's ZeRO-3 the module's weights and the step's gradient are whole on
every rank (the gradient is all-reduced, not reduce-scattered, and the
weights are not gathered layer by layer). Under a mesh only rank 0
writes checkpoints, whole and in the files one process writes (a save
from a mesh resumes in one process and the other way round), and every
rank waits until it has. The caller gives ``log_fn`` to rank 0 alone and
``eval_fn`` to every rank: each rank enters the hook at the same steps,
so none waits in the next step's gradient all-reduce (bounded by the
process group's timeout) while another evaluates; the port's hook
(``utils.logging.make_eval_fn(mesh=)``) shares the sampling and FID's
features over the ranks, rank 0 writing (``scripts/train_diffusion.py``).

A mesh with a model axis above 1 trains the model-parallel UNet
(``parallel/model_parallel.py``, JAX's ``model_partition``: "channel" or
"spatial"): ``init_state(mesh=)`` swaps ``ddpm`` for one whose module is
``unet_with_model_parallel`` of it, and the masters, EMA and moments follow
``parallel.mesh.port_params_sharding`` (under "channel" a weight whose
output channels divide holds this rank's; with ``fsdp`` the data axis
cuts each leaf's largest remaining dimension as well). The ranks of a
model group take the same images; under "spatial" each keeps its rows of
the noised batch and of the target. Each rank back-propagates 1/m of its
loss, so a sharded weight's gradient is complete on its rank and a whole
leaf's (a bias, a GroupNorm scale, ``conv_out`` under "channel"; every
leaf under "spatial") is summed over the model group, after the data
axis's all-reduce. The clip norm is the global norm: the sharded leaves'
squares are summed over the model group, the whole leaves counted once.
The trainer then keeps no whole copy of the weights on the card: the
whole model it keeps for the eval hook (``base_ddpm``) is its layers on
the meta device, which the hook fills with the gathered EMA weights, and
its ``params`` (the fp32 weights the model was made from) move to the
host. A caller that keeps its own reference to the model keeps that
model's weights.

JAX's ``noise_rng_impl``, ``dropout_rng_impl`` and
``compiler_options`` choose a JAX PRNG or XLA flags and have no
counterpart; ``data_layout`` has none either, since the port's UNet takes
NCHW (in channels_last memory) and no layout transpose is ever applied.
"""

from __future__ import annotations

import contextlib
import copy
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
from ..models.unet import copy_layers
from ..models.unet_ddpm import UNetDDPM
from ..parallel.collectives import barrier
from ..parallel.collectives import all_gather
from ..parallel.mesh import (
    Mesh,
    Spec,
    batch_sharding,
    check_batch_divisible,
    port_params_sharding,
    rank,
    shard_leaf,
    unet_with_model_parallel,
)
from ..parallel.model_parallel import ModelParallelUNet
from ..utils.data import HostResidentData
from ..utils.profiling import PhaseTimer
from ..utils.timing import sync

ADAM_EPS = 1e-8  # optax.scale_by_adam's default


@dataclasses.dataclass
class TrainState:
    """``params`` and ``ema_params`` are fp32 tensors keyed as the module's
    ``named_parameters``; ``optimizer`` is the Adam over ``params`` and
    holds the moments (the JAX ``opt_state``). ``mesh`` is the mesh the
    state lives on; under FSDP or a model axis ``shard_specs`` holds each
    parameter's spec (``parallel.mesh.port_params_sharding``; () is whole)
    and ``params``, ``ema_params`` and the moments hold this rank's part
    of it."""

    step: int
    params: Dict[str, Tensor]
    ema_params: Dict[str, Tensor]
    optimizer: torch.optim.Adam
    mesh: Optional[Mesh] = None
    shard_specs: Optional[Dict[str, Spec]] = None


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


def clip_by_global_norm(grads: List[Tensor], max_norm: float,
                        norm: Optional[Tensor] = None) -> Tensor:
    """``optax.clip_by_global_norm`` in place: each g becomes
    ``g / norm * max_norm`` when ``norm >= max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the unclipped norm
    (``optax.global_norm``), ``grads``' own unless ``norm`` is given (the
    global norm of a model whose leaves are sharded). The choice is made
    on the device: no host sync."""
    if norm is None:
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


def host_batch_indices(it: int, n: int, batch_size: int, seed: int = 0
                       ) -> np.ndarray:
    """The rows step ``it`` gathers from a host-resident dataset of ``n``:
    keyed by (seed, it), so a run resumed at step k continues with draw
    k + 1. With seed 0 this is the JAX trainer's stream."""
    return np.random.default_rng((seed, it)).integers(0, n, batch_size)


_MOMENTS = ("exp_avg", "exp_avg_sq")  # Adam's state of each parameter


def _gather_axis(state: TrainState, tensors: Dict[str, Tensor], axis: str
                 ) -> Dict[str, Tensor]:
    """``tensors`` with each dim its spec cuts over ``axis`` gathered (one
    all-gather of them all over that axis's group)."""
    specs, mesh = state.shard_specs, state.mesh
    if specs is None:
        return tensors
    dims = {n: specs[n].index(axis) for n in tensors if axis in specs[n]}
    if not dims:
        return tensors
    if axis == "data":
        group, size, stats = mesh.data_group, mesh.data_size, mesh.stats
    else:
        group, size, stats = mesh.model_group, mesh.model_size, mesh.model_stats
    rows = all_gather(torch.cat([tensors[n].reshape(-1) for n in dims]),
                      group, size, stats).view(size, -1)
    out, at = dict(tensors), 0
    for n, dim in dims.items():
        t = tensors[n]
        whole = list(t.shape)
        whole[dim] *= size
        pieces = rows[:, at:at + t.numel()].reshape(size, *t.shape)
        out[n] = pieces.movedim(0, dim).reshape(whole)
        at += t.numel()
    return out


def _gather(state: TrainState, tensors: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The module's tensors from this rank's FSDP shards (one all-gather
    over the data axis); ``tensors`` itself on a state without them. Under
    a model axis they stay this rank's model shards: see
    :func:`whole_tensors`."""
    return _gather_axis(state, tensors, "data")


def whole_tensors(state: TrainState, tensors: Dict[str, Tensor]
                  ) -> Dict[str, Tensor]:
    """The whole model's tensors from this rank's shards: gathered over
    the data axis (FSDP), then over the model axis."""
    return _gather_axis(state, _gather(state, tensors), "model")


def _gather_optimizer(state: TrainState) -> dict:
    """The optimizer's state dict with whole moments, as one process's."""
    sd = state.optimizer.state_dict()
    if state.shard_specs is None or not sd["state"]:
        return sd
    names = list(state.params)
    st = sd["state"]
    whole = {k: whole_tensors(state, {names[i]: s[k] for i, s in st.items()})
             for k in _MOMENTS}
    return {**sd, "state": {
        i: {**s, **{k: whole[k][names[i]] for k in _MOMENTS}}
        for i, s in st.items()}}


def _local_rows(batch_size: int, grad_accum: int, mesh: Optional[Mesh]
                ) -> Optional[np.ndarray]:
    """The positions in a global batch of this rank's rows: its part of
    each micro-batch, in order (None: all of them)."""
    if mesh is None:
        return None
    shard = batch_sharding(mesh)
    m = batch_size // grad_accum
    part = np.arange(m)[shard.rows(m)]
    return np.concatenate([i * m + part for i in range(grad_accum)])


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
    # times the "data" and "train_step" phases of every step
    timer: Optional[PhaseTimer] = None
    # what a model axis above 1 shards (channel | spatial), and FSDP
    model_partition: str = "channel"
    fsdp: bool = False

    def __post_init__(self):
        self.learning_rate_at = learning_rate_schedule(
            self.learning_rate, self.warmup_steps, self.total_iters)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def base_ddpm(self) -> UNetDDPM:
        """The whole model: ``ddpm`` itself, or, once ``init_state``
        partitioned it over a model axis, its layers on the meta device
        (no weights; ``with_params`` gives them storage) and its
        ``params`` on the host."""
        return getattr(self, "_base_ddpm", self.ddpm)

    def _model_parallel(self, mesh: Optional[Mesh]) -> None:
        """``ddpm`` over the mesh's model axis: the model-parallel UNet of
        the whole model's module (once: a trainer is partitioned over one
        mesh), or the whole model itself."""
        module = self.ddpm.module
        if isinstance(module, ModelParallelUNet):
            if mesh is module.mesh and self.model_partition == module.partition:
                return
            raise ValueError(
                "this trainer's model is partitioned over another mesh's "
                "model axis or partition; make a new trainer")
        if mesh is None or mesh.model_size <= 1:
            return
        base = self.ddpm
        skeleton = copy.copy(base)
        skeleton.module = copy_layers(module, lambda t: t.to("meta"))
        if base.params is not None:
            skeleton.params = {k: v.detach().cpu() for k, v in base.params.items()}
        self._base_ddpm = skeleton
        self.ddpm = UNetDDPM(
            base.scheduler,
            unet_with_model_parallel(module, mesh, self.model_partition),
            base.parametrization, base.tau_scale, device=base.device)

    def init_state(self, params: Optional[Mapping[str, Tensor]] = None,
                   mesh: Optional[Mesh] = None) -> TrainState:
        """fp32 masters from ``params`` (a state dict such as
        ``from_flax_params``' or an fp32 checkpoint; it is copied without
        rounding) or, when None, from the model's fp32 ``params`` (the
        weights it was made from), else the module's own weights; the
        module is then loaded from them. A bf16 module's own weights are
        rounded, so the first two come first. With ``mesh`` and ``fsdp``
        the masters, EMA and moments keep this rank's shards; with a model
        axis above 1 the module becomes the model-parallel UNet and they
        keep this rank's part of it too."""
        self._model_parallel(mesh)
        base = self.base_ddpm()
        names = [name for name, _ in base.module.named_parameters()]
        src = params if params is not None else base.params
        if src is None:
            module = self.ddpm.module
            src = (module.whole_state_dict()
                   if isinstance(module, ModelParallelUNet)
                   else dict(module.named_parameters()))
        if set(src) != set(names):
            raise KeyError(f"params do not match the module: missing "
                           f"{sorted(set(names) - set(src))}, unexpected "
                           f"{sorted(set(src) - set(names))}")
        device = self.ddpm.device
        specs = None
        fsdp = mesh is not None and self.fsdp and mesh.data_size > 1
        if fsdp or (mesh is not None and mesh.model_size > 1):
            specs = port_params_sharding(
                {n: tuple(src[n].shape) for n in names}, mesh,
                self.model_partition, fsdp=fsdp)
        masters = {}
        for name in names:
            t = src[name].detach().to(device=device, dtype=torch.float32)
            if specs is not None:
                t = shard_leaf(t, specs[name], mesh)
            masters[name] = t.clone()
        ema = {name: t.clone() for name, t in masters.items()}
        opt = make_optimizer(list(masters.values()), self.learning_rate,
                             self.weight_decay, self.betas)
        state = TrainState(step=0, params=masters, ema_params=ema,
                           optimizer=opt, mesh=mesh, shard_specs=specs)
        self._load_module(state)
        return state

    def _load_module(self, state: TrainState) -> None:
        """The module's weights (compute dtype) from the fp32 masters,
        gathered first under FSDP."""
        with torch.no_grad():
            torch._foreach_copy_(list(self.ddpm.module.parameters()),
                                 list(_gather(state, state.params).values()))

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
        target = training_target(x0, eps, ab, self.ddpm.parametrization)
        if getattr(self.ddpm.module, "partition", None) == "spatial":
            # this rank's rows of the noised images and of the target (all
            # of them where the model axis does not divide the height)
            height = xt.shape[2]
            xt, target = self._own_rows(xt), self._own_rows(target)
            pred = self.ddpm.module(xt, tau, generator, height=height)
        else:
            pred = self.ddpm.module(xt, tau, generator)
        return torch.mean(torch.square(pred - target.to(pred.dtype)))

    def _own_rows(self, t: Tensor) -> Tensor:
        """This rank's rows of whole images: H / m of them where the model
        axis m divides the height H, else all (every level then runs whole
        on every rank; each rank back-propagates 1/m of the same loss and
        the model group sums the whole leaves' gradients, which gives the
        one-device gradient)."""
        m, r = self.ddpm.module.model_size, self.ddpm.module.model_index
        if t.shape[2] % m:
            return t
        h = t.shape[2] // m
        return t[:, :, r * h:(r + 1) * h]

    def _grads(self, x0, generator, tau, eps, mesh: Optional[Mesh] = None
               ) -> Tuple[Tensor, List[Tensor]]:
        """Mean loss and fp32 gradients over ``grad_accum`` micro-batches;
        under a mesh ``x0`` holds this rank's rows of each, the draws are
        the global micro-batch's, and the mean is over all ranks."""
        module = self.ddpm.module
        params = list(module.parameters())
        a = self.grad_accum
        if x0.shape[0] % a:
            raise ValueError(f"batch {x0.shape[0]} is not divisible by "
                             f"grad_accum={a}")
        m = x0.shape[0] // a
        shard = None if mesh is None else batch_sharding(mesh)
        # each rank of a model group back-propagates 1/mp of its loss
        mp = 1 if mesh is None else mesh.model_size
        loss_sum, grads = None, None
        for i in range(a):
            sl = slice(i * m, (i + 1) * m)
            gen = generator if shard is None else shard.generator(
                generator, m * shard.size)
            loss = self.loss_fn(
                x0[sl], gen, None if tau is None else tau[sl],
                None if eps is None else eps[sl])
            (loss if mp == 1 else loss / mp).backward()
            g = [p.grad.float() for p in params]
            module.zero_grad(set_to_none=True)
            if grads is None:
                loss_sum, grads = loss.detach(), g
            else:
                loss_sum = loss_sum + loss.detach()
                torch._foreach_add_(grads, g)
        if mesh is not None:
            # one all-reduce a step: the gradients and the loss in one buffer
            flat = mesh.all_reduce(torch.cat(
                [g.reshape(-1) for g in grads] + [loss_sum.reshape(1)]))
            parts = flat.split([g.numel() for g in grads] + [1])
            grads = [p.view(g.shape) for p, g in zip(parts, grads)]
            loss_sum = parts[-1].reshape(())
            a *= mesh.data_size
        if mp > 1:
            # the whole leaves' parts and the losses, over the model group
            whole = [i for i, s in enumerate(self._leaf_specs())
                     if "model" not in s]
            flat = mesh.model_all_reduce(torch.cat(
                [grads[i].reshape(-1) for i in whole] + [loss_sum.reshape(1)]))
            parts = flat.split([grads[i].numel() for i in whole] + [1])
            for i, p in zip(whole, parts):
                grads[i] = p.view(grads[i].shape)
            loss_sum = parts[-1].reshape(()) * (1.0 / mp)
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
        the unclipped gradients) and the applied "learning_rate". On a
        state with a mesh, ``x0`` (and ``tau``, ``eps``) are this rank's
        rows of each micro-batch and ``generator`` the step's own; the
        metrics are the global batch's."""
        module = self.ddpm.module
        if not module.training:
            module.train()
        module.zero_grad(set_to_none=True)
        loss, grads = self._grads(x0, generator, tau, eps, state.mesh)
        grad_norm = clip_by_global_norm(grads, self.grad_clip,
                                        self._global_norm(grads, state.mesh))
        masters = list(state.params.values())
        if state.shard_specs is not None:
            grads = [shard_leaf(g, state.shard_specs[n], state.mesh, ("data",))
                     for n, g in zip(state.params, grads)]
        for p, g in zip(masters, grads):
            p.grad = g
        lr = self.learning_rate_at(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        for p in masters:
            p.grad = None
        with torch.no_grad():
            torch._foreach_lerp_(list(state.ema_params.values()), masters,
                                 1.0 - self.ema_decay)
        self._load_module(state)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "learning_rate": lr}

    def _leaf_specs(self) -> List[Spec]:
        """Each module parameter's spec over the model axis."""
        specs = getattr(self.ddpm.module, "specs", None)
        return [specs[n] if specs else ()
                for n, _ in self.ddpm.module.named_parameters()]

    def _global_norm(self, grads: List[Tensor], mesh: Optional[Mesh]
                     ) -> Optional[Tensor]:
        """The global norm of the whole model's gradients (None: the
        gradients are whole, :func:`clip_by_global_norm` takes their own):
        each leaf sharded over the model axis counted once through its
        shards' squares summed over the model group, each whole leaf
        once."""
        if mesh is None or mesh.model_size <= 1:
            return None
        sq = torch.stack(torch._foreach_norm(grads)).square()
        sharded = torch.tensor(["model" in s for s in self._leaf_specs()],
                               device=sq.device)
        parts = torch.stack([torch.where(sharded, sq, 0.0).sum(),
                             torch.where(sharded, 0.0, sq).sum()])
        parts[:1] = mesh.model_all_reduce(parts[:1].clone())
        return torch.sqrt(parts.sum())

    # ------------------------------------------------------------------
    # checkpoints (torch files; resume contract = the JAX trainer's)
    # ------------------------------------------------------------------

    def save_checkpoint(self, state: TrainState, step: int) -> None:
        """Write ``step_{step}/state.pt`` (blocking), then publish it in
        ``latest.txt`` and prune to ``keep_checkpoints``. Under a mesh the
        state is gathered whole, rank 0 writes it, and every rank returns
        once it is published."""
        if self.checkpoint_dir is None:
            return
        params = whole_tensors(state, state.params)
        ema = whole_tensors(state, state.ema_params)
        optimizer = _gather_optimizer(state)
        if state.mesh is None or rank() == 0:
            self._write_checkpoint(state.step, params, ema, optimizer, step)
        if state.mesh is not None:
            barrier()

    def _write_checkpoint(self, state_step, params, ema, optimizer,
                          step: int) -> None:
        path = os.path.join(self.checkpoint_dir, f"step_{step}")
        os.makedirs(path, exist_ok=True)
        payload = {
            "step": state_step,
            "params": {k: v.detach().cpu() for k, v in params.items()},
            "ema_params": {k: v.detach().cpu() for k, v in ema.items()},
            "optimizer": optimizer,
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
        device; under FSDP each rank takes its shards) and reload the
        module's weights from the masters."""
        path = os.path.join(self.checkpoint_dir, f"step_{step}", "state.pt")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        specs = state.shard_specs or {}

        def mine(name, t):  # this rank's part of a whole tensor
            return shard_leaf(t, specs[name], state.mesh) if specs else t

        with torch.no_grad():
            for key in ("params", "ema_params"):
                dst, src = getattr(state, key), payload[key]
                if set(dst) != set(src):
                    raise KeyError(f"checkpoint {path} {key} do not match "
                                   f"the model")
                for name, t in dst.items():
                    t.copy_(mine(name, src[name]))
        opt = payload["optimizer"]
        if specs:
            names = list(state.params)
            opt = {**opt, "state": {
                i: {k: (mine(names[i], v) if k in _MOMENTS else v)
                    for k, v in st.items()}
                for i, st in opt["state"].items()}}
        state.optimizer.load_state_dict(opt)
        state.step = int(payload["step"])
        self._load_module(state)
        return state

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def train(
        self,
        data,
        batch_size: int,
        total_iters: Optional[int] = None,
        seed: int = 0,
        log_every: int = 100,
        params: Optional[Mapping[str, Tensor]] = None,
        mesh: Optional[Mesh] = None,
    ) -> TrainState:
        """Training loop with auto-resume from ``latest.txt``. ``data`` is
        (N, C, H, W) on the model's device, or a ``HostResidentData`` whose
        device is the model's. Step ``it`` draws its batch indices (on the
        device path), flips, noise and dropout masks from
        ``step_generator(seed, it)``; a host-resident dataset's indices come
        from :func:`host_batch_indices`. ``params`` as in
        :meth:`init_state`. ``mesh``: the batch (and each micro-batch)
        shards over its 'data' axis, every rank holding the whole dataset.
        The module is back in eval mode when it returns."""
        total = total_iters or self.total_iters
        if batch_size % self.grad_accum:
            raise ValueError(f"batch_size={batch_size} is not divisible by "
                             f"grad_accum={self.grad_accum}")
        if mesh is not None:
            check_batch_divisible(batch_size, mesh)
            if self.grad_accum > 1:
                check_batch_divisible(batch_size // self.grad_accum, mesh,
                                      what="batch_size // grad_accum")
        rows = _local_rows(batch_size, self.grad_accum, mesh)
        device = self.ddpm.device
        mine = (slice(None) if rows is None
                else torch.from_numpy(rows).to(device))  # per-row draws
        host_resident = isinstance(data, HostResidentData)
        if data.device != device:
            raise ValueError(f"data must be on the model's device {device}: "
                             f"{data.device}")
        state = self.init_state(params, mesh)
        start = 0
        resume = self.latest_checkpoint_step()
        if resume is not None:
            state = self.load_checkpoint(state, resume)
            start = resume
        n = len(data)
        ckpt_every = self.checkpoint_every or self.eval_steps

        def phase(name):
            if self.timer is None:
                return contextlib.nullcontext()
            return self.timer.phase(name)

        self.ddpm.train()
        try:
            for it in range(start + 1, total + 1):
                gen = step_generator(seed, it, device)
                with phase("data"):
                    if host_resident:
                        idx = host_batch_indices(it, n, batch_size, seed)
                        x0 = data.device_batch(idx if rows is None else idx[rows])
                    else:
                        idx = torch.randint(0, n, (batch_size,), generator=gen,
                                            device=device)
                        x0 = data.index_select(0, idx[mine])
                    if self.horizontal_flip:
                        flip = torch.rand((batch_size,), generator=gen,
                                          device=device) < 0.5
                        x0 = torch.where(flip[mine][:, None, None, None],
                                         x0.flip(-1), x0)
                with phase("train_step"):
                    state, metrics = self.train_step(state, x0, gen)
                    if self.timer is not None:
                        sync(metrics)
                if self.log_fn is not None and it % log_every == 0:
                    self.log_fn(it, {k: float(v) for k, v in metrics.items()})
                if it % ckpt_every == 0:
                    self.save_checkpoint(state, it)
                if self.eval_fn is not None and it % self.eval_steps == 0:
                    ema_ddpm = self.base_ddpm().with_params(
                        whole_tensors(state, state.ema_params))
                    eval_metrics = self.eval_fn(ema_ddpm, it)
                    if self.log_fn is not None and eval_metrics:
                        self.log_fn(it, eval_metrics)
        finally:
            self.ddpm.eval()
        return state
