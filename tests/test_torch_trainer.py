"""Port parity: the UNet trainer (pdm_tpu_torch.diffusion.trainer).

A tiny UNet (2 levels, head dim 16, 4 groups) with random JAX parameters
carried over by ``from_flax_params``:

* loss and every gradient of the port's ``loss_fn`` against
  ``jax.value_and_grad`` of the JAX ``loss_fn`` with the same tau and eps
  (JAX's own draws, eps transposed from NHWC): loss to 1e-5 relative,
  each gradient to 1e-5 of its own scale plus 1e-8 (fp32 sums in another
  order);
* three ``train_step``s against the JAX ``DDPMTrainer.train_step``
  (dropout 0, threefry noise, no warmup so the rate is constant, weight
  decay on, a clip that triggers on the first steps): loss and grad_norm
  to 1e-5 relative, params and EMA to 2e-6 absolute (Adam's steps are
  ~1e-3 each; the two differ by fp32 rounding only);
* ``warmup_linear_decay`` against JAX's at counts 0..total+5, 1e-6.

Port-only: the rate applied per step, clipping against optax, grad
accumulation, bf16 modules from fp32 masters, dropout, EMA models, and
checkpoints (round trip, retention, a resumed 3+3-step loop equal to an
uninterrupted 6-step one).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdm_tpu.diffusion.trainer import (
    DDPMTrainer as JTrainer, warmup_linear_decay as j_warmup,
)
from pdm_tpu.models.unet import unet_from_config as j_unet_from_config
from pdm_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
from pdm_tpu.schedulers.analytic import LinearBetaScheduler as JLinear

from pdm_tpu_torch.diffusion.trainer import (
    DDPMTrainer, clip_by_global_norm, learning_rate_schedule,
    warmup_linear_decay,
)
from pdm_tpu_torch.models.unet import dropout, unet_from_config
from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler
from torch_port_fixtures import two_torch_threads  # noqa: F401

TINY = {
    "block_out_channels": [16, 32],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
    "layers_per_block": 1,
    "attention_head_dim": 16,
    "norm_groups": 4,
    "dropout": 0.0,
}
OPT = dict(learning_rate=1e-3, weight_decay=1e-2, warmup_steps=0,
           total_iters=100, grad_clip=0.25, ema_decay=0.9)


def _sched():
    return LinearBetaScheduler(1e-4, 1e2)


def _port_trainer(dtype=torch.float32, cfg=None, **kw):
    net = unet_from_config(3, {**TINY, **(cfg or {})}, dtype=dtype,
                           device="cpu")
    return DDPMTrainer(UNetDDPM(_sched(), net, device="cpu"), **{**OPT, **kw})


def _x0(B=4, seed=1):
    return np.random.RandomState(seed).standard_normal(
        (B, 3, 16, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX trainer on the tiny UNet with random N(0, 0.1^2) params."""
    jnet = j_unet_from_config(3, TINY)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))[
            "params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
        shapes)
    jddpm = JUNetDDPM(scheduler=JLinear(1e-4, 1e2),
                      params=jax.tree_util.tree_map(jnp.asarray, params),
                      module=jnet)
    trainer = JTrainer(ddpm=jddpm, noise_rng_impl="threefry",
                       dropout_rng_impl="threefry", **OPT)
    return jddpm, trainer, params


def _jax_noise(jddpm, key, x0):
    """tau and eps as the JAX loss_fn draws them (key split, NHWC eps),
    eps transposed to the port's NCHW."""
    key_noise, _ = jax.random.split(key)
    tau, eps, _ = jddpm.scheduler.add_noise(
        key_noise, jnp.transpose(jnp.asarray(x0), (0, 2, 3, 1)))
    return (torch.from_numpy(np.array(tau)),
            torch.from_numpy(np.array(eps).transpose(0, 3, 1, 2)))


def test_loss_and_gradients_match_jax(jax_setup):
    jddpm, jtrainer, params = jax_setup
    x0 = _x0()
    key = jax.random.PRNGKey(3)
    (want_loss, _), want_g = jax.jit(jax.value_and_grad(
        jtrainer.loss_fn, has_aux=True))(
        jddpm.params, key, jnp.asarray(x0))
    tau, eps = _jax_noise(jddpm, key, x0)
    tr = _port_trainer()
    tr.ddpm.module.load_state_dict(from_flax_params(params))
    tr.ddpm.train()
    loss = tr.loss_fn(torch.from_numpy(x0), tau=tau, eps=eps)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = from_flax_params(jax.device_get(want_g))
    got = dict(tr.ddpm.module.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        # + 1e-8: to_k.bias's gradient is zero in exact arithmetic (the
        # softmax ignores a shift of every key), rounding noise in both
        scale = float(w.abs().max())
        err = float((got[name].grad - w).abs().max())
        assert err <= 1e-5 * scale + 1e-8, (name, err, scale)


def test_three_train_steps_match_jax(jax_setup):
    _three_steps_against_jax(jax_setup)


def test_three_train_steps_with_the_fused_block_match_jax(jax_setup,
                                                          monkeypatch):
    """PDM_FUSED_BLOCK=1: the port's attention blocks run the whole-block
    path (its plain forward and backward on the CPU) against the JAX
    trainer's standard XLA path (JAX's gate stays closed off the TPU), to
    the same tolerances."""
    from pdm_tpu_torch.ops import attention_block as tb

    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    calls = []
    real = tb.attention_block_bwd
    monkeypatch.setattr(tb, "attention_block_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _three_steps_against_jax(jax_setup)
    assert len(calls) == 3 * 4  # four attention blocks, three steps


def _three_steps_against_jax(jax_setup):
    jddpm, jtrainer, params = jax_setup
    jstate = jtrainer.init_state()
    tr = _port_trainer()
    state = tr.init_state(from_flax_params(params))
    x0 = _x0()
    clipped = []
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        tau, eps = _jax_noise(jddpm, key, x0)
        jstate, jm = jtrainer.train_step(jstate, key, jnp.asarray(x0))
        state, m = tr.train_step(state, torch.from_numpy(x0), tau=tau, eps=eps)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert m["learning_rate"] == OPT["learning_rate"]
        clipped.append(float(m["grad_norm"]) >= OPT["grad_clip"])
    assert any(clipped) and not all(clipped)  # both branches of the clip
    assert state.step == int(jstate.step) == 3
    for mine, theirs in ((state.params, jstate.params),
                         (state.ema_params, jstate.ema_params)):
        want = from_flax_params(jax.device_get(theirs))
        for name, w in want.items():
            err = float((mine[name] - w).abs().max())
            assert err <= 2e-6, (name, err)
    # the module's weights are the masters
    for name, p in tr.ddpm.module.named_parameters():
        assert torch.equal(p.detach(), state.params[name])


@pytest.mark.parametrize("lr,warmup,total", [
    (2e-4, 5000, 1_500_000), (1.0, 10, 110), (1e-4, 10, 1000), (3e-3, 1, 7),
])
def test_warmup_linear_decay_matches_jax(lr, warmup, total):
    mine, theirs = warmup_linear_decay(lr, warmup, total), j_warmup(lr, warmup, total)
    counts = sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                     total - 1, total, total + 5, *range(0, 40, 3)})
    for c in counts:
        np.testing.assert_allclose(mine(c), float(theirs(c)), rtol=1e-6,
                                   atol=1e-12)


def test_applied_learning_rate_per_step():
    """With warmup the first update applies rate 0 (as optax's schedule at
    count 0), so the params do not move; with none the rate is constant
    (the JAX trainer's log would show the decay schedule instead)."""
    assert [learning_rate_schedule(1.0, 0, 10)(c) for c in (0, 5, 10)] == [1.0] * 3
    tr = _port_trainer(warmup_steps=2, total_iters=10)
    state = tr.init_state()
    before = {k: v.clone() for k, v in state.params.items()}
    x0 = torch.from_numpy(_x0())
    rates = []
    for i in range(3):
        state, m = tr.train_step(state, x0, torch.Generator().manual_seed(i))
        rates.append(m["learning_rate"])
        if i == 0:
            assert all(torch.equal(state.params[k], v) for k, v in before.items())
    assert rates == [0.0, 5e-4, 1e-3]


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(2)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    norm = clip_by_global_norm(grads := [torch.from_numpy(a.copy()) for a in arrays],
                               max_norm)
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update([jnp.asarray(a) for a in arrays], tx.init(None))
    np.testing.assert_allclose(float(norm), float(optax.global_norm(arrays)),
                               rtol=1e-6)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_grad_accum_matches_one_batch():
    """Two micro-batches, averaged in fp32, give the one-batch step (same
    tau and eps) up to summation order."""
    x0 = torch.from_numpy(_x0(B=4, seed=5))
    g = torch.Generator().manual_seed(0)
    tau, eps = torch.rand(4, generator=g), torch.randn(4, 3, 16, 16, generator=g)
    out = {}
    for a in (1, 2):
        tr = _port_trainer(grad_accum=a)
        torch.manual_seed(0)
        state = tr.init_state({k: torch.randn_like(v) * 0.1 for k, v in
                               tr.ddpm.module.named_parameters()})
        state, m = tr.train_step(state, x0, tau=tau, eps=eps)
        out[a] = (float(m["loss"]), float(m["grad_norm"]), state.params)
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-6)
    np.testing.assert_allclose(out[2][1], out[1][1], rtol=1e-5)
    for k, v in out[1][2].items():
        assert float((out[2][2][k] - v).abs().max()) <= 1e-6, k


def test_fused_block_grad_accum_and_checkpoint(tmp_path, monkeypatch):
    """With PDM_FUSED_BLOCK=1: two micro-batches give the one-batch step,
    and a checkpoint saved after it resumes to the same next step."""
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    x0 = torch.from_numpy(_x0(B=4, seed=6))
    g = torch.Generator().manual_seed(1)
    tau, eps = torch.rand(4, generator=g), torch.randn(4, 3, 16, 16, generator=g)
    rng = np.random.RandomState(8)
    init = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.1)
                                .astype(np.float32))
            for k, v in _port_trainer().ddpm.module.named_parameters()}
    out = {}
    for a in (1, 2):
        tr = _port_trainer(grad_accum=a, checkpoint_dir=str(tmp_path / str(a)))
        state, m = tr.train_step(tr.init_state(init), x0, tau=tau, eps=eps)
        out[a] = (float(m["loss"]), float(m["grad_norm"]), state.params)
        tr.save_checkpoint(state, state.step)
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-6)
    np.testing.assert_allclose(out[2][1], out[1][1], rtol=1e-5)
    for k, v in out[1][2].items():
        assert float((out[2][2][k] - v).abs().max()) <= 1e-6, k
    tr = _port_trainer(checkpoint_dir=str(tmp_path / "1"))
    state = tr.load_checkpoint(tr.init_state(), tr.latest_checkpoint_step())
    assert all(torch.equal(state.params[k], v) for k, v in out[1][2].items())
    a, _ = tr.train_step(state, x0, torch.Generator().manual_seed(9))
    tr2 = _port_trainer(checkpoint_dir=str(tmp_path / "1"))
    b, _ = tr2.train_step(tr2.load_checkpoint(tr2.init_state(), 1), x0,
                          torch.Generator().manual_seed(9))
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_bf16_module_trains_from_fp32_masters():
    """fp32 masters are kept exactly; the bf16 module's weights are their
    rounding after init and after every step; gradients reach the masters
    in fp32."""
    tr = _port_trainer(dtype=torch.bfloat16)
    rng = np.random.RandomState(4)
    params = {k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
        for k, v in tr.ddpm.module.named_parameters()}
    state = tr.init_state(params)
    assert all(torch.equal(state.params[k], v) for k, v in params.items())
    state, m = tr.train_step(state, torch.from_numpy(_x0()),
                             torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    for name, p in tr.ddpm.module.named_parameters():
        master = state.params[name]
        assert master.dtype == torch.float32
        assert torch.equal(p.detach(), master.to(p.dtype)), name
    moved = sum(float((state.params[k] - v).abs().max()) > 0
                for k, v in params.items())
    assert moved == len(params)


def test_dropout_rate_masks_and_generator():
    """flax semantics: kept with probability 1 - rate, kept values divided
    by 1 - rate; masks from the generator passed in (the same seed gives
    the same mask); train mode without a generator raises; eval mode and
    ``UNetDDPM.forward`` apply none."""
    h = torch.ones(4, 8, 16, 16)
    y = dropout(h, 0.2, torch.Generator().manual_seed(0))
    kept = float((y != 0).float().mean())
    n = h.numel()
    assert abs(kept - 0.8) <= 4 * np.sqrt(0.2 * 0.8 / n)  # 4 sigma
    assert torch.allclose(y[y != 0], torch.tensor(1.0 / 0.8))
    assert torch.equal(y, dropout(h, 0.2, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, dropout(h, 0.2, torch.Generator().manual_seed(1)))

    tr = _port_trainer(cfg={"dropout": 0.5})
    net, ddpm = tr.ddpm.module, tr.ddpm
    x, tau = torch.randn(2, 3, 16, 16), torch.rand(2)
    ddpm.train()
    with pytest.raises(ValueError, match="Generator"):
        net(x, tau)
    a = net(x, tau, torch.Generator().manual_seed(3))
    b = net(x, tau, torch.Generator().manual_seed(3))
    c = net(x, tau, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    ddpm.eval()
    with torch.no_grad():
        assert torch.equal(net(x, tau), net(x, tau))
        assert torch.equal(ddpm(x, tau), ddpm(x, tau))


def test_with_params_builds_an_eval_model_and_leaves_this_one():
    tr = _port_trainer(cfg={"dropout": 0.5})
    ema = {k: torch.full_like(v, 0.01, dtype=torch.float32)
           for k, v in tr.ddpm.module.named_parameters()}
    tr.ddpm.train()
    other = tr.ddpm.with_params(ema)
    assert not other.module.training and tr.ddpm.module.training
    for name, p in other.module.named_parameters():
        assert torch.equal(p.detach(), ema[name])
        assert not torch.equal(dict(tr.ddpm.module.named_parameters())[name]
                               .detach(), ema[name])
    x = torch.randn(2, 3, 16, 16)
    with torch.no_grad():
        assert torch.equal(other(x, 0.3), other(x, 0.3))


def test_checkpoint_round_trip(tmp_path):
    tr = _port_trainer(checkpoint_dir=str(tmp_path))
    state = tr.init_state()
    x0 = torch.from_numpy(_x0())
    for i in range(2):
        state, _ = tr.train_step(state, x0, torch.Generator().manual_seed(i))
    tr.save_checkpoint(state, 2)
    assert tr.latest_checkpoint_step() == 2
    assert sorted(os.listdir(tmp_path)) == ["latest.txt", "step_2"]
    tr2 = _port_trainer(checkpoint_dir=str(tmp_path))
    restored = tr2.load_checkpoint(tr2.init_state(), 2)
    assert restored.step == 2
    for key in ("params", "ema_params"):
        for name, v in getattr(state, key).items():
            assert torch.equal(getattr(restored, key)[name], v)
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st[k], sb["state"][i][k])
    for name, p in tr2.ddpm.module.named_parameters():
        assert torch.equal(p.detach(), state.params[name])
    # one more step from either gives the same state
    a, _ = tr.train_step(state, x0, torch.Generator().manual_seed(9))
    b, _ = tr2.train_step(restored, x0, torch.Generator().manual_seed(9))
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_checkpoint_retention(tmp_path):
    """keep_checkpoints prunes older step_{n} dirs after each publish; the
    published one survives and restores; None keeps everything."""
    tr = _port_trainer(checkpoint_dir=str(tmp_path / "a"), keep_checkpoints=2)
    os.makedirs(tmp_path / "a")
    state = tr.init_state()
    for step in (5, 10, 15, 20):
        state.step = step
        tr.save_checkpoint(state, step)
    kept = sorted(d for d in os.listdir(tmp_path / "a") if d.startswith("step_"))
    assert kept == ["step_15", "step_20"]
    assert tr.latest_checkpoint_step() == 20
    assert tr.load_checkpoint(tr.init_state(), 20).step == 20
    tr2 = _port_trainer(checkpoint_dir=str(tmp_path / "b"))
    os.makedirs(tmp_path / "b")
    for step in (1, 2, 3):
        tr2.save_checkpoint(state, step)
    assert sorted(d for d in os.listdir(tmp_path / "b")
                  if d.startswith("step_")) == ["step_1", "step_2", "step_3"]


def test_resumed_loop_equals_uninterrupted(tmp_path):
    """train() to step 3 with a checkpoint, then a fresh trainer resumes to
    step 6: the same state and the same logged losses as one 6-step run
    (step-keyed batches, flips, noise and dropout masks)."""
    data = torch.from_numpy(np.random.RandomState(7).standard_normal(
        (32, 3, 16, 16)).astype(np.float32))
    cfg = {"dropout": 0.3}
    logs = {"once": {}, "resumed": {}}

    def make(log, ckpt):
        return _port_trainer(cfg=cfg, checkpoint_dir=str(ckpt),
                             checkpoint_every=3, horizontal_flip=True,
                             warmup_steps=2, total_iters=6,
                             log_fn=lambda s, m: log.__setitem__(s, m))

    os.makedirs(tmp_path / "once")
    os.makedirs(tmp_path / "resumed")
    init = {k: v.detach().clone() for k, v in
            make({}, tmp_path).ddpm.module.named_parameters()}
    once = make(logs["once"], tmp_path / "once").train(
        data, 8, total_iters=6, log_every=1, params=init)
    first = make(logs["resumed"], tmp_path / "resumed")
    assert first.train(data, 8, total_iters=3, log_every=1, params=init).step == 3
    assert not first.ddpm.module.training
    resumed = make(logs["resumed"], tmp_path / "resumed").train(
        data, 8, total_iters=6, log_every=1, params=init)
    assert resumed.step == once.step == 6
    assert logs["resumed"] == logs["once"] and len(logs["once"]) == 6
    for key in ("params", "ema_params"):
        for name, v in getattr(once, key).items():
            assert torch.equal(getattr(resumed, key)[name], v), name
