"""Port parity: the data-parallel and FSDP train step on 2 and 4 ranks
(gloo, CPU), against the JAX trainer under its mesh.

One launch per world size runs the steps on its ranks
(``torch_dist_workers.steps_suite``); the tests read its outputs.

* Three ``train_step``s on JAX's parameters and noise (the port's
  ``tests/test_torch_trainer.py`` setup: the tiny UNet, dropout 0, a clip
  that triggers), each rank given its rows of the batch, tau and eps,
  with and without FSDP, against the JAX trainer's steps under a mesh of
  as many virtual devices (data-parallel on 2, FSDP on 4: JAX's own tests
  hold the two equal): loss and grad_norm to 1e-5 relative, params and
  EMA to 2e-6 absolute (that test's tolerances; the sums over the batch
  are grouped by rank, fp32 rounding only). The FSDP step equals the
  data-parallel step within the same 2e-6.
* FSDP: each rank holds at most 1/R of the masters, EMA and both Adam
  moments, plus the parameters no dimension of which R divides.
* The byte bill of one step: one all-reduce of the fp32 gradients and the
  loss; under FSDP one all-gather of the updated shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdm_tpu.diffusion.trainer import DDPMTrainer as JTrainer
from pdm_tpu.models.unet import unet_from_config as j_unet_from_config
from pdm_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
from pdm_tpu.parallel.mesh import make_mesh as j_make_mesh, shard_batch
from pdm_tpu.schedulers.analytic import LinearBetaScheduler as JLinear

from pdm_tpu_torch.models.weights import from_flax_params
from torch_dist_workers import OPT, TINY, launch
from torch_port_fixtures import two_torch_threads  # noqa: F401

B = 8
JAX_FSDP = {2: False, 4: True}  # the JAX layout each world is held against


def _jax_setup():
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
    return jddpm, params


def _jax_noise(jddpm, key, x0):
    key_noise, _ = jax.random.split(key)
    tau, eps, _ = jddpm.scheduler.add_noise(
        key_noise, jnp.transpose(jnp.asarray(x0), (0, 2, 3, 1)))
    return np.array(tau), np.array(eps).transpose(0, 3, 1, 2)


def _jax_steps(jddpm, x0, world, fsdp):
    """Three JAX train steps under a mesh of ``world`` virtual devices."""
    trainer = JTrainer(ddpm=jddpm, noise_rng_impl="threefry",
                       dropout_rng_impl="threefry", fsdp=fsdp, **OPT)
    mesh = j_make_mesh(data=world, model=1, devices=jax.devices()[:world])
    metrics = []
    with mesh:
        state = trainer.init_state(mesh=mesh)
        for i in range(3):
            state, m = trainer.train_step(state, jax.random.PRNGKey(10 + i),
                                          shard_batch(jnp.asarray(x0), mesh))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return (metrics, from_flax_params(jax.device_get(state.params)),
            from_flax_params(jax.device_get(state.ema_params)))


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"steps{world}")
    jddpm, params = _jax_setup()
    x0 = np.random.RandomState(1).standard_normal((B, 3, 16, 16)).astype(
        np.float32)
    flat = {k: v.numpy() for k, v in from_flax_params(params).items()}
    inp = {"j.names": np.asarray(list(flat)), "j.x0": x0,
           **{f"j.p.{k}": v for k, v in flat.items()}}
    for i in range(3):
        inp[f"j.tau{i}"], inp[f"j.eps{i}"] = _jax_noise(
            jddpm, jax.random.PRNGKey(10 + i), x0)
    np.savez(tmp / "inputs.npz", **inp)
    want = _jax_steps(jddpm, x0, world, JAX_FSDP[world])
    return world, flat, want, launch("steps", world, str(tmp))


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
def test_three_steps_match_jax_mesh(ranks, fsdp):
    _, _, (metrics, jparams, jema), outs = ranks
    out = outs[0]
    for i, (loss, norm) in enumerate(metrics):
        np.testing.assert_allclose(out[f"j.{fsdp}.loss{i}"], loss, rtol=1e-5)
        np.testing.assert_allclose(out[f"j.{fsdp}.grad_norm{i}"], norm,
                                   rtol=1e-5)
    for key, want in (("p", jparams), ("e", jema)):
        for name, w in want.items():
            err = float(np.abs(out[f"j.{fsdp}.{key}.{name}"] - w.numpy()).max())
            assert err <= 2e-6, (key, name, err)


def test_fsdp_step_equals_data_parallel_step(ranks):
    _, flat, _, outs = ranks
    out = outs[0]
    for i in range(3):
        np.testing.assert_allclose(out[f"j.True.loss{i}"],
                                   out[f"j.False.loss{i}"], rtol=1e-6)
    for key in ("p", "e"):
        for name in flat:
            np.testing.assert_allclose(out[f"j.True.{key}.{name}"],
                                       out[f"j.False.{key}.{name}"], rtol=0,
                                       atol=2e-6, err_msg=name)
    np.testing.assert_allclose(out["j.True.exp_avg_sq"],
                               out["j.False.exp_avg_sq"], rtol=1e-5, atol=1e-12)


def test_fsdp_holds_a_shard_of_the_state(ranks):
    """Masters, EMA and moments (two a parameter) on each rank: at most
    1/R of the whole plus the parameters left whole; without FSDP, all."""
    world, _, _, outs = ranks
    for out in outs:
        held, ema, moments, whole = out["j.True.held"]
        left = int(out["j.True.whole_leaves"])
        assert left < whole / 50  # the few small leaves JAX leaves whole too
        assert held <= whole / world + left and ema == held
        assert moments == 2 * held
        assert list(out["j.False.held"]) == [whole, whole, 2 * whole, whole]


def test_step_byte_bill(ranks):
    """One all-reduce a step, of the fp32 gradients and the loss (4 bytes
    each); FSDP adds one all-gather of every sharded parameter's fp32
    values (the gathered size, as JAX's HLO counts it)."""
    _, flat, _, outs = ranks
    n_params = sum(v.size for v in flat.values())
    for out in outs:
        assert list(out["bill.False.all-reduce"]) == [4 * (n_params + 1), 1]
        assert list(out["bill.False.all-gather"]) == [0, 0]
        assert list(out["bill.True.all-reduce"]) == [4 * (n_params + 1), 1]
        left = int(out["j.True.whole_leaves"])
        assert list(out["bill.True.all-gather"]) == [4 * (n_params - left), 1]


def test_ranks_agree_bitwise(ranks):
    _, _, _, outs = ranks
    for other in outs[1:]:
        for k in outs[0]:
            if not k.endswith((".held", ".whole_leaves")):
                np.testing.assert_array_equal(other[k], outs[0][k], err_msg=k)
