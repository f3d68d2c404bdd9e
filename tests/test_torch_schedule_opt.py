"""Port parity: schedule optimization through the sampler
(pdm_tpu_torch.diffusion.schedule_opt, the sampler's remat, the posterior
mean's VJP in ops.boltzmann, scripts/optimize_schedule.py).

The same numpy inputs go through the JAX package and the port on the CPU;
the JAX sampler's own draws (torch_port_fixtures.jax_sampler_draws) are
handed to the port. Tolerances:

* The posterior mean's VJP against float64 autograd of the posterior and
  against ``jax.vjp`` of JAX's denoiser: w = p (c.y - c.mean) cancels, so
  an fp32 gradient carries ~1e-7 of sum_j p |c.y_j| |x - s y_j| inv_temp;
  1e-4 of the gradient's scale, 1e-3 for JAX's (its autodiff of the online
  softmax rounds elsewhere), and the plain VJP against torch's autograd of
  the plain forward 1e-5 (the same sums).
* ``sample_with_grid`` and its knot gradient on the 1-D GMM against JAX:
  each of 6 steps moves a posterior mean by the logits' ~1e-6 relative
  rounding (test_torch_true_model.py), and the last returns the posterior
  mean at T = 1e-4, a weighting of the mode's points ~1e-4 apart that
  such a change in its query reweighs (measured: 1.2e-4 of scale for
  DDPM at key 3, 1e-6 to 2e-5 for the others): 5e-4 of scale for the
  sample; 5e-3 for the gradient, which chains that sensitivity through 6
  steps (measured up to 9.7e-4). The tiny UNet (fp32, remat on both
  sides): 1e-4 of scale for the sample, 2e-3 for the gradient (the UNet's
  convolutions sum in another order, as in test_torch_sampler.py).
* The knot optimizer against optax on one gradient sequence: the same
  update, but optax takes Adam's bias correction 1 - b2^t with b2 = 0.999
  rounded to fp32 (1.3e-5 relative off at t = 1), which moves each update
  by ~6.4e-6 of the rate: 2e-5 of the rate per update so far.
* Remat against no remat: bitwise (the same operations on the CPU).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdm_tpu.diffusion import sampling as js
from pdm_tpu.diffusion.schedule_opt import sample_with_grid as j_sample_with_grid
from pdm_tpu.models.base import TrueDDPM as JTrueDDPM
from pdm_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
from pdm_tpu.ops import boltzmann as jb
from pdm_tpu.schedulers.analytic import LogSNRScheduler as JLogSNR

from pdm_tpu_torch.diffusion import sampling as ts
from pdm_tpu_torch.diffusion import schedule_opt as so
from pdm_tpu_torch.models.base import TrueDDPM
from pdm_tpu_torch.models.unet import unet_from_config
from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.ops import boltzmann as tb
from pdm_tpu_torch.ops.mmd import mmd_rbf
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler, LogSNRScheduler
from pdm_tpu_torch.scripts import optimize_schedule as cli
from pdm_tpu_torch.utils.synthetic import generate_gmm_1d

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
from torch_port_fixtures import (  # noqa: E402
    jax_sampler_draws, two_torch_threads,  # noqa: F401
)

STEP_TYPES = ("ddpm", "ddim", "heun", "dpmpp_2m")
MIN_T, MAX_T = 1e-4, 1e1


def _true_models(n, seed=0):
    data = generate_gmm_1d(n, seed=seed)
    jm = JTrueDDPM(scheduler=JLogSNR(MIN_T, MAX_T), train_data=jnp.asarray(data))
    tm = TrueDDPM(scheduler=LogSNRScheduler(MIN_T, MAX_T), train_data=data,
                  device="cpu")
    return data, jm, tm


def _grid(n_steps):
    return ts.discretize_schedule(LogSNRScheduler(MIN_T, MAX_T), n_steps)


def _knot_grad(tm, grid, shape, step_type, remat=False, generator=None, **draws):
    lt = grid.clone().requires_grad_(True)
    x = so.sample_with_grid(tm, lt, generator, shape, step_type, remat=remat,
                            **draws)
    (g,) = torch.autograd.grad(torch.mean(torch.square(x)), [lt])
    return x.detach(), g


# ---- JAX's four tests (tests/test_schedule_opt.py), ported ----


@pytest.mark.parametrize("step_type", ["ddim", "dpmpp_2m"])
def test_gradients_flow_through_sampler(step_type):
    _, _, tm = _true_models(5_000)
    gen = torch.Generator().manual_seed(0)
    _, g = _knot_grad(tm, _grid(6), (32, 1, 1, 1), step_type, generator=gen)
    assert g.shape == (6,)
    assert float(g.abs().sum()) > 0
    assert bool(torch.isfinite(g).all())


def test_optimize_schedule_improves_mmd():
    data, _, tm = _true_models(20_000)
    sched = tm.scheduler
    init = ts.discretize_schedule(sched, 8)
    ref = torch.from_numpy(data[:2000].reshape(-1, 1))

    def eval_mmd(lt, seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            x = so.sample_with_grid(tm, torch.as_tensor(lt), gen, (512, 1, 1, 1))
        return float(mmd_rbf(x.reshape(-1, 1), ref, sigmas=(0.1,)))

    before = np.mean([eval_mmd(init, s) for s in range(3)])
    out = so.optimize_schedule(
        tm, data, init, n_iters=30, batch_size=256, learning_rate=0.05,
        clip_range=(np.log(1e-4), np.log(1e1)), verbose=False, device="cpu",
    )
    assert np.all(np.diff(out["log_temp"]) >= 0)
    after = np.mean([eval_mmd(out["log_temp"], s) for s in range(3)])
    # must not regress; usually improves
    assert after <= before * 1.2, (before, after)
    assert len(out["history"]) == 30


@pytest.mark.parametrize("step_type", ["ddpm", "ddim", "heun"])
def test_ddpm_step_gradient_finite_through_final_step(step_type):
    """The final reverse step has ab_prev == 1, so the noise coefficient is
    sqrt(0); the double-where safe_sqrt keeps inf * 0 out of the lowest
    knot's gradient."""
    _, _, tm = _true_models(2000)
    grid = torch.linspace(np.log(1e-3), np.log(5.0), 5)
    gen = torch.Generator().manual_seed(0)
    _, g = _knot_grad(tm, grid, (64, 1, 1, 1), step_type, generator=gen)
    assert bool(torch.isfinite(g).all()), (step_type, g)


# ---- the port against JAX ----


@pytest.mark.parametrize("step_type", STEP_TYPES)
def test_sample_with_grid_and_its_gradient_match_jax(step_type):
    data, jm, tm = _true_models(2000)
    shape, n_steps = (32, 1, 1, 1), 6
    grid = np.asarray(js.discretize_schedule(jm.scheduler, n_steps))
    key = jax.random.PRNGKey(3)

    def loss(lt):
        x = j_sample_with_grid(jm, lt, key, shape, step_type)
        return jnp.mean(jnp.square(x)), x

    (_, want_x), want_g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(grid))
    x_init, noise = jax_sampler_draws(key, n_steps, shape)
    got_x, got_g = _knot_grad(tm, torch.from_numpy(grid), shape, step_type,
                              x_init=torch.from_numpy(x_init),
                              noise=torch.from_numpy(noise))
    want_x, want_g = np.asarray(want_x), np.asarray(want_g)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0,
                               atol=5e-4 * np.abs(want_x).max())
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=5e-3 * np.abs(want_g).max())


TINY_UNET = {
    "block_out_channels": [8, 16],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
    "layers_per_block": 1,
    "attention_head_dim": 8,
    "dropout": 0.0,
}


@pytest.fixture(scope="module")
def tiny_unets():
    """__graft_entry__._flagship(tiny=True) in fp32 and the port's module
    with the same weights (flax -> torch by from_flax_params)."""
    from __graft_entry__ import _flagship

    jnet, jsched, size = _flagship(tiny=True)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, size, size, 3)), jnp.zeros((1,)))[
            "params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    jm = JUNetDDPM(scheduler=jsched, params=params, module=jnet)
    net = unet_from_config(3, {**TINY_UNET, "norm_groups": 4}, device="cpu")
    net.load_state_dict(from_flax_params(params), strict=True)
    tm = UNetDDPM(LinearBetaScheduler(1e-4, 2.478e4), net, device="cpu")
    return jm, tm, size


@pytest.mark.parametrize("step_type", STEP_TYPES)
def test_tiny_unet_gradient_matches_jax(tiny_unets, step_type):
    jm, tm, size = tiny_unets
    shape, n_steps = (2, 3, size, size), 4
    grid = np.asarray(js.discretize_schedule(jm.scheduler, n_steps))
    key = jax.random.PRNGKey(5)

    def loss(lt):
        x = j_sample_with_grid(jm, lt, key, shape, step_type, remat=True)
        return jnp.mean(jnp.square(x)), x

    (_, want_x), want_g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(grid))
    x_init, noise = jax_sampler_draws(key, n_steps, shape)
    got_x, got_g = _knot_grad(tm, torch.from_numpy(grid), shape, step_type,
                              remat=True, x_init=torch.from_numpy(x_init),
                              noise=torch.from_numpy(noise))
    want_x, want_g = np.asarray(want_x), np.asarray(want_g)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0,
                               atol=1e-4 * np.abs(want_x).max())
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=2e-3 * np.abs(want_g).max())


@pytest.mark.parametrize("step_type", STEP_TYPES)
def test_remat_gives_the_same_gradient(tiny_unets, step_type):
    """Checkpointed steps recompute the same forward: the knot gradient
    is bitwise the unckeckpointed one, DDPM's noise drawn from the same
    generator seed (before the loop under remat, in it without)."""
    _, tm, size = tiny_unets
    grid = ts.discretize_schedule(tm.scheduler, 3)
    outs = [_knot_grad(tm, grid, (2, 3, size, size), step_type, remat=remat,
                       generator=torch.Generator().manual_seed(11))
            for remat in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_discretize_schedule_keeps_the_knots_graph():
    lt = torch.linspace(-3.0, 1.0, 5, requires_grad=True)
    grid = ts.discretize_schedule(None, 5, log_temp=lt)
    tables = ts._step_tables(grid)
    total = sum(v.sum() for v in tables.values())
    (g,) = torch.autograd.grad(total, [lt])
    assert grid.requires_grad and bool(torch.isfinite(g).all())
    assert float(g.abs().sum()) > 0


# ---- the posterior mean's VJP ----


def _vjp_case(B=9, N=400, D=3, seed=0):
    """Queries near data points at per-row temperatures over the sampler's
    range; the first row at log T = log 1e-4, where p is one-hot."""
    rng = np.random.RandomState(seed)
    y = rng.randn(N, D).astype(np.float32)
    lt = np.linspace(np.log(1e-4), np.log(1e1), B).astype(np.float32)
    ab = 1.0 / (1.0 + np.exp(lt))
    idx = rng.randint(0, N, B)
    x = (np.sqrt(ab)[:, None] * y[idx]
         + np.sqrt(1.0 - ab)[:, None] * rng.randn(B, D)).astype(np.float32)
    c = rng.randn(B, D).astype(np.float32)
    return x, y, lt, c


def _f64_reference(x, y, lt, c):
    """float64 autograd of the posterior mean: (dx, dlog_temp)."""
    xd = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    ltd = torch.tensor(lt, dtype=torch.float64, requires_grad=True)
    yd = torch.tensor(y, dtype=torch.float64)
    ab, om = torch.sigmoid(-ltd), torch.sigmoid(ltd)
    h = 0.5 * torch.sum((xd[:, None] - torch.sqrt(ab)[:, None, None] * yd) ** 2, -1)
    mean = torch.softmax(-h / om[:, None], -1) @ yd
    torch.sum(mean * torch.tensor(c, dtype=torch.float64)).backward()
    return xd.grad.numpy(), ltd.grad.numpy()


@pytest.mark.parametrize("chunk", [0, 37])
def test_plain_vjp_matches_autograd_of_the_plain_forward(chunk):
    x, y, lt, c = _vjp_case()
    xt, yt, ct = (torch.from_numpy(a) for a in (x, y, c))
    it = (1.0 / torch.sigmoid(torch.from_numpy(lt))).requires_grad_(True)
    s = torch.sqrt(torch.sigmoid(-torch.from_numpy(lt))).requires_grad_(True)
    xg = xt.clone().requires_grad_(True)
    mom = tb.boltzmann_moments_reference(xg, yt, it, s, compute_mean=True,
                                         chunk_size=chunk)
    torch.sum(mom.mean * ct).backward()
    got = tb.posterior_mean_vjp_reference(
        xt, yt, it.detach(), s.detach(), mom.log_z.detach(),
        mom.mean.detach(), ct, chunk_size=chunk)
    for name, want in (("x", xg.grad), ("inv_temp", it.grad), ("y_scale", s.grad)):
        torch.testing.assert_close(getattr(got, name), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=name)


def test_denoiser_gradient_matches_float64_and_jax():
    """true_posterior_mean_x0 under grad (the autograd Function) against
    float64 autograd and jax.vjp of JAX's denoiser, in xt and log T."""
    x, y, lt, c = _vjp_case()
    xg = torch.from_numpy(x).requires_grad_(True)
    ltg = torch.from_numpy(lt).requires_grad_(True)
    mean = tb.true_posterior_mean_x0(xg, ltg, torch.from_numpy(y))
    torch.sum(mean * torch.from_numpy(c)).backward()
    want_dx, want_dlt = _f64_reference(x, y, lt, c)
    _, vjp = jax.vjp(lambda a, b: jb.true_posterior_mean_x0(a, b, jnp.asarray(y)),
                     jnp.asarray(x), jnp.asarray(lt))
    j_dx, j_dlt = (np.asarray(v) for v in vjp(jnp.asarray(c)))
    for got, want, tol in ((xg.grad.numpy(), want_dx, 1e-4),
                           (ltg.grad.numpy(), want_dlt, 1e-4),
                           (xg.grad.numpy(), j_dx, 1e-3),
                           (ltg.grad.numpy(), j_dlt, 1e-3)):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_mean_is_differentiable_only_with_the_dataset_as_payload():
    x, y, lt, _ = _vjp_case()
    xg = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        tb.true_posterior_mean_x0(xg, torch.from_numpy(lt), torch.from_numpy(y),
                                  values=torch.from_numpy(y).clone())


def test_denoiser_without_grad_takes_the_moments_op_alone():
    x, y, lt, _ = _vjp_case()
    with torch.no_grad():
        a = tb.true_posterior_mean_x0(torch.from_numpy(x), torch.from_numpy(lt),
                                      torch.from_numpy(y))
    b = tb.true_posterior_mean_x0(torch.from_numpy(x), torch.from_numpy(lt),
                                  torch.from_numpy(y))
    assert not a.requires_grad and not b.requires_grad
    assert torch.equal(a, b)


# ---- the knot optimizer and the CLI ----


def test_knot_update_matches_optax():
    """Sort, clip, then clip_by_global_norm and Adam, over a gradient
    sequence that crosses knots and pushes them out of the range."""
    rng = np.random.RandomState(0)
    init = np.array([-2.0, -1.5, -0.2, 0.4, 1.8], np.float32)
    grads = (rng.randn(12, 5) * np.array([[0.3], [3.0], [0.01]] * 4)).astype(np.float32)
    lr, clip, rng_lt = 0.3, 1.0, (-2.5, 2.0)
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))
    lt_j = jnp.asarray(init)
    state = tx.init(lt_j)
    knots = so.Knots(init, lr, clip, rng_lt, torch.device("cpu"))
    for i, g in enumerate(grads):
        lt_j = jnp.clip(jnp.sort(lt_j), *rng_lt)
        got = knots.project()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(lt_j),
                                   rtol=0, atol=2e-5 * lr * i)
        updates, state = tx.update(jnp.asarray(g), state)
        lt_j = optax.apply_updates(lt_j, updates)
        knots.update(torch.from_numpy(g))
    np.testing.assert_allclose(knots.projected().numpy(),
                               np.asarray(jnp.clip(jnp.sort(lt_j), *rng_lt)),
                               rtol=0, atol=2e-5 * lr * len(grads))


def test_cli_writes_the_optimized_knots(tmp_path, monkeypatch):
    for name, value in (("N_DATA", 2000), ("N_ITERS", 3), ("BATCH_SIZE", 64),
                        ("N_STEPS", 4)):
        monkeypatch.setattr(cli, name, value)
    monkeypatch.chdir(tmp_path)
    out = cli.main(["--device", "cpu"])
    saved = np.load(tmp_path / cli.OUT)
    lt = saved["log_temp"]
    np.testing.assert_array_equal(lt, out["log_temp"])
    assert lt.shape == (4,) and np.all(np.diff(lt) >= 0)
    assert lt.min() >= np.log(cli.MIN_TEMP) - 1e-6
    assert lt.max() <= np.log(cli.MAX_TEMP) + 1e-6
    assert saved["history"].shape == (3,) and np.all(np.isfinite(saved["history"]))
    assert saved["init_log_temp"].shape == (4,)


def test_bf16_unet_passes_the_gradient_to_tau(tiny_unets):
    """A bf16 module fed fp32 inputs (JAX's half=False with a bf16 UNet):
    the gradient reaches tau through the time embedding."""
    _, tm, size = tiny_unets
    net = unet_from_config(3, {**TINY_UNET, "norm_groups": 4},
                           dtype=torch.bfloat16, device="cpu")
    net.load_state_dict(tm.module.state_dict())
    model = UNetDDPM(tm.scheduler, net, device="cpu")
    tau = torch.tensor([0.3, 0.8], requires_grad=True)
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 3, size, size)).astype(np.float32))
    out = model(x, tau)
    assert out.dtype == torch.float32
    (g,) = torch.autograd.grad(out.square().sum(), [tau])
    assert bool(torch.isfinite(g).all()) and bool((g != 0).all())


# (B, padded N, D, blocks of the first kernel, blocks of the product): the
# schedule CLI's shape, CIFAR-10 scale, an edge, and a call whose w would
# exceed the workspace (sixteen segments of at most 489 sub-tiles on the
# large path)
VJP_PLAN_CALLS = ((1024, 100_096, 1, 2112, 264), (256, 50_048, 3072, 132, 264),
                  (37, 1_024, 5, 132, 264), (1024, 1_000_064, 3072, 132, 264))


def _check_vjp_plan(plan, B, n_pad, D):
    from pdm_tpu_torch.ops import boltzmann_kernel as bk

    n_tiles = n_pad // 128
    assert plan.b_pad % 128 == 0 and B <= plan.b_pad < B + 128
    # the segments tile the dataset in order, whole sub-tiles, none empty
    starts = [s0 for s0, _ in plan.segments]
    assert starts[0] == 0 and all(n > 0 for _, n in plan.segments)
    assert all(a + n == b for (a, n), b in zip(plan.segments, starts[1:]))
    assert sum(n for _, n in plan.segments) == n_tiles
    # each kernel's chunks cover every segment, none empty
    for per, total in ((plan.per_chunk, plan.n_chunks),
                       (plan.product_per_chunk, plan.product_chunks)):
        if total == 0:
            continue
        assert per > 0
        assert sum(-(-n // per) for _, n in plan.segments) == total
        assert all((-(-n // per) - 1) * per < n for _, n in plan.segments)
    if plan.path == "small":
        assert plan.launches == 2 and len(plan.segments) == 1
        assert plan.workspace == 0 and plan.product_chunks == plan.n_chunks
    else:
        assert plan.launches == 2 * len(plan.segments) + 1
        largest = max(n for _, n in plan.segments)
        assert plan.workspace == largest * 128 * plan.b_pad
        assert plan.workspace <= max(bk.VJP_WORKSPACE, 128 * plan.b_pad)
        assert plan.product_chunks >= 1


@pytest.mark.parametrize("mode,rows", [("fp32", 128), ("bf16_3x", 64), ("bf16", 64)])
@pytest.mark.parametrize("call", range(len(VJP_PLAN_CALLS)))
def test_vjp_plan_covers_the_dataset(mode, rows, call):
    from pdm_tpu_torch.ops import boltzmann_kernel as bk

    B, n_pad, D, slots, product_slots = VJP_PLAN_CALLS[call]
    plan = bk.plan_vjp(mode, B, D, n_pad, slots, product_slots)
    assert plan.tile_rows == (128 if plan.path == "small" else rows)
    _check_vjp_plan(plan, B, n_pad, D)


@pytest.mark.parametrize("mode,D,path", [
    ("fp32", 1, "small"), ("fp32", 2, "small"), ("fp32", 3, "small"),
    ("fp32", 4, "small"), ("fp32", 5, "large"), ("fp32", 64, "large"),
    ("fp32", 3072, "large"), ("bf16_3x", 1, "large"), ("bf16_3x", 4, "large"),
    ("bf16_3x", 3072, "large"), ("bf16", 1, "large"), ("bf16", 4, "large"),
    ("bf16", 3072, "large"),
])
def test_vjp_path_by_mode_and_dimension(mode, D, path):
    """fp32 at D <= VJP_SMALL_MAX_D takes the fused small-D kernel; larger
    D, and the bf16 modes at every D (their mma.sync Grams), the Grams and
    the product."""
    from pdm_tpu_torch.ops import boltzmann_kernel as bk

    assert bk.VJP_SMALL_MAX_D == 4
    assert bk.vjp_path(mode, D) == path
    plan = bk.plan_vjp(mode, 256, D, 50_048, 132, 264)
    assert plan.path == path
    assert plan.launches == (2 if path == "small" else 3)
    _check_vjp_plan(plan, 256, 50_048, D)


@pytest.mark.parametrize("label,mode,B,n_pad,D,segments,launches", [
    ("cli", "fp32", 1024, 100_096, 1, 1, 2),
    ("cli_bf16", "bf16", 1024, 100_096, 1, 2, 5),
    ("cifar10", "fp32", 256, 50_048, 3072, 1, 3),
    ("cifar10_bf16_3x", "bf16_3x", 256, 50_048, 3072, 1, 3),
    ("cifar10_batch_1024", "fp32", 1024, 50_048, 3072, 1, 3),
    ("gmm1d_1e6_bf16", "bf16", 1024, 1_000_064, 1, 16, 33),
])
def test_vjp_workspace_stays_within_its_bound(label, mode, B, n_pad, D, segments,
                                              launches):
    """The large-D path's w^T holds at most VJP_WORKSPACE floats a pass: one
    pass at the schedule CLI's and CIFAR-10's shapes, more (each within the
    bound) where the whole w would not fit; the small-D path holds none."""
    from pdm_tpu_torch.ops import boltzmann_kernel as bk

    plan = bk.plan_vjp(mode, B, D, n_pad, 132, 264)
    assert len(plan.segments) == segments and plan.launches == launches
    assert plan.workspace <= bk.VJP_WORKSPACE
    if plan.path == "small":
        assert plan.workspace == 0
    else:
        assert plan.workspace >= 128 * plan.b_pad
    _check_vjp_plan(plan, B, n_pad, D)


@pytest.mark.parametrize("B,D,mode", [(256, 3072, "fp32"), (100, 1, "fp32"), (1024, 1, "fp32"),
                                      (37, 5, "fp32"), (128, 4, "bf16"), (37, 5, "bf16_3x")])
def test_vjp_operands_layout(B, D, mode):
    """The VJP's operands as the kernels read them: queries and cotangent
    transposed to (D, b_pad) in the mode's split, zero-padded; the row terms
    (5, b_pad) with 0.5|x|^2 bitwise the forward's (its logits are the
    forward's own); the row-major dataset for the product on the large-D
    path only, in rows padded to a multiple of 4 floats where D is not one."""
    from pdm_tpu_torch.ops import boltzmann_kernel as bk
    from pdm_tpu_torch.ops.precision import split

    rng = np.random.RandomState(B + D)
    x, c = (torch.from_numpy(rng.randn(B, D).astype(np.float32)) for _ in range(2))
    y = torch.from_numpy(rng.randn(300, D).astype(np.float32))
    it = torch.from_numpy(rng.uniform(1.0, 100.0, B).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.1, 1.0, B).astype(np.float32))
    mom = tb.boltzmann_moments_reference(x, y, it, s, compute_mean=True, mxu_precision=mode)
    ops = bk.vjp_operands(x, y, it, s, mom.log_z, mom.mean, c, mode=mode)
    fwd = bk.operands(x, y, it, s, values=y, mode=mode)
    b_pad = bk.plan_vjp(mode, B, D, 384, 132, 264).b_pad
    assert ops.x_hi.shape == (D, b_pad) and ops.rows.shape == (5, b_pad)
    for got_hi, got_lo, t in ((ops.x_hi, ops.x_lo, x), (ops.c_hi, ops.c_lo, c)):
        hi, lo = split(t.T.contiguous(), mode)
        assert torch.equal(got_hi[:, :B], hi) and bool((got_hi[:, B:] == 0).all())
        assert (got_lo is None) == (lo is None)
        if lo is not None:
            assert torch.equal(got_lo[:, :B], lo) and bool((got_lo[:, B:] == 0).all())
    assert torch.equal(ops.rows[0, :B], fwd.row[0, :B])
    for k, want in ((1, it), (2, s), (3, mom.log_z), (4, torch.sum(c * mom.mean, dim=1))):
        assert torch.equal(ops.rows[k, :B], want)
    assert bool((ops.rows[1, B:] == 0).all()) and bool((ops.rows[2, B:] == 1).all())
    if bk.vjp_path(mode, D) == "small":
        assert ops.y is None
    else:
        assert ops.y.shape == (300, -(-D // 4) * 4) and ops.y.data_ptr() % 16 == 0
        assert torch.equal(ops.y[:, :D], y) and bool((ops.y[:, D:] == 0).all())
