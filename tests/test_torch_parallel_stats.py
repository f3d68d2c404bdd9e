"""Port parity: the data axis of the statistics and the sampler on 2 and 4
ranks (gloo, CPU), against the port in one process and the JAX package
under ``shard_map`` / its mesh on as many virtual devices.

One launch per world size runs every case on its ranks
(``torch_dist_workers.stats_suite``); the tests read its outputs.
Tolerances, each the JAX package's own for the same comparison:

* the moments and sweep shard bodies against one process: 1e-5 of the
  value (1e-4 for the variance, whose e2 - e1^2 cancels): the merge
  regroups fp32 sums (``tests/test_torch_boltzmann.py``'s merge test);
  against JAX's shard body: log_z 1e-5, e1 and the mean 1e-4, the
  variance 1e-3 (``tests/test_boltzmann.py:126-150``);
* ``thermo_sweep(mesh=)``: entropy rtol 1e-4 atol 1e-5, metric rtol 1e-3,
  free energy rtol 1e-4 atol 1e-4 (``tests/test_parallel.py:51``);
* FID statistics: mean atol 1e-5, covariance rtol 1e-4 atol 1e-5, the FID
  rtol 1e-4 atol 1e-4 (``tests/test_fid.py:199,230``);
* the data-parallel sampler: atol 1e-5 (``tests/test_parallel.py:17``).

The ranks must return bitwise the same results, and a call repeated on
the same ranks bitwise the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pdm_tpu.diffusion.sampling import DDPMSampler as JSampler
from pdm_tpu.models.base import TrueDDPM as JTrue
from pdm_tpu.ops.boltzmann import (
    boltzmann_moments_shard_body as j_moments_shard,
)
from pdm_tpu.ops.boltzmann_sweep import (
    boltzmann_sweep_shard_body as j_sweep_shard,
)
from pdm_tpu.parallel.distributed import sharded_sampler as j_sharded_sampler
from pdm_tpu.parallel.mesh import make_mesh as j_make_mesh
from pdm_tpu.schedulers.analytic import LogSNRScheduler as JLogSNR
from pdm_tpu.stats.sweep import thermo_sweep as j_thermo_sweep
from pdm_tpu.utils.fid import (
    feature_statistics as j_feature_statistics,
    get_compute_fid as j_get_compute_fid,
)
from pdm_tpu.utils.synthetic import generate_gmm_1d

from pdm_tpu_torch.diffusion.sampling import DDPMSampler
from pdm_tpu_torch.models.base import TrueDDPM
from pdm_tpu_torch.ops.boltzmann import boltzmann_moments
from pdm_tpu_torch.ops.boltzmann_sweep import boltzmann_sweep
from pdm_tpu_torch.schedulers.analytic import LogSNRScheduler
from pdm_tpu_torch.stats.sweep import thermo_sweep
from torch_dist_workers import launch
from torch_port_fixtures import jax_sampler_draws, two_torch_threads  # noqa: F401

FIELDS = ("log_z", "shift", "e1_hat", "e2_hat")
MOMENT_CASES = ("even", "uneven", "one_point", "tiny")


def _moment_inputs(world):
    rng = np.random.RandomState(0)
    inp = {"m.x": rng.standard_normal((9, 12)).astype(np.float32),
           "m.inv_temp": rng.uniform(0.2, 2.0, 9).astype(np.float32),
           "m.y_scale": rng.uniform(0.5, 1.0, 9).astype(np.float32)}
    sizes = {"even": [10] * world,  # N 20 or 40
             "uneven": [len(a) for a in np.array_split(np.arange(37), world)],
             "one_point": [1] + [8] * (world - 1),
             "tiny": [1] * (world - 1) + [0]}  # the last rank's shard is empty
    for case, sz in sizes.items():
        n = sum(sz)
        inp[f"m.{case}.y"] = rng.standard_normal((n, 12)).astype(np.float32)
        inp[f"m.{case}.values"] = rng.standard_normal((n, 3)).astype(np.float32)
        inp[f"m.{case}.bounds"] = np.concatenate([[0], np.cumsum(sz)])
    return inp


def _sweep_inputs():
    rng = np.random.RandomState(1)
    return {"s.x0": rng.standard_normal((8, 12)).astype(np.float32),
            "s.eps": rng.standard_normal((8, 12)).astype(np.float32),
            "s.y": rng.standard_normal((40, 12)).astype(np.float32),
            "s.temps": np.logspace(-2, 1, 5).astype(np.float32),
            "s.values": rng.uniform(0.1, 1.0, (40, 1)).astype(np.float32)}


def _jax_sweep_draws(n, d, bs=64):
    """thermo_sweep's first batch as the JAX package draws it."""
    key, sub = jax.random.split(jax.random.PRNGKey(0))
    idx = jax.random.randint(sub, (bs,), 0, n)
    eps = jax.random.normal(jax.random.fold_in(key, 0), (bs, d))
    return np.asarray(idx), np.asarray(eps)


def _thermo_inputs():
    inp = {"t.temp": np.logspace(-1, 1, 5)}
    for case, n, seed in (("even", 128, 0), ("uneven", 133, 1)):
        data = np.random.RandomState(seed).randn(n, 6).astype(np.float32)
        inp[f"t.{case}.data"] = data
        inp[f"t.{case}.idx"], inp[f"t.{case}.eps"] = _jax_sweep_draws(n, 6)
    return inp


def _fid_inputs():
    rng = np.random.RandomState(4)
    inp = {"f.data": rng.randn(1000, 16).astype(np.float32)}
    rng = np.random.RandomState(5)
    inp["f.ref"] = rng.randn(512, 8).astype(np.float32)
    inp["f.x"] = (rng.randn(400, 8) * 1.1 + 0.3).astype(np.float32)
    return inp


def _sampler_inputs():
    x_init, noise = jax_sampler_draws(jax.random.PRNGKey(0), 8, (64, 1, 1, 1))
    return {"g.data": np.asarray(generate_gmm_1d(10_000), np.float32),
            "g.x_init": x_init, "g.noise": noise}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"stats{world}")
    inp = {**_moment_inputs(world), **_sweep_inputs(), **_thermo_inputs(),
           **_fid_inputs(), **_sampler_inputs()}
    np.savez(tmp / "inputs.npz", **inp)
    return world, inp, launch("stats", world, str(tmp))


def _jax_mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _check_moments(out, prefix, want, var_rtol=1e-4):
    for f in FIELDS:
        _close(out[f"{prefix}.{f}"], getattr(want, f).numpy())
    e1, e2 = out[f"{prefix}.e1_hat"], out[f"{prefix}.e2_hat"]
    _close(np.clip(e2 - e1 ** 2, 0, None), want.var.numpy(), rtol=var_rtol)
    if want.mean is not None:
        _close(out[f"{prefix}.mean"], want.mean.numpy())


def test_moments_shard_body_matches_one_process_and_jax(ranks):
    world, inp, outs = ranks
    out = outs[0]
    x, it, ys = (torch.from_numpy(inp[k]) for k in ("m.x", "m.inv_temp",
                                                    "m.y_scale"))
    y, v = inp["m.even.y"], inp["m.even.values"]
    _check_moments(out, "m.even", boltzmann_moments(
        x, torch.from_numpy(y), it, ys, values=torch.from_numpy(v)))
    _check_moments(out, "m.even_mean", boltzmann_moments(
        x, torch.from_numpy(y), it, ys, compute_mean=True))
    fn = shard_map(
        lambda yy: j_moments_shard(jnp.asarray(inp["m.x"]), yy,
                                   jnp.asarray(inp["m.inv_temp"]),
                                   jnp.asarray(inp["m.y_scale"]),
                                   axis_name="data", compute_mean=True),
        mesh=_jax_mesh(world), in_specs=(P("data"),), out_specs=P(),
        check_vma=False)
    want = fn(jnp.asarray(y))
    _close(out["m.even_mean.log_z"], want.log_z)
    e1 = out["m.even_mean.e1_hat"] - out["m.even_mean.shift"]
    _close(e1, want.e1, rtol=1e-4, atol=1e-4)
    _close(out["m.even_mean.mean"], want.mean, rtol=1e-4, atol=1e-4)
    var = np.clip(out["m.even_mean.e2_hat"] - out["m.even_mean.e1_hat"] ** 2,
                  0, None)
    _close(var, want.var, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case", MOMENT_CASES[1:])
def test_moments_shard_body_uneven_and_empty_shards(ranks, case):
    """Shards of other sizes, a shard of one point, an empty shard (every
    logit -inf there: the isfinite guards) against one process."""
    _, inp, outs = ranks
    x, it, ys = (torch.from_numpy(inp[k]) for k in ("m.x", "m.inv_temp",
                                                    "m.y_scale"))
    want = boltzmann_moments(x, torch.from_numpy(inp[f"m.{case}.y"]), it, ys,
                             values=torch.from_numpy(inp[f"m.{case}.values"]))
    _check_moments(outs[0], f"m.{case}", want)


def test_sweep_shard_body_matches_one_process_and_jax(ranks):
    world, inp, outs = ranks
    out = outs[0]
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k.startswith("s.")}
    want = boltzmann_sweep(t["s.x0"], t["s.eps"], t["s.y"], t["s.temps"],
                           values=t["s.values"])
    _check_moments(out, "s", want)
    fn = shard_map(
        lambda yy, vv: j_sweep_shard(
            jnp.asarray(inp["s.x0"]), jnp.asarray(inp["s.eps"]), yy,
            jnp.asarray(inp["s.temps"]), axis_name="data", values=vv),
        mesh=_jax_mesh(world), in_specs=(P("data"), P("data")),
        out_specs=P(), check_vma=False)
    jw = fn(jnp.asarray(inp["s.y"]), jnp.asarray(inp["s.values"]))
    _close(out["s.log_z"], jw.log_z)
    _close(out["s.e1_hat"] - out["s.shift"], jw.e1, rtol=1e-4, atol=1e-4)
    _close(out["s.mean"], jw.mean, rtol=1e-4, atol=1e-4)


def _jax_thermo(world, inp, case, knn):
    with j_make_mesh(data=world, model=1, devices=jax.devices()[:world]) as mesh:
        return j_thermo_sweep(jax.random.PRNGKey(0),
                              jnp.asarray(inp[f"t.{case}.data"]),
                              inp["t.temp"], n_samples=64, batch_size=64,
                              regularize=knn, adaptive_knn=knn, knn_k=3,
                              mesh=mesh)


def _check_thermo(out, prefix, want):
    _close(out[f"{prefix}.entropy"], want["entropy"], rtol=1e-4, atol=1e-5)
    _close(out[f"{prefix}.metric"], want["metric"], rtol=1e-3, atol=1e-5)
    _close(out[f"{prefix}.free_energy"], want["free_energy"], rtol=1e-4,
           atol=1e-4)


@pytest.mark.parametrize("knn", [False, True], ids=["floor", "knn"])
def test_thermo_sweep_mesh_even(ranks, knn):
    """N divisible by the axis: the port's mesh sweep against JAX's mesh
    sweep and the port's one-process sweep on JAX's draws."""
    world, inp, outs = ranks
    draws = [(torch.from_numpy(inp["t.even.idx"]),
              torch.from_numpy(inp["t.even.eps"]))]
    one = thermo_sweep(inp["t.even.data"], inp["t.temp"], 64, 64, draws=draws,
                       regularize=knn, adaptive_knn=knn, knn_k=3,
                       device="cpu")
    _check_thermo(outs[0], f"t.even.{knn}", one)
    _check_thermo(outs[0], f"t.even.{knn}", _jax_thermo(world, inp, "even", knn))
    gen = torch.Generator().manual_seed(0)
    one = thermo_sweep(inp["t.even.data"], inp["t.temp"], 48, 16,
                       generator=gen, device="cpu")
    _close(outs[0]["t.even.gen.entropy"], one["entropy"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("knn", [False, True], ids=["floor", "knn"])
def test_thermo_sweep_mesh_uneven(ranks, knn):
    """N = 133: the remainder under the axis size is dropped (the k-NN
    floor with it), as JAX's mesh sweep drops it."""
    world, inp, outs = ranks
    _check_thermo(outs[0], f"t.uneven.{knn}",
                  _jax_thermo(world, inp, "uneven", knn))
    assert np.all(np.isfinite(outs[0]["t.uneven.gen.entropy"]))


def test_feature_statistics_mesh_ragged(ranks):
    """1000 rows at batch 130: the mesh rounds the batch to the axis's
    multiple and pads and masks the ragged last batch."""
    world, inp, outs = ranks
    data = inp["f.data"]
    mu, sigma = outs[0]["f.mu"], outs[0]["f.sigma"]
    _close(mu, data.mean(0), rtol=0, atol=1e-5)
    _close(sigma, np.cov(data.T), rtol=1e-4, atol=1e-5)
    mesh = j_make_mesh(data=world, model=1, devices=jax.devices()[:world])
    j_mu, j_sigma = j_feature_statistics(jnp.asarray(data), lambda a: a, 16,
                                         batch_size=130, mesh=mesh)
    _close(mu, j_mu, rtol=0, atol=1e-5)
    _close(sigma, j_sigma, rtol=1e-4, atol=1e-5)


def test_compute_fid_mesh(ranks):
    world, inp, outs = ranks
    mesh = j_make_mesh(data=world, model=1, devices=jax.devices()[:world])
    want = j_get_compute_fid(jnp.asarray(inp["f.ref"]), lambda a: a, 8,
                             mesh=mesh)(jnp.asarray(inp["f.x"]))
    _close(outs[0]["f.fid"], want, rtol=1e-4, atol=1e-4)


def _port_sampler(inp, step_type, **kw):
    sched = LogSNRScheduler(1e-4, 1e1)
    ddpm = TrueDDPM(scheduler=sched, train_data=torch.from_numpy(inp["g.data"]),
                    device="cpu")
    kw = {"n_steps": 8, "batch_size": 64, "n_samples": 64, **kw}
    return DDPMSampler(ddpm=ddpm, scheduler=sched, obj_size=(1, 1, 1),
                       step_type=step_type, device="cpu", **kw)


def test_sampler_data_parallel_ddim(ranks):
    """DDIM-8 over the 1-D GMM: JAX's draws through the port's sharded
    sampler against JAX's sharded sampler; the port's own draws against
    the port in one process."""
    world, inp, outs = ranks
    sched = JLogSNR(1e-4, 1e1)
    jsampler = JSampler(ddpm=JTrue(scheduler=sched,
                                   train_data=jnp.asarray(inp["g.data"])),
                        scheduler=sched, n_steps=8, obj_size=(1, 1, 1),
                        batch_size=64, n_samples=64, step_type="ddim")
    mesh = j_make_mesh(data=world, model=1, devices=jax.devices()[:world])
    with mesh:
        want = j_sharded_sampler(jsampler, mesh).batch_sample(
            jax.random.PRNGKey(0))["x"]
    _close(outs[0]["g.ddim.explicit"], want, rtol=0, atol=1e-5)
    one = _port_sampler(inp, "ddim").batch_sample(
        torch.Generator().manual_seed(0))["x"]
    _close(outs[0]["g.ddim.gen"], one.numpy(), rtol=0, atol=1e-5)


def test_sampler_data_parallel_ddpm_and_states(ranks):
    """DDPM-8: the given x_init and noise, and the generator's draws, each
    against one process; ``sample`` with track_states over two batches."""
    _, inp, outs = ranks
    one = _port_sampler(inp, "ddpm")
    want = one.batch_sample(x_init=torch.from_numpy(inp["g.x_init"]),
                            noise=torch.from_numpy(inp["g.noise"]))["x"]
    _close(outs[0]["g.ddpm.explicit"], want.numpy(), rtol=0, atol=1e-5)
    want = one.batch_sample(torch.Generator().manual_seed(0))["x"]
    _close(outs[0]["g.ddpm.gen"], want.numpy(), rtol=0, atol=1e-5)
    res = _port_sampler(inp, "ddim", n_steps=4, batch_size=8, n_samples=12,
                        track_states=True).sample(torch.Generator().manual_seed(1))
    assert outs[0]["g.states"].shape == res["states"].shape == (4, 12, 1, 1, 1)
    _close(outs[0]["g.states"], res["states"], rtol=0, atol=1e-5)
    _close(outs[0]["g.sample"], res["x"], rtol=0, atol=1e-5)


def test_ranks_agree_bitwise_and_repeat(ranks):
    """Every rank returns bitwise the same results, a repeated call on the
    same ranks bitwise the same, and the collectives were counted."""
    _, _, outs = ranks
    for other in outs[1:]:
        assert set(other) == set(outs[0])
        for k, v in outs[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    for f in FIELDS + ("mean",):
        np.testing.assert_array_equal(outs[0][f"m.uneven_again.{f}"],
                                      outs[0][f"m.uneven.{f}"])
    assert outs[0]["stats.all-reduce"] > 0 and outs[0]["stats.all-gather"] > 0
