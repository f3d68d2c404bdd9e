"""Port parity: the port's entry points (pdm_tpu_torch/scripts/) against the
JAX package's scripts, each direction through the artifacts they share, on
the CPU (``--device cpu``), at MNIST's shape over seeded PDMC caches.

* compute_stats_forward: the port's npz builds JAX's entropy scheduler and
  JAX's builds the port's, log_temp within 1e-6 (the same knots, fp32
  interpolation in two orders); the streamed tier writes the same grid.
* compute_stats_metric: the port's npz builds JAX's metric scheduler.
* sample -> compute_fid: the port's samples feed JAX's compute_fid with
  fid.sample=false and a port-written LeNet npz; the two FIDs agree
  within 1e-3 relative (160 samples of 100-dim features: full-rank
  covariances, where both eigh routes agree); scripts/analyze_fids.py
  reads the port's CSV.
* convert_orbax_checkpoint: a JAX trainer's orbax save of a tiny UNet
  loads in the port with params, EMA and Adam moments bitwise equal to
  from_flax_params of JAX's; the bridge's process loads no JAX or orbax.
* train_diffusion -> sample -> compute_fid chain on the port alone, the
  eval hook's FID in the training log.
* train_lenet writes JAX's npz format; convert_inception_weights turns a
  torchvision-named .pth into JAX's layout. One subprocess per CLI checks
  the ``python -m`` argv surface.
"""

import csv
import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pdm_tpu.config.loader import load_config as j_load_config
from pdm_tpu.models import inception as jinc
from pdm_tpu.models import lenet as jlenet
from pdm_tpu.schedulers.from_config import (
    scheduler_from_config as j_scheduler_from_config,
)

from pdm_tpu_torch import runtime
from pdm_tpu_torch.config import datasets as tdatasets
from pdm_tpu_torch.config.loader import (
    load_config, parse_args_from_config, update_config_from_args,
)
from pdm_tpu_torch.models import inception as tinc
from pdm_tpu_torch.models import lenet as tlenet
from pdm_tpu_torch.models.from_config import ddpm_from_config
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.schedulers.from_config import scheduler_from_config
from pdm_tpu_torch.scripts import (
    check_config, check_distance, compute_fid, compute_stats_forward,
    compute_stats_metric, endurance_schedule_table, endurance_solver_table,
    longrun_endurance, metric_schedule_exp, optimize_schedule_flagship,
    sample, schedule_ordering_exp, train_diffusion, train_lenet,
)
from pdm_tpu_torch.utils.data import pdmc_cache_path
from torch_port_fixtures import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

N_TRAIN, N_TEST = 256, 256
TINY_UNET = ("{block_out_channels: [16, 32], down_block_types: [DownBlock2D, "
             "AttnDownBlock2D], up_block_types: [AttnUpBlock2D, UpBlock2D], "
             "layers_per_block: 1, attention_head_dim: 8, norm_groups: 4, "
             "dropout: 0.0}")
TINY_CONV_UNET = ("{block_out_channels: [8, 16], down_block_types: [DownBlock2D, "
                  "DownBlock2D], up_block_types: [UpBlock2D, UpBlock2D], "
                  "layers_per_block: 1, norm_groups: 4, dropout: 0.0}")
TRUE_MODEL = ["--dataset_name", "mnist", "--ddpm.model_name", "true",
              "--ddpm.parametrization", "x0"]
CPU = ["--device", "cpu"]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory with MNIST-shaped PDMC caches (seeded uint8
    images, 256 train and 256 test) and no Inception weights."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PDM_DATA_CACHE", str(tmp_path / "data_cache"))
    monkeypatch.delenv("PDM_INCEPTION_WEIGHTS", raising=False)
    os.makedirs("data_cache")
    rng = np.random.RandomState(0)
    for train, n in ((True, N_TRAIN), (False, N_TEST)):
        runtime.write_cache(pdmc_cache_path("mnist", train),
                            rng.randint(0, 256, (n, 32, 32, 1), dtype=np.uint8))
    return tmp_path


def jax_config(**overrides):
    cfg = j_load_config()
    cfg.parallel.data_axis = 1  # one device, as the port's
    for key, value in overrides.items():
        *heads, leaf = key.split(".")
        sub = cfg
        for h in heads:
            sub = getattr(sub, h)
        setattr(sub, leaf, value)
    return cfg


def port_config(argv):
    cfg = load_config()
    update_config_from_args(cfg, parse_args_from_config(cfg, argv))
    return cfg


def jax_script(name):
    return importlib.import_module(name).main.__wrapped__


def port_lenet(path="checkpoints/lenet_mnist.npz"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    model = tlenet.init_lenet(tlenet.LeNet(), torch.Generator().manual_seed(0))
    tlenet.save_lenet(model, path)


TAU = np.linspace(0.0, 1.0, 33).astype(np.float32)


def assert_same_schedule(jsched, tsched):
    want = np.asarray(jsched.log_temp_from_tau(jax.numpy.asarray(TAU)))
    got = tsched.log_temp_from_tau(torch.from_numpy(TAU)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


def test_compute_stats_forward_both_ways(workdir):
    argv = ["--dataset_name", "mnist", "--forward_stats.n_samples", "64",
            "--forward_stats.batch_size", "32", "--forward_stats.n_temps", "12"]
    compute_stats_forward.main(argv=argv + CPU)
    ours = dict(np.load("stats/mnist_forward.npz"))
    assert set(ours) == {"temp", "entropy", "free_energy", "heat_capacity"}
    assert ours["temp"].shape == (12,) and np.isfinite(ours["entropy"]).all()
    jcfg = jax_config(dataset_name="mnist")
    cfg = port_config(["--dataset_name", "mnist"])
    assert_same_schedule(
        j_scheduler_from_config(jcfg, noise_schedule_type="entropy"),
        scheduler_from_config(cfg, noise_schedule_type="entropy", device="cpu"))
    # the streamed tier writes the same grid
    compute_stats_forward.main(
        argv=argv + ["--forward_stats.stream_chunk", "100"] + CPU)
    streamed = dict(np.load("stats/mnist_forward.npz"))
    np.testing.assert_array_equal(streamed["temp"], ours["temp"])
    assert np.isfinite(streamed["entropy"]).all()
    # and JAX's artifact builds the port's scheduler
    jcfg.forward_stats.n_samples, jcfg.forward_stats.batch_size = 64, 32
    jcfg.forward_stats.n_temps = 12
    jax_script("compute_stats_forward")(jcfg)
    jax_art = dict(np.load("stats/mnist_forward.npz"))
    np.testing.assert_allclose(jax_art["temp"], ours["temp"], rtol=1e-12)
    assert_same_schedule(
        j_scheduler_from_config(jcfg, noise_schedule_type="entropy"),
        scheduler_from_config(cfg, noise_schedule_type="entropy", device="cpu"))


def test_compute_stats_metric_builds_jax_metric_schedule(workdir):
    compute_stats_metric.main(["--dataset", "mnist", "--n_samples", "64",
                               "--n_temps", "10", "--regularize"] + CPU)
    art = dict(np.load("stats/mnist_metric.npz"))
    assert set(art) == {"temp", "metric", "log_temp", "dataset_tr_sigma0"}
    assert np.isfinite(art["metric"]).all() and (art["metric"] > 0).all()
    jcfg = jax_config(dataset_name="mnist")
    cfg = port_config(["--dataset_name", "mnist"])
    assert_same_schedule(
        j_scheduler_from_config(jcfg, noise_schedule_type="metric"),
        scheduler_from_config(cfg, noise_schedule_type="metric", device="cpu"))


# ---------------------------------------------------------------------------
# sampling and FID
# ---------------------------------------------------------------------------


def test_samples_feed_jax_compute_fid(workdir, monkeypatch, capsys):
    port_lenet()
    n_fid, steps = 160, 10
    sample.main(argv=TRUE_MODEL + [
        "--sample.n_steps", str(steps), "--sample.n_samples", str(n_fid),
        "--sample.batch_size", str(n_fid)] + CPU)
    x = np.load(f"samples/mnist_true_{steps}_ddim_steps.npz")["x"]
    assert x.shape == (n_fid, 1, 32, 32) and np.isfinite(x).all()
    jcfg = jax_config(**{"dataset_name": "mnist", "ddpm.model_name": "true",
                         "ddpm.parametrization": "x0", "fid.sample": False,
                         "fid.samples": n_fid, "fid.n_steps": [steps]})
    jax_script("compute_fid")(jcfg)
    with open("fid/mnist_true.csv") as f:
        jax_rows = list(csv.DictReader(f))
    rows = compute_fid.main(argv=TRUE_MODEL + [
        "--no-fid.sample", "--fid.samples", str(n_fid),
        "--fid.n_steps", f"[{steps}]"] + CPU)
    with open("fid/mnist_true.csv") as f:
        text = f.read()
    assert text.splitlines()[0] == "n_steps,schedule,min_temp,fid"
    assert len(jax_rows) == len(rows) == 1
    fid = rows[0]["fid"]
    assert np.isfinite(fid) and fid > 0
    np.testing.assert_allclose(fid, float(jax_rows[0]["fid"]), rtol=1e-3)
    # scripts/analyze_fids.py reads the port's table
    monkeypatch.setattr(sys, "argv", ["analyze_fids.py", "--fid_dir", "fid"])
    capsys.readouterr()
    importlib.import_module("analyze_fids").main()
    assert "linear_beta" in capsys.readouterr().out


def test_train_sample_fid_chain(workdir, monkeypatch):
    """train_diffusion (a tiny UNet without attention, 2 steps, the eval
    hook's FID at step 2) -> sample from its checkpoint -> compute_fid, on
    the port alone. The dataset's fid_samples is cut to 25 so the hook's
    two DDIM-100 samples are one batch of 25 each on the CPU."""
    monkeypatch.setitem(tdatasets._REGISTRY, "mnist", dataclasses.replace(
        tdatasets._REGISTRY["mnist"], fid_samples=25))
    port_lenet()
    unet = ["--dataset_name", "mnist", "--ddpm.unet_config", TINY_CONV_UNET,
            "--ddpm.precision", "f32"]
    train_diffusion.main(argv=unet + [
        "--ddpm_training.total_iters", "2", "--ddpm_training.batch_size", "4",
        "--ddpm_training.eval_steps", "2", "--ddpm_training.warmup_steps", "0"]
        + CPU)
    exp = "mnist_unet_eps_linear_beta_schedule"
    with open(f"logs/{exp}.csv") as f:
        logged = {r["metric"]: float(r["value"]) for r in csv.DictReader(f)}
    assert np.isfinite(logged["fid_100_steps"]) and logged["fid_100_steps"] >= 0
    assert os.path.exists(f"checkpoints/{exp}/step_2/state.pt")
    assert os.path.exists("eval_samples/step_2.png")
    sample.main(argv=unet + ["--sample.n_steps", "3", "--sample.n_samples", "8",
                             "--sample.batch_size", "8"] + CPU)
    assert np.load(f"samples/{exp}_3_ddim_steps.npz")["x"].shape == (8, 1, 32, 32)
    rows = compute_fid.main(argv=unet + ["--fid.n_steps", "[3]",
                                         "--fid.samples", "16"] + CPU)
    assert len(rows) == 1 and np.isfinite(rows[0]["fid"]) and rows[0]["fid"] >= 0
    with open(f"fid/{exp}.csv") as f:
        assert [r["n_steps"] for r in csv.DictReader(f)] == ["3"]


def test_compute_fid_checks_the_schedule_paths(workdir):
    port_lenet()
    with pytest.raises(ValueError, match="noise_schedule_path has 2 entries"):
        compute_fid.main(argv=TRUE_MODEL + [
            "--fid.noise_schedule_path", "[a.npz, b.npz]"] + CPU)


# ---------------------------------------------------------------------------
# checkpoints and weights
# ---------------------------------------------------------------------------


def run_python(*args, cwd):
    # two threads, as the in-process tests: the suite runs several workers
    # on one machine, and a subprocess would otherwise take every core
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=cwd)


def run_module(name, *args, cwd):
    return run_python("-m", f"pdm_tpu_torch.scripts.{name}", *args, cwd=cwd)


def test_orbax_checkpoint_converts(workdir):
    from pdm_tpu.diffusion.trainer import DDPMTrainer as JTrainer
    from pdm_tpu.models.from_config import ddpm_from_config as j_ddpm_from_config

    pytest.importorskip("orbax.checkpoint")
    pytest.importorskip("tensorstore")
    argv = ["--ddpm.unet_config", TINY_UNET, "--ddpm.precision", "f32"]
    cfg = port_config(argv)
    jcfg = jax_config(**{"ddpm.unet_config": dict(cfg.ddpm.unet_config),
                         "ddpm.precision": "f32"})
    jtrainer = JTrainer(ddpm=j_ddpm_from_config(jcfg, key=jax.random.PRNGKey(0)),
                        warmup_steps=0, checkpoint_dir="jax_ckpt")
    state = jtrainer.init_state()
    rng = np.random.RandomState(1)

    def noisy(x):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return np.full_like(x, 7)
        return (x + 0.01 * rng.randn(*x.shape)).astype(x.dtype)

    state = state.__class__(
        step=np.int32(7), params=state.params,
        ema_params=jax.tree_util.tree_map(noisy, state.params),
        opt_state=jax.tree_util.tree_map(noisy, state.opt_state))
    jtrainer.save_checkpoint(state, 7)
    jtrainer.finalize_checkpoints()
    # as `python -m` runs it (runpy), in a process that loads no JAX, orbax
    # or the JAX package: the bridge reads the save with tensorstore alone
    r = run_python(
        "-c", "import runpy, sys\n"
        "sys.argv = ['convert_orbax_checkpoint', *sys.argv[1:]]\n"
        "runpy.run_module('pdm_tpu_torch.scripts.convert_orbax_checkpoint',"
        " run_name='__main__')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} &"
        " {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pdm_tpu'})\n"
        "assert not bad, bad\n",
        *argv, "--src", "jax_ckpt", cwd=workdir)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "converted jax_ckpt/step_7" in r.stdout
    loaded = ddpm_from_config(cfg, pretrained=True, device="cpu")
    want_ema = from_flax_params(jax.device_get(state.ema_params))
    for name, p in loaded.module.named_parameters():
        assert torch.equal(p.detach(), want_ema[name]), name
    payload = torch.load(f"{cfg.checkpoint_dir}/step_7/state.pt",
                         weights_only=True)
    assert payload["step"] == 7
    adam = [s for s in jax.device_get(state.opt_state)
            if hasattr(s, "mu")][0]
    mu, nu = from_flax_params(adam.mu), from_flax_params(adam.nu)
    names = list(payload["params"])
    want_params = from_flax_params(jax.device_get(state.params))
    for i, name in enumerate(names):
        assert torch.equal(payload["params"][name], want_params[name]), name
        opt = payload["optimizer"]["state"][i]
        assert float(opt["step"]) == 7.0
        assert torch.equal(opt["exp_avg"], mu[name]), name
        assert torch.equal(opt["exp_avg_sq"], nu[name]), name


def test_train_lenet_writes_jax_format(workdir, monkeypatch):
    rng = np.random.RandomState(4)
    x = rng.randn(256, 1, 32, 32).astype(np.float32)
    y = (x.reshape(256, -1).sum(1) > 0).astype(np.int64)
    monkeypatch.setattr(train_lenet, "load_hf_images",
                        lambda *args: (x, y) if args[-1] == "train" else (x[:64], y[:64]))
    out = train_lenet.main(argv=["--dataset_name", "mnist"] + CPU)
    assert out == "checkpoints/lenet_mnist.npz"
    model = tlenet.load_lenet(out, device="cpu")
    _, params = jlenet.load_lenet(out)
    want = np.asarray(jlenet.LeNet().apply({"params": params}, jax.numpy.asarray(x[:8])))
    with torch.no_grad():
        got = model(torch.from_numpy(x[:8])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tlenet.evaluate_lenet(model, x, y)[1] > 0.9




def test_convert_inception_weights_cli(workdir):
    """A torchvision-named .pth (fc, AuxLogits and BN running stats) ->
    JAX's npz layout, read by both packages."""
    model = tinc.InceptionV3Features()
    names = {v: k for k, v in tinc._TORCH_BN.items()}
    sd = {"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
          "AuxLogits.fc.weight": torch.zeros(1000, 768)}
    g = torch.Generator().manual_seed(0)
    for key, v in model.state_dict().items():
        *scope, leaf = key.split(".")
        if leaf != "weight":
            key = ".".join([*scope, "bn", names[leaf]])
        sd[key] = torch.rand(v.shape, generator=g) + 0.5
    torch.save(sd, "incep.pth")
    r = run_module("convert_inception_weights", "incep.pth", "--out",
                   "w/incep.npz", cwd=workdir)
    assert r.returncode == 0, r.stderr[-2000:]
    got = tinc.load_inception("w/incep.npz", device="cpu").state_dict()
    assert torch.equal(got["Mixed_7c.branch_pool.bn_var"],
                       sd["Mixed_7c.branch_pool.bn.running_var"])
    assert torch.equal(got["Conv2d_1a_3x3.conv.weight"],
                       sd["Conv2d_1a_3x3.conv.weight"])
    _, params = jinc.load_inception("w/incep.npz")
    np.testing.assert_array_equal(
        np.asarray(params["Conv2d_1a_3x3"]["conv"]["kernel"]),
        sd["Conv2d_1a_3x3.conv.weight"].numpy().transpose(2, 3, 1, 0))


@pytest.mark.parametrize("name,args,artifact", [
    ("compute_stats_forward", ["--dataset_name", "mnist",
                               "--forward_stats.n_samples", "32",
                               "--forward_stats.batch_size", "32",
                               "--forward_stats.n_temps", "6"],
     "stats/mnist_forward.npz"),
    ("compute_stats_metric", ["--dataset", "mnist", "--n_samples", "32",
                              "--n_temps", "6"], "stats/mnist_metric.npz"),
    ("sample", TRUE_MODEL + ["--sample.n_steps", "4", "--sample.n_samples", "8",
                             "--sample.batch_size", "8"],
     "samples/mnist_true_4_ddim_steps.npz"),
])
def test_cli_argv_surface(workdir, name, args, artifact):
    r = run_module(name, *args, *CPU, cwd=workdir)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"saved {artifact.removesuffix('.npz')}" in r.stdout
    assert os.path.exists(artifact)


def test_clis_need_the_card_unless_told_cpu(workdir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        sample.main(argv=TRUE_MODEL)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_stats_metric.main(["--dataset", "mnist"])
    for cli in (check_config, check_distance, schedule_ordering_exp,
                metric_schedule_exp, longrun_endurance, endurance_schedule_table,
                endurance_solver_table, optimize_schedule_flagship):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([])


@pytest.mark.parametrize("name,args,printed,artifact", [
    ("check_config", [], "config OK: experiment=cifar10_unet_eps_linear_beta_schedule",
     None),
    ("schedule_ordering_exp", ["--dim", "4", "--n_data", "1000", "--n_eval", "64",
                               "--n_temps", "6", "--steps", "3", "--min_temp", "1e-4"],
     "wrote schedule_ordering.md + stats/schedule_ordering.npz",
     "stats/schedule_ordering.npz"),
])
def test_experiment_cli_argv_surface(tmp_path, name, args, printed, artifact):
    r = run_module(name, *args, *CPU, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert printed in r.stdout
    assert artifact is None or (tmp_path / artifact).exists()


# ---------------------------------------------------------------------------
# serving export and the offline experiment CLIs
# ---------------------------------------------------------------------------

import jax.numpy as jnp  # noqa: E402

from pdm_tpu.ops.mmd import mmd_rbf as j_mmd_rbf  # noqa: E402
from pdm_tpu.stats import hypersphere as jhyper  # noqa: E402
from pdm_tpu.stats import mc_metric as jmc  # noqa: E402
from pdm_tpu.stats import model_metric as jmm  # noqa: E402
from pdm_tpu.stats.sweep import thermo_sweep as j_thermo_sweep  # noqa: E402
from pdm_tpu.diffusion.sampling import DDPMSampler as JSampler  # noqa: E402
from pdm_tpu.models.base import TrueDDPM as JTrueDDPM  # noqa: E402
from pdm_tpu.schedulers.analytic import (  # noqa: E402
    LinearBetaScheduler as JLinear, LogSNRScheduler as JLogSNR,
)

from pdm_tpu_torch.scripts import (  # noqa: E402
    analyze_synthetic_stats, compute_model_metric_schedule,
    compute_stats_empirical, e2e_synthetic, export_sampler,
    reproduce_high_dim, sample_gmm, verify_logsnr_metric, verify_mc_metric,
    verify_rescaled_metric,
)
from pdm_tpu_torch.scripts.sample import build_sampler  # noqa: E402
from pdm_tpu_torch.utils.data import get_data_tensor  # noqa: E402
from pdm_tpu_torch.utils.serving import load_exported  # noqa: E402
from pdm_tpu_torch.utils.synthetic import (  # noqa: E402
    generate_anisotropic_gmm, generate_gmm_1d, sample_on_hypersphere,
)
from test_torch_stats import jax_draws  # noqa: E402
from test_torch_true_model import _mc_draws, jax_metric_draws  # noqa: E402
from torch_port_fixtures import jax_sampler_draws  # noqa: E402

GMM_EXPORT = ["--dataset_name", "gmm1d", "--ddpm.model_name", "true",
              "--ddpm.parametrization", "x0", "--ddpm.noise_schedule_type",
              "log_snr", "--diffusion.min_temp", "1e-4", "--diffusion.max_temp",
              "1e1", "--sample.n_steps", "6", "--sample.batch_size", "32",
              "--sample.n_samples", "32", "--sample.step_type", "ddim"]


def test_export_sampler_cli(tmp_path, monkeypatch, capsys):
    """tests/test_scripts_smoke.py::test_export_sampler_cli's flags; the
    artifact replays the sampler the flags build, bitwise."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "gmm.pt2")
    assert export_sampler.main([*GMM_EXPORT, "--out", path, *CPU]) == path
    assert f"exported {path}" in capsys.readouterr().out
    assert (tmp_path / "gmm.pt2.json").exists()
    fn, manifest = load_exported(path)
    assert manifest["step_type"] == "ddim" and manifest["n_steps"] == 6
    sampler = build_sampler(port_config(GMM_EXPORT), device="cpu")
    want = sampler.batch_sample(torch.Generator().manual_seed(7))["x"]
    assert torch.equal(fn(7), want)
    # the default path, JAX's form with .pt2
    argv = [*GMM_EXPORT, "--sample.n_steps", "3"]
    out = export_sampler.main([*argv, *CPU])
    cfg = port_config(argv)
    assert out == (f"serving/{cfg.experiment_name}_"
                   f"{cfg.sample.noise_schedule_type}3.pt2")
    assert os.path.exists(out) and os.path.exists(out + ".json")


@pytest.mark.parametrize("name", ["mc", "logsnr", "rescaled"])
def test_verify_metric_clis_match_jax(tmp_path, monkeypatch, name):
    """Each verify CLI's MC estimates against pdm_tpu.stats.mc_metric on
    the same points and JAX's own draws (the tolerance of the port's
    estimator tests), beside its closed form."""
    monkeypatch.chdir(tmp_path)
    n, n_y, k = 200, 300, 4
    x = np.array(jax.random.normal(jax.random.PRNGKey(42), (n, 1)))
    draws = [_mc_draws(jax.random.PRNGKey(i), n, 1, n_y) for i in range(k)]
    script = {"mc": verify_mc_metric, "logsnr": verify_logsnr_metric,
              "rescaled": verify_rescaled_metric}[name]
    size = {"mc": "n_sigmas", "logsnr": "n_lambdas", "rescaled": "n_sigma_sqs"}[name]
    got = script.main(CPU, n_points=n, n_y=n_y, x=x, draws=draws, **{size: k})
    grid = got[{"mc": "sigma", "logsnr": "lambda", "rescaled": "sigma_sq"}[name]]
    for i, g in enumerate(grid):
        key = jax.random.PRNGKey(i)
        if name == "rescaled":
            want = float(jmc.rescaled_metric_diag(
                jnp.asarray([g], jnp.float32), jnp.asarray(x), key, n_y=n_y)[0])
            mine = got["mc"][i]
        else:
            lam = float(np.log(g ** 2)) if name == "mc" else float(g)
            want = float(jmc.metric_scalar(jnp.asarray(lam), jnp.asarray(x), key,
                                           n_y=n_y))
            mine = got["mc"][i] / ((2.0 / g) ** 2 if name == "mc" else 1.0)
        np.testing.assert_allclose(mine, want, rtol=1e-4, atol=1e-5)
    assert np.all(np.isfinite(got["analytical"])) and len(got["mc"]) == k


def test_sample_gmm_cli_matches_jax(tmp_path, monkeypatch):
    """The CLI's sampler on JAX's draws against JAX's sampler (1e-4, the
    port's GMM sampling tolerance) and its MMD against JAX's mmd_rbf on the
    same samples."""
    monkeypatch.chdir(tmp_path)
    n_data, n_samples, n_ref = 5000, 20, 1000
    key = jax.random.PRNGKey(0)
    draws = jax_sampler_draws(key, 10, (n_samples, 1, 1, 1))
    got = sample_gmm.main(CPU, n_data=n_data, n_samples=n_samples, n_ref=n_ref,
                          draws=draws)
    data = generate_gmm_1d(n_data)
    want = JSampler(
        ddpm=JTrueDDPM(scheduler=JLogSNR(1e-4, 1e1), train_data=jnp.asarray(data)),
        scheduler=JLogSNR(1e-4, 1e1), n_steps=10, obj_size=(1, 1, 1),
        batch_size=n_samples, n_samples=n_samples, step_type="ddpm",
        track_states=True).batch_sample(key)
    x = got["Initial"]["x"]
    np.testing.assert_allclose(x, np.asarray(want["x"]).reshape(-1), rtol=0,
                               atol=1e-4)
    assert got["states"].shape == np.asarray(want["states"]).shape
    mmd = float(j_mmd_rbf(jnp.asarray(x[:, None]),
                          jnp.asarray(data[:n_ref]).reshape(-1, 1), sigmas=(0.1,)))
    # the MMD is a difference of means of O(1) kernel values over up to
    # 10^6 pairs, summed in fp32 in two orders: 1e-6 absolute
    np.testing.assert_allclose(got["Initial"]["mmd"], mmd, rtol=1e-5, atol=1e-6)


def test_analyze_synthetic_stats_cli_matches_jax(tmp_path, monkeypatch):
    """The Bessel oracle against pdm_tpu.stats.hypersphere, the MC curves
    against JAX's thermo_sweep on the same points and JAX's draws."""
    monkeypatch.chdir(tmp_path)
    d, sizes, n_s = 10, [60, 120], 32
    got = analyze_synthetic_stats.main(
        ["--d", str(d), "--sizes", *map(str, sizes), "--n_samples", str(n_s),
         *CPU], draws=lambda n, seed: jax_draws(jax.random.PRNGKey(seed), n, d,
                                                n_s, n_s))
    temps = got["temp"]
    want = jhyper.marginal_stats(temps, d=d)
    for k in ("S", "C"):
        np.testing.assert_allclose(got["oracle"][k], want[k], rtol=1e-12)
    for n, curves in [*got["curves"].items(), (max(sizes), got["check"])]:
        seed = 1 if curves is got["check"] else 0
        data = sample_on_hypersphere(d, n=n, radius=1.0, seed=0)
        ref = j_thermo_sweep(jax.random.PRNGKey(seed), jnp.asarray(data), temps,
                             n_samples=n_s, batch_size=n_s)
        for k in ("entropy", "heat_capacity"):
            w = np.asarray(ref[k], np.float64)
            np.testing.assert_allclose(curves[k], w, rtol=1e-5,
                                       atol=1e-5 * (1.0 + np.abs(w).max()))
    mid = analyze_synthetic_stats.MID
    assert got["mid_err"] == pytest.approx(
        np.abs(got["check"]["entropy"][mid] - want["S"][mid]).max())


def test_compute_stats_empirical_cli_matches_jax(workdir):
    """TrueDDPM on the MNIST-shaped cache: the npz against JAX's
    empirical_entropy_stats on the same data and JAX's draws."""
    key = jax.random.PRNGKey(0)
    n_temps, per_temp, bs = 5, 2, 8
    args = [*TRUE_MODEL, "--empirical_stats.n_temps", str(n_temps),
            "--empirical_stats.n_steps_per_temp", str(per_temp),
            "--empirical_stats.batch_size", str(bs)]
    draws = jax_metric_draws(key, N_TRAIN, (1, 32, 32), n_temps,
                             per_temp * bs, bs, "vp")
    written = compute_stats_empirical.main(argv=[*args, *CPU], draws=draws)
    cfg = port_config(args)
    path = cfg.empirical_stats_path
    assert list(written) == [path]
    out = np.load(path)
    assert set(out.files) == {"temp", "entropy", "rescaled_entropy",
                              "d_entropy_d_log_temp"}
    data = get_data_tensor(cfg, device="cpu").numpy()
    temp = np.logspace(np.log10(1e-4), np.log10(2.478e4), n_temps)
    want = jmm.empirical_entropy_stats(
        key, JTrueDDPM(scheduler=JLinear(1e-4, 2.478e4),
                       train_data=jnp.asarray(data.transpose(0, 2, 3, 1))),
        jnp.asarray(data.transpose(0, 2, 3, 1)), temp, n_samples=per_temp * bs,
        batch_size=bs)
    np.testing.assert_allclose(out["temp"], temp)
    for k in ("entropy", "rescaled_entropy", "d_entropy_d_log_temp"):
        assert out[k].shape == (n_temps,)
        np.testing.assert_allclose(out[k], want[k], rtol=1e-4, atol=1e-6)


def test_compute_model_metric_schedule_cli_matches_jax(workdir, monkeypatch):
    """The metric statistics against JAX's model_metric_stats on JAX's
    draws; the dense schedule table builds a custom schedule."""
    import shutil

    from pdm_tpu_torch.config.loader import DEFAULT_CONFIG_PATH
    from pdm_tpu_torch.schedulers.interpolated import custom_scheduler

    yaml_dir = workdir / "yaml"
    shutil.copytree(os.path.dirname(DEFAULT_CONFIG_PATH), yaml_dir)
    root = (yaml_dir / "config.yaml").read_text()
    (yaml_dir / "config.yaml").write_text(
        root.replace("dataset_name: cifar10", "dataset_name: mnist"))
    ddpm_yaml = (yaml_dir / "groups" / "ddpm.yaml").read_text()
    (yaml_dir / "groups" / "ddpm.yaml").write_text(
        ddpm_yaml.replace("model_name: unet", 'model_name: "true"')
        .replace("parametrization: eps", "parametrization: x0"))
    monkeypatch.setenv("PDM_CONFIG", str(yaml_dir / "config.yaml"))
    key = jax.random.PRNGKey(0)
    n_s, n_temps = 24, 5
    draws = jax_metric_draws(key, N_TRAIN, (1, 32, 32), n_temps, n_s, 256, "ve")
    got = compute_model_metric_schedule.main(
        ["--n_samples", str(n_s), "--n_temps", str(n_temps), *CPU], draws=draws)
    assert got["stats_path"] == "stats/mnist_metric_model.npz"
    stats = np.load(got["stats_path"])
    assert set(stats.files) == {"temp", "metric", "log_temp", "dataset_tr_sigma0"}
    data = get_data_tensor(load_config(), device="cpu").numpy().transpose(0, 2, 3, 1)
    temp = np.logspace(np.log10(1e-4), np.log10(2.478e4), n_temps)
    want = jmm.model_metric_stats(
        key, JTrueDDPM(scheduler=JLinear(1e-4, 2.478e4),
                       train_data=jnp.asarray(data)),
        jnp.asarray(data), temp, n_samples=n_s)
    np.testing.assert_allclose(stats["metric"], want["metric"], rtol=1e-4,
                               atol=1e-6)
    table = np.load(got["schedule_path"])
    assert got["schedule_path"] == "stats/mnist_metric_model_schedule.npz"
    assert table["log_temp"].shape == table["timestamps"].shape == (n_temps,)
    assert table["timestamps"][0] == 0.0 and table["timestamps"][-1] == 1.0
    sched = custom_scheduler(got["schedule_path"], device="cpu")
    assert np.isfinite(sched.log_temp_from_tau(torch.linspace(0, 1, 5)).numpy()).all()


def test_reproduce_high_dim_cli(tmp_path, monkeypatch, capsys):
    """At a cut size: the npz keys and shapes JAX's script writes, the
    sweep against JAX's thermo_sweep on JAX's draws, and the KL column
    skipped with its reason where scikit-learn is missing."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PDM_CONFIG", raising=False)
    monkeypatch.setattr(reproduce_high_dim, "kl_backend",
                        lambda: "sklearn is not installed")
    n_train, n_temps, n_s = 300, 8, 32
    got = reproduce_high_dim.main(
        CPU, n_train=n_train, n_gen=50, n_temps=n_temps, sweep_samples=n_s,
        sweep_batch=n_s, n_steps=3,
        draws=jax_draws(jax.random.PRNGKey(0), n_train, 100, n_s, n_s))
    fwd = np.load("stats/anisotropic_gmm_repro_forward.npz")
    met = np.load("stats/anisotropic_gmm_repro_metric.npz")
    assert set(fwd.files) == {"temp", "entropy"}
    assert set(met.files) == {"temp", "metric", "log_temp", "dataset_tr_sigma0"}
    assert fwd["entropy"].shape == met["metric"].shape == (n_temps,)
    data, _, _ = generate_anisotropic_gmm(dim=100, n_components=5,
                                          n_samples=n_train)
    temps = np.logspace(-4, 4, n_temps)
    want = j_thermo_sweep(jax.random.PRNGKey(0), jnp.asarray(data), temps,
                          n_samples=n_s, batch_size=n_s)
    for k in ("entropy", "metric"):
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got["stats"][k], w, rtol=1e-5,
                                   atol=1e-5 * (1.0 + np.abs(w).max()))
    out = capsys.readouterr().out
    assert "KL skipped: sklearn is not installed" in out
    assert set(got["table"]) == {"Baseline (True)", "Cosine", "Metric"}
    for row in got["table"].values():
        assert row["kl"] is None and np.isfinite(row["mmd"])
        np.testing.assert_allclose(row["occupancy"].sum(), 1.0)


def test_e2e_synthetic_cli(tmp_path, monkeypatch, capsys):
    """A few train steps of the blob UNet, then sampling and LeNet FID on
    every schedule: the pipeline runs and reports."""
    monkeypatch.chdir(tmp_path)
    got = e2e_synthetic.main(["--steps", "2", "--n_data", "300", "--batch_size",
                              "16", "--fid_samples", "64", "--sample_steps", "2",
                              *CPU])
    assert [r[:2] for r in got["results"]] == [
        ("linear_beta", 2), ("cosine", 2), ("entropy", 2)]
    assert np.isfinite(got["floor"]) and np.isfinite(got["best_fid"])
    assert capsys.readouterr().out.splitlines()[-1].startswith("RESULT best_fid=")
