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
    compute_fid, compute_stats_forward, compute_stats_metric,
    sample, train_diffusion, train_lenet,
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
