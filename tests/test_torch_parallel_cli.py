"""The port's multi-process start and one entry point on two ranks (gloo,
CPU), as ``torchrun --nproc_per_node 2`` launches them: the environment
gives ``MASTER_ADDR``, ``MASTER_PORT`` (a free local port), ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``.

* ``initialize_multihost()`` with no arguments joins both processes in
  one gloo group on the CPU (JAX's ``tests/test_multihost.py:54`` starts
  two processes the same way), and a collective over it adds up.
* ``compute_stats_forward`` on two ranks, each in its own working
  directory: only rank 0 writes the statistics, which equal one
  process's (entropy rtol 1e-4 atol 1e-5, as
  ``tests/test_parallel.py:51``; the dataset is split across the ranks).
* ``train_diffusion`` with ``--parallel.model_axis 2`` (channel) and then
  ``sample`` with a spatial model axis, on two ranks sharing a working
  directory with MNIST-shaped caches: rank 0's checkpoint equals one
  process's (1e-5: fp32 sums regrouped over the two ranks' channels, two
  Adam steps; to_k's bias, which has no gradient in exact arithmetic,
  within Adam's 2 lr a step) and the samples equal one process's from it
  (1e-4 of the scale).
"""

import os
import socket

import numpy as np
import pytest

import torch

from pdm_tpu_torch import runtime
from pdm_tpu_torch.scripts import compute_stats_forward
from pdm_tpu_torch.utils.data import pdmc_cache_path
from torch_dist_workers import launch, run_model_cli
from torch_port_fixtures import two_torch_threads  # noqa: F401


def _torchrun_env():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "RANK": "{rank}", "LOCAL_RANK": "{rank}", "WORLD_SIZE": "2"}


def test_initialize_multihost_from_torchrun_environment(tmp_path):
    outs = launch("env_multihost", 2, str(tmp_path), env=_torchrun_env())
    for r, out in enumerate(outs):
        assert int(out["world"]) == 2 and int(out["rank"]) == r
        assert str(out["backend"]) == "gloo"
        np.testing.assert_array_equal(out["sum"], [3.0, 3.0, 3.0])


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    return tmp_path


def test_compute_stats_forward_on_two_ranks_writes_on_rank_0(in_tmp):
    dirs = [in_tmp / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    launch("env_stats_cli", 2, str(in_tmp), env=_torchrun_env(),
           cwd=lambda r: str(dirs[r]))
    path = os.path.join("stats", "gmm1d_forward.npz")
    assert (dirs[0] / path).exists() and not (dirs[1] / path).exists()
    compute_stats_forward.main(argv=[
        "--dataset_name", "gmm1d", "--forward_stats.n_samples", "64",
        "--forward_stats.batch_size", "32", "--forward_stats.n_temps", "8",
        "--device", "cpu"])
    got, want = np.load(dirs[0] / path), np.load(in_tmp / path)
    assert set(got.files) == set(want.files)
    np.testing.assert_array_equal(got["temp"], want["temp"])
    np.testing.assert_allclose(got["entropy"], want["entropy"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["free_energy"], want["free_energy"],
                               rtol=1e-4, atol=1e-4)


def test_model_axis_train_and_sample_clis_on_two_ranks(in_tmp, monkeypatch):
    cache = in_tmp / "data_cache"
    monkeypatch.setenv("PDM_DATA_CACHE", str(cache))
    monkeypatch.delenv("PDM_INCEPTION_WEIGHTS", raising=False)
    cache.mkdir()
    rng = np.random.RandomState(0)
    for train, n in ((True, 64), (False, 32)):
        runtime.write_cache(pdmc_cache_path("mnist", train),
                            rng.randint(0, 256, (n, 32, 32, 1), dtype=np.uint8))
    ranks, one = in_tmp / "ranks", in_tmp / "one"
    ranks.mkdir()
    one.mkdir()
    launch("env_model_cli", 2, str(in_tmp),
           env={**_torchrun_env(), "PDM_DATA_CACHE": str(cache)},
           cwd=lambda r: str(ranks))
    monkeypatch.chdir(one)
    run_model_cli()
    exp = "mnist_unet_eps_linear_beta_schedule"
    ckpt = os.path.join("checkpoints", exp, "step_2", "state.pt")
    got = torch.load(ranks / ckpt, weights_only=True)
    want = torch.load(one / ckpt, weights_only=True)
    # to_k's bias has no gradient in exact arithmetic (the softmax does not
    # see a bias added to every key), so Adam turns its rounding noise into
    # steps of up to the rate, either way: 2 lr a step apart (lr 2e-4)
    for key in ("params", "ema_params"):
        for name, t in want[key].items():
            tol = 2 * 2 * 2e-4 if name.endswith("to_k.bias") else 1e-5
            np.testing.assert_allclose(got[key][name].numpy(), t.numpy(), rtol=0,
                                       atol=tol, err_msg=name)
    path = os.path.join("samples", f"{exp}_3_ddim_steps.npz")
    xs, xw = np.load(ranks / path)["x"], np.load(one / path)["x"]
    assert xs.shape == xw.shape == (4, 1, 32, 32)
    np.testing.assert_allclose(xs, xw, rtol=0, atol=1e-4 * float(np.abs(xw).max()))
