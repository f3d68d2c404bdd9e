"""Port parity: the port's utilities against the JAX package's.

* ``utils/synthetic.py``: every generator, draw for draw (exact).
* ``stats/hypersphere.py``: the closed forms on tests/test_hypersphere_misc.py's
  cases, equal to JAX's (the same float64 code: exact), and that file's
  own known-answer checks with its tolerances.
* ``utils/misc.py``: ``batch_jacobian`` against JAX's on the same function
  (fp32, 1e-6) and the hand-computed Jacobian; ``compute_cdf`` exactly.
* ``utils/profiling.py``: ``PhaseTimer``'s summary keys and report layout
  equal JAX's for the same totals; a trace writes a Chrome trace.
* ``utils/logging.py``: the CSV rows equal JAX's ``CSVLogger``'s for the
  same calls (the time column aside); the PNG grid decodes (PIL, when
  installed, and the port's reader) to the grid array exactly; the eval
  hook writes its grid and, without Inception weights, warns that FID is
  unavailable and refuses ``fid.required`` (tests/test_torch_fid.py
  holds the hook with FID).
"""

import csv
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.stats import hypersphere as jh
from pdm_tpu.utils import logging as jlog
from pdm_tpu.utils import misc as jmisc
from pdm_tpu.utils import synthetic as jsyn
from pdm_tpu.utils.profiling import PhaseTimer as JPhaseTimer

from pdm_tpu_torch.config.loader import load_config
from pdm_tpu_torch.models.base import TrueDDPM
from pdm_tpu_torch.schedulers.analytic import LogSNRScheduler
from pdm_tpu_torch.stats import hypersphere as th
from pdm_tpu_torch.utils import logging as tlog
from pdm_tpu_torch.utils import misc as tmisc
from pdm_tpu_torch.utils import synthetic as tsyn
from pdm_tpu_torch.utils.profiling import PhaseTimer, annotate, trace
from pdm_tpu_torch.utils.timing import Timer, sync
from torch_port_fixtures import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("name,args", [
    ("generate_simplex", (7,)), ("generate_cross_polytope", (5,)),
    ("sample_on_hypersphere", (6,)), ("sample_on_hypersphere", (4, 50, 2.0, 3)),
    ("generate_gaussian", (9,)), ("generate_gaussian", (3, 20, 5)),
    ("generate_gmm_1d", (500,)), ("generate_dataset", ("simplex", 4)),
    ("generate_dataset", ("cross-polytope", 3)),
    ("generate_dataset", ("hypersphere", 5)), ("generate_dataset", ("gaussian", 8)),
])
def test_synthetic_generators_match_jax(name, args):
    got, want = getattr(tsyn, name)(*args), getattr(jsyn, name)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_generate_dataset_rejects_unknown_names():
    with pytest.raises(ValueError, match="Invalid name"):
        tsyn.generate_dataset("torus")


@pytest.mark.parametrize("nu,z", [
    (4.0, [1.0, 5.0, 50.0]), (4.0, [1e3]), (4.0, [1e-4]),
    (510.0, [50.0, 100.0, 400.0]), (1535.0, [50.0, 100.0, 400.0, 3000.0]),
])
def test_log_iv_and_bessel_ratio_match_jax(nu, z):
    z = np.asarray(z)
    np.testing.assert_array_equal(th.log_iv(nu, z), jh.log_iv(nu, z))
    np.testing.assert_array_equal(th._bessel_ratio(nu, z), jh._bessel_ratio(nu, z))


@pytest.mark.parametrize("r,d", [(1.3, 8), (1.1, 1024), (1.0, 1024)])
def test_pointwise_closed_forms_match_jax(r, d):
    temps = np.logspace(-3, 1, 50)
    for fn in ("entropy", "heat_capacity", "internal_energy", "log_partition"):
        np.testing.assert_array_equal(getattr(th, fn)(r, temps, d),
                                      getattr(jh, fn)(r, temps, d))


def test_marginal_stats_match_jax_and_known_answers():
    temps = np.logspace(-3, 4, 15)
    got, want = th.marginal_stats(temps, d=10), jh.marginal_stats(temps, d=10)
    for k in ("S", "C", "U", "log_Z"):
        np.testing.assert_array_equal(got[k], want[k])
    # tests/test_hypersphere_misc.py's limits
    np.testing.assert_allclose(got["S"][-1], 0.0, atol=0.01)
    assert got["C"][-1] < 0.05
    np.testing.assert_allclose(got["C"][0], (10 - 1) / 2.0, rtol=0.05)
    assert np.all(np.diff(got["S"]) > -1e-6)
    hi = th.marginal_stats(np.logspace(-2, 3, 8), d=1024)
    assert np.all(hi["S"] <= 1e-6) and abs(hi["S"][-1]) < 0.05
    temps = np.logspace(-1, 1, 400)
    s, c = th.entropy(1.3, temps, 8), th.heat_capacity(1.3, temps, 8)
    ds = np.gradient(s, np.log(temps))
    np.testing.assert_allclose(c[40:360], ds[40:360], rtol=0.05, atol=0.02)


def test_batch_jacobian_matches_jax():
    def f_t(x):
        return torch.stack([x[:, 0] * x[:, 1], x[:, 0] ** 2], dim=1)

    def f_j(x):
        return jnp.stack([x[:, 0] * x[:, 1], x[:, 0] ** 2], axis=1)

    x = np.array([[2.0, 3.0], [1.0, -1.0]], np.float32)
    jac = tmisc.batch_jacobian(f_t, torch.from_numpy(x)).numpy()
    assert jac.shape == (2, 2, 2)
    np.testing.assert_allclose(jac[0], [[3.0, 2.0], [4.0, 0.0]], atol=1e-6)
    np.testing.assert_allclose(jac, np.asarray(jmisc.batch_jacobian(f_j, x)),
                               atol=1e-6)
    w = np.random.RandomState(0).standard_normal((3, 5)).astype(np.float32)
    xs = np.random.RandomState(1).standard_normal((4, 5)).astype(np.float32)
    got = tmisc.batch_jacobian(lambda v: torch.tanh(v @ torch.from_numpy(w).T),
                               torch.from_numpy(xs)).numpy()
    want = np.asarray(jmisc.batch_jacobian(lambda v: jnp.tanh(v @ w.T), xs))
    assert got.shape == (4, 3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_compute_cdf_matches_jax():
    x = np.linspace(0, 1, 11)
    for p in (np.ones(11), np.exp(-x * 3)):
        got = tmisc.compute_cdf(x, p)
        np.testing.assert_array_equal(got, jmisc.compute_cdf(x, p))
        assert got[0] == 0.0 and got[-1] == 1.0 and np.all(np.diff(got) >= 0)


def test_phase_timer_keys_and_report_match_jax():
    t, j = PhaseTimer(), JPhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("b", sync_tree={"x": torch.ones(3)}):
        pass
    for timer in (t, j):
        timer.totals.clear()
        timer.counts.clear()
        timer.totals.update({"data": 0.25, "train_step": 3.5})
        timer.counts.update({"data": 10, "train_step": 10})
    assert t.summary() == j.summary()
    assert t.report() == j.report()


def test_trace_timer_and_sync(tmp_path):
    with trace(str(tmp_path / "tb")):
        with annotate("smoke"):
            _ = torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "tb")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "smoke" in (tmp_path / "tb" / files[0]).read_text()
    with Timer(sync_tree=[torch.ones(2)]) as tm:
        pass
    assert tm.elapsed >= 0.0 and tm.device_elapsed is None
    sync({"a": [torch.zeros(1)], "b": 3})  # CPU tensors: nothing to wait for


def test_csv_rows_match_jax(tmp_path):
    calls = [(1, {"loss": 0.5, "lr": 1e-3}), (2, {"loss": np.float32(0.25)}),
             (10, {"fid": 12.0, "grad_norm": 3})]
    rows = []
    for mod, name in ((tlog, "port.csv"), (jlog, "jax.csv")):
        logger = mod.CSVLogger(str(tmp_path / "sub" / name))
        for step, metrics in calls:
            logger(step, metrics)
        with open(tmp_path / "sub" / name) as f:
            rows.append([r[:3] for r in csv.reader(f)])
    assert rows[0] == rows[1]
    assert rows[0][0] == ["step", "metric", "value"] and len(rows[0]) == 6


@pytest.mark.parametrize("channels", [1, 3])
def test_png_grid_decodes_to_the_grid(tmp_path, channels):
    imgs = np.random.RandomState(0).uniform(
        -1, 1, (9, channels, 8, 6)).astype(np.float32)
    path = str(tmp_path / "grid.png")
    tlog.save_image_grid(imgs, path, nrow=4)
    grid = tlog.image_grid(imgs, nrow=4)
    assert grid.shape == ((24, 24) if channels == 1 else (24, 24, 3))
    np.testing.assert_array_equal(tlog.read_png(path), grid)
    # PIL decodes the port's PNG to the grid, and the JAX package's grid
    # (written through PIL) holds the same pixels
    pil = pytest.importorskip("PIL.Image")
    with pil.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), grid)
    jlog.save_image_grid(imgs, str(tmp_path / "jax.png"), nrow=4)
    with pil.open(str(tmp_path / "jax.png")) as im:
        np.testing.assert_array_equal(np.asarray(im), grid)


def test_png_writer_refuses_other_shapes(tmp_path):
    with pytest.raises(ValueError, match="H, W"):
        tlog.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 2), np.uint8))


def test_eval_fn_writes_the_grid_and_warns(tmp_path, monkeypatch):
    """Without PDM_INCEPTION_WEIGHTS the FID extractor is unavailable: the
    hook warns at every eval and fid.required refuses it."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PDM_INCEPTION_WEIGHTS", raising=False)
    cfg = load_config()
    cfg.dataset_name = "gmm1d"
    cfg.diffusion.min_temp, cfg.diffusion.max_temp = 1e-4, 1e1
    cfg.ddpm.noise_schedule_type = "log_snr"
    data = torch.from_numpy(tsyn.generate_gmm_1d(2_000))
    ddpm = TrueDDPM(scheduler=LogSNRScheduler(1e-4, 1e1), train_data=data,
                    device="cpu")
    eval_fn = tlog.make_eval_fn(cfg, data, sample_dir=str(tmp_path / "ev"),
                                device="cpu")
    with pytest.warns(UserWarning, match="FID unavailable"):
        metrics = eval_fn(ddpm, step=5)
    assert metrics == {}
    grid = tlog.read_png(str(tmp_path / "ev" / "step_5.png"))
    assert grid.shape == (5, 5) and grid.dtype == np.uint8
    # the 25 samples sit near the GMM's modes at +-0.9 and +-1.1
    values = grid.astype(np.float64) / 255.0 * 2.0 - 1.0
    assert np.all(np.abs(np.abs(values) - 1.0) < 0.2)
    cfg.fid.required = True
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="fid.required"):
            tlog.make_eval_fn(cfg, data, sample_dir=str(tmp_path / "ev"),
                              device="cpu")
