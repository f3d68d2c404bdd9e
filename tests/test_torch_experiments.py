"""Port parity: the schedule experiments and the flagship endurance chain
(pdm_tpu_torch/scripts/: check_config, check_distance,
schedule_ordering_exp, metric_schedule_exp, longrun_endurance,
endurance_schedule_table, endurance_solver_table,
optimize_schedule_flagship) against the JAX package, on the CPU.

* make_rgb_blob_dataset bitwise JAX's; the flagship config's parameter
  names and shapes JAX's (jax.eval_shape, mapped by from_flax_params).
* schedule_ordering_exp on JAX's sweep and sampler draws against JAX's
  own script (its npz tables) and JAX's schedulers (the grids).
* check_distance and check_config print what JAX's print.
* metric_schedule_exp on an MNIST-shaped cache with a port-trained tiny
  checkpoint and a port-written LeNet: its metric npz, on JAX's draws, is
  JAX's metric_stats and builds JAX's metric schedule, and it prints
  three finite FIDs.
* The endurance chain at a tiny width (a conv-only UNet, 256 images, 4
  steps): the crash drill (os._exit patched to raise) then a relaunch
  gives params, EMA and Adam moments bitwise those of an uninterrupted
  run; both tables and the flagship optimizer on its checkpoint (the
  schedule table's entropy and metric schedules, on JAX's draws, JAX's
  sweeps and schedulers); JAX's
  analyze_endurance reads the port's CSV and result JSON.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.diffusion.sampling import discretize_schedule as j_discretize
from pdm_tpu.models.unet import unet_from_config as j_unet_from_config
from pdm_tpu.schedulers.analytic import LogSNRScheduler as JLogSNR
from pdm_tpu.schedulers.interpolated import (
    entropy_scheduler as j_entropy_scheduler,
    fisher_rao_arc_length as j_fisher_rao_arc_length,
    metric_scheduler as j_metric_scheduler,
    metric_scheduler_from_npz as j_metric_scheduler_from_npz,
)
from pdm_tpu.stats.sweep import (
    forward_stats as j_forward_stats,
    metric_stats as j_metric_stats,
    thermo_sweep as j_thermo_sweep,
)

from pdm_tpu_torch.config.loader import DEFAULT_CONFIG_PATH, load_config
from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
from pdm_tpu_torch.models.from_config import ddpm_from_config
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.scripts import (
    check_config, check_distance, endurance_schedule_table,
    endurance_solver_table, longrun_endurance, metric_schedule_exp,
    optimize_schedule_flagship, schedule_ordering_exp,
)
from pdm_tpu_torch.utils.data import get_data_tensor
from pdm_tpu_torch.utils.synthetic import generate_anisotropic_gmm
from test_torch_scripts import jax_config, port_lenet, workdir  # noqa: F401
from test_torch_stats import _close, jax_draws
from torch_port_fixtures import jax_sampler_draws, two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

CPU = ["--device", "cpu"]
# conv-only, so that a DDIM-100 eval costs ~1 s on the CPU
TINY = {"block_out_channels": [8, 16], "down_block_types": ["DownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "UpBlock2D"], "layers_per_block": 1,
        "norm_groups": 4, "dropout": 0.1, "add_mid_attention": False}
ENDURANCE = ["--steps", "4", "--n_data", "256", "--batch_size", "4", "--warmup", "2",
             "--eval_every", "2", "--ckpt_every", "2", "--eval_samples", "4", *CPU]
CRASH_AT = 3
TAU_TOL = 1e-5


def jax_script_main(name, argv, monkeypatch):
    """scripts/{name}.py's main() under ``argv``, in this process."""
    import importlib

    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return importlib.import_module(name).main()


# ---------------------------------------------------------------------------
# the shared pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,size,seed", [(40, 32, 0), (7, 16, 3)])
def test_blob_dataset_is_jax_bitwise(n, size, seed):
    from longrun_endurance import make_rgb_blob_dataset as j_blobs

    got = longrun_endurance.make_rgb_blob_dataset(n, size, seed)
    want = j_blobs(n, size, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_flagship_config_is_jax_layout():
    """The one flagship dict of the port's endurance scripts against JAX's
    (longrun_endurance.py:100-111): every parameter's name and shape, by
    jax.eval_shape (no 47 M init) and the port's module on the meta
    device. The dict itself equals each of JAX's four copies."""
    import ast

    for name in ("longrun_endurance", "endurance_schedule_table",
                 "endurance_solver_table", "optimize_schedule_flagship"):
        tree = ast.parse(open(os.path.join(REPO, "scripts", f"{name}.py")).read())
        cfg = [ast.literal_eval(node.value) for node in ast.walk(tree)
               if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "cfg"]
        assert cfg == [longrun_endurance.FLAGSHIP_UNET], name
    jnet = j_unet_from_config(3, longrun_endurance.FLAGSHIP_UNET, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)))["params"],
        jax.random.PRNGKey(0))
    want = from_flax_params(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
    net = longrun_endurance.flagship_module("meta")
    got = {k: tuple(p.shape) for k, p in net.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert net.conv_in.weight.dtype == torch.bfloat16  # the compute dtype
    assert sum(int(np.prod(s)) for s in got.values()) == 47_217_027
    for script in (endurance_schedule_table, endurance_solver_table,
                   optimize_schedule_flagship):
        assert script.load_ema_ddpm is longrun_endurance.load_ema_ddpm
        assert script.blob_fid is longrun_endurance.blob_fid
        assert "block_out_channels" not in open(script.__file__).read()


# ---------------------------------------------------------------------------
# item 1: the schedule experiments
# ---------------------------------------------------------------------------

ORDERING = ["--dim", "8", "--n_data", "2000", "--n_eval", "256", "--n_temps", "12",
            "--steps", "5", "10", "--min_temp", "1e-4"]


def test_schedule_ordering_matches_jax(tmp_path, monkeypatch):
    """tests/test_scripts_smoke.py:140-149's sizes. The port's CLI on JAX's
    sweep draws (PRNGKey(0)) and sampler draws (batch 0 of PRNGKey(1000 +
    n)) against JAX's script, which draws the same: the same npz keys; the
    entropy and metric grids JAX's schedulers give on JAX's sweep within
    1e-5 (fp32 sweeps summed in two orders, then the knots'
    interpolation). The tables: NLL within 5e-4 of |NLL| + |floor| and
    MMD within 2e-5 absolute. Five of the schedules agree to 5e-6 and
    5e-7; the entropy schedule's knots (the sweep's entropy differences,
    cut to their increasing subsequence) move its grid by up to ~1e-5,
    which moved its NLL by 7.7e-5 of that scale and its MMD by 3.1e-6 when
    this test was written: the bounds keep a factor ~6 above that."""
    dim, n_data, n_eval, steps = 8, 2000, 256, (5, 10)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_script_main("schedule_ordering_exp", ORDERING, monkeypatch)
    want = dict(np.load("stats/schedule_ordering.npz"))
    samples, _, _ = generate_anisotropic_gmm(dim=dim, n_samples=n_data + n_eval, seed=42)
    train = samples.reshape(len(samples), -1)[:n_data]
    sampler_draws = {n: jax_sampler_draws(
        jax.random.fold_in(jax.random.PRNGKey(1000 + n), 0), n, (n_eval, 1, dim, 1))
        for n in steps}
    monkeypatch.chdir(tmp_path / "port")
    got = schedule_ordering_exp.main(
        ORDERING + CPU, sweep_draws=jax_draws(jax.random.PRNGKey(0), n_data, dim, 512, 512),
        sampler_draws=sampler_draws)
    out = dict(np.load("stats/schedule_ordering.npz"))
    assert set(out) == set(want)
    for k in ("steps", "names", "sigmas"):
        np.testing.assert_array_equal(out[k], want[k])
    np.testing.assert_allclose(out["nll_floor"], want["nll_floor"], rtol=1e-12)
    np.testing.assert_allclose(out["mmd"], want["mmd"], rtol=0, atol=2e-5)
    scale = np.abs(want["nll"]) + abs(float(want["nll_floor"]))
    assert np.all(np.abs(out["nll"] - want["nll"]) <= 5e-4 * scale)
    md = open("schedule_ordering.md").read()
    assert md.splitlines()[0] == open("../jax/schedule_ordering.md").read().splitlines()[0]
    assert "| entropy |" in md and "| metric |" in md
    temps = np.logspace(-4, 3, 12)
    jstats = j_thermo_sweep(jax.random.PRNGKey(0), jnp.asarray(train), temps,
                            n_samples=512, batch_size=512)
    jmodel = JLogSNR(1e-4, 1e3)
    jsched = {"entropy": j_entropy_scheduler(jstats["temp"], jstats["entropy"],
                                             min_temp=1e-4, max_temp=1e3),
              "metric": j_metric_scheduler(jstats["log_temp"], jstats["metric"])}
    max_lt = float(jmodel.log_temp_from_tau(jnp.ones(())))
    for name, sched in jsched.items():
        for n in steps:
            grid = np.asarray(j_discretize(sched, n, max_log_temp=max_lt))
            np.testing.assert_allclose(got["grids"][(name, n)], grid, rtol=1e-5, atol=1e-5)


def test_check_distance_matches_jax(tmp_path, monkeypatch, capsys):
    """Total and fraction against JAX's fisher_rao_arc_length within 1e-6,
    and the same printed lines as JAX's script."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(5)
    log_temp = np.sort(rng.uniform(np.log(1e-4), np.log(1e4), 40))
    metric = np.exp(-log_temp) * (1 + rng.uniform(0, 0.5, 40))
    np.savez("m.npz", temp=np.exp(log_temp), metric=metric, log_temp=log_temp)
    args = ["--stats_path", "m.npz", "--probe_temp", "0.05"]
    capsys.readouterr()
    jax_script_main("check_distance", [*args, "--out", "j.png"], monkeypatch)
    jax_lines = capsys.readouterr().out.splitlines()
    got = check_distance.main([*args, "--out", "t.png", *CPU])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == jax_lines[:2] and lines[2] == "wrote t.png"
    lt, r = j_fisher_rao_arc_length(log_temp, metric)
    i = min(int(np.searchsorted(np.exp(lt), 0.05)), len(lt) - 1)
    assert got["total"] == pytest.approx(r[-1], rel=1e-6)
    assert got["fraction"] == pytest.approx(r[i] / r[-1], rel=1e-6)


def test_check_config_names_jax_experiment(capsys):
    from pdm_tpu.config.loader import load_config as j_load_config

    cfg = check_config.main(CPU)
    want = j_load_config().experiment_name
    assert cfg.experiment_name == want
    assert capsys.readouterr().out.strip() == f"config OK: experiment={want}"


def tiny_mnist_config(root):
    """A copy of the port's config with dataset mnist and a tiny fp32
    UNet, named by PDM_CONFIG."""
    import shutil

    yaml_dir = root / "yaml"
    shutil.copytree(os.path.dirname(DEFAULT_CONFIG_PATH), yaml_dir)
    text = (yaml_dir / "config.yaml").read_text()
    (yaml_dir / "config.yaml").write_text(
        text.replace("dataset_name: cifar10", "dataset_name: mnist"))
    lines = ["model_name: unet", "parametrization: eps",
             "noise_schedule_type: linear_beta", "precision: f32", "unet_config:"]
    for key, val in TINY.items():
        if isinstance(val, list):
            lines += [f"  {key}:"] + [f"    - {v}" for v in val]
        else:
            lines.append(f"  {key}: {str(val).lower() if isinstance(val, bool) else val}")
    (yaml_dir / "groups" / "ddpm.yaml").write_text("\n".join(lines) + "\n")
    return yaml_dir / "config.yaml"


def test_metric_schedule_exp_builds_jax_schedule(workdir, monkeypatch, capsys):  # noqa: F811
    monkeypatch.setenv("PDM_CONFIG", str(tiny_mnist_config(workdir)))
    port_lenet()
    cfg = load_config()
    trainer = DDPMTrainer(ddpm=ddpm_from_config(cfg, device="cpu"), warmup_steps=0,
                          checkpoint_dir=cfg.checkpoint_dir, checkpoint_every=1,
                          eval_steps=10 ** 9)
    trainer.train(get_data_tensor(cfg, device="cpu"), batch_size=4, total_iters=1)
    capsys.readouterr()
    n, d = get_data_tensor(cfg, device="cpu").flatten(1).shape
    got = metric_schedule_exp.main(["--n_steps", "2", "--n_samples", "64", *CPU],
                                   metric_draws=jax_draws(jax.random.PRNGKey(1), n, d,
                                                          512, 512))
    out = capsys.readouterr().out
    assert got["metric_stats_path"] == "stats/mnist_metric.npz"
    stats = np.load(got["metric_stats_path"])
    assert set(stats.files) == {"temp", "metric", "log_temp", "dataset_tr_sigma0"}
    assert stats["temp"].shape == (100,)
    # the npz is JAX's metric_stats on JAX's draws (PRNGKey(1), 512 samples
    # in one batch, regularize=True) over JAX's 100 temperatures of the
    # dataset's range: test_torch_stats' tolerances (1e-5 of scale, 1e-4
    # for the metric, a variance whose e2 - e1^2 cancels)
    from _common import temp_grid as j_temp_grid
    from pdm_tpu.utils.data import get_data_tensor as j_get_data_tensor

    jdata = j_get_data_tensor(jax_config(dataset_name="mnist"))
    np.testing.assert_array_equal(np.asarray(jdata), get_data_tensor(cfg, device="cpu").numpy())
    want = j_metric_stats(
        jax.random.PRNGKey(1), jdata,
        j_temp_grid(*jax_config(dataset_name="mnist").dataset_config.temp_range, 100),
        n_samples=512, batch_size=512, regularize=True)
    np.testing.assert_allclose(stats["temp"], want["temp"], rtol=1e-12)
    np.testing.assert_allclose(stats["log_temp"], want["log_temp"], rtol=1e-12)
    _close(stats["metric"], want["metric"], rtol=1e-4)
    _close(stats["dataset_tr_sigma0"], want["dataset_tr_sigma0"])
    jsched = j_metric_scheduler_from_npz(got["metric_stats_path"])
    tau = jnp.linspace(0.0, 1.0, 9)
    assert np.isfinite(np.asarray(jsched.log_temp_from_tau(tau))).all()
    assert list(got["fid"]) == ["linear_beta", "cosine", "metric"]
    for name, fid in got["fid"].items():
        assert np.isfinite(fid) and f"{name}: FID@2 steps = {fid:.3f}" in out


# ---------------------------------------------------------------------------
# items 2-4: the endurance chain
# ---------------------------------------------------------------------------


class Crashed(Exception):
    pass


def _exit_raises(code):
    raise Crashed(code)


@pytest.fixture(scope="module")
def endurance(tmp_path_factory):
    """An uninterrupted run in ``whole``; in ``drill`` a run killed right
    after step CRASH_AT, then a relaunch. Returns both dirs and results."""
    root = tmp_path_factory.mktemp("endurance")
    cwd = os.getcwd()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "_exit", _exit_raises)
        try:
            for name in ("whole", "drill"):
                (root / name).mkdir()
                os.chdir(root / name)
                if name == "drill":
                    with pytest.raises(Crashed, match=str(longrun_endurance.CRASH_CODE)):
                        longrun_endurance.main([*ENDURANCE, "--crash_at", str(CRASH_AT)],
                                               unet_config=TINY)
                    out["latest_after_crash"] = open(
                        "checkpoints/endurance/latest.txt").read().strip()
                out[name] = longrun_endurance.main(ENDURANCE, unet_config=TINY)
        finally:
            os.chdir(cwd)
    out["root"] = root
    return out


def test_crash_drill_resumes_bitwise(endurance):
    whole, drill = endurance["whole"], endurance["drill"]
    assert endurance["latest_after_crash"] == "2"
    assert whole["resumed_from"] is None and drill["resumed_from"] == 2
    for key in ("params", "ema_params"):
        a, b = getattr(whole["state"], key), getattr(drill["state"], key)
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(a[name], b[name]), (key, name)
    sa = whole["state"].optimizer.state_dict()["state"]
    sb = drill["state"].optimizer.state_dict()["state"]
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    with open(endurance["root"] / "drill" / "endurance_result.json") as f:
        res = json.load(f)
    assert set(res) == {"steps", "resumed_from", "train_seconds", "img_per_sec",
                        "final_fid", "fid_floor", "eval_history"}
    assert res["steps"] == 4 and res["resumed_from"] == 2
    assert [e["step"] for e in res["eval_history"]] == [4]
    assert res["final_fid"] == whole["final_fid"] and np.isfinite(res["fid_floor"])
    assert [e["step"] for e in whole["eval_history"]] == [2, 4]


def test_analyze_endurance_reads_the_port_run(endurance, monkeypatch, capsys):
    """JAX's scripts/analyze_endurance.py on the drill's CSV (rows of
    the crashed run, then the relaunch's) and result JSON; its figure
    title is built from the JSON."""
    import matplotlib.figure

    drill = endurance["root"] / "drill"
    titles = []
    monkeypatch.setattr(matplotlib.figure.Figure, "suptitle",
                        lambda self, t, **kw: titles.append(t))
    monkeypatch.chdir(drill)
    jax_script_main("analyze_endurance", ["--out", "curves.png"], monkeypatch)
    assert "wrote curves.png" in capsys.readouterr().out
    assert os.path.exists("curves.png")
    assert len(titles) == 1 and "resumed from 2" in titles[0]
    with open("logs/endurance.csv") as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    assert rows[0] == ["step", "metric", "value", "time"]
    logged = {(int(s), m) for s, m, _, _ in rows[1:]}
    assert {(CRASH_AT, "loss"), (2, "fid"), (4, "fid")} <= logged


def _md_rows(path):
    return open(path).read().splitlines()


def assert_table_schedules_are_jax(got, n):
    """The schedule table's data-driven schedules, run on JAX's draws
    (PRNGKey(1): 512 forward samples in one batch; PRNGKey(2): 256 metric
    samples, regularize=True), against JAX's forward_stats ->
    entropy_scheduler (extrapolate=True, min_temp=1e-4) and metric_stats
    -> metric_scheduler over the same 32 temperatures: the curves to
    test_torch_stats' tolerances (1e-5 of scale; 1e-4 for the metric),
    each schedule's log temperature at 33 tau within TAU_TOL of 1 + its
    largest |log T| (~11). When this was written the largest differences
    were 2.9e-6 (entropy) and 7.8e-6 (metric), a factor 14 below that
    bound: fp32 sweeps summed in two orders, then the knots'
    interpolation."""
    from longrun_endurance import make_rgb_blob_dataset as j_blobs

    data = jnp.asarray(j_blobs(n)[0])
    temps = np.logspace(-4, 4.5, 32)
    fstats = j_forward_stats(jax.random.PRNGKey(1), data, temps, n_samples=512,
                             batch_size=512)
    mstats = j_metric_stats(jax.random.PRNGKey(2), data, temps, n_samples=256,
                            batch_size=256, regularize=True)
    _close(got["forward_stats"]["entropy"], fstats["entropy"])
    _close(got["metric_stats"]["metric"], mstats["metric"], rtol=1e-4)
    jsched = {"entropy": j_entropy_scheduler(fstats["temp"], fstats["entropy"],
                                             extrapolate=True, min_temp=1e-4),
              "metric": j_metric_scheduler(mstats["log_temp"], mstats["metric"])}
    tau = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    for name, sched in jsched.items():
        want = np.asarray(sched.log_temp_from_tau(jnp.asarray(tau)))
        have = got["schedules"][name].log_temp_from_tau(torch.from_numpy(tau)).numpy()
        assert np.abs(have - want).max() <= TAU_TOL * (1 + np.abs(want).max()), name


def test_endurance_tables_on_the_checkpoint(endurance, monkeypatch):
    drill = endurance["root"] / "drill"
    monkeypatch.chdir(drill)
    n = 256
    common = ["--n_data", str(n), "--fid_samples", "4", "--steps", "2", "3", *CPU]
    got = endurance_schedule_table.main(
        common, unet_config=TINY,
        forward_draws=jax_draws(jax.random.PRNGKey(1), n, 3 * 32 * 32, 512, 512),
        metric_draws=jax_draws(jax.random.PRNGKey(2), n, 3 * 32 * 32, 256, 256))
    assert_table_schedules_are_jax(got, n)
    assert got["out"] == "endurance_schedule_table"
    with open("endurance_schedule_table.json") as f:
        table = json.load(f)
    assert set(table) == {"checkpoint_step", "fid_floor", "table"}
    assert table["checkpoint_step"] == 4
    names = ("linear_beta", "cosine", "entropy", "metric")
    assert list(table["table"]) == [f"{s}@{n}" for s in names for n in (2, 3)]
    lines = _md_rows("endurance_schedule_table.md")
    assert lines[0] == (f"# Endurance-checkpoint schedule-ordering FID (blob-32, step 4, "
                        f"ddpm steps, floor {table['fid_floor']:.3f})")
    assert lines[1:4] == ["", "| schedule | 2 | 3 |", "|---|---|---|"]
    assert lines[4:] == [f"| {s} | " + " | ".join(
        f"{table['table'][f'{s}@{n}']:.2f}" for n in (2, 3)) + " |" for s in names]
    assert all(np.isfinite(v) for v in table["table"].values())
    assert endurance_schedule_table.main(
        [*common, "--step_type", "ddim"], unet_config=TINY)["out"] == \
        "endurance_schedule_table_ddim"

    with pytest.warns(UserWarning, match="clamping"):
        got = endurance_solver_table.main(common, unet_config=TINY)
    with open("endurance_solver_table.json") as f:
        table = json.load(f)
    assert set(table) == {"checkpoint_step", "fid_floor", "schedule", "table"}
    assert table["schedule"] == "linear_beta"
    solvers = ("ddpm", "ddim", "heun", "dpmpp_2m")
    for s in solvers:
        for n in (2, 3):
            cell = table["table"][f"{s}@{n}"]
            assert cell["nfe"] == (2 * n - 1 if s == "heun" else n)
            assert np.isfinite(cell["fid"])
    lines = _md_rows("endurance_solver_table.md")
    assert lines[2:6] == ["FID (NFE) per solver and level count:", "",
                          "| solver | 2 | 3 |", "|---|---|---|"]
    assert lines[6 + 2] == "| heun | " + " | ".join(
        f"{table['table'][f'heun@{n}']['fid']:.2f} ({2 * n - 1})" for n in (2, 3)) + " |"


def test_optimize_schedule_flagship_on_the_checkpoint(endurance, monkeypatch):
    monkeypatch.chdir(endurance["root"] / "drill")
    got = optimize_schedule_flagship.main(
        ["--n_steps", "3", "--n_iters", "2", "--batch_size", "4", "--n_data", "256",
         "--fid_samples", "6", *CPU], unet_config=TINY)
    with open("optimized_flagship_schedule.json") as f:
        res = json.load(f)
    assert set(res) == {"checkpoint_step", "n_steps", "step_type",
                        "fid_linear_beta_init", "fid_optimized", "init_log_temp",
                        "optimized_log_temp", "mmd_history_first_last"}
    assert res["checkpoint_step"] == 4 and res["step_type"] == "ddpm"
    lt = np.asarray(res["optimized_log_temp"])
    assert lt.shape == (3,) and np.all(np.diff(lt) >= 0)
    assert np.log(1e-4) - 1e-4 <= lt[0] and lt[-1] <= np.log(2.478e4) + 1e-4
    assert len(got["history"]) == 2 and np.isfinite(got["history"]).all()
    assert np.isfinite(res["fid_linear_beta_init"]) and np.isfinite(res["fid_optimized"])


def test_endurance_scripts_need_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no checkpoint under nowhere"):
        endurance_solver_table.main(["--ckpt_dir", "nowhere", "--n_data", "256", *CPU],
                                    unet_config=TINY)
