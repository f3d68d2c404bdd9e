"""Multi-rank workers of the port's CPU tests (torch.distributed, gloo).

:func:`launch` runs one suite on ``world`` ranks, each in a fresh
interpreter (no fork) with one thread, joined through a rendezvous file
under the test's temporary directory; every process group and every join
has a timeout, so a hang fails one test instead of the run. One launch
runs at a time across the test processes (a lock file in the system's
temporary directory, waited on for at most ``LOCK_WAIT_S``), so that the
ranks of several launches under xdist do not crowd the machine's cores
at once. A suite reads
its inputs from ``inputs.npz`` in that directory, written by the test from
seeded numpy (and the JAX package's draws where a test needs them), and
each rank writes its outputs to ``out{rank}.npz``. This module imports
torch, numpy and the port, never JAX.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GROUP_TIMEOUT_S = 90  # each collective
JOIN_TIMEOUT_S = 240  # a whole suite
LOCK_WAIT_S = 120  # for the other launches; then this one runs anyway

_CHILD = ("import sys; sys.path[:0] = [{repo!r}, {tests!r}]; "
          "import torch_dist_workers as w; "
          "w.child({suite!r}, int(sys.argv[1]), {world}, {tmp!r})")


@contextlib.contextmanager
def _one_launch_at_a_time():
    path = os.path.join(tempfile.gettempdir(), "pdm_tpu_torch_ranks.lock")
    with open(path, "a") as f:
        deadline = time.monotonic() + LOCK_WAIT_S
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                held = True
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    held = False
                    break
                time.sleep(0.2)
        try:
            yield
        finally:
            if held:
                fcntl.flock(f, fcntl.LOCK_UN)


def launch(suite: str, world: int, tmp: str, env: Dict[str, str] = None,
           cwd: Callable[[int], str] = None) -> List[Dict[str, np.ndarray]]:
    """Run ``suite`` on ``world`` ranks; each rank's outputs. A rank that
    fails or outlives ``JOIN_TIMEOUT_S`` fails the call (all are killed)."""
    with _one_launch_at_a_time():
        return _launch(suite, world, tmp, env, cwd)


def _launch(suite, world, tmp, env, cwd):
    code = _CHILD.format(repo=REPO, tests=TESTS, suite=suite, world=world,
                         tmp=str(tmp))
    base = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        extra = {k: v.format(rank=r) for k, v in (env or {}).items()}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env={**base, **extra},
            cwd=None if cwd is None else cwd(r)))
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} of {suite} exited {p.returncode}:\n{out[-1500:]}\n"
              f"{err[-3000:]}"
              for r, (p, (out, err)) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    if failed:
        raise AssertionError("\n".join(failed))
    return [dict(np.load(os.path.join(tmp, f"out{r}.npz")))
            for r in range(world)]


def child(suite: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from pdm_tpu_torch.parallel import initialize_multihost

    if suite.startswith("env_"):  # torchrun's environment gives everything
        initialize_multihost(timeout_s=GROUP_TIMEOUT_S, device="cpu")
    else:
        initialize_multihost(f"file://{tmp}/rendezvous", world, rank,
                             timeout_s=GROUP_TIMEOUT_S, device="cpu")
    try:
        inputs = {}
        path = os.path.join(tmp, "inputs.npz")
        if os.path.exists(path):
            inputs = dict(np.load(path))
        out = SUITES[suite](rank, world, inputs, tmp)
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _moments_out(prefix: str, mom) -> Dict[str, np.ndarray]:
    out = {f"{prefix}.{f}": getattr(mom, f).numpy()
           for f in ("log_z", "shift", "e1_hat", "e2_hat")}
    if mom.mean is not None:
        out[f"{prefix}.mean"] = mom.mean.numpy()
    return out


# ---------------------------------------------------------------------
# statistics: the shard bodies, thermo_sweep, FID, the sampler
# ---------------------------------------------------------------------


def stats_suite(rank, world, inp, tmp):
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.ops.boltzmann import boltzmann_moments_shard_body
    from pdm_tpu_torch.ops.boltzmann_sweep import boltzmann_sweep_shard_body
    from pdm_tpu_torch.parallel import make_mesh, sharded_sampler
    from pdm_tpu_torch.schedulers.analytic import LogSNRScheduler
    from pdm_tpu_torch.stats.sweep import thermo_sweep
    from pdm_tpu_torch.utils.fid import feature_statistics, get_compute_fid

    mesh = make_mesh(data=world)
    out = {}
    x, it, ys = _t(inp["m.x"]), _t(inp["m.inv_temp"]), _t(inp["m.y_scale"])
    for case in ("even", "uneven", "one_point", "tiny"):
        y, v = inp[f"m.{case}.y"], inp[f"m.{case}.values"]
        bounds = inp[f"m.{case}.bounds"]
        lo, hi = int(bounds[rank]), int(bounds[rank + 1])
        mom = boltzmann_moments_shard_body(
            x, _t(y[lo:hi]), it, ys, mesh=mesh, values=_t(v[lo:hi]))
        out.update(_moments_out(f"m.{case}", mom))
        if case == "uneven":  # the same call again: bitwise the same
            mom = boltzmann_moments_shard_body(
                x, _t(y[lo:hi]), it, ys, mesh=mesh, values=_t(v[lo:hi]))
            out.update(_moments_out("m.uneven_again", mom))
        if case == "even":
            mom = boltzmann_moments_shard_body(
                x, _t(y[lo:hi]), it, ys, mesh=mesh, compute_mean=True)
            out.update(_moments_out("m.even_mean", mom))
    y = inp["s.y"]
    n = y.shape[0] // world
    mom = boltzmann_sweep_shard_body(
        _t(inp["s.x0"]), _t(inp["s.eps"]), _t(y[rank * n:(rank + 1) * n]),
        _t(inp["s.temps"]), mesh=mesh,
        values=_t(inp["s.values"][rank * n:(rank + 1) * n]))
    out.update(_moments_out("s", mom))

    for case in ("even", "uneven"):
        data = inp[f"t.{case}.data"]
        draws = [(_t(inp[f"t.{case}.idx"]), _t(inp[f"t.{case}.eps"]))]
        for knn in (False, True):
            res = thermo_sweep(data, inp["t.temp"], 64, 64, draws=draws,
                               regularize=knn, adaptive_knn=knn, knn_k=3,
                               mesh=mesh, device="cpu")
            for k in ("entropy", "metric", "free_energy", "heat_capacity"):
                out[f"t.{case}.{knn}.{k}"] = res[k]
        gen = torch.Generator().manual_seed(0)
        res = thermo_sweep(data, inp["t.temp"], 48, 16, generator=gen,
                           mesh=mesh, device="cpu")
        out[f"t.{case}.gen.entropy"] = res["entropy"]

    mu, sigma = feature_statistics(inp["f.data"], lambda a: a.float(), 16,
                                   batch_size=130, device="cpu", mesh=mesh)
    out["f.mu"], out["f.sigma"] = mu.numpy(), sigma.numpy()
    out["f.fid"] = np.asarray(get_compute_fid(
        inp["f.ref"], lambda a: a.float(), 8, device="cpu", mesh=mesh)(
        inp["f.x"]))

    sched = LogSNRScheduler(1e-4, 1e1)
    ddpm = TrueDDPM(scheduler=sched, train_data=_t(inp["g.data"]),
                    device="cpu")
    for step_type in ("ddim", "ddpm"):
        sampler = DDPMSampler(ddpm=ddpm, scheduler=sched, n_steps=8,
                              obj_size=(1, 1, 1), batch_size=64,
                              n_samples=64, step_type=step_type, device="cpu")
        sh = sharded_sampler(sampler, mesh)
        res = sh.batch_sample(torch.Generator().manual_seed(0))
        out[f"g.{step_type}.gen"] = res["x"].numpy()
        kw = {"x_init": _t(inp["g.x_init"])}
        if step_type == "ddpm":
            kw["noise"] = _t(inp["g.noise"])
        out[f"g.{step_type}.explicit"] = sh.batch_sample(**kw)["x"].numpy()
    sampler = DDPMSampler(ddpm=ddpm, scheduler=sched, n_steps=4,
                          obj_size=(1, 1, 1), batch_size=8, n_samples=12,
                          step_type="ddim", track_states=True, device="cpu")
    res = sharded_sampler(sampler, mesh).sample(torch.Generator().manual_seed(1))
    out["g.states"], out["g.sample"] = res["states"], res["x"]
    out["stats.all-reduce"] = np.asarray(mesh.stats["all-reduce"])
    out["stats.all-gather"] = np.asarray(mesh.stats["all-gather"])
    return out


# ---------------------------------------------------------------------
# training
# ---------------------------------------------------------------------

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


def tiny_trainer(dropout: float = 0.0, **kw):
    """The tiny UNet's trainer on the CPU (the port's trainer tests')."""
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.models.unet_ddpm import init_unet_ddpm
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    net = unet_from_config(3, {**TINY, "dropout": dropout}, device="cpu")
    ddpm = init_unet_ddpm(torch.Generator().manual_seed(0),
                          LinearBetaScheduler(1e-4, 1e2), net,
                          (3, 16, 16))
    return DDPMTrainer(ddpm, **{**OPT, **kw})


def loop_data(n: int = 32, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        (n, 3, 16, 16)).astype(np.float32))


# (fsdp, grad_accum, dropout, horizontal_flip) of the loops run on ranks
LOOPS = {"dp": (False, 1, 0.1, True), "dp_accum": (False, 2, 0.1, False),
         "fsdp": (True, 1, 0.1, True), "fsdp_accum": (True, 2, 0.0, False)}


def run_loop(name: str, mesh=None, total: int = 3, checkpoint_dir=None,
             checkpoint_every=None, batch_size: int = 8, **kw):
    """Losses logged per step and the final whole state of a LOOPS run,
    from N(0, 0.1^2) weights (with weight decay on, no gradient is zero)."""
    from pdm_tpu_torch.diffusion.trainer import whole_tensors

    fsdp, accum, drop, flip = LOOPS[name]
    logged = {}
    tr = tiny_trainer(drop, fsdp=fsdp, grad_accum=accum, horizontal_flip=flip,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every,
                      log_fn=lambda it, m: logged.__setitem__(it, m["loss"]),
                      **kw)
    rng = np.random.RandomState(0)
    params = {n: torch.from_numpy((rng.standard_normal(tuple(p.shape)) * 0.1)
                                  .astype(np.float32))
              for n, p in tr.ddpm.module.named_parameters()}
    state = tr.train(loop_data(), batch_size=batch_size, total_iters=total,
                     seed=3, log_every=1, params=params, mesh=mesh)
    return tr, state, logged, whole_tensors(state, state.params), whole_tensors(
        state, state.ema_params)


def steps_suite(rank, world, inp, tmp):
    from pdm_tpu_torch.diffusion.trainer import _gather, _gather_optimizer
    from pdm_tpu_torch.parallel import make_mesh
    from pdm_tpu_torch.parallel.mesh import batch_sharding

    mesh = make_mesh(data=world)
    out = {}
    # three steps on JAX's parameters and noise (tau, eps given)
    names = [str(n) for n in inp["j.names"]]
    params = {n: _t(inp[f"j.p.{n}"]) for n in names}
    rows = batch_sharding(mesh).rows(inp["j.x0"].shape[0])
    for fsdp in (False, True):
        tr = tiny_trainer(fsdp=fsdp)
        state = tr.init_state(params, mesh)
        for i in range(3):
            state, m = tr.train_step(
                state, _t(inp["j.x0"][rows]), tau=_t(inp[f"j.tau{i}"][rows]),
                eps=_t(inp[f"j.eps{i}"][rows]))
            out[f"j.{fsdp}.loss{i}"] = m["loss"].numpy()
            out[f"j.{fsdp}.grad_norm{i}"] = m["grad_norm"].numpy()
        for n, t in _gather(state, state.params).items():
            out[f"j.{fsdp}.p.{n}"] = t.numpy()
        for n, t in _gather(state, state.ema_params).items():
            out[f"j.{fsdp}.e.{n}"] = t.numpy()
        # the bytes each rank holds against one process's
        held = sum(t.numel() for t in state.params.values())
        moments = sum(s[k].numel() for s in state.optimizer.state.values()
                      for k in ("exp_avg", "exp_avg_sq"))
        whole = sum(t.numel() for t in params.values())
        out[f"j.{fsdp}.held"] = np.asarray(
            [held, sum(t.numel() for t in state.ema_params.values()),
             moments, whole])
        out[f"j.{fsdp}.whole_leaves"] = np.asarray(sum(
            t.numel() for n, t in state.params.items()
            if state.shard_specs is None or "data" not in state.shard_specs[n]))
        opt = _gather_optimizer(state)["state"]
        out[f"j.{fsdp}.exp_avg_sq"] = np.concatenate(
            [opt[i]["exp_avg_sq"].reshape(-1).numpy() for i in sorted(opt)])
    # one data-parallel step's byte bill
    for fsdp in (False, True):
        tr = tiny_trainer(fsdp=fsdp)
        state = tr.init_state(params, mesh)
        mesh.stats.reset()
        tr.train_step(state, _t(inp["j.x0"][rows]),
                      tau=_t(inp["j.tau0"][rows]), eps=_t(inp["j.eps0"][rows]))
        for kind in ("all-reduce", "all-gather"):
            out[f"bill.{fsdp}.{kind}"] = np.asarray(
                [mesh.stats[kind], mesh.stats.counts(kind)])
    return out


def loops_suite(rank, world, inp, tmp):
    from pdm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=world)
    out = {}
    # the loops, twice each (bitwise), and checkpoints across layouts
    for name in LOOPS:
        for rep in range(2):
            _, _, logged, p, e = run_loop(name, mesh)
            out[f"l.{name}.{rep}.loss"] = np.asarray(
                [logged[k] for k in sorted(logged)])
            out[f"l.{name}.{rep}.p"] = np.concatenate(
                [t.reshape(-1).numpy() for t in p.values()])
            out[f"l.{name}.{rep}.e"] = np.concatenate(
                [t.reshape(-1).numpy() for t in e.values()])
    for name in ("dp", "fsdp"):
        # saved under the mesh at step 2: the test resumes it alone
        run_loop(name, mesh, total=2, checkpoint_every=2,
                 checkpoint_dir=os.path.join(tmp, f"mesh_{name}"))
        # saved by one process at step 2: resumed here to step 4
        _, _, logged, p, _ = run_loop(
            name, mesh, total=4, checkpoint_every=100,
            checkpoint_dir=os.path.join(tmp, f"one_{name}"))
        out[f"c.{name}.loss"] = np.asarray([logged[k] for k in sorted(logged)])
        out[f"c.{name}.p"] = np.concatenate(
            [t.reshape(-1).numpy() for t in p.values()])
    return out


# ---------------------------------------------------------------------
# a mesh smaller than the world, and the eval hook on every rank
# ---------------------------------------------------------------------


def eval_config():
    """The eval hook's config of the tests: MNIST's LeNet FID over 48
    samples (the LeNet at ``checkpoints/lenet_mnist.npz`` under the
    working directory)."""
    from pdm_tpu_torch.config.loader import load_config

    cfg = load_config()
    cfg.dataset_name = "mnist"
    cfg.ddpm.noise_schedule_type = "linear_beta"
    cfg.fid.samples = 48
    return cfg


def eval_model(data):
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    cfg = eval_config()
    return TrueDDPM(scheduler=LinearBetaScheduler(*cfg.diffusion.temp_range),
                    train_data=_t(data), device="cpu")


def submesh_suite(rank, world, inp, tmp):
    """The automatic data axis over the ranks, shrunk to divide a batch
    of 6: a mesh of 3 of the 4 ranks. Every rank builds it (its groups
    need all of them); the rank left out runs everything alone. Then a
    train loop at batch 6 and the eval hook (``make_eval_fn(mesh=)``),
    each rank in its own working directory."""
    import warnings

    from pdm_tpu_torch.config.config import ParallelConfig
    from pdm_tpu_torch.parallel import make_mesh
    from pdm_tpu_torch.parallel.mesh import mesh_from_config
    from pdm_tpu_torch.utils.logging import make_eval_fn

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = mesh_from_config(ParallelConfig(), batch_size=6)
    out = {"mesh": np.asarray([mesh.shape["data"], mesh.data_size,
                               mesh.data_index]),
           "warned": np.asarray(any("using data=3" in str(w.message)
                                    for w in caught))}
    _, _, logged, p, e = run_loop("dp", mesh, batch_size=6)
    out["loss"] = np.asarray([logged[k] for k in sorted(logged)])
    out["p"] = np.concatenate([t.reshape(-1).numpy() for t in p.values()])
    out["e"] = np.concatenate([t.reshape(-1).numpy() for t in e.values()])
    mesh.stats.reset()
    eval_fn = make_eval_fn(eval_config(), _t(inp["data"]), sample_dir="ev",
                           device="cpu", mesh=mesh)
    out["fid"] = np.asarray(eval_fn(eval_model(inp["data"]), 3)
                            ["fid_100_steps"])
    out["eval.all-gather"] = np.asarray(mesh.stats.counts("all-gather"))
    # a mesh of the whole world made after it: its group has the same
    # name on every rank only if every rank made the first mesh's groups
    whole = make_mesh(data=world)
    out["whole"] = whole.all_reduce(torch.full((2,), float(rank + 1))).numpy()
    return out


# ---------------------------------------------------------------------
# the entry points under torchrun's environment
# ---------------------------------------------------------------------


def env_multihost_suite(rank, world, inp, tmp):
    import torch.distributed as dist

    t = torch.full((3,), float(rank + 1))
    dist.all_reduce(t)
    return {"world": np.asarray(dist.get_world_size()),
            "rank": np.asarray(dist.get_rank()),
            "backend": np.asarray(dist.get_backend()), "sum": t.numpy()}


def env_stats_cli_suite(rank, world, inp, tmp):
    from pdm_tpu_torch.scripts import compute_stats_forward

    compute_stats_forward.main(argv=[
        "--dataset_name", "gmm1d", "--forward_stats.n_samples", "64",
        "--forward_stats.batch_size", "32", "--forward_stats.n_temps", "8",
        "--device", "cpu"])
    return {}


# ---------------------------------------------------------------------
# the model axis: tensor and spatial parallelism
# ---------------------------------------------------------------------


def mp_net(cfg: Dict, names, inp, prefix: str):
    """The tiny UNet of ``cfg`` on the CPU with the test's parameters."""
    from pdm_tpu_torch.models.unet import unet_from_config

    net = unet_from_config(3, cfg, device="cpu")
    net.load_state_dict({n: _t(inp[f"{prefix}.p.{n}"]) for n in names})
    return net


def mp_forward_suite(rank, world, inp, tmp):
    """Each case's TP and SP forward on its mesh: this rank's output (TP:
    its rows of the batch, whole images; SP: its rows of them) and the
    model axis's byte bill."""
    import json

    from pdm_tpu_torch.parallel import make_mesh, unet_with_sp, unet_with_tp

    out = {}
    for case in json.loads(str(inp["cases"])):
        cid, cfg = case["id"], case["cfg"]
        data, model = case["mesh"]
        mesh = make_mesh(data=data, model=model)
        net = mp_net(cfg, [str(n) for n in inp[f"{cid}.names"]], inp, cid)
        x, tau = inp[f"{cid}.x"], inp[f"{cid}.tau"]
        rows = slice(mesh.data_index * len(x) // data,
                     (mesh.data_index + 1) * len(x) // data)
        h = x.shape[2] // model
        mine = slice(mesh.model_index * h, (mesh.model_index + 1) * h)
        for part, make in (("channel", unet_with_tp), ("spatial", unet_with_sp)):
            mesh.model_stats.reset()
            xs = _t(x[rows])
            if part == "spatial":
                xs = xs[:, :, mine].contiguous()
            with torch.no_grad():
                y = make(net, mesh)(xs, _t(tau[rows]))
            out[f"{cid}.{part}"] = y.numpy()
            for kind in ("all-gather", "all-reduce", "collective-permute"):
                out[f"{cid}.{part}.bill.{kind}"] = np.asarray(mesh.model_stats[kind])
    return out


def mp_trainer(partition, fsdp=False, dropout=0.0, **kw):
    return tiny_trainer(dropout, fsdp=fsdp, model_partition=partition, **kw)


def record_grads(tr):
    """Wrap ``tr._grads``: each step's fp32 gradients as the step applied
    them (this rank's part), appended to the returned list."""
    seen = []
    grads_of = tr._grads

    def record(*args):
        loss, grads = grads_of(*args)
        seen.append([g.clone() for g in grads])
        return loss, grads

    tr._grads = record
    return seen


def whole_grads(tr, grads):
    """The whole model's gradients from this rank's (model shards
    gathered), by name."""
    from chip_smoke import _whole_grads

    module = tr.ddpm.module
    named = dict(zip([n for n, _ in module.named_parameters()], grads))
    return _whole_grads(named, module, module.mesh)


def mp_train_suite(rank, world, inp, tmp):
    """On a 2 x 2 mesh: three train steps on JAX's parameters and noise
    for each partition with and without FSDP (losses, norms, whole params
    and EMA, each step's whole gradients, the whole leaves this rank
    holds); one step's byte bill of each partition; the train loops with
    dropout and flips and their checkpoints across layouts."""
    from pdm_tpu_torch.diffusion.trainer import whole_tensors
    from pdm_tpu_torch.parallel import make_mesh
    from pdm_tpu_torch.parallel.mesh import batch_sharding

    mesh = make_mesh(data=2, model=2)
    out = {}
    names = [str(n) for n in inp["j.names"]]
    params = {n: _t(inp[f"j.p.{n}"]) for n in names}
    rows = batch_sharding(mesh).rows(inp["j.x0"].shape[0])
    for part in ("channel", "spatial"):
        for fsdp in (False, True):
            tr = mp_trainer(part, fsdp)
            state = tr.init_state(params, mesh)
            seen = record_grads(tr)
            key = f"{part}.{fsdp}"
            for i in range(3):
                state, m = tr.train_step(
                    state, _t(inp["j.x0"][rows]), tau=_t(inp[f"j.tau{i}"][rows]),
                    eps=_t(inp[f"j.eps{i}"][rows]))
                out[f"{key}.loss{i}"] = m["loss"].numpy()
                out[f"{key}.grad_norm{i}"] = m["grad_norm"].numpy()
                for n, g in whole_grads(tr, seen[i]).items():
                    out[f"{key}.g{i}.{n}"] = g.numpy()
            for n, t in whole_tensors(state, state.params).items():
                out[f"{key}.p.{n}"] = t.numpy()
            for n, t in whole_tensors(state, state.ema_params).items():
                out[f"{key}.e.{n}"] = t.numpy()
            # the whole leaves as this rank holds them (FSDP cuts none of
            # them over 'model')
            local = dict(state.params) if not fsdp else {}
            for n, t in local.items():
                if "model" not in state.shard_specs[n]:
                    out[f"{key}.whole.{n}"] = t.numpy()
            held = sum(t.numel() for t in state.params.values())
            out[f"{key}.held"] = np.asarray(held)
    # one step's byte bill over the model axis
    for part in ("channel", "spatial"):
        tr = mp_trainer(part)
        state = tr.init_state(params, mesh)
        mesh.model_stats.reset()
        tr.train_step(state, _t(inp["j.x0"][rows]), tau=_t(inp["j.tau0"][rows]),
                      eps=_t(inp["j.eps0"][rows]))
        for kind in ("all-gather", "all-reduce", "collective-permute"):
            out[f"bill.{part}.{kind}"] = np.asarray(mesh.model_stats[kind])
    # the loops with dropout and flips, and checkpoints across layouts
    for part in ("channel", "spatial"):
        _, _, logged, p, e = run_loop("dp", mesh, model_partition=part)
        out[f"l.{part}.loss"] = np.asarray([logged[k] for k in sorted(logged)])
        out[f"l.{part}.p"] = np.concatenate([t.reshape(-1).numpy() for t in p.values()])
        out[f"l.{part}.e"] = np.concatenate([t.reshape(-1).numpy() for t in e.values()])
        # saved under the mesh at step 2: the test resumes it alone
        run_loop("dp", mesh, total=2, checkpoint_every=2, model_partition=part,
                 checkpoint_dir=os.path.join(tmp, f"mesh_{part}"))
        # saved by one process at step 2: resumed here to step 4
        _, _, logged, p, _ = run_loop(
            "dp", mesh, total=4, checkpoint_every=100, model_partition=part,
            checkpoint_dir=os.path.join(tmp, f"one_{part}"))
        out[f"c.{part}.loss"] = np.asarray([logged[k] for k in sorted(logged)])
        out[f"c.{part}.p"] = np.concatenate([t.reshape(-1).numpy() for t in p.values()])
    return out


def mp_sampler_suite(rank, world, inp, tmp):
    """sharded_sampler(partition="spatial") on a 2 x 2 mesh, from JAX's
    draws (x_T and each step's noise), DDPM and DDIM with the states."""
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.parallel import make_mesh, sharded_sampler
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    import json

    mesh = make_mesh(data=2, model=2)
    cfg = json.loads(str(inp["cfg"]))
    net = mp_net(cfg, [str(n) for n in inp["s.names"]], inp, "s")
    ddpm = UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net, device="cpu")
    out = {}
    x_init, noise = _t(inp["x_init"]), _t(inp["noise"])
    for step_type in ("ddpm", "ddim"):
        sampler = DDPMSampler(ddpm=ddpm, scheduler=ddpm.scheduler,
                              n_steps=noise.shape[0], obj_size=tuple(x_init.shape[1:]),
                              batch_size=x_init.shape[0], n_samples=x_init.shape[0],
                              step_type=step_type, track_states=True, device="cpu")
        sh = sharded_sampler(sampler, mesh, partition="spatial")
        res = sh.batch_sample(x_init=x_init, noise=noise)
        out[f"{step_type}.x"], out[f"{step_type}.states"] = (
            res["x"].numpy(), res["states"].numpy())
    # drawn from a generator: the same samples as one process's
    sampler = DDPMSampler(ddpm=ddpm, scheduler=ddpm.scheduler, n_steps=3,
                          obj_size=tuple(x_init.shape[1:]), batch_size=4,
                          n_samples=4, step_type="ddpm", device="cpu")
    out["gen"] = sharded_sampler(sampler, mesh, partition="spatial").batch_sample(
        torch.Generator().manual_seed(5))["x"].numpy()
    return out


def mp_uneven_suite(rank, world, inp, tmp):
    """On a 1 x 4 mesh: images of 18 rows, which 4 does not divide (every
    level of the tiny UNet whole on every rank): sharded_sampler(partition=
    "spatial") DDPM and DDIM from JAX's draws with the states, and three
    spatial train steps on JAX's parameters and noise; then images of 16
    rows, which split, through a DDIM step of the spatial sampler. The
    model axis's halo bytes of each."""
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.diffusion.trainer import whole_tensors
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.parallel import make_mesh, sharded_sampler
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    mesh = make_mesh(data=1, model=world)
    names = [str(n) for n in inp["u.names"]]
    net = mp_net(TINY, names, inp, "u")
    ddpm = UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net, device="cpu")
    out = {}

    def sample(x_init, noise, step_type, states):
        mesh.model_stats.reset()
        sampler = DDPMSampler(ddpm=ddpm, scheduler=ddpm.scheduler,
                              n_steps=noise.shape[0], obj_size=tuple(x_init.shape[1:]),
                              batch_size=x_init.shape[0], n_samples=x_init.shape[0],
                              step_type=step_type, track_states=states, device="cpu")
        res = sharded_sampler(sampler, mesh, partition="spatial").batch_sample(
            x_init=x_init, noise=noise)
        return res, np.asarray(mesh.model_stats["collective-permute"])

    for step_type in ("ddpm", "ddim"):
        res, halo = sample(_t(inp["x_init"]), _t(inp["noise"]), step_type, True)
        out[f"{step_type}.x"], out[f"{step_type}.states"] = (
            res["x"].numpy(), res["states"].numpy())
        out[f"{step_type}.halo"] = halo
    tr = mp_trainer("spatial")
    state = tr.init_state({n: _t(inp[f"u.p.{n}"]) for n in names}, mesh)
    seen = record_grads(tr)
    mesh.model_stats.reset()
    for i in range(3):
        state, m = tr.train_step(state, _t(inp["x0"]), tau=_t(inp[f"tau{i}"]),
                                 eps=_t(inp[f"eps{i}"]))
        out[f"loss{i}"], out[f"grad_norm{i}"] = m["loss"].numpy(), m["grad_norm"].numpy()
        for n, g in whole_grads(tr, seen[i]).items():
            out[f"g{i}.{n}"] = g.numpy()
    out["train.halo"] = np.asarray(mesh.model_stats["collective-permute"])
    for n, t in whole_tensors(state, state.params).items():
        out[f"p.{n}"] = t.numpy()
    res, out["even.halo"] = sample(_t(inp["even.x_init"]), _t(inp["even.noise"]),
                                   "ddim", False)
    out["even.x"] = res["x"].numpy()
    return out


TINY_CLI_UNET = ("{block_out_channels: [16, 32], down_block_types: [DownBlock2D, "
                 "AttnDownBlock2D], up_block_types: [AttnUpBlock2D, UpBlock2D], "
                 "layers_per_block: 1, attention_head_dim: 8, norm_groups: 4, "
                 "dropout: 0.0}")


def model_cli_argv(partition=None):
    """train_diffusion's and sample's flags of the model-axis CLI test: the
    tiny UNet on MNIST-shaped caches, 2 steps at batch 4, the eval hook
    (grid only: no LeNet) at step 2; with ``partition`` a model axis of 2."""
    argv = ["--dataset_name", "mnist", "--ddpm.unet_config", TINY_CLI_UNET,
            "--ddpm.precision", "f32", "--device", "cpu"]
    if partition:
        argv += ["--parallel.model_axis", "2", "--parallel.model_partition",
                 partition]
    return argv


def run_model_cli(partition=None):
    """train_diffusion (2 steps) then sample (DDIM-3, 4 samples) in the
    working directory; the dataset's fid_samples cut to 25 so the eval
    hook's grid is one DDIM-100 batch."""
    import dataclasses

    from pdm_tpu_torch.config import datasets as tdatasets
    from pdm_tpu_torch.scripts import sample, train_diffusion

    tdatasets._REGISTRY["mnist"] = dataclasses.replace(
        tdatasets._REGISTRY["mnist"], fid_samples=25)
    train_diffusion.main(argv=model_cli_argv(partition) + [
        "--ddpm_training.total_iters", "2", "--ddpm_training.batch_size", "4",
        "--ddpm_training.eval_steps", "2", "--ddpm_training.warmup_steps", "0"])
    sample.main(argv=model_cli_argv(partition and "spatial") + [
        "--sample.n_steps", "3", "--sample.n_samples", "4",
        "--sample.batch_size", "4"])


def env_model_cli_suite(rank, world, inp, tmp):
    """train_diffusion under a channel partition, then sample under a
    spatial one, on a 1 x 2 mesh from torchrun's environment."""
    run_model_cli("channel")
    return {}


SUITES = {"stats": stats_suite, "steps": steps_suite, "loops": loops_suite,
          "submesh": submesh_suite, "mp_forward": mp_forward_suite,
          "mp_train": mp_train_suite, "mp_sampler": mp_sampler_suite,
          "mp_uneven": mp_uneven_suite,
          "env_multihost": env_multihost_suite,
          "env_model_cli": env_model_cli_suite,
          "env_stats_cli": env_stats_cli_suite}
