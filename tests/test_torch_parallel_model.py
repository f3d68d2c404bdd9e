"""Port parity: the model axis (tensor and spatial parallelism of the UNet,
``pdm_tpu_torch/parallel/model_parallel.py``) on 2 and 4 gloo ranks on the
CPU, against the JAX package's one-device results.

The tiny UNet (``block_out_channels`` (16, 32), one resnet a level, an
attention level, 4 groups) with random JAX parameters carried over by
``from_flax_params``:

* the channel (TP) and spatial (SP) forward on 1 x 2, 2 x 2 and 1 x 4
  meshes, each rank's output (TP: its images; SP: its rows of them)
  against JAX's one-device forward to 2e-4 of the output's scale (fp32
  sums regrouped by rank), including a level whose height does not divide
  (3 rows on 2 ranks, 2 rows on 4: computed whole), heads that do not
  divide (one head on 2 ranks, with an even and an odd batch; 2 heads on
  4), groups that do not divide (2 on 4 ranks) and both downsample
  paddings;
* three ``train_step``s on a 2 x 2 mesh for both partitions, with and
  without FSDP, on JAX's parameters and noise: loss and grad_norm to 1e-5
  relative of JAX's one-device steps; params and EMA within 2e-6 of
  JAX's plus the Adam bound (``chip_smoke.adam_first_step_bound``, summed
  over the steps) of the mesh's gradients against one process's; the
  model group ends each step with bitwise identical whole leaves; FSDP
  steps as the steps without it;
* the train loop (dropout, flips) on 2 x 2 against one process, and
  checkpoints across layouts (saved under the mesh, resumed alone; and
  the other way round);
* ``sharded_sampler(partition="spatial")`` on 2 x 2 from JAX's draws
  (DDPM and DDIM, with the states) against JAX's sampler to 1e-4 of the
  scale, and from a generator against one process; its ``ValueError``
  for TrueDDPM;
* the byte bill of one TP and one SP step against formulas written here;
* rows 3s and 4s' plain versions (split over row pieces, the sums added)
  against JAX's GroupNorm and its VJP (interpret mode), 1e-5, and their
  kernels' launch plan;
* the spatial partition on 18 x 18 images over a 1 x 4 mesh (4 does not
  divide 18: every level whole on every rank): the sampler (DDPM, DDIM,
  the states) and three train steps against JAX's one device, and a
  16 x 16 image on the same mesh, which still splits.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.diffusion import sampling as js
from pdm_tpu.diffusion.trainer import DDPMTrainer as JTrainer
from pdm_tpu.models.unet import unet_from_config as j_unet_from_config
from pdm_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
from pdm_tpu.ops.groupnorm import fused_group_norm_act as j_fgn
from pdm_tpu.parallel.mesh import make_mesh as j_make_mesh
from pdm_tpu.parallel.mesh import params_sharding as j_params_sharding
from pdm_tpu.schedulers.analytic import LinearBetaScheduler as JLinear

from chip_smoke import adam_first_step_bound
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.ops import groupnorm as tg
from torch_dist_workers import (
    OPT, TINY, launch, mp_trainer, record_grads, run_loop,
)
from torch_port_fixtures import jax_sampler_draws, two_torch_threads  # noqa: F401

FWD_TOL = 2e-4  # of the output's scale
B = 8  # the train steps' global batch


def _jax_model(cfg, size, seed=0):
    jnet = j_unet_from_config(3, cfg)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, size, size, 3)), jnp.zeros((1,)))[
            "params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    return jnet, params


def _flat(params, prefix):
    flat = {k: v.numpy() for k, v in from_flax_params(params).items()}
    return {f"{prefix}.names": np.asarray(list(flat)),
            **{f"{prefix}.p.{k}": v for k, v in flat.items()}}


# (id, unet_config overrides, image size, batch, mesh (data, model))
FWD_CASES = {
    2: [("tp_heads", {"attention_head_dim": 8}, 16, 4, (1, 2)),
        ("one_head_pad1", {"attention_head_dim": 32, "downsample_padding": 1},
         16, 4, (1, 2)),
        ("odd_rows_b3", {"attention_head_dim": 32}, 6, 3, (1, 2))],
    4: [("mesh2x2", {"attention_head_dim": 8}, 16, 4, (2, 2)),
        ("m4_groups2", {"norm_groups": 2}, 8, 4, (1, 4)),
        ("m4_two_rows", {}, 4, 4, (1, 4))],
}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def forward(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"mpfwd{world}")
    inp, want, cases = {}, {}, []
    for cid, over, size, batch, mesh in FWD_CASES[world]:
        cfg = {**TINY, **over}
        jnet, params = _jax_model(cfg, size)
        rng = np.random.RandomState(size + batch)
        x = rng.standard_normal((batch, 3, size, size)).astype(np.float32)
        tau = np.linspace(0.1, 0.9, batch).astype(np.float32)
        y = jnet.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                       jnp.asarray(tau))
        want[cid] = (np.asarray(y).transpose(0, 3, 1, 2), mesh)
        inp.update(_flat(params, cid))
        inp[f"{cid}.x"], inp[f"{cid}.tau"] = x, tau
        cases.append({"id": cid, "cfg": cfg, "mesh": list(mesh)})
    inp["cases"] = np.asarray(json.dumps(cases))
    np.savez(tmp / "inputs.npz", **inp)
    return world, want, launch("mp_forward", world, str(tmp))


def _rank_part(y, mesh, rank, spatial):
    data, model = mesh
    d, m = divmod(rank, model)
    b = len(y) // data
    y = y[d * b:(d + 1) * b]
    if spatial:
        h = y.shape[2] // model
        y = y[:, :, m * h:(m + 1) * h]
    return y


@pytest.mark.parametrize("partition", ["channel", "spatial"])
def test_forward_matches_jax(forward, partition):
    world, want, outs = forward
    for cid, (y, mesh) in want.items():
        scale = float(np.abs(y).max())
        for rank in range(mesh[0] * mesh[1]):
            got = outs[rank][f"{cid}.{partition}"]
            ref = _rank_part(y, mesh, rank, partition == "spatial")
            assert got.shape == ref.shape, (cid, rank)
            np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_TOL * scale,
                                       err_msg=f"{cid} rank {rank}")


def test_forward_collectives_by_partition(forward):
    """TP gathers channels and nothing else in a forward; SP exchanges
    halos, all-reduces the GroupNorm sums and gathers rows for attention."""
    world, want, outs = forward
    for cid in want:
        for out in outs:
            assert out[f"{cid}.channel.bill.all-gather"] > 0
            assert out[f"{cid}.channel.bill.all-reduce"] == 0
            assert out[f"{cid}.channel.bill.collective-permute"] == 0
            assert out[f"{cid}.spatial.bill.collective-permute"] > 0
            assert out[f"{cid}.spatial.bill.all-reduce"] > 0
            assert out[f"{cid}.spatial.bill.all-gather"] > 0


# ---------------------------------------------------------------------
# training on 2 x 2
# ---------------------------------------------------------------------


def _jax_noise(jddpm, key, x0):
    key_noise, _ = jax.random.split(key)
    tau, eps, _ = jddpm.scheduler.add_noise(
        key_noise, jnp.transpose(jnp.asarray(x0), (0, 2, 3, 1)))
    return np.array(tau), np.array(eps).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mptrain")
    jnet, params = _jax_model(TINY, 16)
    jddpm = JUNetDDPM(scheduler=JLinear(1e-4, 1e2),
                      params=jax.tree_util.tree_map(jnp.asarray, params),
                      module=jnet)
    x0 = np.random.RandomState(1).standard_normal((B, 3, 16, 16)).astype(np.float32)
    inp = {"j.x0": x0, **_flat(params, "j")}
    for i in range(3):
        inp[f"j.tau{i}"], inp[f"j.eps{i}"] = _jax_noise(
            jddpm, jax.random.PRNGKey(10 + i), x0)
    np.savez(tmp / "inputs.npz", **inp)
    for part in ("channel", "spatial"):  # one process's saves, resumed on the ranks
        run_loop("dp", total=2, checkpoint_every=2,
                 checkpoint_dir=str(tmp / f"one_{part}"))
    # JAX's three one-device steps
    trainer = JTrainer(ddpm=jddpm, noise_rng_impl="threefry",
                       dropout_rng_impl="threefry", **OPT)
    state = trainer.init_state()
    metrics = []
    for i in range(3):
        state, m = trainer.train_step(state, jax.random.PRNGKey(10 + i),
                                      jnp.asarray(x0))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    jparams = from_flax_params(jax.device_get(state.params))
    jema = from_flax_params(jax.device_get(state.ema_params))
    # the port in one process, its gradients recorded
    names = [str(n) for n in inp["j.names"]]
    tr = mp_trainer("channel")
    st = tr.init_state({n: torch.from_numpy(inp[f"j.p.{n}"]) for n in names})
    seen = record_grads(tr)
    for i in range(3):
        tr.train_step(st, torch.from_numpy(x0), tau=torch.from_numpy(inp[f"j.tau{i}"]),
                      eps=torch.from_numpy(inp[f"j.eps{i}"]))
    order = [n for n, _ in tr.ddpm.module.named_parameters()]
    one = [dict(zip(order, g)) for g in seen]
    whole = j_params_sharding(params, j_make_mesh(data=4, model=2), "channel")
    n_whole = sum(int(np.prod(p.shape)) for p, s in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(
            whole, is_leaf=lambda s: hasattr(s, "spec"))) if not any(s.spec))
    return {"metrics": metrics, "p": jparams, "e": jema, "one": one,
            "names": names, "n_whole": n_whole,
            "outs": launch("mp_train", 4, str(tmp)), "tmp": tmp}


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("partition", ["channel", "spatial"])
def test_three_steps_match_jax(train, partition, fsdp):
    key = f"{partition}.{fsdp}"
    for out in train["outs"]:
        for i, (loss, norm) in enumerate(train["metrics"]):
            np.testing.assert_allclose(out[f"{key}.loss{i}"], loss, rtol=1e-5)
            np.testing.assert_allclose(out[f"{key}.grad_norm{i}"], norm, rtol=1e-5)
        for name in train["names"]:
            bound = sum(adam_first_step_bound(
                torch.from_numpy(out[f"{key}.g{i}.{name}"]), train["one"][i][name],
                OPT["learning_rate"]) for i in range(3)).numpy() + 2e-6
            for kind in ("p", "e"):
                want = train[kind][name].numpy()
                err = np.abs(out[f"{key}.{kind}.{name}"] - want)
                assert (err <= bound).all(), (key, kind, name, float(err.max()))


@pytest.mark.parametrize("partition", ["channel", "spatial"])
def test_model_group_keeps_identical_whole_leaves(train, partition):
    """Each model group's ranks hold bitwise the same whole leaves after
    three steps (ranks 0 and 1 form one model group, 2 and 3 the other),
    and the FSDP steps equal the steps without it."""
    outs = train["outs"]
    key = f"{partition}.False"
    whole = [k for k in outs[0] if k.startswith(f"{key}.whole.")]
    assert whole
    for a, b in ((0, 1), (2, 3)):
        for k in whole:
            np.testing.assert_array_equal(outs[a][k], outs[b][k], err_msg=k)
    for name in train["names"]:
        for kind in ("p", "e"):
            np.testing.assert_allclose(outs[0][f"{partition}.True.{kind}.{name}"],
                                       outs[0][f"{key}.{kind}.{name}"], rtol=0,
                                       atol=2e-6, err_msg=name)
    held = [int(outs[0][f"{partition}.{f}.held"]) for f in (False, True)]
    assert held[1] < held[0]


def _tp_gathered_bytes(b: int) -> int:
    """The channel all-gathers of one forward of the tiny UNet at 16 x 16
    (each activation gathered once; the gathered size, fp32): the time
    MLP's two layers; each conv's and dense layer's sharded input, once
    per distinct activation (a resnet's input gathered for its shortcut,
    or by a downsample, is reused by the up path's concat); the
    attention's normalised input and output."""
    def act(c, h):
        return b * c * h * h * 4

    sizes = [b * 64 * 4, b * 64 * 4,                            # time MLP
             act(16, 16), act(16, 16), act(16, 16),             # res, downsample
             act(16, 8), act(32, 8), act(16, 8),                # res (shortcut)
             act(32, 8), act(32, 8),                            # attention
             act(32, 8), act(32, 8), act(32, 8), act(32, 8),    # mid res, attn
             act(32, 8), act(32, 8),                            # mid res
             act(32, 8), act(32, 8), act(64, 8), act(32, 8),    # up res (cat)
             act(32, 8), act(32, 8),                            # attention
             act(32, 8), act(48, 8), act(32, 8),                # up res (cat)
             act(32, 8), act(32, 8),                            # attention
             act(32, 8),                                        # upsample
             act(32, 16), act(48, 16), act(16, 16),             # up res (cat)
             act(16, 16), act(16, 16), act(32, 16), act(16, 16),
             act(16, 16)]                                       # conv_out
    return sum(sizes)


def _sp_bill(b: int, groups: int, n_params: int):
    """One SP step's model-axis bill on 2 ranks (levels of 8 and 4 rows a
    rank): a halo of one row each side for every 3x3 conv (one below for
    the downsample), forward and backward (but for ``conv_in``'s, whose
    input takes no gradient); two (B, G, 2) fp32 sums for
    each of the 17 GroupNorms outside the attention blocks; the 4
    attention blocks' gathered rows, forward (all-gather) and backward
    (all-reduce); the gradients and the loss, and the clip norm's
    scalar."""
    def row(c, w):
        return b * c * w * 4

    halo = (2 * row(3, 16) + 4 * row(16, 16) + row(16, 16)
            + 2 * row(16, 8) + 2 * row(32, 8) + 8 * row(32, 8)
            + 2 * row(64, 8) + 2 * row(32, 8) + 2 * row(48, 8) + 2 * row(32, 8)
            + 2 * row(32, 16) + 2 * row(48, 16) + 2 * row(16, 16)
            + 2 * row(32, 16) + 2 * row(16, 16) + 2 * row(16, 16))
    attn = 4 * b * 32 * 8 * 8 * 4
    gn = 17 * 2 * b * groups * 2 * 4
    return {"collective-permute": 2 * halo - 2 * row(3, 16), "all-gather": attn,
            "all-reduce": attn + gn + 4 * (n_params + 1) + 4}


def test_step_byte_bill(train):
    outs = train["outs"]
    b = B // 2
    n_params = sum(train["p"][n].numel() for n in train["names"])
    tp = _tp_gathered_bytes(b)
    for out in outs:
        assert out["bill.channel.all-gather"] == tp
        # each gather's backward all-reduces the same bytes; then the whole
        # leaves' gradients with the loss, and the clip norm's scalar
        assert out["bill.channel.all-reduce"] == tp + 4 * (train["n_whole"] + 1) + 4
        assert out["bill.channel.collective-permute"] == 0
        for kind, want in _sp_bill(b, TINY["norm_groups"], n_params).items():
            assert out[f"bill.spatial.{kind}"] == want, kind


@pytest.mark.parametrize("partition", ["channel", "spatial"])
def test_loops_and_checkpoints_across_layouts(train, partition, two_torch_threads):
    """The loop (3 steps, dropout 0.1, flips) on 2 x 2 against one
    process; a save under the mesh at step 2 resumed alone to step 3, and
    a save made alone at step 2 resumed under the mesh to step 4, each
    against the uninterrupted run in one process (losses 1e-4 relative,
    params 1e-5: the data axis's loop tolerances in
    test_torch_parallel_train.py)."""
    outs, tmp = train["outs"], train["tmp"]

    def flat(t):
        return np.concatenate([v.reshape(-1).numpy() for v in t.values()])

    _, _, logged, p, _ = run_loop("dp", total=4)
    loss = np.asarray([logged[k] for k in sorted(logged)])
    _, _, _, p3, _ = run_loop("dp")
    for out in outs:
        np.testing.assert_allclose(out[f"l.{partition}.loss"], loss[:3], rtol=1e-4)
        np.testing.assert_allclose(out[f"l.{partition}.p"], flat(p3), rtol=0,
                                   atol=1e-5)
    _, _, resumed, rp, _ = run_loop("dp", total=3, checkpoint_every=100,
                                    checkpoint_dir=str(tmp / f"mesh_{partition}"))
    assert sorted(resumed) == [3]
    np.testing.assert_allclose(resumed[3], loss[2], rtol=1e-4)
    np.testing.assert_allclose(flat(rp), flat(p3), rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs[0][f"c.{partition}.loss"], loss[2:], rtol=1e-4)
    np.testing.assert_allclose(outs[0][f"c.{partition}.p"], flat(p), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------
# the spatial sampler on 2 x 2
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def sampler(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mpsampler")
    cfg = dict(TINY)
    jnet, params = _jax_model(cfg, 16)
    jm = JUNetDDPM(scheduler=JLinear(1e-4, 1e2), params=params, module=jnet)
    shape, n = (4, 3, 16, 16), 3
    key = jax.random.PRNGKey(7)
    want = {}
    for step_type in ("ddpm", "ddim"):
        want[step_type] = js.DDPMSampler(
            ddpm=jm, scheduler=jm.scheduler, n_steps=n, obj_size=shape[1:],
            batch_size=shape[0], n_samples=shape[0], step_type=step_type,
            track_states=True).batch_sample(key)
    x_init, noise = jax_sampler_draws(key, n, shape)
    inp = {"cfg": np.asarray(json.dumps(cfg)), "x_init": x_init, "noise": noise,
           **_flat(params, "s")}
    np.savez(tmp / "inputs.npz", **inp)
    return want, inp, launch("mp_sampler", 4, str(tmp))


@pytest.mark.parametrize("step_type", ["ddpm", "ddim"])
def test_spatial_sampler_matches_jax(sampler, step_type):
    want, _, outs = sampler
    wx, ws = np.asarray(want[step_type]["x"]), np.asarray(want[step_type]["states"])
    for out in outs:
        np.testing.assert_allclose(out[f"{step_type}.x"], wx, rtol=0,
                                   atol=1e-4 * float(np.abs(wx).max()))
        np.testing.assert_allclose(out[f"{step_type}.states"], ws, rtol=0,
                                   atol=1e-4 * float(np.abs(ws).max()))


def test_spatial_sampler_draws_as_one_process(sampler, two_torch_threads):
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler
    from torch_dist_workers import mp_net

    _, inp, outs = sampler
    net = mp_net(json.loads(str(inp["cfg"])), [str(n) for n in inp["s.names"]],
                 inp, "s")
    ddpm = UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net, device="cpu")
    want = DDPMSampler(ddpm=ddpm, scheduler=ddpm.scheduler, n_steps=3,
                       obj_size=(3, 16, 16), batch_size=4, n_samples=4,
                       step_type="ddpm", device="cpu").batch_sample(
        torch.Generator().manual_seed(5))["x"].numpy()
    for out in outs:
        np.testing.assert_allclose(out["gen"], want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


# ---------------------------------------------------------------------
# the spatial partition on images whose rows the model axis does not
# divide (1 x 4 mesh, 18 x 18: every level whole on every rank)
# ---------------------------------------------------------------------

UNEVEN, UNEVEN_B = 18, 4


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    """JAX's one-device sampler (DDPM and DDIM, 3 steps, the states) and
    three train steps at 18 x 18; the port's one-process gradients of the
    same steps (for the Adam bound); a 16 x 16 DDIM step in one process
    (the even split's reference); one 4-rank launch for all of it."""
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler
    from torch_dist_workers import mp_net

    tmp = tmp_path_factory.mktemp("mpuneven")
    jnet, params = _jax_model(TINY, UNEVEN)
    jm = JUNetDDPM(scheduler=JLinear(1e-4, 1e2),
                   params=jax.tree_util.tree_map(jnp.asarray, params), module=jnet)
    shape, key = (UNEVEN_B, 3, UNEVEN, UNEVEN), jax.random.PRNGKey(7)
    want = {step_type: js.DDPMSampler(
        ddpm=jm, scheduler=jm.scheduler, n_steps=3, obj_size=shape[1:],
        batch_size=shape[0], n_samples=shape[0], step_type=step_type,
        track_states=True).batch_sample(key) for step_type in ("ddpm", "ddim")}
    x_init, noise = jax_sampler_draws(key, 3, shape)
    x0 = np.random.RandomState(2).standard_normal(shape).astype(np.float32)
    rng = np.random.RandomState(3)
    inp = {"x_init": x_init, "noise": noise, "x0": x0, **_flat(params, "u"),
           "even.x_init": rng.standard_normal((4, 3, 16, 16)).astype(np.float32),
           "even.noise": rng.standard_normal((1, 4, 3, 16, 16)).astype(np.float32)}
    for i in range(3):
        inp[f"tau{i}"], inp[f"eps{i}"] = _jax_noise(jm, jax.random.PRNGKey(10 + i), x0)
    np.savez(tmp / "inputs.npz", **inp)
    trainer = JTrainer(ddpm=jm, noise_rng_impl="threefry",
                       dropout_rng_impl="threefry", **OPT)
    state = trainer.init_state()
    metrics = []
    for i in range(3):
        state, m = trainer.train_step(state, jax.random.PRNGKey(10 + i),
                                      jnp.asarray(x0))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    names = [str(n) for n in inp["u.names"]]
    tr = mp_trainer("channel")
    st = tr.init_state({n: torch.from_numpy(inp[f"u.p.{n}"]) for n in names})
    seen = record_grads(tr)
    for i in range(3):
        tr.train_step(st, torch.from_numpy(x0), tau=torch.from_numpy(inp[f"tau{i}"]),
                      eps=torch.from_numpy(inp[f"eps{i}"]))
    order = [n for n, _ in tr.ddpm.module.named_parameters()]
    net = mp_net(TINY, names, inp, "u")
    ddpm = UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net, device="cpu")
    even = DDPMSampler(ddpm=ddpm, scheduler=ddpm.scheduler, n_steps=1,
                       obj_size=(3, 16, 16), batch_size=4, n_samples=4,
                       step_type="ddim", device="cpu").batch_sample(
        x_init=torch.from_numpy(inp["even.x_init"]),
        noise=torch.from_numpy(inp["even.noise"]))["x"].numpy()
    return {"want": want, "metrics": metrics, "names": names,
            "p": from_flax_params(jax.device_get(state.params)),
            "one": [dict(zip(order, g)) for g in seen], "even": even,
            "outs": launch("mp_uneven", 4, str(tmp))}


@pytest.mark.parametrize("step_type", ["ddpm", "ddim"])
def test_uneven_spatial_sampler_matches_jax(uneven, step_type):
    """sharded_sampler(partition="spatial") at 18 x 18 on a 1 x 4 mesh
    against JAX's one-device sampler (1e-4 of the scale), with no halo
    exchanged: every rank steps the whole images."""
    want = uneven["want"][step_type]
    wx, ws = np.asarray(want["x"]), np.asarray(want["states"])
    for out in uneven["outs"]:
        np.testing.assert_allclose(out[f"{step_type}.x"], wx, rtol=0,
                                   atol=1e-4 * float(np.abs(wx).max()))
        np.testing.assert_allclose(out[f"{step_type}.states"], ws, rtol=0,
                                   atol=1e-4 * float(np.abs(ws).max()))
        assert int(out[f"{step_type}.halo"]) == 0


def test_uneven_spatial_train_steps_match_jax(uneven):
    """Three spatial train steps at 18 x 18 on a 1 x 4 mesh: loss and
    grad_norm to 1e-5 relative of JAX's one-device steps, params within
    2e-6 of JAX's plus the Adam bound of the mesh's gradients against one
    process's; no halo exchanged."""
    for out in uneven["outs"]:
        for i, (loss, norm) in enumerate(uneven["metrics"]):
            np.testing.assert_allclose(out[f"loss{i}"], loss, rtol=1e-5)
            np.testing.assert_allclose(out[f"grad_norm{i}"], norm, rtol=1e-5)
        for name in uneven["names"]:
            bound = sum(adam_first_step_bound(
                torch.from_numpy(out[f"g{i}.{name}"]), uneven["one"][i][name],
                OPT["learning_rate"]) for i in range(3)).numpy() + 2e-6
            err = np.abs(out[f"p.{name}"] - uneven["p"][name].numpy())
            assert (err <= bound).all(), (name, float(err.max()))
        assert int(out["train.halo"]) == 0


def test_even_split_on_the_same_mesh_still_splits(uneven):
    """At 16 x 16 the same 1 x 4 mesh splits the rows (halo bytes
    exchanged) and the DDIM step matches one process (1e-4 of the
    scale)."""
    want = uneven["even"]
    for out in uneven["outs"]:
        assert int(out["even.halo"]) > 0
        np.testing.assert_allclose(out["even.x"], want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


# ---------------------------------------------------------------------
# rows 3s and 4s: the plain versions against JAX's GroupNorm
# ---------------------------------------------------------------------


@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("B_,S,C,G,R", [(2, 64, 128, 32, 2), (2, 64, 64, 16, 4),
                                        (1, 48, 96, 32, 3)])
def test_split_plain_versions_match_jax(B_, S, C, G, R, act):
    """Statistics of R row pieces added, then each piece normalised,
    against JAX's GroupNorm (its kernel in interpret mode) on the whole
    image; the backward's pieces against its VJP. 1e-5 (fp32 sums in
    another grouping)."""
    rng = np.random.RandomState(S + C)
    x = (rng.standard_normal((B_, S, C)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal((B_, S, C)).astype(np.float32)
    scale = (rng.standard_normal(C) * 0.2 + 1).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    eps = 1e-6
    y, vjp = jax.vjp(lambda x, s, b: j_fgn(x, s, b, G, eps, act, True),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    wdx, wds, wdb = vjp(jnp.asarray(g))
    tx, tgd = torch.from_numpy(x), torch.from_numpy(g)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    pieces, gps = tx.chunk(R, dim=1), tgd.chunk(R, dim=1)
    n = float(S * (C // G))
    sums = sum(tg.group_norm_stats(p, G) for p in pieces)
    out = torch.cat([tg.group_norm_apply(p, ts, tb, sums, G, n, eps, act)
                     for p in pieces], dim=1)
    parts = [tg.group_norm_bwd_stats(p, d, ts, tb, sums, G, n, eps, act)
             for p, d in zip(pieces, gps)]
    gsums = sum(p[0] for p in parts)
    dx = torch.cat([tg.group_norm_bwd_apply(p, d, ts, tb, sums, gsums, G, n, eps,
                                            act) for p, d in zip(pieces, gps)], dim=1)
    for got, want in ((out, y), (dx, wdx), (sum(p[1] for p in parts), wds),
                      (sum(p[2] for p in parts), wdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_split_group_norm_act_autograd_is_the_whole_group_norm():
    """One piece and no group: split_group_norm_act and its gradients are
    fused_group_norm_act's (the plain versions, 1e-5)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((2, 32, 64)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 32, 64)).astype(np.float32))
    grads = []
    for fn in (tg.split_group_norm_act, tg.fused_group_norm_act):
        xs = x.clone().requires_grad_(True)
        sc = torch.ones(64, requires_grad=True)
        bi = torch.zeros(64, requires_grad=True)
        y = fn(xs, sc, bi, 16, 1e-6, "silu")
        y.backward(dy)
        grads.append([y.detach(), xs.grad, sc.grad, bi.grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _split_coverage(plan, S, C):
    """How often the blocks and threads of a row 3s/4s plan touch each row
    and each channel of an image: block k's thread t = cvi + lane * V
    takes rows k rows + lane + i P (< its slab's end) and channels
    (cvi + j V) vec + e, every (cvi, lane) pair once, so an element's
    count is its row's count times its channel's."""
    rows, cols = np.zeros(S, np.int64), np.zeros(C, np.int64)
    for k in range(plan.slabs):
        end = min((k + 1) * plan.rows, S)
        for lane in range(plan.lanes_p):
            np.add.at(rows, np.arange(k * plan.rows + lane, end, plan.lanes_p), 1)
    vpr = C // plan.vec
    for cvi in range(plan.lanes_v):
        for cv in range(cvi, vpr, plan.lanes_v):
            np.add.at(cols, np.arange(cv * plan.vec, (cv + 1) * plan.vec), 1)
    return rows, cols


def _check_split_plan(plan, B_, S, C, itemsize, align):
    assert plan.lanes_v * plan.lanes_p <= plan.threads <= tg.SPLIT_THREADS
    assert plan.threads % 32 == 0 and plan.rows * (plan.slabs - 1) < S
    rows, cols = _split_coverage(plan, S, C)
    assert (rows == 1).all() and (cols == 1).all()
    assert C % plan.vec == 0 and align % (plan.vec * itemsize) == 0
    assert plan.vec * itemsize <= 16


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B_,S", [(64, 1024), (128, 256), (2, 16)])
def test_row3_plan_takes_a_channel_parallel_slice(B_, S, backward):
    """A TP rank's GroupNorm runs row 3 (4) on C / m channels and G / m
    groups: the plan at C 64 in 16 groups (the flagship's 128 channels and
    32 groups on 2 ranks) covers whole groups and every channel. The split
    kernels' plan (rows 3s and 4s, one plan for both directions) covers
    every row and channel exactly once, in 16-byte vectors of bf16."""
    plan = tg.plan_group_norm(B_, S, 64, 16, 2, backward)
    assert plan.cb % 4 == 0 and 16 % plan.kc == 0 and plan.cb * plan.kc == 64
    assert 1 <= plan.kr <= tg.MAX_CLUSTER_BLOCKS and plan.rows * plan.kr >= S
    split = tg.plan_split(B_, S, 64, 2)
    _check_split_plan(split, B_, S, 64, 2, 16)
    assert split.vec == 8


@pytest.mark.parametrize("itemsize,align", [(2, 16), (2, 8), (2, 4), (2, 2),
                                            (4, 16), (4, 8), (4, 4)])
@pytest.mark.parametrize("B_,S,C", [(8, 32768, 128), (64, 512, 128), (64, 512, 256),
                                    (128, 512, 384), (4, 16, 96), (2, 128, 512),
                                    (3, 7, 6)])
def test_split_plan_covers_and_fills_the_card(B_, S, C, itemsize, align):
    """Rows 3s/4s' plan at the headline shapes (the flagship's first level
    split in two, C 128 / 256 / 384), the first level of a 256 x 256 image
    split in two (B 8, S 32768) and edge shapes: every row and channel
    once, the widest vector that C and the alignment allow (16 bytes at
    most), every thread SPLIT_UNROLL loads at least where the image has
    the rows, and at least a block for each of the H100's 132 SMs wherever
    the batch has the rows for it."""
    plan = tg.plan_split(B_, S, C, itemsize, align)
    _check_split_plan(plan, B_, S, C, itemsize, align)
    widest = max(v for v in (1, 2, 4, 8) if v * itemsize <= min(16, align)
                 and C % v == 0)
    assert plan.vec == widest
    passes = -(-(C // plan.vec) // plan.lanes_v)
    if S >= plan.lanes_p * tg.SPLIT_UNROLL:
        assert passes * (plan.rows // plan.lanes_p) >= tg.SPLIT_UNROLL
    if B_ * S >= 132 * plan.lanes_p * tg.SPLIT_UNROLL:
        assert B_ * plan.slabs >= 132
    if (B_, S) == (8, 32768):
        assert B_ * plan.slabs >= 132


def test_spatial_sampler_refuses_a_model_without_spatial_activations():
    """JAX's check and message for the analytic TrueDDPM, on JAX's 2 x 4
    mesh and the port's rules."""
    import types

    from pdm_tpu.diffusion.sampling import DDPMSampler as JSampler
    from pdm_tpu.models.base import TrueDDPM as JTrue
    from pdm_tpu.parallel.distributed import sharded_sampler as j_sharded

    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.parallel import sharded_sampler
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    data = np.random.RandomState(0).standard_normal((100, 1, 1, 1)).astype(np.float32)
    jsched = JLinear(1e-4, 1e2)
    jsampler = JSampler(ddpm=JTrue(scheduler=jsched, train_data=jnp.asarray(data)),
                        scheduler=jsched, n_steps=4, obj_size=(1, 1, 1),
                        batch_size=8, n_samples=8, step_type="ddim")
    with pytest.raises(ValueError, match="spatial") as want:
        j_sharded(jsampler, j_make_mesh(data=2, model=4), partition="spatial")
    sched = LinearBetaScheduler(1e-4, 1e2)
    sampler = DDPMSampler(ddpm=TrueDDPM(scheduler=sched, train_data=torch.from_numpy(data),
                                        device="cpu"),
                          scheduler=sched, n_steps=4, obj_size=(1, 1, 1), batch_size=8,
                          n_samples=8, step_type="ddim", device="cpu")
    stub = types.SimpleNamespace(shape={"data": 2, "model": 4})
    with pytest.raises(ValueError, match="spatial") as got:
        sharded_sampler(sampler, stub, partition="spatial")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("partition", ["channel", "spatial"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
def test_port_params_sharding_is_jax_rule_in_the_ports_layout(shape, partition,
                                                               fsdp):
    """The specs the trainer and the model-parallel UNet use: JAX's
    ``params_sharding`` of the tiny UNet's JAX parameters, each brought to
    the port's layout (HWIO -> OIHW, (in, out) -> (out, in)) under the
    port's name."""
    import types

    from pdm_tpu_torch.models import weights
    from pdm_tpu_torch.parallel.mesh import port_params_sharding

    _, params = _jax_model(TINY, 16)
    want = j_params_sharding(params, j_make_mesh(*shape), partition, fsdp=fsdp)
    shapes = {k: tuple(v.shape) for k, v in from_flax_params(params).items()}
    stub = types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
    got = port_params_sharding(shapes, stub, partition, fsdp=fsdp)
    n = 0
    for path, leaf in weights._leaves(params):
        node = want
        for p in path:
            node = node[p]
        spec = list(node.spec) + [None] * (leaf.ndim - len(node.spec))
        perm = {4: (3, 2, 0, 1), 2: (1, 0)}.get(leaf.ndim, (0,))
        port = tuple(spec[i] for i in perm)
        top, *mid, lf = path
        mid = ["to_out.0" if m == "to_out" else m for m in mid]
        name = ".".join([weights._map_module(top), *mid,
                         weights._map_leaf(lf, np.asarray(leaf))[0]])
        assert got[name] == (port if any(port) else ()), name
        n += 1
    assert n == len(got) > 40


def _stub_mesh(model_index, model=2):
    """One rank's view of a 1 x ``model`` mesh without a process group:
    enough to build the model-parallel layers and a trainer's state
    (collectives over no group do nothing)."""
    import types

    from pdm_tpu_torch.parallel.collectives import CollectiveStats

    return types.SimpleNamespace(
        shape={"data": 1, "model": model}, data_index=0, data_size=1,
        model_index=model_index, model_size=model, model_group=None,
        model_stats=CollectiveStats(), data_group=None, stats=CollectiveStats())


@pytest.mark.parametrize("partition", ["channel", "spatial"])
def test_model_parallel_unet_copies_no_whole_weight(partition):
    """The model-parallel UNet shares every tensor it keeps whole with the
    UNet it was made from (all of them under "spatial") and holds new
    tensors only for the leaves it cuts: this rank's slices, 1/m of each."""
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.parallel.model_parallel import ModelParallelUNet

    net = unet_from_config(3, TINY, device="cpu")
    whole = dict(net.named_parameters())
    for r in range(2):
        mp = ModelParallelUNet(net, _stub_mesh(r), partition)
        n_cut = 0
        for name, p in mp.named_parameters():
            if "model" in mp.specs[name]:
                dim = mp.specs[name].index("model")
                n = whole[name].shape[dim] // 2
                assert torch.equal(p, whole[name].narrow(dim, r * n, n)), name
                assert p.untyped_storage().nbytes() == whole[name].nbytes // 2
                n_cut += 1
            else:
                assert p is whole[name], name
        assert (n_cut > 40) if partition == "channel" else (n_cut == 0)
    assert all(p is whole[n] for n, p in net.named_parameters())  # left intact


@pytest.mark.parametrize("partition", ["channel", "spatial"])
def test_trainer_keeps_no_whole_weights_under_a_model_axis(partition):
    """Under a model axis the trainer holds the model-parallel module and
    the whole model's layers on the meta device (no storage), its fp32
    ``params`` on the host; the eval hook's model is made from the EMA
    when asked, and equals the whole model loaded with it. A second
    ``init_state`` keeps the partition; another mesh raises."""
    from pdm_tpu_torch.models.unet import unet_from_config
    from pdm_tpu_torch.parallel.model_parallel import ModelParallelUNet

    tr = mp_trainer(partition)
    net = tr.ddpm.module
    whole = {n: p.detach().clone() for n, p in net.named_parameters()}
    mesh = _stub_mesh(1)
    state = tr.init_state(mesh=mesh)
    mp = tr.ddpm.module
    assert isinstance(mp, ModelParallelUNet) and tr.ddpm.params is None
    base = tr.base_ddpm()
    assert all(p.is_meta for p in base.module.parameters())
    assert base.params is not None  # init_unet_ddpm's draws
    assert all(t.device.type == "cpu" for t in base.params.values())
    held = sum(p.numel() for p in mp.parameters())
    n_whole = sum(t.numel() for t in whole.values())
    if partition == "channel":
        assert held < 0.6 * n_whole
        assert sum(t.numel() for t in state.params.values()) == held
    else:
        assert held == n_whole
    ema = {n: t + 0.01 for n, t in whole.items()}
    evald = base.with_params(ema)
    ref = unet_from_config(3, TINY, device="cpu")
    ref.load_state_dict(ema)
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 3, 16, 16)).astype(np.float32))
    tau = torch.tensor([0.2, 0.8])
    with torch.no_grad():
        assert torch.equal(evald.module(x, tau), ref(x, tau))
    assert all(p.is_meta for p in base.module.parameters())
    again = tr.init_state(mesh=mesh)
    assert tr.ddpm.module is mp and set(again.params) == set(state.params)
    with pytest.raises(ValueError, match="make a new trainer"):
        tr.init_state(mesh=_stub_mesh(1))
