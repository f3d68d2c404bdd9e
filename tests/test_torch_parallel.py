"""Port parity: the data axis's rules and one-process behaviour
(pdm_tpu_torch.parallel, core/draws.py), against the JAX package on its 8
virtual devices.

* ``params_sharding``: the spec of every parameter equal to JAX's on 4 x 2
  and 8 x 1 meshes, channel and spatial, with and without FSDP, on JAX's
  test parameters and the tiny UNet's (JAX layout).
* ``mesh_from_config``'s branches (``mesh_shape_from_config`` over n
  ranks) and ``check_batch_divisible``: JAX's shapes, warnings and
  messages; the trainer's batch checks: JAX's messages.
* The collective cost model: JAX's algorithm volumes exactly (the same
  link figure given to both), and ``CollectiveStats``' fields.
* The model axis's errors and a sampler's partition are checked as JAX
  checks them (the model axis itself: ``test_torch_parallel_model.py``).
* Draws: a ``SlicedGenerator`` gives a rank its rows of the global draw.
* A mesh of one rank (no process group): training equals training with no
  mesh, bitwise.
Multi-rank runs: ``test_torch_parallel_{stats,steps,train,cli}.py``.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.config.config import ParallelConfig as JParallel
from pdm_tpu.diffusion.trainer import DDPMTrainer as JTrainer
from pdm_tpu.models.from_config import _mesh_requested as j_mesh_requested
from pdm_tpu.models.unet import unet_from_config as j_unet_from_config
from pdm_tpu.parallel import collectives as jcoll
from pdm_tpu.parallel.mesh import (
    check_batch_divisible as j_check_batch_divisible,
    make_mesh as j_make_mesh,
    mesh_from_config as j_mesh_from_config,
    params_sharding as j_params_sharding,
)

from pdm_tpu_torch.config.config import ParallelConfig
from pdm_tpu_torch.core.draws import SlicedGenerator, batch_rand, batch_randn
from pdm_tpu_torch.models.from_config import _mesh_requested
from pdm_tpu_torch.parallel import (
    batch_sharding, initialize_multihost, make_mesh, params_sharding,
    replicated, shard_batch, shard_params, sharded_sampler,
    unet_with_model_parallel, unet_with_sp, unet_with_tp,
)
from pdm_tpu_torch.parallel.collectives import (
    H100_NVLINK_BW, CollectiveStats, link_seconds, project_step,
)
from pdm_tpu_torch.parallel.mesh import (
    check_batch_divisible, mesh_from_config, mesh_shape_from_config,
)
from torch_dist_workers import run_loop
from torch_port_fixtures import two_torch_threads  # noqa: F401


def _stub(data, model=1):
    """A mesh's shape alone, for the rules that read nothing else."""
    return types.SimpleNamespace(shape={"data": data, "model": model})


def _jax_params():
    test = {"conv": {"kernel": np.zeros((3, 3, 16, 64)), "bias": np.zeros((64,))},
            "norm": {"scale": np.zeros((33,))}}
    net = j_unet_from_config(3, {
        "block_out_channels": [16, 32], "layers_per_block": 1,
        "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
        "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
        "attention_head_dim": 16, "norm_groups": 4})
    shapes = jax.eval_shape(lambda k: net.init(
        k, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))["params"],
        jax.random.PRNGKey(0))
    unet = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    return {"test": test, "unet": unet}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("partition", ["channel", "spatial"])
@pytest.mark.parametrize("shape", [(4, 2), (8, 1)], ids=["4x2", "8x1"])
def test_params_sharding_matches_jax(shape, partition, fsdp):
    params = _jax_params()
    jmesh = j_make_mesh(*shape)
    want = j_params_sharding(params, jmesh, partition, fsdp=fsdp)
    got = params_sharding(params, _stub(*shape), partition, fsdp=fsdp)
    flat_want = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: hasattr(x, "spec"))
    n = 0
    for path, sh in flat_want:
        node = got
        for p in path:
            node = node[p.key]
        assert node == tuple(sh.spec), (path, node, sh.spec)
        n += 1
    assert n > 20


def test_params_sharding_rejects_an_unknown_partition():
    with pytest.raises(ValueError, match="partition"):
        params_sharding({"w": np.zeros((4, 4))}, _stub(4, 2), "pipeline")


# (ParallelConfig fields, visible devices, batch_size, grad_accum)
MESH_CASES = [
    ({"data_axis": 4, "model_axis": 2}, 8, None, 1),
    ({}, 8, None, 1),
    ({}, 1, None, 1),
    ({"data_axis": 16}, 8, None, 1),
    ({}, 8, 100, 1),
    ({}, 8, 1, 1),
    ({"data_axis": 8}, 8, 100, 1),
    ({}, 8, 16, 4),
    ({}, 8, 64, 2),
    ({"model_axis": 3}, 8, None, 1),
    ({"data_axis": 1}, 8, None, 1),
]


def _outcome(fn):
    """(result, warning texts, error text) of a call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            return fn(), [str(w.message) for w in caught], None
        except ValueError as e:
            return None, [str(w.message) for w in caught], str(e)


@pytest.mark.parametrize("case", range(len(MESH_CASES)))
def test_mesh_from_config_matches_jax(case):
    fields, n, batch, accum = MESH_CASES[case]
    want, want_warn, want_err = _outcome(lambda: j_mesh_from_config(
        JParallel(**fields), devices=jax.devices()[:n], batch_size=batch,
        grad_accum=accum))
    got, got_warn, got_err = _outcome(lambda: mesh_shape_from_config(
        ParallelConfig(**fields), n, batch_size=batch, grad_accum=accum))
    assert got_err == want_err and got_warn == want_warn
    if want_err is None:
        want = None if want is None else (want.shape["data"], want.shape["model"])
        assert got == want


def test_mesh_from_config_in_one_process():
    """One rank, no process group: None unless asked, a mesh of one rank
    for data_axis 1, JAX's error for more; a model axis over 8 ranks needs
    the process group."""
    assert mesh_from_config(ParallelConfig()) is None
    mesh = mesh_from_config(ParallelConfig(data_axis=1))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    assert mesh.model_group is None and mesh.model_size == 1
    with pytest.raises(ValueError, match="only 1 are visible"):
        mesh_from_config(ParallelConfig(data_axis=2))
    with pytest.raises(ValueError, match="torch.distributed"):
        mesh_from_config(ParallelConfig(model_axis=2), devices=range(8))
    with pytest.raises(ValueError, match="torch.distributed"):
        make_mesh(data=2, devices=range(2))


@pytest.mark.parametrize("batch,data,what", [(12, 8, "batch"), (16, 8, "batch"),
                                             (6, 4, "sample.batch_size")])
def test_check_batch_divisible_matches_jax(batch, data, what):
    jmesh = j_make_mesh(data=data, model=1, devices=jax.devices()[:data])
    want, _, want_err = _outcome(lambda: j_check_batch_divisible(batch, jmesh, what))
    got, _, got_err = _outcome(lambda: check_batch_divisible(batch, _stub(data),
                                                             what))
    assert got_err == want_err and got is want is None


@pytest.mark.parametrize("accum,batch", [(1, 12), (2, 8), (3, 16)])
def test_train_rejects_bad_batches_as_jax(accum, batch):
    """The trainer's checks (JAX's tests/test_parallel.py:177 and
    tests/test_fsdp.py:256) raise JAX's messages before any work."""
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer

    jmesh = j_make_mesh(data=8, model=1)
    data = jnp.zeros((8, 1, 2, 2))
    with pytest.raises(ValueError) as want:
        JTrainer(ddpm=None, grad_accum=accum).train(
            data, batch_size=batch, total_iters=1, mesh=jmesh)
    with pytest.raises(ValueError) as got:
        DDPMTrainer(ddpm=None, grad_accum=accum).train(
            torch.zeros((8, 1, 2, 2)), batch_size=batch, total_iters=1,
            mesh=_stub(8))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axis", [1, 2, 4, 8, 16])
def test_collective_cost_model_matches_jax(axis):
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute", "all-to-all"):
        for nbytes in (0, 4, 123_456_789):
            assert link_seconds(kind, nbytes, axis, H100_NVLINK_BW) == \
                jcoll.ici_seconds(kind, nbytes, axis, H100_NVLINK_BW)
    stats, jstats = CollectiveStats(), jcoll.CollectiveStats()
    for kind, nbytes in (("all-reduce", 1000), ("all-gather", 64),
                         ("all-reduce", 24)):
        stats.add(kind, nbytes)
        jstats.bytes_by_kind[kind] = jstats.bytes_by_kind.get(kind, 0) + nbytes
        jstats.count_by_kind[kind] = jstats.count_by_kind.get(kind, 0) + 1
    assert stats.bytes_by_kind == jstats.bytes_by_kind
    assert stats.count_by_kind == jstats.count_by_kind
    assert stats.total_bytes == jstats.total_bytes == 1088
    assert stats["all-reduce"] == 1024 and stats.counts("all-reduce") == 2
    assert project_step(stats, axis) == jcoll.project_step(jstats, axis,
                                                           H100_NVLINK_BW)
    stats.reset()
    assert stats.total_bytes == 0 and stats.counts("all-gather") == 0


def test_model_axis_raises_and_partitions_are_checked(monkeypatch):
    """A model axis of 1 is JAX's no-op; an unknown partition, a batch the
    data axis does not divide, a spatial sampler without a UNet and the
    whole-block opt-in under a model axis raise JAX's errors (the last the
    port's own)."""
    from pdm_tpu_torch.parallel.model_parallel import refuse_fused_block

    net = object()
    assert unet_with_tp(net, _stub(4)) is net
    assert unet_with_sp(net, _stub(4)) is net
    assert unet_with_model_parallel(net, _stub(4), "spatial") is net
    with pytest.raises(ValueError, match="unknown model partition"):
        unet_with_model_parallel(net, _stub(4), "pipeline")
    sampler = types.SimpleNamespace(batch_size=6)
    with pytest.raises(ValueError, match="sample.batch_size=6"):
        sharded_sampler(sampler, _stub(4), "data")
    sampler.batch_size = 8
    sampler.ddpm = types.SimpleNamespace()
    with pytest.raises(ValueError, match="spatial-parallel sampling needs"):
        sharded_sampler(sampler, _stub(4, 2), "spatial")
    with pytest.raises(ValueError, match=r"unknown sampler partition 'x' \(data\|spatial\)"):
        sharded_sampler(sampler, _stub(4), "x")
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    with pytest.raises(ValueError, match="PDM_FUSED_BLOCK"):
        refuse_fused_block()


def test_mesh_requested_matches_jax(monkeypatch):
    """With one device visible (one rank here), the same decision."""
    devices = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    for fields in ({}, {"data_axis": 1}, {"data_axis": 2}, {"model_axis": 2},
                   {"data_axis": 1, "model_axis": 2}):
        cfg = types.SimpleNamespace(parallel=ParallelConfig(**fields))
        jcfg = types.SimpleNamespace(parallel=JParallel(**fields))
        assert _mesh_requested(cfg) == j_mesh_requested(jcfg), fields


@pytest.mark.parametrize("draw", [batch_rand, batch_randn])
def test_sliced_generator_keeps_its_rows_of_the_global_draw(draw):
    whole = draw((8, 3, 2), torch.Generator().manual_seed(5))
    parts = [draw((2, 3, 2), SlicedGenerator(
        torch.Generator().manual_seed(5), 8, 2 * r, 2 * r + 2))
        for r in range(4)]
    assert torch.equal(torch.cat(parts), whole)
    with pytest.raises(ValueError, match="keeps 2"):
        draw((3, 3), SlicedGenerator(torch.Generator(), 8, 0, 2))


def test_one_rank_mesh_shards_nothing():
    mesh = make_mesh(data=1)
    x = torch.arange(12.0).reshape(6, 2)
    assert shard_batch(x, mesh) is not None and torch.equal(shard_batch(x, mesh), x)
    assert replicated(mesh).shard(x) is x
    assert torch.equal(batch_sharding(mesh).gather(x), x)
    g = torch.Generator()
    assert batch_sharding(mesh).generator(g, 6) is g
    params = {"w": torch.ones(4, 6), "b": torch.ones(6)}
    assert all(torch.equal(a, params[k]) for k, a in shard_params(
        params, mesh, fsdp=True).items())
    assert mesh.all_reduce(x.clone()).equal(x) and mesh.stats.total_bytes == 0
    initialize_multihost()  # one process: nothing to start
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("name", ["dp_accum", "fsdp"])
def test_one_rank_mesh_trains_as_no_mesh(name):
    _, _, logged, p, e = run_loop(name)
    _, _, logged_m, p_m, e_m = run_loop(name, mesh=make_mesh(data=1))
    assert logged == logged_m
    for a, b in ((p, p_m), (e, e_m)):
        assert all(torch.equal(a[k], b[k]) for k in a)
