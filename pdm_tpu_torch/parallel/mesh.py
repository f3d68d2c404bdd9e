"""The ('data', 'model') mesh over torch.distributed ranks, and the
sharding rules.

Counterpart of ``pdm_tpu/parallel/mesh.py``. JAX runs one program over
global arrays and GSPMD partitions it; the port runs one process per card
(``torchrun``), each rank running the same program with the same seeds
and host-side inputs, computing its shard and merging through the
collectives of ``parallel/collectives.py``, so that every rank returns
the replicated result JAX returns.

* axis ``data``: the batch, MC-trajectory or dataset-N axis. Each rank
  holds rows ``[i B/D, (i+1) B/D)`` of a global batch of B over a data
  axis of D (:class:`BatchSharding`); results are gathered or all-reduced
  over the data axis's process group.
* axis ``model``: tensor (channel) or spatial (image rows) parallelism
  of the UNet. Its sharding rules (:func:`params_sharding`) are JAX's.
  The port's UNet calls its kernels through ctypes, which nothing
  partitions, so the axis runs hand-partitioned layers
  (``parallel/model_parallel.py``, built by :func:`unet_with_tp` and
  :func:`unet_with_sp`) whose collectives run over the mesh's
  ``model_group``; the ranks of one model group hold the same images.

A :class:`Mesh` is built over the default process group, whatever backend
started it (``initialize_multihost``). The ranks ``[0, data * model)``
form it, data-major as JAX's ``reshape(data, model)``. Every rank of the
default group builds the mesh, since each of its sub-groups is made by a
call that all ranks enter; a rank left out (``mesh_from_config`` shrinks
an automatic data axis to divide the batch, or ``data_axis`` is smaller
than the world) then holds no group and runs the whole program alone as
a replica, with no collective, so that it too returns the result.
Without torch.distributed a mesh has one rank.
"""

from __future__ import annotations

import warnings
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from ..core.draws import SlicedGenerator
from .collectives import CollectiveStats, all_gather, all_reduce

Spec = Tuple[Optional[str], ...]  # a PartitionSpec: an axis name or None a dim

def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default process group; 1 outside torch.distributed."""
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 outside it."""
    return dist.get_rank() if _initialized() else 0


def _device_type() -> str:
    """The device of this process's mesh: the card when there is one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


class Mesh:
    """A ('data', 'model') mesh of ranks. ``shape`` maps each axis to its
    size, as JAX's ``Mesh.shape``; ``stats`` counts the collectives issued
    over the data axis, ``model_stats`` those over the model axis. On a
    member rank, ``data_index`` and ``model_index`` are its coordinate,
    ``data_group`` and ``model_group`` the process groups of the ranks
    that share its place on the other axis (None for a mesh of one rank
    outside torch.distributed and for a rank the mesh leaves out, which
    then holds everything: ``data_size`` and ``model_size`` 1)."""

    def __init__(self, data: int, model: int = 1,
                 ranks: Optional[Sequence[int]] = None):
        self.shape: Dict[str, int] = {"data": int(data), "model": int(model)}
        self.stats = CollectiveStats()
        self.model_stats = CollectiveStats()
        n = data * model
        ranks = list(range(n)) if ranks is None else list(ranks)[:n]
        if len(ranks) != n:
            raise ValueError(f"mesh {data}x{model} needs {n} ranks: {ranks}")
        self.device_mesh = None
        self.data_group = self.model_group = None
        self.data_index, self.model_index = 0, 0
        self.data_size = self.model_size = 1
        if not _initialized():
            if n != 1:
                raise ValueError(
                    f"a mesh of {n} ranks needs torch.distributed: start the "
                    f"process group first (initialize_multihost)")
            return
        from torch.distributed.device_mesh import DeviceMesh

        # every rank enters the sub-groups' creation, members or not
        mesh = DeviceMesh(
            _device_type(),
            torch.tensor(ranks, dtype=torch.int64).reshape(data, model),
            mesh_dim_names=("data", "model"))
        coord = mesh.get_coordinate()
        if coord is None:  # left out: a replica of its own
            return
        self.device_mesh = mesh
        self.data_index, self.model_index = int(coord[0]), int(coord[1])
        self.data_size, self.model_size = int(data), int(model)
        self.data_group = self.device_mesh.get_group("data")
        self.model_group = self.device_mesh.get_group("model")

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    # -- the collectives over the data axis (counted in ``stats``) --

    def all_reduce(self, t: Tensor, op: str = "sum") -> Tensor:
        return all_reduce(t, self.data_group, self.stats, op)

    def all_gather(self, t: Tensor) -> Tensor:
        return all_gather(t, self.data_group, self.data_size, self.stats)

    # -- over the model axis (counted in ``model_stats``) --

    def model_all_reduce(self, t: Tensor, op: str = "sum") -> Tensor:
        return all_reduce(t, self.model_group, self.model_stats, op)


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[int]] = None,
) -> Mesh:
    """A ("data", "model") mesh over ``devices`` (ranks; all of them by
    default). ``data`` defaults to n_devices // model."""
    devices = list(devices if devices is not None else range(world_size()))
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(data, model, devices)


def mesh_shape_from_config(
    parallel,
    n: int,
    batch_size: Optional[int] = None,
    grad_accum: int = 1,
) -> Optional[Tuple[int, int]]:
    """(data, model) of the mesh :func:`mesh_from_config` builds over
    ``n`` ranks, or None: JAX's branches and messages, with the visible
    devices read as ranks."""
    model = max(1, int(parallel.model_axis))
    data = parallel.data_axis
    if data is None:
        if n == 1 and model == 1:
            return None
        if n % model != 0:
            raise ValueError(
                f"parallel.model_axis={model} does not divide the "
                f"{n} visible devices; set parallel.data_axis explicitly")
        data = n // model
        # the micro-batch (batch_size // grad_accum) must divide the data
        # axis: the trainer splits each batch into micro-batches first
        eff_batch = (None if batch_size is None
                     else batch_size // max(1, int(grad_accum)))
        if eff_batch is not None and eff_batch % data != 0:
            best = max(d for d in range(1, data + 1) if eff_batch % d == 0)
            warnings.warn(
                f"auto mesh: micro-batch {eff_batch} (batch_size="
                f"{batch_size} / grad_accum={grad_accum}) is not divisible "
                f"by the {data} available data-parallel slots; using "
                f"data={best} (set parallel.data_axis to silence)",
                stacklevel=3)
            data = best
        if data * model == 1:
            return None
    data = int(data)
    if data < 1 or model < 1 or data * model > n:
        raise ValueError(
            f"mesh data={data} x model={model} needs {data * model} devices "
            f"but only {n} are visible")
    return data, model


def mesh_from_config(
    parallel,
    devices: Optional[Sequence[int]] = None,
    batch_size: Optional[int] = None,
    grad_accum: int = 1,
) -> Optional[Mesh]:
    """The mesh of a ``ParallelConfig``, or None for one rank with no
    parallelism asked for: the one entry point the CLIs use. An automatic
    data axis (``data_axis`` null) spans the ranks and shrinks, with a
    warning, to the largest width that divides the micro-batch; an
    explicit one that does not fit raises. ``model_axis`` ranks of
    consecutive numbers form a model group, as JAX's devices do."""
    devices = list(devices if devices is not None else range(world_size()))
    shape = mesh_shape_from_config(parallel, len(devices), batch_size,
                                   grad_accum)
    if shape is None:
        return None
    return make_mesh(*shape, devices=devices[: shape[0] * shape[1]])


def check_batch_divisible(batch_size: int, mesh, what: str = "batch_size"):
    """Loud precondition for data-parallel sharding."""
    ax = mesh.shape["data"]
    if batch_size % ax != 0:
        raise ValueError(
            f"{what}={batch_size} is not divisible by the mesh 'data' axis "
            f"({ax}); choose {what} a multiple of {ax} or shrink "
            f"parallel.data_axis")


class BatchSharding:
    """The leading (batch) axis over 'data', the rest replicated: this
    rank's rows ``[index * b, (index + 1) * b)`` of a global batch of
    ``size * b``. ``shard`` takes them, ``gather`` puts the global batch
    back together on every rank (all-gather)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.data_size
        self.index = mesh.data_index

    def rows(self, n: int) -> slice:
        """This rank's rows of a global leading axis of ``n``."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)

    def shard(self, x):
        if isinstance(x, Mapping):
            return {k: self.shard(v) for k, v in x.items()}
        return x[self.rows(x.shape[0])]

    def gather(self, x: Tensor) -> Tensor:
        return self.mesh.all_gather(x)

    def local_shape(self, n: int, obj_size) -> Tuple[int, ...]:
        """This rank's part of a global batch of ``n`` objects."""
        return (n // self.size, *obj_size)

    def shard_steps(self, x: Tensor) -> Tensor:
        """This rank's part of a (steps, batch, ...) stack."""
        return x[:, self.rows(x.shape[1])]

    def gather_steps(self, x: Tensor) -> Tensor:
        """The global (steps, batch, ...) stack from this rank's part."""
        return self.gather(x.transpose(0, 1)).transpose(0, 1)

    def generator(self, generator: Optional[torch.Generator], n: int):
        """``generator`` drawing a global batch of ``n`` rows and keeping
        this rank's (``core/draws.py``), or itself on one rank."""
        if self.size == 1 or generator is None:
            return generator
        r = self.rows(n)
        return SlicedGenerator(generator, n, r.start, r.stop)


class Replicated:
    """Every rank holds the whole array (JAX's ``P()``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def shard(self, x):
        return x


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard the leading (batch) axis over 'data', replicate the rest."""
    return BatchSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(x, mesh: Mesh):
    """This rank's rows of a tensor (or mapping of tensors)."""
    return batch_sharding(mesh).shard(x)


# ---------------------------------------------------------------------
# parameter sharding rules (JAX's, as specs per parameter)
# ---------------------------------------------------------------------


def _leaf_spec(shape: Sequence[int], model_axis_size: int) -> Spec:
    """Tensor-parallel rule: a parameter of 2+ dims shards its last dim
    (Cout of a conv or dense kernel in JAX's layout) over 'model' where
    divisible; anything else is replicated."""
    if len(shape) >= 2 and shape[-1] % model_axis_size == 0:
        return (*([None] * (len(shape) - 1)), "model")
    return ()


def _with_fsdp(spec: Spec, shape: Sequence[int], data_size: int) -> Spec:
    """FSDP on top of ``spec``: the largest still-unsharded dimension
    divisible by the 'data' axis shards over 'data'; a parameter with no
    such dimension keeps ``spec``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    cand = [(shape[i], i) for i in range(len(shape))
            if entries[i] is None and shape[i] % data_size == 0
            and shape[i] >= data_size]
    if not cand:
        return spec
    _, i = max(cand)
    entries[i] = "data"
    return tuple(entries)


def _map(params, fn, path=()):
    if isinstance(params, Mapping):
        return {k: _map(v, fn, (*path, k)) for k, v in params.items()}
    return fn(params)


def params_sharding(params, mesh, partition: str = "channel",
                    fsdp: bool = False):
    """A spec per parameter (a tuple with an axis name or None a dim; ()
    is replicated), in ``params``' structure (nested mappings of tensors
    or shapes).

    ``partition="channel"``: the last dim over 'model' (tensor
    parallelism), replicated over 'data'; ``"spatial"``: replicated, since
    spatial parallelism shards activations. ``fsdp=True`` shards each
    parameter's largest remaining dimension over 'data' as well."""
    def shape_of(leaf):
        return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)

    if partition == "spatial":
        base = _map(params, lambda leaf: ())
    elif partition == "channel":
        m = mesh.shape["model"]
        base = _map(params, lambda leaf: _leaf_spec(shape_of(leaf), m))
    else:
        raise ValueError(
            f"unknown model partition {partition!r} (channel|spatial)")
    d = mesh.shape["data"]
    if not fsdp or d <= 1:
        return base

    def with_fsdp(params, base):
        if isinstance(params, Mapping):
            return {k: with_fsdp(params[k], base[k]) for k in params}
        return _with_fsdp(base, shape_of(params), d)

    return with_fsdp(params, base)


def shard_leaf(leaf: Tensor, spec: Spec, mesh: Mesh,
               axes: Sequence[str] = ("data", "model")) -> Tensor:
    """This rank's part of one tensor under ``spec``: each dim sharded
    over one of ``axes`` is cut (a view) to this rank's place on it."""
    index = {"data": (mesh.data_index, mesh.data_size),
             "model": (mesh.model_index, mesh.model_size)}
    for dim, axis in enumerate(spec):
        if axis is None or axis not in axes:
            continue
        i, size = index[axis]
        step = leaf.shape[dim] // size
        leaf = leaf.narrow(dim, i * step, step)
    return leaf


def shard_params(params, mesh: Mesh, partition: str = "channel",
                 fsdp: bool = False):
    """This rank's part of every parameter under :func:`params_sharding`
    (:func:`shard_leaf` of each)."""
    specs = params_sharding(params, mesh, partition, fsdp=fsdp)

    def walk(params, specs):
        if isinstance(params, Mapping):
            return {k: walk(params[k], specs[k]) for k in params}
        return shard_leaf(params, specs, mesh)

    return walk(params, specs)


def _to_jax_layout(shape: Sequence[int]):
    """The JAX layout of a port parameter's shape, and the port dim of
    each JAX dim: a conv weight (Cout, Cin, kh, kw) is JAX's (kh, kw, Cin,
    Cout), a dense one (Cout, Cin) is JAX's (Cin, Cout); 1-D leaves are
    the same."""
    order = {4: (2, 3, 1, 0), 2: (1, 0)}.get(len(shape), tuple(range(len(shape))))
    return tuple(shape[i] for i in order), order


def port_params_sharding(shapes: Mapping[str, Sequence[int]], mesh,
                         partition: str = "channel", fsdp: bool = False
                         ) -> Dict[str, Spec]:
    """:func:`params_sharding` of the port's flat state dict (names to
    shapes in the port's layout): each shape is taken to JAX's layout, so
    that 'model' lands on a weight's output channels and FSDP's 'data' on
    JAX's choice of the rest, and each spec is brought back to the port's
    dims."""
    jax_shapes = {n: _to_jax_layout(s)[0] for n, s in shapes.items()}
    specs = params_sharding(jax_shapes, mesh, partition, fsdp=fsdp)
    out = {}
    for n, shape in shapes.items():
        _, order = _to_jax_layout(shape)
        spec = list(specs[n]) + [None] * (len(shape) - len(specs[n]))
        port = [None] * len(shape)
        for j, i in enumerate(order):
            port[i] = spec[j]
        out[n] = tuple(port) if any(port) else ()
    return out


def unet_with_tp(net, mesh):
    """Tensor parallelism of the UNet: ``net`` itself on a model axis of 1
    (JAX's no-op); above 1 a ``model_parallel.ModelParallelUNet`` holding
    this rank's output channels of every weight JAX's rule shards
    (activations channel-sharded between layers)."""
    if mesh.shape["model"] <= 1 or mesh.model_size <= 1:  # or left out
        return net
    from .model_parallel import ModelParallelUNet

    return ModelParallelUNet(net, mesh, "channel")


def unet_with_sp(net, mesh):
    """Spatial parallelism of the UNet: ``net`` itself on a model axis of 1
    (JAX's no-op); above 1 a ``model_parallel.ModelParallelUNet`` whose
    activations hold this rank's image rows (parameters whole)."""
    if mesh.shape["model"] <= 1 or mesh.model_size <= 1:
        return net
    from .model_parallel import ModelParallelUNet

    return ModelParallelUNet(net, mesh, "spatial")


def unet_with_model_parallel(net, mesh, partition: str = "channel"):
    """Dispatch the 'model'-axis strategy: "channel" (unet_with_tp) or
    "spatial" (unet_with_sp)."""
    if partition == "channel":
        return unet_with_tp(net, mesh)
    if partition == "spatial":
        return unet_with_sp(net, mesh)
    raise ValueError(f"unknown model partition {partition!r} (channel|spatial)")
