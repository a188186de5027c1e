"""Rank mesh, sharding rules and the activation collectives of the parallel
layouts, port of the JAX package's ``parallel/mesh.py`` on
``torch.distributed``.

One process is one rank and one device. ``make_mesh`` lays the ranks out on
the reference's named axes, in its axis orders and shapes: ``(data,)``,
``(data, model)``, ``(dcn, data)``, ``(dcn, data, model)``, ``(data, pipe)``
and ``(dcn, data, pipe)``. ``Mesh.init_groups`` makes one process group per
line of each axis (and of ``(dcn, data)`` together), the groups the
collectives run over (``parallel.comm``).

What a rank holds (``state_shardings``): a parameter whose spec names
``model`` (the transformer feed-forward pair, Megatron column / row
sharding, and the MoE experts, ``tp_param_spec``) or ``pipe`` (the stacked
``pipe_layers`` rows of a pipeline stage) is cut along that dim, and the
rank keeps its chunk (``shard_model_``); every other parameter is
replicated. Inside ``activation_mesh`` the model is the rank's shard. With
``zero_optimizer`` each data rank also owns one chunk of the optimizer state
of a leaf, on the leaf's first dim that is unsharded and divides over
``data`` (``zero_extend_spec``); ``pipe_layers`` never, and ``dcn`` never.

The reference's activation sharding constraints become explicit autograd
collectives over ``model``, each an exact no-op without an active mesh with a
``model`` axis:

- ``seq_sharded_constraint``: this rank's chunk of T (all-gather backward);
- ``seq_gathered_constraint``: all-gather along T for a replicated consumer
  (backward: this rank's chunk of the full gradient);
- ``expert_sharded_constraint``: this rank's E/M experts of an ``[E, C, H]``
  buffer (all-gather backward), and ``expert_gathered_constraint``, the
  all-gather that rebuilds the buffer (backward: this rank's experts);
- ``copy_to_model`` / ``reduce_from_model`` (Megatron's f and g),
  ``gather_for_partial`` (all-gather, reduce-scatter backward) and
  ``reduce_scatter_seq`` (reduce-scatter, all-gather backward), which
  ``parallel.tp_kernels`` composes around the feed-forward kernel pair;
- ``reduce_from_batch``: a sum over the (dcn, data) ranks whose backward is
  the identity (the MoE's global routing statistics), and
  ``sum_over_batch``, whose backward sums too (BatchNorm's statistics of the
  global batch, a synchronised BatchNorm).

The gradient of a replicated parameter is whole on every model rank, as in
Megatron, except for those that a sequence-parallel region uses on its chunk
of T (the LayerNorms, the out-projection, linear2's bias): those carry
``param.sequence_parallel = True`` and their gradients are summed over
``model`` (``Trainer``).

``_slice_grouped`` keeps the given rank order: the reference orders its
devices by ``slice_index`` and keeps the given order on a mesh whose devices
carry none, which is the port's case (a rank has no slice index), so the
``dcn`` axis is the leading block of ranks.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import socket
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"
PIPE_AXIS = "pipe"
BATCH_AXES = (DCN_AXIS, DATA_AXIS)

Spec = Tuple[Optional[str], ...]


class Mesh:
    """Ranks on named axes (the reference's ``jax.sharding.Mesh``):
    ``devices`` is the numpy grid of global ranks, ``shape`` axis -> size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"grid {self.devices.shape} does not match axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``rank``'s index on each axis (this process's rank by default)."""
        rank = _world_rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not on the mesh {self.devices.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """This rank's position in the line along ``axes`` (row-major over
        them in mesh order): for (dcn, data), the batch shard it owns."""
        c = self.coords(rank)
        i = 0
        for a in self.axis_names:
            if a in axes:
                i = i * self.shape[a] + c[a]
        return i

    def count(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names if a in axes] or [1]))

    def lines(self, axes: Sequence[str]):
        """Every group of ranks that differ only on ``axes`` (in mesh order)."""
        axes = [a for a in self.axis_names if a in axes]
        rest = [a for a in self.axis_names if a not in axes]
        grid = np.transpose(self.devices, [self.axis_names.index(a) for a in rest + axes])
        return [list(map(int, row)) for row in grid.reshape(-1, self.count(axes))]

    def init_groups(self) -> "Mesh":
        """Make the process groups of every single axis and of (dcn, data).
        Collective over the world: every rank calls it once, in one order."""
        keys = [(a,) for a in self.axis_names]
        if DCN_AXIS in self.axis_names:
            keys.append(BATCH_AXES)
        me = _world_rank()
        for key in keys:
            for ranks in self.lines(key):
                group = comm.new_group(ranks) if len(ranks) > 1 else None
                if me in ranks:
                    self._groups[key] = group
        return self

    def group(self, axes) -> Optional[object]:
        """The process group of this rank's line along ``axes`` (None for a
        line of one rank or an axis the mesh does not have)."""
        key = tuple(a for a in self.axis_names if a in ((axes,) if isinstance(axes, str) else axes))
        if not key or self.count(key) == 1:
            return None
        if key not in self._groups:
            raise RuntimeError(f"no process group for {key}: call init_groups() first")
        return self._groups[key]

    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in BATCH_AXES if a in self.axis_names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# ---- the active mesh ------------------------------------------------------------

_ACTIVATION_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "msfa_torch_activation_mesh", default=None)


@contextlib.contextmanager
def activation_mesh(mesh: Optional[Mesh]):
    """Publish ``mesh`` for the block: the layers read it at call time and
    run their collectives over it; the model inside is the rank's shard."""
    token = _ACTIVATION_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVATION_MESH.reset(token)


def current_activation_mesh() -> Optional[Mesh]:
    return _ACTIVATION_MESH.get()


def model_group():
    """(group, index, size) of this rank on the active mesh's ``model``
    axis, or None without one."""
    mesh = current_activation_mesh()
    if mesh is None or mesh.axis_size(MODEL_AXIS) <= 1:
        return None
    return mesh.group(MODEL_AXIS), mesh.coords()[MODEL_AXIS], mesh.axis_size(MODEL_AXIS)


def _chunk(x: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    if x.shape[dim] % count:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {count} ranks")
    return x.chunk(count, dim=dim)[index]


# ---- autograd collectives over 'model' -------------------------------------------


class _Split(torch.autograd.Function):
    """Forward: this rank's chunk of ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group, index, count):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, index, count).contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.dim, ctx.group), None, None, None, None


class _Gather(torch.autograd.Function):
    """Forward: all-gather along ``dim``; backward: this rank's chunk of the
    gradient (``partial`` False: the consumer is replicated, its gradient
    whole on every rank) or the reduce-scatter of it (``partial`` True: each
    rank's consumer holds a part of the gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, index, count, partial):
        ctx.dim, ctx.group, ctx.index, ctx.count, ctx.partial = dim, group, index, count, partial
        return comm.all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = comm.reduce_scatter(g, ctx.dim, ctx.group)
        else:
            g = _chunk(g, ctx.dim, ctx.index, ctx.count).contiguous()
        return g, None, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Forward: reduce-scatter along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return comm.reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    """Forward: sum over the group; backward: the identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Forward: the identity; backward: sum over the group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.clone(), ctx.group), None


def seq_sharded_constraint(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of the time axis of a ``[B, T, H]`` activation
    (Megatron sequence parallelism's norm region); backward all-gathers.
    No-op without an active ``model`` axis."""
    m = model_group()
    return x if m is None else _Split.apply(x, dim, m[0], m[1], m[2])


def seq_gathered_constraint(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """All-gather of a sequence-sharded activation along T for a consumer
    that every model rank computes whole (the replicated attention, the
    pooling); backward keeps this rank's chunk. No-op without a ``model`` axis."""
    m = model_group()
    return x if m is None else _Gather.apply(x, dim, m[0], m[1], m[2], False)


def gather_for_partial(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """All-gather along T for a consumer split over ``model`` (the
    column-parallel feed-forward): backward reduce-scatters the ranks' parts."""
    m = model_group()
    return x if m is None else _Gather.apply(x, dim, m[0], m[1], m[2], True)


def reduce_scatter_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Sum of the model ranks' partial ``[B, T, H]`` outputs, this rank's
    chunk of T (the row-parallel product's exit under sequence
    parallelism); backward all-gathers."""
    m = model_group()
    return x if m is None else _ReduceScatter.apply(x, dim, m[0])


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """A replicated input entering a computation split over ``model``:
    the identity forward, the ranks' gradient parts summed backward."""
    m = model_group()
    return x if m is None else _Copy.apply(x, m[0])


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Partial sums of the model ranks added up; the identity backward."""
    m = model_group()
    return x if m is None else _AllReduce.apply(x, m[0])


def expert_sharded_constraint(x: torch.Tensor, num_experts: int) -> torch.Tensor:
    """This rank's ``E / M`` experts of an ``[E, C, H]`` buffer (expert
    parallelism over ``model``); backward all-gathers. No-op without a
    ``model`` axis."""
    m = model_group()
    if m is None:
        return x
    if num_experts % m[2]:
        raise ValueError(f"model.moe_experts ({num_experts}) must divide evenly over "
                         f"parallel.model_parallel ({m[2]}) for expert parallelism")
    return _Split.apply(x, 0, m[0], m[1], m[2])


def expert_gathered_constraint(x: torch.Tensor) -> torch.Tensor:
    """The all-gather of every rank's experts' outputs ``[E/M, C, H]`` into
    ``[E, C, H]`` for the replicated combine; backward keeps this rank's
    experts."""
    m = model_group()
    return x if m is None else _Gather.apply(x, 0, m[0], m[1], m[2], False)


def reduce_from_batch(x: torch.Tensor) -> torch.Tensor:
    """Sum over the active mesh's (dcn, data) ranks with the identity
    backward: a statistic of the global batch from each rank's rows, whose
    gradient each rank takes for its own rows (the Trainer sums the
    gradients over those ranks). No-op without a mesh."""
    mesh = current_activation_mesh()
    if mesh is None or mesh.count(mesh.batch_axes()) == 1:
        return x
    return _AllReduce.apply(x, mesh.group(mesh.batch_axes()))


class _AllReduceBoth(torch.autograd.Function):
    """Forward and backward: sum over the group (a statistic that every
    rank's loss reads, of every rank's rows)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.clone(), ctx.group), None


def batch_ranks() -> int:
    """The (dcn, data) ranks of the active mesh (1 without one)."""
    mesh = current_activation_mesh()
    return 1 if mesh is None else mesh.count(mesh.batch_axes())


def sum_over_batch(x: torch.Tensor) -> torch.Tensor:
    """Sum over the active mesh's (dcn, data) ranks, backward too: batch
    statistics of the global batch (BatchNorm), which every rank's part of
    the loss reads. No-op without a mesh."""
    if batch_ranks() == 1:
        return x
    mesh = current_activation_mesh()
    return _AllReduceBoth.apply(x, mesh.group(mesh.batch_axes()))


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every (dcn, data) rank's rows of ``x`` (no gradient) in global order."""
    mesh = current_activation_mesh()
    if mesh is None:
        return x
    return comm.all_gather(x, 0, mesh.group(mesh.batch_axes()))


# ---- runtime and mesh ---------------------------------------------------------------

_DISTRIBUTED_INITIALIZED = False


def _rendezvous(address: str, world: int, rank: int):
    """The world's store at ``address`` (``host:port``, ``tcp://`` optional;
    rank 0 serves it) and every rank's host name, which each rank posts
    there: ``(store, hosts)``."""
    scheme, sep, rest = address.rpartition("://")
    if sep and scheme != "tcp":
        raise ValueError(f"parallel.coordinator_address takes host:port; got {address!r}")
    host, _, port = rest.rpartition(":")
    store = dist.TCPStore(host.strip("[]"), int(port), world, is_master=rank == 0)
    store.set(f"host/{rank}", socket.gethostname())
    return store, [store.get(f"host/{r}").decode() for r in range(world)]


def maybe_initialize_distributed(par_cfg, device=None) -> bool:
    """``parallel.coordinator_address: "host:port"`` makes this process one
    rank of a ``torch.distributed`` world: ``init_process_group`` over a
    TCP store there, ``num_processes`` ranks, this one ``process_id``
    (``WORLD_SIZE`` / ``RANK`` from the environment where the keys are
    unset, as a launcher sets them).

    Each rank posts its host name to the store, so a rank knows its local
    rank and how many ranks share its host (``comm.local_ranks``). The
    backend follows from ``device`` and that count (``comm.choose_backend``):
    NCCL where each rank of the host has a card of its own, and then rank
    ``local`` takes card ``local``; on CUDA with more ranks than cards on
    the host, gloo over CUDA tensors, ranks sharing the cards in turn
    (``local % device_count``); gloo on the CPU.

    No-op (returns False) without a coordinator address; idempotent across
    Trainers in one process and against a world that the caller already
    started."""
    global _DISTRIBUTED_INITIALIZED
    cfg = par_cfg or {}
    coord = cfg.get("coordinator_address")
    if not coord:
        return False
    if _DISTRIBUTED_INITIALIZED or dist.is_initialized():
        _DISTRIBUTED_INITIALIZED = True
        return True
    world = cfg.get("num_processes")
    rank = cfg.get("process_id")
    world = int(world if world is not None else os.environ.get("WORLD_SIZE", 0))
    rank = int(rank if rank is not None else os.environ.get("RANK", -1))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(
            "parallel.coordinator_address needs parallel.num_processes and parallel.process_id "
            f"(or WORLD_SIZE and RANK); got {world} processes, process {rank}")
    store, hosts = _rendezvous(str(coord), world, rank)
    local, local_world = comm.local_ranks(hosts, rank)
    device = torch.device("cpu" if device is None else device)
    backend = comm.choose_backend(device, local_world)
    if device.type == "cuda":  # gloo here: more ranks than cards, which they share
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.PrefixStore("world", store),
                            world_size=world, rank=rank)
    _DISTRIBUTED_INITIALIZED = True
    return True


def make_mesh(
    num_devices: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    axis_name: str = DATA_AXIS,
    model_parallel: int = 1,
    dcn_slices: int = 1,
    pipeline_parallel: int = 1,
) -> Mesh:
    """Mesh over the first ``num_devices`` ranks (``devices``: global ranks,
    default the world's). The reference's axis orders and shapes:
    ``(data,)``; ``(data, model)`` of shape ``(n // M, M)``; ``dcn_slices=K``
    a leading ``dcn`` axis; ``pipeline_parallel=P`` a trailing ``pipe``
    axis. Its ``ValueError``s for too few ranks, pipe with model, and a
    product that does not divide the count."""
    if devices is None:
        devices = list(range(_world_size()))
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"Requested {num_devices} devices but only {len(devices)} available")
        devices = list(devices)[:num_devices]
    model_parallel = int(model_parallel or 1)
    dcn_slices = int(dcn_slices or 1)
    pipeline_parallel = int(pipeline_parallel or 1)
    if pipeline_parallel > 1 and model_parallel > 1:
        raise ValueError(
            "pipeline_parallel and model_parallel cannot be combined "
            "(the pipelined layer stack runs under a shard_map that is "
            "manual over 'pipe' only)")
    n = len(devices)
    if n % (model_parallel * dcn_slices * pipeline_parallel):
        raise ValueError(
            f"model_parallel={model_parallel} x dcn_slices={dcn_slices} "
            f"x pipeline_parallel={pipeline_parallel} "
            f"must divide the device count ({n})")
    grid = np.array(_slice_grouped(devices, dcn_slices) if dcn_slices > 1 else list(devices))
    if pipeline_parallel > 1:
        data = n // (dcn_slices * pipeline_parallel)
        if dcn_slices > 1:
            return Mesh(grid.reshape(dcn_slices, data, pipeline_parallel),
                        (DCN_AXIS, axis_name, PIPE_AXIS))
        return Mesh(grid.reshape(data, pipeline_parallel), (axis_name, PIPE_AXIS))
    data = n // (model_parallel * dcn_slices)
    if dcn_slices > 1 and model_parallel > 1:
        return Mesh(grid.reshape(dcn_slices, data, model_parallel),
                    (DCN_AXIS, axis_name, MODEL_AXIS))
    if dcn_slices > 1:
        return Mesh(grid.reshape(dcn_slices, data), (DCN_AXIS, axis_name))
    if model_parallel > 1:
        return Mesh(grid.reshape(data, model_parallel), (axis_name, MODEL_AXIS))
    return Mesh(grid, (axis_name,))


def _slice_grouped(devices, dcn_slices: int):
    """The given order: a rank carries no slice index, the case in which the
    reference keeps its order too (the ``dcn`` axis is then the leading
    block of ranks)."""
    return list(devices)


# ---- sharding rules ---------------------------------------------------------------------


def tp_param_spec(path_names: Sequence[str]) -> Spec:
    """Tensor-parallel spec of a port parameter (or optimizer leaf) by its
    name parts, the reference's rule on the port's layouts: ``linear1``
    ``weight [F, H]`` -> ``(model, None)`` (the reference's kernel ``[H, F]``
    at ``P(None, model)``), its ``bias [F]`` -> ``(model,)``; ``linear2``
    ``weight [H, F]`` -> ``(None, model)`` (rows of the reference's ``[F, H]``
    kernel), its bias replicated; the MoE experts ``moe_w1`` / ``moe_w2``
    ``(model, None, None)``, ``moe_b1`` / ``moe_b2`` ``(model, None)`` (expert
    parallelism); a ``kernel`` leaf (the reference's ``[in, out]`` layout, as
    the stacked ``pipe_layers`` keep it) takes the reference's spec as it is;
    everything else replicated, ``()``."""
    names = [str(n) for n in path_names]
    leaf = names[-1]
    if leaf in ("moe_w1", "moe_w2"):
        return (MODEL_AXIS, None, None)
    if leaf in ("moe_b1", "moe_b2"):
        return (MODEL_AXIS, None)
    owner = names[-2] if len(names) > 1 else ""
    if owner == "linear1":
        if leaf == "weight":
            return (MODEL_AXIS, None)
        if leaf == "kernel":  # a leaf in the reference's [in, out] layout
            return (None, MODEL_AXIS)
        if leaf == "bias":
            return (MODEL_AXIS,)
    if owner == "linear2":
        if leaf == "weight":
            return (None, MODEL_AXIS)
        if leaf == "kernel":
            return (MODEL_AXIS, None)
    return ()


def zero_extend_spec(spec: Spec, shape, n_data: int) -> Spec:
    """``spec`` with ``data`` on the first dim that is unsharded and whose
    size divides by ``n_data`` (ZeRO-1); ``spec`` itself when none does."""
    ndim = len(shape)
    entries = list(spec) + [None] * (ndim - len(spec))
    for i in range(ndim):
        if entries[i] is None and shape[i] % n_data == 0 and shape[i] >= n_data:
            entries[i] = DATA_AXIS
            while entries and entries[-1] is None:
                entries.pop()
            return tuple(entries)
    return tuple(spec)


def is_pipe_leaf(name: str) -> bool:
    return "pipe_layers" in name.split(".")


def state_shardings(mesh: Mesh, shapes: Mapping[str, Sequence[int]],
                    zero_optimizer: bool = False) -> Dict[str, Tuple[Spec, Spec]]:
    """``name -> (param spec, optimizer-state spec)`` for full (global)
    parameter shapes: what each rank holds. The tensor-parallel rule on a
    mesh with ``model``; ``pipe_layers`` leaves ``(pipe,)`` on their layer
    dim on a mesh with ``pipe``; with ``zero_optimizer`` the optimizer state
    of every leaf but ``pipe_layers`` ZeRO-extended over ``data`` (never
    ``dcn``). A spec longer than the leaf's rank is replicated."""
    has_model = MODEL_AXIS in mesh.axis_names
    has_pipe = PIPE_AXIS in mesh.axis_names
    zero_n = mesh.axis_size(DATA_AXIS) if zero_optimizer else 0
    out = {}
    for name, shape in shapes.items():
        pipe_leaf = has_pipe and is_pipe_leaf(name)
        if pipe_leaf:
            spec: Spec = (PIPE_AXIS,)
        else:
            spec = tp_param_spec(name.split(".")) if has_model else ()
        if len(spec) > len(shape):
            spec = ()
        opt = spec
        if zero_n > 1 and not pipe_leaf:
            if name.endswith(".weight") and len(shape) >= 2:
                # stored with its dims reversed from the reference's kernel
                # (convert.py): ZeRO takes the dim the reference takes
                full = list(spec) + [None] * (len(shape) - len(spec))
                opt = zero_extend_spec(tuple(full[::-1]), tuple(shape)[::-1], zero_n)
                opt = tuple((list(opt) + [None] * (len(shape) - len(opt)))[::-1])
            else:
                opt = zero_extend_spec(spec, shape, zero_n)
        out[name] = (spec, opt)
    return out


def local_slice(full: torch.Tensor, spec: Spec, mesh: Mesh, rank: Optional[int] = None):
    """This rank's piece of a full tensor under ``spec``."""
    c = mesh.coords(rank)
    out = full
    for dim, axis in enumerate(spec):
        if axis is not None:
            out = _chunk(out, dim, c[axis], mesh.shape[axis])
    return out


def gather_full(local: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's piece under ``spec`` (collective
    over the spec's axes; every rank of those lines must call it)."""
    out = local.detach()
    for dim, axis in reversed(list(enumerate(spec))):
        if axis is not None:
            out = comm.all_gather(out, dim, mesh.group(axis))
    return out


def replicas(spec: Spec, mesh: Mesh) -> int:
    """How many ranks hold the same piece of a leaf under ``spec``."""
    return mesh.size // mesh.count([a for a in spec if a is not None])


def resolve_num_devices(requested) -> int:
    """``parallel.num_devices`` -> a rank count: ``auto`` is the world size,
    null / falsy one device (no mesh), else the number."""
    if requested in (None, False, "", "none", "null"):
        return 1
    if isinstance(requested, str) and requested.lower() == "auto":
        return _world_size()
    return int(requested)


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> Spec:
    """The batch dim over (dcn, data) jointly where the mesh has dcn."""
    if DCN_AXIS in mesh.axis_names:
        return ((DCN_AXIS, axis_name),)
    return (axis_name,)


def shard_batch(batch, mesh: Mesh, axis_name: str = DATA_AXIS, rank: Optional[int] = None):
    """This rank's rows of every tensor (or array) of a batch tree: block
    ``i`` of ``n`` of the leading dim, ``i`` the rank's (dcn, data) index."""
    axes = [a for a in (DCN_AXIS, axis_name) if a in mesh.axis_names]
    n, i = mesh.count(axes), mesh.index(axes, rank)

    def one(x):
        if x is None:
            return None
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not divide over {n} ranks")
        size = x.shape[0] // n
        return x[i * size:(i + 1) * size]

    if isinstance(batch, Mapping):
        return {k: shard_batch(v, mesh, axis_name, rank) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis_name, rank) for v in batch)
    return one(batch)
