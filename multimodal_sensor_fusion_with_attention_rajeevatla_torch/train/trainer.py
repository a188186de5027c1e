"""Training runtime: port of the JAX package's ``train/trainer.py`` (schedule,
optimizer, augmentations, the per-batch step and ``fit``).

- ``lr_schedule``: per-epoch cosine (``eta_min = lr / 100``), StepLR(30, 0.1)
  or constant, read at the optimizer's inner update count.
- ``AccumulatedAdamW``: what ``optax.MultiSteps(chain(clip_by_global_norm,
  adamw), k)`` does, written out: gradients averaged over ``k`` micro-steps
  (running mean, as optax), then clip and AdamW (b1 0.9, b2 0.999, eps 1e-8,
  bias correction, decoupled decay on every parameter) on the k-th only.
- ``apply_temporal_jitter``, ``add_gaussian_noise``,
  ``dropout_modality_mask``: the on-device augmentations, each taking its
  random draws as tensors so that a test can hand the same draws to both
  frameworks.
- ``Trainer``: builds the model and the optimizer from the config and makes
  the train step: on-device gather, augmentation, forward in train mode
  (BatchNorm running statistics, where the model has them, move on every
  micro-step, as the reference's ``mutable=["batch_stats"]`` does),
  label-smoothed loss, backward, optimizer. Every random draw of a step
  comes from one ``torch.Generator`` on the device, in a fixed order.
  ``fit`` trains whole epochs over a device-resident split (a Python loop
  of micro-steps where the reference compiles a scan) or, with
  ``dataset.streaming``, over batches streamed from the host one ahead of
  the step (``data.device.StreamingDeviceLoader``; the train split is never
  put on the card whole), early-stops on the
  label-smoothed val loss with the reference's patience semantics, keeps
  top-k and ``last`` checkpoints (``train/checkpoint.py``), scores the best
  checkpoint on test and writes ``results.json`` with the reference's keys.
  ``resume_from`` restores weights, optimizer and generator from a ``last``
  checkpoint, so a resumed run repeats an uninterrupted one.

A model with MoE layers (``model.moe_experts``) reports their load-balance
aux losses, and the loss of a micro-step adds ``training.moe_aux_weight``
times their sum, as the reference's does. ``training.remat`` runs the
micro-step's whole forward under ``torch.utils.checkpoint`` (non-reentrant),
the unit the reference wraps in ``jax.checkpoint``: the backward recomputes
it, with the trainer's generator put back to its state before the forward
(so the recompute draws the same masks and kernel seeds) and the BatchNorm
running statistics left as the first forward moved them; the aux losses are
outputs of the recomputed function. Loss and gradients are those of the run
without it, bit for bit, and every forward kernel launches twice a
micro-step.

The streamed and the resident epoch take the same shuffle order and draw
the same numbers from the generator in the same order, so they give the same
losses and weights bit for bit where no layer mixes the rows of a batch: the
last batch's padding rows (weight 0) are window 0 in ``BatchLoader``'s batch
and the epoch order wrapped around in the resident index matrix, which only
BatchNorm statistics and MoE capacity can see.

The parallel layouts (``parallel/``): with ``parallel.num_devices`` above
one, each process is one rank of a ``torch.distributed`` world (started from
``parallel.coordinator_address`` before the model is built,
``maybe_initialize_distributed``, or by the caller), and the mesh is built on
first use (``_ensure_mesh``): data, tensor and sequence parallelism over
``model``, expert parallelism, the GPipe pipeline over ``pipe``, ``dcn``
slices and ZeRO-1, as the reference's ``parallel.*`` keys say, with its
``ValueError``s (``check_layout``). Every rank builds the same model from the
seed and keeps its shard of it (``parallel.mesh.state_shardings``). A step
takes a global batch and each rank its rows of it; the loss is the mean over
the global batch; the accumulated gradients are summed over (dcn, data) after
accumulation (with ZeRO reduce-scattered into each data rank's slice of the
optimizer state every micro-step, the updated slices all-gathered); the
gradients of the parameters that sequence parallelism uses on a chunk of T
are summed over ``model``; the clip's norm is that of the whole gradient.
Each (dcn, data) rank draws its own dropout masks and augmentations from a
generator seeded for its index (``rank_generator``: a rank-distinct Philox
offset on the card, a rank-distinct seed on the CPU), so the masks cannot
match the reference's one global draw; the model and pipe ranks of one data
rank draw alike. Rank 0 alone logs and writes ``results.json``; a checkpoint
holds the gathered state in the one-process format.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from ..convert import gather_state_dict, scatter_state_dict
from ..data.dataset import BatchLoader, WindowedSplit, padded_index_matrix
from ..data.device import DeviceSplit, StreamingDeviceLoader
from ..models.encoders import running_stats_frozen
from ..models.module import MultimodalFusionModel
from ..ops.metrics import cross_entropy_loss, weighted_accuracy
from ..parallel import comm
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    activation_mesh,
    gather_full,
    local_slice,
    make_mesh,
    maybe_initialize_distributed,
    replicas,
    resolve_num_devices,
    shard_batch,
    state_shardings,
)
from ..utils.device import resolve_device
from .checkpoint import CheckpointManager, _is_primary, load_checkpoint, load_train_state


def lr_schedule(
    scheduler: str, learning_rate: float, max_epochs: int, updates_per_epoch: int
) -> Callable[[int], float]:
    """Per-epoch learning rate as a function of the update count.

    cosine: ``CosineAnnealingLR(T_max=max_epochs, eta_min=lr/100)`` at the
    epoch index (clipped to ``max_epochs``); step: ``StepLR(30, 0.1)``;
    anything else: constant.
    """
    updates_per_epoch = max(1, updates_per_epoch)

    def schedule(count: int) -> float:
        epoch = float(min(count // updates_per_epoch, max_epochs))
        if scheduler == "cosine":
            eta_min = learning_rate / 100.0
            return eta_min + 0.5 * (learning_rate - eta_min) * (
                1.0 + math.cos(math.pi * epoch / max(max_epochs, 1))
            )
        if scheduler == "step":
            return learning_rate * 0.1 ** math.floor(epoch / 30.0)
        return learning_rate

    return schedule


class ShardLayout:
    """What the optimizer does across ranks for each parameter of a sharded
    model (``Trainer._ensure_mesh``): the groups it sums over, the parameter
    and optimizer-state specs of ``parallel.mesh.state_shardings``, the ZeRO
    dim (where the optimizer state is cut over ``data``) and whether the
    gradient is a partial sum over ``model`` (``param.sequence_parallel``)."""

    def __init__(self, mesh: Mesh, params: List[torch.Tensor], specs: List[Tuple]):
        self.mesh = mesh
        self.batch_group = mesh.group(mesh.batch_axes())
        self.data_group = mesh.group(DATA_AXIS)
        self.dcn_group = mesh.group("dcn")
        self.model_group = mesh.group(MODEL_AXIS)
        self.specs = specs  # (param spec, optimizer-state spec) per parameter
        self.partial = [bool(getattr(p, "sequence_parallel", False)) and
                        self.model_group is not None for p in params]
        self.zero_dim = []
        for pspec, ospec in specs:
            pad = list(pspec) + [None] * (len(ospec) - len(pspec))
            self.zero_dim.append(next((d for d, (a, b) in enumerate(zip(pad, ospec))
                                       if b == DATA_AXIS and a != DATA_AXIS), None))
        self.zero = any(d is not None for d in self.zero_dim)
        self.data_index = mesh.coords().get(DATA_AXIS, 0)
        self.n_data = mesh.axis_size(DATA_AXIS)
        self.replicas = [replicas(ospec, mesh) for _pspec, ospec in specs]

    def piece(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This data rank's ZeRO piece of parameter ``i``'s local tensor (a
        view; the tensor itself where its state is not cut)."""
        dim = self.zero_dim[i]
        return t if dim is None else t.chunk(self.n_data, dim)[self.data_index]

    def scatter(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """A micro-step's gradients summed over (dcn, data), this data rank's
        ZeRO piece of each: the cut leaves in one reduce-scatter over data
        (every rank's pieces laid out one after the other) and one
        all-reduce over dcn, the rest in one all-reduce over (dcn, data)."""
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        cut = [i for i, d in enumerate(self.zero_dim) if d is not None]
        rest = [i for i, d in enumerate(self.zero_dim) if d is None]
        if cut:
            pieces = [[grads[i].chunk(self.n_data, self.zero_dim[i])[r] for i in cut]
                      for r in range(self.n_data)]
            flat = torch.cat([t.reshape(-1) for rank in pieces for t in rank])
            mine = comm.all_reduce(comm.reduce_scatter(flat, 0, self.data_group),
                                   self.dcn_group)
            offset = 0
            for i, like in zip(cut, pieces[self.data_index]):
                out[i] = mine[offset:offset + like.numel()].view(like.shape)
                offset += like.numel()
        kept = [grads[i].clone() for i in rest]
        _flat_all_reduce(kept, self.batch_group)
        for i, g in zip(rest, kept):
            out[i] = g
        return out

    def finish(self, acc: List[torch.Tensor]) -> None:
        """The accumulated gradients whole: summed over (dcn, data) where the
        micro-steps did not already, and over ``model`` where partial."""
        if not self.zero:
            _flat_all_reduce(acc, self.batch_group)
        _flat_all_reduce([a for a, part in zip(acc, self.partial) if part], self.model_group)

    def sq_norm(self, acc: List[torch.Tensor]) -> torch.Tensor:
        """The squared global norm of the gradient: each piece counted once
        over the world (its sum divided by the ranks that hold it)."""
        sq = sum(a.float().square().sum() / r for a, r in zip(acc, self.replicas))
        return comm.all_reduce(sq, dist.group.WORLD)

    def gather_params(self, params: List[torch.Tensor]) -> None:
        """Each ZeRO-cut parameter whole again from the data ranks' pieces."""
        for i, p in enumerate(params):
            dim = self.zero_dim[i]
            if dim is not None:
                p.copy_(comm.all_gather(self.piece(i, p).contiguous(), dim, self.data_group))


def _flat_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """One sum over ``group`` of every tensor (concatenated), in place."""
    if not tensors or comm.group_size(group) == 1:
        return
    flat = comm.all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


class AccumulatedAdamW:
    """Clip + AdamW (or Adam with coupled L2) behind gradient accumulation.

    ``step(grads)`` takes one micro-step's gradients; every ``accum``-th call
    it clips the accumulated mean by its global norm, runs the Adam update
    with the schedule read at the inner count (before it is incremented),
    applies it to the parameters in place and returns True. State is plain
    tensors on the parameters' device; nothing synchronises with the host.

    With a ``layout`` (a sharded model's ``ShardLayout``) the gradients are
    this rank's part: summed over (dcn, data) after accumulation, or with
    ZeRO reduce-scattered every micro-step into this data rank's pieces of
    ``acc``, ``mu`` and ``nu``, whose update is all-gathered into the
    parameters; the clip's norm is the whole gradient's.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        schedule: Callable[[int], float],
        weight_decay: float = 0.0,
        clip_norm: float = 0.0,
        accum: int = 1,
        decoupled: bool = True,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        layout: Optional[ShardLayout] = None,
    ):
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.accum = max(1, int(accum))
        self.decoupled = decoupled
        self.b1, self.b2, self.eps = b1, b2, eps
        self.layout = layout
        self.acc = [torch.zeros_like(self._piece(i, p)) for i, p in enumerate(self.params)]
        self.mu = [torch.zeros_like(a) for a in self.acc]
        self.nu = [torch.zeros_like(a) for a in self.acc]
        self.mini_step = 0
        self.count = 0  # inner (applied) updates

    def _piece(self, i: int, t: torch.Tensor) -> torch.Tensor:
        return t if self.layout is None else self.layout.piece(i, t)

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> bool:
        n = self.mini_step
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        if self.layout is not None and self.layout.zero:
            grads = self.layout.scatter(grads)
        for acc, g in zip(self.acc, grads):
            acc.add_((g - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.accum:
            return False
        self.mini_step = 0
        if self.layout is not None:
            self.layout.finish(self.acc)
        self.apply()
        return True

    @torch.no_grad()
    def apply(self) -> None:
        """The update from ``acc``, the accumulated gradient whole (this
        rank's pieces of it): clip, Adam, then ``acc`` back to zero."""
        zero = self.layout is not None and self.layout.zero
        updates = self.acc
        if self.clip_norm > 0:
            if self.layout is None:
                norm = torch.sqrt(sum(u.square().sum() for u in updates))
            else:
                norm = torch.sqrt(self.layout.sq_norm(updates))
            updates = [torch.where(norm < self.clip_norm, u, (u / norm) * self.clip_norm)
                       for u in updates]
        pieces = [self._piece(i, p) for i, p in enumerate(self.params)]
        if not self.decoupled and self.weight_decay:
            updates = [u + self.weight_decay * p for u, p in zip(updates, pieces)]
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        for p, u, mu, nu in zip(pieces, updates, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * u)
            nu.mul_(self.b2).add_((1.0 - self.b2) * u * u)
            step = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.decoupled and self.weight_decay:
                step = step + self.weight_decay * p
            p.add_(step * -lr)
        if zero:
            self.layout.gather_params(self.params)
        for acc in self.acc:
            acc.zero_()

    def state_dict(self) -> Dict[str, Any]:
        """Accumulator, moments and both counters (what a resume needs):
        this rank's pieces (``Trainer.train_state`` gathers them)."""
        return {"acc": list(self.acc), "mu": list(self.mu), "nu": list(self.nu),
                "mini_step": self.mini_step, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for name in ("acc", "mu", "nu"):
            own = getattr(self, name)
            if len(own) != len(state[name]):
                raise ValueError(f"optimizer state has {len(state[name])} {name} tensors, "
                                 f"the model {len(own)} parameters")
            for dst, src in zip(own, state[name]):
                dst.copy_(src)
        self.mini_step, self.count = int(state["mini_step"]), int(state["count"])


def build_optimizer(
    training_cfg, params: Iterable[torch.Tensor], steps_per_epoch: int,
    layout: Optional[ShardLayout] = None,
) -> Tuple[AccumulatedAdamW, int]:
    """Optimizer from the ``training:`` config block -> ``(optimizer, accum)``."""
    name = str(training_cfg.get("optimizer", "adamw"))
    if name not in ("adamw", "adam"):
        raise ValueError(f"Unknown optimizer: {name}")
    accum = int(training_cfg.get("gradient_accumulation", 1) or 1)
    schedule = lr_schedule(
        str(training_cfg.get("scheduler", "none")),
        float(training_cfg.get("learning_rate", 1e-3)),
        int(training_cfg.get("max_epochs", 1)),
        max(1, steps_per_epoch // max(1, accum)),
    )
    opt = AccumulatedAdamW(
        params,
        schedule,
        weight_decay=float(training_cfg.get("weight_decay", 0.0)),
        clip_norm=float(training_cfg.get("gradient_clip_norm", 0.0) or 0.0),
        accum=accum,
        decoupled=name == "adamw",
        layout=layout,
    )
    return opt, accum


def apply_temporal_jitter(
    features: Dict[str, torch.Tensor],
    lengths: Optional[torch.Tensor],
    uniform: torch.Tensor,  # [B] draws in [0, 1)
    jitter: float,
):
    """Per-sample circular shift of up to ``jitter * T`` steps, each modality
    in its own timebase, and lengths shrunk by the shift in the first
    modality's timebase (never below 1)."""
    first = next(iter(features.values()))
    batch, ref_len = first.shape[0], first.shape[1]
    if int(jitter * ref_len) <= 0:
        return features, lengths
    frac = uniform * jitter

    def roll(x):
        if x.dim() < 3:
            return x
        t = x.shape[1]
        shift = torch.floor(frac * t).to(torch.int64)
        idx = (torch.arange(t, device=x.device)[None, :] + shift[:, None]) % t
        return x.gather(1, idx.view(batch, t, *[1] * (x.dim() - 2)).expand_as(x))

    jittered = {m: roll(v) for m, v in features.items()}
    if lengths is None:
        return jittered, None
    ref_shift = torch.floor(frac * ref_len).to(lengths.dtype)
    return jittered, torch.clamp(lengths - ref_shift, min=1)


def add_gaussian_noise(
    features: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor], std: float
) -> Dict[str, torch.Tensor]:
    """``x + std * z`` per modality, ``z`` standard normal draws."""
    return {m: v + std * noise[m] for m, v in features.items()}


def dropout_modality_mask(
    uniform: torch.Tensor,  # [B, M] draws in [0, 1)
    revive: torch.Tensor,  # [B] int draws in [0, M)
    rate: float,
) -> torch.Tensor:
    """Drop each modality with probability ``rate`` but never all of them: a
    row that lost every modality gets back the one ``revive`` names."""
    if rate <= 0:
        return torch.ones_like(uniform)
    keep = (uniform > rate).to(torch.float32)
    revived = torch.nn.functional.one_hot(revive.long(), uniform.shape[1]).to(torch.float32)
    dead = keep.sum(dim=1, keepdim=True) == 0
    return torch.where(dead, revived, keep)


# the reference's training.prng_impl values (JAX train/trainer.py)
PRNG_IMPLS = ("threefry", "rbg", "unsafe_rbg")


def check_layout(config) -> None:
    """The reference trainer's checks of ``parallel.*`` with its messages:
    pipeline with tensor parallelism, sequence parallelism without it, MoE
    experts that do not divide over ``model``, and (for a number of devices
    given as a number; ``auto`` is checked with the mesh) a mesh axis or ZeRO
    on one device. Every default of ``config/base.yaml`` passes.

    ``training.prng_impl`` keeps the reference's ``ValueError`` for a value
    other than ``threefry``, ``rbg`` or ``unsafe_rbg``. The three known
    values are accepted and change nothing: they pick the TPU's random-bit
    generator, and the port's dropout masks come from the Philox kernel, or
    from torch's generator at ``dropout_rng: xla``, whatever the key says
    (the same caveat as ``dropout_rng: auto``)."""
    prng_impl = str(config.training.get("prng_impl", "")).lower() or "threefry"
    if prng_impl not in PRNG_IMPLS:
        raise ValueError(
            f"Unknown training.prng_impl {prng_impl!r}; expected threefry or rbg")
    par = config.get("parallel", {}) or {}
    model_parallel = int(par.get("model_parallel", 1) or 1)
    pipeline_parallel = int(par.get("pipeline_parallel", 1) or 1)
    if pipeline_parallel > 1 and model_parallel > 1:
        raise ValueError(
            "parallel.pipeline_parallel cannot be combined with parallel.model_parallel (the "
            "pipelined stack's shard_map is manual over 'pipe' only)")
    if bool(par.get("sequence_parallel", False)) and model_parallel <= 1:
        raise ValueError(
            "parallel.sequence_parallel requires parallel.model_parallel > 1 (it shards "
            "activations across the tensor-parallel group)")
    moe_experts = int(config.model.get("moe_experts", 0) or 0)
    if moe_experts and model_parallel > 1 and moe_experts % model_parallel:
        raise ValueError(
            f"model.moe_experts ({moe_experts}) must divide evenly over parallel.model_parallel "
            f"({model_parallel}) for expert parallelism")
    requested = par.get("num_devices", 1)
    if not (isinstance(requested, str) and requested.lower() == "auto"):
        _check_one_device(par, resolve_num_devices(requested))


def _check_one_device(par, devices: int) -> None:
    if devices <= 1 and (int(par.get("model_parallel", 1) or 1) > 1
                         or int(par.get("dcn_slices", 1) or 1) > 1
                         or int(par.get("pipeline_parallel", 1) or 1) > 1
                         or bool(par.get("zero_optimizer", False))):
        raise ValueError(
            "parallel.model_parallel / parallel.dcn_slices / parallel.pipeline_parallel / "
            "parallel.zero_optimizer require parallel.num_devices > 1")


def rank_generator(device, seed: int, index: int = 0) -> torch.Generator:
    """The trainer's generator for (dcn, data) rank ``index``: seeded with
    ``seed``; for index > 0 moved to a rank-distinct Philox offset on the
    card (``index * 2**40``), or seeded with a rank-distinct seed on the CPU
    (whose generator has no offset). Index 0 is the one-process generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    if index:
        if g.device.type == "cuda":
            g.set_offset(index << 40)
        else:
            g.manual_seed((seed + index * 0x9E3779B97F4A7C15) & ((1 << 63) - 1))
    return g


def shard_model_(model: torch.nn.Module, mesh: Mesh, specs) -> None:
    """Keep this rank's piece of every parameter whose spec is sharded."""
    with torch.no_grad():
        for name, param in model.named_parameters():
            spec = specs[name][0]
            if any(a is not None for a in spec):
                param.data = local_slice(param.data, spec, mesh).clone()


class Trainer:
    """Config-driven experiment runner on one device (reference ``Trainer``).

    Typical use::

        trainer = Trainer(config)                      # model on the card
        results = trainer.fit(train_windows, val_windows, test_windows)

    or, step by step::

        trainer.init_state(steps_per_epoch)
        step = trainer.make_train_step_fn()
        loss, acc = step(device_split, idx)            # one micro-step
    """

    def __init__(self, config, model: Optional[MultimodalFusionModel] = None, device=None):
        check_layout(config)
        self.config = config
        self.device = resolve_device(device)
        # parallel.coordinator_address: join the world before the model is
        # built; on CUDA the rank's card is then the current device
        if (maybe_initialize_distributed(config.get("parallel", {}), self.device)
                and self.device.type == "cuda" and self.device.index is None):
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model or MultimodalFusionModel.from_config(config, device=self.device)
        training = config.training
        self.label_smoothing = float(training.get("label_smoothing", 0.0))
        self.remat = bool(training.get("remat", False))
        self.moe_aux_weight = float(training.get("moe_aux_weight", 0.01))
        augmentation = training.get("augmentation", {}) or {}
        self.modality_dropout = float(augmentation.get("modality_dropout", 0.0))
        self.gaussian_noise = float(augmentation.get("gaussian_noise", 0.0))
        self.temporal_jitter = float(augmentation.get("temporal_jitter", 0.0))
        self.batch_size = int(config.dataset.get("batch_size", 32))
        self.seed = int(config.get("seed", 42))
        self.generator = rank_generator(self.device, self.seed)
        self.optimizer: Optional[AccumulatedAdamW] = None
        self.accum = 1
        par = config.get("parallel", {}) or {}
        self.par = par
        self.zero_optimizer = bool(par.get("zero_optimizer", False))
        self.pipeline_microbatches = (int(par.get("microbatches", 0) or 0)
                                      or int(par.get("pipeline_parallel", 1) or 1))
        self.mesh: Optional[Mesh] = None
        self.specs: Dict[str, Tuple] = {}

    # -- mesh ------------------------------------------------------------------
    def _ensure_mesh(self) -> Optional[Mesh]:
        """Build the mesh on first use (``parallel.num_devices`` above one):
        the process groups, this rank's shard of the model and its
        generator. Collective: every rank of the world calls it."""
        if self.mesh is not None:
            return self.mesh
        par = self.par
        maybe_initialize_distributed(par, self.device)
        n = resolve_num_devices(par.get("num_devices", 1))
        _check_one_device(par, n)
        if n <= 1:
            return None
        mesh = make_mesh(n, model_parallel=int(par.get("model_parallel", 1) or 1),
                         dcn_slices=int(par.get("dcn_slices", 1) or 1),
                         pipeline_parallel=int(par.get("pipeline_parallel", 1) or 1))
        if mesh.size != comm.group_size(dist.group.WORLD):
            raise ValueError(f"parallel.num_devices={n} but the world has "
                             f"{comm.group_size(dist.group.WORLD)} processes: one rank a device")
        mesh.init_groups()
        shapes = {k: tuple(v.shape) for k, v in self.model.named_parameters()}
        self.specs = state_shardings(mesh, shapes, zero_optimizer=self.zero_optimizer)
        shard_model_(self.model, mesh, self.specs)
        self.generator = rank_generator(self.device, self.seed, mesh.index(mesh.batch_axes()))
        self.mesh = mesh
        return mesh

    @property
    def n_shards(self) -> int:
        """The (dcn, data) ranks the batch is cut over."""
        return 1 if self.mesh is None else self.mesh.count(self.mesh.batch_axes())

    def _effective_batch(self, batch_size: Optional[int] = None) -> int:
        """The batch rounded up so that every (dcn, data) rank gets the same
        number of rows, and, with the pipeline, a number that its
        microbatches divide (pad rows get weight 0)."""
        b = int(batch_size or self.batch_size)
        n = self.n_shards
        if self.mesh is not None and "pipe" in self.mesh.axis_names:
            n *= self.pipeline_microbatches
        return ((b + n - 1) // n) * n

    def _layout_ctx(self):
        return activation_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext()

    def init_state(self, steps_per_epoch: int) -> AccumulatedAdamW:
        """Build the optimizer over the model's parameters (the weights are
        the model's own: seeded at construction or loaded)."""
        mesh = self._ensure_mesh()
        params = dict(self.model.named_parameters())
        layout = None if mesh is None else ShardLayout(
            mesh, list(params.values()), [self.specs[k] for k in params])
        self.optimizer, self.accum = build_optimizer(
            self.config.training, params.values(), steps_per_epoch, layout
        )
        return self.optimizer

    def augment(self, features, lengths, num_mod: int):
        """Jitter, noise and modality dropout, drawn from the trainer's
        generator in that order -> ``(features, lengths, modality_mask)``."""
        g = self.generator
        first = next(iter(features.values()))
        batch, device = first.shape[0], first.device
        if self.temporal_jitter > 0:
            u = torch.rand((batch,), generator=g, device=device)
            features, lengths = apply_temporal_jitter(features, lengths, u, self.temporal_jitter)
        if self.gaussian_noise > 0:
            noise = {m: torch.randn(v.shape, generator=g, device=device) for m, v in features.items()}
            features = add_gaussian_noise(features, noise, self.gaussian_noise)
        if self.modality_dropout > 0:
            u = torch.rand((batch, num_mod), generator=g, device=device)
            revive = torch.randint(0, num_mod, (batch,), generator=g, device=device)
            mask = dropout_modality_mask(u, revive, self.modality_dropout)
        else:
            mask = torch.ones((batch, num_mod), device=device)
        return features, lengths, mask

    def _forward(self, names, mask, lengths, *feature_list):
        """The micro-step's training forward on the features ``names`` ->
        ``(logits, aux_losses)``: the unit ``training.remat`` recomputes."""
        aux: List[torch.Tensor] = []
        features = dict(zip(names, feature_list))
        logits = self.model(features, mask, lengths, train=True, generator=self.generator,
                            aux_losses=aux)
        return logits, aux

    def _remat_contexts(self):
        """``checkpoint``'s ``context_fn``, called as the forward starts: the
        forward runs as it is; the recompute runs from the generator's state
        at that moment (which it restores to its own afterwards) and leaves
        the BatchNorm running statistics as they are."""
        start = self.generator.get_state()

        @contextlib.contextmanager
        def recompute():
            now = self.generator.get_state()
            self.generator.set_state(start)
            try:
                with running_stats_frozen():
                    yield
            finally:
                self.generator.set_state(now)

        return contextlib.nullcontext(), recompute()

    def loss_and_grads(self, features, labels, mask, lengths, weight):
        """Forward in train mode, loss, backward -> ``(loss, acc, grads)``
        with one gradient per ``model.parameters()`` entry. The loss adds
        ``moe_aux_weight`` times the model's aux losses where it reports any."""
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        args = (tuple(features), mask, lengths, *features.values())
        if self.remat:
            logits, aux = torch.utils.checkpoint.checkpoint(
                self._forward, *args, use_reentrant=False, context_fn=self._remat_contexts)
        else:
            logits, aux = self._forward(*args)
        loss = cross_entropy_loss(logits, labels, self.label_smoothing, sample_weight=weight)
        acc = weighted_accuracy(logits.detach(), labels, weight)
        reported = None
        if self.mesh is not None:
            # this rank's part of the global batch's mean: sum(w l) / global sum(w)
            group = self.mesh.group(self.mesh.batch_axes())
            w = weight.float().sum().clamp(min=1.0)
            total = comm.all_reduce(weight.float().sum(), group).clamp(min=1.0)
            loss = loss * (w / total)
            acc = comm.all_reduce(acc * (w / total), group)
            reported = comm.all_reduce(loss.detach().clone(), group)
        if aux and self.moe_aux_weight:
            aux_term = self.moe_aux_weight * sum(aux)  # in the order the layers ran
            loss = loss + aux_term
            if reported is not None:
                reported = reported + aux_term.detach()
        loss.backward()
        return (loss.detach() if reported is None else reported), acc, [p.grad for p in params]

    def make_train_step_fn(self):
        """``step(data, idx, weight=None) -> (loss, acc)``: one micro-step on
        the batch ``idx`` of a device-resident split; the optimizer applies
        an update every ``accum`` calls. Returns device tensors and never
        waits on the device."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) before making the step")

        def step(data: DeviceSplit, idx: torch.Tensor, weight: Optional[torch.Tensor] = None):
            if weight is None:
                weight = torch.ones(idx.shape, device=self.device)
            if self.mesh is not None:  # a global batch: this rank's rows of it
                idx, weight = shard_batch((idx, weight), self.mesh)
            features, labels, lengths = data.gather(idx)
            return self._update(features, labels, None, lengths, weight)

        return step

    def make_stream_step_fn(self):
        """``step(features, labels, mask, lengths, weight) -> (loss, acc)``:
        one micro-step on a batch already on the device (a
        ``StreamingDeviceLoader`` tuple), with the resident step's
        augmentations and update; the batch's modality mask is multiplied by
        the step's modality dropout (the reference's streaming step). On a
        mesh the batch is global and each rank takes its rows."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) before making the step")
        if self.mesh is None:
            return self._update

        def step(features, labels, mask, lengths, weight):
            return self._update(*shard_batch((features, labels, mask, lengths, weight),
                                             self.mesh))

        return step

    def _update(self, features, labels, mask, lengths, weight):
        """Augment, loss and gradients, optimizer: one micro-step. ``mask``
        None is the resident step's all-ones modality mask."""
        num_mod = len(features) if mask is None else mask.shape[1]
        features, lengths, drop = self.augment(features, lengths, num_mod)
        mask = drop if mask is None else mask * drop
        with self._layout_ctx():
            loss, acc, grads = self.loss_and_grads(features, labels, mask, lengths, weight)
        self.optimizer.step(grads)
        return loss, acc

    def stream_batches(self, windows: WindowedSplit, epoch: int) -> StreamingDeviceLoader:
        """Epoch ``epoch``'s train batches streamed to the trainer's device:
        a shuffled ``BatchLoader`` seeded as the resident epoch's index
        matrix (``seed + epoch``), so both take the same order."""
        loader = BatchLoader(windows, self.batch_size, shuffle=True, seed=self.seed)
        loader.set_epoch(epoch)
        return StreamingDeviceLoader(loader, device=self.device)

    # -- state for a resume ------------------------------------------------
    def train_state(self) -> Dict[str, Any]:
        """Optimizer tensors and counters plus the generator state: with the
        weights, everything the next epoch depends on. On a mesh the
        optimizer's pieces are gathered whole (collective), ``generator`` is
        rank 0's state and ``generators`` every rank's."""
        state = {"optimizer": self.optimizer.state_dict(),
                 "generator": self.generator.get_state()}
        if self.mesh is None:
            return state
        specs = [self.specs[k] for k, _ in self.model.named_parameters()]
        for name in ("acc", "mu", "nu"):
            state["optimizer"][name] = [gather_full(t, ospec, self.mesh)
                                        for t, (_p, ospec) in zip(state["optimizer"][name], specs)]
        mine = state["generator"].to(self.device)
        every = comm.all_gather(mine[None], 0, dist.group.WORLD).cpu()
        # copies, not rows of one storage: set_state reads a state from its
        # storage's start
        state["generator"], state["generators"] = every[0].clone(), [g.clone() for g in every]
        return state

    def load_train_state(self, state: Dict[str, Any]) -> None:
        optimizer = state["optimizer"]
        generator = state["generator"]
        if self.mesh is not None:  # this rank's pieces of the whole state
            specs = [self.specs[k] for k, _ in self.model.named_parameters()]
            optimizer = dict(optimizer)
            for name in ("acc", "mu", "nu"):
                optimizer[name] = [
                    self.optimizer.layout.piece(i, local_slice(t.to(self.device), pspec,
                                                               self.mesh))
                    for i, (t, (pspec, _o)) in enumerate(zip(optimizer[name], specs))]
            rank = dist.get_rank()
            saved = state.get("generators")
            if saved is not None and len(saved) == self.mesh.size:
                generator = saved[rank]
            else:  # a run of another world: this rank's seed, not its stream
                generator = rank_generator(self.device, self.seed, self.mesh.index(
                    self.mesh.batch_axes())).get_state()
        self.optimizer.load_state_dict(optimizer)
        self.generator.set_state(generator.cpu().clone())

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` whole: on a mesh every rank's pieces
        gathered (collective), the one-process checkpoint format."""
        state = self.model.state_dict()
        return state if self.mesh is None else gather_state_dict(state, self.mesh)

    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """Whole weights (a checkpoint) into the model, this rank's pieces
        on a mesh."""
        self.model.load_state_dict(
            state if self.mesh is None else scatter_state_dict(state, self.mesh))

    # -- evaluation --------------------------------------------------------
    @torch.inference_mode()
    def evaluate_logits(
        self,
        data: DeviceSplit,
        batch_size: Optional[int] = None,
        model: Optional[MultimodalFusionModel] = None,
    ) -> np.ndarray:
        """Full-split forward pass in eval mode -> ``[N, C]`` logits (host
        numpy), with ``model`` or the trainer's own. The last batch is padded
        by wrap-around and cut to ``N``."""
        sharded = model is None and self.mesh is not None
        model = model or self.model
        n = data.num_windows
        batch = self._effective_batch(batch_size) if sharded else int(batch_size or self.batch_size)
        idx_mat, _ = padded_index_matrix(n, batch)
        idx_dev = torch.from_numpy(idx_mat).long().to(self.device)
        out = []
        # the trainer's own model on a mesh: each (dcn, data) rank its rows,
        # the logits gathered; a whole model passed in runs here alone
        with self._layout_ctx() if sharded else contextlib.nullcontext():
            for idx in idx_dev:
                if sharded:
                    idx = shard_batch(idx, self.mesh)
                features, _labels, lengths = data.gather(idx)
                mask = torch.ones((idx.shape[0], len(data.modalities)), device=self.device)
                logits = model(features, mask, lengths, train=False)
                if sharded:
                    logits = comm.all_gather(logits, 0, self.mesh.group(self.mesh.batch_axes()))
                out.append(logits)
        if not out:
            return np.zeros((0, model.num_classes), np.float32)
        return torch.cat(out).cpu().numpy()[:n]

    # -- host-side epoch orchestration ---------------------------------------
    def fit(
        self,
        train_windows: WindowedSplit,
        val_windows: WindowedSplit,
        test_windows: Optional[WindowedSplit] = None,
        save_dir: Optional[str | Path] = None,
        log_fn: Optional[Callable[[str], None]] = print,
        resume_from: Optional[str | Path] = None,
    ) -> Dict[str, Any]:
        """Train up to ``training.max_epochs`` epochs; returns (and writes to
        ``<save_dir>/results.json``) ``best_model_path``, ``best_val_loss``,
        ``config``, ``test_acc`` (with a test split), ``history`` and
        ``train_wall_seconds``."""
        if log_fn is print:  # flush through pipes
            log_fn = lambda msg: print(msg, flush=True)  # noqa: E731
        mesh = self._ensure_mesh()
        if not _is_primary():  # one log, one event stream and one results.json a run
            log_fn = None
        cfg = self.config
        streaming = bool(cfg.dataset.get("streaming", False))
        max_epochs = int(cfg.training.get("max_epochs", 1))
        patience = int(cfg.training.get("early_stopping_patience", 10))
        exp_cfg = cfg.get("experiment", {}) or {}
        save_dir = Path(
            save_dir or Path(exp_cfg.get("save_dir", "runs")) / exp_cfg.get("name", "exp")
        )
        if _is_primary():
            save_dir.mkdir(parents=True, exist_ok=True)
        if mesh is not None and log_fn:
            log_fn(f"mesh {mesh.shape} over {mesh.size} ranks ({self.device.type}, "
                   f"{comm.group_backend()}); batch over {mesh.batch_axes()}"
                   + (", ZeRO-1 over 'data'" if self.zero_optimizer else ""))

        batch = self._effective_batch()
        # streaming never puts the train split on the device whole
        train_data = (None if streaming
                      else DeviceSplit.from_windows(train_windows, device=self.device))
        val_data = DeviceSplit.from_windows(val_windows, device=self.device)
        n_train = train_windows.num_windows
        steps_per_epoch = (n_train + batch - 1) // batch
        self.init_state(steps_per_epoch)
        step = self.make_stream_step_fn() if streaming else self.make_train_step_fn()
        start_epoch = 0
        if resume_from is not None:
            weights, _cfg, meta = load_checkpoint(resume_from)
            self.load_state_dict(weights)
            self.load_train_state(load_train_state(resume_from))
            start_epoch = int(meta.get("epoch", -1)) + 1
            if log_fn:
                log_fn(f"resumed from {resume_from} at epoch {start_epoch}")

        ckpt = CheckpointManager(
            save_dir / "checkpoints",
            config=cfg,
            save_top_k=int(exp_cfg.get("save_top_k", 3)),
            save_last=True,
            # only a resumed run may adopt checkpoints already in save_dir
            adopt_existing=resume_from is not None,
        )
        writer = None
        if _is_primary():
            try:
                from tensorboardX import SummaryWriter

                writer = SummaryWriter(str(save_dir / "logs"))
            except ImportError:
                pass

        best_val = float("inf")
        bad_epochs = 0
        if resume_from is not None and ckpt.best_model_score is not None:
            # restore early-stopping state so interrupted and uninterrupted
            # runs of the same config stop at the same epoch
            best_val = float(ckpt.best_model_score)
            if ckpt.best_model_epoch is not None:
                bad_epochs = max(0, start_epoch - 1 - ckpt.best_model_epoch)
        val_labels = np.asarray(val_windows.labels)
        history = []
        t_start = time.perf_counter()
        for epoch in range(start_epoch, max_epochs):
            if streaming:
                stats = [step(*b) for b in self.stream_batches(train_windows, epoch)]
            else:
                idx_mat, weight_mat = padded_index_matrix(n_train, batch, True,
                                                          self.seed + epoch)
                idx_dev = torch.from_numpy(idx_mat).long().to(self.device)
                weight_dev = torch.from_numpy(weight_mat).to(self.device)
                stats = [step(train_data, idx, weight)
                         for idx, weight in zip(idx_dev, weight_dev)]
            if stats:
                # epoch means stay on the device; one fetch per epoch
                train_loss, train_acc = torch.stack(
                    [torch.stack(pair) for pair in stats]).mean(dim=0).tolist()
            else:  # empty split
                train_loss = train_acc = float("nan")

            val_logits = self.evaluate_logits(val_data)
            # same criterion as training (incl. label smoothing): early
            # stopping and checkpoint ranking rank by the trained objective
            val_loss = float(cross_entropy_loss(
                torch.from_numpy(val_logits), torch.from_numpy(val_labels),
                label_smoothing=self.label_smoothing))
            val_acc = float((val_logits.argmax(-1) == val_labels).mean())
            history.append({"epoch": epoch, "train/loss": train_loss, "train/acc": train_acc,
                            "val/loss": val_loss, "val/acc": val_acc})
            if writer is not None:
                for key in ("train/loss", "train/acc", "val/loss", "val/acc"):
                    writer.add_scalar(key, history[-1][key], epoch)
            if log_fn:
                log_fn(
                    f"epoch {epoch}: train/loss={train_loss:.4f} train/acc={train_acc:.4f} "
                    f"val/loss={val_loss:.4f} val/acc={val_acc:.4f}"
                )

            ckpt.save(self.state_dict(), epoch, val_loss, train_state=self.train_state())
            if val_loss < best_val:
                best_val = val_loss
                bad_epochs = 0
            else:
                # stop once the counter REACHES patience, not one later
                bad_epochs += 1
                if bad_epochs >= patience:
                    if log_fn:
                        log_fn(f"early stopping at epoch {epoch} (patience {patience})")
                    break

        wall = time.perf_counter() - t_start
        results: Dict[str, Any] = {
            "best_model_path": ckpt.best_model_path or "",
            "best_val_loss": float(
                ckpt.best_model_score if ckpt.best_model_score is not None else best_val
            ),
            "config": cfg.to_container(resolve=True),
        }
        if test_windows is not None:
            best_model = None  # the trainer's own (its shard on a mesh)
            if ckpt.best_model_path:
                # rebuilt from the checkpoint directory alone, whole on every rank
                weights, best_cfg, _meta = load_checkpoint(ckpt.best_model_path)
                best_model = MultimodalFusionModel.from_config(best_cfg or cfg, device=self.device)
                best_model.load_state_dict(weights)
            test_data = DeviceSplit.from_windows(test_windows, device=self.device)
            test_logits = self.evaluate_logits(test_data, model=best_model)
            test_labels = np.asarray(test_windows.labels)
            results["test_acc"] = float((test_logits.argmax(-1) == test_labels).mean())
            if log_fn:
                log_fn(f"test/acc={results['test_acc']:.4f}")

        results["history"] = history
        results["train_wall_seconds"] = wall
        if _is_primary():
            (save_dir / "results.json").write_text(json.dumps(results, indent=2))
        if writer is not None:
            writer.close()
        return results
