"""Pipeline parallelism for the transformer encoder's layer stack, port of the
JAX package's ``parallel/pipeline.py`` on ``torch.distributed``.

- **Stacked layers.** The L layers' tensors live stacked in one tree,
  ``pipe_layers.<q_proj|k_proj|v_proj|out_proj|linear1|linear2>.<kernel|bias>``
  (kernels ``[L, in, out]``) and ``pipe_layers.<norm1|norm2>.<scale|bias>``,
  the reference's ``pipe_layers`` leaf for leaf (``convert.py``). Under a
  mesh with a ``pipe`` axis each of its P ranks holds its stage's L/P
  contiguous rows (``parallel.mesh.state_shardings``).
- **Layer math.** One layer is ``models.encoders.run_layer`` on a view of
  the stacked rows (``layer_forward``): the encoder layer's own routes, so on
  the card a stage runs the port's layer kernels (packed attention, the
  residual-LayerNorm halves, the mask generator) as the sequential stack
  does. The reference's pipelined path is plain only because Pallas cannot
  lower inside its ``shard_map``; the function is the same.
- **GPipe schedule** (``_pipeline_schedule``): this data rank's batch splits
  into M microbatches; over ``M + P - 1`` steps rank r runs microbatch
  ``t - r`` and sends its activation to rank ``r + 1``. The last stage's
  outputs are broadcast to every pipe rank (the reference's ``psum``), so the
  rest of the model is rank-uniform. The backward runs the steps in reverse,
  each stage's gradient sent back by ``recv`` / ``send`` in one fixed order,
  with the last rank's output gradient alone (every pipe rank computes the
  same loss: summing their P equal gradients would give P times the
  sequential one); the input's gradient, whole on rank 0, is broadcast, so
  the layers before the stack get the same gradient on every pipe rank.
- **Dropout.** Each (layer, microbatch) draws from a generator seeded from
  one number that every pipe rank draws alike from the caller's generator
  (the reference folds the two indices into its key), so the stages' masks
  are independent and the caller's generator moves alike on every pipe rank.

Off a ``pipe`` mesh the layers run one after the other on the whole batch,
with the same tensors, so the same checkpoint serves both.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from . import comm
from .mesh import PIPE_AXIS, current_activation_mesh

_DENSE = ("q_proj", "k_proj", "v_proj", "out_proj", "linear1", "linear2")
_NORMS = ("norm1", "norm2")
_SEED_MASK = (1 << 62) - 1


def stacked_layers_init(module: "PipelinedTransformerLayers", generator: torch.Generator) -> None:
    """The reference's ``stacked_layers_init``: lecun-normal kernels drawn
    layer by layer (fan-in of one layer), zero biases, LayerNorm scales 1."""
    from ..models.encoders import lecun_normal_

    with torch.no_grad():
        for name in _DENSE:
            kernel = module.pipe_layers[name]["kernel"]
            for layer in range(kernel.shape[0]):
                lecun_normal_(kernel[layer], kernel.shape[1], generator)
            module.pipe_layers[name]["bias"].zero_()
        for name in _NORMS:
            module.pipe_layers[name]["scale"].fill_(1.0)
            module.pipe_layers[name]["bias"].zero_()


def _view(tree, layer: int):
    """One layer of the stacked tree with the encoder layer's attribute
    names (``weight`` ``[out, in]`` as a transposed view of the kernel)."""
    p = {name: SimpleNamespace(weight=tree[name]["kernel"][layer].t(),
                               bias=tree[name]["bias"][layer]) for name in _DENSE}
    p.update({name: SimpleNamespace(weight=tree[name]["scale"][layer],
                                    bias=tree[name]["bias"][layer], eps=1e-6)
              for name in _NORMS})
    return SimpleNamespace(moe=None, **p)


def layer_forward(cfg, tree, layer: int, x, valid_mask, train: bool,
                  generator: Optional[torch.Generator]):
    """Layer ``layer`` of the stacked tree on ``x [B, T, H]``: the encoder
    layer's forward (``models.encoders.run_layer``)."""
    from ..models.encoders import run_layer

    return run_layer(cfg, _view(tree, layer), x, valid_mask, train, generator)


def _fold(base: int, layer: int, micro: int) -> int:
    return (base * 0x9E3779B1 + layer * 0x85EBCA77 + micro * 0xC2B2AE3D + 1) & _SEED_MASK


class PipelinedTransformerLayers(nn.Module):
    """L transformer encoder layers, a GPipe pipeline under an active mesh
    with a ``pipe`` axis, one after the other otherwise (module docstring)."""

    def __init__(self, hidden_dim: int, num_heads: int, num_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 pipeline_parallel: int = 2, microbatches: int = 0,
                 use_flash: bool = False, use_fused_mlp: bool = False,
                 use_fused_mlp_ln: bool = False, dropout_rng: str = "auto",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_layers % pipeline_parallel:
            raise ValueError(
                f"num_layers ({num_layers}) must divide evenly over "
                f"pipeline_parallel ({pipeline_parallel})")
        self.num_layers = num_layers
        self.pipeline_parallel = pipeline_parallel
        self.microbatches = microbatches
        # the encoder layer's settings, read by run_layer
        self.cfg = SimpleNamespace(
            hidden_dim=hidden_dim, num_heads=num_heads, dim_feedforward=dim_feedforward,
            dropout=dropout, use_flash=use_flash, use_fused_mlp=use_fused_mlp,
            use_fused_mlp_ln=use_fused_mlp_ln, dropout_rng=dropout_rng, dtype=dtype,
            seq_parallel=False)
        h, f, L = hidden_dim, dim_feedforward, num_layers
        dims = {"q_proj": (h, h), "k_proj": (h, h), "v_proj": (h, h), "out_proj": (h, h),
                "linear1": (h, f), "linear2": (f, h)}
        tree = {name: nn.ParameterDict({"kernel": nn.Parameter(torch.zeros(L, i, o)),
                                        "bias": nn.Parameter(torch.zeros(L, o))})
                for name, (i, o) in dims.items()}
        tree.update({name: nn.ParameterDict({"scale": nn.Parameter(torch.ones(L, h)),
                                             "bias": nn.Parameter(torch.zeros(L, h))})
                     for name in _NORMS})
        self.pipe_layers = nn.ModuleDict(tree)

    def init_parameters(self, generator: torch.Generator) -> None:
        stacked_layers_init(self, generator)

    def _leaves(self) -> List[nn.Parameter]:
        return [self.pipe_layers[name][leaf] for name in _DENSE + _NORMS
                for leaf in self.pipe_layers[name]]

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        use_dropout = train and self.cfg.dropout > 0.0
        base = None
        if use_dropout:  # one draw, alike on every pipe rank
            base = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                     device=generator.device if generator is not None
                                     else x.device).item())
        mesh = current_activation_mesh()
        if mesh is None or mesh.axis_size(PIPE_AXIS) <= 1:
            for layer in range(self.num_layers):
                gen = _generator(base, layer, 0, x.device)
                x = layer_forward(self.cfg, self.pipe_layers, layer, x, key_padding_mask,
                                  train, gen)
            return x
        n_pipe = mesh.axis_size(PIPE_AXIS)
        if n_pipe != self.pipeline_parallel:
            raise ValueError(f"mesh 'pipe' axis ({n_pipe}) != pipeline_parallel "
                             f"({self.pipeline_parallel})")
        n_micro = self.microbatches or self.pipeline_parallel
        if x.shape[0] % n_micro:
            raise ValueError(f"batch ({x.shape[0]}) must divide evenly into "
                             f"pipeline microbatches ({n_micro})")
        run = _Schedule(self, mesh, n_micro, key_padding_mask, train, base)
        leaves = self._leaves()
        if not torch.is_grad_enabled():
            return run.forward(x, leaves, build_graph=False)
        return _PipelineFunction.apply(run, x, *leaves)


def _generator(base: Optional[int], layer: int, micro: int, device) -> Optional[torch.Generator]:
    if base is None:
        return None
    return torch.Generator(device=device).manual_seed(_fold(base, layer, micro))


class _Schedule:
    """The GPipe steps of one call on this rank (``_pipeline_schedule``)."""

    def __init__(self, module, mesh, n_micro, valid, train, base):
        self.module, self.n_micro, self.train, self.base = module, n_micro, train, base
        line = next(r for r in mesh.lines([PIPE_AXIS]) if dist.get_rank() in r)
        self.group = mesh.group(PIPE_AXIS)
        self.rank = mesh.coords()[PIPE_AXIS]
        self.n_pipe = mesh.axis_size(PIPE_AXIS)
        self.prev = line[self.rank - 1] if self.rank > 0 else None
        self.next = line[self.rank + 1] if self.rank < self.n_pipe - 1 else None
        self.per_stage = module.num_layers // self.n_pipe
        self.valid = None if valid is None else valid.chunk(n_micro)
        self.saved = []  # (micro input, micro output) with their graphs

    def stage(self, tree, y, micro: int):
        for local in range(self.per_stage):
            layer = self.rank * self.per_stage + local
            gen = _generator(self.base, layer, micro, y.device)
            y = layer_forward(self.module.cfg, tree, local, y,
                              None if self.valid is None else self.valid[micro], self.train, gen)
        return y

    def forward(self, x: torch.Tensor, leaves, build_graph: bool) -> torch.Tensor:
        names = [(n, leaf) for n in _DENSE + _NORMS for leaf in self.module.pipe_layers[n]]
        tree = {}
        for (name, leaf), t in zip(names, leaves):
            tree.setdefault(name, {})[leaf] = t
        micro_x = x.chunk(self.n_micro)
        outs = [None] * self.n_micro
        for t in range(self.n_micro + self.n_pipe - 1):
            micro = t - self.rank
            if not 0 <= micro < self.n_micro:
                continue
            if self.prev is None:
                inp = micro_x[micro]
            else:
                inp = comm.recv(micro_x[micro], self.prev, tag=micro)
            with torch.enable_grad() if build_graph else torch.no_grad():
                if build_graph:
                    inp = inp.detach().requires_grad_(True)
                y = self.stage(tree, inp, micro)
            if build_graph:
                self.saved.append((inp, y))
            if self.next is not None:
                comm.send(y.detach(), self.next, tag=micro)
            else:
                outs[micro] = y.detach()
        if self.next is None:
            out = torch.cat(outs)
        else:
            out = torch.empty_like(x)
        # the last stage's outputs on every pipe rank (the reference's psum)
        return comm.broadcast(out.contiguous(), self.n_pipe - 1, self.group)

    def backward(self, grad_out: torch.Tensor, leaves) -> tuple:
        grads = [torch.zeros_like(p) for p in leaves]
        micro_g = grad_out.chunk(self.n_micro)  # read on the last rank alone
        dx = [None] * self.n_micro
        for micro in reversed(range(self.n_micro)):
            inp, y = self.saved[micro]
            if self.next is None:
                g = micro_g[micro].contiguous()
            else:
                g = comm.recv(y, self.next, tag=micro)
            found = torch.autograd.grad(y, [inp, *leaves], g, allow_unused=True)
            for acc, part in zip(grads, found[1:]):
                if part is not None:
                    acc.add_(part)
            if self.prev is not None:
                comm.send(found[0], self.prev, tag=micro)
            else:
                dx[micro] = found[0]
        self.saved = []
        if self.prev is None:
            dx_all = torch.cat(dx)
        else:
            dx_all = torch.empty_like(grad_out)
        # the input's gradient, whole on rank 0, on every pipe rank
        return comm.broadcast(dx_all.contiguous(), 0, self.group), grads


class _PipelineFunction(torch.autograd.Function):
    """The schedule as one autograd node: its forward builds each stage's
    graphs, its backward runs them in reverse (``_Schedule.backward``)."""

    @staticmethod
    def forward(ctx, run: _Schedule, x, *leaves):
        ctx.run = run
        ctx.leaves = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        return run.forward(x, ctx.leaves, build_graph=True)

    @staticmethod
    def backward(ctx, grad_out):
        dx, grads = ctx.run.backward(grad_out, ctx.leaves)
        return (None, dx, *grads)
