"""Per-modality encoders, port of the JAX package's ``models/encoders.py``.

Ported, in eval and train mode: the transformer branch of ``SequenceEncoder``
and its post-LN ``TransformerEncoderLayer`` (dense or MoE feed-forward), the LSTM /
GRU branch with ``RNNStack``, the CNN branch with ``MaskedBatchNorm``,
``FrameEncoder`` and ``SimpleMLPEncoder``, and every route of
``build_encoder``.
The layer runs its q/k/v projections as one ``[H, 3H]`` matmul. With
``flash_attention`` set, a sequence that fits the packed route (padded
T <= 512) feeds that packed output to ``ops.attention.flash_mha_packed``
directly; a longer one is split into ``[B, H, T, d]`` q, k, v for
``ops.attention.flash_self_attention`` (single-key-block or tiled forward,
fused or split backward, by the padded length). The reference casts q, k, v
to bf16 before that transpose on a TPU; the port stays f32, as all its
kernels do. Without the flag the layer takes the plain masked-softmax
attention.
LayerNorms follow flax: eps 1e-6 and the fast variance
``max(E[x^2] - E[x]^2, 0)``.

Training: dropout keep masks are made outside the compute kernels and in a
fixed order (attention-side residual ``[B,T,H]``, hidden ``[B,T,F]``,
FFW-side residual ``[B,T,H]``, then the pooled vector), so the kernel path
and the plain path consume the same masks. ``training.dropout_rng`` picks
their source (``resolve_dropout_rng``): the Philox generator kernel
``ops.mlp.dropout_keep_mask``, seeded per layer with two words drawn from the
caller's ``torch.Generator`` (a layer's three masks in one launch,
``ops.mlp.dropout_keep_masks``), or plain ``torch.rand`` draws from that
generator. There is no dropout on the attention probabilities. With
``fused_mlp`` and ``fused_mlp_ln`` on, train mode runs the layer's two
halves through ``ops.mlp.fused_proj_residual_ln`` and
``fused_mlp_residual_ln``; with ``fused_mlp_ln`` off the feed-forward runs
through ``ops.mlp.transformer_ffw``'s kernel pair; eval keeps the plain path,
as the reference does. Each kernel family is taken where its route names it
at the layer's widths (``ops.attention.attention_route`` on head_dim,
``ops.mlp.mlp_route`` on d_model); a width between the built ones runs on
the kernels padded with zero columns, and a head_dim above 128 or a d_model
above 256 (wider than a block of those kernels holds) takes the plain path.
The reference's kernels take any width; the routes keep the same function.

Linear layers are ``nn.Linear`` (weight ``[out, in]``); ``models.module``
initialises them like flax (lecun-normal kernels, zero biases).

``RNNStack`` (reference ``_RNNStack``) is the plain recurrence: one input
projection for all steps, then a loop over time of ``ops.rnn``'s shared cell
step with the carry frozen past each row's length. The reference runs it as
an XLA scan and no kernel, so there is none here; the recurrence kernels
serve the grouped encoder (``models.grouped.GroupedRNNEncoder``). Its weights
keep the reference's ``[in, gates*H]`` layout.

The CNN branch (two 3-wide SAME convolutions, each followed by batch
statistics over the valid steps only, ReLU and the padded tail re-zeroed, then
a masked mean pool) and ``SimpleMLPEncoder`` normalise with
``MaskedBatchNorm``: the reference's running statistics (``0.9 * running +
0.1 * batch``, the biased variance, eps 1e-5, f32), kept as buffers so that
the ``state_dict`` carries them. They move only on a training forward that
records gradients; a train-mode forward under ``torch.no_grad`` or
``torch.inference_mode`` (MC dropout), or inside ``running_stats_frozen``
(a forward recomputed for its backward), normalises by the batch's
statistics and leaves them as they were, as the reference discards its
``mutable=["batch_stats"]`` update there. The convolutions are plain
``conv1d`` (XLA's in the reference, no kernel there either).

Every encoder but the recurrent ones takes the reference's ``dtype``
(``mixed_precision`` sets bfloat16 on each; ``resolve_dtype``): parameters
stay f32 and are cast where they are used, and the reference's roundings
are kept one product at a time. A dense layer in bf16 (``dense``) rounds its
product to bf16 and then adds the bf16 bias, rounding again, as flax's
``nn.Dense`` does; the transformer layer's out-projection and feed-forward
products round to bf16 and go on in f32 (residuals and LayerNorm statistics
f32, each half's output rounded to bf16); on the kernel routes the bf16
entries of ``ops.attention`` and ``ops.mlp`` take the same roundings (each
op picks its entries by its operands' type; the flash routes take f32 copies
of bf16 q, k and v). BatchNorm statistics
stay f32. ``RNNStack`` and its projection ignore ``dtype``, as the
reference's ``_RNNStack`` does.

The parallel layouts (``parallel/``): under an active mesh with a ``model``
axis the layer's feed-forward is tensor-parallel and, with
``sequence_parallel``, its norm regions hold this rank's chunk of T
(``TransformerEncoderLayer``); ``pipeline_parallel`` > 1 stacks the layers
into ``parallel.pipeline.PipelinedTransformerLayers`` (``pipeline``), a GPipe
pipeline over the mesh's ``pipe`` axis that runs the layers one after the
other off the mesh.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import (
    attention_route,
    flash_mha_packed,
    flash_self_attention,
    packed_route_ok,
)
from ..ops.masked import lengths_to_mask, masked_mean_pool, masked_softmax, nan_to_num
from ..ops.rnn import rnn_scan
from ..ops.mlp import (
    RNG_P_ATT,
    RNG_P_HIDDEN,
    RNG_P_RES,
    dropout_keep_masks,
    fused_mlp_residual_ln,
    fused_proj_residual_ln,
    kernel_rng_seed,
    ln_rows,
    mlp_route,
    transformer_ffw,
)
from ..parallel.mesh import (
    batch_ranks,
    model_group,
    seq_gathered_constraint,
    seq_sharded_constraint,
    sum_over_batch,
)
from .moe import MoEFeedForward

_SEQUENCE_MODALITIES = {"imu", "audio", "mocap", "accelerometer"}


def resolve_dtype(value) -> Optional[torch.dtype]:
    """An encoder's or head's compute type from its config value: None for
    float32 (the default: full f32, the layers themselves), bfloat16 for
    ``bfloat16``; anything else raises."""
    if value is None or value == torch.float32 or str(value).lower() in ("float32",
                                                                         "torch.float32"):
        return None
    if value == torch.bfloat16 or str(value).lower() in ("bfloat16", "torch.bfloat16"):
        return torch.bfloat16
    raise ValueError(f"Unknown compute dtype {value!r}; expected float32 or bfloat16")


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: the layer itself in f32 (``dtype``
    None); in bf16 the input, weight and bias cast to bf16, the product
    rounded to bf16, then the bias added in bf16, a second rounding, as the
    reference computes it (``F.linear`` with a bias would round once)."""
    if dtype is None:
        return layer(x)
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).t()) + layer.bias.to(dtype)


def product_f32(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype],
                bias: bool = True) -> torch.Tensor:
    """The transformer layer's ``einsum(x.astype(cd), w.astype(cd)).astype(f32)
    + b``: the layer itself in f32 (``dtype`` None); in bf16 the product of
    the bf16 input and weight rounded to bf16, then the f32 bias added in f32.
    ``bias=False`` leaves the bias out (a tensor-parallel shard's partial sum)."""
    b = layer.bias if bias else None
    if dtype is None:
        return F.linear(x, layer.weight, b)
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).t()).float()
    return y if b is None else y + b


def resolve_dropout_rng(value, device_type: str, kernels_on: bool = True) -> str:
    """Where a training layer's dropout masks come from: ``"kernel"`` (the
    ``ops.mlp.dropout_keep_mask`` generator kernel) or ``"xla"`` (plain
    ``torch.rand`` draws from the caller's generator).

    As in the reference: ``kernel`` and ``auto`` mean the generator kernel
    when the tensors are on the card and the layer runs at least one kernel
    path (``flash_attention`` or ``fused_mlp``); on the CPU, or with both
    flags off, they mean plain draws. ``xla`` always means plain draws. The
    two sources give different masks from the same generator. Under a
    parallel layout each (dcn, data) rank's generator is its own
    (``train.trainer.rank_generator``: a rank-distinct Philox offset on the
    card), so the masks cannot match the reference's one global draw.
    """
    rng = str(value or "auto").lower()
    if rng not in ("auto", "xla", "kernel"):
        raise ValueError(f"Unknown training.dropout_rng {value!r}; expected auto, xla or kernel")
    return "kernel" if rng != "xla" and device_type == "cuda" and kernels_on else "xla"


def keep_mask(shape, keep_prob: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Bernoulli(``keep_prob``) keep mask (bool) drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(
    x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(keep, x / keep_prob, 0)`` in train mode,
    the identity otherwise or at rate 0, zeros at rate 1."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    return torch.where(keep_mask(x.shape, keep_prob, generator, x.device), x / keep_prob, 0.0)


def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal (+-2 sigma) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` defaults (eps 1e-6, fast variance); its
    output takes the wider of the input's and the parameters' types (f32 on
    a bf16 input), as flax promotes them."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = torch.promote_types(x.dtype, self.weight.dtype)
        return ln_rows(x.float(), self.weight, self.bias, self.eps)[0].to(out_dtype)


_RUNNING_STATS = {"frozen": 0}  # > 0: a recomputed forward runs (running_stats_frozen)


@contextlib.contextmanager
def running_stats_frozen():
    """Inside, a training forward leaves every ``MaskedBatchNorm``'s running
    statistics as they are: a forward recomputed for its backward
    (``training.remat``) has already updated them once, as the reference's
    functional update counts once."""
    _RUNNING_STATS["frozen"] += 1
    try:
        yield
    finally:
        _RUNNING_STATS["frozen"] -= 1


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the channel axis ``channel_dim`` (the last by default)
    whose batch statistics weight only the valid positions (``mask``, the
    shape of the other axes, 1 = valid): the reference's
    ``_MaskedBatchNorm`` and, with ``fast_variance`` and no mask,
    ``flax.linen.BatchNorm`` (variance ``max(E[x^2] - E[x]^2, 0)``).
    Statistics in f32; running statistics ``momentum * running + (1 -
    momentum) * batch`` with the biased variance, updated only on a training
    forward that records gradients (module docstring)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 fast_variance: bool = False, channel_dim: int = -1):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.fast_variance = fast_variance
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        xf = x.float()
        c = self.channel_dim % xf.dim()
        shape = [-1 if a == c else 1 for a in range(xf.dim())]  # a [C] vector over x
        if not train:
            mean, var = self.running_mean, self.running_var
        elif batch_ranks() > 1:
            mean, var = self._global_stats(xf, mask, c, shape)
        else:
            axes = tuple(a for a in range(xf.dim()) if a != c)
            if mask is None:
                mean = xf.mean(dim=axes)
                if self.fast_variance:
                    var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
                else:
                    var = (xf - mean.view(shape)).square().mean(dim=axes)
            else:
                w = mask.float().unsqueeze(c)
                denom = w.sum().clamp(min=1.0)
                mean = (xf * w).sum(dim=axes) / denom
                var = (w * (xf - mean.view(shape)).square()).sum(dim=axes) / denom
        if train:
            if torch.is_grad_enabled() and not _RUNNING_STATS["frozen"]:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                    self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.float().view(shape) + self.bias.float().view(shape)).to(x.dtype)

    def _global_stats(self, xf, mask, c: int, shape):
        """Batch statistics over every (dcn, data) rank's rows, the
        reference's statistics of the global batch: sums over the ranks,
        forward and backward (``parallel.mesh.sum_over_batch``)."""
        axes = tuple(a for a in range(xf.dim()) if a != c)
        w = torch.ones_like(xf.select(c, 0)) if mask is None else mask.float()
        w = w.unsqueeze(c)
        count = sum_over_batch(w.expand_as(xf).sum(dim=axes))
        denom = count if mask is None else count.clamp(min=1.0)
        mean = sum_over_batch((xf * w).sum(dim=axes)) / denom
        if self.fast_variance and mask is None:
            var = torch.clamp(sum_over_batch((xf * xf).sum(dim=axes)) / denom - mean * mean,
                              min=0.0)
        else:
            var = sum_over_batch((w * (xf - mean.view(shape)).square()).sum(dim=axes)) / denom
        return mean, var


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (reference ``_TransformerEncoderLayer``),
    eval and train mode; in bf16 with ``dtype`` (module docstring). With
    ``moe_experts > 0`` a ``models.moe.MoEFeedForward`` (``moe``) takes the
    place of ``linear1`` / ``linear2``, which the layer then does not have:
    its residual dropout, add and norm2 are plain f32, its dropout masks the
    attention-side and FFW-side residual ones only (two a launch on the
    kernel source), and its load-balance aux loss goes to ``aux_losses``
    when the caller passes a list.

    Under an active mesh with a ``model`` axis (``parallel.mesh``) the
    feed-forward pair is this rank's shard (``linear1`` its rows of F,
    ``linear2`` its columns) and runs through ``parallel.tp_kernels.tp_fused_mlp``
    (the ``fused_mlp`` pair, rows 10-11, where the layer's route takes
    kernels; ``ffw_ln``, rows 12-13, cannot take a partial sum), then the
    residual dropout, add and norm2. Attention, the projections and the
    LayerNorms stay replicated, the first half on its route (rows 1-2 and
    14-15). With ``seq_parallel`` the layer's input and output are this
    rank's chunk of T: gathered along T before the attention and the
    feed-forward, the out-projection, residuals and LayerNorms on the chunk,
    the row-parallel product reduce-scattered back to it. The dropout masks
    are drawn whole and sliced, so each rank applies the single-device
    pattern of its data rank."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        dim_feedforward: int = 2048,
        use_flash: bool = False,
        dropout: float = 0.0,
        use_fused_mlp: bool = False,
        use_fused_mlp_ln: bool = False,
        dropout_rng: str = "auto",
        dtype: Optional[torch.dtype] = None,
        moe_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        seq_parallel: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by num_heads {num_heads}")
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.dropout = dropout
        self.use_fused_mlp = use_fused_mlp
        self.use_fused_mlp_ln = use_fused_mlp_ln
        self.dropout_rng = dropout_rng
        self.seq_parallel = seq_parallel
        self.q_proj = nn.Linear(hidden_dim, hidden_dim)
        self.k_proj = nn.Linear(hidden_dim, hidden_dim)
        self.v_proj = nn.Linear(hidden_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)
        self.norm1 = LayerNorm(hidden_dim)
        self.dim_feedforward = dim_feedforward
        self.moe = None
        if moe_experts > 0:  # the reference creates the dense pair on the dense branch only
            self.moe = MoEFeedForward(hidden_dim, dim_feedforward, moe_experts, moe_top_k,
                                      moe_capacity_factor, dropout, dtype)
        else:
            self.linear1 = nn.Linear(hidden_dim, dim_feedforward)
            self.linear2 = nn.Linear(dim_feedforward, hidden_dim)
        self.norm2 = LayerNorm(hidden_dim)
        if seq_parallel:
            # used on each rank's chunk of T: their gradients are partial
            # sums over 'model' (parallel/mesh.py)
            for module in (self.out_proj, self.norm1, self.norm2):
                for param in module.parameters():
                    param.sequence_parallel = True
            if self.moe is None:
                self.linear2.bias.sequence_parallel = True

    def forward(
        self,
        x: torch.Tensor,  # [B, T, H] (this rank's chunk of T under sequence parallelism)
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, T], 1 = valid (whole T)
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        aux_losses: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        return run_layer(self, self, x, key_padding_mask, train, generator, aux_losses)


def _layer_norm(norm, x: torch.Tensor) -> torch.Tensor:
    """``LayerNorm.forward`` on any object with ``weight`` and ``bias``."""
    out_dtype = torch.promote_types(x.dtype, norm.weight.dtype)
    return ln_rows(x.float(), norm.weight, norm.bias, getattr(norm, "eps", 1e-6))[0].to(out_dtype)


def _attend(cfg, p, x, key_padding_mask):
    batch, seq_len, _ = x.shape
    head_dim = cfg.hidden_dim // cfg.num_heads
    # one [H, 3H] projection: q | k | v packed along the minor dim
    w_qkv = torch.cat([p.q_proj.weight, p.k_proj.weight, p.v_proj.weight], 0)
    b_qkv = torch.cat([p.q_proj.bias, p.k_proj.bias, p.v_proj.bias], 0)
    if cfg.dtype is None:
        qkv = F.linear(x, w_qkv, b_qkv)  # [B, T, 3H]
    else:  # the product rounded to bf16, then the bias added in bf16
        qkv = torch.matmul(x, w_qkv.to(cfg.dtype).t()) + b_qkv.to(cfg.dtype)
    qkv5 = qkv.reshape(batch, seq_len, 3, cfg.num_heads, head_dim)
    if cfg.use_flash and attention_route(head_dim) == "kernel":
        # suffix padding -> the valid keys are a prefix; mask == lengths
        lengths = (
            key_padding_mask.sum(dim=-1).to(torch.int32)
            if key_padding_mask is not None
            else None
        )
        # f32 out either way (bf16 on the packed route reads bf16 qkv,
        # the flash routes f32 copies), rounded to the layer's type
        if packed_route_ok(seq_len, cfg.num_heads, head_dim):
            return flash_mha_packed(qkv, lengths, num_heads=cfg.num_heads).to(x.dtype)
        q, k, v = (qkv5[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, T, d]
        attended = flash_self_attention(q, k, v, lengths).to(x.dtype)
        return attended.transpose(1, 2).reshape(batch, seq_len, cfg.hidden_dim)
    q, k, v = qkv5[:, :, 0], qkv5[:, :, 1], qkv5[:, :, 2]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * head_dim**-0.5
    mask = key_padding_mask[:, None, None, :] if key_padding_mask is not None else None
    weights = masked_softmax(scores, mask)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(
        batch, seq_len, cfg.hidden_dim
    )


def run_layer(cfg, p, x, key_padding_mask=None, train=False, generator=None, aux_losses=None):
    """One ``TransformerEncoderLayer`` forward with its settings read from
    ``cfg`` and its tensors from ``p`` (objects with the layer's attribute
    names: the layer itself, or one layer's view of a pipeline stage's
    stacked weights, ``parallel.pipeline``)."""
    batch, seq_len, hidden = x.shape
    rows = batch * seq_len
    dt = cfg.dtype
    model = model_group()
    sp = bool(getattr(cfg, "seq_parallel", False)) and model is not None
    tp = model is not None and p.moe is None  # the dense pair is this rank's shard
    kernels = cfg.use_fused_mlp and train and mlp_route(hidden) == "kernel"
    first_fused = kernels and cfg.use_fused_mlp_ln
    fused = first_fused and not tp  # ffw_ln cannot take the shards' partial sums
    keep_prob = 1.0 - cfg.dropout
    drop = train and cfg.dropout > 0.0
    source = resolve_dropout_rng(
        cfg.dropout_rng, x.device.type, cfg.use_flash or cfg.use_fused_mlp
    )
    def drop_where(mask, y):
        return torch.where(mask.bool(), y / keep_prob, 0.0)

    x_all = seq_gathered_constraint(x) if sp else x  # [B, T, H] for the attention
    full_len = x_all.shape[1]
    attended = _attend(cfg, p, x_all, key_padding_mask)
    if sp:  # the out-projection, residual and norm1 on this rank's chunk
        attended = seq_sharded_constraint(attended)
    att_mask = ffw_mask = res_mask = None
    if drop:
        specs = [(hidden, RNG_P_ATT), (cfg.dim_feedforward, RNG_P_HIDDEN),
                 (hidden, RNG_P_RES)]
        if p.moe is not None:  # no hidden mask: the experts draw their own
            del specs[1]
        if source == "kernel":
            # one two-word seed per layer; the masks differ by their
            # purpose and come from one launch
            seed = kernel_rng_seed(generator, x.device)
            masks = [m.reshape(batch, full_len, width) for m, (width, _) in
                     zip(dropout_keep_masks(seed, batch * full_len, specs, keep_prob), specs)]
        else:
            masks = [keep_mask((batch, full_len, width), keep_prob, generator, x.device)
                     for width, _ in specs]
        att_mask, res_mask = masks[0], masks[-1]
        ffw_mask = masks[1] if len(masks) == 3 else None
        if sp:  # whole masks drawn, this rank's chunk of T applied
            t0 = model[1] * seq_len
            att_mask, res_mask = (m[:, t0:t0 + seq_len] for m in (att_mask, res_mask))
    if first_fused:
        x = fused_proj_residual_ln(
            x.reshape(rows, hidden), attended.reshape(rows, hidden),
            p.out_proj.weight.t(), p.out_proj.bias, p.norm1.weight,
            p.norm1.bias, res_mask=att_mask, keep_prob=keep_prob,
        ).reshape(batch, seq_len, hidden)
    else:  # in bf16 the product rounded, the bias, dropout and LayerNorm in f32
        y = product_f32(p.out_proj, attended, dt)
        if att_mask is not None:
            y = drop_where(att_mask, y)
        x = _layer_norm(p.norm1, x.float() + y).to(x.dtype)
    if p.moe is not None:
        ff, aux = p.moe(seq_gathered_constraint(x) if sp else x, valid_mask=key_padding_mask,
                        train=train, generator=generator)
        if sp:
            ff = seq_sharded_constraint(ff)
        if aux_losses is not None:
            aux_losses.append(aux)
        if res_mask is not None:
            ff = drop_where(res_mask, ff)
        return _layer_norm(p.norm2, x.float() + ff.float()).to(x.dtype)
    if fused:
        return fused_mlp_residual_ln(
            x.reshape(rows, hidden), p.linear1.weight.t(), p.linear1.bias,
            p.linear2.weight.t(), p.linear2.bias, p.norm2.weight,
            p.norm2.bias, ffw_mask=ffw_mask, res_mask=res_mask, keep_prob=keep_prob,
        ).reshape(batch, seq_len, hidden)

    def plain_ffw(rows, mask, bias=True):
        # the reference's XLA branch: in bf16 each product rounded
        h = torch.relu(product_f32(p.linear1, rows, dt))
        if mask is not None:
            h = drop_where(mask, h)
        return product_f32(p.linear2, h, dt, bias=bias)

    if tp:
        # Megatron's column / row pair over 'model': the fused_mlp kernel
        # pair on this rank's F-slice where the route takes kernels, else
        # the plain feed-forward of the slice, without linear2's bias
        from ..parallel.mesh import current_activation_mesh
        from ..parallel.tp_kernels import tp_fused_mlp

        ff = tp_fused_mlp(
            current_activation_mesh(), x, p.linear1.weight.t(), p.linear1.bias,
            p.linear2.weight.t(), p.linear2.bias, keep_mask=ffw_mask, keep_prob=keep_prob,
            seq_dim=1 if sp else None, dtype=dt,
            plain=None if kernels else (lambda rows, mask: plain_ffw(rows, mask, bias=False)),
        ).to(x.dtype)
    elif kernels:
        # fused_mlp without the combined LayerNorm kernel: the
        # feed-forward kernel pair, then the plain residual half (eval
        # stays plain, the reference's measured choice)
        ff = transformer_ffw(
            x, {"kernel": p.linear1.weight.t(), "bias": p.linear1.bias},
            {"kernel": p.linear2.weight.t(), "bias": p.linear2.bias},
            keep_mask=ffw_mask, keep_prob=keep_prob, use_fused=True,
        )
    else:  # in bf16 the output rounded too
        ff = plain_ffw(x, ffw_mask).to(x.dtype)
    if res_mask is not None:
        ff = drop_where(res_mask, ff)
    return _layer_norm(p.norm2, x.float() + ff.float()).to(x.dtype)


class RNNStack(nn.Module):
    """Multi-layer LSTM / GRU (reference ``_RNNStack``): torch gate order,
    every layer's per-step outputs feed the next, dropout only between
    layers, returns the last layer's final hidden state ``[B, H]``."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int, cell_type: str,
                 dropout: float = 0.0):
        super().__init__()
        if cell_type not in ("lstm", "gru"):
            raise ValueError(f"Unknown cell type: {cell_type}")
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.cell_type = cell_type
        self.dropout = dropout
        gates = (4 if cell_type == "lstm" else 3) * hidden_dim
        for layer in range(num_layers):
            in_dim = input_dim if layer == 0 else hidden_dim
            for name, shape in (("weight_ih", (in_dim, gates)), ("weight_hh", (hidden_dim, gates)),
                                ("bias_ih", (gates,)), ("bias_hh", (gates,))):
                self.register_parameter(f"{name}_l{layer}", nn.Parameter(torch.zeros(shape)))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """torch's RNN init, as the reference: every tensor ~ U(+-H^-0.5)."""
        scale = self.hidden_dim**-0.5
        for param in self.parameters():
            param.uniform_(-scale, scale, generator=generator)

    def forward(
        self,
        sequence: torch.Tensor,  # [B, T, D]
        lengths: Optional[torch.Tensor] = None,  # [B]
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        layer_input = sequence
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = (
                getattr(self, f"{name}_l{layer}")
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            # one [B*T, D] x [D, gates*H] product feeds the whole loop
            x_proj = (layer_input @ w_ih + b_ih).transpose(0, 1)  # [T, B, gates*H]
            last = layer == self.num_layers - 1
            final_state, outputs = rnn_scan(
                self.cell_type, x_proj, w_hh, b_hh, lengths, return_outputs=not last)
            if not last:
                layer_input = dropout(outputs.transpose(0, 1), self.dropout, train, generator)
        return final_state


class SequenceEncoder(nn.Module):
    """Time series -> fixed embedding; the transformer, lstm / gru and cnn
    branches (reference ``SequenceEncoder``), with the reference's error
    strings."""

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int = 256,
        output_dim: int = 128,
        num_layers: int = 2,
        encoder_type: str = "lstm",
        flash_attention: bool = False,
        dropout: float = 0.1,
        fused_mlp: bool = False,
        fused_mlp_ln: bool = False,
        dropout_rng: str = "auto",
        dtype=None,
        moe_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        sequence_parallel: bool = False,
        pipeline_parallel: int = 1,
        pipeline_microbatches: int = 0,
    ):
        super().__init__()
        if encoder_type not in ("lstm", "gru", "cnn", "transformer"):
            raise ValueError(f"Unknown encoder type: {encoder_type}")
        if str(dropout_rng or "auto").lower() not in ("auto", "xla", "kernel"):
            raise ValueError(f"Unknown dropout_rng {dropout_rng!r}; expected auto, xla or kernel")
        self.encoder_type = encoder_type
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        # the recurrent branch ignores it, as the reference's _RNNStack does
        self.dtype = resolve_dtype(dtype) if encoder_type in ("cnn", "transformer") else None
        if encoder_type in ("lstm", "gru"):
            self.rnn = RNNStack(input_dim, hidden_dim, num_layers, encoder_type, dropout)
            self.projection = nn.Linear(hidden_dim, output_dim)
            return
        if encoder_type == "cnn":  # two conv blocks whatever num_layers says, as the reference
            self.conv0 = nn.Conv1d(input_dim, hidden_dim, 3, padding=1)
            self.bn0 = MaskedBatchNorm(hidden_dim, channel_dim=1)  # on [B, C, T]
            self.conv1 = nn.Conv1d(hidden_dim, hidden_dim, 3, padding=1)
            self.bn1 = MaskedBatchNorm(hidden_dim, channel_dim=1)
            self.projection = nn.Linear(hidden_dim, output_dim)
            return
        self.input_projection = nn.Linear(input_dim, hidden_dim)
        nhead = 4 if hidden_dim % 4 == 0 else 1
        self.sequence_parallel = bool(sequence_parallel)
        if int(pipeline_parallel or 1) > 1:
            if int(moe_experts or 0) > 0:
                raise ValueError("pipeline_parallel does not compose with moe_experts")
            # GPipe microbatch pipeline over the mesh's "pipe" axis; off-mesh
            # the same stacked layers run one after the other
            from ..parallel.pipeline import PipelinedTransformerLayers

            self.pipeline = PipelinedTransformerLayers(
                hidden_dim, nhead, num_layers, dropout=dropout,
                pipeline_parallel=int(pipeline_parallel), microbatches=int(
                    pipeline_microbatches or 0),
                use_flash=flash_attention, use_fused_mlp=fused_mlp,
                use_fused_mlp_ln=fused_mlp_ln, dropout_rng=dropout_rng, dtype=self.dtype,
            )
        else:
            self.layers = nn.ModuleList(
                TransformerEncoderLayer(
                    hidden_dim, nhead, use_flash=flash_attention, dropout=dropout,
                    use_fused_mlp=fused_mlp, use_fused_mlp_ln=fused_mlp_ln,
                    dropout_rng=dropout_rng, dtype=self.dtype,
                    moe_experts=int(moe_experts or 0), moe_top_k=int(moe_top_k or 2),
                    moe_capacity_factor=float(moe_capacity_factor or 1.25),
                    seq_parallel=self.sequence_parallel,
                )
                for _ in range(num_layers)
            )
        self.projection = nn.Linear(hidden_dim, output_dim)

    def forward(
        self,
        sequence: torch.Tensor,
        lengths: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        aux_losses: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        if sequence.dim() != 3:
            raise ValueError(
                f"Expected 3D input sequence, got shape {tuple(sequence.shape)}"
            )
        if self.encoder_type in ("lstm", "gru"):
            final_state = self.rnn(sequence, lengths=lengths, train=train, generator=generator)
            return self.projection(dropout(final_state, self.dropout, train, generator))
        seq_len = sequence.shape[1]
        dt = self.dtype
        if self.encoder_type == "cnn":
            mask = lengths_to_mask(lengths, seq_len) if lengths is not None else None
            x = sequence.transpose(1, 2)  # [B, C, T] through both blocks
            if mask is not None:
                # the 3-wide SAME conv reads one step past each boundary:
                # zero the padded tail first
                x = x * mask[:, None, :]
            for conv, norm in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
                if dt is None:
                    y = conv(x)
                else:  # the convolution rounded to bf16, then the bias added in bf16
                    y = F.conv1d(x.to(dt), conv.weight.to(dt), padding=1)
                    y = y + conv.bias.to(dt)[:, None]
                x = torch.relu(norm(y, mask, train))
                if mask is not None:
                    x = x * mask[:, None, :].to(x.dtype)
            if mask is None:
                pooled = x.mean(dim=2)
            else:  # the tail is zero: the masked mean is the sum over the valid steps
                pooled = x.sum(dim=2) / mask.to(x.dtype).sum(dim=1, keepdim=True).clamp(min=1.0)
            return dense(self.projection, dropout(pooled, self.dropout, train, generator), dt)
        x = dense(self.input_projection, sequence, dt)
        valid_mask = lengths_to_mask(lengths, seq_len) if lengths is not None else None
        if hasattr(self, "pipeline"):
            x = self.pipeline(x, key_padding_mask=valid_mask, train=train, generator=generator)
        else:
            # sequence parallelism: the layers take and give this rank's chunk of T
            sp = self.sequence_parallel and model_group() is not None
            if sp:
                x = seq_sharded_constraint(x)
            for layer in self.layers:
                x = layer(x, key_padding_mask=valid_mask, train=train, generator=generator,
                          aux_losses=aux_losses)
            if sp:
                x = seq_gathered_constraint(x)
        pooled = masked_mean_pool(x, valid_mask, dim=1, min_denom=1.0)
        return dense(self.projection, dropout(pooled, self.dropout, train, generator), dt)


class FrameEncoder(nn.Module):
    """Frame features ``[B, T, D]`` -> clip embedding by masked temporal
    pooling (reference ``FrameEncoder``): attention pooling (an all-masked
    row gets zero weights), the masked average, or the masked max (``-inf``
    then ``nan_to_num``)."""

    def __init__(self, input_dim: int, hidden_dim: int = 256, output_dim: int = 128,
                 temporal_pooling: str = "attention", dropout: float = 0.1, dtype=None):
        super().__init__()
        if temporal_pooling not in ("attention", "average", "max"):
            raise ValueError(f"Unknown pooling: {temporal_pooling}")
        self.dtype = resolve_dtype(dtype)
        self.temporal_pooling = temporal_pooling
        self.dropout = dropout
        self.frame_processor = nn.Linear(input_dim, hidden_dim)
        if temporal_pooling == "attention":
            self.attention = nn.Linear(hidden_dim, 1)
        self.proj_hidden = nn.Linear(hidden_dim, hidden_dim)
        self.proj_out = nn.Linear(hidden_dim, output_dim)

    def forward(
        self,
        frames: torch.Tensor,
        mask: Optional[torch.Tensor] = None,  # [B, T], 1 = valid
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if frames.dim() != 3:
            raise ValueError(f"Expected 3D frame tensor, got shape {tuple(frames.shape)}")
        dt = self.dtype
        processed = dropout(torch.relu(dense(self.frame_processor, frames, dt)), self.dropout,
                            train, generator)
        if mask is not None:
            mask = mask.to(processed.dtype)
        if self.temporal_pooling == "attention":
            scores = dense(self.attention, processed, dt)  # [B, T, 1]
            weights = masked_softmax(scores, mask[..., None] if mask is not None else None, dim=1)
            pooled = (weights * processed).sum(dim=1)
        elif self.temporal_pooling == "average":
            pooled = masked_mean_pool(processed, mask, dim=1, min_denom=1e-8)
        elif mask is None:
            pooled = processed.amax(dim=1)
        else:
            pooled = nan_to_num(torch.where(mask[..., None] == 0, float("-inf"),
                                            processed).amax(dim=1))
        x = dropout(torch.relu(dense(self.proj_hidden, pooled, dt)), self.dropout, train,
                    generator)
        return dense(self.proj_out, x, dt)


class SimpleMLPEncoder(nn.Module):
    """MLP over pre-extracted ``[B, D]`` features (reference
    ``SimpleMLPEncoder``): ``num_layers`` of Dense, BatchNorm (flax's:
    momentum 0.9, eps 1e-5, the fast variance), ReLU, dropout; then Dense."""

    def __init__(self, input_dim: int, hidden_dim: int = 256, output_dim: int = 128,
                 num_layers: int = 2, dropout: float = 0.1, batch_norm: bool = True,
                 dtype=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        self.num_layers = num_layers
        self.dropout = dropout
        self.batch_norm = batch_norm
        for idx in range(num_layers):
            self.add_module(f"dense{idx}", nn.Linear(input_dim if idx == 0 else hidden_dim,
                                                     hidden_dim))
            if batch_norm:
                self.add_module(f"bn{idx}", MaskedBatchNorm(hidden_dim, fast_variance=True))
        self.out = nn.Linear(hidden_dim, output_dim)

    def forward(
        self,
        features: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if features.dim() != 2:
            raise ValueError(f"Expected 2D feature tensor, got shape {tuple(features.shape)}")
        x = features
        for idx in range(self.num_layers):
            x = dense(getattr(self, f"dense{idx}"), x, self.dtype)
            if self.batch_norm:
                x = getattr(self, f"bn{idx}")(x, train=train)
            x = dropout(torch.relu(x), self.dropout, train, generator)
        return dense(self.out, x, self.dtype)


def build_encoder(
    modality: str,
    input_dim: int,
    output_dim: int,
    encoder_config: Optional[Dict[str, Any]] = None,
) -> nn.Module:
    """Factory with the reference's routing rules (``build_encoder``): a
    ``type`` of ``frame``, ``sequence`` or ``mlp`` wins; else ``video`` /
    ``frames`` take a ``FrameEncoder``, the sequence modalities (and
    ``imu_*``) a ``SequenceEncoder``, the rest a ``SimpleMLPEncoder``. Each
    takes only its own keys from ``encoder_config``."""
    config: Dict[str, Any] = dict(encoder_config) if encoder_config else {}
    override_type = config.pop("type", None)
    modality_key = modality.lower()
    if override_type in ("frame", "sequence", "mlp"):
        kind = override_type
    elif modality_key in ("video", "frames"):
        kind = "frame"
    elif modality_key in _SEQUENCE_MODALITIES or modality_key.startswith("imu_"):
        kind = "sequence"
    else:
        kind = "mlp"
    cls, allowed = {
        "frame": (FrameEncoder, {"hidden_dim", "temporal_pooling", "dropout", "dtype"}),
        "sequence": (SequenceEncoder, {
            "hidden_dim", "num_layers", "encoder_type", "flash_attention", "dropout",
            "fused_mlp", "fused_mlp_ln", "dropout_rng", "sequence_parallel", "moe_experts",
            "moe_top_k", "moe_capacity_factor", "pipeline_parallel", "pipeline_microbatches",
            "dtype"}),
        "mlp": (SimpleMLPEncoder, {"hidden_dim", "num_layers", "dropout", "batch_norm", "dtype"}),
    }[kind]
    return cls(
        input_dim=input_dim,
        output_dim=output_dim,
        **{k: v for k, v in config.items() if k in allowed},
    )
