"""Per-modality encoders, port of the JAX package's ``models/encoders.py``.

Ported, in eval and train mode: the transformer branch of ``SequenceEncoder``
and its post-LN ``TransformerEncoderLayer`` (dense feed-forward), the LSTM /
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
``torch.inference_mode`` (MC dropout) normalises by the batch's statistics
and leaves them as they were, as the reference discards its
``mutable=["batch_stats"]`` update there. The convolutions are plain
``conv1d`` (XLA's in the reference, no kernel there either).

``build_encoder`` raises ``NotImplementedError`` for a per-encoder key of the
reference that the port does not run (``_UNPORTED_KEYS``) set to anything but
its default.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

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

_SEQUENCE_MODALITIES = {"imu", "audio", "mocap", "accelerometer"}
# per-encoder keys the reference's build_encoder passes on and the port does
# not run yet: key -> (is the value a non-default, ROADMAP queue A item)
_UNPORTED_KEYS = {
    "moe_experts": (lambda v: int(v or 0) > 0, 8),
    "pipeline_parallel": (lambda v: int(v or 1) > 1, 11),
    "sequence_parallel": (bool, 11),
    "dtype": (lambda v: v is not None and str(v).lower() not in ("float32", "torch.float32"), 7),
}


def resolve_dropout_rng(value, device_type: str, kernels_on: bool = True) -> str:
    """Where a training layer's dropout masks come from: ``"kernel"`` (the
    ``ops.mlp.dropout_keep_mask`` generator kernel) or ``"xla"`` (plain
    ``torch.rand`` draws from the caller's generator).

    As in the reference: ``kernel`` and ``auto`` mean the generator kernel
    when the tensors are on the card and the layer runs at least one kernel
    path (``flash_attention`` or ``fused_mlp``); on the CPU, or with both
    flags off, they mean plain draws. ``xla`` always means plain draws. The
    two sources give different masks from the same generator.
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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6):
    """flax LayerNorm over the last dim: float32 statistics, fast variance."""
    return ln_rows(x.float(), weight, bias, eps)[0].to(x.dtype)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` defaults (eps 1e-6, fast variance)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


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
            if torch.is_grad_enabled():
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                    self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.float().view(shape) + self.bias.float().view(shape)).to(x.dtype)


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (reference ``_TransformerEncoderLayer``,
    dense non-MoE path), eval and train mode."""

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
    ):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by num_heads {num_heads}")
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.dropout = dropout
        self.use_fused_mlp = use_fused_mlp
        self.use_fused_mlp_ln = use_fused_mlp_ln
        self.dropout_rng = dropout_rng
        self.q_proj = nn.Linear(hidden_dim, hidden_dim)
        self.k_proj = nn.Linear(hidden_dim, hidden_dim)
        self.v_proj = nn.Linear(hidden_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)
        self.norm1 = LayerNorm(hidden_dim)
        self.linear1 = nn.Linear(hidden_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, hidden_dim)
        self.norm2 = LayerNorm(hidden_dim)

    def _attend(self, x, key_padding_mask):
        batch, seq_len, _ = x.shape
        head_dim = self.hidden_dim // self.num_heads
        # one [H, 3H] projection: q | k | v packed along the minor dim
        w_qkv = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight], 0)
        b_qkv = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias], 0)
        qkv = F.linear(x, w_qkv, b_qkv)  # [B, T, 3H]
        qkv5 = qkv.reshape(batch, seq_len, 3, self.num_heads, head_dim)
        if self.use_flash and attention_route(head_dim) == "kernel":
            # suffix padding -> the valid keys are a prefix; mask == lengths
            lengths = (
                key_padding_mask.sum(dim=-1).to(torch.int32)
                if key_padding_mask is not None
                else None
            )
            if packed_route_ok(seq_len, self.num_heads, head_dim):
                return flash_mha_packed(qkv, lengths, num_heads=self.num_heads)
            q, k, v = (qkv5[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, T, d]
            attended = flash_self_attention(q, k, v, lengths)
            return attended.transpose(1, 2).reshape(batch, seq_len, self.hidden_dim)
        q, k, v = qkv5[:, :, 0], qkv5[:, :, 1], qkv5[:, :, 2]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * head_dim**-0.5
        mask = key_padding_mask[:, None, None, :] if key_padding_mask is not None else None
        weights = masked_softmax(scores, mask)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(
            batch, seq_len, self.hidden_dim
        )

    def forward(
        self,
        x: torch.Tensor,  # [B, T, H]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, T], 1 = valid
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        batch, seq_len, hidden = x.shape
        rows = batch * seq_len
        kernels = self.use_fused_mlp and train and mlp_route(hidden) == "kernel"
        fused = kernels and self.use_fused_mlp_ln
        keep_prob = 1.0 - self.dropout
        drop = train and self.dropout > 0.0
        source = resolve_dropout_rng(
            self.dropout_rng, x.device.type, self.use_flash or self.use_fused_mlp
        )
        def drop_where(mask, y):
            return torch.where(mask.bool(), y / keep_prob, 0.0)

        attended = self._attend(x, key_padding_mask)
        att_mask = ffw_mask = res_mask = None
        if drop:
            specs = ((hidden, RNG_P_ATT), (self.linear1.out_features, RNG_P_HIDDEN),
                     (hidden, RNG_P_RES))
            if source == "kernel":
                # one two-word seed per layer; the three masks differ by their
                # purpose and come from one launch
                seed = kernel_rng_seed(generator, x.device)
                masks = [m.reshape(batch, seq_len, width) for m, (width, _) in
                         zip(dropout_keep_masks(seed, rows, specs, keep_prob), specs)]
            else:
                masks = [keep_mask((batch, seq_len, width), keep_prob, generator, x.device)
                         for width, _ in specs]
            att_mask, ffw_mask, res_mask = masks
        if fused:
            x = fused_proj_residual_ln(
                x.reshape(rows, hidden), attended.reshape(rows, hidden),
                self.out_proj.weight.t(), self.out_proj.bias, self.norm1.weight,
                self.norm1.bias, res_mask=att_mask, keep_prob=keep_prob,
            ).reshape(batch, seq_len, hidden)
        else:
            y = self.out_proj(attended)
            if att_mask is not None:
                y = drop_where(att_mask, y)
            x = self.norm1(x + y)
        if fused:
            return fused_mlp_residual_ln(
                x.reshape(rows, hidden), self.linear1.weight.t(), self.linear1.bias,
                self.linear2.weight.t(), self.linear2.bias, self.norm2.weight,
                self.norm2.bias, ffw_mask=ffw_mask, res_mask=res_mask, keep_prob=keep_prob,
            ).reshape(batch, seq_len, hidden)
        if kernels:
            # fused_mlp without the combined LayerNorm kernel: the
            # feed-forward kernel pair, then the plain residual half (eval
            # stays plain, the reference's measured choice)
            ff = transformer_ffw(
                x, {"kernel": self.linear1.weight.t(), "bias": self.linear1.bias},
                {"kernel": self.linear2.weight.t(), "bias": self.linear2.bias},
                keep_mask=ffw_mask, keep_prob=keep_prob, use_fused=True,
            )
        else:
            h = torch.relu(self.linear1(x))
            if ffw_mask is not None:
                h = drop_where(ffw_mask, h)
            ff = self.linear2(h)
        if res_mask is not None:
            ff = drop_where(res_mask, ff)
        return self.norm2(x + ff)


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
    ):
        super().__init__()
        if encoder_type not in ("lstm", "gru", "cnn", "transformer"):
            raise ValueError(f"Unknown encoder type: {encoder_type}")
        if str(dropout_rng or "auto").lower() not in ("auto", "xla", "kernel"):
            raise ValueError(f"Unknown dropout_rng {dropout_rng!r}; expected auto, xla or kernel")
        self.encoder_type = encoder_type
        self.hidden_dim = hidden_dim
        self.dropout = dropout
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
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                hidden_dim, nhead, use_flash=flash_attention, dropout=dropout,
                use_fused_mlp=fused_mlp, use_fused_mlp_ln=fused_mlp_ln,
                dropout_rng=dropout_rng,
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
    ) -> torch.Tensor:
        if sequence.dim() != 3:
            raise ValueError(
                f"Expected 3D input sequence, got shape {tuple(sequence.shape)}"
            )
        if self.encoder_type in ("lstm", "gru"):
            final_state = self.rnn(sequence, lengths=lengths, train=train, generator=generator)
            return self.projection(dropout(final_state, self.dropout, train, generator))
        seq_len = sequence.shape[1]
        if self.encoder_type == "cnn":
            mask = lengths_to_mask(lengths, seq_len) if lengths is not None else None
            x = sequence.transpose(1, 2)  # [B, C, T] through both blocks
            if mask is not None:
                # the 3-wide SAME conv reads one step past each boundary:
                # zero the padded tail first
                x = x * mask[:, None, :]
            for conv, norm in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
                x = torch.relu(norm(conv(x), mask, train))
                if mask is not None:
                    x = x * mask[:, None, :]
            if mask is None:
                pooled = x.mean(dim=2)
            else:  # the tail is zero: the masked mean is the sum over the valid steps
                pooled = x.sum(dim=2) / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
            return self.projection(dropout(pooled, self.dropout, train, generator))
        x = self.input_projection(sequence)
        valid_mask = lengths_to_mask(lengths, seq_len) if lengths is not None else None
        for layer in self.layers:
            x = layer(x, key_padding_mask=valid_mask, train=train, generator=generator)
        pooled = masked_mean_pool(x, valid_mask, dim=1, min_denom=1.0)
        return self.projection(dropout(pooled, self.dropout, train, generator))


class FrameEncoder(nn.Module):
    """Frame features ``[B, T, D]`` -> clip embedding by masked temporal
    pooling (reference ``FrameEncoder``): attention pooling (an all-masked
    row gets zero weights), the masked average, or the masked max (``-inf``
    then ``nan_to_num``)."""

    def __init__(self, input_dim: int, hidden_dim: int = 256, output_dim: int = 128,
                 temporal_pooling: str = "attention", dropout: float = 0.1):
        super().__init__()
        if temporal_pooling not in ("attention", "average", "max"):
            raise ValueError(f"Unknown pooling: {temporal_pooling}")
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
        processed = dropout(torch.relu(self.frame_processor(frames)), self.dropout, train,
                            generator)
        if mask is not None:
            mask = mask.to(processed.dtype)
        if self.temporal_pooling == "attention":
            scores = self.attention(processed)  # [B, T, 1]
            weights = masked_softmax(scores, mask[..., None] if mask is not None else None, dim=1)
            pooled = (weights * processed).sum(dim=1)
        elif self.temporal_pooling == "average":
            pooled = masked_mean_pool(processed, mask, dim=1, min_denom=1e-8)
        elif mask is None:
            pooled = processed.amax(dim=1)
        else:
            pooled = nan_to_num(torch.where(mask[..., None] == 0, float("-inf"),
                                            processed).amax(dim=1))
        x = dropout(torch.relu(self.proj_hidden(pooled)), self.dropout, train, generator)
        return self.proj_out(x)


class SimpleMLPEncoder(nn.Module):
    """MLP over pre-extracted ``[B, D]`` features (reference
    ``SimpleMLPEncoder``): ``num_layers`` of Dense, BatchNorm (flax's:
    momentum 0.9, eps 1e-5, the fast variance), ReLU, dropout; then Dense."""

    def __init__(self, input_dim: int, hidden_dim: int = 256, output_dim: int = 128,
                 num_layers: int = 2, dropout: float = 0.1, batch_norm: bool = True):
        super().__init__()
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
            x = getattr(self, f"dense{idx}")(x)
            if self.batch_norm:
                x = getattr(self, f"bn{idx}")(x, train=train)
            x = dropout(torch.relu(x), self.dropout, train, generator)
        return self.out(x)


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
            "pipeline_parallel", "dtype"}),
        "mlp": (SimpleMLPEncoder, {"hidden_dim", "num_layers", "dropout", "batch_norm", "dtype"}),
    }[kind]
    for key, (non_default, item) in _UNPORTED_KEYS.items():
        if key in allowed and non_default(config.get(key)):
            raise NotImplementedError(
                f"model.encoders.{modality}.{key}={config[key]!r} is not ported yet "
                f"(ROADMAP queue A item {item})")
    return cls(
        input_dim=input_dim,
        output_dim=output_dim,
        **{k: v for k, v in config.items() if k in allowed and k not in _UNPORTED_KEYS},
    )
