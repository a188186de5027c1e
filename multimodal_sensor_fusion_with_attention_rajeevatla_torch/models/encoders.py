"""Per-modality encoders (eval mode), port of the JAX package's ``models/encoders.py``.

Ported: the transformer branch of ``SequenceEncoder`` and its post-LN
``TransformerEncoderLayer`` (dense feed-forward). The layer runs its q/k/v
projections as one ``[H, 3H]`` matmul whose packed output feeds the
attention kernel directly (``ops.attention.flash_mha_packed``) when
``flash_attention`` is set and the sequence fits the packed route; otherwise
it takes the plain masked-softmax attention. LayerNorms follow flax: eps
1e-6 and the fast variance ``max(E[x^2] - E[x]^2, 0)``.

Linear layers are ``nn.Linear`` (weight ``[out, in]``); ``models.module``
initialises them like flax (lecun-normal kernels, zero biases).

The LSTM, GRU and CNN branches, ``FrameEncoder`` and ``SimpleMLPEncoder``
are not ported yet (ROADMAP queue A item 10) and raise
``NotImplementedError``; training-mode dropout comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import flash_mha_packed, packed_route_ok
from ..ops.masked import lengths_to_mask, masked_mean_pool, masked_softmax

_SEQUENCE_MODALITIES = {"imu", "audio", "mocap", "accelerometer"}
_NOT_PORTED = "is not ported yet (ROADMAP queue A item 10)"


def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal (+-2 sigma) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6):
    """flax LayerNorm over the last dim: float32 statistics, fast variance."""
    r = x.float()
    mu = r.mean(dim=-1, keepdim=True)
    var = ((r * r).mean(dim=-1, keepdim=True) - mu * mu).clamp(min=0.0)
    return ((r - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` defaults (eps 1e-6, fast variance)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer, eval mode (reference
    ``_TransformerEncoderLayer``, dense non-MoE path)."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        dim_feedforward: int = 2048,
        use_flash: bool = False,
    ):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} not divisible by num_heads {num_heads}")
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.q_proj = nn.Linear(hidden_dim, hidden_dim)
        self.k_proj = nn.Linear(hidden_dim, hidden_dim)
        self.v_proj = nn.Linear(hidden_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)
        self.norm1 = LayerNorm(hidden_dim)
        self.linear1 = nn.Linear(hidden_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, hidden_dim)
        self.norm2 = LayerNorm(hidden_dim)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, H]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, T], 1 = valid
    ) -> torch.Tensor:
        batch, seq_len, _ = x.shape
        head_dim = self.hidden_dim // self.num_heads
        # one [H, 3H] projection: q | k | v packed along the minor dim
        w_qkv = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight], 0)
        b_qkv = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias], 0)
        qkv = F.linear(x, w_qkv, b_qkv)  # [B, T, 3H]
        if self.use_flash and packed_route_ok(seq_len, self.num_heads, head_dim):
            # suffix padding -> the valid keys are a prefix; mask == lengths
            lengths = (
                key_padding_mask.sum(dim=-1).to(torch.int32)
                if key_padding_mask is not None
                else None
            )
            attended = flash_mha_packed(qkv, lengths, num_heads=self.num_heads)
        elif self.use_flash and x.is_cuda:
            raise NotImplementedError(
                f"flash attention for padded T > 512 (got T={seq_len}) needs the tiled "
                "kernel, which is not ported yet (ROADMAP queue B item 6)"
            )
        else:
            qkv5 = qkv.reshape(batch, seq_len, 3, self.num_heads, head_dim)
            q, k, v = qkv5[:, :, 0], qkv5[:, :, 1], qkv5[:, :, 2]
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * head_dim**-0.5
            mask = key_padding_mask[:, None, None, :] if key_padding_mask is not None else None
            weights = masked_softmax(scores, mask)
            attended = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(
                batch, seq_len, self.hidden_dim
            )
        x = self.norm1(x + self.out_proj(attended))
        ff = self.linear2(torch.relu(self.linear1(x)))
        return self.norm2(x + ff)


class SequenceEncoder(nn.Module):
    """Time series -> fixed embedding; transformer branch (reference
    ``SequenceEncoder``), with the reference's error strings."""

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int = 256,
        output_dim: int = 128,
        num_layers: int = 2,
        encoder_type: str = "lstm",
        flash_attention: bool = False,
    ):
        super().__init__()
        if encoder_type not in ("lstm", "gru", "cnn", "transformer"):
            raise ValueError(f"Unknown encoder type: {encoder_type}")
        if encoder_type != "transformer":
            raise NotImplementedError(f"SequenceEncoder encoder_type={encoder_type!r} {_NOT_PORTED}")
        self.hidden_dim = hidden_dim
        self.input_projection = nn.Linear(input_dim, hidden_dim)
        nhead = 4 if hidden_dim % 4 == 0 else 1
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(hidden_dim, nhead, use_flash=flash_attention)
            for _ in range(num_layers)
        )
        self.projection = nn.Linear(hidden_dim, output_dim)

    def forward(
        self, sequence: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if sequence.dim() != 3:
            raise ValueError(
                f"Expected 3D input sequence, got shape {tuple(sequence.shape)}"
            )
        seq_len = sequence.shape[1]
        x = self.input_projection(sequence)
        valid_mask = lengths_to_mask(lengths, seq_len) if lengths is not None else None
        for layer in self.layers:
            x = layer(x, key_padding_mask=valid_mask)
        pooled = masked_mean_pool(x, valid_mask, dim=1, min_denom=1.0)
        return self.projection(pooled)


def build_encoder(
    modality: str,
    input_dim: int,
    output_dim: int,
    encoder_config: Optional[Dict[str, Any]] = None,
) -> nn.Module:
    """Factory with the reference's routing rules (``build_encoder``)."""
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
    if kind != "sequence":
        raise NotImplementedError(f"{kind} encoder for modality {modality!r} {_NOT_PORTED}")
    allowed = {"hidden_dim", "num_layers", "encoder_type", "flash_attention"}
    return SequenceEncoder(
        input_dim=input_dim,
        output_dim=output_dim,
        **{k: v for k, v in config.items() if k in allowed},
    )
