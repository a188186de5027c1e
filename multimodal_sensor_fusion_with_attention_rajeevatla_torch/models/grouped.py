"""Grouped encoders, port of the JAX package's ``models/grouped.py``.

``GroupedRNNEncoder``: G same-signature per-modality LSTM / GRU stacks
evaluated as one recurrence over a leading group axis, with
``groupable_modalities``. Stacked parameters keep the reference's names and
layout (``weight_ih_l<k> [G, in, gates*H]`` ...). With ``use_pallas`` and one
layer, eval is one launch of ``ops.rnn.grouped_lstm_fused`` /
``grouped_gru_fused`` on the raw stacked input (called as the ``msfa::``
op of ``ops/library.py``), and training runs the input
projection as one G-batched product whose ``x_proj [T, G, B, gates*H]`` feeds
``ops.rnn.grouped_lstm_trainable`` / ``grouped_gru_trainable`` (one forward
and one backward kernel launch for the group); otherwise the recurrence is the
plain loop ``ops.rnn.rnn_scan``, which autograd differentiates. Dropout sits
on the final state on every route and draws from the caller's generator in
the same order, so the kernel and plain routes get the same masks. Under
``mixed_precision`` it runs in f32: the reference switches its recurrence
to bf16 only on a TPU backend, so its function off the TPU, which the tests
hold the port to, is the f32 one; the TPU branch is queued (ROADMAP queue A
item 7b).

``GroupedTransformerEncoder`` (G same-signature per-modality
transformer stacks evaluated as one pass over a leading group axis),
``groupable_transformer_modalities`` and ``stack_group_features``. Member
weights are stacked ``[G, in, out]`` in the reference's layout, one
``nn.Parameter`` per stacked tensor, so every dense layer is one G-batched
matrix product (``torch.baddbmm``; a plain library product, as the reference
leaves it to XLA) and, with ``flash_attention``, the whole group shares one
``ops.attention.flash_self_attention`` launch over the folded ``[G*B]``
batch. The function is that of G separate ``SequenceEncoder``s carrying the
same weights unstacked: same post-LN layer math, same masked mean pooling,
same head-count rule, no attention-probability dropout.

Training: one mask ``[G, B, T, cols]`` per purpose covers the whole group,
drawn in the layer's fixed order (attention-side residual, hidden, FFW-side
residual), from the generator kernel when ``dropout_rng`` is ``auto`` or
``kernel``, the tensors are on the card and ``flash_attention`` is on (a
layer's three masks in one launch, ``ops.mlp.dropout_keep_masks``), else
from ``torch.rand`` on the caller's generator. The grouped encoder does
not use the fused projection/FFW LayerNorm kernels; the reference does not
either.

Under ``mixed_precision`` (``dtype`` bfloat16) it keeps the reference's
roundings one product at a time: the input projection and qkv round their
product to bf16 and add the bf16 bias (a second rounding), the input
projection's result going back to f32; the out-projection and both FFW
products round their product and add the f32 bias in f32; the residual
stream, the LayerNorms, the pooling and the output projection stay f32. The
plain attention runs on the bf16 q, k, v (bf16 scores and weights, the
softmax in f32), the flash route on f32 copies of them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.attention import attention_route, flash_self_attention
from ..ops.masked import lengths_to_mask, masked_mean_pool, masked_softmax
from ..ops.mlp import (
    RNG_P_ATT,
    RNG_P_HIDDEN,
    RNG_P_RES,
    dropout_keep_masks,
    kernel_rng_seed,
    ln_rows,
)
from ..ops import library
from ..ops.rnn import grouped_gru_trainable, grouped_lstm_trainable, rnn_scan
from .encoders import dropout, keep_mask, lecun_normal_, resolve_dropout_rng

_DENSE = ("q_proj", "k_proj", "v_proj", "out_proj", "linear1", "linear2")


def grouped_dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``[G, ..., in] x [G, in, out] + [G, out] -> [G, ..., out]``: one
    G-batched product over the flattened middle axes."""
    groups = x.shape[0]
    flat = x.reshape(groups, -1, x.shape[-1])
    out = torch.baddbmm(bias[:, None, :], flat, kernel)
    return out.reshape(*x.shape[:-1], kernel.shape[-1])


def grouped_product(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``[G, ..., in] x [G, in, out] -> [G, ..., out]`` without a bias, in the
    operands' type (a bf16 product is rounded once, to bf16)."""
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    return torch.bmm(flat, kernel).reshape(*x.shape[:-1], kernel.shape[-1])


def _group_bias(bias: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``[G, out]`` bias shaped to broadcast over ``[G, ..., out]``."""
    return bias.reshape(bias.shape[0], *([1] * (ndim - 2)), bias.shape[-1])


class GroupedRNNEncoder(nn.Module):
    """G independent LSTM / GRU stacks as one recurrence. Input
    ``[G, B, T, D_max]`` (features zero-padded to the group's widest member:
    the padded columns meet weight rows that multiply zeros), output
    ``[G, B, output_dim]``: each member's final hidden state, dropout and
    projection applied, what ``SequenceEncoder`` gives per modality."""

    def __init__(
        self,
        num_groups: int,
        input_dim: int,
        hidden_dim: int = 256,
        output_dim: int = 128,
        num_layers: int = 1,
        cell_type: str = "lstm",
        dropout: float = 0.1,
        use_pallas: bool = False,
    ):
        super().__init__()
        if cell_type not in ("lstm", "gru"):
            raise ValueError(f"Unknown cell type: {cell_type}")
        self.num_groups = num_groups
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.num_layers = num_layers
        self.cell_type = cell_type
        self.dropout = dropout
        self.use_pallas = use_pallas
        gates = (4 if cell_type == "lstm" else 3) * hidden_dim
        for layer in range(num_layers):
            in_dim = input_dim if layer == 0 else hidden_dim
            for name, shape in (("weight_ih", (in_dim, gates)), ("weight_hh", (hidden_dim, gates)),
                                ("bias_ih", (gates,)), ("bias_hh", (gates,))):
                self.register_parameter(
                    f"{name}_l{layer}", nn.Parameter(torch.zeros(num_groups, *shape)))
        self.proj_kernel = nn.Parameter(torch.zeros(num_groups, hidden_dim, output_dim))
        self.proj_bias = nn.Parameter(torch.zeros(num_groups, output_dim))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: recurrent tensors ~ U(+-H^-0.5); the
        projection G independent lecun-normal kernels (the group axis is a
        batch axis, so fan_in is H) and zero biases."""
        scale = self.hidden_dim**-0.5
        for name, param in self.named_parameters():
            if name == "proj_kernel":
                lecun_normal_(param, param.shape[1], generator)
            elif name == "proj_bias":
                param.zero_()
            else:
                param.uniform_(-scale, scale, generator=generator)

    def forward(
        self,
        stacked: torch.Tensor,  # [G, B, T, D_max]
        lengths: Optional[torch.Tensor] = None,  # [B]
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if stacked.dim() != 4 or stacked.shape[0] != self.num_groups:
            raise ValueError(
                f"Expected [G={self.num_groups}, B, T, D] input, got shape {tuple(stacked.shape)}"
            )
        if self.use_pallas and self.num_layers == 1:
            w_ih, w_hh, b_ih, b_hh = (
                getattr(self, f"{name}_l0")
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            lens = lengths.to(torch.int32) if lengths is not None else None
            if train:
                # one G-batched product feeds the differentiable recurrence kernels
                x_proj = grouped_dense(stacked, w_ih, b_ih).permute(2, 0, 1, 3).contiguous()
                trainable = (grouped_lstm_trainable if self.cell_type == "lstm"
                             else grouped_gru_trainable)
                final_state = trainable(x_proj, w_hh, b_hh, lens)
            else:
                # the whole group, input projection included, in one launch
                x = stacked.permute(2, 0, 1, 3).contiguous()  # [G,B,T,D] -> [T,G,B,D]
                w_ih, w_hh, b_ih, b_hh = (w.detach() for w in (w_ih, w_hh, b_ih, b_hh))
                # the kernels as the registered ops, which an exported graph holds
                if self.cell_type == "lstm":
                    # the LSTM's gate biases are purely additive
                    final_state = library.grouped_lstm_fused(x, w_ih, w_hh, b_ih + b_hh, lens)
                else:
                    final_state = library.grouped_gru_fused(x, w_ih, w_hh, b_ih, b_hh, lens)
        else:
            layer_input = stacked
            for layer in range(self.num_layers):
                w_ih, w_hh, b_ih, b_hh = (
                    getattr(self, f"{name}_l{layer}")
                    for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
                # one G-batched product feeds the whole loop: [G,B,T,D] x [G,D,gates*H]
                x_proj = grouped_dense(layer_input, w_ih, b_ih).permute(2, 0, 1, 3)
                last = layer == self.num_layers - 1
                final_state, outputs = rnn_scan(
                    self.cell_type, x_proj, w_hh, b_hh, lengths, return_outputs=not last)
                if not last:
                    # per-step outputs [T,G,B,H] feed the next layer as [G,B,T,H]
                    layer_input = dropout(
                        outputs.permute(1, 2, 0, 3), self.dropout, train, generator)
        dropped = dropout(final_state, self.dropout, train, generator)
        return grouped_dense(dropped, self.proj_kernel, self.proj_bias)


class GroupedTransformerEncoder(nn.Module):
    """G independent transformer encoder stacks as one pass. Input
    ``[G, B, T, D_max]`` (features zero-padded to the group's widest member),
    output ``[G, B, output_dim]``."""

    def __init__(
        self,
        num_groups: int,
        input_dim: int,
        hidden_dim: int = 256,
        output_dim: int = 128,
        num_layers: int = 2,
        dim_feedforward: int = 2048,
        dropout: float = 0.1,
        use_flash: bool = False,
        dropout_rng: str = "auto",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.num_groups = num_groups
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.num_layers = num_layers
        self.dim_feedforward = dim_feedforward
        self.dropout = dropout
        self.use_flash = use_flash
        self.dropout_rng = dropout_rng
        self.num_heads = 4 if hidden_dim % 4 == 0 else 1

        def dense(name: str, d_in: int, d_out: int) -> None:
            self.register_parameter(f"{name}_kernel",
                                    nn.Parameter(torch.zeros(num_groups, d_in, d_out)))
            self.register_parameter(f"{name}_bias", nn.Parameter(torch.zeros(num_groups, d_out)))

        dense("input_projection", input_dim, hidden_dim)
        for layer in range(num_layers):
            for name in _DENSE:
                d_in = dim_feedforward if name == "linear2" else hidden_dim
                d_out = dim_feedforward if name == "linear1" else hidden_dim
                dense(f"{name}_l{layer}", d_in, d_out)
            for name in ("norm1", "norm2"):
                self.register_parameter(f"{name}_l{layer}_scale",
                                        nn.Parameter(torch.ones(num_groups, hidden_dim)))
                self.register_parameter(f"{name}_l{layer}_bias",
                                        nn.Parameter(torch.zeros(num_groups, hidden_dim)))
        dense("proj", hidden_dim, output_dim)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``_grouped_dense_init``: G independent lecun-normal
        kernels (the group axis is a batch axis, so fan_in is ``d_in``), zero
        biases, unit LayerNorm scales."""
        for name, param in self.named_parameters():
            if name.endswith("_kernel"):
                lecun_normal_(param, param.shape[1], generator)
            elif name.endswith("_scale"):
                param.fill_(1.0)
            else:
                param.zero_()

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A layer's dense product: f32 (``dtype`` None), or in bf16 the
        product of the bf16 input and kernel rounded to bf16, then the f32
        bias added in f32 (the reference's ``einsum(x.astype(cd),
        w.astype(cd)).astype(f32) + b``)."""
        kernel, bias = getattr(self, f"{name}_kernel"), getattr(self, f"{name}_bias")
        if self.dtype is None:
            return grouped_dense(x, kernel, bias)
        return (grouped_product(x.to(self.dtype), kernel.to(self.dtype)).float()
                + _group_bias(bias, x.dim()))

    def _dense_cd(self, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The input projection's and qkv's product: f32, or in bf16 the
        product rounded to bf16, then the bf16 bias added in bf16, a second
        rounding (``einsum(...) + b.astype(cd)``)."""
        if self.dtype is None:
            return grouped_dense(x, kernel, bias)
        return (grouped_product(x.to(self.dtype), kernel.to(self.dtype))
                + _group_bias(bias, x.dim()).to(self.dtype))

    def _norm(self, name: str, r: torch.Tensor) -> torch.Tensor:
        scale, bias = getattr(self, f"{name}_scale"), getattr(self, f"{name}_bias")
        return ln_rows(r.float(), scale[:, None, None, :], bias[:, None, None, :], 1e-6)[0]

    def _attend(self, layer: int, x: torch.Tensor, lengths, valid_mask) -> torch.Tensor:
        groups, batch, seq_len, hidden = x.shape
        heads, head_dim = self.num_heads, hidden // self.num_heads
        # one G-batched [G, H, 3H] product feeds q/k/v for every member
        w_qkv = torch.cat([getattr(self, f"{n}_proj_l{layer}_kernel") for n in "qkv"], dim=2)
        b_qkv = torch.cat([getattr(self, f"{n}_proj_l{layer}_bias") for n in "qkv"], dim=1)
        qkv = self._dense_cd(x, w_qkv, b_qkv).reshape(groups, batch, seq_len, 3, heads, head_dim)
        if self.use_flash and attention_route(head_dim) == "kernel":
            # fold the group axis into the batch: one launch for the whole group
            q, k, v = (
                qkv[:, :, :, i].reshape(groups * batch, seq_len, heads, head_dim).transpose(1, 2)
                for i in range(3)
            )
            flat_lengths = lengths.to(torch.int32).repeat(groups) if lengths is not None else None
            # f32 out either way (bf16 q, k, v: the kernels on f32 copies)
            attended = flash_self_attention(q, k, v, flat_lengths).to(x.dtype)
            return attended.transpose(1, 2).reshape(groups, batch, seq_len, hidden)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
        scores = torch.einsum("gbqhd,gbkhd->gbhqk", q, k) * head_dim**-0.5
        mask = valid_mask[None, :, None, None, :] if valid_mask is not None else None
        weights = masked_softmax(scores, mask)
        return torch.einsum("gbhqk,gbkhd->gbqhd", weights, v).reshape(
            groups, batch, seq_len, hidden)

    def forward(
        self,
        stacked: torch.Tensor,  # [G, B, T, D_max]
        lengths: Optional[torch.Tensor] = None,  # [B]
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if stacked.dim() != 4 or stacked.shape[0] != self.num_groups:
            raise ValueError(
                f"Expected [G={self.num_groups}, B, T, D] input, got shape {tuple(stacked.shape)}"
            )
        groups, batch, seq_len, _ = stacked.shape
        keep_prob = 1.0 - self.dropout
        drop = train and self.dropout > 0.0
        source = resolve_dropout_rng(self.dropout_rng, stacked.device.type, self.use_flash)
        kernel_masks = drop and source == "kernel"
        if kernel_masks:
            seed = kernel_rng_seed(generator, stacked.device)  # one seed for the whole stack
            specs = ((self.hidden_dim, RNG_P_ATT), (self.dim_feedforward, RNG_P_HIDDEN),
                     (self.hidden_dim, RNG_P_RES))

        def layer_masks():
            """A layer's three masks by purpose, one launch; None: drawn one
            by one from ``torch.rand`` where they are used."""
            if not kernel_masks:
                return None
            masks = dropout_keep_masks(seed, groups * batch * seq_len, specs, keep_prob)
            return {p: m.reshape(groups, batch, seq_len, cols)
                    for (cols, p), m in zip(specs, masks)}

        def drop_where(y, cols, purpose, masks):
            if not drop:
                return y
            mask = masks[purpose] if masks is not None else keep_mask(
                (groups, batch, seq_len, cols), keep_prob, generator, stacked.device)
            return torch.where(mask.bool(), y / keep_prob, 0.0)

        valid_mask = lengths_to_mask(lengths, seq_len) if lengths is not None else None
        # in bf16 both roundings, then back to the input's type (the
        # residual stream stays f32, as the reference's does)
        x = self._dense_cd(stacked, self.input_projection_kernel,
                           self.input_projection_bias).to(stacked.dtype)
        for layer in range(self.num_layers):
            attended = self._attend(layer, x, lengths, valid_mask)
            masks = layer_masks()
            y = drop_where(self._dense(f"out_proj_l{layer}", attended), self.hidden_dim, RNG_P_ATT,
                           masks)
            x = self._norm(f"norm1_l{layer}", x + y)
            h = torch.relu(self._dense(f"linear1_l{layer}", x))
            h = drop_where(h, self.dim_feedforward, RNG_P_HIDDEN, masks)
            ff = drop_where(self._dense(f"linear2_l{layer}", h), self.hidden_dim, RNG_P_RES, masks)
            x = self._norm(f"norm2_l{layer}", x + ff)
        pooled = masked_mean_pool(
            x, valid_mask[None] if valid_mask is not None else None, dim=2, min_denom=1.0
        )  # [G, B, H]
        pooled = dropout(pooled, self.dropout, train, generator)
        return grouped_dense(pooled, self.proj_kernel, self.proj_bias)  # f32 under any dtype


def groupable_transformer_modalities(
    modalities: Sequence[str], encoder_configs: Mapping[str, Mapping[str, Any]]
) -> Tuple[List[str], Dict[str, Any]]:
    """Subset of modalities that one grouped transformer pass can encode:
    sequence-typed transformer encoders sharing (hidden_dim, num_layers,
    flash_attention, dropout_rng), none with MoE, pipeline or sequence
    parallelism. Returns ``(names, shared_config)``; names is empty when
    fewer than two qualify or their signatures differ."""
    candidates = []
    signatures = set()
    for name in modalities:
        cfg = dict(encoder_configs.get(name, {}) or {})
        if cfg.get("type", "sequence") != "sequence":
            continue
        if cfg.get("encoder_type", "lstm") != "transformer":
            continue
        if int(cfg.get("moe_experts", 0) or 0) > 0:
            continue
        if int(cfg.get("pipeline_parallel", 1) or 1) > 1:
            continue
        if bool(cfg.get("sequence_parallel", False)):
            continue
        signatures.add((
            cfg.get("hidden_dim"),
            int(cfg.get("num_layers", 2)),
            bool(cfg.get("flash_attention", False)),
            str(cfg.get("dropout_rng", "auto")),
        ))
        candidates.append(name)
    if len(candidates) >= 2 and len(signatures) == 1:
        hidden, layers, flash, drng = next(iter(signatures))
        return candidates, {"hidden_dim": hidden, "num_layers": layers,
                            "flash_attention": flash, "dropout_rng": drng}
    return [], {}


def groupable_modalities(
    modalities: Sequence[str], encoder_configs: Mapping[str, Mapping[str, Any]]
) -> Tuple[List[str], Dict[str, Any]]:
    """Subset of modalities that one grouped recurrence can encode: sequence
    encoders (by ``type``, or by the modality's name when it has none) with
    an lstm or gru cell, all sharing (cell, hidden_dim, num_layers). Returns
    ``(names, shared_config)``; names is empty when fewer than two qualify
    or their signatures differ."""
    candidates = []
    signatures = set()
    for name in modalities:
        cfg = dict(encoder_configs.get(name, {}) or {})
        etype = cfg.get("type")
        if etype is None:
            key = name.lower()
            is_seq = key in ("imu", "audio", "mocap", "accelerometer") or key.startswith("imu_")
        else:
            is_seq = etype == "sequence"
        if not is_seq:
            continue
        cell = cfg.get("encoder_type", "lstm")
        if cell not in ("lstm", "gru"):
            continue
        signatures.add((cell, cfg.get("hidden_dim"), int(cfg.get("num_layers", 2))))
        candidates.append(name)
    if len(candidates) >= 2 and len(signatures) == 1:
        cell, hidden, layers = next(iter(signatures))
        return candidates, {"encoder_type": cell, "hidden_dim": hidden, "num_layers": layers}
    return [], {}


def stack_group_features(features: Mapping[str, torch.Tensor], names: Sequence[str]) -> torch.Tensor:
    """Zero-pad each ``[B, T, D_m]`` to the group's D_max and stack to ``[G, B, T, D]``."""
    d_max = max(int(features[n].shape[-1]) for n in names)
    return torch.stack([
        nn.functional.pad(features[n], (0, d_max - features[n].shape[-1])) for n in names
    ])
