"""The flagship model: per-modality encoders + fusion head.

Port of the JAX package's ``models/module.py``: one encoder per modality
(``SequenceEncoder``: transformer, lstm, gru or cnn; ``FrameEncoder``, which
takes the lengths as a frame mask; ``SimpleMLPEncoder``, by
``build_encoder``'s routes); with ``model.grouped_encoders`` (the default)
one ``GroupedRNNEncoder`` over the modalities whose lstm / gru encoders
share a signature, its recurrence through the kernels of
``ops/rnn.py`` in eval and in training when ``model.pallas_rnn`` is on (absent
means off, as in the reference; ``auto`` means on); with
``model.grouped_transformer`` one ``GroupedTransformerEncoder`` over the
same-signature transformer modalities; per-modality encoders for the rest; a
per-modality LayerNorm (``ln_<m>``, flax defaults), then the fusion head of
``model.fusion_type`` (early, late, hybrid or uncertainty). ``fuse`` and
``forward`` return the logits alone: the late and uncertainty heads'
``(logits, per_modality_logits)`` is cut to its first item, as the reference
does.
Weights come from ``init_parameters`` (a seeded ``torch.Generator``, the
reference's initialisers) or from a converted flax checkpoint
(``convert.from_flax_variables``). ``train=True`` runs the training forward:
dropout masks come from the ``generator`` passed along, and the transformer
layers take the fused residual-LayerNorm kernels when ``fused_mlp`` and
``fused_mlp_ln`` are on.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .attention import StackedPairAttention
from ..ops.masked import lengths_to_mask
from .encoders import (
    FrameEncoder,
    LayerNorm,
    MaskedBatchNorm,
    RNNStack,
    SimpleMLPEncoder,
    build_encoder,
    lecun_normal_,
)
from .fusion import build_fusion_model
from .grouped import (
    GroupedRNNEncoder,
    GroupedTransformerEncoder,
    groupable_modalities,
    groupable_transformer_modalities,
    stack_group_features,
)


def _parse_flag(value, name: str) -> bool:
    """An auto/bool kernel flag that may arrive as a string. ``auto`` means
    on: the kernels run wherever the tensors are on the card, and on the CPU
    the wrappers take their plain twins."""
    if isinstance(value, str):
        low = value.lower()
        if low in ("auto", "1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"Unknown {name} value {value!r}; expected auto/true/false")
    return bool(value)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's initialisation: lecun-normal kernels (stacked pair
    kernels use fan_in = P * H, as flax computes it for a ``[P, H, H]``
    shape, convolutions in * width), zero biases, unit LayerNorm and
    BatchNorm scales, BatchNorm running statistics 0 and 1, uniform recurrent
    weights. Walks modules in registration order."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            lecun_normal_(module.weight, module.in_features, generator)
            module.bias.zero_()
        elif isinstance(module, nn.Conv1d):
            lecun_normal_(module.weight, module.in_channels * module.kernel_size[0], generator)
            module.bias.zero_()
        elif isinstance(module, MaskedBatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        elif isinstance(module, StackedPairAttention):
            for name in ("query", "key", "value", "out"):
                kernel = getattr(module, f"{name}_kernel")
                lecun_normal_(kernel, kernel.shape[0] * kernel.shape[1], generator)
                getattr(module, f"{name}_bias").zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (GroupedTransformerEncoder, GroupedRNNEncoder, RNNStack)):
            module.init_parameters(generator)
    return model


class MultimodalFusionModel(nn.Module):
    """Encoders + optional LayerNorm + fusion head, config-driven."""

    def __init__(
        self,
        modalities,
        encoder_configs: Mapping[str, Mapping[str, Any]],
        fusion_type: str = "hybrid",
        output_dim: int = 128,
        hidden_dim: int = 256,
        num_heads: int = 4,
        num_classes: int = 25,
        layer_norm: bool = True,
        dropout: float = 0.1,
        grouped_encoders: bool = True,
        grouped_transformer: bool = False,
        pallas_rnn: bool = False,
    ):
        super().__init__()
        self.modalities = tuple(modalities)
        self.fusion_type = fusion_type
        self.output_dim = output_dim
        self.num_classes = num_classes
        configs = {k: dict(v) for k, v in dict(encoder_configs).items()}
        # per-modality input widths: a missing grouped modality is zero-filled
        # at its own width, not the template's
        self._grouped_dims = {
            n: int(configs.get(n, {}).get("input_dim", 64) or 64) for n in self.modalities
        }
        self.grouped_rnn_names: tuple = ()
        self.grouped_rnn_encoder = None
        if grouped_encoders:
            rnn_names, shared = groupable_modalities(self.modalities, configs)
            if rnn_names:
                self.grouped_rnn_names = tuple(rnn_names)
                self.grouped_rnn_encoder = GroupedRNNEncoder(
                    num_groups=len(rnn_names),
                    input_dim=max(self._grouped_dims[n] for n in rnn_names),
                    hidden_dim=int(shared.get("hidden_dim") or hidden_dim),
                    output_dim=output_dim,
                    num_layers=int(shared.get("num_layers") or 1),
                    cell_type=shared["encoder_type"],
                    dropout=dropout,
                    use_pallas=pallas_rnn,
                )
        self.grouped_tf_names: tuple = ()
        self.grouped_tf_encoder = None
        if grouped_encoders and grouped_transformer:
            tf_names, shared = groupable_transformer_modalities(self.modalities, configs)
            if tf_names:
                self.grouped_tf_names = tuple(tf_names)
                self.grouped_tf_encoder = GroupedTransformerEncoder(
                    num_groups=len(tf_names),
                    input_dim=max(self._grouped_dims[n] for n in tf_names),
                    hidden_dim=int(shared.get("hidden_dim") or hidden_dim),
                    output_dim=output_dim,
                    num_layers=int(shared.get("num_layers") or 2),
                    dropout=dropout,
                    use_flash=bool(shared.get("flash_attention", False)),
                    dropout_rng=str(shared.get("dropout_rng") or "auto"),
                )
        self.encoders = nn.ModuleDict(
            {
                name: build_encoder(
                    modality=name,
                    input_dim=int(configs.get(name, {}).get("input_dim", 64) or 64),
                    output_dim=output_dim,
                    encoder_config=configs.get(name, {}),
                )
                for name in self.modalities
                if name not in self.grouped_rnn_names + self.grouped_tf_names
            }
        )
        self.layer_norms = (
            nn.ModuleDict({name: LayerNorm(output_dim) for name in self.modalities})
            if layer_norm
            else None
        )
        self.fusion_model = build_fusion_model(
            fusion_type,
            {name: output_dim for name in self.modalities},
            num_classes,
            hidden_dim=hidden_dim,
            num_heads=num_heads,
            dropout=dropout,
        )

    @staticmethod
    def _scale_lengths(
        lengths: Optional[torch.Tensor], ref_len: Optional[int], this_len: int
    ) -> Optional[torch.Tensor]:
        """Rescale window valid-lengths from the first modality's time axis
        (``ref_len``) to another's, proportionally."""
        if lengths is None or ref_len is None or ref_len == this_len:
            return lengths
        scaled = torch.ceil(lengths.float() * (this_len / ref_len)).to(torch.int32)
        return scaled.clamp(0, this_len)

    def encode(
        self,
        features: Mapping[str, torch.Tensor],
        lengths: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Run every available modality through its encoder (+LayerNorm)."""
        encoded: Dict[str, torch.Tensor] = {}
        ref_len = next(
            (int(features[n].shape[1]) for n in self.modalities
             if n in features and features[n].dim() == 3),
            None,
        )
        for names_out, encoder in ((self.grouped_rnn_names, self.grouped_rnn_encoder),
                                   (self.grouped_tf_names, self.grouped_tf_encoder)):
            present = [n for n in names_out if n in features]
            if not present:
                continue
            full = features
            if len(present) < len(names_out):
                # some members missing: they are zero-filled at their own
                # feature width and their outputs discarded
                template = features[present[0]]
                full = dict(features)
                for n in names_out:
                    full.setdefault(n, template.new_zeros(
                        (*template.shape[:2], self._grouped_dims[n])))
            stacked = stack_group_features(full, names_out)
            # the members share one time axis
            grp_lengths = self._scale_lengths(lengths, ref_len, int(stacked.shape[2]))
            group_out = encoder(stacked, lengths=grp_lengths, train=train, generator=generator)
            for i, name in enumerate(names_out):
                if name not in present:
                    continue
                emb = group_out[i]
                if self.layer_norms is not None:
                    emb = self.layer_norms[name](emb)
                encoded[name] = emb
        grouped = self.grouped_rnn_names + self.grouped_tf_names
        for name in self.modalities:
            if name not in features or name in grouped:
                continue
            x = features[name]
            mod_lengths = (
                self._scale_lengths(lengths, ref_len, int(x.shape[1])) if x.dim() == 3 else lengths
            )
            encoder = self.encoders[name]
            if isinstance(encoder, FrameEncoder):
                frame_mask = (lengths_to_mask(mod_lengths, x.shape[1])
                              if mod_lengths is not None else None)
                emb = encoder(x, mask=frame_mask, train=train, generator=generator)
            elif isinstance(encoder, SimpleMLPEncoder):
                emb = encoder(x, train=train, generator=generator)
            else:
                emb = encoder(x, lengths=mod_lengths, train=train, generator=generator)
            if self.layer_norms is not None:
                emb = self.layer_norms[name](emb)
            encoded[name] = emb
        return encoded

    def fuse(
        self,
        encoded: Mapping[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_attention: bool = False,
    ):
        """Fusion head over pre-encoded embeddings -> logits, or
        ``(logits, attention_info)`` with ``return_attention`` (hybrid only).
        A head's tuple output (late, uncertainty) gives its logits."""
        if return_attention:
            if self.fusion_type != "hybrid":
                raise ValueError("Attention information is only available for HybridFusion.")
            return self.fusion_model(
                encoded, mask, train=train, generator=generator, return_attention=True
            )
        output = self.fusion_model(encoded, mask, train=train, generator=generator)
        return output[0] if isinstance(output, tuple) else output

    def forward(
        self,
        features: Mapping[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_attention: bool = False,
    ):
        """Logits ``[B, C]``. With ``train=True`` every dropout mask comes
        from ``generator`` (on the inputs' device), encoders first, in a
        fixed order, so two runs with equally seeded generators make the
        same masks whichever compute kernels they take."""
        encoded = self.encode(features, lengths=lengths, train=train, generator=generator)
        return self.fuse(encoded, mask=mask, train=train, generator=generator,
                         return_attention=return_attention)

    @classmethod
    def from_config(
        cls,
        config,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> "MultimodalFusionModel":
        """Build from the YAML config tree (same keys as the reference), with
        weights from ``generator`` (default: seeded with ``config.seed``), on
        ``device`` (default ``cuda``; raises without it unless ``"cpu"``).
        Returns the model in eval mode."""
        device = resolve_device(device)
        model_cfg = config.model
        dataset_cfg = config.dataset
        modalities = tuple(dataset_cfg.modalities)
        unsupported = {
            "mixed_precision": bool(config.get("mixed_precision", False)),
            "model.moe_experts": int(model_cfg.get("moe_experts", 0) or 0) > 0,
            "parallel.pipeline_parallel": int(
                (config.get("parallel", {}) or {}).get("pipeline_parallel", 1) or 1
            ) > 1,
        }
        for key, on in unsupported.items():
            if on:
                raise NotImplementedError(f"{key} is not ported yet (see ROADMAP.md)")
        flags = {
            key: _parse_flag(model_cfg.get(key, "auto"), key)
            for key in ("flash_attention", "fused_mlp", "fused_mlp_ln")
        }
        pallas_rnn = _parse_flag(model_cfg.get("pallas_rnn", False), "pallas_rnn")
        dropout = float(model_cfg.get("dropout", 0.1))
        train_cfg = config.get("training", {}) or {}
        dropout_rng = str(train_cfg.get("dropout_rng", "auto") or "auto").lower()
        if dropout_rng not in ("auto", "xla", "kernel"):
            raise ValueError(
                f"Unknown training.dropout_rng {dropout_rng!r}; expected auto, xla or kernel"
            )
        all_encoder_cfg = model_cfg.get("encoders", {}) or {}
        enc_cfgs = {}
        for name in modalities:
            raw = all_encoder_cfg.get(name, {}) or {}
            cfg = dict(raw.items())
            cfg.setdefault("hidden_dim", int(model_cfg.get("hidden_dim", 256)))
            cfg.setdefault("dropout", dropout)
            if cfg.get("encoder_type") == "transformer":
                for key, value in flags.items():
                    cfg[key] = _parse_flag(cfg.get(key, value), key)
                cfg.setdefault("dropout_rng", dropout_rng)
                # read by the grouping rule only: such encoders stay ungrouped
                cfg.setdefault("sequence_parallel", bool(
                    (config.get("parallel", {}) or {}).get("sequence_parallel", False)))
            enc_cfgs[name] = cfg
        model = cls(
            modalities=modalities,
            encoder_configs=enc_cfgs,
            fusion_type=str(model_cfg.get("fusion_type", "hybrid")),
            output_dim=int(model_cfg.get("output_dim", 128)),
            hidden_dim=int(model_cfg.get("hidden_dim", 256)),
            num_heads=int(model_cfg.get("num_heads", 4)),
            num_classes=int(dataset_cfg.get("num_classes", 11)),
            layer_norm=bool(model_cfg.get("layer_norm", True)),
            dropout=dropout,
            grouped_encoders=bool(model_cfg.get("grouped_encoders", True)),
            grouped_transformer=bool(model_cfg.get("grouped_transformer", False)),
            pallas_rnn=pallas_rnn,
        )
        if generator is None:
            generator = torch.Generator().manual_seed(int(config.get("seed", 0) or 0))
        init_parameters(model, generator)
        return model.to(device).eval()
