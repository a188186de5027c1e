"""The flagship model: per-modality encoders + fusion head (eval mode).

Port of the JAX package's ``models/module.py`` for the ungrouped-transformer,
hybrid-fusion configuration that ``config/base.yaml`` builds: one
``SequenceEncoder`` per modality, a per-modality LayerNorm (``ln_<m>``, flax
defaults), then ``HybridFusion``. Weights come from ``init_parameters`` (a
seeded ``torch.Generator``, flax's initialisers) or from a converted flax
checkpoint (``convert.from_flax_variables``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .attention import StackedPairAttention
from .encoders import LayerNorm, build_encoder, lecun_normal_
from .fusion import build_fusion_model


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
    """flax initialisation: lecun-normal kernels (stacked pair kernels use
    fan_in = P * H, as flax computes it for a ``[P, H, H]`` shape), zero
    biases, unit LayerNorm scales. Walks modules in registration order."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            lecun_normal_(module.weight, module.in_features, generator)
            module.bias.zero_()
        elif isinstance(module, StackedPairAttention):
            for name in ("query", "key", "value", "out"):
                kernel = getattr(module, f"{name}_kernel")
                lecun_normal_(kernel, kernel.shape[0] * kernel.shape[1], generator)
                getattr(module, f"{name}_bias").zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model


class MultimodalFusionModel(nn.Module):
    """Encoders + optional LayerNorm + fusion head, config-driven (eval mode)."""

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
    ):
        super().__init__()
        self.modalities = tuple(modalities)
        self.fusion_type = fusion_type
        self.output_dim = output_dim
        self.num_classes = num_classes
        configs = {k: dict(v) for k, v in dict(encoder_configs).items()}
        self.encoders = nn.ModuleDict(
            {
                name: build_encoder(
                    modality=name,
                    input_dim=int(configs.get(name, {}).get("input_dim", 64) or 64),
                    output_dim=output_dim,
                    encoder_config=configs.get(name, {}),
                )
                for name in self.modalities
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
    ) -> Dict[str, torch.Tensor]:
        """Run every available modality through its encoder (+LayerNorm)."""
        encoded: Dict[str, torch.Tensor] = {}
        ref_len = next(
            (int(features[n].shape[1]) for n in self.modalities
             if n in features and features[n].dim() == 3),
            None,
        )
        for name in self.modalities:
            if name not in features:
                continue
            x = features[name]
            mod_lengths = (
                self._scale_lengths(lengths, ref_len, int(x.shape[1])) if x.dim() == 3 else lengths
            )
            emb = self.encoders[name](x, lengths=mod_lengths)
            if self.layer_norms is not None:
                emb = self.layer_norms[name](emb)
            encoded[name] = emb
        return encoded

    def fuse(
        self, encoded: Mapping[str, torch.Tensor], mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Fusion head over pre-encoded embeddings -> logits."""
        return self.fusion_model(encoded, mask)

    def forward(
        self,
        features: Mapping[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self.fuse(self.encode(features, lengths=lengths), mask=mask)

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
            "model.grouped_transformer": bool(model_cfg.get("grouped_transformer", False)),
            "model.moe_experts": int(model_cfg.get("moe_experts", 0) or 0) > 0,
            "parallel.pipeline_parallel": int(
                (config.get("parallel", {}) or {}).get("pipeline_parallel", 1) or 1
            ) > 1,
        }
        for key, on in unsupported.items():
            if on:
                raise NotImplementedError(f"{key} is not ported yet (see ROADMAP.md)")
        flash = _parse_flag(model_cfg.get("flash_attention", "auto"), "flash_attention")
        all_encoder_cfg = model_cfg.get("encoders", {}) or {}
        enc_cfgs = {}
        for name in modalities:
            raw = all_encoder_cfg.get(name, {}) or {}
            cfg = dict(raw.items())
            cfg.setdefault("hidden_dim", int(model_cfg.get("hidden_dim", 256)))
            if cfg.get("encoder_type") == "transformer":
                cfg["flash_attention"] = _parse_flag(
                    cfg.get("flash_attention", flash), "flash_attention"
                )
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
        )
        if generator is None:
            generator = torch.Generator().manual_seed(int(config.get("seed", 0) or 0))
        init_parameters(model, generator)
        return model.to(device).eval()
