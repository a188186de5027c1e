"""Fusion heads, port of the JAX package's ``models/fusion.py`` (eval mode).

Ported: ``HybridFusion`` (per-modality projections, all-pairs cross-modal
attention as one stacked product, mean aggregation, adaptive gated weighting
with the reference's fallback math, 2-layer classifier). ``EarlyFusion``,
``LateFusion`` and ``UncertaintyFusion`` are queued (ROADMAP queue A item 10).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..ops.masked import adaptive_gate_weights
from .attention import StackedPairAttention, ordered_pairs

_FUSION_TYPES = ("early", "late", "hybrid", "uncertainty")


class HybridFusion(nn.Module):
    """Cross-modal attention + adaptive gated weighting (the flagship head)."""

    def __init__(
        self,
        modality_names: Sequence[str],
        input_dims: Mapping[str, int],
        hidden_dim: int = 256,
        num_classes: int = 11,
        num_heads: int = 4,
    ):
        super().__init__()
        self.modality_names = tuple(modality_names)
        names = self.modality_names
        self.projections = nn.ModuleDict(
            {name: nn.Linear(int(input_dims[name]), hidden_dim) for name in names}
        )
        self.pairs = StackedPairAttention(len(names), hidden_dim, num_heads)
        self.gates = nn.ModuleDict({name: nn.Linear(hidden_dim, 1) for name in names})
        self.classifier_hidden = nn.Linear(hidden_dim, hidden_dim)
        self.classifier_out = nn.Linear(hidden_dim, num_classes)

    def forward(
        self,
        modality_features: Mapping[str, torch.Tensor],
        modality_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        names = self.modality_names
        if not names:
            raise ValueError("No modalities configured for HybridFusion.")
        first = names[0]
        if first not in modality_features:
            raise KeyError(
                f"Missing features for modality '{first}' in HybridFusion forward pass."
            )
        ref = modality_features[first]
        if modality_mask is None:
            modality_mask = torch.ones(
                (ref.shape[0], len(names)), dtype=ref.dtype, device=ref.device
            )
        modality_mask = modality_mask.to(ref.dtype)

        projected = []
        for idx, name in enumerate(names):
            if name not in modality_features:
                raise KeyError(
                    f"Missing features for modality '{name}' in HybridFusion forward pass."
                )
            feats = modality_features[name] * modality_mask[:, idx : idx + 1]
            projected.append(torch.relu(self.projections[name](feats)))
        stacked = torch.stack(projected, dim=0)  # [M, B, H]

        attended, _weights = self.pairs(stacked, modality_mask)
        per_query: Dict[int, list] = {}
        for pair_idx, (qi, _ki) in enumerate(ordered_pairs(names)):
            per_query.setdefault(qi, []).append(pair_idx)
        aggregated = []
        for qi in range(len(names)):
            contributions = [stacked[qi]] + [attended[p] for p in per_query.get(qi, [])]
            aggregated.append(torch.stack(contributions, dim=0).mean(dim=0))
        agg = torch.stack(aggregated, dim=0) * modality_mask.t()[:, :, None]  # [M, B, H]

        fusion_weights = self.compute_adaptive_weights(
            {name: agg[i] for i, name in enumerate(names)}, modality_mask
        )
        fused = (agg.transpose(0, 1) * fusion_weights[..., None]).sum(dim=1)
        return self.classifier_out(torch.relu(self.classifier_hidden(fused)))

    def compute_adaptive_weights(
        self,
        modality_features: Mapping[str, torch.Tensor],
        modality_mask: torch.Tensor,
    ) -> torch.Tensor:
        """Masked-softmax gate weights with the reference's fallback math."""
        if modality_mask is None:
            raise ValueError("modality_mask must be provided for adaptive weighting.")
        scores = []
        for name in self.modality_names:
            if name not in modality_features:
                raise KeyError(f"Missing aggregated features for modality '{name}'.")
            scores.append(self.gates[name](modality_features[name]))
        score_tensor = torch.cat(scores, dim=1)  # [B, M]
        mask = modality_mask.to(score_tensor.dtype)
        return adaptive_gate_weights(score_tensor, mask, len(self.modality_names), dim=1)


def build_fusion_model(
    fusion_type: str,
    modality_dims: Mapping[str, int],
    num_classes: int,
    hidden_dim: int = 256,
    num_heads: int = 4,
) -> nn.Module:
    """Factory mirroring the reference's ``build_fusion_model``;
    ``modality_dims`` keys define the modality order."""
    if fusion_type not in _FUSION_TYPES:
        raise ValueError(f"Unknown fusion type: {fusion_type}")
    if fusion_type != "hybrid":
        raise NotImplementedError(
            f"fusion_type={fusion_type!r} is not ported yet (ROADMAP queue A item 10)"
        )
    return HybridFusion(
        modality_names=tuple(modality_dims.keys()),
        input_dims=modality_dims,
        hidden_dim=hidden_dim,
        num_classes=num_classes,
        num_heads=num_heads,
    )
