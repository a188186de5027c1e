"""Fusion heads, port of the JAX package's ``models/fusion.py``.

Ported: ``HybridFusion`` (per-modality projections, all-pairs cross-modal
attention as one stacked product, mean aggregation, adaptive gated weighting
with the reference's fallback math, 2-layer classifier), in eval and train
mode (dropout on the features before each projection, after its ReLU, on
the pair weights and on the classifier hidden). ``EarlyFusion``,
``LateFusion`` and ``UncertaintyFusion`` are queued (ROADMAP queue A item 10).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..ops.masked import adaptive_gate_weights
from .attention import StackedPairAttention, ordered_pairs
from .encoders import dropout

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
        dropout: float = 0.1,
    ):
        super().__init__()
        self.modality_names = tuple(modality_names)
        self.dropout = dropout
        names = self.modality_names
        self.projections = nn.ModuleDict(
            {name: nn.Linear(int(input_dims[name]), hidden_dim) for name in names}
        )
        self.pairs = StackedPairAttention(len(names), hidden_dim, num_heads, dropout)
        self.gates = nn.ModuleDict({name: nn.Linear(hidden_dim, 1) for name in names})
        self.classifier_hidden = nn.Linear(hidden_dim, hidden_dim)
        self.classifier_out = nn.Linear(hidden_dim, num_classes)

    def forward(
        self,
        modality_features: Mapping[str, torch.Tensor],
        modality_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_attention: bool = False,
    ):
        """Logits ``[B, C]``; with ``return_attention`` also a dict of the
        per-pair attention weights (``attention_maps``, keyed
        ``<query>_to_<key>``) and the gate weights (``fusion_weights``)."""
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
            x = self.projections[name](dropout(feats, self.dropout, train, generator))
            projected.append(dropout(torch.relu(x), self.dropout, train, generator))
        stacked = torch.stack(projected, dim=0)  # [M, B, H]

        attended, pair_weights = self.pairs(stacked, modality_mask, train, generator)
        pairs = ordered_pairs(names)
        per_query: Dict[int, list] = {}
        for pair_idx, (qi, _ki) in enumerate(pairs):
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
        hidden = torch.relu(self.classifier_hidden(fused))
        logits = self.classifier_out(dropout(hidden, self.dropout, train, generator))
        if return_attention:
            attention_maps = {
                f"{names[qi]}_to_{names[ki]}": pair_weights[p] for p, (qi, ki) in enumerate(pairs)
            }
            return logits, {"attention_maps": attention_maps, "fusion_weights": fusion_weights}
        return logits

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
    dropout: float = 0.1,
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
        dropout=dropout,
    )
