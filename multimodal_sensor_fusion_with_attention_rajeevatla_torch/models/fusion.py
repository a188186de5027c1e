"""Fusion heads, port of the JAX package's ``models/fusion.py``, in eval and
train mode, with the reference's error strings:

- ``EarlyFusion``: masked features concatenated, a 3-layer MLP (``fc0``,
  ``fc1``, ``head``), dropout after each hidden ReLU.
- ``LateFusion``: a classifier per modality (``cls_<m>_fc``,
  ``cls_<m>_head``; dropout on the masked input and on the hidden), combined
  by ``softmax(weight_logits)`` re-masked and renormalised, uniform where a
  row has no modality; returns ``(logits, per_modality_logits)``.
- ``UncertaintyFusion``: late fusion's classifiers plus a log-variance head
  per modality (``unc_<m>_head`` on the hidden before dropout, clipped to
  [-6, 6]); inverse-variance weights renormalised, mask-proportional then
  uniform where a row's weights sum to zero; returns ``(logits,
  per_modality_logits)``.
- ``HybridFusion``: per-modality projections, all-pairs cross-modal
  attention as one stacked product, mean aggregation, adaptive gated
  weighting with the reference's fallback math, 2-layer classifier (dropout
  on the features before each projection, after its ReLU, on the pair
  weights and on the classifier hidden).

The reference computes the early, late and uncertainty heads with plain
Dense layers outside any kernel; here they are ``nn.Linear``. Serving runs
the fused head kernel for ``HybridFusion`` only (``serving.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.masked import adaptive_gate_weights, mask_renormalize
from .attention import StackedPairAttention, ordered_pairs
from .encoders import dropout

_FUSION_TYPES = ("early", "late", "hybrid", "uncertainty")


def _checked_mask(head: str, names, features, modality_mask, two_d: bool = False):
    """The reference's checks of a head's inputs, in its order, and the
    modality mask (all ones by default) in the features' dtype."""
    if not names:
        raise ValueError(f"No modalities configured for {head}.")
    for name in names:
        if name not in features:
            raise KeyError(f"Missing features for modality '{name}' in {head} forward pass.")
        if two_d and features[name].dim() != 2:
            shape = tuple(features[name].shape)
            raise ValueError(f"Expected 2D tensor for modality '{name}', got shape {shape}.")
    ref = features[names[0]]
    if modality_mask is None:
        modality_mask = torch.ones((ref.shape[0], len(names)), dtype=ref.dtype, device=ref.device)
    return modality_mask.to(ref.dtype)


class EarlyFusion(nn.Module):
    """Concatenate masked modality features, classify jointly."""

    def __init__(
        self,
        modality_names: Sequence[str],
        input_dims: Mapping[str, int],
        hidden_dim: int = 256,
        num_classes: int = 11,
        dropout: float = 0.1,
    ):
        super().__init__()
        self.modality_names = tuple(modality_names)
        self.dropout = dropout
        self.fc0 = nn.Linear(sum(int(input_dims[n]) for n in self.modality_names), hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.head = nn.Linear(hidden_dim, num_classes)

    def forward(
        self,
        modality_features: Mapping[str, torch.Tensor],
        modality_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        names = self.modality_names
        mask = _checked_mask("EarlyFusion", names, modality_features, modality_mask, two_d=True)
        x = torch.cat([modality_features[n] * mask[:, i : i + 1] for i, n in enumerate(names)],
                      dim=1)
        x = dropout(torch.relu(self.fc0(x)), self.dropout, train, generator)
        x = dropout(torch.relu(self.fc1(x)), self.dropout, train, generator)
        return self.head(x)


class _PerModalityClassifiers(nn.Module):
    """The classifier per modality that late and uncertainty fusion share."""

    def __init__(self, modality_names, input_dims, hidden_dim, num_classes, dropout):
        super().__init__()
        self.modality_names = tuple(modality_names)
        self.dropout = dropout
        for name in self.modality_names:
            self.add_module(f"cls_{name}_fc", nn.Linear(int(input_dims[name]), hidden_dim))
            self.add_module(f"cls_{name}_head", nn.Linear(hidden_dim, num_classes))

    def classify(self, head: str, features, modality_mask, train, generator):
        """-> ``(mask, logits by modality, hidden by modality)``; dropout on the
        masked input and on the hidden, in the reference's order."""
        mask = _checked_mask(head, self.modality_names, features, modality_mask)
        logits, hidden = {}, {}
        for idx, name in enumerate(self.modality_names):
            masked = features[name] * mask[:, idx : idx + 1]
            h = torch.relu(getattr(self, f"cls_{name}_fc")(
                dropout(masked, self.dropout, train, generator)))
            logits[name] = getattr(self, f"cls_{name}_head")(
                dropout(h, self.dropout, train, generator))
            hidden[name] = h
        return mask, logits, hidden


class LateFusion(_PerModalityClassifiers):
    """Per-modality classifiers combined with learned masked softmax weights."""

    def __init__(
        self,
        modality_names: Sequence[str],
        input_dims: Mapping[str, int],
        hidden_dim: int = 256,
        num_classes: int = 11,
        dropout: float = 0.1,
    ):
        super().__init__(modality_names, input_dims, hidden_dim, num_classes, dropout)
        self.weight_logits = nn.Parameter(torch.zeros(len(self.modality_names)))

    def forward(
        self,
        modality_features: Mapping[str, torch.Tensor],
        modality_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mask, per_modality, _hidden = self.classify(
            "LateFusion", modality_features, modality_mask, train, generator)
        stacked = torch.stack([per_modality[n] for n in self.modality_names], dim=1)  # [B, M, C]
        weights = torch.softmax(self.weight_logits, dim=0)[None, :] * mask
        weights = mask_renormalize(weights, mask, len(self.modality_names), fallback="uniform",
                                   dim=1)
        return (stacked * weights[..., None]).sum(dim=1), per_modality


class UncertaintyFusion(_PerModalityClassifiers):
    """Late fusion weighted by learned per-sample inverse variances."""

    def __init__(
        self,
        modality_names: Sequence[str],
        input_dims: Mapping[str, int],
        hidden_dim: int = 256,
        num_classes: int = 11,
        dropout: float = 0.1,
    ):
        super().__init__(modality_names, input_dims, hidden_dim, num_classes, dropout)
        for name in self.modality_names:
            self.add_module(f"unc_{name}_head", nn.Linear(hidden_dim, 1))

    def forward(
        self,
        modality_features: Mapping[str, torch.Tensor],
        modality_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        names = self.modality_names
        mask, per_modality, hidden = self.classify(
            "UncertaintyFusion", modality_features, modality_mask, train, generator)
        stacked = torch.stack([per_modality[n] for n in names], dim=1)  # [B, M, C]
        # a bounded log-variance keeps exp(-log_var) finite
        log_var = torch.stack([
            getattr(self, f"unc_{n}_head")(hidden[n])[:, 0].clamp(-6.0, 6.0) for n in names
        ], dim=1)
        weights = mask_renormalize(torch.exp(-log_var) * mask, mask, len(names),
                                   fallback="proportional", dim=1)
        return (stacked * weights[..., None]).sum(dim=1), per_modality


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
        modality_mask = _checked_mask("HybridFusion", names, modality_features, modality_mask)
        projected = []
        for idx, name in enumerate(names):
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
    ``modality_dims`` keys define the modality order; ``num_heads`` is the
    hybrid head's only."""
    if fusion_type not in _FUSION_TYPES:
        raise ValueError(f"Unknown fusion type: {fusion_type}")
    names = tuple(modality_dims.keys())
    if fusion_type == "hybrid":
        return HybridFusion(names, modality_dims, hidden_dim, num_classes, num_heads, dropout)
    head = {"early": EarlyFusion, "late": LateFusion, "uncertainty": UncertaintyFusion}
    return head[fusion_type](names, modality_dims, hidden_dim, num_classes, dropout)
