"""Masking primitives with the reference's exact fallback semantics.

Port of the JAX package's ``ops/masked.py``: masked positions get ``-inf``
scores, a fully-masked row comes out as exact zeros, and the gate weights
fall back to mask-proportional, then uniform, weights. Everything is
branch-free tensor code (no host synchronisation), so it runs unchanged on
the CPU and on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

# -inf, as in the reference's masked softmax. The attention kernels use the
# finite ``ops.attention.NEG_INF = -1e30`` instead; the two stay apart.
NEG_INF = float("-inf")


def nan_to_num(x: torch.Tensor) -> torch.Tensor:
    """NaN and +-inf -> 0."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def masked_softmax(
    scores: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    dim: int = -1,
) -> torch.Tensor:
    """Softmax with all-masked rows collapsing to exactly zero.

    ``mask`` broadcasts against ``scores``; positions where ``mask == 0`` are
    excluded. Accumulates in float32 whatever the input dtype.
    """
    out_dtype = scores.dtype
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask == 0, NEG_INF, scores)
    row_max = scores.amax(dim=dim, keepdim=True)
    safe_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    unnorm = torch.exp(scores - safe_max)
    unnorm = torch.where(torch.isfinite(scores), unnorm, 0.0)
    denom = unnorm.sum(dim=dim, keepdim=True)
    out = torch.where(
        denom > 0, unnorm / torch.where(denom > 0, denom, 1.0), 0.0
    )
    return out.to(out_dtype)


def adaptive_gate_weights(
    scores: torch.Tensor,  # [..., M] gate scores
    mask: torch.Tensor,  # [..., M] {0,1} availability mask
    num_modalities: int,
    dim: int = -1,
) -> torch.Tensor:
    """Masked-softmax gate weights with the reference's fallback math:
    softmax over available modalities, re-mask, renormalise; zero-sum rows
    fall back to mask-proportional weights, or uniform ``1/M`` when the mask
    itself is all zero."""
    mask = mask.to(scores.dtype)
    weights = masked_softmax(scores, (mask > 0).to(mask.dtype), dim=dim)
    weights = weights * mask
    return mask_renormalize(
        weights, mask, num_modalities, fallback="proportional", dim=dim
    )


def mask_renormalize(
    weights: torch.Tensor,  # [..., M] non-negative raw weights (already masked)
    mask: torch.Tensor,  # [..., M] {0,1} availability mask
    num_modalities: int,
    fallback: str = "proportional",
    dim: int = -1,
) -> torch.Tensor:
    """Renormalise masked weights with the reference's zero-row fallbacks.

    ``fallback="uniform"``: zero-sum rows get ``1/M`` everywhere.
    ``fallback="proportional"``: zero-sum rows get mask-proportional weights,
    then uniform when the mask itself is all zero.
    """
    sums = weights.sum(dim=dim, keepdim=True)
    if fallback == "uniform":
        fb = torch.full_like(weights, 1.0 / num_modalities)
    else:
        mask = mask.to(weights.dtype)
        mask_sum = mask.sum(dim=dim, keepdim=True)
        fb = torch.where(
            mask_sum > 0,
            mask / (mask_sum + 1e-8),
            torch.full_like(mask, 1.0 / num_modalities),
        )
    return torch.where(sums > 0, weights / (sums + 1e-8), fb)


def masked_mean_pool(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    dim: int = 1,
    min_denom: float = 1.0,
) -> torch.Tensor:
    """Mean over ``dim`` restricted to positions where ``mask != 0``; the
    denominator is clamped to ``min_denom`` so empty masks divide by 1."""
    if mask is None:
        return x.mean(dim=dim)
    mask = mask.to(x.dtype).unsqueeze(-1)
    total = (x * mask).sum(dim=dim)
    denom = mask.sum(dim=dim).clamp(min=min_denom)
    return total / denom


def lengths_to_mask(lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    """``[B]`` int lengths -> ``[B, T]`` float {0,1} validity mask."""
    positions = torch.arange(seq_len, device=lengths.device)[None, :]
    return (positions < lengths[:, None]).float()
