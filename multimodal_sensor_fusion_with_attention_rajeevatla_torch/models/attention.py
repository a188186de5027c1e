"""Cross-modal pair attention, port of the JAX package's ``models/attention.py``.

Ported: ``ordered_pairs`` and ``StackedPairAttention``. ``CrossModalAttention``,
``TemporalAttention``, ``PairwiseModalityAttention`` and ``visualize_attention``
are queued (ROADMAP queue A5); no model route calls them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.masked import masked_softmax
from .encoders import dropout


def ordered_pairs(names: Sequence) -> list[Tuple[int, int]]:
    """All ordered (query, key) index pairs, query-major (reference order)."""
    n = len(names)
    return [(qi, ki) for qi in range(n) for ki in range(n) if qi != ki]


class StackedPairAttention(nn.Module):
    """All M(M-1) cross-modal pairs as stacked batched matmuls.

    Each ordered pair owns independent Q/K/V/out projections, stored stacked
    as ``[P, H, H]`` in the reference's ``[in, out]`` layout (the converter
    copies them as they are). Inputs are the projected per-modality
    embeddings ``[M, B, H]``; outputs are the per-pair attended features
    ``[P, B, H]`` and the per-pair attention weights ``[P, B, heads, 1, 1]``
    (pooled embeddings are length-1 sequences). In train mode the pair
    weights take dropout, as in the reference. With ``dtype`` bfloat16 the
    stacked weights and the input are cast to bf16 and every product,
    bias and score is rounded to bf16, as the reference computes them; the
    softmax runs in f32.
    """

    def __init__(
        self, num_modalities: int, hidden_dim: int = 256, num_heads: int = 4,
        dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.num_modalities = num_modalities
        self.dropout = dropout
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.pairs = ordered_pairs(range(num_modalities))
        num_pairs = len(self.pairs)
        for name in ("query", "key", "value", "out"):
            self.register_parameter(
                f"{name}_kernel", nn.Parameter(torch.zeros(num_pairs, hidden_dim, hidden_dim))
            )
            self.register_parameter(
                f"{name}_bias", nn.Parameter(torch.zeros(num_pairs, hidden_dim))
            )

    def forward(
        self,
        stacked: torch.Tensor,  # [M, B, H]
        modality_mask: torch.Tensor,  # [B, M]
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        num_pairs = len(self.pairs)
        batch = stacked.shape[1]
        head_dim = self.hidden_dim // self.num_heads
        if num_pairs == 0:
            return (
                stacked.new_zeros((0, batch, self.hidden_dim)),
                stacked.new_zeros((0, batch, self.num_heads, 1, 1)),
            )
        params = {name: (getattr(self, f"{name}_kernel"), getattr(self, f"{name}_bias"))
                  for name in ("query", "key", "value", "out")}
        if self.dtype is not None:  # params stored f32, computed in bf16
            params = {n: (w.to(self.dtype), b.to(self.dtype)) for n, (w, b) in params.items()}
            stacked = stacked.to(self.dtype)

        def project(x, name):
            w, b = params[name]
            return torch.einsum("pbh,phk->pbk", x, w) + b[:, None, :]

        q_idx = torch.tensor([p[0] for p in self.pairs], device=stacked.device)
        k_idx = torch.tensor([p[1] for p in self.pairs], device=stacked.device)
        q_in = stacked.index_select(0, q_idx)  # [P, B, H]
        k_in = stacked.index_select(0, k_idx)
        q, k, v = project(q_in, "query"), project(k_in, "key"), project(k_in, "value")
        qh = q.reshape(num_pairs, batch, self.num_heads, head_dim)
        kh = k.reshape(num_pairs, batch, self.num_heads, head_dim)
        scores = (qh * kh).sum(-1) * head_dim**-0.5  # [P, B, heads]
        key_mask = modality_mask.t().index_select(0, k_idx)  # [P, B]
        # softmax over a single key: weight 1 where the key is available, else 0
        weights = masked_softmax(scores[..., None], key_mask[:, :, None, None], dim=-1)
        weights = dropout(weights, self.dropout, train, generator)
        attended = weights * v.reshape(num_pairs, batch, self.num_heads, head_dim)
        attended = project(attended.reshape(num_pairs, batch, self.hidden_dim), "out")
        return attended, weights[..., None]
