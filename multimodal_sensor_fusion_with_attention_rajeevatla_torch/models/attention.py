"""Attention modules, port of the JAX package's ``models/attention.py``.

- ``ordered_pairs`` and ``StackedPairAttention``: every ordered modality pair
  in one stacked product, the hybrid head's attention (the kernel route is
  ``ops.fusion``).
- ``CrossModalAttention``: modality A attends to modality B, separate query
  and key / value inputs, 2-D or 3-D (a 2-D input is a length-1 sequence and
  comes back 2-D; with 2-D keys the weights are ``[B, heads, q_len, 1]``); a
  query whose keys are all masked gets zero weights.
- ``TemporalAttention``: self-attention over time steps with a padding mask
  (``[B, T]`` or ``[T]``; masked steps come out zero) and ``pool_sequence``.
- ``PairwiseModalityAttention``: the per-modality projections
  (``projections.<m>``, the reference's ``proj_<m>``) and a
  ``StackedPairAttention`` (``pairs``), each modality the mean of itself and
  what it attended to, masked where it is missing.
- ``visualize_attention``: a heatmap (matplotlib's ``Agg``, imported when
  called).

The last four are plain modules with no kernel, as in the reference; no model
route calls them. Their linear layers are ``nn.Linear`` under the
reference's names (``query_proj``, ``key_proj``, ``value_proj``,
``out_proj``), so ``convert.from_flax_variables`` loads the reference's
trees; with ``dtype`` bfloat16 each product and bias is rounded as flax's
``Dense(dtype=bfloat16)`` does (``encoders.dense``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.masked import masked_softmax
from .encoders import dense, dropout, resolve_dtype


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


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    batch, length, hidden = x.shape
    return x.reshape(batch, length, num_heads, hidden // num_heads)


class CrossModalAttention(nn.Module):
    """Modality A attends to modality B -> ``(attended, weights)``
    (reference ``CrossModalAttention``; module docstring)."""

    def __init__(self, query_dim: int, key_dim: int, hidden_dim: int = 256, num_heads: int = 4,
                 dropout: float = 0.1, dtype=None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim ({hidden_dim}) must be divisible by "
                             f"num_heads ({num_heads})")
        self.hidden_dim, self.num_heads, self.dropout = hidden_dim, num_heads, dropout
        self.dtype = resolve_dtype(dtype)
        self.query_proj = nn.Linear(query_dim, hidden_dim)
        self.key_proj = nn.Linear(key_dim, hidden_dim)
        self.value_proj = nn.Linear(key_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        squeeze_query, squeeze_key = query.dim() == 2, key.dim() == 2
        query = query[:, None] if squeeze_query else query
        key = key[:, None] if squeeze_key else key
        value = value[:, None] if value.dim() == 2 else value
        batch, q_len = query.shape[:2]
        head_dim = self.hidden_dim // self.num_heads
        q = _heads(dense(self.query_proj, query, self.dtype), self.num_heads)
        k = _heads(dense(self.key_proj, key, self.dtype), self.num_heads)
        v = _heads(dense(self.value_proj, value, self.dtype), self.num_heads)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * head_dim**-0.5
        if mask is not None:
            mask = (mask[:, None] if mask.dim() == 1 else mask)[:, None, None, :]
        weights = dropout(masked_softmax(scores, mask), self.dropout, train, generator)
        attended = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
        attended = dense(self.out_proj, attended.reshape(batch, q_len, self.hidden_dim),
                         self.dtype)
        if squeeze_query:
            attended = attended[:, 0]
        if squeeze_key:
            weights = weights[..., :1]
        return attended, weights


class TemporalAttention(nn.Module):
    """Self-attention over time steps -> ``(attended [B, T, H], weights
    [B, heads, T, T])`` (reference ``TemporalAttention``)."""

    def __init__(self, input_dim: int, hidden_dim: int = 256, num_heads: int = 4,
                 dropout: float = 0.1, dtype=None):
        super().__init__()
        self.hidden_dim, self.num_heads, self.dropout = hidden_dim, num_heads, dropout
        self.dtype = resolve_dtype(dtype)
        self.query_proj = nn.Linear(input_dim, hidden_dim)
        self.key_proj = nn.Linear(input_dim, hidden_dim)
        self.value_proj = nn.Linear(input_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, sequence: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        batch, seq_len, _ = sequence.shape
        head_dim = self.hidden_dim // self.num_heads
        q = _heads(dense(self.query_proj, sequence, self.dtype), self.num_heads)
        k = _heads(dense(self.key_proj, sequence, self.dtype), self.num_heads)
        v = _heads(dense(self.value_proj, sequence, self.dtype), self.num_heads)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * head_dim**-0.5
        if mask is not None and mask.dim() == 1:
            mask = mask[None, :]
        weights = masked_softmax(scores, None if mask is None else mask[:, None, None, :])
        weights = dropout(weights, self.dropout, train, generator)
        attended = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
        attended = dense(self.out_proj, attended.reshape(batch, seq_len, self.hidden_dim),
                         self.dtype)
        if mask is not None:
            attended = attended * mask[..., None].to(attended.dtype)
        return attended, weights

    @staticmethod
    def pool_sequence(sequence: torch.Tensor, attention_weights: torch.Tensor) -> torch.Tensor:
        """The weights collapsed into a distribution over time steps, and
        ``[B, T, D] -> [B, D]`` pooled by it."""
        if attention_weights.dim() != 4:
            raise ValueError("Expected attention weights with 4 dims, got "
                             f"{tuple(attention_weights.shape)}")
        pooling = attention_weights.mean(dim=1).mean(dim=1)  # [B, T]
        pooling = pooling / (pooling.sum(dim=1, keepdim=True) + 1e-8)
        return torch.einsum("bt,btd->bd", pooling, sequence)


class PairwiseModalityAttention(nn.Module):
    """Pairwise attention across modalities -> ``(attended features by
    modality, attention maps by "<q>_to_<k>")`` (reference
    ``PairwiseModalityAttention``)."""

    def __init__(self, modality_dims: Mapping[str, int], hidden_dim: int = 256,
                 num_heads: int = 4, dropout: float = 0.1, dtype=None):
        super().__init__()
        self.names = list(modality_dims)
        if not self.names:
            raise ValueError("No modalities provided for PairwiseModalityAttention.")
        self.dropout = dropout
        self.dtype = resolve_dtype(dtype)
        self.projections = nn.ModuleDict(
            {name: nn.Linear(int(dim), hidden_dim) for name, dim in modality_dims.items()})
        self.pairs = StackedPairAttention(len(self.names), hidden_dim, num_heads, dropout,
                                          self.dtype)

    def forward(self, modality_features: Mapping[str, torch.Tensor],
                modality_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        names = self.names
        first = modality_features[names[0]]
        if modality_mask is None:
            modality_mask = torch.ones((first.shape[0], len(names)), device=first.device)
        modality_mask = modality_mask.to(first.dtype)
        stacked = torch.stack([
            dropout(torch.relu(dense(self.projections[n], modality_features[n], self.dtype)),
                    self.dropout, train, generator)
            for n in names])  # [M, B, H]
        attended, weights = self.pairs(stacked, modality_mask, train=train, generator=generator)
        pairs = ordered_pairs(names)
        aggregated = []
        for qi in range(len(names)):  # the mean of itself and what it attended to
            parts = [stacked[qi]] + [attended[p] for p, (q, _k) in enumerate(pairs) if q == qi]
            aggregated.append(torch.stack(parts).mean(dim=0))
        agg = torch.stack(aggregated) * modality_mask.t()[:, :, None].to(stacked.dtype)
        features = {name: agg[i] for i, name in enumerate(names)}
        maps = {f"{names[qi]}_to_{names[ki]}": weights[p] for p, (qi, ki) in enumerate(pairs)}
        return features, maps


def visualize_attention(attention_weights, modality_names: Sequence[str],
                        save_path: Optional[Path | str] = None) -> None:
    """Attention weights as a 2-D heatmap, query modality by key modality,
    leading dims averaged (reference ``visualize_attention``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(attention_weights, torch.Tensor):
        attention_weights = attention_weights.detach().float().cpu().numpy()
    heatmap = np.asarray(attention_weights, dtype=np.float32)
    if heatmap.ndim == 0:
        heatmap = heatmap[None]
    if heatmap.ndim == 1:
        heatmap = heatmap[None, :]
    while heatmap.ndim > 2:
        heatmap = heatmap.mean(axis=0)
    fig, ax = plt.subplots(figsize=(4 + 0.5 * heatmap.shape[1], 4))
    im = ax.imshow(heatmap, cmap="viridis", aspect="auto")
    num_queries, num_keys = heatmap.shape
    ax.set_xticks(np.arange(num_keys))
    ax.set_yticks(np.arange(num_queries))
    ax.set_xticklabels(list(modality_names)[:num_keys], rotation=45, ha="right")
    ax.set_yticklabels(list(modality_names)[:num_queries])
    ax.set_xlabel("Key Modality")
    ax.set_ylabel("Query Modality")
    ax.set_title("Cross-Modal Attention Weights")
    plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    plt.tight_layout()
    if save_path is not None:
        output_path = Path(save_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(output_path, dpi=300, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
