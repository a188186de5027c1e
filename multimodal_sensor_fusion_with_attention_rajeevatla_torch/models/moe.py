"""Mixture-of-Experts feed-forward, port of the JAX package's ``models/moe.py``.

``MoEFeedForward`` takes the place of the dense feed-forward inside the
transformer encoder layer (``model.moe_experts > 0``): a router and E expert
FFWs ``relu(x @ w1_e + b1_e) @ w2_e + b2_e`` with top-k routing at a fixed
per-expert capacity (``moe_capacity``, the GShard / Switch recipe), so every
shape depends on the token count alone and never on the routing.

- **Routing** in f32: router logits and softmax, the top-k experts of each
  token (ties to the lower expert index, as ``lax.top_k``), the gates
  renormalised over the k slots and zeroed on padded steps. A (token, slot)
  takes the next free position of its expert by an integer cumsum; slot 0
  claims positions for every token before slot 1 does (the per-expert count
  carried across slots), so positions are unique. A (token, slot) at or past
  the capacity, or on a padded step, is dropped.
- **Dispatch** is an ``index_copy`` into an ``[E * C + 1, H]`` buffer whose
  last row takes every dropped (token, slot) (the reference's scatter
  ``mode="drop"``); **combine** an ``index_select`` from the expert outputs
  with a zero row appended (its gather ``mode="fill"``), the gates' weighted
  sum in f32. A padded step's output is exactly zero.
- **Experts**: the stacked ``[E, H, F]`` / ``[E, F, H]`` weights in the
  reference's layout, so both products are one ``torch.baddbmm`` over the
  expert axis with no transpose (a plain library product, as the reference
  leaves its einsums to XLA). Dropout between them draws from the caller's
  ``torch.Generator`` with plain ``torch.rand`` whatever the layer's mask
  source, as the reference's MoE keeps its own draws.
- **bf16** (``dtype``): the buffer, both products and both biases in bf16
  (each product rounded, then the bf16 bias added, a second rounding), the
  routing in f32, the combine summed in f32 and returned in x's type.
- **Aux loss**: the Switch load-balance loss ``E * sum_e f_e * P_e`` over the
  valid tokens (f_e the share of tokens whose first choice is e, P_e the
  mean router probability of e). ``forward`` returns it beside the output:
  the caller decides where it goes, and nothing is kept on the module, so a
  recomputed forward (``training.remat``) cannot count it twice.

Parameter names and layouts are the reference's: ``router [H, E]``,
``moe_w1 [E, H, F]``, ``moe_b1 [E, F]``, ``moe_w2 [E, F, H]``,
``moe_b2 [E, H]``, each initialised uniform in +-1/sqrt(fan) (H for the
router and the first expert layer, F for the second).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def moe_capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-expert token capacity, rounded up to a multiple of 8 (the
    reference's rule, kept exactly: it decides which tokens are dropped)."""
    c = int(-(-top_k * num_tokens * capacity_factor // num_experts))
    c = max(8, ((c + 7) // 8) * 8)
    return min(c, max(8, ((top_k * num_tokens + 7) // 8) * 8))


class MoEFeedForward(nn.Module):
    """Top-k routed expert FFW, ``[B, T, H] -> ([B, T, H], aux)``; the caller
    keeps the residual and the LayerNorm (module docstring)."""

    def __init__(self, hidden_dim: int, dim_feedforward: int = 2048, num_experts: int = 4,
                 top_k: int = 2, capacity_factor: float = 1.25, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"moe_top_k ({top_k}) must be in [1, moe_experts={num_experts}]")
        self.hidden_dim = hidden_dim
        self.dim_feedforward = dim_feedforward
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dropout = dropout
        self.dtype = dtype
        e, h, f = num_experts, hidden_dim, dim_feedforward
        self.router = nn.Parameter(torch.zeros(h, e))
        self.moe_w1 = nn.Parameter(torch.zeros(e, h, f))
        self.moe_b1 = nn.Parameter(torch.zeros(e, f))
        self.moe_w2 = nn.Parameter(torch.zeros(e, f, h))
        self.moe_b2 = nn.Parameter(torch.zeros(e, h))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The reference's initialisers: uniform in +-H^-0.5 for the router,
        ``moe_w1`` and ``moe_b1``, +-F^-0.5 for ``moe_w2`` and ``moe_b2``."""
        for param, fan in ((self.router, self.hidden_dim), (self.moe_w1, self.hidden_dim),
                           (self.moe_b1, self.hidden_dim), (self.moe_w2, self.dim_feedforward),
                           (self.moe_b2, self.dim_feedforward)):
            param.uniform_(-fan**-0.5, fan**-0.5, generator=generator)

    def route(self, tokens: torch.Tensor, valid: torch.Tensor):
        """The routing of ``tokens [N, H]`` with ``valid [N]`` (bool) ->
        ``(probs [N, E] f32, gates [N, K] f32, expert [N, K], addr [N, K],
        keep [N, K], capacity)``: ``addr`` is a (token, slot)'s row of the
        ``[E * C, H]`` expert buffer, ``E * C`` where it is dropped."""
        n_tokens = tokens.shape[0]
        num_e, k_slots = self.num_experts, self.top_k
        probs = torch.softmax(tokens.float() @ self.router, dim=-1)
        # a stable descending sort: equal probabilities keep the lower expert first
        gates, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, expert = gates[:, :k_slots], expert[:, :k_slots]
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        gates = gates * valid[:, None]
        cap = moe_capacity(n_tokens, num_e, k_slots, self.capacity_factor)
        live = valid.long()[None, :]
        base = torch.zeros((num_e, 1), dtype=torch.long, device=tokens.device)
        addrs, keeps = [], []
        for slot in range(k_slots):
            # expert-major [E, N], so the cumsum runs along the contiguous
            # token axis (a scan down the tokens of an [N, E] tensor keeps
            # one thread a column on the card)
            onehot = F.one_hot(expert[:, slot], num_e).t().contiguous() * live
            pos = ((onehot.cumsum(1) - onehot + base) * onehot).sum(0)
            base = base + onehot.sum(1, keepdim=True)
            keep = (pos < cap) & valid
            addrs.append(torch.where(keep, expert[:, slot] * cap + pos, num_e * cap))
            keeps.append(keep)
        return probs, gates, expert, torch.stack(addrs, 1), torch.stack(keeps, 1), cap

    def forward(
        self,
        x: torch.Tensor,  # [B, T, H]
        valid_mask: Optional[torch.Tensor] = None,  # [B, T], 1 = valid
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        batch, seq_len, hidden = x.shape
        n_tokens = batch * seq_len
        num_e = self.num_experts
        tokens = x.reshape(n_tokens, hidden)
        valid = (valid_mask.reshape(n_tokens) > 0 if valid_mask is not None
                 else torch.ones(n_tokens, dtype=torch.bool, device=x.device))
        probs, gates, expert, addr, _keep, cap = self.route(tokens, valid)

        cdt = self.dtype or x.dtype
        src = tokens.to(cdt)
        buf = src.new_zeros((num_e * cap + 1, hidden))  # the last row takes the drops
        for slot in range(self.top_k):
            buf = buf.index_copy(0, addr[:, slot], src)
        ebuf = buf[: num_e * cap].reshape(num_e, cap, hidden)
        h = torch.relu(self._product(ebuf, self.moe_w1, self.moe_b1, cdt))
        if train and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
            h = torch.where(keep, h / keep_prob, 0.0)
        out_e = self._product(h, self.moe_w2, self.moe_b2, cdt)
        flat = torch.cat([out_e.reshape(num_e * cap, hidden), out_e.new_zeros((1, hidden))])
        y = None
        for slot in range(self.top_k):
            picked = gates[:, slot, None] * flat.index_select(0, addr[:, slot]).float()
            y = picked if y is None else y + picked

        validf = valid.float()
        denom = validf.sum().clamp(min=1.0)
        top1 = F.one_hot(expert[:, 0], num_e).float() * validf[:, None]
        frac_tokens = top1.sum(0) / denom
        mean_prob = (probs * validf[:, None]).sum(0) / denom
        aux = num_e * (frac_tokens * mean_prob).sum()
        return y.reshape(batch, seq_len, hidden).to(x.dtype), aux

    @staticmethod
    def _product(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cdt: torch.dtype):
        """``a [E, C, in] x w [E, in, out] + b [E, out]`` per expert: one
        ``baddbmm`` in f32; in bf16 the product rounded, then the bf16 bias
        added (a second rounding), as the reference's einsum and add."""
        if cdt == torch.float32:
            return torch.baddbmm(b[:, None, :], a, w)
        return torch.bmm(a.to(cdt), w.to(cdt)) + b.to(cdt)[:, None, :]

