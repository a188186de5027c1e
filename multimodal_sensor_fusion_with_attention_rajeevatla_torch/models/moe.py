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

Expert parallelism (an active mesh with a ``model`` axis, ``parallel.mesh``):
routing stays replicated on every model rank; ``moe_w1`` ... ``moe_b2`` are
this rank's ``E / M`` experts, which run on their rows of the ``[E, C, H]``
buffer, and one all-gather over ``model`` rebuilds the outputs. E must divide
by M (the reference's ``ValueError``). Over (dcn, data) ranks the routing,
the capacity, the drops and the aux loss are those of the global batch, and
each rank's buffer holds only its own kept tokens (``route``).

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

from ..parallel.mesh import (
    BATCH_AXES,
    MODEL_AXIS,
    current_activation_mesh,
    expert_gathered_constraint,
    expert_sharded_constraint,
    gather_batch,
    reduce_from_batch,
)


def _batch_index() -> int:
    """This rank's (dcn, data) index on the active mesh (0 without one)."""
    mesh = current_activation_mesh()
    return 0 if mesh is None else mesh.index(BATCH_AXES)


def _expert_index() -> int:
    """This rank's index on the active mesh's ``model`` axis (0 without one)."""
    mesh = current_activation_mesh()
    return 0 if mesh is None or MODEL_AXIS not in mesh.axis_names else mesh.coords()[MODEL_AXIS]


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
        keep [N, K], rows)``: ``addr`` is a (token, slot)'s row of the
        ``[E * rows, H]`` expert buffer, ``E * rows`` where it is dropped;
        ``rows`` is the capacity C.

        Under an active mesh with (dcn, data) ranks the tokens are this
        rank's rows of the global batch, which the reference routes as one:
        the capacity counts every rank's tokens, and a (token, slot) takes
        its position after the slot's tokens of the ranks before this one
        (their per-expert counts, one all-gather), so the drops are the
        single-device ones. A rank's kept (token, slot)s of an expert come
        first among its own in that order, so the buffer keeps only this
        rank's: an expert's take rows ``0 .. kept - 1`` of it, and ``rows``
        is the most that one expert keeps here (rounded up to 8, at most
        C; one read of a count on the host). The experts then run on this
        rank's tokens alone, not on the whole batch's C rows."""
        n_tokens = tokens.shape[0]
        num_e, k_slots = self.num_experts, self.top_k
        probs = torch.softmax(tokens.float() @ self.router, dim=-1)
        # a stable descending sort: equal probabilities keep the lower expert first
        gates, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, expert = gates[:, :k_slots], expert[:, :k_slots]
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        gates = gates * valid[:, None]
        live = valid.long()[None, :]
        # expert-major [E, N] one-hots, so the cumsum runs along the
        # contiguous token axis (a scan down the tokens of an [N, E] tensor
        # keeps one thread a column on the card)
        onehots = [F.one_hot(expert[:, slot], num_e).t().contiguous() * live
                   for slot in range(k_slots)]
        counts = torch.stack([o.sum(1) for o in onehots])  # [K, E] on this rank
        ranks = gather_batch(counts[None])  # [R, K, E], every (dcn, data) rank's
        me = _batch_index()
        before = ranks[:me].sum(0)  # the slot's tokens of the ranks before this one
        totals = ranks.sum(0)
        cap = moe_capacity(n_tokens * ranks.shape[0], num_e, k_slots, self.capacity_factor)
        base = torch.zeros((num_e, 1), dtype=torch.long, device=tokens.device)
        own = torch.zeros_like(base)  # this rank's earlier slots' tokens
        poss, owns, keeps = [], [], []
        for slot, onehot in enumerate(onehots):
            ahead = onehot.cumsum(1) - onehot
            pos = ((ahead + base + before[slot][:, None]) * onehot).sum(0)
            owns.append(((ahead + own) * onehot).sum(0))
            base = base + totals[slot][:, None]
            own = own + counts[slot][:, None]
            keep = (pos < cap) & valid
            poss.append(pos)
            keeps.append(keep)
        keep = torch.stack(keeps, 1)
        pos, rows = torch.stack(poss, 1), cap
        if ranks.shape[0] > 1:
            kept = torch.zeros(num_e, dtype=torch.long, device=tokens.device)
            kept = kept.index_add(0, expert.reshape(-1), keep.reshape(-1).long())
            rows = min(cap, max(8, -(-int(kept.max()) // 8) * 8))
            pos = torch.stack(owns, 1)
        addr = torch.where(keep, expert * rows + pos, num_e * rows)
        return probs, gates, expert, addr, keep, rows

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
        probs, gates, expert, addr, _keep, rows = self.route(tokens, valid)

        cdt = self.dtype or x.dtype
        src = tokens.to(cdt)
        buf = src.new_zeros((num_e * rows + 1, hidden))  # the last row takes the drops
        for slot in range(self.top_k):
            buf = buf.index_copy(0, addr[:, slot], src)
        # expert parallelism: this rank's E / M experts (their weights are
        # its shard), the outputs of all gathered back for the combine
        ebuf = expert_sharded_constraint(buf[: num_e * rows].reshape(num_e, rows, hidden), num_e)
        h = torch.relu(self._product(ebuf, self.moe_w1, self.moe_b1, cdt))
        if train and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            # the whole [E, rows, F] mask, this rank's experts' rows of it
            keep = torch.rand((num_e,) + h.shape[1:], generator=generator,
                              device=h.device) < keep_prob
            e0 = _expert_index() * h.shape[0]
            h = torch.where(keep[e0:e0 + h.shape[0]], h / keep_prob, 0.0)
        out_e = expert_gathered_constraint(self._product(h, self.moe_w2, self.moe_b2, cdt))
        flat = torch.cat([out_e.reshape(num_e * rows, hidden), out_e.new_zeros((1, hidden))])
        y = None
        for slot in range(self.top_k):
            picked = gates[:, slot, None] * flat.index_select(0, addr[:, slot]).float()
            y = picked if y is None else y + picked

        # over the global batch: each (dcn, data) rank's sums added up
        validf = valid.float()
        denom = reduce_from_batch(validf.sum()).clamp(min=1.0)
        top1 = F.one_hot(expert[:, 0], num_e).float() * validf[:, None]
        frac_tokens = reduce_from_batch(top1.sum(0)) / denom
        mean_prob = reduce_from_batch((probs * validf[:, None]).sum(0)) / denom
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

