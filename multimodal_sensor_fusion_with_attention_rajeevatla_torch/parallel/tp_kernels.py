"""Tensor-parallel composition of the feed-forward kernel pair, port of the
JAX package's ``parallel/tp_kernels.py``.

Megatron column / row sharding of the transformer feed-forward with the
port's ``fused_mlp`` (rows 10-11 of the kernel table on the card, their
plain twins on the CPU) running on each model rank's shard:

- ``w1 [H, F/M]`` and ``b1 [F/M]`` are this rank's columns, ``w2 [F/M, H]``
  its rows: the rank computes its slice of the hidden activation, the ReLU
  and the dropout are elementwise over it;
- the rank's product is a partial ``[N, H]`` output, computed with
  ``b2 = 0``; one sum over ``model`` completes it and ``b2`` is added once,
  after;
- the dropout ``keep_mask`` is one global ``[N, F]`` mask that every rank
  draws alike and slices on F, so the realised pattern is the single-device
  one.

Differentiable: the replicated input enters through ``copy_to_model``
(gradient parts summed backward) and the sum is ``reduce_from_model``
(identity backward), so the input's gradient is whole on every rank and the
weight gradients come back sharded like the weights. Under sequence
parallelism (``seq_dim``) the input is this rank's chunk of T, gathered
before the product (reduce-scatter backward), and the sum is a
reduce-scatter back to the chunk (all-gather backward).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.mlp import fused_mlp
from .mesh import (
    Mesh,
    copy_to_model,
    gather_for_partial,
    reduce_from_model,
    reduce_scatter_seq,
)


def tp_fused_mlp(
    mesh: Optional[Mesh],
    x: torch.Tensor,  # [..., d_in], replicated over 'model' (or its chunk of T with seq_dim)
    w1: torch.Tensor,  # [d_in, d_ff / M]  this rank's columns
    b1: torch.Tensor,  # [d_ff / M]
    w2: torch.Tensor,  # [d_ff / M, d_out] this rank's rows
    b2: torch.Tensor,  # [d_out]  replicated
    keep_mask: Optional[torch.Tensor] = None,  # [..., d_ff] global, or [..., d_ff / M]
    keep_prob: float = 1.0,
    seq_dim: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    plain: Optional[Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]] = None,
) -> torch.Tensor:
    """Feed-forward under Megatron tensor parallelism over the active mesh's
    ``model`` axis (``mesh`` is that mesh, published by ``activation_mesh``).
    Returns ``[..., d_out]`` in f32. The ``fused_mlp`` pair runs on the
    shard (its bf16 entries with ``dtype`` bf16); ``plain(rows, mask)``, where
    given, takes its place: the caller's plain feed-forward of the shard on
    ``rows [N, d_in]`` and the mask's slice, returning the partial
    ``[N, d_out]`` without ``b2``. Without a model axis it is the
    single-device feed-forward."""
    f_local = w1.shape[-1]
    if keep_mask is not None and keep_mask.shape[-1] != f_local:
        index = mesh.coords()["model"] if mesh is not None and "model" in mesh.axis_names else 0
        keep_mask = keep_mask[..., index * f_local:(index + 1) * f_local]
    if seq_dim is None:
        x = copy_to_model(x)
    else:
        x = gather_for_partial(x, seq_dim)
        if keep_mask is not None and keep_mask.shape[seq_dim] != x.shape[seq_dim]:
            raise ValueError("under sequence parallelism the keep mask covers the whole sequence")
    lead, d_in = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, d_in)
    mask = None if keep_mask is None else keep_mask.reshape(rows.shape[0], -1)
    if plain is None:
        partial = fused_mlp(rows if dtype is None else rows.to(dtype), w1, b1, w2,
                            torch.zeros_like(b2), mask, keep_prob)  # b2 after the sum
    else:
        partial = plain(rows, mask)
    partial = partial.float().reshape(*lead, -1)
    out = reduce_from_model(partial) if seq_dim is None else reduce_scatter_seq(partial, seq_dim)
    return out + b2.float()
