"""The served kernels as ``torch.library`` custom ops (namespace ``msfa``).

The eval forward reaches seven kernel entries: the packed attention forward
(row 1, and its bf16 entry, row 1b), the two flash forwards (rows 3 and 4),
the fused hybrid head (row 8) and the two fused grouped recurrences (rows 17
and 18). Each is registered here as one op with two implementations and no
catch-all:

- ``CUDA``: the existing entry (``ops/attention.py``, ``ops/fusion.py``,
  ``ops/rnn.py``) with its checks, its ``ctypes`` launch and its launch
  counter, which counts when the op runs and never when a graph is traced;
- ``CPU``: the same entry, which takes its plain twin for a CPU tensor.

A tensor on any other device finds no kernel and raises. The fake
implementation gives the output shapes and types, so ``torch.export`` holds
the op as one node of the graph (``serving.export_serving_bundle``): the
exported bundle launches the same kernels as ``serving.make_serving_fn`` on
the card and runs the twins on the CPU.

The eval forwards call these ops wherever they call one of those entries
without a gradient to record (``flash_mha_packed``, ``flash_self_attention``,
``hybrid_fused_inference``, ``GroupedRNNEncoder``); training keeps the
``autograd.Function``s, and the training kernels (rows 2, 5-7, 9-16, 19-22
and the bf16 backward entries) are not ops. Importing this module builds
nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import attention, fusion, rnn

NAMESPACE = "msfa"


def _op(name: str, entry, schema: str, fake):
    """Register ``msfa::<name>``: ``entry`` on the CPU and the card, ``fake``
    for tracing."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", entry, mutates_args=(),
                                 device_types=("cpu", "cuda"), schema=schema)
    op.register_fake(fake)
    return op


def _attention_fake(qkv, lengths, num_heads, sm_scale):
    head_dim = attention._check_packed(qkv, lengths, num_heads)
    batch, seq, _ = qkv.shape
    return (qkv.new_empty((batch, seq, num_heads * head_dim), dtype=torch.float32),
            qkv.new_empty((batch, seq, num_heads), dtype=torch.float32))


_PACKED_SCHEMA = ("(Tensor qkv, Tensor lengths, int num_heads, float sm_scale) "
                  "-> (Tensor, Tensor)")
packed_attention_fwd = _op("packed_attention_fwd", attention.packed_attention_fwd,
                           _PACKED_SCHEMA, _attention_fake)
packed_attention_fwd_bf16 = _op("packed_attention_fwd_bf16", attention.packed_attention_fwd_bf16,
                                _PACKED_SCHEMA, _attention_fake)


def _flash_fake(q, k, v, lengths, heads, sm_scale, block_k=attention.BLOCK_K):
    attention._check_flash(q, k, v, lengths, heads)
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))


_FLASH_ARGS = "Tensor q, Tensor k, Tensor v, Tensor lengths, int heads, float sm_scale"
flash_fwd_single = _op("flash_fwd_single", attention.flash_fwd_single,
                       f"({_FLASH_ARGS}) -> (Tensor, Tensor)", _flash_fake)
flash_fwd_tiled = _op("flash_fwd_tiled", attention.flash_fwd_tiled,
                      f"({_FLASH_ARGS}, int block_k) -> (Tensor, Tensor)", _flash_fake)


def _head_entry(projected, modality_mask, value_kernel, value_bias, out_kernel, out_bias,
                gate_kernels, gate_biases, w1, b1, w2, b2, pairs: List[int]) -> torch.Tensor:
    """``fusion.fused_hybrid_head`` on unpacked arguments: the pair weights
    as four tensors and the ordered pairs flattened ``[q0, k0, q1, k1, ...]``."""
    pair_params = {"value_kernel": value_kernel, "value_bias": value_bias,
                   "out_kernel": out_kernel, "out_bias": out_bias}
    return fusion.fused_hybrid_head(projected, modality_mask, pair_params, gate_kernels,
                                    gate_biases, w1, b1, w2, b2,
                                    list(zip(pairs[0::2], pairs[1::2])))


def _head_fake(projected, modality_mask, value_kernel, value_bias, out_kernel, out_bias,
               gate_kernels, gate_biases, w1, b1, w2, b2, pairs):
    return projected.new_empty((projected.shape[1], w2.shape[-1]), dtype=torch.float32)


fused_hybrid_head = _op(
    "fused_hybrid_head", _head_entry,
    "(Tensor projected, Tensor modality_mask, Tensor value_kernel, Tensor value_bias, "
    "Tensor out_kernel, Tensor out_bias, Tensor gate_kernels, Tensor gate_biases, Tensor w1, "
    "Tensor b1, Tensor w2, Tensor b2, int[] pairs) -> Tensor",
    _head_fake)


def _rnn_fake(x, w_ih, w_hh, *rest):
    steps, groups, batch, _ = x.shape
    return x.new_empty((groups, batch, w_hh.shape[1]), dtype=torch.float32)


grouped_lstm_fused = _op(
    "grouped_lstm_fused", rnn.grouped_lstm_fused,
    "(Tensor x, Tensor w_ih, Tensor w_hh, Tensor bias, Tensor? lengths) -> Tensor", _rnn_fake)
grouped_gru_fused = _op(
    "grouped_gru_fused", rnn.grouped_gru_fused,
    "(Tensor x, Tensor w_ih, Tensor w_hh, Tensor b_ih, Tensor b_hh, Tensor? lengths) -> Tensor",
    _rnn_fake)


def graph_ops(graph) -> Dict[str, int]:
    """``{op name: call nodes}`` of the ``msfa`` ops in an fx graph."""
    counts: Dict[str, int] = {}
    for node in graph.nodes:
        target = node.target
        if node.op == "call_function" and getattr(target, "namespace", None) == NAMESPACE:
            name = target.name().split("::", 1)[1].split(".", 1)[0]
            counts[name] = counts.get(name, 0) + 1
    return counts


def head_op_args(params: "fusion.HeadParams", projected, mask, pairs) -> Tuple:
    """The ``msfa::fused_hybrid_head`` arguments from ``HeadParams``."""
    pp = params.pair_params
    flat = [int(i) for pair in pairs for i in pair]
    return (projected, mask, pp["value_kernel"], pp["value_bias"], pp["out_kernel"],
            pp["out_bias"], params.gate_kernels, params.gate_biases, params.w1, params.b1,
            params.w2, params.b2, flat)


def recorded(t: torch.Tensor, *more: Optional[torch.Tensor]) -> bool:
    """True when autograd would record a call on these tensors: then the
    caller takes its ``autograd.Function``, else the op."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (t, *more))
