"""Fused eval-mode HybridFusion head: CUDA kernel and its plain twin.

Counterpart of the JAX package's ``ops/pallas_fusion.py``. On pooled
(length-1) embeddings the whole hybrid head is:

    att_p  = (e_{k(p)} Wv_p + bv_p) Wo_p + bo_p     per ordered pair p
    att_p  = bo_p where key k(p) is masked          (softmax over one key)
    agg_q  = mean(e_q, att_{p: query(p)=q}) * mask_q
    w      = adaptive gate weights of (gate_q . agg_q)
    logits = relu((sum_q w_q agg_q) W1 + b1) W2 + b2

``fused_hybrid_head`` is the kernel wrapper: a CUDA tensor launches
``csrc/fusion_head.cu`` (five kernels on one stream: the pair values, their
out-projections, the aggregation and gate, the hidden and the logits; the
products 3xTF32 on the tensor cores, the intermediates in one scratch tensor
the wrapper allocates) or raises, a CPU tensor takes ``fused_hybrid_head_reference``.
Weights use the reference's ``[in, out]`` layout; pair weights stay stacked
``[P, H, H]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from . import _build
from .masked import adaptive_gate_weights


class HeadParams(NamedTuple):
    """Fused-head weights in kernel layout (all ``[in, out]``, contiguous)."""

    pair_params: Dict[str, torch.Tensor]  # value/out kernel [P,H,H], bias [P,H]
    gate_kernels: torch.Tensor  # [M, H]
    gate_biases: torch.Tensor  # [M]
    w1: torch.Tensor  # [H, H]
    b1: torch.Tensor  # [H]
    w2: torch.Tensor  # [H, C]
    b2: torch.Tensor  # [C]
    proj: Dict[str, Tuple[torch.Tensor, torch.Tensor]]  # name -> (weight [H, D], bias)


# csrc/fusion_head.cu copies H 16 bytes at a time: hybrid_head_params pads H
# to a multiple of 4 (the kernels take any M >= 2, H and C)
HEAD_HIDDEN_MULTIPLE = 4


def _canonical_pairs(num_mod: int) -> List[Tuple[int, int]]:
    return [(q, k) for q in range(num_mod) for k in range(num_mod) if q != k]


def fused_hybrid_head_reference(
    projected, modality_mask, pair_params, gate_kernels, gate_biases,
    w1, b1, w2, b2, pairs,
) -> torch.Tensor:
    """Plain PyTorch version of the head kernel (same operation order)."""
    num_mod = projected.shape[0]
    mask = modality_mask.float()
    wv, bv = pair_params["value_kernel"], pair_params["value_bias"]
    wo, bo = pair_params["out_kernel"], pair_params["out_bias"]
    agg_list = []
    for q in range(num_mod):
        total = projected[q]
        for p, (pq, pk) in enumerate(pairs):
            if pq != q:
                continue
            v = projected[pk] @ wv[p] + bv[p]
            att = v @ wo[p] + bo[p]
            att = torch.where(mask[:, pk : pk + 1] > 0, att, bo[p])
            total = total + att
        agg = total / (1.0 + sum(1 for pq, _ in pairs if pq == q))
        agg_list.append(agg * mask[:, q : q + 1])
    score = torch.stack(
        [(agg_list[m] * gate_kernels[m]).sum(-1) + gate_biases[m] for m in range(num_mod)],
        dim=-1,
    )
    weights = adaptive_gate_weights(score, mask, num_mod)
    fused = agg_list[0] * weights[:, 0:1]
    for m in range(1, num_mod):
        fused = fused + agg_list[m] * weights[:, m : m + 1]
    hidden = torch.relu(fused @ w1 + b1)
    return hidden @ w2 + b2


def _kernel_fn():
    lib = _build.library("fusion_head")
    fn = lib.msfa_fusion_head
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def fused_hybrid_head(
    projected: torch.Tensor,  # [M, B, H] post-ReLU projected embeddings
    modality_mask: torch.Tensor,  # [B, M]
    pair_params: Dict[str, torch.Tensor],
    gate_kernels: torch.Tensor,  # [M, H]
    gate_biases: torch.Tensor,  # [M]
    w1: torch.Tensor,  # [H, H]
    b1: torch.Tensor,  # [H]
    w2: torch.Tensor,  # [H, C]
    b2: torch.Tensor,  # [C]
    pairs: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """Run the fused head -> logits ``[B, C]``.

    CUDA tensors launch the kernels (float32, contiguous, query-major ordered
    pairs; ``hidden`` a multiple of 4 and the products' operands 16-byte
    aligned, or the launch is refused) or raise; CPU tensors take
    ``fused_hybrid_head_reference``. ``fused_hybrid_head.launches`` counts
    calls that launched the head.
    """
    num_mod, batch, hidden = projected.shape
    num_classes = w2.shape[-1]
    pairs = [tuple(p) for p in pairs]
    wv, bv = pair_params["value_kernel"], pair_params["value_bias"]
    wo, bo = pair_params["out_kernel"], pair_params["out_bias"]
    num_pairs = len(pairs)
    expected = {
        "modality_mask": (batch, num_mod), "value_kernel": (num_pairs, hidden, hidden),
        "value_bias": (num_pairs, hidden), "out_kernel": (num_pairs, hidden, hidden),
        "out_bias": (num_pairs, hidden), "gate_kernels": (num_mod, hidden),
        "gate_biases": (num_mod,), "w1": (hidden, hidden), "b1": (hidden,),
        "w2": (hidden, num_classes), "b2": (num_classes,),
    }
    tensors = {
        "modality_mask": modality_mask, "value_kernel": wv, "value_bias": bv,
        "out_kernel": wo, "out_bias": bo, "gate_kernels": gate_kernels,
        "gate_biases": gate_biases, "w1": w1, "b1": b1, "w2": w2, "b2": b2,
    }
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(
                f"{name} must have shape {shape}, got {tuple(tensors[name].shape)}"
            )
        if tensors[name].device != projected.device:
            raise ValueError(f"{name} is on {tensors[name].device}, projected on {projected.device}")
    if projected.device.type == "cpu":
        return fused_hybrid_head_reference(
            projected, modality_mask, pair_params, gate_kernels, gate_biases,
            w1, b1, w2, b2, pairs,
        )
    if projected.device.type != "cuda":
        raise ValueError(f"unsupported device {projected.device}")
    if pairs != _canonical_pairs(num_mod):
        raise ValueError("kernel takes the query-major ordered pairs of ordered_pairs()")
    tensors["projected"] = projected
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    logits = torch.empty((batch, num_classes), device=projected.device, dtype=torch.float32)
    if batch == 0:
        return logits
    # v and att [P, B, H], fused and hidden [B, H]
    scratch = torch.empty(
        (2 * num_pairs + 2) * batch * hidden, device=projected.device, dtype=torch.float32
    )
    lib, fn = _kernel_fn()
    with torch.cuda.device(projected.device):
        code = fn(
            projected.data_ptr(), modality_mask.data_ptr(), wv.data_ptr(), bv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), gate_kernels.data_ptr(), gate_biases.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), logits.data_ptr(),
            scratch.data_ptr(), num_mod, batch, hidden, num_classes,
            torch.cuda.current_stream(projected.device).cuda_stream,
        )
    _build.check(lib, code, "fused_hybrid_head")
    fused_hybrid_head.launches += 1
    return logits


fused_hybrid_head.launches = 0


@torch.no_grad()
def hybrid_head_params(fusion) -> HeadParams:
    """Fused-head weights from a ``models.fusion.HybridFusion`` module.

    Counterpart of the reference's ``hybrid_head_params_from_variables``;
    the linear layers' ``[out, in]`` weights are transposed to ``[in, out]``
    once here, so a server builds them once and not per request. An H that
    is not a multiple of ``HEAD_HIDDEN_MULTIPLE`` is padded with zeros: the
    projections' extra output units are zero, and every weight's extra rows
    and columns too, so the extra columns of every intermediate stay zero and
    the logits are the same.
    """
    names = list(fusion.modality_names)
    pairs = fusion.pairs
    hidden = fusion.classifier_hidden.in_features
    extra = -hidden % HEAD_HIDDEN_MULTIPLE

    def pad(t, dims):  # zeros after the last `dims` axes' H entries
        t = t.detach()
        if extra:
            t = torch.nn.functional.pad(t, [0, extra] * dims)
        return t.contiguous()

    def pad_rows(t):  # [H, n] -> [H + extra, n]
        return pad(t.t(), 1).t().contiguous()

    return HeadParams(
        pair_params={
            "value_kernel": pad(pairs.value_kernel, 2),
            "value_bias": pad(pairs.value_bias, 1),
            "out_kernel": pad(pairs.out_kernel, 2),
            "out_bias": pad(pairs.out_bias, 1),
        },
        gate_kernels=pad(torch.stack([fusion.gates[m].weight[0] for m in names]), 1),
        gate_biases=torch.stack([fusion.gates[m].bias[0] for m in names]).detach().contiguous(),
        w1=pad(fusion.classifier_hidden.weight.t(), 2),
        b1=pad(fusion.classifier_hidden.bias, 1),
        w2=pad_rows(fusion.classifier_out.weight.t()),
        b2=fusion.classifier_out.bias.detach().contiguous(),
        proj={
            m: (pad_rows(fusion.projections[m].weight), pad(fusion.projections[m].bias, 1))
            for m in names
        },
    )


def hybrid_fused_inference(
    params: HeadParams,
    encoded: Dict[str, torch.Tensor],
    modality_mask: torch.Tensor,
    modality_names: Sequence[str],
) -> torch.Tensor:
    """Whole hybrid head from encoder outputs through the fused kernel.

    Equals ``HybridFusion.forward`` in eval mode: the per-modality projection
    and ReLU run as plain ops (each modality has its own input width), then
    the fused head as the op ``msfa::fused_hybrid_head`` (``ops/library.py``).
    """
    from ..models.attention import ordered_pairs

    mask = modality_mask.float()
    projected = []
    for i, m in enumerate(modality_names):
        weight, bias = params.proj[m]
        x = encoded[m] * mask[:, i : i + 1]
        projected.append(torch.relu(torch.nn.functional.linear(x, weight, bias)))
    stacked = torch.stack(projected, dim=0)
    from . import library  # registers the msfa:: ops

    return library.fused_hybrid_head(*library.head_op_args(
        params, stacked, mask.contiguous(), ordered_pairs(modality_names)))
