"""Multi-head self-attention, forward and backward: CUDA kernels and their
plain versions, on two layouts.

**Packed layout** (padded T <= 512). Counterpart of the JAX package's
``ops/pallas_attention.py::flash_mha_packed`` and its custom VJP
``_packed_core``. The input is the qkv projection's natural ``[B, T, 3*H*d]``
layout (q | k | v along the minor dim, heads sliced inside each third) plus
per-row valid key lengths; the output is ``[B, T, H*d]``.
``packed_attention_fwd`` and ``packed_attention_bwd`` are the kernel wrappers
(``csrc/packed_attention.cu``, ``csrc/packed_attention_bwd.cu``), with
``packed_attention_reference`` and ``packed_attention_bwd_reference`` as
their plain PyTorch versions; ``flash_mha_packed`` runs both through one
``torch.autograd.Function``.

**Head-major layout** (any T; the long windows and the grouped encoder).
Counterpart of ``flash_self_attention`` and its custom VJP ``_flash_core``:
``q, k, v [B, H, T, d]`` in, ``[B, H, T, d]`` out, with the reference's
wrapper semantics (blocks clipped to T, T padded up to a block multiple,
routes chosen by the padded length). Five kernels, one wrapper each:

* ``flash_fwd_single`` (``csrc/flash_attention.cu``): the route of the
  reference's single-key-block kernel (the whole key axis at once, no running
  rescale); padded T ``<= max(block_k, SINGLE_K_MAX)``. On the card it is an
  online softmax over 64-key tiles on the tensor cores.
* ``flash_fwd_tiled`` (same source): online softmax over key tiles; above that.
* ``flash_bwd_fused`` (``csrc/flash_attention_bwd.cu``): dq, dk and dv from
  one kernel, each score computed once (dq summed from ordered per-key-tile
  partials in a ``[B*H, ceil(T/64), T, d]`` scratch); padded T
  ``<= max(min(block_q, block_k), FUSED_BWD_MAX)``.
* ``flash_bwd_dkv`` and ``flash_bwd_dq`` (same source): the split pair, no
  scratch; above that. The dk/dv kernel is the fused kernel's body without
  its dq (the same bits for dk and dv); the dq kernel walks one 64-row query
  tile over the key tiles below the length, its ds kept in registers.
  ``flash_delta`` (``rowsum(dout * out)``, plain XLA in the reference) is a
  small kernel of that source run before either route.

All seven attention kernels take each f32 product as three TF32
tensor-core products (``csrc/tf32_mma.cuh``), which keeps f32's accuracy, on
tiles staged by ``cp.async``: one body for the packed and both flash
forwards (``csrc/attention_fwd.cuh``), one for the packed, the fused and the
split dk/dv backward, beside the split dq's (``csrc/attention_bwd.cuh``).

**bf16 (``mixed_precision``).** The packed pair has bf16-operand entries,
``packed_attention_fwd_bf16`` and ``packed_attention_bwd_bf16``, the same
bodies with q, k and v read as bf16 (half the bytes): a product of two bf16
operands (q k^T) is exact in one TF32 product, one of a bf16 and an f32
operand (p v, dout v^T, ds q, ds k) takes two, and p^T dout, both f32,
three. They compute the reference's tested function (its interpret path
casts a bf16 qkv to f32 before the kernel): the f32 kernel's arithmetic on
the bf16 values, ``out`` and ``lse`` in f32, and ``dqkv`` rounded to bf16
(the cast's VJP). The TPU kernel also rounds p to bf16; the port does not.
The entry is picked by the operands' type: ``flash_mha_packed`` and
``PackedAttention`` run the bf16 entries for a bfloat16 ``qkv``;
``flash_self_attention`` (the flash routes, T > 512) casts bf16 q, k and v
to f32 copies for its f32 kernels, which is the reference's function there
too (its interpret path pins f32). The split pair does seven products where the
fused route does five: on the H100 its bound is 1.67 + 1.25 ms at ``[128,
2048, 64]`` against the fused route's 2.08 (165 TFLOP/s, a third of the
TF32 peak).

Routing is by arguments only. The reference also reads five environment
variables: ``MSFA_FLASH_PACKED`` (0 turns the packed route off),
``MSFA_FLASH_PACKED_MAX``, ``MSFA_FLASH_SINGLE_K_MAX``,
``MSFA_FLASH_SINGLE_K_BQ`` and ``MSFA_FLASH_FUSED_BWD_MAX``. The port reads
none of them: its thresholds are the module constants ``PACKED_MAX_LEN``,
``SINGLE_K_MAX`` and ``FUSED_BWD_MAX`` (the reference's defaults), and a
sweep that sets those variables measures the default routes. A caller pins a
route with ``flash_self_attention(..., single_k_max=, fused_bwd_max=)``
(``chip_smoke.py`` times both backward routes so); ``flash_routes`` names
the routes without running anything. The routes compute one function.

On both layouts key columns at or past a row's length are masked, queries are
not; a row with no valid key gives exact zeros (and ``lse = NEG_INF``) and
zero gradients. A CUDA tensor launches the kernel or raises, a CPU tensor
takes the plain version; each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

# Finite mask value of the TPU kernel (pallas_attention.py NEG_INF), kept
# apart from ops.masked.NEG_INF = -inf on purpose.
NEG_INF = -1e30
# Padded sequence length up to which the single-pass packed route is taken
# (the reference's MSFA_FLASH_PACKED_MAX default).
PACKED_MAX_LEN = 512
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def kernel_head_dim(head_dim: int) -> Optional[int]:
    """The head_dim the attention kernels compute ``head_dim`` at: the least
    of ``KERNEL_HEAD_DIMS`` not below it, or None above the largest.
    ``flash_mha_packed`` and ``flash_self_attention`` pad q, k and v with zero
    columns up to it and drop the extra output columns: a zero column adds an
    exact zero to every score and every other output column, and the softmax
    scale stays the true head_dim's, so the function is the same."""
    return next((d for d in KERNEL_HEAD_DIMS if d >= head_dim), None) if head_dim > 0 else None


def attention_route(head_dim: int) -> str:
    """The path a layer's attention takes at ``head_dim`` with the attention
    kernels on: ``"kernel"`` (the packed or flash kernels, at
    ``kernel_head_dim``) or ``"plain"`` (the layer's own softmax: a head_dim
    above the kernels' largest). A plain function of the width, decided
    before any launch."""
    return "plain" if kernel_head_dim(head_dim) is None else "kernel"


def packed_route_ok(seq_len: int, num_heads: int, head_dim: int) -> bool:
    """True when the packed kernel takes this shape (padded T <= 512; any
    head_dim ``attention_route`` sends to the kernels)."""
    del num_heads, head_dim  # the route depends on the sequence length only
    padded = ((seq_len + 7) // 8) * 8
    return padded <= PACKED_MAX_LEN


def _pad_head_dim(x: torch.Tensor, head_dim: int, width: int) -> torch.Tensor:
    """``[..., head_dim]`` -> ``[..., width]`` with zero columns."""
    return torch.nn.functional.pad(x, (0, width - head_dim)) if width != head_dim else x


def _check_packed(qkv: torch.Tensor, lengths: torch.Tensor, num_heads: int) -> int:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, T, 3F], got shape {tuple(qkv.shape)}")
    three_f = qkv.shape[-1]
    if three_f % 3 != 0 or (three_f // 3) % num_heads != 0:
        raise ValueError(
            f"qkv minor dim {three_f} must be 3 * num_heads * head_dim "
            f"(num_heads={num_heads})"
        )
    if lengths.shape != (qkv.shape[0],):
        raise ValueError(
            f"lengths must be [B] = [{qkv.shape[0]}], got {tuple(lengths.shape)}"
        )
    if lengths.device != qkv.device:
        raise ValueError("qkv and lengths must be on the same device")
    return three_f // 3 // num_heads


def packed_attention_reference(
    qkv: torch.Tensor, lengths: torch.Tensor, num_heads: int, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(out [B,T,F], lse [B,T,H])``.

    Mirrors the TPU kernel's arithmetic: sm_scale folded into q, masked
    scores set to ``NEG_INF``, exact zeros and ``lse = NEG_INF`` for rows
    without a valid key.
    """
    head_dim = _check_packed(qkv, lengths, num_heads)
    batch, seq, three_f = qkv.shape
    feat = three_f // 3
    x = qkv.float().reshape(batch, seq, 3, num_heads, head_dim)
    q = (x[:, :, 0] * sm_scale).transpose(1, 2)  # [B, H, T, d]
    k = x[:, :, 1].transpose(1, 2)
    v = x[:, :, 2].transpose(1, 2)
    colmask = (
        torch.arange(seq, device=qkv.device)[None, :] < lengths.to(torch.int64)[:, None]
    )[:, None, None, :]  # [B, 1, 1, T]
    scores = torch.where(colmask, q @ k.transpose(-1, -2), NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(colmask, torch.exp(scores - m.clamp(min=NEG_INF / 2)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    out = torch.where(l > 0, (p @ v) / safe_l, 0.0)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    out = out.transpose(1, 2).reshape(batch, seq, feat)
    return out, lse[..., 0].transpose(1, 2).contiguous()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _packed_fwd(wrapper, symbol: str, dtype: torch.dtype, reference, qkv, lengths,
                num_heads: int, sm_scale: float):
    """The body of both forward entries: checks, then one launch of
    ``symbol`` of ``csrc/packed_attention.cu``, counted on ``wrapper``."""
    head_dim = _check_packed(qkv, lengths, num_heads)
    if qkv.device.type == "cpu":
        return reference(qkv, lengths, num_heads, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != dtype or lengths.dtype != torch.int32:
        raise TypeError(f"kernel takes {_dtype_name(dtype)} qkv and int32 lengths, got "
                        f"{qkv.dtype} and {lengths.dtype}")
    if not (qkv.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("qkv and lengths must be contiguous")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"kernel supports head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}"
        )
    batch, seq, three_f = qkv.shape
    out = torch.empty((batch, seq, three_f // 3), device=qkv.device, dtype=torch.float32)
    lse = torch.empty((batch, seq, num_heads), device=qkv.device, dtype=torch.float32)
    if batch == 0 or seq == 0:
        return out, lse
    lib = _build.library("packed_attention")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(qkv.device):
        code = fn(
            qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
            batch, seq, num_heads, head_dim, float(sm_scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    return out, lse


def packed_attention_fwd(
    qkv: torch.Tensor, lengths: torch.Tensor, num_heads: int, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: ``(out [B,T,F], lse [B,T,H])`` from packed ``qkv``.

    CUDA tensors launch the hand-written kernel (f32, contiguous, int32
    lengths, head_dim in ``KERNEL_HEAD_DIMS``) or raise; CPU tensors take
    ``packed_attention_reference``. ``packed_attention_fwd.launches`` counts
    kernel launches.
    """
    return _packed_fwd(packed_attention_fwd, "msfa_packed_attention_fwd", torch.float32,
                       packed_attention_reference, qkv, lengths, num_heads, sm_scale)


packed_attention_fwd.launches = 0


def packed_attention_bwd_reference(
    qkv: torch.Tensor,
    lengths: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    sm_scale: float,
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: packed ``dqkv [B,T,3F]``.

    Mirrors the TPU kernel: p is recomputed from the saved ``lse`` with
    sm_scale folded into q, ``delta = rowsum(dout * out)`` per head, and
    ``ds = p * (dp - delta)``; dk uses the scaled q, dq is scaled after the
    product. Rows whose ``lse`` is ``NEG_INF`` (no valid key) give zeros.
    """
    head_dim = _check_packed(qkv, lengths, num_heads)
    batch, seq, three_f = qkv.shape
    x = qkv.float().reshape(batch, seq, 3, num_heads, head_dim)
    qs = (x[:, :, 0] * sm_scale).transpose(1, 2)  # [B, H, T, d]
    k = x[:, :, 1].transpose(1, 2)
    v = x[:, :, 2].transpose(1, 2)
    o = out.float().reshape(batch, seq, num_heads, head_dim).transpose(1, 2)
    do = dout.float().reshape(batch, seq, num_heads, head_dim).transpose(1, 2)
    lse_h = lse.float().transpose(1, 2)[..., None]  # [B, H, T, 1]
    colmask = (
        torch.arange(seq, device=qkv.device)[None, :] < lengths.to(torch.int64)[:, None]
    )[:, None, None, :]
    keep = colmask & (lse_h > NEG_INF / 2)
    p = torch.where(keep, torch.exp(qs @ k.transpose(-1, -2) - lse_h.clamp(min=NEG_INF / 2)), 0.0)
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = p.transpose(-1, -2) @ do
    ds = p * (do @ v.transpose(-1, -2) - delta)
    dk = ds.transpose(-1, -2) @ qs
    dq = (ds @ k) * sm_scale
    dqkv = torch.stack([dq, dk, dv], dim=2)  # [B, H, 3, T, d]
    return dqkv.permute(0, 3, 2, 1, 4).reshape(batch, seq, three_f)


def _packed_bwd(wrapper, symbol: str, dtype: torch.dtype, reference, qkv, lengths, out, lse,
                dout, num_heads: int, sm_scale: float):
    """The body of both backward entries: checks, then one launch of
    ``symbol`` of ``csrc/packed_attention_bwd.cu``, counted on ``wrapper``;
    ``dqkv`` in ``qkv``'s type."""
    head_dim = _check_packed(qkv, lengths, num_heads)
    batch, seq, three_f = qkv.shape
    expected = {"out": (batch, seq, three_f // 3), "dout": (batch, seq, three_f // 3),
                "lse": (batch, seq, num_heads)}
    tensors = {"out": out, "dout": dout, "lse": lse}
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(tensors[name].shape)}")
        if tensors[name].device != qkv.device:
            raise ValueError(f"{name} is on {tensors[name].device}, qkv on {qkv.device}")
    if qkv.device.type == "cpu":
        return reference(qkv, lengths, out, lse, dout, num_heads, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    tensors["qkv"] = qkv
    for name, t in tensors.items():
        want = dtype if name == "qkv" else torch.float32
        if t.dtype != want:
            raise TypeError(f"kernel takes {_dtype_name(want)} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"kernel takes contiguous int32 lengths, got {lengths.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel supports head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}")
    dqkv = torch.empty_like(qkv)
    if batch == 0 or seq == 0:
        return dqkv
    lib = _build.library("packed_attention_bwd")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch_floats = lib.msfa_packed_attention_bwd_scratch
    scratch_floats.argtypes = [ctypes.c_int] * 4
    scratch_floats.restype = ctypes.c_longlong
    # delta [B, T, H] and the per-key-tile dq partials the kernel sums in order
    scratch = torch.empty(scratch_floats(batch, seq, num_heads, head_dim), device=qkv.device,
                          dtype=torch.float32)
    with torch.cuda.device(qkv.device):
        code = fn(
            qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), scratch.data_ptr(), dqkv.data_ptr(),
            batch, seq, num_heads, head_dim, float(sm_scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    return dqkv


def packed_attention_bwd(
    qkv: torch.Tensor,
    lengths: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    sm_scale: float,
) -> torch.Tensor:
    """Kernel wrapper: packed ``dqkv [B,T,3F]`` from the forward's ``out``
    and ``lse`` and the output cotangent ``dout``.

    CUDA tensors launch the hand-written backward (f32, contiguous, int32
    lengths, head_dim in ``KERNEL_HEAD_DIMS``) or raise; CPU tensors take
    ``packed_attention_bwd_reference``. ``packed_attention_bwd.launches``
    counts kernel launches.
    """
    return _packed_bwd(packed_attention_bwd, "msfa_packed_attention_bwd", torch.float32,
                       packed_attention_bwd_reference, qkv, lengths, out, lse, dout, num_heads,
                       sm_scale)


packed_attention_bwd.launches = 0


def packed_attention_bf16_reference(
    qkv: torch.Tensor, lengths: torch.Tensor, num_heads: int, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the bf16 forward entry: the f32 arithmetic of
    ``packed_attention_reference`` on the bf16 values of ``qkv`` ->
    ``(out, lse)`` in f32, as the reference's interpret path computes it."""
    _check_bf16(qkv)
    return packed_attention_reference(qkv.float(), lengths, num_heads, sm_scale)


def packed_attention_bwd_bf16_reference(qkv, lengths, out, lse, dout, num_heads: int,
                                        sm_scale: float) -> torch.Tensor:
    """Plain version of the bf16 backward entry: the f32 backward on the bf16
    values of ``qkv``, ``dqkv`` rounded to bf16 (the VJP of the reference's
    cast to f32)."""
    _check_bf16(qkv)
    return packed_attention_bwd_reference(
        qkv.float(), lengths, out, lse, dout, num_heads, sm_scale).to(torch.bfloat16)


def _check_bf16(qkv: torch.Tensor) -> None:
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 entries take bfloat16 qkv, got {qkv.dtype}")


def packed_attention_fwd_bf16(
    qkv: torch.Tensor, lengths: torch.Tensor, num_heads: int, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper, bf16 operands: ``(out [B,T,F], lse [B,T,H])``, both
    f32, from a bfloat16 packed ``qkv``. CUDA tensors launch the bf16 entry
    of the packed forward (contiguous, int32 lengths, head_dim in
    ``KERNEL_HEAD_DIMS``) or raise; CPU tensors take
    ``packed_attention_bf16_reference``. Counted in
    ``packed_attention_fwd_bf16.launches``."""
    return _packed_fwd(packed_attention_fwd_bf16, "msfa_packed_attention_fwd_bf16",
                       torch.bfloat16, packed_attention_bf16_reference, qkv, lengths, num_heads,
                       sm_scale)


packed_attention_fwd_bf16.launches = 0


def packed_attention_bwd_bf16(qkv, lengths, out, lse, dout, num_heads: int,
                              sm_scale: float) -> torch.Tensor:
    """Kernel wrapper, bf16 operands: packed ``dqkv [B,T,3F]`` in bfloat16
    from a bfloat16 ``qkv`` and the forward's f32 ``out`` and ``lse`` and an
    f32 cotangent ``dout``. CUDA tensors launch the bf16 entry of the packed
    backward or raise; CPU tensors take
    ``packed_attention_bwd_bf16_reference``. Counted in
    ``packed_attention_bwd_bf16.launches``."""
    return _packed_bwd(packed_attention_bwd_bf16, "msfa_packed_attention_bwd_bf16",
                       torch.bfloat16, packed_attention_bwd_bf16_reference, qkv, lengths, out,
                       lse, dout, num_heads, sm_scale)


packed_attention_bwd_bf16.launches = 0


class PackedAttention(torch.autograd.Function):
    """``out = attention(qkv)`` with the kernel pair as forward and backward
    (counterpart of the JAX package's custom VJP ``_packed_core``): the f32
    entries for an f32 ``qkv``, the bf16 entries for a bfloat16 one. Saves
    ``qkv, lengths, out, lse``; ``out`` is f32 either way; returns packed
    ``dqkv`` in ``qkv``'s type and no gradient for the lengths."""

    @staticmethod
    def forward(ctx, qkv, lengths, num_heads: int, sm_scale: float):
        fwd = packed_attention_fwd_bf16 if qkv.dtype == torch.bfloat16 else packed_attention_fwd
        out, lse = fwd(qkv, lengths, num_heads, sm_scale)
        ctx.save_for_backward(qkv, lengths, out, lse)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, lengths, out, lse = ctx.saved_tensors
        bwd = packed_attention_bwd_bf16 if qkv.dtype == torch.bfloat16 else packed_attention_bwd
        dqkv = bwd(qkv, lengths, out, lse, dout.float().contiguous(), ctx.num_heads,
                   ctx.sm_scale)
        return dqkv, None, None, None


def flash_mha_packed(
    qkv: torch.Tensor,  # [B, T, 3*H*d]
    lengths: Optional[torch.Tensor] = None,  # [B] valid key timesteps
    *,
    num_heads: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention on the packed qkv layout -> ``[B, T, H*d]`` in f32,
    differentiable through ``PackedAttention`` (the backward kernel gives
    ``dqkv``); with no gradient to record it calls the forward as the op
    ``msfa::packed_attention_fwd`` (``ops/library.py``). A bfloat16 ``qkv``
    runs the bf16 entries; any other type is cast to f32, as in the
    reference.

    Same contract as the reference's ``flash_mha_packed``: T is padded to a
    multiple of 8 (padded key columns are masked through ``lengths``),
    ``lengths=None`` means every key is valid, and ``sm_scale`` defaults to
    ``head_dim ** -0.5``. A head_dim the kernels are not built for is padded
    with zero columns up to ``kernel_head_dim`` (the same function); one above
    ``KERNEL_HEAD_DIMS``' largest raises on the card.
    """
    batch, seq_len = qkv.shape[:2]
    if lengths is None:
        lengths = torch.full((batch,), seq_len, dtype=torch.int32, device=qkv.device)
    head_dim = _check_packed(qkv, lengths, num_heads)
    if sm_scale is None:
        sm_scale = head_dim**-0.5
    width = kernel_head_dim(head_dim) or head_dim
    if width != head_dim:  # zero columns up to the kernels' next head_dim
        qkv = _pad_head_dim(qkv.reshape(batch, seq_len, 3, num_heads, head_dim), head_dim,
                            width).reshape(batch, seq_len, 3 * num_heads * width)
    pad = (-seq_len) % 8
    if pad:
        qkv = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
    operands = (qkv if qkv.dtype == torch.bfloat16 else qkv.float()).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    from . import library  # registers the msfa:: ops

    if library.recorded(operands):
        out = PackedAttention.apply(operands, lengths, num_heads, float(sm_scale))
    else:  # no gradient to record (eval): the registered op, which an exported graph holds
        op = (library.packed_attention_fwd_bf16 if operands.dtype == torch.bfloat16
              else library.packed_attention_fwd)
        out = op(operands, lengths, num_heads, float(sm_scale))[0]
    out = out[:, :seq_len] if pad else out
    if width != head_dim:
        out = out.reshape(batch, seq_len, num_heads, width)[..., :head_dim].reshape(
            batch, seq_len, num_heads * head_dim)
    return out


# ---------------------------------------------------------------------------
# Head-major layout: flash_self_attention and its five kernels
# ---------------------------------------------------------------------------

# Padded length up to which the single-key-block forward and the fused
# backward are routed (the reference's MSFA_FLASH_SINGLE_K_MAX and
# MSFA_FLASH_FUSED_BWD_MAX defaults), and its default blocks.
SINGLE_K_MAX = 2048
FUSED_BWD_MAX = 1024
BLOCK_Q = 512
BLOCK_K = 512


def _check_flash(q, k, v, lengths, heads: int) -> Tuple[int, int, int]:
    """Shapes of the flattened ``[B*H, T, d]`` operands -> ``(B, T, d)``."""
    if q.dim() != 3:
        raise ValueError(f"q must be [B*H, T, d], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must have equal shapes, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    rows, seq, head_dim = q.shape
    if heads <= 0 or rows % heads:
        raise ValueError(f"leading dim {rows} must be batch * heads (heads={heads})")
    batch = rows // heads
    if lengths.shape != (batch,):
        raise ValueError(f"lengths must be [B] = [{batch}], got {tuple(lengths.shape)}")
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return batch, seq, head_dim


def _key_mask(lengths: torch.Tensor, heads: int, seq: int) -> torch.Tensor:
    """``[B*H, 1, T]`` bool: key column below the row's length."""
    cols = torch.arange(seq, device=lengths.device)[None, :]
    mask = cols < lengths.to(torch.int64)[:, None]
    return mask.repeat_interleave(heads, dim=0)[:, None, :]


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor, heads: int,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the single-key-block forward on ``[B*H, T, d]``:
    ``(out [B*H, T, d], lse [B*H, T])``. One max, one exp, one normalise per
    score row; masked scores ``NEG_INF``; exact zeros and ``lse = NEG_INF``
    for rows without a valid key."""
    _batch, seq, _d = _check_flash(q, k, v, lengths, heads)
    colmask = _key_mask(lengths, heads, seq)
    scores = torch.where(colmask, (q.float() @ k.float().transpose(-1, -2)) * sm_scale, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(colmask, torch.exp(scores - m.clamp(min=NEG_INF / 2)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    out = torch.where(l > 0, (p @ v.float()) / safe_l, 0.0)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    return out, lse[..., 0]


def flash_attention_tiled_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor, heads: int,
    sm_scale: float, block_k: int = BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the tiled forward: the same ``(out, lse)`` by
    online softmax over key blocks of ``block_k`` (running max, correction,
    rescaled accumulator), as the TPU kernel ``_flash_kernel`` merges them."""
    _batch, seq, _d = _check_flash(q, k, v, lengths, heads)
    q, k, v = q.float(), k.float(), v.float()
    colmask = _key_mask(lengths, heads, seq)
    m = torch.full(q.shape[:2] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, seq, block_k):
        cols = slice(k0, min(k0 + block_k, seq))
        valid = colmask[..., cols]
        scores = torch.where(valid, (q @ k[:, cols].transpose(-1, -2)) * sm_scale, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(scores - m_new), 0.0)
        correction = torch.where(m <= NEG_INF, 0.0, torch.exp((m - m_new).clamp(max=0.0)))
        l = l * correction + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + p @ v[:, cols]
        m = m_new
    safe_l = torch.where(l > 0, l, 1.0)
    out = torch.where(l > 0, acc / safe_l, 0.0)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    return out, lse[..., 0]


def _p_and_ds(q, k, v, lengths, heads, lse, delta, dout, sm_scale):
    """``p`` and ``ds = p * (dp - delta) * sm_scale`` as the TPU backward
    kernels recompute them from the saved ``lse``."""
    colmask = _key_mask(lengths, heads, q.shape[1])
    lse_col = lse.float()[..., None]
    keep = colmask & (lse_col > NEG_INF / 2)
    scores = (q @ k.transpose(-1, -2)) * sm_scale
    p = torch.where(keep, torch.exp(scores - lse_col.clamp(min=NEG_INF / 2)), 0.0)
    ds = p * (dout @ v.transpose(-1, -2) - delta.float()[..., None]) * sm_scale
    return p, ds


def _bwd_products(q, k, v, lengths, heads, lse, delta, dout, sm_scale, want=("dq", "dk", "dv")):
    q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
    p, ds = _p_and_ds(q, k, v, lengths, heads, lse, delta, dout, sm_scale)
    products = {"dq": lambda: ds @ k, "dk": lambda: ds.transpose(-1, -2) @ q,
                "dv": lambda: p.transpose(-1, -2) @ dout}
    return tuple(products[name]() for name in want)


def flash_dkv_reference(q, k, v, lengths, heads: int, lse, delta, dout, sm_scale: float):
    """Plain version of the split backward's first kernel -> ``(dk, dv)``."""
    _check_flash(q, k, v, lengths, heads)
    return _bwd_products(q, k, v, lengths, heads, lse, delta, dout, sm_scale, ("dk", "dv"))


def flash_dq_reference(q, k, v, lengths, heads: int, lse, delta, dout, sm_scale: float):
    """Plain version of the split backward's second kernel -> ``dq``."""
    _check_flash(q, k, v, lengths, heads)
    return _bwd_products(q, k, v, lengths, heads, lse, delta, dout, sm_scale, ("dq",))[0]


def flash_bwd_fused_reference(q, k, v, lengths, heads: int, lse, delta, dout, sm_scale: float):
    """Plain version of the fused backward -> ``(dq, dk, dv)``; p, dp and ds
    are computed once, as the fused TPU kernel does."""
    _check_flash(q, k, v, lengths, heads)
    return _bwd_products(q, k, v, lengths, heads, lse, delta, dout, sm_scale)


def flash_attention_bwd_reference(
    q, k, v, lengths, heads: int, out, lse, dout, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the whole backward -> ``(dq, dk, dv)`` from
    the forward's ``out`` and ``lse`` and the cotangent ``dout``, with
    ``delta = rowsum(dout * out)``."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    return flash_bwd_fused_reference(q, k, v, lengths, heads, lse, delta, dout, sm_scale)


def _flash_kernel_call(source: str, symbol: str, tensors, outputs, lengths, heads: int,
                       sm_scale: float, what: str):
    """Check the kernel's inputs and launch ``symbol`` of ``source`` with the
    argument order ``(*tensors, lengths?, *outputs, B, T, H, D, scale, stream)``
    the C entry points share (``lengths`` follows q, k, v)."""
    q = tensors[0]
    batch, seq, head_dim = q.shape[0] // heads, q.shape[1], q.shape[2]
    for i, t in enumerate(tensors):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: kernel takes float32 tensors, got {t.dtype} (input {i})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: input {i} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{what}: input {i} is on {t.device}, q on {q.device}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"{what}: kernel takes contiguous int32 lengths, got {lengths.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: kernel supports head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}")
    lib = _build.library(source)
    fn = getattr(lib, symbol)
    n_ptrs = len(tensors) + 1 + len(outputs)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pointers = [t.data_ptr() for t in tensors[:3]] + [lengths.data_ptr()]
    pointers += [t.data_ptr() for t in tensors[3:]] + [t.data_ptr() for t in outputs]
    with torch.cuda.device(q.device):
        code = fn(*pointers, batch, seq, heads, head_dim, float(sm_scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, what)


def _flash_fwd(kernel_symbol: str, reference, wrapper, q, k, v, lengths, heads, sm_scale):
    _check_flash(q, k, v, lengths, heads)
    if q.device.type == "cpu":
        return reference()
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], device=q.device, dtype=torch.float32)
    if q.numel():
        _flash_kernel_call("flash_attention", kernel_symbol, (q, k, v), (out, lse), lengths,
                           heads, sm_scale, wrapper.__name__)
        wrapper.launches += 1
    return out, lse


def flash_fwd_single(q, k, v, lengths, heads: int, sm_scale: float):
    """Kernel wrapper, single-key-block forward: ``(out [B*H,T,d], lse [B*H,T])``
    from ``q, k, v [B*H, T, d]`` and ``lengths [B]``. CUDA tensors launch the
    kernel (f32, contiguous, int32 lengths, head_dim in ``KERNEL_HEAD_DIMS``,
    any T) or raise; CPU tensors take ``flash_attention_reference``."""
    return _flash_fwd(
        "msfa_flash_fwd_single",
        lambda: flash_attention_reference(q, k, v, lengths, heads, sm_scale),
        flash_fwd_single, q, k, v, lengths, heads, sm_scale)


flash_fwd_single.launches = 0


def flash_fwd_tiled(q, k, v, lengths, heads: int, sm_scale: float, block_k: int = BLOCK_K):
    """Kernel wrapper, tiled online-softmax forward: same contract as
    ``flash_fwd_single`` for any T. CPU tensors take
    ``flash_attention_tiled_reference`` with key blocks of ``block_k``; the
    kernel's key tile is 64 whatever ``block_k`` is."""
    return _flash_fwd(
        "msfa_flash_fwd_tiled",
        lambda: flash_attention_tiled_reference(q, k, v, lengths, heads, sm_scale, block_k),
        flash_fwd_tiled, q, k, v, lengths, heads, sm_scale)


flash_fwd_tiled.launches = 0


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dout * out)`` -> ``[B*H, T]``, the softmax Jacobian's
    row term that all three backward kernels read. A small kernel on the
    card, a plain sum on the CPU."""
    if out.shape != dout.shape or out.device != dout.device:
        raise ValueError(f"out {tuple(out.shape)} on {out.device} and dout {tuple(dout.shape)} "
                         f"on {dout.device} must match")
    if out.device.type == "cpu":
        return (dout.float() * out.float()).sum(dim=-1)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"flash_delta takes contiguous float32 {name}, got {t.dtype}")
    delta = torch.empty(out.shape[:-1], device=out.device, dtype=torch.float32)
    if delta.numel() == 0:
        return delta
    lib = _build.library("flash_attention_bwd")
    fn = lib.msfa_flash_delta
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(out.device):
        code = fn(out.data_ptr(), dout.data_ptr(), delta.data_ptr(), delta.numel(),
                  out.shape[-1], torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(lib, code, "flash_delta")
    return delta


def _flash_bwd(symbol: str, reference, wrapper, n_out: int, q, k, v, lengths, heads, lse, delta,
               dout, sm_scale, scratch: bool = False):
    _check_flash(q, k, v, lengths, heads)
    for name, t, shape in (("lse", lse, q.shape[:2]), ("delta", delta, q.shape[:2]),
                           ("dout", dout, q.shape)):
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type == "cpu":
        return reference(q, k, v, lengths, heads, lse, delta, dout, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    outputs = tuple(torch.empty_like(q) for _ in range(n_out))
    if q.numel():
        extra = ()
        if scratch:  # the kernel's per-key-tile dq partials, summed in order by its second launch
            query = getattr(_build.library("flash_attention_bwd"), symbol + "_scratch")
            query.argtypes = [ctypes.c_int] * 4
            query.restype = ctypes.c_longlong
            rows, seq, head_dim = q.shape
            extra = (torch.empty(query(rows // heads, seq, heads, head_dim), device=q.device,
                                 dtype=torch.float32),)
        _flash_kernel_call("flash_attention_bwd", symbol, (q, k, v, lse, delta, dout),
                           outputs + extra, lengths, heads, sm_scale, wrapper.__name__)
        wrapper.launches += 1
    return outputs if n_out > 1 else outputs[0]


def flash_bwd_fused(q, k, v, lengths, heads: int, lse, delta, dout, sm_scale: float):
    """Kernel wrapper, fused backward: ``(dq, dk, dv)``, each ``[B*H, T, d]``:
    one kernel computes dk, dv and a dq partial per 64-key tile (into a
    ``[B*H, ceil(T/64), T, d]`` scratch), a second launch of the same entry
    point sums the partials in key-tile order. CUDA tensors launch it or
    raise; CPU tensors take ``flash_bwd_fused_reference``."""
    return _flash_bwd("msfa_flash_bwd_fused", flash_bwd_fused_reference, flash_bwd_fused, 3,
                      q, k, v, lengths, heads, lse, delta, dout, sm_scale, scratch=True)


flash_bwd_fused.launches = 0


def flash_bwd_dkv(q, k, v, lengths, heads: int, lse, delta, dout, sm_scale: float):
    """Kernel wrapper, split backward, first kernel: ``(dk, dv)`` per key tile,
    the fused kernel's dk and dv bit for bit. CUDA tensors launch it or
    raise; CPU tensors take ``flash_dkv_reference``."""
    return _flash_bwd("msfa_flash_bwd_dkv", flash_dkv_reference, flash_bwd_dkv, 2,
                      q, k, v, lengths, heads, lse, delta, dout, sm_scale)


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, lengths, heads: int, lse, delta, dout, sm_scale: float):
    """Kernel wrapper, split backward, second kernel: ``dq`` per query tile
    (recomputes the scores and dp; each key tile's ``ds k`` added in key-tile
    order). CUDA tensors launch it or raise; CPU tensors take
    ``flash_dq_reference``."""
    return _flash_bwd("msfa_flash_bwd_dq", flash_dq_reference, flash_bwd_dq, 1,
                      q, k, v, lengths, heads, lse, delta, dout, sm_scale)


flash_bwd_dq.launches = 0


def flash_routes(padded_len: int, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                 single_k_max: int = SINGLE_K_MAX, fused_bwd_max: int = FUSED_BWD_MAX):
    """``(forward, backward)`` route names for a padded length, as the
    reference's ``_flash_forward`` and ``_flash_backward`` choose them:
    ``"single"`` or ``"tiled"``, and ``"fused"`` or ``"split"``."""
    forward = "single" if padded_len <= max(block_k, single_k_max) else "tiled"
    backward = "fused" if padded_len <= max(min(block_q, block_k), fused_bwd_max) else "split"
    return forward, backward


class FlashAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` on ``[B*H, T, d]`` with the routed kernels
    as forward and backward (counterpart of the JAX package's custom VJP
    ``_flash_core``). Saves ``q, k, v, lengths, out, lse``; no gradient for
    the lengths."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, heads: int, sm_scale: float, routes, block_k: int):
        if routes[0] == "single":
            out, lse = flash_fwd_single(q, k, v, lengths, heads, sm_scale)
        else:
            out, lse = flash_fwd_tiled(q, k, v, lengths, heads, sm_scale, block_k)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        ctx.heads, ctx.sm_scale, ctx.route = heads, sm_scale, routes[1]
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        dout = dout.float().contiguous()
        delta = flash_delta(out, dout)
        args = (q, k, v, lengths, ctx.heads, lse, delta, dout, ctx.sm_scale)
        if ctx.route == "fused":
            dq, dk, dv = flash_bwd_fused(*args)
        else:
            dk, dv = flash_bwd_dkv(*args)
            dq = flash_bwd_dq(*args)
        return dq, dk, dv, None, None, None, None, None


def flash_self_attention(
    q: torch.Tensor,  # [B, H, T, d]
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # [B] valid key timesteps
    sm_scale: Optional[float] = None,
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
    *,
    single_k_max: int = SINGLE_K_MAX,
    fused_bwd_max: int = FUSED_BWD_MAX,
) -> torch.Tensor:
    """Attention on ``[B, H, T, d]`` -> ``[B, H, T, d]``; the scores never
    reach device memory. Differentiable through ``FlashAttention``; with no
    gradient to record the forward is the op ``msfa::flash_fwd_single`` or
    ``msfa::flash_fwd_tiled`` (``ops/library.py``).

    The reference's wrapper semantics: ``block_q`` and ``block_k`` are clipped
    to T; a T that is not a multiple of both is padded with zeros up to a
    multiple of the larger and the output sliced back (padded keys lie past
    every length); ``lengths=None`` means all T keys; ``sm_scale`` defaults to
    ``d ** -0.5``; the padded length picks the routes (``flash_routes``). The
    kernels use their own 64-wide tiles whatever the blocks are; the blocks
    decide padding and routing only. A ``d`` the kernels are not built for is
    padded with zero columns up to ``kernel_head_dim`` (the same function);
    one above ``KERNEL_HEAD_DIMS``' largest raises ``ValueError`` on the card.
    """
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, d], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must have equal shapes, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    batch, heads, seq_len, head_dim = q.shape
    if lengths is None:
        lengths = torch.full((batch,), seq_len, dtype=torch.int32, device=q.device)
    if lengths.shape != (batch,):
        raise ValueError(f"lengths must be [B] = [{batch}], got {tuple(lengths.shape)}")
    if sm_scale is None:
        sm_scale = head_dim**-0.5
    block_q = min(block_q, seq_len)
    block_k = min(block_k, seq_len)
    pad = 0
    if seq_len and (seq_len % block_q or seq_len % block_k):
        target = max(block_q, block_k)
        pad = -seq_len % target
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    padded_len = seq_len + pad
    routes = flash_routes(padded_len, block_q, block_k, single_k_max, fused_bwd_max)
    width = kernel_head_dim(head_dim) or head_dim  # zero columns up to the kernels' next
    flat = [_pad_head_dim(t.float(), head_dim, width).reshape(batch * heads, padded_len, width)
            .contiguous() for t in (q, k, v)]
    lengths = lengths.to(torch.int32).contiguous()
    from . import library  # registers the msfa:: ops

    if library.recorded(*flat):
        out = FlashAttention.apply(*flat, lengths, heads, float(sm_scale), routes, block_k)
    elif routes[0] == "single":  # no gradient to record (eval): the registered ops
        out = library.flash_fwd_single(*flat, lengths, heads, float(sm_scale))[0]
    else:
        out = library.flash_fwd_tiled(*flat, lengths, heads, float(sm_scale), block_k)[0]
    out = out.reshape(batch, heads, padded_len, width)
    out = out[:, :, :seq_len] if pad else out
    return out[..., :head_dim] if width != head_dim else out
