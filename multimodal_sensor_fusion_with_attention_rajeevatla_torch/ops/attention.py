"""Packed multi-head self-attention, forward and backward: CUDA kernels and
their plain twins.

Counterpart of the JAX package's ``ops/pallas_attention.py::flash_mha_packed``
and its custom VJP ``_packed_core``. The input is the qkv projection's
natural ``[B, T, 3*H*d]`` layout (q | k | v along the minor dim, heads
sliced inside each third) plus per-row valid key lengths; the output is
``[B, T, H*d]``. Key columns at or past a row's length are masked; a row
with no valid key gives exact zeros (and ``lse = NEG_INF``) and zero
gradients.

``packed_attention_fwd`` and ``packed_attention_bwd`` are the kernel
wrappers: a CUDA tensor launches ``csrc/packed_attention.cu`` or
``csrc/packed_attention_bwd.cu`` or raises, a CPU tensor takes
``packed_attention_reference`` or ``packed_attention_bwd_reference``, the
plain PyTorch versions of the same math. ``flash_mha_packed`` runs both
through one ``torch.autograd.Function``.
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


def packed_route_ok(seq_len: int, num_heads: int, head_dim: int) -> bool:
    """True when the packed kernel takes this shape (padded T <= 512)."""
    del num_heads, head_dim  # the route depends on the sequence length only
    padded = ((seq_len + 7) // 8) * 8
    return padded <= PACKED_MAX_LEN


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


def _kernel_fn():
    lib = _build.library("packed_attention")
    fn = lib.msfa_packed_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def packed_attention_fwd(
    qkv: torch.Tensor, lengths: torch.Tensor, num_heads: int, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: ``(out [B,T,F], lse [B,T,H])`` from packed ``qkv``.

    CUDA tensors launch the hand-written kernel (f32, contiguous, int32
    lengths, head_dim in ``KERNEL_HEAD_DIMS``) or raise; CPU tensors take
    ``packed_attention_reference``. ``packed_attention_fwd.launches`` counts
    kernel launches.
    """
    head_dim = _check_packed(qkv, lengths, num_heads)
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, lengths, num_heads, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.float32 or lengths.dtype != torch.int32:
        raise TypeError(
            f"kernel takes float32 qkv and int32 lengths, got {qkv.dtype} and {lengths.dtype}"
        )
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
    lib, fn = _kernel_fn()
    with torch.cuda.device(qkv.device):
        code = fn(
            qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
            batch, seq, num_heads, head_dim, float(sm_scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(lib, code, "packed_attention_fwd")
    packed_attention_fwd.launches += 1
    return out, lse


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


def _bwd_kernel_fn():
    lib = _build.library("packed_attention_bwd")
    fn = lib.msfa_packed_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


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
        return packed_attention_bwd_reference(qkv, lengths, out, lse, dout, num_heads, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    tensors["qkv"] = qkv
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"kernel takes contiguous int32 lengths, got {lengths.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel supports head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}")
    dqkv = torch.empty_like(qkv)
    if batch == 0 or seq == 0:
        return dqkv
    delta = torch.empty((batch, seq, num_heads), device=qkv.device, dtype=torch.float32)
    lib, fn = _bwd_kernel_fn()
    with torch.cuda.device(qkv.device):
        code = fn(
            qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
            batch, seq, num_heads, head_dim, float(sm_scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(lib, code, "packed_attention_bwd")
    packed_attention_bwd.launches += 1
    return dqkv


packed_attention_bwd.launches = 0


class PackedAttention(torch.autograd.Function):
    """``out = attention(qkv)`` with the kernel pair as forward and backward
    (counterpart of the JAX package's custom VJP ``_packed_core``). Saves
    ``qkv, lengths, out, lse``; returns packed ``dqkv`` and no gradient for
    the lengths."""

    @staticmethod
    def forward(ctx, qkv, lengths, num_heads: int, sm_scale: float):
        out, lse = packed_attention_fwd(qkv, lengths, num_heads, sm_scale)
        ctx.save_for_backward(qkv, lengths, out, lse)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, lengths, out, lse = ctx.saved_tensors
        dqkv = packed_attention_bwd(
            qkv, lengths, out, lse, dout.float().contiguous(), ctx.num_heads, ctx.sm_scale
        )
        return dqkv, None, None, None


def flash_mha_packed(
    qkv: torch.Tensor,  # [B, T, 3*H*d]
    lengths: Optional[torch.Tensor] = None,  # [B] valid key timesteps
    *,
    num_heads: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention on the packed qkv layout -> ``[B, T, H*d]``, differentiable
    through ``PackedAttention`` (the backward kernel gives ``dqkv``).

    Same contract as the reference's ``flash_mha_packed``: T is padded to a
    multiple of 8 (padded key columns are masked through ``lengths``),
    ``lengths=None`` means every key is valid, and ``sm_scale`` defaults to
    ``head_dim ** -0.5``.
    """
    batch, seq_len = qkv.shape[:2]
    if lengths is None:
        lengths = torch.full((batch,), seq_len, dtype=torch.int32, device=qkv.device)
    head_dim = _check_packed(qkv, lengths, num_heads)
    if sm_scale is None:
        sm_scale = head_dim**-0.5
    pad = (-seq_len) % 8
    if pad:
        qkv = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
    out = PackedAttention.apply(
        qkv.float().contiguous(), lengths.to(torch.int32).contiguous(), num_heads, float(sm_scale)
    )
    return out[:, :seq_len] if pad else out
