"""Packed multi-head self-attention forward: CUDA kernel and its plain twin.

Counterpart of the JAX package's ``ops/pallas_attention.py::flash_mha_packed``
(forward only; the backward comes with the training slice). The input is the
qkv projection's natural ``[B, T, 3*H*d]`` layout (q | k | v along the minor
dim, heads sliced inside each third) plus per-row valid key lengths; the
output is ``[B, T, H*d]``. Key columns at or past a row's length are masked;
a row with no valid key gives exact zeros (and ``lse = NEG_INF``).

``packed_attention_fwd`` is the kernel wrapper: a CUDA tensor launches
``csrc/packed_attention.cu`` or raises, a CPU tensor takes
``packed_attention_reference``, the plain PyTorch version of the same math.
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


def flash_mha_packed(
    qkv: torch.Tensor,  # [B, T, 3*H*d]
    lengths: Optional[torch.Tensor] = None,  # [B] valid key timesteps
    *,
    num_heads: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention on the packed qkv layout -> ``[B, T, H*d]`` (forward only).

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
    out, _lse = packed_attention_fwd(
        qkv.float().contiguous(), lengths.to(torch.int32).contiguous(), num_heads, sm_scale
    )
    return out[:, :seq_len] if pad else out
