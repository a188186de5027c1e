"""Fused residual-LayerNorm halves of the transformer layer: CUDA kernels,
their plain twins and their autograd Functions.

Counterpart of the fused residual-LN part of the JAX package's
``ops/pallas_mlp.py``:

- ``fused_proj_residual_ln``: ``LayerNorm(x + dropout(a @ wo + bo))``, the
  layer's first half after attention;
- ``fused_mlp_residual_ln``: ``LayerNorm(x + dropout(ffw(x)))`` with
  ``ffw(x) = dropout(relu(x @ w1 + b1)) @ w2 + b2``, the second half.

Weights use the reference's ``[in, out]`` layout. Dropout comes as u8 keep
masks drawn outside the kernels (the caller's generator), scaled by
``1 / keep_prob`` inside; ``keep_prob <= 0`` scales by 0, so an all-drop
mask gives exact zeros and no NaN. The LayerNorm is flax's: float32
statistics, fast variance ``max(E[r^2] - E[r]^2, 0)``, eps 1e-6.

Each pass has a kernel wrapper (``proj_ln_fwd``, ``proj_ln_bwd``,
``ffw_ln_fwd``, ``ffw_ln_bwd``): a CUDA tensor launches ``csrc/proj_ln.cu``
or ``csrc/ffw_ln.cu`` or raises, a CPU tensor takes the ``*_reference`` twin
(the TPU kernel's arithmetic in plain PyTorch). Each wrapper counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

KERNEL_WIDTHS = (32, 64, 128, 256)  # d_model the kernels are instantiated for
FFW_CHUNK = 64  # d_ff must be a multiple of the kernel's hidden chunk
ROW_TILE = 32  # rows per block in both kernels
_SMS = 132  # H100 SXM streaming multiprocessors: sizes the row splits of the sums


def _inv_keep(keep_prob: float) -> float:
    """``1/keep_prob``, and 0.0 at ``keep_prob <= 0``: the mask is then
    all-drop and the output exactly zero, not NaN (``Dropout(p=1)``)."""
    return 0.0 if keep_prob <= 0.0 else float(1.0 / keep_prob)


def ln_rows(r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """flax LayerNorm over the last dim: ``(out, xhat, inv)``."""
    mu = r.mean(dim=-1, keepdim=True)
    var = ((r * r).mean(dim=-1, keepdim=True) - mu * mu).clamp(min=0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (r - mu) * inv
    return xhat * gamma + beta, xhat, inv


def _scale(mask: Optional[torch.Tensor], inv_keep: float):
    return None if mask is None else mask.float() * inv_keep


def _ln_backward(dout, xhat, inv, gamma):
    """LayerNorm backward of the TPU kernels: ``(dr, dgamma, dbeta)``."""
    gdo = dout * gamma
    mean_g = gdo.mean(dim=-1, keepdim=True)
    mean_gx = (gdo * xhat).mean(dim=-1, keepdim=True)
    dr = (gdo - mean_g - xhat * mean_gx) * inv
    return dr, (dout * xhat).sum(0), dout.sum(0)


# ------------------------------------------------------------ plain twins


def proj_ln_fwd_reference(x, a, wo, bo, gamma, beta, rmask, inv_keep: float, eps: float):
    """Plain version of the projection kernel's forward -> ``out [N, D]``."""
    y = a @ wo + bo
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    return ln_rows(x + y, gamma, beta, eps)[0]


def proj_ln_bwd_reference(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep: float, eps: float):
    """Plain version of the projection kernel's backward ->
    ``(dx, da, dwo, dbo, dgamma, dbeta)``."""
    y = a @ wo + bo
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    _out, xhat, inv = ln_rows(x + y, gamma, beta, eps)
    dr, dgamma, dbeta = _ln_backward(dout, xhat, inv, gamma)
    dy = dr * rscale if rscale is not None else dr
    return dr, dy @ wo.t(), a.t() @ dy, dy.sum(0), dgamma, dbeta


def ffw_ln_fwd_reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float,
                         eps: float):
    """Plain version of the FFW kernel's forward -> ``out [N, D]``."""
    h = torch.relu(x @ w1 + b1)
    fscale = _scale(fmask, inv_keep)
    if fscale is not None:
        h = h * fscale
    y = h @ w2 + b2
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    return ln_rows(x + y, gamma, beta, eps)[0]


def ffw_ln_bwd_reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout,
                         inv_keep: float, eps: float):
    """Plain version of the FFW kernel's backward ->
    ``(dx, dw1, db1, dw2, db2, dgamma, dbeta)``."""
    pre = x @ w1 + b1
    fscale = _scale(fmask, inv_keep)
    hd = torch.relu(pre) if fscale is None else torch.relu(pre) * fscale
    y = hd @ w2 + b2
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    _out, xhat, inv = ln_rows(x + y, gamma, beta, eps)
    dr, dgamma, dbeta = _ln_backward(dout, xhat, inv, gamma)
    dy = dr * rscale if rscale is not None else dr
    dhd = dy @ w2.t()
    if fscale is not None:
        dhd = dhd * fscale
    dpre = torch.where(pre > 0.0, dhd, 0.0)
    dx = dr + dpre @ w1.t()
    return dx, x.t() @ dpre, dpre.sum(0), hd.t() @ dy, dy.sum(0), dgamma, dbeta


# ------------------------------------------------------------ kernel wrappers


def _check(tensors: dict, shapes: dict, device: torch.device) -> None:
    for name, shape in shapes.items():
        t = tensors[name]
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")


def _check_kernel_inputs(tensors: dict, width: int) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        want = torch.uint8 if name.endswith("mask") else torch.float32
        if t.dtype != want:
            raise TypeError(f"kernel takes {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if width not in KERNEL_WIDTHS:
        raise ValueError(f"kernel supports d_model in {KERNEL_WIDTHS}, got {width}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _splits(rows: int, tiles: int) -> int:
    """Row splits of a cross-block sum: enough blocks for two waves over the
    SMs, at least 256 rows per split."""
    return max(1, min(math.ceil(2 * _SMS / max(tiles, 1)), math.ceil(rows / 256)))


def _tiles(i: int, o: int) -> int:
    return math.ceil(i / 64) * math.ceil(o / 64)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _fn(source: str, symbol: str, n_ptrs: int, n_ints: int, n_floats: int):
    lib = _build.library(source)
    fn = getattr(lib, symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
        + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def _proj_shapes(x, d):
    n = x.shape[0]
    return {"x": (n, d), "a": (n, d), "wo": (d, d), "bo": (d,), "gamma": (d,),
            "beta": (d,), "rmask": (n, d)}


def proj_ln_fwd(x, a, wo, bo, gamma, beta, rmask, inv_keep: float, eps: float):
    """Kernel wrapper for the projection half's forward -> ``out [N, D]``."""
    d = x.shape[-1]
    tensors = {"x": x, "a": a, "wo": wo, "bo": bo, "gamma": gamma, "beta": beta,
               "rmask": rmask}
    _check(tensors, _proj_shapes(x, d), x.device)
    if x.device.type == "cpu":
        return proj_ln_fwd_reference(x, a, wo, bo, gamma, beta, rmask, inv_keep, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib, fn = _fn("proj_ln", "msfa_proj_ln_fwd", 8, 2, 2)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), a.data_ptr(), wo.data_ptr(), bo.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), _ptr(rmask), out.data_ptr(), n, d, float(inv_keep),
                  float(eps), _stream(x.device))
    _build.check(lib, code, "proj_ln_fwd")
    proj_ln_fwd.launches += 1
    return out


proj_ln_fwd.launches = 0


def proj_ln_bwd(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep: float, eps: float):
    """Kernel wrapper for the projection half's backward ->
    ``(dx, da, dwo, dbo, dgamma, dbeta)``."""
    d = x.shape[-1]
    tensors = {"x": x, "a": a, "wo": wo, "bo": bo, "gamma": gamma, "beta": beta,
               "rmask": rmask, "dout": dout}
    _check(tensors, {**_proj_shapes(x, d), "dout": x.shape}, x.device)
    if x.device.type == "cpu":
        return proj_ln_bwd_reference(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d)
    n = x.shape[0]
    dx, da = torch.empty_like(x), torch.empty_like(x)
    dwo = torch.empty((d, d), device=x.device)
    sums = torch.empty((3, d), device=x.device)
    if n == 0:
        dgamma, dbeta, dbo = sums.zero_().unbind(0)
        return dx, da, dwo.zero_(), dbo, dgamma, dbeta
    splits = _splits(n, _tiles(d, d))
    dy = torch.empty_like(x)
    partial = torch.empty((math.ceil(n / ROW_TILE), 3, d), device=x.device)
    atb_part = torch.empty((splits, d, d), device=x.device)
    lib, fn = _fn("proj_ln", "msfa_proj_ln_bwd", 15, 3, 2)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), a.data_ptr(), wo.data_ptr(), bo.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), _ptr(rmask), dout.data_ptr(), dx.data_ptr(), da.data_ptr(),
                  dwo.data_ptr(), sums.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                  atb_part.data_ptr(), n, d, splits, float(inv_keep), float(eps),
                  _stream(x.device))
    _build.check(lib, code, "proj_ln_bwd")
    proj_ln_bwd.launches += 1
    dgamma, dbeta, dbo = sums.unbind(0)
    return dx, da, dwo, dbo, dgamma, dbeta


proj_ln_bwd.launches = 0


def _ffw_shapes(x, d, f):
    n = x.shape[0]
    return {"x": (n, d), "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,),
            "gamma": (d,), "beta": (d,), "fmask": (n, f), "rmask": (n, d)}


def _check_ffw_width(f: int) -> None:
    if f % FFW_CHUNK:
        raise ValueError(f"kernel takes d_ff a multiple of {FFW_CHUNK}, got {f}")


def ffw_ln_fwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float, eps: float):
    """Kernel wrapper for the FFW half's forward -> ``out [N, D]``."""
    d, f = x.shape[-1], w1.shape[-1]
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "gamma": gamma,
               "beta": beta, "fmask": fmask, "rmask": rmask}
    _check(tensors, _ffw_shapes(x, d, f), x.device)
    if x.device.type == "cpu":
        return ffw_ln_fwd_reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d)
    _check_ffw_width(f)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib, fn = _fn("ffw_ln", "msfa_ffw_ln_fwd", 10, 3, 2)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), _ptr(fmask), _ptr(rmask), out.data_ptr(),
                  n, d, f, float(inv_keep), float(eps), _stream(x.device))
    _build.check(lib, code, "ffw_ln_fwd")
    ffw_ln_fwd.launches += 1
    return out


ffw_ln_fwd.launches = 0


def ffw_ln_bwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout, inv_keep: float,
               eps: float):
    """Kernel wrapper for the FFW half's backward ->
    ``(dx, dw1, db1, dw2, db2, dgamma, dbeta)``. The kernel keeps the
    recomputed hidden and its gradient in two ``[N, d_ff]`` scratch buffers
    allocated here (134 MB each at N = 16384, d_ff = 2048)."""
    d, f = x.shape[-1], w1.shape[-1]
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "gamma": gamma,
               "beta": beta, "fmask": fmask, "rmask": rmask, "dout": dout}
    _check(tensors, {**_ffw_shapes(x, d, f), "dout": x.shape}, x.device)
    if x.device.type == "cpu":
        return ffw_ln_bwd_reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout,
                                    inv_keep, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d)
    _check_ffw_width(f)
    n = x.shape[0]
    dx = torch.empty_like(x)
    dw1 = torch.empty((d, f), device=x.device)
    db1 = torch.empty((f,), device=x.device)
    dw2 = torch.empty((f, d), device=x.device)
    sums = torch.empty((3, d), device=x.device)
    if n == 0:
        dgamma, dbeta, db2 = sums.zero_().unbind(0)
        return dx, dw1.zero_(), db1.zero_(), dw2.zero_(), db2, dgamma, dbeta
    splits = _splits(n, _tiles(d, f))
    col_splits = _splits(n, math.ceil(f / 256))
    hd = torch.empty((n, f), device=x.device)
    dpre = torch.empty((n, f), device=x.device)
    dy = torch.empty_like(x)
    partial = torch.empty((math.ceil(n / ROW_TILE), 3, d), device=x.device)
    atb_part = torch.empty((splits, d, f), device=x.device)
    col_part = torch.empty((col_splits, f), device=x.device)
    lib, fn = _fn("ffw_ln", "msfa_ffw_ln_bwd", 20, 5, 2)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  gamma.data_ptr(), _ptr(fmask), _ptr(rmask), dout.data_ptr(), dx.data_ptr(),
                  dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), sums.data_ptr(),
                  hd.data_ptr(), dpre.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                  atb_part.data_ptr(), col_part.data_ptr(), n, d, f, splits, col_splits,
                  float(inv_keep), float(eps), _stream(x.device))
    _build.check(lib, code, "ffw_ln_bwd")
    ffw_ln_bwd.launches += 1
    dgamma, dbeta, db2 = sums.unbind(0)
    return dx, dw1, db1, dw2, db2, dgamma, dbeta


ffw_ln_bwd.launches = 0


# ------------------------------------------------------------ autograd


class FusedProjResidualLN(torch.autograd.Function):
    """``LayerNorm(x + dropout(a @ wo + bo))`` with the kernel pair as forward
    and backward (the JAX package's custom VJP ``_proj_ln_core``)."""

    @staticmethod
    def forward(ctx, x, a, wo, bo, gamma, beta, rmask, inv_keep: float, eps: float):
        out = proj_ln_fwd(x, a, wo, bo, gamma, beta, rmask, inv_keep, eps)
        ctx.save_for_backward(x, a, wo, bo, gamma, beta, rmask)
        ctx.inv_keep, ctx.eps = inv_keep, eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x, a, wo, bo, gamma, beta, rmask = ctx.saved_tensors
        grads = proj_ln_bwd(x, a, wo, bo, gamma, beta, rmask, dout.float().contiguous(),
                            ctx.inv_keep, ctx.eps)
        return (*grads, None, None, None)


class FusedMlpResidualLN(torch.autograd.Function):
    """``LayerNorm(x + dropout(ffw(x)))`` with the kernel pair as forward and
    backward (the JAX package's custom VJP ``_ffw_ln_core``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float,
                eps: float):
        out = ffw_ln_fwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep, eps)
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta, fmask, rmask)
        ctx.inv_keep, ctx.eps = inv_keep, eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, b1, w2, b2, gamma, beta, fmask, rmask = ctx.saved_tensors
        grads = ffw_ln_bwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask,
                           dout.float().contiguous(), ctx.inv_keep, ctx.eps)
        return (*grads, None, None, None, None)


def _as_mask(mask: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
    return None if mask is None else mask.reshape(rows, -1).to(torch.uint8).contiguous()


def fused_proj_residual_ln(
    x: torch.Tensor,  # [N, d] residual stream
    attended: torch.Tensor,  # [N, d] attention output (before the out-projection)
    wo: torch.Tensor,  # [d, d] out-projection, [in, out]
    bo: torch.Tensor,  # [d]
    gamma: torch.Tensor,
    beta: torch.Tensor,  # LayerNorm scale / bias [d]
    res_mask: Optional[torch.Tensor] = None,  # [N, d] keep mask (bool or u8)
    keep_prob: float = 1.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``LayerNorm(x + dropout(attended @ wo + bo))``, differentiable, with
    the signature of the reference's ``fused_proj_residual_ln``."""
    rows = x.shape[0]
    return FusedProjResidualLN.apply(
        x.float().contiguous(), attended.float().contiguous(), wo.float().contiguous(),
        bo.float().contiguous(), gamma.float().contiguous(), beta.float().contiguous(),
        _as_mask(res_mask, rows), _inv_keep(keep_prob), float(eps),
    )


def fused_mlp_residual_ln(
    x: torch.Tensor,  # [N, d_in]
    w1: torch.Tensor,  # [d_in, d_ff]
    b1: torch.Tensor,
    w2: torch.Tensor,  # [d_ff, d_in]
    b2: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,  # LayerNorm scale / bias [d_in]
    ffw_mask: Optional[torch.Tensor] = None,  # [N, d_ff] keep mask
    res_mask: Optional[torch.Tensor] = None,  # [N, d_in] keep mask
    keep_prob: float = 1.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``LayerNorm(x + dropout(ffw(x)))``, differentiable, with the
    signature of the reference's ``fused_mlp_residual_ln``. The ``[N, d_ff]``
    hidden never reaches device memory in the forward kernel."""
    rows = x.shape[0]
    return FusedMlpResidualLN.apply(
        x.float().contiguous(), w1.float().contiguous(), b1.float().contiguous(),
        w2.float().contiguous(), b2.float().contiguous(), gamma.float().contiguous(),
        beta.float().contiguous(), _as_mask(ffw_mask, rows), _as_mask(res_mask, rows),
        _inv_keep(keep_prob), float(eps),
    )

