"""Feed-forward and residual-LayerNorm kernels of the transformer layer, and
the dropout-mask generator: CUDA kernels, their plain twins and their
autograd Functions.

Counterpart of the JAX package's ``ops/pallas_mlp.py``:

- ``dropout_keep_mask``: a u8 Bernoulli(keep) mask from a counter-based
  generator (Philox4x32-10) seeded with two int32 words that live on the
  device (``kernel_rng_seed`` draws them from a ``torch.Generator``). An
  element is kept iff its uniform 32-bit word is below
  ``min(round(keep * 2^32), 2^32 - 1)``, compared unsigned. The stream is
  the port's own: it depends on (seed, purpose, element index) and equals
  neither the TPU generator's nor ``torch.rand``'s. ``dropout_keep_masks``
  writes up to three masks of one seed (a layer's) in one launch of the
  same kernel;
- ``fused_mlp`` / ``transformer_ffw``:
  ``dropout(relu(x @ w1 + b1)) @ w2 + b2``; its two directions launch the
  hidden kernel of ``fused_mlp_residual_ln`` (the same bits) and the
  product kernels of its backward;
- ``fused_proj_residual_ln``: ``LayerNorm(x + dropout(a @ wo + bo))``, the
  layer's first half after attention;
- ``fused_mlp_residual_ln``: ``LayerNorm(x + dropout(ffw(x)))``, the second
  half.

Weights use the reference's ``[in, out]`` layout. Dropout comes as u8 keep
masks made outside the compute kernels, scaled by ``1 / keep_prob`` inside;
``keep_prob <= 0`` scales by 0, so an all-drop mask gives exact zeros and no
NaN. The LayerNorm is flax's: float32 statistics, fast variance
``max(E[r^2] - E[r]^2, 0)``, eps 1e-6.

Each pass has a kernel wrapper (``dropout_keep_mask``, ``fused_mlp_fwd``,
``fused_mlp_bwd``, ``proj_ln_fwd``, ``proj_ln_bwd``, ``ffw_ln_fwd``,
``ffw_ln_bwd``): a CUDA tensor launches its kernel from ``csrc/`` or raises,
a CPU tensor takes the ``*_reference`` twin (the same arithmetic in plain
PyTorch; the mask twin is bit-identical to its kernel). Each wrapper counts
its launches in ``<wrapper>.launches``.

**bf16 (``mixed_precision``).** Both residual-LN pairs and the
feed-forward pair have bf16-operand entries (``proj_ln_fwd_bf16``,
``proj_ln_bwd_bf16``, ``ffw_ln_fwd_bf16``, ``ffw_ln_bwd_bf16``,
``fused_mlp_fwd_bf16``, ``fused_mlp_bwd_bf16``, with their ``*_reference``
twins): x, the attention output, the weights, the cotangent and the outputs
bf16, the biases and the LayerNorm's scale and offset f32. They round where the reference's kernels
round when ``x`` is bf16 (``pallas_mlp.py``'s compute type is ``x.dtype``):
every product takes two bf16 operands and sums in f32 (the hidden, ``dy``
and ``dpre`` are rounded to bf16 before the products they feed), the
residual and the LayerNorm run in f32, the outputs and the weights'
gradients are rounded to bf16, the biases' and the LayerNorm's gradients
stay f32. The entries are picked by ``x``'s type. On the card every product
of both FFW pairs' bf16 entries, forward and backward, runs on Hopper's
``wgmma`` (``csrc/wgmma_ffw.cuh``; the FFW residual-LN forward and its
backward take ``y = hd @ w2`` from one body, so the backward normalises the
forward's y), and the projection pair's at one TF32 ``mma.sync`` pass a
product (``csrc/tc_product.cuh``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

KERNEL_WIDTHS = (32, 64, 128, 256)  # d_model the kernels are instantiated for
FFW_CHUNK = 64  # d_ff must be a multiple of the hidden kernel's column tile
# the feed-forward and residual-LN kernels' tensor-core products (csrc/ffw.cu,
# csrc/ffw_ln.cu, the projection's backward in csrc/proj_ln.cu): rows per
# block of the [N, d_ff] and the [N, d] products, and the weight gradients'
# [in, out] tile
ROWS_F = 128
ROWS_D = 64
GRAD_TILE = (128, 64)
# the bf16 FFW backward's weight gradients on wgmma (csrc/wgmma_ffw.cuh): a
# block takes 128 of d_ff by the whole d_model, one block an SM
WG_GRAD_ROWS = 128
_SMS = 132  # H100 SXM streaming multiprocessors: sizes the row splits of the sums
# what a mask is for: mixed into the generator's key, so the three masks of a
# layer differ under one seed
RNG_P_HIDDEN = 1  # [N, d_ff] mask between ReLU and the second matmul
RNG_P_RES = 2  # [N, d] residual-dropout mask, FFW side
RNG_P_ATT = 3  # [N, d] residual-dropout mask, attention side
_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def kernel_width(d_model: int) -> Optional[int]:
    """The d_model ``fused_mlp`` computes ``d_model`` at: the least of
    ``KERNEL_WIDTHS`` not below it, or None above the largest."""
    return next((w for w in KERNEL_WIDTHS if w >= d_model), None) if d_model > 0 else None


def ffw_width(d_ff: int) -> int:
    """The d_ff the feed-forward kernels compute ``d_ff`` at: a multiple of
    ``FFW_CHUNK``."""
    return -(-d_ff // FFW_CHUNK) * FFW_CHUNK


def mlp_route(d_model: int) -> str:
    """The path of a layer's second half with ``fused_mlp`` on (the
    ``fused_mlp`` pair, or with ``fused_mlp_ln`` the two residual-LayerNorm
    halves): ``"kernel"`` up to the widest of ``KERNEL_WIDTHS``, else
    ``"plain"`` (a block of these kernels holds 64 whole rows of d_model
    columns, 2 d_model threads). The kernels run at ``kernel_width`` and
    ``ffw_width`` with zero columns past the true widths: a zero input column
    meets a zero row of a weight, a zero hidden unit a zero row of ``w2``, the
    residual is zero past d_model, the LayerNorm divides its row sums by the
    true d_model (``d_valid``), and the extra output columns are dropped, so
    the function is the same. A plain function of the widths, decided before
    any launch."""
    return "plain" if kernel_width(d_model) is None else "kernel"


def _pad_cols(t: Optional[torch.Tensor], width: int) -> Optional[torch.Tensor]:
    """The last dim of ``t`` padded with zeros up to ``width``."""
    if t is None or t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _pad_ffw(w1, b1, w2, mask, d_ff: int):
    """The feed-forward weights and keep mask at ``ffw_width(d_ff)`` hidden
    units: the extra units are zero columns of ``w1`` and ``b1`` and zero
    rows of ``w2``, so their hidden is relu(0) = 0 and adds nothing."""
    width = ffw_width(d_ff)
    if width == d_ff:
        return w1, b1, w2, mask
    return (_pad_cols(w1, width), _pad_cols(b1, width), _pad_cols(w2.t(), width).t(),
            _pad_cols(mask, width))


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


def _ln_valid(r, gamma, beta, eps: float, d_valid: Optional[int]):
    """``ln_rows`` over the first ``d_valid`` columns (all with None), as
    the kernels take a padded row: ``(out, xhat, inv)``, out zero past them
    (the caller pads gamma and beta with zeros)."""
    width = r.shape[-1]
    if d_valid is None or d_valid == width:
        return ln_rows(r, gamma, beta, eps)
    out, xhat, inv = ln_rows(r[:, :d_valid], gamma[:d_valid], beta[:d_valid], eps)
    return _pad_cols(out, width), xhat, inv


def _ln_backward_valid(dout, xhat, inv, gamma, d_valid: Optional[int]):
    """``_ln_backward`` over the first ``d_valid`` columns: dr, dgamma and
    dbeta zero past them."""
    width = dout.shape[-1]
    if d_valid is None or d_valid == width:
        return _ln_backward(dout, xhat, inv, gamma)
    grads = _ln_backward(dout[:, :d_valid], xhat, inv, gamma[:d_valid])
    return tuple(_pad_cols(g, width) for g in grads)


# ------------------------------------------------------------ plain twins


def proj_ln_fwd_reference(x, a, wo, bo, gamma, beta, rmask, inv_keep: float, eps: float,
                          d_valid: Optional[int] = None):
    """Plain version of the projection kernel's forward -> ``out [N, D]``,
    the LayerNorm over the first ``d_valid`` columns (all with None)."""
    y = a @ wo + bo
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    return _ln_valid(x + y, gamma, beta, eps, d_valid)[0]


def proj_ln_bwd_reference(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep: float, eps: float,
                          d_valid: Optional[int] = None, cast=None):
    """Plain version of the projection kernel's backward ->
    ``(dx, da, dwo, dbo, dgamma, dbeta)``. ``cast`` rounds ``dy`` where it
    enters a product (the bf16 twin's; none in f32)."""
    y = a @ wo + bo
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    _out, xhat, inv = _ln_valid(x + y, gamma, beta, eps, d_valid)
    dr, dgamma, dbeta = _ln_backward_valid(dout, xhat, inv, gamma, d_valid)
    dy = dr * rscale if rscale is not None else dr
    dyc = dy if cast is None else cast(dy)
    return dr, dyc @ wo.t(), a.t() @ dyc, dy.sum(0), dgamma, dbeta


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in f32: the reference's
    ``astype(bfloat16)`` before a product whose sum runs in f32."""
    return t.to(torch.bfloat16).float()


def _bf16(*tensors):
    return tuple(t.to(torch.bfloat16) for t in tensors)


def proj_ln_fwd_bf16_reference(x, a, wo, bo, gamma, beta, rmask, inv_keep: float, eps: float,
                               d_valid: Optional[int] = None):
    """Plain version of the projection kernel's bf16 entry -> ``out [N, D]``
    in bf16: the f32 arithmetic on the bf16 values of x, a and wo."""
    return proj_ln_fwd_reference(x.float(), a.float(), wo.float(), bo, gamma, beta, rmask,
                                 inv_keep, eps, d_valid).to(torch.bfloat16)


def proj_ln_bwd_bf16_reference(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep: float,
                               eps: float, d_valid: Optional[int] = None):
    """Plain version of the projection kernel's bf16 backward ->
    ``(dx, da, dwo, dbo, dgamma, dbeta)``: dy rounded to bf16 before both of
    its products, dx, da and dwo in bf16, the rest f32."""
    dx, da, dwo, dbo, dgamma, dbeta = proj_ln_bwd_reference(
        x.float(), a.float(), wo.float(), bo, gamma, beta, rmask, dout.float(), inv_keep, eps,
        d_valid, cast=_bf16_values)
    return (*_bf16(dx, da, dwo), dbo, dgamma, dbeta)


def ffw_ln_fwd_reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float,
                         eps: float, d_valid: Optional[int] = None):
    """Plain version of the FFW kernel's forward -> ``out [N, D]``, the
    LayerNorm over the first ``d_valid`` columns (all with None)."""
    h = torch.relu(x @ w1 + b1)
    fscale = _scale(fmask, inv_keep)
    if fscale is not None:
        h = h * fscale
    y = h @ w2 + b2
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    return _ln_valid(x + y, gamma, beta, eps, d_valid)[0]


def ffw_ln_bwd_reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout,
                         inv_keep: float, eps: float, d_valid: Optional[int] = None):
    """Plain version of the FFW kernel's backward ->
    ``(dx, dw1, db1, dw2, db2, dgamma, dbeta)``."""
    pre = x @ w1 + b1
    return _ffw_ln_bwd_plain(x, w1, pre, pre > 0.0, w2, b2, gamma, fmask, rmask, dout,
                             inv_keep, eps, d_valid)


def _ffw_ln_bwd_plain(x, w1, pre, live, w2, b2, gamma, fmask, rmask, dout, inv_keep: float,
                      eps: float, d_valid: Optional[int] = None, cast=None):
    """The plain FFW backward at the pre-activations ``pre`` [N, d_ff], taking
    the ReLU branch ``live`` (bool [N, d_ff]; ``pre > 0`` for the plain
    forward's own). A backward follows the branches of the forward it
    differentiates, which another forward's arithmetic can round otherwise
    where ``pre`` lies within rounding of zero. ``cast`` rounds the hidden,
    ``dy`` and ``dpre`` where they enter a product (the bf16 twin's; none
    in f32)."""
    cast = cast or (lambda t: t)
    fscale = _scale(fmask, inv_keep)
    hd = torch.where(live, pre, 0.0)
    if fscale is not None:
        hd = hd * fscale
    hdc = cast(hd)
    y = hdc @ w2 + b2
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    _out, xhat, inv = _ln_valid(x + y, gamma, torch.zeros_like(gamma), eps, d_valid)
    dr, dgamma, dbeta = _ln_backward_valid(dout, xhat, inv, gamma, d_valid)
    dy = dr * rscale if rscale is not None else dr
    dyc = cast(dy)
    dhd = dyc @ w2.t()
    if fscale is not None:
        dhd = dhd * fscale
    dpre = torch.where(live, dhd, 0.0)
    dprec = cast(dpre)
    dx = dr + dprec @ w1.t()
    return dx, x.t() @ dprec, dpre.sum(0), hdc.t() @ dyc, dy.sum(0), dgamma, dbeta


def ffw_ln_fwd_bf16_reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float,
                              eps: float, d_valid: Optional[int] = None):
    """Plain version of the FFW kernel's bf16 entry -> ``out [N, D]`` in
    bf16: the pre-activation from the bf16 values of x and w1 in f32, the
    hidden rounded to bf16 before its product with w2, the residual and the
    LayerNorm in f32."""
    xf = x.float()
    h = torch.relu(xf @ w1.float() + b1)
    fscale = _scale(fmask, inv_keep)
    if fscale is not None:
        h = h * fscale
    y = _bf16_values(h) @ w2.float() + b2
    rscale = _scale(rmask, inv_keep)
    if rscale is not None:
        y = y * rscale
    return _ln_valid(xf + y, gamma, beta, eps, d_valid)[0].to(torch.bfloat16)


def ffw_ln_bwd_bf16_reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout,
                              inv_keep: float, eps: float, d_valid: Optional[int] = None):
    """Plain version of the FFW kernel's bf16 backward ->
    ``(dx, dw1, db1, dw2, db2, dgamma, dbeta)``: dx, dw1 and dw2 in bf16,
    the rest f32."""
    xf, w1f = x.float(), w1.float()
    pre = xf @ w1f + b1
    return _ffw_ln_bwd_bf16_plain(xf, w1f, pre, pre > 0.0, w2.float(), b2, gamma, fmask, rmask,
                                  dout.float(), inv_keep, eps, d_valid)


def _ffw_ln_bwd_bf16_plain(x, w1, pre, live, w2, b2, gamma, fmask, rmask, dout,
                           inv_keep: float, eps: float, d_valid: Optional[int] = None):
    """``_ffw_ln_bwd_plain`` with the bf16 entry's roundings, on f32 tensors
    of bf16 values, its results in the entry's types."""
    dx, dw1, db1, dw2, db2, dgamma, dbeta = _ffw_ln_bwd_plain(
        x, w1, pre, live, w2, b2, gamma, fmask, rmask, dout, inv_keep, eps, d_valid,
        cast=_bf16_values)
    return (*_bf16(dx, dw1), db1, dw2.to(torch.bfloat16), db2, dgamma, dbeta)


def _keep_thr(keep_prob: float) -> int:
    """uint32 threshold: keep an element iff its random word < thr."""
    return min(int(round(float(keep_prob) * 2.0**32)), 2**32 - 1)


def kernel_rng_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Two int32 seed words on ``device``, drawn from ``generator`` (what the
    reference folds out of a layer's ``dropout`` key). One draw; the host
    never reads the words."""
    return torch.randint(
        -(2**31), 2**31, (2,), generator=generator, device=device, dtype=torch.int64
    ).to(torch.int32)


def _mulhilo32(a: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of ``a * b`` for a constant ``a < 2^32`` and
    an int64 tensor ``b`` of 32-bit values. The product does not fit int64,
    so ``b`` is split into 16-bit halves whose partial products do."""
    p0, p1 = a * (b & 0xFFFF), a * (b >> 16)
    mid = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (mid >> 32), mid & _M32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) in int64 tensor arithmetic:
    ``counter`` is four int64 tensors of 32-bit words, ``key`` two (tensors
    or ints); returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _M32, (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def dropout_keep_mask_reference(rng_seed: torch.Tensor, rows: int, cols: int, keep_prob: float,
                                purpose: int = RNG_P_HIDDEN) -> torch.Tensor:
    """Plain version of the mask generator -> ``[rows, cols]`` uint8, the
    kernel's bits exactly: element ``e`` takes word ``e % 4`` of the Philox
    call with counter ``(e // 4, 0, 0)`` (64-bit index in two words) and key
    ``(seed[0] ^ purpose * 0x9E3779B9, seed[1])``."""
    total = rows * cols
    if keep_prob >= 1.0:
        return torch.ones((rows, cols), dtype=torch.uint8, device=rng_seed.device)
    seed = rng_seed.to(torch.int64) & _M32
    key = (seed[0] ^ ((purpose * _PHILOX_W0) & _M32), seed[1])
    group = torch.arange((total + 3) // 4, dtype=torch.int64, device=rng_seed.device)
    zero = torch.zeros_like(group)
    words = torch.stack(philox4x32_10((group & _M32, group >> 32, zero, zero), key), dim=-1)
    keep = words.reshape(-1)[:total] < _keep_thr(keep_prob)
    return keep.to(torch.uint8).reshape(rows, cols)


def fused_mlp_fwd_reference(x, w1, b1, w2, b2, mask, inv_keep: float):
    """Plain version of the feed-forward kernel's forward -> ``out [N, D]``."""
    h = torch.relu(x @ w1 + b1)
    scale = _scale(mask, inv_keep)
    if scale is not None:
        h = h * scale
    return h @ w2 + b2


def fused_mlp_bwd_reference(x, w1, b1, w2, mask, dout, inv_keep: float):
    """Plain version of the feed-forward kernel's backward ->
    ``(dx, dw1, db1, dw2)``; ``db2`` is a column sum of ``dout`` taken by
    the caller."""
    pre = x @ w1 + b1
    return _fused_mlp_bwd_plain(x, w1, pre, pre > 0.0, w2, mask, dout, inv_keep)


def _fused_mlp_bwd_plain(x, w1, pre, live, w2, mask, dout, inv_keep: float, cast=None):
    """The plain feed-forward backward at the pre-activations ``pre``
    [N, d_ff], taking the ReLU branch ``live`` (``pre > 0`` for the plain
    forward's own; see ``_ffw_ln_bwd_plain``). ``cast`` rounds the hidden
    and ``dpre`` where they enter a product (the bf16 twin's; none in
    f32)."""
    cast = cast or (lambda t: t)
    scale = _scale(mask, inv_keep)
    hd = torch.where(live, pre, 0.0)
    if scale is not None:
        hd = hd * scale
    dhd = dout @ w2.t()
    if scale is not None:
        dhd = dhd * scale
    dpre = torch.where(live, dhd, 0.0)
    dprec = cast(dpre)
    return dprec @ w1.t(), x.t() @ dprec, dpre.sum(0), cast(hd).t() @ dout


def fused_mlp_fwd_bf16_reference(x, w1, b1, w2, b2, mask, inv_keep: float):
    """Plain version of the feed-forward kernel's bf16 entry -> ``out [N, D]``
    in bf16: the pre-activation from the bf16 values of x and w1 in f32, the
    hidden rounded to bf16 before its product with w2, b2 added in f32, the
    sum rounded."""
    h = torch.relu(x.float() @ w1.float() + b1)
    scale = _scale(mask, inv_keep)
    if scale is not None:
        h = h * scale
    return (_bf16_values(h) @ w2.float() + b2).to(torch.bfloat16)


def fused_mlp_bwd_bf16_reference(x, w1, b1, w2, mask, dout, inv_keep: float):
    """Plain version of the feed-forward kernel's bf16 backward ->
    ``(dx, dw1, db1, dw2)``: the hidden rounded to bf16 before dW2's
    product, dpre before dW1's and dx's, db1 from the unrounded dpre; dx,
    dw1 and dw2 in bf16, db1 f32."""
    xf, w1f = x.float(), w1.float()
    pre = xf @ w1f + b1
    return _fused_mlp_bwd_bf16_plain(xf, w1f, pre, pre > 0.0, w2.float(), mask, dout.float(),
                                     inv_keep)


def _fused_mlp_bwd_bf16_plain(x, w1, pre, live, w2, mask, dout, inv_keep: float):
    """``_fused_mlp_bwd_plain`` with the bf16 entry's roundings, on f32
    tensors of bf16 values, its results in the entry's types."""
    dx, dw1, db1, dw2 = _fused_mlp_bwd_plain(x, w1, pre, live, w2, mask, dout, inv_keep,
                                             cast=_bf16_values)
    return (*_bf16(dx, dw1), db1, dw2.to(torch.bfloat16))


# ------------------------------------------------------------ kernel wrappers


def _check(tensors: dict, shapes: dict, device: torch.device) -> None:
    for name, shape in shapes.items():
        t = tensors.get(name)
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")


def _d_valid(d_valid: Optional[int], width: int) -> int:
    """The LayerNorm's columns: ``width`` with None, else ``d_valid`` in
    ``[1, width]``."""
    if d_valid is None:
        return width
    if not 0 < d_valid <= width:
        raise ValueError(f"d_valid must be in [1, {width}], got {d_valid}")
    return d_valid


def _check_kernel_inputs(tensors: dict, width: int, bf16=()) -> None:
    """Raise unless every tensor has the type its entry takes: u8 masks,
    bfloat16 for the names in ``bf16``, float32 for the rest."""
    for name, t in tensors.items():
        if t is None:
            continue
        want = (torch.uint8 if name.endswith("mask")
                else torch.bfloat16 if name in bf16 else torch.float32)
        if t.dtype != want:
            raise TypeError(f"kernel takes {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if width not in KERNEL_WIDTHS:
        raise ValueError(f"kernel supports d_model in {KERNEL_WIDTHS}, got {width}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _grad_splits(rows: int, tiles: int) -> int:
    """Row splits of the backward's weight gradients: at most the blocks that
    fill the SMs twice over (two blocks fit on one), at least 256 rows each."""
    return max(1, min(2 * _SMS // max(tiles, 1), math.ceil(rows / 256)))


def _grad_tiles(i: int, o: int) -> int:
    """Blocks of one split of an ``[i, o]`` weight gradient on the tensor cores."""
    return math.ceil(i / GRAD_TILE[0]) * math.ceil(o / GRAD_TILE[1])


def _wg_grad_splits(rows: int, f: int) -> int:
    """Row splits of the bf16 FFW backwards' weight gradients (``ffw_ln``'s
    and ``fused_mlp``'s bf16 entries, on wgmma): at most the blocks that fill
    the SMs once (one fits on an SM), at least 256 rows each."""
    return max(1, min(_SMS // math.ceil(f / WG_GRAD_ROWS), math.ceil(rows / 256)))


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


MAX_MASKS = 3  # masks one launch writes (csrc/dropout_mask.cu kMaxMasks): a layer's three


def _check_seed(rng_seed: torch.Tensor) -> None:
    if rng_seed.dtype != torch.int32 or tuple(rng_seed.shape) != (2,):
        raise TypeError(f"rng_seed must be a [2] int32 tensor, got {rng_seed.dtype} "
                        f"{tuple(rng_seed.shape)}")
    if rng_seed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rng_seed.device}")


def _launch_masks(rng_seed: torch.Tensor, masks, keep_prob: float, purposes) -> None:
    """One launch of the mask kernel writing every non-empty ``[rows, cols]``
    uint8 tensor of ``masks``, each with its purpose; counted in
    ``dropout_keep_mask.launches``."""
    args = []
    for mask, purpose in zip(masks, purposes):
        if mask.numel() > 0:
            args += [mask.data_ptr(), mask.numel(), int(purpose)]
    if not args:
        return
    lib = _build.library("dropout_mask")
    fn = lib.msfa_dropout_masks
    if fn.argtypes is None:  # set once: a layer's draw launches it every micro-step
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint] * MAX_MASKS + [
            ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    count = len(args) // 3
    device = rng_seed.device
    with torch.cuda.device(device):
        code = fn(rng_seed.contiguous().data_ptr(), count, *args,
                  *[None, 0, 0] * (MAX_MASKS - count), _keep_thr(keep_prob),
                  int(keep_prob >= 1.0), _stream(device))
    _build.check(lib, code, "dropout_keep_mask")
    dropout_keep_mask.launches += 1


def dropout_keep_mask(rng_seed: torch.Tensor, rows: int, cols: int, keep_prob: float,
                      purpose: int = RNG_P_HIDDEN) -> torch.Tensor:
    """``[rows, cols]`` uint8 Bernoulli(``keep_prob``) keep mask, deterministic
    per (seed, purpose, shape); ``rng_seed`` is the ``[2]`` int32 tensor of
    ``kernel_rng_seed``, on the device the mask is made on. ``keep_prob >= 1``
    gives all ones, ``<= 0`` all zeros."""
    _check_seed(rng_seed)
    if rng_seed.device.type == "cpu":
        return dropout_keep_mask_reference(rng_seed, rows, cols, keep_prob, purpose)
    out = torch.empty((rows, cols), dtype=torch.uint8, device=rng_seed.device)
    _launch_masks(rng_seed, [out], keep_prob, [purpose])
    return out


dropout_keep_mask.launches = 0


def dropout_keep_masks_reference(rng_seed: torch.Tensor, rows: int, specs, keep_prob: float):
    """Plain version of ``dropout_keep_masks``: one
    ``dropout_keep_mask_reference`` call per ``(cols, purpose)``."""
    return [dropout_keep_mask_reference(rng_seed, rows, cols, keep_prob, purpose)
            for cols, purpose in specs]


def dropout_keep_masks(rng_seed: torch.Tensor, rows: int, specs, keep_prob: float):
    """Up to ``MAX_MASKS`` keep masks of one seed in one launch: ``specs`` is
    a sequence of ``(cols, purpose)``, the result the list of ``[rows, cols]``
    uint8 masks, each byte for byte ``dropout_keep_mask(rng_seed, rows, cols,
    keep_prob, purpose)``. A transformer layer draws its three masks so.
    The launch is row 9's kernel and counts in ``dropout_keep_mask.launches``."""
    _check_seed(rng_seed)
    specs = [(int(cols), int(purpose)) for cols, purpose in specs]
    if not 0 < len(specs) <= MAX_MASKS:
        raise ValueError(f"between 1 and {MAX_MASKS} masks in one launch, got {len(specs)}")
    if rng_seed.device.type == "cpu":
        return dropout_keep_masks_reference(rng_seed, rows, specs, keep_prob)
    outs = [torch.empty((rows, cols), dtype=torch.uint8, device=rng_seed.device)
            for cols, _ in specs]
    _launch_masks(rng_seed, outs, keep_prob, [purpose for _, purpose in specs])
    return outs


def _mlp_shapes(x, d, f):
    n = x.shape[0]
    return {"x": (n, d), "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,), "mask": (n, f)}


_MLP_BF16 = ("x", "w1", "w2", "dout")


def _fused_mlp_fwd(wrapper, bf16: bool, x, w1, b1, w2, b2, mask, inv_keep: float):
    """The body of both feed-forward forward entries."""
    d, f = x.shape[-1], w1.shape[-1]
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "mask": mask}
    _check(tensors, _mlp_shapes(x, d, f), x.device)
    if x.device.type == "cpu":
        reference = fused_mlp_fwd_bf16_reference if bf16 else fused_mlp_fwd_reference
        return reference(x, w1, b1, w2, b2, mask, inv_keep)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d, _MLP_BF16 if bf16 else ())
    _check_ffw_width(f)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    return _fused_mlp_fwd_launch(x, w1, b1, w2, b2, mask, inv_keep)[0]


def fused_mlp_fwd(x, w1, b1, w2, b2, mask, inv_keep: float):
    """Kernel wrapper for the feed-forward block's forward -> ``out [N, D]``
    (the kernel takes ``d_out == d_in``)."""
    return _fused_mlp_fwd(fused_mlp_fwd, False, x, w1, b1, w2, b2, mask, inv_keep)


fused_mlp_fwd.launches = 0


def fused_mlp_fwd_bf16(x, w1, b1, w2, b2, mask, inv_keep: float):
    """Kernel wrapper for the feed-forward block's bf16 entry -> ``out [N, D]``
    in bfloat16 from bfloat16 x, w1 and w2 (f32 biases)."""
    return _fused_mlp_fwd(fused_mlp_fwd_bf16, True, x, w1, b1, w2, b2, mask, inv_keep)


fused_mlp_fwd_bf16.launches = 0


def _fused_mlp_fwd_launch(x, w1, b1, w2, b2, mask, inv_keep: float):
    """The feed-forward forward entry of ``x``'s type (f32, or bf16:
    ``fused_mlp_fwd_bf16``) on checked CUDA inputs with N > 0 -> ``(out,
    hd)``: the hidden ``relu(x @ w1 + b1) * mask / keep``, in ``x``'s type,
    lives in an ``[N, d_ff]`` scratch buffer allocated here between the two
    launches."""
    (n, d), f = x.shape, w1.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty_like(x)
    hd = torch.empty((n, f), device=x.device, dtype=x.dtype)
    lib, fn = _fn("ffw", f"msfa_ffw_fwd{_sfx(bf16)}", 8, 3, 1)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  _ptr(mask), out.data_ptr(), hd.data_ptr(), n, d, f, float(inv_keep),
                  _stream(x.device))
    wrapper = fused_mlp_fwd_bf16 if bf16 else fused_mlp_fwd
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    return out, hd


def _fused_mlp_bwd(wrapper, bf16: bool, x, w1, b1, w2, mask, dout, inv_keep: float):
    """The body of both feed-forward backward entries."""
    d, f = x.shape[-1], w1.shape[-1]
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "mask": mask, "dout": dout}
    _check(tensors, {**_mlp_shapes(x, d, f), "dout": x.shape}, x.device)
    if x.device.type == "cpu":
        reference = fused_mlp_bwd_bf16_reference if bf16 else fused_mlp_bwd_reference
        return reference(x, w1, b1, w2, mask, dout, inv_keep)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d, _MLP_BF16 if bf16 else ())
    _check_ffw_width(f)
    if x.shape[0] == 0:
        return (torch.empty_like(x), torch.zeros_like(w1), torch.zeros((f,), device=x.device),
                torch.zeros_like(w2))
    return _fused_mlp_bwd_launch(x, w1, b1, w2, mask, dout, inv_keep)[0]


def fused_mlp_bwd(x, w1, b1, w2, mask, dout, inv_keep: float):
    """Kernel wrapper for the feed-forward block's backward ->
    ``(dx, dw1, db1, dw2)``."""
    return _fused_mlp_bwd(fused_mlp_bwd, False, x, w1, b1, w2, mask, dout, inv_keep)


fused_mlp_bwd.launches = 0


def fused_mlp_bwd_bf16(x, w1, b1, w2, mask, dout, inv_keep: float):
    """Kernel wrapper for the feed-forward block's bf16 backward ->
    ``(dx, dw1, db1, dw2)``, dx, dw1 and dw2 bfloat16, from bfloat16 x, w1,
    w2 and cotangent ``dout``."""
    return _fused_mlp_bwd(fused_mlp_bwd_bf16, True, x, w1, b1, w2, mask, dout, inv_keep)


fused_mlp_bwd_bf16.launches = 0


def _fused_mlp_bwd_launch(x, w1, b1, w2, mask, dout, inv_keep: float):
    """The feed-forward backward entry of ``x``'s type on checked CUDA inputs
    with N > 0 -> ``(grads, hd)``. The kernels keep the recomputed hidden
    ``hd`` (the forward's kernel, the same bits) and its gradient in two
    ``[N, d_ff]`` scratch buffers allocated here, with the per-block
    partials of db1 and the per-split partials of the weight gradients, as
    ``ffw_ln_bwd`` does; with bf16 the two scratch buffers, dx, dw1 and dw2
    bf16."""
    (n, d), f = x.shape, w1.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    act = dict(device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty((d, f), **act), torch.empty((f, d), **act)
    db1 = torch.empty((f,), device=x.device)
    splits = _wg_grad_splits(n, f) if bf16 else _grad_splits(n, _grad_tiles(f, d))
    hd, dpre = torch.empty((n, f), **act), torch.empty((n, f), **act)
    db1_part = torch.empty((math.ceil(n / ROWS_F), f), device=x.device)
    dw_part = torch.empty((splits, d * f), device=x.device)
    lib, fn = _fn("ffw", f"msfa_ffw_bwd{_sfx(bf16)}", 14, 4, 1)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), _ptr(mask),
                  dout.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
                  dw2.data_ptr(), hd.data_ptr(), dpre.data_ptr(), db1_part.data_ptr(),
                  dw_part.data_ptr(), n, d, f, splits, float(inv_keep), _stream(x.device))
    wrapper = fused_mlp_bwd_bf16 if bf16 else fused_mlp_bwd
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    return (dx, dw1, db1, dw2), hd


def _proj_shapes(x, d):
    n = x.shape[0]
    return {"x": (n, d), "a": (n, d), "wo": (d, d), "bo": (d,), "gamma": (d,),
            "beta": (d,), "rmask": (n, d)}


# the bf16 entries' bf16 operands (the rest are f32)
_PROJ_BF16 = ("x", "a", "wo", "dout")
_FFW_BF16 = ("x", "w1", "w2", "dout")


def _sfx(bf16: bool) -> str:
    return "_bf16" if bf16 else ""


def _proj_ln_fwd(wrapper, bf16: bool, x, a, wo, bo, gamma, beta, rmask, inv_keep: float,
                 eps: float, d_valid: Optional[int]):
    """The body of both projection forward entries, counted on ``wrapper``."""
    d = x.shape[-1]
    tensors = {"x": x, "a": a, "wo": wo, "bo": bo, "gamma": gamma, "beta": beta,
               "rmask": rmask}
    _check(tensors, _proj_shapes(x, d), x.device)
    d_valid = _d_valid(d_valid, d)
    if x.device.type == "cpu":
        reference = proj_ln_fwd_bf16_reference if bf16 else proj_ln_fwd_reference
        return reference(x, a, wo, bo, gamma, beta, rmask, inv_keep, eps, d_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d, _PROJ_BF16 if bf16 else ())
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib, fn = _fn("proj_ln", f"msfa_proj_ln_fwd{_sfx(bf16)}", 8, 3, 2)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), a.data_ptr(), wo.data_ptr(), bo.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), _ptr(rmask), out.data_ptr(), n, d, d_valid,
                  float(inv_keep), float(eps), _stream(x.device))
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    return out


def proj_ln_fwd(x, a, wo, bo, gamma, beta, rmask, inv_keep: float, eps: float,
                d_valid: Optional[int] = None):
    """Kernel wrapper for the projection half's forward -> ``out [N, D]``;
    the LayerNorm over the first ``d_valid`` columns (all with None; the
    inputs zero past them)."""
    return _proj_ln_fwd(proj_ln_fwd, False, x, a, wo, bo, gamma, beta, rmask, inv_keep, eps,
                        d_valid)


proj_ln_fwd.launches = 0


def proj_ln_fwd_bf16(x, a, wo, bo, gamma, beta, rmask, inv_keep: float, eps: float,
                     d_valid: Optional[int] = None):
    """Kernel wrapper for the projection half's bf16 entry -> ``out [N, D]``
    in bfloat16 from bfloat16 x, a and wo (f32 bo, gamma, beta)."""
    return _proj_ln_fwd(proj_ln_fwd_bf16, True, x, a, wo, bo, gamma, beta, rmask, inv_keep, eps,
                        d_valid)


proj_ln_fwd_bf16.launches = 0


def _proj_ln_bwd(wrapper, bf16: bool, x, a, wo, bo, gamma, beta, rmask, dout, inv_keep: float,
                 eps: float, d_valid: Optional[int]):
    """The body of both projection backward entries, counted on
    ``wrapper``: dx, da and dwo in the activations' type (dy too, rounded
    as both of its products take it), the sums f32."""
    d = x.shape[-1]
    tensors = {"x": x, "a": a, "wo": wo, "bo": bo, "gamma": gamma, "beta": beta,
               "rmask": rmask, "dout": dout}
    _check(tensors, {**_proj_shapes(x, d), "dout": x.shape}, x.device)
    d_valid = _d_valid(d_valid, d)
    if x.device.type == "cpu":
        reference = proj_ln_bwd_bf16_reference if bf16 else proj_ln_bwd_reference
        return reference(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep, eps, d_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d, _PROJ_BF16 if bf16 else ())
    n = x.shape[0]
    dx, da = torch.empty_like(x), torch.empty_like(x)
    dwo = torch.empty((d, d), device=x.device, dtype=x.dtype)
    sums = torch.empty((3, d), device=x.device)
    if n == 0:
        dgamma, dbeta, dbo = sums.zero_().unbind(0)
        return dx, da, dwo.zero_(), dbo, dgamma, dbeta
    splits = _grad_splits(n, _grad_tiles(d, d))
    dy = torch.empty_like(x)
    ln_part = torch.empty((math.ceil(n / ROWS_D), 3, d), device=x.device)
    dw_part = torch.empty((splits, d * d), device=x.device)
    lib, fn = _fn("proj_ln", f"msfa_proj_ln_bwd{_sfx(bf16)}", 14, 4, 2)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), a.data_ptr(), wo.data_ptr(), bo.data_ptr(), gamma.data_ptr(),
                  _ptr(rmask), dout.data_ptr(), dx.data_ptr(), da.data_ptr(), dwo.data_ptr(),
                  sums.data_ptr(), dy.data_ptr(), ln_part.data_ptr(), dw_part.data_ptr(), n, d,
                  d_valid, splits, float(inv_keep), float(eps), _stream(x.device))
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    dgamma, dbeta, dbo = sums.unbind(0)
    return dx, da, dwo, dbo, dgamma, dbeta


def proj_ln_bwd(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep: float, eps: float,
                d_valid: Optional[int] = None):
    """Kernel wrapper for the projection half's backward ->
    ``(dx, da, dwo, dbo, dgamma, dbeta)``."""
    return _proj_ln_bwd(proj_ln_bwd, False, x, a, wo, bo, gamma, beta, rmask, dout, inv_keep,
                        eps, d_valid)


proj_ln_bwd.launches = 0


def proj_ln_bwd_bf16(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep: float, eps: float,
                     d_valid: Optional[int] = None):
    """Kernel wrapper for the projection half's bf16 backward ->
    ``(dx, da, dwo, dbo, dgamma, dbeta)``, the first three bfloat16, from
    bfloat16 x, a, wo and cotangent ``dout``."""
    return _proj_ln_bwd(proj_ln_bwd_bf16, True, x, a, wo, bo, gamma, beta, rmask, dout,
                        inv_keep, eps, d_valid)


proj_ln_bwd_bf16.launches = 0


def _ffw_shapes(x, d, f):
    n = x.shape[0]
    return {"x": (n, d), "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,),
            "gamma": (d,), "beta": (d,), "fmask": (n, f), "rmask": (n, d)}


def _check_ffw_width(f: int) -> None:
    if f % FFW_CHUNK:
        raise ValueError(f"kernel takes d_ff a multiple of {FFW_CHUNK}, got {f}")


def _ffw_ln_fwd(wrapper, bf16: bool, x, w1, b1, w2, b2, gamma, beta, fmask, rmask,
                inv_keep: float, eps: float, d_valid: Optional[int]):
    """The body of both FFW forward entries."""
    d, f = x.shape[-1], w1.shape[-1]
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "gamma": gamma,
               "beta": beta, "fmask": fmask, "rmask": rmask}
    _check(tensors, _ffw_shapes(x, d, f), x.device)
    d_valid = _d_valid(d_valid, d)
    if x.device.type == "cpu":
        reference = ffw_ln_fwd_bf16_reference if bf16 else ffw_ln_fwd_reference
        return reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep, eps, d_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d, _FFW_BF16 if bf16 else ())
    _check_ffw_width(f)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    return _ffw_ln_fwd_launch(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep, eps,
                              d_valid)[0]


def ffw_ln_fwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float, eps: float,
               d_valid: Optional[int] = None):
    """Kernel wrapper for the FFW half's forward -> ``out [N, D]``; the
    LayerNorm over the first ``d_valid`` columns (all with None; the inputs
    zero past them)."""
    return _ffw_ln_fwd(ffw_ln_fwd, False, x, w1, b1, w2, b2, gamma, beta, fmask, rmask,
                       inv_keep, eps, d_valid)


ffw_ln_fwd.launches = 0


def ffw_ln_fwd_bf16(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float, eps: float,
                    d_valid: Optional[int] = None):
    """Kernel wrapper for the FFW half's bf16 entry -> ``out [N, D]`` in
    bfloat16 from bfloat16 x, w1 and w2 (f32 biases, gamma, beta)."""
    return _ffw_ln_fwd(ffw_ln_fwd_bf16, True, x, w1, b1, w2, b2, gamma, beta, fmask, rmask,
                       inv_keep, eps, d_valid)


ffw_ln_fwd_bf16.launches = 0


def _ffw_ln_fwd_launch(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float,
                       eps: float, d_valid: Optional[int] = None):
    """The FFW forward entry of ``x``'s type (f32, or bf16: ``ffw_ln_fwd_bf16``)
    on checked CUDA inputs with N > 0 -> ``(out, hd)``: the hidden
    ``relu(x @ w1 + b1) * fmask / keep``, in ``x``'s type, lives in an
    ``[N, d_ff]`` scratch buffer allocated here (134 MB at N = 16384, d_ff =
    2048, in f32) between the two launches."""
    (n, d), f = x.shape, w1.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty_like(x)
    hd = torch.empty((n, f), device=x.device, dtype=x.dtype)
    lib, fn = _fn("ffw_ln", f"msfa_ffw_ln_fwd{_sfx(bf16)}", 11, 4, 2)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), _ptr(fmask), _ptr(rmask), out.data_ptr(),
                  hd.data_ptr(), n, d, _d_valid(d_valid, d), f, float(inv_keep), float(eps),
                  _stream(x.device))
    wrapper = ffw_ln_fwd_bf16 if bf16 else ffw_ln_fwd
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    return out, hd


def _ffw_ln_bwd(wrapper, bf16: bool, x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout,
                inv_keep: float, eps: float, d_valid: Optional[int]):
    """The body of both FFW backward entries."""
    d, f = x.shape[-1], w1.shape[-1]
    tensors = {"x": x, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "gamma": gamma,
               "beta": beta, "fmask": fmask, "rmask": rmask, "dout": dout}
    _check(tensors, {**_ffw_shapes(x, d, f), "dout": x.shape}, x.device)
    d_valid = _d_valid(d_valid, d)
    if x.device.type == "cpu":
        reference = ffw_ln_bwd_bf16_reference if bf16 else ffw_ln_bwd_reference
        return reference(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout, inv_keep, eps,
                         d_valid)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(tensors, d, _FFW_BF16 if bf16 else ())
    _check_ffw_width(f)
    if x.shape[0] == 0:
        dgamma, dbeta, db2 = torch.zeros((3, d), device=x.device).unbind(0)
        return (torch.empty_like(x), torch.zeros_like(w1), torch.zeros((f,), device=x.device),
                torch.zeros_like(w2), db2, dgamma, dbeta)
    return _ffw_ln_bwd_launch(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout, inv_keep,
                              eps, d_valid)[0]


def ffw_ln_bwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout, inv_keep: float,
               eps: float, d_valid: Optional[int] = None):
    """Kernel wrapper for the FFW half's backward ->
    ``(dx, dw1, db1, dw2, db2, dgamma, dbeta)``."""
    return _ffw_ln_bwd(ffw_ln_bwd, False, x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout,
                       inv_keep, eps, d_valid)


ffw_ln_bwd.launches = 0


def ffw_ln_bwd_bf16(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout, inv_keep: float,
                    eps: float, d_valid: Optional[int] = None):
    """Kernel wrapper for the FFW half's bf16 backward ->
    ``(dx, dw1, db1, dw2, db2, dgamma, dbeta)``, dx, dw1 and dw2 bfloat16,
    from bfloat16 x, w1, w2 and cotangent ``dout``."""
    return _ffw_ln_bwd(ffw_ln_bwd_bf16, True, x, w1, b1, w2, b2, gamma, beta, fmask, rmask,
                       dout, inv_keep, eps, d_valid)


ffw_ln_bwd_bf16.launches = 0


def _ffw_ln_bwd_launch(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout, inv_keep: float,
                       eps: float, d_valid: Optional[int] = None):
    """The FFW backward entry of ``x``'s type on checked CUDA inputs with N >
    0 -> ``(grads, hd)``. The kernels keep the recomputed hidden ``hd`` (the
    forward's kernel, the same bits) and its gradient in two ``[N, d_ff]``
    scratch buffers allocated here (134 MB each at N = 16384, d_ff = 2048, in
    f32), with dy and the per-block and per-split partials of the sums over
    rows; with bf16 those three in bf16 (each rounded as the products take
    it), dw1, dw2 and dx bf16, and dr waits for dx's product in f32 scratch
    (in f32 it waits in dx)."""
    (n, d), f = x.shape, w1.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    act = dict(device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty((d, f), **act), torch.empty((f, d), **act)
    db1 = torch.empty((f,), device=x.device)
    sums = torch.empty((3, d), device=x.device)
    splits = _wg_grad_splits(n, f) if bf16 else _grad_splits(n, _grad_tiles(f, d))
    hd, dpre = torch.empty((n, f), **act), torch.empty((n, f), **act)
    dy = torch.empty_like(x)
    dr = (torch.empty((n, d), device=x.device),) if bf16 else ()
    ln_part = torch.empty((math.ceil(n / ROWS_D), 3, d), device=x.device)
    db1_part = torch.empty((math.ceil(n / ROWS_F), f), device=x.device)
    dw_part = torch.empty((splits, d * f), device=x.device)
    lib, fn = _fn("ffw_ln", f"msfa_ffw_ln_bwd{_sfx(bf16)}", 20 + len(dr), 5, 2)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  gamma.data_ptr(), _ptr(fmask), _ptr(rmask), dout.data_ptr(), dx.data_ptr(),
                  dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), sums.data_ptr(),
                  hd.data_ptr(), dpre.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in dr),
                  ln_part.data_ptr(), db1_part.data_ptr(), dw_part.data_ptr(), n, d,
                  _d_valid(d_valid, d), f, splits, float(inv_keep), float(eps),
                  _stream(x.device))
    wrapper = ffw_ln_bwd_bf16 if bf16 else ffw_ln_bwd
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    dgamma, dbeta, db2 = sums.unbind(0)
    return (dx, dw1, db1, dw2, db2, dgamma, dbeta), hd


# ------------------------------------------------------------ autograd


class FusedProjResidualLN(torch.autograd.Function):
    """``LayerNorm(x + dropout(a @ wo + bo))`` with the kernel pair as forward
    and backward (the JAX package's custom VJP ``_proj_ln_core``): the f32
    entries for an f32 ``x``, the bf16 entries for a bfloat16 one (x, a and
    wo bf16, the output and dx, da, dwo too)."""

    @staticmethod
    def forward(ctx, x, a, wo, bo, gamma, beta, rmask, inv_keep: float, eps: float,
                d_valid: int):
        fwd = proj_ln_fwd_bf16 if x.dtype == torch.bfloat16 else proj_ln_fwd
        out = fwd(x, a, wo, bo, gamma, beta, rmask, inv_keep, eps, d_valid)
        ctx.save_for_backward(x, a, wo, bo, gamma, beta, rmask)
        ctx.inv_keep, ctx.eps, ctx.d_valid = inv_keep, eps, d_valid
        return out

    @staticmethod
    def backward(ctx, dout):
        x, a, wo, bo, gamma, beta, rmask = ctx.saved_tensors
        bwd = proj_ln_bwd_bf16 if x.dtype == torch.bfloat16 else proj_ln_bwd
        grads = bwd(x, a, wo, bo, gamma, beta, rmask, dout.to(x.dtype).contiguous(),
                    ctx.inv_keep, ctx.eps, ctx.d_valid)
        return (*grads, None, None, None, None)


class FusedMlpResidualLN(torch.autograd.Function):
    """``LayerNorm(x + dropout(ffw(x)))`` with the kernel pair as forward and
    backward (the JAX package's custom VJP ``_ffw_ln_core``): the f32
    entries for an f32 ``x``, the bf16 entries for a bfloat16 one (x, w1 and
    w2 bf16, the output and dx, dw1, dw2 too)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep: float,
                eps: float, d_valid: int):
        fwd = ffw_ln_fwd_bf16 if x.dtype == torch.bfloat16 else ffw_ln_fwd
        out = fwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep, eps, d_valid)
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta, fmask, rmask)
        ctx.inv_keep, ctx.eps, ctx.d_valid = inv_keep, eps, d_valid
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, b1, w2, b2, gamma, beta, fmask, rmask = ctx.saved_tensors
        bwd = ffw_ln_bwd_bf16 if x.dtype == torch.bfloat16 else ffw_ln_bwd
        grads = bwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask,
                    dout.to(x.dtype).contiguous(), ctx.inv_keep, ctx.eps, ctx.d_valid)
        return (*grads, None, None, None, None, None)


class FusedMlp(torch.autograd.Function):
    """``dropout(relu(x @ w1 + b1)) @ w2 + b2`` with the kernel pair as
    forward and backward (the JAX package's custom VJP ``_mlp_core``): the
    f32 entries for an f32 ``x``, the bf16 entries for a bfloat16 one (x, w1
    and w2 bf16, the output and dx, dw1, dw2 too; db1 and db2 f32)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mask, inv_keep: float):
        fwd = fused_mlp_fwd_bf16 if x.dtype == torch.bfloat16 else fused_mlp_fwd
        out = fwd(x, w1, b1, w2, b2, mask, inv_keep)
        ctx.save_for_backward(x, w1, b1, w2, mask)
        ctx.inv_keep = inv_keep
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, b1, w2, mask = ctx.saved_tensors
        bwd = fused_mlp_bwd_bf16 if x.dtype == torch.bfloat16 else fused_mlp_bwd
        dout = dout.to(x.dtype).contiguous()
        dx, dw1, db1, dw2 = bwd(x, w1, b1, w2, mask, dout, ctx.inv_keep)
        return dx, dw1, db1, dw2, dout.float().sum(0), None, None


def _as_mask(mask: Optional[torch.Tensor], rows: int) -> Optional[torch.Tensor]:
    """A keep mask as the kernels take it: ``[rows, width]`` uint8,
    contiguous. A u8 mask (the generator kernel's) passes through as it is
    and a bool mask is reinterpreted, neither is copied."""
    if mask is None:
        return None
    mask = mask.reshape(rows, -1).contiguous()
    return mask.view(torch.uint8) if mask.dtype == torch.bool else mask.to(torch.uint8)


def fused_mlp(
    x: torch.Tensor,  # [N, d_in]
    w1: torch.Tensor,  # [d_in, d_ff]
    b1: torch.Tensor,  # [d_ff]
    w2: torch.Tensor,  # [d_ff, d_in]
    b2: torch.Tensor,  # [d_in]
    keep_mask: Optional[torch.Tensor] = None,  # [N, d_ff] uint8/bool, 1 = keep
    keep_prob: float = 1.0,
) -> torch.Tensor:
    """Fused ``relu(x @ w1 + b1) -> dropout -> @ w2 + b2``, differentiable,
    with the signature of the reference's ``fused_mlp``. ``keep_mask`` (when
    given) is applied between the ReLU and the second matmul as
    ``h * mask / keep_prob``. Widths the kernels are not built for are padded
    with zeros up to ``kernel_width`` and ``ffw_width`` (``mlp_route``: the
    same function); a d_in above ``KERNEL_WIDTHS``' largest raises on the
    card. A bfloat16 ``x`` runs the bf16 entries, x, w1 and w2 in bf16 (the
    output bf16, the biases f32); otherwise all f32."""
    d_in = x.shape[-1]
    width = kernel_width(d_in) or d_in  # d_in padded: zero rows of w1, zero columns of w2
    dt = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    w1, b1, w2, mask = _pad_ffw(w1.to(dt), b1.float(), w2.to(dt),
                                _as_mask(keep_mask, x.shape[0]), w1.shape[-1])
    out = FusedMlp.apply(
        _pad_cols(x.to(dt), width).contiguous(), _pad_cols(w1.t(), width).t().contiguous(),
        b1.contiguous(), _pad_cols(w2, width).contiguous(),
        _pad_cols(b2.float(), width).contiguous(), mask, _inv_keep(keep_prob),
    )
    return out[:, :d_in] if width != d_in else out


def transformer_ffw(
    x: torch.Tensor,  # [B, T, d_in]
    params1,  # {"kernel": [d_in, d_ff], "bias": [d_ff]}
    params2,  # {"kernel": [d_ff, d_out], "bias": [d_out]}
    keep_mask: Optional[torch.Tensor] = None,  # [B, T, d_ff], 1 = keep
    keep_prob: float = 1.0,
    use_fused: bool = False,
) -> torch.Tensor:
    """Transformer feed-forward block on the kernel or the plain path (the
    reference's ``transformer_ffw``). Both consume the same mask, made
    outside, so the training draws do not depend on the path."""
    batch, seq_len, d_in = x.shape
    w1, b1 = params1["kernel"], params1["bias"]
    w2, b2 = params2["kernel"], params2["bias"]
    if use_fused:
        out = fused_mlp(x.reshape(batch * seq_len, d_in), w1, b1, w2, b2,
                        None if keep_mask is None else keep_mask.reshape(batch * seq_len, -1),
                        keep_prob)
        return out.reshape(batch, seq_len, w2.shape[1]).to(x.dtype)
    h = torch.relu(x @ w1 + b1)
    if keep_mask is not None:
        h = torch.where(keep_mask.bool(), h / keep_prob, 0.0)
    return h @ w2 + b2


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
    the signature of the reference's ``fused_proj_residual_ln``. A d the
    kernels are not built for runs at ``kernel_width`` with zero columns past
    it (``mlp_route``: the same function); one above ``KERNEL_WIDTHS``'
    largest raises on the card. A bfloat16 ``x`` runs the bf16 entries, x,
    ``attended`` and ``wo`` in bf16 (the output bf16); otherwise all f32."""
    rows, d = x.shape
    width = kernel_width(d) or d
    dt = x.dtype if x.dtype == torch.bfloat16 else torch.float32

    def cols(t, dtype=torch.float32):  # zero columns up to the kernels' width
        return _pad_cols(t.to(dtype), width).contiguous()

    out = FusedProjResidualLN.apply(
        cols(x, dt), cols(attended, dt), cols(cols(wo, dt).t(), dt).t().contiguous(), cols(bo),
        cols(gamma), cols(beta), _pad_cols(_as_mask(res_mask, rows), width),
        _inv_keep(keep_prob), float(eps), d,
    )
    return out[:, :d] if width != d else out


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
    signature of the reference's ``fused_mlp_residual_ln``. The forward
    keeps the ``[N, d_ff]`` hidden in a scratch buffer between its two
    launches; the backward recomputes it. Widths the kernels are not built
    for run at ``kernel_width`` and ``ffw_width`` with zero columns past them
    (``mlp_route``: the same function); a d_in above ``KERNEL_WIDTHS``'
    largest raises on the card. A bfloat16 ``x`` runs the bf16 entries, x,
    w1 and w2 in bf16 (the output bf16); otherwise all f32."""
    rows, d_in = x.shape
    width = kernel_width(d_in) or d_in
    dt = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    w1, b1, w2, ffw_mask = _pad_ffw(w1.to(dt), b1.float(), w2.to(dt),
                                    _as_mask(ffw_mask, rows), w1.shape[-1])

    def cols(t, dtype=torch.float32):  # zero columns up to the kernels' width
        return _pad_cols(t.to(dtype), width).contiguous()

    out = FusedMlpResidualLN.apply(
        cols(x, dt), cols(w1.t(), dt).t().contiguous(), b1.contiguous(), cols(w2, dt), cols(b2),
        cols(gamma), cols(beta), ffw_mask, _pad_cols(_as_mask(res_mask, rows), width),
        _inv_keep(keep_prob), float(eps), d_in,
    )
    return out[:, :d_in] if width != d_in else out

