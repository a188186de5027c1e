"""The CUDA entries' product schemes, emulated on the CPU in PyTorch alone
(no JAX), so that both the CPU tests and the card tests can hold a kernel to
them: TF32 splits, the residual-LN kernels' 32-deep chunked products and
split weight gradients, and the bf16 entries of both residual-LN pairs and
of the feed-forward pair with their rounding points. Every product of both
bf16 FFW pairs, forward and backward, runs on wgmma (``wgmma_ffw.cuh``):
exact bf16 products summed in f32, over k = d_model in one sum, over d_ff
and the rows in 64-deep chunks; the FFW residual-LN forward and its
backward take y = hd W2 from one body, so the backward normalises the
forward's y."""

import math

import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm

LOW_BITS = ~0x1FFF  # clears the 13 mantissa bits TF32 does not keep
CHUNK_K = 32  # the residual-LN kernels' products: depth of one fresh accumulator
WG_CHUNK_K = 64  # the bf16 wgmma products over d_ff and the rows: the same
WG_ROWS_D = 128  # rows of a bf16 wgmma [N, D] block (the LN backward's partial sums)
BF = torch.bfloat16


def _tf32_hi(x):
    return ((x.view(torch.int32) + 0x1000) & LOW_BITS).view(torch.float32)


def _tf32_cut(x):
    return (x.view(torch.int32) & LOW_BITS).view(torch.float32)


def _mm_chunked(a, b, mm, chunk=CHUNK_K):
    """a @ b as the residual-LN kernels' products take it: each ``chunk``-deep
    piece of k in a fresh accumulator, the pieces added in order in f32."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], chunk):
        out = out + mm(a[:, k0:k0 + chunk], b[k0:k0 + chunk])
    return out


def _mm_wg(a, b):
    """A bf16 wgmma product over d_ff (``WgProduct`` with fresh chunks):
    exact products, 64-deep chunks in fresh accumulators added in f32."""
    return _mm_chunked(a, b, lambda p, q: p @ q, WG_CHUNK_K)


def _in_order(parts):
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _block_sums(x, rows):
    """Sum over the rows of x as per-block partials added in order."""
    return _in_order([x[r0:r0 + rows].sum(0) for r0 in range(0, x.shape[0], rows)])


def _split_grad(a, b, tiles, mm, chunk=CHUNK_K, splits=None):
    """a^T b as the weight-gradient kernel takes it: per split of the rows
    (whole ``chunk``-row chunks, ``splits`` of them, by default
    ``_grad_splits``'), the splits added in order."""
    n = a.shape[0]
    splits = tm._grad_splits(n, tiles) if splits is None else splits
    per_split = math.ceil(math.ceil(n / splits) / chunk) * chunk
    return _in_order([_mm_chunked(a[r0:r0 + per_split].t(), b[r0:r0 + per_split], mm, chunk)
                      for r0 in range(0, n, per_split)])


def _mm_n(a, b, a_lo, b_lo):
    """``tf32_mma.cuh``'s ``mma_n``: mma3's terms in its order, without the lo
    terms of a side that has none (a bf16 operand, exact in TF32)."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    if a_lo:
        out = out + _tf32_cut(a - ah) @ bh
    if b_lo:
        out = out + ah @ _tf32_cut(b - bh)
    return out + ah @ bh


def _mm1(a, b):
    """Two bf16 operands: one TF32 product a k-step, exact, 32-deep chunks
    in fresh accumulators added in f32 (``tc_product.cuh``)."""
    return _mm_chunked(a, b, lambda x, y: _mm_n(x, y, False, False))


def _rnd(t):
    return t.to(BF).float()


def _proj_ln_bf16(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep, eps):
    """``proj_ln``'s bf16 entries: y in f32 from one TF32 product a k-step,
    the residual and LayerNorm in f32, out rounded; backward dy rounded before
    da = dy Wo^T and dWo (per split of the rows), dx = dr rounded, dbo,
    dgamma, dbeta f32 from 64-row blocks."""
    d = x.shape[1]
    rscale = rmask.float() * inv_keep
    r = x + (_mm1(a, wo) + bo) * rscale
    out, xhat, inv = tm.ln_rows(r, gamma, beta, eps)
    dr, _dg, _db = tm._ln_backward(dout, xhat, inv, gamma)
    dy = dr * rscale
    dyb = _rnd(dy)
    grads = (_rnd(dr), _rnd(_mm1(dyb, wo.t())),
             _rnd(_split_grad(a, dyb, tm._grad_tiles(d, d), lambda p, q: _mm_n(p, q, False, False))),
             *(_block_sums(t, tm.ROWS_D) for t in (dy, dout * xhat, dout)))
    return _rnd(out), grads


def _ffw_ln_bf16(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, dout, inv_keep, eps, skip=(),
                 ys=None):
    """``ffw_ln``'s bf16 entries, both directions on wgmma: the hidden (the
    whole k = D in one f32 sum), rounded to bf16; y = hd W2 over d_ff in
    64-deep chunks, one product for the forward (the residual and LayerNorm
    in f32, out rounded) and for the backward, which recomputes it; dx over
    d_ff as y, dpre over D in one sum, the weight gradients per split of
    whole 64-row chunks (``_wg_grad_splits`` of them): dy and dpre rounded
    before their products, dx, dW1, dW2 rounded, db1 (128-row blocks), db2,
    dgamma, dbeta (128-row blocks) f32. ``skip`` names rounding points
    ("hidden", "dy", "dpre") left out, with the products they feed taken on
    the unrounded values: what an entry that dropped them would compute.
    ``ys``, a list, receives the forward's y and the backward's."""
    d, f = w1.shape

    def rnd(t, point):
        return t if point in skip else _rnd(t)

    fscale, rscale = fmask.float() * inv_keep, rmask.float() * inv_keep
    hd = rnd(torch.relu(x @ w1 + b1) * fscale, "hidden")
    y_fwd, y_bwd = _mm_wg(hd, w2), _mm_wg(hd, w2)  # the forward's launch, the backward's
    if ys is not None:
        ys.extend((y_fwd, y_bwd))
    out, _xhat, _inv = tm.ln_rows(x + (y_fwd + b2) * rscale, gamma, beta, eps)
    _out, xhat, inv = tm.ln_rows(x + (y_bwd + b2) * rscale, gamma, beta, eps)
    dr, _dg, _db = tm._ln_backward(dout, xhat, inv, gamma)
    dy = dr * rscale
    dyb = rnd(dy, "dy")
    dpre = torch.where(hd > 0, (dyb @ w2.t()) * fscale, 0.0)
    dpb = rnd(dpre, "dpre")
    mm_wg = lambda p, q: p @ q  # noqa: E731
    splits = tm._wg_grad_splits(x.shape[0], f)
    grads = (_rnd(dr + _mm_wg(dpb, w1.t())),
             _rnd(_split_grad(x, dpb, None, mm_wg, WG_CHUNK_K, splits)),
             _block_sums(dpre, tm.ROWS_F),
             _rnd(_split_grad(hd, dyb, None, mm_wg, WG_CHUNK_K, splits)),
             *(_block_sums(t, WG_ROWS_D) for t in (dy, dout * xhat, dout)))
    return _rnd(out), grads


def _fused_mlp_bf16(x, w1, b1, w2, b2, mask, dout, inv_keep, skip=()):
    """``fused_mlp``'s bf16 entries, both directions on wgmma: the hidden
    (the whole k = D in one f32 sum), rounded to bf16 before W2's product
    (out = hd W2 + b2, ``ffw_ln``'s y over d_ff in 64-deep chunks, rounded)
    and before dW2's; the backward ``ffw_ln``'s bodies without the LN
    product (dpre
    = (hd > 0) (dout W2^T) mask / keep over D in one sum, rounded before
    dW1's and dx's products; dx over d_ff in 64-deep chunks; the weight
    gradients per split of whole 64-row chunks, ``_wg_grad_splits`` of
    them), db1 (128-row blocks) from the unrounded dpre; dx, dW1, dW2
    rounded. ``skip`` names rounding points ("hidden": the forward's, "hd":
    the backward's hidden before dW2, "dpre") left out, with the products
    they feed taken on the unrounded values: what an entry that dropped them
    would compute. Returns ``(out, (dx, dw1, db1, dw2))``."""
    f = w1.shape[1]
    mm_wg = lambda p, q: p @ q  # noqa: E731

    def rnd(t, point):
        return t if point in skip else _rnd(t)

    scale = mask.float() * inv_keep
    h = torch.relu(x @ w1 + b1) * scale
    out = _mm_wg(rnd(h, "hidden"), w2) + b2
    hd = rnd(h, "hd")
    dpre = torch.where(h > 0, (dout @ w2.t()) * scale, 0.0)
    dpb = rnd(dpre, "dpre")
    splits = tm._wg_grad_splits(x.shape[0], f)
    grads = (_rnd(_mm_wg(dpb, w1.t())),
             _rnd(_split_grad(x, dpb, None, mm_wg, WG_CHUNK_K, splits)),
             _block_sums(dpre, tm.ROWS_F),
             _rnd(_split_grad(hd, dout, None, mm_wg, WG_CHUNK_K, splits)))
    return _rnd(out), grads


def exact_fused_mlp_case(**kw):
    """``exact_ffw_ln_case``'s inputs as the feed-forward pair's bf16 entries
    take them -> ``(args, dout, inv_keep)``, ``args`` = (x, w1, b1, w2, b2,
    mask)."""
    args, dout, inv_keep = exact_ffw_ln_case(**kw)
    return (*args[:5], args[7]), dout, inv_keep


def exact_ffw_ln_case(n=256, d=256, f=2048, keep=0.8, seed=5):
    """Inputs of ``ffw_ln``'s bf16 entries on which rounding the hidden, dy
    and dpre each matter, while every sum before a rounding point is exact in
    f32 in any order: x and W1 small integers (x W1 + b1 an integer below
    2^15, times 1/keep = 1.25 still exact), so the hidden is the same bits
    whatever the order of the sums, and about three quarters of its live
    entries lose bits when rounded to bf16; W2 in {-1, 0, 1} * 2^-6, so
    hidden @ W2 is a multiple of 2^-8 far below 2^16. Returns ``(args,
    dout, inv_keep)`` on the CPU, ``args`` as the bf16 entries take them."""
    g = torch.Generator().manual_seed(seed)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=g).float()

    x, w1, b1 = ints(-8, 8, n, d), ints(-8, 8, d, f), ints(-4, 4, f)
    w2, b2 = ints(-1, 1, f, d) * 2**-6, ints(-4, 4, d)
    gamma = 1 + 0.1 * torch.randn(d, generator=g)
    beta = 0.1 * torch.randn(d, generator=g)
    fmask = (torch.rand(n, f, generator=g) < keep).to(torch.uint8)
    rmask = (torch.rand(n, d, generator=g) < keep).to(torch.uint8)
    dout = torch.randn(n, d, generator=g).to(BF)
    args = (x.to(BF), w1.to(BF), b1, w2.to(BF), b2, gamma, beta, fmask, rmask)
    return args, dout, tm._inv_keep(keep)


def ffw_ln_scheme_hidden(x, w1, b1, fmask, inv_keep):
    """The bf16 entries' hidden: relu(x W1 + b1) * fmask / keep rounded to
    bf16, the product exact bf16 products in one f32 sum (wgmma)."""
    return _rnd(torch.relu(x.float() @ w1.float() + b1) * fmask.float() * inv_keep).to(BF)


def bf16_ulps_apart(a, b):
    """Per entry, how many bf16 steps two bf16 tensors of one sign are apart."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
