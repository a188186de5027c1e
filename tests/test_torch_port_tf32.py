"""The precision scheme of the port's tensor-core kernels, emulated on the CPU.

``flash_fwd_single``, ``flash_fwd_tiled``, ``packed_attention_fwd``,
``packed_attention_bwd``, ``flash_bwd_fused`` and ``ffw_ln_bwd`` take each f32
product as three TF32 tensor-core products
(``ops/csrc/tf32_mma.cuh``): x = hi + lo, with
hi = x rounded to TF32 (half a TF32 ulp added to the bits, the low 13 bits
cleared) and lo = x - hi, of which the tensor core reads the top 19 bits; then
a*b = lo*hi' + hi*lo' + hi*hi' with f32 accumulation. TF32 values multiply
exactly in f32, so bit masks on int32 views and f32 products emulate the
scheme. The kernels' arithmetic, emulated so, stays within the limits
``chip_smoke.py`` holds the kernels to on the card against the plain versions:
1e-4 max abs for the forward, 1e-4 of the largest magnitude for the backward.
One TF32 product per f32 product is printed beside it; it misses them. The
fused backward's emulation is also held against the JAX package's fused
backward route (``flash_self_attention``'s VJP in interpret mode), and the
FFW residual-LN backward's against ``fused_mlp_residual_ln``'s VJP there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_attention as pa
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_mlp as jmlp
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm

ATTN_TOL = 1e-4  # forward: max abs error
GRAD_TOL = 1e-4  # backward: max abs error over the largest magnitude
LOW_BITS = ~0x1FFF  # clears the 13 mantissa bits TF32 does not keep
TILE = 64  # the kernels' key tile
CHUNK_K = 32  # the FFW backward's products: depth of one fresh accumulator
# f32 on both sides, products and sums in another order: the tolerance of the
# port's FFW residual-LN tests against the JAX package
JAX_TOL = dict(rtol=2e-5, atol=2e-5)


def _tf32_hi(x):
    return ((x.view(torch.int32) + 0x1000) & LOW_BITS).view(torch.float32)


def _tf32_cut(x):
    return (x.view(torch.int32) & LOW_BITS).view(torch.float32)


def _mm3(a, b):
    """a @ b as three TF32 products (the small terms first), f32 sums."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    """a @ b as one TF32 product: what the 3x scheme is for."""
    return _tf32_hi(a) @ _tf32_hi(b)


def _flash_fwd(q, k, v, lengths, heads, scale, mm, pv_keys=TILE):
    """``flash_fwd_single``'s arithmetic: q scaled first, an online softmax
    over 64-key tiles with one rescale each, tiles at or past a row's length
    skipped, both products through ``mm``; P.V taken ``pv_keys`` keys at a
    time, each step's product added to O in f32."""
    rows, seq, _ = q.shape
    qs = q * scale
    lens = lengths.long().repeat_interleave(heads)[:, None, None]
    m = torch.full((rows, seq, 1), -torch.inf)
    l = torch.zeros(rows, seq, 1)
    o = torch.zeros_like(q)
    for k0 in range(0, seq, TILE):
        keys = slice(k0, min(k0 + TILE, seq))
        active = k0 < lens
        s = mm(qs, k[:, keys].transpose(1, 2))
        s = torch.where(torch.arange(k0, keys.stop)[None, None, :] < lens, s, -torch.inf)
        m_new = torch.where(active, torch.maximum(m, s.amax(-1, keepdim=True)), m)
        rescale = torch.where(active, torch.exp(m - m_new), 1.0)
        p = torch.where(active, torch.exp(s - m_new), 0.0)
        l = l * rescale + p.sum(-1, keepdim=True)
        o = o * rescale
        for c0 in range(0, p.shape[-1], pv_keys):
            o = o + mm(p[..., c0:c0 + pv_keys], v[:, keys][:, c0:c0 + pv_keys])
        m = m_new
    out = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), ta.NEG_INF)
    return out, lse[..., 0]


def _packed_fwd(qkv, lengths, heads, scale, mm):
    """``packed_attention_fwd``'s arithmetic: ``flash_fwd_single``'s on the
    packed layout's heads, P.V in fresh accumulators of two 8-key steps each
    (16 keys) added to O in f32 -> ``(out [B, T, F], lse [B, T, H])``."""
    batch, seq, three_f = qkv.shape
    d = three_f // 3 // heads
    x = qkv.reshape(batch, seq, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2).reshape(batch * heads, seq, d) for i in range(3))
    out, lse = _flash_fwd(q, k, v, lengths, heads, scale, mm, pv_keys=16)
    out = out.reshape(batch, heads, seq, d).transpose(1, 2).reshape(batch, seq, heads * d)
    return out, lse.reshape(batch, heads, seq).transpose(1, 2)


def _flash_bwd_fused(q, k, v, lengths, heads, lse, delta, dout, scale, mm):
    """``flash_bwd_fused``'s arithmetic on ``[B*H, T, d]``: S^T = k q^T and
    dP^T = v dout^T, p^T and ds^T from them; dv = p^T dout and dk = ds^T q
    summed over 64-row query tiles, each tile's product taken alone (the
    kernel's fresh accumulator) and added in f32; dq from the per-64-key-tile
    partials ds k summed in key-tile order; sm_scale on dk and dq last; all
    products through ``mm``."""
    seq = q.shape[1]
    lens = lengths.long().repeat_interleave(heads)
    key_ok = (torch.arange(seq)[None, :] < lens[:, None])[:, :, None]  # [BH, Tk, 1]
    lse_q = lse[:, None, :]  # [BH, 1, Tq]
    keep = key_ok & (lse_q > ta.NEG_INF / 2)
    pt = torch.where(keep, torch.exp(mm(k, q.transpose(1, 2)) * scale - lse_q), 0.0)
    dst = pt * (mm(v, dout.transpose(1, 2)) - delta[:, None, :])
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for t0 in range(0, seq, TILE):
        tile = slice(t0, t0 + TILE)
        dv = dv + mm(pt[:, :, tile], dout[:, tile])  # query tile t0's products
        dk = dk + mm(dst[:, :, tile], q[:, tile])
        dq = dq + mm(dst[:, tile].transpose(1, 2), k[:, tile])  # key tile t0's partial
    return dq * scale, dk * scale, dv


def _packed_bwd(qkv, lengths, out, lse, dout, heads, scale, mm):
    """``packed_attention_bwd``'s five products: S^T = k q^T and dP^T = v dout^T
    per key, p^T and ds^T from them, dv = p^T dout, dk = ds^T q * scale,
    dq = ds k * scale, all through ``mm``."""
    batch, seq, three_f = qkv.shape
    d = three_f // 3 // heads
    x = qkv.reshape(batch, seq, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, T, d]
    do = dout.reshape(batch, seq, heads, d).transpose(1, 2)
    o = out.reshape(batch, seq, heads, d).transpose(1, 2)
    lse_q = lse.transpose(1, 2)[:, :, None, :]  # [B, H, 1, Tq]
    delta = (do * o).sum(-1)[:, :, None, :]
    key_ok = (torch.arange(seq)[None, :] < lengths.long()[:, None])[:, None, :, None]
    keep = key_ok & (lse_q > ta.NEG_INF / 2)
    st = mm(k, q.transpose(-1, -2)) * scale
    pt = torch.where(keep, torch.exp(st - lse_q.clamp(min=ta.NEG_INF / 2)), 0.0)
    dst = pt * (mm(v, do.transpose(-1, -2)) - delta)
    dv = mm(pt, do)
    dk = mm(dst, q) * scale
    dq = mm(dst.transpose(-1, -2), k) * scale
    return torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(batch, seq, three_f)


def test_tf32_split_is_exact_and_rounds_to_nearest():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    x = torch.cat([x, x * 1e-6, x * 1e6])
    hi = _tf32_hi(x)
    lo = x - hi
    assert torch.equal(hi + lo, x)  # the split loses nothing
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    # hi is x to the nearest TF32 value: within half a TF32 ulp (2^-11 relative)
    assert torch.all(lo.abs() <= x.abs() * 2.0**-11)
    # the tensor core's cut of lo keeps the pair within 2^-21 of x
    assert torch.all((x - hi - _tf32_cut(lo)).abs() <= x.abs() * 2.0**-21)


def test_flash_forward_3xtf32_holds_the_f32_limit():
    rng = np.random.default_rng(1)
    heads, seq, d = 1, 1024, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((2, seq, d)).astype(np.float32))
               for _ in range(3))
    lengths = torch.tensor([1024, 613], dtype=torch.int32)
    scale = d**-0.5
    want_out, want_lse = ta.flash_attention_reference(q, k, v, lengths, heads, scale)
    errs = {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        out, lse = _flash_fwd(q, k, v, lengths, heads, scale, mm)
        errs[name] = max((out - want_out).abs().max().item(),
                         (lse - want_lse).abs().max().item())
    print(f"flash forward, BH=2 T=1024 d=64, max abs err against the f32 plain version: "
          f"3xTF32 {errs['3xTF32']:.3e}, 1xTF32 {errs['1xTF32']:.3e} (limit {ATTN_TOL})")
    assert errs["3xTF32"] < ATTN_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


def test_packed_backward_3xtf32_holds_the_f32_limit():
    rng = np.random.default_rng(2)
    batch, seq, heads, d = 2, 512, 4, 64
    qkv = torch.from_numpy(rng.standard_normal((batch, seq, 3 * heads * d)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((batch, seq, heads * d)).astype(np.float32))
    lengths = torch.tensor([512, 300], dtype=torch.int32)
    scale = d**-0.5
    out, lse = ta.packed_attention_reference(qkv, lengths, heads, scale)
    want = ta.packed_attention_bwd_reference(qkv, lengths, out, lse, dout, heads, scale)
    errs = {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        got = _packed_bwd(qkv, lengths, out, lse, dout, heads, scale, mm)
        errs[name] = ((got - want).abs().max() / want.abs().max()).item()
    print(f"packed backward, B=2 T=512 H=4 d=64, max abs err over the largest magnitude: "
          f"3xTF32 {errs['3xTF32']:.3e}, 1xTF32 {errs['1xTF32']:.3e} (limit {GRAD_TOL})")
    assert errs["3xTF32"] < GRAD_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


def test_packed_forward_3xtf32_holds_the_f32_limit():
    rng = np.random.default_rng(3)
    batch, seq, heads, d = 2, 512, 4, 64
    qkv = torch.from_numpy(rng.standard_normal((batch, seq, 3 * heads * d)).astype(np.float32))
    lengths = torch.tensor([512, 300], dtype=torch.int32)
    scale = d**-0.5
    want_out, want_lse = ta.packed_attention_reference(qkv, lengths, heads, scale)
    errs = {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        out, lse = _packed_fwd(qkv, lengths, heads, scale, mm)
        errs[name] = max((out - want_out).abs().max().item(),
                         (lse - want_lse).abs().max().item())
    print(f"packed forward, B=2 T=512 H=4 d=64, max abs err against the f32 plain version: "
          f"3xTF32 {errs['3xTF32']:.3e}, 1xTF32 {errs['1xTF32']:.3e} (limit {ATTN_TOL})")
    assert errs["3xTF32"] < ATTN_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


def _flash_case(rng, rows, seq, d):
    return [torch.from_numpy(rng.standard_normal((rows, seq, d)).astype(np.float32))
            for _ in range(4)]


def test_flash_fused_backward_3xtf32_holds_the_f32_limit():
    rng = np.random.default_rng(4)
    heads, seq, d = 1, 1024, 64
    q, k, v, dout = _flash_case(rng, 2, seq, d)
    lengths = torch.tensor([1024, 613], dtype=torch.int32)
    scale = d**-0.5
    out, lse = ta.flash_attention_reference(q, k, v, lengths, heads, scale)
    delta = (dout * out).sum(-1)
    want = ta.flash_bwd_fused_reference(q, k, v, lengths, heads, lse, delta, dout, scale)
    errs = {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        got = _flash_bwd_fused(q, k, v, lengths, heads, lse, delta, dout, scale, mm)
        errs[name] = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
    print(f"flash fused backward, BH=2 T=1024 d=64, max abs err over the largest magnitude: "
          f"3xTF32 {errs['3xTF32']:.3e}, 1xTF32 {errs['1xTF32']:.3e} (limit {GRAD_TOL})")
    assert errs["3xTF32"] < GRAD_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


def test_flash_fused_backward_3xtf32_matches_the_jax_fused_route(monkeypatch):
    # the reference's fused backward kernel, pinned through its environment knobs
    monkeypatch.setenv("MSFA_FLASH_SINGLE_K_MAX", "4096")
    monkeypatch.setenv("MSFA_FLASH_FUSED_BWD_MAX", "4096")
    rng = np.random.default_rng(5)
    batch, heads, seq, d = 2, 1, 256, 64
    q, k, v, dout = (a.numpy().reshape(batch, heads, seq, d) for a in _flash_case(rng, 2, seq, d))
    lens = np.array([256, 150], np.int32)
    _out, vjp = jax.vjp(
        lambda a, b, c: pa.flash_self_attention(a, b, c, jnp.asarray(lens), interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    flat = [torch.from_numpy(a.reshape(batch * heads, seq, d)) for a in (q, k, v, dout)]
    lengths = torch.from_numpy(lens)
    scale = d**-0.5
    out, lse = _flash_fwd(*flat[:3], lengths, heads, scale, _mm3, pv_keys=16)
    delta = (flat[3] * out).sum(-1)
    got = _flash_bwd_fused(*flat[:3], lengths, heads, lse, delta, flat[3], scale, _mm3)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w).reshape(batch * heads, seq, d)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        print(f"d{name}: emulated flash_bwd_fused vs the JAX fused route, rel err {err:.3e}")
        assert err < GRAD_TOL, f"d{name}"


def test_tiled_forward_route_takes_the_single_route_body():
    # both flash forwards run one body (attention_fwd.cuh): past a small
    # single_k_max the router takes the tiled kernel, and one emulation holds
    # both routes' plain versions to the forward limit
    rng = np.random.default_rng(6)
    heads, seq, d, single_k_max = 2, 200, 32, 64
    routes = {k: ta.flash_routes(seq, block_q=64, block_k=64, single_k_max=k)[0]
              for k in (single_k_max, 4096)}
    assert routes == {single_k_max: "tiled", 4096: "single"}
    q, k, v = (torch.from_numpy(rng.standard_normal((3 * heads, seq, d)).astype(np.float32))
               for _ in range(3))
    lengths = torch.tensor([200, 0, 77], dtype=torch.int32)
    scale = d**-0.5
    emulated = _flash_fwd(q, k, v, lengths, heads, scale, _mm3, pv_keys=16)
    for route, (out, lse) in (
            ("tiled", ta.flash_fwd_tiled(q, k, v, lengths, heads, scale, block_k=64)),
            ("single", ta.flash_fwd_single(q, k, v, lengths, heads, scale))):
        err = max((out - emulated[0]).abs().max().item(),
                  (lse - emulated[1]).abs().max().item())
        print(f"{route} route's plain version vs the 3xTF32 body, T={seq}: max abs err {err:.3e}")
        assert err < ATTN_TOL, route


def _mm_chunked(a, b, mm):
    """a @ b as the backward's products take it: each 32-deep chunk of k in a
    fresh accumulator, the chunks added in order in f32."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], CHUNK_K):
        out = out + mm(a[:, k0:k0 + CHUNK_K], b[k0:k0 + CHUNK_K])
    return out


def _in_order(parts):
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _block_sums(x, rows):
    """Sum over the rows of x as per-block partials added in order."""
    return _in_order([x[r0:r0 + rows].sum(0) for r0 in range(0, x.shape[0], rows)])


def _forward_chain(x, w):
    """Rows of x dotted with rows of w as the forward kernel sums them: one
    f32 FMA chain over k in order (each step exact in f64, then rounded)."""
    s = torch.zeros(x.shape[0])
    for k in range(x.shape[1]):
        s = (s.double() + x[:, k].double() * w[:, k].double()).float()
    return s


def _hidden_pre(x, w1, b1, mm, settle=True):
    """The backward's pre = x W1 + b1: the product through ``mm``; with
    ``settle``, units within the band (D + 64) 2^-23 |x_n| |W1[:, f]| of zero
    taken again by the forward kernel's chain, as the hidden kernel does."""
    pre = _mm_chunked(x, w1, mm) + b1
    if settle:
        band = (x.shape[1] + 64) * 2.0**-23 * x.norm(dim=1)[:, None] * w1.norm(dim=0)[None, :]
        rows, cols = (pre.abs() < band).nonzero(as_tuple=True)
        pre[rows, cols] = _forward_chain(x[rows], w1[:, cols].t()) + b1[cols]
    return pre


def _ffw_ln_bwd(x, w1, b1, w2, b2, gamma, fmask, rmask, dout, inv_keep, eps, mm):
    """``ffw_ln_bwd``'s arithmetic: the six products through ``mm`` in
    32-deep fresh accumulators, pre's sign settled by the forward's chain
    near zero; dW1 and dW2 per split of the rows (whole 32-row chunks), the
    splits added in order; db1 from 128-row blocks, db2, dgamma, dbeta from
    64-row blocks, the partials added in order."""
    n, d = x.shape
    f = w1.shape[1]
    fscale = 1.0 if fmask is None else fmask.float() * inv_keep
    rscale = 1.0 if rmask is None else rmask.float() * inv_keep
    hd = torch.relu(_hidden_pre(x, w1, b1, mm)) * fscale
    y = (_mm_chunked(hd, w2, mm) + b2) * rscale
    _out, xhat, inv = tm.ln_rows(x + y, gamma, torch.zeros_like(gamma), eps)
    dr, _dgamma, _dbeta = tm._ln_backward(dout, xhat, inv, gamma)
    dy = dr * rscale
    dpre = torch.where(hd > 0, _mm_chunked(dy, w2.t(), mm) * fscale, 0.0)
    dx = dr + _mm_chunked(dpre, w1.t(), mm)
    tiles = math.ceil(f / tm.BWD_GRAD_TILE[0]) * math.ceil(d / tm.BWD_GRAD_TILE[1])
    splits = tm._grad_splits(n, tiles)
    per_split = math.ceil(math.ceil(n / splits) / CHUNK_K) * CHUNK_K
    cuts = [slice(r0, r0 + per_split) for r0 in range(0, n, per_split)]
    dw1 = _in_order([_mm_chunked(x[c].t(), dpre[c], mm) for c in cuts])
    dw2 = _in_order([_mm_chunked(hd[c].t(), dy[c], mm) for c in cuts])
    db1 = _block_sums(dpre, tm.BWD_ROWS_F)
    db2, dgamma, dbeta = (_block_sums(t, tm.BWD_ROWS_D) for t in (dy, dout * xhat, dout))
    return dx, dw1, db1, dw2, db2, dgamma, dbeta


def _ffw_case(rng, n, d, f, keep):
    f32 = np.float32
    arrays = [rng.standard_normal((n, d)).astype(f32),
              (rng.standard_normal((d, f)) * d**-0.5).astype(f32),
              (0.1 * rng.standard_normal(f)).astype(f32),
              (rng.standard_normal((f, d)) * f**-0.5).astype(f32),
              (0.1 * rng.standard_normal(d)).astype(f32),
              (1 + 0.1 * rng.standard_normal(d)).astype(f32),
              (0.1 * rng.standard_normal(d)).astype(f32)]
    masks = [None, None] if keep is None else [
        (rng.random((n, width)) < keep).astype(np.uint8) for width in (f, d)]
    dout = rng.standard_normal((n, d)).astype(f32)
    return arrays, masks, dout


FFW_NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta")


@pytest.mark.parametrize("n,keep", [(100, 0.8), (300, None)], ids=["N100-keep0.8", "N300-nomask"])
def test_ffw_ln_backward_3xtf32_holds_the_f32_limit(n, keep):
    d, f = 32, 128
    arrays, masks, dout = _ffw_case(np.random.default_rng(7 + n), n, d, f, keep)
    t = [torch.from_numpy(a) for a in arrays]
    tmask = [None if m is None else torch.from_numpy(m) for m in masks]
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    want = tm.ffw_ln_bwd_reference(*t, *tmask, torch.from_numpy(dout), inv_keep, 1e-6)
    args = (*t[:6], *tmask, torch.from_numpy(dout), inv_keep, 1e-6)
    errs = {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        got = _ffw_ln_bwd(*args, mm)
        errs[name] = {k: ((g - w).abs().max() / w.abs().max()).item()
                      for k, g, w in zip(FFW_NAMES, got, want)}
    worst = {name: max(e.values()) for name, e in errs.items()}
    print(f"FFW residual-LN backward, N={n} D={d} F={f} keep={keep}, max abs err over the "
          f"largest magnitude: 3xTF32 {worst['3xTF32']:.3e}, 1xTF32 {worst['1xTF32']:.3e} "
          f"(limit {GRAD_TOL})")
    assert all(e < GRAD_TOL for e in errs["3xTF32"].values()), errs["3xTF32"]
    assert worst["3xTF32"] * 10 < worst["1xTF32"]


def test_ffw_ln_backward_takes_the_forward_relu_branch():
    # biases that put row 0's every hidden unit, and row 1's half of them,
    # within rounding of zero under the forward kernel's own arithmetic
    rng = np.random.default_rng(9)
    n, d, f = 40, 256, 128
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((d, f)) * d**-0.5).astype(np.float32))
    b1 = -_forward_chain(x[:1].expand(f, d), w1.t())
    b1[::2] = -_forward_chain(x[1:2].expand(f, d), w1.t())[::2]
    forward = (_forward_chain(x.repeat_interleave(f, 0), w1.t().repeat(n, 1)).view(n, f)
               + b1) > 0
    settled = _hidden_pre(x, w1, b1, _mm3) > 0
    unsettled = _hidden_pre(x, w1, b1, _mm3, settle=False) > 0
    print(f"hidden units whose ReLU branch differs from the forward's: "
          f"{(settled != forward).sum().item()} settled, {(unsettled != forward).sum().item()} "
          f"with the 3xTF32 pre alone, of {n * f}")
    assert torch.equal(settled, forward)
    assert not torch.equal(unsettled, forward)


def test_ffw_ln_backward_3xtf32_matches_the_jax_kernel():
    n, d, f, keep = 100, 32, 128, 0.8
    arrays, masks, dout = _ffw_case(np.random.default_rng(8), n, d, f, keep)
    _out, vjp = jax.vjp(
        lambda *a: jmlp.fused_mlp_residual_ln(*a, *(jnp.asarray(m) for m in masks), keep,
                                              interpret=True),
        *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(a) for a in arrays]
    got = _ffw_ln_bwd(*t[:6], *(torch.from_numpy(m) for m in masks), torch.from_numpy(dout),
                      tm._inv_keep(keep), 1e-6, _mm3)
    for name, g, w in zip(FFW_NAMES, got, want):
        w = np.asarray(w)
        print(f"{name}: emulated ffw_ln_bwd vs the JAX kernel's VJP, max abs err "
              f"{np.abs(g.numpy() - w).max():.3e}")
        np.testing.assert_allclose(g.numpy(), w, **JAX_TOL, err_msg=name)
