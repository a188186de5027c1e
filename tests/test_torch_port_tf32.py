"""The precision scheme of the port's tensor-core attention kernels, emulated
on the CPU.

``flash_fwd_single``, ``packed_attention_fwd``, ``packed_attention_bwd`` and
``flash_bwd_fused`` take each f32 product as three TF32 tensor-core products
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
backward route (``flash_self_attention``'s VJP in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_attention as pa
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta

ATTN_TOL = 1e-4  # forward: max abs error
GRAD_TOL = 1e-4  # backward: max abs error over the largest magnitude
LOW_BITS = ~0x1FFF  # clears the 13 mantissa bits TF32 does not keep
TILE = 64  # the kernels' key tile


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
