"""The precision scheme of the port's tensor-core kernels, emulated on the CPU.

``flash_fwd_single``, ``flash_fwd_tiled``, ``packed_attention_fwd``,
``packed_attention_bwd``, ``flash_bwd_fused``, ``flash_bwd_dkv``,
``flash_bwd_dq``, ``ffw_ln_fwd``, ``ffw_ln_bwd``, ``proj_ln_fwd``,
``proj_ln_bwd``, ``fused_mlp_fwd``, ``fused_mlp_bwd``, ``fused_hybrid_head``,
``lstm_train_fwd``, ``lstm_train_bwd``, ``gru_train_fwd``, ``gru_train_bwd``,
``grouped_lstm_fused`` and ``grouped_gru_fused`` (their cluster bodies) take
each f32 product as three TF32
tensor-core products (``ops/csrc/tf32_mma.cuh``): x = hi + lo, with
hi = x rounded to TF32 (half a TF32 ulp added to the bits, the low 13 bits
cleared) and lo = x - hi, of which the tensor core reads the top 19 bits; then
a*b = lo*hi' + hi*lo' + hi*hi' with f32 accumulation. TF32 values multiply
exactly in f32, so bit masks on int32 views and f32 products emulate the
scheme. The kernels' arithmetic, emulated so, stays within the limits
``chip_smoke.py`` holds the kernels to on the card against the plain versions:
1e-4 max abs for the attention forwards and the fused head, 1e-4 of the
largest magnitude for the backwards and the residual-LN kernels. One TF32 product per f32 product is
printed beside it; it misses them. The fused and the split attention
backwards' emulations are also held against the JAX package's routes of the
same name (``flash_self_attention``'s VJP in interpret mode), and the residual-LN
and feed-forward kernels' against ``fused_mlp_residual_ln``,
``fused_proj_residual_ln`` and ``fused_mlp`` there, and the fused head's
against ``fused_hybrid_head``. The LSTM training recurrences' emulation (a
cluster of CTAs, each holding its units' gate columns of W_hh; h exchanged
whole every step; the backward's per-CTA partials of dh summed in rank order)
is held to ``lstm_train_fwd_plain`` / ``lstm_train_bwd_plain`` at the f32
limits of ``test_torch_port_rnn_train.py`` and against the JAX package's
``grouped_lstm_trainable`` (its Pallas kernels in interpret mode) for h_T and
the three gradients; the GRU pair's the same way (r, z and h W_hn beside a
zero column in the forward, b_hn inside the reset gate; the backward's
per-CTA partials of dh at a 3U depth, and at 4U beside it) against
``gru_train_fwd_plain`` / ``gru_train_bwd_plain`` and the JAX package's
``grouped_gru_trainable``. The serving recurrences' emulation (each CTA's gate slots
of W_hh and of W_ih, the GRU's candidate gate split into an h slot and an x
slot beside zero columns, the x part over the input width padded to a
multiple of 8) is held to ``grouped_lstm_fused_plain`` /
``grouped_gru_fused_plain`` at the same limits and against the JAX package's
``grouped_lstm_fused`` / ``grouped_gru_fused`` in interpret mode; the same
body over a precomputed projection (``grouped_lstm_forward``: x_proj added in
the slots' local column order, no x product, at 16 and 32 rows a cluster)
against ``grouped_lstm_forward_plain`` and the JAX package's
``grouped_lstm_forward``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_attention as pa
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_mlp as jmlp
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_rnn as jrnn
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_rnn_train as jrt
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops.pallas_fusion import (
    fused_hybrid_head as jax_fused_hybrid_head,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion as tf
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import rnn as trnn
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.masked import (
    adaptive_gate_weights,
)
from test_torch_port_ops import HEAD_TOL, MASKS
from torch_port_schemes import (
    CHUNK_K,
    _block_sums,
    _mm_chunked,
    _split_grad,
    _tf32_cut,
    _tf32_hi,
)

ATTN_TOL = 1e-4  # forward: max abs error
GRAD_TOL = 1e-4  # backward: max abs error over the largest magnitude
TILE = 64  # the kernels' key tile
# f32 on both sides, products and sums in another order: the tolerance of the
# port's residual-LN tests against the JAX package
JAX_TOL = dict(rtol=2e-5, atol=2e-5)


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


def _flash_bwd_split(q, k, v, lengths, heads, lse, delta, dout, scale, mm):
    """The split route's arithmetic -> ``(dq, dk, dv)``. dq is
    ``flash_bwd_dq``'s: per 64-row query tile (each query row's sums stand
    alone, so all tiles at once), S = q k^T and dP = dout v^T, p and ds from
    them, then each 64-key tile's ds k taken alone (the kernel's fresh
    accumulator) and added in f32 in key-tile order, sm_scale last; all
    products through ``mm``. dk and dv are ``_flash_bwd_fused``'s by
    construction: ``flash_bwd_dkv`` runs the fused kernel's body with its dq
    compiled out, the same instructions for dk and dv."""
    seq = q.shape[1]
    lens = lengths.long().repeat_interleave(heads)
    key_ok = (torch.arange(seq)[None, :] < lens[:, None])[:, None, :]  # [BH, 1, Tk]
    lse_q = lse[:, :, None]  # [BH, Tq, 1]
    keep = key_ok & (lse_q > ta.NEG_INF / 2)
    p = torch.where(keep, torch.exp(mm(q, k.transpose(1, 2)) * scale - lse_q), 0.0)
    ds = p * (mm(dout, v.transpose(1, 2)) - delta[:, :, None])
    dq = torch.zeros_like(q)
    for k0 in range(0, seq, TILE):
        keys = slice(k0, k0 + TILE)
        dq = dq + mm(ds[:, :, keys], k[:, keys])  # key tile k0's product
    _dq, dk, dv = _flash_bwd_fused(q, k, v, lengths, heads, lse, delta, dout, scale, mm)
    return dq * scale, dk, dv


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


def test_flash_split_backward_dq_3xtf32_holds_the_f32_limit():
    rng = np.random.default_rng(10)
    heads, seq, d = 1, 1024, 64
    q, k, v, dout = _flash_case(rng, 2, seq, d)
    lengths = torch.tensor([1024, 613], dtype=torch.int32)
    scale = d**-0.5
    out, lse = ta.flash_attention_reference(q, k, v, lengths, heads, scale)
    delta = (dout * out).sum(-1)
    want = ta.flash_dq_reference(q, k, v, lengths, heads, lse, delta, dout, scale)
    errs = {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        got = _flash_bwd_split(q, k, v, lengths, heads, lse, delta, dout, scale, mm)[0]
        errs[name] = ((got - want).abs().max() / want.abs().max()).item()
    print(f"flash split backward dq, BH=2 T=1024 d=64, max abs err over the largest magnitude: "
          f"3xTF32 {errs['3xTF32']:.3e}, 1xTF32 {errs['1xTF32']:.3e} (limit {GRAD_TOL})")
    assert errs["3xTF32"] < GRAD_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


def test_flash_split_backward_3xtf32_matches_the_jax_split_route(monkeypatch):
    # the reference's split pair (_dkv_kernel, _dq_kernel), pinned through its
    # environment knob with blocks smaller than T; the port's router agrees
    monkeypatch.setenv("MSFA_FLASH_FUSED_BWD_MAX", "0")
    batch, heads, seq, d, block = 2, 1, 256, 64, 128
    assert ta.flash_routes(seq, block, block, fused_bwd_max=0)[1] == "split"
    assert not seq <= max(block, pa._fused_bwd_max())  # the reference's condition
    rng = np.random.default_rng(11)
    q, k, v, dout = (a.numpy().reshape(batch, heads, seq, d) for a in _flash_case(rng, 2, seq, d))
    lens = np.array([256, 150], np.int32)
    _out, vjp = jax.vjp(
        lambda a, b, c: pa.flash_self_attention(a, b, c, jnp.asarray(lens), block_q=block,
                                                block_k=block, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    flat = [torch.from_numpy(a.reshape(batch * heads, seq, d)) for a in (q, k, v, dout)]
    lengths = torch.from_numpy(lens)
    scale = d**-0.5
    out, lse = _flash_fwd(*flat[:3], lengths, heads, scale, _mm3, pv_keys=16)
    delta = (flat[3] * out).sum(-1)
    got = _flash_bwd_split(*flat[:3], lengths, heads, lse, delta, flat[3], scale, _mm3)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w).reshape(batch * heads, seq, d)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        print(f"d{name}: emulated split backward vs the JAX split route, rel err {err:.3e}")
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


def _scales(fmask, rmask, inv_keep):
    return tuple(1.0 if m is None else m.float() * inv_keep for m in (fmask, rmask))


def _hidden(x, w1, b1, fscale, mm):
    """``ffw_ln_hidden_kernel``'s arithmetic, which both directions launch:
    hd = relu(x W1 + b1) * fmask * inv_keep, the product through ``mm``."""
    return torch.relu(_mm_chunked(x, w1, mm) + b1) * fscale


def _ffw_ln_fwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep, eps, mm):
    """``ffw_ln_fwd``'s arithmetic -> ``(out, hd)``: the hidden, then
    y = hd W2 + b2 on 64 whole rows with the residual and the LayerNorm as its
    epilogue."""
    fscale, rscale = _scales(fmask, rmask, inv_keep)
    hd = _hidden(x, w1, b1, fscale, mm)
    y = (_mm_chunked(hd, w2, mm) + b2) * rscale
    return tm.ln_rows(x + y, gamma, beta, eps)[0], hd


def _ffw_ln_bwd(x, w1, b1, w2, b2, gamma, fmask, rmask, dout, inv_keep, eps, mm):
    """``ffw_ln_bwd``'s arithmetic -> ``(grads, hd)``: the forward's hidden
    (one kernel), then the five other products through ``mm`` in 32-deep
    fresh accumulators; dW1 and dW2 per split of the rows, the splits added
    in order; db1 from 128-row blocks, db2, dgamma, dbeta from 64-row blocks,
    the partials added in order."""
    d, f = w1.shape
    fscale, rscale = _scales(fmask, rmask, inv_keep)
    hd = _hidden(x, w1, b1, fscale, mm)
    y = (_mm_chunked(hd, w2, mm) + b2) * rscale
    _out, xhat, inv = tm.ln_rows(x + y, gamma, torch.zeros_like(gamma), eps)
    dr, _dgamma, _dbeta = tm._ln_backward(dout, xhat, inv, gamma)
    dy = dr * rscale
    dpre = torch.where(hd > 0, _mm_chunked(dy, w2.t(), mm) * fscale, 0.0)
    dx = dr + _mm_chunked(dpre, w1.t(), mm)
    dw1 = _split_grad(x, dpre, tm._grad_tiles(d, f), mm)
    dw2 = _split_grad(hd, dy, tm._grad_tiles(f, d), mm)
    db1 = _block_sums(dpre, tm.ROWS_F)
    db2, dgamma, dbeta = (_block_sums(t, tm.ROWS_D) for t in (dy, dout * xhat, dout))
    return (dx, dw1, db1, dw2, db2, dgamma, dbeta), hd


def _fused_mlp_fwd(x, w1, b1, w2, b2, mask, inv_keep, mm):
    """``fused_mlp_fwd``'s arithmetic -> ``(out, hd)``: the hidden (the body
    ``ffw_ln`` launches too), then out = hd W2 + b2 on 64 whole rows."""
    fscale, _rscale = _scales(mask, None, inv_keep)
    hd = _hidden(x, w1, b1, fscale, mm)
    return _mm_chunked(hd, w2, mm) + b2, hd


def _fused_mlp_bwd(x, w1, b1, w2, mask, dout, inv_keep, mm):
    """``fused_mlp_bwd``'s arithmetic -> ``((dx, dw1, db1, dw2), hd)``: the
    forward's hidden (one body), then dpre from dout, dx = dpre W1^T and the
    weight gradients through ``mm`` in 32-deep fresh accumulators; dW1 and
    dW2 per split of the rows (one split count for both, as the wrapper
    passes), the splits added in order; db1 from 128-row blocks."""
    d, f = w1.shape
    fscale, _rscale = _scales(mask, None, inv_keep)
    hd = _hidden(x, w1, b1, fscale, mm)
    dpre = torch.where(hd > 0, _mm_chunked(dout, w2.t(), mm) * fscale, 0.0)
    dx = _mm_chunked(dpre, w1.t(), mm)
    tiles = tm._grad_tiles(f, d)
    dw1 = _split_grad(x, dpre, tiles, mm)
    dw2 = _split_grad(hd, dout, tiles, mm)
    return (dx, dw1, _block_sums(dpre, tm.ROWS_F), dw2), hd


def _proj_residual(x, a, wo, bo, rmask, inv_keep, mm):
    """The LN product of both projection kernels -> ``(r, rscale)``:
    r = x + (a Wo + bo) * rmask * inv_keep, the product through ``mm`` in
    32-deep fresh accumulators."""
    _fscale, rscale = _scales(None, rmask, inv_keep)
    return x + (_mm_chunked(a, wo, mm) + bo) * rscale, rscale


def _proj_ln_fwd(x, a, wo, bo, gamma, beta, rmask, inv_keep, eps, mm):
    """``proj_ln_fwd``'s arithmetic: y = a Wo + bo on 64 whole rows with the
    residual and the LayerNorm as its epilogue (``ffw_ln_fwd``'s LN product
    at K = D)."""
    r, _rscale = _proj_residual(x, a, wo, bo, rmask, inv_keep, mm)
    return tm.ln_rows(r, gamma, beta, eps)[0]


def _proj_ln_bwd(x, a, wo, bo, gamma, rmask, dout, inv_keep, eps, mm):
    """``proj_ln_bwd``'s arithmetic: y = a Wo + bo on 64 whole rows with the
    LayerNorm backward as its epilogue (dx = dr, dy), da = dy Wo^T, dWo per
    split of the rows, dbo, dgamma, dbeta from 64-row blocks, the partials
    added in order; the products through ``mm`` in 32-deep fresh
    accumulators."""
    d = x.shape[1]
    r, rscale = _proj_residual(x, a, wo, bo, rmask, inv_keep, mm)
    _out, xhat, inv = tm.ln_rows(r, gamma, torch.zeros_like(gamma), eps)
    dr, _dgamma, _dbeta = tm._ln_backward(dout, xhat, inv, gamma)
    dy = dr * rscale
    da = _mm_chunked(dy, wo.t(), mm)
    dwo = _split_grad(a, dy, tm._grad_tiles(d, d), mm)
    dbo, dgamma, dbeta = (_block_sums(t, tm.ROWS_D) for t in (dy, dout * xhat, dout))
    return dr, da, dwo, dbo, dgamma, dbeta


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


def _proj_case(rng, n, d, keep):
    f32 = np.float32
    arrays = [rng.standard_normal((n, d)).astype(f32), rng.standard_normal((n, d)).astype(f32),
              (rng.standard_normal((d, d)) * d**-0.5).astype(f32),
              (0.1 * rng.standard_normal(d)).astype(f32),
              (1 + 0.1 * rng.standard_normal(d)).astype(f32),
              (0.1 * rng.standard_normal(d)).astype(f32)]
    rmask = None if keep is None else (rng.random((n, d)) < keep).astype(np.uint8)
    return arrays, rmask, rng.standard_normal((n, d)).astype(f32)


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _rel_errs(got, want, names):
    return {k: ((g - w).abs().max() / w.abs().max()).item() for k, g, w in zip(names, got, want)}


FFW_NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta")
PROJ_NAMES = ("dx", "da", "dwo", "dbo", "dgamma", "dbeta")
LN_CASES = dict(argnames="n,keep", argvalues=[(100, 0.8), (300, None)],
                ids=["N100-keep0.8", "N300-nomask"])


@pytest.mark.parametrize(**LN_CASES)
def test_ffw_ln_forward_3xtf32_holds_the_f32_limit(n, keep):
    d, f = 32, 128
    arrays, masks, _dout = _ffw_case(np.random.default_rng(17 + n), n, d, f, keep)
    args = (*_torch(arrays), *_torch(masks), tm._inv_keep(1.0 if keep is None else keep), 1e-6)
    want = tm.ffw_ln_fwd_reference(*args)
    errs = {name: ((_ffw_ln_fwd(*args, mm)[0] - want).abs().max() / want.abs().max()).item()
            for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1))}
    print(f"FFW residual-LN forward, N={n} D={d} F={f} keep={keep}, max abs err over the "
          f"largest magnitude: 3xTF32 {errs['3xTF32']:.3e}, 1xTF32 {errs['1xTF32']:.3e} "
          f"(limit {GRAD_TOL})")
    assert errs["3xTF32"] < GRAD_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


def test_ffw_ln_forward_3xtf32_matches_the_jax_kernel():
    n, d, f, keep = 100, 32, 128, 0.8
    arrays, masks, _dout = _ffw_case(np.random.default_rng(18), n, d, f, keep)
    want = jmlp.fused_mlp_residual_ln(*(jnp.asarray(a) for a in arrays),
                                      *(jnp.asarray(m) for m in masks), keep, interpret=True)
    got, _hd = _ffw_ln_fwd(*_torch(arrays), *_torch(masks), tm._inv_keep(keep), 1e-6, _mm3)
    print(f"emulated ffw_ln_fwd vs the JAX kernel, max abs err "
          f"{np.abs(got.numpy() - np.asarray(want)).max():.3e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize(**LN_CASES)
def test_ffw_ln_backward_3xtf32_holds_the_f32_limit(n, keep):
    d, f = 32, 128
    arrays, masks, dout = _ffw_case(np.random.default_rng(7 + n), n, d, f, keep)
    t, tmask = _torch(arrays), _torch(masks)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    want = tm.ffw_ln_bwd_reference(*t, *tmask, torch.from_numpy(dout), inv_keep, 1e-6)
    args = (*t[:6], *tmask, torch.from_numpy(dout), inv_keep, 1e-6)
    errs = {name: _rel_errs(_ffw_ln_bwd(*args, mm)[0], want, FFW_NAMES)
            for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1))}
    worst = {name: max(e.values()) for name, e in errs.items()}
    print(f"FFW residual-LN backward, N={n} D={d} F={f} keep={keep}, max abs err over the "
          f"largest magnitude: 3xTF32 {worst['3xTF32']:.3e}, 1xTF32 {worst['1xTF32']:.3e} "
          f"(limit {GRAD_TOL})")
    assert all(e < GRAD_TOL for e in errs["3xTF32"].values()), errs["3xTF32"]
    assert worst["3xTF32"] * 10 < worst["1xTF32"]


def _fma_chain(x, w):
    """Rows of x dotted with rows of w as one f32 FMA chain over k in order
    (each step exact in f64, then rounded): what a backward that settled
    near-zero units by such a chain would take."""
    s = torch.zeros(x.shape[0])
    for k in range(x.shape[1]):
        s = (s.double() + x[:, k].double() * w[:, k].double()).float()
    return s


def test_ffw_ln_directions_share_one_hidden_and_its_relu_branch():
    # biases that put half of row 0's hidden units and the other half of row
    # 1's exactly at zero under the hidden kernel's own 3xTF32 arithmetic
    rng = np.random.default_rng(9)
    n, d, f = 40, 256, 128
    arrays, masks, dout = _ffw_case(rng, n, d, f, 0.8)
    x, w1, _b1, w2, b2, gamma, beta = _torch(arrays)
    fmask, rmask = _torch(masks)
    fmask[:2] = 1  # the units built at zero are all kept
    pre3 = _mm_chunked(x, w1, _mm3)
    b1 = -pre3[0].clone()
    b1[::2] = -pre3[1, ::2]
    inv_keep = tm._inv_keep(0.8)
    _out, fwd_hd = _ffw_ln_fwd(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep, 1e-6,
                               _mm3)
    _grads, bwd_hd = _ffw_ln_bwd(x, w1, b1, w2, b2, gamma, fmask, rmask,
                                 torch.from_numpy(dout), inv_keep, 1e-6, _mm3)
    assert torch.equal(fwd_hd, bwd_hd)  # one kernel: the same bits, so the same branches
    # the rule that went: units within (D + 64) 2^-23 |x_n| |W1[:, f]| of zero
    # taken again by an f32 FMA chain; against this forward it flips branches
    pre = pre3 + b1
    band = (d + 64) * 2.0**-23 * x.norm(dim=1)[:, None] * w1.norm(dim=0)[None, :]
    rows, cols = (pre.abs() < band).nonzero(as_tuple=True)
    settled = pre.clone()
    settled[rows, cols] = _fma_chain(x[rows], w1[:, cols].t()) + b1[cols]
    kept = fmask.bool()
    forward_on = (fwd_hd > 0) & kept
    flips = ((settled > 0) & kept) != forward_on
    print(f"{f} hidden units built at zero: the backward's branch differs from the "
          f"forward's on 0 units, with an FMA-chain settle on {flips.sum().item()} of the "
          f"{len(rows)} it would settle")
    assert flips.any()


def test_ffw_ln_backward_3xtf32_matches_the_jax_kernel():
    n, d, f, keep = 100, 32, 128, 0.8
    arrays, masks, dout = _ffw_case(np.random.default_rng(8), n, d, f, keep)
    _out, vjp = jax.vjp(
        lambda *a: jmlp.fused_mlp_residual_ln(*a, *(jnp.asarray(m) for m in masks), keep,
                                              interpret=True),
        *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(dout))
    t = _torch(arrays)
    got, _hd = _ffw_ln_bwd(*t[:6], *_torch(masks), torch.from_numpy(dout), tm._inv_keep(keep),
                           1e-6, _mm3)
    for name, g, w in zip(FFW_NAMES, got, want):
        w = np.asarray(w)
        print(f"{name}: emulated ffw_ln_bwd vs the JAX kernel's VJP, max abs err "
              f"{np.abs(g.numpy() - w).max():.3e}")
        np.testing.assert_allclose(g.numpy(), w, **JAX_TOL, err_msg=name)


@pytest.mark.parametrize(**LN_CASES)
def test_proj_ln_forward_3xtf32_holds_the_f32_limit(n, keep):
    d = 64
    arrays, rmask, _dout = _proj_case(np.random.default_rng(25 + n), n, d, keep)
    args = (*_torch(arrays), *_torch([rmask]), tm._inv_keep(1.0 if keep is None else keep), 1e-6)
    want = tm.proj_ln_fwd_reference(*args)
    errs = {name: ((_proj_ln_fwd(*args, mm) - want).abs().max() / want.abs().max()).item()
            for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1))}
    print(f"projection residual-LN forward, N={n} D={d} keep={keep}, max abs err over the "
          f"largest magnitude: 3xTF32 {errs['3xTF32']:.3e}, 1xTF32 {errs['1xTF32']:.3e} "
          f"(limit {GRAD_TOL})")
    assert errs["3xTF32"] < GRAD_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


def test_proj_ln_forward_3xtf32_matches_the_jax_kernel():
    n, d, keep = 100, 64, 0.8
    arrays, rmask, _dout = _proj_case(np.random.default_rng(26), n, d, keep)
    want = jmlp.fused_proj_residual_ln(*(jnp.asarray(a) for a in arrays), jnp.asarray(rmask),
                                       keep, interpret=True)
    got = _proj_ln_fwd(*_torch(arrays), torch.from_numpy(rmask), tm._inv_keep(keep), 1e-6, _mm3)
    print(f"emulated proj_ln_fwd vs the JAX kernel, max abs err "
          f"{np.abs(got.numpy() - np.asarray(want)).max():.3e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize(**LN_CASES)
def test_proj_ln_backward_3xtf32_holds_the_f32_limit(n, keep):
    d = 64
    arrays, rmask, dout = _proj_case(np.random.default_rng(27 + n), n, d, keep)
    x, a, wo, bo, gamma, beta = _torch(arrays)
    rmask, dout = _torch([rmask, dout])
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    want = tm.proj_ln_bwd_reference(x, a, wo, bo, gamma, beta, rmask, dout, inv_keep, 1e-6)
    errs = {name: _rel_errs(_proj_ln_bwd(x, a, wo, bo, gamma, rmask, dout, inv_keep, 1e-6, mm),
                            want, PROJ_NAMES)
            for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1))}
    worst = {name: max(e.values()) for name, e in errs.items()}
    print(f"projection residual-LN backward, N={n} D={d} keep={keep}, max abs err over the "
          f"largest magnitude: 3xTF32 {worst['3xTF32']:.3e}, 1xTF32 {worst['1xTF32']:.3e} "
          f"(limit {GRAD_TOL})")
    assert all(e < GRAD_TOL for e in errs["3xTF32"].values()), errs["3xTF32"]
    assert worst["3xTF32"] * 10 < worst["1xTF32"]


def test_proj_ln_backward_3xtf32_matches_the_jax_kernel():
    n, d, keep = 100, 64, 0.8
    arrays, rmask, dout = _proj_case(np.random.default_rng(28), n, d, keep)
    _out, vjp = jax.vjp(
        lambda *args: jmlp.fused_proj_residual_ln(*args, jnp.asarray(rmask), keep,
                                                  interpret=True),
        *(jnp.asarray(v) for v in arrays))
    want = vjp(jnp.asarray(dout))
    x, a, wo, bo, gamma, _beta = _torch(arrays)
    got = _proj_ln_bwd(x, a, wo, bo, gamma, torch.from_numpy(rmask), torch.from_numpy(dout),
                       tm._inv_keep(keep), 1e-6, _mm3)
    for name, g, w in zip(PROJ_NAMES, got, want):
        w = np.asarray(w)
        print(f"{name}: emulated proj_ln_bwd vs the JAX kernel's VJP, max abs err "
              f"{np.abs(g.numpy() - w).max():.3e}")
        np.testing.assert_allclose(g.numpy(), w, **JAX_TOL, err_msg=name)


MLP_NAMES = ("dx", "dw1", "db1", "dw2")


def _mlp_case(seed, n, keep, d=32, f=128):
    """x, w1, b1, w2, b2, mask (or None) and dout of one feed-forward case, as tensors."""
    arrays, masks, dout = _ffw_case(np.random.default_rng(seed), n, d, f, keep)
    return (*_torch(arrays[:5]), _torch(masks)[0], torch.from_numpy(dout))


@pytest.mark.parametrize(**LN_CASES)
def test_fused_mlp_forward_3xtf32_holds_the_f32_limit(n, keep):
    x, w1, b1, w2, b2, mask, _dout = _mlp_case(37 + n, n, keep)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    want = tm.fused_mlp_fwd_reference(x, w1, b1, w2, b2, mask, inv_keep)
    errs = {name: ((_fused_mlp_fwd(x, w1, b1, w2, b2, mask, inv_keep, mm)[0] - want).abs().max()
                   / want.abs().max()).item()
            for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1))}
    print(f"fused_mlp forward, N={n} keep={keep}, max abs err over the largest magnitude: "
          f"3xTF32 {errs['3xTF32']:.3e}, 1xTF32 {errs['1xTF32']:.3e} (limit {GRAD_TOL})")
    assert errs["3xTF32"] < GRAD_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


@pytest.mark.parametrize(**LN_CASES)
def test_fused_mlp_backward_3xtf32_holds_the_f32_limit(n, keep):
    x, w1, b1, w2, _b2, mask, dout = _mlp_case(47 + n, n, keep)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    want = tm.fused_mlp_bwd_reference(x, w1, b1, w2, mask, dout, inv_keep)
    errs = {name: _rel_errs(_fused_mlp_bwd(x, w1, b1, w2, mask, dout, inv_keep, mm)[0], want,
                            MLP_NAMES)
            for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1))}
    worst = {name: max(e.values()) for name, e in errs.items()}
    print(f"fused_mlp backward, N={n} keep={keep}, max abs err over the largest magnitude: "
          f"3xTF32 {worst['3xTF32']:.3e}, 1xTF32 {worst['1xTF32']:.3e} (limit {GRAD_TOL})")
    assert all(e < GRAD_TOL for e in errs["3xTF32"].values()), errs["3xTF32"]
    assert worst["3xTF32"] * 10 < worst["1xTF32"]


def test_fused_mlp_forward_3xtf32_matches_the_jax_kernel():
    keep = 0.8
    args = _mlp_case(48, 100, keep)
    x, w1, b1, w2, b2, mask, _dout = args
    want = jmlp.fused_mlp(*(jnp.asarray(t.numpy()) for t in args[:6]), keep, interpret=True)
    got, _hd = _fused_mlp_fwd(x, w1, b1, w2, b2, mask, tm._inv_keep(keep), _mm3)
    print(f"emulated fused_mlp_fwd vs the JAX kernel, max abs err "
          f"{np.abs(got.numpy() - np.asarray(want)).max():.3e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_fused_mlp_backward_3xtf32_matches_the_jax_kernel():
    keep = 0.8
    x, w1, b1, w2, b2, mask, dout = _mlp_case(49, 100, keep)
    _out, vjp = jax.vjp(
        lambda *a: jmlp.fused_mlp(*a, jnp.asarray(mask.numpy()), keep, interpret=True),
        *(jnp.asarray(t.numpy()) for t in (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(dout.numpy()))
    grads, _hd = _fused_mlp_bwd(x, w1, b1, w2, mask, dout, tm._inv_keep(keep), _mm3)
    for name, g, w in zip((*MLP_NAMES, "db2"), (*grads, dout.sum(0)), want):
        w = np.asarray(w)
        print(f"{name}: emulated fused_mlp_bwd vs the JAX kernel's VJP, max abs err "
              f"{np.abs(g.numpy() - w).max():.3e}")
        np.testing.assert_allclose(g.numpy(), w, **JAX_TOL, err_msg=name)


def test_fused_mlp_and_ffw_ln_share_one_hidden_and_its_relu_branch():
    # biases that put half of row 0's hidden units and the other half of row
    # 1's exactly at zero under the hidden body's own 3xTF32 arithmetic
    n, d, f, keep = 40, 256, 128, 0.8
    arrays, masks, dout = _ffw_case(np.random.default_rng(11), n, d, f, keep)
    x, w1, _b1, w2, b2, gamma, beta = _torch(arrays)
    mask, rmask = _torch(masks)
    mask[:2] = 1  # the units built at zero are all kept
    dout = torch.from_numpy(dout)
    pre3 = _mm_chunked(x, w1, _mm3)
    b1 = -pre3[0].clone()
    b1[::2] = -pre3[1, ::2]
    inv_keep = tm._inv_keep(keep)
    _out, fwd_hd = _fused_mlp_fwd(x, w1, b1, w2, b2, mask, inv_keep, _mm3)
    grads, bwd_hd = _fused_mlp_bwd(x, w1, b1, w2, mask, dout, inv_keep, _mm3)
    _out, ln_hd = _ffw_ln_fwd(x, w1, b1, w2, b2, gamma, beta, mask, rmask, inv_keep, 1e-6, _mm3)
    # one body: the same bits in both directions of both pairs
    assert torch.equal(fwd_hd, bwd_hd) and torch.equal(fwd_hd, ln_hd)
    # the plain twin rounds pre otherwise and takes other branches near zero;
    # on the forward's branches it holds the f32 limit, as chip_smoke.py checks
    pre = x @ w1 + b1
    live = torch.where(mask.bool(), fwd_hd > 0, pre > 0)
    off = live != (pre > 0)
    band = (d + 64) * 2.0**-23 * x.norm(dim=1)[:, None] * w1.norm(dim=0)[None, :]
    on_branch = _rel_errs(grads, tm._fused_mlp_bwd_plain(x, w1, pre, live, w2, mask, dout,
                                                         inv_keep), MLP_NAMES)
    own = _rel_errs(grads, tm.fused_mlp_bwd_reference(x, w1, b1, w2, mask, dout, inv_keep),
                    MLP_NAMES)
    print(f"{f} hidden units built at zero: {off.sum().item()} branches off the twin's, all "
          f"within rounding of zero; on the forward's branches {max(on_branch.values()):.3e}, "
          f"on the twin's own {max(own.values()):.3e}")
    assert off.any() and not torch.any(off & (pre.abs() >= band))
    assert all(e < GRAD_TOL for e in on_branch.values()), on_branch


# ------------------------------------------------------------- fused head

HEAD_PAIRS = [(q, k) for q in range(4) for k in range(4) if q != k]
HEAD_MAX_ABS = 1e-4  # chip_smoke.py's limit for the head against its twin
PAIR_KEYS = ("value_kernel", "value_bias", "out_kernel", "out_bias")
HEAD_REST = ("gate_kernels", "gate_biases", "w1", "b1", "w2", "b2")


def _head_case(batch, mask_name, num_mod=4, hidden=32, classes=5):
    """Inputs of one head case as numpy arrays: M = 4, H = 32, C = 5, a
    batch that is not a multiple of the kernels' 64-row tile, and the mask
    rows of ``MASKS[mask_name]`` repeated down the batch."""
    rng = np.random.default_rng(batch + len(mask_name))
    p = len(HEAD_PAIRS)

    def w(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = {
        "projected": np.maximum(w(num_mod, batch, hidden, scale=1.0), 0.0),
        "value_kernel": w(p, hidden, hidden), "value_bias": w(p, hidden),
        "out_kernel": w(p, hidden, hidden), "out_bias": w(p, hidden),
        "gate_kernels": w(num_mod, hidden), "gate_biases": w(num_mod),
        "w1": w(hidden, hidden), "b1": w(hidden), "w2": w(hidden, classes), "b2": w(classes),
    }
    return arrays, np.resize(MASKS[mask_name], (batch, num_mod))


def _head(projected, mask, pair_params, gate_kernels, gate_biases, w1, b1, w2, b2, mm):
    """``fused_hybrid_head``'s arithmetic (``csrc/fusion_head.cu``): the pair
    values v_p = e_k Wv_p + bv_p, their out-projections and the hidden through
    ``mm`` in 32-deep fresh accumulators; the key mask selects bo_p per row
    after the product, the pairs of a query added in query-major order; the
    gate, the weighted sum and the logits in f32."""
    num_mod = projected.shape[0]
    wv, bv = pair_params["value_kernel"], pair_params["value_bias"]
    wo, bo = pair_params["out_kernel"], pair_params["out_bias"]
    aggs = []
    for q in range(num_mod):
        total = projected[q]
        for p, (pq, pk) in enumerate(HEAD_PAIRS):
            if pq == q:
                v = _mm_chunked(projected[pk], wv[p], mm) + bv[p]
                att = _mm_chunked(v, wo[p], mm) + bo[p]
                total = total + torch.where(mask[:, pk:pk + 1] > 0, att, bo[p])
        aggs.append(total / num_mod * mask[:, q:q + 1])
    score = torch.stack([(aggs[m] * gate_kernels[m]).sum(-1) + gate_biases[m]
                         for m in range(num_mod)], dim=-1)
    weights = adaptive_gate_weights(score, mask, num_mod)
    fused = aggs[0] * weights[:, :1]
    for m in range(1, num_mod):
        fused = fused + aggs[m] * weights[:, m:m + 1]
    hidden = torch.relu(_mm_chunked(fused, w1, mm) + b1)
    return hidden @ w2 + b2


def _head_args(arrays, mask, as_tensor):
    return (as_tensor(arrays["projected"]), as_tensor(mask),
            {k: as_tensor(arrays[k]) for k in PAIR_KEYS},
            *(as_tensor(arrays[k]) for k in HEAD_REST))


@pytest.mark.parametrize("batch", [5, 70])
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_fused_head_3xtf32_holds_the_f32_limit(batch, mask_name):
    arrays, mask = _head_case(batch, mask_name)
    args = _head_args(arrays, mask, torch.from_numpy)
    want = tf.fused_hybrid_head_reference(*args, HEAD_PAIRS)
    errs = {name: (_head(*args, mm) - want).abs().max().item()
            for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1))}
    print(f"fused head, B={batch} mask {mask_name}, max abs err: 3xTF32 {errs['3xTF32']:.3e}, "
          f"1xTF32 {errs['1xTF32']:.3e} (limit {HEAD_MAX_ABS})")
    assert errs["3xTF32"] < HEAD_MAX_ABS
    if mask_name == "none":  # every agg is 0: the products multiply zeros, exactly
        assert errs["3xTF32"] == errs["1xTF32"] == 0.0
    else:
        assert errs["3xTF32"] * 10 < errs["1xTF32"]


@pytest.mark.parametrize("batch", [5, 70])
@pytest.mark.parametrize("mask_name", list(MASKS))
def test_fused_head_3xtf32_matches_the_jax_kernel(batch, mask_name):
    arrays, mask = _head_case(batch, mask_name)
    projected, jmask, pair_params, *rest = _head_args(arrays, mask, jnp.asarray)
    want = np.asarray(jax_fused_hybrid_head(projected, jmask, pair_params, *rest, HEAD_PAIRS,
                                            interpret=True))
    got = _head(*_head_args(arrays, mask, torch.from_numpy), _mm3).numpy()
    print(f"emulated fused head vs the JAX kernel, B={batch} mask {mask_name}, max abs err "
          f"{np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, **HEAD_TOL)


# ------------------------------------------------ LSTM training recurrences

CLUSTER = 4  # CTAs per cluster in the emulation (the kernels take 8 at H = 256)
# f32 both sides, up to 64 dependent steps: test_torch_port_rnn_train.py's limits
RNN_VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
RNN_CASES = dict(argnames="steps,batch,hidden", argvalues=[(22, 5, 32), (64, 20, 64)],
                 ids=["T22-B5-H32", "T64-B20-H64"])
RNN_GROUPS = 3


@contextlib.contextmanager
def _one_thread():
    """The recurrences' emulations are thousands of tiny tensor ops a call:
    on torch's intra-op thread pool each pays a parallel region (25x the
    time on one thread here, more beside other test workers), so they run on
    one thread, the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _local_columns(hidden, cluster):
    """Each CTA's gate columns of W_hh in the kernels' local order
    (``rnn_cluster.cuh`` ``local_col``): local column n is in n-tile n // 8 of
    warp n // 16, whose first tile holds gates i, f and second g, o; its
    columns 2t and 2t + 1 are those two gates of the warp's unit 4 w + t."""
    units = hidden // cluster
    order = []
    for n in range(4 * units):
        tile, col = divmod(n, 8)
        warp, second = divmod(tile, 2)
        order.append((2 * second + col % 2, 4 * warp + col // 2))
    return [[q * hidden + rank * units + u for q, u in order] for rank in range(cluster)]


@_one_thread()
def _lstm_cluster_fwd(x_proj, w_hh, b_hh, lengths, mm):
    """``lstm_train_fwd``'s arithmetic on the cluster body: per step every
    CTA's z = h_{t-1} W_hh slice through ``mm`` in 32-deep fresh accumulators
    (a gate column's sum is the same whichever CTA owns it), then (z + x_proj)
    + b_hh, the cell, the carry frozen past each length, and h exchanged whole
    for the next step -> ``(h_T, gates, hprev, cprev)``, residuals zero past
    each length."""
    steps, groups, batch, _cols = x_proj.shape
    hidden = w_hh.shape[1]
    valid = trnn._valid_steps(steps, lengths, "cpu")
    h = torch.zeros(groups, batch, hidden)
    c = torch.zeros_like(h)
    gates, hprev, cprev = [], [], []
    for t in range(steps):
        keep = valid[t] if valid is not None else torch.ones(batch, 1, dtype=torch.bool)
        z = torch.stack([_mm_chunked(h[g], w_hh[g], mm) for g in range(groups)])
        z = z + x_proj[t] + b_hh[:, None, :]
        i, f, gg, o = z.chunk(4, dim=-1)
        act = torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)], -1)
        i, f, gg, o = act.chunk(4, dim=-1)
        c_new = f * c + i * gg
        h_new = o * torch.tanh(c_new)
        gates.append(torch.where(keep, act, 0.0))
        hprev.append(torch.where(keep, h, 0.0))
        cprev.append(torch.where(keep, c, 0.0))
        h, c = torch.where(keep, h_new, h), torch.where(keep, c_new, c)
    return h, torch.stack(gates), torch.stack(hprev), torch.stack(cprev)


@_one_thread()
def _lstm_cluster_bwd(gates, cprev, w_hh, lengths, dh_out, mm, cluster=CLUSTER):
    """``lstm_train_bwd``'s arithmetic on the cluster body: reverse time, dz
    from the residuals; each CTA's partial of dh_{t-1}, its dz columns in local
    order times its W_hh slice transposed through ``mm`` in 32-deep fresh
    accumulators; the partials summed in rank order, then the frozen rows' dh
    added -> dz, zero past each length."""
    steps, groups, batch, cols = gates.shape
    local = _local_columns(cols // 4, cluster)
    valid = trnn._valid_steps(steps, lengths, "cpu")
    dh, dc = dh_out.clone(), torch.zeros_like(dh_out)
    dz = []
    for t in reversed(range(steps)):
        keep = valid[t] if valid is not None else torch.ones(batch, 1, dtype=torch.bool)
        i, f, g, o = gates[t].chunk(4, dim=-1)
        c_prev = cprev[t]
        tc = torch.tanh(f * c_prev + i * g)
        dct = dc + dh * o * (1 - tc * tc)
        step = torch.cat([dct * g * i * (1 - i), dct * c_prev * f * (1 - f),
                          dct * i * (1 - g * g), dh * tc * o * (1 - o)], -1)
        step = torch.where(keep, step, 0.0)
        dc = torch.where(keep, dct * f, dc)
        skip = torch.where(keep, 0.0, dh)
        dz.append(step)
        total = None
        for cols_c in local:  # rank order
            part = torch.stack([_mm_chunked(step[k][:, cols_c], w_hh[k][:, cols_c].t(), mm)
                                for k in range(groups)])
            total = part if total is None else total + part
        dh = total + skip
    return torch.stack(dz[::-1])


def _rnn_case(steps, batch, hidden, kind, gates=4):
    rng = np.random.default_rng(steps + batch + hidden + len(kind) + (gates != 4))
    scale = hidden**-0.5
    x_proj = rng.standard_normal((steps, RNN_GROUPS, batch, gates * hidden)).astype(np.float32)
    w_hh = rng.uniform(-scale, scale, (RNN_GROUPS, hidden, gates * hidden)).astype(np.float32)
    b_hh = rng.uniform(-scale, scale, (RNN_GROUPS, gates * hidden)).astype(np.float32)
    dh = rng.standard_normal((RNN_GROUPS, batch, hidden)).astype(np.float32)
    lengths = {"full": np.full((batch,), steps, np.int32), "none": None,
               "ragged": rng.integers(0, steps + 1, batch).astype(np.int32)}[kind]
    if kind == "ragged":
        lengths[:4] = [0, 1, steps - 1, steps]
    return x_proj, w_hh, b_hh, dh, lengths


@pytest.mark.parametrize("kind", ["full", "ragged", "none"])
@pytest.mark.parametrize(**RNN_CASES)
def test_lstm_cluster_recurrences_3xtf32_hold_the_f32_limit(steps, batch, hidden, kind):
    x_proj, w_hh, b_hh, dh, lengths = (None if a is None else torch.from_numpy(a)
                                       for a in _rnn_case(steps, batch, hidden, kind))
    want = trnn.lstm_train_fwd_plain(x_proj, w_hh, b_hh, lengths)
    want_dz = trnn.lstm_train_bwd_plain(*want[1:], w_hh, lengths, dh)
    errs, rel = {}, {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        got = _lstm_cluster_fwd(x_proj, w_hh, b_hh, lengths, mm)
        errs[name] = max((g - w).abs().max().item() for g, w in zip(got, want))
        dz = _lstm_cluster_bwd(want[1], want[3], w_hh, lengths, dh, mm)
        rel[name] = ((dz - want_dz).abs().max() / want_dz.abs().max()).item()
        if name == "3xTF32":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), w.numpy(), **RNN_VALUE_TOL)
            if lengths is not None:  # nothing past a row's length, exactly
                past = torch.arange(steps)[:, None] >= lengths[None, :]
                for r in (*got[1:], dz):
                    assert torch.all(r.permute(0, 2, 1, 3)[past] == 0)
    print(f"LSTM cluster recurrences, T={steps} G={RNN_GROUPS} B={batch} H={hidden} C={CLUSTER} "
          f"lengths {kind}: forward max abs err 3xTF32 {errs['3xTF32']:.3e}, 1xTF32 "
          f"{errs['1xTF32']:.3e}; backward over the largest magnitude 3xTF32 {rel['3xTF32']:.3e}, "
          f"1xTF32 {rel['1xTF32']:.3e} (limits {RNN_VALUE_TOL}, {GRAD_TOL})")
    assert rel["3xTF32"] < GRAD_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"] and rel["3xTF32"] * 10 < rel["1xTF32"]


@pytest.mark.parametrize("kind", ["full", "ragged", "none"])
@pytest.mark.parametrize(**RNN_CASES)
def test_lstm_cluster_recurrences_3xtf32_match_the_jax_kernels(steps, batch, hidden, kind):
    x_proj, w_hh, b_hh, dh, lengths = _rnn_case(steps, batch, hidden, kind)
    jl = None if lengths is None else jnp.asarray(lengths)
    want, vjp = jax.vjp(lambda x, w, b: jrt.grouped_lstm_trainable(x, w, b, jl),
                        *map(jnp.asarray, (x_proj, w_hh, b_hh)))
    want_grads = vjp(jnp.asarray(dh))
    tl = None if lengths is None else torch.from_numpy(lengths)
    h_t, gates, hprev, cprev = _lstm_cluster_fwd(*map(torch.from_numpy, (x_proj, w_hh, b_hh)),
                                                 tl, _mm3)
    dz = _lstm_cluster_bwd(gates, cprev, torch.from_numpy(w_hh), tl, torch.from_numpy(dh), _mm3)
    # what _LSTMTrainable.backward adds around the kernel: one product, one sum
    grads = (dz, torch.einsum("tgbh,tgbk->ghk", hprev, dz), dz.sum((0, 2)))
    err = np.abs(h_t.numpy() - np.asarray(want)).max()
    print(f"emulated cluster LSTM vs the JAX kernels, T={steps} B={batch} H={hidden} lengths "
          f"{kind}: h_T max abs err {err:.3e}")
    np.testing.assert_allclose(h_t.numpy(), np.asarray(want), **RNN_VALUE_TOL)
    for name, g, w in zip(("x_proj", "w_hh", "b_hh"), grads, want_grads):
        w = np.asarray(w)
        e = np.abs(g.numpy() - w).max() / np.abs(w).max()
        print(f"  d{name}: rel err {e:.3e} (limit {GRAD_TOL})")
        assert e < GRAD_TOL, name


# ------------------------------------------------ GRU training recurrences

def _gru_bwd_columns(hidden, cluster):
    """Each CTA's columns of the GRU backward's product, in the kernel's
    order, as indices into (r, z, n) ``[3H]``: gate q of unit u at column
    q U + u (``csrc/rnn_cluster.cuh`` ``bwd_slots``: 3, no zero column)."""
    units = hidden // cluster
    return [[q * hidden + rank * units + u for q in range(3) for u in range(units)]
            for rank in range(cluster)]


@_one_thread()
def _gru_cluster_fwd(x_proj, w_hh, b_hh, lengths, mm):
    """``gru_train_fwd``'s arithmetic on the cluster body: per step every
    CTA's slots (r, z, h W_hn, a zero column) of h_{t-1} W_hh through ``mm``
    in 32-deep fresh accumulators (a column's sum is the same whichever CTA
    owns it), r and z from (that + x_proj) + b_hh, hn = h W_hn + b_hn inside
    the reset gate, the carry frozen past each length -> ``(h_T, gates,
    hprev, hn)``, residuals zero past each length."""
    steps, groups, batch, _cols = x_proj.shape
    hidden = w_hh.shape[1]
    valid = trnn._valid_steps(steps, lengths, "cpu")
    h = torch.zeros(groups, batch, hidden)
    gates, hprev, hns = [], [], []
    for t in range(steps):
        keep = valid[t] if valid is not None else torch.ones(batch, 1, dtype=torch.bool)
        hr, hz, hh = torch.stack([_mm_chunked(h[g], w_hh[g], mm) for g in range(groups)]).chunk(3, -1)
        xr, xz, xn = x_proj[t].chunk(3, dim=-1)
        br, bz, bn = b_hh[:, None, :].chunk(3, dim=-1)
        r, z = torch.sigmoid(hr + xr + br), torch.sigmoid(hz + xz + bz)
        hn = hh + bn
        n = torch.tanh(xn + r * hn)
        h_new = (1 - z) * n + z * h
        gates.append(torch.where(keep, torch.cat([r, z, n], -1), 0.0))
        hprev.append(torch.where(keep, h, 0.0))
        hns.append(torch.where(keep, hn, 0.0))
        h = torch.where(keep, h_new, h)
    return h, torch.stack(gates), torch.stack(hprev), torch.stack(hns)


@_one_thread()
def _gru_cluster_bwd(gates, hprev, hn, w_hh, lengths, dh_out, mm, cluster=CLUSTER):
    """``gru_train_bwd``'s arithmetic on the cluster body: reverse time, (dr,
    dz, dn) from the residuals; each CTA's partial of dh_{t-1}, the hidden
    path's cotangent (dr, dz, dn r) in its columns (``_gru_bwd_columns``)
    times its W_hh slice transposed through ``mm`` in 32-deep fresh
    accumulators; the partials summed in rank order, then dh z (or a frozen
    row's dh) added -> dx, zero past each length."""
    steps, groups, batch, cols = gates.shape
    hidden = cols // 3
    local = _gru_bwd_columns(hidden, cluster)
    valid = trnn._valid_steps(steps, lengths, "cpu")
    dh = dh_out.clone()
    dx = []
    for t in reversed(range(steps)):
        keep = valid[t] if valid is not None else torch.ones(batch, 1, dtype=torch.bool)
        r, z, n = gates[t].chunk(3, dim=-1)
        dn = dh * (1 - z) * (1 - n * n)
        dr = dn * hn[t] * r * (1 - r)
        dz = dh * (hprev[t] - n) * z * (1 - z)
        dx.append(torch.where(keep, torch.cat([dr, dz, dn], -1), 0.0))
        hid = torch.where(keep, torch.cat([dr, dz, dn * r], -1), 0.0)
        skip = torch.where(keep, dh * z, dh)
        total = None
        for cols_c in local:  # rank order
            part = torch.stack([_mm_chunked(hid[k][:, cols_c], w_hh[k][:, cols_c].t(), mm)
                                for k in range(groups)])
            total = part if total is None else total + part
        dh = total + skip
    return torch.stack(dx[::-1])


@pytest.mark.parametrize("kind", ["full", "ragged", "none"])
@pytest.mark.parametrize(**RNN_CASES)
def test_gru_cluster_recurrences_3xtf32_hold_the_f32_limit(steps, batch, hidden, kind):
    x_proj, w_hh, b_hh, dh, lengths = (None if a is None else torch.from_numpy(a)
                                       for a in _rnn_case(steps, batch, hidden, kind, gates=3))
    want = trnn.gru_train_fwd_plain(x_proj, w_hh, b_hh, lengths)
    want_dx = trnn.gru_train_bwd_plain(*want[1:], w_hh, lengths, dh)
    errs, rel = {}, {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        got = _gru_cluster_fwd(x_proj, w_hh, b_hh, lengths, mm)
        errs[name] = max((g - w).abs().max().item() for g, w in zip(got, want))
        dx = _gru_cluster_bwd(*want[1:], w_hh, lengths, dh, mm)
        rel[name] = ((dx - want_dx).abs().max() / want_dx.abs().max()).item()
        if name == "3xTF32":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), w.numpy(), **RNN_VALUE_TOL)
            if lengths is not None:  # nothing past a row's length, exactly
                past = torch.arange(steps)[:, None] >= lengths[None, :]
                for r in (*got[1:], dx):
                    assert torch.all(r.permute(0, 2, 1, 3)[past] == 0)
                assert torch.all(got[0][:, lengths == 0] == 0)
    print(f"GRU cluster recurrences, T={steps} G={RNN_GROUPS} B={batch} H={hidden} C={CLUSTER} "
          f"lengths {kind}: forward max abs err 3xTF32 {errs['3xTF32']:.3e}, 1xTF32 "
          f"{errs['1xTF32']:.3e}; backward over the largest magnitude 3xTF32 {rel['3xTF32']:.3e}, "
          f"1xTF32 {rel['1xTF32']:.3e} (limits {RNN_VALUE_TOL}, {GRAD_TOL})")
    assert rel["3xTF32"] < GRAD_TOL
    assert errs["3xTF32"] * 10 < errs["1xTF32"] and rel["3xTF32"] * 10 < rel["1xTF32"]


@pytest.mark.parametrize("kind", ["full", "ragged", "none"])
@pytest.mark.parametrize(**RNN_CASES)
def test_gru_cluster_recurrences_3xtf32_match_the_jax_kernels(steps, batch, hidden, kind):
    x_proj, w_hh, b_hh, dh, lengths = _rnn_case(steps, batch, hidden, kind, gates=3)
    jl = None if lengths is None else jnp.asarray(lengths)
    want, vjp = jax.vjp(lambda x, w, b: jrt.grouped_gru_trainable(x, w, b, jl),
                        *map(jnp.asarray, (x_proj, w_hh, b_hh)))
    want_grads = vjp(jnp.asarray(dh))
    tl = None if lengths is None else torch.from_numpy(lengths)
    h_t, gates, hprev, hn = _gru_cluster_fwd(*map(torch.from_numpy, (x_proj, w_hh, b_hh)), tl,
                                             _mm3)
    dx = _gru_cluster_bwd(gates, hprev, hn, torch.from_numpy(w_hh), tl, torch.from_numpy(dh),
                          _mm3)
    # what _GRUTrainable.backward adds around the kernel: the hidden path's
    # cotangent (the candidate slot times r), one product, one sum
    dhp = torch.cat([dx[..., :2 * hidden], dx[..., 2 * hidden:] * gates[..., :hidden]], -1)
    grads = (dx, torch.einsum("tgbh,tgbk->ghk", hprev, dhp), dhp.sum((0, 2)))
    err = np.abs(h_t.numpy() - np.asarray(want)).max()
    print(f"emulated cluster GRU vs the JAX kernels, T={steps} B={batch} H={hidden} lengths "
          f"{kind}: h_T max abs err {err:.3e}")
    np.testing.assert_allclose(h_t.numpy(), np.asarray(want), **RNN_VALUE_TOL)
    for name, g, w in zip(("x_proj", "w_hh", "b_hh"), grads, want_grads):
        w = np.asarray(w)
        e = np.abs(g.numpy() - w).max() / np.abs(w).max()
        print(f"  d{name}: rel err {e:.3e} (limit {GRAD_TOL})")
        assert e < GRAD_TOL, name


# ------------------------------------------------ serving recurrences

FUSED_CASES = dict(argnames="steps,batch,hidden", argvalues=[(22, 5, 32), (64, 20, 64)],
                   ids=["T22-B5-H32", "T64-B20-H64"])
FUSED_FEATS = [1, 17]  # the heart-rate group's raw width, and the IMUs'


def _fused_slots(cell, w_ih, w_hh, b_a, b_b):
    """The cluster body's four gate slots of each unit (``rnn_cluster_fused.cuh``):
    the LSTM's gates; the GRU's (r, z, n_h, n_x), W_hn in slot 2 of W_hh and
    W_in in slot 3 of W_ih, zero columns beside them; the biases as the
    kernel keeps them -> ``(W_hh [G, H, 4H], W_ih [G, D, 4H], bias [G, 4H])``."""
    if cell == "lstm":
        return w_hh, w_ih, b_a
    hidden = w_hh.shape[1]
    zero_h = torch.zeros(*w_hh.shape[:2], hidden)
    zero_x = torch.zeros(*w_ih.shape[:2], hidden)
    return (torch.cat([w_hh, zero_h], -1),
            torch.cat([w_ih[..., :2 * hidden], zero_x, w_ih[..., 2 * hidden:]], -1),
            torch.cat([b_a[:, :2 * hidden] + b_b[:, :2 * hidden], b_b[:, 2 * hidden:],
                       b_a[:, 2 * hidden:]], -1))


def _bmm_chunked(a, b, mm):
    """``a [..., M, K] @ b [..., K, N]`` through ``mm`` in 32-deep fresh
    accumulators, added in order in f32."""
    out = None
    for k0 in range(0, a.shape[-1], CHUNK_K):
        part = mm(a[..., k0:k0 + CHUNK_K], b[..., k0:k0 + CHUNK_K, :])
        out = part if out is None else out + part
    return out


@_one_thread()
def _fused_cluster(cell, x, w_ih, w_hh, b_a, b_b, lengths, mm, cluster=CLUSTER):
    """``grouped_lstm_fused`` / ``grouped_gru_fused`` on the cluster body: each
    CTA's slot columns (``_local_columns``, side by side in one product) of
    z = h_{t-1} W_hh through ``mm`` in 32-deep fresh accumulators, plus the x
    part x_t W_ih over the depth padded with zeros to a multiple of 8 the
    same way (it does not depend on h, so every step's at once), then + the
    bias; the cell on the slots, the carry frozen past each length -> h_T."""
    steps, groups, batch, feat = x.shape
    hidden = w_hh.shape[1]
    whh, wih, bias = _fused_slots(cell, w_ih, w_hh, b_a, b_b)
    depth = -(-feat // 8) * 8
    wih = torch.cat([wih, torch.zeros(groups, depth - feat, 4 * hidden)], 1)
    x = torch.cat([x, torch.zeros(steps, groups, batch, depth - feat)], -1)
    local = torch.tensor([col for cols in _local_columns(hidden, cluster) for col in cols])
    back = torch.argsort(local)
    whh, wih = whh[..., local], wih[..., local]
    x_part = _bmm_chunked(x, wih, mm)
    valid = trnn._valid_steps(steps, lengths, "cpu")
    h = torch.zeros(groups, batch, hidden)
    c = torch.zeros_like(h)
    for t in range(steps):
        keep = valid[t] if valid is not None else torch.ones(batch, 1, dtype=torch.bool)
        z = (_bmm_chunked(h, whh, mm) + x_part[t])[..., back]
        s0, s1, s2, s3 = (z + bias[:, None, :]).chunk(4, dim=-1)
        if cell == "lstm":
            c_new = torch.sigmoid(s1) * c + torch.sigmoid(s0) * torch.tanh(s2)
            h_new = torch.sigmoid(s3) * torch.tanh(c_new)
            c = torch.where(keep, c_new, c)
        else:  # s2 = h W_hn + b_hn, s3 = x W_in + b_in
            r, u = torch.sigmoid(s0), torch.sigmoid(s1)
            h_new = (1 - u) * torch.tanh(s3 + r * s2) + u * h
        h = torch.where(keep, h_new, h)
    return h


@_one_thread()
def _proj_cluster(x_proj, w_hh, b_hh, lengths, mm, rows, cluster=CLUSTER):
    """``grouped_lstm_forward`` on the cluster body (``kXProj``): per tile of
    ``rows`` batch rows (one cluster), to the tile's longest length, each
    CTA's slot columns of z = h_{t-1} W_hh through ``mm`` in 32-deep fresh
    accumulators, + x_proj taken in the same local column order (the
    registers each lane loads), then + b_hh; the cell, the carry frozen past
    each length -> h_T."""
    steps, groups, batch, _ = x_proj.shape
    hidden = w_hh.shape[1]
    local = torch.tensor([col for cols in _local_columns(hidden, cluster) for col in cols])
    back = torch.argsort(local)
    whh, xp = w_hh[..., local], x_proj[..., local]
    lens = (lengths if lengths is not None else torch.full((batch,), steps)).clamp(0, steps)
    out = torch.zeros(groups, batch, hidden)
    for b0 in range(0, batch, rows):
        tile = slice(b0, min(b0 + rows, batch))
        h = torch.zeros(groups, tile.stop - b0, hidden)
        c = torch.zeros_like(h)
        for t in range(int(lens[tile].max())):
            keep = (t < lens[tile])[:, None]
            z = (_bmm_chunked(h, whh, mm) + xp[t, :, tile])[..., back] + b_hh[:, None, :]
            s0, s1, s2, s3 = z.chunk(4, dim=-1)
            c_new = torch.sigmoid(s1) * c + torch.sigmoid(s0) * torch.tanh(s2)
            h = torch.where(keep, torch.sigmoid(s3) * torch.tanh(c_new), h)
            c = torch.where(keep, c_new, c)
        out[:, tile] = h
    return out


def _x_proj(x, w_ih, b_ih):
    """The precomputed projection ``grouped_lstm_forward`` reads, f32."""
    return torch.einsum("tgbd,gdh->tgbh", x, w_ih) + b_ih[None, :, None, :]


def _fused_case(cell, steps, batch, hidden, feat, kind):
    rng = np.random.default_rng(steps + batch + hidden + feat + len(kind) + len(cell))
    gates = 3 if cell == "gru" else 4
    scale = hidden**-0.5
    u = lambda *shape: rng.uniform(-scale, scale, shape).astype(np.float32)  # noqa: E731
    x = rng.standard_normal((steps, RNN_GROUPS, batch, feat)).astype(np.float32)
    w_ih, w_hh = u(RNN_GROUPS, feat, gates * hidden), u(RNN_GROUPS, hidden, gates * hidden)
    b_ih, b_hh = u(RNN_GROUPS, gates * hidden), u(RNN_GROUPS, gates * hidden)
    lengths = {"full": np.full((batch,), steps, np.int32), "none": None,
               "ragged": rng.integers(0, steps + 1, batch).astype(np.int32)}[kind]
    if kind == "ragged":
        lengths[:4] = [0, 1, steps - 1, steps]
    # the fused LSTM kernel takes one bias, b_ih + b_hh; the GRU's both, and
    # the precomputed projection b_ih with b_hh apart
    biases = (b_ih + b_hh, None) if cell == "lstm" else (b_ih, b_hh)
    return x, w_ih, w_hh, biases, lengths


def _fused_plain(cell, x, w_ih, w_hh, biases, lengths):
    if cell == "lstm_proj":
        return trnn.grouped_lstm_forward_plain(_x_proj(x, w_ih, biases[0]), w_hh, biases[1],
                                               lengths)
    if cell == "lstm":
        return trnn.grouped_lstm_fused_plain(x, w_ih, w_hh, biases[0], lengths)
    return trnn.grouped_gru_fused_plain(x, w_ih, w_hh, *biases, lengths)


def _cluster_emulation(cell, x, w_ih, w_hh, biases, lengths, mm, rows=16):
    """The cluster body's arithmetic for ``cell`` (``"lstm_proj"``:
    ``grouped_lstm_forward`` over ``x W_ih + b_ih``, at ``rows`` a cluster)."""
    if cell == "lstm_proj":
        return _proj_cluster(_x_proj(x, w_ih, biases[0]), w_hh, biases[1], lengths, mm, rows)
    return _fused_cluster(cell, x, w_ih, w_hh, *biases, lengths, mm)


@pytest.mark.parametrize("kind", ["full", "ragged", "none"])
@pytest.mark.parametrize("feat", FUSED_FEATS)
@pytest.mark.parametrize(**FUSED_CASES)
@pytest.mark.parametrize("cell", ["lstm", "gru", "lstm_proj"])
def test_fused_cluster_recurrences_3xtf32_hold_the_f32_limit(cell, steps, batch, hidden, feat,
                                                             kind):
    x, w_ih, w_hh, biases, lengths = _fused_case(cell, steps, batch, hidden, feat, kind)
    args = [torch.from_numpy(a) for a in (x, w_ih, w_hh)]
    biases = [None if b is None else torch.from_numpy(b) for b in biases]
    tl = None if lengths is None else torch.from_numpy(lengths)
    want = _fused_plain(cell, *args, biases, tl)
    if cell == "lstm_proj":  # both tilings: a row's arithmetic does not depend on its cluster
        assert torch.equal(_cluster_emulation(cell, *args, biases, tl, _mm3, 16),
                           _cluster_emulation(cell, *args, biases, tl, _mm3, 32))
    errs = {}
    for name, mm in (("3xTF32", _mm3), ("1xTF32", _mm1)):
        got = _cluster_emulation(cell, *args, biases, tl, mm)
        errs[name] = (got - want).abs().max().item()
        if name == "3xTF32":
            np.testing.assert_allclose(got.numpy(), want.numpy(), **RNN_VALUE_TOL)
            if lengths is not None:  # a row of length 0 never leaves the zero state
                assert torch.all(got[:, tl == 0] == 0)
    print(f"{cell} serving cluster body, T={steps} G={RNN_GROUPS} B={batch} H={hidden} D={feat} "
          f"C={CLUSTER} lengths {kind}: max abs err 3xTF32 {errs['3xTF32']:.3e}, 1xTF32 "
          f"{errs['1xTF32']:.3e} (limit {RNN_VALUE_TOL})")
    assert errs["3xTF32"] * 10 < errs["1xTF32"]


@pytest.mark.parametrize("kind", ["full", "ragged", "none"])
@pytest.mark.parametrize("feat", FUSED_FEATS)
@pytest.mark.parametrize(**FUSED_CASES)
@pytest.mark.parametrize("cell", ["lstm", "gru", "lstm_proj"])
def test_fused_cluster_recurrences_3xtf32_match_the_jax_kernels(cell, steps, batch, hidden, feat,
                                                                kind):
    x, w_ih, w_hh, biases, lengths = _fused_case(cell, steps, batch, hidden, feat, kind)
    jl = None if lengths is None else jnp.asarray(lengths)
    tbiases = [None if b is None else torch.from_numpy(b) for b in biases]
    targs = list(map(torch.from_numpy, (x, w_ih, w_hh)))
    if cell == "lstm_proj":
        x_proj = _x_proj(targs[0], targs[1], tbiases[0]).numpy()
        want = np.asarray(jrnn.grouped_lstm_forward(
            jnp.asarray(x_proj), jnp.asarray(w_hh), jnp.asarray(biases[1]), jl, interpret=True))
    else:
        jbiases = [jnp.asarray(b) for b in biases if b is not None]
        jfn = jrnn.grouped_lstm_fused if cell == "lstm" else jrnn.grouped_gru_fused
        want = np.asarray(jfn(*map(jnp.asarray, (x, w_ih, w_hh)), *jbiases, jl, interpret=True))
    got = _cluster_emulation(cell, *targs, tbiases,
                             None if lengths is None else torch.from_numpy(lengths), _mm3).numpy()
    print(f"emulated {cell} serving cluster body vs the JAX kernel, T={steps} B={batch} "
          f"H={hidden} D={feat} lengths {kind}: max abs err {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, **RNN_VALUE_TOL)
