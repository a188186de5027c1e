"""PyTorch port under ``mixed_precision`` (the reference's end-to-end bf16),
held against the JAX package on the CPU at hidden 32, T = 24, four streams,
seeded numpy inputs and the same weights (converted both ways).

The JAX model runs with its kernels on in interpret mode, eagerly (op by
op): each bf16 operation then rounds where the program says so. XLA's CPU
compiler, when it jits the whole serving function, drops some of those
roundings (a value rounded to bf16 and read back in f32 is fused away), so
the jitted JAX function differs from its own eager run; the port is held to
the program as written.

The bf16 twins of the packed attention pair (rows 1-2), of both
residual-LN pairs (rows 12-15) and of the feed-forward pair (rows 10-11)
against the JAX kernel functions on bf16 inputs; the product scheme of their
CUDA entries (the packed pair's and both FFW pairs' on wgmma, the
projection pair's one TF32 product for two bf16 operands, a bf16 operand
being exact in TF32) emulated on the CPU against the twins, and on
exact-sum inputs each FFW rounding point shown to matter;
served logits of the four fusion heads with one CNN stream, and of the
grouped transformer; one train-mode loss and every gradient against
``jax.value_and_grad`` at dropout 0, on the default kernel route, the
feed-forward pair's route (``fused_mlp_ln`` off) and the grouped
transformer; the types of parameters and logits; the routes under bf16; a
checkpoint round trip.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import encoders as jenc
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_attention as jpa
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_mlp as jmlp
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops.metrics import (
    cross_entropy_loss as jax_cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.serving import (
    make_serving_fn as jax_serving_fn,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
    from_flax_variables,
    to_flax_tree,
    to_flax_variables,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as tenc
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
    cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
    CheckpointManager,
    load_checkpoint,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config
from test_torch_port_zoo import _load_encoder
from test_torch_port_tf32 import _mm3
from torch_port_schemes import (
    WG_CHUNK_K,
    _ffw_ln_bf16,
    _fused_mlp_bf16,
    _mm_chunked,
    _mm_n,
    _proj_ln_bf16,
    _tf32_cut,
    _tf32_hi,
    bf16_ulps_apart,
    exact_ffw_ln_case,
    exact_fused_mlp_case,
    ffw_ln_scheme_hidden,
)

REPO = Path(__file__).resolve().parent.parent
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
SMALL = ["model.hidden_dim=32", "model.output_dim=16"]
KERNELS_ON = ["model.flash_attention=true", "model.fused_mlp=true", "model.fused_mlp_ln=true"]
PAIR_ROUTE = ["model.fused_mlp_ln=false"]  # the feed-forward pair (rows 10-11) in training
GROUPED = ["model.grouped_transformer=true"]
BF16 = ["mixed_precision=true"]
CNN_STREAM = ["model.encoders.imu_chest.encoder_type=cnn"]
SMOOTHING = 0.05
BF = torch.bfloat16
# a twin's f32 output against the JAX kernel's: the same f32 arithmetic on
# the same bf16 values, the sums in another order
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# a bf16 output, max abs error over the largest magnitude: where the two f32
# sums straddle a rounding boundary the bf16 result differs by one ulp, at
# most 2^-7 of the largest magnitude
BF16_TOL = 1e-2
# the port's bf16 logits against JAX's, norm-wise, as a share of JAX's own
# bf16-vs-f32 gap on the same weights and inputs
GAP_SHARE = 0.25
# one train-mode step at dropout 0: the loss relative; each gradient's max
# abs error over its largest magnitude, floored at 1e-2 of the largest
# gradient (the key biases' gradients are zero up to rounding); the whole
# gradient norm-wise. The forward is JAX's bit for bit; the backward's
# products and sums round in another order, and a bf16 rounding that breaks
# the other way moves its element one ulp through every rounded product after
LOSS_TOL = 1e-5
GRAD_TOL = 5e-2
GRAD_NORM_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's intra-op pool costs more than it saves beside
    other test workers. One thread, the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(value)


def _norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    diff = np.abs(got - want).max()
    return float(diff / scale) if scale > 0 else float(diff)


def _bf16_np(x):
    """f32 numpy values rounded to bf16 (the inputs both sides take)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF).float().numpy()


def _batch(seed=20, batch=4):
    rng = np.random.default_rng(seed)
    feats = {n: rng.standard_normal((batch, 24, d)).astype(np.float32)
             for n, d in zip(NAMES, DIMS)}
    mask = np.ones((batch, 4), np.float32)
    mask[:, NAMES.index("imu_ankle")] = 0.0
    mask[2, :] = [0, 0, 0, 1]
    lengths = np.array([24, 7, 0, 13], np.int32)
    labels = rng.integers(0, 25, batch).astype(np.int32)
    weight = np.array([1, 1, 1, 0], np.float32)  # a padded row
    return feats, mask, lengths, labels, weight


# ---- the kernels' twins against the JAX kernel functions --------------------


def _packed_case(seed, batch=3, seq=24, heads=4, d=8):
    rng = np.random.default_rng(seed)
    qkv = _bf16_np(rng.standard_normal((batch, seq, 3 * heads * d)))
    lengths = np.array([seq, 9, 0][:batch], np.int32)
    dout = _bf16_np(rng.standard_normal((batch, seq, heads * d)))  # a bf16 cotangent
    return qkv, lengths, dout, heads


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_packed_attention_bf16_twins_match_the_jax_kernels(direction):
    """Rows 1-2: the reference's packed pair in interpret mode on a bf16 qkv
    (it casts it to f32: out f32, dqkv the cast's VJP, bf16) against the bf16
    twins, and against PackedAttention, which runs them."""
    qkv, lengths, dout, heads = _packed_case(1)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    j_fn = lambda x: jpa.flash_mha_packed(  # noqa: E731
        x, jnp.asarray(lengths), num_heads=heads, interpret=True)
    j_out, vjp = jax.vjp(j_fn, jq)
    tq = torch.from_numpy(qkv).to(BF)
    tl = torch.from_numpy(lengths)
    scale = (qkv.shape[-1] // 3 // heads) ** -0.5
    out, lse = ta.packed_attention_bf16_reference(tq, tl, heads, scale)
    if direction == "forward":
        assert j_out.dtype == jnp.float32 and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32_TOL)
        return
    (j_dqkv,) = vjp(jnp.asarray(dout))
    got = ta.packed_attention_bwd_bf16_reference(tq, tl, out, lse, torch.from_numpy(dout),
                                                 heads, scale)
    assert j_dqkv.dtype == jnp.bfloat16 and got.dtype == BF
    want = np.asarray(j_dqkv.astype(jnp.float32))
    assert _rel(got.float().numpy(), want) < BF16_TOL
    # the autograd Function on the bf16 entries (their twins here)
    leaf = tq.clone().requires_grad_()
    ta.flash_mha_packed(leaf, tl, num_heads=heads).backward(torch.from_numpy(dout))
    assert leaf.grad.dtype == BF
    assert _rel(leaf.grad.float().numpy(), want) < BF16_TOL


def _ln_case(family, seed, n=40, d=32, f=128, keep=0.8):
    rng = np.random.default_rng(seed)

    def w(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    rmask = (rng.random((n, d)) < keep).astype(np.uint8)
    if family == "proj_ln":
        arrays = [_bf16_np(w(n, d)), _bf16_np(w(n, d)), _bf16_np(w(d, d, s=d**-0.5)),
                  w(d, s=0.1), 1 + w(d, s=0.1), w(d, s=0.1)]
        masks = [rmask]
    else:
        arrays = [_bf16_np(w(n, d)), _bf16_np(w(d, f, s=d**-0.5)), w(f, s=0.1),
                  _bf16_np(w(f, d, s=f**-0.5)), w(d, s=0.1), 1 + w(d, s=0.1), w(d, s=0.1)]
        masks = [(rng.random((n, f)) < keep).astype(np.uint8), rmask]
    return arrays, masks, _bf16_np(w(n, d)), keep


# the bf16 operands of each pair (the rest are f32), as the model passes them
_BF16_ARGS = {"proj_ln": (0, 1, 2), "ffw_ln": (0, 1, 3)}


def _jax_ln(family, arrays, masks, keep):
    args = [jnp.asarray(a).astype(jnp.bfloat16) if i in _BF16_ARGS[family] else jnp.asarray(a)
            for i, a in enumerate(arrays)]
    if family == "proj_ln":
        return (lambda *p: jmlp.fused_proj_residual_ln(
            *p, res_mask=jnp.asarray(masks[0]), keep_prob=keep, interpret=True)), args
    return (lambda *p: jmlp.fused_mlp_residual_ln(
        *p, ffw_mask=jnp.asarray(masks[0]), res_mask=jnp.asarray(masks[1]), keep_prob=keep,
        interpret=True)), args


def _torch_ln(family, arrays, masks):
    return [torch.from_numpy(a).to(BF) if i in _BF16_ARGS[family] else torch.from_numpy(a)
            for i, a in enumerate(arrays)] + [torch.from_numpy(m) for m in masks]


@pytest.mark.parametrize("family", ["proj_ln", "ffw_ln"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_residual_ln_bf16_twins_match_the_jax_kernels(family, direction):
    """Rows 12-15: the reference's residual-LN kernels in interpret mode on
    bf16 x, attention output and weights (their compute type is x's) against
    the bf16 twins: the output and dx, da, dW in bf16, the rest f32."""
    arrays, masks, dout, keep = _ln_case(family, 3)
    fn, jargs = _jax_ln(family, arrays, masks, keep)
    j_out, vjp = jax.vjp(fn, *jargs)
    targs = _torch_ln(family, arrays, masks)
    inv_keep = tm._inv_keep(keep)
    if direction == "forward":
        out = getattr(tm, f"{family}_fwd_bf16")(*targs, inv_keep, 1e-6)
        assert out.dtype == BF and j_out.dtype == jnp.bfloat16
        assert _rel(out.float().numpy(), np.asarray(j_out.astype(jnp.float32))) < BF16_TOL
        return
    j_grads = vjp(jnp.asarray(dout).astype(jnp.bfloat16))
    grads = getattr(tm, f"{family}_bwd_bf16")(*targs, torch.from_numpy(dout).to(BF), inv_keep,
                                              1e-6)
    # the wrapper's order (proj: dx, da, dwo, dbo, dgamma, dbeta; ffw: dx,
    # dw1, db1, dw2, db2, dgamma, dbeta) is the argument order of both
    assert len(grads) == len(arrays)
    # every output within one bf16 rounding of its largest magnitude: the f32
    # sums (db1 over dpre) take bf16-rounded values too
    for i, (got, want) in enumerate(zip(grads, j_grads)):
        bf16 = i in _BF16_ARGS[family]
        assert got.dtype == (BF if bf16 else torch.float32)
        assert want.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
        assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < BF16_TOL, i


# ---- the CUDA entries' product scheme, emulated -------------------------------


def test_bf16_operands_drop_only_zero_terms():
    """A bf16 value is exact in TF32 (hi alone, lo zero), so dropping its lo
    terms leaves mma3's sum as it is: one product for two bf16 operands, two
    for a bf16 and an f32 one, the same bits as three on f32 copies."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    b = torch.from_numpy(_bf16_np(rng.standard_normal((64, 8))))
    ab = torch.from_numpy(_bf16_np(a.numpy()))
    assert torch.equal(_tf32_hi(b), b) and not torch.any(_tf32_cut(b - _tf32_hi(b)))
    assert torch.equal(_mm_n(a, b, True, False), _mm3(a, b))
    assert torch.equal(_mm_n(ab, b, False, False), _mm3(ab, b))
    # two bf16 operands multiply exactly in f32: the product is the f32 product
    assert torch.equal(_mm_n(ab, b, False, False), ab @ b)


P_TERMS = 3  # bf16 terms of P in the packed forward's P.V (wgmma_bf16.cuh kPTerms)


def _mm_k16(a, b):
    """Two bf16 operands on wgmma: exact products summed in f32 a k16 step
    (one instruction), the steps added in order."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 16):
        out = out + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return out


def _bf16_terms(p, terms):
    """p as ``terms`` bf16 values, largest first: hi = bf16(p), lo = bf16(p - hi), ..."""
    out, rest = [], p
    for _ in range(terms):
        out.append(rest.to(BF).float())
        rest = rest - out[-1]
    return out


def _packed_fwd_bf16(qkv, lengths, heads, scale, terms=P_TERMS, tile=64):
    """``packed_attention_fwd_bf16``'s arithmetic on wgmma: s = q k^T (exact
    bf16 products summed in f32 a k16 step), an online softmax over 64-key
    tiles in base 2 on the unscaled scores (p = 2^(s c - m c), c = scale
    log2 e), P split into ``terms`` bf16 terms, each term's P.V exact
    products a k16 step, a tile's terms (smallest first) in a fresh
    accumulator added to O in f32."""
    batch, seq, three_f = qkv.shape
    d = three_f // 3 // heads
    x = qkv.float().reshape(batch, seq, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = (x[i].reshape(batch * heads, seq, d) for i in range(3))
    lens = lengths.long().repeat_interleave(heads)[:, None, None]
    c2 = scale * math.log2(math.e)
    m = torch.full((batch * heads, seq, 1), -torch.inf)
    l, o = torch.zeros(batch * heads, seq, 1), torch.zeros_like(q)
    for k0 in range(0, seq, tile):
        keys = slice(k0, min(k0 + tile, seq))
        active = k0 < lens
        s = _mm_k16(q, k[:, keys].transpose(1, 2))
        s = torch.where(torch.arange(k0, keys.stop)[None, None, :] < lens, s, -torch.inf)
        m_new = torch.where(active, torch.maximum(m, s.amax(-1, keepdim=True)), m)
        rescale = torch.where(active, torch.exp2(m * c2 - m_new * c2), 1.0)
        p = torch.where(active, torch.exp2(s * c2 - m_new * c2), 0.0)
        l, o = l * rescale + p.sum(-1, keepdim=True), o * rescale
        part = torch.zeros_like(o)
        for term in reversed(_bf16_terms(p, terms)):
            part = part + _mm_k16(term, v[:, keys])
        o, m = o + part, m_new
    out = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return out.reshape(batch, heads, seq, d).transpose(1, 2).reshape(batch, seq, heads * d)


BWD_TERMS = 3  # bf16 terms of dout, P and dS in the packed backward (wgmma_attention_bwd.cuh)
# dqkv's share of entries the bf16 entry may round to another bf16 value than
# the f32 sums do (each within one bf16 step, bf16_steps_from)
GATE_SHARE = 1e-3


def _k16_steps(acc, a, b):
    """acc + a @ b as wgmma accumulates two bf16 operands: exact products
    summed in f32 a k16 step (one instruction) at a time."""
    for k0 in range(0, a.shape[-1], 16):
        acc = acc + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return acc


def _terms_product(a_terms, b_terms, order):
    """(sum of a's terms) @ (sum of b's) as the kernel takes it: the pairs
    of terms (i, j) with i + j < ``order``, the largest i + j first, in one
    fresh accumulator."""
    acc = 0.0
    for total in reversed(range(order)):
        for j in range(total + 1):
            if total - j < len(a_terms) and j < len(b_terms):
                acc = _k16_steps(acc, a_terms[total - j], b_terms[j])
    return acc


def _packed_bwd_bf16(qkv, lengths, out, lse, dout, heads, scale, terms=BWD_TERMS, tile=64):
    """``packed_attention_bwd_bf16``'s f32 sums on wgmma, before their
    rounding: dout split into ``terms`` bf16 planes, S = q k^T and dP = dout
    v^T (the planes smallest first) a k16 step at a time; P = 2^(s scale
    log2 e - lse log2 e) and dS in f32,
    each split into ``terms`` bf16 terms; dv = P^T dout (the term pairs of
    order below ``terms``) and dk = dS^T q a query tile at a time, dq = dS k
    a key tile at a time in key-tile order, each tile's terms in a fresh
    accumulator added in f32; sm_scale on dq and dk last."""
    batch, seq, three_f = qkv.shape
    d = three_f // 3 // heads
    x = qkv.float().reshape(batch, seq, 3, heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    do = dout.reshape(batch, seq, heads, d).transpose(1, 2)
    o = out.reshape(batch, seq, heads, d).transpose(1, 2)
    lse_q = lse.transpose(1, 2)[..., None]
    delta = (do * o).sum(-1, keepdim=True)
    key_ok = (torch.arange(seq)[None, :] < lengths.long()[:, None])[:, None, None, :]
    keep = key_ok & (lse_q > ta.NEG_INF / 2)
    s = _k16_steps(0.0, q, k.transpose(-1, -2))
    log2e = math.log2(math.e)
    p = torch.where(keep, torch.exp2(s * (scale * log2e) - lse_q.clamp(min=ta.NEG_INF / 2) * log2e),
                    0.0)
    planes = _bf16_terms(do, terms)
    dp = 0.0
    for plane in reversed(planes):
        dp = _k16_steps(dp, plane, v.transpose(-1, -2))
    ds = p * (dp - delta)
    pt, dst, dss = (_bf16_terms(t, terms) for t in (p.transpose(-1, -2), ds.transpose(-1, -2), ds))
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for t0 in range(0, seq, tile):
        rows = slice(t0, t0 + tile)
        dv = dv + _terms_product([t[..., rows] for t in pt], [t[..., rows, :] for t in planes],
                                 terms)
        dk = dk + _terms_product([t[..., rows] for t in dst], [q[..., rows, :]], terms)
        dq = dq + _terms_product([t[..., rows] for t in dss], [k[..., rows, :]], terms)
    dqkv = torch.stack([dq * scale, dk * scale, dv], dim=2)
    return dqkv.permute(0, 3, 2, 1, 4).reshape(batch, seq, three_f)


def _bwd_gate(got, f32_sums):
    """(most bf16 steps from the f32 sums rounded, share of entries off them)"""
    steps = ta.bf16_steps_from(got, f32_sums)
    return steps.max().item(), (steps >= 0.5).float().mean().item()


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_packed_attention_bf16_scheme_holds_the_twins(d):
    """The packed pair's bf16 entries, emulated, against their twins: the
    forward at f32's limit, against the twin and the reference's packed
    forward in interpret mode; the backward's bf16 dqkv within one rounding
    of the twin's and of the reference's packed backward in interpret mode,
    and within one bf16 step of the f32 sums rounded in all but at most
    GATE_SHARE of its entries (the gate the card test holds the entry to)."""
    qkv, lengths, dout, heads = _packed_case(7, batch=3, seq=72, d=d)
    lengths = np.array([72, 37, 0], np.int32)
    tq, tl = torch.from_numpy(qkv).to(BF), torch.from_numpy(lengths)
    scale = d**-0.5
    out, lse = ta.packed_attention_bf16_reference(tq, tl, heads, scale)
    emu = _packed_fwd_bf16(tq, tl, heads, scale)
    np.testing.assert_allclose(emu.numpy(), out.numpy(), rtol=1e-5, atol=1e-5)
    j_fn = lambda x: jpa.flash_mha_packed(  # noqa: E731
        x, jnp.asarray(lengths), num_heads=heads, interpret=True)
    j_out, vjp = jax.vjp(j_fn, jnp.asarray(qkv).astype(jnp.bfloat16))
    np.testing.assert_allclose(emu.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    td = torch.from_numpy(dout)
    got = _packed_bwd_bf16(tq, tl, out, lse, td, heads, scale).to(BF)
    want = ta.packed_attention_bwd_bf16_reference(tq, tl, out, lse, td, heads, scale)
    assert _rel(got.float().numpy(), want.float().numpy()) < BF16_TOL
    (j_dqkv,) = vjp(jnp.asarray(dout))
    assert _rel(got.float().numpy(), np.asarray(j_dqkv.astype(jnp.float32))) < BF16_TOL
    steps, share = _bwd_gate(got, ta.packed_attention_bwd_reference(tq.float(), tl, out, lse, td,
                                                                    heads, scale))
    assert steps <= 1 and share <= GATE_SHARE, (steps, share)


def test_packed_attention_bf16_p_needs_more_than_one_bf16_term():
    """P rounded to bf16 once (the TPU kernel's MXU operand) misses f32's
    1e-5 against the twin by two orders; the entry's three bf16 terms meet
    it (two reach half of it on a 5-key row at T 512)."""
    qkv, _lengths, _dout, heads = _packed_case(9, batch=3, seq=72, d=64)
    tq, tl = torch.from_numpy(qkv).to(BF), torch.tensor([72, 37, 5], dtype=torch.int32)
    out, _lse = ta.packed_attention_bf16_reference(tq, tl, heads, 64**-0.5)

    def err_over_tol(terms):
        emu = _packed_fwd_bf16(tq, tl, heads, 64**-0.5, terms=terms)
        return ((emu - out).abs() / (1e-5 + 1e-5 * out.abs())).max().item()

    assert err_over_tol(1) > 10
    assert err_over_tol(P_TERMS) < 0.25


@pytest.mark.parametrize("cotangent", ["bf16", "f32"])
def test_packed_attention_bf16_backward_needs_three_bf16_terms(cotangent):
    """The backward's gate: dqkv within one bf16 step of the f32 sums
    rounded, in all but GATE_SHARE of its entries. With one bf16 term for
    each f32 operand (dout, P, dS) the emulation misses it by orders; with
    three it meets it, on a bf16 cotangent (the model's: one plane) and on
    an f32 one (three)."""
    g = torch.Generator().manual_seed(13)
    heads, d, seq = 2, 64, 256
    tl = torch.tensor([seq, 37, 1, 0, 65], dtype=torch.int32)  # one valid key: dS is noise
    tq = torch.randn(len(tl), seq, 3 * heads * d, generator=g).to(BF)
    out, lse = ta.packed_attention_bf16_reference(tq, tl, heads, d**-0.5)
    dout = torch.randn(out.shape, generator=g)
    if cotangent == "bf16":
        dout = dout.to(BF).float()
    f32 = ta.packed_attention_bwd_reference(tq.float(), tl, out, lse, dout, heads, d**-0.5)

    def gate(terms):
        return _bwd_gate(_packed_bwd_bf16(tq, tl, out, lse, dout, heads, d**-0.5,
                                          terms=terms).to(BF), f32)

    one, three = gate(1), gate(BWD_TERMS)
    assert one[0] > 100 and one[1] > 100 * GATE_SHARE, one
    assert three[0] <= 1 and three[1] <= GATE_SHARE, three


@pytest.mark.parametrize("cotangent", ["bf16", "f32"])
def test_packed_attention_bf16_step_floor_is_what_the_f32_sums_need(cotangent):
    """The gate's step floor (2^-10 of the call's largest dq, dk or dv): the
    f32 backward itself, against the same backward in f64, lies more than
    one bf16 step of an entry's own magnitude from it, on the row with one
    valid key (dq and dk cancel to zero: dS is rounding noise) and on rows
    with more; under the floor it meets the gate, and so does the emulated
    bf16 entry."""
    g = torch.Generator().manual_seed(13)
    heads, d, seq = 2, 64, 256
    tl = torch.tensor([seq, 37, 1, 0, 65], dtype=torch.int32)
    tq = torch.randn(len(tl), seq, 3 * heads * d, generator=g).to(BF)
    out, lse = ta.packed_attention_bf16_reference(tq, tl, heads, d**-0.5)
    dout = torch.randn(out.shape, generator=g)
    if cotangent == "bf16":
        dout = dout.to(BF).float()
    f32 = ta.packed_attention_bwd_reference(tq.float(), tl, out, lse, dout, heads, d**-0.5)
    f64 = ta.packed_attention_bwd_reference(tq, tl, out, lse, dout, heads, d**-0.5,
                                            dtype=torch.float64)
    own = ta.bf16_steps_from(f32.to(BF), f64, floor=0.0).reshape(len(tl), seq, 3, heads, d)
    assert own[2, :, :2].max() > 1  # the one-key row's dq, dk
    assert own[[0, 1, 4]].max() > 1
    floored = ta.bf16_steps_from(f32.to(BF), f64)
    assert floored.max() <= 1 and (floored >= 0.5).float().mean() <= GATE_SHARE
    emu = _packed_bwd_bf16(tq, tl, out, lse, dout, heads, d**-0.5).to(BF)
    steps, share = _bwd_gate(emu, f64)
    assert steps <= 1 and share <= GATE_SHARE, (steps, share)


@pytest.mark.parametrize("family", ["proj_ln", "ffw_ln"])
def test_residual_ln_bf16_scheme_holds_the_twins(family):
    """Both residual-LN pairs' bf16 entries, emulated (every product of two
    bf16 operands: the projection's one TF32 pass a k-step in 32-deep
    chunks, every FFW product on wgmma in 64-deep chunks or one sum over k =
    D; the roundings of the reference's kernels), against their twins
    within one bf16 rounding of each output's largest magnitude."""
    arrays, masks, dout, keep = _ln_case(family, 11, n=200, d=32, f=128)
    targs = _torch_ln(family, arrays, masks)
    inv_keep = tm._inv_keep(keep)
    f32 = [t.float() if t.dtype == BF else t for t in targs]
    emulate = _proj_ln_bf16 if family == "proj_ln" else _ffw_ln_bf16
    out, grads = emulate(*f32, torch.from_numpy(dout), inv_keep, 1e-6)
    want_out = getattr(tm, f"{family}_fwd_bf16_reference")(*targs, inv_keep, 1e-6)
    assert _rel(out.numpy(), want_out.float().numpy()) < BF16_TOL
    want = getattr(tm, f"{family}_bwd_bf16_reference")(*targs, torch.from_numpy(dout).to(BF),
                                                      inv_keep, 1e-6)
    assert WG_CHUNK_K == 64  # the bf16 FFW products' wgmma chunks
    for i, (got, ref) in enumerate(zip(grads, want)):
        assert _rel(got.numpy(), ref.float().numpy()) < BF16_TOL, i


def test_ffw_ln_bf16_rounding_points_each_move_the_exact_case():
    """On the inputs the card test holds the FFW bf16 entries to (every sum
    before a rounding point exact in f32), the twins are the scheme: equal in
    all but at most 1e-3 of the rounded outputs' entries, each within one
    bf16 step; leaving out the hidden's, dy's or dpre's rounding moves a
    quarter or more of the entries of every output it feeds."""
    args, dout, inv_keep = exact_ffw_ln_case()
    f32 = [t.float() if t.dtype == BF else t for t in args]
    out_s, grads_s = _ffw_ln_bf16(*f32, dout.float(), inv_keep, 1e-6)
    want = [t.to(BF) for t in (out_s, grads_s[0], grads_s[1], grads_s[3])]
    hidden = ffw_ln_scheme_hidden(args[0], args[1], args[2], args[7], inv_keep)
    assert torch.equal(hidden.float(), torch.relu(f32[0] @ f32[1] + f32[2]).mul(
        args[7] * inv_keep).to(BF).float())  # exact before the rounding, in any order
    twin_out = tm.ffw_ln_fwd_bf16_reference(*args, inv_keep, 1e-6)
    twin = tm.ffw_ln_bwd_bf16_reference(*args, dout, inv_keep, 1e-6)
    for a, b in zip((twin_out, twin[0], twin[1], twin[3]), want):
        apart = bf16_ulps_apart(a, b)
        assert apart.max() <= 1 and (apart > 0).float().mean() <= 1e-3
    for skip, moved in (("hidden", (0, 1, 2, 3)), ("dy", (1, 2, 3)), ("dpre", (1, 2))):
        out_v, grads_v = _ffw_ln_bf16(*f32, dout.float(), inv_keep, 1e-6, skip=(skip,))
        variant = [t.to(BF) for t in (out_v, grads_v[0], grads_v[1], grads_v[3])]
        for i in moved:
            assert (variant[i] != want[i]).float().mean() > 0.25, (skip, i)


def test_ffw_ln_bf16_forward_and_backward_take_one_y():
    """The FFW residual-LN bf16 forward and its backward compute y = hd W2
    on one wgmma body (``wgmma_ffw.cuh``'s ``wg_y_rows``, 64-deep fresh
    chunks), so in their scheme the forward's y and the backward's are one
    tensor bit for bit and the backward normalises with the forward's xhat.
    The seeded inputs are not exact sums: the forward's former product (one
    TF32 pass a k-step in 32-deep chunks) gives y other bits on them."""
    arrays, masks, dout, keep = _ln_case("ffw_ln", 29, n=200, d=64, f=256)
    targs = _torch_ln("ffw_ln", arrays, masks)
    f32 = [t.float() if t.dtype == BF else t for t in targs]
    inv_keep = tm._inv_keep(keep)
    ys = []
    _ffw_ln_bf16(*f32, torch.from_numpy(dout), inv_keep, 1e-6, ys=ys)
    y_fwd, y_bwd = ys
    assert torch.equal(y_fwd, y_bwd)
    hd = ffw_ln_scheme_hidden(targs[0], targs[1], targs[2], targs[7], inv_keep).float()
    one_tf32_pass = _mm_chunked(hd, f32[3], lambda p, q: _mm_n(p, q, False, False))
    assert not torch.equal(one_tf32_pass, y_fwd)


def _mlp_case(seed, n=40, d=32, f=128, keep=0.8):
    """(x, w1, b1, w2, b2) as bf16 values in f32 (the biases f32), the keep
    mask and a bf16 cotangent."""
    arrays, masks, dout, keep = _ln_case("ffw_ln", seed, n=n, d=d, f=f, keep=keep)
    return arrays[:5], masks[0], dout, keep


def _torch_mlp(arrays, mask):
    return ([torch.from_numpy(a).to(BF) if i in _BF16_ARGS["ffw_ln"] else torch.from_numpy(a)
             for i, a in enumerate(arrays)] + [torch.from_numpy(mask)])


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_fused_mlp_bf16_twins_match_the_jax_kernels(direction):
    """Rows 10-11: the reference's feed-forward pair in interpret mode,
    eagerly, on bf16 x, w1 and w2 (its compute type is x's: the hidden
    rounded before W2's and dW2's products, dpre before dW1's and dx's)
    against the bf16 twins: out, dx, dW1, dW2 bf16, db1 f32."""
    arrays, mask, dout, keep = _mlp_case(21)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) if i in _BF16_ARGS["ffw_ln"] else jnp.asarray(a)
             for i, a in enumerate(arrays)]
    fn = lambda *p: jmlp.fused_mlp(*p, jnp.asarray(mask), keep, interpret=True)  # noqa: E731
    with jax.disable_jit():
        j_out, vjp = jax.vjp(fn, *jargs)
        j_grads = vjp(jnp.asarray(dout).astype(jnp.bfloat16))
    x, w1, b1, w2, b2, tmask = _torch_mlp(arrays, mask)
    inv_keep = tm._inv_keep(keep)
    if direction == "forward":
        out = tm.fused_mlp_fwd_bf16(x, w1, b1, w2, b2, tmask, inv_keep)
        assert out.dtype == BF and j_out.dtype == jnp.bfloat16
        # the same roundings on the same values: the same bits
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(j_out.astype(jnp.float32)))
        return
    grads = tm.fused_mlp_bwd_bf16(x, w1, b1, w2, tmask, torch.from_numpy(dout).to(BF), inv_keep)
    # the wrapper's dx, dw1, db1, dw2 against the reference's cotangents of x, w1, b1, w2
    for i, (got, want) in enumerate(zip(grads, j_grads[:4])):
        bf16 = i in _BF16_ARGS["ffw_ln"]
        assert got.dtype == (BF if bf16 else torch.float32)
        assert want.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
        want = np.asarray(want.astype(jnp.float32))
        if bf16:  # every product on the same rounded operands, each sum exact in f32 here
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:  # db1: the same f32 values summed in another order
            np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_fused_mlp_bf16_scheme_holds_the_twins():
    """The feed-forward pair's bf16 entries, emulated (every product on
    wgmma, in one sum over k = D or 64-deep chunks over d_ff and the rows;
    the hidden and dpre rounded), against their twins within one bf16
    rounding of each output's largest magnitude."""
    arrays, mask, dout, keep = _mlp_case(23, n=200)
    x, w1, b1, w2, b2, tmask = _torch_mlp(arrays, mask)
    inv_keep = tm._inv_keep(keep)
    tdout = torch.from_numpy(dout)
    out, grads = _fused_mlp_bf16(x.float(), w1.float(), b1, w2.float(), b2, tmask, tdout,
                                 inv_keep)
    want_out = tm.fused_mlp_fwd_bf16_reference(x, w1, b1, w2, b2, tmask, inv_keep)
    assert _rel(out.numpy(), want_out.float().numpy()) < BF16_TOL
    want = tm.fused_mlp_bwd_bf16_reference(x, w1, b1, w2, tmask, tdout.to(BF), inv_keep)
    for i, (got, ref) in enumerate(zip(grads, want)):
        assert _rel(got.numpy(), ref.float().numpy()) < BF16_TOL, i


def test_fused_mlp_bf16_rounding_points_each_move_the_exact_case():
    """On the inputs the card test holds the feed-forward bf16 entries to
    (every sum before a rounding point exact in f32), the twins are the
    scheme within one bf16 step in at most 1e-3 of the entries; leaving out
    the forward's rounding of the hidden, the backward's before dW2, or
    dpre's, moves a quarter or more of the entries of every output it
    feeds."""
    args, dout, inv_keep = exact_fused_mlp_case()
    x, w1, b1, w2, b2, mask = args
    f32 = [t.float() if t.dtype == BF else t for t in args]
    out_s, grads_s = _fused_mlp_bf16(*f32, dout.float(), inv_keep)
    want = [t.to(BF) for t in (out_s, grads_s[0], grads_s[1], grads_s[3])]
    twin_out = tm.fused_mlp_fwd_bf16_reference(*args, inv_keep)
    twin = tm.fused_mlp_bwd_bf16_reference(x, w1, b1, w2, mask, dout, inv_keep)
    for a, b in zip((twin_out, twin[0], twin[1], twin[3]), want):
        apart = bf16_ulps_apart(a, b)
        assert apart.max() <= 1 and (apart > 0).float().mean() <= 1e-3
    for skip, moved in (("hidden", (0,)), ("hd", (3,)), ("dpre", (1, 2))):
        out_v, grads_v = _fused_mlp_bf16(*f32, dout.float(), inv_keep, skip=(skip,))
        variant = [t.to(BF) for t in (out_v, grads_v[0], grads_v[1], grads_v[3])]
        for i in moved:
            assert (variant[i] != want[i]).float().mean() > 0.25, (skip, i)


# ---- the model against JAX ----------------------------------------------------


def _configs(fusion, extra=()):
    base = SMALL + KERNELS_ON + CNN_STREAM + [f"model.fusion_type={fusion}", *extra]
    return (load_config(REPO / "config" / "base.yaml", base + BF16),
            jax_load_config(REPO / "config" / "base.yaml", base + BF16),
            jax_load_config(REPO / "config" / "base.yaml", base))


@pytest.mark.parametrize("fusion", ["early", "late", "hybrid", "uncertainty"])
def test_served_bf16_logits_match_jax(fusion):
    """The served logits of the mixed_precision model (one CNN stream, the
    other three transformers) against the JAX package's serving function on
    the same weights, eager: within a quarter of JAX's own bf16-vs-f32 gap.
    The hybrid head serves through its f32 kernel on both sides."""
    tcfg, jcfg, jcfg32 = _configs(fusion)
    port = MultimodalFusionModel.from_config(tcfg, device="cpu",
                                             generator=torch.Generator().manual_seed(9))
    variables = to_flax_variables(port)
    feats, mask, lengths, _labels, _weight = _batch()
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    jargs = (jf, jnp.asarray(mask), jnp.asarray(lengths))
    with jax.disable_jit():
        want = np.asarray(jax_serving_fn(JaxModel.from_config(jcfg), variables,
                                         interpret=True)(*jargs))
    want32 = np.asarray(jax_serving_fn(JaxModel.from_config(jcfg32), variables,
                                       interpret=True)(*jargs))
    got = make_serving_fn(port, device="cpu")(
        {n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
        torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err, gap = _norm_err(got.numpy(), want), _norm_err(want, want32)
    print(f"{fusion}: port vs JAX bf16 {err:.3e}, JAX bf16 vs f32 {gap:.3e}")
    assert err <= GAP_SHARE * gap
    if fusion == "hybrid":  # the jitted serving function, for the record: not the program's roundings
        jitted = np.asarray(jax_serving_fn(JaxModel.from_config(jcfg), variables,
                                           interpret=True)(*jargs))
        print(f"{fusion}: JAX bf16 jitted vs eager {_norm_err(jitted, want):.3e}, port vs "
              f"jitted {_norm_err(got.numpy(), jitted):.3e}")


def _jax_train(extra, seed):
    """(flax variables, loss, grads) of the JAX mixed_precision model in train
    mode at dropout 0, kernels on (interpret mode), hybrid head, with the
    overrides ``extra``; the loss and its gradient jitted, at a fifth of the
    eager run's time. The jitted loss is the eager one bit for bit; the
    jitted gradient's backward rounds otherwise than the eager one (XLA fuses
    some of its bf16 roundings away), by about as much as the port's does:
    the tolerances hold both."""
    overrides = SMALL + KERNELS_ON + BF16 + ["model.dropout=0", *extra]
    tcfg = load_config(REPO / "config" / "base.yaml", overrides)
    port = MultimodalFusionModel.from_config(tcfg, device="cpu",
                                             generator=torch.Generator().manual_seed(seed))
    variables = to_flax_variables(port)
    jmodel = JaxModel.from_config(jax_load_config(REPO / "config" / "base.yaml", overrides))
    feats, mask, lengths, labels, weight = _batch()
    jf = {n: jnp.asarray(v) for n, v in feats.items()}

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, jf, jnp.asarray(mask), jnp.asarray(lengths),
                              train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        assert logits.dtype == jnp.float32
        return jax_cross_entropy_loss(logits, jnp.asarray(labels), SMOOTHING,
                                      sample_weight=jnp.asarray(weight))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return variables, float(loss), dict(_flat(grads))


@pytest.fixture(scope="module")
def jax_train_reference():
    return _jax_train([], 4)


def _port_train_step_matches(extra, variables, want_loss, want):
    cfg = load_config(REPO / "config" / "base.yaml",
                      SMALL + KERNELS_ON + BF16 + ["model.dropout=0", *extra])
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    feats, mask, lengths, labels, weight = _batch()
    logits = model({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                   torch.from_numpy(lengths), train=True,
                   generator=torch.Generator().manual_seed(0))
    assert logits.dtype == torch.float32
    loss = cross_entropy_loss(logits, torch.from_numpy(labels), SMOOTHING,
                              sample_weight=torch.from_numpy(weight))
    loss.backward()
    assert loss.item() == pytest.approx(want_loss, rel=LOSS_TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    got = dict(_flat(to_flax_tree(grads)))
    assert sorted(got) == sorted(want)  # every parameter has its gradient
    floor = 1e-2 * max(np.abs(w).max() for w in want.values())
    errs = {n: np.abs(got[n] - w).max() / max(np.abs(w).max(), floor) for n, w in want.items()}
    whole = _norm_err(np.concatenate([got[n].ravel() for n in want]),
                      np.concatenate([w.ravel() for w in want.values()]))
    worst = max(errs, key=errs.get)
    print(f"{extra}: loss {loss.item():.7f} vs {want_loss:.7f}; worst gradient {worst} "
          f"{errs[worst]:.3e}; the whole gradient norm-wise {whole:.3e}")
    assert errs[worst] < GRAD_TOL, worst
    assert whole < GRAD_NORM_TOL
    return model


def test_train_loss_and_every_gradient_match_jax(jax_train_reference):
    _port_train_step_matches([], *jax_train_reference)


@pytest.mark.parametrize("route", ["fused_mlp_pair", "grouped"])
def test_bf16_routes_train_like_jax(route):
    """One train step at dropout 0 on the feed-forward pair's route (its bf16
    twins in the port, the reference's kernels in interpret mode) and on the
    grouped transformer, at the default route's limits."""
    extra = PAIR_ROUTE if route == "fused_mlp_pair" else GROUPED
    model = _port_train_step_matches(extra, *_jax_train(extra, 6))
    if route == "grouped":
        assert model.grouped_tf_encoder.dtype == BF and len(model.grouped_tf_names) == 4


def test_grouped_transformer_bf16_serves_like_jax():
    """The served logits of the grouped transformer under mixed_precision
    against the JAX package's serving function on the same weights, eager:
    within a quarter of JAX's own bf16-vs-f32 gap, as the ungrouped heads."""
    base = SMALL + KERNELS_ON + GROUPED
    port = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", base + BF16), device="cpu",
        generator=torch.Generator().manual_seed(8))
    assert port.grouped_tf_encoder.dtype == BF
    variables = to_flax_variables(port)
    feats, mask, lengths, _labels, _weight = _batch()
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    jargs = (jf, jnp.asarray(mask), jnp.asarray(lengths))
    with jax.disable_jit():
        want = np.asarray(jax_serving_fn(JaxModel.from_config(jax_load_config(
            REPO / "config" / "base.yaml", base + BF16)), variables, interpret=True)(*jargs))
    want32 = np.asarray(jax_serving_fn(JaxModel.from_config(jax_load_config(
        REPO / "config" / "base.yaml", base)), variables, interpret=True)(*jargs))
    got = make_serving_fn(port, device="cpu")(
        {n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
        torch.from_numpy(lengths))
    err, gap = _norm_err(got.numpy(), want), _norm_err(want, want32)
    print(f"grouped: port vs JAX bf16 {err:.3e}, JAX bf16 vs f32 {gap:.3e}")
    assert err <= GAP_SHARE * gap


# ---- types, routes, refusals, checkpoints ---------------------------------------


@pytest.mark.parametrize("preset", [None, "early_fusion", "late_fusion", "hybrid_fusion",
                                    "uncertainty_fusion"])
def test_params_are_f32_and_logits_f32(preset):
    """base.yaml and the four presets of config/fusion_strategies.yaml build
    under mixed_precision with f32 parameters; the encoders and the head
    compute in bf16, the logits come back f32."""
    if preset is None:
        cfg = load_config(REPO / "config" / "base.yaml", SMALL + BF16)
    else:
        cfg = load_config(REPO / "config" / "fusion_strategies.yaml",
                          [f"preset={preset}", *SMALL, *BF16])
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    assert model.mixed_precision and model.fusion_model.dtype == BF
    assert all(enc.dtype == BF for enc in model.encoders.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    feats, mask, lengths, _labels, _weight = _batch()
    with torch.no_grad():
        logits = model({n: torch.from_numpy(v) for n, v in feats.items()},
                       torch.from_numpy(mask), torch.from_numpy(lengths))
        encoded = model.encode({n: torch.from_numpy(v) for n, v in feats.items()},
                               torch.from_numpy(lengths))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    # the per-modality LayerNorm promotes the bf16 embeddings to f32, as flax's
    assert all(e.dtype == torch.float32 for e in encoded.values())


def test_a_per_encoder_dtype_is_taken_and_checked():
    cfg = load_config(REPO / "config" / "base.yaml",
                      SMALL + ["model.encoders.imu_hand.dtype=bfloat16"])
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    assert model.encoders["imu_hand"].dtype == BF and model.encoders["imu_chest"].dtype is None
    assert model.fusion_model.dtype is None
    # under mixed_precision an encoder's own float32 wins over the default
    cfg = load_config(REPO / "config" / "base.yaml",
                      SMALL + BF16 + ["model.encoders.imu_hand.dtype=float32"])
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    assert model.encoders["imu_hand"].dtype is None and model.encoders["imu_chest"].dtype == BF
    cfg = load_config(REPO / "config" / "base.yaml",
                      SMALL + ["model.encoders.imu_hand.dtype=float16"])
    with pytest.raises(ValueError, match="dtype"):
        MultimodalFusionModel.from_config(cfg, device="cpu")


@pytest.mark.parametrize("kind", ["frame", "mlp"])
def test_frame_and_mlp_encoders_in_bf16_match_jax(kind):
    """FrameEncoder (attention pooling over a masked row) and
    SimpleMLPEncoder (flax's bf16 Dense and BatchNorm) at dtype bfloat16
    against the JAX package's on the same weights, eager, in eval and in
    train mode at dropout 0 (the batch's own statistics): the same bits."""
    rng = np.random.default_rng(13)
    if kind == "frame":
        jmod = jenc.FrameEncoder(hidden_dim=32, output_dim=16, dropout=0.0, dtype=jnp.bfloat16)
        x = rng.standard_normal((4, 10, 6)).astype(np.float32)
        mask = (np.arange(10)[None, :] < np.array([10, 3, 0, 7])[:, None]).astype(np.float32)
        targs, jargs = (torch.from_numpy(x), torch.from_numpy(mask)), (jnp.asarray(x),
                                                                       jnp.asarray(mask))
        port = tenc.FrameEncoder(6, 32, 16, dropout=0.0, dtype="bfloat16")
    else:
        jmod = jenc.SimpleMLPEncoder(hidden_dim=32, output_dim=16, dropout=0.0,
                                     dtype=jnp.bfloat16)
        x = (rng.standard_normal((8, 6)) * 2 + 1).astype(np.float32)
        targs, jargs = (torch.from_numpy(x),), (jnp.asarray(x),)
        port = tenc.SimpleMLPEncoder(6, 32, 16, dropout=0.0, dtype="bfloat16")
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(13), *jargs))
    _load_encoder(port, variables)
    for train in (False, True):
        with torch.no_grad():
            got = port(*targs, train=train)
        with jax.disable_jit():
            want = (jmod.apply(variables, *jargs, train=True, mutable=["batch_stats"])[0]
                    if train and kind == "mlp" else jmod.apply(variables, *jargs, train=train))
        assert got.dtype == BF and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_routes_under_bf16_and_their_refusals():
    # an entry's inputs of another type raise, whatever the entry
    x = torch.zeros(4, 32)
    tm._check_kernel_inputs({"x": x, "rmask": torch.zeros(4, 32, dtype=torch.uint8)}, 32)
    with pytest.raises(TypeError, match="bfloat16"):
        tm._check_kernel_inputs({"x": x}, 32, tm._PROJ_BF16)
    with pytest.raises(TypeError, match="float32"):
        tm._check_kernel_inputs({"x": x.to(BF)}, 32)
    # the model: the fused_mlp pair trains through its bf16 entries (their
    # twins here), eval stays plain; the grouped transformer takes bf16
    feats, mask, lengths, _labels, _weight = _batch()
    tf = {n: torch.from_numpy(v) for n, v in feats.items()}
    model = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", SMALL + BF16 + PAIR_ROUTE), device="cpu")
    with torch.no_grad():
        assert model(tf, None, torch.from_numpy(lengths)).dtype == torch.float32  # eval: plain
    before = (tm.fused_mlp_fwd_bf16.launches, tm.fused_mlp_bwd_bf16.launches)
    logits = model(tf, None, torch.from_numpy(lengths), train=True,
                   generator=torch.Generator().manual_seed(0))
    logits.sum().backward()
    assert torch.isfinite(logits).all()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    # on the CPU the wrappers take their twins: no launch
    assert (tm.fused_mlp_fwd_bf16.launches, tm.fused_mlp_bwd_bf16.launches) == before
    grouped = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", SMALL + BF16 + GROUPED), device="cpu")
    assert grouped.grouped_tf_encoder.dtype == BF and not grouped.encoders
    with torch.no_grad():
        assert grouped(tf, None, torch.from_numpy(lengths)).dtype == torch.float32


def test_flash_routes_take_f32_copies_of_bf16_operands():
    """Past the packed route the attention runs the f32 kernels on f32 copies
    of bf16 q, k, v: the same out as f32 inputs of those values, and the
    gradients come back in bf16 (the VJP of the cast), as the reference's
    interpret path does."""
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(_bf16_np(rng.standard_normal((2, 4, 40, 8)))).to(BF)
               for _ in range(3))
    lengths = torch.tensor([40, 11], dtype=torch.int32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ta.flash_self_attention(*leaves, lengths, block_q=16, block_k=16)
    want = ta.flash_self_attention(q.float(), k.float(), v.float(), lengths, block_q=16,
                                   block_k=16)
    assert out.dtype == torch.float32 and torch.equal(out, want)
    out.sum().backward()
    assert all(t.grad.dtype == BF for t in leaves)


def test_a_checkpoint_reloads_the_bf16_model_bit_for_bit(tmp_path):
    cfg = load_config(REPO / "config" / "base.yaml", SMALL + BF16 + CNN_STREAM)
    model = MultimodalFusionModel.from_config(cfg, device="cpu",
                                              generator=torch.Generator().manual_seed(3))
    saved = CheckpointManager(tmp_path, config=cfg, save_top_k=1).save(
        model.state_dict(), epoch=0, score=1.0)
    weights, ckpt_cfg, _meta = load_checkpoint(saved)
    assert bool(ckpt_cfg.mixed_precision)
    reloaded = MultimodalFusionModel.from_config(ckpt_cfg, device="cpu")
    reloaded.load_state_dict(weights)
    assert reloaded.mixed_precision
    feats, mask, lengths, _labels, _weight = _batch()
    args = ({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
            torch.from_numpy(lengths))
    with torch.no_grad():
        assert torch.equal(model(*args), reloaded(*args))
    # the flax tree is f32 either way: the converter needs no dtype
    tree = to_flax_variables(reloaded)
    assert all(v.dtype == np.float32 for _n, v in _flat(tree))
    state = reloaded.state_dict()
    assert all(torch.equal(v, state[k]) for k, v in from_flax_variables(tree).items())
