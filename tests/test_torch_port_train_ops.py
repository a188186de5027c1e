"""PyTorch port, training ops: the attention backward, the two fused
residual-LayerNorm functions (values and every gradient) and the metrics,
held against the JAX package on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode (f32), as its own
tests do; the port's wrappers take their plain twins, and its autograd
Functions their plain backward twins, because the tensors lie on the CPU.
Shapes stay small (N <= 256 rows, d_ff <= 64, T <= 24): interpret mode is slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import metrics as jmetrics
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_attention as jpa
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_mlp as jmlp
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import metrics as tmetrics
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm

# f32 on both sides, same formulas; products and row sums round in another
# order, and the weight gradients sum over up to 200 rows
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.requires_grad_() if grad else t


# ------------------------------------------------------------- attention


@pytest.mark.parametrize(
    "seq,heads,hd,lengths",
    [
        (24, 2, 8, [24, 0, 5, 17]),  # length 0; 5 and 17 not multiples of 8
        (13, 2, 8, [13, 6, 0, 1]),  # T padded to 16 inside
        (16, 1, 16, None),
    ],
    ids=["T24", "T13-pad", "T16-nolengths"],
)
def test_flash_mha_packed_grads_match_jax(seq, heads, hd, lengths):
    rng = np.random.default_rng(seq)
    qkv = rng.standard_normal((4, seq, 3 * heads * hd)).astype(np.float32)
    cot = rng.standard_normal((4, seq, heads * hd)).astype(np.float32)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)

    def loss(q):
        out = jpa.flash_mha_packed(q, lens_j, num_heads=heads, interpret=True)
        return jnp.sum(out * cot), out

    (_, want_out), want_grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(qkv))
    x = _t(qkv, grad=True)
    lens_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = ta.flash_mha_packed(x, lens_t, num_heads=heads)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)
    if lengths is not None:
        for b, n in enumerate(lengths):
            if n == 0:
                assert torch.all(x.grad[b] == 0)  # no valid key: no gradient at all


def test_packed_attention_bwd_twin_matches_jax_kernel():
    """The backward twin against the Pallas backward kernel itself."""
    heads, hd, seq = 2, 8, 24
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((3, seq, 3 * heads * hd)).astype(np.float32)
    dout = rng.standard_normal((3, seq, heads * hd)).astype(np.float32)
    lengths = np.array([24, 0, 9], np.int32)
    len_b = jnp.asarray(lengths, jnp.float32).reshape(3, 1)
    kw = dict(num_heads=heads, head_dim=hd, sm_scale=hd**-0.5, interpret=True)
    out, lse = jpa._packed_forward(jnp.asarray(qkv), len_b, **kw)
    want = jpa._packed_backward(jnp.asarray(qkv), len_b, out, lse, jnp.asarray(dout), **kw)
    got = ta.packed_attention_bwd(_t(qkv), torch.from_numpy(lengths), _t(out), _t(lse),
                                  _t(dout), heads, hd**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    feat = heads * hd
    assert torch.all(got[2, 9:, feat:] == 0)  # keys past the length: exact zero dk, dv
    assert torch.all(got[2, 9:, :feat] != 0)  # queries past it still get dq


# ------------------------------------------------ fused residual LayerNorm


def _mask(rng, shape, keep):
    return (rng.random(shape) < keep).astype(np.uint8)


LN_CASES = [(200, 0.8), (200, None), (200, 0.0), (37, 0.8)]
LN_IDS = ["keep0.8", "nomask", "keep0", "N37"]


def _value_and_grads_jax(fn, args, cot):
    def loss(*a):
        out = fn(*a)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(len(args))), has_aux=True)(
        *[jnp.asarray(a) for a in args]
    )
    return np.asarray(out), [np.asarray(g) for g in grads]


def _value_and_grads_port(fn, args, cot):
    tensors = [_t(a, grad=True) for a in args]
    out = fn(*tensors)
    (out * _t(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in tensors]


@pytest.mark.parametrize("n,keep", LN_CASES, ids=LN_IDS)
def test_fused_proj_residual_ln_matches_jax(n, keep):
    d = 32
    rng = np.random.default_rng(n)
    f32 = np.float32
    args = [rng.standard_normal((n, d)).astype(f32), rng.standard_normal((n, d)).astype(f32),
            (rng.standard_normal((d, d)) * d**-0.5).astype(f32),
            (0.1 * rng.standard_normal(d)).astype(f32),
            (1 + 0.1 * rng.standard_normal(d)).astype(f32),
            (0.1 * rng.standard_normal(d)).astype(f32)]
    cot = rng.standard_normal((n, d)).astype(f32)
    rmask = None if keep is None else _mask(rng, (n, d), keep)
    kp = 1.0 if keep is None else keep
    want_out, want_grads = _value_and_grads_jax(
        lambda *a: jmlp.fused_proj_residual_ln(
            *a, res_mask=None if rmask is None else jnp.asarray(rmask), keep_prob=kp,
            interpret=True),
        args, cot)
    got_out, got_grads = _value_and_grads_port(
        lambda *a: tm.fused_proj_residual_ln(
            *a, res_mask=None if rmask is None else torch.from_numpy(rmask), keep_prob=kp),
        args, cot)
    assert np.all(np.isfinite(got_out))
    np.testing.assert_allclose(got_out, want_out, **TOL)
    for name, got, want in zip(("x", "a", "wo", "bo", "gamma", "beta"), got_grads, want_grads):
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    if keep == 0.0:  # all-drop: the projection gets exact-zero gradients
        assert all(np.all(g == 0) for g in got_grads[1:4])


@pytest.mark.parametrize("n,keep", LN_CASES, ids=LN_IDS)
def test_fused_mlp_residual_ln_matches_jax(n, keep):
    d, f = 32, 64
    rng = np.random.default_rng(100 + n)
    f32 = np.float32
    args = [rng.standard_normal((n, d)).astype(f32),
            (rng.standard_normal((d, f)) * d**-0.5).astype(f32),
            (0.1 * rng.standard_normal(f)).astype(f32),
            (rng.standard_normal((f, d)) * f**-0.5).astype(f32),
            (0.1 * rng.standard_normal(d)).astype(f32),
            (1 + 0.1 * rng.standard_normal(d)).astype(f32),
            (0.1 * rng.standard_normal(d)).astype(f32)]
    cot = rng.standard_normal((n, d)).astype(f32)
    fmask = rmask = None
    if keep is not None:
        fmask, rmask = _mask(rng, (n, f), keep), _mask(rng, (n, d), keep)
    kp = 1.0 if keep is None else keep

    def as_j(m):
        return None if m is None else jnp.asarray(m)

    def as_t(m):
        return None if m is None else torch.from_numpy(m)

    want_out, want_grads = _value_and_grads_jax(
        lambda *a: jmlp.fused_mlp_residual_ln(*a, as_j(fmask), as_j(rmask), kp, interpret=True),
        args, cot)
    got_out, got_grads = _value_and_grads_port(
        lambda *a: tm.fused_mlp_residual_ln(*a, as_t(fmask), as_t(rmask), kp), args, cot)
    assert np.all(np.isfinite(got_out))
    np.testing.assert_allclose(got_out, want_out, **TOL)
    names = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")
    for name, got, want in zip(names, got_grads, want_grads):
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    if keep == 0.0:  # all-drop: the FFW gets exact-zero gradients
        assert all(np.all(g == 0) for g in got_grads[1:5])


def test_inv_keep_matches_jax():
    for keep in (1.0, 0.8, 0.5, 0.0, -0.1):
        assert tm._inv_keep(keep) == jmlp._inv_keep(keep)


def test_ln_wrappers_reject_bad_shapes():
    x = torch.zeros(8, 32)
    v = torch.zeros(32)
    with pytest.raises(ValueError, match="wo must have shape"):
        tm.proj_ln_fwd(x, x, torch.zeros(32, 16), v, v, v, None, 1.0, 1e-6)
    with pytest.raises(ValueError, match="fmask must have shape"):
        tm.ffw_ln_fwd(x, torch.zeros(32, 64), torch.zeros(64), torch.zeros(64, 32), v, v, v,
                      torch.zeros(8, 32, dtype=torch.uint8), None, 1.0, 1e-6)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("smoothing", [0.0, 0.05])
@pytest.mark.parametrize("weights", ["none", "mixed", "zeros"])
def test_cross_entropy_loss_matches_jax(smoothing, weights):
    rng = np.random.default_rng(7)
    logits = (3 * rng.standard_normal((6, 25))).astype(np.float32)
    labels = rng.integers(0, 25, 6).astype(np.int32)
    w = {"none": None, "mixed": np.array([1, 0, 1, 1, 0, 1], np.float32),
         "zeros": np.zeros(6, np.float32)}[weights]
    want = jmetrics.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), smoothing,
        sample_weight=None if w is None else jnp.asarray(w))
    got = tmetrics.cross_entropy_loss(
        _t(logits), torch.from_numpy(labels), smoothing,
        sample_weight=None if w is None else _t(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    if weights == "zeros":
        assert got.item() == 0.0  # sum of weights clipped to 1: no NaN


def test_classification_and_calibration_metrics_match_jax():
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 6, 200)
    preds = np.where(rng.random(200) < 0.6, labels, rng.integers(0, 7, 200))
    conf = rng.random(200)
    conf[:3] = [1.0, 0.0, 1 / 15]  # bin edges, incl. the right-closed last bin
    logits = rng.standard_normal((200, 7)).astype(np.float32)
    assert tmetrics.accuracy(preds, labels) == jmetrics.accuracy(preds, labels)
    assert tmetrics.macro_f1(labels, preds) == pytest.approx(jmetrics.macro_f1(labels, preds), abs=1e-12)
    for name in ("expected_calibration_error", "maximum_calibration_error"):
        got = getattr(tmetrics, name)(conf, preds, labels, num_bins=15)
        want = getattr(jmetrics, name)(conf, preds, labels, num_bins=15)
        assert got == pytest.approx(want, abs=1e-12), name
    assert tmetrics.negative_log_likelihood(logits, labels) == pytest.approx(
        jmetrics.negative_log_likelihood(logits, labels), rel=1e-6)
    assert tmetrics.macro_f1(np.array([]), np.array([])) == 0.0
    assert tmetrics.expected_calibration_error(np.array([]), np.array([]), np.array([])) == 0.0
    assert tmetrics.maximum_calibration_error(np.array([]), np.array([]), np.array([])) == 0.0
