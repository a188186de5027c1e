"""PyTorch port, training ops: the attention backward, the fused feed-forward
and the two fused residual-LayerNorm functions (values and every gradient)
and the metrics, held against the JAX package on the same numpy inputs; the
dropout-mask generator's plain version against Philox's published vectors
and its own contract (the JAX generator needs a TPU and has other bits).

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


# ------------------------------------------------------- fused feed-forward


@pytest.mark.parametrize("n,keep", LN_CASES, ids=LN_IDS)
def test_fused_mlp_matches_jax(n, keep):
    """Value and all five gradients against the JAX ``fused_mlp`` kernel pair
    in interpret mode."""
    d, f = 32, 64
    rng = np.random.default_rng(200 + n)
    f32 = np.float32
    args = [rng.standard_normal((n, d)).astype(f32),
            (rng.standard_normal((d, f)) * d**-0.5).astype(f32),
            (0.1 * rng.standard_normal(f)).astype(f32),
            (rng.standard_normal((f, d)) * f**-0.5).astype(f32),
            (0.1 * rng.standard_normal(d)).astype(f32)]
    cot = rng.standard_normal((n, d)).astype(f32)
    mask = None if keep is None else _mask(rng, (n, f), keep)
    kp = 1.0 if keep is None else keep
    want_out, want_grads = _value_and_grads_jax(
        lambda *a: jmlp.fused_mlp(*a, None if mask is None else jnp.asarray(mask), kp,
                                  interpret=True), args, cot)
    got_out, got_grads = _value_and_grads_port(
        lambda *a: tm.fused_mlp(*a, None if mask is None else torch.from_numpy(mask), kp),
        args, cot)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    for name, got, want in zip(("x", "w1", "b1", "w2", "b2"), got_grads, want_grads):
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    if keep == 0.0:  # all-drop: the hidden is exactly zero, the output is b2
        np.testing.assert_array_equal(got_out, np.broadcast_to(args[4], got_out.shape))
        assert all(np.all(g == 0) for g in got_grads[:4])


@pytest.mark.parametrize("use_fused", [True, False], ids=["kernel", "plain"])
def test_transformer_ffw_matches_jax(use_fused):
    rng = np.random.default_rng(31)
    d, f = 32, 64
    x = rng.standard_normal((3, 8, d)).astype(np.float32)
    p1 = {"kernel": (rng.standard_normal((d, f)) * d**-0.5).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(f)).astype(np.float32)}
    p2 = {"kernel": (rng.standard_normal((f, d)) * f**-0.5).astype(np.float32),
          "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    mask = _mask(rng, (3, 8, f), 0.8)
    want = jmlp.transformer_ffw(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p1.items()},
        {k: jnp.asarray(v) for k, v in p2.items()}, jnp.asarray(mask), 0.8,
        use_fused=use_fused, interpret=True)
    got = tm.transformer_ffw(
        _t(x), {k: _t(v) for k, v in p1.items()}, {k: _t(v) for k, v in p2.items()},
        torch.from_numpy(mask), 0.8, use_fused=use_fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_as_mask_copies_no_u8_or_bool_mask():
    u8 = torch.ones(6, 4, dtype=torch.uint8)
    assert tm._as_mask(u8, 6).data_ptr() == u8.data_ptr()
    assert tm._as_mask(u8.reshape(2, 3, 4), 6).data_ptr() == u8.data_ptr()
    flags = torch.ones(6, 4, dtype=torch.bool)
    as_u8 = tm._as_mask(flags, 6)
    assert as_u8.dtype == torch.uint8 and as_u8.data_ptr() == flags.data_ptr()
    assert tm._as_mask(None, 6) is None


# --------------------------------------------------- dropout mask generator


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox4x32_10_known_answers(counter, key, want):
    """The published known-answer vectors of Philox4x32-10 (Random123)."""
    got = tm.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(w) for w in got) == want


def test_dropout_keep_mask_plain_version_semantics():
    seed = torch.tensor([1234, -5678], dtype=torch.int32)
    keep, rows, cols = 0.8, 500, 64
    masks = {p: tm.dropout_keep_mask(seed, rows, cols, keep, p)
             for p in (tm.RNG_P_HIDDEN, tm.RNG_P_RES, tm.RNG_P_ATT)}
    for mask in masks.values():
        assert mask.dtype == torch.uint8 and mask.shape == (rows, cols)
        assert set(mask.unique().tolist()) <= {0, 1}
        # Bernoulli(0.8) over 32,000 draws: within 4 sigma
        assert abs(mask.float().mean().item() - keep) < 4 * (keep * (1 - keep) / mask.numel()) ** 0.5
    # deterministic per (seed, purpose, shape); differs by purpose and by either seed word
    assert torch.equal(masks[tm.RNG_P_ATT], tm.dropout_keep_mask(seed.clone(), rows, cols, keep,
                                                                tm.RNG_P_ATT))
    assert not torch.equal(masks[tm.RNG_P_ATT], masks[tm.RNG_P_RES])
    assert not torch.equal(masks[tm.RNG_P_HIDDEN], masks[tm.RNG_P_RES])
    for other in ([1235, -5678], [1234, -5677]):
        assert not torch.equal(masks[tm.RNG_P_HIDDEN], tm.dropout_keep_mask(
            torch.tensor(other, dtype=torch.int32), rows, cols, keep))
    # the stream depends on the element index alone, not on the row width
    assert torch.equal(masks[tm.RNG_P_HIDDEN].reshape(-1),
                       tm.dropout_keep_mask(seed, cols, rows, keep).reshape(-1))
    # a size that is not a multiple of 4 is a prefix of the stream
    odd = tm.dropout_keep_mask(seed, 7, 3, keep)
    assert torch.equal(odd.reshape(-1), masks[tm.RNG_P_HIDDEN].reshape(-1)[:21])


def test_dropout_keep_mask_edge_keeps_and_threshold():
    seed = torch.tensor([7, 9], dtype=torch.int32)
    assert torch.all(tm.dropout_keep_mask(seed, 33, 5, 1.0) == 1)
    assert torch.all(tm.dropout_keep_mask(seed, 33, 5, 0.0) == 0)
    assert tm.dropout_keep_mask(seed, 0, 5, 0.8).shape == (0, 5)
    for keep in (0.0, 0.3, 0.8, 1.0, 1.5):
        assert tm._keep_thr(keep) == jmlp._keep_thr(keep)
    assert (tm.RNG_P_HIDDEN, tm.RNG_P_RES, tm.RNG_P_ATT) == (
        jmlp._RNG_P_HIDDEN, jmlp._RNG_P_RES, jmlp._RNG_P_ATT)
    # the compare is unsigned: at keep 0.9 the words above 2^31 mostly survive
    assert abs(tm.dropout_keep_mask(seed, 1000, 40, 0.9).float().mean().item() - 0.9) < 0.01
    with pytest.raises(TypeError, match="int32"):
        tm.dropout_keep_mask(seed.long(), 4, 4, 0.8)


def test_kernel_rng_seed_draws_two_words_from_the_generator():
    a = tm.kernel_rng_seed(torch.Generator().manual_seed(5), "cpu")
    b = tm.kernel_rng_seed(torch.Generator().manual_seed(5), "cpu")
    c = tm.kernel_rng_seed(torch.Generator().manual_seed(6), "cpu")
    assert a.dtype == torch.int32 and a.shape == (2,)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("rows,specs,keep", [
    (96, [(32, tm.RNG_P_ATT), (2048, tm.RNG_P_HIDDEN), (32, tm.RNG_P_RES)], 0.8),
    (1021, [(7, tm.RNG_P_HIDDEN), (3, tm.RNG_P_RES), (5, tm.RNG_P_ATT)], 0.8),
    (33, [(5, tm.RNG_P_RES), (64, tm.RNG_P_ATT)], 1.0),
    (33, [(9, tm.RNG_P_HIDDEN)], 0.0),
    (0, [(32, tm.RNG_P_ATT), (64, tm.RNG_P_HIDDEN), (32, tm.RNG_P_RES)], 0.8),
], ids=["layer", "ragged", "keep1", "keep0", "empty"])
def test_dropout_keep_masks_equal_one_call_per_mask(rows, specs, keep):
    """A layer's masks in one launch are, byte for byte, the masks one
    ``dropout_keep_mask_reference`` call per purpose gives."""
    seed = torch.tensor([-99, 2**31 - 1], dtype=torch.int32)
    got = tm.dropout_keep_masks(seed, rows, specs, keep)
    assert len(got) == len(specs)
    for mask, (cols, purpose) in zip(got, specs):
        want = tm.dropout_keep_mask_reference(seed, rows, cols, keep, purpose)
        assert mask.dtype == torch.uint8 and mask.shape == (rows, cols)
        assert torch.equal(mask, want)
    assert all(torch.equal(a, b) for a, b in zip(
        got, tm.dropout_keep_masks_reference(seed, rows, specs, keep)))


def test_dropout_keep_masks_rejects_what_it_does_not_take():
    seed = torch.tensor([7, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="between 1 and 3 masks"):
        tm.dropout_keep_masks(seed, 4, [(4, tm.RNG_P_ATT)] * 4, 0.8)
    with pytest.raises(ValueError, match="between 1 and 3 masks"):
        tm.dropout_keep_masks(seed, 4, [], 0.8)
    with pytest.raises(TypeError, match="int32"):
        tm.dropout_keep_masks(seed.long(), 4, [(4, tm.RNG_P_ATT)], 0.8)
