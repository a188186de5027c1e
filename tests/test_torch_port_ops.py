"""PyTorch port, ops layer: masked primitives and the two kernels' plain twins
held against the JAX package on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode (f32), as
``tests/test_pallas.py`` does; the port's wrappers take their plain PyTorch
twins because the tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import masked as jm
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_attention as jpa
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops.pallas_fusion import (
    fused_hybrid_head as jax_fused_hybrid_head,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion as tf
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import masked as tm

# f32 on both sides, same formulas: agreement to a few ulps; 1e-6 where a
# division or exp enters (the task's stated bound for masked.py)
DIV_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- masked.py


def test_nan_to_num_exact():
    x = np.array([1.5, np.nan, np.inf, -np.inf, -2.0, 0.0], np.float32)
    np.testing.assert_array_equal(tm.nan_to_num(_t(x)).numpy(), _np(jm.nan_to_num(jnp.asarray(x))))


MASKS = {
    "all": np.ones((5, 4), np.float32),
    "none": np.zeros((5, 4), np.float32),
    "single": np.tile(np.array([0, 0, 1, 0], np.float32), (5, 1)),
    "mixed": np.array(
        [[1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1], [0, 1, 0, 0], [1, 1, 0, 1]], np.float32
    ),
    "fractional": np.array(
        [[0.5, 0, 1, 0], [0, 0, 0, 0.25], [1, 1, 1, 1], [0, 0, 0, 0], [2, 0, 0, 1]], np.float32
    ),
}


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_masked_softmax_matches(mask_name):
    scores = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32) * 3
    mask = MASKS[mask_name]
    got = tm.masked_softmax(_t(scores), _t(mask)).numpy()
    want = _np(jm.masked_softmax(jnp.asarray(scores), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, **DIV_TOL)
    dead = mask.sum(-1) == 0
    assert np.all(got[dead] == 0.0)  # all-masked rows are exact zeros


def test_masked_softmax_no_mask_and_axis():
    scores = np.random.default_rng(1).standard_normal((3, 6, 2)).astype(np.float32)
    got = tm.masked_softmax(_t(scores), dim=1).numpy()
    want = _np(jm.masked_softmax(jnp.asarray(scores), axis=1))
    np.testing.assert_allclose(got, want, **DIV_TOL)


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_adaptive_gate_weights_matches(mask_name):
    scores = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)
    # row 3 of every mask sees -inf scores: the softmax sums to zero there and
    # the mask-proportional (or, for an empty mask, uniform) fallback engages
    scores[3] = -np.inf
    mask = MASKS[mask_name]
    got = tm.adaptive_gate_weights(_t(scores), _t(mask), 4).numpy()
    want = _np(jm.adaptive_gate_weights(jnp.asarray(scores), jnp.asarray(mask), 4))
    np.testing.assert_allclose(got, want, **DIV_TOL)
    if mask[3].sum() == 0:
        np.testing.assert_array_equal(got[3], np.full(4, 0.25, np.float32))


@pytest.mark.parametrize("fallback", ["uniform", "proportional"])
def test_mask_renormalize_fallbacks(fallback):
    weights = np.array([[0.2, 0, 0.6, 0], [0, 0, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1]], np.float32)
    mask = np.array([[1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 1]], np.float32)
    got = tm.mask_renormalize(_t(weights), _t(mask), 4, fallback=fallback).numpy()
    want = _np(jm.mask_renormalize(jnp.asarray(weights), jnp.asarray(mask), 4, fallback=fallback))
    np.testing.assert_allclose(got, want, **DIV_TOL)


def test_masked_mean_pool_and_lengths_to_mask():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 9, 5)).astype(np.float32)
    lengths = np.array([9, 0, 3, 12], np.int32)
    mask_t = tm.lengths_to_mask(torch.from_numpy(lengths), 9)
    mask_j = jm.lengths_to_mask(jnp.asarray(lengths), 9)
    np.testing.assert_array_equal(mask_t.numpy(), _np(mask_j))
    got = tm.masked_mean_pool(_t(x), mask_t, dim=1, min_denom=1.0).numpy()
    want = _np(jm.masked_mean_pool(jnp.asarray(x), mask_j, axis=1, min_denom=1.0))
    np.testing.assert_allclose(got, want, **DIV_TOL)
    assert np.all(got[1] == 0.0)  # empty mask divides by min_denom=1, not 0
    np.testing.assert_allclose(
        tm.masked_mean_pool(_t(x), None, dim=1).numpy(),
        _np(jm.masked_mean_pool(jnp.asarray(x), None, axis=1)), **DIV_TOL,
    )


def test_neg_inf_constants_stay_apart():
    assert tm.NEG_INF == float("-inf") == jm.NEG_INF
    assert ta.NEG_INF == jpa.NEG_INF == -1e30


# ---------------------------------------------------------- packed attention

# both sides in f32 (interpret mode keeps f32 dots); the sums run in another
# order (torch matmul vs jnp dot), so agreement is to float32 rounding
ATTN_TOL = dict(rtol=1e-5, atol=2e-6)


def _packed_inputs(batch, seq, heads, hd, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, seq, 3 * heads * hd)).astype(np.float32)


@pytest.mark.parametrize(
    "seq,heads,hd,lengths",
    [
        (64, 2, 16, [64, 0, 37, 1]),
        (50, 4, 8, [50, 13, 0, 8]),  # T padded to 56 inside; 13 and 50 not multiples of 8
        (24, 4, 8, None),
        (13, 1, 16, [13, 5, 0, 30]),  # a length past T: every real key valid
    ],
    ids=["T64", "T50-pad", "T24-nolengths", "T13-pad-long"],
)
def test_flash_mha_packed_matches_jax(seq, heads, hd, lengths):
    qkv = _packed_inputs(4, seq, heads, hd, seed=seq)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    lens_t = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    want = _np(jpa.flash_mha_packed(jnp.asarray(qkv), lens_j, num_heads=heads, interpret=True))
    got = ta.flash_mha_packed(_t(qkv), lens_t, num_heads=heads).numpy()
    assert got.shape == (4, seq, heads * hd)
    np.testing.assert_allclose(got, want, **ATTN_TOL)
    if lengths is not None:
        for b, n in enumerate(lengths):
            if n == 0:
                assert np.all(got[b] == 0.0)  # no valid key: exact zeros


def test_packed_attention_lse_matches_jax_kernel():
    """out AND lse of the kernel-level function vs the Pallas forward."""
    heads, hd = 2, 16
    qkv = _packed_inputs(3, 40, heads, hd, seed=5)
    lengths = np.array([40, 0, 21], np.int32)
    out_j, lse_j = jpa._packed_forward(
        jnp.asarray(qkv), jnp.asarray(lengths, jnp.float32).reshape(3, 1),
        num_heads=heads, head_dim=hd, sm_scale=hd**-0.5, interpret=True,
    )
    out_t, lse_t = ta.packed_attention_fwd(_t(qkv), torch.from_numpy(lengths), heads, hd**-0.5)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), **ATTN_TOL)
    np.testing.assert_allclose(lse_t.numpy(), _np(lse_j), **ATTN_TOL)
    assert np.all(lse_t.numpy()[1] == ta.NEG_INF)


def test_packed_attention_wrapper_cpu_takes_twin_without_counting():
    before = ta.packed_attention_fwd.launches
    qkv = torch.from_numpy(_packed_inputs(2, 16, 2, 8, seed=7))
    lengths = torch.tensor([16, 3], dtype=torch.int32)
    out, lse = ta.packed_attention_fwd(qkv, lengths, 2, 8**-0.5)
    ref_out, ref_lse = ta.packed_attention_reference(qkv, lengths, 2, 8**-0.5)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert ta.packed_attention_fwd.launches == before  # only kernel launches count


@pytest.mark.parametrize(
    "shape,heads,match",
    [((2, 8, 10), 2, "3 \\* num_heads"), ((2, 8, 12), 3, "3 \\* num_heads"), ((2, 8), 1, "\\[B, T, 3F\\]")],
)
def test_packed_attention_rejects_bad_shapes(shape, heads, match):
    with pytest.raises(ValueError, match=match):
        ta.packed_attention_fwd(torch.zeros(shape), torch.zeros(2, dtype=torch.int32), heads, 1.0)


def test_packed_route_matches_jax():
    for seq in (1, 8, 505, 512, 513, 1024):
        assert ta.packed_route_ok(seq, 4, 64) == jpa.packed_route_ok(seq, 4, 64)


# ------------------------------------------------------------- fused head

NUM_MOD, HID, NCLS = 4, 32, 25
# f32 on both sides; the twin repeats the Pallas body's operation order
HEAD_TOL = dict(rtol=1e-5, atol=2e-6)


def _head_inputs(batch, seed):
    rng = np.random.default_rng(seed)
    pairs = [(q, k) for q in range(NUM_MOD) for k in range(NUM_MOD) if q != k]
    p = len(pairs)

    def w(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = {
        "projected": np.maximum(w(NUM_MOD, batch, HID, scale=1.0), 0.0),
        "value_kernel": w(p, HID, HID), "value_bias": w(p, HID),
        "out_kernel": w(p, HID, HID), "out_bias": w(p, HID),
        "gate_kernels": w(NUM_MOD, HID), "gate_biases": w(NUM_MOD),
        "w1": w(HID, HID), "b1": w(HID), "w2": w(HID, NCLS), "b2": w(NCLS),
    }
    return arrays, pairs


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_fused_hybrid_head_matches_jax(mask_name):
    batch = 5  # not a multiple of the JAX kernel's 256-row block: padding must not leak
    a, pairs = _head_inputs(batch, seed=11)
    mask = MASKS[mask_name][:batch]
    pair_keys = ("value_kernel", "value_bias", "out_kernel", "out_bias")
    rest = ("gate_kernels", "gate_biases", "w1", "b1", "w2", "b2")
    want = jax_fused_hybrid_head(
        jnp.asarray(a["projected"]), jnp.asarray(mask),
        {k: jnp.asarray(a[k]) for k in pair_keys}, *(jnp.asarray(a[k]) for k in rest),
        pairs, interpret=True,
    )
    got = tf.fused_hybrid_head(
        _t(a["projected"]), _t(mask), {k: _t(a[k]) for k in pair_keys},
        *(_t(a[k]) for k in rest), pairs,
    )
    assert got.shape == (batch, NCLS)
    np.testing.assert_allclose(got.numpy(), _np(want), **HEAD_TOL)


def test_fused_head_wrapper_checks_shapes_and_counts_nothing_on_cpu():
    a, pairs = _head_inputs(3, seed=12)
    pair_keys = ("value_kernel", "value_bias", "out_kernel", "out_bias")
    args = [{k: _t(a[k]) for k in pair_keys}] + [
        _t(a[k]) for k in ("gate_kernels", "gate_biases", "w1", "b1", "w2", "b2")
    ]
    before = tf.fused_hybrid_head.launches
    tf.fused_hybrid_head(_t(a["projected"]), torch.ones(3, NUM_MOD), *args, pairs)
    assert tf.fused_hybrid_head.launches == before
    with pytest.raises(ValueError, match="modality_mask must have shape"):
        tf.fused_hybrid_head(_t(a["projected"]), torch.ones(3, NUM_MOD + 1), *args, pairs)
