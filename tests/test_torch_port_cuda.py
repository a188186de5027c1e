"""PyTorch port on the card: each CUDA kernel against its plain twin, with
its launch counter. Skipped without a CUDA device; on a
machine with one (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py -q
"""

from pathlib import Path

import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion as tf
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import rnn as tr
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.device import pin_float32
from torch_port_schemes import (
    _ffw_ln_bf16,
    _fused_mlp_bf16,
    bf16_ulps_apart,
    exact_ffw_ln_case,
    exact_fused_mlp_case,
    ffw_ln_scheme_hidden,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    pin_float32()  # no TF32 in products or convolutions: the plain twins in full f32
    return torch.device("cuda")


@pytest.mark.parametrize("seq,hd", [(72, 64), (512, 64), (40, 16), (24, 128)])
def test_packed_attention_kernel_matches_twin(card, seq, hd):
    g = torch.Generator().manual_seed(seq)
    heads = 4
    qkv = torch.randn(4, seq, 3 * heads * hd, generator=g).to(card)
    lengths = torch.tensor([0, seq, 37 % seq, seq - 7], dtype=torch.int32, device=card)
    before = ta.packed_attention_fwd.launches
    out, lse = ta.packed_attention_fwd(qkv, lengths, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert ta.packed_attention_fwd.launches == before + 1
    ref_out, ref_lse = ta.packed_attention_reference(qkv, lengths, heads, hd**-0.5)
    # f32 both; the kernel's online softmax sums over 64-key tiles
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.all(out[0] == 0) and torch.all(lse[0] == ta.NEG_INF)


@pytest.mark.parametrize("hd", [16, 32, 128])
def test_packed_attention_kernel_takes_every_head_dim_at_edge_lengths(card, hd):
    # padded T = 72 (not a multiple of the 64-row tile), lengths on every tile edge
    seq, heads = 72, 4
    g = torch.Generator().manual_seed(hd)
    lens = [0, 1, 37, 64, 65, seq - 1, seq]
    qkv = torch.randn(len(lens), seq, 3 * heads * hd, generator=g).to(card)
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    out, lse = ta.packed_attention_fwd(qkv, lengths, heads, hd**-0.5)
    torch.cuda.synchronize()
    ref_out, ref_lse = ta.packed_attention_reference(qkv, lengths, heads, hd**-0.5)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.all(out[0] == 0) and torch.all(lse[0] == ta.NEG_INF)


def test_packed_attention_kernel_rejects_what_it_does_not_take(card):
    qkv = torch.zeros(2, 8, 3 * 4 * 8, device=card)  # head_dim 8
    lengths = torch.full((2,), 8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ta.packed_attention_fwd(qkv, lengths, 4, 1.0)
    with pytest.raises(TypeError, match="int32"):
        ta.packed_attention_fwd(torch.zeros(2, 8, 3 * 64, device=card), lengths.long(), 1, 1.0)


def _head_case(card, batch, num_mod=4, hidden=256, ncls=25):
    """Head inputs (by default at full width: M = 4, P = 12, H = 256, C = 25)
    on the card, the first rows' masks at the edges: no modality (the uniform
    fallback), one, two."""
    g = torch.Generator().manual_seed(batch)
    pairs = [(q, k) for q in range(num_mod) for k in range(num_mod) if q != k]
    p = len(pairs)

    def w(*shape, scale=0.06):
        return (torch.randn(*shape, generator=g) * scale).to(card)

    projected = torch.relu(w(num_mod, batch, hidden, scale=1.0))
    mask = (torch.rand(batch, num_mod, generator=g) > 0.4).float()
    edges = torch.zeros(3, num_mod)
    edges[1, -1] = edges[2, 0] = edges[2, 2] = 1.0
    mask[:3] = edges[:batch]
    pair_params = {"value_kernel": w(p, hidden, hidden), "value_bias": w(p, hidden),
                   "out_kernel": w(p, hidden, hidden), "out_bias": w(p, hidden)}
    rest = (w(num_mod, hidden), w(num_mod), w(hidden, hidden), w(hidden),
            w(hidden, ncls), w(ncls))
    return projected, mask.to(card), pair_params, rest, pairs


@pytest.mark.parametrize("batch", [1, 5, 64, 130])
def test_fused_head_kernel_matches_twin(card, batch):
    # 130: three 64-row tiles, the last one ragged
    projected, mask, pair_params, rest, pairs = _head_case(card, batch)
    before = tf.fused_hybrid_head.launches
    got = tf.fused_hybrid_head(projected, mask, pair_params, *rest, pairs)
    torch.cuda.synchronize()
    assert tf.fused_hybrid_head.launches == before + 1
    want = tf.fused_hybrid_head_reference(projected, mask, pair_params, *rest, pairs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_mod,hidden,ncls", [(4, 640, 25), (3, 256, 300), (6, 1500, 7)])
def test_fused_head_kernel_takes_any_width_class_count_and_modality_count(card, num_mod, hidden,
                                                                          ncls):
    # H 640 and 1500: K in slabs of 576; C 300: the logits read W2 from device
    # memory; M 6 at H 1500: the gate reads its operands from device memory
    projected, mask, pair_params, rest, pairs = _head_case(card, 33, num_mod, hidden, ncls)
    got = tf.fused_hybrid_head(projected, mask, pair_params, *rest, pairs)
    again = tf.fused_hybrid_head(projected, mask, pair_params, *rest, pairs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = tf.fused_hybrid_head_reference(projected, mask, pair_params, *rest, pairs)
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("batch", [5, 64])
def test_fused_head_kernel_repeats_bit_for_bit(card, batch):
    # every sum in a fixed order, no atomics
    projected, mask, pair_params, rest, pairs = _head_case(card, batch)
    first = tf.fused_hybrid_head(projected, mask, pair_params, *rest, pairs)
    second = tf.fused_hybrid_head(projected, mask, pair_params, *rest, pairs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _rel_err(got, want):
    """Max abs error relative to the reference's largest magnitude."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


# f32 on both sides; the kernels sum in another order (64-wide tiles, split
# row sums for the weight gradients), so errors stay near 1e-6 relative
GRAD_TOL = 1e-4


@pytest.mark.parametrize("seq,hd", [(72, 64), (512, 64), (40, 16), (24, 128)])
def test_packed_attention_bwd_kernel_matches_twin(card, seq, hd):
    g = torch.Generator().manual_seed(100 + seq)
    heads, batch = 4, 4
    qkv = torch.randn(batch, seq, 3 * heads * hd, generator=g).to(card)
    dout = torch.randn(batch, seq, heads * hd, generator=g).to(card)
    lengths = torch.tensor([0, seq, 37 % seq, seq - 7], dtype=torch.int32, device=card)
    out, lse = ta.packed_attention_reference(qkv, lengths, heads, hd**-0.5)
    before = ta.packed_attention_bwd.launches
    got = ta.packed_attention_bwd(qkv, lengths, out, lse, dout, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert ta.packed_attention_bwd.launches == before + 1
    want = ta.packed_attention_bwd_reference(qkv, lengths, out, lse, dout, heads, hd**-0.5)
    assert _rel_err(got, want) < GRAD_TOL
    assert torch.all(got[0] == 0)  # length 0: no gradient at all
    f = heads * hd
    assert torch.all(got[2, 37 % seq:, f:] == 0)  # keys past the length: exact zero dk, dv


def _ln_inputs(g, n, d, f, keep, card):
    def w(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(card)

    fmask = rmask = None
    if keep is not None:
        fmask = (torch.rand(n, f, generator=g) < keep).to(torch.uint8).to(card)
        rmask = (torch.rand(n, d, generator=g) < keep).to(torch.uint8).to(card)
    return w, fmask, rmask


@pytest.mark.parametrize("n,d,keep", [(1000, 256, 0.8), (37, 256, None), (300, 64, 0.0)])
def test_proj_ln_kernels_match_twins(card, n, d, keep):
    g = torch.Generator().manual_seed(n + d)
    w, _fmask, rmask = _ln_inputs(g, n, d, d, keep, card)
    args = (w(n, d), w(n, d), w(d, d, scale=d**-0.5), w(d, scale=0.1), 1 + w(d, scale=0.1),
            w(d, scale=0.1), rmask)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    before = (tm.proj_ln_fwd.launches, tm.proj_ln_bwd.launches)
    out = tm.proj_ln_fwd(*args, inv_keep, 1e-6)
    dout = w(n, d)
    grads = tm.proj_ln_bwd(*args, dout, inv_keep, 1e-6)
    torch.cuda.synchronize()
    assert (tm.proj_ln_fwd.launches, tm.proj_ln_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert _rel_err(out, tm.proj_ln_fwd_reference(*args, inv_keep, 1e-6)) < GRAD_TOL
    for got, want in zip(grads, tm.proj_ln_bwd_reference(*args, dout, inv_keep, 1e-6)):
        if keep == 0.0 and not want.abs().max() > 0:
            assert torch.all(got == 0)
        else:
            assert _rel_err(got, want) < GRAD_TOL


@pytest.mark.parametrize("n,d,f,keep", [(300, 256, 2048, 0.8), (37, 256, 2048, None),
                                        (100, 64, 128, 0.0)])
def test_ffw_ln_kernels_match_twins(card, n, d, f, keep):
    g = torch.Generator().manual_seed(n + f)
    w, fmask, rmask = _ln_inputs(g, n, d, f, keep, card)
    args = (w(n, d), w(d, f, scale=d**-0.5), w(f, scale=0.1), w(f, d, scale=f**-0.5),
            w(d, scale=0.1), 1 + w(d, scale=0.1), w(d, scale=0.1), fmask, rmask)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    before = (tm.ffw_ln_fwd.launches, tm.ffw_ln_bwd.launches)
    out = tm.ffw_ln_fwd(*args, inv_keep, 1e-6)
    dout = w(n, d)
    grads = tm.ffw_ln_bwd(*args, dout, inv_keep, 1e-6)
    torch.cuda.synchronize()
    assert (tm.ffw_ln_fwd.launches, tm.ffw_ln_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert _rel_err(out, tm.ffw_ln_fwd_reference(*args, inv_keep, 1e-6)) < GRAD_TOL
    for got, want in zip(grads, tm.ffw_ln_bwd_reference(*args, dout, inv_keep, 1e-6)):
        if keep == 0.0 and not want.abs().max() > 0:
            assert torch.all(got == 0)
        else:
            assert _rel_err(got, want) < GRAD_TOL


@pytest.mark.parametrize("n,d,dv,keep", [(300, 256, 192, 0.8), (37, 64, 48, None)])
def test_ln_kernels_at_a_padded_width_match_twins(card, n, d, dv, keep):
    # the model width dv run at the built width d: inputs zero past dv, the
    # LayerNorm over dv, and nothing written past dv
    g = torch.Generator().manual_seed(n + dv)
    w, fmask, rmask = _ln_inputs(g, n, d, 128, keep, card)
    cut = torch.ones(d, device=card)
    cut[dv:] = 0.0

    def v(*shape, scale=1.0):  # zero past dv in every axis of width d
        t = w(*shape, scale=scale)
        for axis, size in enumerate(shape):
            if size == d:
                t = t * cut.reshape([-1 if i == axis else 1 for i in range(len(shape))])
        return t.contiguous()

    x, dout = v(n, d), v(n, d)
    gamma, beta = (1 + w(d, scale=0.1)) * cut, v(d, scale=0.1)
    proj = (x, v(n, d), v(d, d, scale=dv**-0.5), v(d, scale=0.1), gamma, beta, rmask)
    ffw = (x, v(d, 128, scale=dv**-0.5), w(128, scale=0.1), v(128, d, scale=128**-0.5),
           v(d, scale=0.1), gamma, beta, fmask, rmask)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    for fwd, bwd, args in ((tm.proj_ln_fwd, tm.proj_ln_bwd, proj),
                           (tm.ffw_ln_fwd, tm.ffw_ln_bwd, ffw)):
        out = fwd(*args, inv_keep, 1e-6, d_valid=dv)
        grads = bwd(*args, dout, inv_keep, 1e-6, d_valid=dv)
        torch.cuda.synchronize()
        want = fwd(*[a.cpu() if a is not None else None for a in args], inv_keep, 1e-6,
                   d_valid=dv)
        assert torch.all(out[:, dv:] == 0) and torch.all(grads[0][:, dv:] == 0)
        assert _rel_err(out.cpu(), want) < GRAD_TOL
        cpu = [a.cpu() if a is not None else None for a in (*args, dout)]
        for got, ref in zip(grads, bwd(*cpu, inv_keep, 1e-6, d_valid=dv)):
            assert _rel_err(got.cpu(), ref) < GRAD_TOL


def test_ffw_ln_bwd_kernel_repeats_bit_for_bit(card):
    # every sum over rows is per-block or per-split partials added in order:
    # no atomics, so the same inputs give the same bits
    n, d, f = 1000, 256, 2048
    g = torch.Generator().manual_seed(41)
    w, fmask, rmask = _ln_inputs(g, n, d, f, 0.8, card)
    args = (w(n, d), w(d, f, scale=d**-0.5), w(f, scale=0.1), w(f, d, scale=f**-0.5),
            w(d, scale=0.1), 1 + w(d, scale=0.1), w(d, scale=0.1), fmask, rmask, w(n, d))
    first = tm.ffw_ln_bwd(*args, 1.25, 1e-6)
    second = tm.ffw_ln_bwd(*args, 1.25, 1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("keep", [0.8, None], ids=["keep0.8", "nomask"])
def test_ffw_ln_forward_hidden_equals_the_backwards_bit_for_bit(card, keep):
    # both directions launch one hidden kernel with the same arguments, so the
    # backward takes every ReLU branch the forward took
    n, d, f = 1000, 256, 2048
    g = torch.Generator().manual_seed(43)
    w, fmask, rmask = _ln_inputs(g, n, d, f, keep, card)
    x, w1, b1, w2, b2 = (w(n, d), w(d, f, scale=d**-0.5), w(f, scale=0.1),
                         w(f, d, scale=f**-0.5), w(d, scale=0.1))
    gamma, beta = 1 + w(d, scale=0.1), w(d, scale=0.1)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    _out, fwd_hd = tm._ffw_ln_fwd_launch(x, w1, b1, w2, b2, gamma, beta, fmask, rmask,
                                         inv_keep, 1e-6)
    _grads, bwd_hd = tm._ffw_ln_bwd_launch(x, w1, b1, w2, b2, gamma, beta, fmask, rmask,
                                           w(n, d), inv_keep, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(fwd_hd, bwd_hd)


def test_proj_ln_bwd_kernel_repeats_bit_for_bit(card):
    n, d = 1000, 256
    g = torch.Generator().manual_seed(47)
    w, _fmask, rmask = _ln_inputs(g, n, d, d, 0.8, card)
    args = (w(n, d), w(n, d), w(d, d, scale=d**-0.5), w(d, scale=0.1), 1 + w(d, scale=0.1),
            w(d, scale=0.1), rmask, w(n, d))
    first = tm.proj_ln_bwd(*args, 1.25, 1e-6)
    second = tm.proj_ln_bwd(*args, 1.25, 1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_proj_ln_fwd_kernel_repeats_bit_for_bit(card):
    n, d = 16384, 256  # the training shape
    g = torch.Generator().manual_seed(53)
    w, _fmask, rmask = _ln_inputs(g, n, d, d, 0.8, card)
    args = (w(n, d), w(n, d), w(d, d, scale=d**-0.5), w(d, scale=0.1), 1 + w(d, scale=0.1),
            w(d, scale=0.1), rmask)
    first = tm.proj_ln_fwd(*args, 1.25, 1e-6)
    second = tm.proj_ln_fwd(*args, 1.25, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _rel_err(first, tm.proj_ln_fwd_reference(*args, 1.25, 1e-6)) < GRAD_TOL


def test_ln_kernels_reject_what_they_do_not_take(card):
    x = torch.zeros(8, 48, device=card)
    with pytest.raises(ValueError, match="d_model"):
        tm.proj_ln_fwd(x, x, torch.zeros(48, 48, device=card), *[torch.zeros(48, device=card)] * 3,
                       None, 1.0, 1e-6)
    x = torch.zeros(8, 64, device=card)
    v = torch.zeros(64, device=card)
    with pytest.raises(ValueError, match="multiple of 64"):
        tm.ffw_ln_fwd(x, torch.zeros(64, 96, device=card), torch.zeros(96, device=card),
                      torch.zeros(96, 64, device=card), v, v, v, None, None, 1.0, 1e-6)
    with pytest.raises(TypeError, match="uint8"):
        tm.proj_ln_fwd(x, x, torch.zeros(64, 64, device=card), v, v, v,
                       torch.ones(8, 64, device=card), 1.0, 1e-6)


@pytest.mark.parametrize("rows,cols,keep,purpose", [
    (512, 256, 0.8, tm.RNG_P_ATT), (512, 2048, 0.8, tm.RNG_P_HIDDEN),
    (37, 91, 0.8, tm.RNG_P_RES), (64, 64, 1.0, tm.RNG_P_RES), (64, 64, 0.0, tm.RNG_P_HIDDEN),
    (3, 1, 0.5, tm.RNG_P_ATT)])
def test_dropout_mask_kernel_equals_twin_bit_for_bit(card, rows, cols, keep, purpose):
    seed = torch.tensor([-1234567, 2**31 - 5], dtype=torch.int32, device=card)
    before = tm.dropout_keep_mask.launches
    got = tm.dropout_keep_mask(seed, rows, cols, keep, purpose)
    torch.cuda.synchronize()
    assert tm.dropout_keep_mask.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == (rows, cols)
    # integer arithmetic on both sides: every byte is equal
    assert torch.equal(got, tm.dropout_keep_mask_reference(seed, rows, cols, keep, purpose))
    assert torch.equal(got.cpu(), tm.dropout_keep_mask(seed.cpu(), rows, cols, keep, purpose))
    if keep in (0.0, 1.0):
        assert torch.all(got == int(keep))
    other = tm.dropout_keep_mask(seed + 1, rows, cols, keep, purpose)
    if keep == 0.8 and rows * cols > 1000:
        assert not torch.equal(got, other)
        n = got.numel()
        assert abs(got.float().mean().item() - keep) < 4 * (keep * (1 - keep) / n) ** 0.5


@pytest.mark.parametrize("rows,specs", [
    (32 * 512, [(256, tm.RNG_P_ATT), (2048, tm.RNG_P_HIDDEN), (256, tm.RNG_P_RES)]),
    (1021, [(7, tm.RNG_P_HIDDEN), (7, tm.RNG_P_RES), (3, tm.RNG_P_ATT)]),
    (4 * 32 * 512, [(256, tm.RNG_P_ATT), (2048, tm.RNG_P_HIDDEN), (256, tm.RNG_P_RES)]),
], ids=["layer", "ragged", "grouped-layer"])
@pytest.mark.parametrize("keep", [0.8, 1.0, 0.0])
def test_dropout_masks_one_launch_equals_twin_bit_for_bit(card, rows, specs, keep):
    """A layer's three masks in one launch: every byte equal to the twin's,
    and to the single-mask launches of the same (seed, purpose)."""
    seed = torch.tensor([424242, -31337], dtype=torch.int32, device=card)
    before = tm.dropout_keep_mask.launches
    got = tm.dropout_keep_masks(seed, rows, specs, keep)
    torch.cuda.synchronize()
    assert tm.dropout_keep_mask.launches == before + 1
    for mask, (cols, purpose) in zip(got, specs):
        assert mask.dtype == torch.uint8 and mask.shape == (rows, cols)
        assert torch.equal(mask, tm.dropout_keep_mask_reference(seed, rows, cols, keep, purpose))
        assert torch.equal(mask, tm.dropout_keep_mask(seed, rows, cols, keep, purpose))
    if keep == 0.8 and rows > 2000:
        rate = torch.cat([m.reshape(-1) for m in got]).float().mean().item()
        n = sum(m.numel() for m in got)
        assert abs(rate - keep) < 4 * (keep * (1 - keep) / n) ** 0.5


def test_dropout_mask_kernel_rejects_a_seed_it_does_not_take(card):
    with pytest.raises(TypeError, match="int32"):
        tm.dropout_keep_mask(torch.zeros(2, dtype=torch.int64, device=card), 4, 4, 0.8)


def _forward_branches(x, w1, b1, mask, inv_keep, hd):
    """The twin's ``pre`` and the ReLU branches the kernel's forward took
    (``hd > 0`` where the mask keeps the unit). Each branch that differs from
    the twin's own must lie within (D + 64) 2^-23 |x_n| |W1[:, f]| of zero in
    the twin's pre: two f32-accurate sums of the same products (the kernel's
    3xTF32, the twin's cuBLAS f32) differ by no more."""
    pre = x @ w1 + b1
    kept = torch.full_like(pre, inv_keep != 0.0, dtype=torch.bool)
    if mask is not None:
        kept &= mask.bool()
    live = torch.where(kept, hd > 0, pre > 0)
    band = (x.shape[1] + 64) * 2.0**-23 * x.norm(dim=1)[:, None] * w1.norm(dim=0)[None, :]
    assert not torch.any((live != (pre > 0)) & (pre.abs() >= band))
    return pre, live


@pytest.mark.parametrize("n,d,f,keep", [(300, 256, 2048, 0.8), (37, 256, 2048, None),
                                        (100, 64, 128, 0.0), (1000, 32, 64, 0.8)])
def test_fused_mlp_kernels_match_twins(card, n, d, f, keep):
    g = torch.Generator().manual_seed(n + f + 1)
    w, mask, _rmask = _ln_inputs(g, n, d, f, keep, card)
    x, w1, b1, w2, b2 = (w(n, d), w(d, f, scale=d**-0.5), w(f, scale=0.1),
                         w(f, d, scale=f**-0.5), w(d, scale=0.1))
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    before = (tm.fused_mlp_fwd.launches, tm.fused_mlp_bwd.launches)
    out = tm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, inv_keep)
    dout = w(n, d)
    grads, hd = tm._fused_mlp_bwd_launch(x, w1, b1, w2, mask, dout, inv_keep)
    torch.cuda.synchronize()
    assert (tm.fused_mlp_fwd.launches, tm.fused_mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert _rel_err(out, tm.fused_mlp_fwd_reference(x, w1, b1, w2, b2, mask, inv_keep)) < GRAD_TOL
    if keep == 0.0:
        assert torch.equal(out, b2.expand_as(out))  # the hidden is exactly zero
    # the backward against its twin on the branches the kernel's forward took
    pre, live = _forward_branches(x, w1, b1, mask, inv_keep, hd)
    for got, want in zip(grads, tm._fused_mlp_bwd_plain(x, w1, pre, live, w2, mask, dout,
                                                        inv_keep)):
        if keep == 0.0 and not want.abs().max() > 0:
            assert torch.all(got == 0)
        else:
            assert _rel_err(got, want) < GRAD_TOL


@pytest.mark.parametrize("keep", [0.8, None], ids=["keep0.8", "nomask"])
def test_fused_mlp_hidden_is_ffw_lns_and_the_backward_repeats(card, keep):
    # both fused_mlp directions and both ffw_ln directions launch one hidden
    # body with the same arguments: the same bits, so the same ReLU branches;
    # every sum over rows is partials added in order, so a rerun repeats
    n, d, f = 1000, 256, 2048
    g = torch.Generator().manual_seed(53)
    w, fmask, rmask = _ln_inputs(g, n, d, f, keep, card)
    x, w1, b1, w2, b2 = (w(n, d), w(d, f, scale=d**-0.5), w(f, scale=0.1),
                         w(f, d, scale=f**-0.5), w(d, scale=0.1))
    gamma, beta, dout = 1 + w(d, scale=0.1), w(d, scale=0.1), w(n, d)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    _out, fwd_hd = tm._fused_mlp_fwd_launch(x, w1, b1, w2, b2, fmask, inv_keep)
    first, bwd_hd = tm._fused_mlp_bwd_launch(x, w1, b1, w2, fmask, dout, inv_keep)
    second, _hd = tm._fused_mlp_bwd_launch(x, w1, b1, w2, fmask, dout, inv_keep)
    _out, ln_hd = tm._ffw_ln_fwd_launch(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, inv_keep,
                                        1e-6)
    torch.cuda.synchronize()
    assert torch.equal(fwd_hd, bwd_hd) and torch.equal(fwd_hd, ln_hd)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_mlp_autograd_runs_both_kernels(card):
    g = torch.Generator().manual_seed(9)
    n, d, f = 200, 64, 256
    w, mask, _rmask = _ln_inputs(g, n, d, f, 0.8, card)
    leaves = [t.requires_grad_() for t in (w(n, d), w(d, f, scale=d**-0.5), w(f, scale=0.1),
                                           w(f, d, scale=f**-0.5), w(d, scale=0.1))]
    before = (tm.fused_mlp_fwd.launches, tm.fused_mlp_bwd.launches)
    out = tm.fused_mlp(*leaves, keep_mask=mask, keep_prob=0.8)
    dout = w(n, d)
    got = torch.autograd.grad(out, leaves, dout)
    assert (tm.fused_mlp_fwd.launches, tm.fused_mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
    x, w1, b1, w2, b2 = leaves
    h = torch.relu(x @ w1 + b1) * mask.float() / 0.8
    want = torch.autograd.grad(h @ w2 + b2, leaves, dout)
    for a, b in zip(got, want):
        assert _rel_err(a, b) < GRAD_TOL


# ---- flash_self_attention: the five head-major kernels ----------------------

FLASH_SHAPES = [  # bh rows = batch * heads, T, head_dim: small, ragged, and the full shapes
    (4, 2, 72, 64), (4, 2, 100, 16), (3, 1, 24, 128), (4, 2, 1100, 32), (32, 4, 1024, 64)]


def _flash_inputs(card, batch, heads, seq, hd, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(batch * heads, seq, hd, generator=g).to(card) for _ in range(4))
    lengths = torch.randint(1, seq + 1, (batch,), generator=g, dtype=torch.int32)
    lengths[:3] = torch.tensor([0, seq, 37 % seq], dtype=torch.int32)
    return q, k, v, dout, lengths.to(card)


@pytest.mark.parametrize("kernel", ["single", "tiled"])
@pytest.mark.parametrize("batch,heads,seq,hd", FLASH_SHAPES + [(3, 4, 2048, 64)])
def test_flash_forward_kernels_match_plain(card, kernel, batch, heads, seq, hd):
    q, k, v, _dout, lengths = _flash_inputs(card, batch, heads, seq, hd, seq + hd)
    fn = ta.flash_fwd_single if kernel == "single" else ta.flash_fwd_tiled
    before = fn.launches
    out, lse = fn(q, k, v, lengths, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref_out, ref_lse = ta.flash_attention_reference(q, k, v, lengths, heads, hd**-0.5)
    # f32 both; the kernels sum over 64-key tiles in another order
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=2e-5)
    assert torch.all(out[:heads] == 0) and torch.all(lse[:heads] == ta.NEG_INF)


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("batch,heads,seq,hd", FLASH_SHAPES)
def test_flash_backward_kernels_match_plain(card, route, batch, heads, seq, hd):
    q, k, v, dout, lengths = _flash_inputs(card, batch, heads, seq, hd, 7 + seq + hd)
    scale = hd**-0.5
    out, lse = ta.flash_attention_reference(q, k, v, lengths, heads, scale)
    delta = ta.flash_delta(out, dout)
    torch.testing.assert_close(delta, (dout * out).sum(-1), rtol=1e-5, atol=1e-5)
    args = (q, k, v, lengths, heads, lse, delta, dout, scale)
    if route == "fused":
        before = ta.flash_bwd_fused.launches
        got = ta.flash_bwd_fused(*args)
        assert ta.flash_bwd_fused.launches == before + 1
    else:
        before = (ta.flash_bwd_dkv.launches, ta.flash_bwd_dq.launches)
        dk, dv = ta.flash_bwd_dkv(*args)
        got = (ta.flash_bwd_dq(*args), dk, dv)
        assert (ta.flash_bwd_dkv.launches, ta.flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    want = ta.flash_attention_bwd_reference(q, k, v, lengths, heads, out, lse, dout, scale)
    for a, b in zip(got, want):
        assert _rel_err(a, b) < GRAD_TOL
        assert torch.all(a[:heads] == 0)  # length 0: no gradient at all
    cut = 37 % seq  # batch row 2: keys past the length get exact zero dk, dv
    assert torch.all(got[1][2 * heads:3 * heads, cut:] == 0)
    assert torch.all(got[2][2 * heads:3 * heads, cut:] == 0)


def test_flash_self_attention_on_the_card_routes_and_differentiates(card):
    q, k, v, dout, lengths = _flash_inputs(card, 3, 2, 200, 64, 5)
    leaves = [t.view(3, 2, 200, 64).clone().requires_grad_() for t in (q, k, v)]
    counters = (ta.flash_fwd_single, ta.flash_fwd_tiled, ta.flash_bwd_fused, ta.flash_bwd_dkv,
                ta.flash_bwd_dq, ta.packed_attention_fwd)
    results = []
    for kwargs, want in (({}, (1, 0, 1, 0, 0, 0)),
                         ({"block_q": 64, "block_k": 64, "single_k_max": 0, "fused_bwd_max": 0},
                          (0, 1, 0, 1, 1, 0))):
        before = [fn.launches for fn in counters]
        out = ta.flash_self_attention(*leaves, lengths, **kwargs)
        grads = torch.autograd.grad(out, leaves, dout.view(3, 2, 200, 64))
        assert tuple(fn.launches - b for fn, b in zip(counters, before)) == want
        results.append((out, *grads))
    for a, b in zip(*results):  # two routes, one function
        assert _rel_err(a, b) < GRAD_TOL


def test_flash_kernels_reject_what_they_do_not_take(card):
    q = torch.zeros(4, 8, 8, device=card)  # head_dim 8
    lengths = torch.full((2,), 8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ta.flash_fwd_single(q, q, q, lengths, 2, 1.0)
    q = torch.zeros(4, 8, 16, device=card)
    with pytest.raises(TypeError, match="int32"):
        ta.flash_fwd_tiled(q, q, q, lengths.long(), 2, 1.0)


@pytest.mark.parametrize("seq", [1024, 2100])
def test_flash_fwd_tiled_equals_single_bit_for_bit(card, seq):
    # the two forward kernels are two entries on one body (attention_fwd.cuh)
    q, k, v, _dout, lengths = _flash_inputs(card, 4, 4, seq, 64, 31 + seq)
    single = ta.flash_fwd_single(q, k, v, lengths, 4, 64**-0.5)
    tiled = ta.flash_fwd_tiled(q, k, v, lengths, 4, 64**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(single[0], tiled[0]) and torch.equal(single[1], tiled[1])


def test_flash_fwd_single_takes_any_length(card):
    # no score rows in shared memory, so no cap on T: 8192 keys run and match
    g = torch.Generator().manual_seed(8192)
    q, k, v = (torch.randn(2, 8192, 16, generator=g).to(card) for _ in range(3))
    for lens in ([8192], [5000]):
        lengths = torch.tensor(lens, dtype=torch.int32, device=card)
        out, lse = ta.flash_fwd_single(q, k, v, lengths, 2, 16**-0.5)
        torch.cuda.synchronize()
        ref_out, ref_lse = ta.flash_attention_reference(q, k, v, lengths, 2, 16**-0.5)
        torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=2e-5)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("all_zero", [True, False], ids=["every-row", "one-row"])
def test_tensor_core_attention_kernels_give_zeros_for_length_0(card, all_zero):
    g = torch.Generator().manual_seed(17)
    heads, hd, batch = 4, 64, 2
    lengths = torch.tensor([0, 0] if all_zero else [0, 700], dtype=torch.int32, device=card)
    q, k, v = (torch.randn(batch * heads, 1024, hd, generator=g).to(card) for _ in range(3))
    ref_out, ref_lse = ta.flash_attention_reference(q, k, v, lengths, heads, hd**-0.5)
    for forward in (ta.flash_fwd_single, ta.flash_fwd_tiled):
        out, lse = forward(q, k, v, lengths, heads, hd**-0.5)
        torch.cuda.synchronize()
        assert torch.all(out[:heads] == 0) and torch.all(lse[:heads] == ta.NEG_INF)
        torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=2e-5)
    dout = torch.randn(batch * heads, 1024, hd, generator=g).to(card)
    delta = ta.flash_delta(ref_out, dout)
    got = ta.flash_bwd_fused(q, k, v, lengths, heads, ref_lse, delta, dout, hd**-0.5)
    torch.cuda.synchronize()
    assert all(torch.all(t[:heads] == 0) for t in got)  # dq, dk, dv of length 0
    want = ta.flash_attention_bwd_reference(q, k, v, lengths, heads, ref_out, ref_lse, dout,
                                            hd**-0.5)
    assert all(_rel_err(a, b) < GRAD_TOL for a, b in zip(got, want))
    qkv = torch.randn(batch, 512, 3 * heads * hd, generator=g).to(card)
    dout = torch.randn(batch, 512, heads * hd, generator=g).to(card)
    lens = lengths.clamp(max=512)
    out, lse = ta.packed_attention_fwd(qkv, lens, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert torch.all(out[0] == 0) and torch.all(lse[0] == ta.NEG_INF)
    ref_out, ref_lse = ta.packed_attention_reference(qkv, lens, heads, hd**-0.5)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    got = ta.packed_attention_bwd(qkv, lens, ref_out, ref_lse, dout, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert torch.all(got[0] == 0)  # length 0: no gradient at all, dq included
    want = ta.packed_attention_bwd_reference(qkv, lens, ref_out, ref_lse, dout, heads, hd**-0.5)
    assert _rel_err(got, want) < GRAD_TOL  # every row 0: both exact zeros


def test_packed_attention_bwd_kernel_repeats_bit_for_bit(card):
    # dq from per-key-tile partials summed in order: no atomics, so the same
    # inputs give the same bits
    g = torch.Generator().manual_seed(23)
    heads, hd, batch, seq = 4, 64, 8, 512
    qkv = torch.randn(batch, seq, 3 * heads * hd, generator=g).to(card)
    dout = torch.randn(batch, seq, heads * hd, generator=g).to(card)
    lengths = torch.tensor([512, 1, 0, 37, 64, 65, 511, 300], dtype=torch.int32, device=card)
    out, lse = ta.packed_attention_fwd(qkv, lengths, heads, hd**-0.5)
    first = ta.packed_attention_bwd(qkv, lengths, out, lse, dout, heads, hd**-0.5)
    second = ta.packed_attention_bwd(qkv, lengths, out, lse, dout, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_bwd_fused_kernel_repeats_bit_for_bit(card):
    # dq from per-key-tile partials summed in order: no atomics, so the same
    # inputs give the same bits
    q, k, v, dout, lengths = _flash_inputs(card, 8, 4, 1024, 64, 29)
    lengths[3:8] = torch.tensor([1, 64, 65, 1023, 613], dtype=torch.int32, device=card)
    out, lse = ta.flash_fwd_single(q, k, v, lengths, 4, 64**-0.5)
    delta = ta.flash_delta(out, dout)
    args = (q, k, v, lengths, 4, lse, delta, dout, 64**-0.5)
    first = ta.flash_bwd_fused(*args)
    second = ta.flash_bwd_fused(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("seq,hd", [(1024, 64), (300, 16), (1100, 32), (200, 128)])
def test_flash_split_kernels_repeat_and_share_the_fused_dk_dv_bits(card, seq, hd):
    # the dk/dv kernel is the fused kernel's body without its dq: the same
    # instructions, so the same bits; neither split kernel uses atomics
    q, k, v, dout, lengths = _flash_inputs(card, 8, 4, seq, hd, 41 + seq)
    lengths[3:8] = torch.tensor([1, 64, 65, seq - 1, seq // 2], dtype=torch.int32, device=card)
    out, lse = ta.flash_fwd_single(q, k, v, lengths, 4, hd**-0.5)
    args = (q, k, v, lengths, 4, lse, ta.flash_delta(out, dout), dout, hd**-0.5)
    _dq, fused_dk, fused_dv = ta.flash_bwd_fused(*args)
    first, second = ta.flash_bwd_dkv(*args), ta.flash_bwd_dkv(*args)
    dq_first, dq_second = ta.flash_bwd_dq(*args), ta.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], fused_dk) and torch.equal(first[1], fused_dv)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(dq_first, dq_second)


# ---- grouped recurrences: the three inference kernels ------------------------

# T, G, B, D, H: small and ragged (B, T not multiples of 8, H not of 32), H 64 and 192 (the
# cluster bodies below the full width), full width
RNN_SHAPES = [
    (22, 2, 5, 3, 16), (37, 3, 13, 8, 48), (24, 1, 8, 1, 300), (40, 2, 21, 5, 64),
    (33, 3, 40, 9, 192), (512, 4, 64, 17, 256)]


def _rnn_inputs(card, steps, groups, batch, feat, hidden, gates, seed):
    g = torch.Generator().manual_seed(seed)
    scale = hidden**-0.5

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(card)

    x = torch.randn(steps, groups, batch, feat, generator=g).to(card)
    lengths = torch.randint(1, steps + 1, (batch,), generator=g, dtype=torch.int32)
    lengths[:5] = torch.tensor([0, 1, steps, steps - 1, 37 % steps], dtype=torch.int32)
    return (x, u(groups, feat, gates * hidden), u(groups, hidden, gates * hidden),
            u(groups, gates * hidden), u(groups, gates * hidden), lengths.to(card))


@pytest.mark.parametrize("with_lengths", [True, False], ids=["lengths", "full"])
@pytest.mark.parametrize("steps,groups,batch,feat,hidden", RNN_SHAPES)
@pytest.mark.parametrize("fn", ["lstm_forward", "lstm_fused", "gru_fused", "lstm_forward_rows16",
                                "lstm_forward_rows32"])
def test_grouped_recurrence_kernels_match_plain(card, fn, steps, groups, batch, feat, hidden,
                                                with_lengths):
    """Each inference kernel on the body its route names (``_rowsN``:
    ``grouped_lstm_forward`` with its cluster tiling forced, refused where
    the SIMT body runs) against its plain version: within the f32 limit, a
    row of length 0 exactly zero, a second launch the same bits."""
    gates = 3 if fn == "gru_fused" else 4
    x, w_ih, w_hh, b_ih, b_hh, lengths = _rnn_inputs(
        card, steps, groups, batch, feat, hidden, gates, steps + hidden)
    lens = lengths if with_lengths else None
    kw = {}
    if fn.startswith("lstm_forward_rows"):
        kw["cluster_rows"] = int(fn[len("lstm_forward_rows"):])
        if tr.grouped_lstm_forward_route(hidden) == "simt":
            with pytest.raises(ValueError, match="SIMT body"):
                tr.grouped_lstm_forward(torch.zeros(steps, groups, batch, 4 * hidden,
                                                    device=card), w_hh, b_hh, lens, **kw)
            return
    if fn.startswith("lstm_forward"):
        x_proj = (torch.einsum("tgbd,gdh->tgbh", x, w_ih) + b_ih[None, :, None, :]).contiguous()
        kernel, plain, args = tr.grouped_lstm_forward, tr.grouped_lstm_forward_plain, \
            (x_proj, w_hh, b_hh, lens)
    elif fn == "lstm_fused":
        kernel, plain, args = tr.grouped_lstm_fused, tr.grouped_lstm_fused_plain, \
            (x, w_ih, w_hh, b_ih + b_hh, lens)
    else:
        kernel, plain, args = tr.grouped_gru_fused, tr.grouped_gru_fused_plain, \
            (x, w_ih, w_hh, b_ih, b_hh, lens)
    before = kernel.launches
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*args)
    assert got.shape == (groups, batch, hidden)
    # f32 both; up to 512 dependent steps whose products sum in another order
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(kernel(*args, **kw), got)  # no atomics: a second launch, the same bits
    if with_lengths:
        assert torch.all(got[:, 0] == 0)  # length 0: the zero state, exactly
        if kw:  # every row of length 0: the zero state, exactly
            zero = torch.zeros_like(lengths)
            assert torch.all(kernel(*args[:-1], zero, **kw) == 0)


def test_grouped_recurrence_kernels_reject_what_they_do_not_take(card):
    x = torch.zeros(4, 2, 3, 5, device=card)
    w_ih, w_hh = torch.zeros(2, 5, 64, device=card), torch.zeros(2, 16, 64, device=card)
    bias = torch.zeros(2, 64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tr.grouped_lstm_fused(x.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2), w_ih, w_hh,
                              bias)
    with pytest.raises(TypeError, match="int32"):
        tr.grouped_lstm_fused(x, w_ih, w_hh, bias, torch.zeros(3, dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="lengths is on"):
        tr.grouped_lstm_fused(x, w_ih, w_hh, bias, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="failed to launch"):  # h and c of 8 rows: 384 KB
        big = torch.zeros(2, 4096, 4 * 4096, device=card)
        tr.grouped_lstm_forward(torch.zeros(1, 2, 3, 4 * 4096, device=card), big,
                                torch.zeros(2, 4 * 4096, device=card))
    w3, b3 = torch.zeros(2, 5, 48, device=card), torch.zeros(2, 48, device=card)
    empty = tr.grouped_gru_fused(x[:, :, :0], w3, torch.zeros(2, 16, 48, device=card), b3, b3)
    assert empty.shape == (2, 0, 16)  # an empty batch launches nothing


FUSED_SHAPES = [  # T, G, B, D, H: the cluster body at B 1, 13, 32, 64, 70, T 1, 509, 512 and
    # D 1 and 17, at each H it takes below 256 (B and T not multiples of its
    # 16-row tile), and H 384 on the SIMT body
    (1, 4, 32, 17, 256), (509, 4, 13, 17, 256), (512, 4, 32, 17, 256), (512, 4, 64, 17, 256),
    (512, 4, 70, 1, 256), (512, 1, 1, 17, 256), (40, 2, 20, 1, 64), (33, 3, 17, 17, 128),
    (40, 2, 5, 17, 192), (30, 2, 5, 17, 384)]


@pytest.mark.parametrize("steps,groups,batch,feat,hidden", FUSED_SHAPES)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fused_recurrences_on_both_bodies_match_plain_and_repeat(card, cell, steps, groups, batch,
                                                                 feat, hidden):
    """``grouped_lstm_fused`` / ``grouped_gru_fused`` on the body
    ``grouped_fused_route`` names (the cluster body at the tiling the wrapper
    picks and at both tilings forced), against their plain versions on the
    edge lengths T, 0, 1, T - 1: within the f32 limit, a row of length 0
    exactly zero, and a second launch on the same inputs the same bits."""
    want_route = "cluster" if hidden in (64, 128, 192, 256) else "simt"
    assert tr.grouped_fused_route(hidden, feat) == want_route
    gates = 4 if cell == "lstm" else 3
    g = torch.Generator().manual_seed(steps + batch + hidden + feat)
    scale = hidden**-0.5

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(card)

    x = torch.randn(steps, groups, batch, feat, generator=g).to(card)
    w_ih, w_hh = u(groups, feat, gates * hidden), u(groups, hidden, gates * hidden)
    b_ih, b_hh = u(groups, gates * hidden), u(groups, gates * hidden)
    lengths = torch.randint(1, steps + 1, (batch,), generator=g, dtype=torch.int32)
    edge = torch.tensor([steps, 0, 1, steps - 1, 37 % steps], dtype=torch.int32)[:batch]
    lengths[:len(edge)] = edge
    lengths = lengths.to(card)
    if cell == "lstm":
        kernel, plain, args = tr.grouped_lstm_fused, tr.grouped_lstm_fused_plain, \
            (x, w_ih, w_hh, b_ih + b_hh, lengths)
    else:
        kernel, plain, args = tr.grouped_gru_fused, tr.grouped_gru_fused_plain, \
            (x, w_ih, w_hh, b_ih, b_hh, lengths)
    want = plain(*args)
    for rows in (None, 16, 32) if want_route == "cluster" else (None,):
        before = kernel.launches
        got, again = kernel(*args, cluster_rows=rows), kernel(*args, cluster_rows=rows)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        # f32 both; up to 512 dependent steps whose products sum in another order
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert torch.all(got[:, lengths == 0] == 0)  # length 0: the zero state, exactly
        assert torch.equal(got, again), rows


def test_fused_recurrences_cluster_geometry_runs_the_serving_batch_in_one_wave(card):
    """At the LSTM / GRU models' serving shape (G 4, B 64, H 256, D 17) 16
    rows a cluster would ask for more clusters than fit on the card at once;
    the wrapper's tiling runs the launch in one wave."""
    for cell in ("lstm", "gru"):
        info = tr.grouped_fused_cluster_info(cell, 256, 17, 64, 4)
        picked = info[f"rows{info['rows']}"]
        assert info["ctas_per_cluster"] == 8 and info["rows16"]["threads"] == 256
        assert picked["waves"] == 1, info
        assert tr.grouped_fused_cluster_info(cell, 256, 17, 32, 4)["rows"] == 16
    with pytest.raises(ValueError, match="SIMT body"):
        tr.grouped_lstm_fused(torch.zeros(2, 1, 3, 5, device=card),
                              torch.zeros(1, 5, 64, device=card), torch.zeros(1, 16, 64, device=card),
                              torch.zeros(1, 64, device=card), cluster_rows=16)


# ---- the recurrences' training kernels ---------------------------------------

RNN_TRAIN_SHAPES = [  # T, G, B, H: small and ragged, 3H not a multiple of 4, H over one pass,
    (22, 2, 5, 16), (9, 1, 3, 15), (24, 1, 8, 300), (509, 4, 13, 256)]  # B 13 / T 509


def _rnn_train_inputs(card, steps, groups, batch, hidden, gates, seed):
    g = torch.Generator().manual_seed(seed)
    scale = hidden**-0.5
    x_proj = torch.randn(steps, groups, batch, gates * hidden, generator=g).to(card)
    w_hh = ((torch.rand(groups, hidden, gates * hidden, generator=g) * 2 - 1) * scale).to(card)
    b_hh = ((torch.rand(groups, gates * hidden, generator=g) * 2 - 1) * scale).to(card)
    dh = torch.randn(groups, batch, hidden, generator=g).to(card)
    lengths = torch.randint(1, steps + 1, (batch,), generator=g, dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, steps], dtype=torch.int32)[:batch]
    return x_proj, w_hh, b_hh, dh, lengths.to(card)


@pytest.mark.parametrize("with_lengths", [True, False], ids=["lengths", "full"])
@pytest.mark.parametrize("steps,groups,batch,hidden", RNN_TRAIN_SHAPES)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_training_kernels_match_plain(card, cell, steps, groups, batch, hidden,
                                          with_lengths):
    """Forward (final state and every residual) and backward (the ``x_proj``
    cotangent from the same residuals) against their twins, one launch each;
    past each length the residuals and the cotangent are exactly zero."""
    gates = 4 if cell == "lstm" else 3
    x_proj, w_hh, b_hh, dh, lengths = _rnn_train_inputs(
        card, steps, groups, batch, hidden, gates, steps + hidden)
    lens = lengths if with_lengths else None
    fwd, bwd = (tr.lstm_train_fwd, tr.lstm_train_bwd) if cell == "lstm" else \
        (tr.gru_train_fwd, tr.gru_train_bwd)
    fwd_plain, bwd_plain = (tr.lstm_train_fwd_plain, tr.lstm_train_bwd_plain) if cell == "lstm" \
        else (tr.gru_train_fwd_plain, tr.gru_train_bwd_plain)
    before = fwd.launches, bwd.launches
    got = fwd(x_proj, w_hh, b_hh, lens)
    want = fwd_plain(x_proj, w_hh, b_hh, lens)
    dx = bwd(*want[1:], w_hh, lens, dh)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):  # f32 both; up to 509 dependent steps
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    want_dx = bwd_plain(*want[1:], w_hh, lens, dh)
    assert _rel_err(dx, want_dx) < 1e-4
    if with_lengths:
        past = (torch.arange(steps, device=card)[:, None] >= lengths[None, :])  # [T, B]
        assert torch.all(got[0][:, 0] == 0)  # length 0: the zero state, exactly
        for t in (*got[1:], dx):
            assert torch.all(t.permute(0, 2, 1, 3)[past] == 0)


LSTM_TRAIN_SHAPES = [  # T, G, B, H: the cluster body at B 1, 13, 32, 64 and T 1, 509, 512, at
    # each H it takes below 256 (B and T not multiples of its 16-row tile), and
    # H 384 on the SIMT body
    (1, 4, 32, 256), (509, 4, 13, 256), (512, 4, 32, 256), (512, 4, 64, 256), (512, 1, 1, 256),
    (40, 2, 20, 64), (33, 3, 17, 128), (40, 2, 5, 192), (30, 2, 5, 384)]


@pytest.mark.parametrize("steps,groups,batch,hidden", LSTM_TRAIN_SHAPES)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_lstm_training_kernels_on_both_bodies_match_plain_and_repeat(card, cell, steps, groups,
                                                                     batch, hidden):
    """Both training kernels of each cell on the body ``rnn_train_route``
    names, against their twins on the edge lengths T, 0, 1, T - 1: every
    output within the f32 limits, exactly zero past each length, and a second
    launch on the same inputs gives the same bits (no atomics)."""
    want_route = "cluster" if hidden in (64, 128, 192, 256) else "simt"
    assert tr.rnn_train_route(hidden) == want_route
    fwd, bwd = getattr(tr, f"{cell}_train_fwd"), getattr(tr, f"{cell}_train_bwd")
    fwd_plain, bwd_plain = getattr(tr, f"{cell}_train_fwd_plain"), getattr(tr, f"{cell}_train_bwd_plain")
    x_proj, w_hh, b_hh, dh, lengths = _rnn_train_inputs(
        card, steps, groups, batch, hidden, 4 if cell == "lstm" else 3, steps + batch + hidden)
    edge = torch.tensor([steps, 0, 1, steps - 1], dtype=torch.int32)[:batch]
    lengths[:len(edge)] = edge.to(card)
    before = fwd.launches, bwd.launches
    got = fwd(x_proj, w_hh, b_hh, lengths)
    want = fwd_plain(x_proj, w_hh, b_hh, lengths)
    dz = bwd(*want[1:], w_hh, lengths, dh)
    again = fwd(x_proj, w_hh, b_hh, lengths)
    dz_again = bwd(*want[1:], w_hh, lengths, dh)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 2)
    for a, b in zip(got, want):  # f32 both; up to 512 dependent steps
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert _rel_err(dz, bwd_plain(*want[1:], w_hh, lengths, dh)) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(dz, dz_again)
    past = torch.arange(steps, device=card)[:, None] >= lengths[None, :]  # [T, B]
    assert torch.all(got[0][:, lengths == 0] == 0)  # length 0: the zero state, exactly
    for t in (*got[1:], dz):
        assert torch.all(t.permute(0, 2, 1, 3)[past] == 0)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_trainable_recurrence_on_the_card_matches_autograd_of_the_loop(card, cell):
    gates = 4 if cell == "lstm" else 3
    x_proj, w_hh, b_hh, dh, lengths = _rnn_train_inputs(card, 64, 4, 13, 256, gates, 5)
    tensors = [t.requires_grad_() for t in (x_proj, w_hh, b_hh)]
    fn = tr.grouped_lstm_trainable if cell == "lstm" else tr.grouped_gru_trainable
    got = fn(*tensors, lengths)
    grads = torch.autograd.grad(got, tensors, dh)
    want = tr.rnn_scan(cell, *tensors, lengths)[0]
    want_grads = torch.autograd.grad(want, tensors, dh)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for a, b in zip(grads, want_grads):
        assert _rel_err(a, b) < 1e-4
    with torch.inference_mode():  # MC dropout: the forward kernel, no graph
        before = tr.lstm_train_fwd.launches + tr.gru_train_fwd.launches
        out = fn(x_proj, w_hh, b_hh, lengths)
        assert tr.lstm_train_fwd.launches + tr.gru_train_fwd.launches == before + 1
    assert not out.requires_grad


def test_rnn_training_kernels_reject_what_they_do_not_take(card):
    x_proj = torch.zeros(4, 2, 3, 64, device=card)
    w_hh, b_hh = torch.zeros(2, 16, 64, device=card), torch.zeros(2, 64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tr.lstm_train_fwd(x_proj.transpose(1, 2).contiguous().transpose(1, 2), w_hh, b_hh)
    with pytest.raises(TypeError, match="int32"):
        tr.gru_train_fwd(x_proj[..., :48].contiguous(), w_hh[..., :48].contiguous(),
                         b_hh[:, :48].contiguous(), torch.zeros(3, dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="lengths is on"):
        tr.lstm_train_fwd(x_proj, w_hh, b_hh, torch.zeros(3, dtype=torch.int32))
    _h, g_res, hprev, cprev = tr.lstm_train_fwd(x_proj, w_hh, b_hh)
    with pytest.raises(ValueError, match="dh_out is on"):
        tr.lstm_train_bwd(g_res, hprev, cprev, w_hh, None, torch.zeros(2, 3, 16))
    with pytest.raises(RuntimeError, match="failed to launch"):  # the staged x_proj: 1 MB
        big = torch.zeros(2, 4096, 4 * 4096, device=card)
        tr.lstm_train_fwd(torch.zeros(1, 2, 3, 4 * 4096, device=card), big,
                          torch.zeros(2, 4 * 4096, device=card))


# ---- C5: every model width the reference takes, on the card ------------------

C5_NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
C5_DIMS = (17, 17, 17, 1)
C5_OFF = ["model.flash_attention=false", "model.fused_mlp=false", "model.fused_mlp_ln=false"]


def _c5_model(card, hidden, overrides=()):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    base = Path(__file__).resolve().parent.parent / "config" / "base.yaml"
    cfg = load_config(base, [f"model.hidden_dim={hidden}", "training.dropout_rng=xla", *overrides])
    return MultimodalFusionModel.from_config(cfg, device=card,
                                             generator=torch.Generator().manual_seed(hidden))


def _c5_batch(card, batch=8, seq=64):
    g = torch.Generator().manual_seed(batch + seq)
    feats = {n: torch.randn(batch, seq, d, generator=g).to(card) for n, d in zip(C5_NAMES, C5_DIMS)}
    lengths = torch.tensor([seq, 1, 37, 0, seq - 1, 8, seq, 20][:batch], dtype=torch.int32)
    return feats, lengths.to(card), torch.randint(0, 25, (batch,), generator=g).to(card)


def _counted(fn):
    kernels = (ta.packed_attention_fwd, ta.packed_attention_bwd, tm.proj_ln_fwd, tm.proj_ln_bwd,
               tm.ffw_ln_fwd, tm.ffw_ln_bwd, tm.fused_mlp_fwd, tm.fused_mlp_bwd,
               tf.fused_hybrid_head)
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels if k.launches}


# hidden -> launches of one request and of one training micro-step (4
# encoders of one layer): at 192 the attention runs at head_dim 64 (48 padded)
# and both residual-LN halves at d_model 256 (192 padded, the LayerNorm over
# 192); at 640 the head runs (H above one slab: K in slabs), and head_dim 160
# and d_model 640 are above the attention's and the layer kernels' widest
C5_LAUNCHES = {
    192: ({"packed_attention_fwd": 4, "fused_hybrid_head": 1},
          {"packed_attention_fwd": 4, "packed_attention_bwd": 4, "proj_ln_fwd": 4,
           "proj_ln_bwd": 4, "ffw_ln_fwd": 4, "ffw_ln_bwd": 4}),
    640: ({"fused_hybrid_head": 1}, {}),
}


@pytest.mark.parametrize("hidden", sorted(C5_LAUNCHES))
def test_model_widths_the_kernels_are_not_built_for_serve_and_train_on_the_card(card, hidden):
    """``model.hidden_dim`` 192 (head_dim 48) and 640 (head_dim 160, the head's
    H above one staged slab) serve and take one training micro-step on the card through
    the routes their widths name, against the same weights with every kernel
    flag off, at chip_smoke.py's limits (PERF.md section 2)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
        cross_entropy_loss,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn

    model = _c5_model(card, hidden)
    plain = _c5_model(card, hidden, C5_OFF)
    plain.load_state_dict(model.state_dict())
    feats, lengths, labels = _c5_batch(card)
    serve = make_serving_fn(model, device=card)
    got, launches = _counted(lambda: serve(feats, None, lengths))
    assert launches == C5_LAUNCHES[hidden][0]
    with torch.inference_mode():
        want = plain.eval()(feats, None, lengths)
    assert torch.isfinite(got).all() and (got - want).abs().max().item() < 1e-3

    results = []
    for m in (model, plain):
        m.train()

        def step(m=m):
            logits = m(feats, None, lengths, train=True,
                       generator=torch.Generator(device=card).manual_seed(7))
            loss = cross_entropy_loss(logits, labels, 0.05)
            return loss, torch.autograd.grad(loss, list(m.parameters()), allow_unused=True)

        (loss, grads), launches = _counted(step)
        results.append((loss, grads, launches))
    (loss_k, grads_k, launches_k), (loss_p, grads_p, launches_p) = results
    assert launches_k == C5_LAUNCHES[hidden][1] and launches_p == {}
    assert abs(loss_k.item() - loss_p.item()) <= 1e-3 * abs(loss_p.item())
    pairs = [(a, b) for a, b in zip(grads_k, grads_p) if b is not None]
    floor = 1e-3 * max(b.abs().max().item() for _a, b in pairs)
    for a, b in pairs:  # each gradient max-abs (floored), and norm-wise
        assert (a - b).abs().max().item() / max(b.abs().max().item(), floor) < 1e-2
        assert (a - b).norm().item() / max(b.norm().item(), floor) < 1e-3


_ENCODER_STEP = {"packed_attention_fwd": 4, "packed_attention_bwd": 4, "proj_ln_fwd": 4,
                 "proj_ln_bwd": 4, "ffw_ln_fwd": 4, "ffw_ln_bwd": 4}
# case -> (overrides of base.yaml, launches of one request, of one training
# micro-step): the early, late and uncertainty heads are plain layers (no head
# kernel); every stream on the CNN encoder launches the head kernel alone
ZOO_CASES = {
    "early": (["model.fusion_type=early"], {"packed_attention_fwd": 4}, _ENCODER_STEP),
    "late": (["model.fusion_type=late"], {"packed_attention_fwd": 4}, _ENCODER_STEP),
    "uncertainty": (["model.fusion_type=uncertainty"], {"packed_attention_fwd": 4},
                    _ENCODER_STEP),
    "cnn": ([f"model.encoders.{n}.encoder_type=cnn" for n in C5_NAMES],
            {"fused_hybrid_head": 1}, {}),
}


@pytest.mark.parametrize("case", sorted(ZOO_CASES))
def test_fusion_heads_and_the_cnn_model_serve_and_train_on_the_card(card, case):
    """base.yaml with the early, late or uncertainty head, or every stream on
    the CNN encoder, at full width: served and one training micro-step on the
    card with the launches their routes name, against the same weights with
    every kernel flag off, at chip_smoke.py's limits (PERF.md section 2); the
    CNN's BatchNorm buffers move with the training step only."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
        cross_entropy_loss,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn

    overrides, serve_want, step_want = ZOO_CASES[case]
    model = _c5_model(card, 256, overrides)
    plain = _c5_model(card, 256, [*overrides, *C5_OFF])
    plain.load_state_dict(model.state_dict())
    feats, lengths, labels = _c5_batch(card)
    serve = make_serving_fn(model, device=card)
    got, launches = _counted(lambda: serve(feats, None, lengths))
    assert launches == serve_want
    with torch.inference_mode():
        want = plain.eval()(feats, None, lengths)
    assert got.shape == (8, 25) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-3
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    assert len(buffers) == (16 if case == "cnn" else 0)

    results = []
    for m in (model, plain):
        def step(m=m):
            logits = m(feats, None, lengths, train=True,
                       generator=torch.Generator(device=card).manual_seed(7))
            loss = cross_entropy_loss(logits, labels, 0.05)
            return loss, torch.autograd.grad(loss, list(m.parameters()), allow_unused=True)

        (loss, grads), launches = _counted(step)
        results.append((loss, grads, launches))
    (loss_k, grads_k, launches_k), (loss_p, grads_p, launches_p) = results
    assert launches_k == step_want and launches_p == {}
    assert abs(loss_k.item() - loss_p.item()) <= 1e-3 * abs(loss_p.item())
    pairs = [(a, b) for a, b in zip(grads_k, grads_p) if b is not None]
    floor = 1e-3 * max(b.abs().max().item() for _a, b in pairs)
    for a, b in pairs:  # each gradient max-abs (floored), and norm-wise
        assert (a - b).abs().max().item() / max(b.abs().max().item(), floor) < 1e-2
        assert (a - b).norm().item() / max(b.norm().item(), floor) < 1e-3
    assert all(not torch.equal(v, buffers[k]) for k, v in model.named_buffers())


# the CNN encoders' embeddings on the card against the CPU, each stream's
# largest error over its largest magnitude: f32 on both sides, the sums in
# another order; TF32 convolutions (10-bit mantissa) miss it
CNN_CPU_TOL = 1e-5


def test_cnn_encoders_on_the_card_match_the_cpu_in_float32(card):
    """Every stream on the CNN encoder at base.yaml's width and chunk 512,
    with TF32 and cuDNN's free choice of algorithm turned on first: building
    the model resolves the card, which pins full float32 and deterministic
    cuDNN, and the card's embeddings then match the same weights on the CPU.
    The same comparison with TF32 convolutions allowed misses the limit."""
    overrides = ZOO_CASES["cnn"][0]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    model = _c5_model(card, 256, overrides).eval()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    cpu = _c5_model(torch.device("cpu"), 256, overrides).eval()
    cpu.load_state_dict(model.state_dict())
    feats, lengths, _labels = _c5_batch(card, seq=512)
    with torch.inference_mode():
        want = cpu.encode({n: x.cpu() for n, x in feats.items()}, lengths.cpu())

        def err():
            got = model.encode(feats, lengths)
            return max((got[n].cpu() - w).abs().max().item() / w.abs().max().item()
                       for n, w in want.items())

        e_f32 = err()
        torch.backends.cudnn.allow_tf32 = True
        try:
            e_tf32 = err()
        finally:
            pin_float32()
    print(f"cnn encoders, card vs cpu: f32 {e_f32:.3e}, tf32 convolutions {e_tf32:.3e}")
    assert e_f32 < CNN_CPU_TOL < e_tf32


# ---- bf16 (mixed_precision): the bf16-operand entries of rows 1, 2, 12-15 ----

# an output rounded to bf16 may round the other way where the kernel's f32 sum
# and the twin's straddle a rounding boundary: one bf16 ulp, at most 2^-7 of
# the largest magnitude, plus the f32 sums' own order
BF16_TOL = 1e-2


# the packed backward's bf16 entry against the f32 entry on f32 copies: the
# share of dqkv's entries that may round to another bf16 value (each within
# one bf16 step); the CPU emulation of its scheme gives ~2e-4
BWD_GATE_SHARE = 1e-3


def _bf16_qkv(g, batch, seq, heads, hd, card):
    return torch.randn(batch, seq, 3 * heads * hd, generator=g).to(torch.bfloat16).to(card)


@pytest.mark.parametrize("seq,hd", [(512, 64), (72, 16), (72, 32), (40, 128)])
def test_packed_attention_bf16_entries_match_twins(card, seq, hd):
    g = torch.Generator().manual_seed(200 + seq + hd)
    heads = 4
    qkv = _bf16_qkv(g, 4, seq, heads, hd, card)
    lengths = torch.tensor([0, seq, 37 % seq, seq - 7], dtype=torch.int32, device=card)
    before = (ta.packed_attention_fwd_bf16.launches, ta.packed_attention_bwd_bf16.launches,
              ta.packed_attention_fwd.launches, ta.packed_attention_bwd.launches)
    out, lse = ta.packed_attention_fwd_bf16(qkv, lengths, heads, hd**-0.5)
    ref_out, ref_lse = ta.packed_attention_bf16_reference(qkv, lengths, heads, hd**-0.5)
    # the twin is the f32 arithmetic on the bf16 values: f32's limits
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    dout = torch.randn(out.shape, generator=g).to(torch.bfloat16).float().to(card)
    got = ta.packed_attention_bwd_bf16(qkv, lengths, ref_out, ref_lse, dout, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert (ta.packed_attention_fwd_bf16.launches, ta.packed_attention_bwd_bf16.launches,
            ta.packed_attention_fwd.launches, ta.packed_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    want = ta.packed_attention_bwd_bf16_reference(qkv, lengths, ref_out, ref_lse, dout, heads,
                                                  hd**-0.5)
    assert _rel_err(got.float(), want.float()) < BF16_TOL
    assert torch.all(out[0] == 0) and torch.all(got[0] == 0)


@pytest.mark.parametrize("seq,hd", [(512, 64), (72, 32)])
def test_packed_attention_bf16_entries_are_the_f32_entries_on_f32_copies(card, seq, hd):
    # one function: the f32 kernel's sums on the bf16 values. Both bf16
    # entries run on wgmma with their f32 operands split into bf16 terms,
    # their own sums: the forward within f32's limits of the f32 entry, the
    # backward's dqkv within one bf16 step of the f32 entry's rounded
    # (bf16_steps_from: the step at no less than 2^-10 of the largest
    # magnitude of the call's dq, dk or dv) in all but BWD_GATE_SHARE of its
    # entries, where a scheme with one bf16 term an operand moves a quarter
    g = torch.Generator().manual_seed(300 + seq)
    heads = 4
    qkv = _bf16_qkv(g, 4, seq, heads, hd, card)
    lengths = torch.tensor([5, seq, 37 % seq, seq - 7], dtype=torch.int32, device=card)
    out, lse = ta.packed_attention_fwd_bf16(qkv, lengths, heads, hd**-0.5)
    f_out, f_lse = ta.packed_attention_fwd(qkv.float(), lengths, heads, hd**-0.5)
    dout = torch.randn(out.shape, generator=g).to(torch.bfloat16).float().to(card)
    got = ta.packed_attention_bwd_bf16(qkv, lengths, f_out, f_lse, dout, heads, hd**-0.5)
    f_got = ta.packed_attention_bwd(qkv.float(), lengths, f_out, f_lse, dout, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    steps = ta.bf16_steps_from(got.cpu(), f_got.cpu())
    assert steps.max() <= 1 and (steps >= 0.5).float().mean() <= BWD_GATE_SHARE
    torch.testing.assert_close(out, f_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, f_lse, rtol=1e-5, atol=1e-5)


def _bf16_ln_args(family, g, n, d, f, keep, card, dv=None):
    """A bf16 residual-LN pair's arguments and a cotangent; with ``dv``, the
    model width dv run at the built width d: zero past dv in every axis of
    width d (the LayerNorm's scale and offset too)."""
    w, fmask, rmask = _ln_inputs(g, n, d, f, keep, card)
    bf = torch.bfloat16
    cut = torch.ones(d, device=card)
    if dv is not None:
        cut[dv:] = 0.0

    def v(*shape, scale=1.0):
        t = w(*shape, scale=scale)
        for axis, size in enumerate(shape):
            if size == d and dv is not None:
                t = t * cut.reshape([-1 if i == axis else 1 for i in range(len(shape))])
        return t.contiguous()

    if family == "proj_ln":
        return (v(n, d).to(bf), v(n, d).to(bf), v(d, d, scale=d**-0.5).to(bf), v(d, scale=0.1),
                (1 + w(d, scale=0.1)) * cut, v(d, scale=0.1), rmask), v(n, d).to(bf)
    return (v(n, d).to(bf), v(d, f, scale=d**-0.5).to(bf), w(f, scale=0.1),
            v(f, d, scale=f**-0.5).to(bf), v(d, scale=0.1), (1 + w(d, scale=0.1)) * cut,
            v(d, scale=0.1), fmask, rmask), v(n, d).to(bf)


@pytest.mark.parametrize("family,n,d,keep,dv", [("proj_ln", 1000, 256, 0.8, None),
                                                ("proj_ln", 37, 64, None, None),
                                                ("ffw_ln", 300, 256, 0.8, None),
                                                ("ffw_ln", 100, 64, 0.0, None),
                                                ("ffw_ln", 333, 32, 0.8, None),
                                                ("ffw_ln", 257, 128, None, None),
                                                ("ffw_ln", 301, 256, 0.8, 192)])
def test_residual_ln_bf16_entries_match_twins(card, family, n, d, keep, dv):
    g = torch.Generator().manual_seed(400 + n)
    f = 2048 if d == 256 else 128
    args, dout = _bf16_ln_args(family, g, n, d, f, keep, card, dv)
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    fwd, bwd = getattr(tm, f"{family}_fwd_bf16"), getattr(tm, f"{family}_bwd_bf16")
    before = (fwd.launches, bwd.launches)
    out = fwd(*args, inv_keep, 1e-6, d_valid=dv)
    grads = bwd(*args, dout, inv_keep, 1e-6, d_valid=dv)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16
    want_out = getattr(tm, f"{family}_fwd_bf16_reference")(*args, inv_keep, 1e-6, d_valid=dv)
    assert _rel_err(out.float(), want_out.float()) < BF16_TOL
    if dv is not None:  # nothing written past the model width
        assert torch.all(out[:, dv:] == 0) and torch.all(grads[0][:, dv:] == 0)
    if family == "ffw_ln":
        # on the forward kernel's ReLU branches (a pre within rounding of zero
        # may take the other one in the twin's f32 product)
        xf, w1f = args[0].float(), args[1].float()
        _o, hd = tm._ffw_ln_fwd_launch(*args, inv_keep, 1e-6, dv)
        pre = xf @ w1f + args[2]
        kept = torch.ones_like(pre, dtype=torch.bool) if args[7] is None else args[7].bool()
        live = torch.where(kept & (inv_keep != 0.0), hd.float() > 0, pre > 0)
        want = tm._ffw_ln_bwd_bf16_plain(xf, w1f, pre, live, args[3].float(), args[4], args[5],
                                         args[7], args[8], dout.float(), inv_keep, 1e-6, dv)
    else:
        want = tm.proj_ln_bwd_bf16_reference(*args, dout, inv_keep, 1e-6, d_valid=dv)
    for got, ref in zip(grads, want):
        assert got.dtype == ref.dtype
        if keep == 0.0 and not ref.abs().max() > 0:
            assert torch.all(got == 0)
        else:
            assert _rel_err(got.float(), ref.float()) < BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ffw_ln_forward_and_backward_normalise_one_y(card, dtype):
    """The FFW residual-LN forward and its backward compute y = hd W2 on one
    body from one hidden kernel's hd (the f32 pair's LnProduct, the bf16
    pair's wgmma_ffw.cuh wg_y_rows), so the backward's xhat is the
    forward's. With gamma 1, beta 0 and a cotangent whose column c holds a
    single 1, at row n_c, dgamma[c] is exactly the backward's xhat[n_c, c],
    and the forward's out[n_c, c] is its own xhat there. Exact for the f32
    pair; for the bf16 pair weak (out is rounded to bf16, which hides a
    last-bit difference in y, so a forward on another product would most
    likely pass too): the CPU scheme test
    (test_torch_port_bf16.py, test_ffw_ln_bf16_forward_and_backward_take_one_y)
    and the shared body are what prove the one product."""
    n, d, f = 1000, 256, 2048
    g = torch.Generator().manual_seed(61)
    w, fmask, rmask = _ln_inputs(g, n, d, f, 0.8, card)
    args = (w(n, d).to(dtype), w(d, f, scale=d**-0.5).to(dtype), w(f, scale=0.1),
            w(f, d, scale=f**-0.5).to(dtype), w(d, scale=0.1), torch.ones(d, device=card),
            torch.zeros(d, device=card), fmask, rmask)
    cols = torch.arange(d, device=card)
    rows = (7 + 3 * cols) % n  # a distinct row for each column
    dout = torch.zeros(n, d, device=card, dtype=dtype)
    dout[rows, cols] = 1.0
    bf16 = dtype == torch.bfloat16
    fwd, bwd = ((tm.ffw_ln_fwd_bf16, tm.ffw_ln_bwd_bf16) if bf16
                else (tm.ffw_ln_fwd, tm.ffw_ln_bwd))
    inv_keep = tm._inv_keep(0.8)
    out = fwd(*args, inv_keep, 1e-6)
    dgamma = bwd(*args, dout, inv_keep, 1e-6)[5]
    torch.cuda.synchronize()
    assert out.dtype == dtype and dgamma.dtype == torch.float32
    assert torch.equal(out[rows, cols], dgamma.to(dtype))


# the FFW bf16 entries against their emulated scheme on inputs where each
# rounding point matters: the hidden is exact before its rounding, so its bits
# are the scheme's; an output rounded to bf16 may round the other way only
# where the kernel's f32 LayerNorm and its sums straddle a boundary (rare: a
# few f32 ulps of 2^8 in each bf16 step), while an entry that left out the
# hidden's, dy's or dpre's rounding would move a quarter or more of them
SCHEME_SHARE = 1e-3


def test_ffw_ln_bf16_entries_round_where_their_scheme_rounds(card):
    args, dout, inv_keep = exact_ffw_ln_case()
    f32 = [t.float() if t.dtype == torch.bfloat16 else t for t in args]
    out_s, grads_s = _ffw_ln_bf16(*f32, dout.float(), inv_keep, 1e-6)
    want = [t.to(torch.bfloat16) for t in (out_s, grads_s[0], grads_s[1], grads_s[3])]
    hidden = ffw_ln_scheme_hidden(args[0], args[1], args[2], args[7], inv_keep)
    live = hidden.float() > 0
    lost = (hidden.float() != torch.relu(f32[0] @ f32[1] + f32[2]) * args[7] * inv_keep)[live]
    assert lost.float().mean() > 0.5  # the hidden's rounding matters here
    on_card = [t.to(card) for t in args[:7]] + [m.to(card) for m in args[7:]]
    out, hd_fwd = tm._ffw_ln_fwd_launch(*on_card, inv_keep, 1e-6)
    grads, hd_bwd = tm._ffw_ln_bwd_launch(*on_card, dout.to(card), inv_keep, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(hd_fwd.cpu(), hidden) and torch.equal(hd_bwd.cpu(), hidden)
    got = [t.cpu() for t in (out, grads[0], grads[1], grads[3])]
    for name, a, b in zip(("out", "dx", "dW1", "dW2"), got, want):
        apart = bf16_ulps_apart(a, b)
        assert apart.max() <= 1, name
        assert (apart > 0).float().mean() <= SCHEME_SHARE, name
    for skip, moved in (("hidden", (0, 1, 2, 3)), ("dy", (1, 2, 3)), ("dpre", (1, 2))):
        out_v, grads_v = _ffw_ln_bf16(*f32, dout.float(), inv_keep, 1e-6, skip=(skip,))
        variant = [t.to(torch.bfloat16) for t in (out_v, grads_v[0], grads_v[1], grads_v[3])]
        for i in moved:
            assert (variant[i] != want[i]).float().mean() > 0.25, (skip, i)


def _bf16_mlp_args(g, n, d, f, keep, card):
    w, mask, _rmask = _ln_inputs(g, n, d, f, keep, card)
    bf = torch.bfloat16
    return (w(n, d).to(bf), w(d, f, scale=d**-0.5).to(bf), w(f, scale=0.1),
            w(f, d, scale=f**-0.5).to(bf), w(d, scale=0.1), mask), w(n, d).to(bf)


@pytest.mark.parametrize("n,d,f,keep", [(300, 256, 2048, 0.8), (37, 256, 2048, None),
                                        (100, 64, 128, 0.0), (1000, 32, 64, 0.8),
                                        (257, 128, 128, 0.8)])
def test_fused_mlp_bf16_entries_match_twins_and_repeat(card, n, d, f, keep):
    """Rows 10b-11b: the feed-forward pair's bf16 entries against their twins
    (the backward on the forward kernel's ReLU branches), one launch each,
    twice bit for bit; the forward's hidden is the backward's."""
    g = torch.Generator().manual_seed(700 + n)
    args, dout = _bf16_mlp_args(g, n, d, f, keep, card)
    x, w1, b1, w2, b2, mask = args
    inv_keep = tm._inv_keep(1.0 if keep is None else keep)
    before = (tm.fused_mlp_fwd_bf16.launches, tm.fused_mlp_bwd_bf16.launches)
    out = tm.fused_mlp_fwd_bf16(*args, inv_keep)
    grads = tm.fused_mlp_bwd_bf16(x, w1, b1, w2, mask, dout, inv_keep)
    torch.cuda.synchronize()
    assert (tm.fused_mlp_fwd_bf16.launches, tm.fused_mlp_bwd_bf16.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16
    assert _rel_err(out.float(), tm.fused_mlp_fwd_bf16_reference(*args, inv_keep).float()) < BF16_TOL
    _o, hd_fwd = tm._fused_mlp_fwd_launch(*args, inv_keep)
    again, hd_bwd = tm._fused_mlp_bwd_launch(x, w1, b1, w2, mask, dout, inv_keep)
    torch.cuda.synchronize()
    assert torch.equal(hd_fwd, hd_bwd) and torch.equal(_o, out)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    xf, w1f = x.float(), w1.float()
    pre = xf @ w1f + b1
    kept = torch.ones_like(pre, dtype=torch.bool) if mask is None else mask.bool()
    live = torch.where(kept & (inv_keep != 0.0), hd_fwd.float() > 0, pre > 0)
    want = tm._fused_mlp_bwd_bf16_plain(xf, w1f, pre, live, w2.float(), mask, dout.float(),
                                        inv_keep)
    for got, ref in zip(grads, want):
        assert got.dtype == ref.dtype
        if keep == 0.0 and not ref.abs().max() > 0:
            assert torch.all(got == 0)
        else:
            assert _rel_err(got.float(), ref.float()) < BF16_TOL


def test_fused_mlp_bf16_entries_round_where_their_scheme_rounds(card):
    """On exact-sum inputs the feed-forward pair's bf16 entries give the
    scheme's hidden bit for bit and out, dx, dW1, dW2 within one bf16 step in
    at most SCHEME_SHARE of the entries, where an entry that left out the
    forward's or the backward's rounding of the hidden, or dpre's, would
    move a quarter or more of the entries it feeds."""
    args, dout, inv_keep = exact_fused_mlp_case()
    x, w1, b1, w2, b2, mask = args
    f32 = [t.float() if t.dtype == torch.bfloat16 else t for t in args]
    out_s, grads_s = _fused_mlp_bf16(*f32, dout.float(), inv_keep)
    want = [t.to(torch.bfloat16) for t in (out_s, grads_s[0], grads_s[1], grads_s[3])]
    hidden = ffw_ln_scheme_hidden(x, w1, b1, mask, inv_keep)
    on_card = [t.to(card) for t in args]
    out, hd_fwd = tm._fused_mlp_fwd_launch(*on_card, inv_keep)
    grads, hd_bwd = tm._fused_mlp_bwd_launch(*on_card[:4], on_card[5], dout.to(card), inv_keep)
    torch.cuda.synchronize()
    assert torch.equal(hd_fwd.cpu(), hidden) and torch.equal(hd_bwd.cpu(), hidden)
    got = [t.cpu() for t in (out, grads[0], grads[1], grads[3])]
    for name, a, b in zip(("out", "dx", "dW1", "dW2"), got, want):
        apart = bf16_ulps_apart(a, b)
        assert apart.max() <= 1, name
        assert (apart > 0).float().mean() <= SCHEME_SHARE, name
    for skip, moved in (("hidden", (0,)), ("hd", (3,)), ("dpre", (1, 2))):
        out_v, grads_v = _fused_mlp_bf16(*f32, dout.float(), inv_keep, skip=(skip,))
        variant = [t.to(torch.bfloat16) for t in (out_v, grads_v[0], grads_v[1], grads_v[3])]
        for i in moved:
            assert (variant[i] != want[i]).float().mean() > 0.25, (skip, i)


def test_bf16_entries_repeat_bit_for_bit_and_f32_entries_refuse_bf16(card):
    g = torch.Generator().manual_seed(57)
    for family in ("proj_ln", "ffw_ln"):
        args, dout = _bf16_ln_args(family, g, 1000, 256, 2048, 0.8, card)
        bwd = getattr(tm, f"{family}_bwd_bf16")
        first, second = bwd(*args, dout, 1.25, 1e-6), bwd(*args, dout, 1.25, 1e-6)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        with pytest.raises(TypeError, match="float32"):
            getattr(tm, f"{family}_fwd")(*args, 1.25, 1e-6)
    qkv = _bf16_qkv(g, 2, 64, 4, 64, card)
    lengths = torch.full((2,), 64, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="float32"):
        ta.packed_attention_fwd(qkv, lengths, 4, 0.125)
    with pytest.raises(TypeError, match="bfloat16"):
        ta.packed_attention_fwd_bf16(qkv.float(), lengths, 4, 0.125)


def test_resolving_the_card_sums_bf16_products_in_f32(card):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.device import (
        resolve_device,
    )

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    assert resolve_device(None).type == "cuda"
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


# ---- the MoE layer and training.remat -------------------------------------------


def test_moe_layer_kernel_path_matches_plain_path(card):
    """A transformer layer with the MoE feed-forward (4 experts, top 2) in
    training at dropout 0: the kernel path (packed attention, the projection
    residual-LN pair; no FFW kernel) against the same layer with the kernel
    flags off, output and every gradient at the f32 limits."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.encoders import (
        TransformerEncoderLayer,
    )

    g = torch.Generator().manual_seed(31)
    layers = {}
    # the dense weights take PyTorch's default init from the global
    # generator: seeded here, so they do not depend on the tests run before
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        for path, on in (("kernels", True), ("plain", False)):
            layers[path] = TransformerEncoderLayer(
                256, 4, use_flash=on, dropout=0.0, use_fused_mlp=on, use_fused_mlp_ln=on,
                moe_experts=4, moe_top_k=2)
    layers["kernels"].moe.init_parameters(torch.Generator().manual_seed(5))
    layers["plain"].load_state_dict(layers["kernels"].state_dict())
    x = torch.randn(8, 128, 256, generator=g).to(card)
    dout = torch.randn(8, 128, 256, generator=g).to(card)
    valid = (torch.arange(128)[None, :] < torch.tensor([128, 1, 37, 0, 127, 64, 128, 9])[:, None])
    results, routed = {}, {}
    for path, layer in layers.items():
        layer.to(card)
        leaf = x.clone().requires_grad_()
        layer.moe.register_forward_pre_hook(
            lambda m, args, path=path: routed.__setitem__(path, args[0].detach()))

        def step():
            aux = []
            out = layer(leaf, key_padding_mask=valid.to(card), train=True, aux_losses=aux)
            ((out * dout).sum() + aux[0]).backward()
            return out

        out, launches = _counted(step)
        results[path] = (out, leaf.grad, [p.grad for p in layer.parameters()], launches)
    (out_k, dx_k, grads_k, launches), (out_p, dx_p, grads_p, none) = (
        results["kernels"], results["plain"])
    assert launches == {"packed_attention_fwd": 1, "packed_attention_bwd": 1, "proj_ln_fwd": 1,
                        "proj_ln_bwd": 1}
    assert none == {}
    assert _rel_err(out_k, out_p) < 1e-4
    # floored at 1e-3 of the largest gradient: the key-projection biases'
    # gradients are zero up to rounding (PERF.md section 2)
    floor = 1e-3 * max(g.abs().max().item() for g in [dx_p, *grads_p])
    for got, want in zip([dx_k, *grads_k], [dx_p, *grads_p]):
        assert (got - want).abs().max().item() / max(want.abs().max().item(), floor) \
            < TRAIN_LAYER_TOL, _routing_report(layers["plain"].moe, routed, valid.to(card))


def _routing_report(moe, routed, valid):
    """What a failure of the MoE layer test needs: the tokens whose top-k
    experts differ between the two paths' MoE inputs, and the smallest gap
    between neighbouring probabilities among the top k + 1 of a valid token
    (a near tie that the paths' rounding can flip)."""
    live = valid.reshape(-1)
    top = {}
    for path, h in routed.items():
        probs = torch.softmax(h.reshape(-1, h.shape[-1]).float() @ moe.router, dim=-1)
        top[path] = torch.sort(probs, dim=-1, descending=True, stable=True)
    sorted_p, experts = top["plain"]
    k = moe.top_k
    flips = ((experts[:, :k] != top["kernels"][1][:, :k]).any(1) & live).sum().item()
    gaps = (sorted_p[:, :k] - sorted_p[:, 1:k + 1])[live]
    return (f"routing: {flips} valid tokens take other experts on the kernel path; "
            f"smallest top-{k + 1} gap {gaps.min().item():.3e}")


# a layer's gradients, kernel path against plain path: the MoE routing takes
# the attention's output, whose f32 sums differ in order; the gradients
# through the router and the gates carry that difference
TRAIN_LAYER_TOL = 1e-3


def test_remat_on_the_card_repeats_bit_for_bit(card):
    """``training.remat`` on the card at dropout 0.2 (the mask kernel's
    masks) through the default kernel route: the loss and every gradient of
    two micro-steps equal the run without it bit for bit, and each forward
    kernel (the attention forward, both residual-LN forwards, the masks)
    launches twice a micro-step."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    base = Path(__file__).resolve().parent.parent / "config" / "base.yaml"
    feats, lengths, labels = _c5_batch(card, batch=8, seq=128)
    mask = torch.ones((8, 4), device=card)
    runs = {}
    for remat in ("false", "true"):
        cfg = load_config(base, ["model.hidden_dim=256", f"training.remat={remat}"])
        trainer = tt.Trainer(cfg, device=card)
        steps = []
        for _ in range(2):
            (loss, _acc, grads), launches = _counted(lambda: trainer.loss_and_grads(
                feats, labels, mask, lengths, torch.ones(8, device=card)))
            steps.append((loss, [g.clone() for g in grads], launches))
        runs[remat] = steps
    for (loss_a, grads_a, l_a), (loss_b, grads_b, l_b) in zip(runs["false"], runs["true"]):
        assert torch.equal(loss_a, loss_b)
        assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
        assert l_b == {k: (2 * v if k.endswith("_fwd") else v) for k, v in l_a.items()}


# case -> (overrides of base.yaml, launches of one request): the bundle's graph
# launches the kernels make_serving_fn launches
BUNDLE_CASES = {
    "flagship": ([], {"packed_attention_fwd": 4, "fused_hybrid_head": 1}),
    "late": (["model.fusion_type=late"], {"packed_attention_fwd": 4}),
    "lstm": ([f"model.encoders.{n}.encoder_type=lstm" for n in C5_NAMES],
             {"grouped_lstm_fused": 1, "fused_hybrid_head": 1}),
}


@pytest.mark.parametrize("case", sorted(BUNDLE_CASES))
def test_bundle_on_the_card_equals_make_serving_fn_and_launches_the_kernels(card, case,
                                                                          tmp_path):
    """base.yaml at full width (hidden 256) exported on the card and loaded
    back: the loaded graph's logits equal ``make_serving_fn``'s bit for bit,
    and one request launches the same kernels, counted at run time."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import (
        export_serving_bundle,
        load_serving_bundle,
        make_serving_fn,
    )

    overrides, want = BUNDLE_CASES[case]
    model = _c5_model(card, 256, overrides)
    feats, lengths, _labels = _c5_batch(card)
    export_serving_bundle(model, tmp_path, 8, 64, dict(zip(C5_NAMES, C5_DIMS)), device=card)
    fn, meta = load_serving_bundle(tmp_path, device=card)
    assert meta["device"] == "cuda" and set(meta["ops"]) == set(want)
    serve = make_serving_fn(model, device=card)
    expected, served = _counted_all(lambda: serve(feats, None, lengths))
    got, launches = _counted_all(lambda: fn(feats, None, lengths))
    assert served == launches == want
    assert torch.equal(got, expected) and torch.isfinite(got).all()


def test_bundle_exported_on_the_cpu_serves_on_the_card_through_the_kernels(card, tmp_path):
    """A bundle traced on the CPU and loaded onto the card (its graph moved)
    launches the kernels and gives ``make_serving_fn``'s logits on the card."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import (
        export_serving_bundle,
        load_serving_bundle,
        make_serving_fn,
    )

    model = _c5_model(card, 256)
    feats, lengths, _labels = _c5_batch(card)
    export_serving_bundle(model.cpu(), tmp_path, 8, 64, dict(zip(C5_NAMES, C5_DIMS)),
                          device="cpu")
    fn, meta = load_serving_bundle(tmp_path, device=card)
    assert meta["device"] == "cpu"
    expected, served = _counted_all(lambda: make_serving_fn(model, device=card)(feats, None,
                                                                                lengths))
    got, launches = _counted_all(lambda: fn(feats, None, lengths))
    assert launches == served == BUNDLE_CASES["flagship"][1]
    assert torch.equal(got, expected)


def _counted_all(fn):
    """``_counted`` over the serving kernels, the recurrences included."""
    kernels = (ta.packed_attention_fwd, ta.flash_fwd_single, ta.flash_fwd_tiled,
               tf.fused_hybrid_head, tr.grouped_lstm_fused, tr.grouped_gru_fused)
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels if k.launches}


def test_streamed_epoch_on_the_card_equals_the_resident_epoch(card, tmp_path):
    """One epoch of ``Trainer.fit`` on synthetic windows at base.yaml's
    width (batch 8, the last batch padded, base.yaml's dropout and
    augmentations on): with ``dataset.streaming=true`` the history and every weight equal
    the resident epoch's bit for bit."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        create_datasets,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    base = Path(__file__).resolve().parent.parent / "config" / "base.yaml"
    train_w, val_w, _ = create_datasets("synthetic", ".", list(C5_NAMES), num_samples=60,
                                        num_classes=25, sequence_length=64, modality_dim=17,
                                        seed=3)
    for w in (train_w, val_w):  # heart_rate is one feature wide
        w.features["heart_rate"] = w.features["heart_rate"][..., :1].copy()
    runs = []
    for streaming in ("false", "true"):
        cfg = load_config(base, ["training.max_epochs=1", "dataset.batch_size=8",
                                 f"dataset.streaming={streaming}"])
        trainer = tt.Trainer(cfg, device=card)
        results = trainer.fit(train_w, val_w, save_dir=tmp_path / streaming, log_fn=None)
        runs.append((results["history"], trainer.model.state_dict()))
    (hist_r, state_r), (hist_s, state_s) = runs
    assert hist_s == hist_r
    assert all(torch.equal(state_s[k], v) for k, v in state_r.items())


_TP_WORLD = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel import comm
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel.mesh import (
    activation_mesh, local_slice, make_mesh)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel.tp_kernels import (
    tp_fused_mlp)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.device import pin_float32

rank = {rank}
pin_float32()
dist.init_process_group("gloo", store=dist.FileStore({store!r}, 2), rank=rank, world_size=2)
mesh = make_mesh(2, model_parallel=2).init_groups()
g = torch.Generator().manual_seed(0)
x = torch.randn(4096, 256, generator=g).cuda().requires_grad_(True)
w1 = (torch.randn(256, 2048, generator=g) / 16).cuda()
b1 = (torch.randn(2048, generator=g) / 16).cuda()
w2 = (torch.randn(2048, 256, generator=g) / 45).cuda()
b2 = (torch.randn(256, generator=g) / 16).cuda()
mask = (torch.rand(4096, 2048, generator=g) < 0.8).cuda()
dout = torch.randn(4096, 256, generator=g).cuda()
shards = [local_slice(w1, (None, "model"), mesh).clone().requires_grad_(True),
          local_slice(b1, ("model",), mesh).clone().requires_grad_(True),
          local_slice(w2, ("model", None), mesh).clone().requires_grad_(True),
          b2.clone().requires_grad_(True)]
before = mlp.fused_mlp_fwd.launches, mlp.fused_mlp_bwd.launches
with activation_mesh(mesh):
    out = tp_fused_mlp(mesh, x, *shards, keep_mask=mask, keep_prob=0.8)
(out * dout).sum().backward()
torch.cuda.synchronize()
launched = (mlp.fused_mlp_fwd.launches - before[0], mlp.fused_mlp_bwd.launches - before[1])
# the collectives gloo has no CUDA path for, staged through the host
y = torch.full((3,), float(rank), device="cuda")
gathered = comm.all_gather(y, 0, mesh.group("model"))
scattered = comm.reduce_scatter(torch.arange(4.0, device="cuda"), 0, mesh.group("model"))
if rank == 0:
    comm.send(y + 7, 1, tag=5)
    got = y
else:
    got = comm.recv(y, 0, tag=5)
torch.save({{"out": out.detach().cpu(), "dx": x.grad.cpu(),
             "grads": [s.grad.cpu() for s in shards], "launched": launched,
             "gathered": gathered.cpu(), "scattered": scattered.cpu(), "recv": got.cpu(),
             "backend": comm.group_backend()}}, {out!r})
dist.destroy_process_group()
"""


def test_tp_fused_mlp_on_two_ranks_of_the_card_matches_fused_mlp(card, tmp_path):
    """Two gloo ranks on the one card: each runs the fused_mlp pair on its
    F = 1024 slice; the summed output and the gradients against one
    fused_mlp over F = 2048 on the same card; gloo's host-staged collectives
    on CUDA tensors."""
    import subprocess
    import sys

    repo = str(Path(__file__).resolve().parent.parent)
    procs = [subprocess.Popen([sys.executable, "-c", _TP_WORLD.format(
        repo=repo, rank=r, store=str(tmp_path / "store"), out=str(tmp_path / f"r{r}.pt"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the 2-rank world did not finish in 300 s")
        assert p.returncode == 0, log.decode()[-3000:]
    ranks = [torch.load(tmp_path / f"r{r}.pt") for r in range(2)]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, 256, generator=g).to(card).requires_grad_(True)
    w1 = (torch.randn(256, 2048, generator=g) / 16).to(card).requires_grad_(True)
    b1 = (torch.randn(2048, generator=g) / 16).to(card).requires_grad_(True)
    w2 = (torch.randn(2048, 256, generator=g) / 45).to(card).requires_grad_(True)
    b2 = (torch.randn(256, generator=g) / 16).to(card).requires_grad_(True)
    mask = (torch.rand(4096, 2048, generator=g) < 0.8).to(card)
    dout = torch.randn(4096, 256, generator=g).to(card)
    want = tm.fused_mlp(x, w1, b1, w2, b2, mask, 0.8)
    (want * dout).sum().backward()
    for r in ranks:
        assert r["backend"] == "gloo" and r["launched"] == (1, 1)
        scale = want.abs().max().item()
        assert (r["out"] - want.cpu()).abs().max().item() <= 1e-5 * scale
        assert (r["dx"] - x.grad.cpu()).abs().max().item() <= 1e-4 * x.grad.abs().max().item()
    got = {"w1": torch.cat([r["grads"][0] for r in ranks], 1),
           "b1": torch.cat([r["grads"][1] for r in ranks]),
           "w2": torch.cat([r["grads"][2] for r in ranks]), "b2": ranks[0]["grads"][3]}
    for name, ref in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        err = (got[name] - ref.grad.cpu()).abs().max().item() / ref.grad.abs().max().item()
        assert err <= 1e-4, name
    assert ranks[0]["gathered"].tolist() == [0.0] * 3 + [1.0] * 3
    assert [r["scattered"].tolist() for r in ranks] == [[0.0, 2.0], [4.0, 6.0]]
    assert ranks[1]["recv"].tolist() == [7.0] * 3
