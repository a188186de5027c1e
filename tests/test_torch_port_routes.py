"""The port's kernel routes by model width, on the CPU.

Each kernel family takes only the widths it is built for, so the model picks
its path by a plain function of its widths, decided before any launch:

- ``ops.attention.attention_route`` on head_dim: the packed and flash
  kernels at ``kernel_head_dim`` (q, k and v padded with zero columns), the
  layer's own softmax above the kernels' largest head_dim;
- ``ops.mlp.mlp_route`` on d_model: the feed-forward pair and the
  residual-LN kernels up to the widest built width, x and the weights padded
  with zero columns (d_ff to a multiple of 64), the LayerNorm's statistics
  over the true d_model;

The fused head takes every width (``csrc/fusion_head.cu`` stages K in slabs
and reads device memory where a block's operands exceed shared memory), an
H that is not a multiple of 4 padded with zeros.

The padding must leave the function as it is: each padded entry point is
held here to its plain version at the unpadded width (values and
gradients), the packed attention also to the JAX package's
``flash_mha_packed`` in interpret mode, and a transformer layer with the
kernels on to the same layer with them off, at widths on both sides of each
route. On the CPU the wrappers take their plain versions, so what runs here
is the routing and the padding; ``tests/test_torch_port_cuda.py`` serves and
trains at ``model.hidden_dim`` 192 and 640 on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_attention as jpa
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as tenc
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.fusion import HybridFusion
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion as tf
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm

# f32 both sides; the padded product adds exact zeros, but a wider matmul
# may sum in another order
TOL = dict(rtol=1e-5, atol=2e-6)
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")


def test_attention_route_pads_every_head_dim_up_to_the_kernels_largest():
    assert ta.KERNEL_HEAD_DIMS == (16, 32, 64, 128)
    assert [ta.kernel_head_dim(d) for d in (1, 8, 16, 17, 48, 64, 65, 128)] == \
        [16, 16, 16, 32, 64, 64, 128, 128]
    assert [ta.attention_route(d) for d in (1, 12, 48, 64, 100, 128)] == ["kernel"] * 6
    assert [ta.attention_route(d) for d in (0, 129, 160, 256)] == ["plain"] * 4
    assert ta.kernel_head_dim(160) is None


def test_residual_ln_route_takes_the_built_widths_only():
    # the built widths run as they are; every other d_model up to the widest
    # runs on them padded (the LayerNorm over the true width)
    assert tm.KERNEL_WIDTHS == (32, 64, 128, 256)
    assert [tm.kernel_width(d) for d in tm.KERNEL_WIDTHS] == list(tm.KERNEL_WIDTHS)
    assert [tm.mlp_route(d) for d in (16, 48, 192, 255)] == ["kernel"] * 4
    assert [tm.mlp_route(d) for d in (320, 640)] == ["plain"] * 2
    assert [tm.ffw_width(f) for f in (1, 64, 100, 2048, 2049)] == [64, 64, 128, 2048, 2112]
    with pytest.raises(ValueError, match="d_valid"):
        tm.proj_ln_fwd(*[torch.zeros(2, 32)] * 2, torch.zeros(32, 32),
                       *[torch.zeros(32)] * 3, None, 1.0, 1e-6, d_valid=33)


def test_fused_mlp_route_pads_up_to_the_widest_built_width():
    assert [tm.mlp_route(d) for d in (1, 16, 48, 192, 256)] == ["kernel"] * 5
    assert [tm.mlp_route(d) for d in (0, 257, 320, 640)] == ["plain"] * 4
    assert [tm.kernel_width(d) for d in (1, 32, 33, 192, 256)] == [32, 32, 64, 256, 256]


def _grads(out, inputs, seed):
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    return torch.autograd.grad(out, inputs, cot)


@pytest.mark.parametrize("heads,hd", [(4, 12), (2, 48)])
def test_packed_attention_at_a_padded_head_dim_is_the_same_function(heads, hd):
    rng = np.random.default_rng(hd)
    seq, lengths = 20, [20, 0, 7, 13]
    qkv = rng.standard_normal((4, seq, 3 * heads * hd)).astype(np.float32)
    want = np.asarray(jpa.flash_mha_packed(jnp.asarray(qkv), jnp.asarray(lengths, jnp.int32),
                                           num_heads=heads, interpret=True))
    x = torch.from_numpy(qkv).requires_grad_()
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = ta.flash_mha_packed(x, lens, num_heads=heads)
    assert got.shape == (4, seq, heads * hd)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert torch.all(got[1] == 0)  # no valid key: exact zeros
    # the gradient against the unpadded plain version
    ref = ta.packed_attention_reference(x, lens, heads, hd**-0.5)[0]
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), **TOL)
    (g_got,), (g_ref,) = _grads(got, [x], 1), _grads(ref, [x], 1)
    np.testing.assert_allclose(g_got.numpy(), g_ref.numpy(), **TOL)


def test_flash_attention_at_a_padded_head_dim_is_the_same_function():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 2, 40, 24, generator=g).requires_grad_() for _ in range(3))
    lengths = torch.tensor([40, 9], dtype=torch.int32)
    got = ta.flash_self_attention(q, k, v, lengths, block_q=16, block_k=16)
    flat = [t.reshape(4, 40, 24) for t in (q, k, v)]
    ref = ta.flash_attention_reference(*flat, lengths, 2, 24**-0.5)[0].reshape(2, 2, 40, 24)
    assert got.shape == (2, 2, 40, 24)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), **TOL)
    for a, b in zip(_grads(got, [q, k, v], 2), _grads(ref, [q, k, v], 2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _ffw_case(n, d, f, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).requires_grad_()
    w1 = (torch.randn(d, f, generator=g) * d**-0.5).requires_grad_()
    b1 = (torch.randn(f, generator=g) * 0.1).requires_grad_()
    w2 = (torch.randn(f, d, generator=g) * f**-0.5).requires_grad_()
    b2 = (torch.randn(d, generator=g) * 0.1).requires_grad_()
    mask = torch.rand(n, f, generator=g) < 0.8
    return x, w1, b1, w2, b2, mask


@pytest.mark.parametrize("d,f", [(48, 100), (192, 2048), (32, 64)])
def test_fused_mlp_at_padded_widths_is_the_same_function(d, f):
    x, w1, b1, w2, b2, mask = _ffw_case(37, d, f, d + f)
    got = tm.fused_mlp(x, w1, b1, w2, b2, mask, 0.8)
    want = tm.transformer_ffw(x[None], {"kernel": w1, "bias": b1}, {"kernel": w2, "bias": b2},
                              mask[None], 0.8, use_fused=False)[0]
    assert got.shape == (37, d)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)
    inputs = [x, w1, b1, w2, b2]
    for a, b in zip(_grads(got, inputs, 3), _grads(want, inputs, 3)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_fused_mlp_residual_ln_at_a_padded_d_ff_is_the_same_function():
    x, w1, b1, w2, b2, fmask = _ffw_case(29, 64, 100, 5)
    g = torch.Generator().manual_seed(6)
    gamma = (1 + 0.1 * torch.randn(64, generator=g)).requires_grad_()
    beta = (0.1 * torch.randn(64, generator=g)).requires_grad_()
    rmask = torch.rand(29, 64, generator=g) < 0.8
    got = tm.fused_mlp_residual_ln(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, 0.8)
    ff = tm.transformer_ffw(x[None], {"kernel": w1, "bias": b1}, {"kernel": w2, "bias": b2},
                            fmask[None], 0.8, use_fused=False)[0]
    want = tm.ln_rows(x + torch.where(rmask, ff / 0.8, 0.0), gamma, beta, 1e-6)[0]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)
    inputs = [x, w1, b1, w2, b2, gamma, beta]
    for a, b in zip(_grads(got, inputs, 7), _grads(want, inputs, 7)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("hidden", [30, 32])
def test_fused_head_at_a_padded_h_is_the_same_function(hidden):
    got, want = _head_and_model(hidden, NAMES, 25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hidden,modalities,classes", [(578, 3, 130), (640, 5, 12)])
def test_fused_head_at_any_width_and_class_count_is_the_same_function(hidden, modalities,
                                                                      classes):
    """Widths above one staged slab (576), padded to a multiple of 4, more
    classes and modalities than PAMAP2's: the head's parameters and entry
    point give the model's own head's logits (to 1e-6 of their largest: they
    reach ~200 at these widths)."""
    got, want = _head_and_model(hidden, tuple(f"m{i}" for i in range(modalities)), classes)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def _head_and_model(hidden, names, classes):
    """The fused head's logits and the model's own head's on the same
    weights and inputs."""
    torch.manual_seed(hidden)
    head = HybridFusion(names, {n: 16 for n in names}, hidden_dim=hidden, num_classes=classes,
                        num_heads=2).eval()
    for p in head.parameters():  # the reference's zero biases would hide a misplaced one
        torch.nn.init.normal_(p, std=0.2)
    params = tf.hybrid_head_params(head)
    width = params.w1.shape[0]
    assert width == -(-hidden // 4) * 4 and params.w2.shape == (width, classes)
    g = torch.Generator().manual_seed(1)
    encoded = {n: torch.randn(6, 16, generator=g) for n in names}
    mask = torch.ones(6, len(names))
    mask[1, 2] = mask[3, :3] = 0.0
    with torch.no_grad():
        got = tf.hybrid_fused_inference(params, encoded, mask, names)
        want = head(encoded, mask)
    return got, want


# head_dim, d_model and d_ff on both sides of each route: (hidden, heads) ->
# the entry points the train-mode layer reaches with every kernel flag on
LN_HALVES = ("fused_proj_residual_ln", "fused_mlp_residual_ln")
LAYER_ROUTES = {
    (64, 4): ("flash_mha_packed", *LN_HALVES),
    (48, 4): ("flash_mha_packed", *LN_HALVES),  # head_dim 12 and d_model 48 padded
    (160, 1): LN_HALVES,  # head_dim 160: plain attention; the halves at 256
    (320, 2): (),  # head_dim 160, d_model above every kernel's widest
}


def _layer_routes(hidden, heads, monkeypatch, ln_kernels=True):
    """The entry points a train-mode layer with the kernel flags on reaches
    (``fused_mlp_ln`` as ``ln_kernels``), after checking that it computes the
    same function (output and every parameter gradient) as the layer with
    the flags off."""
    called = []
    for name in ("flash_mha_packed", "flash_self_attention", "fused_proj_residual_ln",
                 "fused_mlp_residual_ln", "transformer_ffw"):
        fn = getattr(tenc, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            if _name != "transformer_ffw" or kwargs.get("use_fused"):
                called.append(_name)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tenc, name, spy)
    torch.manual_seed(hidden)
    on = tenc.TransformerEncoderLayer(hidden, heads, dim_feedforward=100, use_flash=True,
                                      use_fused_mlp=True, use_fused_mlp_ln=ln_kernels,
                                      dropout=0.0)
    off = tenc.TransformerEncoderLayer(hidden, heads, dim_feedforward=100, dropout=0.0)
    off.load_state_dict(on.state_dict())
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 10, hidden, generator=g)
    valid = torch.ones(3, 10)
    valid[1, 6:] = 0.0
    outs = [layer(x, valid, train=True) for layer in (on, off)]
    np.testing.assert_allclose(outs[0].detach().numpy(), outs[1].detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    grads = [_grads(out, list(layer.parameters()), 4) for out, layer in zip(outs, (on, off))]
    # each gradient to 1e-4 of its largest magnitude, floored at 1e-3 of the
    # layer's largest: the key biases' gradients are zero up to rounding
    floor = 1e-3 * max(b.abs().max().item() for b in grads[1])
    for (name, _p), a, b in zip(on.named_parameters(), *grads):
        assert (a - b).abs().max().item() / max(b.abs().max().item(), floor) < 1e-4, name
    return tuple(called)


@pytest.mark.parametrize("hidden,heads", list(LAYER_ROUTES))
def test_transformer_layer_takes_the_routes_of_its_widths(hidden, heads, monkeypatch):
    """A train-mode layer with every kernel flag on reaches exactly the
    entry points its widths' routes name, and computes the same function
    (output and every parameter gradient) as the layer with the flags off."""
    assert _layer_routes(hidden, heads, monkeypatch) == LAYER_ROUTES[(hidden, heads)]


@pytest.mark.parametrize("hidden,heads,want", [
    (48, 4, ("flash_mha_packed", "transformer_ffw")),
    (160, 1, ("transformer_ffw",)),
    (320, 2, ()),
])
def test_transformer_layer_without_the_ln_kernels_takes_the_fused_mlp_pair(hidden, heads, want,
                                                                           monkeypatch):
    """With ``fused_mlp_ln`` off the feed-forward takes the ``fused_mlp``
    pair wherever ``mlp_route`` names the kernels, padded as the halves are."""
    assert _layer_routes(hidden, heads, monkeypatch, ln_kernels=False) == want


def _same_grads(got, want):
    """Each gradient within 1e-5 of its largest magnitude: the padded
    products sum the same terms in another order."""
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def _ln_case(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    gamma = (1 + 0.1 * torch.randn(d, generator=g)).requires_grad_()
    beta = (0.1 * torch.randn(d, generator=g)).requires_grad_()
    return gamma, beta, torch.rand(n, d, generator=g) < 0.8


@pytest.mark.parametrize("d", [48, 192])
def test_residual_ln_halves_at_a_padded_d_model_are_the_same_function(d):
    """Both halves at a d_model between the built widths run at the next
    one with zero columns and the LayerNorm over the true d: the same values
    and gradients as their plain versions at d, and the wrappers' plain twins
    see the padded width."""
    x, w1, b1, w2, b2, fmask = _ffw_case(23, d, 100, d)
    gamma, beta, rmask = _ln_case(23, d, d + 1)
    g = torch.Generator().manual_seed(d + 2)
    att = torch.randn(23, d, generator=g).requires_grad_()
    wo = (torch.randn(d, d, generator=g) * d**-0.5).requires_grad_()
    bo = (0.1 * torch.randn(d, generator=g)).requires_grad_()
    seen = []
    fwd = tm.proj_ln_fwd

    def spy(x_, *args, **kwargs):
        seen.append((x_.shape[-1], kwargs.get("d_valid", args[-1] if len(args) > 8 else None)))
        return fwd(x_, *args, **kwargs)

    tm.proj_ln_fwd = spy
    try:
        got = tm.fused_proj_residual_ln(x, att, wo, bo, gamma, beta, rmask, 0.8)
    finally:
        tm.proj_ln_fwd = fwd
    assert seen == [(tm.kernel_width(d), d)]
    want = tm.ln_rows(x + torch.where(rmask, (att @ wo + bo) / 0.8, 0.0), gamma, beta, 1e-6)[0]
    assert got.shape == (23, d)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)
    inputs = [x, att, wo, bo, gamma, beta]
    _same_grads(_grads(got, inputs, 8), _grads(want, inputs, 8))
    got = tm.fused_mlp_residual_ln(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, 0.8)
    ff = tm.transformer_ffw(x[None], {"kernel": w1, "bias": b1}, {"kernel": w2, "bias": b2},
                            fmask[None], 0.8, use_fused=False)[0]
    want = tm.ln_rows(x + torch.where(rmask, ff / 0.8, 0.0), gamma, beta, 1e-6)[0]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)
    inputs = [x, w1, b1, w2, b2, gamma, beta]
    _same_grads(_grads(got, inputs, 9), _grads(want, inputs, 9))


def test_residual_ln_twins_write_nothing_past_the_valid_columns():
    """At a padded width the twins of both kernels give zero output and
    zero dx, dgamma, dbeta past ``d_valid``, as the kernels do."""
    n, d, width, f = 9, 40, 64, 64
    x, w1, b1, w2, b2, fmask = (t.detach() for t in _ffw_case(n, d, f, 11))
    gamma, beta, rmask = (t.detach() for t in _ln_case(n, d, 12))

    def cols(t):
        return tm._pad_cols(t, width)

    x, b2, gamma, beta, w2 = cols(x), cols(b2), cols(gamma), cols(beta), cols(w2)
    w1 = cols(w1.t()).t().contiguous()
    rmask = cols(rmask.to(torch.uint8))
    dout = cols(torch.randn(n, d, generator=torch.Generator().manual_seed(13)))
    args = (x, w1, b1, w2, b2, gamma, beta, fmask.to(torch.uint8), rmask)
    out = tm.ffw_ln_fwd(*args, 1.25, 1e-6, d_valid=d)
    dx, _dw1, _db1, _dw2, db2, dgamma, dbeta = tm.ffw_ln_bwd(*args, dout, 1.25, 1e-6, d_valid=d)
    for t in (out, dx, db2, dgamma, dbeta):
        assert torch.all(t[..., d:] == 0)
    wo = cols(cols(torch.eye(d)).t()).t().contiguous()
    out = tm.proj_ln_fwd(x, x, wo, b2, gamma, beta, rmask, 1.25, 1e-6, d_valid=d)
    grads = tm.proj_ln_bwd(x, x, wo, b2, gamma, beta, rmask, dout, 1.25, 1e-6, d_valid=d)
    for t in (out, grads[0], *grads[3:]):
        assert torch.all(t[..., d:] == 0)
