"""PyTorch port, ``flash_self_attention`` (the head-major layout of the long
windows): forward and gradients against the JAX function on each of its
Pallas routes in interpret mode, the port's two layouts against each other,
the shape checks, and the encoder layer and the whole model at a T that
leaves the packed route. The port runs on the CPU, so its wrappers take
their plain versions; the same numpy arrays go to both sides."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.encoders import (
    _TransformerEncoderLayer as JaxLayer,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops import pallas_attention as pa
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops.metrics import (
    cross_entropy_loss as jax_cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
    from_flax_variables,
    to_flax_tree,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as te
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
    cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
# f32 on both sides; the two frameworks sum the products in another order
FWD_TOL = 2e-5  # absolute
BWD_TOL = 2e-5  # of the gradient's largest magnitude
# JAX routes: thresholds pinned through the reference's environment knobs,
# the port's through its keyword arguments
ROUTES = {
    "single": dict(env=("4096", "4096"), block=64, kwargs={}),
    "tiled": dict(env=("0", "0"), block=32,
                  kwargs=dict(block_q=32, block_k=32, single_k_max=0, fused_bwd_max=0)),
}


def _pin(monkeypatch, single_k_max: str, fused_bwd_max: str):
    monkeypatch.setenv("MSFA_FLASH_SINGLE_K_MAX", single_k_max)
    monkeypatch.setenv("MSFA_FLASH_FUSED_BWD_MAX", fused_bwd_max)


def _qkv(seq, hd, seed, batch=2, heads=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, heads, seq, hd)).astype(np.float32) for _ in range(4)]


def _lengths(name, seq):
    return {"none": None, "zero_and_full": np.array([0, seq], np.int32),
            "one_and_ragged": np.array([1, max(seq - 5, 1)], np.int32)}[name]


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("route", ["single", "tiled"])
@pytest.mark.parametrize("lengths", ["none", "zero_and_full", "one_and_ragged"])
@pytest.mark.parametrize("seq,hd", [(24, 16), (64, 64), (100, 16), (100, 64)])
def test_flash_self_attention_forward_matches_jax(monkeypatch, route, lengths, seq, hd):
    """T = 100 is padded by both wrappers (to 128 at block 64, to 128 at
    block 32); at block 32 the tiled route merges 2 to 4 key blocks."""
    spec = ROUTES[route]
    _pin(monkeypatch, *spec["env"])
    q, k, v, _ = _qkv(seq, hd, seed=seq + hd)
    lens = _lengths(lengths, seq)
    block = dict(block_q=spec["block"], block_k=spec["block"])
    want = pa.flash_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens), interpret=True, **block)
    got = ta.flash_self_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if lens is None else torch.from_numpy(lens), **{**block, **spec["kwargs"]})
    assert got.shape == (2, 2, seq, hd)
    assert np.abs(got.numpy() - np.asarray(want)).max() < FWD_TOL
    if lens is not None and lens[0] == 0:
        assert torch.all(got[0] == 0)  # no valid key: exact zeros


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("lengths", ["none", "zero_and_full", "one_and_ragged"])
@pytest.mark.parametrize("seq,hd", [(24, 16), (64, 64), (100, 16)])
def test_flash_self_attention_gradients_match_jax_vjp(monkeypatch, route, lengths, seq, hd):
    spec = ROUTES["single" if route == "fused" else "tiled"]
    _pin(monkeypatch, *spec["env"])
    q, k, v, dout = _qkv(seq, hd, seed=3 + seq + hd)
    lens = _lengths(lengths, seq)
    block = dict(block_q=spec["block"], block_k=spec["block"])
    jl = None if lens is None else jnp.asarray(lens)
    _out, vjp = jax.vjp(
        lambda a, b, c: pa.flash_self_attention(a, b, c, jl, interpret=True, **block),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ta.flash_self_attention(
        *leaves, None if lens is None else torch.from_numpy(lens), **{**block, **spec["kwargs"]})
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip("qkv", got, want):
        assert _rel(g.numpy(), np.asarray(w)) < BWD_TOL, f"d{name}"
        assert torch.isfinite(g).all()
    if lens is not None and lens[0] == 0:
        assert all(torch.all(g[0] == 0) for g in got)  # length 0: zeros, not NaN


@pytest.mark.parametrize("padded,blocks,want", [
    (512, (512, 512), ("single", "fused")), (1024, (512, 512), ("single", "fused")),
    (1536, (512, 512), ("single", "split")), (2048, (512, 512), ("single", "split")),
    (2560, (512, 512), ("tiled", "split")), (4096, (512, 512), ("tiled", "split")),
    (24, (24, 24), ("single", "fused"))])
def test_flash_routes_follow_the_reference_thresholds(monkeypatch, padded, blocks, want):
    monkeypatch.delenv("MSFA_FLASH_SINGLE_K_MAX", raising=False)
    monkeypatch.delenv("MSFA_FLASH_FUSED_BWD_MAX", raising=False)
    assert ta.flash_routes(padded, *blocks) == want
    # the reference's own conditions (_flash_forward, _flash_backward)
    assert (padded <= max(blocks[1], pa._single_k_max())) == (want[0] == "single")
    assert (padded <= max(min(blocks), pa._fused_bwd_max())) == (want[1] == "fused")
    assert (ta.SINGLE_K_MAX, ta.FUSED_BWD_MAX) == (pa._single_k_max(), pa._fused_bwd_max())


# the reference's five routing variables: a value that moves its route, and
# the reference's reading of it
REFERENCE_KNOBS = {
    "MSFA_FLASH_PACKED": ("0", lambda: not pa.packed_route_ok(512, 4, 64)),
    "MSFA_FLASH_PACKED_MAX": ("256", lambda: not pa.packed_route_ok(512, 4, 64)),
    "MSFA_FLASH_SINGLE_K_MAX": ("0", lambda: pa._single_k_max() == 0),
    "MSFA_FLASH_SINGLE_K_BQ": ("128", lambda: pa._env_int("MSFA_FLASH_SINGLE_K_BQ", 512) == 128),
    "MSFA_FLASH_FUSED_BWD_MAX": ("4096", lambda: pa._fused_bwd_max() == 4096),
}


@pytest.mark.parametrize("name", sorted(REFERENCE_KNOBS))
def test_flash_routes_ignore_the_reference_environment_variables(monkeypatch, name):
    # the port reads none of them (ops/attention.py's docstring): a sweep that
    # sets one moves the reference's route and leaves the port's where it was
    for knob in REFERENCE_KNOBS:
        monkeypatch.delenv(knob, raising=False)

    def port_routes():
        return ([ta.flash_routes(n) for n in (512, 1024, 1536, 2048, 4096)],
                [ta.packed_route_ok(n, 4, 64) for n in (256, 512, 520)])

    before = port_routes()
    value, reference_moved = REFERENCE_KNOBS[name]
    monkeypatch.setenv(name, value)
    assert reference_moved()
    assert port_routes() == before


@pytest.mark.parametrize("route", ["single", "tiled"])
@pytest.mark.parametrize("seq,heads,hd", [(24, 2, 16), (100, 4, 8), (512, 2, 16)])
def test_flash_self_attention_equals_the_packed_layout(route, seq, heads, hd):
    """One function on two layouts: ``flash_mha_packed`` on ``[B, T, 3*H*d]``
    and ``flash_self_attention`` on ``[B, H, T, d]``, outputs and gradients."""
    rng = np.random.default_rng(seq)
    batch = 3
    qkv = torch.from_numpy(
        rng.standard_normal((batch, seq, 3 * heads * hd)).astype(np.float32)).requires_grad_()
    dout = torch.from_numpy(rng.standard_normal((batch, seq, heads * hd)).astype(np.float32))
    lengths = torch.tensor([seq, 0, seq // 3], dtype=torch.int32)
    want = ta.flash_mha_packed(qkv, lengths, num_heads=heads)
    (want_grad,) = torch.autograd.grad(want, qkv, dout)
    q, k, v = (qkv.reshape(batch, seq, 3, heads, hd)[:, :, i].transpose(1, 2) for i in range(3))
    got = ta.flash_self_attention(q, k, v, lengths, **ROUTES[route]["kwargs"])
    got = got.transpose(1, 2).reshape(batch, seq, heads * hd)
    (got_grad,) = torch.autograd.grad(got, qkv, dout)
    # the same products in the same order on the CPU; online softmax and the
    # scale folded into q or applied to the scores round differently
    assert (got - want).abs().max().item() < 1e-6
    assert _rel(got_grad.numpy(), want_grad.numpy()) < 1e-6


def test_flash_wrappers_on_the_cpu_take_plain_versions_without_counting():
    q, k, v, dout = (torch.from_numpy(a).reshape(4, 40, 16) for a in _qkv(40, 16, seed=9))
    lengths = torch.tensor([40, 17], dtype=torch.int32)
    counters = (ta.flash_fwd_single, ta.flash_fwd_tiled, ta.flash_bwd_fused, ta.flash_bwd_dkv,
                ta.flash_bwd_dq)
    before = [fn.launches for fn in counters]
    out, lse = ta.flash_fwd_single(q, k, v, lengths, 2, 0.25)
    out_t, lse_t = ta.flash_fwd_tiled(q, k, v, lengths, 2, 0.25, block_k=16)
    torch.testing.assert_close(out, out_t, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, lse_t, rtol=1e-5, atol=1e-6)
    delta = ta.flash_delta(out, dout)
    args = (q, k, v, lengths, 2, lse, delta, dout, 0.25)
    fused = ta.flash_bwd_fused(*args)
    dk, dv = ta.flash_bwd_dkv(*args)
    whole = ta.flash_attention_bwd_reference(q, k, v, lengths, 2, out, lse, dout, 0.25)
    for a, b, c in zip(fused, (ta.flash_bwd_dq(*args), dk, dv), whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
    assert [fn.launches for fn in counters] == before  # only kernel launches count


@pytest.mark.parametrize("case,match", [
    ("rank", r"q must be \[B, H, T, d\]"), ("kv", "equal shapes"), ("lengths", r"lengths must be \[B\]"),
    ("flat_rank", r"q must be \[B\*H, T, d\]"), ("heads", r"batch \* heads"),
    ("lse", "lse must have shape"), ("dout", "dout must have shape")])
def test_flash_attention_rejects_bad_shapes(case, match):
    q = torch.zeros(2, 2, 8, 16)
    flat = q.reshape(4, 8, 16)
    lengths = torch.full((2,), 8, dtype=torch.int32)
    row = torch.zeros(4, 8)
    with pytest.raises(ValueError, match=match):
        if case == "rank":
            ta.flash_self_attention(flat, flat, flat)
        elif case == "kv":
            ta.flash_self_attention(q, q[:, :, :4], q)
        elif case == "lengths":
            ta.flash_self_attention(q, q, q, torch.zeros(3, dtype=torch.int32))
        elif case == "flat_rank":
            ta.flash_fwd_single(q, q, q, lengths, 2, 1.0)
        elif case == "heads":
            ta.flash_fwd_tiled(flat, flat, flat, lengths, 3, 1.0)
        elif case == "lse":
            ta.flash_bwd_fused(flat, flat, flat, lengths, 2, row[:, :4], row, flat, 1.0)
        else:
            ta.flash_bwd_dq(flat, flat, flat, lengths, 2, row, row, flat[:, :4], 1.0)


# ---- the encoder layer and the whole model past the packed route ------------

LONG_T = 520  # padded to 528 > 512: leaves the packed route; both wrappers pad to 1024


def test_long_window_layer_matches_jax():
    hidden, heads = 32, 4
    assert not ta.packed_route_ok(LONG_T, heads, hidden // heads)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, LONG_T, hidden)).astype(np.float32)
    valid = np.array([LONG_T, 301], np.int32)
    kpm = (np.arange(LONG_T)[None, :] < valid[:, None]).astype(np.float32)
    layer = JaxLayer(hidden_dim=hidden, num_heads=heads, dropout=0.0, use_flash=True)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(kpm))
    want = layer.apply(variables, jnp.asarray(x), jnp.asarray(kpm))
    port = te.TransformerEncoderLayer(hidden, heads, use_flash=True)
    state = from_flax_variables({"params": {"encoders_m": {"layer0": jax.tree_util.tree_map(
        np.asarray, variables["params"])}}})
    port.load_state_dict({k.split("layers.0.", 1)[1]: v for k, v in state.items()})
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(kpm))
        plain = te.TransformerEncoderLayer(hidden, heads, use_flash=False)
        plain.load_state_dict(port.state_dict())
        ref = plain.eval()(torch.from_numpy(x), torch.from_numpy(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)  # and the port's plain attention


SMALL = ["model.hidden_dim=32", "model.output_dim=16", "model.dropout=0",
         "training.dropout_rng=xla", f"dataset.chunk_size={LONG_T}"]
SMOOTHING = 0.05


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


@pytest.fixture(scope="module")
def long_model_pair():
    """The JAX model (Pallas kernels in interpret mode) and the port on the
    same weights, with one batch of T = 520 windows."""
    jmodel = JaxModel.from_config(jax_load_config(REPO / "config" / "base.yaml", SMALL))
    rng = np.random.default_rng(31)
    feats = {n: rng.standard_normal((2, LONG_T, d)).astype(np.float32)
             for n, d in zip(NAMES, DIMS)}
    mask = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32)
    lengths = np.array([LONG_T, 260], np.int32)
    labels = np.array([3, 17], np.int32)
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    variables = jmodel.init(jax.random.PRNGKey(2), jf, jnp.asarray(mask), jnp.asarray(lengths))
    model = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", SMALL), device="cpu")
    model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)))
    return jmodel, variables, model, (feats, jf, mask, lengths, labels)


def test_long_window_model_logits_match_jax(long_model_pair):
    jmodel, variables, model, (feats, jf, mask, lengths, _labels) = long_model_pair
    want = jmodel.apply(variables, jf, jnp.asarray(mask), jnp.asarray(lengths))
    with torch.no_grad():
        got = model({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                    torch.from_numpy(lengths))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-5


def test_long_window_training_step_matches_jax(long_model_pair):
    jmodel, variables, model, (feats, jf, mask, lengths, labels) = long_model_pair

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, jf, jnp.asarray(mask), jnp.asarray(lengths),
                              train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_cross_entropy_loss(logits, jnp.asarray(labels), SMOOTHING)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(variables["params"])
    logits = model({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                   torch.from_numpy(lengths), train=True,
                   generator=torch.Generator().manual_seed(0))
    loss = cross_entropy_loss(logits, torch.from_numpy(labels), SMOOTHING)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = dict(_flat(to_flax_tree({n: p.grad for n, p in model.named_parameters()})))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, want_grads)))
    assert sorted(got) == sorted(want)
    # each gradient to 1e-4 of its largest magnitude, floored at 1e-3 of the
    # model's largest (the key biases' gradients are zero up to rounding)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        err = np.abs(got[name] - w).max() / max(np.abs(w).max(), floor)
        assert err < 1e-4, f"{name}: rel err {err:.3e}"
    model.zero_grad(set_to_none=True)
