"""PyTorch port, training forward and backward of the whole model: loss and
every parameter gradient against ``jax.value_and_grad`` of the loss the JAX
``Trainer`` differentiates, on the same weights and numpy inputs (hidden 32,
T = 24, four modalities, one of them masked, dropout 0 so that no random
draw enters). The JAX model runs its attention and fused residual-LN kernels
in interpret mode; the port runs its kernel path (CPU twins) or its plain
path."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
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
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
    cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
SMALL = ["model.hidden_dim=32", "model.output_dim=16"]
KERNELS_ON = ["model.flash_attention=true", "model.fused_mlp=true", "model.fused_mlp_ln=true"]
KERNELS_OFF = ["model.flash_attention=false", "model.fused_mlp=false", "model.fused_mlp_ln=false"]
SMOOTHING = 0.05
# f32 both sides; the gradient of each leaf to 1e-4 of its largest magnitude
# (floored at 1e-3 of the largest gradient in the model: the key biases'
# gradients are zero up to rounding, a bias on every key shifting all of a
# query's scores alike)
GRAD_TOL = 1e-4


def _batch(seed=20):
    rng = np.random.default_rng(seed)
    feats = {n: rng.standard_normal((4, 24, d)).astype(np.float32) for n, d in zip(NAMES, DIMS)}
    mask = np.ones((4, 4), np.float32)
    mask[:, NAMES.index("imu_chest")] = 0.0
    mask[2, :] = [0, 0, 0, 1]
    lengths = np.array([24, 7, 0, 13], np.int32)
    labels = rng.integers(0, 25, 4).astype(np.int32)
    weight = np.array([1, 1, 1, 0], np.float32)  # a padded row
    return feats, mask, lengths, labels, weight


@pytest.fixture(scope="module")
def jax_reference():
    """(flax variables, loss, grads) of the JAX model in train mode."""
    cfg = jax_load_config(REPO / "config" / "base.yaml", SMALL + ["model.dropout=0"] + KERNELS_ON)
    jmodel = JaxModel.from_config(cfg)
    feats, mask, lengths, labels, weight = _batch()
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    variables = jmodel.init(jax.random.PRNGKey(4), jf, jnp.asarray(mask), jnp.asarray(lengths))

    def loss_fn(params):
        logits = jmodel.apply(
            {"params": params}, jf, jnp.asarray(mask), jnp.asarray(lengths), train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
        )
        return jax_cross_entropy_loss(
            logits, jnp.asarray(labels), SMOOTHING, sample_weight=jnp.asarray(weight)
        )

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return to_np(variables), float(loss), to_np(grads)


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def _port_loss_and_grads(overrides, variables, generator_seed=0):
    cfg = load_config(REPO / "config" / "base.yaml", SMALL + overrides)
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    if variables is not None:
        model.load_state_dict(from_flax_variables(variables), strict=True)
    feats, mask, lengths, labels, weight = _batch()
    logits = model(
        {n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
        torch.from_numpy(lengths), train=True,
        generator=torch.Generator().manual_seed(generator_seed),
    )
    loss = cross_entropy_loss(logits, torch.from_numpy(labels), SMOOTHING,
                              sample_weight=torch.from_numpy(weight))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return model, loss.item(), grads


@pytest.mark.parametrize("path", ["kernels", "plain"])
def test_train_loss_and_every_gradient_match_jax(jax_reference, path):
    variables, want_loss, want_grads = jax_reference
    overrides = ["model.dropout=0"] + (KERNELS_ON if path == "kernels" else KERNELS_OFF)
    _model, loss, grads = _port_loss_and_grads(overrides, variables)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    got = dict(_flat(to_flax_tree(grads)))
    want = dict(_flat(want_grads["params"] if "params" in want_grads else want_grads))
    assert sorted(got) == sorted(want)  # every parameter has its gradient
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        err = np.abs(got[name] - w).max() / max(np.abs(w).max(), floor)
        assert err < GRAD_TOL, f"{name}: rel err {err:.3e}"
    # imu_chest is masked in every row: its embedding is zeroed before the
    # head, so its encoder gets exactly zero gradient
    assert np.all(got["encoders_imu_chest/projection/kernel"] == 0)


def test_dropout_kernel_and_plain_paths_draw_the_same_masks():
    """dropout 0.2: the kernel path (CPU twins) and the plain path consume the
    same generator draws, so one seed gives one loss and one gradient."""
    overrides = ["model.dropout=0.2", "training.dropout_rng=xla"]
    model_k, loss_k, grads_k = _port_loss_and_grads(overrides + KERNELS_ON, None, 11)
    state = {k: v.clone() for k, v in model_k.state_dict().items()}
    cfg = load_config(REPO / "config" / "base.yaml", SMALL + overrides + KERNELS_OFF)
    model_p = MultimodalFusionModel.from_config(cfg, device="cpu")
    model_p.load_state_dict(state)
    feats, mask, lengths, labels, weight = _batch()
    logits = model_p(
        {n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
        torch.from_numpy(lengths), train=True, generator=torch.Generator().manual_seed(11),
    )
    loss_p = cross_entropy_loss(logits, torch.from_numpy(labels), SMOOTHING,
                                sample_weight=torch.from_numpy(weight))
    loss_p.backward()
    assert loss_k == pytest.approx(loss_p.item(), rel=1e-6)
    for name, p in model_p.named_parameters():
        torch.testing.assert_close(grads_k[name], p.grad, rtol=1e-4, atol=1e-6)
    # and a different seed draws different masks
    _, loss_other, _ = _port_loss_and_grads(overrides + KERNELS_ON, None, 12)
    assert loss_other != loss_k


def test_from_config_reads_training_keys():
    cfg = load_config(REPO / "config" / "base.yaml", SMALL + ["model.dropout=0.3"])
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    assert not model.training
    layer = model.encoders["imu_hand"].layers[0]
    assert (layer.dropout, layer.use_fused_mlp, layer.use_fused_mlp_ln) == (0.3, True, True)
    assert layer.dropout_rng == "auto"
    assert model.fusion_model.dropout == 0.3 and model.fusion_model.pairs.dropout == 0.3
    with pytest.raises(ValueError, match="Unknown training.dropout_rng"):
        MultimodalFusionModel.from_config(
            load_config(REPO / "config" / "base.yaml", SMALL + ["training.dropout_rng=nope"]),
            device="cpu")


def test_fused_mlp_without_ln_layer_matches_jax_on_explicit_masks(monkeypatch):
    """The layer at fused_mlp=true, fused_mlp_ln=false, dropout 0.2: both
    frameworks are handed the same three numpy masks in place of their own
    draws (the JAX layer through ``jax.random.bernoulli``, the port through
    ``keep_mask``), the JAX layer runs its ``fused_mlp`` kernel pair in
    interpret mode, and output and parameter gradients must agree."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import encoders as jenc
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as tenc

    rng = np.random.default_rng(41)
    batch, seq, hidden, ffw = 3, 8, 32, 2048
    x = rng.standard_normal((batch, seq, hidden)).astype(np.float32)
    cot = rng.standard_normal((batch, seq, hidden)).astype(np.float32)
    valid = np.ones((batch, seq), np.float32)
    valid[1, 5:] = 0.0
    masks = [rng.random((batch, seq, w)) < 0.8 for w in (hidden, ffw, hidden)]

    jax_draws = iter(masks)
    monkeypatch.setattr(jenc.jax.random, "bernoulli",
                        lambda _key, _p, shape: jnp.asarray(next(jax_draws)).reshape(shape))
    jlayer = jenc._TransformerEncoderLayer(
        hidden_dim=hidden, num_heads=4, dropout=0.2, use_flash=False, use_fused_mlp=True,
        use_fused_mlp_ln=False, dropout_rng="xla")
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid))

    def loss_fn(params):
        out = jlayer.apply({"params": params}, jnp.asarray(x), jnp.asarray(valid), train=True,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out * cot), out

    (_, want_out), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])

    port_draws = iter(masks)
    monkeypatch.setattr(tenc, "keep_mask",
                        lambda shape, _p, _g, _d: torch.from_numpy(next(port_draws)).reshape(shape))
    layer = tenc.TransformerEncoderLayer(
        hidden, 4, dropout=0.2, use_flash=False, use_fused_mlp=True, use_fused_mlp_ln=False,
        dropout_rng="xla")
    state = from_flax_variables({"params": {"encoders_m": {"layer0": jax.tree_util.tree_map(
        np.asarray, variables["params"])}}})
    layer.load_state_dict({k.split("layers.0.", 1)[1]: v for k, v in state.items()})
    out = layer(torch.from_numpy(x), torch.from_numpy(valid), train=True)
    (out * torch.from_numpy(cot)).sum().backward()
    # f32 both; same tolerance as the op-level comparison
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-5, atol=2e-5)
    got = dict(_flat(to_flax_tree({f"encoders.m.layers.0.{n}": p.grad
                                   for n, p in layer.named_parameters()})))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, want_grads)))
    assert len(got) == len(want) == 16
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = got[f"encoders_m/layer0/{name}"]
        err = np.abs(g - w).max() / max(np.abs(w).max(), floor)
        assert err < GRAD_TOL, f"{name}: rel err {err:.3e}"


@pytest.mark.parametrize("encoder", ["layer", "grouped"])
def test_kernel_source_layer_draws_its_masks_in_one_call(monkeypatch, encoder):
    """Dropout on the generator kernel's source (pinned on the CPU, where the
    masks come from the kernel's twin): a transformer layer, ungrouped or
    grouped, draws its three masks of one seed with one
    ``dropout_keep_masks`` call, and its training output is bit for bit the
    one the same layer gives when it is handed, in its fixed draw order, the
    three masks one ``dropout_keep_mask_reference`` call per purpose makes
    from that seed (what it drew before the masks shared a launch)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as tenc
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import grouped as tgr
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm

    module = tenc if encoder == "layer" else tgr
    rng = np.random.default_rng(5)
    hidden, ffw = 32, 64
    if encoder == "layer":
        net = tenc.TransformerEncoderLayer(hidden, 4, dim_feedforward=ffw, use_flash=True,
                                           dropout=0.2, use_fused_mlp=True,
                                           use_fused_mlp_ln=True, dropout_rng="kernel")
        x = torch.from_numpy(rng.standard_normal((3, 8, hidden)).astype(np.float32))
        layers, rows = 1, 3 * 8
    else:
        net = tgr.GroupedTransformerEncoder(3, 5, hidden_dim=hidden, output_dim=16, num_layers=2,
                                            dim_feedforward=ffw, dropout=0.2, use_flash=True,
                                            dropout_rng="kernel")
        net.init_parameters(torch.Generator().manual_seed(1))
        x = torch.from_numpy(rng.standard_normal((3, 4, 8, 5)).astype(np.float32))
        layers, rows = 2, 3 * 4 * 8
    calls = []
    one_launch = module.dropout_keep_masks

    def counted(*args):
        calls.append(len(args[2]))
        return one_launch(*args)

    monkeypatch.setattr(module, "resolve_dropout_rng", lambda *_args: "kernel")
    monkeypatch.setattr(module, "dropout_keep_masks", counted)
    got = net(x, None, train=True, generator=torch.Generator().manual_seed(3))
    assert calls == [3] * layers  # one call a layer, its three masks

    # the same seed's masks, one reference call per purpose, handed to the
    # layer in its draw order (attention side, hidden, FFW side) each layer
    generator = torch.Generator().manual_seed(3)
    seed = tm.kernel_rng_seed(generator, "cpu")  # the layer's one draw from the generator
    order = [tm.dropout_keep_mask_reference(seed, rows, cols, 0.8, purpose) for cols, purpose in
             ((hidden, tm.RNG_P_ATT), (ffw, tm.RNG_P_HIDDEN), (hidden, tm.RNG_P_RES))]
    handed = iter(order * layers)
    monkeypatch.setattr(module, "resolve_dropout_rng", lambda *_args: "xla")
    monkeypatch.setattr(module, "keep_mask", lambda shape, *_args: next(handed).reshape(shape))
    assert torch.equal(got, net(x, None, train=True, generator=generator))
    assert next(handed, None) is None
