"""PyTorch port, the model zoo beyond the hybrid transformer: the early, late
and uncertainty fusion heads, the CNN encoder with its masked BatchNorm, the
frame and MLP encoders, every preset of ``config/fusion_strategies.yaml`` and
a CNN-encoder model, MC-dropout uncertainty fusion, the ensemble, and the
fusion-comparison aggregation, held against the JAX package on the same
weights (converted both ways) and numpy inputs, at hidden 32, output 16."""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu import cli as jcli
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu import uncertainty as junc
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import encoders as jenc
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import fusion as jfus
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.ops.metrics import (
    cross_entropy_loss as jax_cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import cli as tcli
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import evaluate as teval
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import uncertainty as tunc
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
    from_flax_variables,
    to_flax_tree,
    to_flax_variables,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data import dataset as tdata
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as tenc
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import fusion as tfus
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
    cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import checkpoint as tckpt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
SMALL = ["model.hidden_dim=32", "model.output_dim=16"]
CNN = [f"model.encoders.{n}.encoder_type=cnn" for n in NAMES]
SMOOTHING = 0.05
# f32 on both sides; products and reductions sum in another order
TOL = dict(rtol=2e-5, atol=2e-5)
# mask rows: all on, mixed, and all off (the heads' zero-row fallbacks)
MASKS = np.array([[1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 0, 0], [0, 0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Every torch tensor here is tiny: torch's intra-op thread pool costs
    more than it saves, the more so beside other test workers. One thread,
    the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=(), leaf=np.asarray):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,), leaf)
        else:
            yield "/".join(prefix + (key,)), leaf(value)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(jmodel, tcfg, seed, *args):
    """Seeded weights for the JAX model and its port, as flax variables
    (numpy leaves): the port's own init from ``seed``, converted, and held
    leaf for leaf to the tree, shapes and dtypes of ``jmodel.init`` (traced
    alone, which costs a fraction of a compiled init)."""
    port = MultimodalFusionModel.from_config(tcfg, device="cpu",
                                             generator=torch.Generator().manual_seed(seed))
    variables = to_flax_variables(port)
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed), *args)
    spec = dict(_flat(want, leaf=lambda v: (tuple(v.shape), np.dtype(v.dtype))))
    assert dict(_flat(variables, leaf=lambda v: (v.shape, v.dtype))) == spec
    return variables


def _rng_feats(batch, width, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((batch, width)).astype(np.float32) for n in NAMES}


def _strip(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()}


def _assert_round_trip(variables, port):
    """The port's tensors convert back to the flax tree leaf for leaf, exactly."""
    got, want = dict(_flat(to_flax_variables(port))), dict(_flat(_np(variables)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


# ---- the three heads -------------------------------------------------------

HEADS = {"early": (jfus.EarlyFusion, tfus.EarlyFusion), "late": (jfus.LateFusion, tfus.LateFusion),
         "uncertainty": (jfus.UncertaintyFusion, tfus.UncertaintyFusion)}


@pytest.mark.filterwarnings("ignore:Initializing zero-element tensors")  # a head of no modality
@pytest.mark.parametrize("kind", sorted(HEADS))
def test_fusion_heads_match_jax(kind):
    jcls, tcls = HEADS[kind]
    feats = _rng_feats(len(MASKS), 16, seed=1)
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    head = jcls(modality_names=NAMES, hidden_dim=32, num_classes=25, dropout=0.1)
    variables = head.init(jax.random.PRNGKey(1), jf, jnp.asarray(MASKS))
    params = dict(variables["params"])
    if kind == "late":  # away from the zero init, so the softmax weights differ
        params["weight_logits"] = jnp.asarray([0.3, -0.2, 0.5, 0.1])
    want = head.apply({"params": params}, jf, jnp.asarray(MASKS))
    port = tcls(NAMES, {n: 16 for n in NAMES}, 32, 25, 0.1)
    port.load_state_dict(from_flax_variables({"params": _np(params)}), strict=True)
    _assert_round_trip({"params": params}, port)
    with torch.no_grad():
        got = port({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(MASKS))
    if kind == "early":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
        assert list(got[1]) == list(NAMES)
        for n in NAMES:
            np.testing.assert_allclose(got[1][n].numpy(), np.asarray(want[1][n]), **TOL)
    # the reference's error strings
    name = tcls.__name__
    with pytest.raises(KeyError, match=f"Missing features for modality 'imu_ankle' in {name}"):
        port({n: torch.from_numpy(v) for n, v in feats.items() if n != "imu_ankle"})
    with pytest.raises(ValueError, match=f"No modalities configured for {name}."):
        tcls((), {}, 8, 3, 0.1)({})
    if kind == "early":
        bad = {n: torch.zeros(4, 2, 16) for n in NAMES}
        with pytest.raises(ValueError, match=re.escape(
                "Expected 2D tensor for modality 'imu_hand', got shape (4, 2, 16).")):
            port(bad)


def test_uncertainty_head_clips_the_log_variance():
    head = tfus.UncertaintyFusion(NAMES, {n: 16 for n in NAMES}, 32, 25, dropout=0.5)
    feats = {n: torch.from_numpy(v) for n, v in _rng_feats(3, 16, seed=2).items()}
    with torch.no_grad():
        for n in NAMES:  # log-variances far past the clip
            getattr(head, f"unc_{n}_head").bias.fill_(40.0 if n == "imu_hand" else -40.0)
        logits, per = head(feats, train=True, generator=torch.Generator().manual_seed(0))
    # inverse variances e^6 for three modalities and e^-6 for imu_hand
    w = np.array([np.exp(-6.0), np.exp(6.0), np.exp(6.0), np.exp(6.0)])
    w = w / (w.sum() + 1e-8)
    want = sum(w[i] * per[n] for i, n in enumerate(NAMES))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **TOL)


# ---- encoders --------------------------------------------------------------

def _wrap(variables, name="encoders_m"):
    """A standalone module's variables under one encoder's scope, so that the
    converter reads them as the model's tree does."""
    return {col: {name: tree} for col, tree in _np(variables).items()}


def _load_encoder(port, variables):
    port.load_state_dict(_strip(from_flax_variables(_wrap(variables)), "encoders.m."), strict=True)
    return port


def _stats_equal(port_state, variables):
    got = {k: v.numpy() for k, v in port_state.items() if k.startswith("bn")}
    for path, w in _flat(_np(variables["batch_stats"])):
        module, stat = path.rsplit("/", 1)
        np.testing.assert_allclose(got[f"{module}.running_{stat}"], w, err_msg=path, **TOL)


def test_cnn_encoder_train_steps_and_batch_stats_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 21, 17)).astype(np.float32) * 2 + 0.5
    lengths = np.array([21, 9, 1, 16], np.int32)  # padded tails; one single-step row
    x[1, 9:] = 50.0  # garbage in the pad must not reach the statistics
    enc = jenc.SequenceEncoder(hidden_dim=32, output_dim=16, encoder_type="cnn", dropout=0.0)
    jx, jl = jnp.asarray(x), jnp.asarray(lengths)
    variables = _np(enc.init(jax.random.PRNGKey(3), jx, jl))
    port = _load_encoder(tenc.SequenceEncoder(17, 32, 16, encoder_type="cnn", dropout=0.0),
                         variables)
    assert port.conv0.weight.shape == (32, 17, 3)
    _assert_round_trip(_wrap(variables), _AsEncoder(port))
    tx, tl = torch.from_numpy(x), torch.from_numpy(lengths)
    for _ in range(2):  # two training steps: outputs and the updated running statistics
        want, updates = enc.apply(variables, jx, jl, train=True, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": _np(updates["batch_stats"])}
        got = port(tx, tl, train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _stats_equal(port.state_dict(), variables)
    assert not np.allclose(variables["batch_stats"]["bn0"]["var"], 1.0)
    want = enc.apply(variables, jx, jl)  # eval: the running statistics
    with torch.no_grad():
        got = port(tx, tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # without lengths the statistics cover every step
    want, _ = enc.apply(variables, jx, None, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        np.testing.assert_allclose(port(tx, None, train=True).numpy(), np.asarray(want), **TOL)


class _AsEncoder(torch.nn.Module):
    """A standalone encoder as ``encoders.m``, for the converter's way back."""

    def __init__(self, module):
        super().__init__()
        self.encoders = torch.nn.ModuleDict({"m": module})


@pytest.mark.parametrize("pooling", ["attention", "average", "max"])
def test_frame_encoder_matches_jax(pooling):
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((4, 9, 12)).astype(np.float32)
    mask = np.ones((4, 9), np.float32)
    mask[1, 5:] = 0.0
    mask[2] = 0.0  # an all-masked row
    mask[3, ::2] = 0.0  # not a prefix
    enc = jenc.FrameEncoder(hidden_dim=32, output_dim=16, temporal_pooling=pooling, dropout=0.1)
    variables = _np(enc.init(jax.random.PRNGKey(4), jnp.asarray(frames), jnp.asarray(mask)))
    port = _load_encoder(tenc.FrameEncoder(12, 32, 16, pooling, 0.1), variables)
    _assert_round_trip(_wrap(variables), _AsEncoder(port))
    for m in (mask, None):
        want = enc.apply(variables, jnp.asarray(frames), None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = port(torch.from_numpy(frames), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("batch_norm", [True, False], ids=["bn", "no-bn"])
def test_mlp_encoder_and_its_running_statistics_match_jax(batch_norm):
    x = np.random.default_rng(5).standard_normal((6, 10)).astype(np.float32) * 3 + 1
    enc = jenc.SimpleMLPEncoder(hidden_dim=32, output_dim=16, num_layers=2, dropout=0.0,
                                batch_norm=batch_norm)
    variables = _np(enc.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    port = _load_encoder(tenc.SimpleMLPEncoder(10, 32, 16, 2, 0.0, batch_norm), variables)
    _assert_round_trip(_wrap(variables), _AsEncoder(port))
    tx = torch.from_numpy(x)
    for _ in range(2):
        if batch_norm:
            want, updates = enc.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
            variables = {"params": variables["params"],
                         "batch_stats": _np(updates["batch_stats"])}
        else:
            want = enc.apply(variables, jnp.asarray(x), train=True)
        np.testing.assert_allclose(port(tx, train=True).detach().numpy(), np.asarray(want), **TOL)
    if batch_norm:
        _stats_equal(port.state_dict(), variables)
    with torch.no_grad():
        np.testing.assert_allclose(port(tx).numpy(), np.asarray(enc.apply(variables, jnp.asarray(x))),
                                   **TOL)


def test_batch_statistics_move_only_on_a_forward_that_records_gradients():
    norm = tenc.MaskedBatchNorm(3)
    x = torch.randn(4, 5, 3, generator=torch.Generator().manual_seed(0)) * 2 + 1
    with torch.inference_mode():
        a = norm(x, train=True)
    with torch.no_grad():
        b = norm(x, train=True)
    assert torch.equal(a, b) and torch.all(norm.running_mean == 0)
    assert torch.all(norm.running_var == 1)
    norm(x, train=True)
    mean = x.reshape(-1, 3).mean(0)
    var = x.reshape(-1, 3).var(0, unbiased=False)  # the biased variance
    torch.testing.assert_close(norm.running_mean, 0.1 * mean)
    torch.testing.assert_close(norm.running_var, 0.9 + 0.1 * var)


# ---- whole models: every preset and a CNN-encoder model ----------------------

PRESETS = {
    "early_fusion": ["preset=early_fusion"],
    "late_fusion": ["preset=late_fusion"],
    "hybrid_fusion": ["preset=hybrid_fusion"],
    "uncertainty_fusion": ["preset=uncertainty_fusion"],
    "late_cnn": ["preset=late_fusion", *CNN],
    "hybrid_cnn": ["preset=hybrid_fusion", *CNN],
}


def _preset_configs(name, extra=()):
    overrides = [*PRESETS[name], *SMALL, *extra]
    path = REPO / "config" / "fusion_strategies.yaml"
    return jax_load_config(path, overrides), load_config(path, overrides)


def _batch(seed=6, batch=4, seq=24):
    rng = np.random.default_rng(seed)
    feats = {n: rng.standard_normal((batch, seq, d)).astype(np.float32) * 1.5
             for n, d in zip(NAMES, DIMS)}
    lengths = np.array([seq, 7, 1, 13][:batch], np.int32)
    labels = rng.integers(0, 25, batch).astype(np.int32)
    return feats, lengths, labels


@pytest.fixture(scope="module", params=sorted(PRESETS))
def preset_pair(request):
    """(name, jax model, flax variables, port model) at dropout 0."""
    jcfg, tcfg = _preset_configs(request.param, ["model.dropout=0"])
    jmodel = JaxModel.from_config(jcfg)
    feats, lengths, _ = _batch()
    variables = _init(jmodel, tcfg, 6, {n: jnp.asarray(v) for n, v in feats.items()},
                      jnp.ones((4, 4)), jnp.asarray(lengths))
    if "weight_logits" in variables["params"].get("fusion_model", {}):
        variables["params"]["fusion_model"]["weight_logits"] = np.array(
            [0.3, -0.2, 0.5, 0.1], np.float32)
    port = MultimodalFusionModel.from_config(tcfg, device="cpu")
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return request.param, jmodel, variables, port


def test_preset_builds_the_reference_tree(preset_pair):
    name, jmodel, variables, port = preset_pair
    assert port.fusion_type == jmodel.fusion_type
    assert type(port.fusion_model).__name__ == {
        "early": "EarlyFusion", "late": "LateFusion", "hybrid": "HybridFusion",
        "uncertainty": "UncertaintyFusion"}[port.fusion_type]
    assert ("batch_stats" in variables) == name.endswith("cnn")
    _assert_round_trip(variables, port)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masks"])
def test_preset_logits_match_jax(preset_pair, masked):
    _name, jmodel, variables, port = preset_pair
    feats, lengths, _ = _batch()
    mask = MASKS if masked else np.ones((4, 4), np.float32)
    want = jmodel.apply(variables, {n: jnp.asarray(v) for n, v in feats.items()},
                        jnp.asarray(mask), jnp.asarray(lengths))
    with torch.no_grad():
        got = port({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                   torch.from_numpy(lengths))
    assert got.shape == (4, 25)  # logits alone, whatever the head returns
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    serve = make_serving_fn(port, device="cpu")
    served = serve({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                   torch.from_numpy(lengths))
    np.testing.assert_allclose(served.numpy(), np.asarray(want), **TOL)
    if port.fusion_type != "hybrid":
        with pytest.raises(ValueError, match="only available for HybridFusion"):
            port({n: torch.from_numpy(v) for n, v in feats.items()}, return_attention=True)


def test_preset_training_step_matches_jax(preset_pair):
    """One training step at dropout 0, augmentations off: the loss the JAX
    ``Trainer`` differentiates, every parameter's gradient (to 2e-5 of its
    largest magnitude, floored at 1e-3 of the model's largest gradient), and
    the BatchNorms' updated running statistics."""
    _name, jmodel, variables, port = preset_pair
    feats, lengths, labels = _batch(seed=8)
    mask = MASKS[[0, 1, 3, 0]]
    weight = np.array([1, 1, 1, 0], np.float32)  # a padded row
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    stats = "batch_stats" in variables

    def loss_fn(params):
        out = jmodel.apply({**variables, "params": params}, jf, jnp.asarray(mask),
                           jnp.asarray(lengths), train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                           mutable=["batch_stats"] if stats else False)
        logits, updates = out if stats else (out, {})
        loss = jax_cross_entropy_loss(logits, jnp.asarray(labels), SMOOTHING,
                                      sample_weight=jnp.asarray(weight))
        return loss, updates

    (want_loss, updates), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    model = MultimodalFusionModel.from_config(_preset_configs(_name, ["model.dropout=0"])[1],
                                              device="cpu")
    model.load_state_dict(port.state_dict(), strict=True)
    logits = model({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                   torch.from_numpy(lengths), train=True, generator=torch.Generator().manual_seed(0))
    loss = cross_entropy_loss(logits, torch.from_numpy(labels), SMOOTHING,
                              sample_weight=torch.from_numpy(weight))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=2e-5)
    got = dict(_flat(to_flax_tree({n: p.grad for n, p in model.named_parameters()})))
    want = dict(_flat(_np(want_grads)))
    assert sorted(got) == sorted(want)
    largest = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        # a convolution's bias feeds a BatchNorm that takes the batch's mean
        # out again: its gradient is zero but for rounding, held to the
        # model's largest gradient
        scale = largest if re.search(r"/conv\d/bias$", name) else max(np.abs(w).max(),
                                                                       1e-3 * largest)
        err = np.abs(got[name] - w).max() / scale
        assert err < 2e-5, f"{name}: rel err {err:.3e}"
    if stats:
        got_stats = dict(_flat(to_flax_variables(model)["batch_stats"]))
        for name, w in _flat(_np(updates["batch_stats"])):
            np.testing.assert_allclose(got_stats[name], w, err_msg=name, **TOL)


MIXED = """
dataset:
  name: synthetic
  modalities: [imu_hand, video, stats]
  num_classes: 5
model:
  fusion_type: late
  hidden_dim: 32
  output_dim: 16
  dropout: 0.0
  encoders:
    imu_hand: {type: sequence, input_dim: 7, encoder_type: cnn}
    video: {input_dim: 12, temporal_pooling: attention}
    stats: {input_dim: 6}
seed: 0
"""


def test_a_model_of_frame_and_mlp_encoders_matches_jax(tmp_path):
    """``build_encoder``'s routes by modality name (``video`` a frame encoder,
    the lengths its frame mask; ``stats`` the MLP encoder on 2-D features)
    beside a CNN stream: eval logits, then a training forward's logits and
    the updated running statistics of both BatchNorm kinds."""
    path = tmp_path / "mixed.yaml"
    path.write_text(MIXED)
    jmodel = JaxModel.from_config(jax_load_config(path))
    tcfg = load_config(path)
    port = MultimodalFusionModel.from_config(tcfg, device="cpu")
    assert [type(port.encoders[m]).__name__ for m in ("imu_hand", "video", "stats")] == [
        "SequenceEncoder", "FrameEncoder", "SimpleMLPEncoder"]
    rng = np.random.default_rng(14)
    feats = {"imu_hand": rng.standard_normal((4, 10, 7)), "video": rng.standard_normal((4, 10, 12)),
             "stats": rng.standard_normal((4, 6)) * 2}
    feats = {m: v.astype(np.float32) for m, v in feats.items()}
    lengths = np.array([10, 3, 0, 7], np.int32)
    jf = {m: jnp.asarray(v) for m, v in feats.items()}
    variables = _init(jmodel, tcfg, 14, jf, None, jnp.asarray(lengths))
    port.load_state_dict(from_flax_variables(variables), strict=True)
    _assert_round_trip(variables, port)
    tf = {m: torch.from_numpy(v) for m, v in feats.items()}
    want = jmodel.apply(variables, jf, None, jnp.asarray(lengths))
    with torch.no_grad():
        np.testing.assert_allclose(port(tf, None, torch.from_numpy(lengths)).numpy(),
                                   np.asarray(want), **TOL)
    want, updates = jmodel.apply(variables, jf, None, jnp.asarray(lengths), train=True,
                                 mutable=["batch_stats"])
    got = port(tf, None, torch.from_numpy(lengths), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got_stats = dict(_flat(to_flax_variables(port)["batch_stats"]))
    want_stats = dict(_flat(_np(updates["batch_stats"])))
    assert sorted(got_stats) == sorted(want_stats) and len(want_stats) == 8
    for name, w in want_stats.items():
        np.testing.assert_allclose(got_stats[name], w, err_msg=name, **TOL)


# ---- uncertainty -------------------------------------------------------------

@pytest.fixture(scope="module")
def late_cnn():
    """A late-fusion model with CNN encoders (dropout 0.2) and its weights as
    flax variables."""
    _jcfg, tcfg = _preset_configs("late_cnn")
    model = MultimodalFusionModel.from_config(tcfg, device="cpu")
    feats, lengths, _ = _batch()
    with torch.enable_grad():  # move the running statistics off their init
        model({n: torch.from_numpy(v) for n, v in feats.items()}, None, torch.from_numpy(lengths),
              train=True, generator=torch.Generator().manual_seed(1))
    return model


@pytest.mark.parametrize("preset", ["late_fusion", "uncertainty_fusion", "late_cnn"])
def test_mc_dropout_uncertainty_fusion_matches_jax_at_dropout_0(preset):
    jcfg, tcfg = _preset_configs(preset, ["model.dropout=0"])
    jmodel = JaxModel.from_config(jcfg)
    feats, lengths, _ = _batch(seed=9)
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    variables = _init(jmodel, tcfg, 9, jf, jnp.ones((4, 4)), jnp.asarray(lengths))
    port = MultimodalFusionModel.from_config(tcfg, device="cpu")
    port.load_state_dict(from_flax_variables(variables), strict=True)
    mask = MASKS[[0, 1, 3, 2]]
    want = jax.jit(lambda v, f, m, l: junc.mc_dropout_uncertainty_fusion(
        jmodel, v, f, m, l, num_samples=3, seed=0))(variables, jf, jnp.asarray(mask),
                                                   jnp.asarray(lengths))
    got = tunc.mc_dropout_uncertainty_fusion(port, {n: torch.from_numpy(v) for n, v in feats.items()},
                                             torch.from_numpy(mask), torch.from_numpy(lengths),
                                             num_samples=3, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    hybrid = MultimodalFusionModel.from_config(_preset_configs("hybrid_fusion")[1], device="cpu")
    with pytest.raises(ValueError, match="requires a LateFusion or UncertaintyFusion model"):
        tunc.mc_dropout_uncertainty_fusion(hybrid, {n: torch.from_numpy(v) for n, v in feats.items()})


def test_mc_dropout_uncertainty_fusion_repeats_and_weights_sum_to_one(late_cnn):
    feats, lengths, _ = _batch(seed=10)
    tf = {n: torch.from_numpy(v) for n, v in feats.items()}
    mask = torch.from_numpy(MASKS)
    first = tunc.mc_dropout_uncertainty_fusion(late_cnn, tf, mask, torch.from_numpy(lengths),
                                               num_samples=4, seed=3)
    again = tunc.mc_dropout_uncertainty_fusion(late_cnn, tf, mask, torch.from_numpy(lengths),
                                               num_samples=4, seed=3)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    logits, weights = first
    assert logits.shape == (4, 25) and torch.isfinite(logits).all()
    torch.testing.assert_close(weights.sum(dim=1), torch.ones(4), rtol=0, atol=1e-6)
    # a row weighs only its own modalities; one with none falls back to uniform
    assert torch.all(weights[1, [1, 3]] == 0) and torch.all(weights[3, :3] == 0)
    torch.testing.assert_close(weights[2], torch.full((4,), 0.25), rtol=0, atol=1e-6)


def test_every_mc_dropout_path_leaves_the_running_statistics_unwritten(late_cnn):
    """The reference runs MC dropout with ``mutable=["batch_stats"]`` and
    discards the update; the port's passes normalise by the batch and write
    no buffer. A training forward that records gradients does write them."""
    feats, lengths, _ = _batch(seed=11)
    tf = {n: torch.from_numpy(v) for n, v in feats.items()}
    tl = torch.from_numpy(lengths)
    before = {k: v.clone() for k, v in late_cnn.named_buffers()}
    assert len(before) == 16  # 4 encoders x 2 BatchNorms x (mean, var)
    tunc.mc_dropout_uncertainty_fusion(late_cnn, tf, None, tl, num_samples=2)
    tunc.MCDropoutUncertainty(late_cnn, num_samples=2)(tf, None, tl)
    tunc.mc_dropout(lambda g, f, l: late_cnn(f, None, l, train=True, generator=g), 2, 0)(tf, tl)
    windows = tdata.WindowedSplit(
        features=feats, labels=np.zeros(4, np.int32), lengths=lengths,
        modalities=list(NAMES))
    tunc.mc_dropout_over_split(late_cnn, DeviceSplit.from_windows(windows, device="cpu"),
                               num_samples=2, batch_size=3)
    for k, v in late_cnn.named_buffers():
        assert torch.equal(v, before[k]), k
    # train mode normalises by the batch: unlike eval, which reads the buffers
    with torch.no_grad():
        train_out = late_cnn(tf, None, tl, train=True, generator=torch.Generator().manual_seed(0))
        eval_out = late_cnn(tf, None, tl)
    assert not torch.allclose(train_out, eval_out)
    late_cnn(tf, None, tl, train=True, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(late_cnn.encoders["imu_hand"].bn0.running_mean,
                           before["encoders.imu_hand.bn0.running_mean"])


def test_ensemble_uncertainty_matches_jax():
    jcfg, tcfg = _preset_configs("late_fusion")
    jmodel = JaxModel.from_config(jcfg)
    feats, lengths, _ = _batch(seed=12)
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    members, ports = [], []
    for seed in (12, 13):
        variables = _init(jmodel, tcfg, seed, jf, jnp.ones((4, 4)), jnp.asarray(lengths))
        members.append((jmodel, variables))
        port = MultimodalFusionModel.from_config(tcfg, device="cpu")
        port.load_state_dict(from_flax_variables(variables), strict=True)
        ports.append(port)
    args = (jf, jnp.asarray(MASKS), jnp.asarray(lengths))
    want = junc.EnsembleUncertainty(members).predict_with_uncertainty(*args)
    got = tunc.EnsembleUncertainty(ports).predict_with_uncertainty(
        {n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(MASKS),
        torch.from_numpy(lengths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the members disagree where a row has a modality; on the row with none
    # both give their biases' logits
    assert got[1].shape == (4,) and torch.all(got[1][[0, 1, 3]] > 0)
    with pytest.raises(ValueError, match="at least one model"):
        tunc.EnsembleUncertainty([]).predict_with_uncertainty()


# ---- training, evaluation and the CLI ----------------------------------------

MINI = """
dataset:
  name: synthetic
  data_dir: ./data/synthetic
  modalities: [imu_hand, imu_chest, heart_rate]
  num_classes: 4
  num_samples: 36
  sequence_length: 24
  modality_dim: 5
  batch_size: 8
model:
  fusion_type: {fusion}
  hidden_dim: 32
  output_dim: 16
  num_heads: 4
  dropout: 0.2
  encoders:
    imu_hand: {{type: sequence, input_dim: 5, encoder_type: {encoder}, num_layers: 1}}
    imu_chest: {{type: sequence, input_dim: 5, encoder_type: {encoder}, num_layers: 1}}
    heart_rate: {{type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}}
training:
  max_epochs: {epochs}
  learning_rate: 1e-3
  gradient_accumulation: 2
  label_smoothing: 0.05
  scheduler: cosine
  augmentation:
    temporal_jitter: 0.1
    gaussian_noise: 0.1
    modality_dropout: 0.2
evaluation:
  missing_modality_test: true
  uncertainty_analysis: true
  num_calibration_bins: 5
uncertainty:
  method: dropout
  num_mc_samples: 3
  temperature_scaling: true
experiment:
  name: mini
  save_dir: {save_dir}
  save_top_k: 2
seed: 3
"""


def _mini(tmp_path, fusion="hybrid", encoder="cnn", epochs=1):
    path = tmp_path / "mini.yaml"
    path.write_text(MINI.format(fusion=fusion, encoder=encoder, epochs=epochs,
                                save_dir=tmp_path / "runs"))
    return path


def _mini_windows():
    return tdata.create_datasets("synthetic", ".", ["imu_hand", "imu_chest", "heart_rate"],
                                 num_samples=36, num_classes=4, sequence_length=24,
                                 modality_dim=5, seed=3)


def test_trainer_moves_the_statistics_every_micro_step_and_resumes_bit_for_bit(tmp_path,
                                                                                monkeypatch):
    cfg = load_config(_mini(tmp_path, epochs=3))
    trainer = tt.Trainer(cfg, device="cpu")
    train_w = _mini_windows()[0]
    data = DeviceSplit.from_windows(train_w, device="cpu")
    trainer.init_state(steps_per_epoch=4)
    step = trainer.make_train_step_fn()
    bn = trainer.model.encoders["imu_hand"].bn0
    seen = [bn.running_mean.clone()]
    for i in range(2):  # accumulation 2: one update, two moves of the statistics
        step(data, torch.arange(8 * i, 8 * i + 8))
        seen.append(bn.running_mean.clone())
    assert trainer.optimizer.count == 1
    assert not torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])
    trainer.evaluate_logits(data)  # eval reads them and leaves them
    assert torch.equal(bn.running_mean, seen[-1])

    full = tt.Trainer(cfg, device="cpu")
    want = full.fit(*_mini_windows(), save_dir=tmp_path / "full", log_fn=None)

    class _Stop(Exception):
        pass

    class StopAfterEpochOne(tckpt.CheckpointManager):
        def save(self, variables, epoch, score, **kw):
            super().save(variables, epoch, score, **kw)
            if epoch == 1:
                raise _Stop

    monkeypatch.setattr(tt, "CheckpointManager", StopAfterEpochOne)
    with pytest.raises(_Stop):
        tt.Trainer(cfg, device="cpu").fit(*_mini_windows(), save_dir=tmp_path / "cut",
                                          log_fn=None)
    monkeypatch.undo()
    last = tmp_path / "cut" / "checkpoints" / "last"
    weights, _cfg, _meta = tckpt.load_checkpoint(last)
    assert "encoders.imu_hand.bn1.running_var" in weights
    resumed = tt.Trainer(cfg, device="cpu")
    got = resumed.fit(*_mini_windows(), save_dir=tmp_path / "cut", log_fn=None, resume_from=last)
    assert got["history"] == want["history"][2:]
    assert got["test_acc"] == want["test_acc"]
    full_state, resumed_state = full.model.state_dict(), resumed.model.state_dict()
    for name, value in full_state.items():  # weights and running statistics
        assert torch.equal(resumed_state[name], value), name


@pytest.mark.parametrize("fusion", ["early", "late", "uncertainty"])
def test_eval_writes_the_reference_files_for_each_fusion_type(tmp_path, capsys, fusion):
    """``train`` then ``eval`` (with plots) through the command surface; the
    files carry the keys of the reference's committed artifacts of that
    fusion type (``experiments/<type>``, or ``hybrid``'s where none is
    committed); no attention heatmap for a head without pair attention."""
    _mini(tmp_path, fusion=fusion, encoder="transformer")
    results = tcli.train_main(["--config-path", str(tmp_path), "--config-name", "mini",
                               "--device", "cpu"])
    out = tmp_path / "experiments"
    standard = tcli.eval_main(["--checkpoint", results["best_model_path"], "--output_dir",
                               str(out), "--analysis_dir", str(tmp_path / "analysis"),
                               "--missing_modality_test", "--device", "cpu"])
    assert "MC-dropout uncertainty analysis..." in capsys.readouterr().out
    assert standard["fusion_type"] == fusion and "attention_plot" not in standard
    committed = REPO / "experiments" / (fusion if fusion != "uncertainty" else "hybrid")
    for name in ("evaluation_results", "uncertainty", "missing_modality"):
        got = json.loads((out / f"{name}.json").read_text())
        want = json.loads((committed / f"{name}.json").read_text())
        assert set(want) - {"attention_plot"} <= set(got), (name, set(want) - set(got))
    assert {p.name for p in (tmp_path / "analysis" / fusion).iterdir()} == {"calibration.png"}
    unc = json.loads((out / "uncertainty.json").read_text())
    assert np.isfinite(unc["mc_dropout"]["mean_uncertainty"])
    missing = json.loads((out / "missing_modality.json").read_text())
    assert len(missing["all_combinations"]) == 7


def test_cnn_checkpoint_reloads_with_its_statistics_and_evaluates(tmp_path):
    _mini(tmp_path, fusion="late")
    results = tcli.train_main(["--config-path", str(tmp_path), "--config-name", "mini",
                               "--device", "cpu"])
    weights, cfg, _meta = tckpt.load_checkpoint(results["best_model_path"])
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    model.load_state_dict(weights, strict=True)
    assert not torch.all(model.encoders["imu_hand"].bn0.running_var == 1.0)
    test = DeviceSplit.from_windows(_mini_windows()[2], device="cpu")
    logits = teval.forward_all(model, test, 8)
    metrics = teval.evaluate_model(model, test, 8)
    assert np.isfinite(logits).all() and 0.0 <= metrics["accuracy"] <= 1.0


def _experiment_tree(root):
    for name, payload in (("late", {"test_accuracy": 0.5}), ("early", {"test_accuracy": 0.25}),
                          ("hybrid", {"test_accuracy": 0.75, "per_class_accuracy": {"1": 0.5}})):
        (root / name).mkdir(parents=True)
        (root / name / "evaluation_results.json").write_text(json.dumps(payload))
    (root / "no_results").mkdir()
    (root / "stray.json").write_text("{}")


@pytest.mark.parametrize("tree", ["synthetic", "committed", "missing"])
def test_aggregate_fusion_comparison_matches_jax(tmp_path, tree):
    if tree == "synthetic":
        source = tmp_path / "experiments"
        _experiment_tree(source)
    elif tree == "committed":
        source = REPO / "experiments"
    else:
        source = tmp_path / "nothing_here"
    want = jcli.aggregate_fusion_comparison(source, tmp_path / "jax" / "fusion_comparison.json")
    got = tcli.aggregate_fusion_comparison(source, tmp_path / "port" / "fusion_comparison.json")
    assert got == want
    assert ((tmp_path / "port" / "fusion_comparison.json").read_text()
            == (tmp_path / "jax" / "fusion_comparison.json").read_text())
    if tree == "synthetic":
        assert list(got["results"]) == ["early", "hybrid", "late"]
        tcli.aggregate_fusion_comparison(source)  # default: beside the experiments
        assert json.loads((source / "fusion_comparison.json").read_text()) == want
