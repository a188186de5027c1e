"""PyTorch port, the recurrent model family: the LSTM and GRU parity models
built by ``from_config`` (hidden 32, one layer per modality, grouped into one
``GroupedRNNEncoder``) against the JAX model on converted weights: eval logits
(all modalities, a masked one, a missing group member), one training step at
``model.pallas_rnn`` off and on, the converter's round trip of the grouped and the
ungrouped tree, the grouped model against the ungrouped one, serving, the
trainer, and a checkpoint. The JAX side runs its recurrence kernels in
interpret mode; the port runs on the CPU."""

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
    ungroup_state_dict,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import WindowedSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import evaluate_model
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.grouped import (
    GroupedRNNEncoder,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
    cross_entropy_loss,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
    CheckpointManager,
    load_checkpoint,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
B, T = 5, 22
SMOOTHING = 0.05
TOL = dict(rtol=2e-5, atol=2e-5)  # f32 both sides, sums in another order
GRAD_TOL = 1e-4  # of each gradient's largest magnitude


def rnn_overrides(cell, layers=1, pallas="true", extra=()):
    """base.yaml with every modality's encoder set to ``cell``, at hidden 32."""
    out = ["model.hidden_dim=32", "model.output_dim=16", "model.dropout=0",
           f"model.pallas_rnn={pallas}", *extra]
    for name in NAMES:
        out += [f"model.encoders.{name}.encoder_type={cell}",
                f"model.encoders.{name}.num_layers={layers}"]
    return out


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    feats = {n: rng.standard_normal((B, T, d)).astype(np.float32) for n, d in zip(NAMES, DIMS)}
    lengths = np.array([T, 7, 0, 13, 1], np.int32)
    labels = rng.integers(0, 25, B).astype(np.int32)
    return feats, lengths, labels


@pytest.fixture(scope="module", params=["lstm", "gru"])
def rnn_model_pair(request):
    """(cell, JAX model, its variables as numpy, the port's model on them)."""
    cell = request.param
    jmodel = JaxModel.from_config(jax_load_config(REPO / "config" / "base.yaml",
                                                  rnn_overrides(cell)))
    feats, lengths, _ = _batch()
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    variables = jmodel.init(jax.random.PRNGKey(3), jf, None, jnp.asarray(lengths))
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", rnn_overrides(cell)), device="cpu")
    model.load_state_dict(from_flax_variables({"params": tree}), strict=True)
    return cell, jmodel, variables, tree, model


def test_rnn_model_groups_all_four_modalities(rnn_model_pair):
    cell, _jmodel, _variables, tree, model = rnn_model_pair
    assert model.grouped_rnn_names == NAMES and len(model.encoders) == 0
    assert not model.grouped_tf_names
    assert "grouped_rnn" in tree and not any(k.startswith("encoders_") for k in tree)
    enc = model.grouped_rnn_encoder
    assert isinstance(enc, GroupedRNNEncoder)
    assert (enc.num_groups, enc.input_dim, enc.hidden_dim, enc.num_layers, enc.cell_type,
            enc.use_pallas) == (4, 17, 32, 1, cell, True)
    gates = 4 if cell == "lstm" else 3
    assert tuple(enc.weight_ih_l0.shape) == (4, 17, gates * 32)


def test_rnn_model_converter_round_trip(rnn_model_pair):
    _cell, _jmodel, _variables, tree, model = rnn_model_pair
    want = dict(_flat(tree))
    got = dict(_flat(to_flax_tree(model)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    again = from_flax_variables({"params": to_flax_tree(model)})
    assert all(torch.equal(again[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("masked", [None, "imu_chest"], ids=["all", "masked"])
def test_rnn_model_logits_match_jax(rnn_model_pair, masked):
    _cell, jmodel, variables, _tree, model = rnn_model_pair
    feats, lengths, _ = _batch()
    mask = np.ones((B, 4), np.float32)
    if masked:
        mask[:, NAMES.index(masked)] = 0.0
        mask[3] = [0, 0, 0, 1]
    want = jmodel.apply(variables, {n: jnp.asarray(v) for n, v in feats.items()},
                        jnp.asarray(mask), jnp.asarray(lengths))
    with torch.no_grad():
        got = model({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                    torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rnn_model_with_a_missing_member_matches_jax(rnn_model_pair):
    """An absent group member is zero-filled at its own width for the stacked
    recurrence and left out of the result."""
    _cell, jmodel, variables, _tree, model = rnn_model_pair
    feats, lengths, _ = _batch()
    missing = "heart_rate"  # the narrow member: its width is not the template's
    want = jmodel.apply(
        variables, {n: jnp.asarray(v) for n, v in feats.items() if n != missing},
        jnp.asarray(lengths), method=JaxModel.encode)
    with torch.no_grad():
        got = model.encode({n: torch.from_numpy(v) for n, v in feats.items() if n != missing},
                           torch.from_numpy(lengths))
    assert sorted(got) == sorted(want) == sorted(n for n in NAMES if n != missing)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL)


def test_rnn_model_training_raises_until_the_training_kernels_are_ported(rnn_model_pair):
    """The model at ``pallas_rnn=true`` trains (through ``grouped_*_trainable``,
    whose plain twins run on the CPU): every gradient is finite, and loss and
    gradients equal those of the ``pallas_rnn=false`` route on the same
    weights and seed."""
    cell, _jmodel, _variables, tree, model = rnn_model_pair
    feats, lengths, labels = _batch()
    plain = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", rnn_overrides(cell, pallas="false")),
        device="cpu")
    plain.load_state_dict(from_flax_variables({"params": tree}), strict=True)
    assert model.grouped_rnn_encoder.use_pallas and not plain.grouped_rnn_encoder.use_pallas
    routes = []
    for m in (model, plain):
        m.zero_grad()
        logits = m({n: torch.from_numpy(v) for n, v in feats.items()}, None,
                   torch.from_numpy(lengths), train=True,
                   generator=torch.Generator().manual_seed(4))
        loss = cross_entropy_loss(logits, torch.from_numpy(labels), SMOOTHING)
        loss.backward()
        routes.append((loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()}))
        m.zero_grad()
    (got_loss, got), (want_loss, want) = routes
    assert np.isfinite(got_loss) and got_loss == pytest.approx(want_loss, rel=1e-6)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert torch.isfinite(got[name]).all(), name
        assert (got[name] - w).abs().max() <= GRAD_TOL * max(w.abs().max(), 1e-30), name


@pytest.mark.parametrize("cell,layers,grouped,pallas", [
    ("lstm", 1, True, "false"), ("gru", 1, True, "false"), ("lstm", 2, False, "false"),
    ("lstm", 1, True, "true"), ("gru", 1, True, "true")])
def test_rnn_train_loss_and_every_gradient_match_jax(cell, layers, grouped, pallas):
    """One training step, dropout 0: the loss the JAX ``Trainer``
    differentiates and every parameter's gradient, compared through
    ``to_flax_tree``; grouped and (two layers) per-modality encoders. At
    ``model.pallas_rnn=true`` both sides train the grouped recurrence through
    ``grouped_*_trainable`` (JAX: its Pallas kernels in interpret mode)."""
    extra = () if grouped else ("model.grouped_encoders=false",)
    overrides = rnn_overrides(cell, layers, pallas=pallas, extra=extra)
    jmodel = JaxModel.from_config(jax_load_config(REPO / "config" / "base.yaml", overrides))
    feats, lengths, labels = _batch(seed=11)
    mask = np.ones((B, 4), np.float32)
    mask[:, NAMES.index("imu_chest")] = 0.0
    weight = np.array([1, 1, 1, 1, 0], np.float32)  # a padded row
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    variables = jmodel.init(jax.random.PRNGKey(5), jf, jnp.asarray(mask), jnp.asarray(lengths))

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, jf, jnp.asarray(mask), jnp.asarray(lengths),
                              train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_cross_entropy_loss(logits, jnp.asarray(labels), SMOOTHING,
                                      sample_weight=jnp.asarray(weight))

    want_loss, want_grads = jax.value_and_grad(loss_fn)(variables["params"])
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert ("grouped_rnn" in tree) == grouped

    model = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", overrides), device="cpu")
    model.load_state_dict(from_flax_variables({"params": tree}), strict=True)
    if not grouped:  # the ungrouped tree's way back is exact too
        for name, w in _flat(tree):
            np.testing.assert_array_equal(dict(_flat(to_flax_tree(model)))[name], w, err_msg=name)
    logits = model({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                   torch.from_numpy(lengths), train=True,
                   generator=torch.Generator().manual_seed(0))
    loss = cross_entropy_loss(logits, torch.from_numpy(labels), SMOOTHING,
                              sample_weight=torch.from_numpy(weight))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    got = dict(_flat(to_flax_tree({n: p.grad for n, p in model.named_parameters()})))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, want_grads)))
    assert sorted(got) == sorted(want)  # every parameter has its gradient
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        err = np.abs(got[name] - w).max() / max(np.abs(w).max(), floor)
        assert err < GRAD_TOL, f"{name}: rel err {err:.3e}"


def test_grouped_rnn_model_equals_the_ungrouped_model(rnn_model_pair, tmp_path):
    """A checkpoint of the grouped model reloads from its directory alone, and
    its weights unstacked give the ungrouped model the same function."""
    cell, _jmodel, _variables, _tree, model = rnn_model_pair
    cfg = load_config(REPO / "config" / "base.yaml", rnn_overrides(cell))
    saved = CheckpointManager(tmp_path / "checkpoints", config=cfg, save_top_k=1).save(
        model.state_dict(), epoch=0, score=1.5)
    weights, ckpt_cfg, _meta = load_checkpoint(saved)
    reloaded = MultimodalFusionModel.from_config(ckpt_cfg, device="cpu")
    reloaded.load_state_dict(weights, strict=True)
    feats, lengths, _ = _batch()
    batch = {n: torch.from_numpy(v) for n, v in feats.items()}
    ungrouped = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml",
                    rnn_overrides(cell, extra=("model.grouped_encoders=false",))), device="cpu")
    assert not ungrouped.grouped_rnn_names and sorted(ungrouped.encoders) == sorted(NAMES)
    ungrouped.load_state_dict(
        ungroup_state_dict(weights, (), dict(zip(NAMES, DIMS)), rnn_names=model.grouped_rnn_names),
        strict=True)
    with torch.no_grad():
        want = model(batch, None, torch.from_numpy(lengths))
        assert torch.equal(reloaded(batch, None, torch.from_numpy(lengths)), want)
        got = ungrouped(batch, None, torch.from_numpy(lengths))
    assert (got - want).abs().max().item() < 1e-5


def test_rnn_model_serves_and_is_evaluated_on_the_cpu(rnn_model_pair):
    _cell, _jmodel, _variables, _tree, model = rnn_model_pair
    feats, lengths, labels = _batch()
    batch = {n: torch.from_numpy(v) for n, v in feats.items()}
    serve = make_serving_fn(model, device="cpu")
    with torch.no_grad():
        want = model(batch, None, torch.from_numpy(lengths))
    torch.testing.assert_close(serve(batch, None, torch.from_numpy(lengths)), want,
                               rtol=1e-5, atol=1e-5)
    # a modality absent from the request: a zero embedding the mask rules out
    mask = torch.ones(B, 4)
    mask[:, 1] = 0.0
    partial = {n: v for n, v in batch.items() if n != "imu_chest"}
    with torch.no_grad():
        want = model({**partial, "imu_chest": torch.zeros(B, T, 17)}, mask,
                     torch.from_numpy(lengths))
    torch.testing.assert_close(serve(partial, mask, torch.from_numpy(lengths)), want,
                               rtol=1e-5, atol=1e-5)
    windows = WindowedSplit(features=feats, labels=labels, lengths=np.maximum(lengths, 1),
                            modalities=list(NAMES))
    metrics = evaluate_model(model, DeviceSplit.from_windows(windows, device="cpu"), batch_size=4)
    assert metrics["num_samples"] == B and np.isfinite(metrics["loss"])


def test_from_config_parses_pallas_rnn_and_the_ungrouped_routes():
    base = REPO / "config" / "base.yaml"
    for value, want in (("auto", True), ("true", True), ("false", False), ("0", False)):
        cfg = load_config(base, rnn_overrides("lstm", pallas=value))
        assert MultimodalFusionModel.from_config(cfg, device="cpu") \
            .grouped_rnn_encoder.use_pallas is want
    with pytest.raises(ValueError, match="Unknown pallas_rnn value"):
        MultimodalFusionModel.from_config(
            load_config(base, rnn_overrides("lstm", pallas="maybe")), device="cpu")
    # two layers group too (the plain loop); mixed cells do not group
    two = MultimodalFusionModel.from_config(
        load_config(base, rnn_overrides("gru", layers=2)), device="cpu")
    assert two.grouped_rnn_encoder.num_layers == 2 and two.grouped_rnn_names == NAMES
    mixed = MultimodalFusionModel.from_config(
        load_config(base, rnn_overrides("lstm") + ["model.encoders.heart_rate.encoder_type=gru",
                                                   "model.encoders.imu_ankle.encoder_type=transformer"]),
        device="cpu")
    assert mixed.grouped_rnn_encoder is None and sorted(mixed.encoders) == sorted(NAMES)
    assert mixed.encoders["heart_rate"].rnn.cell_type == "gru"
    feats, lengths, _ = _batch()
    with torch.no_grad():
        out = mixed({n: torch.from_numpy(v) for n, v in feats.items()}, None,
                    torch.from_numpy(lengths))
    assert out.shape == (B, 25) and torch.isfinite(out).all()
    # the seeded init covers the new modules: uniform +-H^-0.5, twice the same
    a = MultimodalFusionModel.from_config(load_config(base, rnn_overrides("lstm")), device="cpu")
    b = MultimodalFusionModel.from_config(load_config(base, rnn_overrides("lstm")), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    w = a.grouped_rnn_encoder.weight_hh_l0
    assert 0.9 * 32**-0.5 < w.abs().max().item() <= 32**-0.5
    assert abs(w.std().item() - 32**-0.5 / 3**0.5) < 0.05 * 32**-0.5


def _split(seed=5, n=16, t=T):
    rng = np.random.default_rng(seed)
    feats = {m: rng.standard_normal((n, t, d)).astype(np.float32) for m, d in zip(NAMES, DIMS)}
    windows = WindowedSplit(
        features=feats, labels=rng.integers(0, 25, n).astype(np.int32),
        lengths=rng.integers(1, t + 1, n).astype(np.int32), modalities=list(NAMES))
    return DeviceSplit.from_windows(windows, device="cpu")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_trainer_takes_steps_on_the_rnn_family_at_pallas_rnn_false(cell):
    """8 micro-steps (2 updates) with dropout and every augmentation on: the
    same seed twice gives the same losses; at ``pallas_rnn`` on (the training
    kernels' route) the trainer takes the first update's 4 micro-steps to the
    same losses."""
    split = _split()
    overrides = [o for o in rnn_overrides(cell, pallas="false") if o != "model.dropout=0"]
    runs = []
    for _ in range(2):
        trainer = tt.Trainer(load_config(REPO / "config" / "base.yaml", overrides), device="cpu")
        assert trainer.model.grouped_rnn_encoder.dropout == 0.2
        trainer.init_state(steps_per_epoch=2)
        step = trainer.make_train_step_fn()
        encoder = trainer.model.grouped_rnn_encoder
        before = [p.detach().clone() for p in encoder.parameters()]
        losses = [step(split, torch.arange(8) + 8 * (i % 2))[0].item() for i in range(8)]
        assert trainer.optimizer.count == 2 and np.all(np.isfinite(losses))
        assert all(not torch.equal(a, p) for a, p in zip(before, encoder.parameters()))
        runs.append(losses)
    assert runs[0] == runs[1]
    kernel = tt.Trainer(load_config(REPO / "config" / "base.yaml",
                                    [o for o in rnn_overrides(cell) if o != "model.dropout=0"]),
                        device="cpu")
    assert kernel.model.grouped_rnn_encoder.use_pallas
    kernel.init_state(steps_per_epoch=2)
    step = kernel.make_train_step_fn()
    losses = [step(split, torch.arange(8) + 8 * (i % 2))[0].item() for i in range(4)]
    assert kernel.optimizer.count == 1
    np.testing.assert_allclose(losses, runs[0][:4], rtol=1e-5)
