"""PyTorch port, ``model.grouped_transformer``: ``GroupedTransformerEncoder``
against the JAX module on converted stacked weights (outputs and gradients,
with and without the flash route) and against the port's own per-modality
``SequenceEncoder``s carrying the same weights unstacked; the grouped model
against the JAX model (all modalities, one grouped modality missing), the
converter's round trip, the init, and a checkpoint reloaded from its
directory alone. The port runs on the CPU; the JAX side runs its Pallas
attention in interpret mode."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import grouped as jg
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
    from_flax_variables,
    to_flax_tree,
    ungroup_state_dict,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import grouped as tg
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.encoders import (
    SequenceEncoder,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
    CheckpointManager,
    load_checkpoint,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
G, B, T, HIDDEN, OUT, LAYERS = 3, 4, 24, 32, 16, 2
MEMBER_DIMS = (5, 5, 1)  # padded to the group's 5
TOL = dict(rtol=2e-5, atol=2e-5)  # f32 both sides, sums in another order
GRAD_TOL = 1e-4  # of each gradient's largest magnitude


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def _group_inputs(seed=0):
    rng = np.random.default_rng(seed)
    members = {f"m{i}": rng.standard_normal((B, T, d)).astype(np.float32)
               for i, d in enumerate(MEMBER_DIMS)}
    lengths = np.array([T, 0, 9, 17], np.int32)
    cot = rng.standard_normal((G, B, OUT)).astype(np.float32)
    return members, lengths, cot


@pytest.fixture(scope="module", params=[True, False], ids=["flash", "plain"])
def grouped_pair(request):
    """(JAX module, its variables, the port's module on the same weights)."""
    use_flash = request.param
    jenc = jg.GroupedTransformerEncoder(
        num_groups=G, hidden_dim=HIDDEN, output_dim=OUT, num_layers=LAYERS, dropout=0.0,
        use_flash=use_flash, dropout_rng="xla")
    members, lengths, _ = _group_inputs()
    stacked = jg.stack_group_features({n: jnp.asarray(v) for n, v in members.items()},
                                      list(members))
    variables = jenc.init(jax.random.PRNGKey(5), stacked, jnp.asarray(lengths))
    port = tg.GroupedTransformerEncoder(
        G, max(MEMBER_DIMS), hidden_dim=HIDDEN, output_dim=OUT, num_layers=LAYERS, dropout=0.0,
        use_flash=use_flash, dropout_rng="xla")
    state = from_flax_variables({"params": {"grouped_transformer_enc": jax.tree_util.tree_map(
        np.asarray, variables["params"])}})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)
    return jenc, variables, port.eval(), stacked


def test_stack_group_features_matches_jax(grouped_pair):
    _jenc, _variables, _port, stacked = grouped_pair
    members, _, _ = _group_inputs()
    got = tg.stack_group_features({n: torch.from_numpy(v) for n, v in members.items()},
                                  list(members))
    assert got.shape == (G, B, T, max(MEMBER_DIMS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(stacked))


@pytest.mark.parametrize("with_lengths", [True, False], ids=["lengths", "full"])
def test_grouped_encoder_matches_jax(grouped_pair, with_lengths):
    jenc, variables, port, stacked = grouped_pair
    _, lengths, _ = _group_inputs()
    want = jenc.apply(variables, stacked, jnp.asarray(lengths) if with_lengths else None)
    with torch.no_grad():
        got = port(torch.from_numpy(np.array(stacked)),
                   torch.from_numpy(lengths) if with_lengths else None)
    assert got.shape == (G, B, OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_encoder_gradients_match_jax(grouped_pair):
    jenc, variables, port, stacked = grouped_pair
    _, lengths, cot = _group_inputs()

    def loss_fn(params):
        out = jenc.apply({"params": params}, stacked, jnp.asarray(lengths), train=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out * cot)

    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(variables["params"]))))
    out = port(torch.from_numpy(np.array(stacked)), torch.from_numpy(lengths), train=True,
               generator=torch.Generator().manual_seed(0))
    (out * torch.from_numpy(cot)).sum().backward()
    got = dict(_flat(to_flax_tree(
        {f"grouped_tf_encoder.{n}": p.grad for n, p in port.named_parameters()}
    )["grouped_transformer_enc"]))
    port.zero_grad(set_to_none=True)
    assert sorted(got) == sorted(want) and len(want) == 4 + 16 * LAYERS
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        err = np.abs(got[name] - w).max() / max(np.abs(w).max(), floor)
        assert err < GRAD_TOL, f"{name}: rel err {err:.3e}"


def test_grouped_encoder_equals_per_modality_encoders(grouped_pair):
    """The reference's exact-function claim: the group's member g is the
    ``SequenceEncoder`` that carries the member's weights unstacked."""
    _jenc, _variables, port, _stacked = grouped_pair
    members, lengths, _ = _group_inputs()
    unstacked = ungroup_state_dict(
        {f"grouped_tf_encoder.{k}": v for k, v in port.state_dict().items()},
        list(members), {n: x.shape[-1] for n, x in members.items()})
    with torch.no_grad():
        got = port(tg.stack_group_features(
            {n: torch.from_numpy(v) for n, v in members.items()}, list(members)),
            torch.from_numpy(lengths))
        for g, (name, x) in enumerate(members.items()):
            enc = SequenceEncoder(x.shape[-1], hidden_dim=HIDDEN, output_dim=OUT,
                                  num_layers=LAYERS, encoder_type="transformer",
                                  flash_attention=port.use_flash, dropout=0.0).eval()
            own = f"encoders.{name}."
            enc.load_state_dict({k[len(own):]: v for k, v in unstacked.items()
                                 if k.startswith(own)}, strict=True)
            want = enc(torch.from_numpy(x), torch.from_numpy(lengths))
            assert (got[g] - want).abs().max().item() < 1e-5, name


def test_grouped_encoder_dropout_masks_cover_the_group():
    """Train mode: one draw per purpose for the whole group, in a fixed order;
    a seed repeats its masks, another seed draws others, eval draws none."""
    port = tg.GroupedTransformerEncoder(G, 5, hidden_dim=HIDDEN, output_dim=OUT, num_layers=1,
                                        dropout=0.3, use_flash=True, dropout_rng="auto")
    port.init_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((G, B, T, 5)).astype(np.float32))
    run = lambda seed: port(x, None, train=True,  # noqa: E731
                            generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    assert torch.equal(port(x), port(x))
    with pytest.raises(ValueError, match="Expected"):
        port(x[:2])


def test_groupable_transformer_modalities_matches_jax():
    base = dict(encoder_type="transformer", hidden_dim=32, num_layers=2, flash_attention=True,
                dropout_rng="auto")
    cases = [
        {n: dict(base) for n in NAMES},
        {**{n: dict(base) for n in NAMES[:3]}, "heart_rate": dict(base, encoder_type="lstm")},
        {**{n: dict(base) for n in NAMES[:3]}, "heart_rate": dict(base, num_layers=1)},
        {**{n: dict(base) for n in NAMES[:2]}, "imu_ankle": dict(base, moe_experts=4),
         "heart_rate": dict(base, type="mlp")},
        {"imu_hand": dict(base)},
    ]
    for configs in cases:
        assert tg.groupable_transformer_modalities(NAMES, configs) == \
            jg.groupable_transformer_modalities(NAMES, configs)


# ---- the whole model at model.grouped_transformer=true ----------------------

SMALL = ["model.hidden_dim=32", "model.output_dim=16", "model.dropout=0",
         "model.grouped_transformer=true"]


@pytest.fixture(scope="module")
def grouped_model_pair():
    jmodel = JaxModel.from_config(jax_load_config(REPO / "config" / "base.yaml", SMALL))
    rng = np.random.default_rng(7)
    feats = {n: rng.standard_normal((B, T, d)).astype(np.float32) for n, d in zip(NAMES, DIMS)}
    lengths = np.array([T, 7, 0, 13], np.int32)
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    variables = jmodel.init(jax.random.PRNGKey(3), jf, None, jnp.asarray(lengths))
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", SMALL), device="cpu")
    model.load_state_dict(from_flax_variables({"params": tree}), strict=True)
    return jmodel, variables, tree, model, (feats, jf, lengths)


def test_grouped_model_groups_all_four_modalities(grouped_model_pair):
    _jmodel, _variables, tree, model, _ = grouped_model_pair
    assert model.grouped_tf_names == NAMES and len(model.encoders) == 0
    assert "grouped_transformer_enc" in tree and not any(k.startswith("encoders_") for k in tree)
    enc = model.grouped_tf_encoder
    assert (enc.num_groups, enc.input_dim, enc.use_flash, enc.dropout_rng) == (4, 17, True, "auto")


def test_grouped_model_converter_round_trip(grouped_model_pair):
    _jmodel, _variables, tree, model, _ = grouped_model_pair
    want = dict(_flat(tree))
    got = dict(_flat(to_flax_tree(model)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_grouped_model_logits_match_jax(grouped_model_pair):
    jmodel, variables, _tree, model, (feats, jf, lengths) = grouped_model_pair
    mask = np.ones((B, 4), np.float32)
    mask[1, 2] = 0.0
    want = jmodel.apply(variables, jf, jnp.asarray(mask), jnp.asarray(lengths))
    with torch.no_grad():
        got = model({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask),
                    torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_model_with_a_missing_member_matches_jax(grouped_model_pair):
    """A grouped modality that is absent is zero-filled at its own width for
    the stacked pass and left out of the result."""
    jmodel, variables, _tree, model, (feats, jf, lengths) = grouped_model_pair
    missing = "imu_chest"
    want = jmodel.apply(variables, {n: v for n, v in jf.items() if n != missing},
                        jnp.asarray(lengths), method=JaxModel.encode)
    with torch.no_grad():
        got = model.encode({n: torch.from_numpy(v) for n, v in feats.items() if n != missing},
                           torch.from_numpy(lengths))
    assert sorted(got) == sorted(want) == sorted(n for n in NAMES if n != missing)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL)


def test_grouped_model_init_is_seeded_and_flax_shaped(grouped_model_pair):
    _jmodel, _variables, tree, _model, _ = grouped_model_pair
    cfg = load_config(REPO / "config" / "base.yaml", SMALL)
    a = MultimodalFusionModel.from_config(cfg, device="cpu")
    b = MultimodalFusionModel.from_config(cfg, device="cpu")
    got = dict(_flat(to_flax_tree(a)))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in _flat(tree)}
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    # lecun-normal with the group axis as batch axis: variance 1/fan_in per member
    kernel = got["grouped_transformer_enc/linear2_l0/kernel"]
    assert kernel.shape == (4, 2048, 32)
    assert kernel.std() == pytest.approx(2048 ** -0.5, rel=0.05)
    assert np.all(got["grouped_transformer_enc/linear2_l0/bias"] == 0)
    assert np.all(got["grouped_transformer_enc/norm1_l0/scale"] == 1)


def test_grouped_checkpoint_reloads_from_its_directory_alone(grouped_model_pair, tmp_path):
    _jmodel, _variables, _tree, model, (feats, _jf, lengths) = grouped_model_pair
    cfg = load_config(REPO / "config" / "base.yaml", SMALL)
    manager = CheckpointManager(tmp_path / "checkpoints", config=cfg, save_top_k=1)
    saved = manager.save(model.state_dict(), epoch=0, score=1.25)
    weights, ckpt_cfg, meta = load_checkpoint(saved)
    assert meta["epoch"] == 0 and bool(ckpt_cfg.model.grouped_transformer)
    reloaded = MultimodalFusionModel.from_config(ckpt_cfg, device="cpu")
    reloaded.load_state_dict(weights, strict=True)
    batch = {n: torch.from_numpy(v) for n, v in feats.items()}
    with torch.no_grad():
        want = model(batch, None, torch.from_numpy(lengths))
        assert torch.equal(reloaded(batch, None, torch.from_numpy(lengths)), want)
        # the ungrouped model on the same weights unstacked: the same function
        ungrouped = MultimodalFusionModel.from_config(
            load_config(REPO / "config" / "base.yaml", SMALL[:-1]), device="cpu")
        ungrouped.load_state_dict(
            ungroup_state_dict(weights, NAMES, dict(zip(NAMES, DIMS))), strict=True)
        got = ungrouped(batch, None, torch.from_numpy(lengths))
    assert (got - want).abs().max().item() < 1e-5


MINI = """
dataset:
  name: synthetic
  data_dir: ./data/synthetic
  modalities: [imu_hand, imu_chest, heart_rate]
  num_classes: 4
  num_samples: 60
  sequence_length: 24
  modality_dim: 5
  batch_size: 8
model:
  fusion_type: hybrid
  hidden_dim: 32
  output_dim: 16
  num_heads: 4
  dropout: 0.2
  grouped_transformer: true
  encoders:
    imu_hand: {type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}
    imu_chest: {type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}
    heart_rate: {type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}
training:
  max_epochs: 1
  learning_rate: 1e-3
  gradient_accumulation: 2
evaluation:
  num_calibration_bins: 5
uncertainty:
  method: dropout
  num_mc_samples: 2
experiment:
  name: grouped_mini
  save_dir: SAVE_DIR
  save_top_k: 1
seed: 3
"""


def test_train_then_eval_commands_on_a_grouped_model(tmp_path):
    """``train`` with ``model.grouped_transformer`` writes a checkpoint that
    ``evaluate_checkpoint`` scores from its directory alone (CPU)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch import cli, evaluate

    (tmp_path / "mini.yaml").write_text(MINI.replace("SAVE_DIR", str(tmp_path / "runs")))
    results = cli.train_main(["--config-path", str(tmp_path), "--config-name", "mini",
                              "--device", "cpu"])
    best = Path(results["best_model_path"])
    weights, ckpt_cfg, _meta = load_checkpoint(best)
    assert any(k.startswith("grouped_tf_encoder.") for k in weights)
    assert not any(k.startswith("encoders.") for k in weights)
    assert bool(ckpt_cfg.model.grouped_transformer)
    standard = evaluate.evaluate_checkpoint(
        str(best), config_path=str(tmp_path / "nowhere.yaml"), output_dir=str(tmp_path / "out"),
        analysis_dir=str(tmp_path / "analysis"), missing_modality_test=True, device="cpu")
    assert standard["test_accuracy"] == results["test_acc"]
    assert np.isfinite(standard["test_loss"])
