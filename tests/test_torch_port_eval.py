"""PyTorch port, evaluation: ``evaluate_model``, the missing-modality sweep,
the attention maps, the calibration metrics, temperature scaling and the
uncertainty helpers against the JAX functions on the same weights, windows
and logits (hidden 32, T 24, one layer, synthetic data from a numpy seed);
the train and eval entry points end to end on the CPU against the committed
result files' keys; and the rule that the port imports nothing of JAX."""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu import evaluate as jeval
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu import uncertainty as junc
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.data import dataset as jdata
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import cli as tcli
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import evaluate as teval
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import uncertainty as tunc
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import from_flax_variables
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data import dataset as tdata
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multimodal_sensor_fusion_with_attention_rajeevatla_torch"
NAMES = ["imu_hand", "imu_chest", "heart_rate"]

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
  flash_attention: false
  fused_mlp: false
  fused_mlp_ln: false
  encoders:
    imu_hand: {type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}
    imu_chest: {type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}
    heart_rate: {type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}
training:
  max_epochs: 2
  learning_rate: 1e-3
  gradient_accumulation: 2
  label_smoothing: 0.05
  scheduler: cosine
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
  save_dir: SAVE_DIR
  save_top_k: 2
seed: 3
"""


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX model with its variables, the port's model with the same
    weights, and the same test windows on both sides."""
    cfg_file = tmp_path_factory.mktemp("cfg") / "mini.yaml"
    cfg_file.write_text(MINI)
    jcfg = jax_load_config(cfg_file)
    jmodel = JaxModel.from_config(jcfg)
    kw = dict(num_samples=60, num_classes=4, sequence_length=24, modality_dim=5, seed=3)
    jwin = jdata.create_datasets("synthetic", ".", NAMES, **kw)[2]
    twin = tdata.create_datasets("synthetic", ".", NAMES, **kw)[2]
    lengths = np.random.default_rng(0).integers(1, 25, jwin.num_windows).astype(np.int32)
    jwin.lengths[:] = lengths
    twin.lengths[:] = lengths
    feats = {m: jnp.asarray(jwin.features[m][:2]) for m in NAMES}
    variables = jmodel.init(jax.random.PRNGKey(7), feats, jnp.ones((2, 3)), jnp.asarray(lengths[:2]))
    model = MultimodalFusionModel.from_config(load_config(cfg_file), device="cpu")
    model.load_state_dict(
        from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return jmodel, variables, jwin, model, twin


def test_evaluate_model_matches_jax(pair):
    jmodel, variables, jwin, model, twin = pair
    want, (w_preds, w_labels, w_conf, w_logits) = jeval.evaluate_model(
        jmodel, variables, jwin, batch_size=8, return_predictions=True, include_logits=True)
    got, (preds, labels, conf, logits) = teval.evaluate_model(
        model, twin, batch_size=8, return_predictions=True, include_logits=True)
    assert logits.shape == (12, 4)  # 60 // 5 windows: batch 8 pads the last batch, cut again
    np.testing.assert_allclose(logits, w_logits, rtol=1e-5, atol=1e-5)  # f32 both sides
    np.testing.assert_array_equal(preds, w_preds)
    np.testing.assert_array_equal(labels, w_labels)
    np.testing.assert_allclose(conf, w_conf, rtol=1e-5)
    assert set(got) == set(want) == {"accuracy", "f1_macro", "loss", "num_samples"}
    assert got["accuracy"] == want["accuracy"] and got["num_samples"] == 12
    assert got["f1_macro"] == pytest.approx(want["f1_macro"], abs=1e-12)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert teval.evaluate_model(model, twin, batch_size=8) == got


def test_missing_modality_sweep_matches_jax(pair):
    jmodel, variables, jwin, model, twin = pair
    want = jeval.evaluate_missing_modalities(jmodel, variables, jwin, NAMES, batch_size=8)
    got = teval.evaluate_missing_modalities(model, twin, NAMES, batch_size=8)
    assert list(got) == list(want)
    assert list(got["all_combinations"]) == list(want["all_combinations"])
    assert len(got["all_combinations"]) == 7  # 2^3 - 1 subsets, size then lexicographic
    for name, metrics in want["all_combinations"].items():
        assert got["all_combinations"][name]["accuracy"] == metrics["accuracy"], name
        assert got["all_combinations"][name]["f1_macro"] == pytest.approx(metrics["f1_macro"])
    assert got["full_modalities"] == got["all_combinations"]["+".join(NAMES)]
    assert list(got["single_modalities"]) == NAMES
    for name in NAMES:
        assert got["modality_importance"][name] == pytest.approx(
            want["modality_importance"][name], abs=1e-9)
    masks, combos = teval._subset_masks(3)
    want_masks, want_combos = jeval._subset_masks(3)
    np.testing.assert_array_equal(masks, want_masks)
    assert combos == want_combos
    # the two-pass sweep equals zeroing the inputs and running the whole model
    data = DeviceSplit.from_windows(twin, device="cpu")
    preds, _ = teval.predict_all_subsets(model, data, batch_size=12)
    feats, _labels, lengths = data.gather(torch.arange(12))
    keep = torch.tensor([[1.0, 0.0, 1.0]]).expand(12, -1)
    zeroed = {m: feats[m] * keep[0, i] for i, m in enumerate(NAMES)}
    with torch.inference_mode():
        direct = model(zeroed, keep, lengths).argmax(-1)
    np.testing.assert_array_equal(preds[combos.index((0, 2))], direct.numpy())


def test_return_attention_matches_jax(pair):
    jmodel, variables, jwin, model, twin = pair
    feats = {m: jwin.features[m][:6] for m in NAMES}
    mask = np.ones((6, 3), np.float32)
    mask[1] = [1, 0, 1]
    mask[2] = [0, 0, 1]
    lengths = jwin.lengths[:6]
    w_logits, w_info = jmodel.apply(
        variables, {m: jnp.asarray(v) for m, v in feats.items()}, jnp.asarray(mask),
        jnp.asarray(lengths), train=False, return_attention=True)
    with torch.inference_mode():
        logits, info = model({m: torch.from_numpy(v) for m, v in feats.items()},
                             torch.from_numpy(mask), torch.from_numpy(lengths),
                             return_attention=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits), rtol=1e-5, atol=1e-5)
    assert list(info) == ["attention_maps", "fusion_weights"]
    assert list(info["attention_maps"]) == list(w_info["attention_maps"])
    assert "imu_hand_to_heart_rate" in info["attention_maps"]
    for key, want in w_info["attention_maps"].items():
        got = info["attention_maps"][key].numpy()
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(info["fusion_weights"].numpy(), np.asarray(w_info["fusion_weights"]),
                               rtol=1e-5, atol=1e-6)
    matrix = teval.attention_matrix(model, twin, NAMES, batch_size=8)
    assert matrix.shape == (3, 3) and np.all(np.diag(matrix) == 0)
    assert np.all(matrix[~np.eye(3, dtype=bool)] == 1.0)  # one key per pair: weight 1
    assert teval.attention_matrix(model, twin, [], 8) is None


def test_latency_measurements_are_finite(pair):
    _jmodel, _variables, _jwin, model, twin = pair
    mean, std = teval.measure_inference_latency(model, twin, batch_size=8, max_batches=2, warmup=1)
    assert mean > 0 and np.isfinite(std)
    data = DeviceSplit.from_windows(twin, device="cpu")
    assert teval.measure_amortized_latency(model, data, batch_size=8, repeats=1) > 0


def _logits_and_labels(seed=5, n=300, classes=6, scale=3.0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    logits = rng.standard_normal((n, classes)).astype(np.float32)
    logits[np.arange(n), labels] += 1.5  # informative, and over-confident once scaled
    return (scale * logits).astype(np.float32), labels


@pytest.mark.parametrize("num_bins", [15, 5])
def test_calibration_metrics_match_jax(num_bins):
    logits, labels = _logits_and_labels()
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    conf, preds = probs.max(-1), probs.argmax(-1)
    conf[:2] = [1.0, 0.0]  # the last bin is right-closed
    for name in ("expected_calibration_error", "maximum_calibration_error"):
        got = getattr(tunc.CalibrationMetrics, name)(conf, preds, labels, num_bins)
        want = getattr(junc.CalibrationMetrics, name)(conf, preds, labels, num_bins)
        assert got == pytest.approx(want, abs=1e-12), name
    assert tunc.CalibrationMetrics.negative_log_likelihood(logits, labels) == pytest.approx(
        junc.CalibrationMetrics.negative_log_likelihood(logits, labels), rel=1e-6)
    got = tunc.compute_calibration_metrics(logits, labels, num_bins=num_bins)
    want = junc.compute_calibration_metrics(logits, labels, num_bins=num_bins)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7), key
    halves = [(logits[:150], labels[:150]), (logits[150:], labels[150:])]
    assert tunc.compute_calibration_metrics(batches=halves, num_bins=num_bins) == got
    with pytest.raises(ValueError, match="no batches"):
        tunc.compute_calibration_metrics(batches=[])
    with pytest.raises(ValueError, match="Provide logits"):
        tunc.compute_calibration_metrics()


@pytest.mark.parametrize("scale", [3.0, 0.4])
def test_temperature_scaling_matches_jax(scale):
    logits, labels = _logits_and_labels(scale=scale)
    want = junc.TemperatureScaling()
    want.calibrate(logits, labels)
    got = tunc.TemperatureScaling()
    assert got.calibrate(logits, labels) == pytest.approx(want.temperature, abs=1e-3)
    assert (got.temperature > 1.0) == (scale == 3.0)  # over-confident logits are cooled
    np.testing.assert_allclose(got(logits), logits / got.temperature)
    assert torch.equal(got(torch.from_numpy(logits)), torch.from_numpy(logits) / got.temperature)


@pytest.mark.parametrize("shards", [True, False], ids=["shard-guard", "fold-guard"])
def test_guarded_temperature_matches_jax(shards):
    logits, labels = _logits_and_labels(seed=9, n=400)
    shard_ids = np.arange(400) // 100 if shards else None
    kw = dict(num_bins=15, overlap_factor=2, shard_ids=shard_ids)
    want = junc.TemperatureScaling().calibrate_guarded(logits, labels, **kw)
    got = tunc.TemperatureScaling().calibrate_guarded(logits, labels, **kw)
    assert got == pytest.approx(want, abs=1e-3)
    assert got > 1.0  # the guard accepts a temperature here, it does not just keep 1
    # too few effective windows: the temperature stays 1
    assert tunc.TemperatureScaling().calibrate_guarded(logits[:40], labels[:40]) == 1.0


def test_uncertainty_weighted_fusion_matches_jax():
    rng = np.random.default_rng(2)
    preds = {m: rng.standard_normal((5, 4)).astype(np.float32) for m in NAMES}
    uncs = {m: rng.random(5).astype(np.float32) for m in NAMES}
    mask = np.ones((5, 3), np.float32)
    mask[1] = [1, 0, 0]
    mask[2] = 0.0  # uniform fallback
    want_logits, want_w = junc.uncertainty_weighted_fusion(
        {m: jnp.asarray(v) for m, v in preds.items()}, {m: jnp.asarray(v) for m, v in uncs.items()},
        jnp.asarray(mask))
    got_logits, got_w = tunc.UncertaintyWeightedFusion()(
        {m: torch.from_numpy(v) for m, v in preds.items()},
        {m: torch.from_numpy(v) for m, v in uncs.items()}, torch.from_numpy(mask))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="No modality predictions"):
        tunc.uncertainty_weighted_fusion({}, {}, torch.ones(1, 1))
    with pytest.raises(KeyError, match="Missing uncertainty"):
        tunc.uncertainty_weighted_fusion({"a": torch.zeros(1, 2)}, {}, torch.ones(1, 1))


def test_mc_dropout_over_split(pair):
    _jmodel, _variables, _jwin, model, twin = pair
    data = DeviceSplit.from_windows(twin, device="cpu")
    mean, var = tunc.mc_dropout_over_split(model, data, num_samples=4, batch_size=8, seed=1)
    assert mean.shape == (12, 4) and var.shape == (12,)
    assert np.all(np.isfinite(mean)) and np.all(var > 0)  # dropout 0.2: the passes differ
    again = tunc.mc_dropout_over_split(model, data, num_samples=4, batch_size=8, seed=1)
    np.testing.assert_array_equal(again[0], mean)
    other = tunc.mc_dropout_over_split(model, data, num_samples=4, batch_size=8, seed=2)
    assert not np.array_equal(other[0], mean)
    feats, _labels, lengths = data.gather(torch.arange(8))
    one_mean, one_var = tunc.MCDropoutUncertainty(model, num_samples=4, seed=1)(
        feats, torch.ones(8, 3), lengths)
    # the first batch of the sweep: same generators, same draws
    np.testing.assert_allclose(one_mean.numpy(), mean[:8], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(one_var.numpy(), var[:8], rtol=1e-5, atol=1e-9)
    # the reference's definition (mean logits; class-probability variance
    # across samples, averaged over classes) on given sampled logits
    sampled = np.random.default_rng(3).standard_normal((4, 8, 4)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(sampled), axis=-1))
    g_mean, g_var = tunc._mean_and_variance(torch.from_numpy(sampled))
    np.testing.assert_allclose(g_mean.numpy(), sampled.mean(0), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g_var.numpy(), probs.var(0).mean(-1), rtol=1e-5, atol=1e-8)


def test_train_and_eval_entry_points_write_the_reference_files(tmp_path, capsys):
    """``train`` then ``eval`` through the command surface on the CPU; the
    result files carry the keys of the reference's committed artifacts."""
    cfg_file = tmp_path / "mini.yaml"
    cfg_file.write_text(MINI.replace("SAVE_DIR", str(tmp_path / "runs")))
    results = tcli.train_main(["--config-path", str(tmp_path), "--config-name", "mini",
                               "--device", "cpu", "training.max_epochs=1"])
    assert len(results["history"]) == 1
    best = Path(results["best_model_path"])
    assert best.parent == tmp_path / "runs" / "mini" / "checkpoints"
    out = tmp_path / "experiments"
    standard = tcli.eval_main(["--checkpoint", str(best), "--output_dir", str(out),
                               "--analysis_dir", str(tmp_path / "analysis"),
                               "--missing_modality_test", "--device", "cpu"])
    printed = capsys.readouterr().out
    for text in ("Standard Evaluation", "Test Accuracy:", "Missing Modality Robustness Test",
                 "MC-dropout uncertainty analysis...", "Evaluation complete!"):
        assert text in printed
    assert standard["test_accuracy"] == results["test_acc"]
    committed = REPO / "experiments" / "hybrid"
    for name in ("evaluation_results", "uncertainty", "missing_modality"):
        got = json.loads((out / f"{name}.json").read_text())
        want = json.loads((committed / f"{name}.json").read_text())
        assert set(want) <= set(got), (name, set(want) - set(got))
    files = {p.name for p in (tmp_path / "analysis" / "hybrid").iterdir()}
    assert files == {"calibration.png", "attention_viz.png"}
    unc = json.loads((out / "uncertainty.json").read_text())
    assert unc["mc_dropout"]["num_samples"] == 3 and unc["mc_dropout"]["num_windows"] == 12
    # without plots nothing is drawn and no plot path is recorded
    teval.evaluate_checkpoint(str(best), output_dir=str(tmp_path / "noplots"),
                              analysis_dir=str(tmp_path / "never"), device="cpu")
    assert not (tmp_path / "never").exists()
    assert "calibration_plot" not in json.loads((tmp_path / "noplots" / "uncertainty.json").read_text())
    assert not (tmp_path / "noplots" / "missing_modality.json").exists()


def test_command_surface_parses_like_the_reference():
    path, overrides, device = tcli._resolve_config_arg(
        ["-cn", "exp", "--config-path=/cfg", "model.dropout=0.1", "--device", "cpu", "--junk"])
    assert (path, overrides, device) == (Path("/cfg/exp.yaml"), ["model.dropout=0.1"], "cpu")
    path, overrides, device = tcli._resolve_config_arg([])
    assert path == REPO / "config" / "base.yaml" and overrides == [] and device is None
    # train, eval, analysis and preprocess are the commands; anything else is usage
    assert tcli.main([]) == 2 and tcli.main(["serve"]) == 2
    with pytest.raises(SystemExit):
        tcli.eval_main([])  # --checkpoint is required


def test_port_imports_nothing_of_jax():
    """No module of the port, not ``chip_smoke.py`` and no ``scripts/*_torch.py``
    imports jax, flax, optax, orbax or the JAX package."""
    banned = re.compile(
        r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|"
        r"multimodal_sensor_fusion_with_attention_rajeevatla_tpu)\b", re.MULTILINE)
    sources = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
               + sorted((REPO / "scripts").glob("*_torch.py")))
    assert len(sources) > 25
    for path in sources:
        found = banned.findall(path.read_text())
        assert not found, f"{path.relative_to(REPO)} imports {found}"
