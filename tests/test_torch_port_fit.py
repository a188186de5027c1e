"""PyTorch port, fit to checkpoint: ``Trainer.fit`` against the JAX
``Trainer.fit`` from the same initial weights on the same synthetic windows
(hidden 32, T 24, one layer, dropout 0 and augmentations off, so that no
random draw enters), resume against an uninterrupted run, early stopping,
the checkpoint manager against the JAX one, a checkpoint reloaded from its
directory alone, and the copied numpy data pieces against the originals."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.data import dataset as jdata
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.train import checkpoint as jckpt
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.train import trainer as jtrainer
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
    from_flax_variables,
    to_flax_tree,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data import dataset as tdata
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import checkpoint as tckpt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
MODALITIES = ["imu_hand", "imu_chest"]

MINI = """
dataset:
  name: synthetic
  data_dir: ./data/synthetic
  modalities: [imu_hand, imu_chest]
  num_classes: 4
  num_samples: 36
  sequence_length: 24
  modality_dim: 5
  batch_size: 8
model:
  fusion_type: hybrid
  hidden_dim: 32
  output_dim: 16
  num_heads: 4
  dropout: {dropout}
  flash_attention: false
  fused_mlp: false
  fused_mlp_ln: false
  encoders:
    imu_hand: {{type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}}
    imu_chest: {{type: sequence, input_dim: 5, encoder_type: transformer, num_layers: 1}}
training:
  max_epochs: {epochs}
  learning_rate: 1e-3
  weight_decay: 1e-4
  optimizer: adamw
  scheduler: cosine
  gradient_clip_norm: 1.0
  gradient_accumulation: 2
  early_stopping_patience: {patience}
  label_smoothing: 0.05
  dropout_rng: auto
  augmentation:
    temporal_jitter: {aug}
    gaussian_noise: {aug}
    modality_dropout: {aug}
experiment:
  name: mini
  save_dir: ./runs
  save_top_k: 2
seed: 3
"""


def _config_file(tmp_path, dropout=0.0, epochs=2, patience=10, aug=0.0):
    path = tmp_path / "mini.yaml"
    path.write_text(MINI.format(dropout=dropout, epochs=epochs, patience=patience, aug=aug))
    return path


def _windows(module, cfg_seed=3):
    return module.create_datasets(
        "synthetic", ".", MODALITIES, num_samples=36, num_classes=4, sequence_length=24,
        modality_dim=5, seed=cfg_seed)


def test_fit_matches_jax_fit_over_two_epochs(tmp_path):
    """36 windows at batch 8: five micro-steps per epoch, the last one padded
    (weight 0 on four rows), accumulation 2, so an update spans the epoch
    boundary. History losses agree to 1e-4 (f32 both sides, ten AdamW steps)."""
    cfg_file = _config_file(tmp_path)
    jcfg = jax_load_config(cfg_file)
    train_w, val_w, test_w = _windows(jdata)
    want = jtrainer.Trainer(jcfg).fit(train_w, val_w, test_w, save_dir=tmp_path / "jax",
                                      log_fn=None)
    # the initial weights fit() starts from: the same seed and sample batch
    boot = jtrainer.Trainer(jcfg)
    state = boot.init_state(next(iter(jdata.BatchLoader(train_w, 8))), steps_per_epoch=5)
    initial = jax.tree_util.tree_map(np.asarray, state.params)

    cfg = load_config(cfg_file)
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    model.load_state_dict(from_flax_variables({"params": initial}), strict=True)
    trainer = tt.Trainer(cfg, model=model, device="cpu")
    lines = []
    got = trainer.fit(*_windows(tdata), save_dir=tmp_path / "torch", log_fn=lines.append)

    assert set(got) == set(want) == {"best_model_path", "best_val_loss", "config", "test_acc",
                                     "history", "train_wall_seconds"}
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"]
        assert g["train/loss"] == pytest.approx(w["train/loss"], abs=1e-4)
        assert g["val/loss"] == pytest.approx(w["val/loss"], abs=1e-4)
        assert g["train/acc"] == pytest.approx(w["train/acc"], abs=1e-6)
        assert g["val/acc"] == pytest.approx(w["val/acc"], abs=1e-6)
    assert got["best_val_loss"] == pytest.approx(want["best_val_loss"], abs=1e-4)
    assert got["test_acc"] == pytest.approx(want["test_acc"], abs=1e-6)
    assert Path(got["best_model_path"]).name == Path(want["best_model_path"]).name
    assert trainer.optimizer.count == 5  # ten micro-steps at accumulation 2
    on_disk = json.loads((tmp_path / "torch" / "results.json").read_text())
    assert on_disk["history"] == got["history"] and on_disk["config"]["seed"] == 3
    assert lines[0].startswith("epoch 0: train/loss=") and lines[-1].startswith("test/acc=")
    # the checkpoint directories carry the reference's names
    names = sorted(p.name for p in (tmp_path / "torch" / "checkpoints").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "checkpoints").iterdir())
    assert "last" in names and len(names) == 3


class _Stop(Exception):
    pass


def test_resume_repeats_an_uninterrupted_run(tmp_path, monkeypatch):
    """Dropout 0.2 and every augmentation on, so each step consumes the
    generator: a run stopped after epoch 1 and resumed from ``last`` must give
    epoch 2 of the uninterrupted run bit for bit (CPU), weights included."""
    cfg = load_config(_config_file(tmp_path, dropout=0.2, epochs=3, aug=0.1))
    full = tt.Trainer(cfg, device="cpu")
    want = full.fit(*_windows(tdata), save_dir=tmp_path / "full", log_fn=None)

    class StopAfterEpochOne(tckpt.CheckpointManager):
        def save(self, variables, epoch, score, **kw):
            super().save(variables, epoch, score, **kw)
            if epoch == 1:
                raise _Stop

    monkeypatch.setattr(tt, "CheckpointManager", StopAfterEpochOne)
    with pytest.raises(_Stop):
        tt.Trainer(cfg, device="cpu").fit(*_windows(tdata), save_dir=tmp_path / "cut",
                                          log_fn=None)
    monkeypatch.undo()
    last = tmp_path / "cut" / "checkpoints" / "last"
    state = tckpt.load_train_state(last)
    assert state["optimizer"]["count"] == 5 and state["optimizer"]["mini_step"] == 0
    assert len(state["optimizer"]["mu"]) == len(list(full.model.parameters()))

    resumed = tt.Trainer(cfg, device="cpu")
    lines = []
    got = resumed.fit(*_windows(tdata), save_dir=tmp_path / "cut", log_fn=lines.append,
                      resume_from=last)
    assert lines[0] == f"resumed from {last} at epoch 2"
    assert got["history"] == want["history"][2:]
    # the earlier checkpoints are adopted, their scores read back from the
    # directory names (four decimals, as in the reference)
    assert got["best_val_loss"] == pytest.approx(want["best_val_loss"], abs=1e-4)
    assert Path(got["best_model_path"]).name == Path(want["best_model_path"]).name
    assert got["test_acc"] == want["test_acc"]
    for a, b in zip(resumed.model.parameters(), full.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="No train_state"):
        tckpt.load_train_state(Path(got["best_model_path"]))


def test_early_stopping_stops_when_the_counter_reaches_patience(tmp_path, monkeypatch):
    cfg = load_config(_config_file(tmp_path, epochs=10, patience=2))
    trainer = tt.Trainer(cfg, device="cpu")
    _train_w, val_w, _test_w = _windows(tdata)
    calls = []

    def rising_val_loss(data, batch_size=None, model=None):
        # logits ever less sure of the right label: val loss rises every epoch
        calls.append(1)
        onehot = np.eye(4, dtype=np.float32)[val_w.labels]
        return onehot * (5.0 / len(calls))

    monkeypatch.setattr(trainer, "evaluate_logits", rising_val_loss)
    lines = []
    results = trainer.fit(*_windows(tdata)[:2], save_dir=tmp_path / "run", log_fn=lines.append)
    # epoch 0 is the best; epochs 1 and 2 are worse: the counter reaches 2 at epoch 2
    assert [h["epoch"] for h in results["history"]] == [0, 1, 2]
    assert lines[-1] == "early stopping at epoch 2 (patience 2)"
    assert Path(results["best_model_path"]).name.startswith("epoch=0-")
    assert "test_acc" not in results  # no test split given


def test_checkpoint_manager_tracks_top_k_like_the_reference(tmp_path):
    scores = [0.5, 0.4, 0.6, 0.3, 0.45, 0.0]
    jm = jckpt.CheckpointManager(tmp_path / "jax", save_top_k=2, adopt_existing=False)
    tm_ = tckpt.CheckpointManager(tmp_path / "torch", save_top_k=2, adopt_existing=False)
    for epoch, score in enumerate(scores):
        want = jm.save({"params": {"w": np.full((2,), score, np.float32)}}, epoch, score)
        got = tm_.save({"w": torch.full((2,), score)}, epoch, score)
        assert (got is None) == (want is None)
        assert (got and Path(got).name) == (want and Path(want).name)
        assert Path(tm_.best_model_path).name == Path(jm.best_model_path).name
        assert (tm_.best_model_score, tm_.best_model_epoch) == (
            jm.best_model_score, jm.best_model_epoch)
        assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == sorted(
            p.name for p in (tmp_path / "jax").iterdir())
    assert tm_.best_model_score == 0.0  # a score of 0.0 is a real score
    weights, config, meta = tckpt.load_checkpoint(tmp_path / "torch" / "last")
    assert meta == {"epoch": 5, "val_loss": 0.0} and config is None
    assert torch.equal(weights["w"], torch.zeros(2))
    # a resumed run adopts what is on disk; a fresh one does not
    adopted = tckpt.CheckpointManager(tmp_path / "torch", save_top_k=2, adopt_existing=True)
    assert Path(adopted.best_model_path).name == "epoch=5-val_loss=0.0000"
    assert adopted.best_model_epoch == 5
    fresh = tckpt.CheckpointManager(tmp_path / "torch", save_top_k=2, adopt_existing=False)
    assert fresh.best_model_path is None and fresh.best_model_score is None
    with pytest.raises(FileNotFoundError, match="Checkpoint not found"):
        tckpt.load_checkpoint(tmp_path / "nowhere")


@pytest.mark.parametrize("top_k", [0, -1])
def test_checkpoint_manager_top_k_zero_and_all(tmp_path, top_k):
    manager = tckpt.CheckpointManager(tmp_path, save_top_k=top_k)
    for epoch, score in enumerate([0.3, 0.2, 0.4, 0.5]):
        manager.save({"w": torch.zeros(1)}, epoch, score)
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == (["last"] if top_k == 0 else [
        "epoch=0-val_loss=0.3000", "epoch=1-val_loss=0.2000", "epoch=2-val_loss=0.4000",
        "epoch=3-val_loss=0.5000", "last"])


def test_checkpoint_reloads_from_its_directory_alone(tmp_path):
    cfg = load_config(_config_file(tmp_path, dropout=0.2))
    model = MultimodalFusionModel.from_config(cfg, device="cpu")
    manager = tckpt.CheckpointManager(tmp_path / "ckpt", config=cfg, save_top_k=1)
    path = manager.save(model.state_dict(), epoch=4, score=1.25, extra_meta={"note": "x"})
    assert Path(path).name == "epoch=4-val_loss=1.2500"
    weights, config, meta = tckpt.load_checkpoint(path)
    assert meta["epoch"] == 4 and meta["note"] == "x" and meta["config"]["seed"] == 3
    assert config.model.hidden_dim == 32 and list(config.dataset.modalities) == MODALITIES
    reloaded = MultimodalFusionModel.from_config(config, device="cpu")
    reloaded.load_state_dict(weights, strict=True)
    _train_w, _val_w, test_w = _windows(tdata)
    data = DeviceSplit.from_windows(test_w, device="cpu")
    trainer = tt.Trainer(cfg, model=model, device="cpu")
    want = trainer.evaluate_logits(data)
    assert want.shape == (7, 4)  # 36 // 5 windows: the padded tail is cut
    np.testing.assert_array_equal(trainer.evaluate_logits(data, model=reloaded), want)
    # another batch size pads and cuts differently; the products round otherwise
    np.testing.assert_allclose(trainer.evaluate_logits(data, batch_size=3), want, rtol=1e-5,
                               atol=1e-6)
    # the state_dict survives the trip through the flax layout
    back = from_flax_variables({"params": to_flax_tree(weights)})
    assert sorted(back) == sorted(weights)
    for name, tensor in weights.items():
        assert torch.equal(back[name], tensor), name


def test_optimizer_state_dict_round_trip_rejects_another_model():
    params = [torch.zeros(3), torch.zeros(2, 2)]
    opt = tt.AccumulatedAdamW(params, lambda count: 1e-3, accum=2)
    opt.step([torch.ones(3), torch.ones(2, 2)])
    state = opt.state_dict()
    assert state["mini_step"] == 1 and state["count"] == 0
    other = tt.AccumulatedAdamW([torch.zeros(3), torch.zeros(2, 2)], lambda count: 1e-3, accum=2)
    other.load_state_dict(state)
    assert other.mini_step == 1 and torch.equal(other.acc[0], opt.acc[0])
    with pytest.raises(ValueError, match="parameters"):
        tt.AccumulatedAdamW([torch.zeros(3)], lambda count: 1e-3).load_state_dict(state)


def test_fit_rejects_the_streaming_loader(tmp_path):
    """``dataset.streaming=true`` is no longer refused: the trainer builds and
    fits one epoch through the streaming loader on the CPU (its parity with
    the resident epoch and with JAX: ``test_torch_port_stream.py``)."""
    cfg = load_config(_config_file(tmp_path, epochs=1), ["dataset.streaming=true"])
    trainer = tt.Trainer(cfg, device="cpu")
    results = trainer.fit(*_windows(tdata)[:2], save_dir=tmp_path / "run", log_fn=None)
    assert len(results["history"]) == 1 and np.isfinite(results["history"][0]["train/loss"])
    assert trainer.optimizer.count == 2  # five micro-steps at accumulation 2
    assert (tmp_path / "run" / "checkpoints" / "last").is_dir()


# ------------------------------------------------------------ data, copied


def _same_windows(a, b):
    assert a.modalities == b.modalities
    for m in a.modalities:
        np.testing.assert_array_equal(a.features[m], b.features[m])
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.lengths, b.lengths)


def test_synthetic_datasets_equal_the_reference():
    for got, want in zip(_windows(tdata, 11), _windows(jdata, 11)):
        _same_windows(got, want)
    ds = tdata.SyntheticMultimodalDataset(num_samples=6, sequence_length=4, split="val", seed=2)
    ref = jdata.SyntheticMultimodalDataset(num_samples=6, sequence_length=4, split="val", seed=2)
    assert len(ds) == len(ref) == 6 and ds.modalities == ref.modalities
    feats, label, mask = ds[3]
    rfeats, rlabel, rmask = ref[3]
    assert label == rlabel and np.array_equal(mask, rmask)
    batch = tdata.collate_multimodal([ds[i] for i in range(3)])
    rbatch = jdata.collate_multimodal([ref[i] for i in range(3)])
    for got, want in zip(batch[1:], rbatch[1:]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(batch[0]["sensor2"], rbatch[0]["sensor2"])


@pytest.mark.parametrize("shuffle,drop_last,dropout", [(True, False, 0.7), (False, True, 0.0)])
def test_batch_loader_equals_the_reference(shuffle, drop_last, dropout):
    windows = _windows(tdata)[0]
    kw = dict(shuffle=shuffle, seed=5, modality_dropout=dropout, drop_last=drop_last)
    got_loader = tdata.BatchLoader(windows, 8, **kw)
    want_loader = jdata.BatchLoader(_windows(jdata)[0], 8, **kw)
    got_loader.set_epoch(2)
    want_loader.set_epoch(2)
    assert len(got_loader) == len(want_loader) == (4 if drop_last else 5)
    for got, want in zip(got_loader, want_loader):
        for m in MODALITIES:
            np.testing.assert_array_equal(got[0][m], want[0][m])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
        assert np.all(got[2].sum(axis=1) >= 1)  # never every modality dropped
    loaders = tdata.create_dataloaders("synthetic", ".", MODALITIES, batch_size=8, seed=3,
                                       num_samples=36, sequence_length=24, modality_dim=5,
                                       num_workers=2, pin_memory=True)
    assert [len(loader) for loader in loaders] == [5, 1, 1] and loaders[0].shuffle


def test_normalisation_and_missing_modalities_equal_the_reference():
    got_w, want_w = _windows(tdata)[0], _windows(jdata)[0]
    got_w.lengths[:5] = want_w.lengths[:5] = [24, 3, 0, 17, 1]
    got_stats = tdata.compute_normalization_stats(got_w)
    want_stats = jdata.compute_normalization_stats(want_w)
    for m in MODALITIES:
        for a, b in zip(got_stats[m], want_stats[m]):
            np.testing.assert_array_equal(a, b)
    _same_windows(tdata.apply_normalization(got_w, got_stats),
                  jdata.apply_normalization(want_w, want_stats))
    assert np.all(got_w.features["imu_hand"][1, 3:] == 0)  # padding stays zero
    feats = {m: got_w.features[m][:4] for m in MODALITIES}
    mask = np.ones((4, 2), np.float32)
    for pattern in (None, [1], [0, 1]):
        got = tdata.simulate_missing_modalities(feats, mask, pattern)
        want = jdata.simulate_missing_modalities(feats, mask, pattern)
        np.testing.assert_array_equal(got[1], want[1])
        for m in MODALITIES:
            np.testing.assert_array_equal(got[0][m], want[0][m])


def test_create_datasets_on_pamap2_equals_the_reference(tmp_path):
    """The real val and test splits (the small ones), instance-normalised,
    with the overlapping val stride the evaluation uses."""
    kw = dict(dataset_name="pamap2", data_dir=REPO / "data" / "pamap2",
              modalities=["imu_hand", "heart_rate"], chunk_size=512, normalize="instance",
              window_stride=512, val_window_stride=128, chunk_cache_dir=tmp_path / "cache")
    got = tdata.create_datasets(**kw)
    want = jdata.create_datasets(**kw)
    for g, w in zip(got[1:], want[1:]):
        _same_windows(g, w)
        np.testing.assert_array_equal(g.shard_ids, w.shard_ids)
    assert got[1].num_windows > got[2].num_windows > 0
