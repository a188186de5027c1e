"""PyTorch port, streamed training batches: ``StreamingDeviceLoader`` yields
every batch of ``BatchLoader`` as tensors; ``DeviceSplit.from_windows`` holds
the split in the reference's types; ``Trainer.fit`` with ``dataset.streaming=true`` equals
the resident ``fit`` bit for bit (dropout and every augmentation on, so each
step draws from the generator; the last batch padded), and its history is
within 1e-4 of the JAX ``fit`` streamed on the same weights and windows (the
configuration and the dropout-free set-up of ``test_torch_port_fit.py``'s
``test_fit_matches_jax_fit_over_two_epochs``). CPU only."""

import jax
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.data import dataset as jdata
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.train import trainer as jtrainer
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import from_flax_variables
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data import dataset as tdata
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import (
    DeviceSplit,
    StreamingDeviceLoader,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train import trainer as tt
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config
from test_torch_port_fit import _config_file, _windows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one torch thread, the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shuffle,dropout", [(False, 0.0), (True, 0.5)])
def test_loader_yields_every_batch_of_the_batch_loader(shuffle, dropout):
    train_w, _, _ = _windows(tdata)
    loader = tdata.BatchLoader(train_w, 8, shuffle=shuffle, seed=2, modality_dropout=dropout)
    loader.set_epoch(1)
    stream = StreamingDeviceLoader(loader, device="cpu")
    assert len(stream) == len(loader) == 5
    got = list(stream)
    want = list(loader)
    assert len(got) == len(want)
    for (gf, gl, gm, glen, gw), (wf, wl, wm, wlen, ww) in zip(got, want):
        assert list(gf) == list(wf) == train_w.modalities
        for m in wf:
            assert gf[m].dtype == torch.float32
            np.testing.assert_array_equal(gf[m].numpy(), wf[m])
        for g, w, dtype in ((gl, wl, torch.int32), (gm, wm, torch.float32),
                            (glen, wlen, torch.int32), (gw, ww, torch.float32)):
            assert isinstance(g, torch.Tensor) and g.dtype == dtype
            np.testing.assert_array_equal(g.numpy(), w)


def test_loader_streams_any_iterable_of_batch_tuples_one_ahead():
    """The next host batch is taken before the current one is handed over."""
    train_w, _, _ = _windows(tdata)
    batches = list(tdata.BatchLoader(train_w, 16))
    taken = []

    def source():
        for i, b in enumerate(batches):
            taken.append(i)
            yield b

    for i, _batch in enumerate(StreamingDeviceLoader(source(), device="cpu")):
        assert taken[-1] == min(i + 1, len(batches) - 1)
    assert taken == list(range(len(batches)))


def test_from_windows_holds_the_split_in_the_reference_types():
    """Features float32, labels and lengths int32, values unchanged (the
    reference's ``device_put_split`` at its default ``dtype``)."""
    train_w, _, _ = _windows(tdata)
    split = DeviceSplit.from_windows(train_w, device="cpu")
    assert split.modalities == tuple(train_w.modalities)
    assert split.num_windows == train_w.num_windows
    for m in train_w.modalities:
        assert split.features[m].dtype == torch.float32
        assert torch.equal(split.features[m], torch.from_numpy(train_w.features[m]))
    for got, want in ((split.labels, train_w.labels), (split.lengths, train_w.lengths)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _fit(tmp_path, streaming, model=None, **cfg_kwargs):
    cfg = load_config(_config_file(tmp_path, **cfg_kwargs),
                      [f"dataset.streaming={str(streaming).lower()}"])
    trainer = tt.Trainer(cfg, model=model, device="cpu")
    results = trainer.fit(*_windows(tdata), save_dir=tmp_path / f"run_{streaming}", log_fn=None)
    return trainer, results


def test_streamed_fit_equals_resident_fit_bit_for_bit(tmp_path, monkeypatch):
    """Dropout 0.2 and every augmentation on; 36 windows at batch 8, so the
    last batch is padded (weight 0 on four rows), over 2 epochs. The train
    split is never put on the device whole."""
    runs = {}
    real = DeviceSplit.from_windows
    for streaming in (False, True):
        whole = []
        monkeypatch.setattr(DeviceSplit, "from_windows", classmethod(
            lambda cls, w, device=None: whole.append(w.num_windows) or real(w, device)))
        trainer, results = _fit(tmp_path, streaming, dropout=0.2, aug=0.2)
        runs[streaming] = (results, trainer.model.state_dict(), whole)
    (res_r, state_r, whole_r), (res_s, state_s, whole_s) = runs[False], runs[True]
    assert res_s["history"] == res_r["history"]
    assert res_s["best_val_loss"] == res_r["best_val_loss"]
    assert res_s["test_acc"] == res_r["test_acc"]
    for name, t in state_r.items():
        assert torch.equal(state_s[name], t), name
    n_train = _windows(tdata)[0].num_windows
    assert whole_r[0] == n_train and n_train not in whole_s


def test_streamed_fit_matches_the_jax_streamed_fit(tmp_path):
    """Both sides stream from the same initial weights (dropout 0 and the
    augmentations off, so no random draw enters): history within 1e-4, as
    the resident fits are held (f32 both sides, ten AdamW steps)."""
    cfg_file = _config_file(tmp_path)
    jcfg = jax_load_config(cfg_file, ["dataset.streaming=true"])
    train_w, val_w, test_w = _windows(jdata)
    want = jtrainer.Trainer(jcfg).fit(train_w, val_w, test_w, save_dir=tmp_path / "jax",
                                      log_fn=None)
    boot = jtrainer.Trainer(jcfg)
    state = boot.init_state(next(iter(jdata.BatchLoader(train_w, 8))), steps_per_epoch=5)
    initial = jax.tree_util.tree_map(np.asarray, state.params)
    model = MultimodalFusionModel.from_config(load_config(cfg_file), device="cpu")
    model.load_state_dict(from_flax_variables({"params": initial}), strict=True)
    trainer, got = _fit(tmp_path, True, model=model)
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["train/loss"] == pytest.approx(w["train/loss"], abs=1e-4)
        assert g["val/loss"] == pytest.approx(w["val/loss"], abs=1e-4)
        assert g["train/acc"] == pytest.approx(w["train/acc"], abs=1e-6)
        assert g["val/acc"] == pytest.approx(w["val/acc"], abs=1e-6)
    assert got["test_acc"] == pytest.approx(want["test_acc"], abs=1e-6)
    assert trainer.optimizer.count == 5
