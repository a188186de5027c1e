"""PyTorch port, the whole serving slice: JAX ``make_serving_fn`` (Pallas
head and packed attention in interpret mode, f32) against the port's
``make_serving_fn(device="cpu")`` with converted weights; the data copies
against the JAX package's on the committed PAMAP2 shards; the device policy."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.data.dataset import (
    MultimodalDataset as JaxDataset,
    apply_instance_normalization as jax_instance_norm,
    padded_index_matrix as jax_index_matrix,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.serving import (
    make_serving_fn as jax_make_serving_fn,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import from_flax_variables
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
    MultimodalDataset,
    apply_instance_normalization,
    padded_index_matrix,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)


def _build_pair(overrides, batch, seq, seed):
    """JAX model + variables and the port model with the converted weights."""
    overrides = overrides + ["model.flash_attention=true"]
    jmodel = JaxModel.from_config(jax_load_config(REPO / "config" / "base.yaml", overrides))
    rng = np.random.default_rng(seed)
    feats = {n: rng.standard_normal((batch, seq, d)).astype(np.float32) for n, d in zip(NAMES, DIMS)}
    variables = jmodel.init(jax.random.PRNGKey(seed), {n: jnp.asarray(v) for n, v in feats.items()})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", overrides), device="cpu"
    )
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jmodel, variables, port, feats


def _serve_both(jmodel, variables, port, feats, mask, lengths):
    jserve = jax_make_serving_fn(jmodel, variables, use_pallas_head=True, interpret=True)
    want = jserve(
        {n: jnp.asarray(v) for n, v in feats.items()},
        None if mask is None else jnp.asarray(mask),
        None if lengths is None else jnp.asarray(lengths),
    )
    got = make_serving_fn(port, device="cpu")(
        {n: torch.from_numpy(v) for n, v in feats.items()},
        None if mask is None else torch.from_numpy(mask),
        None if lengths is None else torch.from_numpy(lengths),
    )
    return got.numpy(), np.asarray(want)


@pytest.fixture(scope="module")
def small():
    return _build_pair(["model.hidden_dim=32", "model.output_dim=16"], batch=4, seq=40, seed=0)


# f32 both sides; four encoders (FFW 2048 wide) and the head stacked, summed
# in another order: agreement to ~1e-5 relative
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    "case",
    ["all-modalities", "missing-modality", "default-mask-no-lengths", "empty-mask-row"],
)
def test_serving_slice_matches_jax(small, case):
    jmodel, variables, port, feats = small
    lengths = np.array([40, 0, 21, 33], np.int32)  # a length-0 row, non-multiples of 8
    mask = np.ones((4, 4), np.float32)
    if case == "missing-modality":
        # the modality is absent from the batch dict: a zero embedding, mask 0
        feats = {n: v for n, v in feats.items() if n != "imu_ankle"}
        mask[:, 2] = 0.0
    elif case == "default-mask-no-lengths":
        mask = lengths = None
    elif case == "empty-mask-row":
        mask[1] = 0.0  # uniform gate fallback
        mask[3] = [0, 0, 0, 1]
    got, want = _serve_both(jmodel, variables, port, feats, mask, lengths)
    assert got.shape == (4, 25) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_serving_slice_full_width_matches_jax():
    """base.yaml's own widths (hidden 256, 4 heads of 64, FFW 2048, output
    128, 25 classes) at T=512, B=2."""
    jmodel, variables, port, feats = _build_pair([], batch=2, seq=512, seed=1)
    lengths = np.array([512, 301], np.int32)
    mask = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32)
    got, want = _serve_both(jmodel, variables, port, feats, mask, lengths)
    # same f32 math at 8x the width: rounding grows with the 256/2048-wide sums
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)


def test_kernel_head_and_model_head_agree_on_cpu(small):
    _jmodel, _variables, port, feats = small
    tf = {n: torch.from_numpy(v) for n, v in feats.items()}
    lengths = torch.tensor([40, 3, 0, 17], dtype=torch.int32)
    mask = torch.tensor([[1, 1, 1, 1], [1, 0, 0, 1], [0, 0, 0, 0], [0, 1, 0, 0]], dtype=torch.float32)
    a = make_serving_fn(port, device="cpu")(tf, mask, lengths)
    b = make_serving_fn(port, device="cpu", use_kernel_head=False)(tf, mask, lengths)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, small):
    _jmodel, _variables, port, _feats = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serving_fn(port)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultimodalFusionModel.from_config(load_config(REPO / "config" / "base.yaml"))
    windows = MultimodalDataset(REPO / "data" / "pamap2", list(NAMES), "val", chunk_size=64).windows
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceSplit.from_windows(windows)
    assert make_serving_fn(port, device="cpu") is not None


@pytest.fixture(scope="module")
def val_windows():
    kwargs = dict(chunk_size=512, window_stride=128)
    ours = MultimodalDataset(REPO / "data" / "pamap2", list(NAMES), "val", **kwargs).windows
    ref = JaxDataset(REPO / "data" / "pamap2", list(NAMES), "val", **kwargs).windows
    return ours, ref


def test_dataset_copy_matches_jax_windows(val_windows):
    ours, ref = val_windows
    assert ours.num_windows == ref.num_windows > 0
    np.testing.assert_array_equal(ours.labels, ref.labels)
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    np.testing.assert_array_equal(ours.shard_ids, ref.shard_ids)
    for m in NAMES:
        np.testing.assert_array_equal(ours.features[m], ref.features[m])
    apply_instance_normalization(ours)
    jax_instance_norm(ref)
    for m in NAMES:
        np.testing.assert_array_equal(ours.features[m], ref.features[m])
    for n, b, shuffle in ((10, 4, False), (13, 8, True)):
        for a, r in zip(padded_index_matrix(n, b, shuffle, 3), jax_index_matrix(n, b, shuffle, 3)):
            np.testing.assert_array_equal(a, r)


def test_device_split_gather_and_serve_on_cpu(val_windows, small):
    ours, _ = val_windows
    split = DeviceSplit.from_windows(ours, device="cpu")
    idx = torch.tensor([3, 0, 3, split.num_windows - 1])
    feats, labels, lengths = split.gather(idx)
    for m in NAMES:
        np.testing.assert_array_equal(feats[m].numpy(), ours.features[m][idx.numpy()])
    np.testing.assert_array_equal(labels.numpy(), ours.labels[idx.numpy()])
    np.testing.assert_array_equal(lengths.numpy(), ours.lengths[idx.numpy()])
    _jmodel, _variables, port, _ = small
    logits = make_serving_fn(port, device="cpu")(feats, None, lengths)
    assert logits.shape == (4, 25) and torch.isfinite(logits).all()
