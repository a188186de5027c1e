"""PyTorch port, the attention zoo against the JAX package's
``models/attention.py``: ``CrossModalAttention`` (3-D and 2-D queries and
keys, key masks with a row whose keys are all masked), ``TemporalAttention``
(``[B, T]``, ``[T]`` and no mask, ``pool_sequence``) and
``PairwiseModalityAttention`` (a missing modality), in eval mode on the
reference's own initialised weights through ``convert.from_flax_variables``,
within 1e-5; the train-mode dropout on the weights; and ``visualize_attention``
writing its heatmap."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_torch import convert
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models import attention as ja

TOL = 1e-5
B, H, HEADS = 3, 16, 4


def _load(module: torch.nn.Module, variables) -> torch.nn.Module:
    state = convert.from_flax_variables(jax.tree_util.tree_map(np.asarray, dict(variables)))
    module.load_state_dict(state)
    return module.eval()


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one torch thread, the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("q_len,k_len", [(5, 7), (None, 7), (5, None), (None, None)],
                         ids=["3d", "2d_query", "2d_key", "2d_both"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_cross_modal_attention_matches_the_reference(q_len, k_len, masked):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, q_len, 6) if q_len else (B, 6)).astype(np.float32)
    k = rng.standard_normal((B, k_len, 10) if k_len else (B, 10)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((B, k_len or 1)) > 0.3).astype(np.float32)
        mask[1] = 0.0  # every key masked: zero weights
        mask[0, 0] = 1.0
        if not k_len:
            mask = mask[:, 0]  # a [B] mask for 2-D keys
    jmod = ja.CrossModalAttention(hidden_dim=H, num_heads=HEADS, dropout=0.1)
    variables = jmod.init(jax.random.PRNGKey(1), q, k, v, mask)
    want_out, want_w = jmod.apply(variables, q, k, v, mask)
    port = _load(ta.CrossModalAttention(6, 10, H, HEADS, dropout=0.1), variables)
    got_out, got_w = port(*(torch.from_numpy(a) for a in (q, k, v)),
                          None if mask is None else torch.from_numpy(mask))
    assert tuple(got_out.shape) == want_out.shape and tuple(got_w.shape) == want_w.shape
    _close(got_out, want_out)
    _close(got_w, want_w)
    if masked:
        assert torch.all(got_w[1] == 0)


@pytest.mark.parametrize("mask_kind", ["none", "batch", "time"])
def test_temporal_attention_matches_the_reference(mask_kind):
    rng = np.random.default_rng(1)
    seq = rng.standard_normal((B, 8, 5)).astype(np.float32)
    mask = {"none": None,
            "batch": (np.arange(8)[None, :] < np.array([[8], [3], [1]])).astype(np.float32),
            "time": (np.arange(8) < 6).astype(np.float32)}[mask_kind]
    jmod = ja.TemporalAttention(hidden_dim=H, num_heads=HEADS)
    variables = jmod.init(jax.random.PRNGKey(2), seq, mask)
    want_out, want_w = jmod.apply(variables, seq, mask)
    port = _load(ta.TemporalAttention(5, H, HEADS), variables)
    got_out, got_w = port(torch.from_numpy(seq), None if mask is None else torch.from_numpy(mask))
    _close(got_out, want_out)
    _close(got_w, want_w)
    _close(ta.TemporalAttention.pool_sequence(torch.from_numpy(seq), got_w),
           ja.TemporalAttention.pool_sequence(jnp.asarray(seq), want_w))
    with pytest.raises(ValueError, match="Expected attention weights with 4 dims"):
        ta.TemporalAttention.pool_sequence(torch.from_numpy(seq), got_w[0])


@pytest.mark.parametrize("missing", [False, True], ids=["all", "one_missing"])
def test_pairwise_modality_attention_matches_the_reference(missing):
    rng = np.random.default_rng(2)
    dims = {"a": 6, "b": 9, "c": 4}
    feats = {m: rng.standard_normal((B, d)).astype(np.float32) for m, d in dims.items()}
    mask = np.ones((B, 3), np.float32)
    if missing:
        mask[0, 1] = 0.0
        mask[2, 2] = 0.0
    jmod = ja.PairwiseModalityAttention(modality_names=tuple(dims), hidden_dim=H,
                                        num_heads=HEADS)
    variables = jmod.init(jax.random.PRNGKey(3), feats, mask)
    want_feats, want_maps = jmod.apply(variables, feats, mask)
    port = _load(ta.PairwiseModalityAttention(dims, H, HEADS), variables)
    got_feats, got_maps = port({m: torch.from_numpy(x) for m, x in feats.items()},
                               torch.from_numpy(mask))
    assert sorted(got_feats) == sorted(want_feats) and sorted(got_maps) == sorted(want_maps)
    for m in dims:
        _close(got_feats[m], want_feats[m])
    for name in want_maps:
        _close(got_maps[name], want_maps[name])
    with pytest.raises(ValueError, match="No modalities provided"):
        ta.PairwiseModalityAttention({})


def test_train_mode_drops_attention_weights():
    torch.manual_seed(0)
    port = ta.TemporalAttention(5, H, HEADS, dropout=0.5)
    seq = torch.randn(B, 8, 5)
    _, eval_w = port(seq)
    _, train_w = port(seq, train=True, generator=torch.Generator().manual_seed(4))
    kept = train_w != 0
    assert 0 < kept.float().mean().item() < 1
    torch.testing.assert_close(train_w[kept], (eval_w / 0.5)[kept])


def test_visualize_attention_writes_a_heatmap(tmp_path: Path):
    weights = torch.rand(2, 4, 3, 3)  # leading dims averaged away
    out = tmp_path / "maps" / "attention.png"
    ta.visualize_attention(weights, ["a", "b", "c"], save_path=out)
    assert out.is_file() and out.stat().st_size > 1000
