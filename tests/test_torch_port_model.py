"""PyTorch port, model layer: encoder layer, SequenceEncoder, HybridFusion,
the weight converter and the whole model, held against the JAX package with
converted weights on the same numpy inputs (eval mode, small widths)."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.encoders import (
    SequenceEncoder as JaxSequenceEncoder,
    _TransformerEncoderLayer as JaxLayer,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.fusion import (
    HybridFusion as JaxHybridFusion,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import from_flax_variables
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models import encoders as te
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.fusion import (
    EarlyFusion,
    HybridFusion,
    LateFusion,
    UncertaintyFusion,
    build_fusion_model,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multimodal_sensor_fusion_with_attention_rajeevatla_torch"
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = (17, 17, 17, 1)
SMALL = ["model.hidden_dim=32", "model.output_dim=16"]
# f32 on both sides; matmul sums and the layer norms round in another order,
# and the encoder's FFW is 2048 wide, so ~1e-5 relative is float32 rounding
TOL = dict(rtol=2e-5, atol=2e-5)


def _load(module, flax_params):
    module.load_state_dict(from_flax_variables({"params": flax_params}), strict=True)
    return module.eval()


def _seq(batch, seq, dim, seed):
    return np.random.default_rng(seed).standard_normal((batch, seq, dim)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_transformer_layer_matches_jax(use_flash):
    hidden, heads = 32, 4
    x = _seq(3, 20, hidden, seed=0)
    valid = np.array([20, 0, 13], np.int32)  # a length-0 row; 13 not a multiple of 8
    kpm = (np.arange(20)[None, :] < valid[:, None]).astype(np.float32)
    layer = JaxLayer(hidden_dim=hidden, num_heads=heads, dropout=0.0, use_flash=use_flash)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(kpm))
    want = layer.apply(variables, jnp.asarray(x), jnp.asarray(kpm))
    port = _load(te.TransformerEncoderLayer(hidden, heads, use_flash=use_flash), variables["params"])
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("with_lengths", [True, False], ids=["lengths", "full"])
def test_sequence_encoder_matches_jax(use_flash, with_lengths):
    x = _seq(4, 21, 17, seed=1)
    lengths = np.array([21, 0, 9, 16], np.int32) if with_lengths else None
    enc = JaxSequenceEncoder(
        hidden_dim=32, output_dim=16, num_layers=2, encoder_type="transformer",
        dropout=0.0, flash_attention=use_flash,
    )
    jl = None if lengths is None else jnp.asarray(lengths)
    variables = enc.init(jax.random.PRNGKey(1), jnp.asarray(x), jl)
    want = enc.apply(variables, jnp.asarray(x), jl)
    port = _load(
        te.SequenceEncoder(17, hidden_dim=32, output_dim=16, num_layers=2,
                           encoder_type="transformer", flash_attention=use_flash),
        variables["params"],
    )
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sequence_encoder_errors_keep_reference_strings():
    with pytest.raises(ValueError, match=re.escape("Unknown encoder type: rnn")):
        te.SequenceEncoder(4, encoder_type="rnn")
    # ported since: the cnn branch
    enc = te.SequenceEncoder(4, hidden_dim=8, output_dim=4, encoder_type="cnn")
    assert isinstance(enc.bn0, te.MaskedBatchNorm) and enc.conv1.in_channels == 8
    with pytest.raises(ValueError, match=re.escape("Expected 3D input sequence, got shape (2, 5)")):
        enc(torch.zeros(2, 5))
    for kind in ("lstm", "gru"):  # ported since: the recurrent branch
        enc = te.SequenceEncoder(4, hidden_dim=8, output_dim=4, num_layers=1, encoder_type=kind)
        assert isinstance(enc.rnn, te.RNNStack) and enc.rnn.cell_type == kind
        with pytest.raises(ValueError, match=re.escape("Expected 3D input sequence, got shape (2, 5)")):
            enc(torch.zeros(2, 5))
    enc = te.SequenceEncoder(4, hidden_dim=8, output_dim=4, num_layers=1, encoder_type="transformer")
    with pytest.raises(ValueError, match=re.escape("Expected 3D input sequence, got shape (2, 5)")):
        enc(torch.zeros(2, 5))
    # ported since: the frame and mlp routes, with the reference's strings
    video = te.build_encoder("video", 512, 16, {"temporal_pooling": "max"})
    assert isinstance(video, te.FrameEncoder) and video.temporal_pooling == "max"
    with pytest.raises(ValueError, match=re.escape("Expected 3D frame tensor, got shape (2, 512)")):
        video(torch.zeros(2, 512))
    with pytest.raises(ValueError, match=re.escape("Unknown pooling: sum")):
        te.build_encoder("video", 512, 16, {"temporal_pooling": "sum"})
    heart = te.build_encoder("heart_rate", 1, 16)  # the MLP encoder without type: sequence
    assert isinstance(heart, te.SimpleMLPEncoder)
    with pytest.raises(ValueError, match=re.escape("Expected 2D feature tensor, got shape (2, 5, 1)")):
        heart(torch.zeros(2, 5, 1))
    assert isinstance(
        te.build_encoder("heart_rate", 1, 16, {"type": "sequence", "encoder_type": "transformer"}),
        te.SequenceEncoder,
    )


@pytest.mark.parametrize(
    "mask_rows",
    [[[1, 1, 1, 1]] * 3, [[1, 0, 1, 0], [0, 0, 0, 0], [0, 0, 0, 1]]],
    ids=["all", "mixed-with-empty"],
)
def test_hybrid_fusion_matches_jax(mask_rows):
    rng = np.random.default_rng(2)
    feats = {n: rng.standard_normal((3, 16)).astype(np.float32) for n in NAMES}
    mask = np.asarray(mask_rows, np.float32)
    head = JaxHybridFusion(modality_names=NAMES, hidden_dim=32, num_classes=25, num_heads=4)
    jf = {n: jnp.asarray(v) for n, v in feats.items()}
    variables = head.init(jax.random.PRNGKey(2), jf, jnp.asarray(mask))
    want = head.apply(variables, jf, jnp.asarray(mask))
    port = _load(HybridFusion(NAMES, {n: 16 for n in NAMES}, 32, 25, 4), variables["params"])
    with torch.no_grad():
        got = port({n: torch.from_numpy(v) for n, v in feats.items()}, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(KeyError, match="Missing features for modality 'imu_chest' in HybridFusion"):
        port({n: torch.from_numpy(v) for n, v in feats.items() if n != "imu_chest"})


def test_build_fusion_model_routes():
    with pytest.raises(ValueError, match="Unknown fusion type: nope"):
        build_fusion_model("nope", {"a": 4}, 3)
    feats = {"a": torch.ones(2, 4), "b": torch.ones(2, 6)}
    # ported since: every fusion type of the reference
    for kind, cls in (("early", EarlyFusion), ("late", LateFusion), ("hybrid", HybridFusion),
                      ("uncertainty", UncertaintyFusion)):
        head = build_fusion_model(kind, {"a": 4, "b": 6}, 3, hidden_dim=8)
        assert type(head) is cls
        with torch.no_grad():
            out = head(feats)
        logits = out[0] if kind in ("late", "uncertainty") else out
        assert logits.shape == (2, 3) and torch.isfinite(logits).all()


@pytest.fixture(scope="module")
def small_pair():
    """(jax model, flax variables, port model, numpy features) at hidden 32."""
    overrides = SMALL + ["model.flash_attention=true"]
    jmodel = JaxModel.from_config(jax_load_config(REPO / "config" / "base.yaml", overrides))
    feats = {n: _seq(3, 24, d, seed=10 + i) for i, (n, d) in enumerate(zip(NAMES, DIMS))}
    variables = jmodel.init(jax.random.PRNGKey(3), {n: jnp.asarray(v) for n, v in feats.items()})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", overrides), device="cpu"
    )
    port.load_state_dict(from_flax_variables(variables), strict=True)
    return jmodel, variables, port, feats


def test_converter_round_trip_from_flax_init(small_pair):
    _jmodel, variables, port, _ = small_pair
    params = variables["params"]
    state = port.state_dict()
    flat = jax.tree_util.tree_leaves(params)
    assert len(state) == len(flat)  # every flax leaf has exactly one torch tensor
    assert sum(v.numel() for v in state.values()) == sum(a.size for a in flat)
    layer = params["encoders_imu_hand"]["layer0"]
    np.testing.assert_array_equal(
        state["encoders.imu_hand.layers.0.q_proj.weight"].numpy(), layer["q_proj"]["kernel"].T
    )
    np.testing.assert_array_equal(
        state["encoders.imu_hand.layers.0.norm2.weight"].numpy(), layer["norm2"]["scale"]
    )
    np.testing.assert_array_equal(
        state["layer_norms.heart_rate.bias"].numpy(), params["ln_heart_rate"]["bias"]
    )
    fusion = params["fusion_model"]
    np.testing.assert_array_equal(
        state["fusion_model.pairs.value_kernel"].numpy(), fusion["pairs"]["value_kernel"]
    )
    np.testing.assert_array_equal(
        state["fusion_model.gates.imu_ankle.weight"].numpy(), fusion["gate_imu_ankle"]["kernel"].T
    )
    np.testing.assert_array_equal(
        state["fusion_model.projections.imu_chest.weight"].numpy(),
        fusion["proj_imu_chest"]["kernel"].T,
    )


@pytest.mark.parametrize("missing", [None, "imu_chest"], ids=["all", "missing-mask"])
def test_model_forward_matches_jax(small_pair, missing):
    jmodel, variables, port, feats = small_pair
    lengths = np.array([24, 7, 0], np.int32)
    mask = np.ones((3, 4), np.float32)
    if missing:
        mask[:, NAMES.index(missing)] = 0.0
    want = jmodel.apply(
        variables, {n: jnp.asarray(v) for n, v in feats.items()}, jnp.asarray(mask),
        jnp.asarray(lengths),
    )
    with torch.no_grad():
        got = port({n: torch.from_numpy(v) for n, v in feats.items()},
                   torch.from_numpy(mask), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_port_init_is_seeded_and_flax_shaped():
    cfg = load_config(REPO / "config" / "base.yaml", SMALL)
    a = MultimodalFusionModel.from_config(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = MultimodalFusionModel.from_config(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    c = MultimodalFusionModel.from_config(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["fusion_model.pairs.value_kernel"], sc["fusion_model.pairs.value_kernel"])
    # lecun-normal: std 1/sqrt(fan_in), truncated at 2 sigma; pair kernels
    # use fan_in = P * H as flax computes it for [P, H, H]
    w = sa["encoders.imu_hand.layers.0.linear1.weight"]
    assert abs(w.std().item() - 32**-0.5) < 0.1 * 32**-0.5
    assert w.abs().max().item() <= 2 * 32**-0.5 / 0.87962566 + 1e-6
    pk = sa["fusion_model.pairs.query_kernel"]
    assert abs(pk.std().item() - (12 * 32) ** -0.5) < 0.1 * (12 * 32) ** -0.5
    assert torch.all(sa["layer_norms.imu_hand.weight"] == 1.0)
    assert torch.all(sa["fusion_model.classifier_out.bias"] == 0.0)
    assert not a.training


def test_from_config_rejects_unported_options():
    for override in ("mixed_precision=true", "model.moe_experts=4",
                     "parallel.pipeline_parallel=2"):
        cfg = load_config(REPO / "config" / "base.yaml", SMALL + [override])
        with pytest.raises(NotImplementedError, match="not ported"):
            MultimodalFusionModel.from_config(cfg, device="cpu")
    # ported since: the grouped transformer encoder and windows past the packed route
    cfg = load_config(REPO / "config" / "base.yaml",
                      SMALL + ["model.grouped_transformer=true", "dataset.chunk_size=1024"])
    grouped = MultimodalFusionModel.from_config(cfg, device="cpu")
    assert grouped.grouped_tf_names == NAMES and len(grouped.encoders) == 0
    feats = {n: torch.zeros(1, 520, d) for n, d in zip(NAMES, DIMS)}
    with torch.no_grad():
        assert grouped(feats).shape == (1, 25)
    # ported since: the lstm / gru encoders (one alone stays ungrouped)
    cfg = load_config(REPO / "config" / "base.yaml", SMALL + ["model.encoders.imu_hand.encoder_type=lstm"])
    mixed = MultimodalFusionModel.from_config(cfg, device="cpu")
    assert mixed.grouped_rnn_encoder is None and mixed.encoders["imu_hand"].encoder_type == "lstm"
    with torch.no_grad():
        assert mixed({n: x[:, :24] for n, x in feats.items()}).shape == (1, 25)
    # ported since: the cnn encoder
    cfg = load_config(REPO / "config" / "base.yaml", SMALL + ["model.encoders.imu_hand.encoder_type=cnn"])
    cnn = MultimodalFusionModel.from_config(cfg, device="cpu")
    assert cnn.encoders["imu_hand"].encoder_type == "cnn"
    assert "encoders.imu_hand.bn1.running_var" in cnn.state_dict()
    with torch.no_grad():
        assert cnn({n: x[:, :24] for n, x in feats.items()}).shape == (1, 25)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|flax|optax|jaxlib"
        r"|multimodal_sensor_fusion_with_attention_rajeevatla_tpu)\b|import_module|__import__",
        re.M,
    )
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())]
    assert offenders == []
    # and at run time: importing every port module loads neither
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "for m in %r: __import__(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'multimodal_sensor_fusion_with_attention_rajeevatla_tpu')]\n"
        "assert not bad, bad\n"
    ) % (str(REPO), modules)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
