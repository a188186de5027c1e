"""PyTorch port, the serving bundle: ``serving.export_serving_bundle`` ->
``load_serving_bundle`` on the CPU for a hybrid, a late, a CNN and a grouped
LSTM model (``model.pallas_rnn`` on) of base.yaml at hidden 32, T 16: the
loaded bundle's logits equal ``make_serving_fn(device="cpu")``'s bit for bit
(the JAX package's ``tests/test_serving_export.py`` asserts the same of its
bundle) and the JAX model's on the converted weights within
``test_torch_port_serving.py``'s ``TOL``; the graph calls the kernels as
``msfa::`` ops; a fresh process that loads a bundle imports no module of the
port's ``models/``, ``train/`` or ``evaluate.py``; the export script; and
``torch.library.opcheck`` on each of the seven ops."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    load_config as jax_load_config,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import to_flax_variables
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import library
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import rnn as tr
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.fusion import _canonical_pairs
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import (
    export_serving_bundle,
    load_serving_bundle,
    make_serving_fn,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
    CheckpointManager,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import (
    ConfigNode,
    load_config,
)

REPO = Path(__file__).resolve().parent.parent
PKG = "multimodal_sensor_fusion_with_attention_rajeevatla_torch"
NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
DIMS = dict(zip(NAMES, (17, 17, 17, 1)))
B, T = 4, 16
# f32 both sides; four encoders and the head stacked, summed in another order
TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = ["model.hidden_dim=32", "model.output_dim=16", "model.dropout=0",
         "model.flash_attention=true"]
# case -> (overrides of base.yaml, the msfa:: op nodes of its graph)
CASES = {
    "hybrid": ([], {"packed_attention_fwd": 4, "fused_hybrid_head": 1}),
    "late": (["model.fusion_type=late"], {"packed_attention_fwd": 4}),
    "cnn": ([f"model.encoders.{n}.encoder_type=cnn" for n in NAMES],
            {"fused_hybrid_head": 1}),
    "grouped_lstm": (["model.pallas_rnn=true"]
                     + [f"model.encoders.{n}.encoder_type=lstm" for n in NAMES],
                     {"grouped_lstm_fused": 1, "fused_hybrid_head": 1}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one torch thread, the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _overrides(case):
    return [*SMALL, *CASES[case][0]]


def _requests():
    rng = np.random.default_rng(5)
    feats = {n: rng.standard_normal((B, T, d)).astype(np.float32) for n, d in DIMS.items()}
    lengths = np.array([T, 0, 9, 1], np.int32)
    mask = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 1], [1, 1, 0, 0]], np.float32)
    return feats, mask, lengths


def _export(case, out_dir):
    model = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", _overrides(case)), device="cpu",
        generator=torch.Generator().manual_seed(11))
    with torch.no_grad():  # BatchNorm statistics other than the initial ones
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(2))
    out = export_serving_bundle(model, out_dir, B, T, DIMS, device="cpu")
    return model, out, load_serving_bundle(out, device="cpu")[0]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """case -> (the port model, its bundle directory, the loaded function),
    each exported on the CPU."""
    return {case: _export(case, tmp_path_factory.mktemp(case)) for case in CASES}


@pytest.fixture(params=sorted(CASES))
def bundle(request, bundles):
    return (request.param, *bundles[request.param])


def test_bundle_has_the_reference_layout_and_names_its_ops(bundle):
    case, model, out, fn = bundle
    assert sorted(p.name for p in out.iterdir()) == ["bundle.json", "params.npz", "serving.pt2"]
    meta = json.loads((out / "bundle.json").read_text())
    assert meta["modalities"] == list(NAMES) and meta["feature_dims"] == DIMS
    assert (meta["batch_size"], meta["chunk_size"], meta["num_classes"]) == (B, T, 25)
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    assert meta["ops"] == CASES[case][1]
    exported = fn.exported  # serving.pt2, deserialized
    assert library.graph_ops(exported.graph) == CASES[case][1]
    # the graph holds no weight: every tensor is in params.npz
    assert not exported.state_dict and not exported.constants
    with np.load(out / "params.npz") as npz:
        state = model.state_dict()
        assert sorted(npz.files) == sorted(state)
        for name, t in state.items():
            np.testing.assert_array_equal(npz[name], t.numpy(), err_msg=name)


@pytest.mark.parametrize("request_kind", ["masked-with-lengths", "defaults"])
def test_loaded_bundle_equals_make_serving_fn_bit_for_bit(bundle, request_kind):
    _case, model, _out, fn = bundle
    feats, mask, lengths = _requests()
    tf = {n: torch.from_numpy(v) for n, v in feats.items()}
    serve = make_serving_fn(model, device="cpu")
    if request_kind == "defaults":  # a mask of ones, every length chunk_size
        got = fn(feats)
        want = serve(tf, torch.ones((B, 4)), torch.full((B,), T, dtype=torch.int32))
    else:
        got = fn(tf, torch.from_numpy(mask), torch.from_numpy(lengths))
        want = serve(tf, torch.from_numpy(mask), torch.from_numpy(lengths))
    assert got.shape == (B, 25) and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_loaded_fn_calls_its_module_on_its_weights(bundle):
    """``fn.graph(fn.params, ...)`` is ``fn`` without its defaults and input
    coercion; the weights are params.npz's, on the device."""
    _case, model, _out, fn = bundle
    feats, mask, lengths = _requests()
    tf = {n: torch.from_numpy(v) for n, v in feats.items()}
    tm, tl = torch.from_numpy(mask), torch.from_numpy(lengths)
    assert sorted(fn.params) == sorted(model.state_dict())
    with torch.inference_mode():
        got = fn.graph(fn.params, tf, tm, tl)
    assert torch.equal(got, fn(feats, mask, lengths))


def test_loaded_bundle_matches_jax(bundle):
    """The JAX model runs its plain XLA graph (its kernel flags off), the
    graph of the reference's own bundle."""
    case, model, _out, fn = bundle
    feats, mask, lengths = _requests()
    jmodel = JaxModel.from_config(jax_load_config(
        REPO / "config" / "base.yaml",
        [*_overrides(case), "model.flash_attention=false", "model.pallas_rnn=false"]))
    want = jax.jit(jmodel.apply)(to_flax_variables(model),
                                 {n: jnp.asarray(v) for n, v in feats.items()},
                                 jnp.asarray(mask), jnp.asarray(lengths))
    got = fn(feats, mask, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bundle_rejects_other_shapes(bundle):
    _case, _model, _out, fn = bundle
    bad = {n: np.zeros((B + 1, T, d), np.float32) for n, d in DIMS.items()}
    with pytest.raises(Exception):
        fn(bad)


def test_a_fresh_process_serves_the_bundles_without_the_model_code(bundles, tmp_path):
    """The loader imports ``ops/library.py`` (the ops) and nothing of
    ``models/``, ``train/`` or ``evaluate.py``: one fresh process loads the
    four bundles and serves the same request as ``make_serving_fn``."""
    feats, mask, lengths = _requests()
    np.savez(tmp_path / "request.npz", mask=mask, lengths=lengths, **feats)
    dirs = {case: str(out) for case, (_model, out, _fn) in bundles.items()}
    code = (
        "import sys, json, numpy as np, torch\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "torch.set_num_threads(1)\n"
        f"from {PKG}.serving import load_serving_bundle\n"
        f"r = np.load({str(tmp_path / 'request.npz')!r})\n"
        f"for case, path in {dirs!r}.items():\n"
        "    fn, meta = load_serving_bundle(path, device='cpu')\n"
        "    logits = fn({m: r[m] for m in meta['modalities']}, r['mask'], r['lengths'])\n"
        f"    np.save({str(tmp_path)!r} + f'/{{case}}.npy', logits.numpy())\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith('multimodal'))))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, check=True)
    modules = json.loads(done.stdout.strip().splitlines()[-1])
    assert f"{PKG}.ops.library" in modules and f"{PKG}.serving" in modules
    for part in (".models", ".train", ".evaluate"):
        assert not [m for m in modules if m.startswith(PKG + part)], modules
    assert not [m for m in modules if m.startswith("multimodal_sensor_fusion_with_attention"
                                                   "_rajeevatla_tpu")]
    tf = {n: torch.from_numpy(v) for n, v in feats.items()}
    for case, (model, _out, _fn) in bundles.items():
        want = make_serving_fn(model, device="cpu")(tf, torch.from_numpy(mask),
                                                     torch.from_numpy(lengths))
        np.testing.assert_array_equal(np.load(tmp_path / f"{case}.npy"), want.numpy())


def test_export_script_writes_a_loadable_bundle(tmp_path):
    """checkpoint -> scripts/export_serving_torch.py -> a bundle that serves
    the checkpoint's weights (two modalities, as the JAX package's test of
    its script)."""
    import importlib

    dims = {"imu_hand": 9, "heart_rate": 1}
    cfg = ConfigNode({
        "dataset": {"name": "pamap2", "modalities": list(dims), "num_classes": 7,
                    "batch_size": 4, "chunk_size": 12},
        "model": {"fusion_type": "hybrid", "hidden_dim": 16, "output_dim": 8, "num_heads": 2,
                  "dropout": 0.1, "flash_attention": True,
                  "encoders": {m: {"type": "sequence", "input_dim": d,
                                   "encoder_type": "transformer", "num_layers": 1}
                               for m, d in dims.items()}},
    })
    model = MultimodalFusionModel.from_config(cfg, device="cpu",
                                              generator=torch.Generator().manual_seed(3))
    mgr = CheckpointManager(tmp_path / "checkpoints", config=cfg)
    mgr.save(model.state_dict(), epoch=0, score=1.0)
    script = importlib.import_module("scripts.export_serving_torch")
    script.main(["--checkpoint", str(mgr.best_model_path), "--output_dir",
                 str(tmp_path / "bundle"), "--device", "cpu"])
    fn, meta = load_serving_bundle(tmp_path / "bundle", device="cpu")
    assert (meta["batch_size"], meta["chunk_size"]) == (4, 12)
    assert meta["ops"] == {"packed_attention_fwd": 2, "fused_hybrid_head": 1}
    rng = np.random.default_rng(4)
    feats = {m: torch.from_numpy(rng.standard_normal((4, 12, d)).astype(np.float32))
             for m, d in dims.items()}
    lengths = torch.tensor([12, 3, 0, 7], dtype=torch.int32)
    want = make_serving_fn(model, device="cpu")(feats, None, lengths)
    assert torch.equal(fn(feats, None, lengths), want)


# ---- the ops ----------------------------------------------------------------

# op name -> the kernel entry it registers (the head's: its unpacked adapter)
ENTRIES = {
    "packed_attention_fwd": ta.packed_attention_fwd,
    "packed_attention_fwd_bf16": ta.packed_attention_fwd_bf16,
    "flash_fwd_single": ta.flash_fwd_single,
    "flash_fwd_tiled": ta.flash_fwd_tiled,
    "fused_hybrid_head": library._head_entry,
    "grouped_lstm_fused": tr.grouped_lstm_fused,
    "grouped_gru_fused": tr.grouped_gru_fused,
}


def _op_cases():
    g = torch.Generator().manual_seed(0)
    lengths = torch.tensor([8, 0, 3], dtype=torch.int32)
    qkv = torch.randn(3, 8, 3 * 2 * 16, generator=g)
    q, k, v = (torch.randn(6, 8, 16, generator=g) for _ in range(3))
    hid, mods, ncls = 8, 3, 5
    pairs = _canonical_pairs(mods)
    npairs = len(pairs)
    head = (torch.relu(torch.randn(mods, 3, hid, generator=g)), torch.ones(3, mods),
            torch.randn(npairs, hid, hid, generator=g), torch.randn(npairs, hid, generator=g),
            torch.randn(npairs, hid, hid, generator=g), torch.randn(npairs, hid, generator=g),
            torch.randn(mods, hid, generator=g), torch.randn(mods, generator=g),
            torch.randn(hid, hid, generator=g), torch.randn(hid, generator=g),
            torch.randn(hid, ncls, generator=g), torch.randn(ncls, generator=g),
            [i for p in pairs for i in p])
    x = torch.randn(5, 2, 3, 4, generator=g)  # [T, G, B, D]
    return {
        "packed_attention_fwd": (qkv, lengths, 2, 0.25),
        "packed_attention_fwd_bf16": (qkv.bfloat16(), lengths, 2, 0.25),
        "flash_fwd_single": (q, k, v, lengths, 2, 0.25),
        "flash_fwd_tiled": (q, k, v, lengths, 2, 0.25, 4),
        "fused_hybrid_head": head,
        "grouped_lstm_fused": (x, torch.randn(2, 4, 4 * 6, generator=g),
                               torch.randn(2, 6, 4 * 6, generator=g),
                               torch.randn(2, 4 * 6, generator=g), lengths),
        "grouped_gru_fused": (x, torch.randn(2, 4, 3 * 6, generator=g),
                              torch.randn(2, 6, 3 * 6, generator=g),
                              torch.randn(2, 3 * 6, generator=g),
                              torch.randn(2, 3 * 6, generator=g), None),
    }


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_op_passes_opcheck_and_equals_its_entry_on_the_cpu(name):
    args = _op_cases()[name]
    op = getattr(library, name)
    torch.library.opcheck(op, args)
    with torch.inference_mode():
        got = op(*args)
    want = ENTRIES[name](*args)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(a, b)


def test_eval_forwards_reach_the_ops_and_training_the_autograd_functions(monkeypatch):
    """Without a gradient to record the attention and head entries are
    called through the ops; with one, through their autograd Functions."""
    calls = []
    real = torch.library.CustomOpDef.__call__

    def spy(self, *args, **kwargs):
        calls.append(self)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.library.CustomOpDef, "__call__", spy)
    qkv = torch.randn(2, 8, 3 * 2 * 16)
    with torch.no_grad():
        ta.flash_mha_packed(qkv, None, num_heads=2)
    assert calls == [library.packed_attention_fwd]
    calls.clear()
    ta.flash_mha_packed(qkv.requires_grad_(), None, num_heads=2).sum().backward()
    assert calls == [] and qkv.grad is not None
    q = torch.randn(1, 2, 600, 16)
    with torch.no_grad():
        ta.flash_self_attention(q, q, q)
    assert calls == [library.flash_fwd_single]
