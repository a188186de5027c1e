"""PyTorch port, the rest of the command surface: ``analysis.py`` against the
JAX package's (``_get_metric``, the file names ``generate_all_plots`` writes,
each plot drawn; matplotlib imported only when a plot is drawn), the
``analysis`` command, and the latency sweep over a loose iterable of batches
(``evaluate._latency_over_batches``) against the JAX one on the same
malformed and well-formed batches: the same warnings, in the same order, and
the same count of timed calls; a kernel or device fault is raised, not
skipped. CPU only."""

import importlib
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_tpu import analysis as janalysis
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu import evaluate as jeval
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.models.module import (
    MultimodalFusionModel as JaxModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_tpu.utils.config import (
    ConfigNode as JaxConfigNode,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import analysis as tanalysis
from multimodal_sensor_fusion_with_attention_rajeevatla_torch import evaluate as teval
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import to_flax_variables
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
    MultimodalFusionModel,
)
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops._build import KernelError
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import ConfigNode

PKG = "multimodal_sensor_fusion_with_attention_rajeevatla_torch"
DIMS = {"imu_hand": 5, "heart_rate": 1}
B, T = 4, 10
CONFIG = {
    "dataset": {"name": "pamap2", "modalities": list(DIMS), "num_classes": 5},
    "model": {"fusion_type": "hybrid", "hidden_dim": 16, "output_dim": 8, "num_heads": 2,
              "dropout": 0.1, "flash_attention": False, "fused_mlp": False,
              "encoders": {m: {"type": "sequence", "input_dim": d,
                               "encoder_type": "transformer", "num_layers": 1}
                           for m, d in DIMS.items()}},
}


# ---- the latency sweep over loose batches ------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one torch thread, the pool's size restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """The port's model (seeded, CPU) and the JAX model on its weights."""
    model = MultimodalFusionModel.from_config(ConfigNode(CONFIG), device="cpu",
                                              generator=torch.Generator().manual_seed(4))
    return model, JaxModel.from_config(JaxConfigNode(CONFIG)), to_flax_variables(model)


def _batches():
    rng = np.random.default_rng(2)
    feats = {m: rng.standard_normal((B, T, d)).astype(np.float32) for m, d in DIMS.items()}
    labels = rng.integers(0, 5, B).astype(np.int32)
    mask = np.ones((B, 2), np.float32)
    lengths = np.array([T, 3, 1, 7], np.int32)
    wide = {m: np.zeros((B, T, d + 2), np.float32) for m, d in DIMS.items()}
    return [
        42,                                   # unparseable
        ("not-a-mapping",),                   # unparseable
        ({}, labels),                         # empty features
        ({"imu_hand": "junk"}, labels),       # non-tensor feature
        ({"imu_hand": np.float32(1.0)}, None),  # no batch size to infer
        (wide, labels, mask, lengths),        # the model call fails
        (feats, labels, mask, lengths),       # timed, after its warm-up
        (feats, labels, mask, lengths),       # timed
        feats,                                # a new signature: warm-up again, timed
        (feats, labels, mask, lengths),       # beyond max_batches
    ]


class _Clock:
    """Stands in for a module's ``time``: counts ``perf_counter`` calls."""

    def __init__(self):
        self.calls = 0

    def perf_counter(self):
        self.calls += 1
        return float(self.calls)


def test_latency_sweep_skips_and_warns_as_the_reference(models, capsys, monkeypatch):
    model, jmodel, variables = models
    clocks = {}
    for name, module in (("jax", jeval), ("port", teval)):
        clocks[name] = _Clock()
        monkeypatch.setattr(module, "time", clocks[name])
    want = jeval.measure_inference_latency(jmodel, variables, _batches(), max_batches=9,
                                           warmup=2)
    want_out = capsys.readouterr().out
    got = teval.measure_inference_latency(model, _batches(), max_batches=9, warmup=2)
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert [line.strip() for line in got_out.splitlines()] == [
        "Warning: Unable to parse batch for latency measurement, skipping.",
        "Warning: Unable to parse batch for latency measurement, skipping.",
        "Warning: Empty feature dict encountered during latency measurement, skipping.",
        "Warning: Non-tensor feature encountered, skipping batch for latency measurement.",
        "Warning: Unable to infer batch size for latency measurement, skipping.",
        "Warning: Model call failed during latency measurement, skipping batch.",
    ]
    # three timed calls on each side, two clock readings each
    assert clocks["port"].calls == clocks["jax"].calls == 6
    assert got == want  # the fake clock: 1 / B ms per call, no spread


def test_latency_sweep_warms_up_once_per_signature(models, monkeypatch):
    model, _jmodel, _variables = models
    calls = []
    real = MultimodalFusionModel.forward
    monkeypatch.setattr(MultimodalFusionModel, "forward",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    mean, std = teval.measure_inference_latency(model, _batches(), max_batches=9, warmup=2)
    assert mean > 0 and np.isfinite(std)
    # the failing call warms up once (and raises), each of the two
    # signatures twice, and three calls are timed
    assert len(calls) == 1 + 2 * 2 + 3
    assert teval.measure_inference_latency(model, [1, 2, None]) == (0.0, 0.0)


def test_latency_sweep_reads_a_finite_generator_lazily(models):
    model, _jmodel, _variables = models
    taken = []

    def endless():
        while True:
            taken.append(1)
            yield _batches()[6]

    mean, _std = teval.measure_inference_latency(model, endless(), max_batches=3, warmup=1)
    assert mean > 0 and len(taken) == 3


@pytest.mark.parametrize("error", [
    KernelError("packed_attention_fwd failed to launch: CUDA error 9 (invalid configuration)"),
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
], ids=["kernel", "device"])
def test_latency_sweep_stops_on_a_kernel_or_device_fault(models, monkeypatch, capsys, error):
    """A batch's own failure is skipped (the reference's rule); a kernel
    that does not build or launch, or a fault on the device, is raised."""
    model, _jmodel, _variables = models

    def fails(self, *a, **k):
        raise error

    monkeypatch.setattr(MultimodalFusionModel, "forward", fails)
    with pytest.raises(type(error), match=str(error).split(":")[0]):
        teval.measure_inference_latency(model, _batches()[5:8], max_batches=3, warmup=1)
    assert "Model call failed" not in capsys.readouterr().out


# ---- analysis ---------------------------------------------------------------


def test_get_metric_equals_the_reference():
    cases = [({"accuracy": 0.5, "test_accuracy": 0.7}, ["accuracy", "test_accuracy"]),
             ({"test_accuracy": "0.25"}, ["accuracy", "test_accuracy"]),
             ({"latency_ms": 3}, ["inference_ms", "inference_ms_mean", "latency_ms"]),
             ({}, ["ece"])]
    for metrics, keys in cases:
        assert tanalysis._get_metric(metrics, keys) == janalysis._get_metric(metrics, keys)
    assert tanalysis._get_metric({}, ["x"], default=2.5) == 2.5


def _experiments(root: Path, names=("hybrid",)) -> Path:
    """An experiment directory per name with ``missing_modality.json``, and a
    ``fusion_comparison.json``, in the reference's schemas."""
    root.mkdir(parents=True, exist_ok=True)
    for name, acc in zip(names, (0.7, 0.6)):
        sub = root / name
        sub.mkdir(parents=True)
        sub.joinpath("missing_modality.json").write_text(json.dumps({
            "single_modalities": {"imu_hand": {"accuracy": acc - 0.2},
                                  "heart_rate": {"accuracy": 0.1}},
            "all_combinations": {"imu_hand": {"accuracy": acc - 0.2},
                                 "heart_rate": {"accuracy": 0.1},
                                 "imu_hand+heart_rate": {"accuracy": acc}},
        }))
    fusion = root / "fusion_comparison.json"
    fusion.write_text(json.dumps({"results": {
        "hybrid": {"test_accuracy": 0.7, "test_f1_macro": 0.6, "ece": 0.05, "latency_ms": 2.0},
        "late": {"accuracy": 0.6, "f1_macro": 0.5, "ece": 0.12, "inference_ms": 1.0}}}))
    return fusion


def test_generate_all_plots_writes_the_reference_files(tmp_path):
    pytest.importorskip("matplotlib")
    fusion = _experiments(tmp_path / "experiments")
    tanalysis.generate_all_plots(tmp_path / "experiments", tmp_path / "port", fusion)
    janalysis.generate_all_plots(tmp_path / "experiments", tmp_path / "jax", fusion)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["fusion_comparison.png", "hybrid_missing_modality.png"]
    assert all((tmp_path / "port" / n).stat().st_size > 0 for n in names)


def test_attention_and_calibration_plots_are_drawn(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    tanalysis.plot_attention_weights(rng.random((3, 2, 2)), ["a", "b"], tmp_path / "att.png")
    conf = rng.random(50)
    tanalysis.plot_calibration_diagram(conf, rng.integers(0, 3, 50), rng.integers(0, 3, 50),
                                       num_bins=5, save_path=tmp_path / "cal.png")
    assert (tmp_path / "att.png").stat().st_size > 0 and (tmp_path / "cal.png").stat().st_size > 0


def test_analysis_imports_matplotlib_only_to_draw(monkeypatch):
    """Without matplotlib (the card's machine) the module imports and reads
    metrics; a plot raises ``ImportError``."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    try:
        module = importlib.reload(tanalysis)
        assert module._get_metric({"ece": 0.2}, ["ece"]) == 0.2
        with pytest.raises(ImportError):
            module.plot_attention_weights(np.eye(2), ["a", "b"], "unused.png")
    finally:
        monkeypatch.undo()
        importlib.reload(tanalysis)


def test_analysis_command_draws_the_plots(tmp_path, monkeypatch, capsys):
    """``python -m <port> analysis --experiment_dir ... --fusion_file ...``."""
    pytest.importorskip("matplotlib")
    fusion = _experiments(tmp_path / "experiments", names=())
    monkeypatch.setattr(sys, "argv", [PKG, "analysis", "--experiment_dir",
                                      str(tmp_path / "experiments"), "--output_dir",
                                      str(tmp_path / "plots"), "--fusion_file", str(fusion)])
    with pytest.raises(SystemExit) as done:
        runpy.run_module(PKG, run_name="__main__", alter_sys=True)
    assert done.value.code == 0
    assert (tmp_path / "plots" / "fusion_comparison.png").exists()
    assert "Fusion comparison plot saved to" in capsys.readouterr().out


def test_main_lists_the_four_commands(capsys):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.cli import main

    assert main(["nonsense"]) == 2
    assert "{train|eval|analysis|preprocess}" in capsys.readouterr().err
