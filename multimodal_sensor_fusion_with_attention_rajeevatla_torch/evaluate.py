"""Evaluation: metrics, latency, missing-modality robustness, attention viz.
Port of the JAX package's ``evaluate.py``.

- ``evaluate_model``: accuracy / macro-F1 / loss / num_samples, optional
  ``(preds, labels, confidences[, logits])`` tuple.
- ``measure_inference_latency``: per-sample ms mean/std, one batch per timed
  call, fenced with ``torch.cuda.synchronize`` on the card;
  ``measure_amortized_latency``: the whole split enqueued back to back and
  fenced once.
- ``evaluate_missing_modalities``: all ``2^M - 1`` modality subsets. Each
  batch is encoded exactly twice (real inputs and zeroed inputs); the fusion
  head then runs once per subset mask on the chosen embeddings, which equals
  zeroing the inputs and re-running the whole model per subset.
- ``generate_attention_visualization``: hybrid-only M x M heatmap.
- ``evaluate_checkpoint``: the eval entry point's body. Loads a
  self-contained checkpoint and writes ``evaluation_results.json`` /
  ``uncertainty.json`` / ``missing_modality.json`` with the reference's key
  schema. ``run_evaluation`` is that plus the two plots (reliability diagram
  and attention heatmap), which need matplotlib.
"""

from __future__ import annotations

import itertools
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.dataset import WindowedSplit, create_datasets, padded_index_matrix
from .data.device import DeviceSplit
from .models.module import MultimodalFusionModel
from .ops.metrics import cross_entropy_loss, macro_f1
from .uncertainty import CalibrationMetrics
from .utils.device import resolve_device


def _model_device(model: MultimodalFusionModel) -> torch.device:
    return next(model.parameters()).device


def _device_split(model, windows: WindowedSplit | DeviceSplit) -> DeviceSplit:
    if isinstance(windows, DeviceSplit):
        return windows
    return DeviceSplit.from_windows(windows, device=_model_device(model))


def _batches(data: DeviceSplit, batch_size: int):
    """``([S, B] index matrix on the split's device, all-ones modality mask)``."""
    idx_mat, _ = padded_index_matrix(data.num_windows, batch_size)
    device = data.labels.device
    idx = torch.from_numpy(idx_mat).long().to(device)
    return idx, torch.ones((batch_size, len(data.modalities)), device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def forward_all(model: MultimodalFusionModel, data: DeviceSplit, batch_size: int = 32) -> np.ndarray:
    """Full-split eval-mode forward -> ``[N, C]`` logits (host numpy)."""
    n = data.num_windows
    idx_mat, mask = _batches(data, batch_size)
    out = []
    for idx in idx_mat:
        features, _labels, lengths = data.gather(idx)
        out.append(model(features, mask, lengths, train=False))
    if not out:
        return np.zeros((0, model.num_classes), np.float32)
    return torch.cat(out).cpu().numpy()[:n]


def evaluate_model(
    model: MultimodalFusionModel,
    windows: WindowedSplit | DeviceSplit,
    batch_size: int = 32,
    return_predictions: bool = False,
    include_logits: bool = False,
):
    """Standard evaluation: accuracy, macro-F1, loss, sample count."""
    data = _device_split(model, windows)
    logits = forward_all(model, data, batch_size)
    labels = data.labels.cpu().numpy()

    logits_t = torch.from_numpy(logits)
    probs = torch.softmax(logits_t, dim=-1).numpy()
    confidences = probs.max(axis=-1)
    preds = probs.argmax(axis=-1)
    loss = float(cross_entropy_loss(logits_t, torch.from_numpy(labels)))
    metrics = {
        "accuracy": float((preds == labels).mean()),
        "f1_macro": macro_f1(labels, preds),
        "loss": loss,
        "num_samples": int(labels.shape[0]),
    }
    if return_predictions:
        out: Tuple[np.ndarray, ...] = (preds, labels, confidences)
        if include_logits:
            out = (*out, logits)
        return metrics, out
    return metrics


@torch.inference_mode()
def measure_inference_latency(
    model: MultimodalFusionModel,
    windows: WindowedSplit | DeviceSplit,
    batch_size: int = 32,
    max_batches: int = 50,
    warmup: int = 3,
) -> Tuple[float, float]:
    """Per-sample latency (ms) mean/std of the eval forward, one batch per
    timed call: host clock around a forward that ends in a device fence."""
    data = _device_split(model, windows)
    device = data.labels.device
    idx_mat, mask = _batches(data, batch_size)
    if idx_mat.shape[0] == 0:
        return 0.0, 0.0

    def forward(idx):
        features, _labels, lengths = data.gather(idx)
        logits = model(features, mask, lengths, train=False)
        _sync(device)
        return logits

    for _ in range(warmup):
        forward(idx_mat[0])
    per_sample_ms: List[float] = []
    for idx in idx_mat[:max_batches]:
        t0 = time.perf_counter()
        forward(idx)
        per_sample_ms.append((time.perf_counter() - t0) / batch_size * 1000.0)
    arr = np.asarray(per_sample_ms)
    return float(arr.mean()), float(arr.std(ddof=0))


@torch.inference_mode()
def measure_amortized_latency(
    model: MultimodalFusionModel,
    data: DeviceSplit,
    batch_size: int = 32,
    repeats: int = 4,
) -> float:
    """Amortised per-window ms over whole-split sweeps: every batch is
    enqueued without waiting and the device is fenced once at the end, so
    host dispatch overlaps device work as in sustained serving."""
    device = data.labels.device
    idx_mat, mask = _batches(data, batch_size)
    if idx_mat.shape[0] == 0:
        return 0.0

    def sweep():
        for idx in idx_mat:
            features, _labels, lengths = data.gather(idx)
            model(features, mask, lengths, train=False)

    sweep()  # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        sweep()
    _sync(device)
    elapsed = time.perf_counter() - t0
    return elapsed / (repeats * idx_mat.shape[0] * batch_size) * 1000.0


# ---------------------------------------------------------------------------
# missing-modality robustness
# ---------------------------------------------------------------------------

def _subset_masks(num_modalities: int) -> Tuple[np.ndarray, List[Tuple[int, ...]]]:
    """All non-empty subsets, ordered by size then lexicographic."""
    combos: List[Tuple[int, ...]] = []
    for size in range(1, num_modalities + 1):
        combos.extend(itertools.combinations(range(num_modalities), size))
    masks = np.zeros((len(combos), num_modalities), np.float32)
    for i, combo in enumerate(combos):
        masks[i, list(combo)] = 1.0
    return masks, combos


@torch.inference_mode()
def predict_all_subsets(
    model: MultimodalFusionModel,
    data: DeviceSplit,
    batch_size: int = 32,
) -> Tuple[np.ndarray, List[Tuple[int, ...]]]:
    """Predictions under every modality subset: ``[S, N]`` class ids. Per
    batch the encoders run twice (real + zero input), then the fusion head
    once per subset mask."""
    masks_np, combos = _subset_masks(len(data.modalities))
    n = data.num_windows
    idx_mat, _ones = _batches(data, batch_size)
    masks = torch.from_numpy(masks_np).to(data.labels.device)  # [S, M]
    preds = []
    for idx in idx_mat:
        features, _labels, lengths = data.gather(idx)
        enc_real = model.encode(features, lengths)
        enc_zero = model.encode({m: torch.zeros_like(v) for m, v in features.items()}, lengths)
        per_subset = []
        for keep, mask_row in zip(masks_np, masks):  # keep: the host's copy of the row
            enc = {m: enc_real[m] if keep[i] > 0 else enc_zero[m]
                   for i, m in enumerate(data.modalities)}
            logits = model.fuse(enc, mask_row[None, :].expand(batch_size, -1))
            per_subset.append(logits.argmax(dim=-1))
        preds.append(torch.stack(per_subset))  # [S, B]
    if not preds:
        return np.zeros((len(combos), 0), np.int64), combos
    return torch.cat(preds, dim=1).cpu().numpy()[:, :n], combos


def _compute_modality_importance(
    results: Dict[str, Any], modality_names: Sequence[str]
) -> Dict[str, float]:
    """Importance = mean(acc with modality) - mean(acc without), abs-normalised."""
    importance: Dict[str, float] = {}
    for modality in modality_names:
        with_scores, without_scores = [], []
        for combo_name, metrics in results["all_combinations"].items():
            if modality in combo_name.split("+"):
                with_scores.append(metrics["accuracy"])
            else:
                without_scores.append(metrics["accuracy"])
        if with_scores and without_scores:
            importance[modality] = float(np.mean(with_scores) - np.mean(without_scores))
        else:
            importance[modality] = 0.0
    total = sum(abs(v) for v in importance.values())
    if total > 0:
        importance = {k: v / total for k, v in importance.items()}
    return importance


def evaluate_missing_modalities(
    model: MultimodalFusionModel,
    windows: WindowedSplit | DeviceSplit,
    modality_names: Sequence[str],
    batch_size: int = 32,
) -> Dict[str, Any]:
    """Robustness over all ``2^M - 1`` modality subsets (one pass)."""
    data = _device_split(model, windows)
    labels = data.labels.cpu().numpy()
    preds, combos = predict_all_subsets(model, data, batch_size)

    results: Dict[str, Any] = {
        "full_modalities": {},
        "single_modalities": {},
        "all_combinations": {},
    }
    num_mod = len(modality_names)
    for subset_preds, combo in zip(preds, combos):
        subset_names = [modality_names[i] for i in combo]
        metrics = {
            "accuracy": float((subset_preds == labels).mean()),
            "f1_macro": macro_f1(labels, subset_preds),
        }
        results["all_combinations"]["+".join(subset_names)] = metrics
        if len(combo) == 1:
            results["single_modalities"][subset_names[0]] = metrics
        if len(combo) == num_mod:
            results["full_modalities"] = metrics
    results["modality_importance"] = _compute_modality_importance(results, modality_names)
    return results


# ---------------------------------------------------------------------------
# attention visualisation
# ---------------------------------------------------------------------------

@torch.inference_mode()
def attention_matrix(
    model: MultimodalFusionModel,
    windows: WindowedSplit | DeviceSplit,
    modality_names: Sequence[str],
    batch_size: int = 32,
) -> Optional[np.ndarray]:
    """Mean cross-modal attention weight per (query, key) modality pair over
    the first batch -> ``[M, M]`` (zero diagonal), or ``None`` when the model
    has no pair attention to show."""
    if not modality_names or model.fusion_type != "hybrid":
        return None
    data = _device_split(model, windows)
    n = min(batch_size, data.num_windows)
    idx = torch.arange(n, device=data.labels.device)
    features, _labels, lengths = data.gather(idx)
    mask = torch.ones((n, len(data.modalities)), device=data.labels.device)
    _logits, attention_info = model(features, mask, lengths, train=False, return_attention=True)
    attention_maps = attention_info.get("attention_maps", {})
    if not attention_maps:
        return None
    names = list(modality_names)
    matrix = np.zeros((len(names), len(names)), np.float32)
    for key, weights in attention_maps.items():
        q_mod, _, k_mod = key.partition("_to_")
        if q_mod in names and k_mod in names:
            matrix[names.index(q_mod), names.index(k_mod)] = float(weights.mean())
    return matrix


def generate_attention_visualization(
    model: MultimodalFusionModel,
    windows: WindowedSplit | DeviceSplit,
    modality_names: Sequence[str],
    save_path: Path | str,
    batch_size: int = 32,
) -> Optional[Path]:
    """Hybrid-only M x M mean-attention heatmap, saved to ``save_path``."""
    matrix = attention_matrix(model, windows, modality_names, batch_size)
    if matrix is None:
        return None
    num_mod = len(modality_names)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(matrix, cmap="magma", aspect="equal")
    ax.set_xticks(range(num_mod))
    ax.set_yticks(range(num_mod))
    ax.set_xticklabels(modality_names, rotation=45, ha="right")
    ax.set_yticklabels(modality_names)
    ax.set_xlabel("Key Modality")
    ax.set_ylabel("Query Modality")
    ax.set_title("Cross-Modal Attention Heatmap")
    fig.colorbar(im, ax=ax, shrink=0.8)
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(save_path, dpi=300)
    plt.close(fig)
    return save_path


# ---------------------------------------------------------------------------
# eval entry point body
# ---------------------------------------------------------------------------

def save_results_json(results: Dict[str, Any], output_path: str | Path) -> None:
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(results, indent=2))
    print(f"Results saved to: {output_path}")


def dataset_kwargs(config) -> dict:
    """``create_datasets`` arguments from the ``dataset:`` config block."""
    ds = config.dataset
    kwargs = dict(
        dataset_name=str(ds.name),
        data_dir=str(ds.data_dir),
        modalities=list(ds.modalities),
        chunk_size=ds.get("chunk_size"),
        chunk_cache_dir=ds.get("chunk_cache_dir"),
        normalize=ds.get("normalize", False),
        window_stride=ds.get("window_stride"),
    )
    if str(ds.name) == "synthetic":
        kwargs.update(
            num_samples=int(ds.get("num_samples", 10000)),
            num_classes=int(ds.get("num_classes", 5)),
            sequence_length=int(ds.get("sequence_length", 100)),
            modality_dim=int(ds.get("modality_dim", 32)),
            seed=int(config.get("seed", 42)),
        )
    return kwargs


def evaluate_checkpoint(
    checkpoint: str,
    config_path: str = "config/base.yaml",
    output_dir: str = "experiments",
    analysis_dir: str = "analysis",
    missing_modality_test: bool = False,
    device=None,
    plots: bool = False,
) -> Dict[str, Any]:
    """Full evaluation of a checkpoint directory, writing the reference's
    JSON artifacts; on ``device`` (default ``cuda``). With ``plots`` it also
    draws the reliability diagram and the attention heatmap and records
    their paths (``run_evaluation``); without, nothing imports matplotlib."""
    from .train.checkpoint import load_checkpoint
    from .utils.config import load_config

    device = resolve_device(device)
    print(f"Loading model from: {checkpoint}")
    weights, config, _meta = load_checkpoint(checkpoint)
    if config is None:
        config = load_config(config_path)
    model = MultimodalFusionModel.from_config(config, device=device)
    model.load_state_dict(weights)

    print("Creating dataloaders...")
    kwargs = dataset_kwargs(config)
    # overlap factor of the calibration split (chunk/stride): overlapping
    # windows are near-duplicates, so calibrate_guarded counts effective
    # (non-overlapping-equivalent) windows toward its thresholds
    val_overlap = 1
    if bool((config.get("uncertainty", {}) or {}).get("temperature_scaling", False)):
        # temperature scaling fits on the val split, whose disjoint windowing
        # yields too few windows for the ECE guard to engage; pool it with
        # stride chunk//4. Val feeds only the calibration fit here.
        chunk = kwargs.get("chunk_size")
        if kwargs.get("dataset_name") != "synthetic" and chunk:
            stride = max(1, int(chunk) // 4)
            kwargs["val_window_stride"] = stride
            val_overlap = max(1, int(chunk) // stride)
    _train_w, val_w, test_w = create_datasets(**kwargs)
    test_data = DeviceSplit.from_windows(test_w, device=device)
    batch_size = int(config.dataset.get("batch_size", 32))

    print("\n" + "=" * 80)
    print("Standard Evaluation")
    print("=" * 80)
    metrics, (preds, labels, confidences, logits) = evaluate_model(
        model, test_data, batch_size, return_predictions=True, include_logits=True,
    )
    print(f"\nTest Accuracy: {metrics['accuracy']:.4f}")
    print(f"Test F1 (macro): {metrics['f1_macro']:.4f}")
    print(f"Test Loss: {metrics['loss']:.4f}")

    print("\nComputing calibration metrics...")
    eval_cfg = config.get("evaluation", {}) or {}
    num_bins = int(eval_cfg.get("num_calibration_bins", 15))
    ece = CalibrationMetrics.expected_calibration_error(confidences, preds, labels, num_bins)
    mce = CalibrationMetrics.maximum_calibration_error(confidences, preds, labels, num_bins)
    nll = CalibrationMetrics.negative_log_likelihood(logits, labels)
    print(f"ECE: {ece:.4f}\nMCE: {mce:.4f}\nNLL: {nll:.4f}")

    fusion_type = str(config.model.fusion_type)
    calibration_plot = attention_plot = None
    if plots:
        analysis_root = Path(analysis_dir) / fusion_type
        analysis_root.mkdir(parents=True, exist_ok=True)
        calibration_plot = analysis_root / "calibration.png"
        CalibrationMetrics.reliability_diagram(
            confidences, preds, labels, num_bins=num_bins, save_path=calibration_plot
        )
        if fusion_type == "hybrid":
            attention_plot = generate_attention_visualization(
                model, test_data, list(config.dataset.modalities),
                analysis_root / "attention_viz.png", batch_size,
            )
            if attention_plot is not None:
                print(f"Attention visualization saved to: {attention_plot}")

    print("\nMeasuring inference latency...")
    latency_mean_ms, latency_std_ms = measure_inference_latency(model, test_data, batch_size)
    amortized_ms = measure_amortized_latency(model, test_data, batch_size)
    print(f"Per-sample inference time: {latency_mean_ms:.3f} ± {latency_std_ms:.3f} ms")
    print(f"Amortized (pipelined) per-sample time: {amortized_ms:.3f} ms")

    per_class = {}
    for cls in np.unique(labels):
        cls_mask = labels == cls
        per_class[int(cls)] = float((preds[cls_mask] == cls).mean())

    standard_results: Dict[str, Any] = {
        "dataset": str(config.dataset.name),
        "fusion_type": fusion_type,
        "test_accuracy": metrics["accuracy"],
        "test_f1_macro": metrics["f1_macro"],
        "test_loss": metrics["loss"],
        "ece": ece,
        "mce": mce,
        "nll": nll,
        "inference_ms_mean": latency_mean_ms,
        "inference_ms_std": latency_std_ms,
        # the per-batch numbers above wait for the device after every batch;
        # this one enqueues the whole split and waits once
        "inference_ms_amortized": amortized_ms,
        "per_class_accuracy": per_class,
        "num_test_windows": int(labels.shape[0]),
    }
    if attention_plot is not None:
        standard_results["attention_plot"] = str(attention_plot)

    if missing_modality_test:
        print("\n" + "=" * 80)
        print("Missing Modality Robustness Test")
        print("=" * 80)
        missing_results = evaluate_missing_modalities(
            model, test_data, list(config.dataset.modalities), batch_size
        )
        print(f"\nFull modalities: {missing_results['full_modalities']['accuracy']:.4f}")
        print("\nSingle modality performance:")
        for modality, m in missing_results["single_modalities"].items():
            print(f"  {modality}: {m['accuracy']:.4f}")
        print("\nModality importance scores:")
        for modality, score in missing_results["modality_importance"].items():
            print(f"  {modality}: {score:.4f}")
        save_results_json(missing_results, Path(output_dir) / "missing_modality.json")

    save_results_json(standard_results, Path(output_dir) / "evaluation_results.json")

    uncertainty_results = {
        "dataset": str(config.dataset.name),
        "fusion_type": fusion_type,
        "ece": ece,
        "mce": mce,
        "nll": nll,
        "num_bins": num_bins,
    }
    if calibration_plot is not None:
        uncertainty_results["calibration_plot"] = str(calibration_plot)

    unc_cfg = config.get("uncertainty", {}) or {}
    if (
        bool(eval_cfg.get("uncertainty_analysis", False))
        and str(unc_cfg.get("method", "dropout")) == "dropout"
    ):
        # epistemic uncertainty via MC dropout over the full test set
        from .uncertainty import mc_dropout_over_split

        print("\nMC-dropout uncertainty analysis...")
        num_mc = int(unc_cfg.get("num_mc_samples", 10))
        _mean_logits, variance = mc_dropout_over_split(
            model, test_data, num_samples=num_mc, batch_size=batch_size,
        )
        uncertainty_results["mc_dropout"] = {
            "num_samples": num_mc,
            "mean_uncertainty": float(np.mean(variance)),
            "max_uncertainty": float(np.max(variance)),
            "num_windows": int(test_data.num_windows),
        }
        print(
            f"mean predictive variance over {test_data.num_windows} windows: "
            f"{uncertainty_results['mc_dropout']['mean_uncertainty']:.5f}"
        )

    if bool(unc_cfg.get("temperature_scaling", False)):
        # post-hoc temperature scaling: fit T on the validation split, report
        # calibrated test metrics
        from .uncertainty import TemperatureScaling

        print("\nFitting temperature scaling on the validation split...")
        val_data = DeviceSplit.from_windows(val_w, device=device)
        val_logits = forward_all(model, val_data, batch_size)
        ts = TemperatureScaling()
        ts.calibrate_guarded(
            val_logits, np.asarray(val_w.labels), num_bins,
            overlap_factor=val_overlap, shard_ids=val_w.shard_ids,
        )
        scaled = np.asarray(ts(logits))
        scaled_probs = torch.softmax(torch.from_numpy(scaled), dim=-1).numpy()
        scaled_conf = scaled_probs.max(-1)
        scaled_preds = scaled_probs.argmax(-1)
        uncertainty_results.update(
            {
                "temperature": float(ts.temperature),
                "ece_after_temperature_scaling": CalibrationMetrics.expected_calibration_error(
                    scaled_conf, scaled_preds, labels, num_bins
                ),
                "nll_after_temperature_scaling": CalibrationMetrics.negative_log_likelihood(
                    scaled, labels
                ),
            }
        )
        print(
            f"T={uncertainty_results['temperature']:.3f}  "
            f"ECE {ece:.4f} -> {uncertainty_results['ece_after_temperature_scaling']:.4f}"
        )
    save_results_json(uncertainty_results, Path(output_dir) / "uncertainty.json")
    print("\nEvaluation complete!")
    return standard_results


def run_evaluation(
    checkpoint: str,
    config_path: str = "config/base.yaml",
    output_dir: str = "experiments",
    analysis_dir: str = "analysis",
    missing_modality_test: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Full evaluation pipeline with the two plots (needs matplotlib)."""
    return evaluate_checkpoint(
        checkpoint, config_path, output_dir, analysis_dir, missing_modality_test,
        device=device, plots=True,
    )
