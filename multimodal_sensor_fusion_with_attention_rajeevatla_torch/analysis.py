"""Analysis plot suite over the ``experiments/*.json`` artifacts (copy of
the JAX package's ``analysis.py``).

Capability parity with the reference's plot generator (``src/analysis.py``):
fusion-strategy comparison (accuracy / F1 / ECE with the 0.1 target line /
latency), missing-modality degradation + single-modality bars, annotated
M x M attention heatmap, and the calibration reliability + confidence
histogram panel. Consumes the same JSON schemas with the same metric-key
aliasing (``accuracy|test_accuracy``, ``inference_ms|inference_ms_mean|
latency_ms``, reference ``src/analysis.py:25-58``). numpy and matplotlib
only, no device code; matplotlib is imported when a plot is drawn, so a
machine without it (the card's) imports this module and reads
``_get_metric`` all the same.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, with the reference's style
    (seaborn's palette where seaborn is installed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:  # seaborn is cosmetic; degrade gracefully without it
        import seaborn as sns

        sns.set_palette("husl")
    except ImportError:
        pass
    try:
        plt.style.use("seaborn-v0_8-darkgrid")
    except OSError:
        pass
    return plt


_BAR_COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd"]


def _get_metric(
    metrics: Mapping[str, Any], keys: Sequence[str], default: float = 0.0
) -> float:
    for key in keys:
        if key in metrics:
            return float(metrics[key])
    return default


def plot_fusion_comparison(
    results: Mapping[str, Any],
    save_path: Path | str = Path("analysis/fusion_comparison.png"),
) -> None:
    """4-panel comparison across fusion strategies."""
    plt = _pyplot()
    strategies = list(results["results"].keys())
    get = lambda s, keys: _get_metric(results["results"][s], keys)  # noqa: E731
    accuracies = [get(s, ["accuracy", "test_accuracy"]) for s in strategies]
    f1_scores = [get(s, ["f1_macro", "test_f1_macro"]) for s in strategies]
    eces = [get(s, ["ece"]) for s in strategies]
    latencies = [
        get(s, ["inference_ms", "inference_ms_mean", "latency_ms"]) for s in strategies
    ]

    colors = _BAR_COLORS[: max(1, len(strategies))]
    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    fig.suptitle("Fusion Strategy Comparison", fontsize=16, fontweight="bold")

    panels = [
        (axes[0, 0], accuracies, "Accuracy", "Test Accuracy", (0, 1.0), 0.02, "{:.3f}"),
        (axes[0, 1], f1_scores, "F1 Score (macro)", "F1 Score", (0, 1.0), 0.02, "{:.3f}"),
        (axes[1, 0], eces, "ECE", "Expected Calibration Error", None, 0.005, "{:.3f}"),
        (axes[1, 1], latencies, "Inference Time (ms)", "Inference Speed", None, 0.5, "{:.1f}"),
    ]
    for ax, values, ylabel, title, ylim, pad, fmt in panels:
        ax.bar(strategies, values, color=colors)
        ax.set_ylabel(ylabel, fontsize=12)
        ax.set_title(title, fontsize=12)
        if ylim:
            ax.set_ylim(list(ylim))
        for i, v in enumerate(values):
            ax.text(i, v + pad, fmt.format(v), ha="center", fontsize=10)
    axes[1, 0].axhline(y=0.1, color="r", linestyle="--", label="Target (0.1)")
    axes[1, 0].legend()

    plt.tight_layout()
    output = Path(save_path)
    output.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(output, dpi=300, bbox_inches="tight")
    print(f"Fusion comparison plot saved to: {output}")
    plt.close()


def plot_missing_modality_robustness(
    results: Mapping[str, Any],
    save_path: Path | str = Path("analysis/missing_modality.png"),
) -> None:
    """Degradation curve over #modalities + single-modality bars."""
    plt = _pyplot()
    combos = results.get("all_combinations", {})
    singles = results.get("single_modalities", {})

    by_count: dict[int, list[float]] = {}
    for name, metrics in combos.items():
        count = len(name.split("+"))
        by_count.setdefault(count, []).append(
            _get_metric(metrics, ["accuracy", "test_accuracy"])
        )
    counts = sorted(by_count)
    means = [float(np.mean(by_count[c])) for c in counts]
    stds = [float(np.std(by_count[c])) for c in counts]

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 5))
    fig.suptitle("Missing Modality Robustness", fontsize=15, fontweight="bold")

    ax1.errorbar(counts, means, yerr=stds, marker="o", capsize=4, linewidth=2)
    ax1.set_xlabel("Number of Available Modalities")
    ax1.set_ylabel("Accuracy")
    ax1.set_title("Performance vs Modality Count")
    ax1.set_xticks(counts)
    ax1.grid(True, alpha=0.4)

    if singles:
        names = list(singles.keys())
        accs = [
            _get_metric(singles[n], ["accuracy", "test_accuracy"]) for n in names
        ]
        ax2.bar(names, accs, color=_BAR_COLORS[: max(1, len(names))])
        ax2.set_ylabel("Accuracy")
        ax2.set_title("Single-Modality Performance")
        ax2.tick_params(axis="x", rotation=30)
        for i, v in enumerate(accs):
            ax2.text(i, v + 0.01, f"{v:.3f}", ha="center", fontsize=9)

    plt.tight_layout()
    output = Path(save_path)
    output.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(output, dpi=300, bbox_inches="tight")
    print(f"Missing modality plot saved to: {output}")
    plt.close()


def plot_attention_weights(
    attention_matrix: np.ndarray,
    modality_names: Sequence[str],
    save_path: Path | str = Path("analysis/attention_weights.png"),
) -> None:
    """Annotated M x M attention heatmap."""
    plt = _pyplot()
    matrix = np.asarray(attention_matrix, dtype=np.float32)
    while matrix.ndim > 2:
        matrix = matrix.mean(axis=0)
    if matrix.ndim < 2:
        matrix = np.atleast_2d(matrix)

    num_q, num_k = matrix.shape
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(matrix, cmap="viridis", aspect="equal")
    ax.set_xticks(range(num_k))
    ax.set_yticks(range(num_q))
    ax.set_xticklabels(list(modality_names)[:num_k], rotation=45, ha="right")
    ax.set_yticklabels(list(modality_names)[:num_q])
    for i in range(num_q):
        for j in range(num_k):
            ax.text(
                j, i, f"{matrix[i, j]:.2f}",
                ha="center", va="center",
                color="white" if matrix[i, j] < matrix.max() * 0.6 else "black",
                fontsize=9,
            )
    ax.set_xlabel("Key Modality")
    ax.set_ylabel("Query Modality")
    ax.set_title("Cross-Modal Attention Weights")
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    plt.tight_layout()
    output = Path(save_path)
    output.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(output, dpi=300, bbox_inches="tight")
    print(f"Attention plot saved to: {output}")
    plt.close()


def plot_calibration_diagram(
    confidences: np.ndarray,
    predictions: np.ndarray,
    labels: np.ndarray,
    num_bins: int = 15,
    save_path: Path | str = Path("analysis/calibration.png"),
) -> None:
    """Reliability diagram + confidence histogram with inline ECE."""
    plt = _pyplot()
    from .ops.metrics import _bin_stats, expected_calibration_error

    confidences = np.asarray(confidences)
    predictions = np.asarray(predictions)
    labels = np.asarray(labels)

    bin_edges = np.linspace(0, 1, num_bins + 1)
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    # the SAME binning as the ECE computation (ops/metrics.py) — the plotted
    # per-bin accuracies and the printed ECE can never disagree
    _counts, _avg_conf, acc, _nz = _bin_stats(
        confidences, predictions, labels, num_bins
    )

    ece = expected_calibration_error(confidences, predictions, labels, num_bins)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    fig.suptitle("Calibration Analysis", fontsize=15, fontweight="bold")

    ax1.bar(centers, acc, width=1.0 / num_bins, alpha=0.7, edgecolor="black",
            label="Accuracy")
    ax1.plot([0, 1], [0, 1], "--", color="gray", label="Perfect Calibration")
    ax1.set_xlim(0, 1)
    ax1.set_ylim(0, 1)
    ax1.set_xlabel("Confidence")
    ax1.set_ylabel("Accuracy")
    ax1.set_title("Reliability Diagram")
    ax1.text(0.02, 0.95, f"ECE: {ece:.3f}", transform=ax1.transAxes,
             verticalalignment="top")
    ax1.legend(loc="lower right")

    ax2.hist(confidences, bins=bin_edges, alpha=0.75, edgecolor="black")
    ax2.set_xlabel("Confidence")
    ax2.set_ylabel("Count")
    ax2.set_title("Confidence Distribution")

    plt.tight_layout()
    output = Path(save_path)
    output.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(output, dpi=300, bbox_inches="tight")
    print(f"Calibration plot saved to: {output}")
    plt.close()


# ---------------------------------------------------------------------------
# directory walker (reference ``src/analysis.py:368-477``)
# ---------------------------------------------------------------------------

def _process_experiment_dir(exp_dir: Path, out_dir: Path) -> None:
    missing_file = exp_dir / "missing_modality.json"
    if missing_file.exists():
        try:
            plot_missing_modality_robustness(
                json.loads(missing_file.read_text()),
                out_dir / f"{exp_dir.name}_missing_modality.png",
            )
        except Exception as exc:  # pragma: no cover
            print(f"  Skipping missing-modality plot for {exp_dir.name}: {exc}")


def generate_all_plots(
    experiment_dir: str | Path = "experiments",
    output_dir: str | Path = "analysis",
    fusion_file: Optional[str | Path] = None,
) -> None:
    experiment_dir = Path(experiment_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    if experiment_dir.exists():
        _process_experiment_dir(experiment_dir, output_dir)
        for sub in sorted(p for p in experiment_dir.iterdir() if p.is_dir()):
            _process_experiment_dir(sub, output_dir)

    if fusion_file is not None:
        fusion_path = Path(fusion_file)
        if fusion_path.exists():
            results = json.loads(fusion_path.read_text())
            if results.get("results"):
                plot_fusion_comparison(
                    results, output_dir / "fusion_comparison.png"
                )
            else:
                print(f"No results in {fusion_path}; skipping comparison plot")
