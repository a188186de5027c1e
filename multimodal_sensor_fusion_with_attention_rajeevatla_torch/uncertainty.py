"""Uncertainty quantification: MC dropout, calibration, temperature scaling.
Port of the JAX package's ``uncertainty.py``.

- ``CalibrationMetrics``: ECE / MCE / NLL with equal-width bins whose last
  bin is right-closed, plus the reliability diagram (matplotlib is imported
  inside the plotting function only).
- ``mc_dropout`` / ``MCDropoutUncertainty`` / ``mc_dropout_over_split``:
  epistemic uncertainty from stochastic forward passes. Where the reference
  maps over dropout keys inside one compiled program, the port loops over
  samples, each with its own ``torch.Generator`` seeded ``seed + sample``,
  so sample ``s`` draws the same masks for every batch size. The passes run
  in train mode under ``torch.inference_mode``: a model with BatchNorms
  normalises by the batch's statistics and leaves its running statistics as
  they were (``models.encoders.MaskedBatchNorm``), as the reference discards
  its ``mutable=["batch_stats"]`` update.
- ``uncertainty_weighted_fusion`` / ``UncertaintyWeightedFusion``:
  inverse-uncertainty weights with the masked renormalisation and the
  uniform fallback.
- ``mc_dropout_uncertainty_fusion``: the per-modality logits of a late or
  uncertainty fusion model sampled under MC dropout, each modality weighted
  by the inverse of its predictive variance.
- ``EnsembleUncertainty``: mean and variance of the members' probabilities.
- ``TemperatureScaling``: one temperature minimising val NLL (scipy L-BFGS-B
  on ``log T`` over a torch value-and-grad), and the ECE-guarded variant.
- ``compute_calibration_metrics``: sweep helper.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.dataset import padded_index_matrix
from .ops.masked import mask_renormalize
from .ops.metrics import (
    _bin_stats,
    expected_calibration_error,
    maximum_calibration_error,
    negative_log_likelihood,
)


def _softmax_np(logits) -> np.ndarray:
    return torch.softmax(torch.as_tensor(np.asarray(logits), dtype=torch.float32), dim=-1).numpy()


class CalibrationMetrics:
    """Calibration metric suite (static methods, reference-compatible API)."""

    expected_calibration_error = staticmethod(expected_calibration_error)
    maximum_calibration_error = staticmethod(maximum_calibration_error)
    negative_log_likelihood = staticmethod(negative_log_likelihood)

    @staticmethod
    def reliability_diagram(
        confidences: np.ndarray,
        predictions: np.ndarray,
        labels: np.ndarray,
        num_bins: int = 15,
        save_path: Path | str | None = None,
    ) -> None:
        """Accuracy-vs-confidence bar diagram with inline ECE annotation."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        confidences = np.asarray(confidences)
        predictions = np.asarray(predictions)
        labels = np.asarray(labels)
        # the plotted bars and the reported ECE come from the same binning
        bin_edges = np.linspace(0.0, 1.0, num_bins + 1)
        centers = (bin_edges[:-1] + bin_edges[1:]) / 2
        _counts, _avg_conf, accuracies, _nz = _bin_stats(
            confidences, predictions, labels, num_bins
        )

        fig, ax = plt.subplots(figsize=(6, 5))
        ax.bar(centers, accuracies, width=1.0 / num_bins, alpha=0.7, edgecolor="black",
               label="Accuracy")
        ax.plot([0, 1], [0, 1], "--", color="gray", label="Perfect Calibration")
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.set_xlabel("Confidence")
        ax.set_ylabel("Accuracy")
        ax.set_title("Reliability Diagram")
        ece = expected_calibration_error(confidences, predictions, labels, num_bins)
        ax.text(0.02, 0.95, f"ECE: {ece:.3f}", transform=ax.transAxes, fontsize=10,
                verticalalignment="top")
        ax.legend(loc="lower right")
        plt.tight_layout()
        if save_path is not None:
            out = Path(save_path)
            out.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(out, dpi=300, bbox_inches="tight")
            plt.close(fig)
        else:
            plt.show()


def _mean_and_variance(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[S, B, C]`` sampled logits -> mean logits ``[B, C]`` and the mean
    class-probability variance across samples ``[B]``."""
    probs = torch.softmax(logits, dim=-1)
    return logits.mean(dim=0), probs.var(dim=0, unbiased=False).mean(dim=-1)


def mc_dropout(
    apply_fn: Callable[..., torch.Tensor],
    num_samples: int,
    seed: int,
    device="cpu",
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Wrap a dropout-bearing forward into an MC-dropout predictor.

    ``apply_fn(generator, *args) -> logits`` runs ``num_samples`` times, each
    with a generator on ``device`` seeded ``seed + sample``. Returns
    ``(mean_logits, variance)``.
    """

    @torch.inference_mode()
    def predict(*args):
        samples = []
        for sample in range(num_samples):
            generator = torch.Generator(device=device).manual_seed(seed + sample)
            samples.append(apply_fn(generator, *args))
        return _mean_and_variance(torch.stack(samples))

    return predict


class MCDropoutUncertainty:
    """Object-style wrapper mirroring the reference class."""

    def __init__(self, model, num_samples: int = 10, seed: int = 0):
        self.model = model
        self.num_samples = num_samples
        self.seed = seed

    def __call__(self, features, mask=None, lengths=None):
        device = next(iter(features.values())).device

        def apply_fn(generator, feats, msk, lens):
            return self.model(feats, msk, lens, train=True, generator=generator)

        return mc_dropout(apply_fn, self.num_samples, self.seed, device)(features, mask, lengths)


@torch.inference_mode()
def mc_dropout_over_split(
    model,
    data,
    num_samples: int = 10,
    batch_size: int = 32,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """MC-dropout over a full device-resident split: per batch,
    ``num_samples`` training-mode forwards (dropout on, no gradient). Peak
    memory is one forward; every window is covered. Returns host
    ``(mean_logits [N, C], predictive_variance [N])``."""
    n = data.num_windows
    device = data.labels.device
    idx_mat = torch.from_numpy(padded_index_matrix(n, batch_size)[0]).long().to(device)
    generators = [torch.Generator(device=device).manual_seed(seed + s) for s in range(num_samples)]
    means, variances = [], []
    for idx in idx_mat:
        features, _labels, lengths = data.gather(idx)
        mask = torch.ones((idx.shape[0], len(data.modalities)), device=device)
        logits = torch.stack([
            model(features, mask, lengths, train=True, generator=g) for g in generators
        ])
        mean, variance = _mean_and_variance(logits)
        means.append(mean)
        variances.append(variance)
    if not means:
        return np.zeros((0, model.num_classes), np.float32), np.zeros((0,), np.float32)
    return torch.cat(means).cpu().numpy()[:n], torch.cat(variances).cpu().numpy()[:n]


def uncertainty_weighted_fusion(
    modality_predictions: Mapping[str, torch.Tensor],
    modality_uncertainties: Mapping[str, torch.Tensor],
    modality_mask: torch.Tensor,
    epsilon: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-uncertainty weighted logit fusion.

    Weights ~ ``mask / (uncertainty + eps)`` renormalised per sample; rows
    with zero total weight fall back to mask-proportional weights, or uniform
    when the mask itself is all-zero.
    """
    names = list(modality_predictions.keys())
    if not names:
        raise ValueError("No modality predictions supplied for fusion.")
    mask = torch.as_tensor(modality_mask, dtype=torch.float32)
    logits_stack, weight_list = [], []
    for name in names:
        if name not in modality_uncertainties:
            raise KeyError(f"Missing uncertainty for modality '{name}'.")
        logits_stack.append(modality_predictions[name][:, None, :])
        weight_list.append(1.0 / (modality_uncertainties[name][:, None] + epsilon))
    logits_tensor = torch.cat(logits_stack, dim=1)  # (B, M, C)
    weighted = torch.cat(weight_list, dim=1) * mask  # (B, M)
    fusion_weights = mask_renormalize(weighted, mask, len(names), fallback="proportional", dim=1)
    fused_logits = (logits_tensor * fusion_weights[..., None]).sum(dim=1)
    return fused_logits, fusion_weights


class UncertaintyWeightedFusion:
    """Class-style wrapper for API parity with the reference."""

    def __init__(self, epsilon: float = 1e-6):
        self.epsilon = epsilon

    def __call__(self, modality_predictions, modality_uncertainties, modality_mask):
        return uncertainty_weighted_fusion(
            modality_predictions, modality_uncertainties, modality_mask, self.epsilon
        )


def mc_dropout_uncertainty_fusion(
    model,
    features: Mapping[str, torch.Tensor],
    modality_mask: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    num_samples: int = 10,
    seed: int = 0,
    epsilon: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uncertainty-aware fusion: ``num_samples`` MC-dropout passes of a late
    or uncertainty fusion ``model`` (encoders and head in train mode, sample
    ``s`` drawing from a generator seeded ``seed + s``), each modality's
    per-modality logits averaged over the samples and its predictive variance
    (the variance of the softmax over samples, averaged over classes) taken
    as its uncertainty, combined by :func:`uncertainty_weighted_fusion`.
    Returns ``(fused_logits, fusion_weights)``."""
    if getattr(model, "fusion_type", None) not in ("late", "uncertainty"):
        raise ValueError(
            "mc_dropout_uncertainty_fusion requires a LateFusion or "
            "UncertaintyFusion model (per-modality heads provide the "
            "per-modality predictions)."
        )
    names = list(model.modalities)
    first = next(iter(features.values()))
    device = first.device
    if modality_mask is None:
        modality_mask = torch.ones((first.shape[0], len(names)), device=device)
    samples = []
    with torch.inference_mode():
        for sample in range(num_samples):
            generator = torch.Generator(device=device).manual_seed(seed + sample)
            encoded = model.encode(features, lengths, train=True, generator=generator)
            _fused, per_modality = model.fusion_model(encoded, modality_mask, train=True,
                                                      generator=generator)
            samples.append(torch.stack([per_modality[n] for n in names]))  # [M, B, C]
        mean_logits, variance = _mean_and_variance(torch.stack(samples))  # [M, B, C], [M, B]
        return uncertainty_weighted_fusion(
            {n: mean_logits[i] for i, n in enumerate(names)},
            {n: variance[i] for i, n in enumerate(names)},
            modality_mask, epsilon,
        )


class TemperatureScaling:
    """Single-temperature post-hoc calibration (Guo et al., 2017).

    ``calibrate`` minimises validation NLL over ``T`` with L-BFGS-B (scipy
    driving a torch value-and-grad on ``log T``); ``T`` is clamped to >= 1e-3.
    """

    def __init__(self):
        self.temperature = 1.0

    def __call__(self, logits):
        if isinstance(logits, torch.Tensor):
            return logits / self.temperature
        return np.asarray(logits) / self.temperature

    forward = __call__

    def calibrate(self, logits, labels, lr: float = 0.01, max_iter: int = 50) -> float:
        from scipy.optimize import minimize

        logits_t = torch.as_tensor(np.asarray(logits), dtype=torch.float32)
        labels_t = torch.as_tensor(np.asarray(labels)).long()

        def objective(x):
            # float32 like the reference's jitted objective
            log_t = torch.tensor(float(x[0]), dtype=torch.float32, requires_grad=True)
            logp = torch.log_softmax(logits_t / torch.exp(log_t), dim=-1)
            value = -logp.gather(-1, labels_t[:, None]).mean()
            (grad,) = torch.autograd.grad(value, log_t)
            return float(value.detach()), np.array([float(grad)], dtype=np.float64)

        result = minimize(objective, x0=np.zeros(1), jac=True, method="L-BFGS-B",
                          options={"maxiter": max_iter})
        del lr  # accepted for API parity; L-BFGS needs no learning rate
        self.temperature = max(float(np.exp(result.x[0])), 1e-3)
        return self.temperature

    def calibrate_guarded(
        self,
        logits,
        labels,
        num_bins: int = 15,
        max_iter: int = 50,
        min_windows: Optional[int] = None,
        overlap_factor: int = 1,
        shard_ids=None,
    ) -> float:
        """ECE-guarded calibration: accept a temperature only when its val
        improvement is large and consistent across shards, so it transfers to
        test (the raw NLL fit over-sharpens on small validation splits).

        Shared machinery: the guard's bin count adapts to the effective split
        size (``n_eff // 10`` clipped to ``[5, num_bins]``); overlapping
        windows count as ``n // overlap_factor`` effective ones; below
        ``min_windows`` effective windows (default ``10 * bins``) T stays 1;
        candidates are a grid over ``[0.5, 2.5]`` plus the clipped NLL-fit T.

        With ``shard_ids`` naming >= 3 shards: a candidate is admissible iff
        the overall val ECE improves by >= 0.01, it improves on >= 75% of the
        shards and hurts none by more than 0.005; among those the one with
        the largest minimum per-shard improvement wins. Without shard
        provenance: a 2-fold cross-check on contiguous blocks of
        ``4 * overlap_factor`` windows assigned round-robin; a candidate must
        improve overall val ECE by 0.005 and worsen neither fold.
        """
        logits_np = np.asarray(logits, np.float32)
        labels_np = np.asarray(labels)
        n = labels_np.shape[0]
        n_eff = max(1, n // max(1, int(overlap_factor)))
        num_bins_eff = int(np.clip(n_eff // 10, 5, num_bins))
        if min_windows is None:
            min_windows = 10 * num_bins_eff
        if n_eff < min_windows:
            self.temperature = 1.0
            return self.temperature

        def ece_at(t: float, sel=slice(None)) -> float:
            probs = _softmax_np(logits_np[sel] / t)
            return expected_calibration_error(
                probs.max(-1), probs.argmax(-1), labels_np[sel], num_bins_eff
            )

        t_nll = TemperatureScaling()
        t_nll.calibrate(logits_np, labels_np, max_iter=max_iter)
        candidates = sorted(
            set(
                [float(np.clip(t_nll.temperature, 0.5, 2.5))]
                + np.exp(np.linspace(np.log(0.5), np.log(2.5), 21)).tolist()
            )
        )

        shards = None
        if shard_ids is not None:
            shard_arr = np.asarray(shard_ids)
            if shard_arr.shape[0] == n:
                uniq = np.unique(shard_arr)
                if len(uniq) >= 3:
                    shards = (shard_arr, uniq)

        if shards is not None:
            shard_arr, uniq = shards
            need = int(np.ceil(0.75 * len(uniq)))
            base_overall = ece_at(1.0)
            base_per = {s: ece_at(1.0, shard_arr == s) for s in uniq}
            best_t, best_key = 1.0, (-np.inf, -np.inf)
            for t in candidates:
                overall = base_overall - ece_at(t)
                if overall < 0.01:
                    continue
                per = np.array([base_per[s] - ece_at(t, shard_arr == s) for s in uniq])
                if (per > 0).sum() < need or per.min() < -0.005:
                    continue
                key = (float(per.min()), overall)
                if key > best_key:
                    best_t, best_key = float(t), key
            self.temperature = best_t
            return self.temperature

        # round-robin contiguous blocks: overlapping neighbours stay in the
        # same fold while both folds sample every region of the split
        block_size = 4 * max(1, int(overlap_factor))
        fold_a = (np.arange(n) // block_size) % 2 == 0
        fold_b = ~fold_a
        base = ece_at(1.0)
        base_a = ece_at(1.0, fold_a)
        base_b = ece_at(1.0, fold_b)
        best_t, best_ece = 1.0, base
        for t in candidates:
            e = ece_at(t)
            if (
                e < base - 0.005
                and e < best_ece - 1e-9
                and ece_at(t, fold_a) <= base_a + 1e-9
                and ece_at(t, fold_b) <= base_b + 1e-9
            ):
                best_t, best_ece = float(t), e
        self.temperature = best_t
        return self.temperature


class EnsembleUncertainty:
    """Uncertainty from an ensemble of models: each member called as
    ``model(*args, train=False)`` (a tuple output gives its logits)."""

    def __init__(self, models: Sequence[Callable[..., torch.Tensor]]):
        self.models = list(models)
        self.num_models = len(self.models)

    @torch.inference_mode()
    def predict_with_uncertainty(self, *args) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> ``(mean probabilities [B, C], mean class variance [B])``."""
        if self.num_models == 0:
            raise ValueError("Ensemble must contain at least one model.")
        probs = []
        for model in self.models:
            logits = model(*args, train=False)
            if isinstance(logits, tuple):
                logits = logits[0]
            probs.append(torch.softmax(logits, dim=-1))
        tensor = torch.stack(probs)  # [E, B, C]
        return tensor.mean(dim=0), tensor.var(dim=0, unbiased=False).mean(dim=-1)


def compute_calibration_metrics(
    logits: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    batches: List[Tuple[np.ndarray, np.ndarray]] | None = None,
    num_bins: int = 15,
) -> Dict[str, float]:
    """ECE/MCE/NLL/accuracy over a full logits set or an iterable of
    ``(logits, labels)`` batches."""
    if batches is not None:
        parts_logits, parts_labels = [], []
        for batch_logits, batch_labels in batches:
            parts_logits.append(np.asarray(batch_logits))
            parts_labels.append(np.asarray(batch_labels))
        if not parts_logits:
            raise ValueError("Dataloader produced no batches to evaluate.")
        logits = np.concatenate(parts_logits)
        labels = np.concatenate(parts_labels)
    if logits is None or labels is None:
        raise ValueError("Provide logits+labels or batches.")
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    probs = _softmax_np(logits)
    confidences = probs.max(axis=-1)
    predictions = probs.argmax(axis=-1)
    return {
        "ece": expected_calibration_error(confidences, predictions, labels, num_bins),
        "mce": maximum_calibration_error(confidences, predictions, labels, num_bins),
        "nll": negative_log_likelihood(logits, labels),
        "accuracy": float((predictions == labels).mean()),
    }
