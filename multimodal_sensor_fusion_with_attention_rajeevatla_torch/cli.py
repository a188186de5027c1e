"""Entry points of the port (train / eval / analysis / preprocess), with the
reference's command surface:

    python -m multimodal_sensor_fusion_with_attention_rajeevatla_torch train \
        [--config-name base] [--config-path config] [--device cuda] model.dropout=0.1 ...
    python -m multimodal_sensor_fusion_with_attention_rajeevatla_torch eval \
        --checkpoint runs/<exp>/checkpoints/<name> [--missing_modality_test] [--device cuda]
    python -m multimodal_sensor_fusion_with_attention_rajeevatla_torch analysis \
        [--experiment_dir experiments] [--output_dir analysis] [--fusion_file F]
    python -m multimodal_sensor_fusion_with_attention_rajeevatla_torch preprocess \
        [--raw-dir data/raw] [--output data] [--import-reference DIR] [--no-csv]

``train`` takes Hydra-style dotted overrides; ``eval`` the reference's
argparse flags. Both run on the card unless ``--device cpu`` is given.
``analysis`` draws the plots of ``analysis.py`` (needs matplotlib) and
``preprocess`` runs the raw PAMAP2 ETL of ``data/preprocess.py``; neither
touches a device. ``aggregate_fusion_comparison`` rebuilds
``fusion_comparison.json`` from the per-strategy evaluation files.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from .utils.config import ConfigNode, load_config

_REPO_ROOT = Path(__file__).resolve().parent.parent


def _apply_runtime_config(config: ConfigNode) -> None:
    """Seed numpy. The card's float32 pins (no TF32, deterministic cuDNN) are
    set where every entry point resolves its device
    (``utils.device.pin_float32``)."""
    np.random.seed(int(config.get("seed", 42)))


def _resolve_config_arg(argv: List[str]):
    """Split hydra-ish args: ``--config-name X`` / ``--config-path P`` /
    ``--device D`` + dotted overrides -> ``(config file, overrides, device)``."""
    config_name = "base"
    config_path = _REPO_ROOT / "config"
    device = None
    overrides: List[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--config-name", "-cn"):
            config_name = argv[i + 1]
            i += 2
        elif arg.startswith("--config-name="):
            config_name = arg.split("=", 1)[1]
            i += 1
        elif arg in ("--config-path", "-cp"):
            config_path = Path(argv[i + 1])
            i += 2
        elif arg.startswith("--config-path="):
            config_path = Path(arg.split("=", 1)[1])
            i += 1
        elif arg == "--device":
            device = argv[i + 1]
            i += 2
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
            i += 1
        elif "=" in arg and not arg.startswith("-"):
            overrides.append(arg)
            i += 1
        else:
            i += 1
    if not str(config_name).endswith(".yaml"):
        config_name = f"{config_name}.yaml"
    return Path(config_path) / config_name, overrides, device


def train_main(argv: Optional[List[str]] = None) -> dict:
    """Training entry point: datasets from the config, ``Trainer.fit``."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    config_file, overrides, device = _resolve_config_arg(argv)
    config = load_config(config_file, overrides)

    print("=" * 80)
    print("Configuration:")
    print(config.to_yaml())
    print("=" * 80)

    _apply_runtime_config(config)

    from .data.dataset import create_datasets
    from .evaluate import dataset_kwargs
    from .train.trainer import Trainer

    print("\nCreating datasets...")
    train_w, val_w, test_w = create_datasets(**dataset_kwargs(config))
    print(f"Train windows: {train_w.num_windows}")
    print(f"Val windows: {val_w.num_windows}")
    print(f"Test windows: {test_w.num_windows}")

    print("\nCreating model...")
    trainer = Trainer(config, device=device)

    results = trainer.fit(train_w, val_w, test_w)
    total_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"Total parameters: {total_params:,}")
    print(f"\nTraining complete! Best model: {results['best_model_path']}")
    print(f"Best validation loss: {results['best_val_loss']:.4f}")
    return results


def eval_main(argv: Optional[List[str]] = None) -> dict:
    """Evaluation entry point: ``evaluate.run_evaluation`` on a checkpoint."""
    parser = argparse.ArgumentParser(description="Evaluate multimodal fusion model")
    parser.add_argument("--checkpoint", type=str, required=True, help="Path to model checkpoint")
    parser.add_argument("--config", type=str, default="config/base.yaml", help="Path to config file")
    parser.add_argument("--output_dir", type=str, default="experiments", help="Directory to save results")
    parser.add_argument("--analysis_dir", type=str, default="analysis", help="Directory to save calibration plots")
    parser.add_argument("--missing_modality_test", action="store_true", help="Run missing modality robustness test")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .evaluate import run_evaluation

    return run_evaluation(
        checkpoint=args.checkpoint,
        config_path=args.config,
        output_dir=args.output_dir,
        analysis_dir=args.analysis_dir,
        missing_modality_test=args.missing_modality_test,
        device=args.device,
    )


def analysis_main(argv: Optional[List[str]] = None) -> None:
    """Analysis/plots entry point (reference ``src/analysis.py:452-477``)."""
    parser = argparse.ArgumentParser(description="Generate analysis plots")
    parser.add_argument("--experiment_dir", type=str, default="experiments")
    parser.add_argument("--output_dir", type=str, default="analysis")
    parser.add_argument("--fusion_file", type=str, default=None)
    args = parser.parse_args(argv)

    from .analysis import generate_all_plots

    generate_all_plots(
        experiment_dir=args.experiment_dir,
        output_dir=args.output_dir,
        fusion_file=args.fusion_file,
    )


def preprocess_main(argv: Optional[List[str]] = None) -> None:
    """Raw-data ETL entry point (reference ``data/preprocess.py``)."""
    from .data.preprocess import main as preprocess

    preprocess(argv)


def aggregate_fusion_comparison(
    experiments_dir: str | Path = "experiments",
    output_path: Optional[str | Path] = None,
) -> dict:
    """Rebuild ``fusion_comparison.json`` from the ``evaluation_results.json``
    of each experiment directory under ``experiments_dir`` (keyed by the
    directory's name, in sorted order), as the reference CI's merge job does;
    written to ``output_path`` (default ``<experiments_dir>/fusion_comparison.json``)."""
    base = Path(experiments_dir)
    results = {"results": {}}
    if base.exists():
        for fusion_dir in sorted(p for p in base.iterdir() if p.is_dir()):
            eval_file = fusion_dir / "evaluation_results.json"
            if eval_file.exists():
                results["results"][fusion_dir.name] = json.loads(eval_file.read_text())
    output_path = Path(output_path or base / "fusion_comparison.json")
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(results, indent=2))
    return results


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"train": train_main, "eval": eval_main, "analysis": analysis_main,
                "preprocess": preprocess_main}
    if not argv or argv[0] not in commands:
        print(f"usage: python -m {__package__} {{{'|'.join(commands)}}} [arguments]",
              file=sys.stderr)
        return 2
    commands[argv[0]](argv[1:])
    return 0
