"""Entry points of the port (train / eval), with the reference's command
surface:

    python -m multimodal_sensor_fusion_with_attention_rajeevatla_torch train \
        [--config-name base] [--config-path config] [--device cuda] model.dropout=0.1 ...
    python -m multimodal_sensor_fusion_with_attention_rajeevatla_torch eval \
        --checkpoint runs/<exp>/checkpoints/<name> [--missing_modality_test] [--device cuda]

``train`` takes Hydra-style dotted overrides; ``eval`` the reference's
argparse flags. Both run on the card unless ``--device cpu`` is given. The
analysis and preprocess entry points are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .utils.config import ConfigNode, load_config

_REPO_ROOT = Path(__file__).resolve().parent.parent


def _apply_runtime_config(config: ConfigNode) -> None:
    """Seed numpy, and keep float32 products in full float32 (no TF32): the
    port is held to the reference in f32."""
    np.random.seed(int(config.get("seed", 42)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {"train": train_main, "eval": eval_main}
    if not argv or argv[0] not in commands:
        print(f"usage: python -m {__package__} {{train|eval}} [arguments]", file=sys.stderr)
        return 2
    commands[argv[0]](argv[1:])
    return 0
