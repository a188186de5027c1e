#!/usr/bin/env python
"""Export a checkpoint of the PyTorch port as a serving bundle (torch.export).

Usage:
    python scripts/export_serving_torch.py --checkpoint runs/<exp>/checkpoints/<name> \
        --output_dir serving_bundle [--batch_size 64] [--device cuda|cpu]

The checkpoint is one the port's ``Trainer.fit`` wrote
(``train/checkpoint.py``). The bundle (``serving.pt2`` + flat
``params.npz`` + ``bundle.json``) serves without the port's model code: see
``multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving``. Its
graph calls the hand-written kernels as ``msfa::`` custom ops, which run on
the card, or as their plain twins on the CPU, whichever device loads it.
``--device`` is the device the graph is traced on (default: the card).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import (
        export_serving_bundle,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
        load_checkpoint,
    )

    weights, config, _meta = load_checkpoint(args.checkpoint)
    if config is None:
        raise SystemExit("checkpoint has no bundled config; cannot rebuild model")
    model = MultimodalFusionModel.from_config(config, device=args.device)
    model.load_state_dict(weights)

    dataset = config.dataset
    batch = int(args.batch_size or dataset.get("batch_size", 32))
    chunk = int(dataset.get("chunk_size", 512))
    enc_cfgs = config.model.get("encoders", {}) or {}
    dims = {m: int((enc_cfgs.get(m, {}) or {}).get("input_dim", 64) or 64)
            for m in dataset.modalities}
    out = export_serving_bundle(model, args.output_dir, batch_size=batch, chunk_size=chunk,
                                feature_dims=dims, device=args.device)
    print(f"Serving bundle exported to: {out}")


if __name__ == "__main__":
    main()
