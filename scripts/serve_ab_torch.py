#!/usr/bin/env python3
"""``serving.make_serving_fn``'s latency from two checkouts of the port on one
CUDA card, in turns: to tell whether a change to the port moves the served
path.

    python3 scripts/serve_ab_torch.py --checkout A_DIR --checkout B_DIR [--rounds 1]

Each round runs A, B, B, A, each in a process of its own that imports the
port from that checkout (its kernels built into the checkout's
``build/torch_ext``); the config and the PAMAP2 windows are this repo's. Each
run serves the three models of ``chip_smoke.py``'s [bundle] phase (the
flagship at chunk 512, LSTM512, late fusion; weights from the config's seed)
batch-64 requests of real windows and reads, over 20 requests after 3 warm
ones, the p50 ms of a request fenced with ``torch.cuda.synchronize`` and the
p50 host ms until the call returns (its enqueue). Prints the card's name and
power limit, one JSON line per run, and last a JSON line of the medians by
checkout and model. Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = "multimodal_sensor_fusion_with_attention_rajeevatla_torch"
BATCH, CHUNK, WARM, TIMED = 64, 512, 3, 20


def models(modalities):
    """label -> overrides of base.yaml (``chip_smoke.py``'s [bundle] models)."""
    lstm = [f"dataset.chunk_size={CHUNK}"]
    for m in modalities:
        lstm += [f"model.encoders.{m}.encoder_type=lstm", f"model.encoders.{m}.num_layers=1"]
    return {"flagship": [], "lstm512": lstm, "late": ["model.fusion_type=late"]}


def child(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout))
    import torch

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        MultimodalDataset, apply_instance_normalization, padded_index_matrix,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    import multimodal_sensor_fusion_with_attention_rajeevatla_torch as port

    if Path(port.__file__).resolve().parent != (checkout / PKG).resolve():
        raise RuntimeError(f"imported {port.__file__}, not the port of {checkout}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    base = REPO / "config" / "base.yaml"
    cfg = load_config(base)
    modalities = list(cfg.dataset.modalities)
    windows = MultimodalDataset(REPO / "data" / "pamap2", modalities, "train", chunk_size=CHUNK,
                                window_stride=int(cfg.dataset.window_stride)).windows
    apply_instance_normalization(windows)
    split = DeviceSplit.from_windows(windows, device="cuda")
    matrix, _ = padded_index_matrix(split.num_windows, BATCH, shuffle=True, seed=int(cfg.seed))
    batches = [split.gather(torch.from_numpy(row).long()) for row in matrix[:WARM + TIMED]]
    out = {}
    for label, overrides in models(modalities).items():
        cfg = load_config(base, overrides)
        model = MultimodalFusionModel.from_config(
            cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed)))
        serve = make_serving_fn(model, device="cuda")
        wall, enqueue = [], []
        for i, (feats, _labels, lengths) in enumerate(batches):
            t = time.perf_counter()
            serve(feats, None, lengths)
            returned = time.perf_counter()
            torch.cuda.synchronize()
            if i >= WARM:
                wall.append(time.perf_counter() - t)
                enqueue.append(returned - t)
        out[label] = {"p50_ms": sorted(wall)[TIMED // 2] * 1e3,
                      "enqueue_p50_ms": sorted(enqueue)[TIMED // 2] * 1e3}
        del model, serve
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkout", action="append", type=Path, default=[])
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    if len(args.checkout) != 2:
        parser.error("give two --checkout directories")

    import torch

    if not torch.cuda.is_available():
        print("serve_ab_torch: CUDA is not available; this runs on the card only", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    a, b = args.checkout
    runs = {str(a): [], str(b): []}
    for _ in range(args.rounds):
        for checkout in (a, b, b, a):
            done = subprocess.run([sys.executable, __file__, "--child", str(checkout)],
                                  capture_output=True, text=True, check=True, timeout=900)
            result = json.loads(done.stdout.strip().splitlines()[-1])
            runs[str(checkout)].append(result)
            print(json.dumps({"checkout": str(checkout), **result}), flush=True)
    medians = {c: {label: {k: statistics.median(r[label][k] for r in rs)
                           for k in ("p50_ms", "enqueue_p50_ms")}
                   for label in rs[0]}
               for c, rs in runs.items()}
    print(json.dumps({"card": smi, "medians": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
