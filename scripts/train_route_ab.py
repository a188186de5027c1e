#!/usr/bin/env python3
"""Device time of the PyTorch port's training micro-step by kernel family in
one or more checkouts, in turns, on one CUDA card: an A/B of two trees in the
same process order.

    python3 scripts/train_route_ab.py                      # this checkout
    python3 scripts/train_route_ab.py --tree old --tree . --tree . --tree old

Each ``--tree`` runs in its own process, which imports the port from that
checkout and builds its kernels from its ``ops/csrc``; the measuring code is
``chip_smoke.py``'s [train] phase of this checkout. In each process,
``config/base.yaml`` at full width and seeded weights on real PAMAP2 train
windows (batch 32, every augmentation on), for the default route and
``model.fused_mlp=true model.fused_mlp_ln=false`` at chunk 512, for the
LSTM parity model (every encoder one LSTM layer, one grouped recurrence,
``chip_smoke.rnn_overrides``) at chunk 512 and 1024, and for the GRU model at
512: 8 micro-steps (their losses kept: the table says whether they are the
same bits in every tree), then 8 under ``torch.profiler`` (device ms per micro-step by kernel family,
``chip_smoke.FAMILIES``; the device total and its busy share of the wall
time), then the p50 of 20 micro-steps on the host clock. Prints the card's
name and power limit, one JSON line per tree, then the table of all runs.
Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# route -> (overrides, chunk); a cell name: chip_smoke.rnn_overrides' parity
# model of that cell (every encoder one layer, grouped) at that chunk
ROUTES = {"default": ([], 512),
          "fused_mlp": (["model.fused_mlp=true", "model.fused_mlp_ln=false"], 512),
          "lstm512": ("lstm", 512), "lstm1024": ("lstm", 1024), "gru512": ("gru", 512)}
# the feed-forward pair's kernels before their 3xTF32 redesign (the SIMT row
# walk and its second pass), so that an older tree's step splits the same way
OLD_FAMILIES = (("fused_mlp_fwd", ("ffw_fwd_kernel",)),
                ("fused_mlp_bwd", ("ffw_bwd_kernel", "atb_partial", "reduce_splits",
                                   "colsum_partial")))


def _measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.FAMILIES = smoke.FAMILIES + OLD_FAMILIES
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs the step
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    cfg = load_config(REPO / "config" / "base.yaml")
    modalities = list(cfg.dataset.modalities)
    routes, data = {}, {}
    for label, (overrides, chunk) in ROUTES.items():
        if chunk not in data:
            split = smoke.load_split(torch, modalities, chunk, int(cfg.dataset.window_stride))
            data[chunk] = (split, smoke.index_batches(torch, split, int(cfg.dataset.batch_size),
                                                      int(cfg.seed)))
        split, idx = data[chunk]
        if isinstance(overrides, str):
            overrides = smoke.rnn_overrides(modalities, overrides, chunk)
        trainer = smoke._trainer(torch, overrides)
        step, losses, _launches = smoke.counted_steps(torch, {}, trainer, split, idx, 8)
        families = smoke.profile_micro_steps(torch, step, split, idx, 8)
        families["losses"] = losses
        lat = []
        for i in range(20):
            t = time.perf_counter()
            step(split, idx[i % len(idx)])
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
        families["p50_ms"] = sorted(lat[4:])[len(lat[4:]) // 2] * 1e3
        routes[label] = families
        del trainer, step
        torch.cuda.empty_cache()
    return {"tree": str(tree), "device": torch.cuda.get_device_name(0), "routes": routes}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", help="checkout to time (repeatable, in order)")
    parser.add_argument("--one", help=argparse.SUPPRESS)  # child process: time this tree
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_route_ab: CUDA is not available; this runs on the card only",
              file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(_measure(Path(args.one).resolve())), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for tree in args.tree or [str(REPO)]:
        proc = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True,
                              text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip(), flush=True)  # the profiles, then the JSON line
        line = proc.stdout.strip().splitlines()[-1]
        runs.append(json.loads(line))
    for label in ROUTES:
        print(f"{label} route, ms per micro-step" + "".join(
            f"{Path(r['tree']).name or '.':>14s}" for r in runs))
        names = list(dict.fromkeys(k for r in runs for k in r["routes"][label] if k != "losses"))
        for name in names:
            print(f"  {name:32s}" + "".join(
                f"{r['routes'][label].get(name, 0.0):14.4f}" for r in runs))
        losses = [r["routes"][label]["losses"] for r in runs]
        same = all(loss == losses[0] for loss in losses)
        print(f"  losses of 8 micro-steps: {'bit-identical in every tree' if same else 'differ'} "
              f"{losses[0]}" + ("" if same else f" / {losses[1:]}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
