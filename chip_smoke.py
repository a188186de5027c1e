#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Setup: print the card's name and power limit, build the port's CUDA
   kernels from ``ops/csrc``, load the PAMAP2 train split (chunk 512,
   stride 128, instance normalisation) from ``data/pamap2`` onto the card.
2. Kernels: each kernel against its plain PyTorch twin on the card, at the
   serving shapes (packed attention: B=64, T=512, H=4, d=64; fused head:
   M=4, P=12, H=256, C=25, B=64), including the edge cases (length 0, lengths
   that are not multiples of 8 or of the 64-key tile, padded T, all-masked
   and single-modality rows). Times with CUDA events: kernel, plain twin and,
   where one PyTorch call computes the same function, that call.
3. Serve: ``MultimodalFusionModel.from_config(config/base.yaml)`` with seeded
   random weights at full width, ``serving.make_serving_fn`` on batch-64
   requests of real windows (all modalities; one modality missing; short
   lengths). The launch counters must show every encoder's attention and the
   head going through the kernels; the logits must be finite and agree with
   the same weights on the plain path (kernels off). Then p50 latency and
   windows/s over repeated requests, and device time by kernel family
   (torch.profiler) with the device's busy share.
4. Print the kernel table as one JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

The script imports torch and the port only; it needs no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "multimodal_sensor_fusion_with_attention_rajeevatla_torch"
TPU_PKG = "multimodal_sensor_fusion_with_attention_rajeevatla_tpu"
BATCH = 64
# f32 peaks of one H100 SXM (NVIDIA data sheet): CUDA-core FP32 and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# stated tolerances: f32 on both sides; the kernels sum in another order
# (online softmax across 64-key tiles, per-thread dot products)
ATTN_TOL = 1e-4
HEAD_TOL = 1e-4
LOGIT_TOL = 1e-3  # four encoders and the head stacked: errors add up


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_attention(torch, attn, real_lengths):
    """Kernel vs plain twin at the serving shape; returns the table row."""
    g = torch.Generator().manual_seed(1)
    batch, seq, heads, hd = BATCH, 512, 4, 64
    scale = hd**-0.5
    qkv = torch.randn(batch, seq, 3 * heads * hd, generator=g).cuda()
    edge = torch.randint(1, seq + 1, (batch,), generator=g, dtype=torch.int32)
    edge[:8] = torch.tensor([0, seq, 37, 1, 64, 65, 511, 8], dtype=torch.int32)
    err = 0.0
    cases = [(qkv, edge.cuda()), (qkv, real_lengths)]
    # padded T (not a multiple of the 64-row tile) with a length past the valid keys
    qkv72 = torch.randn(3, 72, 3 * heads * hd, generator=g).cuda()
    cases.append((qkv72, torch.tensor([0, 70, 72], dtype=torch.int32).cuda()))
    for x, lens in cases:
        out, lse = attn.packed_attention_fwd(x, lens, heads, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = attn.packed_attention_reference(x, lens, heads, scale)
        e_out = (out - ref_out).abs().max().item()
        valid = ref_lse > attn.NEG_INF / 2
        if not torch.equal(valid, lse > attn.NEG_INF / 2):
            raise AssertionError("packed attention: rows without keys differ from the twin")
        e_lse = (lse[valid] - ref_lse[valid]).abs().max().item()
        zero_rows = (lens == 0).nonzero().flatten().tolist()
        if any(out[b].abs().max().item() != 0.0 for b in zero_rows):
            raise AssertionError("packed attention: a length-0 row is not exactly zero")
        print(f"  packed_attention T={x.shape[1]} max_abs_err out={e_out:.3e} lse={e_lse:.3e} "
              f"(tol {ATTN_TOL})", flush=True)
        err = max(err, e_out, e_lse)
    if err > ATTN_TOL:
        raise AssertionError(f"packed attention disagrees with its twin: {err} > {ATTN_TOL}")

    uniform_ms = time_ms(lambda: attn.packed_attention_fwd(qkv, cases[0][1], heads, scale))
    print(f"  packed_attention ms={uniform_ms:.4f} on the uniform random lengths above", flush=True)
    # the table's times are on the real request's lengths (what serving gives it)
    lens = real_lengths
    ms = time_ms(lambda: attn.packed_attention_fwd(qkv, lens, heads, scale))
    plain_ms = time_ms(lambda: attn.packed_attention_reference(qkv, lens, heads, scale))
    view = qkv.view(batch, seq, 3, heads, hd)
    q, k, v = (view[:, :, i].transpose(1, 2) for i in range(3))
    key_mask = (torch.arange(seq, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=key_mask))
    keys = float(lens.clamp(0, seq).sum().item())
    flops = 4.0 * heads * hd * seq * keys  # QK^T and PV over the valid keys
    nbytes = 4.0 * (qkv.numel() + batch + batch * seq * heads * hd + batch * seq * heads)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"  packed_attention ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}; {keys:.0f} valid keys, {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return {
        "name": "packed_attention_fwd", "route": "cuda",
        "source": f"{PKG}/ops/csrc/packed_attention.cu",
        "replaces": f"{TPU_PKG}/ops/pallas_attention.py:793",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def check_head(torch, fusion, ordered_pairs, head_inputs):
    """Kernel vs plain twin on the serving head's own inputs plus edge masks."""
    projected, mask, params = head_inputs
    num_mod, batch, hidden = projected.shape
    pairs = ordered_pairs(range(num_mod))
    args = (params.pair_params, params.gate_kernels, params.gate_biases,
            params.w1, params.b1, params.w2, params.b2, pairs)
    edge = mask.clone()
    edge[0] = 0.0  # uniform fallback
    edge[1] = torch.tensor([0.0, 0.0, 0.0, 1.0])  # one modality
    edge[2] = torch.tensor([1.0, 0.0, 1.0, 0.0])
    err = 0.0
    for m in (mask, edge):
        out = fusion.fused_hybrid_head(projected, m, *args)
        torch.cuda.synchronize()
        ref = fusion.fused_hybrid_head_reference(projected, m, *args)
        e = (out - ref).abs().max().item()
        print(f"  fused_hybrid_head max_abs_err={e:.3e} (tol {HEAD_TOL})", flush=True)
        err = max(err, e)
    # a batch that is not a multiple of the kernel's 4-row tile
    out = fusion.fused_hybrid_head(projected[:, :5].contiguous(), edge[:5].contiguous(), *args)
    ref = fusion.fused_hybrid_head_reference(projected[:, :5], edge[:5], *args)
    err = max(err, (out - ref).abs().max().item())
    if err > HEAD_TOL:
        raise AssertionError(f"fused head disagrees with its twin: {err} > {HEAD_TOL}")
    ms = time_ms(lambda: fusion.fused_hybrid_head(projected, mask, *args))
    plain_ms = time_ms(lambda: fusion.fused_hybrid_head_reference(projected, mask, *args))
    num_pairs, num_classes = len(pairs), params.w2.shape[1]
    flops = 2.0 * batch * (2 * num_pairs * hidden * hidden + num_mod * hidden
                           + hidden * hidden + hidden * num_classes)
    weights = (2 * num_pairs * hidden * (hidden + 1) + num_mod * (hidden + 1)
               + hidden * (hidden + 1) + (hidden + 1) * num_classes)
    nbytes = 4.0 * (projected.numel() + mask.numel() + weights + batch * num_classes)
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"  fused_hybrid_head ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)",
          flush=True)
    return {
        "name": "fused_hybrid_head", "route": "cuda",
        "source": f"{PKG}/ops/csrc/fusion_head.cu",
        "replaces": f"{TPU_PKG}/ops/pallas_fusion.py:37",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def profile_requests(torch, serve, batches, iters: int = 10) -> None:
    """Device time by kernel family over ``iters`` requests (torch.profiler's
    CUDA activity), and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        for i in range(n):
            feats, _, lengths = batches[i % len(batches)]
            serve(feats, None, lengths)
        torch.cuda.synchronize()

    run(3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(iters)
        wall_us = (time.perf_counter() - t) * 1e6
    families = {"packed_attention": 0.0, "fusion_head": 0.0, "gemm": 0.0, "other": 0.0}
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        key = next((k for k in ("packed_attention", "fusion_head") if k in low), None)
        if key is None:
            key = "gemm" if any(w in low for w in ("gemm", "cutlass", "sm90_xmma", "nvjet")) else "other"
        families[key] += us
    busy = sum(families.values())
    print(f"  profile over {iters} requests: device busy {busy / wall_us:.3f} of wall "
          f"({busy / iters / 1e3:.3f} ms device time per request)", flush=True)
    for key, us in families.items():
        print(f"    {key:17s} {us / iters / 1e3:8.4f} ms/request  {us / busy:.3f} of device time",
              flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    top kernel {us / iters / 1e3:8.4f} ms/request  {name[:110]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card only",
              file=sys.stderr)
        return 2
    if not (REPO / PKG / "serving.py").is_file():
        print(f"chip_smoke: {PKG} not found beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain twins
    torch.backends.cudnn.allow_tf32 = False

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        MultimodalDataset, apply_instance_normalization, padded_index_matrix,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.attention import (
        ordered_pairs,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as attn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # ---- 1. setup: kernels and data --------------------------------------
    t = time.perf_counter()
    _build.build_all()
    print(f"[setup] kernels built in {time.perf_counter() - t:.1f} s", flush=True)
    cfg = load_config(REPO / "config" / "base.yaml")
    modalities = list(cfg.dataset.modalities)
    t = time.perf_counter()
    windows = MultimodalDataset(
        REPO / "data" / "pamap2", modalities, "train",
        chunk_size=int(cfg.dataset.chunk_size),
        window_stride=int(cfg.dataset.window_stride),
    ).windows
    apply_instance_normalization(windows)
    split = DeviceSplit.from_windows(windows, device="cuda")
    print(f"[setup] {split.num_windows} train windows on the card in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    idx_matrix, _ = padded_index_matrix(split.num_windows, BATCH, shuffle=True, seed=int(cfg.seed))
    batches = [split.gather(torch.from_numpy(row)) for row in idx_matrix]
    # the first request also carries the split's short windows
    short = torch.from_numpy((windows.lengths < int(cfg.dataset.chunk_size)).nonzero()[0][:8])
    first_idx = torch.cat([short, torch.from_numpy(idx_matrix[0][: BATCH - len(short)])])
    batches[0] = split.gather(first_idx)

    # ---- model --------------------------------------------------------------
    model = MultimodalFusionModel.from_config(
        cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed))
    )
    plain_cfg = load_config(REPO / "config" / "base.yaml", ["model.flash_attention=false"])
    plain_model = MultimodalFusionModel.from_config(plain_cfg, device="cuda")
    plain_model.load_state_dict(model.state_dict())
    serve = make_serving_fn(model, device="cuda")

    @torch.inference_mode()
    def serve_plain(feats, mask, lengths):
        """The serving contract on the plain path: a missing modality is a
        zero embedding, the head is the model's own (kernels off)."""
        encoded = plain_model.encode(feats, lengths)
        for m in modalities:
            encoded.setdefault(m, torch.zeros((BATCH, plain_model.output_dim), device="cuda"))
        return plain_model.fuse(encoded, mask)

    # ---- 2. kernels vs their plain twins ------------------------------------
    print("[kernels]", flush=True)
    feats0, _labels0, lengths0 = batches[0]
    rows = [check_attention(torch, attn, lengths0)]
    with torch.inference_mode():
        params = fusion.hybrid_head_params(model.fusion_model)
        encoded = model.encode(feats0, lengths0)
        mask0 = torch.ones((BATCH, len(modalities)), device="cuda")
        projected = torch.stack([
            torch.relu(torch.nn.functional.linear(encoded[m], *params.proj[m])) for m in modalities
        ]).contiguous()
    rows.append(check_head(torch, fusion, ordered_pairs, (projected, mask0, params)))

    # ---- 3. serve: the main path ----------------------------------------------
    print("[serve]", flush=True)
    missing = modalities[1]
    feats1, _, lengths1 = batches[1]
    mask1 = torch.ones((BATCH, len(modalities)), device="cuda")
    mask1[:, 1] = 0.0
    feats2, _, _ = batches[2]
    g = torch.Generator().manual_seed(7)
    lengths2 = torch.randint(1, 160, (BATCH,), generator=g, dtype=torch.int32)
    lengths2[:3] = torch.tensor([0, 37, 1], dtype=torch.int32)
    requests = [
        ("all modalities", feats0, None, lengths0),
        (f"{missing} missing", {m: x for m, x in feats1.items() if m != missing}, mask1, lengths1),
        ("short lengths", feats2, None, lengths2.cuda()),
    ]
    counters = (attn.packed_attention_fwd, fusion.fused_hybrid_head)
    for fn in counters:
        fn.launches = 0
    logits = []
    for _name, feats, mask, lengths in requests:
        logits.append(serve(feats, mask, lengths))
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]
    want_attn = sum(len(feats) for _n, feats, _m, _l in requests)
    print(f"  launches: packed_attention_fwd={launches[0]} (want {want_attn}), "
          f"fused_hybrid_head={launches[1]} (want {len(requests)})", flush=True)
    if launches != [want_attn, len(requests)]:
        raise AssertionError(f"kernel launch counts {launches} != {[want_attn, len(requests)]}")
    worst = 0.0
    for (name, feats, mask, lengths), got in zip(requests, logits):
        ref = serve_plain(feats, mask, lengths)
        torch.cuda.synchronize()
        if got.shape != (BATCH, model.num_classes) or not torch.isfinite(got).all():
            raise AssertionError(f"request '{name}': bad logits {tuple(got.shape)}")
        e = (got - ref).abs().max().item()
        print(f"  request '{name}': logits {tuple(got.shape)} finite, max_abs_err vs plain "
              f"path {e:.3e} (tol {LOGIT_TOL})", flush=True)
        worst = max(worst, e)
    if worst > LOGIT_TOL:
        raise AssertionError(f"served logits disagree with the plain path: {worst} > {LOGIT_TOL}")
    if [fn.launches for fn in counters] != launches:
        raise AssertionError("the plain path launched a kernel")
    for row, n in zip(rows, launches):
        row["launches"] = n

    lat = []
    for i in range(40):
        feats, _, lengths = batches[i % len(batches)]
        t = time.perf_counter()
        serve(feats, None, lengths)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    lat = sorted(lat[5:])
    p50 = lat[len(lat) // 2]
    print(f"  serve batch {BATCH}: p50 latency {p50 * 1e3:.3f} ms, "
          f"{BATCH / p50:.1f} windows/s on {smi}", flush=True)
    profile_requests(torch, serve, batches)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
