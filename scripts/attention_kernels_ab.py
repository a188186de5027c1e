#!/usr/bin/env python3
"""Time the PyTorch port's attention, residual-LN, feed-forward, head,
recurrence and mask-generator kernels in one or more checkouts, in turns, on
one CUDA card: an A/B of two trees in the same process order.

    python3 scripts/attention_kernels_ab.py                      # this checkout
    python3 scripts/attention_kernels_ab.py --tree old --tree . --tree . --tree old

Each ``--tree`` runs in its own process, which imports the port from that
checkout, builds its kernels from its ``ops/csrc`` and times, with CUDA
events, rows 1-22 of the kernel table at the shapes
``chip_smoke.py`` reports them: the packed forward (B 64, T 512, H 4, d 64)
and backward (B 32), the single-key-block forward and the fused backward at
``[B*H, T, d]`` = ``[128, 1024, 64]``, ``[512, 512, 64]`` and ``[128, 2048,
64]``, the split dk/dv and dq kernels at ``[128, 1024, 64]`` and ``[128,
2048, 64]``, the tiled
forward at ``[256, 4096, 64]``, ``[128, 1024, 64]`` and ``[128, 2048, 64]``
(every key valid), the feed-forward pair and the projection and FFW
residual-LayerNorm kernels, forward and backward, at N = 16,384 rows, d 256,
d_ff 2048, keep 0.8, the fused head at batch 64 (M 4, H 256, C 25, a
random mask), the LSTM and GRU training kernels at T 512 and 1024, G 4,
B 32, H 256 on ragged lengths like a real batch's (each backward on its
twin's residuals), and the three inference recurrences (rows 16-18) at T 512
and 1024, G 4, B 32 and 64, H 256, D 17 on a real PAMAP2 batch's lengths
(each on the body and tiling its wrapper picks), and the mask generator
(row 9) at ``[16384, 2048]`` and ``[16384, 256]`` and a layer's three masks
(one launch where the tree has ``dropout_keep_masks``, else one a mask),
keep 0.8; the eight bf16 entries (rows 1b-2b, 10b-15b) at the same shapes
on bf16 copies, with ``scaled_dot_product_attention`` in bf16 (the key mask,
every key valid) beside row 1b, rows 10b and 12b also by part (the hidden,
the hd W2 product; torch.profiler) with cuBLAS's bf16 ``addmm(b2, hd, W2)``
beside the product; inputs from a fixed seed. Then, per tree, the serve p50 of batch-64 requests and their
device time by kernel family (``chip_smoke.profile``) for the LSTM parity
model at chunk 512 and 1024 and the GRU model at 512
(``chip_smoke.rnn_overrides``, seeded weights, real windows). Launches are
timed back to back; the
head, the projection's forward and the masks are also timed each call
alone, the card kept ahead of the host, L2-warm and L2-cold (a 128 MB write
before each call).
``scaled_dot_product_attention`` (forward, or its backward) is timed beside
each attention shape. The attention backward kernels' outputs are hashed on
ragged lengths (0, 1, 37, 64, 65, T - 1, T, T / 2), the attention forwards',
the bf16 entries' and the feed-forward, residual-LN, head, recurrence and
mask kernels' outputs on their timed inputs, so
that the table also says which kernels give the same bits in every tree. Prints the card's
name and power limit, one JSON line per tree, then the table of all runs.
Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
HEADS, HEAD_DIM = 4, 64


def _time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _smoke():
    """``chip_smoke.py`` of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _warm_cold(times, name, fn, flush) -> None:
    """Each call timed alone, L2-warm and L2-cold, as ``chip_smoke.py`` times
    rows 8 and 14 (its ``device_ms``)."""
    smoke = _smoke()
    times[f"{name}_alone_warm"] = smoke.device_ms(fn)
    times[f"{name}_alone_cold"] = smoke.device_ms(fn, flush=flush)


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal digests, equal bits
    (a bf16 tensor's read as int16: numpy has no bf16)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()[:16]


def _ragged(torch, batch, seq):
    lengths = torch.full((batch,), seq, dtype=torch.int32)
    lengths[:8] = torch.tensor([0, 1, 37, 64, 65, seq - 1, seq, seq // 2], dtype=torch.int32)
    return lengths.cuda()


def _measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta

    g = torch.Generator().manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = HEAD_DIM**-0.5
    times, bits = {}, {}

    def packed(batch, seq=512):
        qkv = torch.randn(batch, seq, 3 * HEADS * HEAD_DIM, generator=g).cuda()
        lengths = torch.full((batch,), seq, dtype=torch.int32, device="cuda")
        q, k, v = (qkv.view(batch, seq, 3, HEADS, HEAD_DIM)[:, :, i].transpose(1, 2)
                   for i in range(3))
        return qkv, lengths, (q, k, v)

    qkv, lengths, qkv_views = packed(64)
    times["packed_attention_fwd"] = _time_ms(
        torch, lambda: ta.packed_attention_fwd(qkv, lengths, HEADS, scale), 20)
    bits["packed_attention_fwd"] = _digest(
        ta.packed_attention_fwd(qkv, lengths, HEADS, scale))
    times["sdpa_fwd_packed"] = _time_ms(torch, lambda: sdpa(*qkv_views), 20)
    qkv, lengths, qkv_views = packed(32)
    dout = torch.randn(32, 512, HEADS * HEAD_DIM, generator=g).cuda()
    out, lse = ta.packed_attention_fwd(qkv, lengths, HEADS, scale)
    times["packed_attention_bwd"] = _time_ms(
        torch, lambda: ta.packed_attention_bwd(qkv, lengths, out, lse, dout, HEADS, scale), 20)
    ragged = _ragged(torch, 32, 512)
    out_r, lse_r = ta.packed_attention_fwd(qkv, ragged, HEADS, scale)
    bits["packed_attention_bwd"] = _digest(
        [ta.packed_attention_bwd(qkv, ragged, out_r, lse_r, dout, HEADS, scale)])
    del out_r, lse_r
    leaves = [t.detach().requires_grad_() for t in qkv_views]
    sdpa_out = sdpa(*leaves)
    d_sdpa = dout.view(32, 512, HEADS, HEAD_DIM).transpose(1, 2)
    times["sdpa_bwd_packed"] = _time_ms(
        torch, lambda: torch.autograd.grad(sdpa_out, leaves, d_sdpa, retain_graph=True), 20)
    del qkv, dout, out, lse, leaves, sdpa_out

    for rows, seq in ((128, 1024), (512, 512), (128, 2048)):
        tag = f"{rows}x{seq}"
        q, k, v, dout = (torch.randn(rows, seq, HEAD_DIM, generator=g).cuda() for _ in range(4))
        lengths = torch.full((rows // HEADS,), seq, dtype=torch.int32, device="cuda")
        out, lse = ta.flash_fwd_single(q, k, v, lengths, HEADS, scale)
        delta = ta.flash_delta(out, dout)
        args = (q, k, v, lengths, HEADS, lse, delta, dout, scale)
        times[f"flash_fwd_single_{tag}"] = _time_ms(
            torch, lambda: ta.flash_fwd_single(q, k, v, lengths, HEADS, scale), 10)
        bits[f"flash_fwd_single_{tag}"] = _digest([out, lse])
        times[f"flash_bwd_fused_{tag}"] = _time_ms(torch, lambda: ta.flash_bwd_fused(*args), 5)
        if rows == 128:
            times[f"flash_bwd_dkv_{tag}"] = _time_ms(torch, lambda: ta.flash_bwd_dkv(*args), 5)
            times[f"flash_bwd_dq_{tag}"] = _time_ms(torch, lambda: ta.flash_bwd_dq(*args), 5)
            ragged = _ragged(torch, rows // HEADS, seq)
            out_r, lse_r = ta.flash_fwd_single(q, k, v, ragged, HEADS, scale)
            args_r = (q, k, v, ragged, HEADS, lse_r, ta.flash_delta(out_r, dout), dout, scale)
            for name, fn in (("flash_bwd_fused", ta.flash_bwd_fused),
                             ("flash_bwd_dkv", ta.flash_bwd_dkv), ("flash_bwd_dq", ta.flash_bwd_dq)):
                got = fn(*args_r)
                bits[f"{name}_{tag}"] = _digest(got if isinstance(got, tuple) else [got])
            del out_r, lse_r, args_r, got
        shape = (rows // HEADS, HEADS, seq, HEAD_DIM)
        leaves = [t.view(shape).detach().requires_grad_() for t in (q, k, v)]
        times[f"sdpa_fwd_{tag}"] = _time_ms(torch, lambda: sdpa(*leaves), 10)
        sdpa_out = sdpa(*leaves)
        times[f"sdpa_bwd_{tag}"] = _time_ms(
            torch, lambda: torch.autograd.grad(sdpa_out, leaves, dout.view(shape),
                                               retain_graph=True), 5)
        del q, k, v, dout, out, lse, delta, args, leaves, sdpa_out

    for rows, seq in ((256, 4096), (128, 1024), (128, 2048)):
        q, k, v = (torch.randn(rows, seq, HEAD_DIM, generator=g).cuda() for _ in range(3))
        lengths = torch.full((rows // HEADS,), seq, dtype=torch.int32, device="cuda")
        times[f"flash_fwd_tiled_{rows}x{seq}"] = _time_ms(
            torch, lambda: ta.flash_fwd_tiled(q, k, v, lengths, HEADS, scale), 10)
        bits[f"flash_fwd_tiled_{rows}x{seq}"] = _digest(
            ta.flash_fwd_tiled(q, k, v, lengths, HEADS, scale))
        if seq == 4096:
            leaves = [t.view(rows // HEADS, HEADS, seq, HEAD_DIM) for t in (q, k, v)]
            times[f"sdpa_fwd_{rows}x{seq}"] = _time_ms(torch, lambda: sdpa(*leaves), 10)
        del q, k, v
    flush = torch.empty(32 << 20, device="cuda")  # 128 MB: more than the 50 MB L2
    mlp_times, mlp_bits = _measure_mlp(torch, g, flush)
    times.update(mlp_times)
    bits.update(mlp_bits)
    bf16_times, bf16_bits = _measure_bf16(torch, g)
    times.update(bf16_times)
    bits.update(bf16_bits)
    head_times, head_bits = _measure_head(torch, g, flush)
    times.update(head_times)
    bits.update(head_bits)
    mask_times, mask_bits = _measure_masks(torch, flush)
    times.update(mask_times)
    bits.update(mask_bits)
    rnn_times, rnn_bits = _measure_rnn_train(torch, g)
    times.update(rnn_times)
    bits.update(rnn_bits)
    rnn_times, rnn_bits = _measure_rnn_serve(torch, g)
    times.update(rnn_times)
    bits.update(rnn_bits)
    return {"tree": str(tree), "device": torch.cuda.get_device_name(0), "ms": times,
            "bits": bits}


def _measure_mlp(torch, g, flush) -> dict:
    """Rows 10-15: the feed-forward pair and the two residual-LN pairs at the
    training shape, keep 0.8 -> (ms, output digests)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm

    n, d, f, keep = 16384, 256, 2048, 0.8

    def w(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).cuda()

    fmask, rmask = ((torch.rand(n, width, generator=g) < keep).to(torch.uint8).cuda()
                    for width in (f, d))
    inv_keep, eps = tm._inv_keep(keep), 1e-6
    x, dout, a = w(n, d), w(n, d), w(n, d)
    ffw = (x, w(d, f, s=d**-0.5), w(f, s=0.1), w(f, d, s=f**-0.5), w(d, s=0.1),
           1 + w(d, s=0.1), w(d, s=0.1), fmask, rmask)
    proj = (x, a, w(d, d, s=d**-0.5), w(d, s=0.1), 1 + w(d, s=0.1), w(d, s=0.1), rmask)
    x_, w1, b1, w2, b2 = ffw[:5]
    calls = {
        "fused_mlp_fwd": lambda: tm.fused_mlp_fwd(x_, w1, b1, w2, b2, fmask, inv_keep),
        "fused_mlp_bwd": lambda: tm.fused_mlp_bwd(x_, w1, b1, w2, fmask, dout, inv_keep),
        "ffw_ln_fwd": lambda: tm.ffw_ln_fwd(*ffw, inv_keep, eps),
        "ffw_ln_bwd": lambda: tm.ffw_ln_bwd(*ffw, dout, inv_keep, eps),
        "proj_ln_fwd": lambda: tm.proj_ln_fwd(*proj, inv_keep, eps),
        "proj_ln_bwd": lambda: tm.proj_ln_bwd(*proj, dout, inv_keep, eps),
    }
    bits = {}
    for name, call in calls.items():
        out = call()
        bits[name] = _digest(out if isinstance(out, tuple) else [out])
    times = {name: _time_ms(torch, call, 10) for name, call in calls.items()}
    _warm_cold(times, "proj_ln_fwd", calls["proj_ln_fwd"], flush)
    return times, bits


def _measure_bf16(torch, g) -> dict:
    """Rows 1b-2b and 10b-15b, the bf16 entries, at ``chip_smoke.py``'s
    shapes (the packed forward at B 64, the backward at B 32, T 512, H 4, d
    64, every key valid; the FFW and projection pairs at N = 16,384, d 256,
    d_ff 2048, keep 0.8), with SDPA in bf16 beside row 1b -> (ms, output
    digests)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm

    bf, scale = torch.bfloat16, HEAD_DIM**-0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n, d, f, keep = 16384, 256, 2048, 0.8

    def w(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).cuda()

    qkv = w(64, 512, 3 * HEADS * HEAD_DIM).to(bf)
    lengths = torch.full((64,), 512, dtype=torch.int32, device="cuda")
    view = qkv.view(64, 512, 3, HEADS, HEAD_DIM)
    q, k, v = (view[:, :, i].transpose(1, 2) for i in range(3))
    key_mask = torch.ones(64, 1, 1, 512, dtype=torch.bool, device="cuda")
    tq, tl = qkv[:32].contiguous(), lengths[:32]
    t_out, t_lse = ta.packed_attention_bf16_reference(tq, tl, HEADS, scale)
    t_dout = w(32, 512, HEADS * HEAD_DIM).to(bf).float()
    fmask, rmask = ((torch.rand(n, width, generator=g) < keep).to(torch.uint8).cuda()
                    for width in (f, d))
    inv_keep, eps = tm._inv_keep(keep), 1e-6
    x, dout, a = w(n, d).to(bf), w(n, d).to(bf), w(n, d).to(bf)
    w1, b1, w2, b2 = w(d, f, s=d**-0.5).to(bf), w(f, s=0.1), w(f, d, s=f**-0.5).to(bf), w(d, s=0.1)
    ffw = (x, w1, b1, w2, b2, 1 + w(d, s=0.1), w(d, s=0.1), fmask, rmask)
    proj = (x, a, w(d, d, s=d**-0.5).to(bf), w(d, s=0.1), 1 + w(d, s=0.1), w(d, s=0.1), rmask)
    calls = {
        "packed_attention_fwd_bf16": lambda: ta.packed_attention_fwd_bf16(qkv, lengths, HEADS,
                                                                          scale),
        "packed_attention_bwd_bf16": lambda: ta.packed_attention_bwd_bf16(
            tq, tl, t_out, t_lse, t_dout, HEADS, scale),
        "fused_mlp_fwd_bf16": lambda: tm.fused_mlp_fwd_bf16(x, w1, b1, w2, b2, fmask, inv_keep),
        "fused_mlp_bwd_bf16": lambda: tm.fused_mlp_bwd_bf16(x, w1, b1, w2, fmask, dout, inv_keep),
        "ffw_ln_fwd_bf16": lambda: tm.ffw_ln_fwd_bf16(*ffw, inv_keep, eps),
        "ffw_ln_bwd_bf16": lambda: tm.ffw_ln_bwd_bf16(*ffw, dout, inv_keep, eps),
        "proj_ln_fwd_bf16": lambda: tm.proj_ln_fwd_bf16(*proj, inv_keep, eps),
        "proj_ln_bwd_bf16": lambda: tm.proj_ln_bwd_bf16(*proj, dout, inv_keep, eps),
    }
    bits = {}
    for name, call in calls.items():
        out = call()
        bits[name] = _digest(out if isinstance(out, tuple) else [out])
    times = {name: _time_ms(torch, call, 10) for name, call in calls.items()}
    times["sdpa_fwd_bf16_packed"] = _time_ms(torch, lambda: sdpa(q, k, v, attn_mask=key_mask), 20)
    # rows 10b and 12b by part: the hidden's launch and the hd W2 product's
    # (device ms, torch.profiler); cuBLAS's bf16 addmm(b2, hd, W2), its sums
    # in f32, the product part's yardstick
    smoke = _smoke()
    for name in ("fused_mlp_fwd_bf16", "ffw_ln_fwd_bf16"):
        for kernel, ms in smoke.kernel_times(torch, calls[name], 5).items():
            times[f"{name}_{'hidden' if 'hidden' in kernel else 'product'}"] = ms
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.device import pin_float32

    pin_float32()
    hd = tm._ffw_ln_fwd_launch(*ffw, inv_keep, eps)[1]
    b2b = b2.to(bf)
    times["addmm_bf16_hd_w2"] = _time_ms(torch, lambda: torch.addmm(b2b, hd, w2), 10)
    return times, bits


def _measure_head(torch, g, flush) -> dict:
    """Row 8: the fused head at batch 64, full width -> (ms, output digest)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion as tf

    num_mod, batch, hidden, ncls = 4, 64, 256, 25
    pairs = [(q, k) for q in range(num_mod) for k in range(num_mod) if q != k]

    def w(*shape, s=0.06):
        return (torch.randn(*shape, generator=g) * s).cuda()

    projected = torch.relu(w(num_mod, batch, hidden, s=1.0))
    mask = (torch.rand(batch, num_mod, generator=g) > 0.3).float().cuda()
    p = len(pairs)
    pair_params = {"value_kernel": w(p, hidden, hidden), "value_bias": w(p, hidden),
                   "out_kernel": w(p, hidden, hidden), "out_bias": w(p, hidden)}
    rest = (w(num_mod, hidden), w(num_mod), w(hidden, hidden), w(hidden), w(hidden, ncls), w(ncls))

    def call():
        return tf.fused_hybrid_head(projected, mask, pair_params, *rest, pairs)

    times = {"fused_hybrid_head": _time_ms(torch, call, 20)}
    _warm_cold(times, "fused_hybrid_head", call, flush)
    return times, {"fused_hybrid_head": _digest([call()])}


def _measure_masks(torch, flush) -> dict:
    """Row 9: the mask generator at the training shape (N = 16,384, keep 0.8)
    -> (ms, output digests)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp as tm

    n, d, f, keep = 16384, 256, 2048, 0.8
    seed = torch.tensor([20240229, -77], dtype=torch.int32, device="cuda")
    layer = ((d, tm.RNG_P_ATT), (f, tm.RNG_P_HIDDEN), (d, tm.RNG_P_RES))

    def masks():
        if hasattr(tm, "dropout_keep_masks"):  # one launch for the layer
            return tm.dropout_keep_masks(seed, n, layer, keep)
        return [tm.dropout_keep_mask(seed, n, c, keep, p) for c, p in layer]

    calls = {"dropout_keep_mask_n2048": lambda: tm.dropout_keep_mask(seed, n, f, keep,
                                                                     tm.RNG_P_HIDDEN),
             "dropout_keep_mask_n256": lambda: tm.dropout_keep_mask(seed, n, d, keep,
                                                                    tm.RNG_P_RES),
             "dropout_layer_masks": masks}
    times = {name: _time_ms(torch, call, 20) for name, call in calls.items()}
    for name, call in calls.items():
        _warm_cold(times, name, call, flush)
    return times, {"dropout_layer_masks": _digest(masks())}


def _measure_rnn_train(torch, g) -> dict:
    """Rows 19-22: the recurrences' training kernels at the LSTM / GRU
    models' training shape (T 512 and 1024, G 4, B 32, H 256) on ragged
    lengths like a real batch's (24 rows whole, 8 between 64 and T), each
    backward on its twin's residuals -> (ms, output digests)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import rnn as tr

    groups, batch, hidden = 4, 32, 256
    scale = hidden**-0.5
    times, bits = {}, {}
    for seq in (512, 1024):
        tag = "" if seq == 512 else f"_t{seq}"
        lengths = torch.full((batch,), seq, dtype=torch.int32)
        lengths[24:] = torch.randint(64, seq, (8,), generator=g, dtype=torch.int32)
        lengths = lengths.cuda()
        for cell, gates in (("lstm", 4), ("gru", 3)):
            fwd, bwd = getattr(tr, f"{cell}_train_fwd"), getattr(tr, f"{cell}_train_bwd")
            x_proj = torch.randn(seq, groups, batch, gates * hidden, generator=g).cuda()
            w_hh = ((torch.rand(groups, hidden, gates * hidden, generator=g) * 2 - 1)
                    * scale).cuda()
            b_hh = ((torch.rand(groups, gates * hidden, generator=g) * 2 - 1) * scale).cuda()
            dh = torch.randn(groups, batch, hidden, generator=g).cuda()
            res = getattr(tr, f"{cell}_train_fwd_plain")(x_proj, w_hh, b_hh, lengths)[1:]
            bits[f"{cell}_train_fwd{tag}"] = _digest(fwd(x_proj, w_hh, b_hh, lengths))
            bits[f"{cell}_train_bwd{tag}"] = _digest([bwd(*res, w_hh, lengths, dh)])
            times[f"{cell}_train_fwd{tag}"] = _time_ms(
                torch, lambda: fwd(x_proj, w_hh, b_hh, lengths), 5)
            times[f"{cell}_train_bwd{tag}"] = _time_ms(torch, lambda: bwd(*res, w_hh, lengths, dh),
                                                       5)
            del x_proj, res
    return times, bits


def _measure_rnn_serve(torch, g) -> dict:
    """Rows 16-18 at T 512 and 1024, G 4, H 256, D 17, B 32 and 64 on a real
    batch's lengths, and the recurrent models' served requests -> (ms,
    output digests)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import rnn as tr
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    smoke = _smoke()
    cfg = load_config(REPO / "config" / "base.yaml")
    modalities, seed = list(cfg.dataset.modalities), int(cfg.seed)
    groups, hidden, feat, batch_max = 4, 256, 17, 64
    scale = hidden**-0.5

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).cuda()

    times, bits = {}, {}
    for seq in (512, 1024):
        split = smoke.load_split(torch, modalities, seq, int(cfg.dataset.window_stride))
        idx = smoke.index_batches(torch, split, batch_max, seed)
        real = split.lengths.index_select(0, idx[0].cuda())
        x = torch.randn(seq, groups, batch_max, feat, generator=g).cuda()
        w = {gates: (u(groups, feat, gates * hidden), u(groups, hidden, gates * hidden),
                     u(groups, gates * hidden), u(groups, gates * hidden)) for gates in (4, 3)}
        w_ih, w_hh, b_ih, b_hh = w[4]
        x_proj = (torch.einsum("tgbd,gdh->tgbh", x, w_ih) + b_ih[None, :, None, :]).contiguous()
        for batch in (32, batch_max):
            xb, xpb = x[:, :, :batch].contiguous(), x_proj[:, :, :batch].contiguous()
            lens = real[:batch].contiguous()
            calls = {"grouped_lstm_forward": lambda: tr.grouped_lstm_forward(xpb, w_hh, b_hh, lens),
                     "grouped_lstm_fused": lambda: tr.grouped_lstm_fused(xb, w_ih, w_hh,
                                                                         b_ih + b_hh, lens),
                     "grouped_gru_fused": lambda: tr.grouped_gru_fused(xb, *w[3], lens)}
            for name, call in calls.items():
                tag = f"{name}_t{seq}_b{batch}"
                bits[tag] = _digest([call()])
                times[tag] = _time_ms(torch, call, 5)
        del x, x_proj
        for cell in ("lstm", "gru") if seq == 512 else ("lstm",):
            label = f"serve_{cell}{seq}"
            model = MultimodalFusionModel.from_config(
                load_config(REPO / "config" / "base.yaml", smoke.rnn_overrides(modalities, cell, seq)),
                device="cuda", generator=torch.Generator().manual_seed(seed))
            serve = make_serving_fn(model, device="cuda")
            requests = [split.gather(i) for i in idx[:4]]
            lat = []
            for i in range(20):
                feats, _labels, lengths = requests[i % len(requests)]
                t = time.perf_counter()
                serve(feats, None, lengths)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
            lat = sorted(lat[4:])

            def run(n):
                for i in range(n):
                    feats, _labels, lengths = requests[i % len(requests)]
                    serve(feats, None, lengths)
                torch.cuda.synchronize()

            families = smoke.profile(torch, run, 6, "request")
            times[f"{label}_p50"] = lat[len(lat) // 2] * 1e3
            times[f"{label}_device"] = families["device"]
            times[f"{label}_recurrence"] = families.get(f"grouped_{cell}", 0.0)
            times[f"{label}_busy"] = families["busy"]
            del model, serve, requests
        del split
        torch.cuda.empty_cache()
    return times, bits


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", help="checkout to time (repeatable, in order)")
    parser.add_argument("--one", help=argparse.SUPPRESS)  # child process: time this tree
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_kernels_ab: CUDA is not available; this runs on the card only",
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
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    names = list(runs[0]["ms"])
    print(f"{'kernel (ms)':34s}" + "".join(f"{Path(r['tree']).name or '.':>14s}" for r in runs))
    for name in names:
        print(f"{name:34s}" + "".join(f"{r['ms'].get(name, float('nan')):14.4f}" for r in runs))
    print(f"{'output bits (sha256 prefix)':34s}" + "".join(f"{'':>14s}" for _ in runs))
    for name in runs[0]["bits"]:
        digests = [r["bits"].get(name, "-") for r in runs]
        same = "same in every tree" if len(set(digests)) == 1 else "differ"
        print(f"{name:34s}" + "".join(f"{d[:12]:>14s}" for d in digests) + f"  {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
