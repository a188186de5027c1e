#!/usr/bin/env python3
"""Where a step of the serving recurrences' cluster body goes, on one CUDA card.

    python3 scripts/rnn_fused_variants.py

Builds variants of ``ops/csrc/rnn.cu`` from text edits of a copy of
``ops/csrc`` (under ``build/rnn_fused_variants/``, one ``nvcc`` each, all at
once): the kernels as they are; one m16 tile a warp at 32 rows a cluster
(512 threads a CTA) instead of two (256 threads, each B fragment split once
for both tiles); the x part (x_t . W_ih slice) by f32 FMAs on the CUDA
cores instead of 3xTF32; the x part on the step's chain (at the top of the
step) instead of in the cluster barrier's wait; and the step product, the
exchange through distributed shared memory or the x part compiled out, one
at a time and all three (the cell, the staging and the cluster barrier
left). Each variant's ``grouped_lstm_fused`` and ``grouped_gru_fused`` run
on the same inputs at T 512, G 4, H 256, D 17, every row whole: B 32 at 16
rows a cluster (one wave), B 64 at 32 rows (one wave) and at 16 (two waves);
prints ms, us per step and the error against the plain versions (a variant
with a part compiled out computes something else). Prints the card's name
and power limit first. Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "rnn_fused_variants"
HEADER = "rnn_cluster_fused.cuh"
T, G, H, D = 512, 4, 256, 17
CASES = ((32, 16), (64, 32), (64, 16))  # (B, rows a cluster)

X_PART_FMA = r'''
template <int WT>
__device__ __forceinline__ void x_part_fma(const float* xs, const float* wx, int ldx, int D,
                                           int wu, int m0, int gr, int tq,
                                           float (&xacc)[WT][2][4]) {
  const float* w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = wx + local_col(q, 4 * wu + tq) * ldx;
#pragma unroll
  for (int m = 0; m < WT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) xacc[m][n][i] = 0.f;
  for (int d = 0; d < D; ++d) {
    float wq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wq[q] = w[q][d];
#pragma unroll
    for (int m = 0; m < WT; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float xv = xs[(16 * (m0 + m) + 8 * rr + gr) * ldx + d];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& a = xacc[m][q / 2][2 * rr + (q & 1)];
          a = fmaf(xv, wq[q], a);
        }
      }
  }
}

// x [T, G, B, D], w_ih'''
PROLOGUE_X = "  if (t_end > 0) x_part<WT>(x_s, wx, ldx, Dp, wu, m0, gr, tq, xacc);\n"
WINDOW_X = ("    if (t + 1 < t_end)\n"
            "      x_part<WT>(x_s + (t + 1) % kXStages * sx, wx, ldx, Dp, wu, m0, gr, tq, xacc);\n")
PRODUCT = "    // z = h_{t-1} . ws on n-tiles 2 wu, 2 wu + 1\n"
LOOP = "for (int k0 = 0; k0 < H; k0 += 8 * kChunkSteps) {"

ONE_TILE = [("constexpr int kWarpTiles = 2;", "constexpr int kWarpTiles = 1;")]
FMA = [("\n// x [T, G, B, D], w_ih", X_PART_FMA),
       (PROLOGUE_X, PROLOGUE_X.replace("x_part<WT>", "x_part_fma<WT>").replace("Dp,", "D,")),
       (WINDOW_X, WINDOW_X.replace("x_part<WT>", "x_part_fma<WT>").replace("Dp,", "D,"))]
ON_CHAIN = [(WINDOW_X, ""),
            (PRODUCT, "    x_part<WT>(x_s + t % kXStages * sx, wx, ldx, Dp, wu, m0, gr, tq, xacc);\n"
                      + PRODUCT)]
NO_PRODUCT = [(LOOP, LOOP.replace("k0 < H", "k0 < 0"))]
NO_EXCHANGE = [("          st_peer4(", "          if (H < 0) st_peer4(")]
NO_X = [(WINDOW_X, "")]
VARIANTS = {
    "kept": [],
    "one m16 tile a warp": ONE_TILE,
    "x part by FMA": FMA,
    "x part on the chain": ON_CHAIN,
    "no product": NO_PRODUCT,
    "no exchange": NO_EXCHANGE,
    "no x part after step 0": NO_X,
    "barrier, cell, staging only": NO_PRODUCT + NO_EXCHANGE + NO_X,
}


def _time_ms(torch, fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rnn_fused_variants: CUDA is not available; this runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import rnn

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = OUT / str(i)
        shutil.copytree(_build.CSRC_DIR, d)
        for old, new in edits:
            text = (d / HEADER).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant '{name}': {old!r} is not once in {HEADER}")
            (d / HEADER).write_text(text.replace(old, new))
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "rnn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    g = torch.Generator().manual_seed(0)
    scale = H**-0.5
    stream = torch.cuda.current_stream().cuda_stream
    cells = {}
    for cell, gates in (("lstm", 4), ("gru", 3)):
        def u(*shape):
            return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).cuda()

        x = torch.randn(T, G, 64, D, generator=g).cuda()
        w_ih, w_hh, b_ih, b_hh = (u(G, D, gates * H), u(G, H, gates * H), u(G, gates * H),
                                  u(G, gates * H))
        biases = (b_ih + b_hh,) if cell == "lstm" else (b_ih, b_hh)
        cases = []
        for batch, rows in CASES:
            xb = x[:, :, :batch].contiguous()
            lengths = torch.full((batch,), T, dtype=torch.int32, device="cuda")
            plain = getattr(rnn, f"grouped_{cell}_fused_plain")
            cases.append((batch, rows, xb, lengths, plain(xb, w_ih, w_hh, *biases, lengths)))
        cells[cell] = (w_ih, w_hh, biases, cases)
    print(f"grouped_lstm_fused / grouped_gru_fused at T={T} G={G} H={H} D={D}, every row whole:",
          flush=True)
    for name, (d, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant '{name}' does not build:\n{output}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        parts = []
        for cell, (w_ih, w_hh, biases, cases) in cells.items():
            fn = getattr(lib, f"msfa_grouped_{cell}_fused")
            fn.argtypes = [ctypes.c_void_p] * (5 + len(biases)) + [ctypes.c_int] * 6 \
                + [ctypes.c_void_p]
            for batch, rows, xb, lengths, want in cases:
                out = torch.empty(G, batch, H, device="cuda")
                args = [t.data_ptr() for t in (xb, w_ih, w_hh, *biases, lengths, out)] + [
                    T, G, batch, D, H, rows, stream]
                code = fn(*args)
                if code:
                    parts.append(f"{cell} B{batch}/{rows} refused ({code})")
                    continue
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                ms = _time_ms(torch, lambda: fn(*args))
                parts.append(f"{cell} B{batch}/{rows} {ms:.4f} ms {ms / T * 1e3:.3f} us err "
                             f"{err:.1e}")
        print(f"  {name:28s} " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
