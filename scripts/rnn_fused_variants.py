#!/usr/bin/env python3
"""Where a step of the serving recurrences' cluster body goes, on one CUDA card.

    python3 scripts/rnn_fused_variants.py

Builds variants of ``ops/csrc/rnn.cu`` from text edits of a copy of
``ops/csrc`` (under ``build/rnn_fused_variants/``, one ``nvcc`` each, all at
once): the kernels as they are; one m16 tile a warp at 32 rows a cluster
(512 threads a CTA) instead of two (256 threads, each B fragment split once
for both tiles); the x part (x_t . W_ih slice) by f32 FMAs on the CUDA
cores instead of 3xTF32; the x part on the step's chain (at the top of the
step) instead of in the cluster barrier's wait; the precomputed projection
(``grouped_lstm_forward``) staged through shared memory (one stage of the
CTA's 4U columns, copied by cp.async at the top of the step behind the
product, a CTA barrier before the cell) instead of loaded into registers
one step ahead in the barrier's wait; and the step product, the exchange
through distributed shared memory or the x part (x_proj's loads) compiled
out, one at a time and all three (the cell, the staging and the cluster
barrier left). Each variant's ``grouped_lstm_fused``, ``grouped_gru_fused``
and ``grouped_lstm_forward`` run on the same inputs at T 512, G 4, H 256, D
17, every row whole: B 32 at 16 rows a cluster (one wave), B 64 at 32 rows
(one wave) and at 16 (two waves); prints ms, us per step and the error
against the plain versions (a variant with a part compiled out computes
something else). Prints the card's name and power limit first. Needs a CUDA
card; imports torch and the port only.
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

// kXRaw: x [T, G, B, D]'''
PROLOGUE_X = "    if constexpr (XSRC == kXRaw) x_part<WT>(x_s, wx, ldx, Dp, wu, m0, gr, tq, xacc);\n"
WINDOW_X = ("      if constexpr (XSRC == kXRaw)\n"
            "        x_part<WT>(x_s + (t + 1) % kXStages * sx, wx, ldx, Dp, wu, m0, gr, tq, xacc);\n")
PROLOGUE_PROJ = "    else load_x_proj<WT>(x, 0, grp, b0, m0, gr, j, G, B, H, xacc);\n"
WINDOW_PROJ = ("      else\n"
               "        load_x_proj<WT>(x, t + 1, grp, b0, m0, gr, j, G, B, H, xacc);\n")
WINDOW = "    if (t + 1 < t_end) {\n" + WINDOW_X + WINDOW_PROJ + "    }\n"
PRODUCT = "    // z = h_{t-1} . ws on n-tiles 2 wu, 2 wu + 1\n"
CELL = "    // the cell of unit j for rows gr + 8 rr + 16 (m0 + m): acc[m][0] holds\n"
LOOP = "for (int k0 = 0; k0 < H; k0 += 8 * kChunkSteps) {"
STAGE_PROJ = r'''
// x_proj [T, G, B, 4H] at step t, the CTA's 4U gate columns of the tile's
// rows -> dst[row][gate][unit] (row stride 4U + kPad): 16-byte cp.async
// copies, zero-filled past the batch; one commit group
__device__ __forceinline__ void stage_x_proj(const float* __restrict__ x_proj, float* dst, int t,
                                             int grp, int b0, int c0, int G, int B, int H, int U,
                                             int rows) {
  const int quads = U / 4, per_row = 4 * quads;
  const size_t base = ((size_t)t * G + grp) * B;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, k = i - r * per_row, q = k / quads, u = 4 * (k - q * quads);
    const int b = b0 + r;
    cp_async16(dst + r * (4 * U + kPad) + q * U + u,
               b < B ? x_proj + (base + b) * 4 * H + q * H + c0 + u : x_proj, b < B);
  }
  cp_async_commit();
}

// kXRaw: x [T, G, B, D]'''
READ_STAGE = r'''    if constexpr (XSRC == kXProj) {  // every thread's copies of step t, in place
      cp_async_wait<0>();
      __syncthreads();
      const float* xs = h_s + 2 * kRows * ld;
#pragma unroll
      for (int m = 0; m < WT; ++m)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xacc[m][q / 2][2 * rr + (q & 1)] =
                xs[(16 * (m0 + m) + 8 * rr + gr) * (4 * U + kPad) + q * U + 4 * wu + tq];
    }
'''

ONE_TILE = [("constexpr int kWarpTiles = 2;", "constexpr int kWarpTiles = 1;")]
FMA = [("\n// kXRaw: x [T, G, B, D]", X_PART_FMA),
       (PROLOGUE_X, PROLOGUE_X.replace("x_part<WT>", "x_part_fma<WT>").replace("Dp,", "D,")),
       (WINDOW_X, WINDOW_X.replace("x_part<WT>", "x_part_fma<WT>").replace("Dp,", "D,"))]
ON_CHAIN = [(WINDOW_X, "      if constexpr (XSRC == kXRaw) {\n      }\n"),
            (PRODUCT, "    if constexpr (XSRC == kXRaw)\n"
                      "      x_part<WT>(x_s + t % kXStages * sx, wx, ldx, Dp, wu, m0, gr, tq, xacc);\n"
                      + PRODUCT)]
# row 16's x_proj through one shared-memory stage (all that fits beside W_hh
# and h at 32 rows), staged at the top of the step behind the product
X_PROJ_STAGED = [
    ("  const size_t x_side = D > 0 ? 4 * U * ldx + kXStages * rows * ldx : 0;",
     "  const size_t x_side = D > 0 ? 4 * U * ldx + kXStages * rows * ldx : rows * (4 * U + kPad);"),
    ("\n// kXRaw: x [T, G, B, D]", STAGE_PROJ),
    (PROLOGUE_PROJ, ""), (WINDOW_PROJ, ""),
    (PRODUCT, "    if constexpr (XSRC == kXProj)  // step t's x_proj, behind the product\n"
              "      stage_x_proj(x, h_s + 2 * kRows * ld, t, grp, b0, c0, G, B, H, U, kRows);\n"
              + PRODUCT),
    (CELL, READ_STAGE + CELL)]
NO_PRODUCT = [(LOOP, LOOP.replace("k0 < H", "k0 < 0"))]
NO_EXCHANGE = [("          st_peer4(", "          if (H < 0) st_peer4(")]
NO_X = [(WINDOW, "")]
VARIANTS = {
    "kept": [],
    "one m16 tile a warp": ONE_TILE,
    "x part by FMA": FMA,
    "x part on the chain": ON_CHAIN,
    "x_proj staged in smem": X_PROJ_STAGED,
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
    for cell, gates in (("lstm", 4), ("gru", 3), ("lstm_proj", 4)):
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
            if cell == "lstm_proj":  # x_proj [T, G, B, 4H] (b_ih inside), W_hh, b_hh
                inputs = ((torch.einsum("tgbd,gdh->tgbh", xb, w_ih)
                           + b_ih[None, :, None, :]).contiguous(), w_hh, b_hh)
                want = rnn.grouped_lstm_forward_plain(*inputs, lengths)
            else:
                inputs = (xb, w_ih, w_hh, *biases)
                want = getattr(rnn, f"grouped_{cell}_fused_plain")(*inputs, lengths)
            cases.append((batch, rows, inputs, lengths, want))
        cells[cell] = cases
    print(f"grouped_lstm_fused / grouped_gru_fused / grouped_lstm_forward (lstm_proj) at T={T} "
          f"G={G} H={H} D={D}, every row whole:", flush=True)
    for name, (d, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant '{name}' does not build:\n{output}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        parts = []
        for cell, cases in cells.items():
            proj = cell == "lstm_proj"
            fn = getattr(lib, "msfa_grouped_lstm_forward" if proj else f"msfa_grouped_{cell}_fused")
            for batch, rows, inputs, lengths, want in cases:
                fn.argtypes = [ctypes.c_void_p] * (len(inputs) + 2) + \
                    [ctypes.c_int] * (5 if proj else 6) + [ctypes.c_void_p]
                out = torch.empty(G, batch, H, device="cuda")
                dims = [T, G, batch, H, rows] if proj else [T, G, batch, D, H, rows]
                args = [t.data_ptr() for t in (*inputs, lengths, out)] + dims + [stream]
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
