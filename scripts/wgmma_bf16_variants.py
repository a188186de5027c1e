#!/usr/bin/env python3
"""The bf16 wgmma kernels' design choices, measured on one CUDA card.

    python3 scripts/wgmma_bf16_variants.py

Builds one source (under ``build/wgmma_bf16_variants/``, one ``nvcc``) on the
port's ``ops/csrc/wgmma_bf16.cuh`` and times, with CUDA events:

- the packed attention forward's bf16 tile (``attention_fwd_wg``, row 1b) at
  B 64, T 512, H 4, d 64, every key valid and on ragged lengths (200-512),
  with one or two warpgroups a block and P split into two or three bf16
  terms. The header fixes both counts (``kAttnWgs``, ``kPTerms``); each
  variant is a copy of it, written beside the source with the two constants
  set and its namespace renamed, so the variants build in one file. Each
  variant's max abs error against the f32 twin and that error
  over the card tests' limit (1e-5 + 1e-5 |twin|), beside the entry and
  ``scaled_dot_product_attention`` in bf16 with the key mask;
- the main loop alone (``WgProduct``, no epilogue) at the bf16 hidden's
  shape (x [16384, 256] . W1 [256, 2048]) for other tiles and ring depths;
- the y = hd W2 product alone (``WgLnProduct<256>``'s loop, 64-deep fresh
  chunks, no epilogue; rows 10b, 12b and 13b) at the training shape (hd
  [16384, 2048] . W2 [2048, 256]): the design's 128-row blocks (one an SM)
  against 64-row blocks (two an SM with a two-stage ring), with the blocks
  an SM that the card's occupancy query gives each;
- the packed attention backward's bf16 entry (row 2b, ``wgmma_attention_bwd.cuh``)
  at B 32, T 512, H 4, d 64 on ragged lengths (1-512) and every key valid,
  a bf16 cotangent: the design, exp by ``expf``, two bf16 terms of P and
  dS, and a cost probe with no exp (wrong values).
  Each variant is ``packed_attention_bwd.cu`` built (one ``nvcc`` each, all
  at once) beside a copy of the header with its constants or its exp
  changed; its time, its kernels' times (torch.profiler), and the share of
  dqkv's entries that differ from the f32 entry's rounded to bf16.

Prints the card's name and power limit first. Needs a CUDA card; imports
torch and the port only.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "wgmma_bf16_variants"
B, T, H, D = 64, 512, 4, 64
N, K, F = 16384, 256, 2048

# (warpgroups a block, bf16 terms of P)
ATTN = ((2, 3), (1, 3), (2, 2), (1, 2))
# (warpgroups a block, columns, ring stages)
LOOPS = ((2, 128, 2), (2, 128, 3), (2, 128, 4), (2, 64, 3), (1, 128, 3), (2, 256, 2))
# y = hd W2 at D 256: (warpgroups a block, ring stages); the design first
Y_LOOPS = ((2, 3), (1, 3), (1, 2))

# one attention variant's kernel and launcher, in the namespace of its header copy
ATTN_VARIANT = r'''
#include "attn_vNS.cuh"
namespace msfa_wg_vNS {
__global__ void __launch_bounds__(AttnWg<64>::kThreads) attn(const bf16* qkv, const int* lengths,
                                                             float* out, float* lse, int T,
                                                             int H, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char raw[];
  constexpr int D = 64;
  const int q0 = blockIdx.x * AttnWg<D>::kRows, h = blockIdx.y, b = blockIdx.z, F = H * D;
  const long ld = 3L * F;
  const bf16* q = qkv + (long)b * T * ld + h * D;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  attention_fwd_wg<D>(q, q + F, q + 2 * F, ld, out + (long)b * T * F + h * D, F,
                      lse + (long)b * T * H + h, H, T, len, q0, sm_scale, align1024(raw));
}

int run_attn(const bf16* qkv, const int* lengths, float* out, float* lse, int B, int T, int H,
             float sm_scale) {
  using A = AttnWg<64>;
  cudaFuncSetAttribute(attn, cudaFuncAttributeMaxDynamicSharedMemorySize, A::kSmemBytes);
  attn<<<dim3((T + A::kRows - 1) / A::kRows, H, B), A::kThreads, A::kSmemBytes>>>(
      qkv, lengths, out, lse, T, H, sm_scale);
  return (int)cudaGetLastError();
}
}  // namespace msfa_wg_vNS
'''

SOURCE = r'''
#include "wgmma_bf16.cuh"
ATTN_VARIANTS
using namespace msfa_wg;

template <class P>
__global__ void __launch_bounds__(P::kThreads) loop(const bf16* x, const bf16* w1, float* sink,
                                                    int N, int K, int F) {
  extern __shared__ __align__(1024) unsigned char raw[];
  const int f0 = blockIdx.x * P::kBN, n0 = blockIdx.y * P::kBM;
  typename P::Acc acc;
  P::run(Operand{x + (long)n0 * K, K, N - n0, K}, Operand{w1 + f0, F, F - f0, K}, K,
         align1024(raw), acc);
  float s = 0.f;  // keeps the product: nothing is stored unless it sums to this
  for (int nb = 0; nb < P::kNB; ++nb)
    for (int i = 0; i < 32; ++i) s += acc[nb][i];
  if (s == 12345.f) sink[threadIdx.x] = s;
}

template <class P>
int run_loop(const bf16* x, const bf16* w1, float* sink, int N, int K, int F) {
  const int bytes = P::kRingBytes + kAlignSlack;
  cudaFuncSetAttribute(loop<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  loop<P><<<dim3(F / P::kBN, N / P::kBM), P::kThreads, bytes>>>(x, w1, sink, N, K, F);
  return (int)cudaGetLastError();
}

template <class P>  // y = hd W2 for P::kBM whole rows, 64-deep fresh chunks
__global__ void __launch_bounds__(P::kThreads) yrows(const bf16* hd, const bf16* w2, float* sink,
                                                     int N, int F, int D) {
  extern __shared__ __align__(1024) unsigned char raw[];
  const int n0 = blockIdx.x * P::kBM;
  typename P::Acc acc;
  P::run(Operand{hd + (long)n0 * F, F, N - n0, F}, Operand{w2, D, D, F}, F, align1024(raw), acc);
  float s = 0.f;
  for (int nb = 0; nb < P::kNB; ++nb)
    for (int i = 0; i < 32; ++i) s += acc[nb][i];
  if (s == 12345.f) sink[threadIdx.x] = s;
}

template <class P>
int run_yrows(const bf16* hd, const bf16* w2, float* sink, int N, int F, int D, int* per_sm) {
  const int bytes = P::kRingBytes + kAlignSlack;
  cudaFuncSetAttribute(yrows<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, yrows<P>, P::kThreads, bytes);
  yrows<P><<<(N + P::kBM - 1) / P::kBM, P::kThreads, bytes>>>(hd, w2, sink, N, F, D);
  return (int)cudaGetLastError();
}

extern "C" {
int yrows_variant(int v, const bf16* hd, const bf16* w2, float* sink, int N, int F, int D,
                  int* per_sm) {
  switch (v) {
    Y_CASES
    default: return -1;
  }
}
int attn_variant(int v, const bf16* qkv, const int* lengths, float* out, float* lse, int B,
                 int T, int H, float sm_scale) {
  switch (v) {
    ATTN_CASES
    default: return -1;
  }
}
int loop_variant(int v, const bf16* x, const bf16* w1, float* sink, int N, int K, int F) {
  switch (v) {
    LOOP_CASES
    default: return -1;
  }
}
}
'''


def _header_variant(header: str, i: int, wgs: int, terms: int) -> str:
    """wgmma_bf16.cuh with its attention tile's warpgroups and terms of P set
    and its namespace renamed, so that variants live side by side."""
    for old, new in (("#pragma once\n", ""), ("namespace msfa_wg {", f"namespace msfa_wg_v{i} {{"),
                     ("constexpr int kPTerms = 3;", f"constexpr int kPTerms = {terms};"),
                     ("constexpr int kAttnWgs = 2;", f"constexpr int kAttnWgs = {wgs};")):
        if header.count(old) != 1:
            raise RuntimeError(f"wgmma_bf16.cuh no longer holds {old!r} once")
        header = header.replace(old, new)
    return header


def _write_source(csrc: Path) -> None:
    header = (csrc / "wgmma_bf16.cuh").read_text()
    for i, (w, t) in enumerate(ATTN):
        (OUT / f"attn_v{i}.cuh").write_text(_header_variant(header, i, w, t))
    variants = "".join(ATTN_VARIANT.replace("NS", str(i)) for i in range(len(ATTN)))
    attn = "\n    ".join(f"case {i}: return msfa_wg_v{i}::run_attn(qkv, lengths, out, lse, B, T, "
                         f"H, sm_scale);" for i in range(len(ATTN)))
    loops = "\n    ".join(
        f"case {i}: return run_loop<WgProduct<{m}, {c}, false, true, false, {s}>>(x, w1, sink, "
        f"N, K, F);" for i, (m, c, s) in enumerate(LOOPS))
    ys = "\n    ".join(
        f"case {i}: return run_yrows<WgProduct<{m}, 256, false, true, true, {s}, 2>>(hd, w2, "
        f"sink, N, F, D, per_sm);" for i, (m, s) in enumerate(Y_LOOPS))
    (OUT / "variants.cu").write_text(SOURCE.replace("ATTN_VARIANTS", variants)
                                     .replace("ATTN_CASES", attn).replace("LOOP_CASES", loops)
                                     .replace("Y_CASES", ys))


# row 2b: (label, replacements in wgmma_attention_bwd.cuh)
_P_BODY = "return ex2(fmaf(s, sm_scale * kLog2e, -lse * kLog2e));"
BWD = (("design", ()),
       ("exp by expf", ((_P_BODY, "return expf(s * sm_scale - lse);"),)),
       ("two terms of P and dS",
        (("constexpr int kBwdPTerms = 3;", "constexpr int kBwdPTerms = 2;"),
         ("constexpr int kDsTerms = 3;", "constexpr int kDsTerms = 2;"))),
       ("no exp (cost probe)", ((_P_BODY, "return s * sm_scale - lse;"),)))


def _build_bwd_variants(build) -> list:
    """One library a row-2b variant: the entry's source beside its header copy."""
    header = (build.CSRC_DIR / "wgmma_attention_bwd.cuh").read_text()
    procs = []
    for i, (_label, edits) in enumerate(BWD):
        out = OUT / f"bwd_v{i}"
        out.mkdir(parents=True, exist_ok=True)
        text = header
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"wgmma_attention_bwd.cuh no longer holds {old!r}")
            text = text.replace(old, new)
        (out / "wgmma_attention_bwd.cuh").write_text(text)
        (out / "packed_attention_bwd.cu").write_text(
            (build.CSRC_DIR / "packed_attention_bwd.cu").read_text())
        procs.append(subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o",
             str(out / "lib.so"), str(out / "packed_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, proc in enumerate(procs):
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"row 2b variant {BWD[i][0]} did not build:\n{output}")
        lib = ctypes.CDLL(str(OUT / f"bwd_v{i}" / "lib.so"))
        lib.msfa_packed_attention_bwd_bf16.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        lib.msfa_packed_attention_bwd_bf16_scratch.argtypes = [ctypes.c_int] * 4
        lib.msfa_packed_attention_bwd_bf16_scratch.restype = ctypes.c_longlong
        libs.append(lib)
    return libs


def _bwd_rows(torch, ta, libs, g) -> None:
    """Row 2b's variants at the training shape, printed one line a length set."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, heads, scale = 32, H, D**-0.5
    qkv = torch.randn(b, T, 3 * heads * D, generator=g).to(torch.bfloat16).cuda()
    for label, lengths in (("ragged 1-512", torch.randint(1, T + 1, (b,), generator=g,
                                                          dtype=torch.int32)),
                           ("every key", torch.full((b,), T, dtype=torch.int32))):
        lengths = lengths.cuda()
        out, lse = ta.packed_attention_fwd(qkv.float(), lengths, heads, scale)
        dout = torch.randn(out.shape, generator=g).to(torch.bfloat16).float().cuda()
        f32 = ta.packed_attention_bwd(qkv.float(), lengths, out, lse, dout, heads, scale)
        dqkv = torch.empty_like(qkv)
        parts = []
        for (name, _edits), lib in zip(BWD, libs):
            scratch = torch.empty(lib.msfa_packed_attention_bwd_bf16_scratch(b, T, heads, D),
                                  device="cuda")

            def call(lib=lib, scratch=scratch):
                code = lib.msfa_packed_attention_bwd_bf16(
                    qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    dout.data_ptr(), scratch.data_ptr(), dqkv.data_ptr(), b, T, heads, D,
                    scale, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"row 2b variant {name} refused: {code}")

            ms = _time_ms(torch, call)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            kernels = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    key = e.name.split("<")[0].split("::")[-1]
                    kernels[key] = kernels.get(key, 0.0) + e.time_range.elapsed_us() / 5e3
            off = (dqkv != f32.to(torch.bfloat16)).float().mean().item()
            parts.append(f"{name} {ms:.4f} ms (" + ", ".join(
                f"{k} {v:.4f}" for k, v in kernels.items()) + f"; {off:.2e} of dqkv differ from "
                f"the f32 entry's rounded)")
        print(f"row 2b, {label} ({lengths.sum().item()} of {b * T} keys): " + " | ".join(parts),
              flush=True)


def _time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
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
        print("wgmma_bf16_variants: CUDA is not available; this runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    bwd_libs = _build_bwd_variants(_build)
    _write_source(_build.CSRC_DIR)
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(OUT), "-I",
                            str(_build.CSRC_DIR), "-o",
                            str(OUT / "lib.so"), str(OUT / "variants.cu")],
                           capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(OUT / "lib.so"))
    lib.attn_variant.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float]
    lib.loop_variant.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.yrows_variant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p])

    g = torch.Generator().manual_seed(1)
    scale = D**-0.5
    qkv = torch.randn(B, T, 3 * H * D, generator=g).to(torch.bfloat16).cuda()
    view = qkv.view(B, T, 3, H, D)
    q, k, v = (view[:, :, i].transpose(1, 2) for i in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = torch.empty(B, T, H * D, device="cuda")
    lse = torch.empty(B, T, H, device="cuda")
    for label, lengths in (("every key", torch.full((B,), T, dtype=torch.int32)),
                           ("ragged", torch.randint(200, T + 1, (B,), generator=g,
                                                    dtype=torch.int32))):
        lengths = lengths.cuda()
        twin, _ = ta.packed_attention_bf16_reference(qkv, lengths, H, scale)
        mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        parts = []
        for i, (w, terms) in enumerate(ATTN):
            def call(i=i):
                return lib.attn_variant(i, qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                                        lse.data_ptr(), B, T, H, scale)

            if call():
                raise RuntimeError(f"attention variant {w} warpgroups, {terms} terms refused")
            ms = _time_ms(torch, call)
            err = (out - twin).abs()
            parts.append(f"{w} wg {terms} terms {ms:.4f} ms (err {err.max().item():.2e}, "
                         f"{(err / (1e-5 + 1e-5 * twin.abs())).max().item():.3f} of the limit)")
        entry = _time_ms(torch, lambda: ta.packed_attention_fwd_bf16(qkv, lengths, H, scale))
        library = _time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask))
        parts.append(f"entry {entry:.4f} | SDPA bf16 {library:.4f}")
        print(f"row 1b, {label}: " + " | ".join(parts), flush=True)

    x = torch.randn(N, K, generator=g).to(torch.bfloat16).cuda()
    w1 = torch.randn(K, F, generator=g).to(torch.bfloat16).cuda()
    sink = torch.zeros(1024, device="cuda")
    parts = []
    for i, (m, c, s) in enumerate(LOOPS):
        def call(i=i):
            return lib.loop_variant(i, x.data_ptr(), w1.data_ptr(), sink.data_ptr(), N, K, F)

        if call():
            raise RuntimeError(f"main-loop variant {i} refused")
        parts.append(f"{64 * m}x{c} ({m} wg, {s} stages) {_time_ms(torch, call):.4f}")
    print(f"main loop alone, x [{N}, {K}] . W1 [{K}, {F}], ms: " + " | ".join(parts), flush=True)

    hd = torch.randn(N, F, generator=g).to(torch.bfloat16).cuda()
    w2 = (torch.randn(F, K, generator=g) * F**-0.5).to(torch.bfloat16).cuda()
    per_sm = ctypes.c_int(0)
    parts = []
    for i, (m, s) in enumerate(Y_LOOPS):
        def call(i=i):
            return lib.yrows_variant(i, hd.data_ptr(), w2.data_ptr(), sink.data_ptr(), N, F, K,
                                     ctypes.byref(per_sm))

        if call():
            raise RuntimeError(f"y = hd W2 variant {i} refused")
        parts.append(f"{64 * m} rows ({m} wg, {s} stages, {per_sm.value} an SM) "
                     f"{_time_ms(torch, call):.4f}")
    print(f"y = hd W2 alone, hd [{N}, {F}] . W2 [{F}, {K}], 64-deep fresh chunks, ms: "
          + " | ".join(parts), flush=True)
    _bwd_rows(torch, ta, bwd_libs, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
