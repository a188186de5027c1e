#!/usr/bin/env python3
"""Where a step of the cluster training kernels (LSTM and GRU) goes, on one
CUDA card.

    python3 scripts/lstm_cluster_variants.py

Builds variants of ``ops/csrc/rnn_train.cu`` from text edits of a copy of
``ops/csrc`` (under ``build/lstm_variants/``, one ``nvcc`` each, all at
once): the kernels as they are (the forward's chunk loop unrolled 4 deep,
the backward's 1); both loops unrolled 1, 2 or 4 deep; the step
product, the exchange through distributed shared
memory or the stores to device memory compiled out, one at a time and all
three (the cell, the staging and the cluster barrier left); clusters of 16
CTAs (a non-portable size: 16 units a CTA, 128 CTAs at B 32); the 3xTF32
split with the hi part left to the tensor core's truncation (two operations
per element instead of three). Both cells share the body, so each edit moves
both. Each
variant's ``lstm_train_fwd`` / ``_bwd`` and ``gru_train_fwd`` / ``_bwd`` run
on the same inputs at T 512, G 4, B 32, H 256, every row whole; prints ms,
µs per step and the error against the plain twins (a variant with a part
compiled out computes something else). Then times the
exchange of one step alone: 8 CTAs of a cluster, 256 threads, each CTA
sending 16 KB (16 rows of its 32 units of h to all 8), four ways: remote
16-byte stores and a cluster barrier (the kernels' way), remote loads after
a barrier, asynchronous remote stores completing on the receiver's
mbarrier, and one bulk copy per peer. Prints the card's name and power
limit first. Needs a CUDA card; imports torch and the port only.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "lstm_variants"
T, G, B, H = 512, 4, 32, 256

FWD_LOOP = "for (int k0 = 0; k0 < H; k0 += 8 * kChunkSteps) {"
BWD_LOOP = "for (int k0 = 0; k0 < depth; k0 += 8 * kChunkSteps) {"
FWD_UNROLL = "#pragma unroll 4\n    " + FWD_LOOP
BWD_UNROLL = "#pragma unroll 1\n      " + BWD_LOOP


def _unroll(depth):
    return [(FWD_UNROLL, f"#pragma unroll {depth}\n    " + FWD_LOOP),
            (BWD_UNROLL, f"#pragma unroll {depth}\n      " + BWD_LOOP)]


NO_PRODUCT = [(FWD_LOOP, FWD_LOOP.replace("k0 < H", "k0 < 0")),
              (BWD_LOOP, BWD_LOOP.replace("k0 < depth", "k0 < 0"))]
NO_EXCHANGE = [("        st_peer4(", "        if (H < 0) st_peer4("),
               ("        st_peer2(peer(slot + gr", "        if (H < 0) st_peer2(peer(slot + gr"),
               ("        st_peer2(peer(slot + (gr", "        if (H < 0) st_peer2(peer(slot + (gr")]
NO_STORES = [("        for (int q = 0; q < NG; ++q) gates[row * cols",
              "        if (H < 0) for (int q = 0; q < NG; ++q) gates[row * cols"),
             ("        hprev[row * H + j]", "        if (H < 0) hprev[row * H + j]"),
             ("        aux[row * H + j]", "        if (H < 0) aux[row * H + j]"),
             ("        for (int q = 0; q < NG; ++q) dx[row",
              "        if (H < 0) for (int q = 0; q < NG; ++q) dx[row")]
TRUNCATED_HI = [("tf32_mma.cuh",
                 "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                 "  lo = __float_as_uint(x - __uint_as_float(hi));",
                 "  hi = __float_as_uint(x);\n"
                 "  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));")]
CLUSTER_16 = [("constexpr int kCluster = 8;", "constexpr int kCluster = 16;"),
              ("rnn_train.cu", "  cudaError_t err = allow_smem(kernel, smem);\n",
               "  cudaError_t err = allow_smem(kernel, smem);\n  if (err == cudaSuccess)\n"
               "    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")]
VARIANTS = {
    "kept": [],
    "cluster of 16": CLUSTER_16,
    "unroll 1": _unroll(1),
    "unroll 2": _unroll(2),
    "unroll 4": _unroll(4),
    "no product": NO_PRODUCT,
    "no exchange": NO_EXCHANGE,
    "no stores": NO_STORES,
    "barrier, cell, staging only": NO_PRODUCT + NO_EXCHANGE + NO_STORES,
    "hi by truncation": TRUNCATED_HI,
}

EXCHANGE_CU = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ unsigned smem(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ unsigned peer(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void arrive() { asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory"); }
__device__ __forceinline__ void wait() { asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory"); }
__device__ __forceinline__ void expect(void* m, int bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}"
               :: "r"(smem(m)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void wait_tx(void* m, int parity) {
  asm volatile("{\n.reg .pred P1;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
               "@P1 bra DONE;\nbra WAIT;\nDONE:\n}" :: "r"(smem(m)), "r"(parity) : "memory");
}
// one step's exchange, `iters` times: 256 threads send 16 KB a CTA, 2 KB to each of 8
template <int MODE>
__global__ void exchange(int iters, float* sink) {
  __shared__ __align__(128) float4 buf[2][8][128];
  __shared__ __align__(128) float4 stage[2][128];
  __shared__ __align__(8) unsigned long long bar[2];
  float acc = threadIdx.x;
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int tid = threadIdx.x;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) { expect(&bar[0], 8 * 2048); expect(&bar[1], 8 * 2048); }
  arrive(); wait();
  for (int i = 0; i < iters; ++i) {
    const int b = i & 1;
    if (MODE == 0) {  // remote 16-byte stores, then a cluster barrier
      for (int k = 0; k < 2; ++k) {
        const unsigned a = peer(&buf[b][rank][(tid / 4) * 2], (tid & 3) + 4 * k);
        asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %1, %1, %1};" :: "r"(a), "f"(acc) : "memory");
        asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %1, %1, %1};" :: "r"(a + 16), "f"(acc) : "memory");
      }
      arrive(); wait();
    } else if (MODE == 1) {  // a cluster barrier, then remote 16-byte loads
      arrive(); wait();
      for (int k = 0; k < 2; ++k) {
        const int r = (tid & 3) + 4 * k;
        const unsigned a = peer(&stage[b][(tid / 4) * 2], r);
        float4 v0, v1;
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v0.x), "=f"(v0.y), "=f"(v0.z), "=f"(v0.w) : "r"(a) : "memory");
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v1.x), "=f"(v1.y), "=f"(v1.z), "=f"(v1.w) : "r"(a + 16) : "memory");
        buf[b][r][(tid / 4) * 2] = v0;
        buf[b][r][(tid / 4) * 2 + 1] = v1;
      }
      __syncthreads();
    } else if (MODE == 2) {  // asynchronous remote stores completing on the receiver's mbarrier
      if (i > 0) wait();
      for (int k = 0; k < 2; ++k) {
        const int r = (tid & 3) + 4 * k;
        const unsigned a = peer(&buf[b][rank][(tid / 4) * 2], r), m = peer(&bar[b], r);
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %1, %1, %1}, [%2];"
                     :: "r"(a), "f"(acc), "r"(m) : "memory");
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %1, %1, %1}, [%2];"
                     :: "r"(a + 16), "f"(acc), "r"(m) : "memory");
      }
      wait_tx(&bar[b], (i >> 1) & 1);
      __syncthreads();
      if (tid == 0) expect(&bar[b], 8 * 2048);
    } else {  // one bulk copy of a 2 KB stage per peer, completing on its mbarrier
      reinterpret_cast<float*>(stage[b])[tid * 2] = acc;
      reinterpret_cast<float*>(stage[b])[tid * 2 + 1] = acc;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (i > 0) wait();
      if (tid < 8)
        asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], 2048, [%2];"
                     :: "r"(peer(&buf[b][rank][0], tid)), "r"(smem(&stage[b][0])), "r"(peer(&bar[b], tid))
                     : "memory");
      wait_tx(&bar[b], (i >> 1) & 1);
      __syncthreads();
      if (tid == 0) expect(&bar[b], 8 * 2048);
    }
    acc += reinterpret_cast<float*>(buf[b])[tid * 5 % 4096];
    if (MODE >= 2) arrive();  // this CTA has read buffer b: peers may refill it
  }
  if (MODE >= 2) wait();
  arrive(); wait();
  if (acc == 12345.f) sink[0] = acc;
}
extern "C" float exchange_us(int mode, int iters) {
  float* sink;
  cudaMalloc(&sink, 4);
  cudaLaunchConfig_t c = {};
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = 8; a[0].val.clusterDim.y = 1; a[0].val.clusterDim.z = 1;
  c.gridDim = dim3(64); c.blockDim = dim3(256); c.attrs = a; c.numAttrs = 1;
  void (*kernels[4])(int, float*) = {exchange<0>, exchange<1>, exchange<2>, exchange<3>};
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {  // the first launch warms up
    cudaEventRecord(e0);
    if (cudaLaunchKernelEx(&c, kernels[mode], iters, sink) != cudaSuccess) return -1.f;
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  if (cudaDeviceSynchronize() != cudaSuccess) return -1.f;
  cudaFree(sink);
  return ms * 1e3f / iters;
}
"""


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
        print("lstm_cluster_variants: CUDA is not available; this runs on the card only",
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
        for edit in edits:
            file, old, new = edit if len(edit) == 3 else ("rnn_cluster.cuh", *edit)
            text = (d / file).read_text()
            if old not in text:
                raise RuntimeError(f"variant '{name}': {old!r} is not in {file}")
            (d / file).write_text(text.replace(old, new))
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "rnn_train.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    (OUT / "exchange.cu").write_text(EXCHANGE_CU)
    exchange = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / "exchange.so"),
         str(OUT / "exchange.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    g = torch.Generator().manual_seed(0)
    lengths = torch.full((B,), T, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}  # cell -> (x_proj, w_hh, b_hh, dh, the twins' forward, their backward)
    for cell, gates in (("lstm", 4), ("gru", 3)):
        x = torch.randn(T, G, B, gates * H, generator=g).cuda()
        w = ((torch.rand(G, H, gates * H, generator=g) * 2 - 1) * H**-0.5).cuda()
        b = ((torch.rand(G, gates * H, generator=g) * 2 - 1) * H**-0.5).cuda()
        dh = torch.randn(G, B, H, generator=g).cuda()
        want = getattr(rnn, f"{cell}_train_fwd_plain")(x, w, b, lengths)
        cases[cell] = (x, w, b, dh, want,
                       getattr(rnn, f"{cell}_train_bwd_plain")(*want[1:], w, lengths, dh))
    print(f"{{lstm,gru}}_train_fwd / _bwd at T={T} G={G} B={B} H={H}:", flush=True)
    for name, (d, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant '{name}' does not build:\n{output}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for cell, (x, w, b, dh, want, want_dz) in cases.items():
            fwd, bwd = getattr(lib, f"msfa_{cell}_train_fwd"), getattr(lib, f"msfa_{cell}_train_bwd")
            # the backward reads the gates and c_{t-1} (LSTM) or h_{t-1} and hn (GRU)
            res_in = (want[1], want[3]) if cell == "lstm" else want[1:]
            fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            bwd.argtypes = [ctypes.c_void_p] * (4 + len(res_in)) + [ctypes.c_int] * 4 + \
                [ctypes.c_void_p]
            out = torch.empty(G, B, H, device="cuda")
            res = [torch.zeros(T, G, B, c, device="cuda") for c in (x.shape[-1], H, H)]
            dz = torch.zeros_like(res[0])
            fwd_args = [t.data_ptr() for t in (x, w, b, lengths, out, *res)] + [T, G, B, H, stream]
            bwd_args = [t.data_ptr() for t in (*res_in, w, lengths, dh, dz)] + [T, G, B, H, stream]
            codes = fwd(*fwd_args), bwd(*bwd_args)
            if any(codes):
                print(f"  {name:28s} {cell} refused to launch (CUDA errors {codes})", flush=True)
                continue
            torch.cuda.synchronize()
            err_fwd = (out - want[0]).abs().max().item()
            err_bwd = ((dz - want_dz).abs().max() / want_dz.abs().max()).item()
            f_ms = _time_ms(torch, lambda: fwd(*fwd_args))
            b_ms = _time_ms(torch, lambda: bwd(*bwd_args))
            print(f"  {name:28s} {cell:4s} forward {f_ms:.4f} ms ({f_ms / T * 1e3:.3f} us a step), "
                  f"backward {b_ms:.4f} ms ({b_ms / T * 1e3:.3f}); h_T max abs err {err_fwd:.2e}, "
                  f"dz rel err {err_bwd:.2e}", flush=True)
    output, _ = exchange.communicate()
    if exchange.returncode:
        raise RuntimeError(f"the exchange benchmark does not build:\n{output}")
    lib = ctypes.CDLL(str(OUT / "exchange.so"))
    lib.exchange_us.restype = ctypes.c_float
    print("one step's exchange alone (8 clusters of 8 CTAs, 16 KB out of each CTA):", flush=True)
    for mode, name in enumerate(("remote stores + cluster barrier",
                                 "cluster barrier + remote loads",
                                 "asynchronous remote stores + mbarrier",
                                 "bulk copies + mbarrier")):
        us = lib.exchange_us(mode, 4096)
        if us < 0:
            raise RuntimeError(f"the exchange benchmark failed: {name}")
        print(f"  {name:40s} {us:.3f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
