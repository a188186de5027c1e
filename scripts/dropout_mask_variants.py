#!/usr/bin/env python3
"""What each step of the mask generator's design pays, on one CUDA card.

    python3 scripts/dropout_mask_variants.py

Builds variants of ``ops/csrc/dropout_mask.cu`` from text edits of a copy of
``ops/csrc`` (under ``build/dropout_mask_variants/``, one ``nvcc`` each, all
at once), each changing one step of the design: the kernel as it is; each
32x32->64-bit product as one wide multiply (``(uint64_t)a * b``) instead of
``__umulhi`` and a low multiply; the round keys added in each call instead of
computed once a thread and held; two and four 16-byte chunks (8 and 16 Philox
calls) in flight a thread instead of one; one pass of blocks over the mask (as
many blocks as the mask needs) instead of the card's resident blocks walking
it with a stride. Each variant writes ``[16384, 2048]``, ``[16384, 256]`` and
a layer's three masks (``[16384, 256/2048/256]``, one launch) from one seed at
keep 0.8; checks every byte against the plain version; prints its SASS's
multiply and logic opcodes (``chip_smoke.sass_opcodes``) beside each shape's
integer bound, worked from the Philox calls it needs
(``chip_smoke.mask_int_bound``), then each shape's ms, each call alone
(``chip_smoke.device_ms``), the median of ``ROUNDS`` rounds that take the
variants in turn (min and max beside it). First, the card's own integer rates:
kernels of 8 chains a thread, each step one Philox product (one IMAD.WIDE, or
IMAD.HI and IMAD) and an XOR, an IMAD, or a LOP3 of three chains, in steps a
clock per SM. Prints the card's name and power limit first. Needs a CUDA card;
imports torch and the port only.
"""

from __future__ import annotations

import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "dropout_mask_variants"
SOURCE = "dropout_mask.cu"
ROWS, D, F, KEEP = 16384, 256, 2048, 0.8
ROUNDS = 5

# the card's integer rates: OP 0 a Philox product as one wide multiply and an
# XOR of its halves, 1 the same as IMAD.HI and IMAD, 2 an IMAD, 3 a LOP3 of
# three of the chains; 8 chains a thread
RATES = r'''
#include <stdint.h>
template <int OP>
__global__ void rate_kernel(uint32_t* out, int iters, uint32_t m) {
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = threadIdx.x * 8u + i + blockIdx.x * 977u;
  for (int n = 0; n < iters; ++n) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (OP == 0) {
        const uint64_t p = (uint64_t)m * c[i];
        c[i] = (uint32_t)p ^ (uint32_t)(p >> 32);
      } else if (OP == 1) {
        c[i] = __umulhi(m, c[i]) ^ (m * c[i]);
      } else if (OP == 2) {
        c[i] = c[i] * m + 0x9E3779B9u;
      } else {  // non-linear in the chains, so the compiler cannot fold iterations
        c[i] = (c[i] & c[(i + 1) % 8]) ^ c[(i + 2) % 8];
      }
    }
  }
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r ^= c[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}
extern "C" int msfa_rate(int op, uint32_t* out, int blocks, int threads, int iters, uint32_t m) {
  void (*k[4])(uint32_t*, int, uint32_t) = {rate_kernel<0>, rate_kernel<1>, rate_kernel<2>,
                                            rate_kernel<3>};
  k[op]<<<blocks, threads>>>(out, iters, m);
  return (int)cudaGetLastError();
}
'''
RATE_OPS = ("one wide multiply + XOR", "IMAD.HI + IMAD + XOR", "IMAD", "LOP3")

TWO_MULTIPLIES = "  hi = __umulhi(a, b);\n  lo = a * b;\n"  # __umulhi and a low multiply
ONE_WIDE = ("  const uint64_t p = (uint64_t)a * b;\n  hi = (uint32_t)(p >> 32);\n"
            "  lo = (uint32_t)p;\n")
# the round keys added in each call instead of computed once a thread and held
KEYS_IN_EACH_CALL = [
    ("__device__ __forceinline__ uint32_t group_bytes(uint32_t g0, uint32_t g1, "
     "const RoundKeys& key,\n                                                uint32_t thr) {",
     "__device__ __forceinline__ uint32_t group_bytes(uint32_t g0, uint32_t g1, uint32_t k0,\n"
     "                                                uint32_t k1, uint32_t thr) {"),
    ("    c0 = hi1 ^ c1 ^ key[0][r];\n    c2 = hi0 ^ c3 ^ key[1][r];\n"
     "    c1 = lo1;\n    c3 = lo0;\n",
     "    c0 = hi1 ^ c1 ^ k0;\n    c2 = hi0 ^ c3 ^ k1;\n    c1 = lo1;\n    c3 = lo0;\n"
     "    k0 += kW0;\n    k1 += kW1;\n"),
    ("__device__ __forceinline__ uint4 chunk_bytes(uint32_t c, const RoundKeys& key, uint32_t thr,",
     "__device__ __forceinline__ uint4 chunk_bytes(uint32_t c, uint32_t k0, uint32_t k1, "
     "uint32_t thr,"),
    ("  return make_uint4(group_bytes(g0, g1, key, thr), group_bytes(g0 | 1u, g1, key, thr),\n"
     "                    group_bytes(g0 | 2u, g1, key, thr), group_bytes(g0 | 3u, g1, key, thr));",
     "  return make_uint4(group_bytes(g0, g1, k0, k1, thr), group_bytes(g0 | 1u, g1, k0, k1, thr),\n"
     "                    group_bytes(g0 | 2u, g1, k0, k1, thr), group_bytes(g0 | 3u, g1, k0, k1, "
     "thr));"),
    ("  RoundKeys key;\n  key[0][0] = (uint32_t)seed[0] ^ (purpose * kW0);\n"
     "  key[1][0] = (uint32_t)seed[1];\n#pragma unroll\n  for (int r = 1; r < kRounds; ++r) {\n"
     "    key[0][r] = key[0][r - 1] + kW0;\n    key[1][r] = key[1][r - 1] + kW1;\n  }\n",
     "  const uint32_t k0 = (uint32_t)seed[0] ^ (purpose * kW0), k1 = (uint32_t)seed[1];\n"),
    ("      v[i] = chunk_bytes(c + i * stride, key, thr, all_keep);",
     "      v[i] = chunk_bytes(c + i * stride, k0, k1, thr, all_keep);"),
    ("    const uint4 v = chunk_bytes(whole, key, thr, all_keep);",
     "    const uint4 v = chunk_bytes(whole, k0, k1, thr, all_keep);"),
]
CHUNKS = "constexpr int kChunksInFlight = 1;"
VARIANTS = {
    "kept": [],
    "one wide multiply a product": [(TWO_MULTIPLIES, ONE_WIDE)],
    "round keys added in each call": KEYS_IN_EACH_CALL,
    "two chunks in flight": [(CHUNKS, CHUNKS.replace("1;", "2;"))],
    "four chunks in flight": [(CHUNKS, CHUNKS.replace("1;", "4;"))],
    "one pass of blocks": [("    long long blocks = capacity * chunks / all_chunks;",
                            "    long long blocks = one_pass;")],
}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dropout_mask_variants: CUDA is not available; this runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp

    smoke = _smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = OUT / str(i)
        shutil.copytree(_build.CSRC_DIR, d)
        for old, new in edits:
            text = (d / SOURCE).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant '{name}': {old!r} is not once in {SOURCE}")
            (d / SOURCE).write_text(text.replace(old, new))
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    rate_dir = OUT / "rates"
    rate_dir.mkdir(parents=True)
    (rate_dir / "rates.cu").write_text(RATES)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(rate_dir / "lib.so"),
                    str(rate_dir / "rates.cu")], check=True, capture_output=True)
    rates = ctypes.CDLL(str(rate_dir / "lib.so"))
    rates.msfa_rate.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + \
        [ctypes.c_uint]
    blocks, threads, iters = 8 * sms, 256, 4096
    sink = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    print(f"the card's integer rates (steps of a chain a clock per SM; {blocks} blocks of "
          f"{threads}, 8 chains a thread):", flush=True)
    for op, label in enumerate(RATE_OPS):
        def rate_call():
            if rates.msfa_rate(op, sink.data_ptr(), blocks, threads, iters, 0xD2511F53):
                raise RuntimeError("rate kernel refused")

        ms = smoke.time_ms(rate_call, iters=5)
        per_clock = blocks * threads * iters * 8 / (ms * 1e-3 * sms * clock_mhz * 1e6)
        ops = smoke.sass_opcodes(_build, rate_dir / "lib.so", f"rate_kernelILi{op}E")
        print(f"  {label:26s} {per_clock:6.1f} a clock per SM ({ms:.3f} ms; its SASS "
              f"{list(ops.items())[:6]})", flush=True)

    seed = torch.tensor([20240229, -77], dtype=torch.int32, device="cuda")
    layer = ((D, mlp.RNG_P_ATT), (F, mlp.RNG_P_HIDDEN), (D, mlp.RNG_P_RES))
    cases = {f"[{ROWS}, {F}]": ((F, mlp.RNG_P_HIDDEN),), f"[{ROWS}, {D}]": ((D, mlp.RNG_P_RES),),
             "layer": layer}
    want = {label: mlp.dropout_keep_masks_reference(seed, ROWS, specs, KEEP)
            for label, specs in cases.items()}
    stream = torch.cuda.current_stream().cuda_stream
    thr = mlp._keep_thr(KEEP)
    calls = {}
    bounds = {label: smoke.mask_int_bound(ROWS * sum(c for c, _ in specs) / 4, sms,
                                          clock_mhz * 1e6) for label, specs in cases.items()}
    print(f"mask generator variants, keep {KEEP}; integer bound " + "; ".join(
        f"{label} {ms:.4f} ms" for label, ms in bounds.items()) + f" ({sms} SMs at "
          f"{clock_mhz:.0f} MHz, clocks.max.sm):", flush=True)
    for name, (d, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant '{name}' does not build:\n{output}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.msfa_dropout_masks
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint] * 3 + [
            ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        info = (ctypes.c_int * 3)()
        lib.msfa_dropout_mask_info(info)
        ops = smoke.sass_opcodes(_build, d / "lib.so", "dropout_mask_kernel")
        for label, specs in cases.items():
            outs = [torch.empty((ROWS, c), dtype=torch.uint8, device="cuda") for c, _ in specs]
            slots = [a for o, (_, p) in zip(outs, specs) for a in (o.data_ptr(), o.numel(), p)]
            slots += [None, 0, 0] * (3 - len(outs))

            def call(fn=fn, outs=outs, slots=slots):
                code = fn(seed.data_ptr(), len(outs), *slots, thr, 0, stream)
                if code:
                    raise RuntimeError(f"variant '{name}': launch refused ({code})")

            call()
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want[label])):
                raise AssertionError(f"variant '{name}' {label}: bytes differ from the plain "
                                     f"version")
            calls[(name, label)] = (call, [])
        imad_lop = {op: n for op, n in ops.items() if op.startswith(("IMAD", "LOP3"))}
        print(f"  {name:26s} {info[1]} Philox calls a pass of its loop, {info[2]} blocks "
              f"resident, every byte the plain version's; its SASS {sum(ops.values())} "
              f"instructions, {imad_lop}", flush=True)
    for _ in range(ROUNDS):  # the variants in turn, each call alone
        for call, times in calls.values():
            times.append(smoke.device_ms(call))
    print(f"ms each call alone, the median of {ROUNDS} rounds [min, max]:", flush=True)
    for name in VARIANTS:
        parts = []
        for label in cases:
            times = sorted(calls[(name, label)][1])
            parts.append(f"{label} {times[len(times) // 2]:.4f} [{times[0]:.4f}, "
                         f"{times[-1]:.4f}]")
        print(f"  {name:26s} " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
