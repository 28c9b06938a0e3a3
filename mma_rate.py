#!/usr/bin/env python3
"""The tensor-core rate that warp-level ``mma.sync`` reaches on this card.

    python3 mma_rate.py   # needs one CUDA card and nvcc

The port's kernels (``ezaudio_tpu_torch/csrc``) issue ``mma.sync``:
m16n8k8 TF32 (three per f32-accurate product) and m16n8k16 bf16.  This
script times long runs of independent MMAs on register operands, so
nothing but the tensor cores limits them, at 4, 8 and 16 warps per SM.
It prints one JSON line per run with the rate in TFLOP/s, the card's name
and power limit, and exits non-zero without a card.  The rate is the
ceiling of a kernel built on ``mma.sync``; ``wgmma`` is not measured here.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// Each warp runs `iters` rounds of 8 independent MMAs on register operands.
template <bool kBf16>
__global__ void mma_loop(float* out, int iters) {
  const uint32_t one = kBf16 ? 0x3c003c00u : 0x3a800000u;  // small, finite operands
  uint32_t a[4] = {one, one, one, one}, b[2] = {one, one};
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kBf16) {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int ez_mma_loop(int bf16, int blocks, int threads, int iters, float* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) mma_loop<true><<<blocks, threads, 0, s>>>(out, iters);
  else mma_loop<false><<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

MMAS_PER_ROUND = 8
FLOPS_PER_MMA = {"tf32": 2 * 16 * 8 * 8, "bf16": 2 * 16 * 8 * 16}


def build() -> ctypes.CDLL:
    from ezaudio_tpu_torch.ops.kernels import _build

    flags = _build.NVCC_FLAGS
    digest = hashlib.sha1((SOURCE + " ".join(flags)).encode()).hexdigest()[:12]
    os.makedirs(_build.build_dir(), exist_ok=True)
    lib = os.path.join(_build.build_dir(), f"libmma_rate-{digest}.so")
    if not os.path.exists(lib):
        src = lib[:-3] + ".cu"
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_build._nvcc(), *flags, "-o", lib, src], check=True,
                       capture_output=True, text=True)
    fn = ctypes.CDLL(lib).ez_mma_loop
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, I, I, P, P]
    fn.restype = I
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import card_line

    fn = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    print(card_line(), flush=True)
    for kind in ("tf32", "bf16"):
        for warps in (4, 8, 16):
            blocks, threads = sms * warps // 4, 128
            out = torch.empty(blocks * threads, device="cuda")
            launch = lambda: fn(kind == "bf16", blocks, threads, iters,  # noqa: E731
                                out.data_ptr(), stream)
            if launch() != 0:
                raise RuntimeError("mma_loop launch failed")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            mmas = blocks * threads // 32 * iters * MMAS_PER_ROUND
            print(json.dumps(dict(mma=kind, warps_per_sm=warps, sms=sms, ms=ms,
                                  tflops=mmas * FLOPS_PER_MMA[kind] / ms / 1e9)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
