// Fused Oobleck ResidualUnit forward, channel-last:
//   y = x + W1 . snake2(conv7_d(snake1(x)) + b7) + b1,
//   snake(x) = x + sin^2(a x) / (b + 1e-9)  (a, b already exp'd),
// where conv7_d is the k=7 correlation with dilation d and 3d zero rows of
// padding at each end.
//
// Replaces: ezaudio_tpu/ops/pallas/resunit.py::_resunit_kernel (one Pallas
// program per (batch, 512-row tile) holding a (TL + 6d, C) window in VMEM,
// the 7 taps as shifted (TL, C) @ (C, C) MXU products).
//
// Bound on the H100: each output row costs 16*C^2 flops (7 taps + the 1x1)
// against 2*C elements read and written, 512 flops per byte at C = 128 in
// f32: bound by arithmetic (the f32 CUDA-core rate), not by memory.
//
// Design: the TPU's (512 + 54) x 512 window is ~1.2 MB, far beyond shared
// memory.  Here a block owns TL = 32 output rows and produces whole C-wide
// rows, because the 1x1 product needs every channel of snake2(conv7):
//   1. for each 128-column chunk of the conv7 output, stream 32-channel
//      chunks of the (TL + 6d)-row input window through shared memory with
//      snake1 applied on load (rows outside [0, L) are the zero padding,
//      and snake(0) = 0 would keep them zero anyway), then for each of the
//      7 taps stage a 32 x 128 weight tile and accumulate a 4 x 4 register
//      tile per thread in f32;
//   2. apply b7 and snake2 and keep the (TL, C) result G in shared memory;
//   3. G @ W1 + b1 plus the residual, written once per output element.
// Windows overlap by the 6d halo rows, so tile seams are exact.  bf16
// inputs are rounded to bf16 where the Pallas kernel casts (after snake1 and
// after snake2); all sums are f32.  Weights are re-read from L2 by every
// block; the 6d halo (54 rows at d = 9) re-reads input rows.  Forward only.
//
// C interface (ctypes): ez_resunit_fwd returns the cudaError_t of the
// launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TL = 32;        // output rows per block
constexpr int NC = 128;       // output-column chunk
constexpr int KC = 32;        // input-channel chunk
constexpr int THREADS = 256;  // 32 column groups x 8 row groups, 4 x 4 each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float snake(float x, float a, float b) {
  const float s = sinf(x * a);
  return x + (1.0f / (b + 1e-9f)) * (s * s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
resunit_fwd(const T* __restrict__ x, const T* __restrict__ w7, const T* __restrict__ b7,
            const T* __restrict__ w1, const T* __restrict__ b1,
            const float* __restrict__ ab, T* __restrict__ y, int L, int C, int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int win = TL + 6 * d;
  float* G = smem;             // [TL][C]   snake2(conv7 + b7)
  float* Hs = G + TL * C;      // [win][KC] snake1(x) window, one channel chunk
  float* Ws = Hs + win * KC;   // [KC][NC]  weight tile

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TL;
  const int tid = threadIdx.x;
  const int c0 = (tid & 31) * 4;  // first of this thread's 4 columns
  const int r0 = (tid >> 5) * 4;  // first of this thread's 4 rows
  const T* xb = x + (size_t)b * L * C;
  const float* a1 = ab;
  const float* be1 = ab + C;
  const float* a2 = ab + 2 * C;
  const float* be2 = ab + 3 * C;

  // ---- 1-2: G = snake2(conv7_d(snake1(x)) + b7) ----
  for (int n0 = 0; n0 < C; n0 += NC) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();  // Hs and Ws free
      for (int idx = tid; idx < win * KC; idx += THREADS) {
        const int r = idx / KC, kk = idx - r * KC;
        const int t = t0 - 3 * d + r, ch = k0 + kk;
        float hv = 0.f;
        if (t >= 0 && t < L) {
          hv = round_to<T>(snake(to_f(xb[(size_t)t * C + ch]), a1[ch], be1[ch]));
        }
        Hs[idx] = hv;
      }
      for (int j = 0; j < 7; ++j) {
        __syncthreads();  // Ws free (and Hs written, for j = 0)
        const T* wj = w7 + ((size_t)j * C + k0) * C + n0;
        for (int idx = tid; idx < KC * NC; idx += THREADS) {
          const int kk = idx / NC, nn = idx - kk * NC;
          Ws[idx] = to_f(wj[(size_t)kk * C + nn]);
        }
        __syncthreads();
        const float* hrow = Hs + (r0 + j * d) * KC;
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
          const float4 w = *reinterpret_cast<const float4*>(Ws + kk * NC + c0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float h = hrow[i * KC + kk];
            acc[i][0] = fmaf(h, w.x, acc[i][0]);
            acc[i][1] = fmaf(h, w.y, acc[i][1]);
            acc[i][2] = fmaf(h, w.z, acc[i][2]);
            acc[i][3] = fmaf(h, w.w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + c0 + c;
        G[(r0 + i) * C + col] =
            round_to<T>(snake(acc[i][c] + to_f(b7[col]), a2[col], be2[col]));
      }
    }
  }

  // ---- 3: y = x + (G @ W1 + b1) ----
  for (int n0 = 0; n0 < C; n0 += NC) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();  // Ws free; G complete before the first read
      const T* wk = w1 + (size_t)k0 * C + n0;
      for (int idx = tid; idx < KC * NC; idx += THREADS) {
        const int kk = idx / NC, nn = idx - kk * NC;
        Ws[idx] = to_f(wk[(size_t)kk * C + nn]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(Ws + kk * NC + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float g = G[(r0 + i) * C + k0 + kk];
          acc[i][0] = fmaf(g, w.x, acc[i][0]);
          acc[i][1] = fmaf(g, w.y, acc[i][1]);
          acc[i][2] = fmaf(g, w.z, acc[i][2]);
          acc[i][3] = fmaf(g, w.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + r0 + i;
      if (t >= L) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + c0 + c;
        const size_t off = (size_t)t * C + col;
        y[(size_t)b * L * C + off] =
            from_f<T>(to_f(xb[off]) + (acc[i][c] + to_f(b1[col])));
      }
    }
  }
}

size_t smem_bytes(int C, int d) {
  return sizeof(float) * ((size_t)TL * C + (size_t)(TL + 6 * d) * KC + (size_t)KC * NC);
}

template <typename T>
cudaError_t launch(const void* x, const void* w7, const void* b7, const void* w1,
                   const void* b1, const float* ab, void* y, int B, int L, int C,
                   int d, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, d);
  cudaError_t err = cudaFuncSetAttribute(
      resunit_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + TL - 1) / TL, B);
  resunit_fwd<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w7), static_cast<const T*>(b7),
      static_cast<const T*>(w1), static_cast<const T*>(b1), ab, static_cast<T*>(y),
      L, C, d);
  return cudaGetLastError();
}

}  // namespace

// x, y (B, L, C); w7 (7, C, C) as (tap, in, out); b7, b1 (C,); w1 (C, C) as
// (in, out); all contiguous and of one type (dtype 0 = float32,
// 1 = bfloat16).  ab (4, C) float32: exp'd alpha1, beta1, alpha2, beta2.
// C must be a multiple of 128; the (TL, C) tile must fit shared memory.
extern "C" int ez_resunit_fwd(const void* x, const void* w7, const void* b7,
                              const void* w1, const void* b1, const float* ab,
                              void* y, int B, int L, int C, int d, int dtype,
                              void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || C <= 0 || C % NC != 0 || d <= 0 ||
      smem_bytes(C, d) > 232448 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch<float>(x, w7, b7, w1, b1, ab, y, B, L, C, d, s)
      : launch<__nv_bfloat16>(x, w7, b7, w1, b1, ab, y, B, L, C, d, s);
  return (int)err;
}
