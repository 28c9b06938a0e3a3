// Attention forward for the DiT: o = softmax(scale * q k^T + bias) v.
//
// Replaces: ezaudio_tpu/ops/pallas/attention.py::_attn_kernel (one Pallas
// program per (batch, head) holding the whole Lq x Lk score tile in VMEM).
//
// Bound on the H100: at the EzAudio shapes (Lq = 500, Lk = 500 or 100,
// head_dim 64/72) the work is 4*Lq*Lk*D flops per (batch, head) against
// (2*Lq + 2*Lk)*D elements moved, about 60 flops per byte in f32: the
// kernel is bound by arithmetic, and with f32 inputs by the CUDA-core rate.
//
// Design: the TPU design does not carry over (512 x 512 f32 scores are
// 1 MB, beyond one block's 227 KB of shared memory), so the queries are
// split over blocks and K/V stream through shared memory with an online
// softmax in f32 (flash-attention order).  A block owns 32 query rows;
// four threads share a row, each holding a quarter of the head dim in
// registers (dims i*4 + lane, so the four lanes read adjacent words of a
// K/V row and eight rows of a warp read the same words: no bank
// conflicts).  Each 32-key tile is staged once in shared memory for all
// 32 rows; scores are reduced over the four lanes with two shuffles.
// The head dim is padded in registers to a multiple of 4 lanes (72 -> 80).
// The additive bias is the Pallas kernel's: 0 or -1e30 per key, from the
// (B, Lk) key mask; keys past Lk are skipped.  Scores, softmax and both
// products accumulate in f32 for f32 and bf16 inputs; with bf16 inputs p
// is rounded to bf16 before the PV product, as in the Pallas kernel, which
// costs bf16 a second pass over K.  Forward only.
//
// C interface (ctypes): ez_attention_fwd returns the cudaError_t of the
// launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 32;               // query rows per block
constexpr int LANES = 4;               // threads per query row
constexpr int THREADS = ROWS * LANES;  // 128
constexpr int TK = 32;                 // keys per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage keys [k0, k0 + TK) (and their values when `vs` is given) in shared
// memory as f32, with each key's bias; keys past Lk get bias -inf.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(const T* kb, const T* vb, const float* bias,
                                          int b, int Lk, int D, int k0, int tid,
                                          float (*ks)[DP], float (*vs)[DP], float* bs) {
  for (int idx = tid; idx < TK * DP; idx += THREADS) {
    const int j = idx / DP, d = idx % DP;
    const int kj = k0 + j;
    const bool in = kj < Lk && d < D;
    ks[j][d] = in ? to_f(kb[(size_t)kj * D + d]) : 0.f;
    if (vs) vs[j][d] = in ? to_f(vb[(size_t)kj * D + d]) : 0.f;
  }
  if (tid < TK) {
    const int kj = k0 + tid;
    bs[tid] = kj < Lk ? (bias ? bias[(size_t)b * Lk + kj] : 0.f) : -INFINITY;
  }
}

// s[j] = scale * q . k_j + bias_j for the staged tile; returns max_j s[j].
template <int DPT, int DP>
__device__ __forceinline__ float tile_scores(const float* qr, float (*ks)[DP],
                                             const float* bs, int lane, float scale,
                                             float* s) {
  float mt = -INFINITY;
#pragma unroll
  for (int j = 0; j < TK; ++j) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], ks[j][i * LANES + lane], part);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    s[j] = part * scale + bs[j];
    mt = fmaxf(mt, s[j]);
  }
  return mt;
}

// f32 inputs take one pass with an online softmax.  bf16 inputs take two,
// because the Pallas kernel rounds the normalised p = exp(s - m) / sum to
// the value type before the PV product, and that needs each row's final
// max and sum: the first pass finds them, the second accumulates PV.
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const float* __restrict__ bias, T* __restrict__ o,
         int H, int Lq, int Lk, int D, float scale) {
  constexpr int DP = DPT * LANES;  // padded head dim
  constexpr bool kRoundP = !std::is_same<T, float>::value;
  __shared__ float ks[TK][DP];
  __shared__ float vs[TK][DP];
  __shared__ float bs[TK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int lane = tid % LANES;
  const int qi = blockIdx.x * ROWS + row;
  const bool valid = qi < Lq;

  const T* qp = q + ((size_t)bh * Lq + (valid ? qi : 0)) * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * LANES + lane;
    qr[i] = (valid && d < D) ? to_f(qp[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  float s[TK];

  if constexpr (kRoundP) {  // pass 1: the row's max and softmax sum
    for (int k0 = 0; k0 < Lk; k0 += TK) {
      __syncthreads();  // previous tile fully consumed
      load_tile<T, DP>(kb, vb, bias, b, Lk, D, k0, tid, ks, nullptr, bs);
      __syncthreads();
      // the first tile always holds key 0 with a finite score, so mn is finite
      const float mn = fmaxf(m, tile_scores<DPT, DP>(qr, ks, bs, lane, scale, s));
      l *= expf(m - mn);  // 0 on the first tile (m = -inf)
#pragma unroll
      for (int j = 0; j < TK; ++j) l += expf(s[j] - mn);  // 0 for keys past Lk
      m = mn;
    }
  }

  for (int k0 = 0; k0 < Lk; k0 += TK) {
    __syncthreads();
    load_tile<T, DP>(kb, vb, bias, b, Lk, D, k0, tid, ks, vs, bs);
    __syncthreads();
    const float mt = tile_scores<DPT, DP>(qr, ks, bs, lane, scale, s);
    if constexpr (kRoundP) {
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = to_f(from_f<T>(expf(s[j] - m) / l));
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j][i * LANES + lane], acc[i]);
      }
    } else {
      const float mn = fmaxf(m, mt);
      const float corr = expf(m - mn);
      l *= corr;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = expf(s[j] - mn);
        l += p;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j][i * LANES + lane], acc[i]);
      }
      m = mn;
    }
  }

  if (valid) {
    T* op = o + ((size_t)bh * Lq + qi) * D;
    const float inv = kRoundP ? 1.f : 1.f / l;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = i * LANES + lane;
      if (d < D) op[d] = from_f<T>(acc[i] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* o, int B, int H, int Lq, int Lk, int D, float scale,
                   cudaStream_t stream) {
  dim3 grid((Lq + ROWS - 1) / ROWS, B * H);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (D <= 32) {
    attn_fwd<T, 8><<<grid, THREADS, 0, stream>>>(qt, kt, vt, bias, ot, H, Lq, Lk, D, scale);
  } else if (D <= 64) {
    attn_fwd<T, 16><<<grid, THREADS, 0, stream>>>(qt, kt, vt, bias, ot, H, Lq, Lk, D, scale);
  } else if (D <= 80) {
    attn_fwd<T, 20><<<grid, THREADS, 0, stream>>>(qt, kt, vt, bias, ot, H, Lq, Lk, D, scale);
  } else {
    attn_fwd<T, 32><<<grid, THREADS, 0, stream>>>(qt, kt, vt, bias, ot, H, Lq, Lk, D, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Lq, D), k and v (B, H, Lk, D), o (B, H, Lq, D), all contiguous
// and of one type (dtype 0 = float32, 1 = bfloat16); bias (B, Lk) float32
// or null.  D <= 128.
extern "C" int ez_attention_fwd(const void* q, const void* k, const void* v,
                                const float* bias, void* o, int B, int H, int Lq,
                                int Lk, int D, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D <= 0 || D > 128 ||
      B * H > 65535 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch<float>(q, k, v, bias, o, B, H, Lq, Lk, D, scale, s)
      : launch<__nv_bfloat16>(q, k, v, bias, o, B, H, Lq, Lk, D, scale, s);
  return (int)err;
}
