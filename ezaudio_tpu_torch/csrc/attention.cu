// Attention forward for the DiT: o = softmax(scale * q k^T + bias) v.
//
// Replaces: ezaudio_tpu/ops/pallas/attention.py::_attn_kernel (one Pallas
// program per (batch, head) holding the whole Lq x Lk score tile in VMEM).
//
// Bound on the H100: at the EzAudio shapes (Lq = 500, Lk = 500 or 100,
// head_dim 64/72) the work is 4*Lq*Lk*D flops per (batch, head) against
// (2*Lq + 2*Lk)*D elements moved.  In f32 every product runs as three TF32
// tensor-core products (3xTF32, mma_tf32.cuh), so the bound is
// 3 * flops / 495 TFLOP/s: self-attention is bound by operations, the
// 100-key cross-attention by bytes.
//
// Design (flash-attention order on warp-level mma.sync):
//   - a block of 4 warps owns 64 query rows, 16 per warp (the m16 of the
//     MMA).  At one prompt B*H = 32, so Lq = 500 gives 8 x 32 = 256 blocks:
//     at ~87 KB of shared memory two blocks fit an SM, and the 256 blocks
//     are resident on the 132 SMs at once (one wave, 8 warps per SM);
//   - 64-key K/V tiles are double-buffered in shared memory with 16-byte
//     cp.async (row pad of 4 f32 / 8 bf16 keeps the fragment loads free of
//     bank conflicts); the Q tile is staged once the same way;
//   - S = Q K^T with 3xTF32 (f32) or bf16 (bf16) MMAs into accumulator
//     fragments; the softmax runs on the fragments in base 2, row max and
//     sum reduced over the 4 threads of a quad with shuffles;
//   - O += P V on the same MMAs.  In f32 the accumulator layout of P is not
//     the TF32 A layout (a thread holds C columns 2t, 2t+1, but A columns t,
//     t+4).  The key order inside P V is free, so A takes logical column t
//     from key 2t and t+4 from key 2t+1, and the V fragment is loaded in the
//     same order (b0 = V[2t][g], b1 = V[2t+1][g]): no shuffle.  In bf16 the
//     C pairs are the A pairs (FlashAttention-2's register reuse) and V's B
//     fragment comes from ldmatrix .trans.
// f32 takes one pass with an online softmax.  bf16 takes two, because the
// Pallas kernel rounds the normalised p = exp(s - m) / sum to the value
// type before the PV product: the first pass finds each row's max and sum,
// the second rounds p as the bf16 A operand and accumulates P V in f32.
// The additive bias is the Pallas kernel's: 0 or -1e30 per key, from the
// (B, Lk) key mask; keys past Lk get -inf, and a fully masked row stays
// uniform over its masked keys.  The head dim is zero-padded in shared
// memory to 64/72/128 (f32, a multiple of the k8 step) or 64/80/128 (bf16,
// of the k16 step).  Head dims not a multiple of 16 bytes are staged
// with plain loads instead of cp.async.  Forward only.
//
// Not wgmma: TF32 wgmma needs both operands K-major in shared memory, and V
// (Lk, D) is MN-major for P V, so V would have to be transposed in shared
// memory first; that, TMA and persistent blocks are later work.
//
// C interface (ctypes): ez_attention_fwd returns the cudaError_t of the
// launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

using namespace ezk;

constexpr int ROWS = 64;     // query rows per block, 16 per warp
constexpr int THREADS = 128;
constexpr int TK = 64;       // keys per shared-memory tile
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Cfg;
template <> struct Cfg<float> {          // 16 bytes = 4 elements; pad 4
  static constexpr int VEC = 4, PAD = 4;
};
template <> struct Cfg<__nv_bfloat16> {  // 16 bytes = 8 elements; pad 8
  static constexpr int VEC = 8, PAD = 8;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + n) of a (L, D) matrix into a [n][DP + PAD] shared tile,
// zero past L and past D: cp.async when `vec` (D a multiple of 16 bytes and
// 16-byte aligned bases), plain loads otherwise.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int n, int L,
                                          int D, bool vec, int tid) {
  constexpr int LD = DP + Cfg<T>::PAD;
  constexpr int V = Cfg<T>::VEC;
  constexpr int CPR = DP / V;  // 16-byte chunks per row
  if (vec) {
    for (int idx = tid; idx < n * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx - r * CPR) * V;
      const bool in = row0 + r < L && c < D;
      cp_async16(dst + r * LD + c, in ? src + (size_t)(row0 + r) * D + c : src, in);
    }
  } else {
    for (int idx = tid; idx < n * DP; idx += THREADS) {
      const int r = idx / DP, c = idx - r * DP;
      const bool in = row0 + r < L && c < D;
      dst[r * LD + c] = in ? src[(size_t)(row0 + r) * D + c] : from_f<T>(0.f);
    }
  }
}

// s[n] (keys n*8..n*8+7 of the tile) = q k^T for this warp's 16 rows.
template <typename T, int DP>
__device__ __forceinline__ void scores(float (*s)[4], const T* qw, const T* kt, int g, int t) {
  constexpr int LD = DP + Cfg<T>::PAD;
  constexpr int NT = TK / 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const float* qa = qw + kk * 8;
      uint32_t ahi[4], alo[4];
      split_tf32(qa[g * LD + t], ahi[0], alo[0]);
      split_tf32(qa[(g + 8) * LD + t], ahi[1], alo[1]);
      split_tf32(qa[g * LD + t + 4], ahi[2], alo[2]);
      split_tf32(qa[(g + 8) * LD + t + 4], ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kr = kt + (n * 8 + g) * LD + kk * 8;
        uint32_t bhi[2], blo[2];
        split_tf32(kr[t], bhi[0], blo[0]);
        split_tf32(kr[t + 4], bhi[1], blo[1]);
        mma3xtf32(s[n], ahi, alo, bhi, blo);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const T* qa = qw + kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qa + g * LD);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + (g + 8) * LD);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + g * LD + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + (g + 8) * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* kr = kt + (n * 8 + g) * LD + kk * 16 + 2 * t;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(kr);
        b[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(s[n], a, b);
      }
    }
  }
}

// o[n] (head dims n*8..n*8+7) += p v for this warp's 16 rows; p holds the
// tile's probabilities in the accumulator layout of `scores`.
template <typename T, int DP>
__device__ __forceinline__ void accumulate_pv(float (*o)[4], float (*p)[4], const T* vt,
                                              int g, int t, int lane) {
  constexpr int LD = DP + Cfg<T>::PAD;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk) {
      // logical k = t is key 2t, k = t + 4 is key 2t + 1 (see the header)
      uint32_t ahi[4], alo[4];
      split_tf32(p[kk][0], ahi[0], alo[0]);
      split_tf32(p[kk][2], ahi[1], alo[1]);
      split_tf32(p[kk][1], ahi[2], alo[2]);
      split_tf32(p[kk][3], ahi[3], alo[3]);
      const float* vr = vt + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t bhi[2], blo[2];
        split_tf32(vr[n * 8], bhi[0], blo[0]);
        split_tf32(vr[LD + n * 8], bhi[1], blo[1]);
        mma3xtf32(o[n], ahi, alo, bhi, blo);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        ldmatrix_b_trans(b, vt + kk * 16 * LD + n * 8, LD, lane);
        mma_bf16(o[n], a, b);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return (size_t)(ROWS + 4 * TK) * (DP + Cfg<T>::PAD) * sizeof(T) + 2 * TK * sizeof(float);
}

// Scores are kept in base 2: s2 = log2(e) * (scale * q.k + bias).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const float* __restrict__ bias, T* __restrict__ o,
         int H, int Lq, int Lk, int D, float scale_log2, bool vec) {
  constexpr int LD = DP + Cfg<T>::PAD;
  constexpr int NT = TK / 8;  // key columns of S, in 8s
  constexpr int DT = DP / 8;  // head-dim columns of O, in 8s
  constexpr bool kTwoPass = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);               // [ROWS][LD]
  T* Ks = Qs + ROWS * LD;                               // [2][TK][LD]
  T* Vs = Ks + 2 * TK * LD;                             // [2][TK][LD]
  float* bs = reinterpret_cast<float*>(Vs + 2 * TK * LD);  // [2][TK]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;

  // Tile sequence: bf16 walks the keys twice (pass 1: K only), f32 once.
  const int ntiles = (Lk + TK - 1) / TK;
  const int first = kTwoPass ? 0 : ntiles;
  const int total = 2 * ntiles;
  auto load_tile = [&](int it) {
    const int st = it & 1;
    const bool pass2 = it >= ntiles;
    const int k0 = (pass2 ? it - ntiles : it) * TK;
    load_rows<T, DP>(Ks + st * TK * LD, kb, k0, TK, Lk, D, vec, tid);
    if (pass2) load_rows<T, DP>(Vs + st * TK * LD, vb, k0, TK, Lk, D, vec, tid);
    if (tid < TK) {
      const int kj = k0 + tid;
      bs[st * TK + tid] =
          kj < Lk ? (bias ? bias[(size_t)b * Lk + kj] * LOG2E : 0.f) : -INFINITY;
    }
  };

  load_rows<T, DP>(Qs, q + (size_t)bh * Lq * D, q0, ROWS, Lq, D, vec, tid);
  load_tile(first);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float inv[2] = {1.f, 1.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const T* qw = Qs + warp * 16 * LD;

  for (int it = first; it < total; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` visible; every warp is done with tile it - 1
    if (it + 1 < total) {
      load_tile(it + 1);
      cp_async_commit();
    }
    const int st = it & 1;
    const float* bt = bs + st * TK;
    float s[NT][4];
    scores<T, DP>(s, qw, Ks + st * TK * LD, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = s[n][c] * scale_log2 + bt[n * 8 + 2 * t + (c & 1)];
    }
    if (it < ntiles || !kTwoPass) {  // online max and sum (f32, bf16 pass 1)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // every tile holds a key < Lk with a finite score, so mn is finite
        const float mn = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = exp2f(m[r] - mn);  // 0 on the first tile (m = -inf)
        l[r] *= corr[r];
        m[r] = mn;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = exp2f(s[n][c] - m[c >> 1]);  // 0 for keys past Lk
          l[c >> 1] += s[n][c];
        }
      }
      if (kTwoPass) {
        if (it + 1 == ntiles) {  // end of pass 1: the rows' sums are final
          inv[0] = 1.f / quad_sum(l[0]);
          inv[1] = 1.f / quad_sum(l[1]);
        }
        continue;
      }
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    } else {  // bf16 pass 2: p = exp(s - m) / l, rounded as the bf16 A operand
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = exp2f(s[n][c] - m[c >> 1]) * inv[c >> 1];
      }
    }
    accumulate_pv<T, DP>(acc, s, Vs + st * TK * LD, g, t, lane);
  }

  // f32 divides by the row sums here; bf16's p already held them
  if (kTwoPass) {
    inv[0] = inv[1] = 1.f;
  } else {
    inv[0] = 1.f / quad_sum(l[0]);
    inv[1] = 1.f / quad_sum(l[1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= Lq) continue;
    T* op = o + ((size_t)bh * Lq + qi) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D) op[d] = from_f<T>(acc[n][2 * r] * inv[r]);
      if (d + 1 < D) op[d + 1] = from_f<T>(acc[n][2 * r + 1] * inv[r]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch_dp(const T* q, const T* k, const T* v, const float* bias, T* o, int B,
                      int H, int Lq, int Lk, int D, float scale, bool vec,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Lq + ROWS - 1) / ROWS, B * H);
  attn_fwd<T, DP><<<grid, THREADS, smem, stream>>>(q, k, v, bias, o, H, Lq, Lk, D,
                                                   scale * LOG2E, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* o, int B, int H, int Lq, int Lk, int D, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  const bool vec = D % Cfg<T>::VEC == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  constexpr bool f32 = std::is_same<T, float>::value;
  if (D <= 64) return launch_dp<T, 64>(qt, kt, vt, bias, ot, B, H, Lq, Lk, D, scale, vec, stream);
  if (D <= (f32 ? 72 : 80)) {
    return launch_dp<T, f32 ? 72 : 80>(qt, kt, vt, bias, ot, B, H, Lq, Lk, D, scale, vec,
                                       stream);
  }
  return launch_dp<T, 128>(qt, kt, vt, bias, ot, B, H, Lq, Lk, D, scale, vec, stream);
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
