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
// f32: bound by arithmetic.  In f32 every product runs as three TF32
// tensor-core products (3xTF32, mma_tf32.cuh), so the bound is
// 3 * flops / 495 TFLOP/s.
//
// Design: a fused implicit GEMM on warp-level mma.sync.
//   - A block owns TL = 64 output rows and 128 of the C output channels.  A
//     thread-block cluster of C / 128 blocks (1, 2, 4 for C = 128, 256, 512)
//     shares one row tile: block r computes channels [128 r, 128 r + 128) of
//     G = snake2(conv7 + b7), so it streams only its 128-column slab of w7,
//     and at C = 512, L = 5 000 the grid has 79 x 4 = 316 blocks.
//   - conv7: for each 32-channel chunk of the input, the (TL + 6d)-row x
//     window arrives by cp.async during the previous chunk's taps (rows
//     outside [0, L) are the zero padding); snake1 of it is computed once
//     into an operand window in shared memory (already split into TF32
//     hi/lo for f32, rounded to bf16 for bf16); then the 7 taps are
//     (TL, 32) @ (32, 128) products on that window shifted by j*d rows,
//     summed by the MMAs per chunk and across chunks in f32 registers.  The
//     w7 tiles, and after them the w1 tiles, stream through a cp.async
//     double buffer, one __syncthreads per tile.  Eight warps side by side
//     each own 16 of the 128 columns over all 64 rows (4 x 2 m16n8
//     fragments): every weight element is split into hi/lo once per block,
//     and A fragments come from ldmatrix.  At d = 9 a block takes ~103 KB
//     of shared memory and at most 128 registers a thread, so two blocks
//     (16 warps) share an SM.
//   - b7 and snake2 are applied to the accumulator and the block's (TL, 128)
//     slice of G is kept in shared memory.
//   - the 1x1 needs all C channels of G: after cluster.sync() each block
//     copies the 32-channel chunks of G from their owner's shared memory
//     (distributed shared memory, map_shared_rank) into its operand buffer
//     and computes its 128 output channels of G @ W1 + b1 + x.  A second
//     cluster.sync() keeps every block's G alive until its peers are done.
// Windows overlap by the 6d halo rows, so tile seams are exact.  bf16 inputs
// are rounded to bf16 where the Pallas kernel casts (after snake1 and after
// snake2), here by the operand type of the bf16 MMAs; all sums are f32.
// Launched with cudaLaunchKernelEx and a cluster dimension.  Forward only.
//
// C interface (ctypes): ez_resunit_fwd returns the cudaError_t of the
// launch; 0 is success, cudaErrorInvalidValue a shape the kernel does not
// take (C not a multiple of 128 or above 1024, a window beyond shared
// memory, misaligned pointers).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ezk;

constexpr int TL = 64;        // output rows per block
constexpr int NB = 128;       // output channels per block
constexpr int KC = 32;        // input-channel chunk
constexpr int WN = 16;        // output channels per warp: 2 m16n8 column tiles
constexpr int NTW = WN / 8;
constexpr int MT = TL / 16;   // a warp holds all TL rows: 4 m16 row tiles
constexpr int THREADS = 32 * (NB / WN);  // 8 warps side by side over the 128 channels
constexpr int MAX_CLUSTER = 8;
static_assert(THREADS % (KC / 4) == 0, "snake1 staging keeps a thread on its 4 channels");
constexpr int GP = NB + 4;    // row stride of G (f32)
constexpr int WP = NB + 8;    // row stride of a weight tile: conflict-free B fragments

template <typename T> struct Cfg;
// The operand window: f32 as TF32 hi and lo planes (u32), bf16 as bf16.
template <> struct Cfg<float> {
  static constexpr int AP = KC + 4;  // row stride, in u32
  static constexpr int PLANES = 2;
  static constexpr int ESZ = 4;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int AP = KC + 8;  // row stride, in bf16
  static constexpr int PLANES = 1;
  static constexpr int ESZ = 2;
};

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

// snake with inv_b = 1 / (b + 1e-9) computed by the caller
__device__ __forceinline__ float snake(float x, float a, float inv_b) {
  const float s = sinf(x * a);
  return x + inv_b * (s * s);
}

// Four consecutive elements of a row, as floats.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// Four operand values into row r, columns c..c+3 of the operand window.
template <typename T>
__device__ __forceinline__ void store_operand4(unsigned char* A, int plane_elems, int r, int c,
                                               const float* v) {
  constexpr int AP = Cfg<T>::AP;
  if constexpr (std::is_same<T, float>::value) {
    uint4 hi, lo;
    split_tf32(v[0], hi.x, lo.x);
    split_tf32(v[1], hi.y, lo.y);
    split_tf32(v[2], hi.z, lo.z);
    split_tf32(v[3], hi.w, lo.w);
    uint32_t* Ahi = reinterpret_cast<uint32_t*>(A);
    *reinterpret_cast<uint4*>(Ahi + r * AP + c) = hi;
    *reinterpret_cast<uint4*>(Ahi + plane_elems + r * AP + c) = lo;
  } else {
    uint2 p;
    p.x = pack_bf16(v[0], v[1]);
    p.y = pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(reinterpret_cast<T*>(A) + r * AP + c) = p;
  }
}

// acc += window[row_off + rows, 0:KC] @ Wt[0:KC, 0:128] for this warp's
// (TL, WN) part of the (TL, 128) output.  Each warp owns its WN weight
// columns, so every weight element is split once per block.
template <typename T>
__device__ __forceinline__ void mma_chunk(float (*acc)[NTW][4], const unsigned char* A,
                                          int plane_elems, const T* Wt, int row_off,
                                          int wn, int g, int t, int lane) {
  constexpr int AP = Cfg<T>::AP;
  // this lane's row address for ldmatrix_a: rows 0-7 / 8-15, then 16 bytes on
  const int lrow = row_off + (lane & 7) + ((lane >> 3) & 1) * 8;
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t* Ahi = reinterpret_cast<const uint32_t*>(A) + lrow * AP + (lane >> 4) * 4;
    const uint32_t* Alo = Ahi + plane_elems;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      uint32_t bhi[NTW][2], blo[NTW][2];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const float* wr = Wt + (kk * 8 + t) * WP + wn * WN + nt * 8 + g;
        split_tf32(wr[0], bhi[nt][0], blo[nt][0]);
        split_tf32(wr[4 * WP], bhi[nt][1], blo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ahi[4], alo[4];
        ldmatrix_a(ahi, Ahi + mt * 16 * AP + kk * 8);
        ldmatrix_a(alo, Alo + mt * 16 * AP + kk * 8);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma3xtf32(acc[mt][nt], ahi, alo, bhi[nt], blo[nt]);
      }
    }
  } else {
    const T* Ab = reinterpret_cast<const T*>(A) + lrow * AP + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t b[NTW][2];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        ldmatrix_b_trans(b[nt], Wt + kk * 16 * WP + wn * WN + nt * 8, WP, lane);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_a(a, Ab + mt * 16 * AP + kk * 16);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
  }
}

// Shared memory: [G slice (TL, GP) f32, or during conv7 the raw x window
// (win, KC)] [operand window, PLANES x (win, AP)] [2 weight tiles (KC, WP)].
template <typename T>
__host__ __device__ size_t head_bytes(size_t win) {
  const size_t g = sizeof(float) * TL * GP, xw = sizeof(T) * win * KC;
  return ((g > xw ? g : xw) + 15) / 16 * 16;
}

template <typename T>
size_t smem_bytes(int d) {
  const size_t win = TL + 6 * (size_t)d;
  return head_bytes<T>(win)
       + (size_t)Cfg<T>::PLANES * win * Cfg<T>::AP * Cfg<T>::ESZ
       + 2 * (size_t)KC * WP * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
resunit_fwd(const T* __restrict__ x, const T* __restrict__ w7, const T* __restrict__ b7,
            const T* __restrict__ w1, const T* __restrict__ b1,
            const float* __restrict__ ab, T* __restrict__ y, int L, int C, int d) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int win = TL + 6 * d;
  const int plane = win * Cfg<T>::AP;  // elements of one operand plane
  float* G = reinterpret_cast<float*>(smem_raw);  // [TL][GP]: this block's G slice
  T* X = reinterpret_cast<T*>(smem_raw);          // [win][KC]: x, until G is written
  unsigned char* A = smem_raw + head_bytes<T>(win);  // operand window
  T* W = reinterpret_cast<T*>(A + Cfg<T>::PLANES * plane * Cfg<T>::ESZ);  // [2][KC][WP]

  const int cs = C / NB;
  const int rank = (int)cluster.block_rank();
  const int nbase = rank * NB;
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x / cs) * TL;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wn = warp;  // this warp's WN-column slice of the block's 128
  const T* xb = x + (size_t)b * L * C;
  const float* a1 = ab;
  const float* be1 = ab + C;
  const float* a2 = ab + 2 * C;
  const float* be2 = ab + 3 * C;

  // Weight tiles in order: w7 (chunk c, tap j) at s = 7c + j, then w1
  // (chunk c) at s = 7 * nch + c; each (KC, 128) from the block's slab.
  const int nch = C / KC;
  const int nconv = 7 * nch, total = 8 * nch;
  auto load_w = [&](int s) {
    const T* src;
    if (s < nconv) {
      const int c = s / 7, j = s - 7 * c;
      src = w7 + ((size_t)j * C + (size_t)c * KC) * C + nbase;
    } else {
      src = w1 + (size_t)(s - nconv) * KC * C + nbase;
    }
    T* dst = W + (s & 1) * KC * WP;
    constexpr int V = 16 / sizeof(T), CPR = NB / V;
    for (int idx = tid; idx < KC * CPR; idx += THREADS) {
      const int r = idx / CPR, c = (idx - r * CPR) * V;
      cp_async16(dst + r * WP + c, src + (size_t)r * C + c, true);
    }
  };

  // x rows t0 - 3d .. t0 + TL + 3d, channels of chunk c; zero outside [0, L)
  auto load_x = [&](int c) {
    constexpr int V = 16 / sizeof(T), CPR = KC / V;
    for (int idx = tid; idx < win * CPR; idx += THREADS) {
      const int r = idx / CPR, cc = (idx - r * CPR) * V;
      const int tg = t0 - 3 * d + r;
      const bool in = tg >= 0 && tg < L;
      cp_async16(X + r * KC + cc, in ? xb + (size_t)tg * C + c * KC + cc : xb, in);
    }
  };

  // part: the MMA sum over one input chunk (7 taps, or one 1x1 tile);
  // acc: the f32 sum of the parts (see mma_tf32.cuh on MMA accumulation).
  float acc[MT][NTW][4], part[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = part[mt][nt][e] = 0.f;
    }
  }

  load_x(0);
  load_w(0);
  cp_async_commit();
  for (int s = 0; s < total; ++s) {
    const bool conv = s < nconv;
    const int c = conv ? s / 7 : s - nconv;
    const int j = conv ? s - 7 * c : 0;
    if (s == nconv) {
      // G slice = snake2(conv7 + b7), rounded to the operand type
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * 16 + g + 8 * (e >> 1);
            const int col = wn * WN + nt * 8 + 2 * t + (e & 1);
            const int ch = nbase + col;
            G[row * GP + col] =
                round_to<T>(snake(acc[mt][nt][e] + to_f(b7[ch]), a2[ch],
                                  1.0f / (be2[ch] + 1e-9f)));
            acc[mt][nt][e] = 0.f;
          }
        }
      }
      cluster.sync();  // every G slice of the cluster complete and visible
    }
    cp_async_wait_all();
    __syncthreads();  // tile s visible; every warp is done with tile s - 1
    if (s + 1 < total) {
      load_w(s + 1);
      cp_async_commit();
    }
    if (j == 0) {  // a new input chunk: stage its operand window
      const int k0 = c * KC;
      if (conv) {  // snake1 of the staged x window (snake(0) = 0 keeps the padding)
        // THREADS is a multiple of KC / 4, so a thread keeps its 4 channels
        const int c4 = (tid % (KC / 4)) * 4;
        float sa[4], sb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sa[e] = a1[k0 + c4 + e];
          sb[e] = 1.0f / (be1[k0 + c4 + e] + 1e-9f);
        }
        for (int r = tid / (KC / 4); r < win; r += THREADS / (KC / 4)) {
          float v[4];
          load4(X + r * KC + c4, v);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = round_to<T>(snake(v[e], sa[e], sb[e]));
          store_operand4<T>(A, plane, r, c4, v);
        }
      } else {  // G[:, k0:k0+KC] from the block that owns those channels
        const float* src = cluster.map_shared_rank(G, k0 / NB) + k0 % NB;
        for (int idx = tid; idx < TL * (KC / 4); idx += THREADS) {
          const int r = idx / (KC / 4), c4 = (idx - r * (KC / 4)) * 4;
          float v[4];
          load4(src + r * GP + c4, v);
          store_operand4<T>(A, plane, r, c4, v);
        }
      }
      __syncthreads();  // operand window ready; X consumed
      if (conv && c + 1 < nch) {  // the next chunk's x, in flight during these taps
        load_x(c + 1);
        cp_async_commit();
      }
    }
    mma_chunk<T>(part, A, plane, W + (s & 1) * KC * WP, conv ? j * d : 0, wn, g, t, lane);
    if (!conv || j == 6) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nt][e] += part[mt][nt][e];
            part[mt][nt][e] = 0.f;
          }
        }
      }
    }
  }

  // y = x + (G @ W1 + b1) for this block's 128 channels
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tg = t0 + mt * 16 + g + 8 * h;
      if (tg >= L) continue;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int ch = nbase + wn * WN + nt * 8 + 2 * t;
        const size_t off = (size_t)b * L * C + (size_t)tg * C + ch;
        y[off] = from_f<T>(to_f(x[off]) + (acc[mt][nt][2 * h] + to_f(b1[ch])));
        y[off + 1] = from_f<T>(to_f(x[off + 1]) + (acc[mt][nt][2 * h + 1] + to_f(b1[ch + 1])));
      }
    }
  }
  cluster.sync();  // peers may still be reading this block's G
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* w7, const void* b7, const void* w1,
                   const void* b1, const float* ab, void* y, int B, int L, int C,
                   int d, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(d);
  // Raise the kernel's dynamic shared-memory limit only when a dilation
  // needs more than has been granted, so that a launch recorded into a CUDA
  // graph (after an eager warm-up at the same shapes) makes no attribute
  // call.  One card per process: the attribute is per device.
  static std::atomic<size_t> granted{0};
  cudaError_t err = cudaSuccess;
  if (smem > granted.load()) {
    err = cudaFuncSetAttribute(resunit_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    size_t prev = granted.load();
    while (smem > prev && !granted.compare_exchange_weak(prev, smem)) {
    }
  }
  const int cs = C / NB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((L + TL - 1) / TL) * cs, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, resunit_fwd<T>, static_cast<const T*>(x),
                           static_cast<const T*>(w7), static_cast<const T*>(b7),
                           static_cast<const T*>(w1), static_cast<const T*>(b1), ab,
                           static_cast<T*>(y), L, C, d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, y (B, L, C); w7 (7, C, C) as (tap, in, out); b7, b1 (C,); w1 (C, C) as
// (in, out); all contiguous, 16-byte aligned and of one type (dtype 0 =
// float32, 1 = bfloat16).  ab (4, C) float32: exp'd alpha1, beta1, alpha2,
// beta2.  C a multiple of 128 up to 1024 (a cluster of at most 8 blocks);
// the (TL + 6d)-row window must fit shared memory.
extern "C" int ez_resunit_fwd(const void* x, const void* w7, const void* b7,
                              const void* w1, const void* b1, const float* ab,
                              void* y, int B, int L, int C, int d, int dtype,
                              void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || C <= 0 || C % NB != 0 || C / NB > MAX_CLUSTER ||
      d <= 0 || (dtype != 0 && dtype != 1) || !aligned16(x) || !aligned16(w7) ||
      !aligned16(w1) || !aligned16(y) ||
      (dtype == 0 ? smem_bytes<float>(d) : smem_bytes<__nv_bfloat16>(d)) > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch<float>(x, w7, b7, w1, b1, ab, y, B, L, C, d, s)
      : launch<__nv_bfloat16>(x, w7, b7, w1, b1, ab, y, B, L, C, d, s);
  return (int)err;
}
