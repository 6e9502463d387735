// flash_common.cuh -- what the flash attention libraries share: the
// strides, the visibility rule, 16-byte cp.async copies, the bitmaps of
// the tiles to skip, the backward's row sums (delta_kernel) and its
// reduction of dK/dV's partial sums over parts of the heads
// (dkdv_reduce_kernel), outputs rounded once to their type, and the host
// side's launch preparation and occupancy report. flash_attention.cu (the
// float32 kernels) and flash_attention16.cu (the bfloat16 and float16
// kernels) include it.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // 4 warps
constexpr int kRows = 64;             // a block's own rows: 16 a warp
constexpr int kDeltaThreads = 256;    // delta_kernel: a warp a row
constexpr float kNegInf = -1e30f;

struct Strides {  // element strides of a (B, S, heads, hd) tensor
  long long b, s, h;
};

// two consecutive outputs, each rounded once to the output's type
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}
__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float as_float(__half x) { return __half2float(x); }

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (window <= 0 || (long long)kp > (long long)qp - window);
}

// ---- asynchronous copies -------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight (a
// barrier then makes every thread's copies visible)
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// n values src[i0 + i] (i < n, i0 + i < S; else 0) -> dst[i], by threads
// lo .. lo + n - 1, 4-byte cp.async
__device__ __forceinline__ void load_vals(void* dst, const void* src, int lo,
                                          int n, int i0, int S) {
  const int i = (int)threadIdx.x - lo;
  if (i >= 0 && i < n) {
    const bool ok = i0 + i < S;
    cp4(static_cast<int*>(dst) + i,
        static_cast<const int*>(src) + (ok ? i0 + i : i0), ok);
  }
}

// ---- tiles to skip -------------------------------------------------------

// min and max of pos[r] over r < n with pos[r] >= 0 (all of them when
// !only_valid), into out[0], out[1]; INT_MAX / INT_MIN when there is none.
// Called by every thread; ends with a barrier.
__device__ __forceinline__ void pos_range(const int* pos, int n,
                                          bool only_valid, int* out) {
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = threadIdx.x; r < n; r += 32) {
      if (!only_valid || pos[r] >= 0) {
        lo = min(lo, pos[r]);
        hi = max(hi, pos[r]);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (threadIdx.x == 0) {
      out[0] = lo;
      out[1] = hi;
    }
  }
  __syncthreads();
}

__host__ __device__ constexpr int bitmap_words(int tiles) {
  return (tiles + 31) / 32;
}

// Bitmaps of the tiles (TILE indices each) along the streamed axis, from
// the positions pos[j], j < n: bit i of live is set iff tile i holds some
// j with live_ok(pos[j]) (a necessary condition for a visible pair in the
// tile); bit i of part iff some j of tile i fails full_ok(pos[j]) (every
// pair of j with the block's own rows visible), so a live tile without a
// part bit needs no mask (a tile past n must be tested apart). Each warp
// reads 32 consecutive positions, one tile's. Called by every one of the
// block's NTH threads; ends with a barrier.
template <int TILE, int NTH = kThreads, typename Live, typename Full>
__device__ __forceinline__ void mark_tiles(unsigned* live, unsigned* part,
                                           int tiles, const int* pos, int n,
                                           Live live_ok, Full full_ok) {
  static_assert(TILE % 32 == 0, "a warp's 32 positions lie in one tile");
  for (int i = threadIdx.x; i < bitmap_words(tiles); i += NTH)
    live[i] = part[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j0 = (int)threadIdx.x - lane; j0 < n; j0 += NTH) {
    const int j = j0 + lane;
    const int x = j < n ? pos[j] : 0;
    const bool hit = __any_sync(0xffffffffu, j < n && live_ok(x));
    const bool all = __all_sync(0xffffffffu, j < n && full_ok(x));
    if (lane == 0) {
      const int word = j0 / TILE / 32;
      const unsigned bit = 1u << (j0 / TILE % 32);
      if (hit) atomicOr(live + word, bit);
      if (!all) atomicOr(part + word, bit);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool bit_set(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// the first live tile at or after i, or tiles
__device__ __forceinline__ int next_live(const unsigned* live, int i,
                                         int tiles) {
  while (i < tiles) {
    const unsigned w = live[i >> 5] >> (i & 31);
    if (w) return i + __ffs(w) - 1;
    i = (i | 31) + 1;
  }
  return tiles;
}

// delta[b, h, i] = sum_c dO[b, i, h, c] O[b, i, h, c]: a warp a row, the
// lanes' partial sums reduced in a fixed order (float32 sums of the
// inputs' type's values)
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int H, int Sq, int hd,
                 long long rows, Strides so, Strides sdo) {
  const long long row = (long long)blockIdx.x * (kDeltaThreads / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % Sq);
  const int h = (int)((row / Sq) % H);
  const int b = (int)(row / ((long long)Sq * H));
  const T* orow = o + b * so.b + (long long)i * so.s + h * so.h;
  const T* drow = dout + b * sdo.b + (long long)i * sdo.s + h * sdo.h;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32)
    acc = fmaf(as_float(drow[c]), as_float(orow[c]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// dK = scale (ws[0, 0] + ws[1, 0] + ...), dV = ws[0, 1] + ws[1, 1] + ...:
// the parts added in ascending order in float32, a thread four consecutive
// columns, each output rounded once to T
template <int HD, typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    dkdv_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dk,
                       T* __restrict__ dv, int parts, int Sk, int Kv,
                       long long plane, float scale, Strides sdk,
                       Strides sdv) {
  const long long n = plane / 4;  // float4s of one of dK, dV
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  for (long long i = (long long)blockIdx.x * kDeltaThreads + threadIdx.x;
       i < 2 * n; i += (long long)gridDim.x * kDeltaThreads) {
    const int which = i >= n;  // 0: dK, 1: dV
    const long long j = i - which * n, e = 4 * j;
    float4 a = w4[which * n + j];
    for (int p = 1; p < parts; ++p) {
      const float4 x = w4[(2 * p + which) * n + j];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const int c = (int)(e % HD);
    const long long row = e / HD;  // (b, s, kv head)
    const int kvh = (int)(row % Kv), s = (int)(row / Kv % Sk);
    const int b = (int)(row / Kv / Sk);
    T* out = which ? dv + b * sdv.b + (long long)s * sdv.s + kvh * sdv.h + c
                   : dk + b * sdk.b + (long long)s * sdk.s + kvh * sdk.h + c;
    const float f = which ? 1.f : scale;
    store2(out, a.x * f, a.y * f);
    store2(out + 2, a.z * f, a.w * f);
  }
}

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared memory above 48 KB, and the SM's carve-out at its most, so that
// two blocks fit an SM
template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// blocks per SM, dynamic shared memory, registers and local (spill) bytes
// of one kernel, and its threads a block: res[0..4]
template <typename K>
cudaError_t resources_of(K kernel, size_t bytes, int* res,
                         int threads = kThreads) {
  cudaError_t e = prepare(kernel, bytes);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  if ((e = cudaFuncGetAttributes(&a, kernel)) != cudaSuccess) return e;
  res[1] = (int)bytes;
  res[2] = a.numRegs;
  res[3] = (int)a.localSizeBytes;
  res[4] = threads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(res, kernel, threads,
                                                       bytes);
}

bool shape_ok(int B, int H, int Kv, int Sq, int Sk) {
  return B >= 1 && H >= 1 && Kv >= 1 && H % Kv == 0 && Sq >= 1 && Sk >= 1 &&
         B <= 65535 && H <= 65535 &&
         (long long)cdiv(Sq, kRows) * H * B <= INT_MAX &&
         (long long)cdiv(Sk, kRows) * Kv * B <= INT_MAX;
}

}  // namespace
