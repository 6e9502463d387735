// merge_ops.cu -- Hopper (sm_90a) kernels of the merge operators' column
// reductions.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/merge_ops.py:
//   weighted_colmerge <- weighted_colmerge (_weighted_kernel)
//   ties_colmerge     <- ties_colmerge     (_ties_kernel)
// Both reduce an (m, D) row-major float32 panel over its m rows (agents)
// into one (D,) float32 row, column by column:
//
//   weighted: out_j = sum_k w_kj x_kj / sum_k w_kj   (var and fisher merges;
//             the caller folds its eps into w, so the sum is positive)
//   ties:     tk = |t_kj| >= th_k ? t_kj : 0; s = sum_k tk >= 0 ? + : -;
//             out_j = mean of the tk that agree with s (tk * s > 0), or 0
//             where none does (the TIES merge body on deviations t)
//
// The m per-row TIES thresholds are computed by the caller outside the
// kernel (kernels/ref.py:ties_thresh_ref, a row quantile), as in the
// reference.
//
// What bounds them: bytes. m is small (8 on the main path) and D is the
// whole model (237.5 M columns for olmo-1b cut to two layers). weighted
// reads 8 bytes per element (x and w) for 3 operations; ties reads 4 bytes
// per element for about 8. Both are far under the H100's ~20 float32
// operations per byte of memory traffic, so their least time is their
// bytes (inputs read once, the row written once) over the memory rate.
//
// What the design does about it: every input byte is read from device
// memory once. A thread owns VEC consecutive columns (VEC = 4 when
// D % 4 == 0 and the pointers are 16-byte aligned: float4 loads and
// stores; else one column), in a grid-stride loop whose bound masks the
// ragged edge (nothing is padded; the TPU versions pad D to their block).
//   weighted streams over k in chunks of kChunk rows: all loads of a chunk
//     (2 * kChunk 16-byte loads) are started before its sums, so several
//     loads are in flight per thread, and nothing of a row is kept.
//   ties needs every value of a column twice (the elected sign first, then
//     the agreeing mean): the thread loads its m trimmed values once into
//     registers (m bounded by a template bucket, 8 / 16 / 32) and takes both
//     passes from there; reading tau again would double its bytes. The m
//     thresholds sit in shared memory.
//
// Numerics, bit for bit with the plain versions (kernels/ref.py): sums over
// k in fixed order from k = 0 with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into fused multiply-adds), one
// IEEE division (__fdiv_rn) at the end. Build without --use_fast_math.
//
// C interface for ctypes. The kernels allocate nothing and launch on the
// stream they are given; each entry point returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;
constexpr int kMaxRows = 32;
constexpr int kChunk = 8;

__device__ __forceinline__ void load_cols(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load_cols(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void store_cols(float* p, const float (&v)[1]) {
  p[0] = v[0];
}
__device__ __forceinline__ void store_cols(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    weighted_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int m, long long D) {
  const long long groups = D / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long col = g * VEC;
    float num[VEC], den[VEC];
    for (int k0 = 0; k0 < m; k0 += kChunk) {
      float xv[kChunk][VEC], wv[kChunk][VEC];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (k0 + i < m) {
          load_cols(x + (long long)(k0 + i) * D + col, xv[i]);
          load_cols(w + (long long)(k0 + i) * D + col, wv[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (k0 + i < m) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float p = __fmul_rn(wv[i][v], xv[i][v]);
            if (k0 + i == 0) {
              num[v] = p;
              den[v] = wv[i][v];
            } else {
              num[v] = __fadd_rn(num[v], p);
              den[v] = __fadd_rn(den[v], wv[i][v]);
            }
          }
        }
      }
    }
    float o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) o[v] = __fdiv_rn(num[v], den[v]);
    store_cols(out + col, o);
  }
}

template <int MAXM, int VEC>
__global__ void __launch_bounds__(kThreads)
    ties_kernel(const float* __restrict__ tau,
                const float* __restrict__ thresh, float* __restrict__ out,
                int m, long long D) {
  __shared__ float th_s[MAXM];
  for (int i = threadIdx.x; i < m; i += blockDim.x) th_s[i] = thresh[i];
  __syncthreads();

  const long long groups = D / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long col = g * VEC;
    float t[MAXM][VEC];
#pragma unroll
    for (int k = 0; k < MAXM; ++k) {
      if (k < m) load_cols(tau + (long long)k * D + col, t[k]);
    }
    // trim (entries below the row's threshold become +0) and the column sum
    float colsum[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) colsum[v] = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXM; ++k) {
      if (k < m) {
        const float th = th_s[k];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          t[k][v] = fabsf(t[k][v]) >= th ? t[k][v] : 0.0f;
          colsum[v] = k == 0 ? t[k][v] : __fadd_rn(colsum[v], t[k][v]);
        }
      }
    }
    // the elected sign (a sum of 0 elects +), then the agreeing mean
    float o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const bool up = colsum[v] >= 0.0f;
      float cnt = 0.0f, dev = 0.0f;
#pragma unroll
      for (int k = 0; k < MAXM; ++k) {
        if (k < m) {
          const float tk = t[k][v];
          const bool agree = up ? tk > 0.0f : tk < 0.0f;
          cnt = __fadd_rn(cnt, agree ? 1.0f : 0.0f);
          dev = __fadd_rn(dev, agree ? tk : 0.0f);
        }
      }
      o[v] = cnt > 0.0f ? __fdiv_rn(dev, fmaxf(cnt, 1.0f)) : 0.0f;
    }
    store_cols(out + col, o);
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

unsigned grid_for(long long groups) {
  long long blocks = (groups + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <int MAXM>
cudaError_t launch_ties(const float* tau, const float* thresh, float* out,
                        int m, long long D, cudaStream_t stream) {
  if (D % 4 == 0 && aligned(tau) && aligned(out)) {
    ties_kernel<MAXM, 4><<<grid_for(D / 4), kThreads, 0, stream>>>(
        tau, thresh, out, m, D);
  } else {
    ties_kernel<MAXM, 1><<<grid_for(D), kThreads, 0, stream>>>(
        tau, thresh, out, m, D);
  }
  return cudaGetLastError();
}

}  // namespace

// x, w (m, D) f32 -> out (D,) f32: sum_k w x / sum_k w per column
extern "C" int weighted_colmerge_f32(const void* x, const void* w, void* out,
                                     int m, long long D, void* stream) {
  if (m < 1 || m > kMaxRows || D < 1) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(xp) && aligned(wp) && aligned(o)) {
    weighted_kernel<4><<<grid_for(D / 4), kThreads, 0, s>>>(xp, wp, o, m, D);
  } else {
    weighted_kernel<1><<<grid_for(D), kThreads, 0, s>>>(xp, wp, o, m, D);
  }
  return (int)cudaGetLastError();
}

// tau (m, D) f32, thresh (m,) f32 -> out (D,) f32: the TIES column merge
extern "C" int ties_colmerge_f32(const void* tau, const void* thresh,
                                 void* out, int m, long long D,
                                 void* stream) {
  if (m < 1 || m > kMaxRows || D < 1) return (int)cudaErrorInvalidValue;
  const float* t = static_cast<const float*>(tau);
  const float* th = static_cast<const float*>(thresh);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 8) return (int)launch_ties<8>(t, th, o, m, D, s);
  if (m <= 16) return (int)launch_ties<16>(t, th, o, m, D, s);
  return (int)launch_ties<32>(t, th, o, m, D, s);
}
