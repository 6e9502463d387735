// panel_reduce.cu -- Hopper (sm_90a) kernels for the panel statistics:
// the column mean of an (m, D) panel (float32, bfloat16 or float16; each
// value widened exactly to float32) and its total squared deviation
// sum_{k,j} (theta[k,j] - mean[j])^2 (= m * Xi^2, Xi the consensus distance).
//
// Replaces the Pallas TPU kernel panel_mean_consensus
// (src/repro/kernels/panel_reduce.py, body _reduce_kernel). That kernel adds
// into one scalar across grid steps, which is safe only because a TPU grid
// runs in order. CUDA blocks run concurrently and in no order, so here:
//   pass 1 (mean_sq_kernel): each block writes the column means of the
//     columns it visits and ONE partial sum of squares, into its own slot;
//   pass 2 (sum_partials_kernel, one block): sums the partials in a fixed
//     order and writes the scalar.
// No float atomics: the result is the same on every run.
//
// What bounds it: bytes. Pass 1 reads the panel once (4*m*D bytes, 2*m*D
// for a 16-bit panel) and writes the float32 mean (4*D); it does about 3 operations per element read, far
// under the H100's float32 flops per byte. Pass 2 touches a few KB. The
// least time is (itemsize*m*D + 4*D) bytes over the memory rate.
//
// What the design does about it: each element is read from memory once. A
// thread owns VEC consecutive columns (16-byte float4 loads, or 8-byte loads
// of four 16-bit values, when D is a multiple of 4 and the pointers are
// aligned, else one column),
// holds its m values in registers, forms the mean (a fixed-order float32 sum
// over k divided by m, exactly as kernels/ref.py:panel_mean_consensus_ref)
// and accumulates the squared deviations from the same registers. Blocks
// walk D in a grid-stride loop whose bound masks the ragged edge.
//
// Numerics: each deviation is rounded to float32 (as in the reference),
// then squared and accumulated in float64 per thread, per block (a fixed
// tree) and across blocks (fixed order), and rounded once to float32. The
// float64 work is a few operations per element on a memory-bound pass; it
// keeps the sum of squares of a 1.9 G-element panel accurate to float32
// rounding whatever the grid size.
//
// C interface for ctypes. The kernels allocate nothing (the caller passes
// the float64 partials buffer, panel_reduce_partials(D) slots) and launch on
// the stream given; the entry point returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

// bfloat16 and float16 travel as their 16 bits; widening is exact
struct bf16_t {
  uint16_t bits;
};
struct f16_t {
  uint16_t bits;
};

__device__ __forceinline__ float widen_lo(const bf16_t*, uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float widen_hi(const bf16_t*, uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ float widen_lo(const f16_t*, uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xFFFFu)));
}
__device__ __forceinline__ float widen_hi(const f16_t*, uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// load VEC consecutive columns as float32
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
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&v)[1]) {
  v[0] = widen_lo(p, __ldg(reinterpret_cast<const unsigned short*>(p)));
}
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = widen_lo(p, x.x);  // the lower address is the low half
  v[1] = widen_hi(p, x.x);
  v[2] = widen_lo(p, x.y);
  v[3] = widen_hi(p, x.y);
}

__device__ __forceinline__ void store_cols(float* p, const float (&v)[1]) {
  p[0] = v[0];
}
__device__ __forceinline__ void store_cols(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ double block_sum(double x, double* red) {
  red[threadIdx.x] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = __dadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  return red[0];
}

template <int MAXM, int VEC, typename T>
__global__ void __launch_bounds__(kThreads)
    mean_sq_kernel(const T* __restrict__ theta, float* __restrict__ mean,
                   double* __restrict__ partial, int m, long long D) {
  __shared__ double red[kThreads];
  const float fm = (float)m;
  double local = 0.0;
  const long long groups = D / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long col = g * VEC;
    float t[MAXM][VEC];
#pragma unroll
    for (int k = 0; k < MAXM; ++k) {
      if (k < m) load_cols(theta + (long long)k * D + col, t[k]);
    }
    float mu[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) mu[v] = t[0][v];
#pragma unroll
    for (int k = 1; k < MAXM; ++k) {
      if (k < m) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) mu[v] = __fadd_rn(mu[v], t[k][v]);
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) mu[v] = __fdiv_rn(mu[v], fm);
    store_cols(mean + col, mu);
#pragma unroll
    for (int k = 0; k < MAXM; ++k) {
      if (k < m) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const double d = (double)__fsub_rn(t[k][v], mu[v]);
          local = __dadd_rn(local, __dmul_rn(d, d));
        }
      }
    }
  }
  const double total = block_sum(local, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const double* __restrict__ partial, int nparts,
                        float* __restrict__ out) {
  __shared__ double red[kThreads];
  double local = 0.0;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x)
    local = __dadd_rn(local, partial[i]);
  const double total = block_sum(local, red);
  if (threadIdx.x == 0) out[0] = __double2float_rn(total);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

long long num_partials(long long D) {
  long long blocks = (D + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

template <int MAXM, typename T>
cudaError_t launch(const T* theta, float* mean, double* partial,
                   int nparts, float* sq, int m, long long D,
                   cudaStream_t stream) {
  // four columns of a row: 16 bytes of float32 or 8 bytes of bf16 / f16
  const bool vec = (D % 4 == 0) && aligned(theta, 4 * sizeof(T)) &&
                   aligned(mean, 16);
  if (vec) {
    mean_sq_kernel<MAXM, 4, T><<<nparts, kThreads, 0, stream>>>(
        theta, mean, partial, m, D);
  } else {
    mean_sq_kernel<MAXM, 1, T><<<nparts, kThreads, 0, stream>>>(
        theta, mean, partial, m, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partial, nparts, sq);
  return cudaGetLastError();
}

template <typename T>
int reduce(const void* theta, void* mean, void* partial, int nparts,
           void* sq, int m, long long D, void* stream) {
  if (m < 1 || m > 32 || D < 1 || nparts != num_partials(D))
    return (int)cudaErrorInvalidValue;
  const T* t = static_cast<const T*>(theta);
  float* mu = static_cast<float*>(mean);
  double* part = static_cast<double*>(partial);
  float* out = static_cast<float*>(sq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 8) return (int)launch<8>(t, mu, part, nparts, out, m, D, s);
  if (m <= 16) return (int)launch<16>(t, mu, part, nparts, out, m, D, s);
  return (int)launch<32>(t, mu, part, nparts, out, m, D, s);
}

}  // namespace

extern "C" long long panel_reduce_partials(long long D) {
  return num_partials(D);
}

// theta (m, D) f32 / bf16 / f16 -> mean (D,) f32, sq () f32
extern "C" int panel_mean_consensus_f32(const void* theta, void* mean,
                                        void* partial, int nparts, void* sq,
                                        int m, long long D, void* stream) {
  return reduce<float>(theta, mean, partial, nparts, sq, m, D, stream);
}

extern "C" int panel_mean_consensus_bf16(const void* theta, void* mean,
                                         void* partial, int nparts, void* sq,
                                         int m, long long D, void* stream) {
  return reduce<bf16_t>(theta, mean, partial, nparts, sq, m, D, stream);
}

extern "C" int panel_mean_consensus_f16(const void* theta, void* mean,
                                        void* partial, int nparts, void* sq,
                                        int m, long long D, void* stream) {
  return reduce<f16_t>(theta, mean, partial, nparts, sq, m, D, stream);
}
