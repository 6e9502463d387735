// panel_reduce.cu -- Hopper (sm_90a) kernels for the panel statistics:
// the column mean of an (m, D) float32 panel and its total squared deviation
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
// What bounds it: bytes. Pass 1 reads the panel once (4*m*D bytes) and
// writes the mean (4*D); it does about 3 operations per element read, far
// under the H100's float32 flops per byte. Pass 2 touches a few KB. The
// least time is (4*m*D + 4*D) bytes over the memory rate.
//
// What the design does about it: each element is read from memory once. A
// thread owns VEC consecutive columns (16-byte float4 loads when D is a
// multiple of 4 and the pointers are 16-byte aligned, else one column),
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

template <int VEC>
struct Cols;

template <>
struct Cols<1> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Cols<4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

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

template <int MAXM, int VEC>
__global__ void __launch_bounds__(kThreads)
    mean_sq_kernel(const float* __restrict__ theta, float* __restrict__ mean,
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
      if (k < m) Cols<VEC>::load(theta + (long long)k * D + col, t[k]);
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
    Cols<VEC>::store(mean + col, mu);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

long long num_partials(long long D) {
  long long blocks = (D + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

template <int MAXM>
cudaError_t launch(const float* theta, float* mean, double* partial,
                   int nparts, float* sq, int m, long long D,
                   cudaStream_t stream) {
  const bool vec = (D % 4 == 0) && aligned16(theta) && aligned16(mean);
  if (vec) {
    mean_sq_kernel<MAXM, 4><<<nparts, kThreads, 0, stream>>>(
        theta, mean, partial, m, D);
  } else {
    mean_sq_kernel<MAXM, 1><<<nparts, kThreads, 0, stream>>>(
        theta, mean, partial, m, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partial, nparts, sq);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long panel_reduce_partials(long long D) {
  return num_partials(D);
}

extern "C" int panel_mean_consensus_f32(const void* theta, void* mean,
                                        void* partial, int nparts, void* sq,
                                        int m, long long D, void* stream) {
  if (m < 1 || m > 32 || D < 1 || nparts != num_partials(D))
    return (int)cudaErrorInvalidValue;
  const float* t = static_cast<const float*>(theta);
  float* mu = static_cast<float*>(mean);
  double* part = static_cast<double*>(partial);
  float* out = static_cast<float*>(sq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 8) return (int)launch<8>(t, mu, part, nparts, out, m, D, s);
  if (m <= 16) return (int)launch<16>(t, mu, part, nparts, out, m, D, s);
  return (int)launch<32>(t, mu, part, nparts, out, m, D, s);
}
