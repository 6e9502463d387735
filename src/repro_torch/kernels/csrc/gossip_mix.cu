// gossip_mix.cu -- Hopper (sm_90a) kernel for the gossip mix out = W @ theta.
//
// Replaces the Pallas TPU kernel gossip_mix_panel
// (src/repro/kernels/gossip_mix.py, body _mix_kernel). W is (n, m) float32
// with n = m (a mixing matrix) or n = m + 1 (an extra 1^T/m row folds the
// column mean into the same sweep, see core/panel.py:mix_dense_mean); theta
// is the (m, D) float32 parameter panel; out is (n, D) float32.
//
// What bounds it: bytes. m is small (4 to 32) and D is the whole model
// (237.5 M columns for olmo-1b cut to two layers), so the kernel does
// 2*n*m flops per column against 4*(m + n) bytes moved, about one flop per
// byte: far under the H100's ~20 float32 flops per byte of memory traffic
// (67 TFLOP/s over 3.35 TB/s). Its least time is its bytes over the memory
// rate.
//
// What the design does about it: every input byte is read from device
// memory once and every output byte written once. A thread owns VEC
// consecutive columns (16-byte float4 loads and stores when D is a multiple
// of 4 and the pointers are 16-byte aligned, else one column), holds the m
// input values of its columns in registers and produces all n output rows
// from them. W (at most 33 x 32 floats) sits in shared memory. Blocks walk D
// in a grid-stride loop whose bound masks the ragged edge: nothing is padded
// (the TPU version pads D to its block).
//
// Numerics: out[r, j] = W[r,0]*t[0,j] + W[r,1]*t[1,j] + ..., summed over k in
// fixed order with every product and every sum rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into fused multiply-adds). Rows
// with equal weights therefore come out equal bit for bit: after the final
// merge (every row of W is 1/m) all rows of the panel and the folded mean
// row are identical and the consensus distance is exactly 0. The plain
// version, kernels/ref.py:gossip_mix_ref, runs the same sequence.
//
// C interface for ctypes. The kernel allocates nothing and launches on the
// stream it is given; the entry point returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape it does not take.

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

template <int MAXM, int VEC>
__global__ void __launch_bounds__(kThreads)
    mix_kernel(const float* __restrict__ W, const float* __restrict__ theta,
               float* __restrict__ out, int n, int m, long long D) {
  __shared__ float w_s[(MAXM + 1) * MAXM];
  for (int i = threadIdx.x; i < n * m; i += blockDim.x) w_s[i] = W[i];
  __syncthreads();

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
    for (int r = 0; r < n; ++r) {
      const float* w = w_s + r * m;
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = __fmul_rn(w[0], t[0][v]);
#pragma unroll
      for (int k = 1; k < MAXM; ++k) {
        if (k < m) {
          const float wk = w[k];
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(wk, t[k][v]));
        }
      }
      Cols<VEC>::store(out + (long long)r * D + col, acc);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int MAXM>
cudaError_t launch(const float* W, const float* theta, float* out, int n,
                   int m, long long D, cudaStream_t stream) {
  const bool vec = (D % 4 == 0) && aligned16(theta) && aligned16(out);
  const long long groups = vec ? D / 4 : D;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec) {
    mix_kernel<MAXM, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        W, theta, out, n, m, D);
  } else {
    mix_kernel<MAXM, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        W, theta, out, n, m, D);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gossip_mix_f32(const void* W, const void* theta, void* out,
                              int n, int m, long long D, void* stream) {
  if (m < 1 || m > 32 || n < 1 || n > m + 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(W);
  const float* t = static_cast<const float*>(theta);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 8) return (int)launch<8>(w, t, o, n, m, D, s);
  if (m <= 16) return (int)launch<16>(w, t, o, n, m, D, s);
  return (int)launch<32>(w, t, o, n, m, D, s);
}
