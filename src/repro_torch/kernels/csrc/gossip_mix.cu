// gossip_mix.cu -- Hopper (sm_90a) kernel for the gossip mix out = W @ theta.
//
// Replaces the Pallas TPU kernel gossip_mix_panel
// (src/repro/kernels/gossip_mix.py, body _mix_kernel). W is (n, m) float32
// with n = m (a mixing matrix) or n = m + 1 (an extra 1^T/m row folds the
// column mean into the same sweep, see core/panel.py:mix_dense_mean); theta
// is the (m, D) parameter panel or wire payload: float32, bfloat16 (the
// bf16 wire, or a bfloat16 parameter group) or float16 (a float16 group);
// out is (n, D) float32 for each, the folded mean row included. The caller
// rounds a narrower payload's mixed rows back to its dtype, as the
// reference's plain path does (core/panel.py of the reference:
// y32 = W @ xw.astype(f32), y = y32.astype(xw.dtype)).
//
// What bounds it: bytes. m is small (4 to 32) and D is the whole model
// (237.5 M columns for olmo-1b cut to two layers), so the kernel does
// 2*n*m flops per column against (4 or 2)*m + 4*n bytes moved, about one
// flop per byte: far under the H100's ~20 float32 flops per byte of memory
// traffic (67 TFLOP/s over 3.35 TB/s). Its least time is its bytes over the
// memory rate.
//
// What the design does about it: every input byte is read from device
// memory once and every output byte written once. A thread owns VEC
// consecutive columns (VEC = 4 when D is a multiple of 4 and the pointers
// are aligned: 16-byte float4 loads, or 8-byte loads of four bf16 values,
// and float4 stores; else one column), holds the m input values of its
// columns in registers as float32 (a bf16 value widens exactly) and
// produces all n output rows from them. W (at most 33 x 32 floats) sits in
// shared memory. Blocks walk D in a grid-stride loop whose bound masks the
// ragged edge: nothing is padded (the TPU version pads D to its block).
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
// stream it is given; each entry point returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

// bfloat16 travels as its 16 bits (the high half of a float32), so the
// kernel needs no bf16 header: widening is a shift, and exact
struct bf16_t {
  uint16_t bits;
};

// float16 travels as its 16 bits too; widening to float32 is exact
struct f16_t {
  uint16_t bits;
};

__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xFFFFu)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
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
__device__ __forceinline__ void load_cols(const bf16_t* p, float (&v)[1]) {
  v[0] = bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void load_cols(const bf16_t* p, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_lo(x.x);  // the lower address is the low half (little endian)
  v[1] = bf16_hi(x.x);
  v[2] = bf16_lo(x.y);
  v[3] = bf16_hi(x.y);
}

__device__ __forceinline__ void load_cols(const f16_t* p, float (&v)[1]) {
  v[0] = f16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void load_cols(const f16_t* p, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = f16_lo(x.x);
  v[1] = f16_hi(x.x);
  v[2] = f16_lo(x.y);
  v[3] = f16_hi(x.y);
}

__device__ __forceinline__ void store_cols(float* p, const float (&v)[1]) {
  p[0] = v[0];
}
__device__ __forceinline__ void store_cols(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int MAXM, int VEC, typename T>
__global__ void __launch_bounds__(kThreads)
    mix_kernel(const float* __restrict__ W, const T* __restrict__ theta,
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
      if (k < m) load_cols(theta + (long long)k * D + col, t[k]);
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
      store_cols(out + (long long)r * D + col, acc);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int MAXM, typename T>
cudaError_t launch(const float* W, const T* theta, float* out, int n, int m,
                   long long D, cudaStream_t stream) {
  // four columns of a row: 16 bytes of float32 or 8 bytes of bf16 / f16
  const bool vec = (D % 4 == 0) && aligned(theta, 4 * sizeof(T)) &&
                   aligned(out, 16);
  const long long groups = vec ? D / 4 : D;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec) {
    mix_kernel<MAXM, 4, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        W, theta, out, n, m, D);
  } else {
    mix_kernel<MAXM, 1, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        W, theta, out, n, m, D);
  }
  return cudaGetLastError();
}

template <typename T>
int mix(const void* W, const void* theta, void* out, int n, int m,
        long long D, void* stream) {
  if (m < 1 || m > 32 || n < 1 || n > m + 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(W);
  const T* t = static_cast<const T*>(theta);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 8) return (int)launch<8>(w, t, o, n, m, D, s);
  if (m <= 16) return (int)launch<16>(w, t, o, n, m, D, s);
  return (int)launch<32>(w, t, o, n, m, D, s);
}

}  // namespace

// W (n, m) f32, theta (m, D) f32 -> out (n, D) f32
extern "C" int gossip_mix_f32(const void* W, const void* theta, void* out,
                              int n, int m, long long D, void* stream) {
  return mix<float>(W, theta, out, n, m, D, stream);
}

// W (n, m) f32, theta (m, D) bf16 -> out (n, D) f32
extern "C" int gossip_mix_bf16(const void* W, const void* theta, void* out,
                               int n, int m, long long D, void* stream) {
  return mix<bf16_t>(W, theta, out, n, m, D, stream);
}

// W (n, m) f32, theta (m, D) f16 -> out (n, D) f32
extern "C" int gossip_mix_f16(const void* W, const void* theta, void* out,
                              int n, int m, long long D, void* stream) {
  return mix<f16_t>(W, theta, out, n, m, D, stream);
}
