// wire_quant.cu -- Hopper (sm_90a) kernels of the compressed gossip wire.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/wire_quant.py:
//   quantize_int8   <- quantize_int8_panel   (_round_kernel, _stoch_kernel)
//   dequantize_int8 <- dequantize_int8_panel (_dequant_kernel)
//   sparsify_topk   <- sparsify_topk_panel   (_sparsify_kernel)
// Each is elementwise over an (m, D) row-major panel against one float32
// value per row (the int8 scale or the top-k threshold, (m, 1)), which the
// caller computes outside the kernel as the reference does.
//
//   quantize:   q = clamp(rint(x / s), -127, 127)          (u == null)
//               q = clamp(floor(x / s + u), -127, 127)     (stochastic)
//   dequantize: y = float(q) * s
//   sparsify:   y = |x| >= t ? x : 0
//
// What bounds them: bytes. Each does one to four operations per element
// against 5 to 9 bytes moved (x 4, u 4, q 1, y 4), far under the H100's ~20
// float32 operations per byte of memory traffic. Their least time is their
// bytes over the memory rate.
//
// What the design does about it: every byte is read once and written once,
// nothing is staged. The grid is (column blocks, m): blockIdx.y is the row,
// so a thread reads its row's scale or threshold once into a register and
// walks the row's columns in a grid-stride loop with 64-bit indices (m * D
// is 1.9e9 at the main shape, close to 2^31). When D % 4 == 0 and every
// pointer is 16-byte aligned (rows then stay aligned too), a thread moves 4
// consecutive columns per step: float4 loads and stores for float32, one
// 4-byte char4 for int8 (dequantize keeps several char4 loads in flight).
// Otherwise one column per step. The ragged edge is masked by the loop
// bound: nothing is padded (the TPU versions pad D to their block).
//
// Numerics, bit for bit with the plain versions (kernels/ref.py) and the
// reference's oracles: IEEE division __fdiv_rn (never a reciprocal multiply:
// one ulp in x / s can flip a rounding decision), round to nearest with
// ties to even (rintf, as jnp.round and torch.round), the stochastic sum
// as a separately rounded __fadd_rn (no contraction), the product in
// dequantize as __fmul_rn. Build without --use_fast_math.
//
// C interface for ctypes. The kernels allocate nothing and launch on the
// stream they are given; each entry point returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

__device__ __forceinline__ int8_t quant_one(float x, float s, float u,
                                            bool stochastic) {
  const float t = __fdiv_rn(x, s);
  const float r = stochastic ? floorf(__fadd_rn(t, u)) : rintf(t);
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f),
                                                    127.0f)));
}

__device__ __forceinline__ float sparsify_one(float x, float t) {
  return fabsf(x) >= t ? x : 0.0f;
}

// columns [col, col + VEC) of row r; VEC is 4 (aligned path) or 1
template <int VEC, bool STOCH>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ u, int8_t* __restrict__ q,
                    long long D) {
  const long long row = blockIdx.y;
  const float s = scale[row];
  const float* xr = x + row * D;
  const float* ur = STOCH ? u + row * D : nullptr;
  int8_t* qr = q + row * D;
  const long long groups = D / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long col = g * VEC;
    if (VEC == 4) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + col));
      float4 uv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (STOCH) uv = __ldg(reinterpret_cast<const float4*>(ur + col));
      char4 out;
      out.x = quant_one(xv.x, s, uv.x, STOCH);
      out.y = quant_one(xv.y, s, uv.y, STOCH);
      out.z = quant_one(xv.z, s, uv.z, STOCH);
      out.w = quant_one(xv.w, s, uv.w, STOCH);
      *reinterpret_cast<char4*>(qr + col) = out;
    } else {
      qr[col] = quant_one(__ldg(xr + col), s, STOCH ? __ldg(ur + col) : 0.f,
                          STOCH);
    }
  }
}

__device__ __forceinline__ float4 dequant4(char4 v, float s) {
  return make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                     __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
}

// VEC is 4 (char4 loads, float4 stores) or 1. A thread reads only 4 bytes
// per 4 columns, so the aligned path issues kUnroll loads, a grid stride
// apart, before their stores: 4-byte loads one at a time kept too few bytes
// in flight (68 % of the byte bound on the H100), and one 16-byte load per
// thread made each warp store write 64-byte strided pieces (40 %).
constexpr int kUnroll = 4;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ y,
                      long long D) {
  const long long row = blockIdx.y;
  const float s = scale[row];
  const int8_t* qr = q + row * D;
  float* yr = y + row * D;
  const long long groups = D / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC == 4) {
    const char4* q4 = reinterpret_cast<const char4*>(qr);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (; g + (kUnroll - 1) * stride < groups; g += kUnroll * stride) {
      char4 v[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) v[i] = __ldg(q4 + g + i * stride);
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) y4[g + i * stride] = dequant4(v[i], s);
    }
    for (; g < groups; g += stride) y4[g] = dequant4(__ldg(q4 + g), s);
  } else {
    for (; g < groups; g += stride) yr[g] = __fmul_rn((float)qr[g], s);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    sparsify_kernel(const float* __restrict__ x,
                    const float* __restrict__ thresh, float* __restrict__ y,
                    long long D) {
  const long long row = blockIdx.y;
  const float t = thresh[row];
  const float* xr = x + row * D;
  float* yr = y + row * D;
  const long long groups = D / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long col = g * VEC;
    if (VEC == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + col));
      *reinterpret_cast<float4*>(yr + col) =
          make_float4(sparsify_one(v.x, t), sparsify_one(v.y, t),
                      sparsify_one(v.z, t), sparsify_one(v.w, t));
    } else {
      yr[col] = sparsify_one(__ldg(xr + col), t);
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// (column blocks per row, rows): at most kMaxBlocks blocks in all
dim3 grid_for(int m, long long groups) {
  long long per_row = (groups + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / m;
  if (cap < 1) cap = 1;
  if (per_row > cap) per_row = cap;
  if (per_row < 1) per_row = 1;
  return dim3((unsigned)per_row, (unsigned)m);
}

bool bad_shape(int m, long long D) { return m < 1 || m > 65535 || D < 1; }

}  // namespace

// x (m, D) f32, scale (m, 1) f32, u (m, D) f32 or null -> q (m, D) int8
extern "C" int quantize_int8_f32(const void* x, const void* scale,
                                 const void* u, void* q, int m, long long D,
                                 void* stream) {
  if (bad_shape(m, D)) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* up = static_cast<const float*>(u);
  int8_t* qp = static_cast<int8_t*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (D % 4 == 0) && aligned16(xp) && aligned16(up) &&
                   (reinterpret_cast<uintptr_t>(qp) & 3u) == 0;
  const dim3 grid = grid_for(m, vec ? D / 4 : D);
  if (vec && up) {
    quantize_kernel<4, true><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, D);
  } else if (vec) {
    quantize_kernel<4, false><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, D);
  } else if (up) {
    quantize_kernel<1, true><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, D);
  } else {
    quantize_kernel<1, false><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, D);
  }
  return (int)cudaGetLastError();
}

// q (m, D) int8, scale (m, 1) f32 -> y (m, D) f32
extern "C" int dequantize_int8_f32(const void* q, const void* scale, void* y,
                                   int m, long long D, void* stream) {
  if (bad_shape(m, D)) return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (D % 4 == 0) && aligned16(yp) &&
                   (reinterpret_cast<uintptr_t>(qp) & 3u) == 0;
  const dim3 grid = grid_for(m, vec ? D / 4 : D);
  if (vec) {
    dequantize_kernel<4><<<grid, kThreads, 0, st>>>(qp, sp, yp, D);
  } else {
    dequantize_kernel<1><<<grid, kThreads, 0, st>>>(qp, sp, yp, D);
  }
  return (int)cudaGetLastError();
}

// x (m, D) f32, thresh (m, 1) f32 -> y (m, D) f32
extern "C" int sparsify_topk_f32(const void* x, const void* thresh, void* y,
                                 int m, long long D, void* stream) {
  if (bad_shape(m, D)) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(thresh);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (D % 4 == 0) && aligned16(xp) && aligned16(yp);
  const dim3 grid = grid_for(m, vec ? D / 4 : D);
  if (vec) {
    sparsify_kernel<4><<<grid, kThreads, 0, st>>>(xp, tp, yp, D);
  } else {
    sparsify_kernel<1><<<grid, kThreads, 0, st>>>(xp, tp, yp, D);
  }
  return (int)cudaGetLastError();
}
