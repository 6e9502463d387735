// wire_int8g.cu -- Hopper (sm_90a) kernels of the grouped int8 layout, the
// storage of the companded int8 moment, statistics and residual panels.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/wire_quant.py:
//   quantize_int8g   <- quantize_int8_grouped_panel
//                       (_round8g_kernel, _stoch8g_kernel)
//   dequantize_int8g <- dequantize_int8_grouped_panel (_dequant8g_kernel)
// over an (m, w) row-major panel or column slab of one. The scales are
// grouped: one float32 per row per `group` columns, (m, G) with
// G = ceil(w / group), computed by the caller outside the kernel as the
// reference does (amax / 127). The companding transform of the moment
// storages stays outside too, as in the reference.
//
//   quantize:   q = clamp(rint(x / s), -127, 127)          (u == null)
//               q = clamp(floor(x / s + u), -127, 127)     (stochastic)
//               s = scale[row, col / group]
//   dequantize: y = float(q) * s
//
// Every operand has its own row stride (leading dimension, in elements),
// so a column slab of a wider (m, D) panel -- a slab of whole groups, its
// pointers at the slab's first column and first group -- is read and
// written in place without a copy. The storages draw their uniforms a slab
// at a time (2^22 columns), so a stochastic write never holds an (m, D)
// panel of uniforms.
//
// What bounds them: bytes. A few operations per element against 5 to 9
// bytes moved (x 4, u 4, q 1, y 4), far under the H100's ~20 float32
// operations per byte of memory traffic.
//
// What the design does about it: every byte is read once and written once,
// nothing is staged. The grid is (column blocks, m): blockIdx.y is the row,
// a thread walks its row in a grid-stride loop with 64-bit row offsets.
// When every stride, the width and the group are multiples of 4 and the
// pointers are aligned, a thread owns 4 columns of one scale group (one
// cached scale load; float4 for float32, char4 for int8) and dequantize
// keeps several char4 loads in flight; any other shape takes the
// one-column path of the same kernels.
//
// Numerics, bit for bit with the plain versions (kernels/ref.py) and the
// reference's oracles: IEEE division __fdiv_rn, rintf (ties to even, as
// jnp.round), the stochastic sum as a separately rounded __fadd_rn, the
// product as __fmul_rn. Build without --use_fast_math.
//
// C interface for ctypes. The kernels allocate nothing and launch on the
// stream they are given; each entry point returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;
constexpr int kUnroll = 4;  // char4 loads a dequantize thread keeps in flight

__device__ __forceinline__ int8_t quant8_one(float x, float s, float u,
                                             bool stochastic) {
  const float t = __fdiv_rn(x, s);
  const float r = stochastic ? floorf(__fadd_rn(t, u)) : rintf(t);
  return static_cast<int8_t>(
      static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

__device__ __forceinline__ float group_scale(const float* sr, long long col,
                                             int group) {
  return __ldg(sr + static_cast<unsigned>(col) / static_cast<unsigned>(group));
}

struct Strides {
  long long x, s, u, q;  // row strides in elements
};

template <int VEC, bool STOCH>
__global__ void __launch_bounds__(kThreads)
    quantize8g_kernel(const float* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ u, int8_t* __restrict__ q,
                      long long w, int group, Strides ld) {
  const long long row = blockIdx.y;
  const float* xr = x + row * ld.x;
  const float* ur = STOCH ? u + row * ld.u : nullptr;
  const float* sr = scale + row * ld.s;
  int8_t* qr = q + row * ld.q;
  const long long runs = w / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < runs; g += stride) {
    const long long col = g * VEC;
    const float s = group_scale(sr, col, group);
    if (VEC == 4) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + col));
      float4 uv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (STOCH) uv = __ldg(reinterpret_cast<const float4*>(ur + col));
      char4 out;
      out.x = quant8_one(xv.x, s, uv.x, STOCH);
      out.y = quant8_one(xv.y, s, uv.y, STOCH);
      out.z = quant8_one(xv.z, s, uv.z, STOCH);
      out.w = quant8_one(xv.w, s, uv.w, STOCH);
      *reinterpret_cast<char4*>(qr + col) = out;
    } else {
      qr[col] = quant8_one(__ldg(xr + col), s, STOCH ? __ldg(ur + col) : 0.f,
                           STOCH);
    }
  }
}

__device__ __forceinline__ float4 dequant4(char4 v, float s) {
  return make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                     __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    dequantize8g_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        float* __restrict__ y, long long w, int group,
                        long long ldq, long long lds, long long ldy) {
  const long long row = blockIdx.y;
  const int8_t* qr = q + row * ldq;
  const float* sr = scale + row * lds;
  float* yr = y + row * ldy;
  const long long runs = w / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC == 4) {
    const char4* q4 = reinterpret_cast<const char4*>(qr);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (; g + (kUnroll - 1) * stride < runs; g += kUnroll * stride) {
      char4 v[kUnroll];
      float s[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        v[i] = __ldg(q4 + g + i * stride);
        s[i] = group_scale(sr, 4 * (g + i * stride), group);
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i)
        y4[g + i * stride] = dequant4(v[i], s[i]);
    }
    for (; g < runs; g += stride)
      y4[g] = dequant4(__ldg(q4 + g), group_scale(sr, 4 * g, group));
  } else {
    for (; g < runs; g += stride)
      yr[g] = __fmul_rn((float)qr[g], group_scale(sr, g, group));
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

dim3 grid_for(int m, long long work) {
  long long per_row = (work + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / m;
  if (cap < 1) cap = 1;
  if (per_row > cap) per_row = cap;
  if (per_row < 1) per_row = 1;
  return dim3((unsigned)per_row, (unsigned)m);
}

// rows index the grid's y (<= 65535); a row's columns fit 31 bits; each
// row stride covers the row's elements
bool bad_shape(int m, long long w, int G, int group) {
  return m < 1 || m > 65535 || w < 1 || w > 0x7FFFFFFFLL || group < 1 ||
         G != (w + group - 1) / group;
}

}  // namespace

// x (m, w; row stride ldx) f32, scale (m, G; lds) f32, u (m, w; ldu) f32 or
// null -> q (m, w; ldq) int8
extern "C" int quantize_int8g_f32(const void* x, const void* scale,
                                  const void* u, void* q, int m, long long w,
                                  int G, int group, long long ldx,
                                  long long lds, long long ldu, long long ldq,
                                  void* stream) {
  if (bad_shape(m, w, G, group) || ldx < w || lds < G || ldq < w ||
      (u && ldu < w))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* up = static_cast<const float*>(u);
  int8_t* qp = static_cast<int8_t*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides ld{ldx, lds, ldu, ldq};
  const bool vec = w % 4 == 0 && group % 4 == 0 && ldx % 4 == 0 &&
                   ldq % 4 == 0 && (!up || ldu % 4 == 0) && aligned(xp, 16) &&
                   aligned(up, 16) && aligned(qp, 4);
  const dim3 grid = grid_for(m, vec ? w / 4 : w);
  if (vec && up) {
    quantize8g_kernel<4, true><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, w,
                                                          group, ld);
  } else if (vec) {
    quantize8g_kernel<4, false><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, w,
                                                           group, ld);
  } else if (up) {
    quantize8g_kernel<1, true><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, w,
                                                          group, ld);
  } else {
    quantize8g_kernel<1, false><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, w,
                                                           group, ld);
  }
  return (int)cudaGetLastError();
}

// q (m, w; ldq) int8, scale (m, G; lds) f32 -> y (m, w; ldy) f32
extern "C" int dequantize_int8g_f32(const void* q, const void* scale, void* y,
                                    int m, long long w, int G, int group,
                                    long long ldq, long long lds,
                                    long long ldy, void* stream) {
  if (bad_shape(m, w, G, group) || ldq < w || lds < G || ldy < w)
    return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && group % 4 == 0 && ldq % 4 == 0 &&
                   ldy % 4 == 0 && aligned(yp, 16) && aligned(qp, 4);
  const dim3 grid = grid_for(m, vec ? w / 4 : w);
  if (vec) {
    dequantize8g_kernel<4><<<grid, kThreads, 0, st>>>(qp, sp, yp, w, group,
                                                      ldq, lds, ldy);
  } else {
    dequantize8g_kernel<1><<<grid, kThreads, 0, st>>>(qp, sp, yp, w, group,
                                                      ldq, lds, ldy);
  }
  return (int)cudaGetLastError();
}
