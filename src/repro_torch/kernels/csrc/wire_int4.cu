// wire_int4.cu -- Hopper (sm_90a) kernels of the int4 gossip wire.
//
// Replaces four Pallas TPU kernels of src/repro/kernels/wire_quant.py:
//   quantize_int4   <- quantize_int4_panel   (_round4_kernel, _stoch4_kernel)
//   dequantize_int4 <- dequantize_int4_panel (_dequant4_kernel)
//   pack_int4       <- pack_int4_panel       (_pack4_kernel)
//   unpack_int4     <- unpack_int4_panel     (_unpack4_kernel)
// over an (m, D) row-major panel. The scales are grouped: one float32 per
// row per `group` columns, (m, G) with G = ceil(D / group), computed by the
// caller outside the kernel as the reference does (amax / 7).
//
//   quantize:   q = clamp(rint(x / s), -7, 7)          (u == null)
//               q = clamp(floor(x / s + u), -7, 7)     (stochastic)
//               s = scale[row, col / group]; q is int8 in [-7, 7]
//   dequantize: y = float(q) * s
//   pack:       p[row, j] = (q[row, 2j] & 15) | (q[row, 2j + 1] & 15) << 4,
//               the odd tail against a zero nibble; p is (m, ceil(D / 2))
//   unpack:     q[row, c] = (n ^ 8) - 8, n the nibble of column c
//
// What bounds them: bytes. Each does a few operations per element against
// 1.5 to 9 bytes moved (x 4, u 4, q 1, packed 1/2, y 4), far under the
// H100's ~20 float32 operations per byte of memory traffic.
//
// What the design does about it: every byte is read once and written once,
// nothing is staged. The grid is (column blocks, m): blockIdx.y is the row,
// and a thread walks its row in a grid-stride loop with 64-bit row offsets
// (m * D is 1.9e9 at the main shape). Packing indexes each row on its own:
// flat pairing of the (m, D) buffer would pair a row's last column with the
// next row's first when D is odd. Aligned panels take vector paths whose
// warps read and write contiguous spans:
//   quantize / dequantize (D % 4 == 0, group % 4 == 0): a thread owns 4
//     columns of one scale group (one scale load, cached, per run), float4
//     for float32 and char4 for int8; dequantize keeps several char4 loads
//     in flight, as the int8 dequantize does;
//   pack / unpack (D % 16 == 0): a thread turns 16 int8 values (one 16-byte
//     load) into 8 packed bytes, or 8 packed bytes into 16 values, with byte
//     permutes.
// Any other width or alignment (D = 1001: rows start at odd addresses)
// takes the one-column path inside the same kernels: nothing is padded.
//
// Numerics, bit for bit with the plain versions (kernels/ref.py) and the
// reference's oracles: IEEE division __fdiv_rn (one ulp in x / s can flip a
// rounding decision), rintf (ties to even, as jnp.round), the stochastic
// sum as a separately rounded __fadd_rn, the product as __fmul_rn. Build
// without --use_fast_math.
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

__device__ __forceinline__ int8_t quant4_one(float x, float s, float u,
                                             bool stochastic) {
  const float t = __fdiv_rn(x, s);
  const float r = stochastic ? floorf(__fadd_rn(t, u)) : rintf(t);
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -7.0f), 7.0f)));
}

// the scale of column `col` (< 2^31) of a row's scales `sr`
__device__ __forceinline__ float group_scale(const float* sr, long long col,
                                             int group) {
  return __ldg(sr + static_cast<unsigned>(col) / static_cast<unsigned>(group));
}

// columns [col, col + VEC) of row r; VEC is 4 (aligned path) or 1
template <int VEC, bool STOCH>
__global__ void __launch_bounds__(kThreads)
    quantize4_kernel(const float* __restrict__ x,
                     const float* __restrict__ scale,
                     const float* __restrict__ u, int8_t* __restrict__ q,
                     long long D, int G, int group) {
  const long long row = blockIdx.y;
  const float* xr = x + row * D;
  const float* ur = STOCH ? u + row * D : nullptr;
  const float* sr = scale + row * G;
  int8_t* qr = q + row * D;
  const long long runs = D / VEC;
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
      out.x = quant4_one(xv.x, s, uv.x, STOCH);
      out.y = quant4_one(xv.y, s, uv.y, STOCH);
      out.z = quant4_one(xv.z, s, uv.z, STOCH);
      out.w = quant4_one(xv.w, s, uv.w, STOCH);
      *reinterpret_cast<char4*>(qr + col) = out;
    } else {
      qr[col] = quant4_one(__ldg(xr + col), s, STOCH ? __ldg(ur + col) : 0.f,
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
    dequantize4_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scale,
                       float* __restrict__ y, long long D, int G, int group) {
  const long long row = blockIdx.y;
  const int8_t* qr = q + row * D;
  const float* sr = scale + row * G;
  float* yr = y + row * D;
  const long long runs = D / VEC;
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
      for (int i = 0; i < kUnroll; ++i) y4[g + i * stride] = dequant4(v[i], s[i]);
    }
    for (; g < runs; g += stride)
      y4[g] = dequant4(__ldg(q4 + g), group_scale(sr, 4 * g, group));
  } else {
    for (; g < runs; g += stride)
      yr[g] = __fmul_rn((float)qr[g], group_scale(sr, g, group));
  }
}

// 8 int8 values (two words, column order in little-endian bytes) -> their
// 4 packed bytes: even column in the low nibble
__device__ __forceinline__ uint32_t pack8(uint32_t a, uint32_t b) {
  uint32_t ta = a & 0x0F0F0F0Fu;
  uint32_t tb = b & 0x0F0F0F0Fu;
  ta |= ta >> 4;  // bytes 0 and 2 now hold (col 0 | col 1 << 4), (2 | 3 << 4)
  tb |= tb >> 4;
  return __byte_perm(ta, tb, 0x6420);
}

// 4 packed bytes -> 8 int8 values as two words, each nibble sign-extended
__device__ __forceinline__ uint2 unpack8(uint32_t w) {
  const uint32_t lo = w & 0x0F0F0F0Fu;
  const uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;
  const uint32_t a = __byte_perm(lo, hi, 0x5140);  // lo0 hi0 lo1 hi1
  const uint32_t b = __byte_perm(lo, hi, 0x7362);  // lo2 hi2 lo3 hi3
  // (n ^ 8) - 8 in each byte: n ^ 8 is in [0, 15], so the bytes never borrow
  return make_uint2(__vsub4(a ^ 0x08080808u, 0x08080808u),
                    __vsub4(b ^ 0x08080808u, 0x08080808u));
}

// VEC16: one thread packs 16 columns (D % 16 == 0, aligned); else one
// packed byte per step, the odd tail against a zero nibble
template <bool VEC16>
__global__ void __launch_bounds__(kThreads)
    pack4_kernel(const int8_t* __restrict__ q, uint8_t* __restrict__ p,
                 long long D) {
  const long long row = blockIdx.y;
  const long long P = (D + 1) / 2;
  const int8_t* qr = q + row * D;
  uint8_t* pr = p + row * P;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC16) {
    const uint4* q16 = reinterpret_cast<const uint4*>(qr);
    uint2* p8 = reinterpret_cast<uint2*>(pr);
    for (; g < D / 16; g += stride) {
      const uint4 v = __ldg(q16 + g);
      p8[g] = make_uint2(pack8(v.x, v.y), pack8(v.z, v.w));
    }
  } else {
    for (; g < P; g += stride) {
      const long long c = 2 * g;
      const uint8_t lo = static_cast<uint8_t>(qr[c]) & 0xFu;
      const uint8_t hi =
          c + 1 < D ? static_cast<uint8_t>(qr[c + 1]) & 0xFu : 0u;
      pr[g] = static_cast<uint8_t>(lo | (hi << 4));
    }
  }
}

// VEC16: one thread unpacks 8 packed bytes into 16 columns; else one column
// per step
template <bool VEC16>
__global__ void __launch_bounds__(kThreads)
    unpack4_kernel(const uint8_t* __restrict__ p, int8_t* __restrict__ q,
                   long long D) {
  const long long row = blockIdx.y;
  const long long P = (D + 1) / 2;
  const uint8_t* pr = p + row * P;
  int8_t* qr = q + row * D;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC16) {
    const uint2* p8 = reinterpret_cast<const uint2*>(pr);
    uint4* q16 = reinterpret_cast<uint4*>(qr);
    for (; g < D / 16; g += stride) {
      const uint2 w = __ldg(p8 + g);
      const uint2 a = unpack8(w.x);
      const uint2 b = unpack8(w.y);
      q16[g] = make_uint4(a.x, a.y, b.x, b.y);
    }
  } else {
    for (; g < D; g += stride) {
      const uint32_t b = __ldg(pr + g / 2);
      const uint32_t n = (g & 1) ? (b >> 4) : (b & 0xFu);
      qr[g] = static_cast<int8_t>(static_cast<int>(n ^ 8u) - 8);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// (column blocks per row, rows): at most kMaxBlocks blocks in all
dim3 grid_for(int m, long long work) {
  long long per_row = (work + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / m;
  if (cap < 1) cap = 1;
  if (per_row > cap) per_row = cap;
  if (per_row < 1) per_row = 1;
  return dim3((unsigned)per_row, (unsigned)m);
}

// rows index the grid's y (<= 65535); a row's columns fit 31 bits
bool bad_shape(int m, long long D) {
  return m < 1 || m > 65535 || D < 1 || D > 0x7FFFFFFFLL;
}

bool bad_group(long long D, int G, int group) {
  return group < 1 || G != (D + group - 1) / group;
}

}  // namespace

// x (m, D) f32, scale (m, G) f32, u (m, D) f32 or null -> q (m, D) int8
extern "C" int quantize_int4_f32(const void* x, const void* scale,
                                 const void* u, void* q, int m, long long D,
                                 int G, int group, void* stream) {
  if (bad_shape(m, D) || bad_group(D, G, group))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* up = static_cast<const float*>(u);
  int8_t* qp = static_cast<int8_t*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && group % 4 == 0 && aligned(xp, 16) &&
                   aligned(up, 16) && aligned(qp, 4);
  const dim3 grid = grid_for(m, vec ? D / 4 : D);
  if (vec && up) {
    quantize4_kernel<4, true><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, D, G,
                                                         group);
  } else if (vec) {
    quantize4_kernel<4, false><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, D,
                                                          G, group);
  } else if (up) {
    quantize4_kernel<1, true><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, D, G,
                                                         group);
  } else {
    quantize4_kernel<1, false><<<grid, kThreads, 0, st>>>(xp, sp, up, qp, D,
                                                          G, group);
  }
  return (int)cudaGetLastError();
}

// q (m, D) int8, scale (m, G) f32 -> y (m, D) f32
extern "C" int dequantize_int4_f32(const void* q, const void* scale, void* y,
                                   int m, long long D, int G, int group,
                                   void* stream) {
  if (bad_shape(m, D) || bad_group(D, G, group))
    return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && group % 4 == 0 && aligned(yp, 16) &&
                   aligned(qp, 4);
  const dim3 grid = grid_for(m, vec ? D / 4 : D);
  if (vec) {
    dequantize4_kernel<4><<<grid, kThreads, 0, st>>>(qp, sp, yp, D, G, group);
  } else {
    dequantize4_kernel<1><<<grid, kThreads, 0, st>>>(qp, sp, yp, D, G, group);
  }
  return (int)cudaGetLastError();
}

// q (m, D) int8 -> p (m, ceil(D / 2)) uint8
extern "C" int pack_int4_i8(const void* q, void* p, int m, long long D,
                            void* stream) {
  if (bad_shape(m, D)) return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  uint8_t* pp = static_cast<uint8_t*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 16 == 0 && aligned(qp, 16) && aligned(pp, 8);
  const dim3 grid = grid_for(m, vec ? D / 16 : (D + 1) / 2);
  if (vec) {
    pack4_kernel<true><<<grid, kThreads, 0, st>>>(qp, pp, D);
  } else {
    pack4_kernel<false><<<grid, kThreads, 0, st>>>(qp, pp, D);
  }
  return (int)cudaGetLastError();
}

// p (m, ceil(D / 2)) uint8 -> q (m, D) int8
extern "C" int unpack_int4_u8(const void* p, void* q, int m, long long D,
                              void* stream) {
  if (bad_shape(m, D)) return (int)cudaErrorInvalidValue;
  const uint8_t* pp = static_cast<const uint8_t*>(p);
  int8_t* qp = static_cast<int8_t*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 16 == 0 && aligned(pp, 8) && aligned(qp, 16);
  const dim3 grid = grid_for(m, vec ? D / 16 : D);
  if (vec) {
    unpack4_kernel<true><<<grid, kThreads, 0, st>>>(pp, qp, D);
  } else {
    unpack4_kernel<false><<<grid, kThreads, 0, st>>>(pp, qp, D);
  }
  return (int)cudaGetLastError();
}
