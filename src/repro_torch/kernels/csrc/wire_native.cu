// wire_native.cu -- Hopper (sm_90a) kernel of the stochastic int8 wire
// quantize that draws its uniforms on the chip.
//
// Replaces the Pallas TPU kernel quantize_int8_panel_native of
// src/repro/kernels/wire_quant.py: q = clamp(floor(x / s + u), -127, 127)
// over an (m, D) row-major float32 panel against one float32 scale per row
// ((m, 1), amax / 127, computed by the caller as the reference does), with
// u drawn inside the kernel instead of read from an (m, D) uniform panel.
//
// The draws: Philox4x32-10 (Salmon et al., SC'11; the constants of
// Random123 and of the toolkit's curand_Philox4x32_10), keyed by
// (seed, 512-column block index) as two separate words -- the reference's
// keying, so consecutive seeds never alias shifted streams (seed t, block
// i is not seed t + 1, block i - 1) -- on the counter (row, column within
// the block / 4, 0, 0). One call gives the 4 consecutive columns 4j..4j+3
// of the block, word k to column 4j + k, and u = (word & 0xFFFFFF) * 2^-24
// (exact in float32, in [0, 1)). The seed is read from a 1-element int32
// device tensor (the counterpart of the reference's SMEM scalar), so the
// caller draws it on the card and nothing waits for the host.
//
// What bounds it: bytes. x in (4 bytes a column) and q out (1 byte): 5
// bytes an element, where the supplied-uniform quantize moves 9. Philox
// costs 20 32-bit multiplies (10 high halves, 10 low) and about 40 other
// integer operations per 4 columns, about 15 an element, under the card's
// integer rate at this byte rate.
//
// The design is the simple one: one thread per 4 columns (one Philox call),
// a grid-stride loop over a row's quads with blockIdx.y the row, float4
// loads and one char4 store where D % 4 == 0 and the pointers are aligned,
// else single columns with the tail masked (a D that is not a multiple of 4
// or of 512 needs no padding). Numerics as quantize_int8 in wire_quant.cu:
// IEEE division __fdiv_rn, the sum as a separately rounded __fadd_rn, floor,
// clamp. Build without --use_fast_math.
//
// A block of a wider panel (a rank's shard of a sharded panel) passes the
// panel row of its first row (row0) and the panel column of its first
// column (col0, a multiple of 512): its draws are then the wider panel's,
// so the shards of a panel quantize to the whole panel's bits.
//
// C interface for ctypes: the kernel allocates nothing and launches on the
// stream it is given; the entry point returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kQuadsPerBlock = 512 / 4;  // counter word 1 wraps per block

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  // a 24-bit integer times 2^-24: exact
  return __fmul_rn(static_cast<float>(bits & 0xFFFFFFu), 5.9604644775390625e-8f);
}

__device__ __forceinline__ int8_t quant_one(float x, float s, float u) {
  const float r = floorf(__fadd_rn(__fdiv_rn(x, s), u));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f),
                                                    127.0f)));
}

// quad g of row blockIdx.y: columns [4g, 4g + 4) (fewer at a ragged tail)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    quantize_native_kernel(const float* __restrict__ x,
                           const float* __restrict__ scale,
                           const int32_t* __restrict__ seed,
                           int8_t* __restrict__ q, long long D,
                           uint32_t row0, long long quad0) {
  const uint32_t row = row0 + blockIdx.y;
  const float s = scale[blockIdx.y];
  const uint32_t sd = static_cast<uint32_t>(__ldg(seed));
  const float* xr = x + (long long)blockIdx.y * D;
  int8_t* qr = q + (long long)blockIdx.y * D;
  const long long quads = (D + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < quads; g += stride) {
    const long long col = g * 4;
    const long long gq = quad0 + g;  // the quad's index in the panel row
    const uint4 r = philox4x32_10(
        make_uint4(row, static_cast<uint32_t>(gq % kQuadsPerBlock), 0u, 0u),
        make_uint2(sd, static_cast<uint32_t>(gq / kQuadsPerBlock)));
    if (VEC) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + col));
      char4 out;
      out.x = quant_one(xv.x, s, uniform24(r.x));
      out.y = quant_one(xv.y, s, uniform24(r.y));
      out.z = quant_one(xv.z, s, uniform24(r.z));
      out.w = quant_one(xv.w, s, uniform24(r.w));
      *reinterpret_cast<char4*>(qr + col) = out;
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (col + k < D) {
          qr[col + k] = quant_one(__ldg(xr + col + k), s, uniform24(w[k]));
        }
      }
    }
  }
}

// (column blocks per row, rows): at most kMaxBlocks blocks in all
dim3 grid_for(int m, long long quads) {
  long long per_row = (quads + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / m;
  if (cap < 1) cap = 1;
  if (per_row > cap) per_row = cap;
  if (per_row < 1) per_row = 1;
  return dim3((unsigned)per_row, (unsigned)m);
}

}  // namespace

// x (m, D) f32, scale (m, 1) f32, seed (1,) int32 -> q (m, D) int8; the
// block's first row and column in its panel (row0, col0 % 512 == 0)
extern "C" int quantize_int8_native_f32(const void* x, const void* scale,
                                        const void* seed, void* q, int m,
                                        long long D, int row0,
                                        long long col0, void* stream) {
  if (m < 1 || m > 65535 || D < 1 || D > 2147483647LL || row0 < 0 ||
      col0 < 0 || col0 % 512 != 0 || col0 + D > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  const int32_t* seedp = static_cast<const int32_t*>(seed);
  int8_t* qp = static_cast<int8_t*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (D % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(xp) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(qp) & 3u) == 0;
  const dim3 grid = grid_for(m, (D + 3) / 4);
  if (vec) {
    quantize_native_kernel<true><<<grid, kThreads, 0, st>>>(
        xp, sp, seedp, qp, D, (uint32_t)row0, col0 / 4);
  } else {
    quantize_native_kernel<false><<<grid, kThreads, 0, st>>>(
        xp, sp, seedp, qp, D, (uint32_t)row0, col0 / 4);
  }
  return (int)cudaGetLastError();
}

// Philox4x32-10 of n (counter, key) pairs, for holding this kernel's
// generator against the toolkit's (chip_smoke.py): ctr (n, 4), key (n, 2)
// uint32 -> out (n, 4) uint32
namespace {
__global__ void philox_kernel(const uint32_t* __restrict__ ctr,
                              const uint32_t* __restrict__ key,
                              uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 r = philox4x32_10(
      make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]),
      make_uint2(key[2 * i], key[2 * i + 1]));
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}
}  // namespace

extern "C" int philox4x32_10_u32(const void* ctr, const void* key, void* out,
                                 int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  philox_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ctr), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}
