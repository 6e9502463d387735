// opt_fused.cu -- Hopper (sm_90a) fused AdamW step on grouped-int8 moments.
//
// Replaces the Pallas TPU kernel adamw_fused_int8_panel (_adamw_fused_kernel)
// of src/repro/kernels/opt_fused.py. Over an (m, w) slab of the parameter,
// gradient and stored-moment panels it does, in one sweep, for each
// row and each group of `group` columns:
//   1. decode both moments: y = float(q) * s, then the inverse companding
//      sign(y) * y^2 (transform 1) or nothing (transform 0);
//   2. the AdamW expression of optim.adamw_core with the row's lr, bc1, bc2:
//        m' = b1 m + (1 - b1) g;   v' = b2 v + (1 - b2) g^2
//        p' = p - lr (m' / bc1 / (sqrt(v' / bc2) + eps) + wd p)
//   3. write p';
//   4. the forward companding z = sign(x) * sqrt(|x|) of m' and v';
//   5. each group's fresh scale amax|z| / 127 (an all-zero group 1/127);
//   6. the stochastic re-encode q = clamp(floor(z / s + u), -127, 127).
// p, the int8 moments and their scales are updated IN PLACE; nothing else
// goes back to memory, and no float32 moment panel is ever made.
//
// What bounds it: bytes. Per element it reads g, p, both uniforms (4 bytes
// each) and both int8 moments, and writes p and both moments: 24 bytes, plus
// 16 bytes per group and row for the four scale reads and writes; it does
// some 40 float32 operations per element, about 1.7 per byte, far under the
// H100's ~20 per byte.
//
// What the design does about it: a warp owns whole groups, one at a time
// (grid-stride over (row, group) pairs), and holds the group's new moments
// in registers, so the group's amax is a warp shuffle reduction and the
// fresh scale is used for the re-encode without a trip through memory. For
// the 128-column groups of the int8 storage on aligned panels, lane l holds
// the 4 consecutive columns 4l .. 4l + 3 and loads them as one float4 or
// char4; otherwise lane l holds columns l, l + 32, ... (VPL values a lane,
// a template bucket of 1..32, so a group of up to 1024 columns). Every
// operand has a row stride, so a column slab of whole groups of a wider
// (m, D) panel is updated in place: the port draws the uniforms a slab of
// 2^22 columns at a time and never holds an (m, D) panel of them.
//
// Numerics, bit for bit with the plain version (kernels/ref.py:
// adamw_fused_int8_ref), where PyTorch runs every operation as its own
// rounded kernel: no contraction -- every product, sum and difference is
// __fmul_rn / __fadd_rn / __fsub_rn, the divisions __fdiv_rn, the square
// root __fsqrt_rn, round-down floorf after a separately rounded u sum; the
// constants arrive as the float32 values PyTorch rounds its Python scalars
// to; sign(x) is (x > 0) - (x < 0) as torch.sign computes it. Build without
// --use_fast_math.
//
// C interface for ctypes. The kernel allocates nothing and launches on the
// stream it is given; the entry point returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 16;

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

template <bool SQRT>
__device__ __forceinline__ float decode(int8_t q, float s) {
  const float y = __fmul_rn((float)q, s);
  return SQRT ? __fmul_rn(sgn(y), __fmul_rn(y, y)) : y;
}

template <bool SQRT>
__device__ __forceinline__ float compand(float x) {
  return SQRT ? __fmul_rn(sgn(x), __fsqrt_rn(fabsf(x))) : x;
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

__device__ __forceinline__ int8_t encode(float z, float s, float u) {
  const float r = floorf(__fadd_rn(__fdiv_rn(z, s), u));
  return static_cast<int8_t>(
      static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

// one column: decode, the AdamW expression, p' written to *pout, the
// companded new moments returned in zm, zv
template <bool SQRT>
__device__ __forceinline__ void update_one(float gg, float pp, int8_t qa,
                                           int8_t qb, float smo, float svo,
                                           float lr_r, float b1c, float b2c,
                                           const Consts& c, float* pout,
                                           float* zm, float* zv) {
  const float m0 = decode<SQRT>(qa, smo);
  const float v0 = decode<SQRT>(qb, svo);
  const float m1 = __fadd_rn(__fmul_rn(c.b1, m0), __fmul_rn(c.omb1, gg));
  const float v1 = __fadd_rn(__fmul_rn(c.b2, v0),
                             __fmul_rn(c.omb2, __fmul_rn(gg, gg)));
  const float mhat = __fdiv_rn(m1, b1c);
  const float vhat = __fdiv_rn(v1, b2c);
  const float den = __fadd_rn(__fsqrt_rn(vhat), c.eps);
  const float t = __fadd_rn(__fdiv_rn(mhat, den), __fmul_rn(c.wd, pp));
  *pout = __fsub_rn(pp, __fmul_rn(lr_r, t));
  *zm = compand<SQRT>(m1);
  *zv = compand<SQRT>(v1);
}

// ldx: row stride of g, p, qm, qv; lds: of sm, sv; ldu: of um, uv.
// V4 (group 128, every stride and the width multiples of 4, aligned
// pointers): lane l holds the 4 consecutive columns 4l .. 4l + 3 of its
// group, loaded as one float4 (g, p, u) or char4 (q); otherwise lane l
// holds columns l, l + 32, ... one at a time.
template <int VPL, bool SQRT, bool V4>
__global__ void __launch_bounds__(kThreads)
    adamw_fused_kernel(const float* __restrict__ g, float* __restrict__ p,
                       int8_t* __restrict__ qm, float* __restrict__ sm,
                       int8_t* __restrict__ qv, float* __restrict__ sv,
                       const float* __restrict__ um,
                       const float* __restrict__ uv,
                       const float* __restrict__ lr,
                       const float* __restrict__ bc1,
                       const float* __restrict__ bc2, int m, long long w,
                       int G, int group, long long ldx, long long lds,
                       long long ldu, Consts c) {
  const int lane = threadIdx.x & 31;
  const long long pairs = (long long)m * G;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long pi = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       pi < pairs; pi += nwarps) {
    const long long row = pi / G;
    const long long gi = pi - row * G;
    const long long c0 = gi * group;
    const long long rem = w - c0;
    const int glen = rem < group ? (int)rem : group;
    const long long xo = row * ldx + c0;
    const long long uo = row * ldu + c0;
    const long long so = row * lds + gi;
    const float smo = __ldg(sm + so), svo = __ldg(sv + so);
    const float lr_r = __ldg(lr + row), b1c = __ldg(bc1 + row),
                b2c = __ldg(bc2 + row);
    float zm[VPL], zv[VPL];
    float am = 0.f, av = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) zm[i] = zv[i] = 0.f;
    if (V4) {
      const int col = 4 * lane;
      if (col < glen) {  // glen is a multiple of 4 here
        const float4 g4 =
            __ldg(reinterpret_cast<const float4*>(g + xo + col));
        float4 p4 = *reinterpret_cast<const float4*>(p + xo + col);
        const char4 a4 = *reinterpret_cast<const char4*>(qm + xo + col);
        const char4 b4 = *reinterpret_cast<const char4*>(qv + xo + col);
        update_one<SQRT>(g4.x, p4.x, a4.x, b4.x, smo, svo, lr_r, b1c, b2c, c,
                         &p4.x, &zm[0], &zv[0]);
        update_one<SQRT>(g4.y, p4.y, a4.y, b4.y, smo, svo, lr_r, b1c, b2c, c,
                         &p4.y, &zm[1], &zv[1]);
        update_one<SQRT>(g4.z, p4.z, a4.z, b4.z, smo, svo, lr_r, b1c, b2c, c,
                         &p4.z, &zm[2], &zv[2]);
        update_one<SQRT>(g4.w, p4.w, a4.w, b4.w, smo, svo, lr_r, b1c, b2c, c,
                         &p4.w, &zm[3], &zv[3]);
        *reinterpret_cast<float4*>(p + xo + col) = p4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          am = fmaxf(am, fabsf(zm[i]));
          av = fmaxf(av, fabsf(zv[i]));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int col = lane + 32 * i;
        if (col < glen) {
          update_one<SQRT>(__ldg(g + xo + col), p[xo + col], qm[xo + col],
                           qv[xo + col], smo, svo, lr_r, b1c, b2c, c,
                           p + xo + col, &zm[i], &zv[i]);
          am = fmaxf(am, fabsf(zm[i]));
          av = fmaxf(av, fabsf(zv[i]));
        }
      }
    }
    am = warp_max(am);
    av = warp_max(av);
    const float sm1 = __fdiv_rn(am > 0.f ? am : 1.0f, 127.0f);
    const float sv1 = __fdiv_rn(av > 0.f ? av : 1.0f, 127.0f);
    if (V4) {
      const int col = 4 * lane;
      if (col < glen) {
        const float4 a =
            __ldg(reinterpret_cast<const float4*>(um + uo + col));
        const float4 b =
            __ldg(reinterpret_cast<const float4*>(uv + uo + col));
        char4 oa, ob;
        oa.x = encode(zm[0], sm1, a.x);
        oa.y = encode(zm[1], sm1, a.y);
        oa.z = encode(zm[2], sm1, a.z);
        oa.w = encode(zm[3], sm1, a.w);
        ob.x = encode(zv[0], sv1, b.x);
        ob.y = encode(zv[1], sv1, b.y);
        ob.z = encode(zv[2], sv1, b.z);
        ob.w = encode(zv[3], sv1, b.w);
        *reinterpret_cast<char4*>(qm + xo + col) = oa;
        *reinterpret_cast<char4*>(qv + xo + col) = ob;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int col = lane + 32 * i;
        if (col < glen) {
          qm[xo + col] = encode(zm[i], sm1, __ldg(um + uo + col));
          qv[xo + col] = encode(zv[i], sv1, __ldg(uv + uo + col));
        }
      }
    }
    if (lane == 0) {
      sm[so] = sm1;
      sv[so] = sv1;
    }
  }
}

template <int VPL, bool SQRT, bool V4>
void launch(dim3 grid, cudaStream_t st, const float* g, float* p, int8_t* qm,
            float* sm, int8_t* qv, float* sv, const float* um,
            const float* uv, const float* lr, const float* bc1,
            const float* bc2, int m, long long w, int G, int group,
            long long ldx, long long lds, long long ldu, Consts c) {
  adamw_fused_kernel<VPL, SQRT, V4><<<grid, kThreads, 0, st>>>(
      g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2, m, w, G, group, ldx, lds,
      ldu, c);
}

template <bool SQRT>
int dispatch(int vpl, bool v4, dim3 grid, cudaStream_t st, const float* g,
             float* p, int8_t* qm, float* sm, int8_t* qv, float* sv,
             const float* um, const float* uv, const float* lr, const float* bc1,
             const float* bc2, int m, long long w, int G, int group,
             long long ldx, long long lds, long long ldu, Consts c) {
#define ADAMW_CASE(N)                                                        \
  case N:                                                                    \
    launch<N, SQRT, false>(grid, st, g, p, qm, sm, qv, sv, um, uv, lr, bc1,  \
                           bc2, m, w, G, group, ldx, lds, ldu, c);           \
    break;
  if (v4) {
    launch<4, SQRT, true>(grid, st, g, p, qm, sm, qv, sv, um, uv, lr, bc1,
                          bc2, m, w, G, group, ldx, lds, ldu, c);
    return (int)cudaGetLastError();
  }
  switch (vpl) {
    ADAMW_CASE(1)
    ADAMW_CASE(2)
    ADAMW_CASE(4)
    ADAMW_CASE(8)
    ADAMW_CASE(16)
    ADAMW_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ADAMW_CASE
  return (int)cudaGetLastError();
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

}  // namespace

// g (m, w; ldx) f32; p (m, w; ldx) f32, updated in place; qm, qv (m, w; ldx)
// int8 and sm, sv (m, G; lds) f32, updated in place; um, uv (m, w; ldu) f32
// uniforms; lr, bc1, bc2 (m,) f32; transform 0 (linear) or 1 (signed sqrt)
extern "C" int adamw_fused_int8_f32(
    const void* g, void* p, void* qm, void* sm, void* qv, void* sv,
    const void* um, const void* uv, const void* lr, const void* bc1,
    const void* bc2, int m, long long w, int G, int group, long long ldx,
    long long lds, long long ldu, float b1, float omb1, float b2, float omb2,
    float eps, float wd, int transform, void* stream) {
  if (m < 1 || w < 1 || group < 1 || group > 1024 ||
      G != (w + group - 1) / group || ldx < w || lds < G || ldu < w ||
      (transform != 0 && transform != 1))
    return (int)cudaErrorInvalidValue;
  int vpl = 1;
  while (32 * vpl < group) vpl *= 2;
  const long long pairs = (long long)m * G;
  long long blocks = (pairs + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Consts c{b1, omb1, b2, omb2, eps, wd};
  const float* gp = static_cast<const float*>(g);
  float* pp = static_cast<float*>(p);
  int8_t* qmp = static_cast<int8_t*>(qm);
  int8_t* qvp = static_cast<int8_t*>(qv);
  float* smp = static_cast<float*>(sm);
  float* svp = static_cast<float*>(sv);
  const float* ump = static_cast<const float*>(um);
  const float* uvp = static_cast<const float*>(uv);
  const float* lrp = static_cast<const float*>(lr);
  const float* b1p = static_cast<const float*>(bc1);
  const float* b2p = static_cast<const float*>(bc2);
  const bool v4 = group == 128 && w % 4 == 0 && ldx % 4 == 0 &&
                  ldu % 4 == 0 && aligned(gp, 16) && aligned(pp, 16) &&
                  aligned(ump, 16) && aligned(uvp, 16) && aligned(qmp, 4) &&
                  aligned(qvp, 4);
  if (transform == 1)
    return dispatch<true>(vpl, v4, grid, st, gp, pp, qmp, smp, qvp, svp,
                          ump, uvp, lrp, b1p, b2p, m, w, G, group, ldx, lds,
                          ldu, c);
  return dispatch<false>(vpl, v4, grid, st, gp, pp, qmp, smp, qvp, svp, ump,
                         uvp, lrp, b1p, b2p, m, w, G, group, ldx, lds, ldu,
                         c);
}
