// flash_attention.cu -- Hopper (sm_90a) kernels for causal / windowed
// online-softmax attention with grouped-query heads: the forward pass and
// its backward pass.
//
// Replaces the Pallas TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention.py, body _flash_kernel) and the GQA
// expansion of its wrapper (src/repro/kernels/ops.py:flash_attention). The
// Pallas kernel has only the forward pass; the port's train path
// differentiates through attention, so the backward pass is here too.
//
// What it computes (the plain version is kernels/ref.py:flash_attention_ref,
// the loop of src/repro/models/attention.py:_sdpa_blockwise): for each
// batch b, query head h (key/value head h / (H / Kv): GQA by index, K and V
// are never expanded) and query row i,
//   s_j  = (q_i . k_j) * scale                       (float32, scale after the dot)
//   s_j  = NEG_INF where key j is not visible        (a fill, not a bias)
//   visible: k_pos[j] >= 0, causal k_pos[j] <= q_pos[i],
//            window k_pos[j] > q_pos[i] - window
//   online over key tiles: m' = max(m, max_j s_j), p_j = exp(s_j - m'),
//   alpha = exp(m - m'), l = alpha l + sum_j p_j, acc = alpha acc + sum_j
//   p_j v_j (p rounded to v's type first), out_i = acc / max(l, 1e-30),
//   and lse_i = m + log(l) for the backward pass.
// A wholly masked tile is skipped: its p are exp(-1e30 - m) = 0 exactly once
// the row has seen a visible key, so skipping it changes no number. A row
// with no visible key at all is outside the contract (the plain version
// averages the masked keys' v there, the kernel writes 0).
//
// Backward (float32 only): delta_i = sum_c dO_ic O_ic (delta_kernel), then
//   P_ij = exp(s_ij - lse_i) (0 where masked), dP = dO V^T,
//   dS = P o (dP - delta), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.
// dkdv_kernel owns (b, kv head, key tile) and loops over the G query heads
// of its group and over the query tiles; dq_kernel owns (b, h, query tile)
// and loops over the key tiles. Every sum runs in a fixed order and no
// output is shared between blocks: no atomics, the same bits every run.
//
// What bounds it: operations. At the train path's shape (B 2, S 2048, H 16,
// hd 128) the forward does 2 B H S^2 hd flops (the causal half of two
// products) on 4 tensors of 33.5 MB, ~256 flops a byte; the H100's
// float32 rate (67 TFLOP/s) over its memory rate (3.35 TB/s) is 20 flops a
// byte. The products run as plain float32 FMAs on the CUDA cores (no TF32:
// the port's float32 parity with the reference depends on it).
//
// What the design does about it: tiles of 64 queries x 64 keys, 256
// threads, each owning a 4 x 4 micro-tile of the scores and 4 rows of the
// output. Operands sit in shared memory as float32 in the layout each
// product reads with float4 loads: the reduction index major, the thread's
// 4 rows or columns contiguous (a transposed tile [d][64 + 4], or a natural
// one [row][hd + 4]); each step of a product loads 2 float4 for 16 FMAs.
// Row statistics (max, sum) reduce over the 16 lanes of a half-warp that
// share the rows. Tiles above 48 KB of shared memory are raised with
// cudaFuncSetAttribute. Loads are plain (no cp.async / TMA, no wgmma):
// making it fast is later work.
//
// Layout: q (B, Sq, H, hd), k and v (B, Sk, Kv, hd), dO, O alike, hd
// contiguous, element strides for B, S and the head given per tensor (the
// wrapper copies nothing); positions int32 (B, Sq) and (B, Sk); lse and
// delta float32 (B, H, Sq). Forward inputs float32 or bfloat16 (out in
// the input type, accumulated in float32); backward float32.
//
// C interface for ctypes. The kernels allocate nothing and launch on the
// stream they are given; each entry point returns cudaGetLastError() after
// its launches, or cudaErrorInvalidValue for a shape it does not take.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows of a tile
constexpr int BK = 64;          // keys of a tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx) = (t / 16, t % 16)
constexpr int TS = BQ + 4;      // row stride of a transposed tile [d][64 + 4]
constexpr float kNegInf = -1e30f;

struct Strides {  // element strides of a (B, S, heads, hd) tensor
  long long b, s, h;
};

// a thread's output columns: NCH chunks of VW consecutive columns, chunk J
// at J * 16 * VW + tx * VW; the row stride NS of a natural tile [row][hd +
// 4]; BUF floats hold a 64-row tile in either layout
template <int HD>
struct Tile {
  static constexpr int VW = HD >= 64 ? 4 : HD / 16;
  static constexpr int NCH = HD / (16 * VW);
  static constexpr int N = HD / 16;
  static constexpr int NS = HD + 4;
  static constexpr int BUF = HD * TS > BK * NS ? HD * TS : BK * NS;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_as(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}
// p rounded to v's type before its product (the plain version's
// p.to(v.dtype)); exact for float32
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) &&
         (window <= 0 || (long long)kp > (long long)qp - window);
}

// rows [r0, r0 + 64) of head h of batch b -> shared memory as float32, rows
// at or past S as 0; transposed dst[d * TS + r], else dst[r * (HD + 4) + d]
template <int HD, bool TRANS, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          Strides st, int b, int h, int r0,
                                          int S) {
  const T* base = src + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < 64 * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
    if (r0 + r < S) x = to_f32(base[(long long)(r0 + r) * st.s + d]);
    if (TRANS)
      dst[d * TS + r] = x;
    else
      dst[r * Tile<HD>::NS + d] = x;
  }
}

// acc[i][j] += sum_x A[x * TS + i] B[x * TS + j] over i, j < 4: A and B are
// transposed tiles at the thread's 4 rows and 4 columns
__device__ __forceinline__ void mma_tt(float (&acc)[4][4], const float* A,
                                       const float* B, int n) {
#pragma unroll 4
  for (int x = 0; x < n; ++x) {
    const float4 a = *reinterpret_cast<const float4*>(A + x * TS);
    const float4 b = *reinterpret_cast<const float4*>(B + x * TS);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (VW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

// acc[i][c] += sum_x A[x * TS + i] Bn[x * (HD + 4) + col(c)]: A a transposed
// tile at the thread's 4 rows, Bn a natural tile at the thread's first
// column (tx * VW)
template <int HD>
__device__ __forceinline__ void mma_tn(float (&acc)[4][HD / 16],
                                       const float* A, const float* Bn,
                                       int n) {
  using C = Tile<HD>;
#pragma unroll 4
  for (int x = 0; x < n; ++x) {
    const float4 a = *reinterpret_cast<const float4*>(A + x * TS);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float bv[C::N];
#pragma unroll
    for (int J = 0; J < C::NCH; ++J)
      load_vec<C::VW>(Bn + x * Tile<HD>::NS + J * 16 * C::VW,
                      bv + J * C::VW);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
  }
}

// store v[0..3][j] (4 consecutive rows at row0, column col) of a transposed
// tile as one float4
__device__ __forceinline__ void store_col4(float* dst, int col, int row0,
                                           const float (&v)[4][4], int j) {
  *reinterpret_cast<float4*>(dst + col * TS + row0) =
      make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// min and max of pos[r] over r < n with pos[r] >= 0 (all of them when
// !only_valid), into out[0], out[1]; INT_MAX / INT_MIN when there is none.
// Called by every thread; ends with a barrier.
__device__ __forceinline__ void pos_range(const int* pos, int n,
                                          bool only_valid, int* out) {
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = threadIdx.x; r < n; r += 32) {
      if (!only_valid || pos[r] >= 0) {
        lo = min(lo, pos[r]);
        hi = max(hi, pos[r]);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (threadIdx.x == 0) {
      out[0] = lo;
      out[1] = hi;
    }
  }
  __syncthreads();
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ qpos,
               const int* __restrict__ kpos, T* __restrict__ o,
               float* __restrict__ lse, int H, int G, int Sq, int Sk,
               int causal, int window, float scale, Strides sq, Strides sk,
               Strides sv, Strides so) {
  using C = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][TS]
  float* KV = Qt + HD * TS;                     // K transposed, then V natural
  float* Pt = KV + Tile<HD>::BUF;            // P transposed [key][TS]
  int* qp = reinterpret_cast<int*>(Pt + BK * TS);
  int* kp = qp + BQ;
  int* rng = kp + BK;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvh = h / G;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int nq = min(BQ, Sq - q0);
  // rows past Sq repeat the last row's position: computed, never written
  if (t < BQ) qp[t] = qpos[(long long)b * Sq + q0 + min(t, nq - 1)];
  load_tile<HD, true>(Qt, q, sq, b, h, q0, Sq);
  __syncthreads();
  pos_range(qp, nq, false, rng);
  const int qmin = rng[0], qmax = rng[1];

  float m_run[4], l_run[4], acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.f;
  }

  const int nkt = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's KV, Pt and kp are free
    int any = 0;
    if (t < BK) {
      const int kk = k0 + t < Sk ? kpos[(long long)b * Sk + k0 + t] : -1;
      kp[t] = kk;
      // a key some query of the tile may see (necessary, not sufficient)
      any = kk >= 0 && (!causal || kk <= qmax) &&
            (window <= 0 || (long long)kk > (long long)qmin - window);
    }
    if (!__syncthreads_or(any)) continue;  // wholly masked tile
    load_tile<HD, true>(KV, k, sk, b, kvh, k0, Sk);
    __syncthreads();
    float s[4][4] = {};
    mma_tt(s, Qt + ty * 4, KV + tx * 4, HD);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = qp[ty * 4 + i];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(qq, kp[tx * 4 + j], causal, window)
                      ? __fmul_rn(s[i][j], scale)
                      : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      rs = half_warp_sum(rs);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = alpha * l_run[i] + rs;
#pragma unroll
      for (int c = 0; c < C::N; ++c) acc[i][c] *= alpha;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = round_as(s[i][j], v);
    }
    __syncthreads();  // every thread has read K
#pragma unroll
    for (int j = 0; j < 4; ++j) store_col4(Pt, tx * 4 + j, ty * 4, s, j);
    load_tile<HD, false>(KV, v, sv, b, kvh, k0, Sk);
    __syncthreads();
    mma_tn<HD>(acc, Pt + ty * 4, KV + tx * C::VW, BK);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
    T* orow = o + b * so.b + (long long)(q0 + r) * so.s + h * so.h;
#pragma unroll
    for (int J = 0; J < C::NCH; ++J)
#pragma unroll
      for (int jj = 0; jj < C::VW; ++jj)
        store_as(acc[i][J * C::VW + jj] / den,
                 orow + J * 16 * C::VW + tx * C::VW + jj);
    if (tx == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] = m_run[i] + logf(l_run[i]);
  }
}

// delta[b, h, i] = sum_c dO[b, i, h, c] O[b, i, h, c]: a warp a row, the
// lanes' partial sums reduced in a fixed order
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int H, int Sq, int hd,
                 long long rows, Strides so, Strides sdo) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % Sq);
  const int h = (int)((row / Sq) % H);
  const int b = (int)(row / ((long long)Sq * H));
  const float* orow = o + b * so.b + (long long)i * so.s + h * so.h;
  const float* drow = dout + b * sdo.b + (long long)i * sdo.s + h * sdo.h;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(drow[c], orow[c], acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const int* __restrict__ qpos, const int* __restrict__ kpos,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int G, int Sq, int Sk,
                int causal, int window, float scale, Strides sq, Strides sk,
                Strides sv, Strides sdo, Strides sdk, Strides sdv) {
  using C = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [HD][TS], the block's keys
  float* Vt = Kt + HD * TS;                     // [HD][TS]
  float* QA = Vt + HD * TS;                     // Q transposed, then natural
  float* DA = QA + Tile<HD>::BUF;            // dO transposed, then natural
  float* Ps = DA + Tile<HD>::BUF;            // P [query][TS]
  float* dSs = Ps + BQ * TS;                    // dS [query][TS]
  int* qp = reinterpret_cast<int*>(dSs + BQ * TS);
  int* kp = qp + BQ;
  float* lse_s = reinterpret_cast<float*>(kp + BK);
  float* dl_s = lse_s + BQ;
  int* rng = reinterpret_cast<int*>(dl_s + BQ);

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BK;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int nk = min(BK, Sk - k0);
  if (t < BK) kp[t] = t < nk ? kpos[(long long)b * Sk + k0 + t] : -1;
  load_tile<HD, true>(Kt, k, sk, b, kvh, k0, Sk);
  load_tile<HD, true>(Vt, v, sv, b, kvh, k0, Sk);
  __syncthreads();
  pos_range(kp, BK, true, rng);
  const int kmin = rng[0], kmax = rng[1];
  const bool any_key = kmin <= kmax;

  float accK[4][C::N], accV[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::N; ++c) accK[i][c] = accV[i][c] = 0.f;

  const int nqt = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G && any_key; ++g) {
    const int h = kvh * G + g;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's buffers are free
      int any = 0;
      if (t < BQ) {
        const bool ok = q0 + t < Sq;
        const int qq = ok ? qpos[(long long)b * Sq + q0 + t] : 0;
        const long long row = ((long long)b * H + h) * Sq + q0 + t;
        qp[t] = qq;
        lse_s[t] = ok ? lse[row] : 0.f;
        dl_s[t] = ok ? delta[row] : 0.f;
        // a query that may see some key of the tile (necessary)
        any = ok && (!causal || kmin <= qq) &&
              (window <= 0 || (long long)kmax > (long long)qq - window);
      }
      if (!__syncthreads_or(any)) continue;  // wholly masked tile
      load_tile<HD, true>(QA, q, sq, b, h, q0, Sq);
      load_tile<HD, true>(DA, dout, sdo, b, h, q0, Sq);
      __syncthreads();
      // transposed scores: keys ty * 4 + i, queries tx * 4 + j
      float p[4][4] = {}, ds[4][4] = {};
      mma_tt(p, Kt + ty * 4, QA + tx * 4, HD);
      mma_tt(ds, Vt + ty * 4, DA + tx * 4, HD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx * 4 + j;
        const bool row_ok = q0 + qr < Sq;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok =
              row_ok && visible(qp[qr], kp[ty * 4 + i], causal, window);
          p[i][j] = ok ? expf(__fmul_rn(p[i][j], scale) - lse_s[qr]) : 0.f;
          ds[i][j] = p[i][j] * (ds[i][j] - dl_s[qr]);
        }
      }
      __syncthreads();  // every thread has read Q and dO transposed
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        store_col4(Ps, tx * 4 + j, ty * 4, p, j);
        store_col4(dSs, tx * 4 + j, ty * 4, ds, j);
      }
      load_tile<HD, false>(QA, q, sq, b, h, q0, Sq);
      load_tile<HD, false>(DA, dout, sdo, b, h, q0, Sq);
      __syncthreads();
      mma_tn<HD>(accV, Ps + ty * 4, DA + tx * C::VW, BQ);
      mma_tn<HD>(accK, dSs + ty * 4, QA + tx * C::VW, BQ);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nk) continue;
    float* krow = dk + b * sdk.b + (long long)(k0 + r) * sdk.s + kvh * sdk.h;
    float* vrow = dv + b * sdv.b + (long long)(k0 + r) * sdv.s + kvh * sdv.h;
#pragma unroll
    for (int J = 0; J < C::NCH; ++J)
#pragma unroll
      for (int jj = 0; jj < C::VW; ++jj) {
        const int c = J * 16 * C::VW + tx * C::VW + jj;
        krow[c] = accK[i][J * C::VW + jj] * scale;
        vrow[c] = accV[i][J * C::VW + jj];
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const int* __restrict__ qpos, const int* __restrict__ kpos,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int G, int Sq, int Sk,
              int causal, int window, float scale, Strides sq, Strides sk,
              Strides sv, Strides sdo, Strides sdq) {
  using C = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][TS]
  float* dOt = Qt + HD * TS;                    // [HD][TS]
  float* Kb = dOt + HD * TS;                    // K transposed, then natural
  float* Vt = Kb + Tile<HD>::BUF;            // [HD][TS]
  float* dSt = Vt + HD * TS;                    // dS transposed [key][TS]
  int* qp = reinterpret_cast<int*>(dSt + BK * TS);
  int* kp = qp + BQ;
  float* lse_s = reinterpret_cast<float*>(kp + BK);
  float* dl_s = lse_s + BQ;
  int* rng = reinterpret_cast<int*>(dl_s + BQ);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvh = h / G;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int nq = min(BQ, Sq - q0);
  if (t < BQ) {
    const long long row = ((long long)b * H + h) * Sq + q0 + t;
    qp[t] = qpos[(long long)b * Sq + q0 + min(t, nq - 1)];
    lse_s[t] = t < nq ? lse[row] : 0.f;
    dl_s[t] = t < nq ? delta[row] : 0.f;
  }
  load_tile<HD, true>(Qt, q, sq, b, h, q0, Sq);
  load_tile<HD, true>(dOt, dout, sdo, b, h, q0, Sq);
  __syncthreads();
  pos_range(qp, nq, false, rng);
  const int qmin = rng[0], qmax = rng[1];

  float acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::N; ++c) acc[i][c] = 0.f;

  const int nkt = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's buffers are free
    int any = 0;
    if (t < BK) {
      const int kk = k0 + t < Sk ? kpos[(long long)b * Sk + k0 + t] : -1;
      kp[t] = kk;
      any = kk >= 0 && (!causal || kk <= qmax) &&
            (window <= 0 || (long long)kk > (long long)qmin - window);
    }
    if (!__syncthreads_or(any)) continue;  // wholly masked tile
    load_tile<HD, true>(Kb, k, sk, b, kvh, k0, Sk);
    load_tile<HD, true>(Vt, v, sv, b, kvh, k0, Sk);
    __syncthreads();
    float p[4][4] = {}, ds[4][4] = {};
    mma_tt(p, Qt + ty * 4, Kb + tx * 4, HD);
    mma_tt(ds, dOt + ty * 4, Vt + tx * 4, HD);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qp[r], kp[tx * 4 + j], causal, window);
        p[i][j] = ok ? expf(__fmul_rn(p[i][j], scale) - lse_s[r]) : 0.f;
        ds[i][j] = p[i][j] * (ds[i][j] - dl_s[r]);
      }
    }
    __syncthreads();  // every thread has read K transposed
#pragma unroll
    for (int j = 0; j < 4; ++j) store_col4(dSt, tx * 4 + j, ty * 4, ds, j);
    load_tile<HD, false>(Kb, k, sk, b, kvh, k0, Sk);
    __syncthreads();
    mma_tn<HD>(acc, dSt + ty * 4, Kb + tx * C::VW, BK);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    float* row = dq + b * sdq.b + (long long)(q0 + r) * sdq.s + h * sdq.h;
#pragma unroll
    for (int J = 0; J < C::NCH; ++J)
#pragma unroll
      for (int jj = 0; jj < C::VW; ++jj)
        row[J * 16 * C::VW + tx * C::VW + jj] =
            acc[i][J * C::VW + jj] * scale;
  }
}

constexpr size_t kIntBytes = sizeof(int) * (BQ + BK + 2 * BQ + 4);

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (HD * TS + Tile<HD>::BUF + BK * TS) + kIntBytes;
}
template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * HD * TS + 2 * Tile<HD>::BUF + 2 * BQ * TS) +
         kIntBytes;
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (3 * HD * TS + Tile<HD>::BUF + BK * TS) +
         kIntBytes;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <int HD, typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, void* o, float* lse, int B, int H, int Kv,
                int Sq, int Sk, int causal, int window, float scale,
                const long long* st, cudaStream_t stream) {
  const size_t smem = fwd_smem<HD>();
  cudaError_t e = allow_smem(fwd_kernel<HD, T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fwd_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(o), lse, H,
      H / Kv, Sq, Sk, causal, window, scale, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3));
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd(const float* q, const float* k, const float* v,
                const float* o, const float* dout, const int* qpos,
                const int* kpos, const float* lse, float* delta, float* dq,
                float* dk, float* dv, int B, int H, int Kv, int Sq, int Sk,
                int causal, int window, float scale, const long long* st,
                cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  const long long warps = kThreads / 32;
  delta_kernel<<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                 stream>>>(o, dout, delta, H, Sq, HD, rows, strides_at(st, 3),
                           strides_at(st, 4));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int G = H / Kv;
  const size_t s1 = dkdv_smem<HD>();
  if ((e = allow_smem(dkdv_kernel<HD>, s1)) != cudaSuccess) return e;
  dkdv_kernel<HD><<<dim3((Sk + BK - 1) / BK, Kv, B), kThreads, s1, stream>>>(
      q, k, v, dout, qpos, kpos, lse, delta, dk, dv, H, G, Sq, Sk, causal,
      window, scale, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 4), strides_at(st, 6), strides_at(st, 7));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t s2 = dq_smem<HD>();
  if ((e = allow_smem(dq_kernel<HD>, s2)) != cudaSuccess) return e;
  dq_kernel<HD><<<dim3((Sq + BQ - 1) / BQ, H, B), kThreads, s2, stream>>>(
      q, k, v, dout, qpos, kpos, lse, delta, dq, H, G, Sq, Sk, causal, window,
      scale, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 4), strides_at(st, 5));
  return cudaGetLastError();
}

bool shape_ok(int B, int H, int Kv, int Sq, int Sk) {
  return B >= 1 && H >= 1 && Kv >= 1 && H % Kv == 0 && Sq >= 1 && Sk >= 1 &&
         B <= 65535 && H <= 65535;
}

}  // namespace

// q (B, Sq, H, hd), k, v (B, Sk, Kv, hd), float32 (bf16 == 0) or bfloat16;
// positions int32 (B, Sq), (B, Sk); -> o (B, Sq, H, hd) in the input type,
// lse (B, H, Sq) float32. strides: 12 element strides (b, s, head) of q, k,
// v, o. window <= 0: none. hd one of 16, 32, 64, 128.
extern "C" int flash_attention_fwd(int bf16, const void* q, const void* k,
                                   const void* v, const void* qpos,
                                   const void* kpos, void* o, void* lse,
                                   int B, int H, int Kv, int Sq, int Sk,
                                   int hd, int causal, int window,
                                   float scale, const long long* strides,
                                   void* stream) {
  if (!shape_ok(B, H, Kv, Sq, Sk)) return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(HD)                                                             \
  return (int)(bf16 ? fwd<HD, __nv_bfloat16>(q, k, v, qp, kp, o, l, B, H,   \
                                             Kv, Sq, Sk, causal, window,    \
                                             scale, strides, s)             \
                    : fwd<HD, float>(q, k, v, qp, kp, o, l, B, H, Kv, Sq,   \
                                     Sk, causal, window, scale, strides, s))
  switch (hd) {
    case 16: FWD(16);
    case 32: FWD(32);
    case 64: FWD(64);
    case 128: FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD
}

// float32 throughout: q, k, v, o, dout as in the forward; lse (B, H, Sq)
// from it; delta (B, H, Sq) scratch; -> dq (B, Sq, H, hd), dk, dv (B, Sk,
// Kv, hd). strides: 24 element strides (b, s, head) of q, k, v, o, dout,
// dq, dk, dv.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* qpos,
                                   const void* kpos, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int H, int Kv, int Sq, int Sk,
                                   int hd, int causal, int window,
                                   float scale, const long long* strides,
                                   void* stream) {
  if (!shape_ok(B, H, Kv, Sq, Sk)) return (int)cudaErrorInvalidValue;
#define BWD(HD)                                                               \
  return (int)bwd<HD>(                                                        \
      static_cast<const float*>(q), static_cast<const float*>(k),             \
      static_cast<const float*>(v), static_cast<const float*>(o),             \
      static_cast<const float*>(dout), static_cast<const int*>(qpos),         \
      static_cast<const int*>(kpos), static_cast<const float*>(lse),          \
      static_cast<float*>(delta), static_cast<float*>(dq),                    \
      static_cast<float*>(dk), static_cast<float*>(dv), B, H, Kv, Sq, Sk,     \
      causal, window, scale, strides, static_cast<cudaStream_t>(stream))
  switch (hd) {
    case 16: BWD(16);
    case 32: BWD(32);
    case 64: BWD(64);
    case 128: BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD
}
