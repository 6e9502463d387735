// flash_attention16.cu -- Hopper (sm_90a) flash attention kernels for
// bfloat16 and float16 q, k, v: the forward pass and its backward pass,
// with every product on the tensor cores at their 16-bit rate. The
// libraries flash_attention_bf16.cu and flash_attention_f16.cu define
// FLASH_ELEMENT and include this file; flash_attention.cu holds the
// float32 kernels (split TF32) and states the function both compute.
//
// Replaces, for 16-bit inputs, the Pallas TPU kernel flash_attention_bh
// (src/repro/kernels/flash_attention.py, body _flash_kernel) and its GQA
// wrapper (src/repro/kernels/ops.py:flash_attention); the backward has no
// Pallas counterpart (the port's train path differentiates through it).
//
// The function: flash_attention.cu's header (kernels/ref.py:
// flash_attention_ref), the same contract: GQA by index, positions,
// k_pos < 0 as "no key", causal and windowed masks, the NEG_INF fill, the
// float32 lse and row sums, every sum in float32, each output rounded once
// to the inputs' type; the same C interface and strides.
//
// Numerics. Every product takes 16-bit operands with float32 sums, as
// mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16} and
// wgmma.mma_async.sync.aligned.m64nNk16.f32.{bf16,f16} do:
//   S = Q K^T and dP = dO V^T are exact products of the inputs, summed in
//   float32; the scores are scaled after the dot (s * scale, rounded);
//   P = exp(s - m) (forward) or exp(s - lse) (backward) is float32, its
//   row sums l are float32 sums of the unrounded P, and P is rounded once
//   to v's type (the inputs' type) before P V and dV = P^T dO, as the
//   plain version's p.to(v.dtype);
//   dS = P o (dP - delta) is float32, rounded once to the inputs' type
//   before dK = scale dS^T Q and dQ = scale dS K.
// The plain 16-bit version rounds every einsum to the inputs' type; these
// kernels round only P and dS, and each output once, so they lie closer to
// the float32 yardstick than it does (tests/test_torch_flash16.py emulates
// this rounding on the CPU; chip_smoke.py's phase 3 measures it on the
// card). The accumulators chain over tiles on the tensor cores (the
// truncating accumulation that the float32 route avoids with a fresh
// accumulator a tile): measured against the 16-bit gate, not assumed.
//
// What bounds it: operations. The forward does 4 hd flops a visible pair
// (S, P V), the backward 10 (S, dP, dV, dK, dQ) at the function's bound;
// at the train path's shape (B 2, S 2048, H 16, hd 128) that is ~500 and
// ~600 flops a byte moved, above the H100's ~295 flops a byte at 989
// TFLOP/s. So the tiles stay 16-bit from device memory to the tensor
// cores: 16-byte cp.async straight from the rows into shared memory
// (zero-filled past S). P and dS go from the C fragment of one product to
// the A fragment of the next in registers (lane (g, t) holds columns 2t,
// 2t + 1 and 2t + 8, 2t + 9 of each 16 columns: m16n8k16's A layout, which
// is also each warp's part of wgmma's A from registers), packed to 16-bit
// pairs.
// Two routes to the tensor cores:
//   wgmma (the forward, fwd16_kernel): a warpgroup of 4 warps issues
//   S = Q K^T for 64 query rows with Q and K read by wgmma from shared
//   memory, and P V with P from its registers and V from shared memory
//   (transposed by the instruction); the tiles lie in wgmma's 128-byte
//   swizzle, addressed by matrix descriptors.
//   mma.sync (the backward): fragments by ldmatrix (and ldmatrix.trans for
//   the operands read along their rows: dO in dV, Q in dK, K in dQ) from
//   rows padded to a bank-conflict-free stride. A wgmma backward (five
//   products, three transposed operands) is later work.
//
// Tiles: at least 8 warps an SM at every head dim, no spills (the tile
// sizes below).
//   forward  a block owns (b, h, 64 NWG queries), NWG warpgroups of 64
//            rows (one, two blocks an SM at hd 96 and 128; two, one block
//            at hd 16, 32, 64 and 256: kWgGroups); Q resident, the key
//            tile (64 keys, + positions) and the value tile in a two-slot
//            ring: keys k + 1 load while tile k's P V runs, values k + 1
//            while tile k + 1's S runs; every tile in wgmma's 128-byte
//            swizzle (rows of 64-column atoms, chunk j of row r at
//            j ^ (r % 8)), hd 16, 32 and 96 in whole atoms of which they
//            fill a part (kWgCols: S takes hd's k-steps, P V computes the
//            atoms' columns and stores hd of them). (Issuing S of tile
//            k + 1 with P V of tile k over two stages of both tiles
//            measured 1.4-2.0x slower.)
//   backward (mma.sync, 4-warp blocks, two an SM; rows padded by 8 values,
//            16 bytes: a row stride of hd / 2 + 4 words, 4 or 20 (mod 32),
//            so ldmatrix's 8 rows of 16 bytes cover the 32 banks)
//   dK/dV    a block owns (b, kv head, 64 keys, DC columns of dK and dV,
//            a part of the group's heads): K and V resident, slot 0 the
//            query tile (64 queries; 32 from hd 128; + positions, lse),
//            slot 1 dO (+ delta); S^T and dP^T over the whole hd, dK +=
//            dS^T Q and dV += P^T dO over the block's columns, both
//            accumulators in registers. DC = hd up to hd 128 (no
//            workspace, no reduction); at hd 256 two column blocks of 128
//            (two accumulators of hd 256 floats a thread would not fit the
//            registers; each column block recomputes S^T and dP^T: 12 hd
//            operations a pair against 8), and the heads in parts
//            (bwd_parts) whose float32 partial sums go through the
//            workspace to dkdv_reduce_kernel.
//   dQ       a block owns (b, h, 64 queries): Q and dO resident, slot 0 the
//            key tile (64 keys; 32 at hd 256), slot 1 the value tile; dP
//            (values) first, then S and dQ += dS K (keys).
// Each block builds the bitmaps of the tiles that hold a visible pair
// (only those are loaded) and of those that need no mask, as the float32
// kernels do; blocks run the longest tiles first.
//
// Determinism: every output element is written by one thread of one block
// after sums in a fixed order (tiles ascending, the mma sequence, shuffles
// in a fixed pattern, dK/dV's parts added in ascending order): the same
// bits on every run; no atomics in a sum.

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kKeys16 = 64;  // dK/dV's key rows

// The tiles by head dim: the largest that keep every kernel free of spills
// at 8 warps an SM (ptxas, H100 80GB HBM3 at 700 W; the alternatives'
// times: PERF.md §6). dK/dV's query tile (32 from hd 128: 64 spilled
// 32-56 bytes a thread beside the two accumulators) and the columns of dK
// and dV a block accumulates; dQ's key tile
template <int HD>
constexpr int kDkdvQ = HD >= 128 ? 32 : 64;
template <int HD>
constexpr int kDkdvCols = HD > 128 ? 128 : HD;
template <int HD>
constexpr int kDqKeys = HD > 128 ? 32 : 64;

template <int HD>
constexpr int kStride = HD + 8;  // a tile row's elements (16 bytes of pad)

// ---- 16-bit products -----------------------------------------------------

// d += a b, one m16n8k16 product of 16-bit operands, float32 sums
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x, y rounded once to T, x in the low half (the lower column)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  uint32_t u;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    u = *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(x, y);
    u = *reinterpret_cast<const uint32_t*>(&h);
  }
  return u;
}

// four 8 x 8 16-bit matrices of shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i holds matrix i, lane (g, t) its
// row g, columns 2t, 2t + 1 (ldsm4t: its column g, rows 2t, 2t + 1)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A lane's offset into a tile [rows][kStride<HD>] for ldsm4 of an A
// fragment (rows 0-15 x k 0-15: matrices rows 0-7 / 8-15, then k 8-15) and
// for ldsm4t of the B fragments of two n-tiles from a [k][n] tile (k 0-15
// x n 0-15: matrices k 0-7 / 8-15 of n-tile 0, then of n-tile 1)
template <int HD>
__device__ __forceinline__ int a_offset() {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * kStride<HD> + 8 * (lane >> 4);
}
// ... and for ldsm4 of the B fragments of two n-tiles from an [n][k] tile
// (n 0-7: k 0-7, k 8-15; then n 8-15)
template <int HD>
__device__ __forceinline__ int b_offset() {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + 8 * (lane >> 4)) * kStride<HD> + 8 * ((lane >> 3) & 1);
}

// 2^x, one MUFU instruction (relative error ~2^-22; results below 2^-126
// flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// acc[j] (+)= A B_j^T over the HD columns, 16 x 8 each in C layout: A the
// warp's 16 rows of one tile, B_j rows 8j .. 8j + 7 of another, both
// [row][kStride] with hd along the row
template <int HD, int NT, typename T>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* A,
                                        const T* B) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
  const int ao = a_offset<HD>(), bo = b_offset<HD>();
  zero(acc);
#pragma unroll
  for (int k = 0; k < HD; k += 16) {
    uint32_t a[4];
    ldsm4(a, A + ao + k);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4(b, B + bo + 8 * j * kStride<HD> + k);
      mma16<T>(acc[j], a, b[0], b[1]);
      mma16<T>(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// C-layout fragments x[KS * 2][4] (16 rows x 16 KS columns, float32) as
// the A operand of the next product: KS k-steps, each rounded once to T
template <int KS, typename T>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4],
                                     const float (&x)[2 * KS][4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    a[s][0] = pack2<T>(x[2 * s][0], x[2 * s][1]);
    a[s][1] = pack2<T>(x[2 * s][2], x[2 * s][3]);
    a[s][2] = pack2<T>(x[2 * s + 1][0], x[2 * s + 1][1]);
    a[s][3] = pack2<T>(x[2 * s + 1][2], x[2 * s + 1][3]);
  }
}

// acc[n] += P B over DC columns (n < DC / 8): P the A fragments of KS
// k-steps (16 rows each), B [k][kStride] with its DC columns from where B
// points, read transposed
template <int HD, int DC, int KS, typename T>
__device__ __forceinline__ void mma_pb(float (&acc)[DC / 8][4],
                                       const uint32_t (&p)[KS][4],
                                       const T* B) {
  const int ao = a_offset<HD>();
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int n = 0; n < DC / 8; n += 2) {
      uint32_t b[4];
      ldsm4t(b, B + ao + 16 * s * kStride<HD> + 8 * n);
      mma16<T>(acc[n], p[s], b[0], b[1]);
      mma16<T>(acc[n + 1], p[s], b[2], b[3]);
    }
}

// rows r0 .. r0 + R - 1 of a (b, head) slice (row stride ss elements, hd
// contiguous) -> dst [R][kStride], rows at or past S as 0; r0 < S; by the
// block's threads, 16-byte cp.async (src-size 0 past S)
template <int HD, int R, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss,
                                          int r0, int S) {
  constexpr int C = HD / 8, N = R * C, PER = (N + kThreads - 1) / kThreads;
#pragma unroll(PER > 8 ? 4 : PER)
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * kThreads, r = e / C, c = e % C;
    if (N % kThreads == 0 || e < N) {
      const bool ok = r0 + r < S;
      cp16(dst + r * kStride<HD> + 8 * c,
           src + (long long)(ok ? r0 + r : r0) * ss + 8 * c, ok);
    }
  }
}

// ---- forward -------------------------------------------------------------

// The online softmax over one key tile of an m-tile's rows: the scaled and
// masked scores s, in base-2 units (s scale log2(e); C layout: rows g,
// g + 8 in r = 0, 1; a row's keys over the 4 lanes of its quad) become
// p = 2^(s - m') = exp of the natural scores' difference (float32; l sums
// them unrounded); m and l move to the tile's, and alpha = 2^(m - m') is
// what the accumulator is scaled by.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = ex2(s[j][e] - m_new);
        rs += s[j][e];
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    alpha[r] = ex2(m_run[r] - m_new);
    l_run[r] = alpha[r] * l_run[r] + rs;
    m_run[r] = m_new;
  }
}

// d (+)= A B^T, m64n64k16: A (64 x 16) and B (64 x 16) K-major in shared
// memory (descriptors da, db); d zeroed first where scale_d is 0
template <typename T>
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n64k16: A (64 x 16) in registers (each warp its 16 rows
// in mma.sync's A layout), B (16 x 64) MN-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_rs64(float (&d)[8][4],
                                          const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n128k16: A (64 x 16) in registers (each warp its 16 rows
// in mma.sync's A layout), B (16 x 128) MN-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_rs128(float (&d)[16][4],
                                          const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n256k16: A (64 x 16) in registers (each warp its 16 rows
// in mma.sync's A layout), B (16 x 256) MN-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_rs256(float (&d)[32][4],
                                          const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the forward on wgmma ------------------------------------------------

// a tile row's columns in shared memory: hd rounded up to whole 64-column
// swizzle atoms (hd 16 and 32 to 64, hd 96 to 128; the columns past hd are
// never loaded: S reads only hd's k-steps, and P V's columns past hd are
// never stored)
template <int HD>
constexpr int kWgCols = (HD + 63) / 64 * 64;
// warpgroups a block (64 query rows each) and blocks an SM: at 128 columns
// one warpgroup, two blocks (200 registers a thread; 0.151 ms at hd 128's
// timed shape against 0.161 for one block of two), else one block of two
// (hd 256: 0.117 against 0.137; hd 64: 0.051 against 0.056; H100 80GB
// HBM3 at 700 W; PERF.md §6)
template <int HD>
constexpr int kWgGroups = kWgCols<HD> == 128 ? 1 : 2;
template <int HD>
constexpr int kWgBlocks = kWgCols<HD> == 128 ? 2 : 1;
template <int HD>
constexpr int kWgThreads = 128 * kWgGroups<HD>;
constexpr int kWgKeys = 64;  // the key tile

// wgmma's 128-byte swizzle: a tile [R][HD] of 16-bit values lies as HD / 64
// atoms of [R][64] (128 bytes a row), row r's 16-byte chunk j at chunk
// j ^ (r % 8); each atom starts on 1024 bytes
template <int R>
__device__ __forceinline__ int sw_offset(int r, int c) {  // c: 16-byte chunk
  return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// rows r0 .. r0 + R - 1 of a (b, head) slice -> dst in the swizzled layout,
// rows at or past S as 0; by the block's NTH threads
template <int HD, int R, int NTH, typename T>
__device__ __forceinline__ void load_tile_sw(T* dst, const T* src,
                                             long long ss, int r0, int S) {
  constexpr int C = HD / 8, N = R * C, PER = (N + NTH - 1) / NTH;
#pragma unroll(PER > 8 ? 4 : PER)
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * NTH, r = e / C, c = e % C;
    if (N % NTH == 0 || e < N) {
      const bool ok = r0 + r < S;
      cp16(reinterpret_cast<char*>(dst) + sw_offset<R>(r, c),
           src + (long long)(ok ? r0 + r : r0) * ss + 8 * c, ok);
    }
  }
}

// a shared-memory matrix descriptor with the 128-byte swizzle; lbo and sbo
// in bytes
__device__ __forceinline__ uint64_t sw_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// the async proxy (wgmma) sees this thread's shared-memory writes
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// ties the registers to this point: reads and writes of x stay on their
// side of the wgmma issue and wait around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[n][e])::"memory");
}

template <int HD, typename T>
__device__ __forceinline__ void wgmma_pv(float (&acc)[HD / 8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs64<T>(acc, a, db);
  else if constexpr (HD == 128)
    wgmma_rs128<T>(acc, a, db);
  else
    wgmma_rs256<T>(acc, a, db);
}

// a block owns (b, h, 64 NWG queries): warpgroup wg its 64, each warp 16
// (mma.sync's C / A fragment layouts); S = Q K^T by wgmma from shared
// memory, P V by wgmma with P from registers
template <int HD, typename T>
__global__ void __launch_bounds__(kWgThreads<HD>, kWgBlocks<HD>)
    fwd16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ o,
                 float* __restrict__ lse, int B, int H, int G, int Sq,
                 int Sk, int causal, int window, float scale, Strides sq,
                 Strides sk, Strides sv, Strides so) {
  static_assert(HD % 16 == 0, "whole k-steps");
  constexpr int NTH = kWgThreads<HD>, BM = 64 * kWgGroups<HD>, BK = kWgKeys;
  constexpr int HP = kWgCols<HD>, NT = BK / 8, NO = HP / 8;
  extern __shared__ uint4 smem16[];
  // the tiles on 1024 bytes (the swizzle's period)
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem16);
  char* sm = reinterpret_cast<char*>(smem16) + ((1024 - (base & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(sm);            // [BM][HP], swizzled
  T* Ks = Qs + BM * HP;                        // slot 0: keys [BK][HP]
  T* Vs = Ks + BK * HP;                        // slot 1: values [BK][HP]
  int* kp = reinterpret_cast<int*>(Vs + BK * HP);
  int* qp = kp + BK;
  int* rng = qp + BM;
  const int nqt = (Sq + BM - 1) / BM, nkt = (Sk + BK - 1) / BK;
  unsigned* live = reinterpret_cast<unsigned*>(rng + 4);
  unsigned* part = live + bitmap_words(nkt);

  const int bh = blockIdx.x % (B * H);
  const int qt = nqt - 1 - blockIdx.x / (B * H);  // longest first
  const int h = bh % H, b = bh / H, kvh = h / G, q0 = qt * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int row0 = 16 * warp;  // the warp's first row (warpgroup wg: 64 wg ..)
  const int nq = min(BM, Sq - q0);
  const int* kpb = kpos + (long long)b * Sk;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int i = threadIdx.x; i < BM; i += NTH)
    qp[i] = qpos[(long long)b * Sq + q0 + min(i, nq - 1)];
  load_tile_sw<HD, BM, NTH>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  cp_commit();
  __syncthreads();
  pos_range(qp, nq, false, rng);
  const int qmin = rng[0], qmax = rng[1];
  mark_tiles<BK, NTH>(
      live, part, nkt, kpb, Sk,
      [&](int kk) {
        return kk >= 0 && (!causal || kk <= qmax) &&
               (window <= 0 || (long long)kk > (long long)qmin - window);
      },
      [&](int kk) {
        return kk >= 0 && (!causal || kk <= qmin) &&
               (window <= 0 || (long long)kk > (long long)qmax - window);
      });
  int kt = next_live(live, 0, nkt);
  if (kt < nkt) {
    load_tile_sw<HD, BK, NTH>(Ks, kb, sk.s, kt * BK, Sk);
    load_vals(kp, kpb, 0, BK, kt * BK, Sk);
  }
  cp_commit();
  if (kt < nkt) load_tile_sw<HD, BK, NTH>(Vs, vb, sv.s, kt * BK, Sk);
  cp_commit();

  const int qrow[2] = {qp[row0 + g], qp[row0 + g + 8]};
  const float scale2 = scale * kLog2e;  // the scores in base-2 units
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[NO][4];
  zero(acc);

  while (kt < nkt) {
    const int k0 = kt * BK;
    cp_wait<1>();  // Q, this tile's keys and positions
    fence_async_shared();
    __syncthreads();
    float s[NT][4];
    zero(s);
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss64<T>(
          s,
          sw_desc(reinterpret_cast<char*>(Qs) + (ks >> 2) * BM * 128 +
                      wg * 64 * 128 + (ks & 3) * 32,
                  16, 1024),
          sw_desc(reinterpret_cast<char*>(Ks) + (ks >> 2) * BK * 128 +
                      (ks & 3) * 32,
                  16, 1024),
          ks);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    const bool full = !bit_set(part, kt) && k0 + BK <= Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        s[j][e] = full || (k0 + c < Sk &&
                           visible(qrow[e >> 1], kp[c], causal, window))
                      ? __fmul_rn(s[j][e], scale2)
                      : kNegInf;
      }
    __syncthreads();  // every warp is done with slot 0
    const int next = next_live(live, kt + 1, nkt);
    if (next < nkt) {
      load_tile_sw<HD, BK, NTH>(Ks, kb, sk.s, next * BK, Sk);
      load_vals(kp, kpb, 0, BK, next * BK, Sk);
    }
    cp_commit();
    float alpha[2];
    online_softmax(s, m_run, l_run, alpha);
    uint32_t pa[BK / 16][4];
    to_a<BK / 16, T>(pa, s);  // p rounded to v's type
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    cp_wait<1>();  // this tile's values
    fence_async_shared();
    __syncthreads();
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int ps = 0; ps < BK / 16; ++ps)
      wgmma_pv<HP, T>(acc, pa[ps],
                      sw_desc(reinterpret_cast<char*>(Vs) + ps * 16 * 128,
                              BK * 128, 1024));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    __syncthreads();  // every warp is done with slot 1
    if (next < nkt) load_tile_sw<HD, BK, NTH>(Vs, vb, sv.s, next * BK, Sk);
    cp_commit();
    kt = next;
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= nq) continue;
    const float den = fmaxf(l_run[r], 1e-30f);
    T* orow = o + b * so.b + (long long)(q0 + row) * so.s + h * so.h + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(orow + 8 * n, acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    if (t == 0)
      lse[((long long)b * H + h) * Sq + q0 + row] =
          fmaf(m_run[r], kLn2, logf(l_run[r]));
  }
}

// ---- backward ------------------------------------------------------------

// A block owns (b, kv head, 64 keys, columns c0 .. c0 + DC - 1 of dK and
// dV, heads part * Gp .. part * Gp + Gp - 1 of the group) and loops over
// those heads and their live query tiles; each warp 16 keys. dK (unscaled)
// and dV go to the workspace ws as float32 partial sums where the heads
// are in parts (ws != null; dkdv_reduce_kernel adds them), else to dk, dv,
// rounded once.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    dkdv16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const int* __restrict__ qpos, const int* __restrict__ kpos,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, float* __restrict__ ws, int B, int H,
                  int Kv, int G, int Gp, int Sq, int Sk, int causal,
                  int window, float scale, Strides sq, Strides sk, Strides sv,
                  Strides sdo, Strides sdk, Strides sdv) {
  constexpr int RS = kStride<HD>, BQ = kDkdvQ<HD>, NT = BQ / 8;
  constexpr int DC = kDkdvCols<HD>, NCB = HD / DC, KR = kKeys16;
  extern __shared__ uint4 smem16[];
  T* Ks = reinterpret_cast<T*>(smem16);  // [KR][RS], the block's keys
  T* Vs = Ks + KR * RS;                  // [KR][RS]
  T* Qs = Vs + KR * RS;                  // slot 0: queries [BQ][RS]
  T* dOs = Qs + BQ * RS;                 // slot 1: dO [BQ][RS]
  int* qp = reinterpret_cast<int*>(dOs + BQ * RS);  // slot 0
  float* ls = reinterpret_cast<float*>(qp + BQ);    // slot 0: lse
  float* dl = ls + BQ;                              // slot 1: delta
  int* kp = reinterpret_cast<int*>(dl + BQ);
  int* rng = kp + KR;
  const int nqt = (Sq + BQ - 1) / BQ;
  unsigned* live = reinterpret_cast<unsigned*>(rng + 4);
  unsigned* part = live + bitmap_words(nqt);

  // the first key tiles see the most queries under a causal mask
  const int bk = blockIdx.x % (B * Kv);
  int rest = blockIdx.x / (B * Kv);
  const int cb = rest % NCB;
  rest /= NCB;
  const int parts = G / Gp, pi = rest % parts, kt = rest / parts;
  const int kvh = bk % Kv, b = bk / Kv, k0 = kt * KR, c0 = cb * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = min(KR, Sk - k0);
  const int* qpb = qpos + (long long)b * Sq;

  if (threadIdx.x < KR)
    kp[threadIdx.x] = (int)threadIdx.x < nk
                          ? kpos[(long long)b * Sk + k0 + threadIdx.x]
                          : -1;
  load_tile<HD, KR>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, Sk);
  load_tile<HD, KR>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, Sk);
  cp_commit();
  __syncthreads();
  pos_range(kp, KR, true, rng);
  const int kmin = rng[0], kmax = rng[1];
  const bool any_key = kmin <= kmax;
  // every one of the 64 keys valid (none past Sk, no negative position)
  const bool all_keys =
      !__syncthreads_or(threadIdx.x < KR && kp[threadIdx.x] < 0);
  mark_tiles<BQ>(
      live, part, nqt, qpb, Sq,
      [&](int qq) {
        return any_key && (!causal || kmin <= qq) &&
               (window <= 0 || (long long)kmax > (long long)qq - window);
      },
      [&](int qq) {
        return all_keys && (!causal || kmax <= qq) &&
               (window <= 0 || (long long)kmin > (long long)qq - window);
      });

  // the (head of the part, query tile) pairs in order, live tiles only
  int gi = 0, qt = next_live(live, 0, nqt);
  if (qt == nqt) gi = Gp;
  auto load_q = [&](int gg, int tt) {
    const int hh = kvh * G + pi * Gp + gg, r0 = tt * BQ;
    load_tile<HD, BQ>(Qs, q + b * sq.b + hh * sq.h, sq.s, r0, Sq);
    load_vals(qp, qpb, 0, BQ, r0, Sq);
    load_vals(ls, lse + ((long long)b * H + hh) * Sq, BQ, BQ, r0, Sq);
  };
  auto load_do = [&](int gg, int tt) {
    const int hh = kvh * G + pi * Gp + gg, r0 = tt * BQ;
    load_tile<HD, BQ>(dOs, dout + b * sdo.b + hh * sdo.h, sdo.s, r0, Sq);
    load_vals(dl, delta + ((long long)b * H + hh) * Sq, 0, BQ, r0, Sq);
  };
  if (gi < Gp) load_q(gi, qt);
  cp_commit();
  if (gi < Gp) load_do(gi, qt);
  cp_commit();

  const int krow[2] = {kp[16 * warp + g], kp[16 * warp + g + 8]};
  const float scale2 = scale * kLog2e;  // P = 2^(s scale2 - lse log2(e))
  const T* Kw = Ks + 16 * warp * RS;
  const T* Vw = Vs + 16 * warp * RS;
  float accK[DC / 8][4], accV[DC / 8][4];
  zero(accK);
  zero(accV);

  while (gi < Gp) {
    const int q0 = qt * BQ;
    cp_wait<1>();  // K, V, this tile's queries, positions and lse
    __syncthreads();
    float p[NT][4], ds[NT][4];
    // transposed scores: keys (rows) x queries (columns)
    mma_abt<HD, NT>(p, Kw, Qs);
    const bool full = !bit_set(part, qt) && q0 + BQ <= Sq;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        p[j][e] = full || (q0 + c < Sq &&
                           visible(qp[c], krow[e >> 1], causal, window))
                      ? ex2(fmaf(p[j][e], scale2, -kLog2e * ls[c]))
                      : 0.f;
      }
    cp_wait<0>();  // this tile's dO and delta
    __syncthreads();
    mma_abt<HD, NT>(ds, Vw, dOs);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        ds[j][e] = p[j][e] * (ds[j][e] - dl[c]);
      }
    // P rounded to v's type and dS to the inputs' type, packed as A
    // fragments (their float32 registers free before the products)
    uint32_t pa[NT / 2][4], da[NT / 2][4];
    to_a<NT / 2, T>(pa, p);
    to_a<NT / 2, T>(da, ds);
    mma_pb<HD, DC, NT / 2>(accK, da, Qs + c0);
    int ngi = gi, nqt2 = next_live(live, qt + 1, nqt);
    if (nqt2 == nqt) {
      ++ngi;
      nqt2 = next_live(live, 0, nqt);
    }
    __syncthreads();  // every warp is done with slot 0
    if (ngi < Gp) load_q(ngi, nqt2);
    cp_commit();
    mma_pb<HD, DC, NT / 2>(accV, pa, dOs + c0);
    __syncthreads();  // every warp is done with slot 1
    if (ngi < Gp) load_do(ngi, nqt2);
    cp_commit();
    gi = ngi;
    qt = nqt2;
  }
  cp_wait<0>();

  const long long plane = (long long)B * Sk * Kv * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row >= nk) continue;
    if (ws != nullptr) {
      float* wk = ws + 2 * pi * plane +
                  (((long long)b * Sk + k0 + row) * Kv + kvh) * HD + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        store2(wk + 8 * n, accK[n][2 * r], accK[n][2 * r + 1]);
        store2(wk + plane + 8 * n, accV[n][2 * r], accV[n][2 * r + 1]);
      }
      continue;
    }
    T* krow_out = dk + b * sdk.b + (long long)(k0 + row) * sdk.s +
                  kvh * sdk.h + c0 + 2 * t;
    T* vrow_out = dv + b * sdv.b + (long long)(k0 + row) * sdv.s +
                  kvh * sdv.h + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      store2(krow_out + 8 * n, accK[n][2 * r] * scale,
             accK[n][2 * r + 1] * scale);
      store2(vrow_out + 8 * n, accV[n][2 * r], accV[n][2 * r + 1]);
    }
  }
}

// a block owns (b, h, 64 queries) and loops over the key tiles; each warp
// 16 queries, all hd columns of dQ
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    dq16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const int* __restrict__ qpos, const int* __restrict__ kpos,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int B,
                int H, int G, int Sq, int Sk, int causal, int window,
                float scale, Strides sq, Strides sk, Strides sv, Strides sdo,
                Strides sdq) {
  constexpr int RS = kStride<HD>, BK = kDqKeys<HD>, NT = BK / 8;
  extern __shared__ uint4 smem16[];
  T* Qs = reinterpret_cast<T*>(smem16);  // [64][RS]
  T* dOs = Qs + kRows * RS;              // [64][RS]
  T* Ks = dOs + kRows * RS;              // slot 0: keys [BK][RS]
  T* Vs = Ks + BK * RS;                  // slot 1: values [BK][RS]
  int* kp = reinterpret_cast<int*>(Vs + BK * RS);  // slot 0's positions
  int* qp = kp + BK;
  int* rng = qp + kRows;
  const int nqt = (Sq + kRows - 1) / kRows, nkt = (Sk + BK - 1) / BK;
  unsigned* live = reinterpret_cast<unsigned*>(rng + 4);
  unsigned* part = live + bitmap_words(nkt);

  const int bh = blockIdx.x % (B * H);
  const int qt = nqt - 1 - blockIdx.x / (B * H);  // longest first
  const int h = bh % H, b = bh / H, kvh = h / G, q0 = qt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = min(kRows, Sq - q0);
  const int* kpb = kpos + (long long)b * Sk;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  if (threadIdx.x < kRows)
    qp[threadIdx.x] =
        qpos[(long long)b * Sq + q0 + min((int)threadIdx.x, nq - 1)];
  load_tile<HD, kRows>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile<HD, kRows>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  cp_commit();
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + q0 + row;
    lrow[r] = row < nq ? kLog2e * lse[at] : 0.f;  // base-2 units
    drow[r] = row < nq ? delta[at] : 0.f;
  }
  __syncthreads();
  pos_range(qp, nq, false, rng);
  const int qmin = rng[0], qmax = rng[1];
  mark_tiles<BK>(
      live, part, nkt, kpb, Sk,
      [&](int kk) {
        return kk >= 0 && (!causal || kk <= qmax) &&
               (window <= 0 || (long long)kk > (long long)qmin - window);
      },
      [&](int kk) {
        return kk >= 0 && (!causal || kk <= qmin) &&
               (window <= 0 || (long long)kk > (long long)qmax - window);
      });
  int kt = next_live(live, 0, nkt);
  if (kt < nkt) load_tile<HD, BK>(Vs, vb, sv.s, kt * BK, Sk);
  cp_commit();
  if (kt < nkt) {
    load_tile<HD, BK>(Ks, kb, sk.s, kt * BK, Sk);
    load_vals(kp, kpb, 0, BK, kt * BK, Sk);
  }
  cp_commit();

  const int qrow[2] = {qp[16 * warp + g], qp[16 * warp + g + 8]};
  const T* Qw = Qs + 16 * warp * RS;
  const T* dOw = dOs + 16 * warp * RS;
  const float scale2 = scale * kLog2e;  // P = 2^(s scale2 - lse log2(e))
  float acc[HD / 8][4];
  zero(acc);

  while (kt < nkt) {
    const int k0 = kt * BK;
    cp_wait<1>();  // Q, dO, this tile's values
    __syncthreads();
    float s[NT][4], ds[NT][4];
    mma_abt<HD, NT>(ds, dOw, Vs);  // dP
    __syncthreads();  // every warp is done with slot 1
    const int next = next_live(live, kt + 1, nkt);
    if (next < nkt) load_tile<HD, BK>(Vs, vb, sv.s, next * BK, Sk);
    cp_commit();
    cp_wait<1>();  // this tile's keys and positions
    __syncthreads();
    mma_abt<HD, NT>(s, Qw, Ks);
    const bool full = !bit_set(part, kt) && k0 + BK <= Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), r = e >> 1;
        const float p =
            full || (k0 + c < Sk && visible(qrow[r], kp[c], causal, window))
                ? ex2(fmaf(s[j][e], scale2, -lrow[r]))
                : 0.f;
        ds[j][e] = p * (ds[j][e] - drow[r]);
      }
    {
      uint32_t da[NT / 2][4];
      to_a<NT / 2, T>(da, ds);  // dS rounded to the inputs' type
      mma_pb<HD, HD, NT / 2>(acc, da, Ks);
    }
    __syncthreads();  // every warp is done with slot 0
    if (next < nkt) {
      load_tile<HD, BK>(Ks, kb, sk.s, next * BK, Sk);
      load_vals(kp, kpb, 0, BK, next * BK, Sk);
    }
    cp_commit();
    kt = next;
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row >= nq) continue;
    T* out =
        dq + b * sdq.b + (long long)(q0 + row) * sdq.s + h * sdq.h + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(out + 8 * n, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// ---- host ----------------------------------------------------------------

template <int HD>
constexpr size_t tile_bytes(int rows) {
  return 2 * (size_t)rows * kStride<HD>;
}
// fwd16_kernel: Q and the key and value slots, from 1024 bytes on
template <int HD>
size_t fwd_smem(int Sk) {
  constexpr int BM = 64 * kWgGroups<HD>;
  return 1024 + 2 * (size_t)kWgCols<HD> * (BM + 2 * kWgKeys) +
         sizeof(int) *
             (kWgKeys + BM + 4 + 2 * bitmap_words(cdiv(Sk, kWgKeys)));
}
template <int HD>
size_t dkdv_smem(int Sq) {
  constexpr int BQ = kDkdvQ<HD>;
  return tile_bytes<HD>(2 * kKeys16 + 2 * BQ) +
         sizeof(int) *
             (3 * BQ + kKeys16 + 4 + 2 * bitmap_words(cdiv(Sq, BQ)));
}
template <int HD>
size_t dq_smem(int Sk) {
  constexpr int BK = kDqKeys<HD>;
  return tile_bytes<HD>(2 * kRows + 2 * BK) +
         sizeof(int) * (BK + kRows + 4 + 2 * bitmap_words(cdiv(Sk, BK)));
}
// dK/dV's blocks: key tiles x column blocks x parts x kv heads x batch
template <int HD>
long long dkdv_blocks(int B, int Kv, int Sk, int parts) {
  return (long long)cdiv(Sk, kKeys16) * (HD / kDkdvCols<HD>) * parts * Kv * B;
}

template <int HD, typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, void* o, float* lse, int B, int H, int Kv,
                int Sq, int Sk, int causal, int window, float scale,
                const long long* st, cudaStream_t stream) {
  const size_t smem = fwd_smem<HD>(Sk);
  cudaError_t e = prepare(fwd16_kernel<HD, T>, smem);
  if (e != cudaSuccess) return e;
  fwd16_kernel<HD, T><<<cdiv(Sq, 64 * kWgGroups<HD>) * H * B,
                        kWgThreads<HD>, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(o), lse, B, H,
      H / Kv, Sq, Sk, causal, window, scale, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3));
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t bwd(const T* q, const T* k, const T* v, const T* o,
                const T* dout, const int* qpos, const int* kpos,
                const float* lse, float* delta, T* dq, T* dk, T* dv,
                float* ws, int B, int H, int Kv, int Sq, int Sk, int causal,
                int window, int parts, float scale, const long long* st,
                cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  const long long warps = kDeltaThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), kDeltaThreads, 0,
                    stream>>>(o, dout, delta, H, Sq, HD, rows,
                              strides_at(st, 3), strides_at(st, 4));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int G = H / Kv;
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), sdo = strides_at(st, 4),
                sdq = strides_at(st, 5), sdk = strides_at(st, 6),
                sdv = strides_at(st, 7);
  const size_t s1 = dkdv_smem<HD>(Sq);
  if ((e = prepare(dkdv16_kernel<HD, T>, s1)) != cudaSuccess) return e;
  dkdv16_kernel<HD, T><<<(unsigned)dkdv_blocks<HD>(B, Kv, Sk, parts),
                         kThreads, s1, stream>>>(
      q, k, v, dout, qpos, kpos, lse, delta, dk, dv, ws, B, H, Kv, G,
      G / parts, Sq, Sk, causal, window, scale, sq, sk, sv, sdo, sdk, sdv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (ws != nullptr) {
    const long long plane = (long long)B * Sk * Kv * HD;
    const long long blocks =
        (2 * plane / 4 + kDeltaThreads - 1) / kDeltaThreads;
    dkdv_reduce_kernel<HD, T><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                                kDeltaThreads, 0, stream>>>(
        ws, dk, dv, parts, Sk, Kv, plane, scale, sdk, sdv);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const size_t s2 = dq_smem<HD>(Sk);
  if ((e = prepare(dq16_kernel<HD, T>, s2)) != cudaSuccess) return e;
  dq16_kernel<HD, T><<<cdiv(Sq, kRows) * H * B, kThreads, s2, stream>>>(
      q, k, v, dout, qpos, kpos, lse, delta, dq, B, H, G, Sq, Sk, causal,
      window, scale, sq, sk, sv, sdo, sdq);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t occupancy(int S, int* res) {
  cudaError_t e =
      resources_of(fwd16_kernel<HD, T>, fwd_smem<HD>(S), res, kWgThreads<HD>);
  if (e != cudaSuccess) return e;
  if ((e = resources_of(dkdv16_kernel<HD, T>, dkdv_smem<HD>(S), res + 5)) !=
      cudaSuccess)
    return e;
  return resources_of(dq16_kernel<HD, T>, dq_smem<HD>(S), res + 10);
}

}  // namespace

#ifndef FLASH_ELEMENT
#error "build flash_attention_bf16.cu or flash_attention_f16.cu"
#endif
typedef FLASH_ELEMENT Elem;
static_assert(!std::is_same<Elem, float>::value, "16-bit elements only");

// The entry points of flash_attention.cu, with its arguments, for the
// library's 16-bit element type. ws: at hd 256 with parts > 1, parts x 2 x
// B x Sk x Kv x hd floats of scratch for dK/dV's float32 partial sums
// (null otherwise).
extern "C" int flash_attention_fwd(const void* q, const void* k,
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
#define FWD(HD)                                                        \
  return (int)fwd<HD, Elem>(q, k, v, qp, kp, o, l, B, H, Kv, Sq, Sk,   \
                            causal, window, scale, strides, s)
  switch (hd) {
    case 16: FWD(16);
    case 32: FWD(32);
    case 64: FWD(64);
    case 96: FWD(96);
    case 128: FWD(128);
    case 256: FWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD
}

extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* qpos,
                                   const void* kpos, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   void* ws, int B, int H, int Kv, int Sq,
                                   int Sk, int hd, int causal, int window,
                                   int parts, float scale,
                                   const long long* strides, void* stream) {
  const bool wants_ws = hd > 128 && parts > 1;
  if (!shape_ok(B, H, Kv, Sq, Sk) || parts < 1 || (H / Kv) % parts ||
      (parts > 1 && hd <= 128) || wants_ws != (ws != nullptr) ||
      (long long)cdiv(Sk, kKeys16) * 2 * Kv * B * parts > INT_MAX)
    return (int)cudaErrorInvalidValue;
#define BWD(HD)                                                               \
  return (int)bwd<HD, Elem>(                                                  \
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),               \
      static_cast<const Elem*>(v), static_cast<const Elem*>(o),               \
      static_cast<const Elem*>(dout), static_cast<const int*>(qpos),          \
      static_cast<const int*>(kpos), static_cast<const float*>(lse),          \
      static_cast<float*>(delta), static_cast<Elem*>(dq),                     \
      static_cast<Elem*>(dk), static_cast<Elem*>(dv),                         \
      static_cast<float*>(ws), B, H, Kv, Sq, Sk, causal, window, parts,       \
      scale, strides, static_cast<cudaStream_t>(stream))
  switch (hd) {
    case 16: BWD(16);
    case 32: BWD(32);
    case 64: BWD(64);
    case 96: BWD(96);
    case 128: BWD(128);
    case 256: BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD
}

// the forward, dK/dV and dQ kernels' resources, as flash_attention.cu's
extern "C" int flash_attention_occupancy(int hd, int S, int* res) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return (int)occupancy<16, Elem>(S, res);
    case 32: return (int)occupancy<32, Elem>(S, res);
    case 64: return (int)occupancy<64, Elem>(S, res);
    case 96: return (int)occupancy<96, Elem>(S, res);
    case 128: return (int)occupancy<128, Elem>(S, res);
    case 256: return (int)occupancy<256, Elem>(S, res);
    default: return (int)cudaErrorInvalidValue;
  }
}
