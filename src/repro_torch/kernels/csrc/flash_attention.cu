// flash_attention.cu -- Hopper (sm_90a) kernels for causal / windowed
// online-softmax attention with grouped-query heads: the forward pass and
// its backward pass, with every product on the tensor cores, for float32
// q, k, v (split TF32, below). bfloat16 and float16 inputs take
// flash_attention16.cu's kernels (the same function and C interface, on
// the tensor cores' 16-bit products); flash_common.cuh holds what the two
// share.
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
// the row has seen a visible key, and before that alpha = 0 wipes what it
// added, so skipping it changes no number. A row with no visible key at all
// is outside the contract (the plain version averages the masked keys' v
// there, the kernel writes 0).
//
// Backward (every sum in float32): delta_i = sum_c dO_ic O_ic (delta_kernel), then
//   P_ij = exp(s_ij - lse_i) (0 where masked), dP = dO V^T,
//   dS = P o (dP - delta), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.
// dkdv_kernel owns (b, kv head, 64 keys) and loops over the G query heads of
// its group and their query tiles; dq_kernel owns (b, h, 64 queries) and
// loops over the key tiles. Both compute S and dP, each once a visible
// pair: dK/dV 8 hd operations a pair (S^T, dP^T, dK, dV at 2 hd each), dQ
// 6 hd (S, dP, dQ), 14 hd against the 10 of the bound. One S per backward
// would need dQ summed across the key tiles' blocks, which takes atomics
// in a varying order or a second pass over partial sums. Up to hd 128 those
// are the kernels; hd 256 takes their warp-pair versions (below).
//
// Determinism: every output element is written by one thread of one block,
// after sums in a fixed order (tiles in ascending order, the mma sequence,
// shuffles in a fixed pattern; at hd 256 the two 128-column partials of S
// (forward and backward) and dP added as two terms, which IEEE addition gives the same bits in
// either order, and dK/dV's parts added in ascending order by
// dkdv_reduce_kernel, one thread an output element): the same bits on
// every run. The only atomic is an OR into a block's own bitmaps of tiles
// in shared memory, whose bits do not depend on the order.
//
// What bounds it: operations. At the train path's shape (B 2, S 2048, H 16,
// hd 128) the forward does 4 hd flops a visible pair (S = QK^T, PV) and the
// backward 10 (S, dP, dV, dK, dQ), ~256 and ~320 flops a byte moved; the
// H100's float32 CUDA cores (67 TFLOP/s) give ~20 flops a byte. So every
// product runs on the tensor cores, as warp-level
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, in split TF32:
//   each float32 operand x is split into hi = tf32(x) (cvt.rna: 10 mantissa
//   bits, round to nearest, ties away; done as two integer operations) and
//   lo = tf32(x - hi) (the subtraction is exact); a b becomes lo_a hi_b +
//   hi_a lo_b + hi_a hi_b (small terms first) into a float32 accumulator.
//   |a - hi_a| <= 2^-11 |a| and |lo_a - (a - hi_a)| <= 2^-22 |a|, so each
//   product's error is the dropped lo_a lo_b <= 2^-22 |a b| plus the lo
//   rounding, 2 2^-22 |a b|: about 7e-7 relative, the order of float32's
//   own rounding of the sum. One-pass TF32 (hi_a hi_b alone) errs by 2^-10
//   |a b| and misses the tolerances (tests/test_torch_flash_tf32.py
//   emulates both on the CPU). The tensor cores' accumulation is not
//   IEEE: each mma truncates the sum toward zero at the accumulator's ulp,
//   so a long chain of mma on one accumulator drifts (dV summed over 8192
//   queries, ~3000 chained mma, erred 2x the gradient tolerance). Every
//   sum that runs over tiles (O, dQ, dK, dV) therefore takes each tile's
//   product in a fresh accumulator and adds it by one rounded fmaf: no
//   truncating chain is longer than 3 x 8 k steps, and the results sit
//   within 0.15 of the tolerances of float64, as the plain float32 version
//   does (H100 80GB HBM3 at 700 W).
// Three tensor-core products a float32 product: 3 x 4 hd a pair at 495
// TFLOP/s (TF32, dense) is the route's bound.
//
// Why mma.sync and not wgmma: wgmma takes tf32 operands K-major from shared
// memory only (its transpose bits are for 16-bit types), so split TF32
// through it would hold hi and lo tiles of Q, K and V in shared memory
// (~192 KB at hd 128 before double buffering, of 227 KB). mma.sync reads its
// fragments from float32 tiles and splits them in registers.
//
// Tiles, warps and shared memory. A block is 4 warps (128 threads); each
// warp owns 16 rows of the block's 64 (queries; keys in dK/dV) and keeps
// its S and P fragments and its accumulators in registers (FA2 style).
// Tiles lie in shared memory as float32, rows padded to hd + 4 floats;
// row-major fragments come by ldmatrix (8 rows of 16 bytes at a stride of
// 4 (mod 32) words cover the 32 banks), column reads at rows 2t, columns g
// (8t + g covers them too). A C-layout accumulator (S, P, dS) becomes the
// A operand of the next product without moving: lane (g, t) holds columns
// 2t, 2t + 1 of each 8-column block, which stand for the k indices t, t + 4
// when the B rows are read at 2t, 2t + 1 (the same permutation of the
// reduction), so P and dS never pass through shared memory.
//   forward  Q [64] resident; a two-slot ring: slot 0 the key tile [32],
//            slot 1 the value tile [32], each as hi and lo tiles: the
//            threads split the chunks they copied once they land, so the
//            block's warps read split fragments (a warp splits only Q and
//            P).
//            Key tile k + 1 loads while tile k's P V runs, value tile k + 1
//            while tile k + 1's S runs.
//   dQ       Q, dO [64] resident; slot 0 keys [32], slot 1 values [32];
//            dP (values) first, then S and dS K (keys): each slot refills
//            during the other's products.
//   dK/dV    K, V [64] resident; slot 0 Q [32] (+ positions, lse), slot 1
//            dO [32] (+ delta); S^T, dP^T, dK += dS^T Q, dV += P^T dO.
// At hd 128 each kernel takes 101,376 bytes of tiles (+ < 1 KB of
// positions and the tile bitmaps): two blocks, 8 warps, an SM (the dK/dV
// kernel of the first design took 174 KB, one block). ptxas gives the
// three 254-255 registers and no spills (the cap of two 128-thread blocks
// an SM). Head dim 96 takes the same kernels: its tiles take 76,800 bytes
// (two blocks an SM). At hd 256 a warp's
// accumulators of hd floats a thread (two in dK/dV) would not fit the
// registers, so all three kernels run warp pairs (fwd_pair_kernel,
// dkdv_pair_kernel, dq_pair_kernel):
//   8-warp blocks; warps w and w + 4 own the same 16 rows, w the output
//   columns 0-127, w + 4 the columns 128-255, so each thread's
//   accumulators are hd 128's (two of 64 floats in dK/dV, one in the
//   forward and dQ). Each warp of a pair computes S (S^T in dK/dV; and dP
//   in the backward) over its own 128 columns of the hd reduction; the
//   two partials pass through shared memory (a 2 KB slot a warp, which S
//   and then dP reuse: 16 KB a block) and are added, so both warps form
//   the same m, l and P (and dS) and every product is computed once: the
//   forward 4 hd operations a visible pair, dK/dV 8 hd, dQ 6 hd (the
//   first designs, two column blocks each computing the whole S and dP,
//   did 6, 12 and 10). A named barrier of the pair (64 threads) orders a
//   slot's write before the partner's read; the block's barriers between
//   the ring's stages order the read before the slot's next write.
//   The forward's tiles are Q [64] and the key and value tiles [32] as hi
//   and lo, all 256 columns: 199,680 bytes, + the slots 16,384 + <
//   1 KB = 216,480 bytes at S 2048 (dK/dV 216,736, dQ 216,480), under a
//   block's 232,448: one block, 8 warps, an SM, with
//   __launch_bounds__(256, 1), 255 registers a thread at most (256 x 255
//   = 65,280 of the SM's 65,536), and no spills (the forward and dK/dV
//   kernels read the rows' positions from shared memory in the mask and
//   take P V's tile product two n-tiles at a time, dK's one: 4 and 8
//   bytes a thread spilled otherwise).
//   dK/dV's grid: a block owns a pair of key tiles, kt and nkt - 1 - kt,
//   one after the other (under a causal mask their live 32-query tiles
//   add up to the same count, nqt + 2 at S 2048: 64 - 2 kt + 2 + 2 kt =
//   66), and a part of the group's heads (bwd_parts in the wrapper: the
//   fewest parts, a divisor of G, that give the grid two blocks an SM,
//   else G). gemma-2b's (B 2, S 2048, H 8 on Kv 1): 16 pairs x 2 x 8 parts
//   = 256 blocks (1.94 waves of 132), each 66 (head, query tile)
//   iterations, the max 1.00x the mean (the first design: 32 key tiles x
//   B 2 x 2 column blocks = 128 blocks, one wave, the blocks of key tile 0
//   looping over 8 heads x 64 tiles = 512, 1.94x the mean of 264).
//   recurrentgemma-2b's (H 10 on 1, window 2048 = causal here): 10 parts,
//   320 blocks of 66 (2.42 waves). With more than one part each block
//   writes partial dK, dV sums to a float32 workspace the wrapper
//   allocates (parts x 2 x B x Sk x Kv x hd x 4 bytes: 67,108,864 at
//   gemma's shape, 83,886,080 at recurrentgemma's), and dkdv_reduce_kernel
//   adds the parts in ascending order (and scales dK).
//   The forward's and dQ's grids: cdiv(S, 64) x H x B blocks (512 at
//   gemma's shape, 3.88 waves of 132; 640 at recurrentgemma's), the
//   longest query tiles first.
// The ring is filled by 16-byte cp.async.cg, zero-filled past S
// (src-size 0). Blocks run the longest tiles first: the forward and dQ take the
// query tiles from the last (the most keys under a causal mask), dK/dV the
// key tiles from the first. Each block builds, from the positions, bitmaps
// of the tiles that hold a visible pair (the others are never loaded) and
// of those whose every pair is visible (no mask is applied to them).
//
// Layout: q (B, Sq, H, hd), k and v (B, Sk, Kv, hd), dO, O alike, hd
// contiguous, element strides for B, S and the head given per tensor; the
// rows the kernels read start on 16 bytes (the wrapper copies a tensor that
// does not), and the outputs are written as float pairs. Positions int32
// (B, Sq) and (B, Sk); lse and delta float32 (B, H, Sq); every tensor
// float32 here (the 16-bit libraries: flash_attention16.cu).
//
// C interface for ctypes. The kernels allocate nothing and launch on the
// stream they are given; each entry point returns cudaGetLastError() after
// its launches, or cudaErrorInvalidValue for a shape it does not take.

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kFwdKeys = 32;          // the forward's key tile
constexpr int kBwdTile = 32;          // dQ's key tile, dK/dV's query tile
// n-tiles a fresh accumulator takes in mma_pb (half of it in dK/dV, which
// holds two long accumulators); at most hd / 8
template <int HD>
constexpr int kChunkOf = HD / 8 < 4 ? HD / 8 : 4;

// copies a thread's row loop issues unrolled: all of them up to hd 128; 8
// past it, where the fully unrolled loop's hoisted addresses made hd 256's
// kernels spill (24-72 bytes a thread)
template <int HD, int N>
constexpr int kRowsUnroll = HD > 128 && N > 8 ? 8 : N;

// ---- split TF32 on the tensor cores -------------------------------------

// cvt.rna.tf32.f32 of a finite x: the 13 dropped bits rounded to nearest,
// ties away, in two integer operations (the instruction adds an inf/NaN
// guard, a third)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as an operand: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// where B's split comes from: B split in registers as A is (kSplit), or
// B's hi and lo tiles split once per block in shared memory (kPreB); three
// TF32 products either way
enum Mode { kSplit, kPreB };

// d += a b: lo_a hi_b, hi_a lo_b, hi_a hi_b (the small terms first)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint2 bh,
                                     uint2 bl) {
  mma(d, al, bh.x, bh.y);
  mma(d, ah, bl.x, bl.y);
  mma(d, ah, bh.x, bh.y);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// four 8 x 4 float32 blocks of shared memory, one a register (ldmatrix's
// 8 x 8 16-bit matrices): lane l gives the address of row l % 8 of block
// l / 8, and gets word l % 4 of row l / 4 of each block
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// acc[j] = A B_j^T over k < KD, 16 x 8 each in C layout (lane (g, t):
// rows g, g + 8, columns 2t, 2t + 1): A the warp's 16 rows of a tile, B_j
// rows 8j .. 8j + 7 of another (Bh, and its lo tile Bl under kPreB), all
// [row][HD + 4] with k along the row (KD < HD: the KD columns from where A
// and B point, a partial product). Fragments come by ldmatrix: A's four
// (rows 0-7 / 8-15 x columns k-k+3 / k+4-k+7) and two n-tiles' B at a
// time; 8 rows of 16 bytes at a stride of 4 (mod 32) words cover the 32
// banks.
template <int HD, int NT, Mode MODE, int KD = HD>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const float* A,
                                        const float* Bh, const float* Bl) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
  constexpr int RS = HD + 4;
  zero(acc);
  const int lane = threadIdx.x & 31, m = lane >> 3, rr = lane & 7;
  const float* a = A + (rr + 8 * (m & 1)) * RS + 4 * (m >> 1);
  const int bo = (rr + 8 * (m >> 1)) * RS + 4 * (m & 1);
#pragma unroll 4
  for (int k = 0; k < KD; k += 8) {
    uint32_t ar[4], ah[4], al[4];
    ldsm4(ar, a + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split(__uint_as_float(ar[i]), ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // b0, b1 of n-tile j, then of j + 1
      uint32_t bh[4], bl[4];
      ldsm4(bh, Bh + bo + 8 * j * RS + k);
      if constexpr (MODE == kPreB) {
        ldsm4(bl, Bl + bo + 8 * j * RS + k);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(__uint_as_float(bh[i]), bh[i], bl[i]);
      }
      mma3(acc[j], ah, al, make_uint2(bh[0], bh[1]),
           make_uint2(bl[0], bl[1]));
      mma3(acc[j + 1], ah, al, make_uint2(bh[2], bh[3]),
           make_uint2(bl[2], bl[3]));
    }
  }
}

// acc[n] = alpha acc[n] + P B over k < 8 KS (columns 8n .. 8n + 7 of the
// output, n < DC / 8: B's first DC columns, B's rows HD + 4 floats apart;
// alpha[0] for row g, alpha[1] for row g + 8): P the C-layout
// accumulator of mma_abt (p[s]: its columns 8s .. 8s + 7) taken as the A
// operand in place, lane (g, t)'s k = t, t + 4 standing for columns 2t,
// 2t + 1; B [k][HD + 4] read at rows 8s + 2t, 8s + 2t + 1 (the same
// permutation) and column 8n + g: 8t + g covers the 32 banks. The tensor
// cores truncate at each accumulation (to the accumulator's ulp, toward
// zero), so the tile's product runs in a fresh accumulator, NB n-tiles at
// a time, and joins acc by one rounded fmaf: no truncating chain outlives
// a tile (dV over 8192 queries was ~3000 chained mma and erred 2x the
// tolerance).
template <int HD, int DC, int KS, int NB, Mode MODE>
__device__ __forceinline__ void mma_pb(float (&acc)[DC / 8][4],
                                       const float (&p)[KS][4],
                                       const float* Bh, const float* Bl,
                                       const float (&alpha)[2]) {
  static_assert(DC / 8 % NB == 0, "whole chunks of n-tiles");
  constexpr int RS = HD + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bo = 2 * t * RS + g;
#pragma unroll
  for (int n0 = 0; n0 < DC / 8; n0 += NB) {
    float part[NB][4];
    zero(part);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t ah[4], al[4];
      split(p[s][0], ah[0], al[0]);
      split(p[s][2], ah[1], al[1]);
      split(p[s][1], ah[2], al[2]);
      split(p[s][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int at0 = bo + 8 * s * RS + 8 * (n0 + n), at1 = at0 + RS;
        uint2 bh, bl;
        if constexpr (MODE == kPreB) {
          bh = make_uint2(__float_as_uint(Bh[at0]), __float_as_uint(Bh[at1]));
          bl = make_uint2(__float_as_uint(Bl[at0]), __float_as_uint(Bl[at1]));
        } else {
          split(Bh[at0], bh.x, bl.x);
          split(Bh[at1], bh.y, bl.y);
        }
        mma3(part[n], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e >> 1], part[n][e]);
  }
}

// rows r0 .. r0 + R - 1 of a (b, head) slice (row stride ss elements, hd
// contiguous) -> dst [R][HD + 4] float32, rows at or past S as 0; r0 < S;
// by the block's NTH threads, by 16-byte cp.async (src-size 0 past S)
template <int HD, int R, typename T, int NTH = kThreads>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int r0, int S) {
  static_assert(std::is_same<T, float>::value, "float32 tiles");
  constexpr int RS = HD + 4, C = HD / 4;
  static_assert(R * C % NTH == 0, "whole chunks a thread");
#pragma unroll (kRowsUnroll<HD, R * C / NTH>)
  for (int i = 0; i < R * C / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, r = e / C, c = e % C;
    const bool ok = r0 + r < S;
    cp16(dst + r * RS + 4 * c, src + (long long)(ok ? r0 + r : r0) * ss + 4 * c,
         ok);
  }
}

// the chunks this thread copied by load_rows<HD, R> into hi, split
// in place: hi = tf32(x), lo = tf32(x - hi). Right after the thread's own
// cp.async group is complete (its copies are visible to it); a barrier
// then publishes both tiles. By the block's NTH threads, as load_rows.
template <int HD, int R, int NTH = kThreads>
__device__ __forceinline__ void split_rows(float* hi, float* lo) {
  constexpr int RS = HD + 4, C = HD / 4;
#pragma unroll (kRowsUnroll<HD, R * C / NTH>)
  for (int i = 0; i < R * C / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, at = e / C * RS + 4 * (e % C);
    float4 x = *reinterpret_cast<float4*>(hi + at), h, l;
    uint32_t uh, ul;
    split(x.x, uh, ul);
    h.x = __uint_as_float(uh);
    l.x = __uint_as_float(ul);
    split(x.y, uh, ul);
    h.y = __uint_as_float(uh);
    l.y = __uint_as_float(ul);
    split(x.z, uh, ul);
    h.z = __uint_as_float(uh);
    l.z = __uint_as_float(ul);
    split(x.w, uh, ul);
    h.w = __uint_as_float(uh);
    l.w = __uint_as_float(ul);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// ---- forward -------------------------------------------------------------

// The online softmax over one key tile of a warp's rows: the scaled and
// masked scores s (C layout: rows g, g + 8 in r = 0, 1; a row's 32 keys
// over the 4 lanes of its quad) become p = exp(s - m'); m and l move to
// the tile's, and alpha = exp(m - m') is what the accumulator is scaled
// by.
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
        s[j][e] = expf(s[j][e] - m_new);
        rs += s[j][e];
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    alpha[r] = expf(m_run[r] - m_new);
    l_run[r] = alpha[r] * l_run[r] + rs;
    m_run[r] = m_new;
  }
}

// up to hd 128: a block owns (b, h, 64 queries) and loops over the key
// tiles; each warp its 16 queries, all hd columns
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ qpos,
               const int* __restrict__ kpos, T* __restrict__ o,
               float* __restrict__ lse, int B, int H, int G, int Sq, int Sk,
               int causal, int window, float scale, Strides sq, Strides sk,
               Strides sv, Strides so) {
  constexpr int RS = HD + 4, BK = kFwdKeys, NT = BK / 8;
  constexpr Mode MODE = kPreB;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [64][RS]
  float* Ks = Qs + kRows * RS;  // slot 0: keys [BK][RS], their hi once split
  float* Kl = Ks + BK * RS;     // their lo [BK][RS]
  float* Vs = Kl + BK * RS;     // slot 1: values [BK][RS], hi
  float* Vl = Vs + BK * RS;     // their lo
  int* kp = reinterpret_cast<int*>(Vl + BK * RS);  // slot 0's positions
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

  // rows past Sq repeat the last row's position: computed, never written
  if (threadIdx.x < kRows)
    qp[threadIdx.x] =
        qpos[(long long)b * Sq + q0 + min((int)threadIdx.x, nq - 1)];
  load_rows<HD, kRows>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  cp_commit();
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
  if (kt < nkt) {
    load_rows<HD, BK>(Ks, kb, sk.s, kt * BK, Sk);
    load_vals(kp, kpb, 0, BK, kt * BK, Sk);
  }
  cp_commit();
  if (kt < nkt) load_rows<HD, BK>(Vs, vb, sv.s, kt * BK, Sk);
  cp_commit();

  const int qrow[2] = {qp[16 * warp + g], qp[16 * warp + g + 8]};
  const float* Qw = Qs + 16 * warp * RS;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  zero(acc);

  while (kt < nkt) {
    const int k0 = kt * BK;
    cp_wait<1>();  // Q, this tile's keys and positions
    split_rows<HD, BK>(Ks, Kl);
    __syncthreads();
    float s[NT][4];
    mma_abt<HD, NT, MODE>(s, Qw, Ks, Kl);
    if (!bit_set(part, kt) && k0 + BK <= Sk) {  // every pair visible
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          s[j][e] =
              k0 + c < Sk && visible(qrow[e >> 1], kp[c], causal, window)
                  ? __fmul_rn(s[j][e], scale)
                  : kNegInf;
        }
    }
    __syncthreads();  // every warp is done with slot 0
    const int next = next_live(live, kt + 1, nkt);
    if (next < nkt) {
      load_rows<HD, BK>(Ks, kb, sk.s, next * BK, Sk);
      load_vals(kp, kpb, 0, BK, next * BK, Sk);
    }
    cp_commit();
    float alpha[2];
    online_softmax(s, m_run, l_run, alpha);
    cp_wait<1>();  // this tile's values
    split_rows<HD, BK>(Vs, Vl);
    __syncthreads();
    mma_pb<HD, HD, NT, kChunkOf<HD>, MODE>(acc, s, Vs, Vl, alpha);
    __syncthreads();  // every warp is done with slot 1
    if (next < nkt) load_rows<HD, BK>(Vs, vb, sv.s, next * BK, Sk);
    cp_commit();
    kt = next;
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row >= nq) continue;
    const float den = fmaxf(l_run[r], 1e-30f);
    T* orow = o + b * so.b + (long long)(q0 + row) * so.s + h * so.h + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(orow + 8 * n, acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    if (t == 0)
      lse[((long long)b * H + h) * Sq + q0 + row] = m_run[r] + logf(l_run[r]);
  }
}

// ---- backward ------------------------------------------------------------

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const int* __restrict__ qpos, const int* __restrict__ kpos,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int B, int H, int Kv, int G, int Sq,
                int Sk, int causal, int window, float scale, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk,
                Strides sdv) {
  constexpr int RS = HD + 4, BQ = kBwdTile, NT = BQ / 8;
  constexpr Mode SM = kSplit, PM = kSplit;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [64][RS], the block's keys
  float* Vs = Ks + kRows * RS;                  // [64][RS]
  float* Qs = Vs + kRows * RS;                  // slot 0: queries [BQ][RS]
  float* dOs = Qs + BQ * RS;                    // slot 1: dO [BQ][RS]
  int* qp = reinterpret_cast<int*>(dOs + BQ * RS);  // slot 0
  float* ls = reinterpret_cast<float*>(qp + BQ);    // slot 0: lse
  float* dl = ls + BQ;                              // slot 1: delta
  int* kp = reinterpret_cast<int*>(dl + BQ);
  int* rng = kp + kRows;
  const int nqt = (Sq + BQ - 1) / BQ;
  unsigned* live = reinterpret_cast<unsigned*>(rng + 4);
  unsigned* part = live + bitmap_words(nqt);

  const int bk = blockIdx.x % (B * Kv);
  const int kt = blockIdx.x / (B * Kv);  // the first key tiles see the most
  const int kvh = bk % Kv, b = bk / Kv, k0 = kt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = min(kRows, Sk - k0);
  const int* qpb = qpos + (long long)b * Sq;

  if (threadIdx.x < kRows)
    kp[threadIdx.x] = (int)threadIdx.x < nk
                          ? kpos[(long long)b * Sk + k0 + threadIdx.x]
                          : -1;
  load_rows<HD, kRows>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, Sk);
  load_rows<HD, kRows>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, Sk);
  cp_commit();
  __syncthreads();
  pos_range(kp, kRows, true, rng);
  const int kmin = rng[0], kmax = rng[1];
  const bool any_key = kmin <= kmax;
  // every one of the 64 keys valid (none past Sk, no negative position)
  const bool all_keys = !__syncthreads_or(threadIdx.x < kRows &&
                                          kp[threadIdx.x] < 0);
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

  // the (head of the group, query tile) pairs in order, live tiles only
  int gi = 0, qt = next_live(live, 0, nqt);
  if (qt == nqt) gi = G;
  auto load_q = [&](int gg, int tt) {
    const int hh = kvh * G + gg, r0 = tt * BQ;
    load_rows<HD, BQ>(Qs, q + b * sq.b + hh * sq.h, sq.s, r0, Sq);
    load_vals(qp, qpb, 0, BQ, r0, Sq);
    load_vals(ls, lse + ((long long)b * H + hh) * Sq, BQ, BQ, r0, Sq);
  };
  auto load_do = [&](int gg, int tt) {
    const int hh = kvh * G + gg, r0 = tt * BQ;
    load_rows<HD, BQ>(dOs, dout + b * sdo.b + hh * sdo.h, sdo.s, r0, Sq);
    load_vals(dl, delta + ((long long)b * H + hh) * Sq, 0, BQ, r0, Sq);
  };
  if (gi < G) load_q(gi, qt);
  cp_commit();
  if (gi < G) load_do(gi, qt);
  cp_commit();

  const int krow[2] = {kp[16 * warp + g], kp[16 * warp + g + 8]};
  const float* Kw = Ks + 16 * warp * RS;
  const float* Vw = Vs + 16 * warp * RS;
  const float one[2] = {1.f, 1.f};
  float accK[HD / 8][4], accV[HD / 8][4];
  zero(accK);
  zero(accV);

  while (gi < G) {
    const int q0 = qt * BQ;
    cp_wait<1>();  // K, V, this tile's queries, positions and lse
    __syncthreads();
    float p[NT][4], ds[NT][4];
    // transposed scores: keys (rows) x queries (columns)
    mma_abt<HD, NT, SM>(p, Kw, Qs, nullptr);
    const bool full = !bit_set(part, qt) && q0 + BQ <= Sq;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        p[j][e] = full || (q0 + c < Sq &&
                           visible(qp[c], krow[e >> 1], causal, window))
                      ? expf(__fmul_rn(p[j][e], scale) - ls[c])
                      : 0.f;
      }
    cp_wait<0>();  // this tile's dO and delta
    __syncthreads();
    mma_abt<HD, NT, SM>(ds, Vw, dOs, nullptr);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        ds[j][e] = p[j][e] * (ds[j][e] - dl[c]);
      }
    mma_pb<HD, HD, NT, kChunkOf<HD> / 2, PM>(accK, ds, Qs, nullptr, one);
    int ngi = gi, nqt2 = next_live(live, qt + 1, nqt);
    if (nqt2 == nqt) {
      ++ngi;
      nqt2 = next_live(live, 0, nqt);
    }
    __syncthreads();  // every warp is done with slot 0
    if (ngi < G) load_q(ngi, nqt2);
    cp_commit();
    mma_pb<HD, HD, NT, kChunkOf<HD> / 2, PM>(accV, p, dOs, nullptr, one);
    __syncthreads();  // every warp is done with slot 1
    if (ngi < G) load_do(ngi, nqt2);
    cp_commit();
    gi = ngi;
    qt = nqt2;
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row >= nk) continue;
    T* krow_out = dk + b * sdk.b + (long long)(k0 + row) * sdk.s +
                  kvh * sdk.h + 2 * t;
    T* vrow_out = dv + b * sdv.b + (long long)(k0 + row) * sdv.s +
                  kvh * sdv.h + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store2(krow_out + 8 * n, accK[n][2 * r] * scale,
             accK[n][2 * r + 1] * scale);
      store2(vrow_out + 8 * n, accV[n][2 * r], accV[n][2 * r + 1]);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const int* __restrict__ qpos, const int* __restrict__ kpos,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int B, int H, int G, int Sq, int Sk,
              int causal, int window, float scale, Strides sq, Strides sk,
              Strides sv, Strides sdo, Strides sdq) {
  constexpr int RS = HD + 4, BK = kBwdTile, NT = BK / 8;
  constexpr Mode SM = kSplit, PM = kSplit;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [64][RS]
  float* dOs = Qs + kRows * RS;                 // [64][RS]
  float* Ks = dOs + kRows * RS;                 // slot 0: keys [BK][RS]
  float* Vs = Ks + BK * RS;                     // slot 1: values [BK][RS]
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
  load_rows<HD, kRows>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_rows<HD, kRows>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  cp_commit();
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + q0 + row;
    lrow[r] = row < nq ? lse[at] : 0.f;
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
  if (kt < nkt) load_rows<HD, BK>(Vs, vb, sv.s, kt * BK, Sk);
  cp_commit();
  if (kt < nkt) {
    load_rows<HD, BK>(Ks, kb, sk.s, kt * BK, Sk);
    load_vals(kp, kpb, 0, BK, kt * BK, Sk);
  }
  cp_commit();

  const int qrow[2] = {qp[16 * warp + g], qp[16 * warp + g + 8]};
  const float* Qw = Qs + 16 * warp * RS;
  const float* dOw = dOs + 16 * warp * RS;
  const float one[2] = {1.f, 1.f};
  float acc[HD / 8][4];
  zero(acc);

  while (kt < nkt) {
    const int k0 = kt * BK;
    cp_wait<1>();  // Q, dO, this tile's values
    __syncthreads();
    float s[NT][4], ds[NT][4];
    mma_abt<HD, NT, SM>(ds, dOw, Vs, nullptr);  // dP
    __syncthreads();  // every warp is done with slot 1
    const int next = next_live(live, kt + 1, nkt);
    if (next < nkt) load_rows<HD, BK>(Vs, vb, sv.s, next * BK, Sk);
    cp_commit();
    cp_wait<1>();  // this tile's keys and positions
    __syncthreads();
    mma_abt<HD, NT, SM>(s, Qw, Ks, nullptr);
    const bool full = !bit_set(part, kt) && k0 + BK <= Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), r = e >> 1;
        const float p =
            full || (k0 + c < Sk && visible(qrow[r], kp[c], causal, window))
                ? expf(__fmul_rn(s[j][e], scale) - lrow[r])
                : 0.f;
        ds[j][e] = p * (ds[j][e] - drow[r]);
      }
    mma_pb<HD, HD, NT, kChunkOf<HD>, PM>(acc, ds, Ks, nullptr, one);
    __syncthreads();  // every warp is done with slot 0
    if (next < nkt) {
      load_rows<HD, BK>(Ks, kb, sk.s, next * BK, Sk);
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

// ---- hd 256: warp pairs -------------------------------------------------

constexpr int kPairThreads = 256;  // 8 warps: pairs (w, w + 4), w < 4

// the named barrier of warp pair (w, w + 4), w = pair (barrier 0 is
// __syncthreads')
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;" ::"r"(pair + 1) : "memory");
}

// the exchange slots xs [8][NT 4 32]: a warp's C-layout fragments s[NT][4]
// -> slot w, lane l's float4 j at float4 32 j + l (32 lanes store 512
// contiguous bytes)
template <int NT>
__device__ __forceinline__ void put_slot(float* xs, int w,
                                         const float (&s)[NT][4]) {
  float4* d = reinterpret_cast<float4*>(xs) + 32 * NT * w + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    d[32 * j] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
}

// s += the fragments in slot w, the partner warp's. Each warp of a pair
// holds the product over its own 128 columns of the reduction; IEEE
// addition is commutative, so both hold the same bits: (columns 0-127's
// partial) + (columns 128-255's).
template <int NT>
__device__ __forceinline__ void add_slot(float (&s)[NT][4], const float* xs,
                                         int w) {
  const float4* d = reinterpret_cast<const float4*>(xs) + 32 * NT * w +
                    (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 x = d[32 * j];
    s[j][0] += x.x;
    s[j][1] += x.y;
    s[j][2] += x.z;
    s[j][3] += x.w;
  }
}

// The forward at hd 256. A block owns (b, h, 64 queries) and loops over the
// key tiles; warps w and w + 4 own the same 16 queries, w the output
// columns 0-127 and the reduction's columns 0-127 of S, w + 4 the columns
// 128-255. The two partials of S are added in both warps, so both form the
// same m, l, alpha and P, and each runs P V over its own output columns;
// warp w writes lse.
template <int HD, typename T>
__global__ void __launch_bounds__(kPairThreads, 1)
    fwd_pair_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, T* __restrict__ o,
                    float* __restrict__ lse, int B, int H, int G, int Sq,
                    int Sk, int causal, int window, float scale, Strides sq,
                    Strides sk, Strides sv, Strides so) {
  constexpr int RS = HD + 4, DC = HD / 2, BK = kFwdKeys, NT = BK / 8;
  constexpr int NTH = kPairThreads, XS = NT * 4 * 32;
  constexpr Mode MODE = kPreB;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [64][RS]
  float* Ks = Qs + kRows * RS;  // slot 0: keys [BK][RS], their hi once split
  float* Kl = Ks + BK * RS;     // their lo [BK][RS]
  float* Vs = Kl + BK * RS;     // slot 1: values [BK][RS], hi
  float* Vl = Vs + BK * RS;     // their lo
  float* xs = Vl + BK * RS;     // [8][XS]: each warp's partial S
  int* kp = reinterpret_cast<int*>(xs + 8 * XS);  // slot 0's positions
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
  const int wr = warp & 3, c0 = DC * (warp >> 2);  // its rows, its columns
  const int nq = min(kRows, Sq - q0);
  const int* kpb = kpos + (long long)b * Sk;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  // rows past Sq repeat the last row's position: computed, never written
  if (threadIdx.x < kRows)
    qp[threadIdx.x] =
        qpos[(long long)b * Sq + q0 + min((int)threadIdx.x, nq - 1)];
  load_rows<HD, kRows, T, NTH>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
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
    load_rows<HD, BK, T, NTH>(Ks, kb, sk.s, kt * BK, Sk);
    load_vals(kp, kpb, 0, BK, kt * BK, Sk);
  }
  cp_commit();
  if (kt < nkt) load_rows<HD, BK, T, NTH>(Vs, vb, sv.s, kt * BK, Sk);
  cp_commit();

  const float* Qw = Qs + 16 * wr * RS + c0;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[DC / 8][4];
  zero(acc);

  while (kt < nkt) {
    const int k0 = kt * BK;
    cp_wait<1>();  // Q, this tile's keys and positions
    split_rows<HD, BK, NTH>(Ks, Kl);
    __syncthreads();
    float s[NT][4];
    // the warp's 128 columns of the reduction, then its partner's added
    mma_abt<HD, NT, MODE, DC>(s, Qw, Ks + c0, Kl + c0);
    put_slot(xs, warp, s);
    pair_sync(wr);
    add_slot(s, xs, warp ^ 4);
    if (!bit_set(part, kt) && k0 + BK <= Sk) {  // every pair visible
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the query's position read here, not held in a register
          // across the loop (this kernel's registers are at the cap)
          const int c = 8 * j + 2 * t + (e & 1);
          s[j][e] = k0 + c < Sk && visible(qp[16 * wr + g + 4 * (e & 2)],
                                           kp[c], causal, window)
                  ? __fmul_rn(s[j][e], scale)
                  : kNegInf;
        }
    }
    __syncthreads();  // every warp is done with slot 0 and its partner's S
    const int next = next_live(live, kt + 1, nkt);
    if (next < nkt) {
      load_rows<HD, BK, T, NTH>(Ks, kb, sk.s, next * BK, Sk);
      load_vals(kp, kpb, 0, BK, next * BK, Sk);
    }
    cp_commit();
    float alpha[2];
    online_softmax(s, m_run, l_run, alpha);
    cp_wait<1>();  // this tile's values
    split_rows<HD, BK, NTH>(Vs, Vl);
    __syncthreads();
    // two n-tiles of fresh accumulator at a time (four spilled 8 bytes a
    // thread)
    mma_pb<HD, DC, NT, kChunkOf<DC> / 2, MODE>(acc, s, Vs + c0, Vl + c0,
                                               alpha);
    __syncthreads();  // every warp is done with slot 1
    if (next < nkt) load_rows<HD, BK, T, NTH>(Vs, vb, sv.s, next * BK, Sk);
    cp_commit();
    kt = next;
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * wr + g + 8 * r;
    if (row >= nq) continue;
    const float den = fmaxf(l_run[r], 1e-30f);
    T* orow = o + b * so.b + (long long)(q0 + row) * so.s + h * so.h + c0 +
              2 * t;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      store2(orow + 8 * n, acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    if (t == 0 && warp < 4)
      lse[((long long)b * H + h) * Sq + q0 + row] = m_run[r] + logf(l_run[r]);
  }
}

// dK/dV at hd 256. A block owns (b, kv head, a pair of key tiles kt and
// nkt - 1 - kt, taken one after the other, a part of gpp consecutive heads
// of the group); warps w and w + 4 own the same 16 keys of the tile, w the
// dK/dV columns 0-127 and the reduction's columns 0-127 of S^T and dP^T,
// w + 4 the columns 128-255. With more than one part (ws not null), the
// block writes its partial dK (not yet scaled) and dV in float32 to ws
// [G / gpp][2][B][Sk][Kv][HD], summed by dkdv_reduce_kernel; else dK and
// dV.
template <int HD, typename T>
__global__ void __launch_bounds__(kPairThreads, 1)
    dkdv_pair_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const T* __restrict__ dout,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kpos,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ ws, int B,
                     int H, int Kv, int G, int gpp, int Sq, int Sk,
                     int causal, int window, float scale, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv) {
  constexpr int RS = HD + 4, DC = HD / 2, BQ = kBwdTile, NT = BQ / 8;
  constexpr int NTH = kPairThreads, XS = NT * 4 * 32;
  constexpr Mode SM = kSplit, PM = kSplit;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [64][RS], the tile's keys
  float* Vs = Ks + kRows * RS;                  // [64][RS]
  float* Qs = Vs + kRows * RS;                  // slot 0: queries [BQ][RS]
  float* dOs = Qs + BQ * RS;                    // slot 1: dO [BQ][RS]
  float* xs = dOs + BQ * RS;  // [8][XS]: each warp's partial S^T, then dP^T
  int* qp = reinterpret_cast<int*>(xs + 8 * XS);  // slot 0
  float* ls = reinterpret_cast<float*>(qp + BQ);  // slot 0: lse
  float* dl = ls + BQ;                            // slot 1: delta
  int* kp = reinterpret_cast<int*>(dl + BQ);
  int* rng = kp + kRows;
  const int nqt = (Sq + BQ - 1) / BQ, nkt = (Sk + kRows - 1) / kRows;
  unsigned* live = reinterpret_cast<unsigned*>(rng + 4);
  unsigned* part = live + bitmap_words(nqt);

  const int npairs = (nkt + 1) / 2;
  const int bk = blockIdx.x % (B * Kv), rest = blockIdx.x / (B * Kv);
  const int pi = rest % npairs;
  const int kvh = bk % Kv, b = bk / Kv;
  const int h0 = kvh * G + rest / npairs * gpp;  // the part's first head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, c0 = DC * (warp >> 2);  // its rows, its columns
  const int* qpb = qpos + (long long)b * Sq;
  const float one[2] = {1.f, 1.f};

  auto load_q = [&](int gg, int tt) {
    const int hh = h0 + gg, r0 = tt * BQ;
    load_rows<HD, BQ, T, NTH>(Qs, q + b * sq.b + hh * sq.h, sq.s, r0, Sq);
    load_vals(qp, qpb, 0, BQ, r0, Sq);
    load_vals(ls, lse + ((long long)b * H + hh) * Sq, BQ, BQ, r0, Sq);
  };
  auto load_do = [&](int gg, int tt) {
    const int hh = h0 + gg, r0 = tt * BQ;
    load_rows<HD, BQ, T, NTH>(dOs, dout + b * sdo.b + hh * sdo.h, sdo.s, r0,
                              Sq);
    load_vals(dl, delta + ((long long)b * H + hh) * Sq, 0, BQ, r0, Sq);
  };

  // key tile pi, then nkt - 1 - pi (unless pi is the middle tile)
  for (int kt = pi, last = nkt - 1 - pi;; kt = last) {
    const int k0 = kt * kRows, nk = min(kRows, Sk - k0);
    __syncthreads();  // every warp is done with the last tile's K, V, bitmaps
    if (threadIdx.x < kRows)
      kp[threadIdx.x] = (int)threadIdx.x < nk
                            ? kpos[(long long)b * Sk + k0 + threadIdx.x]
                            : -1;
    load_rows<HD, kRows, T, NTH>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, Sk);
    load_rows<HD, kRows, T, NTH>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, Sk);
    cp_commit();
    __syncthreads();
    pos_range(kp, kRows, true, rng);
    const int kmin = rng[0], kmax = rng[1];
    const bool any_key = kmin <= kmax;
    const bool all_keys = !__syncthreads_or(threadIdx.x < kRows &&
                                            kp[threadIdx.x] < 0);
    mark_tiles<BQ, NTH>(
        live, part, nqt, qpb, Sq,
        [&](int qq) {
          return any_key && (!causal || kmin <= qq) &&
                 (window <= 0 || (long long)kmax > (long long)qq - window);
        },
        [&](int qq) {
          return all_keys && (!causal || kmax <= qq) &&
                 (window <= 0 || (long long)kmin > (long long)qq - window);
        });

    // the part's (head, query tile) pairs in order, live tiles only
    int gi = 0, qt = next_live(live, 0, nqt);
    if (qt == nqt) gi = gpp;
    if (gi < gpp) load_q(gi, qt);
    cp_commit();
    if (gi < gpp) load_do(gi, qt);
    cp_commit();

    const float* Kw = Ks + 16 * wr * RS + c0;
    const float* Vw = Vs + 16 * wr * RS + c0;
    float accK[DC / 8][4], accV[DC / 8][4];
    zero(accK);
    zero(accV);

    while (gi < gpp) {
      const int q0 = qt * BQ;
      cp_wait<1>();  // K, V, this tile's queries, positions and lse
      __syncthreads();
      float p[NT][4], ds[NT][4];
      // transposed scores, keys (rows) x queries (columns): the warp's
      // 128 columns of the reduction, then its partner's added
      mma_abt<HD, NT, SM, DC>(p, Kw, Qs + c0, nullptr);
      put_slot(xs, warp, p);
      pair_sync(wr);
      add_slot(p, xs, warp ^ 4);
      const bool full = !bit_set(part, qt) && q0 + BQ <= Sq;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the key's position read here, not held in a register across
          // the loop (this kernel's registers are at the cap)
          const int c = 8 * j + 2 * t + (e & 1);
          p[j][e] = full || (q0 + c < Sq &&
                             visible(qp[c], kp[16 * wr + g + 4 * (e & 2)],
                                     causal, window))
                        ? expf(__fmul_rn(p[j][e], scale) - ls[c])
                        : 0.f;
        }
      cp_wait<0>();  // this tile's dO and delta
      __syncthreads();  // (and every partner has read this warp's S^T)
      mma_abt<HD, NT, SM, DC>(ds, Vw, dOs + c0, nullptr);
      put_slot(xs, warp, ds);
      pair_sync(wr);
      add_slot(ds, xs, warp ^ 4);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          ds[j][e] = p[j][e] * (ds[j][e] - dl[c]);
        }
      // one n-tile of fresh accumulator at a time while p and ds are both
      // live (two spilled 8 bytes a thread), two for dV
      mma_pb<HD, DC, NT, kChunkOf<DC> / 4, PM>(accK, ds, Qs + c0, nullptr,
                                               one);
      int ngi = gi, nqt2 = next_live(live, qt + 1, nqt);
      if (nqt2 == nqt) {
        ++ngi;
        nqt2 = next_live(live, 0, nqt);
      }
      __syncthreads();  // every warp is done with slot 0 and its partner's dP^T
      if (ngi < gpp) load_q(ngi, nqt2);
      cp_commit();
      mma_pb<HD, DC, NT, kChunkOf<DC> / 2, PM>(accV, p, dOs + c0, nullptr,
                                               one);
      __syncthreads();  // every warp is done with slot 1
      if (ngi < gpp) load_do(ngi, nqt2);
      cp_commit();
      gi = ngi;
      qt = nqt2;
    }
    cp_wait<0>();

    const long long plane = (long long)B * Sk * Kv * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * wr + g + 8 * r;
      if (row >= nk) continue;
      float *krow_out, *vrow_out, sc;
      if (ws) {
        krow_out = ws + 2 * (blockIdx.x / (B * Kv) / npairs) * plane +
                   (((long long)b * Sk + k0 + row) * Kv + kvh) * HD + c0 +
                   2 * t;
        vrow_out = krow_out + plane;
        sc = 1.f;
      } else {
        krow_out = dk + b * sdk.b + (long long)(k0 + row) * sdk.s +
                   kvh * sdk.h + c0 + 2 * t;
        vrow_out = dv + b * sdv.b + (long long)(k0 + row) * sdv.s +
                   kvh * sdv.h + c0 + 2 * t;
        sc = scale;
      }
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        store2(krow_out + 8 * n, accK[n][2 * r] * sc,
               accK[n][2 * r + 1] * sc);
        store2(vrow_out + 8 * n, accV[n][2 * r], accV[n][2 * r + 1]);
      }
    }
    if (kt >= last) break;
  }
}

// dQ at hd 256. A block owns (b, h, 64 queries) and loops over the key
// tiles; warps w and w + 4 own the same 16 queries, w the dQ columns 0-127
// and the reduction's columns 0-127 of S and dP, w + 4 the columns
// 128-255.
template <int HD, typename T>
__global__ void __launch_bounds__(kPairThreads, 1)
    dq_pair_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const int* __restrict__ qpos, const int* __restrict__ kpos,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int B, int H, int G, int Sq, int Sk, int causal,
                   int window, float scale, Strides sq, Strides sk,
                   Strides sv, Strides sdo, Strides sdq) {
  constexpr int RS = HD + 4, DC = HD / 2, BK = kBwdTile, NT = BK / 8;
  constexpr int NTH = kPairThreads, XS = NT * 4 * 32;
  constexpr Mode SM = kSplit, PM = kSplit;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [64][RS]
  float* dOs = Qs + kRows * RS;                 // [64][RS]
  float* Ks = dOs + kRows * RS;                 // slot 0: keys [BK][RS]
  float* Vs = Ks + BK * RS;                     // slot 1: values [BK][RS]
  float* xs = Vs + BK * RS;  // [8][XS]: each warp's partial dP, then S
  int* kp = reinterpret_cast<int*>(xs + 8 * XS);  // slot 0's positions
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
  const int wr = warp & 3, c0 = DC * (warp >> 2);  // its rows, its columns
  const int nq = min(kRows, Sq - q0);
  const int* kpb = kpos + (long long)b * Sk;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  if (threadIdx.x < kRows)
    qp[threadIdx.x] =
        qpos[(long long)b * Sq + q0 + min((int)threadIdx.x, nq - 1)];
  load_rows<HD, kRows, T, NTH>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_rows<HD, kRows, T, NTH>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0,
                               Sq);
  cp_commit();
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * wr + g + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + q0 + row;
    lrow[r] = row < nq ? lse[at] : 0.f;
    drow[r] = row < nq ? delta[at] : 0.f;
  }
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
  if (kt < nkt) load_rows<HD, BK, T, NTH>(Vs, vb, sv.s, kt * BK, Sk);
  cp_commit();
  if (kt < nkt) {
    load_rows<HD, BK, T, NTH>(Ks, kb, sk.s, kt * BK, Sk);
    load_vals(kp, kpb, 0, BK, kt * BK, Sk);
  }
  cp_commit();

  const int qrow[2] = {qp[16 * wr + g], qp[16 * wr + g + 8]};
  const float* Qw = Qs + 16 * wr * RS + c0;
  const float* dOw = dOs + 16 * wr * RS + c0;
  const float one[2] = {1.f, 1.f};
  float acc[DC / 8][4];
  zero(acc);

  while (kt < nkt) {
    const int k0 = kt * BK;
    cp_wait<1>();  // Q, dO, this tile's values
    __syncthreads();
    float s[NT][4], ds[NT][4];
    mma_abt<HD, NT, SM, DC>(ds, dOw, Vs + c0, nullptr);  // dP, partial
    put_slot(xs, warp, ds);
    __syncthreads();  // every warp is done with slot 1, its dP put
    add_slot(ds, xs, warp ^ 4);
    const int next = next_live(live, kt + 1, nkt);
    if (next < nkt) load_rows<HD, BK, T, NTH>(Vs, vb, sv.s, next * BK, Sk);
    cp_commit();
    cp_wait<1>();  // this tile's keys and positions
    __syncthreads();  // (and every partner has read this warp's dP)
    mma_abt<HD, NT, SM, DC>(s, Qw, Ks + c0, nullptr);  // S, partial
    put_slot(xs, warp, s);
    pair_sync(wr);
    add_slot(s, xs, warp ^ 4);
    const bool full = !bit_set(part, kt) && k0 + BK <= Sk;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), r = e >> 1;
        const float p =
            full || (k0 + c < Sk && visible(qrow[r], kp[c], causal, window))
                ? expf(__fmul_rn(s[j][e], scale) - lrow[r])
                : 0.f;
        ds[j][e] = p * (ds[j][e] - drow[r]);
      }
    mma_pb<HD, DC, NT, kChunkOf<DC>, PM>(acc, ds, Ks + c0, nullptr, one);
    __syncthreads();  // every warp is done with slot 0 and its partner's S
    if (next < nkt) {
      load_rows<HD, BK, T, NTH>(Ks, kb, sk.s, next * BK, Sk);
      load_vals(kp, kpb, 0, BK, next * BK, Sk);
    }
    cp_commit();
    kt = next;
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * wr + g + 8 * r;
    if (row >= nq) continue;
    T* out = dq + b * sdq.b + (long long)(q0 + row) * sdq.s + h * sdq.h + c0 +
             2 * t;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      store2(out + 8 * n, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// ---- host ----------------------------------------------------------------

// the warp-pair kernels' exchange slots: 8 x 16 x 32 floats (a warp's S
// fragments over a tile of 32 keys or queries)
static_assert(kFwdKeys == kBwdTile, "one size of exchange slot");
constexpr size_t kExchangeBytes = sizeof(float) * 8 * 16 * kBwdTile;

// the forward kernel of a head dim and its threads a block: warp pairs at
// hd 256 (an accumulator of hd floats a thread would not fit the
// registers)
template <int HD, typename T>
auto fwd_kernel_of() {
  if constexpr (HD > 128)
    return fwd_pair_kernel<HD, T>;
  else
    return fwd_kernel<HD, T>;
}
template <int HD>
constexpr int kFwdThreads = HD > 128 ? kPairThreads : kThreads;
// dK/dV by warp pairs (dkdv_pair_kernel, its float32 partial sums through
// the workspace and dkdv_reduce_kernel where the heads are split): at hd
// 256, where the 4-warp kernel's two accumulators of hd floats a thread
// would not fit the registers
template <int HD>
constexpr bool kPairDkdv = HD > 128;

template <int HD>
constexpr size_t tile_bytes(int rows) {
  return sizeof(float) * (size_t)rows * (HD + 4);
}
// Q, the keys' and the values' hi and lo tiles (+ the slots at hd 256)
template <int HD>
size_t fwd_smem(int Sk) {
  return tile_bytes<HD>(kRows + 4 * kFwdKeys) +
         (HD > 128 ? kExchangeBytes : 0) +
         sizeof(int) * (kFwdKeys + kRows + 4 +
                        2 * bitmap_words(cdiv(Sk, kFwdKeys)));
}
template <int HD>
size_t dkdv_smem(int Sq) {
  return tile_bytes<HD>(2 * kRows + 2 * kBwdTile) +
         sizeof(int) * (3 * kBwdTile + kRows + 4 +
                        2 * bitmap_words(cdiv(Sq, kBwdTile)));
}
template <int HD>
size_t dq_smem(int Sk) {
  return tile_bytes<HD>(2 * kRows + 2 * kBwdTile) +
         sizeof(int) * (kBwdTile + kRows + 4 +
                        2 * bitmap_words(cdiv(Sk, kBwdTile)));
}

template <int HD, typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, void* o, float* lse, int B, int H, int Kv,
                int Sq, int Sk, int causal, int window, float scale,
                const long long* st, cudaStream_t stream) {
  auto kernel = fwd_kernel_of<HD, T>();
  const size_t smem = fwd_smem<HD>(Sk);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<cdiv(Sq, kRows) * H * B, kFwdThreads<HD>, smem, stream>>>(
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
  if constexpr (kPairDkdv<HD>) {
    // dK and dV straight from the kernel with one part; else through the
    // workspace and the reduction
    const bool reduce = ws != nullptr;
    const size_t s1 = dkdv_smem<HD>(Sq) + kExchangeBytes;
    if ((e = prepare(dkdv_pair_kernel<HD, T>, s1)) != cudaSuccess) return e;
    dkdv_pair_kernel<HD, T><<<cdiv(cdiv(Sk, kRows), 2) * Kv * B * parts,
                              kPairThreads, s1, stream>>>(
        q, k, v, dout, qpos, kpos, lse, delta, dk, dv, ws, B, H, Kv, G,
        G / parts, Sq, Sk, causal, window, scale, sq, sk, sv, sdo, sdk, sdv);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (reduce) {
      const long long plane = (long long)B * Sk * Kv * HD;
      const long long blocks =
          (2 * plane / 4 + kDeltaThreads - 1) / kDeltaThreads;
      dkdv_reduce_kernel<HD, T><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                                  kDeltaThreads, 0, stream>>>(
          ws, dk, dv, parts, Sk, Kv, plane, scale, sdk, sdv);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  } else {
    const size_t s1 = dkdv_smem<HD>(Sq);
    if ((e = prepare(dkdv_kernel<HD, T>, s1)) != cudaSuccess) return e;
    dkdv_kernel<HD, T><<<cdiv(Sk, kRows) * Kv * B, kThreads, s1, stream>>>(
        q, k, v, dout, qpos, kpos, lse, delta, dk, dv, B, H, Kv, G, Sq, Sk,
        causal, window, scale, sq, sk, sv, sdo, sdk, sdv);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if constexpr (HD > 128) {
    const size_t s2 = dq_smem<HD>(Sk) + kExchangeBytes;
    if ((e = prepare(dq_pair_kernel<HD, T>, s2)) != cudaSuccess) return e;
    dq_pair_kernel<HD, T><<<cdiv(Sq, kRows) * H * B, kPairThreads, s2,
                            stream>>>(q, k, v, dout, qpos, kpos, lse, delta,
                                      dq, B, H, G, Sq, Sk, causal, window,
                                      scale, sq, sk, sv, sdo, sdq);
  } else {
    const size_t s2 = dq_smem<HD>(Sk);
    if ((e = prepare(dq_kernel<HD, T>, s2)) != cudaSuccess) return e;
    dq_kernel<HD, T><<<cdiv(Sq, kRows) * H * B, kThreads, s2, stream>>>(
        q, k, v, dout, qpos, kpos, lse, delta, dq, B, H, G, Sq, Sk, causal,
        window, scale, sq, sk, sv, sdo, sdq);
  }
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t occupancy(int S, int* res) {
  cudaError_t e;
  if ((e = resources_of(fwd_kernel_of<HD, T>(), fwd_smem<HD>(S), res,
                        kFwdThreads<HD>)) != cudaSuccess)
    return e;
  if constexpr (kPairDkdv<HD>)
    e = resources_of(dkdv_pair_kernel<HD, T>,
                     dkdv_smem<HD>(S) + kExchangeBytes, res + 5,
                     kPairThreads);
  else
    e = resources_of(dkdv_kernel<HD, T>, dkdv_smem<HD>(S), res + 5);
  if (e != cudaSuccess) return e;
  if constexpr (HD > 128)
    return resources_of(dq_pair_kernel<HD, T>,
                        dq_smem<HD>(S) + kExchangeBytes, res + 10,
                        kPairThreads);
  else
    return resources_of(dq_kernel<HD, T>, dq_smem<HD>(S), res + 10);
}

}  // namespace

// The float32 library; the bfloat16 and float16 ones
// (flash_attention_bf16.cu, flash_attention_f16.cu) export the same entry
// points from flash_attention16.cu.
typedef float Elem;

// q (B, Sq, H, hd), k, v (B, Sk, Kv, hd) of the library's element type;
// positions int32 (B, Sq), (B, Sk); -> o (B, Sq, H, hd) in that type, lse
// (B, H, Sq) float32. strides: 12 element strides (b, s, head) of q, k, v,
// o. window <= 0: none. hd one of 16, 32, 64, 96, 128, 256.
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

// q, k, v, o, dout as in the forward, of the library's element type; lse
// (B, H, Sq) float32 from it; delta (B, H, Sq) float32 scratch; -> dq (B,
// Sq, H, hd), dk, dv (B, Sk, Kv, hd) in the element type (accumulated in
// float32, each rounded once). strides: 24 element strides (b, s, head) of
// q, k, v, o, dout, dq, dk, dv. parts: the hd-256 dK/dV kernel's split of
// each group's H / Kv heads (a divisor of it; 1 below hd 256); at hd 256
// with parts > 1, ws holds parts x 2 x B x Sk x Kv x hd floats of scratch
// for the warp pairs' float32 partial sums (null otherwise).
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
      (long long)cdiv(cdiv(Sk, kRows), 2) * Kv * B * parts > INT_MAX)
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

// Blocks per SM, dynamic shared memory (bytes), registers a thread, local
// memory (bytes a thread: spills) and threads a block of the library's
// forward, dK/dV and dQ kernels at head dim hd and sequence length S, from
// the runtime's occupancy calculator and function attributes: res[15],
// five a kernel.
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
