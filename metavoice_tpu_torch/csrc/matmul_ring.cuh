// The ring of tensor-core tiles for weight-only matmuls of more than 8 rows,
// written for Hopper (sm_90a): one kernel template, int4g_ring_kernel, in
// three weight formats. matmul_int4_grouped.cu launches it for K12 (q (K, N)
// int8, groupwise scales and zeros) and K13 (p (K/2, N) split-half nibble
// pairs), matmul_int8.cu for K11 (q (K, N) plain int8, one f32 scale a
// column). Their files say what each computes and what bounds it.
//
// Design (one launch a call):
//   * A block computes a tile of 16, 32, 64, 128 or 256 rows by 128 columns
//     over a split of K (below); one producer warpgroup makes the copies and
//     the conversion, consumer warps only multiply, and a ring of 3 or 4
//     slots (an x chunk of 64 k, the groupwise formats' group rows of scales
//     and zeros, its converted 64 x 128 weights; four mbarriers a slot; 4 at
//     K11's 256 rows, which stage no scales) hands the work over.
//   * The copies are the copy engine's (TMA), a lane of each producer warp
//     issuing one a step, 2 or 3 steps ahead: x's chunk from a 3-D view of x,
//     (rows, halves, k of a half) for K13 and (rows, 1, k) otherwise, so rows
//     past M and k past the end of K (of a half) arrive as zeros; with a
//     staged block's first step its 64 rows x 128 bytes of w (128-byte
//     swizzled); K12's and K13's group rows of s and z of the step (up to 8:
//     a groupsize that is a multiple of 8). A groupsize that is not reads
//     each row's scale and zero from global memory instead.
//   * The conversion, once a block, exact and off the int-to-float unit:
//     producer thread p of a warp takes rows 2p, 2p + 1 of a staged block by
//     the warp's 32 columns and stores each column's bf16 pair (k, k + 1) as
//     4 bytes into the slot's K-major tile with the 128-byte swizzle (a
//     warp's 32 lanes fill a column's 128-byte row: no bank conflicts).
//     K12's and K13's, 8 columns an iteration of a loop that is not
//     unrolled: K12's signed bytes are biased and doubled (a shift and one
//     lop3 for the even, the odd bytes of a word), K13's nibbles doubled (a
//     shift and a mask), each put under 2^22's exponent by one byte permute
//     and taken back by one f32 subtract, giving q + 0.5 exactly; then
//     __fmul_rn by the scale and __fadd_rn of the zero of the row's group,
//     and one cvt to the bf16 pair. K11's signed bytes need no affine: its
//     two rows' 32 bytes by two 16-byte loads each, all four first, then a
//     pair's two bytes by one byte permute, their low 7 bits under the bf16
//     exponent of 128 and the subtrahend 128 or 256 (by the sign bit) by one
//     lop3 each, one bf16x2 subtract (plain_pair): q exactly, unrolled (on
//     the H100 7% faster a call than K12's loop shape with 8-byte loads).
//     Rows past K and columns past N are masked to zero, not branched
//     around. K13's staged block feeds two consumer steps: its low nibbles
//     are rows k, its high ones rows k + K/2, each against its own x chunk.
//   * The products: at 64 rows and more, wgmma m64n128k16 (bf16 -> f32), one
//     or two consumer warpgroups of one or two m64 tiles, A the swizzled x
//     chunk and B the converted tile, both read by the tensor cores from
//     shared memory. At 16 and 32 rows, mma.sync m16n8k16 fed by ldmatrix
//     from the same tiles, 4 consumer warps of 32 columns each.
//   * K is split across blocks on whole staged blocks (ops/quantized.
//     int4g_tile_plan and int8_tile_plan pick the rows of a tile and the
//     splits by a model of the card fitted to the times of every cut,
//     tools/ring_cuts.py), so each byte of w is read once a row tile; more
//     than 256 rows take more row tiles. With more than one split each block
//     writes its f32 partial, and the last block of a tile to finish, behind
//     a ticket (one acquire-release atomic, reset to 0 by that block), adds
//     them in split order and casts the sum to x's dtype once; K11's column
//     scale multiplies the sum of all of K there (with one split, in the
//     consumers), as the TPU kernel applies it. The same bits every call and
//     every CUDA-graph replay.
//   What holds it (timer marks in an experiment build, tools/ring_marks.py,
//   NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): the producers'
//   conversion, about 1700 cycles a step of 8192 weights for one warpgroup
//   in K12 (25 cycles a weight a thread: the mix of f32, integer-pipe and
//   conversion instructions at one warp a scheduler), against 1240 cycles
//   of wgmma at 256 rows and 680 at 128; K11's conversion takes 650-1030
//   cycles a step, against 640 of wgmma at 128 rows and 1160 at 256, where
//   a step moves about 96 KB (128 rows) to 160 KB (256) through shared
//   memory (copies in, the conversion's reads and stores, wgmma's reads of
//   x and of B once an m64 tile): 750-1250 cycles at 128 bytes a cycle.
//   Then each split's partial write and the merge.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prefill_ring.cuh"

namespace {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte j of a word of doubled nibbles (2 n a byte, n in 0..15) as the exact
// f32 n - 7.5: the byte put under 2^22's exponent (mantissa step 0.5) by one
// byte permute, then one subtract of 2^22 + 7.5.
__device__ __forceinline__ float nib_value(uint32_t twice, int j) {
  return __int_as_float((int)__byte_perm(twice, 0x4A800000u, 0x7640u + j)) - 4194311.5f;
}

// Two weights, bf16(v * s + z) each with no contraction, as one bf16 pair
// (lo in the low half): one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t weight_pair(float v_lo, float s_lo, float z_lo, float v_hi, float s_hi,
                                                float z_hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(v_lo, s_lo), z_lo),
                                           __fadd_rn(__fmul_rn(v_hi, s_hi), z_hi));
  return *reinterpret_cast<uint32_t*>(&p);
}

constexpr int kRgCols = 128;       // output columns a block
constexpr int kRgChunk = 64;       // rows of w a staged block (K11, K12 k rows; K13 packed rows: 64 k of each half)
constexpr int kRgProducers = 128;  // one producer warpgroup: the copies and the conversion
constexpr int kRgRowBytes = kRgChunk * 2;  // a staged x row and a converted weight column (K-major): 64 bf16,
                                           // 128 bytes, 16-byte pieces swizzled by the row
constexpr int kRgRawBytes = kRgChunk * kRgCols;  // a staged block of w: 64 rows of 128 bytes, swizzled like x
constexpr int kRgSzRows = 8;       // group rows of scales (and of zeros) a step stages: 64 k from a multiple
                                   // of 64 span 8 at most where the groupsize is a multiple of 8
constexpr int kRgMergeOut = 4;     // outputs (4 columns each) a thread of the merging block takes at once
constexpr int kRgMergeSplits = 4;  // splits' partials it loads at once for each

// The weight formats: K12's q (K, N) int8 and K13's p (K/2, N) nibble
// pairs, each with groupwise scales and zeros; K11's q (K, N) int8 with one
// scale a column.
enum RgFmt { kRgQ4 = 0, kRgP4 = 1, kRgQ8 = 2 };

// A tile of 16 kMt rows by kRgCols columns. The producer warpgroup comes
// first. 64 rows and more (kMt 4, 8, 16): one or two consumer warpgroups on
// wgmma m64n128k16, each one or two m64 tiles by the 128 columns (a warp's
// 16 rows of each by 16 n8 tiles, wgmma's accumulator layout). 16 or 32
// rows (kMt 1, 2): 4 consumer warps on mma.sync fed by ldmatrix, each 32
// columns over all the rows. K13 walks two consumer steps a staged block
// (its low nibbles, then its high ones).
template <int kFmt, int kMt>
struct RgShape {
  static_assert(kMt == 1 || kMt == 2 || kMt == 4 || kMt == 8 || kMt == 16, "16, 32, 64, 128 or 256 rows");
  static constexpr bool kPacked = kFmt == kRgP4;
  static constexpr bool kAffine = kFmt != kRgQ8;    // groupwise scales and zeros in the conversion
  static constexpr int kHalves = kPacked ? 2 : 1;  // consumer steps a staged block
  // ring slots (an x chunk, its scales and zeros and its converted weights each): 3 where 4 would leave no
  // room (256 rows of K12 and K13; K11 stages no scales) or keep a second block off the SM (16 and 32 rows)
  static constexpr int kSlots = kMt == 4 || kMt == 8 || (kMt == 16 && !kAffine) ? 4 : 3;
  static constexpr int kAhead = kSlots - 1;  // steps whose copies are issued ahead of the conversion
  // staged blocks of raw weights: a buffer is refilled only after the consumers are done with the last step
  // that read it (the issuing thread's wait on the slot's empty barrier, below)
  static constexpr int kRawBufs = kPacked ? (kSlots + 2) / 2 : kSlots;
  static constexpr bool kWg = kMt >= 4;
  static constexpr int kWgs = kMt >= 8 ? 2 : 1;             // wgmma: consumer warpgroups
  static constexpr int kConsumerWarps = kWg ? 4 * kWgs : 4;
  static constexpr int kThreads = kRgProducers + 32 * kConsumerWarps;
  static constexpr int kWmt = kWg ? kMt / 4 / kWgs : kMt;  // m64 (wgmma) or m16 tiles a consumer warp
  static constexpr int kWnt = kWg ? kRgCols / 8 : kRgCols / 32;  // n8 tiles a consumer warp
  static constexpr int kBm = 16 * kMt;
  static constexpr size_t kXSlot = (size_t)kBm * kRgRowBytes;      // multiples of 1024: the swizzle's alignment
  static constexpr size_t kBSlot = (size_t)kRgCols * kRgRowBytes;  // 16 KB
  // [s, z][row][column]; none for K11
  static constexpr size_t kSzSlot = kAffine ? (size_t)2 * kRgSzRows * kRgCols * sizeof(float) : 0;
  static constexpr size_t kBarBytes = sizeof(uint64_t) * 4 * kSlots;
  // x chunks, converted weights, scales and zeros, raw weights, barriers, and 1 KB to align the start
  static constexpr size_t kSmem = 1024 + kSlots * (kXSlot + kBSlot + kSzSlot) + kRawBufs * kRgRawBytes + kBarBytes;
  // blocks an SM (the registers held to it): up to 32 rows two blocks' shared memory fits an SM
  static constexpr int kBlocksPerSm = kMt <= 2 ? 2 : 1;
  static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472, "the blocks' shared memory fits an SM");
};

struct RgArgs {
  const float* sc;   // K12/K13 (k / gs, n): a groupsize that is no multiple of 8 reads them here; K11 (n,)
  const float* zr;   // K12/K13 (k / gs, n)
  void* y;           // (m, n) bf16 (out_bf16) or f32
  float* part;       // splits > 1: (splits, m, n) f32 partials
  int* tickets;      // splits > 1: one a tile, 0 between calls
  int m, k, n, gs, out_bf16, split_chunks;
  int x_halves;      // K13: x's tensor map is (rows, halves, k / 2); else (rows, 1, k)
};

// Bytes j = 0..3 of a word of int8 weights as the exact f32 q + 0.5, from the
// word's bytes biased by 128 and doubled (even: bytes 0 and 2, odd: 1 and 3;
// a shift and one lop3 each a word), put under 2^22's exponent (mantissa
// step 0.5) by one byte permute, then one subtract of 2^22 + 127.5.
__device__ __forceinline__ uint32_t even_bytes(uint32_t w) { return ((w << 1) & 0x01FE01FEu) ^ 0x01000100u; }
__device__ __forceinline__ uint32_t odd_bytes(uint32_t w) { return ((w >> 7) & 0x01FE01FEu) ^ 0x01000100u; }
__device__ __forceinline__ float byte_value(uint32_t even, uint32_t odd, int j) {
  return __int_as_float((int)__byte_perm(j & 1 ? odd : even, 0x4A800000u, j & 2 ? 0x7632u : 0x7610u)) -
         4194431.5f;
}

// Byte j of two words of signed int8 weights (rows k and k + 1 of one
// column) as the exact bf16 pair (row k's in the low half): the two bytes at
// bits 0 and 16 by one byte permute; their low 7 bits m under the bf16
// exponent of 128 (the bf16 128 + m) by one lop3, the subtrahend 128 (q >= 0)
// or 256 (q < 0: the byte's sign bit is the low bit of the bf16 exponent)
// by another, and one bf16x2 subtract gives m or m - 128, that is q, exactly.
__device__ __forceinline__ uint32_t plain_pair(uint32_t w0, uint32_t w1, int j) {
  const uint32_t v = __byte_perm(w0, w1, j | ((4 + j) << 8));
  const uint32_t mag = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t sub = (v & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 p = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                             *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<uint32_t*>(&p);
}

// y = x @ the weights for a tile of 16 kMt rows, over a split of
// split_chunks staged blocks. Grid (column tiles of kRgCols, row tiles,
// splits). The copies are the copy engine's, issued by a lane of each
// producer warp kAhead steps ahead: x's chunk (xmap), with a staged block's
// first step its 64 x 128 bytes of w (wmap, 128-byte swizzled), and K12's
// and K13's group rows of scales and zeros of each step (smap, zmap; K11
// has none). Producer thread pt owns rows 2 p, 2 p + 1 (p = pt mod 32) by
// columns [32 cb, 32 cb + 32) (cb = pt / 32) of every staged block, and
// converts them once into the slot's K-major bf16 tile (K12, K13:
// bf16((q + 0.5) * s + z); K11: q), a bf16 pair (k, k + 1) of a column a
// 4-byte store (a warp's 32 lanes fill the column's 128-byte row: no bank
// conflicts). A groupsize that is no multiple of 8 reads each row's scale
// and zero from global memory. K11's column scale multiplies the f32 sum of
// all of K: in the consumers with one split, else in the merging block.
template <int kFmt, int kMt>
__global__ void __launch_bounds__(RgShape<kFmt, kMt>::kThreads, RgShape<kFmt, kMt>::kBlocksPerSm)
    int4g_ring_kernel(const RgArgs a, const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap smap,
                      const __grid_constant__ CUtensorMap zmap) {
  using S = RgShape<kFmt, kMt>;
  constexpr bool kPacked = S::kPacked, kAffine = S::kAffine;
  constexpr int kHalves = S::kHalves, kSlots = S::kSlots, kBm = S::kBm, kWmt = S::kWmt, kWnt = S::kWnt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (pf_smem(smem_raw) & 1023)) & 1023);  // the swizzle's alignment
  unsigned char* x_s = smem;                              // [slots][kBm][128 bytes], swizzled
  unsigned char* b_s = x_s + kSlots * S::kXSlot;          // [slots][kRgCols columns][128 bytes], swizzled
  unsigned char* raw_s = b_s + kSlots * S::kBSlot;        // [kRawBufs][64 rows][128 bytes], swizzled
  float* sz_s = reinterpret_cast<float*>(raw_s + S::kRawBufs * kRgRawBytes);  // [slots][s, z][kRgSzRows][kRgCols]
  uint64_t* full = reinterpret_cast<uint64_t*>(raw_s + S::kRawBufs * kRgRawBytes + kSlots * S::kSzSlot);
  uint64_t* empty = full + kSlots;
  uint64_t* xfull = empty + kSlots;
  uint64_t* wfull = xfull + kSlots;
  __shared__ int last_s;

  const int m = a.m, n = a.n;
  const int half = a.k / 2;
  const int rows_w = kPacked ? half : a.k;  // rows of w
  const int n_chunks = (rows_w + kRgChunk - 1) / kRgChunk;
  const int c0 = blockIdx.z * a.split_chunks;
  const int n_steps = kHalves * (min(n_chunks, c0 + a.split_chunks) - c0);
  const int row0 = blockIdx.y * kBm;
  const int col0 = blockIdx.x * kRgCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // a step's group rows fit kRgSzRows, and a row pair lies in one group
  const bool sz_staged = kAffine && a.gs % 8 == 0;

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      pf_bar_init(&full[i], kRgProducers);
      pf_bar_init(&empty[i], S::kConsumerWarps);
      pf_bar_init(&xfull[i], 1);
      pf_bar_init(&wfull[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[kWmt][kWnt][4];  // the consumers' products (declared for all: the epilogue reads them)
#pragma unroll
  for (int i = 0; i < kWmt; ++i)
#pragma unroll
    for (int jn = 0; jn < kWnt; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;
  const bool consumer = tid >= kRgProducers;
  const int cw = (tid - kRgProducers) >> 5;  // consumer warp (the producers' is negative)
  const int wg = (tid - kRgProducers) >> 7;  // wgmma: the consumer warpgroup

  if (!consumer) {
    // ---------------- producer: the copies (thread 0), kAhead steps ahead, and the conversion
    const int pt = tid;
    const int p = pt & 31;         // rows 2 p, 2 p + 1 of a staged block
    const int cb = pt >> 5;        // columns [32 cb, 32 cb + 32) of the tile: 16-byte pieces 2 cb, 2 cb + 1
    // the first k of step t's half (K13's high nibbles: + K/2)
    auto step_k = [&](int t) { return (c0 + t / kHalves) * kRgChunk + (t % kHalves) * half; };
    // step t's copies, one a producer warp (its lane 0), each after the consumers are done with the slot's
    // last use: warp 0 x's chunk; warp 1 the expected bytes and, with a staged block's first step, its raw
    // weights; warps 2 and 3 the step's group rows of scales and of zeros (K12, K13)
    const int pw = pt >> 5;
    auto issue = [&](int t) {
      const int slot = t % kSlots;
      const int hb = t % kHalves;
      const int r0 = (c0 + t / kHalves) * kRgChunk;
      if (t >= kSlots) pf_bar_wait(&empty[slot], (t / kSlots - 1) & 1);
      if (pw == 0) {
        pf_bar_expect(&xfull[slot], (unsigned)S::kXSlot);
        if (a.x_halves) {
          pf_tma_3d(x_s + slot * S::kXSlot, &xmap, r0, hb, row0, &xfull[slot]);
        } else {
          pf_tma_3d(x_s + slot * S::kXSlot, &xmap, r0 + hb * half, 0, row0, &xfull[slot]);
        }
      } else if (pw == 1) {
        pf_bar_expect(&wfull[slot], (hb == 0 ? kRgRawBytes : 0) + (sz_staged ? (unsigned)S::kSzSlot : 0u));
        if (hb == 0) pf_tma_2d(raw_s + ((t / kHalves) % S::kRawBufs) * kRgRawBytes, &wmap, col0, r0, &wfull[slot]);
      } else if (sz_staged) {
        const float* sz = sz_s + slot * (S::kSzSlot / sizeof(float)) + (pw - 2) * kRgSzRows * kRgCols;
        pf_tma_2d(const_cast<float*>(sz), pw == 2 ? &smap : &zmap, col0, step_k(t) / a.gs, &wfull[slot]);
      }
    };
    if (lane == 0)
      for (int t = 0; t < S::kAhead && t < n_steps; ++t) issue(t);  // the slots' first use: nothing to wait for
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const int slot = t % kSlots;
      const int hb = t % kHalves;
      const int kf = step_k(t);
      const int rl = 2 * p;                            // the thread's first row in the staged block
      const int k0 = kf + rl;                          // its k
      const bool row_ok = (c0 + t / kHalves) * kRgChunk + rl < rows_w;  // rows_w even: both rows or neither
      pf_bar_wait(&wfull[slot], (t / kSlots) & 1);  // step t's raw weights, scales and zeros have landed
      const unsigned char* raw = raw_s + ((t / kHalves) % S::kRawBufs) * kRgRawBytes;
      const float* szr = sz_s + slot * (S::kSzSlot / sizeof(float)) + (k0 / a.gs - kf / a.gs) * kRgCols;
      const size_t go0 = (size_t)(k0 / a.gs) * n + col0, go1 = (size_t)((k0 + 1) / a.gs) * n + col0;
      unsigned char* bd = b_s + slot * S::kBSlot;
      if constexpr (!kAffine) {  // K11: the signed bytes as they are, no affine
        // the 16-byte pieces 2 cb and 2 cb + 1 of the thread's two rows, all loaded first (the swizzle puts
        // piece j of row r at j ^ (r mod 8)); then each column's pair, masked words giving zeros
        uint4 v[2][2];  // [piece 2 cb + h][row 2 p + e]
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[h][e] = *reinterpret_cast<const uint4*>(raw + (rl + e) * kRgCols + (((2 * cb + h) ^ ((rl + e) & 7)) << 4));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cl = 32 * cb + 16 * h;  // columns [cl, cl + 16): n % 16 == 0, all in or all out
          const uint32_t keep = row_ok && col0 + cl < n ? 0xFFFFFFFFu : 0u;
          const uint32_t w0[4] = {v[h][0].x & keep, v[h][0].y & keep, v[h][0].z & keep, v[h][0].w & keep};
          const uint32_t w1[4] = {v[h][1].x & keep, v[h][1].y & keep, v[h][1].z & keep, v[h][1].w & keep};
#pragma unroll
          for (int wd = 0; wd < 4; ++wd)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = cl + 4 * wd + i;
              *reinterpret_cast<uint32_t*>(bd + col * kRgRowBytes + (((rl >> 3) ^ (col & 7)) << 4) + (rl & 7) * 2) =
                  plain_pair(w0[wd], w1[wd], i);
            }
        }
      } else {
        // 8 columns an iteration, not unrolled: the loop's code stays small enough to be fetched at the rate
        // the producers issue it (unrolled, the conversion ran at half the speed)
#pragma unroll 1
        for (int q8 = 0; q8 < 4; ++q8) {
          const int cl = 32 * cb + 8 * q8;  // columns [cl, cl + 8): 8 bytes of piece cl / 16 of each row
          const bool ok = row_ok && col0 + cl < n;  // n % 16 == 0: 8 columns all in or all out
          const uint32_t keep = ok ? 0xFFFFFFFFu : 0u;  // zeros past K and N, by a mask: a branch around each
                                                         // pair's math would keep pairs from overlapping
          uint32_t w[2][2];  // [row 2 p + e][word]
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint2 v = *reinterpret_cast<const uint2*>(raw + (rl + e) * kRgCols +
                                                             (((cl >> 4) ^ ((rl + e) & 7)) << 4) + (cl & 8));
            w[e][0] = v.x, w[e][1] = v.y;
          }
          float s0[8], z0[8], s1[8], z1[8];  // the scales and zeros of the rows' groups
          if (sz_staged) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float4 s4 = *reinterpret_cast<const float4*>(szr + cl + 4 * j);
              const float4 z4 = *reinterpret_cast<const float4*>(szr + kRgSzRows * kRgCols + cl + 4 * j);
              s0[4 * j] = s4.x, s0[4 * j + 1] = s4.y, s0[4 * j + 2] = s4.z, s0[4 * j + 3] = s4.w;
              z0[4 * j] = z4.x, z0[4 * j + 1] = z4.y, z0[4 * j + 2] = z4.z, z0[4 * j + 3] = z4.w;
            }
#pragma unroll
            for (int c = 0; c < 8; ++c) s1[c] = s0[c], z1[c] = z0[c];
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              s0[c] = z0[c] = s1[c] = z1[c] = 0.f;
              if (ok) {
                s0[c] = __ldg(a.sc + go0 + cl + c), z0[c] = __ldg(a.zr + go0 + cl + c);
                s1[c] = __ldg(a.sc + go1 + cl + c), z1[c] = __ldg(a.zr + go1 + cl + c);
              }
            }
          }
#pragma unroll
          for (int wd = 0; wd < 2; ++wd) {  // columns cl + 4 wd .. + 3
            float x0[4], x1[4];  // q + 0.5 of rows 2 p and 2 p + 1
            if constexpr (kPacked) {
              const uint32_t t0 = hb ? (w[0][wd] >> 3) & 0x1E1E1E1Eu : (w[0][wd] << 1) & 0x1E1E1E1Eu;
              const uint32_t t1 = hb ? (w[1][wd] >> 3) & 0x1E1E1E1Eu : (w[1][wd] << 1) & 0x1E1E1E1Eu;
#pragma unroll
              for (int i = 0; i < 4; ++i) x0[i] = nib_value(t0, i), x1[i] = nib_value(t1, i);
            } else {
              const uint32_t e0 = even_bytes(w[0][wd]), o0 = odd_bytes(w[0][wd]);
              const uint32_t e1 = even_bytes(w[1][wd]), o1 = odd_bytes(w[1][wd]);
#pragma unroll
              for (int i = 0; i < 4; ++i) x0[i] = byte_value(e0, o0, i), x1[i] = byte_value(e1, o1, i);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = 4 * wd + i, col = cl + c;
              const uint32_t pair = weight_pair(x0[i], s0[c], z0[c], x1[i], s1[c], z1[c]) & keep;
              *reinterpret_cast<uint32_t*>(bd + col * kRgRowBytes + (((rl >> 3) ^ (col & 7)) << 4) + (rl & 7) * 2) =
                  pair;
            }
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores, for wgmma's reads
      pf_bar_arrive(&full[slot]);  // its weights are ready (x: the slot's xfull barrier)
      if (lane == 0 && t + S::kAhead < n_steps) issue(t + S::kAhead);  // then the copies of a step ahead
    }
  } else {
    // ---------------- consumers: the products
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const int slot = t % kSlots;
      pf_bar_wait(&xfull[slot], (t / kSlots) & 1);
      pf_bar_wait(&full[slot], (t / kSlots) & 1);
      const unsigned char* bs = b_s + slot * S::kBSlot;
      if constexpr (S::kWg) {
        const unsigned char* xs = x_s + slot * S::kXSlot + wg * kWmt * 64 * kRgRowBytes;
        pf_wg_fence();
#pragma unroll
        for (int kk = 0; kk < kRgChunk; kk += 16) {  // a k16 step is 32 bytes further into the swizzled rows
#pragma unroll
          for (int i = 0; i < kWmt; ++i)
            pf_wgmma_n128(reinterpret_cast<float(&)[64]>(acc[i]), pf_desc(xs + i * 64 * kRgRowBytes + kk * 2),
                          pf_desc(bs + kk * 2));
        }
        pf_wg_commit();
        pf_wg_wait0();
      } else {
        const unsigned char* xs = x_s + slot * S::kXSlot;
        const int wcol = cw * 32;
#pragma unroll
        for (int kk = 0; kk < kRgChunk; kk += 16) {
          // row r's (column n's) 16-byte piece p of the swizzled tiles sits at piece p ^ (r mod 8)
          uint32_t af[kWmt][4];
#pragma unroll
          for (int i = 0; i < kWmt; ++i) {
            const int r = i * 16 + (lane & 15);
            pf_ldmatrix_x4(af[i], xs + r * kRgRowBytes + ((((kk >> 3) + (lane >> 4)) ^ (r & 7)) << 4));
          }
          uint32_t bf[kWnt][2];
#pragma unroll
          for (int hb = 0; hb < kWnt / 2; ++hb) {  // (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
            uint32_t bq[4];
            const int nn = wcol + 16 * hb + (lane & 7) + ((lane >> 4) << 3);
            pf_ldmatrix_x4(bq, bs + nn * kRgRowBytes + ((((kk >> 3) + ((lane >> 3) & 1)) ^ (nn & 7)) << 4));
            bf[2 * hb][0] = bq[0], bf[2 * hb][1] = bq[1], bf[2 * hb + 1][0] = bq[2], bf[2 * hb + 1][1] = bq[3];
          }
#pragma unroll
          for (int i = 0; i < kWmt; ++i)
#pragma unroll
            for (int jn = 0; jn < kWnt; ++jn) mma_bf16(acc[i][jn], af[i], bf[jn]);
        }
      }
      __syncwarp();
      if (lane == 0) pf_bar_arrive(&empty[slot]);  // the warp is done with the slot
    }
  }

  // the consumer thread's outputs: column pair jn (col0 + wcol + 8 jn + 2 tig, + 1) of row gid + 8 h of its
  // tile i (wgmma: m64 tile wg kWmt + i, the warp's 16 rows of it; mma.sync: m16 tile i)
  auto out_r = [&](int i, int h) {  // in the tile
    return S::kWg ? 64 * (wg * kWmt + i) + 16 * (cw & 3) + gid + 8 * h : 16 * i + gid + 8 * h;
  };
  auto out_col = [&](int jn) { return col0 + (S::kWg ? 0 : cw * 32) + jn * 8 + 2 * tig; };  // n % 16 == 0
  const bool one = gridDim.z == 1;
  if (consumer) {  // one split: y in x's dtype (K11 times the column's scale); more: the f32 partial
#pragma unroll
    for (int i = 0; i < kWmt; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + out_r(i, h);
        if (r >= m) continue;
#pragma unroll
        for (int jn = 0; jn < kWnt; ++jn) {
          const int col = out_col(jn);
          if (col >= n) continue;
          float v0 = acc[i][jn][2 * h], v1 = acc[i][jn][2 * h + 1];
          if (!one) {
            *reinterpret_cast<float2*>(a.part + ((size_t)blockIdx.z * m + r) * n + col) = make_float2(v0, v1);
            continue;
          }
          if constexpr (!kAffine) {
            const float2 cs = __ldg(reinterpret_cast<const float2*>(a.sc + col));
            v0 *= cs.x, v1 *= cs.y;
          }
          if (a.out_bf16) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.y) + (size_t)r * n + col) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(a.y) + (size_t)r * n + col) = make_float2(v0, v1);
          }
        }
      }
  }
  if (one) return;

  // more than one split: the last block of the tile to finish adds every split's partial in split order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __syncthreads();  // the block's writes happen before thread 0's release
  if (tid == 0) last_s = pf_atom_add_acq_rel(&a.tickets[tile], 1) == (int)gridDim.z - 1;
  __syncthreads();  // and thread 0's acquire before the last block's reads
  if (!last_s) return;
  const int splits = gridDim.z;
  const int rows = min(kBm, m - row0);
  const size_t stride = (size_t)m * n;
  for (int o0 = tid; o0 < rows * (kRgCols / 4); o0 += kRgMergeOut * S::kThreads) {
    size_t off[kRgMergeOut];
    int col[kRgMergeOut];
    bool live[kRgMergeOut];
    float4 sum[kRgMergeOut];
#pragma unroll
    for (int j = 0; j < kRgMergeOut; ++j) {  // 4 columns each
      const int o = o0 + j * S::kThreads;
      col[j] = col0 + 4 * (o % (kRgCols / 4));
      live[j] = o < rows * (kRgCols / 4) && col[j] < n;
      off[j] = (size_t)(row0 + o / (kRgCols / 4)) * n + col[j];
      sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s0 = 0; s0 < splits; s0 += kRgMergeSplits) {
      float4 pv[kRgMergeOut][kRgMergeSplits];
#pragma unroll
      for (int j = 0; j < kRgMergeOut; ++j)
#pragma unroll
        for (int sp = 0; sp < kRgMergeSplits; ++sp)
          pv[j][sp] = live[j] && s0 + sp < splits
                          ? __ldcg(reinterpret_cast<const float4*>(a.part + (s0 + sp) * stride + off[j]))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kRgMergeOut; ++j)
#pragma unroll
        for (int sp = 0; sp < kRgMergeSplits; ++sp)
          if (s0 + sp < splits) {
            sum[j].x += pv[j][sp].x, sum[j].y += pv[j][sp].y;
            sum[j].z += pv[j][sp].z, sum[j].w += pv[j][sp].w;
          }
    }
#pragma unroll
    for (int j = 0; j < kRgMergeOut; ++j) {
      if (!live[j]) continue;
      if constexpr (!kAffine) {  // K11: the column scales times the sum of all of K
        const float4 cs = __ldg(reinterpret_cast<const float4*>(a.sc + col[j]));
        sum[j].x *= cs.x, sum[j].y *= cs.y, sum[j].z *= cs.z, sum[j].w *= cs.w;
      }
      if (a.out_bf16) {
        __nv_bfloat162* yb = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.y) + off[j]);
        yb[0] = __floats2bfloat162_rn(sum[j].x, sum[j].y);
        yb[1] = __floats2bfloat162_rn(sum[j].z, sum[j].w);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(a.y) + off[j]) = sum[j];
      }
    }
  }
  if (tid == 0) a.tickets[tile] = 0;
}

template <int kFmt, int kMt>
cudaError_t rg_launch(const RgArgs& a, const CUtensorMap (&maps)[4], int splits, cudaStream_t s) {
  using S = RgShape<kFmt, kMt>;
  // above 48 KB of shared memory a kernel must opt in, on each device it runs on
  const cudaError_t err = cudaFuncSetAttribute(int4g_ring_kernel<kFmt, kMt>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kRgCols - 1) / kRgCols, (a.m + S::kBm - 1) / S::kBm, splits);
  int4g_ring_kernel<kFmt, kMt><<<grid, S::kThreads, S::kSmem, s>>>(a, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

// Checks the plan's arguments, makes the tensor maps and launches the
// instance of the tile: w (rows of w, n) bytes with a.k the K of x (K13:
// rows K/2); K12's and K13's scales and zeros (k / gs, n) f32, K11's
// (n,) scales. Returns a cudaError_t.
template <int kFmt>
int rg_run(const __nv_bfloat16* x, const uint8_t* w, RgArgs a, int mt, int n_tickets, cudaStream_t s) {
  constexpr bool kPacked = kFmt == kRgP4;
  const int rows_w = kPacked ? a.k / 2 : a.k;
  const int n_chunks = (rows_w + kRgChunk - 1) / kRgChunk;
  if (a.split_chunks < 1 || (mt != 1 && mt != 2 && mt != 4 && mt != 8 && mt != 16))
    return (int)cudaErrorInvalidValue;
  const int splits = (n_chunks + a.split_chunks - 1) / a.split_chunks;
  const int row_tiles = (a.m + 16 * mt - 1) / (16 * mt);
  const long long tiles = (long long)((a.n + kRgCols - 1) / kRgCols) * row_tiles;
  if (splits > 65535 || row_tiles > 65535 ||
      (splits > 1 && (a.part == nullptr || a.tickets == nullptr || tiles > n_tickets)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4] = {};  // K11 stages no scales or zeros: its last two are never read
  // x as (rows, halves, k of a half) where a half's row is a multiple of 16 bytes (K13, k % 16 == 0), so that a
  // chunk of the low half reads zeros past its end; else as (rows, 1, k)
  a.x_halves = kPacked && a.k % 16 == 0;
  const int kin = a.x_halves ? a.k / 2 : a.k;
  const cuuint64_t xdims[3] = {(cuuint64_t)kin, (cuuint64_t)(a.x_halves ? 2 : 1), (cuuint64_t)a.m};
  const cuuint64_t xstrides[2] = {(cuuint64_t)kin * 2, (cuuint64_t)a.k * 2};  // bytes: a half, a row
  const cuuint32_t xbox[3] = {(cuuint32_t)kRgChunk, 1, (cuuint32_t)(16 * mt)};
  // w as (rows, n) bytes, a box a staged block, 128-byte swizzled; s and z as (k / gs, n) f32, a box a
  // step's group rows
  const cuuint64_t wdims[2] = {(cuuint64_t)a.n, (cuuint64_t)rows_w}, wstrides[1] = {(cuuint64_t)a.n};
  const cuuint32_t wbox[2] = {(cuuint32_t)kRgCols, (cuuint32_t)kRgChunk};
  cudaError_t err = pf_tensor_map_3d(&maps[0], x, xdims, xstrides, xbox);
  if (err == cudaSuccess)
    err = pf_tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, wstrides, wbox,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (kFmt != kRgQ8) {
    const cuuint64_t gdims[2] = {(cuuint64_t)a.n, (cuuint64_t)(a.k / a.gs)}, gstrides[1] = {(cuuint64_t)a.n * 4};
    const cuuint32_t gbox[2] = {(cuuint32_t)kRgCols, (cuuint32_t)kRgSzRows};
    if (err == cudaSuccess)
      err = pf_tensor_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.sc, gdims, gstrides, gbox,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
      err = pf_tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.zr, gdims, gstrides, gbox,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return (int)err;
  switch (mt) {
    case 1: return (int)rg_launch<kFmt, 1>(a, maps, splits, s);
    case 2: return (int)rg_launch<kFmt, 2>(a, maps, splits, s);
    case 4: return (int)rg_launch<kFmt, 4>(a, maps, splits, s);
    case 8: return (int)rg_launch<kFmt, 8>(a, maps, splits, s);
    default: return (int)rg_launch<kFmt, 16>(a, maps, splits, s);
  }
}

}  // namespace
