// The decode GEMV on the tensor cores, one launch a product: the products
// of the int32-word decode stack (decode_stack_int4.cu, K3 with int4 words
// and K7 with int8 words) and of the per-layer attention blocks and FFNs
// (decode_block_int4.cu, K5's and K6's int4 words; decode_block_int8.cu,
// K9's and K10's plain int8). Only those three files include it.
//
// y (B, N) = xn (B, K) @ W (K, N) for B <= 8 rows, where xn is x itself or,
// for the products that follow a norm, RMSNorm(x) * w computed here from the
// residual row; W in int32 words: int4 "split-eighth" (bits [4j, 4j+4) of
// word (r, n) hold q[j K/8 + r, n] + 8, groups of 128 rows with s and c =
// z - 7.5 s in sc rows [0, gp) and [gp, 2 gp)) or int8 "split-quarter" (byte
// j of word (r, n) holds q[j K/4 + r, n] + 128; one group over K, s at sc
// row 0 and c = -128 s at row gp); or plain int8 (K, N) with one f32 scale a
// column (VPW 1). The arithmetic is the TPU kernels' (_int4_group_matmul,
// _int8_word_matmul): per group, f32 sums of x times the raw value (a nibble
// 0..15 or a byte 0..255, exact in bf16), times s, plus bf16(sum of x over
// the group) * c; plain int8 (_decode_block_kernel): f32 sums of x times the
// signed byte over all of K, times the column's scale after the merge (each
// matrix its own scales: K10's w1 and w3).
//
// Design:
//   * mma.sync m16n8k16 bf16 -> f32 with the WEIGHTS as A (16 output
//     columns x 16 k) and x as B (16 k x 8 rows; rows >= B are zero and never
//     stored). A k-step is 16 word rows of one nibble slab (int4) or byte
//     lane (int8), so every product of one mma lies in one group. A lane owns
//     4 neighbouring columns (one 16-byte load a word row) and 4 word rows of
//     a k-step; the 8 lane groups of a warp cover 32 columns, a full 128-byte
//     line a row. The lane's rows (4 tig, +1) and (+2, +3) of a column fill
//     the A registers of k (2 tig, +1) and (2 tig + 8, +9); B takes x at the
//     same rows.
//   * int4: a warp loads the words of up to kSgAhead k-steps of one group
//     at once (a batch: the plan gives each warp one), then takes the batch
//     slab pair by slab pair: the f32 sums of a pair over the batch, then
//     times the group's s, into the lane's 8 outputs, so only one pair's
//     accumulators are live. int8 (one group): a ring of kSgAhead steps in
//     flight, each slot refilled as soon as it is used, f32 sums a byte lane
//     over the warp's whole run, times s at the end.
//   * Exact conversion off the int-to-float unit: a nibble pair of two words
//     (rows r, r + 1) becomes the bf16 pair (128 + n, 128 + n') with one byte
//     permute and one lop3 against 0x43004300, and one bf16x2 subtract of 128
//     gives n, n' exactly; a byte b becomes the f32 2^23 + b by one byte
//     permute, one f32 subtract gives b, and one cvt.rn.bf16x2.f32 packs two
//     (a signed byte: its sign bit flipped first, and 2^23 + 128 taken off).
//   * Plain int8: a lane's 4 columns are one 4-byte word a row (rows 4 tig
//     .. + 3 of a k-step), so byte j of two rows' words is the A register of
//     column 4 gid + j. Each warp stages its k-steps (16 rows x 32 bytes) in
//     a shared-memory ring of kSgPlainAhead slots, one 16-byte cp.async a
//     lane a step, and reads the 4-byte words back conflict-free (K9 on an
//     NVIDIA H100 80GB HBM3 at 700 W, one call: 9% faster at pos 255 and 7%
//     at 2047 than 4-byte register loads of the words in a ring 8 deep, 5%
//     and 3% than one 16 deep). No c term and no sums of x: the
//     norm-and-sum pass is skipped.
//   * K is cut into splits of split_steps k-steps (the wrapper's plan,
//     ops/decode_stack.stack_gemv_plan), a split dealt to the block's 4 warps
//     in runs. The warps sum in shared memory; with one split (and one
//     matrix) the block applies the epilogue itself, otherwise it writes its
//     partial to L2 and the last block of its 32-column tile (an
//     acquire-release ticket that block resets to 0) sums the partials in a
//     fixed order and applies it. The same bits every call and every CUDA
//     graph replay.
//   * Programmatic dependent launch: the words of the warp's first batch
//     (to registers), the block's scale and c rows (cp.async to shared
//     memory) and its slice of the norm weights depend on no earlier kernel,
//     so they are loaded BEFORE pdl_wait(). (An L2 prefetch of the words
//     before the wait, with the register loads after the prologue, was 3%
//     slower on the H100.)
//   * The block's K slice of x arrives by bulk copies (cp.async.bulk, one a
//     (slab, row) segment, completing on a transaction barrier), each CTA of
//     a cluster of kSgCluster neighbouring column tiles copying every
//     kSgCluster-th segment into every CTA of the cluster (multicast): all of
//     a product's blocks read the same few KB at once (timer marks: leaving
//     those loads out made the step 12% faster; the multicast took 9.5% off a
//     graph-replayed int4 step at pos 255, 3.9% off int8's; clusters of 4
//     were slower).
//   * After the wait the prologue makes one round of loads: x's segments,
//     the residual of its tile (kSgResid), and each row's sums of squares by
//     32-column tile, which the residual epilogue of the kernel that wrote x
//     left (the first layer's norm sums its full row). It norms the slice in
//     place with RMSNorm's roundings (f32 normalise, round to bf16, times
//     the bf16 weight) and sums it for the c terms: int4 splits hold whole
//     groups, so a block rounds its groups' sums itself; int8 splits leave
//     their f32 sums beside the partials and the merging block rounds the
//     total. Then pdl_trigger() lets the next kernel of the step start
//     loading its weights while this one computes.
//   What holds it (globaltimer marks in an experiment build,
//   tools/stack_marks.py, H100, int4 at pos 255): a product takes 8-12 us
//   from its wait to its last block's end, about 49 us a layer with the
//   attention split's 5 and the combine's hand-off 6; in a product, waiting
//   for the slice and scalars takes 0.7-1.3 us, the norm-and-sum pass
//   0.8-1.6, the products 2-2.5 and the epilogue or merge 0.6-3 us: a chain
//   of dependent phases at 1-3 blocks an SM, where the weight bytes alone
//   would take 0.6-3.4 us (PERF.md section 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"

namespace {

constexpr int kSgCols = 32;         // output columns a block: 8 lane groups of kSgLaneCols
constexpr int kSgLaneCols = 4;      // neighbouring columns a lane: one 16-byte load a word row
constexpr int kSgStepRows = 16;     // word rows a k-step (the mma's depth)
constexpr int kSgWarps = 4;         // warps a block
constexpr int kSgThreads = kSgWarps * 32;
constexpr int kSgMinBlocks = 3;     // blocks an SM the registers must allow (the plan's aim)
constexpr int kSgRows = 8;          // rows of x: the mma's N
constexpr int kSgAhead = 4;         // k-steps whose words a warp loads at once (a batch)
constexpr int kSgPlainAhead = 8;    // plain int8: k-steps of 512 bytes a warp has in flight
constexpr int kSgPlainStep = kSgStepRows * kSgCols;  // plain int8: bytes a warp's k-step
constexpr int kSgQGroup = 128;      // int4 group: word rows of a slab
constexpr int kSgGroupSteps = kSgQGroup / kSgStepRows;  // int4 k-steps a group: splits hold whole groups
constexpr int kSgMaxCGroups = 4;    // int4 groups a split holds at most (split_steps <= 32)
// (slab, row) rows a warp takes at once in the norm-and-sum pass (H100, one call: int4 1.2% faster at 4
// than at 2, int8 4% faster at 2 than at 4)
constexpr int kSgPassRowsI4 = 4;
constexpr int kSgPassRowsI8 = 2;
constexpr int kSgSsVec = 8;         // 16-byte loads a lane has in flight for a full row's sum of squares
constexpr int kSgMaxSsTiles = 4 * 32;  // tiles of sums of squares a row (one float4 a lane), at most
constexpr int kSgMergeVec = 8;      // split partials the merging block loads at once
constexpr int kSgCluster = 2;        // column tiles a cluster: each slice is read from L2 once a cluster
constexpr int kSgXBytes = 36 * 1024;  // the x slice and the norm weights' slice in shared memory, at most

enum SgEpi { kSgF32 = 0, kSgQKV = 1, kSgResid = 2, kSgSwiglu = 3, kSgBf16 = 4 };

struct SgMat {
  const int32_t* pw;        // (K / VPW, N) words; plain int8: (K, N) bytes
  const __nv_bfloat16* sc;  // (2 gp, N); plain int8: unread
};

// One product: its input, weights, cut of K and epilogue.
struct SgArgs {
  const __nv_bfloat16* x;       // (B, K): the residual stream (norm_w set) or the activations
  const __nv_bfloat16* norm_w;  // (K,) RMSNorm weight, or nullptr: x as it is
  float eps;
  SgMat m0, m1;                 // m1: w3 beside w1 (kSgSwiglu, grid z 2)
  int b_rows, k, n, gp, split_steps;
  int epi;
  const float* col_scale;       // plain int8: m0's (N,) f32, times the merged sum
  const float* col_scale1;      // plain int8: m1's (grid z 2)
  float* out_f32;               // kSgF32, kSgQKV: (B, N)
  __nv_bfloat16* out_bf16;      // kSgResid: bf16(resid + bf16(y)), in place when resid is it; kSgSwiglu; kSgBf16
  const __nv_bfloat16* resid;
  __nv_bfloat16* k_cache;       // kSgQKV: columns >= d go to the cache row at (layer, *pos)
  __nv_bfloat16* v_cache;
  const int* pos;
  int layer, seq_len, d, dkv;
  float* part;                  // (mats, splits, B, N) partials when the grid has more than one part
  int* tickets;                 // a column tile's arrivals, 0 between launches
  // Sums of squares of the residual stream by 32-column tile, (B, N / 32):
  // written by the residual epilogue (ss_out), read by the next norm
  // (ss_in, at most kSgMaxSsTiles tiles; nullptr: the block sums the full
  // row itself).
  float* ss_out;
  const float* ss_in;
};

// bf16 elements between two (slab, row) rows of the x slice: a multiple of
// 64 plus 16, so that the 8-byte B reads of a half warp (4 rows x 4 lanes)
// fall in distinct banks.
__host__ __device__ constexpr int sg_x_stride(int split_steps) {
  return (split_steps * kSgStepRows + 63) / 64 * 64 + 16;
}

// The x slice, [slab][row][stride], and the norm weights' slice after it, [slab][stride].
__host__ __device__ constexpr int sg_x_bytes(int vpw, int b_rows, int split_steps) {
  return vpw * (b_rows + 1) * sg_x_stride(split_steps) * 2;
}

__device__ __forceinline__ float sg_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void sg_mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int sg_atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// (a & b) | c in one instruction.
__device__ __forceinline__ uint32_t sg_and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t sg_minus128(uint32_t v) {
  const uint32_t k128 = 0x43004300u;  // the bf16 pair (128, 128)
  __nv_bfloat162 p = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&k128));
  return *reinterpret_cast<uint32_t*>(&p);
}

// Nibbles 2 byte and 2 byte + 1 of two words w0, w1 (rows r, r + 1 of one
// column) as exact bf16 pairs (w0's in the low half): lo for slab 2 byte, hi
// for slab 2 byte + 1.
__device__ __forceinline__ void sg_nibble_pairs(uint32_t w0, uint32_t w1, int byte, uint32_t& lo,
                                                uint32_t& hi) {
  const uint32_t v = __byte_perm(w0, w1, byte | ((4 + byte) << 8));  // the bytes at bits 0 and 16
  lo = sg_minus128(sg_and_or(v, 0x000F000Fu, 0x43004300u));
  hi = sg_minus128(sg_and_or(v >> 4, 0x000F000Fu, 0x43004300u));
}

// Byte j of two words w0, w1 as the exact bf16 pair (w0's in the low half).
__device__ __forceinline__ uint32_t sg_byte_pair(uint32_t w0, uint32_t w1, int j) {
  const float f0 = __int_as_float((int)__byte_perm(w0, 0x4B000000u, 0x7540u + j)) - 8388608.0f;
  const float f1 = __int_as_float((int)__byte_perm(w1, 0x4B000000u, 0x7540u + j)) - 8388608.0f;
  __nv_bfloat162 p = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Signed byte j of two words whose sign bits are flipped (w ^ 0x80808080)
// as the exact bf16 pair.
__device__ __forceinline__ uint32_t sg_sbyte_pair(uint32_t f0w, uint32_t f1w, int j) {
  __nv_bfloat162 p = __floats2bfloat162_rn(sbyte_float(f0w, j), sbyte_float(f1w, j));
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void sg_cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void sg_cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The x slice's bulk copies (the tensor-memory-access unit) and the
// transaction barrier they complete, in the CTA's shared memory.
__device__ __forceinline__ unsigned sg_smem(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void sg_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(sg_smem(bar))
               : "memory");
}

// The barrier's one arrival, expecting `bytes` of copies (which may land before it).
__device__ __forceinline__ void sg_bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n" ::"r"(sg_smem(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void sg_bar_wait(uint64_t* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sg_smem(bar))
        : "memory");
}

// bytes (a multiple of 16) from global src to dst in the shared memory of
// every CTA of the cluster in mask (at dst's offset), completing on each
// one's barrier at bar's offset.
__device__ __forceinline__ void sg_bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar,
                                             uint16_t mask) {
  if (kSgCluster == 1)
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     sg_smem(dst)),
                 "l"(src), "r"(bytes), "r"(sg_smem(bar))
                 : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
        "%4;\n" ::"r"(sg_smem(dst)),
        "l"(src), "r"(bytes), "r"(sg_smem(bar)), "h"(mask)
        : "memory");
}

__device__ __forceinline__ void sg_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned sg_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Element h (0 or 1) of a bf16 pair as f32.
__device__ __forceinline__ float sg_half(uint32_t pair, int h) {
  return __uint_as_float(h ? pair & 0xFFFF0000u : pair << 16);
}

// Applies the epilogue to y (and y3) at (b, col) -> the square of the new
// residual value (kSgResid), else 0. resid: the residual at (b, col), and
// pos: *a.pos (kSgQKV), both read in the prologue.
__device__ __forceinline__ float sg_epilogue(const SgArgs& a, int b, int col, float y, float y3, float resid,
                                             int pos) {
  const size_t i = (size_t)b * a.n + col;
  switch (a.epi) {
    case kSgF32:
      a.out_f32[i] = y;
      break;
    case kSgQKV: {
      a.out_f32[i] = y;
      const int c = col - a.d;
      if (c >= 0) {
        __nv_bfloat16* cache = c < a.dkv ? a.k_cache : a.v_cache;
        const int cc = c < a.dkv ? c : c - a.dkv;
        cache[(((size_t)a.layer * a.seq_len + pos) * a.b_rows + b) * a.dkv + cc] = __float2bfloat16_rn(y);
      }
      break;
    }
    case kSgResid: {
      const __nv_bfloat16 v = __float2bfloat16_rn(resid + round_bf16(y));
      a.out_bf16[i] = v;
      return bf(v) * bf(v);
    }
    case kSgSwiglu:
      a.out_bf16[i] = __float2bfloat16_rn(y / (1.f + expf(-y)) * y3);
      break;
    case kSgBf16:
      a.out_bf16[i] = __float2bfloat16_rn(y);
      break;
  }
  return 0.f;
}

// After an epilogue by every lane of a warp on one row b of the tile: that
// row's sum of squares of the tile's new residual values.
__device__ __forceinline__ void sg_tile_squares(const SgArgs& a, int b, float sq) {
  if (a.ss_out == nullptr) return;
  sq = sg_warp_sum(sq);
  if ((threadIdx.x & 31) == 0) a.ss_out[(size_t)b * (a.n / kSgCols) + blockIdx.x] = sq;
}

// Grid (N / 32 column tiles, splits, matrices), kSgThreads threads, dynamic
// shared memory sg_x_bytes(VPW, B, split_steps). VPW: 8 (int4) or 4 (int8)
// values a word, or 1 (plain int8, no norm; one matrix, or w1 and w3 with
// the SwiGLU epilogue, each with its own column scales).
template <int VPW>
__global__ void __launch_bounds__(kSgThreads, kSgMinBlocks) stack_gemv(SgArgs a) {
  constexpr bool kInt8 = VPW == 4;
  constexpr bool kInt4 = VPW == 8;
  constexpr bool kPlain = VPW == 1;
  constexpr int kCRows = kInt4 ? kSgMaxCGroups * VPW : 1;  // scale (and c) rows a block holds
  extern __shared__ uint4 sg_dyn[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(sg_dyn);  // [slab][row][stride]
  __shared__ float s_red[kSgWarps][kSgRows][kSgCols];
  __shared__ float s_inv[kSgRows];
  __shared__ float s_cs[kInt4 ? kSgMaxCGroups : 1][kInt4 ? VPW : 1][kSgRows];  // int4: bf16 group sums
  __shared__ float s_cx[kSgRows];  // int8: the split's f32 sum of x
  __shared__ float s_rowsum[kInt8 ? VPW : 1][kSgRows];  // int8: each (slab, row)'s sum of x
  __shared__ float s_resid[kSgRows][kSgCols];  // kSgResid: the tile's residual
  // the tile's s and c rows of the split's groups: [group][slab][column] (int8: the one row)
  __shared__ __align__(16) __nv_bfloat16 s_sc[kCRows][kSgCols];
  __shared__ __align__(16) __nv_bfloat16 s_c[kCRows][kSgCols];
  __shared__ bool s_last;
  __shared__ __align__(8) uint64_t s_bar;  // the slice's bulk copies

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int mat = blockIdx.z;
  const SgMat m = mat == 0 ? a.m0 : a.m1;
  const int b_rows = a.b_rows;
  const int kw = a.k / VPW;  // word rows
  const int steps = kw / kSgStepRows;
  const int col0 = blockIdx.x * kSgCols;
  const int col = col0 + kSgLaneCols * gid;  // the lane's 4 columns
  const int split = blockIdx.y;
  const int s_begin = split * a.split_steps;
  const int s_end = min(s_begin + a.split_steps, steps);
  const int warp_steps = (a.split_steps + kSgWarps - 1) / kSgWarps;
  const int ks_begin = s_begin + warp * warp_steps;
  const int ks_end = min(ks_begin + warp_steps, s_end);
  const int group_steps = kInt8 ? steps : kSgGroupSteps;
  const int n_grp_slab = kInt8 ? 1 : kw / kSgQGroup;  // groups a slab
  const int cg0 = s_begin / group_steps;              // int4: the split's first group in each slab
  const int n_cg = kInt8 ? 1 : (s_end - s_begin) / group_steps;
  const int stride = sg_x_stride(a.split_steps);
  const int32_t* wl = m.pw + (size_t)(4 * tig) * a.n + col;  // the lane's first word row of step 0

  // int4 takes its run in batches, steps [ks0, batch_end(ks0)) inside one
  // group; int8 (one group) in a ring of kSgAhead steps, a slot refilled
  // with the step kSgAhead later as soon as it is used
  auto batch_end = [&](int ks0) { return min(min(ks0 + kSgAhead, ks_end), (ks0 / group_steps + 1) * group_steps); };
  uint4 wv[kSgAhead][4];  // [step][row 4 tig + r]: the words of the lane's 4 columns
  auto load_step = [&](int u, int ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wv[u][r] = __ldg(reinterpret_cast<const uint4*>(wl + (size_t)(ks * kSgStepRows + r) * a.n));
  };
  auto load_batch = [&](int ks0) {
    const int ks1 = batch_end(ks0);
#pragma unroll
    for (int u = 0; u < kSgAhead; ++u) {
      if (ks0 + u < ks1) {
        load_step(u, ks0 + u);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[u][r] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  // plain int8: lane L copies row L / 2, half L % 2 of k-step ks into slot
  // u of the warp's ring (after the x slice), laid out [row % 4][row / 4][32
  // bytes], so that the 4-byte reads of lane (gid, tig) at rows 4 tig + r
  // fall in 32 distinct banks; one commit group a step
  unsigned char* pring = reinterpret_cast<unsigned char*>(sg_dyn) + sg_x_bytes(VPW, b_rows, a.split_steps) +
                         (size_t)warp * kSgPlainAhead * kSgPlainStep;
  const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(m.pw) + col0 + 16 * (lane & 1);
  auto load_plain = [&](int u, int ks) {
    const int row = lane >> 1;
    sg_cp_async16(pring + u * kSgPlainStep + (row & 3) * 128 + (row >> 2) * 32 + 16 * (lane & 1),
                  wsrc + (size_t)(ks * kSgStepRows + row) * a.n);
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::: "memory"); };

  // before the wait, what depends on no earlier kernel: the first batch's
  // words, and the s and c rows of the split's groups for the tile (int4
  // row j n_grp_slab + g of slab j, group g; int8 rows 0 and gp)
  if constexpr (kPlain) {
#pragma unroll
    for (int u = 0; u < kSgPlainAhead; ++u) {
      if (ks_begin + u < ks_end) load_plain(u, ks_begin + u);
      commit();
    }
  } else {
    for (int i = tid; i < kCRows * 2 * (kSgCols / 8); i += kSgThreads) {
      const int piece = i % (kSgCols / 8);  // 16 bytes: 8 columns
      const int row = (i / (kSgCols / 8)) % kCRows;
      const bool is_c = i >= kCRows * (kSgCols / 8);
      const int cg = row / VPW, j = row % VPW;
      if (!kInt8 && cg >= n_cg) continue;
      const int src_row = kInt8 ? 0 : j * n_grp_slab + cg0 + cg;
      sg_cp_async16(&(is_c ? s_c : s_sc)[row][8 * piece],
                    m.sc + (size_t)(src_row + (is_c ? a.gp : 0)) * a.n + col0 + 8 * piece);
    }
    if (ks_begin < ks_end) load_batch(ks_begin);
  }

  // the block's K slice of x and of the norm weights: one bulk copy a (slab,
  // row) segment, each CTA of the cluster (kSgCluster neighbouring column
  // tiles: the same split and matrix, so the same slice) copying every
  // kSgCluster-th segment into every CTA's shared memory; the norm weights'
  // depend on no earlier kernel and go before the wait, x's after it
  const bool norm = a.norm_w != nullptr;
  const int r8n = (s_end - s_begin) * kSgStepRows / 8;  // 16-byte pieces of a slab's slice
  const int k_off = s_begin * kSgStepRows;
  __nv_bfloat16* sw = sx + (size_t)VPW * b_rows * stride;  // the norm weights' slice: [slab][stride]
  const int copy_rows = b_rows + (norm ? 1 : 0);  // rows of x, then the norm weights'
  const int n_seg = VPW * copy_rows;
  const unsigned rank = kSgCluster > 1 ? sg_cluster_rank() : 0;
  auto copy_segments = [&](bool weights) {
    for (int sg = rank + kSgCluster * tid; sg < n_seg; sg += kSgCluster * kSgThreads) {
      const int j = sg / copy_rows;
      const int b = sg - j * copy_rows;
      if ((b == b_rows) != weights) continue;
      __nv_bfloat16* dst = b < b_rows ? sx + (size_t)(j * b_rows + b) * stride : sw + (size_t)j * stride;
      const __nv_bfloat16* src = (b < b_rows ? a.x + (size_t)b * a.k : a.norm_w) + (size_t)j * kw + k_off;
      sg_bulk_copy(dst, src, 16u * r8n, &s_bar, (1u << kSgCluster) - 1);
    }
  };
  if (tid == 0) sg_bar_init(&s_bar);
  if constexpr (kSgCluster > 1) {
    sg_cluster_sync();  // every CTA's barrier is set up before any copy lands in it
  } else {
    __syncthreads();
  }
  if (tid == 0) sg_bar_expect(&s_bar, 16u * r8n * n_seg);
  if (norm) copy_segments(true);
  pdl_wait();

  // the prologue's one round of loads: the slice of x, then the few scalars
  copy_segments(false);
  float rv[kSgRows * kSgCols / kSgThreads];  // kSgResid: the tile's residual, (b, column) i = tid + 128 q
#pragma unroll
  for (int q = 0; q < kSgRows * kSgCols / kSgThreads; ++q) {
    const int i = tid + q * kSgThreads;
    rv[q] = a.epi == kSgResid && i < b_rows * kSgCols
                ? bf(__ldcg(a.resid + (size_t)(i / kSgCols) * a.n + col0 + i % kSgCols))
                : 0.f;
  }
  const int pos = a.epi == kSgQKV ? __ldcg(a.pos) : 0;
  const int n_tiles = a.k / kSgCols;
  const bool tiles_ss = norm && a.ss_in != nullptr;
  float4 ssv[kSgRows / kSgWarps];  // rows warp and warp + 4: their tiles' sums of squares, 4 a lane
#pragma unroll
  for (int q = 0; q < kSgRows / kSgWarps; ++q) {
    const int b = warp + q * kSgWarps;
    ssv[q] = tiles_ss && b < b_rows && 4 * lane < n_tiles
                 ? __ldcg(reinterpret_cast<const float4*>(a.ss_in + (size_t)b * n_tiles) + lane)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tiles_ss) {
#pragma unroll
    for (int q = 0; q < kSgRows / kSgWarps; ++q) {
      const int b = warp + q * kSgWarps;
      const float ss = sg_warp_sum((ssv[q].x + ssv[q].y) + (ssv[q].z + ssv[q].w));
      if (lane == 0 && b < b_rows) s_inv[b] = 1.f / sqrtf(ss / (float)a.k + a.eps);
    }
  } else if (norm) {  // the full row
    for (int b = warp; b < b_rows; b += kSgWarps) {
      float ss = 0.f;
      for (int k0 = 8 * lane; k0 < a.k; k0 += 8 * 32 * kSgSsVec) {
        uint4 v[kSgSsVec];
#pragma unroll
        for (int u = 0; u < kSgSsVec; ++u) {
          const int k = k0 + u * 8 * 32;
          v[u] = k < a.k ? __ldcg(reinterpret_cast<const uint4*>(a.x + (size_t)b * a.k + k)) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kSgSsVec; ++u) {
          const uint32_t xs[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float f = sg_half(xs[e / 2], e & 1);
            ss += f * f;
          }
        }
      }
      ss = sg_warp_sum(ss);
      if (lane == 0) s_inv[b] = 1.f / sqrtf(ss / (float)a.k + a.eps);
    }
  }
#pragma unroll
  for (int q = 0; q < kSgRows * kSgCols / kSgThreads; ++q) {
    const int i = tid + q * kSgThreads;
    if (i < b_rows * kSgCols) s_resid[i / kSgCols][i % kSgCols] = rv[q];
  }
  if constexpr (!kPlain) sg_cp_async_wait_all();  // plain int8: its ring's copies are waited for one by one
  sg_bar_wait(&s_bar);
  __syncthreads();
  // one pass over the x slice, a warp a (slab, row) row: RMSNorm's roundings
  // in place, bf16(bf16(x * inv) * w), and the c terms' sums of x. int4: a
  // group is 128 values, 16 pieces, so half a warp's pieces of one pass:
  // the half's sum, rounded to bf16. int8: the row's f32 sum, and the split's
  // is the rows' in slab order (rounded once the splits' sums are added).
  // a warp takes kPassRows rows at a time, for independent work between its shuffles
  constexpr int kPassRows = kInt8 ? kSgPassRowsI8 : kSgPassRowsI4;
  const int n_rows = kPlain ? 0 : VPW * b_rows;  // plain int8: neither norm nor c terms
  for (int row0 = warp; row0 < n_rows; row0 += kPassRows * kSgWarps) {
    int j[kPassRows], b[kPassRows];
    bool live[kPassRows];
#pragma unroll
    for (int h = 0; h < kPassRows; ++h) {
      const int row = row0 + h * kSgWarps;
      live[h] = row < n_rows;
      j[h] = row / b_rows;
      b[h] = row - j[h] * b_rows;
    }
    float row_sum[kPassRows] = {};
    for (int r0 = 0; r0 < r8n; r0 += 32) {
      const int r8 = r0 + lane;
      float sum[kPassRows] = {};
#pragma unroll
      for (int h = 0; h < kPassRows; ++h) {
        if (!live[h] || r8 >= r8n) continue;
        __nv_bfloat16* px = sx + (size_t)(j[h] * b_rows + b[h]) * stride + 8 * r8;
        uint4 xr = *reinterpret_cast<const uint4*>(px);
        uint32_t* xs = reinterpret_cast<uint32_t*>(&xr);
        if (norm) {
          const uint4 wr = *reinterpret_cast<const uint4*>(sw + (size_t)j[h] * stride + 8 * r8);
          const uint32_t ws[4] = {wr.x, wr.y, wr.z, wr.w};
          const float inv = s_inv[b[h]];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float lo = round_bf16(round_bf16(sg_half(xs[q], 0) * inv) * sg_half(ws[q], 0));
            const float hi = round_bf16(round_bf16(sg_half(xs[q], 1) * inv) * sg_half(ws[q], 1));
            __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
            xs[q] = *reinterpret_cast<uint32_t*>(&p);
          }
          *reinterpret_cast<uint4*>(px) = xr;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[h] += sg_half(xs[q], 0) + sg_half(xs[q], 1);
      }
      if constexpr (!kInt4) {
#pragma unroll
        for (int h = 0; h < kPassRows; ++h) row_sum[h] += sum[h];
      } else {  // pieces 16 g .. 16 g + 15 form group g of the split
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
#pragma unroll
          for (int h = 0; h < kPassRows; ++h) sum[h] += __shfl_xor_sync(kFull, sum[h], off);
#pragma unroll
        for (int h = 0; h < kPassRows; ++h)
          if (live[h] && (lane & 15) == 0 && r8 < r8n) s_cs[r8 / 16][j[h]][b[h]] = round_bf16(sum[h]);
      }
    }
    if constexpr (kInt8) {
#pragma unroll
      for (int h = 0; h < kPassRows; ++h) {
        const float total = sg_warp_sum(row_sum[h]);
        if (live[h] && lane == 0) s_rowsum[j[h]][b[h]] = total;
      }
    }
  }
  __syncthreads();
  if constexpr (kInt8) {
    if (tid < b_rows) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < VPW; ++j) sum += s_rowsum[j][tid];
      s_cx[tid] = sum;
    }
    __syncthreads();
  }
  pdl_trigger();

  // the products: out[cp][e] is column 4 gid + 2 cp + (e >> 1), row 2 tig + (e & 1)
  float out[2][4];
#pragma unroll
  for (int cp = 0; cp < 2; ++cp)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[cp][e] = 0.f;
  const bool x_ok = gid < b_rows;
  const __nv_bfloat16* sxl = sx + (size_t)gid * stride + 4 * tig;  // the lane's row of x, slab 0
  auto x_frag = [&](int j, int rr, uint32_t (&xb)[2]) {  // B: x at rows 4 tig .. +3 of slab j
    uint2 v = make_uint2(0, 0);
    if (x_ok) v = *reinterpret_cast<const uint2*>(sxl + (size_t)j * b_rows * stride + rr);
    xb[0] = v.x;
    xb[1] = v.y;
  };
  // out += acc (a slab's f32 sums over the batch) times s of slab j's row of the batch's group
  auto fold = [&](const float (&acc)[2][4], int srow) {
    const uint2 sp = *reinterpret_cast<const uint2*>(&s_sc[srow][kSgLaneCols * gid]);
#pragma unroll
    for (int cp = 0; cp < 2; ++cp)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[cp][e] = fmaf(acc[cp][e], sg_half(cp == 0 ? sp.x : sp.y, e >> 1), out[cp][e]);
  };
  if constexpr (kPlain) {
    float acc[2][4] = {};  // [column pair][mma D]: f32 sums over the whole run, unscaled
    for (int ks0 = ks_begin; ks0 < ks_end; ks0 += kSgPlainAhead) {
#pragma unroll
      for (int u = 0; u < kSgPlainAhead; ++u) {
        const int ks = ks0 + u;
        if (ks >= ks_end) break;
        uint32_t xb[2];
        x_frag(0, (ks - s_begin) * kSgStepRows, xb);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kSgPlainAhead - 1) : "memory");
        __syncwarp();  // slot u has landed for the whole warp
        uint32_t f[4];  // rows 4 tig + r, sign bits flipped
#pragma unroll
        for (int r = 0; r < 4; ++r)
          f[r] = *reinterpret_cast<const uint32_t*>(pring + u * kSgPlainStep + r * 128 + tig * 32 + 4 * gid) ^
                 0x80808080u;
        __syncwarp();  // and is read before it is refilled
#pragma unroll
        for (int cp = 0; cp < 2; ++cp) {
          // A rows gid (column 2 cp) and gid + 8 (column 2 cp + 1); k rows (0, 1) and (2, 3)
          const uint32_t af[4] = {sg_sbyte_pair(f[0], f[1], 2 * cp), sg_sbyte_pair(f[0], f[1], 2 * cp + 1),
                                  sg_sbyte_pair(f[2], f[3], 2 * cp), sg_sbyte_pair(f[2], f[3], 2 * cp + 1)};
          sg_mma(acc[cp], af, xb);
        }
        if (ks + kSgPlainAhead < ks_end) load_plain(u, ks + kSgPlainAhead);  // refill the slot
        commit();
      }
    }
#pragma unroll
    for (int cp = 0; cp < 2; ++cp)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[cp][e] = acc[cp][e];
  } else if constexpr (kInt8) {
    float acc[4][2][4];  // [byte lane][column pair][mma D]: one group, so f32 sums over the whole run
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int cp = 0; cp < 2; ++cp)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][cp][e] = 0.f;
    for (int ks0 = ks_begin; ks0 < ks_end; ks0 += kSgAhead) {
#pragma unroll
      for (int u = 0; u < kSgAhead; ++u) {
        const int ks = ks0 + u;
        if (ks >= ks_end) break;
        const uint4* w = wv[u];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t xb[2];
          x_frag(j, (ks - s_begin) * kSgStepRows, xb);
#pragma unroll
          for (int cp = 0; cp < 2; ++cp) {
            // A rows gid (column 2 cp) and gid + 8 (column 2 cp + 1); k rows (0, 1) and (2, 3)
            const uint32_t c0r0 = cp == 0 ? w[0].x : w[0].z, c1r0 = cp == 0 ? w[0].y : w[0].w;
            const uint32_t c0r1 = cp == 0 ? w[1].x : w[1].z, c1r1 = cp == 0 ? w[1].y : w[1].w;
            const uint32_t c0r2 = cp == 0 ? w[2].x : w[2].z, c1r2 = cp == 0 ? w[2].y : w[2].w;
            const uint32_t c0r3 = cp == 0 ? w[3].x : w[3].z, c1r3 = cp == 0 ? w[3].y : w[3].w;
            const uint32_t af[4] = {sg_byte_pair(c0r0, c0r1, j), sg_byte_pair(c1r0, c1r1, j),
                                    sg_byte_pair(c0r2, c0r3, j), sg_byte_pair(c1r2, c1r3, j)};
            sg_mma(acc[j][cp], af, xb);
          }
        }
        if (ks + kSgAhead < ks_end) load_step(u, ks + kSgAhead);  // refill the slot
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) fold(acc[j], 0);
  } else {
    for (int ks0 = ks_begin; ks0 < ks_end;) {
      if (ks0 != ks_begin) load_batch(ks0);
      const int ks1 = batch_end(ks0);
      const int g = ks0 / group_steps - cg0;  // the batch's group in the split
#pragma unroll
      for (int byte = 0; byte < 4; ++byte) {  // slabs 2 byte and 2 byte + 1
        float acc[2][2][4] = {};
#pragma unroll
        for (int u = 0; u < kSgAhead; ++u) {
          if (ks0 + u >= ks1) break;
          const int rr = (ks0 + u - s_begin) * kSgStepRows;
          uint32_t xlo[2], xhi[2];
          x_frag(2 * byte, rr, xlo);
          x_frag(2 * byte + 1, rr, xhi);
          const uint32_t w[4][4] = {{wv[u][0].x, wv[u][0].y, wv[u][0].z, wv[u][0].w},
                                    {wv[u][1].x, wv[u][1].y, wv[u][1].z, wv[u][1].w},
                                    {wv[u][2].x, wv[u][2].y, wv[u][2].z, wv[u][2].w},
                                    {wv[u][3].x, wv[u][3].y, wv[u][3].z, wv[u][3].w}};  // [row][column]
          uint32_t lo[4][2], hi[4][2];  // [column][row pair]
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int rp = 0; rp < 2; ++rp)
              sg_nibble_pairs(w[2 * rp][c], w[2 * rp + 1][c], byte, lo[c][rp], hi[c][rp]);
#pragma unroll
          for (int cp = 0; cp < 2; ++cp) {
            const uint32_t al[4] = {lo[2 * cp][0], lo[2 * cp + 1][0], lo[2 * cp][1], lo[2 * cp + 1][1]};
            const uint32_t ah[4] = {hi[2 * cp][0], hi[2 * cp + 1][0], hi[2 * cp][1], hi[2 * cp + 1][1]};
            sg_mma(acc[0][cp], al, xlo);
            sg_mma(acc[1][cp], ah, xhi);
          }
        }
        fold(acc[0], g * VPW + 2 * byte);
        fold(acc[1], g * VPW + 2 * byte + 1);
      }
      ks0 = ks1;
    }
  }

  // the warps' sums, then the block's: one value a (row, column) of the tile
#pragma unroll
  for (int cp = 0; cp < 2; ++cp)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = 2 * tig + (e & 1);
      if (b < b_rows) s_red[warp][b][kSgLaneCols * gid + 2 * cp + (e >> 1)] = out[cp][e];
    }
  __syncthreads();
  const int n_parts = gridDim.y * gridDim.z;
  // int8 with more than one part: the split's sum of x goes beside the partials
  float* part_x = a.part + (size_t)gridDim.z * gridDim.y * b_rows * a.n;
  if (kInt8 && n_parts > 1 && tid < b_rows) part_x[(mat * gridDim.y + split) * b_rows + tid] = s_cx[tid];
  for (int i = tid; i < b_rows * kSgCols; i += kSgThreads) {
    const int b = i / kSgCols;
    const int cc = i % kSgCols;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kSgWarps; ++wp) v += s_red[wp][b][cc];
    if (kInt4)
      for (int cg = 0; cg < n_cg; ++cg)
#pragma unroll
        for (int j = 0; j < VPW; ++j) v += s_cs[cg][j][b] * bf(s_c[cg * VPW + j][cc]);
    if (n_parts == 1) {
      if (kInt8) v += round_bf16(s_cx[b]) * bf(s_c[0][cc]);
      if (kPlain) v *= a.col_scale[col0 + cc];  // one part: one matrix
      sg_tile_squares(a, b, sg_epilogue(a, b, col0 + cc, v, 0.f, s_resid[b][cc], pos));
    } else {
      a.part[((size_t)(mat * gridDim.y + split) * b_rows + b) * a.n + col0 + cc] = v;
    }
  }
  if (n_parts == 1) return;
  __syncthreads();  // the block's writes happen before thread 0's release
  if (tid == 0) s_last = sg_atom_add_acq_rel(&a.tickets[blockIdx.x], 1) == n_parts - 1;
  __syncthreads();  // and thread 0's acquire before the last block's reads
  if (!s_last) return;
  // the merge, in a fixed order; each output loads up to kSgMergeVec splits' partials at once
  const size_t mat_stride = (size_t)gridDim.y * b_rows * a.n;
  const size_t split_stride = (size_t)b_rows * a.n;
  const int n_splits = gridDim.y;
  for (int i = tid; i < b_rows * kSgCols; i += kSgThreads) {
    const int b = i / kSgCols;
    const int cc = i % kSgCols;
    float y[2] = {0.f, 0.f};  // the matrices' sums (y[1]: w3)
    // plain int8: each matrix's column scale, loaded before the partials (a
    // scale picked by z inside the loop waited for them: K9 3% slower on the H100)
    const float cs0 = kPlain ? a.col_scale[col0 + cc] : 0.f;
    const float cs1 = kPlain && gridDim.z > 1 ? a.col_scale1[col0 + cc] : 0.f;
    for (int z = 0; z < (int)gridDim.z; ++z) {
      const float* p = a.part + z * mat_stride + (size_t)b * a.n + col0 + cc;
      const float* px = part_x + (size_t)z * n_splits * b_rows + b;
      float xs = 0.f;
      for (int s0 = 0; s0 < n_splits; s0 += kSgMergeVec) {
        float pv[kSgMergeVec], pxv[kSgMergeVec];
#pragma unroll
        for (int q = 0; q < kSgMergeVec; ++q) {
          pv[q] = s0 + q < n_splits ? __ldcg(p + (s0 + q) * split_stride) : 0.f;
          pxv[q] = kInt8 && s0 + q < n_splits ? __ldcg(px + (s0 + q) * b_rows) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kSgMergeVec; ++q)
          if (s0 + q < n_splits) {
            y[z] += pv[q];
            xs += pxv[q];
          }
      }
      if (kInt8) {  // bf16 of the sum of x over K, times c
        const __nv_bfloat16* c_row = (z == 0 ? a.m0 : a.m1).sc + (size_t)a.gp * a.n;
        y[z] += round_bf16(xs) * bf(z == mat ? s_c[0][cc] : c_row[col0 + cc]);
      }
      if (kPlain) y[z] *= z == 0 ? cs0 : cs1;
    }
    sg_tile_squares(a, b, sg_epilogue(a, b, col0 + cc, y[0], y[1], s_resid[b][cc], pos));
  }
  if (tid == 0) a.tickets[blockIdx.x] = 0;
}

// One product as a programmatic dependent of the kernel before it on s.
// plan: {split_steps, n_splits, warps}, checked by the caller (sg_plan_ok).
template <int VPW>
cudaError_t launch_stack_gemv(const SgArgs& a, const int* plan, int n_mats, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n / kSgCols, plan[1], n_mats);
  cfg.blockDim = dim3(kSgThreads);
  cfg.dynamicSmemBytes = sg_x_bytes(VPW, a.b_rows, plan[0]);
  if constexpr (VPW == 1) {  // and the warps' rings, past 48 KB with the largest x slices
    constexpr int kRing = kSgWarps * kSgPlainAhead * kSgPlainStep;
    static bool configured = false;
    if (!configured) {  // set once, before the first launch (and any capture)
      const cudaError_t err =
          cudaFuncSetAttribute(stack_gemv<VPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSgXBytes + kRing);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    cfg.dynamicSmemBytes += kRing;
  }
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = kSgCluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, stack_gemv<VPW>, a);
}

// Layer `layer` of a matrix stacked over layers: pw (L, K/VPW, N), sc (L, 2*gp, N).
template <int VPW>
SgMat layer_mat(const SgMat& m, int layer, int k, int n, int gp) {
  return SgMat{m.pw + (size_t)layer * (k / VPW) * n, m.sc + (size_t)layer * 2 * gp * n};
}

// Whether the kernel runs plan {split_steps, n_splits, warps} for x (b_rows,
// k) @ (k, n) words of vpw values (n_mats matrices side by side), with
// part_elems f32 of partials and n_tickets tickets.
bool sg_plan_ok(int vpw, int b_rows, int k, int n, int n_mats, const int* plan, long long part_elems,
                int n_tickets) {
  if (k % (vpw * kSgStepRows) != 0 || n % (kSgCols * kSgCluster) != 0 || n < kSgCols || b_rows < 1 ||
      b_rows > kSgRows)
    return false;
  const int steps = k / vpw / kSgStepRows;
  const int split_steps = plan[0], n_splits = plan[1], warps = plan[2];
  if (split_steps < 1 || warps != kSgWarps || n_splits < 1 || n_splits > 65535 ||
      n_splits != (steps + split_steps - 1) / split_steps || sg_x_bytes(vpw, b_rows, split_steps) > kSgXBytes ||
      (vpw == 8 && (split_steps % kSgGroupSteps != 0 || split_steps > kSgMaxCGroups * kSgGroupSteps)))
    return false;
  if (n_splits * n_mats > 1 &&
      (part_elems < (long long)n_mats * n_splits * b_rows * (n + 1) || n_tickets < n / kSgCols))
    return false;
  return true;
}

}  // namespace
