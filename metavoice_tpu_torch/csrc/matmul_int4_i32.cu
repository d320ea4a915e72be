// Weight-only matmuls for prefill, written for Hopper (sm_90a), in the
// int32-word serving formats: one kernel template, two C entries, K2 and K8.
//
// K2, int4 (mv_matmul_int4_i32): replaces
// metavoice_tpu/ops/quantized.py:matmul_int4_i32 (the Pallas TPU kernel
// _prefill_int4_kernel). y (M, N) f32 = x (M, K) bf16 @ W, where W is the
// packed serving format: pw (K/8, N) int32 holds eight biased nibbles a
// word in the "split-eighth" layout (bits [4j, 4j+4) of word (k', n) are row
// j*K/8 + k'), and sc (2*Gp, N) bf16 holds the group scales s and constants c.
// Per K-group g of 128 rows the product is
//     y += s_g * (x_g @ nib_g) + bf16(sum x_g) * c_g,
// with the raw nibbles 0..15 exact in bf16 and x_g @ nib_g summed in f32.
//
// K8, int8 (mv_matmul_int8_i32): replaces
// metavoice_tpu/ops/quantized.py:matmul_int8_i32 (the Pallas TPU kernel
// _prefill_int8_kernel). p8 (K/4, N) int32 holds four biased bytes a word,
// "split-quarter" (bits [8j, 8j+8) of word (k', n) are row j*K/4 + k'), and
// sc8 (2*Gp, N) bf16 holds s at row 0 and c = -128*s at row Gp (Gp = 8). One
// group spans K:
//     y = s * (x @ byte) + bf16(sum x) * c,
// with the raw bytes 0..255 exact in bf16. The c term takes back about
// 128 * s * sum(x), several times the net result, so sum(x) is rounded to
// bf16 at the same point as in the TPU kernel, once, over all of K; its f32
// sum runs in another order than the plain version's, so a row whose sum
// lies on a bf16 rounding boundary can round the other way (a shift of
// |c| * ulp(sum x) in that row).
//
// What bounds them: at the main-path shape (M = 256, the CFG pair times a
// 128-token prompt bucket; one layer's five projections, 2048 x 6144,
// 2048 x 2048, 2048 x 6144 twice, 6144 x 2048, FFN padded to 6144) a layer
// is 27.9 GFLOP against 27 MB (int4) or 54 MB (int8) of weights: the bf16
// tensor cores (989 TFLOP/s) and not the memory set the bound, 28 us. At
// 16-32 rows (the unfused int4 route and the int8 per-layer route, the CFG
// rows of batches 8 and 16) the weight bytes do: about 8 us (int4) and 16 us
// (int8) a layer at 3.35 TB/s.
//
// Design of K2 and K8 (prefill_kernel<kVals, kMt>), one launch a call:
//   * A block computes a tile of 16, 32, 64 or 128 rows (the plan's choice by
//     M) by 64 columns, over a split of K (below). Its warps are specialized:
//     one producer warpgroup (two at 128 rows) makes the copies and the
//     conversion; consumer warps only multiply. A ring of 4 slots hands the
//     work over, each slot an x chunk and its converted weights, with three
//     mbarriers a slot: the x chunk landed, the weights converted (the
//     producers' arrivals), the slot read (the consumer warps').
//   * Dequantization once: a block stages a word block (128 word rows, the 8
//     nibbles or 4 bytes of a word are 8 or 4 slabs of K) in shared memory
//     once, and walks its slabs in steps of 64 k. For each step the producers
//     turn value j of the chunk's words into bf16 once, exactly and off the
//     int-to-float unit (a nibble pair: one byte permute, one lop3 under the
//     bf16 128's exponent, one bf16x2 subtract of 128, as decode_stack_gemv.cuh;
//     a byte: word_values.cuh's f32 trick and one cvt to a bf16 pair), into
//     the slot's B tile, K-major with the 128-byte swizzle. At M 256 each
//     weight is read and converted twice a call (two row tiles).
//   * The copies: the x chunk (the tile's rows by 64 k of one slab) by one
//     bulk tensor copy (TMA) of a 3-D view of x (rows, slabs, word rows), so
//     rows past M and word rows past a short slab's end (K8, K/4 not a
//     multiple of 64) arrive as zeros, 128-byte swizzled; the words by
//     cp.async (16 bytes a thread) with the first slab's steps; K2's s and c
//     rows of the word block with its first step. Loads run 2 steps ahead
//     of the conversion, which runs up to 2 steps ahead of the products.
//   * The products: at 64 and 128 rows, wgmma m64n64k16 (bf16 -> f32), one
//     consumer warpgroup for each 64 rows, A the swizzled x chunk and B the
//     converted tile, both read by the tensor cores from shared memory. At 16
//     and 32 rows, where wgmma's 64 rows would mostly multiply zeros,
//     mma.sync m16n8k16 fed by ldmatrix from the same tiles, 4 consumer
//     warps of 16 columns each.
//   * The row sums of x for the c terms come from the tensor cores too: one
//     more product a k-step against a tile of ones (wgmma m64n8k16, or one
//     mma.sync by the warp that owns the m16 tile's sums), so no CUDA-core
//     pass reads the chunk.
//   * K2's group affine: a group is 128 k of one slab, two steps. Its
//     products go to their own accumulators; after its last step every
//     consumer adds s_g * dot to the running sum and clears the group's, in
//     registers, and the warps that took its row sums keep bf16(sum x_g) in
//     shared memory. At the word block's end (8 groups) one barrier of the
//     consumers, and each adds the 8 groups' bf16(sum x_g) * c_g.
//   * K is split across blocks on whole word blocks (ops/quantized.
//     prefill_plan picks the rows of a tile and the word blocks of a split
//     so that the grid fills the 132 SMs), so each word is read once a row
//     tile and K2's groups stay whole in a split. With more than one split
//     each block writes its f32 partial (K2: its groups' affine applied; K8:
//     its dots and its rows' f32 sums of x); the last block of a tile to
//     finish, behind a ticket (one acquire-release atomic, reset to 0 by that
//     block), adds them in split order, its own from its registers; K8's
//     epilogue, s * dot + bf16(sum x) * c with the f32 sums of all splits
//     rounded once, runs there, after the merge. The same bits every call and
//     every CUDA graph replay.
//   What holds it (clock64 marks in an experiment build, NVIDIA H100 80GB
//   HBM3, 700 W; PERF.md section 6): at M 256 a 128-row block spends
//   about a third of its time in the products; the rest is the hand-over
//   chain of each step (the producers' conversion, 550-800 cycles a step),
//   the group and word-block ends, and the merge after the loop, with one
//   block an SM and nothing to overlap them.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrappers and their plain PyTorch
// versions are in metavoice_tpu_torch/ops/quantized.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prefill_ring.cuh"
#include "word_values.cuh"

namespace {

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------------------------------------------------ K2 and K8

constexpr int kPfCols = 64;               // output columns a block
constexpr int kPfWordBlock = 128;         // word rows staged at once (K2: one group of each slab); splits hold whole ones
constexpr int kPfChunk = 64;              // word rows (k of one slab) a step takes: x rows of 128 bytes
constexpr int kPfChunks = kPfWordBlock / kPfChunk;
constexpr int kPfSlots = 4;               // ring slots: an x chunk and its converted weights each
constexpr int kPfAhead = 2;               // steps whose copies are in flight ahead of the conversion
constexpr int kPfWordBufs = 2;            // word blocks staged at once where a split holds more than one: the next
                                          // arrives while the last slab converts
constexpr int kPfWStride = kPfCols + 4;   // words a staged row (pad: conflict-free 16-byte reads)
constexpr int kPfXRowBytes = kPfChunk * 2;  // a staged x row: 128 bytes, 16-byte pieces swizzled by the row
constexpr int kPfBRowBytes = kPfChunk * 2;  // a converted weight column (K-major): 128 bytes, swizzled like x
constexpr int kPfProducerBar = 1;         // named barrier of the producer warpgroup
constexpr int kPfConsumerBar = 2;         // named barrier of the consumer warps
constexpr uint32_t kOnesPair = 0x3F803F80u;  // the bf16 pair (1, 1)
static_assert(kPfAhead < kPfSlots, "a slot is refilled only after the consumers are done with it");

// A tile of 16 kMt rows. The producer warpgroups (threads [0, kProducers))
// come first. 64 or 128 rows (kMt 4, 8): kMt / 4 consumer warpgroups on
// wgmma, each 64 rows by the 64 columns (a warp's 16 rows by 8 n8 tiles,
// wgmma's accumulator layout). 16 or 32 rows (kMt 1, 2), where wgmma's 64
// rows would multiply mostly zeros: 4 consumer warps on mma.sync, each 16
// columns over all the rows.
template <int kMt>
struct PfShape {
  static_assert(kMt == 1 || kMt == 2 || kMt == 4 || kMt == 8, "16, 32, 64 or 128 rows");
  static constexpr bool kWg = kMt >= 4;
  static constexpr int kProducers = kMt == 8 ? 256 : 128;
  static constexpr int kConsumerWarps = kWg ? kMt : 4;
  static constexpr int kConsumers = 32 * kConsumerWarps;
  static constexpr int kThreads = kProducers + kConsumers;
  static constexpr int kWmt = kWg ? 1 : kMt;      // m16 tiles a consumer warp
  static constexpr int kWnt = kWg ? kPfCols / 8 : 2;  // n8 tiles a consumer warp
  // blocks an SM (the registers held to it): up to 64 rows, two blocks' shared memory fits an SM
  static constexpr int kBlocksPerSm = kMt <= 4 ? 2 : 1;
  static constexpr int kBm = 16 * kMt;
  static constexpr size_t kWordBytes = sizeof(int32_t) * kPfWordBlock * kPfWStride;  // one word block
  static constexpr size_t kXSlot = (size_t)kBm * kPfXRowBytes;  // a multiple of 1024: the swizzle's alignment
  static constexpr size_t kXBytes = kPfSlots * kXSlot;
  static constexpr size_t kBSlot = (size_t)kPfCols * kPfBRowBytes;  // 8 KB, 1024-aligned
  static constexpr size_t kBBytes = kPfSlots * kBSlot + 1024;          // and a 1 KB tile of ones (the row sums)
  static constexpr size_t kSumBytes = sizeof(float) * 2 * 8 * kBm;  // K2: [word block parity][slab][row]
  static constexpr size_t kScBytes = sizeof(__nv_bfloat16) * 2 * 16 * kPfCols;  // K2: [parity][s 8, c 8][column]
  static constexpr size_t kBarBytes = sizeof(uint64_t) * 3 * kPfSlots;
  // x chunks, weights, sums and barriers, then 1 or kPfWordBufs word blocks, and 1 KB to align the start
  static size_t smem(int word_bufs) {
    return 1024 + kXBytes + kBBytes + kSumBytes + kScBytes + kBarBytes + word_bufs * kWordBytes;
  }
};

struct PfArgs {
  const __nv_bfloat16* x;   // (m, k)
  const int32_t* w;         // (k / vals, n) words
  const __nv_bfloat16* sc;  // (2 gp, n): s rows, then c rows
  float* y;                 // (m, n)
  float* part;              // splits > 1: (splits, m, n) f32 partials
  float* xpart;             // K8, splits > 1: (splits, column tiles, m) f32 sums of x
  int* tickets;             // splits > 1: one a tile, 0 between calls
  int m, k, n, gp, split_wb;
};

__device__ __forceinline__ float pf_round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Element h (0 or 1) of a bf16 pair as f32.
__device__ __forceinline__ float pf_half(uint32_t pair, int h) {
  return __uint_as_float(h ? pair & 0xFFFF0000u : pair << 16);
}

// Nibble j of two words w0, w1 (neighbouring columns of one word row) as the
// exact bf16 pair (w0's in the low half): the byte holding it from each word
// by one byte permute, the nibble under the exponent of the bf16 128 by one
// lop3 (128 + n, exact), and one bf16x2 subtract of 128.
__device__ __forceinline__ uint32_t pf_nibble_pair(uint32_t w0, uint32_t w1, int j) {
  const int byte = j >> 1;
  const uint32_t v = __byte_perm(w0, w1, byte | ((4 + byte) << 8)) >> (4 * (j & 1));  // at bits 0 and 16
  uint32_t t;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(t) : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));  // (v & m) | c
  const uint32_t k128 = 0x43004300u;
  __nv_bfloat162 p = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                             *reinterpret_cast<const __nv_bfloat162*>(&k128));
  return *reinterpret_cast<uint32_t*>(&p);
}

// Byte j of two words as the exact bf16 pair (w0's in the low half).
__device__ __forceinline__ uint32_t pf_byte_pair(uint32_t w0, uint32_t w1, int j) {
  return pack_bf16x2(word_val<4>((int32_t)w0, j), word_val<4>((int32_t)w1, j));
}

// K8's epilogue: s * dot + bf16(sum x) * c, xs already rounded.
__device__ __forceinline__ float k8_out(float dot, float s, float xs, float c) { return dot * s + xs * c; }

// The steps of a split, in order: word block mb, slab j, chunk c.
struct PfStep {
  int mb, j, c;
};

// y = x @ W for the words' kVals values a word: 8 (K2, a group every 128
// rows of a slab) or 4 (K8, one group over all of K). Grid (column tiles of
// kPfCols, row tiles of 16 kMt, splits of split_wb word blocks).
template <int kVals, int kMt>
__global__ void __launch_bounds__(PfShape<kMt>::kThreads, PfShape<kMt>::kBlocksPerSm)
    prefill_kernel(const PfArgs a, const __grid_constant__ CUtensorMap xmap) {
  using S = PfShape<kMt>;
  constexpr bool kInt8 = kVals == 4;
  constexpr int kBm = S::kBm, kThreads = S::kThreads, kWmt = S::kWmt, kWnt = S::kWnt, kProd = S::kProducers;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (pf_smem(smem_raw) & 1023)) & 1023);  // the x slots' swizzle alignment
  unsigned char* x_s = smem;                                                     // [slots][kBm][128 bytes], swizzled
  unsigned char* b_s = smem + S::kXBytes;                     // [slots][64 columns][128 bytes], swizzled (K-major)
  unsigned char* ones_s = b_s + kPfSlots * S::kBSlot;           // [8][128 bytes] of bf16 ones
  float* xsum_s = reinterpret_cast<float*>(smem + S::kXBytes + S::kBBytes);     // K2 [2][8][kBm]; K8 [kBm]
  __nv_bfloat16* sc_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kXBytes + S::kBBytes + S::kSumBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kXBytes + S::kBBytes + S::kSumBytes + S::kScBytes);
  uint64_t* empty = full + kPfSlots;
  uint64_t* xfull = empty + kPfSlots;
  int32_t* w_s = reinterpret_cast<int32_t*>(smem + S::kXBytes + S::kBBytes + S::kSumBytes + S::kScBytes +
                                            S::kBarBytes);
  // [word_bufs][kPfWordBlock][kPfWStride]: a split of one word block (the plan's usual cut) stages one
  __shared__ int last_s;

  const int m = a.m, n = a.n;
  const int kw = a.k / kVals;  // word rows
  const int n_wb = (kw + kPfWordBlock - 1) / kPfWordBlock;
  const int wb0 = blockIdx.z * a.split_wb;
  const int wb1 = min(n_wb, wb0 + a.split_wb);
  const int row0 = blockIdx.y * kBm;
  const int col0 = blockIdx.x * kPfCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  // chunks a slab of word block mb holds (K8: the last block may be short)
  auto chunks = [&](int mb) { return min(kPfChunks, (kw - mb * kPfWordBlock + kPfChunk - 1) / kPfChunk); };
  auto advance = [&](PfStep& q) {
    if (++q.c == chunks(q.mb)) {
      q.c = 0;
      if (++q.j == kVals) {
        q.j = 0;
        ++q.mb;
      }
    }
  };
  int n_steps = 0;
  for (int mb = wb0; mb < wb1; ++mb) n_steps += kVals * chunks(mb);

  if (tid == 0) {
    for (int i = 0; i < kPfSlots; ++i) {
      pf_bar_init(&full[i], kProd);
      pf_bar_init(&empty[i], S::kConsumerWarps);
      pf_bar_init(&xfull[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 1024 / 4; i += kThreads) reinterpret_cast<uint32_t*>(ones_s)[i] = kOnesPair;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the ones, for wgmma's reads
  __syncthreads();

  // the consumers' accumulators (declared for all: the epilogue reads them)
  float acc[kWmt][kWnt][4];  // K2: the split's sum of scaled groups
  float dot[kWmt][kWnt][4];  // K2: this group's products; K8: the split's
  float xacc[4];             // the row sums of m16 tile st (below) by the ones column (K2 the group's)
#pragma unroll
  for (int i = 0; i < kWmt; ++i)
#pragma unroll
    for (int jn = 0; jn < kWnt; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = dot[i][jn][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) xacc[e] = 0.f;
  const bool consumer = tid >= kProd;
  const int cw = (tid - kProd) >> 5;  // consumer warp (the producers' is negative)
  const int wrow = S::kWg ? cw * 16 : 0;  // a consumer warp's first row in the tile (wgmma: warp w of a
  const int wcol = S::kWg ? 0 : cw * 16;  // warpgroup has rows 16 w) and its first column
  // the m16 tile whose row sums the warp takes: a wgmma warp its own rows; mma.sync's warp w tile w
  const int st = S::kWg ? 0 : cw;
  const bool sums = consumer && st < kWmt;

  if (!consumer) {
    // ---------------- producer: the copies, kPfAhead steps ahead, and the conversion
    const int pt = tid;
    // step q's copies into slot q % kPfSlots: the x chunk of slab j by one bulk tensor copy (rows past M
    // and word rows past the slab's end read as zeros), and in slab 0 the chunk's word rows by cp.async
    auto issue = [&](const PfStep& q, int slot) {
      const int r0 = q.mb * kPfWordBlock + q.c * kPfChunk;  // the chunk's first word row
      if (pt == 0) {
        pf_bar_expect(&xfull[slot], (unsigned)S::kXSlot);
        pf_tma_3d(x_s + slot * S::kXSlot, &xmap, r0, q.j, row0, &xfull[slot]);
      }
      if (q.j == 0) {
        int32_t* wd = w_s + ((q.mb - wb0) % kPfWordBufs) * kPfWordBlock * kPfWStride + q.c * kPfChunk * kPfWStride;
#pragma unroll
        for (int it = 0; it < kPfChunk * (kPfCols / 4) / kProd; ++it) {
          const int i = pt + it * kProd;
          const int r = i / (kPfCols / 4);
          const int p = (i % (kPfCols / 4)) * 4;
          const bool ok = r0 + r < kw && col0 + p < n;  // n % 8 == 0: 4 words all in or all out
          pf_cp_async16(wd + r * kPfWStride + p, ok ? a.w + (size_t)(r0 + r) * n + col0 + p : a.w, ok);
        }
        if (!kInt8 && q.c == 0 && pt < 16 * (kPfCols / 8)) {  // K2: the word block's 8 groups' s and c rows
          const int r = pt / (kPfCols / 8);  // 16 rows of 8 pieces, one a producer
          const int p = (pt % (kPfCols / 8)) * 8;
          const int row = (r & 7) * n_wb + q.mb + (r >= 8 ? a.gp : 0);
          const bool ok = col0 + p < n;  // n % 8 == 0: 8 values all in or all out
          pf_cp_async16(sc_s + (((q.mb - wb0) & 1) * 16 + r) * kPfCols + p,
                        ok ? a.sc + (size_t)row * n + col0 + p : a.sc, ok);
        }
      }
    };
    PfStep ld{wb0, 0, 0}, cv{wb0, 0, 0};
    for (int q = 0; q < kPfAhead; ++q) {
      if (q < n_steps) issue(ld, q % kPfSlots);
      advance(ld);
      pf_commit();
    }
#pragma unroll 1
    for (int p = 0; p < n_steps; ++p) {
      const int q = p + kPfAhead;
      if (q < n_steps) {
        if (q >= kPfSlots) pf_bar_wait(&empty[q % kPfSlots], (q / kPfSlots - 1) & 1);  // step q - slots is done
        issue(ld, q % kPfSlots);
      }
      advance(ld);
      pf_commit();
      pf_wait<kPfAhead>();  // this thread's copies of step p have landed
      pf_named_sync(kPfProducerBar, kProd);  // and every producer's
      // step p's weights, value j of its staged words, as bf16 into its slot, K-major: a thread takes word
      // rows k0, k0 + 1 (lanes along k: the stores are conflict-free) of 4 columns, and each column's two
      // values are one bf16 pair at (column, k0); each weight once a block
      const int32_t* ws = w_s + ((cv.mb - wb0) % kPfWordBufs) * kPfWordBlock * kPfWStride + cv.c * kPfChunk * kPfWStride;
      unsigned char* bd = b_s + (p % kPfSlots) * S::kBSlot;
      constexpr int kIters = kPfChunk / 2 * (kPfCols / 4) / kProd;
      uint4 w0[kIters], w1[kIters];
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int i = pt + it * kProd;
        const int k0 = 2 * (i % (kPfChunk / 2));
        const int c4 = (i / (kPfChunk / 2)) * 4;
        w0[it] = *reinterpret_cast<const uint4*>(ws + k0 * kPfWStride + c4);
        w1[it] = *reinterpret_cast<const uint4*>(ws + (k0 + 1) * kPfWStride + c4);
      }
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int i = pt + it * kProd;
        const int k0 = 2 * (i % (kPfChunk / 2));
        const int c4 = (i / (kPfChunk / 2)) * 4;
        const uint32_t a0[4] = {w0[it].x, w0[it].y, w0[it].z, w0[it].w};
        const uint32_t a1[4] = {w1[it].x, w1[it].y, w1[it].z, w1[it].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = c4 + q;
          const uint32_t v = kInt8 ? pf_byte_pair(a0[q], a1[q], cv.j) : pf_nibble_pair(a0[q], a1[q], cv.j);
          *reinterpret_cast<uint32_t*>(bd + col * kPfBRowBytes + ((((k0 >> 3) ^ (col & 7))) << 4) + (k0 & 7) * 2) = v;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores, for wgmma's reads
      advance(cv);
      pf_bar_arrive(&full[p % kPfSlots]);  // its x chunk (this thread's copies) and weights are ready
    }
  } else {
    // ---------------- consumers: the products
    PfStep cu{wb0, 0, 0};
    const int wg = (tid - kProd) >> 7;  // wgmma: the consumer warpgroup, rows [64 wg, 64 wg + 64)
    const uint64_t ones_desc = pf_desc(ones_s);
    const uint32_t ones[2] = {kOnesPair, kOnesPair};
#pragma unroll 1
    for (int t = 0; t < n_steps; ++t) {
      const int slot = t % kPfSlots;
      pf_bar_wait(&xfull[slot], (t / kPfSlots) & 1);
      pf_bar_wait(&full[slot], (t / kPfSlots) & 1);
      const unsigned char* bs = b_s + slot * S::kBSlot;
      if constexpr (S::kWg) {
        const unsigned char* xs = x_s + slot * S::kXSlot + wg * 64 * kPfXRowBytes;
        pf_wg_fence();
#pragma unroll
        for (int kk = 0; kk < kPfChunk; kk += 16) {  // a k16 step is 32 bytes further into the swizzled rows
          const uint64_t da = pf_desc(xs + kk * 2);
          pf_wgmma_n64(reinterpret_cast<float(&)[32]>(dot[0]), da, pf_desc(bs + kk * 2));
          pf_wgmma_n8(xacc, da, ones_desc);
        }
        pf_wg_commit();
        pf_wg_wait0();
      } else {
        const unsigned char* xs = x_s + slot * S::kXSlot;
#pragma unroll
        for (int kk = 0; kk < kPfChunk; kk += 16) {
          // row r's (column n's) 16-byte piece p of the swizzled tiles sits at piece p ^ (r mod 8)
          uint32_t af[kWmt][4];
#pragma unroll
          for (int i = 0; i < kWmt; ++i) {
            const int r = i * 16 + (lane & 15);
            pf_ldmatrix_x4(af[i], xs + r * kPfXRowBytes + ((((kk >> 3) + (lane >> 4)) ^ (r & 7)) << 4));
          }
          uint32_t bq[4];  // (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) of the warp's 16 columns
          const int nn = wcol + (lane & 7) + ((lane >> 4) << 3);
          pf_ldmatrix_x4(bq, bs + nn * kPfBRowBytes + ((((kk >> 3) + ((lane >> 3) & 1)) ^ (nn & 7)) << 4));
          const uint32_t bf[2][2] = {{bq[0], bq[1]}, {bq[2], bq[3]}};
#pragma unroll
          for (int i = 0; i < kWmt; ++i)
#pragma unroll
            for (int jn = 0; jn < kWnt; ++jn) mma_bf16(dot[i][jn], af[i], bf[jn]);
          if (sums) {
#pragma unroll
            for (int i = 0; i < kWmt; ++i)
              if (i == st) mma_bf16(xacc, af[i], ones);
          }
        }
      }
      __syncwarp();
      if (lane == 0) pf_bar_arrive(&empty[slot]);  // the warp is done with the slot
      if constexpr (!kInt8) {
        if (cu.c == kPfChunks - 1) {  // the group's last chunk: s * dot into the running sum, and its
          float* xsj = xsum_s + (((cu.mb - wb0) & 1) * 8 + cu.j) * kBm;  // row sums, rounded to bf16 as the
          if (sums && tig == 0) {  // TPU kernel feeds them to the c term, kept for the word block's end
            xsj[wrow + st * 16 + gid] = pf_round_bf16(xacc[0]);
            xsj[wrow + st * 16 + gid + 8] = pf_round_bf16(xacc[2]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) xacc[e] = 0.f;
          // the word block's s and c rows, staged with its first words (each a bf16 pair at the lane's columns)
          const __nv_bfloat16* scb = sc_s + ((cu.mb - wb0) & 1) * 16 * kPfCols + wcol + 2 * tig;
#pragma unroll
          for (int jn = 0; jn < kWnt; ++jn) {
            const uint32_t sp = *reinterpret_cast<const uint32_t*>(scb + cu.j * kPfCols + jn * 8);
            const float s0 = pf_half(sp, 0), s1 = pf_half(sp, 1);
#pragma unroll
            for (int i = 0; i < kWmt; ++i) {
              float* d = dot[i][jn];
              acc[i][jn][0] += d[0] * s0;
              acc[i][jn][1] += d[1] * s1;
              acc[i][jn][2] += d[2] * s0;
              acc[i][jn][3] += d[3] * s1;
              d[0] = d[1] = d[2] = d[3] = 0.f;
            }
          }
          if (cu.j == kVals - 1) {  // the word block's end: its 8 groups' c terms, bf16(sum x_g) * c_g
            pf_named_sync(kPfConsumerBar, S::kConsumers);  // (two buffers: a warp runs at most one block ahead)
            const float* xsb = xsum_s + ((cu.mb - wb0) & 1) * 8 * kBm;
#pragma unroll 1
            for (int j = 0; j < kVals; ++j) {
              uint32_t cp[kWnt];
#pragma unroll
              for (int jn = 0; jn < kWnt; ++jn)
                cp[jn] = *reinterpret_cast<const uint32_t*>(scb + (8 + j) * kPfCols + jn * 8);
#pragma unroll
              for (int i = 0; i < kWmt; ++i) {
                const float xs0 = xsb[j * kBm + wrow + i * 16 + gid];
                const float xs1 = xsb[j * kBm + wrow + i * 16 + gid + 8];
#pragma unroll
                for (int jn = 0; jn < kWnt; ++jn) {
                  const float c0 = pf_half(cp[jn], 0), c1 = pf_half(cp[jn], 1);
                  acc[i][jn][0] += xs0 * c0;
                  acc[i][jn][1] += xs0 * c1;
                  acc[i][jn][2] += xs1 * c0;
                  acc[i][jn][3] += xs1 * c1;
                }
              }
            }
          }
        }
      }
      advance(cu);
    }
  }
  __syncthreads();  // producers and consumers both done; xsum_s free

  if constexpr (kInt8) {  // each row's f32 sum of x over the split
    if (sums && tig == 0) {
      xsum_s[wrow + st * 16 + gid] = xacc[0];
      xsum_s[wrow + st * 16 + gid + 8] = xacc[2];
    }
    __syncthreads();
  }
  const bool one = gridDim.z == 1;
  // the consumer thread's outputs: column pair jn (col0 + wcol + 8 jn + 2 tig, + 1) of row gid + 8 h of its
  // m16 tile i
  auto out_r = [&](int i, int h) { return wrow + i * 16 + gid + 8 * h; };  // in the tile
  auto out_col = [&](int jn) { return col0 + wcol + jn * 8 + 2 * tig; };  // n % 8 == 0: col < n takes col + 1
  auto own = [&](int i, int jn, int h) {  // the split's value: K2 its sum of scaled groups, K8 its dots
    return kInt8 ? make_float2(dot[i][jn][2 * h], dot[i][jn][2 * h + 1])
                 : make_float2(acc[i][jn][2 * h], acc[i][jn][2 * h + 1]);
  };
  // y at (tile row r, column pair jn): K2 v; K8 s * v + bf16(sum x) * c, xs rounded
  auto store = [&](int r, int jn, float2 v, float xs) {
    const int col = out_col(jn);
    if constexpr (kInt8) {
      const float s0 = __bfloat162float(a.sc[col]), s1 = __bfloat162float(a.sc[col + 1]);
      const float c0 = __bfloat162float(a.sc[(size_t)a.gp * n + col]);
      const float c1 = __bfloat162float(a.sc[(size_t)a.gp * n + col + 1]);
      v = make_float2(k8_out(v.x, s0, xs, c0), k8_out(v.y, s1, xs, c1));
    }
    *reinterpret_cast<float2*>(a.y + (size_t)(row0 + r) * n + col) = v;
  };
  if (one) {
    if (consumer) {
#pragma unroll
      for (int i = 0; i < kWmt; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = out_r(i, h);
          if (row0 + r >= m) continue;
          const float xs = kInt8 ? pf_round_bf16(xsum_s[r]) : 0.f;
#pragma unroll
          for (int jn = 0; jn < kWnt; ++jn)
            if (out_col(jn) < n) store(r, jn, own(i, jn, h), xs);
        }
    }
    return;
  }

  // more than one split: the partials, then the last block of the tile adds them in split order
  const int split = blockIdx.z;
  if (consumer) {
#pragma unroll
    for (int i = 0; i < kWmt; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = out_r(i, h);
        if (row0 + r >= m) continue;
#pragma unroll
        for (int jn = 0; jn < kWnt; ++jn)
          if (out_col(jn) < n)
            *reinterpret_cast<float2*>(a.part + ((size_t)split * m + row0 + r) * n + out_col(jn)) = own(i, jn, h);
        if (kInt8 && tig == 0 && wcol == 0)
          a.xpart[((size_t)split * gridDim.x + blockIdx.x) * m + row0 + r] = xsum_s[r];
      }
  }
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __syncthreads();  // the block's writes happen before thread 0's release
  if (tid == 0) last_s = pf_atom_add_acq_rel(&a.tickets[tile], 1) == (int)gridDim.z - 1;
  __syncthreads();  // and thread 0's acquire before the last block's reads
  if (!last_s) return;
  if (consumer) {
    float2 sum[kWmt][kWnt][2];
    float xs[kWmt][2];
#pragma unroll
    for (int i = 0; i < kWmt; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xs[i][h] = 0.f;
#pragma unroll
        for (int jn = 0; jn < kWnt; ++jn) sum[i][jn][h] = make_float2(0.f, 0.f);
      }
    for (int sp = 0; sp < (int)gridDim.z; ++sp) {  // split order; a split's loads all go out at once
      float2 v[kWmt][kWnt][2];
      float xv[kWmt][2];
#pragma unroll
      for (int i = 0; i < kWmt; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = out_r(i, h);
          const bool row_ok = row0 + r < m;
#pragma unroll
          for (int jn = 0; jn < kWnt; ++jn) {
            v[i][jn][h] = make_float2(0.f, 0.f);
            if (sp == split) {
              v[i][jn][h] = own(i, jn, h);
            } else if (row_ok && out_col(jn) < n) {
              v[i][jn][h] = __ldcg(reinterpret_cast<const float2*>(a.part + ((size_t)sp * m + row0 + r) * n +
                                                                     out_col(jn)));
            }
          }
          xv[i][h] = 0.f;
          if (kInt8 && row_ok)
            xv[i][h] = sp == split ? xsum_s[r] : __ldcg(a.xpart + ((size_t)sp * gridDim.x + blockIdx.x) * m + row0 + r);
        }
#pragma unroll
      for (int i = 0; i < kWmt; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          xs[i][h] += xv[i][h];
#pragma unroll
          for (int jn = 0; jn < kWnt; ++jn) {
            sum[i][jn][h].x += v[i][jn][h].x;
            sum[i][jn][h].y += v[i][jn][h].y;
          }
        }
    }
#pragma unroll
    for (int i = 0; i < kWmt; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = out_r(i, h);
        if (row0 + r >= m) continue;
#pragma unroll
        for (int jn = 0; jn < kWnt; ++jn)  // K8: the rows' sums over all of K, rounded once
          if (out_col(jn) < n) store(r, jn, sum[i][jn][h], pf_round_bf16(xs[i][h]));
      }
  }
  if (tid == 0) a.tickets[tile] = 0;
}

template <int kVals, int kMt>
cudaError_t pf_launch(const PfArgs& a, const CUtensorMap& xmap, int splits, cudaStream_t s) {
  using S = PfShape<kMt>;
  const size_t smem = S::smem(a.split_wb > 1 ? kPfWordBufs : 1);
  // above 48 KB of shared memory a kernel must opt in, on each device it runs on
  const cudaError_t err = cudaFuncSetAttribute(prefill_kernel<kVals, kMt>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::smem(kPfWordBufs));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kPfCols - 1) / kPfCols, (a.m + S::kBm - 1) / S::kBm, splits);
  prefill_kernel<kVals, kMt><<<grid, S::kThreads, smem, s>>>(a, xmap);
  return cudaGetLastError();
}

// Checks the plan's arguments and launches the instance of its tile.
template <int kVals>
int pf_run(const PfArgs& a, int mt, int n_tickets, void* stream) {
  const int n_wb = (a.k / kVals + kPfWordBlock - 1) / kPfWordBlock;
  if (a.split_wb < 1 || (mt != 1 && mt != 2 && mt != 4 && mt != 8)) return (int)cudaErrorInvalidValue;
  const int splits = (n_wb + a.split_wb - 1) / a.split_wb;
  const long long tiles = (long long)((a.n + kPfCols - 1) / kPfCols) * ((a.m + 16 * mt - 1) / (16 * mt));
  if (splits > 65535 || (a.m + 16 * mt - 1) / (16 * mt) > 65535 ||
      (splits > 1 && (a.part == nullptr || a.tickets == nullptr || tiles > n_tickets ||
                      (kVals == 4 && a.xpart == nullptr))))
    return (int)cudaErrorInvalidValue;
  // x as (rows, slabs, word rows) bf16: a box is one chunk of one slab for the tile's rows
  const int kw = a.k / kVals;
  const cuuint64_t dims[3] = {(cuuint64_t)kw, (cuuint64_t)kVals, (cuuint64_t)a.m};
  const cuuint64_t strides[2] = {(cuuint64_t)kw * 2, (cuuint64_t)a.k * 2};  // bytes: a slab, a row
  const cuuint32_t box[3] = {(cuuint32_t)kPfChunk, 1, (cuuint32_t)(16 * mt)};
  CUtensorMap xmap;
  const cudaError_t map_err = pf_tensor_map_3d(&xmap, a.x, dims, strides, box);
  if (map_err != cudaSuccess) return (int)map_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return (int)pf_launch<kVals, 1>(a, xmap, splits, s);
    case 2: return (int)pf_launch<kVals, 2>(a, xmap, splits, s);
    case 4: return (int)pf_launch<kVals, 4>(a, xmap, splits, s);
    default: return (int)pf_launch<kVals, 8>(a, xmap, splits, s);
  }
}

}  // namespace

// x: (m, k) bf16, pw: (k/8, n) int32, sc: (2*gp, n) bf16, y: (m, n) f32, all
// contiguous on the device. k must be a multiple of 1024 (8 slabs of whole
// 128-row groups) and n a multiple of 8. The plan (ops/quantized.prefill_plan):
// mt m16 tiles a block's rows (1, 2, 4 or 8), split_wb word blocks of 128 rows
// a split; with more than one split, part (splits, m, n) f32 and tickets,
// n_tickets >= the tiles, int32 all 0 (left 0). Returns a cudaError_t.
extern "C" int mv_matmul_int4_i32(const void* x, const void* pw, const void* sc, void* y, int m, int k, int n,
                                  int gp, int mt, int split_wb, void* part, void* tickets, int n_tickets,
                                  void* stream) {
  if (m < 1 || k < 8 * kPfWordBlock || k % (8 * kPfWordBlock) != 0 || n < 8 || n % 8 != 0 || gp < k / 128)
    return (int)cudaErrorInvalidValue;
  const PfArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(pw),
                 static_cast<const __nv_bfloat16*>(sc), static_cast<float*>(y), static_cast<float*>(part), nullptr,
                 static_cast<int*>(tickets), m, k, n, gp, split_wb};
  return pf_run<8>(a, mt, n_tickets, stream);
}

// x: (m, k) bf16, p8: (k/4, n) int32, sc8: (2*gp, n) bf16 with s at row 0 and
// c at row gp, y: (m, n) f32, all contiguous on the device. k must be a
// multiple of 32 and n a multiple of 8. The plan as for mv_matmul_int4_i32;
// with more than one split also xpart, (splits, ceil(n / 64), m) f32.
// Returns a cudaError_t.
extern "C" int mv_matmul_int8_i32(const void* x, const void* p8, const void* sc8, void* y, int m, int k, int n,
                                  int gp, int mt, int split_wb, void* part, void* xpart, void* tickets,
                                  int n_tickets, void* stream) {
  if (m < 1 || k < 32 || k % 32 != 0 || n < 8 || n % 8 != 0 || gp < 1) return (int)cudaErrorInvalidValue;
  const PfArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(p8),
                 static_cast<const __nv_bfloat16*>(sc8), static_cast<float*>(y), static_cast<float*>(part),
                 static_cast<float*>(xpart), static_cast<int*>(tickets), m, k, n, gp, split_wb};
  return pf_run<4>(a, mt, n_tickets, stream);
}
