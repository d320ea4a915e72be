// Groupwise int4 weight-only matmuls, K12 and K13 (mv_matmul_int4_grouped),
// written for Hopper (sm_90a).
//
// Replaces metavoice_tpu/ops/quantized.py:matmul_int4 (the Pallas TPU kernel
// _int4_matmul_kernel, K12) and matmul_int4_packed
// (_int4_packed_matmul_kernel, K13): the projections of a first stage whose
// layer weights are the JAX package's groupwise int4 leaves
// (quantize_params_int4 and _packed, the reference's own format,
// fam/llm/fast_quantize.py:70-148). For x (M, K) bf16, q (K, N) int8 in
// [-8, 7] (K12; the ring takes any int8, as the TPU kernel does, the GEMV
// assumes the range) or p (K/2, N) uint8 split-half nibble pairs (K13: the low
// nibble of byte (k, n) is q[k] + 8, the high nibble q[k + K/2] + 8), and
// scales s, zeros z (K/g, N) f32 (g the groupsize):
//     w = bf16((q + 0.5) * s[k / g] + z[k / g]),  y = x @ w summed in f32,
// in x's dtype (bf16 or f32). The dequantization is an f32 multiply and an
// f32 add, each rounded on its own (__fmul_rn / __fadd_rn, so that nvcc's
// FMA contraction cannot move a weight's bf16 rounding away from the plain
// version's), then one rounding to bf16, as the TPU kernels do; K13's
// nib - 7.5 is q + 0.5 exactly. The affine is not factored into an
// epilogue (s * (x @ q) + z * sum x): that form never rounds a weight.
//
// What bounds them: at M = 2 (a decode step of the CFG pair), the weight
// bytes. One layer's five projections (2048 x 6144, 2048 x 2048, 2048 x
// 5632 twice, 5632 x 2048) read 51.4 M weights plus 8 bytes of scale and
// zero per group: 54.6 MB for K12, 28.9 MB for K13, about 16 us and 9 us at
// 3.35 TB/s; so do the 16 and 32 rows of the speculative verify and the CFG
// rows of batches 8 and 16. At M = 256 (prefill: the CFG pair x a 128-token
// bucket) the same layer is 26.3 GFLOP: about 27 us on the bf16 tensor
// cores, and each weight's dequantization (about 5 CUDA-core instructions)
// has to stay under the products.
//
// Design:
//   * More than 8 rows, or a groupsize that is no multiple of 16: one launch
//     a call of the ring of tensor-core tiles (int4g_ring_kernel,
//     matmul_ring.cuh, shared with K11; its design is there): TMA copies
//     of x, of w and of each step's group rows of scales and zeros, each
//     weight converted once a block by a producer warpgroup into a
//     K-major bf16 ring slot, exactly and off the int-to-float unit
//     (bf16((q + 0.5) s + z) by __fmul_rn, __fadd_rn and one cvt, as the
//     TPU kernels round), wgmma from 64 rows, K split by
//     ops/quantized.int4g_tile_plan. K13's staged block of packed rows
//     feeds two consumer steps, its low nibbles (rows k) and its high ones
//     (rows k + K/2).
//   What holds it (timer marks in an experiment build, NVIDIA H100 80GB
//   HBM3, 700 W; PERF.md section 6): the producers' conversion, about
//   1600 cycles a step of 8192 weights for one warpgroup, against 1240
//   cycles of wgmma at 256 rows and 680 at 128; then each split's partial
//   write and the merge. So the plan takes 128-row tiles at M 256 (each
//   weight converted twice, by twice the blocks) and the fewest splits
//   that fill the card.
//   * M <= 8 (groupsize a multiple of 16; any other takes the ring): one
//     launch a call, the products on the tensor cores (int4g_mma_gemv).
//     mma.sync m16n8k16 with the WEIGHTS as A (16 output columns x 16 k)
//     and x as B (16 k x 8 rows, rows >= M zero in the fragment, never
//     read). A lane loads 8 bytes of neighbouring columns at one row, so
//     the 8 lane groups of a warp cover 64 contiguous bytes of a row and
//     the 4 lanes of a quad take different rows: the k order inside an mma
//     and which columns are its 16 rows are free, as long as A and B agree.
//     K12: a lane takes 4 rows of a 16-row k-step, (rows 0, 1) and (2, 3)
//     of a column fill its two A registers. K13: a lane takes 2 packed rows
//     of an 8-row k-step, and the low and high nibble of one byte (k = r
//     and r + K/2) share an A register, so one 8-byte load feeds 16
//     weights; B takes x[r] and x[r + K/2]. A lane loads the weights of
//     several k-steps before it dequantizes any of them. Dequantization
//     stays off the slow conversion unit: two doubled nibbles a byte (K12:
//     (q & 15) ^ 8 = q + 8 for q in [-8, 7]) with one shift and one mask a
//     word, a byte permute under 2^22's exponent (mantissa step 0.5) and
//     one f32 subtract of 2^22 + 7.5 give q + 0.5 exactly; then
//     __fmul_rn(v, s), __fadd_rn(., z) and one cvt to a bf16 pair, so every
//     weight is bf16((q + 0.5) s + z) bit for bit. K12's group scales and
//     zeros stay in registers, K13's two groups' in shared memory. K is
//     split across blocks (ops/quantized.int4g_plan picks the splits and
//     the warps a block; the caller routes a call here by passing its
//     split_steps) and across a block's warps; the warps sum in shared
//     memory, and the last block of a column tile to finish sums the
//     splits' partials from L2 in a fixed order behind a ticket (one
//     acquire-release atomic, reset to 0 by that block), so the result is
//     the same bits on every call and a CUDA-graph replay finds the tickets
//     as the first launch did.
//     What holds it (globaltimer marks in an experiment build, H100): the
//     weight stream runs at about 1.7-2 TB/s from the launch's burst of
//     loads, and after it the partials' write, the ticket and the merge
//     take 2-3 us a call; the dequantization and the products take about a
//     fifth (K12) to a quarter (K13) of the time (PERF.md section 6, PR 10).

// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrappers and their plain PyTorch
// versions are ops/quantized.py:matmul_int4 and matmul_int4_packed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul_ring.cuh"

namespace {

// ---- M <= 8: the GEMV on the tensor cores, one launch a call -----------------

constexpr int kLaneCols = 8;        // neighbouring columns a lane: one 8-byte load a row
constexpr int kGemvCols = 8 * kLaneCols;  // output columns a warp (and a block): 8 lane groups
constexpr int kGemvMaxWarps = 8;    // warps a block (the plan's choice)
constexpr int kGemvRows = 8;        // rows of x: the mma's N
constexpr int kMergeSplits = 16;    // splits' partials a merged output loads at once
constexpr int kMergeOut = 2;        // outputs a thread of the merging block takes at once

// k-steps (16 k each) whose weights a lane loads before it dequantizes any
// of them: K12 4 rows a step, K13 2 packed rows, each row 8 bytes (on
// the H100 more steps, or a second batch in flight, were slower: PERF.md)
constexpr int kAheadQ = 2;
constexpr int kAheadP = 4;

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void store_y(void* y, int out_bf16, size_t i, float v) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(y)[i] = v;
  }
}

// y (m, n) = x (m, k) @ the groupwise int4 weights, m <= 8. A lane owns
// kLaneCols neighbouring columns (one load of kLaneCols bytes a row), a
// warp kGemvCols. Grid (column tiles of kGemvCols, splits of K); split i
// holds k-steps [i * split_steps, + split_steps) of the K / 16, dealt to the
// block's warps in contiguous runs. A warp loads the weights and x of kAhead steps into
// registers before it dequantizes any of them. K12 holds its group's scales
// and zeros in registers; K13, which needs two groups', in shared memory (a
// quad's columns read by its four lanes). With one split a block writes y;
// with more it writes its partial to part (splits, m, n) and the last block
// of its column tile sums them.
template <bool kPacked, int kAhead>
__global__ void __launch_bounds__(kGemvMaxWarps * 32)
int4g_mma_gemv(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w, const float* __restrict__ sc,
               const float* __restrict__ zr, void* __restrict__ y, int m, int k, int n, int gs, int out_bf16,
               int split_steps, float* __restrict__ part, int* __restrict__ tickets) {
  constexpr int kHalves = kPacked ? 2 : 1;
  constexpr int kLoads = kPacked ? 2 : 4;      // rows of w a lane loads a k-step
  constexpr int kStepRows = kPacked ? 8 : 16;  // rows of w a k-step
  constexpr int kWords = kLaneCols / 4;        // words a lane loads a row
  constexpr int kSzStride = kLaneCols + 4;     // floats of a lane group's scales (or zeros): conflict-free reads
  constexpr int kSzFloats = 2 * 2 * 8 * kSzStride;  // K13: a warp's [half][s, z][lane group][kSzStride]
  static_assert(kGemvMaxWarps * kSzFloats <= kGemvMaxWarps * kGemvRows * kGemvCols, "the scales fit sred");
  // the warps' sums [warp][row][column] after the k-loop; K13's scales and zeros during it
  __shared__ __align__(16) float sred[kGemvMaxWarps * kGemvRows * kGemvCols];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int col0 = blockIdx.x * kGemvCols;
  const int col = col0 + kLaneCols * gid;  // the lane's kLaneCols columns (n % 16 == 0: all in or all out)
  const bool col_ok = col < n;
  const bool x_ok = gid < m;
  const int half = k / 2;
  const int group_steps = gs / kStepRows;  // k-steps a group
  const int half_groups = half / gs;       // K13: the groups of the low half
  const int split = blockIdx.y;
  const int s_end = min((split + 1) * split_steps, k / 16);
  const int warp_steps = (split_steps + n_warps - 1) / n_warps;
  const int ks_begin = split * split_steps + warp * warp_steps;
  const int ks_end = min(ks_begin + warp_steps, s_end);
  const uint8_t* wl = w + (size_t)(tig * kLoads) * n + col;  // the lane's first row of step 0
  const __nv_bfloat16* xl = x + (size_t)gid * k + tig * kLoads;
  float* szl = sred + warp * kSzFloats + gid * kSzStride;  // K13: the lane group's [half][s, z] rows

  float acc[kLaneCols / 2][4];
#pragma unroll
  for (int j = 0; j < kLaneCols / 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float sv[kPacked ? 1 : kLaneCols], zv[kPacked ? 1 : kLaneCols];  // K12: the group's, for the lane's columns
  int g_next = ks_begin;  // the first step of the next group
  auto load_group = [&](int g) {
    if constexpr (kPacked) {  // 16-byte pieces tig, tig + 4, ... of the quad's kLaneCols: [half][s, z][kLaneCols / 4]
      __syncwarp();  // every lane is done with the last group's
      if (col_ok) {
#pragma unroll
        for (int t = 0; t < kLaneCols / 4; ++t) {
          const int c = tig + 4 * t;
          const int hw = c / (kLaneCols / 4), q = c % (kLaneCols / 4);  // hw: half * 2 + (zeros ? 1 : 0)
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              (hw & 1 ? zr : sc) + (size_t)(g + (hw >> 1) * half_groups) * n + col + 4 * q));
          *reinterpret_cast<float4*>(szl + hw * 8 * kSzStride + 4 * q) = v;
        }
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int q = 0; q < kLaneCols / 4; ++q) {
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f), z4 = s4;
        if (col_ok) {
          s4 = __ldg(reinterpret_cast<const float4*>(sc + (size_t)g * n + col) + q);
          z4 = __ldg(reinterpret_cast<const float4*>(zr + (size_t)g * n + col) + q);
        }
        sv[4 * q] = s4.x, sv[4 * q + 1] = s4.y, sv[4 * q + 2] = s4.z, sv[4 * q + 3] = s4.w;
        zv[4 * q] = z4.x, zv[4 * q + 1] = z4.y, zv[4 * q + 2] = z4.z, zv[4 * q + 3] = z4.w;
      }
    }
  };

  for (int ks0 = ks_begin; ks0 < ks_end; ks0 += kAhead) {
    uint32_t wv[kAhead][kLoads][kWords];
    uint32_t xv[kAhead][2];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool live = ks0 + u < ks_end;
#pragma unroll
      for (int r = 0; r < kLoads; ++r) {
        if (live && col_ok) {
          const uint2 t = __ldg(reinterpret_cast<const uint2*>(wl + (size_t)((ks0 + u) * kStepRows + r) * n));
          wv[u][r][0] = t.x, wv[u][r][1] = t.y;
        } else {
#pragma unroll
          for (int q = 0; q < kWords; ++q) wv[u][r][q] = 0u;
        }
      }
      xv[u][0] = xv[u][1] = 0u;
      if (live && x_ok) {
        if constexpr (kPacked) {  // x[r], x[r + 1] and x[r + K/2], x[r + 1 + K/2]
          const uint32_t lo = *reinterpret_cast<const uint32_t*>(xl + (ks0 + u) * kStepRows);
          const uint32_t hi = *reinterpret_cast<const uint32_t*>(xl + half + (ks0 + u) * kStepRows);
          xv[u][0] = __byte_perm(lo, hi, 0x5410);
          xv[u][1] = __byte_perm(lo, hi, 0x7632);
        } else {  // x[r .. r + 3]
          const uint2 v = *reinterpret_cast<const uint2*>(xl + (ks0 + u) * kStepRows);
          xv[u][0] = v.x, xv[u][1] = v.y;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int ks = ks0 + u;
      if (ks >= ks_end) break;
      if (ks == g_next) {  // a new group (the same for the whole warp)
        const int g = ks / group_steps;
        g_next = (g + 1) * group_steps;
        load_group(g);
      }
      // doubled nibbles: [r][q] word q of row r (K13: [r][q] low, [kLoads + r][q] high)
      uint32_t tw[kHalves * kLoads][kWords];
#pragma unroll
      for (int r = 0; r < kLoads; ++r)
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
          if constexpr (kPacked) {
            tw[r][q] = (wv[u][r][q] << 1) & 0x1E1E1E1Eu;
            tw[kLoads + r][q] = (wv[u][r][q] >> 3) & 0x1E1E1E1Eu;
          } else {
            tw[r][q] = ((wv[u][r][q] << 1) & 0x1E1E1E1Eu) ^ 0x10101010u;
          }
        }
#pragma unroll
      for (int j = 0; j < kLaneCols / 2; ++j) {  // the lane's columns 2j (A row gid) and 2j + 1 (A row gid + 8)
        uint32_t a[4];
        if constexpr (kPacked) {  // row e / 2: (low, high) nibble
          float2 s2[2], z2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s2[h] = *reinterpret_cast<const float2*>(szl + (h * 2) * 8 * kSzStride + 2 * j);
            z2[h] = *reinterpret_cast<const float2*>(szl + (h * 2 + 1) * 8 * kSzStride + 2 * j);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * j + (e & 1), r = e >> 1;
            const bool odd = e & 1;
            a[e] = weight_pair(nib_value(tw[r][c / 4], c % 4), odd ? s2[0].y : s2[0].x, odd ? z2[0].y : z2[0].x,
                               nib_value(tw[kLoads + r][c / 4], c % 4), odd ? s2[1].y : s2[1].x,
                               odd ? z2[1].y : z2[1].x);
          }
        } else {  // rows (0, 1) for e < 2, (2, 3) above
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * j + (e & 1), r = 2 * (e >> 1);
            a[e] = weight_pair(nib_value(tw[r][c / 4], c % 4), sv[c], zv[c], nib_value(tw[r + 1][c / 4], c % 4),
                               sv[c], zv[c]);
          }
        }
        mma_bf16(acc[j], a, xv[u]);
      }
    }
  }
  __syncthreads();  // K13's scales are done with: sred takes the warps' sums

  // D: acc[j][e] is column kLaneCols gid + 2j + (e >> 1), row 2 tig + (e & 1)
#pragma unroll
  for (int j = 0; j < kLaneCols / 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = 2 * tig + (e & 1);
      if (b < m) sred[(warp * kGemvRows + b) * kGemvCols + kLaneCols * gid + 2 * j + (e >> 1)] = acc[j][e];
    }
  __syncthreads();

  const int n_splits = gridDim.y;
  for (int i = tid; i < m * kGemvCols; i += blockDim.x) {
    const int b = i / kGemvCols;
    const int c = col0 + i % kGemvCols;
    if (c >= n) continue;
    float v = 0.f;
    for (int wp = 0; wp < n_warps; ++wp) v += sred[(wp * kGemvRows + b) * kGemvCols + i % kGemvCols];
    if (n_splits == 1) {
      store_y(y, out_bf16, (size_t)b * n + c, v);
    } else {
      part[((size_t)split * m + b) * n + c] = v;
    }
  }
  if (n_splits == 1) return;
  __syncthreads();  // the block's writes happen before thread 0's release
  if (tid == 0) last = atom_add_acq_rel(&tickets[blockIdx.x], 1) == n_splits - 1;
  __syncthreads();  // and thread 0's acquire before the last block's reads
  if (!last) return;
  // every output the thread merges loads its splits' partials at once (one
  // L2 round trip for up to kMergeSplits splits), then sums them in order
  const size_t stride = (size_t)m * n;
  for (int o0 = tid; o0 < m * kGemvCols; o0 += kMergeOut * blockDim.x) {
    const float* p[kMergeOut];
    bool live[kMergeOut];
    float v[kMergeOut];
#pragma unroll
    for (int j = 0; j < kMergeOut; ++j) {
      const int o = o0 + j * blockDim.x;
      live[j] = o < m * kGemvCols && col0 + o % kGemvCols < n;
      p[j] = part + (size_t)(o / kGemvCols) * n + col0 + o % kGemvCols;
      v[j] = 0.f;
    }
    for (int s0 = 0; s0 < n_splits; s0 += kMergeSplits) {
      float pv[kMergeOut][kMergeSplits];
#pragma unroll
      for (int j = 0; j < kMergeOut; ++j)
#pragma unroll
        for (int s = 0; s < kMergeSplits; ++s)
          pv[j][s] = live[j] && s0 + s < n_splits ? __ldcg(p[j] + (s0 + s) * stride) : 0.f;
#pragma unroll
      for (int j = 0; j < kMergeOut; ++j)
#pragma unroll
        for (int s = 0; s < kMergeSplits; ++s)
          if (s0 + s < n_splits) v[j] += pv[j][s];
    }
#pragma unroll
    for (int j = 0; j < kMergeOut; ++j) {
      const int o = o0 + j * blockDim.x;
      if (live[j]) store_y(y, out_bf16, (size_t)(o / kGemvCols) * n + col0 + o % kGemvCols, v[j]);
    }
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}


}  // namespace

// x: (m, k) bf16; w: q (k, n) int8 (packed 0) or p (k/2, n) uint8 (packed 1); scales, zeros:
// (k/groupsize, n) f32; y: (m, n) bf16 (out_bf16 1) or f32 (out_bf16 0); all contiguous on the
// device. k a multiple of 8 and of groupsize (packed: k/2 a multiple of groupsize), n a multiple
// of 16. split_steps > 0 takes the GEMV (the caller's route: m <= 8 and groupsize a multiple of
// 16): K in ceil(k / 16 / split_steps) splits of split_steps k-steps of 16, blocks of warps
// (1..8) warps; with more than one split it needs part, (splits, m, n) f32, and tickets,
// n_tickets >= ceil(n / 64) int32 all 0 (left 0). split_steps 0 takes the ring (the plan,
// ops/quantized.int4g_tile_plan): mt m16 tiles a block's rows (1, 2, 4, 8 or 16), split_chunks
// staged blocks of 64 rows of w a split; with more than one split part, (splits, m, n) f32, and
// tickets, n_tickets >= the tiles (row x column), int32 all 0 (left 0). Returns a cudaError_t.
extern "C" int mv_matmul_int4_grouped(const void* x, const void* w, const void* scales, const void* zeros,
                                      void* y, int m, int k, int n, int groupsize, int packed, int out_bf16,
                                      int split_steps, int warps, int mt, int split_chunks, void* part,
                                      void* tickets, int n_tickets, void* stream) {
  if (m < 1 || k < 8 || k % 8 != 0 || n < 16 || n % 16 != 0 || groupsize < 1 || k % groupsize != 0 ||
      (packed && (k / 2) % groupsize != 0) || x == nullptr || w == nullptr || scales == nullptr ||
      zeros == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  if (split_steps < 0) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint8_t*>(w);
  const auto* sf = static_cast<const float*>(scales);
  const auto* zf = static_cast<const float*>(zeros);
  auto* pf = static_cast<float*>(part);
  auto* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_steps > 0) {
    const int n_splits = (k / 16 + split_steps - 1) / split_steps;
    if (m > kGemvRows || groupsize % 16 != 0 || warps < 1 || warps > kGemvMaxWarps || n_splits > 65535 ||
        (n_splits > 1 && (part == nullptr || tickets == nullptr || n_tickets < (n + kGemvCols - 1) / kGemvCols)))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((n + kGemvCols - 1) / kGemvCols, n_splits);
    if (packed) {
      int4g_mma_gemv<true, kAheadP><<<grid, warps * 32, 0, s>>>(xb, wb, sf, zf, y, m, k, n, groupsize, out_bf16,
                                                                split_steps, pf, tk);
    } else {
      int4g_mma_gemv<false, kAheadQ><<<grid, warps * 32, 0, s>>>(xb, wb, sf, zf, y, m, k, n, groupsize, out_bf16,
                                                                 split_steps, pf, tk);
    }
    return (int)cudaGetLastError();
  }
  const RgArgs a{sf, zf, y, pf, tk, m, k, n, groupsize, out_bf16, split_chunks, 0};
  return packed ? rg_run<kRgP4>(xb, wb, a, mt, n_tickets, s) : rg_run<kRgQ4>(xb, wb, a, mt, n_tickets, s);
}
