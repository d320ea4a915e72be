// Groupwise int4 weight-only matmuls, K12 and K13 (mv_matmul_int4_grouped),
// written for Hopper (sm_90a).
//
// Replaces metavoice_tpu/ops/quantized.py:matmul_int4 (the Pallas TPU kernel
// _int4_matmul_kernel, K12) and matmul_int4_packed
// (_int4_packed_matmul_kernel, K13): the projections of a first stage whose
// layer weights are the JAX package's groupwise int4 leaves
// (quantize_params_int4 and _packed, the reference's own format,
// fam/llm/fast_quantize.py:70-148). For x (M, K) bf16, q (K, N) int8 in
// [-8, 7] (K12) or p (K/2, N) uint8 split-half nibble pairs (K13: the low
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
// 3.35 TB/s. At M = 256 (prefill: the CFG pair x a 128-token bucket) the
// same layer is 26.3 GFLOP: about 27 us on the bf16 tensor cores.
//
// Design:
//   * M > 8: tensor-core tiles. A block of 8 warps computes a 64 x 128
//     output tile with mma.sync m16n8k16 bf16 -> f32, each warp a 32 x 32
//     sub-tile. For each 64-row block of K, the block dequantizes the 64 x 128
//     weights once into shared memory as bf16 (16 columns a thread, the
//     scale and zero of each row's group read beside them; K13 reads packed
//     row k mod K/2 and takes its low nibble below K/2, its high one above)
//     and stages the 64 x 64 slice of x; B fragments are two 16-bit reads
//     of neighbouring k. Shared-memory rows are padded so the fragment reads
//     are free of bank conflicts. No TMA, no wgmma, no pipelining yet.
//   * M <= 8 (groupsize a multiple of 16; any other takes the tiles): one
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

namespace {

constexpr int kTileM = 64;          // output rows per block
constexpr int kTileN = 128;         // output columns per block
constexpr int kTileK = 64;          // rows of K staged at once
constexpr int kTileThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kXStride = kTileK + 8;  // bf16 per staged x row (pad: conflict-free A reads)
constexpr int kWStride = kTileN + 8;  // bf16 per staged weight row (pad: conflict-free B reads)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte j of a word of four weight bytes as the exact f32 q + 0.5: the signed
// byte (K12), or nibble h of it minus 7.5 (K13).
template <bool kPacked>
__device__ __forceinline__ float int4_value(uint32_t word, int j, int h) {
  if constexpr (kPacked) {
    return (float)((word >> (8 * j + 4 * h)) & 0xFu) - 7.5f;
  } else {
    return (float)(int)(int8_t)((word >> (8 * j)) & 0xFFu) + 0.5f;
  }
}

// The weight of value v in its group: bf16(v * s + z), no contraction.
__device__ __forceinline__ __nv_bfloat16 dequant(float v, float s, float z) {
  return __float2bfloat16_rn(__fadd_rn(__fmul_rn(v, s), z));
}

template <bool kPacked>
__global__ void __launch_bounds__(kTileThreads)
int4g_tile_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ sc, const float* __restrict__ zr, void* __restrict__ y,
                  int m, int k, int n, int gs, int out_bf16) {
  __shared__ __align__(16) __nv_bfloat16 w_s[kTileK * kWStride];
  __shared__ __align__(16) __nv_bfloat16 x_s[kTileM * kXStride];

  const int half = k / 2;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // which 32-row half of the tile
  const int wn = warp >> 1;  // which 32-column quarter
  const int gid = lane >> 2;
  const int tig = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int tm = 0; tm < 2; ++tm)
#pragma unroll
    for (int tn = 0; tn < 4; ++tn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tm][tn][e] = 0.f;

  const int n_blocks = (k + kTileK - 1) / kTileK;
  for (int kb = 0; kb < n_blocks; ++kb) {
    const int k0 = kb * kTileK;
    __syncthreads();  // the previous block's readers are done
    for (int i = tid; i < kTileK * (kTileN / 16); i += kTileThreads) {
      const int r = i / (kTileN / 16);
      const int c16 = (i % (kTileN / 16)) * 16;
      const int kr = k0 + r;
      const int col = col0 + c16;
      uint32_t out[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      // n % 16 == 0, so a 16-column vector is all in or all out
      if (kr < k && col < n) {
        const int h = kPacked && kr >= half ? 1 : 0;
        const int wrow = kr - h * half;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)wrow * n + col));
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
        const float4* sp = reinterpret_cast<const float4*>(sc + (size_t)(kr / gs) * n + col);
        const float4* zp = reinterpret_cast<const float4*>(zr + (size_t)(kr / gs) * n + col);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 s4 = __ldg(sp + q);
          const float4 z4 = __ldg(zp + q);
          __nv_bfloat162 lo, hi;
          lo.x = dequant(int4_value<kPacked>(words[q], 0, h), s4.x, z4.x);
          lo.y = dequant(int4_value<kPacked>(words[q], 1, h), s4.y, z4.y);
          hi.x = dequant(int4_value<kPacked>(words[q], 2, h), s4.z, z4.z);
          hi.y = dequant(int4_value<kPacked>(words[q], 3, h), s4.w, z4.w);
          out[2 * q] = *reinterpret_cast<uint32_t*>(&lo);
          out[2 * q + 1] = *reinterpret_cast<uint32_t*>(&hi);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(w_s + r * kWStride + c16);
      dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
      dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
    }
    for (int i = tid; i < kTileM * (kTileK / 8); i += kTileThreads) {
      const int r = i / (kTileK / 8);
      const int c8 = (i % (kTileK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      // k % 8 == 0, so an 8-value vector is all in or all out
      if (row0 + r < m && k0 + c8 < k)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * k + k0 + c8);
      *reinterpret_cast<uint4*>(x_s + r * kXStride + c8) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int tm = 0; tm < 2; ++tm) {
        const __nv_bfloat16* base = x_s + (wm * 32 + tm * 16 + gid) * kXStride + kk + tig * 2;
        a[tm][0] = *reinterpret_cast<const uint32_t*>(base);
        a[tm][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kXStride);
        a[tm][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        a[tm][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kXStride + 8);
      }
#pragma unroll
      for (int tn = 0; tn < 4; ++tn) {
        const uint16_t* wb = reinterpret_cast<const uint16_t*>(w_s) + (kk + tig * 2) * kWStride + wn * 32 +
                             tn * 8 + gid;
        uint32_t b[2];
        b[0] = (uint32_t)wb[0] | ((uint32_t)wb[kWStride] << 16);
        b[1] = (uint32_t)wb[8 * kWStride] | ((uint32_t)wb[9 * kWStride] << 16);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm) mma_bf16(acc[tm][tn], a[tm], b);
      }
    }
  }

#pragma unroll
  for (int tn = 0; tn < 4; ++tn) {
    const int col = col0 + wn * 32 + tn * 8 + tig * 2;
    if (col >= n) continue;
#pragma unroll
    for (int tm = 0; tm < 2; ++tm) {
      const int r = row0 + wm * 32 + tm * 16 + gid;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows r and r + 8
        if (r + 8 * hh >= m) continue;
        const float v0 = acc[tm][tn][2 * hh];
        const float v1 = acc[tm][tn][2 * hh + 1];
        const size_t off = (size_t)(r + 8 * hh) * n + col;
        if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + off) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(y) + off) = make_float2(v0, v1);
        }
      }
    }
  }
}

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

template <bool kPacked>
cudaError_t run(const __nv_bfloat16* x, const uint8_t* w, const float* sc, const float* zr, void* y, int m, int k,
                int n, int gs, int out_bf16, int split_steps, int warps, float* part, int* tickets, cudaStream_t s) {
  if (split_steps > 0) {
    const dim3 grid((n + kGemvCols - 1) / kGemvCols, (k / 16 + split_steps - 1) / split_steps);
    int4g_mma_gemv<kPacked, kPacked ? kAheadP : kAheadQ><<<grid, warps * 32, 0, s>>>(
        x, w, sc, zr, y, m, k, n, gs, out_bf16, split_steps, part, tickets);
    return cudaGetLastError();
  }
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  int4g_tile_kernel<kPacked><<<grid, kTileThreads, 0, s>>>(x, w, sc, zr, y, m, k, n, gs, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// x: (m, k) bf16; w: q (k, n) int8 in [-8, 7] (packed 0) or p (k/2, n) uint8 (packed 1);
// scales, zeros: (k/groupsize, n) f32; y: (m, n) bf16 (out_bf16 1) or f32 (out_bf16 0); all
// contiguous on the device. k a multiple of 8 and of groupsize (packed: k/2 a multiple of
// groupsize), n a multiple of 16. split_steps > 0 takes the GEMV (the caller's route: m <= 8
// and groupsize a multiple of 16): K in ceil(k / 16 / split_steps) splits of split_steps k-steps
// of 16, blocks of warps (1..8) warps; with more than one split it needs part, (splits, m, n)
// f32, and tickets, n_tickets >= ceil(n / 64) int32 all 0 (left 0). split_steps 0 takes the
// tiles (warps, part and tickets unused). Returns a cudaError_t.
extern "C" int mv_matmul_int4_grouped(const void* x, const void* w, const void* scales, const void* zeros,
                                      void* y, int m, int k, int n, int groupsize, int packed, int out_bf16,
                                      int split_steps, int warps, void* part, void* tickets, int n_tickets,
                                      void* stream) {
  if (m < 1 || k < 8 || k % 8 != 0 || n < 16 || n % 16 != 0 || groupsize < 1 || k % groupsize != 0 ||
      (packed && (k / 2) % groupsize != 0) || x == nullptr || w == nullptr || scales == nullptr ||
      zeros == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  if (split_steps < 0) return (int)cudaErrorInvalidValue;
  if (split_steps > 0) {
    const int n_splits = (k / 16 + split_steps - 1) / split_steps;
    if (m > kGemvRows || groupsize % 16 != 0 || warps < 1 || warps > kGemvMaxWarps || n_splits > 65535 ||
        (n_splits > 1 && (part == nullptr || tickets == nullptr || n_tickets < (n + kGemvCols - 1) / kGemvCols)))
      return (int)cudaErrorInvalidValue;
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint8_t*>(w);
  const auto* sf = static_cast<const float*>(scales);
  const auto* zf = static_cast<const float*>(zeros);
  auto* pf = static_cast<float*>(part);
  auto* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed)
    return (int)run<true>(xb, wb, sf, zf, y, m, k, n, groupsize, out_bf16, split_steps, warps, pf, tk, s);
  return (int)run<false>(xb, wb, sf, zf, y, m, k, n, groupsize, out_bf16, split_steps, warps, pf, tk, s);
}
