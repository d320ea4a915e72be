// Weight-only matmuls for prefill, written for Hopper (sm_90a): in the
// int32-word serving formats (one kernel template, two C entries, K2 and
// K8), and on plain int8 arrays (K11).
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
// bf16 at the same point as in the TPU kernel; its f32 sum runs in another
// order than the plain version's, so a row whose sum lies on a bf16 rounding
// boundary can round the other way (a shift of |c| * ulp(sum x) in that row).
//
// What bounds it: at the main-path shape (M = 256, the CFG pair times a
// 128-token prompt bucket; K x N of 2048 x 6144) a call is 6.4 GFLOP against
// 14 MB (int4) or 20 MB (int8) of operands, so the tensor cores (989 TFLOP/s
// bf16) and not the memory set the bound, at about 6.5 us.
//
// K11, plain int8 (mv_matmul_int8): replaces
// metavoice_tpu/ops/quantized.py:matmul_int8 (the Pallas TPU kernel
// _int8_matmul_kernel), the projections of quantisation_mode="int8_plain"
// outside K9/K10 (prefill, the speculative verify, GQA and quantized-cache
// decode). q (K, N) int8 row-major with one f32 scale per column:
//     y = (bf16(x) @ bf16(q)) * s, in x's dtype (bf16 or f32),
// the int8 values exact in bf16 and the products summed in f32. At the
// main-path shape (M = 256; one layer's five projections, 2048 x 6144,
// 2048 x 2048, 2048 x 5632 twice, 5632 x 2048) that is 26 GFLOP against
// 51 MB of int8 weights: bound by the tensor cores.
//
// Design (simple and right first; no TMA, no wgmma, no pipelining yet):
//   * One block of 8 warps computes a 64 x 128 output tile with mma.sync
//     m16n8k16 bf16 -> f32; each warp owns a 32 x 32 sub-tile.
//   * For each 128-row block of word rows, the block stages the words once in
//     shared memory and walks the slabs they hold (8 nibbles or 4 bytes a
//     word): for each slab it stages the matching 64 x 128 slice of x, takes
//     the rows' sums in f32, and runs the slab's 8 k-steps, building each B
//     fragment from the staged words (word_values.cuh, then a convert to
//     bf16x2).
//   * int4: each slab of a word block is one group; its f32 fragment is
//     scaled by s_g and the c-term (group sum rounded to bf16, as the TPU
//     kernel feeds it to its c-term dot) added in registers, so the affine
//     terms never touch the per-weight path. int8: one fragment sums over all
//     of K, the row sums add up over K, and the epilogue applies s and
//     bf16(sum x) * c once per output.
//   * Word rows past K/4 (int8 with K/4 not a multiple of 128) stage as
//     zeros, so K needs only be a multiple of 32 there.
//   * Shared-memory rows are padded so that fragment loads are free of bank
//     conflicts.
//   * K11 has the same tiles and MMA on the plain layout: each 128-row
//     block of q is staged in shared memory as bytes, and a B fragment's
//     four values (k and k + 1, k + 8 and k + 9 of one column) are four
//     byte reads converted exactly to bf16. A 32-bit word of this layout
//     holds four columns at one k, so the word formats' per-word extraction
//     does not apply. x is never quantized (an int8 MMA would need that):
//     the TPU kernel's arithmetic is bf16 products summed in f32. The scale
//     and the cast to x's dtype are the epilogue.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper and its plain PyTorch
// version are in metavoice_tpu_torch/ops/quantized.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "word_values.cuh"

namespace {

constexpr int kGroup = 128;           // quantization groupsize (rows of K per group)
constexpr int kBM = 64;               // output rows per block
constexpr int kBN = 128;              // output columns per block
constexpr int kThreads = 256;         // 8 warps: 2 along M x 4 along N
constexpr int kXStride = kGroup + 8;  // bf16 per staged x row (pad: conflict-free A loads)
constexpr int kWStride = kBN + 4;     // words per staged weight row (pad: conflict-free B loads)
constexpr size_t kSmemBytes =
    sizeof(int32_t) * kGroup * kWStride + sizeof(__nv_bfloat16) * kBM * kXStride + sizeof(float) * kBM;
constexpr unsigned kFull = 0xffffffffu;

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

// kVals values a word: 8 (int4, a group every 128 rows of a slab) or 4
// (int8, one group over all of K).
template <int kVals>
__global__ void __launch_bounds__(kThreads)
matmul_i32_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ pw,
                  const __nv_bfloat16* __restrict__ sc, float* __restrict__ y, int m, int k, int n,
                  int gp) {
  constexpr bool kInt8 = kVals == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* w_s = reinterpret_cast<int32_t*>(smem);  // [kGroup][kWStride]
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(w_s + kGroup * kWStride);  // [kBM][kXStride]
  float* xsum_s = reinterpret_cast<float*>(x_s + kBM * kXStride);                  // [kBM]

  const int kw = k / kVals;                          // word rows
  const int n_blocks = (kw + kGroup - 1) / kGroup;   // 128-row word blocks (int4: groups per slab)
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // which 32-row half of the tile
  const int wn = warp >> 1;  // which 32-column quarter
  const int gid = lane >> 2;
  const int tig = lane & 3;

  float acc[2][4][4];   // int4: the sum of the scaled groups
  float accg[2][4][4];  // int4: this group's dots; int8: the dots over all of K
#pragma unroll
  for (int tm = 0; tm < 2; ++tm)
#pragma unroll
    for (int tn = 0; tn < 4; ++tn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tm][tn][e] = accg[tm][tn][e] = 0.f;
  if constexpr (kInt8) {
    if (tid < kBM) xsum_s[tid] = 0.f;  // read after the loop's first barrier
  }

  for (int mb = 0; mb < n_blocks; ++mb) {
    __syncthreads();  // the previous word block's readers are done
    for (int i = tid; i < kGroup * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4);
      const int c4 = (i % (kBN / 4)) * 4;
      int4 v = make_int4(0, 0, 0, 0);
      // n % 8 == 0, so a 4-word vector is all in or all out
      if (col0 + c4 < n && mb * kGroup + r < kw)
        v = *reinterpret_cast<const int4*>(pw + (size_t)(mb * kGroup + r) * n + col0 + c4);
      *reinterpret_cast<int4*>(w_s + r * kWStride + c4) = v;
    }

    for (int j = 0; j < kVals; ++j) {
      const int g = j * n_blocks + mb;  // int4: the group value j of these words belongs to
      __syncthreads();  // words staged; the previous slab's readers are done
      for (int i = tid; i < kBM * (kGroup / 8); i += kThreads) {
        const int r = i / (kGroup / 8);
        const int c8 = (i % (kGroup / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        // kw % 8 == 0, so an 8-value vector is all in or all out
        if (row0 + r < m && mb * kGroup + c8 < kw)
          v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * k + (size_t)j * kw + mb * kGroup + c8);
        *reinterpret_cast<uint4*>(x_s + r * kXStride + c8) = v;
      }
      __syncthreads();

      {  // the rows' sums over this slice: 4 threads a row, f32
        const int r = tid >> 2;
        const int part = tid & 3;
        float s = 0.f;
#pragma unroll 8
        for (int c = part * 32; c < part * 32 + 32; ++c) s += __bfloat162float(x_s[r * kXStride + c]);
        s += __shfl_xor_sync(kFull, s, 1);
        s += __shfl_xor_sync(kFull, s, 2);
        if (part == 0) {
          if constexpr (kInt8) {
            xsum_s[r] += s;  // rounded to bf16 once, after all of K
          } else {
            xsum_s[r] = __bfloat162float(__float2bfloat16_rn(s));
          }
        }
      }

      if constexpr (!kInt8) {
#pragma unroll
        for (int tm = 0; tm < 2; ++tm)
#pragma unroll
          for (int tn = 0; tn < 4; ++tn)
#pragma unroll
            for (int e = 0; e < 4; ++e) accg[tm][tn][e] = 0.f;
      }

#pragma unroll 2
      for (int kk = 0; kk < kGroup; kk += 16) {
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
          const int32_t* wb = w_s + (kk + tig * 2) * kWStride + wn * 32 + tn * 8 + gid;
          uint32_t b[2];
          b[0] = pack_bf16x2(word_val<kVals>(wb[0], j), word_val<kVals>(wb[kWStride], j));
          b[1] = pack_bf16x2(word_val<kVals>(wb[8 * kWStride], j), word_val<kVals>(wb[9 * kWStride], j));
#pragma unroll
          for (int tm = 0; tm < 2; ++tm) mma_bf16(accg[tm][tn], a[tm], b);
        }
      }

      if constexpr (!kInt8) {
        __syncthreads();  // xsum_s is written
#pragma unroll
        for (int tn = 0; tn < 4; ++tn) {
          const int col = col0 + wn * 32 + tn * 8 + tig * 2;
          float s0 = 0.f, s1 = 0.f, c0 = 0.f, c1 = 0.f;
          if (col < n) {
            s0 = __bfloat162float(sc[(size_t)g * n + col]);
            s1 = __bfloat162float(sc[(size_t)g * n + col + 1]);
            c0 = __bfloat162float(sc[(size_t)(gp + g) * n + col]);
            c1 = __bfloat162float(sc[(size_t)(gp + g) * n + col + 1]);
          }
#pragma unroll
          for (int tm = 0; tm < 2; ++tm) {
            const int r = wm * 32 + tm * 16 + gid;
            const float xs0 = xsum_s[r];
            const float xs1 = xsum_s[r + 8];
            acc[tm][tn][0] += accg[tm][tn][0] * s0 + xs0 * c0;
            acc[tm][tn][1] += accg[tm][tn][1] * s1 + xs0 * c1;
            acc[tm][tn][2] += accg[tm][tn][2] * s0 + xs1 * c0;
            acc[tm][tn][3] += accg[tm][tn][3] * s1 + xs1 * c1;
          }
        }
      }
    }
  }

  if constexpr (kInt8) {  // the one group's epilogue: s * dots + bf16(sum x) * c
    __syncthreads();  // xsum_s is complete
#pragma unroll
    for (int tn = 0; tn < 4; ++tn) {
      const int col = col0 + wn * 32 + tn * 8 + tig * 2;
      float s0 = 0.f, s1 = 0.f, c0 = 0.f, c1 = 0.f;
      if (col < n) {
        s0 = __bfloat162float(sc[col]);
        s1 = __bfloat162float(sc[col + 1]);
        c0 = __bfloat162float(sc[(size_t)gp * n + col]);
        c1 = __bfloat162float(sc[(size_t)gp * n + col + 1]);
      }
#pragma unroll
      for (int tm = 0; tm < 2; ++tm) {
        const int r = wm * 32 + tm * 16 + gid;
        const float xs0 = __bfloat162float(__float2bfloat16_rn(xsum_s[r]));
        const float xs1 = __bfloat162float(__float2bfloat16_rn(xsum_s[r + 8]));
        acc[tm][tn][0] = accg[tm][tn][0] * s0 + xs0 * c0;
        acc[tm][tn][1] = accg[tm][tn][1] * s1 + xs0 * c1;
        acc[tm][tn][2] = accg[tm][tn][2] * s0 + xs1 * c0;
        acc[tm][tn][3] = accg[tm][tn][3] * s1 + xs1 * c1;
      }
    }
  }

#pragma unroll
  for (int tm = 0; tm < 2; ++tm) {
#pragma unroll
    for (int tn = 0; tn < 4; ++tn) {
      const int col = col0 + wn * 32 + tn * 8 + tig * 2;
      const int r = row0 + wm * 32 + tm * 16 + gid;
      if (col >= n) continue;
      if (r < m) *reinterpret_cast<float2*>(y + (size_t)r * n + col) = make_float2(acc[tm][tn][0], acc[tm][tn][1]);
      if (r + 8 < m)
        *reinterpret_cast<float2*>(y + (size_t)(r + 8) * n + col) = make_float2(acc[tm][tn][2], acc[tm][tn][3]);
    }
  }
}

template <int kVals>
int launch(const void* x, const void* pw, const void* sc, void* y, int m, int k, int n, int gp,
           void* stream) {
  // above 48 KB of shared memory a kernel must opt in, on each device it runs on
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_i32_kernel<kVals>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_i32_kernel<kVals><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(pw),
      static_cast<const __nv_bfloat16*>(sc), static_cast<float*>(y), m, k, n, gp);
  return (int)cudaGetLastError();
}

constexpr int kQStride = kBN + 16;  // bytes per staged int8 weight row (pad: conflict-free B reads)

__device__ __forceinline__ float i8f(int8_t v) { return __int2float_rn((int)v); }

__global__ void __launch_bounds__(kThreads)
matmul_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ sc, void* __restrict__ y, int m, int k, int n,
                   int out_bf16) {
  __shared__ __align__(16) int8_t q_s[kGroup * kQStride];
  __shared__ __align__(16) __nv_bfloat16 x_s[kBM * kXStride];

  const int n_blocks = (k + kGroup - 1) / kGroup;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
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

  for (int kb = 0; kb < n_blocks; ++kb) {
    const int k0 = kb * kGroup;
    __syncthreads();  // the previous block's readers are done
    for (int i = tid; i < kGroup * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16);
      const int c16 = (i % (kBN / 16)) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      // n % 16 == 0, so a 16-byte vector is all in or all out
      if (col0 + c16 < n && k0 + r < k)
        v = *reinterpret_cast<const uint4*>(q + (size_t)(k0 + r) * n + col0 + c16);
      *reinterpret_cast<uint4*>(q_s + r * kQStride + c16) = v;
    }
    for (int i = tid; i < kBM * (kGroup / 8); i += kThreads) {
      const int r = i / (kGroup / 8);
      const int c8 = (i % (kGroup / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      // k % 8 == 0, so an 8-value vector is all in or all out
      if (row0 + r < m && k0 + c8 < k)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * k + k0 + c8);
      *reinterpret_cast<uint4*>(x_s + r * kXStride + c8) = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kGroup; kk += 16) {
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
        const int8_t* qb = q_s + (kk + tig * 2) * kQStride + wn * 32 + tn * 8 + gid;
        uint32_t b[2];
        b[0] = pack_bf16x2(i8f(qb[0]), i8f(qb[kQStride]));
        b[1] = pack_bf16x2(i8f(qb[8 * kQStride]), i8f(qb[9 * kQStride]));
#pragma unroll
        for (int tm = 0; tm < 2; ++tm) mma_bf16(acc[tm][tn], a[tm], b);
      }
    }
  }

#pragma unroll
  for (int tn = 0; tn < 4; ++tn) {
    const int col = col0 + wn * 32 + tn * 8 + tig * 2;
    if (col >= n) continue;
    const float s0 = sc[col];
    const float s1 = sc[col + 1];
#pragma unroll
    for (int tm = 0; tm < 2; ++tm) {
      const int r = row0 + wm * 32 + tm * 16 + gid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows r and r + 8
        if (r + 8 * h >= m) continue;
        const float v0 = acc[tm][tn][2 * h] * s0;
        const float v1 = acc[tm][tn][2 * h + 1] * s1;
        const size_t off = (size_t)(r + 8 * h) * n + col;
        if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + off) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(y) + off) = make_float2(v0, v1);
        }
      }
    }
  }
}

}  // namespace

// x: (m, k) bf16, q: (k, n) int8, sc: (n,) f32, y: (m, n) bf16 (out_bf16 1) or f32
// (out_bf16 0), all contiguous on the device. k must be a multiple of 8 and n of 16.
// Returns a cudaError_t.
extern "C" int mv_matmul_int8(const void* x, const void* q, const void* sc, void* y, int m, int k,
                              int n, int out_bf16, void* stream) {
  if (m < 1 || k < 8 || k % 8 != 0 || n < 16 || n % 16 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(sc), y, m, k, n, out_bf16);
  return (int)cudaGetLastError();
}

// x: (m, k) bf16, pw: (k/8, n) int32, sc: (2*gp, n) bf16, y: (m, n) f32, all
// contiguous on the device. k must be a multiple of 1024 (8 slabs of whole
// 128-row groups) and n a multiple of 8. Returns a cudaError_t.
extern "C" int mv_matmul_int4_i32(const void* x, const void* pw, const void* sc, void* y, int m,
                                  int k, int n, int gp, void* stream) {
  if (m < 1 || k < 8 * kGroup || k % (8 * kGroup) != 0 || n < 8 || n % 8 != 0 || gp < k / kGroup)
    return (int)cudaErrorInvalidValue;
  return launch<8>(x, pw, sc, y, m, k, n, gp, stream);
}

// x: (m, k) bf16, p8: (k/4, n) int32, sc8: (2*gp, n) bf16 with s at row 0 and
// c at row gp, y: (m, n) f32, all contiguous on the device. k must be a
// multiple of 32 and n a multiple of 8. Returns a cudaError_t.
extern "C" int mv_matmul_int8_i32(const void* x, const void* p8, const void* sc8, void* y, int m,
                                  int k, int n, int gp, void* stream) {
  if (m < 1 || k < 32 || k % 32 != 0 || n < 8 || n % 8 != 0 || gp < 1)
    return (int)cudaErrorInvalidValue;
  return launch<4>(x, p8, sc8, y, m, k, n, gp, stream);
}
