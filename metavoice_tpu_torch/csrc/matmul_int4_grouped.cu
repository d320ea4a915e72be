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
// Design (simple and right first; no TMA, no wgmma, no pipelining yet):
//   * M > 8: tensor-core tiles. A block of 8 warps computes a 64 x 128
//     output tile with mma.sync m16n8k16 bf16 -> f32, each warp a 32 x 32
//     sub-tile. For each 64-row block of K, the block dequantizes the 64 x 128
//     weights once into shared memory as bf16 (16 columns a thread, the
//     scale and zero of each row's group read beside them; K13 reads packed
//     row k mod K/2 and takes its low nibble below K/2, its high one above)
//     and stages the 64 x 64 slice of x; B fragments are two 16-bit reads
//     of neighbouring k. Shared-memory rows are padded so the fragment reads
//     are free of bank conflicts.
//   * M <= 8: the split-K CUDA-core GEMV of the plain-int8 kernels
//     (gemv8_partial in decode_gemv.cuh): a block owns 64 byte rows by
//     32 * CPL columns, a lane's 16- (or 8-) byte load is CPL neighbouring
//     columns at one row, x is broadcast from shared memory, and each
//     weight is dequantized where it is read, with the group's scales and
//     zeros held in registers and reloaded when the group changes. K13's
//     block owns packed rows, so each byte is read once and gives both its
//     weights (row r and row r + K/2, each with its own group). The partials
//     are summed in a fixed order by gemv_reduce, which writes x's dtype.
//     The tiles would give N / 128 = 16-48 blocks at M = 2 on 132 SMs.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrappers and their plain PyTorch
// versions are ops/quantized.py:matmul_int4 and matmul_int4_packed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_gemv.cuh"

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

// Partial products of x (b_rows, K) bf16 with the groupwise int4 weights
// over byte rows [chunk * 64, +64) (K12: rows of K; K13: rows of p, each
// giving rows r and r + K/2): part[chunk][b][n] in f32.
template <int NB, int CPL, bool kPacked>
__global__ void __launch_bounds__(kGemvThreads)
int4g_gemv_partial(const __nv_bfloat16* __restrict__ x, int b_rows, int k, int n, int gs,
                   const uint8_t* __restrict__ w, const float* __restrict__ sc, const float* __restrict__ zr,
                   float* __restrict__ part) {
  constexpr int kHalves = kPacked ? 2 : 1;
  constexpr int kCols = 32 * CPL;
  const int rows = k / kHalves;  // byte rows of w
  const int chunk = blockIdx.y;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = chunk * kChunk8;

  __shared__ float sx[kHalves][kChunk8][NB];
  // [warp][b][c][lane], padded so that the reduce below reads a lane's CPL
  // columns without bank conflicts
  __shared__ float sred[kGemvWarps][NB][CPL][33];

  for (int i = tid; i < kHalves * kChunk8 * NB; i += kGemvThreads) {
    const int h = i / (kChunk8 * NB);
    const int r = (i / NB) % kChunk8;
    const int b = i % NB;
    sx[h][r][b] = b < b_rows && row0 + r < rows ? bf(x[(size_t)b * k + (size_t)h * rows + row0 + r]) : 0.f;
  }
  __syncthreads();

  float acc[NB][CPL];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[b][c] = 0.f;

  const int col = col0 + lane * CPL;
  if (col < n) {
    float sv[kHalves][CPL], zv[kHalves][CPL];
    int g_cur[kHalves];
#pragma unroll
    for (int h = 0; h < kHalves; ++h) g_cur[h] = -1;
    for (int rr = 0; rr < kRowsPerGemvWarp8; ++rr) {
      const int r = warp * kRowsPerGemvWarp8 + rr;
      if (row0 + r >= rows) break;
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const int g = (h * rows + row0 + r) / gs;
        if (g != g_cur[h]) {  // the same row for the whole warp: no divergence
          g_cur[h] = g;
          const float4* sp = reinterpret_cast<const float4*>(sc + (size_t)g * n + col);
          const float4* zp = reinterpret_cast<const float4*>(zr + (size_t)g * n + col);
#pragma unroll
          for (int q = 0; q < CPL / 4; ++q) {
            const float4 s4 = __ldg(sp + q);
            const float4 z4 = __ldg(zp + q);
            sv[h][4 * q] = s4.x;
            sv[h][4 * q + 1] = s4.y;
            sv[h][4 * q + 2] = s4.z;
            sv[h][4 * q + 3] = s4.w;
            zv[h][4 * q] = z4.x;
            zv[h][4 * q + 1] = z4.y;
            zv[h][4 * q + 2] = z4.z;
            zv[h][4 * q + 3] = z4.w;
          }
        }
      }
      uint32_t wv[CPL / 4];
      load_bytes<CPL>(reinterpret_cast<const int8_t*>(w) + (size_t)(row0 + r) * n + col, wv);
      float xv[kHalves][NB];
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int b = 0; b < NB; ++b) xv[h][b] = sx[h][r][b];
#pragma unroll
      for (int q = 0; q < CPL / 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < kHalves; ++h) {
            const int c = 4 * q + j;
            const float wt = bf(dequant(int4_value<kPacked>(wv[q], j, h), sv[h][c], zv[h][c]));
#pragma unroll
            for (int b = 0; b < NB; ++b) acc[b][c] = fmaf(xv[h][b], wt, acc[b][c]);
          }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < CPL; ++c) sred[warp][b][c][lane] = acc[b][c];
  __syncthreads();

  for (int i = tid; i < NB * kCols; i += kGemvThreads) {
    const int b = i / kCols;
    const int cc = i % kCols;
    if (b >= b_rows || col0 + cc >= n) continue;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kGemvWarps; ++wp) v += sred[wp][b][cc % CPL][cc / CPL];
    part[((size_t)chunk * b_rows + b) * n + col0 + cc] = v;
  }
}

template <int NB, int CPL, bool kPacked>
cudaError_t run_gemv(const __nv_bfloat16* x, int m, int k, int n, int gs, const uint8_t* w, const float* sc,
                     const float* zr, void* y, int out_bf16, float* part, cudaStream_t s) {
  const int rows = kPacked ? k / 2 : k;
  const int n_chunks = (rows + kChunk8 - 1) / kChunk8;
  int4g_gemv_partial<NB, CPL, kPacked><<<dim3((n + 32 * CPL - 1) / (32 * CPL), n_chunks), kGemvThreads, 0, s>>>(
      x, m, k, n, gs, w, sc, zr, part);
  MV_CHECK(cudaGetLastError());
  Epilogue e{};
  e.kind = out_bf16 ? kEpiBf16 : kEpiF32;
  e.out_f32 = static_cast<float*>(y);
  e.out_bf16 = static_cast<__nv_bfloat16*>(y);
  gemv_reduce<<<(m * n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(part, n_chunks, m, n, e);
  return cudaGetLastError();
}

template <bool kPacked>
cudaError_t run(const __nv_bfloat16* x, const uint8_t* w, const float* sc, const float* zr, void* y, int m, int k,
                int n, int gs, int out_bf16, float* part, cudaStream_t s) {
  if (m == 1) return run_gemv<1, 16, kPacked>(x, m, k, n, gs, w, sc, zr, y, out_bf16, part, s);
  if (m == 2) return run_gemv<2, 16, kPacked>(x, m, k, n, gs, w, sc, zr, y, out_bf16, part, s);
  if (m <= 4) return run_gemv<4, 16, kPacked>(x, m, k, n, gs, w, sc, zr, y, out_bf16, part, s);
  if (m <= 8) return run_gemv<8, 8, kPacked>(x, m, k, n, gs, w, sc, zr, y, out_bf16, part, s);
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  int4g_tile_kernel<kPacked><<<grid, kTileThreads, 0, s>>>(x, w, sc, zr, y, m, k, n, gs, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// x: (m, k) bf16; w: q (k, n) int8 (packed 0) or p (k/2, n) uint8 (packed 1); scales, zeros:
// (k/groupsize, n) f32; y: (m, n) bf16 (out_bf16 1) or f32 (out_bf16 0); all contiguous on
// the device. k a multiple of 8 and of groupsize (packed: k/2 a multiple of groupsize), n a
// multiple of 16. m <= 8 takes the GEMV and needs part, ceil(rows of w / 64) * m * n f32;
// more rows take the tiles (part unused). Returns a cudaError_t.
extern "C" int mv_matmul_int4_grouped(const void* x, const void* w, const void* scales, const void* zeros,
                                      void* y, int m, int k, int n, int groupsize, int packed, int out_bf16,
                                      void* part, void* stream) {
  if (m < 1 || k < 8 || k % 8 != 0 || n < 16 || n % 16 != 0 || groupsize < 1 || k % groupsize != 0 ||
      (packed && (k / 2) % groupsize != 0) || x == nullptr || w == nullptr || scales == nullptr ||
      zeros == nullptr || y == nullptr || (m <= 8 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint8_t*>(w);
  const auto* sf = static_cast<const float*>(scales);
  const auto* zf = static_cast<const float*>(zeros);
  auto* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) return (int)run<true>(xb, wb, sf, zf, y, m, k, n, groupsize, out_bf16, pf, s);
  return (int)run<false>(xb, wb, sf, zf, y, m, k, n, groupsize, out_bf16, pf, s);
}
