// The split-K CUDA-core GEMV for a few rows of activations (B <= 8), used
// now only by the per-layer FFNs: over int32 weight words for the int4 FFN
// (decode_block_int4.cu, K6), and over plain (K, N) int8 weights
// (gemv8_partial) for the plain-int8 FFN (decode_block_int8.cu, K10). The
// decode stack (K3, K7) and the attention blocks (K5, K9) take the
// tensor-core GEMV of decode_stack_gemv.cuh.
//
// A block of gemv_partial owns 32 word rows (int4: a quarter of one 128-row
// group in each of the 8 nibble slabs) by 32 * CPT columns; neighbouring
// lanes read neighbouring columns' words with 16-byte loads; each thread
// keeps one partial sum per (row of x, slab, column), so the scale is
// applied once per block. The c term is added once per group: int4 by the
// block holding a group's first rows, int8 by the first block, which sums x
// over all of K. gemv_reduce sums the partials in a fixed order and applies
// the epilogue. The int4 products follow the TPU kernels'
// _int4_group_matmul: per group, f32 sums of x times the raw nibbles, times
// s_g, plus bf16(sum x_g) * c_g; the int8 ones _int8_word_matmul.
//
// gemv8_partial is the same split-K scheme over the plain layout: a block
// owns 64 rows of K by 32 * CPL columns, a lane's 16-byte (CPL 16) or
// 8-byte (CPL 8) load holds CPL neighbouring columns at one k, x is
// broadcast per k from shared memory, and each thread keeps CPL partial sums
// per row of x (64 registers at most: CPL narrows to 8 for B > 4). The
// signed bytes are exact floats; the column scale is applied once, in
// gemv_reduce, after the fixed-order sum over K: the TPU kernels' f32 dot of
// bf16 x and bf16(q), times s.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "word_values.cuh"

// Return a failed call's cudaError_t from the enclosing launch sequence.
#define MV_CHECK(expr)                          \
  do {                                          \
    const cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_;       \
  } while (0)

// An unnamed namespace: each including file gets its own copy of the kernels.
namespace {

constexpr int kQGroup = 128;        // quantization groupsize
constexpr int kChunkRows = 32;      // word rows per GEMV block
constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kRowsPerGemvWarp = kChunkRows / kGemvWarps;
constexpr int kReduceThreads = 256;

enum Epi { kEpiF32 = 0, kEpiSwiglu = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int VPW>
__device__ __forceinline__ void load_x(const float* p, float (&v)[VPW]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  if constexpr (VPW == 8) {
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
}

template <int CPT>
__device__ __forceinline__ void load_words(const int32_t* p, int32_t (&w)[CPT]) {
  if constexpr (CPT == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (CPT == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = __ldg(p);
  }
}

struct GemvMat {
  const int32_t* pw;        // (K/VPW, N)
  const __nv_bfloat16* sc;  // (2*gp, N)
};

// Partial products of x (b_rows, K) bf16 with the packed matrix of
// blockIdx.z (VPW values a word), over word rows [chunk * 32, +32):
// part[z][chunk][b][n] in f32. int4: the block holding the first rows of a
// group also adds that group's c-terms, once per group. int8: the first
// block adds the one group's c-term, bf16(sum of x over K) * c.
template <int NB, int CPT, int VPW>
__global__ void __launch_bounds__(kGemvThreads)
gemv_partial(const __nv_bfloat16* __restrict__ x, int b_rows, int kw, int n, int gp,
             GemvMat m0, GemvMat m1, float* __restrict__ part) {
  constexpr bool kInt8 = VPW == 4;
  constexpr int kCols = 32 * CPT;
  const GemvMat mat = blockIdx.z == 0 ? m0 : m1;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = VPW * kw;
  const int n_grp_slab = kInt8 ? 1 : kw / kQGroup;  // groups per slab
  const int row0 = chunk * kChunkRows;              // first word row
  const int mgrp = kInt8 ? 0 : row0 / kQGroup;      // group index inside each slab
  const bool first = kInt8 ? chunk == 0 : row0 % kQGroup == 0;

  __shared__ __align__(16) float sx[kChunkRows][NB][VPW];  // x at (slab j, word row r)
  __shared__ float sred[kGemvWarps][NB][kCols];
  __shared__ float sxs[NB][VPW];  // bf16-rounded group sums (int8: [b][0] only)

  for (int i = tid; i < kChunkRows * NB * VPW; i += kGemvThreads) {
    const int r = i / (NB * VPW);
    const int b = (i / VPW) % NB;
    const int j = i % VPW;
    sx[r][b][j] = b < b_rows ? bf(x[(size_t)b * k + (size_t)j * kw + row0 + r]) : 0.f;
  }
  if constexpr (kInt8) {
    if (first) {
      for (int b = warp; b < NB; b += kGemvWarps) {
        float s = 0.f;
        if (b < b_rows) {
          const __nv_bfloat16* xp = x + (size_t)b * k;
          for (int i = lane; i < k; i += 32) s += bf(xp[i]);
        }
        s = warp_sum(s);
        if (lane == 0) sxs[b][0] = round_bf16(s);
      }
    }
  } else if (first) {
    for (int jb = warp; jb < VPW * NB; jb += kGemvWarps) {
      const int j = jb % VPW;
      const int b = jb / VPW;
      float s = 0.f;
      if (b < b_rows) {
        const __nv_bfloat16* xp = x + (size_t)b * k + (size_t)j * kw + mgrp * kQGroup;
        for (int i = lane; i < kQGroup; i += 32) s += bf(xp[i]);
      }
      s = warp_sum(s);
      if (lane == 0) sxs[b][j] = round_bf16(s);
    }
  }
  __syncthreads();

  float acc[NB][VPW][CPT];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < VPW; ++j)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[b][j][c] = 0.f;

  const int col = col0 + lane * CPT;
#pragma unroll
  for (int rr = 0; rr < kRowsPerGemvWarp; ++rr) {
    const int r = warp * kRowsPerGemvWarp + rr;
    int32_t w[CPT];
    load_words<CPT>(mat.pw + (size_t)(row0 + r) * n + col, w);
    float xv[NB][VPW];
#pragma unroll
    for (int b = 0; b < NB; ++b) load_x<VPW>(&sx[r][b][0], xv[b]);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int j = 0; j < VPW; ++j) {
        const float wf = word_val<VPW>(w[c], j);
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b][j][c] = fmaf(xv[b][j], wf, acc[b][j][c]);
      }
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    float sj[VPW];  // int8: the one scale s (row 0) for every slab
#pragma unroll
    for (int j = 0; j < VPW; ++j)
      sj[j] = bf(mat.sc[(kInt8 ? 0 : (size_t)(j * n_grp_slab + mgrp) * n) + col + c]);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < VPW; ++j) p += acc[b][j][c] * sj[j];
      sred[warp][b][lane * CPT + c] = p;
    }
  }
  __syncthreads();

  for (int i = tid; i < NB * kCols; i += kGemvThreads) {
    const int b = i / kCols;
    const int cc = i % kCols;
    if (b >= b_rows) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) v += sred[w][b][cc];
    if constexpr (kInt8) {
      if (first) v += sxs[b][0] * bf(mat.sc[(size_t)gp * n + col0 + cc]);
    } else if (first) {
#pragma unroll
      for (int j = 0; j < VPW; ++j)
        v += sxs[b][j] * bf(mat.sc[(size_t)(gp + j * n_grp_slab + mgrp) * n + col0 + cc]);
    }
    part[((size_t)(blockIdx.z * n_chunks + chunk) * b_rows + b) * n + col0 + cc] = v;
  }
}

struct Epilogue {
  int kind;
  float* out_f32;            // kEpiF32: (b_rows, n)
  __nv_bfloat16* out_bf16;   // kEpiSwiglu: (b_rows, n)
  const float* scale0;       // nullptr, or (n,) f32 column scales of the (first) product
  const float* scale1;       // kEpiSwiglu: nullptr, or those of the second
};

// Sums the partials of every chunk in order and applies the epilogue.
__global__ void __launch_bounds__(kReduceThreads)
gemv_reduce(const float* __restrict__ part, int n_chunks, int b_rows, int n, Epilogue e) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= b_rows * n) return;
  const size_t stride = (size_t)b_rows * n;
  float y = 0.f;
  for (int c = 0; c < n_chunks; ++c) y += part[c * stride + i];
  if (e.scale0 != nullptr) y *= e.scale0[i % n];
  switch (e.kind) {
    case kEpiF32:
      e.out_f32[i] = y;
      break;
    case kEpiSwiglu: {
      float y3 = 0.f;
      for (int c = 0; c < n_chunks; ++c) y3 += part[(n_chunks + c) * stride + i];
      if (e.scale1 != nullptr) y3 *= e.scale1[i % n];
      e.out_bf16[i] = __float2bfloat16_rn(y / (1.f + expf(-y)) * y3);
      break;
    }
  }
}

// One product x (b_rows, K) bf16 @ packed (K, N), or two of the same shape
// (n_mats 2: w1 and w3 for the SwiGLU epilogue): the partial kernel over
// K/VPW/32 chunks, then the fixed-order reduce with epilogue e. part holds
// n_mats * K/VPW/32 * b_rows * N f32. Returns the launches' cudaError_t.
template <int NB, int CPT, int VPW>
cudaError_t launch_gemv(const __nv_bfloat16* x, int b_rows, int k, int n, int gp, GemvMat m0,
                        GemvMat m1, int n_mats, float* part, const Epilogue& e, cudaStream_t s) {
  const int kw = k / VPW;
  const int n_chunks = kw / kChunkRows;
  gemv_partial<NB, CPT, VPW><<<dim3(n / (32 * CPT), n_chunks, n_mats), kGemvThreads, 0, s>>>(
      x, b_rows, kw, n, gp, m0, m1, part);
  MV_CHECK(cudaGetLastError());
  const int total = b_rows * n;
  gemv_reduce<<<(total + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part, n_chunks, b_rows, n, e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- plain int8

constexpr int kChunk8 = 64;  // K rows per gemv8_partial block
constexpr int kRowsPerGemvWarp8 = kChunk8 / kGemvWarps;

template <int CPL>
__device__ __forceinline__ void load_bytes(const int8_t* p, uint32_t (&w)[CPL / 4]) {
  static_assert(CPL == 16 || CPL == 8, "a lane reads 16 or 8 columns");
  if constexpr (CPL == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
}

// Partial products of x (b_rows, K) bf16 with the plain int8 (K, N) matrix
// of blockIdx.z (w0 or w1) over rows [chunk * 64, +64), rows past K taken as
// zero: part[z][chunk][b][n] in f32, unscaled. N % 16 == 0, so a lane's
// columns are all in or all out.
template <int NB, int CPL>
__global__ void __launch_bounds__(kGemvThreads)
gemv8_partial(const __nv_bfloat16* __restrict__ x, int b_rows, int k, int n,
              const int8_t* __restrict__ w0, const int8_t* __restrict__ w1, float* __restrict__ part) {
  constexpr int kCols = 32 * CPL;
  const int8_t* w = blockIdx.z == 0 ? w0 : w1;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = chunk * kChunk8;

  __shared__ float sx[kChunk8][NB];
  // [warp][b][c][lane], padded so that the reduce below reads a lane's CPL
  // columns without bank conflicts
  __shared__ float sred[kGemvWarps][NB][CPL][33];

  for (int i = tid; i < kChunk8 * NB; i += kGemvThreads) {
    const int r = i / NB;
    const int b = i % NB;
    sx[r][b] = b < b_rows && row0 + r < k ? bf(x[(size_t)b * k + row0 + r]) : 0.f;
  }
  __syncthreads();

  float acc[NB][CPL];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[b][c] = 0.f;

  const int col = col0 + lane * CPL;
  if (col < n) {
#pragma unroll 4
    for (int rr = 0; rr < kRowsPerGemvWarp8; ++rr) {
      const int r = warp * kRowsPerGemvWarp8 + rr;
      if (row0 + r >= k) break;
      uint32_t wv[CPL / 4];
      load_bytes<CPL>(w + (size_t)(row0 + r) * n + col, wv);
      float xv[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) xv[b] = sx[r][b];
#pragma unroll
      for (int q = 0; q < CPL / 4; ++q) {
        const uint32_t flipped = wv[q] ^ 0x80808080u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wf = sbyte_float(flipped, j);
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[b][4 * q + j] = fmaf(xv[b], wf, acc[b][4 * q + j]);
        }
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
    part[((size_t)(blockIdx.z * n_chunks + chunk) * b_rows + b) * n + col0 + cc] = v;
  }
}

// One product x (b_rows, K) bf16 @ plain int8 (K, N), or two of the same
// shape (n_mats 2: w1 and w3 for the SwiGLU epilogue), the column scales in
// e: gemv8_partial over ceil(K/64) chunks, then the fixed-order reduce.
// part holds n_mats * ceil(K/64) * b_rows * N f32. Returns the launches'
// cudaError_t.
template <int NB, int CPL>
cudaError_t launch_gemv8(const __nv_bfloat16* x, int b_rows, int k, int n, const int8_t* w0,
                         const int8_t* w1, int n_mats, float* part, const Epilogue& e,
                         cudaStream_t s) {
  const int n_chunks = (k + kChunk8 - 1) / kChunk8;
  gemv8_partial<NB, CPL><<<dim3((n + 32 * CPL - 1) / (32 * CPL), n_chunks, n_mats), kGemvThreads, 0, s>>>(
      x, b_rows, k, n, w0, w1, part);
  MV_CHECK(cudaGetLastError());
  const int total = b_rows * n;
  gemv_reduce<<<(total + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      part, n_chunks, b_rows, n, e);
  return cudaGetLastError();
}

// Layer `layer` of a matrix stacked over layers: pw (L, K/VPW, N), sc (L, 2*gp, N).
template <int VPW>
GemvMat layer_mat(const GemvMat& m, int layer, int k, int n, int gp) {
  return GemvMat{m.pw + (size_t)layer * (k / VPW) * n, m.sc + (size_t)layer * 2 * gp * n};
}

}  // namespace
