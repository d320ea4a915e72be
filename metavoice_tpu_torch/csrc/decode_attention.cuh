// T=1 split-sequence (flash-decoding) attention device code of the int32-word
// decode stack (decode_stack_int4.cu, K3 and K7, whose chain of launches
// takes the kChained forms), now its only user: K1, K4 and the attention
// blocks K5 and K9 take the one-launch design (decode_attention_onepass.cuh),
// so the int8 and packed cache formats below (K5's until then) have no
// caller. decode_stack_gemv.cuh includes it for kFull and, through it,
// device_common.cuh's helpers (pdl_wait, bf, round_bf16, MV_CHECK).
//
// For one query token per (batch, head) row: the softmax-weighted sum of the
// values over the row's window [starts[b], pos] of the sequence-major
// (L, S, B, H_kv, Dh) cache. Query row r = b * n_head + h reads kv row
// r / group (group = n_head / H_kv query heads share a kv head: GQA).
//
//   * Only the valid window is read: slots beyond pos (which may hold
//     garbage, even NaN) and below the row's start are never loaded.
//     Skipping them is exact, since masked slots get weight exactly 0.
//   * The sequence is split across blocks: grid (rows, splits), so a step
//     with few rows still spreads over the SMs. Each block keeps its own
//     online-softmax state in f32 and writes a partial (max, sum, acc); a
//     second small kernel merges the splits. A split wholly past pos writes
//     an empty partial (max -1e30, sum 0), which the merge weighs by 0.
//   * Eight lanes share one cache row: each lane loads Dh/8 contiguous
//     elements with 16-byte loads, so a warp reads four positions at once,
//     coalesced, and reduces a dot product with three shuffles.
//   * f32 arithmetic: q * (1/sqrt(Dh)) in f32, f32 scores and accumulators;
//     the output is rounded once to its type.
//   * The cache format is a template argument (CacheFmt). A float cache (K1,
//     K3, K5 on a bf16 cache) is read as above. An int8 cache (kFmtI8:
//     int8 values, one f32 scale per (slot, kv row) in a (L, S, 1, W)
//     table) or a packed one (kFmtPacked: int32 words holding slots
//     4w..4w+3 in bytes 0..3, scales residue-split (L, 4, S/4, 1, W)) is
//     read as the TPU kernel's kv8_mode="bf16": q rounded to bf16 against the
//     integer values (exact), the dot in f32 times the k scale, and each
//     value weight rounded to bf16 as bf16(p * v_scale). A packed warp starts
//     at a multiple of 4 slots, so its four position groups share each word.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_common.cuh"

// An unnamed namespace: each including file gets its own copy of the kernels.
namespace {

constexpr int kGroup = 8;                  // lanes that share one cache row
constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 32 / kGroup;  // positions one warp reads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegBig = -1e30f;          // the reference's finite -inf

enum CacheFmt { kFmtFloat = 0, kFmtI8 = 1, kFmtPacked = 2 };

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[E]) {
  static_assert(E % 8 == 0, "bf16 rows are read 8 elements (16 bytes) at a time");
#pragma unroll
  for (int i = 0; i < E; i += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[i + 2 * j] = f.x;
      out[i + 2 * j + 1] = f.y;
    }
  }
}

template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&out)[E]) {
  static_assert(E % 4 == 0, "f32 rows are read 4 elements (16 bytes) at a time");
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 raw = *reinterpret_cast<const float4*>(p + i);
    out[i] = raw.x;
    out[i + 1] = raw.y;
    out[i + 2] = raw.z;
    out[i + 3] = raw.w;
  }
}

// E int8 values (16 bytes) as floats.
template <int E>
__device__ __forceinline__ void load_row(const int8_t* p, float (&out)[E]) {
  static_assert(E == 16, "int8 rows are read 16 values (16 bytes) at a time");
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * i + j] = (float)(int8_t)(w[i] >> (8 * j));
}

// Byte `j` of E packed int32 words (4 x 16 bytes) as floats.
template <int E>
__device__ __forceinline__ void load_packed_row(const int32_t* p, int j, float (&out)[E]) {
  static_assert(E % 4 == 0, "packed rows are read 4 words (16 bytes) at a time");
  const int sh = 8 * j;
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const int4 raw = *reinterpret_cast<const int4*>(p + i);
    out[i] = (float)(int8_t)(raw.x >> sh);
    out[i + 1] = (float)(int8_t)(raw.y >> sh);
    out[i + 2] = (float)(int8_t)(raw.z >> sh);
    out[i + 3] = (float)(int8_t)(raw.w >> sh);
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Arguments of one attention step. Query row r is read at
// q + (r / n_head) * q_bstride + (r % n_head) * DH.
template <typename TQ, typename T>
struct SplitArgs {
  const TQ* q;
  int q_bstride;
  // The step's new K/V rows, (B * H_kv, DH): the block whose split holds pos
  // writes them into the cache and every read of slot pos takes them instead
  // (blocks run in no order). nullptr: slot pos was written before the launch.
  const T* k_new;
  const T* v_new;
  T* k_cache;
  T* v_cache;
  const int* starts;  // nullptr or (B,) first valid slot per batch row
  int n_head;
  int group;          // query heads per kv head
  int bkv;            // B * H_kv: kv rows per cache slot
  int seq_len;        // S, the cache capacity
  int layer;
  const int* pos_dev;  // nullptr: use pos
  int pos;
  int split_len;
  float scale;
  float* part_ml;   // (rows, splits, 2): max, sum of exp
  float* part_acc;  // (rows, splits, DH): sum of exp-weighted values
  // int8 formats only: the scale tables, W (scale_width) columns a slot
  const float* k_scale;
  const float* v_scale;
  int scale_width;
};

// One block per (query row, split). FMT: the cache format (CacheFmt); T is
// the float type, int8_t or int32_t (words) to match. kChained: launched as a
// programmatic dependent of the kernel that writes q (the decode stack's
// chain), so it waits for that kernel before reading anything.
template <typename TQ, typename T, int DH, int FMT = kFmtFloat, bool kChained = false>
__global__ void __launch_bounds__(kThreads) decode_attn_split(SplitArgs<TQ, T> a) {
  if constexpr (kChained) {
    pdl_wait();
    pdl_trigger();
  }
  constexpr int E = DH / kGroup;
  constexpr bool kQuant = FMT != kFmtFloat;
  constexpr bool kPacked = FMT == kFmtPacked;
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kGroup;
  const int d0 = (lane % kGroup) * E;
  const int pos = a.pos_dev == nullptr ? a.pos : *a.pos_dev;
  const int kv_row = row / a.group;
  const size_t part = (size_t)row * n_splits + split;

  // elements from slot s to s + 1 (packed: from word row w to w + 1)
  const size_t pos_stride = (size_t)a.bkv * DH;
  const size_t base = (size_t)a.layer * (kPacked ? a.seq_len / 4 : a.seq_len) * pos_stride +
                      (size_t)kv_row * DH;
  const T* kn = a.k_new == nullptr ? nullptr : a.k_new + (size_t)kv_row * DH;
  const T* vn = a.v_new == nullptr ? nullptr : a.v_new + (size_t)kv_row * DH;

  if (kn != nullptr && split == pos / a.split_len && threadIdx.x < DH) {
    a.k_cache[base + (size_t)pos * pos_stride + threadIdx.x] = kn[threadIdx.x];
    a.v_cache[base + (size_t)pos * pos_stride + threadIdx.x] = vn[threadIdx.x];
  }

  const int lo = a.starts == nullptr ? 0 : min(max(a.starts[row / a.n_head], 0), pos);
  const int s_begin = max(split * a.split_len, lo);
  const int s_end = min((split + 1) * a.split_len, pos + 1);
  if (s_begin >= s_end) {  // nothing of the window in this split
    if (threadIdx.x < DH) a.part_acc[part * DH + threadIdx.x] = 0.f;
    if (threadIdx.x == 0) {
      a.part_ml[2 * part] = kNegBig;
      a.part_ml[2 * part + 1] = 0.f;
    }
    return;
  }

  float qf[E];
  load_row<E>(a.q + (size_t)(row / a.n_head) * a.q_bstride + (size_t)(row % a.n_head) * DH + d0, qf);
#pragma unroll
  for (int i = 0; i < E; ++i) qf[i] = kQuant ? round_bf16(qf[i] * a.scale) : qf[i] * a.scale;

  float m = kNegBig;
  float l = 0.f;
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  // `base_s` is the same for the whole warp, so every lane takes part in the
  // shuffles; lanes whose position falls past the split only skip the update.
  const int s_first = kPacked ? s_begin & ~3 : s_begin;
  for (int base_s = s_first + warp * kRowsPerWarp; base_s < s_end;
       base_s += kWarps * kRowsPerWarp) {
    const int s = base_s + grp;
    const bool valid = s >= s_begin && s < s_end;
    float kf[E];
    float vf[E];
    float dot = 0.f;
    float vs = 1.f;
    if (valid) {
      if constexpr (kPacked) {
        const size_t off = base + (size_t)(s >> 2) * pos_stride + d0;
        load_packed_row<E>(reinterpret_cast<const int32_t*>(a.k_cache) + off, s & 3, kf);
        load_packed_row<E>(reinterpret_cast<const int32_t*>(a.v_cache) + off, s & 3, vf);
      } else {
        const bool fresh = kn != nullptr && s == pos;
        const T* kp = fresh ? kn + d0 : a.k_cache + base + (size_t)s * pos_stride + d0;
        const T* vp = fresh ? vn + d0 : a.v_cache + base + (size_t)s * pos_stride + d0;
        load_row<E>(kp, kf);
        load_row<E>(vp, vf);
      }
#pragma unroll
      for (int i = 0; i < E; ++i) dot += qf[i] * kf[i];
    }
    dot += __shfl_xor_sync(kFull, dot, 4);
    dot += __shfl_xor_sync(kFull, dot, 2);
    dot += __shfl_xor_sync(kFull, dot, 1);
    if (valid) {
      if constexpr (kQuant) {
        const size_t srow = kPacked ? ((size_t)(a.layer * 4 + (s & 3)) * (a.seq_len / 4) + (s >> 2))
                                    : (size_t)a.layer * a.seq_len + s;
        dot *= a.k_scale[srow * a.scale_width + kv_row];
        vs = a.v_scale[srow * a.scale_width + kv_row];
      }
      const float m_new = fmaxf(m, dot);
      const float alpha = expf(m - m_new);
      const float p = expf(dot - m_new);
      l = l * alpha + p;
      const float pv = kQuant ? round_bf16(p * vs) : p;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = acc[i] * alpha + pv * vf[i];
      m = m_new;
    }
  }

  // Merge the warp's four position groups (lanes that differ in bits 3, 4).
#pragma unroll
  for (int off = kGroup; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(kFull, m, off);
    const float l_o = __shfl_xor_sync(kFull, l, off);
    const float m_new = fmaxf(m, m_o);
    const float ca = expf(m - m_new);
    const float cb = expf(m_o - m_new);
    l = l * ca + l_o * cb;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float acc_o = __shfl_xor_sync(kFull, acc[i], off);
      acc[i] = acc[i] * ca + acc_o * cb;
    }
    m = m_new;
  }

  __shared__ float s_acc[kWarps][DH];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < E; ++i) s_acc[warp][d0 + i] = acc[i];
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();

  if (threadIdx.x < DH) {
    const int d = threadIdx.x;
    float mm = s_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, s_m[w]);
    float ll = 0.f;
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w] - mm);
      ll += s_l[w] * c;
      aa += s_acc[w][d] * c;
    }
    a.part_acc[part * DH + d] = aa;
    if (d == 0) {
      a.part_ml[2 * part] = mm;
      a.part_ml[2 * part + 1] = ll;
    }
  }
}

// One block of DH threads per query row: merge the splits, y[row * DH + d].
// kChained as for decode_attn_split.
template <typename TY, int DH, bool kChained = false>
__global__ void __launch_bounds__(DH)
decode_attn_combine(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    int n_splits, TY* __restrict__ y) {
  if constexpr (kChained) {
    pdl_wait();
    pdl_trigger();
  }
  const int row = blockIdx.x;
  const int d = threadIdx.x;
  const size_t first = (size_t)row * n_splits;
  float mm = kNegBig;
  for (int sp = 0; sp < n_splits; ++sp) mm = fmaxf(mm, part_ml[2 * (first + sp)]);
  float ll = 0.f;
  float aa = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) {
    const float c = expf(part_ml[2 * (first + sp)] - mm);
    ll += part_ml[2 * (first + sp) + 1] * c;
    aa += part_acc[(first + sp) * DH + d] * c;
  }
  store(y + (size_t)row * DH + d, aa / fmaxf(ll, 1e-30f));
}

}  // namespace
