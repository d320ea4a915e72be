// T-query decode attention for one layer (the speculative verify, and GQA
// decode at T = 1), written for Hopper (sm_90a).
//
// Replaces metavoice_tpu/ops/attention.py:decode_attention_multi (the Pallas
// TPU kernel _decode_attn_multi_kernel). For T <= 16 new tokens at cache
// positions [pos, pos + T) it writes their K/V rows into the sequence-major
// (L, S, B, H_kv, Dh) cache in place, and query t of batch row b attends the
// window [starts[b], pos + t] with an f32 online softmax scaled by
// 1/sqrt(Dh). Head h reads kv head h / g (g = H / H_kv query heads share a
// kv head: GQA), as jnp.repeat / repeat_interleave of the kv heads does.
//
// What bounds it: cache bytes. A call reads the window's K and V once,
// 2 * (pos + T - start) * B * H_kv * Dh elements, and does 4 * T * g
// operations per element read, far below the card's ~295 operations per
// byte at T * g <= 16; the kernel is bound by streaming the window out of
// device memory, and at short windows by latency.
//
// Design, following that bound:
//   * The cache read is shared by every query of a kv row: a block takes one
//     kv row, one split of the sequence and up to 16 of its T * g queries;
//     it stages 32 positions of K and V at a time in shared memory (f32) and
//     scores them against each of its queries (lane = position), so a tile
//     is read from device memory once for all of them. More than 16 queries
//     of one kv row (T * g > 16) go to further blocks that read the same
//     tiles again, mostly from L2.
//   * The sequence is split across blocks as in K1 (grid (B * H_kv, splits,
//     query groups)), each split keeps its own online-softmax state and
//     writes a partial (max, sum, acc) per query; K1's combine kernel
//     (decode_attention.cuh) merges the splits of each query.
//   * Visibility of the new rows: blocks run in no order, so no block may
//     read a slot of [pos, pos + T) from the cache. Every tile load takes
//     those rows from k_new/v_new instead, and the split that holds a new
//     row writes it into the cache (the rows may straddle two splits: each
//     writes its own). The caches come out bit-identical to the plain
//     version's.
//   * Only the window is read: slots past pos + T - 1 (which may hold
//     garbage, even NaN) and below the row's start are never loaded, tile
//     rows past the split are zeros, and a query's slots past pos + t get
//     weight exactly 0. A start past pos is taken as pos.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper and its plain PyTorch
// version are in metavoice_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"

namespace {

constexpr int kTile = 32;  // cache positions staged at once: one per lane when scoring
constexpr int kMultiWarps = 4;
constexpr int kMultiThreads = kMultiWarps * 32;
constexpr int kMaxT = 16;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
struct MultiArgs {
  const T* q;      // (B, H, T, DH)
  const T* k_new;  // (B, H_kv, T, DH)
  const T* v_new;
  T* k_cache;  // (L, S, B, H_kv, DH)
  T* v_cache;
  const int* starts;  // nullptr or (B,) first valid slot per batch row
  int n_head;
  int n_kv_head;
  int group;  // query heads per kv head
  int t_q;    // T
  int n_q;    // T * group: the queries of one kv row
  int bkv;    // B * H_kv: kv rows per cache slot
  int seq_len;
  int layer;
  int pos;
  int split_len;
  float scale;
  float* part_ml;   // (B * H * T, splits, 2): max, sum of exp
  float* part_acc;  // (B * H * T, splits, DH): sum of exp-weighted values
};

// One block per (kv row, split, group of 4 * QPW queries). Query j of a kv
// row is (t = j / group, i = j % group), head hkv * group + i; warp w takes
// the block's queries jj * 4 + w.
template <typename T, int DH, int QPW>
__global__ void __launch_bounds__(kMultiThreads) decode_attn_multi_split(MultiArgs<T> a) {
  constexpr int QB = kMultiWarps * QPW;  // queries a block
  constexpr int KS = DH + 4;             // padded K row: lanes' float4 reads hit distinct banks
  constexpr int E = DH / 32;             // value dims a lane sums
  constexpr int V = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int CPR = DH / V;            // 16-byte loads per row
  static_assert(E == 2 || E == 4, "head_dim 64 or 128");
  __shared__ __align__(16) float k_s[kTile * KS];
  __shared__ __align__(16) float v_s[kTile * DH];
  __shared__ __align__(16) float q_s[QB * DH];

  const int r = blockIdx.x;  // kv row b * H_kv + hkv
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int q0 = blockIdx.z * QB;
  const int b = r / a.n_kv_head;
  const int hkv = r % a.n_kv_head;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos = a.pos;
  const size_t pos_stride = (size_t)a.bkv * DH;  // elements from slot s to s + 1
  const size_t base = (size_t)a.layer * a.seq_len * pos_stride + (size_t)r * DH;
  const T* kn = a.k_new + (size_t)r * a.t_q * DH;
  const T* vn = a.v_new + (size_t)r * a.t_q * DH;
  const int sp_lo = split * a.split_len;
  const int sp_hi = sp_lo + a.split_len;

  // 1) the split that holds a new row writes it (once: the first query group)
  if (blockIdx.z == 0) {
    const int w_lo = max(sp_lo, pos);
    const int w_hi = min(sp_hi, pos + a.t_q);
    for (int i = threadIdx.x; i < (w_hi - w_lo) * DH; i += kMultiThreads) {
      const int s = w_lo + i / DH;
      const int d = i % DH;
      a.k_cache[base + (size_t)s * pos_stride + d] = kn[(size_t)(s - pos) * DH + d];
      a.v_cache[base + (size_t)s * pos_stride + d] = vn[(size_t)(s - pos) * DH + d];
    }
  }

  // the block's queries: their rows of (B, H, T) and causal bounds
  int qrow[QPW];
  int bound[QPW];
  bool live[QPW];
#pragma unroll
  for (int jj = 0; jj < QPW; ++jj) {
    const int j = q0 + jj * kMultiWarps + warp;
    const int t = j / a.group;
    const int i = j % a.group;
    live[jj] = j < a.n_q;
    qrow[jj] = (b * a.n_head + hkv * a.group + i) * a.t_q + t;
    bound[jj] = pos + t;
  }

  const int lo = a.starts == nullptr ? 0 : min(max(a.starts[b], 0), pos);
  const int s_begin = max(sp_lo, lo);
  const int s_end = min(sp_hi, pos + a.t_q);
  if (s_begin >= s_end) {  // nothing of the window in this split: empty partials
#pragma unroll
    for (int jj = 0; jj < QPW; ++jj) {
      if (!live[jj]) continue;
      const size_t part = (size_t)qrow[jj] * n_splits + split;
#pragma unroll
      for (int e = 0; e < E; ++e) a.part_acc[part * DH + lane * E + e] = 0.f;
      if (lane == 0) {
        a.part_ml[2 * part] = kNegBig;
        a.part_ml[2 * part + 1] = 0.f;
      }
    }
    return;
  }

  // q * (1/sqrt(Dh)) in f32; rows of absent queries are zeros
  for (int i = threadIdx.x; i < QB * DH; i += kMultiThreads) {
    const int j = q0 + i / DH;
    float v = 0.f;
    if (j < a.n_q) {
      const int row = (b * a.n_head + hkv * a.group + j % a.group) * a.t_q + j / a.group;
      v = to_float(a.q[(size_t)row * DH + i % DH]) * a.scale;
    }
    q_s[i] = v;
  }

  float m[QPW];
  float l[QPW];
  float acc[QPW][E];
#pragma unroll
  for (int jj = 0; jj < QPW; ++jj) {
    m[jj] = kNegBig;
    l[jj] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[jj][e] = 0.f;
  }

  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    __syncthreads();  // the last tile is consumed (and q_s is written)
    for (int c = threadIdx.x; c < kTile * CPR; c += kMultiThreads) {
      const int p = c / CPR;
      const int d0 = (c % CPR) * V;
      const int s = t0 + p;
      float kf[V];
      float vf[V];
      if (s < s_end) {
        const bool fresh = s >= pos;  // a new row: from k_new/v_new, never the cache
        load_row<V>(fresh ? kn + (size_t)(s - pos) * DH + d0
                          : a.k_cache + base + (size_t)s * pos_stride + d0, kf);
        load_row<V>(fresh ? vn + (size_t)(s - pos) * DH + d0
                          : a.v_cache + base + (size_t)s * pos_stride + d0, vf);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        *reinterpret_cast<float4*>(&k_s[p * KS + d0 + e]) = make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(&v_s[p * DH + d0 + e]) = make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    __syncthreads();

    // scores: lane p against each of the warp's queries, K read once for all
    const int s = t0 + lane;
    float dot[QPW];
#pragma unroll
    for (int jj = 0; jj < QPW; ++jj) dot[jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(&k_s[lane * KS + d]);
#pragma unroll
      for (int jj = 0; jj < QPW; ++jj) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[(jj * kMultiWarps + warp) * DH + d]);
        dot[jj] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

#pragma unroll
    for (int jj = 0; jj < QPW; ++jj) {
      if (!live[jj]) continue;  // the same for the whole warp
      const bool valid = s < s_end && s <= bound[jj];
      const float sc = valid ? dot[jj] : kNegBig;
      const float m_tile = warp_max(sc);
      if (m_tile == kNegBig) continue;  // no slot of this tile is in the query's window
      const float m_new = fmaxf(m[jj], m_tile);
      const float alpha = expf(m[jj] - m_new);
      const float pr = valid ? expf(sc - m_new) : 0.f;
      l[jj] = l[jj] * alpha + warp_sum(pr);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[jj][e] *= alpha;
#pragma unroll 8
      for (int pp = 0; pp < kTile; ++pp) {
        const float w = __shfl_sync(kFull, pr, pp);
        const float* vp = &v_s[pp * DH + lane * E];
        if constexpr (E == 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vp);
          acc[jj][0] += w * vv.x;
          acc[jj][1] += w * vv.y;
          acc[jj][2] += w * vv.z;
          acc[jj][3] += w * vv.w;
        } else {
          const float2 vv = *reinterpret_cast<const float2*>(vp);
          acc[jj][0] += w * vv.x;
          acc[jj][1] += w * vv.y;
        }
      }
      m[jj] = m_new;
    }
  }

#pragma unroll
  for (int jj = 0; jj < QPW; ++jj) {
    if (!live[jj]) continue;
    const size_t part = (size_t)qrow[jj] * n_splits + split;
#pragma unroll
    for (int e = 0; e < E; ++e) a.part_acc[part * DH + lane * E + e] = acc[jj][e];
    if (lane == 0) {
      a.part_ml[2 * part] = m[jj];
      a.part_ml[2 * part + 1] = l[jj];
    }
  }
}

template <typename T, int DH, int QPW>
cudaError_t launch_qpw(const MultiArgs<T>& a, int n_splits, int rows, void* y, cudaStream_t stream) {
  const int n_groups = (a.n_q + kMultiWarps * QPW - 1) / (kMultiWarps * QPW);
  decode_attn_multi_split<T, DH, QPW><<<dim3(a.bkv, n_splits, n_groups), kMultiThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<T, DH><<<rows, DH, 0, stream>>>(a.part_ml, a.part_acc, n_splits, static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
                   void* v_cache, const int* starts, int batch, int n_head, int n_kv_head,
                   int t_q, int seq_len, int layer, int pos, int split_len, int n_splits,
                   float* part_ml, float* part_acc, void* y, cudaStream_t stream) {
  MultiArgs<T> a;
  a.q = static_cast<const T*>(q);
  a.k_new = static_cast<const T*>(k_new);
  a.v_new = static_cast<const T*>(v_new);
  a.k_cache = static_cast<T*>(k_cache);
  a.v_cache = static_cast<T*>(v_cache);
  a.starts = starts;
  a.n_head = n_head;
  a.n_kv_head = n_kv_head;
  a.group = n_head / n_kv_head;
  a.t_q = t_q;
  a.n_q = t_q * a.group;
  a.bkv = batch * n_kv_head;
  a.seq_len = seq_len;
  a.layer = layer;
  a.pos = pos;
  a.split_len = split_len;
  a.scale = (float)(1.0 / sqrt((double)DH));
  a.part_ml = part_ml;
  a.part_acc = part_acc;
  const int rows = batch * n_head * t_q;
  if (a.n_q <= kMultiWarps) return launch_qpw<T, DH, 1>(a, n_splits, rows, y, stream);
  if (a.n_q <= 2 * kMultiWarps) return launch_qpw<T, DH, 2>(a, n_splits, rows, y, stream);
  return launch_qpw<T, DH, 4>(a, n_splits, rows, y, stream);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, k_new, v_new, both caches and y share it).
// q, y: (batch, n_head, t_q, head_dim); k_new, v_new: (batch, n_kv_head, t_q,
// head_dim); caches (L, seq_len, batch, n_kv_head, head_dim); starts: NULL or
// (batch,) int32 on the device. part_ml: (batch*n_head*t_q*n_splits*2,) f32 and
// part_acc: (batch*n_head*t_q*n_splits*head_dim,) f32 scratch. Returns a cudaError_t.
extern "C" int mv_decode_attention_multi(int dtype, const void* q, const void* k_new,
                                         const void* v_new, void* k_cache, void* v_cache,
                                         const void* starts, int batch, int n_head,
                                         int n_kv_head, int t_q, int head_dim, int seq_len,
                                         int layer, int pos, int split_len, int n_splits,
                                         void* part_ml, void* part_acc, void* y, void* stream) {
  const int* st = static_cast<const int*>(starts);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_q < 1 || t_q > kMaxT || n_kv_head < 1 || n_head % n_kv_head != 0 || pos < 0 ||
      pos + t_q > seq_len || split_len < 1 || n_splits < 1 ||
      (long long)split_len * n_splits < (long long)pos + t_q)
    return (int)cudaErrorInvalidValue;
#define MV_ARGS q, k_new, v_new, k_cache, v_cache, st, batch, n_head, n_kv_head, t_q, seq_len, \
                layer, pos, split_len, n_splits, ml, acc, y, s
  if (dtype == 0 && head_dim == 128) return (int)launch<__nv_bfloat16, 128>(MV_ARGS);
  if (dtype == 0 && head_dim == 64) return (int)launch<__nv_bfloat16, 64>(MV_ARGS);
  if (dtype == 1 && head_dim == 128) return (int)launch<float, 128>(MV_ARGS);
  if (dtype == 1 && head_dim == 64) return (int)launch<float, 64>(MV_ARGS);
#undef MV_ARGS
  return (int)cudaErrorInvalidValue;
}
