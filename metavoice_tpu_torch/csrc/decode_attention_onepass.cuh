// Decode attention over the sequence-major (L, S, B, H_kv, Dh) cache in ONE
// launch: the device code of K1 (decode_attention.cu, one query a kv row),
// K4 (decode_attention_multi.cu, up to 16 queries a kv row: T new tokens
// times g = H / H_kv query heads) and the attention of the per-layer
// attention blocks K5 (decode_block_int4.cu: a bf16, int8 or packed cache)
// and K9 (decode_block_int8.cu: bf16). Only those four files include it.
//
// For T new tokens at cache slots [pos, pos + T) it writes their K/V rows
// into the cache in place, and query t of batch row b attends the window
// [starts[b], pos + t] with an f32 online softmax of the scores scaled by
// 1/sqrt(Dh).
// Query head h reads kv head h / g. K1 is the case T = 1, g = 1.
//
// What bounds it: cache bytes. A call reads the window's K and V once,
// 2 * (pos + T - start) * B * H_kv * Dh elements, and does 4 * T * g
// operations an element, far below the card's ~295 operations a byte; at
// the decode windows of a synthesise (54-255 slots) it is latency.
//
// Design, following that bound (each choice measured on an H100, PERF.md):
//   * One launch a call. The grid is (kv rows, splits, query groups of up to
//     16). Each block keeps its own online-softmax state; with one split it
//     writes y itself, with more the last block of a (kv row, query group)
//     to finish merges the splits' partials from L2 (merge_splits: a ticket
//     taken with one acquire-release atomic, reset by that block). A
//     thread-block cluster merging through distributed shared memory was
//     tried first: on an H100 the cluster launch and its two cluster
//     barriers cost more than the ticket does (K4 T 8 at pos 2032, 8 splits:
//     0.0318 ms launched as clusters against 0.0209 without, before any
//     merge).
//   * Every warp on its own. A block's 8 warps deal its split's slots out in
//     warp tiles; each warp streams its tiles through its own ring of
//     shared-memory stages filled by 16-byte cp.async copies (rows past the
//     split zero-filled, never read from device memory), waits only for its
//     own copies and keeps its own softmax state, so no block barrier sits
//     on the streaming path. The warps merge once, at the end, in shared
//     memory. Tiles stay in the cache's type and widen in registers.
//   * The softmax runs once a warp tile, in the log2 domain (scores scaled
//     by log2(e) / sqrt(Dh), weights exp2(s - max)), in f32.
//   * K1 (one query a kv row): CUDA cores. Eight lanes share a slot, each 16
//     bytes of the row at a time, so a quarter warp reads 128 contiguous
//     bytes (no bank conflict).
//   * K4 in bf16 (2 to 16 queries a kv row): tensor cores, mma.sync
//     m16n8k16 with the block's 16 query rows as M; P enters P V as a bf16
//     high and low part (attn_mma_kernel).
//   * K4 in f32: CUDA cores, the block's warps sharing each tile
//     (attn_simt_kernel).
//   * Visibility of the new rows: blocks run in no order, so no block reads
//     a slot of [pos, pos + T) from the cache. Every tile copy takes those
//     rows from k_new/v_new, and the split that holds a new row writes it
//     (the first query group only). The caches come out bit-identical to
//     the plain version's.
//   * Only the window is read: slots past pos + T - 1 (which may hold
//     garbage, even NaN) and below the row's start are never loaded, and a
//     query's slots past pos + t get weight exactly 0. A start past pos is
//     taken as pos. A split with nothing of the window leaves an empty
//     partial (max -1e30, sum 0) that the merge weighs by 0.
//   * The attention blocks' variant (attn_row_kernel with NEW != kRowK1,
//     one query a block: GQA query head h of a block reads kv row h /
//     kv_group) is the second of three kernels chained by programmatic
//     dependent launch: its first ring stages of the cache window go out
//     before griddepcontrol.wait, then q (f32, from the qkv product's
//     output) and the new K/V row. The split that holds pos makes the new
//     row in the cache's format from the f32 values itself: bf16(row), or,
//     for the int8 and packed caches, the row quantized per (batch row, kv
//     head) (s = max(absmax, 1e-8) * f32(1/127), q = clip(rint(row / s),
//     -127, 127)); every query block of the kv row makes the same bits and
//     puts them into its own tile, and the first one writes the row (the
//     packed word read, merged and written by that one block) and its
//     scales. A split that ends at pos (the next one starts there) has a
//     last tile over pos too: its slot stays zero-filled, weight 0. The
//     int8 and packed formats follow the TPU kernel's kv8_mode="bf16": q
//     rounded to bf16 against the integer values (exact
//     in f32), the dot times the slot's k scale, each value weight rounded
//     to bf16 as bf16(p * v_scale); the tiles widen in registers by a byte
//     permute, the slots' scales copied beside them.
//
// The launch sets no state that a replay would find stale (the kernels'
// attributes are set once, before their first launch; the merge tickets are
// left at 0), synchronises nothing, and so is captured in a CUDA graph like
// any kernel. A call may read its first new slot from the device (pos_dev:
// K1, the attention blocks and K4's GQA decode at T = 1, K4's speculative
// verify at T = gamma): its plan then covers the window up to a.pos + T - 1,
// the bucket's last slot, a split wholly past pos + T - 1 leaving an empty
// partial and writing nothing, so one captured launch serves every slot of
// the bucket. The new rows [pos, pos + T) are found on the device too: each
// tile copy takes a slot at or past pos from k_new/v_new, and the splits
// that hold a part of the range write that part, wherever its boundaries
// fall. Calls that share a device's tickets run one after another on one
// stream, as the port's callers do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "device_common.cuh"

// An unnamed namespace: each including file gets its own copy of the kernels.
namespace {


constexpr int kCWarps = 8;  // warps a block of the K1 and bf16 K4 kernels
constexpr int kCThreads = kCWarps * 32;
constexpr int kCTile = 32;   // f32 K4 kernel: cache slots a tile, one per lane in the softmax
constexpr int kCStages = 3;  // f32 K4 kernel: tiles in its shared-memory ring
constexpr int kGWarps = 4;   // f32 K4 kernel: warps a block
constexpr int kGThreads = kGWarps * 32;
constexpr int kGGroups = kGThreads / 8;  // 8 lanes score one (query, slot) pair
constexpr int kCMaxQ = 16;        // queries a block
constexpr int kCMaxT = 16;        // new tokens a call
constexpr int kCMaxSplits = 32;   // splits of a kv row's window
constexpr unsigned kCFull = 0xffffffffu;
constexpr float kCNegBig = -1e30f;  // the reference's finite -inf

// The new row's source in attn_row_kernel: K1 takes q, k_new and v_new in
// the cache's type; the attention blocks take q and the new K/V row in f32
// from the qkv product's output and make the row in the cache's format.
enum RowNew { kRowK1 = 0, kRowBf16 = 1, kRowI8 = 2, kRowPacked = 3 };

// T: the cache's element (the packed cache: int32 words); TY: y's.
template <typename T, typename TY = T>
struct OnePassArgs {
  const T* q;      // (B, H, T, DH)
  const T* k_new;  // (B, H_kv, T, DH)
  const T* v_new;
  T* k_cache;  // (L, S, B, H_kv, DH); packed (L, S / 4, B, H_kv, DH)
  T* v_cache;
  TY* y;              // (B, H, T, DH)
  const int* starts;  // nullptr or (B,) first valid slot per batch row
  int n_head;
  int n_kv_head;
  int group;  // query heads per kv head
  int t_q;    // T
  int n_q;    // T * group: the queries of one kv row
  int bkv;    // B * H_kv: kv rows per cache slot
  int seq_len;
  int layer;
  int pos;              // the first new row's slot; with pos_dev, the last slot pos_dev may name
  const int* pos_dev;   // nullptr, or the first new row's slot, read on the device
  int split_len;
  float scale;  // log2(e) / sqrt(Dh): scores in the log2 domain, weights exp2(s - max)
  float* part;   // splits > 1: f32 partials of every (kv row, query group) and split (merge_splits)
  int* tickets;  // splits > 1: one zeroed counter per (kv row, query group)
  // The attention blocks only: one block a query head, so n_head and
  // n_kv_head hold H, group 1; the kv row of query head h is b * H_kv + h /
  // kv_group.
  const float* qkv;  // (B, q_bstride) f32: q (H * DH), the new K row (H_kv * DH), the new V row
  int q_bstride;
  int kv_group;
  float* k_scale;  // the int8 and packed caches' scale tables, scale_width columns a slot
  float* v_scale;
  int scale_width;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  // 16 bytes from gmem, or 16 zero bytes (src-size 0: nothing is read)
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(fill ? 16 : 0)
               : "memory");
}
// 4 bytes from gmem, or 4 zero bytes
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(fill ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements as floats (N * sizeof(T) bytes, aligned to that).
template <int N>
__device__ __forceinline__ void to_floats(const __nv_bfloat16* p, float* out) {
  static_assert(N == 2 || N == 4 || N == 8, "2, 4 or 8 bf16 values");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    w[0] = raw.x, w[1] = raw.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void to_floats(const float* p, float* out) {
  static_assert(N == 2 || N == 4, "2 or 4 f32 values");
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

__device__ __forceinline__ float cwarp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kCFull, v, off));
  return v;
}
__device__ __forceinline__ float cwarp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kCFull, v, off);
  return v;
}

template <typename T, int DH>
__host__ __device__ constexpr size_t simt_smem_bytes() {
  return 2u * kCStages * kCTile * DH * sizeof(T);  // the K and V rings
}

// (B, H, T) row of query j of kv row (b, hkv): t = j / g, head hkv * g + j % g.
template <typename Args>
__device__ __forceinline__ int query_row(const Args& a, int b, int hkv, int j) {
  return (b * a.n_head + hkv * a.group + j % a.group) * a.t_q + j / a.group;
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// The split that holds new rows of [pos, pos + T) writes them into the cache
// (called once the block's first copies are in flight). Every 16-byte chunk
// is loaded before any is stored, so the loads overlap.
template <typename T, int DH, int THREADS>
__device__ __forceinline__ void write_new_rows(const OnePassArgs<T>& a, int pos, size_t base, size_t pos_stride,
                                               const T* kn, const T* vn, int sp_lo, int sp_hi) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER = (kCMaxT * DH / V + THREADS - 1) / THREADS;  // chunks a thread at most
  const int w_lo = max(sp_lo, pos);
  const int n = max(min(sp_hi, pos + a.t_q) - w_lo, 0) * DH / V;  // chunks to write
  uint4 kv[PER], vv[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < n) {
      kv[k] = reinterpret_cast<const uint4*>(kn + (size_t)(w_lo - pos) * DH)[c];
      vv[k] = reinterpret_cast<const uint4*>(vn + (size_t)(w_lo - pos) * DH)[c];
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < n) {
      const size_t o = base + (size_t)(w_lo + c * V / DH) * pos_stride + c * V % DH;
      *reinterpret_cast<uint4*>(a.k_cache + o) = kv[k];
      *reinterpret_cast<uint4*>(a.v_cache + o) = vv[k];
    }
  }
}

// The merge of the splits, in the same launch. Every block holds its partial
// of its QB queries in shared memory (part_m, part_l: (QB,), part_acc: (QB,
// DH), 16-byte aligned). With one split it writes y at once. Otherwise it
// writes the partial to a.part (L2-resident scratch) and takes its (kv row,
// query group)'s ticket with one acquire-release atomic; the last block to
// arrive merges every split's partial, writes y and resets the ticket to 0
// for the next call (so a CUDA-graph replay finds it as the first launch
// did). The last block loads the splits' (max, sum, acc) eight splits at a
// time and folds them in with a running max, one round trip a chunk.
template <int DH, int QB, int THREADS = kCThreads, typename Args>
__device__ __forceinline__ void merge_splits(const Args& a, int b, int hkv, int q0,
                                             const float* part_m, const float* part_l,
                                             const float* part_acc) {
  constexpr int NI = (QB * DH / 4 + THREADS - 1) / THREADS;  // float4 outputs a thread
  constexpr int CH = 8;                                      // splits a round trip
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int n_splits = gridDim.y;
  const int live = min(QB, a.n_q - q0);
  auto write_y = [&](int i4, const float4& v) {  // outputs 4 * i4 .. 4 * i4 + 3
    const int j = 4 * i4 / DH;
    auto* y = a.y + (size_t)query_row(a, b, hkv, q0 + j) * DH + 4 * i4 % DH;
    store_out(y, v.x), store_out(y + 1, v.y), store_out(y + 2, v.z), store_out(y + 3, v.w);
  };
  if (n_splits == 1) {
    for (int i4 = tid; i4 < live * DH / 4; i4 += THREADS) {
      const float inv = 1.f / fmaxf(part_l[4 * i4 / DH], 1e-30f);
      const float4 v = reinterpret_cast<const float4*>(part_acc)[i4];
      write_y(i4, make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv));
    }
    return;
  }
  // a.part: every ticket's (split, QB, DH) sums, then every ticket's (split, QB, 2) (max, sum)
  const size_t ticket = (size_t)blockIdx.x * gridDim.z + blockIdx.z;
  float4* acc = reinterpret_cast<float4*>(a.part) + ticket * n_splits * QB * DH / 4;
  float* ml = a.part + (size_t)gridDim.x * gridDim.z * n_splits * QB * DH + ticket * n_splits * QB * 2;
  for (int i4 = tid; i4 < live * DH / 4; i4 += THREADS)
    acc[(size_t)blockIdx.y * QB * DH / 4 + i4] = reinterpret_cast<const float4*>(part_acc)[i4];
  if (tid < live) {
    ml[(blockIdx.y * QB + tid) * 2] = part_m[tid];
    ml[(blockIdx.y * QB + tid) * 2 + 1] = part_l[tid];
  }
  __syncthreads();  // the block's writes happen before thread 0's release
  if (tid == 0) last = atom_add_acq_rel(&a.tickets[ticket], 1) == n_splits - 1;
  __syncthreads();  // and thread 0's acquire before the last block's reads
  if (!last) return;
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int i4 = tid + k * THREADS;
    if (i4 >= live * DH / 4) break;
    const int j = 4 * i4 / DH;
    float mm = kCNegBig, ll = 0.f;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < n_splits; c0 += CH) {
      float m_c[CH], l_c[CH];
      float4 a_c[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (c0 + c < n_splits) {
          m_c[c] = __ldcg(&ml[((c0 + c) * QB + j) * 2]);
          l_c[c] = __ldcg(&ml[((c0 + c) * QB + j) * 2 + 1]);
          a_c[c] = __ldcg(&acc[(size_t)(c0 + c) * QB * DH / 4 + i4]);
        } else {
          m_c[c] = kCNegBig, l_c[c] = 0.f, a_c[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      float m_new = mm;
#pragma unroll
      for (int c = 0; c < CH; ++c) m_new = fmaxf(m_new, m_c[c]);
      const float r = exp2f(mm - m_new);
      ll *= r, y.x *= r, y.y *= r, y.z *= r, y.w *= r;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float w = exp2f(m_c[c] - m_new);  // a split with nothing of the window: m -1e30, sum 0
        ll += l_c[c] * w;
        y.x += a_c[c].x * w, y.y += a_c[c].y * w, y.z += a_c[c].z * w, y.w += a_c[c].w * w;
      }
      mm = m_new;
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    write_y(i4, make_float4(y.x * inv, y.y * inv, y.z * inv, y.w * inv));
  }
  if (tid == 0) a.tickets[ticket] = 0;
}

// ---- one query a kv row (K1) or a block (K5, K9): CUDA cores -------------
//
// A warp walks its own tiles of 8 slots (the block's split is dealt out to the
// block's warps tile by tile) through its own ring of kRStages shared-memory
// stages, so no barrier of the block is on its path: it waits for its own
// copies and syncs with itself. Eight lanes share a slot (each 16 bytes at a
// time, a quarter warp reading 128 contiguous bytes); a lane group takes
// slots g and g + 4 of the tile. The tile's max is warp-wide, so the warp
// has one running max: the softmax rescales once a tile, and each lane sums
// its Dh/8 value dims over its group's slots. At the end the groups add up
// by shuffles and the block's warps merge in shared memory.
//
// The attention blocks' variants (NEW != kRowK1, Dh 128): the int8 cache's
// tile is 8 slots of 128 bytes (a lane's 16 values one copy); the packed
// cache's is the 2 word rows of 8 slots that start on a multiple of 4, and
// lane group g takes slots 2 g and 2 g + 1, bytes of the same 16 words (one
// read and one sign flip of a word for both); each stage also holds its
// slots' k and v scales. The new row never comes from memory: its slot is zero-filled
// in the copy (the packed word row is copied, its byte at pos stale) and
// the warp whose tile holds pos writes the block's new row into the stage
// before reading it.
constexpr int kRTile = 8;    // slots a warp tile
constexpr int kRStages = 3;  // warp tiles in a warp's ring

template <typename T, int DH>
__host__ __device__ constexpr size_t row_smem_bytes() {
  return (size_t)kCWarps * kRStages * 2 * kRTile * DH * sizeof(T);  // each warp's K and V ring
}

// The attention blocks' dynamic shared memory: each warp's K and V ring (a
// packed tile is kRTile / 4 word rows), each stage's k and v scales, the new
// row's two scales (16 bytes) and the new K and V row in the cache's values
// (packed: int8).
template <int NEW, int DH>
__host__ __device__ constexpr size_t block_ring_bytes() {
  return NEW == kRowBf16 ? (size_t)kCWarps * kRStages * 2 * kRTile * DH * 2 : (size_t)kCWarps * kRStages * 2 * kRTile * DH;
}
template <int NEW, int DH>
__host__ __device__ constexpr size_t block_smem_bytes() {
  return block_ring_bytes<NEW, DH>() + (size_t)kCWarps * kRStages * 2 * kRTile * sizeof(float) + 16 +
         2 * DH * (NEW == kRowBf16 ? 2 : 1);
}

// 16 int8 values (one 16-byte chunk) as exact floats.
__device__ __forceinline__ void i8_floats(const int8_t* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = sbyte_float(w[i], j);
}

// Bytes j and j + 1 of 4 packed words (one 16-byte chunk) as exact floats.
__device__ __forceinline__ void packed_floats(const int32_t* p, int j, float* out0, float* out1) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out0[i] = sbyte_float(w[i], j);
    out1[i] = sbyte_float(w[i], j + 1);
  }
}

template <typename T, int DH, int NEW = kRowK1>
__global__ void __launch_bounds__(kCThreads)
attn_row_kernel(OnePassArgs<T, std::conditional_t<NEW == kRowK1, T, __nv_bfloat16>> a) {
  constexpr bool kBlock = NEW != kRowK1;
  constexpr bool kQuant = NEW == kRowI8 || NEW == kRowPacked;
  constexpr bool kPacked = NEW == kRowPacked;
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy (packed: words)
  constexpr int ROW_CH = DH / V;     // 16-byte chunks a row (packed: a word row)
  constexpr int EQ = DH / 8;         // elements a lane scores and sums
  constexpr int NCH = EQ / V;        // chunks a lane reads of a row
  constexpr int TR = kPacked ? kRTile / 4 : kRTile;  // cache rows a warp tile (packed: word rows)
  constexpr int WT = TR * DH;        // elements of a warp tile of K (or V)
  using NewT = std::conditional_t<kPacked, int8_t, T>;  // the new row's values
  static_assert(DH == 64 || DH == 128, "head_dim 64 or 128");
  static_assert(!kBlock || DH == 128, "the attention blocks take head_dim 128");
  static_assert(NCH >= 1 && (TR * ROW_CH) % 32 == 0, "whole chunks a lane");
  static_assert(!kBlock || kCThreads == 2 * DH, "a thread a value of the new K and V rows");

  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) float red[kCWarps][DH];  // each warp's sums, then its (max, sum)
  __shared__ float red_ml[kCWarps][2];
  __shared__ __align__(16) float part_acc[DH];
  __shared__ float part_m[1];
  __shared__ float part_l[1];

  const int r = blockIdx.x;  // query row = kv row b * H + h (blocks: n_kv_head holds H)
  const int split = blockIdx.y;
  const int b = r / a.n_kv_head;
  const int hkv = r % a.n_kv_head;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a step captured in a CUDA graph reads the slot on the device; its plan
  // covers the window up to a.pos, and a split wholly past pos leaves an
  // empty partial. The attention blocks read it (and the starts) before
  // their programmatic wait, where the SM's L1 may still hold an earlier
  // step's line: from L2 (pos was written kernels before the step's first)
  const int pos = a.pos_dev == nullptr ? a.pos : __ldcg(a.pos_dev);
  const size_t pos_stride = (size_t)a.bkv * DH;  // elements from slot s to s + 1 (packed: word row)
  // blocks: the kv row, b * H_kv + h / kv_group
  const int kv = kBlock ? b * (a.n_kv_head / a.kv_group) + hkv / a.kv_group : r;
  const size_t base = (size_t)a.layer * (kPacked ? a.seq_len / 4 : a.seq_len) * pos_stride + (size_t)kv * DH;
  const T* kn = kBlock ? nullptr : a.k_new + (size_t)r * DH;
  const T* vn = kBlock ? nullptr : a.v_new + (size_t)r * DH;
  const int sp_lo = split * a.split_len;
  // blocks: whether this split holds pos, and so makes the new row; a split
  // wholly past pos (a window bucket's plan) makes and writes nothing
  [[maybe_unused]] const bool holds = pos >= sp_lo && pos < sp_lo + a.split_len;
  T* kw = reinterpret_cast<T*>(ring) + (size_t)warp * kRStages * 2 * WT;  // [stage][K, V][slot][DH]
  // blocks: each warp's stages' scales [stage][K, V][slot], the new row's
  // two scales, the new rows [K, V][DH]
  float* kw_sc = reinterpret_cast<float*>(ring + block_ring_bytes<NEW, DH>()) + (size_t)warp * kRStages * 2 * kRTile;
  float* new_sc = reinterpret_cast<float*>(ring + block_ring_bytes<NEW, DH>()) + kCWarps * kRStages * 2 * kRTile;
  NewT* new_row = reinterpret_cast<NewT*>(new_sc + 4);

  const int lo = a.starts == nullptr ? 0 : min(max(kBlock ? __ldcg(a.starts + b) : a.starts[b], 0), pos);
  const int s_begin = max(sp_lo, lo);
  const int s_end = min(sp_lo + a.split_len, pos + 1);
  const int s_first = kPacked ? s_begin & ~3 : s_begin;  // packed tiles start on a word row
  const int n_wt = s_first < s_end ? (s_end - s_first + kRTile - 1) / kRTile : 0;
  const int mine = n_wt > warp ? (n_wt - 1 - warp) / kCWarps + 1 : 0;  // tiles warp, warp + kCWarps, ...

  auto load_tile = [&](int i, int stage) {
    const int t0 = s_first + (warp + kCWarps * i) * kRTile;
    T* ks = kw + stage * 2 * WT;
    if constexpr (!kBlock) {
#pragma unroll
      for (int c = lane; c < kRTile * ROW_CH; c += 32) {
        const int p = c / ROW_CH;
        const int e = (c % ROW_CH) * V;
        const int s = t0 + p;
        const bool in = s < s_end;
        const bool fresh = s == pos;  // the new row: from k_new/v_new, never the cache
        const size_t off = in && !fresh ? base + (size_t)s * pos_stride : 0;
        cp_async16(ks + p * DH + e, (in && !fresh ? a.k_cache : kn) + off + e, in);
        cp_async16(ks + WT + p * DH + e, (in && !fresh ? a.v_cache : vn) + off + e, in);
      }
    } else {
#pragma unroll
      for (int c = lane; c < TR * ROW_CH; c += 32) {
        const int p = c / ROW_CH;  // tile row (packed: word row)
        const int e = (c % ROW_CH) * V;
        const int s = kPacked ? t0 + 4 * p : t0 + p;  // its (first) slot
        const bool in = s < s_end && (kPacked || s != pos);  // the new row is made in the block
        const size_t off = in ? base + (size_t)(kPacked ? s / 4 : s) * pos_stride + e : 0;
        cp_async16(ks + p * DH + e, a.k_cache + off, in);
        cp_async16(ks + WT + p * DH + e, a.v_cache + off, in);
      }
      if constexpr (kQuant) {
        if (lane < 2 * kRTile) {  // lanes 0-7 the slots' k scales, 8-15 their v scales
          const int s = t0 + lane % kRTile;
          const bool in = s >= s_begin && s < s_end && s != pos;  // packed: the tile may start before s_begin
          const size_t srow = kPacked ? ((size_t)a.layer * 4 + (s & 3)) * (a.seq_len / 4) + (s >> 2)
                                      : (size_t)a.layer * a.seq_len + s;
          cp_async4(kw_sc + stage * 2 * kRTile + lane,
                    (lane < kRTile ? a.k_scale : a.v_scale) + (in ? srow * a.scale_width + kv : 0), in);
        }
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kRStages - 1; ++i) {
    if (i < mine) load_tile(i, i);
    cp_async_commit();
  }

  const int grp = lane >> 3;  // slots grp and grp + 4 of a tile (packed: 2 grp and 2 grp + 1)
  const int lg = lane & 7;
  const int slot0 = kPacked ? 2 * grp : grp;
  const int slot1 = kPacked ? 2 * grp + 1 : grp + 4;
  float qf[EQ];
  if constexpr (!kBlock) {
    uint4 q_raw[NCH];  // the query's loads, in flight with the new row's
#pragma unroll
    for (int c = 0; c < NCH; ++c) q_raw[c] = reinterpret_cast<const uint4*>(a.q + (size_t)r * DH)[lg + 8 * c];
    write_new_rows<T, DH, kCThreads>(a, pos, base, pos_stride, kn, vn, sp_lo, sp_lo + a.split_len);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      to_floats<V>(reinterpret_cast<const T*>(&q_raw[c]), qf + c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) qf[c * V + j] *= a.scale;
    }
  } else {
    pdl_wait();  // the qkv product's output is written
    pdl_trigger();
    const float* qp = a.qkv + (size_t)b * a.q_bstride + (size_t)hkv * DH;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(qp + (lg + 8 * c) * V + j));
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[c * V + j + e] = kQuant ? round_bf16(f[e] * a.scale) : f[e] * a.scale;
      }
    // the split that holds pos makes the new K (threads < DH) and V row from
    // the f32 values, the first query head of the kv row writes it
    if (holds) {
      const int t = tid % DH;
      const bool is_v = tid >= DH;
      const int h_kv = a.n_kv_head / a.kv_group;
      const float v = __ldcg(a.qkv + (size_t)b * a.q_bstride + (size_t)(a.n_kv_head + (is_v ? h_kv : 0) + hkv / a.kv_group) * DH + t);
      const bool writes = hkv % a.kv_group == 0;
      T* cache = is_v ? a.v_cache : a.k_cache;
      if constexpr (!kQuant) {
        new_row[is_v * DH + t] = __float2bfloat16_rn(v);
        if (writes) cache[base + (size_t)pos * pos_stride + t] = __float2bfloat16_rn(v);
      } else {
        float m = cwarp_max(fabsf(v));
        if (lane == 0) red_ml[warp][0] = m;
        __syncthreads();
        m = red_ml[is_v ? 4 : 0][0];
#pragma unroll
        for (int w = 1; w < kCWarps / 2; ++w) m = fmaxf(m, red_ml[(is_v ? 4 : 0) + w][0]);
        const float sc = fmaxf(m, 1e-8f) * (float)(1.0 / 127.0);
        const int q = (int)fminf(fmaxf(rintf(__fdiv_rn(v, sc)), -127.f), 127.f);
        new_row[is_v * DH + t] = (int8_t)q;
        if (t == 0) new_sc[is_v] = sc;
        if (writes) {
          size_t srow;
          if constexpr (kPacked) {
            const int sh = 8 * (pos & 3);
            T* word = cache + base + (size_t)(pos >> 2) * pos_stride + t;
            *word = (int32_t)(((uint32_t)*word & ~(0xFFu << sh)) | (((uint32_t)q & 0xFFu) << sh));
            srow = ((size_t)a.layer * 4 + (pos & 3)) * (a.seq_len / 4) + (pos >> 2);
          } else {
            cache[base + (size_t)pos * pos_stride + t] = (int8_t)q;
            srow = (size_t)a.layer * a.seq_len + pos;
          }
          if (t == 0) (is_v ? a.v_scale : a.k_scale)[srow * a.scale_width + kv] = sc;
        }
      }
      __syncthreads();  // the new row is in shared memory; red_ml is free again
    }
  }
  float m = kCNegBig;  // the warp's running max (the same in every lane)
  float l = 0.f;       // the sum over the lane group's slots
  float acc[EQ];
#pragma unroll
  for (int e = 0; e < EQ; ++e) acc[e] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kRStages - 2>();
    __syncwarp();  // the warp's copies of tile i are visible to the warp; tile i - 1 is consumed
    if constexpr (kBlock) {
      const int tp = s_first + (warp + kCWarps * i) * kRTile;
      // the tile holding the new row: put the block's in. A split that ends at
      // pos has a last tile over it too, but no new row (its slot is zero-filled)
      if (holds && pos >= tp && pos < tp + kRTile) {
        T* kt = kw + (i % kRStages) * 2 * WT;
        float* kt_sc = kw_sc + (i % kRStages) * 2 * kRTile;
        if constexpr (kPacked) {
          const int p = (pos - tp) >> 2;
          const uint32_t sh = 8 * (pos & 3);
          for (int w = lane; w < DH; w += 32)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t* word = reinterpret_cast<uint32_t*>(kt + h * WT + p * DH + w);
              *word = (*word & ~(0xFFu << sh)) | (((uint32_t)(uint8_t)new_row[h * DH + w]) << sh);
            }
        } else {
          if (lane < 2 * ROW_CH)
            reinterpret_cast<uint4*>(kt + (lane / ROW_CH) * WT + (pos - tp) * DH)[lane % ROW_CH] =
                reinterpret_cast<const uint4*>(new_row + (lane / ROW_CH) * DH)[lane % ROW_CH];
        }
        if constexpr (kQuant) {
          if (lane < 2) kt_sc[lane * kRTile + pos - tp] = new_sc[lane];
        }
        __syncwarp();
      }
    }
    {
      const int next = i + kRStages - 1;
      if (next < mine) load_tile(next, next % kRStages);
      cp_async_commit();
    }
    const T* ks = kw + (i % kRStages) * 2 * WT;
    const float* ssc = kw_sc + (i % kRStages) * 2 * kRTile;
    const int t0 = s_first + (warp + kCWarps * i) * kRTile;
    float sc[2];
    float pk[kPacked ? 2 : 1][kPacked ? EQ : 1];  // packed: the lane's K values of both slots
    if constexpr (kPacked) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        packed_floats(ks + (grp >> 1) * DH + (lg + 8 * c) * V, slot0 & 3, pk[0] + c * V, pk[1] + c * V);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = h == 0 ? slot0 : slot1;
      float dot = 0.f;
      float dot2 = 0.f;  // two chains of sums: half the latency
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float kf[V];
        if constexpr (kPacked) {
#pragma unroll
          for (int j = 0; j < V; ++j) kf[j] = pk[h][c * V + j];
        } else if constexpr (NEW == kRowI8) {
          i8_floats(ks + slot * DH + (lg + 8 * c) * V, kf);
        } else {
          to_floats<V>(ks + slot * DH + (lg + 8 * c) * V, kf);
        }
#pragma unroll
        for (int j = 0; j < V; j += 2) {
          dot += qf[c * V + j] * kf[j];
          dot2 += qf[c * V + j + 1] * kf[j + 1];
        }
      }
      dot += dot2;
      dot += __shfl_xor_sync(kCFull, dot, 4);
      dot += __shfl_xor_sync(kCFull, dot, 2);
      dot += __shfl_xor_sync(kCFull, dot, 1);
      if constexpr (kQuant) dot *= ssc[slot] * 1.4426950408889634f;  // times the k scale, to the log2 domain
      const bool in = t0 + slot < s_end && (!kPacked || t0 + slot >= s_begin);
      sc[h] = in ? dot : kCNegBig;
    }
    float mt = fmaxf(sc[0], sc[1]);
    mt = fmaxf(mt, __shfl_xor_sync(kCFull, mt, 8));
    mt = fmaxf(mt, __shfl_xor_sync(kCFull, mt, 16));
    const float m_new = fmaxf(m, mt);  // mt is finite: the tile holds a slot of the window
    const float alpha = exp2f(m - m_new);
    const float p0 = sc[0] == kCNegBig ? 0.f : exp2f(sc[0] - m_new);
    const float p1 = sc[1] == kCNegBig ? 0.f : exp2f(sc[1] - m_new);
    l = l * alpha + p0 + p1;
    m = m_new;
    // the value weights: p, or bf16(p * v_scale) against the integer values
    const float w0 = kQuant ? round_bf16(p0 * ssc[kRTile + slot0]) : p0;
    const float w1 = kQuant ? round_bf16(p1 * ssc[kRTile + slot1]) : p1;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float v0[V], v1[V];
      if constexpr (kPacked) {
        packed_floats(ks + WT + (grp >> 1) * DH + (lg + 8 * c) * V, slot0 & 3, v0, v1);
      } else if constexpr (NEW == kRowI8) {
        i8_floats(ks + WT + slot0 * DH + (lg + 8 * c) * V, v0);
        i8_floats(ks + WT + slot1 * DH + (lg + 8 * c) * V, v1);
      } else {
        to_floats<V>(ks + WT + grp * DH + (lg + 8 * c) * V, v0);
        to_floats<V>(ks + WT + (grp + 4) * DH + (lg + 8 * c) * V, v1);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc[c * V + j] = acc[c * V + j] * alpha + w0 * v0[j] + w1 * v1[j];
    }
  }
  cp_async_wait<0>();

  // the warp's four lane groups share m: add up their sums
#pragma unroll
  for (int off = 8; off < 32; off <<= 1) {
    l += __shfl_xor_sync(kCFull, l, off);
#pragma unroll
    for (int e = 0; e < EQ; ++e) acc[e] += __shfl_xor_sync(kCFull, acc[e], off);
  }
  // the block's warps
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < V; ++j) red[warp][(lg + 8 * c) * V + j] = acc[c * V + j];
    if (lg == 0) {
      red_ml[warp][0] = m;
      red_ml[warp][1] = l;
    }
  }
  __syncthreads();
  if (tid < DH) {
    float mm = kCNegBig;
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) mm = fmaxf(mm, red_ml[w][0]);
    float aa = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) {
      const float c = exp2f(red_ml[w][0] - mm);  // a warp with no tile: m -1e30, sum 0
      aa += red[w][tid] * c;
      ll += red_ml[w][1] * c;
    }
    part_acc[tid] = aa;
    if (tid == 0) {
      part_m[0] = mm;
      part_l[0] = ll;
    }
  }
  __syncthreads();
  merge_splits<DH, 1>(a, b, hkv, 0, part_m, part_l, part_acc);
}

// ---- f32 with 2..16 queries a kv row (K4): CUDA cores --------------------
//
// One block per (kv row, split, group of QB queries); QB is 2, 4, 8 or 16.
// The block's 4 warps share each 32-slot tile of a ring of kCStages stages:
// scores (8 lanes a (query, slot) pair) to shared memory, then the softmax
// once a tile (warp w takes queries w, w + 4, ...), then P.V (warp w takes
// every fourth slot for all of the block's queries, a lane Dh/32 value
// dims); the warps' sums add up at the end.
template <typename T, int DH, int QB>
__global__ void __launch_bounds__(kGThreads) attn_simt_kernel(OnePassArgs<T> a) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int ROW_CH = DH / V;     // 16-byte chunks a row
  constexpr int EQ = DH / 8;         // elements a lane scores
  constexpr int NCH = EQ / V;        // chunks a lane scores
  constexpr int E = DH / 32;         // value dims a lane sums
  constexpr int QS = (QB + kGWarps - 1) / kGWarps;  // queries a warp's softmax owns
  constexpr int TILE = kCTile * DH;
  static_assert(DH == 64 || DH == 128, "head_dim 64 or 128");
  static_assert(QB >= 1 && QB <= kCMaxQ && kGGroups % QB == 0, "QB divides the 16 lane groups");
  static_assert(NCH >= 1, "a lane scores at least one chunk");
  static_assert(kGWarps * QB * DH * sizeof(float) <= simt_smem_bytes<T, DH>(),
                "the warps' sums fit the ring they reuse");

  extern __shared__ __align__(16) unsigned char ring[];
  T* k_s = reinterpret_cast<T*>(ring);  // [stage][slot][DH]
  T* v_s = k_s + kCStages * TILE;
  float* red_s = reinterpret_cast<float*>(ring);  // [warp][QB][DH], after the last tile
  __shared__ float s_s[QB][kCTile];                // the tile's scores
  __shared__ __align__(16) float p_s[kCTile][QB];  // the tile's weights
  __shared__ float alpha_s[QB];                    // the tile's rescale of each query
  __shared__ __align__(16) float part_acc[QB * DH];
  __shared__ float part_m[QB];
  __shared__ float part_l[QB];

  const int r = blockIdx.x;  // kv row b * H_kv + hkv
  const int split = blockIdx.y;
  const int q0 = blockIdx.z * QB;
  const int b = r / a.n_kv_head;
  const int hkv = r % a.n_kv_head;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = a.pos_dev == nullptr ? a.pos : __ldcg(a.pos_dev);  // in a CUDA graph: on the device
  const size_t pos_stride = (size_t)a.bkv * DH;  // elements from slot s to s + 1
  const size_t base = (size_t)a.layer * a.seq_len * pos_stride + (size_t)r * DH;
  const T* kn = a.k_new + (size_t)r * a.t_q * DH;
  const T* vn = a.v_new + (size_t)r * a.t_q * DH;
  const int sp_lo = split * a.split_len;
  const int sp_hi = sp_lo + a.split_len;

  const int lo = a.starts == nullptr ? 0 : min(max(a.starts[b], 0), pos);
  const int s_begin = max(sp_lo, lo);
  const int s_end = min(sp_hi, pos + a.t_q);
  const int n_tiles = s_begin < s_end ? (s_end - s_begin + kCTile - 1) / kCTile : 0;

  auto load_tile = [&](int tile, int stage) {
    const int t0 = s_begin + tile * kCTile;
    T* ks = k_s + stage * TILE;
    T* vs = v_s + stage * TILE;
    for (int c = tid; c < kCTile * ROW_CH; c += kGThreads) {
      const int p = c / ROW_CH;
      const int e = (c % ROW_CH) * V;
      const int s = t0 + p;
      const bool in = s < s_end;
      const bool fresh = s >= pos;  // a new row: from k_new/v_new, never the cache
      const size_t off = in ? (fresh ? (size_t)(s - pos) * DH : base + (size_t)s * pos_stride) : 0;
      const T* kp = (in && !fresh ? a.k_cache : kn) + off + e;
      const T* vp = (in && !fresh ? a.v_cache : vn) + off + e;
      cp_async16(ks + p * DH + e, kp, in);
      cp_async16(vs + p * DH + e, vp, in);
    }
  };
#pragma unroll
  for (int i = 0; i < kCStages - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    cp_async_commit();
  }
  if (blockIdx.z == 0) write_new_rows<T, DH, kGThreads>(a, pos, base, pos_stride, kn, vn, sp_lo, sp_hi);

  // the lane group's query for scoring: 8 lanes, EQ elements each
  const int grp = tid >> 3;
  const int lg = tid & 7;
  const int qi = grp % QB;
  const int bound = pos + (q0 + qi) / a.group;  // the query's last slot
  float qf[EQ];
  {
    const bool alive = q0 + qi < a.n_q;
    const T* qp = a.q + (size_t)query_row(a, b, hkv, alive ? q0 + qi : 0) * DH;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      to_floats<V>(qp + (lg + 8 * c) * V, qf + c * V);
#pragma unroll
      for (int j = 0; j < V; ++j) qf[c * V + j] = alive ? qf[c * V + j] * a.scale : 0.f;
    }
  }

  float m_r[QS];  // softmax state of the queries warp, warp + 4, ... (every lane holds it)
  float l_r[QS];
  float acc[QB][E];
#pragma unroll
  for (int k = 0; k < QS; ++k) m_r[k] = kCNegBig, l_r[k] = 0.f;
#pragma unroll
  for (int j = 0; j < QB; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kCStages - 2>();  // this thread's copies of the tile have landed
    __syncthreads();                // everyone's have, and the tile before is consumed
    {
      const int next = tile + kCStages - 1;
      if (next < n_tiles) load_tile(next, next % kCStages);
      cp_async_commit();
    }
    const T* ks = k_s + (tile % kCStages) * TILE;
    const T* vs = v_s + (tile % kCStages) * TILE;
    const int t0 = s_begin + tile * kCTile;

    // scores: pair grp + 16 rr is (query qi, slot (grp + 16 rr) / QB)
#pragma unroll 4
    for (int rr = 0; rr < 2 * QB; ++rr) {
      const int slot = (grp + kGGroups * rr) / QB;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float kf[V];
        to_floats<V>(ks + slot * DH + (lg + 8 * c) * V, kf);
#pragma unroll
        for (int j = 0; j < V; ++j) dot += qf[c * V + j] * kf[j];
      }
      dot += __shfl_xor_sync(kCFull, dot, 4);
      dot += __shfl_xor_sync(kCFull, dot, 2);
      dot += __shfl_xor_sync(kCFull, dot, 1);
      const int s = t0 + slot;
      if (lg == 0) s_s[qi][slot] = (s < s_end && s <= bound) ? dot : kCNegBig;
    }
    __syncthreads();

    // the softmax once a tile: warp w takes queries w, w + 4, ...; lane = slot
#pragma unroll
    for (int k = 0; k < QS; ++k) {
      const int j = warp + kGWarps * k;
      if (j >= QB) break;
      const float sc = s_s[j][lane];
      const float m_tile = cwarp_max(sc);
      float alpha = 1.f;
      float p = 0.f;
      if (m_tile != kCNegBig) {  // the same for the whole warp
        const float m_new = fmaxf(m_r[k], m_tile);
        alpha = exp2f(m_r[k] - m_new);
        p = sc == kCNegBig ? 0.f : exp2f(sc - m_new);
        l_r[k] = l_r[k] * alpha + cwarp_sum(p);
        m_r[k] = m_new;
      }
      p_s[lane][j] = p;
      if (lane == 0) alpha_s[j] = alpha;
    }
    __syncthreads();

    // P.V: warp w takes slots w, w + 4, ... for every query
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const float al = alpha_s[j];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] *= al;
    }
#pragma unroll 2
    for (int i = 0; i < kCTile / kGWarps; ++i) {
      const int slot = warp + kGWarps * i;
      float vf[E];
      to_floats<E>(vs + slot * DH + lane * E, vf);
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        const float p = p_s[slot][j];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] += p * vf[e];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile consumed: the ring becomes red_s

  // the block's partial: the four warps' sums, and each query's (max, sum)
#pragma unroll
  for (int j = 0; j < QB; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) red_s[(warp * QB + j) * DH + lane * E + e] = acc[j][e];
#pragma unroll
  for (int k = 0; k < QS; ++k) {
    const int j = warp + kGWarps * k;
    if (j < QB && lane == 0) {
      part_m[j] = m_r[k];
      part_l[j] = l_r[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < QB * DH; i += kGThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGWarps; ++w) s += red_s[w * QB * DH + i];
    part_acc[i] = s;
  }
  __syncthreads();
  merge_splits<DH, QB, kGThreads>(a, b, hkv, q0, part_m, part_l, part_acc);
}

// ---- bf16 with 2..16 queries a kv row (K4): tensor cores -------------------
//
// mma.sync m16n8k16 (bf16 in, f32 sums); the block's 16 query rows are the
// M side (rows past the kv row's queries are zeros, never written). As in
// the K1 kernel, a warp walks its own tiles, here of 16 slots, through its
// own ring with its own online softmax; no barrier of the block is on its
// path.
//   * Scores S = Q K^T: Q (16 x Dh) in registers for the whole call, K from
//     the tile by ldmatrix; bf16 q and K are exact inputs and every product
//     is exact in f32; the 1/sqrt(Dh) scale is applied in f32 after the dot.
//   * P V in f32: each weight p is split into a bf16 high part and a bf16
//     low part (p - high), two MMAs against the exact bf16 V, so p enters
//     with 16 bits of mantissa and the sums stay f32.
//   * The block's warps' (max, sum, acc) merge in shared memory with one
//     weight a (warp, query), then the splits merge as in the K1 kernel.
constexpr int kMTile = 16;   // slots a warp tile: the k side of P V
constexpr int kMStages = 2;  // warp tiles in a warp's ring
constexpr int kMQ = 16;      // query rows a block: one m16 tile

template <int DH>
__host__ __device__ constexpr int mma_row() {
  return DH + 8;  // padded row (bf16): ldmatrix's 8 rows hit 8 distinct 16-byte bank groups
}
template <int DH>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  // each warp's K and V ring, then Q
  return ((size_t)kCWarps * kMStages * 2 * kMTile + kMQ) * mma_row<DH>() * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(kCThreads) attn_mma_kernel(OnePassArgs<__nv_bfloat16> a) {
  using T = __nv_bfloat16;
  constexpr int RS = mma_row<DH>();
  constexpr int ROW_CH = DH / 8;  // 16-byte chunks a row
  constexpr int KS = DH / 16;     // k-steps of the scores
  constexpr int NT = DH / 8;      // n-tiles of the output
  constexpr int WT = kMTile * RS;  // elements of a warp tile of K (or V)
  static_assert(DH == 64 || DH == 128, "head_dim 64 or 128");
  static_assert((kMTile * ROW_CH) % 32 == 0, "whole chunks a lane");
  static_assert(kCWarps * kMQ * DH * sizeof(float) <= (size_t)kCWarps * kMStages * 2 * WT * sizeof(T),
                "the warps' sums fit the rings they reuse");

  extern __shared__ __align__(16) unsigned char ring[];
  T* q_s = reinterpret_cast<T*>(ring) + (size_t)kCWarps * kMStages * 2 * WT;  // [query][RS]
  T* kw = reinterpret_cast<T*>(ring) + (size_t)(threadIdx.x >> 5) * kMStages * 2 * WT;  // [stage][K, V][slot][RS]
  float* red_s = reinterpret_cast<float*>(ring);  // [warp][query][DH], after the last tile
  __shared__ float warp_m[kCWarps][kMQ];
  __shared__ float warp_l[kCWarps][kMQ];
  __shared__ __align__(16) float part_acc[kMQ * DH];
  __shared__ float part_m[kMQ];
  __shared__ float part_l[kMQ];

  const int r = blockIdx.x;  // kv row b * H_kv + hkv
  const int split = blockIdx.y;
  const int q0 = blockIdx.z * kMQ;
  const int b = r / a.n_kv_head;
  const int hkv = r % a.n_kv_head;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = a.pos_dev == nullptr ? a.pos : __ldcg(a.pos_dev);  // in a CUDA graph: on the device
  const size_t pos_stride = (size_t)a.bkv * DH;
  const size_t base = (size_t)a.layer * a.seq_len * pos_stride + (size_t)r * DH;
  const T* kn = a.k_new + (size_t)r * a.t_q * DH;
  const T* vn = a.v_new + (size_t)r * a.t_q * DH;
  const int sp_lo = split * a.split_len;
  const int sp_hi = sp_lo + a.split_len;

  const int lo = a.starts == nullptr ? 0 : min(max(a.starts[b], 0), pos);
  const int s_begin = max(sp_lo, lo);
  const int s_end = min(sp_hi, pos + a.t_q);
  const int n_wt = s_begin < s_end ? (s_end - s_begin + kMTile - 1) / kMTile : 0;
  const int mine = n_wt > warp ? (n_wt - 1 - warp) / kCWarps + 1 : 0;  // tiles warp, warp + kCWarps, ...

  // the block's queries (zeros past the kv row's) in the oldest copy group
  for (int c = tid; c < kMQ * ROW_CH; c += kCThreads) {
    const int j = c / ROW_CH;
    const int e = (c % ROW_CH) * 8;
    const bool alive = q0 + j < a.n_q;
    cp_async16(q_s + j * RS + e, a.q + (size_t)query_row(a, b, hkv, alive ? q0 + j : 0) * DH + e, alive);
  }
  cp_async_commit();
  auto load_tile = [&](int i, int stage) {
    const int t0 = s_begin + (warp + kCWarps * i) * kMTile;
    T* ks = kw + stage * 2 * WT;
#pragma unroll
    for (int c = lane; c < kMTile * ROW_CH; c += 32) {
      const int p = c / ROW_CH;
      const int e = (c % ROW_CH) * 8;
      const int s = t0 + p;
      const bool in = s < s_end;
      const bool fresh = s >= pos;  // a new row: from k_new/v_new, never the cache
      const size_t off = in ? (fresh ? (size_t)(s - pos) * DH : base + (size_t)s * pos_stride) : 0;
      cp_async16(ks + p * RS + e, (in && !fresh ? a.k_cache : kn) + off + e, in);
      cp_async16(ks + WT + p * RS + e, (in && !fresh ? a.v_cache : vn) + off + e, in);
    }
  };
#pragma unroll
  for (int i = 0; i < kMStages - 1; ++i) {
    if (i < mine) load_tile(i, i);
    cp_async_commit();
  }
  if (blockIdx.z == 0) write_new_rows<T, DH, kCThreads>(a, pos, base, pos_stride, kn, vn, sp_lo, sp_hi);
  cp_async_wait<kMStages - 1>();  // the queries' group, the oldest
  __syncthreads();
  uint32_t qa[KS][4];  // Q's A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4(static_cast<unsigned>(__cvta_generic_to_shared(q_s + row * RS + kk * 16 + (lane >> 4) * 8)), qa[kk]);
  }

  const int g = lane >> 2;        // the thread's query rows g and g + 8 of the m16 tiles
  const int c2 = (lane & 3) * 2;  // its first column of an n8 tile
  // the last slot of each of its two query rows (rows past the queries: any)
  const int bound0 = pos + (q0 + g) / a.group;
  const int bound1 = pos + (q0 + g + 8) / a.group;
  const unsigned kw_addr = static_cast<unsigned>(__cvta_generic_to_shared(kw));

  float m0 = kCNegBig, m1 = kCNegBig;  // rows g, g + 8: running max (same in the row's 4 lanes)
  float l0 = 0.f, l1 = 0.f;            // this lane's share of the running sums
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kMStages - 2>();
    __syncwarp();  // the warp's copies of tile i are visible to the warp; tile i - 1 is consumed
    {
      const int next = i + kMStages - 1;
      if (next < mine) load_tile(next, next % kMStages);
      cp_async_commit();
    }
    const int w0 = s_begin + (warp + kCWarps * i) * kMTile;  // the tile's first slot
    const unsigned ks_addr = kw_addr + (unsigned)((i % kMStages) * 2 * WT * sizeof(T));
    const unsigned vs_addr = ks_addr + (unsigned)(WT * sizeof(T));

    // scores of 16 query rows x 16 slots: n-tile 0 slots 0-7, n-tile 1 slots 8-15
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4];
      const int slot = (lane & 7) + (lane >> 4) * 8;
      ldsm_x4(ks_addr + (unsigned)((slot * RS + kk * 16 + ((lane >> 3) & 1) * 8) * sizeof(T)), kb);
      mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
      mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
    }

    // the softmax once a tile, per query row: max over the 4 lanes of a row
    float mt0 = kCNegBig, mt1 = kCNegBig;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = w0 + n * 8 + c2 + e;
        const bool in = s < s_end;
        sc[n][e] = in && s <= bound0 ? sc[n][e] * a.scale : kCNegBig;
        sc[n][2 + e] = in && s <= bound1 ? sc[n][2 + e] * a.scale : kCNegBig;
        mt0 = fmaxf(mt0, sc[n][e]);
        mt1 = fmaxf(mt1, sc[n][2 + e]);
      }
    mt0 = fmaxf(mt0, __shfl_xor_sync(kCFull, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(kCFull, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(kCFull, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(kCFull, mt1, 2));
    // a row with no slot in this tile keeps its state: alpha 1, weights 0
    const float mn0 = fmaxf(m0, mt0);
    const float mn1 = fmaxf(m1, mt1);
    const float al0 = mt0 == kCNegBig ? 1.f : exp2f(m0 - mn0);
    const float al1 = mt1 == kCNegBig ? 1.f : exp2f(m1 - mn1);
    l0 *= al0;
    l1 *= al1;
    uint32_t ph[4], pl[4];  // P's A fragments, high and low bf16 parts
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = sc[n][e] == kCNegBig ? 0.f : exp2f(sc[n][e] - mn0);
        p[2 + e] = sc[n][2 + e] == kCNegBig ? 0.f : exp2f(sc[n][2 + e] - mn1);
      }
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(p[2], p[3]);
      const float2 f01 = __bfloat1622float2(h01);
      const float2 f23 = __bfloat1622float2(h23);
      ph[2 * n] = *reinterpret_cast<const uint32_t*>(&h01);
      ph[2 * n + 1] = *reinterpret_cast<const uint32_t*>(&h23);
      pl[2 * n] = pack_bf16(p[0] - f01.x, p[1] - f01.y);
      pl[2 * n + 1] = pack_bf16(p[2] - f23.x, p[3] - f23.y);
    }
    m0 = mt0 == kCNegBig ? m0 : mn0;
    m1 = mt1 == kCNegBig ? m1 : mn1;

    // P V: 16 query rows x 16 slots against 16 slots x Dh, two n-tiles a load
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
#pragma unroll
    for (int d2 = 0; d2 < NT / 2; ++d2) {
      uint32_t vb[4];
      const int slot = (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(vs_addr + (unsigned)((slot * RS + d2 * 16 + (lane >> 4) * 8) * sizeof(T)), vb);
      mma_bf16(o[2 * d2], ph, vb[0], vb[1]);
      mma_bf16(o[2 * d2], pl, vb[0], vb[1]);
      mma_bf16(o[2 * d2 + 1], ph, vb[2], vb[3]);
      mma_bf16(o[2 * d2 + 1], pl, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's tiles consumed: the rings become red_s

  // the warps' partials, then the block's: one weight exp(m_w - max) a (warp, query)
  l0 += __shfl_xor_sync(kCFull, l0, 1);
  l0 += __shfl_xor_sync(kCFull, l0, 2);
  l1 += __shfl_xor_sync(kCFull, l1, 1);
  l1 += __shfl_xor_sync(kCFull, l1, 2);
  if ((lane & 3) == 0) {
    warp_m[warp][g] = m0;
    warp_m[warp][g + 8] = m1;
    warp_l[warp][g] = l0;
    warp_l[warp][g + 8] = l1;
  }
  const int live = min(kMQ, a.n_q - q0);  // query rows past it are never written
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (g < live)
      *reinterpret_cast<float2*>(&red_s[(warp * kMQ + g) * DH + n * 8 + c2]) = make_float2(o[n][0], o[n][1]);
    if (g + 8 < live)
      *reinterpret_cast<float2*>(&red_s[(warp * kMQ + g + 8) * DH + n * 8 + c2]) = make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();
  if (tid < kMQ) {
    float mm = kCNegBig;
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) mm = fmaxf(mm, warp_m[w][tid]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) {
      const float c = exp2f(warp_m[w][tid] - mm);  // a warp with no tile: m -1e30, sum 0
      warp_m[w][tid] = c;
      ll += warp_l[w][tid] * c;
    }
    part_m[tid] = mm;
    part_l[tid] = ll;
  }
  __syncthreads();
  for (int i4 = tid; i4 < live * DH / 4; i4 += kCThreads) {
    const int j = 4 * i4 / DH;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) {
      const float c = warp_m[w][j];
      const float4 v = reinterpret_cast<const float4*>(red_s)[w * kMQ * DH / 4 + i4];
      s.x += v.x * c, s.y += v.y * c, s.z += v.z * c, s.w += v.w * c;
    }
    reinterpret_cast<float4*>(part_acc)[i4] = s;
  }
  __syncthreads();
  merge_splits<DH, kMQ>(a, b, hkv, q0, part_m, part_l, part_acc);
}

// Launch one of the kernels: grid (kv rows, splits, query groups).
template <typename T, typename Kernel>
cudaError_t launch_split(Kernel kern, int threads, size_t smem, bool& configured, const OnePassArgs<T>& a,
                         int n_splits, int n_groups, cudaStream_t stream) {
  if (!configured) {  // set once, before the first launch (and any capture)
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kern<<<dim3(a.bkv, n_splits, n_groups), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DH, int QB>
cudaError_t launch_simt_qb(const OnePassArgs<T>& a, int n_splits, cudaStream_t stream) {
  static bool configured = false;
  return launch_split(attn_simt_kernel<T, DH, QB>, kGThreads, simt_smem_bytes<T, DH>(), configured, a,
                          n_splits, (a.n_q + QB - 1) / QB, stream);
}

template <typename T, int DH>
cudaError_t launch_onepass(const OnePassArgs<T>& a, int n_splits, cudaStream_t stream) {
  if (a.n_q == 1) {
    static bool configured = false;
    return launch_split(attn_row_kernel<T, DH>, kCThreads, row_smem_bytes<T, DH>(), configured, a, n_splits, 1, stream);
  }
  if constexpr (sizeof(T) == 2) {  // bf16: tensor cores from two queries a kv row
    static bool configured = false;
    return launch_split(attn_mma_kernel<DH>, kCThreads, mma_smem_bytes<DH>(), configured, a, n_splits,
                            (a.n_q + kMQ - 1) / kMQ, stream);
  } else {
    if (a.n_q <= 2) return launch_simt_qb<T, DH, 2>(a, n_splits, stream);
    if (a.n_q <= 4) return launch_simt_qb<T, DH, 4>(a, n_splits, stream);
    if (a.n_q <= 8) return launch_simt_qb<T, DH, 8>(a, n_splits, stream);
    return launch_simt_qb<T, DH, 16>(a, n_splits, stream);
  }
}

template <typename T, int DH>
cudaError_t attention_onepass(const void* q, const void* k_new, const void* v_new, void* k_cache,
                              void* v_cache, const int* starts, int batch, int n_head, int n_kv_head,
                              int t_q, int seq_len, int layer, int pos, const int* pos_dev, int split_len,
                              int n_splits, float* part, int* tickets, void* y, cudaStream_t stream) {
  OnePassArgs<T> a;
  a.q = static_cast<const T*>(q);
  a.k_new = static_cast<const T*>(k_new);
  a.v_new = static_cast<const T*>(v_new);
  a.k_cache = static_cast<T*>(k_cache);
  a.v_cache = static_cast<T*>(v_cache);
  a.y = static_cast<T*>(y);
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
  a.pos_dev = pos_dev;
  a.split_len = split_len;
  a.scale = (float)(1.4426950408889634 / sqrt((double)DH));  // log2(e) / sqrt(Dh)
  a.part = part;
  a.tickets = tickets;
  return launch_onepass<T, DH>(a, n_splits, stream);
}

// The attention of one attention block (K5, K9), launched as a programmatic
// dependent of the qkv product before it on the stream: one block a query
// head and split, grid (batch * n_head, n_splits). qkv (batch, q_bstride)
// f32: q (n_head * 128), the new K row, the new V row (n_kv_head * 128
// each); y (batch, n_head * 128) bf16; the caches in NEW's format, the new
// row written at (layer, pos), with its scales in k_scale / v_scale
// (scale_width columns a slot) for the int8 and packed caches. pos_dev as
// for decode_attention_onepass (pos is then the last slot of the plan's
// window). part and tickets as for decode_attention_onepass with batch *
// n_head kv rows and one query each. The caller checks the shapes and the
// plan.
template <int NEW>
cudaError_t attention_block(const float* qkv, int q_bstride, void* k_cache, void* v_cache, float* k_scale,
                            float* v_scale, int scale_width, const int* starts, int batch, int n_head,
                            int n_kv_head, int seq_len, int layer, int pos, const int* pos_dev, int split_len,
                            int n_splits,
                            float* part, int* tickets, __nv_bfloat16* y, cudaStream_t stream) {
  using T = std::conditional_t<NEW == kRowBf16, __nv_bfloat16, std::conditional_t<NEW == kRowI8, int8_t, int32_t>>;
  constexpr int DH = 128;
  constexpr size_t smem = block_smem_bytes<NEW, DH>();
  OnePassArgs<T, __nv_bfloat16> a = {};
  a.k_cache = static_cast<T*>(k_cache);
  a.v_cache = static_cast<T*>(v_cache);
  a.y = y;
  a.starts = starts;
  a.n_head = n_head;
  a.n_kv_head = n_head;  // one block a query head
  a.group = 1;
  a.t_q = 1;
  a.n_q = 1;
  a.bkv = batch * n_kv_head;
  a.seq_len = seq_len;
  a.layer = layer;
  a.pos = pos;
  a.pos_dev = pos_dev;
  a.split_len = split_len;
  // bf16: q * log2(e) / sqrt(Dh), as K1; int8: bf16(q / sqrt(Dh)), log2(e) after the k scale
  a.scale = (float)((NEW == kRowBf16 ? 1.4426950408889634 : 1.0) / sqrt((double)DH));
  a.part = part;
  a.tickets = tickets;
  a.qkv = qkv;
  a.q_bstride = q_bstride;
  a.kv_group = n_head / n_kv_head;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.scale_width = scale_width;
  static bool configured = false;
  if (!configured) {  // set once, before the first launch (and any capture)
    cudaError_t err = cudaFuncSetAttribute(attn_row_kernel<T, DH, NEW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return launch_chained(attn_row_kernel<T, DH, NEW>, dim3(batch * n_head, n_splits), dim3(kCThreads), smem, stream,
                        a);
}

// dtype: 0 = bfloat16, 1 = float32 (q, k_new, v_new, both caches and y share
// it). part: with n_splits > 1, f32 scratch of at least (batch * n_kv_head *
// query groups * n_splits * 16 * (head_dim + 2)) values, query groups =
// ceil(t_q * n_head / n_kv_head / 16); tickets: n_tickets int32 counters,
// all 0, left 0. pos_dev: nullptr, or an int32 on the device holding the
// first new row's slot, which the caller keeps in [0, pos]: pos + t_q is
// then the window the plan covers, so one launch serves every slot of that
// window (a CUDA graph replayed step after step, or round after round of
// the speculative verify at t_q = gamma).
// Checks the shape and the plan, then launches. Returns a cudaError_t.
inline int decode_attention_onepass(int dtype, const void* q, const void* k_new, const void* v_new,
                                    void* k_cache, void* v_cache, const void* starts, int batch,
                                    int n_head, int n_kv_head, int t_q, int head_dim, int seq_len,
                                    int layer, int pos, const void* pos_dev, int split_len, int n_splits,
                                    void* part, void* tickets, int n_tickets, void* y, void* stream) {
  const long long n = (long long)pos + t_q;
  if (t_q < 1 || t_q > kCMaxT || n_kv_head < 1 || n_head % n_kv_head != 0 || pos < 0 ||
      n > seq_len || split_len < 1 || n_splits < 1 || n_splits > kCMaxSplits ||
      (long long)split_len * n_splits < n)
    return (int)cudaErrorInvalidValue;
  const long long n_groups = ((long long)t_q * (n_head / n_kv_head) + kCMaxQ - 1) / kCMaxQ;
  if (n_splits > 1 && (part == nullptr || tickets == nullptr || (long long)batch * n_kv_head * n_groups > n_tickets))
    return (int)cudaErrorInvalidValue;
  const int* st = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MV_ARGS q, k_new, v_new, k_cache, v_cache, st, batch, n_head, n_kv_head, t_q, seq_len, layer, pos, \
                static_cast<const int*>(pos_dev), split_len, n_splits, static_cast<float*>(part),               \
                static_cast<int*>(tickets), y, s
  if (dtype == 0 && head_dim == 128) return (int)attention_onepass<__nv_bfloat16, 128>(MV_ARGS);
  if (dtype == 0 && head_dim == 64) return (int)attention_onepass<__nv_bfloat16, 64>(MV_ARGS);
  if (dtype == 1 && head_dim == 128) return (int)attention_onepass<float, 128>(MV_ARGS);
  if (dtype == 1 && head_dim == 64) return (int)attention_onepass<float, 64>(MV_ARGS);
#undef MV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace
