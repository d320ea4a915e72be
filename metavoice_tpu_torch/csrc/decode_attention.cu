// T=1 flash-decode attention for one layer, written for Hopper (sm_90a).
//
// Replaces metavoice_tpu/ops/attention.py:decode_attention (the Pallas TPU
// kernel _decode_attn_kernel). For one query token per (batch, head) row it
// writes the step's new K/V row into the sequence-major (L, S, B, H, Dh)
// cache in place at (layer, pos), then takes the softmax-weighted sum of the
// values over the row's window [starts[b], pos].
//
// What bounds it: cache bytes. A step reads 2 * (pos + 1 - start) * B * H * Dh
// elements of the layer's K and V and does two multiply-adds per element, far
// below the card's ~295 operations per byte, so the kernel is bound by how fast
// it streams the window out of device memory, and at short windows by latency.
//
// Design, following that bound:
//   * Only the valid window is read: slots beyond pos (which may hold garbage,
//     even NaN) and below the row's start are never loaded. Skipping them is
//     exact, since the masked slots get weight exactly 0 in the reference.
//   * The sequence is split across blocks (flash-decoding): grid (B*H, splits),
//     so a main-path step with only B*H = 32 rows still spreads over the SMs.
//     Each block keeps its own online-softmax state in f32 and writes a
//     partial (max, sum, acc); a second tiny kernel merges the splits.
//   * Eight lanes share one cache row: each lane loads Dh/8 contiguous
//     elements with 16-byte loads, so a warp reads four positions at once,
//     coalesced, and reduces a dot product with three shuffles.
//   * Ordering of the row write: blocks run in no order, so no block may read
//     slot pos from the cache. The block whose split holds pos writes the new
//     row, and every read of slot pos takes k_new/v_new instead.
//   * f32 arithmetic throughout: q * (1/sqrt(Dh)) in f32, f32 scores,
//     f32 accumulators; the output is rounded once to the input type.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper and its plain PyTorch
// version are in metavoice_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;                  // lanes that share one cache row
constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 32 / kGroup;  // positions one warp reads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegBig = -1e30f;          // the reference's finite -inf

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

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// One block per (row, split). Writes the split's partial softmax state:
// part_ml[2 * (row * n_splits + split) + {0, 1}] = (max, sum of exp),
// part_acc[(row * n_splits + split) * DH + d] = sum of exp-weighted values.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attn_split(const T* __restrict__ q, const T* __restrict__ k_new,
                  const T* __restrict__ v_new, T* __restrict__ k_cache,
                  T* __restrict__ v_cache, const int* __restrict__ starts, int n_head,
                  int bh, int seq_len, int layer, int pos, int split_len, float scale,
                  float* __restrict__ part_ml, float* __restrict__ part_acc) {
  constexpr int E = DH / kGroup;
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kGroup;
  const int d0 = (lane % kGroup) * E;

  const size_t pos_stride = (size_t)bh * DH;  // elements from slot s to s + 1
  const size_t base = (size_t)layer * seq_len * pos_stride + (size_t)row * DH;
  const T* kn = k_new + (size_t)row * DH;
  const T* vn = v_new + (size_t)row * DH;

  if (split == pos / split_len && threadIdx.x < DH) {
    k_cache[base + (size_t)pos * pos_stride + threadIdx.x] = kn[threadIdx.x];
    v_cache[base + (size_t)pos * pos_stride + threadIdx.x] = vn[threadIdx.x];
  }

  const int lo = starts == nullptr ? 0 : min(max(starts[row / n_head], 0), pos);
  const int s_begin = max(split * split_len, lo);
  const int s_end = min((split + 1) * split_len, pos + 1);

  float qf[E];
  load_row<E>(q + (size_t)row * DH + d0, qf);
#pragma unroll
  for (int i = 0; i < E; ++i) qf[i] *= scale;

  float m = kNegBig;
  float l = 0.f;
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  // `base_s` is the same for the whole warp, so every lane takes part in the
  // shuffles; lanes whose position falls past the split only skip the update.
  for (int base_s = s_begin + warp * kRowsPerWarp; base_s < s_end;
       base_s += kWarps * kRowsPerWarp) {
    const int s = base_s + grp;
    const bool valid = s < s_end;
    float kf[E];
    float vf[E];
    float dot = 0.f;
    if (valid) {
      const T* kp = s == pos ? kn + d0 : k_cache + base + (size_t)s * pos_stride + d0;
      const T* vp = s == pos ? vn + d0 : v_cache + base + (size_t)s * pos_stride + d0;
      load_row<E>(kp, kf);
      load_row<E>(vp, vf);
#pragma unroll
      for (int i = 0; i < E; ++i) dot += qf[i] * kf[i];
    }
    dot += __shfl_xor_sync(kFull, dot, 4);
    dot += __shfl_xor_sync(kFull, dot, 2);
    dot += __shfl_xor_sync(kFull, dot, 1);
    if (valid) {
      const float m_new = fmaxf(m, dot);
      const float alpha = expf(m - m_new);
      const float p = expf(dot - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = acc[i] * alpha + p * vf[i];
      m = m_new;
    }
  }

  // Merge the warp's four position groups (lanes that differ in bits 3, 4).
#pragma unroll
  for (int off = kGroup; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(kFull, m, off);
    const float l_o = __shfl_xor_sync(kFull, l, off);
    const float m_new = fmaxf(m, m_o);
    const float a = expf(m - m_new);
    const float b = expf(m_o - m_new);
    l = l * a + l_o * b;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float acc_o = __shfl_xor_sync(kFull, acc[i], off);
      acc[i] = acc[i] * a + acc_o * b;
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
    const size_t part = (size_t)row * n_splits + split;
    part_acc[part * DH + d] = aa;
    if (d == 0) {
      part_ml[2 * part] = mm;
      part_ml[2 * part + 1] = ll;
    }
  }
}

// One block of DH threads per row: merge the splits and write y in T.
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
decode_attn_combine(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    int n_splits, T* __restrict__ y) {
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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
                   void* v_cache, const int* starts, int batch, int n_head, int seq_len,
                   int layer, int pos, int split_len, int n_splits, float* part_ml,
                   float* part_acc, void* y, cudaStream_t stream) {
  const int bh = batch * n_head;
  const float scale = (float)(1.0 / sqrt((double)DH));
  decode_attn_split<T, DH><<<dim3(bh, n_splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), starts, n_head, bh, seq_len, layer,
      pos, split_len, scale, part_ml, part_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<T, DH><<<bh, DH, 0, stream>>>(part_ml, part_acc, n_splits,
                                                    static_cast<T*>(y));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, k_new, v_new, both caches and y share it).
// starts: NULL or (batch,) int32 on the device. part_ml: (B*H*n_splits*2,) f32 and
// part_acc: (B*H*n_splits*head_dim,) f32 scratch. Returns a cudaError_t.
extern "C" int mv_decode_attention(int dtype, const void* q, const void* k_new,
                                   const void* v_new, void* k_cache, void* v_cache,
                                   const void* starts, int batch, int n_head, int head_dim,
                                   int seq_len, int layer, int pos, int split_len,
                                   int n_splits, void* part_ml, void* part_acc, void* y,
                                   void* stream) {
  const int* st = static_cast<const int*>(starts);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_len < 1 || n_splits < 1 || (long long)split_len * n_splits < (long long)pos + 1)
    return (int)cudaErrorInvalidValue;
#define MV_ARGS q, k_new, v_new, k_cache, v_cache, st, batch, n_head, seq_len, layer, pos, \
                split_len, n_splits, ml, acc, y, s
  if (dtype == 0 && head_dim == 128) return (int)launch<__nv_bfloat16, 128>(MV_ARGS);
  if (dtype == 0 && head_dim == 64) return (int)launch<__nv_bfloat16, 64>(MV_ARGS);
  if (dtype == 1 && head_dim == 128) return (int)launch<float, 128>(MV_ARGS);
  if (dtype == 1 && head_dim == 64) return (int)launch<float, 64>(MV_ARGS);
#undef MV_ARGS
  return (int)cudaErrorInvalidValue;
}
