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
// Design, following that bound: only the valid window is read, split along
// the sequence across blocks (grid (B*H, splits), so a main-path step with
// only B*H = 32 rows still spreads over the SMs) with a second kernel that
// merges the splits; f32 arithmetic throughout. The device code is shared
// with the int4 decode stack and described in decode_attention.cuh. Ordering
// of the row write: blocks run in no order, so no block may read slot pos
// from the cache; the block whose split holds pos writes the new row, and
// every read of slot pos takes k_new/v_new instead.
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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
                   void* v_cache, const int* starts, int batch, int n_head, int seq_len,
                   int layer, int pos, int split_len, int n_splits, float* part_ml,
                   float* part_acc, void* y, cudaStream_t stream) {
  const int bh = batch * n_head;
  SplitArgs<T, T> a;
  a.q = static_cast<const T*>(q);
  a.q_bstride = n_head * DH;
  a.k_new = static_cast<const T*>(k_new);
  a.v_new = static_cast<const T*>(v_new);
  a.k_cache = static_cast<T*>(k_cache);
  a.v_cache = static_cast<T*>(v_cache);
  a.starts = starts;
  a.n_head = n_head;
  a.group = 1;
  a.bkv = bh;
  a.seq_len = seq_len;
  a.layer = layer;
  a.pos_dev = nullptr;
  a.pos = pos;
  a.split_len = split_len;
  a.scale = (float)(1.0 / sqrt((double)DH));
  a.part_ml = part_ml;
  a.part_acc = part_acc;
  decode_attn_split<T, T, DH><<<dim3(bh, n_splits), kThreads, 0, stream>>>(a);
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
