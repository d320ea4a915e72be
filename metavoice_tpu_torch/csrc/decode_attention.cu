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
// Design, following that bound: the device code of decode_attention_onepass.cuh
// with one query a row (T = 1, g = 1), on CUDA cores: one launch a call, the
// sequence split across blocks and merged by the last block of a row to
// finish, every warp streaming its own tiles through its own ring of
// shared-memory stages with cp.async, and the online softmax once a tile, in
// f32.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper, its plan of the split and
// its plain PyTorch version are in metavoice_tpu_torch/ops/attention.py.

#include "decode_attention_onepass.cuh"

// dtype: 0 = bfloat16, 1 = float32 (q, k_new, v_new, both caches and y share it).
// q, k_new, v_new, y: (batch, n_head, head_dim); caches (L, seq_len, batch,
// n_head, head_dim); starts: NULL or (batch,) int32 on the device. The window
// [0, pos] is cut into n_splits <= 32 splits of split_len slots; part,
// tickets and n_tickets as decode_attention_onepass in the header says.
// pos_dev: NULL, or an int32 on the device holding the new row's slot, at
// most pos (a captured step reads it at each replay; pos is then the last
// slot of the plan's window). Returns a cudaError_t.
extern "C" int mv_decode_attention(int dtype, const void* q, const void* k_new,
                                   const void* v_new, void* k_cache, void* v_cache,
                                   const void* starts, int batch, int n_head, int head_dim,
                                   int seq_len, int layer, int pos, const void* pos_dev, int split_len,
                                   int n_splits, void* part, void* tickets, int n_tickets,
                                   void* y, void* stream) {
  return decode_attention_onepass(dtype, q, k_new, v_new, k_cache, v_cache, starts, batch, n_head,
                                  n_head, 1, head_dim, seq_len, layer, pos, pos_dev, split_len, n_splits,
                                  part, tickets, n_tickets, y, stream);
}
