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
// Design, following that bound: the device code of decode_attention_onepass.cuh.
// The cache read is shared by every query of a kv row: a block takes one kv
// row, one split of the sequence and up to 16 of its T * g queries, so a
// tile is read from device memory once for all of them (more than 16
// queries of one kv row go to further blocks that read the same tiles
// again, mostly from L2). In bf16 the scores and P V run on tensor cores
// (mma.sync, P as a bf16 high and low part), in f32 on CUDA cores. One
// launch a call: the last block of a kv row to finish merges its splits.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper, its plan of the split and
// its plain PyTorch version are in metavoice_tpu_torch/ops/attention.py.

#include "decode_attention_onepass.cuh"

// dtype: 0 = bfloat16, 1 = float32 (q, k_new, v_new, both caches and y share it).
// q, y: (batch, n_head, t_q, head_dim); k_new, v_new: (batch, n_kv_head, t_q,
// head_dim); caches (L, seq_len, batch, n_kv_head, head_dim); starts: NULL or
// (batch,) int32 on the device. The window [0, pos + t_q) is cut into
// n_splits <= 32 splits of split_len slots; part, tickets and n_tickets as
// decode_attention_onepass in the header says. pos_dev: NULL, or an int32 on
// the device holding the first new row's slot, at most pos (a GQA decode
// step at t_q 1, or the speculative verify at t_q gamma, captured in a CUDA
// graph, reads it at each replay; pos is then window - t_q, the last first
// slot the plan's window holds). Returns a cudaError_t.
extern "C" int mv_decode_attention_multi(int dtype, const void* q, const void* k_new,
                                         const void* v_new, void* k_cache, void* v_cache,
                                         const void* starts, int batch, int n_head,
                                         int n_kv_head, int t_q, int head_dim, int seq_len,
                                         int layer, int pos, const void* pos_dev, int split_len,
                                         int n_splits, void* part, void* tickets, int n_tickets,
                                         void* y, void* stream) {
  return decode_attention_onepass(dtype, q, k_new, v_new, k_cache, v_cache, starts, batch, n_head,
                                  n_kv_head, t_q, head_dim, seq_len, layer, pos, pos_dev, split_len,
                                  n_splits, part, tickets, n_tickets, y, stream);
}
