// One decode layer's plain-int8 attention block (K9, mv_decode_block_int8)
// and plain-int8 SwiGLU FFN (K10, mv_decode_ffn_int8), written for Hopper
// (sm_90a).
//
// Replaces metavoice_tpu/ops/attention.py:decode_attention_block_int8 (the
// Pallas TPU kernel _decode_block_kernel) and
// metavoice_tpu/ops/quantized.py:ffn_int8 (_ffn_int8_kernel): the T = 1
// step of quantisation_mode="int8_plain", whose weights are plain (K, N)
// int8 arrays with one f32 scale per output column.
//
// K9, for B <= 8 rows of the normed input x (B, D) bf16, MHA, Dh = 128:
//   qkv = (x @ Wqkv) * s_qkv in f32 (bf16 x times the exact int8 values,
//   f32 sums over all of K, times the column scale);
//   the new K and V rows written as bf16(qkv) at (layer, pos) of the bf16
//   (L, S, B, H, Dh) cache;
//   attention over [starts[b], pos] (q * 1/sqrt(Dh) in f32, f32 scores and
//   sums), rounded to bf16;
//   y = bf16((y_attn @ Wo) * s_o).
// K10: h = bf16(silu(x @ W1 * s1) * (x @ W3 * s3)) with silu and the product
//   in f32; y = (h @ W2) * s2 in f32.
// Weights are one layer's: the wrappers pass that layer's view.
//
// What bounds them: the weight bytes and, for K9, the cache window. At the
// main-path shape (D = 2048, 16 heads, B = 2, FFN 5632) K9 reads 16.8 MB of
// int8 weights plus 2 * (pos + 1) * 16 KB of bf16 cache, K10 34.6 MB: at
// 3.35 TB/s about 6.3 us (K9 at pos 255), 15 us (K9 at pos 2047) and 10 us
// (K10). Two multiply-adds per weight byte and row are far below the card's
// ~295 operations a byte.
//
// K9's design: three kernels on the caller's stream, each launched as a
// programmatic dependent of the one before (it loads its weights, or its
// first cache tiles, before griddepcontrol.wait); it allocates nothing and
// never synchronises.
//   1. qkv = x @ Wqkv * s: the tensor-core GEMV of decode_stack_gemv.cuh in
//      its plain-int8 form (a lane's 4 columns one 4-byte word a row, the
//      signed bytes made exact bf16 by a byte permute, f32 sums over K, the
//      column scale applied once after the split merge inside the launch),
//      K cut by the wrapper's plan (ops/decode_stack.stack_gemv_plan, vpw 1).
//   2. Attention: the one-pass kernel of K1 (decode_attention_onepass.cuh,
//      attn_row_kernel, one block a head and split, the window cut by
//      ops/attention.attention_plan, the splits merged behind a ticket); the
//      split that holds pos rounds the new row from the f32 qkv and writes it.
//   3. y = bf16(ya @ Wo * s_o): as 1, the bf16 epilogue.
// What holds it (NVIDIA H100 80GB HBM3, 700 W; pos 255, mean profiled time
// of each kernel, which overlap): qkv product 15.2 us (12.6 MB of words in
// 384 blocks, 2 splits and their merge), attention 11.4, o-proj 11.7, 20.8
// us from a call's first start to its last end against 6.3 us of bytes:
// three dependent kernels, each product a prologue of dependent phases
// before its first mma, the attention's 256 slots one split on 32 SMs.
//
// K10's design: two kernels on the caller's stream, the second a
// programmatic dependent of the first; it allocates nothing and never
// synchronises.
//   1. h = bf16(silu(x @ W1 * s1) * (x @ W3 * s3)): one launch of the
//      tensor-core GEMV in its plain-int8 form (grid z 2: w1 and w3 side by
//      side), the last block of each column tile merging both matrices'
//      partials in a fixed order, each times its own column scale, then the
//      SwiGLU epilogue.
//   2. y = (h @ W2) * s2 in f32: as 1, one matrix, the f32 epilogue; its
//      first k-steps are in flight before its programmatic wait, h is read
//      after it (once launch 1 has finished and its stores are visible).
//   Each product's K is cut by the wrapper's plan (ops/decode_stack.
//   ffn_plan, from stack_gemv_plan with vpw 1), the merge counters those of
//   K3/K9. The columns come in tiles of 32, two to a cluster, so D and I
//   must be multiples of 64.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrappers and their plain PyTorch
// versions are ops/attention.py:decode_attention_block_int8 and
// ops/quantized.py:ffn_int8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention_onepass.cuh"
#include "decode_stack_gemv.cuh"

namespace {

constexpr int kDh = 128;  // the kernel's head width

SgMat plain(const void* q) { return SgMat{static_cast<const int32_t*>(q), nullptr}; }

}  // namespace

// One layer's plain-int8 attention block (K9). x (B, D) bf16; wqkv (D, 3D) int8 with
// wqkv_s (3D,) f32; wo (D, D) int8 with wo_s (D,) f32; k_cache/v_cache (L, S, B, H, 128)
// bf16, written at (layer, pos); starts NULL or (B,) int32; y (B, D) bf16 out.
// plans: host int32 [2][3], {split_steps, n_splits, warps} of the qkv and the
// o-proj product (ops/decode_stack.stack_gemv_plan with vpw 1). The plan's
// window [0, window) in n_splits <= 32 splits of split_len slots
// (ops/attention.attention_plan with B*H rows), the last holding slot
// window - 1; pos in [0, window), or, with pos_dev (an int32 on the device,
// which the caller keeps in [0, window): a captured step reads it at each
// replay), ignored. Scratch: qkv (B, 3D) f32, ya (B, D) bf16,
// part f32 of part_elems, at least each product's splits * B * (N + 1) when it
// has more than one split, tickets n_tickets int32 all 0 (left 0), at least
// 3D / 32; with n_splits > 1, attn_part f32 of B*H*n_splits*(128 + 2) and
// attn_tickets n_attn_tickets >= B*H int32 all 0 (left 0). Returns a
// cudaError_t.
extern "C" int mv_decode_block_int8(const void* x, const void* wqkv, const void* wqkv_s,
                                    const void* wo, const void* wo_s, void* k_cache, void* v_cache,
                                    const void* starts, void* y, int layer, int pos, const void* pos_dev,
                                    int window, int batch, int dim, int n_head, int seq_len,
                                    const void* plans, int split_len,
                                    int n_splits, void* qkv, void* ya, void* part, long long part_elems,
                                    void* tickets, int n_tickets, void* attn_part, void* attn_tickets,
                                    int n_attn_tickets, void* stream) {
  const int* plan = static_cast<const int*>(plans);
  if (batch < 1 || batch > kSgRows || n_head < 1 || n_head * kDh != dim || layer < 0 || window < 1 ||
      window > seq_len || (pos_dev == nullptr && (pos < 0 || pos >= window)) || n_splits < 1 ||
      n_splits > kCMaxSplits || split_len < 1 || (long long)n_splits * split_len < window ||
      (long long)(n_splits - 1) * split_len >= window ||
      x == nullptr || y == nullptr || plan == nullptr || wqkv_s == nullptr || wo_s == nullptr ||
      (n_splits > 1 && (attn_part == nullptr || attn_tickets == nullptr || batch * n_head > n_attn_tickets)) ||
      !sg_plan_ok(1, batch, dim, 3 * dim, 1, plan, part_elems, n_tickets) ||
      !sg_plan_ok(1, batch, dim, dim, 1, plan + 3, part_elems, n_tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qkv_f = static_cast<float*>(qkv);
  auto* ya_b = static_cast<__nv_bfloat16*>(ya);
  SgArgs q = {};
  q.x = static_cast<const __nv_bfloat16*>(x);
  q.b_rows = batch;
  q.m0 = q.m1 = plain(wqkv);
  q.col_scale = static_cast<const float*>(wqkv_s);
  q.k = dim;
  q.n = 3 * dim;
  q.split_steps = plan[0];
  q.epi = kSgF32;
  q.out_f32 = qkv_f;
  q.part = static_cast<float*>(part);
  q.tickets = static_cast<int*>(tickets);
  MV_CHECK(launch_stack_gemv<1>(q, plan, 1, s));

  MV_CHECK(attention_block<kRowBf16>(qkv_f, 3 * dim, k_cache, v_cache, nullptr, nullptr, 0,
                                     static_cast<const int*>(starts), batch, n_head, n_head, seq_len, layer,
                                     pos_dev == nullptr ? pos : window - 1, static_cast<const int*>(pos_dev),
                                     split_len, n_splits, static_cast<float*>(attn_part),
                                     static_cast<int*>(attn_tickets), ya_b, s));

  SgArgs o = q;
  o.x = ya_b;
  o.m0 = o.m1 = plain(wo);
  o.col_scale = static_cast<const float*>(wo_s);
  o.n = dim;
  o.split_steps = plan[3];
  o.epi = kSgBf16;
  o.out_f32 = nullptr;
  o.out_bf16 = static_cast<__nv_bfloat16*>(y);
  return (int)launch_stack_gemv<1>(o, plan + 3, 1, s);
}

// One layer's plain-int8 SwiGLU FFN (K10): x (B, D) bf16; w1, w3 (D, I) int8 with s1, s3
// (I,) f32; w2 (I, D) int8 with s2 (D,) f32; y (B, D) f32 out. D and I multiples of 64.
// plans: host int32 [2][3], {split_steps, n_splits, warps} of the w1/w3 and
// the w2 product (ops/decode_stack.ffn_plan with vpw 1). Scratch: h (B, I)
// bf16, part f32 of part_elems, at least 2 * splits * B * (I + 1) of w1/w3
// and, when w2 has more than one split, its splits * B * (D + 1); tickets
// n_tickets int32 all 0 (left 0), at least I / 32. Returns a cudaError_t.
extern "C" int mv_decode_ffn_int8(const void* x, const void* w1, const void* s1, const void* w3, const void* s3,
                                  const void* w2, const void* s2, void* y, int batch, int dim, int inter,
                                  const void* plans, void* h, void* part, long long part_elems, void* tickets,
                                  int n_tickets, void* stream) {
  const int* plan = static_cast<const int*>(plans);
  if (batch < 1 || batch > kSgRows || x == nullptr || y == nullptr || h == nullptr || plan == nullptr ||
      s1 == nullptr || s3 == nullptr || s2 == nullptr ||
      !sg_plan_ok(1, batch, dim, inter, 2, plan, part_elems, n_tickets) ||
      !sg_plan_ok(1, batch, inter, dim, 1, plan + 3, part_elems, n_tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  SgArgs f = {};
  f.x = static_cast<const __nv_bfloat16*>(x);
  f.b_rows = batch;
  f.m0 = plain(w1);
  f.m1 = plain(w3);
  f.col_scale = static_cast<const float*>(s1);
  f.col_scale1 = static_cast<const float*>(s3);
  f.k = dim;
  f.n = inter;
  f.split_steps = plan[0];
  f.epi = kSgSwiglu;
  f.out_bf16 = hb;
  f.part = static_cast<float*>(part);
  f.tickets = static_cast<int*>(tickets);
  MV_CHECK(launch_stack_gemv<1>(f, plan, 2, s));

  SgArgs w = f;
  w.x = hb;
  w.m0 = w.m1 = plain(w2);
  w.col_scale = static_cast<const float*>(s2);
  w.col_scale1 = nullptr;
  w.k = inter;
  w.n = dim;
  w.split_steps = plan[3];
  w.epi = kSgF32;
  w.out_bf16 = nullptr;
  w.out_f32 = static_cast<float*>(y);
  return (int)launch_stack_gemv<1>(w, plan + 3, 1, s);
}
