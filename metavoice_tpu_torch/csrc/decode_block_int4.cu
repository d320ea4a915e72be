// One decode layer's int4 attention block (K5, mv_decode_block_int4) and
// int4 SwiGLU FFN (K6, mv_decode_ffn_int4), written for Hopper (sm_90a).
//
// Replaces metavoice_tpu/ops/attention.py:decode_attention_block_int4 (the
// Pallas TPU kernel _decode_block_int4_kernel) and
// metavoice_tpu/ops/quantized.py:decode_ffn_int4 (_ffn_int4_kernel): the
// per-layer int4 decode route, which serves a quantized KV cache (and an
// int4 stage that misses the decode stack's conditions only on its norms).
//
// K5, for B <= 8 rows of the normed input x (B, D) bf16:
//   qkv = x @ Wqkv in f32 (int4 group arithmetic: per group, f32 sums of x
//   times the raw nibbles, times s_g, plus bf16(sum x_g) * c_g);
//   the new K/V row written at (layer, pos) in the cache's format: a bf16
//   cache gets bf16(row); an int8 cache the row quantized per (batch row,
//   kv head) from f32, s = max(absmax, 1e-8) * f32(1/127), q = clip(
//   round_half_even(row / s), -127, 127), with s in the scale table; the
//   packed cache merges byte pos % 4 into word pos // 4, keeping the word's
//   other bytes, and writes s to residue row pos % 4, column pos // 4;
//   attention over [starts[b], pos] (q * 1/sqrt(Dh) in f32, rounded to bf16
//   for the int8 formats; query head h reads kv head h / (H / H_kv)),
//   rounded to bf16 in query-head order b * H + h;
//   y = y_attn @ Wo, rounded to bf16.
// K6: h = bf16(silu(x @ W1) * (x @ W3)) with silu and the product in f32;
//   y = h @ W2 in f32.
// Weights are stacked over layers: pw (L, K/8, N) int32, sc (L, 2*gp, N)
// bf16; the C entries index the layer.
//
// What bounds them: the packed weight bytes and, for K5, the cache window.
// At the main-path shape (D = 2048, 16 heads, B = 2, FFN packed to 6144) K5
// reads 9.4 MB of weights and scales and 2 * (pos + 1) * B * H_kv * Dh
// cache values (1 byte each in the int8 formats, 2 in bf16, plus 8 bytes of
// scales a slot), K6 21 MB of weights: at 3.35 TB/s about 3.3 us (K5 int8
// at pos 255), 7.8 us (K5 int8 at pos 2047) and 6.0 us (K6). A few
// multiply-adds per byte are far below the card's ~295 operations a byte.
//
// K5's design: three kernels on the caller's stream, each launched as a
// programmatic dependent of the one before (it loads its weights, or its
// first cache tiles, before griddepcontrol.wait); it allocates nothing and
// never synchronises.
//   1. qkv = x @ Wqkv: the tensor-core GEMV of the decode stack
//      (decode_stack_gemv.cuh, int4 words, no norm), f32 out, K cut by the
//      wrapper's plan (ops/decode_stack.stack_gemv_plan), the split merge
//      inside the launch.
//   2. Attention: the one-pass kernel of K1 (decode_attention_onepass.cuh,
//      attn_row_kernel, one block a query head and split, the window cut by
//      ops/attention.attention_plan, the splits merged behind a ticket). The
//      split that holds pos makes the new row in the cache's format from the
//      f32 qkv itself and writes it; the int8 and packed tiles widen in
//      registers on the CUDA cores.
//   3. y = ya @ Wo: as 1, the bf16 epilogue.
// What holds it (NVIDIA H100 80GB HBM3, 700 W; int8 cache at pos 255, mean
// profiled time of each kernel, which overlap): qkv product 9.5 us,
// attention 8.4, o-proj 10.5, 16.7 us from a call's first start to its
// last end against 3.3 us of bytes. The three kernels depend on each other,
// each product runs a prologue of dependent phases before its first mma,
// and the attention's 256 slots are one split on 32 SMs (latency).
//
// K6's design: two kernels on the caller's stream, the second a
// programmatic dependent of the first; it allocates nothing and never
// synchronises.
//   1. h = bf16(silu(x @ W1) * (x @ W3)): one launch of the tensor-core
//      GEMV (int4 words, no norm, grid z 2: w1 and w3 side by side), the
//      SwiGLU epilogue applied by the last block of each column tile after
//      the fixed-order merge of both matrices' partials.
//   2. y = h @ W2 in f32: as 1, one matrix, the f32 epilogue; it loads its
//      first weights before its programmatic wait and reads h after it
//      (the wait returns once launch 1 has finished and its stores are
//      visible).
//   Each product's K is cut by the wrapper's plan (ops/decode_stack.
//   ffn_plan, from stack_gemv_plan), the merge counters those of K3/K5.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrappers and their plain PyTorch
// versions are ops/attention.py:decode_attention_block_int4 and
// ops/quantized.py:decode_ffn_int4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention_onepass.cuh"
#include "decode_stack_gemv.cuh"

namespace {

constexpr int kDh = 128;  // the kernels' head width

SgMat mat(const void* pw, const void* sc) {
  return SgMat{static_cast<const int32_t*>(pw), static_cast<const __nv_bfloat16*>(sc)};
}

}  // namespace

// One layer's int4 attention block (K5). fmt (CacheFmt, decode_attention.cuh):
// kFmtFloat (0) a bf16 cache (L, S, B, H_kv, 128); kFmtI8 (1) an int8 cache of the
// same shape with k_scale/v_scale (L, S, 1, scale_width) f32; kFmtPacked (2) a packed cache (L, S/4, B, H_kv, 128) int32 with residue-split scales
// (L, 4, S/4, 1, scale_width) f32. x (B, D) bf16; wqkv_pw (L, D/8, D + 2*H_kv*128)
// i32, wqkv_sc (L, 2*gp, same) bf16; wo (L, D/8, D); starts NULL or (B,) int32;
// y (B, D) bf16 out. The caches and scales are updated in place at (layer, pos).
// plans: host int32 [2][3], {split_steps, n_splits, warps} of the qkv and the
// o-proj product (ops/decode_stack.stack_gemv_plan). The plan's window
// [0, window) in n_splits <= 32 splits of split_len slots (ops/attention.
// attention_plan with B*H rows), the last holding slot window - 1; pos in
// [0, window), or, with pos_dev (an int32 on the device, which the caller
// keeps in [0, window): a captured step reads it at each replay), ignored. Scratch: qkv (B, D + 2*H_kv*128) f32, ya (B, D) bf16, part f32 of
// part_elems, at least each product's splits * B * (N + 1) when it has more
// than one split, tickets n_tickets int32 all 0 (left 0), at least N / 32 of
// the qkv product; with n_splits > 1, attn_part f32 of B*H*n_splits*(128 + 2)
// and attn_tickets n_attn_tickets >= B*H int32 all 0 (left 0). Returns a
// cudaError_t.
extern "C" int mv_decode_block_int4(
    int fmt, const void* x, const void* wqkv_pw, const void* wqkv_sc, const void* wo_pw,
    const void* wo_sc, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* starts, void* y, int layer, int pos, const void* pos_dev, int window, int batch, int dim,
    int n_head, int n_kv_head, int head_dim, int seq_len, int scale_width, int gp, const void* plans,
    int split_len, int n_splits,
    void* qkv, void* ya, void* part, long long part_elems, void* tickets, int n_tickets, void* attn_part,
    void* attn_tickets, int n_attn_tickets, void* stream) {
  const bool quant = fmt == kFmtI8 || fmt == kFmtPacked;
  const int qout = dim + 2 * n_kv_head * kDh;
  const int* plan = static_cast<const int*>(plans);
  if ((fmt != kFmtFloat && !quant) || batch < 1 || batch > kSgRows || head_dim != kDh || n_kv_head < 1 ||
      n_head % n_kv_head != 0 || n_head * kDh != dim || dim % (8 * kSgQGroup) != 0 || gp < dim / kSgQGroup ||
      layer < 0 || window < 1 || window > seq_len || (pos_dev == nullptr && (pos < 0 || pos >= window)) ||
      n_splits < 1 || n_splits > kCMaxSplits || split_len < 1 || (long long)n_splits * split_len < window ||
      (long long)(n_splits - 1) * split_len >= window ||
      x == nullptr || y == nullptr || plan == nullptr ||
      (quant && (k_scale == nullptr || v_scale == nullptr || scale_width < batch * n_kv_head)) ||
      (fmt == kFmtPacked && seq_len % 4 != 0) ||
      (n_splits > 1 && (attn_part == nullptr || attn_tickets == nullptr || batch * n_head > n_attn_tickets)) ||
      !sg_plan_ok(8, batch, dim, qout, 1, plan, part_elems, n_tickets) ||
      !sg_plan_ok(8, batch, dim, dim, 1, plan + 3, part_elems, n_tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qkv_f = static_cast<float*>(qkv);
  auto* ya_b = static_cast<__nv_bfloat16*>(ya);
  SgArgs q = {};
  q.x = static_cast<const __nv_bfloat16*>(x);
  q.b_rows = batch;
  q.m0 = q.m1 = layer_mat<8>(mat(wqkv_pw, wqkv_sc), layer, dim, qout, gp);
  q.k = dim;
  q.n = qout;
  q.gp = gp;
  q.split_steps = plan[0];
  q.epi = kSgF32;
  q.out_f32 = qkv_f;
  q.part = static_cast<float*>(part);
  q.tickets = static_cast<int*>(tickets);
  MV_CHECK(launch_stack_gemv<8>(q, plan, 1, s));

  const int* st = static_cast<const int*>(starts);
  auto* ap = static_cast<float*>(attn_part);
  auto* at = static_cast<int*>(attn_tickets);
  auto* ks = static_cast<float*>(k_scale);
  auto* vs = static_cast<float*>(v_scale);
  const int* pd = static_cast<const int*>(pos_dev);
  const int slot = pd == nullptr ? pos : window - 1;  // with pos_dev: the window's last slot
#define MV_ATTN(NEW)                                                                                       \
  attention_block<NEW>(qkv_f, qout, k_cache, v_cache, ks, vs, scale_width, st, batch, n_head, n_kv_head, \
                       seq_len, layer, slot, pd, split_len, n_splits, ap, at, ya_b, s)
  // the cache format as the attention's new-row kind
  MV_CHECK(fmt == kFmtFloat ? MV_ATTN(kRowBf16) : fmt == kFmtI8 ? MV_ATTN(kRowI8) : MV_ATTN(kRowPacked));
#undef MV_ATTN

  SgArgs o = q;
  o.x = ya_b;
  o.m0 = o.m1 = layer_mat<8>(mat(wo_pw, wo_sc), layer, dim, dim, gp);
  o.n = dim;
  o.split_steps = plan[3];
  o.epi = kSgBf16;
  o.out_f32 = nullptr;
  o.out_bf16 = static_cast<__nv_bfloat16*>(y);
  return (int)launch_stack_gemv<8>(o, plan + 3, 1, s);
}

// One layer's int4 SwiGLU FFN (K6): x (B, D) bf16; w1, w3 pw (L, D/8, Ip) i32 with sc
// (L, 2*gp, Ip) bf16; w2 pw (L, Ip/8, D) with sc (L, 2*gp2, D); y (B, D) f32 out.
// plans: host int32 [2][3], {split_steps, n_splits, warps} of the w1/w3 and
// the w2 product (ops/decode_stack.ffn_plan). Scratch: h (B, Ip) bf16, part
// f32 of part_elems, at least 2 * splits * B * (Ip + 1) of w1/w3 and, when
// w2 has more than one split, its splits * B * (D + 1); tickets n_tickets
// int32 all 0 (left 0), at least Ip / 32. Returns a cudaError_t.
extern "C" int mv_decode_ffn_int4(const void* x, const void* w1_pw, const void* w1_sc, const void* w3_pw,
                                  const void* w3_sc, const void* w2_pw, const void* w2_sc, void* y, int layer,
                                  int batch, int dim, int ip, int gp, int gp2, const void* plans, void* h,
                                  void* part, long long part_elems, void* tickets, int n_tickets, void* stream) {
  const int* plan = static_cast<const int*>(plans);
  if (batch < 1 || batch > kSgRows || layer < 0 || dim % (8 * kSgQGroup) != 0 || ip % (8 * kSgQGroup) != 0 ||
      gp < dim / kSgQGroup || gp2 < ip / kSgQGroup || x == nullptr || y == nullptr || h == nullptr ||
      plan == nullptr || !sg_plan_ok(8, batch, dim, ip, 2, plan, part_elems, n_tickets) ||
      !sg_plan_ok(8, batch, ip, dim, 1, plan + 3, part_elems, n_tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  SgArgs f = {};
  f.x = static_cast<const __nv_bfloat16*>(x);
  f.b_rows = batch;
  f.m0 = layer_mat<8>(mat(w1_pw, w1_sc), layer, dim, ip, gp);
  f.m1 = layer_mat<8>(mat(w3_pw, w3_sc), layer, dim, ip, gp);
  f.k = dim;
  f.n = ip;
  f.gp = gp;
  f.split_steps = plan[0];
  f.epi = kSgSwiglu;
  f.out_bf16 = hb;
  f.part = static_cast<float*>(part);
  f.tickets = static_cast<int*>(tickets);
  MV_CHECK(launch_stack_gemv<8>(f, plan, 2, s));

  SgArgs w = f;
  w.x = hb;
  w.m0 = w.m1 = layer_mat<8>(mat(w2_pw, w2_sc), layer, ip, dim, gp2);
  w.k = ip;
  w.n = dim;
  w.gp = gp2;
  w.split_steps = plan[3];
  w.epi = kSgF32;
  w.out_bf16 = nullptr;
  w.out_f32 = static_cast<float*>(y);
  return (int)launch_stack_gemv<8>(w, plan + 3, 1, s);
}
