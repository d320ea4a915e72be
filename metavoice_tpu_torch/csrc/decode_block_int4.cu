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
//   attention over [starts[b], pos] read back from the cache (the split
//   kernel of decode_attention.cuh, templated on the format; q * 1/sqrt(Dh)
//   in f32, rounded to bf16 for the int8 formats; query head h reads kv head
//   h / (H / H_kv)), rounded to bf16 in query-head order b * H + h;
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
// scales a slot), K6 21 MB of weights: at 3.35 TB/s about 3.5 us (K5 at pos
// 255), 8 us (K5 int8 at pos 2047) and 6.3 us (K6). A few multiply-adds per
// byte are far below the card's ~295 operations a byte.
//
// Design (simple and right first): each C entry launches a fixed sequence
// of small kernels on the caller's stream, allocates nothing and never
// synchronises. The products are the split-K GEMV of the decode stack
// (decode_gemv.cuh), whose reduce applies the epilogue (f32 out, bf16 out,
// or silu(h1) * h3 for w1 and w3 in one launch). The new row is written by
// its own small kernel before the attention launch, so stream order makes
// it visible; the attention reads it back from the cache as the TPU kernel
// does. A GQA call runs one attention block per query row, so the g query
// heads of a kv head read its tiles g times (from L2 after the first).
// K5 is 7 launches, K6 4.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrappers and their plain PyTorch
// versions are ops/attention.py:decode_attention_block_int4 and
// ops/quantized.py:decode_ffn_int4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "decode_gemv.cuh"

namespace {

constexpr int kDh = 128;  // the kernels' head width

// The step's new K (blockIdx.y 0) or V (1) row of one (batch row, kv head)
// (blockIdx.x = b * H_kv + h), read from qkv (B, D + 2 * H_kv * Dh) f32 and
// written into the cache at (layer, pos) in format FMT. One thread a value.
template <int FMT>
__global__ void __launch_bounds__(kDh)
kv_row_write(const float* __restrict__ qkv, int qout, int dim, int n_kv_head, void* k_cache,
             void* v_cache, float* k_scale, float* v_scale, int scale_width, int seq_len,
             int layer, int pos) {
  const int kv_row = blockIdx.x;
  const int bkv = gridDim.x;
  const int b = kv_row / n_kv_head;
  const int h = kv_row % n_kv_head;
  const int t = threadIdx.x;
  const bool is_v = blockIdx.y == 1;
  const float v = qkv[(size_t)b * qout + dim + (is_v ? n_kv_head * kDh : 0) + h * kDh + t];
  if constexpr (FMT == kFmtFloat) {
    __nv_bfloat16* cache = static_cast<__nv_bfloat16*>(is_v ? v_cache : k_cache);
    cache[(((size_t)layer * seq_len + pos) * bkv + kv_row) * kDh + t] = __float2bfloat16_rn(v);
  } else {
    __shared__ float s_max[kDh / 32];
    float a = fabsf(v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
    if ((t & 31) == 0) s_max[t >> 5] = a;
    __syncthreads();
    a = s_max[0];
#pragma unroll
    for (int w = 1; w < kDh / 32; ++w) a = fmaxf(a, s_max[w]);
    const float s = fmaxf(a, 1e-8f) * (float)(1.0 / 127.0);
    const int q = (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
    float* table = is_v ? v_scale : k_scale;
    size_t srow;
    if constexpr (FMT == kFmtI8) {
      int8_t* cache = static_cast<int8_t*>(is_v ? v_cache : k_cache);
      cache[(((size_t)layer * seq_len + pos) * bkv + kv_row) * kDh + t] = (int8_t)q;
      srow = (size_t)layer * seq_len + pos;
    } else {
      uint32_t* cache = static_cast<uint32_t*>(is_v ? v_cache : k_cache);
      const int sh = 8 * (pos & 3);
      uint32_t* word = cache + (((size_t)layer * (seq_len / 4) + (pos >> 2)) * bkv + kv_row) * kDh + t;
      *word = (*word & ~(0xFFu << sh)) | (((uint32_t)q & 0xFFu) << sh);
      srow = ((size_t)layer * 4 + (pos & 3)) * (seq_len / 4) + (pos >> 2);
    }
    if (t == 0) table[srow * scale_width + kv_row] = s;
  }
}

struct BlockArgs {
  const __nv_bfloat16* x;  // (B, D) normed input
  GemvMat wqkv, wo;        // this layer's
  void* k_cache;
  void* v_cache;
  float* k_scale;
  float* v_scale;
  const int* starts;
  __nv_bfloat16* y;  // (B, D) out
  int layer, pos, batch, dim, n_head, n_kv_head, seq_len, scale_width, gp, n_splits, split_len;
  float* qkv;         // (B, qout) scratch
  __nv_bfloat16* ya;  // (B, D) attention output
  float* part;        // GEMV partials
  float* part_ml;     // attention partials
  float* part_acc;
};

template <int NB, int CPT, int FMT, typename T>
cudaError_t run_block(const BlockArgs& a, cudaStream_t s) {
  const int d = a.dim;
  const int qout = d + 2 * a.n_kv_head * kDh;
  const int bkv = a.batch * a.n_kv_head;
  Epilogue eq{};
  eq.kind = kEpiF32;
  eq.out_f32 = a.qkv;
  MV_CHECK((launch_gemv<NB, CPT, 8>(a.x, a.batch, d, qout, a.gp, a.wqkv, a.wqkv, 1, a.part, eq, s)));

  kv_row_write<FMT><<<dim3(bkv, 2), kDh, 0, s>>>(a.qkv, qout, d, a.n_kv_head, a.k_cache,
                                                  a.v_cache, a.k_scale, a.v_scale,
                                                  a.scale_width, a.seq_len, a.layer, a.pos);
  MV_CHECK(cudaGetLastError());

  SplitArgs<float, T> at{};
  at.q = a.qkv;
  at.q_bstride = qout;
  at.k_new = nullptr;  // the row is in the cache already
  at.v_new = nullptr;
  at.k_cache = static_cast<T*>(a.k_cache);
  at.v_cache = static_cast<T*>(a.v_cache);
  at.starts = a.starts;
  at.n_head = a.n_head;
  at.group = a.n_head / a.n_kv_head;
  at.bkv = bkv;
  at.seq_len = a.seq_len;
  at.layer = a.layer;
  at.pos_dev = nullptr;
  at.pos = a.pos;
  at.split_len = a.split_len;
  at.scale = (float)(1.0 / sqrt((double)kDh));
  at.part_ml = a.part_ml;
  at.part_acc = a.part_acc;
  at.k_scale = a.k_scale;
  at.v_scale = a.v_scale;
  at.scale_width = a.scale_width;
  const int rows = a.batch * a.n_head;
  decode_attn_split<float, T, kDh, FMT><<<dim3(rows, a.n_splits), kThreads, 0, s>>>(at);
  MV_CHECK(cudaGetLastError());
  decode_attn_combine<__nv_bfloat16, kDh><<<rows, kDh, 0, s>>>(a.part_ml, a.part_acc, a.n_splits,
                                                               a.ya);
  MV_CHECK(cudaGetLastError());

  Epilogue eo{};
  eo.kind = kEpiBf16;
  eo.out_bf16 = a.y;
  return launch_gemv<NB, CPT, 8>(a.ya, a.batch, d, d, a.gp, a.wo, a.wo, 1, a.part, eo, s);
}

template <int FMT, typename T>
int run_block_rows(const BlockArgs& a, cudaStream_t s) {
  if (a.batch == 1) return (int)run_block<1, 4, FMT, T>(a, s);
  if (a.batch == 2) return (int)run_block<2, 4, FMT, T>(a, s);
  if (a.batch <= 4) return (int)run_block<4, 2, FMT, T>(a, s);
  return (int)run_block<8, 1, FMT, T>(a, s);
}

template <int NB, int CPT>
cudaError_t run_ffn(const __nv_bfloat16* x, GemvMat w1, GemvMat w3, GemvMat w2, float* y, int batch,
                    int dim, int ip, int gp, int gp2, __nv_bfloat16* h, float* part, cudaStream_t s) {
  Epilogue eg{};
  eg.kind = kEpiSwiglu;
  eg.out_bf16 = h;
  MV_CHECK((launch_gemv<NB, CPT, 8>(x, batch, dim, ip, gp, w1, w3, 2, part, eg, s)));
  Epilogue ef{};
  ef.kind = kEpiF32;
  ef.out_f32 = y;
  return launch_gemv<NB, CPT, 8>(h, batch, ip, dim, gp2, w2, w2, 1, part, ef, s);
}

GemvMat mat(const void* pw, const void* sc) {
  return GemvMat{static_cast<const int32_t*>(pw), static_cast<const __nv_bfloat16*>(sc)};
}

}  // namespace

// One layer's int4 attention block (K5). fmt: 0 a bf16 cache (L, S, B, H_kv, 128);
// 1 an int8 cache of the same shape with k_scale/v_scale (L, S, 1, scale_width) f32;
// 2 a packed cache (L, S/4, B, H_kv, 128) int32 with residue-split scales
// (L, 4, S/4, 1, scale_width) f32. x (B, D) bf16; wqkv_pw (L, D/8, D + 2*H_kv*128)
// i32, wqkv_sc (L, 2*gp, same) bf16; wo (L, D/8, D); starts NULL or (B,) int32;
// y (B, D) bf16 out. The caches and scales are updated in place at (layer, pos).
// Scratch: qkv (B, D + 2*H_kv*128) f32, ya (B, D) bf16, part f32 holding
// D/256 * B * (D + 2*H_kv*128) partials, part_ml (B*H*n_splits*2) and part_acc
// (B*H*n_splits*128) f32. n_splits * split_len must cover pos + 1. Returns a cudaError_t.
extern "C" int mv_decode_block_int4(
    int fmt, const void* x, const void* wqkv_pw, const void* wqkv_sc, const void* wo_pw,
    const void* wo_sc, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* starts, void* y, int layer, int pos, int batch, int dim, int n_head, int n_kv_head,
    int head_dim, int seq_len, int scale_width, int gp, int n_splits, int split_len, void* qkv,
    void* ya, void* part, void* part_ml, void* part_acc, void* stream) {
  const bool quant = fmt == kFmtI8 || fmt == kFmtPacked;
  if (fmt < kFmtFloat || fmt > kFmtPacked || batch < 1 || batch > 8 || head_dim != kDh ||
      n_kv_head < 1 || n_head % n_kv_head != 0 || n_head * kDh != dim || dim % (8 * kQGroup) != 0 ||
      gp < dim / kQGroup || layer < 0 || pos < 0 || pos >= seq_len || n_splits < 1 ||
      (long long)n_splits * split_len < pos + 1 || x == nullptr || y == nullptr ||
      (quant && (k_scale == nullptr || v_scale == nullptr || scale_width < batch * n_kv_head)) ||
      (fmt == kFmtPacked && seq_len % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int qout = dim + 2 * n_kv_head * kDh;
  BlockArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wqkv = layer_mat<8>(mat(wqkv_pw, wqkv_sc), layer, dim, qout, gp);
  a.wo = layer_mat<8>(mat(wo_pw, wo_sc), layer, dim, dim, gp);
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.starts = static_cast<const int*>(starts);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.layer = layer;
  a.pos = pos;
  a.batch = batch;
  a.dim = dim;
  a.n_head = n_head;
  a.n_kv_head = n_kv_head;
  a.seq_len = seq_len;
  a.scale_width = scale_width;
  a.gp = gp;
  a.n_splits = n_splits;
  a.split_len = split_len;
  a.qkv = static_cast<float*>(qkv);
  a.ya = static_cast<__nv_bfloat16*>(ya);
  a.part = static_cast<float*>(part);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtI8) return run_block_rows<kFmtI8, int8_t>(a, s);
  if (fmt == kFmtPacked) return run_block_rows<kFmtPacked, int32_t>(a, s);
  return run_block_rows<kFmtFloat, __nv_bfloat16>(a, s);
}

// One layer's int4 SwiGLU FFN (K6): x (B, D) bf16; w1, w3 pw (L, D/8, Ip) i32 with sc
// (L, 2*gp, Ip) bf16; w2 pw (L, Ip/8, D) with sc (L, 2*gp2, D); y (B, D) f32 out.
// Scratch: h (B, Ip) bf16, part f32 holding max(2 * D/256 * B * Ip, Ip/256 * B * D)
// partials. Returns a cudaError_t.
extern "C" int mv_decode_ffn_int4(const void* x, const void* w1_pw, const void* w1_sc,
                                  const void* w3_pw, const void* w3_sc, const void* w2_pw,
                                  const void* w2_sc, void* y, int layer, int batch, int dim, int ip,
                                  int gp, int gp2, void* h, void* part, void* stream) {
  if (batch < 1 || batch > 8 || layer < 0 || dim % (8 * kQGroup) != 0 || ip % (8 * kQGroup) != 0 ||
      gp < dim / kQGroup || gp2 < ip / kQGroup || x == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  const GemvMat w1 = layer_mat<8>(mat(w1_pw, w1_sc), layer, dim, ip, gp);
  const GemvMat w3 = layer_mat<8>(mat(w3_pw, w3_sc), layer, dim, ip, gp);
  const GemvMat w2 = layer_mat<8>(mat(w2_pw, w2_sc), layer, ip, dim, gp2);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yf = static_cast<float*>(y);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 1) return (int)run_ffn<1, 4>(xb, w1, w3, w2, yf, batch, dim, ip, gp, gp2, hb, pf, s);
  if (batch == 2) return (int)run_ffn<2, 4>(xb, w1, w3, w2, yf, batch, dim, ip, gp, gp2, hb, pf, s);
  if (batch <= 4) return (int)run_ffn<4, 2>(xb, w1, w3, w2, yf, batch, dim, ip, gp, gp2, hb, pf, s);
  return (int)run_ffn<8, 1>(xb, w1, w3, w2, yf, batch, dim, ip, gp, gp2, hb, pf, s);
}
