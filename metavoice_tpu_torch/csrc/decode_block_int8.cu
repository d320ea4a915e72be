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
//   f32 sums, times the column scale);
//   the new K and V rows written as bf16(qkv) at (layer, pos) of the bf16
//   (L, S, B, H, Dh) cache (in the reduce's epilogue);
//   attention over [starts[b], pos] read back from the cache (the split
//   kernel of decode_attention.cuh: q * 1/sqrt(Dh) in f32, f32 scores and
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
// Design (simple and right first): each C entry launches a fixed sequence of
// small kernels on the caller's stream, allocates nothing and never
// synchronises. The products are the split-K CUDA-core GEMV over the plain
// layout (gemv8_partial in decode_gemv.cuh): a lane's 16-byte load is 16
// neighbouring columns at one k; the fixed-order reduce applies the column
// scale and the epilogue (the qkv row write, bf16 out, or silu(h1) * h3 for
// w1 and w3 in one launch). The attention is K1's split kernel, reading the
// new row back from the cache as the TPU kernel does. K9 is 6 launches, K10
// 4.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrappers and their plain PyTorch
// versions are ops/attention.py:decode_attention_block_int8 and
// ops/quantized.py:ffn_int8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "decode_gemv.cuh"

namespace {

constexpr int kDh = 128;  // the kernel's head width

struct Block8Args {
  const __nv_bfloat16* x;  // (B, D) normed input
  const int8_t* wqkv;      // (D, 3D)
  const float* wqkv_s;     // (3D,)
  const int8_t* wo;        // (D, D)
  const float* wo_s;       // (D,)
  __nv_bfloat16* k_cache;  // (L, S, B, H, Dh)
  __nv_bfloat16* v_cache;
  const int* starts;
  __nv_bfloat16* y;  // (B, D) out
  int layer, pos, batch, dim, n_head, seq_len, n_splits, split_len;
  float* qkv;         // (B, 3D) scratch
  __nv_bfloat16* ya;  // (B, D) attention output
  float* part;        // GEMV partials
  float* part_ml;     // attention partials
  float* part_acc;
};

template <int NB, int CPL>
cudaError_t run_block8(const Block8Args& a, cudaStream_t s) {
  const int d = a.dim;
  Epilogue eq{};
  eq.kind = kEpiQKV;
  eq.out_f32 = a.qkv;
  eq.scale0 = a.wqkv_s;
  eq.k_cache = a.k_cache;
  eq.v_cache = a.v_cache;
  eq.pos = nullptr;
  eq.pos_host = a.pos;
  eq.layer = a.layer;
  eq.seq_len = a.seq_len;
  eq.d = d;
  eq.dkv = d;
  MV_CHECK((launch_gemv8<NB, CPL>(a.x, a.batch, d, 3 * d, a.wqkv, a.wqkv, 1, a.part, eq, s)));

  SplitArgs<float, __nv_bfloat16> at{};
  at.q = a.qkv;
  at.q_bstride = 3 * d;
  at.k_new = nullptr;  // the row is in the cache already
  at.v_new = nullptr;
  at.k_cache = a.k_cache;
  at.v_cache = a.v_cache;
  at.starts = a.starts;
  at.n_head = a.n_head;
  at.group = 1;
  at.bkv = a.batch * a.n_head;
  at.seq_len = a.seq_len;
  at.layer = a.layer;
  at.pos_dev = nullptr;
  at.pos = a.pos;
  at.split_len = a.split_len;
  at.scale = (float)(1.0 / sqrt((double)kDh));
  at.part_ml = a.part_ml;
  at.part_acc = a.part_acc;
  const int rows = a.batch * a.n_head;
  decode_attn_split<float, __nv_bfloat16, kDh, kFmtFloat><<<dim3(rows, a.n_splits), kThreads, 0, s>>>(at);
  MV_CHECK(cudaGetLastError());
  decode_attn_combine<__nv_bfloat16, kDh><<<rows, kDh, 0, s>>>(a.part_ml, a.part_acc, a.n_splits,
                                                               a.ya);
  MV_CHECK(cudaGetLastError());

  Epilogue eo{};
  eo.kind = kEpiBf16;
  eo.out_bf16 = a.y;
  eo.scale0 = a.wo_s;
  return launch_gemv8<NB, CPL>(a.ya, a.batch, d, d, a.wo, a.wo, 1, a.part, eo, s);
}

template <int NB, int CPL>
cudaError_t run_ffn8(const __nv_bfloat16* x, const int8_t* w1, const float* s1, const int8_t* w3,
                     const float* s3, const int8_t* w2, const float* s2, float* y, int batch, int dim,
                     int inter, __nv_bfloat16* h, float* part, cudaStream_t s) {
  Epilogue eg{};
  eg.kind = kEpiSwiglu;
  eg.out_bf16 = h;
  eg.scale0 = s1;
  eg.scale1 = s3;
  MV_CHECK((launch_gemv8<NB, CPL>(x, batch, dim, inter, w1, w3, 2, part, eg, s)));
  Epilogue ef{};
  ef.kind = kEpiF32;
  ef.out_f32 = y;
  ef.scale0 = s2;
  return launch_gemv8<NB, CPL>(h, batch, inter, dim, w2, w2, 1, part, ef, s);
}

}  // namespace

// One layer's plain-int8 attention block (K9). x (B, D) bf16; wqkv (D, 3D) int8 with
// wqkv_s (3D,) f32; wo (D, D) int8 with wo_s (D,) f32; k_cache/v_cache (L, S, B, H, 128)
// bf16, written at (layer, pos); starts NULL or (B,) int32; y (B, D) bf16 out.
// Scratch: qkv (B, 3D) f32, ya (B, D) bf16, part f32 holding ceil(D/64) * B * 3D
// partials, part_ml (B*H*n_splits*2) and part_acc (B*H*n_splits*128) f32.
// n_splits * split_len must cover pos + 1. Returns a cudaError_t.
extern "C" int mv_decode_block_int8(const void* x, const void* wqkv, const void* wqkv_s,
                                    const void* wo, const void* wo_s, void* k_cache, void* v_cache,
                                    const void* starts, void* y, int layer, int pos, int batch,
                                    int dim, int n_head, int seq_len, int n_splits, int split_len,
                                    void* qkv, void* ya, void* part, void* part_ml, void* part_acc,
                                    void* stream) {
  if (batch < 1 || batch > 8 || n_head < 1 || n_head * kDh != dim || layer < 0 || pos < 0 ||
      pos >= seq_len || n_splits < 1 || (long long)n_splits * split_len < pos + 1 ||
      x == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  Block8Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wqkv = static_cast<const int8_t*>(wqkv);
  a.wqkv_s = static_cast<const float*>(wqkv_s);
  a.wo = static_cast<const int8_t*>(wo);
  a.wo_s = static_cast<const float*>(wo_s);
  a.k_cache = static_cast<__nv_bfloat16*>(k_cache);
  a.v_cache = static_cast<__nv_bfloat16*>(v_cache);
  a.starts = static_cast<const int*>(starts);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.layer = layer;
  a.pos = pos;
  a.batch = batch;
  a.dim = dim;
  a.n_head = n_head;
  a.seq_len = seq_len;
  a.n_splits = n_splits;
  a.split_len = split_len;
  a.qkv = static_cast<float*>(qkv);
  a.ya = static_cast<__nv_bfloat16*>(ya);
  a.part = static_cast<float*>(part);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 1) return (int)run_block8<1, 16>(a, s);
  if (batch == 2) return (int)run_block8<2, 16>(a, s);
  if (batch <= 4) return (int)run_block8<4, 16>(a, s);
  return (int)run_block8<8, 8>(a, s);
}

// One layer's plain-int8 SwiGLU FFN (K10): x (B, D) bf16; w1, w3 (D, I) int8 with s1, s3
// (I,) f32; w2 (I, D) int8 with s2 (D,) f32; y (B, D) f32 out. D and I multiples of 16.
// Scratch: h (B, I) bf16, part f32 holding max(2 * ceil(D/64) * B * I, ceil(I/64) * B * D)
// partials. Returns a cudaError_t.
extern "C" int mv_decode_ffn_int8(const void* x, const void* w1, const void* s1, const void* w3,
                                  const void* s3, const void* w2, const void* s2, void* y,
                                  int batch, int dim, int inter, void* h, void* part,
                                  void* stream) {
  if (batch < 1 || batch > 8 || dim < 16 || dim % 16 != 0 || inter < 16 || inter % 16 != 0 ||
      x == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* q1 = static_cast<const int8_t*>(w1);
  const auto* q3 = static_cast<const int8_t*>(w3);
  const auto* q2 = static_cast<const int8_t*>(w2);
  const auto* f1 = static_cast<const float*>(s1);
  const auto* f3 = static_cast<const float*>(s3);
  const auto* f2 = static_cast<const float*>(s2);
  auto* yf = static_cast<float*>(y);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 1) return (int)run_ffn8<1, 16>(xb, q1, f1, q3, f3, q2, f2, yf, batch, dim, inter, hb, pf, s);
  if (batch == 2) return (int)run_ffn8<2, 16>(xb, q1, f1, q3, f3, q2, f2, yf, batch, dim, inter, hb, pf, s);
  if (batch <= 4) return (int)run_ffn8<4, 16>(xb, q1, f1, q3, f3, q2, f2, yf, batch, dim, inter, hb, pf, s);
  return (int)run_ffn8<8, 8>(xb, q1, f1, q3, f3, q2, f2, yf, batch, dim, inter, hb, pf, s);
}
