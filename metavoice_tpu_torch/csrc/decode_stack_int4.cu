// One decode step through every transformer layer with weights in int32
// words, written for Hopper (sm_90a): int4 (K3, mv_decode_stack_int4) and
// int8 (K7, mv_decode_stack_int8).
//
// Replaces metavoice_tpu/ops/decode_stack.py:decode_stack_int4 with
// wfmt="i4" and wfmt="i8" (the Pallas TPU kernel _decode_stack_kernel, grid
// over layers). Per layer, for B <= 8 rows (the CFG pair on the main path):
//   RMSNorm -> int4 qkv projection (f32) -> the k/v rows, rounded to bf16,
//   written into the (L, S, B, H_kv, Dh) cache at (layer, pos) -> attention
//   over [starts[b], pos] with q * 1/sqrt(Dh) in f32 (GQA: query head h reads
//   kv head h / (H / H_kv)) -> int4 o-proj, bf16 residual add -> RMSNorm ->
//   int4 w1/w3, silu(h1) * h3 in f32 rounded to bf16 -> int4 w2, bf16
//   residual add; after the last layer, optionally, the final RMSNorm and
//   the int4 tied head -> f32 logits (B, Vp) (int4 only: the int8 mode keeps
//   the bf16 head outside). Norms: f32, rounded to bf16, then times the bf16
//   weight. The int4 products follow the TPU kernel's _int4_group_matmul:
//   per group, f32 sums of x times the raw nibbles, times s_g, plus
//   bf16(sum x_g) * c_g. The int8 products follow _int8_word_matmul: one
//   group spans K (p8 (K/4, N) words of four biased bytes; s at sc8 row 0, c
//   = -128 * s at row Gp = 8), so x @ W = s * (x @ byte) + bf16(sum x) * c.
//
// What bounds it: weight bytes. At the main-path shape (24 layers, D = 2048,
// Ip = 6144, B = 2) an int4 step streams 695 MB of packed weights and scale
// tables and 3.3 MB of packed head, an int8 step 1308 MB of packed words and
// 17 MB of sc8 tables; both read 24 * 16384 * (pos + 1) bytes of KV window
// and do about 2 (int4) or 1 (int8) multiply-adds per weight byte and row:
// far below the card's ~295 operations per byte, so the floor is
// bytes / 3.35 TB/s, about 0.21 ms (int4) and 0.40 ms (int8) at pos 0.
//
// Design (simple and right first):
//   * One C entry per step launches a fixed sequence of small kernels for
//     every layer on the caller's stream: it allocates nothing (scratch comes
//     from the wrapper) and never synchronises. pos is read on the device
//     from an int32, so the step's launches do not depend on it (the
//     attention grid is sized for the cache capacity S; splits past pos
//     write an empty partial and exit).
//   * The GEMV (decode_gemv.cuh, shared with the per-layer int4 kernels),
//     templated on the word format (VPW values a word: 8 nibbles or 4
//     bytes): a block owns 32 word rows (int4: a quarter of one 128-row
//     group in each of the 8 nibble slabs) by 32 * CPT columns; neighbouring
//     lanes read neighbouring columns' words with 16-byte loads; each thread
//     keeps one partial sum per (row of x, slab, column), so the scale is
//     applied once per block. The c term is added once per group: int4 by
//     the block holding a group's first rows, int8 by the first block, which
//     sums x over all of K. The contraction is split across blocks
//     (K/VPW/32 of them) so that even a 2048-wide output fills the SMs, and
//     a second small kernel sums the partials in a fixed order and applies
//     the epilogue: f32 out; f32 out plus the bf16 k/v row write; the bf16
//     residual add; or silu(h1) * h3.
//   * Nibbles and bytes become floats through the mantissa of 2^23
//     (word_values.cuh, exact), which avoids the slow int-to-float unit.
//   * Attention is the split-sequence device code shared with the
//     decode-attention kernel (decode_attention.cuh).
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper and its plain PyTorch
// version are in metavoice_tpu_torch/ops/decode_stack.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "decode_gemv.cuh"

namespace {

constexpr int kNormThreads = 256;
constexpr int kHeadDim = 128;

// RMSNorm of one row per block: bf16(bf16(x * rsqrt(mean(x^2) + eps)) * w).
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_rows(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ out, int d, float eps) {
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * d;
  __nv_bfloat16* orow = out + (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    const float v = bf(xr[i]);
    ss += v * v;
  }
  __shared__ float s_part[kNormThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kNormThreads / 32; ++i) total += s_part[i];
  const float inv = 1.f / sqrtf(total / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kNormThreads)
    orow[i] = __float2bfloat16_rn(round_bf16(bf(xr[i]) * inv) * bf(w[i]));
}

struct StepArgs {
  const __nv_bfloat16* x_in;
  __nv_bfloat16* x;  // the residual stream, (B, D): the output
  const __nv_bfloat16* norm1;
  const __nv_bfloat16* norm2;
  GemvMat wqkv, wo, w1, w3, w2, head;
  __nv_bfloat16* k_cache;
  __nv_bfloat16* v_cache;
  const int* pos;
  const int* starts;
  const __nv_bfloat16* ln_f;  // nullptr: no head
  float* logits;
  int n_layer, batch, dim, n_head, n_kv_head, seq_len, ip, vp, gp, gp2;
  float eps;
  int n_splits, split_len;
  __nv_bfloat16* xn;  // (B, D) normed activations
  float* qkv;         // (B, qout)
  __nv_bfloat16* ya;  // (B, D) attention output
  __nv_bfloat16* h;   // (B, Ip) SwiGLU hidden
  float* part;        // GEMV partials
  float* part_ml;     // attention partials
  float* part_acc;
};

template <int NB, int CPT, int VPW>
cudaError_t gemv(const StepArgs& a, const __nv_bfloat16* x, int k, int n, int gp, GemvMat m0,
                 GemvMat m1, int n_mats, const Epilogue& e, cudaStream_t s) {
  return launch_gemv<NB, CPT, VPW>(x, a.batch, k, n, gp, m0, m1, n_mats, a.part, e, s);
}

template <int NB, int CPT, int VPW>
cudaError_t run_step(const StepArgs& a, cudaStream_t s) {
  const int d = a.dim;
  const int dkv = a.n_kv_head * kHeadDim;
  const int qout = d + 2 * dkv;
  MV_CHECK(cudaMemcpyAsync(a.x, a.x_in, sizeof(__nv_bfloat16) * a.batch * d,
                           cudaMemcpyDeviceToDevice, s));
  Epilogue none{};
  for (int l = 0; l < a.n_layer; ++l) {
    rmsnorm_rows<<<a.batch, kNormThreads, 0, s>>>(a.x, a.norm1 + (size_t)l * d, a.xn, d, a.eps);
    MV_CHECK(cudaGetLastError());

    Epilogue eq = none;
    eq.kind = kEpiQKV;
    eq.out_f32 = a.qkv;
    eq.k_cache = a.k_cache;
    eq.v_cache = a.v_cache;
    eq.pos = a.pos;
    eq.layer = l;
    eq.seq_len = a.seq_len;
    eq.d = d;
    eq.dkv = dkv;
    const GemvMat wqkv = layer_mat<VPW>(a.wqkv, l, d, qout, a.gp);
    MV_CHECK((gemv<NB, CPT, VPW>(a, a.xn, d, qout, a.gp, wqkv, wqkv, 1, eq, s)));

    SplitArgs<float, __nv_bfloat16> at;
    at.q = a.qkv;
    at.q_bstride = qout;
    at.k_new = nullptr;
    at.v_new = nullptr;
    at.k_cache = a.k_cache;
    at.v_cache = a.v_cache;
    at.starts = a.starts;
    at.n_head = a.n_head;
    at.group = a.n_head / a.n_kv_head;
    at.bkv = a.batch * a.n_kv_head;
    at.seq_len = a.seq_len;
    at.layer = l;
    at.pos_dev = a.pos;
    at.pos = 0;
    at.split_len = a.split_len;
    at.scale = (float)(1.0 / sqrt((double)kHeadDim));
    at.part_ml = a.part_ml;
    at.part_acc = a.part_acc;
    const int rows = a.batch * a.n_head;
    decode_attn_split<float, __nv_bfloat16, kHeadDim>
        <<<dim3(rows, a.n_splits), kThreads, 0, s>>>(at);
    MV_CHECK(cudaGetLastError());
    decode_attn_combine<__nv_bfloat16, kHeadDim>
        <<<rows, kHeadDim, 0, s>>>(a.part_ml, a.part_acc, a.n_splits, a.ya);
    MV_CHECK(cudaGetLastError());

    Epilogue er = none;
    er.kind = kEpiResid;
    er.out_bf16 = a.x;
    const GemvMat wo = layer_mat<VPW>(a.wo, l, d, d, a.gp);
    MV_CHECK((gemv<NB, CPT, VPW>(a, a.ya, d, d, a.gp, wo, wo, 1, er, s)));

    rmsnorm_rows<<<a.batch, kNormThreads, 0, s>>>(a.x, a.norm2 + (size_t)l * d, a.xn, d, a.eps);
    MV_CHECK(cudaGetLastError());

    Epilogue eg = none;
    eg.kind = kEpiSwiglu;
    eg.out_bf16 = a.h;
    MV_CHECK((gemv<NB, CPT, VPW>(a, a.xn, d, a.ip, a.gp, layer_mat<VPW>(a.w1, l, d, a.ip, a.gp),
                                 layer_mat<VPW>(a.w3, l, d, a.ip, a.gp), 2, eg, s)));

    const GemvMat w2 = layer_mat<VPW>(a.w2, l, a.ip, d, a.gp2);
    MV_CHECK((gemv<NB, CPT, VPW>(a, a.h, a.ip, d, a.gp2, w2, w2, 1, er, s)));
  }
  if (a.ln_f != nullptr) {
    rmsnorm_rows<<<a.batch, kNormThreads, 0, s>>>(a.x, a.ln_f, a.xn, d, a.eps);
    MV_CHECK(cudaGetLastError());
    Epilogue ef = none;
    ef.kind = kEpiF32;
    ef.out_f32 = a.logits;
    MV_CHECK((gemv<NB, CPT, VPW>(a, a.xn, d, a.vp, a.gp, a.head, a.head, 1, ef, s)));
  }
  return cudaSuccess;
}

// The step's arguments, checked, or false. vpw: 8 (int4) or 4 (int8).
bool make_args(StepArgs& a, int vpw, const void* x_in, void* x_out, const void* norm1,
               const void* norm2, const void* const (&mats)[10], void* k_cache, void* v_cache,
               const void* pos, const void* starts, const void* ln_f, const void* head_pw,
               const void* head_sc, void* logits, int n_layer, int batch, int dim, int n_head,
               int n_kv_head, int head_dim, int seq_len, int ip, int vp, int gp, int gp2,
               float eps, int n_splits, int split_len, void* const (&scratch)[7]) {
  const bool with_head = ln_f != nullptr;
  const bool int4 = vpw == 8;
  if (n_layer < 1 || batch < 1 || batch > 8 || head_dim != kHeadDim || n_kv_head < 1 ||
      n_head % n_kv_head != 0 || n_head * head_dim != dim || dim % (8 * kQGroup) != 0 ||
      ip % (8 * kQGroup) != 0 || gp < (int4 ? dim / kQGroup : 1) ||
      gp2 < (int4 ? ip / kQGroup : 1) || n_splits < 1 || split_len < 1 ||
      (long long)n_splits * split_len < seq_len || pos == nullptr ||
      (with_head && (!int4 || head_pw == nullptr || head_sc == nullptr || logits == nullptr ||
                     vp < 128 || vp % 128 != 0)))
    return false;
  a.x_in = static_cast<const __nv_bfloat16*>(x_in);
  a.x = static_cast<__nv_bfloat16*>(x_out);
  a.norm1 = static_cast<const __nv_bfloat16*>(norm1);
  a.norm2 = static_cast<const __nv_bfloat16*>(norm2);
  auto mat = [](const void* pw, const void* sc) {
    return GemvMat{static_cast<const int32_t*>(pw), static_cast<const __nv_bfloat16*>(sc)};
  };
  a.wqkv = mat(mats[0], mats[1]);
  a.wo = mat(mats[2], mats[3]);
  a.w1 = mat(mats[4], mats[5]);
  a.w3 = mat(mats[6], mats[7]);
  a.w2 = mat(mats[8], mats[9]);
  a.head = mat(head_pw, head_sc);
  a.k_cache = static_cast<__nv_bfloat16*>(k_cache);
  a.v_cache = static_cast<__nv_bfloat16*>(v_cache);
  a.pos = static_cast<const int*>(pos);
  a.starts = static_cast<const int*>(starts);
  a.ln_f = static_cast<const __nv_bfloat16*>(ln_f);
  a.logits = static_cast<float*>(logits);
  a.n_layer = n_layer;
  a.batch = batch;
  a.dim = dim;
  a.n_head = n_head;
  a.n_kv_head = n_kv_head;
  a.seq_len = seq_len;
  a.ip = ip;
  a.vp = vp;
  a.gp = gp;
  a.gp2 = gp2;
  a.eps = eps;
  a.n_splits = n_splits;
  a.split_len = split_len;
  a.xn = static_cast<__nv_bfloat16*>(scratch[0]);
  a.qkv = static_cast<float*>(scratch[1]);
  a.ya = static_cast<__nv_bfloat16*>(scratch[2]);
  a.h = static_cast<__nv_bfloat16*>(scratch[3]);
  a.part = static_cast<float*>(scratch[4]);
  a.part_ml = static_cast<float*>(scratch[5]);
  a.part_acc = static_cast<float*>(scratch[6]);
  return true;
}

template <int VPW>
int run_step_rows(const StepArgs& a, cudaStream_t s) {
  if (a.batch == 1) return (int)run_step<1, 4, VPW>(a, s);
  if (a.batch == 2) return (int)run_step<2, 4, VPW>(a, s);
  if (a.batch <= 4) return (int)run_step<4, 2, VPW>(a, s);
  return (int)run_step<8, 1, VPW>(a, s);
}

}  // namespace

// One int4 decode step of every layer (K3). Shapes (all contiguous on the device):
//   x_in, x_out (B, D) bf16; norm1, norm2 (L, D) bf16;
//   wqkv_pw (L, D/8, D + 2*H_kv*128) i32 and wqkv_sc (L, 2*gp, same) bf16; wo (L, D/8, D);
//   w1, w3 (L, D/8, Ip); w2_pw (L, Ip/8, D) with w2_sc (L, 2*gp2, D);
//   k_cache, v_cache (L, S, B, H_kv, 128) bf16, updated in place at (layer, *pos);
//   pos: one int32; starts: NULL or (B,) int32;
//   ln_f (D,) bf16, head_pw (D/8, Vp), head_sc (2*gp, Vp), logits (B, Vp) f32,
//   or all four NULL for no head;
// scratch: xn (B, D) bf16, qkv (B, D + 2*H_kv*128) f32, ya (B, D) bf16, h (B, Ip) bf16,
//   part f32 holding the largest GEMV's 2 * K/8/32 * B * N partials,
//   part_ml (B*H*n_splits*2) and part_acc (B*H*n_splits*128) f32.
// n_splits * split_len must cover S. Returns a cudaError_t.
extern "C" int mv_decode_stack_int4(
    const void* x_in, void* x_out, const void* norm1, const void* norm2, const void* wqkv_pw,
    const void* wqkv_sc, const void* wo_pw, const void* wo_sc, const void* w1_pw,
    const void* w1_sc, const void* w3_pw, const void* w3_sc, const void* w2_pw,
    const void* w2_sc, void* k_cache, void* v_cache, const void* pos, const void* starts,
    const void* ln_f, const void* head_pw, const void* head_sc, void* logits, int n_layer,
    int batch, int dim, int n_head, int n_kv_head, int head_dim, int seq_len, int ip, int vp,
    int gp, int gp2, float eps, int n_splits, int split_len, void* xn, void* qkv, void* ya,
    void* h, void* part, void* part_ml, void* part_acc, void* stream) {
  const void* const mats[10] = {wqkv_pw, wqkv_sc, wo_pw, wo_sc, w1_pw,
                                w1_sc,   w3_pw,   w3_sc, w2_pw, w2_sc};
  void* const scratch[7] = {xn, qkv, ya, h, part, part_ml, part_acc};
  StepArgs a;
  if (!make_args(a, 8, x_in, x_out, norm1, norm2, mats, k_cache, v_cache, pos, starts, ln_f,
                 head_pw, head_sc, logits, n_layer, batch, dim, n_head, n_kv_head, head_dim,
                 seq_len, ip, vp, gp, gp2, eps, n_splits, split_len, scratch))
    return (int)cudaErrorInvalidValue;
  return run_step_rows<8>(a, static_cast<cudaStream_t>(stream));
}

// One int8 decode step of every layer (K7), no head. Shapes as for
// mv_decode_stack_int4, with the int8 words: wqkv_p8 (L, D/4, D + 2*H_kv*128)
// i32, wo (L, D/4, D), w1, w3 (L, D/4, Ip), w2_p8 (L, Ip/4, D); every sc8
// (L, 2*gp, N) bf16 with s at row 0 and c at row gp (gp2 for w2); part f32
// holding the largest GEMV's 2 * K/4/32 * B * N partials. Returns a
// cudaError_t.
extern "C" int mv_decode_stack_int8(
    const void* x_in, void* x_out, const void* norm1, const void* norm2, const void* wqkv_p8,
    const void* wqkv_sc8, const void* wo_p8, const void* wo_sc8, const void* w1_p8,
    const void* w1_sc8, const void* w3_p8, const void* w3_sc8, const void* w2_p8,
    const void* w2_sc8, void* k_cache, void* v_cache, const void* pos, const void* starts,
    int n_layer, int batch, int dim, int n_head, int n_kv_head, int head_dim, int seq_len, int ip,
    int gp, int gp2, float eps, int n_splits, int split_len, void* xn, void* qkv, void* ya,
    void* h, void* part, void* part_ml, void* part_acc, void* stream) {
  const void* const mats[10] = {wqkv_p8, wqkv_sc8, wo_p8, wo_sc8, w1_p8,
                                w1_sc8,  w3_p8,    w3_sc8, w2_p8, w2_sc8};
  void* const scratch[7] = {xn, qkv, ya, h, part, part_ml, part_acc};
  StepArgs a;
  if (!make_args(a, 4, x_in, x_out, norm1, norm2, mats, k_cache, v_cache, pos, starts, nullptr,
                 nullptr, nullptr, nullptr, n_layer, batch, dim, n_head, n_kv_head, head_dim,
                 seq_len, ip, 0, gp, gp2, eps, n_splits, split_len, scratch))
    return (int)cudaErrorInvalidValue;
  return run_step_rows<4>(a, static_cast<cudaStream_t>(stream));
}
