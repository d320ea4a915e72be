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
// Design:
//   * One C entry per step launches six kernels a layer on the caller's
//     stream, and one more for the head: the qkv product (RMSNorm in its
//     prologue; f32 q, the bf16 k/v row written at (layer, pos)), the
//     attention split and combine, the o-proj (bf16 residual add), w1 and w3
//     in one launch (RMSNorm; silu(h1) * h3 rounded to bf16) and w2 (bf16
//     residual add); the head's product takes ln_f in its prologue. It
//     allocates nothing (scratch and the plans of K's cut come from the
//     wrapper) and never synchronises; pos is read on the device from an
//     int32, so the launches do not depend on it (the attention grid is
//     sized for the cache capacity S; splits past pos write an empty
//     partial and exit). Layer 0 reads x_in and writes x_out, so no copy
//     starts the step.
//   * The products are decode_stack_gemv.cuh: tensor-core mma.sync over the
//     raw nibbles or bytes, converted exactly off the int-to-float unit, the
//     split-K partials merged inside the launch by the last block of a
//     column tile.
//   * Every kernel is launched as a programmatic dependent of the one before
//     (cudaLaunchKernelEx with programmatic stream serialization): a product
//     loads its first weights before it waits for the kernel before it, and
//     each kernel lets the next one start once it has read its inputs. The
//     chain holds under a CUDA-graph capture.
//   * Attention is the split-sequence device code of decode_attention.cuh
//     (K3 and K7 its only users), in its chained form.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper and its plain PyTorch
// version are in metavoice_tpu_torch/ops/decode_stack.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "decode_stack_gemv.cuh"
#include "device_common.cuh"

namespace {

constexpr int kHeadDim = 128;
constexpr int kPlans = 5;  // qkv, o-proj, w1/w3, w2, head: {split_steps, n_splits, warps} each
enum { kPlanQKV = 0, kPlanO = 1, kPlanW13 = 2, kPlanW2 = 3, kPlanHead = 4 };

struct StepArgs {
  const __nv_bfloat16* x_in;
  __nv_bfloat16* x;  // the residual stream, (B, D): the output
  const __nv_bfloat16* norm1;
  const __nv_bfloat16* norm2;
  SgMat wqkv, wo, w1, w3, w2, head;
  __nv_bfloat16* k_cache;
  __nv_bfloat16* v_cache;
  const int* pos;
  const int* starts;
  const __nv_bfloat16* ln_f;  // nullptr: no head
  float* logits;
  int n_layer, batch, dim, n_head, n_kv_head, seq_len, ip, vp, gp, gp2;
  float eps;
  int n_splits, split_len;
  float* qkv;         // (B, qout)
  __nv_bfloat16* ya;  // (B, D) attention output
  __nv_bfloat16* h;   // (B, Ip) SwiGLU hidden
  float* part;        // the products' split partials
  float* ssq;         // (B, D / 32) sums of squares of the residual stream by tile
  float* part_ml;     // attention partials
  float* part_acc;
  int* tickets;
  const int* plans;   // [kPlans][3]
};

template <int VPW>
cudaError_t run_step(const StepArgs& a, cudaStream_t s) {
  const int d = a.dim;
  const int dkv = a.n_kv_head * kHeadDim;
  const int qout = d + 2 * dkv;
  float* ssq = d / kSgCols <= kSgMaxSsTiles ? a.ssq : nullptr;  // the residual's sums of squares by tile
  SgArgs base = {};
  base.eps = a.eps;
  base.b_rows = a.batch;
  base.part = a.part;
  base.tickets = a.tickets;
  for (int l = 0; l < a.n_layer; ++l) {
    const __nv_bfloat16* xr = l == 0 ? a.x_in : a.x;  // the layer's residual input

    SgArgs q = base;
    q.x = xr;
    q.norm_w = a.norm1 + (size_t)l * d;
    q.ss_in = l == 0 ? nullptr : ssq;  // layer 0: x_in's own
    q.m0 = q.m1 = layer_mat<VPW>(a.wqkv, l, d, qout, a.gp);
    q.k = d;
    q.n = qout;
    q.gp = a.gp;
    q.split_steps = a.plans[3 * kPlanQKV];
    q.epi = kSgQKV;
    q.out_f32 = a.qkv;
    q.k_cache = a.k_cache;
    q.v_cache = a.v_cache;
    q.pos = a.pos;
    q.layer = l;
    q.seq_len = a.seq_len;
    q.d = d;
    q.dkv = dkv;
    MV_CHECK(launch_stack_gemv<VPW>(q, a.plans + 3 * kPlanQKV, 1, s));

    SplitArgs<float, __nv_bfloat16> at = {};
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
    MV_CHECK(launch_chained(decode_attn_split<float, __nv_bfloat16, kHeadDim, kFmtFloat, true>,
                            dim3(rows, a.n_splits), dim3(kThreads), 0, s, at));
    MV_CHECK(launch_chained(decode_attn_combine<__nv_bfloat16, kHeadDim, true>, dim3(rows), dim3(kHeadDim), 0, s,
                            (const float*)a.part_ml, (const float*)a.part_acc, a.n_splits, a.ya));

    SgArgs o = base;
    o.x = a.ya;
    o.m0 = o.m1 = layer_mat<VPW>(a.wo, l, d, d, a.gp);
    o.k = d;
    o.n = d;
    o.gp = a.gp;
    o.split_steps = a.plans[3 * kPlanO];
    o.epi = kSgResid;
    o.resid = xr;
    o.out_bf16 = a.x;
    o.ss_out = ssq;
    MV_CHECK(launch_stack_gemv<VPW>(o, a.plans + 3 * kPlanO, 1, s));

    SgArgs f = base;
    f.x = a.x;
    f.norm_w = a.norm2 + (size_t)l * d;
    f.ss_in = ssq;
    f.m0 = layer_mat<VPW>(a.w1, l, d, a.ip, a.gp);
    f.m1 = layer_mat<VPW>(a.w3, l, d, a.ip, a.gp);
    f.k = d;
    f.n = a.ip;
    f.gp = a.gp;
    f.split_steps = a.plans[3 * kPlanW13];
    f.epi = kSgSwiglu;
    f.out_bf16 = a.h;
    MV_CHECK(launch_stack_gemv<VPW>(f, a.plans + 3 * kPlanW13, 2, s));

    SgArgs w = base;
    w.x = a.h;
    w.m0 = w.m1 = layer_mat<VPW>(a.w2, l, a.ip, d, a.gp2);
    w.k = a.ip;
    w.n = d;
    w.gp = a.gp2;
    w.split_steps = a.plans[3 * kPlanW2];
    w.epi = kSgResid;
    w.resid = a.x;
    w.out_bf16 = a.x;
    w.ss_out = ssq;
    MV_CHECK(launch_stack_gemv<VPW>(w, a.plans + 3 * kPlanW2, 1, s));
  }
  if (a.ln_f != nullptr) {
    SgArgs hd = base;
    hd.x = a.x;
    hd.norm_w = a.ln_f;
    hd.ss_in = ssq;
    hd.m0 = hd.m1 = a.head;
    hd.k = d;
    hd.n = a.vp;
    hd.gp = a.gp;
    hd.split_steps = a.plans[3 * kPlanHead];
    hd.epi = kSgF32;
    hd.out_f32 = a.logits;
    MV_CHECK(launch_stack_gemv<VPW>(hd, a.plans + 3 * kPlanHead, 1, s));
  }
  return cudaSuccess;
}

// The step's arguments, checked, or false. vpw: 8 (int4) or 4 (int8).
bool make_args(StepArgs& a, int vpw, const void* x_in, void* x_out, const void* norm1,
               const void* norm2, const void* const (&mats)[10], void* k_cache, void* v_cache,
               const void* pos, const void* starts, const void* ln_f, const void* head_pw,
               const void* head_sc, void* logits, int n_layer, int batch, int dim, int n_head,
               int n_kv_head, int head_dim, int seq_len, int ip, int vp, int gp, int gp2,
               float eps, int n_splits, int split_len, void* const (&scratch)[7], long long part_elems,
               void* tickets, int n_tickets, const int* plans) {
  const bool with_head = ln_f != nullptr;
  const bool int4 = vpw == 8;
  if (n_layer < 1 || batch < 1 || batch > kSgRows || head_dim != kHeadDim || n_kv_head < 1 ||
      n_head % n_kv_head != 0 || n_head * head_dim != dim || dim % (8 * kSgQGroup) != 0 ||
      ip % (8 * kSgQGroup) != 0 || gp < (int4 ? dim / kSgQGroup : 1) ||
      gp2 < (int4 ? ip / kSgQGroup : 1) || n_splits < 1 || split_len < 1 ||
      (long long)n_splits * split_len < seq_len || pos == nullptr || plans == nullptr ||
      (with_head && (!int4 || head_pw == nullptr || head_sc == nullptr || logits == nullptr ||
                     vp < 128 || vp % 128 != 0)))
    return false;
  const int qout = dim + 2 * n_kv_head * head_dim;
  if (!sg_plan_ok(vpw, batch, dim, qout, 1, plans + 3 * kPlanQKV, part_elems, n_tickets) ||
      !sg_plan_ok(vpw, batch, dim, dim, 1, plans + 3 * kPlanO, part_elems, n_tickets) ||
      !sg_plan_ok(vpw, batch, dim, ip, 2, plans + 3 * kPlanW13, part_elems, n_tickets) ||
      !sg_plan_ok(vpw, batch, ip, dim, 1, plans + 3 * kPlanW2, part_elems, n_tickets) ||
      (with_head && !sg_plan_ok(vpw, batch, dim, vp, 1, plans + 3 * kPlanHead, part_elems, n_tickets)))
    return false;
  a.x_in = static_cast<const __nv_bfloat16*>(x_in);
  a.x = static_cast<__nv_bfloat16*>(x_out);
  a.norm1 = static_cast<const __nv_bfloat16*>(norm1);
  a.norm2 = static_cast<const __nv_bfloat16*>(norm2);
  auto mat = [](const void* pw, const void* sc) {
    return SgMat{static_cast<const int32_t*>(pw), static_cast<const __nv_bfloat16*>(sc)};
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
  a.qkv = static_cast<float*>(scratch[0]);
  a.ya = static_cast<__nv_bfloat16*>(scratch[1]);
  a.h = static_cast<__nv_bfloat16*>(scratch[2]);
  a.part = static_cast<float*>(scratch[3]);
  a.ssq = static_cast<float*>(scratch[4]);
  a.part_ml = static_cast<float*>(scratch[5]);
  a.part_acc = static_cast<float*>(scratch[6]);
  a.tickets = static_cast<int*>(tickets);
  a.plans = plans;
  return true;
}

// Every nibble and byte value through the products' conversions, for the
// card tests: thread t takes words whose nibble j is (t + j) mod 16 (w0) and
// (t / 16 + 3 j) mod 16 (w1), and whose byte j is (t + j) mod 256 (w0) and
// (7 t + 3 j) mod 256 (w1).
__global__ void stack_values(uint32_t* nib, uint32_t* byte) {
  const uint32_t t = threadIdx.x;
  uint32_t w0 = 0, w1 = 0, b0 = 0, b1 = 0;
  for (int j = 0; j < 8; ++j) {
    w0 |= ((t + j) % 16) << (4 * j);
    w1 |= ((t / 16 + 3 * j) % 16) << (4 * j);
  }
  for (int j = 0; j < 4; ++j) {
    b0 |= ((t + j) % 256) << (8 * j);
    b1 |= ((7 * t + 3 * j) % 256) << (8 * j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t lo, hi;
    sg_nibble_pairs(w0, w1, j, lo, hi);
    nib[(t * 4 + j) * 2] = lo;
    nib[(t * 4 + j) * 2 + 1] = hi;
    byte[t * 4 + j] = sg_byte_pair(b0, b1, j);
  }
}

}  // namespace

// The conversions' results for the card tests: nib (256, 4, 2) and byte
// (256, 4) uint32 bf16 pairs, thread t's words as stack_values says: nib[t, j]
// holds slabs 2 j and 2 j + 1 (the pair w0's, w1's nibble), byte[t, j] byte
// lane j. Returns a cudaError_t.
extern "C" int mv_decode_stack_values(void* nib, void* byte, void* stream) {
  stack_values<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(nib),
                                                                  static_cast<uint32_t*>(byte));
  return (int)cudaGetLastError();
}

// One int4 decode step of every layer (K3). Shapes (all contiguous on the device):
//   x_in, x_out (B, D) bf16; norm1, norm2 (L, D) bf16;
//   wqkv_pw (L, D/8, D + 2*H_kv*128) i32 and wqkv_sc (L, 2*gp, same) bf16; wo (L, D/8, D);
//   w1, w3 (L, D/8, Ip); w2_pw (L, Ip/8, D) with w2_sc (L, 2*gp2, D);
//   k_cache, v_cache (L, S, B, H_kv, 128) bf16, updated in place at (layer, *pos);
//   pos: one int32; starts: NULL or (B,) int32;
//   ln_f (D,) bf16, head_pw (D/8, Vp), head_sc (2*gp, Vp), logits (B, Vp) f32,
//   or all four NULL for no head;
// scratch: qkv (B, D + 2*H_kv*128) f32, ya (B, D) bf16, h (B, Ip) bf16, part f32
//   of part_elems, at least every product's mats * splits * B * (N + 1), ssq
//   (B, D / 32) f32,
//   part_ml (B*H*n_splits*2) and part_acc (B*H*n_splits*128) f32, tickets
//   n_tickets int32 all 0 (left 0), at least the widest product's N / 32;
// plans: host int32 [5][3], {split_steps, n_splits, warps} of the qkv, o-proj,
//   w1/w3, w2 and head products (ops/decode_stack.stack_gemv_plan; the head's
//   unread without a head).
// n_splits * split_len must cover S. Returns a cudaError_t (cudaErrorInvalidValue
// for arguments or a plan the kernels cannot run).
extern "C" int mv_decode_stack_int4(
    const void* x_in, void* x_out, const void* norm1, const void* norm2, const void* wqkv_pw,
    const void* wqkv_sc, const void* wo_pw, const void* wo_sc, const void* w1_pw,
    const void* w1_sc, const void* w3_pw, const void* w3_sc, const void* w2_pw,
    const void* w2_sc, void* k_cache, void* v_cache, const void* pos, const void* starts,
    const void* ln_f, const void* head_pw, const void* head_sc, void* logits, int n_layer,
    int batch, int dim, int n_head, int n_kv_head, int head_dim, int seq_len, int ip, int vp,
    int gp, int gp2, float eps, int n_splits, int split_len, void* qkv, void* ya, void* h,
    void* part, long long part_elems, void* ssq, void* part_ml, void* part_acc, void* tickets,
    int n_tickets, const void* plans, void* stream) {
  const void* const mats[10] = {wqkv_pw, wqkv_sc, wo_pw, wo_sc, w1_pw,
                                w1_sc,   w3_pw,   w3_sc, w2_pw, w2_sc};
  void* const scratch[7] = {qkv, ya, h, part, ssq, part_ml, part_acc};
  StepArgs a;
  if (!make_args(a, 8, x_in, x_out, norm1, norm2, mats, k_cache, v_cache, pos, starts, ln_f,
                 head_pw, head_sc, logits, n_layer, batch, dim, n_head, n_kv_head, head_dim,
                 seq_len, ip, vp, gp, gp2, eps, n_splits, split_len, scratch, part_elems, tickets,
                 n_tickets, static_cast<const int*>(plans)))
    return (int)cudaErrorInvalidValue;
  return (int)run_step<8>(a, static_cast<cudaStream_t>(stream));
}

// One int8 decode step of every layer (K7), no head. Shapes as for
// mv_decode_stack_int4, with the int8 words: wqkv_p8 (L, D/4, D + 2*H_kv*128)
// i32, wo (L, D/4, D), w1, w3 (L, D/4, Ip), w2_p8 (L, Ip/4, D); every sc8
// (L, 2*gp, N) bf16 with s at row 0 and c at row gp (gp2 for w2); plans as
// there, the head's unread. Returns a cudaError_t.
extern "C" int mv_decode_stack_int8(
    const void* x_in, void* x_out, const void* norm1, const void* norm2, const void* wqkv_p8,
    const void* wqkv_sc8, const void* wo_p8, const void* wo_sc8, const void* w1_p8,
    const void* w1_sc8, const void* w3_p8, const void* w3_sc8, const void* w2_p8,
    const void* w2_sc8, void* k_cache, void* v_cache, const void* pos, const void* starts,
    int n_layer, int batch, int dim, int n_head, int n_kv_head, int head_dim, int seq_len, int ip,
    int gp, int gp2, float eps, int n_splits, int split_len, void* qkv, void* ya, void* h,
    void* part, long long part_elems, void* ssq, void* part_ml, void* part_acc, void* tickets,
    int n_tickets, const void* plans, void* stream) {
  const void* const mats[10] = {wqkv_p8, wqkv_sc8, wo_p8, wo_sc8, w1_p8,
                                w1_sc8,  w3_p8,    w3_sc8, w2_p8, w2_sc8};
  void* const scratch[7] = {qkv, ya, h, part, ssq, part_ml, part_acc};
  StepArgs a;
  if (!make_args(a, 4, x_in, x_out, norm1, norm2, mats, k_cache, v_cache, pos, starts, nullptr,
                 nullptr, nullptr, nullptr, n_layer, batch, dim, n_head, n_kv_head, head_dim,
                 seq_len, ip, 0, gp, gp2, eps, n_splits, split_len, scratch, part_elems, tickets,
                 n_tickets, static_cast<const int*>(plans)))
    return (int)cudaErrorInvalidValue;
  return (int)run_step<4>(a, static_cast<cudaStream_t>(stream));
}
