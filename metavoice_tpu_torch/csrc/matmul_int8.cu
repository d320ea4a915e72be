// The plain-int8 weight-only matmul, K11 (mv_matmul_int8), written for
// Hopper (sm_90a).
//
// Replaces metavoice_tpu/ops/quantized.py:matmul_int8 (the Pallas TPU kernel
// _int8_matmul_kernel): the projections of quantisation_mode="int8_plain"
// outside K9/K10 (prefill, the speculative verify, GQA and quantized-cache
// decode, FFNs off K10's grid, batched CFG rows above 8). q (K, N) int8
// row-major with one f32 scale per column:
//     y = (bf16(x) @ q) * s, in x's dtype (bf16 or f32),
// the int8 values exact in bf16, the products summed in f32 over all of K,
// then times the column's scale once and cast, as the TPU kernel orders it.
// The scale is never folded into a weight (that would round it).
//
// What bounds it: one layer's five projections (2048 x 6144, 2048 x 2048,
// 2048 x 5632 twice, 5632 x 2048) read 51.4 MB of int8 weights. At M = 2
// (a decode step of the CFG pair) and at the 16 and 32 rows of the
// speculative verify and batched CFG rows, those bytes: about 15.4 us at
// 3.35 TB/s. At M = 256 (prefill: the CFG pair x a 128-token bucket), 26.3
// GFLOP: about 27 us on the bf16 tensor cores.
//
// Design, one launch a call either way; the wrapper
// (ops/quantized.matmul_int8) picks the route and its cut:
//   * Up to 8 rows with K a multiple of 16 and N of 64
//     (ops/quantized.int8_gemv_ok): the tensor-core GEMV of
//     decode_stack_gemv.cuh in its plain-int8 form, one matrix, no norm
//     (stack_gemv<1>, as K9's o-proj and K10's w2): mma.sync with the
//     weights as A and the rows of x as B, a lane's 4 columns one 4-byte
//     word a row staged by cp.async, the signed bytes made exact bf16 by a
//     byte permute, K cut by ops/decode_stack.stack_gemv_plan, the splits
//     merged in a fixed order by the last block of a 32-column tile, the
//     column scale applied after the merge, then the bf16 or f32 epilogue.
//   * Any other call: the ring of tensor-core tiles (int4g_ring_kernel,
//     matmul_ring.cuh, shared with K12/K13, its format kRgQ8): TMA copies of
//     x and w, each byte converted once a block by the producer warpgroup
//     (plain_pair: a byte permute, two lop3 and one bf16x2 subtract a pair,
//     no scales or zeros staged), wgmma from 64 rows (mma.sync at 16 and 32),
//     K split by ops/quantized.int8_tile_plan (K11's own constants of the
//     ring's model: 256-row tiles at M 256 where the K split fills the card,
//     each weight converted once), the column scale applied to the sum of
//     all of K (in the consumers with one split, in the merging block with
//     more). More than 256 rows take more row tiles.
//   What holds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): on the
//   ring the producers' conversion at 16 and 128 rows and the tensor cores'
//   shared-memory reads at 256, about equal there, then the splits' partial
//   writes and merge (qkv at M 256: the loops end at 15.8 us, the merging
//   blocks at 28.9); on the GEMV, as for K9/K10, a chain of dependent phases
//   a launch.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper and its plain PyTorch
// version are ops/quantized.py:matmul_int8 and matmul_int8_reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_stack_gemv.cuh"
#include "matmul_ring.cuh"

// x: (m, k) bf16; q: (k, n) int8; scales: (n,) f32; y: (m, n) bf16 (out_bf16 1) or f32
// (out_bf16 0); all contiguous on the device, x, q and scales at 16-byte boundaries. k a
// multiple of 8, n of 16. gemv_steps > 0 takes the GEMV (m <= 8, k a multiple of 16, n of 64):
// K in gemv_splits splits of gemv_steps k-steps of 16 (ops/decode_stack.stack_gemv_plan with
// vpw 1); with more than one split part f32 of part_elems >= gemv_splits * m * (n + 1), and
// tickets, n_tickets >= n / 32 int32 all 0 (left 0). gemv_steps 0 takes the ring (the plan,
// ops/quantized.int8_tile_plan): mt m16 tiles a block's rows (1, 2, 4, 8 or 16), split_chunks
// staged blocks of 64 rows of q a split; with more than one split part, (splits, m, n) f32, and
// tickets, n_tickets >= the tiles (row x column), int32 all 0 (left 0). Returns a cudaError_t.
extern "C" int mv_matmul_int8(const void* x, const void* q, const void* scales, void* y, int m, int k, int n,
                              int out_bf16, int gemv_steps, int gemv_splits, int mt, int split_chunks, void* part,
                              long long part_elems, void* tickets, int n_tickets, void* stream) {
  if (m < 1 || k < 8 || k % 8 != 0 || n < 16 || n % 16 != 0 || gemv_steps < 0 || x == nullptr || q == nullptr ||
      scales == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gemv_steps > 0) {
    const int plan[3] = {gemv_steps, gemv_splits, kSgWarps};
    if (!sg_plan_ok(1, m, k, n, 1, plan, part_elems, n_tickets)) return (int)cudaErrorInvalidValue;
    SgArgs g = {};
    g.x = static_cast<const __nv_bfloat16*>(x);
    g.b_rows = m;
    g.m0 = g.m1 = SgMat{static_cast<const int32_t*>(q), nullptr};
    g.col_scale = static_cast<const float*>(scales);
    g.k = k;
    g.n = n;
    g.split_steps = gemv_steps;
    g.epi = out_bf16 ? kSgBf16 : kSgF32;
    if (out_bf16) {
      g.out_bf16 = static_cast<__nv_bfloat16*>(y);
    } else {
      g.out_f32 = static_cast<float*>(y);
    }
    g.part = static_cast<float*>(part);
    g.tickets = static_cast<int*>(tickets);
    return (int)launch_stack_gemv<1>(g, plan, 1, s);
  }
  const RgArgs a{static_cast<const float*>(scales), nullptr, y, static_cast<float*>(part), static_cast<int*>(tickets),
                 m, k, n, 1, out_bf16, split_chunks, 0};
  return rg_run<kRgQ8>(static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q), a, mt, n_tickets, s);
}
