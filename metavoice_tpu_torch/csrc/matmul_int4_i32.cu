// int4-in-int32 weight-only matmul for prefill (K2), written for Hopper (sm_90a).
//
// Replaces metavoice_tpu/ops/quantized.py:matmul_int4_i32 (the Pallas TPU
// kernel _prefill_int4_kernel). y (M, N) f32 = x (M, K) bf16 @ W, where W is
// the packed serving format: pw (K/8, N) int32 holds eight biased nibbles a
// word in the "split-eighth" layout (bits [4j, 4j+4) of word (k', n) are row
// j*K/8 + k'), and sc (2*Gp, N) bf16 holds the group scales s and constants c.
// Per K-group g of 128 rows the product is
//     y += s_g * (x_g @ nib_g) + bf16(sum x_g) * c_g,
// with the raw nibbles 0..15 exact in bf16 and x_g @ nib_g summed in f32.
//
// What bounds it: at the main-path shape (M = 256, the CFG pair times a
// 128-token prompt bucket; K x N of 2048 x 6144) a call is 6.4 GFLOP against
// 14 MB of operands, so the tensor cores (989 TFLOP/s bf16) and not the
// memory set the bound, at about 6.5 us.
//
// Design (simple and right first; no TMA, no wgmma, no pipelining yet):
//   * One block of 8 warps computes a 64 x 128 output tile with mma.sync
//     m16n8k16 bf16 -> f32; each warp owns a 32 x 32 sub-tile.
//   * For each 128-row block of word rows, the block stages the words once in
//     shared memory and walks the 8 groups they hold (one per nibble slab):
//     for each group it stages the matching 64 x 128 slice of x, takes the
//     rows' group sums in f32 (rounded to bf16, as the TPU kernel feeds them
//     to its c-term dot), and runs the group's 8 k-steps, building each B
//     fragment from the staged words (shift, mask, convert to bf16x2).
//   * The group's f32 fragment is scaled by s_g and the c-term added in
//     registers, so the affine terms never touch the per-weight path.
//   * Shared-memory rows are padded so that fragment loads are free of bank
//     conflicts.
//
// Plain C entry point (no PyTorch headers), loaded with ctypes by
// metavoice_tpu_torch/ops/_build.py; the wrapper and its plain PyTorch
// version are in metavoice_tpu_torch/ops/quantized.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;           // quantization groupsize (rows of K per group)
constexpr int kBM = 64;               // output rows per block
constexpr int kBN = 128;              // output columns per block
constexpr int kThreads = 256;         // 8 warps: 2 along M x 4 along N
constexpr int kXStride = kGroup + 8;  // bf16 per staged x row (pad: conflict-free A loads)
constexpr int kWStride = kBN + 4;     // words per staged weight row (pad: conflict-free B loads)
constexpr size_t kSmemBytes =
    sizeof(int32_t) * kGroup * kWStride + sizeof(__nv_bfloat16) * kBM * kXStride + sizeof(float) * kBM;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float nib(int32_t word, int shift) {
  return (float)((word >> shift) & 0xF);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
matmul_int4_i32_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ pw,
                       const __nv_bfloat16* __restrict__ sc, float* __restrict__ y, int m, int k,
                       int n, int gp) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* w_s = reinterpret_cast<int32_t*>(smem);  // [kGroup][kWStride]
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(w_s + kGroup * kWStride);  // [kBM][kXStride]
  float* xsum_s = reinterpret_cast<float*>(x_s + kBM * kXStride);                  // [kBM]

  const int k8 = k / 8;
  const int n_grp_slab = k8 / kGroup;  // groups per nibble slab
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // which 32-row half of the tile
  const int wn = warp >> 1;  // which 32-column quarter
  const int gid = lane >> 2;
  const int tig = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int tm = 0; tm < 2; ++tm)
#pragma unroll
    for (int tn = 0; tn < 4; ++tn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tm][tn][e] = 0.f;

  for (int mb = 0; mb < n_grp_slab; ++mb) {
    __syncthreads();  // the previous word block's readers are done
    for (int i = tid; i < kGroup * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4);
      const int c4 = (i % (kBN / 4)) * 4;
      int4 v = make_int4(0, 0, 0, 0);
      if (col0 + c4 < n)  // n % 8 == 0, so a 4-word vector is all in or all out
        v = *reinterpret_cast<const int4*>(pw + (size_t)(mb * kGroup + r) * n + col0 + c4);
      *reinterpret_cast<int4*>(w_s + r * kWStride + c4) = v;
    }

    for (int j = 0; j < 8; ++j) {
      const int g = j * n_grp_slab + mb;  // the group nibble j of these words belongs to
      const int shift = 4 * j;
      __syncthreads();  // words staged; the previous group's readers are done
      for (int i = tid; i < kBM * (kGroup / 8); i += kThreads) {
        const int r = i / (kGroup / 8);
        const int c8 = (i % (kGroup / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row0 + r < m)
          v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * k + g * kGroup + c8);
        *reinterpret_cast<uint4*>(x_s + r * kXStride + c8) = v;
      }
      __syncthreads();

      {  // the rows' group sums: 4 threads a row, f32, rounded to bf16
        const int r = tid >> 2;
        const int part = tid & 3;
        float s = 0.f;
#pragma unroll 8
        for (int c = part * 32; c < part * 32 + 32; ++c) s += __bfloat162float(x_s[r * kXStride + c]);
        s += __shfl_xor_sync(kFull, s, 1);
        s += __shfl_xor_sync(kFull, s, 2);
        if (part == 0) xsum_s[r] = __bfloat162float(__float2bfloat16_rn(s));
      }

      float accg[2][4][4];
#pragma unroll
      for (int tm = 0; tm < 2; ++tm)
#pragma unroll
        for (int tn = 0; tn < 4; ++tn)
#pragma unroll
          for (int e = 0; e < 4; ++e) accg[tm][tn][e] = 0.f;

#pragma unroll 2
      for (int kk = 0; kk < kGroup; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int tm = 0; tm < 2; ++tm) {
          const __nv_bfloat16* base = x_s + (wm * 32 + tm * 16 + gid) * kXStride + kk + tig * 2;
          a[tm][0] = *reinterpret_cast<const uint32_t*>(base);
          a[tm][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kXStride);
          a[tm][2] = *reinterpret_cast<const uint32_t*>(base + 8);
          a[tm][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kXStride + 8);
        }
#pragma unroll
        for (int tn = 0; tn < 4; ++tn) {
          const int32_t* wb = w_s + (kk + tig * 2) * kWStride + wn * 32 + tn * 8 + gid;
          uint32_t b[2];
          b[0] = pack_bf16x2(nib(wb[0], shift), nib(wb[kWStride], shift));
          b[1] = pack_bf16x2(nib(wb[8 * kWStride], shift), nib(wb[9 * kWStride], shift));
#pragma unroll
          for (int tm = 0; tm < 2; ++tm) mma_bf16(accg[tm][tn], a[tm], b);
        }
      }
      __syncthreads();  // xsum_s is written

#pragma unroll
      for (int tn = 0; tn < 4; ++tn) {
        const int col = col0 + wn * 32 + tn * 8 + tig * 2;
        float s0 = 0.f, s1 = 0.f, c0 = 0.f, c1 = 0.f;
        if (col < n) {
          s0 = __bfloat162float(sc[(size_t)g * n + col]);
          s1 = __bfloat162float(sc[(size_t)g * n + col + 1]);
          c0 = __bfloat162float(sc[(size_t)(gp + g) * n + col]);
          c1 = __bfloat162float(sc[(size_t)(gp + g) * n + col + 1]);
        }
#pragma unroll
        for (int tm = 0; tm < 2; ++tm) {
          const int r = wm * 32 + tm * 16 + gid;
          const float xs0 = xsum_s[r];
          const float xs1 = xsum_s[r + 8];
          acc[tm][tn][0] += accg[tm][tn][0] * s0 + xs0 * c0;
          acc[tm][tn][1] += accg[tm][tn][1] * s1 + xs0 * c1;
          acc[tm][tn][2] += accg[tm][tn][2] * s0 + xs1 * c0;
          acc[tm][tn][3] += accg[tm][tn][3] * s1 + xs1 * c1;
        }
      }
    }
  }

#pragma unroll
  for (int tm = 0; tm < 2; ++tm) {
#pragma unroll
    for (int tn = 0; tn < 4; ++tn) {
      const int col = col0 + wn * 32 + tn * 8 + tig * 2;
      const int r = row0 + wm * 32 + tm * 16 + gid;
      if (col >= n) continue;
      if (r < m) *reinterpret_cast<float2*>(y + (size_t)r * n + col) = make_float2(acc[tm][tn][0], acc[tm][tn][1]);
      if (r + 8 < m)
        *reinterpret_cast<float2*>(y + (size_t)(r + 8) * n + col) = make_float2(acc[tm][tn][2], acc[tm][tn][3]);
    }
  }
}

}  // namespace

// x: (m, k) bf16, pw: (k/8, n) int32, sc: (2*gp, n) bf16, y: (m, n) f32, all
// contiguous on the device. k must be a multiple of 1024 (8 slabs of whole
// 128-row groups) and n a multiple of 8. Returns a cudaError_t.
extern "C" int mv_matmul_int4_i32(const void* x, const void* pw, const void* sc, void* y, int m,
                                  int k, int n, int gp, void* stream) {
  if (m < 1 || k < 8 * kGroup || k % (8 * kGroup) != 0 || n < 8 || n % 8 != 0 || gp < k / kGroup)
    return (int)cudaErrorInvalidValue;
  // above 48 KB of shared memory a kernel must opt in, on each device it runs on
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_int4_i32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_int4_i32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(pw),
      static_cast<const __nv_bfloat16*>(sc), static_cast<float*>(y), m, k, n, gp);
  return (int)cudaGetLastError();
}
