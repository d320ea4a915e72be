// Small device and launch helpers shared by the decode kernels:
// decode_attention.cuh (and, through it, decode_stack_gemv.cuh and
// decode_stack_int4.cu) and decode_attention_onepass.cuh (and, through it,
// decode_attention.cu, decode_attention_multi.cu, decode_block_int4.cu and
// decode_block_int8.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Return a failed call's cudaError_t from the enclosing launch sequence.
#define MV_CHECK(expr)                    \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

namespace {

// Programmatic dependent launch (Hopper): a kernel launched with the
// programmatic-stream-serialization attribute may start while the kernel
// before it on the stream still runs. pdl_wait() returns once that kernel has
// finished and its writes are visible (at once without the attribute);
// pdl_trigger() lets the next such kernel start.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) { return bf(__float2bfloat16_rn(v)); }

// Signed byte j of a word whose sign bits are flipped (w ^ 0x80808080, each
// byte q + 128) as an exact float, off the int-to-float unit: the byte placed
// in the low mantissa of 2^23 by one byte permute, minus 2^23 + 128.
__device__ __forceinline__ float sbyte_float(uint32_t flipped, int j) {
  return __int_as_float((int)__byte_perm(flipped, 0x4B000000u, 0x7540u + j)) - 8388736.0f;
}

// A kernel launched on s as a programmatic dependent of the one before it,
// with smem bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_chained(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
