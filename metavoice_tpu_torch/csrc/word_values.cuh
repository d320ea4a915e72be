// The values of a packed int32 weight word as exact floats, shared by the
// kernels that read the int32-word formats (matmul_int4_i32.cu,
// decode_stack_int4.cu).
#pragma once

#include <stdint.h>

// Value j of a word: the 4-bit nibble j (kVals 8, int4) or the byte j
// (kVals 4, int8), placed in the low mantissa bits of 2^23 (0x4B000000)
// with a shift and mask or one byte permute, minus 2^23. Exact, and it keeps
// the slow int-to-float unit out of the inner loops.
template <int kVals>
__device__ __forceinline__ float word_val(int32_t word, int j) {
  static_assert(kVals == 8 || kVals == 4, "int32 words hold 8 nibbles or 4 bytes");
  if constexpr (kVals == 8) {
    return __int_as_float(((word >> (4 * j)) & 0xF) | 0x4B000000) - 8388608.0f;
  } else {
    return __int_as_float((int)__byte_perm((unsigned)word, 0x4B000000u, 0x7540u + j)) - 8388608.0f;
  }
}
