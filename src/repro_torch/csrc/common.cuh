// Shared helpers of the port's CUDA kernels: storage-type conversion and
// the int4 nibble extraction of the AutoGPTQ layout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (kernels/_build.py::dtype_code); int8
// payloads have entry points of their own and need no code
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Nibble i of a packed word.  The words are signed int32 in memory; the
// shift is done on the unsigned 32-bit value so the top nibble is not
// sign-extended.
__device__ __forceinline__ float nibble(uint32_t word, int i) {
  return (float)((word >> (4 * i)) & 0xFu);
}

// Zero point of column n from the column-packed qzeros row (N/8 words).
__device__ __forceinline__ float zero_point(const int32_t* qz_row, int n) {
  return nibble((uint32_t)qz_row[n >> 3], n & 7);
}
