// Shared helpers for the hand-written Hopper kernels of cyclegan_tpu_torch.
//
// Every kernel is exported through a plain C interface (loaded with ctypes):
// pointers and the stream arrive as void*, sizes as int, and each entry point
// returns cudaGetLastError() right after its launch so the Python wrapper can
// raise on a refused launch. Kernels are templated on float and
// __nv_bfloat16, accumulate in f32 and store in the input type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's cast
}

// Grid size for a grid-stride loop over n elements with `threads` per block:
// enough blocks to fill the card several times over, never more than needed.
inline int grid_for(size_t n, int threads) {
  size_t blocks = (n + threads - 1) / threads;
  const size_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

// Whether a pointer may be read or written in 16-byte units
inline bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
