// Row units of the kernels that walk NHCW rows with no per-element index:
// K3 sum2x2, K4 concat_up2, K7 dup2x2 and K8 split_pool2.
//
// In NHCW a row (b, i) holds its C channels' W columns back to back, so
// column 2j + s of channel c sits at c W + 2j + s = 2 (c W/2 + j) + s: the
// nearest 2x column upsample of a row is the row with every element twice,
// and its adjoint sums neighbouring element pairs. A kernel's thread moves
// one unit of a row; the unit's element count, a template argument, picks
// the path: 16 or 8 bytes (the vector path, every access aligned to its
// width) or one element (the element path).
#pragma once

#include "common.cuh"

// dst[0, VS) = src[0, VS), VS elements of T: one element or 16 bytes
template <typename T, int VS>
__device__ __forceinline__ void copy_unit(T* dst, const T* src) {
  if constexpr (VS * sizeof(T) == 16) {
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  } else {
    *dst = *src;
  }
}

// two bf16 in a word, each times s in f32 and rounded once (as from_f32)
__device__ __forceinline__ unsigned int scale_bf16x2(unsigned int w,
                                                     float s) {
  const float lo = __uint_as_float(w << 16) * s;
  const float hi = __uint_as_float(w & 0xffff0000u) * s;
  return (unsigned int)__bfloat16_as_ushort(from_f32<__nv_bfloat16>(lo)) |
         ((unsigned int)__bfloat16_as_ushort(from_f32<__nv_bfloat16>(hi))
          << 16);
}

// a[0, 2 VX) = b[0, 2 VX) = src[0, VX) with every element twice, each
// times scale in f32 and rounded once to T where SCALED (else its bits);
// VX elements of T: one element or 8 bytes
template <typename T, int VX, bool SCALED = false>
__device__ __forceinline__ void widen_unit(T* a, T* b, const T* src,
                                           float scale = 1.0f) {
  if constexpr (VX * sizeof(T) == 8) {
    uint2 v = *reinterpret_cast<const uint2*>(src);
    int4 w;
    if constexpr (sizeof(T) == 2) {
      if constexpr (SCALED) {
        v.x = scale_bf16x2(v.x, scale);
        v.y = scale_bf16x2(v.y, scale);
      }
      // bytes (0 1 0 1) and (2 3 2 3)
      w = make_int4(__byte_perm(v.x, 0, 0x1010), __byte_perm(v.x, 0, 0x3232),
                    __byte_perm(v.y, 0, 0x1010), __byte_perm(v.y, 0, 0x3232));
    } else {
      if constexpr (SCALED) {
        v.x = __float_as_uint(__uint_as_float(v.x) * scale);
        v.y = __float_as_uint(__uint_as_float(v.y) * scale);
      }
      w = make_int4(v.x, v.x, v.y, v.y);
    }
    *reinterpret_cast<int4*>(a) = w;
    *reinterpret_cast<int4*>(b) = w;
  } else {
    T v = *src;
    if constexpr (SCALED) v = from_f32<T>(to_f32(v) * scale);
    a[0] = v;
    a[1] = v;
    b[0] = v;
    b[1] = v;
  }
}

// ((p + q) + (r + t)) [* s] in f32 of the bf16 pair p, r in word a and q,
// t in word b, rounded once
template <bool SCALED>
__device__ __forceinline__ unsigned short pool_bf16x2(unsigned int a,
                                                      unsigned int b,
                                                      float s) {
  const float left = __uint_as_float(a << 16) + __uint_as_float(b << 16);
  const float right =
      __uint_as_float(a & 0xffff0000u) + __uint_as_float(b & 0xffff0000u);
  float sum = left + right;
  if constexpr (SCALED) sum *= s;
  return __bfloat16_as_ushort(from_f32<__nv_bfloat16>(sum));
}

// ((a[2j] + b[2j]) + (a[2j+1] + b[2j+1])) [* s] in f32
template <bool SCALED>
__device__ __forceinline__ float pool_f32(float a0, float b0, float a1,
                                          float b1, float s) {
  float sum = (a0 + b0) + (a1 + b1);
  if constexpr (SCALED) sum *= s;
  return sum;
}

// dst[j] = (a[2j] + b[2j]) + (a[2j+1] + b[2j+1]) in f32, times scale where
// SCALED, rounded once, for j in [0, VX): the 2x2 block sums of the row
// pair a, b (the row pair first, then the column pair, then the scale, as
// the Pallas kernels compute); VX elements of T: one element or 8 bytes,
// from 2 VX of each row
template <typename T, int VX, bool SCALED = false>
__device__ __forceinline__ void pool_unit(T* dst, const T* a, const T* b,
                                          float scale = 1.0f) {
  if constexpr (VX * sizeof(T) == 8) {
    const uint4 p = *reinterpret_cast<const uint4*>(a);
    const uint4 q = *reinterpret_cast<const uint4*>(b);
    uint2 out;
    if constexpr (sizeof(T) == 2) {
      out.x = (unsigned int)pool_bf16x2<SCALED>(p.x, q.x, scale) |
              ((unsigned int)pool_bf16x2<SCALED>(p.y, q.y, scale) << 16);
      out.y = (unsigned int)pool_bf16x2<SCALED>(p.z, q.z, scale) |
              ((unsigned int)pool_bf16x2<SCALED>(p.w, q.w, scale) << 16);
    } else {
      out.x = __float_as_uint(pool_f32<SCALED>(
          __uint_as_float(p.x), __uint_as_float(q.x), __uint_as_float(p.y),
          __uint_as_float(q.y), scale));
      out.y = __float_as_uint(pool_f32<SCALED>(
          __uint_as_float(p.z), __uint_as_float(q.z), __uint_as_float(p.w),
          __uint_as_float(q.w), scale));
    }
    *reinterpret_cast<uint2*>(dst) = out;
  } else {
    dst[0] = from_f32<T>(pool_f32<SCALED>(to_f32(a[0]), to_f32(b[0]),
                                          to_f32(a[1]), to_f32(b[1]), scale));
  }
}
