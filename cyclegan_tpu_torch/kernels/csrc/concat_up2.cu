// K4 concat_up2: the pooled U-Net's up-path junction on NHCW activations.
//
// Replaces cyclegan_tpu/ops/pallas_concat.py `_concat_up2_call`: concat over
// channels of (skip, nearest-2x-upsample(x)), skip first (on the TPU the
// upsample was a 0/1 interleave matmul on the MXU).
//
// skip [B, H, C1, W], x [B, H/2, C2, W/2] -> out [B, H, C1 + C2, W]
//
// Bound on the H100: bytes; it does no arithmetic. In NHCW, output row
// (b, 2k + r), r in {0, 1}, is skip row (b, 2k + r) (n1 = C1 W elements)
// followed by x row (b, k) (m = C2 W/2 elements) with every element written
// twice: column 2j + s of channel c sits at c W + 2j + s = 2 (c W/2 + j) + s,
// so out[n1 + 2e] = out[n1 + 2e + 1] = x[e]. A row pair is thus two
// segmented copies and one widening copy, and no index needs the channel or
// the column.
//
// The grid's y dimension walks the B H/2 row pairs and its x dimension the
// units of a pair: first the 2 n1 elements of the pair's two skip rows
// (contiguous in skip), then the m elements of x row k. Vector path (every
// pointer 16-byte aligned, n1 a whole number of 16-byte units and m of
// 8-byte ones, the rule of ops/cuda_concat.py `concat_up2_geometry`): a skip
// unit is one 16-byte load and store; an x unit is one 8-byte load (4 bf16
// or 2 f32) widened in registers to 16 bytes and stored into both rows, so x
// is read from device memory once and a warp's store covers 512 contiguous
// bytes. Element path (anything else: an odd C1 W, a view off alignment):
// the same map one element at a time. No thread divides by a runtime value.
// Values are copied as bits, so the result is exact. The units
// (`copy_unit`, `widen_unit`) are in row_units.cuh, shared with K7 and K8.
#include "row_units.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROW_BLOCKS = 65535;  // gridDim.y limit

// pair k: out rows 2k, 2k+1 (n1 + 2m elements each) from skip rows 2k, 2k+1
// (n1 each) and x row k (m); units [0, 2 ms) copy skip, [2 ms, 2 ms + mx)
// widen x, ms = n1 / VS, mx = m / VX
template <typename T, int VS, int VX>
__global__ void __launch_bounds__(THREADS)
concat_up2_kernel(const T* __restrict__ skip, const T* __restrict__ x,
                  T* __restrict__ out, int pairs, int n1, int m) {
  const int ms = n1 / VS, mx = m / VX;
  const int row = n1 + 2 * m;
  const int u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= 2 * ms + mx) return;
  for (int k = blockIdx.y; k < pairs; k += gridDim.y) {
    T* o = out + (size_t)k * 2 * row;
    if (u < 2 * ms) {
      const int r = u >= ms;
      copy_unit<T, VS>(o + r * row + (u - r * ms) * VS,
                       skip + (size_t)k * 2 * n1 + u * VS);
    } else {
      const int e = (u - 2 * ms) * VX;
      widen_unit<T, VX>(o + n1 + 2 * e, o + row + n1 + 2 * e,
                        x + (size_t)k * m + e);
    }
  }
}

template <typename T, int VS, int VX>
int launch_path(const T* skip, const T* x, T* out, int pairs, int n1, int m,
                cudaStream_t st) {
  const int units = 2 * (n1 / VS) + m / VX;
  const dim3 grid((units + THREADS - 1) / THREADS,
                  pairs < MAX_ROW_BLOCKS ? pairs : MAX_ROW_BLOCKS);
  concat_up2_kernel<T, VS, VX><<<grid, THREADS, 0, st>>>(skip, x, out, pairs,
                                                         n1, m);
  return (int)cudaGetLastError();
}

// vec: the wrapper's choice of path (`concat_up2_geometry`); refused where
// the vector path's alignment does not hold
template <typename T>
int launch(const void* skip, const void* x, void* out, int B, int H, int C1,
           int C2, int W, int vec, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C1 < 1 || C2 < 1)
    return (int)cudaErrorInvalidValue;
  const int pairs = B * (H / 2);
  const int n1 = C1 * W, m = C2 * (W / 2);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    constexpr int VS = 16 / sizeof(T), VX = 8 / sizeof(T);
    if (!aligned16(skip) || !aligned16(x) || !aligned16(out) || n1 % VS ||
        m % VX)
      return (int)cudaErrorInvalidValue;
    return launch_path<T, VS, VX>((const T*)skip, (const T*)x, (T*)out, pairs,
                                  n1, m, st);
  }
  return launch_path<T, 1, 1>((const T*)skip, (const T*)x, (T*)out, pairs, n1,
                              m, st);
}

}  // namespace

extern "C" int concat_up2_f32(const void* skip, const void* x, void* out,
                              int B, int H, int C1, int C2, int W, int vec,
                              void* stream) {
  return launch<float>(skip, x, out, B, H, C1, C2, W, vec, stream);
}

extern "C" int concat_up2_bf16(const void* skip, const void* x, void* out,
                               int B, int H, int C1, int C2, int W, int vec,
                               void* stream) {
  return launch<__nv_bfloat16>(skip, x, out, B, H, C1, C2, W, vec, stream);
}
