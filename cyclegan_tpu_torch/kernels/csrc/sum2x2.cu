// K3 sum2x2: scaled 2x2 block sum on NHCW activations.
//
// Replaces cyclegan_tpu/ops/pallas_resize.py `_sum2x2_call`: the 2x2 average
// pool is scale 1/4 (and the upsample's backward would be scale 1).
//
// x [B, H, C, W] -> out [B, H/2, C, W/2],
// out = scale * ((x[2h, 2w] + x[2h+1, 2w]) + (x[2h, 2w+1] + x[2h+1, 2w+1])),
// in f32, in that order, and one rounding to the storage type: the Pallas
// kernel adds the row pair, then the lane pair, then scales.
//
// Bound on the H100: bytes (one multiply and three adds per 5 elements
// moved). In NHCW, output row (b, h) (m = C W/2 elements) is the pair sums
// of x rows (b, 2h) and (b, 2h + 1): column pair (2j, 2j + 1) of channel c
// sits at element pair c W/2 + j of a row, so out[e] pools x elements 2e
// and 2e + 1 of both rows (row_units.cuh `pool_unit`). This is K8's pooled
// part alone, with the scale, and no index needs the channel or the column.
//
// The grid's y dimension walks the B H/2 output rows and its x dimension
// the units of a row. Vector path (both pointers 16-byte aligned, an x row
// a whole number of 16-byte units: the rule of ops/cuda_resize.py
// `sum2x2_geometry`): a unit reads 16 bytes of each row of the pair and
// stores the 8 bytes of its 4 bf16 or 2 f32 results, so x is read from
// device memory once. Element path (anything else: an odd C W/2, a view
// off alignment): the same map one element at a time. No thread divides by
// a runtime value.
#include "row_units.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROW_BLOCKS = 65535;  // gridDim.y limit

// x rows 2i, 2i+1 (2m elements each) -> out row i (m); unit u pools out
// elements [u VX, (u + 1) VX)
template <typename T, int VX>
__global__ void __launch_bounds__(THREADS)
sum2x2_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int m,
              float scale) {
  const int u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= m / VX) return;
  const int e = u * VX;
  for (int i = blockIdx.y; i < rows; i += gridDim.y) {
    const T* a = x + (size_t)i * 4 * m + 2 * e;
    pool_unit<T, VX, true>(out + (size_t)i * m + e, a, a + 2 * m, scale);
  }
}

template <typename T, int VX>
int launch_path(const T* x, T* out, int rows, int m, float scale,
                cudaStream_t st) {
  const dim3 grid((m / VX + THREADS - 1) / THREADS,
                  rows < MAX_ROW_BLOCKS ? rows : MAX_ROW_BLOCKS);
  sum2x2_kernel<T, VX><<<grid, THREADS, 0, st>>>(x, out, rows, m, scale);
  return (int)cudaGetLastError();
}

// vec: the wrapper's choice of path (`sum2x2_geometry`); refused where the
// vector path's alignment does not hold
template <typename T>
int launch(const void* x, void* out, int B, int H, int C, int W, float scale,
           int vec, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = B * (H / 2), m = C * (W / 2);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    constexpr int VX = 8 / sizeof(T);
    if (!aligned16(x) || !aligned16(out) || m % VX)
      return (int)cudaErrorInvalidValue;
    return launch_path<T, VX>((const T*)x, (T*)out, rows, m, scale, st);
  }
  return launch_path<T, 1>((const T*)x, (T*)out, rows, m, scale, st);
}

}  // namespace

extern "C" int sum2x2_f32(const void* x, void* out, int B, int H, int C, int W,
                          float scale, int vec, void* stream) {
  return launch<float>(x, out, B, H, C, W, scale, vec, stream);
}

extern "C" int sum2x2_bf16(const void* x, void* out, int B, int H, int C,
                           int W, float scale, int vec, void* stream) {
  return launch<__nv_bfloat16>(x, out, B, H, C, W, scale, vec, stream);
}
