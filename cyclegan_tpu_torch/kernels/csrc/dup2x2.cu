// K7 dup2x2: scaled nearest 2x duplication on NHCW activations.
//
// Replaces cyclegan_tpu/ops/pallas_resize.py `_dup2x2_call`: the backward of
// the 2x2 average pool is scale 1/4 (and a standalone nearest upsample would
// be scale 1); on the TPU the duplication was a 0/1 interleave matmul on
// the MXU.
//
// x [B, h, C, w] -> out [B, 2h, C, 2w],
// out[b, 2i + r, c, 2j + s] = x[b, i, c, j] * scale, for r, s in {0, 1},
// product in f32 and one rounding to the storage type.
//
// Bound on the H100: bytes (one multiply per four elements written). In
// NHCW, output rows (b, 2i) and (b, 2i + 1) are both x row (b, i) (m = C w
// elements) with every element written twice: column 2j + s of channel c
// sits at 2 (c w + j) + s, so out[2e + s] = x[e] (row_units.cuh). This is
// K4's x part alone, with a multiply, and no index needs the channel or the
// column.
//
// The grid's y dimension walks the B h rows of x and its x dimension the
// units of a row. Vector path (both pointers 16-byte aligned, m a whole
// number of 8-byte units, the rule of ops/cuda_resize.py `dup2x2_geometry`):
// a unit is one 8-byte load of x (4 bf16 or 2 f32), each element multiplied
// in f32 and rounded once, widened in registers to 16 bytes and stored into
// both output rows, so x is read from device memory once and a warp's store
// covers 512 contiguous bytes of each row. Element path (anything else: an
// odd C w, a view off alignment): the same map one element at a time. No
// thread divides by a runtime value.
#include "row_units.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROW_BLOCKS = 65535;  // gridDim.y limit

// x row i (m elements) -> out rows 2i, 2i+1 (2m each); unit u widens x
// elements [u VX, (u + 1) VX)
template <typename T, int VX>
__global__ void __launch_bounds__(THREADS)
dup2x2_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int m,
              float scale) {
  const int u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= m / VX) return;
  const int e = u * VX;
  for (int i = blockIdx.y; i < rows; i += gridDim.y) {
    T* o = out + (size_t)i * 4 * m + 2 * e;
    widen_unit<T, VX, true>(o, o + 2 * m, x + (size_t)i * m + e, scale);
  }
}

template <typename T, int VX>
int launch_path(const T* x, T* out, int rows, int m, float scale,
                cudaStream_t st) {
  const dim3 grid((m / VX + THREADS - 1) / THREADS,
                  rows < MAX_ROW_BLOCKS ? rows : MAX_ROW_BLOCKS);
  dup2x2_kernel<T, VX><<<grid, THREADS, 0, st>>>(x, out, rows, m, scale);
  return (int)cudaGetLastError();
}

// vec: the wrapper's choice of path (`dup2x2_geometry`); refused where the
// vector path's alignment does not hold
template <typename T>
int launch(const void* x, void* out, int B, int h, int C, int w, float scale,
           int vec, void* stream) {
  if (B < 1 || h < 1 || C < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int rows = B * h, m = C * w;
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

extern "C" int dup2x2_f32(const void* x, void* out, int B, int h, int C,
                          int w, float scale, int vec, void* stream) {
  return launch<float>(x, out, B, h, C, w, scale, vec, stream);
}

extern "C" int dup2x2_bf16(const void* x, void* out, int B, int h, int C,
                           int w, float scale, int vec, void* stream) {
  return launch<__nv_bfloat16>(x, out, B, h, C, w, scale, vec, stream);
}
