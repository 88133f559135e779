// K8 split_pool2: the adjoint of the up-path junction (K4) on NHCW
// activations.
//
// Replaces cyclegan_tpu/ops/pallas_concat.py `_split_pool2_call`. The
// junction is out = concat(skip, nearest-2x-upsample(x)) over channels, so
// for its gradient g [B, H, C1 + C2, W]:
//   dskip [B, H, C1, W]     = g[:, :, :C1, :]
//   dx    [B, H/2, C2, W/2] : dx[b, i, c, j] =
//       (g[b, 2i, C1 + c, 2j] + g[b, 2i + 1, C1 + c, 2j])
//     + (g[b, 2i, C1 + c, 2j + 1] + g[b, 2i + 1, C1 + c, 2j + 1])
// in f32, the row pair first and the column pair second as the Pallas kernel
// and K3 add, then one rounding to the storage type.
//
// Bound on the H100: bytes (g read once, both outputs written once; 3 adds
// per 4 elements of the second part). In NHCW, g row (b, 2k + r), r in
// {0, 1}, is dskip row (b, 2k + r) (n1 = C1 W elements) followed by the
// m = C2 W/2 column pairs of x row (b, k): dx row k, element e, sums
// elements n1 + 2e and n1 + 2e + 1 of g rows 2k and 2k + 1 (row_units.cuh).
// A row pair is thus two segmented copies and one pair-summing pass, K4's
// map run backward, and no index needs the channel or the column.
//
// The grid's y dimension walks the B H/2 row pairs and its x dimension the
// units of a pair: first the 2 n1 elements of the pair's two skip parts
// (contiguous in dskip), then the m elements of dx row k. Vector path (every
// pointer 16-byte aligned, n1 a whole number of 16-byte units and m of
// 8-byte ones: ops/cuda_concat.py `concat_up2_geometry`, K4's rule): a skip
// unit is one 16-byte load and store; a pooled unit reads 16 bytes at
// element n1 + 2e of each row of the pair and stores the 8 bytes of its 4
// bf16 or 2 f32 sums at element e of dx row k, so g is read from device
// memory once. Element path (anything else: an odd C1 W, a view off
// alignment): the same map one element at a time. No thread divides by a
// runtime value.
#include "row_units.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROW_BLOCKS = 65535;  // gridDim.y limit

// pair k: g rows 2k, 2k+1 (n1 + 2m elements each) -> dskip rows 2k, 2k+1
// (n1 each) and dx row k (m); units [0, 2 ms) copy to dskip, [2 ms,
// 2 ms + mx) sum into dx, ms = n1 / VS, mx = m / VX
template <typename T, int VS, int VX>
__global__ void __launch_bounds__(THREADS)
split_pool2_kernel(const T* __restrict__ g, T* __restrict__ dskip,
                   T* __restrict__ dx, int pairs, int n1, int m) {
  const int ms = n1 / VS, mx = m / VX;
  const int row = n1 + 2 * m;
  const int u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= 2 * ms + mx) return;
  for (int k = blockIdx.y; k < pairs; k += gridDim.y) {
    const T* gk = g + (size_t)k * 2 * row;
    if (u < 2 * ms) {
      const int r = u >= ms;
      copy_unit<T, VS>(dskip + (size_t)k * 2 * n1 + u * VS,
                       gk + r * row + (u - r * ms) * VS);
    } else {
      const int e = (u - 2 * ms) * VX;
      pool_unit<T, VX>(dx + (size_t)k * m + e, gk + n1 + 2 * e,
                       gk + row + n1 + 2 * e);
    }
  }
}

template <typename T, int VS, int VX>
int launch_path(const T* g, T* dskip, T* dx, int pairs, int n1, int m,
                cudaStream_t st) {
  const int units = 2 * (n1 / VS) + m / VX;
  const dim3 grid((units + THREADS - 1) / THREADS,
                  pairs < MAX_ROW_BLOCKS ? pairs : MAX_ROW_BLOCKS);
  split_pool2_kernel<T, VS, VX><<<grid, THREADS, 0, st>>>(g, dskip, dx,
                                                          pairs, n1, m);
  return (int)cudaGetLastError();
}

// vec: the wrapper's choice of path (`concat_up2_geometry`); refused where
// the vector path's alignment does not hold
template <typename T>
int launch(const void* g, void* dskip, void* dx, int B, int H, int C1, int C2,
           int W, int vec, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C1 < 1 || C2 < 1)
    return (int)cudaErrorInvalidValue;
  const int pairs = B * (H / 2);
  const int n1 = C1 * W, m = C2 * (W / 2);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    constexpr int VS = 16 / sizeof(T), VX = 8 / sizeof(T);
    if (!aligned16(g) || !aligned16(dskip) || !aligned16(dx) || n1 % VS ||
        m % VX)
      return (int)cudaErrorInvalidValue;
    return launch_path<T, VS, VX>((const T*)g, (T*)dskip, (T*)dx, pairs, n1,
                                  m, st);
  }
  return launch_path<T, 1, 1>((const T*)g, (T*)dskip, (T*)dx, pairs, n1, m,
                              st);
}

}  // namespace

extern "C" int split_pool2_f32(const void* g, void* dskip, void* dx, int B,
                               int H, int C1, int C2, int W, int vec,
                               void* stream) {
  return launch<float>(g, dskip, dx, B, H, C1, C2, W, vec, stream);
}

extern "C" int split_pool2_bf16(const void* g, void* dskip, void* dx, int B,
                                int H, int C1, int C2, int W, int vec,
                                void* stream) {
  return launch<__nv_bfloat16>(g, dskip, dx, B, H, C1, C2, W, vec, stream);
}
