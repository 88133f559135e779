// K11 concat2 and K12 split2: the channel concat of two NHCW activations and
// its adjoint.
//
// Replaces cyclegan_tpu/ops/pallas_concat.py `_concat2_call` (K11) and
// `_split2_call` (K12):
//   concat2: a [B, H, C1, W] ++ b [B, H, C2, W] -> out [B, H, C1 + C2, W]
//   split2:  g [B, H, C1 + C2, W] -> (g[:, :, :C1], g[:, :, C1:])
//
// In NHCW each (b, h) row of the concatenated tensor is the contiguous
// C1 * W elements of a's row followed by the C2 * W elements of b's row, so
// both kernels are row-segmented copies over B * H rows of n1 + n2 elements,
// n1 = C1 * W and n2 = C2 * W. split2 reads g once and writes both outputs
// in one launch, as the Pallas `_split2_kernel` does.
//
// Bound on the H100: bytes (each element is read once and written once; no
// arithmetic). Where n1, n2 and every pointer allow it, the copy moves
// 16-byte units (int4): a thread per unit, neighbouring threads on
// neighbouring units, so loads and stores are full 128-byte lines per warp.
// Otherwise it moves one element per thread. The grid's y dimension walks
// the rows and its x dimension the units of a row, so no thread divides by a
// row length. Values are copied as bits, so both kernels equal their plain
// versions exactly. There is no gate: any W, C1, C2 and both dtypes run.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROW_BLOCKS = 65535;  // gridDim.y limit

// out row r = a row r (m1 units) ++ b row r (m2 units)
template <typename U>
__global__ void __launch_bounds__(THREADS)
concat2_kernel(const U* __restrict__ a, const U* __restrict__ b,
               U* __restrict__ out, int rows, int m1, int m2) {
  const int m = m1 + m2;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const U* ar = a + (size_t)r * m1;
    const U* br = b + (size_t)r * m2;
    U* orow = out + (size_t)r * m;
    for (int u = blockIdx.x * THREADS + threadIdx.x; u < m;
         u += gridDim.x * THREADS) {
      orow[u] = u < m1 ? ar[u] : br[u - m1];
    }
  }
}

// da row r = g row r [0, m1), db row r = g row r [m1, m1 + m2)
template <typename U>
__global__ void __launch_bounds__(THREADS)
split2_kernel(const U* __restrict__ g, U* __restrict__ da,
              U* __restrict__ db, int rows, int m1, int m2) {
  const int m = m1 + m2;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const U* grow = g + (size_t)r * m;
    U* ar = da + (size_t)r * m1;
    U* br = db + (size_t)r * m2;
    for (int u = blockIdx.x * THREADS + threadIdx.x; u < m;
         u += gridDim.x * THREADS) {
      const U v = grow[u];
      if (u < m1) {
        ar[u] = v;
      } else {
        br[u - m1] = v;
      }
    }
  }
}

dim3 grid_of(int rows, int m) {
  const int per_row = (m + THREADS - 1) / THREADS;
  return dim3(per_row < 1 ? 1 : per_row,
              rows < 1 ? 1 : (rows < MAX_ROW_BLOCKS ? rows : MAX_ROW_BLOCKS));
}

// 16-byte units where both segment lengths are whole units and every
// pointer is 16-byte aligned (row starts are then aligned too).
template <typename T>
bool vectorizable(int n1, int n2, const void* p, const void* q,
                  const void* s) {
  constexpr int V = 16 / sizeof(T);
  return n1 % V == 0 && n2 % V == 0 && (uintptr_t)p % 16 == 0 &&
         (uintptr_t)q % 16 == 0 && (uintptr_t)s % 16 == 0;
}

template <typename T>
int launch_concat2(const void* a, const void* b, void* out, int rows, int n1,
                   int n2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vectorizable<T>(n1, n2, a, b, out)) {
    constexpr int V = 16 / sizeof(T);
    const int m1 = n1 / V, m2 = n2 / V;
    concat2_kernel<int4><<<grid_of(rows, m1 + m2), THREADS, 0, st>>>(
        (const int4*)a, (const int4*)b, (int4*)out, rows, m1, m2);
  } else {
    concat2_kernel<T><<<grid_of(rows, n1 + n2), THREADS, 0, st>>>(
        (const T*)a, (const T*)b, (T*)out, rows, n1, n2);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split2(const void* g, void* da, void* db, int rows, int n1,
                  int n2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vectorizable<T>(n1, n2, g, da, db)) {
    constexpr int V = 16 / sizeof(T);
    const int m1 = n1 / V, m2 = n2 / V;
    split2_kernel<int4><<<grid_of(rows, m1 + m2), THREADS, 0, st>>>(
        (const int4*)g, (int4*)da, (int4*)db, rows, m1, m2);
  } else {
    split2_kernel<T><<<grid_of(rows, n1 + n2), THREADS, 0, st>>>(
        (const T*)g, (T*)da, (T*)db, rows, n1, n2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows = B * H, n1 = C1 * W, n2 = C2 * W (elements)
extern "C" int concat2_f32(const void* a, const void* b, void* out, int rows,
                           int n1, int n2, void* stream) {
  return launch_concat2<float>(a, b, out, rows, n1, n2, stream);
}

extern "C" int concat2_bf16(const void* a, const void* b, void* out, int rows,
                            int n1, int n2, void* stream) {
  return launch_concat2<__nv_bfloat16>(a, b, out, rows, n1, n2, stream);
}

extern "C" int split2_f32(const void* g, void* da, void* db, int rows, int n1,
                          int n2, void* stream) {
  return launch_split2<float>(g, da, db, rows, n1, n2, stream);
}

extern "C" int split2_bf16(const void* g, void* da, void* db, int rows,
                           int n1, int n2, void* stream) {
  return launch_split2<__nv_bfloat16>(g, da, db, rows, n1, n2, stream);
}
