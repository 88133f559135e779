// K10 reflect_fold: the adjoint of REFLECT padding by p on H and W, NHCW.
//
// Replaces the halo fold of cyclegan_tpu/ops/pallas_conv.py
// `conv2d_reflect_nhcw`'s VJP (`_conv_reflect_bwd_rule`: two strip adds in H,
// then a 0/1 fold matrix in W on the MXU). The input gradient of K9 is
// dX = fold(dXp), with dXp [B, H+2p, C, W+2p] the gradient with respect to
// the padded input (K1 on dY, see ops/cuda_reflect.py).
//
// dxp [B, H+2p, C, W+2p] -> dx [B, H, C, W]:
//   dx[h, w] = sum over source rows r of h and source columns s of w of
//              dxp[r, s],
// where the source rows of h are, in this order, the interior row h + p, the
// top halo row p - h when 1 <= h <= p, and the bottom halo row 2H + p - 2 - h
// when H-1-p <= h <= H-2 (padded row p-j came from row j, row p+H-1+j from
// row H-1-j); the same for columns. The sum runs in f32 as the JAX fold
// does: H first, over every source column, then W:
//   dx = (t(w + p) + t(left)) + t(right), t(s) = (int + top) + bot
// and rounds once; the plain version adds in the same order, so K10 is exact
// against it.
//
// Bound on the H100: bytes (at most 8 adds per element written). The grid's
// y dimension walks the B H output rows and its x dimension the units of a
// row, in channel and column order; a thread makes one unit of V output
// elements of one channel and leaves it in one 16-byte store (the unit's
// channel and column come from one 32-bit division of its index). No
// shared memory and no barrier: every thread's loads are in flight while
// others compute.
//
// Vector path (ops/cuda_reflect.py `reflect_fold_geometry`: 16-byte aligned
// pointers, W a whole number of units, p < V, dxp a whole number of units):
// each source row (1 to 3, the same for the whole CTA) is read at padded
// columns w + p, V elements at an offset m from a 16-byte unit of dxp that
// need not be 0, as no row need start on a unit (the ResNet stem's rows are
// 1,572 bf16 bytes): the two aligned units around them, shifted into place
// in registers by a select network on their 32-bit words (`__byte_perm` for
// an odd bf16 offset); neighbouring threads' units overlap by one, which
// the L1 serves. With p < V only a channel's first and last unit have halo
// columns, p each. p is a template argument of this path (one kernel for
// each p < V), so those units add them in unrolled loops at fixed element
// indices, their loads issued together, and the other units carry no halo
// code beyond two flags.
//
// Element path (anything else, such as a view off alignment): the same
// kernel with one element a unit and p at run time.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROW_BLOCKS = 65535;  // gridDim.y limit

// f32 value of element e of a 16-byte unit of T held as four words
template <typename T>
__device__ __forceinline__ float unit_f32(const uint32_t (&w)[4], int e) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t word = w[e / 2];
    return __uint_as_float(e % 2 ? word & 0xffff0000u : word << 16);
  } else {
    return __uint_as_float(w[e]);
  }
}

// out = the 16 bytes at element offset m (0 < m < V) of the 32 bytes a, b:
// the words shifted by m / (elements a word) with selects, then by half a
// word for an odd bf16 offset
template <typename T>
__device__ __forceinline__ void shifted(uint32_t (&out)[4], const uint4& a,
                                        const uint4& b, int m) {
  constexpr int EPW = 4 / sizeof(T);  // elements a word
  const int s = m / EPW;
  const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t t1[6], t2[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) t1[i] = (s & 2) ? v[i + 2] : v[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) t2[i] = (s & 1) ? t1[i + 1] : t1[i];
  const bool half = EPW == 2 && (m & 1);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = half ? __byte_perm(t2[k], t2[k + 1], 0x5432) : t2[k];
}

// s[0, V) (+)= the f32 values of src[off, off + V); src is 16-byte aligned
template <typename T, int V, bool ADD>
__device__ __forceinline__ void window_values(float (&s)[V], const T* src,
                                              size_t off) {
  if constexpr (V == 1) {
    const float x = to_f32(src[off]);
    s[0] = ADD ? s[0] + x : x;
  } else {
    const int m = (int)(off % V);
    const uint4* unit = reinterpret_cast<const uint4*>(src + (off - m));
    const uint4 a = unit[0];
    uint32_t w[4] = {a.x, a.y, a.z, a.w};
    if (m) shifted<T>(w, a, unit[1], m);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x = unit_f32<T>(w, e);
      s[e] = ADD ? s[e] + x : x;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_unit(T* dst, const float (&s)[V]) {
  if constexpr (V == 1) {
    dst[0] = from_f32<T>(s[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(s[2 * k],
                                                          s[2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&pair);
      } else {
        w[k] = __float_as_uint(s[k]);
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// s[e] += t(col), the f32 sum of the source rows at column col
template <typename T, int V>
__device__ __forceinline__ void add_column(float (&s)[V], int e,
                                           const T* src, size_t irow,
                                           size_t trow, size_t brow,
                                           bool has_top, bool has_bot,
                                           int col) {
  float t = to_f32(src[irow + col]);
  if (has_top) t += to_f32(src[trow + col]);
  if (has_bot) t += to_f32(src[brow + col]);
  s[e] += t;
}

// blockIdx.y: output rows r = b H + h, strided by gridDim.y; blockIdx.x,
// threadIdx.x: unit u of the row's C W / V, channel u / (W / V). Vector
// path: P = p; element path: V = 1, P = -1 and p at run time (p_run).
template <typename T, int V, int P>
__global__ void __launch_bounds__(THREADS)
reflect_fold_kernel(const T* __restrict__ dxp, T* __restrict__ dx, int B,
                    int H, int C, int W, int p_run) {
  const int p = P >= 0 ? P : p_run;
  const int Hp = H + 2 * p, Wp = W + 2 * p;
  const int per_c = W / V;
  const int u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= C * per_c) return;
  const int c = u / per_c;
  const int w0 = (u - c * per_c) * V;
  // whether the unit has a left and a right halo column
  const bool first = V == 1 ? w0 >= 1 && w0 <= p : w0 == 0;
  const bool last = V == 1 ? w0 >= W - 1 - p && w0 <= W - 2 : w0 == W - V;
  const size_t plane = (size_t)C * Wp;  // one dxp row
  const int c0 = c * Wp;                // the channel's columns in a dxp row
  const int q = c0 + w0 + p;            // the unit's

  for (int r = blockIdx.y; r < B * H; r += gridDim.y) {
    const int b = r / H, h = r - b * H;
    const bool has_top = h >= 1 && h <= p;
    const bool has_bot = h >= H - 1 - p && h <= H - 2;
    const size_t img = (size_t)b * Hp;
    const size_t irow = (img + h + p) * plane;
    const size_t trow = (img + (has_top ? p - h : 0)) * plane;
    const size_t brow = (img + (has_bot ? 2 * H + p - 2 - h : 0)) * plane;

    // t at padded columns w0 + p ..: (interior + top) + bottom
    float s[V];
    window_values<T, V, false>(s, dxp, irow + q);
    if (has_top) window_values<T, V, true>(s, dxp, trow + q);
    if (has_bot) window_values<T, V, true>(s, dxp, brow + q);
    // (t[w + p] + t[left]) + t[right]
    if constexpr (V == 1) {
      if (first)
        add_column<T, 1>(s, 0, dxp, irow, trow, brow, has_top, has_bot,
                         c0 + p - w0);
      if (last)
        add_column<T, 1>(s, 0, dxp, irow, trow, brow, has_top, has_bot,
                         c0 + 2 * W + p - 2 - w0);
    } else {
      // a first unit's output column j (1 <= j <= P) adds padded column
      // P - j; a last unit's column W - 1 - j adds column W + P - 1 + j
      if (first) {
#pragma unroll
        for (int j = 1; j <= P; ++j)
          add_column<T, V>(s, j, dxp, irow, trow, brow, has_top, has_bot,
                           c0 + P - j);
      }
      if (last) {
#pragma unroll
        for (int j = 1; j <= P; ++j)
          add_column<T, V>(s, V - 1 - j, dxp, irow, trow, brow, has_top,
                           has_bot, c0 + W + P - 1 + j);
      }
    }
    store_unit<T, V>(dx + ((size_t)r * C + c) * W + w0, s);
  }
}

template <typename T, int V, int P>
int launch_path(const T* dxp, T* dx, int B, int H, int C, int W, int p,
                cudaStream_t st) {
  const int rows = B * H;
  const int units = C * (W / V);
  const dim3 grid((units + THREADS - 1) / THREADS,
                  rows < MAX_ROW_BLOCKS ? rows : MAX_ROW_BLOCKS);
  reflect_fold_kernel<T, V, P><<<grid, THREADS, 0, st>>>(dxp, dx, B, H, C,
                                                         W, p);
  return (int)cudaGetLastError();
}

// the vector path's kernel for p, one of P, P + 1, .., V - 1
template <typename T, int V, int P = 0>
int launch_vec(const T* dxp, T* dx, int B, int H, int C, int W, int p,
               cudaStream_t st) {
  if constexpr (P < V) {
    if (p == P) return launch_path<T, V, P>(dxp, dx, B, H, C, W, p, st);
    return launch_vec<T, V, P + 1>(dxp, dx, B, H, C, W, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// vec: the wrapper's choice of path (`reflect_fold_geometry`); refused
// where the vector path's conditions do not hold
template <typename T>
int launch(const void* dxp, void* dx, int B, int H, int C, int W, int p,
           int vec, void* stream) {
  if (B < 1 || C < 1 || p < 0 || p >= H || p >= W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const size_t n = (size_t)B * (H + 2 * p) * C * (W + 2 * p);
    if (!aligned16(dxp) || !aligned16(dx) || n % V || W % V || p >= V)
      return (int)cudaErrorInvalidValue;
    return launch_vec<T, V>((const T*)dxp, (T*)dx, B, H, C, W, p, st);
  }
  return launch_path<T, 1, -1>((const T*)dxp, (T*)dx, B, H, C, W, p, st);
}

}  // namespace

extern "C" int reflect_fold_f32(const void* dxp, void* dx, int B, int H,
                                int C, int W, int p, int vec, void* stream) {
  return launch<float>(dxp, dx, B, H, C, W, p, vec, stream);
}

extern "C" int reflect_fold_bf16(const void* dxp, void* dx, int B, int H,
                                 int C, int W, int p, int vec, void* stream) {
  return launch<__nv_bfloat16>(dxp, dx, B, H, C, W, p, vec, stream);
}
