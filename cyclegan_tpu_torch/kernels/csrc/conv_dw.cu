// K5 conv_dw: the weight gradient of a stride-1 KxK convolution on NHCW
// activations, any K (K = 1 included), and K9-dW conv_reflect_dw: the same
// gradient of K9's reflect-padded convolution.
//
// K5 replaces cyclegan_tpu/ops/pallas_conv.py `_conv_dw_call` (KxK dW) and
// `_conv1x1_dw_call` (the 1x1 head's dW). K9-dW replaces the dW of
// `conv2d_reflect_nhcw`'s VJP (`_conv_dw_call` on the reflect-padded input).
//
// x  [B, H, C, W]      the conv's input
// g  [B, H, Cout, W]   the gradient of its output
// dw [K, K, C, Cout]   f32 HWIO:
//   dw[dy, dx, c, co] = sum over b, h, w of
//                       x[b, h + dy - pad, c, w + dx - pad] * g[b, h, co, w]
// with zeros outside the image; pad is the forward's pad before ((K-1)/2).
// K9-dW reads x through the reflected index map instead (odd K, pad K/2, the
// edge not repeated), so no padded copy of x is written to device memory.
//
// Bound on the H100: operations (as many multiply-adds as the forward, with
// the same 16-100 per byte). As a matrix product it is
// dw[m, co] = sum_p patch[p, m] * g[p, co], m = (dy, dx, c), over the
// p = B*H*W pixels (up to 524,288 terms) into a small output (at most
// 4*4*192*128 values in the generator). The design is a split reduction:
// a block owns an MT x NT output tile and a contiguous slice of (b, h) image
// rows. Per 32-pixel stretch of a row it stages the patch values (an im2col
// tile gathered from x, zeros outside the image) and the g values in shared
// memory, and each thread accumulates a 4x4 micro-tile in f32 registers. It
// writes its partial sums to an f32 workspace [splits, M, Cout]; a second
// kernel adds the splits in a fixed order, so the result does not depend on
// scheduling. CUDA cores only; a tensor-core version is later work.
#include "common.cuh"

namespace {

constexpr int MT = 64;       // output rows (dy, dx, c) per block
constexpr int NT = 32;       // output channels per block
constexpr int PT = 32;       // pixels staged per round: one stretch of a row
constexpr int THREADS = 128; // 16 row groups x 8 channel groups, 4x4 each

// REFLECT padding's source index (see conv_same.cu); out of [0, n) past
// the reflected range, which only rows and columns never summed reach.
__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

struct DwSmem {
  float as[PT][MT + 1];  // +1: conflict-free transposed stores
  float bs[PT][NT + 1];
  int s_dy[MT], s_dx[MT], s_c[MT];
};

template <typename T, bool REFLECT>
__device__ __forceinline__ void dw_partial(
    DwSmem& sm, const T* __restrict__ x, const T* __restrict__ g,
    float* __restrict__ part, int B, int H, int C, int W, int Cout, int K,
    int pad, int splits) {
  auto& as = sm.as;
  auto& bs = sm.bs;
  int* s_dy = sm.s_dy;
  int* s_dx = sm.s_dx;
  int* s_c = sm.s_c;

  const int M = K * K * C;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * NT;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int mg = tid % 16;  // rows mg + 16 i
  const int ng = tid / 16;  // channels ng + 8 j

  for (int i = tid; i < MT; i += THREADS) {
    const int m = m0 + i;
    if (m < M) {
      const int tap = m / C;
      s_dy[i] = tap / K;
      s_dx[i] = tap % K;
      s_c[i] = m % C;
    } else {
      s_dy[i] = -1;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int R = B * H;
  const int rows_per = (R + splits - 1) / splits;
  const int r_begin = split * rows_per;
  const int r_end = min(R, r_begin + rows_per);
  const int p = tid % PT;       // this thread's pixel when staging
  const int lane_row = tid / PT;  // 0..3

  for (int r = r_begin; r < r_end; ++r) {
    const int b = r / H;
    const int h = r % H;
    for (int w0 = 0; w0 < W; w0 += PT) {
      __syncthreads();  // s_* written, or the previous round's reads done
      const int w = w0 + p;
      for (int ml = lane_row; ml < MT; ml += THREADS / PT) {
        float v = 0.f;
        const int dy = s_dy[ml];
        if (dy >= 0 && w < W) {
          int hh = h + dy - pad;
          int ww = w + s_dx[ml] - pad;
          if (REFLECT) {
            hh = reflect_index(hh, H);
            ww = reflect_index(ww, W);
          }
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = to_f32(x[(((size_t)b * H + hh) * C + s_c[ml]) * W + ww]);
        }
        as[p][ml] = v;
      }
      for (int nl = lane_row; nl < NT; nl += THREADS / PT) {
        const int n = n0 + nl;
        float v = 0.f;
        if (n < Cout && w < W)
          v = to_f32(g[(((size_t)b * H + h) * Cout + n) * W + w]);
        bs[p][nl] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < PT; ++q) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[q][mg + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = bs[q][ng + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
      }
    }
  }

  float* out = part + (size_t)split * M * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + mg + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ng + 8 * j;
      if (n < Cout) out[(size_t)m * Cout + n] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ part, int B, int H, int C, int W,
                       int Cout, int K, int pad, int splits) {
  __shared__ DwSmem sm;
  dw_partial<T, false>(sm, x, g, part, B, H, C, W, Cout, K, pad, splits);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_reflect_dw_partial_kernel(const T* __restrict__ x,
                               const T* __restrict__ g,
                               float* __restrict__ part, int B, int H, int C,
                               int W, int Cout, int K, int pad, int splits) {
  __shared__ DwSmem sm;
  dw_partial<T, true>(sm, x, g, part, B, H, C, W, Cout, K, pad, splits);
}

// dw[i] = part[0][i] + part[1][i] + ... in that order.
__device__ __forceinline__ void sum_splits(const float* __restrict__ part,
                                           float* __restrict__ dw, size_t n,
                                           int splits) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (size_t)gridDim.x * 256) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
    dw[i] = s;
  }
}

__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ dw,
                  size_t n, int splits) {
  sum_splits(part, dw, n, splits);
}

// the same sum for K9-dW, under its own name in a profiler trace
__global__ void __launch_bounds__(256)
reflect_sum_splits_kernel(const float* __restrict__ part,
                          float* __restrict__ dw, size_t n, int splits) {
  sum_splits(part, dw, n, splits);
}

template <typename T, bool REFLECT>
int launch(const void* x, const void* g, void* part, void* dw, int B, int H,
           int C, int W, int Cout, int K, int pad, int splits, void* stream) {
  if (splits < 1 || pad < 0 || pad > K - 1) return (int)cudaErrorInvalidValue;
  if (REFLECT && (K % 2 != 1 || pad != K / 2 || pad >= H || pad >= W))
    return (int)cudaErrorInvalidValue;
  const int M = K * K * C;
  dim3 grid((M + MT - 1) / MT, (Cout + NT - 1) / NT, splits);
  auto partial = REFLECT ? conv_reflect_dw_partial_kernel<T>
                         : conv_dw_partial_kernel<T>;
  partial<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (float*)part, B, H, C, W, Cout, K, pad,
      splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)M * Cout;
  auto sum = REFLECT ? reflect_sum_splits_kernel : sum_splits_kernel;
  sum<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)dw, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv_dw_f32(const void* x, const void* g, void* part, void* dw,
                           int B, int H, int C, int W, int Cout, int K,
                           int pad, int splits, void* stream) {
  return launch<float, false>(x, g, part, dw, B, H, C, W, Cout, K, pad,
                              splits, stream);
}

extern "C" int conv_dw_bf16(const void* x, const void* g, void* part,
                            void* dw, int B, int H, int C, int W, int Cout,
                            int K, int pad, int splits, void* stream) {
  return launch<__nv_bfloat16, false>(x, g, part, dw, B, H, C, W, Cout, K,
                                      pad, splits, stream);
}

extern "C" int conv_reflect_dw_f32(const void* x, const void* g, void* part,
                                   void* dw, int B, int H, int C, int W,
                                   int Cout, int K, int splits,
                                   void* stream) {
  return launch<float, true>(x, g, part, dw, B, H, C, W, Cout, K, K / 2,
                             splits, stream);
}

extern "C" int conv_reflect_dw_bf16(const void* x, const void* g, void* part,
                                    void* dw, int B, int H, int C, int W,
                                    int Cout, int K, int splits,
                                    void* stream) {
  return launch<__nv_bfloat16, true>(x, g, part, dw, B, H, C, W, Cout, K,
                                     K / 2, splits, stream);
}
