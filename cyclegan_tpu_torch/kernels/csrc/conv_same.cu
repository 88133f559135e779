// K1 conv_same: stride-1 TF-'SAME' KxK convolution on NHCW activations, and
// K9 conv_reflect: the same convolution of the reflect-padded input.
//
// K1 replaces cyclegan_tpu/ops/pallas_conv.py `_conv_fwd_call` (the factored
// im2col KxK forward) and `_conv1x1_call` (the 1x1 head): K = 1 is the same
// function with no padding. K9 replaces the forward of `conv2d_reflect_nhcw`
// (a reflect pad, then `_conv_fwd_call` on the pre-padded input).
//
// x   [B, H, C, W]     activations, W innermost (the JAX kernels' NHCW)
// w   [K, K, C, Cout]  HWIO weights, as stored in the checkpoint
// b   [Cout] or null   bias, added to the f32 sum before the store
// out [B, H, Cout, W]
// pad rows and columns before the image, the rest after. K1 pads with zeros:
// the forward of TF SAME pads (K-1)/2 before, (1, 2) for K = 4; the input
// gradient of that conv (this kernel on dY with flipped, ci<->co-swapped
// weights, as pallas_conv.py `_conv_bwd_rule`) pads K-1-(K-1)/2 before, 2 for
// K = 4. K9 takes odd K only and pads K/2 on each side by REFLECT (the edge
// is not repeated: row -1 is row 1, row H is row H-2), as the reference's
// ReflectionPadding2D; it needs K/2 < H and K/2 < W.
//
// Bound on the H100: operations. The generator's convs do 16-100 multiply-adds
// per byte moved, far above the ~1 the memory needs at CUDA-core rates. This
// first version is a direct convolution on the CUDA cores in f32 (no tensor
// cores yet): a block stages a (TILE_H + K - 1) x CI_CHUNK x (TILE_W + K - 1)
// input window and the K*K*CI_CHUNK*CO_TILE weights it needs into shared
// memory (zeros outside the image for K1; for K9 the window is read through
// the reflected index map, so no padded copy is written to device memory and
// the padding costs no branch in the inner loop), and each thread keeps
// CO_TILE output channels of one pixel in registers. Every staged input value
// is reused K*K*CO_TILE times; the weight reads are warp-wide broadcasts. A
// tensor-core implicit GEMM is later work.
#include "common.cuh"

namespace {

constexpr int TILE_W = 32;   // output columns per block: one warp across W
constexpr int TILE_H = 8;    // output rows per block: one warp per row
constexpr int CO_TILE = 16;  // output channels per thread, in registers
constexpr int CI_CHUNK = 8;  // input channels staged per shared-memory round

size_t smem_bytes(int K) {
  const size_t xs = (size_t)(TILE_H + K - 1) * CI_CHUNK * (TILE_W + K - 1);
  const size_t ws = (size_t)K * K * CI_CHUNK * CO_TILE;
  return (xs + ws) * sizeof(float);
}

// Source index of padded position i in an axis of n by REFLECT: -j -> j and
// n-1+j -> n-1-j. Positions past the reflected range stay out of [0, n) and
// read as zero; only outputs past the image edge, never stored, use them.
__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

template <typename T, bool REFLECT>
__device__ __forceinline__ void conv_tile(
    float* smem, const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out, int B, int H, int C,
    int W, int Cout, int K, int pad) {
  const int SW = TILE_W + K - 1;
  const int SH = TILE_H + K - 1;
  float* xs = smem;                         // [SH][CI_CHUNK][SW]
  float* ws = smem + SH * CI_CHUNK * SW;    // [K*K][CI_CHUNK][CO_TILE]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int nthreads = TILE_W * TILE_H;
  const int w0 = blockIdx.x * TILE_W;
  const int h0 = blockIdx.y * TILE_H;
  const int n_co_tiles = (Cout + CO_TILE - 1) / CO_TILE;
  const int b = blockIdx.z / n_co_tiles;
  const int co0 = (blockIdx.z % n_co_tiles) * CO_TILE;

  float acc[CO_TILE];
#pragma unroll
  for (int i = 0; i < CO_TILE; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CI_CHUNK) {
    __syncthreads();  // the previous round's reads are done
    const int n_x = SH * CI_CHUNK * SW;
    for (int i = tid; i < n_x; i += nthreads) {
      const int col = i % SW;
      const int rest = i / SW;
      const int ci = rest % CI_CHUNK;
      const int row = rest / CI_CHUNK;
      int hh = h0 + row - pad;
      int ww = w0 + col - pad;
      if (REFLECT) {
        hh = reflect_index(hh, H);
        ww = reflect_index(ww, W);
      }
      const int cc = c0 + ci;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && cc < C)
        v = to_f32(x[(((size_t)b * H + hh) * C + cc) * W + ww]);
      xs[i] = v;
    }
    const int n_w = K * K * CI_CHUNK * CO_TILE;
    for (int i = tid; i < n_w; i += nthreads) {
      const int co = i % CO_TILE;
      const int rest = i / CO_TILE;
      const int ci = rest % CI_CHUNK;
      const int tap = rest / CI_CHUNK;  // dy * K + dx
      const int cc = c0 + ci;
      const int oc = co0 + co;
      float v = 0.f;
      if (cc < C && oc < Cout) v = to_f32(w[((size_t)tap * C + cc) * Cout + oc]);
      ws[i] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < CI_CHUNK; ++ci) {
      for (int dy = 0; dy < K; ++dy) {
        const float* xrow = xs + ((ty + dy) * CI_CHUNK + ci) * SW + tx;
        const float* wtap = ws + ((dy * K) * CI_CHUNK + ci) * CO_TILE;
        for (int dx = 0; dx < K; ++dx) {
          const float xv = xrow[dx];
          const float4* wv =
              reinterpret_cast<const float4*>(wtap + dx * CI_CHUNK * CO_TILE);
#pragma unroll
          for (int q = 0; q < CO_TILE / 4; ++q) {
            const float4 f = wv[q];
            acc[4 * q + 0] = fmaf(xv, f.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv, f.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv, f.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv, f.w, acc[4 * q + 3]);
          }
        }
      }
    }
  }

  const int h = h0 + ty;
  const int wc = w0 + tx;
  if (h >= H || wc >= W) return;
#pragma unroll
  for (int co = 0; co < CO_TILE; ++co) {
    const int oc = co0 + co;
    if (oc < Cout) {
      float v = acc[co];
      if (bias != nullptr) v += to_f32(bias[oc]);
      out[(((size_t)b * H + h) * Cout + oc) * W + wc] = from_f32<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TILE_W * TILE_H)
conv_same_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ out, int B,
                 int H, int C, int W, int Cout, int K, int pad) {
  extern __shared__ __align__(16) float smem[];
  conv_tile<T, false>(smem, x, w, bias, out, B, H, C, W, Cout, K, pad);
}

template <typename T>
__global__ void __launch_bounds__(TILE_W * TILE_H)
conv_reflect_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ out, int B,
                    int H, int C, int W, int Cout, int K, int pad) {
  extern __shared__ __align__(16) float smem[];
  conv_tile<T, true>(smem, x, w, bias, out, B, H, C, W, Cout, K, pad);
}

template <typename T, bool REFLECT>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int H, int C, int W, int Cout, int K, int pad, void* stream) {
  if (pad < 0 || pad > K - 1) return (int)cudaErrorInvalidValue;
  if (REFLECT && (K % 2 != 1 || pad != K / 2 || pad >= H || pad >= W))
    return (int)cudaErrorInvalidValue;
  auto kernel = REFLECT ? conv_reflect_kernel<T> : conv_same_kernel<T>;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_co_tiles = (Cout + CO_TILE - 1) / CO_TILE;
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H,
            B * n_co_tiles);
  dim3 block(TILE_W, TILE_H);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)bias, (T*)out, B, H, C, W, Cout, K,
      pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv_same_f32(const void* x, const void* w, const void* bias,
                             void* out, int B, int H, int C, int W, int Cout,
                             int K, int pad, void* stream) {
  return launch<float, false>(x, w, bias, out, B, H, C, W, Cout, K, pad,
                              stream);
}

extern "C" int conv_same_bf16(const void* x, const void* w, const void* bias,
                              void* out, int B, int H, int C, int W, int Cout,
                              int K, int pad, void* stream) {
  return launch<__nv_bfloat16, false>(x, w, bias, out, B, H, C, W, Cout, K,
                                      pad, stream);
}

extern "C" int conv_reflect_f32(const void* x, const void* w,
                                const void* bias, void* out, int B, int H,
                                int C, int W, int Cout, int K, void* stream) {
  return launch<float, true>(x, w, bias, out, B, H, C, W, Cout, K, K / 2,
                             stream);
}

extern "C" int conv_reflect_bf16(const void* x, const void* w,
                                 const void* bias, void* out, int B, int H,
                                 int C, int W, int Cout, int K, void* stream) {
  return launch<__nv_bfloat16, true>(x, w, bias, out, B, H, C, W, Cout, K,
                                     K / 2, stream);
}
