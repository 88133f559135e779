// K13 instance_norm_nhwc: instance norm over the spatial positions of NHWC
// activations, with the statistics the backward reads.
//
// Replaces cyclegan_tpu/ops/pallas_norm.py `_forward_call`, the two-phase
// kernel of the NHWC layout (`pallas_norm: true`). Its sequential grid
// (sample, 2 phases, HW chunks) carried the sums in VMEM scratch from one
// step to the next; blocks of a GPU run in no order, so the phases become
// two launches here.
//
// x [N, HW, C] (C innermost); gamma, beta [C] in x's type, both or neither;
// y like x; mean, rstd [N, C] f32; ws_sum, ws_sq [N, splits, C] f32 scratch.
// Per (sample, channel), as the Pallas kernel: f32 sums of x and x^2,
// mean = sum / HW, var = max(sumsq / HW - mean^2, 0), rstd = rsqrt(var +
// eps), y = (x - mean) * rstd [* gamma + beta], stored in x's type.
//
// Bound on the H100: bytes (about 7 operations per element). C is innermost,
// so neighbouring threads take neighbouring channels and a warp reads
// contiguous memory; with VEC, each thread moves 16 bytes (8 bf16 or 4 f32
// channels), else one element. A block owns a tile of at most 32 channel
// vectors and one of `splits` row ranges of one sample, so a layer with few
// samples and channels still fills the 132 SMs (one block per sample and
// channel tile would give 8 blocks at batch 8).
//   launch 1: each block sums x and x^2 of its rows into ws (its split's
//             slot), reducing over its row lanes in a fixed order;
//   launch 2: each block adds the splits' sums in a fixed order (no float
//             atomics, so runs repeat bit for bit), computes mean and rstd
//             (split 0 writes them out) and normalizes its rows.
// x is read twice (the second read mostly from the 50 MB L2) and y written
// once, as the Pallas kernel's two phases do.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Rows [r0, r1) of split s: the same for both launches.
__device__ __forceinline__ void split_rows(int HW, int splits, int s, int& r0,
                                           int& r1) {
  r0 = (int)((long long)HW * s / splits);
  r1 = (int)((long long)HW * (s + 1) / splits);
}

// grid (channel tiles, splits, N); `tile` channel vectors per block, so
// THREADS / tile row lanes.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
partial_sums_kernel(const T* __restrict__ x, float* __restrict__ ws_sum,
                    float* __restrict__ ws_sq, int HW, int C, int splits,
                    int tile) {
  __shared__ float red[2][THREADS * V];
  const int n = blockIdx.z;
  const int s = blockIdx.y;
  const int rows = THREADS / tile;
  const int tv = threadIdx.x % tile;
  const int ty = threadIdx.x / tile;
  const int c0 = (blockIdx.x * tile + tv) * V;  // this thread's first channel
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  int r0, r1;
  split_rows(HW, splits, s, r0, r1);
  if (ty < rows && c0 < C) {
    const T* base = x + (size_t)n * HW * C + c0;
    for (int r = r0 + ty; r < r1; r += rows) {
      float v[V];
      load_v<T, V>(base + (size_t)r * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += v[i];
        s2[i] += v[i] * v[i];
      }
    }
  }
  if (ty < rows) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[0][(ty * tile + tv) * V + i] = s1[i];
      red[1][(ty * tile + tv) * V + i] = s2[i];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile * V; t += THREADS) {
    const int c = blockIdx.x * tile * V + t;
    if (c >= C) continue;
    float a = 0.f, q = 0.f;
    for (int k = 0; k < rows; ++k) {  // fixed order
      a += red[0][k * tile * V + t];
      q += red[1][k * tile * V + t];
    }
    const size_t slot = ((size_t)n * splits + s) * C + c;
    ws_sum[slot] = a;
    ws_sq[slot] = q;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
normalize_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                 const T* __restrict__ beta, T* __restrict__ y,
                 const float* __restrict__ ws_sum,
                 const float* __restrict__ ws_sq, float* __restrict__ mean_out,
                 float* __restrict__ rstd_out, int HW, int C, int splits,
                 int tile, float eps) {
  __shared__ float s_mean[32 * V], s_rstd[32 * V], s_g[32 * V], s_b[32 * V];
  const int n = blockIdx.z;
  const int s = blockIdx.y;
  const int rows = THREADS / tile;
  const int tv = threadIdx.x % tile;
  const int ty = threadIdx.x / tile;
  const bool affine = gamma != nullptr;
  const float count = (float)HW;
  for (int t = threadIdx.x; t < tile * V; t += THREADS) {
    const int c = blockIdx.x * tile * V + t;
    if (c >= C) continue;
    float a = 0.f, q = 0.f;
    for (int k = 0; k < splits; ++k) {  // fixed order: every block agrees
      a += ws_sum[((size_t)n * splits + k) * C + c];
      q += ws_sq[((size_t)n * splits + k) * C + c];
    }
    const float mean = a / count;
    const float var = fmaxf(q / count - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    if (s == 0) {
      mean_out[(size_t)n * C + c] = mean;
      rstd_out[(size_t)n * C + c] = rstd;
    }
    s_mean[t] = mean;
    s_rstd[t] = rstd;
    s_g[t] = affine ? to_f32(gamma[c]) : 1.f;
    s_b[t] = affine ? to_f32(beta[c]) : 0.f;
  }
  __syncthreads();
  const int c0 = (blockIdx.x * tile + tv) * V;
  if (ty >= rows || c0 >= C) return;
  float m[V], r[V], g[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = s_mean[tv * V + i];
    r[i] = s_rstd[tv * V + i];
    g[i] = s_g[tv * V + i];
    b[i] = s_b[tv * V + i];
  }
  int r0, r1;
  split_rows(HW, splits, s, r0, r1);
  const size_t base = (size_t)n * HW * C + c0;
  for (int row = r0 + ty; row < r1; row += rows) {
    float v[V];
    load_v<T, V>(x + base + (size_t)row * C, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = (v[i] - m[i]) * r[i];
      if (affine) v[i] = v[i] * g[i] + b[i];
    }
    store_v<T, V>(y + base + (size_t)row * C, v);
  }
}

template <typename T, int V>
int launch_v(const void* x, const void* gamma, const void* beta, void* y,
             void* mean, void* rstd, void* ws_sum, void* ws_sq, int N, int HW,
             int C, int splits, float eps, cudaStream_t stream) {
  const int cv = C / V;
  const int tile = cv < 32 ? cv : 32;
  const dim3 grid((cv + tile - 1) / tile, splits, N);
  partial_sums_kernel<T, V><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (float*)ws_sum, (float*)ws_sq, HW, C, splits, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  normalize_kernel<T, V><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const T*)gamma, (const T*)beta, (T*)y,
      (const float*)ws_sum, (const float*)ws_sq, (float*)mean, (float*)rstd,
      HW, C, splits, tile, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           void* mean, void* rstd, void* ws_sum, void* ws_sq, int N, int HW,
           int C, int splits, float eps, int vec, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if ((gamma == nullptr) != (beta == nullptr) || N < 1 || HW < 1 || C < 1 ||
      splits < 1 || N > 65535 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (C % V != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    return launch_v<T, V>(x, gamma, beta, y, mean, rstd, ws_sum, ws_sq, N, HW,
                          C, splits, eps, s);
  }
  return launch_v<T, 1>(x, gamma, beta, y, mean, rstd, ws_sum, ws_sq, N, HW,
                        C, splits, eps, s);
}

}  // namespace

extern "C" int instance_norm_nhwc_f32(const void* x, const void* gamma,
                                      const void* beta, void* y, void* mean,
                                      void* rstd, void* ws_sum, void* ws_sq,
                                      int N, int HW, int C, int splits,
                                      float eps, int vec, void* stream) {
  return launch<float>(x, gamma, beta, y, mean, rstd, ws_sum, ws_sq, N, HW, C,
                       splits, eps, vec, stream);
}

extern "C" int instance_norm_nhwc_bf16(const void* x, const void* gamma,
                                       const void* beta, void* y, void* mean,
                                       void* rstd, void* ws_sum, void* ws_sq,
                                       int N, int HW, int C, int splits,
                                       float eps, int vec, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, ws_sum, ws_sq,
                               N, HW, C, splits, eps, vec, stream);
}
