// K14 (forward) and K15 (backward): U-GAT-IT's adaptive layer-instance norm
// (AdaLIN, and ILN with per-channel gamma and beta) on NHCW activations
// x [B, H, C, W], optionally followed by a ReLU:
//
//   y = (rho_c xhat_in + (1 - rho_c) xhat_ln) gamma[b,c] + beta[b,c]
//
// xhat_in normalizes over the (H, W) plane of each sample and channel,
// xhat_ln over the (C, H, W) volume of each sample, both with the unbiased
// variance and eps. Inputs and outputs are float or bf16, every statistic
// and coefficient f32.
//
// Forward, three launches: a CTA per plane walks its H rows of W elements
// (16-byte units where W and the pointers allow) and keeps (count, mean,
// M2), each unit's own two-pass moments merged in by Chan's formula, then
// merged over the CTA in a fixed order; one CTA then merges each sample's
// planes pairwise (Chan again, never sum-of-squares minus mean squared)
// into its layer statistics and folds everything into y = x A + Bc per
// plane; a grid-stride pass writes y. Backward, three launches: per plane
// P1 = sum g and P2 = sum g (x - mu_in), g the ReLU-masked gradient; one CTA
// forms dbeta, dgamma, drho (summed over the batch in order) and the
// coefficients of dx; a grid-stride pass writes
//   dx = g A + c_in (x - mu_in) + c_ln (x - mu_ln) + k3.
// No atomics: every sum has a fixed order, so runs are bit-identical.
#include "common.cuh"

namespace an {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Stat {
  float n, mean, m2;
};

__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return Stat{n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
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

// The CTA's merged statistics, in the same order every run: a shuffle-down
// tree in each warp, then the warps in order by thread 0.
__device__ Stat block_merge(Stat s, Stat* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stat o{__shfl_down_sync(FULL, s.n, off), __shfl_down_sync(FULL, s.mean, off),
           __shfl_down_sync(FULL, s.m2, off)};
    if ((threadIdx.x & 31) + off < 32) s = merge(s, o);
  }
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stat t = smem[0];
    for (int w = 1; w < THREADS / 32; ++w) t = merge(t, smem[w]);
    smem[0] = t;
  }
  __syncthreads();
  return smem[0];
}

// The CTA's sums of two values, in a fixed order (as block_merge).
__device__ float2 block_sum2(float a, float b, float2* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(FULL, a, off);
    b += __shfl_down_sync(FULL, b, off);
  }
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = smem[0];
    for (int w = 1; w < THREADS / 32; ++w) {
      t.x += smem[w].x;
      t.y += smem[w].y;
    }
    smem[0] = t;
  }
  __syncthreads();
  return smem[0];
}

// The plane (blockIdx.y = b, blockIdx.x = c): its mean and M2.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
ada_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ mu,
                      float* __restrict__ m2, int H, int C, int W) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int q = W / V;
  const int units = H * q;
  const size_t row = (size_t)C * W;
  const T* base = x + ((size_t)b * H * C + c) * W;
  Stat s{0.f, 0.f, 0.f};
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int h = u / q, j = u - h * q;
    float v[V];
    load<T, V>(base + h * row + (size_t)j * V, v);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) sum += v[i];
    const float m = sum * (1.f / V);
    float d2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) d2 += (v[i] - m) * (v[i] - m);
    s = merge(s, Stat{(float)V, m, d2});
  }
  __shared__ Stat smem[THREADS / 32];
  s = block_merge(s, smem);
  if (threadIdx.x == 0) {
    mu[(size_t)b * C + c] = s.mean;
    m2[(size_t)b * C + c] = s.m2;
  }
}

// One CTA: each sample's planes merged pairwise into its layer statistics,
// then each plane's r_in, A and Bc. saved: [5][B][C] = mu_in, M2_in, r_in,
// A, Bc; layer: [2][B] = mu_ln, r_ln.
__global__ void __launch_bounds__(THREADS)
ada_norm_finalize_kernel(const float* __restrict__ rho,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ saved, float* __restrict__ layer,
                         int B, int C, float n_in, float eps) {
  __shared__ Stat smem[THREADS];
  const size_t bc = (size_t)B * C;
  const float* mu = saved;
  const float* m2 = saved + bc;
  float* r_in = saved + 2 * bc;
  float* A = saved + 3 * bc;
  float* Bc = saved + 4 * bc;
  const int t = threadIdx.x;
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)b * C;
    Stat s{0.f, 0.f, 0.f};
    for (int c = t; c < C; c += THREADS)
      s = merge(s, Stat{n_in, mu[row + c], m2[row + c]});
    smem[t] = s;
    __syncthreads();
    for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
      if (t < stride) smem[t] = merge(smem[t], smem[t + stride]);
      __syncthreads();
    }
    const Stat ln = smem[0];
    __syncthreads();  // smem is the next sample's
    const float rl = 1.f / sqrtf(ln.m2 / (ln.n - 1.f) + eps);
    if (t == 0) {
      layer[b] = ln.mean;
      layer[B + b] = rl;
    }
    for (int c = t; c < C; c += THREADS) {
      const size_t k = row + c;
      const float ri = 1.f / sqrtf(m2[k] / (n_in - 1.f) + eps);
      const float p = rho[c], g = gamma[k];
      r_in[k] = ri;
      A[k] = g * (p * ri + (1.f - p) * rl);
      Bc[k] = beta[k] - g * (p * ri * mu[k] + (1.f - p) * rl * ln.mean);
    }
  }
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
ada_norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ A,
                      const float* __restrict__ Bc, T* __restrict__ y,
                      size_t units, int W, int C, size_t HC) {
  for (size_t u = (size_t)blockIdx.x * THREADS + threadIdx.x; u < units;
       u += (size_t)gridDim.x * THREADS) {
    const size_t e = u * V;
    const size_t r = e / W;
    const size_t k = (r / HC) * C + r % C;
    const float a = A[k], bb = Bc[k];
    float v[V];
    load<T, V>(x + e, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float o = fmaf(v[i], a, bb);
      v[i] = RELU ? fmaxf(o, 0.f) : o;
    }
    store<T, V>(y + e, v);
  }
}

// The plane's P1 = sum g and P2 = sum g (x - mu_in); p: [2][B][C].
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
ada_norm_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                           const float* __restrict__ saved,
                           float* __restrict__ p, int B, int H, int C, int W) {
  const int c = blockIdx.x, b = blockIdx.y;
  const size_t bc = (size_t)B * C, k = (size_t)b * C + c;
  const float m = saved[k], a = saved[3 * bc + k], bb = saved[4 * bc + k];
  const int q = W / V;
  const int units = H * q;
  const size_t row = (size_t)C * W;
  const size_t base = ((size_t)b * H * C + c) * W;
  float s1 = 0.f, s2 = 0.f;
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int h = u / q, j = u - h * q;
    const size_t e = base + h * row + (size_t)j * V;
    float v[V], g[V];
    load<T, V>(x + e, v);
    load<T, V>(gy + e, g);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gi = (RELU && !(fmaf(v[i], a, bb) > 0.f)) ? 0.f : g[i];
      s1 += gi;
      s2 += gi * (v[i] - m);
    }
  }
  __shared__ float2 smem[THREADS / 32];
  const float2 s = block_sum2(s1, s2, smem);
  if (threadIdx.x == 0) {
    p[k] = s.x;
    p[bc + k] = s.y;
  }
}

// One CTA: dbeta, dgamma ([B][C]), drho ([C], summed over b in order) and
// dx's coefficients: coef [2][B][C] = c_in, k3 (the plane's part); ln
// [2][B] = c_ln, k3 (the sample's part).
__global__ void __launch_bounds__(THREADS)
ada_norm_bwd_finalize_kernel(const float* __restrict__ rho,
                             const float* __restrict__ gamma,
                             const float* __restrict__ saved,
                             const float* __restrict__ layer,
                             const float* __restrict__ p,
                             float* __restrict__ coef, float* __restrict__ ln,
                             float* __restrict__ drho,
                             float* __restrict__ dgamma,
                             float* __restrict__ dbeta, int B, int C,
                             float n_in, float n_ln) {
  __shared__ float2 smem[THREADS];
  const size_t bc = (size_t)B * C;
  const float* mu = saved;
  const float* r_in = saved + 2 * bc;
  const int t = threadIdx.x;
  for (int b = 0; b < B; ++b) {
    const size_t row = (size_t)b * C;
    const float ml = layer[b], rl = layer[B + b];
    float g1 = 0.f, g2 = 0.f;
    for (int c = t; c < C; c += THREADS) {
      const size_t k = row + c;
      const float p1 = p[k], p2 = p[bc + k];
      const float ri = r_in[k], r = rho[c], g = gamma[k];
      const float s_in = ri * p2;
      const float s_ln = rl * (p2 + (mu[k] - ml) * p1);
      dbeta[k] = p1;
      dgamma[k] = r * s_in + (1.f - r) * s_ln;
      const float dr = g * (s_in - s_ln);
      drho[c] = b == 0 ? dr : drho[c] + dr;
      const float w = (1.f - r) * g;
      g1 += w * p1;
      g2 += w * s_ln;
      coef[k] = -r * g * ri * ri * s_in / (n_in - 1.f);
      coef[bc + k] = -r * g * ri * p1 / n_in;
    }
    smem[t] = make_float2(g1, g2);
    __syncthreads();
    for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
      if (t < stride) {
        smem[t].x += smem[t + stride].x;
        smem[t].y += smem[t + stride].y;
      }
      __syncthreads();
    }
    if (t == 0) {
      ln[b] = -rl * rl * smem[0].y / (n_ln - 1.f);
      ln[B + b] = -rl * smem[0].x / n_ln;
    }
    __syncthreads();
  }
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS)
ada_norm_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          const float* __restrict__ saved,
                          const float* __restrict__ layer,
                          const float* __restrict__ coef,
                          const float* __restrict__ ln, T* __restrict__ dx,
                          size_t units, int B, int W, int C, size_t HC) {
  const size_t bc = (size_t)B * C;
  for (size_t u = (size_t)blockIdx.x * THREADS + threadIdx.x; u < units;
       u += (size_t)gridDim.x * THREADS) {
    const size_t e = u * V;
    const size_t r = e / W;
    const size_t b = r / HC;
    const size_t k = b * C + r % C;
    const float m = saved[k], a = saved[3 * bc + k], bb = saved[4 * bc + k];
    const float ci = coef[k], k3 = coef[bc + k] + ln[B + b];
    const float cl = ln[b], ml = layer[b];
    float v[V], g[V];
    load<T, V>(x + e, v);
    load<T, V>(gy + e, g);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gi = (RELU && !(fmaf(v[i], a, bb) > 0.f)) ? 0.f : g[i];
      v[i] = gi * a + ci * (v[i] - m) + cl * (v[i] - ml) + k3;
    }
    store<T, V>(dx + e, v);
  }
}

template <typename T>
constexpr int vec_of() {
  return 16 / sizeof(T);
}

template <typename T, int V>
int forward(const T* x, const float* rho, const float* gamma,
            const float* beta, T* y, float* saved, float* layer, int B, int H,
            int C, int W, float eps, int relu, cudaStream_t s) {
  const size_t bc = (size_t)B * C;
  ada_norm_stats_kernel<T, V><<<dim3(C, B), THREADS, 0, s>>>(
      x, saved, saved + bc, H, C, W);
  ada_norm_finalize_kernel<<<1, THREADS, 0, s>>>(
      rho, gamma, beta, saved, layer, B, C, (float)H * W, eps);
  const size_t units = (size_t)B * H * C * W / V;
  const int grid = grid_for(units, THREADS);
  if (relu)
    ada_norm_apply_kernel<T, V, true><<<grid, THREADS, 0, s>>>(
        x, saved + 3 * bc, saved + 4 * bc, y, units, W, C, (size_t)H * C);
  else
    ada_norm_apply_kernel<T, V, false><<<grid, THREADS, 0, s>>>(
        x, saved + 3 * bc, saved + 4 * bc, y, units, W, C, (size_t)H * C);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool RELU>
void backward_passes(const T* x, const T* gy, const float* rho,
                     const float* gamma, const float* saved,
                     const float* layer, T* dx, float* p, float* coef,
                     float* ln, float* drho, float* dgamma, float* dbeta,
                     int B, int H, int C, int W, cudaStream_t s) {
  ada_norm_bwd_reduce_kernel<T, V, RELU><<<dim3(C, B), THREADS, 0, s>>>(
      x, gy, saved, p, B, H, C, W);
  ada_norm_bwd_finalize_kernel<<<1, THREADS, 0, s>>>(
      rho, gamma, saved, layer, p, coef, ln, drho, dgamma, dbeta, B, C,
      (float)H * W, (float)H * W * C);
  const size_t units = (size_t)B * H * C * W / V;
  ada_norm_bwd_apply_kernel<T, V, RELU><<<grid_for(units, THREADS), THREADS, 0,
                                          s>>>(x, gy, saved, layer, coef, ln,
                                               dx, units, B, W, C,
                                               (size_t)H * C);
}

template <typename T>
int fwd_entry(const void* x, const void* rho, const void* gamma,
              const void* beta, void* y, void* saved, void* layer, int B,
              int H, int C, int W, float eps, int relu, int vec,
              void* stream) {
  constexpr int V = vec_of<T>();
  const bool fits = W % V == 0 && aligned16(x) && aligned16(y);
  if (B < 1 || H * W < 2 || C < 1 || (vec && !fits) || (!vec && fits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const T* xp = (const T*)x;
  T* yp = (T*)y;
  const float *r = (const float*)rho, *g = (const float*)gamma,
              *bt = (const float*)beta;
  if (vec)
    return forward<T, V>(xp, r, g, bt, yp, (float*)saved, (float*)layer, B, H,
                         C, W, eps, relu, s);
  return forward<T, 1>(xp, r, g, bt, yp, (float*)saved, (float*)layer, B, H, C,
                       W, eps, relu, s);
}

template <typename T>
int bwd_entry(const void* x, const void* gy, const void* rho,
              const void* gamma, const void* saved, const void* layer,
              void* dx, void* p, void* coef, void* ln, void* drho,
              void* dgamma, void* dbeta, int B, int H, int C, int W, int relu,
              int vec, void* stream) {
  constexpr int V = vec_of<T>();
  const bool fits =
      W % V == 0 && aligned16(x) && aligned16(gy) && aligned16(dx);
  if (B < 1 || H * W < 2 || C < 1 || (vec && !fits) || (!vec && fits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const T *xp = (const T*)x, *gp = (const T*)gy;
  const float *r = (const float*)rho, *g = (const float*)gamma,
              *sv = (const float*)saved, *ly = (const float*)layer;
  float *pp = (float*)p, *cf = (float*)coef, *lp = (float*)ln,
        *dr = (float*)drho, *dg = (float*)dgamma, *db = (float*)dbeta;
  T* dxp = (T*)dx;
#define AN_BWD(VV, RR)                                                        \
  backward_passes<T, VV, RR>(xp, gp, r, g, sv, ly, dxp, pp, cf, lp, dr, dg, \
                             db, B, H, C, W, s)
  if (vec && relu) AN_BWD(V, true);
  else if (vec) AN_BWD(V, false);
  else if (relu) AN_BWD(1, true);
  else AN_BWD(1, false);
#undef AN_BWD
  return (int)cudaGetLastError();
}

}  // namespace an

extern "C" int ada_norm_f32(const void* x, const void* rho, const void* gamma,
                            const void* beta, void* y, void* saved,
                            void* layer, int B, int H, int C, int W, float eps,
                            int relu, int vec, void* stream) {
  return an::fwd_entry<float>(x, rho, gamma, beta, y, saved, layer, B, H, C, W,
                              eps, relu, vec, stream);
}

extern "C" int ada_norm_bf16(const void* x, const void* rho, const void* gamma,
                             const void* beta, void* y, void* saved,
                             void* layer, int B, int H, int C, int W,
                             float eps, int relu, int vec, void* stream) {
  return an::fwd_entry<__nv_bfloat16>(x, rho, gamma, beta, y, saved, layer, B,
                                      H, C, W, eps, relu, vec, stream);
}

extern "C" int ada_norm_bwd_f32(const void* x, const void* gy, const void* rho,
                                const void* gamma, const void* saved,
                                const void* layer, void* dx, void* p,
                                void* coef, void* ln, void* drho,
                                void* dgamma, void* dbeta, int B, int H, int C,
                                int W, int relu, int vec, void* stream) {
  return an::bwd_entry<float>(x, gy, rho, gamma, saved, layer, dx, p, coef, ln,
                              drho, dgamma, dbeta, B, H, C, W, relu, vec,
                              stream);
}

extern "C" int ada_norm_bwd_bf16(const void* x, const void* gy,
                                 const void* rho, const void* gamma,
                                 const void* saved, const void* layer,
                                 void* dx, void* p, void* coef, void* ln,
                                 void* drho, void* dgamma, void* dbeta, int B,
                                 int H, int C, int W, int relu, int vec,
                                 void* stream) {
  return an::bwd_entry<__nv_bfloat16>(x, gy, rho, gamma, saved, layer, dx, p,
                                      coef, ln, drho, dgamma, dbeta, B, H, C,
                                      W, relu, vec, stream);
}
