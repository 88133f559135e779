// K6 norm_act_bwd: the backward of instance norm + activation (K2) on NHCW
// activations.
//
// Replaces cyclegan_tpu/ops/pallas_norm_act.py `_bwd_call` (slab < 3 MB) and
// `_bwd_stream_call` (slab >= 3 MB); the split was a VMEM artefact, one design
// covers both here, as K2 does for the forward.
//
// x, gz [B, H, C, W]; gamma, beta [C] in x's type or null (1 and 0);
// mu, rstd [B, C] f32, the forward's statistics (K2 writes them).
// Per (sample, channel) plane of n = H*W values:
//   xhat = (x - mu) * rstd,  v = gamma * xhat + beta,  dv = gz * act'(v)
//   t1 = sum dv,  t2 = sum dv * xhat                  (f32, written [B, C])
//   dx = gamma * rstd * (dv - t1 / n - xhat * t2 / n)  (x's type)
// act'(v) is 1 where v > 0 for relu and 0 elsewhere (v = 0 included),
// 1 where v >= 0 and alpha elsewhere for leaky_relu, and 1 for none, as
// pallas_norm_act.py `_act_grad`. dgamma and dbeta are the sums of t2 and t1
// over the batch, which the caller takes.
//
// Bound on the H100: bytes (about 20 flops per element against x and gz read
// and dx written). As K2: one block per plane walks its rows at stride C*W
// with coalesced loads, reduces in f32 registers, warp shuffles and shared
// memory, and sweeps the plane a second time to write dx; the second read of
// x and gz mostly hits L2.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) s += red[i];
  return s;
}

// v = gamma * xhat + beta rounded twice, with no fused multiply-add, as the
// plain version's separate multiply and add: act'(v) changes by O(1) at
// v = 0, so the two must agree on v's sign bit for bit.
__device__ __forceinline__ float affine(float xhat, float g, float be) {
  return __fadd_rn(__fmul_rn(xhat, g), be);
}

__device__ __forceinline__ float act_grad(float v, int act, float alpha) {
  if (act == ACT_RELU) return v > 0.f ? 1.f : 0.f;
  if (act == ACT_LEAKY) return v >= 0.f ? 1.f : alpha;
  return 1.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gz,
                    const T* __restrict__ gamma, const T* __restrict__ beta,
                    const float* __restrict__ mu_in,
                    const float* __restrict__ rstd_in, T* __restrict__ dx,
                    float* __restrict__ t1_out, float* __restrict__ t2_out,
                    int H, int C, int W, int act, float alpha) {
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x % C;
  const int n = H * W;
  const size_t row_stride = (size_t)C * W;
  const size_t base = ((size_t)(blockIdx.x / C) * H * C + c) * W;
  const float mu = mu_in[blockIdx.x];
  const float rstd = rstd_in[blockIdx.x];
  const float g = gamma != nullptr ? to_f32(gamma[c]) : 1.f;
  const float be = beta != nullptr ? to_f32(beta[c]) : 0.f;

  float s1 = 0.f;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int h = i / W;
    const size_t off = base + h * row_stride + (i - h * W);
    const float xhat = (to_f32(x[off]) - mu) * rstd;
    const float dv =
        to_f32(gz[off]) * act_grad(affine(xhat, g, be), act, alpha);
    s1 += dv;
    s2 += dv * xhat;
  }
  const float t1 = block_sum(s1, red);
  const float t2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    t1_out[blockIdx.x] = t1;
    t2_out[blockIdx.x] = t2;
  }
  const float inv_n = 1.f / (float)n;
  const float k = g * rstd;
  const float m1 = t1 * inv_n;
  const float m2 = t2 * inv_n;

  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int h = i / W;
    const size_t off = base + h * row_stride + (i - h * W);
    const float xhat = (to_f32(x[off]) - mu) * rstd;
    const float dv =
        to_f32(gz[off]) * act_grad(affine(xhat, g, be), act, alpha);
    dx[off] = from_f32<T>(k * (dv - m1 - xhat * m2));
  }
}

template <typename T>
int launch(const void* x, const void* gz, const void* gamma, const void* beta,
           const void* mu, const void* rstd, void* dx, void* t1, void* t2,
           int B, int H, int C, int W, int act, float alpha, void* stream) {
  norm_act_bwd_kernel<T><<<B * C, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)gz, (const T*)gamma, (const T*)beta,
      (const float*)mu, (const float*)rstd, (T*)dx, (float*)t1, (float*)t2, H,
      C, W, act, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int norm_act_bwd_f32(const void* x, const void* gz,
                                const void* gamma, const void* beta,
                                const void* mu, const void* rstd, void* dx,
                                void* t1, void* t2, int B, int H, int C, int W,
                                int act, float alpha, void* stream) {
  return launch<float>(x, gz, gamma, beta, mu, rstd, dx, t1, t2, B, H, C, W,
                       act, alpha, stream);
}

extern "C" int norm_act_bwd_bf16(const void* x, const void* gz,
                                 const void* gamma, const void* beta,
                                 const void* mu, const void* rstd, void* dx,
                                 void* t1, void* t2, int B, int H, int C,
                                 int W, int act, float alpha, void* stream) {
  return launch<__nv_bfloat16>(x, gz, gamma, beta, mu, rstd, dx, t1, t2, B, H,
                               C, W, act, alpha, stream);
}
