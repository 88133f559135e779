// K2 instance_norm_act_fwd: instance norm + activation on NHCW activations.
//
// Replaces cyclegan_tpu/ops/pallas_norm_act.py `_fwd_call` (slab < 3 MB) and
// `_fwd_stream_call` (slab >= 3 MB, hand-pipelined DMA). The split was a VMEM
// artefact of the TPU; one design covers both here.
//
// x [B, H, C, W]; gamma, beta [C] in x's type or null (1 and 0); out like x;
// mu, rstd [B, C] f32 or null: the statistics, written for the backward
// (K6, norm_act_bwd.cu) as the Pallas forward writes its residuals, and left
// out (null) when serving.
// Per (sample, channel): mu = E[x], var from f32 sums, eps 1e-3 by default,
// out = act((x - mu) * gamma * rstd + beta), act in {none, relu, leaky_relu}.
// Statistics follow the JAX package: bf16 input takes one sweep with
// var = max(E[x^2] - mu^2, 0) (pallas_norm_act.py `_fwd_kernel`); f32 input
// takes the two-pass variance of ops/norm.py (the TF-parity path).
//
// Bound on the H100: bytes. The op does ~8 flops per element and must read x
// once and write out once. One block owns one (sample, channel) plane: it
// walks the plane's H rows (W contiguous elements each, row stride C*W) with
// coalesced loads, reduces in f32 registers, then warp shuffles and shared
// memory, and makes a second sweep to write. That second read of x (and the
// third for f32) mostly hits the 50 MB L2 for the generator's planes
// (<= 128 KB each). Spreading one plane over several blocks (a cross-block
// reduction) is later work for the planes that leave SMs idle.
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

template <typename T, bool TWO_PASS>
__global__ void __launch_bounds__(THREADS)
norm_act_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                const T* __restrict__ beta, T* __restrict__ out,
                float* __restrict__ mu_out, float* __restrict__ rstd_out,
                int H, int C, int W, float eps, int act, float alpha) {
  __shared__ float red[THREADS / 32];
  const int b = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const int n = H * W;
  const size_t row_stride = (size_t)C * W;
  const size_t base = ((size_t)b * H * C + c) * W;

  float s1 = 0.f;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int h = i / W;
    const float v = to_f32(x[base + h * row_stride + (i - h * W)]);
    s1 += v;
    if (!TWO_PASS) s2 += v * v;
  }
  const float inv_n = 1.f / (float)n;
  const float mu = block_sum(s1, red) * inv_n;
  float var;
  if (TWO_PASS) {
    float d2 = 0.f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int h = i / W;
      const float d = to_f32(x[base + h * row_stride + (i - h * W)]) - mu;
      d2 += d * d;
    }
    var = block_sum(d2, red) * inv_n;
  } else {
    var = fmaxf(block_sum(s2, red) * inv_n - mu * mu, 0.f);
  }
  const float rstd = rsqrtf(var + eps);
  if (mu_out != nullptr && threadIdx.x == 0) {
    mu_out[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rstd;
  }
  const float g = gamma != nullptr ? to_f32(gamma[c]) : 1.f;
  const float be = beta != nullptr ? to_f32(beta[c]) : 0.f;
  const float a = g * rstd;

  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int h = i / W;
    const size_t off = base + h * row_stride + (i - h * W);
    float v = (to_f32(x[off]) - mu) * a + be;
    if (act == ACT_RELU) {
      v = fmaxf(v, 0.f);
    } else if (act == ACT_LEAKY) {
      v = v >= 0.f ? v : v * alpha;
    }
    out[off] = from_f32<T>(v);
  }
}

template <typename T, bool TWO_PASS>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           void* mu, void* rstd, int B, int H, int C, int W, float eps,
           int act, float alpha, void* stream) {
  if ((mu == nullptr) != (rstd == nullptr)) return (int)cudaErrorInvalidValue;
  norm_act_kernel<T, TWO_PASS><<<B * C, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)gamma, (const T*)beta, (T*)out, (float*)mu,
      (float*)rstd, H, C, W, eps, act, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int instance_norm_act_f32(const void* x, const void* gamma,
                                     const void* beta, void* out, void* mu,
                                     void* rstd, int B, int H, int C, int W,
                                     float eps, int act, float alpha,
                                     void* stream) {
  return launch<float, true>(x, gamma, beta, out, mu, rstd, B, H, C, W, eps,
                             act, alpha, stream);
}

extern "C" int instance_norm_act_bf16(const void* x, const void* gamma,
                                      const void* beta, void* out, void* mu,
                                      void* rstd, int B, int H, int C, int W,
                                      float eps, int act, float alpha,
                                      void* stream) {
  return launch<__nv_bfloat16, false>(x, gamma, beta, out, mu, rstd, B, H, C,
                                      W, eps, act, alpha, stream);
}
