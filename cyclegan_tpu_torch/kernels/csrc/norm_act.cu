// K2 instance_norm_act_fwd: instance norm + activation on NHCW activations.
//
// Replaces cyclegan_tpu/ops/pallas_norm_act.py `_fwd_call` (slab < 3 MB) and
// `_fwd_stream_call` (slab >= 3 MB, hand-pipelined DMA). The split was a VMEM
// artefact of the TPU; one kernel covers both here.
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
// once and write out once, and it does (norm_act.cuh): each thread loads its
// 4 slots of 16 bytes once into registers, all in flight together; the
// sums, the f32 second pass and the output pass read that copy. Planes of
// up to 1,024 slots (64x128 bf16) share a CTA, a warp or more each; larger
// planes split their rows over a cluster of up to 8 CTAs (2 at 128x128
// bf16, 8 at 256x256), which exchange f32 partial sums through distributed
// shared memory. Which shapes take which (`na::geometry`,
// cuda_norm_act.norm_act_geometry): every bf16 launch of the recipes keeps
// its slots in registers; W % 8 != 0 (bf16) or % 4 != 0 (f32) takes
// one-element slots and reads x again for each pass, as do planes whose
// cluster share exceeds 1,024 slots (f32 256x256, 512x512). One launch per
// call.
#include "norm_act.cuh"

namespace {

using na::Pack;

// four CTAs per SM: 64 registers a thread. ptxas then keeps the slots
// packed; with more room it holds their f32 values as well, twice the
// registers, and the launches ran slower on an H100.
constexpr int MIN_BLOCKS = 4;

template <typename T, int V, bool RES, bool TWO_PASS, int ACT>
__global__ void __launch_bounds__(na::THREADS, MIN_BLOCKS)
norm_act_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                const T* __restrict__ beta, T* __restrict__ out,
                float* __restrict__ mu_out, float* __restrict__ rstd_out,
                int H, int C, int W, int channels, int cluster, int rows,
                float eps, float alpha) {
  constexpr int NV = na::SLOTS;
  __shared__ na::Red red;
  const na::Place p = na::place(H, C, W, V, channels, cluster, rows);
  Pack<T, V> buf[RES ? NV : 1];
  if constexpr (RES) {  // every load in flight before the first use
    na::walk<NV, RES, V>(p, [&](int s, size_t off) {
      buf[s] = na::load<T, V>(x + off);
    });
  }
  auto slot = [&](int s, size_t off) {
    if constexpr (RES) {
      return buf[s];
    } else {
      return na::load<T, V>(x + off);
    }
  };

  float sums[2] = {0.f, 0.f};
  na::walk<NV, RES, V>(p, [&](int s, size_t off) {
    const Pack<T, V> v = slot(s, off);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = to_f32(v.v[e]);
      sums[0] += f;
      if (!TWO_PASS) sums[1] += f * f;
    }
  });
  na::plane_sums<2>(sums, red, 0, channels, cluster, p.cl);
  const float inv_n = 1.f / (float)(H * W);
  const float mu = sums[0] * inv_n;
  float var;
  if constexpr (TWO_PASS) {
    float d2[1] = {0.f};
    na::walk<NV, RES, V>(p, [&](int s, size_t off) {
      const Pack<T, V> v = slot(s, off);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = to_f32(v.v[e]) - mu;
        d2[0] += d * d;
      }
    });
    na::plane_sums<1>(d2, red, 1, channels, cluster, p.cl);
    var = d2[0] * inv_n;
  } else {
    var = fmaxf(sums[1] * inv_n - mu * mu, 0.f);
  }
  if (cluster > 1) na::cluster_arrive();  // this rank's remote reads are done
  const float rstd = rsqrtf(var + eps);
  if (mu_out != nullptr && p.lead) {
    mu_out[p.b * C + p.c] = mu;
    rstd_out[p.b * C + p.c] = rstd;
  }
  const float g = gamma != nullptr ? to_f32(gamma[p.c]) : 1.f;
  const float be = beta != nullptr ? to_f32(beta[p.c]) : 0.f;
  const float a = g * rstd;

  na::walk<NV, RES, V>(p, [&](int s, size_t off) {
    const Pack<T, V> v = slot(s, off);
    Pack<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float y = (to_f32(v.v[e]) - mu) * a + be;
      o.v[e] = from_f32<T>(na::activate<ACT>(y, alpha));
    }
    na::store<T, V>(out + off, o);
  });
  // keep this CTA's partials alive until every rank has read them
  if (cluster > 1) na::cluster_wait();
}

template <typename T, int V, bool RES>
int run(const na::Geometry& g, const void* x, const void* gamma,
        const void* beta, void* out, void* mu, void* rstd, int B, int H,
        int C, int W, float eps, int act, float alpha, void* stream) {
  constexpr bool TWO_PASS = sizeof(T) == 4;
  return na::with_act(act, [&](auto a) {
    return na::launch(g, B, C, stream,
                      norm_act_kernel<T, V, RES, TWO_PASS, decltype(a)::value>,
                      (const T*)x, (const T*)gamma, (const T*)beta, (T*)out,
                      (float*)mu, (float*)rstd, H, C, W, g.channels,
                      g.cluster, g.rows, eps, alpha);
  });
}

template <typename T>
int entry(const void* x, const void* gamma, const void* beta, void* out,
          void* mu, void* rstd, int B, int H, int C, int W, float eps,
          int act, float alpha, int vec, int channels, int cluster, int rows,
          int slots, int resident, void* stream) {
  if ((mu == nullptr) != (rstd == nullptr)) return (int)cudaErrorInvalidValue;
  const na::Geometry g =
      na::geometry(B, H, C, W, (int)sizeof(T), 1,
                   na::aligned16(x) && na::aligned16(out));
  if (!na::same(g, vec, channels, cluster, rows, slots, resident))
    return (int)cudaErrorInvalidValue;  // the wrapper's rule has drifted
  constexpr int V16 = 16 / sizeof(T);
  if (g.resident)
    return run<T, V16, true>(g, x, gamma, beta, out, mu, rstd, B, H, C, W,
                             eps, act, alpha, stream);
  if (g.vec == V16)
    return run<T, V16, false>(g, x, gamma, beta, out, mu, rstd, B, H, C, W,
                              eps, act, alpha, stream);
  return run<T, 1, false>(g, x, gamma, beta, out, mu, rstd, B, H, C, W, eps,
                          act, alpha, stream);
}

}  // namespace

extern "C" int instance_norm_act_f32(const void* x, const void* gamma,
                                     const void* beta, void* out, void* mu,
                                     void* rstd, int B, int H, int C, int W,
                                     float eps, int act, float alpha, int vec,
                                     int channels, int cluster, int rows,
                                     int slots, int resident, void* stream) {
  return entry<float>(x, gamma, beta, out, mu, rstd, B, H, C, W, eps, act,
                      alpha, vec, channels, cluster, rows, slots, resident,
                      stream);
}

extern "C" int instance_norm_act_bf16(const void* x, const void* gamma,
                                      const void* beta, void* out, void* mu,
                                      void* rstd, int B, int H, int C, int W,
                                      float eps, int act, float alpha,
                                      int vec, int channels, int cluster,
                                      int rows, int slots, int resident,
                                      void* stream) {
  return entry<__nv_bfloat16>(x, gamma, beta, out, mu, rstd, B, H, C, W, eps,
                              act, alpha, vec, channels, cluster, rows, slots,
                              resident, stream);
}
