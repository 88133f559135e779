// K6 norm_act_bwd: the backward of instance norm + activation (K2) on NHCW
// activations.
//
// Replaces cyclegan_tpu/ops/pallas_norm_act.py `_bwd_call` (slab < 3 MB) and
// `_bwd_stream_call` (slab >= 3 MB); the split was a VMEM artefact, one
// kernel covers both here, as K2 does for the forward.
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
// and dx written). As K2 (norm_act.cuh): each thread loads its 4 slots of x
// and 4 of gz once into registers, sums dv and dv * xhat in f32, and writes
// dx from that copy. Planes of up to 1,024 slots share a CTA; larger planes
// split their rows over a cluster of up to 8 CTAs, which exchange the two
// partial sums through distributed shared memory. Every bf16 launch of the
// recipes keeps its slots in registers; one-element slots (a ragged W) and
// planes whose cluster share exceeds 1,024 slots (f32 256x256, 512x512)
// read x and gz again for the dx pass. The activation is a template
// argument: no element tests it. One launch per call.
#include "norm_act.cuh"

namespace {

using na::Pack;

// v = gamma * xhat + beta rounded twice, with no fused multiply-add, as the
// plain version's separate multiply and add: act'(v) changes by O(1) at
// v = 0, so the two must agree on v's sign bit for bit.
__device__ __forceinline__ float affine(float xhat, float g, float be) {
  return __fadd_rn(__fmul_rn(xhat, g), be);
}

// gz * act'(v)
template <int ACT>
__device__ __forceinline__ float act_grad(float gz, float v, float alpha) {
  if constexpr (ACT == na::ACT_RELU) return v > 0.f ? gz : 0.f;
  if constexpr (ACT == na::ACT_LEAKY) return v >= 0.f ? gz : gz * alpha;
  return gz;
}

template <typename T, int V, bool RES, int ACT>
__global__ void __launch_bounds__(na::THREADS)
norm_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gz,
                    const T* __restrict__ gamma, const T* __restrict__ beta,
                    const float* __restrict__ mu_in,
                    const float* __restrict__ rstd_in, T* __restrict__ dx,
                    float* __restrict__ t1_out, float* __restrict__ t2_out,
                    int H, int C, int W, int channels, int cluster, int rows,
                    float alpha) {
  constexpr int NV = na::SLOTS;
  __shared__ na::Red red;
  const na::Place p = na::place(H, C, W, V, channels, cluster, rows);
  Pack<T, V> bx[RES ? NV : 1], bg[RES ? NV : 1];
  if constexpr (RES) {  // every load in flight before the first use
    na::walk<NV, RES, V>(p, [&](int s, size_t off) {
      bx[s] = na::load<T, V>(x + off);
      bg[s] = na::load<T, V>(gz + off);
    });
  }
  const float mu = mu_in[p.b * C + p.c];
  const float rstd = rstd_in[p.b * C + p.c];
  const float g = gamma != nullptr ? to_f32(gamma[p.c]) : 1.f;
  const float be = beta != nullptr ? to_f32(beta[p.c]) : 0.f;
  // f(e, xhat, dv) for each element e of slot s
  auto each = [&](int s, size_t off, auto&& f) {
    Pack<T, V> vx, vg;
    if constexpr (RES) {
      vx = bx[s];
      vg = bg[s];
    } else {
      vx = na::load<T, V>(x + off);
      vg = na::load<T, V>(gz + off);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xhat = (to_f32(vx.v[e]) - mu) * rstd;
      const float dv =
          act_grad<ACT>(to_f32(vg.v[e]), affine(xhat, g, be), alpha);
      f(e, xhat, dv);
    }
  };

  float sums[2] = {0.f, 0.f};
  na::walk<NV, RES, V>(p, [&](int s, size_t off) {
    each(s, off, [&](int, float xhat, float dv) {
      sums[0] += dv;
      sums[1] += dv * xhat;
    });
  });
  na::plane_sums<2>(sums, red, 0, channels, cluster, p.cl);
  if (cluster > 1) na::cluster_arrive();  // this rank's remote reads are done
  if (p.lead) {
    t1_out[p.b * C + p.c] = sums[0];
    t2_out[p.b * C + p.c] = sums[1];
  }
  const float inv_n = 1.f / (float)(H * W);
  const float k = g * rstd;
  const float m1 = sums[0] * inv_n;
  const float m2 = sums[1] * inv_n;

  na::walk<NV, RES, V>(p, [&](int s, size_t off) {
    Pack<T, V> o;
    each(s, off, [&](int e, float xhat, float dv) {
      o.v[e] = from_f32<T>(k * (dv - m1 - xhat * m2));
    });
    na::store<T, V>(dx + off, o);
  });
  // keep this CTA's partials alive until every rank has read them
  if (cluster > 1) na::cluster_wait();
}

template <typename T, int V, bool RES>
int run(const na::Geometry& g, const void* x, const void* gz,
        const void* gamma, const void* beta, const void* mu,
        const void* rstd, void* dx, void* t1, void* t2, int B, int H, int C,
        int W, int act, float alpha, void* stream) {
  return na::with_act(act, [&](auto a) {
    return na::launch(g, B, C, stream,
                      norm_act_bwd_kernel<T, V, RES, decltype(a)::value>,
                      (const T*)x, (const T*)gz, (const T*)gamma,
                      (const T*)beta, (const float*)mu, (const float*)rstd,
                      (T*)dx, (float*)t1, (float*)t2, H, C, W, g.channels,
                      g.cluster, g.rows, alpha);
  });
}

template <typename T>
int entry(const void* x, const void* gz, const void* gamma, const void* beta,
          const void* mu, const void* rstd, void* dx, void* t1, void* t2,
          int B, int H, int C, int W, int act, float alpha, int vec,
          int channels, int cluster, int rows, int slots, int resident,
          void* stream) {
  const na::Geometry g = na::geometry(
      B, H, C, W, (int)sizeof(T), 2,
      na::aligned16(x) && na::aligned16(gz) && na::aligned16(dx));
  if (!na::same(g, vec, channels, cluster, rows, slots, resident))
    return (int)cudaErrorInvalidValue;  // the wrapper's rule has drifted
  constexpr int V16 = 16 / sizeof(T);
  if (g.resident)
    return run<T, V16, true>(g, x, gz, gamma, beta, mu, rstd, dx, t1, t2, B,
                             H, C, W, act, alpha, stream);
  if (g.vec == V16)
    return run<T, V16, false>(g, x, gz, gamma, beta, mu, rstd, dx, t1, t2, B,
                              H, C, W, act, alpha, stream);
  return run<T, 1, false>(g, x, gz, gamma, beta, mu, rstd, dx, t1, t2, B, H,
                          C, W, act, alpha, stream);
}

}  // namespace

extern "C" int norm_act_bwd_f32(const void* x, const void* gz,
                                const void* gamma, const void* beta,
                                const void* mu, const void* rstd, void* dx,
                                void* t1, void* t2, int B, int H, int C, int W,
                                int act, float alpha, int vec, int channels,
                                int cluster, int rows, int slots, int resident,
                                void* stream) {
  return entry<float>(x, gz, gamma, beta, mu, rstd, dx, t1, t2, B, H, C, W,
                      act, alpha, vec, channels, cluster, rows, slots,
                      resident, stream);
}

extern "C" int norm_act_bwd_bf16(const void* x, const void* gz,
                                 const void* gamma, const void* beta,
                                 const void* mu, const void* rstd, void* dx,
                                 void* t1, void* t2, int B, int H, int C,
                                 int W, int act, float alpha, int vec,
                                 int channels, int cluster, int rows,
                                 int slots, int resident, void* stream) {
  return entry<__nv_bfloat16>(x, gz, gamma, beta, mu, rstd, dx, t1, t2, B, H,
                              C, W, act, alpha, vec, channels, cluster, rows,
                              slots, resident, stream);
}
