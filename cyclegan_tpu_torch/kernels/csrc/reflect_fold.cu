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
//   dx = (rows(w + p) + rows(left)) + rows(right), rows(s) = (int + top) + bot
// and rounds once; the plain version adds in the same order, so K10 is exact
// against it.
//
// Bound on the H100: bytes (at most 8 adds per element written). One thread
// per output element in a grid-stride loop; neighbouring threads read
// neighbouring columns of each source row, so the interior reads and the
// writes are coalesced and the few halo reads are short strided runs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
reflect_fold_kernel(const T* __restrict__ dxp, T* __restrict__ dx, int B,
                    int H, int C, int W, int p) {
  const int Hp = H + 2 * p;
  const int Wp = W + 2 * p;
  const size_t total = (size_t)B * H * C * W;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const int w = (int)(i % W);
    size_t t = i / W;
    const int c = (int)(t % C);
    t /= C;
    const int h = (int)(t % H);
    const size_t b = t / H;

    int rows[3], cols[3];
    int nr = 0, nc = 0;
    rows[nr++] = h + p;
    if (h >= 1 && h <= p) rows[nr++] = p - h;
    if (h >= H - 1 - p && h <= H - 2) rows[nr++] = 2 * H + p - 2 - h;
    cols[nc++] = w + p;
    if (w >= 1 && w <= p) cols[nc++] = p - w;
    if (w >= W - 1 - p && w <= W - 2) cols[nc++] = 2 * W + p - 2 - w;

    float v = 0.f;
    for (int k = 0; k < nc; ++k) {
      float s = to_f32(dxp[((b * Hp + rows[0]) * C + c) * Wp + cols[k]]);
      for (int j = 1; j < nr; ++j)
        s += to_f32(dxp[((b * Hp + rows[j]) * C + c) * Wp + cols[k]]);
      v = k == 0 ? s : v + s;
    }
    dx[i] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* dxp, void* dx, int B, int H, int C, int W, int p,
           void* stream) {
  if (p < 0 || p >= H || p >= W) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * H * C * W;
  reflect_fold_kernel<T><<<grid_for(total, THREADS), THREADS, 0,
                           (cudaStream_t)stream>>>((const T*)dxp, (T*)dx, B,
                                                   H, C, W, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int reflect_fold_f32(const void* dxp, void* dx, int B, int H,
                                int C, int W, int p, void* stream) {
  return launch<float>(dxp, dx, B, H, C, W, p, stream);
}

extern "C" int reflect_fold_bf16(const void* dxp, void* dx, int B, int H,
                                 int C, int W, int p, void* stream) {
  return launch<__nv_bfloat16>(dxp, dx, B, H, C, W, p, stream);
}
