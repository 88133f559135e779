// K8 split_pool2: the adjoint of the up-path junction (K4) on NHCW
// activations.
//
// Replaces cyclegan_tpu/ops/pallas_concat.py `_split_pool2_call`. The
// junction is out = concat(skip, nearest-2x-upsample(x)) over channels, so
// for its gradient g [B, H, C1 + C2, W]:
//   dskip [B, H, C1, W]     = g[:, :, :C1, :]
//   dx    [B, H/2, C2, W/2] : dx[b, i, c, j] =
//       (g[b, 2i, C1 + c, 2j] + g[b, 2i + 1, C1 + c, 2j])
//     + (g[b, 2i, C1 + c, 2j + 1] + g[b, 2i + 1, C1 + c, 2j + 1])
// in f32, the row pair first and the column pair second as the Pallas kernel
// and K3 add, then one rounding to the storage type.
//
// Bound on the H100: bytes (g read once, both outputs written once; 3 adds
// per 4 elements of the second part). One launch, one thread per output
// element of either part in one grid-stride loop; reads and writes of
// neighbouring threads are neighbouring addresses.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
split_pool2_kernel(const T* __restrict__ g, T* __restrict__ dskip,
                   T* __restrict__ dx, int B, int H, int C1, int C2, int W) {
  const int C = C1 + C2;
  const int h = H / 2;
  const int w = W / 2;
  const size_t n_skip = (size_t)B * H * C1 * W;
  const size_t total = n_skip + (size_t)B * h * C2 * w;
  const size_t row = (size_t)C * W;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    if (i < n_skip) {
      const int wc = (int)(i % W);
      size_t t = i / W;
      const int c = (int)(t % C1);
      const size_t bh = t / C1;  // b * H + row
      dskip[i] = g[(bh * C + c) * W + wc];
    } else {
      const size_t k = i - n_skip;
      const int j = (int)(k % w);
      size_t t = k / w;
      const int c = (int)(t % C2);
      t /= C2;
      const int r = (int)(t % h);
      const size_t b = t / h;
      const size_t base = ((b * H + 2 * r) * C + C1 + c) * W + 2 * j;
      const float left = to_f32(g[base]) + to_f32(g[base + row]);
      const float right = to_f32(g[base + 1]) + to_f32(g[base + row + 1]);
      dx[k] = from_f32<T>(left + right);
    }
  }
}

template <typename T>
int launch(const void* g, void* dskip, void* dx, int B, int H, int C1, int C2,
           int W, void* stream) {
  const size_t total =
      (size_t)B * H * C1 * W + (size_t)B * (H / 2) * C2 * (W / 2);
  split_pool2_kernel<T><<<grid_for(total, THREADS), THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const T*)g, (T*)dskip, (T*)dx, B, H, C1, C2, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int split_pool2_f32(const void* g, void* dskip, void* dx, int B,
                               int H, int C1, int C2, int W, void* stream) {
  return launch<float>(g, dskip, dx, B, H, C1, C2, W, stream);
}

extern "C" int split_pool2_bf16(const void* g, void* dskip, void* dx, int B,
                                int H, int C1, int C2, int W, void* stream) {
  return launch<__nv_bfloat16>(g, dskip, dx, B, H, C1, C2, W, stream);
}
