// K3 sum2x2: scaled 2x2 block sum on NHCW activations.
//
// Replaces cyclegan_tpu/ops/pallas_resize.py `_sum2x2_call`: the 2x2 average
// pool is scale 1/4 (and the upsample's backward, later, is scale 1).
//
// x [B, H, C, W] -> out [B, H/2, C, W/2],
// out = scale * ((x[2h, 2w] + x[2h+1, 2w]) + (x[2h, 2w+1] + x[2h+1, 2w+1])),
// in f32, in that order: the Pallas kernel adds the row pair first and the
// lane pair second.
//
// Bound on the H100: bytes (3 flops per 5 elements moved). One thread per
// output element in a grid-stride loop; neighbouring threads read neighbouring
// column pairs of the two input rows and write neighbouring outputs, so every
// access is coalesced.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
sum2x2_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int H,
              int C, int W, float scale) {
  const int Ho = H / 2;
  const int Wo = W / 2;
  const size_t total = (size_t)B * Ho * C * Wo;
  const size_t row = (size_t)C * W;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const int wo = (int)(i % Wo);
    size_t t = i / Wo;
    const int c = (int)(t % C);
    t /= C;
    const int ho = (int)(t % Ho);
    const size_t b = t / Ho;
    const size_t base = ((b * H + 2 * ho) * C + c) * W + 2 * wo;
    const float left = to_f32(x[base]) + to_f32(x[base + row]);
    const float right = to_f32(x[base + 1]) + to_f32(x[base + row + 1]);
    out[i] = from_f32<T>((left + right) * scale);
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int H, int C, int W, float scale,
           void* stream) {
  const size_t total = (size_t)B * (H / 2) * C * (W / 2);
  sum2x2_kernel<T><<<grid_for(total, THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>((const T*)x, (T*)out, B, H, C, W,
                                             scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sum2x2_f32(const void* x, void* out, int B, int H, int C, int W,
                          float scale, void* stream) {
  return launch<float>(x, out, B, H, C, W, scale, stream);
}

extern "C" int sum2x2_bf16(const void* x, void* out, int B, int H, int C,
                           int W, float scale, void* stream) {
  return launch<__nv_bfloat16>(x, out, B, H, C, W, scale, stream);
}
