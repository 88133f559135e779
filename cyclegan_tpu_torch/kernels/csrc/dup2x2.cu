// K7 dup2x2: scaled nearest 2x duplication on NHCW activations.
//
// Replaces cyclegan_tpu/ops/pallas_resize.py `_dup2x2_call`: the backward of
// the 2x2 average pool is scale 1/4 (and a standalone nearest upsample would
// be scale 1).
//
// x [B, h, C, w] -> out [B, 2h, C, 2w],
// out[b, 2i + r, c, 2j + s] = x[b, i, c, j] * scale, for r, s in {0, 1},
// product in f32 and one rounding to the storage type; a scale of 1/4 is
// exact in both types.
//
// Bound on the H100: bytes (one multiply per four elements written). One
// thread per output element in a grid-stride loop: writes are coalesced and
// each input element is read by the two neighbouring threads of two rows
// (the repeats hit L1/L2).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dup2x2_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int h,
              int C, int w, float scale) {
  const int H = 2 * h;
  const int W = 2 * w;
  const size_t total = (size_t)B * H * C * W;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const int wo = (int)(i % W);
    size_t t = i / W;
    const int c = (int)(t % C);
    t /= C;
    const int ho = (int)(t % H);
    const size_t b = t / H;
    out[i] = from_f32<T>(to_f32(x[((b * h + ho / 2) * C + c) * w + wo / 2])
                         * scale);
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int h, int C, int w, float scale,
           void* stream) {
  const size_t total = (size_t)B * 2 * h * C * 2 * w;
  dup2x2_kernel<T><<<grid_for(total, THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>((const T*)x, (T*)out, B, h, C, w,
                                             scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dup2x2_f32(const void* x, void* out, int B, int h, int C,
                          int w, float scale, void* stream) {
  return launch<float>(x, out, B, h, C, w, scale, stream);
}

extern "C" int dup2x2_bf16(const void* x, void* out, int B, int h, int C,
                           int w, float scale, void* stream) {
  return launch<__nv_bfloat16>(x, out, B, h, C, w, scale, stream);
}
