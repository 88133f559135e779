// K4 concat_up2: the pooled U-Net's up-path junction on NHCW activations.
//
// Replaces cyclegan_tpu/ops/pallas_concat.py `_concat_up2_call`:
// concat over channels of (skip, nearest-2x-upsample(x)), skip first.
//
// skip [B, H, C1, W], x [B, H/2, C2, W/2] -> out [B, H, C1 + C2, W]
// out[:, :, :C1] = skip; out[:, h, C1 + c, w] = x[:, h/2, c, w/2].
//
// Bound on the H100: bytes; it does no arithmetic. Fusing the upsample into
// the concat saves writing and re-reading the upsampled tensor, as on the TPU.
// One thread per output element in a grid-stride loop: writes are coalesced,
// skip reads are coalesced, and each x element is read by two neighbouring
// threads of two rows (the second read hits L1/L2). Values are copied as
// they are, with no conversion, so the result is exact.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
concat_up2_kernel(const T* __restrict__ skip, const T* __restrict__ x,
                  T* __restrict__ out, int B, int H, int C1, int C2, int W) {
  const int C = C1 + C2;
  const int h_half = H / 2;
  const int w_half = W / 2;
  const size_t total = (size_t)B * H * C * W;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const int w = (int)(i % W);
    size_t t = i / W;
    const int c = (int)(t % C);
    t /= C;
    const int h = (int)(t % H);
    const size_t b = t / H;
    if (c < C1) {
      out[i] = skip[((b * H + h) * C1 + c) * W + w];
    } else {
      out[i] = x[((b * h_half + h / 2) * C2 + (c - C1)) * w_half + w / 2];
    }
  }
}

template <typename T>
int launch(const void* skip, const void* x, void* out, int B, int H, int C1,
           int C2, int W, void* stream) {
  const size_t total = (size_t)B * H * (C1 + C2) * W;
  concat_up2_kernel<T><<<grid_for(total, THREADS), THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const T*)skip, (const T*)x, (T*)out, B, H, C1, C2, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int concat_up2_f32(const void* skip, const void* x, void* out,
                              int B, int H, int C1, int C2, int W,
                              void* stream) {
  return launch<float>(skip, x, out, B, H, C1, C2, W, stream);
}

extern "C" int concat_up2_bf16(const void* skip, const void* x, void* out,
                               int B, int H, int C1, int C2, int W,
                               void* stream) {
  return launch<__nv_bfloat16>(skip, x, out, B, H, C1, C2, W, stream);
}
