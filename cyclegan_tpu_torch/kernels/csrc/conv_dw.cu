// K5 conv_dw: the weight gradient of a stride-1 KxK convolution on NHCW
// activations, any K (K = 1 included), and K9-dW conv_reflect_dw: the same
// gradient of K9's reflect-padded convolution.
//
// K5 replaces cyclegan_tpu/ops/pallas_conv.py `_conv_dw_call` (KxK dW) and
// `_conv1x1_dw_call` (the 1x1 head's dW). K9-dW replaces the dW of
// `conv2d_reflect_nhcw`'s VJP (`_conv_dw_call` on the reflect-padded input).
//
// x  [B, H, C, W]      the conv's input
// g  [B, H, Cout, W]   the gradient of its output
// dw [K, K, C, Cout]   f32 HWIO:
//   dw[dy, dx, c, co] = sum over b, h, w of
//                       x[b, h + dy - pad, c, w + dx - pad] * g[b, h, co, w]
// with zeros outside the image; pad is the forward's pad before ((K-1)/2).
//
// Bound on the H100: operations (as many multiply-adds as the forward, 16
// to 100 per byte). As a matrix product, dw[m, co] = sum_p patch[p, m]
// g[p, co] with m = (dy, dx, c) over the p = B*H*W pixels (up to 524,288
// terms) into a small output (at most 4*4*192*128 values in the
// generator). Both designs below split the pixel sum over slices of the
// (b, h) rows into an f32 workspace [splits, K*K*C, Cout] (only real
// (tap, c) rows and co columns are written), and a second kernel adds the
// splits in a fixed order: the result does not depend on scheduling and is
// equal bit for bit across runs, with no atomics.
//
// bf16, the main path: TMA and wgmma (`conv_dw_tma_kernel`). For fixed
// (b, h) the NHCW rows x[b, h + dy - pad, :, :] and g[b, h, :, :] are
// [C, W] and [Cout, W] with W contiguous, so each tap is a product with M =
// channels, N = Cout and the reduction over pixels, both operands K-major
// as wgmma reads them, no transpose. Against the four limits of the
// CUDA-core design (f32 FMAs; a scalar im2col gather with index arithmetic
// and bounds tests on every element, stored as f32; 8 shared loads per 16
// FMAs; no overlap of copy and compute):
// - products on the tensor cores: wgmma m64nNk16, bf16 in, f32
//   accumulators in registers, N = Cout rounded up to 8, 16, 32, 64 or 128
//   (tiles of 128 beyond); bf16 products are exact in f32;
// - no per-element index math: TMA copies each operand tile, boxes of
//   [1, 1, rows, 64 px] out of tensor maps over x and g [B, H, Cout, W] in
//   bf16 (64 bf16 = one 128-byte swizzled row, wgmma's canonical K-major
//   tile). TMA fills everything outside the tensor with zeros: SAME's zero
//   rows above and below the image, the zero channel rows past a small C
//   and the zero g rows past a small Cout. The row shift dy is the box's
//   start coordinate h + dy - pad. The column shift dx cannot be: a box's
//   innermost start must be a multiple of 16 bytes (8 bf16), and on the
//   H100 a box started at an odd column faults. So a first kernel writes
//   K shifted copies xs[dx, b, h, c, w] = x[b, h, c, w + dx - pad] (zeros
//   past the edges; `dw_shift_copies_kernel`, one 16-byte store per
//   thread), and the box of tap (dy, dx) starts at (dx, b, h + dy - pad,
//   c0, w0) of a 5-D map over them: K times x's bytes written and read
//   again, against K*K*C*Cout*B*H*W multiply-adds (one pass of its own,
//   where the library pad and a generic strided torch copy made two);
// - an M tile is 64 (tap, channel) rows: Cb rows per tap, Cb the smallest
//   of 8, 16, 32, 64 at least C (64 beyond, in channel tiles), so 64 / Cb
//   taps share a tile when C <= 32; a block's two consumer warpgroups take
//   two M tiles against one g tile;
// - a ring of STAGES shared-memory stages guarded by mbarriers: one
//   producer thread keeps TMA loads in flight while the consumer
//   warpgroups multiply, releasing a stage when its wgmma group is done.
// K9-dW runs the same body at pad 0 on the shifted copies of the
// reflect-padded x (the VALID dW, as JAX's VJP runs `_conv_dw_call` on
// `jnp.pad(..., "reflect")`): xs[dx, b, h', c, w] = xr[b, h', c, w + dx],
// h' < H + 2p, xr the reflect pad of x, made in the same copy kernel
// through the reflected index map.
//
// f32, and bf16 outside the TMA domain (a base not 16-byte aligned, or W
// not a multiple of 8 so that a row's stride is not a multiple of 16
// bytes): the CUDA-core design (`conv_dw_partial_kernel`, the
// `conv_dw_simt` counter; the Python wrapper picks by that rule). A block
// owns a 64 x 32 output tile; per 32-pixel stretch of a row it stages the
// im2col values (K9-dW through the reflected index map, no padded copy)
// and the g values in shared memory, and each thread accumulates a 4x4
// micro-tile in f32. It keeps the f32 gradient check off TF32.
#include "hopper.cuh"

namespace {

constexpr int MT = 64;       // output rows (dy, dx, c) per block
constexpr int NT = 32;       // output channels per block
constexpr int PT = 32;       // pixels staged per round: one stretch of a row
constexpr int THREADS = 128; // 16 row groups x 8 channel groups, 4x4 each

// REFLECT padding's source index (see conv_same.cu); out of [0, n) past
// the reflected range, which only rows and columns never summed reach.
__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

struct DwSmem {
  float as[PT][MT + 1];  // +1: conflict-free transposed stores
  float bs[PT][NT + 1];
  int s_dy[MT], s_dx[MT], s_c[MT];
};

template <typename T, bool REFLECT>
__device__ __forceinline__ void dw_partial(
    DwSmem& sm, const T* __restrict__ x, const T* __restrict__ g,
    float* __restrict__ part, int B, int H, int C, int W, int Cout, int K,
    int pad, int splits) {
  auto& as = sm.as;
  auto& bs = sm.bs;
  int* s_dy = sm.s_dy;
  int* s_dx = sm.s_dx;
  int* s_c = sm.s_c;

  const int M = K * K * C;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * NT;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int mg = tid % 16;  // rows mg + 16 i
  const int ng = tid / 16;  // channels ng + 8 j

  for (int i = tid; i < MT; i += THREADS) {
    const int m = m0 + i;
    if (m < M) {
      const int tap = m / C;
      s_dy[i] = tap / K;
      s_dx[i] = tap % K;
      s_c[i] = m % C;
    } else {
      s_dy[i] = -1;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int R = B * H;
  const int rows_per = (R + splits - 1) / splits;
  const int r_begin = split * rows_per;
  const int r_end = min(R, r_begin + rows_per);
  const int p = tid % PT;       // this thread's pixel when staging
  const int lane_row = tid / PT;  // 0..3

  for (int r = r_begin; r < r_end; ++r) {
    const int b = r / H;
    const int h = r % H;
    for (int w0 = 0; w0 < W; w0 += PT) {
      __syncthreads();  // s_* written, or the previous round's reads done
      const int w = w0 + p;
      for (int ml = lane_row; ml < MT; ml += THREADS / PT) {
        float v = 0.f;
        const int dy = s_dy[ml];
        if (dy >= 0 && w < W) {
          int hh = h + dy - pad;
          int ww = w + s_dx[ml] - pad;
          if (REFLECT) {
            hh = reflect_index(hh, H);
            ww = reflect_index(ww, W);
          }
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = to_f32(x[(((size_t)b * H + hh) * C + s_c[ml]) * W + ww]);
        }
        as[p][ml] = v;
      }
      for (int nl = lane_row; nl < NT; nl += THREADS / PT) {
        const int n = n0 + nl;
        float v = 0.f;
        if (n < Cout && w < W)
          v = to_f32(g[(((size_t)b * H + h) * Cout + n) * W + w]);
        bs[p][nl] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < PT; ++q) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[q][mg + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = bs[q][ng + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
      }
    }
  }

  float* out = part + (size_t)split * M * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + mg + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ng + 8 * j;
      if (n < Cout) out[(size_t)m * Cout + n] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       float* __restrict__ part, int B, int H, int C, int W,
                       int Cout, int K, int pad, int splits) {
  __shared__ DwSmem sm;
  dw_partial<T, false>(sm, x, g, part, B, H, C, W, Cout, K, pad, splits);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_reflect_dw_partial_kernel(const T* __restrict__ x,
                               const T* __restrict__ g,
                               float* __restrict__ part, int B, int H, int C,
                               int W, int Cout, int K, int pad, int splits) {
  __shared__ DwSmem sm;
  dw_partial<T, true>(sm, x, g, part, B, H, C, W, Cout, K, pad, splits);
}

// dw[i] = part[0][i] + part[1][i] + ... in that order.
__device__ __forceinline__ void sum_splits(const float* __restrict__ part,
                                           float* __restrict__ dw, size_t n,
                                           int splits) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (size_t)gridDim.x * 256) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
    dw[i] = s;
  }
}

__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ dw,
                  size_t n, int splits) {
  sum_splits(part, dw, n, splits);
}

// the same sum for K9-dW, under its own name in a profiler trace
__global__ void __launch_bounds__(256)
reflect_sum_splits_kernel(const float* __restrict__ part,
                          float* __restrict__ dw, size_t n, int splits) {
  sum_splits(part, dw, n, splits);
}

// the fixed-order sum of the splits, under each launch name's own symbol
int sum_parts(bool reflect, const void* part, void* dw, size_t n, int splits,
              cudaStream_t stream) {
  auto sum = reflect ? reflect_sum_splits_kernel : sum_splits_kernel;
  sum<<<grid_for(n, 256), 256, 0, stream>>>((const float*)part, (float*)dw,
                                            n, splits);
  return (int)cudaGetLastError();
}

template <typename T, bool REFLECT>
int launch_simt(const void* x, const void* g, void* part, void* dw, int B,
                int H, int C, int W, int Cout, int K, int pad, int splits,
                void* stream) {
  if (splits < 1 || pad < 0 || pad > K - 1) return (int)cudaErrorInvalidValue;
  if (REFLECT && (K % 2 != 1 || pad != K / 2 || pad >= H || pad >= W))
    return (int)cudaErrorInvalidValue;
  const int M = K * K * C;
  dim3 grid((M + MT - 1) / MT, (Cout + NT - 1) / NT, splits);
  auto partial = REFLECT ? conv_reflect_dw_partial_kernel<T>
                         : conv_dw_partial_kernel<T>;
  partial<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (float*)part, B, H, C, W, Cout, K, pad,
      splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_parts(REFLECT, part, dw, (size_t)M * Cout, splits,
                   (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// The TMA + wgmma design (bf16)

// The K column-shifted copies the TMA design reads (see the note at the
// top): xs[dx, b, h, c, w] = x[b, h, c, w + dx - pad], zeros past the W
// edges, [K, B, H, C, W]; with REFLECT through the reflected index map in
// both axes, [K, B, H + 2 pad, C, W]. One thread per 8 outputs (one 16-byte
// store); its loads are 2-byte, neighbouring threads on neighbouring
// addresses. Bound by bytes: x read once, xs written once.
template <bool REFLECT>
__device__ __forceinline__ void shift_copies(const uint16_t* __restrict__ x,
                                             uint16_t* __restrict__ xs,
                                             int B, int H, int C, int W,
                                             int K, int pad) {
  const int Hx = REFLECT ? H + 2 * pad : H;
  const int W8 = W / 8;
  const size_t n = (size_t)K * B * Hx * C * W8;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    size_t t = i;
    const int w0 = (int)(t % W8) * 8;
    t /= W8;
    const int c = (int)(t % C);
    t /= C;
    const int h = (int)(t % Hx);
    t /= Hx;
    const int b = (int)(t % B);
    const int dx = (int)(t / B);
    const int hs = REFLECT ? reflect_index(h - pad, H) : h;
    const uint16_t* row = x + (((size_t)b * H + hs) * C + c) * W;
    uint4 out;
    uint16_t* v = reinterpret_cast<uint16_t*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int w = w0 + j + dx - pad;
      if (REFLECT) w = reflect_index(w, W);
      v[j] = (w >= 0 && w < W) ? row[w] : (uint16_t)0;  // bf16 +0
    }
    reinterpret_cast<uint4*>(xs)[i] = out;
  }
}

__global__ void __launch_bounds__(256)
dw_shift_copies_kernel(const uint16_t* x, uint16_t* xs, int B, int H, int C,
                       int W, int K, int pad) {
  shift_copies<false>(x, xs, B, H, C, W, K, pad);
}

// K9-dW's, under its own name in a profiler trace
__global__ void __launch_bounds__(256)
reflect_dw_shift_copies_kernel(const uint16_t* x, uint16_t* xs, int B, int H,
                               int C, int W, int K, int pad) {
  shift_copies<true>(x, xs, B, H, C, W, K, pad);
}

constexpr int TMA_PX = 64;          // pixels per stage: one swizzled row
constexpr int TILE_ROWS = 64;       // (tap, c) rows of one M tile (wgmma M)
constexpr int CONSUMERS = 2;        // consumer warpgroups, an M tile each
constexpr int TMA_THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int STAGES = 3;  // few stages, small blocks: more blocks per SM
constexpr int A_BYTES = TILE_ROWS * TMA_PX * 2;    // 8 KiB

// How the K*K*C (tap, c) rows are cut into 64-row M tiles: cb channel rows
// per tap (8, 16, 32 or 64), taps = 64 / cb taps per tile, c_tiles channel
// tiles per tap group (more than one only when C > 64), m_tiles in all.
// Tile mt holds taps (mt / c_tiles) * taps + j, j < taps, channels
// (mt % c_tiles) * cb + [0, cb). ops/cuda_conv.py `dw_tma_geometry` is the
// same rule.
struct TmaGeometry {
  int cb, taps, c_tiles, m_tiles;
};

TmaGeometry tma_geometry(int C, int KK) {
  TmaGeometry t;
  t.cb = C <= 8 ? 8 : C <= 16 ? 16 : C <= 32 ? 32 : 64;
  t.taps = TILE_ROWS / t.cb;
  t.c_tiles = (C + t.cb - 1) / t.cb;
  t.m_tiles = t.c_tiles * ((KK + t.taps - 1) / t.taps);
  return t;
}

template <int N>
__host__ __device__ constexpr int tma_stage_bytes() {
  return CONSUMERS * A_BYTES + N * TMA_PX * 2;
}

// + 1 KiB to align the ring to 1024 bytes
template <int N>
__host__ __device__ constexpr int tma_smem_bytes() {
  return 1024 + STAGES * tma_stage_bytes<N>() + 2 * STAGES * 8;
}

// Block (pair of M tiles, N tile, split): sums its slice of (b, h) rows,
// 64 pixels a stage, into f32 registers, then writes its partial sums.
// xmap tiles the shifted copies [K, B, Hx, C, W] in boxes [1, 1, 1, cb, 64]
// (Hx = H, and H + K - 1 for K9-dW, whose pad is then 0); gmap tiles g
// [1, B, H, Cout, W] in boxes [1, 1, 1, N, 64].
template <int N>
__device__ __forceinline__ void dw_tma(const CUtensorMap* xmap,
                                       const CUtensorMap* gmap,
                                       float* __restrict__ part, int B, int H,
                                       int W, int C, int Cout, int K, int pad,
                                       int splits, TmaGeometry geo) {
  constexpr int STAGE = tma_stage_bytes<N>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int KK = K * K;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * N;
  const int split = blockIdx.z;
  const int R = B * H;
  const int rows_per = (R + splits - 1) / splits;
  const int r_begin = split * rows_per;
  const int r_end = min(R, r_begin + rows_per);
  const int chunks = (W + TMA_PX - 1) / TMA_PX;
  const int iters = max(0, r_end - r_begin) * chunks;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // the producer: one thread issues every TMA load
    if (tid != CONSUMERS * 128) return;
    uint32_t tx = N * TMA_PX * 2;
    for (int q = 0; q < CONSUMERS; ++q) {
      const int mt = blockIdx.x * CONSUMERS + q;
      if (mt < geo.m_tiles)
        tx += min(geo.taps, KK - (mt / geo.c_tiles) * geo.taps) * geo.cb *
              TMA_PX * 2;
    }
    for (int i = 0; i < iters; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      const int r = r_begin + i / chunks;
      const int b = r / H, h = r % H;
      const int w0 = (i % chunks) * TMA_PX;
      uint8_t* stage = smem + s * STAGE;
      mbar_expect_tx(&full[s], tx);
      for (int q = 0; q < CONSUMERS; ++q) {
        const int mt = blockIdx.x * CONSUMERS + q;
        if (mt >= geo.m_tiles) continue;
        const int tap0 = (mt / geo.c_tiles) * geo.taps;
        const int c0 = (mt % geo.c_tiles) * geo.cb;
        for (int j = 0; j < geo.taps && tap0 + j < KK; ++j) {
          const int dy = (tap0 + j) / K, dx = (tap0 + j) % K;
          tma_load_5d(stage + q * A_BYTES + j * geo.cb * TMA_PX * 2, xmap,
                      &full[s], w0, c0, h + dy - pad, b, dx);
        }
      }
      tma_load_5d(stage + CONSUMERS * A_BYTES, gmap, &full[s], w0, n0, h, b,
                  0);
    }
    return;
  }

  // a consumer warpgroup: M tile mt against the stage's g tile. Past the
  // last M tile it multiplies whatever its A region holds and stores
  // nothing: a branch around the wgmmas would make the compiler serialize
  // them.
  const int q = tid / 128;
  const int mt = blockIdx.x * CONSUMERS + q;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < iters; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* a = smem + s * STAGE + q * A_BYTES;
    const uint8_t* bt = smem + s * STAGE + CONSUMERS * A_BYTES;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) fence_operand(acc[k]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < TMA_PX / 16; ++k)
      wgmma_bf16<N>(acc, sw128_desc(a + 32 * k), sw128_desc(bt + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
    for (int k = 0; k < N / 2; ++k) fence_operand(acc[k]);
    if (i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int k = 0; k < N / 2; ++k) fence_operand(acc[k]);
  if (mt >= geo.m_tiles) return;

  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int tap0 = (mt / geo.c_tiles) * geo.taps;
  const int c0 = (mt % geo.c_tiles) * geo.cb;
  float* out = part + (size_t)split * KK * C * Cout;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int co = n0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
    const int tap = tap0 + row / geo.cb;
    const int c = c0 + row % geo.cb;
    if (tap < KK && c < C && co < Cout)
      out[((size_t)tap * C + c) * Cout + co] = acc[i];
  }
}

template <int N>
__global__ void __launch_bounds__(TMA_THREADS, 1)
conv_dw_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap, float* part,
                   int B, int H, int W, int C, int Cout, int K, int pad,
                   int splits, TmaGeometry geo) {
  dw_tma<N>(&xmap, &gmap, part, B, H, W, C, Cout, K, pad, splits, geo);
}

// the same body for K9-dW (pad 0 on the padded copy), under its own name in
// a profiler trace
template <int N>
__global__ void __launch_bounds__(TMA_THREADS, 1)
conv_reflect_dw_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap gmap,
                           float* part, int B, int H, int W, int C, int Cout,
                           int K, int pad, int splits, TmaGeometry geo) {
  dw_tma<N>(&xmap, &gmap, part, B, H, W, C, Cout, K, pad, splits, geo);
}

// A contiguous bf16 [P, B, H, C, W] tensor tiled in boxes [1, 1, 1, rows,
// 64] with the 128-byte swizzle.
bool encode_map(CUtensorMap* map, const void* base, int P, int B, int H,
                int C, int W, int rows) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)W * 2;
  cuuint64_t dims[5] = {(cuuint64_t)W, (cuuint64_t)C, (cuuint64_t)H,
                        (cuuint64_t)B, (cuuint64_t)P};
  cuuint64_t strides[4] = {row, row * C, row * C * H, row * C * H * B};
  cuuint32_t box[5] = {TMA_PX, (cuuint32_t)rows, 1, 1, 1};
  cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch_tma_n(bool reflect, const CUtensorMap& xmap,
                 const CUtensorMap& gmap, float* part, int B, int H, int W,
                 int C, int Cout, int K, int pad, int splits,
                 TmaGeometry geo, cudaStream_t stream) {
  auto kernel =
      reflect ? conv_reflect_dw_tma_kernel<N> : conv_dw_tma_kernel<N>;
  constexpr int smem = tma_smem_bytes<N>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((geo.m_tiles + CONSUMERS - 1) / CONSUMERS, (Cout + N - 1) / N,
            splits);
  kernel<<<grid, TMA_THREADS, smem, stream>>>(xmap, gmap, part, B, H, W, C,
                                              Cout, K, pad, splits, geo);
  return (int)cudaGetLastError();
}

// x [B, H, C, W]; xs room for its K shifted copies [K, B, Hx, C, W]
// (Hx = H, or H + 2 pad for K9-dW with pad = K / 2; ops/cuda_conv.py
// `shifted_copies` is their plain version), which this writes first;
// g [B, H, Cout, W].
int launch_tma(bool reflect, const void* x, void* xs, const void* g,
               void* part, void* dw, int B, int H, int C, int W, int Cout,
               int K, int pad, int splits, void* stream) {
  if (splits < 1 || pad < 0 || pad > K - 1) return (int)cudaErrorInvalidValue;
  if (reflect && (K % 2 != 1 || pad != K / 2 || pad >= H || pad >= W))
    return (int)cudaErrorInvalidValue;
  if (W % 8 != 0 || ((uintptr_t)x | (uintptr_t)xs | (uintptr_t)g) % 16 != 0)
    return (int)cudaErrorInvalidValue;  // outside the TMA domain
  cudaStream_t s = (cudaStream_t)stream;
  const size_t copies = (size_t)K * B * (reflect ? H + 2 * pad : H) * C * W;
  auto shift = reflect ? reflect_dw_shift_copies_kernel
                       : dw_shift_copies_kernel;
  shift<<<grid_for(copies / 8, 256), 256, 0, s>>>(
      (const uint16_t*)x, (uint16_t*)xs, B, H, C, W, K, pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const TmaGeometry geo = tma_geometry(C, K * K);
  const int n = Cout <= 8 ? 8 : Cout <= 16 ? 16 : Cout <= 32 ? 32
              : Cout <= 64 ? 64 : 128;
  CUtensorMap xmap, gmap;
  if (tensor_map_encoder() == nullptr)
    return (int)cudaErrorSharedObjectSymbolNotFound;
  if (!encode_map(&xmap, xs, K, B, reflect ? H + 2 * pad : H, C, W,
                  geo.cb) ||
      !encode_map(&gmap, g, 1, B, H, Cout, W, n))
    return (int)cudaErrorInvalidValue;
  const int kpad = reflect ? 0 : pad;
  float* p = (float*)part;
  int err;
  if (n == 8)
    err = launch_tma_n<8>(reflect, xmap, gmap, p, B, H, W, C, Cout, K, kpad,
                          splits, geo, s);
  else if (n == 16)
    err = launch_tma_n<16>(reflect, xmap, gmap, p, B, H, W, C, Cout, K, kpad,
                           splits, geo, s);
  else if (n == 32)
    err = launch_tma_n<32>(reflect, xmap, gmap, p, B, H, W, C, Cout, K, kpad,
                           splits, geo, s);
  else if (n == 64)
    err = launch_tma_n<64>(reflect, xmap, gmap, p, B, H, W, C, Cout, K, kpad,
                           splits, geo, s);
  else
    err = launch_tma_n<128>(reflect, xmap, gmap, p, B, H, W, C, Cout, K,
                            kpad, splits, geo, s);
  if (err != 0) return err;
  return sum_parts(reflect, part, dw, (size_t)K * K * C * Cout, splits, s);
}

}  // namespace

// K5: bf16 on TMA + wgmma over the shifted copies of x it writes into xs
// (see launch_tma); f32 and the bf16 shapes outside the TMA domain on the
// CUDA cores (conv_dw_simt_bf16). The wrapper picks.
extern "C" int conv_dw_bf16(const void* x, void* xs, const void* g,
                            void* part, void* dw, int B, int H, int C, int W,
                            int Cout, int K, int pad, int splits,
                            void* stream) {
  return launch_tma(false, x, xs, g, part, dw, B, H, C, W, Cout, K, pad,
                    splits, stream);
}

extern "C" int conv_dw_f32(const void* x, const void* g, void* part, void* dw,
                           int B, int H, int C, int W, int Cout, int K,
                           int pad, int splits, void* stream) {
  return launch_simt<float, false>(x, g, part, dw, B, H, C, W, Cout, K, pad,
                                   splits, stream);
}

extern "C" int conv_dw_simt_bf16(const void* x, const void* g, void* part,
                                 void* dw, int B, int H, int C, int W,
                                 int Cout, int K, int pad, int splits,
                                 void* stream) {
  return launch_simt<__nv_bfloat16, false>(x, g, part, dw, B, H, C, W, Cout,
                                           K, pad, splits, stream);
}

// K9-dW: bf16 on TMA + wgmma over the shifted copies of the reflect-padded
// input it writes into xs (see launch_tma); f32 and bf16 outside the
// domain on the CUDA cores through the reflected index map, no copy.
extern "C" int conv_reflect_dw_bf16(const void* x, void* xs, const void* g,
                                    void* part, void* dw, int B, int H, int C,
                                    int W, int Cout, int K, int splits,
                                    void* stream) {
  return launch_tma(true, x, xs, g, part, dw, B, H, C, W, Cout, K, K / 2,
                    splits, stream);
}

extern "C" int conv_reflect_dw_f32(const void* x, const void* g, void* part,
                                   void* dw, int B, int H, int C, int W,
                                   int Cout, int K, int splits,
                                   void* stream) {
  return launch_simt<float, true>(x, g, part, dw, B, H, C, W, Cout, K, K / 2,
                                  splits, stream);
}

extern "C" int conv_reflect_dw_simt_bf16(const void* x, const void* g,
                                         void* part, void* dw, int B, int H,
                                         int C, int W, int Cout, int K,
                                         int splits, void* stream) {
  return launch_simt<__nv_bfloat16, true>(x, g, part, dw, B, H, C, W, Cout,
                                          K, K / 2, splits, stream);
}
