// K1 conv_same: stride-1 TF-'SAME' KxK convolution on NHCW activations, and
// K9 conv_reflect: the same convolution of the reflect-padded input.
//
// K1 replaces cyclegan_tpu/ops/pallas_conv.py `_conv_fwd_call` (the factored
// im2col KxK forward) and `_conv1x1_call` (the 1x1 head): K = 1 is the same
// function with no padding. K9 replaces the forward of `conv2d_reflect_nhcw`
// (`_conv_reflect_fwd_impl`: a reflect pad, then `_conv_fwd_call` on the
// pre-padded input).
//
// x   [B, H, C, W]     activations, W innermost (the JAX kernels' NHCW)
// w   [K, K, C, Cout]  HWIO weights, as stored in the checkpoint
// b   [Cout] or null   bias, added to the f32 sum before the one rounding
// out [B, Ho, Cout, Wo], Ho = H + 2 grow, Wo = W + 2 grow
// pad rows and columns before the image, the rest after. K1 pads with zeros:
// the forward of TF SAME pads (K-1)/2 before, (1, 2) for K = 4; the input
// gradient of that conv (this kernel on dY with flipped, ci<->co-swapped
// weights, as pallas_conv.py `_conv_bwd_rule`) pads K-1-(K-1)/2 before, 2 for
// K = 4. `grow` widens the output by that many rows and columns on each side
// (zeros before the image: pad + grow; after: K-1-pad + grow): the reflect
// conv's input gradient is the full correlation of dY over the padded side
// H + 2p, which is K1 at pad p and grow p, with no zero-padded copy of dY.
// K9 takes odd K only and pads K/2 on each side by REFLECT (the edge is not
// repeated: row -1 is row 1, row H is row H-2), as the reference's
// ReflectionPadding2D; it needs K/2 < H and K/2 < W.
//
// Bound on the H100: operations, summed over a train step's launches. Most
// launches do 16-600 multiply-adds per byte of input and output, far above
// what the CUDA cores can feed (~4 bf16 FMAs per byte at 67 TFLOP/s) and
// around the bf16 tensor cores' ~150 per byte at 989 TFLOP/s; the 1x1
// head (K = 1, under 1 per byte) is bound by bytes. So the products belong
// on the tensor cores.
//
// bf16, the main path: an implicit GEMM on wgmma (`conv_same_tc_kernel`,
// `conv_reflect_tc_kernel`), after a pack kernel in the same C call
// (`conv_same_pack_kernel`, `conv_reflect_pack_kernel`) writes
//   xp [Cg][B][Hp][Wp][8]  bf16, Hp = Ho + K - 1, Wp = Wo + K - 1:
//     x padded (zeros for K1, the reflect map for K9) with 8 channels
//     innermost, Cg = C rounded up to 16, over 8; channels past C are zeros;
//   wp [nt][C16][K*K][2][N][8] bf16: the HWIO weights re-laid K-major in
//     nt tiles of N output channels, N = Cout (Cout / nt past 256) rounded
//     up to 8, 16, 32, 48, 64, 80, 96, 128, 160, 192 or 256, zeros past C
//     and Cout; C16 = Cg / 2 steps of 16 channels.
// Then out[p] = sum over taps (dy, dx) and channels of xp[p + dy Wp + dx]
// wp[tap], with p the flattened padded pixel index b Hp Wp + h Wp + w, is a
// VALID correlation whose M is the flattened pixels, N is Cout and the
// reduction runs over (16-channel step, tap) in k16 wgmmas. Against the
// four limits of the CUDA-core design below:
// - f32 FMAs on the CUDA cores: wgmma m64nNk16, bf16 in, f32 accumulators
//   in registers (N > 128 as side-by-side wgmmas, `wgmma_wide`);
// - a scalar gather with div/mod index math and four bounds tests per
//   staged element: the pack kernel pays the index map once per element
//   (2x x's bytes, the bound's own), and the main kernel's loads are 1-D
//   bulk copies (`cp.async.bulk`) of contiguous runs of xp and wp, no index
//   math. In wgmma's no-swizzle K-major layout a core matrix is 8 rows x 16
//   bytes; a window of xp of one channel group is such rows, one pixel
//   each, so the A operand of tap (dy, dx) is the same window with its
//   descriptor start moved by (dy Wp + dx) 16 bytes: always 16-byte aligned
//   (no column-shifted copies, which a TMA box would need), one window
//   per 16 channels for all K*K taps;
// - a shared-memory load per FMA: wgmma reads both operands from shared
//   memory itself, a 64 x N x 16 product per instruction;
// - no overlap of copy and compute: a ring of up to 3 stages guarded by
//   mbarriers; one producer thread issues the bulk copies while two
//   consumer warpgroups multiply. A stage is 16 channels of a run of tap
//   rows: the window of BM + (K-1) Wp + K-1 pixels and the K*K taps'
//   weights at every shape of the recipes; where two such stages do not
//   fit 227 KB (wide k7 weights, long rows), the K tap rows are cut into
//   shorter runs, each with the window its offsets span, so that the ring
//   always holds two stages (one would wait on itself). A block's M tile is
//   BM = 2 x MW x 64 flattened pixels (MW = 2, or 1 for N > 128) by one N
//   tile (blockIdx.y); outputs at
//   w >= Wo or h >= Ho are computed and never stored, (K-1)/Wp and
//   (K-1)/Hp of the work, 3% at 66x66 k3, against the CUDA-core design's
//   32-column tiles that waste a third of a 66-wide row.
// Epilogue: bias added in f32, one rounding to bf16, stored straight from
// the accumulators to out[b, h, co, w] (8 neighbouring pixels of a column
// are 16 contiguous bytes). ops/cuda_conv.py `conv_tc_geometry` is the
// same geometry; `conv_tc_pack_plain` the pack.
//
// f32: the CUDA-core design (`conv_same_simt_kernel`,
// `conv_reflect_simt_kernel`, counted as `conv_same_simt`), which keeps f32
// products for the f32 gradient checks (JAX's Precision.HIGHEST): a block
// stages a (TILE_H + K - 1) x CI_CHUNK x (TILE_W + K - 1) input window and
// the K*K*CI_CHUNK*CO_TILE weights it needs into shared memory (zeros
// outside the image for K1; for K9 the window is read through the reflected
// index map), and each thread keeps CO_TILE output channels of one pixel in
// registers.
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The CUDA-core design

constexpr int TILE_W = 32;   // output columns per block: one warp across W
constexpr int TILE_H = 8;    // output rows per block: one warp per row
constexpr int CO_TILE = 16;  // output channels per thread, in registers
constexpr int CI_CHUNK = 8;  // input channels staged per shared-memory round

// The H100's opt-in limit of dynamic shared memory per block. A kernel's
// limit is raised to it, never to one launch's size: the attribute is one
// per kernel in the process, and two host threads launching the same kernel
// at two sizes would otherwise each lower it under the other's launch
// ("too many resources requested for launch").
constexpr int SMEM_OPT_IN_MAX = 232448;

size_t smem_bytes(int K) {
  const size_t xs = (size_t)(TILE_H + K - 1) * CI_CHUNK * (TILE_W + K - 1);
  const size_t ws = (size_t)K * K * CI_CHUNK * CO_TILE;
  return (xs + ws) * sizeof(float);
}

// Source index of padded position i in an axis of n by REFLECT: -j -> j and
// n-1+j -> n-1-j. Positions past the reflected range stay out of [0, n) and
// read as zero; only outputs past the image edge, never stored, use them.
__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// Output [Ho, Wo] = [H + 2 grow, W + 2 grow]; pb = pad + grow zero rows and
// columns before the image (K9: pb = K / 2 reflected, grow 0).
template <typename T, bool REFLECT>
__device__ __forceinline__ void conv_tile(
    float* smem, const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out, int B, int H, int C,
    int W, int Cout, int K, int pb, int grow) {
  const int SW = TILE_W + K - 1;
  const int SH = TILE_H + K - 1;
  const int Ho = H + 2 * grow, Wo = W + 2 * grow;
  float* xs = smem;                         // [SH][CI_CHUNK][SW]
  float* ws = smem + SH * CI_CHUNK * SW;    // [K*K][CI_CHUNK][CO_TILE]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int nthreads = TILE_W * TILE_H;
  const int w0 = blockIdx.x * TILE_W;
  const int h0 = blockIdx.y * TILE_H;
  const int n_co_tiles = (Cout + CO_TILE - 1) / CO_TILE;
  const int b = blockIdx.z / n_co_tiles;
  const int co0 = (blockIdx.z % n_co_tiles) * CO_TILE;

  float acc[CO_TILE];
#pragma unroll
  for (int i = 0; i < CO_TILE; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CI_CHUNK) {
    __syncthreads();  // the previous round's reads are done
    const int n_x = SH * CI_CHUNK * SW;
    for (int i = tid; i < n_x; i += nthreads) {
      const int col = i % SW;
      const int rest = i / SW;
      const int ci = rest % CI_CHUNK;
      const int row = rest / CI_CHUNK;
      int hh = h0 + row - pb;
      int ww = w0 + col - pb;
      if (REFLECT) {
        hh = reflect_index(hh, H);
        ww = reflect_index(ww, W);
      }
      const int cc = c0 + ci;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && cc < C)
        v = to_f32(x[(((size_t)b * H + hh) * C + cc) * W + ww]);
      xs[i] = v;
    }
    const int n_w = K * K * CI_CHUNK * CO_TILE;
    for (int i = tid; i < n_w; i += nthreads) {
      const int co = i % CO_TILE;
      const int rest = i / CO_TILE;
      const int ci = rest % CI_CHUNK;
      const int tap = rest / CI_CHUNK;  // dy * K + dx
      const int cc = c0 + ci;
      const int oc = co0 + co;
      float v = 0.f;
      if (cc < C && oc < Cout) v = to_f32(w[((size_t)tap * C + cc) * Cout + oc]);
      ws[i] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < CI_CHUNK; ++ci) {
      for (int dy = 0; dy < K; ++dy) {
        const float* xrow = xs + ((ty + dy) * CI_CHUNK + ci) * SW + tx;
        const float* wtap = ws + ((dy * K) * CI_CHUNK + ci) * CO_TILE;
        for (int dx = 0; dx < K; ++dx) {
          const float xv = xrow[dx];
          const float4* wv =
              reinterpret_cast<const float4*>(wtap + dx * CI_CHUNK * CO_TILE);
#pragma unroll
          for (int q = 0; q < CO_TILE / 4; ++q) {
            const float4 f = wv[q];
            acc[4 * q + 0] = fmaf(xv, f.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv, f.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv, f.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv, f.w, acc[4 * q + 3]);
          }
        }
      }
    }
  }

  const int h = h0 + ty;
  const int wc = w0 + tx;
  if (h >= Ho || wc >= Wo) return;
#pragma unroll
  for (int co = 0; co < CO_TILE; ++co) {
    const int oc = co0 + co;
    if (oc < Cout) {
      float v = acc[co];
      if (bias != nullptr) v += to_f32(bias[oc]);
      out[(((size_t)b * Ho + h) * Cout + oc) * Wo + wc] = from_f32<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TILE_W * TILE_H)
conv_same_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias, T* __restrict__ out, int B,
                      int H, int C, int W, int Cout, int K, int pb,
                      int grow) {
  extern __shared__ __align__(16) float smem[];
  conv_tile<T, false>(smem, x, w, bias, out, B, H, C, W, Cout, K, pb, grow);
}

template <typename T>
__global__ void __launch_bounds__(TILE_W * TILE_H)
conv_reflect_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ out,
                         int B, int H, int C, int W, int Cout, int K, int pb,
                         int grow) {
  extern __shared__ __align__(16) float smem[];
  conv_tile<T, true>(smem, x, w, bias, out, B, H, C, W, Cout, K, pb, grow);
}

template <typename T, bool REFLECT>
int launch_simt(const void* x, const void* w, const void* bias, void* out,
                int B, int H, int C, int W, int Cout, int K, int pad,
                int grow, void* stream) {
  if (pad < 0 || pad > K - 1 || grow < 0) return (int)cudaErrorInvalidValue;
  if (REFLECT && (K % 2 != 1 || pad != K / 2 || pad >= H || pad >= W ||
                  grow != 0))
    return (int)cudaErrorInvalidValue;
  auto kernel = REFLECT ? conv_reflect_simt_kernel<T> : conv_same_simt_kernel<T>;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  const int Ho = H + 2 * grow, Wo = W + 2 * grow;
  const int n_co_tiles = (Cout + CO_TILE - 1) / CO_TILE;
  dim3 grid((Wo + TILE_W - 1) / TILE_W, (Ho + TILE_H - 1) / TILE_H,
            B * n_co_tiles);
  dim3 block(TILE_W, TILE_H);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)bias, (T*)out, B, H, C, W, Cout, K,
      pad + grow, grow);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core design (bf16)

constexpr int TC_CONSUMERS = 2;  // consumer warpgroups, MW m64 tiles each
constexpr int TC_THREADS = TC_CONSUMERS * 128 + 32;  // + the producer warp
constexpr int TC_MAX_STAGES = 3;
constexpr int TC_SMEM_MAX = SMEM_OPT_IN_MAX;
constexpr int TC_N_MAX = 256;        // the widest N tile

// The launch's geometry (ops/cuda_conv.py `conv_tc_geometry` is the same
// rule, and sizes the workspace this checks): the padded sides; the channel
// groups of 8 and c16 steps of 16 channels; nt N tiles of n columns each
// (Cout split evenly where it passes 256); the block's M tile BM =
// TC_CONSUMERS * MW * 64 flattened pixels; `rows` tap rows (dy) per
// stage, a divisor of K, in groups = K / rows runs, and steps = c16 groups
// reduction steps, each one stage: the window of two channel groups (NW =
// BM + (rows - 1) Wp + K - 1 pixels, the span of the run's tap offsets dy
// Wp + dx) and the run's rows K taps' weights. rows is the largest divisor
// with which two stages fit (K at every shape of the recipes; one row fits
// twice for K <= 13), so that the ring never holds a single stage of
// several steps; the stages, the blocks.
struct TcGeometry {
  int B, H, C, W, Cout, K, pb, Ho, Wo, Hp, Wp, cg, c16, n, nt, mw, bm;
  int rows, groups, steps, nw, stage_bytes, stages, smem, blocks;
  long long ptot;  // B Hp Wp, the flattened padded pixels
};

int tc_n(int cout) {
  const int ns[] = {8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 256};
  for (int n : ns)
    if (cout <= n) return n;
  return 0;
}

bool tc_geometry(TcGeometry& g, int B, int H, int C, int W, int Cout, int K,
                 int pb, int grow) {
  if (B < 1 || C < 1 || Cout < 1 || K < 1) return false;
  g.B = B; g.H = H; g.C = C; g.W = W; g.Cout = Cout; g.K = K; g.pb = pb;
  g.Ho = H + 2 * grow;
  g.Wo = W + 2 * grow;
  g.Hp = g.Ho + K - 1;
  g.Wp = g.Wo + K - 1;
  g.cg = 2 * ((C + 15) / 16);
  g.c16 = g.cg / 2;
  g.nt = (Cout + TC_N_MAX - 1) / TC_N_MAX;
  g.n = tc_n((Cout + g.nt - 1) / g.nt);
  g.mw = g.n <= 128 ? 2 : 1;
  g.bm = TC_CONSUMERS * g.mw * 64;
  const int room = TC_SMEM_MAX - 2 * TC_MAX_STAGES * 8;
  for (g.rows = K; g.rows >= 1; --g.rows) {
    if (K % g.rows != 0) continue;
    g.groups = K / g.rows;
    g.steps = g.c16 * g.groups;
    g.nw = g.bm + (g.rows - 1) * g.Wp + K - 1;
    g.stage_bytes = 2 * g.nw * 16 + g.rows * K * 2 * g.n * 16;
    const int fit = room / g.stage_bytes;
    if (fit >= (g.steps < 2 ? g.steps : 2)) {
      g.stages = g.steps < TC_MAX_STAGES ? g.steps : TC_MAX_STAGES;
      if (fit < g.stages) g.stages = fit;
      break;
    }
  }
  if (g.rows < 1) return false;
  g.smem = g.stages * g.stage_bytes + 2 * g.stages * 8;
  g.ptot = (long long)B * g.Hp * g.Wp;
  g.blocks = (int)((g.ptot + g.bm - 1) / g.bm);
  return true;
}

// The workspace bytes of xp then wp.
size_t tc_workspace(const TcGeometry& g) {
  return ((size_t)g.cg * g.ptot +
          (size_t)g.nt * g.c16 * g.K * g.K * 2 * g.n) * 16;
}

// xp and wp (see the note at the top), one thread per 8 channels (one
// 16-byte store): first the Cg B Hp Wp pixels of xp, then the nt C16 K*K 2
// N rows of wp. Bound by bytes.
template <bool REFLECT>
__device__ __forceinline__ void pack(const uint16_t* __restrict__ x,
                                     const uint16_t* __restrict__ w,
                                     uint16_t* __restrict__ xp,
                                     uint16_t* __restrict__ wp,
                                     TcGeometry g) {
  const size_t n_x = (size_t)g.cg * g.ptot;
  const size_t n_w = (size_t)g.nt * g.c16 * g.K * g.K * 2 * g.n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_x + n_w; i += (size_t)gridDim.x * blockDim.x) {
    uint4 v8;
    uint16_t* v = reinterpret_cast<uint16_t*>(&v8);
    if (i < n_x) {
      size_t t = i;
      const int wq = (int)(t % g.Wp);
      t /= g.Wp;
      const int hq = (int)(t % g.Hp);
      t /= g.Hp;
      const int b = (int)(t % g.B);
      const int grp = (int)(t / g.B);
      int hs = hq - g.pb, ws = wq - g.pb;
      if (REFLECT) {
        hs = reflect_index(hs, g.H);
        ws = reflect_index(ws, g.W);
      }
      const bool inside = hs >= 0 && hs < g.H && ws >= 0 && ws < g.W;
      const uint16_t* src = x + ((size_t)b * g.H + hs) * g.C * g.W + ws;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = grp * 8 + j;
        v[j] = inside && c < g.C ? src[(size_t)c * g.W] : (uint16_t)0;
      }
      reinterpret_cast<uint4*>(xp)[i] = v8;
    } else {
      size_t t = i - n_x;
      const int co = (int)(t % g.n);
      t /= g.n;
      const int half = (int)(t % 2);
      t /= 2;
      const int tap = (int)(t % (g.K * g.K));
      t /= g.K * g.K;
      const int step = (int)(t % g.c16);
      const int oc = (int)(t / g.c16) * g.n + co;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (2 * step + half) * 8 + j;
        v[j] = c < g.C && oc < g.Cout
                   ? w[((size_t)tap * g.C + c) * g.Cout + oc]
                   : (uint16_t)0;
      }
      reinterpret_cast<uint4*>(wp)[i - n_x] = v8;
    }
  }
}

__global__ void __launch_bounds__(256)
conv_same_pack_kernel(const uint16_t* x, const uint16_t* w, uint16_t* xp,
                      uint16_t* wp, TcGeometry g) {
  pack<false>(x, w, xp, wp, g);
}

__global__ void __launch_bounds__(256)
conv_reflect_pack_kernel(const uint16_t* x, const uint16_t* w, uint16_t* xp,
                         uint16_t* wp, TcGeometry g) {
  pack<true>(x, w, xp, wp, g);
}

// Block (m, j): output rows [m BM, (m + 1) BM) of the flattened padded
// pixels, output channels [j N, (j + 1) N). Consumer warpgroup q owns rows
// q MW 64 + [0, MW 64) as MW m64 tiles. Step i is the run of tap rows
// dy0 = (i % groups) rows + [0, rows) of the 16 channels i / groups.
template <int N, int MW>
__device__ __forceinline__ void conv_tc(const uint16_t* __restrict__ xp,
                                        const uint16_t* __restrict__ wp,
                                        const __nv_bfloat16* __restrict__ bias,
                                        __nv_bfloat16* __restrict__ out,
                                        const TcGeometry& g) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  uint64_t* full =
      reinterpret_cast<uint64_t*>(tc_smem + g.stages * g.stage_bytes);
  uint64_t* empty = full + g.stages;
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * g.bm;
  const int S = g.stages;
  const int taps = g.K * g.K;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_CONSUMERS * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS * 128) {
    // the producer: one thread issues every bulk copy. A window stops at
    // the end of xp; rows it leaves stale feed only outputs never stored
    // (a stored output's taps all lie in its own image).
    if (tid != TC_CONSUMERS * 128) return;
    const uint16_t* wtile = wp + (size_t)blockIdx.y * g.c16 * taps * 2 * N * 8;
    for (int i = 0; i < g.steps; ++i) {
      const int s = i % S;
      if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
      const int step = i / g.groups;
      const int dy0 = (i % g.groups) * g.rows;
      const long long start = m0 + (long long)dy0 * g.Wp;
      const long long left = g.ptot - start;
      const uint32_t nwv = left <= 0 ? 0u
                           : (uint32_t)(left < g.nw ? left : g.nw);
      const uint32_t w_bytes = g.rows * g.K * 2 * N * 16;
      uint8_t* stage = tc_smem + s * g.stage_bytes;
      mbar_expect_tx(&full[s], 2 * nwv * 16 + w_bytes);
      if (nwv > 0)
        for (int half = 0; half < 2; ++half)
          bulk_load(stage + half * g.nw * 16,
                    xp + ((size_t)(2 * step + half) * g.ptot + start) * 8,
                    nwv * 16, &full[s]);
      bulk_load(stage + 2 * g.nw * 16,
                wtile + ((size_t)step * taps + dy0 * g.K) * 2 * N * 8,
                w_bytes,
                &full[s]);
    }
    return;
  }

  const int q = tid / 128;
  float acc[MW][N / 2];
#pragma unroll
  for (int j = 0; j < MW; ++j)
#pragma unroll
    for (int k = 0; k < N / 2; ++k) acc[j][k] = 0.f;

  for (int i = 0; i < g.steps; ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    const uint8_t* window = tc_smem + s * g.stage_bytes + q * MW * 64 * 16;
    const uint8_t* weights = tc_smem + s * g.stage_bytes + 2 * g.nw * 16;
#pragma unroll
    for (int j = 0; j < MW; ++j)
#pragma unroll
      for (int k = 0; k < N / 2; ++k) fence_operand(acc[j][k]);
    wgmma_fence();
    // tap (dy0 + dy, dx) is the window at offset dy Wp + dx. The loops'
    // bounds are launch constants: on an H100, bounds computed per step
    // (a shorter last run) made the kernel 1.2x slower over the recipes'
    // K > 1 shapes, and an index division per tap 1.3x.
    for (int dy = 0; dy < g.rows; ++dy) {
      for (int dx = 0; dx < g.K; ++dx) {
        const int off = dy * g.Wp + dx;
        const uint64_t b = kmajor_desc(
            weights + (dy * g.K + dx) * 2 * N * 16, N * 16, 128);
#pragma unroll
        for (int j = 0; j < MW; ++j)
          wgmma_wide<N>(acc[j],
                        kmajor_desc(window + (j * 64 + off) * 16,
                                    g.nw * 16, 128),
                        b);
      }
    }
    wgmma_commit();
    // the previous step's products are done: its stage is free. The ring
    // holds at least two stages wherever there are two steps (tc_geometry),
    // so the stage this step waited on is never the one it frees.
    wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < MW; ++j)
#pragma unroll
      for (int k = 0; k < N / 2; ++k) fence_operand(acc[j][k]);
    if (i > 0) mbar_arrive(&empty[(i - 1) % S]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < MW; ++j)
#pragma unroll
    for (int k = 0; k < N / 2; ++k) fence_operand(acc[j][k]);

  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int co0 = blockIdx.y * N;
  const long long plane = (long long)g.Hp * g.Wp;
#pragma unroll
  for (int j = 0; j < MW; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m =
          m0 + q * MW * 64 + j * 64 + warp * 16 + lane / 4 + 8 * half;
      if (m >= g.ptot) continue;
      const int b = (int)(m / plane);
      const int rem = (int)(m % plane);
      const int h = rem / g.Wp, w = rem % g.Wp;
      if (h >= g.Ho || w >= g.Wo) continue;
      __nv_bfloat16* dst = out + ((size_t)b * g.Ho + h) * g.Cout * g.Wo + w;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        if ((k / 2) % 2 != half) continue;
        const int co = co0 + 8 * (k / 4) + 2 * (lane % 4) + k % 2;
        if (co >= g.Cout) continue;
        float v = acc[j][k];
        if (bias != nullptr) v += __bfloat162float(bias[co]);
        dst[(size_t)co * g.Wo] = __float2bfloat16_rn(v);
      }
    }
  }
}

template <int N, int MW>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_same_tc_kernel(const uint16_t* xp, const uint16_t* wp,
                    const __nv_bfloat16* bias, __nv_bfloat16* out,
                    const __grid_constant__ TcGeometry g) {
  conv_tc<N, MW>(xp, wp, bias, out, g);
}

// the same body for K9, under its own name in a profiler trace
template <int N, int MW>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_reflect_tc_kernel(const uint16_t* xp, const uint16_t* wp,
                       const __nv_bfloat16* bias, __nv_bfloat16* out,
                       const __grid_constant__ TcGeometry g) {
  conv_tc<N, MW>(xp, wp, bias, out, g);
}

template <int N>
int launch_tc_n(bool reflect, const TcGeometry& g, const uint16_t* xp,
                const uint16_t* wp, const void* bias, void* out,
                cudaStream_t s) {
  constexpr int MW = N <= 128 ? 2 : 1;
  auto kernel = reflect ? conv_reflect_tc_kernel<N, MW>
                        : conv_same_tc_kernel<N, MW>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(g.blocks, g.nt), TC_THREADS, g.smem, s>>>(
      xp, wp, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, g);
  return (int)cudaGetLastError();
}

// ws: ws_bytes of room for xp then wp, Cg B Hp Wp 8 + nt C16 K K 2 N 8
// bf16 (ops/cuda_conv.py `_launch_conv` allocates it from its copy of the
// geometry), 16-byte aligned; less room than this geometry needs is refused.
int launch_tc(bool reflect, const void* x, const void* w, const void* bias,
              void* out, void* ws, long long ws_bytes, int B, int H, int C,
              int W, int Cout, int K, int pad, int grow, void* stream) {
  if (pad < 0 || pad > K - 1 || grow < 0) return (int)cudaErrorInvalidValue;
  if (reflect && (K % 2 != 1 || pad != K / 2 || pad >= H || pad >= W ||
                  grow != 0))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)ws % 16 != 0) return (int)cudaErrorInvalidValue;
  TcGeometry g;
  if (!tc_geometry(g, B, H, C, W, Cout, K, pad + grow, grow) ||
      ws_bytes < 0 || (size_t)ws_bytes < tc_workspace(g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint16_t* xp = (uint16_t*)ws;
  uint16_t* wp = xp + (size_t)g.cg * g.ptot * 8;
  auto pack_kernel = reflect ? conv_reflect_pack_kernel : conv_same_pack_kernel;
  pack_kernel<<<grid_for(tc_workspace(g) / 16, 256), 256, 0, s>>>(
      (const uint16_t*)x, (const uint16_t*)w, xp, wp, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (g.n) {
    case 8: return launch_tc_n<8>(reflect, g, xp, wp, bias, out, s);
    case 16: return launch_tc_n<16>(reflect, g, xp, wp, bias, out, s);
    case 32: return launch_tc_n<32>(reflect, g, xp, wp, bias, out, s);
    case 48: return launch_tc_n<48>(reflect, g, xp, wp, bias, out, s);
    case 64: return launch_tc_n<64>(reflect, g, xp, wp, bias, out, s);
    case 80: return launch_tc_n<80>(reflect, g, xp, wp, bias, out, s);
    case 96: return launch_tc_n<96>(reflect, g, xp, wp, bias, out, s);
    case 128: return launch_tc_n<128>(reflect, g, xp, wp, bias, out, s);
    case 160: return launch_tc_n<160>(reflect, g, xp, wp, bias, out, s);
    case 192: return launch_tc_n<192>(reflect, g, xp, wp, bias, out, s);
    default: return launch_tc_n<256>(reflect, g, xp, wp, bias, out, s);
  }
}

}  // namespace

// K1 in bf16: the pack, then the tensor-core product (see launch_tc).
extern "C" int conv_same_bf16(const void* x, const void* w, const void* bias,
                              void* out, void* ws, long long ws_bytes, int B,
                              int H, int C, int W, int Cout, int K, int pad,
                              int grow, void* stream) {
  return launch_tc(false, x, w, bias, out, ws, ws_bytes, B, H, C, W, Cout, K,
                   pad, grow, stream);
}

// K9 in bf16: the reflect pack, then the same product.
extern "C" int conv_reflect_bf16(const void* x, const void* w,
                                 const void* bias, void* out, void* ws,
                                 long long ws_bytes, int B, int H, int C,
                                 int W, int Cout, int K, void* stream) {
  return launch_tc(true, x, w, bias, out, ws, ws_bytes, B, H, C, W, Cout, K,
                   K / 2, 0, stream);
}

// The CUDA-core design: f32 on the main path, bf16 only to compare.
extern "C" int conv_same_simt_f32(const void* x, const void* w,
                                  const void* bias, void* out, int B, int H,
                                  int C, int W, int Cout, int K, int pad,
                                  int grow, void* stream) {
  return launch_simt<float, false>(x, w, bias, out, B, H, C, W, Cout, K, pad,
                                   grow, stream);
}

extern "C" int conv_same_simt_bf16(const void* x, const void* w,
                                   const void* bias, void* out, int B, int H,
                                   int C, int W, int Cout, int K, int pad,
                                   int grow, void* stream) {
  return launch_simt<__nv_bfloat16, false>(x, w, bias, out, B, H, C, W, Cout,
                                           K, pad, grow, stream);
}

extern "C" int conv_reflect_simt_f32(const void* x, const void* w,
                                     const void* bias, void* out, int B,
                                     int H, int C, int W, int Cout, int K,
                                     void* stream) {
  return launch_simt<float, true>(x, w, bias, out, B, H, C, W, Cout, K,
                                  K / 2, 0, stream);
}

extern "C" int conv_reflect_simt_bf16(const void* x, const void* w,
                                      const void* bias, void* out, int B,
                                      int H, int C, int W, int Cout, int K,
                                      void* stream) {
  return launch_simt<__nv_bfloat16, true>(x, w, bias, out, B, H, C, W, Cout,
                                          K, K / 2, 0, stream);
}
