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
// Bound on the H100: operations, by shape class. As a matrix product,
// dw[m, co] = sum_p patch[p, m] g[p, co] with m = (dy, dx, c) over the p =
// B*H*W pixels (up to 524,288 terms). The generator's and discriminators'
// wide layers (C and Cout 16-256, K 3-7) need x and g read once for 16-600
// multiply-adds per byte: over the card's 295 only where C and Cout pass
// 128 (the ResNet and U-GAT-IT trunk, 256 x 256 at 64x64); the stems (C 3)
// and heads (Cout 1-3, K 7) waste the wgmma's width (8 channel rows per
// group, N 8 for Cout 3), and the 1x1 heads (K 1) are bound by bytes. Both
// designs below split the pixel sum over slices of the steps into an f32
// workspace [splits, K*K*C, Cout] (only real (tap, c) rows and co columns
// are written), and a second kernel adds the splits in a fixed order: the
// result does not depend on scheduling and is equal bit for bit across
// runs, with no atomics.
//
// bf16, the main path: the tap-ring design (`conv_dw_tma_kernel`,
// `conv_reflect_dw_tma_kernel`). A TMA box cannot start at an odd column,
// so the TMA design before it first wrote K column-shifted copies of x to
// device memory and loaded each tap's box from them: every x element
// crossed into shared memory about K*K times (K copies, K row shifts),
// the copies were written and read back, and every pair of M tiles loaded
// g again. Here a block walks its slice of steps, one output row h of one
// 64-pixel chunk each, h fastest, and reads x and g once a step:
// - the producer warpgroup: one thread TMA-loads each x row the block's
//   taps need, as it lies ([8 groups_max channels, raw_lines pixels] from
//   the chunk's column - lead, a 16-byte aligned start; TMA reads zeros
//   outside x: SAME's rows and columns, channels past C), another the
//   step's g tile ([N, 64 pixels], 128-byte swizzle); two warps transpose
//   each x row on chip into a ring of the last rows of the block's dy span
//   (plus DW_AHEAD rows in flight): one 16-byte line per pixel, 8 channels
//   innermost (ldmatrix, then stmatrix .trans). raw_lines is an odd
//   multiple of 8, so the 8 channel rows one ldmatrix reads fall in 8
//   distinct bank groups;
// - two consumer warpgroups form every tap's A fragment (64 (tap, channel)
//   rows x 16 pixels) from the ring: dy picks the ring row and the dx
//   shift is a start 16 dx bytes further along the lines, which ldmatrix
//   .trans takes at any 16-byte line. That is the route for dx: a
//   shared-memory descriptor cannot start inside a 128-byte swizzle row,
//   and a transposed (MN-major) descriptor would need one stride between
//   the 8-row groups of an M tile, which the (tap, group) rows of a small
//   C do not have; ldmatrix gives each 8-row group its own address and
//   reads no more than wgmma would, 2 KB an m64k16 fragment. A is wgmma's
//   register operand, B the g tile K-major in shared memory, as the old
//   design had it; one g tile serves every (tap, channel) row of the
//   block, and its f32 sums stay in registers (mt m64 tiles a warpgroup);
// - mbarriers hand x rows, ring rows and g tiles on; each warp arrives
//   once, from lane 0 after __syncwarp (one arrival per thread serialized
//   256 shared-memory atomics a step and took more time than the products);
//   consumers free a ring row right after their last ldmatrix of it.
// The rows (channel group of 8, tap) are taken group-major, so a block's
// rows span few channel groups and its x rows carry only those; a block
// holds 2 mt m64 tiles, mt picked by an estimate of its time
// (`dw_geometry`). K9-dW applies the reflect pad as an index map: the x
// rows' TMA coordinate is the reflected row, and at the W edges the
// transposing warps store pixels 1 .. pad and W - 1 - pad .. W - 2 a
// second time at the lines of their mirror images. No padded or shifted
// copy is written.
//
// f32, and bf16 outside the tap-ring domain (a base not 16-byte aligned, W
// not a multiple of 8 so that a row's stride is not a multiple of 16
// bytes, or a window wider than DW_MAX_LINES): the CUDA-core design
// (`conv_dw_partial_kernel`, the `conv_dw_simt` counter; the Python
// wrapper picks by that rule). A block
// owns a 64 x 32 output tile; per 32-pixel stretch of a row it stages the
// im2col values (K9-dW through the reflected index map, no padded copy)
// and the g values in shared memory, and each thread accumulates a 4x4
// micro-tile in f32. It keeps the f32 gradient check off TF32.
#include <algorithm>

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
// The tap-ring design (bf16): TMA and wgmma, every tap formed on chip

constexpr int DW_PX = 64;          // pixels a step: one 128-byte g row
constexpr int DW_CONSUMERS = 2;    // consumer warpgroups
constexpr int DW_THREADS = (1 + DW_CONSUMERS) * 128;  // + the producer's
constexpr int DW_TRANSPOSERS = 64; // producer warps 2-3
constexpr int DW_GSTAGES = 4;      // g tiles in flight
constexpr int DW_RAW = 3;          // x rows in flight as they lie (NHCW)
constexpr int DW_AHEAD = 2;        // ring rows beyond a block's dy span
constexpr int DW_MAX_LINES = 96;   // window pixels a channel group stages
constexpr int DW_MAX_GROUPS = 32;  // channel groups of one x box (256 rows)
constexpr int DW_MIN_UNITS = 16;   // the fewest steps a split should sum
constexpr int DW_STEP_CLK = 300;   // a step's cost apart from its tiles
constexpr int DW_SMS = 132;        // one block per SM
constexpr int SMEM_OPT_IN_MAX = 232448;

// How a launch is cut (see the note at the top); ops/cuda_conv.py
// `dw_tma_geometry` is the same rule. groups: channel groups of 8; rows
// (tap, group) in group-major order, rg_block of them a block (2 mt m64
// tiles of 8 row groups per consumer warpgroup), m_blocks blocks; n_tiles
// tiles of N = n output channels; the window of a row: lead pixels before
// the step's 64, lines in all in the ring (a multiple of 32) and raw_lines
// as TMA loads it (an odd multiple of 8, so that the 8 channel rows an
// ldmatrix reads fall in 8 distinct bank groups); the ring: slots rows of
// groups_max channel groups; chunks 64-pixel steps a row, units = B chunks
// H steps in all, cut into splits slices.
struct DwGeometry {
  int n, mt, n_tiles, groups, rg_block, m_blocks, lead, lines, raw_lines,
      slots, groups_max, chunks, units, splits, smem;
};

// the taps' dy rows [d0, d1] and channel groups [g0, g1] of block m
struct DwBlock {
  int r0, r1, g0, g1, d0, d1;
};

__host__ __device__ inline DwBlock dw_block(int m, int rg_block, int total,
                                            int K) {
  DwBlock blk;
  const int KK = K * K;
  blk.r0 = m * rg_block;
  blk.r1 = total < blk.r0 + rg_block ? total : blk.r0 + rg_block;
  blk.g0 = blk.r0 / KK;
  blk.g1 = (blk.r1 - 1) / KK;
  const bool one = blk.g0 == blk.g1;
  blk.d0 = one ? (blk.r0 % KK) / K : 0;
  blk.d1 = one ? ((blk.r1 - 1) % KK) / K : K - 1;
  return blk;
}

__host__ __device__ inline int dw_smem(int n, int slots, int groups_max,
                                       int lines, int raw_lines) {
  return 1024 + DW_GSTAGES * n * 128 +
         (slots * lines + DW_RAW * raw_lines) * groups_max * 16 +
         16 * (DW_GSTAGES + DW_RAW + slots);
}

// n = 0: no cut fits (the wrapper then runs the CUDA-core design)
DwGeometry dw_geometry(int B, int H, int W, int C, int Cout, int K,
                       int pad) {
  DwGeometry geo = {};
  const int KK = K * K;
  geo.groups = (C + 7) / 8;
  const int total = geo.groups * KK;
  geo.n_tiles = (Cout + 127) / 128;
  const int per_tile = (Cout + geo.n_tiles - 1) / geo.n_tiles;
  geo.n = per_tile <= 8 ? 8 : per_tile <= 16 ? 16 : per_tile <= 32 ? 32
        : per_tile <= 64 ? 64 : 128;
  geo.lead = 8 * ((pad + 7) / 8);
  const int trail = 8 * ((K - 1 - pad + 7) / 8);
  geo.lines = (DW_PX + geo.lead + trail + 31) / 32 * 32;
  geo.raw_lines = DW_PX + geo.lead + trail + ((DW_PX + geo.lead + trail) %
                                              16 == 0 ? 8 : 0);
  if (geo.lines > DW_MAX_LINES) return DwGeometry{};
  // m64 tiles per warpgroup: the least estimated time, m_blocks steps of
  // DW_STEP_CLK plus 2 mt tiles of max(2 n, 64 + n) clocks (the tensor
  // cores' time for 4 k16 steps of m64nNk16, or shared memory's for A and
  // B); the most tiles where two tie
  const int top = geo.n == 128 ? 2 : geo.n == 8 ? 8 : 4;
  const int tile_clk = std::max(2 * geo.n, 64 + geo.n);
  int best = 0;
  long best_cost = 0;
  for (int mt = top; mt >= 1; mt /= 2) {
    const int rg_block = 16 * mt;
    const int m_blocks = (total + rg_block - 1) / rg_block;
    int span = 0, groups_max = 0;
    for (int m = 0; m < m_blocks; ++m) {
      const DwBlock blk = dw_block(m, rg_block, total, K);
      span = std::max(span, blk.d1 - blk.d0 + 1);
      groups_max = std::max(groups_max, blk.g1 - blk.g0 + 1);
    }
    const int slots = span + DW_AHEAD;
    const int smem =
        dw_smem(geo.n, slots, groups_max, geo.lines, geo.raw_lines);
    if (smem > SMEM_OPT_IN_MAX || groups_max > DW_MAX_GROUPS) continue;
    const long cost = (long)m_blocks * (DW_STEP_CLK + 2 * mt * tile_clk);
    if (best == 0 || cost < best_cost) {
      best = mt;
      best_cost = cost;
      geo.rg_block = rg_block;
      geo.m_blocks = m_blocks;
      geo.slots = slots;
      geo.groups_max = groups_max;
      geo.smem = smem;
    }
  }
  if (best == 0) return DwGeometry{};
  geo.mt = best;
  geo.chunks = (W + DW_PX - 1) / DW_PX;
  geo.units = B * geo.chunks * H;
  const int per_split = geo.m_blocks * geo.n_tiles;
  geo.splits =
      std::max(1, std::min(geo.units / DW_MIN_UNITS, DW_SMS / per_split));
  return geo;
}

// A block's walk: its steps u in [u0, u1), (b, chunk, h) with h fastest;
// each step reads x rows h + dy - pad, dy in [d0, d1] (padded
// coordinates), the newest h + d1 - pad. The stream of x rows it stages:
// per step that newest row, and before the first step of the slice and of
// each new (b, chunk) the span's other rows first (e from d0 - d1 to -1).
struct DwWalk {
  int u0, u1, warm, H;
  __device__ __forceinline__ int first(int u) const {
    return (u == u0 || u % H == 0) ? warm : 0;
  }
};

// Block (rg_block row groups, N tile, split), three warpgroups:
// - the producer: one thread of warp 0 issues the TMA loads of the
//   stream's x rows (as they lie, [8 groups_max channels, lines pixels],
//   DW_RAW in flight), one of warp 1 those of each step's g tile
//   (DW_GSTAGES in flight); warps 2-3 transpose each x row into the ring, 8
//   channels innermost (ldmatrix, stmatrix .trans), apply REFLECT's
//   columns at the W edges, and hand the row on;
// - two consumer warpgroups: per step every tap's A fragment by ldmatrix
//   .trans from the ring rows at the tap's dx offset, wgmma against the g
//   tile, f32 sums in registers; then the partial sums.
// xmap tiles x [1, B, H, C, W] in boxes [1, 1, 1, 8 groups_max, lines];
// gmap g [1, B, H, Cout, W] in boxes [1, 1, 1, N, 64], 128-byte swizzle.
template <int N, int MT, bool REFLECT>
__device__ __forceinline__ void dw_ring(const CUtensorMap* xmap,
                                        const CUtensorMap* gmap,
                                        float* __restrict__ part, int H,
                                        int W, int C, int Cout, int K,
                                        int pad, DwGeometry geo) {
  constexpr int GTILE = N * DW_PX * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int slot_bytes = geo.groups_max * geo.lines * 16;
  const int raw_bytes = geo.groups_max * geo.raw_lines * 16;
  uint8_t* ring = smem + DW_GSTAGES * GTILE;
  uint8_t* raw = ring + geo.slots * slot_bytes;
  uint64_t* g_full = reinterpret_cast<uint64_t*>(raw + DW_RAW * raw_bytes);
  uint64_t* g_empty = g_full + DW_GSTAGES;
  uint64_t* raw_full = g_empty + DW_GSTAGES;
  uint64_t* raw_empty = raw_full + DW_RAW;
  uint64_t* ring_full = raw_empty + DW_RAW;
  uint64_t* ring_empty = ring_full + geo.slots;

  const int KK = K * K;
  const DwBlock blk = dw_block(blockIdx.x, geo.rg_block, geo.groups * KK, K);
  const int span = blk.d1 - blk.d0 + 1, S = geo.slots;
  const int n0 = blockIdx.y * N;
  const int split = blockIdx.z;
  const int per = (geo.units + geo.splits - 1) / geo.splits;
  DwWalk walk;
  walk.u0 = min(geo.units, split * per);
  walk.u1 = min(geo.units, walk.u0 + per);
  walk.warm = blk.d0 - blk.d1;
  walk.H = H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    // one arrival per warp: lane 0's, after its warp's accesses
    for (int s = 0; s < DW_GSTAGES; ++s) {
      mbar_init(&g_full[s], 1);
      mbar_init(&g_empty[s], DW_CONSUMERS * 4);
    }
    for (int s = 0; s < DW_RAW; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], DW_TRANSPOSERS / 32);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&ring_full[s], DW_TRANSPOSERS / 32);
      mbar_init(&ring_empty[s], DW_CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    setmaxnreg_dec<56>();
    if (warp == 0) {
      // the x rows, in the order the steps take them
      if (lane != 0) return;
      int j = 0;
      for (int u = walk.u0; u < walk.u1; ++u) {
        const int h = u % H, wc = (u / H) % geo.chunks;
        const int b = u / H / geo.chunks;
        for (int e = walk.first(u); e <= 0; ++e, ++j) {
          const int s = j % DW_RAW;
          if (j >= DW_RAW) mbar_wait(&raw_empty[s], ((j / DW_RAW) - 1) & 1);
          const int xr = h + blk.d1 - pad + e;
          mbar_expect_tx(&raw_full[s], raw_bytes);
          tma_load_5d(raw + s * raw_bytes, xmap, &raw_full[s],
                      wc * DW_PX - geo.lead, 8 * blk.g0,
                      REFLECT ? reflect_index(xr, H) : xr, b, 0);
        }
      }
      return;
    }
    if (warp == 1) {
      // the g tile of every step
      if (lane != 0) return;
      for (int i = 0; walk.u0 + i < walk.u1; ++i) {
        const int u = walk.u0 + i;
        const int h = u % H, wc = (u / H) % geo.chunks;
        const int b = u / H / geo.chunks, s = i % DW_GSTAGES;
        if (i >= DW_GSTAGES)
          mbar_wait(&g_empty[s], ((i / DW_GSTAGES) - 1) & 1);
        mbar_expect_tx(&g_full[s], GTILE);
        tma_load_5d(smem + s * GTILE, gmap, &g_full[s], wc * DW_PX, n0, h, b,
                    0);
      }
      return;
    }
    // warps 2-3: each x row of the stream into its ring slot, 8 channels
    // innermost: channel group gl to warp 2 + gl % 2, its per_group
    // batches of 32 pixels loaded, then stored; lane l addresses row l % 8
    // of matrix l / 8 in both: channel 8 gl + l % 8 at pixels 8 (l / 8) of
    // the raw row, and pixel line 8 (l / 8) + l % 8 of the group in the
    // ring. Lines past the window (from a raw row's end on) are never read.
    // REFLECT: the pixels 1 .. pad and W - 1 - pad .. W - 2 are stored a
    // second time, after the group's own lines, at the lines of -1 .. -pad
    // and W .. W - 1 + pad (TMA read those as zeros); a lane with no such
    // pixel stores its own line again if that pixel is in the row, else
    // into the last line (past the raw row's end, never read).
    const int per_group = geo.lines / 32;
    const int ngb = blk.g1 - blk.g0 + 1;
    int j = 0;
    for (int u = walk.u0; u < walk.u1; ++u) {
      const int px0 = (u / H) % geo.chunks * DW_PX - geo.lead;
      for (int e = walk.first(u); e <= 0; ++e, ++j) {
        const int s = j % DW_RAW, r = j % S;
        mbar_wait(&raw_full[s], (j / DW_RAW) & 1);
        if (j >= S) mbar_wait(&ring_empty[r], ((j / S) - 1) & 1);
        const uint32_t src = smem_u32(raw + s * raw_bytes);
        const uint32_t dst = smem_u32(ring + r * slot_bytes);
        for (int gl = warp - 2; gl < ngb; gl += 2) {
          uint32_t v[3][4];
#pragma unroll
          for (int q = 0; q < 3; ++q)
            if (q < per_group)
              ldmatrix_x4(v[q], src + ((8 * gl + lane % 8) * geo.raw_lines +
                                       (4 * q + lane / 8) * 8) * 2);
          const uint32_t base = dst + gl * geo.lines * 16;
#pragma unroll
          for (int q = 0; q < 3; ++q)
            if (q < per_group)
              stmatrix_x4_trans(base + (32 * q + lane) * 16, v[q]);
          if (REFLECT && (px0 < 0 || px0 + geo.lines > W)) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              // a batch with no pixel to mirror stores nothing again
              const int first = px0 + 32 * q;
              if (q >= per_group ||
                  (first + 31 < W - 1 - pad && (first > pad || first + 31 < 1)))
                continue;
              const int line = 32 * q + lane, px = px0 + line;
              int to = px >= 0 && px < W ? line : geo.lines - 1;
              if (px >= 1 && px <= pad)
                to = line - 2 * px;
              else if (px >= W - 1 - pad && px <= W - 2 &&
                       line + 2 * (W - 1 - px) < geo.lines)
                to = line + 2 * (W - 1 - px);
              stmatrix_x4_trans(base + to * 16, v[q]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&raw_empty[s]);
          mbar_arrive(&ring_full[r]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<224>();
  const int wg = warp / 4 - 1, cw = warp % 4;
  // ldmatrix addresses: lane l reads stored row l % 8 of matrix l / 8 of
  // each of its warp's A fragments: row group 2 cw + (l / 8) % 2 of the
  // tile, pixels 8 ((l / 8) / 2) + l % 8 of the k16 step, shifted by its
  // tap's dx; back is how many rows before a step's newest its dy reads
  int off[MT], back[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int jq = lane / 8;
    const int rg = blk.r0 + (wg * MT + mt) * 8 + 2 * cw + (jq & 1);
    int g = 0, dy = blk.d1, dx = 0;
    if (rg < blk.r1) {
      const int tap = rg % KK;
      g = rg / KK - blk.g0;
      dy = tap / K;
      dx = tap % K;
    }
    off[mt] = (g * geo.lines + 8 * (jq >> 1) + (lane & 7) + dx - pad +
               geo.lead) * 16;
    back[mt] = blk.d1 - dy;
  }

  float acc[MT][N / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
  uint32_t a[DW_PX / 16][MT][4];
  const uint32_t ring_u32 = smem_u32(ring);
  // the newest row of a step: its slot and that slot's phase; the slot of
  // the oldest row of the span
  int slot = -1, phase = 0, h = walk.u0 % H;
  for (int u = walk.u0; u < walk.u1; ++u) {
    const int ci = u - walk.u0;
    slot += (u == walk.u0 || h == 0) ? span : 1;
    if (slot >= S) {
      slot -= S;
      phase ^= 1;
    }
    mbar_wait(&ring_full[slot], phase);
    const int s = ci % DW_GSTAGES;
    mbar_wait(&g_full[s], (ci / DW_GSTAGES) & 1);
    const uint8_t* bt = smem + s * GTILE;
    uint32_t addr[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = slot - back[mt];
      addr[mt] = ring_u32 + (r < 0 ? r + S : r) * slot_bytes + off[mt];
    }
    // the ring rows this step reads last: its oldest, or all of them
    // where the next step starts a new (b, chunk) or the slice ends
    if (++h == H) h = 0;
    const int release = (u + 1 == walk.u1 || h == 0) ? span : 1;
    // the previous step's products are done: its A registers and its g
    // tile are free
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < DW_PX / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) fence_operand(a[kk][mt][q]);
    if (ci > 0 && lane == 0) mbar_arrive(&g_empty[(ci - 1) % DW_GSTAGES]);
#pragma unroll
    for (int kk = 0; kk < DW_PX / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4_trans(a[kk][mt], addr[mt] + kk * 256);
    __syncwarp();
    for (int i = 0; i < release && lane == 0; ++i) {
      const int r = slot - span + 1 + i;
      mbar_arrive(&ring_empty[r < 0 ? r + S : r]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_operand(acc[mt][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_PX / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_rs<N>(acc[mt], a[kk][mt], sw128_desc(bt + 32 * kk));
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[mt][i]);

  // thread t holds acc[mt][i] at tile row 16 cw + lane / 4 +
  // 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  float* out = part + (size_t)split * KK * C * Cout;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rg = blk.r0 + (wg * MT + mt) * 8 + 2 * cw + half;
      const int c = (rg / KK) * 8 + lane / 4;
      if (rg >= blk.r1 || c >= C) continue;
      float* row = out + ((size_t)(rg % KK) * C + c) * Cout;
#pragma unroll
      for (int i = 2 * half; i < N / 2; i += 4) {
        const int co = n0 + (i / 4) * 8 + (lane % 4) * 2;
        if (co < Cout) row[co] = acc[mt][i];
        if (co + 1 < Cout) row[co + 1] = acc[mt][i + 1];
      }
    }
  }
}

template <int N, int MT>
__global__ void __launch_bounds__(DW_THREADS, 1)
conv_dw_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap, float* part,
                   int B, int H, int W, int C, int Cout, int K, int pad,
                   DwGeometry geo) {
  dw_ring<N, MT, false>(&xmap, &gmap, part, H, W, C, Cout, K, pad, geo);
}

// the same body for K9-dW, x read through the reflected index map, under
// its own name in a profiler trace
template <int N, int MT>
__global__ void __launch_bounds__(DW_THREADS, 1)
conv_reflect_dw_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap gmap,
                           float* part, int B, int H, int W, int C, int Cout,
                           int K, int pad, DwGeometry geo) {
  dw_ring<N, MT, true>(&xmap, &gmap, part, H, W, C, Cout, K, pad, geo);
}

// A contiguous bf16 [B, H, rows, W] tensor as a 5-D map [1, B, H, rows, W]
// tiled in boxes [1, 1, 1, box_rows, box_w]: the 128-byte swizzle (g, whose
// box is one 128-byte row wide) or none (x)
bool encode_map(CUtensorMap* map, const void* base, int B, int H, int rows,
                int W, int box_rows, int box_w, bool swizzle) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)W * 2;
  cuuint64_t dims[5] = {(cuuint64_t)W, (cuuint64_t)rows, (cuuint64_t)H,
                        (cuuint64_t)B, 1};
  cuuint64_t strides[4] = {row, row * rows, row * rows * H,
                           row * rows * H * B};
  cuuint32_t box[5] = {(cuuint32_t)box_w, (cuuint32_t)box_rows, 1, 1, 1};
  cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, int MT>
int launch_ring_nm(bool reflect, const CUtensorMap& xmap,
                   const CUtensorMap& gmap, float* part, int B, int H, int W,
                   int C, int Cout, int K, int pad, const DwGeometry& geo,
                   cudaStream_t stream) {
  auto kernel =
      reflect ? conv_reflect_dw_tma_kernel<N, MT> : conv_dw_tma_kernel<N, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN_MAX);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(geo.m_blocks, geo.n_tiles, geo.splits);
  kernel<<<grid, DW_THREADS, geo.smem, stream>>>(xmap, gmap, part, B, H, W,
                                                  C, Cout, K, pad, geo);
  return (int)cudaGetLastError();
}

template <int N>
int launch_ring_n(bool reflect, const CUtensorMap& xmap,
                  const CUtensorMap& gmap, float* part, int B, int H, int W,
                  int C, int Cout, int K, int pad, const DwGeometry& geo,
                  cudaStream_t stream) {
  if (geo.mt == 1)
    return launch_ring_nm<N, 1>(reflect, xmap, gmap, part, B, H, W, C, Cout,
                                K, pad, geo, stream);
  if (geo.mt == 2)
    return launch_ring_nm<N, 2>(reflect, xmap, gmap, part, B, H, W, C, Cout,
                                K, pad, geo, stream);
  if constexpr (N == 8)
    if (geo.mt == 8)
      return launch_ring_nm<N, 8>(reflect, xmap, gmap, part, B, H, W, C,
                                  Cout, K, pad, geo, stream);
  if constexpr (N <= 64)
    return launch_ring_nm<N, 4>(reflect, xmap, gmap, part, B, H, W, C, Cout,
                                K, pad, geo, stream);
  return (int)cudaErrorInvalidValue;
}

// x [B, H, C, W], g [B, H, Cout, W]; `splits` is the wrapper's copy of the
// geometry's (the workspace holds that many slices), refused if it differs
int launch_ring(bool reflect, const void* x, const void* g, void* part,
                void* dw, int B, int H, int C, int W, int Cout, int K,
                int pad, int splits, void* stream) {
  if (pad < 0 || pad > K - 1) return (int)cudaErrorInvalidValue;
  if (reflect && (K % 2 != 1 || pad != K / 2 || pad >= H || pad >= W))
    return (int)cudaErrorInvalidValue;
  if (W % 8 != 0 || ((uintptr_t)x | (uintptr_t)g) % 16 != 0)
    return (int)cudaErrorInvalidValue;  // outside the TMA domain
  const DwGeometry geo = dw_geometry(B, H, W, C, Cout, K, pad);
  if (geo.n == 0 || splits != geo.splits ||
      (reflect && geo.raw_lines >= geo.lines))
    return (int)cudaErrorInvalidValue;
  if (tensor_map_encoder() == nullptr)
    return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap xmap, gmap;
  if (!encode_map(&xmap, x, B, H, C, W, 8 * geo.groups_max, geo.raw_lines,
                  false) ||
      !encode_map(&gmap, g, B, H, Cout, W, geo.n, DW_PX, true))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)part;
  int err;
  if (geo.n == 8)
    err = launch_ring_n<8>(reflect, xmap, gmap, p, B, H, W, C, Cout, K,
                           pad, geo, s);
  else if (geo.n == 16)
    err = launch_ring_n<16>(reflect, xmap, gmap, p, B, H, W, C, Cout, K,
                            pad, geo, s);
  else if (geo.n == 32)
    err = launch_ring_n<32>(reflect, xmap, gmap, p, B, H, W, C, Cout, K,
                            pad, geo, s);
  else if (geo.n == 64)
    err = launch_ring_n<64>(reflect, xmap, gmap, p, B, H, W, C, Cout, K,
                            pad, geo, s);
  else
    err = launch_ring_n<128>(reflect, xmap, gmap, p, B, H, W, C, Cout, K,
                             pad, geo, s);
  if (err != 0) return err;
  return sum_parts(reflect, part, dw, (size_t)K * K * C * Cout, splits, s);
}

}  // namespace

// K5: bf16 on the tap-ring design (see launch_ring); f32 and the bf16
// shapes outside its domain on the CUDA cores (conv_dw_simt_bf16). The
// wrapper picks.
extern "C" int conv_dw_bf16(const void* x, const void* g, void* part,
                            void* dw, int B, int H, int C, int W, int Cout,
                            int K, int pad, int splits, void* stream) {
  return launch_ring(false, x, g, part, dw, B, H, C, W, Cout, K, pad, splits,
                     stream);
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

// K9-dW: bf16 on the tap-ring design, the reflect pad an index map of its
// loads; f32 and bf16 outside the domain on the CUDA cores through the same
// map, no copy.
extern "C" int conv_reflect_dw_bf16(const void* x, const void* g, void* part,
                                    void* dw, int B, int H, int C, int W,
                                    int Cout, int K, int splits,
                                    void* stream) {
  return launch_ring(true, x, g, part, dw, B, H, C, W, Cout, K, K / 2,
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
