// K13 instance_norm_nhwc: instance norm over the spatial positions of NHWC
// activations, with the statistics the backward reads.
//
// Replaces cyclegan_tpu/ops/pallas_norm.py `_forward_call`, the two-phase
// kernel of the NHWC layout (`pallas_norm: true`). Its sequential grid
// (sample, 2 phases, HW chunks) carried the sums in VMEM scratch from one
// phase to the next.
//
// x [N, HW, C] (C innermost); gamma, beta [C] in x's type, both or neither;
// y like x; mean, rstd [N, C] f32. Per (sample, channel), as the Pallas
// kernel: f32 sums of x and x^2, mean = sum / HW, var = max(sumsq / HW -
// mean^2, 0), rstd = rsqrt(var + eps), y = (x - mean) * rstd [* gamma +
// beta], stored in x's type.
//
// Bound on the H100: bytes (about 7 operations per element).
//
// Resident: one launch, x read from device memory once. A slot is 16
// bytes of a row (8 bf16 or 4 f32 channels). A tile is `tile` neighbouring
// channel vectors (a power of two dividing C / 16 bytes, at most MAX_TILE:
// 64 contiguous bytes of a row) of one sample over its HW rows, split by
// rows over a cluster of `cluster` CTAs (up to 16, a non-portable size),
// `rows` each: thread t takes vector t % tile and rows t / tile,
// t / tile + THREADS / tile, ... of its CTA's rows, `slots` at most, so a
// warp reads whole row segments and no thread divides per row. Each thread
// copies its slots into shared memory with cp.async, all in flight, in two
// groups: the first half's sums run while the second half lands. The sums
// and the normalize pass read that copy. Sums are f32 in a fixed order: a
// thread's slots in order, a butterfly over the warp's lanes of one
// vector, the warps in order, then the cluster's ranks in order, each CTA
// reading every rank's partials from distributed shared memory
// (norm_act.cuh). No float atomics: runs repeat bit for bit. The
// statistics are worked out once per channel and shared through shared
// memory. The cluster grows until a CTA holds about TARGET_BYTES of x, so
// that small layers still spread over many SMs; the tile is the widest
// whose CTAs then hold at most SMEM_MAX. Every launch of the recipes is
// resident. Shared memory, not registers, holds the copy: on an H100 a
// thread's registers held too little for a tile of more than one vector
// at 64x64 and past, and one-vector tiles (16 bytes a row) ran far slower
// than a `copy_` of their bytes.
//
// Streamed (tiles past that budget, a 512x512 column; one-element slots,
// where C is not whole vectors or a pointer is not 16-byte aligned): the
// two-launch design. Launch 1 sums x and x^2 of each of `splits` row
// ranges into ws, launch 2 adds the splits in order and normalizes, so x
// is read twice (the second time mostly from the 50 MB L2). On an H100 it
// ran faster past the budget than one clustered launch that reads x twice.
//
// `geometry` below is the rule; ops/cuda_norm.py
// `instance_norm_nhwc_geometry` is the same rule in Python, and the entry
// points refuse a launch whose geometry differs.
#include <algorithm>

#include "norm_act.cuh"

namespace {

using na::Pack;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TILE = 4;      // channel vectors of a resident tile
constexpr int MAX_CLUSTER = 16;  // non-portable: opted in at launch
constexpr long long TARGET_BYTES = 32 << 10;  // of x a CTA, where it can
constexpr long long SMEM_MAX = 160 << 10;     // the resident copy, a CTA
constexpr int TARGET_BLOCKS = 4 * 132;  // streamed: a few waves of 132 SMs

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// ---- the geometry rule (ops/cuda_norm.py instance_norm_nhwc_geometry) ----

struct Geometry {
  int vec, tile, cluster, slots, splits;  // splits 0: resident
};

Geometry geometry(int n, int hw, int c, int esize, bool aligned) {
  Geometry g;
  const int v16 = 16 / esize;
  g.vec = aligned && c % v16 == 0 ? v16 : 1;
  const int cv = c / g.vec;
  g.splits = 1;
  if (g.vec == v16) {  // the widest tile whose CTAs' copies fit
    int t = 1;
    while (2 * t <= MAX_TILE && cv % (2 * t) == 0) t *= 2;
    for (; t >= 1 && g.splits; t /= 2) {
      int cl = 1;
      while (cl < MAX_CLUSTER && cl < hw &&
             ceil_div((long long)t * hw * 16, cl) > TARGET_BYTES)
        cl *= 2;
      const long long slots = ceil_div(ceil_div(hw, cl), THREADS / t);
      if (slots * THREADS * 16 <= SMEM_MAX) {
        g.tile = t;
        g.cluster = cl;
        g.slots = (int)slots;
        g.splits = 0;
      }
    }
  }
  if (g.splits) {  // streamed: row splits filling about TARGET_BLOCKS CTAs
    g.tile = std::min(cv, 32);
    g.cluster = 1;
    g.slots = 0;
    const long long lanes = THREADS / g.tile;
    long long s = ceil_div(TARGET_BLOCKS, (long long)n * ceil_div(cv, g.tile));
    s = std::min(s, std::min(hw / (4 * lanes), 65535LL));
    g.splits = (int)std::max(s, 1LL);
  }
  return g;
}

bool same(const Geometry& a, int vec, int tile, int cluster, int slots,
          int splits) {
  return a.vec == vec && a.tile == tile && a.cluster == cluster &&
         a.slots == slots && a.splits == splits;
}

// ---- resident: one launch ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies but the last N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this rank has read the others' partials (values already in registers):
// no ordering to release
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_shared(const unsigned char* p) {
  Pack<T, V> r;
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  memcpy(&r, &u, 16);
  return r;
}

struct Red {
  float warp[WARPS][2][MAX_TILE * 8];  // per warp: sums of each channel
  float part[2][MAX_TILE * 8];         // the CTA's: read by other ranks
  float tot[2][MAX_TILE * 8];          // the cluster's
  float stat[4][MAX_TILE * 8];         // mean, rstd, gamma, beta
};

// grid: (sample, tile) clusters of `cluster` CTAs, tile = 1 << tile_log2;
// `slots` x THREADS 16-byte slots of dynamic shared memory, slot k of
// thread t at (k THREADS + t) 16 bytes; V = 16 / sizeof(T)
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
instance_norm_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                          const T* __restrict__ beta, T* __restrict__ y,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int HW, int C,
                          int tile_log2, int cluster, int rows, int slots,
                          float eps) {
  extern __shared__ __align__(16) unsigned char copy[];
  __shared__ Red red;
  const int tile = 1 << tile_log2;
  const int tv = threadIdx.x & (tile - 1);
  const int lanes = THREADS >> tile_log2;
  const int rank = blockIdx.x & (cluster - 1);  // %cluster_ctarank
  const int t = blockIdx.x / cluster;
  const int tiles = (C / V) >> tile_log2;  // per sample
  const int n = t / tiles;
  const int c0 = (((t - n * tiles) << tile_log2) + tv) * V;
  const int r0 = rank * rows + (threadIdx.x >> tile_log2);
  const int r1 = min(HW, (rank + 1) * rows);
  // this thread's slots: rows r0, r0 + lanes, ... below r1
  const int mine = r0 < r1 ? min(slots, (r1 - r0 + lanes - 1) / lanes) : 0;
  const T* xs = x + (size_t)n * HW * C + c0 + (size_t)r0 * C;
  T* ys = y + (size_t)n * HW * C + c0 + (size_t)r0 * C;
  const size_t stride = (size_t)lanes * C;
  unsigned char* buf = copy + threadIdx.x * 16;
  constexpr int STEP = THREADS * 16;

  // every copy in flight before the first use, in two groups: the first
  // half's sums run while the second half lands. Only this thread reads
  // its copies, so waiting for its own groups is enough.
  const int half = (mine + 1) / 2;
  for (int k = 0; k < mine; ++k) {
    cp_async16(buf + k * STEP, xs + k * stride);
    if (k + 1 == half) cp_async_commit();
  }
  cp_async_commit();

  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
  auto add = [&](int k0, int k1) {  // slots in order
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const Pack<T, V> v = load_shared<T, V>(buf + k * STEP);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(v.v[e]);
        s1[e] += f;
        s2[e] += f * f;
      }
    }
  };
  cp_async_wait<1>();
  add(0, half);
  cp_async_wait<0>();
  add(half, mine);

  // the lanes of a warp that share a vector: a butterfly, equal bits in each
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (o < tile) break;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
      s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane < tile) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red.warp[warp][0][lane * V + e] = s1[e];
      red.warp[warp][1][lane * V + e] = s2[e];
    }
  }
  __syncthreads();
  const int width = tile * V;  // channels of the tile
  if (threadIdx.x < 2 * width) {  // warps in order
    const int q = threadIdx.x >= width, i = threadIdx.x - q * width;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += red.warp[w][q][i];
    red.part[q][i] = a;
  }
  if (cluster > 1) {
    na::cluster_arrive();
    na::cluster_wait();
    if (threadIdx.x < 2 * width) {  // all loads in flight, then ranks in order
      const int q = threadIdx.x >= width, i = threadIdx.x - q * width;
      float v[MAX_CLUSTER];
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k)
        v[k] = k < cluster ? na::load_rank(&red.part[q][i], k) : 0.f;
      float a = v[0];
#pragma unroll
      for (int k = 1; k < MAX_CLUSTER; ++k) a += v[k];
      red.tot[q][i] = a;
    }
  }
  __syncthreads();
  if (cluster > 1) cluster_arrive_relaxed();
  if (threadIdx.x < width) {  // the statistics, once per channel
    const int i = threadIdx.x, c = c0 - tv * V + i;
    const float count = (float)HW;
    const float a = cluster > 1 ? red.tot[0][i] : red.part[0][i];
    const float q = cluster > 1 ? red.tot[1][i] : red.part[1][i];
    const float mean = a / count;
    const float var = fmaxf(q / count - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    if (rank == 0) {
      mean_out[(size_t)n * C + c] = mean;
      rstd_out[(size_t)n * C + c] = rstd;
    }
    red.stat[0][i] = mean;
    red.stat[1][i] = rstd;
    red.stat[2][i] = gamma != nullptr ? to_f32(gamma[c]) : 1.f;
    red.stat[3][i] = beta != nullptr ? to_f32(beta[c]) : 0.f;
  }
  __syncthreads();
  float mean[V], rstd[V], g[V], b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mean[e] = red.stat[0][tv * V + e];
    rstd[e] = red.stat[1][tv * V + e];
    g[e] = red.stat[2][tv * V + e];
    b[e] = red.stat[3][tv * V + e];
  }
#pragma unroll 4
  for (int k = 0; k < mine; ++k) {
    const Pack<T, V> v = load_shared<T, V>(buf + k * STEP);
    Pack<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float f = (to_f32(v.v[e]) - mean[e]) * rstd[e];
      if (gamma != nullptr) f = f * g[e] + b[e];
      o.v[e] = from_f32<T>(f);
    }
    na::store<T, V>(ys + k * stride, o);
  }
  // keep this CTA's partials alive until every rank has read them
  if (cluster > 1) na::cluster_wait();
}

// ---- streamed: two launches ----


template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Rows [r0, r1) of split s: the same for both launches.
__device__ __forceinline__ void split_rows(int HW, int splits, int s, int& r0,
                                           int& r1) {
  r0 = (int)((long long)HW * s / splits);
  r1 = (int)((long long)HW * (s + 1) / splits);
}

// grid (channel tiles, splits, N); `tile` channel vectors per block, so
// THREADS / tile row lanes.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
partial_sums_kernel(const T* __restrict__ x, float* __restrict__ ws_sum,
                    float* __restrict__ ws_sq, int HW, int C, int splits,
                    int tile) {
  __shared__ float red[2][THREADS * V];
  const int n = blockIdx.z;
  const int s = blockIdx.y;
  const int rows = THREADS / tile;
  const int tv = threadIdx.x % tile;
  const int ty = threadIdx.x / tile;
  const int c0 = (blockIdx.x * tile + tv) * V;  // this thread's first channel
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  int r0, r1;
  split_rows(HW, splits, s, r0, r1);
  if (ty < rows && c0 < C) {
    const T* base = x + (size_t)n * HW * C + c0;
    for (int r = r0 + ty; r < r1; r += rows) {
      float v[V];
      load_v<T, V>(base + (size_t)r * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += v[i];
        s2[i] += v[i] * v[i];
      }
    }
  }
  if (ty < rows) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[0][(ty * tile + tv) * V + i] = s1[i];
      red[1][(ty * tile + tv) * V + i] = s2[i];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile * V; t += THREADS) {
    const int c = blockIdx.x * tile * V + t;
    if (c >= C) continue;
    float a = 0.f, q = 0.f;
    for (int k = 0; k < rows; ++k) {  // fixed order
      a += red[0][k * tile * V + t];
      q += red[1][k * tile * V + t];
    }
    const size_t slot = ((size_t)n * splits + s) * C + c;
    ws_sum[slot] = a;
    ws_sq[slot] = q;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
normalize_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                 const T* __restrict__ beta, T* __restrict__ y,
                 const float* __restrict__ ws_sum,
                 const float* __restrict__ ws_sq, float* __restrict__ mean_out,
                 float* __restrict__ rstd_out, int HW, int C, int splits,
                 int tile, float eps) {
  __shared__ float s_mean[32 * V], s_rstd[32 * V], s_g[32 * V], s_b[32 * V];
  const int n = blockIdx.z;
  const int s = blockIdx.y;
  const int rows = THREADS / tile;
  const int tv = threadIdx.x % tile;
  const int ty = threadIdx.x / tile;
  const bool affine = gamma != nullptr;
  const float count = (float)HW;
  for (int t = threadIdx.x; t < tile * V; t += THREADS) {
    const int c = blockIdx.x * tile * V + t;
    if (c >= C) continue;
    float a = 0.f, q = 0.f;
    for (int k = 0; k < splits; ++k) {  // fixed order: every block agrees
      a += ws_sum[((size_t)n * splits + k) * C + c];
      q += ws_sq[((size_t)n * splits + k) * C + c];
    }
    const float mean = a / count;
    const float var = fmaxf(q / count - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    if (s == 0) {
      mean_out[(size_t)n * C + c] = mean;
      rstd_out[(size_t)n * C + c] = rstd;
    }
    s_mean[t] = mean;
    s_rstd[t] = rstd;
    s_g[t] = affine ? to_f32(gamma[c]) : 1.f;
    s_b[t] = affine ? to_f32(beta[c]) : 0.f;
  }
  __syncthreads();
  const int c0 = (blockIdx.x * tile + tv) * V;
  if (ty >= rows || c0 >= C) return;
  float m[V], r[V], g[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = s_mean[tv * V + i];
    r[i] = s_rstd[tv * V + i];
    g[i] = s_g[tv * V + i];
    b[i] = s_b[tv * V + i];
  }
  int r0, r1;
  split_rows(HW, splits, s, r0, r1);
  const size_t base = (size_t)n * HW * C + c0;
  for (int row = r0 + ty; row < r1; row += rows) {
    float v[V];
    load_v<T, V>(x + base + (size_t)row * C, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = (v[i] - m[i]) * r[i];
      if (affine) v[i] = v[i] * g[i] + b[i];
    }
    store_v<T, V>(y + base + (size_t)row * C, v);
  }
}

template <typename T, int V>
int launch_split(const void* x, const void* gamma, const void* beta, void* y,
             void* mean, void* rstd, void* ws_sum, void* ws_sq, int N, int HW,
             int C, int splits, float eps, cudaStream_t stream) {
  const int cv = C / V;
  const int tile = cv < 32 ? cv : 32;
  const dim3 grid((cv + tile - 1) / tile, splits, N);
  partial_sums_kernel<T, V><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (float*)ws_sum, (float*)ws_sq, HW, C, splits, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  normalize_kernel<T, V><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const T*)gamma, (const T*)beta, (T*)y,
      (const float*)ws_sum, (const float*)ws_sq, (float*)mean, (float*)rstd,
      HW, C, splits, tile, eps);
  return (int)cudaGetLastError();
}


// ---- entry ----

constexpr int SIZES = 5;  // cluster sizes 1, 2, 4, 8, 16
constexpr int STEPS = (int)(SMEM_MAX / (THREADS * 16)) + 1;  // smem sizes
using Schedulable = signed char[SIZES][STEPS];  // 0 unknown, 1, -1

// What the kernel opts in to, once: the dynamic shared memory of the
// largest resident copy and clusters past 8 CTAs (a non-portable size)
template <typename K>
cudaError_t opt_in(K kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The resident launch: (sample, tile) clusters of g.cluster CTAs, each
// with its copy of x in dynamic shared memory. A cluster the card cannot
// co-schedule is refused (asked of the occupancy API once per cluster and
// smem size), never launched to hang.
template <typename T>
int launch_resident(const Geometry& g, const void* x, const void* gamma,
                    const void* beta, void* y, void* mean, void* rstd, int N,
                    int HW, int C, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto* kernel = instance_norm_nhwc_kernel<T, V>;
  static const cudaError_t opted = opt_in(kernel);
  if (opted != cudaSuccess) return (int)opted;
  static Schedulable known = {};
  int tile_log2 = 0;
  while ((1 << tile_log2) < g.tile) ++tile_log2;
  const int rows = (int)ceil_div(HW, g.cluster);
  const int smem = g.slots * THREADS * 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)N * (C / V / g.tile) * g.cluster));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.cluster > 1 ? 1 : 0;
  if (g.cluster > 1) {
    int log2 = 0;
    while ((1 << log2) < g.cluster) ++log2;
    signed char& k = known[log2][g.slots];
    if (k == 0) {
      int n = 0;
      const cudaError_t err =
          cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      k = n > 0 ? 1 : -1;
    }
    if (k < 0) return (int)cudaErrorLaunchOutOfResources;
  }
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)x, (const T*)gamma, (const T*)beta, (T*)y,
      (float*)mean, (float*)rstd, HW, C, tile_log2, g.cluster, rows, g.slots,
      eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// vec, tile, cluster, slots, splits: the wrapper's geometry, refused where
// it differs from this file's; ws_sum, ws_sq: [N, splits, C] f32 scratch
// of a streamed launch (splits > 0)
template <typename T>
int entry(const void* x, const void* gamma, const void* beta, void* y,
          void* mean, void* rstd, void* ws_sum, void* ws_sq, int N, int HW,
          int C, float eps, int vec, int tile, int cluster, int slots,
          int splits, void* stream) {
  if ((gamma == nullptr) != (beta == nullptr) || N < 1 || HW < 1 || C < 1 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(N, HW, C, (int)sizeof(T),
                              na::aligned16(x) && na::aligned16(y));
  if (!same(g, vec, tile, cluster, slots, splits))
    return (int)cudaErrorInvalidValue;  // the wrapper's rule has drifted
  const cudaStream_t st = (cudaStream_t)stream;
  if (!g.splits)
    return launch_resident<T>(g, x, gamma, beta, y, mean, rstd, N, HW, C, eps,
                              st);
  if (ws_sum == nullptr || ws_sq == nullptr) return (int)cudaErrorInvalidValue;
  if (g.vec > 1)
    return launch_split<T, 16 / sizeof(T)>(x, gamma, beta, y, mean, rstd,
                                           ws_sum, ws_sq, N, HW, C, g.splits,
                                           eps, st);
  return launch_split<T, 1>(x, gamma, beta, y, mean, rstd, ws_sum, ws_sq, N,
                            HW, C, g.splits, eps, st);
}

}  // namespace

extern "C" int instance_norm_nhwc_f32(const void* x, const void* gamma,
                                      const void* beta, void* y, void* mean,
                                      void* rstd, void* ws_sum, void* ws_sq,
                                      int N, int HW, int C, float eps,
                                      int vec, int tile, int cluster,
                                      int slots, int splits, void* stream) {
  return entry<float>(x, gamma, beta, y, mean, rstd, ws_sum, ws_sq, N, HW, C,
                      eps, vec, tile, cluster, slots, splits, stream);
}

extern "C" int instance_norm_nhwc_bf16(const void* x, const void* gamma,
                                       const void* beta, void* y, void* mean,
                                       void* rstd, void* ws_sum, void* ws_sq,
                                       int N, int HW, int C, float eps,
                                       int vec, int tile, int cluster,
                                       int slots, int splits, void* stream) {
  return entry<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, ws_sum, ws_sq,
                              N, HW, C, eps, vec, tile, cluster, slots,
                              splits, stream);
}
