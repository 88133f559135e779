// What K2 (norm_act.cu) and K6 (norm_act_bwd.cu) share: the geometry rule,
// the walk of a thread over its share of a plane, the plane sums over a CTA
// and a thread-block cluster, and the launch. K13 (instance_norm_nhwc.cu)
// takes the 16-byte slots and the cluster barrier and DSMEM read from here.
//
// x [B, H, C, W] NHCW: a (sample, channel) plane is H rows of W contiguous
// elements at row stride C*W. A slot is 16 bytes of a row (8 bf16 or 4 f32,
// `vec`), or one element where W is ragged (W % vec != 0) or a pointer is
// not 16-byte aligned. A tile is `channels` planes of one sample (THREADS /
// channels threads each, at least a warp) for one CTA, or one plane split
// over a cluster of `cluster` CTAs, `rows` rows each. A thread walks its
// slots of a tile in two dimensions, (row, slot), stepping by THREADS /
// channels slots with a carry: no integer division per element or slot.
//
// Each operand crosses device memory once: a thread loads its slots of the
// tile (SLOTS of each operand: x in K2, x and gz in K6) into registers, all
// loads in flight before the first use, and the statistics pass, the f32
// second pass and the output pass read that copy. That is `resident`:
// every bf16 launch of the recipes. Tiles whose share exceeds that (planes
// past the cluster's budget: 512x512 bf16; f32 256x256) and one-element
// slots read device memory again for each pass instead.
//
// Clusters cost time (on an H100 the launches of a train step with the
// cluster exchange left out, results wrong, ran about a sixth faster), so
// a cluster is used only where a plane exceeds one CTA's registers.
//
// Sums are f32 in a fixed order: a thread's slots in order, a warp's
// butterfly, the plane's warps in order, then the cluster's ranks in order,
// each CTA reading every rank's partials from distributed shared memory. So
// every CTA of a cluster gets the same totals, bit for bit, run after run.
#pragma once

#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace na {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 4;          // slots of each operand a thread keeps
constexpr int MAX_CLUSTER = 8;    // portable cluster size

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float y, float alpha) {
  if constexpr (ACT == ACT_RELU) return fmaxf(y, 0.f);
  if constexpr (ACT == ACT_LEAKY) return y >= 0.f ? y : y * alpha;
  return y;
}

// f(std::integral_constant<int, act>{}): the activation as a template
// argument, so that no element tests it
template <class F>
int with_act(int act, F&& f) {
  switch (act) {
    case ACT_NONE:
      return f(std::integral_constant<int, ACT_NONE>{});
    case ACT_RELU:
      return f(std::integral_constant<int, ACT_RELU>{});
    case ACT_LEAKY:
      return f(std::integral_constant<int, ACT_LEAKY>{});
  }
  return (int)cudaErrorInvalidValue;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The geometry rule; cuda_norm_act.norm_act_geometry is the same rule in
// Python, and the entry points refuse a launch whose geometry differs.
// `operands`: the tensors a thread keeps (1 for K2, 2 for K6).
struct Geometry {
  int vec, channels, cluster, rows, slots, resident;
};

inline Geometry geometry(int b, int h, int c, int w, int esize, int operands,
                         bool aligned) {
  Geometry g;
  const int v16 = 16 / esize;
  g.vec = aligned && w % v16 == 0 ? v16 : 1;
  const long long q = w / g.vec;                    // slots per row
  const long long nv = SLOTS;        // slots of each operand kept per thread
  const long long cap = THREADS * nv;  // per CTA
  const long long plane = (long long)h * q;
  g.channels = 1;
  g.cluster = 1;
  if (plane <= cap) {  // planes share a CTA, a warp or more each
    while (2 * g.channels <= WARPS && c % (2 * g.channels) == 0 &&
           2 * g.channels * plane <= cap)
      g.channels *= 2;
  } else {  // rows split over a cluster until a CTA's share fits
    while (g.cluster < MAX_CLUSTER && 2 * g.cluster <= h &&
           ceil_div(h, g.cluster) * q > cap)
      g.cluster *= 2;
  }
  g.rows = (int)ceil_div(h, g.cluster);
  g.slots = (int)ceil_div((long long)g.rows * q, THREADS / g.channels);
  g.resident = g.slots <= nv && g.vec == v16;
  return g;
}

inline bool same(const Geometry& a, int vec, int channels, int cluster,
                 int rows, int slots, int resident) {
  return a.vec == vec && a.channels == channels && a.cluster == cluster &&
         a.rows == rows && a.slots == slots && a.resident == resident;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- slots ----

template <typename T, int V>
struct Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  Pack<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = p[e];
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& r) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    memcpy(&u, &r, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = r.v[e];
  }
}

// Where a thread's slots lie. Thread tl of a plane's tpc = THREADS /
// channels takes slots tl, tl + tpc, ... of its CTA's rows x q, row-major.
struct Place {
  int b, c, cl;      // sample, channel, plane within the tile
  size_t base, rs;   // offset of (b, row 0, c, 0); row stride C*W
  int row0, col0;    // first slot: absolute row, slot within the row
  int dr, dc, q;     // step per slot: rows, slots (carried at q)
  int n;             // slots of this thread
  bool lead;         // writes the plane's statistics
};

__device__ __forceinline__ Place place(int H, int C, int W, int V,
                                       int channels, int cluster, int rows) {
  Place p;
  const int tpc = THREADS / channels;
  const int rank = blockIdx.x % cluster;  // %cluster_ctarank: 1-D clusters
  const int tile = blockIdx.x / cluster;
  const int groups = C / channels;
  p.b = tile / groups;
  p.cl = threadIdx.x / tpc;
  p.c = (tile - p.b * groups) * channels + p.cl;
  const int tl = threadIdx.x - p.cl * tpc;
  p.q = W / V;
  const int h0 = rank * rows;
  const int here = max(0, min(H, h0 + rows) - h0);
  p.row0 = h0 + tl / p.q;
  p.col0 = tl % p.q;
  p.dr = tpc / p.q;
  p.dc = tpc % p.q;
  const int total = here * p.q;
  p.n = total > tl ? (total - tl + tpc - 1) / tpc : 0;
  p.rs = (size_t)C * W;
  p.base = ((size_t)p.b * H * C + p.c) * W;
  p.lead = rank == 0 && tl == 0;
  return p;
}

// f(s, offset) for each slot s of the thread, in order. Resident: unrolled
// over the NV slots a thread keeps, so that f can index a register array.
template <int NV, bool RES, int V, class F>
__device__ __forceinline__ void walk(const Place& p, F&& f) {
  int row = p.row0, col = p.col0;
  if constexpr (RES) {
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      if (s < p.n) f(s, p.base + (size_t)row * p.rs + (size_t)col * V);
      row += p.dr;
      col += p.dc;
      if (col >= p.q) {
        col -= p.q;
        ++row;
      }
    }
  } else {
#pragma unroll 4
    for (int s = 0; s < p.n; ++s) {
      f(s, p.base + (size_t)row * p.rs + (size_t)col * V);
      row += p.dr;
      col += p.dc;
      if (col >= p.q) {
        col -= p.q;
        ++row;
      }
    }
  }
}

// ---- clusters ----

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// *p in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float load_rank(const float* p, int rank) {
  uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// ---- plane sums ----

struct Red {
  float warp[WARPS][2];
  float part[2][2][WARPS];  // [round][quantity][plane]: read by other ranks
  float tot[2];
};

// Replaces s[0..NQ) by their sums over the thread's plane: the CTA's
// threads of the plane, then every rank of the cluster in rank order.
// `round` picks a partials buffer no rank can still be reading (the f32
// forward's second round); a cluster waits at the end of the kernel until
// every rank has read them.
template <int NQ>
__device__ __forceinline__ void plane_sums(float (&s)[NQ], Red& r, int round,
                                           int channels, int cluster,
                                           int cl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) r.warp[warp][i] = s[i];
  }
  __syncthreads();
  if (threadIdx.x < channels) {
    const int wpp = WARPS / channels;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      float a = 0.f;
      for (int w = 0; w < wpp; ++w) a += r.warp[threadIdx.x * wpp + w][i];
      r.part[round][i][threadIdx.x] = a;
    }
  }
  if (cluster > 1) {  // one plane per CTA
    cluster_arrive();
    cluster_wait();
    if (threadIdx.x < NQ) {  // all loads in flight, then the sum in order
      float v[MAX_CLUSTER];
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k)
        v[k] = k < cluster ? load_rank(&r.part[round][threadIdx.x][0], k)
                           : 0.f;
      float a = v[0];
#pragma unroll
      for (int k = 1; k < MAX_CLUSTER; ++k) a += v[k];
      r.tot[threadIdx.x] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NQ; ++i)
    s[i] = cluster > 1 ? r.tot[i] : r.part[round][i][cl];
}

// ---- launch ----

// One launch of `kernel`: a CTA per tile, B * (C / channels) tiles, in
// clusters of g.cluster CTAs. A cluster the card cannot co-schedule is
// refused (asked of the occupancy API once per kernel and cluster size),
// never launched to hang.
template <typename... Params, typename... Args>
int launch(const Geometry& g, int B, int C, void* stream,
           void (*kernel)(Params...), Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)B * (C / g.channels) * g.cluster));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.cluster > 1 ? 1 : 0;
  if (g.cluster > 1) {
    static int schedulable[MAX_CLUSTER + 1] = {};  // 0 unknown, 1, -1
    int& known = schedulable[g.cluster];
    if (known == 0) {
      int n = 0;
      const cudaError_t err =
          cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      known = n > 0 ? 1 : -1;
    }
    if (known < 0) return (int)cudaErrorLaunchOutOfResources;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace na
