// The per-frontier-node GBDT histogram body shared by node_hist.cu (f32
// stats rounded to bf16, f32 sums) and node_hist_int8.cu (int8 stats,
// exact int32 sums). Both compute
//
//   out[f, w*3 + s, b] = sum_r [pos_r == w] * stat(base[s, r]) * [binned[f, r] == b]
//
// over binned [F, n] (int32, int16 or uint8), pos [n] int32 in [-1, W)
// (rows with pos < 0 contribute nothing) and base [3, n], into out
// [F, 3W, B], zero-filled by the caller (the kernel adds into it). Bins
// outside [0, B) are skipped, so a bad id never writes outside a histogram.
//
// Bound: memory. A pass must read F*n*sizeof(bin) bytes of bins, 4n of pos
// and 3n*sizeof(stat) of stats; it does 3 adds per (row, feature). At 1M
// rows x 28 int32 features that is 128 MB (f32 stats), about 38 us at
// 3.35 TB/s. The design reads every input byte about once:
//
// 1. Feature groups. The grid is (row block, feature group x node tile).
//    A block owns `group` features x `node_tile` frontier nodes, one
//    [group, node_tile, 3, B] histogram in dynamic shared memory (up to
//    227 KB). It loads a row's pos and its three stats once, into
//    registers, then loops over its features' bins: pos and the stats are
//    read once per feature group, not once per feature.
// 2. 16-byte loads. A thread takes V = min(16/sizeof(bin), 8) consecutive
//    rows at a time: one 16-byte load of each feature's int32 or int16 bins
//    (8 bytes of uint8 bins: 16 rows spilled kernel 1's registers and left
//    threads idle at the root pass), 4V bytes of pos and of each f32 stat
//    channel (V bytes of each int8 channel). An array row
//    (a feature's bins, a stat channel) starts at f*n elements, so it is
//    aligned only when n is a multiple of V; a misaligned row takes the
//    same V rows with scalar loads, and the n % V rows past the last whole
//    vector are taken one per thread by the last row block.
//    Row blocks stride over the rows in sweeps of one vector per thread,
//    so rows at pos -1 (a half pass's buffer past its selected rows) cost
//    every block alike.
// 3. Cluster-reduced flush. Blocks are launched in clusters of `cluster`
//    (<= 8) consecutive row blocks of the same feature group and node
//    tile. After the scatter, each block sums a 1/cluster slice of the
//    cells across the cluster's histograms through distributed shared
//    memory, in rank order, and adds each non-zero sum into the output
//    with one global atomicAdd: an output cell takes one global atomic
//    per cluster, not one per block.
//
// What bounds it on an H100 is the scatter's shared-memory atomics, three
// per (row, feature), not memory: the pass takes the same time with every
// load scalar, and the f32 kernel, whose shared atomicAdd is a
// compare-and-swap loop (ATOMS.CAST.SPIN), takes about twice the int8
// kernel's native ATOMS.ADD. Pairing grad and hess in one 64-bit cell (one
// atomic instead of two) made both slower: a 64-bit CAS (ATOMS.CAS.64) and
// a 64-bit integer add (ATOMS.CAST.SPIN.64) are both loops.
//
// Geometry (group, node_tile, cluster, row_blocks, threads) is chosen by
// the caller (ops/histogram.py:_node_geometry, which sizes the grid to one
// wave of the clusters the card holds, max_clusters below) and checked
// here: anything this body cannot run returns cudaErrorInvalidValue, and a
// launch the card refuses returns its error. Nothing retries with another
// geometry.
#pragma once

#include <cooperative_groups.h>
#include <string.h>

#include "hist_common.cuh"

namespace mm_node {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;   // the most threads a block may have
constexpr int kMinBlocks = 2;   // blocks per SM the register budget allows
constexpr int kMaxCluster = 8;  // the portable cluster size

// Rows a thread takes at a time: one 16-byte load of int32 or int16 bins,
// 8 bytes of uint8 bins.
template <typename BinT>
constexpr int kVec = sizeof(BinT) == 1 ? 8 : 16 / (int)sizeof(BinT);

// V consecutive elements from p: 16-byte vector loads when p is aligned to
// min(16, V*sizeof(T)) bytes, else V scalar loads.
template <typename T, int V>
__device__ __forceinline__ void load_rows(const T* __restrict__ p, bool aligned,
                                          T (&out)[V]) {
  constexpr int kBytes = (int)sizeof(T) * V;
  if (aligned) {
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int c = 0; c < kBytes / 16; ++c) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(p) + c);
        memcpy(reinterpret_cast<char*>(out) + 16 * c, &w, 16);
      }
    } else if constexpr (kBytes == 8) {
      const int2 w = __ldg(reinterpret_cast<const int2*>(p));
      memcpy(out, &w, 8);
    } else {
      static_assert(kBytes == 4, "a row vector is 4, 8 or a multiple of 16 bytes");
      const int w = __ldg(reinterpret_cast<const int*>(p));
      memcpy(out, &w, 4);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = __ldg(p + i);
  }
}

template <typename T, int V>
__device__ __forceinline__ bool vec_aligned(const T* p) {
  constexpr int kBytes = (int)sizeof(T) * V;
  constexpr int kAlign = kBytes < 16 ? kBytes : 16;
  return (reinterpret_cast<uintptr_t>(p) % kAlign) == 0;
}

// f32 stats, rounded to bf16 in registers (the rounding every engine of
// the JAX package applies) and summed in f32. V rounded stats of a channel
// are kept as V/2 words of two bf16 each; widening one back is a shift.
template <int V>
struct Bf16Stats {
  using Stat = float;
  using Acc = float;
  static constexpr int kWords = V / 2;

  __device__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static void load(const float* __restrict__ p, bool aligned,
                              uint32_t (&w)[kWords]) {
    float s[V];
    load_rows<float, V>(p, aligned, s);
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = bits(s[2 * i]) | (bits(s[2 * i + 1]) << 16);
  }
  __device__ static float get(const uint32_t (&w)[kWords], int i) {
    const uint32_t x = w[i / 2];
    return __uint_as_float((i & 1) ? (x & 0xFFFF0000u) : (x << 16));
  }
  __device__ static float scalar(const float* __restrict__ p) {
    return mm_hist::round_bf16(__ldg(p));
  }
};

// int8 stats (the quantized grad*mask, hess*mask and mask), summed exactly
// in int32. V stats of a channel are kept as V/4 packed words.
template <int V>
struct Int8Stats {
  using Stat = int8_t;
  using Acc = int;
  static constexpr int kWords = V / 4;

  __device__ static void load(const int8_t* __restrict__ p, bool aligned,
                              uint32_t (&w)[kWords]) {
    int8_t s[V];
    load_rows<int8_t, V>(p, aligned, s);
    memcpy(w, s, V);
  }
  __device__ static int get(const uint32_t (&w)[kWords], int i) {
    return (int)(w[i / 4] << (24 - 8 * (i % 4))) >> 24;  // sign-extended byte
  }
  __device__ static int scalar(const int8_t* __restrict__ p) { return (int)__ldg(p); }
};

// One row's three stats into its cell of a feature's histogram h
// ([node_tile, 3, B]); `off` is the row's node offset in h, or -1.
template <typename Acc>
__device__ __forceinline__ void add_row(Acc* h, int off, int b, int B, Acc g, Acc hs,
                                        Acc c) {
  if (off < 0 || (unsigned)b >= (unsigned)B) return;
  Acc* cell = h + off + b;
  if (g != Acc(0)) atomicAdd(cell, g);
  if (hs != Acc(0)) atomicAdd(cell + B, hs);
  if (c != Acc(0)) atomicAdd(cell + 2 * B, c);
}

template <typename BinT, template <int> class StatsT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
node_hist_kernel(const BinT* __restrict__ binned, const int32_t* __restrict__ pos,
                 const typename StatsT<kVec<BinT>>::Stat* __restrict__ base,
                 typename StatsT<kVec<BinT>>::Acc* __restrict__ out, long long n,
                 int F, int W, int B, int group, int node_tile, int tiles) {
  constexpr int V = kVec<BinT>;
  using Stats = StatsT<V>;
  using Stat = typename Stats::Stat;
  using Acc = typename Stats::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);  // [g_n, wt, 3, B]
  cg::cluster_group cluster = cg::this_cluster();

  const int f0 = (blockIdx.y / tiles) * group;
  const int w0 = (blockIdx.y % tiles) * node_tile;
  const int g_n = min(group, F - f0);
  const int wt = min(node_tile, W - w0);
  const int node_cells = 3 * B;
  const int feat_cells = wt * node_cells;
  const int cells = g_n * feat_cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = Acc(0);
  __syncthreads();

  // whole row vectors in sweeps of blockDim.x, sweep k to row block
  // k % gridDim.x: a half pass's selected rows sit at the front of its
  // buffer, so contiguous row ranges would leave most blocks idle. The
  // n % V rows after the last whole vector belong to the last row block.
  const long long nv = n / V;
  const bool pos_al = vec_aligned<int32_t, V>(pos);
  bool stat_al[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) stat_al[k] = vec_aligned<Stat, V>(base + k * n);

  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nv;
       v += (long long)gridDim.x * blockDim.x) {
    const long long r = v * V;
    int p[V];
    load_rows<int32_t, V>(pos + r, pos_al, p);
    int off[V];
    bool any = false;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int q = p[i] - w0;
      off[i] = (unsigned)q < (unsigned)wt ? q * node_cells : -1;
      any |= off[i] >= 0;
    }
    if (!any) continue;  // no row of this vector is in the node tile
    uint32_t s[3][Stats::kWords];
#pragma unroll
    for (int k = 0; k < 3; ++k) Stats::load(base + k * n + r, stat_al[k], s[k]);
#pragma unroll 4
    for (int g = 0; g < g_n; ++g) {
      const BinT* col = binned + (long long)(f0 + g) * n;
      BinT b[V];
      load_rows<BinT, V>(col + r, vec_aligned<BinT, V>(col), b);
      Acc* h = hist + g * feat_cells;
#pragma unroll
      for (int i = 0; i < V; ++i)
        add_row<Acc>(h, off[i], (int)b[i], B, Stats::get(s[0], i), Stats::get(s[1], i),
                     Stats::get(s[2], i));
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    const long long r = nv * V + threadIdx.x;
    if (r < n) {
      const int q = pos[r] - w0;
      const int off = (unsigned)q < (unsigned)wt ? q * node_cells : -1;
      if (off >= 0) {
        const Acc g0 = Stats::scalar(base + r);
        const Acc g1 = Stats::scalar(base + n + r);
        const Acc g2 = Stats::scalar(base + 2 * n + r);
        for (int g = 0; g < g_n; ++g)
          add_row<Acc>(hist + g * feat_cells, off, (int)binned[(long long)(f0 + g) * n + r],
                       B, g0, g1, g2);
      }
    }
  }

  // every block of the cluster has finished its scatter (and its shared
  // memory is visible cluster-wide) before any block reads a peer's
  cluster.sync();
  const int C = (int)cluster.num_blocks();
  const int per = (cells + C - 1) / C;
  const int lo = (int)cluster.block_rank() * per;
  const int hi = min(cells, lo + per);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    Acc v = Acc(0);
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < C) v += *cluster.map_shared_rank(hist + i, k);
    if (v != Acc(0)) {
      // out[f0+g, w0*3 : (w0+wt)*3, :] is one contiguous run per feature
      const int g = i / feat_cells;
      atomicAdd(out + ((long long)(f0 + g) * 3 * W + (long long)w0 * 3) * B +
                    (i - g * feat_cells),
                v);
    }
  }
  // no block may exit (and free its shared memory) while a peer reads it
  cluster.sync();
}

// The dynamic shared memory of a geometry, or -1 if this body cannot run
// it. groups*tiles is the grid's y extent.
template <typename Acc>
long long checked_smem(long long n, int F, int W, int B, int group, int node_tile, int cluster,
                       int row_blocks, int threads) {
  if (n < 0 || F <= 0 || W <= 0 || B <= 0) return -1;
  if (group < 1 || group > F || node_tile < 1 || node_tile > W) return -1;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0) return -1;
  if (row_blocks < cluster || row_blocks % cluster != 0) return -1;
  if (threads < 32 || threads > kThreads || threads % 32 != 0) return -1;
  const long long groups = (F + group - 1) / group, tiles = (W + node_tile - 1) / node_tile;
  if (groups * tiles > 65535) return -1;
  const long long smem = (long long)group * node_tile * 3 * B * (long long)sizeof(Acc);
  return smem > mm_hist::kSmemMax ? -1 : smem;
}

template <typename Kernel>
cudaLaunchConfig_t cluster_config(Kernel, dim3 grid, int threads, int smem, int cluster,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename BinT, template <int> class StatsT>
cudaError_t launch(const void* binned, const void* pos, const void* base, void* out,
                   long long n, int F, int W, int B, int group, int node_tile, int cluster,
                   int row_blocks, int threads, cudaStream_t stream) {
  using Stats = StatsT<kVec<BinT>>;
  using Acc = typename Stats::Acc;
  const long long smem =
      checked_smem<Acc>(n, F, W, B, group, node_tile, cluster, row_blocks, threads);
  if (smem < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto kernel = node_hist_kernel<BinT, StatsT>;
  cudaError_t err = mm_hist::allow_smem(kernel, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (W + node_tile - 1) / node_tile;
  const int groups = (F + group - 1) / group;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(kernel, dim3((unsigned)row_blocks, (unsigned)(groups * tiles), 1),
                                          threads, (int)smem, cluster, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const BinT*>(binned),
                           static_cast<const int32_t*>(pos),
                           static_cast<const typename Stats::Stat*>(base),
                           static_cast<Acc*>(out), n, F, W, B, group, node_tile, tiles);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

// How many clusters of `cluster` blocks with `smem` bytes of shared memory
// the card holds at once (cudaOccupancyMaxActiveClusters): the caller
// sizes the grid to one wave of them.
template <typename BinT, template <int> class StatsT>
cudaError_t max_clusters(int smem, int cluster, int threads, int* result) {
  if (smem <= 0 || smem > mm_hist::kSmemMax || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || threads < 32 || threads > kThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  auto kernel = node_hist_kernel<BinT, StatsT>;
  cudaError_t err = mm_hist::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(kernel, dim3((unsigned)cluster, 1, 1), threads, smem, cluster, 0, &attr);
  return cudaOccupancyMaxActiveClusters(result, kernel, &cfg);
}

// bin_bytes: 4 = int32, 2 = int16, 1 = uint8.
template <template <int> class StatsT>
cudaError_t dispatch(const void* binned, int bin_bytes, const void* pos, const void* base,
                     void* out, long long n, int F, int W, int B, int group, int node_tile,
                     int cluster, int row_blocks, int threads, cudaStream_t s) {
  switch (bin_bytes) {
    case 4:
      return launch<int32_t, StatsT>(binned, pos, base, out, n, F, W, B, group, node_tile,
                                     cluster, row_blocks, threads, s);
    case 2:
      return launch<int16_t, StatsT>(binned, pos, base, out, n, F, W, B, group, node_tile,
                                     cluster, row_blocks, threads, s);
    case 1:
      return launch<uint8_t, StatsT>(binned, pos, base, out, n, F, W, B, group, node_tile,
                                     cluster, row_blocks, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <template <int> class StatsT>
cudaError_t dispatch_max_clusters(int bin_bytes, int smem, int cluster, int threads, int* result) {
  switch (bin_bytes) {
    case 4:
      return max_clusters<int32_t, StatsT>(smem, cluster, threads, result);
    case 2:
      return max_clusters<int16_t, StatsT>(smem, cluster, threads, result);
    case 1:
      return max_clusters<uint8_t, StatsT>(smem, cluster, threads, result);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mm_node
