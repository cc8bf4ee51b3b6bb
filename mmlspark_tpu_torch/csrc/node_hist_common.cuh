// The GBDT histogram body shared by the port's three kernels, in two modes.
//
// Node mode (kernels 1 and 2: node_hist.cu, f32 stats rounded to bf16 with
// f32 sums; node_hist_int8.cu, int8 stats with exact int32 sums):
//
//   out[f, w*3 + s, b] = sum_r [pos_r == w] * stat(base[s, r]) * [binned[f, r] == b]
//
// over pos [n] int32 in [-1, W) (rows with pos < 0 contribute nothing) and
// base [3, n], into out [F, 3W, B].
//
// Channel mode (kernel 3: hist_bf16.cu, f32 stats rounded to bf16 or taken
// as they are, f32 sums):
//
//   out[f, s, b] = sum_r stat(stats[s, r]) * [binned[f, r] == b]
//
// over stats [S, n], into out [F, S, B]. Every row counts; no pos is read.
//
// In both, binned is [F, n] (int32, int16 or uint8), out is zero-filled by
// the caller (the kernel adds into it), zero stats are not added, and bins
// outside [0, B) are skipped, so a bad id never writes outside a histogram.
//
// Bound: memory. A pass must read F*n*sizeof(bin) bytes of bins, 4n of pos
// (node mode) and (3 or S)*n*sizeof(stat) of stats; it does one add per
// (row, feature, stat). At 1M rows x 28 int32 features that is 128 MB in
// node mode (f32 stats), about 38 us at 3.35 TB/s, and 120 MB for S=2 in
// channel mode, about 36 us. The design reads every input byte about once:
//
// 1. Feature groups. A block owns `group` features x a tile of `tile`
//    frontier nodes (node mode, [group, tile, 3, B] cells) or one stat
//    channel (channel mode, [group, B] cells, each kept `reps` times), in
//    dynamic shared memory (up to 227 KB). It loads a row's pos and stats
//    once, into registers, then loops over its features' bins: pos and the
//    stats are read once per feature group, not once per feature. Channel
//    mode tiles S one channel to a block, as node mode tiles the frontier
//    (on an H100, tiles of 2 and 3 channels lost to one at S=2 and S=3).
//    The grid is one-dimensional, row blocks fastest: block x is row block
//    x % row_blocks of (feature group, tile) item x / row_blocks, so a
//    grid may hold up to 2^31-1 blocks, whatever F, W and S.
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
//    (<= 8) consecutive row blocks of the same feature group and tile.
//    After the scatter, each block sums a 1/cluster slice of the cells
//    across the cluster's histograms through distributed shared memory, in
//    rank order, and adds each non-zero sum into the output with one global
//    atomicAdd: an output cell takes one global atomic per cluster, not one
//    per block.
//
// 4. Cell copies (channel mode). A block keeps `reps` (1, or 4 to 32)
//    copies of each cell side by side, and a thread adds into copy
//    lane % reps; before the flush each block sums every cell's copies in
//    order. An f32 shared atomicAdd is a compare-and-swap loop, and a
//    warp's lanes that hit one word go round it once more each; with
//    copies, lanes that share a bin mostly hit different words, in
//    different banks. Node mode keeps one copy (reps = 1, folded away).
//
// What bounds it on an H100 is the scatter's shared-memory atomics, one per
// (row, feature, stat), not memory: the pass takes the same time with every
// load scalar, and the f32 kernels, whose shared atomicAdd is a
// compare-and-swap loop (ATOMS.CAST.SPIN), take about twice the int8
// kernel's native ATOMS.ADD. Pairing grad and hess in one 64-bit cell (one
// atomic instead of two) made both node kernels slower: a 64-bit CAS
// (ATOMS.CAS.64) and a 64-bit integer add (ATOMS.CAST.SPIN.64) are both
// loops. Channel mode's copies took kernel 3 from 0.1647 to 0.1085 ms at
// 1M x 28 int32 bins, S=2, B=255 (16 copies; NVIDIA H100 80GB HBM3,
// 700 W, the ablation of tools/ab_node_hist.py).
//
// Geometry (group, tile, reps, cluster, row_blocks, threads) is chosen by the
// caller (ops/histogram.py:_node_geometry and _cols_geometry, which size
// the grid to one wave of the clusters the card holds, max_clusters below)
// and checked here: anything this body cannot run returns
// cudaErrorInvalidValue, and a launch the card refuses returns its error.
// Nothing retries with another geometry.
#pragma once

#include <cooperative_groups.h>
#include <string.h>

#include <type_traits>

#include "hist_common.cuh"

namespace mm_hist {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;     // the most threads a block may have
constexpr int kMinBlocks = 2;     // blocks per SM the register budget allows
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxReps = 32;      // copies of a channel-mode cell: one per lane

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
    return round_bf16(__ldg(p));
  }
};

// f32 stats summed as they are (histogram_cols with stats_dtype=float32).
template <int V>
struct F32Stats {
  using Stat = float;
  using Acc = float;
  static constexpr int kWords = V;

  __device__ static void load(const float* __restrict__ p, bool aligned,
                              uint32_t (&w)[kWords]) {
    float s[V];
    load_rows<float, V>(p, aligned, s);
    memcpy(w, s, sizeof(s));
  }
  __device__ static float get(const uint32_t (&w)[kWords], int i) {
    return __uint_as_float(w[i]);
  }
  __device__ static float scalar(const float* __restrict__ p) { return __ldg(p); }
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

// One row's C stats into its cells of a feature's histogram h, channel k
// at cell + k*B; `off` is the row's node offset in h (0 in channel mode),
// or -1. Each cell has R consecutive copies (R = 1 in node mode) and h
// points at the thread's copy.
template <typename Acc, int C>
__device__ __forceinline__ void add_row(Acc* h, int off, int b, int B, int R,
                                        const Acc (&x)[C]) {
  if (off < 0 || (unsigned)b >= (unsigned)B) return;
  Acc* cell = h + (off + b) * R;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (x[k] != Acc(0)) atomicAdd(cell + k * B * R, x[k]);
}

// kPos: node mode (C = 3 stats per node, W frontier nodes, tiles of `tile`
// nodes); else channel mode (C = 1: W = S stat channels, one to a block,
// `reps` copies of every cell).
template <typename BinT, template <int> class StatsT, bool kPos>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hist_kernel(const BinT* __restrict__ binned, const int32_t* __restrict__ pos,
            const typename StatsT<kVec<BinT>>::Stat* __restrict__ base,
            typename StatsT<kVec<BinT>>::Acc* __restrict__ out, long long n, int F, int W,
            int B, int group, int tile, int tiles, int reps, int row_blocks) {
  constexpr int C = kPos ? 3 : 1;
  constexpr int V = kVec<BinT>;
  using Stats = StatsT<V>;
  using Stat = typename Stats::Stat;
  using Acc = typename Stats::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);  // [g_n, tn, 3, B] or [g_n, tn, B, R]
  cg::cluster_group cluster = cg::this_cluster();

  // row blocks fastest: a cluster (consecutive blocks, row_blocks a
  // multiple of its size) never straddles two (group, tile) items
  const int item = (int)(blockIdx.x / (unsigned)row_blocks);
  const int rb = (int)blockIdx.x - item * row_blocks;
  const int f0 = (item / tiles) * group;
  const int t0 = (item % tiles) * tile;  // the tile's first node or channel
  const int g_n = min(group, F - f0);
  const int tn = min(tile, W - t0);
  const int node_cells = 3 * B;
  const int feat_cells = (kPos ? 3 : 1) * tn * B;
  const int cells = g_n * feat_cells;
  // channel mode keeps R copies of each cell side by side and a thread
  // adds into copy lane % R: lanes that hit one cell hit R words
  const int R = kPos ? 1 : reps;
  for (int i = threadIdx.x; i < cells * R; i += blockDim.x) hist[i] = Acc(0);
  __syncthreads();
  Acc* const mine = hist + (threadIdx.x & (R - 1));

  // channel k of the block: stat row k (node mode) or t0 (channel mode)
  const Stat* st = kPos ? base : base + (long long)t0 * n;

  // whole row vectors in sweeps of blockDim.x, sweep k to row block
  // k % row_blocks: a half pass's selected rows sit at the front of its
  // buffer, so contiguous row ranges would leave most blocks idle. The
  // n % V rows after the last whole vector belong to the last row block.
  const long long nv = n / V;
  bool pos_al = false;
  if constexpr (kPos) pos_al = vec_aligned<int32_t, V>(pos);
  bool stat_al[C];
#pragma unroll
  for (int k = 0; k < C; ++k) stat_al[k] = vec_aligned<Stat, V>(st + k * n);

  for (long long v = (long long)rb * blockDim.x + threadIdx.x; v < nv;
       v += (long long)row_blocks * blockDim.x) {
    const long long r = v * V;
    int off[V];
    if constexpr (kPos) {
      int p[V];
      load_rows<int32_t, V>(pos + r, pos_al, p);
      bool any = false;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int q = p[i] - t0;
        off[i] = (unsigned)q < (unsigned)tn ? q * node_cells : -1;
        any |= off[i] >= 0;
      }
      if (!any) continue;  // no row of this vector is in the node tile
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) off[i] = 0;
    }
    uint32_t s[C][Stats::kWords];
#pragma unroll
    for (int k = 0; k < C; ++k) Stats::load(st + k * n + r, stat_al[k], s[k]);
#pragma unroll 4
    for (int g = 0; g < g_n; ++g) {
      const BinT* col = binned + (long long)(f0 + g) * n;
      BinT b[V];
      load_rows<BinT, V>(col + r, vec_aligned<BinT, V>(col), b);
      Acc* h = mine + g * feat_cells * R;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        Acc x[C];
#pragma unroll
        for (int k = 0; k < C; ++k) x[k] = Stats::get(s[k], i);
        add_row<Acc, C>(h, off[i], (int)b[i], B, R, x);
      }
    }
  }
  if (rb == row_blocks - 1) {
    const long long r = nv * V + threadIdx.x;
    if (r < n) {
      int off = 0;
      if constexpr (kPos) {
        const int q = pos[r] - t0;
        off = (unsigned)q < (unsigned)tn ? q * node_cells : -1;
      }
      if (off >= 0) {
        Acc x[C];
#pragma unroll
        for (int k = 0; k < C; ++k) x[k] = Stats::scalar(st + k * n + r);
        for (int g = 0; g < g_n; ++g)
          add_row<Acc, C>(mine + g * feat_cells * R, off,
                          (int)binned[(long long)(f0 + g) * n + r], B, R, x);
      }
    }
  }

  if constexpr (!kPos) {
    if (R > 1) {  // each cell's copies, summed in order into its first
      static_assert(std::is_same<Acc, float>::value, "channel mode sums f32");
      __syncthreads();
      for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        float* c = hist + i * R;
        float v = 0.f;
        for (int r = 0; r < R; r += 4) {  // R >= 4: 16-byte shared loads
          const float4 q = *reinterpret_cast<const float4*>(c + r);
          v += q.x;
          v += q.y;
          v += q.z;
          v += q.w;
        }
        c[0] = v;
      }
    }
  }
  // every block of the cluster has finished its scatter (and its shared
  // memory is visible cluster-wide) before any block reads a peer's
  cluster.sync();
  // out[f0+g, row0 : row0 + feat_cells/B, :] is one contiguous run per
  // feature, out_rows rows per feature
  const long long out_rows = kPos ? 3LL * W : (long long)W;
  const long long row0 = kPos ? 3LL * t0 : (long long)t0;
  const int nb = (int)cluster.num_blocks();
  const int per = (cells + nb - 1) / nb;
  const int lo = (int)cluster.block_rank() * per;
  const int hi = min(cells, lo + per);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    Acc v = Acc(0);
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < nb) v += *cluster.map_shared_rank(hist + i * R, k);
    if (v != Acc(0)) {
      const int g = i / feat_cells;
      atomicAdd(out + ((long long)(f0 + g) * out_rows + row0) * B + (i - g * feat_cells), v);
    }
  }
  // no block may exit (and free its shared memory) while a peer reads it
  cluster.sync();
}

// The dynamic shared memory of a geometry, or -1 if this body cannot run
// it: `item_cells` histogram rows per tile item (3 per node, 1 per
// channel), `reps` copies of each cell (1, or 4 to kMaxReps in channel
// mode). The grid is row_blocks * groups * tiles blocks, at most 2^31-1.
template <typename Acc>
long long checked_smem(long long n, int F, int W, int B, int group, int tile, int cluster,
                       int row_blocks, int threads, int item_cells, int reps) {
  if (n < 0 || F <= 0 || W <= 0 || B <= 0) return -1;
  if (reps != 1 && (reps < 4 || reps > kMaxReps || (reps & (reps - 1)) != 0)) return -1;
  if (group < 1 || group > F || tile < 1 || tile > W) return -1;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0) return -1;
  if (row_blocks < cluster || row_blocks % cluster != 0) return -1;
  if (threads < 32 || threads > kThreads || threads % 32 != 0) return -1;
  const long long groups = (F + group - 1) / group, tiles = (W + tile - 1) / tile;
  if (row_blocks * groups * tiles > 0x7FFFFFFFLL) return -1;
  const long long smem =
      (long long)group * tile * item_cells * B * reps * (long long)sizeof(Acc);
  return smem > kSmemMax ? -1 : smem;
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

template <typename BinT, template <int> class StatsT, bool kPos>
cudaError_t launch(const void* binned, const void* pos, const void* base, void* out,
                   long long n, int F, int W, int B, int group, int tile, int reps,
                   int cluster, int row_blocks, int threads, cudaStream_t stream) {
  using Stats = StatsT<kVec<BinT>>;
  using Acc = typename Stats::Acc;
  if (kPos ? reps != 1 : tile != 1) return cudaErrorInvalidValue;
  const long long smem = checked_smem<Acc>(n, F, W, B, group, tile, cluster, row_blocks,
                                           threads, kPos ? 3 : 1, reps);
  if (smem < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto kernel = hist_kernel<BinT, StatsT, kPos>;
  cudaError_t err = allow_smem(kernel, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (W + tile - 1) / tile;
  const long long groups = (F + group - 1) / group;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(kernel, dim3((unsigned)(row_blocks * groups * tiles), 1, 1), threads,
                     (int)smem, cluster, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const BinT*>(binned),
                           static_cast<const int32_t*>(pos),
                           static_cast<const typename Stats::Stat*>(base),
                           static_cast<Acc*>(out), n, F, W, B, group, tile, (int)tiles, reps,
                           row_blocks);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

// How many clusters of `cluster` blocks with `smem` bytes of shared memory
// the card holds at once (cudaOccupancyMaxActiveClusters): the caller
// sizes the grid to one wave of them.
template <typename BinT, template <int> class StatsT, bool kPos>
cudaError_t max_clusters(int smem, int cluster, int threads, int* result) {
  if (smem <= 0 || smem > kSmemMax || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || threads < 32 || threads > kThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  auto kernel = hist_kernel<BinT, StatsT, kPos>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(kernel, dim3((unsigned)cluster, 1, 1), threads, smem, cluster, 0, &attr);
  return cudaOccupancyMaxActiveClusters(result, kernel, &cfg);
}

// f(BinT{}) for bin_bytes 4 = int32, 2 = int16, 1 = uint8.
template <typename Fn>
cudaError_t with_bins(int bin_bytes, Fn&& f) {
  switch (bin_bytes) {
    case 4: return f(int32_t{});
    case 2: return f(int16_t{});
    case 1: return f(uint8_t{});
    default: return cudaErrorInvalidValue;
  }
}

// Node mode (kernels 1 and 2).
template <template <int> class StatsT>
cudaError_t dispatch(const void* binned, int bin_bytes, const void* pos, const void* base,
                     void* out, long long n, int F, int W, int B, int group, int node_tile,
                     int cluster, int row_blocks, int threads, cudaStream_t s) {
  return with_bins(bin_bytes, [&](auto bin) {
    return launch<decltype(bin), StatsT, true>(binned, pos, base, out, n, F, W, B, group,
                                               node_tile, 1, cluster, row_blocks, threads, s);
  });
}

template <template <int> class StatsT>
cudaError_t dispatch_max_clusters(int bin_bytes, int smem, int cluster, int threads, int* result) {
  return with_bins(bin_bytes, [&](auto bin) {
    return max_clusters<decltype(bin), StatsT, true>(smem, cluster, threads, result);
  });
}

// Channel mode (kernel 3): one stat channel per block.
template <template <int> class StatsT>
cudaError_t dispatch_cols(const void* binned, int bin_bytes, const void* stats, void* out,
                          long long n, int F, int S, int B, int group, int reps, int cluster,
                          int row_blocks, int threads, cudaStream_t s) {
  return with_bins(bin_bytes, [&](auto bin) {
    return launch<decltype(bin), StatsT, false>(binned, nullptr, stats, out, n, F, S, B, group,
                                                1, reps, cluster, row_blocks, threads, s);
  });
}

template <template <int> class StatsT>
cudaError_t dispatch_cols_max_clusters(int bin_bytes, int smem, int cluster, int threads,
                                       int* result) {
  return with_bins(bin_bytes, [&](auto bin) {
    return max_clusters<decltype(bin), StatsT, false>(smem, cluster, threads, result);
  });
}

}  // namespace mm_hist
