// Kernel 1's deterministic mode: per-frontier-node GBDT histograms over
// bf16-rounded stats, one partial per row block, whose bits are a function
// of the block's inputs and shape alone. For Hopper (sm_90a).
//
// Replaces mmlspark_tpu/ops/histogram.py:_node_hist_pallas (bf16 variant)
// as mmlspark_tpu/models/gbdt/growth.py:_blocked_node_hist calls it: once
// per fixed row block of GrowConfig.hist_blocks, the partials then folded
// in block order by the caller. For row block j of `rows` rows it computes
//
//   out[j, f, w*3 + s, b] = sum_{r in block j} [pos_r == w]
//                             * bf16(base[s, r]) * [binned[f, r] == b]
//
// over binned [F, n] (int32, int16 or uint8), pos [n] int32 in [-1, W) and
// base [3, n] f32 (grad*mask, hess*mask, mask), into out [blocks, F, 3W, B]
// f32, n = blocks * rows.
//
// Why not kernel 1's f32 sums: its f32 atomicAdd in shared and global
// memory adds in the order warps get there, so two launches of one pass
// can differ in the last ulp, and a fit's trees with them. Here every stat
// is turned into a fixed-point int64 before it is added, and integer
// addition does not depend on order: the sums are the same bits whatever
// the warp scheduling, occupancy, grid or number of processes on the card.
//
// Fixed point: stat s of block j is scaled by 2^shift[j][s], chosen from
// the block's largest |bf16 stat| a < 2^e as shift = 62 - e -
// ceil(log2(rows)) (ops/histogram_scatter.py:_det_shifts; here on the card:
// amax_bits below, then FixedStats::shift_of), so that a sum of
// `rows` scaled values stays within 2^62. Each value is rounded to the
// nearest integer once (an error of at most 2^-63 * rows * 2^e, about
// 1e-13 of the block's largest stat at 125,000 rows: below what f32
// summation loses), the integer sums are exact, and each sum is converted
// back as (float)((double)sum * 2^-shift). So the result is within f32
// rounding of the plain version's f32 sums (node_hist_blocked_plain), whose
// own order differs, and bit-equal to ops/histogram_scatter.py:
// node_hist_det_plain. A (block, stat) whose stats are not all finite has
// shift kNoScale: its values are not added and its cells come out NaN.
//
// The kernel is the fixed-point mode of the histogram body
// (node_hist_common.cuh: the row blocks of the reduction are its segments,
// each (segment, feature group, node tile) an item; design points 1-3 and
// 5 there), geometry from ops/histogram.py:_det_geometry, a function of the
// shape alone. Bound: kernel 1's bytes (bins, pos and stats read once, the
// output written once). On an H100 (tools/ab_node_hist.py --det-ablation,
// n=1,000,000 in 8 blocks, F=28, B=255) the adds are not what limits it:
// the (lo, hi) cells make one native 32-bit add per stat where a value's
// low word is zero (values within 2^(L-23) of their block's largest, L =
// ceil(log2(rows))) and two otherwise, and at W=16 the pass with zero
// stats (every load and conversion, no add) takes two thirds of the full
// one: 8-byte cells leave room for one feature of 16 nodes a block, so
// each of the 28 items re-reads every row's pos and stats. Where a cluster
// of row blocks owns an item it converts and stores its cells; else the
// int64 partials go through `acc` and the finish kernel below converts.
#include <algorithm>

#include "node_hist_common.cuh"

namespace mm_hist_det {

constexpr int kThreads = 256;   // the amax pass's and finish's blocks
constexpr int kAmaxBlocks = 264;  // about two blocks per SM of an H100

using Shifts = mm_hist::FixedStats<4>;

// amax[j * 3 + s] = the largest bits of |base[s, r]| over block j's rows, by atomicMax (a non-negative float's bits order as
// its value, and a non-finite value's bits are at least 0x7F800000's);
// zeroed by the caller. `chunks` blocks of threads share each (j, s).
__global__ void amax_bits(const float* __restrict__ base, uint32_t* __restrict__ amax,
                          long long n, long long rows, int blocks, int chunks) {
  const int seg = (int)blockIdx.x / chunks;  // s * blocks + j
  const int c = (int)blockIdx.x - seg * chunks;
  const int s = seg / blocks, j = seg - s * blocks;
  const float* p = base + (long long)s * n + (long long)j * rows;
  const long long lo = rows * c / chunks, hi = rows * (c + 1) / chunks;
  uint32_t m = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    m = max(m, __float_as_uint(fabsf(__ldg(p + i))));
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(amax + j * 3 + s, m);
}

// out[i] = (float)((double)acc[i] * 2^-shift of its (block, stat)); NaN for
// a (block, stat) without a shift.
__global__ void finish(const unsigned long long* __restrict__ acc,
                       const uint32_t* __restrict__ amax, float* __restrict__ out,
                       long long total, long long per_block, int W, int B, int lg) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(i / per_block);
    const int k = (int)((i / B) % (3LL * W)) % 3;
    const int sh = Shifts::shift_of(amax[j * 3 + k], lg);
    out[i] = sh == mm_hist::kNoScale ? __int_as_float(0x7fc00000)
                                     : (float)scalbn((double)(long long)acc[i], -sh);
  }
}

}  // namespace mm_hist_det

extern "C" {

// bin_bytes: 4 = int32, 2 = int16, 1 = uint8. amax: [blocks, 3] uint32
// scratch, filled here (each stat's largest |value| of a block, whence its
// shift); out: [blocks, F, 3W, B] f32. acc: null when each cluster owns its
// item (cluster == row_blocks), else [blocks, F, 3W, B] int64 zeroed by
// the caller, converted into out by a last launch. The geometry is
// ops/histogram.py:_det_geometry's. Returns a cudaError_t code.
int mm_node_hist_det(const void* binned, int bin_bytes, const void* pos, const void* base,
                     void* amax, void* acc, void* out, long long n, int blocks, int F, int W,
                     int B, int group, int tile, int cluster, int row_blocks, int threads,
                     void* stream) {
  namespace d = mm_hist_det;
  if (blocks < 1 || n < 0 || n % blocks != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<uint32_t*>(amax);
  auto a = static_cast<long long*>(acc);
  auto o = static_cast<float*>(out);
  const long long rows = n / blocks;
  cudaError_t err = cudaMemsetAsync(m, 0, sizeof(uint32_t) * 3 * blocks, s);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (int)std::max(1LL, std::min<long long>(d::kAmaxBlocks / (3 * blocks), rows));
  if (rows > 0) {
    d::amax_bits<<<3 * blocks * chunks, d::kThreads, 0, s>>>(static_cast<const float*>(base),
                                                             m, n, rows, blocks, chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = mm_hist::dispatch_fixed<mm_hist::FixedStats>(binned, bin_bytes, pos, base, m, a, o, n,
                                                     blocks, F, W, B, group, tile, cluster,
                                                     row_blocks, threads, s);
  if (err != cudaSuccess || acc == nullptr) return (int)err;
  const long long total = (long long)blocks * F * 3 * W * B;
  const long long want = (total + d::kThreads - 1) / d::kThreads;
  const unsigned fgrid = (unsigned)(want < 65535 ? want : 65535);
  d::finish<<<fgrid, d::kThreads, 0, s>>>(static_cast<const unsigned long long*>(acc), m, o,
                                          total, total / blocks, W, B,
                                          mm_hist::ceil_log2(rows));
  return (int)cudaGetLastError();
}

// Clusters of `cluster` blocks of `threads` threads and `smem` bytes of
// shared memory that the card holds at once, into *result: what
// ops/histogram.py:_DET_CLUSTERS_HELD records for an H100.
int mm_node_hist_det_max_clusters(int bin_bytes, int smem, int cluster, int threads,
                                  int* result) {
  return (int)mm_hist::dispatch_max_clusters<mm_hist::FixedStats>(bin_bytes, smem, cluster,
                                                                  threads, result);
}

}  // extern "C"
