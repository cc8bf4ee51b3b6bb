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
// Why not kernel 1's body: its f32 atomicAdd in shared and global memory
// adds in the order warps get there, so two launches of one pass can
// differ in the last ulp, and a fit's trees with them. Here every stat is
// turned into a fixed-point int64 before it is added, and integer addition
// does not depend on order: the sums are the same bits whatever the warp
// scheduling, occupancy, grid or number of processes on the card.
//
// Fixed point: stat s of block j is scaled by 2^shift[j][s], chosen by the
// caller (ops/histogram.py:_det_shifts) from the block's largest |bf16
// stat| a < 2^e as shift = 62 - e - ceil(log2(rows)), so that a sum of
// `rows` scaled values stays below 2^62 (plus rows/2 of rounding). Each
// value is rounded to the nearest integer once (an error of at most
// 2^-63 * rows * 2^e, about 1e-13 of the block's largest stat at 125,000
// rows: below what f32 summation loses), the integer sums are exact, and
// the finish kernel converts each sum back with one rounding to f32. So
// the result is within f32 rounding of the plain version's f32 sums
// (node_hist_plain), whose own order differs. A (block, stat) whose stats
// are not all finite has shift kNoScale: its values are not added and its
// cells come out NaN.
//
// Bound: the same bytes as kernel 1 (bins, pos and stats read once; the
// output written once); what bounds it on an H100 is the scatter's 64-bit
// shared-memory atomics, a compare-and-swap loop each (as kernel 1's f32
// atomics). This first version is plain: one row per thread per sweep,
// scalar loads, one block per (row block, feature group, node tile, slice
// of rows); a block's integer histogram lives in shared memory and is
// flushed with 64-bit global atomics (exact), then the finish kernel
// converts. The geometry comes from ops/histogram.py:_det_geometry, from
// the shape alone.
#include <limits.h>

#include "hist_common.cuh"

namespace mm_hist_det {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;
constexpr int kNoScale = INT_MIN;  // the (block, stat) has non-finite stats
constexpr int kFinishThreads = 256;

template <typename BinT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scatter(const BinT* __restrict__ binned, const int32_t* __restrict__ pos,
        const float* __restrict__ base, const int* __restrict__ shift,
        unsigned long long* __restrict__ acc, long long n, long long rows, int F, int W,
        int B, int group, int tile, int tiles, int items, int row_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* hist = reinterpret_cast<unsigned long long*>(smem_raw);
  // grid: row slices fastest, then (feature group, node tile) items, then
  // the row blocks of the deterministic reduction
  const int rb = (int)(blockIdx.x % (unsigned)row_blocks);
  const int y = (int)(blockIdx.x / (unsigned)row_blocks);
  const int item = y % items;
  const int j = y / items;
  const int f0 = (item / tiles) * group;
  const int t0 = (item % tiles) * tile;
  const int g_n = min(group, F - f0);
  const int tn = min(tile, W - t0);
  const int node_cells = 3 * B;
  const int feat_cells = tn * node_cells;
  const int cells = g_n * feat_cells;  // [g_n, tn, 3, B]
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0ull;
  __syncthreads();

  int s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = shift[j * 3 + k];
  const long long r1 = (long long)(j + 1) * rows;
  for (long long r = (long long)j * rows + (long long)rb * blockDim.x + threadIdx.x; r < r1;
       r += (long long)row_blocks * blockDim.x) {
    const int q = pos[r] - t0;
    if ((unsigned)q >= (unsigned)tn) continue;  // not in this node tile
    long long v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      v[k] = s[k] == kNoScale
                 ? 0
                 : __double2ll_rn(scalbn((double)mm_hist::round_bf16(base[k * n + r]), s[k]));
    if ((v[0] | v[1] | v[2]) == 0) continue;
    unsigned long long* h = hist + q * node_cells;
    for (int g = 0; g < g_n; ++g) {
      const int b = (int)binned[(long long)(f0 + g) * n + r];
      if ((unsigned)b >= (unsigned)B) continue;  // a bad id writes nothing
      unsigned long long* cell = h + g * feat_cells + b;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (v[k] != 0) atomicAdd(cell + k * B, (unsigned long long)v[k]);
    }
  }
  __syncthreads();
  // acc[j, f0+g, 3*t0 : 3*(t0+tn), :] is one contiguous run per feature
  const long long out_rows = 3LL * W;
  unsigned long long* out = acc + (long long)j * F * out_rows * B;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v = hist[i];
    if (v != 0ull) {
      const int g = i / feat_cells;
      atomicAdd(out + ((long long)(f0 + g) * out_rows + 3LL * t0) * B + (i - g * feat_cells), v);
    }
  }
}

// out[i] = acc[i] * 2^-shift of its (block, stat), rounded once to f32;
// NaN for a (block, stat) without a scale.
__global__ void finish(const unsigned long long* __restrict__ acc, const int* __restrict__ shift,
                       float* __restrict__ out, long long total, long long per_block, int W,
                       int B) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(i / per_block);
    const int k = (int)((i / B) % (3LL * W)) % 3;
    const int sh = shift[j * 3 + k];
    out[i] = sh == kNoScale ? __int_as_float(0x7fc00000)
                            : (float)scalbn((double)(long long)acc[i], -sh);
  }
}

template <typename BinT>
cudaError_t launch(const void* binned, const void* pos, const void* base, const void* shift,
                   void* acc, void* out, long long n, int blocks, int F, int W, int B, int group,
                   int tile, int row_blocks, int threads, cudaStream_t stream) {
  if (n < 0 || blocks < 1 || n % blocks != 0 || F < 1 || W < 1 || B < 1) return cudaErrorInvalidValue;
  if (group < 1 || group > F || tile < 1 || tile > W || row_blocks < 1) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kThreads || threads % 32 != 0) return cudaErrorInvalidValue;
  const long long groups = (F + group - 1) / group, tiles = (W + tile - 1) / tile;
  const long long grid = (long long)row_blocks * groups * tiles * blocks;
  if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const long long smem = (long long)group * tile * 3 * B * (long long)sizeof(unsigned long long);
  if (smem > mm_hist::kSmemMax) return cudaErrorInvalidValue;
  const long long total = (long long)blocks * F * 3 * W * B;
  if (n == 0 || total == 0) return cudaSuccess;
  auto kernel = scatter<BinT>;
  cudaError_t err = mm_hist::allow_smem(kernel, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, threads, (size_t)smem, stream>>>(
      static_cast<const BinT*>(binned), static_cast<const int32_t*>(pos),
      static_cast<const float*>(base), static_cast<const int*>(shift),
      static_cast<unsigned long long*>(acc), n, n / blocks, F, W, B, group, tile, (int)tiles,
      (int)(groups * tiles), row_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long want = (total + kFinishThreads - 1) / kFinishThreads;
  const unsigned fgrid = (unsigned)(want < 65535 ? want : 65535);
  finish<<<fgrid, kFinishThreads, 0, stream>>>(
      static_cast<const unsigned long long*>(acc), static_cast<const int*>(shift),
      static_cast<float*>(out), total, total / blocks, W, B);
  return cudaGetLastError();
}

}  // namespace mm_hist_det

extern "C" {

// bin_bytes: 4 = int32, 2 = int16, 1 = uint8. shift: [blocks, 3] int32
// (ops/histogram.py:_det_shifts); acc: [blocks, F, 3W, B] int64, zeroed by
// the caller; out: [blocks, F, 3W, B] f32. The geometry is
// ops/histogram.py:_det_geometry's. Returns a cudaError_t code.
int mm_node_hist_det(const void* binned, int bin_bytes, const void* pos, const void* base,
                     const void* shift, void* acc, void* out, long long n, int blocks, int F,
                     int W, int B, int group, int tile, int row_blocks, int threads,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 4:
      return (int)mm_hist_det::launch<int32_t>(binned, pos, base, shift, acc, out, n, blocks, F,
                                               W, B, group, tile, row_blocks, threads, s);
    case 2:
      return (int)mm_hist_det::launch<int16_t>(binned, pos, base, shift, acc, out, n, blocks, F,
                                               W, B, group, tile, row_blocks, threads, s);
    case 1:
      return (int)mm_hist_det::launch<uint8_t>(binned, pos, base, shift, acc, out, n, blocks, F,
                                               W, B, group, tile, row_blocks, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
