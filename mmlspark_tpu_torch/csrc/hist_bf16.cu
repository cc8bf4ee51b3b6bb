// Unfused GBDT histograms of S stat channels for Hopper (sm_90a).
//
// Replaces mmlspark_tpu/ops/histogram.py:_hist_pallas (call at :664, body
// _make_hist_kernel:589), the kernel behind histogram_cols. It computes
//
//   out[f, s, b] = sum_r round(stats[s, r]) * [binned[f, r] == b]
//
// with f32 accumulation: stats is [S, n] f32, round is bf16
// round-to-nearest-even (__float2bfloat16_rn, widened back) or none (f32
// stats_dtype), binned is [F, n] (int32, int16 or uint8) and out is
// [F, S, B] f32, zero-filled by the caller (the kernel adds into it). No
// row is masked; a bin outside [0, B) is skipped, never written.
//
// The channel mode of the body kernels 1 and 2 share
// (node_hist_common.cuh, which holds the design and the bound): a block
// owns a feature group x one stat channel, loads a row vector's stats once
// per feature group and rounds them in registers (no rounded copy is ever
// written), and scatters into up to 32 lane-interleaved copies of each
// shared-memory cell (fewer compare-and-swap retries on the f32 shared
// atomics); each block sums its copies, and pairs of row blocks sum their
// histograms through distributed shared memory before one global atomic
// per cell. Float atomics make the sums order-dependent; integer-valued
// stats below 2^24 (counts) stay exact.
#include "node_hist_common.cuh"

extern "C" {

// bin_bytes: 4 = int32, 2 = int16, 1 = uint8; to_bf16: 1 rounds each stat
// to bf16 before it is added, 0 adds it as given; the geometry (reps
// copies of each cell) is ops/histogram.py:_cols_geometry's. Returns a
// cudaError_t code.
int mm_hist_bf16(const void* binned, int bin_bytes, const void* stats, void* out, long long n,
                 int F, int S, int B, int to_bf16, int group, int reps, int cluster,
                 int row_blocks, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (to_bf16)
    return (int)mm_hist::dispatch_cols<mm_hist::Bf16Stats>(binned, bin_bytes, stats, out, n, F,
                                                           S, B, group, reps, cluster, row_blocks,
                                                           threads, s);
  return (int)mm_hist::dispatch_cols<mm_hist::F32Stats>(binned, bin_bytes, stats, out, n, F, S,
                                                        B, group, reps, cluster, row_blocks,
                                                        threads, s);
}

// Clusters of `cluster` blocks of `threads` threads and `smem` bytes of
// shared memory that the card holds at once, into *result, for the
// kernel of (bin_bytes, to_bf16).
int mm_hist_bf16_max_clusters(int bin_bytes, int to_bf16, int smem, int cluster, int threads,
                              int* result) {
  if (to_bf16)
    return (int)mm_hist::dispatch_cols_max_clusters<mm_hist::Bf16Stats>(bin_bytes, smem, cluster,
                                                                        threads, result);
  return (int)mm_hist::dispatch_cols_max_clusters<mm_hist::F32Stats>(bin_bytes, smem, cluster,
                                                                     threads, result);
}

}  // extern "C"
