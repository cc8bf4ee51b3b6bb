// Per-frontier-node GBDT gradient histograms over bf16-rounded stats, for
// Hopper (sm_90a).
//
// Replaces mmlspark_tpu/ops/histogram.py:_node_hist_pallas (bf16 variant,
// body _make_node_hist_kernel, inner loop _hist_dot_accumulate /
// _hist_group_dot). It computes
//
//   out[f, w*3 + s, b] = sum_r [pos_r == w] * bf16(base[s, r]) * [binned[f, r] == b]
//
// with f32 accumulation: s in {grad*mask, hess*mask, mask}; base is [3, n]
// f32, rounded to bf16 with __float2bfloat16_rn in registers (the rounding
// every engine of the JAX package applies); out is [F, 3W, B] f32.
//
// The TPU kernel turns the bin scatter into a one-hot x MXU contraction
// because a TPU has no fast scatter. Hopper has fast shared-memory atomics,
// so this is a scatter; node_hist_common.cuh holds its design (feature
// groups, 16-byte loads, cluster-reduced flush) and its bound. Float
// atomics make the grad/hess sums order-dependent; the count channel stays
// exact (integer counts below 2^24).
#include "node_hist_common.cuh"

extern "C" {

// bin_bytes: 4 = int32, 2 = int16, 1 = uint8; the geometry is
// ops/histogram.py:_node_geometry's. Returns a cudaError_t code.
int mm_node_hist_bf16(const void* binned, int bin_bytes, const void* pos, const void* base,
                      void* out, long long n, int F, int W, int B, int group, int node_tile,
                      int cluster, int row_blocks, int threads, void* stream) {
  return (int)mm_hist::dispatch<mm_hist::Bf16Stats>(
      binned, bin_bytes, pos, base, out, n, F, W, B, group, node_tile, cluster, row_blocks,
      threads, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` blocks of `threads` threads and `smem` bytes of
// shared memory that the card holds at once, into *result.
int mm_node_hist_bf16_max_clusters(int bin_bytes, int smem, int cluster, int threads,
                                   int* result) {
  return (int)mm_hist::dispatch_max_clusters<mm_hist::Bf16Stats>(bin_bytes, smem, cluster, threads,
                                                           result);
}

}  // extern "C"
