// Per-frontier-node GBDT gradient histograms over int8 stats, for Hopper
// (sm_90a): the quantized-gradient path (LightGBM use_quantized_grad).
//
// Replaces mmlspark_tpu/ops/histogram.py:_node_hist_pallas with
// quantized=True (selected at histogram.py:287-290; the int8 branch of the
// body _make_node_hist_kernel at :608-610, accumulated by _hist_group_dot
// in int32). It computes, exactly,
//
//   out[f, w*3 + s, b] = sum_r [pos_r == w] * base[s, r] * [binned[f, r] == b]
//
// in int32: base is [3, n] int8 (the quantized grad*mask, hess*mask and
// mask of quantize_stats) and out is [F, 3W, B] int32. Dequantization
// (out * scale[s]) stays with the caller, as in the JAX package
// (histogram.py:316-318).
//
// The scatter of node_hist.cu with integer arithmetic, from the same body
// (node_hist_common.cuh): the int8 stats of V rows are loaded as packed
// words and sign-extended in registers; zero stats are not added. Integer
// addition does not depend on order, so the result is bit-equal to any
// other summation (the plain version's index_add_). The caller bounds
// every cell: quantize_stats clips to q_max = quant_q_max(n), so
// q_max * n < 2^31 and no cell can overflow.
#include "node_hist_common.cuh"

extern "C" {

// bin_bytes: 4 = int32, 2 = int16, 1 = uint8; the geometry is
// ops/histogram.py:_node_geometry's. Returns a cudaError_t code.
int mm_node_hist_int8(const void* binned, int bin_bytes, const void* pos, const void* base,
                      void* out, long long n, int F, int W, int B, int group, int node_tile,
                      int cluster, int row_blocks, int threads, void* stream) {
  return (int)mm_hist::dispatch<mm_hist::Int8Stats>(
      binned, bin_bytes, pos, base, out, n, F, W, B, group, node_tile, cluster, row_blocks,
      threads, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` blocks of `threads` threads and `smem` bytes of
// shared memory that the card holds at once, into *result.
int mm_node_hist_int8_max_clusters(int bin_bytes, int smem, int cluster, int threads,
                                   int* result) {
  return (int)mm_hist::dispatch_max_clusters<mm_hist::Int8Stats>(bin_bytes, smem, cluster, threads,
                                                           result);
}

}  // extern "C"
