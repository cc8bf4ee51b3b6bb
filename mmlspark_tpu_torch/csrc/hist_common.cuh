// Pieces shared by the port's histogram kernels: shared-memory limits, bf16
// rounding and the error-string export (all three kernels), and the block
// size, the tiling of one axis over gridDim.z and the row-chunk geometry
// (hist_bf16.cu; the node kernels' geometry is node_hist_common.cuh's).
// Each kernel source includes this header and is built into its own
// library; ops/_build.py hashes the headers with every source, so an edit
// here rebuilds all three.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mm_hist {

constexpr int kThreads = 256;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;  // 227 KB: the most a Hopper block can use

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Items (frontier nodes or stat channels) one block holds in shared memory
// at `per_item` bytes each: as many as fit in 48 KB, at least one, at most
// `items`. A single item above 48 KB gets a tile of one and a raised limit.
inline int tile_items(long long per_item, int items) {
  long long t = kSmemDefault / per_item;
  if (t < 1) t = 1;
  if (t > items) t = items;
  return (int)t;
}

// Raise `kernel`'s dynamic shared-memory limit when `smem` exceeds 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Row chunks for a grid of (outer, chunks, tiles) blocks, `outer_blocks` =
// outer * tiles: enough chunks to fill the card about twice over, but never
// so many that a chunk holds fewer rows than its block's flush touches
// cells (`min_rows`, at least 2048).
template <typename Kernel>
cudaError_t row_chunks(Kernel kernel, int smem, long long n, long long outer_blocks,
                       long long min_rows, long long* rows_per_chunk, long long* chunks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (2LL * sms * per_sm + outer_blocks - 1) / outer_blocks;
  if (min_rows < 2048) min_rows = 2048;
  long long c = n / min_rows;
  if (c > want) c = want;
  if (c > 65535) c = 65535;
  if (c < 1) c = 1;
  *rows_per_chunk = (n + c - 1) / c;
  *chunks = (n + *rows_per_chunk - 1) / *rows_per_chunk;
  return cudaSuccess;
}

}  // namespace mm_hist

// Every kernel library exports the message for a code its entry point
// returned (ops/_build.py:check reads it).
extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
