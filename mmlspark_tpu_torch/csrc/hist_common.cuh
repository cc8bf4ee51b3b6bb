// Pieces under the port's histogram body (node_hist_common.cuh): the
// shared-memory limits, bf16 rounding and the error-string export. Each
// kernel source includes the body and is built into its own library;
// ops/_build.py hashes the headers with every source, so an edit here
// rebuilds all three.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mm_hist {

constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory a kernel gets unasked
constexpr int kSmemMax = 232448;  // 227 KB: the most a Hopper block can use

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Raise `kernel`'s dynamic shared-memory limit when `smem` exceeds 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace mm_hist

// Every kernel library exports the message for a code its entry point
// returned (ops/_build.py:check reads it).
extern "C" const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
