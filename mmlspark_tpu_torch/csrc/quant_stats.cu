// A quantized tree's int8 gradient statistics in one pass, for Hopper
// (sm_90a): LightGBM use_quantized_grad's per-channel symmetric int8
// quantization with stochastic rounding.
//
// Replaces no TPU kernel: the JAX package computes this as XLA-fused
// elementwise code (mmlspark_tpu/models/gbdt/growth.py:_quantize_for,
// mmlspark_tpu/ops/histogram.py:quantize_stats). The port's eager chain of
// the same function (models/gbdt/growth.py:_quantize_for over the stacked
// [3, n] statistics, utils/prng.py's int64 threefry passes,
// ops/histogram.py:quantize_stats) stays the CPU route and the reference
// this kernel is held to bit for bit. For each channel c of the statistics
// s = (grad * vm, hess * vm, vm) and row i it writes
//
//   out[c, i] = clamp(floor(s[c, i] / scale[c] + u[c, i]), -q_max, q_max)
//
// as int8, where u is, by mode:
//
//   kThreefry    jax.random.uniform's draw of counter c*stride + start + i
//                under the key (k0, k1): threefry2x32 with 20 rounds of
//                the counter's (hi, lo) words, x0 ^ x1, the top 23 bits as
//                the mantissa of a float in [1, 2), minus 1
//                (utils/prng.py:uniform with start and stride);
//   kPositional  the blocked mode's murmur mix of the global row start + i
//                and the channel (ops/histogram.py:positional_uniform);
//   kNearest     no draw: round half to even (torch.round).
//
// Division and addition are the IEEE round-to-nearest ones (__fdiv_rn,
// __fadd_rn), never contracted, and a NaN passes the clamp as torch.clamp
// passes it, so the int8 values are the eager chain's on the card. The
// scales come from the caller (the eager chain's own expression over the
// per-channel amax, which mm_stats_amax computes exactly: a max is the
// same in any order).
//
// Bound on an H100: 31.5M hashes of about 90 integer operations each at
// n = 10.5M rows (about 0.2 ms at the card's int32 rate), against 0.05 ms
// of memory (three f32 reads, three int8 writes a row). Each thread takes
// one row and its three channels, so the three f32 inputs are read once and
// the hash runs in registers; no shared memory, no synchronisation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAmaxBlocks = 1024;  // blocks of the amax reduction, at most

enum Mode { kNearest = 0, kThreefry = 1, kPositional = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32, 20 rounds (utils/prng.py:_threefry_int), returning x0 ^ x1
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

// murmur3's 32-bit finalizer (ops/histogram.py:_mix32)
__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v = (v ^ (v >> 16)) * 0x85EBCA6Bu;
  v = (v ^ (v >> 13)) * 0xC2B2AE35u;
  return v ^ (v >> 16);
}

template <int kMode>
__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1, long long start,
                                      long long stride, int c, long long i) {
  if (kMode == kThreefry) {
    const unsigned long long ctr = static_cast<unsigned long long>(c * stride + start + i);
    const uint32_t b = threefry_bits(k0, k1, static_cast<uint32_t>(ctr >> 32),
                                     static_cast<uint32_t>(ctr));
    return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  }
  const uint32_t idx = static_cast<uint32_t>(start + i);
  uint32_t x = (idx ^ k0) + static_cast<uint32_t>(c) * 0x9E3779B9u;
  x = mix32(x ^ k1);
  x = mix32(x + 0x27D4EB2Fu);
  return __fmul_rn(static_cast<float>(x >> 8), 1.0f / 16777216.0f);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    quant_stats_kernel(const float* __restrict__ grad, const float* __restrict__ hess,
                       const float* __restrict__ vm, const float* __restrict__ scales,
                       int8_t* __restrict__ out, long long n, uint32_t k0, uint32_t k1,
                       long long start, long long stride, float q_max) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float v = vm[i];
  const float s[3] = {__fmul_rn(grad[i], v), __fmul_rn(hess[i], v), v};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x = __fdiv_rn(s[c], scales[c]);
    float q = kMode == kNearest ? rintf(x)
                                : floorf(__fadd_rn(x, draw<kMode>(k0, k1, start, stride, c, i)));
    if (!isnan(q)) q = fminf(fmaxf(q, -q_max), q_max);
    out[c * n + i] = static_cast<int8_t>(q);
  }
}

// the per-channel max of |grad * vm|, |hess * vm|, |vm| as the bits of
// non-negative floats (whose unsigned order is their order, a NaN above
// +inf, so a NaN wins as torch.amax lets it), into amax_bits zeroed by
// the caller
__global__ void __launch_bounds__(kThreads)
    stats_amax_kernel(const float* __restrict__ grad, const float* __restrict__ hess,
                      const float* __restrict__ vm, unsigned int* __restrict__ amax_bits,
                      long long n) {
  unsigned int m[3] = {0u, 0u, 0u};
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const float v = vm[i];
    m[0] = max(m[0], __float_as_uint(fabsf(__fmul_rn(grad[i], v))));
    m[1] = max(m[1], __float_as_uint(fabsf(__fmul_rn(hess[i], v))));
    m[2] = max(m[2], __float_as_uint(fabsf(v)));
  }
  __shared__ unsigned int warp_max[3][kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const unsigned int w = __reduce_max_sync(0xFFFFFFFFu, m[c]);
    if (lane == 0) warp_max[c][warp] = w;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned int b = 0u;
    for (int w = 0; w < kThreads / 32; ++w) b = max(b, warp_max[threadIdx.x][w]);
    atomicMax(amax_bits + threadIdx.x, b);
  }
}

}  // namespace

extern "C" {

const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// amax: [3] f32 zeroed by the caller. Returns a cudaError_t code.
int mm_stats_amax(const void* grad, const void* hess, const void* vm, void* amax, long long n,
                  void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (blocks > kAmaxBlocks) blocks = kAmaxBlocks;
  stats_amax_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad), static_cast<const float*>(hess),
      static_cast<const float*>(vm), static_cast<unsigned int*>(amax), n);
  return (int)cudaGetLastError();
}

// scales: [3] f32; out: [3, n] int8; mode: 0 nearest, 1 threefry, 2
// positional (the key words unused in mode 0, stride in modes 0 and 2).
// Returns a cudaError_t code.
int mm_quant_stats(const void* grad, const void* hess, const void* vm, const void* scales,
                   void* out, long long n, unsigned int k0, unsigned int k1, long long start,
                   long long stride, int mode, float q_max, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grad);
  const float* h = static_cast<const float*>(hess);
  const float* v = static_cast<const float*>(vm);
  const float* sc = static_cast<const float*>(scales);
  int8_t* o = static_cast<int8_t*>(out);
  switch (mode) {
    case kNearest:
      quant_stats_kernel<kNearest><<<blocks, kThreads, 0, s>>>(g, h, v, sc, o, n, k0, k1, start,
                                                               stride, q_max);
      break;
    case kThreefry:
      quant_stats_kernel<kThreefry><<<blocks, kThreads, 0, s>>>(g, h, v, sc, o, n, k0, k1, start,
                                                                stride, q_max);
      break;
    case kPositional:
      quant_stats_kernel<kPositional><<<blocks, kThreads, 0, s>>>(g, h, v, sc, o, n, k0, k1,
                                                                  start, stride, q_max);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
