// LambdaRank's gradients and hessians over query groups of any length, for
// Hopper (sm_90a): one launch a boosting round.
//
// Replaces no TPU kernel: the JAX package computes the lambdas as XLA code
// over query groups padded to one static width, a dense [G, S, S] batch
// (mmlspark_tpu/models/gbdt/objectives.py:_lambdarank), which drops the rows
// past the width and spends most of its work on padding. The port keeps
// that formula (models/gbdt/objectives.py:_dense_lambdas) and its plain
// version over ragged queries (objectives.py:lambdarank_plain), the CPU's
// route and what this kernel is held to. For query q, rows [b, e) of rows
// sorted by query (b = offsets[q], e = offsets[q + 1]), the rows of weight
// above 0 taking part:
//
//   rank_i   = #{j: s_j > s_i} + #{j < i: s_j == s_i}   (descending, stable)
//   disc_i   = 1 / log2(rank_i + 2)
//   maxDCG   = the ideal order's gains over its first max_position places,
//              each over log2(place + 2); at least 1e-12
//   for each pair y_i > y_j:
//     delta  = |gain_i - gain_j| |disc_i - disc_j| / maxDCG
//     sig    = 1 / (1 + exp(sigma (s_i - s_j)))
//     lambda = -sigma sig delta,  h = sigma^2 sig (1 - sig) delta
//   grad_i   = sum_j lambda(i, j) - sum_j lambda(j, i)
//   hess_i   = max(sum_j h(i, j) + sum_j h(j, i), 1e-9)
//
// gain = 2^y - 1, or table[clamp(int(y), 0, n_table - 1)] (labelGain).
//
// Design. One block a query; a thread takes the query's rows i = thread,
// thread + blockDim, ... and walks the rows j in order, so every thread of
// a warp reads the same j at once (a broadcast from shared memory). The
// query's scores, grades, gains, discounts and weights are staged in
// dynamic shared memory (20 bytes a row) for queries of up to smem_rows
// rows; a longer query is read from device memory, its gains, discounts
// and weights through a scratch of three floats a row that the wrapper
// allocates, so a query of any length runs. The wrapper sizes the block
// and smem_rows from the longest query: short queries take small blocks,
// so many queries share an SM. Ranks and ideal places are counts over the
// query (no sort). A row's sums are taken by one thread in a fixed order
// (tiles of 32 rows j summed apart, then added in order), written once, no
// atomics; maxDCG is summed in a fixed order too: two launches on one input
// give the same bits, so two fits of one seed grow the same trees.
//
// Bound on an H100: the pairs' arithmetic at the float32 rate (21
// operations a pair y_i > y_j) against the bytes of scores, grades, weights
// and offsets read and g and h written; at Yahoo LTR's 473,134 rows in
// 19,944 queries both bounds are a few microseconds, so the blocks' count
// loops and synchronisations set its time. Counting ranks costs L^2
// compares a query of L rows, less than a sort for such queries (a mean of
// 23.7 rows).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTile = 32;  // rows j summed apart before they join a row's sum
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float gain_of(float y, const float* table, int n_table) {
  if (n_table <= 0) return exp2f(y) - 1.0f;
  const int g = min(max(static_cast<int>(y), 0), n_table - 1);
  return table[g];
}

__global__ void __launch_bounds__(kMaxThreads)
    lambdarank_kernel(const float* __restrict__ score, const float* __restrict__ label,
                      const float* __restrict__ weight, const long long* __restrict__ offsets,
                      float* __restrict__ scratch, long long n, int smem_rows,
                      const float* __restrict__ table, int n_table, int max_position,
                      float sigma, float* __restrict__ grad, float* __restrict__ hess) {
  extern __shared__ float smem[];
  __shared__ float warp_dcg[kMaxThreads / 32];
  const long long b = offsets[blockIdx.x];
  const int L = static_cast<int>(offsets[blockIdx.x + 1] - b);
  if (L <= 0) return;
  const bool staged = L <= smem_rows;
  // the query's rows: shared memory, or device memory and the scratch
  float* sm_s = smem;
  float* sm_y = smem + smem_rows;
  const float* S = staged ? sm_s : score + b;
  const float* Y = staged ? sm_y : label + b;
  float* G = staged ? smem + 2 * smem_rows : scratch + b;
  float* D = staged ? smem + 3 * smem_rows : scratch + n + b;
  float* V = staged ? smem + 4 * smem_rows : scratch + 2 * n + b;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float y = label[b + i];
    if (staged) {
      sm_s[i] = score[b + i];
      sm_y[i] = y;
    }
    const bool v = weight[b + i] > 0.0f;
    V[i] = v ? 1.0f : 0.0f;
    G[i] = v ? gain_of(y, table, n_table) : 0.0f;
  }
  __syncthreads();

  // ranks and ideal places by counting; discounts; this thread's share of
  // the ideal DCG, in its rows' order
  float dcg = 0.0f;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const bool vi = V[i] != 0.0f;
    const float si = vi ? S[i] : -INFINITY;
    const float gi = G[i];
    int above = 0, ideal = 0;
    for (int j = 0; j < L; ++j) {
      const float sj = V[j] != 0.0f ? S[j] : -INFINITY;
      const float gj = G[j];
      above += (sj > si || (sj == si && j < i)) ? 1 : 0;
      ideal += (gj > gi || (gj == gi && j < i)) ? 1 : 0;
    }
    D[i] = vi ? 1.0f / log2f(static_cast<float>(above) + 2.0f) : 0.0f;
    if (ideal < max_position) dcg += gi * (1.0f / log2f(static_cast<float>(ideal) + 2.0f));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dcg += __shfl_xor_sync(kFull, dcg, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_dcg[warp] = dcg;
  __syncthreads();
  float maxdcg = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) maxdcg += warp_dcg[w];
  maxdcg = fmaxf(maxdcg, 1e-12f);

  // each row's lambdas as the higher (up) and as the lower (down) item of
  // its pairs, a tile of rows j at a time
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    float up = 0.0f, down = 0.0f, h_up = 0.0f, h_down = 0.0f;
    if (V[i] != 0.0f) {
      const float si = S[i], yi = Y[i], gi = G[i], di = D[i];
      for (int j0 = 0; j0 < L; j0 += kTile) {
        float t_up = 0.0f, t_down = 0.0f, th_up = 0.0f, th_down = 0.0f;
        const int j1 = min(j0 + kTile, L);
        for (int j = j0; j < j1; ++j) {
          if (V[j] == 0.0f) continue;
          const float yj = Y[j];
          if (yi > yj) {
            const float delta = fabsf(gi - G[j]) * fabsf(di - D[j]) / maxdcg;
            const float sig = 1.0f / (1.0f + expf(sigma * (si - S[j])));
            t_up += -sigma * sig * delta;
            th_up += sigma * sigma * sig * (1.0f - sig) * delta;
          } else if (yj > yi) {
            const float delta = fabsf(G[j] - gi) * fabsf(D[j] - di) / maxdcg;
            const float sig = 1.0f / (1.0f + expf(sigma * (S[j] - si)));
            t_down += -sigma * sig * delta;
            th_down += sigma * sigma * sig * (1.0f - sig) * delta;
          }
        }
        up += t_up;
        down += t_down;
        h_up += th_up;
        h_down += th_down;
      }
    }
    grad[b + i] = up - down;
    hess[b + i] = fmaxf(h_up + h_down, 1e-9f);
  }
}

}  // namespace

extern "C" {

const char* mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// score, label, weight, grad, hess: [n] f32; offsets: [n_queries + 1] int64
// rising from 0 to n; threads: the block's threads, a multiple of 32 up to
// 1,024; smem_rows: the rows a query may stage in shared memory (20 bytes
// a row, at most 227 KB); scratch: [3 n] f32 when a query is longer than
// smem_rows, else unused (may be null); table: [n_table] f32 label gains,
// or null with n_table 0 for 2^y - 1. Returns a cudaError_t code.
int mm_lambdarank(const void* score, const void* label, const void* weight, const void* offsets,
                  long long n_queries, long long n, int threads, int smem_rows, void* scratch,
                  const void* table, int n_table, int max_position, float sigma, void* grad,
                  void* hess, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  if (n_queries > 2147483647LL || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem_rows < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(smem_rows) * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lambdarank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return (int)e;
  }
  lambdarank_kernel<<<(unsigned)n_queries, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(score), static_cast<const float*>(label),
      static_cast<const float*>(weight), static_cast<const long long*>(offsets),
      static_cast<float*>(scratch), n, smem_rows, static_cast<const float*>(table), n_table,
      max_position, sigma, static_cast<float*>(grad), static_cast<float*>(hess));
  return (int)cudaGetLastError();
}

}  // extern "C"
