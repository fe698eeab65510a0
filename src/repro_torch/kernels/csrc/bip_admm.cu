// One BIP-ADMM dual iteration for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ../bip_admm.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bip_admm.py
// (bip_admm_iteration, body _iteration_kernel). For scores s (n, m) fp32,
// expert prices q (m,) and per-expert histogram edges (m, n_bins):
//   p_i        = max(0, (k+1)-th largest of s_i - q)           (n,)
//   hist[j][c] = #{ i : exactly c edges of expert j lie below s_ij - p_i }
// The wrapper turns hist into the TPU kernel's counts by a suffix sum:
//   counts[j][b] = #{ i : s_ij - p_i > edge_jb } = sum_{c > b} hist[j][c],
// which holds because each expert's edges are non-decreasing in b.
//
// What bounds it on this card: the function reads s once (n*m*4 bytes:
// 0.5 MB for 8192 tokens x 16 experts) and does ~(k+1 + log2 n_bins)
// compares per score, so it is bound by device memory at well under a
// microsecond; in practice a launch this small is bound by its own latency
// and by the per-block histogram flush. The design keeps every count out
// of device memory until the end of a block:
//  * blocks tile the rows (one thread per row) and a group of experts; the
//    ragged last tile is masked, nothing is padded (the TPU pads with -2);
//  * p by distinct values: each pass finds the largest value below the
//    previous one and its multiplicity, so at most k+1 passes over the
//    row's m scores give the (k+1)-th largest counted with ties, exactly
//    the value of the TPU's k+1 max-extraction passes;
//  * instead of the TPU's n_bins compares per score, a binary search in the
//    expert's edge row (shared memory) finds how many edges lie below
//    s_ij - p_i, and one shared-memory atomicAdd bumps that bin of an int32
//    histogram; the block flushes its non-zero bins with atomicAdd. Integer
//    counts make the order of the atomics irrelevant: the result is exact,
//    bit for bit the plain version's given the same edges;
//  * the edges are computed once by the wrapper in torch (the plain
//    version's own formula), so no fused multiply-add here can move an
//    edge by an ulp;
//  * shared memory per block is group*(n_bins floats + n_bins+1 ints):
//    33 KB for 8 experts at 512 bins. Experts are split over blockIdx.y in
//    groups of at most 8, so m = 16 and m = 64 (minimind-moe-64e) both fit;
//    above 48 KB (large n_bins) the launch raises the dynamic limit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;      // rows per block, one per thread
constexpr int GROUP = 8;          // experts per block (blockIdx.y)
constexpr float PAD_VALUE = -2.0f;  // (k+1)-th largest when a row has fewer lanes
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__global__ void __launch_bounds__(THREADS) bip_admm_iteration_kernel(
    const float* __restrict__ s, const float* __restrict__ q,
    const float* __restrict__ edges, float* __restrict__ p_out,
    int* __restrict__ hist, int n, int m, int top_k, int n_bins, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j0 = blockIdx.y * group;
  const int g = min(group, m - j0);
  const int nb1 = n_bins + 1;
  float* edges_sh = reinterpret_cast<float*>(smem);
  int* hist_sh = reinterpret_cast<int*>(edges_sh + static_cast<size_t>(group) * n_bins);

  for (int i = threadIdx.x; i < g * n_bins; i += THREADS)
    edges_sh[i] = edges[static_cast<size_t>(j0) * n_bins + i];
  for (int i = threadIdx.x; i < g * nb1; i += THREADS) hist_sh[i] = 0;
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (row < n) {
    const float* s_row = s + row * m;
    // (k+1)-th largest of x = s_row - q, ties counted: pass t finds the
    // largest value strictly below the previous pass's and how often it
    // occurs, until k+1 values are accounted for.
    float bound = INFINITY;
    float kth = PAD_VALUE;
    int need = top_k + 1;
    while (true) {
      float best = -INFINITY;
      int cnt = 0;
      for (int j = 0; j < m; ++j) {
        const float x = s_row[j] - q[j];
        if (x < bound) {
          if (x > best) {
            best = x;
            cnt = 1;
          } else if (x == best) {
            ++cnt;
          }
        }
      }
      if (cnt == 0) break;  // fewer than k+1 lanes: the TPU's pad value stands
      if (cnt >= need) {
        kth = best;
        break;
      }
      need -= cnt;
      bound = best;
    }
    const float p = fmaxf(kth, 0.0f);
    if (blockIdx.y == 0) p_out[row] = p;

    for (int jl = 0; jl < g; ++jl) {
      const float v = s_row[j0 + jl] - p;
      const float* e = edges_sh + jl * n_bins;
      int lo = 0, hi = n_bins;  // number of edges < v, by lower bound
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (e[mid] < v)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo > 0) atomicAdd(&hist_sh[jl * nb1 + lo], 1);  // bin 0 adds to no count
    }
  }
  __syncthreads();

  int* hist_blk = hist + static_cast<size_t>(j0) * nb1;
  for (int i = threadIdx.x; i < g * nb1; i += THREADS) {
    const int c = hist_sh[i];
    if (c != 0) atomicAdd(&hist_blk[i], c);
  }
}

}  // namespace

extern "C" {

// s (n, m) fp32 row-major, q (m,), edges (m, n_bins) non-decreasing per row,
// p (n,) out, hist (m, n_bins + 1) int32 out, zeroed by the caller.
// Returns cudaGetLastError() after the launch (0 on success).
int bip_admm_iteration(const void* s, const void* q, const void* edges, void* p,
                       void* hist, int n, int m, int top_k, int n_bins,
                       void* stream) {
  if (n <= 0 || m <= 0 || n_bins <= 0 || top_k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_expert =
      static_cast<size_t>(n_bins) * sizeof(float) + static_cast<size_t>(n_bins + 1) * sizeof(int);
  int group = m < GROUP ? m : GROUP;
  while (group > 1 && group * per_expert > MAX_SMEM) --group;
  const size_t smem = group * per_expert;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        bip_admm_iteration_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + THREADS - 1) / THREADS, (m + group - 1) / group);
  bip_admm_iteration_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(q),
      static_cast<const float*>(edges), static_cast<float*>(p),
      static_cast<int*>(hist), n, m, top_k, n_bins, group);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
