// The whole BIP-ADMM dual update of one MoE layer in one launch, for Hopper
// (sm_90a), bound through a plain C interface (ctypes; see ../bip_admm.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bip_admm.py
// (bip_admm_iteration, body _iteration_kernel) together with the jnp that
// runs around it: locate_bin, q_from_histogram and the fori_loop of
// src/repro/kernels/ops.py (bip_dual_update, single-device form). For
// scores s (n, m) fp32 and warm-start prices q0 (m,), T outer iterations of
//   p_i  = max(0, (k+1)-th largest of s_i - q)                     (rows)
//   then refine + 1 histogram passes per expert j over [lo_j, hi_j):
//     counts[j][b] = #{ i : s_ij - p_i > edge_jb },
//     edge_jb      = lo_j + (hi_j - lo_j) * (b / n_bins),
//   after each pass the bin of the (rank+1)-th largest narrows [lo_j, hi_j);
//   after the last, q_j is interpolated in it (over the bounds that pass
//   was counted on, not the narrowed ones).
// One launch returns q. The same kernel, with T = 1 and no refinement,
// exports p and the fp32 counts of one pass over given bounds: the TPU
// kernel's own (p, counts) contract (`bip_admm_iteration`).
//
// What bounds it on this card: the update reads s once (n*m*4 bytes, 0.5 MB
// at n = 8192, m = 16) and does T*n*m*((refine+1)*ceil(log2(n_bins+1)) +
// k+1) fp32 compares: under a microsecond of memory or arithmetic. The
// work is a chain of 2*T(refine+1) dependent histogram passes, each ending
// in an order statistic that the next pass needs, so what bounds it in
// practice is latency on 16 SMs: per pass, each thread places its row's m
// scores one expert after another (load, shift, place, warp match, remote
// add), then two cluster barriers and an owner phase. The old form took 2T
// launches and ~40 torch ops per pass on the host. Here:
//  * one thread-block cluster (16 CTAs where the card can place them,
//    else 8; chosen by the wrapper, a launch parameter) runs the whole
//    update. There is no grid-wide sync, no global atomic, no host sync;
//  * the CTAs split the rows. Each CTA stages its rows' scores once in
//    shared memory, column by column with an odd stride (no bank
//    conflicts); rows beyond what shared memory holds are re-read from L2;
//  * p once per outer iteration, kept in shared memory through the refine
//    passes: for k+1 <= 9 one sweep over the row keeps the k+1 largest of
//    s_i - q, duplicates included, sorted in registers; for larger k, at
//    most k+1 sweeps over distinct values. Either gives the (k+1)-th
//    largest counted with ties (PAD_VALUE when the row has fewer lanes);
//  * histograms in distributed shared memory: expert j's int32 histogram
//    of n_bins + 1 bins lives in CTA j % cluster (hist[c] = rows with
//    exactly c edges below the shifted score; the counts are its suffix
//    sums). A thread places its score among the edges (one compare each
//    for the scores below edge 0 or above the last; else an estimate from
//    the uniform spacing, checked against the exact edges on either side,
//    binary search when the check fails), the warp aggregates equal bins
//    (__match_any_sync) and its leader adds the popcount into the owner's
//    shared memory (cluster.map_shared_rank). Each CTA walks the experts
//    from its own. A full histogram per CTA (m*(n_bins+1)*4 B: 262 KB at
//    m = 128) would not fit; the owner split keeps every m;
//  * after each pass the cluster syncs; each owner warp runs the suffix sum
//    of its expert, locates b* = last edge whose count > rank, writes the
//    new (lo_j, hi_j) - or on an iteration's last pass q_j - into every
//    CTA's shared memory, zeroes the histogram, and the cluster syncs again;
//  * bit-equality with the plain torch loop: every edge, width, bin bound,
//    fraction and q is formed with __fadd_rn / __fsub_rn / __fmul_rn /
//    __fdiv_rn, in the plain version's order, so nvcc contracts nothing
//    into an FMA. n_bins is a power of two (the wrapper refuses others), so
//    b / n_bins and (hi - lo) / n_bins are exact as products with 1/n_bins,
//    whatever way either side divides. Counts are integers; the order of
//    the atomics cannot change them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr float LO = -1.0f;         // score domain: s in [0, 1], minus p in [0, 1]
constexpr float HI = 1.0f;
constexpr float PAD_VALUE = -2.0f;  // (k+1)-th largest when a row has fewer lanes
constexpr int MAX_SMEM = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 4;  // experts placed together by one thread

// negative return codes of the entry points (the wrapper names them)
constexpr int ERR_LAYOUT = -1;  // the plan's shared bytes disagree with the layout below
constexpr int ERR_SMEM = -2;    // shared memory over the 227 KB a block may use

struct Params {
  const float* s;
  const float* q0;
  const float* lo0;  // per-expert bounds of the single-pass mode, else null
  const float* hi0;
  float* q_out;       // dual-update mode
  float* p_out;       // single-pass mode: p (n,) and counts (m, n_bins)
  float* counts_out;
  int n, m, top_k, rank, n_iters, refine, n_bins;
  int rows_per_cta, resident_rows, s_stride, experts_per_owner;
};

// shared memory, in floats/ints: four edge terms per expert (4m), q, lo and
// hi (m each), the owned histograms (experts_per_owner * (n_bins + 1)), p of
// the CTA's rows (rows_per_cta), the resident scores (m * s_stride)
__host__ __device__ inline long long smem_words(int m, int n_bins, int rows_per_cta,
                                               int s_stride, int experts_per_owner) {
  return 7LL * m + static_cast<long long>(experts_per_owner) * (n_bins + 1) + rows_per_cta +
         static_cast<long long>(m) * s_stride;
}

// edge b of an expert: lo + (hi - lo) * (b / n_bins), d = hi - lo rounded
__device__ __forceinline__ float edge_at(float lo, float d, int b, float inv_bins) {
  return __fadd_rn(lo, __fmul_rn(d, __fmul_rn(static_cast<float>(b), inv_bins)));
}

// The number of an expert's edges strictly below v (0..n_bins), for
// edge 0 = lo < v <= top = edge n_bins-1: an estimate from the uniform
// spacing, checked against the exact edges on either side; -1 when the
// check fails (search() then decides).
__device__ __forceinline__ int place(float v, float4 e, int n_bins, float inv_bins) {
  const float lo = e.x, d = e.y, inv_width = e.z;
  const float t = fminf(fmaxf(__fmul_rn(__fsub_rn(v, lo), inv_width), 1.0f),
                        static_cast<float>(n_bins - 1));
  const int c = static_cast<int>(ceilf(t));
  const bool ok = edge_at(lo, d, c - 1, inv_bins) < v && !(edge_at(lo, d, c, inv_bins) < v);
  return ok ? c : -1;
}

// the same count by binary search, for lo < v <= top
__device__ __noinline__ int search(float v, float4 e, int n_bins, float inv_bins) {
  const float lo = e.x, d = e.y;
  int below = 0, at_or_above = n_bins - 1;  // edge(below) < v <= edge(at_or_above)
  while (at_or_above - below > 1) {
    const int mid = (below + at_or_above) >> 1;
    if (edge_at(lo, d, mid, inv_bins) < v)
      below = mid;
    else
      at_or_above = mid;
  }
  return at_or_above;
}

// The scores of a CTA's row r: in shared memory for the resident rows
// (column-major, odd stride), else in device memory (L2). One generic
// pointer and step per row, so reading a score takes no branch. Passed by
// value, so that nothing of it lives in local memory.
struct Row {
  const float* at;
  int step;
  __device__ __forceinline__ float operator[](int j) const { return at[j * step]; }
};
struct Scores {
  const float* sh;
  const float* dev;
  int resident, stride, m;
  __device__ __forceinline__ Row row(int r) const {
    return r < resident ? Row{sh + r, stride} : Row{dev + static_cast<long long>(r) * m, 1};
  }
};

// The (k+1)-th largest of x_j = s_rj - q_j, j < m, counted with ties (the
// value torch.topk(x, k+1).values[k] gives), or PAD_VALUE when m < k+1.
// K1 = k+1 <= 9: one sweep keeps the K1 largest values, duplicates
// included, sorted in registers.
template <int K1>
__device__ __forceinline__ float kth_by_list(const Row s, const float* q, int m) {
  float top[K1];
#pragma unroll
  for (int i = 0; i < K1; ++i) top[i] = -INFINITY;
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    const float x = __fsub_rn(s[j], q[j]);
    if (x > top[K1 - 1]) {
#pragma unroll
      for (int i = K1 - 1; i > 0; --i) top[i] = x > top[i - 1] ? top[i - 1] : fmaxf(top[i], x);
      top[0] = fmaxf(top[0], x);
    }
  }
  return m >= K1 ? top[K1 - 1] : PAD_VALUE;
}

// any k: each sweep finds the largest value below the previous sweep's and
// how often it occurs, until k+1 values are accounted for
__device__ __noinline__ float kth_by_sweeps(const Row s, const float* q, int m, int top_k) {
  float bound = INFINITY;
  int need = top_k + 1;
  while (true) {
    float best = -INFINITY;
    int cnt = 0;
    for (int j = 0; j < m; ++j) {
      const float x = __fsub_rn(s[j], q[j]);
      if (x < bound) {
        if (x > best) {
          best = x;
          cnt = 1;
        } else if (x == best) {
          ++cnt;
        }
      }
    }
    if (cnt == 0) return PAD_VALUE;  // fewer than k+1 lanes: the TPU's pad value
    if (cnt >= need) return best;
    need -= cnt;
    bound = best;
  }
}

__global__ void __launch_bounds__(THREADS, 1) bip_dual_update_kernel(const Params a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cta = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int m = a.m, n_bins = a.n_bins, nb1 = n_bins + 1, epo = a.experts_per_owner;
  const float inv_bins = 1.0f / static_cast<float>(n_bins);  // exact: a power of two

  // per expert: lo, hi - lo, n_bins / (hi - lo) (for the estimate only),
  // edge n_bins-1 of the current pass
  float4* edge_sh = reinterpret_cast<float4*>(smem);
  float* q_sh = smem + 4 * m;
  float* lo_sh = q_sh + m;
  float* hi_sh = lo_sh + m;
  int* hist_sh = reinterpret_cast<int*>(hi_sh + m);
  float* p_sh = reinterpret_cast<float*>(hist_sh + epo * nb1);
  float* s_sh = p_sh + a.rows_per_cta;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(cta) * a.rows_per_cta;
  const int rows = static_cast<int>(max(0LL, min(static_cast<long long>(a.rows_per_cta), a.n - row0)));
  const int resident = min(rows, a.resident_rows);
  const float* s_cta = a.s + row0 * m;
  const Scores score{s_sh, s_cta, resident, a.s_stride, m};

  // stage the resident rows (coalesced reads, column-major writes), q0,
  // and zero the owned histograms
  for (int e = tid; e < resident * m; e += THREADS) {
    const int r = e / m, j = e - r * m;
    s_sh[j * a.s_stride + r] = __ldg(s_cta + e);
  }
  for (int j = tid; j < m; j += THREADS) q_sh[j] = a.q0[j];
  for (int i = tid; i < epo * nb1; i += THREADS) hist_sh[i] = 0;
  // every CTA of the cluster has started (its shared memory exists) before
  // anyone writes into it
  cluster.sync();

  const bool export_mode = a.counts_out != nullptr;
  // expert j is owned by CTA j % n_cta (a power of two), as its histogram
  // j / n_cta there; each CTA walks the experts from its own first
  const int cshift = __ffs(n_cta) - 1;
  const int first_j = cta < m ? cta : 0;

  for (int t = 0; t < a.n_iters; ++t) {
    for (int j = tid; j < m; j += THREADS) {
      lo_sh[j] = a.lo0 ? a.lo0[j] : LO;
      hi_sh[j] = a.hi0 ? a.hi0[j] : HI;
    }
    // p of this CTA's rows from q: the (k+1)-th largest of s_i - q, ties
    // counted
    for (int r = tid; r < rows; r += THREADS) {
      const Row row = score.row(r);
      float kth;
      switch (a.top_k) {  // uniform: the sorted list lives in registers
        case 0: kth = kth_by_list<1>(row, q_sh, m); break;
        case 1: kth = kth_by_list<2>(row, q_sh, m); break;
        case 2: kth = kth_by_list<3>(row, q_sh, m); break;
        case 3: kth = kth_by_list<4>(row, q_sh, m); break;
        case 4: kth = kth_by_list<5>(row, q_sh, m); break;
        case 5: kth = kth_by_list<6>(row, q_sh, m); break;
        case 6: kth = kth_by_list<7>(row, q_sh, m); break;
        case 7: kth = kth_by_list<8>(row, q_sh, m); break;
        case 8: kth = kth_by_list<9>(row, q_sh, m); break;
        default: kth = kth_by_sweeps(row, q_sh, m, a.top_k);
      }
      const float p = fmaxf(kth, 0.0f);
      p_sh[r] = p;
      if (export_mode) a.p_out[row0 + r] = p;
    }

    for (int pass = 0; pass <= a.refine; ++pass) {
      const bool last = pass == a.refine;
      __syncthreads();  // lo/hi of this pass are in place
      for (int j = tid; j < m; j += THREADS) {
        const float lo = lo_sh[j], d = __fsub_rn(hi_sh[j], lo);
        edge_sh[j] = make_float4(lo, d, static_cast<float>(n_bins) / d,
                                 edge_at(lo, d, n_bins - 1, inv_bins));
      }
      __syncthreads();

      // histogram pass: one row per thread, every expert, UNROLL experts at
      // a time so that their placements overlap. A score at or below edge 0
      // counts nowhere and one above the last edge lands in bin n_bins (one
      // compare each; the estimate is formed for every score all the same,
      // so that the code stays straight-line).
      for (int r0 = 0; r0 < rows; r0 += THREADS) {  // uniform over the CTA
        const int r = r0 + tid;
        const bool valid = r < rows;
        const float p = valid ? p_sh[r] : 0.0f;
        const Row row = score.row(valid ? r : 0);
        for (int jj = 0; jj < m; jj += UNROLL) {
          int js[UNROLL], cs[UNROLL];
          float vs[UNROLL];
          float4 es[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {  // loads first, then straight-line placement
            const int x = first_j + jj + u;
            js[u] = jj + u < m ? (x >= m ? x - m : x) : first_j;
            es[u] = edge_sh[js[u]];
            vs[u] = row[js[u]];
          }
          bool any_search = false;
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const float v = __fsub_rn(vs[u], p);
            vs[u] = v;
            const int c = place(v, es[u], n_bins, inv_bins);
            cs[u] = !(valid && jj + u < m) || !(v > es[u].x) ? 0 : (v > es[u].w ? n_bins : c);
            any_search |= cs[u] < 0;
          }
          if (__any_sync(FULL, any_search)) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
              if (cs[u] < 0) cs[u] = search(vs[u], es[u], n_bins, inv_bins);
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int j = js[u];
            const int c = cs[u];
            const unsigned peers = __match_any_sync(FULL, c);
            if (c > 0 && lane == __ffs(peers) - 1) {  // bin 0 adds to no count
              int* h = cluster.map_shared_rank(hist_sh, j & (n_cta - 1)) + (j >> cshift) * nb1;
              atomicAdd(h + c, __popc(peers));
            }
          }
        }
      }
      cluster.sync();  // every count is in its owner's histogram

      // owners: one warp per owned expert
      for (int jl = warp; jl < epo; jl += WARPS) {
        const int j = cta + (jl << cshift);
        if (j >= m) break;
        int* h = hist_sh + jl * nb1;
        // in-place inclusive suffix sum: h[c] = rows with >= c edges below,
        // so counts[b] = h[b + 1]
        const int chunk = (nb1 + 31) / 32;
        const int beg = min(nb1, lane * chunk), end = min(nb1, beg + chunk);
        int own = 0;
#pragma unroll 8
        for (int c = beg; c < end; ++c) own += h[c];
        int incl = own;
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_down_sync(FULL, incl, off);
          if (lane + off < 32) incl += y;
        }
        int run = incl - own;
#pragma unroll 8
        for (int c = end - 1; c >= beg; --c) {
          run += h[c];
          h[c] = run;
        }
        __syncwarp();
        if (export_mode) {
          for (int b = lane; b < n_bins; b += 32)
            a.counts_out[static_cast<long long>(j) * n_bins + b] = static_cast<float>(h[b + 1]);
        } else {
          // b* + 1 = number of edges whose count exceeds rank (counts fall in b)
          int above = 0;
#pragma unroll 8
          for (int b = lane; b < n_bins; b += 32) above += h[b + 1] > a.rank;
          for (int off = 16; off > 0; off >>= 1) above += __shfl_xor_sync(FULL, above, off);
          const bool found = above > 0;
          const int b_clip = found ? above - 1 : 0;
          const float lo = lo_sh[j], hi = hi_sh[j];
          const float width = __fmul_rn(__fsub_rn(hi, lo), inv_bins);  // (hi - lo) / n_bins
          const float bin_lo = __fadd_rn(lo, __fmul_rn(static_cast<float>(b_clip), width));
          float v0, v1 = 0.0f;
          if (!last) {  // narrow to the located bin
            v0 = found ? bin_lo : lo;
            v1 = found ? __fadd_rn(bin_lo, width) : hi;
          } else {  // q_j, interpolated in the bin over this pass's bounds
            const float c_lo = static_cast<float>(h[b_clip + 1]);
            const float c_hi = b_clip + 1 < n_bins ? static_cast<float>(h[b_clip + 2]) : 0.0f;
            const float frac = __fdiv_rn(__fsub_rn(c_lo, static_cast<float>(a.rank)),
                                         fmaxf(__fsub_rn(c_lo, c_hi), 1.0f));
            const float v = __fadd_rn(bin_lo, __fmul_rn(fminf(fmaxf(frac, 0.0f), 1.0f), width));
            v0 = found ? fmaxf(v, 0.0f) : 0.0f;
          }
          __syncwarp();  // every lane has read lo/hi before they are overwritten
          for (int dst = lane; dst < n_cta; dst += 32) {
            if (!last) {
              *cluster.map_shared_rank(lo_sh + j, dst) = v0;
              *cluster.map_shared_rank(hi_sh + j, dst) = v1;
            } else {
              *cluster.map_shared_rank(q_sh + j, dst) = v0;
            }
          }
          if (last && t == a.n_iters - 1 && lane == 0) a.q_out[j] = v0;
        }
        __syncwarp();
#pragma unroll 8
        for (int c = lane; c < nb1; c += 32) h[c] = 0;
      }
      cluster.sync();  // new bounds (or q) everywhere, histograms zeroed
    }
  }
}

cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(bip_dual_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bip_dual_update_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t launch_config(int cluster, int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

extern "C" {

int bip_admm_threads() { return THREADS; }

// How many clusters of `cluster` CTAs with `smem_bytes` of shared memory
// each the device can hold at once (0: it cannot place one).
int bip_admm_max_active_clusters(int cluster, int smem_bytes, int device, int* out) {
  *out = 0;
  if (smem_bytes > MAX_SMEM) return ERR_SMEM;
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = set_attributes();
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config = launch_config(cluster, smem_bytes, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(out, bip_dual_update_kernel, &config);
  }
  const cudaError_t back = cudaSetDevice(previous);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

// One launch: the whole dual update (counts_out null: writes q_out) or one
// pass over the given bounds (counts_out set: writes p_out and counts_out,
// (m, n_bins) fp32). s (n, m) fp32 row-major; q0, lo, hi (m,) (lo, hi null:
// [-1, 1) every iteration). The plan's numbers come from the wrapper
// (bip_admm.launch_plan). Returns 0, a CUDA error, or ERR_*.
int bip_admm_dual(const void* s, const void* q0, const void* lo, const void* hi, void* q_out,
                  void* p_out, void* counts_out, int n, int m, int top_k, int rank, int n_iters,
                  int refine, int n_bins, int cluster, int rows_per_cta, int resident_rows,
                  int s_stride, int experts_per_owner, int smem_bytes, int device,
                  void* stream) {
  if (n <= 0 || m <= 0 || n_bins <= 0 || top_k < 0 || n_iters <= 0 || refine < 0 ||
      (cluster != 8 && cluster != 16) || resident_rows > rows_per_cta ||
      experts_per_owner * cluster < m)
    return static_cast<int>(cudaErrorInvalidValue);
  if (4 * smem_words(m, n_bins, rows_per_cta, s_stride, experts_per_owner) != smem_bytes)
    return ERR_LAYOUT;
  if (smem_bytes > MAX_SMEM) return ERR_SMEM;
  // launch on the tensors' device, from any thread, and leave the caller's
  // current device as it was
  static bool attributes_set[64] = {};
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || !attributes_set[device]) {
    err = set_attributes();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) attributes_set[device] = true;
  }
  Params a;
  a.s = static_cast<const float*>(s);
  a.q0 = static_cast<const float*>(q0);
  a.lo0 = static_cast<const float*>(lo);
  a.hi0 = static_cast<const float*>(hi);
  a.q_out = static_cast<float*>(q_out);
  a.p_out = static_cast<float*>(p_out);
  a.counts_out = static_cast<float*>(counts_out);
  a.n = n;
  a.m = m;
  a.top_k = top_k;
  a.rank = rank;
  a.n_iters = n_iters;
  a.refine = refine;
  a.n_bins = n_bins;
  a.rows_per_cta = rows_per_cta;
  a.resident_rows = resident_rows;
  a.s_stride = s_stride;
  a.experts_per_owner = experts_per_owner;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      launch_config(cluster, smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&config, bip_dual_update_kernel, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (previous != device) {
    const cudaError_t back = cudaSetDevice(previous);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
