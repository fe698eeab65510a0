// K5: AdamW's step over every leaf of the params tree at once (multi-tensor),
// bound through a plain C interface (ctypes; see ../adamw_step.py).
//
// It replaces no TPU kernel: the reference's AdamW is plain jnp
// (src/repro/optim/adamw.py), so there is no pl.pallas_call to port. It was
// added because the port's plain AdamW updates each leaf in slices through
// ~17 fp32 elementwise kernels and three copies (clip scale, two moments,
// two bias corrections, sqrt, eps, the division, decay, lr, the stores):
// each reads and writes a whole fp32 slice, so a parameter moves ~200 bytes
// where 28 would do, and the global norm adds two kernels a leaf. With
// ~100-170 leaves that is ~2,000 launches a step.
//
//   k5_grad_sq       per-block sums of g^2 over a chunk of leaves (fp32
//                    squares, fp64 sums), into a fixed slot of a scratch
//   k5_norm_finish   one block adds the scratch in a fixed order and writes
//                    gnorm = sqrt(sum): no atomics, the same bits every call
//   k5_update        p, mu, nu <- AdamW(p, g * clip scale, mu, nu) in place
//                    for a chunk of leaves; the clip scale from gnorm and the
//                    guard from device pointers (no host sync); where the
//                    guard is false the kernel stores nothing
//
// Dtypes: the gradient takes the param's (as autograd gives it), the two
// moments one dtype; each float32 or bfloat16, as the port's configurations
// declare them (fp32 everywhere in minimind and granite, bf16 params and
// moments in llama4-scout and arctic, fp32 params beside bf16 moments where
// a reduced config keeps those).
//
// The leaf table (pointers, element counts, decay flags, the prefix of
// block starts) is a kernel parameter, passed by value: the gradients are
// new tensors every step, so a table on the device would be one more copy
// a step. A table holds MAX_LEAVES leaves (~3.2 KB of the 4 KB a launch
// takes); the caller cuts longer lists into chunks. Block b of a launch
// updates tile b - block_start[j] of leaf j, the last j with
// block_start[j] <= b (leaves of no element take no block).
//
// Numerics: the plain path's fp32 operations, rounded at the same places
// (../adamw_step.py `adamw_step_plain`), so the update is bit-equal given
// the same gnorm: __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn keep nvcc
// from contracting any pair into an FMA. Where PyTorch's CUDA kernels do
// something of their own it is mirrored: a tensor divided by a Python
// scalar is multiplied by the scalar's fp32 reciprocal (BinaryDivTrueKernel),
// so the bias corrections arrive as reciprocals; clamp propagates NaN; a
// bf16 gradient is scaled by the bf16-rounded scale and rounded to bf16.
//
// What bounds it on this card (H100 SXM, 3.35 TB/s): bytes. The norm reads
// g (4 B a parameter at fp32), the update reads p, g, mu, nu and writes p,
// mu, nu (28 B): 32 B a parameter, ~10 flops, far below the ridge. What the
// design does about it: every state array is read once and written once,
// nothing is kept in device memory between the operations, 16-byte vector
// accesses (4 fp32 or 4 bf16 a thread per access, 4 accesses in flight per
// array, all loads before any store), and a few launches a step: one norm
// launch per chunk, one finish, one update launch per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// entry-point codes besides CUDA's own errors (see ../adamw_step.py)
constexpr int BAD_DTYPE = -1;
constexpr int BAD_TABLE = -2;

constexpr int MAX_LEAVES = 64;
constexpr int THREADS = 256;
constexpr int VEC = 4;     // elements a thread reads per access
constexpr int UNROLL = 4;  // accesses a thread keeps in flight per array
constexpr long long TILE = (long long)THREADS * VEC * UNROLL;  // elements a block
constexpr int NORM_BLOCKS = 528;  // 4 per SM of the H100's 132
constexpr int FINISH_THREADS = 1024;
constexpr int F32 = 0;
constexpr int BF16 = 1;

struct Table {
  void* p[MAX_LEAVES];
  const void* g[MAX_LEAVES];
  void* mu[MAX_LEAVES];
  void* nu[MAX_LEAVES];
  long long n[MAX_LEAVES];
  long long block_start[MAX_LEAVES + 1];
  unsigned char decay[MAX_LEAVES];
  unsigned char vec[MAX_LEAVES];  // every pointer of the leaf on the vector grain
  int n_leaves;
};
static_assert(sizeof(Table) + 64 < 4096, "a launch's parameters");

struct Hyper {
  float lr, b1, omb1, b2, omb2, inv_c1, inv_c2, eps, wd, clip;
  int has_clip;
  const float* gnorm;
  const unsigned char* ok;  // null: no guard
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// 4 elements at a 4-element-aligned address: one 16-byte (fp32) or 8-byte
// (bf16) access
__device__ __forceinline__ void load4(const float* src, float (&o)[VEC]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* src, float (&o)[VEC]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(a); o[1] = __high2float(a); o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* dst, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* dst, const float (&v)[VEC]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 out;
  out.x = *reinterpret_cast<const unsigned*>(&a);
  out.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(dst) = out;
}

// the last leaf j of the table with block_start[j] <= b
__device__ __forceinline__ int find_leaf(const Table& t, long long b) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// the block's sum in a fixed order (shuffles, then the warps' sums in warp 0)
template <int NT>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[NT / 32];
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    if (lane < NT / 32) v = warp_sums[lane];
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // thread 0's is the block's
}

template <typename G>
__global__ void __launch_bounds__(THREADS) k5_grad_sq_kernel(const __grid_constant__ Table t, double* partials) {
  double acc = 0.0;
  const long long total = t.block_start[t.n_leaves];
  for (long long b = blockIdx.x; b < total; b += gridDim.x) {
    const int j = find_leaf(t, b);
    const G* g = static_cast<const G*>(t.g[j]);
    const long long n = t.n[j], start = (b - t.block_start[j]) * TILE;
    if (t.vec[j] && start + TILE <= n) {
      float x[UNROLL][VEC];
      #pragma unroll
      for (int u = 0; u < UNROLL; ++u) load4(g + start + ((long long)u * THREADS + threadIdx.x) * VEC, x[u]);
      #pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        #pragma unroll
        for (int e = 0; e < VEC; ++e) acc += (double)__fmul_rn(x[u][e], x[u][e]);
      }
    } else {
      const long long end = n < start + TILE ? n : start + TILE;
      for (long long i = start + threadIdx.x; i < end; i += THREADS) {
        const float x = to_f<G>(g[i]);
        acc += (double)__fmul_rn(x, x);
      }
    }
  }
  acc = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(FINISH_THREADS) k5_norm_finish_kernel(const double* partials, int n, float* gnorm) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += FINISH_THREADS) acc += partials[i];
  acc = block_sum<FINISH_THREADS>(acc);
  if (threadIdx.x == 0) *gnorm = __fsqrt_rn(__double2float_rn(acc));
}

// min(clip / max(gnorm, 1e-9), 1) with torch.clamp's NaN propagation (x != x:
// NaN, as nvcc compiles without fast math)
__device__ __forceinline__ float clip_scale(float gnorm, float clip) {
  const float den = gnorm != gnorm ? gnorm : fmaxf(gnorm, 1e-9f);
  const float s = __fdiv_rn(clip, den);
  return s != s ? s : fminf(s, 1.0f);
}

// One element, in the plain path's order:
//   mu' = b1 mu + (1-b1) g;  nu' = b2 nu + ((1-b2) g) g
//   d = (mu' * (1/c1)) / (sqrt(nu' * (1/c2)) + eps) [+ wd p];  p' = p - lr d
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m, float& v, const Hyper& h, bool decay) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float d = __fdiv_rn(__fmul_rn(m, h.inv_c1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_c2)), h.eps));
  if (decay) d = __fadd_rn(d, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, d));
}

template <typename P, typename M>
__global__ void __launch_bounds__(THREADS) k5_update_kernel(const __grid_constant__ Table t, const Hyper h) {
  if (h.ok != nullptr && !*h.ok) return;  // keep: the old state, untouched
  const long long b = blockIdx.x;
  const int j = find_leaf(t, b);
  const long long n = t.n[j], start = (b - t.block_start[j]) * TILE;
  P* p = static_cast<P*>(t.p[j]);
  const P* g = static_cast<const P*>(t.g[j]);
  M* mu = static_cast<M*>(t.mu[j]);
  M* nu = static_cast<M*>(t.nu[j]);
  const bool decay = t.decay[j];
  // the clip scale in the gradient's dtype (gs * scale.to(gs.dtype)), 1: none
  float scale = 1.0f;
  if (h.has_clip) scale = to_f<P>(from_f<P>(clip_scale(*h.gnorm, h.clip)));
  if (t.vec[j] && start + TILE <= n) {
    float pv[UNROLL][VEC], gv[UNROLL][VEC], mv[UNROLL][VEC], vv[UNROLL][VEC];
    #pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = start + ((long long)u * THREADS + threadIdx.x) * VEC;
      load4(p + i, pv[u]);
      load4(g + i, gv[u]);
      load4(mu + i, mv[u]);
      load4(nu + i, vv[u]);
    }
    #pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      #pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float gs = gv[u][e];
        if (h.has_clip) gs = to_f<P>(from_f<P>(__fmul_rn(gs, scale)));
        adamw_elem(pv[u][e], gs, mv[u][e], vv[u][e], h, decay);
      }
      const long long i = start + ((long long)u * THREADS + threadIdx.x) * VEC;
      float ps[VEC], ms[VEC], vs[VEC];
      #pragma unroll
      for (int e = 0; e < VEC; ++e) { ps[e] = pv[u][e]; ms[e] = mv[u][e]; vs[e] = vv[u][e]; }
      store4(p + i, ps);
      store4(mu + i, ms);
      store4(nu + i, vs);
    }
  } else {
    const long long end = n < start + TILE ? n : start + TILE;
    for (long long i = start + threadIdx.x; i < end; i += THREADS) {
      float pf = to_f<P>(p[i]), mf = to_f<M>(mu[i]), vf = to_f<M>(nu[i]), gs = to_f<P>(g[i]);
      if (h.has_clip) gs = to_f<P>(from_f<P>(__fmul_rn(gs, scale)));
      adamw_elem(pf, gs, mf, vf, h, decay);
      p[i] = from_f<P>(pf);
      mu[i] = from_f<M>(mf);
      nu[i] = from_f<M>(vf);
    }
  }
}

int elem_size(int dt) { return dt == BF16 ? 2 : 4; }

bool aligned(const void* ptr, int dt) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % (VEC * elem_size(dt)) == 0;
}

// The table of one launch, checked: 1..MAX_LEAVES leaves, block starts from
// 0 that give leaf j ceil(n_j / TILE) blocks. Null pointer lists are left
// null (the norm reads g only).
int fill_table(Table& t, int n_leaves, void* const* p, void* const* g, void* const* mu, void* const* nu,
               const long long* n, const long long* block_start, const unsigned char* decay, int p_dt, int m_dt) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || block_start[0] != 0) return BAD_TABLE;
  t = Table{};
  t.n_leaves = n_leaves;
  for (int j = 0; j < n_leaves; ++j) {
    if (n[j] < 0 || block_start[j + 1] - block_start[j] != (n[j] + TILE - 1) / TILE) return BAD_TABLE;
    t.p[j] = p ? p[j] : nullptr;
    t.g[j] = g[j];
    t.mu[j] = mu ? mu[j] : nullptr;
    t.nu[j] = nu ? nu[j] : nullptr;
    t.n[j] = n[j];
    t.decay[j] = decay ? decay[j] : 0;
    t.vec[j] = aligned(t.p[j], p_dt) && aligned(t.g[j], p_dt) && aligned(t.mu[j], m_dt) &&
               aligned(t.nu[j], m_dt);
  }
  for (int j = 0; j <= n_leaves; ++j) t.block_start[j] = block_start[j];
  if (block_start[n_leaves] > 0x7fffffffLL) return BAD_TABLE;
  return 0;
}

template <typename P, typename M>
int launch_update(const Table& t, const Hyper& h, cudaStream_t stream) {
  const long long blocks = t.block_start[t.n_leaves];
  if (blocks == 0) return 0;
  k5_update_kernel<P, M><<<(unsigned)blocks, THREADS, 0, stream>>>(t, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 0: leaves a table, 1: elements a block, 2: blocks a norm launch
long long k5_limits(int which) {
  return which == 0 ? MAX_LEAVES : which == 1 ? TILE : which == 2 ? NORM_BLOCKS : -1;
}

// Per-block sums of g^2 over one chunk into partials[0 .. NORM_BLOCKS).
int k5_grad_sq(int g_dt, int n_leaves, void* const* g, const long long* n, const long long* block_start,
               double* partials, void* stream) {
  if (g_dt != F32 && g_dt != BF16) return BAD_DTYPE;
  Table t;
  if (int rc = fill_table(t, n_leaves, nullptr, g, nullptr, nullptr, n, block_start, nullptr, g_dt, F32)) return rc;
  auto s = static_cast<cudaStream_t>(stream);
  if (g_dt == F32) k5_grad_sq_kernel<float><<<NORM_BLOCKS, THREADS, 0, s>>>(t, partials);
  else k5_grad_sq_kernel<bf16><<<NORM_BLOCKS, THREADS, 0, s>>>(t, partials);
  return (int)cudaGetLastError();
}

// gnorm = sqrt(sum of partials[0 .. n)), in a fixed order.
int k5_norm_finish(const double* partials, int n, float* gnorm, void* stream) {
  k5_norm_finish_kernel<<<1, FINISH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(partials, n, gnorm);
  return (int)cudaGetLastError();
}

// One AdamW step over one chunk of leaves, in place. p_dt: the dtype code
// of the params and grads, m_dt: of both moments; scalars: lr, b1, 1 - b1,
// b2, 1 - b2, 1 / c1, 1 / c2, eps, weight decay, clip norm; gnorm (fp32)
// and ok (bool, or null) on the device.
int k5_update(int p_dt, int m_dt, int n_leaves, void* const* p, void* const* g, void* const* mu, void* const* nu,
              const long long* n, const long long* block_start, const unsigned char* decay, const float* scalars,
              int has_clip, const float* gnorm, const unsigned char* ok, void* stream) {
  if ((p_dt != F32 && p_dt != BF16) || (m_dt != F32 && m_dt != BF16)) return BAD_DTYPE;
  Table t;
  if (int rc = fill_table(t, n_leaves, p, g, mu, nu, n, block_start, decay, p_dt, m_dt)) return rc;
  const Hyper h{scalars[0], scalars[1], scalars[2], scalars[3], scalars[4], scalars[5], scalars[6],
                scalars[7], scalars[8], scalars[9], has_clip, gnorm, ok};
  auto s = static_cast<cudaStream_t>(stream);
  if (p_dt == F32) return m_dt == F32 ? launch_update<float, float>(t, h, s) : launch_update<float, bf16>(t, h, s);
  return m_dt == F32 ? launch_update<bf16, float>(t, h, s) : launch_update<bf16, bf16>(t, h, s);
}

}  // extern "C"
