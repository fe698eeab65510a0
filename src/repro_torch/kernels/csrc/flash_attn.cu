// K4: fused causal attention for Hopper (sm_90a), forward and backward,
// bound through a plain C interface (ctypes; see ../flash_attn.py).
//
// It replaces no TPU kernel: the reference's attention is plain jnp
// (src/repro/models/common.py `attention`, `_attend`), so there is no
// pl.pallas_call to port. It was added because the port's plain chunked
// attention (models/common.py `_attend`) sends every (B, H, 512, S) score
// block through device memory eight or more times (bf16 einsum, fp32 cast,
// scale, mask, softmax, mask, bf16 cast, PV einsum), scores the masked half
// above the diagonal, and keeps 6 bytes a score for its backward.
//
//   flash_attn_fwd   o = softmax(q k^T / sqrt(hd), causal) v, and the fp32
//                    log-sum-exp of every row (for the backward)
//   flash_attn_bwd   delta = rowsum(do * o) (a pre-pass), then dk and dv over
//                    key tiles, then dq over query tiles: no atomics, so the
//                    gradients are the same from run to run
//
// q (B, S, H, hd), k and v (B, S, KV, hd) are read where they lie: a row
// stride of H*hd (or any stride that is a multiple of 16 bytes), kv head
// h / (H / KV) for GQA, no transpose, no repeat, no padding of S: rows past
// S read as zero (cp.async's zero fill) and are never written. The
// log-sum-exp and delta rows are padded to a multiple of the tile, so their
// tiles load whole; a padded row has a finite log-sum-exp and zero dO, and
// adds exact zeros to dk and dv.
//
// Numerics (the contract of the plain path, no lower precision): products
// in bf16 on the tensor cores into fp32 accumulators; logits stay fp32 from
// the accumulator (the plain path rounds them to bf16 first), scaled by
// 1/sqrt(hd); softmax, running max and sums in fp32; P rounded to bf16
// before PV, as `_attend` rounds its weights before its PV einsum; dP and
// dS in fp32, dS rounded to bf16 before dQ = dS K and dK = dS^T Q.
//
// What bounds it on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): the
// tensor-core operations. A (query, key) pair costs 4*hd FLOP forward (QK^T
// and PV) while q, k, v and o are read or written once per 64-row tile, far
// above the ridge (~295 FLOP/byte) at the training lengths. The work is the
// causal half of S^2: 2 S^2 hd FLOP per (batch, head) forward. What the
// design does about it:
//   - mma.sync m16n8k16 (bf16 in, fp32 accumulate): at hd 64 a warp's
//     16-row slice of a 64 x 64 tile is 32 mma per product, and every
//     intermediate (S, P, dP, dS) stays in registers: the C fragment of one
//     product is the A fragment of the next with no shared-memory trip;
//   - one algorithm and tile shape for hd 64 and 128; what adapts is where
//     a warp's fixed A operand (q, k, v or dO rows) lives: in registers,
//     except in the backward at hd 128, whose two 16 x 128 fp32
//     accumulators take the registers, so it is re-read from its shared
//     tile at each use (`ARows`);
//   - ldmatrix (plain and .trans) feeds the B operands from shared memory
//     rows padded by 16 bytes, so the eight row addresses of a phase fall on
//     eight distinct 4-bank groups (no bank conflicts), and one row-major
//     tile serves both as K x N and as N x K;
//   - cp.async double buffering: the next key (or query) tile is in flight
//     while the current one is multiplied;
//   - the causal walk stops at the diagonal tile (the only one masked), and
//     the blocks with the longest walks are launched first;
//   - the exponentials are ex2.approx on logits pre-scaled by log2(e).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// entry-point codes besides CUDA's own errors (see ../flash_attn.py)
constexpr int BAD_HEAD_DIM = -1;
constexpr int BAD_SHAPE = -2;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // query rows of a tile: 16 per warp
constexpr int BN = 64;          // key rows of a tile
static_assert(BM == BN, "the causal walk pairs query and key tiles of one size");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragment addressing (lane l of a warp; g = l / 4, t = l % 4). For an
// m16n8k16 product a warp holds C as c[0..1] = (row g, cols 2t, 2t+1) and
// c[2..3] = (row g + 8, same cols); the A fragment of 16 x 16 takes two
// neighbouring C tiles: a = {C_j[0,1], C_j[2,3], C_j+1[0,1], C_j+1[2,3]}.
//
// A fragment (16 x 16) of a row-major tile at (r0, c0):
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
// B fragments of two n-tiles (16 n x 16 k) from a tile stored N x K
// row-major (plain ldmatrix): rows n0 + b_row, cols k0 + b_col
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }
// B fragments of two n-tiles from a tile stored K x N row-major
// (ldmatrix .trans): rows k0 + a_row, cols n0 + a_col

// rows [row0, row0 + 64) of a (S, hd) slice with row stride `ld_g`
// (elements) into a shared tile of row stride LD; rows >= S read as zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t ld_g, int row0, int S) {
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  constexpr int LD = HD + 8;
#pragma unroll
  for (int c = threadIdx.x; c < BN * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * LD + col, src + (ok ? (int64_t)(row0 + r) * ld_g + col : 0), ok);
  }
}

// 64 fp32 values (a padded row tile of lse or delta) into shared memory
__device__ __forceinline__ void load_row_stats(float* dst, const float* src) {
  if (threadIdx.x < BM / 4) cp_async16(dst + 4 * threadIdx.x, src + 4 * threadIdx.x, true);
}

// The A operand of a product against shared tiles: this warp's 16 rows of
// a shared row-major tile (16 x HD). REGS: its fragments are read once into
// registers (HD 64 everywhere, the forward at any HD); else they are read
// from the tile at each use, where the backward's two HD-wide accumulators
// take the registers (HD 128). The tile must then stay put.
template <int HD, bool REGS>
struct ARows {
  uint32_t f[REGS ? HD / 16 : 1][4];
  const bf16* at;  // this lane's ldmatrix address in the warp's rows

  __device__ __forceinline__ void init(const bf16* tile, int warp, int lane) {
    at = tile + (warp * 16 + a_row(lane)) * (HD + 8) + a_col(lane);
    if constexpr (REGS) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(f[kk], at + kk * 16);
    }
  }
  __device__ __forceinline__ void frag(int kk, uint32_t (&r)[4]) const {
    if constexpr (REGS) {
      r[0] = f[kk][0], r[1] = f[kk][1], r[2] = f[kk][2], r[3] = f[kk][3];
    } else {
      ldsm_x4(r, at + kk * 16);
    }
  }
};

// acc (16 x 64) += A (16 x HD) * T^T, T a 64 x HD shared tile (N x K)
template <int HD, bool REGS>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const ARows<HD, REGS>& a, const bf16* t, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    a.frag(kk, af);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, t + (np * 16 + b_row(lane)) * LD + kk * 16 + b_col(lane));
      mma(acc[2 * np], af, b[0], b[1]);
      mma(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// acc (16 x HD) += A (16 x 64, fragments) * T, T a 64 x HD shared tile (K x N)
template <int HD>
__device__ __forceinline__ void mma_ab(float (&acc)[HD / 8][4], const uint32_t (&a)[4][4], const bf16* t,
                                       int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, t + (kk * 16 + a_row(lane)) * LD + dp * 16 + a_col(lane));
      mma(acc[2 * dp], a[kk], b[0], b[1]);
      mma(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
}

// C fragments of 16 x 64 (fp32) as bf16 A fragments over the 64 columns
__device__ __forceinline__ void to_a_frags(uint32_t (&f)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    f[nt / 2][(nt % 2) * 2] = pack_bf16(c[nt][0], c[nt][1]);
    f[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

// 16 x HD fp32 fragments, times `mul`, as bf16 rows of global memory
// (rows >= S skipped)
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ld_g, const float (&acc)[HD / 8][4], int row,
                                           int S, float mul0, float mul1, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + half * 8;
    if (r >= S) continue;
    const float mul = half ? mul1 : mul0;
    bf16* p = dst + (int64_t)r * ld_g + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(p + dt * 8) =
          pack_bf16(acc[dt][2 * half] * mul, acc[dt][2 * half + 1] * mul);
  }
}

// ----------------------------------------------------------------- forward

// grid (B*H, ceil(S/BM)); blockIdx.y = 0 takes the last query tile (the
// longest walk), so the heaviest blocks start first
template <int HD>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const bf16* __restrict__ q, int64_t qb, int64_t qs, int64_t qh, const bf16* __restrict__ k,
               int64_t kb, int64_t ks, int64_t kh, const bf16* __restrict__ v, int64_t vb, int64_t vs,
               int64_t vh, bf16* __restrict__ o, int64_t ob, int64_t os, int64_t oh, float* __restrict__ lse,
               int S, int S_pad, int H, int groups, float scale_log2) {
  constexpr int LD = HD + 8;
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LD;      // two stages
  bf16* sV = sK + 2 * BN * LD;  // two stages

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / groups;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row = qt * BM + warp * 16 + g;  // this thread's rows: row, row + 8

  const bf16* qp = q + b * qb + h * qh;
  const bf16* kp = k + b * kb + hk * kh;
  const bf16* vp = v + b * vb + hk * vh;
  load_tile<HD>(sQ, qp, qs, qt * BM, S);
  load_tile<HD>(sK, kp, ks, 0, S);
  load_tile<HD>(sV, vp, vs, 0, S);
  cp_async_commit();

  ARows<HD, true> qf;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j <= qt; ++j) {
    const int st = j & 1;
    if (j < qt) {
      load_tile<HD>(sK + (st ^ 1) * BN * LD, kp, ks, (j + 1) * BN, S);
      load_tile<HD>(sV + (st ^ 1) * BN * LD, vp, vs, (j + 1) * BN, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) qf.init(sQ, warp, lane);

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma_abt(s, qf, sK + st * BN * LD, lane);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (j == qt && j * BN + nt * 8 + 2 * t + (e & 1) > row + (e >> 1) * 8) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // every row sees key 0 at j = 0, so mx is finite from the first tile on
    const float alpha[2] = {ex2(m[0] - mx[0]), ex2(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(s[nt][e] - m[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    uint32_t pf[4][4];
    to_a_frags(pf, s);
    mma_ab<HD>(acc, pf, sV + st * BN * LD, lane);
    __syncthreads();  // the stage is read before the next tile refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_rows<HD>(o + b * ob + h * oh, os, acc, row, S, 1.f / l[0], 1.f / l[1], t);
  if (t == 0) {  // every padded row too: the backward loads whole tiles
    float* lp = lse + ((int64_t)b * H + h) * S_pad;
    lp[row] = (m[0] + __log2f(l[0])) * LN2;
    lp[row + 8] = (m[1] + __log2f(l[1])) * LN2;
  }
}

// ---------------------------------------------------------------- backward

// delta = rowsum(do * o) in fp32 over (B, H, S_pad); padded rows get 0.
// HD / 8 threads a row, 16 bytes each.
template <int HD>
__global__ void delta_kernel(const bf16* __restrict__ o, int64_t ob, int64_t os, int64_t oh,
                             const bf16* __restrict__ dout, int64_t db, int64_t ds, int64_t dh,
                             float* __restrict__ delta, int S, int S_pad, int H, int64_t rows) {
  constexpr int TPR = HD / 8;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = gid / TPR;
  const int part = gid % TPR;
  float sum = 0.f;
  const int s = r % S_pad;
  const int64_t bh = r / S_pad;
  if (r < rows && s < S) {
    const int h = bh % H, b = bh / H;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * ob + s * os + h * oh + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * db + s * ds + h * dh + part * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(d2[i]);
      sum += a.x * c.x + a.y * c.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0 && r < rows) delta[r] = sum;
}

// dk, dv for one key tile of one (batch, kv head): the walk runs over the
// group's query heads and, for each, the query tiles from the diagonal on.
// grid (B*KV, ceil(S/BN)); blockIdx.y = 0 (the longest walk) first.
template <int HD>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv_kernel(const bf16* __restrict__ q, int64_t qb, int64_t qs, int64_t qh, const bf16* __restrict__ k,
                    int64_t kb, int64_t ks, int64_t kh, const bf16* __restrict__ v, int64_t vb, int64_t vs,
                    int64_t vh, const bf16* __restrict__ dout, int64_t db, int64_t ds, int64_t dh,
                    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                    int64_t dkb, int64_t dks, int64_t dkh, bf16* __restrict__ dv, int64_t dvb, int64_t dvs,
                    int64_t dvh, int S, int S_pad, int H, int groups, float scale, float scale_log2) {
  constexpr int LD = HD + 8;
  constexpr int DT = HD / 8;
  constexpr int STAGE = 2 * BM * LD;  // q, do tiles of one stage (elements)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;  // stage st: q at sQ + st * STAGE, do after it
  float* sStat = reinterpret_cast<float*>(sQ + 2 * STAGE);  // stage st: lse, delta

  const int KV = H / groups;
  const int b = blockIdx.x / KV, hk = blockIdx.x % KV;
  const int kt = blockIdx.y, nq = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int key = kt * BN + warp * 16 + g;  // this thread's keys: key, key + 8
  const int walk = nq - kt;                  // query tiles per head
  const int n_it = groups * walk;

  auto prefetch = [&](int it, int st) {
    const int h = hk * groups + it / walk, qt = kt + it % walk;
    bf16* dst = sQ + st * STAGE;
    load_tile<HD>(dst, q + b * qb + h * qh, qs, qt * BM, S);
    load_tile<HD>(dst + BM * LD, dout + b * db + h * dh, ds, qt * BM, S);
    const int64_t stat = ((int64_t)b * H + h) * S_pad + qt * BM;
    load_row_stats(sStat + st * 2 * BM, lse + stat);
    load_row_stats(sStat + st * 2 * BM + BM, delta + stat);
  };

  load_tile<HD>(sK, k + b * kb + hk * kh, ks, kt * BN, S);
  load_tile<HD>(sV, v + b * vb + hk * vh, vs, kt * BN, S);
  prefetch(0, 0);
  cp_async_commit();

  ARows<HD, HD <= 64> kf, vf;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) prefetch(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      kf.init(sK, warp, lane);
      vf.init(sV, warp, lane);
    }
    const bf16* tq = sQ + st * STAGE;
    const bf16* tdo = tq + BM * LD;
    const float* tl = sStat + st * 2 * BM;
    const float* td = tl + BM;
    const bool diag = it % walk == 0;

    // P^T (keys x queries) = exp(K Q^T / sqrt(hd) - lse)
    float p[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
    mma_abt(p, kf, tq, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);  // query column within the tile
        float x = ex2(p[nt][e] * scale_log2 - tl[qc] * LOG2E);
        if (diag && warp * 16 + g + (e >> 1) * 8 > qc) x = 0.f;
        p[nt][e] = x;
      }
    // dV += P^T dO
    uint32_t f[4][4];
    to_a_frags(f, p);
    mma_ab<HD>(dva, f, tdo, lane);
    // dP^T = V dO^T; dS^T = P^T (dP^T - delta)
    float dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    mma_abt(dp, vf, tdo, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = p[nt][e] * (dp[nt][e] - td[nt * 8 + 2 * t + (e & 1)]);
    // dK += dS^T Q
    to_a_frags(f, dp);
    mma_ab<HD>(dka, f, tq, lane);
    __syncthreads();
  }
  store_rows<HD>(dk + b * dkb + hk * dkh, dks, dka, key, S, scale, scale, t);
  store_rows<HD>(dv + b * dvb + hk * dvh, dvs, dva, key, S, 1.f, 1.f, t);
}

// dq for one query tile of one (batch, head), over the key tiles up to the
// diagonal. grid (B*H, ceil(S/BM)); blockIdx.y = 0 (the longest walk) first.
template <int HD>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_kernel(const bf16* __restrict__ q, int64_t qb, int64_t qs, int64_t qh, const bf16* __restrict__ k,
                  int64_t kb, int64_t ks, int64_t kh, const bf16* __restrict__ v, int64_t vb, int64_t vs,
                  int64_t vh, const bf16* __restrict__ dout, int64_t db, int64_t ds, int64_t dh,
                  const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
                  int64_t dqb, int64_t dqs, int64_t dqh, int S, int S_pad, int H, int groups, float scale,
                  float scale_log2) {
  constexpr int LD = HD + 8;
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BM * LD;
  bf16* sK = sdO + BM * LD;     // two stages
  bf16* sV = sK + 2 * BN * LD;  // two stages

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / groups;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row = qt * BM + warp * 16 + g;

  const bf16* kp = k + b * kb + hk * kh;
  const bf16* vp = v + b * vb + hk * vh;
  load_tile<HD>(sQ, q + b * qb + h * qh, qs, qt * BM, S);
  load_tile<HD>(sdO, dout + b * db + h * dh, ds, qt * BM, S);
  load_tile<HD>(sK, kp, ks, 0, S);
  load_tile<HD>(sV, vp, vs, 0, S);
  cp_async_commit();

  const int64_t stat = ((int64_t)b * H + h) * S_pad;
  const float l2[2] = {lse[stat + row] * LOG2E, lse[stat + row + 8] * LOG2E};
  const float dl[2] = {delta[stat + row], delta[stat + row + 8]};

  ARows<HD, HD <= 64> qf, df;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = 0; j <= qt; ++j) {
    const int st = j & 1;
    if (j < qt) {
      load_tile<HD>(sK + (st ^ 1) * BN * LD, kp, ks, (j + 1) * BN, S);
      load_tile<HD>(sV + (st ^ 1) * BN * LD, vp, vs, (j + 1) * BN, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      qf.init(sQ, warp, lane);
      df.init(sdO, warp, lane);
    }
    const bf16* tk = sK + st * BN * LD;
    float p[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = dp[nt][e] = 0.f;
    mma_abt(p, qf, tk, lane);
    mma_abt(dp, df, sV + st * BN * LD, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = ex2(p[nt][e] * scale_log2 - l2[e >> 1]);
        if (j == qt && j * BN + nt * 8 + 2 * t + (e & 1) > row + (e >> 1) * 8) x = 0.f;
        dp[nt][e] = x * (dp[nt][e] - dl[e >> 1]);
      }
    uint32_t f[4][4];
    to_a_frags(f, dp);
    mma_ab<HD>(acc, f, tk, lane);  // dQ += dS K
    __syncthreads();
  }
  store_rows<HD>(dq + b * dqb + h * dqh, dqs, acc, row, S, scale, scale, t);
}

// ------------------------------------------------------------------- host

template <int HD>
constexpr int fwd_smem() { return (BM + 4 * BN) * (HD + 8) * 2; }
template <int HD>
constexpr int dkdv_smem() { return (2 * BN + 4 * BM) * (HD + 8) * 2 + 4 * BM * 4; }
template <int HD>
constexpr int dq_smem() { return (2 * BM + 4 * BN) * (HD + 8) * 2; }

// raise a kernel's dynamic shared memory limit once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

int s_pad(int S) { return (S + BM - 1) / BM * BM; }

template <int HD>
int fwd(const bf16* q, int64_t qb, int64_t qs, int64_t qh, const bf16* k, int64_t kb, int64_t ks, int64_t kh,
        const bf16* v, int64_t vb, int64_t vs, int64_t vh, bf16* o, int64_t ob, int64_t os, int64_t oh,
        float* lse, int B, int S, int H, int KV, float scale, cudaStream_t stream) {
  static bool done[64];
  cudaError_t err = allow_smem(fwd_kernel<HD>, fwd_smem<HD>(), done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + BM - 1) / BM);
  fwd_kernel<HD><<<grid, THREADS, fwd_smem<HD>(), stream>>>(q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, o, ob,
                                                            os, oh, lse, S, s_pad(S), H, H / KV,
                                                            scale * LOG2E);
  return cudaGetLastError();
}

template <int HD>
int bwd(const bf16* q, int64_t qb, int64_t qs, int64_t qh, const bf16* k, int64_t kb, int64_t ks, int64_t kh,
        const bf16* v, int64_t vb, int64_t vs, int64_t vh, const bf16* o, int64_t ob, int64_t os, int64_t oh,
        const bf16* dout, int64_t db, int64_t ds, int64_t dh, const float* lse, float* delta, bf16* dq,
        int64_t dqb, int64_t dqs, int64_t dqh, bf16* dk, int64_t dkb, int64_t dks, int64_t dkh, bf16* dv,
        int64_t dvb, int64_t dvs, int64_t dvh, int B, int S, int H, int KV, float scale, cudaStream_t stream) {
  static bool done_dkdv[64], done_dq[64];
  cudaError_t err = allow_smem(bwd_dkdv_kernel<HD>, dkdv_smem<HD>(), done_dkdv);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<HD>, dq_smem<HD>(), done_dq);
  if (err != cudaSuccess) return err;
  const int sp = s_pad(S), groups = H / KV, nt = (S + BM - 1) / BM;
  const int64_t rows = (int64_t)B * H * sp;
  const int64_t threads = rows * (HD / 8);
  delta_kernel<HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(o, ob, os, oh, dout, db, ds, dh, delta,
                                                                          S, sp, H, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkdv_kernel<HD><<<dim3(B * KV, nt), THREADS, dkdv_smem<HD>(), stream>>>(
      q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, dout, db, ds, dh, lse, delta, dk, dkb, dks, dkh, dv, dvb, dvs,
      dvh, S, sp, H, groups, scale, scale * LOG2E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq_kernel<HD><<<dim3(B * H, nt), THREADS, dq_smem<HD>(), stream>>>(
      q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, dout, db, ds, dh, lse, delta, dq, dqb, dqs, dqh, S, sp, H,
      groups, scale, scale * LOG2E);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KV) {
  return B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || (S + BM - 1) / BM > 65535;
}

}  // namespace

// Strides are in elements; the last axis (head_dim) has unit stride. lse
// and delta are (B, H, S_pad) fp32 with S_pad = S rounded up to 64.
extern "C" int flash_attn_fwd(int head_dim, const void* q, int64_t qb, int64_t qs, int64_t qh, const void* k,
                              int64_t kb, int64_t ks, int64_t kh, const void* v, int64_t vb, int64_t vs,
                              int64_t vh, void* o, int64_t ob, int64_t os, int64_t oh, void* lse, int B, int S,
                              int H, int KV, float scale, void* stream) {
  if (bad_shape(B, S, H, KV)) return BAD_SHAPE;
  if (head_dim != 64 && head_dim != 128) return BAD_HEAD_DIM;
  auto run = head_dim == 64 ? fwd<64> : fwd<128>;
  return run(static_cast<const bf16*>(q), qb, qs, qh, static_cast<const bf16*>(k), kb, ks, kh,
             static_cast<const bf16*>(v), vb, vs, vh, static_cast<bf16*>(o), ob, os, oh,
             static_cast<float*>(lse), B, S, H, KV, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attn_bwd(int head_dim, const void* q, int64_t qb, int64_t qs, int64_t qh, const void* k,
                              int64_t kb, int64_t ks, int64_t kh, const void* v, int64_t vb, int64_t vs,
                              int64_t vh, const void* o, int64_t ob, int64_t os, int64_t oh, const void* dout,
                              int64_t db, int64_t ds, int64_t dh, const void* lse, void* delta, void* dq,
                              int64_t dqb, int64_t dqs, int64_t dqh, void* dk, int64_t dkb, int64_t dks,
                              int64_t dkh, void* dv, int64_t dvb, int64_t dvs, int64_t dvh, int B, int S, int H,
                              int KV, float scale, void* stream) {
  if (bad_shape(B, S, H, KV)) return BAD_SHAPE;
  if (head_dim != 64 && head_dim != 128) return BAD_HEAD_DIM;
  auto run = head_dim == 64 ? bwd<64> : bwd<128>;
  return run(static_cast<const bf16*>(q), qb, qs, qh, static_cast<const bf16*>(k), kb, ks, kh,
             static_cast<const bf16*>(v), vb, vs, vh, static_cast<const bf16*>(o), ob, os, oh,
             static_cast<const bf16*>(dout), db, ds, dh, static_cast<const float*>(lse),
             static_cast<float*>(delta), static_cast<bf16*>(dq), dqb, dqs, dqh, static_cast<bf16*>(dk), dkb,
             dks, dkh, static_cast<bf16*>(dv), dvb, dvs, dvh, B, S, H, KV, scale,
             static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of each kernel (0 fwd, 1 dk/dv, 2 dq) at head_dim
// 64 or 128
extern "C" int flash_attn_smem_bytes(int head_dim, int which) {
  if (head_dim == 128) return which == 0 ? fwd_smem<128>() : which == 1 ? dkdv_smem<128>() : dq_smem<128>();
  return which == 0 ? fwd_smem<64>() : which == 1 ? dkdv_smem<64>() : dq_smem<64>();
}
