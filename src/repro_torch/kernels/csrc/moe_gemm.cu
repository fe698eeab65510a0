// Grouped expert-FFN GEMMs for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ../moe_gemm.py).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/moe_gemm.py:
//   moe_gemm_gated_ffn_in  <-  grouped_gated_ffn_in (_gated_in_kernel)
//       h[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e])     (E,C,D)x(E,D,F) -> (E,C,F)
//   moe_gemm_matmul        <-  grouped_matmul (_matmul_kernel)
//       y[e] = h[e] @ w[e]                              (E,C,F)x(E,F,D) -> (E,C,D)
// Both accumulate in fp32 and store in the input's dtype (fp32 or bf16), as
// the TPU kernels do.
//
// What bounds them on this card: at the serving shape (E=16 experts, C=160
// capacity rows, D=512, F=1408, bf16) the expert weights dominate the bytes
// (46 MB for wg+wu, 23 MB for w_down) while the work is 7.4 / 3.7 GFLOP,
// 110-130 FLOP per byte, under the H100's ~295 FLOP/byte ridge: both are
// bound by device memory. The design therefore reads every weight tile from
// device memory once per expert and lets the C-tiles that share it run side
// by side: blockIdx.x walks the C-tiles fastest, so the (few) blocks that
// reuse one (expert, N-tile) weight panel are scheduled together and the
// repeats hit L2. The gated kernel fuses both projections and the SwiGLU
// epilogue, so x is read once and the (E,C,F) pre-activations never reach
// device memory. bf16 runs on the tensor cores through WMMA (mma.sync,
// 16x16x16, fp32 accumulate); fp32 runs on plain FMA in full precision.
// Unlike the TPU version nothing is padded to 128: every edge (C, D, F
// arbitrary) is masked in the tile loads and the store. The kernels take
// strides: the expert-FFN backward (../ops.py) runs moe_gemm_matmul over
// transposed views, whose tile loads are then uncoalesced (consecutive
// threads walk the strided axis). wgmma, TMA, layout-aware loads and a
// multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int BM = 64;  // rows of the output tile (capacity rows C)
constexpr int BN = 64;  // columns of the output tile (F for K1, D for K2)
constexpr int BK = 32;  // reduction depth staged per step
constexpr int THREADS = 128;
constexpr int APAD = 8;  // shared-memory row padding (elements); keeps
constexpr int BPAD = 8;  // WMMA pointers 32-byte aligned and spreads banks
constexpr int CPAD = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// Stage the (BM x BK) tile of A and the (BK x BN) tiles of B0 (and B1) at
// reduction offset k0 into shared memory; out-of-range elements read as 0.
template <typename T, int NB>
__device__ __forceinline__ void load_tiles(
    T (*As)[BK + APAD], T (*Bs)[BK][BN + BPAD], const T* a_e, long long sa_m,
    long long sa_k, const T* b_e0, const T* b_e1, long long sb_k,
    long long sb_n, int m0, int n0, int k0, int M, int N, int K) {
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    const int gm = m0 + r, gk = k0 + c;
    As[r][c] = (gm < M && gk < K) ? a_e[gm * sa_m + gk * sa_k] : zero_of<T>();
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const T* b_e = b == 0 ? b_e0 : b_e1;
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[b][r][c] = (gk < K && gn < N) ? b_e[gk * sb_k + gn * sb_n] : zero_of<T>();
    }
  }
}

// out[e] = A[e] @ B0[e]                         (GATED = false)
// out[e] = silu(A[e] @ B0[e]) * (A[e] @ B1[e])  (GATED = true)
// A (E,M,K), B0/B1 (E,K,N) sharing strides, out (E,M,N); strides in elements.
template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS) grouped_gemm_kernel(
    const T* __restrict__ a, long long sa_e, long long sa_m, long long sa_k,
    const T* __restrict__ b0, const T* __restrict__ b1, long long sb_e,
    long long sb_k, long long sb_n, T* __restrict__ out, long long so_e,
    long long so_m, long long so_n, int M, int N, int K) {
  constexpr int NB = GATED ? 2 : 1;
  __shared__ __align__(32) T As[BM][BK + APAD];
  __shared__ __align__(32) T Bs[NB][BK][BN + BPAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long e = blockIdx.z;
  const T* a_e = a + e * sa_e;
  const T* b_e0 = b0 + e * sb_e;
  const T* b_e1 = GATED ? b1 + e * sb_e : nullptr;

  if constexpr (sizeof(T) == 2) {
    // bf16: tensor cores through WMMA. Four warps in a 2x2 layout, each
    // owning a 32x32 quarter of the tile as 2x2 fragments of 16x16.
    using namespace nvcuda;
    __shared__ __align__(32) float Cs[BM][BN + CPAD];
    const int warp = tid / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[b][i][j], 0.0f);

    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tiles<T, NB>(As, Bs, a_e, sa_m, sa_k, b_e0, b_e1, sb_k, sb_n, m0, n0,
                        k0, M, N, K);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &As[wm + i * 16][kk], BK + APAD);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, &Bs[b][kk][wn + j * 16], BN + BPAD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::mma_sync(acc[b][i][j], fa[i], fb, acc[b][i][j]);
          }
        }
      }
      __syncthreads();
    }

    // epilogue: both accumulators share one fragment layout, so the SwiGLU
    // is elementwise over fragment slots; stage through shared memory for a
    // masked, row-major store in the output dtype.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (GATED) {
#pragma unroll
          for (int t = 0; t < acc[0][i][j].num_elements; ++t)
            acc[0][i][j].x[t] = silu(acc[0][i][j].x[t]) * acc[1][i][j].x[t];
        }
        wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[0][i][j],
                                BN + CPAD, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gm = m0 + r, gn = n0 + c;
      if (gm < M && gn < N)
        out[e * so_e + gm * so_m + gn * so_n] = from_float<T>(Cs[r][c]);
    }
  } else {
    // fp32: plain FMA in full precision. Each thread owns a 4x8 grid of
    // outputs: rows ty + 16*i, columns tx + 8*j (conflict-free smem reads).
    const int ty = tid / 8, tx = tid % 8;
    float acc[NB][4][8];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[b][i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tiles<T, NB>(As, Bs, a_e, sa_m, sa_k, b_e0, b_e1, sb_k, sb_n, m0, n0,
                        k0, M, N, K);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_float(As[ty + 16 * i][kk]);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float bv = to_float(Bs[b][kk][tx + 8 * j]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[b][i][j] = fmaf(av[i], bv, acc[b][i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gm = m0 + ty + 16 * i, gn = n0 + tx + 8 * j;
        if (gm < M && gn < N) {
          float v = acc[0][i][j];
          if constexpr (GATED) v = silu(v) * acc[1][i][j];
          out[e * so_e + gm * so_m + gn * so_n] = from_float<T>(v);
        }
      }
    }
  }
}

template <typename T, bool GATED>
int launch(const void* a, long long sa_e, long long sa_m, long long sa_k,
           const void* b0, const void* b1, long long sb_e, long long sb_k,
           long long sb_n, void* out, long long so_e, long long so_m,
           long long so_n, int E, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, E);
  grouped_gemm_kernel<T, GATED><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), sa_e, sa_m, sa_k, static_cast<const T*>(b0),
      static_cast<const T*>(b1), sb_e, sb_k, sb_n, static_cast<T*>(out), so_e,
      so_m, so_n, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int BAD_DTYPE = -1;

}  // namespace

extern "C" {

// h (E,C,F) = silu(x @ wg) * (x @ wu); x (E,C,D), wg/wu (E,D,F) with equal
// strides. Returns cudaGetLastError() after the launch (0 on success).
int moe_gemm_gated_ffn_in(int dtype, const void* x, long long sx_e,
                          long long sx_m, long long sx_k, const void* wg,
                          const void* wu, long long sw_e, long long sw_k,
                          long long sw_n, void* h, long long sh_e,
                          long long sh_m, long long sh_n, int E, int C, int F,
                          int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return launch<float, true>(x, sx_e, sx_m, sx_k, wg, wu, sw_e, sw_k, sw_n,
                               h, sh_e, sh_m, sh_n, E, C, F, D, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, true>(x, sx_e, sx_m, sx_k, wg, wu, sw_e, sw_k,
                                       sw_n, h, sh_e, sh_m, sh_n, E, C, F, D, s);
  return BAD_DTYPE;
}

// y (E,C,D) = h @ w; h (E,C,F), w (E,F,D).
int moe_gemm_matmul(int dtype, const void* h, long long sh_e, long long sh_m,
                    long long sh_k, const void* w, long long sw_e,
                    long long sw_k, long long sw_n, void* y, long long sy_e,
                    long long sy_m, long long sy_n, int E, int C, int D, int F,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return launch<float, false>(h, sh_e, sh_m, sh_k, w, nullptr, sw_e, sw_k,
                                sw_n, y, sy_e, sy_m, sy_n, E, C, D, F, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, false>(h, sh_e, sh_m, sh_k, w, nullptr, sw_e,
                                        sw_k, sw_n, y, sy_e, sy_m, sy_n, E, C,
                                        D, F, s);
  return BAD_DTYPE;
}

}  // extern "C"
