// Grouped expert-FFN GEMMs for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ../moe_gemm.py).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/moe_gemm.py:
//   moe_gemm_gated_ffn_in  <-  grouped_gated_ffn_in (_gated_in_kernel, :41)
//       h[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e])     (E,C,D)x(E,D,F) -> (E,C,F)
//   moe_gemm_matmul        <-  grouped_matmul (_matmul_kernel, :94)
//       y[e] = h[e] @ w[e]                              (E,C,F)x(E,F,D) -> (E,C,D)
// Both accumulate in fp32 and store in the input's dtype (fp32 or bf16), as
// the TPU kernels do. moe_gemm_matmul also runs the eight backward products
// of the expert FFN (../ops.py) over transposed views, so its operands come
// with either of their last two axes unit-stride.
//
// What bounds each use on this card (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s,
// ridge ~295 FLOP/byte), minimind-moe-16e (E=16, D=512, F=1408):
//   - serving (C=160): 110-130 FLOP per byte, bound by device memory, that
//     is by the expert weights (46 MB for wg+wu, 23 MB for w);
//   - training (C=2560): every product is 59 GFLOP (K1: 118) at ~800 FLOP
//     per byte, bound by the tensor cores.
// The bf16 design serves both:
//   - TMA loads through one 3-D tensor map per operand: inner = the axis of
//     unit stride (box 64 bf16 = 128 bytes, 128-byte swizzle), middle = the
//     other matrix axis, outer = the expert (box 1). Elements past an edge
//     read as zero, so a ragged C, D or F, and a K that is not a multiple
//     of 64, are exact without padding, and a tile never reads the next
//     expert's rows;
//   - each operand is read as it lies: wgmma takes A and B from shared
//     memory K-major or MN-major (its transpose flags), so the transposed
//     views of the backward need no copy and no strided load. The kernel is
//     instantiated for the four (A, B) layout pairs; the entry point picks
//     one from the strides;
//   - warp specialisation: one producer thread keeps a ring of STAGES
//     (A, B) tiles in flight, with a "full" (transaction bytes) and an
//     "empty" mbarrier per stage; two consumer warpgroups each own 64 rows
//     of the 128-row tile and issue wgmma.mma_async m64n128k16 with fp32
//     accumulators, keep one wgmma group in flight, and release a stage
//     once wgmma.wait_group shows it has been read; setmaxnreg moves
//     registers from the producer warpgroup to the consumers;
//   - K1 keeps two accumulators (gate, up) over one A tile; its epilogue
//     applies silu(g)*u over their shared fragment layout, so the (E,C,F)
//     pre-activations never reach device memory;
//   - blockIdx.x walks the C-tiles fastest: the blocks that share one
//     (expert, N-tile) weight panel run together and its repeats hit L2,
//     which is what the memory-bound serving shape needs;
//   - the epilogue stages each warpgroup's 64 x 128 bf16 tile in the freed
//     ring (16-byte chunks permuted by row, so neither side has bank
//     conflicts) and writes it with masked 16-byte stores, 16 threads to a
//     256-byte row.
// fp32 keeps a plain FMA kernel in full precision (wgmma has no full-fp32
// form), with masked, strided scalar loads.

#include <cuda.h>          // CUtensorMap and its enums (the driver is not linked)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
// entry-point codes besides CUDA's own errors (see ../moe_gemm.py)
constexpr int BAD_DTYPE = -1;
constexpr int BAD_LAYOUT = -2;  // an operand TMA cannot describe
constexpr int NO_TMA = -3;      // the driver offers no cuTensorMapEncodeTiled
constexpr int BAD_MAP = -4;     // cuTensorMapEncodeTiled refused a tensor map

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// ------------------------------------------------------- fp32: plain FMA

namespace fp32 {

constexpr int BM = 64;  // rows of the output tile (capacity rows C)
constexpr int BN = 64;  // columns of the output tile (F for K1, D for K2)
constexpr int BK = 32;  // reduction depth staged per step
constexpr int THREADS = 128;
constexpr int PAD = 8;  // shared-memory row padding (elements)

// Stage the (BM x BK) tile of A and the (BK x BN) tiles of B0 (and B1) at
// reduction offset k0 into shared memory; out-of-range elements read as 0.
template <int NB>
__device__ __forceinline__ void load_tiles(
    float (*As)[BK + PAD], float (*Bs)[BK][BN + PAD], const float* a_e,
    long long sa_m, long long sa_k, const float* b_e0, const float* b_e1,
    long long sb_k, long long sb_n, int m0, int n0, int k0, int M, int N, int K) {
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    const int gm = m0 + r, gk = k0 + c;
    As[r][c] = (gm < M && gk < K) ? a_e[gm * sa_m + gk * sa_k] : 0.0f;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float* b_e = b == 0 ? b_e0 : b_e1;
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[b][r][c] = (gk < K && gn < N) ? b_e[gk * sb_k + gn * sb_n] : 0.0f;
    }
  }
}

// out[e] = A[e] @ B0[e]                         (GATED = false)
// out[e] = silu(A[e] @ B0[e]) * (A[e] @ B1[e])  (GATED = true)
// A (E,M,K), B0/B1 (E,K,N) sharing strides, out (E,M,N); strides in elements.
template <bool GATED>
__global__ void __launch_bounds__(THREADS) fp32_gemm_kernel(
    const float* __restrict__ a, long long sa_e, long long sa_m, long long sa_k,
    const float* __restrict__ b0, const float* __restrict__ b1, long long sb_e,
    long long sb_k, long long sb_n, float* __restrict__ out, long long so_e,
    long long so_m, long long so_n, int M, int N, int K) {
  constexpr int NB = GATED ? 2 : 1;
  __shared__ float As[BM][BK + PAD];
  __shared__ float Bs[NB][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long e = blockIdx.z;
  const float* a_e = a + e * sa_e;
  const float* b_e0 = b0 + e * sb_e;
  const float* b_e1 = GATED ? b1 + e * sb_e : nullptr;

  // Each thread owns a 4x8 grid of outputs: rows ty + 16*i, columns
  // tx + 8*j (conflict-free shared-memory reads).
  const int ty = tid / 8, tx = tid % 8;
  float acc[NB][4][8];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[b][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tiles<NB>(As, Bs, a_e, sa_m, sa_k, b_e0, b_e1, sb_k, sb_n, m0, n0, k0,
                   M, N, K);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float bv = Bs[b][kk][tx + 8 * j];
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
        out[e * so_e + gm * so_m + gn * so_n] = v;
      }
    }
  }
}

template <bool GATED>
int launch(const void* a, long long sa_e, long long sa_m, long long sa_k,
           const void* b0, const void* b1, long long sb_e, long long sb_k,
           long long sb_n, void* out, long long so_e, long long so_m,
           long long so_n, int E, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, E);
  fp32_gemm_kernel<GATED><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(a), sa_e, sa_m, sa_k, static_cast<const float*>(b0),
      static_cast<const float*>(b1), sb_e, sb_k, sb_n, static_cast<float*>(out),
      so_e, so_m, so_n, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

// ------------------------------------ bf16: TMA + mbarrier ring + wgmma

namespace bf16 {

constexpr int BM = 128;  // output rows per block: two consumer warpgroups x 64
constexpr int BN = 128;  // output columns per block: one wgmma n128
constexpr int BK = 64;   // reduction depth per stage: one 128-byte swizzle row
constexpr int BOX = 64;  // TMA box along an operand's unit-stride axis
constexpr int TILE_BYTES = BM * BK * 2;     // an A or a B tile (BM == BN): 16 KB
constexpr int HALF_BYTES = TILE_BYTES / 2;  // 64 rows of it, or one 64 x 64 box
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups

// The ring of stages in dynamic shared memory: 192 KB of tiles either way,
// plus slack to align it to 1024 bytes.
template <bool GATED>
struct Ring {
  static constexpr int STAGES = GATED ? 4 : 6;
  static constexpr int STAGE_BYTES = (GATED ? 3 : 2) * TILE_BYTES;  // A + B (+ B)
  static constexpr int BYTES = STAGES * STAGE_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// lasts seconds can only be a broken pipeline: it traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 4000000000ull) {
        __trap();
      }
    }
  }
}

// One TMA tile load of box (c0 inner, c1 middle, c2 expert) into shared
// memory, counted against the barrier's transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading (LBO) and stride (SBO) byte offsets in 16-byte units,
// layout type 1 (128-byte swizzle) in bits 62-63. Tiles are 1024-byte
// aligned, so the base offset stays 0.
//   K-major (one 128-byte row of 64 K-values per M/N index): SBO = 1024,
//     the step between groups of 8 rows; LBO is not used (a k16 slice lies
//     inside one row) and is 16.
//   MN-major (one 128-byte row of 64 M/N-values per K index): SBO = 1024,
//     the step between groups of 8 K-rows; LBO = 8 KB, the step between the
//     64-wide boxes along M or N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t operand_desc(bool mn_major, uint32_t tile, int kk) {
  // the kk-th 16-deep slice: 32 bytes along a K-major row, 16 K-rows of
  // 128 bytes in an MN-major tile
  return mn_major ? desc(tile + kk * 2048, HALF_BYTES, 1024) : desc(tile + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32, this warpgroup's fragment) += A (64 x 16) B (16 x 128),
// both bf16 from shared memory; TA / TB = 1: that operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// out[e] = A[e] @ B0[e]                         (GATED = false)
// out[e] = silu(A[e] @ B0[e]) * (A[e] @ B1[e])  (GATED = true)
// A (E,M,K) and B0/B1 (E,K,N) come as tensor maps; A_MN / B_MN: that
// operand is MN-major (its M or N axis has unit stride), else K-major. out
// (E,M,N) has unit column stride; vec_stores: its rows start on 16 bytes.
template <bool GATED, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(THREADS, 1) wgmma_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b0,
    const __grid_constant__ CUtensorMap map_b1, __nv_bfloat16* __restrict__ out,
    long long so_e, long long so_m, int M, int N, int K, int vec_stores) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int STAGES = Ring<GATED>::STAGES;
  constexpr int STAGE_BYTES = Ring<GATED>::STAGE_BYTES;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(1024) uint8_t dyn_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grain
  const uint32_t ring = (smem_addr(dyn_smem) + 1023u) & ~1023u;
  // shared address of tile t (0: A, 1 + b: B_b) of stage s
  auto tile = [ring](int s, int t) { return ring + static_cast<uint32_t>(s * STAGE_BYTES + t * TILE_BYTES); };

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int ktiles = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);   // the producer's expect_tx
      mbar_init(smem_addr(&empty[s]), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    // an MN-major tile is two 64-wide boxes; one wholly past M (or N) is
    // not loaded: it would only feed rows (columns) that are never stored
    const int a_boxes = A_MN ? (M - m0 > BOX ? 2 : 1) : 1;
    const int b_boxes = B_MN ? (N - n0 > BOX ? 2 : 1) : 1;
    const uint32_t a_bytes = A_MN ? a_boxes * HALF_BYTES : TILE_BYTES;
    const uint32_t b_bytes = B_MN ? b_boxes * HALF_BYTES : TILE_BYTES;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % STAGES, k0 = kt * BK;
      mbar_wait(smem_addr(&empty[s]), ((kt / STAGES) & 1) ^ 1);  // the first pass finds it free
      const uint32_t bar = smem_addr(&full[s]);
      mbar_expect_tx(bar, a_bytes + NB * b_bytes);
      if constexpr (A_MN) {
        for (int j = 0; j < a_boxes; ++j)
          tma_load(tile(s, 0) + j * HALF_BYTES, &map_a, bar, m0 + j * BOX, k0, e);
      } else {
        tma_load(tile(s, 0), &map_a, bar, k0, m0, e);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const CUtensorMap* map_b = b == 0 ? &map_b0 : &map_b1;
        if constexpr (B_MN) {
          for (int j = 0; j < b_boxes; ++j)
            tma_load(tile(s, 1 + b) + j * HALF_BYTES, map_b, bar, n0 + j * BOX, k0, e);
        } else {
          tma_load(tile(s, 1 + b), map_b, bar, k0, n0, e);
        }
      }
    }
    return;
  }

  // consumer warpgroups: rows m0 + 64*cw .. +64 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = threadIdx.x / 128 - 1;
  float acc[NB][64];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[b][i] = 0.0f;
    fence_acc(acc[b]);
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_addr(&full[s]), (kt / STAGES) & 1);
    // this warpgroup's 64 rows start 8 KB into the A tile in either layout
    const uint32_t a_tile = tile(s, 0) + cw * HALF_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = operand_desc(A_MN, a_tile, kk);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wgmma_m64n128k16<A_MN, B_MN>(acc[b], da, operand_desc(B_MN, tile(s, 1 + b), kk));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(smem_addr(&empty[(kt - 1) % STAGES]));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) fence_acc(acc[b]);

  // Epilogue, through shared memory so that the stores to device memory
  // are 16 bytes a thread, a row's 256 bytes by 16 neighbouring threads.
  // Both warpgroups' products have read their last stages: the ring is free
  // (every TMA load landed before its full barrier completed).
  asm volatile("bar.sync 1, 256;" ::: "memory");
  // This warpgroup's 64 x 128 tile as two 64 x 64 halves of 128-byte rows,
  // the 16-byte chunks of row r permuted by r % 8: the fragment writes
  // below and the row reads after are free of bank conflicts.
  const uint32_t staged = ring + cw * TILE_BYTES;
  auto chunk_addr = [staged](int r, int c) {  // row r, 16-byte chunk c (of 16)
    return staged + (c / 8) * HALF_BYTES + r * 128 + (((c % 8) ^ (r % 8)) * 16);
  };
  // Fragment of m64nN: thread t holds rows 16*(t/32) + (t%32)/4 (+8),
  // columns 8*j + 2*(t%4) (+1), as registers 4j + {0,1} (+{2,3}).
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (t / 32) + (t % 32) / 4 + 8 * h, reg = 4 * j + 2 * h;
      float v0 = acc[0][reg], v1 = acc[0][reg + 1];
      if constexpr (GATED) {
        v0 = silu(v0) * acc[1][reg];
        v1 = silu(v1) * acc[1][reg + 1];
      }
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(chunk_addr(r, j) + 4 * (t % 4)),
                   "r"(*reinterpret_cast<const uint32_t*>(&pair))
                   : "memory");
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(2 + cw) : "memory");  // this warpgroup's tile is staged
  __nv_bfloat16* out_e = out + static_cast<long long>(e) * so_e;
#pragma unroll
  for (int i = 0; i < 64 * 16 / 128; ++i) {
    const int idx = t + 128 * i, r = idx / 16, c = idx % 16;
    const int row = m0 + cw * 64 + r, col = n0 + 8 * c;
    if (row >= M || col >= N) continue;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(chunk_addr(r, c))
                 : "memory");
    __nv_bfloat16* p = out_e + row * so_m + col;
    if (vec_stores && col + 8 <= N) {
      *reinterpret_cast<uint4*>(p) = v;
    } else {
      const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int k = 0; k < 8 && col + k < N; ++k) p[k] = vals[k];
    }
  }
}

using EncodeFn = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
EncodeFn tensor_map_encoder() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeFn>(p)
                                                                        : nullptr;
  }();
  return fn;
}

// A 3-D map over one bf16 operand: inner = its unit-stride axis (box 64),
// middle = its other matrix axis (box box_mid), outer = the expert (box 1);
// strides in elements.
int encode(CUtensorMap* map, const void* ptr, long long inner, long long middle,
           long long experts, long long s_middle, long long s_expert, int box_mid) {
  const EncodeFn fn = tensor_map_encoder();
  if (fn == nullptr) return NO_TMA;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(middle),
                              static_cast<cuuint64_t>(experts)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s_middle) * 2,
                                 static_cast<cuuint64_t>(s_expert) * 2};
  const cuuint32_t box[3] = {BOX, static_cast<cuuint32_t>(box_mid), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of range reads as 0
  return rc == CUDA_SUCCESS ? 0 : BAD_MAP;
}

template <bool GATED, bool A_MN, bool B_MN>
int launch_pair(const CUtensorMap& ma, const CUtensorMap& mb0, const CUtensorMap& mb1, void* out,
                long long so_e, long long so_m, int E, int M, int N, int K, int vec_stores,
                cudaStream_t stream) {
  const auto kernel = wgmma_gemm_kernel<GATED, A_MN, B_MN>;
  constexpr int smem = Ring<GATED>::BYTES;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, E);
  kernel<<<grid, THREADS, smem, stream>>>(ma, mb0, mb1, static_cast<__nv_bfloat16*>(out), so_e,
                                          so_m, M, N, K, vec_stores);
  return static_cast<int>(cudaGetLastError());
}

// Encode the operands' tensor maps and launch the instantiation of their
// layout pair. Each operand is K-major when its K axis has unit stride and
// MN-major when its other matrix axis has (../moe_gemm.py checks and
// normalises the strides first).
template <bool GATED>
int launch(const void* a, long long sa_e, long long sa_m, long long sa_k, const void* b0,
           const void* b1, long long sb_e, long long sb_k, long long sb_n, void* out,
           long long so_e, long long so_m, long long so_n, int E, int M, int N, int K,
           cudaStream_t stream) {
  if (E == 0 || M == 0 || N == 0) return 0;
  const bool a_mn = sa_k != 1, b_mn = sb_n == 1;
  if ((a_mn && sa_m != 1) || (!b_mn && sb_k != 1) || so_n != 1 || K < 1) return BAD_LAYOUT;
  // cuTensorMapEncodeTiled is a driver call and needs a current context. A
  // thread that has made no runtime call yet has none (autograd's device
  // thread, when the backward's first operation is this launch):
  // cudaSetDevice makes the device's primary context current.
  int dev = 0;
  cudaError_t ctx = cudaGetDevice(&dev);
  if (ctx == cudaSuccess) ctx = cudaSetDevice(dev);
  if (ctx != cudaSuccess) return static_cast<int>(ctx);
  CUtensorMap ma, mb0, mb1;
  int rc = a_mn ? encode(&ma, a, M, K, E, sa_k, sa_e, BOX) : encode(&ma, a, K, M, E, sa_m, sa_e, BM);
  for (int b = 0; b < (GATED ? 2 : 1) && rc == 0; ++b) {
    CUtensorMap* mb = b == 0 ? &mb0 : &mb1;
    const void* ptr = b == 0 ? b0 : b1;
    rc = b_mn ? encode(mb, ptr, N, K, E, sb_k, sb_e, BOX) : encode(mb, ptr, K, N, E, sb_n, sb_e, BN);
  }
  if (rc != 0) return rc;
  if (!GATED) mb1 = mb0;  // unused
  const int vec = so_m % 8 == 0 && so_e % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (a_mn)
    return b_mn ? launch_pair<GATED, true, true>(ma, mb0, mb1, out, so_e, so_m, E, M, N, K, vec, stream)
                : launch_pair<GATED, true, false>(ma, mb0, mb1, out, so_e, so_m, E, M, N, K, vec, stream);
  return b_mn ? launch_pair<GATED, false, true>(ma, mb0, mb1, out, so_e, so_m, E, M, N, K, vec, stream)
              : launch_pair<GATED, false, false>(ma, mb0, mb1, out, so_e, so_m, E, M, N, K, vec, stream);
}

}  // namespace bf16

}  // namespace

extern "C" {

// h (E,C,F) = silu(x @ wg) * (x @ wu); x (E,C,D), wg/wu (E,D,F) with equal
// strides. Returns cudaGetLastError() after the launch (0 on success), or
// one of the negative codes above.
int moe_gemm_gated_ffn_in(int dtype, const void* x, long long sx_e,
                          long long sx_m, long long sx_k, const void* wg,
                          const void* wu, long long sw_e, long long sw_k,
                          long long sw_n, void* h, long long sh_e,
                          long long sh_m, long long sh_n, int E, int C, int F,
                          int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return fp32::launch<true>(x, sx_e, sx_m, sx_k, wg, wu, sw_e, sw_k, sw_n, h,
                             sh_e, sh_m, sh_n, E, C, F, D, s);
  if (dtype == DTYPE_BF16)
    return bf16::launch<true>(x, sx_e, sx_m, sx_k, wg, wu, sw_e, sw_k, sw_n, h,
                            sh_e, sh_m, sh_n, E, C, F, D, s);
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
    return fp32::launch<false>(h, sh_e, sh_m, sh_k, w, nullptr, sw_e, sw_k, sw_n,
                              y, sy_e, sy_m, sy_n, E, C, D, F, s);
  if (dtype == DTYPE_BF16)
    return bf16::launch<false>(h, sh_e, sh_m, sh_k, w, nullptr, sw_e, sw_k, sw_n,
                             y, sy_e, sy_m, sy_n, E, C, D, F, s);
  return BAD_DTYPE;
}

// Dynamic shared memory of one block of the bf16 kernel (K1: gated = 1).
int moe_gemm_bf16_smem_bytes(int gated) {
  return gated ? bf16::Ring<true>::BYTES : bf16::Ring<false>::BYTES;
}

}  // extern "C"
