// The fused encoder layer's bf16 kernels on Hopper's warpgroup tensor cores:
// the products and epilogues of K1 (forward, with its dropout, causal and
// relative-bias variants) and K2 (backward, with dRel), which replace the
// TPU kernels _fwd_kernel and _bwd_kernel / _bwd_element of
// bert4rec_tpu/ops/fused_encoder_layer.py; dispatched from
// fused_encoder_layer.cu. The attention core runs flash_hopper.cuh's three
// kernels with the layer's switches (kRel, kPart, DK).
//
// Bound. At ml-20m_256's shape (B S = 51,200 rows, H = 256, F = 1,024) the
// forward's products are 80.5 GFLOP and the backward's 161 (0.08 / 0.16 ms
// at the bf16 peak) against ~0.65 / ~1.2 GB of activations (0.2 / 0.4 ms at
// 3.35 TB/s): per launch the layer is bound by its bytes as much as by its
// products, and the epilogues (bias, gelu, dropout, residual, LayerNorm and
// their writes) cost as much as the products. So every epilogue runs from
// the registers or from a shared-memory copy of the tile, writes whole
// 16-byte chunks, and overlaps another block's products where registers
// allow two blocks an SM.
//
// Every product C = A W runs on wgmma with fp32 accumulators in registers.
// A is a row-major activation [M, K] read as K-major tiles, W a row-major
// [K, N] weight read as an MN-major B operand (hopper.cuh's mn_desc: a tile
// of 64 K rows and up to 256 N columns spans four 64-column blocks). A block
// is two warpgroups (256 threads): WM along the rows, WN along the columns,
// each warpgroup 64 rows x BN columns. All threads fill a ring of 3 or 4
// stages by cp.async 16-byte copies into the 128-byte swizzle (rows past M,
// K and columns past N zero-filled: exact for every product), the copies of
// the next stages in flight and the previous step's products still running
// while the current step's are issued (ring). Epilogues run from the
// registers: thread t of a warpgroup holds rows 16 (t / 32) + (t % 32) / 4 +
// 8 h and columns 8 j + 2 (t % 4) + e (element 4 j + 2 h + e).
//
//   gemm_kernel       C = T(epi(A W)): + bias (qkv), + bias then tanh-gelu
//                     (W1), nothing (dctx), + an fp32 matrix (dx = du +
//                     dqkv Wqkv^T); 128 x 128 tiles, two blocks an SM, the
//                     output staged through shared memory
//   gelu_grad_kernel  the FFN backward's dual product: df W2^T and x1 W1
//                     into two accumulator sets of one 128 x 128 tile, then
//                     dhpre = T(dhact gelu'(hpre)) and dbf1's column
//                     partials
//   ln_fwd_kernel     Wo and W2: a block owns whole rows, 128 of them (H <=
//                     256: each warpgroup holds 64 rows in an m64nHk16
//                     accumulator) or 64 (256 < H <= 512: the warpgroups
//                     split the columns); the tile goes to shared memory and
//                     warps take whole rows for bias, output dropout,
//                     residual and LayerNorm; writes T(y), xhat and rstd
//   ln_bwd_kernel     the dx1 product dw_res + dhpre W1^T the same way, with
//                     LN1's backward: du, dattn = T(du keep), and the dg1 /
//                     db1 / dbo column partials
//   ln_rows_bwd_kernel LN2's backward without a product, bound by bytes: the
//                     same row phase over dy
//   wgrad_kernel      dW = A^T B over the M = B S rows, both operands
//                     MN-major (wgmma's transpose bits); each block sweeps
//                     a contiguous chunk of rows, the chunks of a cluster
//                     (up to 8) are summed in rank order through
//                     distributed shared memory, and the few cluster
//                     partials in order after it: no float atomics, the
//                     same bits every run and on every card
//
// The rounding points are the fp32 path's (fused_encoder_layer.cu's header);
// tanh-gelu is evaluated as x sigmoid(2 u), the same function through one
// exponential.
//
// Layout rule (ops/fused_encoder_layer.py kernel_route, checked before any
// launch): H, the head dim and F multiples of 8 and every operand 16-byte
// aligned (the wrapper copies one that is not), so every row of every
// matrix is a whole number of 16-byte chunks; H <= 512, head dim <= 128.
#pragma once

#include <algorithm>

#include <cooperative_groups.h>

#include "attention.cuh"
#include "common.cuh"
#include "flash_hopper.cuh"
#include "hopper.cuh"

namespace b4r {
namespace layer_hopper {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int kBlockThreads = 2 * kThreads;  // two warpgroups
constexpr int kKStep = 64;                   // contraction rows per stage
constexpr int kMaxStages = 4;
constexpr int kSmemBytes = 227 * 1024;  // a block's dynamic shared memory at most
// the ring's stages: 4 where shared memory allows (with bps blocks an SM
// sharing it), else 3 (every layout here fits 3)
constexpr int stages_for(int stage_bytes, int bps = 1) {
  return 1024 + kMaxStages * stage_bytes <= kSmemBytes / bps ? kMaxStages : kMaxStages - 1;
}
constexpr int kLnRowsBlock = 64;    // rows of one ln_rows_bwd_kernel block
constexpr int kWgradBlocks = 264;   // wgrad's grid aims at two blocks an SM
constexpr int kWgradMinSteps = 8;   // 64-row steps a wgrad block sweeps at least

// ---------------------------------------------------------------------------
// wgmma with both operands in shared memory, A (TA) and B (TB) transposed
// or not: m64nNk16, d = A B + d (the accumulators start at zero)
// ---------------------------------------------------------------------------
#define B4R_F8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_tr_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_tr_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24), B4R_F8(32), B4R_F8(40), B4R_F8(48),
        B4R_F8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_tr_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24), B4R_F8(32), B4R_F8(40), B4R_F8(48),
        B4R_F8(56), B4R_F8(64), B4R_F8(72), B4R_F8(80), B4R_F8(88), B4R_F8(96),
        B4R_F8(104), B4R_F8(112), B4R_F8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
#undef B4R_F8

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_tr(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64)
    wgmma_ss_tr_n64<TA, TB>(d, da, db);
  else if constexpr (N == 128)
    wgmma_ss_tr_n128<TA, TB>(d, da, db);
  else
    wgmma_ss_tr_n256<TA, TB>(d, da, db);
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------
// Rows t0 .. t0 + 64 kTiles - 1 of a row-major matrix (row stride ss
// elements; S rows, D columns from src) into kTiles consecutive swizzled
// [64][DP] tiles at dst, by the block's NT threads; rows past S and columns
// past D zero-filled.
template <int DP, int kTiles, int NT>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src, int ss, int t0,
                                          int S, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  constexpr int kTotal = kTiles * kRows * kChunks;
  static_assert(kTotal % NT == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kTotal / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / kChunks, c = idx % kChunks, t = t0 + r, rt = r & (kRows - 1);
    const int bytes = t < S ? min(16, max(0, 2 * (D - 8 * c))) : 0;
    const bf16* from = bytes ? src + (size_t)t * ss + 8 * c : src;
    cp_async16(dst + (r / kRows) * tile_bytes(DP) + (c >> 3) * kBlockBytes + rt * 128 +
                   (((c & 7) ^ (rt & 7)) << 4),
               from, bytes);
  }
}

template <int N> __device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// ---------------------------------------------------------------------------
// the products' main loop
// ---------------------------------------------------------------------------
// one product's operands: A [M, K] (row stride lda), W [K, N] (row stride ldw)
struct Product {
  const bf16* a;
  int lda;
  const bf16* w;
  int ldw;
};

// A block of WM x WN warpgroups, each 64 rows x BN columns, NP products over
// the same K
template <int WM, int WN, int BN, int NP, int BPS = 1>
struct Tiles {
  static_assert(WM * WN == 2 && BN % 64 == 0 && BN <= 256, "two warpgroups, N <= 256");
  static constexpr int kCols = BN * WN;                 // the block's columns
  static constexpr int kA = WM * tile_bytes(kKStep);    // a stage's A tiles
  static constexpr int kB = tile_bytes(kCols);          // a stage's W tile
  static constexpr int kStage = NP * (kA + kB);
  static constexpr int kST = stages_for(kStage, BPS);
  static constexpr size_t kSmem = 1024 + (size_t)kST * kStage;
  static_assert(BPS == 1 || kSmem * BPS <= kSmemBytes, "the blocks an SM holds");
};

// The thread's place in the block: its warpgroup (wm, wn), its accumulator
// rows rl, rl + 8 inside the block and its first column c0 (element
// 4 j + 2 h + e is row rl + 8 h, column c0 + 8 j + e)
template <int WM, int BN>
struct Place {
  int wm, wn, rl, c0, tq, lane, warp;
  __device__ __forceinline__ Place() {
    const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127;
    wm = wg % WM;
    wn = wg / WM;
    tq = lt & 3;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    rl = wm * kRows + 16 * (lt >> 5) + ((lt & 31) >> 2);
    c0 = wn * BN + 2 * tq;
  }
};

template <int N> __device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The ring's schedule, shared by every product loop: ST stages, the copies
// of steps ks + 1 .. ks + ST - 2 in flight while step ks's products run, and
// step ks - 1's products still running when step ks's are issued (one
// wgmma group in flight besides the newest). One barrier a step: it makes
// step ks's copies visible to every warpgroup and, since each warpgroup
// waited on its products of step ks - 2 before it, frees that step's stage
// for the copies of step ks + ST - 2. prefetch(ks) fills stage ks % ST,
// products(stage) issues the step's wgmma.
template <int ST, typename Prefetch, typename Products>
__device__ __forceinline__ void ring(int nk, Prefetch&& prefetch, Products&& products) {
  constexpr int D = ST - 2;
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < nk) prefetch(s);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<D - 1>();
    fence_async_smem();
    __syncthreads();
    if (ks + D < nk) prefetch(ks + D);
    cp_async_commit();
    wgmma_fence();
    products(ks % ST);
    wgmma_commit();
    wgmma_wait_n<1>();
  }
  wgmma_wait_n<0>();
  cp_async_wait<0>();
  __syncthreads();
}

// acc[p] = A_p[m0 .. m0 + 64 WM) W_p[:, n0 .. n0 + BN WN) for this thread's
// warpgroup; leaves every copy and product done and the shared memory free.
template <int WM, int WN, int BN, int NP, int BPS = 1>
__device__ __forceinline__ void mainloop(float (&acc)[NP][BN / 2], const Product (&pr)[NP],
                                         int M, int K, int N, int m0, int n0, uint32_t sm) {
  using L = Tiles<WM, WN, BN, NP, BPS>;
  const int wg = threadIdx.x >> 7, wm = wg % WM, wn = wg / WM;
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(acc[p]);
  ring<L::kST>(
      cdiv(K, kKStep),
      [&](int ks) {
        const uint32_t st = sm + (ks % L::kST) * L::kStage;
        const int k0 = ks * kKStep;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint32_t at = st + p * (L::kA + L::kB);
          copy_rows<kKStep, WM, kBlockThreads>(at, pr[p].a + k0, pr[p].lda, m0, M, K - k0);
          copy_rows<L::kCols, 1, kBlockThreads>(at + L::kA, pr[p].w + n0, pr[p].ldw, k0, K,
                                                N - n0);
        }
      },
      [&](int stage) {
        const uint32_t st = sm + stage * L::kStage;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          fence_regs(acc[p]);
          const uint32_t at = st + p * (L::kA + L::kB) + wm * tile_bytes(kKStep);
          const uint32_t bt = st + p * (L::kA + L::kB) + L::kA + wn * (BN / 64) * kBlockBytes;
#pragma unroll
          for (int kk = 0; kk < kKStep / 16; ++kk)
            wgmma_ss_tr<BN, 0, 1>(acc[p], k_desc(at, kk), mn_desc(bt, kk));
        }
      });
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
}

// Output staging: the block's bf16 results go to shared memory first (row
// stride ld elements, 16 bytes of padding: conflict-free 4-byte writes), then
// out as whole 16-byte chunks, each warp writing whole lines.
__device__ __forceinline__ void stage_bf2(bf16* tile, int ld, int row, int col, float a,
                                          float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + row * ld + col) = __floats2bfloat162_rn(a, b);
}
// rows [0, rows) x columns [0, cols) of the staged tile into out (row
// stride n, rows past M and columns past N dropped; N % 8 == 0), after a
// barrier
template <int NT>
__device__ __forceinline__ void flush_bf16(const bf16* tile, int ld, int rows, int cols,
                                           bf16* out, int n, int m0, int n0, int M, int N) {
  __syncthreads();
  const int chunks = cols / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += NT) {
    const int r = idx / chunks, c = 8 * (idx % chunks);
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * n + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * ld + c);
  }
}

// tanh-approximate gelu and its derivative for the bf16 path, as
// x sigmoid(2 u) (u the tanh argument): the same function as common.cuh's
// tanh form, through one exponential (fp32 kernels keep tanhf)
__device__ __forceinline__ float gelu_sig(float x) {
  const float u = kGeluC * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.0f + __expf(-2.0f * u));
}
__device__ __forceinline__ float gelu_sig_grad(float x) {
  const float u = kGeluC * (x + 0.044715f * x * x * x);
  const float s = __fdividef(1.0f, 1.0f + __expf(-2.0f * u));  // (1 + tanh u) / 2
  const float du = kGeluC * (1.0f + 3.0f * 0.044715f * x * x);
  return s + 2.0f * x * s * (1.0f - s) * du;
}

__device__ __forceinline__ float quad_col_sum(float v) {  // over the 8 rows of a warp
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// out[i] = sum_r part[r * n + i]: the partials' second pass, 32 columns a
// block, each of its 8 warps summing every 8th row in order, then the 8
// warp sums in order (a fixed order: the same bits every run). common.cuh's
// reduce_rows (one thread a column) stays as it is: the fp32 kernels keep
// their bits.
__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, int n) {
  __shared__ float red[8][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < n)
    for (int r = warp; r < rows; r += 8) s += part[(size_t)r * n + col];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][lane];
    out[col] = t;
  }
}

inline cudaError_t sum_rows(const float* part, float* out, int rows, int n,
                            cudaStream_t stream) {
  sum_rows_kernel<<<ceil_div(n, 32), 256, 0, stream>>>(part, out, rows, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C = T(epi(A W)), 128 x BN tiles
// ---------------------------------------------------------------------------
enum { kEpiBias = 0, kEpiBiasGelu = 1, kEpiNone = 2, kEpiAddF32 = 3 };
// blocks an SM holds: 128-column tiles, two blocks an SM, so that one
// block's epilogue runs beside the other's products (faster at every layer
// shape than 256-column tiles with one block an SM, whose epilogue leaves
// the tensor cores idle)
constexpr int kGemmBlocks = 2;

template <int BN>
__global__ void __launch_bounds__(kBlockThreads, kGemmBlocks)
gemm_kernel(Product pr, const float* __restrict__ bias, const float* __restrict__ r32,
            bf16* __restrict__ C, int M, int K, int N, int epi) {
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * 2 * kRows, n0 = blockIdx.y * BN;
  float acc[1][BN / 2];
  const Product prs[1] = {pr};
  mainloop<2, 1, BN, 1, kGemmBlocks>(acc, prs, M, K, N, m0, n0, smem_u32(sm));
  const Place<2, BN> t;
  constexpr int kLd = BN + 8;
  bf16* tile = reinterpret_cast<bf16*>(sm);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int lc = t.c0 + 8 * j, c = n0 + lc;  // c < N implies c + 1 < N (N even)
    const bool cok = c < N;
    float b0 = 0.f, b1 = 0.f;
    if (cok && (epi == kEpiBias || epi == kEpiBiasGelu)) {
      b0 = bias[c];
      b1 = bias[c + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + t.rl + 8 * h;
      float v0 = acc[0][4 * j + 2 * h] + b0, v1 = acc[0][4 * j + 2 * h + 1] + b1;
      if (epi == kEpiBiasGelu) {
        v0 = gelu_sig(v0);
        v1 = gelu_sig(v1);
      }
      if (epi == kEpiAddF32 && cok && r < M) {
        const float2 rr = *reinterpret_cast<const float2*>(r32 + (size_t)r * N + c);
        v0 = rr.x + v0;
        v1 = rr.y + v1;
      }
      stage_bf2(tile, kLd, t.rl + 8 * h, lc, v0, v1);
    }
  }
  flush_bf16<kBlockThreads>(tile, kLd, 2 * kRows, BN, C, N, m0, n0, M, N);
}

// ---------------------------------------------------------------------------
// dHpre = T((dF W2^T) gelu'(X1 W1 + bf1)) with dbf1's column partials
// part[row block][F] (sums of the unrounded value), 128 x BN tiles
// ---------------------------------------------------------------------------
template <int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
gelu_grad_kernel(Product dhact, Product hpre, const float* __restrict__ bf1,
                 bf16* __restrict__ dhpre, float* __restrict__ part, int M, int F, int H) {
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * 2 * kRows, n0 = blockIdx.y * BN;
  float acc[2][BN / 2];
  const Product prs[2] = {dhact, hpre};
  mainloop<2, 1, BN, 2>(acc, prs, M, H, F, m0, n0, smem_u32(sm));
  const Place<2, BN> t;
  constexpr int kLd = BN + 8;
  bf16* tile = reinterpret_cast<bf16*>(sm);                          // [128][kLd]
  float* red = reinterpret_cast<float*>(sm + 2 * kRows * kLd * 2);  // [8 warps][BN]
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int lc = t.c0 + 8 * j, c = n0 + lc;
    const bool cok = c < F;
    const float b0 = cok ? bf1[c] : 0.f, b1 = cok ? bf1[c + 1] : 0.f;
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + t.rl + 8 * h, i = 4 * j + 2 * h;
      const float v0 = acc[0][i] * gelu_sig_grad(acc[1][i] + b0);
      const float v1 = acc[0][i + 1] * gelu_sig_grad(acc[1][i + 1] + b1);
      stage_bf2(tile, kLd, t.rl + 8 * h, lc, v0, v1);
      if (cok && r < M) {
        cs0 += v0;
        cs1 += v1;
      }
    }
    cs0 = quad_col_sum(cs0);
    cs1 = quad_col_sum(cs1);
    if (t.lane < 4) {
      red[t.warp * BN + lc] = cs0;
      red[t.warp * BN + lc + 1] = cs1;
    }
  }
  flush_bf16<kBlockThreads>(tile, kLd, 2 * kRows, BN, dhpre, F, m0, n0, M, F);
  for (int c = threadIdx.x; c < BN; c += kBlockThreads) {
    if (n0 + c >= F) continue;
    float s = 0.f;
    for (int w = 0; w < kBlockThreads / 32; ++w) s += red[w * BN + c];
    part[(size_t)blockIdx.x * F + n0 + c] = s;
  }
}

// ---------------------------------------------------------------------------
// the row-owning products with LayerNorm. HP = H rounded up to 64, 128, 256
// or 512: WM = 2, WN = 1 up to 256 (128 rows a block), else WM = 1, WN = 2
// (64 rows, the columns split between the warpgroups). The product's fp32
// tile goes to shared memory (row stride HP + 8 floats: conflict-free
// 8-byte writes); then each of the 8 warps takes whole rows, a lane 8
// columns at a time, so that every read and write of the epilogue is a
// 16-byte access and a warp moves whole lines (kT = HP / 256 chunks of 8
// columns a lane, at least 1).
// ---------------------------------------------------------------------------
template <int HP>
struct RowShape {
  static constexpr int WM = HP <= 256 ? 2 : 1, WN = 2 / WM, BN = HP / WN, kRowsB = WM * kRows;
  static constexpr int kLd = HP + 8;
  // the ring, or the fp32 tile with the backward's [8][3][HP] partials
  static constexpr size_t kRing = Tiles<WM, WN, BN, 1>::kSmem;
  static constexpr size_t kTile = 1024 + (size_t)(kRowsB * kLd + 8 * 3 * HP) * 4;
  static constexpr size_t kSmem = kRing > kTile ? kRing : kTile;
};

// the warpgroup's accumulator into the block's fp32 tile xs (row stride ld)
template <int WM, int BN>
__device__ __forceinline__ void spill_acc(float* xs, int ld, const float (&acc)[BN / 2]) {
  const Place<WM, BN> t;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(xs + (t.rl + 8 * h) * ld + t.c0 + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(b2[i]);
    v[2 * i + 1] = __high2float(b2[i]);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 packed;
  packed.x = pack_bf16(v[0], v[1]);
  packed.y = pack_bf16(v[2], v[3]);
  packed.z = pack_bf16(v[4], v[5]);
  packed.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = packed;
}

// The row phase's lanes: kL lanes a row (8 columns each, kT chunks of 8
// a lane), 32 / kL rows a warp at a time, so that narrow rows keep every
// lane busy. Sums over a row's lanes: group_sum.
template <int HP>
struct RowLanes {
  static constexpr int kL = HP >= 256 ? 32 : HP / 8, kT = HP / (8 * kL);
};
template <int kL> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kL / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + rows) of Y = T(LN(R + (xs + bias) keep(site)) gamma +
// beta), xs the product's fp32 rows in shared memory; in training also xhat
// and rstd. Each warp takes kU groups of 32 / kL rows at a time (their
// loads in flight together), the block's 8 warps every 8th such set.
constexpr int kU = 2;
template <int HP>
__device__ __forceinline__ void ln_fwd_rows(const float* xs, int ld, int row0, int rows,
                                            const float* __restrict__ bias,
                                            const bf16* __restrict__ R,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta,
                                            bf16* __restrict__ Y, float* __restrict__ xhat_out,
                                            float* __restrict__ rstd_out, Drop drop, int site,
                                            int S, int M, int H) {
  constexpr int kL = RowLanes<HP>::kL, kT = RowLanes<HP>::kT, kPer = 32 / kL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane / kL, gl = lane % kL;
  const float inv_h = 1.0f / (float)H;
  for (int rb = warp * kPer * kU; rb < rows; rb += (kBlockThreads / 32) * kPer * kU) {
    float u[kU][kT][8], sum[kU], mean[kU], sq[kU], rstd[kU];
    int rr[kU], r[kU];
    bool ok[kU];
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      rr[q] = rb + q * kPer + sub;
      r[q] = row0 + rr[q];
      ok[q] = rr[q] < rows && r[q] < M;
      const uint32_t sk = site_key(drop, r[q] / S, site);
      const int srow = r[q] % S;
      sum[q] = 0.f;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int c = 8 * (gl + kL * t);
#pragma unroll
        for (int i = 0; i < 8; ++i) u[q][t][i] = 0.f;
        if (!ok[q] || c >= H) continue;
        float x[8], b[8], res[8];
        load8(x, xs + rr[q] * ld + c);
        load8(b, bias + c);
        load8(res, R + (size_t)r[q] * H + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = x[i] + b[i];
          if (drop.on) v *= keep_scale_k(drop, sk, (uint32_t)(srow * H + c + i));
          u[q][t][i] = res[i] + v;
          sum[q] += u[q][t][i];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) mean[q] = group_sum<kL>(sum[q]) * inv_h;
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      sq[q] = 0.f;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (8 * (gl + kL * t) >= H) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = u[q][t][i] - mean[q];
          sq[q] += d * d;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) rstd[q] = rsqrtf(group_sum<kL>(sq[q]) * inv_h + kLnEps);
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      if (!ok[q]) continue;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int c = 8 * (gl + kL * t);
        if (c >= H) continue;
        float g[8], e[8], xh[8], y[8];
        load8(g, gamma + c);
        load8(e, beta + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xh[i] = (u[q][t][i] - mean[q]) * rstd[q];
          y[i] = xh[i] * g[i] + e[i];
        }
        store8(Y + (size_t)r[q] * H + c, y);
        if (xhat_out) store8(xhat_out + (size_t)r[q] * H + c, xh);
      }
      if (rstd_out && gl == 0) rstd_out[r[q]] = rstd[q];
    }
  }
}

// Rows [row0, row0 + rows) of LayerNorm's backward, gin = dy (xs null) or
// xs + R32 (the dx1 product's rows in shared memory):
//   dout = rstd (gin g - mean(gin g) - xhat mean(gin g xhat))   (fp32)
//   dmask = dout keep(site)                                     (-> T)
// and the block's column partials part_row[3 H] of sum(gin xhat),
// sum(gin), sum(dmask), through red ([8 warps][3][H] floats of shared
// memory, each warp's rows summed first). Rows taken as in ln_fwd_rows.
template <int HP>
__device__ __forceinline__ void ln_bwd_rows(const float* xs, int ld, int row0, int rows,
                                            const bf16* __restrict__ dy,
                                            const float* __restrict__ R32,
                                            const float* __restrict__ xhat,
                                            const float* __restrict__ rstd,
                                            const float* __restrict__ gamma, Drop drop,
                                            int site, int S, float* __restrict__ dout32,
                                            bf16* __restrict__ dmask, float* red,
                                            float* __restrict__ part_row, int M, int H) {
  constexpr int kL = RowLanes<HP>::kL, kT = RowLanes<HP>::kT, kPer = 32 / kL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane / kL, gl = lane % kL;
  const float inv_h = 1.0f / (float)H;
  float gm[kT][8], p[3][kT][8];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int c = 8 * (gl + kL * t);
#pragma unroll
    for (int i = 0; i < 8; ++i) p[0][t][i] = p[1][t][i] = p[2][t][i] = gm[t][i] = 0.f;
    if (c < H) load8(gm[t], gamma + c);
  }
  for (int rb = warp * kPer * kU; rb < rows; rb += (kBlockThreads / 32) * kPer * kU) {
    float gv[kU][kT][8], xv[kU][kT][8], s1[kU], s2[kU], mean1[kU], mean2[kU];
    int rr[kU], r[kU];
    bool ok[kU];
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      rr[q] = rb + q * kPer + sub;
      r[q] = row0 + rr[q];
      ok[q] = rr[q] < rows && r[q] < M;
      s1[q] = s2[q] = 0.f;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int c = 8 * (gl + kL * t);
#pragma unroll
        for (int i = 0; i < 8; ++i) gv[q][t][i] = xv[q][t][i] = 0.f;
        if (!ok[q] || c >= H) continue;
        const size_t at = (size_t)r[q] * H + c;
        if (xs) {
          float x[8];
          load8(x, xs + rr[q] * ld + c);
          load8(gv[q][t], R32 + at);
#pragma unroll
          for (int i = 0; i < 8; ++i) gv[q][t][i] = gv[q][t][i] + x[i];
        } else {
          load8(gv[q][t], dy + at);
        }
        load8(xv[q][t], xhat + at);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          p[0][t][i] += gv[q][t][i] * xv[q][t][i];
          p[1][t][i] += gv[q][t][i];
          const float dxh = gv[q][t][i] * gm[t][i];
          s1[q] += dxh;
          s2[q] += dxh * xv[q][t][i];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      mean1[q] = group_sum<kL>(s1[q]) * inv_h;
      mean2[q] = group_sum<kL>(s2[q]) * inv_h;
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      if (!ok[q]) continue;
      const float rs = rstd[r[q]];
      const uint32_t sk = site_key(drop, r[q] / S, site);
      const int srow = r[q] % S;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int c = 8 * (gl + kL * t);
        if (c >= H) continue;
        float d[8], m[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          d[i] = rs * (gv[q][t][i] * gm[t][i] - mean1[q] - xv[q][t][i] * mean2[q]);
          m[i] = drop.on ? d[i] * keep_scale_k(drop, sk, (uint32_t)(srow * H + c + i)) : d[i];
          p[2][t][i] += m[i];
        }
        store8(dout32 + (size_t)r[q] * H + c, d);
        store8(dmask + (size_t)r[q] * H + c, m);
      }
    }
  }
  // the warp's rows: its kPer row groups summed in order
#pragma unroll
  for (int o = kL; o < 32; o <<= 1)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int t = 0; t < kT; ++t)
#pragma unroll
        for (int i = 0; i < 8; ++i) p[q][t][i] += __shfl_xor_sync(0xffffffffu, p[q][t][i], o);
  if (sub == 0)
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = 8 * (gl + kL * t);
      if (c >= H) continue;
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) red[(warp * 3 + q) * H + c + i] = p[q][t][i];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * H; idx += kBlockThreads) {
    float s = 0.f;
    for (int w = 0; w < kBlockThreads / 32; ++w) s += red[w * 3 * H + idx];
    part_row[idx] = s;
  }
}

// Y = T(LN(R + (A W + bias) keep(site)) gamma + beta); in training also xhat
// (fp32 [M, H]) and rstd ([M]).
template <int HP>
__global__ void __launch_bounds__(kBlockThreads, 1)
ln_fwd_kernel(Product pr, int K, const float* __restrict__ bias, const bf16* __restrict__ R,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              bf16* __restrict__ Y, float* __restrict__ xhat_out, float* __restrict__ rstd_out,
              Drop drop, int site, int S, int M, int H) {
  using RS = RowShape<HP>;
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * RS::kRowsB;
  float acc[1][RS::BN / 2];
  const Product prs[1] = {pr};
  mainloop<RS::WM, RS::WN, RS::BN, 1>(acc, prs, M, K, H, m0, 0, smem_u32(sm));
  float* xs = reinterpret_cast<float*>(sm);
  spill_acc<RS::WM, RS::BN>(xs, RS::kLd, acc[0]);
  __syncthreads();
  ln_fwd_rows<HP>(xs, RS::kLd, m0, RS::kRowsB, bias, R, gamma, beta, Y, xhat_out,
                      rstd_out, drop, site, S, M, H);
}

// LayerNorm's backward after a product, gin = R32 + A W (ln_bwd_rows), its
// column partials in part[block][3 H]
template <int HP>
__global__ void __launch_bounds__(kBlockThreads, 1)
ln_bwd_kernel(Product pr, int K, const float* __restrict__ R32,
              const float* __restrict__ xhat, const float* __restrict__ rstd,
              const float* __restrict__ gamma, Drop drop, int site, int S,
              float* __restrict__ dout32, bf16* __restrict__ dmask, float* __restrict__ part,
              int M, int H) {
  using RS = RowShape<HP>;
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * RS::kRowsB;
  float acc[1][RS::BN / 2];
  const Product prs[1] = {pr};
  mainloop<RS::WM, RS::WN, RS::BN, 1>(acc, prs, M, K, H, m0, 0, smem_u32(sm));
  float* xs = reinterpret_cast<float*>(sm);
  float* red = xs + RS::kRowsB * RS::kLd;  // [8 warps][3][H]
  spill_acc<RS::WM, RS::BN>(xs, RS::kLd, acc[0]);
  __syncthreads();
  ln_bwd_rows<HP>(xs, RS::kLd, m0, RS::kRowsB, nullptr, R32, xhat, rstd, gamma, drop,
                      site, S, dout32, dmask, red, part + (size_t)blockIdx.x * 3 * H, M, H);
}

// LayerNorm's backward of dy (no product): kLnRowsBlock rows a block
template <int HP>
__global__ void __launch_bounds__(kBlockThreads)
ln_rows_bwd_kernel(const bf16* __restrict__ dy, const float* __restrict__ xhat,
                   const float* __restrict__ rstd, const float* __restrict__ gamma, Drop drop,
                   int site, int S, float* __restrict__ dout32, bf16* __restrict__ dmask,
                   float* __restrict__ part, int M, int H) {
  extern __shared__ float red[];  // [8 warps][3][H]
  ln_bwd_rows<HP>(nullptr, 0, blockIdx.x * kLnRowsBlock, kLnRowsBlock, dy, nullptr, xhat,
                  rstd, gamma, drop, site, S, dout32, dmask, red,
                  part + (size_t)blockIdx.x * 3 * H, M, H);
}

// ---------------------------------------------------------------------------
// dW[K1, N] = A^T B over the M rows (A [M, K1], B [M, N] bf16, row-major).
// A block (two warpgroups) owns a 128 x BN tile of dW and sweeps a chunk of
// rows; block `rank` of a cluster of C takes chunk g C + rank of the tile's
// cluster group g. The A tile is 64 rows x 128 columns (each warpgroup's
// 64 columns one block, its M), read MN-major (transpose bit of A), the B
// tile 64 rows x BN columns, MN-major. The cluster's C fp32 tiles are summed
// in rank order through distributed shared memory, each block summing
// 128 / C rows of all C, into out: dW itself with one group, else the
// group's partial [groups][K1][N] (summed in order by reduce_rows).
// ---------------------------------------------------------------------------
template <int BN>
struct WgradTiles {
  static constexpr int kA = tile_bytes(2 * kRows);  // 64 rows x 128 columns
  static constexpr int kB = tile_bytes(BN);
  static constexpr int kStage = kA + kB;
  static constexpr int kLd = BN + 8;                // the fp32 exchange tile's row stride
  static constexpr int kST = stages_for(kStage);
  static constexpr size_t kRing = (size_t)kST * kStage;
  static constexpr size_t kXch = (size_t)2 * kRows * kLd * 4;
  static constexpr size_t kSmem = 1024 + (kRing > kXch ? kRing : kXch);
};

template <int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm, float* __restrict__ out,
             int M, int K1, int N, int chunk_rows, int groups) {
  using L = WgradTiles<BN>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = (int)blockIdx.x / C, tile = cid / groups, grp = cid % groups;
  const int ntiles = cdiv(N, BN);
  const int k0 = (tile / ntiles) * 2 * kRows, n0 = (tile % ntiles) * BN;
  const int m_begin = (grp * C + rank) * chunk_rows;
  const int m_end = min(M, m_begin + chunk_rows);
  const int nk = m_end > m_begin ? cdiv(m_end - m_begin, kRows) : 0;
  uint8_t* sm = aligned_smem();
  const uint32_t sbase = smem_u32(sm);
  const int wm = threadIdx.x >> 7;

  float acc[BN / 2];
  zero(acc);
  ring<L::kST>(
      nk,
      [&](int ks) {
        const uint32_t st = sbase + (ks % L::kST) * L::kStage;
        const int m = m_begin + ks * kRows;
        copy_rows<2 * kRows, 1, kBlockThreads>(st, A + k0, K1, m, m_end, K1 - k0);
        copy_rows<BN, 1, kBlockThreads>(st + L::kA, Bm + n0, N, m, m_end, N - n0);
      },
      [&](int stage) {
        const uint32_t st = sbase + stage * L::kStage;
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_ss_tr<BN, 1, 1>(acc, mn_desc(st + wm * kBlockBytes, kk),
                                mn_desc(st + L::kA, kk));
      });
  fence_regs(acc);

  // this block's fp32 tile, then the cluster's sum in rank order
  float* xch = reinterpret_cast<float*>(sm);
  const Place<2, BN> t;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(xch + (t.rl + 8 * h) * L::kLd + t.c0 + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  cluster.sync();
  const int rows = 2 * kRows / C, r0 = rank * rows;
  float* dst = out + (size_t)grp * K1 * N;
  for (int idx = threadIdx.x; idx < rows * (BN / 4); idx += kBlockThreads) {
    const int row = r0 + idx / (BN / 4), col = 4 * (idx % (BN / 4));
    const int k = k0 + row, n = n0 + col;  // n < N implies n + 3 < N (N % 8 == 0)
    if (k >= K1 || n >= N) continue;
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C)
        v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(xch, q) +
                                                row * L::kLd + col);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q >= C) break;
      sum.x += v[q].x;
      sum.y += v[q].y;
      sum.z += v[q].z;
      sum.w += v[q].w;
    }
    *reinterpret_cast<float4*>(dst + (size_t)k * N + n) = sum;
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

// ---------------------------------------------------------------------------
// launches (host)
// ---------------------------------------------------------------------------
inline int column_tile(int N) { return N % 256 == 0 ? 256 : N >= 128 ? 128 : 64; }
inline int padded_hidden(int H) { return H <= 64 ? 64 : H <= 128 ? 128 : H <= 256 ? 256 : 512; }

// A weight gradient's split: the column tile, the cluster size, the number
// of cluster groups (partials) and the rows each block sweeps. It depends on
// the shapes only, so the sums run in the same order on every card.
struct WgradPlan {
  int bn, cluster, groups, chunk_rows;
};
inline WgradPlan wgrad_plan(int M, int K1, int N) {
  WgradPlan p;
  p.bn = column_tile(N);
  const int tiles = ceil_div(K1, 2 * kRows) * ceil_div(N, p.bn);
  const int steps = ceil_div(M, kRows);
  int splits = ceil_div(kWgradBlocks, tiles);
  splits = std::max(1, std::min(splits, steps / kWgradMinSteps));
  p.cluster = 1;
  while (2 * p.cluster <= std::min(splits, kMaxCluster)) p.cluster *= 2;
  p.groups = ceil_div(splits, p.cluster);
  p.chunk_rows = ceil_div(steps, p.cluster * p.groups) * kRows;
  return p;
}
// floats of the partials a wgrad needs beyond dW
inline size_t wgrad_scratch(int M, int K1, int N) {
  const WgradPlan p = wgrad_plan(M, K1, N);
  return p.groups > 1 ? (size_t)p.groups * K1 * N : 0;
}

template <int BN>
cudaError_t launch_wgrad(const bf16* A, const bf16* B, float* out, int M, int K1, int N,
                         const WgradPlan& p, cudaStream_t stream) {
  const int tiles = ceil_div(K1, 2 * kRows) * ceil_div(N, BN);
  return launch_clusters_n(wgrad_kernel<BN>, tiles * p.groups * p.cluster, p.cluster,
                           kBlockThreads, WgradTiles<BN>::kSmem, stream, A, B, out, M, K1, N,
                           p.chunk_rows, p.groups);
}

// dW = A^T B; scratch holds wgrad_scratch(M, K1, N) floats
inline cudaError_t wgrad(const bf16* A, const bf16* B, float* scratch, float* dW, int M,
                         int K1, int N, cudaStream_t stream) {
  const WgradPlan p = wgrad_plan(M, K1, N);
  float* out = p.groups > 1 ? scratch : dW;
  cudaError_t err;
  switch (p.bn) {
    case 256: err = launch_wgrad<256>(A, B, out, M, K1, N, p, stream); break;
    case 128: err = launch_wgrad<128>(A, B, out, M, K1, N, p, stream); break;
    default: err = launch_wgrad<64>(A, B, out, M, K1, N, p, stream); break;
  }
  if (err != cudaSuccess || p.groups == 1) return err;
  return sum_rows(scratch, dW, p.groups, K1 * N, stream);
}

template <int BN>
cudaError_t launch_gemm(const Product& pr, const float* bias, const float* r32, bf16* C, int M,
                        int K, int N, int epi, cudaStream_t stream) {
  using L = Tiles<2, 1, BN, 1, kGemmBlocks>;
  cudaError_t err = allow_smem(gemm_kernel<BN>, L::kSmem);
  if (err != cudaSuccess) return err;
  gemm_kernel<BN><<<dim3(ceil_div(M, 2 * kRows), ceil_div(N, BN)), kBlockThreads,
                         L::kSmem, stream>>>(pr, bias, r32, C, M, K, N, epi);
  return cudaGetLastError();
}

// C[M, N] = T(epi(A[M, K] W[K, N]))
inline cudaError_t gemm(const bf16* A, const bf16* W, const float* bias, const float* r32,
                        bf16* C, int M, int K, int N, int epi, cudaStream_t stream) {
  const Product pr{A, K, W, N};
  if (N >= 128) return launch_gemm<128>(pr, bias, r32, C, M, K, N, epi, stream);
  return launch_gemm<64>(pr, bias, r32, C, M, K, N, epi, stream);
}

template <int BN>
cudaError_t launch_gelu_grad(const Product& dh, const Product& hp, const float* bf1,
                             bf16* dhpre, float* part, int M, int F, int H,
                             cudaStream_t stream) {
  using L = Tiles<2, 1, BN, 2>;
  cudaError_t err = allow_smem(gelu_grad_kernel<BN>, L::kSmem);
  if (err != cudaSuccess) return err;
  gelu_grad_kernel<BN><<<dim3(ceil_div(M, 2 * kRows), ceil_div(F, BN)), kBlockThreads,
                         L::kSmem, stream>>>(dh, hp, bf1, dhpre, part, M, F, H);
  return cudaGetLastError();
}

// dhpre = T((df W2^T) gelu'(x1 W1 + bf1)) with w2t = W2^T [H, F]; part holds
// gelu_grad_blocks(M) x F floats
inline int gelu_grad_blocks(int M) { return ceil_div(M, 2 * kRows); }
inline cudaError_t gelu_grad(const bf16* df, const bf16* w2t, const bf16* x1, const bf16* w1,
                             const float* bf1, bf16* dhpre, float* part, int M, int F, int H,
                             cudaStream_t stream) {
  const Product dh{df, H, w2t, F}, hp{x1, H, w1, F};
  if (F >= 128) return launch_gelu_grad<128>(dh, hp, bf1, dhpre, part, M, F, H, stream);
  return launch_gelu_grad<64>(dh, hp, bf1, dhpre, part, M, F, H, stream);
}

// blocks (and so partial rows) of the row-owning kernels
inline int ln_blocks(int M, int H) {
  return ceil_div(M, padded_hidden(H) <= 256 ? 2 * kRows : kRows);
}

template <int HP>
cudaError_t launch_ln_fwd(const Product& pr, int K, const float* bias, const bf16* R,
                          const float* gamma, const float* beta, bf16* Y, float* xhat,
                          float* rstd, Drop drop, int site, int S, int M, int H,
                          cudaStream_t stream) {
  using RS = RowShape<HP>;
  const size_t smem = RS::kSmem;
  cudaError_t err = allow_smem(ln_fwd_kernel<HP>, smem);
  if (err != cudaSuccess) return err;
  ln_fwd_kernel<HP><<<ceil_div(M, RS::kRowsB), kBlockThreads, smem, stream>>>(
      pr, K, bias, R, gamma, beta, Y, xhat, rstd, drop, site, S, M, H);
  return cudaGetLastError();
}

// Y = T(LN(R + (A W + bias) keep(site)) gamma + beta), A [M, K], W [K, H]
inline cudaError_t ln_fwd(const bf16* A, const bf16* W, int K, const float* bias,
                          const bf16* R, const float* gamma, const float* beta, bf16* Y,
                          float* xhat, float* rstd, Drop drop, int site, int S, int M, int H,
                          cudaStream_t stream) {
  const Product pr{A, K, W, H};
#define B4R_LNF(HPV) \
  launch_ln_fwd<HPV>(pr, K, bias, R, gamma, beta, Y, xhat, rstd, drop, site, S, M, H, stream)
  switch (padded_hidden(H)) {
    case 64: return B4R_LNF(64);
    case 128: return B4R_LNF(128);
    case 256: return B4R_LNF(256);
    default: return B4R_LNF(512);
  }
#undef B4R_LNF
}

template <int HP>
cudaError_t launch_ln_bwd(const Product& pr, int K, const float* R32, const float* xhat,
                          const float* rstd, const float* gamma, Drop drop, int site, int S,
                          float* dout32, bf16* dmask, float* part, int M, int H,
                          cudaStream_t stream) {
  using RS = RowShape<HP>;
  const size_t smem = RS::kSmem;
  cudaError_t err = allow_smem(ln_bwd_kernel<HP>, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<HP><<<ceil_div(M, RS::kRowsB), kBlockThreads, smem, stream>>>(
      pr, K, R32, xhat, rstd, gamma, drop, site, S, dout32, dmask, part, M, H);
  return cudaGetLastError();
}

// LN's backward of gin = R32 + A W (A [M, K], W [K, H]); part holds
// ln_blocks(M, H) x 3 H floats
inline cudaError_t ln_bwd(const bf16* A, const bf16* W, int K, const float* R32,
                          const float* xhat, const float* rstd, const float* gamma, Drop drop,
                          int site, int S, float* dout32, bf16* dmask, float* part, int M,
                          int H, cudaStream_t stream) {
  const Product pr{A, K, W, H};
#define B4R_LNB(HPV)                                                                   \
  launch_ln_bwd<HPV>(pr, K, R32, xhat, rstd, gamma, drop, site, S, dout32, dmask, part, \
                     M, H, stream)
  switch (padded_hidden(H)) {
    case 64: return B4R_LNB(64);
    case 128: return B4R_LNB(128);
    case 256: return B4R_LNB(256);
    default: return B4R_LNB(512);
  }
#undef B4R_LNB
}

// LN's backward of dy (no product); part holds ceil(M / 64) x 3 H floats
inline int ln_rows_blocks(int M) { return ceil_div(M, kLnRowsBlock); }
template <int HP>
cudaError_t launch_ln_rows_bwd(const bf16* dy, const float* xhat, const float* rstd,
                               const float* gamma, Drop drop, int site, int S, float* dout32,
                               bf16* dmask, float* part, int M, int H, cudaStream_t stream) {
  const size_t smem = (size_t)8 * 3 * H * 4;
  cudaError_t err = allow_smem(ln_rows_bwd_kernel<HP>, smem);
  if (err != cudaSuccess) return err;
  ln_rows_bwd_kernel<HP><<<ln_rows_blocks(M), kBlockThreads, smem, stream>>>(
      dy, xhat, rstd, gamma, drop, site, S, dout32, dmask, part, M, H);
  return cudaGetLastError();
}

inline cudaError_t ln_rows_bwd(const bf16* dy, const float* xhat, const float* rstd,
                               const float* gamma, Drop drop, int site, int S, float* dout32,
                               bf16* dmask, float* part, int M, int H, cudaStream_t stream) {
#define B4R_LNR(HPV) \
  launch_ln_rows_bwd<HPV>(dy, xhat, rstd, gamma, drop, site, S, dout32, dmask, part, M, H, stream)
  switch (padded_hidden(H)) {
    case 64: return B4R_LNR(64);
    case 128: return B4R_LNR(128);
    case 256: return B4R_LNR(256);
    default: return B4R_LNR(512);
  }
#undef B4R_LNR
}

// ---------------------------------------------------------------------------
// the attention core on flash_hopper.cuh's kernels, heads as strided views
// of the packed qkv (head dims up to 64 run in the DP = 64 tiles, zero-filled
// past D, up to 128 in DP = 128; head dims up to 32 run the score products
// over 32 columns only: the products with p and ds keep N = 64, half of it
// zeros, as wgmma's MN-major operands come in 64-column blocks)
// ---------------------------------------------------------------------------
// whether the relative bias takes 16-byte copies (S % 4 == 0, aligned slab)
inline int rel16(const float* rel, int S) {
  return rel && S % 4 == 0 && (reinterpret_cast<uintptr_t>(rel) & 15) == 0;
}

template <int DP, bool kRel, int DK>
cudaError_t attention_fwd_dp(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                             const int32_t* mask, Heads<bf16> o, float* stat_m, float* stat_l,
                             uint32_t* bits, Drop drop, int B, int S, int N, int D,
                             float scale, int causal, const float* rel, cudaStream_t stream) {
  const size_t smem = fwd_smem(DP, kRel);
  cudaError_t err = allow_smem(flash_fwd_kernel<DP, kRel, DK>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DP, kRel, DK><<<dim3(ceil_div(S, kRows), N, B), kThreads, smem, stream>>>(
      q, k, v, mask, o, stat_m, stat_l, bits, drop, S, N, D, scale, causal, rel,
      rel16(rel, S));
  return cudaGetLastError();
}

template <bool kRel>
cudaError_t attention_fwd(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                          const int32_t* mask, Heads<bf16> o, float* stat_m, float* stat_l,
                          uint32_t* bits, Drop drop, int B, int S, int N, int D, float scale,
                          int causal, const float* rel, cudaStream_t stream) {
  if (D <= 32)
    return attention_fwd_dp<64, kRel, 32>(q, k, v, mask, o, stat_m, stat_l, bits, drop, B, S,
                                          N, D, scale, causal, rel, stream);
  if (D <= 64)
    return attention_fwd_dp<64, kRel, 64>(q, k, v, mask, o, stat_m, stat_l, bits, drop, B, S,
                                          N, D, scale, causal, rel, stream);
  return attention_fwd_dp<128, kRel, 128>(q, k, v, mask, o, stat_m, stat_l, bits, drop, B, S, N,
                                     D, scale, causal, rel, stream);
}

template <int DP, bool kRel, int DK>
cudaError_t attention_bwd_dp(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                             Heads<const bf16> dout, const int32_t* mask, const float* stat_m,
                             const float* stat_l, const uint32_t* bits, Drop drop,
                             float* delta, Heads<bf16> dq, Heads<bf16> dk, Heads<bf16> dv,
                             float* part, int B, int S, int N, int D, float scale, int causal,
                             const float* rel, float* drel, cudaStream_t stream) {
  const dim3 grid(ceil_div(S, kRows), N, B);
  size_t smem = dq_smem(DP, kRel);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<DP, true, kRel, DK>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP, true, kRel, DK><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, mask, stat_m, stat_l, bits, drop, delta, dq, S, N, D, scale, causal, rel,
      rel16(rel, S), drel, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = dkv_smem(DP, kRel);
  if ((err = allow_smem(flash_bwd_dkv_kernel<DP, true, kRel, DK>, smem)) != cudaSuccess)
    return err;
  flash_bwd_dkv_kernel<DP, true, kRel, DK><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, mask, stat_m, stat_l, delta, bits, drop, dk, dv, S, N, D, scale, causal,
      rel, rel16(rel, S), part);
  return cudaGetLastError();
}

// dq, dk, dv and the per-tile column sums part [B * ceil(S / 64)][3 N D];
// with kRel, drel
template <bool kRel>
cudaError_t attention_bwd(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                          Heads<const bf16> dout, const int32_t* mask, const float* stat_m,
                          const float* stat_l, const uint32_t* bits, Drop drop, float* delta,
                          Heads<bf16> dq, Heads<bf16> dk, Heads<bf16> dv, float* part, int B,
                          int S, int N, int D, float scale, int causal, const float* rel,
                          float* drel, cudaStream_t stream) {
  if (D <= 32)
    return attention_bwd_dp<64, kRel, 32>(q, k, v, dout, mask, stat_m, stat_l, bits, drop,
                                          delta, dq, dk, dv, part, B, S, N, D, scale, causal,
                                          rel, drel, stream);
  if (D <= 64)
    return attention_bwd_dp<64, kRel, 64>(q, k, v, dout, mask, stat_m, stat_l, bits, drop,
                                          delta, dq, dk, dv, part, B, S, N, D, scale, causal,
                                          rel, drel, stream);
  return attention_bwd_dp<128, kRel, 128>(q, k, v, dout, mask, stat_m, stat_l, bits, drop, delta,
                                     dq, dk, dv, part, B, S, N, D, scale, causal, rel, drel,
                                     stream);
}

}  // namespace layer_hopper
}  // namespace b4r
