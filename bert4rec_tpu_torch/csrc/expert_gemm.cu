// K11: the grouped expert GEMM of a mixture of SwiGLU experts (the
// "mla_moe" block's routed experts), forward and backward, for Hopper
// (sm_90a). No TPU kernel: the JAX package has no sparse experts.
//
// Rows arrive sorted by expert: each expert e owns a run of rows of x
// [R, H] (runs uneven, possibly empty, none dropped) and maps it through
// its weights W_g[e], W_u[e] [H, I] and W_d[e] [I, H] (bf16, stacked
// [E, ...]):
//   forward   g = x W_g[e], u = x W_u[e], act = silu(g) u, y = act W_d[e]
//   backward  dA = dy W_d[e]^T, dg = dA u silu'(g), du = dA silu(g),
//             dx = dg W_g[e]^T + du W_u[e]^T,
//             dW_d[e] = act^T dy, dW_g[e] = x^T dg, dW_u[e] = x^T du
// with fp32 sums; g, u, act, y, dg, du and dx are stored rounded to bf16
// (act and the SwiGLU derivative from the fp32 sums of g and u in the
// forward, from the rounded g and u in the backward), the weight
// gradients in fp32. ops/expert_gemm.py's plain version has the same
// rounding points.
//
// Bound (Moonlight-16B-A3B's layer: R = 76,800 rows, H = 2,048, I = 1,408):
// three products of 2 R H I = 1.33 TFLOP forward, 2.66 backward (1.34 /
// 2.69 ms at 989 TFLOP/s) against ~1.7 GB moved a forward (0.5 ms at
// 3.35 TB/s): bound by operations. On an H100 80GB HBM3 at 700 W: 3.52 ms
// forward and 7.24 ms backward (38% and 37% of the bound), against
// torch._grouped_mm's 2.71 / 6.74 ms with PyTorch's elementwise SwiGLU.
//
// Design: layer_hopper.cuh's product machinery (two warpgroups a block,
// wgmma with fp32 accumulators in registers, a ring of cp.async stages in
// the 128-byte swizzle, rows and columns past an operand zero-filled),
// over a schedule of 128-row tiles that each lie inside one expert's run
// (tile_e, tile_r0, tile_r1: the tile's expert, first row and its run's
// end; tile_e -1 past the last tile). A row tile's loads stop at its run's
// end, so a tile never reads another expert's rows, and its stores drop
// the rows past it.
//   expert_gate_up_kernel  a block's 128 columns of g and the same 128 of
//                          u as one 256-wide product (W_g and W_u side by
//                          side in the B tile: the row tile read once), the
//                          silu(g) u epilogue, g, u and act staged through
//                          shared memory and written as whole 16-byte chunks
//   expert_rows_kernel     y = act W_d[e] (W read MN-major); dA =
//                          dy W_d[e]^T with the SwiGLU derivative's
//                          epilogue (W read K-major, its rows the output's
//                          columns); dx = dg W_g[e]^T + du W_u[e]^T, the two
//                          products one after the other into one
//                          accumulator; 128 x 256 tiles where N is a
//                          multiple of 256, else 128 x 128 (two blocks an SM)
//   expert_wgrad_kernel    one expert's 128 x 256 tile of a weight
//                          gradient, its run of rows the contraction (both
//                          operands read MN-major, 64 rows a step); x^T dg
//                          and x^T du as 128 columns of each side by side;
//                          an empty run writes zeros. No float atomics: two
//                          runs give the same bits.
// Layout rule (checked by the wrapper): H and I multiples of 8, every
// operand contiguous with a 16-byte aligned base.
#include "layer_hopper.cuh"

namespace b4r {
namespace expert_gemm {

using namespace hopper;
using namespace layer_hopper;

constexpr int kBM = 2 * kRows;  // a block's output rows (two warpgroups of 64)

// the tile schedule (see the header)
struct Sched {
  const int* e;
  const int* r0;
  const int* r1;
};

// A row kernel's shared memory: a ring of stages, each a 128 x 64 A tile
// and a 64 x BN (or BN x 64) B tile, BPS blocks an SM
template <int BN, int BPS>
struct RowTiles {
  static constexpr int kA = 2 * tile_bytes(kKStep);
  static constexpr int kB = tile_bytes(BN);
  static constexpr int kStage = kA + kB;
  static constexpr int kST = stages_for(kStage, BPS);
  static constexpr size_t kSmem = 1024 + (size_t)kST * kStage;
  static_assert(kSmem * BPS <= kSmemBytes, "the blocks an SM holds");
};
template <int BN>
constexpr int kRowBlocks = BN == 128 ? 2 : 1;  // blocks an SM: two for 128-column tiles

// acc = sum over p of A_p[m0 .. m0 + 128) B_p for the block's BN columns
// from n0, the NP products one after another along the contraction, each
// K deep: A_p [rows, K] row-major (rows past M zero); B_p from w_p, stored
// [K, N] row-major (read MN-major) or, with kKB, [N, K] row-major (read
// K-major). kDual (one product, MN-major): the block's first BN / 2
// columns from w at n0 and the next BN / 2 from w2 at n0, the gate and up
// products side by side. Leaves every copy and product done and the
// shared memory free.
template <int BN, bool kKB, bool kDual, int NP>
__device__ __forceinline__ void rows_loop(float (&acc)[BN / 2], const Product (&pr)[NP],
                                          const bf16* w2, int M, int K, int N, int m0, int n0,
                                          uint32_t sm) {
  using L = RowTiles<BN, kRowBlocks<BN>>;
  const int wm = threadIdx.x >> 7, nk = cdiv(K, kKStep);
  zero(acc);
  ring<L::kST>(
      NP * nk,
      [&](int ks) {
        const uint32_t st = sm + (ks % L::kST) * L::kStage;
        const Product& p = (NP == 1 || ks < nk) ? pr[0] : pr[NP - 1];
        const int k0 = (ks % nk) * kKStep;
        copy_rows<kKStep, 2, kBlockThreads>(st, p.a + k0, p.lda, m0, M, K - k0);
        if constexpr (kKB) {
          copy_rows<kKStep, BN / kRows, kBlockThreads>(st + L::kA, p.w + k0, p.ldw, n0, N,
                                                       K - k0);
        } else if constexpr (kDual) {
          copy_rows<BN / 2, 1, kBlockThreads>(st + L::kA, p.w + n0, p.ldw, k0, K, N - n0);
          copy_rows<BN / 2, 1, kBlockThreads>(st + L::kA + tile_bytes(BN / 2), w2 + n0, p.ldw,
                                              k0, K, N - n0);
        } else {
          copy_rows<BN, 1, kBlockThreads>(st + L::kA, p.w + n0, p.ldw, k0, K, N - n0);
        }
      },
      [&](int stage) {
        const uint32_t st = sm + stage * L::kStage;
        const uint32_t at = st + wm * tile_bytes(kKStep), bt = st + L::kA;
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < kKStep / 16; ++kk) {
          if constexpr (kKB)
            wgmma_ss_tr<BN, 0, 0>(acc, k_desc(at, kk), k_desc(bt, kk));
          else
            wgmma_ss_tr<BN, 0, 1>(acc, k_desc(at, kk), mn_desc(bt, kk));
        }
      });
  fence_regs(acc);
}

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + __expf(-v)); }

// ---------------------------------------------------------------------------
// g = x W_g[e], u = x W_u[e], act = silu(g) u: grid (cdiv(I, 128), tiles);
// a block's 128 columns of g and the same 128 of u are one 256-wide product
// ---------------------------------------------------------------------------
constexpr int kGateCols = 128;
using GateUp = RowTiles<2 * kGateCols, 1>;

__global__ void __launch_bounds__(kBlockThreads, 1)
expert_gate_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu, bf16* __restrict__ g, bf16* __restrict__ u,
                      bf16* __restrict__ act, Sched s, int H, int I) {
  constexpr int BN = 2 * kGateCols, kLd = kGateCols + 8, kStaged = kBM * kLd;
  const int t = blockIdx.y, e = s.e[t];
  if (e < 0) return;
  const int m0 = s.r0[t], M = s.r1[t], n0 = blockIdx.x * kGateCols;
  const size_t we = (size_t)e * H * I;
  const Product pr[1] = {{x, H, wg + we, I}};
  uint8_t* sm = aligned_smem();
  float acc[BN / 2];
  rows_loop<BN, false, true, 1>(acc, pr, wu + we, M, H, I, m0, n0, smem_u32(sm));
  const Place<2, BN> p;
  bf16* tg = reinterpret_cast<bf16*>(sm);
  bf16* tu = tg + kStaged;
  bf16* ta = tu + kStaged;
#pragma unroll
  for (int j = 0; j < kGateCols / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p.rl + 8 * h, col = p.c0 + 8 * j, i = 4 * j + 2 * h;
      const int iu = i + 4 * (kGateCols / 8);  // the same column of u
      const float g0 = acc[i], g1 = acc[i + 1], u0 = acc[iu], u1 = acc[iu + 1];
      stage_bf2(tg, kLd, row, col, g0, g1);
      stage_bf2(tu, kLd, row, col, u0, u1);
      stage_bf2(ta, kLd, row, col, g0 * sigm(g0) * u0, g1 * sigm(g1) * u1);
    }
  flush_bf16<kBlockThreads>(tg, kLd, kBM, kGateCols, g, I, m0, n0, M, I);
  flush_bf16<kBlockThreads>(tu, kLd, kBM, kGateCols, u, I, m0, n0, M, I);
  flush_bf16<kBlockThreads>(ta, kLd, kBM, kGateCols, act, I, m0, n0, M, I);
}

// ---------------------------------------------------------------------------
// c = a W[e] for an expert's [K, N] product, BN output columns a block:
// grid (cdiv(N, BN), tiles)
//   kDown      y = act W_d[e]              (p1; W_d[e] [K = I, N = H])
//   kSwigluBwd dA = dy W_d[e]^T into dg = dA u silu'(g) (c) and
//              du = dA silu(g)             (p1; W_d[e] [N = I, K = H])
//   kDx        dx = dg W_g[e]^T + du W_u[e]^T  (p1, p2; [N = H, K = I])
// Each product's w is expert 0's weight; expert e's is K N elements on.
// ---------------------------------------------------------------------------
enum { kDown = 0, kSwigluBwd = 1, kDx = 2 };

template <int MODE, int BN>
__global__ void __launch_bounds__(kBlockThreads, kRowBlocks<BN>)
expert_rows_kernel(Product p1, Product p2, bf16* __restrict__ c, const bf16* __restrict__ gs,
                   const bf16* __restrict__ us, bf16* __restrict__ du, Sched s, int K, int N) {
  constexpr int kLd = BN + 8, kStaged = kBM * kLd;
  const int t = blockIdx.y, e = s.e[t];
  if (e < 0) return;
  const int m0 = s.r0[t], M = s.r1[t], n0 = blockIdx.x * BN;
  const size_t we = (size_t)e * K * N;
  p1.w += we;
  p2.w += we;
  uint8_t* sm = aligned_smem();
  float acc[BN / 2];
  if constexpr (MODE == kDx) {
    const Product pr[2] = {p1, p2};
    rows_loop<BN, true, false, 2>(acc, pr, nullptr, M, K, N, m0, n0, smem_u32(sm));
  } else {
    const Product pr[1] = {p1};
    rows_loop<BN, MODE == kSwigluBwd, false, 1>(acc, pr, nullptr, M, K, N, m0, n0,
                                               smem_u32(sm));
  }
  const Place<2, BN> p;
  bf16* t1 = reinterpret_cast<bf16*>(sm);
  bf16* t2 = t1 + kStaged;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p.rl + 8 * h, col = p.c0 + 8 * j, i = 4 * j + 2 * h;
      const float a0 = acc[i], a1 = acc[i + 1];
      if constexpr (MODE == kSwigluBwd) {
        const int r = m0 + row, cc = n0 + col;  // cc < N implies cc + 1 < N (N even)
        float g0 = 0.f, g1 = 0.f, u0 = 0.f, u1 = 0.f;
        if (r < M && cc < N) {
          const size_t o = (size_t)r * N + cc;
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gs + o));
          const float2 uv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(us + o));
          g0 = gv.x, g1 = gv.y, u0 = uv.x, u1 = uv.y;
        }
        const float s0 = sigm(g0), s1 = sigm(g1);
        stage_bf2(t1, kLd, row, col, a0 * u0 * (s0 * (1.0f + g0 * (1.0f - s0))),
                  a1 * u1 * (s1 * (1.0f + g1 * (1.0f - s1))));
        stage_bf2(t2, kLd, row, col, a0 * (g0 * s0), a1 * (g1 * s1));
      } else {
        stage_bf2(t1, kLd, row, col, a0, a1);
      }
    }
  flush_bf16<kBlockThreads>(t1, kLd, kBM, BN, c, N, m0, n0, M, N);
  if constexpr (MODE == kSwigluBwd)
    flush_bf16<kBlockThreads>(t2, kLd, kBM, BN, du, N, m0, n0, M, N);
}

// ---------------------------------------------------------------------------
// c[e] = a[rows of e]^T b[rows of e] ([M1, N] fp32), a [R, M1] and b [R, N]
// row-major, offsets [E + 1] the runs' bounds: a block's 128 x 256 tile,
// grid (cdiv(M1, 128) cdiv(N, 256), E). kDual: two gradients that share a,
// c = a^T b and c2 = a^T b2, as 128 columns of each side by side (grid
// (cdiv(M1, 128) cdiv(N, 128), E)).
// ---------------------------------------------------------------------------
constexpr int kWgradCols = 256;
struct ExpertWgradTiles {
  static constexpr int kA = tile_bytes(kBM);          // 64 rows x 128 columns of a
  static constexpr int kB = tile_bytes(kWgradCols);   // 64 rows x 256 columns of b
  static constexpr int kStage = kA + kB;
  static constexpr int kST = stages_for(kStage);
  static constexpr size_t kSmem = 1024 + (size_t)kST * kStage;
};

template <bool kDual>
__global__ void __launch_bounds__(kBlockThreads, 1)
expert_wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    const bf16* __restrict__ b2, float* __restrict__ c, float* __restrict__ c2,
                    const int* __restrict__ offsets, int M1, int N) {
  using L = ExpertWgradTiles;
  constexpr int BN = kWgradCols, kCols = kDual ? BN / 2 : BN;  // columns of one output
  const int e = blockIdx.y, ntn = cdiv(N, kCols);
  const int k0 = (blockIdx.x / ntn) * kBM, n0 = (blockIdx.x % ntn) * kCols;
  const int r_begin = offsets[e], r_end = offsets[e + 1];
  const int nk = r_end > r_begin ? cdiv(r_end - r_begin, kRows) : 0;
  const uint32_t sbase = smem_u32(aligned_smem());
  const int wm = threadIdx.x >> 7;
  float acc[BN / 2];
  zero(acc);
  ring<L::kST>(
      nk,
      [&](int ks) {
        const uint32_t st = sbase + (ks % L::kST) * L::kStage;
        const int m = r_begin + ks * kRows;
        copy_rows<kBM, 1, kBlockThreads>(st, a + k0, M1, m, r_end, M1 - k0);
        if constexpr (kDual) {
          copy_rows<kCols, 1, kBlockThreads>(st + L::kA, b + n0, N, m, r_end, N - n0);
          copy_rows<kCols, 1, kBlockThreads>(st + L::kA + tile_bytes(kCols), b2 + n0, N, m,
                                             r_end, N - n0);
        } else {
          copy_rows<BN, 1, kBlockThreads>(st + L::kA, b + n0, N, m, r_end, N - n0);
        }
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
  const Place<2, BN> p;
  const size_t base = (size_t)e * M1 * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int side = kDual && j >= kCols / 8;  // 0: c, 1: c2
      const int row = k0 + p.rl + 8 * h, col = n0 + p.c0 + 8 * j - side * kCols;
      if (row < M1 && col < N)
        *reinterpret_cast<float2*>((side ? c2 : c) + base + (size_t)row * N + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

// allows the kernel its shared memory and launches it on (gx, gy) blocks
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int gx, int gy, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(gx, gy), kBlockThreads, smem, stream>>>(static_cast<KArgs>(args)...);
  return cudaGetLastError();
}

}  // namespace expert_gemm
}  // namespace b4r

namespace {
using namespace b4r::expert_gemm;

// a row kernel at BN = 256 where N is a multiple of 256, else 128 (two
// blocks an SM: at Moonlight's N = I = 1,408 the dA kernel takes 1.52 ms on
// an H100 80GB HBM3, against 1.81 ms at 256 with its last tile half idle)
template <int MODE, typename... Args>
cudaError_t launch_rows(int N, int tiles, cudaStream_t st, Args... args) {
  if (N % 256 == 0)
    return launch(expert_rows_kernel<MODE, 256>, N / 256, tiles, RowTiles<256, 1>::kSmem, st,
                  args...);
  return launch(expert_rows_kernel<MODE, 128>, b4r::ceil_div(N, 128), tiles,
                RowTiles<128, 2>::kSmem, st, args...);
}
}  // namespace

extern "C" {

// K11's forward products. x [R, H]; wg, wu [E, H, I]; wd [E, I, H]; g, u,
// act [R, I]; y [R, H] (bf16, contiguous); tile_e / tile_r0 / tile_r1 the
// schedule of `tiles` 128-row tiles. H and I multiples of 8.
int b4r_expert_forward(const void* x, const void* wg, const void* wu, const void* wd, void* g,
                       void* u, void* act, void* y, const int* tile_e, const int* tile_r0,
                       const int* tile_r1, int tiles, int H, int I, void* stream) {
  if (H <= 0 || I <= 0 || H % 8 || I % 8 || tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sched s{tile_e, tile_r0, tile_r1};
  cudaError_t err = launch(expert_gate_up_kernel, b4r::ceil_div(I, kGateCols), tiles,
                           GateUp::kSmem, st, x, wg, wu, g, u, act, s, H, I);
  if (err != cudaSuccess) return (int)err;
  const Product down{static_cast<const bf16*>(act), I, static_cast<const bf16*>(wd), H};
  return (int)launch_rows<kDown>(H, tiles, st, down, down, y, nullptr, nullptr, nullptr, s, I,
                                 H);
}

// K11's backward. dy [R, H] and the forward's x, g, u, act; dg, du [R, I]
// and dx [R, H] bf16 out; dwg, dwu [E, H, I] and dwd [E, I, H] fp32 out
// (every element written); offsets [E + 1] int32, the runs' bounds.
int b4r_expert_backward(const void* dy, const void* x, const void* wg, const void* wu,
                        const void* wd, const void* g, const void* u, const void* act, void* dg,
                        void* du, void* dx, float* dwg, float* dwu, float* dwd,
                        const int* tile_e, const int* tile_r0, const int* tile_r1, int tiles,
                        const int* offsets, int E, int H, int I, void* stream) {
  using b4r::ceil_div;
  if (H <= 0 || I <= 0 || H % 8 || I % 8 || tiles <= 0 || E <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Sched s{tile_e, tile_r0, tile_r1};
  auto B = [](const void* p) { return static_cast<const bf16*>(p); };
  // dA = dy W_d[e]^T (W_d[e] is [I, H]: N = I rows of K = H) -> dg, du
  const Product da{B(dy), H, B(wd), H};
  cudaError_t err = launch_rows<kSwigluBwd>(I, tiles, st, da, da, dg, g, u, du, s, H, I);
  if (err != cudaSuccess) return (int)err;
  // dx = dg W_g[e]^T + du W_u[e]^T (W[e] is [H, I]: N = H rows of K = I)
  err = launch_rows<kDx>(H, tiles, st, Product{B(dg), I, B(wg), I},
                         Product{B(du), I, B(wu), I}, dx, nullptr, nullptr, nullptr, s, I, H);
  if (err != cudaSuccess) return (int)err;
  // dW_d[e] = act^T dy ([I, H]); dW_g[e], dW_u[e] = x^T dg, x^T du ([H, I])
  err = launch(expert_wgrad_kernel<false>, ceil_div(I, kBM) * ceil_div(H, kWgradCols), E,
               ExpertWgradTiles::kSmem, st, act, dy, nullptr, dwd, nullptr, offsets, I, H);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(expert_wgrad_kernel<true>, ceil_div(H, kBM) * ceil_div(I, kWgradCols / 2),
                     E, ExpertWgradTiles::kSmem, st, x, dg, du, dwg, dwu, offsets, H, I);
}

}  // extern "C"
