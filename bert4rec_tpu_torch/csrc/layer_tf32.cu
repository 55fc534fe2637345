// The fused encoder layer in fp32 on Hopper's tensor cores, in 3xTF32
// (sm_90a): the forward at inference and in training (K1 / K1', with
// attention and output dropout and the saves its backward reads) and the
// backward (K2). Replaces, for every fp32 launch inside its shape rule, the
// TPU kernels _fwd_kernel (launched by _run_forward) and _bwd_kernel /
// _bwd_element (launched by _run_backward) of
// bert4rec_tpu/ops/fused_encoder_layer.py, with their causal (K1'' causal,
// K2 causal) and relative-bias (K1'' rel_bias, K2 dRel) variants;
// ops/fused_encoder_layer.py kernel_route sends them here ("tf32"). It
// computes what fused_encoder_layer.cu's header writes, with T = float:
//
//   qkv  = x Wqkv + bqkv
//   p    = softmax(q k^T / sqrt(D) + (mask > 0 ? 0 : -1e9)
//                  [+ (key > query ? -1e9 : 0) if causal] [+ rel[b, head]])
//   ctx  = (p * keep_h) v
//   x1   = LN1(x + (ctx Wo + bo) * keep_N)
//   hact = gelu_tanh(x1 W1 + b1)
//   y    = LN2(x1 + (hact W2 + b2) * keep_N+1)
//
// and its backward (_bwd_element), every rounding to T the identity.
//
// 3xTF32. Every product runs on wgmma .tf32 with fp32 accumulators: each
// fp32 operand is split into hi = cvt.rna.tf32(v) and lo =
// cvt.rna.tf32(v - hi) (v - hi is exact in fp32), and a b accumulates
// lo_a hi_b + hi_a lo_b, then hi_a hi_b, per 8-deep k-block. The dropped
// lo_a lo_b and the roundings of lo leave each product within a few fp32
// ulps of a b (single-pass TF32 keeps 11 bits). The activations are split
// where they land in shared memory or the registers. wgmma reads .tf32
// operands only K-major (tf32.cuh), which decides each product's layout:
//   x W (forward)         contracts over W's rows: each launch first writes
//                         W^T's hi and lo for the weights into the caller's
//                         workspace (wt_split_kernel, ~1.5 MB at H = 128)
//   dY W^T (backward)     contracts over W's columns: W as stored is K-major
//                         for B; w_split_kernel writes its hi and lo
//   dW = A^T dB           contracts over the B S rows, along which neither
//                         operand is contiguous: A comes from the registers
//                         by ld.shared in fragment order (tf32.cuh
//                         frag_cols), dB is transposed as it is split
//   attention             dv = p^T dO, dk = ds^T q (over queries) and
//                         dq = ds k (over keys) take p, ds from the
//                         registers as A, and dO, q, k transposed into B
// Nothing is cached between launches: whatever wrote the weights, the
// launch reads them as they are.
//
// Kernels (fp32 tiles of 32 columns = one 128-byte swizzle row, brought in
// by cp.async into a ring; the streamed activations split in place by the
// thread that copied them, attention's p and ds in the registers):
//   wt_split_kernel     W [K, N] -> W^T hi, lo [N, K], through a 32 x 33
//                       shared tile (the forward's four weights; W1 again
//                       in the backward, to recompute x1 W1)
//   w_split_kernel      W -> hi, lo as stored (the backward's four weights)
//   gemm_tf32_kernel    128 x 128 output tiles, two warpgroups of 64 rows,
//                       the weight tiles streamed with the A tiles (3
//                       stages); epilogues: + bias (qkv), + bias then
//                       tanh-gelu (W1), none (dctx), + an fp32 matrix (dx),
//                       or the gelu derivative of a second product over the
//                       same rows (dhpre = (df W2^T) gelu'(x1 W1 + b1))
//   ln_tf32_kernel      a block owns whole rows (128, or 64 at H > 128 with
//                       the columns split between the warpgroups), the tile
//                       goes to shared memory and each warp takes whole
//                       rows: forward, bias, dropout, residual and
//                       LayerNorm (saving xhat and 1/std in training);
//                       backward (dx1 = dw_res + dhpre W1^T), LayerNorm's
//                       backward with dg1 / db1 / dbo's column partials
//   ln_rows_bwd_kernel  LN2's backward from dy (no product), with dg2 /
//                       db2 / dbf2's column partials
//   attn_tf32_kernel    one warpgroup per (64-query tile, head, sequence),
//                       ONE pass over the key tiles with an online softmax
//                       in registers: s = q k^T on wgmma from shared memory;
//                       p split in the registers into the A fragments of
//                       o += p v (register-A wgmma: k-block j holds keys
//                       8 j + 2 (lane % 4) and + 1, so v^T is stored with
//                       each 8 keys' even ones first); the next key tile's
//                       copies run during this one's products; head dim
//                       <= 64. In training the unnormalised exponentials
//                       are scaled by keep after they join the row sum
//                       (dropout after normalisation, as the plain version,
//                       in another rounding order), and the final state is
//                       saved: stat_m = the row's max of the biased scores,
//                       stat_l = sum_j exp(s_j - stat_m), the SIMT kernels'
//                       convention, from which the backward recomputes p =
//                       exp(s - stat_m) / stat_l
//   attn_dq_tf32_kernel one warpgroup per (64-query tile, head, sequence):
//                       delta = dO . o per query row (flash attention's
//                       form; JAX's sum_j dp_ij p_ij is the same sum in
//                       exact arithmetic), then over the key tiles s = q
//                       k^T, dp = dO v^T, ds = p (dp keep - delta), dRel =
//                       ds and dq += ds k
//   attn_dkv_tf32_kernel one warpgroup per (64-key tile, head, sequence),
//                       over the query tiles: s^T = k q^T (its three passes
//                       in the dq kernel's order, so the recomputed scores
//                       match), dp^T = v dO^T, dv += (p keep)^T dO, dk +=
//                       ds^T q; k and v stay raw in shared memory, their A
//                       fragments split in the registers at each use, so
//                       that at head dim 32 two blocks fit an SM
//   wgrad_tf32_kernel   dW's split partials: a block of 128 rows of dW x
//                       128 columns over a chunk of the batch's rows
//                       (wgrad_chunk: the grid near two waves of one
//                       block an SM, at most 1,024 rows),
//                       summed in the tensor core's accumulator, then the
//                       partials in chunk order (reduce_rows): no sum runs
//                       longer than 1,024 terms in the tensor core (over K7's
//                       42k-entry sweep its accumulation moved dh by 1.7e-4
//                       of its scale, loss_tf32.cuh), no float atomics, and
//                       two runs give the same bits
//   colsum_kernel       the bias gradients dbf1 and dbqkv: column sums in
//                       chunks of 256 rows, then reduce_rows
// The attention dropout's keep is redrawn from common.cuh's counter hash in
// every kernel that needs it (site h per head, counter query * S + key), as
// the SIMT kernels do: no keep bits are stored. The output dropout's sites
// are N and N + 1.
// The mask bias stays -1e9 (a row that sees only padding is uniform over
// its keys, as on the TPU); a key past the sequence is -inf. Causal and
// the relative bias are the SIMT kernels' law (attention.cuh tile_scores:
// the triangle's -1e9 added to the pad bias, rel added last, key tiles
// wholly after a query tile skipped where causal_skip says it is exact,
// and query tiles wholly before a key tile skipped in the dk / dv kernel).
//
// Bound. 99.1 MFLOP a sequence forward at S = 200, H = 128, F = 512, and
// 198 backward; 3xTF32 does three tensor-core products for each, so at the
// H100 SXM's published 495 TFLOP/s of TF32 it runs at most at 165 TFLOP/s:
// 0.154 ms forward and 0.308 ms backward at B = 256 (at 67 TFLOP/s without
// tensor cores: 0.379 and 0.757 ms), against ~0.12 ms of activation
// traffic forward at 3.35 TB/s. Bound by operations; times on the card are
// in PERF.md.
//
// Layout rule (kernel_route, decided before any launch): H, the head dim
// and F multiples of 8, H <= 256, head dim <= 64, every operand 16-byte
// aligned and contiguous (the weights: contiguous).

#include <algorithm>

#include "attention.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace b4r;
using namespace b4r::hopper;
using namespace b4r::tf32;

constexpr int kKs = 32;            // fp32 columns of one panel row (128 bytes)

// The products' ring: ST stages, the copies of steps ks + 1 .. ks + ST - 1
// in flight while step ks is split and its products run. One barrier a
// step: it makes step ks's copies and split visible to both warpgroups and,
// since every thread waited on its products of step ks - 1 before it,
// frees that step's stage for the copies of step ks + ST - 1.
// prefetch(ks) fills stage ks % ST, split(stage) splits this thread's
// chunks of it, products(stage) issues the step's wgmma.
template <int ST, typename Prefetch, typename Split, typename Products>
__device__ __forceinline__ void ring(int nk, Prefetch&& prefetch, Split&& split,
                                     Products&& products) {
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) prefetch(s);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<ST - 2>();
    split(ks % ST);
    fence_async_smem();
    __syncthreads();
    if (ks + ST - 1 < nk) prefetch(ks + ST - 1);
    cp_async_commit();
    wgmma_fence();
    products(ks % ST);
    wgmma_commit();
    wgmma_wait_n<0>();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// A block of WM x WN warpgroups, each 64 rows x BN columns of the output:
// acc = A[m0 .., :K] W[:K, n0 ..] with A [M, K] row-major and W given as
// W^T hi and lo ([N, K] row-major); the stage holds A hi | A lo | B hi |
// B lo. Leaves every copy and product done and the shared memory free.
template <int WM, int WN, int BN, int ST>
struct Ring {
  static constexpr int kCols = WN * BN;
  static constexpr int kA = WM * kPanel, kB = kCols * 128;
  static constexpr int kStage = 2 * (kA + kB);
  static constexpr size_t kSmem = 1024 + (size_t)ST * kStage;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

template <int WM, int WN, int BN, int ST>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 64][32], const float* A, int M,
                                         int K, const float* whi, const float* wlo, int N,
                                         int m0, int n0, uint8_t* sm) {
  using L = Ring<WM, WN, BN, ST>;
  const uint32_t base = smem_u32(sm);
  const int wg = threadIdx.x >> 7, wm = wg % WM, wn = wg / WM;
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  ring<ST>(
      (K + kKs - 1) / kKs,
      [&](int ks) {
        const uint32_t st = base + (ks % ST) * L::kStage;
        const int k0 = ks * kKs;
        copy_panel<64 * WM, 256>(st, A, K, m0, M, k0, K);
        copy_panel<L::kCols, 256>(st + 2 * L::kA, whi, K, n0, N, k0, K);
        copy_panel<L::kCols, 256>(st + 2 * L::kA + L::kB, wlo, K, n0, N, k0, K);
      },
      [&](int stage) { split_panel<64 * WM, 256>(sm + stage * L::kStage, L::kA); },
      [&](int stage) {
        const uint32_t st = base + stage * L::kStage;
        const uint32_t a = st + wm * kPanel, b = st + 2 * L::kA + wn * BN * 128;
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
#pragma unroll
          for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[j][i])::"memory");
#pragma unroll
          for (int kk = 0; kk < kKs / 8; ++kk)
            mma3(acc[j], a, L::kA, b + j * kPanel, L::kB, kk);
        }
      });
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[j][i])::"memory");
}

// ---------------------------------------------------------------------------
// C = epi(A W): M x N, A [M, K], W as W^T hi / lo [N, K]
// ---------------------------------------------------------------------------
enum GemmEpi {
  kEpiBias,      // A W + bias (qkv)
  kEpiBiasGelu,  // gelu_tanh(A W + bias) (W1)
  kEpiNone,      // A W (dctx = dattn Wo^T)
  kEpiAddF32,    // R + A W (dx = du + dqkv Wqkv^T)
  kEpiGeluGrad,  // (A W) gelu'(A2 W2 + bias) (dhpre = (df W2^T) gelu'(x1 W1 + b1))
};

struct GemmArgs {
  const float *A, *whi, *wlo, *bias;
  float* C;
  int M, K, N;
  const float *A2, *w2hi, *w2lo;  // kEpiGeluGrad's second product
  const float* R;                 // kEpiAddF32's [M, N] term
};

constexpr int kGemmBN = 128, kGemmST = 3;
using GemmRing = Ring<2, 1, kGemmBN, kGemmST>;

template <int kEpi>
__global__ void __launch_bounds__(256, 1) gemm_tf32_kernel(GemmArgs g) {
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * kGemmBN;
  constexpr int kJ = kGemmBN / 64;
  float acc[kJ][32];
  mainloop<2, 1, kGemmBN, kGemmST>(acc, g.A, g.M, g.K, g.whi, g.wlo, g.N, m0, n0, sm);
  float acc2[kEpi == kEpiGeluGrad ? kJ : 1][32];
  if constexpr (kEpi == kEpiGeluGrad)
    mainloop<2, 1, kGemmBN, kGemmST>(acc2, g.A2, g.M, g.K, g.w2hi, g.w2lo, g.N, m0, n0, sm);
  const int lt = threadIdx.x & 127, tq = lt & 3;
  const int row = m0 + 64 * (threadIdx.x >> 7) + 16 * (lt >> 5) + ((lt & 31) >> 2);
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = n0 + 64 * j + 8 * q + 2 * tq;  // c < N implies c + 1 < N (N even)
      if (c >= g.N) continue;
      float b0 = 0.f, b1 = 0.f;
      if constexpr (kEpi != kEpiNone && kEpi != kEpiAddF32) {
        b0 = g.bias[c];
        b1 = g.bias[c + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= g.M) continue;
        const int i = 4 * q + 2 * h;
        const size_t at_rc = (size_t)r * g.N + c;
        float v0, v1;
        if constexpr (kEpi == kEpiBias || kEpi == kEpiBiasGelu) {
          v0 = acc[j][i] + b0;
          v1 = acc[j][i + 1] + b1;
          if (kEpi == kEpiBiasGelu) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
        } else if constexpr (kEpi == kEpiNone) {
          v0 = acc[j][i];
          v1 = acc[j][i + 1];
        } else if constexpr (kEpi == kEpiAddF32) {
          const float2 rv = *reinterpret_cast<const float2*>(g.R + at_rc);
          v0 = rv.x + acc[j][i];
          v1 = rv.y + acc[j][i + 1];
        } else {
          v0 = acc[j][i] * gelu_tanh_grad(acc2[j][i] + b0);
          v1 = acc[j][i + 1] * gelu_tanh_grad(acc2[j][i + 1] + b1);
        }
        *reinterpret_cast<float2*>(g.C + at_rc) = make_float2(v0, v1);
      }
    }
}

// ---------------------------------------------------------------------------
// LayerNorm. A block owns whole rows; each warp takes whole rows, a lane 4
// columns at a time (column 4 lane + 128 t, t < kT).
// ---------------------------------------------------------------------------
enum LnMode { kLnInfer, kLnTrain, kLnBwd };

struct LnArgs {
  const float *A, *whi, *wlo;
  int K;
  const float *bias, *R, *gamma, *beta;
  float* Y;
  int M, H;
  // training: output dropout at `site` where drop.on, xhat and 1/std saved
  // where non-null; backward: xhat / rstd read, dmask = Y keep, part the
  // column partials
  Drop drop;
  int site, S;
  float *xhat, *rstd, *dmask, *part;
};

// LayerNorm's backward over row r by one warp: g the incoming gradient;
// writes d = rstd (g gamma - mean(g gamma) - xhat mean(g gamma xhat)) and
// d keep(site) to dmask; adds g xhat, g and d keep to the lane's column
// partials p[0..2]
template <int kT>
__device__ __forceinline__ void ln_bwd_row(const float (&g)[kT][4], int r, const LnArgs& a,
                                           const float* xhat, const float* rstd, float* dout,
                                           float (&p)[3][kT][4]) {
  const int lane = threadIdx.x & 31;
  const int H = a.H;
  float xh[kT][4] = {}, s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int c = 4 * lane + 128 * t;
    if (c >= H) continue;
    const float4 x4 = *reinterpret_cast<const float4*>(xhat + (size_t)r * H + c);
    const float4 g4 = *reinterpret_cast<const float4*>(a.gamma + c);
    xh[t][0] = x4.x;
    xh[t][1] = x4.y;
    xh[t][2] = x4.z;
    xh[t][3] = x4.w;
    const float gm[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[0][t][i] += g[t][i] * xh[t][i];
      p[1][t][i] += g[t][i];
      const float dxh = g[t][i] * gm[i];
      s1 += dxh;
      s2 += dxh * xh[t][i];
    }
  }
  const float inv_h = 1.0f / (float)H;
  const float mean1 = warp_sum(s1) * inv_h, mean2 = warp_sum(s2) * inv_h;
  const float rs = rstd[r];
  const int srow = r % a.S;
  const uint32_t sk = site_key(a.drop, r / a.S, a.site);
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int c = 4 * lane + 128 * t;
    if (c >= H) continue;
    const float4 g4 = *reinterpret_cast<const float4*>(a.gamma + c);
    const float gm[4] = {g4.x, g4.y, g4.z, g4.w};
    float d[4], dm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[i] = rs * (g[t][i] * gm[i] - mean1 - xh[t][i] * mean2);
      dm[i] = a.drop.on ? d[i] * keep_scale_k(a.drop, sk, (uint32_t)(srow * H + c + i)) : d[i];
      p[2][t][i] += dm[i];
    }
    *reinterpret_cast<float4*>(dout + (size_t)r * H + c) = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(a.dmask + (size_t)r * H + c) =
        make_float4(dm[0], dm[1], dm[2], dm[3]);
  }
}

// the block's column partials: every warp's p summed in warp order into
// part[blockIdx.x][3 H] (g xhat | g | d keep), through red [8][3][HP]
template <int HP, int kT>
__device__ __forceinline__ void ln_block_partials(float (&p)[3][kT][4], float* red, float* part,
                                                  int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = 4 * lane + 128 * t;
      if (c < HP)
        *reinterpret_cast<float4*>(red + (warp * 3 + k) * HP + c) =
            make_float4(p[k][t][0], p[k][t][1], p[k][t][2], p[k][t][3]);
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * H; idx += 256) {
    const int k = idx / H, c = idx % H;
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[(w * 3 + k) * HP + c];
    part[(size_t)blockIdx.x * 3 * H + idx] = s;
  }
}

// Forward: Y = LN(R + (A W + bias) keep) gamma + beta; backward: Y = du =
// LN'(R + A W), dmask = du keep, with the column partials. HP = H rounded
// up to 64, 128 or 256.
template <int HP>
struct LnShape {
  static constexpr int WM = HP <= 128 ? 2 : 1, WN = 2 / WM, BN = HP / WN;
  static constexpr int kRowsB = 64 * WM, ST = HP <= 128 ? 3 : 2, kLd = HP + 8;
  using R = Ring<WM, WN, BN, ST>;
  static constexpr size_t kTile = (size_t)kRowsB * kLd * 4;
  static constexpr size_t kRed = (size_t)8 * 3 * HP * 4;  // the backward's partials
  static constexpr size_t kNeed = 1024 + kTile + kRed;
  static constexpr size_t kSmem = R::kSmem > kNeed ? R::kSmem : kNeed;
};

template <int HP, int kMode>
__global__ void __launch_bounds__(256, 1) ln_tf32_kernel(LnArgs a) {
  using LS = LnShape<HP>;
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * LS::kRowsB;
  const int M = a.M, H = a.H;
  float acc[LS::BN / 64][32];
  mainloop<LS::WM, LS::WN, LS::BN, LS::ST>(acc, a.A, M, a.K, a.whi, a.wlo, H, m0, 0, sm);
  // the accumulators into the block's fp32 tile, rows of kLd floats
  float* xs = reinterpret_cast<float*>(sm);
  {
    const int wg = threadIdx.x >> 7, wm = wg % LS::WM, wn = wg / LS::WM;
    const int lt = threadIdx.x & 127, tq = lt & 3;
    const int rl = 64 * wm + 16 * (lt >> 5) + ((lt & 31) >> 2);
#pragma unroll
    for (int j = 0; j < LS::BN / 64; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(xs + (rl + 8 * h) * LS::kLd + wn * LS::BN + 64 * j +
                                     8 * q + 2 * tq) =
              make_float2(acc[j][4 * q + 2 * h], acc[j][4 * q + 2 * h + 1]);
  }
  __syncthreads();
  constexpr int kT = (HP + 127) / 128;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kMode == kLnBwd) {
    float p[3][kT][4] = {};
    for (int rr = warp; rr < LS::kRowsB; rr += 8) {
      const int r = m0 + rr;
      if (r >= M) break;
      float g[kT][4] = {};
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int c = 4 * lane + 128 * t;
        if (c >= H) continue;
        const float4 x = *reinterpret_cast<const float4*>(xs + rr * LS::kLd + c);
        const float4 res = *reinterpret_cast<const float4*>(a.R + (size_t)r * H + c);
        g[t][0] = res.x + x.x;
        g[t][1] = res.y + x.y;
        g[t][2] = res.z + x.z;
        g[t][3] = res.w + x.w;
      }
      ln_bwd_row<kT>(g, r, a, a.xhat, a.rstd, a.Y, p);
    }
    ln_block_partials<HP, kT>(p, reinterpret_cast<float*>(sm + LS::kTile), a.part, H);
    return;
  }
  const float inv_h = 1.0f / (float)H;
  for (int rr = warp; rr < LS::kRowsB; rr += 8) {
    const int r = m0 + rr;
    if (r >= M) break;
    uint32_t sk = 0;
    if constexpr (kMode == kLnTrain) sk = site_key(a.drop, r / a.S, a.site);
    float u[kT][4], sum = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = 4 * lane + 128 * t;
      u[t][0] = u[t][1] = u[t][2] = u[t][3] = 0.f;
      if (c >= H) continue;
      const float4 x = *reinterpret_cast<const float4*>(xs + rr * LS::kLd + c);
      const float4 b = *reinterpret_cast<const float4*>(a.bias + c);
      const float4 res = *reinterpret_cast<const float4*>(a.R + (size_t)r * H + c);
      float v[4] = {x.x + b.x, x.y + b.y, x.z + b.z, x.w + b.w};
      if constexpr (kMode == kLnTrain)
        if (a.drop.on)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] *= keep_scale_k(a.drop, sk, (uint32_t)((r % a.S) * H + c + i));
      u[t][0] = res.x + v[0];
      u[t][1] = res.y + v[1];
      u[t][2] = res.z + v[2];
      u[t][3] = res.w + v[3];
      sum += (u[t][0] + u[t][1]) + (u[t][2] + u[t][3]);
    }
    const float mean = warp_sum(sum) * inv_h;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (4 * lane + 128 * t >= H) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = u[t][i] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_h + kLnEps);
    if (kMode == kLnTrain && a.rstd && lane == 0) a.rstd[r] = rstd;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = 4 * lane + 128 * t;
      if (c >= H) continue;
      const float4 g = *reinterpret_cast<const float4*>(a.gamma + c);
      const float4 e = *reinterpret_cast<const float4*>(a.beta + c);
      float4 xh, y;
      xh.x = (u[t][0] - mean) * rstd;
      xh.y = (u[t][1] - mean) * rstd;
      xh.z = (u[t][2] - mean) * rstd;
      xh.w = (u[t][3] - mean) * rstd;
      y.x = xh.x * g.x + e.x;
      y.y = xh.y * g.y + e.y;
      y.z = xh.z * g.z + e.z;
      y.w = xh.w * g.w + e.w;
      *reinterpret_cast<float4*>(a.Y + (size_t)r * H + c) = y;
      if (kMode == kLnTrain && a.xhat)
        *reinterpret_cast<float4*>(a.xhat + (size_t)r * H + c) = xh;
    }
  }
}

// LN2's backward from dy: a block of 128 rows, 16 a warp
constexpr int kLnRowsB = 128;

template <int HP>
__global__ void __launch_bounds__(256) ln_rows_bwd_kernel(LnArgs a, const float* __restrict__ dy) {
  __shared__ __align__(16) float red[8 * 3 * HP];
  constexpr int kT = (HP + 127) / 128;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float p[3][kT][4] = {};
  for (int rr = warp; rr < kLnRowsB; rr += 8) {
    const int r = blockIdx.x * kLnRowsB + rr;
    if (r >= a.M) break;
    float g[kT][4] = {};
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = 4 * lane + 128 * t;
      if (c >= a.H) continue;
      const float4 v = *reinterpret_cast<const float4*>(dy + (size_t)r * a.H + c);
      g[t][0] = v.x;
      g[t][1] = v.y;
      g[t][2] = v.z;
      g[t][3] = v.w;
    }
    ln_bwd_row<kT>(g, r, a, a.xhat, a.rstd, a.Y, p);
  }
  ln_block_partials<HP, kT>(p, red, a.part, a.H);
}

// ---------------------------------------------------------------------------
// the weights' hi and lo: W [K, N] row-major -> W^T hi, lo [N, K] row-major,
// a 32 x 32 tile a block, read and written along rows (wt_split_kernel); or
// as stored (w_split_kernel)
// ---------------------------------------------------------------------------
struct WtJob {
  const float* w[4];
  float* hi[4];
  float* lo[4];
  int K[4], N[4];
  int first[5];  // matrix i's tiles are blocks first[i] .. first[i + 1] - 1
};

__global__ void __launch_bounds__(256) wt_split_kernel(WtJob job) {
  __shared__ float t[32][33];
  int i = 0;
  while (i < 3 && (int)blockIdx.x >= job.first[i + 1]) ++i;
  const int K = job.K[i], N = job.N[i], tile = blockIdx.x - job.first[i];
  const int tn = (N + 31) / 32, k0 = tile / tn * 32, n0 = tile % tn * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int j = ty; j < 32; j += 8)
    t[j][tx] = (k0 + j < K && n0 + tx < N) ? job.w[i][(size_t)(k0 + j) * N + n0 + tx] : 0.f;
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int n = n0 + j, k = k0 + tx;
    if (n >= N || k >= K) continue;
    float hi, lo;
    split_tf32(t[tx][j], hi, lo);
    job.hi[i][(size_t)n * K + k] = hi;
    job.lo[i][(size_t)n * K + k] = lo;
  }
}

__global__ void __launch_bounds__(256) w_split_kernel(WtJob job) {
  for (int i = 0; i < 4; ++i) {
    const long n = (long)job.K[i] * job.N[i];
    for (long e = (long)blockIdx.x * 256 + threadIdx.x; e < n; e += (long)gridDim.x * 256)
      split_tf32(job.w[i][e], job.hi[i][e], job.lo[i][e]);
  }
}

// ---------------------------------------------------------------------------
// attention forward, one pass: a warpgroup per (64-query tile, head,
// sequence) over the packed [B*S, 3H] qkv
// ---------------------------------------------------------------------------
template <int DP>
struct AttnShape {
  static constexpr int kQ = kTileQ<DP>;  // a 64-row [64][DP] tile
  static constexpr int kV = kTileT<DP>;  // v^T: DP rows x 64 keys
  // q hi, q lo, k hi, k lo, v^T hi, v^T lo, the next key tile's k and v
  // as copied (fp32), the keys' mask bias
  static constexpr int kQo = 0, kKo = 2 * kQ, kVo = 4 * kQ, kRo = kVo + 2 * kV,
                       kMo = kRo + 2 * kQ;
  static constexpr size_t kSmem = 1024 + (size_t)kMo + 64 * 4;
};

// kTrain (a launch that saves or draws dropout; a compile-time switch, since
// its checks slow the served launches by ~5%): dropout on p (site head,
// counter query * S + key) where drop.on, and the row statistics to stat_m /
// stat_l where non-null
template <int DP, bool kRel, bool kTrain>
__global__ void __launch_bounds__(128)
attn_tf32_kernel(const float* __restrict__ qkv, const int32_t* __restrict__ mask,
                 float* __restrict__ ctx, const float* __restrict__ rel, int S, int H,
                 int N, int D, float scale, int causal, float* __restrict__ stat_m,
                 float* __restrict__ stat_l, Drop drop) {
  using AS = AttnShape<DP>;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);
  float* mb = reinterpret_cast<float*>(sm + AS::kMo);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tq = lane & 3;
  const int q0 = blockIdx.x * 64, head = blockIdx.y, b = blockIdx.z;
  const int ld = 3 * H;
  const float* qh = qkv + (size_t)b * S * ld + head * D;
  const float* kh = qh + H;
  const float* vh = qh + 2 * H;
  const int32_t* mask_row = mask + (size_t)b * S;
  const int t_end = key_tiles_end(q0, S, causal_skip(mask_row, causal));
  const float* relh = kRel ? head_slab(rel, b, head, N, S) : nullptr;
  const int rloc = 16 * warp + (lane >> 2);  // this thread's rows rloc, rloc + 8
  uint32_t hk = 0;
  if constexpr (kTrain) hk = site_key(drop, b, head);

  // the raw k and v tiles of the key tile at t0 (fp32, swizzled panels)
  auto fetch = [&](int t0) {
#pragma unroll
    for (int p = 0; p < DP / 32; ++p) {
      copy_panel<64, 128>(base + AS::kRo + p * kPanel, kh, ld, t0, S, 32 * p, D);
      copy_panel<64, 128>(base + AS::kRo + AS::kQ + p * kPanel, vh, ld, t0, S, 32 * p, D);
    }
  };
  // q, split once, and the first key tile's copies
#pragma unroll
  for (int p = 0; p < DP / 32; ++p)
    copy_panel<64, 128>(base + AS::kQo + p * kPanel, qh, ld, q0, S, 32 * p, D);
  fetch(0);
  cp_async_commit();

  float o[DP / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int t0 = 0; t0 < t_end; t0 += 64) {
    // this tile's copies landed: each thread splits the chunks it copied,
    // k in place of the tile's k, v transposed into v^T (key, d) -> (d,
    // key); then the next tile's copies start into the freed raw tiles
    cp_async_wait<0>();
    if (t0 == 0)
#pragma unroll
      for (int p = 0; p < DP / 32; ++p)
        split_panel<64, 128>(sm + AS::kQo + p * kPanel, AS::kQ);
    split_tile<DP, 128, true, false>(threadIdx.x & 127, sm + AS::kRo, sm + AS::kKo, nullptr);
    split_tile<DP, 128, false, true>(threadIdx.x & 127, sm + AS::kRo + AS::kQ, nullptr, sm + AS::kVo);
    if (tid < 64) {
      const int t = t0 + tid;
      mb[tid] = t < S ? (mask_row[t] > 0 ? 0.f : kAttnNegMask) : -INFINITY;
    }
    fence_async_smem();
    __syncthreads();
    if (t0 + 64 < t_end) fetch(t0 + 64);
    cp_async_commit();

    // s = q k^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int pan = (kk >> 2) * kPanel;
      mma3(s, base + AS::kQo + pan, AS::kQ, base + AS::kKo + pan, AS::kQ, kk & 3);
    }
    wgmma_commit();
    wgmma_wait_n<0>();
    fence_regs(s);

    // scale, biases, online max and sum; p = exp(s - m) into shared memory
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + rloc + 8 * h;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = 8 * j + 2 * tq + e, key = t0 + kl;
          const float bm = mb[kl];
          const float bias = (causal && key > q) ? bm + kAttnNegMask : bm;
          float v = (bm == -INFINITY) ? -INFINITY : s[4 * j + 2 * h + e] * scale + bias;
          if constexpr (kRel)
            if (bm != -INFINITY && q < S) v += __ldg(relh + (size_t)q * S + key);
          s[4 * j + 2 * h + e] = v;
          tmax = fmaxf(tmax, v);
        }
      const float mn = fmaxf(m[h], quad_max(tmax));
      alpha[h] = exp2f((m[h] - mn) * kAttnLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f((s[4 * j + 2 * h + e] - mn) * kAttnLog2e);
          sum += p;
          if constexpr (kTrain) {
            const int key = t0 + 8 * j + 2 * tq + e;
            if (drop.on && q < S && key < S)
              p *= keep_scale_k(drop, hk, (uint32_t)(q * S + key));
          }
          s[4 * j + 2 * h + e] = p;
        }
      l[h] = l[h] * alpha[h] + sum;
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * j + 2 * h] *= alpha[h];
        o[4 * j + 2 * h + 1] *= alpha[h];
      }
    // o += p v, p from the registers: k-block j of the A fragment is the
    // accumulator's keys 8 j + 2 tq (k = tq) and 8 j + 2 tq + 1 (k = tq +
    // 4), rows rloc and rloc + 8 -- v^T's columns are in that order
    uint32_t ph[8][4], pl[8][4];
    to_frags_tf32(ph, pl, s);
    fence_regs(o);
    wgmma_fence();
    mma3_frags<DP>(o, ph, pl, base + AS::kVo);
    wgmma_commit();
    wgmma_wait_n<0>();
    fence_regs(o);
    __syncthreads();  // k, v^T and the mask are rewritten next
  }
  cp_async_wait<0>();

  float* oh = ctx + (size_t)b * S * H + head * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + rloc + 8 * h;
    const float lsum = quad_sum(l[h]);
    const float inv = 1.0f / lsum;
    if (q >= S) continue;
    if (kTrain && stat_m && tq == 0) {
      const size_t at_q = ((size_t)b * N + head) * S + q;
      stat_m[at_q] = m[h];
      stat_l[at_q] = lsum;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (d < D)
        *reinterpret_cast<float2*>(oh + (size_t)q * H + d) =
            make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// attention backward
// ---------------------------------------------------------------------------
struct AttnBwdArgs {
  const float* qkv;    // [B S, 3H], the forward's
  const float* ctx;    // [B S, H], the forward's output o
  const float* dctx;   // [B S, H], dO
  const int32_t* mask;
  const float *stat_m, *stat_l;  // [B, N, S]
  float* delta;                  // [B, N, S], written by the dq kernel
  float* dqkv;                   // [B S, 3H]
  const float* rel;              // [B, N, S, S] or null
  float* drel;
  Drop drop;
  int S, H, N, D, causal;
  float scale;
};

// the softmax backward's elementwise step at one score: p recomputed from
// the forward's statistics as exp(s - stat_m) / stat_l, then p keep (for
// dv) and ds = p (dp keep - delta)
struct ScoreGrad {
  float pk, ds;
};
__device__ __forceinline__ ScoreGrad score_grad(float s, float bm, int q, int key,
                                                const AttnBwdArgs& a, const float* relh,
                                                float m, float inv_l, float delta, float dp,
                                                uint32_t hk) {
  const float bias = (a.causal && key > q) ? bm + kAttnNegMask : bm;
  float v = (bm == -INFINITY) ? -INFINITY : s * a.scale + bias;
  if (relh && bm != -INFINITY && q < a.S) v += __ldg(relh + (size_t)q * a.S + key);
  const float p = exp2f((v - m) * kAttnLog2e) * inv_l;
  const float keep = (a.drop.on && q < a.S && key < a.S)
                         ? keep_scale_k(a.drop, hk, (uint32_t)(q * a.S + key))
                         : 1.f;
  return {p * keep, p * (dp * keep - delta)};
}

template <int DP>
struct DqShape {
  static constexpr int kQ = kTileQ<DP>, kV = kTileT<DP>;
  // q, dO, k, v (hi / lo each), k^T hi / lo, the next key tile's raw k and
  // v, the keys' mask bias, the rows' delta
  static constexpr int kQo = 0, kDo = 2 * kQ, kKo = 4 * kQ, kVo = 6 * kQ, kTo = 8 * kQ,
                       kRo = kTo + 2 * kV, kMo = kRo + 2 * kQ, kEo = kMo + 64 * 4;
  static constexpr size_t kSmem = 1024 + (size_t)kEo + 64 * 4;
};

template <int DP, bool kRel>
__global__ void __launch_bounds__(128) attn_dq_tf32_kernel(AttnBwdArgs a) {
  using AS = DqShape<DP>;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);
  float* mb = reinterpret_cast<float*>(sm + AS::kMo);
  float* dl_s = reinterpret_cast<float*>(sm + AS::kEo);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tq = lane & 3;
  const int q0 = blockIdx.x * 64, head = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, D = a.D, ld = 3 * H;
  const float* qh = a.qkv + (size_t)b * S * ld + head * D;
  const float* kh = qh + H;
  const float* vh = qh + 2 * H;
  const float* doh = a.dctx + (size_t)b * S * H + head * D;
  const float* oh = a.ctx + (size_t)b * S * H + head * D;
  const int32_t* mask_row = a.mask + (size_t)b * S;
  const int t_end = key_tiles_end(q0, S, causal_skip(mask_row, a.causal));
  const float* relh = kRel ? head_slab(a.rel, b, head, a.N, S) : nullptr;
  float* drelh = kRel ? head_slab(a.drel, b, head, a.N, S) : nullptr;
  const size_t stat0 = ((size_t)b * a.N + head) * S;
  const uint32_t hk = site_key(a.drop, b, head);
  const int rloc = 16 * warp + (lane >> 2);

  auto fetch = [&](int t0) {
#pragma unroll
    for (int p = 0; p < DP / 32; ++p) {
      copy_panel<64, 128>(base + AS::kRo + p * kPanel, kh, ld, t0, S, 32 * p, D);
      copy_panel<64, 128>(base + AS::kRo + AS::kQ + p * kPanel, vh, ld, t0, S, 32 * p, D);
    }
  };
#pragma unroll
  for (int p = 0; p < DP / 32; ++p) {
    copy_panel<64, 128>(base + AS::kQo + p * kPanel, qh, ld, q0, S, 32 * p, D);
    copy_panel<64, 128>(base + AS::kDo + p * kPanel, doh, H, q0, S, 32 * p, D);
  }
  fetch(0);
  cp_async_commit();
  // delta = dO . o per query row, for this kernel and the dk / dv one
  if (tid < 64) {
    const int q = q0 + tid;
    float dl = 0.f;
    if (q < S) {
      for (int d = 0; d < D; ++d) dl += doh[(size_t)q * H + d] * oh[(size_t)q * H + d];
      a.delta[stat0 + q] = dl;
    }
    dl_s[tid] = dl;
  }
  float mr[2], il[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + rloc + 8 * h;
    mr[h] = q < S ? a.stat_m[stat0 + q] : 0.f;
    il[h] = q < S ? 1.0f / a.stat_l[stat0 + q] : 0.f;
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  for (int t0 = 0; t0 < t_end; t0 += 64) {
    cp_async_wait<0>();
    if (t0 == 0)
#pragma unroll
      for (int p = 0; p < DP / 32; ++p) {
        split_panel<64, 128>(sm + AS::kQo + p * kPanel, AS::kQ);
        split_panel<64, 128>(sm + AS::kDo + p * kPanel, AS::kQ);
      }
    split_tile<DP, 128, true, true>(threadIdx.x & 127, sm + AS::kRo, sm + AS::kKo, sm + AS::kTo);
    split_tile<DP, 128, true, false>(threadIdx.x & 127, sm + AS::kRo + AS::kQ, sm + AS::kVo, nullptr);
    if (tid < 64) {
      const int t = t0 + tid;
      mb[tid] = t < S ? (mask_row[t] > 0 ? 0.f : kAttnNegMask) : -INFINITY;
    }
    fence_async_smem();
    __syncthreads();
    if (t0 == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) dr[h] = dl_s[rloc + 8 * h];
    if (t0 + 64 < t_end) fetch(t0 + 64);
    cp_async_commit();

    // s = q k^T, dp = dO v^T
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int pan = (kk >> 2) * kPanel;
      mma3(s, base + AS::kQo + pan, AS::kQ, base + AS::kKo + pan, AS::kQ, kk & 3);
      mma3(dp, base + AS::kDo + pan, AS::kQ, base + AS::kVo + pan, AS::kQ, kk & 3);
    }
    wgmma_commit();
    wgmma_wait_n<0>();
    fence_regs(s);
    fence_regs(dp);

    // ds = p (dp keep - delta) in place of s, and dRel = ds
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + rloc + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, kl = 8 * j + 2 * tq + e, key = t0 + kl;
          const float ds =
              score_grad(s[i], mb[kl], q, key, a, relh, mr[h], il[h], dr[h], dp[i], hk).ds;
          if constexpr (kRel)
            if (q < S && key < S) drelh[(size_t)q * S + key] = ds;
          s[i] = ds;
        }
    }
    // dq += ds k: ds from the registers, k^T the B tile
    uint32_t dh[8][4], dlo[8][4];
    to_frags_tf32(dh, dlo, s);
    fence_regs(dq);
    wgmma_fence();
    mma3_frags<DP>(dq, dh, dlo, base + AS::kTo);
    wgmma_commit();
    wgmma_wait_n<0>();
    fence_regs(dq);
    __syncthreads();  // k, v, k^T and the mask are rewritten next
  }
  cp_async_wait<0>();
  if constexpr (kRel)  // the key tiles causal_skip skipped: p = 0, dRel = 0
    for (int idx = tid; idx < 64 * (S - t_end); idx += 128) {
      const int q = q0 + idx / (S - t_end), key = t_end + idx % (S - t_end);
      if (q < S) drelh[(size_t)q * S + key] = 0.f;
    }

  float* out = a.dqkv + (size_t)b * S * ld + head * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + rloc + 8 * h;
    if (q >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (d < D)
        *reinterpret_cast<float2*>(out + (size_t)q * ld + d) =
            make_float2(dq[4 * j + 2 * h] * a.scale, dq[4 * j + 2 * h + 1] * a.scale);
    }
  }
}

template <int DP>
struct DkvShape {
  static constexpr int kQ = kTileQ<DP>, kV = kTileT<DP>;
  // k and v raw, q and dO hi / lo, q^T and dO^T hi / lo, the next query
  // tile's raw q and dO, the query tile's max, 1 / sum and delta
  static constexpr int kKo = 0, kVo = kQ, kQo = 2 * kQ, kDo = 4 * kQ, kQTo = 6 * kQ,
                       kDTo = kQTo + 2 * kV, kRo = kDTo + 2 * kV, kSo = kRo + 2 * kQ;
  static constexpr size_t kSmem = 1024 + (size_t)kSo + 3 * 64 * 4;
  static_assert(kSmem <= 232448, "a block's shared memory");
};

template <int DP, bool kRel>
__global__ void __launch_bounds__(128) attn_dkv_tf32_kernel(AttnBwdArgs a) {
  using AS = DkvShape<DP>;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);
  float* st = reinterpret_cast<float*>(sm + AS::kSo);  // m [64], 1/l [64], delta [64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tq = lane & 3;
  const int k0 = blockIdx.x * 64, head = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, D = a.D, ld = 3 * H;
  const float* qh = a.qkv + (size_t)b * S * ld + head * D;
  const float* kh = qh + H;
  const float* vh = qh + 2 * H;
  const float* doh = a.dctx + (size_t)b * S * H + head * D;
  const int32_t* mask_row = a.mask + (size_t)b * S;
  // the query tiles wholly before this key tile see none of it where the
  // forward skipped it (the mirror of key_tiles_end)
  const int q_begin = causal_skip(mask_row, a.causal) ? k0 : 0;
  const float* relh = kRel ? head_slab(a.rel, b, head, a.N, S) : nullptr;
  const size_t stat0 = ((size_t)b * a.N + head) * S;
  const uint32_t hk = site_key(a.drop, b, head);
  const int rloc = 16 * warp + (lane >> 2);  // this thread's keys k0 + rloc, + 8

  auto fetch = [&](int q0) {
#pragma unroll
    for (int p = 0; p < DP / 32; ++p) {
      copy_panel<64, 128>(base + AS::kRo + p * kPanel, qh, ld, q0, S, 32 * p, D);
      copy_panel<64, 128>(base + AS::kRo + AS::kQ + p * kPanel, doh, H, q0, S, 32 * p, D);
    }
  };
#pragma unroll
  for (int p = 0; p < DP / 32; ++p) {
    copy_panel<64, 128>(base + AS::kKo + p * kPanel, kh, ld, k0, S, 32 * p, D);
    copy_panel<64, 128>(base + AS::kVo + p * kPanel, vh, ld, k0, S, 32 * p, D);
  }
  fetch(q_begin);
  cp_async_commit();
  float bk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + rloc + 8 * h;
    bk[h] = key < S ? (mask_row[key] > 0 ? 0.f : kAttnNegMask) : -INFINITY;
  }

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int q0 = q_begin; q0 < S; q0 += 64) {
    cp_async_wait<0>();
    split_tile<DP, 128, true, true>(threadIdx.x & 127, sm + AS::kRo, sm + AS::kQo, sm + AS::kQTo);
    split_tile<DP, 128, true, true>(threadIdx.x & 127, sm + AS::kRo + AS::kQ, sm + AS::kDo, sm + AS::kDTo);
    if (tid < 64) {
      const int q = q0 + tid;
      const bool ok = q < S;
      st[tid] = ok ? a.stat_m[stat0 + q] : 0.f;
      st[64 + tid] = ok ? 1.0f / a.stat_l[stat0 + q] : 0.f;
      st[128 + tid] = ok ? a.delta[stat0 + q] : 0.f;
    }
    fence_async_smem();
    __syncthreads();
    if (q0 + 64 < S) fetch(q0 + 64);
    cp_async_commit();

    // s^T = k q^T, dp^T = v dO^T (rows the keys, columns the queries), a
    // 32-column panel of k and v at a time as split A fragments
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int p = 0; p < DP / 32; ++p) {
      uint32_t kh[4][4], kl[4][4], vh[4][4], vl[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        frag_rows(kh[q], kl[q], sm + AS::kKo, 4 * p + q);
        frag_rows(vh[q], vl[q], sm + AS::kVo, 4 * p + q);
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kb = 4 * p + q;
        mma3_rs_ba(s, kh[q], kl[q], bdesc(base + AS::kQo, 64, kb),
                   bdesc(base + AS::kQo + AS::kQ, 64, kb));
        mma3_rs_ba(dp, vh[q], vl[q], bdesc(base + AS::kDo, 64, kb),
                   bdesc(base + AS::kDo + AS::kQ, 64, kb));
      }
      wgmma_commit();
      wgmma_wait_n<0>();
    }
    fence_regs(s);
    fence_regs(dp);

    // p keep in place of s^T, ds in place of dp^T
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + rloc + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, ql = 8 * j + 2 * tq + e, q = q0 + ql;
          const ScoreGrad g = score_grad(s[i], bk[h], q, key, a, relh, st[ql], st[64 + ql],
                                         st[128 + ql], dp[i], hk);
          s[i] = g.pk;
          dp[i] = g.ds;
        }
    }
    // dv += (p keep)^T dO, dk += ds^T q: the fragments from the registers,
    // dO^T and q^T the B tiles
    uint32_t ph[8][4], pl[8][4], dh[8][4], dlo[8][4];
    to_frags_tf32(ph, pl, s);
    to_frags_tf32(dh, dlo, dp);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    mma3_frags<DP>(dv, ph, pl, base + AS::kDTo);
    mma3_frags<DP>(dk, dh, dlo, base + AS::kQTo);
    wgmma_commit();
    wgmma_wait_n<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // q, dO, their transposes and the statistics are rewritten next
  }
  cp_async_wait<0>();

  float* out = a.dqkv + (size_t)b * S * ld + head * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + rloc + 8 * h;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (d >= D) continue;
      *reinterpret_cast<float2*>(out + (size_t)key * ld + H + d) =
          make_float2(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
      *reinterpret_cast<float2*>(out + (size_t)key * ld + 2 * H + d) =
          make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradients: part[z][K1][N] = sum over the rows m of chunk z of A[m][k]
// B[m][n], A [M, K1] and B [M, N] row-major. A block: two warpgroups of 64
// rows k, 128 columns n; a step of 32 rows m: A's raw tile, read by
// frag_cols as the transposed A fragments, and B's, transposed as it is
// split into the K-major B tile [128 n][32 m, even-first]
// ---------------------------------------------------------------------------
constexpr int kWgBN = 128, kWgST = 3;
struct WgShape {
  static constexpr int kA = 4 * 32 * 128;  // A raw [32 m][128 k], four panels
  static constexpr int kB = kA;            // B raw [32 m][128 n]
  static constexpr int kBT = kWgBN * 128;  // B^T [128 n][32 m]
  static constexpr int kStage = kA + kB + 2 * kBT;
  static constexpr size_t kSmem = 1024 + (size_t)kWgST * kStage;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

__global__ void __launch_bounds__(256, 1)
wgrad_tf32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ part, int M, int K1, int N, int chunk) {
  using W = WgShape;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);
  const int k0 = blockIdx.x * 128, n0 = blockIdx.y * kWgBN, z = blockIdx.z;
  const int m_begin = z * chunk, m_end = min(M, m_begin + chunk);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x;
  float acc[kWgBN / 2];
#pragma unroll
  for (int i = 0; i < kWgBN / 2; ++i) acc[i] = 0.f;
  ring<kWgST>(
      (m_end - m_begin + 31) / 32,
      [&](int ks) {
        const uint32_t st = base + (ks % kWgST) * W::kStage;
        const int m0 = m_begin + 32 * ks;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          copy_panel<32, 256>(st + p * 32 * 128, A, K1, m0, m_end, k0 + 32 * p, K1);
          copy_panel<32, 256>(st + W::kA + p * 32 * 128, B, N, m0, m_end, n0 + 32 * p, N);
        }
      },
      [&](int stage) {
        uint8_t* st = sm + stage * W::kStage;
        const int r = tid >> 3, c = tid & 7;  // this thread's chunk of each panel
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(st + W::kA + p * 32 * 128 + chunk_at(r, c));
          const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float h, l;
            split_tf32(v[e], h, l);
            const uint32_t o = at(kWgBN, 32 * p + 4 * c + e, kpos(r));
            *reinterpret_cast<float*>(st + W::kA + W::kB + o) = h;
            *reinterpret_cast<float*>(st + W::kA + W::kB + W::kBT + o) = l;
          }
        }
      },
      [&](int stage) {
        const uint8_t* st = sm + stage * W::kStage;
        const uint32_t bt = base + stage * W::kStage + W::kA + W::kB;
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) frag_cols<32, true>(hi[kb], lo[kb], st, 0, 64 * wg, kb);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
          mma3_rs<kWgBN>(acc, hi[kb], lo[kb], kdesc(bt, kb), kdesc(bt + W::kBT, kb));
      });
  fence_regs(acc);
  const int lt = tid & 127, tq = lt & 3;
  const int row = k0 + 64 * wg + 16 * (lt >> 5) + ((lt & 31) >> 2);
  float* out = part + (size_t)z * K1 * N;
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * tq;  // c < N implies c + 1 < N (N even)
    if (c >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = row + 8 * h;
      if (k < K1)
        *reinterpret_cast<float2*>(out + (size_t)k * N + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// column sums of X [M, N] over chunks of kColRows rows: part[chunk][N]
constexpr int kColRows = 256;

__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ X, float* __restrict__ part, int M, int N) {
  const int n = blockIdx.y * 256 + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.x * kColRows, m1 = min(M, m0 + kColRows);
  float s = 0.f;
  for (int m = m0; m < m1; ++m) s += X[(size_t)m * N + n];
  part[(size_t)blockIdx.x * N + n] = s;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <int kEpi>
cudaError_t gemm_tf32(const GemmArgs& g, cudaStream_t st) {
  cudaError_t err = allow_smem(gemm_tf32_kernel<kEpi>, GemmRing::kSmem);
  if (err != cudaSuccess) return err;
  gemm_tf32_kernel<kEpi><<<dim3(ceil_div(g.M, 128), ceil_div(g.N, kGemmBN)), 256,
                           GemmRing::kSmem, st>>>(g);
  return cudaGetLastError();
}

cudaError_t gemm_tf32(int epi, const float* A, const float* whi, const float* wlo,
                      const float* bias, float* C, int M, int K, int N, cudaStream_t st) {
  const GemmArgs g{A, whi, wlo, bias, C, M, K, N, nullptr, nullptr, nullptr, nullptr};
  return epi == kEpiBias ? gemm_tf32<kEpiBias>(g, st) : gemm_tf32<kEpiBiasGelu>(g, st);
}

template <int HP, int kMode>
cudaError_t launch_ln(const LnArgs& a, cudaStream_t st) {
  using LS = LnShape<HP>;
  cudaError_t err = allow_smem(ln_tf32_kernel<HP, kMode>, LS::kSmem);
  if (err != cudaSuccess) return err;
  ln_tf32_kernel<HP, kMode><<<ceil_div(a.M, LS::kRowsB), 256, LS::kSmem, st>>>(a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t ln_tf32(const LnArgs& a, cudaStream_t st) {
  if (a.H <= 64) return launch_ln<64, kMode>(a, st);
  if (a.H <= 128) return launch_ln<128, kMode>(a, st);
  return launch_ln<256, kMode>(a, st);
}

int ln_blocks(int M, int H) { return ceil_div(M, H <= 128 ? 128 : 64); }

cudaError_t ln_rows_bwd(const LnArgs& a, const float* dy, cudaStream_t st) {
  const int grid = ceil_div(a.M, kLnRowsB);
  if (a.H <= 64)
    ln_rows_bwd_kernel<64><<<grid, 256, 0, st>>>(a, dy);
  else if (a.H <= 128)
    ln_rows_bwd_kernel<128><<<grid, 256, 0, st>>>(a, dy);
  else
    ln_rows_bwd_kernel<256><<<grid, 256, 0, st>>>(a, dy);
  return cudaGetLastError();
}

template <int DP, bool kRel, bool kTrain>
cudaError_t launch_attn(const float* qkv, const int32_t* mask, float* ctx, const float* rel,
                        int B, int S, int H, int N, int D, float scale, int causal,
                        float* stat_m, float* stat_l, Drop drop, cudaStream_t st) {
  using AS = AttnShape<DP>;
  cudaError_t err = allow_smem(attn_tf32_kernel<DP, kRel, kTrain>, AS::kSmem);
  if (err != cudaSuccess) return err;
  attn_tf32_kernel<DP, kRel, kTrain><<<dim3(ceil_div(S, 64), N, B), 128, AS::kSmem, st>>>(
      qkv, mask, ctx, rel, S, H, N, D, scale, causal, stat_m, stat_l, drop);
  return cudaGetLastError();
}

template <bool kTrain>
cudaError_t attn_tf32(const float* qkv, const int32_t* mask, float* ctx, const float* rel,
                      int B, int S, int H, int N, int D, float scale, int causal,
                      float* stat_m, float* stat_l, Drop drop, cudaStream_t st) {
#define B4R_ATTN(DPV, REL)                                                                  \
  launch_attn<DPV, REL, kTrain>(qkv, mask, ctx, rel, B, S, H, N, D, scale, causal, stat_m, \
                                stat_l, drop, st)
  if (D <= 32) return rel ? B4R_ATTN(32, true) : B4R_ATTN(32, false);
  return rel ? B4R_ATTN(64, true) : B4R_ATTN(64, false);
#undef B4R_ATTN
}

template <int DP, bool kRel>
cudaError_t launch_attn_bwd(const AttnBwdArgs& a, int B, cudaStream_t st) {
  cudaError_t err = allow_smem(attn_dq_tf32_kernel<DP, kRel>, DqShape<DP>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(a.S, 64), a.N, B);
  attn_dq_tf32_kernel<DP, kRel><<<grid, 128, DqShape<DP>::kSmem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attn_dkv_tf32_kernel<DP, kRel>, DkvShape<DP>::kSmem)) != cudaSuccess)
    return err;
  attn_dkv_tf32_kernel<DP, kRel><<<grid, 128, DkvShape<DP>::kSmem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t attn_bwd_tf32(const AttnBwdArgs& a, int B, cudaStream_t st) {
  if (a.D <= 32)
    return a.rel ? launch_attn_bwd<32, true>(a, B, st) : launch_attn_bwd<32, false>(a, B, st);
  return a.rel ? launch_attn_bwd<64, true>(a, B, st) : launch_attn_bwd<64, false>(a, B, st);
}

// rows a weight-gradient block sums: the grid near two waves of one block an
// SM (264 blocks on an H100), a multiple of 32, at most 1,024
int wgrad_chunk(int M, int K1, int N) {
  const int tiles = ceil_div(K1, 128) * ceil_div(N, kWgBN);
  const int chunk = 32 * ceil_div(ceil_div(M, ceil_div(264, tiles)), 32);
  return std::min(chunk, 1024);
}
int wgrad_splits(int M, int K1, int N) { return ceil_div(M, wgrad_chunk(M, K1, N)); }

// dW [K1, N] = A^T B over the M rows: split partials, then summed in order
cudaError_t wgrad_tf32(const float* A, const float* B, float* scratch, float* dW, int M,
                       int K1, int N, cudaStream_t st) {
  cudaError_t err = allow_smem(wgrad_tf32_kernel, WgShape::kSmem);
  if (err != cudaSuccess) return err;
  const int splits = wgrad_splits(M, K1, N);
  wgrad_tf32_kernel<<<dim3(ceil_div(K1, 128), ceil_div(N, kWgBN), splits), 256,
                      WgShape::kSmem, st>>>(A, B, scratch, M, K1, N,
                                            wgrad_chunk(M, K1, N));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_rows(scratch, dW, splits, K1 * N, st);
}

// out [N] = the column sums of X [M, N]
cudaError_t colsum(const float* X, float* scratch, float* out, int M, int N, cudaStream_t st) {
  const int chunks = ceil_div(M, kColRows);
  colsum_kernel<<<dim3(chunks, ceil_div(N, 256)), 256, 0, st>>>(X, scratch, M, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_rows(scratch, out, chunks, N, st);
}

// W^T hi and lo of the given matrices (K[i] = N[i] = 0: none), each carved
// to 256 bytes
WtJob split_job(Carve& c, const float* const (&w)[4], const int (&K)[4], const int (&N)[4]) {
  WtJob job;
  job.first[0] = 0;
  for (int i = 0; i < 4; ++i) {
    job.w[i] = w[i];
    job.K[i] = K[i];
    job.N[i] = N[i];
    job.hi[i] = c.take<float>((size_t)K[i] * N[i]);
    job.lo[i] = c.take<float>((size_t)K[i] * N[i]);
    job.first[i + 1] = job.first[i] + ceil_div(K[i], 32) * ceil_div(N[i], 32);
  }
  return job;
}

// the forward's workspace: W^T hi, then lo, for Wqkv [H, 3H], Wo [H, H],
// W1 [H, F] and W2 [F, H]
struct Tf32Scratch {
  WtJob job;
  size_t bytes;
  Tf32Scratch(void* base, const float* const (&w)[4], int H, int F) {
    Carve c{static_cast<char*>(base), 0};
    job = split_job(c, w, {H, H, H, F}, {3 * H, H, F, H});
    bytes = c.used;
  }
};

// the backward's workspace: the four weights' hi / lo as stored (wj), W1^T's
// (w1t), the activation gradients and the split partials
struct Tf32BwdScratch {
  WtJob wj, w1t;
  float *dw_res, *df, *dhpre, *du, *dattn, *dctx, *dqkv, *delta, *part;
  size_t bytes;
  Tf32BwdScratch(void* base, const float* const (&w)[4], int B, int S, int H, int N, int F) {
    const size_t M = (size_t)B * S;
    Carve c{static_cast<char*>(base), 0};
    wj = split_job(c, w, {H, H, H, F}, {3 * H, H, F, H});
    const float* const w1[4] = {w[2], nullptr, nullptr, nullptr};
    w1t = split_job(c, w1, {H, 0, 0, 0}, {F, 0, 0, 0});
    dw_res = c.take<float>(M * H);
    df = c.take<float>(M * H);
    dhpre = c.take<float>(M * F);
    du = c.take<float>(M * H);
    dattn = c.take<float>(M * H);
    dctx = c.take<float>(M * H);
    dqkv = c.take<float>(M * 3 * H);
    delta = c.take<float>((size_t)B * N * S);
    // the largest of every split reduction's partials
    size_t np = 0;
    const int wk[4][2] = {{F, H}, {H, F}, {H, H}, {H, 3 * H}};  // dW2, dW1, dWo, dWqkv
    for (const auto& kn : wk)
      np = std::max(np, (size_t)wgrad_splits((int)M, kn[0], kn[1]) * kn[0] * kn[1]);
    np = std::max(np, (size_t)ceil_div(M, kLnRowsB) * 3 * H);
    np = std::max(np, (size_t)ln_blocks((int)M, H) * 3 * H);
    np = std::max(np, (size_t)ceil_div(M, kColRows) * std::max(F, 3 * H));
    part = c.take<float>(np);
    bytes = c.used;
  }
};

// pointer orders (ops/fused_encoder_layer.py _TF32_PTRS / _TF32_BWD_PTRS)
enum Tf32Ptr {
  P_X, P_MASK, P_WQKV, P_BQKV, P_WO, P_BO, P_G1, P_B1LN, P_W1, P_BF1, P_W2, P_BF2, P_G2,
  P_B2LN, P_QKV, P_CTX, P_X1, P_HACT, P_Y, P_REL, P_WT, P_XHAT1, P_RSTD1, P_XHAT2,
  P_RSTD2, P_STAT_M, P_STAT_L, P_COUNT
};
enum Tf32BwdPtr {
  Q_X, Q_MASK, Q_DY, Q_WQKV, Q_WO, Q_W1, Q_W2, Q_BF1, Q_G1, Q_G2, Q_QKV, Q_CTX, Q_X1,
  Q_HACT, Q_XHAT1, Q_RSTD1, Q_XHAT2, Q_RSTD2, Q_STAT_M, Q_STAT_L, Q_DX, Q_DWQKV, Q_DBQKV,
  Q_DWO, Q_GLN1, Q_DW1, Q_DBF1, Q_DW2, Q_GLN2, Q_WORKSPACE, Q_REL, Q_DREL, Q_COUNT
};

bool tf32_shape_ok(int H, int N, int F) {
  const int D = H / N;
  return H <= 256 && D <= 64 && H % 8 == 0 && D % 8 == 0 && F % 8 == 0;
}

}  // namespace

extern "C" {

// Limits the wrapper's route checks (ops/fused_encoder_layer.py kernel_route).
int b4r_fused_layer_tf32_max_hidden() { return 256; }
int b4r_fused_layer_tf32_max_head_dim() { return 64; }

// Bytes of the workspace a forward launch writes W^T's hi and lo into.
size_t b4r_fused_layer_tf32_workspace_bytes(int H, int F) {
  const float* const none[4] = {nullptr, nullptr, nullptr, nullptr};
  return Tf32Scratch(nullptr, none, H, F).bytes;
}

// Bytes of the backward's workspace.
size_t b4r_fused_layer_bwd_tf32_workspace_bytes(int B, int S, int H, int N, int F) {
  const float* const none[4] = {nullptr, nullptr, nullptr, nullptr};
  return Tf32BwdScratch(nullptr, none, B, S, H, N, F).bytes;
}

// The fp32 forward, 3xTF32. ptrs: _TF32_PTRS order, every one fp32 but the
// int32 mask; the weights as the layer holds them ([H, 3H], [H, H], [H, F],
// [F, H], contiguous); qkv [B S, 3H], ctx [B S, H], x1 [B S, H], hact
// [B S, F]; rel ([B, N, S, S]) null or the relative bias; wt the workspace
// (b4r_fused_layer_tf32_workspace_bytes); causal != 0 adds the triangle. In
// training (non-null xhat1) also xhat1, xhat2 [B S, H], rstd1, rstd2 [B S],
// stat_m, stat_l [B, N, S]; a rate of 0 is `*_on == 0`. Nothing saved and
// both rates 0 runs the kernels' inference instantiations. Launches on
// `stream`; returns the first CUDA error.
int b4r_fused_layer_fwd_tf32(void* const* p, int B, int S, int H, int N, int F, int causal,
                             float scale, unsigned seed, unsigned attn_threshold,
                             float attn_scale, int attn_on, unsigned out_threshold,
                             float out_scale, int out_on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S, D = H / N;
  if (!tf32_shape_ok(H, N, F)) return (int)cudaErrorInvalidValue;
  const Drop ad{seed, attn_threshold, attn_scale, attn_on};
  const Drop od{seed, out_threshold, out_scale, out_on};
  const bool train = p[P_XHAT1] || attn_on || out_on;
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto o = [&](int i) { return static_cast<float*>(p[i]); };
  float* qkv = o(P_QKV);
  float* ctx = o(P_CTX);
  float* x1 = o(P_X1);
  float* hact = o(P_HACT);
  const int32_t* mask = static_cast<const int32_t*>(p[P_MASK]);
  const float* const w[4] = {f(P_WQKV), f(P_WO), f(P_W1), f(P_W2)};
  const Tf32Scratch wt(p[P_WT], w, H, F);
  const WtJob& j = wt.job;
  wt_split_kernel<<<j.first[4], 256, 0, st>>>(j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = gemm_tf32(kEpiBias, f(P_X), j.hi[0], j.lo[0], f(P_BQKV), qkv, M, H, 3 * H, st);
  if (err != cudaSuccess) return (int)err;
  err = train ? attn_tf32<true>(qkv, mask, ctx, f(P_REL), B, S, H, N, D, scale, causal,
                                o(P_STAT_M), o(P_STAT_L), ad, st)
              : attn_tf32<false>(qkv, mask, ctx, f(P_REL), B, S, H, N, D, scale, causal,
                                 nullptr, nullptr, ad, st);
  if (err != cudaSuccess) return (int)err;
  LnArgs ln{ctx, j.hi[1], j.lo[1], H, f(P_BO), f(P_X), f(P_G1), f(P_B1LN), x1, M, H,
            od, N, S, o(P_XHAT1), o(P_RSTD1), nullptr, nullptr};
  err = train ? ln_tf32<kLnTrain>(ln, st) : ln_tf32<kLnInfer>(ln, st);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tf32(kEpiBiasGelu, x1, j.hi[2], j.lo[2], f(P_BF1), hact, M, H, F, st);
  if (err != cudaSuccess) return (int)err;
  ln = LnArgs{hact, j.hi[3], j.lo[3], F, f(P_BF2), x1, f(P_G2), f(P_B2LN), o(P_Y), M, H,
              od, N + 1, S, o(P_XHAT2), o(P_RSTD2), nullptr, nullptr};
  return (int)(train ? ln_tf32<kLnTrain>(ln, st) : ln_tf32<kLnInfer>(ln, st));
}

// The fp32 backward (K2), 3xTF32, in the ten steps of the bf16
// layer_backward_wgmma (fused_encoder_layer.cu). ptrs: _TF32_BWD_PTRS order;
// the weights as stored; the forward's saves (its qkv, ctx, x1, hact, xhat1
// / 2, rstd1 / 2, stat_m / l: causal, rel and the seed and rates must be
// the forward's); gradients: dx [B S, H]; dwqkv [H, 3H], dbqkv [3H], dwo
// [H, H], gln1 [3, H] = (dg1, db1, dbo), dw1 [H, F], dbf1 [F], dw2 [F, H],
// gln2 [3, H] = (dg2, db2, dbf2); with rel, drel ([B, N, S, S]) receives
// dRel. workspace: b4r_fused_layer_bwd_tf32_workspace_bytes.
int b4r_fused_layer_bwd_tf32(void* const* p, int B, int S, int H, int N, int F, int causal,
                             float scale, unsigned seed, unsigned attn_threshold,
                             float attn_scale, int attn_on, unsigned out_threshold,
                             float out_scale, int out_on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S, D = H / N;
  if (!tf32_shape_ok(H, N, F)) return (int)cudaErrorInvalidValue;
  const Drop ad{seed, attn_threshold, attn_scale, attn_on};
  const Drop od{seed, out_threshold, out_scale, out_on};
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto o = [&](int i) { return static_cast<float*>(p[i]); };
  const float* const w[4] = {f(Q_WQKV), f(Q_WO), f(Q_W1), f(Q_W2)};
  const Tf32BwdScratch ws(p[Q_WORKSPACE], w, B, S, H, N, F);
  const WtJob &wj = ws.wj, &w1t = ws.w1t;
  cudaError_t err;
#define B4R_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err

  const long most = (long)std::max(3 * H * H, H * F);
  w_split_kernel<<<std::min(ceil_div(most, 256), 1024), 256, 0, st>>>(wj);
  B4R_TRY(cudaGetLastError());
  wt_split_kernel<<<w1t.first[4], 256, 0, st>>>(w1t);
  B4R_TRY(cudaGetLastError());
  // 1. LN2: dw_res = LN2'(dy), df = dw_res keep_N+1; dg2, db2, dbf2
  LnArgs ln{nullptr, nullptr, nullptr, 0, nullptr, nullptr, f(Q_G2), nullptr, ws.dw_res, M, H,
            od, N + 1, S, o(Q_XHAT2), o(Q_RSTD2), ws.df, ws.part};
  B4R_TRY(ln_rows_bwd(ln, f(Q_DY), st));
  B4R_TRY(reduce_rows(ws.part, o(Q_GLN2), ceil_div(M, kLnRowsB), 3 * H, st));
  // 2. dW2 = hact^T df
  B4R_TRY(wgrad_tf32(f(Q_HACT), ws.df, ws.part, o(Q_DW2), M, F, H, st));
  // 3. dhpre = (df W2^T) gelu'(x1 W1 + b1); dbf1
  B4R_TRY(gemm_tf32<kEpiGeluGrad>(GemmArgs{ws.df, wj.hi[3], wj.lo[3], f(Q_BF1), ws.dhpre, M, H,
                                           F, f(Q_X1), w1t.hi[0], w1t.lo[0], nullptr},
                                  st));
  B4R_TRY(colsum(ws.dhpre, ws.part, o(Q_DBF1), M, F, st));
  // 4. dW1 = x1^T dhpre
  B4R_TRY(wgrad_tf32(f(Q_X1), ws.dhpre, ws.part, o(Q_DW1), M, H, F, st));
  // 5. LN1: dx1 = dw_res + dhpre W1^T; du = LN1'(dx1), dattn = du keep_N;
  //    dg1, db1, dbo
  ln = LnArgs{ws.dhpre, wj.hi[2], wj.lo[2], F, nullptr, ws.dw_res, f(Q_G1), nullptr, ws.du,
              M, H, od, N, S, o(Q_XHAT1), o(Q_RSTD1), ws.dattn, ws.part};
  B4R_TRY(ln_tf32<kLnBwd>(ln, st));
  B4R_TRY(reduce_rows(ws.part, o(Q_GLN1), ln_blocks(M, H), 3 * H, st));
  // 6. dWo = ctx^T dattn
  B4R_TRY(wgrad_tf32(f(Q_CTX), ws.dattn, ws.part, o(Q_DWO), M, H, H, st));
  // 7. dctx = dattn Wo^T
  B4R_TRY(gemm_tf32<kEpiNone>(GemmArgs{ws.dattn, wj.hi[1], wj.lo[1], nullptr, ws.dctx, M, H,
                                       H, nullptr, nullptr, nullptr, nullptr},
                              st));
  // 8. attention: dq, dk, dv -> dqkv; with rel, dRel; dbqkv
  const AttnBwdArgs attn{f(Q_QKV),    f(Q_CTX),  ws.dctx,  static_cast<const int32_t*>(p[Q_MASK]),
                         f(Q_STAT_M), f(Q_STAT_L), ws.delta, ws.dqkv, f(Q_REL), o(Q_DREL),
                         ad,          S,           H,        N,       D,        causal,
                         scale};
  B4R_TRY(attn_bwd_tf32(attn, B, st));
  B4R_TRY(colsum(ws.dqkv, ws.part, o(Q_DBQKV), M, 3 * H, st));
  // 9. dWqkv = x^T dqkv
  B4R_TRY(wgrad_tf32(f(Q_X), ws.dqkv, ws.part, o(Q_DWQKV), M, H, 3 * H, st));
  // 10. dx = du + dqkv Wqkv^T
  B4R_TRY(gemm_tf32<kEpiAddF32>(GemmArgs{ws.dqkv, wj.hi[0], wj.lo[0], nullptr, o(Q_DX), M,
                                         3 * H, H, nullptr, nullptr, nullptr, ws.du},
                                st));
#undef B4R_TRY
  return 0;
}

}  // extern "C"
