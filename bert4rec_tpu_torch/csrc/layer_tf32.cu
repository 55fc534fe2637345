// The fused encoder layer's fp32 inference forward on Hopper's tensor
// cores, in 3xTF32 (sm_90a). Replaces, for the launches that save nothing
// for a backward and draw no dropout (serving, evaluation,
// recommend_stream), the TPU kernel _fwd_kernel (launched by _run_forward)
// of bert4rec_tpu/ops/fused_encoder_layer.py; ops/fused_encoder_layer.py
// kernel_route sends them here ("tf32"). It computes what
// fused_encoder_layer.cu's header writes, with T = float, no dropout:
//
//   qkv  = x Wqkv + bqkv
//   p    = softmax(q k^T / sqrt(D) + (mask > 0 ? 0 : -1e9)
//                  [+ (key > query ? -1e9 : 0) if causal] [+ rel[b, head]])
//   ctx  = p v
//   x1   = LN1(x + ctx Wo + bo)
//   hact = gelu_tanh(x1 W1 + b1)
//   y    = LN2(x1 + hact W2 + b2)
//
// 3xTF32. Every product runs on wgmma .tf32 with fp32 accumulators: each
// fp32 operand is split into hi = cvt.rna.tf32(v) and lo =
// cvt.rna.tf32(v - hi) (v - hi is exact in fp32), and a b accumulates
// lo_a hi_b + hi_a lo_b, then hi_a hi_b, per 8-deep k-block. The dropped
// lo_a lo_b and the roundings of lo leave each product within a few fp32
// ulps of a b (single-pass TF32 keeps 11 bits; this is why the SIMT
// kernels' "TF32 would change their results" no longer holds). The
// activations are split where they land in shared memory or the registers.
// wgmma reads .tf32 operands only K-major, and x W contracts over W's rows,
// so each launch first writes W^T's hi and lo for the four weights into the
// caller's workspace (wt_split_kernel, ~1.5 MB at H = 128): nothing is
// cached between launches, so whatever wrote the weights, the launch reads
// them as they are.
//
// Kernels (fp32 tiles of 32 columns = one 128-byte swizzle row, brought in
// by cp.async into a ring; the streamed activations split in place by the
// thread that copied them, attention's p in the registers):
//   wt_split_kernel    W [K, N] -> W^T hi, lo [N, K] for the four weights,
//                      through a 32 x 33 shared tile
//   gemm_tf32_kernel   qkv (+ bias) and W1 (+ bias, tanh-gelu): 128 x 128
//                      output tiles, two warpgroups of 64 rows, the W^T
//                      tiles streamed with the A tiles (3 stages)
//   ln_tf32_kernel     Wo and W2 (+ bias, residual, LayerNorm): a block
//                      owns whole rows (128, or 64 at H > 128 with the
//                      columns split between the warpgroups), the tile goes
//                      to shared memory and each warp takes whole rows for
//                      bias, residual and LayerNorm
//   attn_tf32_kernel   one warpgroup per (64-query tile, head, sequence),
//                      ONE pass over the key tiles with an online softmax
//                      in registers (inference saves no statistics): s =
//                      q k^T on wgmma from shared memory; p split in the
//                      registers into the A fragments of o += p v
//                      (register-A wgmma: k-block j holds keys 8 j + 2 (lane
//                      % 4) and + 1, so v^T is stored with each 8 keys'
//                      even ones first); the next key tile's copies run
//                      during this one's products; head dim <= 64
// The mask bias stays -1e9 (a row that sees only padding is uniform over
// its keys, as on the TPU); a key past the sequence is -inf. Causal and
// the relative bias are the SIMT kernels' law (attention.cuh tile_scores:
// the triangle's -1e9 added to the pad bias, rel added last, key tiles
// wholly after a query tile skipped where causal_skip says it is exact).
//
// Bound. 99.1 MFLOP a sequence at S = 200, H = 128, F = 512; 3xTF32 does
// three tensor-core products for each, so at the H100 SXM's published 495
// TFLOP/s of TF32 it runs at most at 165 TFLOP/s: 0.154 ms at B = 256 (at
// 67 TFLOP/s without tensor cores: 0.379 ms), against ~0.12 ms of
// activation traffic at 3.35 TB/s. Bound by operations; times on the card
// are in PERF.md.
//
// Layout rule (kernel_route, decided before any launch): H, the head dim
// and F multiples of 8, H <= 256, head dim <= 64, every operand 16-byte
// aligned and contiguous (the weights: contiguous).

#include "attention.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace b4r;
using namespace b4r::hopper;
using namespace b4r::tf32;

constexpr int kKs = 32;            // fp32 columns of one panel row (128 bytes)
constexpr int kPanel = kRows * 128;  // a 64-row panel

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
// C = epi(A W + bias): + bias (qkv) or + bias then tanh-gelu (W1)
// ---------------------------------------------------------------------------
constexpr int kGemmBN = 128, kGemmST = 3;
using GemmRing = Ring<2, 1, kGemmBN, kGemmST>;

template <bool kGelu>
__global__ void __launch_bounds__(256, 1)
gemm_tf32_kernel(const float* __restrict__ A, const float* __restrict__ whi,
                 const float* __restrict__ wlo, const float* __restrict__ bias,
                 float* __restrict__ C, int M, int K, int N) {
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * kGemmBN;
  float acc[kGemmBN / 64][32];
  mainloop<2, 1, kGemmBN, kGemmST>(acc, A, M, K, whi, wlo, N, m0, n0, sm);
  const int lt = threadIdx.x & 127, tq = lt & 3;
  const int row = m0 + 64 * (threadIdx.x >> 7) + 16 * (lt >> 5) + ((lt & 31) >> 2);
#pragma unroll
  for (int j = 0; j < kGemmBN / 64; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = n0 + 64 * j + 8 * q + 2 * tq;  // c < N implies c + 1 < N (N even)
      if (c >= N) continue;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= M) continue;
        float v0 = acc[j][4 * q + 2 * h] + b0, v1 = acc[j][4 * q + 2 * h + 1] + b1;
        if (kGelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        *reinterpret_cast<float2*>(C + (size_t)r * N + c) = make_float2(v0, v1);
      }
    }
}

// ---------------------------------------------------------------------------
// Y = LN(R + A W + bias) gamma + beta, a block owning whole rows. HP = H
// rounded up to 64, 128 or 256.
// ---------------------------------------------------------------------------
template <int HP>
struct LnShape {
  static constexpr int WM = HP <= 128 ? 2 : 1, WN = 2 / WM, BN = HP / WN;
  static constexpr int kRowsB = 64 * WM, ST = HP <= 128 ? 3 : 2, kLd = HP + 8;
  using R = Ring<WM, WN, BN, ST>;
  static constexpr size_t kTile = 1024 + (size_t)kRowsB * kLd * 4;
  static constexpr size_t kSmem = R::kSmem > kTile ? R::kSmem : kTile;
};

template <int HP>
__global__ void __launch_bounds__(256, 1)
ln_tf32_kernel(const float* __restrict__ A, const float* __restrict__ whi,
               const float* __restrict__ wlo, int K, const float* __restrict__ bias,
               const float* __restrict__ R, const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ Y, int M, int H) {
  using LS = LnShape<HP>;
  uint8_t* sm = aligned_smem();
  const int m0 = blockIdx.x * LS::kRowsB;
  float acc[LS::BN / 64][32];
  mainloop<LS::WM, LS::WN, LS::BN, LS::ST>(acc, A, M, K, whi, wlo, H, m0, 0, sm);
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
  // each warp takes whole rows, a lane 4 columns at a time
  constexpr int kT = (HP + 127) / 128;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_h = 1.0f / (float)H;
  for (int rr = warp; rr < LS::kRowsB; rr += 8) {
    const int r = m0 + rr;
    if (r >= M) break;
    float u[kT][4], sum = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = 4 * lane + 128 * t;
      u[t][0] = u[t][1] = u[t][2] = u[t][3] = 0.f;
      if (c >= H) continue;
      const float4 x = *reinterpret_cast<const float4*>(xs + rr * LS::kLd + c);
      const float4 b = *reinterpret_cast<const float4*>(bias + c);
      const float4 res = *reinterpret_cast<const float4*>(R + (size_t)r * H + c);
      u[t][0] = res.x + (x.x + b.x);
      u[t][1] = res.y + (x.y + b.y);
      u[t][2] = res.z + (x.z + b.z);
      u[t][3] = res.w + (x.w + b.w);
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
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = 4 * lane + 128 * t;
      if (c >= H) continue;
      const float4 g = *reinterpret_cast<const float4*>(gamma + c);
      const float4 e = *reinterpret_cast<const float4*>(beta + c);
      float4 y;
      y.x = (u[t][0] - mean) * rstd * g.x + e.x;
      y.y = (u[t][1] - mean) * rstd * g.y + e.y;
      y.z = (u[t][2] - mean) * rstd * g.z + e.z;
      y.w = (u[t][3] - mean) * rstd * g.w + e.w;
      *reinterpret_cast<float4*>(Y + (size_t)r * H + c) = y;
    }
  }
}

// ---------------------------------------------------------------------------
// W^T's hi and lo for the four weights: W [K, N] row-major -> hi, lo [N, K]
// row-major, a 32 x 32 tile a block, read and written along rows
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

// ---------------------------------------------------------------------------
// attention, one pass: a warpgroup per (64-query tile, head, sequence) over
// the packed [B*S, 3H] qkv; DP = the head dim rounded up to 32 or 64
// ---------------------------------------------------------------------------
template <int DP>
struct AttnShape {
  static constexpr int kQ = DP / 32 * kPanel;  // a 64-row [64][DP] tile
  static constexpr int kV = 2 * DP * 128;      // v^T: DP rows x 64 keys
  // q hi, q lo, k hi, k lo, v^T hi, v^T lo, the next key tile's k and v
  // as copied (fp32), the keys' mask bias
  static constexpr int kQo = 0, kKo = 2 * kQ, kVo = 4 * kQ, kRo = kVo + 2 * kV,
                       kMo = kRo + 2 * kQ;
  static constexpr size_t kSmem = 1024 + (size_t)kMo + 64 * 4;
};

template <int DP, bool kRel>
__global__ void __launch_bounds__(128)
attn_tf32_kernel(const float* __restrict__ qkv, const int32_t* __restrict__ mask,
                 float* __restrict__ ctx, const float* __restrict__ rel, int S, int H,
                 int N, int D, float scale, int causal) {
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
#pragma unroll
    for (int p = 0; p < DP / 32; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + 128 * i, r = idx >> 3, c = idx & 7;
        const uint32_t at = p * kPanel + chunk_at(r, c);
        const float4 kv = *reinterpret_cast<const float4*>(sm + AS::kRo + at);
        const float4 vv4 = *reinterpret_cast<const float4*>(sm + AS::kRo + AS::kQ + at);
        float4 h4, l4;
        split_tf32(kv.x, h4.x, l4.x);
        split_tf32(kv.y, h4.y, l4.y);
        split_tf32(kv.z, h4.z, l4.z);
        split_tf32(kv.w, h4.w, l4.w);
        *reinterpret_cast<float4*>(sm + AS::kKo + at) = h4;
        *reinterpret_cast<float4*>(sm + AS::kKo + AS::kQ + at) = l4;
        const float vv[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
        // key r's column of v^T: within each 8 keys, even keys first
        const int pan = r >> 5, kc = (r & 24) | ((r & 7) >> 1) | ((r & 1) << 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 32 * p + 4 * c + e;
          const int vt = AS::kVo + pan * DP * 128 + d * 128 + (((kc >> 2) ^ (d & 7)) << 4) +
                         (kc & 3) * 4;
          float h, lo;
          split_tf32(vv[e], h, lo);
          *reinterpret_cast<float*>(sm + vt) = h;
          *reinterpret_cast<float*>(sm + vt + AS::kV) = lo;
        }
      }
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
          const float p = exp2f((s[4 * j + 2 * h + e] - mn) * kAttnLog2e);
          s[4 * j + 2 * h + e] = p;
          sum += p;
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
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float hi, lo;
        split_tf32(s[4 * j + 2 * (r & 1) + (r >> 1)], hi, lo);
        ph[j][r] = __float_as_uint(hi);
        pl[j][r] = __float_as_uint(lo);
      }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t vt = base + AS::kVo + (j >> 2) * DP * 128;
      wgmma_tf32_rs<DP>(o, pl[j], kdesc(vt, j & 3));
      wgmma_tf32_rs<DP>(o, ph[j], kdesc(vt + AS::kV, j & 3));
      wgmma_tf32_rs<DP>(o, ph[j], kdesc(vt, j & 3));
    }
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
    const float inv = 1.0f / quad_sum(l[h]);
    if (q >= S) continue;
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
// launches
// ---------------------------------------------------------------------------
template <bool kGelu>
cudaError_t gemm_tf32(const float* A, const float* whi, const float* wlo, const float* bias,
                      float* C, int M, int K, int N, cudaStream_t st) {
  cudaError_t err = allow_smem(gemm_tf32_kernel<kGelu>, GemmRing::kSmem);
  if (err != cudaSuccess) return err;
  gemm_tf32_kernel<kGelu><<<dim3(ceil_div(M, 128), ceil_div(N, kGemmBN)), 256,
                            GemmRing::kSmem, st>>>(A, whi, wlo, bias, C, M, K, N);
  return cudaGetLastError();
}

// the workspace: W^T hi, then lo, for Wqkv [H, 3H], Wo [H, H], W1 [H, F]
// and W2 [F, H], each carved to 256 bytes
struct Tf32Scratch {
  WtJob job;
  size_t bytes;
  Tf32Scratch(void* base, const float* const (&w)[4], int H, int F) {
    Carve c{static_cast<char*>(base), 0};
    const int K[4] = {H, H, H, F}, N[4] = {3 * H, H, F, H};
    job.first[0] = 0;
    for (int i = 0; i < 4; ++i) {
      job.w[i] = w[i];
      job.K[i] = K[i];
      job.N[i] = N[i];
      job.hi[i] = c.take<float>((size_t)K[i] * N[i]);
      job.lo[i] = c.take<float>((size_t)K[i] * N[i]);
      job.first[i + 1] = job.first[i] + ceil_div(K[i], 32) * ceil_div(N[i], 32);
    }
    bytes = c.used;
  }
};

template <int HP>
cudaError_t launch_ln(const float* A, const float* whi, const float* wlo, int K,
                      const float* bias, const float* R, const float* g, const float* b,
                      float* Y, int M, int H, cudaStream_t st) {
  using LS = LnShape<HP>;
  cudaError_t err = allow_smem(ln_tf32_kernel<HP>, LS::kSmem);
  if (err != cudaSuccess) return err;
  ln_tf32_kernel<HP><<<ceil_div(M, LS::kRowsB), 256, LS::kSmem, st>>>(A, whi, wlo, K, bias,
                                                                     R, g, b, Y, M, H);
  return cudaGetLastError();
}

cudaError_t ln_tf32(const float* A, const float* whi, const float* wlo, int K,
                    const float* bias, const float* R, const float* g, const float* b,
                    float* Y, int M, int H, cudaStream_t st) {
  if (H <= 64) return launch_ln<64>(A, whi, wlo, K, bias, R, g, b, Y, M, H, st);
  if (H <= 128) return launch_ln<128>(A, whi, wlo, K, bias, R, g, b, Y, M, H, st);
  return launch_ln<256>(A, whi, wlo, K, bias, R, g, b, Y, M, H, st);
}

template <int DP, bool kRel>
cudaError_t launch_attn(const float* qkv, const int32_t* mask, float* ctx, const float* rel,
                        int B, int S, int H, int N, int D, float scale, int causal,
                        cudaStream_t st) {
  using AS = AttnShape<DP>;
  cudaError_t err = allow_smem(attn_tf32_kernel<DP, kRel>, AS::kSmem);
  if (err != cudaSuccess) return err;
  attn_tf32_kernel<DP, kRel><<<dim3(ceil_div(S, 64), N, B), 128, AS::kSmem, st>>>(
      qkv, mask, ctx, rel, S, H, N, D, scale, causal);
  return cudaGetLastError();
}

template <bool kRel>
cudaError_t attn_tf32(const float* qkv, const int32_t* mask, float* ctx, const float* rel,
                      int B, int S, int H, int N, int D, float scale, int causal,
                      cudaStream_t st) {
  if (D <= 32) return launch_attn<32, kRel>(qkv, mask, ctx, rel, B, S, H, N, D, scale, causal, st);
  return launch_attn<64, kRel>(qkv, mask, ctx, rel, B, S, H, N, D, scale, causal, st);
}

// pointer order (ops/fused_encoder_layer.py _TF32_PTRS)
enum Tf32Ptr {
  P_X, P_MASK, P_WQKV, P_BQKV, P_WO, P_BO, P_G1, P_B1LN, P_W1, P_BF1, P_W2, P_BF2, P_G2,
  P_B2LN, P_QKV, P_CTX, P_X1, P_HACT, P_Y, P_REL, P_WT, P_COUNT
};

}  // namespace

extern "C" {

// Limits the wrapper's route checks (ops/fused_encoder_layer.py kernel_route).
int b4r_fused_layer_tf32_max_hidden() { return 256; }
int b4r_fused_layer_tf32_max_head_dim() { return 64; }

// Bytes of the workspace a launch writes W^T's hi and lo into.
size_t b4r_fused_layer_tf32_workspace_bytes(int H, int F) {
  const float* const none[4] = {nullptr, nullptr, nullptr, nullptr};
  return Tf32Scratch(nullptr, none, H, F).bytes;
}

// The fp32 inference forward, 3xTF32. ptrs: _TF32_PTRS order, every one
// fp32 but the int32 mask; the weights as the layer holds them ([H, 3H],
// [H, H], [H, F], [F, H], contiguous); qkv [B S, 3H], ctx [B S, H], x1
// [B S, H], hact [B S, F] scratch; rel ([B, N, S, S]) null or the relative
// bias; wt the workspace (b4r_fused_layer_tf32_workspace_bytes); causal != 0
// adds the triangle. Launches on `stream`; returns the first CUDA error.
int b4r_fused_layer_fwd_tf32(void* const* p, int B, int S, int H, int N, int F,
                             int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S, D = H / N;
  if (H > 256 || D > 64 || H % 8 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  float* qkv = static_cast<float*>(p[P_QKV]);
  float* ctx = static_cast<float*>(p[P_CTX]);
  float* x1 = static_cast<float*>(p[P_X1]);
  float* hact = static_cast<float*>(p[P_HACT]);
  const int32_t* mask = static_cast<const int32_t*>(p[P_MASK]);
  const float* const w[4] = {f(P_WQKV), f(P_WO), f(P_W1), f(P_W2)};
  const Tf32Scratch wt(p[P_WT], w, H, F);
  const WtJob& j = wt.job;
  wt_split_kernel<<<j.first[4], 256, 0, st>>>(j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = gemm_tf32<false>(f(P_X), j.hi[0], j.lo[0], f(P_BQKV), qkv, M, H, 3 * H, st);
  if (err != cudaSuccess) return (int)err;
  err = p[P_REL] ? attn_tf32<true>(qkv, mask, ctx, f(P_REL), B, S, H, N, D, scale, causal, st)
                 : attn_tf32<false>(qkv, mask, ctx, nullptr, B, S, H, N, D, scale, causal, st);
  if (err != cudaSuccess) return (int)err;
  err = ln_tf32(ctx, j.hi[1], j.lo[1], H, f(P_BO), f(P_X), f(P_G1), f(P_B1LN), x1, M, H, st);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tf32<true>(x1, j.hi[2], j.lo[2], f(P_BF1), hact, M, H, F, st);
  if (err != cudaSuccess) return (int)err;
  return (int)ln_tf32(hact, j.hi[3], j.lo[3], F, f(P_BF2), x1, f(P_G2), f(P_B2LN),
                      static_cast<float*>(p[P_Y]), M, H, st);
}

}  // extern "C"
