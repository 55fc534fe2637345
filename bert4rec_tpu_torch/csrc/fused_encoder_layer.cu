// Fused post-LN transformer encoder layer, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of bert4rec_tpu/ops/fused_encoder_layer.py:
//   K1  _fwd_kernel (launched by _run_forward), with attention-probability
//       and output dropout, its causal variant (causal=True, SASRec) and its
//       relative-bias variant (K1'' rel_bias, the temporal family);
//   K2  _bwd_kernel / _bwd_element (launched by _run_backward), causal and
//       with rel_bias too, then also writing dRel (K2 dRel).
// The forward computes _layer_fwd_math step by step, with the same rounding
// points (T is float or bf16, every sum is fp32):
//
//   qkv  = T(x Wqkv + bqkv)
//   p    = softmax_fp32(q k^T / sqrt(D) + (mask > 0 ? 0 : -1e9)
//                       [+ (key > query ? -1e9 : 0) if causal]
//                       [+ rel[b, head] if rel_bias])                per head
//   ctx  = T(T(p * keep_h) v)
//   x1   = T(LN1(x + (ctx Wo + bo) * keep_N))
//   hact = T(gelu_tanh(x1 W1 + b1))
//   y    = T(LN2(x1 + (hact W2 + b2) * keep_N+1))
//
// keep_* are 1 / (1 - rate) or 0 from the counter hash of common.cuh, the
// same bits as the plain version's ops/dropout_bits.py; no mask is stored.
//
// Design. The TPU kernel holds one whole layer and one whole sequence in
// ~14 MB of VMEM per grid cell; an H100 block has at most 227 KB of shared
// memory, and one layer's fp32 weights alone are 786 KB at hidden 128. So
// the forward is five launches of three kernels, each owning tiles that fit:
//   gemm_kernel              qkv projection, and W1 with the tanh-gelu epilogue
//   attention_kernel         one block per (query tile, head, sequence); two
//                            passes over key tiles: the first finds each
//                            row's max and sum, the second forms the
//                            normalised probabilities, applies the dropout
//                            scale and rounds them to T as the TPU kernel
//                            does, and accumulates p v (attention.cuh: the
//                            port's one attention implementation, shared
//                            with flash attention's K8/K9; here q, k and v
//                            are column blocks of the packed qkv)
//   gemm_residual_ln_kernel  Wo and W2: a block owns whole rows, so bias,
//                            output dropout, residual and LayerNorm run in
//                            the epilogue
// In training the forward also writes what the backward reads: the
// normalised LayerNorm inputs xhat (fp32) with their 1/std per row, and each
// attention row's max and sum. The backward's values are then bitwise the
// ones a recomputation would give (the same tile code over the same inputs);
// saving them is a memory choice, not a change of function.
//
// The backward (K2) computes _bwd_element's function in eleven launches plus
// deterministic reductions: LN2 backward (a row kernel), the FFN (a dual
// GEMM that recomputes x1 W1 + b1 and applies the gelu derivative), LN1
// backward in the epilogue of the dx1 GEMM, the output projection, two
// attention kernels of attention.cuh (dq per query tile with the row sum
// sum_j dp_ij p_ij computed as JAX does, not flash attention's dO.O; dk/dv
// per key tile), and dx. The weight gradients reduce over all B*S rows:
// the TPU grid accumulates them sequentially; here every block writes a
// split-K partial and reduce_rows_kernel sums the partials in a fixed
// order, so two runs give the same bits (no float atomics).
//
// Causal (K1'' causal, SASRec). The same kernels with the triangle added to
// the scores inside tile_scores (no dense bias in memory), and the key
// tiles wholly after a query tile skipped (the dkv kernel skips the query
// tiles wholly before its key tile) where that is exact: see causal_skip.
// The saved row max and sum are the causal ones, so the backward
// recomputes the same probabilities; the dropout counters are unchanged.
//
// Relative bias (K1'' rel_bias, K2 dRel; the temporal family). rel is the
// encoder's fp32 [B, N, S, S] relative-time bias, built once per step and
// shared by every layer, as the TPU kernel streams it per cell. The
// attention kernels read it as a compile-time variant of attention.cuh's
// tiles (added after the pad and causal biases, before the softmax; the
// saved row statistics include it), and the backward's dq kernel writes
// dRel = p (dp - delta) in fp32 before rounding: the gradient the encoder
// chains onto its (bucket, head) table. At ml-20m_128 (B=256, S=200, N=4)
// rel and dRel are 164 MB each, against ~99 MFLOP per sequence: the bias
// adds bytes, not operations.
//
// Bound. ~99 MFLOP per sequence forward and ~198 backward at S=200, H=128,
// F=512 (causal: ~89 and ~178, the attention products over the lower
// triangle only): the layer is bound by operations, not bytes.
//
// Kernels, by operand type and shape (an explicit dispatch: the wrapper's
// shape law, ops/fused_encoder_layer.py kernel_route, picks the entry
// point; nothing is caught):
//   bf16, H, head dim and F multiples of 8 (every layer config the repo
//         trains or serves): layer_hopper.cuh, every product on wgmma with
//         bf16 tiles brought in by cp.async into the 128-byte swizzle and
//         the epilogues applied from the registers (b4r_fused_layer_fwd_wgmma
//         / _bwd_wgmma); the attention core is flash_hopper.cuh's three
//         kernels with the layer's switches (the relative bias, dRel, the
//         dbqkv column sums). With attention dropout the forward writes the
//         keep bits it draws and the backward reads them.
//   other bf16 shapes: the kernels below with mma.sync m16n8k16 tiles (fp32
//         sums) and attention.cuh's tiles.
//   fp32 with H <= 256, head dim <= 64, H, head dim and F multiples of 8
//         (inference and training, every variant): layer_tf32.cu's own entry
//         points, every product on wgmma in 3xTF32 (each operand split into
//         TF32 hi and lo, three tensor-core products for each fp32 one:
//         within a few fp32 ulps).
//   fp32 off that rule (wider shapes): the kernels below as SIMT FMA loops
//         and attention.cuh's SIMT tiles.
// bf16 products are exact in fp32, so the bf16 paths differ only in the
// order of their sums.
//
// Interface: C entry points taking an array of device pointers (order in
// ops/fused_encoder_layer.py), launching on the caller's stream; each
// returns the first non-zero cudaGetLastError() code.

#include "attention.cuh"
#include "common.cuh"
#include "layer_hopper.cuh"

namespace {

using namespace b4r;

// --------------------------------------------------------------------------
// C[M, N] = T(epilogue(A[M, K] W[K, N])): + bias, + bias then gelu, nothing,
// or + R32 (an fp32 [M, N] matrix).
// --------------------------------------------------------------------------
enum { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_NONE = 2, EPI_ADD_F32 = 3 };

template <typename T, int kEpi>
__global__ void __launch_bounds__(256)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W,
            const float* __restrict__ bias, const float* __restrict__ R32,
            T* __restrict__ C, int M, int N, int K) {
  __shared__ float As[GM_BK][GM_BM + GM_PAD];
  __shared__ float Bs[GM_BK][GM_BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * GM_BM, col0 = blockIdx.y * GM_BN;
  float acc[4][4];
  gemm_tile_nn(acc, A, W, M, N, K, row0, col0, As, Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float v = acc[i][j];
      if (kEpi == EPI_BIAS || kEpi == EPI_BIAS_GELU) v += bias[c];
      if (kEpi == EPI_BIAS_GELU) v = gelu_tanh(v);
      if (kEpi == EPI_ADD_F32) v = R32[(size_t)r * N + c] + v;
      C[(size_t)r * N + c] = from_f<T>(v);
    }
  }
}

template <typename T, int kEpi>
cudaError_t gemm(const T* A, const T* W, const float* bias, const float* R32, T* C,
                 int M, int N, int K, cudaStream_t stream) {
  gemm_kernel<T, kEpi><<<dim3(ceil_div(M, GM_BM), ceil_div(N, GM_BN)), 256, 0, stream>>>(
      A, W, bias, R32, C, M, N, K);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// Row-owning GEMM tile: acc = A[row0:+32, :K] W[:K, :H]. A block owns 32
// whole rows: warp w holds rows 4w..4w+3, lane l holds columns l, l+32, ...,
// l+32(TN-1) (H <= 32 TN), so row sums are warp shuffles.
// --------------------------------------------------------------------------
constexpr int LN_BM = 32, LN_BK = 16, LN_PAD = 4, LN_MAXTN = 16;

// bf16 operands run on the tensor cores: warp w computes rows
// 16 (w % 2) .. +15 and the 8-column blocks (w / 2) + 4 t, through
// shared memory back to the row-owning layout. The region at As then holds
// A [32][MMA_LD], B^T [Hp][MMA_LD] (bf16, Hp = H rounded up to 32) and the
// fp32 tile [32][H + 1]: ln_tile_floats(H) covers both layouts.
__host__ __device__ inline int ln_h_padded(int H) { return (H + 31) / 32 * 32; }

__host__ __device__ inline size_t ln_tile_floats(int H) {
  const size_t simt = (size_t)(LN_BK * (LN_BM + LN_PAD) + LN_BK * H);
  const size_t mma = (size_t)(LN_BM + ln_h_padded(H)) * MMA_LD / 2 +
                     (size_t)LN_BM * (H + 1);
  return simt > mma ? simt : mma;
}

template <typename T, int TN>
__device__ __forceinline__ void ln_gemm_tile(float acc[4][TN], const T* __restrict__ A,
                                             const T* __restrict__ W, int M, int H,
                                             int K, int row0, float* As, float* Bs) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if constexpr (kIsBf16<T>) {
    const int Hp = ln_h_padded(H);
    __nv_bfloat16* Ah = reinterpret_cast<__nv_bfloat16*>(As);
    __nv_bfloat16* Bh = Ah + LN_BM * MMA_LD;
    float* Cs = reinterpret_cast<float*>(Bh + (size_t)Hp * MMA_LD);
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    const int mb = (warp & 1) * 16, nb = (warp >> 1) * 8;
    float c[TN][4];
#pragma unroll
    for (int t = 0; t < TN; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[t][q] = 0.f;
    for (int k0 = 0; k0 < K; k0 += MMA_BK) {
      for (int l = tid; l < LN_BM * MMA_BK; l += 256) {
        const int r = l / MMA_BK, kk = l % MMA_BK;
        const int gr = row0 + r, gk = k0 + kk;
        Ah[r * MMA_LD + kk] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : zero;
      }
      for (int l = tid; l < MMA_BK * Hp; l += 256) {
        const int kk = l / Hp, n = l % Hp;
        const int gk = k0 + kk;
        Bh[n * MMA_LD + kk] = (gk < K && n < H) ? W[(size_t)gk * H + n] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < MMA_BK; kk += 16) {
        uint32_t a[4], b[2];
        load_a_frag(a, Ah, mb, kk);
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const int n0 = nb + 32 * t;
          if (n0 < Hp) {
            load_b_frag(b, Bh, n0, kk);
            mma_bf16(c[t], a, b);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < TN; ++t)
      if (nb + 32 * t < Hp) spill_frag(Cs, H + 1, c[t], mb, nb + 32 * t, H);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = lane + 32 * j;
        acc[i][j] = col < H ? Cs[(warp * 4 + i) * (H + 1) + col] : 0.f;
      }
    __syncthreads();
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += LN_BK) {
      for (int l = tid; l < LN_BM * LN_BK; l += 256) {
        const int r = l / LN_BK, c = l % LN_BK;
        const int gr = row0 + r, gc = k0 + c;
        As[c * (LN_BM + LN_PAD) + r] =
            (gr < M && gc < K) ? to_f(A[(size_t)gr * K + gc]) : 0.f;
      }
      for (int l = tid; l < LN_BK * H; l += 256) {
        const int r = l / H, c = l % H;
        const int gr = k0 + r;
        Bs[r * H + c] = (gr < K) ? to_f(W[(size_t)gr * H + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < LN_BK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk * (LN_BM + LN_PAD) + warp * 4 + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = lane + 32 * j;
          if (c < H) {
            const float b = Bs[kk * H + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }
}

// Y = T(LN(R + (A W + bias) * keep) * gamma + beta); in training also
// xhat (fp32 [M, H]) and rstd ([M]).
template <typename T, int TN>
__global__ void __launch_bounds__(256)
gemm_residual_ln_kernel(const T* __restrict__ A, const T* __restrict__ W,
                        const float* __restrict__ bias, const T* __restrict__ R,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        T* __restrict__ Y, float* __restrict__ xhat_out,
                        float* __restrict__ rstd_out, Drop drop, int site, int S,
                        int M, int H, int K) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + LN_BK * (LN_BM + LN_PAD);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * LN_BM;
  float acc[4][TN];
  ln_gemm_tile<T, TN>(acc, A, W, M, H, K, row0, As, Bs);

  const float inv_h = 1.0f / (float)H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + warp * 4 + i;  // the same for the whole warp
    if (r >= M) continue;
    const int elem = r / S, srow = r % S;
    const uint32_t sk = site_key(drop, elem, site);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = lane + 32 * j;
      if (c < H) {
        float v = acc[i][j] + bias[c];
        if (drop.on) v *= keep_scale_k(drop, sk, (uint32_t)(srow * H + c));
        const float u = to_f(R[(size_t)r * H + c]) + v;
        acc[i][j] = u;
        sum += u;
      }
    }
    const float mean = warp_sum(sum) * inv_h;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = lane + 32 * j;
      if (c < H) {
        const float d = acc[i][j] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_h + kLnEps);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = lane + 32 * j;
      if (c < H) {
        const float xh = (acc[i][j] - mean) * rstd;
        Y[(size_t)r * H + c] = from_f<T>(xh * gamma[c] + beta[c]);
        if (xhat_out) xhat_out[(size_t)r * H + c] = xh;
      }
    }
    if (rstd_out && lane == 0) rstd_out[r] = rstd;
  }
}

template <typename T, int TN>
cudaError_t launch_gemm_ln(const T* A, const T* W, const float* bias, const T* R,
                           const float* gamma, const float* beta, T* Y, float* xhat,
                           float* rstd, Drop drop, int site, int S, int M, int H,
                           int K, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ln_tile_floats(H);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_residual_ln_kernel<T, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gemm_residual_ln_kernel<T, TN><<<ceil_div(M, LN_BM), 256, smem, stream>>>(
      A, W, bias, R, gamma, beta, Y, xhat, rstd, drop, site, S, M, H, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gemm_ln(const T* A, const T* W, const float* bias, const T* R,
                    const float* gamma, const float* beta, T* Y, float* xhat,
                    float* rstd, Drop drop, int site, int S, int M, int H, int K,
                    cudaStream_t stream) {
#define B4R_LN(TNV) \
  launch_gemm_ln<T, TNV>(A, W, bias, R, gamma, beta, Y, xhat, rstd, drop, site, S, M, H, K, stream)
  switch (pow2_at_least(ceil_div(H, 32))) {
    case 1: return B4R_LN(1);
    case 2: return B4R_LN(2);
    case 4: return B4R_LN(4);
    case 8: return B4R_LN(8);
    case 16: return B4R_LN(16);
    default: return cudaErrorInvalidValue;
  }
#undef B4R_LN
}

// head view of one section (0 q, 1 k, 2 v) of the packed [B*S, 3H] qkv
template <typename P>
Heads<P> packed(P* qkv, int S, int H, int D, int section) {
  return {qkv + (size_t)section * H, (long long)S * 3 * H, D, 3 * H};
}

// forward pointer order (ops/fused_encoder_layer.py _FWD_PTRS)
enum FwdPtr {
  F_X, F_MASK, F_WQKV, F_BQKV, F_WO, F_BO, F_G1, F_B1LN, F_W1, F_BF1, F_W2, F_BF2,
  F_G2, F_B2LN, F_QKV, F_CTX, F_X1, F_HACT, F_Y, F_XHAT1, F_RSTD1, F_XHAT2,
  F_RSTD2, F_STAT_M, F_STAT_L, F_REL, F_BITS, F_COUNT
};

template <typename T>
int layer_forward(void* const* p, int B, int S, int H, int N, int F, int causal,
                  float scale, Drop attn_drop, Drop out_drop, cudaStream_t stream) {
  const T* x = static_cast<const T*>(p[F_X]);
  const int32_t* mask = static_cast<const int32_t*>(p[F_MASK]);
  T* qkv = static_cast<T*>(p[F_QKV]);
  T* ctx = static_cast<T*>(p[F_CTX]);
  T* x1 = static_cast<T*>(p[F_X1]);
  T* hact = static_cast<T*>(p[F_HACT]);
  auto f32 = [&](int i) { return static_cast<float*>(p[i]); };
  auto wt = [&](int i) { return static_cast<const T*>(p[i]); };
  const int M = B * S, D = H / N;
  cudaError_t err;

  // 1. qkv = T(x Wqkv + bqkv)
  if ((err = gemm<T, EPI_BIAS>(x, wt(F_WQKV), f32(F_BQKV), nullptr, qkv, M, 3 * H, H,
                               stream)) != cudaSuccess)
    return (int)err;
  // 2. ctx = T(T(softmax(q k^T * scale + mask bias [+ causal bias] [+ rel])
  //    * keep) v), per head
  const T* cqkv = qkv;
  const Heads<const T> hq = packed(cqkv, S, H, D, 0), hk = packed(cqkv, S, H, D, 1),
                       hv = packed(cqkv, S, H, D, 2);
  const Heads<T> hctx{ctx, (long long)S * H, D, H};
  const float* rel = static_cast<const float*>(p[F_REL]);
  err = rel ? attention<T, true>(hq, hk, hv, mask, hctx, f32(F_STAT_M), f32(F_STAT_L),
                                 attn_drop, B, S, N, D, scale, causal, stream, rel)
            : attention<T>(hq, hk, hv, mask, hctx, f32(F_STAT_M), f32(F_STAT_L),
                           attn_drop, B, S, N, D, scale, causal, stream);
  if (err != cudaSuccess) return (int)err;
  // 3. x1 = T(LN1(x + (ctx Wo + bo) * keep_N))
  if ((err = gemm_ln<T>(ctx, wt(F_WO), f32(F_BO), x, f32(F_G1), f32(F_B1LN), x1,
                        f32(F_XHAT1), f32(F_RSTD1), out_drop, N, S, M, H, H,
                        stream)) != cudaSuccess)
    return (int)err;
  // 4. hact = T(gelu_tanh(x1 W1 + b1))
  if ((err = gemm<T, EPI_BIAS_GELU>(x1, wt(F_W1), f32(F_BF1), nullptr, hact, M, F, H,
                                    stream)) != cudaSuccess)
    return (int)err;
  // 5. y = T(LN2(x1 + (hact W2 + b2) * keep_N+1))
  if ((err = gemm_ln<T>(hact, wt(F_W2), f32(F_BF2), x1, f32(F_G2), f32(F_B2LN),
                        static_cast<T*>(p[F_Y]), f32(F_XHAT2), f32(F_RSTD2), out_drop,
                        N + 1, S, M, H, F, stream)) != cudaSuccess)
    return (int)err;
  return 0;
}

// ==========================================================================
// backward (K2)
// ==========================================================================

// LayerNorm backward over row-owned tiles. gin = dy (kGemm false) or
// R32 + A Wt (kGemm true, the dx1 GEMM). Per row:
//   dout = rstd * (gin g - mean(gin g) - xhat mean(gin g xhat))   (fp32)
//   dmask = dout * keep(site)                                     (-> T)
// and per-block column partials of sum(gin xhat), sum(gin), sum(dmask),
// laid out part[block][3 H].
template <typename T, int TN, bool kGemm>
__global__ void __launch_bounds__(256)
ln_bwd_kernel(const T* __restrict__ A, const T* __restrict__ Wt, int K,
              const T* __restrict__ dy, const float* __restrict__ R32,
              const float* __restrict__ xhat, const float* __restrict__ rstd,
              const float* __restrict__ gamma, Drop drop, int site, int S,
              float* __restrict__ dout32, T* __restrict__ dmask,
              float* __restrict__ part, int M, int H) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * LN_BM;
  float acc[4][TN];
  if (kGemm) {
    ln_gemm_tile<T, TN>(acc, A, Wt, M, H, K, row0, smem,
                        smem + LN_BK * (LN_BM + LN_PAD));
  }
  float* red = smem + (kGemm ? ln_tile_floats(H) : 0);  // [8 warps][3 H]
  float p0[TN], p1[TN], p2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) p0[j] = p1[j] = p2[j] = 0.f;
  const float inv_h = 1.0f / (float)H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + warp * 4 + i;  // the same for the whole warp
    if (r >= M) continue;
    const int elem = r / S, srow = r % S;
    const uint32_t sk = site_key(drop, elem, site);
    float g[TN], xh[TN];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = lane + 32 * j;
      g[j] = xh[j] = 0.f;
      if (c < H) {
        const size_t at = (size_t)r * H + c;
        g[j] = kGemm ? R32[at] + acc[i][j] : to_f(dy[at]);
        xh[j] = xhat[at];
        p0[j] += g[j] * xh[j];
        p1[j] += g[j];
        const float dxh = g[j] * gamma[c];
        s1 += dxh;
        s2 += dxh * xh[j];
      }
    }
    const float mean1 = warp_sum(s1) * inv_h, mean2 = warp_sum(s2) * inv_h;
    const float rs = rstd[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = lane + 32 * j;
      if (c < H) {
        const size_t at = (size_t)r * H + c;
        const float d = rs * (g[j] * gamma[c] - mean1 - xh[j] * mean2);
        dout32[at] = d;
        const float dm =
            drop.on ? d * keep_scale_k(drop, sk, (uint32_t)(srow * H + c)) : d;
        dmask[at] = from_f<T>(dm);
        p2[j] += dm;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = lane + 32 * j;
    if (c < H) {
      red[warp * 3 * H + c] = p0[j];
      red[warp * 3 * H + H + c] = p1[j];
      red[warp * 3 * H + 2 * H + c] = p2[j];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 3 * H; idx += 256) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w * 3 * H + idx];
    part[(size_t)blockIdx.x * 3 * H + idx] = s;
  }
}

template <typename T, int TN, bool kGemm>
cudaError_t launch_ln_bwd(const T* A, const T* Wt, int K, const T* dy, const float* R32,
                          const float* xhat, const float* rstd, const float* gamma,
                          Drop drop, int site, int S, float* dout32, T* dmask,
                          float* part, int M, int H, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kGemm ? ln_tile_floats(H) : 0) + (size_t)8 * 3 * H);
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel<T, TN, kGemm>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<T, TN, kGemm><<<ceil_div(M, LN_BM), 256, smem, stream>>>(
      A, Wt, K, dy, R32, xhat, rstd, gamma, drop, site, S, dout32, dmask, part, M, H);
  return cudaGetLastError();
}

template <typename T, bool kGemm>
cudaError_t ln_bwd(const T* A, const T* Wt, int K, const T* dy, const float* R32,
                   const float* xhat, const float* rstd, const float* gamma, Drop drop,
                   int site, int S, float* dout32, T* dmask, float* part, int M, int H,
                   cudaStream_t stream) {
#define B4R_LNB(TNV)                                                                  \
  launch_ln_bwd<T, TNV, kGemm>(A, Wt, K, dy, R32, xhat, rstd, gamma, drop, site, S, \
                               dout32, dmask, part, M, H, stream)
  switch (pow2_at_least(ceil_div(H, 32))) {
    case 1: return B4R_LNB(1);
    case 2: return B4R_LNB(2);
    case 4: return B4R_LNB(4);
    case 8: return B4R_LNB(8);
    case 16: return B4R_LNB(16);
    default: return cudaErrorInvalidValue;
  }
#undef B4R_LNB
}

// dHpre[M, F] = T((dF W2t)[r, c] * gelu'((X1 W1)[r, c] + bf1[c])): the FFN's
// dhact and its gelu derivative in one pass, recomputing hpre with the
// forward's own tile code; part[block row][F] holds the fp32 column sums
// (dbf1's split partials).
template <typename T>
__global__ void __launch_bounds__(256)
gelu_grad_gemm_kernel(const T* __restrict__ dF, const T* __restrict__ W2t,
                      const T* __restrict__ X1, const T* __restrict__ W1,
                      const float* __restrict__ bf1, T* __restrict__ dHpre,
                      float* __restrict__ part, int M, int F, int H) {
  __shared__ float As[GM_BK][GM_BM + GM_PAD];
  __shared__ float Bs[GM_BK][GM_BN];
  __shared__ float red[16][GM_BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * GM_BM, col0 = blockIdx.y * GM_BN;
  float a1[4][4], a2[4][4];
  gemm_tile_nn(a1, dF, W2t, M, F, H, row0, col0, As, Bs);
  gemm_tile_nn(a2, X1, W1, M, F, H, row0, col0, As, Bs);
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= F) continue;
      const float v = a1[i][j] * gelu_tanh_grad(a2[i][j] + bf1[c]);
      dHpre[(size_t)r * F + c] = from_f<T>(v);
      colsum[j] += v;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx + 16 * j] = colsum[j];
  __syncthreads();
  if (tid < GM_BN && col0 + tid < F) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[t][tid];
    part[(size_t)blockIdx.x * F + col0 + tid] = s;
  }
}

// Weight-gradient split-K partials: part[s][K1][N] = sum over rows m of
// chunk s of A[m, k] B[m, n] (A [M, K1], B [M, N], row-major in T).
template <typename T>
__global__ void __launch_bounds__(256)
wgrad_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ part,
             int M, int K1, int N, int chunk) {
  __shared__ float As[GM_BK][GM_BM + GM_PAD];  // [m][k]
  __shared__ float Bs[GM_BK][GM_BN];           // [m][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * GM_BM, n0 = blockIdx.y * GM_BN, split = blockIdx.z;
  const int m_begin = split * chunk, m_end = min(M, m_begin + chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if constexpr (kIsBf16<T>) {
    // tensor cores: A^T [k][m] and B^T [n][m] tiles, the rows m the
    // contraction; warp w computes k rows 16 (w % 4) .. +15, n columns
    // 32 (w / 4) .. +31
    __shared__ __align__(16) __nv_bfloat16 Ah[GM_BM * MMA_LD];
    __shared__ __align__(16) __nv_bfloat16 Bh[GM_BN * MMA_LD];
    __shared__ float Cs[GM_BM * (GM_BN + 1)];
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    const int warp = tid / 32, mb = (warp & 3) * 16, nb = (warp >> 2) * 32;
    float c[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[t][q] = 0.f;
    for (int m0 = m_begin; m0 < m_end; m0 += MMA_BK) {
      for (int l = tid; l < MMA_BK * GM_BM; l += 256) {
        const int mm = l / GM_BM, kk = l % GM_BM;
        const int m = m0 + mm, k = k0 + kk;
        Ah[kk * MMA_LD + mm] = (m < m_end && k < K1) ? A[(size_t)m * K1 + k] : zero;
      }
      for (int l = tid; l < MMA_BK * GM_BN; l += 256) {
        const int mm = l / GM_BN, nn = l % GM_BN;
        const int m = m0 + mm, n = n0 + nn;
        Bh[nn * MMA_LD + mm] = (m < m_end && n < N) ? B[(size_t)m * N + n] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < MMA_BK; kk += 16) {
        uint32_t a[4], b[2];
        load_a_frag(a, Ah, mb, kk);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          load_b_frag(b, Bh, nb + 8 * t, kk);
          mma_bf16(c[t], a, b);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) spill_frag(Cs, GM_BN + 1, c[t], mb, nb + 8 * t, GM_BN);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = Cs[(ty + 16 * i) * (GM_BN + 1) + tx + 16 * j];
  } else {
    for (int m0 = m_begin; m0 < m_end; m0 += GM_BK) {
      for (int l = tid; l < GM_BK * GM_BM; l += 256) {
        const int mm = l / GM_BM, kk = l % GM_BM;
        const int m = m0 + mm, k = k0 + kk;
        As[mm][kk] = (m < m_end && k < K1) ? to_f(A[(size_t)m * K1 + k]) : 0.f;
      }
      for (int l = tid; l < GM_BK * GM_BN; l += 256) {
        const int mm = l / GM_BN, nn = l % GM_BN;
        const int m = m0 + mm, n = n0 + nn;
        Bs[mm][nn] = (m < m_end && n < N) ? to_f(B[(size_t)m * N + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int mm = 0; mm < GM_BK; ++mm) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[mm][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[mm][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) part[((size_t)split * K1 + k) * N + n] = acc[i][j];
    }
  }
}

constexpr int WG_CHUNK = 512;  // rows per split-K partial
inline int wgrad_splits(int M) { return ceil_div(M, WG_CHUNK); }

// dW[K1, N] = A^T B, reduced over the M rows in two deterministic passes
template <typename T>
cudaError_t wgrad(const T* A, const T* B, float* scratch, float* dW, int M, int K1,
                  int N, cudaStream_t stream) {
  const int splits = wgrad_splits(M);
  wgrad_kernel<T><<<dim3(ceil_div(K1, GM_BM), ceil_div(N, GM_BN), splits), 256, 0,
                    stream>>>(A, B, scratch, M, K1, N, WG_CHUNK);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_rows(scratch, dW, splits, K1 * N, stream);
}

// backward pointer order (ops/fused_encoder_layer.py _BWD_PTRS)
enum BwdPtr {
  B_X, B_MASK, B_DY, B_WQKV_T, B_WO_T, B_W1, B_W1_T, B_W2_T, B_BF1, B_G1, B_G2,
  B_QKV, B_CTX, B_X1, B_HACT, B_XHAT1, B_RSTD1, B_XHAT2, B_RSTD2, B_STAT_M,
  B_STAT_L, B_DX, B_DWQKV, B_DBQKV, B_DWO, B_GLN1, B_DW1, B_DBF1, B_DW2, B_GLN2,
  B_WORKSPACE, B_REL, B_DREL, B_BITS, B_COUNT
};

// Carves the backward's scratch from one workspace; with base == nullptr
// it only counts the bytes.
template <typename T>
struct BwdScratch {
  float *dw_res, *du, *delta, *part_ln2, *part_ln1, *part_bf1, *part_qkv, *wsplit;
  T *df, *dhpre, *dattn, *dctx, *dqkv;
  size_t bytes;
  BwdScratch(void* base, int B, int S, int H, int N, int F) {
    const size_t M = (size_t)B * S;
    const int nb_ln = ceil_div(M, LN_BM), nb_gm = ceil_div(M, GM_BM);
    const size_t wmax = (size_t)(H * F > 3 * H * H ? H * F : 3 * H * H);
    Carve c{static_cast<char*>(base), 0};
    dw_res = c.take<float>(M * H);
    du = c.take<float>(M * H);
    delta = c.take<float>((size_t)B * N * S);
    part_ln2 = c.take<float>((size_t)nb_ln * 3 * H);
    part_ln1 = c.take<float>((size_t)nb_ln * 3 * H);
    part_bf1 = c.take<float>((size_t)nb_gm * F);
    part_qkv = c.take<float>((size_t)B * ceil_div(S, AT_BQ) * 3 * H);
    wsplit = c.take<float>((size_t)wgrad_splits((int)M) * wmax);
    df = c.take<T>(M * H);
    dhpre = c.take<T>(M * F);
    dattn = c.take<T>(M * H);
    dctx = c.take<T>(M * H);
    dqkv = c.take<T>(M * 3 * H);
    bytes = c.used;
  }
};

template <typename T>
int layer_backward(void* const* p, int B, int S, int H, int N, int F, int causal,
                   float scale, Drop attn_drop, Drop out_drop, cudaStream_t stream) {
  auto f32 = [&](int i) { return static_cast<float*>(p[i]); };
  auto wt = [&](int i) { return static_cast<const T*>(p[i]); };
  const int32_t* mask = static_cast<const int32_t*>(p[B_MASK]);
  const int M = B * S, D = H / N;
  const int nb_ln = ceil_div(M, LN_BM), nb_gm = ceil_div(M, GM_BM);
  BwdScratch<T> w(p[B_WORKSPACE], B, S, H, N, F);
  cudaError_t err;
#define B4R_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err

  // 1. LN2: dw_res = LN2'(dy), df = T(dw_res * keep_N+1); dg2, db2, dbf2
  B4R_TRY((ln_bwd<T, false>(nullptr, nullptr, 0, wt(B_DY), nullptr, f32(B_XHAT2),
                            f32(B_RSTD2), f32(B_G2), out_drop, N + 1, S, w.dw_res, w.df,
                            w.part_ln2, M, H, stream)));
  B4R_TRY(reduce_rows(w.part_ln2, f32(B_GLN2), nb_ln, 3 * H, stream));
  // 2. dW2 = hact^T df
  B4R_TRY(wgrad<T>(wt(B_HACT), w.df, w.wsplit, f32(B_DW2), M, F, H, stream));
  // 3. dhpre = T((df W2^T) * gelu'(x1 W1 + b1)); dbf1
  gelu_grad_gemm_kernel<T><<<dim3(nb_gm, ceil_div(F, GM_BN)), 256, 0, stream>>>(
      w.df, wt(B_W2_T), wt(B_X1), wt(B_W1), f32(B_BF1), w.dhpre, w.part_bf1, M, F, H);
  B4R_TRY(cudaGetLastError());
  B4R_TRY(reduce_rows(w.part_bf1, f32(B_DBF1), nb_gm, F, stream));
  // 4. dW1 = x1^T dhpre
  B4R_TRY(wgrad<T>(wt(B_X1), w.dhpre, w.wsplit, f32(B_DW1), M, H, F, stream));
  // 5. LN1: dx1 = dw_res + dhpre W1^T; du = LN1'(dx1), dattn = T(du * keep_N);
  //    dg1, db1, dbo
  B4R_TRY((ln_bwd<T, true>(w.dhpre, wt(B_W1_T), F, nullptr, w.dw_res, f32(B_XHAT1),
                           f32(B_RSTD1), f32(B_G1), out_drop, N, S, w.du, w.dattn,
                           w.part_ln1, M, H, stream)));
  B4R_TRY(reduce_rows(w.part_ln1, f32(B_GLN1), nb_ln, 3 * H, stream));
  // 6. dWo = ctx^T dattn
  B4R_TRY(wgrad<T>(wt(B_CTX), w.dattn, w.wsplit, f32(B_DWO), M, H, H, stream));
  // 7. dctx = T(dattn Wo^T)
  B4R_TRY((gemm<T, EPI_NONE>(w.dattn, wt(B_WO_T), nullptr, nullptr, w.dctx, M, H, H,
                             stream)));
  // 8. attention: dq, dk, dv -> dqkv; dbqkv; with rel, dRel
  const T* qkv = wt(B_QKV);
  const Heads<const T> hq = packed(qkv, S, H, D, 0), hk = packed(qkv, S, H, D, 1),
                       hv = packed(qkv, S, H, D, 2),
                       hdo{w.dctx, (long long)S * H, D, H};
  const Heads<T> hdq = packed(w.dqkv, S, H, D, 0), hdk = packed(w.dqkv, S, H, D, 1),
                 hdv = packed(w.dqkv, S, H, D, 2);
  const float* rel = static_cast<const float*>(p[B_REL]);
  B4R_TRY((rel ? attn_bwd<T, true>(hq, hk, hv, hdo, mask, f32(B_STAT_M), f32(B_STAT_L),
                                    attn_drop, w.delta, hdq, hdk, hdv, w.part_qkv, B, S,
                                    N, D, scale, causal, stream, rel, f32(B_DREL))
               : attn_bwd<T>(hq, hk, hv, hdo, mask, f32(B_STAT_M), f32(B_STAT_L),
                             attn_drop, w.delta, hdq, hdk, hdv, w.part_qkv, B, S, N, D,
                             scale, causal, stream)));
  B4R_TRY(reduce_rows(w.part_qkv, f32(B_DBQKV), B * ceil_div(S, AT_BQ), 3 * H, stream));
  // 9. dWqkv = x^T dqkv
  B4R_TRY(wgrad<T>(wt(B_X), w.dqkv, w.wsplit, f32(B_DWQKV), M, H, 3 * H, stream));
  // 10. dx = T(du + dqkv Wqkv^T)
  B4R_TRY((gemm<T, EPI_ADD_F32>(w.dqkv, wt(B_WQKV_T), nullptr, w.du,
                                static_cast<T*>(p[B_DX]), M, H, 3 * H, stream)));
#undef B4R_TRY
  return 0;
}

// ==========================================================================
// bf16 on Hopper's warpgroup kernels (layer_hopper.cuh): the same steps, the
// same rounding points, the same dropout sites and counters. The attention
// core is flash_hopper.cuh's; with attention dropout the forward writes the
// keep bits it draws ([B, N, T, T, 128] 32-bit words, T = ceil(S / 64)) and
// the backward reads them.
// ==========================================================================
using bf16 = __nv_bfloat16;
namespace lh = layer_hopper;

int layer_forward_wgmma(void* const* p, int B, int S, int H, int N, int F, int causal,
                        float scale, Drop attn_drop, Drop out_drop, cudaStream_t stream) {
  const bf16* x = static_cast<const bf16*>(p[F_X]);
  bf16* qkv = static_cast<bf16*>(p[F_QKV]);
  bf16* ctx = static_cast<bf16*>(p[F_CTX]);
  bf16* x1 = static_cast<bf16*>(p[F_X1]);
  bf16* hact = static_cast<bf16*>(p[F_HACT]);
  auto f32 = [&](int i) { return static_cast<float*>(p[i]); };
  auto wt = [&](int i) { return static_cast<const bf16*>(p[i]); };
  const int M = B * S, D = H / N;
  cudaError_t err;
#define B4R_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err
  // 1. qkv = T(x Wqkv + bqkv)
  B4R_TRY(lh::gemm(x, wt(F_WQKV), f32(F_BQKV), nullptr, qkv, M, H, 3 * H, lh::kEpiBias,
                   stream));
  // 2. ctx = T(T(softmax(q k^T * scale + biases [+ rel]) * keep) v), per head
  const bf16* cqkv = qkv;
  const Heads<const bf16> hq = packed(cqkv, S, H, D, 0), hk = packed(cqkv, S, H, D, 1),
                          hv = packed(cqkv, S, H, D, 2);
  const Heads<bf16> hctx{ctx, (long long)S * H, D, H};
  const float* rel = static_cast<const float*>(p[F_REL]);
  uint32_t* bits = attn_drop.on ? static_cast<uint32_t*>(p[F_BITS]) : nullptr;
  B4R_TRY((rel ? lh::attention_fwd<true>(hq, hk, hv, static_cast<const int32_t*>(p[F_MASK]),
                                         hctx, f32(F_STAT_M), f32(F_STAT_L), bits, attn_drop,
                                         B, S, N, D, scale, causal, rel, stream)
               : lh::attention_fwd<false>(hq, hk, hv, static_cast<const int32_t*>(p[F_MASK]),
                                          hctx, f32(F_STAT_M), f32(F_STAT_L), bits, attn_drop,
                                          B, S, N, D, scale, causal, nullptr, stream)));
  // 3. x1 = T(LN1(x + (ctx Wo + bo) * keep_N))
  B4R_TRY(lh::ln_fwd(ctx, wt(F_WO), H, f32(F_BO), x, f32(F_G1), f32(F_B1LN), x1,
                     f32(F_XHAT1), f32(F_RSTD1), out_drop, N, S, M, H, stream));
  // 4. hact = T(gelu_tanh(x1 W1 + b1))
  B4R_TRY(lh::gemm(x1, wt(F_W1), f32(F_BF1), nullptr, hact, M, H, F, lh::kEpiBiasGelu,
                   stream));
  // 5. y = T(LN2(x1 + (hact W2 + b2) * keep_N+1))
  B4R_TRY(lh::ln_fwd(hact, wt(F_W2), F, f32(F_BF2), x1, f32(F_G2), f32(F_B2LN),
                     static_cast<bf16*>(p[F_Y]), f32(F_XHAT2), f32(F_RSTD2), out_drop, N + 1,
                     S, M, H, stream));
#undef B4R_TRY
  return 0;
}

// The wgmma backward's scratch, carved from one workspace (base == nullptr
// only counts the bytes).
struct WgmmaScratch {
  float *dw_res, *du, *delta, *part_ln2, *part_ln1, *part_bf1, *part_qkv, *wsplit;
  bf16 *df, *dhpre, *dattn, *dctx, *dqkv;
  size_t bytes;
  WgmmaScratch(void* base, int B, int S, int H, int N, int F) {
    const int M = B * S;
    size_t wmax = lh::wgrad_scratch(M, F, H);
    wmax = std::max(wmax, lh::wgrad_scratch(M, H, F));
    wmax = std::max(wmax, lh::wgrad_scratch(M, H, H));
    wmax = std::max(wmax, lh::wgrad_scratch(M, H, 3 * H));
    Carve c{static_cast<char*>(base), 0};
    dw_res = c.take<float>((size_t)M * H);
    du = c.take<float>((size_t)M * H);
    delta = c.take<float>((size_t)B * N * S);
    part_ln2 = c.take<float>((size_t)lh::ln_rows_blocks(M) * 3 * H);
    part_ln1 = c.take<float>((size_t)lh::ln_blocks(M, H) * 3 * H);
    part_bf1 = c.take<float>((size_t)lh::gelu_grad_blocks(M) * F);
    part_qkv = c.take<float>((size_t)B * ceil_div(S, hopper::kRows) * 3 * H);
    wsplit = c.take<float>(std::max(wmax, (size_t)1));
    df = c.take<bf16>((size_t)M * H);
    dhpre = c.take<bf16>((size_t)M * F);
    dattn = c.take<bf16>((size_t)M * H);
    dctx = c.take<bf16>((size_t)M * H);
    dqkv = c.take<bf16>((size_t)M * 3 * H);
    bytes = c.used;
  }
};

int layer_backward_wgmma(void* const* p, int B, int S, int H, int N, int F, int causal,
                         float scale, Drop attn_drop, Drop out_drop, cudaStream_t stream) {
  auto f32 = [&](int i) { return static_cast<float*>(p[i]); };
  auto wt = [&](int i) { return static_cast<const bf16*>(p[i]); };
  const int32_t* mask = static_cast<const int32_t*>(p[B_MASK]);
  const int M = B * S, D = H / N;
  WgmmaScratch w(p[B_WORKSPACE], B, S, H, N, F);
  const uint32_t* bits = static_cast<const uint32_t*>(p[B_BITS]);
  if (attn_drop.on && !bits) return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define B4R_TRY(call) \
  if ((err = (call)) != cudaSuccess) return (int)err

  // 1. LN2: dw_res = LN2'(dy), df = T(dw_res * keep_N+1); dg2, db2, dbf2
  B4R_TRY(lh::ln_rows_bwd(wt(B_DY), f32(B_XHAT2), f32(B_RSTD2), f32(B_G2), out_drop, N + 1,
                          S, w.dw_res, w.df, w.part_ln2, M, H, stream));
  B4R_TRY(lh::sum_rows(w.part_ln2, f32(B_GLN2), lh::ln_rows_blocks(M), 3 * H, stream));
  // 2. dW2 = hact^T df
  B4R_TRY(lh::wgrad(wt(B_HACT), w.df, w.wsplit, f32(B_DW2), M, F, H, stream));
  // 3. dhpre = T((df W2^T) * gelu'(x1 W1 + b1)); dbf1
  B4R_TRY(lh::gelu_grad(w.df, wt(B_W2_T), wt(B_X1), wt(B_W1), f32(B_BF1), w.dhpre,
                        w.part_bf1, M, F, H, stream));
  B4R_TRY(lh::sum_rows(w.part_bf1, f32(B_DBF1), lh::gelu_grad_blocks(M), F, stream));
  // 4. dW1 = x1^T dhpre
  B4R_TRY(lh::wgrad(wt(B_X1), w.dhpre, w.wsplit, f32(B_DW1), M, H, F, stream));
  // 5. LN1: dx1 = dw_res + dhpre W1^T; du = LN1'(dx1), dattn = T(du * keep_N);
  //    dg1, db1, dbo
  B4R_TRY(lh::ln_bwd(w.dhpre, wt(B_W1_T), F, w.dw_res, f32(B_XHAT1), f32(B_RSTD1), f32(B_G1),
                     out_drop, N, S, w.du, w.dattn, w.part_ln1, M, H, stream));
  B4R_TRY(lh::sum_rows(w.part_ln1, f32(B_GLN1), lh::ln_blocks(M, H), 3 * H, stream));
  // 6. dWo = ctx^T dattn
  B4R_TRY(lh::wgrad(wt(B_CTX), w.dattn, w.wsplit, f32(B_DWO), M, H, H, stream));
  // 7. dctx = T(dattn Wo^T)
  B4R_TRY(lh::gemm(w.dattn, wt(B_WO_T), nullptr, nullptr, w.dctx, M, H, H, lh::kEpiNone,
                   stream));
  // 8. attention: dq, dk, dv -> dqkv; dbqkv; with rel, dRel
  const bf16* qkv = wt(B_QKV);
  const Heads<const bf16> hq = packed(qkv, S, H, D, 0), hk = packed(qkv, S, H, D, 1),
                          hv = packed(qkv, S, H, D, 2),
                          hdo{w.dctx, (long long)S * H, D, H};
  const Heads<bf16> hdq = packed(w.dqkv, S, H, D, 0), hdk = packed(w.dqkv, S, H, D, 1),
                    hdv = packed(w.dqkv, S, H, D, 2);
  const float* rel = static_cast<const float*>(p[B_REL]);
  B4R_TRY((rel ? lh::attention_bwd<true>(hq, hk, hv, hdo, mask, f32(B_STAT_M), f32(B_STAT_L),
                                         bits, attn_drop, w.delta, hdq, hdk, hdv, w.part_qkv,
                                         B, S, N, D, scale, causal, rel, f32(B_DREL), stream)
               : lh::attention_bwd<false>(hq, hk, hv, hdo, mask, f32(B_STAT_M),
                                          f32(B_STAT_L), bits, attn_drop, w.delta, hdq, hdk,
                                          hdv, w.part_qkv, B, S, N, D, scale, causal, nullptr,
                                          nullptr, stream)));
  B4R_TRY(lh::sum_rows(w.part_qkv, f32(B_DBQKV), B * ceil_div(S, hopper::kRows), 3 * H,
                      stream));
  // 9. dWqkv = x^T dqkv
  B4R_TRY(lh::wgrad(wt(B_X), w.dqkv, w.wsplit, f32(B_DWQKV), M, H, 3 * H, stream));
  // 10. dx = T(du + dqkv Wqkv^T)
  B4R_TRY(lh::gemm(w.dqkv, wt(B_WQKV_T), nullptr, w.du, static_cast<bf16*>(p[B_DX]), M,
                   3 * H, H, lh::kEpiAddF32, stream));
#undef B4R_TRY
  return 0;
}

}  // namespace

extern "C" {

// bf16 on the warpgroup kernels (ops/fused_encoder_layer.py kernel_route
// sends a launch here): the same pointer orders and arguments as
// b4r_fused_layer_fwd / _bwd, dtype 1 only; ptrs[keep_bits] ([B, N, T, T,
// 128] 32-bit words, T = ceil(S / 64)) receives the forward's attention
// keep bits when the attention dropout is on and is read by the backward.
int b4r_fused_layer_fwd_wgmma(int dtype, void* const* ptrs, int B, int S, int H, int N,
                              int F, int causal, float scale, unsigned seed,
                              unsigned attn_threshold, float attn_scale, int attn_on,
                              unsigned out_threshold, float out_scale, int out_on,
                              void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const Drop ad{seed, attn_threshold, attn_scale, attn_on};
  const Drop od{seed, out_threshold, out_scale, out_on};
  return layer_forward_wgmma(ptrs, B, S, H, N, F, causal, scale, ad, od,
                             static_cast<cudaStream_t>(stream));
}

int b4r_fused_layer_bwd_wgmma(int dtype, void* const* ptrs, int B, int S, int H, int N,
                              int F, int causal, float scale, unsigned seed,
                              unsigned attn_threshold, float attn_scale, int attn_on,
                              unsigned out_threshold, float out_scale, int out_on,
                              void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const Drop ad{seed, attn_threshold, attn_scale, attn_on};
  const Drop od{seed, out_threshold, out_scale, out_on};
  return layer_backward_wgmma(ptrs, B, S, H, N, F, causal, scale, ad, od,
                              static_cast<cudaStream_t>(stream));
}

size_t b4r_fused_layer_bwd_wgmma_workspace_bytes(int B, int S, int H, int N, int F) {
  return WgmmaScratch(nullptr, B, S, H, N, F).bytes;
}

// Limits the wrapper checks before calling (ops/fused_encoder_layer.py).
int b4r_fused_layer_max_hidden() { return 32 * LN_MAXTN; }
int b4r_fused_layer_max_head_dim() { return AT_MAXD; }

// Bytes of the workspace b4r_fused_layer_bwd carves its scratch from.
size_t b4r_fused_layer_bwd_workspace_bytes(int dtype, int B, int S, int H, int N, int F) {
  if (dtype == 1) return BwdScratch<__nv_bfloat16>(nullptr, B, S, H, N, F).bytes;
  return BwdScratch<float>(nullptr, B, S, H, N, F).bytes;
}

// dtype: 0 = float32, 1 = bfloat16 for x, the weight matrices, the saved
// activations and y; biases, LayerNorm params, statistics and gradients of
// the weights are always float32. ptrs: _FWD_PTRS order; the six training
// outputs (xhat1 .. stat_l) may be null at inference. causal != 0 adds the
// TPU kernel's causal bias (K1'' causal); a non-null rel ([B, N, S, S]
// float32) adds the relative bias (K1'' rel_bias). A rate of 0 is
// `*_on == 0`.
int b4r_fused_layer_fwd(int dtype, void* const* ptrs, int B, int S, int H, int N,
                        int F, int causal, float scale, unsigned seed,
                        unsigned attn_threshold, float attn_scale, int attn_on,
                        unsigned out_threshold, float out_scale, int out_on,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop ad{seed, attn_threshold, attn_scale, attn_on};
  const Drop od{seed, out_threshold, out_scale, out_on};
  if (dtype == 0)
    return layer_forward<float>(ptrs, B, S, H, N, F, causal, scale, ad, od, st);
  if (dtype == 1)
    return layer_forward<__nv_bfloat16>(ptrs, B, S, H, N, F, causal, scale, ad, od, st);
  return (int)cudaErrorInvalidValue;
}

// ptrs: _BWD_PTRS order. Gradients: dx in dtype; dwqkv [H, 3H], dbqkv [3H],
// dwo [H, H], gln1 [3, H] = (dg1, db1, dbo), dw1 [H, F], dbf1 [F],
// dw2 [F, H], gln2 [3, H] = (dg2, db2, dbf2), all float32. causal and rel
// must be the forward's (its saved row statistics are of those scores);
// with rel, drel ([B, N, S, S] float32) receives dRel (K2 dRel).
int b4r_fused_layer_bwd(int dtype, void* const* ptrs, int B, int S, int H, int N,
                        int F, int causal, float scale, unsigned seed,
                        unsigned attn_threshold, float attn_scale, int attn_on,
                        unsigned out_threshold, float out_scale, int out_on,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop ad{seed, attn_threshold, attn_scale, attn_on};
  const Drop od{seed, out_threshold, out_scale, out_on};
  if (dtype == 0)
    return layer_backward<float>(ptrs, B, S, H, N, F, causal, scale, ad, od, st);
  if (dtype == 1)
    return layer_backward<__nv_bfloat16>(ptrs, B, S, H, N, F, causal, scale, ad, od, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

namespace {

// out[b][s][r][c] = keep scale of site site0 + s at (r, c): the masks the
// layer kernels draw, written out so a check can hold them against the
// plain version's ops/dropout_bits.py bit for bit.
__global__ void keep_scale_kernel(float* __restrict__ out, Drop drop, int B, int site0,
                                  int n_sites, int rows, int cols) {
  const long total = (long)B * n_sites * rows * cols;
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (long)gridDim.x * 256) {
    const int c = (int)(i % cols), r = (int)(i / cols % rows);
    const int s = (int)(i / ((long)cols * rows) % n_sites);
    const int b = (int)(i / ((long)cols * rows * n_sites));
    out[i] = keep_scale(drop, b, site0 + s, (uint32_t)(r * cols + c));
  }
}

}  // namespace

extern "C" int b4r_dropout_keep_scale(float* out, unsigned seed, unsigned threshold,
                                      float scale, int B, int site0, int n_sites,
                                      int rows, int cols, void* stream) {
  const Drop d{seed, threshold, scale, 1};
  const long total = (long)B * n_sites * rows * cols;
  const int blocks = (int)(total < 256L * 4096 ? (total + 255) / 256 : 4096);
  keep_scale_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, d, B, site0, n_sites, rows, cols);
  return (int)cudaGetLastError();
}
