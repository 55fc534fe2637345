// Fused post-LN transformer encoder layer, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel bert4rec_tpu/ops/fused_encoder_layer.py:_fwd_kernel
// (launched by _run_forward) for the inference case: no dropout, no causal
// mask, no relative-time bias. It computes _layer_fwd_math step by step, with
// the same rounding points (T is float or bf16, every sum is fp32):
//
//   qkv  = T(x Wqkv + bqkv)
//   p    = softmax_fp32(q k^T / sqrt(D) + (mask > 0 ? 0 : -1e9))   per head
//   ctx  = T(T(p) v)
//   x1   = T(LN1(x + ctx Wo + bo))
//   hact = T(gelu_tanh(x1 W1 + b1))
//   y    = T(LN2(x1 + hact W2 + b2))
//
// Design. The TPU kernel holds one whole layer and one whole sequence in
// ~14 MB of VMEM per grid cell; an H100 block has at most 227 KB of shared
// memory, and one layer's fp32 weights alone are 786 KB at hidden 128. So
// the layer is five launches of three kernels, each owning tiles that fit:
//   gemm_bias_kernel         qkv projection, and W1 with the tanh-gelu epilogue
//   attention_kernel         one block per (query tile, head, sequence); two
//                            passes over key tiles: the first finds each
//                            row's max and sum, the second forms the
//                            normalised probabilities, rounds them to T as
//                            the TPU kernel does, and accumulates p v
//   gemm_residual_ln_kernel  Wo and W2: a block owns whole rows, so bias,
//                            residual and LayerNorm run in the epilogue
// Intermediates round-trip through device memory between launches (qkv,
// ctx, x1, hact), which the TPU kernel kept in VMEM.
//
// Bound. ~99 MFLOP per sequence at S=200, H=128, F=512: the layer is bound by
// operations, not bytes. These kernels are plain SIMT fp32 FMA loops (no
// tensor cores, no TMA): right first; wgmma/TMA tiles are later work.
//
// Interface: one C entry point launching all five kernels on the caller's
// stream; it returns the first non-zero cudaGetLastError() code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr float kNegMask = -1e9f;
constexpr float kLnEps = 1e-12f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = kGeluC * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// --------------------------------------------------------------------------
// C[M, N] = T(epilogue(A[M, K] W[K, N] + bias[N])), epilogue = id or gelu.
// 64 x 64 output tile per block, 256 threads, 4 x 4 outputs per thread.
// --------------------------------------------------------------------------
constexpr int GM_BM = 64, GM_BN = 64, GM_BK = 16, GM_PAD = 4;

template <typename T, bool kGelu>
__global__ void __launch_bounds__(256)
gemm_bias_kernel(const T* __restrict__ A, const T* __restrict__ W,
                 const float* __restrict__ bias, T* __restrict__ C,
                 int M, int N, int K) {
  __shared__ float As[GM_BK][GM_BM + GM_PAD];
  __shared__ float Bs[GM_BK][GM_BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * GM_BM, col0 = blockIdx.y * GM_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    for (int l = tid; l < GM_BM * GM_BK; l += 256) {
      const int r = l / GM_BK, c = l % GM_BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? to_f(A[(size_t)gr * K + gc]) : 0.f;
    }
    for (int l = tid; l < GM_BK * GM_BN; l += 256) {
      const int r = l / GM_BN, c = l % GM_BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? to_f(W[(size_t)gr * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GM_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float v = acc[i][j] + bias[c];
      if (kGelu) v = gelu_tanh(v);
      C[(size_t)r * N + c] = from_f<T>(v);
    }
  }
}

// --------------------------------------------------------------------------
// Y[M, H] = T(LN(R + (A[M, K] W[K, H] + bias)) * gamma + beta), fp32 inside.
// A block owns 32 whole rows: warp w holds rows 4w..4w+3, lane l holds
// columns l, l+32, ..., l+32(TN-1) (H <= 32 TN), so row sums are warp
// shuffles. TN is a template argument so no lane issues empty column slots.
// --------------------------------------------------------------------------
constexpr int LN_BM = 32, LN_BK = 16, LN_PAD = 4, LN_MAXTN = 16;

template <typename T, int TN>
__global__ void __launch_bounds__(256)
gemm_residual_ln_kernel(const T* __restrict__ A, const T* __restrict__ W,
                        const float* __restrict__ bias,
                        const T* __restrict__ R,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ Y,
                        int M, int H, int K) {
  extern __shared__ float smem[];
  float* As = smem;                              // [LN_BK][LN_BM + LN_PAD]
  float* Bs = smem + LN_BK * (LN_BM + LN_PAD);   // [LN_BK][H]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * LN_BM;
  float acc[4][TN];
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

  const float inv_h = 1.0f / (float)H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + warp * 4 + i;  // the same for the whole warp
    if (r >= M) continue;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = lane + 32 * j;
      if (c < H) {
        const float u = to_f(R[(size_t)r * H + c]) + (acc[i][j] + bias[c]);
        acc[i][j] = u;
        sum += u;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum * inv_h;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = lane + 32 * j;
      if (c < H) {
        const float d = acc[i][j] - mean;
        sq += d * d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq * inv_h + kLnEps);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = lane + 32 * j;
      if (c < H) {
        const float yv = (acc[i][j] - mean) * rstd * gamma[c] + beta[c];
        Y[(size_t)r * H + c] = from_f<T>(yv);
      }
    }
  }
}

// --------------------------------------------------------------------------
// Masked multi-head attention over qkv [B*S, 3H] (q | k | v, head-major
// columns inside each), ctx [B*S, H]. Block = (query tile, head, sequence),
// 256 threads: thread (ty, tx) owns query rows ty + 16 i and, for scores,
// key columns tx + 16 j; for the output, head columns tx + 16 j with
// j < DJ (D <= 16 DJ; DJ a template argument so no thread issues empty
// slots). The 16 threads of a row are one half-warp, so row reductions are
// shuffles.
// --------------------------------------------------------------------------
constexpr int AT_BQ = 64, AT_BKV = 64, AT_MAXD = 128;
static_assert(AT_BQ == AT_BKV, "load_head_tile loads query and key tiles alike");

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void load_head_tile(float* dst, const T* __restrict__ qkv,
                                               size_t seq_row0, int t0, int S,
                                               int col0, int D, int ld) {
  for (int l = threadIdx.x; l < AT_BKV * D; l += 256) {
    const int r = l / D, d = l % D;
    const int t = t0 + r;
    dst[r * (D + 1) + d] =
        (t < S) ? to_f(qkv[(seq_row0 + t) * (size_t)ld + col0 + d]) : 0.f;
  }
}

// scores of this thread's 4 x 4 (row, key) pairs for the key tile in Ks
__device__ __forceinline__ void tile_scores(float s[4][4], const float* Qs,
                                            const float* Ks, const float* mb,
                                            int tx, int ty, int D, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float q[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(q[i], k[j], s[i][j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b = mb[tx + 16 * j];  // -inf marks a key past the sequence
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i][j] = (b == -INFINITY) ? -INFINITY : s[i][j] * scale + b;
  }
}

template <typename T, int DJ>
__global__ void __launch_bounds__(256)
attention_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ mask,
                 T* __restrict__ ctx, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [AT_BQ][D + 1]
  float* Ks = Qs + AT_BQ * (D + 1);          // [AT_BKV][D + 1]
  float* Vs = Ks + AT_BKV * (D + 1);         // [AT_BKV][D + 1]
  float* Ps = Vs + AT_BKV * (D + 1);         // [AT_BQ][AT_BKV + 1]
  float* mb = Ps + AT_BQ * (AT_BKV + 1);     // [AT_BKV]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * AT_BQ, head = blockIdx.y, b = blockIdx.z;
  const size_t seq_row0 = (size_t)b * S;
  const int ld = 3 * H;
  const int qcol = head * D, kcol = H + head * D, vcol = 2 * H + head * D;

  load_head_tile(Qs, qkv, seq_row0, q0, S, qcol, D, ld);

  // pass 1: running row max m and sum l of exp(s - m)
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int t0 = 0; t0 < S; t0 += AT_BKV) {
    load_head_tile(Ks, qkv, seq_row0, t0, S, kcol, D, ld);
    for (int c = tid; c < AT_BKV; c += 256) {
      const int t = t0 + c;
      mb[c] = (t < S) ? (mask[seq_row0 + t] > 0 ? 0.f : kNegMask) : -INFINITY;
    }
    __syncthreads();
    tile_scores(s, Qs, Ks, mb, tx, ty, D, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) tsum += exp2f((s[i][j] - m_new) * kLog2e);
      l[i] = l[i] * exp2f((m[i] - m_new) * kLog2e) + half_warp_sum(tsum);
      m[i] = m_new;
    }
    __syncthreads();
  }
  float inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv_l[i] = 1.0f / l[i];

  // pass 2: p = T(exp(s - m) / l), ctx += p v
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  for (int t0 = 0; t0 < S; t0 += AT_BKV) {
    load_head_tile(Ks, qkv, seq_row0, t0, S, kcol, D, ld);
    load_head_tile(Vs, qkv, seq_row0, t0, S, vcol, D, ld);
    for (int c = tid; c < AT_BKV; c += 256) {
      const int t = t0 + c;
      mb[c] = (t < S) ? (mask[seq_row0 + t] > 0 ? 0.f : kNegMask) : -INFINITY;
    }
    __syncthreads();
    tile_scores(s, Qs, Ks, mb, tx, ty, D, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((s[i][j] - m[i]) * kLog2e) * inv_l[i];
        Ps[(ty + 16 * i) * (AT_BKV + 1) + tx + 16 * j] = to_f(from_f<T>(p));
      }
    __syncthreads();
    const int kv_len = min(AT_BKV, S - t0);
    for (int c = 0; c < kv_len; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (AT_BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float v = Vs[c * (D + 1) + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = fmaf(p[i], v, o[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ctx[(seq_row0 + r) * (size_t)H + head * D + d] = from_f<T>(o[i][j]);
    }
  }
}

size_t attention_smem_bytes(int D) {
  return sizeof(float) *
         (size_t)(AT_BQ * (D + 1) + 2 * AT_BKV * (D + 1) + AT_BQ * (AT_BKV + 1) + AT_BKV);
}

size_t ln_smem_bytes(int H) {
  return sizeof(float) * (size_t)(LN_BK * (LN_BM + LN_PAD) + LN_BK * H);
}

inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

// the smallest power of two >= n (n >= 1)
inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <typename T, int DJ>
cudaError_t launch_attention(const T* qkv, const int32_t* mask, T* ctx, int B,
                             int S, int H, int N, int D, float scale,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<T, DJ><<<dim3(ceil_div(S, AT_BQ), N, B), 256, smem, stream>>>(
      qkv, mask, ctx, S, H, D, scale);
  return cudaGetLastError();
}

template <typename T, int TN>
cudaError_t launch_gemm_ln(const T* A, const T* W, const float* bias, const T* R,
                           const float* gamma, const float* beta, T* Y, int M,
                           int H, int K, cudaStream_t stream) {
  const size_t smem = ln_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_residual_ln_kernel<T, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gemm_residual_ln_kernel<T, TN><<<ceil_div(M, LN_BM), 256, smem, stream>>>(
      A, W, bias, R, gamma, beta, Y, M, H, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention(const T* qkv, const int32_t* mask, T* ctx, int B, int S,
                      int H, int N, int D, float scale, cudaStream_t stream) {
  switch (pow2_at_least(ceil_div(D, 16))) {
    case 1: return launch_attention<T, 1>(qkv, mask, ctx, B, S, H, N, D, scale, stream);
    case 2: return launch_attention<T, 2>(qkv, mask, ctx, B, S, H, N, D, scale, stream);
    case 4: return launch_attention<T, 4>(qkv, mask, ctx, B, S, H, N, D, scale, stream);
    case 8: return launch_attention<T, 8>(qkv, mask, ctx, B, S, H, N, D, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t gemm_ln(const T* A, const T* W, const float* bias, const T* R,
                    const float* gamma, const float* beta, T* Y, int M, int H,
                    int K, cudaStream_t stream) {
  switch (pow2_at_least(ceil_div(H, 32))) {
    case 1: return launch_gemm_ln<T, 1>(A, W, bias, R, gamma, beta, Y, M, H, K, stream);
    case 2: return launch_gemm_ln<T, 2>(A, W, bias, R, gamma, beta, Y, M, H, K, stream);
    case 4: return launch_gemm_ln<T, 4>(A, W, bias, R, gamma, beta, Y, M, H, K, stream);
    case 8: return launch_gemm_ln<T, 8>(A, W, bias, R, gamma, beta, Y, M, H, K, stream);
    case 16: return launch_gemm_ln<T, 16>(A, W, bias, R, gamma, beta, Y, M, H, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int layer_forward(const void* x, const int32_t* mask, const void* wqkv,
                  const float* bqkv, const void* wo, const float* bo,
                  const float* g1, const float* b1ln, const void* w1,
                  const float* bf1, const void* w2, const float* bf2,
                  const float* g2, const float* b2ln, void* qkv_buf,
                  void* ctx_buf, void* x1_buf, void* h_buf, void* y, int B,
                  int S, int H, int N, int F, float scale,
                  cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* qkv = static_cast<T*>(qkv_buf);
  T* ctx = static_cast<T*>(ctx_buf);
  T* x1 = static_cast<T*>(x1_buf);
  T* hact = static_cast<T*>(h_buf);
  const int M = B * S, D = H / N;
  cudaError_t err;

  // 1. qkv = T(x Wqkv + bqkv)
  gemm_bias_kernel<T, false><<<dim3(ceil_div(M, GM_BM), ceil_div(3 * H, GM_BN)), 256, 0, stream>>>(
      xt, static_cast<const T*>(wqkv), bqkv, qkv, M, 3 * H, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 2. ctx = T(T(softmax(q k^T * scale + mask bias)) v), per head
  if ((err = attention<T>(qkv, mask, ctx, B, S, H, N, D, scale, stream)) != cudaSuccess)
    return (int)err;

  // 3. x1 = T(LN1(x + ctx Wo + bo))
  if ((err = gemm_ln<T>(ctx, static_cast<const T*>(wo), bo, xt, g1, b1ln, x1, M, H,
                        H, stream)) != cudaSuccess)
    return (int)err;

  // 4. hact = T(gelu_tanh(x1 W1 + b1))
  gemm_bias_kernel<T, true><<<dim3(ceil_div(M, GM_BM), ceil_div(F, GM_BN)), 256, 0, stream>>>(
      x1, static_cast<const T*>(w1), bf1, hact, M, F, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 5. y = T(LN2(x1 + hact W2 + b2))
  if ((err = gemm_ln<T>(hact, static_cast<const T*>(w2), bf2, x1, g2, b2ln,
                        static_cast<T*>(y), M, H, F, stream)) != cudaSuccess)
    return (int)err;
  return 0;
}

}  // namespace

extern "C" {

// Limits the wrapper checks before calling (ops/fused_encoder_layer.py).
int b4r_fused_layer_max_hidden() { return 32 * LN_MAXTN; }
int b4r_fused_layer_max_head_dim() { return AT_MAXD; }

// dtype: 0 = float32, 1 = bfloat16 for x, the four weight matrices, the
// scratch buffers and y; biases and LayerNorm params are always float32.
int b4r_fused_layer_fwd(int dtype, const void* x, const int32_t* mask,
                        const void* wqkv, const float* bqkv, const void* wo,
                        const float* bo, const float* g1, const float* b1ln,
                        const void* w1, const float* bf1, const void* w2,
                        const float* bf2, const float* g2, const float* b2ln,
                        void* qkv_buf, void* ctx_buf, void* x1_buf,
                        void* h_buf, void* y, int B, int S, int H, int N,
                        int F, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return layer_forward<float>(x, mask, wqkv, bqkv, wo, bo, g1, b1ln, w1, bf1,
                                w2, bf2, g2, b2ln, qkv_buf, ctx_buf, x1_buf,
                                h_buf, y, B, S, H, N, F, scale, st);
  if (dtype == 1)
    return layer_forward<__nv_bfloat16>(x, mask, wqkv, bqkv, wo, bo, g1, b1ln,
                                        w1, bf1, w2, bf2, g2, b2ln, qkv_buf,
                                        ctx_buf, x1_buf, h_buf, y, B, S, H, N,
                                        F, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
