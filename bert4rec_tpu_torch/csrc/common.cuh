// Helpers shared by the port's Hopper kernels (sm_90a): element-type
// conversion, the dropout hash, warp reductions, a 64 x 64 GEMM tile (bf16
// operands on the tensor cores with mma.sync, fp32 ones as SIMT FMA loops)
// and a deterministic row reduction.
#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace b4r {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the rounding points of the JAX kernels
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

// the smallest power of two >= n (n >= 1)
inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// ---------------------------------------------------------------------------
// Dropout bits: the same hash as bert4rec_tpu_torch/ops/dropout_bits.py, bit
// for bit. key = seed + elem * 64 + site (mod 2^32), counter = row * n_cols
// + col, bits = fmix32(fmix32(key) ^ counter * 0x9E3779B9); kept where
// bits >= threshold, scaled by 1 / (1 - rate). fmix32(key) is constant for
// a (batch element, site): kernels compute it once (site_key) and pay one
// round per element (keep_scale_k).
// ---------------------------------------------------------------------------
constexpr uint32_t kSitesPerCell = 64;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}


// one dropout site family of a launch; `on` == 0 means rate 0 (no hashing)
struct Drop {
  uint32_t seed;
  uint32_t threshold;
  float scale;
  int on;
};

// fmix32(key) of one (batch element, site)
__device__ __forceinline__ uint32_t site_key(const Drop& d, int elem, int site) {
  return fmix32(d.seed + (uint32_t)elem * kSitesPerCell + (uint32_t)site);
}

__device__ __forceinline__ float keep_scale_k(const Drop& d, uint32_t site_k,
                                              uint32_t counter) {
  return fmix32(site_k ^ (counter * 0x9E3779B9u)) >= d.threshold ? d.scale : 0.f;
}

__device__ __forceinline__ float keep_scale(const Drop& d, int elem, int site,
                                            uint32_t counter) {
  return keep_scale_k(d, site_key(d, elem, site), counter);
}

// ---------------------------------------------------------------------------
// the layer's LayerNorm epsilon and tanh-approximate gelu (JAX's kernel's,
// whatever inner_activation says)
// ---------------------------------------------------------------------------
constexpr float kLnEps = 1e-12f;
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = kGeluC * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float inner = kGeluC * (x + 0.044715f * x * x * x);
  const float t = tanhf(inner);
  const float dinner = kGeluC * (1.0f + 3.0f * 0.044715f * x * x);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * dinner;
}

// ---------------------------------------------------------------------------
// warp reductions
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
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

// ---------------------------------------------------------------------------
// bf16 tensor-core tiles: mma.sync.m16n8k16 with fp32 sums. The products
// of bf16 operands are exact in fp32, so a tile differs from the SIMT loop
// only in the order of its sums. Operand tiles live in shared memory as
// bf16 rows of MMA_LD elements along k (A: [row][k]; B transposed to
// [col][k]), so every fragment register is one aligned 32-bit load.
// ---------------------------------------------------------------------------
constexpr int MMA_BK = 32, MMA_LD = MMA_BK + 8;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment: rows r0 .. r0+15, k kk .. kk+15 of As[row][MMA_LD]
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const __nv_bfloat16* As,
                                            int r0, int kk) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = As + (r0 + (lane >> 2)) * MMA_LD + kk + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * MMA_LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * MMA_LD + 8);
}

// B fragment: columns n0 .. n0+7, k kk .. kk+15 of Bt[col][MMA_LD]
__device__ __forceinline__ void load_b_frag(uint32_t b[2], const __nv_bfloat16* Bt,
                                            int n0, int kk) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = Bt + (n0 + (lane >> 2)) * MMA_LD + kk + 2 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Writes a warp's accumulator tile (rows r0 .. r0+15, columns n0 .. n0+7)
// into Cs[row * ldc + col], columns >= n_cols dropped.
__device__ __forceinline__ void spill_frag(float* Cs, int ldc, const float c[4], int r0,
                                           int n0, int n_cols) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane >> 2), col = n0 + 2 * (lane & 3);
  if (col < n_cols) {
    Cs[r * ldc + col] = c[0];
    Cs[(r + 8) * ldc + col] = c[2];
  }
  if (col + 1 < n_cols) {
    Cs[r * ldc + col + 1] = c[1];
    Cs[(r + 8) * ldc + col + 1] = c[3];
  }
}

// ---------------------------------------------------------------------------
// acc = A[row0:+64, :K] W[:K, col0:+64] (row-major, fp32 sums). 256 threads;
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i, columns
// tx + 16 j. Ends with a barrier, so the caller may reuse As / Bs. With
// bf16 operands the tile runs on the tensor cores (warp w computes rows
// 16 (w % 4) .. +15, columns 32 (w / 4) .. +31) and is handed to the same
// thread layout through shared memory.
// ---------------------------------------------------------------------------
constexpr int GM_BM = 64, GM_BN = 64, GM_BK = 16, GM_PAD = 4;

template <typename TA, typename TW>
__device__ __forceinline__ void gemm_tile_nn(float acc[4][4], const TA* __restrict__ A,
                                             const TW* __restrict__ W, int M, int N,
                                             int K, int row0, int col0,
                                             float (&As)[GM_BK][GM_BM + GM_PAD],
                                             float (&Bs)[GM_BK][GM_BN]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if constexpr (kIsBf16<TA> && kIsBf16<TW>) {
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
    for (int k0 = 0; k0 < K; k0 += MMA_BK) {
      for (int l = tid; l < GM_BM * MMA_BK; l += 256) {
        const int r = l / MMA_BK, kk = l % MMA_BK;
        const int gr = row0 + r, gk = k0 + kk;
        Ah[r * MMA_LD + kk] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : zero;
      }
      for (int l = tid; l < MMA_BK * GM_BN; l += 256) {
        const int kk = l / GM_BN, n = l % GM_BN;
        const int gk = k0 + kk, gn = col0 + n;
        Bh[n * MMA_LD + kk] = (gk < K && gn < N) ? W[(size_t)gk * N + gn] : zero;
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
    __syncthreads();
  } else {
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
  }
}

// two fp32 values that are bf16-exact (operands read back from fp32 tiles)
// as one bf16x2 fragment register, the lower k in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Dot products of this thread's 4 x 4 (row of Xs, row of Ys) pairs, both
// tiles [64][D + 1] in shared memory; thread (ty, tx) takes Xs rows
// ty + 16 i and Ys rows tx + 16 j. With kMma (bf16-exact tiles) the 64 x 64
// products run on the tensor cores (warp w: rows 16 (w % 4) .. +15,
// columns 32 (w / 4) .. +31) and reach the same layout through `scr`, a
// [64][65] fp32 scratch tile; the call then holds two block barriers.
template <bool kMma = false>
__device__ __forceinline__ void tile_dots(float s[4][4], const float* Xs, const float* Ys,
                                          int tx, int ty, int D, float* scr = nullptr) {
  if constexpr (kMma) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const int mb = (warp & 3) * 16, nb = (warp >> 2) * 32, ld = D + 1;
    auto X = [&](int r, int k) { return k < D ? Xs[r * ld + k] : 0.f; };
    auto Y = [&](int r, int k) { return k < D ? Ys[r * ld + k] : 0.f; };
    float c[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[q][e] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], b[2];
      a[0] = pack2(X(mb + g, kk + t2), X(mb + g, kk + t2 + 1));
      a[1] = pack2(X(mb + g + 8, kk + t2), X(mb + g + 8, kk + t2 + 1));
      a[2] = pack2(X(mb + g, kk + t2 + 8), X(mb + g, kk + t2 + 9));
      a[3] = pack2(X(mb + g + 8, kk + t2 + 8), X(mb + g + 8, kk + t2 + 9));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = nb + 8 * q + g;
        b[0] = pack2(Y(n, kk + t2), Y(n, kk + t2 + 1));
        b[1] = pack2(Y(n, kk + t2 + 8), Y(n, kk + t2 + 9));
        mma_bf16(c[q], a, b);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) spill_frag(scr, 65, c[q], mb, nb + 8 * q, 64);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = scr[(ty + 16 * i) * 65 + tx + 16 * j];
    __syncthreads();
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float q[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = Xs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = Ys[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(q[i], k[j], s[i][j]);
    }
  }
}

// c += A[64 x 64] B[64 x D] on the tensor cores, operands read from fp32
// shared-memory tiles holding bf16-exact values: A(r, k) = A[r*a_rs +
// k*a_ks], B(k, n) = B[k*b_ks + n*b_ns]. Warp w owns rows 16 (w % 4) ..
// +15 and the 8-column blocks 8 DJ (w / 4) + 8 q, q < DJ (16 DJ >= D).
template <int DJ>
__device__ __forceinline__ void mma_acc_64xD(float c[DJ][4], const float* A, int a_rs,
                                             int a_ks, const float* B, int b_ks,
                                             int b_ns, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int mb = (warp & 3) * 16, n_base = (warp >> 2) * 8 * DJ;
  auto At = [&](int r, int k) { return A[r * a_rs + k * a_ks]; };
  for (int kk = 0; kk < 64; kk += 16) {
    uint32_t a[4], b[2];
    a[0] = pack2(At(mb + g, kk + t2), At(mb + g, kk + t2 + 1));
    a[1] = pack2(At(mb + g + 8, kk + t2), At(mb + g + 8, kk + t2 + 1));
    a[2] = pack2(At(mb + g, kk + t2 + 8), At(mb + g, kk + t2 + 9));
    a[3] = pack2(At(mb + g + 8, kk + t2 + 8), At(mb + g + 8, kk + t2 + 9));
#pragma unroll
    for (int q = 0; q < DJ; ++q) {
      const int n0 = n_base + 8 * q;
      if (n0 >= D) continue;
      const int n = n0 + g;
      auto Bt = [&](int k) { return n < D ? B[k * b_ks + n * b_ns] : 0.f; };
      b[0] = pack2(Bt(kk + t2), Bt(kk + t2 + 1));
      b[1] = pack2(Bt(kk + t2 + 8), Bt(kk + t2 + 9));
      mma_bf16(c[q], a, b);
    }
  }
}

// Writes mma_acc_64xD's fragments into out[row * ld + col] (cols < D).
template <int DJ>
__device__ __forceinline__ void spill_64xD(float* out, int ld, const float c[DJ][4],
                                           int D) {
  const int warp = threadIdx.x >> 5;
  const int mb = (warp & 3) * 16, n_base = (warp >> 2) * 8 * DJ;
#pragma unroll
  for (int q = 0; q < DJ; ++q)
    if (n_base + 8 * q < D) spill_frag(out, ld, c[q], mb, n_base + 8 * q, D);
}

// out[i] = sum_r part[r * n + i], r in order: the deterministic second pass
// of every split reduction (no float atomics anywhere).
__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int rows,
                   int n) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * n + i];
  out[i] = s;
}

inline cudaError_t reduce_rows(const float* part, float* out, int rows, int n,
                               cudaStream_t stream) {
  reduce_rows_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(part, out, rows, n);
  return cudaGetLastError();
}

// bump allocator over one caller-allocated workspace, 256-byte aligned
struct Carve {
  char* base;
  size_t used;
  template <typename U> U* take(size_t count) {
    U* p = reinterpret_cast<U*>(base ? base + used : nullptr);
    used += (count * sizeof(U) + 255) / 256 * 256;
    return p;
  }
};

}  // namespace b4r
