// Masked multi-head attention over 64 x 64 tiles, forward and backward, for
// Hopper (sm_90a): the SIMT / mma.sync tiles, shared by the fused
// encoder layer's off-rule shapes (fused_encoder_layer.cu, K1/K1''/K2: fp32
// off layer_tf32.cu's rule, bf16 off layer_hopper.cuh's) and fp32 flash
// attention off its 3xTF32 rule (flash_attention.cu, K8/K9: a head dim that
// is not a multiple of 8 up to 64; ops/flash_attention.py flash_route
// "simt"). Every shape the repo ships runs the warpgroup kernels instead.
//
// Function, per (batch element b, head n), T float or bf16, sums in fp32:
//
//   s    = q k^T * scale + (mask > 0 ? 0 : -1e9) [+ (key > query ? -1e9 : 0)]
//          [+ rel[b, n, query, key]]
//   p    = exp(s - max_j s) * (1 / sum_j exp(s - max_j s))      (fp32)
//   o    = T(T(p * keep) v)
// and its backward (the TPU kernels' _bwd_kernel / _bwd_element):
//   dd   = dO v^T, dp = dd * keep, delta = sum_j dp_ij p_ij
//   ds   = T(p (dp - delta))
//   dq   = T(ds k * scale), dk = T(ds^T q * scale), dv = T(T(p * keep)^T dO)
// keep is 1 / (1 - rate) or 0 from the counter hash of common.cuh at site
// `head` and counter `row * S + col`, the plain versions' ops/dropout_bits.py
// (an int product: S <= 46340, checked by the wrappers).
//
// Operands are [B, N, S, D] views given by element strides (Heads): K8/K9's
// q, k, v, o as the wrapper hands them (any batch, head and sequence
// strides; the head-dim axis contiguous), or the packed [B*S, 3H] qkv of the
// fused layer, whose q, k and v are column blocks of one matrix. The mask is
// [B, S] int32, the row statistics and delta [B, N, S] fp32.
//
// Kernels (256 threads; thread (ty, tx) owns tile rows ty + 16 i and, for
// scores, key columns tx + 16 j; for head outputs, columns tx + 16 j with
// j < DJ, D <= 16 DJ; the 16 threads of a row are one half-warp):
//   attention_kernel     one block per (query tile, head, batch element);
//                        pass 1 over the key tiles finds each row's max and
//                        sum, pass 2 forms the normalised probabilities,
//                        applies the dropout scale, rounds them to T as the
//                        TPU kernels do and accumulates p v; it can write
//                        the row max and sum for the backward;
//   attn_bwd_dq_kernel   one block per (query tile, head, batch element):
//                        delta (JAX's sum_j dp_ij p_ij, not flash
//                        attention's dO . o: equal in exact arithmetic, not
//                        in rounding) in pass A, dq in pass B;
//   attn_bwd_dkv_kernel  one block per (key tile, head, batch element),
//                        looping over the query tiles: dk and dv.
// Both backward kernels read the forward's row statistics, so they recompute
// its probabilities bit for bit.
//
// Relative bias (kRel, the fused layer's K1'' rel_bias / K2 dRel; the
// temporal family's relative-time bias): rel is an fp32 [B, N, S, S] tensor
// (JAX's head-major [B, N*S, S]) added to the scores after the pad and
// causal biases, in fp32, as the TPU kernel adds it. Every kernel that forms
// scores reads it straight from device memory in tile_scores' 4 x 4 pattern
// (16 consecutive keys per half-warp, no shared-memory tile), so the
// recomputed probabilities stay bitwise the forward's. attn_bwd_dq_kernel
// writes its gradient drel = p (dp - delta) in fp32, before the rounding to
// T the dq product reads, and zeros where causal_skip skips a key tile (p is
// 0 there). kRel is a template switch: without it the kernels compile to
// the code they ran before it existed (flash attention never passes rel).
// It adds 4 B per (query, key) pair read per pass (two forward, three
// backward) and 4 B written: bytes, not operations, bound what it adds. Weight-free: no split-K reduction, and two
// runs give the same bits. The fused layer also asks for the column sums of
// dq, dk and dv per tile (its qkv bias gradient): `part`, null for K8/K9.
// With bf16 operands the products QK^T, dO V^T, p v, ds k, ds^T q and
// p^T dO run on the tensor cores (mma.sync m16n8k16, fp32 sums); fp32 stays
// on SIMT FMA loops. Shared memory at D = 64: 67, 83 and 101 KB.
#pragma once

#include "common.cuh"

namespace b4r {

constexpr float kAttnNegMask = -1e9f;
constexpr float kAttnLog2e = 1.4426950408889634f;
constexpr int AT_BQ = 64, AT_BKV = 64, AT_MAXD = 128;
static_assert(AT_BQ == AT_BKV, "load_head_tile loads query and key tiles alike");

// One [B, N, S, D] operand: element (b, n, t, d) at p[b sb + n sn + t ss + d].
// Offsets inside one head fit in 32 bits ((S - 1) ss + D < 2^31, checked by
// the wrappers): a row index is one 32-bit multiply-add.
template <typename P>
struct Heads {
  P* p;
  long long sb, sn;
  int ss;
  __device__ __forceinline__ P* at(int b, int n) const {
    return p + (long long)b * sb + (long long)n * sn;
  }
};

// Rows t0 .. t0+63 of one head ([S, D] at `src` with row stride ss) into an
// fp32 [64][D + 1] tile, rows past the sequence zero, and the key tile's
// additive mask bias (-inf marks a key past the sequence). kLdg reads
// through __ldg's read-only path. The forward kernel asks for it: without
// it K1' forward read 0.6% slower than with the packed __restrict__ qkv it
// read before these tiles were shared. The backward kernels load as they
// did then (PERF.md, A/B of the layer kernels).
template <bool kLdg = false, typename T>
__device__ __forceinline__ void load_head_tile(float* dst, const T* __restrict__ src,
                                               int ss, int t0, int S, int D) {
  for (int l = threadIdx.x; l < AT_BKV * D; l += 256) {
    const int r = l / D, d = l % D;
    const int t = t0 + r;
    if constexpr (kLdg)
      dst[r * (D + 1) + d] = (t < S) ? to_f(__ldg(src + t * ss + d)) : 0.f;
    else
      dst[r * (D + 1) + d] = (t < S) ? to_f(src[t * ss + d]) : 0.f;
  }
}

template <bool kLdg = false>
__device__ __forceinline__ void load_mask_bias(float* mb, const int32_t* __restrict__ mask_row,
                                               int t0, int S) {
  for (int c = threadIdx.x; c < AT_BKV; c += 256) {
    const int t = t0 + c;
    if constexpr (kLdg)
      mb[c] = (t < S) ? (__ldg(mask_row + t) > 0 ? 0.f : kAttnNegMask) : -INFINITY;
    else
      mb[c] = (t < S) ? (mask_row[t] > 0 ? 0.f : kAttnNegMask) : -INFINITY;
  }
}

// scaled, masked scores of this thread's 4 x 4 (query, key) pairs of the
// query tile at q0 and the key tile at t0 (kMma: on the tensor cores,
// through the [64][65] scratch tile `scr`). With `causal` a key after its
// query adds a second -1e9 to the pad bias, as the TPU kernels'
// pad_bias + causal_bias: a padded key above the diagonal scores -2e9, one
// on or below it -1e9, so a row that sees only padding is uniform over
// its keys j <= i, as in the TPU kernels.
//
// With kRel, `rel` is this (batch element, head)'s [S, S] fp32 slab; its
// entry (query, key) is added last, to the keys inside the sequence of the
// query rows inside it (S = 200 leaves a partial last tile).
template <bool kMma, bool kRel = false>
__device__ __forceinline__ void tile_scores(float s[4][4], const float* Qs,
                                            const float* Ks, const float* mb,
                                            int tx, int ty, int D, float scale,
                                            float* scr, int q0, int t0, int causal,
                                            const float* __restrict__ rel = nullptr,
                                            int S = 0) {
  tile_dots<kMma>(s, Qs, Ks, tx, ty, D, scr);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b = mb[tx + 16 * j];
    const int key = t0 + tx + 16 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bias = (causal && key > q0 + ty + 16 * i) ? b + kAttnNegMask : b;
      s[i][j] = (b == -INFINITY) ? -INFINITY : s[i][j] * scale + bias;
      if constexpr (kRel) {
        const int q = q0 + ty + 16 * i;
        if (b != -INFINITY && q < S) s[i][j] += __ldg(rel + q * S + key);
      }
    }
  }
}

// This (batch element, head)'s [S, S] slab of a [B, N, S, S] tensor.
template <typename P>
__device__ __forceinline__ P* head_slab(P* t, int b, int head, int N, int S) {
  return t + ((size_t)b * N + head) * S * S;
}

// Whether a causal block may skip the key tiles wholly after its query
// tile. When the sequence's first key is real, every row sees it with a
// score of O(1), so a key after the row (-1e9 or -2e9) adds exp(-1e9) = 0
// to the row: the skip is exact. When the first key is padding, a row may
// see only padding (all scores ~ -1e9, as a later real key's); then no
// tile is skipped and the biases alone give the TPU kernels' rows.
__device__ __forceinline__ int causal_skip(const int32_t* __restrict__ mask_row,
                                           int causal) {
  return causal && mask_row[0] > 0;
}

// One past the last key tile a query tile at q0 reads (AT_BQ == AT_BKV
// keeps the tiles aligned: the diagonal tile is the last).
__device__ __forceinline__ int key_tiles_end(int q0, int S, int skip) {
  return skip ? min(S, q0 + AT_BQ) : S;
}

template <typename T, int DJ, bool kRel>
__global__ void __launch_bounds__(256)
attention_kernel(Heads<const T> q, Heads<const T> k, Heads<const T> v,
                 const int32_t* __restrict__ mask, Heads<T> o,
                 float* __restrict__ stat_m, float* __restrict__ stat_l, Drop drop,
                 int S, int N, int D, float scale, int causal,
                 const float* __restrict__ rel) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [AT_BQ][D + 1]
  float* Ks = Qs + AT_BQ * (D + 1);          // [AT_BKV][D + 1]
  float* Vs = Ks + AT_BKV * (D + 1);         // [AT_BKV][D + 1]
  float* Ps = Vs + AT_BKV * (D + 1);         // [AT_BQ][AT_BKV + 1]
  float* mb = Ps + AT_BQ * (AT_BKV + 1);     // [AT_BKV]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * AT_BQ, head = blockIdx.y, b = blockIdx.z;
  const T* qh = q.at(b, head);
  const T* kh = k.at(b, head);
  const T* vh = v.at(b, head);
  const int32_t* mask_row = mask + (size_t)b * S;
  constexpr bool kMma = kIsBf16<T>;
  const uint32_t hk = site_key(drop, b, head);  // this block's site
  const int t_end = key_tiles_end(q0, S, causal_skip(mask_row, causal));
  const float* relh = kRel ? head_slab(rel, b, head, N, S) : nullptr;

  load_head_tile<true>(Qs, qh, q.ss, q0, S, D);

  // pass 1: running row max m and sum l of exp(s - m)
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int t0 = 0; t0 < t_end; t0 += AT_BKV) {
    load_head_tile<true>(Ks, kh, k.ss, t0, S, D);
    load_mask_bias<true>(mb, mask_row, t0, S);
    __syncthreads();
    tile_scores<kMma, kRel>(s, Qs, Ks, mb, tx, ty, D, scale, Ps, q0, t0, causal, relh, S);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) tsum += exp2f((s[i][j] - m_new) * kAttnLog2e);
      l[i] = l[i] * exp2f((m[i] - m_new) * kAttnLog2e) + half_warp_sum(tsum);
      m[i] = m_new;
    }
    __syncthreads();
  }
  float inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv_l[i] = 1.0f / l[i];
    const int r = q0 + ty + 16 * i;
    if (stat_m && tx == 0 && r < S) {
      const size_t at = ((size_t)b * N + head) * S + r;
      stat_m[at] = m[i];
      stat_l[at] = l[i];
    }
  }

  // pass 2: p = T(exp(s - m) / l * keep), o += p v
  float acc[4][DJ], co[DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = co[j][i] = 0.f;
  for (int t0 = 0; t0 < t_end; t0 += AT_BKV) {
    load_head_tile<true>(Ks, kh, k.ss, t0, S, D);
    load_head_tile<true>(Vs, vh, v.ss, t0, S, D);
    load_mask_bias<true>(mb, mask_row, t0, S);
    __syncthreads();
    tile_scores<kMma, kRel>(s, Qs, Ks, mb, tx, ty, D, scale, Ps, q0, t0, causal, relh, S);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f((s[i][j] - m[i]) * kAttnLog2e) * inv_l[i];
        if (drop.on)
          p *= keep_scale_k(drop, hk,
                            (uint32_t)((q0 + ty + 16 * i) * S + t0 + tx + 16 * j));
        Ps[(ty + 16 * i) * (AT_BKV + 1) + tx + 16 * j] = round_to<T>(p);
      }
    __syncthreads();
    if constexpr (kMma) {
      // keys past the sequence have p = 0 and zero v rows: a full tile
      mma_acc_64xD<DJ>(co, Ps, AT_BKV + 1, 1, Vs, D + 1, 1, D);
    } else {
      const int kv_len = min(AT_BKV, S - t0);
      for (int c = 0; c < kv_len; ++c) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (AT_BKV + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float vv = Vs[c * (D + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  if constexpr (kMma) {  // fragments -> the (ty, tx) layout, through Qs
    spill_64xD<DJ>(Qs, D + 1, co, D);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) acc[i][j] = Qs[(ty + 16 * i) * (D + 1) + d];
      }
  }

  T* oh = o.at(b, head);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) oh[r * o.ss + d] = from_f<T>(acc[i][j]);
    }
  }
}

inline size_t attention_smem_bytes(int D) {
  return sizeof(float) *
         (size_t)(AT_BQ * (D + 1) + 2 * AT_BKV * (D + 1) + AT_BQ * (AT_BKV + 1) + AT_BKV);
}

template <typename T, int DJ, bool kRel>
cudaError_t launch_attention(Heads<const T> q, Heads<const T> k, Heads<const T> v,
                             const int32_t* mask, Heads<T> o, float* stat_m,
                             float* stat_l, Drop drop, int B, int S, int N, int D,
                             float scale, int causal, const float* rel,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, DJ, kRel>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<T, DJ, kRel><<<dim3(ceil_div(S, AT_BQ), N, B), 256, smem, stream>>>(
      q, k, v, mask, o, stat_m, stat_l, drop, S, N, D, scale, causal, rel);
  return cudaGetLastError();
}

// o = attention(q, k, v); stat_m / stat_l ([B, N, S]) may be null; with
// kRel, rel ([B, N, S, S] fp32) is added to the scores
template <typename T, bool kRel = false>
cudaError_t attention(Heads<const T> q, Heads<const T> k, Heads<const T> v,
                      const int32_t* mask, Heads<T> o, float* stat_m, float* stat_l,
                      Drop drop, int B, int S, int N, int D, float scale, int causal,
                      cudaStream_t stream, const float* rel = nullptr) {
#define B4R_AT(DJV) \
  launch_attention<T, DJV, kRel>(q, k, v, mask, o, stat_m, stat_l, drop, B, S, N, D, \
                                 scale, causal, rel, stream)
  switch (pow2_at_least(ceil_div(D, 16))) {
    case 1: return B4R_AT(1);
    case 2: return B4R_AT(2);
    case 4: return B4R_AT(4);
    case 8: return B4R_AT(8);
    default: return cudaErrorInvalidValue;
  }
#undef B4R_AT
}

// attn_bwd_dq_kernel: one block per (query tile, head, batch element);
// writes dq, delta and, with `part`, the dq columns' sums per tile
// (part [B * n_query_tiles][3 N D], dq in the first N D columns).
template <typename T, int DJ, bool kRel>
__global__ void __launch_bounds__(256)
attn_bwd_dq_kernel(Heads<const T> q, Heads<const T> k, Heads<const T> v,
                   Heads<const T> dout, const int32_t* __restrict__ mask,
                   const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                   Drop drop, float* __restrict__ delta_out, Heads<T> dq,
                   float* __restrict__ part, int S, int N, int D, float scale,
                   int causal, const float* __restrict__ rel, float* __restrict__ drel) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [64][D + 1]
  float* Cs = Qs + AT_BQ * (D + 1);          // dO rows of the query tile
  float* Ks = Cs + AT_BQ * (D + 1);
  float* Vs = Ks + AT_BKV * (D + 1);
  float* Ps = Vs + AT_BKV * (D + 1);         // [64][65] ds
  float* mb = Ps + AT_BQ * (AT_BKV + 1);     // [64]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = blockIdx.x, q0 = qt * AT_BQ, head = blockIdx.y, b = blockIdx.z;
  const T* qh = q.at(b, head);
  const T* kh = k.at(b, head);
  const T* vh = v.at(b, head);
  const int32_t* mask_row = mask + (size_t)b * S;
  constexpr bool kMma = kIsBf16<T>;
  const uint32_t hk = site_key(drop, b, head);  // this block's site
  const size_t stat0 = ((size_t)b * N + head) * S;
  const int t_end = key_tiles_end(q0, S, causal_skip(mask_row, causal));
  const float* relh = kRel ? head_slab(rel, b, head, N, S) : nullptr;
  float* drelh = kRel ? head_slab(drel, b, head, N, S) : nullptr;

  load_head_tile(Qs, qh, q.ss, q0, S, D);
  load_head_tile(Cs, dout.at(b, head), dout.ss, q0, S, D);
  float m[4], inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    m[i] = r < S ? stat_m[stat0 + r] : 0.f;
    inv_l[i] = r < S ? 1.0f / stat_l[stat0 + r] : 0.f;
  }

  float s[4][4], dd[4][4];
  // pass A: delta_i = sum_j dp_ij p_ij
  float dl[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < t_end; t0 += AT_BKV) {
    load_head_tile(Ks, kh, k.ss, t0, S, D);
    load_head_tile(Vs, vh, v.ss, t0, S, D);
    load_mask_bias(mb, mask_row, t0, S);
    __syncthreads();
    tile_scores<kMma, kRel>(s, Qs, Ks, mb, tx, ty, D, scale, Ps, q0, t0, causal, relh, S);
    tile_dots<kMma>(dd, Cs, Vs, tx, ty, D, Ps);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((s[i][j] - m[i]) * kAttnLog2e) * inv_l[i];
        float dp = dd[i][j];
        if (drop.on)
          dp *= keep_scale_k(drop, hk,
                             (uint32_t)((q0 + ty + 16 * i) * S + t0 + tx + 16 * j));
        dl[i] += dp * p;
      }
    __syncthreads();
  }
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    delta[i] = half_warp_sum(dl[i]);
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < S) delta_out[stat0 + r] = delta[i];
  }

  // pass B: dq = T(ds) k
  float acc[4][DJ], co[DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = co[j][i] = 0.f;
  for (int t0 = 0; t0 < t_end; t0 += AT_BKV) {
    load_head_tile(Ks, kh, k.ss, t0, S, D);
    load_head_tile(Vs, vh, v.ss, t0, S, D);
    load_mask_bias(mb, mask_row, t0, S);
    __syncthreads();
    tile_scores<kMma, kRel>(s, Qs, Ks, mb, tx, ty, D, scale, Ps, q0, t0, causal, relh, S);
    tile_dots<kMma>(dd, Cs, Vs, tx, ty, D, Ps);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((s[i][j] - m[i]) * kAttnLog2e) * inv_l[i];
        float dp = dd[i][j];
        if (drop.on)
          dp *= keep_scale_k(drop, hk,
                             (uint32_t)((q0 + ty + 16 * i) * S + t0 + tx + 16 * j));
        const float ds = p * (dp - delta[i]);
        if constexpr (kRel) {  // dRel: the fp32 ds, before the rounding
          const int qr = q0 + ty + 16 * i, key = t0 + tx + 16 * j;
          if (qr < S && key < S) drelh[qr * S + key] = ds;
        }
        Ps[(ty + 16 * i) * (AT_BKV + 1) + tx + 16 * j] = round_to<T>(ds);
      }
    __syncthreads();
    if constexpr (kMma) {
      mma_acc_64xD<DJ>(co, Ps, AT_BKV + 1, 1, Ks, D + 1, 1, D);
    } else {
      const int kv_len = min(AT_BKV, S - t0);
      for (int c = 0; c < kv_len; ++c) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (AT_BKV + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float kv = Ks[c * (D + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], kv, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  if constexpr (kRel) {  // the key tiles causal_skip skipped: p = 0, dRel = 0
    for (int t0 = t_end; t0 < S; t0 += AT_BKV)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = q0 + ty + 16 * i, key = t0 + tx + 16 * j;
          if (qr < S && key < S) drelh[qr * S + key] = 0.f;
        }
  }
  if constexpr (kMma) {  // fragments -> the (ty, tx) layout, through Qs
    spill_64xD<DJ>(Qs, D + 1, co, D);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) acc[i][j] = Qs[(ty + 16 * i) * (D + 1) + d];
      }
  }

  T* dqh = dq.at(b, head);
  float colsum[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) colsum[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const float val = acc[i][j] * scale;
        dqh[r * dq.ss + d] = from_f<T>(val);
        colsum[j] += val;
      }
    }
  }
  if (part) {  // uniform over the block
    float* red = Ps;  // [16][D], free after the last barrier
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) red[ty * D + d] = colsum[j];
    }
    __syncthreads();
    if (tid < D) {
      float sum = 0.f;
      for (int t = 0; t < 16; ++t) sum += red[t * D + tid];
      part[((size_t)b * gridDim.x + qt) * 3 * N * D + head * D + tid] = sum;
    }
  }
}

// attn_bwd_dkv_kernel: one block per (key tile, head, batch element); loops
// over the query tiles; writes dk, dv and, with `part`, their columns' sums
// per tile (dk in columns N D .. 2 N D - 1, dv in 2 N D .. 3 N D - 1).
template <typename T, int DJ, bool kRel>
__global__ void __launch_bounds__(256)
attn_bwd_dkv_kernel(Heads<const T> q, Heads<const T> k, Heads<const T> v,
                    Heads<const T> dout, const int32_t* __restrict__ mask,
                    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                    const float* __restrict__ delta, Drop drop, Heads<T> dk,
                    Heads<T> dv, float* __restrict__ part, int S, int N, int D,
                    float scale, int causal, const float* __restrict__ rel) {
  extern __shared__ float smem[];
  float* Ks = smem;                          // [64][D + 1] key tile
  float* Vs = Ks + AT_BKV * (D + 1);
  float* Qs = Vs + AT_BKV * (D + 1);         // query tile
  float* Cs = Qs + AT_BQ * (D + 1);          // dO rows of the query tile
  float* Ss = Cs + AT_BQ * (D + 1);          // [64 q][65] T(ds)
  float* Ws = Ss + AT_BQ * (AT_BKV + 1);     // [64 q][65] T(p * keep)
  float* mb = Ws + AT_BQ * (AT_BKV + 1);     // [64]
  float* rm = mb + AT_BKV;                   // query-row max, 1/sum, delta
  float* rl = rm + AT_BQ;
  float* rd = rl + AT_BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kt = blockIdx.x, k0 = kt * AT_BKV, head = blockIdx.y, b = blockIdx.z;
  const T* qh = q.at(b, head);
  const T* doh = dout.at(b, head);
  const int32_t* mask_row = mask + (size_t)b * S;
  constexpr bool kMma = kIsBf16<T>;
  const uint32_t hk = site_key(drop, b, head);  // this block's site
  const size_t stat0 = ((size_t)b * N + head) * S;
  const float* relh = kRel ? head_slab(rel, b, head, N, S) : nullptr;

  load_head_tile(Ks, k.at(b, head), k.ss, k0, S, D);
  load_head_tile(Vs, v.at(b, head), v.ss, k0, S, D);
  load_mask_bias(mb, mask_row, k0, S);

  float ok[4][DJ], ov[4][DJ], ck[DJ][4], cv[DJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) ok[i][j] = ov[i][j] = ck[j][i] = cv[j][i] = 0.f;
  float s[4][4], dd[4][4];
  // the query tiles wholly before this key tile see none of it (the
  // mirror of key_tiles_end): their p and ds are 0 here
  const int q_begin = causal_skip(mask_row, causal) ? k0 : 0;
  for (int q0 = q_begin; q0 < S; q0 += AT_BQ) {
    load_head_tile(Qs, qh, q.ss, q0, S, D);
    load_head_tile(Cs, doh, dout.ss, q0, S, D);
    for (int r = tid; r < AT_BQ; r += 256) {
      const int t = q0 + r;
      rm[r] = t < S ? stat_m[stat0 + t] : 0.f;
      rl[r] = t < S ? 1.0f / stat_l[stat0 + t] : 0.f;
      rd[r] = t < S ? delta[stat0 + t] : 0.f;
    }
    __syncthreads();
    tile_scores<kMma, kRel>(s, Qs, Ks, mb, tx, ty, D, scale, Ss, q0, k0, causal, relh, S);
    tile_dots<kMma>(dd, Cs, Vs, tx, ty, D, Ss);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const float p = exp2f((s[i][j] - rm[qr]) * kAttnLog2e) * rl[qr];
        float keep = 1.f;
        if (drop.on)
          keep = keep_scale_k(drop, hk, (uint32_t)((q0 + qr) * S + k0 + kc));
        const float dp = drop.on ? dd[i][j] * keep : dd[i][j];
        Ss[qr * (AT_BKV + 1) + kc] = round_to<T>(p * (dp - rd[qr]));
        Ws[qr * (AT_BKV + 1) + kc] = round_to<T>(drop.on ? p * keep : p);
      }
    }
    __syncthreads();
    if constexpr (kMma) {
      // rows are keys, the contraction runs over the query tile (query
      // rows past the sequence have ds = p = 0 and zero q, dO rows)
      mma_acc_64xD<DJ>(ck, Ss, 1, AT_BKV + 1, Qs, D + 1, 1, D);
      mma_acc_64xD<DJ>(cv, Ws, 1, AT_BKV + 1, Cs, D + 1, 1, D);
    } else {
      const int q_len = min(AT_BQ, S - q0);
      for (int qr = 0; qr < q_len; ++qr) {
        float sv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sv[i] = Ss[qr * (AT_BKV + 1) + ty + 16 * i];
          wv[i] = Ws[qr * (AT_BKV + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float qv = Qs[qr * (D + 1) + d], cvv = Cs[qr * (D + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ok[i][j] = fmaf(sv[i], qv, ok[i][j]);
              ov[i][j] = fmaf(wv[i], cvv, ov[i][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if constexpr (kMma) {  // fragments -> the (ty, tx) layout, through Qs, Cs
    spill_64xD<DJ>(Qs, D + 1, ck, D);
    spill_64xD<DJ>(Cs, D + 1, cv, D);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          ok[i][j] = Qs[(ty + 16 * i) * (D + 1) + d];
          ov[i][j] = Cs[(ty + 16 * i) * (D + 1) + d];
        }
      }
  }

  T* dkh = dk.at(b, head);
  T* dvh = dv.at(b, head);
  float ksum[DJ], vsum[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) ksum[j] = vsum[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const float kvv = ok[i][j] * scale, vv = ov[i][j];
        dkh[r * dk.ss + d] = from_f<T>(kvv);
        dvh[r * dv.ss + d] = from_f<T>(vv);
        ksum[j] += kvv;
        vsum[j] += vv;
      }
    }
  }
  if (part) {  // uniform over the block
    float* red = Ss;  // [16][2 D], free after the last barrier
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        red[ty * 2 * D + d] = ksum[j];
        red[ty * 2 * D + D + d] = vsum[j];
      }
    }
    __syncthreads();
    if (tid < 2 * D) {
      float sum = 0.f;
      for (int t = 0; t < 16; ++t) sum += red[t * 2 * D + tid];
      const int col = tid < D ? N * D + head * D + tid : 2 * N * D + head * D + tid - D;
      part[((size_t)b * gridDim.x + kt) * 3 * N * D + col] = sum;
    }
  }
}

inline size_t attn_bwd_dq_smem_bytes(int D) {
  return sizeof(float) * (size_t)(4 * AT_BQ * (D + 1) + AT_BQ * (AT_BKV + 1) + AT_BKV);
}
inline size_t attn_bwd_dkv_smem_bytes(int D) {
  return sizeof(float) *
         (size_t)(4 * AT_BQ * (D + 1) + 2 * AT_BQ * (AT_BKV + 1) + AT_BKV + 3 * AT_BQ);
}

template <typename T, int DJ, bool kRel>
cudaError_t launch_attn_bwd(Heads<const T> q, Heads<const T> k, Heads<const T> v,
                            Heads<const T> dout, const int32_t* mask,
                            const float* stat_m, const float* stat_l, Drop drop,
                            float* delta, Heads<T> dq, Heads<T> dk, Heads<T> dv,
                            float* part, int B, int S, int N, int D, float scale,
                            int causal, const float* rel, float* drel,
                            cudaStream_t stream) {
  const dim3 grid(ceil_div(S, AT_BQ), N, B);
  size_t smem = attn_bwd_dq_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, DJ, kRel>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, DJ, kRel><<<grid, 256, smem, stream>>>(
      q, k, v, dout, mask, stat_m, stat_l, drop, delta, dq, part, S, N, D, scale, causal,
      rel, drel);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = attn_bwd_dkv_smem_bytes(D);
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T, DJ, kRel>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<T, DJ, kRel><<<grid, 256, smem, stream>>>(
      q, k, v, dout, mask, stat_m, stat_l, delta, drop, dk, dv, part, S, N, D, scale,
      causal, rel);
  return cudaGetLastError();
}

// dq, dk, dv of attention(q, k, v) for the output gradient dout, from the
// forward's row statistics; delta is [B, N, S] scratch, part may be null;
// with kRel the scores add rel and drel ([B, N, S, S] fp32) gets its gradient
template <typename T, bool kRel = false>
cudaError_t attn_bwd(Heads<const T> q, Heads<const T> k, Heads<const T> v,
                     Heads<const T> dout, const int32_t* mask, const float* stat_m,
                     const float* stat_l, Drop drop, float* delta, Heads<T> dq,
                     Heads<T> dk, Heads<T> dv, float* part, int B, int S, int N, int D,
                     float scale, int causal, cudaStream_t stream,
                     const float* rel = nullptr, float* drel = nullptr) {
#define B4R_AB(DJV)                                                                      \
  launch_attn_bwd<T, DJV, kRel>(q, k, v, dout, mask, stat_m, stat_l, drop, delta, dq, dk, \
                                dv, part, B, S, N, D, scale, causal, rel, drel, stream)
  switch (pow2_at_least(ceil_div(D, 16))) {
    case 1: return B4R_AB(1);
    case 2: return B4R_AB(2);
    case 4: return B4R_AB(4);
    case 8: return B4R_AB(8);
    default: return cudaErrorInvalidValue;
  }
#undef B4R_AB
}

}  // namespace b4r
