// Flash attention on Hopper's warpgroup tensor cores (bf16 operands): the
// K8 forward and the two K9 backward kernels of flash_attention.cu.
//
// One warpgroup (128 threads) per block; every tile is 64 rows of one head
// ([64][DP] bf16, DP = 64 or 128 the head dim D zero-padded, in hopper.cuh's
// swizzle). All threads fill the tiles with cp.async 16-byte copies from
// the strided [B, N, S, D] views (16-byte aligned base and strides; rows
// past S and columns past D are zero-filled, which is exact for both
// products), a two-stage ring keeping the next tile in flight while the
// products run on the current one.
//
// Products: scores X Y^T run as wgmma m64n64k16 with both operands K-major
// in shared memory (fp32 accumulators in registers); the second product of
// each step takes the rounded probabilities (or ds) straight from those
// registers as its A operand (hopper.cuh's to_frags), with B an MN-major
// tile (the same swizzled bytes read with the transpose bit).
//
// Every kernel forms a score with the same instruction, k-order and
// epilogue (fmaf(acc, scale, bias), -inf for keys past S), so the
// probabilities K9 recomputes from K8's row max and sum are K8's bit for
// bit; the dkv kernel forms S^T = K Q^T, whose entries are the same sums.
// The fused encoder layer (layer_hopper.cuh) runs the same kernels on its
// packed [B S, 3 H] qkv with two compile-time switches that K8/K9 leave off:
// kRel adds its fp32 relative bias after the pad and causal biases (and the
// dq kernel writes dRel), kPart writes the column sums of dq, dk and dv per
// tile (its qkv bias gradient). DK (default DP) is the contraction the score
// products run over: the layer's head dims up to 32 take DK = 32 of the
// DP = 64 tiles, whose zero-filled columns add exact zeros to every sum.
// DV (default DP) is the value width, for latent attention's values that
// are narrower than its queries and keys: v, o, dO and dv take [64][DV]
// tiles and DV wide accumulators, the dp = dO v^T product contracts over DV,
// while q, k, dq and dk keep the [64][DP] tiles (K8/K9 at DP = DK = 192,
// DV = 128; the value width is then exactly DV). With DV = DP every kernel
// is the code it was before.
// JAX's rounding points hold: p is normalised in fp32 before the keep scale
// and the rounding to bf16; dp = dd * keep is rounded before dp - delta
// (__fmul_rn, which nvcc never contracts into the following add). K8 tests
// each pair's dropout hash once and writes the result as one bit; K9 reads
// the bits (see kept_k).
#pragma once

#include "attention.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace b4r {
namespace hopper {

// Blocks an SM holds, which registers decide: at DP = 64 ptxas fits K8 in
// 128 registers and the K9 kernels in 168 (4 and 3 blocks, against 3 and 2
// at the 130-200 it takes unbounded); each warpgroup waits on its own
// products and barriers, and more of them per SM hide more of those waits.
template <int DP> constexpr int kFwdBlocks = DP == 64 ? 4 : 2;  // DP = 192: 2
template <int DP> constexpr int kBwdBlocks = DP == 64 ? 3 : 1;

// mask[t0 .. t0+63] (int32) into shared memory, 0 past the sequence
__device__ __forceinline__ void load_mask(uint32_t dst, const int32_t* mask_row, int t0,
                                          int S) {
  const int c = threadIdx.x, t = t0 + c;
  if (c < kRows) cp_async4(dst + 4 * c, t < S ? mask_row + t : mask_row, t < S ? 4 : 0);
}

// The score's epilogue, one law for every kernel: the pad bias kb of the key
// (-inf past the sequence, where the zero-filled rows give acc = 0), a
// second -1e9 for a key after its query when causal (so a row that sees
// only padding is uniform over keys j <= i). kDiag: the tile holds such a
// pair (causal, and its key tile starts at or after its query tile).
template <bool kDiag>
__device__ __forceinline__ float score(float acc, float scale, float kb, int key,
                                       int query) {
  const float bias = (kDiag && key > query) ? kb + kAttnNegMask : kb;
  return fmaf(acc, scale, bias);
}

// f(std::bool_constant<diag>): one body compiled with and without the
// causal comparisons
template <typename F> __device__ __forceinline__ void with_diag(bool diag, F&& f) {
  if (diag)
    f(std::true_type{});
  else
    f(std::false_type{});
}

__device__ __forceinline__ float key_bias(int32_t m, int key, int S) {
  return key < S ? (m > 0 ? 0.f : kAttnNegMask) : -INFINITY;
}

// s (queries as rows, keys as columns) -> scores, the key tile at t0 with
// its mask in mask_s
__device__ __forceinline__ void row_scores(float (&s)[32], const int32_t* mask_s, int t0,
                                           int row0, int S, float scale, bool diag) {
  const int tq = threadIdx.x & 3;
  with_diag(diag, [&](auto kDiag) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 mv = *reinterpret_cast<const int2*>(mask_s + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t0 + 8 * j + 2 * tq + e;
        const float kb = key_bias(e ? mv.y : mv.x, key, S);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[4 * j + 2 * h + e];
          x = score<decltype(kDiag)::value>(x, scale, kb, key, row0 + 8 * h);
        }
      }
    }
  });
}

// Rows row0, row0 + 8 of a [64 x DP] accumulator tile times mul into a head
// of out (rows >= S and columns >= D dropped).
template <int DP>
__device__ __forceinline__ void store_rows(bf16* head, int ss, const float (&acc)[DP / 2],
                                           int row0, int S, int D, float mul) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    bf16* p = head + row * ss;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col >= D) continue;
      const float x0 = acc[4 * j + 2 * h] * mul, x1 = acc[4 * j + 2 * h + 1] * mul;
      if (col + 1 < D && (reinterpret_cast<uintptr_t>(p + col) & 3) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        p[col] = __float2bfloat16_rn(x0);
        if (col + 1 < D) p[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// The relative bias rel[q0 .. q0+63][k0 .. k0+63] of a head's slab into the
// fp32 [64][kRelLd] block at dst (queries as rows; the padded stride keeps
// the dkv kernel's transposed reads free of bank conflicts), zero past S.
constexpr int kRelLd = kRows + 4;
__device__ __forceinline__ void load_rel_block(uint32_t dst, const float* relh, int q0,
                                               int k0, int S, int rel16) {
  const int tid = threadIdx.x;
  if (rel16) {
#pragma unroll
    for (int i = 0; i < kRows * kRows / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 4, c = idx & 15;
      const int q = q0 + r, key = k0 + 4 * c;
      const bool ok = q < S && key < S;  // S % 4 == 0: the whole chunk or none
      cp_async16(dst + (r * kRelLd + 4 * c) * 4, ok ? relh + q * S + key : relh, ok ? 16 : 0);
    }
  } else {
    for (int i = 0; i < kRows * kRows / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 6, c = idx & 63;
      const int q = q0 + r, key = k0 + c;
      const bool ok = q < S && key < S;
      cp_async4(dst + (r * kRelLd + c) * 4, ok ? relh + q * S + key : relh, ok ? 4 : 0);
    }
  }
}

// The fused layer's relative bias (kRel): the stage's block of rel
// (load_rel_block, queries as rows) added to the thread's scores (tile rows
// rl0, rl0 + 8), after the pad and causal biases. Queries and keys past the
// sequence were zero-filled: they add 0, as in the dkv kernel.
__device__ __forceinline__ void add_rel(float (&s)[32], const float* rb, int rl0) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* row = rb + (rl0 + 8 * h) * kRelLd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(row + 8 * j + 2 * tq);
      s[4 * j + 2 * h] += v.x;
      s[4 * j + 2 * h + 1] += v.y;
    }
  }
}

// dRel's row of this thread (query r < S) at keys key, key + 1: one 8-byte
// store where S is even, so that a quad writes whole 32-byte sectors
__device__ __forceinline__ void store_pair(float* row, int key, int S, float a, float b) {
  if ((S & 1) == 0 && key + 1 < S) {
    *reinterpret_cast<float2*>(row + key) = make_float2(a, b);
  } else {
    if (key < S) row[key] = a;
    if (key + 1 < S) row[key + 1] = b;
  }
}

// The fused layer's bias-gradient partials (kPart): out[d] = the sum over
// the tile's rows inside the sequence of acc * mul, column d < D, summed in
// a fixed order (quads, then the 4 warps through red, [4][DP] floats of
// shared memory no copy is writing).
template <int DP>
__device__ __forceinline__ void column_sums(const float (&acc)[DP / 2], float mul, int row0,
                                            int S, int D, float* red, float* out) {
  const int tq = threadIdx.x & 3, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may hold a previous call's sums still being read
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row0 + 8 * h < S) v += acc[4 * j + 2 * h + e] * mul;
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[warp * DP + 8 * j + 2 * tq + e] = v;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads)
    out[c] = ((red[c] + red[DP + c]) + red[2 * DP + c]) + red[3 * DP + c];
}

// Dropout keep bits. K8 tests each (query, key) pair's hash once (common.cuh's
// keep_scale_k law) and writes the results, one 32-bit word per thread and
// tile pair: word t of tile pair (qt, kt) holds, at bit 4 j + 2 h + e, the
// element K8's thread t holds there (query 64 qt + 16 (t / 32) + (t % 32) / 4
// + 8 h, key 64 kt + 8 j + 2 (t % 4) + e). K9 reads the words instead of
// hashing again (ops/dropout_bits.py tile_keep_bits is the plain packing).
__device__ __forceinline__ bool kept_k(const Drop& d, uint32_t hk, uint32_t counter) {
  return fmix32(hk ^ (counter * 0x9E3779B9u)) >= d.threshold;
}
// the first word of tile pair (qt, kt) of a head; `tiles` = ceil(S / 64)
__device__ __forceinline__ size_t bits_at(int b, int head, int N, int tiles, int qt,
                                          int kt) {
  return ((((size_t)b * N + head) * tiles + qt) * tiles + kt) * kThreads;
}
// one tile pair's 128 words (512 bytes) into shared memory, by warp 0
__device__ __forceinline__ void load_bits(uint32_t dst, const uint32_t* src) {
  if (threadIdx.x < 32) cp_async16(dst + 16 * threadIdx.x, src + 4 * threadIdx.x, 16);
}

// ---------------------------------------------------------------------------
// K8: one block per (64-query tile, head, batch element). The key tiles
// stream twice: pass 1 (items 0 .. n-1) finds each row's max m and sum l;
// pass 2 (items n .. 2n-1) recomputes the scores, forms
// p = T(exp(s - m) * (1 / l) * keep) in registers and accumulates p v.
// ---------------------------------------------------------------------------
template <int DP, bool kRel = false, int DK = DP, int DV = DP>
__global__ void __launch_bounds__(kThreads, kFwdBlocks<DP>)
flash_fwd_kernel(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                 const int32_t* __restrict__ mask, Heads<bf16> o,
                 float* __restrict__ stat_m, float* __restrict__ stat_l,
                 uint32_t* __restrict__ keep_bits, Drop drop, int S, int N, int D,
                 float scale, int causal, const float* __restrict__ rel, int rel16) {
  constexpr int kTile = tile_bytes(DP), kTileV = tile_bytes(DV);
  const int Dv = DV == DP ? D : DV;  // the value width
  uint8_t* sm = aligned_smem();
  const uint32_t Qs = smem_u32(sm), Ks = Qs + kTile, Vs = Ks + kStages * kTile,
                 Ms = Vs + kStages * kTileV, Rs = Ms + kStages * kRows * 4;
  const int32_t* mask_s = reinterpret_cast<const int32_t*>(sm + (Ms - Qs));
  const float* rel_s = reinterpret_cast<const float*>(sm + (Rs - Qs));  // kRel

  const int tid = threadIdx.x, tq = tid & 3;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int row0 = q0 + (tid >> 5) * 16 + ((tid & 31) >> 2);  // rows row0, row0 + 8
  const int32_t* mask_row = mask + (size_t)b * S;
  const int n = cdiv(key_tiles_end(q0, S, causal_skip(mask_row, causal)), kRows);
  const uint32_t hk = site_key(drop, b, head);
  const bf16* kh = k.at(b, head);
  const bf16* vh = v.at(b, head);
  const float* relh = kRel ? head_slab(rel, b, head, N, S) : nullptr;

  auto prefetch = [&](int item) {
    const int st = item % kStages, t0 = (item < n ? item : item - n) * kRows;
    load_tile<DP>(Ks + st * kTile, kh, k.ss, t0, S, D);
    if (item >= n) load_tile<DV>(Vs + st * kTileV, vh, v.ss, t0, S, Dv);
    load_mask(Ms + st * kRows * 4, mask_row, t0, S);
    if constexpr (kRel) load_rel_block(Rs + st * kRows * kRelLd * 4, relh, q0, t0, S, rel16);
  };
  load_tile<DP>(Qs, q.at(b, head), q.ss, q0, S, D);
  prefetch(0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float acc[DV / 2], s[32];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  for (int item = 0; item < 2 * n; ++item) {
    if (item + 1 < 2 * n) prefetch(item + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int st = item % kStages, t0 = (item < n ? item : item - n) * kRows;
    wgmma_fence();
    mma_nt<DK>(s, Qs, Ks + st * kTile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    row_scores(s, mask_s + st * kRows, t0, row0, S, scale, causal && t0 >= q0);
    if constexpr (kRel) add_rel(s, rel_s + st * kRows * kRelLd, row0 - q0);
    if (item < n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        const float m_new = fmaxf(m[h], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sum += ex2((s[4 * j + 2 * h + e] - m_new) * kAttnLog2e);
        l[h] = l[h] * ex2((m[h] - m_new) * kAttnLog2e) + quad_sum(sum);
        m[h] = m_new;
      }
      if (item == n - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          inv_l[h] = 1.0f / l[h];
          const int r = row0 + 8 * h;
          if (stat_m && tq == 0 && r < S) {
            const size_t at = ((size_t)b * N + head) * S + r;
            stat_m[at] = m[h];
            stat_l[at] = l[h];
          }
        }
      }
    } else {
      uint32_t kept = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = ex2((s[i] - m[h]) * kAttnLog2e) * inv_l[h];
            if (drop.on) {
              const bool keep = kept_k(drop, hk, (uint32_t)(row0 + 8 * h) * (uint32_t)S +
                                                     (uint32_t)(t0 + 8 * j + 2 * tq + e));
              p *= keep ? drop.scale : 0.f;
              kept |= (uint32_t)keep << i;
            }
            s[i] = p;
          }
      if (keep_bits)
        keep_bits[bits_at(b, head, N, gridDim.x, blockIdx.x, t0 / kRows) + tid] = kept;
      uint32_t a[4][4];
      to_frags(a, s);
      fence_frags(a);
      fence_regs(acc);
      wgmma_fence();
      mma_rs<DV>(acc, a, Vs + st * kTileV);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    }
    __syncthreads();
  }
  store_rows<DV>(o.at(b, head), o.ss, acc, row0, S, Dv, 1.f);
}

// ---------------------------------------------------------------------------
// K9, dq kernel: one block per (64-query tile, head, batch element); Q, dO
// resident, the key and value tiles stream twice. Pass A (items 0 .. n-1)
// sums JAX's delta = sum_j dp p per row; pass B (items n .. 2n-1) forms
// ds = T(p (dp - delta)) in registers and accumulates dq += ds k.
// ---------------------------------------------------------------------------
//
// The fused layer's variants: kRel adds its relative bias to the scores and
// writes dRel = p (dp - delta) in fp32 before the rounding (zeros in the key
// tiles causal_skip skips); kPart writes the dq columns' sums of the tile
// (part [B * tiles][3 N D], dq in the first N D columns).
template <int DP, bool kPart = false, bool kRel = false, int DK = DP, int DV = DP>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<DP>)
flash_bwd_dq_kernel(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                    Heads<const bf16> dout, const int32_t* __restrict__ mask,
                    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                    const uint32_t* __restrict__ keep_bits, Drop drop,
                    float* __restrict__ delta_out, Heads<bf16> dq, int S, int N, int D,
                    float scale, int causal, const float* __restrict__ rel, int rel16,
                    float* __restrict__ drel, float* __restrict__ part) {
  constexpr int kTile = tile_bytes(DP), kTileV = tile_bytes(DV);
  constexpr int DKV = DV == DP ? DK : DV;  // the dp = dO v^T contraction
  const int Dv = DV == DP ? D : DV;
  uint8_t* sm = aligned_smem();
  const uint32_t Qs = smem_u32(sm), Os = Qs + kTile, Ks = Os + kTileV,
                 Vs = Ks + kStages * kTile, Ms = Vs + kStages * kTileV,
                 Bs = Ms + kStages * kRows * 4;
  const int32_t* mask_s = reinterpret_cast<const int32_t*>(sm + (Ms - Qs));
  const uint32_t* bits_s = reinterpret_cast<const uint32_t*>(sm + (Bs - Qs));
  const uint32_t Rs = Bs + kStages * kThreads * 4;
  const float* rel_s = reinterpret_cast<const float*>(sm + (Rs - Qs));  // kRel

  const int tid = threadIdx.x, tq = tid & 3;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int row0 = q0 + (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int32_t* mask_row = mask + (size_t)b * S;
  const int n = cdiv(key_tiles_end(q0, S, causal_skip(mask_row, causal)), kRows);
  const size_t stat0 = ((size_t)b * N + head) * S;
  const bf16* kh = k.at(b, head);
  const bf16* vh = v.at(b, head);
  const float* relh = kRel ? head_slab(rel, b, head, N, S) : nullptr;
  float* drelh = kRel ? head_slab(drel, b, head, N, S) : nullptr;

  auto prefetch = [&](int item) {
    const int st = item % kStages, kt = item < n ? item : item - n, t0 = kt * kRows;
    load_tile<DP>(Ks + st * kTile, kh, k.ss, t0, S, D);
    load_tile<DV>(Vs + st * kTileV, vh, v.ss, t0, S, Dv);
    load_mask(Ms + st * kRows * 4, mask_row, t0, S);
    if (drop.on)
      load_bits(Bs + st * kThreads * 4,
                keep_bits + bits_at(b, head, N, gridDim.x, blockIdx.x, kt));
    if constexpr (kRel) load_rel_block(Rs + st * kRows * kRelLd * 4, relh, q0, t0, S, rel16);
  };
  load_tile<DP>(Qs, q.at(b, head), q.ss, q0, S, D);
  load_tile<DV>(Os, dout.at(b, head), dout.ss, q0, S, Dv);
  prefetch(0);
  cp_async_commit();

  float m[2], inv_l[2], dl[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    m[h] = r < S ? stat_m[stat0 + r] : 0.f;
    inv_l[h] = r < S ? 1.0f / stat_l[stat0 + r] : 0.f;
  }
  float acc[DP / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  for (int item = 0; item < 2 * n; ++item) {
    if (item + 1 < 2 * n) prefetch(item + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int st = item % kStages, t0 = (item < n ? item : item - n) * kRows;
    wgmma_fence();
    mma_nt<DK>(s, Qs, Ks + st * kTile);
    mma_nt<DKV>(dp, Os, Vs + st * kTileV);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    row_scores(s, mask_s + st * kRows, t0, row0, S, scale, causal && t0 >= q0);
    if constexpr (kRel) add_rel(s, rel_s + st * kRows * kRelLd, row0 - q0);
    // p and dp = dO v^T keep of element i (row row0 + 8 h); dp is rounded
    // before it is used (__fmul_rn: never contracted into a later add)
    const uint32_t kept = drop.on ? bits_s[st * kThreads + tid] : 0u;
    auto p_dp = [&](int i, int h, float& p, float& d) {
      p = ex2((s[i] - m[h]) * kAttnLog2e) * inv_l[h];
      d = dp[i];
      if (drop.on) d = __fmul_rn(d, (kept >> i) & 1u ? drop.scale : 0.f);
    };
    if (item < n) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p, d;
            p_dp(4 * j + 2 * h + e, h, p, d);
            dl[h] += __fmul_rn(d, p);
          }
      if (item == n - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          delta[h] = quad_sum(dl[h]);
          const int r = row0 + 8 * h;
          if (tq == 0 && r < S) delta_out[stat0 + r] = delta[h];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p, d;
            p_dp(i, h, p, d);
            s[i] = p * (d - delta[h]);
          }
      if constexpr (kRel) {  // dRel: the fp32 ds, before the rounding
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          if (r >= S) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            store_pair(drelh + r * S, t0 + 8 * j + 2 * tq, S, s[4 * j + 2 * h],
                       s[4 * j + 2 * h + 1]);
        }
      }
      uint32_t a[4][4];
      to_frags(a, s);
      fence_frags(a);
      fence_regs(acc);
      wgmma_fence();
      mma_rs<DP>(acc, a, Ks + st * kTile);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    }
    __syncthreads();
  }
  if constexpr (kRel) {  // the key tiles causal_skip skipped: p = 0, dRel = 0
    for (int t0 = n * kRows; t0 < S; t0 += kRows)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r >= S) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) store_pair(drelh + r * S, t0 + 8 * j + 2 * tq, S, 0.f, 0.f);
      }
  }
  store_rows<DP>(dq.at(b, head), dq.ss, acc, row0, S, D, scale);
  if constexpr (kPart) {
    cp_async_wait<0>();
    column_sums<DP>(acc, scale, row0, S, D, reinterpret_cast<float*>(sm),
                    part + ((size_t)b * gridDim.x + blockIdx.x) * 3 * N * D + head * D);
  }
}

// ---------------------------------------------------------------------------
// K9, dkv kernel: one block per (64-key tile, head, batch element); K, V
// resident, the query and dO tiles and the query rows' m, 1 / l and delta
// stream. Keys are the M dimension: S^T = K Q^T and dP^T = V dO^T, so
// T(p keep)^T and T(ds)^T come out in the A-register layout of
// dv += T(p keep)^T dO and dk += T(ds)^T q (dO and Q read MN-major).
// ---------------------------------------------------------------------------
//
// The fused layer's variants: kRel stages each query tile's [64 queries][64
// keys] block of the relative bias through shared memory by cp.async (16-byte
// copies when rel16: S a multiple of 4 and a 16-byte aligned slab; else
// 4-byte ones) and adds it to the transposed scores; kPart writes the dk and
// dv columns' sums of the tile (columns N D + head D .. and 2 N D + head D ..
// of part).
template <int DP, bool kPart = false, bool kRel = false, int DK = DP, int DV = DP>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<DP>)
flash_bwd_dkv_kernel(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                     Heads<const bf16> dout, const int32_t* __restrict__ mask,
                     const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                     const float* __restrict__ delta,
                     const uint32_t* __restrict__ keep_bits, Drop drop, Heads<bf16> dk,
                     Heads<bf16> dv, int S, int N, int D, float scale, int causal,
                     const float* __restrict__ rel, int rel16, float* __restrict__ part) {
  constexpr int kTile = tile_bytes(DP), kTileV = tile_bytes(DV);
  constexpr int DKV = DV == DP ? DK : DV;  // the dP^T = V dO^T contraction
  const int Dv = DV == DP ? D : DV;
  uint8_t* sm = aligned_smem();
  const uint32_t Ks = smem_u32(sm), Vs = Ks + kTile, Qs = Vs + kTileV,
                 Os = Qs + kStages * kTile;
  // [kStages][3][64]: the streamed query rows' m, 1 / l, delta; then
  // [kStages][128] keep-bit words
  float* rows_s =
      reinterpret_cast<float*>(sm + kTile + kTileV + kStages * (kTile + kTileV));
  const uint32_t* bits_s =
      reinterpret_cast<const uint32_t*>(rows_s + kStages * 3 * kRows);
  const uint32_t Bs = smem_u32(bits_s);
  // kRel: [kStages][64 queries][kRelLd] fp32 blocks of rel
  const uint32_t Rs = Bs + kStages * kThreads * 4;
  const float* rel_s = reinterpret_cast<const float*>(sm + (Rs - Ks));

  const int tid = threadIdx.x, tq = tid & 3, g = (tid & 31) >> 2;
  const int k0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const float* relh = kRel ? head_slab(rel, b, head, N, S) : nullptr;
  const int key0 = k0 + (tid >> 5) * 16 + g;  // keys key0, key0 + 8
  const int32_t* mask_row = mask + (size_t)b * S;
  // the query tiles wholly before this key tile see none of it (the mirror
  // of key_tiles_end): their p and ds are 0 here
  const int qb = causal_skip(mask_row, causal) ? k0 : 0;
  const int n = cdiv(S - qb, kRows);
  const size_t stat0 = ((size_t)b * N + head) * S;
  const bf16* qh = q.at(b, head);
  const bf16* oh = dout.at(b, head);

  float kb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    kb[h] = key_bias(key < S ? mask_row[key] : 0, key, S);
  }
  auto prefetch = [&](int item) {
    const int st = item % kStages, t0 = qb + item * kRows;
    load_tile<DP>(Qs + st * kTile, qh, q.ss, t0, S, D);
    load_tile<DV>(Os + st * kTileV, oh, dout.ss, t0, S, Dv);
    if (drop.on)
      load_bits(Bs + st * kThreads * 4,
                keep_bits + bits_at(b, head, N, gridDim.x, t0 / kRows, blockIdx.x));
    if constexpr (kRel) load_rel_block(Rs + st * kRows * kRelLd * 4, relh, t0, k0, S, rel16);
  };
  // query row stats of an item: plain loads into registers, stored into
  // the item's stage (1 / l formed once per row) after the current step
  float rm = 0.f, rl = 0.f, rd = 0.f;
  auto fetch = [&](int item) {
    const int t = qb + item * kRows + tid;
    if (tid < kRows && t < S) {
      rm = stat_m[stat0 + t];
      rl = 1.0f / stat_l[stat0 + t];
      rd = delta[stat0 + t];
    } else {
      rm = rl = rd = 0.f;
    }
  };
  auto stash = [&](int item) {
    float* r = rows_s + (item % kStages) * 3 * kRows;
    if (tid < kRows) {
      r[tid] = rm;
      r[kRows + tid] = rl;
      r[2 * kRows + tid] = rd;
    }
  };
  load_tile<DP>(Ks, k.at(b, head), k.ss, k0, S, D);
  load_tile<DV>(Vs, v.at(b, head), v.ss, k0, S, Dv);
  prefetch(0);
  cp_async_commit();
  fetch(0);
  stash(0);

  float dk_acc[DP / 2], dv_acc[DV / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  for (int item = 0; item < n; ++item) {
    if (item + 1 < n) {
      prefetch(item + 1);
      fetch(item + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int st = item % kStages, q0 = qb + item * kRows;
    wgmma_fence();
    mma_nt<DK>(s, Ks, Qs + st * kTile);
    mma_nt<DKV>(dp, Vs, Os + st * kTileV);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    const float* r = rows_s + st * 3 * kRows;
    const float* rb = rel_s + st * kRows * kRelLd + (key0 - k0);
    // This thread's elements as K8 held them (the transpose of its layout):
    // element (j, h, e) is bit 4 (2 warp + h) + 2 (j % 2) + g % 2 of word
    // 32 (j / 2) + 8 tq + 4 e + g / 2.
    uint32_t kept[4][2] = {};
    if (drop.on)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          kept[jj][e] = bits_s[st * kThreads + 32 * jj + 8 * tq + 4 * e + (g >> 1)] >>
                        (8 * (tid >> 5) + (g & 1));
    with_diag(causal && k0 >= q0, [&](auto kDiag) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 mv = *reinterpret_cast<const float2*>(r + c);
        const float2 lv = *reinterpret_cast<const float2*>(r + kRows + c);
        const float2 dl2 = *reinterpret_cast<const float2*>(r + 2 * kRows + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int query = q0 + c + e;
          const float mq = e ? mv.y : mv.x, iq = e ? lv.y : lv.x, dl = e ? dl2.y : dl2.x;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e, key = key0 + 8 * h;
            float sv = score<decltype(kDiag)::value>(s[i], scale, kb[h], key, query);
            if constexpr (kRel) sv += rb[(c + e) * kRelLd + 8 * h];
            const float p = ex2((sv - mq) * kAttnLog2e) * iq;
            float keep = 1.f, d = dp[i];
            if (drop.on) {
              keep = (kept[j >> 1][e] >> (4 * h + 2 * (j & 1))) & 1u ? drop.scale : 0.f;
              d = __fmul_rn(d, keep);
            }
            s[i] = drop.on ? p * keep : p;
            dp[i] = p * (d - dl);
          }
        }
      }
    });
    uint32_t ap[4][4], as[4][4];
    to_frags(ap, s);
    to_frags(as, dp);
    fence_frags(ap);
    fence_frags(as);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    mma_rs<DV>(dv_acc, ap, Os + st * kTileV);
    mma_rs<DP>(dk_acc, as, Qs + st * kTile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if (item + 1 < n) stash(item + 1);
    __syncthreads();
  }
  store_rows<DP>(dk.at(b, head), dk.ss, dk_acc, key0, S, D, scale);
  store_rows<DV>(dv.at(b, head), dv.ss, dv_acc, key0, S, Dv, 1.f);
  if constexpr (kPart) {
    cp_async_wait<0>();
    float* out = part + ((size_t)b * gridDim.x + blockIdx.x) * 3 * N * D + head * D;
    float* red = reinterpret_cast<float*>(sm);
    column_sums<DP>(dk_acc, scale, key0, S, D, red, out + N * D);
    column_sums<DV>(dv_acc, 1.f, key0, S, D, red, out + 2 * N * D);
  }
}

// ---------------------------------------------------------------------------
// launches (ceil(S / 64), N, B) blocks of kThreads
// ---------------------------------------------------------------------------
// the kRel variants' staged blocks of the relative bias
inline size_t rel_smem(bool rel) { return rel ? (size_t)kStages * kRows * kRelLd * 4 : 0; }
// dv: the value width (default dp)
inline size_t fwd_smem(int dp, bool rel = false, int dv = 0) {
  dv = dv ? dv : dp;
  return 1024 + (size_t)tile_bytes(dp) * (1 + kStages) + (size_t)tile_bytes(dv) * kStages +
         kStages * kRows * 4 + rel_smem(rel);
}
inline size_t dq_smem(int dp, bool rel = false, int dv = 0) {
  dv = dv ? dv : dp;
  return 1024 + (size_t)(tile_bytes(dp) + tile_bytes(dv)) * (1 + kStages) +
         kStages * kRows * 4 + kStages * kThreads * 4 + rel_smem(rel);
}
inline size_t dkv_smem(int dp, bool rel = false, int dv = 0) {
  dv = dv ? dv : dp;
  return 1024 + (size_t)(tile_bytes(dp) + tile_bytes(dv)) * (1 + kStages) +
         kStages * 3 * kRows * 4 + kStages * kThreads * 4 + rel_smem(rel);
}

template <int DP, int DV = DP>
cudaError_t forward(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                    const int32_t* mask, Heads<bf16> o, float* stat_m, float* stat_l,
                    uint32_t* keep_bits, Drop drop, int B, int S, int N, int D,
                    float scale, int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem(DP, false, DV);
  cudaError_t err = allow_smem(flash_fwd_kernel<DP, false, DP, DV>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DP, false, DP, DV><<<dim3(ceil_div(S, kRows), N, B), kThreads, smem, stream>>>(
      q, k, v, mask, o, stat_m, stat_l, keep_bits, drop, S, N, D, scale, causal, nullptr, 0);
  return cudaGetLastError();
}

template <int DP, int DV = DP>
cudaError_t backward(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                     Heads<const bf16> dout, const int32_t* mask, const float* stat_m,
                     const float* stat_l, const uint32_t* keep_bits, Drop drop,
                     float* delta, Heads<bf16> dq,
                     Heads<bf16> dk, Heads<bf16> dv, int B, int S, int N, int D,
                     float scale, int causal, cudaStream_t stream) {
  const dim3 grid(ceil_div(S, kRows), N, B);
  size_t smem = dq_smem(DP, false, DV);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<DP, false, false, DP, DV>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP, false, false, DP, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, mask, stat_m, stat_l, keep_bits, drop, delta, dq, S, N, D, scale,
      causal, nullptr, 0, nullptr, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = dkv_smem(DP, false, DV);
  if ((err = allow_smem(flash_bwd_dkv_kernel<DP, false, false, DP, DV>, smem)) != cudaSuccess)
    return err;
  flash_bwd_dkv_kernel<DP, false, false, DP, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, mask, stat_m, stat_l, delta, keep_bits, drop, dk, dv, S, N, D, scale,
      causal, nullptr, 0, nullptr);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace b4r
