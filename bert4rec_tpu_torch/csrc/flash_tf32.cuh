// fp32 flash attention on Hopper's tensor cores in 3xTF32 (sm_90a): K8 and
// K9 of bert4rec_tpu/ops/flash_attention.py (_fwd_kernel, launched by
// _forward; _bwd_kernel, launched by _backward through _flash_bwd) for every
// fp32 launch whose head dim is a multiple of 8 and at most 64
// (ops/flash_attention.py flash_route "tf32"; flash_attention.cu sends the
// rest to attention.cuh's SIMT tiles).
//
// What it computes is flash_attention.cu's function over strided [B, N, S, D]
// views (Heads): s = q k^T scale + (mask > 0 ? 0 : -1e9) [+ (key > query ?
// -1e9 : 0)], a key past S -inf; p = exp(s - max) / sum; o = (p keep) v; the
// backward's dv = (p keep)^T dO, ds = p (dO v^T keep - delta), dq = ds k
// scale, dk = ds^T q scale. The dropout keep is common.cuh's counter hash at
// site `head`, counter query * S + key, redrawn wherever it is needed (no keep
// bits stored). Two departures from the SIMT kernels' rounding order, equal
// in exact arithmetic: the forward scales the unnormalised exponentials by
// keep after they join the row sum and divides o by the sum at the end (an
// online softmax, one pass); and the dq kernel forms ds with flash
// attention's delta0 = dO . o, known before its one pass over the keys,
// while it sums JAX's delta = sum_j dp_ij keep_ij p_ij beside, then corrects
// dq by (delta - delta0) sum_j p_ij k_j; the dk / dv kernel reads JAX's
// delta. delta0 and delta differ in rounding by ~2^-21 |dp|: left in, a row
// whose probability is all on one key (a sequence of length 1) got gradients
// of that size where the plain version's are exactly 0 (dk at S = 1,100 read
// 1.5e-4 of its scale); corrected, they are 0 to ~1e-13.
//
// 3xTF32 (tf32.cuh): each fp32 operand is split into hi = cvt.rna.tf32(v)
// and lo = cvt.rna.tf32(v - hi), and a b accumulates lo_a hi_b + hi_a lo_b,
// then hi_a hi_b, per 8-deep k-block, in fp32 on wgmma .tf32. wgmma reads
// .tf32 operands from shared memory K-major only, so the products whose
// contraction runs along a tile's rows (o += p v, dq += ds k, dv += p^T dO,
// dk += ds^T q) take their A operand (p, ds) from the registers and a
// transposed, split copy of the streamed tile as B (each 8 keys' even ones
// first, the register fragments' order: tf32.cuh kpos).
//
// Kernels (tiles of 64 rows x DP columns, DP = 32 or 64, in 32-column panels
// of the 128-byte swizzle; every copy a 16-byte cp.async; the thread that
// copied a chunk splits it, so a raw stage is refilled without a barrier):
//   flash_fwd_tf32_kernel  two warpgroups per (128-query block, head,
//                          sequence), ONE pass over the key tiles with an
//                          online softmax in registers. Each warpgroup
//                          holds its 64 query rows' A fragments split in
//                          registers (64 at DP = 64); both multiply every
//                          key tile, split once into a two-stage ring of
//                          k hi / lo and v^T hi / lo, so each k / v tile
//                          crosses L2 once per 128 queries. A step: s = q
//                          k^T issued; tile t + 2's copies into the raw
//                          stage tile t left; tile t + 1 split while the
//                          product runs; the softmax; p v with p split in
//                          the registers; one block barrier. Saves
//                          stat_m (the row's max of the biased scores) and
//                          stat_l (sum_j exp(s_j - stat_m)), the SIMT
//                          kernels' convention, from which K9 recomputes p.
//   flash_dq_tf32_kernel   one warpgroup per (64-query tile, head,
//                          sequence): delta0 = dO . o per row (a warp a row,
//                          coalesced), then over the key tiles s = q k^T, dp
//                          = dO v^T, ds0 = p (dp keep - delta0), dq0 += ds0
//                          k and pk += p k (k^T split as B), JAX's delta
//                          summed on the CUDA cores; at the end dq = dq0 -
//                          (delta - delta0) pk, and delta written.
//   flash_dkv_tf32_kernel  kDkvWgs warpgroups per (64 kDkvWgs keys, head,
//                          sequence), over the query tiles: s^T = k q^T (the
//                          dq kernel's three passes in its order, so the
//                          recomputed scores match), dp^T = v dO^T, dv +=
//                          (p keep)^T dO, dk += ds^T q. Each warpgroup keeps
//                          its keys' k and v raw in shared memory and splits
//                          their A fragments at each use; the warpgroups
//                          share each query tile's q, dO and their
//                          transposes, split once.
// Every long sum (o, dq over the key tiles; dk, dv over the query tiles)
// adds one tile's product at a time on the CUDA cores (tile_product). No
// float atomics: two runs give the same bits. Causal launches skip the
// key tiles wholly after a query tile (and, in the dk / dv kernel, the
// query tiles wholly before a key tile) where attention.cuh causal_skip says
// that is exact; a warpgroup skips a tile its own rows need not see.
//
// Bound at the main path's shape (B N = 384 heads, S = 512, D = 64): K8 4 B
// N S^2 D = 25.8 GFLOP, K9 51.5 GFLOP; 3xTF32 does three tensor-core
// products for each, so at the H100 SXM's 495 TFLOP/s of TF32 they run at
// most at 165 TFLOP/s: 0.156 and 0.312 ms, against 201 / 352 MB of fp32
// operands (0.060 / 0.105 ms at 3.35 TB/s). Bound by operations; the scores
// are formed once forward, twice backward (not counted). Times in PERF.md.
//
// Layout rule (checked by the wrapper before any launch, and again here):
// q, k, v, o and dO have a 16-byte aligned base and batch, head and sequence
// strides; the outputs are the wrapper's own allocations.
#pragma once

#include "attention.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace b4r {
namespace flash_tf32 {

using namespace hopper;
using namespace tf32;

constexpr int kMaxHeadDim = 64;   // the route's head dims: multiples of 8 up to this
constexpr int kDqWgs = 2;         // the dq kernel's warpgroups (64 queries each)
constexpr int kDkvWgs = 2;        // the dk / dv kernel's warpgroups (64 keys each)

inline bool takes(int D) { return D % 8 == 0 && D > 0 && D <= kMaxHeadDim; }

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------
// rows r0 .. r0 + 63 of one head ([S, D], row stride ss) into the raw
// [64][DP] tile at dst, by the NT threads (t this thread's index among them)
template <int DP, int NT>
__device__ __forceinline__ void copy_rows(int t, uint32_t dst, const float* src, int ss, int r0,
                                          int S, int D) {
#pragma unroll
  for (int p = 0; p < DP / 32; ++p) copy_panel_t<64, NT>(t, dst + p * kPanel, src, ss, r0, S, 32 * p, D);
}

// the keys' additive mask bias of the key tile at t0 (-inf past S)
__device__ __forceinline__ float key_bias(const int32_t* mask_row, int key, int S) {
  return key < S ? (mask_row[key] > 0 ? 0.f : kAttnNegMask) : -INFINITY;
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------
// acc = A B over the 64 keys (or queries) of one tile, in a zeroed
// accumulator, waited for. The long sums (over S keys or queries) add these
// per-tile products on the CUDA cores, as loss_tf32.cuh does: wgmma's fp32
// accumulation drifts over long runs (over K7's 42k-entry sweep it moved
// dh by 1.7e-4 of its scale); a tile's 24 steps keep it to rounding.
template <int DP>
__device__ __forceinline__ void tile_product(float (&acc)[DP / 2], const uint32_t (&hi)[8][4],
                                             const uint32_t (&lo)[8][4], uint32_t bt) {
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
  mma3_frags<DP>(acc, hi, lo, bt);
  wgmma_commit();
  wgmma_wait_n<0>();
  fence_regs(acc);
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------
struct FwdArgs {
  Heads<const float> q, k, v;
  const int32_t* mask;
  Heads<float> o;
  float *stat_m, *stat_l;  // [B, N, S], or null
  Drop drop;
  int S, N, D, causal;
  float scale;
};

template <int DP>
struct FwdShape {
  static constexpr int kK = 2 * kTileQ<DP>;   // one stage of k hi | lo
  static constexpr int kV = 2 * kTileT<DP>;  // one stage of v^T hi | lo
  static constexpr int kRaw = 2 * kTileQ<DP>; // one stage of raw k | v
  // two stages of each, then the stages' key mask bias; q's 128 raw rows
  // land in k's second stage before the loop
  static constexpr int kKo = 0, kVo = 2 * kK, kRo = kVo + 2 * kV, kMo = kRo + 2 * kRaw;
  static constexpr size_t kSmem = 1024 + (size_t)kMo + 2 * 64 * 4;
  static_assert(kSmem <= 232448, "a block's shared memory");
  static_assert(2 * kTileQ<DP> <= kK, "q's raw rows fit one stage of k");
};

// kTrain (a launch that saves or draws dropout, a compile-time switch):
// dropout on p where drop.on, the row statistics where stat_m is non-null
template <int DP, bool kTrain>
__global__ void __launch_bounds__(256, 1) flash_fwd_tf32_kernel(FwdArgs a) {
  using L = FwdShape<DP>;
  constexpr int NT = 256;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);
  float* mb = reinterpret_cast<float*>(sm + L::kMo);  // [2][64]
  const int tid = threadIdx.x, wg = tid >> 7, tq = tid & 3, rloc = frag_row();
  const int qb = blockIdx.x * 128, q0 = qb + 64 * wg, head = blockIdx.y, b = blockIdx.z;
  const int S = a.S, D = a.D;
  const float* qh = a.q.at(b, head);
  const float* kh = a.k.at(b, head);
  const float* vh = a.v.at(b, head);
  const int32_t* mask_row = a.mask + (size_t)b * S;
  const int skip = causal_skip(mask_row, a.causal);
  const int nt = cdiv(key_tiles_end(qb + 64, S, skip), 64);  // the block's key tiles
  const int my_end = q0 < S ? key_tiles_end(q0, S, skip) : 0;  // this warpgroup's
  uint32_t hk = 0;
  if constexpr (kTrain) hk = site_key(a.drop, b, head);

  auto fetch = [&](int t) {  // key tile t's raw k and v into raw stage t % 2
    const uint32_t st = base + L::kRo + (t & 1) * L::kRaw;
    copy_rows<DP, NT>(tid, st, kh, a.k.ss, 64 * t, S, D);
    copy_rows<DP, NT>(tid, st + kTileQ<DP>, vh, a.v.ss, 64 * t, S, D);
  };
  auto split = [&](int t) {  // this thread's chunks of key tile t into stage t % 2
    const uint8_t* raw = sm + L::kRo + (t & 1) * L::kRaw;
    split_tile<DP, NT, true, false>(tid, raw, sm + L::kKo + (t & 1) * L::kK, nullptr);
    split_tile<DP, NT, false, true>(tid, raw + kTileQ<DP>, nullptr, sm + L::kVo + (t & 1) * L::kV);
    if (tid < 64) mb[(t & 1) * 64 + tid] = key_bias(mask_row, 64 * t + tid, S);
  };

  // q's 128 rows raw into k's second stage, key tiles 0 and 1 into the raw
  // stages; each warpgroup reads its 64 rows as split A fragments
  const uint32_t qraw = base + L::kKo + L::kK;
#pragma unroll
  for (int w = 0; w < 2; ++w) copy_rows<DP, NT>(tid, qraw + w * kTileQ<DP>, qh, a.q.ss, qb + 64 * w, S, D);
  cp_async_commit();
  fetch(0);
  cp_async_commit();
  if (nt > 1) fetch(1);
  cp_async_commit();
  cp_async_wait<1>();  // q and tile 0
  __syncthreads();
  uint32_t qhi[DP / 8][4], qlo[DP / 8][4];
#pragma unroll
  for (int kb = 0; kb < DP / 8; ++kb)
    frag_rows(qhi[kb], qlo[kb], sm + L::kKo + L::kK + wg * kTileQ<DP>, kb);
  split(0);
  fence_async_smem();
  __syncthreads();  // tile 0 split, q read: k's second stage is free

  float o[DP / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int t0 = 64 * t;
    const bool mine = t0 < my_end;  // uniform over the warpgroup
    const uint32_t kst = base + L::kKo + (t & 1) * L::kK;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    if (mine) {  // s = q k^T
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < DP / 8; ++kb)
        mma3_rs<64>(s, qhi[kb], qlo[kb], bdesc(kst, 64, kb), bdesc(kst + kTileQ<DP>, 64, kb));
      wgmma_commit();
    }
    // while it runs: tile t + 2's copies into the raw stage this thread
    // split tile t from, and tile t + 1 split into the other stage
    if (t + 2 < nt) fetch(t + 2);
    cp_async_commit();
    if (t + 1 < nt) {
      cp_async_wait<1>();
      split(t + 1);
      fence_async_smem();
    }
    if (mine) {
      wgmma_wait_n<0>();
      fence_regs(s);
      const float* bt = mb + (t & 1) * 64;
      // scale, biases, online max and sum; p = exp(s - m) keep in place of s
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
            const float bm = bt[kl];
            const float bias = (a.causal && key > q) ? bm + kAttnNegMask : bm;
            const float v = (bm == -INFINITY) ? -INFINITY : s[4 * j + 2 * h + e] * a.scale + bias;
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
              if (a.drop.on && q < S && key < S)
                p *= keep_scale_k(a.drop, hk, (uint32_t)(q * S + key));
            }
            s[4 * j + 2 * h + e] = p;
          }
        l[h] = l[h] * alpha[h] + sum;
        m[h] = mn;
      }
      // o = o alpha + p v: p's fragments from the registers, v^T the B
      // tile, the tile's product in an accumulator of its own and added
      // on the CUDA cores (tile_product)
      uint32_t ph[8][4], pl[8][4];
      to_frags_tf32(ph, pl, s);
      float pv[DP / 2];
      tile_product<DP>(pv, ph, pl, base + L::kVo + (t & 1) * L::kV);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * j + 2 * h] = o[4 * j + 2 * h] * alpha[h] + pv[4 * j + 2 * h];
          o[4 * j + 2 * h + 1] = o[4 * j + 2 * h + 1] * alpha[h] + pv[4 * j + 2 * h + 1];
        }
    }
    __syncthreads();  // tile t + 1 split by all; stage t % 2 is free
  }
  cp_async_wait<0>();

  float* oh = a.o.at(b, head);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + rloc + 8 * h;
    const float lsum = quad_sum(l[h]);
    const float inv = 1.0f / lsum;
    if (q >= S) continue;
    if (kTrain && a.stat_m && tq == 0) {
      const size_t at_q = ((size_t)b * a.N + head) * S + q;
      a.stat_m[at_q] = m[h];
      a.stat_l[at_q] = lsum;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (d < D)
        *reinterpret_cast<float2*>(oh + (size_t)q * a.o.ss + d) =
            make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------
struct BwdArgs {
  Heads<const float> q, k, v, o, dout;
  const int32_t* mask;
  const float *stat_m, *stat_l;  // [B, N, S], the forward's
  float* delta;                  // [B, N, S], JAX's, written by the dq kernel
  Heads<float> dq, dk, dv;
  Drop drop;
  int S, N, D, causal;
  float scale;
};

// the softmax backward's probability at one score, recomputed from the
// forward's statistics as exp(s - stat_m) / stat_l, and its dropout keep;
// the callers form p keep (for dv) and ds = p (dp keep - delta), dp keep
// rounded by __fmul_rn in both kernels (nvcc would fuse it into the
// subtraction in one of them: a row whose probability is one key's then
// gets ds = 0 in the dq kernel and a rounding error in the dk / dv one)
struct ScoreProb {
  float p, keep;
};
__device__ __forceinline__ ScoreProb score_prob(float s, float bm, int q, int key,
                                                const BwdArgs& a, float m, float inv_l,
                                                uint32_t hk) {
  const float bias = (a.causal && key > q) ? bm + kAttnNegMask : bm;
  const float v = (bm == -INFINITY) ? -INFINITY : s * a.scale + bias;
  const float keep = (a.drop.on && q < a.S && key < a.S)
                         ? keep_scale_k(a.drop, hk, (uint32_t)(q * a.S + key))
                         : 1.f;
  return {exp2f((v - m) * kAttnLog2e) * inv_l, keep};
}

template <int DP, int NW>
struct DqShape {
  static constexpr int kQ = kTileQ<DP>, kV = kTileT<DP>;
  // each warpgroup's q and dO raw, k and v hi / lo, k^T hi / lo, the next
  // key tile's raw k and v, the keys' mask bias, the rows' delta0
  static constexpr int kQo = 0, kDo = NW * kQ, kKo = 2 * NW * kQ, kVo = kKo + 2 * kQ,
                       kTo = kVo + 2 * kQ, kRo = kTo + 2 * kV, kMo = kRo + 2 * kQ,
                       kEo = kMo + 64 * 4;
  static constexpr size_t kSmem = 1024 + (size_t)kEo + NW * 64 * 4;
  static_assert(kSmem <= 232448, "a block's shared memory");
};

template <int DP, int NW>
__global__ void __launch_bounds__(NW * 128, 1) flash_dq_tf32_kernel(BwdArgs a) {
  using L = DqShape<DP, NW>;
  constexpr int NT = NW * 128;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);
  float* mb = reinterpret_cast<float*>(sm + L::kMo);
  float* dl_s = reinterpret_cast<float*>(sm + L::kEo);  // [NW * 64]
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31, tq = lane & 3;
  const int rloc = frag_row();
  const int qb = blockIdx.x * 64 * NW, q0 = qb + 64 * wg, head = blockIdx.y, b = blockIdx.z;
  const int S = a.S, D = a.D;
  const float* kh = a.k.at(b, head);
  const float* vh = a.v.at(b, head);
  const float* doh = a.dout.at(b, head);
  const float* oh = a.o.at(b, head);
  const int32_t* mask_row = a.mask + (size_t)b * S;
  const int skip = causal_skip(mask_row, a.causal);
  const int t_end = key_tiles_end(qb + 64 * (NW - 1), S, skip);  // the block's
  const int my_end = q0 < S ? key_tiles_end(q0, S, skip) : 0;    // this warpgroup's
  const size_t stat0 = ((size_t)b * a.N + head) * S;
  const uint32_t hk = site_key(a.drop, b, head);

  auto fetch = [&](int t0) {
    copy_rows<DP, NT>(tid, base + L::kRo, kh, a.k.ss, t0, S, D);
    copy_rows<DP, NT>(tid, base + L::kRo + L::kQ, vh, a.v.ss, t0, S, D);
  };
  // each warpgroup's 64 rows of q and dO, raw: their A fragments are split
  // at each use
  copy_rows<DP, 128>(tid & 127, base + L::kQo + wg * L::kQ, a.q.at(b, head), a.q.ss, q0, S, D);
  copy_rows<DP, 128>(tid & 127, base + L::kDo + wg * L::kQ, doh, a.dout.ss, q0, S, D);
  fetch(0);
  cp_async_commit();
  // delta0 = dO . o per query row (flash attention's form, known before
  // the pass): a warp a row, lane l columns 2 l and 2 l + 1
  for (int r = warp; r < 64 * NW; r += NT / 32) {
    const int q = qb + r, d = 2 * lane;
    float dl = 0.f;
    if (q < S && d < D) {
      const float2 x = *reinterpret_cast<const float2*>(doh + (size_t)q * a.dout.ss + d);
      const float2 y = *reinterpret_cast<const float2*>(oh + (size_t)q * a.o.ss + d);
      dl = x.x * y.x + x.y * y.y;
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) dl += __shfl_xor_sync(0xffffffffu, dl, w);
    if (lane == 0) dl_s[r] = dl;
  }
  float mr[2], il[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + rloc + 8 * h;
    mr[h] = q < S ? a.stat_m[stat0 + q] : 0.f;
    il[h] = q < S ? 1.0f / a.stat_l[stat0 + q] : 0.f;
  }

  // dq0 = sum_j p (dp keep - delta0) k, pk = sum_j p k, and this thread's
  // terms of JAX's delta = sum_j p dp keep
  float dq[DP / 2], pk[DP / 2], dj[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = pk[i] = 0.f;
  for (int t0 = 0; t0 < t_end; t0 += 64) {
    cp_async_wait<0>();
    split_tile<DP, NT, true, true>(tid, sm + L::kRo, sm + L::kKo, sm + L::kTo);
    split_tile<DP, NT, true, false>(tid, sm + L::kRo + L::kQ, sm + L::kVo, nullptr);
    if (tid < 64) mb[tid] = key_bias(mask_row, t0 + tid, S);
    fence_async_smem();
    __syncthreads();
    if (t0 == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) dr[h] = dl_s[64 * wg + rloc + 8 * h];
    if (t0 + 64 < t_end) fetch(t0 + 64);
    cp_async_commit();

    if (t0 < my_end) {  // uniform over the warpgroup
      // s = q k^T, dp = dO v^T: a 32-column panel of q and dO at a time as
      // split A fragments, k and v the B tiles
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int p = 0; p < DP / 32; ++p) {
        uint32_t qh[4][4], ql[4][4], oh4[4][4], ol[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          frag_rows(qh[c], ql[c], sm + L::kQo + wg * L::kQ, 4 * p + c);
          frag_rows(oh4[c], ol[c], sm + L::kDo + wg * L::kQ, 4 * p + c);
        }
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kb = 4 * p + c;
          mma3_rs<64>(s, qh[c], ql[c], bdesc(base + L::kKo, 64, kb),
                      bdesc(base + L::kKo + L::kQ, 64, kb));
          mma3_rs<64>(dp, oh4[c], ol[c], bdesc(base + L::kVo, 64, kb),
                      bdesc(base + L::kVo + L::kQ, 64, kb));
        }
        wgmma_commit();
        wgmma_wait_n<0>();
      }
      fence_regs(s);
      fence_regs(dp);

      // ds0 = p (dp keep - delta0) in place of s, p in place of dp
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + rloc + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e, kl = 8 * j + 2 * tq + e;
            const ScoreProb g = score_prob(s[i], mb[kl], q, t0 + kl, a, mr[h], il[h], hk);
            const float dpk = __fmul_rn(dp[i], g.keep);  // rounded, as the dk / dv kernel's
            dj[h] += g.p * dpk;
            s[i] = g.p * (dpk - dr[h]);
            dp[i] = g.p;
          }
      }
      // dq0 += ds0 k, then pk += p k: the fragments from the registers, k^T
      // the B tile
      float acc[DP / 2];
      {
        uint32_t dh[8][4], dlo[8][4];
        to_frags_tf32(dh, dlo, s);
        tile_product<DP>(acc, dh, dlo, base + L::kTo);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dq[i] += acc[i];
      {
        uint32_t ph[8][4], pl[8][4];
        to_frags_tf32(ph, pl, dp);
        tile_product<DP>(acc, ph, pl, base + L::kTo);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) pk[i] += acc[i];
    }
    __syncthreads();  // k, v, k^T and the mask are rewritten next
  }
  cp_async_wait<0>();

  // JAX's delta for the dk / dv kernel, and dq = dq0 - (delta - delta0) pk
  float* out = a.dq.at(b, head);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + rloc + 8 * h;
    const float delta = quad_sum(dj[h]), eps = delta - dr[h];
    if (q >= S) continue;
    if (tq == 0) a.delta[stat0 + q] = delta;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (d < D)
        *reinterpret_cast<float2*>(out + (size_t)q * a.dq.ss + d) =
            make_float2((dq[4 * j + 2 * h] - eps * pk[4 * j + 2 * h]) * a.scale,
                        (dq[4 * j + 2 * h + 1] - eps * pk[4 * j + 2 * h + 1]) * a.scale);
    }
  }
}

template <int DP, int NW>
struct DkvShape {
  static constexpr int kQ = kTileQ<DP>, kV = kTileT<DP>;
  // each warpgroup's k and v raw, q and dO hi / lo, q^T and dO^T hi / lo,
  // the next query tile's raw q and dO, the query tile's max, 1 / sum and
  // delta
  static constexpr int kKo = 0, kVo = NW * kQ, kQo = 2 * NW * kQ, kDo = kQo + 2 * kQ,
                       kQTo = kDo + 2 * kQ, kDTo = kQTo + 2 * kV, kRo = kDTo + 2 * kV,
                       kSo = kRo + 2 * kQ;
  static constexpr size_t kSmem = 1024 + (size_t)kSo + 3 * 64 * 4;
  static_assert(kSmem <= 232448, "a block's shared memory");
};

template <int DP, int NW>
__global__ void __launch_bounds__(NW * 128, 1) flash_dkv_tf32_kernel(BwdArgs a) {
  using L = DkvShape<DP, NW>;
  constexpr int NT = NW * 128;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);
  float* st = reinterpret_cast<float*>(sm + L::kSo);  // m [64], 1/l [64], delta [64]
  const int tid = threadIdx.x, wg = tid >> 7, tq = tid & 3, rloc = frag_row();
  const int kb0 = blockIdx.x * 64 * NW, k0 = kb0 + 64 * wg, head = blockIdx.y, b = blockIdx.z;
  const int S = a.S, D = a.D;
  const float* qh = a.q.at(b, head);
  const float* doh = a.dout.at(b, head);
  const int32_t* mask_row = a.mask + (size_t)b * S;
  // the query tiles wholly before a key tile see none of it where the
  // forward skipped it (the mirror of key_tiles_end): the block starts at
  // its first warpgroup's, each warpgroup at its own
  const int skip = causal_skip(mask_row, a.causal);
  const int q_begin = skip ? kb0 : 0, my_begin = skip ? k0 : 0;
  const bool live = k0 < S;  // this warpgroup has keys
  const size_t stat0 = ((size_t)b * a.N + head) * S;
  const uint32_t hk = site_key(a.drop, b, head);

  auto fetch = [&](int q0) {
    copy_rows<DP, NT>(tid, base + L::kRo, qh, a.q.ss, q0, S, D);
    copy_rows<DP, NT>(tid, base + L::kRo + L::kQ, doh, a.dout.ss, q0, S, D);
  };
  // each warpgroup's 64 keys' k and v, raw
  copy_rows<DP, 128>(tid & 127, base + L::kKo + wg * L::kQ, a.k.at(b, head), a.k.ss, k0, S, D);
  copy_rows<DP, 128>(tid & 127, base + L::kVo + wg * L::kQ, a.v.at(b, head), a.v.ss, k0, S, D);
  fetch(q_begin);
  cp_async_commit();
  float bk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) bk[h] = key_bias(mask_row, k0 + rloc + 8 * h, S);

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int q0 = q_begin; q0 < S; q0 += 64) {
    cp_async_wait<0>();
    split_tile<DP, NT, true, true>(tid, sm + L::kRo, sm + L::kQo, sm + L::kQTo);
    split_tile<DP, NT, true, true>(tid, sm + L::kRo + L::kQ, sm + L::kDo, sm + L::kDTo);
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

    if (live && q0 >= my_begin) {  // uniform over the warpgroup
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
        for (int c = 0; c < 4; ++c) {
          frag_rows(kh[c], kl[c], sm + L::kKo + wg * L::kQ, 4 * p + c);
          frag_rows(vh[c], vl[c], sm + L::kVo + wg * L::kQ, 4 * p + c);
        }
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kb = 4 * p + c;
          mma3_rs_ba(s, kh[c], kl[c], bdesc(base + L::kQo, 64, kb),
                     bdesc(base + L::kQo + L::kQ, 64, kb));
          mma3_rs_ba(dp, vh[c], vl[c], bdesc(base + L::kDo, 64, kb),
                     bdesc(base + L::kDo + L::kQ, 64, kb));
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
            const int i = 4 * j + 2 * h + e, ql = 8 * j + 2 * tq + e;
            const ScoreProb g =
                score_prob(s[i], bk[h], q0 + ql, key, a, st[ql], st[64 + ql], hk);
            s[i] = g.p * g.keep;
            dp[i] = g.p * (__fmul_rn(dp[i], g.keep) - st[128 + ql]);
          }
      }
      // dv += (p keep)^T dO, then dk += ds^T q: the fragments from the
      // registers, dO^T and q^T the B tiles (one product at a time, so that
      // a tile's accumulator and one set of fragments are live)
      float acc[DP / 2];
      {
        uint32_t ph[8][4], pl[8][4];
        to_frags_tf32(ph, pl, s);
        tile_product<DP>(acc, ph, pl, base + L::kDTo);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dv[i] += acc[i];
      {
        uint32_t dh[8][4], dlo[8][4];
        to_frags_tf32(dh, dlo, dp);
        tile_product<DP>(acc, dh, dlo, base + L::kQTo);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] += acc[i];
    }
    __syncthreads();  // q, dO, their transposes and the statistics are rewritten next
  }
  cp_async_wait<0>();

  float* dko = a.dk.at(b, head);
  float* dvo = a.dv.at(b, head);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + rloc + 8 * h;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (d >= D) continue;
      *reinterpret_cast<float2*>(dko + (size_t)key * a.dk.ss + d) =
          make_float2(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
      *reinterpret_cast<float2*>(dvo + (size_t)key * a.dv.ss + d) =
          make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <int DP, bool kTrain>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  using L = FwdShape<DP>;
  cudaError_t err = allow_smem(flash_fwd_tf32_kernel<DP, kTrain>, L::kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_tf32_kernel<DP, kTrain>
      <<<dim3(ceil_div(a.S, 128), a.N, B), 256, L::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// K8: D a multiple of 8 up to kMaxHeadDim (takes); stat_m / stat_l may be
// null (then nothing is saved)
inline cudaError_t forward(const FwdArgs& a, int B, cudaStream_t stream) {
  const bool train = a.stat_m != nullptr || a.drop.on;
  if (a.D <= 32) return train ? launch_fwd<32, true>(a, B, stream) : launch_fwd<32, false>(a, B, stream);
  return train ? launch_fwd<64, true>(a, B, stream) : launch_fwd<64, false>(a, B, stream);
}

template <int DP>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  using Q = DqShape<DP, kDqWgs>;
  cudaError_t err = allow_smem(flash_dq_tf32_kernel<DP, kDqWgs>, Q::kSmem);
  if (err != cudaSuccess) return err;
  flash_dq_tf32_kernel<DP, kDqWgs>
      <<<dim3(ceil_div(a.S, 64 * kDqWgs), a.N, B), 128 * kDqWgs, Q::kSmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  using K = DkvShape<DP, kDkvWgs>;
  if ((err = allow_smem(flash_dkv_tf32_kernel<DP, kDkvWgs>, K::kSmem)) != cudaSuccess) return err;
  flash_dkv_tf32_kernel<DP, kDkvWgs>
      <<<dim3(ceil_div(a.S, 64 * kDkvWgs), a.N, B), 128 * kDkvWgs, K::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// K9: the dq kernel (writing delta), then the dk / dv kernel
inline cudaError_t backward(const BwdArgs& a, int B, cudaStream_t stream) {
  return a.D <= 32 ? launch_bwd<32>(a, B, stream) : launch_bwd<64>(a, B, stream);
}

}  // namespace flash_tf32
}  // namespace b4r
