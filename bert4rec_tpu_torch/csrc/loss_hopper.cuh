// The loss kernels on Hopper's warpgroup tensor cores (bf16 operands),
// dispatched from fused_mlm_loss.cu, replacing these of
// bert4rec_tpu/ops/fused_mlm_loss.py: K5 (_fwd_kernel_tiled, for
// _run_forward_tiled and _run_forward_tiled_stats), K7's two sweeps
// (_bwd_dh_kernel + _bwd_dt_kernel), which also run K4 (_bwd_kernel) from
// K3's lse, and K6 (_bwd_merged_kernel). Bound by operations: 2 R V W FLOP
// forward, 6 R V W backward (K4 and K7 recompute the logits: 8 R V W).
//
// K5 (loss_fwd_sweep_kernel, below the backwards) is two warpgroups a
// block, 64 hidden rows each held as register A fragments, sharing each
// streamed vocabulary tile: the table, re-read from L2 once per row
// block, costs half the traffic of 64-row blocks. One exponential per (row, vocabulary
// entry) takes about as long on the special-function units as the
// products at W = 128, so each warpgroup keeps two accumulators and folds
// tile j's logits into its online max and sum while tile j + 1's product
// runs.
//
// Every backward kernel is one warpgroup (128 threads) per block. Its
// resident tile X and its streamed tiles Y are 64 rows of the hidden [R, W]
// or of the table [V, W], bf16 in hopper.cuh's swizzle (W zero-filled to
// WP = 64, 128 or 256 columns: exact for both products), copied by cp.async
// in a two-stage ring with the streamed rows' operands (bias, or lse and
// label).
// One step, for each streamed tile:
//   s = X Y^T                     wgmma m64n64k16, both tiles K-major, fp32
//                                 accumulators in registers
//   dlog from s in registers      (exp(s + b - lse) - [col == label]) w, w =
//                                 g / max(n_valid, 1) where the label
//                                 weighs; the forward's lse is known, so no
//                                 running max. dl w is __fmul_rn: nvcc never
//                                 contracts it into a neighbouring add.
//   acc += T(dlog) Y              the rounded dlog packed in place as the
//                                 register A operand, Y read MN-major
// K7's dh sweep: X = a hidden row tile, Y = the vocabulary tiles; K7's dt
// sweep: X = a vocabulary tile (so its rows are wgmma's M: s is the
// transpose of the logits), Y = the hidden row tiles, and db sums the
// unrounded dlog of each X row. A sweep's Y tiles are dealt round-robin to
// the C blocks of a thread-block cluster (C a power of two <= 8 that brings
// the grid to ~kSweepCtas blocks), so the 160 row tiles of an ML-20M batch
// fill the card; the C fp32 partials of the tile (acc, db) are summed in
// rank order through distributed shared memory, each block summing 64 / C
// of its rows: no workspace, no atomics.
//
// K6: one recompute of the logits. A block holds a vocabulary tile and
// sweeps all hidden row tiles as the dt sweep does; for each it also forms
// its dh contribution T(dlog) T_tile (the rounded dlog stored transposed
// into shared memory as a K-major A tile, the vocabulary tile read
// MN-major; N = 128 halves at WP = 256, which keeps the registers of acc
// and of the contribution within 255). The C blocks of a cluster hold C
// neighbouring vocabulary tiles and sweep the row tiles in step: per row
// tile, their C contributions are summed in rank order through distributed
// shared memory and added into the cluster's fp32 dh partial [R, W] (the
// first group of vocabulary tiles stores), one write per (row tile, group of
// C vocabulary tiles) instead of one read and write per vocabulary tile. At
// most kMergedClusters clusters, each taking groups round-robin, so the
// workspace (clusters x R x W fp32) does not grow with V; the partials are
// reduced in cluster order afterwards.
#pragma once

#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace b4r {

// whether a row carries loss weight: label > 0, or label >= 0 under the
// sharded loss's encoding (valid_ge_zero)
__device__ __forceinline__ bool row_valid(int lab, int valid_ge_zero) {
  return valid_ge_zero ? lab >= 0 : lab > 0;
}

namespace loss_hopper {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSweepCtas = 1024;     // a sweep's clusters grow until ~this many blocks
constexpr int kMergedClusters = 32;  // K6's clusters, and so its dh partials, at most
constexpr int kStatBytes = 512;      // a stage's streamed row operands
// Blocks an SM holds. A sweep keeps acc (WP / 2 registers) and s (32); K6
// also the dh contribution (N / 2) and holds a fp32 exchange tile.
template <int WP> constexpr int kSweepBlocks = WP == 64 ? 4 : WP == 128 ? 3 : 2;
template <int WP> constexpr int kMergedBlocks = WP == 256 ? 1 : 2;
template <int WP> constexpr int kLd = WP + 8;  // fp32 exchange tile row stride
// K5: two warpgroups a block share each streamed vocabulary tile, 64 hidden
// rows each; the splits of the vocabulary bring the grid to ~kFwdItems
// blocks. Vocabulary entries a step: 128 at WP = 256 (m64n128 products, one
// block an SM; 10% faster than 64 there on an H100), 64 below it, where two
// blocks an SM fit (8% faster than 128 at WP = 128).
constexpr int kFwdThreads = 2 * kThreads, kFwdRows = 2 * kRows;
constexpr int kFwdItems = 1024;
template <int WP> constexpr int kFwdN = WP == 256 ? 128 : 64;
template <int WP> constexpr int kFwdBlocks = kFwdN<WP> == 64 ? 2 : 1;
// ring stages: four, or three where four tiles would not fit shared memory
template <int WP> constexpr int kFwdStages = kFwdN<WP> * WP * 2 > 32768 ? 3 : 4;

struct BwdArgs {
  const bf16* hidden;     // [R, W]
  const bf16* table;      // [V, W], the hidden dtype
  const float* bias;      // [V], vocab padding at -1e9
  const int32_t* labels;  // [R]
  const float* lse;       // [R], the forward's
  const float* g;         // the loss's cotangent
  const float* n_valid;   // the forward's weighted row count
  int valid_ge_zero;
  int R, V, W;
};

__device__ __forceinline__ float weight_scale(const BwdArgs& a) {
  return a.g[0] / fmaxf(a.n_valid[0], 1.f);
}

// The streamed tile's row operands into a stage: hidden rows y0 .. +63
// (kHiddenY) their lse [0, 64) and labels [64, 128); vocabulary rows their
// bias [0, 64). Rows past the matrix are zero-filled (the epilogues mask
// them by index).
template <bool kHiddenY>
__device__ __forceinline__ void load_stats(uint32_t dst, const BwdArgs& a, int y0) {
  const int t = threadIdx.x, c = t & (kRows - 1), y = y0 + c;
  if constexpr (kHiddenY) {
    const bool ok = y < a.R;
    if (t < kRows)
      cp_async4(dst + 4 * c, ok ? a.lse + y : a.lse, ok ? 4 : 0);
    else
      cp_async4(dst + 4 * (kRows + c), ok ? a.labels + y : a.labels, ok ? 4 : 0);
  } else if (t < kRows) {
    const bool ok = y < a.V;
    cp_async4(dst + 4 * c, ok ? a.bias + y : a.bias, ok ? 4 : 0);
  }
}

// dlog in place of the logits s, X = hidden rows (lse, label, weight per X
// row h), Y = vocabulary entries y0 + column with their bias in bias_s
// (-inf past V, where the zero-filled table rows give s = 0)
__device__ __forceinline__ void dlog_hidden_x(float (&s)[32], const float* bias_s, int y0,
                                              int V, const float (&lse)[2],
                                              const int (&lab)[2], const float (&w)[2]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 bv = *reinterpret_cast<const float2*>(bias_s + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = y0 + c + e;
      const float b = v < V ? (e ? bv.y : bv.x) : -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = s[4 * j + 2 * h + e];
        const float p = ex2((x + b - lse[h]) * kLog2e);
        x = __fmul_rn(p - (v == lab[h] ? 1.f : 0.f), w[h]);
      }
    }
  }
}

// dlog in place of the transposed logits s, X = vocabulary entries xv[h]
// with bias xb[h] (-inf past V), Y = hidden rows y0 + column with their lse
// and label in st; db[h] sums X row h's unrounded dlog
__device__ __forceinline__ void dlog_table_x(float (&s)[32], const float* st, int y0,
                                             const BwdArgs& a, float scale,
                                             const int (&xv)[2], const float (&xb)[2],
                                             float (&db)[2]) {
  const int tq = threadIdx.x & 3;
  const int32_t* lab_s = reinterpret_cast<const int32_t*>(st + kRows);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 lv = *reinterpret_cast<const float2*>(st + c);
    const int2 lb = *reinterpret_cast<const int2*>(lab_s + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = y0 + c + e, lab = e ? lb.y : lb.x;
      const float lse = e ? lv.y : lv.x;
      const float w = (r < a.R && row_valid(lab, a.valid_ge_zero)) ? scale : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = s[4 * j + 2 * h + e];
        const float p = ex2((x + xb[h] - lse) * kLog2e);
        x = __fmul_rn(p - (xv[h] == lab ? 1.f : 0.f), w);
        db[h] += x;
      }
    }
  }
}

// columns [0, N) of a 64 x N accumulator into the fp32 tile out (row
// stride ld floats, columns from col0)
template <int N>
__device__ __forceinline__ void store_acc(float* out, int ld, int col0,
                                          const float (&acc)[N / 2]) {
  const int tq = threadIdx.x & 3, row0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (row0 + 8 * h) * ld + col0 + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// Rows [rank * 64 / C, +64 / C) of the cluster's C fp32 tiles tile (row
// stride ld, WP columns) summed in rank order, four columns at a time:
// out(row, col, sum) for col < W.
template <int WP, typename F>
__device__ __forceinline__ void cluster_sum_rows(cg::cluster_group& cluster, float* tile,
                                                 int ld, int W, F&& out) {
  const int C = (int)cluster.num_blocks(), rows = kRows / C;
  const int r0 = (int)cluster.block_rank() * rows;
  for (int idx = threadIdx.x; idx < rows * (WP / 4); idx += kThreads) {
    const int row = r0 + idx / (WP / 4), col = 4 * (idx % (WP / 4));
    if (col >= W) continue;
    float4 v[kMaxCluster];  // every peer's load in flight before the sums
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < C)
        v[k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, k) + row * ld +
                                                col);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k >= C) break;
      sum.x += v[k].x;
      sum.y += v[k].y;
      sum.z += v[k].z;
      sum.w += v[k].w;
    }
    out(row, col, sum);
  }
}

// barrier.cluster halves: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K7's sweeps: block rank of cluster x holds X tile x and streams the Y tiles
// rank, rank + C, ...; kTableX: the dt sweep (X = vocabulary tiles, writes
// dt and db), else the dh sweep (X = hidden row tiles, writes dh).
// ---------------------------------------------------------------------------
template <int WP, bool kTableX>
__global__ void __launch_bounds__(kThreads, kSweepBlocks<WP>)
loss_sweep_kernel(BwdArgs a, bf16* dh, float* dt, float* db) {
  constexpr int kTile = tile_bytes(WP);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  uint8_t* sm = aligned_smem();
  const uint32_t Xs = smem_u32(sm), Ys = Xs + kTile, Ss = Ys + kStages * kTile;
  const float* stats = reinterpret_cast<const float*>(sm + (Ss - Xs));

  const int tid = threadIdx.x, tq = tid & 3;
  const int row0 = 16 * (tid >> 5) + ((tid & 31) >> 2);  // tile rows row0, row0 + 8
  const int x0 = (int)(blockIdx.x / C) * kRows;
  const bf16* X = kTableX ? a.table : a.hidden;
  const bf16* Y = kTableX ? a.hidden : a.table;
  const int xn = kTableX ? a.V : a.R, yn = kTableX ? a.R : a.V;
  const int ytiles = cdiv(yn, kRows);
  const int n = rank < ytiles ? cdiv(ytiles - rank, C) : 0;
  const float scale = weight_scale(a);

  auto prefetch = [&](int item) {
    const int st = item % kStages, y0 = (rank + item * C) * kRows;
    load_tile<WP>(Ys + st * kTile, Y, a.W, y0, yn, a.W);
    load_stats<kTableX>(Ss + st * kStatBytes, a, y0);
  };
  load_tile<WP>(Xs, X, a.W, x0, xn, a.W);
  if (n > 0) prefetch(0);
  cp_async_commit();

  // this thread's X rows: vocabulary index and bias (dt sweep), or label,
  // lse and weight (dh sweep)
  int xi[2];
  float xb[2], xl[2], xw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = x0 + row0 + 8 * h;
    if constexpr (kTableX) {
      xi[h] = x;
      xb[h] = x < a.V ? a.bias[x] : -INFINITY;
    } else {
      xi[h] = x < a.R ? a.labels[x] : -1;
      xl[h] = x < a.R ? a.lse[x] : 0.f;
      xw[h] = (x < a.R && row_valid(xi[h], a.valid_ge_zero)) ? scale : 0.f;
    }
  }
  float acc[WP / 2], s[32], dbs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < WP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  for (int item = 0; item < n; ++item) {
    if (item + 1 < n) prefetch(item + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int st = item % kStages, y0 = (rank + item * C) * kRows;
    const uint32_t Yt = Ys + st * kTile;
    wgmma_fence();
    mma_nt<WP>(s, Xs, Yt);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    if constexpr (kTableX)
      dlog_table_x(s, stats + st * (kStatBytes / 4), y0, a, scale, xi, xb, dbs);
    else
      dlog_hidden_x(s, stats + st * (kStatBytes / 4), y0, a.V, xl, xi, xw);
    uint32_t f[4][4];
    to_frags(f, s);
    fence_frags(f);
    fence_regs(acc);
    wgmma_fence();
    mma_rs<WP>(acc, f, Yt);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the cluster's sum in rank order: each block's fp32 partial (and db)
  // over its tiles, then every block sums 64 / C rows of all C
  float* part = reinterpret_cast<float*>(sm);
  float* dbp = part + kRows * kLd<WP>;
  store_acc<WP>(part, kLd<WP>, 0, acc);
  if constexpr (kTableX) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = quad_sum(dbs[h]);
      if (tq == 0) dbp[row0 + 8 * h] = v;
    }
  }
  cluster.sync();
  const int W = a.W;
  cluster_sum_rows<WP>(cluster, part, kLd<WP>, W, [&](int row, int col, float4 v) {
    const int x = x0 + row;
    if (x >= xn) return;
    if constexpr (kTableX) {
      *reinterpret_cast<float4*>(dt + (size_t)x * W + col) = v;
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dh + (size_t)x * W + col) = packed;
    }
  });
  if constexpr (kTableX) {
    const int rows = kRows / C, row = rank * rows + tid;
    if (tid < rows && x0 + row < a.V) {
      float sum = 0.f;
      for (int k = 0; k < C; ++k) sum += cluster.map_shared_rank(dbp, k)[row];
      db[x0 + row] = sum;
    }
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

// ---------------------------------------------------------------------------
// K6: cluster c, block rank, takes the groups c, c + n_clusters, ... of C
// vocabulary tiles (its tile: group * C + rank; past V a zero tile whose
// outputs are dropped) and for each sweeps all hidden row tiles, writing
// the tile's dt and db once and adding the cluster's dh sums into
// part_dh[c].
// ---------------------------------------------------------------------------
template <int WP>
__global__ void __launch_bounds__(kThreads, kMergedBlocks<WP>)
loss_merged_kernel(BwdArgs a, float* dt, float* db, float* part_dh, int n_clusters) {
  constexpr int kTile = tile_bytes(WP), kN = WP < 128 ? WP : 128;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = (int)blockIdx.x / C;
  uint8_t* sm = aligned_smem();
  const uint32_t Xs = smem_u32(sm), Ys = Xs + kTile, Ds = Ys + kStages * kTile,
                 Cs = Ds + tile_bytes(64), Ss = Cs + kRows * kLd<WP> * 4;
  uint8_t* ds_p = sm + (Ds - Xs);
  float* xch = reinterpret_cast<float*>(sm + (Cs - Xs));
  const float* stats = reinterpret_cast<const float*>(sm + (Ss - Xs));

  const int tid = threadIdx.x, tq = tid & 3;
  const int row0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int W = a.W, vtiles = cdiv(a.V, kRows), groups = cdiv(vtiles, C);
  const int rtiles = cdiv(a.R, kRows);
  const float scale = weight_scale(a);
  float* mine = part_dh + (size_t)cid * a.R * W;

  auto prefetch = [&](int item) {
    const int st = item % kStages;
    load_tile<WP>(Ys + st * kTile, a.hidden, W, item * kRows, a.R, W);
    load_stats<true>(Ss + st * kStatBytes, a, item * kRows);
  };
  bool pending = false;  // an arrive on the cluster barrier not yet waited on
  for (int grp = cid, first = 1; grp < groups; grp += n_clusters, first = 0) {
    const int v0 = (grp * C + rank) * kRows;
    load_tile<WP>(Xs, a.table, W, v0, a.V, W);
    prefetch(0);
    cp_async_commit();
    int xi[2];
    float xb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xi[h] = v0 + row0 + 8 * h;
      xb[h] = xi[h] < a.V ? a.bias[xi[h]] : -INFINITY;
    }
    float acc[WP / 2], s[32], dbs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < WP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int item = 0; item < rtiles; ++item) {
      if (item + 1 < rtiles) prefetch(item + 1);
      cp_async_commit();
      cp_async_wait<1>();
      fence_async_smem();
      __syncthreads();
      const int st = item % kStages, r0 = item * kRows;
      const uint32_t Yt = Ys + st * kTile;
      wgmma_fence();
      mma_nt<WP>(s, Xs, Yt);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      dlog_table_x(s, stats + st * (kStatBytes / 4), r0, a, scale, xi, xb, dbs);
      uint32_t f[4][4];
      to_frags(f, s);
      // the rounded dlog transposed into Ds, a K-major [64 rows][64 vocab]
      // A tile: element (vocab row0 + 8 h, row 8 j + 2 tq + e)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + 2 * tq + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = row0 + 8 * h;
            *reinterpret_cast<bf16*>(ds_p + r * 128 + (((v >> 3) ^ (r & 7)) << 4) +
                                     (v & 7) * 2) = __float2bfloat16_rn(s[4 * j + 2 * h + e]);
          }
        }
      fence_async_smem();
      __syncthreads();
      if (pending) cluster_wait();  // the peers have read this block's exchange tile
      float hc[kN / 2];
      fence_frags(f);
      fence_regs(acc);
      wgmma_fence();
      mma_rs<WP>(acc, f, Yt);
      mma_ss_t<kN>(hc, Ds, Xs);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(hc);
      store_acc<kN>(xch, kLd<WP>, 0, hc);
      if constexpr (WP > kN) {  // the columns past 128 of the contribution
        wgmma_fence();
        mma_ss_t<kN>(hc, Ds, Xs + 2 * kBlockBytes);
        wgmma_commit();
        wgmma_wait();
        fence_regs(hc);
        store_acc<kN>(xch, kLd<WP>, kN, hc);
      }
      cluster_arrive();
      cluster_wait();  // every block's contribution is in its exchange tile
      cluster_sum_rows<WP>(cluster, xch, kLd<WP>, W, [&](int row, int col, float4 v) {
        const int r = r0 + row;
        if (r >= a.R) return;
        float4* p = reinterpret_cast<float4*>(mine + (size_t)r * W + col);
        if (!first) {
          const float4 o = *p;
          v.x += o.x;
          v.y += o.y;
          v.z += o.z;
          v.w += o.w;
        }
        *p = v;
      });
      // the next step rewrites Ds, a stage and the exchange tile only after
      // the barrier above (every thread's products done) and, for the
      // exchange tile, after the peers' arrive below
      cluster_arrive();
      pending = true;
    }
    // this tile's dt and db, once
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = xi[h];
      const float dsum = quad_sum(dbs[h]);
      if (v >= a.V) continue;
      if (tq == 0) db[v] = dsum;
#pragma unroll
      for (int j = 0; j < WP / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < W)
          *reinterpret_cast<float2*>(dt + (size_t)v * W + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    __syncthreads();  // Xs and the stages are reloaded for the next group
  }
  if (pending) cluster_wait();  // no block leaves while a peer reads its tile
}

// ---------------------------------------------------------------------------
// K5: block (row block, split) holds kFwdRows hidden rows, 64 per warpgroup
// as register A fragments, and streams the split's vocabulary tiles of
// kFwdN<WP> entries (with their bias) through a kFwdStages<WP> ring that
// both warpgroups read. Per tile each warpgroup issues s = X Y^T into its
// accumulator, then, while that product runs, folds the previous tile's
// logits (held apart, the bias added) into its rows' online max and sum of
// exponentials, and picks the label logit where the label's column lies in
// that tile. The split's per-row (max, sum, label logit) go to
// part_*[split][row]; the caller merges the splits in split order.
// ---------------------------------------------------------------------------
struct FwdArgs {
  const bf16* hidden;     // [R, W]
  const bf16* table;      // [V, W], the hidden dtype
  const float* bias;      // [V], vocab padding at -1e9
  const int32_t* labels;  // [R]
  float *part_m, *part_s, *part_ll;  // [splits][R]
  int R, V, W, splits;
};

// the register A fragments of this thread's warpgroup's 64 rows x0 .. of a
// row-major [n, W] bf16 matrix (W a multiple of 8; rows past n and columns
// past W are zeros): k-block kk's register 2 c + h holds row row0 + 8 h,
// columns 16 kk + 8 c + 2 tq, +1
template <int WP>
__device__ __forceinline__ void load_frags(uint32_t (&xf)[WP / 16][4], const bf16* src,
                                           int x0, int n, int W) {
  const int tq = threadIdx.x & 3;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = x0 + row0 + 8 * h;
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(src + (size_t)(r < n ? r : 0) * W);
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 16 * kk + 8 * c + 2 * tq;
        xf[kk][2 * c + h] = (r < n && col < W) ? row[col / 2] : 0u;
      }
  }
}

// Starts s = X Y^T, X the register fragments, Y a tile of BN rows (BN / 64
// halves of 64 rows, hopper.cuh's swizzle, 64-column blocks BN * 128 bytes
// apart) as a K-major operand; the caller fences before and commits after.
template <int WP, int BN>
__device__ __forceinline__ void mma_frags_nt(float (&s)[BN / 2],
                                             const uint32_t (&xf)[WP / 16][4], uint32_t Y) {
#pragma unroll
  for (int kk = 0; kk < WP / 16; ++kk) {
    const uint64_t d = sw128_desc(Y + (kk >> 2) * (BN * 128) + (kk & 3) * 32, 16, 1024);
    if constexpr (BN == 64)
      wgmma_rs_k_n64(s, xf[kk], d, kk > 0);
    else
      wgmma_rs_k_n128(s, xf[kk], d, kk > 0);
  }
}

// One vocabulary tile's products s plus the tile's bias (in bias_s) into
// x: the logits of X rows row0 + 8 h, tile columns 8 j + 2 tq + e. With
// kRagged the columns from vlim on lie past the vocabulary and get -inf.
template <int BN, bool kRagged>
__device__ __forceinline__ void add_bias(float (&x)[BN / 2], const float (&s)[BN / 2],
                                         const float* bias_s, int vlim) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 bv = *reinterpret_cast<const float2*>(bias_s + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = (kRagged && c + e >= vlim) ? -INFINITY : (e ? bv.y : bv.x);
#pragma unroll
      for (int h = 0; h < 2; ++h) x[4 * j + 2 * h + e] = s[4 * j + 2 * h + e] + b;
    }
  }
}

// One tile's logits x folded into the rows' running max m, this thread's
// share l of the sum of exp(logit - m), and ll, the logit at column rel[h]
// of the tile where the label lies in it.
template <int BN>
__device__ __forceinline__ void fold_tile(const float (&x)[BN / 2], const int (&rel)[2],
                                          float (&m)[2], float (&l)[2], float (&ll)[2]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) tmax = fmaxf(tmax, x[4 * j + 2 * h + e]);
    if ((unsigned)rel[h] < (unsigned)BN) {  // one lane of the quad holds it
      const int d = rel[h] - 2 * tq;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e == d) ll[h] = x[4 * j + 2 * h + e];
    }
    const float mn = fmaxf(m[h], quad_max(tmax));
    const float ms = mn * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) sum += ex2(fmaf(x[4 * j + 2 * h + e], kLog2e, -ms));
    l[h] = fmaf(l[h], ex2((m[h] - mn) * kLog2e), sum);
    m[h] = mn;
  }
}

template <int WP>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks<WP>)
loss_fwd_sweep_kernel(FwdArgs a) {
  constexpr int BN = kFwdN<WP>, kTile = BN * WP * 2, kST = kFwdStages<WP>;
  uint8_t* sm = aligned_smem();
  const uint32_t Ys = smem_u32(sm), Bs = Ys + kST * kTile;
  const float* bias_s = reinterpret_cast<const float*>(sm + kST * kTile);

  const int tid = threadIdx.x, tq = tid & 3;
  const int row0 = 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
  const int x0 = (int)blockIdx.x * kFwdRows + (tid >> 7) * kRows;
  const int split = (int)blockIdx.y, vtiles = cdiv(a.V, BN);
  const int t0 = (int)((long)split * vtiles / a.splits);
  const int n = (int)((long)(split + 1) * vtiles / a.splits) - t0;

  auto prefetch = [&](int item) {
    const int st = item % kST, v0 = (t0 + item) * BN;
#pragma unroll
    for (int half = 0; half < BN / kRows; ++half)
      load_tile<WP, kFwdThreads, BN * 128>(Ys + st * kTile + half * kBlockBytes, a.table,
                                           a.W, v0 + half * kRows, a.V, a.W);
    if (tid < BN) {
      const bool ok = v0 + tid < a.V;
      cp_async4(Bs + (st * BN + tid) * 4, ok ? a.bias + v0 + tid : a.bias, ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kST - 1; ++i) {
    if (i < n) prefetch(i);
    cp_async_commit();
  }

  uint32_t xf[WP / 16][4];
  load_frags<WP>(xf, a.hidden, x0, a.R, a.W);
  // labels outside [0, V) match no column
  int lab[2];
  float m[2], l[2], ll[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = x0 + row0 + 8 * h, y = r < a.R ? a.labels[r] : -1;
    lab[h] = (y >= 0 && y < a.V) ? y : -(1 << 30);
    m[h] = -INFINITY;
    l[h] = ll[h] = 0.f;
  }
  // One step of the ring: the barrier makes tile `item`'s copies visible to
  // both warpgroups and, since every thread finished tile item - 1's
  // product and read its bias before it, frees that tile's stage for tile
  // item + kST - 1. Tile item - 1's logits (prev) are folded while
  // tile item's product runs into cur; then cur plus the tile's bias
  // becomes prev. (No product is in flight from one step to the next, and
  // prev is never a product's register: ptxas then keeps the product
  // asynchronous.)
  float cur[BN / 2], prev[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) cur[i] = 0.f;
  for (int item = 0; item < n; ++item) {
    cp_async_wait<kST - 2>();
    fence_async_smem();
    __syncthreads();
    if (item + kST - 1 < n) prefetch(item + kST - 1);
    cp_async_commit();
    wgmma_fence();
    mma_frags_nt<WP, BN>(cur, xf, Ys + (item % kST) * kTile);
    wgmma_commit();
    const int v0 = (t0 + item) * BN;
    if (item > 0) {
      const int rel[2] = {lab[0] - (v0 - BN), lab[1] - (v0 - BN)};
      fold_tile<BN>(prev, rel, m, l, ll);
    }
    wgmma_wait();
    fence_regs(cur);
    const float* b = bias_s + (item % kST) * BN;
    if (v0 + BN > a.V)
      add_bias<BN, true>(prev, cur, b, a.V - v0);
    else
      add_bias<BN, false>(prev, cur, b, BN);
  }
  if (n > 0) {
    const int v0 = (t0 + n - 1) * BN;
    const int rel[2] = {lab[0] - v0, lab[1] - v0};
    fold_tile<BN>(prev, rel, m, l, ll);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = x0 + row0 + 8 * h;
    const float ls = quad_sum(l[h]), lls = quad_sum(ll[h]);
    if (tq == 0 && r < a.R) {
      const size_t o = (size_t)split * a.R + r;
      a.part_m[o] = m[h];
      a.part_s[o] = ls;
      a.part_ll[o] = lls;
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
inline int padded_width(int W) { return W <= 64 ? 64 : W <= 128 ? 128 : 256; }

inline size_t sweep_smem(int wp) {
  return 1024 + (size_t)tile_bytes(wp) * (1 + kStages) + kStages * kStatBytes;
}
inline size_t merged_smem(int wp) {
  return 1024 + (size_t)tile_bytes(wp) * (1 + kStages) + tile_bytes(64) +
         (size_t)kRows * (wp + 8) * 4 + kStages * kStatBytes;
}

// a sweep's cluster size: the smallest power of two that brings the grid to
// ~kSweepCtas blocks, at most kMaxCluster and at most the streamed tiles
inline int sweep_cluster(int xtiles, int ytiles) {
  int c = 1;
  while (c < kMaxCluster && 2 * c <= ytiles && xtiles * c < kSweepCtas) c *= 2;
  return c;
}
// K7's (and K4's) two sweeps' cluster sizes at Y tiles of yn rows: the dh
// sweep's (X = the 64-row tiles of the hidden), then the dt sweep's (X =
// the 64-entry tiles of the vocabulary)
inline void sweep_clusters(int R, int V, int yn, int& c_dh, int& c_dt) {
  c_dh = sweep_cluster((R + kRows - 1) / kRows, (V + yn - 1) / yn);
  c_dt = sweep_cluster((V + kRows - 1) / kRows, (R + yn - 1) / yn);
}
// K6's cluster size (vocabulary tiles per group) and cluster count
inline int merged_cluster(int V) {
  const int vtiles = (V + kRows - 1) / kRows;
  int c = 1;
  while (c < kMaxCluster && 2 * c <= vtiles) c *= 2;
  return c;
}
inline int merged_clusters(int V) {
  const int vtiles = (V + kRows - 1) / kRows, c = merged_cluster(V);
  return std::min((vtiles + c - 1) / c, kMergedClusters);
}

template <int WP>
constexpr size_t kFwdSmem = 1024 + (size_t)kFwdN<WP> * (WP * 2 + 4) * kFwdStages<WP>;

// K5's vocabulary splits: the fewest that bring (row blocks x splits) to
// kFwdItems, at most one per vocabulary tile of kFwdN<WP> entries
inline int fwd_splits(int R, int V, int W) {
  const int wp = padded_width(W);
  const int bn = wp == 64 ? kFwdN<64> : wp == 128 ? kFwdN<128> : kFwdN<256>;
  const int rblocks = (R + kFwdRows - 1) / kFwdRows, vtiles = (V + bn - 1) / bn;
  return std::max(1, std::min(vtiles, (kFwdItems + rblocks - 1) / rblocks));
}

// K5's first pass; a.splits = fwd_splits(R, V, W)
template <int WP>
cudaError_t fwd_sweep(const FwdArgs& a, cudaStream_t st) {
  const size_t smem = kFwdSmem<WP>;
  cudaError_t err = allow_smem(loss_fwd_sweep_kernel<WP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.R + kFwdRows - 1) / kFwdRows, a.splits);
  loss_fwd_sweep_kernel<WP><<<grid, kFwdThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// K7: the dh sweep, then the dt sweep
template <int WP>
cudaError_t two_sweep(const BwdArgs& a, bf16* dh, float* dt, float* db, cudaStream_t st) {
  const int rtiles = (a.R + kRows - 1) / kRows, vtiles = (a.V + kRows - 1) / kRows;
  int c_dh, c_dt;
  sweep_clusters(a.R, a.V, kRows, c_dh, c_dt);
  cudaError_t err = launch_clusters(loss_sweep_kernel<WP, false>, rtiles * c_dh, c_dh,
                                    sweep_smem(WP), st, a, dh, dt, db);
  if (err != cudaSuccess) return err;
  return launch_clusters(loss_sweep_kernel<WP, true>, vtiles * c_dt, c_dt, sweep_smem(WP),
                         st, a, dh, dt, db);
}

// K6's sweep; the caller reduces part_dh's merged_clusters(V) partials
template <int WP>
cudaError_t merged_sweep(const BwdArgs& a, float* dt, float* db, float* part_dh,
                         cudaStream_t st) {
  const int c = merged_cluster(a.V), n = merged_clusters(a.V);
  return launch_clusters(loss_merged_kernel<WP>, n * c, c, merged_smem(WP), st, a, dt, db,
                         part_dh, n);
}

}  // namespace loss_hopper
}  // namespace b4r
