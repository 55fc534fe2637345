// The fp32 loss kernels on Hopper's warpgroup tensor cores in 3xTF32
// (tf32.cuh's law), dispatched from fused_mlm_loss.cu, replacing these of
// bert4rec_tpu/ops/fused_mlm_loss.py in fp32: K3 (_fwd_kernel, launched by
// _run_forward) and K5 (_fwd_kernel_tiled, launched by _tiled_fwd_call for
// _run_forward_tiled and _run_forward_tiled_stats): one forward sweep,
// loss_tf32_fwd_sweep_kernel, over the vocabulary splits, then
// fused_mlm_loss.cu's ordered merge; K4 (_bwd_kernel, launched by
// _run_backward) and K7 (_bwd_dh_kernel + _bwd_dt_kernel, launched by
// _run_backward_tiled): the two sweeps from the forward's lse, and K6
// (_bwd_merged_kernel, launched by _run_backward_merged). They compute what
// fused_mlm_loss.cu's header writes with T = float (rounding dlog to the
// hidden dtype is then no rounding). Bound by operations: 2 R V W FLOP
// forward, 6 R V W backward (K4 / K7 recompute the logits: 8 R V W), three
// tensor-core products each, so at most 495 / 3 = 165 TFLOP/s on an H100
// SXM.
//
// The crux: wgmma reads .tf32 operands from shared memory only K-major, and
// of the three products per (row tile, vocabulary tile) only s = X Y^T
// contracts over the columns the tiles hold in memory order. So every
// product takes its A operand from registers, loaded by each thread with
// ld.shared in whatever order the fragment needs (and split there), and
// its B operand from a K-major tile in shared memory:
//   s = X Y^T                 M = the X rows, N = the Y rows, K = W: A = X
//                             (a raw fp32 tile, split as it is read), B =
//                             Y's hi and lo tiles (Y lands raw by cp.async,
//                             each thread splits the chunks it copied)
//   dlog from s in registers  (exp(s + b - lse) - [col == label]) w, split
//                             into hi / lo and stored as a K-major [X][Y]
//                             tile (D)
//   acc^T += Y^T dlog^T       M = W (64-column blocks of the output), N =
//                             the X rows, K = the Y rows: A = Y^T read from
//                             Y's hi / lo tiles, B = D
// so the outputs accumulate transposed, [W][X rows], and reach memory
// through a shared tile in rows. Nothing is transposed in device memory:
// no workspace grows with V. The k order inside each 8-deep k-block is
// even-first (k position q holds row 2 q for q < 4, 2 (q - 4) + 1 above),
// in D and in the A fragments alike: the transposed fragment reads are then
// free of bank conflicts, as are D's stores.
//
// Two consumer warpgroups a block share the resident X tile and take the
// streamed Y tiles in turn, each with its own stage, D and accumulators:
// one's register work (the split, dlog, the fragment loads) runs while the
// other's products do; each prefetches its next Y tile as soon as its last
// read of the stage is done. A step's output product (K = the Y rows) is
// formed in a fresh accumulator and added to the running sum on the CUDA
// cores: the tensor core's own accumulation, over K7's 42k-entry Reddit
// sweep, moved dh by 1.7e-4 of its scale, past the fp32 tolerance.
//
// K7: two sweeps, each a thread-block cluster per X tile whose C blocks
// take every C-th Y tile (C a power of two <= 8 that brings the grid to
// ~1,024 blocks), their fp32 partials summed in rank order through
// distributed shared memory: the dh sweep (X = 64 hidden rows, Y = 64 or,
// at W > 128, 32 vocabulary entries) and the dt sweep (X = a vocabulary
// tile, Y = hidden rows; db sums each X row's unrounded dlog). No
// workspace.
//
// K3's and K5's forward sweep (loss_tf32_fwd_sweep_kernel, after K6):
// s = X Y^T only, Y = the vocabulary tiles of the block's split, each tile's
// logits folded into an online max / sum of exponentials and the label
// logit in registers. At WP <= 128 (fwd_rows) a block holds 128 hidden
// rows, each warpgroup 64 of them as A fragments split in registers once
// (128 registers at WP = 128), and both warpgroups multiply every streamed
// tile, which crosses L2 and is split once per 128 rows; a tile's fold and
// the next tile's split run while its product does. At WP = 256 (fwd_tiles:
// 256 registers of fragments would not fit) a block holds 64 rows raw and
// its two warpgroups take the tiles in turn. The splits bring the grid to
// whole waves of one block an SM and are merged in split order by
// fused_mlm_loss.cu, which writes lse and the sums (K3, K5's loss entry) or
// the per-row stats (K5's stats entry).
//
// K6: one recompute. A block holds a vocabulary tile X and sweeps the
// hidden rows 32 at a time as the dt sweep does; for each it also forms the
// tile's dh contribution dh^T = X^T dlog (M = W, K = the vocabulary tile,
// N = the rows: A = X^T read from the raw X tile, B = dlog stored again
// transposed, D2). The C blocks of a cluster hold C neighbouring vocabulary
// tiles and sweep the rows in step; per row tile their contributions are
// summed in rank order through distributed shared memory and added into the
// cluster's fp32 dh partial (at most loss_hopper's kMergedClusters
// partials of R x W, reduced in cluster order afterwards). At W > 128 one
// warpgroup a block: two exchange tiles and two sets of D tiles would not
// fit.
//
// Layout rule (fused_mlm_loss.cu wgmma_layout, which the wrapper meets by
// copying): hidden and table contiguous, 16-byte aligned base and rows (W
// a multiple of 4), W <= 256 (zero-filled to 64, 128 or 256).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"
#include "loss_hopper.cuh"
#include "tf32.cuh"

namespace b4r {
namespace loss_tf32 {

using namespace hopper;
using namespace tf32;
using loss_hopper::cluster_arrive;
using loss_hopper::cluster_wait;
using loss_hopper::kLog2e;
namespace cg = cooperative_groups;

struct Args {
  const float* hidden;    // [R, W]
  const float* table;     // [V, W]
  const float* bias;      // [V], vocab padding at -1e9
  const int32_t* labels;  // [R]
  const float* lse;       // [R], the forward's
  const float* g;         // the loss's cotangent
  const float* n_valid;   // the forward's weighted row count
  int valid_ge_zero;
  int R, V, W;
};

// Y rows a step: the sweeps 64, or 32 at WP = 256 (two warpgroups' stages
// of Y's hi / lo tiles, their D tiles and the raw X tile then fill 224 KB);
// K6 32 (its second dlog tile and exchange tile), with one warpgroup a
// block at WP = 256
template <int WP> constexpr int kSweepYn = WP == 256 ? 32 : 64;
constexpr int kSweepWgs = 2;
constexpr int kMergedYn = 32;
template <int WP> constexpr int kMergedWgs = WP == 256 ? 1 : 2;
template <int WP> constexpr int kLd = WP + 4;  // fp32 row stride of the output tiles

// ---------------------------------------------------------------------------
// fragments and tiles
// ---------------------------------------------------------------------------
// warpgroup wg's own barrier (id 0 is the block's)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kThreads) : "memory");
}

// the 64 x N accumulator s (row row0 + 8 h, column 8 j + 2 tq + e) split
// into the K-major B tile [64 rows][N, even-first] at t (lo parts lo bytes
// further)
template <int N>
__device__ __forceinline__ void store_k(uint8_t* t, int lo, const float (&s)[N / 2]) {
  const int tq = threadIdx.x & 3, row0 = frag_row();
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t o = at(kRows, row0 + 8 * h, 8 * j + tq + 4 * e);
        uint32_t hi, lw;
        split_into(s[4 * j + 2 * h + e], hi, lw);
        *reinterpret_cast<uint32_t*>(t + o) = hi;
        *reinterpret_cast<uint32_t*>(t + lo + o) = lw;
      }
}

// the same accumulator transposed: the K-major B tile [N rows][64,
// even-first]
template <int N>
__device__ __forceinline__ void store_kt(uint8_t* t, int lo, const float (&s)[N / 2]) {
  const int tq = threadIdx.x & 3, row0 = frag_row();
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t o = at(N, 8 * j + 2 * tq + e, kpos(row0 + 8 * h));
        uint32_t hi, lw;
        split_into(s[4 * j + 2 * h + e], hi, lw);
        *reinterpret_cast<uint32_t*>(t + o) = hi;
        *reinterpret_cast<uint32_t*>(t + lo + o) = lw;
      }
}

// a transposed 64 x N accumulator (M = output columns m0 + row0 + 8 h, N =
// output rows 8 j + 2 tq + e) into the fp32 tile out [rows][ld], or added
// to it (kAdd)
template <int N, bool kAdd = false>
__device__ __forceinline__ void store_rows(float* out, int ld, int m0,
                                           const float (&acc)[N / 2]) {
  const int tq = threadIdx.x & 3, row0 = frag_row();
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& o = out[(8 * j + 2 * tq + e) * ld + m0 + row0 + 8 * h];
        o = kAdd ? o + acc[4 * j + 2 * h + e] : acc[4 * j + 2 * h + e];
      }
}

// Rows [rank * ROWS / C, +ROWS / C) of the cluster's C fp32 tiles (row
// stride ld, WP columns) summed in rank order, four columns at a time, by
// NT threads (this one t among them): out(row, col, sum) for col < W.
template <int ROWS, int WP, int NT, typename F>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster, float* tile, int ld,
                                            int W, int t, F&& out) {
  const int C = (int)cluster.num_blocks(), rows = ROWS / C;
  const int r0 = (int)cluster.block_rank() * rows;
  for (int idx = t; idx < rows * (WP / 4); idx += NT) {
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

// ---------------------------------------------------------------------------
// the streamed rows' operands and dlog
// ---------------------------------------------------------------------------
// Into a stage, by a warpgroup's thread t: hidden rows y0 .. +N-1
// (kHiddenY) their lse [0, N) and labels [N, 2N); vocabulary rows their
// bias [0, N). Rows past the matrix are zero-filled (the epilogues mask
// them by index).
template <bool kHiddenY, int N>
__device__ __forceinline__ void load_stats(int t, uint32_t dst, const Args& a, int y0) {
  const int c = t % N, y = y0 + c;
  if constexpr (kHiddenY) {
    const bool ok = y < a.R;
    if (t < N)
      cp_async4(dst + 4 * c, ok ? a.lse + y : a.lse, ok ? 4 : 0);
    else if (t < 2 * N)
      cp_async4(dst + 4 * (N + c), ok ? a.labels + y : a.labels, ok ? 4 : 0);
  } else if (t < N) {
    const bool ok = y < a.V;
    cp_async4(dst + 4 * c, ok ? a.bias + y : a.bias, ok ? 4 : 0);
  }
}

// dlog in place of the logits s, X = hidden rows (lse, label, weight per X
// row h), Y = vocabulary entries y0 + column with their bias in bias_s
// (-inf past V, where the zero-filled table rows give s = 0)
template <int N>
__device__ __forceinline__ void dlog_hidden_x(float (&s)[N / 2], const float* bias_s, int y0,
                                              int V, const float (&lse)[2],
                                              const int (&lab)[2], const float (&w)[2]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
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
template <int N>
__device__ __forceinline__ void dlog_table_x(float (&s)[N / 2], const float* st, int y0,
                                             const Args& a, float scale, const int (&xv)[2],
                                             const float (&xb)[2], float (&db)[2]) {
  const int tq = threadIdx.x & 3;
  const int32_t* lab_s = reinterpret_cast<const int32_t*>(st + N);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
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

// ---------------------------------------------------------------------------
// the products of one step
// ---------------------------------------------------------------------------
// k-blocks whose A fragments are loaded together: one 32-column panel, half
// of one at WP = 256, where the 128 accumulator registers leave less room
template <int WP> constexpr int kChunk = WP == 256 ? 2 : 4;

// Issues NC chunks of KC k-blocks as one product chain: chunk c's A
// fragments, loaded by frag(c, q, hi, lo) for its q-th k-block, go to
// buffer c & 1, which is reused only once chunk c - 2's products are done
// (wait_group 1), so ptxas need not serialise the chain; mma(c, q, hi, lo)
// issues the k-block's three products; tail() runs once every chunk is
// issued, before the last products are waited on.
template <int KC, int NC, typename Frag, typename Mma, typename Tail>
__device__ __forceinline__ void chain(Frag&& frag, Mma&& mma, Tail&& tail) {
  uint32_t hi[2][KC][4], lo[2][KC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c >= 2) wgmma_wait_n<1>();
#pragma unroll
    for (int q = 0; q < KC; ++q) frag(c, q, hi[c & 1][q], lo[c & 1][q]);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < KC; ++q) mma(c, q, hi[c & 1][q], lo[c & 1][q]);
    wgmma_commit();
  }
  tail();
  wgmma_wait_n<0>();
}

// s = X Y^T over WP columns: X the raw 64-row tile at xs, Y's hi / lo tiles
// (N rows) at shared address yt / yt + ylo
template <int WP, int N>
__device__ __forceinline__ void product_s(float (&s)[N / 2], const uint8_t* xs, uint32_t yt,
                                          int ylo) {
  constexpr int KC = kChunk<WP>;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  chain<KC, WP / 8 / KC>(
      [&](int c, int q, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        frag_rows(hi, lo, xs, c * KC + q);
      },
      [&](int c, int q, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
        const int kb = c * KC + q;
        mma3_rs<N>(s, hi, lo, bdesc(yt, N, kb), bdesc(yt + ylo, N, kb));
      },
      [] {});
  fence_regs(s);
}

// For each block of 64 output columns m (WP / 64 of them): d = (columns
// 64 m .. of A^T) B over KB k-blocks of 8, formed in a fresh accumulator and
// handed to done(m, d). A^T from the tile at a (ROWS rows; raw and split,
// or hi / lo lo_off apart), B the K-major tile at shared address bt (bt +
// blo its lo part, brows rows); tail() runs once the last block's products
// are issued (every fragment read).
template <int WP, int N, int ROWS, int KB, bool kSplit, int KC, typename Done, typename Tail>
__device__ __forceinline__ void product_t(const uint8_t* a, int lo_off, uint32_t bt, int blo,
                                          int brows, Done&& done, Tail&& tail) {
#pragma unroll
  for (int m = 0; m < WP / 64; ++m) {
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    fence_regs(d);
    chain<KC, KB / KC>(
        [&](int c, int q, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          frag_cols<ROWS, kSplit>(hi, lo, a, lo_off, 64 * m, c * KC + q);
        },
        [&](int c, int q, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
          const int kb = c * KC + q;
          mma3_rs<N>(d, hi, lo, bdesc(bt, brows, kb), bdesc(bt + blo, brows, kb));
        },
        [&] {
          if (m == WP / 64 - 1) tail();
        });
    fence_regs(d);
    done(m, d);
  }
}

// ---------------------------------------------------------------------------
// K7's sweeps: block rank of cluster x holds X tile x and streams the Y tiles
// rank, rank + C, ..., its two warpgroups taking them in turn; kTableX: the
// dt sweep (X = vocabulary tiles, writes dt and db), else the dh sweep (X =
// hidden row tiles, writes dh).
// ---------------------------------------------------------------------------
template <int WP, int YN>
struct SweepShape {
  static constexpr int G = kSweepWgs;
  static constexpr int kYPlane = YN * WP * 4, kYStage = 2 * kYPlane;
  static constexpr int kDPlane = kRows * YN * 4, kDTile = 2 * kDPlane;
  static constexpr int kY = 0, kD = G * kYStage, kX = kD + G * kDTile;
  static constexpr int kS = kX + kRows * WP * 4, kStat = 8 * YN;
  static constexpr size_t kSmem = 1024 + (size_t)kS + G * kStat;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
  static_assert((size_t)kRows * kLd<WP> * 4 + G * kRows * 4 <= (size_t)kX, "the output tile");
};

template <int WP, int YN, bool kTableX>
__global__ void __launch_bounds__(kSweepWgs * kThreads, 1)
loss_tf32_sweep_kernel(Args a, float* dh, float* dt, float* db) {
  using L = SweepShape<WP, YN>;
  constexpr int G = L::G;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);

  const int wg = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
  const int tq = lt & 3, row0 = frag_row();
  const int x0 = (int)(blockIdx.x / C) * kRows;
  const float* X = kTableX ? a.table : a.hidden;
  const float* Y = kTableX ? a.hidden : a.table;
  const int xn = kTableX ? a.V : a.R, yn = kTableX ? a.R : a.V;
  const int ytiles = cdiv(yn, YN);
  const int n = rank < ytiles ? cdiv(ytiles - rank, C) : 0;  // this block's Y tiles
  const float scale = a.g[0] / fmaxf(a.n_valid[0], 1.f);
  // this warpgroup's stage, D tile and streamed rows' operands
  uint8_t* yt = sm + L::kY + wg * L::kYStage;
  const uint32_t ya = base + L::kY + wg * L::kYStage, da = base + L::kD + wg * L::kDTile;
  const uint32_t sa = base + L::kS + wg * L::kStat;
  const float* stats = reinterpret_cast<const float*>(sm + L::kS + wg * L::kStat);

  auto prefetch = [&](int item) {
    const int y0 = (rank + item * C) * YN;
#pragma unroll
    for (int p = 0; p < WP / 32; ++p)
      copy_panel_t<YN, kThreads>(lt, ya + p * YN * 128, Y, a.W, y0, yn, 32 * p, a.W);
    load_stats<kTableX, YN>(lt, sa, a, y0);
  };
#pragma unroll
  for (int p = 0; p < WP / 32; ++p)
    copy_panel_t<kRows, G * kThreads>(threadIdx.x, base + L::kX + p * kRows * 128, X, a.W, x0,
                                      xn, 32 * p, a.W);
  if (wg < n) prefetch(wg);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the X tile is complete for both warpgroups

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
  float acc[WP / 64][32], dbs[2] = {0.f, 0.f};
#pragma unroll
  for (int m = 0; m < WP / 64; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  for (int item = wg; item < n; item += G) {
    cp_async_wait<0>();
    const int y0 = (rank + item * C) * YN;
#pragma unroll
    for (int p = 0; p < WP / 32; ++p)
      split_panel_t<YN, kThreads>(lt, yt + p * YN * 128, L::kYPlane);
    fence_async_smem();
    wg_sync(wg);
    float s[YN / 2];
    product_s<WP, YN>(s, sm + L::kX, ya, L::kYPlane);
    if constexpr (kTableX)
      dlog_table_x<YN>(s, stats, y0, a, scale, xi, xb, dbs);
    else
      dlog_hidden_x<YN>(s, stats, y0, a.V, xl, xi, xw);
    store_k<YN>(sm + L::kD + wg * L::kDTile, L::kDPlane, s);
    fence_async_smem();
    wg_sync(wg);
    product_t<WP, 64, YN, YN / 8, false, kChunk<WP>>(
        yt, L::kYPlane, da, L::kDPlane, kRows,
        [&](int m, const float (&d)[32]) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[m][i] += d[i];
        },
        [&] {  // every thread of the warpgroup is done with the stage
          wg_sync(wg);
          if (item + G < n) prefetch(item + G);
          cp_async_commit();
        });
  }
  cp_async_wait<0>();
  __syncthreads();

  // the two warpgroups' partials summed in order, then the cluster's in
  // rank order: every block sums 64 / C rows of all C
  float* part = reinterpret_cast<float*>(sm);
  float* dbp = part + kRows * kLd<WP>;  // [G][64]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (wg == g) {
#pragma unroll
      for (int m = 0; m < WP / 64; ++m) {
        if (g == 0)
          store_rows<64>(part, kLd<WP>, 64 * m, acc[m]);
        else
          store_rows<64, true>(part, kLd<WP>, 64 * m, acc[m]);
      }
    }
    __syncthreads();
  }
  if constexpr (kTableX) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = quad_sum(dbs[h]);
      if (tq == 0) dbp[wg * kRows + row0 + 8 * h] = v;
    }
  }
  cluster.sync();
  const int W = a.W;
  float* out = kTableX ? dt : dh;
  cluster_sum<kRows, WP, G * kThreads>(cluster, part, kLd<WP>, W, threadIdx.x,
                                       [&](int row, int col, float4 v) {
                                         const int x = x0 + row;
                                         if (x < xn)
                                           *reinterpret_cast<float4*>(
                                               out + (size_t)x * W + col) = v;
                                       });
  if constexpr (kTableX) {
    const int rows = kRows / C, row = rank * rows + (int)threadIdx.x;
    if ((int)threadIdx.x < rows && x0 + row < a.V) {
      float sum = 0.f;
      for (int k = 0; k < C; ++k) {
        const float* p = cluster.map_shared_rank(dbp, k);
        float v = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) v += p[g * kRows + row];
        sum += v;
      }
      db[x0 + row] = sum;
    }
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

// ---------------------------------------------------------------------------
// K6: cluster c, block rank, takes the groups c, c + n_clusters, ... of C
// vocabulary tiles (its tile: group * C + rank; past V a zero tile whose
// outputs are dropped) and for each sweeps the hidden rows 32 at a time, its
// G warpgroups taking the row tiles in turn, writing the tile's dt and db
// once and adding the cluster's dh sums into part_dh[c].
// ---------------------------------------------------------------------------
template <int WP, int G>
struct MergedShape {
  static constexpr int YN = kMergedYn;
  static constexpr int kYPlane = YN * WP * 4, kYStage = 2 * kYPlane;
  static constexpr int kDPlane = kRows * YN * 4, kDTile = 2 * kDPlane;  // D and D2 alike
  static constexpr int kY = 0, kD = G * kYStage, kX = kD + G * 2 * kDTile;
  static constexpr int kXch = YN * kLd<WP> * 4;
  static constexpr int kC = kX + kRows * WP * 4, kS = kC + G * kXch, kStat = 8 * YN;
  static constexpr size_t kSmem = 1024 + (size_t)kS + G * kStat;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
  static_assert((size_t)kRows * kLd<WP> * 4 + G * kRows * 4 <= (size_t)kX, "the dt tile");
};

template <int WP, int G>
__global__ void __launch_bounds__(G * kThreads, 1)
loss_tf32_merged_kernel(Args a, float* dt, float* db, float* part_dh, int n_clusters) {
  using L = MergedShape<WP, G>;
  constexpr int YN = L::YN;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = (int)blockIdx.x / C;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);

  const int wg = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
  const int tq = lt & 3, row0 = frag_row();
  const int W = a.W, vtiles = cdiv(a.V, kRows), groups = cdiv(vtiles, C);
  const int ytiles = cdiv(a.R, YN), steps = cdiv(ytiles, G);
  const float scale = a.g[0] / fmaxf(a.n_valid[0], 1.f);
  float* mine = part_dh + (size_t)cid * a.R * W;
  // this warpgroup's stage, dlog tiles, exchange tile and row operands
  uint8_t* yt = sm + L::kY + wg * L::kYStage;
  const uint32_t ya = base + L::kY + wg * L::kYStage;
  const int d1 = L::kD + wg * 2 * L::kDTile, d2 = d1 + L::kDTile;
  float* xch = reinterpret_cast<float*>(sm + L::kC + wg * L::kXch);
  const uint32_t sa = base + L::kS + wg * L::kStat;
  const float* stats = reinterpret_cast<const float*>(sm + L::kS + wg * L::kStat);

  auto prefetch = [&](int item) {
#pragma unroll
    for (int p = 0; p < WP / 32; ++p)
      copy_panel_t<YN, kThreads>(lt, ya + p * YN * 128, a.hidden, W, item * YN, a.R, 32 * p,
                                 W);
    load_stats<true, YN>(lt, sa, a, item * YN);
  };
  bool pending = false;  // an arrive on the cluster barrier not yet waited on
  for (int grp = cid, first = 1; grp < groups; grp += n_clusters, first = 0) {
    const int v0 = (grp * C + rank) * kRows;
#pragma unroll
    for (int p = 0; p < WP / 32; ++p)
      copy_panel_t<kRows, G * kThreads>(threadIdx.x, base + L::kX + p * kRows * 128, a.table, W,
                                        v0, a.V, 32 * p, W);
    if (wg < ytiles) prefetch(wg);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the X tile is complete for every warpgroup
    int xi[2];
    float xb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xi[h] = v0 + row0 + 8 * h;
      xb[h] = xi[h] < a.V ? a.bias[xi[h]] : -INFINITY;
    }
    float acc[WP / 64][32], dbs[2] = {0.f, 0.f};
#pragma unroll
    for (int m = 0; m < WP / 64; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
    // every warpgroup meets the cluster barriers of every step, with a row
    // tile or without one (past R)
    for (int step = 0; step < steps; ++step) {
      const int item = step * G + wg, r0 = item * YN;
      const bool active = item < ytiles;
      if (active) {
        cp_async_wait<0>();
#pragma unroll
        for (int p = 0; p < WP / 32; ++p)
          split_panel_t<YN, kThreads>(lt, yt + p * YN * 128, L::kYPlane);
        fence_async_smem();
        wg_sync(wg);
        float s[YN / 2];
        product_s<WP, YN>(s, sm + L::kX, ya, L::kYPlane);
        dlog_table_x<YN>(s, stats, r0, a, scale, xi, xb, dbs);
        store_k<YN>(sm + d1, L::kDPlane, s);
        store_kt<YN>(sm + d2, L::kDPlane, s);
        fence_async_smem();
        wg_sync(wg);
        // dt^T += H^T dlog^T over the 32 rows
        product_t<WP, 64, YN, YN / 8, false, kChunk<WP>>(
            yt, L::kYPlane, base + d1, L::kDPlane, kRows,
            [&](int m, const float (&d)[32]) {
#pragma unroll
              for (int i = 0; i < 32; ++i) acc[m][i] += d[i];
            },
            [&] {  // every thread of the warpgroup is done with the stage
              wg_sync(wg);
              if (item + G < ytiles) prefetch(item + G);
              cp_async_commit();
            });
      }
      if (pending) cluster_wait();  // the peers have read the exchange tiles
      if (active) {
        // this tile's dh contribution, dh^T = X^T dlog, 64 columns at a time
#pragma unroll
        for (int m = 0; m < WP / 64; ++m)
          product_t<64, YN, kRows, kRows / 8, true, kChunk<WP>>(
              sm + L::kX + m * 2 * kRows * 128, 0, base + d2, L::kDPlane, YN,
              [&](int, const float (&d)[YN / 2]) { store_rows<YN>(xch, kLd<WP>, 64 * m, d); },
              [] {});
      }
      cluster_arrive();
      cluster_wait();  // every block's contributions are in its exchange tiles
      if (active)
        cluster_sum<YN, WP, kThreads>(cluster, xch, kLd<WP>, W, lt,
                                      [&](int row, int col, float4 v) {
                                        const int r = r0 + row;
                                        if (r >= a.R) return;
                                        float4* p =
                                            reinterpret_cast<float4*>(mine + (size_t)r * W + col);
                                        if (!first) {
                                          const float4 o = *p;
                                          v.x += o.x;
                                          v.y += o.y;
                                          v.z += o.z;
                                          v.w += o.w;
                                        }
                                        *p = v;
                                      });
      // the next step rewrites the stages and dlog tiles only after the
      // barrier above (every thread's products done) and the exchange
      // tiles only after the peers' arrive below
      cluster_arrive();
      pending = true;
    }
    cp_async_wait<0>();
    __syncthreads();
    // this tile's dt (the warpgroups' partials summed in order, through a
    // row tile over the free stages) and db, once
    float* part = reinterpret_cast<float*>(sm);
    float* dbp = part + kRows * kLd<WP>;  // [G][64]
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (wg == g) {
#pragma unroll
        for (int m = 0; m < WP / 64; ++m) {
          if (g == 0)
            store_rows<64>(part, kLd<WP>, 64 * m, acc[m]);
          else
            store_rows<64, true>(part, kLd<WP>, 64 * m, acc[m]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = quad_sum(dbs[h]);
          if (tq == 0) dbp[g * kRows + row0 + 8 * h] = v;
        }
      }
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kRows * (WP / 4); idx += G * kThreads) {
      const int row = idx / (WP / 4), col = 4 * (idx % (WP / 4));
      if (col < W && v0 + row < a.V)
        *reinterpret_cast<float4*>(dt + (size_t)(v0 + row) * W + col) =
            *reinterpret_cast<const float4*>(part + row * kLd<WP> + col);
    }
    if ((int)threadIdx.x < kRows && v0 + (int)threadIdx.x < a.V) {
      float v = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) v += dbp[g * kRows + threadIdx.x];
      db[v0 + threadIdx.x] = v;
    }
    __syncthreads();  // X, the stages and the dt tile are reloaded for the next group
  }
  if (pending) cluster_wait();  // no block leaves while a peer reads its tiles
}

// ---------------------------------------------------------------------------
// K3's and K5's first pass, loss_tf32_fwd_sweep_kernel<WP>: per block (row
// block, vocabulary split), the split's per-row (max, sum of exp at it,
// label logit) into part_*[split][row]; the caller merges the splits in
// split order. Labels outside [0, V) match no column. Two bodies by width:
//
// WP = 256, fwd_tiles: block (row tile x, split) holds hidden rows x0 ..
// +63 (the X tile) raw and streams the split's vocabulary tiles of YN
// entries with their bias, its two warpgroups taking them in turn, each
// with its own stage (a tile lands raw by cp.async and each thread splits
// the chunks it copied). The A fragments (256 registers at this width) are
// read and split from the raw X tile per step, as the sweeps do. Per tile:
// s = X Y^T, then the tile's logits (its bias added, -inf past V) folded
// into the warpgroup's running max and sum of exponentials and its label
// logit while the other warpgroup's products run. The two warpgroups' row
// stats are merged in order.
// ---------------------------------------------------------------------------
struct FwdArgs {
  const float* hidden;    // [R, W]
  const float* table;     // [V, W]
  const float* bias;      // [V], vocab padding at -1e9
  const int32_t* labels;  // [R]
  float *part_m, *part_s, *part_ll;  // [splits][R]
  int R, V, W, splits;
};

constexpr int kFwdTileItems = 512;  // fwd_tiles' splits bring the grid to ~this many blocks

template <int WP>
struct FwdShape {
  static constexpr int G = kSweepWgs, YN = kSweepYn<WP>;
  static constexpr int kYPlane = YN * WP * 4, kYStage = 2 * kYPlane;
  static constexpr int kY = 0, kX = G * kYStage, kB = kX + kRows * WP * 4;
  static constexpr int kM = kB + G * YN * 4;  // warpgroup 1's row stats [3][64]
  static constexpr size_t kSmem = 1024 + (size_t)kM + 3 * kRows * 4;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

template <int WP>
__device__ __forceinline__ void fwd_tiles(const FwdArgs& a) {
  using L = FwdShape<WP>;
  constexpr int G = L::G, YN = L::YN;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);

  const int wg = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
  const int tq = lt & 3, row0 = frag_row();
  const int x0 = (int)blockIdx.x * kRows, split = (int)blockIdx.y;
  const int vtiles = cdiv(a.V, YN);
  const int t0 = (int)((long)split * vtiles / a.splits);
  const int n = (int)((long)(split + 1) * vtiles / a.splits) - t0;  // the split's tiles
  // this warpgroup's stage and its tile's bias
  uint8_t* yt = sm + L::kY + wg * L::kYStage;
  const uint32_t ya = base + L::kY + wg * L::kYStage, ba = base + L::kB + wg * YN * 4;
  const float* bias_s = reinterpret_cast<const float*>(sm + L::kB + wg * YN * 4);

  auto prefetch = [&](int item) {
    const int y0 = (t0 + item) * YN;
#pragma unroll
    for (int p = 0; p < WP / 32; ++p)
      copy_panel_t<YN, kThreads>(lt, ya + p * YN * 128, a.table, a.W, y0, a.V, 32 * p, a.W);
    if (lt < YN) {
      const bool ok = y0 + lt < a.V;
      cp_async4(ba + 4 * lt, ok ? a.bias + y0 + lt : a.bias, ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int p = 0; p < WP / 32; ++p)
    copy_panel_t<kRows, G * kThreads>(threadIdx.x, base + L::kX + p * kRows * 128, a.hidden,
                                      a.W, x0, a.R, 32 * p, a.W);
  if (wg < n) prefetch(wg);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the X tile is complete for both warpgroups

  int lab[2];
  float m[2], l[2], ll[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = x0 + row0 + 8 * h, y = r < a.R ? a.labels[r] : -1;
    lab[h] = (y >= 0 && y < a.V) ? y : -(1 << 30);
    m[h] = -INFINITY;
    l[h] = ll[h] = 0.f;
  }
  for (int item = wg; item < n; item += G) {
    cp_async_wait<0>();
#pragma unroll
    for (int p = 0; p < WP / 32; ++p)
      split_panel_t<YN, kThreads>(lt, yt + p * YN * 128, L::kYPlane);
    fence_async_smem();
    wg_sync(wg);
    float s[YN / 2];
    product_s<WP, YN>(s, sm + L::kX, ya, L::kYPlane);
    const int y0 = (t0 + item) * YN;
    if (y0 + YN > a.V)
      loss_hopper::add_bias<YN, true>(s, s, bias_s, a.V - y0);
    else
      loss_hopper::add_bias<YN, false>(s, s, bias_s, YN);
    wg_sync(wg);  // every thread of the warpgroup is done with the stage
    if (item + G < n) prefetch(item + G);
    cp_async_commit();
    const int rel[2] = {lab[0] - y0, lab[1] - y0};
    loss_hopper::fold_tile<YN>(s, rel, m, l, ll);
  }
  cp_async_wait<0>();

  // warpgroup 1's row stats merged into warpgroup 0's, then written
  float* ms = reinterpret_cast<float*>(sm + L::kM);
  float ls[2], lls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ls[h] = quad_sum(l[h]);
    lls[h] = quad_sum(ll[h]);
    if (wg == 1 && tq == 0) {
      const int r = row0 + 8 * h;
      ms[r] = m[h];
      ms[kRows + r] = ls[h];
      ms[2 * kRows + r] = lls[h];
    }
  }
  __syncthreads();
  if (wg != 0 || tq != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h, x = x0 + r;
    if (x >= a.R) continue;
    const float m1 = ms[r], mn = fmaxf(m[h], m1);
    const size_t o = (size_t)split * a.R + x;
    a.part_m[o] = mn;
    a.part_s[o] = ls[h] * ex2((m[h] - mn) * kLog2e) + ms[kRows + r] * ex2((m1 - mn) * kLog2e);
    a.part_ll[o] = lls[h] + ms[2 * kRows + r];
  }
}

// ---------------------------------------------------------------------------
// WP <= 128, fwd_rows: block (row block x of 128 rows, split) streams the
// split's vocabulary tiles of kFwdYn entries through a ring of kFwdStages
// stages, both warpgroups reading each tile: a warpgroup holds its 64
// hidden rows' A fragments in registers, split into hi / lo once, so each
// table tile crosses L2 and is split once per 128 rows (half the traffic
// and splits of fwd_tiles' 64). One step, tile i in stage i % kFwdStages:
//   issue s = X Y^T on stage i into cur (one commit group, in flight while
//   the CUDA cores work); prefetch tile i + 2 into the stage tile i - 1
//   left; split tile i + 1 (each thread the chunks it copied, so no barrier
//   between its copy and its split); fold tile i - 1's logits (prev) into
//   the rows' max, sum of exponentials and label logit; wait for cur, add
//   its bias into prev; one block barrier (tile i + 1 split, stage i free).
// No product is in flight from one step to the next.
// ---------------------------------------------------------------------------
constexpr int kFwdYn = 64, kFwdStages = 3, kFwdBlockRows = 2 * kRows;
constexpr int kFwdRowItems = 1024;  // fwd_rows' splits bring the grid to ~this many blocks

template <int WP>
struct FwdRowsShape {
  static constexpr int kYPlane = kFwdYn * WP * 4, kYStage = 2 * kYPlane;
  static constexpr int kB = kFwdStages * kYStage;  // the stages' bias [S][kFwdYn]
  static constexpr int kX = 2 * kYStage;           // the raw X tiles, before the loop
  static constexpr size_t kSmem = 1024 + (size_t)kB + kFwdStages * kFwdYn * 4;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
  static_assert(2 * kRows * WP * 4 <= kYStage, "the X tiles fill one stage");
};

template <int WP>
__device__ __forceinline__ void fwd_rows(const FwdArgs& a) {
  using L = FwdRowsShape<WP>;
  constexpr int YN = kFwdYn, S = kFwdStages, NT = kSweepWgs * kThreads;
  uint8_t* sm = aligned_smem();
  const uint32_t base = smem_u32(sm);

  const int wg = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
  const int tq = lt & 3, row0 = frag_row();
  const int x0 = (int)blockIdx.x * kFwdBlockRows + wg * kRows, split = (int)blockIdx.y;
  const int vtiles = cdiv(a.V, YN);
  const int t0 = (int)((long)split * vtiles / a.splits);
  const int n = (int)((long)(split + 1) * vtiles / a.splits) - t0;  // the split's tiles
  const float* bias_s = reinterpret_cast<const float*>(sm + L::kB);

  auto prefetch = [&](int item) {
    const int st = item % S, y0 = (t0 + item) * YN;
#pragma unroll
    for (int p = 0; p < WP / 32; ++p)
      copy_panel_t<YN, NT>(threadIdx.x, base + st * L::kYStage + p * YN * 128, a.table, a.W,
                           y0, a.V, 32 * p, a.W);
    if (threadIdx.x < YN) {
      const bool ok = y0 + (int)threadIdx.x < a.V;
      cp_async4(base + L::kB + 4 * (st * YN + threadIdx.x),
                ok ? a.bias + y0 + threadIdx.x : a.bias, ok ? 4 : 0);
    }
  };
  auto split_stage = [&](int item) {
#pragma unroll
    for (int p = 0; p < WP / 32; ++p)
      split_panel_t<YN, NT>(threadIdx.x, sm + (item % S) * L::kYStage + p * YN * 128,
                            L::kYPlane);
  };
  // this warpgroup's 64 rows raw into stage 2's space, tiles 0 and 1 into
  // stages 0 and 1
  const uint32_t xa = base + L::kX + wg * kRows * WP * 4;
#pragma unroll
  for (int p = 0; p < WP / 32; ++p)
    copy_panel_t<kRows, kThreads>(lt, xa + p * kRows * 128, a.hidden, a.W, x0, a.R, 32 * p,
                                  a.W);
  cp_async_commit();
  if (n > 0) prefetch(0);
  cp_async_commit();
  if (n > 1) prefetch(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // the X tiles are complete
  uint32_t xh[WP / 8][4], xl[WP / 8][4];
#pragma unroll
  for (int kb = 0; kb < WP / 8; ++kb)
    frag_rows(xh[kb], xl[kb], sm + L::kX + wg * kRows * WP * 4, kb);
  if (n > 0) split_stage(0);
  fence_async_smem();
  __syncthreads();  // tile 0 is split, every X fragment read: stage 2 is free

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
  float cur[YN / 2], prev[YN / 2];
  for (int item = 0; item < n; ++item) {
    const uint32_t ya = base + (item % S) * L::kYStage;
#pragma unroll
    for (int i = 0; i < YN / 2; ++i) cur[i] = 0.f;
    fence_regs(cur);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < WP / 8; ++kb)
      mma3_rs<YN>(cur, xh[kb], xl[kb], bdesc(ya, YN, kb), bdesc(ya + L::kYPlane, YN, kb));
    wgmma_commit();
    if (item + 2 < n) prefetch(item + 2);
    cp_async_commit();
    if (item + 1 < n) {
      cp_async_wait<1>();  // tile item + 1, this thread's chunks
      split_stage(item + 1);
      fence_async_smem();
    }
    const int v0 = (t0 + item) * YN;
    if (item > 0) {
      const int rel[2] = {lab[0] - (v0 - YN), lab[1] - (v0 - YN)};
      loss_hopper::fold_tile<YN>(prev, rel, m, l, ll);
    }
    wgmma_wait_n<0>();
    fence_regs(cur);
    const float* b = bias_s + (item % S) * YN;
    if (v0 + YN > a.V)
      loss_hopper::add_bias<YN, true>(prev, cur, b, a.V - v0);
    else
      loss_hopper::add_bias<YN, false>(prev, cur, b, YN);
    __syncthreads();  // tile item + 1 is split by all, stage item is free
  }
  if (n > 0) {
    const int v0 = (t0 + n - 1) * YN;
    const int rel[2] = {lab[0] - v0, lab[1] - v0};
    loss_hopper::fold_tile<YN>(prev, rel, m, l, ll);
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

template <int WP>
__global__ void __launch_bounds__(kSweepWgs * kThreads, 1)
loss_tf32_fwd_sweep_kernel(FwdArgs a) {
  if constexpr (WP <= 128)
    fwd_rows<WP>(a);
  else
    fwd_tiles<WP>(a);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
// kSweepYn<WP> at the width W pads to
inline int sweep_yn(int W) {
  return loss_hopper::padded_width(W) == 256 ? kSweepYn<256> : kSweepYn<128>;
}

// K3's and K5's vocabulary splits: the fewest that bring (row blocks x
// splits) to a target, at most one per vocabulary tile. One block an SM, so
// the target is a number of whole waves that the tail does not cut short:
// fwd_rows (WP <= 128) 128-row blocks, kFwdYn-entry tiles, ~kFwdRowItems
// blocks (bf16 K5's law: at ML-20M's batch, R = 10,240, V = 26,732, 80 row
// blocks x 13 splits, 7.9 waves on 132 SMs, which measured 12% faster than
// 7 splits' 4.2 waves on an H100); fwd_tiles (WP = 256) 64-row tiles,
// kSweepYn<256>-entry tiles, ~kFwdTileItems blocks (160 x 4 there; 7
// splits measured 3% slower).
inline int fwd_splits(int R, int V, int W) {
  const bool rows = loss_hopper::padded_width(W) <= 128;
  const int xr = rows ? kFwdBlockRows : kRows, yn = rows ? kFwdYn : kSweepYn<256>;
  const int items = rows ? kFwdRowItems : kFwdTileItems;
  const int rblocks = (R + xr - 1) / xr, vtiles = (V + yn - 1) / yn;
  return std::max(1, std::min(vtiles, (items + rblocks - 1) / rblocks));
}

// K3's and K5's first pass; a.splits = fwd_splits(R, V, W)
template <int WP>
cudaError_t fwd_sweep(const FwdArgs& a, cudaStream_t st) {
  size_t smem;
  int xr;  // rows a block
  if constexpr (WP <= 128) {
    smem = FwdRowsShape<WP>::kSmem;
    xr = kFwdBlockRows;
  } else {
    smem = FwdShape<WP>::kSmem;
    xr = kRows;
  }
  cudaError_t err = allow_smem(loss_tf32_fwd_sweep_kernel<WP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.R + xr - 1) / xr, a.splits);
  loss_tf32_fwd_sweep_kernel<WP><<<grid, kSweepWgs * kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// K7: the dh sweep, then the dt sweep
template <int WP>
cudaError_t two_sweep(const Args& a, float* dh, float* dt, float* db, cudaStream_t st) {
  constexpr int YN = kSweepYn<WP>, NT = kSweepWgs * kThreads;
  constexpr size_t smem = SweepShape<WP, YN>::kSmem;
  const int rtiles = (a.R + kRows - 1) / kRows, vtiles = (a.V + kRows - 1) / kRows;
  int c_dh, c_dt;
  loss_hopper::sweep_clusters(a.R, a.V, YN, c_dh, c_dt);
  cudaError_t err = launch_clusters_n(loss_tf32_sweep_kernel<WP, YN, false>, rtiles * c_dh,
                                      c_dh, NT, smem, st, a, dh, dt, db);
  if (err != cudaSuccess) return err;
  return launch_clusters_n(loss_tf32_sweep_kernel<WP, YN, true>, vtiles * c_dt, c_dt, NT,
                           smem, st, a, dh, dt, db);
}

// K6's sweep; the caller reduces part_dh's loss_hopper::merged_clusters(V)
// partials
template <int WP>
cudaError_t merged_sweep(const Args& a, float* dt, float* db, float* part_dh,
                         cudaStream_t st) {
  constexpr int G = kMergedWgs<WP>;
  const int c = loss_hopper::merged_cluster(a.V), n = loss_hopper::merged_clusters(a.V);
  return launch_clusters_n(loss_tf32_merged_kernel<WP, G>, n * c, c, G * kThreads,
                           MergedShape<WP, G>::kSmem, st, a, dt, db, part_dh, n);
}

}  // namespace loss_tf32
}  // namespace b4r
