// Fused tied-softmax masked cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of bert4rec_tpu/ops/fused_mlm_loss.py:
//   K3  _fwd_kernel (launched by _run_forward)            whole-table forward
//   K4  _bwd_kernel (launched by _run_backward)           whole-table backward
//   K5  _fwd_kernel_tiled (_tiled_fwd_call, for _run_forward_tiled and
//       _run_forward_tiled_stats)                         vocab-tiled forward
//   K6  _bwd_merged_kernel (_run_backward_merged)         one-recompute backward
//   K7  _bwd_dh_kernel + _bwd_dt_kernel (_run_backward_tiled)  two-sweep backward
// over hidden [R, W] and the tied table [V, W] (both in T = float or bf16,
// the table already cast to the hidden dtype as the JAX kernels stream it),
// bias [V] fp32 with vocab-padding columns at -1e9, labels [R] int32
// (0 = padding row):
//
//   logits = hidden table^T + bias                         (fp32, never stored)
//   lse    = max + log(sum exp(logits - max))              per row, kept
//   nll    = (lse - logits[label]) * (label > 0)
//   correct = logits[label] >= max and label >= 0  (ties count, as on the TPU)
//   sums   = (sum nll, sum correct * w, sum correct, sum w)
//   dlog   = (exp(logits - lse) - onehot) * w * g / max(n_valid, 1)
//   dh     = T(T(dlog) table),  dtable = T(dlog)^T hidden,  dbias = sum dlog
//
// with w = label > 0, or label >= 0 under valid_ge_zero (the sharded loss's
// label encoding: a local index, a positive sentinel past the table for a
// remote label, -1 for none). A label outside [0, V) matches no column.
//
// Design. The point of the TPU kernels is never to materialise the [R, V]
// fp32 logits. The TPU held a whole table (K3/K4) or a 1,024-column tile
// (K5-K7) in VMEM; an H100 block has 227 KB, so every kernel here streams
// 64-row tiles and recomputes the logits tile it needs. By operand type
// (an explicit dispatch on `dtype`, nothing caught):
//   bf16 K3             K5's two passes over the whole table: the sweep
//                       below, then loss_tiled_merge_kernel, m / s / ll not
//                       written. Split law: K5's (fwd_splits, mirrored
//                       by ops/fused_mlm_loss.py whole_table_splits),
//                       ~1,024 blocks; at ml-1m's batch (R = 10,240, V =
//                       3,709, W = 128) 13 splits x 80 row blocks, which
//                       measured faster than one split's 80 blocks on 132
//                       SMs (PERF.md)
//   bf16 K4-K7          loss_hopper.cuh's wgmma kernels: bf16 tiles by
//                       cp.async into the 128-byte swizzle, the logits in
//                       registers. K5: blocks of 128 hidden rows (two
//                       warpgroups, the rows as register A fragments) share
//                       each streamed vocabulary tile; one tile's online
//                       max / sum of exponentials runs while the next tile's
//                       product does; the vocabulary is split until the grid
//                       holds ~1,024 blocks, and each split's per-row (max,
//                       sum, label logit) goes to a workspace. K4 and K7: a
//                       dh sweep (a hidden row tile per cluster) and a dt
//                       sweep (a vocabulary tile per cluster), each splitting
//                       its streamed tiles over the cluster's blocks and
//                       summing their fp32 partials in rank order through
//                       distributed shared memory: no workspace (K4 reads
//                       K3's lse, K7 K5's; the function is the same). K6:
//                       clusters of 8 vocabulary tiles sweep the row tiles
//                       in step; per row tile their dh contributions are
//                       summed through distributed shared memory and written
//                       once into the cluster's fp32 dh partial (at most 32
//                       partials of R x W, reduced in cluster order: 168 MB
//                       at R = 10,240, W = 128, any V). Layout rule, which
//                       the wrapper checks first: hidden and table
//                       contiguous, 16-byte aligned base and rows (W a
//                       multiple of 8), W <= 256 (zero-filled to 64, 128 or
//                       256).
//   fp32 K3-K7          loss_tf32.cuh's 3xTF32 wgmma kernels, the bf16
//                       designs' sweeps and clusters with every product's
//                       A operand in registers (.tf32 wgmma reads shared
//                       memory only K-major). K3 and K5 (both entries):
//                       loss_tf32_fwd_sweep_kernel (at W <= 128 blocks of
//                       128 hidden rows, each warpgroup's 64 held as A
//                       fragments split into hi / lo once, both sharing
//                       each streamed vocabulary tile, as bf16 K5; at W =
//                       256 64-row tiles whose warpgroups take the tiles in
//                       turn) over the vocabulary splits (fwd_splits, one
//                       block an SM: bf16 K5's law at W <= 128, ~512 blocks
//                       at W = 256; mirrored by tiled_forward_splits), then
//                       loss_tiled_merge_kernel. K4 and K7:
//                       loss_tf32_sweep_kernel's dh and dt sweeps, no
//                       workspace (K4 from K3's lse). K6:
//                       loss_tf32_merged_kernel, the same <= 32 cluster dh
//                       partials as bf16 K6. Layout rule, which the
//                       wrapper meets by copying: hidden and table
//                       contiguous, 16-byte aligned base and rows (W a
//                       multiple of 4), W <= 256 (zero-filled to 64, 128
//                       or 256).
//   the second pass     loss_tiled_merge_kernel (K3 and K5, both types):
//                       each row's splits merged in split order into lse,
//                       the stats and the four sums
// The backwards read the forward's lse (the JAX whole-table backward
// recomputes max and sum; the difference is fp32 rounding, within the
// tolerance the tests state). dlog is rounded to the hidden dtype before
// both products and dbias sums the unrounded dlog, as JAX's kernels do. No
// float atomics: two runs give the same bits. No workspace grows with V.
//
// Bound. 2 R V W FLOP forward, 6 R V W backward (the logits, dh, dtable; K7
// recomputes the logits once more, which the bound does not count), against
// megabytes of inputs: bound by operations (0.071 ms for K5 and 0.213 ms for
// K6 at the ML-20M batch, R = 10,240, V = 26,732, W = 128, and 0.00983 ms
// for bf16 K3 at ml-1m's, at 989 TFLOP/s; fp32 K5 / K6 there 0.425 / 1.274
// ms and fp32 K3 / K4 at ml-1m's 0.059 / 0.177 ms at 3xTF32's 165
// TFLOP/s). K5 also takes one exponential per (row, vocabulary entry): 274
// M at that batch, about as long on the special-function units as its bf16
// products on the tensor cores, which is why its designs overlap the two.

#include "common.cuh"
#include "loss_hopper.cuh"
#include "loss_tf32.cuh"

namespace {

using namespace b4r;

constexpr int LT = 64;  // rows per row tile and per vocabulary tile
constexpr int LOSS_MAXW = 256;
// K3 and K5, second pass: one thread per row merges its splits in split order into
// (max, sum, label logit) and lse, and the block's rows into partials of the
// four sums (a fixed tree, then reduce_rows). Null lse / sums: the stats
// entry; null m_out: the loss entry.
__global__ void __launch_bounds__(256)
loss_tiled_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                        const float* __restrict__ part_ll, const int32_t* __restrict__ labels,
                        int R, int n_splits, float* __restrict__ lse_out,
                        float* __restrict__ m_out, float* __restrict__ s_out,
                        float* __restrict__ ll_out, float* __restrict__ part_sums) {
  __shared__ float red[4][256];
  const int tid = threadIdx.x, r = blockIdx.x * 256 + tid;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (r < R) {
    float m = part_m[r];
    for (int k = 1; k < n_splits; ++k) m = fmaxf(m, part_m[(size_t)k * R + r]);
    float s = 0.f, ll = 0.f;
    for (int k = 0; k < n_splits; ++k) {
      const size_t o = (size_t)k * R + r;
      s += part_s[o] * expf(part_m[o] - m);
      ll += part_ll[o];
    }
    if (m_out != nullptr) {
      m_out[r] = m;
      s_out[r] = s;
      ll_out[r] = ll;
    }
    if (lse_out != nullptr) {
      const float lse = m + logf(s);
      lse_out[r] = lse;
      const int lab = labels[r];
      const float w = lab > 0 ? 1.f : 0.f;
      const float c = (ll >= m && lab >= 0) ? 1.f : 0.f;
      v[0] = (lse - ll) * w;
      v[1] = c * w;
      v[2] = c;
      v[3] = w;
    }
  }
  if (part_sums == nullptr) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) red[q][tid] = v[q];
  __syncthreads();
  for (int stride = 128; stride > 0; stride >>= 1) {
    if (tid < stride)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[q][tid] += red[q][tid + stride];
    __syncthreads();
  }
  if (tid < 4) part_sums[(size_t)blockIdx.x * 4 + tid] = red[tid][0];
}

// dh = T(sum_c part[c]) over the clusters in order (K6's dh reduction)
template <typename T>
__global__ void __launch_bounds__(256)
reduce_rows_cast_kernel(const float* __restrict__ part, T* __restrict__ out, int rows,
                        long n) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * n + i];
  out[i] = from_f<T>(s);
}

// The vocabulary splits of K3 and K5, by the operands' type: bf16 by
// loss_hopper.cuh's law, fp32 by loss_tf32.cuh's
int fwd_splits(int dtype, int R, int V, int W) {
  return dtype == 1 ? loss_hopper::fwd_splits(R, V, W) : loss_tf32::fwd_splits(R, V, W);
}

// K3 and K5: per-split row stats and per-block partial sums; no V x W term
struct TiledFwdScratch {
  float *part_m, *part_s, *part_ll, *part_sums;
  size_t bytes;
  TiledFwdScratch(void* base, int n_splits, int R) {
    Carve c{static_cast<char*>(base), 0};
    const size_t n = (size_t)n_splits * R;
    part_m = c.take<float>(n);
    part_s = c.take<float>(n);
    part_ll = c.take<float>(n);
    part_sums = c.take<float>((size_t)ceil_div(R, 256) * 4);
    bytes = c.used;
  }
};

// K6: one fp32 dh partial per cluster (loss_hopper.cuh's law, both
// dtypes); K7 needs none
struct TiledBwdScratch {
  float* part_dh;
  size_t bytes;
  TiledBwdScratch(void* base, int R, int V, int W, int merged) {
    Carve c{static_cast<char*>(base), 0};
    const int parts = loss_hopper::merged_clusters(V);
    part_dh = merged ? c.take<float>((size_t)parts * R * W) : nullptr;
    bytes = c.used;
  }
};

// the copies' layout rule of the wgmma kernels (loss_hopper.cuh's in bf16,
// which the wrapper checks first; loss_tf32.cuh's in fp32, which it meets
// by copying): 16-byte aligned operands and rows (W a multiple of
// 16 / sizeof(T)), W <= LOSS_MAXW
template <typename T>
bool wgmma_layout(const void* hidden, const void* table, const void* dh, int W) {
  return (reinterpret_cast<uintptr_t>(hidden) | reinterpret_cast<uintptr_t>(table) |
          reinterpret_cast<uintptr_t>(dh)) % 16 == 0 &&
         W % (16 / sizeof(T)) == 0 && W <= LOSS_MAXW;
}

// K3 and K5: the first pass writes each of the n_splits vocabulary splits'
// row stats (bf16 loss_hopper.cuh's loss_fwd_sweep_kernel, fp32
// loss_tf32.cuh's loss_tf32_fwd_sweep_kernel); loss_tiled_merge_kernel
// merges them in split order
int tiled_forward(int dtype, const void* hidden, const void* table, const float* bias,
                  const int32_t* labels, float* lse, float* sums, float* m, float* s,
                  float* ll, void* workspace, int R, int V, int W, cudaStream_t stream) {
  const int n_splits = fwd_splits(dtype, R, V, W);
  TiledFwdScratch w(workspace, n_splits, R);
  cudaError_t err;
  if (dtype == 1) {
    if (!wgmma_layout<__nv_bfloat16>(hidden, table, nullptr, W))
      return (int)cudaErrorInvalidValue;
    const loss_hopper::FwdArgs a{static_cast<const __nv_bfloat16*>(hidden),
                                 static_cast<const __nv_bfloat16*>(table),
                                 bias, labels, w.part_m, w.part_s, w.part_ll,
                                 R, V, W, n_splits};
    switch (loss_hopper::padded_width(W)) {
      case 64: err = loss_hopper::fwd_sweep<64>(a, stream); break;
      case 128: err = loss_hopper::fwd_sweep<128>(a, stream); break;
      default: err = loss_hopper::fwd_sweep<256>(a, stream); break;
    }
  } else {
    if (!wgmma_layout<float>(hidden, table, nullptr, W)) return (int)cudaErrorInvalidValue;
    const loss_tf32::FwdArgs a{static_cast<const float*>(hidden),
                               static_cast<const float*>(table),
                               bias, labels, w.part_m, w.part_s, w.part_ll,
                               R, V, W, n_splits};
    switch (loss_hopper::padded_width(W)) {
      case 64: err = loss_tf32::fwd_sweep<64>(a, stream); break;
      case 128: err = loss_tf32::fwd_sweep<128>(a, stream); break;
      default: err = loss_tf32::fwd_sweep<256>(a, stream); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int blocks = ceil_div(R, 256);
  loss_tiled_merge_kernel<<<blocks, 256, 0, stream>>>(
      w.part_m, w.part_s, w.part_ll, labels, R, n_splits, lse, m, s, ll,
      sums != nullptr ? w.part_sums : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return sums != nullptr ? (int)reduce_rows(w.part_sums, sums, blocks, 4, stream) : 0;
}

using loss_hopper::merged_sweep;
using loss_hopper::two_sweep;
using loss_tf32::merged_sweep;
using loss_tf32::two_sweep;

// K6 (merged) or K7 on the wgmma sweeps, by the operands' type: bf16 on
// loss_hopper.cuh's (bf16 K4 too: K7's two sweeps from K3's lse), fp32 on
// loss_tf32.cuh's 3xTF32 ones; K6's cluster partials reduced in cluster
// order
template <int WP, typename T, typename A>
int tiled_backward_w(int merged, const A& a, T* dh, float* dt, float* db, void* workspace,
                     cudaStream_t stream) {
  if (!merged) return (int)two_sweep<WP>(a, dh, dt, db, stream);
  TiledBwdScratch w(workspace, a.R, a.V, a.W, 1);
  cudaError_t err = merged_sweep<WP>(a, dt, db, w.part_dh, stream);
  if (err != cudaSuccess) return (int)err;
  const long n = (long)a.R * a.W;
  reduce_rows_cast_kernel<T><<<ceil_div(n, 256), 256, 0, stream>>>(
      w.part_dh, dh, loss_hopper::merged_clusters(a.V), n);
  return (int)cudaGetLastError();
}

template <typename T, typename A>
int tiled_backward(int merged, const A& a, void* dh, float* dt, float* db, void* workspace,
                   cudaStream_t stream) {
  if (!wgmma_layout<T>(a.hidden, a.table, dh, a.W)) return (int)cudaErrorInvalidValue;
  T* d = static_cast<T*>(dh);
  switch (loss_hopper::padded_width(a.W)) {
    case 64: return tiled_backward_w<64>(merged, a, d, dt, db, workspace, stream);
    case 128: return tiled_backward_w<128>(merged, a, d, dt, db, workspace, stream);
    default: return tiled_backward_w<256>(merged, a, d, dt, db, workspace, stream);
  }
}

}  // namespace

extern "C" {

// Limit the wrapper checks before calling (ops/fused_mlm_loss.py).
int b4r_mlm_loss_max_width() { return LOSS_MAXW; }

// Bytes of K3's workspace in dtype: its vocabulary splits' row stats (splits
// x R x 3, fwd_splits) and its row-block sums, no V x W. K4 needs none.
size_t b4r_mlm_loss_workspace_bytes(int dtype, int R, int V, int W) {
  return TiledFwdScratch(nullptr, fwd_splits(dtype, R, V, W), R).bytes;
}

// Bytes of K5's workspace in dtype: splits x R x 3 + the row-block sums, no
// V x W.
size_t b4r_mlm_loss_tiled_fwd_workspace_bytes(int dtype, int R, int V, int W) {
  return TiledFwdScratch(nullptr, fwd_splits(dtype, R, V, W), R).bytes;
}

// The grid of K4's (and K7's) two sweeps in dtype, as launched: out[0..3] =
// the dh sweep's blocks and cluster size, then the dt sweep's.
void b4r_mlm_loss_sweep_grid(int dtype, int R, int V, int W, int* out) {
  loss_hopper::sweep_clusters(R, V, dtype == 1 ? LT : loss_tf32::sweep_yn(W), out[1], out[3]);
  out[0] = ceil_div(R, LT) * out[1];
  out[2] = ceil_div(V, LT) * out[3];
}

// Bytes of K6's (merged = 1) or K7's (merged = 0) workspace, either dtype.
size_t b4r_mlm_loss_tiled_bwd_workspace_bytes(int R, int V, int W, int merged) {
  return TiledBwdScratch(nullptr, R, V, W, merged).bytes;
}

// K3. dtype: 0 = float32, 1 = bfloat16 for hidden and table (and dh).
// Writes lse [R] and sums [4] = (sum nll * w, sum correct * w, sum correct,
// sum w): a sweep over the whole table's vocabulary splits (fwd_splits;
// bf16 K5's sweep, fp32 loss_tf32.cuh's 3xTF32 one) and the ordered merge.
int b4r_mlm_loss_fwd(int dtype, const void* hidden, const void* table,
                     const float* bias, const int32_t* labels, float* lse, float* sums,
                     void* workspace, int R, int V, int W, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return tiled_forward(dtype, hidden, table, bias, labels, lse, sums, nullptr, nullptr,
                       nullptr, workspace, R, V, W, static_cast<cudaStream_t>(stream));
}

// K5. Writes lse [R] and sums [4] as b4r_mlm_loss_fwd, and the per-row
// stats m, s, ll [R] (max, sum of exp at it, label logit); any of the five
// may be null (the stats entry passes null lse and sums).
int b4r_mlm_loss_tiled_fwd(int dtype, const void* hidden, const void* table,
                           const float* bias, const int32_t* labels, float* lse, float* sums,
                           float* m, float* s, float* ll, void* workspace, int R, int V,
                           int W, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return tiled_forward(dtype, hidden, table, bias, labels, lse, sums, m, s, ll, workspace, R,
                       V, W, static_cast<cudaStream_t>(stream));
}

// K4: K7's two sweeps from K3's lse (bf16 loss_hopper.cuh's, fp32
// loss_tf32.cuh's). g: the loss's cotangent (one float on the device);
// n_valid: sums[3] of the forward. Writes dh [R, W] in dtype, dt [V, W] and
// db [V] in float32; no workspace.
int b4r_mlm_loss_bwd(int dtype, const void* hidden, const void* table,
                     const float* bias, const int32_t* labels, const float* lse,
                     const float* g, const float* n_valid, void* dh, float* dt,
                     float* db, void* workspace, int R, int V, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const loss_tf32::Args a{static_cast<const float*>(hidden), static_cast<const float*>(table),
                            bias, labels, lse, g, n_valid, 0, R, V, W};
    return tiled_backward<float>(0, a, dh, dt, db, workspace, st);
  }
  if (dtype == 1) {
    const loss_hopper::BwdArgs a{static_cast<const __nv_bfloat16*>(hidden),
                                 static_cast<const __nv_bfloat16*>(table),
                                 bias, labels, lse, g, n_valid, 0, R, V, W};
    return tiled_backward<__nv_bfloat16>(0, a, dh, dt, db, workspace, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K6 (merged = 1) or K7 (merged = 0), the backward of K5 from its lse;
// valid_ge_zero = 1 weighs rows with label >= 0. Outputs as b4r_mlm_loss_bwd.
int b4r_mlm_loss_tiled_bwd(int merged, int dtype, const void* hidden, const void* table,
                           const float* bias, const int32_t* labels, const float* lse,
                           const float* g, const float* n_valid, int valid_ge_zero,
                           void* dh, float* dt, float* db, void* workspace, int R, int V,
                           int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const loss_tf32::Args a{static_cast<const float*>(hidden), static_cast<const float*>(table),
                            bias, labels, lse, g, n_valid, valid_ge_zero, R, V, W};
    return tiled_backward<float>(merged, a, dh, dt, db, workspace, st);
  }
  if (dtype == 1) {
    const loss_hopper::BwdArgs a{static_cast<const __nv_bfloat16*>(hidden),
                                 static_cast<const __nv_bfloat16*>(table),
                                 bias, labels, lse, g, n_valid, valid_ge_zero, R, V, W};
    return tiled_backward<__nv_bfloat16>(merged, a, dh, dt, db, workspace, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
