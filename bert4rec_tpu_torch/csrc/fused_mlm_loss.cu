// Fused tied-softmax masked cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the whole-table TPU kernels of bert4rec_tpu/ops/fused_mlm_loss.py:
//   K3  _fwd_kernel (launched by _run_forward)
//   K4  _bwd_kernel (launched by _run_backward)
// over hidden [R, W] and the tied table [V, W] (both in T = float or bf16,
// the table already cast to the hidden dtype as the JAX kernel streams it),
// bias [V] fp32 with vocab-padding columns at -1e9, labels [R] int32
// (0 = padding row):
//
//   logits = hidden table^T + bias                         (fp32, never stored)
//   lse    = max + log(sum exp(logits - max))              per row, kept
//   nll    = (lse - logits[label]) * (label > 0)
//   correct = logits[label] >= max   (ties count, as the TPU kernel's rule)
//   sums   = (sum nll, sum correct * w, sum correct, sum w)
//   dlog   = (exp(logits - lse) - onehot) * w * g / max(n_valid, 1)
//   dh     = T(T(dlog) table),  dtable = T(dlog)^T hidden,  dbias = sum dlog
//
// Design. The point of the TPU kernel is never to materialise the [R, V]
// fp32 logits (152 MB at R = 10,240, V = 3,709). The TPU held the whole
// table in VMEM; an H100 block has 227 KB, so every kernel streams the table
// in 64-row vocabulary tiles and recomputes the logits tile it needs:
//   loss_fwd_kernel    one block per 64-row tile, online max / sum over the
//                      vocabulary tiles; emits lse and per-block partials
//                      of the four sums (reduced in a second, ordered pass)
//   loss_bwd_dh_kernel one block per 64-row tile; dh accumulated over the
//                      vocabulary tiles
//   loss_bwd_dt_kernel one block per (vocabulary tile, chunk of rows);
//                      split partials of dtable and dbias, reduced in order
// The backward reads the forward's lse instead of recomputing max and sum
// (the JAX single-tile backward recomputes them; the difference is fp32
// rounding, within the tolerance the tests state). No float atomics: two
// runs give the same bits.
//
// Bound. 2 R V W = 9.7 GFLOP forward and about 3x that backward against
// ~3.5 MB of inputs: bound by operations. With bf16 operands every product
// (the logits tile, dlog . table, dlog^T . hidden) runs on the tensor cores
// with mma.sync (fp32 sums; the operands are bf16-exact, so only the order
// of the sums differs from the fp32 loops, which fp32 operands keep). No
// copy pipelining or wgmma yet: later work.

#include "common.cuh"

namespace {

using namespace b4r;

constexpr int LT = 64;  // rows per row tile and per vocabulary tile
constexpr int LOSS_MAXW = 256;
constexpr int DT_CHUNK = 1024;  // rows per dtable split

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int row0, int n_rows, int W) {
  for (int l = threadIdx.x; l < LT * W; l += 256) {
    const int r = l / W, d = l % W;
    dst[r * (W + 1) + d] = (row0 + r < n_rows) ? to_f(src[(size_t)(row0 + r) * W + d]) : 0.f;
  }
}

// the vocabulary tile's bias: -inf marks a column past the vocabulary
__device__ __forceinline__ void load_bias(float* bs, const float* __restrict__ bias,
                                          int v0, int V) {
  for (int c = threadIdx.x; c < LT; c += 256) bs[c] = (v0 + c < V) ? bias[v0 + c] : -INFINITY;
}

template <typename T>
__global__ void __launch_bounds__(256)
loss_fwd_kernel(const T* __restrict__ hidden, const T* __restrict__ table,
                const float* __restrict__ bias, const int32_t* __restrict__ labels,
                float* __restrict__ lse_out, float* __restrict__ part, int R, int V,
                int W) {
  extern __shared__ float smem[];
  float* Hs = smem;                    // [64][W + 1]
  float* Ts = Hs + LT * (W + 1);       // [64][W + 1]
  float* bs = Ts + LT * (W + 1);       // [64]
  float* ll = bs + LT;                 // [64] label logits
  float* rowv = ll + LT;               // [4][64] per-row nll*w, c*w, c, w
  float* scr = rowv + 4 * LT;          // [64][65] tensor-core scratch
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * LT;
  constexpr bool kMma = kIsBf16<T>;

  load_rows(Hs, hidden, r0, R, W);
  for (int r = tid; r < LT; r += 256) ll[r] = 0.f;
  int lab[4];
  float m[4], l[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    lab[i] = r < R ? labels[r] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int v0 = 0; v0 < V; v0 += LT) {
    load_rows(Ts, table, v0, V, W);
    load_bias(bs, bias, v0, V);
    __syncthreads();
    tile_dots<kMma>(s, Hs, Ts, tx, ty, W, scr);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += bs[tx + 16 * j];
        if (v0 + tx + 16 * j == lab[i]) ll[ty + 16 * i] = s[i][j];
      }
      const float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) tsum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(tsum);
      m[i] = m_new;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i, r = r0 + rr;
    if (tx != 0) continue;
    float nllw = 0.f, cw = 0.f, c = 0.f, w = 0.f;
    if (r < R) {
      const float lse = m[i] + logf(l[i]);
      lse_out[r] = lse;
      w = lab[i] > 0 ? 1.f : 0.f;
      c = ll[rr] >= m[i] ? 1.f : 0.f;
      nllw = (lse - ll[rr]) * w;
      cw = c * w;
    }
    rowv[rr] = nllw;
    rowv[LT + rr] = cw;
    rowv[2 * LT + rr] = c;
    rowv[3 * LT + rr] = w;
  }
  __syncthreads();
  if (tid < 4) {
    float acc = 0.f;
    for (int rr = 0; rr < LT; ++rr) acc += rowv[tid * LT + rr];
    part[(size_t)blockIdx.x * 4 + tid] = acc;
  }
}

// dlog of this thread's 4 x 4 (row, vocab) pairs; s holds the logits
__device__ __forceinline__ float dlog_of(float s, float lse, int col, int lab, float wr) {
  const float p = expf(s - lse);
  return (p - (col == lab ? 1.f : 0.f)) * wr;
}

template <typename T, int WJ>
__global__ void __launch_bounds__(256)
loss_bwd_dh_kernel(const T* __restrict__ hidden, const T* __restrict__ table,
                   const float* __restrict__ bias, const int32_t* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   const float* __restrict__ n_valid, T* __restrict__ dh, int R, int V,
                   int W) {
  extern __shared__ float smem[];
  float* Hs = smem;                    // [64][W + 1]
  float* Ts = Hs + LT * (W + 1);       // [64][W + 1]
  float* Ds = Ts + LT * (W + 1);       // [64][65] T(dlog)
  float* bs = Ds + LT * (LT + 1);      // [64]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * LT;
  const float scale = g[0] / fmaxf(n_valid[0], 1.f);
  constexpr bool kMma = kIsBf16<T>;

  load_rows(Hs, hidden, r0, R, W);
  int lab[4];
  float lr[4], wr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    lab[i] = r < R ? labels[r] : -1;
    lr[i] = r < R ? lse[r] : 0.f;
    wr[i] = lab[i] > 0 ? scale : 0.f;
  }
  float acc[4][WJ], cacc[WJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < WJ; ++j) acc[i][j] = cacc[j][i] = 0.f;
  float s[4][4];
  for (int v0 = 0; v0 < V; v0 += LT) {
    load_rows(Ts, table, v0, V, W);
    load_bias(bs, bias, v0, V);
    __syncthreads();
    tile_dots<kMma>(s, Hs, Ts, tx, ty, W, Ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ds[(ty + 16 * i) * (LT + 1) + c] =
            round_to<T>(dlog_of(s[i][j] + bs[c], lr[i], v0 + c, lab[i], wr[i]));
      }
    __syncthreads();
    if constexpr (kMma) {
      // columns past the vocabulary: dlog = 0 and zero table rows
      mma_acc_64xD<WJ>(cacc, Ds, LT + 1, 1, Ts, W + 1, 1, W);
    } else {
      const int vlen = min(LT, V - v0);
      for (int c = 0; c < vlen; ++c) {
        float dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = Ds[(ty + 16 * i) * (LT + 1) + c];
#pragma unroll
        for (int j = 0; j < WJ; ++j) {
          const int d = tx + 16 * j;
          if (d < W) {
            const float t = Ts[c * (W + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dv[i], t, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  if constexpr (kMma) {  // fragments -> the (ty, tx) layout, through Hs
    spill_64xD<WJ>(Hs, W + 1, cacc, W);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < WJ; ++j) {
        const int d = tx + 16 * j;
        if (d < W) acc[i][j] = Hs[(ty + 16 * i) * (W + 1) + d];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < WJ; ++j) {
      const int d = tx + 16 * j;
      if (d < W) dh[(size_t)r * W + d] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int WJ>
__global__ void __launch_bounds__(256)
loss_bwd_dt_kernel(const T* __restrict__ hidden, const T* __restrict__ table,
                   const float* __restrict__ bias, const int32_t* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   const float* __restrict__ n_valid, float* __restrict__ part_dt,
                   float* __restrict__ part_db, int R, int V, int W) {
  extern __shared__ float smem[];
  float* Ts = smem;                    // [64 vocab][W + 1], this block's tile
  float* Hs = Ts + LT * (W + 1);       // [64 rows][W + 1]
  float* Ds = Hs + LT * (W + 1);       // [64 rows][65] T(dlog)
  float* Df = Ds + LT * (LT + 1);      // [64 rows][65] fp32 dlog
  float* bs = Df + LT * (LT + 1);      // [64]
  float* rl = bs + LT;                 // [64] row lse
  float* rw = rl + LT;                 // [64] row weight
  int* rlab = reinterpret_cast<int*>(rw + LT);  // [64] row label
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int v0 = blockIdx.x * LT, split = blockIdx.y;
  const int m_begin = split * DT_CHUNK, m_end = min(R, m_begin + DT_CHUNK);
  const float scale = g[0] / fmaxf(n_valid[0], 1.f);
  constexpr bool kMma = kIsBf16<T>;

  load_rows(Ts, table, v0, V, W);
  load_bias(bs, bias, v0, V);
  float acc[4][WJ], cacc[WJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < WJ; ++j) acc[i][j] = cacc[j][i] = 0.f;
  float db = 0.f;  // thread tid < 64 owns vocabulary column v0 + tid
  float s[4][4];
  for (int r0 = m_begin; r0 < m_end; r0 += LT) {
    load_rows(Hs, hidden, r0, m_end, W);
    for (int r = tid; r < LT; r += 256) {
      const bool ok = r0 + r < m_end;
      rlab[r] = ok ? labels[r0 + r] : -1;
      rl[r] = ok ? lse[r0 + r] : 0.f;
      rw[r] = (ok && rlab[r] > 0) ? scale : 0.f;
    }
    __syncthreads();
    tile_dots<kMma>(s, Hs, Ts, tx, ty, W, Df);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float dl = dlog_of(s[i][j] + bs[c], rl[rr], v0 + c, rlab[rr], rw[rr]);
        Df[rr * (LT + 1) + c] = dl;
        Ds[rr * (LT + 1) + c] = round_to<T>(dl);
      }
    }
    __syncthreads();
    const int rlen = min(LT, m_end - r0);
    if (tid < LT)
      for (int rr = 0; rr < rlen; ++rr) db += Df[rr * (LT + 1) + tid];
    if constexpr (kMma) {
      // rows are vocabulary entries, the contraction runs over the row
      // tile (rows past the chunk have dlog = 0 and zero hidden rows)
      mma_acc_64xD<WJ>(cacc, Ds, 1, LT + 1, Hs, W + 1, 1, W);
    } else {
      for (int rr = 0; rr < rlen; ++rr) {
        float dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = Ds[rr * (LT + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < WJ; ++j) {
          const int d = tx + 16 * j;
          if (d < W) {
            const float h = Hs[rr * (W + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dv[i], h, acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  if constexpr (kMma) {  // fragments -> the (ty, tx) layout, through Ts
    spill_64xD<WJ>(Ts, W + 1, cacc, W);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < WJ; ++j) {
        const int d = tx + 16 * j;
        if (d < W) acc[i][j] = Ts[(ty + 16 * i) * (W + 1) + d];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty + 16 * i;
    if (v >= V) continue;
#pragma unroll
    for (int j = 0; j < WJ; ++j) {
      const int d = tx + 16 * j;
      if (d < W) part_dt[((size_t)split * V + v) * W + d] = acc[i][j];
    }
  }
  if (tid < LT && v0 + tid < V) part_db[(size_t)split * V + v0 + tid] = db;
}

size_t fwd_smem_bytes(int W) {
  return sizeof(float) * (size_t)(2 * LT * (W + 1) + 6 * LT + LT * (LT + 1));
}
size_t dh_smem_bytes(int W) {
  return sizeof(float) * (size_t)(2 * LT * (W + 1) + LT * (LT + 1) + LT);
}
size_t dt_smem_bytes(int W) {
  return sizeof(float) * (size_t)(2 * LT * (W + 1) + 2 * LT * (LT + 1) + 4 * LT);
}

int dt_splits(int R) { return ceil_div(R, DT_CHUNK); }

struct LossScratch {
  float *part_fwd, *part_dt, *part_db;
  size_t bytes;
  LossScratch(void* base, int R, int V, int W) {
    Carve c{static_cast<char*>(base), 0};
    part_fwd = c.take<float>((size_t)ceil_div(R, LT) * 4);
    part_dt = c.take<float>((size_t)dt_splits(R) * V * W);
    part_db = c.take<float>((size_t)dt_splits(R) * V);
    bytes = c.used;
  }
};

template <typename T>
int loss_forward(const void* hidden, const void* table, const float* bias,
                 const int32_t* labels, float* lse, float* sums, void* workspace,
                 int R, int V, int W, cudaStream_t stream) {
  LossScratch w(workspace, R, V, W);
  const size_t smem = fwd_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      loss_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  loss_fwd_kernel<T><<<ceil_div(R, LT), 256, smem, stream>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(table), bias, labels, lse,
      w.part_fwd, R, V, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)reduce_rows(w.part_fwd, sums, ceil_div(R, LT), 4, stream);
}

template <typename T, int WJ>
int loss_backward_w(const T* hidden, const T* table, const float* bias,
                    const int32_t* labels, const float* lse, const float* g,
                    const float* n_valid, T* dh, float* dt, float* db, void* workspace,
                    int R, int V, int W, cudaStream_t stream) {
  LossScratch w(workspace, R, V, W);
  size_t smem = dh_smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(loss_bwd_dh_kernel<T, WJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  loss_bwd_dh_kernel<T, WJ><<<ceil_div(R, LT), 256, smem, stream>>>(
      hidden, table, bias, labels, lse, g, n_valid, dh, R, V, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  smem = dt_smem_bytes(W);
  err = cudaFuncSetAttribute(loss_bwd_dt_kernel<T, WJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int splits = dt_splits(R);
  loss_bwd_dt_kernel<T, WJ><<<dim3(ceil_div(V, LT), splits), 256, smem, stream>>>(
      hidden, table, bias, labels, lse, g, n_valid, w.part_dt, w.part_db, R, V, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = reduce_rows(w.part_dt, dt, splits, V * W, stream)) != cudaSuccess)
    return (int)err;
  return (int)reduce_rows(w.part_db, db, splits, V, stream);
}

template <typename T>
int loss_backward(const void* hidden, const void* table, const float* bias,
                  const int32_t* labels, const float* lse, const float* g,
                  const float* n_valid, void* dh, float* dt, float* db, void* workspace,
                  int R, int V, int W, cudaStream_t stream) {
  const T* h = static_cast<const T*>(hidden);
  const T* t = static_cast<const T*>(table);
  T* d = static_cast<T*>(dh);
#define B4R_LB(WJV) \
  loss_backward_w<T, WJV>(h, t, bias, labels, lse, g, n_valid, d, dt, db, workspace, R, V, W, stream)
  switch (pow2_at_least(ceil_div(W, 16))) {
    case 1: return B4R_LB(1);
    case 2: return B4R_LB(2);
    case 4: return B4R_LB(4);
    case 8: return B4R_LB(8);
    case 16: return B4R_LB(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B4R_LB
}

}  // namespace

extern "C" {

// Limit the wrapper checks before calling (ops/fused_mlm_loss.py).
int b4r_mlm_loss_max_width() { return LOSS_MAXW; }

// Bytes of the workspace both entry points carve their partials from.
size_t b4r_mlm_loss_workspace_bytes(int R, int V, int W) {
  return LossScratch(nullptr, R, V, W).bytes;
}

// dtype: 0 = float32, 1 = bfloat16 for hidden and table (and dh). Writes
// lse [R] and sums [4] = (sum nll * w, sum correct * w, sum correct, sum w).
int b4r_mlm_loss_fwd(int dtype, const void* hidden, const void* table,
                     const float* bias, const int32_t* labels, float* lse, float* sums,
                     void* workspace, int R, int V, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return loss_forward<float>(hidden, table, bias, labels, lse, sums, workspace, R, V, W, st);
  if (dtype == 1)
    return loss_forward<__nv_bfloat16>(hidden, table, bias, labels, lse, sums, workspace,
                                       R, V, W, st);
  return (int)cudaErrorInvalidValue;
}

// g: the loss's cotangent (one float on the device); n_valid: sums[3] of
// the forward. Writes dh [R, W] in dtype, dt [V, W] and db [V] in float32.
int b4r_mlm_loss_bwd(int dtype, const void* hidden, const void* table,
                     const float* bias, const int32_t* labels, const float* lse,
                     const float* g, const float* n_valid, void* dh, float* dt,
                     float* db, void* workspace, int R, int V, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return loss_backward<float>(hidden, table, bias, labels, lse, g, n_valid, dh, dt, db,
                                workspace, R, V, W, st);
  if (dtype == 1)
    return loss_backward<__nv_bfloat16>(hidden, table, bias, labels, lse, g, n_valid, dh,
                                        dt, db, workspace, R, V, W, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
