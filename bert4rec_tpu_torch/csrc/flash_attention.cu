// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of bert4rec_tpu/ops/flash_attention.py:
//   K8  _fwd_kernel (launched by _forward): masked multi-head attention over
//       [B, N, S, D], fp32 softmax(q k^T / sqrt(D) + pad bias [+ causal
//       bias]), attention-probability dropout, p v;
//   K9  _bwd_kernel (launched by _backward, through the custom backward
//       _flash_bwd): dq, dk, dv with the same dropout mask.
// The function, rounding points included, is attention.cuh's (the TPU
// kernel's _probs: p normalised in fp32, times keep, rounded to v's type
// before p v; the backward's ds = T(p (dp - rowsum(dp p))) with JAX's row
// sum, dq = ds k scale, dk = ds^T q scale, dv = T(p keep)^T dO). The dropout
// mask is the counter hash of common.cuh at site `head`, counter
// `row * S + col` (the port's stream; the TPU's pltpu bits cannot be
// reproduced), so K8, K9 and the plain versions draw the same mask.
//
// Design. The TPU kernel holds whole [S, S] fp32 score matrices of a head
// group in VMEM (_heads_per_cell sizes a cell for ~12 of them in 14 MB);
// at S = 512 one such matrix alone is 1 MB, and an H100 block has at most
// 227 KB of shared memory. So the kernels stream 64-key tiles through
// shared memory: K8 is attention.cuh's attention_kernel (two passes over
// the key tiles per 64-query tile, writing each row's max and sum), K9 its
// attn_bwd_dq_kernel and attn_bwd_dkv_kernel, which read those statistics
// instead of recomputing them (0.8 MB a layer at the main path's shape; a
// memory choice, not a change of function). Operands are strided views:
// the wrapper hands q, k and v as the [B, S, N, D] projection's transposes
// without a copy, and o, dq, dk, dv come back in the layout it chooses.
//
// Bound. At the main path's shape (B N = 384 heads, S = 512, D = 64,
// bf16) K8 needs 4 B N S^2 D = 25.8 GFLOP (26 us at 989 TFLOP/s) against
// 100.7 MB of q, k, v in and o out (30 us at 3.35 TB/s): bound by bytes.
// K9 needs 8 B N S^2 D = 51.5 GFLOP (52 us) against 176 MB (53 us). The
// recomputation of the scores (K9 forms them twice, K8 twice) is not
// counted. The tiles stage through shared memory as fp32 with mma.sync
// products and no copy pipelining, TMA or wgmma: right first, fast later.
//
// Interface: C entry points taking an array of device pointers and an
// array of element strides, launching on the caller's stream; each returns
// the first non-zero cudaGetLastError() code.

#include "attention.cuh"
#include "common.cuh"

namespace {

using namespace b4r;

template <typename P>
Heads<P> view(void* p, const long long* st) {
  return {static_cast<P*>(p), st[0], st[1], (int)st[2]};
}

// forward pointer order (ops/flash_attention.py _FWD_PTRS)
enum FwdPtr { F_Q, F_K, F_V, F_MASK, F_O, F_STAT_M, F_STAT_L, F_COUNT };
// backward pointer order (ops/flash_attention.py _BWD_PTRS)
enum BwdPtr {
  B_Q, B_K, B_V, B_DO, B_MASK, B_STAT_M, B_STAT_L, B_DELTA, B_DQ, B_DK, B_DV, B_COUNT
};

template <typename T>
int flash_forward(void* const* p, const long long* st, int B, int N, int S, int D,
                  int causal, float scale, Drop drop, cudaStream_t stream) {
  return (int)attention<T>(view<const T>(p[F_Q], st), view<const T>(p[F_K], st + 3),
                           view<const T>(p[F_V], st + 6),
                           static_cast<const int32_t*>(p[F_MASK]),
                           view<T>(p[F_O], st + 9), static_cast<float*>(p[F_STAT_M]),
                           static_cast<float*>(p[F_STAT_L]), drop, B, S, N, D, scale,
                           causal, stream);
}

template <typename T>
int flash_backward(void* const* p, const long long* st, int B, int N, int S, int D,
                   int causal, float scale, Drop drop, cudaStream_t stream) {
  return (int)attn_bwd<T>(
      view<const T>(p[B_Q], st), view<const T>(p[B_K], st + 3),
      view<const T>(p[B_V], st + 6), view<const T>(p[B_DO], st + 9),
      static_cast<const int32_t*>(p[B_MASK]), static_cast<const float*>(p[B_STAT_M]),
      static_cast<const float*>(p[B_STAT_L]), drop, static_cast<float*>(p[B_DELTA]),
      view<T>(p[B_DQ], st + 12), view<T>(p[B_DK], st + 15), view<T>(p[B_DV], st + 18),
      nullptr, B, S, N, D, scale, causal, stream);
}

}  // namespace

extern "C" {

// The largest head dim the kernels take (the wrapper checks it).
int b4r_flash_max_head_dim() { return AT_MAXD; }

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o. ptrs: _FWD_PTRS
// order; stat_m / stat_l ([B, N, S] fp32, the row max and sum K9 reads) may
// be null. strides: (batch, head, sequence) element strides of q, k, v, o.
// causal != 0 adds the TPU kernel's causal bias. A rate of 0 is on == 0.
int b4r_flash_fwd(int dtype, void* const* ptrs, const long long* strides, int B, int N,
                  int S, int D, int causal, float scale, unsigned seed,
                  unsigned threshold, float keep_scale, int on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop{seed, threshold, keep_scale, on};
  if (dtype == 0)
    return flash_forward<float>(ptrs, strides, B, N, S, D, causal, scale, drop, st);
  if (dtype == 1)
    return flash_forward<__nv_bfloat16>(ptrs, strides, B, N, S, D, causal, scale, drop,
                                        st);
  return (int)cudaErrorInvalidValue;
}

// ptrs: _BWD_PTRS order; delta is [B, N, S] fp32 scratch; strides: q, k, v,
// dO, dq, dk, dv. causal and the dropout must be the forward's (its saved
// row statistics are of those scores).
int b4r_flash_bwd(int dtype, void* const* ptrs, const long long* strides, int B, int N,
                  int S, int D, int causal, float scale, unsigned seed,
                  unsigned threshold, float keep_scale, int on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop{seed, threshold, keep_scale, on};
  if (dtype == 0)
    return flash_backward<float>(ptrs, strides, B, N, S, D, causal, scale, drop, st);
  if (dtype == 1)
    return flash_backward<__nv_bfloat16>(ptrs, strides, B, N, S, D, causal, scale, drop,
                                         st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
