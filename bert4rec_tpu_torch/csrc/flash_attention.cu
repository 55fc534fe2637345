// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of bert4rec_tpu/ops/flash_attention.py:
//   K8  _fwd_kernel (launched by _forward): masked multi-head attention over
//       [B, N, S, D], fp32 softmax(q k^T / sqrt(D) + pad bias [+ causal
//       bias]), attention-probability dropout, p v;
//   K9  _bwd_kernel (launched by _backward, through the custom backward
//       _flash_bwd): dq, dk, dv with the same dropout mask.
// The function, rounding points included, is the TPU kernel's _probs: p
// normalised in fp32 as exp(s - m) * (1 / sum), times keep, rounded to v's
// type before p v (fp32 sums); the backward's ds = T(p (dp - rowsum(dp p)))
// with JAX's row sum (not flash attention's dO . o: equal in exact
// arithmetic, not in rounding), dq = ds k scale, dk = ds^T q scale,
// dv = T(p keep)^T dO. The dropout mask is the counter hash of common.cuh at
// site `head`, counter `row * S + col` (the port's stream; the TPU's pltpu
// bits cannot be reproduced), so K8, K9 and the plain versions draw the
// same mask.
//
// Bound. At the main path's shape (B N = 384 heads, S = 512, D = 64, bf16)
// K8 needs 4 B N S^2 D = 25.8 GFLOP (26 us at 989 TFLOP/s) against 100.7 MB
// of q, k, v in and o out (30 us at 3.35 TB/s): bound by bytes. K9 needs
// 8 B N S^2 D = 51.5 GFLOP (52 us) against 176 MB (53 us). In fp32 the same
// work is bound by operations: 0.156 / 0.312 ms at 3xTF32's 165 TFLOP/s.
// The TPU kernel holds whole [S, S] fp32 score matrices of a head group in
// VMEM; an H100 block has at most 227 KB of shared memory, so the kernels
// stream 64-row tiles and recompute the scores instead (not counted in the
// bound), and the backward reads the forward's row max and sum (0.8 MB a
// layer at the main path's shape).
//
// Design, by operand type (an explicit dispatch on `dtype`, nothing caught):
//   bf16  flash_hopper.cuh: one warpgroup per 64-row tile, tiles copied as
//         bf16 by cp.async into the 128-byte swizzle with a two-stage ring,
//         every product on wgmma with the scores in registers; the rounded
//         probabilities (and ds) feed the next product as its register A
//         operand. K8 two passes per query tile (row statistics, then
//         normalised probabilities: no online rescale of unnormalised bf16
//         probabilities, which would round elsewhere); K9 a dq kernel per
//         query tile (pass A JAX's delta, pass B dq) and a dkv kernel per
//         key tile (S^T = K Q^T, so dv and dk take T(p keep)^T and T(ds)^T
//         from registers). Layout rule: q, k, v and dO have a 16-byte
//         aligned base and batch, head and sequence strides (the wrapper
//         raises on anything else; the main path's views of one
//         [B, S, 3, N, D] projection meet it); D <= 128, and latent
//         attention's queries and keys of D = 192 against values of
//         Dv = 128 (the kernels at DP = 192, DV = 128: wide tiles for q, k,
//         dq, dk, 128-wide ones for v, o, dO, dv; dq and dk accumulate 192
//         columns, n192 products).
//   fp32  with D a multiple of 8 up to 64 (ops/flash_attention.py
//         flash_route "tf32", every shipped config): flash_tf32.cuh's 3xTF32
//         wgmma kernels (K8 one online pass, 128 queries a block; K9 a dq
//         kernel reading delta = dO . o, and a dk / dv kernel), under the
//         same 16-byte rule for q, k, v, o and dO (the wrapper copies a view
//         that breaks it). Any other fp32 head dim ("simt"): attention.cuh's
//         SIMT tiles (attention_kernel, attn_bwd_dq_kernel,
//         attn_bwd_dkv_kernel), which the fused layer's off-rule route
//         also runs. A forward and its backward take one route, from D
//         alone, so the saved row statistics are the backward's own.
// Deterministic: no float atomics, two runs give the same bits.
//
// Interface: C entry points taking an array of device pointers and an
// array of element strides, launching on the caller's stream; each returns
// the first non-zero cudaGetLastError() code (cudaErrorInvalidValue for a
// bf16 or 3xTF32 operand outside the layout rule or a head dim past 128).

#include "attention.cuh"
#include "common.cuh"
#include "flash_hopper.cuh"
#include "flash_tf32.cuh"

namespace {

using namespace b4r;

template <typename P>
Heads<P> view(void* p, const long long* st) {
  return {static_cast<P*>(p), st[0], st[1], (int)st[2]};
}

// whether a view of es-byte elements meets the copies' 16-byte rule
bool aligned16(const void* p, const long long* st, int es = 2) {
  const uintptr_t bytes = reinterpret_cast<uintptr_t>(p) | (uintptr_t)(st[0] * es) |
                          (uintptr_t)(st[1] * es) | (uintptr_t)(st[2] * es);
  return (bytes & 15) == 0;
}

// forward pointer order (ops/flash_attention.py _FWD_PTRS)
enum FwdPtr { F_Q, F_K, F_V, F_MASK, F_O, F_STAT_M, F_STAT_L, F_BITS, F_COUNT };
// backward pointer order (ops/flash_attention.py _BWD_PTRS)
enum BwdPtr {
  B_Q, B_K, B_V, B_DO, B_O, B_MASK, B_STAT_M, B_STAT_L, B_DELTA, B_DQ, B_DK, B_DV, B_BITS,
  B_COUNT
};
// backward stride order (ops/flash_attention.py _BWD_VIEWS): q, k, v, dO, o,
// dq, dk, dv
enum BwdView { V_Q = 0, V_K = 3, V_V = 6, V_DO = 9, V_O = 12, V_DQ = 15, V_DK = 18, V_DV = 21 };

int forward_fp32(void* const* p, const long long* st, int B, int N, int S, int D,
                 int causal, float scale, Drop drop, cudaStream_t stream) {
  if (flash_tf32::takes(D)) {
    for (int i = 0; i < 4; ++i)
      if (!aligned16(p[i == 3 ? F_O : i], st + 3 * i, 4)) return (int)cudaErrorInvalidValue;
    const flash_tf32::FwdArgs a{view<const float>(p[F_Q], st),
                                view<const float>(p[F_K], st + 3),
                                view<const float>(p[F_V], st + 6),
                                static_cast<const int32_t*>(p[F_MASK]),
                                view<float>(p[F_O], st + 9),
                                static_cast<float*>(p[F_STAT_M]),
                                static_cast<float*>(p[F_STAT_L]),
                                drop, S, N, D, causal, scale};
    return (int)flash_tf32::forward(a, B, stream);
  }
  return (int)attention<float>(
      view<const float>(p[F_Q], st), view<const float>(p[F_K], st + 3),
      view<const float>(p[F_V], st + 6), static_cast<const int32_t*>(p[F_MASK]),
      view<float>(p[F_O], st + 9), static_cast<float*>(p[F_STAT_M]),
      static_cast<float*>(p[F_STAT_L]), drop, B, S, N, D, scale, causal, stream);
}

int backward_fp32(void* const* p, const long long* st, int B, int N, int S, int D,
                  int causal, float scale, Drop drop, cudaStream_t stream) {
  if (flash_tf32::takes(D)) {
    const int ptr[5] = {B_Q, B_K, B_V, B_DO, B_O};
    for (int i = 0; i < 5; ++i)
      if (!p[ptr[i]] || !aligned16(p[ptr[i]], st + 3 * i, 4)) return (int)cudaErrorInvalidValue;
    const flash_tf32::BwdArgs a{view<const float>(p[B_Q], st + V_Q),
                                view<const float>(p[B_K], st + V_K),
                                view<const float>(p[B_V], st + V_V),
                                view<const float>(p[B_O], st + V_O),
                                view<const float>(p[B_DO], st + V_DO),
                                static_cast<const int32_t*>(p[B_MASK]),
                                static_cast<const float*>(p[B_STAT_M]),
                                static_cast<const float*>(p[B_STAT_L]),
                                static_cast<float*>(p[B_DELTA]),
                                view<float>(p[B_DQ], st + V_DQ),
                                view<float>(p[B_DK], st + V_DK),
                                view<float>(p[B_DV], st + V_DV),
                                drop, S, N, D, causal, scale};
    return (int)flash_tf32::backward(a, B, stream);
  }
  return (int)attn_bwd<float>(
      view<const float>(p[B_Q], st + V_Q), view<const float>(p[B_K], st + V_K),
      view<const float>(p[B_V], st + V_V), view<const float>(p[B_DO], st + V_DO),
      static_cast<const int32_t*>(p[B_MASK]), static_cast<const float*>(p[B_STAT_M]),
      static_cast<const float*>(p[B_STAT_L]), drop, static_cast<float*>(p[B_DELTA]),
      view<float>(p[B_DQ], st + V_DQ), view<float>(p[B_DK], st + V_DK),
      view<float>(p[B_DV], st + V_DV), nullptr, B, S, N, D, scale, causal, stream);
}

using hopper::bf16;

template <int V> using Width = std::integral_constant<int, V>;

int forward_bf16(void* const* p, const long long* st, int B, int N, int S, int D, int Dv,
                 int causal, float scale, Drop drop, cudaStream_t stream) {
  for (int i = 0; i < 3; ++i)
    if (!aligned16(p[i], st + 3 * i)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto dp, auto dv) {
    return (int)hopper::forward<decltype(dp)::value, decltype(dv)::value>(
        view<const bf16>(p[F_Q], st), view<const bf16>(p[F_K], st + 3),
        view<const bf16>(p[F_V], st + 6), static_cast<const int32_t*>(p[F_MASK]),
        view<bf16>(p[F_O], st + 9), static_cast<float*>(p[F_STAT_M]),
        static_cast<float*>(p[F_STAT_L]), static_cast<uint32_t*>(p[F_BITS]), drop, B,
        S, N, D, scale, causal, stream);
  };
  if (Dv != D) return D == 192 && Dv == 128 ? run(Width<192>{}, Width<128>{})
                                            : (int)cudaErrorInvalidValue;
  if (D <= 64) return run(Width<64>{}, Width<64>{});
  if (D <= 128) return run(Width<128>{}, Width<128>{});
  return (int)cudaErrorInvalidValue;
}

int backward_bf16(void* const* p, const long long* st, int B, int N, int S, int D, int Dv,
                  int causal, float scale, Drop drop, cudaStream_t stream) {
  for (int i = 0; i < 4; ++i)
    if (!aligned16(p[i], st + 3 * i)) return (int)cudaErrorInvalidValue;
  if (drop.on && !p[B_BITS]) return (int)cudaErrorInvalidValue;
  auto run = [&](auto dp, auto dv) {
    return (int)hopper::backward<decltype(dp)::value, decltype(dv)::value>(
        view<const bf16>(p[B_Q], st), view<const bf16>(p[B_K], st + 3),
        view<const bf16>(p[B_V], st + 6), view<const bf16>(p[B_DO], st + 9),
        static_cast<const int32_t*>(p[B_MASK]), static_cast<const float*>(p[B_STAT_M]),
        static_cast<const float*>(p[B_STAT_L]), static_cast<const uint32_t*>(p[B_BITS]),
        drop, static_cast<float*>(p[B_DELTA]), view<bf16>(p[B_DQ], st + V_DQ),
        view<bf16>(p[B_DK], st + V_DK), view<bf16>(p[B_DV], st + V_DV), B, S, N, D, scale,
        causal, stream);
  };
  if (Dv != D) return D == 192 && Dv == 128 ? run(Width<192>{}, Width<128>{})
                                            : (int)cudaErrorInvalidValue;
  if (D <= 64) return run(Width<64>{}, Width<64>{});
  if (D <= 128) return run(Width<128>{}, Width<128>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The largest head dim the kernels take (the wrapper checks it).
int b4r_flash_max_head_dim() { return AT_MAXD; }

// The largest fp32 head dim of the 3xTF32 kernels (multiples of 8 up to it;
// ops/flash_attention.py flash_route mirrors the law and checks this).
int b4r_flash_tf32_max_head_dim() { return flash_tf32::kMaxHeadDim; }

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o. ptrs: _FWD_PTRS
// order; stat_m / stat_l ([B, N, S] fp32, the row max and sum K9 reads) may
// be null, and so may keep_bits (bf16 only: [B, N, T, T, 128] 32-bit words,
// T = ceil(S / 64), the dropout keep bits K9 reads; unused for fp32).
// strides: (batch, head, sequence) element strides of q, k, v, o. D is the
// head dim of q and k, Dv that of v and o (bf16 only where they differ).
// causal != 0 adds the TPU kernel's causal bias. A rate of 0 is on == 0.
int b4r_flash_fwd(int dtype, void* const* ptrs, const long long* strides, int B, int N,
                  int S, int D, int Dv, int causal, float scale, unsigned seed,
                  unsigned threshold, float keep_scale, int on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop{seed, threshold, keep_scale, on};
  if (dtype == 0 && Dv == D)
    return forward_fp32(ptrs, strides, B, N, S, D, causal, scale, drop, st);
  if (dtype == 1) return forward_bf16(ptrs, strides, B, N, S, D, Dv, causal, scale, drop, st);
  return (int)cudaErrorInvalidValue;
}

// ptrs: _BWD_PTRS order; delta is [B, N, S] fp32 scratch; strides: q, k, v,
// dO, o, dq, dk, dv (o, the forward's output, is read by the fp32 3xTF32
// kernels only, for delta = dO . o; elsewhere it may be null). causal and
// the dropout must be the forward's (its saved row statistics are of those
// scores); with bf16 and dropout, keep_bits are the forward's (fp32 hashes
// anew).
int b4r_flash_bwd(int dtype, void* const* ptrs, const long long* strides, int B, int N,
                  int S, int D, int Dv, int causal, float scale, unsigned seed,
                  unsigned threshold, float keep_scale, int on, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop{seed, threshold, keep_scale, on};
  if (dtype == 0 && Dv == D)
    return backward_fp32(ptrs, strides, B, N, S, D, causal, scale, drop, st);
  if (dtype == 1)
    return backward_bf16(ptrs, strides, B, N, S, D, Dv, causal, scale, drop, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
