// 3xTF32 on Hopper's warpgroup tensor cores (sm_90a), shared by the fp32
// layer (layer_tf32.cu), the fp32 loss kernels (loss_tf32.cuh) and fp32
// flash attention (flash_tf32.cuh).
//
// Each fp32 operand is split into hi = cvt.rna.tf32(v) and lo =
// cvt.rna.tf32(v - hi) (v - hi is exact in fp32), and a b accumulates
// lo_a hi_b + hi_a lo_b, then hi_a hi_b, per 8-deep k-block, in fp32: the
// dropped lo_a lo_b and the roundings of lo leave each product within a few
// fp32 ulps of a b (one TF32 pass keeps 11 bits).
//
// wgmma reads .tf32 operands from shared memory only K-major. fp32 tiles
// are panels of 32 columns (one 128-byte row) in the 128-byte swizzle:
// row r's 16-byte chunk c at r * 128 + ((c ^ (r % 8)) * 16), 8-row groups
// 1024 bytes apart.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace b4r {
namespace tf32 {

using hopper::cp_async16;
using hopper::sw128_desc;

__device__ __forceinline__ uint32_t rna_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = __uint_as_float(rna_tf32(v));
  lo = __uint_as_float(rna_tf32(__fsub_rn(v, hi)));
}

// a K-major operand's k-block: 8 fp32 (32 bytes) at column 8 kk of panel
// rows starting at `panel` (8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t kdesc(uint32_t panel, int kk) {
  return sw128_desc(panel + kk * 32, 16, 1024);
}

#define B4R_F8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A B, m64n64k8 .tf32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, m64nNk8 .tf32 (N = 32, 64 or 128), A the registers a (the tf32
// register fragment: row 16 warp + lane / 4 + 8 (r & 1), column lane % 4 +
// 4 (r >> 1) for register r), B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24), B4R_F8(32), B4R_F8(40),
          B4R_F8(48), B4R_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : B4R_F8(0), B4R_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef B4R_F8

// d += A B over one k-block in 3xTF32, m64n64k8 from shared memory: lo hi,
// hi lo, then hi hi; the lo copies of A and B lie `alo` / `blo` bytes past
// their hi ones
__device__ __forceinline__ void mma3(float (&d)[32], uint32_t a, uint32_t alo, uint32_t b,
                                     uint32_t blo, int kk) {
  wgmma_tf32_n64(d, kdesc(a + alo, kk), kdesc(b, kk));
  wgmma_tf32_n64(d, kdesc(a, kk), kdesc(b + blo, kk));
  wgmma_tf32_n64(d, kdesc(a, kk), kdesc(b, kk));
}

template <int N> __device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// copies: ROWS rows x 32 columns of a row-major fp32 matrix (row stride ld,
// n rows, K columns) from (r0, k0) into a swizzled panel at dst by the NT
// threads of the block; rows past n and columns past K zero-filled (exact
// for every product). split_panel then rewrites the chunks this thread
// copied as their hi parts and writes their lo parts `lo` bytes further.
// The _t forms take the thread's index among the NT (a warpgroup's own).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

template <int ROWS, int NT>
__device__ __forceinline__ void copy_panel_t(int t, uint32_t dst, const float* src, int ld,
                                             int r0, int n, int k0, int K) {
  static_assert(ROWS * 8 % NT == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * 8 / NT; ++i) {
    const int idx = t + i * NT, r = idx >> 3, c = idx & 7;
    const int row = r0 + r, col = k0 + 4 * c;
    const int bytes = row < n ? min(16, max(0, 4 * (K - col))) : 0;
    cp_async16(dst + chunk_at(r, c), bytes ? src + (size_t)row * ld + col : src, bytes);
  }
}
template <int ROWS, int NT>
__device__ __forceinline__ void copy_panel(uint32_t dst, const float* src, int ld, int r0,
                                           int n, int k0, int K) {
  copy_panel_t<ROWS, NT>(threadIdx.x, dst, src, ld, r0, n, k0, K);
}

template <int ROWS, int NT>
__device__ __forceinline__ void split_panel_t(int t, uint8_t* panel, int lo) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / NT; ++i) {
    const int idx = t + i * NT;
    float4* p = reinterpret_cast<float4*>(panel + chunk_at(idx >> 3, idx & 7));
    float4* q = reinterpret_cast<float4*>(panel + lo + chunk_at(idx >> 3, idx & 7));
    float4 v = *p, h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *p = h;
    *q = l;
  }
}
template <int ROWS, int NT>
__device__ __forceinline__ void split_panel(uint8_t* panel, int lo) {
  split_panel_t<ROWS, NT>(threadIdx.x, panel, lo);
}

// ---------------------------------------------------------------------------
// register A fragments read from shared memory in any order (ld.shared),
// for the products whose contraction runs along a tile's rows; the k order
// inside each 8-deep k-block is even-first (k position q holds row 2 q for
// q < 4, 2 (q - 4) + 1 above), in the fragments and in the K-major B tiles
// alike, which keeps the transposed reads free of bank conflicts
// ---------------------------------------------------------------------------
// this thread's first accumulator row in its warpgroup's 64
__device__ __forceinline__ int frag_row() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}

// byte offset of element (row, col) of an fp32 tile of `rows` rows in
// 32-column panels (panels rows * 128 bytes apart)
__device__ __forceinline__ uint32_t at(int rows, int row, int col) {
  return (col >> 5) * rows * 128 + chunk_at(row, (col & 31) >> 2) + (col & 3) * 4;
}
__device__ __forceinline__ float ld_at(const uint8_t* t, uint32_t off) {
  return *reinterpret_cast<const float*>(t + off);
}
__device__ __forceinline__ void split_into(float v, uint32_t& hi, uint32_t& lo) {
  float h, l;
  split_tf32(v, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// k-block kb of the raw 64-row tile t read as [M = its rows][K = its
// columns], split: register r holds (row0 + 8 (r & 1), 8 kb + tq + 4 (r >> 1))
__device__ __forceinline__ void frag_rows(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                          const uint8_t* t, int kb) {
  const int tq = threadIdx.x & 3, row0 = frag_row();
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split_into(ld_at(t, at(hopper::kRows, row0 + 8 * (r & 1), 8 * kb + tq + 4 * (r >> 1))),
               hi[r], lo[r]);
}

// k-block kb of the transpose of a ROWS-row tile, [M = its columns m0 ..
// m0 + 63][K = its rows, even-first]: register r holds (column m0 + row0 +
// 8 (r & 1), row 8 kb + 2 tq + (r >> 1)). kSplit: t is raw and is split;
// else t holds the hi parts and t + lo the lo parts.
template <int ROWS, bool kSplit>
__device__ __forceinline__ void frag_cols(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                          const uint8_t* t, int lo_off, int m0, int kb) {
  const int tq = threadIdx.x & 3, row0 = frag_row();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t o = at(ROWS, 8 * kb + 2 * tq + (r >> 1), m0 + row0 + 8 * (r & 1));
    if constexpr (kSplit) {
      split_into(ld_at(t, o), hi[r], lo[r]);
    } else {
      hi[r] = __float_as_uint(ld_at(t, o));
      lo[r] = __float_as_uint(ld_at(t + lo_off, o));
    }
  }
}

// d += A B over one k-block in 3xTF32, A from registers, B's hi and lo
// K-major k-blocks at descriptors bh, bl: lo hi, hi lo, then hi hi
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const uint32_t (&ahi)[4],
                                        const uint32_t (&alo)[4], uint64_t bh, uint64_t bl) {
  wgmma_tf32_rs<N>(d, alo, bh);
  wgmma_tf32_rs<N>(d, ahi, bl);
  wgmma_tf32_rs<N>(d, ahi, bh);
}

// k-block kb of a K-major tile of `rows` rows
__device__ __forceinline__ uint64_t bdesc(uint32_t t, int rows, int kb) {
  return kdesc(t + (kb >> 2) * rows * 128, kb & 3);
}

// k even-first inside each 8: the k position of column (or row) c
__device__ __forceinline__ int kpos(int c) {
  return (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2);
}


// ---------------------------------------------------------------------------
// attention tiles (layer_tf32.cu's attention kernels, flash_tf32.cuh):
// [64][DP] (DP = the head dim rounded up to 32 or 64) in DP / 32 panels, and
// their transposes [DP][64, even-first] in two panels
// ---------------------------------------------------------------------------
constexpr int kPanel = hopper::kRows * 128;  // a 64-row panel of 32 columns
template <int DP> constexpr int kTileQ = DP / 32 * kPanel;
template <int DP> constexpr int kTileT = 2 * DP * 128;

// This thread's chunks of the raw [64][DP] tile at raw (as copy_panel_t<64,
// NT> copied them, t this thread's index among the NT) split: with kSame
// into hi / lo of the same layout at hl (lo kTileQ further), with kTr
// transposed, (row r, column d) to row d, column kpos(r), into hi / lo at
// tr (lo kTileT further)
template <int DP, int NT, bool kSame, bool kTr>
__device__ __forceinline__ void split_tile(int t, const uint8_t* raw, uint8_t* hl, uint8_t* tr) {
#pragma unroll
  for (int p = 0; p < DP / 32; ++p)
#pragma unroll
    for (int i = 0; i < 64 * 8 / NT; ++i) {
      const int idx = t + NT * i, r = idx >> 3, c = idx & 7;
      const uint32_t off = p * kPanel + chunk_at(r, c);
      const float4 v4 = *reinterpret_cast<const float4*>(raw + off);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
      if constexpr (kSame) {
        *reinterpret_cast<float4*>(hl + off) = make_float4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<float4*>(hl + kTileQ<DP> + off) = make_float4(l[0], l[1], l[2], l[3]);
      }
      if constexpr (kTr)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t o = at(DP, 32 * p + 4 * c + e, kpos(r));
          *reinterpret_cast<float*>(tr + o) = h[e];
          *reinterpret_cast<float*>(tr + kTileT<DP> + o) = l[e];
        }
    }
}

// d += A B over one k-block in 3xTF32, A from registers, B's hi and lo
// K-major k-blocks at bh, bl, with the first two passes in mma3's order for
// B A: hi lo, lo hi, then hi hi (s^T = k q^T then sums what s = q k^T sums,
// in the same order)
__device__ __forceinline__ void mma3_rs_ba(float (&d)[32], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint64_t bh, uint64_t bl) {
  wgmma_tf32_rs<64>(d, ahi, bl);
  wgmma_tf32_rs<64>(d, alo, bh);
  wgmma_tf32_rs<64>(d, ahi, bh);
}

// the 64 x 64 accumulator x (row r, column 8 j + 2 tq + e) as the register A
// fragments of k-block j, split: k position tq holds column 8 j + 2 tq,
// position tq + 4 column 8 j + 2 tq + 1 (the transposed B tiles' order)
__device__ __forceinline__ void to_frags_tf32(uint32_t (&hi)[8][4], uint32_t (&lo)[8][4],
                                              const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_into(x[4 * j + 2 * (r & 1) + (r >> 1)], hi[j][r], lo[j][r]);
}

// d += A B over the 64 keys (or queries) of a tile: A the fragments, B the
// transposed [DP][64] tile at bt (lo kTileT further)
template <int DP>
__device__ __forceinline__ void mma3_frags(float (&d)[DP / 2], const uint32_t (&hi)[8][4],
                                           const uint32_t (&lo)[8][4], uint32_t bt) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t t = bt + (j >> 2) * DP * 128;
    wgmma_tf32_rs<DP>(d, lo[j], kdesc(t, j & 3));
    wgmma_tf32_rs<DP>(d, hi[j], kdesc(t + kTileT<DP>, j & 3));
    wgmma_tf32_rs<DP>(d, hi[j], kdesc(t, j & 3));
  }
}

}  // namespace tf32
}  // namespace b4r
