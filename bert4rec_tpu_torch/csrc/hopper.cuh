// Hopper building blocks shared by the port's warpgroup kernels (sm_90a):
// flash attention's K8/K9 (flash_hopper.cuh), the loss kernels K4-K7
// (loss_hopper.cuh) and the fused encoder layer's K1/K2 (layer_hopper.cuh).
//
// Tiles are 64 rows of bf16 ([64][DP], DP a multiple of 64), each 64
// columns one 8 KB block in the 128-byte swizzle wgmma reads: row r's
// 16-byte chunk c at r * 128 + ((c ^ (r % 8)) * 16). All threads of a
// warpgroup fill a tile with cp.async 16-byte copies from a row-major
// source (16-byte aligned base and row stride; rows and columns past the
// source are zero-filled, which is exact for every product).
//
// Products run on wgmma with fp32 accumulators in registers: a tile is a
// K-major operand (contraction over its columns, k_desc) or, read with the
// transpose bit, an MN-major B operand (contraction over its rows, mn_desc;
// N up to 256 spans four 64-column blocks). For 16-bit types the m64nNk16
// accumulator layout is the A-register layout, so element 4 j + 2 h + e of
// a thread's 64 x 64 accumulator (row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e) packs into k-block j / 2 with no exchange
// (to_frags). A row's columns per thread reduce across the 4 lanes that
// share it (quad_sum).
#pragma once

#include "common.cuh"

namespace b4r {
namespace hopper {
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // rows of every tile (the wgmma M)
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // tiles of the streamed operands in flight
constexpr int kBlockBytes = kRows * 128;  // one [64][64] bf16 swizzled block

__host__ __device__ constexpr int tile_bytes(int dp) { return kRows * dp * 2; }
__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the copies' writes made visible to wgmma's (async-proxy) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows t0 .. t0+63 of a row-major [S, D] matrix at src (row stride ss
// elements: a head, a hidden or a table) into the swizzled [64][DP] tile at
// shared address dst, by the block's NT threads; its 64-column blocks BS
// bytes apart (a [64][DP] tile's own, or half of a 128-row tile's).
template <int DP, int NT = kThreads, int BS = kBlockBytes>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int ss, int t0,
                                          int S, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kRows * kChunks / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / kChunks, c = idx % kChunks, t = t0 + r;
    const int bytes = t < S ? min(16, max(0, 2 * (D - 8 * c))) : 0;
    const bf16* from = bytes ? src + t * ss + 8 * c : src;
    cp_async16(dst + (c >> 3) * BS + r * 128 + (((c & 7) ^ (r & 7)) << 4), from, bytes);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register reads across the asynchronous
// products that write (or read) them
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle (the address,
// strides in 16-byte units, layout type 1 in bits 62-63)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// k-block kk (columns 16 kk .. +15) of a tile as a K-major operand:
// 8-row groups 1024 B apart, the block's 32 bytes inside the swizzle atom
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 16, 1024);
}
// k-block kk (tile rows 16 kk .. +15) of a tile as an MN-major B operand
// (n = its columns): 8-row groups 1024 B apart, 64-column blocks kBlockBytes
__device__ __forceinline__ uint64_t mn_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, kBlockBytes, 1024);
}

// the accumulator operands of one wgmma, eight at a time
#define B4R_F8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d = A B (+ d when accumulate), m64n64k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B (+ d when accumulate), m64n64k16: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d = A B (+ d when accumulate), m64n64k16: A in registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_k_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d = A B (+ d when accumulate), m64n128k16: A in registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_k_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24),
        B4R_F8(32), B4R_F8(40), B4R_F8(48), B4R_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d = A B (+ d when accumulate), m64n128k16: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24),
        B4R_F8(32), B4R_F8(40), B4R_F8(48), B4R_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d = A B (+ d when accumulate), m64n192k16: A in registers, B MN-major in
// shared memory (the dq and dk products of latent attention's 192-wide keys)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24),
        B4R_F8(32), B4R_F8(40), B4R_F8(48), B4R_F8(56),
        B4R_F8(64), B4R_F8(72), B4R_F8(80), B4R_F8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d = A B (+ d when accumulate), m64n256k16: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24),
        B4R_F8(32), B4R_F8(40), B4R_F8(48), B4R_F8(56),
        B4R_F8(64), B4R_F8(72), B4R_F8(80), B4R_F8(88),
        B4R_F8(96), B4R_F8(104), B4R_F8(112), B4R_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d = A B (+ d when accumulate), m64n64k16: A K-major, B MN-major, both in
// shared memory
__device__ __forceinline__ void wgmma_ss_t_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B (+ d when accumulate), m64n128k16: A K-major, B MN-major, both in
// shared memory
__device__ __forceinline__ void wgmma_ss_t_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : B4R_F8(0), B4R_F8(8), B4R_F8(16), B4R_F8(24),
        B4R_F8(32), B4R_F8(40), B4R_F8(48), B4R_F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef B4R_F8

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, db, 1);
  else if constexpr (DP == 128)
    wgmma_rs_n128(d, a, db, 1);
  else if constexpr (DP == 192)
    wgmma_rs_n192(d, a, db, 1);
  else
    wgmma_rs_n256(d, a, db, 1);
}

template <int N>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (N == 64)
    wgmma_ss_t_n64(d, da, db, accumulate);
  else
    wgmma_ss_t_n128(d, da, db, accumulate);
}

// Starts s = X Y^T over the DP columns (X, Y tiles as K-major operands);
// the caller fences before and commits and waits after.
template <int DP>
__device__ __forceinline__ void mma_nt(float (&s)[32], uint32_t X, uint32_t Y) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64(s, k_desc(X, kk), k_desc(Y, kk), kk > 0);
}

// Starts acc += A B, A the 64 x 64 fragments a, B the tile at Bt read
// MN-major (rows = the contraction, columns = N).
template <int DP>
__device__ __forceinline__ void mma_rs(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                         uint32_t Bt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(acc, a[kk], mn_desc(Bt, kk));
}

// Starts d = A B, A the 64 x 64 tile At as a K-major operand, B N columns
// of the tile at Bt read MN-major (rows = the contraction).
template <int N>
__device__ __forceinline__ void mma_ss_t(float (&d)[N / 2], uint32_t At, uint32_t Bt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_t<N>(d, k_desc(At, kk), mn_desc(Bt, kk), kk > 0);
}

// 2^x on the special-function unit, subnormal results flushed to 0 (one
// instruction; exp2f adds a subnormal range fix-up around it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (a 64 x 64 accumulator) rounded to bf16 as A fragments: k-block kk's
// register r packs elements 8 kk + 2 r and 8 kk + 2 r + 1
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// sum over the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// the dynamic shared memory, its start rounded up to the 1024-byte swizzle
// repeat (the launches ask for 1 KB more than the layout)
__device__ __forceinline__ uint8_t* aligned_smem() {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return smem_raw + (((a + 1023) & ~1023u) - a);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// thread-block clusters (the loss backwards' and the layer's weight gradients')
// ---------------------------------------------------------------------------
constexpr int kMaxCluster = 8;  // the portable cluster size

// `blocks` blocks of `threads` threads in clusters of `cluster` along x, with
// `smem` bytes of dynamic shared memory
template <typename... KArgs, typename... Args>
cudaError_t launch_clusters_n(void (*kernel)(KArgs...), int blocks, int cluster, int threads,
                              size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// the same with one warpgroup a block
template <typename... KArgs, typename... Args>
cudaError_t launch_clusters(void (*kernel)(KArgs...), int blocks, int cluster, size_t smem,
                            cudaStream_t stream, Args... args) {
  return launch_clusters_n(kernel, blocks, cluster, kThreads, smem, stream, args...);
}

}  // namespace hopper
}  // namespace b4r
