// The item table's gradient: the backward of the embedding gather, for
// Hopper (sm_90a).
//
//   dtable[v, :] = sum of g[r, :] over the positions r with ids[r] == v
//
// g [R, H] in the compute dtype (bf16 or fp32; reading it in that dtype is
// the backward of the gather's cast), ids [R] int32, dtable [V, H] fp32,
// 0 in every row no position touches. The [PAD] row keeps its gradient, as
// JAX's jnp.take has no padding index.
//
// Replaces no TPU kernel: the JAX package's gather (jnp.take) leaves its
// backward to XLA's scatter-add. It replaces PyTorch's index_put_
// (accumulate=True), which sorts the ids and walks each run of equal ids
// with one warp, row by row: at ml-20m_128's batch (R = 51,200) the [PAD]
// run is 27,623 rows and the [MASK] run 4,630, and that walk took 16-18 ms
// a step (PERF.md).
//
// Bound. Read g once and write dtable once: at ml-20m_128 (R = 51,200,
// H = 128 bf16, V = 26,732) 13.1 + 13.7 MB, about 8 us at 3.35 TB/s.
//
// Design. No sort: a warp takes a tile of 32 consecutive positions, and each
// group of equal ids inside it (__match_any_sync) is one piece. So a run of
// one id is cut into pieces of at most 32 rows that are summed in parallel,
// and an id has at most one piece a tile.
//   table_grad_pieces_{bf16,f32}  each piece's rows summed in position
//       order in fp32 (16-byte loads, four rows in flight; at H = 128 bf16
//       a row is 16 lanes, so a warp sums two rows at a time and adds the
//       two halves after; a row of more than 32 loads is cut into slices,
//       a warp each), the sum written to scratch at the row of the piece's
//       first position; the one-row pieces (most items) are copied there
//       together, four rows in flight. That position is put in the id's
//       list: an integer atomic gives it a slot, one of 32 inline slots of
//       the id, past them one of a shared overflow list tagged with the id.
//       Slots are given in no fixed order.
//   table_grad_combine  an id with at most 32 pieces is a warp's: it ranks
//       its pieces by position and adds them in that order. An id with
//       more (the pieces kernel lists it when its 33rd piece comes) is a
//       block's, one of up to 256 blocks ahead of the warps' that take the
//       list in turn: the pieces are laid out by tile in shared memory
//       (inline slots and the overflow entries of the id), each group of
//       threads adds the tiles t = rg, rg + groups, ... in order, and the
//       groups are added in order. Rows no position touches are written 0
//       here, so dtable needs no fill.
// No float atomics: every sum has a fixed order, so two runs give the same
// bits. Three operations a call: a memset of the counts and two kernels.
//
// Interface: one C entry point on the caller's stream, returning the first
// non-zero CUDA error code (cudaErrorInvalidValue for a bad argument). The
// wrapper (ops/table_gradient.py) allocates the int32 scratch, of the size
// b4r_table_grad_scratch gives, and the fp32 piece sums (R x Hp, Hp = H
// rounded up to 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace b4r {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;                 // positions a warp tile
constexpr int kInline = 32;               // inline slots an id
constexpr int kPieceThreads = 256;        // table_grad_pieces' block
constexpr int kCombineThreads = 1024;     // table_grad_combine's block
constexpr int kCombineWarps = kCombineThreads / 32;
constexpr int kAhead = 8;                 // loads in flight a thread
constexpr unsigned char kNone = 0xff;     // no piece in this tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The columns of a row's 16-byte unit: 8 bf16 or 4 fp32.
template <typename T>
struct Unit { static constexpr int kCols = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void add_raw(float* acc, const uint4& raw) {
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < Unit<T>::kCols; ++e) acc[e] += to_float(x[e]);
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// The id at a position, or -1 past R or outside [0, V) (no piece).
__device__ __forceinline__ int id_at(const int* ids, int pos, int R, int V) {
  if (pos >= R) return -1;
  const int id = ids[pos];
  return (id >= 0 && id < V) ? id : -1;
}

// Row r's unit u as fp32, into part's row (16-byte stores).
__device__ __forceinline__ void store_unit(float* part, long long row, int Hp,
                                           int u, const float* x, int cols) {
  float4* dst = reinterpret_cast<float4*>(part + row * Hp + u * cols);
  for (int e = 0; e < cols; e += 4)
    dst[e / 4] = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
}

// acc += unit u of the rows in mask (lane bits of the tile at base), in
// lane order; kAhead / 2 loads in flight where vec.
template <typename T>
__device__ __forceinline__ void add_rows(float* acc, const T* g, int base,
                                         unsigned mask, int u, int H,
                                         bool vec) {
  constexpr int kCols = Unit<T>::kCols;
  if (vec) {
    for (unsigned m = mask; m;) {
      uint4 raw[kAhead / 2];
      bool got[kAhead / 2];
#pragma unroll
      for (int i = 0; i < kAhead / 2; ++i) {
        got[i] = m != 0;
        if (got[i]) {
          const int r = base + __ffs(m) - 1;
          m &= m - 1;
          raw[i] = __ldg(reinterpret_cast<const uint4*>(
              g + (long long)r * H + u * kCols));
        }
      }
#pragma unroll
      for (int i = 0; i < kAhead / 2; ++i)
        if (got[i]) add_raw<T>(acc, raw[i]);
    }
  } else {
    for (unsigned m = mask; m; m &= m - 1) {
      const T* src = g + (long long)(base + __ffs(m) - 1) * H + u * kCols;
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        if (u * kCols + e < H) acc[e] += to_float(src[e]);
    }
  }
}

// The lanes of mask whose rank in it is sub mod subs.
__device__ __forceinline__ unsigned every_nth(unsigned mask, int subs,
                                              int sub) {
  unsigned own = 0;
  int k = 0;
  for (unsigned m = mask; m; m &= m - 1, ++k)
    if (k % subs == sub) own |= m & (~m + 1u);
  return own;
}

template <typename T>
__device__ __forceinline__ void pieces(const T* __restrict__ g,
                                       const int* __restrict__ ids, int R,
                                       int H, int V, int Hp, bool vec,
                                       float* __restrict__ part, int* count,
                                       int* slots, int* ovf, int* heavy) {
  constexpr int kCols = Unit<T>::kCols;
  const int lane = threadIdx.x & 31;
  // lanes a row: the row's units rounded up to a power of two, at most 32;
  // a wider row is cut into slices of 32 units, a warp each, so a tile
  // has `slices` warps; the warp sums 32 / lpr rows at a time (sub-rows)
  const int units = (H + kCols - 1) / kCols;
  int lpr = 1;
  while (lpr < units && lpr < 32) lpr <<= 1;
  const int slices = (units + 31) / 32;
  const int warp = blockIdx.x * (kPieceThreads / 32) + (threadIdx.x >> 5);
  const int base = warp / slices * kTile, slice = warp % slices;
  const int subs = 32 / lpr, sub = lane / lpr;
  const int u = slice * lpr + lane % lpr;
  const int id = id_at(ids, base + lane, R, V);
  const unsigned same = __match_any_sync(kFull, id);
  const bool leader = id >= 0 && lane == __ffs(same) - 1;
  if (leader && slice == 0) {
    const int pos = base + lane;
    const int slot = atomicAdd(count + id, 1);
    if (slot < kInline) {
      slots[(long long)id * kInline + slot] = pos;
    } else {
      const int k = atomicAdd(count + V, 1);
      ovf[2 * k] = id;
      ovf[2 * k + 1] = pos;
      if (slot == kInline) heavy[atomicAdd(count + V + 1, 1)] = id;
    }
  }
  const bool single = leader && __popc(same) == 1;
  unsigned groups = __ballot_sync(kFull, leader && !single);

  // groups of two or more rows, one at a time: sub-row s sums the group's
  // rows of rank s mod subs, then the sub-rows are added in order
  while (groups) {
    const int lead = __ffs(groups) - 1;
    groups &= groups - 1;
    const unsigned rows = __shfl_sync(kFull, same, lead);
    float acc[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
    if (u < units) add_rows(acc, g, base, every_nth(rows, subs, sub), u, H, vec);
    for (int s = 1; s < subs; ++s) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const float x = __shfl_sync(kFull, acc[e], (lane + s * lpr) & 31);
        if (sub == 0) acc[e] += x;
      }
    }
    if (sub == 0 && u < units) store_unit(part, base + lead, Hp, u, acc, kCols);
  }

  // one-row pieces all together: sub-row s copies those of rank s mod subs
  // to part as fp32, kAhead / 2 of them in flight
  unsigned own = every_nth(__ballot_sync(kFull, single), subs, sub);
  if (u >= units) return;
  while (own) {
    uint4 raw[kAhead / 2];
    int at[kAhead / 2];
#pragma unroll
    for (int i = 0; i < kAhead / 2; ++i) {
      at[i] = own ? __ffs(own) - 1 : -1;
      own &= own - 1;
      if (at[i] >= 0 && vec)
        raw[i] = __ldg(reinterpret_cast<const uint4*>(
            g + (long long)(base + at[i]) * H + u * kCols));
    }
#pragma unroll
    for (int i = 0; i < kAhead / 2; ++i) {
      if (at[i] < 0) continue;
      float x[kCols];
#pragma unroll
      for (int e = 0; e < kCols; ++e) x[e] = 0.f;
      if (vec)
        add_raw<T>(x, raw[i]);
      else
        add_rows(x, g, base, 1u << at[i], u, H, false);
      store_unit(part, base + at[i], Hp, u, x, kCols);
    }
  }
}

__global__ void __launch_bounds__(kPieceThreads)
table_grad_pieces_bf16(const __nv_bfloat16* g, const int* ids, int R, int H,
                       int V, int Hp, bool vec, float* part, int* count,
                       int* slots, int* ovf, int* heavy) {
  pieces(g, ids, R, H, V, Hp, vec, part, count, slots, ovf, heavy);
}

__global__ void __launch_bounds__(kPieceThreads)
table_grad_pieces_f32(const float* g, const int* ids, int R, int H, int V,
                      int Hp, bool vec, float* part, int* count, int* slots,
                      int* ovf, int* heavy) {
  pieces(g, ids, R, H, V, Hp, vec, part, count, slots, ovf, heavy);
}

// Chunk c (4 columns) of dtable's row v.
__device__ __forceinline__ void store_chunk(float* out, int v, int c, int H,
                                            float4 acc) {
  float* dst = out + (long long)v * H + 4 * c;
  if ((H & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = acc;
  } else {
    const float x[4] = {acc.x, acc.y, acc.z, acc.w};
    for (int e = 0; e < 4 && 4 * c + e < H; ++e) dst[e] = x[e];
  }
}

__global__ void __launch_bounds__(kCombineThreads)
table_grad_combine(const float4* __restrict__ part,
                   const int* __restrict__ count,
                   const int* __restrict__ slots,
                   const int* __restrict__ ovf,
                   const int* __restrict__ heavy, int V, int H, int Hp,
                   int tiles, int heavy_blocks, float* __restrict__ out) {
  extern __shared__ unsigned char lead[];   // [tiles]: the piece's lane
  __shared__ float4 red[kCombineThreads];
  const int nch = Hp / 4;                    // float4 chunks of a part row
  const int chunks = (H + 3) / 4;            // of them inside dtable
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if ((int)blockIdx.x >= heavy_blocks) {
    // a warp an id; ids with more than 32 pieces are the heavy blocks'
    const int lane = threadIdx.x & 31;
    const int v = (blockIdx.x - heavy_blocks) * kCombineWarps + (threadIdx.x >> 5);
    const int n = v < V ? count[v] : kInline + 1;
    if (n > kInline) return;
    // rank the pieces by position (distinct), then lane k holds the k-th
    const int p = lane < n ? slots[(long long)v * kInline + lane] : 0x7fffffff;
    int sorted = p;
    if (n > 1) {
      int rank = 0;
      for (int j = 0; j < 32; ++j) rank += __shfl_sync(kFull, p, j) < p;
      for (int j = 0; j < 32; ++j) {
        const int q = __shfl_sync(kFull, p, j), r = __shfl_sync(kFull, rank, j);
        if (r == lane) sorted = q;
      }
    }
    for (int c0 = 0; c0 < chunks; c0 += 32) {
      const int c = c0 + lane;
      float4 acc = zero;
      for (int k = 0; k < n; k += kAhead) {
        float4 x[kAhead];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
          const int pk = __shfl_sync(kFull, sorted, (k + i) & 31);
          x[i] = (k + i < n && c < chunks) ? part[(long long)pk * nch + c] : zero;
        }
#pragma unroll
        for (int i = 0; i < kAhead; ++i) add4(acc, x[i]);
      }
      if (c < chunks) store_chunk(out, v, c, H, acc);
    }
    return;
  }

  // an id with more than 32 pieces a block, in turn over the heavy list
  const int t = threadIdx.x;
  int lpr = 1;                               // threads a row: <= 32
  while (lpr < chunks && lpr < 32) lpr <<= 1;
  const int groups = kCombineThreads / lpr, rg = t / lpr, cl = t % lpr;
  const int n_ovf = count[V], n_heavy = count[V + 1];
  for (int h = blockIdx.x; h < n_heavy; h += heavy_blocks) {
    const int hv = heavy[h];
    for (int i = t; i < tiles; i += kCombineThreads) lead[i] = kNone;
    __syncthreads();
    if (t < kInline) {
      const int p = slots[(long long)hv * kInline + t];
      lead[p / kTile] = (unsigned char)(p % kTile);
    }
    for (int i = t; i < n_ovf; i += kCombineThreads) {
      if (ovf[2 * i] == hv) {
        const int p = ovf[2 * i + 1];
        lead[p / kTile] = (unsigned char)(p % kTile);
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < chunks; c0 += lpr) {
      const int c = c0 + cl;
      float4 acc = zero;
      if (c < chunks) {
        for (int tile = rg; tile < tiles; tile += kAhead * groups) {
          float4 x[kAhead];
#pragma unroll
          for (int i = 0; i < kAhead; ++i) {
            const int tt = tile + i * groups;
            const unsigned char l = tt < tiles ? lead[tt] : kNone;
            x[i] = l != kNone ? part[((long long)tt * kTile + l) * nch + c] : zero;
          }
#pragma unroll
          for (int i = 0; i < kAhead; ++i) add4(acc, x[i]);
        }
      }
      red[t] = acc;
      __syncthreads();
      if (rg == 0 && c < chunks) {
        for (int r = 1; r < groups; ++r) add4(acc, red[r * lpr + cl]);
        store_chunk(out, hv, c, H, acc);
      }
      __syncthreads();
    }
  }
}

}  // namespace b4r

extern "C" {

// int32s of b4r_table_grad's iscratch for R positions and V ids: the
// counts (V, then the overflow and heavy counts), V x 32 inline slots,
// R overflow (id, position) pairs and R / 32 heavy ids. 0 where R is past
// what the combine kernel takes (a byte a tile of shared memory, at most
// 160 KiB) or an argument is not positive.
long long b4r_table_grad_scratch(int R, int V) {
  using namespace b4r;
  if (R <= 0 || V <= 0) return 0;
  const long long tiles = ((long long)R + kTile - 1) / kTile;
  if ((tiles + 15) / 16 * 16 > 160 * 1024) return 0;
  return (long long)V * (1 + kInline) + 2 + 2LL * R + tiles;
}

// dtype: 0 = float32, 1 = bfloat16 for g [R, H] (contiguous). ids [R] int32.
// iscratch: b4r_table_grad_scratch(R, V) int32; part: R x Hp fp32 with
// Hp = H rounded up to 8, 16-byte aligned; out [V, H] fp32, 16-byte
// aligned. Every row of out is written.
int b4r_table_grad(int dtype, const void* g, const int* ids, int R, int H,
                   int V, int* iscratch, float* part, float* out,
                   void* stream) {
  using namespace b4r;
  if (H <= 0 || b4r_table_grad_scratch(R, V) == 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* count = iscratch;                     // [V], overflow, heavy counts
  int* slots = iscratch + V + 2;             // [V, kInline]
  int* ovf = slots + (long long)V * kInline; // [R, 2]
  int* heavy = ovf + 2LL * R;                // [R / 32]: ids past kInline
  const int Hp = (H + 7) / 8 * 8;
  const int tiles = (R + kTile - 1) / kTile;
  const size_t smem = (size_t)(tiles + 15) / 16 * 16;
  cudaError_t err = cudaMemsetAsync(count, 0, (size_t)(V + 2) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int units = (H + (dtype == 1 ? 7 : 3)) / (dtype == 1 ? 8 : 4);
  const long long warps = (long long)tiles * ((units + 31) / 32);
  const int blocks = (int)((warps + kPieceThreads / 32 - 1) / (kPieceThreads / 32));
  const int row_bytes = H * (dtype == 1 ? 2 : 4);
  const bool vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (dtype == 1)
    table_grad_pieces_bf16<<<blocks, kPieceThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), ids, R, H, V, Hp, vec, part,
        count, slots, ovf, heavy);
  else
    table_grad_pieces_f32<<<blocks, kPieceThreads, 0, st>>>(
        static_cast<const float*>(g), ids, R, H, V, Hp, vec, part, count,
        slots, ovf, heavy);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(table_grad_combine,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // at most R / 33 ids have more than 32 pieces: that many heavy blocks,
  // up to 256 (two an SM), each taking every so many of the heavy list;
  // they come first, so the longest sums start first
  const int light_blocks = (V + kCombineWarps - 1) / kCombineWarps;
  const int heavy_blocks = min(R / (kInline + 1) + 1, 256);
  table_grad_combine<<<light_blocks + heavy_blocks, kCombineThreads, smem,
                       st>>>(
      reinterpret_cast<const float4*>(part), count, slots, ovf, heavy, V, H,
      Hp, tiles, heavy_blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
