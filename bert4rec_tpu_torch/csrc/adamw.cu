// K12: the trainer's update, optax's chain(clip_by_global_norm, adamw), as
// one multi-tensor pass for Hopper (sm_90a), in place:
//
//   norm = sqrt(sum over every leaf of sum(g * g))
//   g'   = g where norm < clip, else g / norm * clip
//   m    = b1 m + (1 - b1) g'        v = b2 v + (1 - b2) g'^2
//   u    = (m / bc1) / (sqrt(v / bc2) + eps)  (+ wd p on decayed leaves)
//   p   -= lr u
//
// p, m, v fp32; g fp32 or bf16 (read in its own dtype); every sum and the
// update in fp32.
//
// Replaces no TPU kernel: the JAX package leaves optax's chain to XLA. It
// replaces the port's per-leaf clip and eleven foreach operations
// (ops/adamw.py's plain version), which wrote the clipped gradient and
// three more fp32 temporaries a leaf: ~150 bytes moved an element, 133 ms of
// moonlight_5L's 360 ms step over 2.48 B parameters, and ~1,100 launches a
// step at bert_base_512.
//
// Bound. 32 bytes an element: g read for the norm, then p, g, m, v read and
// p, m, v written (79.4 GB at moonlight_5L, 23.7 ms at 3.35 TB/s).
//
// Design. The wrapper (ops/adamw.py) writes a table of the leaves (their
// four pointers, element count and flags) and each leaf's first chunk: a
// leaf is cut into chunks of kChunk elements, its last one ragged, and no
// chunk crosses a leaf, so one grid of fixed-size blocks covers leaves
// from one element to hundreds of millions. A block finds its leaf by a
// binary search over the first chunks (a small array every block reads,
// held in L1). Offsets inside a leaf are 64-bit.
//   adamw_sumsq_kernel      a chunk's sum of g * g (16-byte or 8-byte
//                           vector loads where the leaf is aligned), one
//                           fp32 partial a chunk
//   adamw_leaf_sums_kernel  one block: a warp a leaf adds its partials in
//                           chunk order (in double), then one warp adds the
//                           leaves in leaf order and writes the norm
//   adamw_update_kernel     a chunk's update, the norm read from device
//                           memory (the wrapper's, or a mesh hook's)
// No float atomics: every sum has a fixed order, so two calls give the same
// bits.
//
// Interface: two C entry points on the caller's stream, each returning the
// first non-zero CUDA error code (cudaErrorInvalidValue for a bad
// argument).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace b4r {
namespace adamw {

constexpr unsigned kFull = 0xffffffffu;
constexpr long long kChunk = 1 << 16;   // elements a block: ops/adamw.CHUNK
constexpr int kThreads = 256;           // the chunk kernels' block
constexpr int kSumThreads = 1024;       // adamw_leaf_sums_kernel's block
constexpr long long kDecay = 1;         // Leaf::flags
constexpr long long kBf16 = 2;

// A row of the wrapper's table: six int64 (ops/adamw.leaf_table).
struct Leaf {
  float* p;
  const void* g;
  float* m;
  float* v;
  long long n;
  long long flags;
};
static_assert(sizeof(Leaf) == 48, "the wrapper writes six int64 a leaf");

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, clip;
};

// The last leaf whose first chunk is at or before `chunk`: leaves without a
// chunk share their successor's first chunk and are passed over.
__device__ __forceinline__ int find_leaf(const long long* begin, int n_leaves,
                                         long long chunk) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(begin + mid) <= chunk) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements of g from a 16-byte (fp32) or 8-byte (bf16)
// aligned address.
__device__ __forceinline__ float4 load4(const float* x) {
  return __ldg(reinterpret_cast<const float4*>(x));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(x));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ bool aligned4(const T* x) {
  return reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
}

// The block's sum of x, in a fixed order; the result is thread 0's.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  }
  return x;
}

template <typename T>
__device__ float chunk_sumsq(const T* g, int len) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int done = 0;
  if (aligned4(g)) {
    const int units = len / 4;
#pragma unroll 4
    for (int j = threadIdx.x; j < units; j += kThreads) {
      const float4 t = load4(g + 4 * j);
      a0 = fmaf(t.x, t.x, a0);
      a1 = fmaf(t.y, t.y, a1);
      a2 = fmaf(t.z, t.z, a2);
      a3 = fmaf(t.w, t.w, a3);
    }
    done = units * 4;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads) {
    const float t = to_float(g[j]);
    a0 = fmaf(t, t, a0);
  }
  return (a0 + a1) + (a2 + a3);
}

__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const Leaf* __restrict__ leaves,
                   const long long* __restrict__ begin, int n_leaves,
                   float* __restrict__ partial) {
  const long long chunk = blockIdx.x;
  const int li = find_leaf(begin, n_leaves, chunk);
  const Leaf leaf = leaves[li];
  const long long start = (chunk - begin[li]) * kChunk;
  const int len = (int)min(kChunk, leaf.n - start);
  const float s =
      (leaf.flags & kBf16)
          ? chunk_sumsq(static_cast<const __nv_bfloat16*>(leaf.g) + start, len)
          : chunk_sumsq(static_cast<const float*>(leaf.g) + start, len);
  const float total = block_sum(s);
  if (threadIdx.x == 0) partial[chunk] = total;
}

__global__ void __launch_bounds__(kSumThreads)
adamw_leaf_sums_kernel(const long long* __restrict__ begin, int n_leaves,
                       const float* __restrict__ partial,
                       float* __restrict__ sums, float* __restrict__ norm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int li = warp; li < n_leaves; li += kSumThreads / 32) {
    double s = 0.0;
    for (long long c = begin[li] + lane; c < begin[li + 1]; c += 32)
      s += partial[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
    if (lane == 0) sums[li] = (float)s;
  }
  __syncthreads();
  if (warp == 0) {
    double s = 0.0;
    for (int li = lane; li < n_leaves; li += 32) s += sums[li];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
    if (lane == 0) *norm = sqrtf((float)s);
  }
}

// One element's clip and AdamW step, rounded where the plain version's
// foreach operations round (a scalar times a tensor added by a fused
// multiply-add, every other operation on its own), so that under the same
// norm the two give the same bits.
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     bool decay, bool below, float nrm,
                                     const Hyper& h) {
  if (!below) g = __fmul_rn(__fdiv_rn(g, nrm), h.clip);
  m = __fmaf_rn(g, h.omb1, __fmul_rn(m, h.b1));
  v = __fmaf_rn(__fmul_rn(g, g), h.omb2, __fmul_rn(v, h.b2));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (decay) u = __fmaf_rn(p, h.wd, u);
  p = __fmaf_rn(u, -h.lr, p);
}

template <typename T>
__device__ void chunk_update(float* p, const T* g, float* m, float* v,
                             int len, bool decay, bool below, float nrm,
                             const Hyper& h) {
  int done = 0;
  if (aligned4(g) && aligned4(p) && aligned4(m) && aligned4(v)) {
    const int units = len / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
#pragma unroll 2
    for (int j = threadIdx.x; j < units; j += kThreads) {
      float4 pp = p4[j], mm = m4[j], vv = v4[j];
      const float4 gg = load4(g + 4 * j);
      adam(pp.x, gg.x, mm.x, vv.x, decay, below, nrm, h);
      adam(pp.y, gg.y, mm.y, vv.y, decay, below, nrm, h);
      adam(pp.z, gg.z, mm.z, vv.z, decay, below, nrm, h);
      adam(pp.w, gg.w, mm.w, vv.w, decay, below, nrm, h);
      p4[j] = pp;
      m4[j] = mm;
      v4[j] = vv;
    }
    done = units * 4;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads)
    adam(p[j], to_float(g[j]), m[j], v[j], decay, below, nrm, h);
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const Leaf* __restrict__ leaves,
                    const long long* __restrict__ begin, int n_leaves,
                    const float* __restrict__ norm, Hyper h) {
  const long long chunk = blockIdx.x;
  const int li = find_leaf(begin, n_leaves, chunk);
  const Leaf leaf = leaves[li];
  const long long start = (chunk - begin[li]) * kChunk;
  const int len = (int)min(kChunk, leaf.n - start);
  const float nrm = *norm;
  const bool below = nrm < h.clip, decay = (leaf.flags & kDecay) != 0;
  if (leaf.flags & kBf16)
    chunk_update(leaf.p + start,
                 static_cast<const __nv_bfloat16*>(leaf.g) + start,
                 leaf.m + start, leaf.v + start, len, decay, below, nrm, h);
  else
    chunk_update(leaf.p + start, static_cast<const float*>(leaf.g) + start,
                 leaf.m + start, leaf.v + start, len, decay, below, nrm, h);
}

}  // namespace adamw
}  // namespace b4r

extern "C" {

// leaves: n_leaves rows of six int64 (p, g, m, v, n, flags); begin:
// n_leaves + 1 int64, each leaf's first chunk and then n_chunks. partial:
// n_chunks fp32; sums: n_leaves fp32, each leaf's sum of g * g; norm: one
// fp32, the square root of their sum. Two launches.
int b4r_adamw_norm(const void* leaves, const void* begin, int n_leaves,
                   long long n_chunks, void* partial, void* sums, void* norm,
                   void* stream) {
  using namespace b4r::adamw;
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* first = static_cast<const long long*>(begin);
  adamw_sumsq_kernel<<<(unsigned)n_chunks, kThreads, 0, st>>>(
      static_cast<const Leaf*>(leaves), first, n_leaves,
      static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adamw_leaf_sums_kernel<<<1, kSumThreads, 0, st>>>(
      first, n_leaves, static_cast<const float*>(partial),
      static_cast<float*>(sums), static_cast<float*>(norm));
  return (int)cudaGetLastError();
}

// The update of every leaf of the table in place, clipped by the fp32 norm
// at `norm` (device memory). One launch.
int b4r_adamw_update(const void* leaves, const void* begin, int n_leaves,
                     long long n_chunks, const void* norm, float lr, float b1,
                     float omb1, float b2, float omb2, float eps, float wd,
                     float bc1, float bc2, float clip, void* stream) {
  using namespace b4r::adamw;
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, clip};
  adamw_update_kernel<<<(unsigned)n_chunks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const long long*>(begin),
      n_leaves, static_cast<const float*>(norm), h);
  return (int)cudaGetLastError();
}

}  // extern "C"
