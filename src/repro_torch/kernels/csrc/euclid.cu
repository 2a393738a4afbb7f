// K1: batched squared Euclidean distance (verification, brute force).
//
// Replaces the Pallas kernel repro/kernels/euclid.py::euclid_pallas.
//   out[a, b] = sum_t (x[row(a, b), t] - q[a, t])^2, f32 accumulation,
//   x and q both f32 or both bf16, out f32, with two entry points:
//   repro_euclid         all pairs: row(a, b) = b, x (N, T), out (Q, N);
//   repro_euclid_gather  gathered:  row(a, b) = gather[a, b] (int64), x
//                        (U, T) the union of a verification round's
//                        rows, out (Qa, B) -- one launch per round.
//
// Contract: the reduction order of one (query, row) pair is fixed by T
// and the dtype alone.  One warp owns one pair in pair_dist(), which both
// entry points run.  When T is a multiple of the 16-byte vector width
// (4 f32, 8 bf16), lane l sums the 16-byte chunks l, l+32, ... in order
// with fmaf, each chunk's values in order; otherwise lane l sums the
// scalars t = l, l+32, ... in order.  Then a fixed xor butterfly sums the
// 32 lanes.  Nothing depends on N, Q, B, U, where the pair sits in the
// grid or which entry ran it, so a verification round and a whole-corpus
// brute force give bit-identical distances.  The wrappers hand in
// 16-byte-aligned tensors, so alignment never picks the form.  The form
// stays subtract-square-sum: the GEMM expansion |q|^2 + |x|^2 - 2 q.x
// cancels near zero and would reorder ties in exact verification, so K1
// has no product for the tensor cores.
//
// Bound: bytes (3 flops per element read).  At the verification round
// shape (Qa = 8, B = 256, T = 960 f32) the unique rows, the queries, the
// gather and the output are 7.92 MB, 2.36 us of HBM time.  Design: one
// block per (query, tile of candidates), 8 warps, each warp taking the
// tile's candidates in turn; the query is staged once into shared memory
// with cp.async and every warp reads it from there; candidate rows are
// read with coalesced 16-byte loads, and rows shared between queries come
// from L2 (query-fastest block order).  The tile shrinks until the grid
// has two blocks per SM where the pairs allow it (a round's 2,048 pairs:
// 256 blocks of one candidate per warp).  The query must fit a block's
// shared memory (232,448 bytes: T <= 58,112 f32 or 116,224 bf16); the
// wrappers raise beyond that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps per block
constexpr int kMaxPerWarp = 16;            // candidates per warp, at most
constexpr int64_t kTargetBlocks = 2 * 132; // two blocks per H100 SM
constexpr int64_t kMaxSmem = 232448;      // a block's shared memory on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One 16-byte chunk: its values in order, fmaf into acc.
__device__ __forceinline__ float chunk_acc(const float4& a, const float4& b,
                                           float acc, float) {
  float d = a.x - b.x;
  acc = fmaf(d, d, acc);
  d = a.y - b.y;
  acc = fmaf(d, d, acc);
  d = a.z - b.z;
  acc = fmaf(d, d, acc);
  d = a.w - b.w;
  return fmaf(d, d, acc);
}
__device__ __forceinline__ float chunk_acc(const float4& a, const float4& b,
                                           float acc, __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 u = __bfloat1622float2(x[k]);   // .x is the lower address
    const float2 v = __bfloat1622float2(y[k]);
    float d = u.x - v.x;
    acc = fmaf(d, d, acc);
    d = u.y - v.y;
    acc = fmaf(d, d, acc);
  }
  return acc;
}

// The distance of one (query, row) pair, summed by one warp; every lane
// returns it.  kVec: T is a multiple of the 16-byte width, and both
// pointers are 16-byte aligned.
template <typename T, bool kVec>
__device__ __forceinline__ float pair_dist(const T* __restrict__ x,
                                           const T* q, int64_t t_len,
                                           int lane) {
  float acc = 0.f;
  if (kVec) {
    constexpr int kV = 16 / sizeof(T);
    const int64_t n_chunks = t_len / kV;
    const float4* xv = reinterpret_cast<const float4*>(x);
    const float4* qv = reinterpret_cast<const float4*>(q);
#pragma unroll 4
    for (int64_t c = lane; c < n_chunks; c += 32)
      acc = chunk_acc(__ldg(xv + c), qv[c], acc, T());
  } else {
#pragma unroll 4
    for (int64_t t = lane; t < t_len; t += 32) {
      const float d = to_f32(x[t]) - to_f32(q[t]);
      acc = fmaf(d, d, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// One block: query a, candidates [b0, b0 + tile).  gather == nullptr is
// the all-pairs form (row = candidate).  The query is read from shared
// memory.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    euclid_kernel(const T* __restrict__ x, const T* __restrict__ q,
                  const int64_t* __restrict__ gather,
                  float* __restrict__ out, int64_t n_rows, int64_t n_q,
                  int64_t n_cand, int64_t t_len, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = blockIdx.x % n_q;        // query fastest: a row tile
  const int64_t b0 = (blockIdx.x / n_q) * tile;  // stays in L2 across it
  const T* qa = q + a * t_len;
  T* qs = reinterpret_cast<T*>(smem_raw);
  if (kVec) {
    const int64_t n_chunks = t_len * (int64_t)sizeof(T) / 16;
    for (int64_t c = threadIdx.x; c < n_chunks; c += blockDim.x)
      cp_async16(reinterpret_cast<float4*>(qs) + c,
                 reinterpret_cast<const float4*>(qa) + c);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (int64_t t = threadIdx.x; t < t_len; t += blockDim.x) qs[t] = qa[t];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b_end = b0 + tile < n_cand ? b0 + tile : n_cand;
  for (int64_t b = b0 + warp; b < b_end; b += kWarps) {
    int64_t row = b;
    if (gather != nullptr) row = gather[a * n_cand + b];
    float d;
    if (row >= 0 && row < n_rows) {
      d = pair_dist<T, kVec>(x + row * t_len, qs, t_len, lane);
    } else {
      d = __int_as_float(0x7fc00000);        // NaN: the wrapper checks
    }
    if (lane == 0) out[a * n_cand + b] = d;
  }
}

template <typename T, bool kVec>
int launch_typed(const void* x, const void* q, const int64_t* gather,
                 void* out, int64_t n_rows, int64_t n_q, int64_t n_cand,
                 int64_t t_len, cudaStream_t s) {
  const int64_t pairs = n_q * n_cand;
  int64_t per_warp = pairs / (kWarps * kTargetBlocks);
  per_warp = per_warp < 1 ? 1 : (per_warp > kMaxPerWarp ? kMaxPerWarp
                                                        : per_warp);
  const int tile = (int)(per_warp * kWarps);
  const int64_t blocks = n_q * ((n_cand + tile - 1) / tile);
  if (blocks <= 0 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int64_t q_bytes = t_len * (int64_t)sizeof(T);
  if (q_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (q_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        euclid_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)q_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  euclid_kernel<T, kVec><<<(unsigned)blocks, kWarps * 32, (size_t)q_bytes,
                           s>>>((const T*)x, (const T*)q, gather, (float*)out,
                                n_rows, n_q, n_cand, t_len, tile);
  return (int)cudaGetLastError();
}

// The form is chosen by T and the dtype alone.
int launch(const void* x, const void* q, const int64_t* gather, void* out,
           int64_t n_rows, int64_t n_q, int64_t n_cand, int64_t t_len,
           int dtype, void* stream) {
  if (n_q <= 0 || n_cand <= 0 || t_len <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return t_len % 4 == 0
               ? launch_typed<float, true>(x, q, gather, out, n_rows, n_q,
                                           n_cand, t_len, s)
               : launch_typed<float, false>(x, q, gather, out, n_rows, n_q,
                                            n_cand, t_len, s);
  if (dtype == 1)
    return t_len % 8 == 0
               ? launch_typed<__nv_bfloat16, true>(x, q, gather, out, n_rows,
                                                   n_q, n_cand, t_len, s)
               : launch_typed<__nv_bfloat16, false>(x, q, gather, out,
                                                    n_rows, n_q, n_cand,
                                                    t_len, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All pairs: x (n_rows, t_len), q (n_q, t_len), out (n_q, n_rows) f32.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_euclid(const void* x, const void* q, void* out,
                            int64_t n_rows, int64_t n_q, int64_t t_len,
                            int dtype, void* stream) {
  return launch(x, q, nullptr, out, n_rows, n_q, n_rows, t_len, dtype,
                stream);
}

// Gathered: rows (n_rows, t_len), q (n_q, t_len), gather (n_q, n_cand)
// int64 in [0, n_rows), out (n_q, n_cand) f32: out[a, b] is the distance
// of q[a] to rows[gather[a, b]].  Returns the cudaError_t of the launch.
extern "C" int repro_euclid_gather(const void* rows, const void* q,
                                   const void* gather, void* out,
                                   int64_t n_rows, int64_t n_q,
                                   int64_t n_cand, int64_t t_len, int dtype,
                                   void* stream) {
  if (gather == nullptr) return (int)cudaErrorInvalidValue;
  return launch(rows, q, (const int64_t*)gather, out, n_rows, n_q, n_cand,
                t_len, dtype, stream);
}
