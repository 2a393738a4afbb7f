// K1: batched squared Euclidean distance (verification).
//
// Replaces the Pallas kernel repro/kernels/euclid.py::euclid_pallas.
//   out[q, n] = sum_t (x[n, t] - q[q, t])^2, f32 accumulation,
//   x (N, T) and q (Q, T) both f32 or both bf16, out (Q, N) f32.
//
// Contract: the reduction order of one (query, row) pair is fixed by T
// alone.  One warp owns one pair; lane l accumulates t = l, l+32, ...
// in order with fmaf, then a fixed xor-butterfly sums the 32 lanes.
// Nothing depends on N, Q or where the pair sits in the grid, so every
// engine route that calls this kernel (one verification batch, a whole
// corpus brute force) gives bit-identical distances.  The form stays
// subtract-square-sum: the GEMM expansion |q|^2 + |x|^2 - 2 q.x cancels
// near zero and would reorder ties in exact verification.
//
// Bound: bytes.  N*T input elements are read once (3 flops each); at the
// verification shape (256 x 960, one query) the whole call moves ~1 MB,
// well under a microsecond of HBM time, so a launch is launch-bound.
// Pairs are numbered query-fastest, so the warps that read one row run
// side by side and the row comes from L2 for all but the first query.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void euclid_kernel(const T* __restrict__ x,
                              const T* __restrict__ q,
                              float* __restrict__ out, int64_t n_rows,
                              int64_t n_q, int64_t t_len) {
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n_rows * n_q) return;  // the whole warp leaves together
  const int64_t qi = pair % n_q;
  const int64_t n = pair / n_q;
  const T* xr = x + n * t_len;
  const T* qr = q + qi * t_len;
  float acc = 0.f;
  for (int64_t t = lane; t < t_len; t += 32) {
    const float d = to_f32(xr[t]) - to_f32(qr[t]);
    acc = fmaf(d, d, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[qi * n_rows + n] = acc;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_euclid(const void* x, const void* q, void* out,
                            int64_t n_rows, int64_t n_q, int64_t t_len,
                            int dtype, void* stream) {
  const int64_t blocks =
      (n_rows * n_q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks <= 0 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(32 * kWarpsPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    euclid_kernel<float><<<grid, block, 0, s>>>(
        (const float*)x, (const float*)q, (float*)out, n_rows, n_q, t_len);
  } else if (dtype == 1) {
    euclid_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)q, (float*)out,
        n_rows, n_q, t_len);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
