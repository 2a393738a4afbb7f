// K4: PAA segment means (Eq. 5), the encoders' front end.
//
// Replaces the Pallas kernel repro/kernels/paa.py::paa_pallas.
//   out[n, w] = (sum_{e < E} x[n, w*E + e]) / E,  E = T / W,
//   x (N, T) f32 or bf16, out (N, W) f32, f32 accumulation.
//
// Bound: bytes.  Each input element is read once and added once; at the
// encode shape (1M x 960 f32) the call moves ~4 GB against ~1 GFLOP.
// Design: one thread per output segment.  Because T = W*E, segment
// (n, w) starts at element (n*W + w)*E, so the flat output index alone
// locates it; a thread sums its E contiguous values in order.  A warp's
// 32 segments are one contiguous stretch of 32*E values, so the lines a
// warp touches are all used, through L1, over its E steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void paa_kernel(const T* __restrict__ x, float* __restrict__ out,
                           int64_t n_out, int64_t seg_len) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const T* src = x + i * seg_len;
  float acc = 0.f;
  for (int64_t e = 0; e < seg_len; ++e) acc += to_f32(src[e]);
  out[i] = acc / (float)seg_len;
}

}  // namespace

// n_out = N * W segments of seg_len = T / W values each.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_paa(const void* x, void* out, int64_t n_out,
                         int64_t seg_len, int dtype, void* stream) {
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks <= 0 || blocks > 0x7fffffff || seg_len <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    paa_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)x, (float*)out, n_out, seg_len);
  } else if (dtype == 1) {
    paa_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (float*)out, n_out, seg_len);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
