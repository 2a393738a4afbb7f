// K5: z-normalized windowed squared distance (the distance profile).
//
// Replaces the Pallas kernel
// repro/kernels/windowed_euclid.py::windowed_euclid_pallas.
//   out[q, n, s] = sum_i ((x[n, s*stride + i] - mu) / sig - q[q, i])^2,
//   mu, sig the mean and population std of the window, sig clamped at
//   EPS = 1e-12 (as core/normalize.py::znormalize), x (N, T) f32, q (Q, m)
//   f32 z-normalized, out (Q, N, S) f32, S = (T - m) / stride + 1.
//   A window whose variance is not > 0 gives exactly sum_i q[q, i]^2; the
//   result is clamped at 0.
//
// Bound: operations.  Counting the TPU kernel's work (2m flops per
// (query, window) for the sliding dot, x and q read once, the output
// written once), the scan shape (Q = 8, 2048 x 3600, m = 240, stride 4)
// is 6.61 GFLOP against 84.6 MB: 0.0987 ms at 67 TFLOP/s f32 against
// 0.0253 ms at 3.35 TB/s.
//
// Design: one block per (row, tile of window starts), one thread per
// window start.  The block stages the row's slab of (tile-1)*stride + m
// samples in shared memory once and loops over all Q queries, which it
// stages eight at a time, transposed so that one thread reads the eight
// queries' i-th values as two 16-byte broadcasts; the row is read from
// HBM once for all queries.  Each window's statistics are computed once
// and shared by all queries, in two passes (the mean of the samples less
// the window's first sample, then the sum of squared deviations): the
// TPU kernel's one-pass var = s2/m - mu^2 cancels when a window's mean is
// large against its spread.  Each (query, window) distance is the direct
// sum of ((x - mu) * (1/sig) - q)^2 with fmaf, which does not cancel
// either.  Ragged tails (the last tile, T not a multiple of stride, one
// window per row when T == m) are masked here; the input is not padded.
// The output is indexed with int64.  No tensor cores: a later PR can
// recast the sliding dot as a Hankel-times-queries product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kQReg = 8;               // queries held in registers at once
constexpr int kMaxSmem = 232448;       // a block's shared memory on sm_90

__global__ void windowed_euclid_kernel(const float* __restrict__ x,
                                       const float* __restrict__ q,
                                       float* __restrict__ out,
                                       int64_t n_rows, int64_t t_len,
                                       int64_t n_q, int m, int stride,
                                       int64_t n_win, int64_t n_tiles,
                                       int slab_len) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // (m, kQReg) transposed chunk
  float* q_ss = qs + (int64_t)kQReg * m; // (kQReg,) sum of squares
  float* slab = q_ss + kQReg;            // (slab_len,) row samples
  const int tile = blockDim.x;
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t s0 = (blockIdx.x % n_tiles) * tile;
  const int64_t t0 = s0 * stride;
  const float* xr = x + row * t_len;

  const int64_t avail = t_len - t0 < slab_len ? t_len - t0 : slab_len;
  for (int64_t i = threadIdx.x; i < avail; i += tile) slab[i] = xr[t0 + i];
  __syncthreads();

  const int64_t s = s0 + threadIdx.x;
  const bool valid = s < n_win;
  const float* w = slab + (int64_t)threadIdx.x * stride;
  float mu = 0.f, var = 0.f, inv = 0.f;
  if (valid) {
    const float shift = w[0];
    float s1 = 0.f;
    for (int i = 0; i < m; ++i) s1 += w[i] - shift;
    mu = shift + s1 / (float)m;
    float s2 = 0.f;
    for (int i = 0; i < m; ++i) {
      const float d = w[i] - mu;
      s2 = fmaf(d, d, s2);
    }
    var = s2 / (float)m;
    inv = 1.f / fmaxf(sqrtf(var), kEps);
  }

  for (int64_t g = 0; g < n_q; g += kQReg) {
    __syncthreads();                     // the previous chunk is read
    for (int64_t k = threadIdx.x; k < (int64_t)kQReg * m; k += tile) {
      const int64_t i = k / kQReg, j = k % kQReg;
      qs[k] = g + j < n_q ? q[(g + j) * m + i] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < kQReg) {
      float ss = 0.f;
      for (int i = 0; i < m; ++i) {
        const float v = qs[i * kQReg + threadIdx.x];
        ss = fmaf(v, v, ss);
      }
      q_ss[threadIdx.x] = ss;
    }
    __syncthreads();
    if (!valid) continue;
    float acc[kQReg];
#pragma unroll
    for (int j = 0; j < kQReg; ++j) acc[j] = 0.f;
    for (int i = 0; i < m; ++i) {
      const float z = (w[i] - mu) * inv;
      const float4 a = *reinterpret_cast<const float4*>(qs + i * kQReg);
      const float4 b = *reinterpret_cast<const float4*>(qs + i * kQReg + 4);
      const float qv[kQReg] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < kQReg; ++j) {
        const float d = z - qv[j];
        acc[j] = fmaf(d, d, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQReg; ++j) {
      if (g + j < n_q)
        out[((g + j) * n_rows + row) * n_win + s] =
            var > 0.f ? fmaxf(acc[j], 0.f) : q_ss[j];
    }
  }
}

// Shared bytes for a tile of `tile` window starts.
int64_t smem_bytes(int tile, int m, int stride) {
  const int64_t slab = (int64_t)(tile - 1) * stride + m;
  return ((int64_t)kQReg * m + kQReg + slab) * (int64_t)sizeof(float);
}

}  // namespace

// x (n_rows, t_len) f32, q (n_q, m) f32, out (n_q, n_rows, S) f32, all
// contiguous.  Returns the cudaError_t of the launch.
extern "C" int repro_windowed_euclid(const void* x, const void* q, void* out,
                                     int64_t n_rows, int64_t t_len,
                                     int64_t n_q, int m, int stride,
                                     void* stream) {
  if (m <= 0 || stride <= 0 || m > t_len || n_rows <= 0 || n_q <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_win = (t_len - m) / stride + 1;
  // the widest tile whose slab fits a block's shared memory; a tile
  // narrower than one warp is not worth a launch
  int tile = 128;
  while (tile > 32 && smem_bytes(tile, m, stride) > kMaxSmem) tile /= 2;
  const int64_t bytes = smem_bytes(tile, m, stride);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (n_win + tile - 1) / tile;
  const int64_t blocks = n_rows * n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowed_euclid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int slab_len = (int)((int64_t)(tile - 1) * stride + m);
  windowed_euclid_kernel<<<(unsigned)blocks, tile, (size_t)bytes,
                           (cudaStream_t)stream>>>(
      (const float*)x, (const float*)q, (float*)out, n_rows, t_len, n_q, m,
      stride, n_win, n_tiles, slab_len);
  return (int)cudaGetLastError();
}
