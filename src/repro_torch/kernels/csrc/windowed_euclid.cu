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
// 0.0253 ms at 3.35 TB/s.  The direct form below costs two FP
// instructions per (query, window, sample), which floors it near 0.2 ms.
//
// Design: one block per (row, tile of window starts).  The block stages
// the row's slab in shared memory once, de-interleaved by stride phase:
// sample j of the slab sits at [j % stride][j / stride], each phase row
// padded to a 16-byte multiple.  Sample i of window w is then at
// [i % stride][w + i / stride], so the 32 lanes of a warp, which own 32
// consecutive windows, read 32 consecutive words at any stride: no bank
// conflicts in the statistics passes or the query loop (a row-major slab
// read at lane * stride conflicts stride ways).  The slab is staged with
// 4-byte cp.async copies.  Each thread owns R windows (a warp owns R
// runs of 32 consecutive windows), so one pair of 16-byte query
// broadcasts feeds R x 8 distances.  R is 4 where that still gives two
// blocks per SM, else 1, with the block width chosen the same way: on
// the H100 R = 4 takes 14 % less time than R = 1 over a 2,048-row scan,
// while a 38-row scan at R = 4 would have at most 76 blocks for the 132
// SMs.
// Queries are staged eight at a time, phase-major like the slab; the
// row is read from HBM once for all queries.  Each window's statistics
// are computed once and shared by all queries, in two passes (the mean
// of the samples less the window's first sample, then the sum of squared
// deviations): the TPU kernel's one-pass var = s2/m - mu^2 cancels when
// a window's mean is large against its spread.  Each (query, window)
// distance is the direct sum of ((x - mu) * (1/sig) - q)^2 with fmaf,
// which does not cancel either.  Samples are visited phase by phase, so
// a window's sums run in an order fixed by m and the stride alone.
// Ragged tails (the last tile, T not a multiple of stride, one window
// per row when T == m) are masked here; the input is not padded.  The
// output is indexed with int64.  No tensor cores: a Hankel-times-queries
// product needs the dot-product expansion, which cancels near zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kQReg = 8;               // queries held in registers at once
constexpr int kMaxSmem = 232448;       // a block's shared memory on sm_90
constexpr int64_t kTargetBlocks = 2 * 132;   // two blocks per H100 SM

struct Geometry {
  int n_phase;   // phase rows staged: min(stride, m)
  int qc;        // query columns per phase: ceil(m / stride)
  int cols;      // slab columns per phase: tile + (m - 1) / stride
  int pitch;     // cols padded to a multiple of 4 words
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

// Samples i < m with i % stride == p.
__device__ __forceinline__ int phase_len(int p, int m, int stride) {
  return (m - p + stride - 1) / stride;
}

// Stage query chunk g (kQReg queries from g on, zeros past n_q) into qs,
// phase-major: sample i of query j at qs[((i % stride) * qc + i / stride)
// * kQReg + j], with 4-byte cp.async copies (the caller commits).
__device__ __forceinline__ void stage_queries(float* qs,
                                              const float* __restrict__ q,
                                              int64_t g, int64_t n_q, int m,
                                              int stride, int qc) {
  for (int k = threadIdx.x; k < kQReg * m; k += blockDim.x) {
    const int j = k / m, i = k % m;
    float* dst = qs + ((i % stride) * qc + i / stride) * kQReg + j;
    if (g + j < n_q)
      cp_async4(dst, q + (g + j) * m + i);
    else
      *dst = 0.f;
  }
}

template <int R>
__global__ void __launch_bounds__(256)
    windowed_euclid_kernel(const float* __restrict__ x,
                           const float* __restrict__ q,
                           float* __restrict__ out, int64_t n_rows,
                           int64_t t_len, int64_t n_q, int m, int stride,
                           int64_t n_win, int64_t n_tiles, Geometry geo) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // (n_phase, qc, 8)
  float* q_ss = qs + (int64_t)geo.n_phase * geo.qc * kQReg;  // (8,)
  float* slab = q_ss + kQReg;                        // (n_phase, pitch)
  const int nt = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t s0 = (blockIdx.x % n_tiles) * (int64_t)(nt * R);
  const int64_t t0 = s0 * stride;
  const float* xr = x + row * t_len;

  // the slab, phase-major (past the row's end it holds zeros), and the
  // first query chunk, both in flight together
  const int n_stage = geo.n_phase * geo.cols;
  for (int k = threadIdx.x; k < n_stage; k += nt) {
    const int p = k / geo.cols, c = k % geo.cols;
    const int64_t t = t0 + p + (int64_t)c * stride;
    float* dst = slab + p * geo.pitch + c;
    if (t < t_len)
      cp_async4(dst, xr + t);
    else
      *dst = 0.f;
  }
  stage_queries(qs, q, 0, n_q, m, stride, geo.qc);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // Window r of this thread is local window (warp * R + r) * 32 + lane:
  // each warp owns R runs of 32 consecutive windows, so for every sample
  // the lanes read 32 consecutive words, at fixed offsets r * 32.
  const float* xw = slab + warp * 32 * R + lane;
  float mu[R], inv[R];
  bool live[R];
  {  // per-window statistics, two passes, shared by all queries
    float shift[R], s1[R], s2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      shift[r] = xw[r * 32];
      s1[r] = 0.f;
      s2[r] = 0.f;
    }
    for (int p = 0; p < geo.n_phase; ++p) {
      const float* xp = xw + p * geo.pitch;
      const int n_c = phase_len(p, m, stride);
#pragma unroll 4
      for (int c = 0; c < n_c; ++c) {
#pragma unroll
        for (int r = 0; r < R; ++r) s1[r] += xp[c + r * 32] - shift[r];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) mu[r] = shift[r] + s1[r] / (float)m;
    for (int p = 0; p < geo.n_phase; ++p) {
      const float* xp = xw + p * geo.pitch;
      const int n_c = phase_len(p, m, stride);
#pragma unroll 4
      for (int c = 0; c < n_c; ++c) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d = xp[c + r * 32] - mu[r];
          s2[r] = fmaf(d, d, s2[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float var = s2[r] / (float)m;
      live[r] = var > 0.f;
      inv[r] = 1.f / fmaxf(sqrtf(var), kEps);
    }
  }

  for (int64_t g = 0; g < n_q; g += kQReg) {
    if (g > 0) {                         // chunk 0 was staged above
      __syncthreads();                   // the previous chunk is read
      stage_queries(qs, q, g, n_q, m, stride, geo.qc);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
    }
    // sum of squares of each staged query, one warp per query
    for (int j = warp; j < kQReg; j += nt / 32) {
      float ss = 0.f;
      for (int i = lane; i < m; i += 32) {
        const float v = qs[((i % stride) * geo.qc + i / stride) * kQReg + j];
        ss = fmaf(v, v, ss);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (lane == 0) q_ss[j] = ss;
    }
    __syncthreads();

    float acc[R][kQReg];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kQReg; ++j) acc[r][j] = 0.f;
    for (int p = 0; p < geo.n_phase; ++p) {
      const float* xp = xw + p * geo.pitch;
      const float* qp = qs + p * geo.qc * kQReg;
      const int n_c = phase_len(p, m, stride);
#pragma unroll 2
      for (int c = 0; c < n_c; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(qp + c * kQReg);
        const float4 b =
            *reinterpret_cast<const float4*>(qp + c * kQReg + 4);
        const float qv[kQReg] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float z = (xp[c + r * 32] - mu[r]) * inv[r];
#pragma unroll
          for (int j = 0; j < kQReg; ++j) {
            const float d = z - qv[j];
            acc[r][j] = fmaf(d, d, acc[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t s = s0 + (warp * R + r) * 32 + lane;
      if (s >= n_win) continue;
#pragma unroll
      for (int j = 0; j < kQReg; ++j) {
        if (g + j < n_q)
          out[((g + j) * n_rows + row) * n_win + s] =
              live[r] ? fmaxf(acc[r][j], 0.f) : q_ss[j];
      }
    }
  }
}

Geometry geometry(int tile, int m, int stride) {
  Geometry g;
  g.n_phase = stride < m ? stride : m;
  g.qc = (m + stride - 1) / stride;
  g.cols = tile + (m - 1) / stride;
  g.pitch = (g.cols + 3) / 4 * 4;
  return g;
}

int64_t smem_bytes(const Geometry& g) {
  return ((int64_t)g.n_phase * g.qc * kQReg + kQReg +
          (int64_t)g.n_phase * g.pitch) *
         (int64_t)sizeof(float);
}

template <int R>
int launch_r(const float* x, const float* q, float* out, int64_t n_rows,
             int64_t t_len, int64_t n_q, int m, int stride, int64_t n_win,
             int warps, int64_t n_tiles, cudaStream_t s) {
  const Geometry geo = geometry(warps * 32 * R, m, stride);
  const int64_t bytes = smem_bytes(geo);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowed_euclid_kernel<R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  windowed_euclid_kernel<R><<<(unsigned)(n_rows * n_tiles), warps * 32,
                              (size_t)bytes, s>>>(
      x, q, out, n_rows, t_len, n_q, m, stride, n_win, n_tiles, geo);
  return (int)cudaGetLastError();
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
  // (windows per thread, warps per block at most), most register reuse
  // first; the first that gives two blocks per SM and fits shared memory
  // wins, else the one with the most blocks
  static const int kChoices[][2] = {{4, 8}, {4, 4}, {1, 8},
                                    {1, 4}, {1, 2}, {1, 1}};
  constexpr int kNumChoices = sizeof(kChoices) / sizeof(kChoices[0]);
  int best = -1, warps = 0;
  int64_t n_tiles = 0, best_blocks = 0;
  for (int k = 0; k < kNumChoices; ++k) {
    const int r = kChoices[k][0], w_max = kChoices[k][1];
    const int64_t warps_row = (n_win + 32 * r - 1) / (32 * r);
    const int64_t tiles = (warps_row + w_max - 1) / w_max;
    const int w = (int)((warps_row + tiles - 1) / tiles);
    if (smem_bytes(geometry(w * 32 * r, m, stride)) > kMaxSmem) continue;
    const int64_t blocks = n_rows * tiles;
    if (best < 0 || blocks > best_blocks) {
      best = k, warps = w, n_tiles = tiles, best_blocks = blocks;
    }
    if (blocks >= kTargetBlocks) break;
  }
  if (best < 0 || best_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* qf = (const float*)q;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return kChoices[best][0] == 4
             ? launch_r<4>(xf, qf, of, n_rows, t_len, n_q, m, stride, n_win,
                           warps, n_tiles, s)
             : launch_r<1>(xf, qf, of, n_rows, t_len, n_q, m, stride, n_win,
                           warps, n_tiles, s);
}
