// K2: sSAX cell^2 sweep (Eq. 20, max form).
//
// Replaces the Pallas kernel repro/kernels/ssax_dist.py::ssax_dist_pallas.
//   c1, c2 = t1, t2[l, seas[n, l]]     (L, A_seas) tables
//   d1, d2 = u1, u2[w, res[n, w]]      (W, A_res) tables
//   out[n] = sum_{l, w} max(0, c1 + d1, c2 + d2)^2
// seas (N, L) and res (N, W) int32, tables f32, out (N,) f32, unscaled:
// the caller applies sqrt(T / (W*L)) and the square root.
//
// Bound: bytes at the sweep's shapes.  (L + W)*4 symbol bytes per
// candidate (232 B at L=10, W=48) against 5*L*W = 2,400 flops; the f32
// rate would allow ~28 flops/byte, so HBM stays the limit, just.
// Design: one thread owns one candidate row.  A block stages its 128 rows
// of both symbol arrays through shared memory with coalesced loads (odd
// row strides, so the per-thread reads are free of bank conflicts), and
// keeps the four query tables in shared memory when they fit the budget
// (13.6 KB at the sweep's shapes), else reads them through L2.  The
// (L, W) cross never touches memory: a chunk of 16 residual terms sits in
// registers while the season terms stream past it.  A ragged chunk pads
// with -inf, whose cell is max(0, -inf) = 0, and the ragged N edge is a
// thread that has no row.  Symbols are clamped into their alphabets
// before the gather, so a malformed symbol cannot read outside a table.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;
constexpr int kChunk = 16;
constexpr int kSmemTableBudget = 100 * 1024;  // keeps two blocks per SM
constexpr int kSmemMax = 232448;              // a block's opt-in maximum

template <bool kTablesInSmem>
__global__ void ssax_dist_kernel(
    const int32_t* __restrict__ seas, const int32_t* __restrict__ res,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const float* __restrict__ u1, const float* __restrict__ u2,
    float* __restrict__ out, int64_t n_rows, int l_len, int w_len,
    int as_len, int ar_len) {
  extern __shared__ int32_t smem[];
  const int ls = l_len | 1, ws = w_len | 1;
  int32_t* s_seas = smem;
  int32_t* s_res = s_seas + kRows * ls;
  const float *T1 = t1, *T2 = t2, *U1 = u1, *U2 = u2;
  if (kTablesInSmem) {
    const int nt = l_len * as_len, nu = w_len * ar_len;
    float* tabs = reinterpret_cast<float*>(s_res + kRows * ws);
    for (int i = threadIdx.x; i < nt; i += kRows) {
      tabs[i] = t1[i];
      tabs[nt + i] = t2[i];
    }
    for (int i = threadIdx.x; i < nu; i += kRows) {
      tabs[2 * nt + i] = u1[i];
      tabs[2 * nt + nu + i] = u2[i];
    }
    T1 = tabs;
    T2 = tabs + nt;
    U1 = tabs + 2 * nt;
    U2 = tabs + 2 * nt + nu;
  }
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int rows =
      n_rows - row0 < kRows ? (int)(n_rows - row0) : kRows;
  const int32_t* src_s = seas + row0 * l_len;
  for (int i = threadIdx.x; i < rows * l_len; i += kRows) {
    const int r = i / l_len;
    s_seas[r * ls + (i - r * l_len)] = src_s[i];
  }
  const int32_t* src_r = res + row0 * w_len;
  for (int i = threadIdx.x; i < rows * w_len; i += kRows) {
    const int r = i / w_len;
    s_res[r * ws + (i - r * w_len)] = src_r[i];
  }
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const int32_t* my_s = s_seas + threadIdx.x * ls;
  const int32_t* my_r = s_res + threadIdx.x * ws;
  float acc = 0.f;
  for (int w0 = 0; w0 < w_len; w0 += kChunk) {
    float d1[kChunk], d2[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int w = w0 + j;
      if (w < w_len) {
        const int a = w * ar_len + min(max(my_r[w], 0), ar_len - 1);
        d1[j] = U1[a];
        d2[j] = U2[a];
      } else {
        d1[j] = -INFINITY;
        d2[j] = -INFINITY;
      }
    }
    for (int l = 0; l < l_len; ++l) {
      const int a = l * as_len + min(max(my_s[l], 0), as_len - 1);
      const float c1 = T1[a], c2 = T2[a];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float cell = fmaxf(0.f, fmaxf(c1 + d1[j], c2 + d2[j]));
        acc = fmaf(cell, cell, acc);
      }
    }
  }
  out[row0 + threadIdx.x] = acc;
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int repro_ssax_dist(const void* seas, const void* res,
                               const void* t1, const void* t2,
                               const void* u1, const void* u2, void* out,
                               int64_t n_rows, int l_len, int w_len,
                               int as_len, int ar_len, void* stream) {
  const int64_t blocks = (n_rows + kRows - 1) / kRows;
  const int64_t stage =
      (int64_t)kRows * ((l_len | 1) + (w_len | 1)) * 4;
  const int64_t tabs =
      2 * ((int64_t)l_len * as_len + (int64_t)w_len * ar_len) * 4;
  if (blocks <= 0 || blocks > 0x7fffffff || l_len <= 0 || w_len <= 0 ||
      as_len <= 0 || ar_len <= 0 || stage > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool in_smem = stage + tabs <= kSmemTableBudget;
  const int smem = (int)(in_smem ? stage + tabs : stage);
  if (in_smem) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(ssax_dist_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ssax_dist_kernel<true><<<(unsigned)blocks, kRows, smem, s>>>(
        (const int32_t*)seas, (const int32_t*)res, (const float*)t1,
        (const float*)t2, (const float*)u1, (const float*)u2, (float*)out,
        n_rows, l_len, w_len, as_len, ar_len);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(ssax_dist_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ssax_dist_kernel<false><<<(unsigned)blocks, kRows, smem, s>>>(
        (const int32_t*)seas, (const int32_t*)res, (const float*)t1,
        (const float*)t2, (const float*)u1, (const float*)u2, (float*)out,
        n_rows, l_len, w_len, as_len, ar_len);
  }
  return (int)cudaGetLastError();
}
