// K3: SAX MINDIST^2 sweep.
//
// Replaces the Pallas kernel repro/kernels/sax_dist.py::sax_dist_pallas.
//   out[n] = sum_w table[w, sym[n, w]],  sym (N, W) int32,
//   table (W, A) f32 (the query's squared cell distances), out (N,) f32,
//   unscaled: the caller applies sqrt(T/W) and the square root.
//
// Bound: bytes.  W*4 symbol bytes are read per candidate (192 B at
// W=48) against W adds.  The TPU formulation was a one-hot contraction
// on the matrix unit; here it is a plain gather from a table kept on
// chip.  One thread owns one candidate row.  A block stages its 128 rows
// of symbols through shared memory with coalesced loads (row stride
// padded to an odd word count, so the per-thread reads are free of bank
// conflicts) and keeps the table in shared memory when it fits the
// budget below.  A larger table (W*A*4 is 384 KB at W=96, A=1024, beyond
// a block's 227 KB) is read through L2 instead, so no shape is refused
// for its table.  Symbols are clamped into [0, A) before the gather, so a
// malformed symbol cannot read outside the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;
constexpr int kSmemTableBudget = 100 * 1024;  // keeps two blocks per SM
constexpr int kSmemMax = 232448;              // a block's opt-in maximum

template <bool kTableInSmem>
__global__ void sax_dist_kernel(const int32_t* __restrict__ sym,
                                const float* __restrict__ table,
                                float* __restrict__ out, int64_t n_rows,
                                int w_len, int a_len) {
  extern __shared__ int32_t smem[];
  const int stride = w_len | 1;
  int32_t* s_sym = smem;
  const float* tab = table;
  if (kTableInSmem) {
    float* s_tab = reinterpret_cast<float*>(smem + kRows * stride);
    for (int i = threadIdx.x; i < w_len * a_len; i += kRows)
      s_tab[i] = table[i];
    tab = s_tab;
  }
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int rows =
      n_rows - row0 < kRows ? (int)(n_rows - row0) : kRows;
  const int32_t* src = sym + row0 * w_len;
  for (int i = threadIdx.x; i < rows * w_len; i += kRows) {
    const int r = i / w_len;
    s_sym[r * stride + (i - r * w_len)] = src[i];
  }
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;
  const int32_t* mine = s_sym + threadIdx.x * stride;
  float acc = 0.f;
  for (int w = 0; w < w_len; ++w) {
    const int a = min(max(mine[w], 0), a_len - 1);
    acc += tab[w * a_len + a];
  }
  out[row0 + threadIdx.x] = acc;
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int repro_sax_dist(const void* sym, const void* table, void* out,
                              int64_t n_rows, int w_len, int a_len,
                              void* stream) {
  const int64_t blocks = (n_rows + kRows - 1) / kRows;
  const int64_t stage = (int64_t)kRows * (w_len | 1) * 4;
  const int64_t tab = (int64_t)w_len * a_len * 4;
  if (blocks <= 0 || blocks > 0x7fffffff || w_len <= 0 || a_len <= 0 ||
      stage > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool in_smem = stage + tab <= kSmemTableBudget;
  const int smem = (int)(in_smem ? stage + tab : stage);
  if (in_smem) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(sax_dist_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    sax_dist_kernel<true><<<(unsigned)blocks, kRows, smem, s>>>(
        (const int32_t*)sym, (const float*)table, (float*)out, n_rows, w_len,
        a_len);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(sax_dist_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    sax_dist_kernel<false><<<(unsigned)blocks, kRows, smem, s>>>(
        (const int32_t*)sym, (const float*)table, (float*)out, n_rows, w_len,
        a_len);
  }
  return (int)cudaGetLastError();
}
