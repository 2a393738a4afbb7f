// K2: sSAX cell^2 sweep (Eq. 20, max form), Q queries in one launch.
//
// Replaces the Pallas kernel repro/kernels/ssax_dist.py::ssax_dist_pallas.
// For each query q:
//   c1, c2 = t1, t2[q, l, seas[n, l]]     (Q, L, A_seas) tables
//   d1, d2 = u1, u2[q, w, res[n, w]]      (Q, W, A_res) tables
//   out[q, n] = sum_{l, w} max(0, c1 + d1, c2 + d2)^2
// seas (N, L) and res (N, W) int32, tables f32, out (Q, N) f32, unscaled:
// the caller applies sqrt(T / (W*L)) and the square root.
//
// Bound: one query is about even between bytes ((L + W)*4 symbol bytes
// per row, 232 B at L=10, W=48) and FP32 issue (five instructions per
// cell: two FADDs, two FMNMXs, one FFMA; 480 cells a row).  Q queries
// read the symbols once and issue Q times, so a batch is bound by
// operations.
//
// Design:
//   * Persistent blocks walk tiles of R rows (128, or 64/32 for long
//     rows).  A tile's seas and res land densely in a staging buffer
//     through cp.async (16-byte copies where the arrays allow).  Once it
//     has landed, the block turns it into gather offsets l*A + clamp(s)
//     in a second buffer (clamped into the alphabet, so a
//     malformed symbol cannot read outside a table): once per row for
//     all queries.  The staging buffer is then free, and the next tile
//     loads into it while this one computes.  Offset rows keep odd
//     strides (L | 1, W | 1), so a thread reading its own row hits 32
//     distinct banks across a warp.
//   * The queries' tables sit in shared memory as float2 pairs (t1, t2)
//     and (u1, u2), so one 8-byte load fetches both terms of a symbol.
//     When all Q queries' tables fit beside the tile they are loaded
//     once per block; otherwise the queries go in groups that fit, each
//     group's tables loaded per tile while the tile stays in shared
//     memory (the symbols are still read from HBM once).  When not even
//     one query's tables fit, they are read through L1/L2.
//   * A block is R rows x P query slices: thread (slice p, row r) sweeps
//     row r for the group's queries p, p + P, ..., two at a time, each
//     with its own accumulator, so one query's FFMA chain overlaps the
//     other's.  The (L, W) cross never touches memory: a chunk of 16
//     residual terms per query sits in registers while the season terms
//     stream past it, the next season term loaded ahead.
//   * Every query's arithmetic is, in order, that of the one-query
//     kernel this replaces: w in chunks of 16, l outside, j inside, one
//     fmaf into the query's accumulator.  That kernel padded a ragged
//     last chunk with -inf, whose cell is max(0, -inf) = 0 and adds
//     exactly +0 to a sum that is never -0 or NaN (max(0, .) is never
//     NaN); here a last chunk of at most 8 terms runs 8 wide, the rest
//     padded the same way.  So out[q, n] is bitwise that kernel's, and
//     the same whatever batch, group or slice query q sits in.
//   * The ragged N edge is a tile with fewer rows; nothing is padded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 16;
constexpr int kMaxThreads = 512;
constexpr int kSmemMax = 232448;              // a block's opt-in maximum
constexpr int kTileRows[] = {128, 64, 32};    // rows per tile, preferred

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// n int32 from global src to shared dst, contiguous, by threads t of
// nthr; 16-byte copies when both ends allow it (dst always does).
__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* src,
                                           int n, int t, int nthr) {
  int head = 0;
  if (((uintptr_t)src & 15) == 0) {
    head = n & ~3;
    for (int i = 4 * t; i < head; i += 4 * nthr)
      cp_async16(dst + i, src + i);
  }
  for (int i = head + t; i < n; i += nthr) cp_async4(dst + i, src + i);
}

// One query's tables in shared memory, both terms of a symbol together.
struct SmemTabs {
  const float2* t;                  // (L, A_seas) pairs (t1, t2)
  const float2* u;                  // (W, A_res) pairs (u1, u2)
  __device__ float2 c(int off) const { return t[off]; }
  __device__ float2 d(int off) const { return u[off]; }
};

// One query's tables read through L1/L2 where shared memory cannot hold
// them.
struct GlobalTabs {
  const float *t1, *t2, *u1, *u2;
  __device__ float2 c(int off) const {
    return make_float2(__ldg(t1 + off), __ldg(t2 + off));
  }
  __device__ float2 d(int off) const {
    return make_float2(__ldg(u1 + off), __ldg(u2 + off));
  }
};

// One chunk of NJ residual terms (my_r[0..nj), nj <= NJ; the rest padded
// with -inf) against every season term, for KQ queries.
template <int KQ, int NJ, bool kFull, class Tabs>
__device__ __forceinline__ void sweep_chunk(const int32_t* my_s,
                                            const int32_t* my_r,
                                            const Tabs (&tab)[KQ],
                                            int l_len, int nj,
                                            float (&acc)[KQ]) {
  float2 d[KQ][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (kFull || j < nj) {
      const int a = my_r[j];
#pragma unroll
      for (int k = 0; k < KQ; ++k) d[k][j] = tab[k].d(a);
    } else {
#pragma unroll
      for (int k = 0; k < KQ; ++k)
        d[k][j] = make_float2(-INFINITY, -INFINITY);
    }
  }
  float2 next[KQ];
#pragma unroll
  for (int k = 0; k < KQ; ++k) next[k] = tab[k].c(my_s[0]);
  for (int l = 0; l < l_len; ++l) {
    float2 c[KQ];
#pragma unroll
    for (int k = 0; k < KQ; ++k) c[k] = next[k];
    if (l + 1 < l_len) {
      const int a = my_s[l + 1];
#pragma unroll
      for (int k = 0; k < KQ; ++k) next[k] = tab[k].c(a);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int k = 0; k < KQ; ++k) {
        const float cell =
            fmaxf(0.f, fmaxf(c[k].x + d[k][j].x, c[k].y + d[k][j].y));
        acc[k] = fmaf(cell, cell, acc[k]);
      }
    }
  }
}

// KQ queries over one row whose symbols are already gather offsets.
template <int KQ, class Tabs>
__device__ __forceinline__ void sweep_row(const int32_t* my_s,
                                          const int32_t* my_r,
                                          const Tabs (&tab)[KQ], int l_len,
                                          int w_len, float (&acc)[KQ]) {
#pragma unroll
  for (int k = 0; k < KQ; ++k) acc[k] = 0.f;
  int w0 = 0;
  for (; w0 + kChunk <= w_len; w0 += kChunk)
    sweep_chunk<KQ, kChunk, true>(my_s, my_r + w0, tab, l_len, kChunk, acc);
  const int rest = w_len - w0;
  if (rest > kChunk / 2)
    sweep_chunk<KQ, kChunk, false>(my_s, my_r + w0, tab, l_len, rest, acc);
  else if (rest > 0)
    sweep_chunk<KQ, kChunk / 2, false>(my_s, my_r + w0, tab, l_len, rest,
                                       acc);
}

// Shared memory of a group's tables, rounded up to keep the staging
// buffer behind them 16-byte aligned.
__host__ __device__ __forceinline__ int64_t tables_bytes(int64_t group,
                                                         int64_t per_q) {
  return (group * per_q * (int64_t)sizeof(float2) + 15) & ~(int64_t)15;
}

struct Params {
  const int32_t* seas;
  const int32_t* res;
  const float *t1, *t2, *u1, *u2;
  float* out;
  int64_t n_rows, n_tiles;
  int n_q, l_len, w_len, as_len, ar_len;
  int rows_per_tile, n_slices, group;   // R, P, queries per table group
};

template <bool kSmemTabs>
__global__ void __launch_bounds__(kMaxThreads)
    ssax_dist_batch_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, nthr = blockDim.x;
  const int R = p.rows_per_tile, P = p.n_slices;
  const int row = t % R, slice = t / R;
  const int L = p.l_len, W = p.w_len;
  const int ls = L | 1, ws = W | 1;
  const int nt = L * p.as_len, nu = W * p.ar_len, per_q = nt + nu;
  // [tables][staging: seas R x L, res R x W][offsets: R x ls, R x ws]
  float2* tabs = reinterpret_cast<float2*>(smem);
  int32_t* st_s = reinterpret_cast<int32_t*>(
      smem + (kSmemTabs ? tables_bytes(p.group, per_q) : 0));
  int32_t* st_r = st_s + R * L;
  int32_t* off_s = st_r + ((R * W + 3) & ~3);
  int32_t* off_r = off_s + R * ls;

  auto tile_rows = [&](int64_t tile) {
    const int64_t left = p.n_rows - tile * R;
    return left < R ? (int)left : R;
  };
  // Issue this thread's copies of a tile's symbols into the staging.
  auto stage = [&](int64_t tile) {
    const int rows = tile_rows(tile);
    copy_async(st_s, p.seas + tile * R * L, rows * L, t, nthr);
    copy_async(st_r, p.res + tile * R * W, rows * W, t, nthr);
    cp_async_commit();
  };
  // Staged rows -> offset rows.  Thread t owns term e = t % (L + W) of
  // rows t / (L + W), + rstep, ... (with fewer threads than terms, terms
  // t, t + nthr, ... of every row): no division per term, and a warp
  // reads and writes runs of consecutive words.
  auto to_offsets = [&](int rows) {
    const int terms = L + W;
    const bool wide = nthr >= terms;
    const int rstep = wide ? nthr / terms : 1;
    const int r0 = wide ? t / terms : 0;
    if (r0 >= rstep) return;
    for (int e = wide ? t % terms : t; e < terms; e += wide ? terms : nthr) {
      const bool is_s = e < L;
      const int c = is_s ? e : e - L;
      const int a_len = is_s ? p.as_len : p.ar_len;
      const int sstride = is_s ? L : W, dstride = is_s ? ls : ws;
      const int32_t* src = (is_s ? st_s : st_r) + c;
      int32_t* dst = (is_s ? off_s : off_r) + c;
      const int ca = c * a_len, hi = a_len - 1;
#pragma unroll 4
      for (int r = r0; r < rows; r += rstep)
        dst[r * dstride] = ca + min(max(src[r * sstride], 0), hi);
    }
  };
  // Queries [q0, q0 + gq) into shared memory as (t1, t2), (u1, u2) pairs.
  auto load_tabs = [&](int q0, int gq) {
    for (int k = 0; k < gq; ++k) {
      float2* dst = tabs + (size_t)k * per_q;
      const int64_t qt = (int64_t)(q0 + k) * nt;
      const int64_t qu = (int64_t)(q0 + k) * nu;
      for (int i = t; i < nt; i += nthr)
        dst[i] = make_float2(p.t1[qt + i], p.t2[qt + i]);
      for (int i = t; i < nu; i += nthr)
        dst[nt + i] = make_float2(p.u1[qu + i], p.u2[qu + i]);
    }
  };
  using Tabs = typename std::conditional<kSmemTabs, SmemTabs,
                                         GlobalTabs>::type;
  // The tables of query q (slot k of the group in shared memory).
  auto tab_of = [&](int q, int k) {
    Tabs x;
    if constexpr (kSmemTabs) {
      x.t = tabs + (size_t)k * per_q;
      x.u = x.t + nt;
    } else {
      x.t1 = p.t1 + (int64_t)q * nt;
      x.t2 = p.t2 + (int64_t)q * nt;
      x.u1 = p.u1 + (int64_t)q * nu;
      x.u2 = p.u2 + (int64_t)q * nu;
    }
    (void)k;
    return x;
  };

  const bool one_group = p.group >= p.n_q;
  if (kSmemTabs && one_group) load_tabs(0, p.n_q);   // once per block
  int64_t tile = blockIdx.x;
  if (tile < p.n_tiles) stage(tile);
  const int32_t* my_s = off_s + row * ls;
  const int32_t* my_r = off_r + row * ws;
  for (; tile < p.n_tiles; tile += gridDim.x) {
    const int rows = tile_rows(tile);
    cp_async_wait_all();                 // this thread's copies are in
    __syncthreads();                     // everyone's; offsets are free
    to_offsets(rows);
    __syncthreads();                     // offsets ready; staging free
    const int64_t next = tile + gridDim.x;
    if (next < p.n_tiles) stage(next);   // loads while this tile computes
    float* out = p.out + tile * R + row;
    for (int g0 = 0; g0 < p.n_q; g0 += p.group) {
      const int gq = min(p.group, p.n_q - g0);
      if (kSmemTabs && !one_group) {
        if (g0) __syncthreads();         // the last group is done
        load_tabs(g0, gq);
        __syncthreads();
      }
      if (row >= rows) continue;
      int k = slice;
      for (; k + P < gq; k += 2 * P) {
        const Tabs tb[2] = {tab_of(g0 + k, k), tab_of(g0 + k + P, k + P)};
        float acc[2];
        sweep_row<2>(my_s, my_r, tb, L, W, acc);
        out[(int64_t)(g0 + k) * p.n_rows] = acc[0];
        out[(int64_t)(g0 + k + P) * p.n_rows] = acc[1];
      }
      if (k < gq) {
        const Tabs tb[1] = {tab_of(g0 + k, k)};
        float acc[1];
        sweep_row<1>(my_s, my_r, tb, L, W, acc);
        out[(int64_t)(g0 + k) * p.n_rows] = acc[0];
      }
    }
  }
}

template <bool kSmemTabs>
int launch(const Params& p, int threads, int smem, cudaStream_t s) {
  auto* kern = ssax_dist_batch_kernel<kSmemTabs>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t resident = (int64_t)per_sm * sms;
  const int64_t blocks = p.n_tiles < resident ? p.n_tiles : resident;
  kern<<<(unsigned)blocks, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

int ssax_dist_launch(const void* seas, const void* res, const void* t1,
                     const void* t2, const void* u1, const void* u2,
                     void* out, int64_t n_rows, int n_q, int l_len,
                     int w_len, int as_len, int ar_len, cudaStream_t s) {
  if (n_rows <= 0 || n_q <= 0 || l_len <= 0 || w_len <= 0 ||
      as_len <= 0 || ar_len <= 0)
    return (int)cudaErrorInvalidValue;
  // staging (L + W words, the res part rounded up to 16 bytes) and
  // offsets (L | 1 + W | 1 words) per row
  const int64_t per_q = (int64_t)l_len * as_len + (int64_t)w_len * ar_len;
  const int64_t q_bytes = per_q * (int64_t)sizeof(float2);
  auto tile_bytes = [&](int64_t r) {
    return 4 * (r * l_len + ((r * w_len + 3) & ~3) +
                r * ((l_len | 1) + (w_len | 1)));
  };
  // Rows per tile: the largest whose buffers leave room for one query's
  // tables; failing that, the largest whose buffers fit, with the tables
  // read through L1/L2.
  int R = 0;
  bool in_smem = false;
  for (int r : kTileRows) {
    if (tile_bytes(r) + q_bytes <= kSmemMax) {
      R = r;
      in_smem = true;
      break;
    }
  }
  if (!R) {
    for (int r : kTileRows)
      if (tile_bytes(r) <= kSmemMax) {
        R = r;
        break;
      }
  }
  if (!R || (int64_t)l_len * as_len > 0x7fffffff / 2 ||
      (int64_t)w_len * ar_len > 0x7fffffff / 2)
    return (int)cudaErrorInvalidValue;
  // Queries per table group: all of them, or as many as fit, spread
  // evenly over the fewest groups.
  int group = n_q;
  if (in_smem) {
    const int64_t fit = (kSmemMax - tile_bytes(R)) / q_bytes;
    const int64_t n_groups = (n_q + fit - 1) / fit;
    group = (int)((n_q + n_groups - 1) / n_groups);
  }
  const int slices = group < kMaxThreads / R ? group : kMaxThreads / R;
  Params p{(const int32_t*)seas, (const int32_t*)res, (const float*)t1,
           (const float*)t2,     (const float*)u1,    (const float*)u2,
           (float*)out,          n_rows,              (n_rows + R - 1) / R,
           n_q,                  l_len,               w_len,
           as_len,               ar_len,              R,
           slices,               group};
  const int threads = R * slices;
  if (in_smem)
    return launch<true>(
        p, threads, (int)(tile_bytes(R) + tables_bytes(group, per_q)), s);
  return launch<false>(p, threads, (int)tile_bytes(R), s);
}

}  // namespace

// Q queries: t1, t2 (Q, L, A_seas), u1, u2 (Q, W, A_res), out (Q, N).
// Returns the cudaError_t of the launch.
extern "C" int repro_ssax_dist_batch(const void* seas, const void* res,
                                     const void* t1, const void* t2,
                                     const void* u1, const void* u2,
                                     void* out, int64_t n_rows, int n_q,
                                     int l_len, int w_len, int as_len,
                                     int ar_len, void* stream) {
  return ssax_dist_launch(seas, res, t1, t2, u1, u2, out, n_rows, n_q,
                          l_len, w_len, as_len, ar_len,
                          (cudaStream_t)stream);
}

// One query: t1, t2 (L, A_seas), u1, u2 (W, A_res), out (N,); Q = 1 of
// the same kernel.
extern "C" int repro_ssax_dist(const void* seas, const void* res,
                               const void* t1, const void* t2,
                               const void* u1, const void* u2, void* out,
                               int64_t n_rows, int l_len, int w_len,
                               int as_len, int ar_len, void* stream) {
  return ssax_dist_launch(seas, res, t1, t2, u1, u2, out, n_rows, 1, l_len,
                          w_len, as_len, ar_len, (cudaStream_t)stream);
}
