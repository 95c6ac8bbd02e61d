// Fused SMA-crossover sweep for Hopper (sm_90a): K1 of the port, and K6,
// the OBV-trend sweep, which forms its SMA from a cumsum row too.
//
// Replaces the TPU kernel of the reference package,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_fused_call` with
// its `_kernel_inline` body (and the `_kernel` HBM-table body, which
// computes the same function). For every (ticker, combo) lane it computes
// the 9 backtest metrics of an SMA crossover in one pass over the bars and
// writes only those 9 floats.
//
// Design.
// - Each window's SMA formed once per (ticker, window, bar) and shared. The
//   TPU kernel builds a (windows x bars) SMA table per ticker in VMEM and
//   selects each lane's fast-minus-slow row with a +-1 one-hot matmul. That
//   table (606 KB at the headline) does not fit in a block's shared memory,
//   so one CTA covers one ticker x one tile of lanes and forms the SMAs of
//   the tile's distinct fast and slow windows (one list, built by torch ops
//   before the launch with each lane's two indices into it) a block of bars
//   at a time in shared memory (bar_blocks.cuh), with the table's exact op
//   sequence: (cs[t] - cs[t-w]) / float(w), cs[t-w] = 0 for t < w, and 0 for
//   t < w - 1. Each lane then reads its two values, and d = sma_fast -
//   sma_slow equals the one-hot contraction (two nonzero terms, one
//   rounding). The bench grid's 1024-lane tiles read about 110 windows.
// - Inputs: the cumsum and the simple returns of the closes, (N, T) each,
//   computed by plain torch ops before the launch (the reference leaves them
//   to XLA). cs is read once per (window, bar) through L1; the block's
//   returns are staged beside the values.
// - One sequential pass per thread over t < t_real[ticker] carries the
//   position and the metric sums (metrics_tail.cuh, shared with every
//   kernel). It replaces both the "scan" and the "ladder" epilogues of the
//   TPU kernel. Bars at or past t_real contribute nothing, which equals the
//   reference holding the last position through repeat-last padding.
// - Output: (9, N, P) f32 in the reference's `_metrics_pack` order and
//   formulas. The wrapper allocates it; the kernel allocates nothing.
//
// What bounds it: fp32 arithmetic outside the tensor cores. Per (combo,
// bar) a lane does the difference and its sign and the 20 operations of
// the metric update, one an IEEE division; the SMA's sub and IEEE
// division run once per (window, bar) of the tile, about 1/9 of a lane's
// share at the headline. Bytes are negligible: two input rows per ticker
// and 36 MB of output for the headline 500 x 2000 sweep.
//
// K6 (dbx_obv) replaces the reference's `_fused_obv_call` with its bodies
// `_obv_kernel_inline` (SMA-of-OBV table built in VMEM from the OBV cumsum
// row by the SMA kernel's own table code) and `_obv_kernel` (the same
// table streamed from HBM), which share `_obv_signal_tail`. Here one CTA
// per ticker x 128 combos stages three rows (the normalized OBV, its cumsum
// and the simple returns, 3 x 1260 x 4 B = 15 KB at the bench shape), and
// each thread forms its window's SMA of the OBV per bar with `sma_at`, then
// pos = sign(obv[t] - sma) from bar window - 1. No table and no one-hot
// (its single nonzero term per lane is a copy). Bound by fp32 operations:
// 24 a (combo, bar) with one IEEE division, of which the SMA's sub and div
// could be formed once per window and bar and shared, as K1 does.
//
// Built without fast math and with -fmad=false: the SMA division and sqrtf
// stay IEEE round-to-nearest, so table values equal the reference's, and no
// multiply-add is contracted, so the epilogue rounds as the plain PyTorch
// version does.

#include "bar_blocks.cuh"
#include "metrics_tail.cuh"
#include "occupancy.cuh"

namespace {

// K6's lanes a CTA.
constexpr int kThreads = 128;
// K6: stage its rows in shared memory up to this many bytes per CTA (three
// rows: T <= 8192 bars); longer histories read through the read-only cache.
constexpr size_t kMaxStagedBytes = 96 * 1024;

__device__ __forceinline__ float sma_at(const float* cs, int t, int w,
                                        float fw) {
  if (t < w - 1) return 0.f;
  const float lag = t >= w ? cs[t - w] : 0.f;
  return (cs[t] - lag) / fw;
}

// wins: the (n_tiles, wmax) window lists, counts: their lengths; fi, si:
// each lane's fast and slow index into its tile's list.
__global__ void __launch_bounds__(dbx::kMaxTileLanes) fused_sma_kernel(
    const float* __restrict__ cs, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ wins,
    const int* __restrict__ counts, const int* __restrict__ fi,
    const int* __restrict__ si, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int P, int wmax, float cost,
    float ppy) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const float* cs_row = cs + static_cast<size_t>(n) * T;
  const int* list = wins + static_cast<size_t>(blockIdx.y) * wmax;
  const bool live = p < P;
  const int f = live ? fi[p] : 0;
  const int s = live ? si[p] : 0;
  const int t_on = live ? warm[p] - 1 : 0;

  dbx::MetricsAcc acc;
  dbx::bar_block_pass(
      smem, counts[blockIdx.y], tr, r + static_cast<size_t>(n) * T, live,
      [&](int j, int t) {
        const int w = list[j];
        return sma_at(cs_row, t, w, static_cast<float>(w));
      },
      [&](const float* v, float rt, int t) {
        // Read and decide on every bar, then select: no branch in the loop.
        const float pos = dbx::sign_of(v[f] - v[s]);
        acc.step(t >= t_on ? pos : 0.f, rt, cost);
      });
  if (live) acc.store(out, n, p, N, P, tr, ppy);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) obv_kernel(
    const float* __restrict__ obv, const float* __restrict__ cs,
    const float* __restrict__ r, const int* __restrict__ t_real,
    const int* __restrict__ window, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int P, float cost, float ppy) {
  extern __shared__ float staged[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const size_t row = static_cast<size_t>(n) * T;
  const float* obv_row = obv + row;
  const float* cs_row = cs + row;
  const float* r_row = r + row;
  if (kStaged) {
    for (int t = threadIdx.x; t < tr; t += kThreads) {
      staged[t] = obv_row[t];
      staged[T + t] = cs_row[t];
      staged[2 * T + t] = r_row[t];
    }
    __syncthreads();
    obv_row = staged;
    cs_row = staged + T;
    r_row = staged + 2 * T;
  }
  if (p >= P) return;

  const int w = window[p];
  const float fw = static_cast<float>(w);
  const int t_on = warm[p] - 1;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) pos = dbx::sign_of(obv_row[t] - sma_at(cs_row, t, w, fw));
    acc.step(pos, r_row[t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
}

}  // namespace

// C entry points (loaded with ctypes). Pointers are device pointers.
//
// dbx_fused_sma (K1): cs, r: (N, T) f32; t_real: (N,) i32; wins:
// (n_tiles, wmax) i32, the sorted distinct windows each tile of `lanes`
// lanes reads, counts: (n_tiles,) i32 their number (at most wmax); fi, si:
// (P,) i32 each lane's fast and slow index into its tile's list; warm:
// (P,) i32 (the truncated max(fast, slow) warmup); out: (9, N, P) f32.
// lanes: a multiple of 32 up to 1024, the lanes a CTA. Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int dbx_fused_sma(const void* cs, const void* r,
                             const void* t_real, const void* wins,
                             const void* counts, const void* fi,
                             const void* si, const void* warm, void* out,
                             int N, int T, int P, int lanes, int wmax,
                             float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = dbx::block_smem_bytes(wmax);
  const int err = dbx::allow_smem(fused_sma_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(N, (P + lanes - 1) / lanes);
  fused_sma_kernel<<<grid, lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cs), static_cast<const float*>(r),
      static_cast<const int*>(t_real), static_cast<const int*>(wins),
      static_cast<const int*>(counts), static_cast<const int*>(fi),
      static_cast<const int*>(si), static_cast<const int*>(warm),
      static_cast<float*>(out), N, T, P, wmax, cost, static_cast<float>(ppy));
  return static_cast<int>(cudaGetLastError());
}

// dbx_fused_sma_occupancy: the build report (occupancy.cuh: registers,
// resident CTAs an SM, lanes, dynamic shared memory in info[0..3]) of K1's
// kernel launched as dbx_fused_sma launches it on `lanes`-lane tiles with
// lists of at most `wmax` windows.
extern "C" int dbx_fused_sma_occupancy(int lanes, int wmax, int* info) {
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dbx::launch_report(fused_sma_kernel, lanes,
                            dbx::block_smem_bytes(wmax), info);
}

// dbx_obv (K6): obv, cs, r: (N, T) f32 (normalized OBV, its cumsum, simple
// returns of the closes); t_real: (N,) i32; window, warm: (P,) i32 (rounded
// window, truncated warmup = window); out: (9, N, P) f32. Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int dbx_obv(const void* obv, const void* cs, const void* r,
                       const void* t_real, const void* window,
                       const void* warm, void* out, int N, int T, int P,
                       float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  const size_t smem = 3 * static_cast<size_t>(T) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a_obv = static_cast<const float*>(obv);
  const auto* a_cs = static_cast<const float*>(cs);
  const auto* a_r = static_cast<const float*>(r);
  const auto* a_tr = static_cast<const int*>(t_real);
  const auto* a_win = static_cast<const int*>(window);
  const auto* a_w = static_cast<const int*>(warm);
  auto* a_out = static_cast<float*>(out);
  const float f_ppy = static_cast<float>(ppy);
  if (smem <= kMaxStagedBytes) {
    const int err = dbx::allow_smem(obv_kernel<true>, smem);
    if (err != 0) return err;
    obv_kernel<true><<<grid, kThreads, smem, s>>>(
        a_obv, a_cs, a_r, a_tr, a_win, a_w, a_out, N, T, P, cost, f_ppy);
  } else {
    obv_kernel<false><<<grid, kThreads, 0, s>>>(
        a_obv, a_cs, a_r, a_tr, a_win, a_w, a_out, N, T, P, cost, f_ppy);
  }
  return static_cast<int>(cudaGetLastError());
}
