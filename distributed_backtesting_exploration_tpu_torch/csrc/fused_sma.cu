// Fused SMA-crossover sweep for Hopper (sm_90a): K1 of the port, and K6,
// the OBV-trend sweep, which forms its SMA from a cumsum row too and runs
// on the same tiles.
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
// the metric update (metrics_tail.cuh: its drawdown division only on the
// bars that may set a new maximum drawdown); the SMA's sub and IEEE
// division run once per (window, bar) of the tile, about 1/9 of a lane's
// share at the headline. Bytes are negligible: two input rows per ticker
// and 36 MB of output for the headline 500 x 2000 sweep.
//
// K6 (dbx_obv) replaces the reference's `_fused_obv_call` with its bodies
// `_obv_kernel_inline` (SMA-of-OBV table built in VMEM from the OBV cumsum
// row by the SMA kernel's own table code) and `_obv_kernel` (the same
// table streamed from HBM), which share `_obv_signal_tail`. Its signal,
// obv[t] - sma_w[t], is a function of (ticker, window, bar), so it takes
// K1's design: one CTA covers one ticker x one tile of lanes, forms
// obv[t] - sma_at(cs, t, w) once per (window, bar) of the tile's distinct
// windows a block of bars at a time (bar_blocks.cuh; obv and its cumsum
// cs read through L1) with its sign, and each lane steps its window's sign
// from bar window - 1. The difference rounds once, as the reference's
// does, so the sign is the lane's own. No table and no one-hot (its single
// nonzero term per lane is a copy). The bench grid (windows 5..129 tiled 16
// times) gives a 1024-lane tile 125 distinct windows. Bound by fp32
// operations: a lane's 20 of the metric update a bar, and the SMA's sub
// and IEEE division, the difference and its sign once per (window, bar).
//
// Built without fast math and with -fmad=false: the SMA division and sqrtf
// stay IEEE round-to-nearest, so table values equal the reference's, and no
// multiply-add is contracted, so the epilogue rounds as the plain PyTorch
// version does.

#include "bar_blocks.cuh"
#include "metrics_tail.cuh"
#include "occupancy.cuh"

namespace {

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

// K6 on the same tiles: wi, each lane's index into its tile's list.
__global__ void __launch_bounds__(dbx::kMaxTileLanes) obv_kernel(
    const float* __restrict__ obv, const float* __restrict__ cs,
    const float* __restrict__ r, const int* __restrict__ t_real,
    const int* __restrict__ wins, const int* __restrict__ counts,
    const int* __restrict__ wi, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int P, int wmax, float cost,
    float ppy) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const size_t row = static_cast<size_t>(n) * T;
  const float* obv_row = obv + row;
  const float* cs_row = cs + row;
  const int* list = wins + static_cast<size_t>(blockIdx.y) * wmax;
  const bool live = p < P;
  const int j = live ? wi[p] : 0;
  const int t_on = live ? warm[p] - 1 : 0;

  dbx::MetricsAcc acc;
  dbx::bar_block_pass(
      smem, counts[blockIdx.y], tr, r + row, live,
      [&](int k, int t) {
        const int w = list[k];
        return dbx::sign_of(obv_row[t] -
                            sma_at(cs_row, t, w, static_cast<float>(w)));
      },
      [&](const float* v, float rt, int t) {
        acc.step(t >= t_on ? v[j] : 0.f, rt, cost);
      });
  if (live) acc.store(out, n, p, N, P, tr, ppy);
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
// returns of the closes); t_real: (N,) i32; wins, counts: the tiles'
// window lists and their lengths, as dbx_fused_sma's; wi: (P,) i32 each
// lane's index into its tile's list; warm: (P,) i32 (truncated warmup =
// window); out: (9, N, P) f32; lanes as dbx_fused_sma's. Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int dbx_obv(const void* obv, const void* cs, const void* r,
                       const void* t_real, const void* wins,
                       const void* counts, const void* wi, const void* warm,
                       void* out, int N, int T, int P, int lanes, int wmax,
                       float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = dbx::block_smem_bytes(wmax);
  const int err = dbx::allow_smem(obv_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(N, (P + lanes - 1) / lanes);
  obv_kernel<<<grid, lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obv), static_cast<const float*>(cs),
      static_cast<const float*>(r), static_cast<const int*>(t_real),
      static_cast<const int*>(wins), static_cast<const int*>(counts),
      static_cast<const int*>(wi), static_cast<const int*>(warm),
      static_cast<float*>(out), N, T, P, wmax, cost, static_cast<float>(ppy));
  return static_cast<int>(cudaGetLastError());
}

// dbx_obv_occupancy: dbx_fused_sma_occupancy's report for K6's kernel.
extern "C" int dbx_obv_occupancy(int lanes, int wmax, int* info) {
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dbx::launch_report(obv_kernel, lanes, dbx::block_smem_bytes(wmax),
                            info);
}
