// Band-machine sweeps for Hopper (sm_90a): K2 of the port, and K7, the
// pairs sweep, which runs the same hysteresis machine.
//
// Replaces the TPU kernel of the reference package,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_band_machine_pallas`
// with its bodies `_band_kernel_inline` (z-table built in the kernel by
// `_build_boll_z_scratch`), `_boll_kernel` and `_touch_kernel` (z-table
// streamed from HBM). For every (ticker, combo) lane it selects the lane's
// z-score series, runs a band machine over it and writes the 9 backtest
// metrics:
// - "hysteresis" (bollinger, stochastic): the 3-state machine of
//   `signals.band_hysteresis`: from flat, enter long below -k and short
//   above +k; leave a long at z >= -z_exit and a short at z <= z_exit;
//   flat before the lane's warmup.
// - "touch" (bollinger_touch): memoryless, long below -k, short above +k.
//
// Design.
// - No one-hot matmul and no compose ladder. The TPU kernel selects each
//   lane's z row with a one-hot contraction (one nonzero term: a copy) and
//   evaluates the machine as a log-depth composition of transition maps,
//   which only selects among -1/0/+1. One thread per lane reading its own
//   z value and stepping the machine bar by bar gives the same positions.
// - Two C entries:
//   * dbx_band_inline (bollinger): no z-table. Inputs are the close row and
//     the cumsum rows of close, centered close and centered close squared
//     (torch ops before the launch) plus the simple returns: 5 rows, staged
//     in shared memory (5 x 1260 x 4 B = 25 KB at the headline T). Each lane
//     forms its window's z per bar in `_build_boll_z_scratch`'s op order:
//     m = (cs[t] - cs[t-w]) / w, s1 and s2 the centered window sums,
//     var = max((s2 - s1*s1/w) / w, 0), z = (c - m) / (sqrt(var) + 1e-12),
//     z = 0 for t < w - 1.
//   * dbx_band_table (stochastic): reads a torch-built (N, W, T) f32
//     z-table, row widx[lane].
//     At the stochastic bench shape that table is 500 x 125 x 1260 x 4 B =
//     315 MB, which the card's 80 GB holds with room to spare; only the
//     returns row is staged.
// - One CTA covers one ticker x 128 combos; one sequential pass per thread
//   over t < t_real[ticker] with the PnL and metrics of metrics_tail.cuh.
//
// What bounds it. The inline entry spends about 13 fp32 operations per
// (combo, bar) on z (three divisions and a square root) beside the 20 of
// the metric update. The table entry reads 4 B of z per (combo, bar); the
// bench grids run window-minor, so the 32 lanes of a warp hold 32 windows
// and each bar's load touches 32 table rows, one sector each. That load,
// not arithmetic, keeps the table entry far above its operations bound
// (PERF.md, section 6). Staging a CTA's z rows, or giving a CTA one window,
// is a later speed step (ROADMAP.md, Queue 2), as is sharing the inline z
// across the lanes of one window.
//
// K7 (dbx_pairs) replaces the reference's `_fused_pairs_call` with its body
// `_pairs_kernel`: one one-hot selection of a stacked (z, hedged return)
// table row per lane, the band ladder with per-lane z_entry and z_exit,
// net = prev * hr - cost * |dpos| and `_metrics_pack`. Here each thread
// reads its lane's rows of two torch-built (N, W, T) tables (the spread
// z-score and the hedged spread return, 50 MB each at 1000 pairs x 10
// lookbacks x 1260 bars), steps band_next<kHysteresis> with its own k and
// z_exit, and passes hr[t] to MetricsAcc::step in place of the ticker's
// return, which is exactly the reference's net. The pairs grid runs
// lookback-major, so a warp's 32 lanes read one or two rows a bar: loads
// coalesce into a few sectors and the kernel is bound by its ~24 fp32
// operations a (combo, bar), not by the 100 MB of tables.
//
// Built without fast math and with -fmad=false: divisions and sqrtf are
// IEEE round-to-nearest and nothing is contracted, so z equals the torch
// z-table built from the same cumsums, and the positions and metrics equal
// the plain PyTorch version's bit for bit.

#include "band_next.cuh"
#include "metrics_tail.cuh"

namespace {

using dbx::band_next;
using dbx::kHysteresis;
using dbx::kTouch;

constexpr int kThreads = 128;
constexpr size_t kMaxStagedBytes = 96 * 1024;

// Windowed sum cs[t] - cs[t-w] (cs[t-w] = 0 for t < w).
__device__ __forceinline__ float wsum(const float* cs, int t, int w) {
  return cs[t] - (t >= w ? cs[t - w] : 0.f);
}

__device__ __forceinline__ float boll_z(const float* c, const float* cs,
                                        const float* csx, const float* csx2,
                                        int t, int w, float fw) {
  if (t < w - 1) return 0.f;
  const float m = wsum(cs, t, w) / fw;
  const float s1 = wsum(csx, t, w);
  const float s2 = wsum(csx2, t, w);
  float var = (s2 - s1 * s1 / fw) / fw;
  var = var < 0.f ? 0.f : var;  // torch.clamp_min: NaN stays NaN
  return (c[t] - m) / (sqrtf(var) + dbx::kEps);
}

template <int kMachine, bool kStaged>
__global__ void __launch_bounds__(kThreads) band_inline_kernel(
    const float* __restrict__ close, const float* __restrict__ cs,
    const float* __restrict__ csx, const float* __restrict__ csx2,
    const float* __restrict__ r, const int* __restrict__ t_real,
    const int* __restrict__ window, const float* __restrict__ k,
    const int* __restrict__ warm, float* __restrict__ out, int N, int T,
    int P, float z_exit, float cost, float ppy) {
  extern __shared__ float staged[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const size_t row = static_cast<size_t>(n) * T;
  const float* rows[5] = {close + row, cs + row, csx + row, csx2 + row,
                          r + row};
  if (kStaged) {
    for (int i = 0; i < 5; ++i) {
      for (int t = threadIdx.x; t < tr; t += kThreads) {
        staged[i * T + t] = rows[i][t];
      }
    }
    __syncthreads();
    for (int i = 0; i < 5; ++i) rows[i] = staged + i * T;
  }
  if (p >= P) return;

  const int w = window[p];
  const float fw = static_cast<float>(w);
  const float kk = k[p];
  const int t_on = warm[p] - 1;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) {
      const float z = boll_z(rows[0], rows[1], rows[2], rows[3], t, w, fw);
      pos = band_next<kMachine>(acc.prev, z, kk, z_exit);
    }
    acc.step(pos, rows[4][t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
}

template <int kMachine, bool kStaged>
__global__ void __launch_bounds__(kThreads) band_table_kernel(
    const float* __restrict__ z, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ widx,
    const float* __restrict__ k, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int W, int P, float z_exit,
    float cost, float ppy) {
  extern __shared__ float staged[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const float* r_row = r + static_cast<size_t>(n) * T;
  if (kStaged) {
    for (int t = threadIdx.x; t < tr; t += kThreads) staged[t] = r_row[t];
    __syncthreads();
    r_row = staged;
  }
  if (p >= P) return;

  const float* z_row = z + (static_cast<size_t>(n) * W + widx[p]) * T;
  const float kk = k[p];
  const int t_on = warm[p] - 1;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) pos = band_next<kMachine>(acc.prev, z_row[t], kk, z_exit);
    acc.step(pos, r_row[t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
}

__global__ void __launch_bounds__(kThreads) pairs_kernel(
    const float* __restrict__ z, const float* __restrict__ hr,
    const int* __restrict__ t_real, const int* __restrict__ widx,
    const float* __restrict__ k, const float* __restrict__ z_exit,
    const int* __restrict__ warm, float* __restrict__ out, int N, int T,
    int W, int P, float cost, float ppy) {
  const int n = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  if (p >= P) return;
  const int tr = min(max(t_real[n], 0), T);
  const size_t row = (static_cast<size_t>(n) * W + widx[p]) * T;
  const float* z_row = z + row;
  const float* hr_row = hr + row;
  const float kk = k[p];
  const float zx = z_exit[p];
  const int t_on = warm[p] - 1;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) pos = band_next<kHysteresis>(acc.prev, z_row[t], kk, zx);
    acc.step(pos, hr_row[t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
}

template <int kMachine>
int launch_inline(const float* close, const float* cs, const float* csx,
                  const float* csx2, const float* r, const int* t_real,
                  const int* window, const float* k, const int* warm,
                  float* out, int N, int T, int P, float z_exit, float cost,
                  float ppy, cudaStream_t s) {
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  const size_t smem = 5 * static_cast<size_t>(T) * sizeof(float);
  if (smem <= kMaxStagedBytes) {
    const int err = dbx::allow_smem(band_inline_kernel<kMachine, true>, smem);
    if (err != 0) return err;
    band_inline_kernel<kMachine, true><<<grid, kThreads, smem, s>>>(
        close, cs, csx, csx2, r, t_real, window, k, warm, out, N, T, P,
        z_exit, cost, ppy);
  } else {
    band_inline_kernel<kMachine, false><<<grid, kThreads, 0, s>>>(
        close, cs, csx, csx2, r, t_real, window, k, warm, out, N, T, P,
        z_exit, cost, ppy);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kMachine>
int launch_table(const float* z, const float* r, const int* t_real,
                 const int* widx, const float* k, const int* warm, float* out,
                 int N, int T, int W, int P, float z_exit, float cost,
                 float ppy, cudaStream_t s) {
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(T) * sizeof(float);
  if (smem <= kMaxStagedBytes) {
    const int err = dbx::allow_smem(band_table_kernel<kMachine, true>, smem);
    if (err != 0) return err;
    band_table_kernel<kMachine, true><<<grid, kThreads, smem, s>>>(
        z, r, t_real, widx, k, warm, out, N, T, W, P, z_exit, cost, ppy);
  } else {
    band_table_kernel<kMachine, false><<<grid, kThreads, 0, s>>>(
        z, r, t_real, widx, k, warm, out, N, T, W, P, z_exit, cost, ppy);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (loaded with ctypes). Pointers are device pointers; each
// launches on `stream` and returns cudaGetLastError() as an int. machine:
// 0 = hysteresis, 1 = touch. out: (9, N, P) f32.
//
// dbx_band_inline: close, cs, csx, csx2, r: (N, T) f32 (close, its cumsum,
// the cumsums of the centered close and of its square, simple returns);
// t_real: (N,) i32; window, warm: (P,) i32 (rounded window, truncated
// warmup); k: (P,) f32 entry band.
extern "C" int dbx_band_inline(const void* close, const void* cs,
                               const void* csx, const void* csx2,
                               const void* r, const void* t_real,
                               const void* window, const void* k,
                               const void* warm, void* out, int N, int T,
                               int P, int machine, float z_exit, float cost,
                               int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (machine != kHysteresis && machine != kTouch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto launch = machine == kTouch ? launch_inline<kTouch>
                                  : launch_inline<kHysteresis>;
  return launch(static_cast<const float*>(close),
                static_cast<const float*>(cs), static_cast<const float*>(csx),
                static_cast<const float*>(csx2), static_cast<const float*>(r),
                static_cast<const int*>(t_real),
                static_cast<const int*>(window), static_cast<const float*>(k),
                static_cast<const int*>(warm), static_cast<float*>(out), N, T,
                P, z_exit, cost, static_cast<float>(ppy),
                static_cast<cudaStream_t>(stream));
}

// dbx_band_table: z: (N, W, T) f32 z-table (0 before each window's warmup);
// r: (N, T) f32; t_real: (N,) i32; widx: (P,) i32 row of each lane in z;
// k: (P,) f32; warm: (P,) i32.
extern "C" int dbx_band_table(const void* z, const void* r,
                              const void* t_real, const void* widx,
                              const void* k, const void* warm, void* out,
                              int N, int T, int W, int P, int machine,
                              float z_exit, float cost, int ppy,
                              void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (machine != kHysteresis && machine != kTouch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto launch = machine == kTouch ? launch_table<kTouch>
                                  : launch_table<kHysteresis>;
  return launch(static_cast<const float*>(z), static_cast<const float*>(r),
                static_cast<const int*>(t_real),
                static_cast<const int*>(widx), static_cast<const float*>(k),
                static_cast<const int*>(warm), static_cast<float*>(out), N, T,
                W, P, z_exit, cost, static_cast<float>(ppy),
                static_cast<cudaStream_t>(stream));
}

// dbx_pairs (K7): z, hr: (N, W, T) f32 spread z-table (0 before each
// lookback's warmup) and hedged-return table; t_real: (N,) i32; widx: (P,)
// i32 row of each lane; k, z_exit: (P,) f32 entry and exit bands; warm: (P,)
// i32 (truncated 2 * lookback - 1).
extern "C" int dbx_pairs(const void* z, const void* hr, const void* t_real,
                         const void* widx, const void* k, const void* z_exit,
                         const void* warm, void* out, int N, int T, int W,
                         int P, float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  pairs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(hr),
      static_cast<const int*>(t_real), static_cast<const int*>(widx),
      static_cast<const float*>(k), static_cast<const float*>(z_exit),
      static_cast<const int*>(warm), static_cast<float*>(out), N, T, W, P,
      cost, static_cast<float>(ppy));
  return static_cast<int>(cudaGetLastError());
}
