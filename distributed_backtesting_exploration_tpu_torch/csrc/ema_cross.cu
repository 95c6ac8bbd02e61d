// EMA signal-line crossover sweeps for Hopper (sm_90a): K4 and K5 of the
// port.
//
// Replaces two TPU kernels of the reference package,
// distributed_backtesting_exploration_tpu/ops/fused.py:
// - `_fused_macd_call` (:2661) with its body `_macd_kernel` (:2630), MACD:
//   the macd line is the lane's fast row minus its slow row of a table of
//   EMAs of the demeaned close (one row per distinct span);
// - `_fused_trix_call` (:3009) with its body `_trix_kernel` (:2974), TRIX:
//   the lane's row of a table of triple EMAs of the close, e3, gives
//   trix = e3[t] / e3[t-1] - 1, where a previous value of 0 is taken as 1
//   and bar 0 gives 0.
// Both then run a per-lane signal line, an EMA of that series with decay
// a = 2/(signal+1), trade pos = sign(x - signal) from bar warm - 1 on, and
// write the 9 backtest metrics.
//
// Design.
// - The EMA tables are built with torch ops before the launch (the
//   reference's shift-doubling ladder, ops/rolling.py `ema_ladder`); the
//   kernel reads the lane's rows from global memory. At the bench shape one
//   ticker's table is 20 x 1260 x 4 B = 100 KB for macd and 50 KB for trix,
//   which stays in L2; staging it in shared memory is a later speed step.
// - No one-hot matmul: the TPU kernel contracts the table with a +-1 (macd)
//   or one-hot (trix) selector; a gather of the rows and one subtraction
//   gives the same value bit for bit.
// - The signal line is sequential here, where the TPU ran a log-depth
//   ladder across the lane's bars (`_ema_ladder` :2607): s = x at bar 0,
//   then s = (1-a) s + a x, two multiplies and one add with 1-a formed once.
//   It rounds in another order than the ladder, so a crossing at a knife
//   edge can resolve the other way against the reference; the port's plain
//   version (ops/fused.py `macd_plain`, `trix_plain`) carries it in this
//   order, and the kernel equals that bit for bit.
// - One CTA covers one ticker x 128 combos; the returns row is staged in
//   shared memory; one sequential pass per thread over t < t_real[ticker]
//   with the PnL and metrics of metrics_tail.cuh.
//
// What bounds it. Per (combo, bar) 24 fp32 operations for macd and 26 for
// trix (20 of them the metric update, a division among trix's), 2 more past
// the warmup, beside a load of 8 B (macd, two rows) or 4 B (trix) from the
// table. The bench grids put the slow span (macd) or the span (trix) on
// neighbouring lanes, so a warp's loads touch about 10 table rows a bar
// (the band-machine table entry's touch 32; PERF.md, section 6).
//
// Built without fast math and with -fmad=false: the division is IEEE
// round-to-nearest and nothing is contracted, so the kernel rounds as the
// plain PyTorch version's tensor ops do.

#include "metrics_tail.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxStagedBytes = 96 * 1024;
constexpr int kMacd = 0;
constexpr int kTrix = 1;

// One bar of the lane's series x: kMacd reads its fast row `a_row` and its
// slow row `b_row`; kTrix reads its e3 row `a_row` (b_row unused).
template <int kKind>
__device__ __forceinline__ float series_at(const float* a_row,
                                           const float* b_row, int t) {
  if (kKind == kMacd) return a_row[t] - b_row[t];
  if (t == 0) return 0.f;
  const float prev = a_row[t - 1];
  return a_row[t] / (prev == 0.f ? 1.f : prev) - 1.f;
}

template <int kKind, bool kStaged>
__global__ void __launch_bounds__(kThreads) ema_cross_kernel(
    const float* __restrict__ tbl, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ aidx,
    const int* __restrict__ bidx, const float* __restrict__ a_sig,
    const int* __restrict__ warm, float* __restrict__ out, int N, int T,
    int W, int P, float cost, float ppy) {
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

  const float* base = tbl + static_cast<size_t>(n) * W * T;
  const float* a_row = base + static_cast<size_t>(aidx[p]) * T;
  const float* b_row =
      kKind == kMacd ? base + static_cast<size_t>(bidx[p]) * T : a_row;
  const float a = a_sig[p];
  const float keep = 1.f - a;
  const int t_on = warm[p] - 1;
  float sig = 0.f;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    const float x = series_at<kKind>(a_row, b_row, t);
    sig = t == 0 ? x : keep * sig + a * x;
    const float pos = t >= t_on ? dbx::sign_of(x - sig) : 0.f;
    acc.step(pos, r_row[t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
}

template <int kKind>
int launch(const float* tbl, const float* r, const int* t_real,
           const int* aidx, const int* bidx, const float* a_sig,
           const int* warm, float* out, int N, int T, int W, int P,
           float cost, float ppy, cudaStream_t s) {
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(T) * sizeof(float);
  if (smem <= kMaxStagedBytes) {
    const int err = dbx::allow_smem(ema_cross_kernel<kKind, true>, smem);
    if (err != 0) return err;
    ema_cross_kernel<kKind, true><<<grid, kThreads, smem, s>>>(
        tbl, r, t_real, aidx, bidx, a_sig, warm, out, N, T, W, P, cost, ppy);
  } else {
    ema_cross_kernel<kKind, false><<<grid, kThreads, 0, s>>>(
        tbl, r, t_real, aidx, bidx, a_sig, warm, out, N, T, W, P, cost, ppy);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (loaded with ctypes). Pointers are device pointers; each
// launches on `stream` and returns cudaGetLastError() as an int.
// tbl: (N, W, T) f32 EMA table; r: (N, T) f32 simple returns; t_real: (N,)
// i32; a_sig: (P,) f32 signal decays 2/(signal+1); warm: (P,) i32 truncated
// warmups; out: (9, N, P) f32.
//
// dbx_macd: fidx, sidx: (P,) i32 rows of each lane's fast and slow span.
extern "C" int dbx_macd(const void* tbl, const void* r, const void* t_real,
                        const void* fidx, const void* sidx, const void* a_sig,
                        const void* warm, void* out, int N, int T, int W,
                        int P, float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  return launch<kMacd>(
      static_cast<const float*>(tbl), static_cast<const float*>(r),
      static_cast<const int*>(t_real), static_cast<const int*>(fidx),
      static_cast<const int*>(sidx), static_cast<const float*>(a_sig),
      static_cast<const int*>(warm), static_cast<float*>(out), N, T, W, P,
      cost, static_cast<float>(ppy), static_cast<cudaStream_t>(stream));
}

// dbx_trix: widx: (P,) i32 row of each lane's span in the triple-EMA table.
extern "C" int dbx_trix(const void* tbl, const void* r, const void* t_real,
                        const void* widx, const void* a_sig, const void* warm,
                        void* out, int N, int T, int W, int P, float cost,
                        int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  return launch<kTrix>(
      static_cast<const float*>(tbl), static_cast<const float*>(r),
      static_cast<const int*>(t_real), static_cast<const int*>(widx),
      static_cast<const int*>(widx), static_cast<const float*>(a_sig),
      static_cast<const int*>(warm), static_cast<float*>(out), N, T, W, P,
      cost, static_cast<float>(ppy), static_cast<cudaStream_t>(stream));
}
