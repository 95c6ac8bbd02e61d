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
// - The tables come in from device memory: macd's EMA table built with
//   torch ops before the launch (the reference's shift-doubling ladder,
//   ops/rolling.py `ema_ladder`), trix's triple-EMA table by ema_rows.cu
//   (dbx_ema_rows) on the card. No one-hot matmul: the TPU kernel
//   contracts the table with a +-1 (macd) or one-hot (trix) selector; a
//   read of the lane's rows gives the same value bit for bit.
// - The signal line is sequential here, where the TPU ran a log-depth
//   ladder across the lane's bars (`_ema_ladder` :2607): s = x at bar 0,
//   then s = (1-a) s + a x, two multiplies and one add with 1-a formed once.
//   It rounds in another order than the ladder, so a crossing at a knife
//   edge can resolve the other way against the reference; the port's plain
//   version (ops/fused.py `macd_plain`, `trix_plain`) carries it in this
//   order, and the kernels equal that bit for bit.
// - macd: one CTA covers one ticker x 128 combos; the returns row is
//   staged in shared memory; one sequential pass per thread over
//   t < t_real[ticker] with the PnL and metrics of metrics_tail.cuh.
// - trix: trix's x is a function of (ticker, span, bar), not of the lane,
//   and its division is IEEE. So its lanes run in tiles (bar_blocks.cuh, as
//   K1's and K6's do): one CTA covers one ticker x one tile of lanes, fills
//   the rate of change of the tile's distinct spans once per bar of a block
//   in shared memory, reading the two e3 values of each from the table
//   (e3[t-1] from the row, also where a block begins), and each lane steps
//   its signal line and the metric update on its span's value. No division
//   and no table read stays on a lane's chain. The wrapper builds the
//   tiles' span lists with torch ops (ops/fused.py `window_tiles` of the
//   lanes' table rows).
//
// What bounds them. Per (combo, bar) the 20 fp32 operations of the metric
// update (metrics_tail.cuh) and the signal line's 3, for macd also the row
// difference, 2 more past the warmup; trix's rate of change (zero test,
// division, -1) once per (ticker, span, bar), 1/100 of a lane's bars at the
// bench grid (10 spans a 1000-lane ticker). macd reads 8 B a (combo, bar)
// from the table; the bench grid puts the slow span on neighbouring lanes,
// so a warp's loads touch about 10 table rows a bar.
//
// Built without fast math and with -fmad=false: the division is IEEE
// round-to-nearest and nothing is contracted, so the kernels round as the
// plain PyTorch versions' tensor ops do.

#include "bar_blocks.cuh"
#include "metrics_tail.cuh"
#include "occupancy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxStagedBytes = 96 * 1024;

// K4: the macd line is the lane's fast row `f_row` minus its slow row
// `s_row`.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads) macd_kernel(
    const float* __restrict__ tbl, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ fidx,
    const int* __restrict__ sidx, const float* __restrict__ a_sig,
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
  const float* f_row = base + static_cast<size_t>(fidx[p]) * T;
  const float* s_row = base + static_cast<size_t>(sidx[p]) * T;
  const float a = a_sig[p];
  const float keep = 1.f - a;
  const int t_on = warm[p] - 1;
  float sig = 0.f;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    const float x = f_row[t] - s_row[t];
    sig = t == 0 ? x : keep * sig + a * x;
    const float pos = t >= t_on ? dbx::sign_of(x - sig) : 0.f;
    acc.step(pos, r_row[t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
}

// K5 on tiles: wins, the (n_tiles, wmax) lists of the table rows each tile
// reads, counts their lengths; wi, each lane's index into its tile's list.
__global__ void __launch_bounds__(dbx::kMaxTileLanes) trix_kernel(
    const float* __restrict__ tbl, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ wins,
    const int* __restrict__ counts, const int* __restrict__ wi,
    const float* __restrict__ a_sig, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int W, int P, int wmax,
    float cost, float ppy) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const float* rows = tbl + static_cast<size_t>(n) * W * T;
  const int* list = wins + static_cast<size_t>(blockIdx.y) * wmax;
  const bool live = p < P;
  const int j = live ? wi[p] : 0;
  const float a = live ? a_sig[p] : 0.f;
  const float keep = 1.f - a;
  const int t_on = live ? warm[p] - 1 : 0;
  float sig = 0.f;

  dbx::MetricsAcc acc;
  dbx::bar_block_pass(
      smem, counts[blockIdx.y], tr, r + static_cast<size_t>(n) * T, live,
      [&](int k, int t) {
        if (t == 0) return 0.f;
        const float* e3 = rows + static_cast<size_t>(list[k]) * T;
        const float prev = e3[t - 1];
        return e3[t] / (prev == 0.f ? 1.f : prev) - 1.f;
      },
      [&](const float* v, float rt, int t) {
        const float x = v[j];
        sig = t == 0 ? x : keep * sig + a * x;
        const float pos = t >= t_on ? dbx::sign_of(x - sig) : 0.f;
        acc.step(pos, rt, cost);
      });
  if (live) acc.store(out, n, p, N, P, tr, ppy);
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
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(T) * sizeof(float);
  const auto* tp = static_cast<const float*>(tbl);
  const auto* rp = static_cast<const float*>(r);
  const auto* trp = static_cast<const int*>(t_real);
  const auto* fp = static_cast<const int*>(fidx);
  const auto* sp = static_cast<const int*>(sidx);
  const auto* ap = static_cast<const float*>(a_sig);
  const auto* wp = static_cast<const int*>(warm);
  auto* op = static_cast<float*>(out);
  const float fppy = static_cast<float>(ppy);
  if (smem <= kMaxStagedBytes) {
    const int err = dbx::allow_smem(macd_kernel<true>, smem);
    if (err != 0) return err;
    macd_kernel<true><<<grid, kThreads, smem, s>>>(
        tp, rp, trp, fp, sp, ap, wp, op, N, T, W, P, cost, fppy);
  } else {
    macd_kernel<false><<<grid, kThreads, 0, s>>>(
        tp, rp, trp, fp, sp, ap, wp, op, N, T, W, P, cost, fppy);
  }
  return static_cast<int>(cudaGetLastError());
}

// dbx_trix: wins: (n_tiles, wmax) i32, the sorted distinct table rows each
// tile of `lanes` lanes reads, counts: (n_tiles,) i32 their number; wi:
// (P,) i32 each lane's index into its tile's list. lanes: a multiple of 32
// up to 1024, the lanes a CTA.
extern "C" int dbx_trix(const void* tbl, const void* r, const void* t_real,
                        const void* wins, const void* counts, const void* wi,
                        const void* a_sig, const void* warm, void* out, int N,
                        int T, int W, int P, int lanes, int wmax, float cost,
                        int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = dbx::block_smem_bytes(wmax);
  const int err = dbx::allow_smem(trix_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(N, (P + lanes - 1) / lanes);
  trix_kernel<<<grid, lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), static_cast<const float*>(r),
      static_cast<const int*>(t_real), static_cast<const int*>(wins),
      static_cast<const int*>(counts), static_cast<const int*>(wi),
      static_cast<const float*>(a_sig), static_cast<const int*>(warm),
      static_cast<float*>(out), N, T, W, P, wmax, cost,
      static_cast<float>(ppy));
  return static_cast<int>(cudaGetLastError());
}

// dbx_trix_occupancy: the build report (occupancy.cuh) of K5's kernel
// launched as dbx_trix launches it on `lanes`-lane tiles with lists of at
// most `wmax` rows.
extern "C" int dbx_trix_occupancy(int lanes, int wmax, int* info) {
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dbx::launch_report(trix_kernel, lanes, dbx::block_smem_bytes(wmax),
                            info);
}
