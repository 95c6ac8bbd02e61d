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
// What bounds them. Not bytes: per (combo, bar) each lane steps the 20
// fp32 operations of the metric update (metrics_tail.cuh) and the signal
// line's 3 on one sequential chain, so a kernel's time is its lanes'
// instructions a bar. The series x is a function of (ticker, span or
// (fast, slow) pair, bar), not of the lane: at the bench grids 10 lanes
// (macd: the signal spans) or 100 (trix) read each distinct x.
//
// Design.
// - The tables come in from device memory, built on the card by
//   ema_rows.cu (dbx_ema_rows): macd's one ladder of EMAs of the demeaned
//   close, trix's three chained ladders. No one-hot matmul: the TPU kernel
//   contracts the table with a +-1 (macd) or one-hot (trix) selector; a
//   read of the lane's rows gives the same value bit for bit.
// - Both run their lanes in tiles (bar_blocks.cuh, as K1's and K6's do):
//   one CTA covers one ticker x one tile of lanes and fills the x of each
//   distinct series its tile reads once per bar of a block in shared
//   memory, so no table read, row pointer or shared operation stays on a
//   lane's chain; each lane reads its x with one shared load and steps its
//   signal line and the metric update. The wrapper builds the tiles' lists
//   with torch ops (ops/fused.py `window_tiles`): for macd of each lane's
//   key fidx * W + sidx, whose rows the CTA decodes into shared memory
//   once (x = f_row[t] - s_row[t], the plain version's expression), for
//   trix of each lane's table row (x from the two e3 values of its row,
//   e3[t-1] from the row, also where a block begins; 0 at bar 0).
// - The signal line is sequential here, where the TPU ran a log-depth
//   ladder across the lane's bars (`_ema_ladder` :2607): s = x at bar 0,
//   then s = (1-a) s + a x, two multiplies and one add with 1-a formed once.
//   It rounds in another order than the ladder, so a crossing at a knife
//   edge can resolve the other way against the reference; the port's plain
//   version (ops/fused.py `macd_plain`, `trix_plain`) carries it in this
//   order, and the kernels equal that bit for bit. macd steps bar 0 apart
//   (lane_block_pass's first-bar step), so its loop selects no bar-0 value.
//
// Built without fast math and with -fmad=false: the division is IEEE
// round-to-nearest and nothing is contracted, so the kernels round as the
// plain PyTorch versions' tensor ops do.

#include "bar_blocks.cuh"
#include "metrics_tail.cuh"
#include "occupancy.cuh"

#include <climits>

namespace {

// K4 on tiles: wins, the (n_tiles, wmax) lists of the (fast, slow) keys
// fidx * W + sidx each tile reads, counts their lengths; wi, each lane's
// index into its tile's list.
__global__ void __launch_bounds__(dbx::kMaxTileLanes) macd_kernel(
    const float* __restrict__ tbl, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ wins,
    const int* __restrict__ counts, const int* __restrict__ wi,
    const float* __restrict__ a_sig, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int W, int P, int wmax,
    float cost, float ppy) {
  extern __shared__ float smem[];
  // Each listed key's fast and slow row offsets in the ticker's table.
  __shared__ int2 rows[dbx::kMaxTileLanes];
  const int n = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const float* tb = tbl + static_cast<size_t>(n) * W * T;
  const int* list = wins + static_cast<size_t>(blockIdx.y) * wmax;
  const int wc = counts[blockIdx.y];
  for (int i = threadIdx.x; i < wc; i += blockDim.x) {
    const int key = list[i];
    rows[i] = make_int2(key / W * T, key % W * T);
  }
  __syncthreads();
  const bool live = p < P;
  const int j = live ? wi[p] : 0;
  const float a = live ? a_sig[p] : 0.f;
  const float keep = 1.f - a;
  const int t_on = live ? warm[p] - 1 : 0;
  float sig = 0.f;

  dbx::MetricsAcc acc;
  dbx::lane_block_pass<dbx::kValues>(
      smem, wc, tr, r + static_cast<size_t>(n) * T, live, j,
      [&](int i, int t) {
        const int2 o = rows[i];
        return tb[o.x + t] - tb[o.y + t];
      },
      [&](float x, float rt, int t) {
        sig = keep * sig + a * x;
        const float pos = t >= t_on ? dbx::sign_of(x - sig) : 0.f;
        acc.step(pos, rt, cost);
      },
      [&](float x, float rt, int t) {  // bar 0: the line starts at x
        sig = x;
        const float pos = t >= t_on ? dbx::sign_of(x - sig) : 0.f;
        acc.step(pos, rt, cost);
      });
  if (live) acc.store(out, n, p, N, P, tr, ppy);
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
// dbx_macd: wins: (n_tiles, wmax) i32, the sorted distinct keys fidx * W +
// sidx (each lane's fast and slow rows) each tile of `lanes` lanes reads,
// counts: (n_tiles,) i32 their number; wi: (P,) i32 each lane's index into
// its tile's list. lanes: a multiple of 32 up to 1024, the lanes a CTA;
// wmax at most 1024, W * T below 2^31.
extern "C" int dbx_macd(const void* tbl, const void* r, const void* t_real,
                        const void* wins, const void* counts, const void* wi,
                        const void* a_sig, const void* warm, void* out, int N,
                        int T, int W, int P, int lanes, int wmax, float cost,
                        int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (!dbx::tile_ok(lanes, wmax) || wmax > dbx::kMaxTileLanes ||
      static_cast<long long>(W) * T > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = dbx::block_smem_bytes(wmax);
  const int err = dbx::allow_smem(macd_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(N, (P + lanes - 1) / lanes);
  macd_kernel<<<grid, lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), static_cast<const float*>(r),
      static_cast<const int*>(t_real), static_cast<const int*>(wins),
      static_cast<const int*>(counts), static_cast<const int*>(wi),
      static_cast<const float*>(a_sig), static_cast<const int*>(warm),
      static_cast<float*>(out), N, T, W, P, wmax, cost,
      static_cast<float>(ppy));
  return static_cast<int>(cudaGetLastError());
}

// dbx_macd_occupancy: the build report (occupancy.cuh) of K4's kernel
// launched as dbx_macd launches it on `lanes`-lane tiles with lists of at
// most `wmax` keys.
extern "C" int dbx_macd_occupancy(int lanes, int wmax, int* info) {
  if (!dbx::tile_ok(lanes, wmax) || wmax > dbx::kMaxTileLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dbx::launch_report(macd_kernel, lanes, dbx::block_smem_bytes(wmax),
                            info);
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
