// Single-window-axis sweeps for Hopper (sm_90a): K3 of the port.
//
// Replaces the TPU kernel of the reference package,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_single_window_pallas`
// with its bodies `_mom_kernel_inline`/`_mom_kernel` (momentum) and
// `_don_kernel`/`_don_kernel_inline` (donchian and donchian_hl over the
// breakout-sign table, streamed from HBM or built in VMEM). For every
// (ticker, combo) lane it forms the lane's position series and writes the
// 9 backtest metrics.
//
// Design.
// - No table selection by one-hot matmul and no compose ladder: one thread
//   per lane reads its own values and steps bar by bar, which gives the TPU
//   kernel's positions exactly (its contraction copies one exact value and
//   its ladder only selects among -1/0/+1).
// - dbx_momentum: past = close[max(t - w, 0)] read from the staged close
//   row (the clipped read of `_mom_kernel_inline`), pos = sign(close - past)
//   with jnp.sign's treatment of 0, flat before the warmup (lookback + 1).
//   Exact: no rounding can change the sign of a difference of two floats.
// - dbx_donchian: no table. The CTA builds the sparse-table levels of the
//   ticker's high-source and low-source rows in shared memory
//   (extrema.cuh); each lane forms its channel per bar, +-1e30 before
//   t = w - 1 (`_fused_don_call`'s fills), keeps the prior bar's channel in
//   registers (1e30 at t = 0), takes the breakout sign (+1 where the close
//   is at or above the prior high, -1 at or below the prior low, up wins)
//   and runs the latch: +1 on up, -1 on down, else hold; flat before the
//   warmup (window + 1). Max, min and comparisons of raw prices are exact,
//   so the signs equal those of `_fused_don_call`'s table. When the
//   levels do not fit in shared memory (long rows), the wrapper builds
//   them in device memory with torch ops and the same body reads them.
//   Lanes run window-major (the wrapper sorts them and passes `lane`, each
//   slot's lane in the caller's order): a warp's lanes share one to four
//   windows, so their level reads are broadcasts of a few words. One CTA
//   covers one ticker x 1024 combos (the levels take up to 227 KB, one CTA
//   an SM, 32 warps).
// - dbx_momentum: one CTA covers one ticker x 128 combos, the close and
//   returns rows staged in shared memory when they fit. Its sign is a
//   function of (ticker, lookback, bar), but forming it once per lookback
//   and bar block in shared memory (bar_blocks.cuh, K1's design) was not
//   faster on the H100 (PERF.md, section 6): this per-lane read
//   takes no barrier and keeps more warps resident, and its sub and sign
//   are two of a lane's 22 operations a bar.
// - One sequential pass per thread over t < t_real[ticker] with the PnL and
//   metrics of metrics_tail.cuh.
//
// What bounds it. Momentum does about 22 fp32 operations per (combo, bar),
// 20 of them the metric update; donchian 26 (the channel's max and min,
// two breakout compares, the latch). Both are bound by their operations
// (PERF.md, section 6).
//
// Built without fast math and with -fmad=false, like K1: the metrics round
// as the plain PyTorch version's do.

#include "extrema.cuh"
#include "metrics_tail.cuh"
#include "occupancy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxStagedBytes = 96 * 1024;
// Lanes per CTA of the donchian entry: one CTA an SM, 32 warps.
constexpr int kWideThreads = 1024;
// The reference's stand-in for the channel's +-inf warmup fill.
constexpr float kChannelFill = 1e30f;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) momentum_kernel(
    const float* __restrict__ close, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ lookback,
    const int* __restrict__ warm, float* __restrict__ out, int N, int T,
    int P, float cost, float ppy) {
  extern __shared__ float staged[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const float* c_row = close + static_cast<size_t>(n) * T;
  const float* r_row = r + static_cast<size_t>(n) * T;
  if (kStaged) {
    for (int t = threadIdx.x; t < tr; t += kThreads) {
      staged[t] = c_row[t];
      staged[T + t] = r_row[t];
    }
    __syncthreads();
    c_row = staged;
    r_row = staged + T;
  }
  if (p >= P) return;

  const int w = lookback[p];
  const int t_on = warm[p] - 1;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) pos = dbx::sign_of(c_row[t] - c_row[max(t - w, 0)]);
    acc.step(pos, r_row[t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
}

template <bool kStaged>
__global__ void __launch_bounds__(kWideThreads, 1) donchian_kernel(
    const float* __restrict__ close, const float* __restrict__ hi_src,
    const float* __restrict__ lo_src, const float* __restrict__ r,
    const float* __restrict__ lev_hi, const float* __restrict__ lev_lo,
    const int* __restrict__ t_real, const int* __restrict__ window,
    const int* __restrict__ warm, const int* __restrict__ lane,
    float* __restrict__ out, int N, int T, int L, int P, float cost,
    float ppy) {
  extern __shared__ float staged[];
  const int n = blockIdx.x;
  const int slot = blockIdx.y * kWideThreads + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const size_t row = static_cast<size_t>(n) * T;
  const float* c_row = close + row;
  const float* r_row = r + row;
  const float* lh;
  const float* ll;
  if (kStaged) {
    const dbx::StagedChannel st = dbx::stage_channel(
        staged, c_row, r_row, hi_src + row, lo_src + row, window, slot, P, T,
        tr, L);
    c_row = st.close;
    r_row = st.r;
    lh = st.lev_hi;
    ll = st.lev_lo;
  } else {
    const size_t lev = static_cast<size_t>(n) * (L + 1) * T;
    lh = lev_hi + lev;
    ll = lev_lo + lev;
  }
  if (slot >= P) return;

  const int w = max(window[slot], 1);
  const dbx::Channel ch(lh, ll, T, w);
  const int t_on = warm[slot] - 1;
  float hi_prev = kChannelFill;
  float lo_prev = -kChannelFill;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) {
      const float c = c_row[t];
      pos = c >= hi_prev ? 1.f : (c <= lo_prev ? -1.f : acc.prev);
    }
    const bool full = t >= w - 1;
    hi_prev = full ? ch.high(t) : kChannelFill;
    lo_prev = full ? ch.low(t) : -kChannelFill;
    acc.step(pos, r_row[t], cost);
  }
  acc.store(out, n, lane[slot], N, P, tr, ppy);
}

}  // namespace

// C entry points (loaded with ctypes). Pointers are device pointers; each
// launches on `stream` and returns cudaGetLastError() as an int.
// out: (9, N, P) f32; t_real: (N,) i32; warm: (P,) i32 truncated warmups.
//
// dbx_momentum: close, r: (N, T) f32; lookback: (P,) i32 rounded lookbacks.
extern "C" int dbx_momentum(const void* close, const void* r,
                            const void* t_real, const void* lookback,
                            const void* warm, void* out, int N, int T, int P,
                            float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  const size_t smem = 2 * static_cast<size_t>(T) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a_c = static_cast<const float*>(close);
  const auto* a_r = static_cast<const float*>(r);
  const auto* a_tr = static_cast<const int*>(t_real);
  const auto* a_lb = static_cast<const int*>(lookback);
  const auto* a_w = static_cast<const int*>(warm);
  auto* a_out = static_cast<float*>(out);
  const float f_ppy = static_cast<float>(ppy);
  if (smem <= kMaxStagedBytes) {
    const int err = dbx::allow_smem(momentum_kernel<true>, smem);
    if (err != 0) return err;
    momentum_kernel<true><<<grid, kThreads, smem, s>>>(
        a_c, a_r, a_tr, a_lb, a_w, a_out, N, T, P, cost, f_ppy);
  } else {
    momentum_kernel<false><<<grid, kThreads, 0, s>>>(
        a_c, a_r, a_tr, a_lb, a_w, a_out, N, T, P, cost, f_ppy);
  }
  return static_cast<int>(cudaGetLastError());
}

// dbx_donchian: close, hi_src, lo_src, r: (N, T) f32 (the channel's high
// and low sources: the close itself for donchian, the highs and lows for
// donchian_hl); window: (P,) i32 window of each slot; lane: (P,) i32, the
// caller's lane of each slot (slot p's metrics go to out[:, n, lane[p]]);
// lev_hi, lev_lo: null where the kernel builds the levels in shared
// memory, else (N, L + 1, T) f32 levels of hi_src (max) and lo_src (min)
// in device memory, L = dbx_channel_levels(T) (extrema.cuh).
extern "C" int dbx_donchian(const void* close, const void* hi_src,
                            const void* lo_src, const void* r,
                            const void* lev_hi, const void* lev_lo,
                            const void* t_real, const void* window,
                            const void* warm, const void* lane, void* out,
                            int N, int T, int P, float cost, int ppy,
                            void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(N, (P + kWideThreads - 1) / kWideThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a_c = static_cast<const float*>(close);
  const auto* a_hs = static_cast<const float*>(hi_src);
  const auto* a_ls = static_cast<const float*>(lo_src);
  const auto* a_r = static_cast<const float*>(r);
  const auto* a_lh = static_cast<const float*>(lev_hi);
  const auto* a_ll = static_cast<const float*>(lev_lo);
  const auto* a_tr = static_cast<const int*>(t_real);
  const auto* a_win = static_cast<const int*>(window);
  const auto* a_w = static_cast<const int*>(warm);
  const auto* a_lane = static_cast<const int*>(lane);
  auto* a_out = static_cast<float*>(out);
  const float f_ppy = static_cast<float>(ppy);
  const int L = dbx::channel_levels(T);
  if (dbx::channel_staged(T)) {
    const size_t smem = dbx::channel_smem_bytes(T);
    const int err = dbx::allow_smem(donchian_kernel<true>, smem);
    if (err != 0) return err;
    donchian_kernel<true><<<grid, kWideThreads, smem, s>>>(
        a_c, a_hs, a_ls, a_r, nullptr, nullptr, a_tr, a_win, a_w, a_lane,
        a_out, N, T, L, P, cost, f_ppy);
  } else {
    if (a_lh == nullptr || a_ll == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    donchian_kernel<false><<<grid, kWideThreads, 0, s>>>(
        a_c, a_hs, a_ls, a_r, a_lh, a_ll, a_tr, a_win, a_w, a_lane, a_out, N,
        T, L, P, cost, f_ppy);
  }
  return static_cast<int>(cudaGetLastError());
}

// dbx_donchian_occupancy: the build report (occupancy.cuh: registers,
// resident CTAs an SM, lanes, dynamic shared memory in info[0..3]) of the
// donchian kernel at row length T, as dbx_donchian launches it.
extern "C" int dbx_donchian_occupancy(int T, int* info) {
  if (dbx::channel_staged(T)) {
    return dbx::launch_report(donchian_kernel<true>, kWideThreads,
                              dbx::channel_smem_bytes(T), info);
  }
  return dbx::launch_report(donchian_kernel<false>, kWideThreads, 0, info);
}
