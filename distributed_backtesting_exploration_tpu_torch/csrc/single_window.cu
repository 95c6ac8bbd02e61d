// Single-window-axis sweeps for Hopper (sm_90a): K3 of the port.
//
// Replaces the TPU kernel of the reference package,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_single_window_pallas`
// with its bodies `_mom_kernel_inline`/`_mom_kernel` (momentum) and
// `_don_kernel` (donchian and donchian_hl over the HBM breakout-sign table,
// the reference's shipped default). For every (ticker, combo) lane it forms
// the lane's position series and writes the 9 backtest metrics.
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
// - dbx_donchian: reads a torch-built (N, W, T) int8 breakout-sign table,
//   +1 where the close is at or above the prior bar's channel high, -1 at
//   or below the prior low, up wins (`_fused_don_call`'s table with its
//   +-1e30 warmup fills), and runs the latch: +1 on up, -1 on down, else
//   hold; flat before the warmup (window + 1). Max, min and comparisons of
//   raw prices are exact, so the table equals the reference's.
// - One CTA covers one ticker x 128 combos; the ticker's rows are staged in
//   shared memory when they fit; one sequential pass per thread over
//   t < t_real[ticker] with the PnL and metrics of metrics_tail.cuh.
//
// What bounds it. Both entries do about 22 fp32 operations per (combo,
// bar), 20 of them the metric update. The donchian entry reads 1 B of the
// sign table per (combo, bar); the bench grids run window-minor, so the 32
// lanes of a warp hold 32 windows and each bar's load touches 32 table
// rows, one sector each. That load keeps it far above its operations bound
// (PERF.md, section 6). Building the channel rows in shared memory from a
// sparse table (`_don_kernel_inline`) is a later speed step (ROADMAP.md,
// Queue 2).
//
// Built without fast math and with -fmad=false, like K1: the metrics round
// as the plain PyTorch version's do.

#include <stdint.h>

#include "metrics_tail.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxStagedBytes = 96 * 1024;

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
__global__ void __launch_bounds__(kThreads) donchian_kernel(
    const int8_t* __restrict__ sig, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ widx,
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

  const int8_t* s_row = sig + (static_cast<size_t>(n) * W + widx[p]) * T;
  const int t_on = warm[p] - 1;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) {
      const int s = s_row[t];
      pos = s > 0 ? 1.f : (s < 0 ? -1.f : acc.prev);
    }
    acc.step(pos, r_row[t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
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

// dbx_donchian: sig: (N, W, T) int8 breakout signs; r: (N, T) f32;
// widx: (P,) i32 row of each lane in sig.
extern "C" int dbx_donchian(const void* sig, const void* r,
                            const void* t_real, const void* widx,
                            const void* warm, void* out, int N, int T, int W,
                            int P, float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(T) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a_sig = static_cast<const int8_t*>(sig);
  const auto* a_r = static_cast<const float*>(r);
  const auto* a_tr = static_cast<const int*>(t_real);
  const auto* a_wi = static_cast<const int*>(widx);
  const auto* a_w = static_cast<const int*>(warm);
  auto* a_out = static_cast<float*>(out);
  const float f_ppy = static_cast<float>(ppy);
  if (smem <= kMaxStagedBytes) {
    const int err = dbx::allow_smem(donchian_kernel<true>, smem);
    if (err != 0) return err;
    donchian_kernel<true><<<grid, kThreads, smem, s>>>(
        a_sig, a_r, a_tr, a_wi, a_w, a_out, N, T, W, P, cost, f_ppy);
  } else {
    donchian_kernel<false><<<grid, kThreads, 0, s>>>(
        a_sig, a_r, a_tr, a_wi, a_w, a_out, N, T, W, P, cost, f_ppy);
  }
  return static_cast<int>(cudaGetLastError());
}
