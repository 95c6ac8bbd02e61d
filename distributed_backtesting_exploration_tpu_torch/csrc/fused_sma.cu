// Fused SMA-crossover sweep for Hopper (sm_90a): K1 of the port, and K6,
// the OBV-trend sweep, which forms its SMA the same way.
//
// Replaces the TPU kernel of the reference package,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_fused_call` with
// its `_kernel_inline` body (and the `_kernel` HBM-table body, which
// computes the same function). For every (ticker, combo) lane it computes
// the 9 backtest metrics of an SMA crossover in one pass over the bars and
// writes only those 9 floats.
//
// Design.
// - No SMA table. The TPU kernel builds a (windows x bars) table per ticker
//   and selects each lane's fast-minus-slow row with a +-1 one-hot matmul.
//   At the headline shape that table is 120 x 1264 x 4 B = 606 KB, more
//   than a block's 227 KB of shared memory, and Hopper has no need of the
//   matmul. Instead each thread owns one lane and forms sma_fast and
//   sma_slow at every bar from the ticker's cumsum row with the table's
//   exact op sequence: (cs[t] - cs[t-w]) / float(w), with cs[t-w] = 0 for
//   t < w and the value 0 for t < w - 1. d = sma_fast - sma_slow is then
//   bit-equal to the one-hot contraction (two nonzero terms, one rounding).
// - Inputs: the cumsum and the simple returns of the closes, (N, T) each,
//   computed by plain torch ops before the launch (the reference leaves them
//   to XLA). One CTA covers one ticker x 128 combos; the ticker's cs and r
//   rows are staged in shared memory when they fit, else read through the
//   read-only cache.
// - One sequential pass per thread over t < t_real[ticker] carries the
//   position and the metric sums (metrics_tail.cuh, shared with K2 and K3).
//   It replaces both the "scan" and the "ladder" epilogues of the TPU
//   kernel. Bars at or past t_real contribute nothing, which equals the
//   reference holding the last position through repeat-last padding.
// - Output: (9, N, P) f32 in the reference's `_metrics_pack` order and
//   formulas. The wrapper allocates it; the kernel allocates nothing.
//
// What bounds it: fp32 arithmetic outside the tensor cores, about 30
// operations per (combo, bar) including two IEEE divisions. Bytes are
// negligible: two input rows per ticker and 36 MB of output for the
// headline 500 x 2000 sweep. Making it fast (sharing SMA values across the
// lanes of one window, fewer divisions) is later work.
//
// K6 (dbx_obv) replaces the reference's `_fused_obv_call` with its bodies
// `_obv_kernel_inline` (SMA-of-OBV table built in VMEM from the OBV cumsum
// row by the SMA kernel's own table code) and `_obv_kernel` (the same
// table streamed from HBM), which share `_obv_signal_tail`. Here
// it is K1's design on another series: one CTA per ticker x 128 combos
// stages three rows (the normalized OBV, its cumsum and the simple returns,
// 3 x 1260 x 4 B = 15 KB at the bench shape), and each thread forms its
// window's SMA of the OBV per bar with `sma_at`, then
// pos = sign(obv[t] - sma) from bar window - 1. No table and no one-hot
// (its single nonzero term per lane is a copy). Bound by fp32 operations
// like K1: 24 a (combo, bar) with one IEEE division, of which the SMA's
// sub and div could be shared by the lanes of one window.
//
// Built without fast math and with -fmad=false: the SMA division and sqrtf
// stay IEEE round-to-nearest, so table values equal the reference's, and no
// multiply-add is contracted, so the epilogue rounds as the plain PyTorch
// version does.

#include "metrics_tail.cuh"

namespace {

constexpr int kThreads = 128;
// Stage cs and r in shared memory up to this many bytes per CTA (both rows:
// T <= 12288 bars); longer histories read through the read-only cache.
constexpr size_t kMaxStagedBytes = 96 * 1024;

__device__ __forceinline__ float sma_at(const float* cs, int t, int w,
                                        float fw) {
  if (t < w - 1) return 0.f;
  const float lag = t >= w ? cs[t - w] : 0.f;
  return (cs[t] - lag) / fw;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) fused_sma_kernel(
    const float* __restrict__ cs, const float* __restrict__ r,
    const int* __restrict__ t_real, const int* __restrict__ fast,
    const int* __restrict__ slow, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int P, float cost, float ppy) {
  extern __shared__ float staged[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const float* cs_row = cs + static_cast<size_t>(n) * T;
  const float* r_row = r + static_cast<size_t>(n) * T;
  if (kStaged) {
    for (int t = threadIdx.x; t < tr; t += kThreads) {
      staged[t] = cs_row[t];
      staged[T + t] = r_row[t];
    }
    __syncthreads();
    cs_row = staged;
    r_row = staged + T;
  }
  if (p >= P) return;

  const int fw = fast[p];
  const int sw = slow[p];
  const float ffw = static_cast<float>(fw);
  const float fsw = static_cast<float>(sw);
  const int t_on = warm[p] - 1;

  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) {
      pos = dbx::sign_of(sma_at(cs_row, t, fw, ffw) -
                         sma_at(cs_row, t, sw, fsw));
    }
    acc.step(pos, r_row[t], cost);
  }
  acc.store(out, n, p, N, P, tr, ppy);
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

// C entry point (loaded with ctypes). Pointers are device pointers:
// cs, r: (N, T) f32; t_real: (N,) i32; fast, slow, warm: (P,) i32 (rounded
// windows and the truncated max(fast, slow) warmup); out: (9, N, P) f32.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int dbx_fused_sma(const void* cs, const void* r,
                             const void* t_real, const void* fast,
                             const void* slow, const void* warm, void* out,
                             int N, int T, int P, float cost, int ppy,
                             void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(N, (P + kThreads - 1) / kThreads);
  const size_t smem = 2 * static_cast<size_t>(T) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a_cs = static_cast<const float*>(cs);
  const auto* a_r = static_cast<const float*>(r);
  const auto* a_tr = static_cast<const int*>(t_real);
  const auto* a_f = static_cast<const int*>(fast);
  const auto* a_s = static_cast<const int*>(slow);
  const auto* a_w = static_cast<const int*>(warm);
  auto* a_out = static_cast<float*>(out);
  if (smem <= kMaxStagedBytes) {
    const int err = dbx::allow_smem(fused_sma_kernel<true>, smem);
    if (err != 0) return err;
    fused_sma_kernel<true><<<grid, kThreads, smem, s>>>(
        a_cs, a_r, a_tr, a_f, a_s, a_w, a_out, N, T, P, cost,
        static_cast<float>(ppy));
  } else {
    fused_sma_kernel<false><<<grid, kThreads, 0, s>>>(
        a_cs, a_r, a_tr, a_f, a_s, a_w, a_out, N, T, P, cost,
        static_cast<float>(ppy));
  }
  return static_cast<int>(cudaGetLastError());
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
