// Fused SMA-crossover sweep for Hopper (sm_90a): K1 of the port.
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
// - One sequential pass per thread over t < t_real[ticker] carries prev,
//   s1, s2, the downside square sum, cumulative net, running peak, mdd,
//   wins, active bars and turnover. It replaces both the "scan" and the
//   "ladder" epilogues of the TPU kernel. Bars at or past t_real contribute
//   nothing, which equals the reference holding the last position through
//   repeat-last padding.
// - Output: (9, N, P) f32 in the reference's `_metrics_pack` order and
//   formulas. The wrapper allocates it; the kernel allocates nothing.
//
// What bounds it: fp32 arithmetic outside the tensor cores, about 30
// operations per (combo, bar) including two IEEE divisions. Bytes are
// negligible: two input rows per ticker and 36 MB of output for the
// headline 500 x 2000 sweep. Making it fast (sharing SMA values across the
// lanes of one window, fewer divisions) is later work.
//
// Built without fast math and with -fmad=false: the SMA division and sqrtf
// stay IEEE round-to-nearest, so table values equal the reference's, and no
// multiply-add is contracted, so the epilogue rounds as the plain PyTorch
// version does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-12f;
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

  float prev = 0.f, s1 = 0.f, s2 = 0.f, dsq = 0.f, cum = 0.f;
  float peak = -INFINITY, mdd = 0.f, wins = 0.f, active = 0.f, turn = 0.f;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) {
      const float d = sma_at(cs_row, t, fw, ffw) - sma_at(cs_row, t, sw, fsw);
      // jnp.sign: +-1, and d itself for +-0 (and NaN).
      pos = d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
    }
    const float dp = fabsf(pos - prev);
    const float net = prev * r_row[t] - cost * dp;
    s1 += net;
    s2 += net * net;
    const float down = fminf(net, 0.f);
    dsq += down * down;
    cum += net;
    const float eq = 1.f + cum;
    peak = fmaxf(peak, eq);
    mdd = fmaxf(mdd, (peak - eq) / fmaxf(peak, kEps));
    if (prev != 0.f) {
      active += 1.f;
      if (net > 0.f) wins += 1.f;
    }
    turn += dp;
    prev = pos;
  }

  const float nf = static_cast<float>(tr);
  const float mean = s1 / nf;
  const float sd = sqrtf(fmaxf(s2 / nf - mean * mean, 0.f));
  const float dstd = sqrtf(dsq / nf);
  const float ann = sqrtf(ppy);
  const float eq_final = 1.f + cum;
  const float years = fmaxf(nf / ppy, kEps);
  const size_t plane = static_cast<size_t>(N) * P;
  float* o = out + static_cast<size_t>(n) * P + p;
  o[0 * plane] = mean / (sd + kEps) * ann;                    // sharpe
  o[1 * plane] = mean / (dstd + kEps) * ann;                  // sortino
  o[2 * plane] = mdd;                                         // max_drawdown
  o[3 * plane] = eq_final - 1.f;                              // total_return
  o[4 * plane] = powf(fmaxf(eq_final, kEps), 1.f / years) - 1.f;  // cagr
  o[5 * plane] = sd * ann;                                    // volatility
  o[6 * plane] = wins / (active + kEps);                      // hit_rate
  o[7 * plane] = 0.5f * turn;                                 // n_trades
  o[8 * plane] = turn;                                        // turnover
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
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          fused_sma_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
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
