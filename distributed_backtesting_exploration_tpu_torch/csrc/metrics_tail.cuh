// Per-bar PnL and the 9-metric epilogue shared by every kernel of the port.
//
// Replaces the shared tail of the reference's TPU kernels,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_metrics_tail` and
// `_metrics_pack` (with `_equity_scan` for the running peak and drawdown).
// There the tail runs as a scan or ladder over (T_pad, lanes) tiles; here
// each thread owns one (ticker, combo) lane and carries the running sums
// through one sequential pass over the bars, so one struct serves every
// kernel and every kernel rounds its metrics in the same order.
//
// Step order per bar (the plain PyTorch versions in ops/fused.py,
// `_MetricState`, repeat it op for op): position change, net return,
// moment sums, downside square sum, equity, running peak, drawdown, active
// and winning bars, turnover. The equity is 1 + s1: the plain version's
// cumulative net and its s1 are one sum, the same bits. Built with
// -fmad=false, so no multiply-add is contracted and each operation rounds
// once, as the plain version's tensor ops do.
//
// The drawdown quotient (peak - eq) / max(peak, eps) is an IEEE division,
// and it can raise mdd only on a bar that sets a new maximum drawdown. So
// step tests each bar with one explicit fused multiply-add, f = mdd * pk -
// d rounded once (-fmad=false does not touch an explicit fmaf): where f's
// sign bit is clear and f is no NaN, the exact mdd * pk - d is >= 0, so
// d / pk <= mdd, its rounding too, and max(mdd, d / pk) is mdd; the
// division runs only on the other bars (negative, -0 from an underflow,
// NaN). The sign bit is the test, not f < 0, because a tiny negative that
// underflows to -0 is not < 0.
//
// NaN propagates as in the plain versions: torch.maximum, clamp_min and
// clamp_max return NaN where an operand is NaN, where fmaxf and fminf
// return the other operand, so the update's and the epilogue's max and min
// are max.NaN and min.NaN. On numbers they equal fmaxf and fminf bit for
// bit: no max here sees +0 beside -0 (equity is never -0, and so no peak,
// drawdown or quotient is), and the one min that may, min(net, 0) at net =
// -0, is squared at once.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dbx {

constexpr float kEps = 1e-12f;

// jnp.sign: +-1, and d itself for +-0 (and NaN).
__device__ __forceinline__ float sign_of(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
}

// max(a, b) and min(a, b), NaN if either is NaN (torch.maximum's and
// torch.minimum's rule; see the note above).
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

struct MetricsAcc {
  float prev = 0.f, s1 = 0.f, s2 = 0.f, dsq = 0.f;
  float peak = -INFINITY, mdd = 0.f, wins = 0.f, active = 0.f, turn = 0.f;

  // One bar: `pos` is the position decided at this bar's close, `r` the
  // bar's simple return, earned by the previous position.
  __device__ __forceinline__ void step(float pos, float r, float cost) {
    const float dp = fabsf(pos - prev);
    const float net = prev * r - cost * dp;
    s1 += net;
    s2 += net * net;
    const float down = min_nan(net, 0.f);
    dsq += down * down;
    const float eq = 1.f + s1;
    peak = max_nan(peak, eq);
    const float d = peak - eq;
    const float pk = max_nan(peak, kEps);
    if (__float_as_uint(fmaf(mdd, pk, -d)) > 0x7f800000u) {
      mdd = max_nan(mdd, d / pk);
    }
    const float act = prev != 0.f ? 1.f : 0.f;
    active += act;
    wins += net > 0.f ? act : 0.f;
    turn += dp;
    prev = pos;
  }

  // The 9 metrics of lane (n, p) after `tr` bars into out (9, N, P), in the
  // reference's `_metrics_pack` order and formulas.
  __device__ __forceinline__ void store(float* out, int n, int p, int N,
                                        int P, int tr, float ppy) const {
    const float nf = static_cast<float>(tr);
    const float mean = s1 / nf;
    const float sd = sqrtf(max_nan(s2 / nf - mean * mean, 0.f));
    const float dstd = sqrtf(dsq / nf);
    const float ann = sqrtf(ppy);
    const float eq_final = 1.f + s1;
    const float years = fmaxf(nf / ppy, kEps);
    const size_t plane = static_cast<size_t>(N) * P;
    float* o = out + static_cast<size_t>(n) * P + p;
    o[0 * plane] = mean / (sd + kEps) * ann;                    // sharpe
    o[1 * plane] = mean / (dstd + kEps) * ann;                  // sortino
    o[2 * plane] = mdd;                                         // max_drawdown
    o[3 * plane] = eq_final - 1.f;                              // total_return
    o[4 * plane] = powf(max_nan(eq_final, kEps), 1.f / years) - 1.f;  // cagr
    o[5 * plane] = sd * ann;                                    // volatility
    o[6 * plane] = wins / (active + kEps);                      // hit_rate
    o[7 * plane] = 0.5f * turn;                                 // n_trades
    o[8 * plane] = turn;                                        // turnover
  }
};

// Raise a kernel's dynamic shared memory limit above the default 48 KB
// where `smem` needs it. Returns a cudaError_t as an int.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return static_cast<int>(cudaSuccess);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace dbx
