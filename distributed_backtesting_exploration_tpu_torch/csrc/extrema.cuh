// Channel extrema on the card: the sparse-table range query that K2's
// stochastic entry (band_machine.cu) and K3's donchian entry
// (single_window.cu) build per ticker, so that no (N, W, T) channel, %K or
// breakout-sign table is written to device memory.
//
// Replaces the reference's `_extrema_table` and the in-VMEM build of
// `_don_kernel_inline` (distributed_backtesting_exploration_tpu/ops/fused.py):
// level[0] = x, level[j][t] = op(level[j-1][t], level[j-1][t - 2^(j-1)])
// with the neutral value (-inf for max, +inf for min) before the shift, so
// level[j][t] = op(x[t - 2^j + 1 .. t]); a window w is then
// op(level[kk][t], level[kk][t - (w - 2^kk)]) with 2^kk the largest power of
// two <= w. This is the port's `_extrema_rows` (ops/fused.py) op for op.
// Max and min of raw prices are exact, so the channel equals the torch rows
// bit for bit; both use a max and min that propagate NaN, as torch.maximum
// and torch.minimum do (fmaxf and fminf drop a NaN).
//
// Layout: a ticker's levels of one side are (L + 1) rows of T floats, level
// j at offset j * T, in shared memory (built here by the CTA) or in device
// memory (built by the wrapper with torch ops when they do not fit). Which
// of the two, and L, follow from T alone (channel_staged, channel_levels),
// and the wrapper asks this header's dbx_channel_levels rather than
// keeping its own copy of the rule.

#pragma once

#include <cuda_runtime.h>

namespace dbx {

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Levels 1..L of both sides in place, from level 0 already in lev_hi and
// lev_lo, over the bars t < tr (the only ones a lane reads). op(x, neutral)
// is x, so a bar before the shift copies its level below. One
// __syncthreads() after each level; the caller syncs before level 1.
__device__ __forceinline__ void build_levels(float* lev_hi, float* lev_lo,
                                             int T, int tr, int L) {
  for (int j = 1; j <= L; ++j) {
    const int s = 1 << (j - 1);
    const float* hi_in = lev_hi + (j - 1) * T;
    const float* lo_in = lev_lo + (j - 1) * T;
    float* hi_out = lev_hi + j * T;
    float* lo_out = lev_lo + j * T;
    for (int t = threadIdx.x; t < tr; t += blockDim.x) {
      const bool in = t >= s;
      hi_out[t] = in ? nan_max(hi_in[t], hi_in[t - s]) : hi_in[t];
      lo_out[t] = in ? nan_min(lo_in[t], lo_in[t - s]) : lo_in[t];
    }
    __syncthreads();
  }
}

// One lane's window on a ticker's levels: high(t) and low(t) are the
// rolling max of the high source and min of the low source over
// [t - w + 1, t] (the neutral value stands in for bars before 0).
struct Channel {
  const float* hi;  // level kk of the high side
  const float* lo;  // level kk of the low side
  int s;            // w - 2^kk

  __device__ __forceinline__ Channel(const float* lev_hi,
                                     const float* lev_lo, int T, int w) {
    const int kk = 31 - __clz(w);
    hi = lev_hi + static_cast<size_t>(kk) * T;
    lo = lev_lo + static_cast<size_t>(kk) * T;
    s = w - (1 << kk);
  }

  __device__ __forceinline__ float high(int t) const {
    const float a = hi[t];
    return t >= s ? nan_max(a, hi[t - s]) : a;
  }

  __device__ __forceinline__ float low(int t) const {
    const float a = lo[t];
    return t >= s ? nan_min(a, lo[t - s]) : a;
  }
};

// Shared-memory layout of a ticker staged for a channel entry: the close
// and returns rows, then the high and low levels, (2 + 2 (L + 1)) rows of
// T floats.
struct StagedChannel {
  const float* close;
  const float* r;
  float* lev_hi;
  float* lev_lo;
};

// Shared memory one CTA may take on the H100 (the opt-in maximum).
constexpr size_t kMaxSmem = 227 * 1024;

// Doubling levels above the rows at row length T: floor(log2 T), which
// covers every window that fills a bar below T (a longer window is all
// warmup fill).
inline int channel_levels(int T) {
  int L = 0;
  while (L < 30 && (2 << L) <= T) ++L;
  return L;
}

inline size_t channel_smem_bytes(int T) {
  return (2 + 2 * static_cast<size_t>(channel_levels(T) + 1)) * T *
         sizeof(float);
}

// Whether a channel entry stages its rows and builds its levels in shared
// memory at row length T; else its caller passes the levels in device
// memory.
inline bool channel_staged(int T) { return channel_smem_bytes(T) <= kMaxSmem; }

// Stage one ticker's close, returns, high source and low source rows (bars
// t < tr) in `smem` and build its levels: only those the CTA's windows read
// (up to the largest power of two <= min(its largest window, tr); a longer
// window has no full span below tr), at most L. Every thread of the CTA
// calls it; `slot` is the thread's lane slot, valid below P.
__device__ __forceinline__ StagedChannel stage_channel(
    float* smem, const float* close, const float* r, const float* hi_src,
    const float* lo_src, const int* window, int slot, int P, int T, int tr,
    int L) {
  float* s_c = smem;
  float* s_r = smem + T;
  float* s_hi = smem + 2 * static_cast<size_t>(T);
  float* s_lo = s_hi + static_cast<size_t>(L + 1) * T;
  __shared__ int w_top;
  if (threadIdx.x == 0) w_top = 1;
  __syncthreads();
  if (slot < P) atomicMax(&w_top, min(window[slot], tr));
  for (int t = threadIdx.x; t < tr; t += blockDim.x) {
    s_c[t] = close[t];
    s_r[t] = r[t];
    s_hi[t] = hi_src[t];
    s_lo[t] = lo_src[t];
  }
  __syncthreads();
  build_levels(s_hi, s_lo, T, tr, min(31 - __clz(w_top), L));
  return {s_c, s_r, s_hi, s_lo};
}

}  // namespace dbx

// dbx_channel_levels: the levels above the rows, L, of the (N, L + 1, T)
// level tensors a caller passes to this library's channel entry at row
// length T, or -1 when the entry builds its levels in shared memory and
// takes none. Each library that includes this header exports it.
extern "C" int dbx_channel_levels(int T) {
  return dbx::channel_staged(T) ? -1 : dbx::channel_levels(T);
}
