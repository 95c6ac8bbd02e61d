// The pairs trade's tables on the card for Hopper (sm_90a): the spread
// z-table and the hedged-return table that K7 (dbx_pairs, band_machine.cu)
// reads.
//
// Replaces the table prep of the reference's TPU kernel,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_fused_pairs_call`
// (:1482) builds, before its `pallas_call` (:1582), the rolling OLS of y on
// x per distinct lookback from the legs' centred windowed moments, the
// spread, its z-score over the same lookback and the hedged return
// (:1499-1580). The port's torch version of that prep, ops/fused.py
// `pairs_tables`, makes about 17 (N, W, T) intermediates of 50 MB each at
// the bench shape (1000 pairs x 10 lookbacks x 1260 bars), with seven
// cumsums and a gather per windowed sum.
//
// Design.
// - The sums. A windowed sum is c[t] - c[t-w] of a prefix sum c, as in the
//   reference. In f32 that difference cancels: c grows with t, the window
//   sum does not, and the windowed variance cancels once more (sxx - sx *
//   sx / w). So every prefix sum is kept in f64, taken sequentially along
//   the row (torch's CUDA cumsum splits a row by the tensor's row count, so
//   no kernel can repeat its order, and a sequential chain is one that the
//   plain version repeats), and every windowed sum is the f64 difference
//   c[t] - c[t-w] rounded once to f32. All the rest is the f32 formula of
//   `pairs_tables`. The generic path run in f64 is the witness this is held
//   to (chip_smoke.py).
// - A sum is a chain of T dependent f64 adds a row, each with a conversion
//   in and one out; a conversion costs a warp instruction whatever lanes
//   run it, so the chains run few to a warp, on warps 0-3 (one a scheduler).
// - So one CTA per pair and group of up to 10 lookbacks (all 10 of the
//   bench grid at T = 1260). The four legs' sums (x, y, x x and x y, the
//   legs centred by their means) run on four warps and keep their f64
//   prefix rows, from which a parallel pass takes every lookback's OLS and
//   spread. The three sums of every lookback's spread (its own, and those
//   of the spread centred by its mean and of that squared) run on four
//   warps together, each chain carrying its prefix sum and the same sum w
//   bars behind, so it writes its f32 window sums and keeps no f64 row.
//   Everything between the legs and the two output rows stays in shared
//   memory (at the bench shape 200 KB, one CTA an SM): the legs' prefix
//   rows and centred legs share their space with the spreads' last two sum
//   rows, which are written after the legs' rows are done. The hedge ratios
//   wait in the spread's first sum row for the hedged returns, which take
//   the bar before's. Only z and hr are written to device memory. Rows too
//   long for the staging budget run the same code on device-memory scratch
//   that the wrapper allocates (kStaged false).
// - The spread's mean over the T bars, which centres its moments, is taken
//   in a fixed order that the plain version (`pairs_tables_plain`,
//   `lane_tree_mean`) repeats: lane l of a warp sums the bars l, l + 32,
//   ... in f64 (0 past T), the 32 sums fold in a fixed tree (l + 16, then
//   l + 8, ...), and the total is divided by T in f64 and rounded to f32.
// - The legs' means come in from torch ((N,) each, formed before the
//   launch), as the plain version takes them.
// - Every other value is the formula of `pairs_tables`, evaluated left to
//   right as torch does ((sx * sy) / fw, and alpha = (sy / fw + my) -
//   beta * (sx / fw + mx)), one thread a (lookback, bar).
//
// What bounds it on this card: the two tables it writes, 8 B a (pair,
// lookback, bar), 101 MB at the bench shape, 30 us at 3.35 TB/s; its
// operations (39 fp32 and 22 fp64 a (pair, lookback, bar)) take about
// 32 us at those rates. In practice the sequential chains take about half
// its time and the parallel passes the rest, at one CTA an SM; a chain's
// reads must stay ahead of its adds and off branches, or each bar waits on
// a shared-memory read.
//
// Built without fast math and with -fmad=false: the divisions and the
// square root are IEEE round-to-nearest and nothing is contracted, so every
// value rounds as the torch ops of the plain version.

#include "metrics_tail.cuh"

namespace {

constexpr int kThreads = 1024;
// Lookbacks a CTA at most: their spreads' three sums fit 32 lanes.
constexpr int kMaxGroup = 10;
constexpr size_t kMaxStagedBytes = 226 * 1024;
// The warps that run the chains, one a scheduler.
constexpr int kChainWarps = 4;

// The stride of a CTA's f32 rows: T rounded up to 1 more than a multiple
// of 32, so that row r starts r banks on.
__host__ __device__ inline int pitch(int T) {
  return T + (33 - T % 32) % 32;
}

// Floats of a CTA's first region at row length T and G lookbacks: the
// legs' four f64 prefix rows and two centred f32 legs, which the last two
// sum rows of every lookback's spread take over later.
__host__ __device__ inline size_t shared_floats(int T, int G) {
  const size_t legs = 8 * static_cast<size_t>(T) + 2 * pitch(T);
  const size_t sums = 2 * static_cast<size_t>(G) * pitch(T);
  return legs > sums ? legs : sums;
}

// Floats of shared memory (or scratch) of a CTA of G lookbacks at row
// length T: the first region, then each lookback's spread and first sum
// row; a multiple of 32, so every CTA's scratch starts 128-byte aligned.
__host__ __device__ inline size_t cta_floats(int T, int G) {
  const size_t n = shared_floats(T, G) + 2 * static_cast<size_t>(G) * pitch(T);
  return (n + 31) / 32 * 32;
}

// Lookbacks a CTA takes out of W at row length T (*group), and the floats
// of scratch it needs (*scratch, 0 where it is staged in shared memory).
inline void plan(int T, int W, int* group, int* scratch) {
  int g = W < kMaxGroup ? W : kMaxGroup;
  while (g > 1 && cta_floats(T, g) * sizeof(float) > kMaxStagedBytes) --g;
  if (cta_floats(T, g) * sizeof(float) <= kMaxStagedBytes) {
    *group = g;
    *scratch = 0;
  } else {
    *group = W < kMaxGroup ? W : kMaxGroup;
    *scratch = static_cast<int>(cta_floats(T, *group));
  }
}

// The running f64 sum c of value(t) over the bars t < T and, with kLag,
// the same sum w bars behind (c[t - w], 0 for t < w: the same adds in the
// same order, so it equals c[t - w] bit for bit); emit(t, c[t], c[t - w])
// at every bar. Whole blocks of kChunk bars run unchecked, the values of
// the next block read before this block's sums and without a branch (past
// the row a read is clamped to its last bar and unused), so the chain is
// the f64 adds alone; the last T % kChunk bars follow one at a time.
template <bool kLag, class Value, class Emit>
__device__ void running_sum(Value value, Emit emit, int T, int w) {
  constexpr int kChunk = 8;
  const int whole = T - T % kChunk;
  const auto lead_at = [&](int t) { return value(min(t, T - 1)); };
  const auto lag_at = [&](int t) {
    const float u = value(min(max(t - w, 0), T - 1));
    return t >= w ? u : 0.f;
  };
  float v[kChunk];
  float u[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    v[k] = lead_at(k);
    if (kLag) u[k] = lag_at(k);
  }
  double lead = 0.0;
  double lag = 0.0;
  for (int t0 = 0; t0 < whole; t0 += kChunk) {
    float next[kChunk];
    float next_u[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      next[k] = lead_at(t0 + kChunk + k);
      if (kLag) next_u[k] = lag_at(t0 + kChunk + k);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      lead += static_cast<double>(v[k]);
      if (kLag) lag += static_cast<double>(u[k]);
      emit(t0 + k, lead, lag);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      v[k] = next[k];
      if (kLag) u[k] = next_u[k];
    }
  }
  for (int t = whole; t < T; ++t) {
    lead += static_cast<double>(value(t));
    if (kLag) lag += static_cast<double>(lag_at(t));
    emit(t, lead, lag);
  }
}

// The mean of row `s` over its T bars in the fixed order above, on the 32
// lanes of one warp (every lane gets it).
__device__ float lane_tree_mean(const float* s, int T) {
  const int lane = threadIdx.x % 32;
  double acc = 0.0;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    acc += t < T ? static_cast<double>(s[t]) : 0.0;
  }
  for (int off = 16; off >= 1; off /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  return __double2float_rn(__shfl_sync(0xffffffffu, acc, 0) / T);
}

// The window sum ending at bar t of the f64 prefix row c: c[t] - c[t-w]
// (0 for t < w) in f64, rounded to f32.
__device__ __forceinline__ float window_sum(const double* c, int t, int w) {
  return __double2float_rn(c[t] - (t >= w ? c[t - w] : 0.0));
}

struct Ols {
  float beta, alpha;
};

// The rolling OLS of y on x at bar t from the f64 prefix rows of the
// centred legs and of their products: c + 0 x, 1 y, 2 x x, 3 x y.
__device__ __forceinline__ Ols ols_at(const double* c, int T, int t, int w,
                                      float fw, float mx, float my) {
  const float sx = window_sum(c, t, w);
  const float sy = window_sum(c + T, t, w);
  const float sxx = window_sum(c + 2 * static_cast<size_t>(T), t, w);
  const float sxy = window_sum(c + 3 * static_cast<size_t>(T), t, w);
  const float cov = sxy - sx * sy / fw;
  const float var = dbx::max_nan(sxx - sx * sx / fw, 0.f);
  const float beta = cov / (var + dbx::kEps);
  return {beta, (sy / fw + my) - beta * (sx / fw + mx)};
}

// One CTA: pair n, lookbacks w0 .. w0 + g - 1 of `windows` (G a CTA, the
// last group of a pair may hold fewer).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads) pairs_tables_kernel(
    const float* __restrict__ y, const float* __restrict__ x,
    const float* __restrict__ mx, const float* __restrict__ my,
    const int* __restrict__ windows, float* __restrict__ z,
    float* __restrict__ hr, float* __restrict__ scratch, int T, int W,
    int G) {
  extern __shared__ __align__(16) float staged[];
  __shared__ float means[kMaxGroup];
  const int groups = (W + G - 1) / G;
  const int n = blockIdx.x / groups;
  const int w0 = (blockIdx.x % groups) * G;
  const int g = min(G, W - w0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Chain i runs on lane i / kChainWarps of warp i % kChainWarps.
  const int chain = lane * kChainWarps + warp;
  const bool chain_warp = warp < kChainWarps;
  const int P = pitch(T);
  const float mxn = mx[n];
  const float myn = my[n];
  const float* yr = y + static_cast<size_t>(n) * T;
  const float* xr = x + static_cast<size_t>(n) * T;
  float* buf = kStaged ? staged : scratch + blockIdx.x * cta_floats(T, G);
  // The first region: the legs' f64 prefix rows, then the centred legs;
  // later the last two sum rows of each lookback's spread.
  double* c = reinterpret_cast<double*>(buf);
  float* xc = buf + 8 * static_cast<size_t>(T);
  float* yc = xc + P;
  float* const second = buf + shared_floats(T, G);
  // Lookback j's rows: its spread; the window sums of the spread (the
  // hedge ratio's row before them), of the centred spread and of its
  // square.
  const auto spread = [&](int j) {
    return second + j * static_cast<size_t>(P);
  };
  const auto sum_row = [&](int j, int k) {
    return k == 0 ? second + (G + j) * static_cast<size_t>(P)
                  : buf + (2 * j + k - 1) * static_cast<size_t>(P);
  };
  // f(j, t) for every (lookback, bar) of the CTA, its threads on
  // consecutive bars.
  const auto each = [&](auto f) {
    int j = threadIdx.x / T;
    int t = threadIdx.x % T;
    while (j < g) {
      f(j, t);
      for (t += kThreads; t >= T; t -= T) ++j;
    }
  };

  // The centred legs, then the prefix sums of them and of their products.
  for (int t = threadIdx.x; t < T; t += kThreads) {
    xc[t] = xr[t] - mxn;
    yc[t] = yr[t] - myn;
  }
  __syncthreads();
  if (chain_warp && chain < 4) {
    // x, y, x x, x y.
    const float* a = chain == 1 ? yc : xc;
    const float* b = chain == 3 ? yc : xc;
    const bool product = chain >= 2;
    double* out = c + chain * static_cast<size_t>(T);
    running_sum<false>(
        [=](int t) {
          const float va = a[t];
          const float vb = b[t];
          return product ? va * vb : va;
        },
        [=](int t, double lead, double) { out[t] = lead; }, T, 0);
  }
  __syncthreads();

  // Each lookback's spread, and its hedge ratio (0 during the OLS warmup
  // t < w - 1) in the row of the spread's first window sum.
  each([&](int j, int t) {
    const int w = windows[w0 + j];
    const Ols o = ols_at(c, T, t, w, static_cast<float>(w), mxn, myn);
    const bool ok = t >= w - 1;
    spread(j)[t] = ok ? yr[t] - (o.alpha + o.beta * xr[t]) : yr[t];
    sum_row(j, 0)[t] = ok ? o.beta : 0.f;
  });
  __syncthreads();

  // The spreads' means, warp j for lookback j, and the hedged returns on
  // the hedge ratio of the bar before (0 before bar 0).
  if (warp < g) {
    const float m = lane_tree_mean(spread(warp), T);
    if (lane == 0) means[warp] = m;
  }
  each([&](int j, int t) {
    const float bp = t > 0 ? sum_row(j, 0)[t - 1] : 0.f;
    const int tp = t > 0 ? t - 1 : 0;
    const float ry = yr[t] / yr[tp] - 1.f;
    const float rx = xr[t] / xr[tp] - 1.f;
    hr[(static_cast<size_t>(n) * W + w0 + j) * T + t] =
        (ry - bp * rx) / dbx::max_nan(1.f + fabsf(bp), 1.f);
  });
  __syncthreads();

  // The window sums of each spread (k 0), of the spread centred by its
  // mean (k 1) and of that squared (k 2), one chain each.
  if (chain_warp && chain < 3 * g) {
    const int j = chain / 3;
    const int k = chain % 3;
    const float* sp = spread(j);
    const float m = means[j];
    float* out = sum_row(j, k);
    running_sum<true>(
        [=](int t) {
          const float s = sp[t];
          const float sc = s - m;
          return k == 0 ? s : k == 1 ? sc : sc * sc;
        },
        [=](int t, double lead, double lag) {
          out[t] = __double2float_rn(lead - lag);
        },
        T, windows[w0 + j]);
  }
  __syncthreads();

  // z from bar 2w - 2 on (the OLS warmup, then the z-score's).
  each([&](int j, int t) {
    const int w = windows[w0 + j];
    const float fw = static_cast<float>(w);
    const float mz = sum_row(j, 0)[t] / fw;
    const float s1 = sum_row(j, 1)[t];
    const float s2 = sum_row(j, 2)[t];
    const float varz = dbx::max_nan((s2 - s1 * s1 / fw) / fw, 0.f);
    const float zt = (spread(j)[t] - mz) / (sqrtf(varz) + dbx::kEps);
    z[(static_cast<size_t>(n) * W + w0 + j) * T + t] =
        t >= 2 * w - 2 ? zt : 0.f;
  });
}

}  // namespace

// dbx_pairs_tables_plan: info[0], the lookbacks a CTA of dbx_pairs_tables
// takes at row length T out of W; info[1], the floats of device-memory
// scratch each of its N * ceil(W / info[0]) CTAs needs, 0 where they stage
// their rows in shared memory.
extern "C" int dbx_pairs_tables_plan(int T, int W, int* info) {
  if (T <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  plan(T, W, &info[0], &info[1]);
  return static_cast<int>(cudaSuccess);
}

// dbx_pairs_tables: y, x (N, T) f32 close legs; mx, my (N,) f32 their means
// over the T bars; windows (W,) i32 distinct lookbacks (each at least 1);
// z, hr (N, W, T) f32 out: the spread z-table and the hedged-return table;
// scratch: as dbx_pairs_tables_plan says, else unused. Pointers are device
// pointers. Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int dbx_pairs_tables(const void* y, const void* x, const void* mx,
                                const void* my, const void* windows, void* z,
                                void* hr, void* scratch, int N, int T, int W,
                                void* stream) {
  if (N <= 0 || W <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  int G = 0;
  int per_cta = 0;
  plan(T, W, &G, &per_cta);
  const unsigned ctas =
      static_cast<unsigned>(N) * static_cast<unsigned>((W + G - 1) / G);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const float*>(y);
  const auto* xp = static_cast<const float*>(x);
  const auto* mxp = static_cast<const float*>(mx);
  const auto* myp = static_cast<const float*>(my);
  const auto* wp = static_cast<const int*>(windows);
  auto* zp = static_cast<float*>(z);
  auto* hp = static_cast<float*>(hr);
  if (per_cta == 0) {
    const size_t smem = cta_floats(T, G) * sizeof(float);
    const int err = dbx::allow_smem(pairs_tables_kernel<true>, smem);
    if (err != 0) return err;
    pairs_tables_kernel<true><<<ctas, kThreads, smem, s>>>(
        yp, xp, mxp, myp, wp, zp, hp, nullptr, T, W, G);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    pairs_tables_kernel<false><<<ctas, kThreads, 0, s>>>(
        yp, xp, mxp, myp, wp, zp, hp, static_cast<float*>(scratch), T, W,
        G);
  }
  return static_cast<int>(cudaGetLastError());
}
