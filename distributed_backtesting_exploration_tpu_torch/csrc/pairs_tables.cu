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
// The sums. A windowed sum is c[t] - c[t-w] of a prefix sum c, as in the
// reference. In f32 that difference cancels: c grows with t, the window sum
// does not, and the windowed variance cancels once more (sxx - sx * sx /
// w). So every prefix sum is kept in f64, taken sequentially along the row
// (a chain of T dependent adds, each with a conversion in), and every
// windowed sum is the f64 difference c[t] - c[t-w] rounded once to f32. The
// lag c[t-w] is a second chain over the same values w bars behind (0 below
// w): the same adds in the same order, so the same bits. All the rest is
// the f32 formula of `pairs_tables`. The plain version, ops/fused.py
// `pairs_tables_plain` (`seq_cumsum`, `lane_tree_mean`), repeats every
// order, so the two are bit-equal; the generic path run in f64 is the
// witness both are held to (chip_smoke.py).
//
// What bounds it on this card: the two tables it writes, 8 B a (pair,
// lookback, bar), 101 MB at the bench shape, 30 us at 3.35 TB/s; its
// operations (39 fp32 and 22 fp64 a (pair, lookback, bar)) take about
// 32 us. Beside them runs work that the bound does not count, at a quarter
// of the fp32 rate: 14 f32 <-> f64 conversions a (pair, lookback, bar) (16
// an SM a clock: the CUDA C Programming Guide's throughput table for
// compute capability 9.0) and 11 IEEE divisions (each a reciprocal and a
// range check at that rate, five FMAs and a branch). What held
// the earlier design (one CTA a pair, 200 KB of shared memory, one CTA an
// SM) far above the bound: its 34 chains a pair ran on 1-8 lanes of four
// warps while 28 warps waited at a barrier, and a chain's conversion and
// add issue as a warp instruction however few lanes are live.
//
// This design puts every chain on a full warp, by row: lane i sums row i of
// 32 rows of one kind, so each conversion and add serves 32 chains. Three
// launches, each with as many warps as it has rows:
// 1. legs: 8 pairs a CTA. Warp 0 is the chains, lane kind x 8 + pair: the
//    prefix sums of the centred legs x, y and of x x and x y (4 f64 rows
//    a pair) into the pair's own slice of the z table where it has room
//    (W >= 8; launch 2 reads them before it writes the spread there), else
//    into device-memory scratch. Warps 1-3 bring the legs'
//    bars in up to seven tiles of 32 ahead (cp.async), form the next tile's
//    values and write the last tile's sums out, one barrier a tile, so the
//    adds never wait on device memory.
// 2. spread and hedged returns: one CTA a pair, its four prefix rows and
//    the legs' returns staged in shared memory (T <= 3072), one warp a
//    (pair, lookback) row, lane on bar. The rolling OLS from the rows'
//    window sums, the spread (into the z table, where launch 3 turns it
//    into z), the hedged return on the hedge ratio of the bar before (a
//    shuffle from the lane below; 0 before bar 0 and in the OLS warmup),
//    and the spread's mean over the T bars in the fixed order that
//    `lane_tree_mean` repeats: lane l sums the bars l, l + 32, ... in f64
//    (0 past T), the 32 sums fold in a fixed tree (l + 16, then l + 8,
//    ...), and the total over T in f64 rounds to f32.
// 3. sums and z: 32 (pair, lookback) rows a CTA, three CTAs an SM. Warps
//    0-2 are the chains, lane on row, one warp for each of the spread's
//    three sums (its own, and those of the spread centred by its mean and
//    of that squared), each lane a lead and a lag chain over a tile of 32
//    bars. Warps 3-7, lane on bar, meanwhile form z for the tile before
//    from its three sums and write it over the spread, store the next tile
//    (loaded a tile ahead, coalesced) into a ring of tiles in shared
//    memory, and gather from the ring the next tile's lags, w bars behind
//    each row. Every tile is on a skewed pitch (row i starts i banks on),
//    so a lane walking its row and a lane on its bar both touch 32 banks;
//    chains read each half tile into registers first, so their adds run
//    back to back. The ring holds ceil(w_max / 32) + 1 tiles or more (a
//    power of two, at least 4).
// Only z and hr are (N, W, T). Where the longest lookback is longer than
// the ring can hold (480 bars), the lags are read from device memory
// instead, so the spread stays in the hr table until z is written, and a
// fourth launch forms the hedged returns (one CTA a pair, the hedge ratio
// of the bar before formed again from the prefix rows, kept in scratch).
//
// chip_smoke.py prints each launch's time at the bench shape (PERF.md): the
// spread and sums launches take most of it; the sums' chains are bound by
// their conversions (9 a (pair, lookback, bar)), the rest by issue.
//
// Built without fast math and with -fmad=false: the divisions and the
// square root are IEEE round-to-nearest and nothing is contracted, so every
// value rounds as the torch ops of the plain version.

#include <cuda_pipeline.h>

#include <climits>

#include "metrics_tail.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Bars a tile of launches 1 and 3.
constexpr int kTile = 32;
// Row pitch of a tile in shared memory: row i starts i banks on.
constexpr int kPitch = kTile + 1;
constexpr int kTileFloats = 32 * kPitch;
// Launch 1: pairs a CTA, four kinds each (one chain warp); warps a CTA;
// stages of the legs' bars (tiles in flight: one fewer).
constexpr int kLegPairs = 8;
constexpr int kKinds = 4;
constexpr int kLegWarps = 4;
constexpr int kLegStages = 8;
// Launches 2 and 4: one CTA a pair, at most 16 warps; the pair's four
// prefix rows (and in launch 2 the legs' returns) staged in shared memory
// where the rows take up to this many bytes (T <= 3072), else read from
// device memory.
constexpr int kPairWarps = 16;
constexpr size_t kMaxStagedBytes = 96 * 1024;
// Launch 3: rows a CTA (one a lane); three chain warps (one a sum) and
// five warps for z, the ring and the lags (rows zw, zw + 5, ...); at most
// 80 registers a thread, so three CTAs share an SM.
constexpr int kSumRows = 32;
constexpr int kSums = 3;
constexpr int kZWarps = 5;
constexpr int kSumCtasPerSm = 3;
constexpr int kSumWarps = kSums + kZWarps;
constexpr int kOwnRows = (kSumRows + kZWarps - 1) / kZWarps;
// The ring's tiles at most: lookbacks up to (kMaxRing - 1) x 32 bars.
constexpr int kMaxRing = 16;

static_assert(kLegPairs * kKinds == 32, "launch 1 fills a warp");

// Where the legs' four f64 prefix rows live: row `kind` of pair n at
// c + n pair + kind kind_stride (in doubles).
struct PrefixRows {
  double* c;
  size_t pair, kind;
};

// Bytes of a pair's four prefix rows, and whether launches 2 and 4 stage
// them in shared memory.
inline size_t pair_rows_bytes(int T) {
  return kKinds * sizeof(double) * static_cast<size_t>(T);
}

inline bool staged(int T) { return pair_rows_bytes(T) <= kMaxStagedBytes; }

// Warps a CTA of launch 2 at W lookbacks: as few as take the rows in
// ceil(W / 16) rounds.
inline int pair_warps(int W) {
  const int rounds = (W + kPairWarps - 1) / kPairWarps;
  return (W + rounds - 1) / rounds;
}

// Whether the prefix rows of pair n live in its own slice of the z table
// (W T floats): launch 2 stages them in shared memory before it writes the
// pair's spread there, so that needs the ring path (z untouched until
// launch 2), staging, room (W >= 8) and 8-byte alignment (W T even).
// Elsewhere they live in device-memory scratch.
inline bool prefix_in_z(int T, int W, int ring) {
  return ring != 0 && staged(T) && W >= 2 * kKinds &&
         static_cast<long long>(W) * T % 2 == 0;
}

// Floats of device-memory scratch: the spreads' means a (pair, lookback),
// after the prefix rows (kind-major, (4, N, T)) where they are not in z.
inline size_t scratch_floats(int N, int T, int W, bool in_z) {
  return (in_z ? 0 : 2 * static_cast<size_t>(kKinds) * N * T) +
         static_cast<size_t>(N) * W;
}

// Tiles of launch 3's ring for lookbacks up to max_window: the newest tile
// and the ceil(max_window / 32) before it that its lags reach; a power of
// two, at least 4 (the tiles being summed, formed into z and stored); 0
// where that is more than kMaxRing (the lags then come from device memory;
// 4 tiles still hold the leads).
inline int ring_tiles(int max_window) {
  const int need = (max_window + kTile - 1) / kTile + 1;
  int r = 4;
  while (r < need) r *= 2;
  return r <= kMaxRing ? r : 0;
}

// Shared memory of launch 3 with `ring` tiles: the ring, two lag tiles and
// two tiles of each of the three sums.
inline size_t sums_smem(int ring) {
  return sizeof(float) * kTileFloats * (ring + 2 + 2 * kSums);
}

// Pair n's four prefix rows (x, y, x x, x y), `stride` apart: in shared
// memory (`rows`, stride T), copied there by the whole CTA, or where `c`
// keeps them.
template <bool kStaged>
__device__ __forceinline__ const double* pair_rows(const PrefixRows& c,
                                                   double* rows, int n,
                                                   int T, size_t* stride) {
  const double* base = c.c + n * c.pair;
  if (!kStaged) {
    *stride = c.kind;
    return base;
  }
  for (int kind = 0; kind < kKinds; ++kind) {
    const double* src = base + kind * c.kind;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      __pipeline_memcpy_async(rows + kind * T + t, src + t, sizeof(double));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  *stride = T;
  return rows;
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
// centred legs and of their products, `stride` apart: x, y, x x, x y.
__device__ __forceinline__ Ols ols_at(const double* c, size_t stride, int t,
                                      int w, float fw, float mx, float my) {
  const float sx = window_sum(c, t, w);
  const float sy = window_sum(c + stride, t, w);
  const float sxx = window_sum(c + 2 * stride, t, w);
  const float sxy = window_sum(c + 3 * stride, t, w);
  const float cov = sxy - sx * sy / fw;
  const float var = dbx::max_nan(sxx - sx * sx / fw, 0.f);
  const float beta = cov / (var + dbx::kEps);
  return {beta, (sy / fw + my) - beta * (sx / fw + mx)};
}

// The hedged return on returns ry, rx and the hedge ratio bp of the bar
// before.
__device__ __forceinline__ float hedged_return(float ry, float rx, float bp) {
  return (ry - bp * rx) / dbx::max_nan(1.f + fabsf(bp), 1.f);
}

// z from the three window sums s0, s1, s2 of the spread s (its own, and
// those of the centred spread and of its square) over lookback fw.
__device__ __forceinline__ float z_of(float s, float s0, float s1, float s2,
                                      float fw) {
  const float mz = s0 / fw;
  const float varz = dbx::max_nan((s2 - s1 * s1 / fw) / fw, 0.f);
  return (s - mz) / (sqrtf(varz) + dbx::kEps);
}

// The legs' returns at bar t (the bar before's price, bar 0's at bar 0).
__device__ __forceinline__ void returns_at(const float* yr, const float* xr,
                                           int t, float* ry, float* rx) {
  const int tp = t > 0 ? t - 1 : 0;
  *ry = yr[t] / yr[tp] - 1.f;
  *rx = xr[t] / xr[tp] - 1.f;
}

// Launch 1: the legs' prefix sums of pairs n0 .. n0 + 7. Warp 0 is the
// chains: lane kind x 8 + p sums row kind x 8 + p of the tile's values
// (x - mx, y - my, and their products x x and x y, as the plain version
// forms them) into the tile's sums. Warps 1-3 (lane on bar; pairs h, h + 3,
// ...; rows h, h + 3, ...) meanwhile form the next tile's values from the
// legs' bars, which they bring in up to seven tiles ahead (cp.async), and
// write the last tile's sums out. One barrier a tile.
__global__ void __launch_bounds__(kLegWarps * 32) legs_kernel(
    const float* __restrict__ y, const float* __restrict__ x,
    const float* __restrict__ mx, const float* __restrict__ my,
    PrefixRows c, int N, int T) {
  __shared__ float raw[kLegStages][2 * kLegPairs][kTile];
  __shared__ float vals[2][32][kPitch];
  __shared__ double sums[2][32][kPitch];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kLegPairs;
  const int tiles = (T + kTile - 1) / kTile;
  if (warp == 0) {
    double acc = 0.0;
    for (int b = 0; b <= tiles; ++b) {
      __syncthreads();
      if (b == tiles) continue;
      const float* own = vals[b & 1][lane];
      double* out = sums[b & 1][lane];
      const int nb = min(kTile, T - b * kTile);
      if (nb == kTile) {
        // The row's reads first, so the adds run back to back.
        float v[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i) v[i] = own[i];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          acc += static_cast<double>(v[i]);
          out[i] = acc;
        }
      } else {
        for (int i = 0; i < nb; ++i) {
          acc += static_cast<double>(own[i]);
          out[i] = acc;
        }
      }
    }
    return;
  }
  const int h = warp - 1;
  constexpr int kHelpers = kLegWarps - 1;
  constexpr int kOwnPairs = (kLegPairs + kHelpers - 1) / kHelpers;
  float mxp[kOwnPairs], myp[kOwnPairs];
#pragma unroll
  for (int k = 0; k < kOwnPairs; ++k) {
    const int p = h + kHelpers * k;
    const bool ok = p < kLegPairs && n0 + p < N;
    mxp[k] = ok ? mx[n0 + p] : 0.f;
    myp[k] = ok ? my[n0 + p] : 0.f;
  }
  // Tile b's bars of the thread's pairs into stage b % kLegStages, one
  // commit group a tile (an empty one past the last tile); 0 where there
  // is no bar.
  const auto issue = [&](int b) {
    if (b < tiles) {
      const int t = b * kTile + lane;
#pragma unroll
      for (int k = 0; k < kOwnPairs; ++k) {
        const int p = h + kHelpers * k;
        if (p >= kLegPairs) continue;
        const bool ok = n0 + p < N && t < T;
        const size_t at = ok ? static_cast<size_t>(n0 + p) * T + t : 0;
        float(*stage)[kTile] = raw[b % kLegStages];
        __pipeline_memcpy_async(&stage[p][lane], x + at, 4, ok ? 0 : 4);
        __pipeline_memcpy_async(&stage[kLegPairs + p][lane], y + at, 4,
                                ok ? 0 : 4);
      }
    }
    __pipeline_commit();
  };
  // Tile b's values of the thread's pairs (its own copies) into vals.
  const auto form = [&](int b) {
    const float(*stage)[kTile] = raw[b % kLegStages];
    float(*v)[kPitch] = vals[b & 1];
#pragma unroll
    for (int k = 0; k < kOwnPairs; ++k) {
      const int p = h + kHelpers * k;
      if (p >= kLegPairs) continue;
      const float xc = stage[p][lane] - mxp[k];
      const float yc = stage[kLegPairs + p][lane] - myp[k];
      v[p][lane] = xc;
      v[kLegPairs + p][lane] = yc;
      v[2 * kLegPairs + p][lane] = xc * xc;
      v[3 * kLegPairs + p][lane] = xc * yc;
    }
  };
#pragma unroll
  for (int b = 0; b < kLegStages - 1; ++b) issue(b);
  __pipeline_wait_prior(kLegStages - 2);
  form(0);
  for (int b = 0; b <= tiles; ++b) {
    __syncthreads();
    if (b >= 1) {
      const int t = (b - 1) * kTile + lane;
      if (t < T) {
#pragma unroll
        for (int k = 0; k < (32 + kHelpers - 1) / kHelpers; ++k) {
          const int row = h + kHelpers * k;
          const int n = n0 + row % kLegPairs;
          if (row < 32 && n < N) {
            c.c[n * c.pair + row / kLegPairs * c.kind + t] =
                sums[(b - 1) & 1][row][lane];
          }
        }
      }
    }
    if (b + 1 < tiles) {
      issue(b + kLegStages - 1);
      __pipeline_wait_prior(kLegStages - 2);
      form(b + 1);
    }
  }
  __pipeline_wait_prior(0);
}

// Launch 2: pair n's spreads into `spread` and their means into means[n W
// + j], one warp a (pair, lookback) row (warp v takes j = v, v + warps,
// ...), lane on bar; with kHr also the hedged returns into `hr`.
template <bool kStaged, bool kHr>
__global__ void __launch_bounds__(kPairWarps * 32) spread_kernel(
    const float* __restrict__ y, const float* __restrict__ x,
    const float* __restrict__ mx, const float* __restrict__ my,
    const int* __restrict__ windows, PrefixRows c, float* spread,
    float* __restrict__ hr, float* __restrict__ means, int T, int W) {
  extern __shared__ double rows[];
  const int n = blockIdx.x;
  const float* yr = y + static_cast<size_t>(n) * T;
  const float* xr = x + static_cast<size_t>(n) * T;
  // With the rows staged, the legs' returns too, once a bar.
  float* const ret = reinterpret_cast<float*>(rows + kKinds * T);
  if (kStaged && kHr) {
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      returns_at(yr, xr, t, &ret[t], &ret[T + t]);
    }
  }
  size_t stride = 0;
  const double* cn = pair_rows<kStaged>(c, rows, n, T, &stride);
  const int lane = threadIdx.x % 32;
  const float mxn = mx[n];
  const float myn = my[n];
  for (int j = threadIdx.x / 32; j < W; j += blockDim.x / 32) {
    const int w = windows[j];
    const float fw = static_cast<float>(w);
    const size_t r = static_cast<size_t>(n) * W + j;
    float* out = spread + r * T;
    double acc = 0.0;
    float beta_before = 0.f;  // the hedge ratio of the bar before the block
#pragma unroll 2
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      const int tc = min(t, T - 1);
      const Ols o = ols_at(cn, stride, tc, w, fw, mxn, myn);
      const bool ok = tc >= w - 1;
      const float yt = yr[tc];
      const float s = ok ? yt - (o.alpha + o.beta * xr[tc]) : yt;
      if (kHr) {
        const float beta = ok ? o.beta : 0.f;
        const float below = __shfl_up_sync(kFull, beta, 1);
        const float bp = lane == 0 ? beta_before : below;
        beta_before = __shfl_sync(kFull, beta, 31);
        float ry, rx;
        if (kStaged) {
          ry = ret[tc];
          rx = ret[T + tc];
        } else {
          returns_at(yr, xr, tc, &ry, &rx);
        }
        if (t < T) hr[r * T + t] = hedged_return(ry, rx, bp);
      }
      if (t < T) out[t] = s;
      acc += t < T ? static_cast<double>(s) : 0.0;
    }
    for (int off = 16; off >= 1; off /= 2) {
      acc += __shfl_down_sync(kFull, acc, off);
    }
    if (lane == 0) means[r] = __double2float_rn(acc / T);
  }
}

// Launch 3's chains over one tile: sum K (0 the spread, 1 the spread
// centred by its mean m, 2 that squared) of the lane's row, from the tile
// (`lead`) and the tile w bars behind (`lag`, 0 below bar w), each window
// sum into `out`.
template <int K>
__device__ __forceinline__ float sum_value(float s, float m) {
  if (K == 0) return s;
  const float sc = s - m;
  return K == 1 ? sc : sc * sc;
}

template <int K>
__device__ __forceinline__ void sum_chains(const float* lead,
                                           const float* lag, float* out,
                                           int t0, int nb, int w, float m,
                                           double& lead_acc,
                                           double& lag_acc) {
  const auto step = [&](int i, float s, float s_lag) {
    const float v = sum_value<K>(s, m);
    const float u = t0 + i >= w ? sum_value<K>(s_lag, m) : 0.f;
    lead_acc += static_cast<double>(v);
    lag_acc += static_cast<double>(u);
    out[i] = __double2float_rn(lead_acc - lag_acc);
  };
  if (nb == kTile) {
    // Each half tile's reads first, so the adds run back to back.
#pragma unroll
    for (int i0 = 0; i0 < kTile; i0 += kTile / 2) {
      float a[kTile / 2], b[kTile / 2];
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {
        a[i] = lead[i0 + i];
        b[i] = lag[i0 + i];
      }
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) step(i0 + i, a[i], b[i]);
    }
  } else {
    for (int i = 0; i < nb; ++i) step(i, lead[i], lag[i]);
  }
}

// Launch 3: rows r0 .. r0 + 31 of the spread: their three window sums and
// z. With kRing, z goes over the spread (z == spread) and the lags come
// from the ring of the last `ring` tiles; else from device memory, and z
// goes to its own table.
template <bool kRing>
__global__ void __launch_bounds__(kSumWarps * 32, kSumCtasPerSm) sums_kernel(
    const float* spread, float* z, const float* __restrict__ means,
    const int* __restrict__ windows, int N, int T, int W, int ring) {
  extern __shared__ float smem[];
  __shared__ int row_w[kSumRows];
  // The ring's tiles, then two lag tiles, then two sets of three sum tiles.
  float* const ring_base = smem;
  float* const lag_base = smem + ring * kTileFloats;
  float* const sum_base = lag_base + 2 * kTileFloats;
  const auto tile_of = [&](float* base, int k) {
    return base + k * kTileFloats;
  };
  const long long rows = static_cast<long long>(N) * W;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long r0 = static_cast<long long>(blockIdx.x) * kSumRows;
  const int tiles = (T + kTile - 1) / kTile;
  if (threadIdx.x < kSumRows) {
    row_w[threadIdx.x] = windows[(r0 + threadIdx.x) % W];
  }
  __syncthreads();
  if (warp < kSums) {
    // A chain: row r0 + lane, sum `warp`, tile b at step b.
    const int w = row_w[lane];
    const float m = r0 + lane < rows ? means[r0 + lane] : 0.f;
    double lead_acc = 0.0;
    double lag_acc = 0.0;
    for (int b = 0; b <= tiles; ++b) {
      __syncthreads();
      if (b == tiles) continue;
      const int t0 = b * kTile;
      const int nb = min(kTile, T - t0);
      const float* lead = tile_of(ring_base, b & (ring - 1)) + lane * kPitch;
      const float* lag = tile_of(lag_base, b & 1) + lane * kPitch;
      float* out = tile_of(sum_base, (b & 1) * kSums + warp) + lane * kPitch;
      if (warp == 0) {
        sum_chains<0>(lead, lag, out, t0, nb, w, m, lead_acc, lag_acc);
      } else if (warp == 1) {
        sum_chains<1>(lead, lag, out, t0, nb, w, m, lead_acc, lag_acc);
      } else {
        sum_chains<2>(lead, lag, out, t0, nb, w, m, lead_acc, lag_acc);
      }
    }
    return;
  }
  // z, the ring and the lags: bar t0 + lane of rows zw, zw + 5, ...
  const int zw = warp - kSums;
  float next[kOwnRows];
  // Tile b's bars of the rows into registers (0 past the rows and bars).
  const auto load = [&](int b) {
    const int t = b * kTile + lane;
#pragma unroll
    for (int q = 0; q < kOwnRows; ++q) {
      const int i = zw + kZWarps * q;
      const bool ok = i < kSumRows && r0 + i < rows && t < T;
      next[q] = ok ? spread[static_cast<size_t>(r0 + i) * T + t] : 0.f;
    }
  };
  // The registers into tile b's ring slot, then tile b's lags (bar t - w
  // of each row, 0 below bar 0) into its lag tile.
  const auto store = [&](int b) {
    float* lead = tile_of(ring_base, b & (ring - 1));
    float* lag = tile_of(lag_base, b & 1);
    const int t = b * kTile + lane;
#pragma unroll
    for (int q = 0; q < kOwnRows; ++q) {
      const int i = zw + kZWarps * q;
      if (i < kSumRows) lead[i * kPitch + lane] = next[q];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kOwnRows; ++q) {
      const int i = zw + kZWarps * q;
      if (i >= kSumRows) continue;
      const int u = t - row_w[i];
      float v = 0.f;
      if (u >= 0 && t < T && r0 + i < rows) {
        v = kRing ? tile_of(ring_base, (u / kTile) & (ring - 1))[i * kPitch +
                                                                 u % kTile]
                  : spread[static_cast<size_t>(r0 + i) * T + u];
      }
      lag[i * kPitch + lane] = v;
    }
  };
  load(0);
  store(0);
  if (tiles > 1) load(1);
  for (int b = 0; b <= tiles; ++b) {
    __syncthreads();
    if (b >= 1) {
      // z of tile b - 1 from bar 2w - 2 on (the OLS warmup, then the
      // z-score's).
      const float* lead = tile_of(ring_base, (b - 1) & (ring - 1));
      const float* s0 = tile_of(sum_base, ((b - 1) & 1) * kSums);
      const float* s1r = s0 + kTileFloats;
      const float* s2r = s1r + kTileFloats;
      const int t = (b - 1) * kTile + lane;
#pragma unroll
      for (int q = 0; q < kOwnRows; ++q) {
        const int i = zw + kZWarps * q;
        if (i >= kSumRows || r0 + i >= rows || t >= T) continue;
        const int at = i * kPitch + lane;
        const int wi = row_w[i];
        const float zt = z_of(lead[at], s0[at], s1r[at], s2r[at],
                              static_cast<float>(wi));
        z[static_cast<size_t>(r0 + i) * T + t] = t >= 2 * wi - 2 ? zt : 0.f;
      }
    }
    if (b + 1 < tiles) store(b + 1);
    if (b + 2 < tiles) load(b + 2);
  }
}

// Launch 4 (lookbacks too long for the ring): pair n's hedged returns,
// each on the hedge ratio of the bar before (0 before bar 0 and in the OLS
// warmup t < w - 1), one thread a bar and every lookback.
template <bool kStaged>
__global__ void __launch_bounds__(kPairWarps * 32) hedged_kernel(
    const float* __restrict__ y, const float* __restrict__ x,
    const float* __restrict__ mx, const float* __restrict__ my,
    const int* __restrict__ windows, PrefixRows c, float* __restrict__ hr,
    int T, int W) {
  extern __shared__ double rows[];
  const int n = blockIdx.x;
  size_t stride = 0;
  const double* cn = pair_rows<kStaged>(c, rows, n, T, &stride);
  const float mxn = mx[n];
  const float myn = my[n];
  const float* yr = y + static_cast<size_t>(n) * T;
  const float* xr = x + static_cast<size_t>(n) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    for (int j = 0; j < W; ++j) {
      const int w = windows[j];
      float bp = 0.f;
      if (t > 0 && t - 1 >= w - 1) {
        bp = ols_at(cn, stride, t - 1, w, static_cast<float>(w), mxn, myn)
                 .beta;
      }
      float ry, rx;
      returns_at(yr, xr, t, &ry, &rx);
      hr[(static_cast<size_t>(n) * W + j) * T + t] =
          hedged_return(ry, rx, bp);
    }
  }
}

int launched() { return static_cast<int>(cudaGetLastError()); }

template <bool kStaged, bool kHr>
int launch_spread(const float* y, const float* x, const float* mx,
                  const float* my, const int* windows, PrefixRows c,
                  float* spread, float* hr, float* means, int N, int T,
                  int W, cudaStream_t s) {
  const size_t smem =
      kStaged ? pair_rows_bytes(T) +
                    (kHr ? 2 * sizeof(float) * static_cast<size_t>(T) : 0)
              : 0;
  if (const int err = dbx::allow_smem(spread_kernel<kStaged, kHr>, smem)) {
    return err;
  }
  spread_kernel<kStaged, kHr><<<N, 32 * pair_warps(W), smem, s>>>(
      y, x, mx, my, windows, c, spread, hr, means, T, W);
  return launched();
}

template <bool kStaged>
int launch_hedged(const float* y, const float* x, const float* mx,
                  const float* my, const int* windows, PrefixRows c,
                  float* hr, int N, int T, int W, cudaStream_t s) {
  const size_t smem = kStaged ? pair_rows_bytes(T) : 0;
  if (const int err = dbx::allow_smem(hedged_kernel<kStaged>, smem)) {
    return err;
  }
  hedged_kernel<kStaged><<<N, 256, smem, s>>>(
      y, x, mx, my, windows, c, hr, T, W);
  return launched();
}

template <bool kRing>
int launch_sums(const float* spread, float* z, const float* means,
                const int* windows, int N, int T, int W, int ring,
                cudaStream_t s) {
  const size_t smem = sums_smem(ring);
  if (const int err = dbx::allow_smem(sums_kernel<kRing>, smem)) return err;
  const long long rows = static_cast<long long>(N) * W;
  sums_kernel<kRing>
      <<<static_cast<unsigned>((rows + kSumRows - 1) / kSumRows),
         kSumWarps * 32, smem, s>>>(spread, z, means, windows, N, T, W,
                                    ring);
  return launched();
}

}  // namespace

// dbx_pairs_tables_plan: how dbx_pairs_tables lays out N pairs of T bars
// and W lookbacks, the longest `max_window` bars. info[0], the floats of
// device-memory scratch it needs (the legs' f64 prefix rows where they are
// not in z, then the spreads' means); info[1], the pairs a warp of the
// legs' chains takes; info[2], the (pair, lookback) rows a CTA of the
// spreads' chains takes;
// info[3], the launches a call makes; info[4], 1 where the spread launch
// stages a pair's prefix rows in shared memory, 0 where it reads them from
// device memory; info[5], the tiles of the sums launch's ring, 0 where
// the lags come from device memory; info[6], 1 where the prefix rows live
// in the z table, 0 where in the scratch.
extern "C" int dbx_pairs_tables_plan(int N, int T, int W, int max_window,
                                     int* info) {
  if (N <= 0 || T <= 0 || W <= 0 || max_window <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ring = ring_tiles(max_window);
  const bool in_z = prefix_in_z(T, W, ring);
  const size_t floats = scratch_floats(N, T, W, in_z);
  if (floats > static_cast<size_t>(INT_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  info[0] = static_cast<int>(floats);
  info[1] = kLegPairs;
  info[2] = kSumRows;
  info[3] = ring != 0 ? 3 : 4;
  info[4] = staged(T) ? 1 : 0;
  info[5] = ring;
  info[6] = in_z ? 1 : 0;
  return static_cast<int>(cudaSuccess);
}

// dbx_pairs_tables: y, x (N, T) f32 close legs; mx, my (N,) f32 their means
// over the T bars; windows (W,) i32 distinct lookbacks (each at least 1),
// the longest `max_window` bars (it sizes the sums launch's ring: a
// smaller value than the longest gives wrong z); z, hr (N, W, T) f32 out:
// the spread z-table and the hedged-return table (one of the two holds the
// spread until z is written, and z the legs' prefix rows before that where
// they fit); scratch: the floats dbx_pairs_tables_plan gives. Pointers are
// device pointers. Launches on `stream` and returns the first launch's
// error, or cudaGetLastError() of the last, as an int.
extern "C" int dbx_pairs_tables(const void* y, const void* x, const void* mx,
                                const void* my, const void* windows, void* z,
                                void* hr, void* scratch, int N, int T, int W,
                                int max_window, void* stream) {
  if (N <= 0 || W <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  if (scratch == nullptr || max_window <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ring = ring_tiles(max_window);
  const bool in_z = prefix_in_z(T, W, ring);
  if (scratch_floats(N, T, W, in_z) > static_cast<size_t>(INT_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const float*>(y);
  const auto* xp = static_cast<const float*>(x);
  const auto* mxp = static_cast<const float*>(mx);
  const auto* myp = static_cast<const float*>(my);
  const auto* wp = static_cast<const int*>(windows);
  auto* zp = static_cast<float*>(z);
  auto* hp = static_cast<float*>(hr);
  const size_t NT = static_cast<size_t>(N) * T;
  const PrefixRows c =
      in_z ? PrefixRows{reinterpret_cast<double*>(zp),
                        static_cast<size_t>(W) * T / 2,
                        static_cast<size_t>(T)}
           : PrefixRows{static_cast<double*>(scratch),
                        static_cast<size_t>(T), NT};
  auto* means = static_cast<float*>(scratch) + (in_z ? 0 : 2 * kKinds * NT);
  legs_kernel<<<(N + kLegPairs - 1) / kLegPairs, kLegWarps * 32, 0, s>>>(
      yp, xp, mxp, myp, c, N, T);
  if (const int err = launched()) return err;
  if (ring != 0) {
    // The spread in the z table, z over it; hr in launch 2.
    const int err =
        staged(T) ? launch_spread<true, true>(yp, xp, mxp, myp, wp, c, zp,
                                              hp, means, N, T, W, s)
                  : launch_spread<false, true>(yp, xp, mxp, myp, wp, c, zp,
                                               hp, means, N, T, W, s);
    if (err != 0) return err;
    return launch_sums<true>(zp, zp, means, wp, N, T, W, ring, s);
  }
  // The spread in the hr table until z is written, then hr over it.
  int err = staged(T) ? launch_spread<true, false>(yp, xp, mxp, myp, wp, c,
                                                   hp, nullptr, means, N, T,
                                                   W, s)
                      : launch_spread<false, false>(yp, xp, mxp, myp, wp, c,
                                                    hp, nullptr, means, N,
                                                    T, W, s);
  if (err != 0) return err;
  err = launch_sums<false>(hp, zp, means, wp, N, T, W, 4, s);
  if (err != 0) return err;
  return staged(T) ? launch_hedged<true>(yp, xp, mxp, myp, wp, c, hp, N, T,
                                         W, s)
                   : launch_hedged<false>(yp, xp, mxp, myp, wp, c, hp, N, T,
                                          W, s);
}
