// Band-machine sweeps for Hopper (sm_90a): K2 of the port, and K7, the
// pairs sweep, which runs the same hysteresis machine.
//
// Replaces the TPU kernel of the reference package,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_band_machine_pallas`
// with its bodies `_band_kernel_inline` (z-table built in the kernel by
// `_build_boll_z_scratch`), `_boll_kernel` and `_touch_kernel` (z-table
// streamed from HBM). For every (ticker, combo) lane it selects the lane's
// z-score series, runs a band machine over it and writes the 9 backtest
// metrics:
// - "hysteresis" (bollinger, stochastic): the 3-state machine of
//   `signals.band_hysteresis`: from flat, enter long below -k and short
//   above +k; leave a long at z >= -z_exit and a short at z <= z_exit;
//   flat before the lane's warmup.
// - "touch" (bollinger_touch): memoryless, long below -k, short above +k.
//
// Design.
// - No one-hot matmul and no compose ladder. The TPU kernel selects each
//   lane's z row with a one-hot contraction (one nonzero term: a copy) and
//   evaluates the machine as a log-depth composition of transition maps,
//   which only selects among -1/0/+1. One thread per lane reading its own
//   z value and stepping the machine bar by bar gives the same positions.
// - dbx_band_inline (bollinger): no z-table in device memory. Inputs are the
//   close row and the cumsum rows of close, centered close and centered close
//   squared (torch ops before the launch) plus the simple returns. One CTA
//   covers one ticker x one tile of lanes and forms the z of the tile's
//   distinct windows (a list built by torch ops before the launch, with each
//   lane's index into it) once per (window, bar), a block of bars at a time
//   in shared memory (bar_blocks.cuh), as `_build_boll_z_scratch` forms its
//   VMEM table once per ticker, and in its op order: m = (cs[t] - cs[t-w]) /
//   w, s1 and s2 the centered window sums, var = max((s2 - s1*s1/w) / w, 0),
//   z = (c - m) / (sqrt(var) + 1e-12), z = 0 for t < w - 1. The rows are read
//   once per (window, bar) through L1; each lane then reads its window's z
//   from the block. The bench grid's tiles read 20 windows.
// - The table entry is one body, `band_source_kernel`, templated on where
//   a lane's z comes from, with two C entries:
//   * dbx_band_table (rsi, keltner, vwap_reversion): a torch-built
//     (N, W, T) f32 z-table (EMA and cumsum prep), each lane reading its
//     row in device memory; the CTA stages only the returns row. Staging
//     the CTA's distinct table rows too was measured and gained nothing
//     (PERF.md, section 6).
//   * dbx_band_stoch (stochastic): no table. The CTA builds the sparse-table
//     levels of the ticker's high and low rows in shared memory
//     (extrema.cuh), and each lane forms its channel and %K per bar in
//     `stochastic_z_table`'s op order: rng = hi - lo,
//     k = rng > 1e-12 ? 100 * (c - lo) / (rng + 1e-12) : 50, minus 50, and
//     0 for t < w - 1. When the levels do not fit in shared memory (long
//     rows), the wrapper builds them in device memory with torch ops, one
//     op per level and side, and the same body reads them there.
//   Lanes run window-major: the wrapper sorts them by window on the host
//   and passes `lane`, each slot's lane in the caller's order, where the
//   kernel writes its metrics. A warp's lanes then share one to four
//   windows, so their loads are broadcasts of a few words (of the levels
//   in shared memory, or of the table rows through L1).
//   A stochastic CTA covers one ticker x 1024 combos: the staged rows and
//   levels take up to 227 KB, one CTA an SM, and 1024 lanes keep 32 warps
//   resident to hide each lane's sequential chain. A z-table CTA covers 128
//   combos.
// - One sequential pass per thread over t < t_real[ticker] with the PnL and
//   metrics of metrics_tail.cuh.
//
// What bounds it. Every entry steps the 4 operations of the machine and
// the 20 of the metric update (one IEEE division) per (combo, bar). The
// inline entry's z (13 operations: three divisions and a square root) runs
// once per (window, bar) of a tile, 1/50 of the lanes' count on the bench
// grid; the stochastic entry spends 9 per (combo, bar) on the channel and
// %K; the table entry reads 4 B of z per (combo, bar), a warp's lanes on
// one to four rows. All are bound by their operations (PERF.md, section 6).
//
// K7 (dbx_pairs) replaces the reference's `_fused_pairs_call` with its body
// `_pairs_kernel`: one one-hot selection of a stacked (z, hedged return)
// table row per lane, the band ladder with per-lane z_entry and z_exit,
// net = prev * hr - cost * |dpos| and `_metrics_pack`. Its inputs are two
// (N, W, T) tables built on the card (pairs_tables.cu: the spread z-score
// and the hedged spread return) with one row per distinct lookback; the
// lanes differ only in their bands. What bounds it is each lane's
// sequential chain of instructions a bar (the machine and the metric
// update), not the bytes: the bench grid's 500 lanes read 10 rows. So the
// lanes run in tiles on the read path of K1 (bar_blocks.cuh, layout
// kPairs): one CTA covers one pair x one tile of lanes and fills the
// (z, hr) pair of each lookback its tile reads once per bar of a block in
// shared memory; each lane reads its pair with one 8-byte shared load,
// steps band_next<kHysteresis> with its own k and z_exit and passes hr to
// MetricsAcc::step in place of the ticker's return, which is exactly the
// reference's net. No table read, 64-bit address or row pointer stays on
// a lane's chain, and no ticker returns row is staged. The wrapper builds
// the tiles' lookback lists with torch ops (ops/fused.py `window_tiles`),
// and each lane walks its own slot of the blocks (lane_block_pass).
//
// Built without fast math and with -fmad=false: divisions and sqrtf are
// IEEE round-to-nearest and nothing is contracted, so z and %K equal the
// torch tables built from the same inputs, and the positions and metrics
// equal the plain PyTorch version's bit for bit.

#include "band_next.cuh"
#include "bar_blocks.cuh"
#include "extrema.cuh"
#include "metrics_tail.cuh"
#include "occupancy.cuh"

namespace {

using dbx::band_next;
using dbx::kHysteresis;
using dbx::kTouch;

constexpr int kThreads = 128;
// The table entry stages its returns row up to this many bytes.
constexpr size_t kMaxStagedBytes = 96 * 1024;
// Lanes per CTA of the stochastic source: one CTA an SM (its staged rows
// and levels take up to 227 KB), 32 warps.
constexpr int kStochThreads = 1024;

// Windowed sum cs[t] - cs[t-w] (cs[t-w] = 0 for t < w).
__device__ __forceinline__ float wsum(const float* cs, int t, int w) {
  return cs[t] - (t >= w ? cs[t - w] : 0.f);
}

// The z-score of window w at bar t: the inline entry's per-window value.
__device__ __forceinline__ float boll_z(const float* c, const float* cs,
                                        const float* csx, const float* csx2,
                                        int t, int w, float fw) {
  if (t < w - 1) return 0.f;
  const float m = wsum(cs, t, w) / fw;
  const float s1 = wsum(csx, t, w);
  const float s2 = wsum(csx2, t, w);
  float var = (s2 - s1 * s1 / fw) / fw;
  var = var < 0.f ? 0.f : var;  // torch.clamp_min: NaN stays NaN
  return (c[t] - m) / (sqrtf(var) + dbx::kEps);
}

// wins: the (n_tiles, wmax) window lists, counts: their lengths; wi: each
// lane's index into its tile's list.
template <int kMachine>
__global__ void __launch_bounds__(dbx::kMaxTileLanes) band_inline_kernel(
    const float* __restrict__ close, const float* __restrict__ cs,
    const float* __restrict__ csx, const float* __restrict__ csx2,
    const float* __restrict__ r, const int* __restrict__ t_real,
    const int* __restrict__ wins, const int* __restrict__ counts,
    const int* __restrict__ wi, const float* __restrict__ k,
    const int* __restrict__ warm, float* __restrict__ out, int N, int T,
    int P, int wmax, float z_exit, float cost, float ppy) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const size_t row = static_cast<size_t>(n) * T;
  const float* c_row = close + row;
  const float* cs_row = cs + row;
  const float* csx_row = csx + row;
  const float* csx2_row = csx2 + row;
  const int* list = wins + static_cast<size_t>(blockIdx.y) * wmax;
  const bool live = p < P;
  const int j_lane = live ? wi[p] : 0;
  const float kk = live ? k[p] : 0.f;
  const int t_on = live ? warm[p] - 1 : 0;

  dbx::MetricsAcc acc;
  dbx::bar_block_pass(
      smem, counts[blockIdx.y], tr, r + row, live,
      [&](int j, int t) {
        const int w = list[j];
        return boll_z(c_row, cs_row, csx_row, csx2_row, t, w,
                      static_cast<float>(w));
      },
      [&](const float* v, float rt, int t) {
        // Read and step the machine on every bar, then select: no branch.
        const float pos = band_next<kMachine>(acc.prev, v[j_lane], kk, z_exit);
        acc.step(t >= t_on ? pos : 0.f, rt, cost);
      });
  if (live) acc.store(out, n, p, N, P, tr, ppy);
}

// z sources of the table entry. Each gives `stage`, run by every thread of
// the CTA before its lanes start (it stages what the CTA's lanes read and
// returns the ticker's view), and the view's `lane(row)`, whose z(t) is the
// lane's z at bar t. `row` is the lane's entry of the entry's per-lane row
// array: a table row for TableZ, the window for StochZ.

// A torch-built (N, W, T) z-table, each lane reading its row in device
// memory; with kStaged the returns row is copied to shared memory.
template <bool kStaged>
struct TableZ {
  static constexpr int kLanes = kThreads;
  const float* z;
  int W;

  struct Lane {
    const float* row;
    __device__ __forceinline__ float z(int t) const { return row[t]; }
  };

  struct Ticker {
    const float* r;
    const float* table;  // the ticker's (W, T) rows
    int T;
    __device__ __forceinline__ Lane lane(int row) const {
      return {table + static_cast<size_t>(row) * T};
    }
  };

  __device__ __forceinline__ Ticker stage(float* smem, int n, int T, int tr,
                                          const float* r_row, const int*,
                                          int, int) const {
    const float* table = z + static_cast<size_t>(n) * W * T;
    if (!kStaged) return {r_row, table, T};
    for (int t = threadIdx.x; t < tr; t += blockDim.x) smem[t] = r_row[t];
    __syncthreads();
    return {smem, table, T};
  }
};

// Stochastic %K from the sparse-table levels of the ticker's high and low
// rows: built in shared memory with kStaged (extrema.cuh), else read from
// (N, L + 1, T) level tensors in device memory.
template <bool kStaged>
struct StochZ {
  static constexpr int kLanes = kStochThreads;
  const float* close;
  const float* high;
  const float* low;
  const float* lev_hi;
  const float* lev_lo;
  int L;

  struct Lane {
    dbx::Channel ch;
    const float* c;
    int w1;  // w - 1: the first bar with a full window
    __device__ __forceinline__ float z(int t) const {
      if (t < w1) return 0.f;
      const float hi = ch.high(t);
      const float lo = ch.low(t);
      const float rng = hi - lo;
      const float k = rng > dbx::kEps ? 100.f * (c[t] - lo) / (rng + dbx::kEps)
                                      : 50.f;
      return k - 50.f;
    }
  };

  struct Ticker {
    const float* r;
    const float* c;
    const float* lev_hi;
    const float* lev_lo;
    int T;
    __device__ __forceinline__ Lane lane(int w) const {
      w = max(w, 1);
      return {dbx::Channel(lev_hi, lev_lo, T, w), c, w - 1};
    }
  };

  __device__ __forceinline__ Ticker stage(float* smem, int n, int T, int tr,
                                          const float* r_row,
                                          const int* window, int slot,
                                          int P) const {
    const size_t row = static_cast<size_t>(n) * T;
    if (!kStaged) {
      const size_t lev = static_cast<size_t>(n) * (L + 1) * T;
      return {r_row, close + row, lev_hi + lev, lev_lo + lev, T};
    }
    const dbx::StagedChannel st = dbx::stage_channel(
        smem, close + row, r_row, high + row, low + row, window, slot, P, T,
        tr, L);
    return {st.r, st.close, st.lev_hi, st.lev_lo, T};
  }
};

template <int kMachine, class Source>
__global__ void __launch_bounds__(Source::kLanes) band_source_kernel(
    Source src, const float* __restrict__ r, const int* __restrict__ t_real,
    const int* __restrict__ row, const float* __restrict__ k,
    const int* __restrict__ warm, const int* __restrict__ lane,
    float* __restrict__ out, int N, int T, int P, float z_exit, float cost,
    float ppy) {
  extern __shared__ float staged[];
  const int n = blockIdx.x;
  const int slot = blockIdx.y * Source::kLanes + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const auto tk = src.stage(staged, n, T, tr, r + static_cast<size_t>(n) * T,
                            row, slot, P);
  if (slot >= P) return;

  const auto ln = tk.lane(row[slot]);
  const float kk = k[slot];
  const int t_on = warm[slot] - 1;
  dbx::MetricsAcc acc;
  for (int t = 0; t < tr; ++t) {
    float pos = 0.f;
    if (t >= t_on) pos = band_next<kMachine>(acc.prev, ln.z(t), kk, z_exit);
    acc.step(pos, tk.r[t], cost);
  }
  acc.store(out, n, lane[slot], N, P, tr, ppy);
}

// K7 on tiles: wins, the (n_tiles, wmax) lists of the table rows (one a
// lookback) each tile reads, counts their lengths; wi, each lane's index
// into its tile's list.
__global__ void __launch_bounds__(dbx::kMaxTileLanes) pairs_kernel(
    const float* __restrict__ z, const float* __restrict__ hr,
    const int* __restrict__ t_real, const int* __restrict__ wins,
    const int* __restrict__ counts, const int* __restrict__ wi,
    const float* __restrict__ k, const float* __restrict__ z_exit,
    const int* __restrict__ warm, float* __restrict__ out, int N, int T,
    int W, int P, int wmax, float cost, float ppy) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const int tr = min(max(t_real[n], 0), T);
  const size_t base = static_cast<size_t>(n) * W * T;
  const float* z_rows = z + base;
  const float* hr_rows = hr + base;
  const int* list = wins + static_cast<size_t>(blockIdx.y) * wmax;
  const bool live = p < P;
  const int j = live ? wi[p] : 0;
  const float kk = live ? k[p] : 0.f;
  const float zx = live ? z_exit[p] : 0.f;
  const int t_on = live ? warm[p] - 1 : 0;

  dbx::MetricsAcc acc;
  dbx::lane_block_pass<dbx::kPairs>(
      smem, counts[blockIdx.y], tr, nullptr, live, j,
      [&](int i, int t) {
        const size_t at = static_cast<size_t>(list[i]) * T + t;
        return make_float2(z_rows[at], hr_rows[at]);
      },
      [&](float2 zh, int t) {
        // Step the machine on every bar, then select: no branch.
        const float nxt = band_next<kHysteresis>(acc.prev, zh.x, kk, zx);
        const float pos = t >= t_on ? nxt : 0.f;
        acc.step(pos, zh.y, cost);
      });
  if (live) acc.store(out, n, p, N, P, tr, ppy);
}

template <int kMachine, class Source>
int launch_source(const Source& src, size_t smem, const float* r,
                  const int* t_real, const int* row, const float* k,
                  const int* warm, const int* lane, float* out, int N, int T,
                  int P, float z_exit, float cost, float ppy,
                  cudaStream_t s) {
  constexpr int kLanes = Source::kLanes;
  const dim3 grid(N, (P + kLanes - 1) / kLanes);
  auto kernel = band_source_kernel<kMachine, Source>;
  const int err = dbx::allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, kLanes, smem, s>>>(src, r, t_real, row, k, warm, lane, out,
                                    N, T, P, z_exit, cost, ppy);
  return static_cast<int>(cudaGetLastError());
}

template <class Source>
int launch_machine(int machine, const Source& src, size_t smem,
                   const float* r, const int* t_real, const int* row,
                   const float* k, const int* warm, const int* lane,
                   float* out, int N, int T, int P, float z_exit, float cost,
                   float ppy, cudaStream_t s) {
  auto launch = machine == kTouch ? launch_source<kTouch, Source>
                                  : launch_source<kHysteresis, Source>;
  return launch(src, smem, r, t_real, row, k, warm, lane, out, N, T, P,
                z_exit, cost, ppy, s);
}

}  // namespace

// C entry points (loaded with ctypes). Pointers are device pointers; each
// launches on `stream` and returns cudaGetLastError() as an int. machine:
// 0 = hysteresis, 1 = touch. out: (9, N, P) f32.
//
// dbx_band_inline: close, cs, csx, csx2, r: (N, T) f32 (close, its cumsum,
// the cumsums of the centered close and of its square, simple returns);
// t_real: (N,) i32; wins: (n_tiles, wmax) i32, the sorted distinct windows
// each tile of `lanes` lanes reads, counts: (n_tiles,) i32 their number (at
// most wmax); wi: (P,) i32 each lane's index into its tile's list; k: (P,)
// f32 entry band; warm: (P,) i32 (truncated warmup). lanes: a multiple of
// 32 up to 1024, the lanes a CTA.
extern "C" int dbx_band_inline(const void* close, const void* cs,
                               const void* csx, const void* csx2,
                               const void* r, const void* t_real,
                               const void* wins, const void* counts,
                               const void* wi, const void* k,
                               const void* warm, void* out, int N, int T,
                               int P, int lanes, int wmax, int machine,
                               float z_exit, float cost, int ppy,
                               void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if ((machine != kHysteresis && machine != kTouch) ||
      !dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = machine == kTouch ? band_inline_kernel<kTouch>
                                  : band_inline_kernel<kHysteresis>;
  const size_t smem = dbx::block_smem_bytes(wmax);
  const int err = dbx::allow_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(N, (P + lanes - 1) / lanes);
  kernel<<<grid, lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(close), static_cast<const float*>(cs),
      static_cast<const float*>(csx), static_cast<const float*>(csx2),
      static_cast<const float*>(r), static_cast<const int*>(t_real),
      static_cast<const int*>(wins), static_cast<const int*>(counts),
      static_cast<const int*>(wi), static_cast<const float*>(k),
      static_cast<const int*>(warm), static_cast<float*>(out), N, T, P, wmax,
      z_exit, cost, static_cast<float>(ppy));
  return static_cast<int>(cudaGetLastError());
}

// dbx_band_inline_occupancy: the build report (occupancy.cuh) of the
// inline entry's hysteresis kernel launched as dbx_band_inline launches it
// on `lanes`-lane tiles with lists of at most `wmax` windows.
extern "C" int dbx_band_inline_occupancy(int lanes, int wmax, int* info) {
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dbx::launch_report(band_inline_kernel<kHysteresis>, lanes,
                            dbx::block_smem_bytes(wmax), info);
}

// The table entry's arguments beside its source: r: (N, T) f32;
// t_real: (N,) i32; k: (P,) f32; warm: (P,) i32; lane: (P,) i32, the
// caller's lane of each slot (slot p's metrics go to out[:, n, lane[p]]).
//
// dbx_band_table: z: (N, W, T) f32 z-table (0 before each window's warmup);
// widx: (P,) i32 row of each slot in z.
extern "C" int dbx_band_table(const void* z, const void* r,
                              const void* t_real, const void* widx,
                              const void* k, const void* warm,
                              const void* lane, void* out, int N, int T,
                              int W, int P, int machine, float z_exit,
                              float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (machine != kHysteresis && machine != kTouch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a_z = static_cast<const float*>(z);
  const auto* a_r = static_cast<const float*>(r);
  const auto* a_tr = static_cast<const int*>(t_real);
  const auto* a_row = static_cast<const int*>(widx);
  const auto* a_k = static_cast<const float*>(k);
  const auto* a_w = static_cast<const int*>(warm);
  const auto* a_lane = static_cast<const int*>(lane);
  auto* a_out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float f_ppy = static_cast<float>(ppy);
  const size_t smem = static_cast<size_t>(T) * sizeof(float);
  if (smem <= kMaxStagedBytes) {
    return launch_machine(machine, TableZ<true>{a_z, W}, smem, a_r, a_tr,
                          a_row, a_k, a_w, a_lane, a_out, N, T, P, z_exit,
                          cost, f_ppy, s);
  }
  return launch_machine(machine, TableZ<false>{a_z, W}, 0, a_r, a_tr, a_row,
                        a_k, a_w, a_lane, a_out, N, T, P, z_exit, cost,
                        f_ppy, s);
}

// dbx_band_stoch: close, high, low: (N, T) f32; window: (P,) i32 window of
// each slot; lev_hi, lev_lo: null where the kernel builds the levels in
// shared memory, else (N, L + 1, T) f32 levels of the highs (max) and lows
// (min) in device memory, L = dbx_channel_levels(T) (extrema.cuh).
extern "C" int dbx_band_stoch(const void* close, const void* high,
                              const void* low, const void* r,
                              const void* lev_hi, const void* lev_lo,
                              const void* t_real, const void* window,
                              const void* k, const void* warm,
                              const void* lane, void* out, int N, int T,
                              int P, int machine, float z_exit, float cost,
                              int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (machine != kHysteresis && machine != kTouch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a_c = static_cast<const float*>(close);
  const auto* a_h = static_cast<const float*>(high);
  const auto* a_l = static_cast<const float*>(low);
  const auto* a_lh = static_cast<const float*>(lev_hi);
  const auto* a_ll = static_cast<const float*>(lev_lo);
  const auto* a_r = static_cast<const float*>(r);
  const auto* a_tr = static_cast<const int*>(t_real);
  const auto* a_win = static_cast<const int*>(window);
  const auto* a_k = static_cast<const float*>(k);
  const auto* a_w = static_cast<const int*>(warm);
  const auto* a_lane = static_cast<const int*>(lane);
  auto* a_out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float f_ppy = static_cast<float>(ppy);
  const int L = dbx::channel_levels(T);
  if (dbx::channel_staged(T)) {
    return launch_machine(machine,
                          StochZ<true>{a_c, a_h, a_l, nullptr, nullptr, L},
                          dbx::channel_smem_bytes(T), a_r, a_tr, a_win, a_k,
                          a_w, a_lane, a_out, N, T, P, z_exit, cost, f_ppy,
                          s);
  }
  if (a_lh == nullptr || a_ll == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_machine(machine, StochZ<false>{a_c, a_h, a_l, a_lh, a_ll, L},
                        0, a_r, a_tr, a_win, a_k, a_w, a_lane, a_out, N, T,
                        P, z_exit, cost, f_ppy, s);
}

// dbx_band_occupancy: the build report (occupancy.cuh: registers, resident
// CTAs an SM, lanes, dynamic shared memory in info[0..3]) of the table
// entry's hysteresis kernel at row length T on the z-table source
// (source 0) or the stochastic source (source 1), as dbx_band_table and
// dbx_band_stoch launch it.
extern "C" int dbx_band_occupancy(int source, int T, int* info) {
  const size_t r_bytes = static_cast<size_t>(T) * sizeof(float);
  if (source == 0) {
    if (r_bytes <= kMaxStagedBytes) {
      return dbx::launch_report(band_source_kernel<kHysteresis, TableZ<true>>,
                                kThreads, r_bytes, info);
    }
    return dbx::launch_report(band_source_kernel<kHysteresis, TableZ<false>>,
                              kThreads, 0, info);
  }
  if (dbx::channel_staged(T)) {
    return dbx::launch_report(band_source_kernel<kHysteresis, StochZ<true>>,
                              kStochThreads, dbx::channel_smem_bytes(T),
                              info);
  }
  return dbx::launch_report(band_source_kernel<kHysteresis, StochZ<false>>,
                            kStochThreads, 0, info);
}

// dbx_pairs (K7): z, hr: (N, W, T) f32 spread z-table (0 before each
// lookback's warmup) and hedged-return table; t_real: (N,) i32; wins:
// (n_tiles, wmax) i32, the sorted distinct table rows each tile of `lanes`
// lanes reads, counts: (n_tiles,) i32 their number; wi: (P,) i32 each
// lane's index into its tile's list; k, z_exit: (P,) f32 entry and exit
// bands; warm: (P,) i32 (truncated 2 * lookback - 1). lanes: a multiple of
// 32 up to 1024, the lanes a CTA.
extern "C" int dbx_pairs(const void* z, const void* hr, const void* t_real,
                         const void* wins, const void* counts, const void* wi,
                         const void* k, const void* z_exit, const void* warm,
                         void* out, int N, int T, int W, int P, int lanes,
                         int wmax, float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = dbx::block_smem_bytes(wmax, dbx::kPairs);
  const int err = dbx::allow_smem(pairs_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(N, (P + lanes - 1) / lanes);
  pairs_kernel<<<grid, lanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(hr),
      static_cast<const int*>(t_real), static_cast<const int*>(wins),
      static_cast<const int*>(counts), static_cast<const int*>(wi),
      static_cast<const float*>(k), static_cast<const float*>(z_exit),
      static_cast<const int*>(warm), static_cast<float*>(out), N, T, W, P,
      wmax, cost, static_cast<float>(ppy));
  return static_cast<int>(cudaGetLastError());
}

// dbx_pairs_occupancy: the build report (occupancy.cuh) of K7's kernel
// launched as dbx_pairs launches it on `lanes`-lane tiles with lists of at
// most `wmax` rows.
extern "C" int dbx_pairs_occupancy(int lanes, int wmax, int* info) {
  if (!dbx::tile_ok(lanes, wmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dbx::launch_report(pairs_kernel, lanes,
                            dbx::block_smem_bytes(wmax, dbx::kPairs), info);
}
