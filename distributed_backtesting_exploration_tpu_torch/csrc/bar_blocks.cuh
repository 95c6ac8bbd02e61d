// Per-window values formed once per bar block in shared memory and shared
// by the lanes of one CTA: the read path of K1 (fused_sma.cu,
// dbx_fused_sma), of K2's inline entry (band_machine.cu, dbx_band_inline),
// of K4 and K5 (ema_cross.cu, dbx_macd: the macd line of each (fast, slow)
// pair; dbx_trix: each span's rate of change), of K6 (fused_sma.cu,
// dbx_obv: the sign of OBV minus its SMA) and of K7 (band_machine.cu,
// dbx_pairs: each lookback's z and hedged return).
//
// Replaces the per-ticker tables of the reference's TPU kernels,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_kernel_inline`
// builds the SMA table of every distinct window in VMEM,
// `_build_boll_z_scratch` the Bollinger z-table and `_obv_kernel_inline`
// the SMA-of-OBV table, once per ticker; each lane then selects its rows.
// A whole table does not fit in a block's shared memory on Hopper (120
// windows x 1264 bars x 4 B = 606 KB at the headline), so here a CTA (one
// ticker, one tile of lanes) forms the values of its tile's windows a
// block of B bars at a time.
//
// A tile's windows are a row of a padded (n_tiles, Wc) list that the
// wrapper builds with torch ops on the card (ops/fused.py `window_tiles`),
// with the row's count and each lane's index into it. Per block the CTA's
// threads together fill vals[b][j] (bar b of the block, window j of the
// list; window-minor, so a warp's lanes on one window read one word, a
// broadcast, and on consecutive windows consecutive banks) and the block's
// returns, and every lane steps its B bars reading its window's value from
// vals. Two buffers alternate: while the lanes step one block, the CTA
// fills the next, so one barrier a block separates them. B follows from the
// CTA's own count, so shared memory is bounded by a fixed budget, not by
// the row length or the grid, and every shape runs this one path. The
// budget, the 128-bar cap and the double buffering are the fastest of a
// sweep on the H100 (PERF.md, section 6).
//
// Two layouts of a block, fixed at compile time: kValues, one float a
// window and the ticker's returns row (every entry but K7); kPairs, a
// float2 a window, its value and the return a lane on it earns, and no
// returns row (K7: each lookback's z and its hedged return). Two ways to
// step a block share the pass: bar_block_pass, where a lane may read any
// window of a bar (K1, K2 inline, K5, K6), and lane_block_pass, where it
// reads its own window only and walks it by pointer (K4, K7), with an
// optional first-bar step.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace dbx {

// A block's layout: kValues, one float a window and the bar's return from
// the ticker's returns row; kPairs, a float2 a window (the window's value
// and the return it earns) and no returns row.
constexpr int kValues = 0;
constexpr int kPairs = 1;

// Shared-memory budget of one of a CTA's two bar blocks, and the most bars
// a block holds.
constexpr size_t kBlockBudget = 48 * 1024;
constexpr int kMaxBlockBars = 128;
// The widest tile: one lane a thread, 1024 threads a CTA.
constexpr int kMaxTileLanes = 1024;

// The floats a bar of a block takes for a list of `wc` windows: the values
// and the return (kValues), or a value and a return a window (kPairs).
__host__ __device__ inline int bar_floats(int wc, int layout) {
  return layout == kPairs ? 2 * wc : wc + 1;
}

// Bars a block holds for a list of `wc` windows: B = clamp(budget /
// (4 bar_floats), 1, 128).
__host__ __device__ inline int block_bars(int wc, int layout = kValues) {
  const size_t b = kBlockBudget / (sizeof(float) * bar_floats(wc, layout));
  return b < 1 ? 1 : (b > kMaxBlockBars ? kMaxBlockBars : static_cast<int>(b));
}

// The dynamic shared memory of a launch whose lists hold at most `wmax`
// windows: two blocks of what block_bars asks for the longest such list,
// two budgets from 95 windows on (48 with kPairs).
inline size_t block_smem_bytes(int wmax, int layout = kValues) {
  const size_t full = sizeof(float) * kMaxBlockBars * bar_floats(wmax, layout);
  return 2 * (full < kBlockBudget ? full : kBlockBudget);
}

// A tile's width and lists are usable: lanes a multiple of 32 up to 1024,
// room for at least one window.
inline bool tile_ok(int lanes, int wmax) {
  return lanes >= 32 && lanes <= kMaxTileLanes && lanes % 32 == 0 &&
         wmax >= 1;
}

// One CTA's pass over bars [0, tr) in blocks of B = block_bars(wc,
// kLayout), shared by bar_block_pass and lane_block_pass: for each block,
// slot b * wc + j = value(j, t0 + b) for every window j < wc and bar b of
// the block (a float, or with kPairs a float2), and with kValues the
// block's returns from `r_row` (unused with kPairs) after its B slot rows;
// then, on a lane that is `live`, step_block(buffer, B, t0, nb) steps the
// block's nb bars from bar t0. Block k + 1 is filled in the other buffer
// while block k is stepped. Every thread of the CTA takes part in the fill
// and the barriers.
template <int kLayout, class Value, class StepBlock>
__device__ __forceinline__ void block_pass(float* smem, int wc, int tr,
                                           const float* r_row, bool live,
                                           Value value, StepBlock step_block) {
  using Slot = typename std::conditional<kLayout == kPairs, float2,
                                         float>::type;
  const int B = block_bars(wc, kLayout);
  const int stride = B * bar_floats(wc, kLayout);  // floats a buffer
  // This thread's first (bar, window) slot of a block and its stride.
  const int j0 = threadIdx.x % wc;
  const int b0 = threadIdx.x / wc;
  const int dj = blockDim.x % wc;
  const int db = blockDim.x / wc;
  const auto fill = [&](float* buf, int t0) {
    const int nb = min(B, tr - t0);
    Slot* slots = reinterpret_cast<Slot*>(buf);
    for (int b = b0, j = j0; b < nb;) {
      slots[b * wc + j] = value(j, t0 + b);
      j += dj;
      b += db;
      if (j >= wc) {
        j -= wc;
        ++b;
      }
    }
    if constexpr (kLayout == kValues) {
      float* rs = buf + B * wc;
      for (int b = threadIdx.x; b < nb; b += blockDim.x) rs[b] = r_row[t0 + b];
    }
  };
  if (tr > 0) fill(smem, 0);
  __syncthreads();
  int k = 0;
  for (int t0 = 0; t0 < tr; t0 += B, k ^= 1) {
    // The other buffer was last read before the previous barrier.
    if (t0 + B < tr) fill(smem + (k ^ 1) * stride, t0 + B);
    const float* cur = smem + k * stride;
    if (live) {
      const int nb = min(B, tr - t0);
      step_block(cur, B, t0, nb);
    }
    __syncthreads();
  }
}

// The pass of a lane that may read any window of a bar (K1 reads two, its
// fast and its slow one): step(v, rt, t) for each bar t in order, v the
// bar's row of wc values, rt its return.
template <class Value, class Step>
__device__ __forceinline__ void bar_block_pass(float* smem, int wc, int tr,
                                               const float* r_row, bool live,
                                               Value value, Step step) {
  block_pass<kValues>(smem, wc, tr, r_row, live, value,
                      [&](const float* cur, int B, int t0, int nb) {
                        for (int b = 0; b < nb; ++b) {
                          step(cur + b * wc, cur[B * wc + b], t0 + b);
                        }
                      });
}

// lane_block_pass's first-bar step where none is given: the loop's step
// takes bar 0 too.
struct EveryBar {};

// The pass of a lane that reads one window, its index `slot` in the list
// (K4, K7): step(x, rt, t) with its value x and the bar's return rt
// (kValues), step(x, t) with its (value, return) float2 (kPairs), for each
// bar t in order; `first` in place of `step` at bar 0 where one is given
// (a bar-0 step peeled out of the loop, so the loop's step needs no bar-0
// select). The lane walks its slot down the block by pointer, so no index
// arithmetic sits on its chain.
template <int kLayout, class Value, class Step, class First = EveryBar>
__device__ __forceinline__ void lane_block_pass(float* smem, int wc, int tr,
                                                const float* r_row, bool live,
                                                int slot, Value value,
                                                Step step,
                                                First first = First()) {
  using Slot = typename std::conditional<kLayout == kPairs, float2,
                                         float>::type;
  const auto at = [](auto& f, const Slot* x, const float* r, int t) {
    if constexpr (kLayout == kPairs) {
      f(*x, t);
    } else {
      f(*x, *r, t);
    }
  };
  block_pass<kLayout>(
      smem, wc, tr, r_row, live, value,
      [&](const float* cur, int B, int t, int nb) {
        const Slot* x = reinterpret_cast<const Slot*>(cur) + slot;
        const float* r = cur + B * wc;
        const int end = t + nb;
        if constexpr (!std::is_same<First, EveryBar>::value) {
          if (t == 0) {
            at(first, x, r, 0);
            x += wc;
            ++r;
            ++t;
          }
        }
        for (; t < end; ++t, x += wc, ++r) at(step, x, r, t);
      });
}

}  // namespace dbx
