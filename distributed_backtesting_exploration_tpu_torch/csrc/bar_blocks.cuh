// Per-window values formed once per bar block in shared memory and shared
// by the lanes of one CTA: the read path of K1 (fused_sma.cu,
// dbx_fused_sma), of K2's inline entry (band_machine.cu, dbx_band_inline)
// and of K6 (fused_sma.cu, dbx_obv: the sign of OBV minus its SMA).
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

#pragma once

#include <cuda_runtime.h>

namespace dbx {

// Shared-memory budget of one of a CTA's two bar blocks, and the most bars
// a block holds.
constexpr size_t kBlockBudget = 48 * 1024;
constexpr int kMaxBlockBars = 128;
// The widest tile: one lane a thread, 1024 threads a CTA.
constexpr int kMaxTileLanes = 1024;

// Bars a block holds for a list of `wc` windows: B = clamp(budget /
// (4 (wc + 1)), 1, 128) (the values and the returns row).
__host__ __device__ inline int block_bars(int wc) {
  const size_t b = kBlockBudget / (sizeof(float) * (wc + 1));
  return b < 1 ? 1 : (b > kMaxBlockBars ? kMaxBlockBars : static_cast<int>(b));
}

// The dynamic shared memory of a launch whose lists hold at most `wmax`
// windows: two blocks of what block_bars asks for the longest such list,
// two budgets from 95 windows on.
inline size_t block_smem_bytes(int wmax) {
  const size_t full = sizeof(float) * kMaxBlockBars * (wmax + 1);
  return 2 * (full < kBlockBudget ? full : kBlockBudget);
}

// A tile's width and lists are usable: lanes a multiple of 32 up to 1024,
// room for at least one window.
inline bool tile_ok(int lanes, int wmax) {
  return lanes >= 32 && lanes <= kMaxTileLanes && lanes % 32 == 0 &&
         wmax >= 1;
}

// One CTA's pass over bars [0, tr) in blocks of B = block_bars(wc): for
// each block, vals[b * wc + j] = value(j, t0 + b) for every window j < wc
// and bar b of the block, and the block's returns from `r_row`; then, on a
// lane that is `live`, step(vals + b * wc, r[t0 + b], t0 + b) for each bar
// in order. Block k + 1 is filled in the other buffer while block k is
// stepped. Every thread of the CTA takes part in the fill and the barriers.
template <class Value, class Step>
__device__ __forceinline__ void bar_block_pass(float* smem, int wc, int tr,
                                               const float* r_row, bool live,
                                               Value value, Step step) {
  const int B = block_bars(wc);
  const int stride = B * (wc + 1);  // one buffer: B rows of values, returns
  // This thread's first (bar, window) slot of a block and its stride.
  const int j0 = threadIdx.x % wc;
  const int b0 = threadIdx.x / wc;
  const int dj = blockDim.x % wc;
  const int db = blockDim.x / wc;
  const auto fill = [&](float* buf, int t0) {
    const int nb = min(B, tr - t0);
    for (int b = b0, j = j0; b < nb;) {
      buf[b * wc + j] = value(j, t0 + b);
      j += dj;
      b += db;
      if (j >= wc) {
        j -= wc;
        ++b;
      }
    }
    float* rs = buf + B * wc;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) rs[b] = r_row[t0 + b];
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
      for (int b = 0; b < nb; ++b) step(cur + b * wc, cur[B * wc + b], t0 + b);
    }
    __syncthreads();
  }
}

}  // namespace dbx
