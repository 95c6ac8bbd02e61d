// The band machine's transition, shared by K2 and K7 (band_machine.cu) and
// by the bollinger stage scaffold (stages.cu), so that every kernel steps
// one machine and none keeps a copy of it.
//
// Replaces the per-bar transition maps of the reference's `_band_ladder`
// (distributed_backtesting_exploration_tpu/ops/fused.py), which the TPU
// composes as a log-depth ladder; here each thread steps it bar by bar.

#pragma once

namespace dbx {

constexpr int kHysteresis = 0;
constexpr int kTouch = 1;

// Next state of the band machine from `state` (exactly -1, 0 or +1) on a
// valid bar with z-score `z`: "hysteresis" enters long below -k and short
// above +k from flat, and leaves a long at z >= -z_exit and a short at
// z <= z_exit; "touch" is memoryless.
template <int kMachine>
__device__ __forceinline__ float band_next(float state, float z, float k,
                                           float z_exit) {
  const float entered = z < -k ? 1.f : (z > k ? -1.f : 0.f);
  if (kMachine == kTouch || state == 0.f) return entered;
  if (state > 0.f) return z >= -z_exit ? 0.f : state;
  return z <= z_exit ? 0.f : state;
}

}  // namespace dbx
