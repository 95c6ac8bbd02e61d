// Build report of a kernel: what the card makes of it at launch, for the
// diagnostics of chip_smoke.py. Not on any launch path.

#pragma once

#include <cuda_runtime.h>

namespace dbx {

// Fills info[0..3] with the registers a thread of `kernel`, its resident
// CTAs an SM, and the `lanes` and `smem` bytes of dynamic shared memory it
// is launched with. Returns a cudaError_t as an int.
template <typename Kernel>
inline int launch_report(Kernel kernel, int lanes, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, lanes,
                                                      smem);
  info[0] = attr.numRegs;
  info[1] = ctas;
  info[2] = lanes;
  info[3] = static_cast<int>(smem);
  return static_cast<int>(err);
}

}  // namespace dbx
