// Seeded source-pass defects for kernel-hygiene's csrc pass
// (tests/test_torch_kernel_hygiene.py). Never built.
#include <cstdio>

__device__ float twice(float v) { return 2.0f * v; }

__global__ void leaky_sum(const float* __restrict__ x, float* total,
                          int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    printf("thread %d\n", i);
    atomicAdd(total, twice(x[i]));
  }
}

__global__ void count_hits(const float* x, unsigned int* hits, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  // printf("a comment is no call\n");
  if (i < n && x[i] > 0.0f) atomicAdd(hits, 1u);
}

extern "C" int dbx_fixture(const float* x, float* total, int n) {
  std::printf("host side logging is not device code\n");
  leaky_sum<<<1, 32>>>(x, total, n);
  return 0;
}
