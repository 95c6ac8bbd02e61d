// Chained EMA ladders on the card for Hopper (sm_90a): the triple-EMA
// table that K5 (dbx_trix) reads.
//
// Replaces the table prep of the reference's TPU kernel,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_fused_trix_call`
// (:3009) builds, per distinct span, `_ema_rows(_ema_rows(_ema_rows(close,
// a), a), a)` (:3016-3021; `_ema_rows` :1732), the shift-doubling ladder of
// the EMA run three times, and stacks the rows into an (N, W, T) table. The
// port's plain version is ops/fused.py `trix_ema_table` (three chained
// ops/rolling.py `ema_ladder` calls in torch: 11 passes of two `cat`s and
// three elementwise ops over the whole (N, W, T) tensor each, at the bench
// shape about 165 launches over 25 MB apiece).
//
// Design.
// - One CTA per (ticker, distinct span) row. Its B row, the ladder's
//   running sums, lives in shared memory as two buffers of T floats (8 B a
//   bar): a pass reads one and writes the other, so one barrier a pass
//   separates its reads from its writes. The first ladder reads the input
//   row from device memory; each later one starts from the row the last
//   left. Only the finished row is written out.
// - The ladder op for op (rolling.ema_ladder): B = x at bar 0 and x * a
//   after; then for step s = 1, 2, 4, ... < T, B[t] = A[t] * Be[t] + B[t]
//   with Be[t] = B[t - s] (0 below s), the multiply and the add two
//   operations. a = 2 / (span + 1) comes in as the f32 value torch formed
//   (rolling._decay), so the decay is the same in both.
// - The ladder's A row needs no memory: it is a function of the decay and
//   the bar alone. It starts as 0 at bar 0 and 1 - a after, and a pass
//   turns it into Ae * A, so after the pass of step s it is 0 below 2s and
//   q * q above, where q was its value above s: the pass before the one of
//   step s leaves A[t] = 0 for t < s and q for t >= s, with q = 1 - a at
//   s = 1 and squared each pass. The kernel carries q and forms the same
//   products torch forms (0 * q = 0 and q * q), so every A[t] it uses is
//   the plain version's, bit for bit.
// - Rows too long for the staging budget run the same code on two rows of
//   device-memory scratch that the wrapper allocates (kStaged false).
// - `ladders` chained ladders, 3 for trix; 1 gives the one-ladder table of
//   macd (`macd_ema_table`, the EMAs of the demeaned close).
//
// What bounds it on this card: the table it writes, 4 B a (ticker, span,
// bar) to device memory, beside 2 fp32 operations a (row, bar, pass) of
// ceil(log2 T) passes a ladder (the B update; A is one product a pass). At
// the bench shape (500 x 10 x 1260, 3 ladders) the operations take about
// 13 us at the fp32 rate and the 25 MB table 7.5 us at 3.35 TB/s; the
// ladder's passes are barrier-separated, so each CTA holds only its row in
// shared memory (10 KB) and many CTAs share an SM.
//
// Built without fast math and with -fmad=false: no multiply-add is
// contracted, so every value rounds as the torch ops of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxStagedBytes = 96 * 1024;

// Floats of shared memory (or scratch) a row needs: its two B buffers.
__host__ __device__ inline size_t row_floats(int T) {
  return 2 * static_cast<size_t>(T);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) ema_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ decay,
    float* __restrict__ out, float* __restrict__ scratch, int T, int W,
    int ladders) {
  extern __shared__ float staged[];
  const size_t row = blockIdx.x;            // n * W + span
  const int n = static_cast<int>(row / W);
  const float a = decay[row % W];
  float* cur = kStaged ? staged : scratch + row * row_floats(T);
  float* nxt = cur + T;
  const float* in = x + static_cast<size_t>(n) * T;
  for (int l = 0; l < ladders; ++l) {
    // A reads and writes its own bar only: in place from the second on.
    for (int t = threadIdx.x; t < T; t += kThreads) {
      const float v = in[t];
      cur[t] = t == 0 ? v : v * a;
    }
    __syncthreads();
    float q = 1.f - a;                      // A[t] for t >= s
    for (int s = 1; s < T; s *= 2) {
      for (int t = threadIdx.x; t < T; t += kThreads) {
        const bool on = t >= s;
        const float at = on ? q : 0.f;
        const float be = on ? cur[t - s] : 0.f;
        nxt[t] = at * be + cur[t];
      }
      __syncthreads();
      float* done = nxt;
      nxt = cur;
      cur = done;
      q = q * q;
    }
    in = cur;
  }
  float* o = out + row * T;
  for (int t = threadIdx.x; t < T; t += kThreads) o[t] = cur[t];
}

}  // namespace

// dbx_ema_rows_scratch: floats of device-memory scratch each (ticker, span)
// row of dbx_ema_rows needs at row length T; 0 where the rows are staged in
// shared memory.
extern "C" int dbx_ema_rows_scratch(int T) {
  const size_t floats = row_floats(T);
  return floats * sizeof(float) <= kMaxStagedBytes ? 0
                                                   : static_cast<int>(floats);
}

// dbx_ema_rows: x (N, T) f32 rows; decay (W,) f32 EMA decays; out (N, W, T)
// f32, row (n, w) the EMA of x[n] with decay[w] chained `ladders` times (1
// to 3); scratch: N * W * dbx_ema_rows_scratch(T) f32 where that is not 0,
// else unused. Pointers are device pointers. Launches on `stream` and
// returns cudaGetLastError() as an int.
extern "C" int dbx_ema_rows(const void* x, const void* decay, void* out,
                            void* scratch, int N, int T, int W, int ladders,
                            void* stream) {
  if (N <= 0 || W <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  if (ladders < 1 || ladders > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned rows = static_cast<unsigned>(N) * static_cast<unsigned>(W);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* dp = static_cast<const float*>(decay);
  auto* op = static_cast<float*>(out);
  if (dbx_ema_rows_scratch(T) == 0) {
    const size_t smem = row_floats(T) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ema_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    ema_rows_kernel<true><<<rows, kThreads, smem, s>>>(xp, dp, op, nullptr,
                                                       T, W, ladders);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    ema_rows_kernel<false><<<rows, kThreads, 0, s>>>(
        xp, dp, op, static_cast<float*>(scratch), T, W, ladders);
  }
  return static_cast<int>(cudaGetLastError());
}
