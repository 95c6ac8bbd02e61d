// Chained EMA ladders on the card for Hopper (sm_90a): the EMA table that
// K4 (dbx_macd) reads and the triple-EMA table that K5 (dbx_trix) reads.
//
// Replaces the table prep of the reference's TPU kernels,
// distributed_backtesting_exploration_tpu/ops/fused.py: `_fused_trix_call`
// (:3009) builds, per distinct span, `_ema_rows(_ema_rows(_ema_rows(close,
// a), a), a)` (:3016-3021; `_ema_rows` :1732), the shift-doubling ladder of
// the EMA run three times, and `_fused_macd_call` (:2661) one ladder of the
// close demeaned by its first bar (:2675-2677); each stacks the rows into
// an (N, W, T) table. The port's plain versions are ops/fused.py
// `trix_ema_table` and `macd_ema_table` (ops/rolling.py `ema_ladder` in
// torch: 11 passes of two `cat`s and three elementwise ops over the whole
// (N, W, T) tensor each).
//
// The ladder op for op (rolling.ema_ladder): B = x at bar 0 and x * a
// after; then for step s = 1, 2, 4, ... < T, B[t] = A[t] * Be[t] + B[t]
// with Be[t] = B[t - s] (0 below s), the multiply and the add two
// operations. a = 2 / (span + 1) comes in as the f32 value torch formed
// (rolling._decay). The ladder's A row needs no memory: before the pass of
// step s it is 0 below s and q above, with q = 1 - a at s = 1 and squared
// each pass (0 * q = 0 and q * q, the products torch forms), so the kernel
// carries q and every A[t] it uses is the plain version's, bit for bit.
// `ladders` chained ladders, 3 for trix; 1 gives macd's table.
//
// What bounds it on this card: the table it writes, 4 B a (ticker, span,
// bar) to device memory, beside 2 fp32 operations a (row, bar, pass) of
// ceil(log2 T) passes a ladder. At the bench shape (500 x 10 x 1260, 3
// ladders) the operations take about 13 us at the fp32 rate and the 25 MB
// table 7.5 us at 3.35 TB/s. The earlier design (one CTA of 256 threads a
// row in shared memory) spent its time on what surrounds that work: each
// pass read and wrote the row in shared memory between two barriers, 33
// barrier-separated passes a trix row for about 5 bars a thread each.
//
// This design holds a row in one warp's registers: bar t on lane t % 32 in
// register t / 32, R = ceil(T / 32) registers a lane, rounded up to one of
// a few compiled sizes (40 at T = 1260, at most 64). A step below 32 reads
// bar t - s from lane (lane - s) % 32, in the same register or, where lane
// < s, the one before: the sending lane picks which (one select) and one
// shuffle carries it. A step of 32 or more is a move between a lane's own
// registers, r - s / 32. The passes are unrolled so every register index
// is a constant, each pass walks the registers from the top down (so every
// read sees the pass's input), and the three ladders of trix chain in
// registers; only the finished row is written. Several rows a CTA, one a
// warp, and no barrier. Rows longer than the largest register plan (T >
// 2048) run the earlier design: the row in shared memory, or on two rows
// of device-memory scratch that the wrapper allocates where it is too long
// to stage (kStaged false).
//
// Built without fast math and with -fmad=false: no multiply-add is
// contracted, so every value rounds as the torch ops of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// The staged design (long rows): threads a CTA, and the shared memory a row
// may take before it runs on scratch.
constexpr int kThreads = 256;
constexpr size_t kMaxStagedBytes = 96 * 1024;
// The register design: rows a CTA (one a warp), and the largest number of
// registers a lane holds of a row.
constexpr int kRowWarps = 4;
constexpr int kMaxRegisters = 64;

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


// One (ticker, span) row a warp, bar t on lane t % 32 in b[t / 32]: the
// `ladders` chained ladders of x's row with decay `decay[row % W]`.
template <int R>
__global__ void __launch_bounds__(kRowWarps * 32) ema_rows_registers(
    const float* __restrict__ x, const float* __restrict__ decay,
    float* __restrict__ out, int N, int T, int W, int ladders) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / 32;
  if (row >= static_cast<long long>(N) * W) return;
  const float a = decay[row % W];
  const float* in = x + static_cast<size_t>(row / W) * T;
  float b[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = 32 * r + lane;
    b[r] = t < T ? in[t] : 0.f;
  }
  for (int l = 0; l < ladders; ++l) {
    // B = x at bar 0, x * a after.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r > 0 || lane > 0) b[r] = b[r] * a;
    }
    float q = 1.f - a;                      // A[t] for t >= s
    // Steps 1 .. 16: bar t - s is on lane (lane - s) % 32, in register r
    // or, where lane < s, r - 1; the sender picks (its lane < 32 - s keeps
    // r). Below bar s, A and Be are 0 (register 0, lanes below s).
#pragma unroll
    for (int s = 1; s < 32; s *= 2) {
      if (s >= T) break;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const float below = r > 0 ? b[r > 0 ? r - 1 : 0] : 0.f;
        const float send = lane < 32 - s ? b[r] : below;
        const float be = __shfl_sync(kFull, send, (lane - s) & 31);
        if (r > 0) {
          b[r] = q * be + b[r];
        } else {
          const bool on = lane >= s;
          b[r] = (on ? q : 0.f) * (on ? be : 0.f) + b[r];
        }
      }
      q = q * q;
    }
    // Steps 32 k: bar t - s is in the lane's own register r - k; below bar
    // s (registers under k) A and Be are 0.
#pragma unroll
    for (int k = 1; k < R; k *= 2) {
      if (32 * k >= T) break;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        if (r >= k) {
          b[r] = q * b[r >= k ? r - k : 0] + b[r];
        } else {
          b[r] = 0.f * 0.f + b[r];
        }
      }
      q = q * q;
    }
  }
  float* o = out + static_cast<size_t>(row) * T;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = 32 * r + lane;
    if (t < T) o[t] = b[r];
  }
}

// The compiled register sizes; registers(T) is the least that holds T bars,
// 0 above them all.
constexpr int kRegisterSizes[] = {1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64};
static_assert(kRegisterSizes[sizeof(kRegisterSizes) / sizeof(int) - 1] ==
                  kMaxRegisters,
              "the largest plan is kMaxRegisters");

inline int registers(int T) {
  const int need = (T + 31) / 32;
  for (const int r : kRegisterSizes) {
    if (r >= need) return r;
  }
  return 0;
}

template <int R>
int launch_registers(const float* x, const float* decay, float* out, int N,
                     int T, int W, int ladders, cudaStream_t s) {
  const long long rows = static_cast<long long>(N) * W;
  ema_rows_registers<R>
      <<<static_cast<unsigned>((rows + kRowWarps - 1) / kRowWarps),
         kRowWarps * 32, 0, s>>>(x, decay, out, N, T, W, ladders);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dbx_ema_rows_registers: the registers a lane holds of a row of
// dbx_ema_rows at row length T (one row a warp), 0 where the row is longer
// than the largest register plan and runs staged.
extern "C" int dbx_ema_rows_registers(int T) {
  return T > 0 ? registers(T) : 0;
}

// dbx_ema_rows_scratch: floats of device-memory scratch each (ticker, span)
// row of dbx_ema_rows needs at row length T; 0 where the rows are held in
// registers or staged in shared memory.
extern "C" int dbx_ema_rows_scratch(int T) {
  if (dbx_ema_rows_registers(T) != 0) return 0;
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
  switch (dbx_ema_rows_registers(T)) {
    case 1: return launch_registers<1>(xp, dp, op, N, T, W, ladders, s);
    case 2: return launch_registers<2>(xp, dp, op, N, T, W, ladders, s);
    case 4: return launch_registers<4>(xp, dp, op, N, T, W, ladders, s);
    case 8: return launch_registers<8>(xp, dp, op, N, T, W, ladders, s);
    case 16: return launch_registers<16>(xp, dp, op, N, T, W, ladders, s);
    case 24: return launch_registers<24>(xp, dp, op, N, T, W, ladders, s);
    case 32: return launch_registers<32>(xp, dp, op, N, T, W, ladders, s);
    case 40: return launch_registers<40>(xp, dp, op, N, T, W, ladders, s);
    case 48: return launch_registers<48>(xp, dp, op, N, T, W, ladders, s);
    case 56: return launch_registers<56>(xp, dp, op, N, T, W, ladders, s);
    case 64: return launch_registers<64>(xp, dp, op, N, T, W, ladders, s);
    default: break;
  }
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
