// Roofline stage scaffolds for Hopper (sm_90a): K8 of the port.
//
// Replaces the two TPU kernels of the reference's bench.py
// `roofline_stages` config: `stage_call` (body `stage_kernel`, the SMA
// crossover kernel `_kernel` of distributed_backtesting_exploration_tpu/
// ops/fused.py reading its HBM table) and `boll_stage_call` (body
// `boll_stage_kernel`, the bollinger kernel `_boll_kernel`). Each is the
// shipped kernel cut after one stage, so that timing consecutive stages
// tells where a kernel's time goes. They compute no backtest a user asks
// for, except the `full` stage, which is the shipped kernel end to end.
//
// Stages, for each (ticker, lane): `x` is the lane's selected value at
// bar t, the SMA table's fast row minus its slow row (SMA) or its window's
// row of the z-table (bollinger); `pos` the lane's position (SMA: sign(x)
// from bar warm - 1, else 0; bollinger: the 3-state hysteresis machine of
// band_next.cuh with the lane's k and z_exit = 0 from bar warm - 1).
// - touch: the sum of the ticker's whole table, in every lane;
// - matmul: the sum of x over the T_pad bars (the reference's one-hot
//   selection matmul; here a gather and one subtraction, bit-equal to the
//   +-1 one-hot);
// - signal: the sum of pos * r over the T_pad bars;
// - no_ladders: the one-pass reductions of the metrics tail over the
//   ticker's `tr` real bars (positions held after them, which adds exact
//   zeros), without the equity, peak and drawdown that the reference
//   computes with its two shift ladders: SMA rows s1, s2, mean, std, dstd,
//   hit, turnover, std, s1; bollinger rows s1, s2, mean, std, std, s1,
//   turnover, std, s1;
// - full: the shipped metrics tail, MetricsAcc of metrics_tail.cuh.
// Every stage writes all 9 output rows (a one-value stage writes its value
// to each), so every variant has the same output traffic and no stage's
// work can be compiled away. The wrapper reads row 0.
//
// Design. One CTA per (ticker, block of `lanes` lanes), one thread per
// lane, `lanes` in {128, 256, 512, 1024} (the reference's block-width
// experiment). The returns row is staged in shared memory (5 KB at
// T_pad = 1264); each lane reads its table row(s) from global memory bar
// by bar. touch is a CTA-cooperative sum: thread i adds elements i,
// i + lanes, ... of the ticker's flattened (W_pad, T_pad) table, so a
// warp's loads coalesce, then a tree halves the partial sums in shared
// memory. The order is fixed, so every CTA of a ticker gets the same sum
// and the plain version (ops/stages.py) repeats it bit for bit.
// The stage is a template parameter: each variant compiles only the work
// up to its cut.
//
// What bounds it. touch and matmul are bound by bytes (the SMA table at the
// bench shape is 500 x 120 x 1264 x 4 B = 303 MB, about 0.09 ms at
// 3.35 TB/s); every ticker's CTAs re-read its table (16 at 2000 lanes),
// which only L2 can serve at that rate. From signal on the stages are
// bound by their fp32 operations (about 20 a lane a bar for full), and the
// table reads of the SMA grid, whose warps hold 32 slow windows and so
// read 32 rows a bar, keep them above it. Making them fast is later work;
// these kernels exist to split a kernel's time by stage.
//
// Built with -fmad=false and IEEE division and square root, as every
// source here: the plain version's tensor ops round each operation once,
// in the same order.

#include "band_next.cuh"
#include "metrics_tail.cuh"

namespace {

constexpr int kMaxLanes = 1024;
constexpr size_t kMaxStagedBytes = 96 * 1024;
constexpr int kRows = 9;

constexpr int kSma = 0;
constexpr int kBoll = 1;

constexpr int kTouchStage = 0;
constexpr int kMatmul = 1;
constexpr int kSignal = 2;
constexpr int kNoLadders = 3;
constexpr int kFull = 4;

__device__ __forceinline__ void write_rows(float* out, size_t plane,
                                           size_t at, const float* rows) {
  for (int i = 0; i < kRows; ++i) out[i * plane + at] = rows[i];
}

__device__ __forceinline__ void write_value(float* out, size_t plane,
                                            size_t at, float v) {
  for (int i = 0; i < kRows; ++i) out[i * plane + at] = v;
}

// The lane's selected value at bar t: fast row minus slow row (SMA), or
// its z row (bollinger).
template <int kFamily>
__device__ __forceinline__ float selected(const float* a, const float* b,
                                          int t) {
  if (kFamily == kSma) return a[t] - b[t];
  return a[t];
}

// The lane's position at bar t from its selected value x and its previous
// position `state`.
template <int kFamily>
__device__ __forceinline__ float position(float state, float x, float k,
                                          int t, int t_on) {
  if (t < t_on) return 0.f;
  if (kFamily == kSma) return dbx::sign_of(x);
  return dbx::band_next<dbx::kHysteresis>(state, x, k, 0.f);
}

// The one-pass reductions of the no_ladders stage: MetricsAcc::step without
// the equity, its running peak and the drawdown, in the same op order.
// kDownHit adds the downside square sum and the hit counts (the SMA
// scaffold's rows; the bollinger scaffold's have neither).
template <bool kDownHit>
struct ReductionAcc {
  float prev = 0.f, s1 = 0.f, s2 = 0.f, dsq = 0.f, wins = 0.f, active = 0.f;
  float turn = 0.f;

  __device__ __forceinline__ void step(float pos, float r, float cost) {
    const float dp = fabsf(pos - prev);
    const float net = prev * r - cost * dp;
    s1 += net;
    s2 += net * net;
    if (kDownHit) {
      const float down = fminf(net, 0.f);
      dsq += down * down;
      if (prev != 0.f) {
        active += 1.f;
        if (net > 0.f) wins += 1.f;
      }
    }
    turn += dp;
    prev = pos;
  }

  __device__ __forceinline__ void store(float* out, size_t plane, size_t at,
                                        int tr) const {
    const float nf = static_cast<float>(tr);
    const float mean = s1 / nf;
    const float sd = sqrtf(fmaxf(s2 / nf - mean * mean, 0.f));
    if (kDownHit) {
      const float dstd = sqrtf(dsq / nf);
      const float hit = wins / (active + dbx::kEps);
      const float rows[kRows] = {s1, s2, mean, sd, dstd, hit, turn, sd, s1};
      write_rows(out, plane, at, rows);
    } else {
      const float rows[kRows] = {s1, s2, mean, sd, sd, s1, turn, sd, s1};
      write_rows(out, plane, at, rows);
    }
  }
};

// row_a, row_b: each lane's fast and slow rows in the table (SMA), or its
// window's row and nullptr (bollinger); k: the lanes' entry bands
// (bollinger) or nullptr. out: (9, N, P). `staged`: the returns row fits
// the shared memory the launch gave.
template <int kFamily, int kStage>
__global__ void __launch_bounds__(kMaxLanes) stage_kernel(
    const float* __restrict__ r, const float* __restrict__ tbl,
    const int* __restrict__ row_a, const int* __restrict__ row_b,
    const float* __restrict__ k, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int W, int P, int tr, bool staged,
    float cost, float ppy) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int lanes = blockDim.x;
  const int p = blockIdx.y * lanes + threadIdx.x;
  const size_t plane = static_cast<size_t>(N) * P;
  const size_t at = static_cast<size_t>(n) * P + p;
  const float* table = tbl + static_cast<size_t>(n) * W * T;

  if (kStage == kTouchStage) {
    const size_t total = static_cast<size_t>(W) * T;
    float s = 0.f;
    for (size_t i = threadIdx.x; i < total; i += lanes) s += table[i];
    smem[threadIdx.x] = s;
    __syncthreads();
    for (int h = lanes / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) smem[threadIdx.x] += smem[threadIdx.x + h];
      __syncthreads();
    }
    if (p < P) write_value(out, plane, at, smem[0]);
    return;
  }

  const float* r_row = r + static_cast<size_t>(n) * T;
  if (kStage != kMatmul && staged) {
    for (int t = threadIdx.x; t < T; t += lanes) smem[t] = r_row[t];
    __syncthreads();
    r_row = smem;
  }
  if (p >= P) return;

  const float* a = table + static_cast<size_t>(row_a[p]) * T;
  const float* b =
      kFamily == kSma ? table + static_cast<size_t>(row_b[p]) * T : nullptr;

  if (kStage == kMatmul) {
    float v = 0.f;
    for (int t = 0; t < T; ++t) v += selected<kFamily>(a, b, t);
    write_value(out, plane, at, v);
    return;
  }

  const float kk = kFamily == kBoll ? k[p] : 0.f;
  const int t_on = warm[p] - 1;
  if (kStage == kSignal) {
    float v = 0.f, state = 0.f;
    for (int t = 0; t < T; ++t) {
      state = position<kFamily>(state, selected<kFamily>(a, b, t), kk, t,
                                t_on);
      v += state * r_row[t];
    }
    write_value(out, plane, at, v);
  } else if (kStage == kNoLadders) {
    ReductionAcc<kFamily == kSma> acc;
    for (int t = 0; t < tr; ++t) {
      acc.step(position<kFamily>(acc.prev, selected<kFamily>(a, b, t), kk,
                                 t, t_on),
               r_row[t], cost);
    }
    acc.store(out, plane, at, tr);
  } else {
    dbx::MetricsAcc acc;
    for (int t = 0; t < tr; ++t) {
      acc.step(position<kFamily>(acc.prev, selected<kFamily>(a, b, t), kk,
                                 t, t_on),
               r_row[t], cost);
    }
    acc.store(out, n, p, N, P, tr, ppy);
  }
}

template <int kFamily, int kStage>
int launch(const float* r, const float* tbl, const int* row_a,
           const int* row_b, const float* k, const int* warm, float* out,
           int N, int T, int W, int P, int tr, int lanes, float cost,
           float ppy, cudaStream_t s) {
  const dim3 grid(N, (P + lanes - 1) / lanes);
  size_t smem = 0;
  if (kStage == kTouchStage) {
    smem = static_cast<size_t>(lanes) * sizeof(float);
  } else if (kStage != kMatmul) {
    smem = static_cast<size_t>(T) * sizeof(float);
  }
  const bool staged = smem <= kMaxStagedBytes;
  if (!staged) smem = 0;
  const int err = dbx::allow_smem(stage_kernel<kFamily, kStage>, smem);
  if (err != 0) return err;
  stage_kernel<kFamily, kStage><<<grid, lanes, smem, s>>>(
      r, tbl, row_a, row_b, k, warm, out, N, T, W, P, tr, staged, cost, ppy);
  return static_cast<int>(cudaGetLastError());
}

template <int kFamily>
int dispatch(const void* r, const void* tbl, const void* row_a,
             const void* row_b, const void* k, const void* warm, void* out,
             int N, int T, int W, int P, int tr, int stage, int lanes,
             float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (lanes != 128 && lanes != 256 && lanes != 512 && lanes != 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tr < 1 || tr > T) return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch<kFamily, kFull>) fn;
  switch (stage) {
    case kTouchStage: fn = launch<kFamily, kTouchStage>; break;
    case kMatmul: fn = launch<kFamily, kMatmul>; break;
    case kSignal: fn = launch<kFamily, kSignal>; break;
    case kNoLadders: fn = launch<kFamily, kNoLadders>; break;
    case kFull: fn = launch<kFamily, kFull>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(static_cast<const float*>(r), static_cast<const float*>(tbl),
            static_cast<const int*>(row_a), static_cast<const int*>(row_b),
            static_cast<const float*>(k), static_cast<const int*>(warm),
            static_cast<float*>(out), N, T, W, P, tr, lanes, cost,
            static_cast<float>(ppy), static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points (loaded with ctypes). Pointers are device pointers; each
// launches on `stream` and returns cudaGetLastError() as an int. stage:
// 0 touch, 1 matmul, 2 signal, 3 no_ladders, 4 full; lanes: threads a CTA,
// 128, 256, 512 or 1024; tr: the real bars, 1 <= tr <= T. out: (9, N, P)
// f32.
//
// dbx_sma_stage: r: (N, T) f32 simple returns of the padded close; tbl:
// (N, W, T) f32 SMA table; fast, slow: (P,) i32 rows of each lane's
// windows in it; warm: (P,) i32.
extern "C" int dbx_sma_stage(const void* r, const void* tbl,
                             const void* fast, const void* slow,
                             const void* warm, void* out, int N, int T,
                             int W, int P, int tr, int stage, int lanes,
                             float cost, int ppy, void* stream) {
  return dispatch<kSma>(r, tbl, fast, slow, nullptr, warm, out, N, T, W, P,
                        tr, stage, lanes, cost, ppy, stream);
}

// dbx_boll_stage: r: (N, T) f32; z: (N, W, T) f32 z-table; widx: (P,) i32
// row of each lane; k: (P,) f32 entry bands; warm: (P,) i32.
extern "C" int dbx_boll_stage(const void* r, const void* z, const void* widx,
                              const void* k, const void* warm, void* out,
                              int N, int T, int W, int P, int tr, int stage,
                              int lanes, float cost, int ppy, void* stream) {
  return dispatch<kBoll>(r, z, widx, nullptr, k, warm, out, N, T, W, P, tr,
                         stage, lanes, cost, ppy, stream);
}
