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
// - matmul: the sum of x over the T_pad bars in bar order (the reference's
//   one-hot selection matmul, then its sum over bars; here a gather and
//   one subtraction a bar, bit-equal to the +-1 one-hot);
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
// Design: one read path for every stage after touch, so that consecutive
// stages differ only in their per-bar work.
// - A ticker's CTAs run together. A CTA is one ticker x one tile of
//   `lanes` lanes (one thread a lane, 128-1024); the tile is the fastest
//   index of the 1-D grid, and a thread block cluster of C CTAs (a power of
//   2 up to 16, at most the ticker's tile count rounded up) holds
//   consecutive tiles of one ticker. Tiles pad to a multiple of C; a
//   padding CTA has no live lane and still takes part in the copies.
// - The table reaches shared memory in blocks of B bars by the Tensor
//   Memory Accelerator: the table is a 3-D tensor map (T, W, N), and each
//   of a cluster's first CTAs copies a box of B bars x a multiple of 8
//   rows of the block, multicast into every CTA of the cluster
//   (`cp.async.bulk.tensor ... .multicast::cluster`), so a block leaves L2
//   once a cluster; the last CTA copies the block's returns (from signal
//   on) with a 1-D bulk copy. Copies complete on an mbarrier ("full") of
//   each buffer. A ring of two buffers turns over: after a block every CTA
//   arrives on the "empty" mbarrier of that buffer in each CTA of the
//   cluster, and the first warp refills the buffer released the block
//   before once all have arrived, so one block is in flight while the
//   lanes step one.
// - In a buffer row j lies at j * B floats, B an odd number of 16-byte
//   words, so the 8 lanes of a quarter warp that read 8 neighbouring rows
//   hit 8 different bank groups. Each lane reads its row (rows) four bars
//   at a time (16-byte loads) and steps them in bar order; lanes of a warp
//   that share a row (the SMA's fast row) read it as a broadcast.
// - B follows from W_pad and the lanes: the buffers of a CTA take at most
//   1/ceil(1024 / lanes) of the SM's shared memory, so CTAs of 32 resident
//   warps fit an SM, and B is the deepest block that fits, up to 128 bars
//   (a 120-row table at 128 lanes: 20 bars). A wider table takes shorter
//   blocks, down to 4 bars; a table whose 4-bar blocks do not fit in
//   227 KB is refused (cudaErrorInvalidConfiguration, before any launch).
// - Clusters: 2 CTAs for the staged stages (chain-bound stages lose to
//   larger clusters, whose CTAs wait on each other's releases), 16 for
//   touch (each cluster reduces the whole table); at most a ticker's tile
//   count rounded up to a power of 2. The layout sweep of stage_sweep.py
//   builds this file with other cluster sizes, rings and block depths
//   (-D DBX_STAGE_*); no layout changes a bit of the output.
// - touch is one reduction per ticker in an order fixed by the table's
//   shape alone: the flattened table is cut into 64 chunks; a warp sums a
//   chunk with 16-byte loads into 4 independent float4 accumulators (lane
//   i adds words (j * 4 + u) * 32 + i, u the accumulator), folds them with
//   a fixed tree and the warp with a butterfly; the 64 chunk sums go to
//   the shared memory of the cluster's first CTA (distributed shared
//   memory), and every CTA folds them with the same tree (c[i] + c[i + 32],
//   then the butterfly). The plain version (ops/stages.py) repeats it bit
//   for bit; no lane count or cluster size changes a bit.
// The stage is a template parameter: each variant compiles only the work
// up to its cut.
//
// What bounds it. touch is bound by bytes: the SMA table at the bench
// shape is 500 x 120 x 1264 x 4 B = 303 MB, 0.09 ms at 3.35 TB/s, read
// once. matmul is bound by what the SMs take in: every 128-lane CTA stages
// the whole table of its ticker, 16 CTAs x 303 MB = 4.9 GB at the bench's
// 2000 lanes, which the card moves from L2 into shared memory at about
// 6 TB/s (the cluster multicast cuts the L2 reads, not the intake); wider
// CTAs take in less. From signal on the stages are bound by each lane's
// chain of dependent steps (about 50 SASS instructions a bar for full), as
// in K1. The measured times and sweeps are in PERF.md, section 6.
//
// Built with -fmad=false and IEEE division and square root, as every
// source here: the plain version's tensor ops round each operation once,
// in the same order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstdint>

#include "band_next.cuh"
#include "metrics_tail.cuh"
#include "occupancy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 9;

constexpr int kSma = 0;
constexpr int kBoll = 1;

constexpr int kTouchStage = 0;
constexpr int kMatmul = 1;
constexpr int kSignal = 2;
constexpr int kNoLadders = 3;
constexpr int kFull = 4;

constexpr int kMaxLanes = 1024;
// The most bars a derived block holds; the most rows or bars of one
// tensor copy's box.
constexpr int kMaxBlockBars = 128;
constexpr int kMaxBox = 256;

// The layout (see the top of the file); a build for the layout sweep sets
// these with -D. CTAs a cluster of the staged stages and of touch (16
// needs the non-portable cluster attribute), block buffers a CTA, and bars
// a block (0: derived from the table's width and the lanes).
#ifndef DBX_STAGE_CLUSTER
#define DBX_STAGE_CLUSTER 2
#endif
#ifndef DBX_TOUCH_CLUSTER
#define DBX_TOUCH_CLUSTER 16
#endif
#ifndef DBX_STAGE_RING
#define DBX_STAGE_RING 2
#endif
#ifndef DBX_STAGE_BARS
#define DBX_STAGE_BARS 0
#endif
constexpr int kStageCluster = DBX_STAGE_CLUSTER;
constexpr int kTouchCluster = DBX_TOUCH_CLUSTER;
constexpr int kRing = DBX_STAGE_RING;
constexpr int kBlockBars = DBX_STAGE_BARS;
static_assert(kStageCluster >= 1 && kStageCluster <= 16 &&
                  (kStageCluster & (kStageCluster - 1)) == 0 &&
                  kTouchCluster >= 1 && kTouchCluster <= 16 &&
                  (kTouchCluster & (kTouchCluster - 1)) == 0,
              "a cluster is a power of 2 up to 16 CTAs");
static_assert(kRing >= 2 && kRing <= 8, "a ring holds 2 to 8 buffers");
static_assert(kBlockBars >= 0 && kBlockBars <= kMaxBox && kBlockBars % 4 == 0,
              "a block holds a multiple of 4 bars, at most a box");
// The default block leaves room for this many resident warps an SM.
constexpr int kTargetWarps = 32;
// H100 (sm_90): shared memory of an SM, the part the runtime reserves for
// each CTA, and the most one CTA may take.
constexpr size_t kSmemPerSm = 228 * 1024;
constexpr size_t kSmemReserved = 1024;
constexpr size_t kMaxSmem = 227 * 1024;
// touch: chunks a ticker's table is cut into, float4 accumulators a lane.
constexpr int kTouchChunks = 64;
constexpr int kTouchAccs = 4;

// --- asynchronous copies and barriers (inline PTX) ------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the cluster's copies.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on `bar` and expect `bytes` more of asynchronous copies in its
// current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Arrive on the barrier at `bar`'s offset in the shared memory of the
// cluster's CTA `cta`, releasing this CTA's reads before it.
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(cta));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          remote)
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`: into this CTA alone (C == 1), or
// into the same offsets of every CTA of the cluster of C.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar,
                                          int C) {
  if (C == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  } else {
    const uint16_t mask = static_cast<uint16_t>((1u << C) - 1u);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
  }
}

// The (B bars x box rows) box of the 3-D tensor map at bar t0, row `row`
// of ticker n into shared `dst` (128-byte aligned), completing on `bar`:
// into this CTA alone (C == 1), or into every CTA of the cluster of C.
// Bars past T and rows past W land as zeros.
__device__ __forceinline__ void box_copy(float* dst, const CUtensorMap* map,
                                         int t0, int row, int n,
                                         uint64_t* bar, int C) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  if (C == 1) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
        "l"(desc), "r"(t0), "r"(row), "r"(n), "r"(smem_u32(bar))
        : "memory");
  } else {
    const uint16_t mask = static_cast<uint16_t>((1u << C) - 1u);
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;" ::"r"(
            smem_u32(dst)),
        "l"(desc), "r"(t0), "r"(row), "r"(n), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
  }
}

// --- the stages' per-lane work ---------------------------------------------

__device__ __forceinline__ void write_rows(float* out, size_t plane,
                                           size_t at, const float* rows) {
  for (int i = 0; i < kRows; ++i) out[i * plane + at] = rows[i];
}

__device__ __forceinline__ void write_value(float* out, size_t plane,
                                            size_t at, float v) {
  for (int i = 0; i < kRows; ++i) out[i * plane + at] = v;
}

// The lane's selected value from its row values at one bar: fast minus
// slow (SMA), or its z (bollinger).
template <int kFamily>
__device__ __forceinline__ float selected(float a, float b) {
  if (kFamily == kSma) return a - b;
  return a;
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
      const float down = dbx::min_nan(net, 0.f);
      dsq += down * down;
      const float act = prev != 0.f ? 1.f : 0.f;
      active += act;
      wins += net > 0.f ? act : 0.f;
    }
    turn += dp;
    prev = pos;
  }

  __device__ __forceinline__ void store(float* out, size_t plane, size_t at,
                                        int tr) const {
    const float nf = static_cast<float>(tr);
    const float mean = s1 / nf;
    const float sd = sqrtf(dbx::max_nan(s2 / nf - mean * mean, 0.f));
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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Steps bars t0 .. t0 + nb - 1 of one block in order: a and b are the
// lane's rows in the buffer (b unread for bollinger), rs the returns row
// (unread with kReturns false); four bars a 16-byte load, then the rest.
template <int kFamily, bool kReturns, class Step>
__device__ __forceinline__ void walk(const float* a, const float* b,
                                     const float* rs, int t0, int nb,
                                     Step& step) {
  int i = 0;
  for (; i + 4 <= nb; i += 4) {
    const float4 va = load4(a + i);
    const float4 vb = kFamily == kSma ? load4(b + i) : va;
    const float4 vr = kReturns ? load4(rs + i) : va;
    step(selected<kFamily>(va.x, vb.x), vr.x, t0 + i);
    step(selected<kFamily>(va.y, vb.y), vr.y, t0 + i + 1);
    step(selected<kFamily>(va.z, vb.z), vr.z, t0 + i + 2);
    step(selected<kFamily>(va.w, vb.w), vr.w, t0 + i + 3);
  }
  for (; i < nb; ++i) {
    step(selected<kFamily>(a[i], kFamily == kSma ? b[i] : 0.f),
         kReturns ? rs[i] : 0.f, t0 + i);
  }
}

// Fixed-order sum of 32 lanes' values (a butterfly: every lane gets the
// same bits, lane 0's order v[0] + v[16], then + the same of lane 8, ...).
__device__ __forceinline__ float warp_fold(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// touch: the sum of the ticker's (W, T) table `table`, the same bits in
// every CTA of the cluster (the order is set out at the top of the file).
__device__ __forceinline__ float touch_sum(const float* table, int T, int W,
                                          const cg::cluster_group& cluster) {
  __shared__ float chunks[kTouchChunks];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int m4 = W * T / 4;
  const int q = (m4 + kTouchChunks - 1) / kTouchChunks;
  const int passes = (q + 32 * kTouchAccs - 1) / (32 * kTouchAccs);
  const float4* words = reinterpret_cast<const float4*>(table);
  float* sums = cluster.map_shared_rank(chunks, 0);
  // Every CTA of the cluster has started before any writes the first
  // CTA's shared memory: distributed shared memory may be touched only
  // then.
  cluster.sync();
  for (int c = rank * warps + static_cast<int>(threadIdx.x) / 32;
       c < kTouchChunks; c += C * warps) {
    const int len = min(q, m4 - c * q);
    const float4* base = words + static_cast<size_t>(c) * q;
    float4 acc[kTouchAccs];
#pragma unroll
    for (int u = 0; u < kTouchAccs; ++u) {
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 2
    for (int j = 0; j < passes; ++j) {
#pragma unroll
      for (int u = 0; u < kTouchAccs; ++u) {
        const int i = (j * kTouchAccs + u) * 32 + lane;
        const float4 x =
            i < len ? __ldg(base + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[u].x += x.x;
        acc[u].y += x.y;
        acc[u].z += x.z;
        acc[u].w += x.w;
      }
    }
    float s[kTouchAccs];
#pragma unroll
    for (int u = 0; u < kTouchAccs; ++u) {
      s[u] = (acc[u].x + acc[u].y) + (acc[u].z + acc[u].w);
    }
    const float t = warp_fold((s[0] + s[1]) + (s[2] + s[3]));
    if (lane == 0) sums[c] = t;
  }
  cluster.sync();
  const float total = warp_fold(sums[lane] + sums[lane + 32]);
  // The first CTA's sums stay until every CTA of the cluster has read them.
  cluster.sync();
  return total;
}

// How a launch stages its blocks (every field 0 for touch).
struct Layout {
  int tiles;    // CTAs a ticker: its lane tiles padded to a multiple of C
  int B;        // bars a block
  int ring;     // block buffers
  int copiers;  // CTAs of a cluster that copy table rows
  int rows;     // table rows each copier copies, `box` a tensor copy
  int box;
  int slot;     // floats a buffer (table rows, returns row), 128-byte aligned
};

// Dynamic shared memory of a launch with this layout: 128 bytes to align
// the buffers, the buffers and two barriers a buffer.
__host__ __device__ __forceinline__ size_t stage_smem(const Layout& lay) {
  return 128 + lay.ring * (lay.slot * sizeof(float) + 2 * sizeof(uint64_t));
}

// row_a, row_b: each lane's fast and slow rows in the table (SMA), or its
// window's row and nullptr (bollinger); k: the lanes' entry bands
// (bollinger) or nullptr. map: the table as a 3-D tensor (T, W, N) with a
// (B, box, 1) box. out: (9, N, P).
template <int kFamily, int kStage>
__global__ void __launch_bounds__(kMaxLanes) stage_kernel(
    const float* __restrict__ r, const float* __restrict__ tbl,
    const int* __restrict__ row_a, const int* __restrict__ row_b,
    const float* __restrict__ k, const int* __restrict__ warm,
    float* __restrict__ out, int N, int T, int W, int P, int tr,
    const __grid_constant__ CUtensorMap map, const Layout lay, float cost,
    float ppy) {
  extern __shared__ __align__(16) float smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int n = blockIdx.x / lay.tiles;
  const int p = (blockIdx.x % lay.tiles) * blockDim.x + threadIdx.x;
  const bool live = p < P;
  const size_t plane = static_cast<size_t>(N) * P;
  const size_t at = static_cast<size_t>(n) * P + p;

  if constexpr (kStage == kTouchStage) {
    const float total =
        touch_sum(tbl + static_cast<size_t>(n) * W * T, T, W, cluster);
    if (live) write_value(out, plane, at, total);
    return;
  } else {
    constexpr bool kReturns = kStage != kMatmul;
    const int C = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int lane = threadIdx.x % 32;
    const bool producer = threadIdx.x < 32;
    const int B = lay.B;
    const int ring = lay.ring;
    // The buffers start 128-byte aligned (the tensor copies' alignment).
    float* base = smem + ((128 - (smem_u32(smem) & 127)) & 127) / 4;
    // full[i]: buffer i's block has landed here; empty[i]: every CTA of
    // the cluster is done with it.
    uint64_t* full = reinterpret_cast<uint64_t*>(
        base + static_cast<size_t>(ring) * lay.slot);
    uint64_t* empty = full + ring;
    const int table_rows = lay.copiers * lay.rows;   // rows of a buffer
    const int limit = kStage == kMatmul || kStage == kSignal ? T : tr;
    const int nblocks = (limit + B - 1) / B;
    const float* r_row = r + static_cast<size_t>(n) * T;

    if (threadIdx.x == 0) {
      for (int i = 0; i < ring; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, C);
      }
      fence_barrier_init();
    }
    cluster.sync();
    // Block `blk` into its buffer in every CTA of the cluster, by the first
    // warp: copier `rank` copies table rows rank * rows + m * box (its
    // lane m's box), the last CTA the returns.
    const auto issue = [&](int blk) {
      const int s = blk % ring;
      const int t0 = blk * B;
      const uint32_t r_bytes = sizeof(float) * min(B, T - t0);
      float* buf = base + static_cast<size_t>(s) * lay.slot;
      if (lane == 0) {
        mbar_expect(full + s, sizeof(float) * table_rows * B +
                                  (kReturns ? r_bytes : 0));
      }
      if (rank < lay.copiers && lane * lay.box < lay.rows) {
        const int row = rank * lay.rows + lane * lay.box;
        box_copy(buf + static_cast<size_t>(row) * B, &map, t0, row, n,
                 full + s, C);
      }
      if (kReturns && rank == C - 1 && lane == 31) {
        bulk_copy(buf + static_cast<size_t>(table_rows) * B, r_row + t0,
                  r_bytes, full + s, C);
      }
    };
    // Blocks in flight ahead of the one the lanes step, and how many
    // blocks ago a refilled buffer was released.
    const int lag = ring / 2;
    if (producer) {
      for (int blk = 0; blk < ring && blk < nblocks; ++blk) issue(blk);
    }

    const int ra = live ? row_a[p] : 0;
    const int rb = kFamily == kSma && live ? row_b[p] : ra;
    const float kk = kFamily == kBoll && live ? k[p] : 0.f;
    const int t_on = live ? warm[p] - 1 : 0;
    float v = 0.f, state = 0.f;
    ReductionAcc<kFamily == kSma> red;
    dbx::MetricsAcc acc;
    auto step = [&](float x, float rt, int t) {
      if constexpr (kStage == kMatmul) {
        v += x;
      } else if constexpr (kStage == kSignal) {
        state = position<kFamily>(state, x, kk, t, t_on);
        v += state * rt;
      } else if constexpr (kStage == kNoLadders) {
        red.step(position<kFamily>(red.prev, x, kk, t, t_on), rt, cost);
      } else {
        acc.step(position<kFamily>(acc.prev, x, kk, t, t_on), rt, cost);
      }
    };
    for (int blk = 0; blk < nblocks; ++blk) {
      // Refill the buffer released `lag` blocks ago, once every CTA of the
      // cluster has released it.
      const int old = blk - lag;
      if (producer && old >= 0 && old + ring < nblocks) {
        mbar_wait(empty + old % ring, (old / ring) & 1);
        issue(old + ring);
      }
      const int s = blk % ring;
      mbar_wait(full + s, (blk / ring) & 1);
      if (live) {
        const float* buf = base + static_cast<size_t>(s) * lay.slot;
        const int t0 = blk * B;
        walk<kFamily, kReturns>(buf + static_cast<size_t>(ra) * B,
                                buf + static_cast<size_t>(rb) * B,
                                buf + static_cast<size_t>(table_rows) * B,
                                t0, min(B, limit - t0), step);
      }
      // This CTA is done with the buffer: one arrival on each CTA's
      // barrier of it.
      __syncthreads();
      if (static_cast<int>(threadIdx.x) < C) {
        mbar_arrive_at(empty + s, threadIdx.x);
      }
    }
    // No CTA leaves while another may still copy or arrive into it.
    cluster.sync();
    if (!live) return;
    if constexpr (kStage == kMatmul || kStage == kSignal) {
      write_value(out, plane, at, v);
    } else if constexpr (kStage == kNoLadders) {
      red.store(out, plane, at, tr);
    } else {
      acc.store(out, n, p, N, P, tr, ppy);
    }
  }
}

using StageFn = void (*)(const float*, const float*, const int*, const int*,
                         const float*, const int*, float*, int, int, int, int,
                         int, CUtensorMap, Layout, float, float);

template <int kFamily>
StageFn kernel_for(int stage) {
  switch (stage) {
    case kTouchStage: return stage_kernel<kFamily, kTouchStage>;
    case kMatmul: return stage_kernel<kFamily, kMatmul>;
    case kSignal: return stage_kernel<kFamily, kSignal>;
    case kNoLadders: return stage_kernel<kFamily, kNoLadders>;
    case kFull: return stage_kernel<kFamily, kFull>;
    default: return nullptr;
  }
}

// A launch's cluster size, layout and shared memory.
struct Plan {
  int C;
  Layout lay;
  size_t smem;
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The layout of `stage` with B-bar blocks in a ring of `ring` on a W-row
// table, C CTAs a cluster: the fewest copiers of at most C whose boxes of
// a multiple of 8 rows (at most kMaxBox) cover the W rows.
Layout staging(int W, int B, int ring, int C, int tiles) {
  Layout lay = {};
  lay.tiles = tiles;
  lay.B = B;
  lay.ring = ring;
  lay.rows = round_up((W + C - 1) / C, 8);
  lay.copiers = (W + lay.rows - 1) / lay.rows;
  const int boxes = (lay.rows + kMaxBox - 1) / kMaxBox;
  lay.box = round_up((lay.rows + boxes - 1) / boxes, 8);
  lay.rows = boxes * lay.box;
  lay.slot = round_up((lay.copiers * lay.rows + 1) * B, 32);
  return lay;
}

// The layout of `stage` on an (N, W, T) table and P lanes at `lanes` lanes
// a CTA, as set out at the top of the file. Returns a cudaError_t as an
// int: cudaErrorInvalidConfiguration where the blocks do not fit a CTA's
// shared memory.
int make_plan(int stage, int T, int W, int P, int lanes, Plan* pl) {
  if ((lanes != 128 && lanes != 256 && lanes != 512 && lanes != 1024) ||
      stage < kTouchStage || stage > kFull || W < 1 || T < 4 || T % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int want = stage == kTouchStage ? kTouchCluster : kStageCluster;
  const int tiles = (P + lanes - 1) / lanes;
  int C = 1;
  while (C < want && C < tiles) C *= 2;
  pl->C = C;
  pl->lay = Layout{};
  pl->lay.tiles = round_up(tiles, C);
  pl->smem = 0;
  if (stage == kTouchStage) return static_cast<int>(cudaSuccess);
  int B = kBlockBars;
  if (B == 0) {
    // The deepest block of an odd number of 16-byte words a row (so that
    // 8 neighbouring rows lie in 8 bank groups) within the budget.
    const int ctas = kTargetWarps * 32 / lanes;  // lanes <= 1024
    const size_t budget = kSmemPerSm / ctas - kSmemReserved;
    B = 4;
    while (B + 8 <= kMaxBlockBars &&
           stage_smem(staging(W, B + 8, kRing, C, 0)) <= budget) {
      B += 8;
    }
  }
  pl->lay = staging(W, B, kRing, C, pl->lay.tiles);
  pl->smem = stage_smem(pl->lay);
  return pl->smem > kMaxSmem
             ? static_cast<int>(cudaErrorInvalidConfiguration)
             : static_cast<int>(cudaSuccess);
}

// The table as a 3-D tensor (T bars, W rows, N tickers) for the plan's
// (B, box, 1) boxes. Returns a cudaError_t as an int.
int table_map(CUtensorMap* map, const void* tbl, int N, int T, int W,
              const Layout& lay) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return static_cast<int>(cudaErrorSymbolNotFound);
    }
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {sizeof(float) * static_cast<cuuint64_t>(T),
                                 sizeof(float) * static_cast<cuuint64_t>(T) *
                                     W};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(lay.B),
                             static_cast<cuuint32_t>(lay.box), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(tbl), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? static_cast<int>(cudaSuccess)
                             : static_cast<int>(cudaErrorInvalidValue);
}

// Lets `fn` take the plan's shared memory and cluster size.
int prepare(StageFn fn, const Plan& pl) {
  if (pl.C > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return dbx::allow_smem(fn, pl.smem);
}

void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
               const Plan& pl, int N, int lanes, cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(static_cast<unsigned>(N) * pl.lay.tiles);
  cfg->blockDim = dim3(lanes);
  cfg->dynamicSmemBytes = pl.smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kFamily>
int dispatch(const void* r, const void* tbl, const void* row_a,
             const void* row_b, const void* k, const void* warm, void* out,
             int N, int T, int W, int P, int tr, int stage, int lanes,
             float cost, int ppy, void* stream) {
  if (N <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (tr < 1 || tr > T || !aligned16(r) || !aligned16(tbl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan pl;
  int err = make_plan(stage, T, W, P, lanes, &pl);
  if (err != 0) return err;
  if (static_cast<long long>(N) * pl.lay.tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map = {};
  if (stage != kTouchStage) {
    err = table_map(&map, tbl, N, T, W, pl.lay);
    if (err != 0) return err;
  }
  const StageFn fn = kernel_for<kFamily>(stage);
  err = prepare(fn, pl);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, pl, N, lanes, static_cast<cudaStream_t>(stream));
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, fn, static_cast<const float*>(r), static_cast<const float*>(tbl),
      static_cast<const int*>(row_a), static_cast<const int*>(row_b),
      static_cast<const float*>(k), static_cast<const int*>(warm),
      static_cast<float*>(out), N, T, W, P, tr, map, pl.lay, cost,
      static_cast<float>(ppy));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (loaded with ctypes). Pointers are device pointers; each
// launches on `stream` and returns cudaGetLastError() (or the launch's
// error) as an int. stage: 0 touch, 1 matmul, 2 signal, 3 no_ladders,
// 4 full; lanes: threads a CTA, 128, 256, 512 or 1024; tr: the real bars,
// 1 <= tr <= T; T a multiple of 4 and the table and returns 16-byte
// aligned. out: (9, N, P) f32. A table whose blocks do not fit a CTA's
// shared memory (thousands of rows) gets cudaErrorInvalidConfiguration and
// no launch.
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

// dbx_stage_occupancy: the build report of `stage` of family `kind` (0 SMA,
// 1 bollinger) launched as the entries above launch it on a (W, T) table
// and P lanes: info[0..3] as occupancy.cuh's launch_report (registers,
// resident CTAs an SM, lanes, dynamic shared memory), info[4] the cluster
// size, info[5] the bars a block and info[6] the block buffers (0 for
// touch), info[7] the clusters the card can hold at once. Returns a
// cudaError_t as an int.
extern "C" int dbx_stage_occupancy(int kind, int stage, int T, int W, int P,
                                   int lanes, int* info) {
  Plan pl;
  int err = make_plan(stage, T, W, P, lanes, &pl);
  if (err != 0) return err;
  const StageFn fn =
      kind == kSma ? kernel_for<kSma>(stage) : kernel_for<kBoll>(stage);
  err = prepare(fn, pl);
  if (err != 0) return err;
  err = dbx::launch_report(fn, lanes, pl.smem, info);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, pl, 1, lanes, nullptr);
  int clusters = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg));
  info[4] = pl.C;
  info[5] = pl.lay.B;
  info[6] = pl.lay.ring;
  info[7] = clusters;
  return err;
}
