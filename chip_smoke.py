"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive.

Run from the repository root with one CUDA card visible:

    python3 chip_smoke.py

(``python3 chip_smoke.py --sass DIR`` prints only the SASS instructions a
bar of the kernels' metric loops built from another tree's ``csrc/``
``DIR``, to set beside this tree's: :func:`sass_of`. ``python3
chip_smoke.py --parent DIR`` times the table kernels and the port bench's
pairs, trix and macd configs in another tree ``DIR`` and in this one, in
turns on the same card: :func:`parent_compare`. ``python3 chip_smoke.py
--obs-split`` times phase 12 (b)'s drain with neither fleet telemetry nor
the span log, each alone and both, in turns: :func:`obs_split`.)

Phases (each asserts; any failure exits non-zero and prints no result):

1. The card's name and power limit (nvidia-smi), and CUDA must be present.
2. Build every kernel of the main paths from ``csrc/`` (one nvcc per source,
   started together).
3. Each kernel entry against its plain PyTorch version on the same inputs
   on the card, in four cases: the main path's shape (500 tickers x 1260
   bars x the family's bench grid, cost 1e-3), cost 0, ragged lengths
   (32 x 1260) and T=251 (32 x 251). K1 on the 2000-combo SMA grid; K2's
   inline entry on the 1000-combo bollinger grid, its table entry on the
   1000-combo rsi z-table (and on the keltner and vwap z-tables at
   32 x 1260 and at 500 x 1260, where it is timed too) and its stochastic
   entry on the 1000-combo stochastic grid, each with both machines
   (hysteresis, touch); K3's momentum entry on 2000 lookback lanes and its
   donchian entry on the 1000-lane high/low grid; K4 (macd) and K5 (trix)
   on their 1000-combo EMA tables (built on the card by
   ``dbx_ema_rows``); K6 (obv) on the 2000-lane OBV grid; K7 (pairs) on
   1000 pairs x 1260 bars x the 500-combo pairs grid, its small cases on
   32 pairs, its tables built on the card by ``dbx_pairs_tables``;
   the SASS a bar of K2's table entry's metric loop. The window-major
   entries (K2's table and stochastic entries, K3's donchian) take their
   lanes sorted by window, as their sweeps pass them, and run two more
   cases: long rows (4 x 5000, where the channel levels live in device
   memory) and a grid of 2368 lanes
   whose lane blocks (1024 lanes, 128 for the table entry) straddle
   windows, held against the plain version in the caller's lane order,
   and launched in that order too. Their registers, resident warps an SM
   and shared memory are printed (``csrc/occupancy.cuh``). The tile
   entries (K1, K2's inline entry, K4, K5, K6 and K7, which form each
   window's value once per bar block in shared memory,
   ``csrc/bar_blocks.cuh``) and K3's momentum entry run three more cases:
   long rows (4 x 13000), a grid of many distinct windows (K1 fast 2..129
   x slow 130..400, K2 8 k x window 5..300, K4 fast 2..41 x slow 42..400
   step 9 x 2 signals, K5 spans 2..400 x 2 signals, K6 and momentum
   windows 2..400 three times, K7 lookbacks 2..400 x 2 z_entry, on 4 x
   1260, K7 on 4 pairs) and
   eight histories that end mid-block and are shorter than most windows;
   then the tile entries sweep their CTA width (128-1024 lanes), bit-equal
   and timed at each; their build report and the per-bar instruction count
   of their metric loop in the SASS (``cuobjdump -sass``, :func:`_per_bar`)
   are printed. Their kernel time is the kernel alone, with the tiles'
   window lists built beforehand; the time through the wrapper, which
   builds them with torch ops, is printed beside it. K1, momentum, K4, K5
   and K7 (the crafted rows as its hedged returns) also run crafted
   returns (8 x 1260, cost 0 and 1e-3) that drive equity through 0, below
   0, to +-inf and to NaN: NaN where the plain version has NaN, every
   other value bit-equal. Positions must be identical, so
   n_trades and turnover (sums of small integers) must be bit-equal; every
   other metric must agree at rtol=2e-4, atol=2e-5, and for the
   window-major and tile entries and momentum every metric must be
   bit-equal. Kernel and plain times come from CUDA events after warmup.
   Then the table kernels: ``dbx_ema_rows`` (``csrc/ema_rows.cu``) against
   ``trix_ema_table`` on trix's table of the main path's panel, 32 ragged
   rows, T=251, T=2, T=2048 (the largest register plan) and long rows
   (4 x 13000, staged in device memory), and with one ladder against
   ``macd_ema_table`` on macd's, each with its register plan;
   ``dbx_pairs_tables`` (``csrc/pairs_tables.cu``) against
   ``pairs_tables_plain`` on K7's four cases, long rows (2 x 3500 and
   1 x 5000 with the prefix rows in device memory, 2 x 13000), T=1, T=2
   and a lookback of 600 bars (past the sums launch's ring: the lags from
   device memory), each with its plan: every value bit-equal; each kernel
   timed at its main path's shape (through the
   wrapper, and its device time from a CUDA graph) beside its bound and
   plain version (pairs also beside ``pairs_tables``, the torch prep it
   replaced).
   Then K8, the roofline stage scaffolds
   (``csrc/stages.cu``): every (stage, lanes) case of ``dbx_sma_stage``
   (500 x 1260 x the 2000-combo SMA grid) and ``dbx_boll_stage`` (500 x
   1260 x the 1000-combo bollinger grid), on the bench's seed-0 panel,
   against its plain version: every output row must be bit-equal (same
   inputs, every operation in the same order). Each case is timed through
   its wrapper (CUDA events around 20 calls) beside its bound and, for
   touch and matmul, the one PyTorch call computing the same function,
   timed the same way; the device time of each, from a CUDA graph of 20
   calls, is printed beside. Each entry's build report (registers,
   resident CTAs, shared memory, cluster size, bars a block, ring), the
   SASS a bar of its matmul and full loops and matmul at every width are
   printed. Then every stage at every width on five more shapes (about
   400 distinct windows, T=37, one ticker, 75 lanes, a 13000-bar row),
   bit-equal.
4. The main paths at full width, one per strategy: 500 synthetic tickers x
   1260 daily bars as DBX1 payloads in 500 JobSpecs with the bench grid
   (for pairs 1000 two-legged JobSpecs, the legs from 2000 synthetic
   tickers), through ``TorchSweepBackend(device="cuda").process``. Every
   DBXM block decodes to the grid size with finite sharpe, and the path's
   kernel launch count, reset just before the run, grew. A 16-job batch
   then goes
   through the same backend and is held against the port's generic sweep
   (the golden path) on the card: for sma_crossover on a 1/32 price tick
   grid (exact f32 cumsums) at rtol=2e-4, atol=2e-5; for the exact-signal
   families (stochastic, momentum, donchian, donchian_hl) with identical
   positions (n_trades, turnover bit-equal); for bollinger and
   bollinger_touch under the flip rule of ``tests/torch_parity.py`` (the
   centering mean and the cumsums run on tensors of other shapes there,
   so a z-score at the band can round the other way; whether n_trades and
   turnover came out bit-equal is printed); for rsi, keltner and obv_trend
   with identical positions (both paths build their tables, or the OBV
   and its cumsum, with the same ops on rows of one count); for macd and
   trix under the reference's flip-aware budget (the kernels carry the
   signal EMA sequentially, the generic path as a shift-doubling ladder,
   so a crossing at a knife edge can land a bar apart: that moves a trade
   by one bar, and sharpe by less than the flip rule's threshold), and for
   vwap_reversion and pairs (against ``models.pairs.run_pairs_sweep``)
   under the same budget, which is the reference's pairs budget
   (``tests/test_fused.py`` ``_check_pairs``): the two paths take the
   z-scores' sums in other orders, and the windowed variance cancels, so
   a z at the band can land a bar apart. There every cell off by more than
   rtol=2e-3, atol=2e-4 counts as flipped, and at most max(1, 1%) may
   flip. vwap's fused path takes torch's CUDA reductions over tensors of
   another row count, which split a row in another order: its golden
   path runs again one k at a time, so its tensors have the fused path's
   row count and sum in its order, and positions must then be identical.
   Both paths take their prefix sums in f64 rounded once a bar
   (``ops.rolling.prefix_sum``), the same bits whatever the shape.
   pairs' fused path takes each windowed sum as the f64 difference of two
   f64 prefix sums, rounded once (``csrc/pairs_tables.cu``), where the
   generic path takes it in f32 from torch's f32 CUDA scan, which cancels:
   its budget is held against the generic path run in f64 (the witness,
   :func:`_gold_f64`), and the counts of cells off against the generic
   path in f32, and between that path and the witness, are printed. The
   generic
   path sums equity in another order, so for the new families cagr is
   held to the error its final equity may carry (``_cagr_slack``).
   The stochastic, donchian and donchian_hl sweeps must also leave no
   (N, W, T) table on the card: their peak allocation during a 500-ticker
   sweep stays below one int8 breakout-sign table of that grid; the pairs
   sweep's stays below three f32 (N, W, T) tables (z, hr and less than one
   more). macd's, trix's and pairs' main paths must launch their table
   kernels.
   K8's main path is the port bench (``python -m
   distributed_backtesting_exploration_tpu_torch.bench``), run here
   in-process with 3 timed iterations on every config but ``autotune``
   (phase 10) and the control-plane keys of ``bench.CONTROL_CONFIGS``,
   which run no kernel (phase 13 runs ``pipeline`` and ``queue_machine``;
   the script's time), the control plane's ``e2e_local``,
   ``fleet_telemetry`` and ``flight`` on 500 jobs (the bench's 1500) and
   the fleet's 200 (600), also for the script's time: every config must
   report a rate and every K8 case must launch; its JSON line is
   printed.
5. The worker path at the same widths, through ``submit`` and
   ``collect``: 500 sma jobs with ``top_k=16`` under sharpe and
   max_drawdown and 1000 pairs jobs under sharpe (the launch counts reset
   just before; K1 and K7 with its tables must launch), each DBXS block
   held against the same job's full DBXM block from ``process``: the
   indices of a numpy total-order rank of the full row (+0 ahead of -0,
   the lower index first), the rows bit-equal; each batch timed five more
   times beside the full batch, the top-k reduce at (500, 2000) by CUDA
   events, and DBXS against DBXM bytes a job. 64 best-returns sma jobs on
   a 1/32 tick grid: each index that of ``sweep.best_params`` over the
   generic sweep of the same batch on the card, the row bit-equal to that
   sweep's, the return series bit-equal to the chosen combo repriced
   alone (``Strategy.positions``, ``pnl.backtest_prefix``). 500 sma jobs
   with digests, inline and then digest-only: ten cache misses, ten
   host hits (the host level filled by ``prefetch``) and ten device
   hits, with no decode on a hit, no device miss on a device hit and the
   inline batch's bytes; a device level with room for half the panels,
   filled by one batch of misses, must hold on the card just the bytes
   it charges; a digest neither cached nor fetchable must raise. Then ``worker_rate.measure``: 8 batches of 500 sma jobs through
   ``process`` and through the depth-2 executor in turns, the bytes
   identical, batches/s and backtests/s printed; and a cProfile of one
   ``process`` call, its top host frames by own time.
6. Walk-forward at the reference bench's settings: 500 tickers x 1260
   bars, train 600, test 55 (12 windows), cost 1e-3. First the refit's
   argmax on the card against numpy's (jnp.argmax's rule: the first NaN
   wins, ties go to the first index) on crafted rows, whole and across
   param chunks. Then, for each of the 13 single-asset families, 500
   walk-forward JobSpecs on its bench grid (1000-2000 combos, so the
   fused-train route) through ``process``, the launch counts reset just
   before: the family's kernel entry (and macd's and trix's table kernel)
   must launch, and every block is one stitched row with finite sharpe;
   the batch is timed three more times. The same 500 tickers' 6000
   stacked train windows (the shape the main path gave the kernel) then
   go through ``walk_forward_fused`` with the kernel and again with every
   entry's plain version as the train sweep (the entry must launch no
   time in the plain run): chosen params and out-of-sample metrics
   bit-equal, and the main path's 500 blocks bit-equal to the plain run's
   rows. 16 jobs (sma on a 1/32
   tick grid) are held against the generic ``walk_forward`` on the card
   under the reference's flip-aware rule: a job whose sharpe is off by
   more than 0.01 + 1% is flipped (at most 2 of 16), the others within
   rtol=2e-3, atol=2e-4 (cagr within ``_cagr_slack``). 250 pairs
   walk-forward jobs (the first 250 of phase 4's 1000 pairs, which keeps
   the script inside its time; 500 combos, generic: the reference has no
   fused route for them) must be bit-equal to ``walk_forward_pairs`` on
   the same stacked legs; the jobs flipped against the same refit in f64
   are counted and held at most a fifth (76 of the first 500 on the H100),
   and the unflipped jobs' metrics off the flip-aware tolerance are
   counted and printed. Then the rates in backtests/s (tickers x combos x
   windows over the median of 5 runs after a warm-up) of the bench's
   walk-forward config, generic and fused at P = 400 and fused at
   P = 2000, and the port bench's ``walkforward`` config in both routes,
   each beside the card's name and power limit. Last,
   ``sweep_and_compose`` at 500 x 1260 on the sma bench grid (chosen =
   ``best_params`` of the generic sweep; the book's series and metrics
   against a numpy f64 recomputation at the reference tests'
   tolerances), ``correlation_matrix`` of the 500 tickers' returns
   against numpy's f64 at rtol=1e-4, atol=1e-4, and a ``SweepCheckpointer``
   round trip of the (500, 2000) sweep Metrics, bit-equal.
7. Streaming (``streaming/``), at the widths of phase 4 and half its
   tickers: (a) each of the 14 ``fused_*_sweep`` wrappers with
   ``carry_out=True`` on ``synthetic_ohlcv(250, 1260, seed=0)`` and the
   bench's grid (pairs 500 x 1260, 500 combos), the launch
   counts reset just before (every K1-K7 entry and the table kernels must
   launch): the kernel's metrics bit-equal to the same call without it,
   every carry tensor f32 on the card, and ``finalize(carry)`` against the
   port's generic sweep (``run_sweep``, ``run_pairs_sweep``) under
   ``tests/test_streaming.py``'s rule with a 1% budget (a
   lane whose turnover or hit rate differs is flipped; on the rest those
   and n_trades bit-equal, the other metrics at rtol=2e-5, atol=2e-6,
   pairs 5e-3, 5e-4, cagr within ``_cagr_slack``). (b) Per family, a
   carry at 1260 bars plus one 16-bar append on ``synthetic_ohlcv(250,
   1276, seed=0)`` (pairs: 500 pairs) against the cold path: the carry
   advanced by the cold build's positions and returns on the appended
   bars, flipped lanes those whose positions there differ, at most 1%;
   and against ``build_carry`` at 1276 under the same rule, the lanes
   whose first 1260 bars differ between the generic models at the two
   lengths set aside and counted (pairs: a lane off the tolerance or
   with another hit rate counts as flipped, phase 4's pairs budget). sma
   also runs 16 one-bar appends against the 16-bar one, and sma, macd and
   rsi an append after a device-level eviction and a host restore,
   bit-equal to the one never evicted. (c) 128 sma append jobs (one
   ticker, 1260 bars, 2000 combos) through ``TorchSweepBackend.process``:
   round 1 repriced in full (128 counted), round 2 the next 16 bars as
   delta-only jobs spliced onto the cached base (128 carry hits, no
   decode, blocks bit-equal to ``finalize(append_step(...))`` of the
   round-1 carries called directly), round 3 round 2 again (a retried
   delivery: nothing advanced, blocks bit-equal to round 2's), one carry
   a stream kept at the default 64 MB; three times, the median of each
   round printed; then a budget for half the carries: every job completes
   and its block is the append's or the full reprice's, the reprices
   counted; 16 macd and 16 rsi jobs rounds 1 and 2 the same way. (d) The
   port bench's ``streaming_append`` (T = 8192, ΔT = 16, P = 32), printed.
8. Paged mode and scenario batches (``rpc/page_pool.py``,
   ``fused.fused_paged_sweep``, ``scenarios/``, ``fused.
   fused_scenario_sweep``), every check collected and failed together at
   the phase's end. (a) Each of the 13 single-asset families on its bench
   grid over ``synthetic_ohlcv(500, 1260, seed=0)`` cut to lengths drawn
   in 64..1260 (seed 8), from a page pool through ``fused_paged_sweep``
   (``DBX_PAGE_BARS``, 512: three page-count bins), the launch counts
   reset just before the 13 sweeps: the family's entry (and macd's and
   trix's table kernel) launched once a bin; each bin bit-equal to the
   dense wrapper on the same rows stacked to the bin's longest (the
   reference's bit-exact twin of a bin). Against the dense ragged stack
   of the whole group (every row padded to 1260) the cells not bit-equal
   and off the flip-aware tolerance are printed, not held: the f32
   cumsums of the preps (K1, K6, K2 inline, keltner's and vwap's
   z-tables) associate by the tensor's row count and length on the card,
   and bollinger's centering mean takes the pad bars (ROADMAP Queue 3).
   Before the sweeps, the prefix sums of the whole group's closes against
   those of its first 512 and 1024 bars and of each bin's rows, in f32
   and in f64 rounded once, are printed, and K1 on the whole group's own
   inputs cut to each bin's rows and bars must be bit-equal to the whole
   group's run.
   (b) The port bench's ``ragged_paged``, printed. (c) 500 sma jobs with
   digests, lengths in 64..1260 (seed 9), through ``process`` with the
   paged route (one group) and with it off (the power-of-two length
   buckets), four batches each in turns: the two routes' blocks within
   the flip-aware budget (at most max(1, 1%) of the cells off its
   tolerance; the cells not bit-equal printed), groups and K1's launches
   printed, the batches timed; 16 of the panels extended by 16 bars
   upload at most ⌈16 / 512⌉ + 1 pages each, their blocks within the
   same budget of the dense route's; a pool with room for half the
   group's pages rejects it once, counted, and the group is served dense,
   bit-equal to the dense route. (d) One spec generated twice gives the same
   bytes; 500 specs of one 1260-bar base (seed 920; block 16, 3 regimes,
   vol_scale 2, shock 0.01) generated on the card hold ``high >=
   max(open, close) >= min(open, close) >= low > 0``; each family's
   ``fused_scenario_sweep`` of the 500 on its bench grid, the launch
   counts reset just before the 13 sweeps (the entry launched once a
   chunk), against the dense wrapper on the same panels brought to the
   host and back (the materialized rung's data path) in one launch:
   bit-equal where the two see the same row count, the flip-aware budget
   otherwise; a carrier job of the 500 specs through ``process``, three
   times on the fused route and three times with ``DBX_SCENARIO_FUSED=0``
   (the materialized rung): every spec completed under its id on the
   route asked for, counted, and the two routes' blocks bit-equal; then
   the port bench's ``scenario_megakernel`` and ``scenario_sweep``,
   printed.
9. Multiple devices on the one card (``parallel/sharding.py``,
   ``timeshard.py``, ``multihost.py``, ``rpc/slice_worker.py``): first
   one pair's K7 block alone, in the 1000-pair stack and in a ragged
   stack, bits compared. (a) The mesh route: a backend on a mesh of the
   card four times against the meshless backend on each family's 500-job
   batch (1000 pairs jobs) of its bench grid and on a ragged batch of
   vwap_reversion (lengths 64..1260, seed 8): every block bit-equal, each
   entry (and its table kernel) launched 4 times a group, both batches
   timed twice. (b) ``sharded_cumsum``, ``sharded_ema`` and
   ``sharded_band_positions`` over 4 shards of 4 x 8192 bars bit-equal to
   ``prefix_sum``, a one-shard mesh's EMA and ``band_hysteresis_assoc``;
   each of the 14 ``sharded_*_backtest`` on 4 x 8192 bars, one combo,
   against the generic sweep (rtol=2e-4, atol=2e-5; macd, trix and pairs
   at most 2 series flipped, the rest at 2e-3/2e-4), both timed (the
   generic sweep once, the time-sharded one the median of 3); the
   reference bench's ``long_context`` (1 x 65537 bars, seed 7, P = 32)
   time-sharded, generic and on K1, timed and held to each other; one
   8201-bar momentum job through the mesh backend's time-sharded route
   against the meshless backend. (c) Two spawned processes, a gloo group
   and a mesh of the card twice each: ``initialize``, ``host_shard``, the
   sharded sweep of each rank's share of a 64-ticker panel gathered and
   bit-equal to one process's, then a ``run`` and a ``run_ts`` round of
   the slice bit-equal to the single-host backend; each child killed at
   150 s.
10. Tuning (``tune/``, the reference's tune layer). (a) The six tile
   families (sma_crossover, bollinger, macd, trix, obv_trend: 500 jobs of
   1260 bars on the bench grid; pairs: 1000 jobs) through a
   ``TorchSweepBackend`` with ``DBX_AUTOTUNE=1``, ``DBX_AUTOTUNE_REPS=3``
   and a fresh ``DBX_SCHEDULE_DIR``, the launch counts reset just before
   each batch: ``dbx_autotune_trials_total`` grew for the family, its
   entry launched, the winner recorded under the card's platform
   (``torch-cuda-sm90``) and the same after the journal is opened again,
   and every DBXM block bit-equal to a backend's with ``DBX_AUTOTUNE``
   off; each family's default and tuned batch times (medians of three,
   alternating), its winner and the measured and modeled speedups are
   printed. (b) The compile cache: ``ema_rows`` built by nvcc into an
   empty directory (cold) and offered to a ``tune.CompileStore``; a second
   ``CacheSync`` installs it into another empty directory, and with nvcc
   unreachable (``CUDA_HOME`` a directory without it, ``PATH`` stripped,
   ``_kernels._nvcc`` raising) the library loads from there and its
   kernel, on trix's main-path table, is bit-equal to ``trix_ema_table``;
   the cold and warm walls are printed.
11. The dispatch loop (``rpc/dispatcher.py`` and what it imports): the
   port's ``DispatcherServer`` on ``localhost:0`` with a journal and a
   results directory, and one port ``Worker`` with ``TorchSweepBackend``
   on the card (``jobs_per_chip=100``, polling every 5 ms), over
   loopback gRPC, the launch counts reset before each part. (a) 500 sma
   jobs of phase 4's panel and grid (explicit ids): every stored block
   bit-equal to ``process`` of the same jobs called directly, K1
   launched; the drain's wall, jobs/s, backtests/s, ``RequestJobs``
   batches, the median ``dbx_rpc_seconds`` by method, the worker's
   serialized wire bytes a job and the drain's attribution (enqueue,
   the backend's ``process`` calls, each RPC's handler seconds) printed.
   (b) The same panels again: 500 digest-only legs
   (``dbx_dispatch_payloads_total{mode="digest_only"}``), blocks
   bit-equal to (a)'s. (c) The same jobs with ``top_k=16`` under sharpe,
   bit-equal to the direct ``process``. (a') 500 jobs like (a) on
   another panel, drained under ``obs.trace.device_profile`` (CPU and
   CUDA activities): the card's busy seconds, the union of the trace's
   kernel, copy and set intervals, and their share of the drain's wall
   printed; blocks bit-equal to the direct ``process``; the journal
   replays to 2000 completed and none pending. (d) Eight sma streams built cold, then two
   ``AppendBars`` rounds of 16 bars each (the first a full reprice, the
   second a carry hit, counted): every block bit-equal to a fresh backend
   given the worker's batches in the same order. (e) One base panel and
   64 scenario specs with ``DBX_SCENARIO_FUSED=1`` (the worker's
   spec-batch route; the panel store holds 1 panel) and ``=0`` (the
   dispatcher materializes each panel on the card; 65 panels): the two
   rungs' blocks bit-equal. (f) 500 jobs, the dispatcher stopped once it
   has recorded its first ``CompleteJobs``, a new one on the same port
   from ``JobQueue.restore`` of the journal: one block a job, bit-equal
   to (a)'s, no job pending. The phase's wall is printed.
12. The worker's observability (the worker's and backend's spans,
   metrics and fleet telemetry, ``obs.timeline``, ``obs.dump``,
   ``obs.why``), K1's launches counted from 0 before each drain. (a) The
   port's dispatcher and two port workers (``jobs_per_chip=100``, 5 ms
   polls, telemetry on, the span log ``DBX_OBS_JSONL`` to one file): 500
   sma jobs of phase 4's panel and grid, every stored block bit-equal to
   the direct ``process``; the dispatcher's fleet view lists both
   workers, not stale, with the stages decode, compile, execute and d2h,
   and its execute histogram is the fold of the workers' rows; the
   timeline over the log gives each job a lifecycle, and the drain's
   critical path by stage is printed; ``obs.dump`` on the log and
   ``obs.why`` on one job exit 0 (the drain runs with
   ``DBX_DECISIONS_RATE=0``, and the decision plane's queue is scored
   before the loop stops, so every job has its decision record). (b)
   The cost of telemetry and the span log is not in the default run:
   ``--obs-split`` times the drain in its four arms, 12 rounds each. (c)
   One worker whose backend's ``collect`` raises once for a 100-job batch, ``DBX_FLIGHT_DIR`` set, 5 s leases: one
   ``collect_fail`` bundle, the 100 jobs re-served, every block bit-equal
   to (a)'s. (d) The process's ``/metrics`` (an ``obs.MetricsServer``, as
   the worker CLI's ``--metrics-port`` serves it) scraped over HTTP
   before and after (a)'s drain: ``dbx_worker_rpc_seconds`` for
   ``RequestJobs`` and ``CompleteJobs``, the encoded DBXM bytes equal to
   the stored blocks', ``dbx_backtests_total`` 500 x 2000, the
   panel-cache counters equal to the two caches' ``stats()``.
13. The native worker shell (``csrc/worker_native.cc``, built by
   ``runtime._core.build_worker_shell`` with g++; each shell's log must
   show the core selftest passed and the proto selftest not failed,
   skipped where the build found no libprotobuf). Five shells start at
   once, each group on a port dispatcher of its own. (a) Phase 11's 500
   sma jobs (panel seed 7, the 2000-combo grid) drained by two shells,
   ``--backend torch --device cuda --jobs-per-chip 100`` polling every 5
   ms, after a warm-up drain of 200 jobs of another panel: every stored
   block bit-equal to the direct ``process``; the cold start (spawn to
   both shells polling), the drain's wall, jobs/s and backtests/s, and
   K1's launches read from each shell's ``/metrics``
   (``dbx_kernel_launches``, its wrappers' own count) before and after the
   drain. One pair runs its channels native, the other with
   ``DBX_NO_NATIVE=1`` (python), each shown in the shells' logs; each pair
   drains ``SHELL_ROUNDS`` (1) times, the pairs in turns, either first
   in alternate rounds (``phase_native_shell(..., rounds=12)`` for a
   comparison of the two kinds: 1-4 rounds cannot resolve it). K1's library, built in phase 2, must be loaded and not
   rebuilt. (b) One shell with ``--fused off`` on 16 of the jobs: its
   blocks within the flip-aware budget of the fused route's. (c) The port
   bench's ``pipeline`` and ``queue_machine`` on the card (its C-ABI
   grain from the port-built ``dbx_core_bench``), printed. Every shell
   must exit 0 on SIGTERM.
14. The port's static analysis, certifier and model checker
   (``analysis/``). (a) dbxlint (``python -m
   distributed_backtesting_exploration_tpu_torch.analysis.lint --format
   json`` as its ``main``, in a process of its own in which jax and the
   JAX package cannot be imported) over the port package must exit 0,
   clean, with all fourteen rules run and none skipped (the numerics
   certifier and kernel-hygiene run on the CPU there); dbxmc
   (``analysis.modelcheck``) at the port bench's size (12 ops, seed 0, 120
   schedules a substrate) on the Python substrate and, where the port's
   native core loads, the native one, with zero violations; no kernel
   launches (the launch counts, reset just before, stay 0). (b) ``lint
   --certify --format json`` in the same process exits 0: 59 rows against
   ``numerics.torch.contract.json``, no drift, no finding. (c)
   kernel-hygiene with ``device="cuda"``: every fused family (dense,
   pairs, paged, scenario, append steps, both substrates) and the K8
   scaffolds run on the card, their kernels launching, the boundary read
   at each launch: no finding, and every entry of ``HYGIENE_LAUNCHES``
   launched; its launches by entry printed. (d) Every output the port's
   table certifies exact, selection or int-exact (in both substrates'
   build rows) bit-identical between the ``scan:8`` and ``ladder``
   ``build_carry`` on the card: sma_crossover and bollinger on
   ``synthetic_ohlcv(500, 1260, seed=7)`` with the bench grids, the other
   twelve families on 32 tickers of it (pairs on 32 pairs of seed-7
   legs). (a) and (b)'s process runs while this one runs dbxmc, (c) and
   (d). Walls printed beside the card's name and power limit.
15. The reference's public API that the port took over last, at full
   width on phase 4's panels (:func:`phase_api`). (a) The eight standalone
   metrics (``ops/metrics.py``) of the sma bench grid's positions through
   ``backtest_prefix`` (500 x 2000 x 1260, 100 combos a chunk; the first
   chunk also under a ragged mask): each bit-equal to the same field of
   ``summary_metrics`` on the same tensors (they run the same reductions),
   and on a CPU copy of 64 tickers of the first chunk within rtol=1e-5,
   atol=1e-6. (b) ``backtest_prefix(compound=True)`` on that chunk, its
   returns and equity against the CPU copy's within the same tolerance.
   (c) ``backtest_scan`` with a band-hysteresis step over the bollinger
   bench grid's z (500 x 1000 x 1260): positions identical to
   ``signals.band_hysteresis``, returns and equity bit-equal to
   ``backtest_prefix`` of them; the 1260-step loop timed. (d)
   ``chunked_pairs_sweep`` (1000 pairs of ``synthetic_ohlcv(2000, 1260,
   seed=1)`` x 500 combos, ``param_chunk=50``) against
   ``run_pairs_sweep`` under the flip rule of ``tests/torch_parity.py``
   (a cell off by more than 0.01 + 1% is flipped, at most 1%; the rest
   at rtol=2e-4, atol=2e-5, cagr within ``_cagr_slack``): torch's CUDA
   cumsum of the equity associates by the row count; both walls printed.
   (e) The port bench's generic A/B (``DBX_BENCH_GENERIC=1``) through its
   ``sweep_call``: ``sma_fused`` and ``pairs`` fused and generic (the
   generic pairs arm is (d)'s ``chunked_pairs_sweep`` call, the bench's
   own on the same legs), the launch counts reset before each arm (K1 and
   K7 with its tables must launch in the fused arms, nothing in the
   generic ones): sma under the same flip rule against the generic arm
   (tests/test_fused.py's rtol=2e-4, atol=2e-5 elsewhere); pairs under
   phase 4's flip-aware budget (a cell off by more than rtol=2e-3,
   atol=2e-4 counts as flipped, at most 1%) against the generic path in
   f64, phase 4's witness (the f32 generic arm's windowed sums cancel:
   1.016% of the cells flip against it on the H100), the counts against
   the f32 arm and between the two generic runs printed; each arm's
   backtests/s from the
   median of warm calls (fused 5, generic sma 3, generic pairs (d)'s one)
   and the fused/generic ratio. The walls of (a)-(e) printed.
16. Each phase's wall on one line, then one JSON line with each kernel
   entry's (K8: each case's) launches,
   error, times, bound and library time (the tile entries also their
   width sweep, wrapper time, build report and SASS count; the table
   kernels each a record of their own; K1-K6 also their launches on the
   walk-forward main paths, ``walkforward_launches``, every entry but
   K8's on the streaming phase's carry_out calls, ``streaming_launches``,
   and every entry on phase 8's paged and scenario sweeps,
   ``paged_launches`` and ``scenario_launches``, each of them but K7's
   and its tables' launched there, and K1-K7's on phase 9 (a)'s mesh
   route, ``mesh_launches``, the tile entries' on phase 10 (a)'s tuned
   batches, ``tune_launches``, every entry's in phase 11,
   ``dispatch_launches``, and K1's in phase 12, ``obs_launches``, and in
   phase 13's shells, ``native_launches``, and every entry's under phase
   14 (c)'s kernel-hygiene, ``hygiene_launches``, and K1's, K7's and its
   tables' in phase 15 (e)'s fused arms, ``api_launches``); then
   the JSON result line, last.

This script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from distributed_backtesting_exploration_tpu_torch import roofline
from distributed_backtesting_exploration_tpu_torch.roofline import (
    OPS_EACH_BAR, OPS_LEVEL, OPS_PER_BAR, OPS_SIGNAL, OPS_WINDOW)

RTOL, ATOL = 2e-4, 2e-5
N_TICKERS, N_BARS, COST = 500, 1260, 1e-3

# The bench grids (the reference's bench.py, roofline.bench_axes) as wire
# axes.
AXES = roofline.bench_axes()
FAST_AXIS = AXES["sma_crossover"]["fast"]          # 20 fast windows
SLOW_AXIS = AXES["sma_crossover"]["slow"]          # 100 slow windows
N_PAIRS = 1000
# strategy -> its check against the golden path: "exact" identical
# positions, "flip" the flip rule, "shift" the flip-aware budget of a
# signal line that rounds in another order. FAMILIES adds its axes and the
# kernel entry it launches.
CHECKS = {"bollinger": "flip", "bollinger_touch": "flip",
          "stochastic": "exact", "momentum": "exact", "donchian": "exact",
          "donchian_hl": "exact", "rsi": "exact", "keltner": "exact",
          "macd": "shift", "trix": "shift", "obv_trend": "exact",
          "vwap_reversion": "shift", "pairs": "shift"}
FAMILIES = {s: (AXES[s], roofline.ENTRY[s], c) for s, c in CHECKS.items()}
# The "shift" families whose golden path takes the z-score's reductions
# over (tickers, combos, bars) tensors where the fused path takes them over
# (tickers, distinct windows, bars): torch's CUDA reductions split a row by
# the row count, so the two sum in other orders.
# Run one value of this axis at a time, the golden path's tensors have the
# fused path's row count, and positions must then be identical.
SAME_ORDER_AXIS = {"vwap_reversion": "k"}
# The kernel that builds a strategy's table on its main path.
TABLE_KERNELS = {"macd": "ema_rows", "trix": "ema_rows",
                 "pairs": "pairs_tables"}
# The families whose fused path takes its windowed moments on the card as
# f64 differences of f64 prefix sums, rounded once (csrc/pairs_tables.cu),
# nearer exact arithmetic than the generic path's f32 sums, which cancel:
# their budget is held against the generic path run in f64
# (:func:`_gold_f64`), and the cells off against the generic path in f32,
# and between it and the f64 run, are counted and printed.
F64_WITNESS = ("pairs",)
# The reference's flip-aware budget for the "shift" families
# (tests/test_fused.py `_macd_flip_aware_check`, the tolerance of its pairs
# budget `_check_pairs`).
SHIFT_RTOL, SHIFT_ATOL = 2e-3, 2e-4
PKG = "distributed_backtesting_exploration_tpu_torch"
REF = "distributed_backtesting_exploration_tpu/ops/fused.py"


@contextlib.contextmanager
def _env(**values):
    """Set (a str) or unset (None) environment variables for a block."""
    prior = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _once_ms(fn) -> tuple:
    """``fn()`` and the CUDA-event ms of that one call, the card idle
    before it: the plain versions' time, taken on the call that their
    comparison needs anyway (a per-bar loop of torch ops takes seconds)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def _graph_ms(fn, reps: int = 20) -> float:
    """CUDA-event ms of one call of ``fn`` replayed from a CUDA graph of
    ``reps`` calls: the device's time without the host's launch cost,
    printed beside :func:`_cuda_ms` where a call is short."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _flat_grid(axes: dict) -> dict:
    """Flat per-combo arrays of the product of ``axes`` in the wire's
    canonical (sorted) axis order, row-major."""
    names = sorted(axes)
    mesh = np.meshgrid(*(axes[n] for n in names), indexing="ij")
    return {n: m.reshape(-1).astype(np.float32) for n, m in zip(names, mesh)}


def phase_card() -> str:
    _check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    _check(bool(line), f"nvidia-smi gave no card: {smi.stderr.strip()}")
    print(line)
    return line


def phase_build(kernels_mod) -> None:
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in kernels_mod.SRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for name, path in zip(sources, pool.map(kernels_mod.build, sources)):
            kernels_mod.load(name)
            print(f"built {name}: {path.name}")
    print(f"build_s {time.perf_counter() - t0:.3f}")


def _k1_inputs(fused, pnl, close, t_real, fast, slow):
    dev = torch.device("cuda")
    c = torch.as_tensor(close, device=dev)
    fw, sw, warm = fused._grid_setup(fast, slow)
    tr = fused._check_t_real(t_real, *close.shape)
    return (torch.cumsum(c, 1).contiguous(), pnl.simple_returns(c).contiguous(),
            *(torch.from_numpy(a).to(dev) for a in (tr, fw, sw, warm)))


def _compare(fused, tag, label, got, ref, exact: bool = False):
    """Kernel vs plain output planes; returns (max_abs, max_rel). With
    ``exact`` every metric must be bit-equal."""
    torch.cuda.synchronize()
    names = fused.Metrics._fields
    max_abs = max_rel = 0.0
    for k, name in enumerate(names):
        a, b = got[k], ref[k]
        _check(bool(torch.isfinite(a).all()), f"{label}: {name} not finite")
        err = (a - b).abs()
        if exact or name in ("n_trades", "turnover"):
            _check(bool(torch.equal(a, b)),
                   f"{label}: {name} differs (max {float(err.max())}): "
                   "not bit-equal")
        bad = err > ATOL + RTOL * b.abs()
        _check(not bool(bad.any()),
               f"{label}: {name} off in {int(bad.sum())} cells, max abs err "
               f"{float(err.max())}")
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / b.abs().clamp_min(1e-6)).max()))
    print(f"{tag} {label}: max_abs_err {max_abs:.3e} max_rel_err "
          f"{max_rel:.3e}")
    return max_abs, max_rel


def _crafted_returns(n_bars: int) -> np.ndarray:
    """Eight rows of simple returns that drive a lane's equity through 0,
    below 0, to +-inf and to NaN: steps of 30-250% either way (rows 0, 1),
    -100% on every bar (row 2: equity exactly 0 at cost 0, then below), a
    +inf and a -inf return (rows 3, 4), a NaN (row 5), returns of 3e38 that
    overflow the sums (row 6) and subnormal ones (row 7)."""
    rng = np.random.default_rng(12)
    r = (rng.choice(np.float32([-1, 1]), (8, n_bars))
         * rng.uniform(0.3, 2.5, (8, n_bars))).astype(np.float32)
    r[2] = -1.0
    r[3, n_bars // 2] = np.inf
    r[4, n_bars // 2] = -np.inf
    r[5, n_bars // 2] = np.nan
    r[6, n_bars // 3:] = 3e38
    r[7] *= np.float32(1e-40)
    return r


def _compare_bits(fused, tag, label, got, ref):
    """Kernel vs plain output planes where they need not be finite: NaN
    where the plain version has NaN, every other value bit-equal. The plain
    version must reach NaN, +-inf and a total return below -1 (equity below
    0). Returns (0, 0), the errors of the comparison."""
    torch.cuda.synchronize()
    for k, name in enumerate(fused.Metrics._fields):
        a, b = got[k], ref[k]
        nan = torch.isnan(b)
        _check(bool(torch.equal(torch.isnan(a), nan))
               and bool(torch.equal(a[~nan].view(torch.int32),
                                    b[~nan].view(torch.int32))),
               f"{label}: {name} differs from its plain version")
    _check(bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
           and bool((ref[3] < -1).any()),
           f"{label}: the returns reached no NaN, inf or negative equity")
    print(f"{tag} {label}: bit-equal ({int(torch.isnan(ref).sum())} NaN, "
          f"{int(torch.isinf(ref).sum())} inf cells; total return below -1 "
          f"in {int((ref[3] < -1).sum())} lanes)")
    return 0.0, 0.0


def _with_returns(inputs, at: int, r: np.ndarray):
    """``inputs`` with the returns at position ``at`` replaced by ``r``."""
    return (*inputs[:at], torch.as_tensor(r, device=inputs[at].device),
            *inputs[at + 1:])


def _k1_compare(fused, label, inputs, cost):
    """Kernel vs plain on the same inputs, every metric bit-equal; returns
    (max_abs, max_rel)."""
    got = fused.fused_sma_cuda(*inputs, cost=cost, ppy=252)
    ref = fused.fused_sma_plain(*inputs, cost=cost, ppy=252)
    return _compare(fused, "k1", label, got, ref, exact=True)


def _signal_bars(tr, warm) -> float:
    """Bars below each ticker's length at or past each lane's warmup - 1,
    summed over (ticker, lane)."""
    return roofline.signal_bars(tr.cpu().numpy(), warm.cpu().numpy())


def _bound(tr, warm, P, ops_bar, ops_signal, n_bytes,
           extra_ops: float = 0.0) -> tuple[float, str]:
    """Least time for the work: operations over the fp32 rate (every bar
    below a ticker's length, plus the signal work on the bars past each
    lane's warmup, plus ``extra_ops``) against ``n_bytes`` over the memory
    rate."""
    ops = float(ops_bar * tr.double().sum() * P
                + ops_signal * _signal_bars(tr, warm) + extra_ops)
    return roofline.bound_ms(ops, n_bytes)


def _k1_bound_ms(inputs) -> tuple[float, str]:
    """K1's bound: the metric update and the difference and sign per lane,
    the SMA once per (ticker, distinct window, bar) from the first bar a
    lane reads the window."""
    cs, _, tr, fast, slow, warm = inputs
    N, T = cs.shape
    P = fast.shape[0]
    n_bytes = 4 * (2 * N * T + N + 3 * P + 9 * N * P)
    per_window = roofline.window_signal_bars(
        *(x.cpu().numpy() for x in (tr, warm, fast, slow)))
    return _bound(tr, warm, P, OPS_PER_BAR, OPS_SIGNAL["fused_sma"], n_bytes,
                  OPS_WINDOW["fused_sma"] * per_window)


# The tile entries (K1, K2's inline entry, K4, K5, K6 and K7,
# csrc/bar_blocks.cuh): the CTA widths of the width sweep, and the further
# cases that hold them (and momentum) bit-equal to their plain versions:
# long rows, a grid of many distinct windows, and histories that end
# mid-block and are shorter than most windows.
TILE_LANES = (128, 256, 512, 1024)
LONG_TILE_ROWS = (4, 13000)
SHORT_LENS = np.asarray([1, 5, 63, 65, 100, 127, 129, 700])


def _short_histories(panel):
    """The SHORT_LENS.size rows of each array of ``panel`` (an OHLCV panel,
    or a pair's legs) padded by repeating their last bar past SHORT_LENS."""
    for f in panel:
        for i, n in enumerate(SHORT_LENS):
            f[i, n:] = f[i, n - 1]
    return panel


# Each tile entry's library and the C entry of its build report.
TILE_REPORTS = {"fused_sma": ("fused_sma", "dbx_fused_sma_occupancy"),
                "band_inline": ("band_machine", "dbx_band_inline_occupancy"),
                "macd": ("ema_cross", "dbx_macd_occupancy"),
                "obv": ("fused_sma", "dbx_obv_occupancy"),
                "trix": ("ema_cross", "dbx_trix_occupancy"),
                "pairs": ("band_machine", "dbx_pairs_occupancy")}


def _tile_report(fused, entry: str, lanes: int, *windows) -> dict:
    """The build report of a tile entry's kernel on ``lanes``-lane tiles of
    lanes reading ``windows`` (``csrc/occupancy.cuh``), and the longest
    window list of those tiles."""
    wins, counts, *_ = fused.window_tiles(lanes, *windows)
    info = (ctypes.c_int * 4)()
    lib, query = TILE_REPORTS[entry]
    err = getattr(fused._kernels._typed(lib), query)(lanes, wins.shape[1],
                                                      info)
    return {**_report(entry, err, info), "window_list": int(counts.max())}


def _mnemonic(op: str) -> str:
    """A SASS instruction's opcode without its predicate and modifiers."""
    words = [w for w in op.split() if not w.startswith("@")]
    return words[0].split(".")[0] if words else ""


def _sass_loops(kernels_mod, lib: str, kernel) -> list:
    """The loops of ``kernel`` (a substring of its mangled name, or a tuple
    of substrings it holds all of) in the SASS of library ``lib``
    (``cuobjdump -sass``), innermost only: for each,
    its SASS instructions, and those of its common path with their FMNMX,
    FFMA and FADD. The common path leaves out the blocks that a forward
    branch inside the loop skips and that hold a MUFU.RCP: the drawdown
    division of MetricsAcc::step, which runs only on a bar that may set a
    new maximum drawdown (``csrc/metrics_tail.cuh``)."""
    tool = Path(kernels_mod._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(kernels_mod.build(lib))],
                          capture_output=True, text=True, check=True).stdout
    out = []
    parts = kernel if isinstance(kernel, tuple) else (kernel,)
    for func in text.split("Function : ")[1:]:
        name = func.split(None, 1)[0]
        if not all(part in name for part in parts):
            continue
        addr, ops, labels, branches = None, {}, {}, []
        pending = []
        for line in func.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            ops[addr] = m.group(2)
            tgt = re.search(r"\bBRA\b[^`]*?(?:`\((\.L_x_\d+)\)|"
                            r"\s(0x[0-9a-f]+)\s*$)", m.group(2))
            if tgt:
                branches.append((addr, tgt.group(1) or int(tgt.group(2), 16)))
        jumps = [(at, labels.get(tgt) if isinstance(tgt, str) else tgt)
                 for at, tgt in branches]
        jumps = [(at, tgt) for at, tgt in jumps if tgt is not None]
        loops = [(tgt, at) for at, tgt in jumps if tgt <= at]
        for start, end in loops:
            if any(start <= a and b <= end and (a, b) != (start, end)
                   for a, b in loops):
                continue            # holds another loop: not innermost
            body = {a: op for a, op in ops.items() if start <= a <= end}
            rare = set()
            for at, tgt in jumps:
                if start <= at < tgt <= end:
                    block = [a for a in body if at < a < tgt]
                    if any("MUFU.RCP" in body[a] for a in block):
                        rare.update(block)
            common = [op for a, op in body.items() if a not in rare]

            def count(mnemonic):
                return sum(_mnemonic(op) == mnemonic for op in common)
            out.append({"kernel": name, "start": hex(start),
                        "instructions": len(body), "common": len(common),
                        "fmnmx": count("FMNMX"), "ffma": count("FFMA"),
                        "fadd": count("FADD")})
    _check(bool(out), f"no loop of {kernel} found in the SASS of {lib}")
    return out


def _per_bar(loops) -> float:
    """The per-bar instruction count of the metric loop: the innermost loop
    with the most FMNMX on its common path, whose instructions there over
    its bars an iteration. MetricsAcc::step takes three FMNMX a bar on its
    common path (the running peak, the peak's floor, the downside min; the
    drawdown's max sits with its division), so the bars an iteration are
    FMNMX / 3."""
    loop = max(loops, key=lambda x: (x["fmnmx"], x["common"]))
    _check(loop["fmnmx"] >= 3, "no metric loop in the SASS")
    return loop["common"] / (loop["fmnmx"] / 3)


def _k1_launch(fused, inputs, cost, lanes):
    """K1 on ``inputs`` at ``lanes`` lanes a CTA with its tiles built
    beforehand: (its output planes, a function that launches the kernel
    alone), for the kernel's CUDA-event time without the wrapper's tile
    build."""
    cs, r, tr, fast, slow, warm = inputs
    tiles = fused.window_tiles(lanes, fast, slow)
    out = torch.empty((9, cs.shape[0], fast.shape[0]), device=cs.device)
    return out, lambda: fused._launch_fused_sma(cs, r, tr, tiles, warm, out,
                                                lanes, cost=cost, ppy=252)


def _inline_launch(fused, inputs, kw, lanes):
    """K2's inline entry as :func:`_k1_launch`."""
    *rows, tr, window, k, warm = inputs
    tiles = fused.window_tiles(lanes, window)
    out = torch.empty((9, rows[0].shape[0], window.shape[0]),
                      device=window.device)
    code = fused._machine_code(kw["machine"])
    return out, lambda: fused._launch_band_inline(
        rows, tr, tiles, k, warm, out, lanes, code=code,
        z_exit=kw["z_exit"], cost=kw["cost"], ppy=kw["ppy"])


def _obv_launch(fused, inputs, kw, lanes):
    """K6 as :func:`_k1_launch`."""
    obv, cs, r, tr, window, warm = inputs
    tiles = fused.window_tiles(lanes, window)
    out = torch.empty((9, obv.shape[0], window.shape[0]), device=obv.device)
    return out, lambda: fused._launch_obv(obv, cs, r, tr, tiles, warm, out,
                                          lanes, cost=kw["cost"],
                                          ppy=kw["ppy"])


def _trix_launch(fused, inputs, kw, lanes):
    """K5 as :func:`_k1_launch`."""
    tbl, r, tr, widx, a_sig, warm = inputs
    tiles = fused.window_tiles(lanes, widx)
    out = torch.empty((9, tbl.shape[0], widx.shape[0]), device=tbl.device)
    return out, lambda: fused._launch_trix(tbl, r, tr, tiles, a_sig, warm,
                                           out, lanes, cost=kw["cost"],
                                           ppy=kw["ppy"])


def _macd_launch(fused, inputs, kw, lanes):
    """K4 as :func:`_k1_launch`."""
    tbl, r, tr, fidx, sidx, a_sig, warm = inputs
    tiles = fused.window_tiles(lanes, _macd_keys(fused, inputs)[0])
    out = torch.empty((9, tbl.shape[0], fidx.shape[0]), device=tbl.device)
    return out, lambda: fused._launch_macd(tbl, r, tr, tiles, a_sig, warm,
                                           out, lanes, cost=kw["cost"],
                                           ppy=kw["ppy"])


def _pairs_launch(fused, inputs, kw, lanes):
    """K7 as :func:`_k1_launch`."""
    z, hr, tr, widx, k, zx, warm = inputs
    tiles = fused.window_tiles(lanes, widx)
    out = torch.empty((9, z.shape[0], widx.shape[0]), device=z.device)
    return out, lambda: fused._launch_pairs(z, hr, tr, tiles, k, zx, warm,
                                            out, lanes, cost=kw["cost"],
                                            ppy=kw["ppy"])


def _macd_keys(fused, inputs) -> tuple:
    """K4's tile keys (``fused.macd_keys``) of its inputs, as a 1-tuple."""
    tbl, _, _, fidx, sidx, *_ = inputs
    return (fused.macd_keys(fidx, sidx, tbl.shape[1]),)


def _width_sweep(launch, plain_ref, label) -> dict:
    """A tile entry at every width of TILE_LANES (``launch(lanes)`` as
    :func:`_k1_launch` gives it): bit-equal to its plain version's planes
    ``plain_ref``, and the kernel's CUDA-event ms at each."""
    times = {}
    for lanes in TILE_LANES:
        out, run = launch(lanes)
        run()
        torch.cuda.synchronize()
        _check(bool(torch.equal(out, plain_ref)),
               f"{label} at {lanes} lanes differs from its plain version")
        times[lanes] = _cuda_ms(run, reps=20, warmup=2)
    print(f"{label} width sweep (kernel ms by lanes a CTA): " + ", ".join(
        f"{n} {t:.4f}" for n, t in times.items()))
    return times


def _small_cases(data, head):
    """The three small cases beside the headline: (label, OHLCV panel,
    t_real, cost)."""
    small = data.OHLCV(*(f[:32] for f in head))
    lens = np.random.default_rng(1).integers(200, N_BARS + 1, 32)
    ragged = data.OHLCV(*(f.copy() for f in small))
    for f in ragged:
        for i, n in enumerate(lens):
            f[i, n:] = f[i, n - 1]
    short = data.synthetic_ohlcv(32, 251, seed=3)
    return [("32x1260 cost=0", small, None, 0.0),
            ("ragged 32x1260", ragged, lens, COST),
            ("32x251", short, None, COST)]


def phase_kernels(kernels_mod, fused, pnl, data) -> dict:
    grid_f = np.repeat(FAST_AXIS, SLOW_AXIS.size)
    grid_s = np.tile(SLOW_AXIS, FAST_AXIS.size)
    head = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=0).close
    main_in = _k1_inputs(fused, pnl, head, None, grid_f, grid_s)
    errs = [_k1_compare(fused, "headline 500x1260x2000 cost=1e-3", main_in,
                        COST)]
    small = head[:32]
    errs.append(_k1_compare(
        fused, "32x1260x2000 cost=0",
        _k1_inputs(fused, pnl, small, None, grid_f, grid_s), 0.0))
    lens = np.random.default_rng(1).integers(200, N_BARS + 1, 32)
    ragged = small.copy()
    for i, n in enumerate(lens):
        ragged[i, n:] = ragged[i, n - 1]
    errs.append(_k1_compare(
        fused, "ragged 32x1260x2000",
        _k1_inputs(fused, pnl, ragged, lens, grid_f, grid_s), COST))
    short = data.synthetic_ohlcv(32, 251, seed=3).close
    errs.append(_k1_compare(
        fused, "32x251x2000",
        _k1_inputs(fused, pnl, short, None, grid_f, grid_s), COST))
    n, T = LONG_TILE_ROWS
    errs.append(_k1_compare(
        fused, f"long rows {n}x{T}x2000",
        _k1_inputs(fused, pnl, data.synthetic_ohlcv(n, T, seed=5).close,
                   None, grid_f, grid_s), COST))
    wide_f = np.repeat(np.arange(2, 130, dtype=np.float32), 271)
    wide_s = np.tile(np.arange(130, 401, dtype=np.float32), 128)
    errs.append(_k1_compare(
        fused, f"many windows 4x{N_BARS}x{wide_f.size} (fast 2..129 x slow "
        "130..400)", _k1_inputs(fused, pnl, head[:4], None, wide_f, wide_s),
        COST))
    errs.append(_k1_compare(
        fused, f"short histories {SHORT_LENS.tolist()} x2000",
        _k1_inputs(fused, pnl, _short_histories(data.synthetic_ohlcv(
            SHORT_LENS.size, N_BARS, seed=8)).close, SHORT_LENS, grid_f,
            grid_s), COST))
    crafted = _with_returns(
        _k1_inputs(fused, pnl, head[:8], None, grid_f, grid_s), 1,
        _crafted_returns(N_BARS))
    for cost in (0.0, COST):
        errs.append(_compare_bits(
            fused, "k1", f"crafted returns 8x{N_BARS}x2000 cost={cost}",
            fused.fused_sma_cuda(*crafted, cost=cost, ppy=252),
            fused.fused_sma_plain(*crafted, cost=cost, ppy=252)))

    ref, plain_ms = _once_ms(
        lambda: fused.fused_sma_plain(*main_in, cost=COST, ppy=252))
    widths = _width_sweep(
        lambda lanes: _k1_launch(fused, main_in, COST, lanes), ref,
        "k1 fused_sma")
    ms = _cuda_ms(_k1_launch(fused, main_in, COST, fused._SMA_LANES)[1],
                  reps=20, warmup=2)
    wrapper_ms = _cuda_ms(
        lambda: fused.fused_sma_cuda(*main_in, cost=COST, ppy=252), reps=20,
        warmup=2)
    bound_ms, bound_by = _k1_bound_ms(main_in)
    print(f"k1 headline: kernel {ms:.4f} ms, wrapper (with its tile "
          f"build) {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    occupancy = _tile_report(fused, "fused_sma", fused._SMA_LANES,
                             *main_in[3:5])
    loops, per_bar = _loop_sass(kernels_mod, "fused_sma")
    print(f"k1 fused_sma at the headline: {occupancy}; SASS a bar "
          f"{per_bar[None]}; loops {loops}")
    return {"name": "fused_sma", "route": "cuda",
            "source": f"{PKG}/csrc/fused_sma.cu",
            "replaces": f"{REF}:728",
            "tpu_kernel": "ops/fused.py:_fused_call",
            "max_abs_err": max(e[0] for e in errs),
            "max_rel_err": max(e[1] for e in errs),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "wrapper_ms": wrapper_ms, "width_ms": widths,
            "occupancy": occupancy,
            "sass_per_bar": per_bar[None]}


# --- K2 and K3: inputs of each entry as its sweep wrapper prepares them ---

def _common(fused, pnl, panel, t_real):
    dev = torch.device("cuda")
    close, high, low = (torch.as_tensor(f, device=dev).contiguous()
                        for f in (panel.close, panel.high, panel.low))
    tr = fused._check_t_real(t_real, *close.shape)
    r = pnl.simple_returns(close).contiguous()
    return dev, close, high, low, torch.from_numpy(tr).to(dev), r


def _band_inline_inputs(fused, pnl, panel, t_real, axes=None):
    dev, close, _, _, tr, r = _common(fused, pnl, panel, t_real)
    g = _flat_grid(axes or AXES["bollinger"])
    _, win, _, warm = fused._window_setup(g["window"], "windows", 0.0, 1)
    xc = close - close.mean(dim=1, keepdim=True)
    rows = (close, torch.cumsum(close, 1), torch.cumsum(xc, 1),
            torch.cumsum(xc * xc, 1), r)
    return (*(x.contiguous() for x in rows), tr,
            *fused._to(dev, win, g["k"], warm))


def _lanes(fused, dev, widx, *per_lane):
    """Per-lane arrays in window-major slot order, as the sweeps pass them,
    on ``dev``, then the ``lane`` array."""
    lane, _, *sorted_ = fused.window_major(widx, *per_lane)
    return (*fused._to(dev, *sorted_), *fused._to(dev, lane))


def _band_stoch_inputs(fused, pnl, panel, t_real, axes=None):
    dev, close, high, low, tr, r = _common(fused, pnl, panel, t_real)
    g = _flat_grid(axes or AXES["stochastic"])
    _, win, widx, warm = fused._window_setup(g["window"], "windows", 0.0, 1)
    return (close, high, low, r, tr,
            *_lanes(fused, dev, widx, win, g["band"], warm))


def _momentum_inputs(fused, pnl, panel, t_real, axes=None):
    dev, close, _, _, tr, r = _common(fused, pnl, panel, t_real)
    _, lb, _, warm = fused._window_setup(
        (axes or AXES["momentum"])["lookback"], "lookbacks", 1.0, 0)
    return (close, r, tr, *fused._to(dev, lb, warm))


def _donchian_inputs(fused, pnl, panel, t_real, axes=None):
    dev, close, high, low, tr, r = _common(fused, pnl, panel, t_real)
    _, win, widx, warm = fused._window_setup(
        (axes or AXES["donchian"])["window"], "windows", 1.0, 1)
    return (close, high, low, r, tr, *_lanes(fused, dev, widx, win, warm))


def _rsi_table_inputs(fused, pnl, panel, t_real, axes=None):
    dev, close, _, _, tr, r = _common(fused, pnl, panel, t_real)
    g = _flat_grid(axes or AXES["rsi"])
    periods, _, widx, warm = fused._window_setup(g["period"], "periods",
                                                 1.0, 1)
    z = fused.rsi_z_table(close, periods)
    return (z, r, tr, *_lanes(fused, dev, widx, widx, g["band"], warm))


def _keltner_table_inputs(fused, pnl, panel, t_real):
    dev, close, high, low, tr, r = _common(fused, pnl, panel, t_real)
    g = _flat_grid(AXES["keltner"])
    windows, _, widx, warm = fused._window_setup(g["window"], "windows",
                                                 0.0, 1)
    z = fused.keltner_z_table(close, high, low, windows)
    return (z, r, tr, *_lanes(fused, dev, widx, widx, g["k"], warm))


def _macd_inputs(fused, pnl, panel, t_real, axes=None):
    dev, close, _, _, tr, r = _common(fused, pnl, panel, t_real)
    g = _flat_grid(axes or AXES["macd"])
    spans, fidx, sidx, a_sig, warm = fused._macd_grid_setup(
        g["fast"], g["slow"], g["signal"])
    return (fused.macd_sweep_table(close, spans), r, tr,
            *fused._to(dev, fidx, sidx, a_sig, warm))


def _trix_inputs(fused, pnl, panel, t_real, axes=None):
    dev, close, _, _, tr, r = _common(fused, pnl, panel, t_real)
    g = _flat_grid(axes or AXES["trix"])
    spans, widx, a_sig, warm = fused._trix_grid_setup(g["span"], g["signal"])
    return (fused.trix_sweep_table(close, spans), r, tr,
            *fused._to(dev, widx, a_sig, warm))


def _volume(panel, dev):
    return torch.as_tensor(panel.volume, device=dev).contiguous()


def _vwap_table_inputs(fused, pnl, panel, t_real):
    dev, close, _, _, tr, r = _common(fused, pnl, panel, t_real)
    g = _flat_grid(AXES["vwap_reversion"])
    windows, _, widx, warm = fused._window_setup(g["window"], "windows",
                                                 -1.0, 1, 2.0)
    z = fused.vwap_z_table(close, _volume(panel, dev), windows)
    return (z, r, tr, *_lanes(fused, dev, widx, widx, g["k"], warm))


def _obv_inputs(fused, pnl, panel, t_real, axes=None):
    dev, close, _, _, tr, r = _common(fused, pnl, panel, t_real)
    _, win, _, warm = fused._window_setup(
        (axes or AXES["obv_trend"])["window"], "windows", 0.0, 1)
    series = fused.rolling.obv_series(close, _volume(panel, dev))
    return (series.contiguous(), torch.cumsum(series, 1).contiguous(), r,
            tr, *fused._to(dev, win, warm))


def _pairs_inputs(fused, pnl, legs, t_real, axes=None):
    dev = torch.device("cuda")
    y, x = (torch.as_tensor(c, device=dev).contiguous() for c in legs)
    g = _flat_grid(axes or AXES["pairs"])
    windows, widx, k, zx, warm = fused._pairs_grid_setup(
        g["lookback"], g["z_entry"], 0.0)
    z, hr = fused.pairs_sweep_tables(y, x, windows)
    tr = fused._check_t_real(t_real, *y.shape)
    return (z, hr, *fused._to(dev, tr, widx, k, zx, warm))


def _pairs_legs(data, n_pairs, n_bars, seed):
    closes = data.synthetic_ohlcv(2 * n_pairs, n_bars, seed=seed)
    return (data.OHLCV(*(f[:n_pairs] for f in closes)),
            data.OHLCV(*(f[n_pairs:] for f in closes)))


def _pairs_panel(data, n_pairs, n_bars, seed):
    """K7's inputs' source for a case: the (y, x) close legs of
    ``n_pairs`` pairs."""
    return tuple(leg.close for leg in _pairs_legs(data, n_pairs, n_bars,
                                                  seed))


def _pairs_cases(data):
    """K7's four cases, on (y, x) close legs: the main path's 1000 pairs,
    and 32 of them at cost 0, ragged (both legs of a pair padded alike)
    and at T=251."""
    y, x = (leg.close for leg in _pairs_legs(data, N_PAIRS, N_BARS, 1))
    sy, sx = y[:32], x[:32]
    lens = np.random.default_rng(1).integers(200, N_BARS + 1, 32)
    ry, rx = sy.copy(), sx.copy()
    for leg in (ry, rx):
        for i, n in enumerate(lens):
            leg[i, n:] = leg[i, n - 1]
    short = (leg.close for leg in _pairs_legs(data, 32, 251, 3))
    return [(f"headline {N_PAIRS}x{N_BARS}", (y, x), None, COST),
            (f"32x{N_BARS} cost=0", (sy, sx), None, 0.0),
            (f"ragged 32x{N_BARS}", (ry, rx), lens, COST),
            ("32x251", tuple(short), None, COST)]


# Further tables of an entry, each run at 32 x 1260 and at the main path's
# 500 x 1260 (compared, and timed on the machine its strategy uses).
EXTRA_CASES = {"band_table": (("keltner", _keltner_table_inputs),
                              ("vwap", _vwap_table_inputs))}

# The window-major entries' two further cases: long rows (the channel
# levels in device memory, the table rows read there), and a grid of 2368
# lanes (8 bands or repeats x 296 windows) whose lane blocks straddle
# windows, held against the plain version in the caller's lane order.
LONG_ROWS = (4, 5000)
STRADDLE_AXES = {
    "band_stoch": {"band": np.linspace(10, 40, 8).astype(np.float32),
                   "window": np.arange(5, 301, dtype=np.float32)},
    "band_table": {"band": np.linspace(10, 30, 8).astype(np.float32),
                   "period": np.arange(5, 301, dtype=np.float32)},
    "donchian": {"window": np.tile(np.arange(5, 301, dtype=np.float32), 8)},
}


def _entry_bytes(inputs) -> int:
    """Bytes each entry must move: every distinct input read once, the
    (9, N, P) metrics written once."""
    seen = {}
    for x in inputs:
        seen[(x.data_ptr(), x.numel())] = x.numel() * x.element_size()
    N = inputs[0].shape[0]
    P = inputs[-1].shape[0]
    return sum(seen.values()) + 4 * 9 * N * P


class Tile(NamedTuple):
    """What a tile entry (``csrc/bar_blocks.cuh``) reports beside its
    cases: the launch of its kernel alone on tiles built beforehand
    (``launch(fused, inputs, kw, lanes)`` as :func:`_k1_launch`), the name
    of its shipped width in ``ops/fused.py``, and ``windows(fused,
    inputs)``, the lanes' windows its wrapper builds the tiles of."""

    launch: Callable
    lanes: str
    windows: Callable


class Entry(NamedTuple):
    """One kernel entry of phase 3: its tag, the TPU kernel's line, its
    source, the function making its inputs, the position of t_real in
    them, the kernel and plain versions, the machines it runs, and its
    cases (None: the shared ones of 500 tickers). A window-major entry
    ends its inputs with its ``n_lane`` per-lane arrays (window or table
    row, [k,] warm) and ``lane``; it is held bit-equal and runs the
    long-row and straddling cases. An entry with ``wide_axes`` (its grid
    of many distinct windows) is held bit-equal and runs the long-row,
    many-window and short-history cases; a tile entry (``tile``) also the
    width sweep. ``returns_at``: the position of the returns in the inputs
    of an entry that also runs the crafted returns (K7: its hedged-return
    table, each row of a pair the crafted row). ``panel(data, n, T,
    seed)`` makes what ``build`` takes for those further cases (None: an
    OHLCV panel of n tickers)."""

    tag: str
    line: int
    src: str
    build: Callable
    tr_at: int
    kernel: Callable
    plain: Callable
    machines: tuple
    cases: Callable | None = None
    n_lane: int = 0
    wide_axes: dict | None = None
    tile: Tile | None = None
    returns_at: int | None = None
    panel: Callable | None = None


# Many distinct windows on one axis: 399 a list, tiled three times.
WIDE_WINDOWS = np.tile(np.arange(2, 401, dtype=np.float32), 3)


def _at(i: int) -> Callable:
    """A Tile's ``windows``: the lanes' windows at position ``i`` of the
    inputs."""
    return lambda fused, inputs: (inputs[i],)


def _entries(fused):
    return {
        "band_inline": Entry("k2", 1166, "band_machine.cu",
                             _band_inline_inputs, 5, fused.band_inline_cuda,
                             fused.band_inline_plain,
                             ("hysteresis", "touch"),
                             wide_axes={"k": np.linspace(0.5, 3.0, 8)
                                        .astype(np.float32),
                                        "window": np.arange(
                                            5, 301, dtype=np.float32)},
                             tile=Tile(_inline_launch, "_BAND_INLINE_LANES",
                                       _at(6))),
        "band_table": Entry("k2", 1166, "band_machine.cu",
                            _rsi_table_inputs, 2, fused.band_table_cuda,
                            fused.band_machine_plain,
                            ("hysteresis", "touch"), n_lane=3),
        "band_stoch": Entry("k2", 1166, "band_machine.cu",
                            _band_stoch_inputs, 4, fused.band_stoch_cuda,
                            fused.band_stoch_plain,
                            ("hysteresis", "touch"), n_lane=3),
        "momentum": Entry("k3", 1933, "single_window.cu", _momentum_inputs,
                          2, fused.momentum_cuda, fused.momentum_plain,
                          (None,), wide_axes={"lookback": WIDE_WINDOWS},
                          returns_at=1),
        "donchian": Entry("k3", 1933, "single_window.cu", _donchian_inputs,
                          4, fused.donchian_cuda, fused.donchian_plain,
                          (None,), n_lane=2),
        "macd": Entry("k4", 2661, "ema_cross.cu", _macd_inputs, 2,
                      fused.macd_cuda, fused.macd_plain, (None,),
                      wide_axes={"fast": np.arange(2, 42, dtype=np.float32),
                                 "signal": np.float32([3, 9]),
                                 "slow": np.arange(42, 401, 9,
                                                   dtype=np.float32)},
                      tile=Tile(_macd_launch, "_MACD_LANES", _macd_keys),
                      returns_at=1),
        "trix": Entry("k5", 3009, "ema_cross.cu", _trix_inputs, 2,
                      fused.trix_cuda, fused.trix_plain, (None,),
                      wide_axes={"signal": np.float32([3, 9]),
                                 "span": np.arange(2, 401, dtype=np.float32)},
                      tile=Tile(_trix_launch, "_TRIX_LANES", _at(3)),
                      returns_at=1),
        "obv": Entry("k6", 2841, "fused_sma.cu", _obv_inputs, 3,
                     fused.obv_cuda, fused.obv_plain, (None,),
                     wide_axes={"window": WIDE_WINDOWS},
                     tile=Tile(_obv_launch, "_OBV_LANES", _at(4))),
        "pairs": Entry("k7", 1482, "band_machine.cu", _pairs_inputs, 2,
                       fused.pairs_cuda, fused.pairs_plain, (None,),
                       _pairs_cases,
                       wide_axes={"lookback": np.arange(2, 401,
                                                        dtype=np.float32),
                                  "z_entry": np.float32([1.0, 2.0])},
                       tile=Tile(_pairs_launch, "_PAIRS_LANES", _at(3)),
                       returns_at=1, panel=_pairs_panel),
    }


def _kw(machine, cost):
    kw = {"cost": cost, "ppy": 252}
    if machine is not None:
        kw.update(machine=machine, z_exit=0.0)
    return kw


def _level_ops(tr, window) -> float:
    """The level build of a channel entry: per ticker, the levels up to the
    largest power of two <= min(its largest window, its length), one max and
    one min a level and bar."""
    w_max = int(window.max())
    return float(sum(OPS_LEVEL * n * (max(min(w_max, n), 1).bit_length() - 1)
                     for n in tr.cpu().tolist()))


def _n_series(fused, entry, inputs) -> int:
    """The distinct series a ticker's lanes of trix or macd read: the
    table's spans (trix), the lanes' (fast, slow) pairs (macd)."""
    if entry == "trix":
        return inputs[0].shape[1]
    return int(torch.unique(_macd_keys(fused, inputs)[0]).numel())


def _entry_bound(fused, entry, e: Entry, inputs):
    tr = inputs[e.tr_at]
    warm = inputs[-2] if e.n_lane else inputs[-1]
    if entry in ("trix", "macd"):
        # The rate of change or the macd line once per (ticker, distinct
        # series, bar) from bar 0.
        extra = OPS_WINDOW[entry] * _n_series(fused, entry, inputs) * float(
            tr.double().sum())
    else:
        # The per-window work once per (ticker, distinct window), from its
        # warmup: a lane's warmup is a function of its window alone.
        extra = OPS_WINDOW.get(entry, 0) * _signal_bars(tr,
                                                        torch.unique(warm))
    if entry in ("band_stoch", "donchian"):
        extra += _level_ops(tr, inputs[e.tr_at + 1])
    return _bound(tr, warm, warm.shape[0],
                  OPS_PER_BAR + OPS_EACH_BAR.get(entry, 0),
                  OPS_SIGNAL[entry], _entry_bytes(inputs), extra)


def _macd_lane_bound(inputs):
    """K4's bound with the macd line counted on every lane, the count of
    its kernel before it ran on tiles."""
    tr, warm = inputs[2], inputs[-1]
    return _bound(tr, warm, warm.shape[0],
                  OPS_PER_BAR + OPS_EACH_BAR["macd"] + OPS_WINDOW["macd"],
                  OPS_SIGNAL["macd"], _entry_bytes(inputs))


def _lane_cases(data, entry: str, e: Entry):
    """The long-row and straddling runs of a window-major entry: (label,
    inputs function, panel, t_real, cost, caller order)."""
    n, T = LONG_ROWS
    long = data.synthetic_ohlcv(n, T, seed=5)
    small = data.synthetic_ohlcv(8, N_BARS, seed=6)
    axes = STRADDLE_AXES[entry]

    def straddle(fused, pnl, panel, t_real):
        return e.build(fused, pnl, panel, t_real, axes=axes)
    return [(f"long rows {n}x{T}", e.build, long, None, COST, False),
            (f"straddling 8x{N_BARS}x2368", straddle, small, None, COST,
             True)]


def _panel_of(data, e: Entry, n: int, T: int, seed: int):
    """What ``e.build`` takes for a further case of n tickers (K7: n
    pairs) of T bars."""
    if e.panel is not None:
        return e.panel(data, n, T, seed)
    return data.synthetic_ohlcv(n, T, seed=seed)


def _tile_cases(data, e: Entry):
    """The further runs of an entry with ``wide_axes``: (label, inputs
    function, panel, t_real, cost, caller order)."""
    n, T = LONG_TILE_ROWS
    n_wide = int(np.prod([a.size for a in e.wide_axes.values()]))

    def wide(fused, pnl, panel, t_real):
        return e.build(fused, pnl, panel, t_real, axes=e.wide_axes)
    return [(f"long rows {n}x{T}", e.build, _panel_of(data, e, n, T, 5),
             None, COST, False),
            (f"many windows 4x{N_BARS}x{n_wide}", wide,
             _panel_of(data, e, 4, N_BARS, 6), None, COST, False),
            (f"short histories {SHORT_LENS.tolist()}", e.build,
             _short_histories(_panel_of(data, e, SHORT_LENS.size, N_BARS,
                                        8)), SHORT_LENS, COST, False)]


def _crafted_inputs(inputs, at: int):
    """``inputs`` with the returns at position ``at`` the crafted returns
    (:func:`_crafted_returns`); a (N, W, T) table of returns (K7's hedged
    returns) takes each ticker's crafted row on every one of its rows."""
    r = _crafted_returns(N_BARS)
    if inputs[at].ndim == 3:
        r = np.ascontiguousarray(np.broadcast_to(r[:, None, :],
                                                 inputs[at].shape))
    return _with_returns(inputs, at, r)


def _occupancy(fused, entry: str, T: int) -> dict:
    """The build report of a window-major entry's kernel at row length
    ``T``, as its C entry launches it (``csrc/occupancy.cuh``): registers
    a thread, resident CTAs and warps an SM, lanes and dynamic shared
    memory a CTA."""
    info = (ctypes.c_int * 4)()
    if entry == "donchian":
        lib = fused._kernels.single_window_lib()
        err = lib.dbx_donchian_occupancy(T, info)
    else:
        lib = fused._kernels.band_machine_lib()
        err = lib.dbx_band_occupancy(int(entry == "band_stoch"), T, info)
    return _report(entry, err, info)


def _report(entry: str, err: int, info) -> dict:
    """A build report's ``info[0..3]`` (``csrc/occupancy.cuh``) by name."""
    _check(err == 0, f"{entry} occupancy query failed: CUDA error {err}")
    regs, ctas, lanes, smem = info
    return {"registers": regs, "ctas_per_sm": ctas,
            "warps_per_sm": ctas * lanes // 32, "lanes": lanes,
            "smem_bytes": smem}


def _caller_order(inputs, n_lane: int):
    """The same inputs with the slots put back in the caller's lane order
    and ``lane`` the identity: the plain version's reference for the
    window-major launch."""
    *head, lane = inputs
    inv = torch.empty_like(lane)
    inv[lane.long()] = torch.arange(lane.numel(), dtype=lane.dtype,
                                    device=lane.device)
    per_lane = [x[inv.long()] for x in head[-n_lane:]]
    ident = torch.arange(lane.numel(), dtype=lane.dtype, device=lane.device)
    return (*head[:-n_lane], *per_lane, ident)


# The entries whose metric loop's SASS a bar is printed: entry ->
# (library, {machine: the kernel's name in the SASS, or parts of it}). K2's
# table entry is its hysteresis kernel on rows staged.
LOOP_SASS = {
    "fused_sma": ("fused_sma", {None: "fused_sma_kernel"}),
    "band_inline": ("band_machine",
                    {"hysteresis": "band_inline_kernelILi0E",
                     "touch": "band_inline_kernelILi1E"}),
    "band_table": ("band_machine",
                   {None: ("band_source_kernelILi0E", "TableZILb1E")}),
    "macd": ("ema_cross", {None: "macd_kernel"}),
    "trix": ("ema_cross", {None: "trix_kernel"}),
    "obv": ("fused_sma", {None: "obv_kernel"}),
    "pairs": ("band_machine", {None: "pairs_kernel"}),
}


def _loop_sass(kernels_mod, entry: str) -> tuple[dict, dict]:
    """The SASS loops (:func:`_sass_loops`) of ``LOOP_SASS[entry]``'s
    kernels and their instructions a bar (:func:`_per_bar`), by machine."""
    lib, kernels = LOOP_SASS[entry]
    loops = {m: _sass_loops(kernels_mod, lib, k) for m, k in kernels.items()}
    return loops, {m: _per_bar(x) for m, x in loops.items()}


def phase_new_kernels(fused, pnl, data) -> dict:
    """K2-K7, every entry and machine, against their plain versions in the
    four cases (and K2's table entry on the keltner and vwap z-tables; the
    window-major entries also on long rows and a straddling grid; the tile
    entries and momentum on the cases of :func:`_tile_cases`; momentum,
    K4, K5 and K7 on crafted returns); times and bound at the main path's
    shape, the first case. Returns one kernels-line record per entry."""
    head = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=0)
    shared = [(f"headline {N_TICKERS}x{N_BARS}", head, None, COST)] + \
        _small_cases(data, head)
    small = data.OHLCV(*(f[:32] for f in head))
    out = {}
    for entry, e in _entries(fused).items():
        errs = []
        timing = {}
        widths, wrapper_ms = {}, {}
        runs = [(label, e.build, panel, t_real, cost, False)
                for label, panel, t_real, cost in (e.cases(data) if e.cases
                                                   else shared)]
        for what, extra in EXTRA_CASES.get(entry, ()):
            runs += [(f"{what} z-table 32x{N_BARS}", extra, small, None,
                      COST, False),
                     (f"{what} z-table {N_TICKERS}x{N_BARS}", extra, head,
                      None, COST, False)]
        if e.n_lane:
            runs += _lane_cases(data, entry, e)
        if e.wide_axes:
            runs += _tile_cases(data, e)
        if e.returns_at is not None:
            def crafted(fused, pnl, panel, t_real):
                return _crafted_inputs(e.build(fused, pnl, panel, t_real),
                                       e.returns_at)
            crafted_panel = (_panel_of(data, e, 8, N_BARS, 12) if e.panel
                             else data.OHLCV(*(f[:8] for f in head)))
            runs += [(f"crafted returns 8x{N_BARS} cost={cost}", crafted,
                      crafted_panel, None, cost, False)
                     for cost in (0.0, COST)]
        tables = {}
        for i, (label, make, panel, t_real, cost, caller) in enumerate(runs):
            inputs = make(fused, pnl, panel, t_real)
            ref_in = _caller_order(inputs, e.n_lane) if caller else inputs
            for machine in e.machines:
                kw = _kw(machine, cost)
                name = f"{entry}" + (f" {machine}" if machine else "")
                ref, plain_ms = _once_ms(lambda: e.plain(*ref_in, **kw))
                got = e.kernel(*inputs, **kw)
                if label.startswith("crafted"):
                    errs.append(_compare_bits(fused, e.tag, f"{name} {label}",
                                              got, ref))
                else:
                    errs.append(_compare(fused, e.tag, f"{name} {label}",
                                         got, ref,
                                         exact=bool(e.n_lane or e.wide_axes)))
                if caller:
                    errs.append(_compare(
                        fused, e.tag, f"{name} {label} (caller's order)",
                        e.kernel(*ref_in, **kw), ref, exact=True))
                if i == 0 and e.n_lane and machine == e.machines[0]:
                    occupancy = _occupancy(fused, entry, N_BARS)
                    print(f"{e.tag} {entry} at T={N_BARS}: {occupancy}")
                run = functools.partial(e.kernel, *inputs, **kw)
                if i == 0 and e.tile:
                    head_win = e.tile.windows(fused, inputs)
                    widths[machine] = _width_sweep(
                        lambda lanes: e.tile.launch(fused, inputs, kw,
                                                    lanes), ref,
                        f"{e.tag} {name}")
                    wrapper_ms[machine] = _cuda_ms(run, reps=20, warmup=2)
                    run = e.tile.launch(fused, inputs, kw,
                                        getattr(fused, e.tile.lanes))[1]
                if i == 0:
                    ms = _cuda_ms(run, reps=20, warmup=2)
                    bound = _entry_bound(fused, entry, e, inputs)
                    timing[machine] = (ms, plain_ms, bound)
                    print(f"{e.tag} {name} headline: kernel {ms:.4f} ms, "
                          f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} "
                          f"ms ({bound[1]})")
                    if entry == "macd":
                        lane_bound = _macd_lane_bound(inputs)
                        print(f"{e.tag} {name} bound with the macd line on "
                              f"every lane (the parent's count): "
                              f"{lane_bound[0]:.4f} ms ({lane_bound[1]})")
            if i > 0 and label.endswith(f"z-table {N_TICKERS}x{N_BARS}"):
                # Another main path's table: timed on its machine.
                kw = _kw(e.machines[0], cost)
                ms = _cuda_ms(lambda: e.kernel(*inputs, **kw), reps=20,
                              warmup=2)
                bound = _entry_bound(fused, entry, e, inputs)
                what = label.split(" z-table")[0]
                tables[what] = {"ms": ms, "bound_ms": bound[0],
                                "bound_by": bound[1]}
                print(f"{e.tag} {entry} {e.machines[0]} {label}: kernel "
                      f"{ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        ms, plain_ms, bound = timing[e.machines[0]]
        out[entry] = {
            "name": entry, "route": "cuda",
            "source": f"{PKG}/csrc/{e.src}", "replaces": f"{REF}:{e.line}",
            "max_abs_err": max(err[0] for err in errs),
            "max_rel_err": max(err[1] for err in errs),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}
        if e.machines[0] is not None:
            out[entry]["machine_timed"] = e.machines[0]
            out[entry]["touch_ms"] = timing["touch"][0]
        if tables:
            out[entry]["other_tables"] = tables
        if e.n_lane:
            out[entry]["occupancy"] = occupancy
        if entry == "macd":
            out[entry]["lane_bound_ms"] = lane_bound[0]
        if entry in LOOP_SASS:
            loops, per_bar = _loop_sass(fused._kernels, entry)
            out[entry]["sass_per_bar"] = per_bar.get(None, per_bar)
            print(f"{e.tag} {entry} SASS a bar (common path): {per_bar}; "
                  f"loops {loops}")
        if e.tile:
            if e.machines == (None,):       # one machine: no dict by machine
                wrapper_ms, widths = wrapper_ms[None], widths[None]
            out[entry].update(
                wrapper_ms=wrapper_ms, width_ms=widths,
                occupancy=_tile_report(fused, entry,
                                       getattr(fused, e.tile.lanes),
                                       *head_win))
            print(f"{e.tag} {entry} at the headline: "
                  f"{out[entry]['occupancy']}")
    return out


# --- the table kernels (csrc/ema_rows.cu, csrc/pairs_tables.cu) ----------

def _bits_equal(a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _max_abs_err(a, b) -> float:
    """The largest |a - b| over the cells where a and b are finite (the
    tables' other cells are held by :func:`_bits_equal`)."""
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0


def _ema_rows_cases(fused, data):
    """``dbx_ema_rows``'s cases, (label, x, decay, ladders, plain): trix's
    table of the main path's panel, of 32 ragged rows (padded by their last
    bar), at T=251, T=2 and T=2048 (the largest register plan) and on long
    rows (4 x 13000, staged in device memory), and macd's one-ladder table
    of the main path's panel."""
    dev = torch.device("cuda")
    head = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=0)
    spans = np.unique(AXES["trix"]["span"])
    _, (_, ragged, _, _), (_, short, _, _) = _small_cases(data, head)
    n, T = LONG_TILE_ROWS
    cases = []
    for label, panel in ((f"trix {N_TICKERS}x{N_BARS}", head),
                         (f"trix ragged 32x{N_BARS}", ragged),
                         ("trix 32x251", short),
                         ("trix 3x2", data.synthetic_ohlcv(3, 2, seed=4)),
                         ("trix 3x2048", data.synthetic_ohlcv(3, 2048,
                                                             seed=6)),
                         (f"trix long rows {n}x{T}",
                          data.synthetic_ohlcv(n, T, seed=5))):
        close = torch.as_tensor(panel.close, device=dev).contiguous()
        cases.append((label, close, fused.ema_decay(dev, spans), 3,
                      functools.partial(fused.trix_ema_table, close, spans)))
    close = torch.as_tensor(head.close, device=dev).contiguous()
    macd_spans = np.unique(np.concatenate([AXES["macd"]["fast"],
                                           AXES["macd"]["slow"]]))
    cases.append((f"macd one ladder {N_TICKERS}x{N_BARS}",
                  (close - close[:, :1]).contiguous(),
                  fused.ema_decay(dev, macd_spans), 1,
                  functools.partial(fused.macd_ema_table, close, macd_spans)))
    return cases


def _pairs_table_cases(data):
    """``dbx_pairs_tables``'s cases, (label, (y, x) close legs, lookbacks or
    None for the bench's): the cases of :func:`_pairs_cases`; long rows
    2 x 3500 and 1 x 5000 (the prefix rows read from device memory) and
    2 x 13000; T=1 and T=2; and 4 x 1300 with a lookback of 600 bars,
    longer than the sums launch's ring (the lags read from device memory,
    a fourth launch for hr)."""
    longs = [(f"long rows {n}x{T}",
              tuple(leg.close for leg in _pairs_legs(data, n, T, 5)), None)
             for n, T in ((2, 3500), (1, 5000), (2, 13000), (3, 1), (3, 2))]
    lag_mem = np.concatenate([np.unique(AXES["pairs"]["lookback"]), [600]])
    return ([(label, legs, None) for label, legs, _, _ in _pairs_cases(data)]
            + longs
            + [("lags from memory 4x1300",
                tuple(leg.close for leg in _pairs_legs(data, 4, 1300, 6)),
                lag_mem)])


def _launch_split(run, reps: int = 5) -> dict:
    """Device microseconds a call of each kernel ``run`` launches, by
    kernel name, from ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        # "(anonymous namespace)::legs_kernel(...)": the name after the
        # first "::" (the arguments may hold more).
        name = re.search(r"::(\w+)[<(]", e.key)
        if e.device_time_total > 0 and name:
            split[name.group(1)] = e.device_time_total / reps
    return split


def phase_tables(fused, data) -> dict:
    """The table kernels against their plain versions, every value
    bit-equal: ``dbx_ema_rows`` against ``trix_ema_table`` (and, one
    ladder, ``macd_ema_table``), ``dbx_pairs_tables`` against
    ``pairs_tables_plain``, each case with its plan. Each kernel is timed at its main path's
    shape (CUDA events through the wrapper, and the device time from a CUDA
    graph of 20 calls) beside its bound and plain version (pairs also
    beside ``pairs_tables``, the torch prep it replaced); ``python3
    chip_smoke.py --parent DIR`` times another tree's beside them. Returns
    one kernels-line record each."""
    dev = torch.device("cuda")
    records = {}
    errs = {"ema_rows": [], "pairs_tables": []}
    for i, (label, x, decay, ladders, plain) in enumerate(
            _ema_rows_cases(fused, data)):
        got = fused.ema_rows_cuda(x, decay, ladders)
        ref = plain()
        torch.cuda.synchronize()
        errs["ema_rows"].append(_max_abs_err(got, ref))
        _check(_bits_equal(got, ref), f"ema_rows {label} differs from its "
               f"plain version (max {errs['ema_rows'][-1]})")
        T = x.shape[1]
        print(f"ema_rows {label} {tuple(got.shape)}: bit-equal (registers "
              f"a lane {fused.ema_rows_registers(T)}, scratch floats a row "
              f"{fused._ema_rows_scratch(T)})")
        if i == 0 or label.startswith("macd"):
            # The main paths' tables: trix's (the first case), macd's.
            N, W, T = got.shape
            run = functools.partial(fused.ema_rows_cuda, x, decay, ladders)
            ms = _cuda_ms(run, reps=20, warmup=2)
            device_ms = _graph_ms(run)
            plain_ms = _cuda_ms(plain, reps=5, warmup=1)
            bound = roofline.ema_rows_bound(N, W, T, ladders)
            timed = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1]}
            if i == 0:
                records["ema_rows"] = {
                    "name": "ema_rows", "route": "cuda",
                    "source": f"{PKG}/csrc/ema_rows.cu",
                    "replaces": f"{REF}:3009", "kernel_ms": ms,
                    **timed, "library_ms": None}
            else:
                records["ema_rows"]["other_tables"] = {"macd": {
                    **timed, "replaces": f"{REF}:2675"}}
            print(f"ema_rows {label}: kernel {ms:.4f} ms (device "
                  f"{device_ms:.4f}), plain ({plain.func.__name__}) "
                  f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    bench_windows = np.unique(AXES["pairs"]["lookback"]).astype(np.int32)
    for i, (label, legs, lookbacks) in enumerate(_pairs_table_cases(data)):
        w_np = (bench_windows if lookbacks is None
                else np.asarray(lookbacks, np.int32))
        windows = torch.from_numpy(w_np).to(dev)
        y, x = (torch.as_tensor(c, device=dev).contiguous() for c in legs)
        args = (y, x, x.mean(dim=1), y.mean(dim=1), windows)
        max_window = int(w_np.max())
        got = fused.pairs_tables_cuda(*args, max_window=max_window)
        ref = fused.pairs_tables_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("z", "hr"), got, ref):
            errs["pairs_tables"].append(_max_abs_err(a, b))
            _check(_bits_equal(a, b), f"pairs_tables {label}: {name} "
                   f"differs from its plain version (max "
                   f"{errs['pairs_tables'][-1]})")
        N, T = y.shape
        plan = fused.pairs_tables_plan(N, T, w_np.size, max_window)
        print(f"pairs_tables {label} {tuple(got[0].shape)}: z and hr "
              f"bit-equal (plan: scratch floats {plan[0]}, pairs a legs CTA "
              f"{plan[1]}, rows a sums CTA {plan[2]}, launches {plan[3]}, "
              f"prefix rows staged {plan[4]}, ring tiles {plan[5]}, prefix "
              f"rows in z {plan[6]})")
        if i == 0:
            N, W, T = got[0].shape
            run = functools.partial(fused.pairs_tables_cuda, *args,
                                    max_window=max_window)
            ms = _cuda_ms(run, reps=20, warmup=2)
            device_ms = _graph_ms(run)
            plain_ms = _cuda_ms(lambda: fused.pairs_tables_plain(*args),
                                reps=1, warmup=1)
            spans = w_np.astype(np.float32)
            prep_ms = _cuda_ms(lambda: fused.pairs_tables(y, x, spans),
                               reps=5, warmup=1)
            bound = roofline.pairs_tables_bound(N, W, T)
            split = _launch_split(run)
            records["pairs_tables"] = {
                "name": "pairs_tables", "route": "cuda",
                "source": f"{PKG}/csrc/pairs_tables.cu",
                "replaces": f"{REF}:1482", "ms": ms, "device_ms": device_ms,
                "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None,
                "torch_prep_ms": prep_ms, "launch_us": split}
            print(f"pairs_tables {label}: kernel {ms:.4f} ms (device "
                  f"{device_ms:.4f}; by launch, us: " + ", ".join(
                      f"{k} {v:.1f}" for k, v in split.items()) +
                  f"), plain {plain_ms:.4f} ms, torch prep (pairs_tables) "
                  f"{prep_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    for name, rec in records.items():
        rec["max_abs_err"] = max(errs[name])
    return records


# --- the main paths -------------------------------------------------------

def _jobs(pb, data, strategy, axes, panels, cost=COST):
    """One JobSpec per row of ``panels``: an OHLCV panel, and for pairs
    the second leg's panel too (``ohlcv2``)."""
    grid = {k: pb.GridAxis(values=[float(v) for v in vals])
            for k, vals in axes.items()}
    legs = ("ohlcv", "ohlcv2")
    return [pb.JobSpec(
        id=f"{strategy}-{i:04d}", strategy=strategy, grid=grid, cost=cost,
        periods_per_year=252,
        **{leg: data.to_wire_bytes(data.OHLCV(*(f[i] for f in panel)))
           for leg, panel in zip(legs, panels)})
        for i in range(panels[0].close.shape[0])]


def _jobs_from_panel(pb, data, panel):
    return _jobs(pb, data, "sma_crossover",
                 {"fast": FAST_AXIS, "slow": SLOW_AXIS}, (panel,))


def _panels(data, strategy, n, seed):
    """The panels of ``n`` jobs: one synthetic OHLCV panel, or for pairs
    the (y, x) legs from ``2 n`` synthetic tickers."""
    if strategy == "pairs":
        return _pairs_legs(data, n, N_BARS, seed)
    return (data.synthetic_ohlcv(n, N_BARS, seed=seed),)


def _route(compute, fused, strategy, axes):
    """The backend's fused route of ``strategy`` as (stack, run): stack
    the decoded legs of a batch's jobs into the sweep's inputs, and run the
    fused sweep on the card."""
    g = _flat_grid(axes)
    if strategy == "pairs":
        def stack(legs):
            return [np.stack([job[i].close for job in legs]) for i in (0, 1)]

        def run(yx):
            return fused.fused_pairs_sweep(*yx, g["lookback"], g["z_entry"],
                                           cost=COST, device="cuda")
        return stack, run
    spec = compute._FUSED_STRATEGIES[strategy]
    return (lambda legs: {f: np.stack([getattr(job[0], f) for job in legs])
                          for f in spec.fields},
            lambda fields: spec.run(fields, g, cost=COST,
                                    periods_per_year=252, device="cuda"))


def _main_path_stages(jobs, data, wire, compute, strategy, stack,
                      run) -> None:
    """One batch's host stages timed apart, in the backend's order: DBX1
    decode of every leg, stacking (``stack``), the fused sweep with its
    host<->device copies and torch prep (``run``), and DBXM packing."""
    t = [time.perf_counter()]
    legs = [[data.from_wire_bytes(b) for b in (j.ohlcv, j.ohlcv2) if b]
            for j in jobs]
    t.append(time.perf_counter())
    inputs = stack(legs)
    t.append(time.perf_counter())
    host = torch.stack(list(run(inputs))).cpu().numpy()
    t.append(time.perf_counter())
    for i in range(len(jobs)):
        wire.metrics_to_bytes(compute.Metrics(*host[:, i]))
    t.append(time.perf_counter())
    names = ("decode", "stack", "sweep+copies", "pack")
    print(f"{strategy} main path stages (s): " + ", ".join(
        f"{n} {b - a:.4f}" for n, a, b in zip(names, t, t[1:])))


def _drive(kernels_mod, backend, wire, jobs, n_combos, entry, label):
    """One full-width batch with the launch counts reset just before it;
    returns (launch counts, seconds)."""
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    done = backend.process(jobs)
    batch_s = time.perf_counter() - t0
    launches = dict(kernels_mod.LAUNCHES)
    print(f"{label} main path launches {launches}")
    _check(launches.get(entry, 0) > 0,
           f"the {label} main path launched {entry} no time")
    _check(len(done) == len(jobs), f"{label}: {len(done)} completions for "
           f"{len(jobs)} jobs")
    by_id = {c.job_id: wire.metrics_from_bytes(c.metrics) for c in done}
    _check(set(by_id) == {j.id for j in jobs}, f"{label}: completion ids "
           "differ")
    for jid, m in by_id.items():
        for f in m:
            _check(f.shape == (n_combos,), f"{jid}: shape {f.shape}")
        _check(bool(np.isfinite(m.sharpe).all()), f"{jid}: sharpe not finite")
    return launches, batch_s


def _repeat(backend, jobs, n_combos, label, batch_s, reps) -> None:
    # Host time of one batch varies between identical calls (the card's
    # host shares its cores), so report min and median.
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        backend.process(jobs)
        times.append(time.perf_counter() - t0)
    med, best = statistics.median(times), min(times)
    n_bt = len(jobs) * n_combos
    print(f"{label} main path: {len(jobs)} jobs x {n_combos} combos, first "
          f"batch {batch_s:.4f} s; {reps} more: min {best:.4f} s "
          f"({n_bt / best:.1f} backtests/s), median {med:.4f} s "
          f"({n_bt / med:.1f} backtests/s), max {max(times):.4f} s")


def phase_main_path(kernels_mod, compute, wire, pb, data, sweep, models,
                    fused):
    jobs = _jobs_from_panel(
        pb, data, data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7))
    backend = compute.TorchSweepBackend(device="cuda")
    n_combos = FAST_AXIS.size * SLOW_AXIS.size
    launches, batch_s = _drive(kernels_mod, backend, wire, jobs, n_combos,
                               "fused_sma", "sma_crossover")

    # The golden path (the port's generic sweep, independent code) on a
    # small batch through the same backend. Closes are on a 1/32 tick grid
    # so every cumsum is exact in f32 whatever its association: both paths
    # then take identical positions, and the metrics may differ only by
    # the order of their sums.
    k = 16
    small = data.synthetic_ohlcv(k, N_BARS, seed=11)
    small = data.OHLCV(*(np.round(f * 32) / np.float32(32) for f in small))
    _check(float(small.close.sum(axis=1).max()) * 32 < 2 ** 24,
           "tick-grid closes too large for an exact f32 cumsum")
    gjobs = _jobs_from_panel(pb, data, small)
    gdone = {c.job_id: wire.metrics_from_bytes(c.metrics)
             for c in backend.process(gjobs)}
    grid = sweep.product_grid(fast=FAST_AXIS, slow=SLOW_AXIS)
    gold = sweep.run_sweep(small, models.get_strategy("sma_crossover"), grid,
                           cost=COST, device="cuda")
    for name in gold._fields:
        a = np.stack([getattr(gdone[j.id], name) for j in gjobs])
        b = getattr(gold, name).cpu().numpy()
        bad = np.abs(a - b) > ATOL + RTOL * np.abs(b)
        _check(not bad.any(), f"main path vs golden path: {name} off in "
               f"{int(bad.sum())} cells, max abs err "
               f"{float(np.abs(a - b).max())}")
    print(f"main path vs golden path: {k} jobs x {n_combos} combos agree")

    _repeat(backend, jobs, n_combos, "sma_crossover", batch_s, 10)
    _main_path_stages(jobs, data, wire, compute, "sma_crossover",
                      *_route(compute, fused, "sma_crossover",
                              {"fast": FAST_AXIS, "slow": SLOW_AXIS}))
    return launches


def _cagr_slack(gold, n_bars: int = N_BARS, rtol: float = RTOL,
                atol: float = ATOL) -> np.ndarray:
    """What cagr may carry of its final equity's error: cagr =
    eq ** (1 / years) - 1 multiplies an error in eq by
    eq ** (1 / years - 1) / years, which grows as eq -> 0, and the two
    paths sum the equity in other orders. The equity error allowed is
    total_return's own tolerance (``rtol``, ``atol``) over ``n_bars``. The
    slack is capped at the flip rule's own bound (0.01 + 0.01 |cagr|), so
    cagr stays checked where the final equity nears 0."""
    tr = np.asarray(gold.total_return.cpu().numpy())
    cagr = np.asarray(gold.cagr.cpu().numpy())
    eq = np.maximum(1.0 + tr, 1e-12)
    years = n_bars / 252
    slack = eq ** (1.0 / years - 1.0) / years * (atol + rtol * np.abs(tr))
    return np.minimum(slack, 0.01 + 0.01 * np.abs(cagr))


def _tolerance(check: str):
    return (SHIFT_RTOL, SHIFT_ATOL) if check == "shift" else (RTOL, ATOL)


def _flipped(got, gold, check: str, slack) -> np.ndarray:
    """The cells of a ``"flip"`` or ``"shift"`` check that count as
    flipped: for ``"flip"``, off by more than 0.01 + 0.01 |ref|; for
    ``"shift"``, by more than the flip-aware budget's rtol and atol."""
    rtol, atol = _tolerance(check)
    flipped = np.zeros(got["turnover"].shape, dtype=bool)
    for name in gold._fields:
        a, b = got[name], getattr(gold, name).cpu().numpy()
        if check == "flip":
            off = 0.01 + 0.01 * np.abs(b)
        else:
            off = atol + rtol * np.abs(b)
        flipped |= np.abs(a - b) > off + slack[name]
    return flipped


def _slack(gold) -> dict:
    """Each metric's slack beyond its tolerance: cagr's
    (:func:`_cagr_slack`), 0 for the rest."""
    slack = {name: 0.0 for name in gold._fields}
    slack["cagr"] = _cagr_slack(gold)
    return slack


def _golden_check(label, got, gold, check: str) -> int:
    """Backend metrics against the generic sweep's; returns the number of
    flipped cells. ``check`` is a ``FAMILIES`` check: for ``"exact"``,
    n_trades and turnover must be bit-equal and no cell may be set aside
    as flipped; for ``"flip"`` and ``"shift"``, at most max(1, 1%) of the
    cells may flip (:func:`_flipped`)."""
    fields = gold._fields
    slack = _slack(gold)
    rtol, atol = _tolerance(check)
    flipped = np.zeros(got["turnover"].shape, dtype=bool)
    if check == "exact":
        for name in ("n_trades", "turnover"):
            _check(np.array_equal(got[name], getattr(gold, name).cpu()
                                  .numpy()),
                   f"{label} vs golden path: {name} differs: positions are "
                   "not identical")
    else:
        flipped = _flipped(got, gold, check, slack)
    n_flips = int(flipped.sum())
    _check(n_flips <= max(1, int(0.01 * flipped.size)),
           f"{label} vs golden path: {n_flips}/{flipped.size} flips")
    for name in fields:
        a, b = got[name], getattr(gold, name).cpu().numpy()
        bad = (np.abs(a - b) > atol + rtol * np.abs(b) + slack[name]) \
            & ~flipped
        _check(not bad.any(), f"{label} vs golden path: {name} off in "
               f"{int(bad.sum())} unflipped cells, max abs err "
               f"{float(np.abs(a - b)[~flipped].max())}")
    return n_flips


def _report_golden(label, got, gold, check, n_combos) -> None:
    n_flips = _golden_check(label, got, gold, check)
    rule = {"exact": "identical positions", "flip": "flip rule",
            "shift": "flip-aware budget"}[check]
    same = all(np.array_equal(got[name], getattr(gold, name).cpu().numpy())
               for name in ("n_trades", "turnover"))
    print(f"{label} main path vs golden path: 16 jobs x {n_combos} combos "
          f"agree ({rule}, {n_flips} flipped cells; n_trades and turnover "
          f"bit-equal: {same})")


def _gold(sweep, models, strategy, panels, grid):
    """The golden path: the port's generic sweep (for pairs
    ``models.pairs.run_pairs_sweep``) on the card."""
    if strategy == "pairs":
        y, x = panels
        return models.pairs.run_pairs_sweep(y.close, x.close, grid,
                                            cost=COST, device="cuda")
    return sweep.run_sweep(panels[0], models.get_strategy(strategy), grid,
                           cost=COST, device="cuda")


def _gold_f64(sweep, models, panels, grid):
    """The generic pairs sweep (``models.pairs.pair_backtest``) on the card
    with its legs in f64, so every sum and quotient of its tables is f64:
    the witness pairs' fused path is held to."""
    y, x = (torch.as_tensor(leg.close, dtype=torch.float64,
                            device="cuda")[:, None, :] for leg in panels)
    return sweep.map_param_chunks(
        grid, y.shape[0] * y.shape[-1], torch.device("cuda"),
        lambda sub: models.pairs.pair_backtest(y, x, sub, cost=COST))


def _gold_same_order(sweep, models, strategy, panels, axes, fields):
    """The golden path run one value of ``SAME_ORDER_AXIS[strategy]`` at a
    time, put back in the grid's order: its (tickers, combos, bars) tensors
    then have the fused path's row count, so torch sums their rows in the
    fused path's order."""
    flat = _flat_grid(axes)
    split = flat[SAME_ORDER_AXIS[strategy]]
    n = panels[0].close.shape[0]
    out = {name: np.empty((n, split.size), np.float32) for name in fields}
    for v in np.unique(split):
        sel = split == v
        m = _gold(sweep, models, strategy, panels,
                  {k: a[sel] for k, a in flat.items()})
        for name in fields:
            out[name][:, sel] = getattr(m, name).cpu().numpy()
    return out


# The sweeps whose channel the kernel builds: no (N, W, T) table on the card.
NO_TABLE = ("stochastic", "donchian", "donchian_hl")


def _check_no_table(jobs, data, strategy, axes, stack, run) -> None:
    """One batch's fused sweep on the card with its peak allocation above
    what was allocated before it: it must stay below one int8 (N, W, T)
    table of the batch's distinct windows (the smallest table the sweep
    once built)."""
    inputs = stack([[data.from_wire_bytes(j.ohlcv)] for j in jobs])
    N, T = inputs["close"].shape
    W = np.unique(axes["window"]).size
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m = run(inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del m
    table = N * W * T
    print(f"{strategy} sweep peak allocation {peak} bytes; an int8 "
          f"(N, W, T) table is {table} bytes")
    _check(peak < table, f"{strategy}: the sweep allocated {peak} bytes, "
           f"as much as an (N, W, T) table ({table})")


def _check_pairs_tables_only(jobs, data, axes, stack, run) -> None:
    """One batch's pairs sweep on the card with its peak allocation above
    what was allocated before it: below three (N, W, T) f32 tables, z and hr
    and less than one more (the torch prep held about 17)."""
    inputs = stack([[data.from_wire_bytes(b) for b in (j.ohlcv, j.ohlcv2)]
                    for j in jobs])
    N, T = inputs[0].shape
    W = np.unique(axes["lookback"]).size
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m = run(inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del m
    table = 4 * N * W * T
    print(f"pairs sweep peak allocation {peak} bytes; an f32 (N, W, T) "
          f"table is {table} bytes")
    _check(peak < 3 * table, f"pairs: the sweep allocated {peak} bytes, "
           f"more than z, hr and another (N, W, T) table ({3 * table})")


def phase_new_main_paths(kernels_mod, compute, wire, pb, data, sweep,
                         models, fused) -> dict:
    """The main paths of the strategies of ``FAMILIES``; returns the
    launches per kernel entry summed over their runs."""
    backend = compute.TorchSweepBackend(device="cuda")
    total: dict = {}
    for seed, (strategy, (axes, entry, check)) in enumerate(
            FAMILIES.items(), start=20):
        # pairs: bench.py's legs, synthetic_ohlcv(2000, 1260, seed=1).
        n_jobs, main_seed = ((N_PAIRS, 1) if strategy == "pairs"
                             else (N_TICKERS, seed))
        jobs = _jobs(pb, data, strategy, axes,
                     _panels(data, strategy, n_jobs, main_seed))
        n_combos = int(np.prod([v.size for v in axes.values()]))
        launches, batch_s = _drive(kernels_mod, backend, wire, jobs,
                                   n_combos, entry, strategy)
        if strategy in TABLE_KERNELS:
            table = TABLE_KERNELS[strategy]
            _check(launches.get(table, 0) > 0,
                   f"the {strategy} main path launched {table} no time")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

        small = _panels(data, strategy, 16, seed + 100)
        gjobs = _jobs(pb, data, strategy, axes, small)
        gdone = {c.job_id: wire.metrics_from_bytes(c.metrics)
                 for c in backend.process(gjobs)}
        got = {name: np.stack([getattr(gdone[j.id], name) for j in gjobs])
               for name in compute.Metrics._fields}
        grid = sweep.product_grid(**{k: axes[k] for k in sorted(axes)})
        if strategy in F64_WITNESS:
            f32 = _gold(sweep, models, strategy, small, grid)
            gold = _gold_f64(sweep, models, small, grid)
            f32_np = {name: getattr(f32, name).cpu().numpy()
                      for name in f32._fields}
            print(f"{strategy} cells of {got['turnover'].size} off by more "
                  "than the flip-aware budget's tolerance: main path vs "
                  "golden path in f32 "
                  f"{int(_flipped(got, f32, check, _slack(f32)).sum())}, "
                  "golden path in f32 vs in f64 "
                  f"{int(_flipped(f32_np, gold, check, _slack(gold)).sum())}")
            _report_golden(f"{strategy} (golden path in f64)", got, gold,
                           check, n_combos)
        else:
            gold = _gold(sweep, models, strategy, small, grid)
            _report_golden(strategy, got, gold, check, n_combos)
        if strategy in SAME_ORDER_AXIS:
            same = _gold_same_order(sweep, models, strategy, small, axes,
                                    gold._fields)
            _report_golden(f"{strategy} (golden path in the fused path's "
                           "cumsum order)", got, gold._make(
                               torch.from_numpy(same[name])
                               for name in gold._fields), "exact", n_combos)

        _repeat(backend, jobs, n_combos, strategy, batch_s, 5)
        _main_path_stages(jobs, data, wire, compute, strategy,
                          *_route(compute, fused, strategy, axes))
        if strategy in NO_TABLE:
            _check_no_table(jobs, data, strategy, axes,
                            *_route(compute, fused, strategy, axes))
        if strategy == "pairs":
            _check_pairs_tables_only(jobs, data, axes,
                                     *_route(compute, fused, strategy, axes))
    return total


# --- K8: the roofline stage scaffolds and the port bench --------------------

# The TPU kernel each scaffold replaces: bench.py `stage_call` and
# `boll_stage_call`, at their pallas_call's function.
STAGE_REF = {"sma": "bench.py:362", "boll": "bench.py:567"}


def _stage_library_call(stage, inp) -> Callable | None:
    """One PyTorch call computing a stage's function, where there is one:
    touch the tables' sums; matmul the contraction of the table with the
    lanes' one-hot (+1 fast row and -1 slow row for SMA), full f32 (TF32
    off, as the package sets it). None for the later stages."""
    if stage == "touch":
        return lambda: inp.table.sum(dim=(1, 2))
    if stage != "matmul":
        return None
    W, P = inp.table.shape[1], inp.row_a.shape[0]
    onehot = torch.zeros((W, P), dtype=torch.float32,
                         device=inp.table.device)
    lanes = torch.arange(P, device=inp.table.device)
    ones = torch.ones(P, dtype=torch.float32, device=inp.table.device)
    onehot.index_put_((inp.row_a.long(), lanes), ones, accumulate=True)
    if inp.row_b is not None:
        onehot.index_put_((inp.row_b.long(), lanes), -ones, accumulate=True)
    return lambda: torch.einsum("nwt,wp->np", inp.table, onehot)


def _stage_edge_cases(stages, data) -> list:
    """K8's shapes beside the bench's, (label, kind, inputs): about 400
    distinct windows (4-bar blocks at 128 lanes), T shorter than a block
    and no multiple of 4, one ticker, 75 lanes, and a long row."""
    def sma(n, T, seed, n_fast, n_slow):
        close = data.synthetic_ohlcv(n, T, seed=seed).close
        g = roofline.product({
            "fast": np.float32([3, 5, 8, 13][:n_fast]),
            "slow": np.arange(20, 20 + 2 * n_slow, 2, dtype=np.float32)})
        return stages.sma_stage_inputs(close, g["fast"], g["slow"],
                                       device="cuda")

    def boll(n, T, seed, n_k, n_w):
        close = data.synthetic_ohlcv(n, T, seed=seed).close
        g = roofline.product({
            "k": np.linspace(0.5, 3.0, n_k).astype(np.float32),
            "window": np.arange(5, 5 + 2 * n_w, 2, dtype=np.float32)})
        return stages.boll_stage_inputs(close, g["window"], g["k"],
                                        device="cuda")

    shapes = (("wide 2x251, 400 windows", (2, 251, 3, 4, 396),
               (2, 251, 3, 15, 400)),
              ("short 3x37", (3, 37, 4, 4, 24), (3, 37, 4, 4, 6)),
              ("one ticker 1x300", (1, 300, 5, 4, 40), (1, 300, 5, 4, 10)),
              ("75 lanes 2x251", (2, 251, 6, 3, 25), (2, 251, 6, 3, 25)),
              ("long row 1x13000", (1, 13000, 2, 4, 8), (1, 13000, 2, 15, 2)))
    return [case for label, a, b in shapes
            for case in ((label, "sma", sma(*a)), (label, "boll", boll(*b)))]


def _stage_sass(kernels_mod, kind: str) -> dict:
    """SASS instructions a bar of the matmul and full loops of one K8
    entry: full by the metric loop's FMNMX (:func:`_per_bar`), matmul by
    its FADD (a bar's subtraction and sum for SMA, its sum for
    bollinger) in the innermost loop with the most of them."""
    family = {"sma": 0, "boll": 1}[kind]
    matmul = _sass_loops(kernels_mod, "stages",
                         f"stage_kernelILi{family}ELi1EE")
    full = _sass_loops(kernels_mod, "stages",
                       f"stage_kernelILi{family}ELi4EE")
    loop = max(matmul, key=lambda x: (x["fadd"], x["instructions"]))
    _check(loop["fadd"] > 0, f"no matmul loop in the SASS of {kind}")
    return {"matmul": loop["instructions"] / (loop["fadd"] / (2 - family)),
            "full": _per_bar(full)}


def phase_stages(kernels_mod, stages, bench, data) -> list:
    """Every (stage, lanes) case of K8's two entries at the bench's shape
    (SMA 500 x 1260 x 2000, bollinger 500 x 1260 x 1000, on the bench's
    seed-0 panel) against its plain version: every row must be bit-equal
    (same inputs, every operation in the same order). Times through the
    wrapper (device times beside), bound and library call per case; each
    entry's build report, SASS a bar and matmul at every width; then every
    stage at every width on the edge shapes of :func:`_stage_edge_cases`,
    bit-equal. Returns one kernels-line record per bench case."""
    close = torch.as_tensor(data.synthetic_ohlcv(N_TICKERS, N_BARS,
                                                 seed=0).close,
                            device="cuda")
    sg = roofline.product(AXES["sma_crossover"])
    bg = roofline.product(AXES["bollinger"])
    kinds = {
        "sma": (stages.sma_stage_inputs(close, sg["fast"], sg["slow"],
                                        device="cuda"),
                bench.SMA_CASES, stages.sma_stage_cuda,
                stages.sma_stage_plain),
        "boll": (stages.boll_stage_inputs(close, bg["window"], bg["k"],
                                          device="cuda"),
                 bench.BOLL_CASES, stages.boll_stage_cuda,
                 stages.boll_stage_plain)}
    records = []
    for kind, (inp, cases, kernel, plain) in kinds.items():
        N, W, T = inp.table.shape
        refs = {}
        for stage, lanes in cases:
            if stage == "prep":        # the table build: no kernel
                continue
            label = f"{kind}_stage_{stage}_l{lanes}"
            got = kernel(inp, stage=stage, lanes=lanes)
            ref, plain_ms = _once_ms(lambda: plain(inp, stage=stage,
                                                   lanes=lanes))
            refs[stage] = ref
            torch.cuda.synchronize()
            _check(bool(torch.isfinite(got).all()), f"{label}: not finite")
            err = float((got - ref).abs().max())
            _check(bool(torch.equal(got, ref)), f"{label}: differs from its "
                   f"plain version, max abs err {err}")
            ms = _cuda_ms(lambda: kernel(inp, stage=stage, lanes=lanes),
                          reps=20, warmup=2)
            device_ms = _graph_ms(lambda: kernel(inp, stage=stage,
                                                 lanes=lanes))
            bound_ms, bound_by = roofline.stage_bound(
                kind, stage, N=N, T_pad=T, W_pad=W, tr=inp.tr,
                warm=inp.warm.cpu().numpy())
            call = _stage_library_call(stage, inp)
            library_ms, lib = None, "none"
            if call is not None:
                library_ms = _cuda_ms(call, reps=20, warmup=2)
                lib = (f"{library_ms:.4f} ms (device {_graph_ms(call):.4f} "
                       "ms)")
            print(f"k8 {label} {N}x{T}x{W}x{inp.row_a.shape[0]}: kernel "
                  f"{ms:.4f} ms (device {device_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}), library {lib}, max abs "
                  f"err {err:.3e}")
            records.append({
                "name": label, "route": "cuda",
                "source": f"{PKG}/csrc/stages.cu",
                "replaces": STAGE_REF[kind], "max_abs_err": err, "ms": ms,
                "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms})
        report = {stage: stages.stage_occupancy(kind, inp, stage=stage)
                  for stage in ("touch", "matmul", "signal", "no_ladders",
                                "full")}
        print(f"k8 {kind} build report (128 lanes): {report}")
        print(f"k8 {kind} SASS a bar: {_stage_sass(kernels_mod, kind)}")
        # Every CTA stages its ticker's whole table: wider CTAs take in
        # less of it a lane.
        widths = {}
        for lanes in stages.LANES:
            _check(bool(torch.equal(kernel(inp, stage="matmul", lanes=lanes),
                                    refs["matmul"])),
                   f"{kind} matmul at {lanes} lanes differs from its plain "
                   "version")
            widths[lanes] = _cuda_ms(lambda: kernel(inp, stage="matmul",
                                                    lanes=lanes),
                                     reps=20, warmup=2)
        print(f"k8 {kind}_stage_matmul width sweep (ms by lanes a CTA): "
              + ", ".join(f"{n} {t:.4f}" for n, t in widths.items()))
    for label, kind, inp in _stage_edge_cases(stages, data):
        kernel, plain = {"sma": (stages.sma_stage_cuda,
                                 stages.sma_stage_plain),
                         "boll": (stages.boll_stage_cuda,
                                  stages.boll_stage_plain)}[kind]
        all_stages = (stages.SMA_STAGES if kind == "sma" else
                      stages.BOLL_STAGES)[1:]
        for stage in all_stages:
            ref = plain(inp, stage=stage)
            for lanes in stages.LANES:
                got = kernel(inp, stage=stage, lanes=lanes)
                torch.cuda.synchronize()
                _check(bool(torch.equal(got, ref)), f"k8 {kind} {stage} at "
                       f"{lanes} lanes on {label} differs from its plain "
                       "version")
        print(f"k8 {kind} {label} (table {tuple(inp.table.shape)}, "
              f"{inp.row_a.shape[0]} lanes): every stage at every width "
              "bit-equal")
    return records


def phase_bench(kernels_mod, bench, records) -> None:
    """K8's main path: the port bench in-process on its configs (fewer
    iterations than its default), with the launch counts reset just before
    it; every K8 case must have launched. Prints the bench's JSON line."""
    kernels_mod.reset_launch_counts()
    # Every config but autotune, whose halves phase 10 runs, and the
    # control-plane keys of CONTROL_CONFIGS, which run no kernel (phase 13
    # runs pipeline and queue_machine), and e2e_local, fleet_telemetry and
    # flight on a third of their jobs: the script's time limit.
    skip = ("autotune", *bench.CONTROL_CONFIGS)
    result = bench.run(bench.Settings(
        iters=3, warmup=1, local_jobs=500, fleet_jobs=200,
        configs=frozenset(c for c in bench.CONFIGS if c not in skip)))
    launches = dict(kernels_mod.LAUNCHES)
    print(json.dumps(result))
    print(f"bench launches {launches}")
    for name in (*bench.FUSED, "roofline_stages_full",
                 "roofline_stages_boll_full", "walkforward"):
        _check(result["configs"].get(name, 0) > 0, f"bench: {name} gave "
               "no rate")
    for rec in records:
        rec["launches"] = launches.get(rec["name"], 0)
        _check(rec["launches"] > 0, f"{rec['name']} launched no time in the "
               "bench")


# --- the worker path: top-k, best-returns, digest-only, the pipeline -------

TOP_K = 16


def _with(jobs, **fields) -> list:
    """Copies of ``jobs`` with ``fields`` set."""
    out = []
    for j in jobs:
        c = type(j)()
        c.CopyFrom(j)
        for k, v in fields.items():
            setattr(c, k, v)
        out.append(c)
    return out


def _total_order_topk(values: np.ndarray, sign: float, k: int) -> np.ndarray:
    """The reference's ``lax.top_k`` selection in numpy: ``sign * values``
    with NaN as -inf, ranked by the floats' total order (+0 ahead of -0),
    the lower index first among equal keys."""
    score = (values * np.float32(sign)).astype(np.float32)
    score[np.isnan(score)] = -np.inf
    bits = score.view(np.int32)
    key = np.where(bits < 0, bits ^ np.int32(0x7FFFFFFF), bits)
    return np.argsort(-key.astype(np.int64), axis=-1, kind="stable")[..., :k]


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _submit_collect(backend, jobs) -> tuple[list, float]:
    t0 = time.perf_counter()
    done = backend.collect(backend.submit(jobs))
    return done, time.perf_counter() - t0


def _secs(label: str, secs: list) -> str:
    return (f"{label} median {statistics.median(secs):.4f} s (runs "
            f"{', '.join(f'{x:.4f}' for x in secs)})")


def _check_topk(wire, label, jobs, done, full, metric, sign) -> None:
    """Each DBXS block against its job's full DBXM matrix: the indices of
    the numpy total-order rank, the rows bit-equal to the matrix's."""
    _check(len(done) == len(jobs), f"{label}: {len(done)} completions")
    for c in done:
        idx, rows, name = wire.topk_from_bytes(c.metrics)
        whole = full[c.job_id]
        want = _total_order_topk(getattr(whole, metric), sign, TOP_K)
        _check(name == metric and np.array_equal(idx, want),
               f"{label} {c.job_id}: indices {idx} != {want}")
        for f in whole._fields:
            _check(np.array_equal(_u32(getattr(rows, f)),
                                  _u32(getattr(whole, f)[idx])),
                   f"{label} {c.job_id}: {f} rows not bit-equal")


def phase_worker_path(kernels_mod, compute, executor, wire, pb, data,
                      sweep, models, fused, pnl, panel_store) -> None:
    """Top-k, best-returns and digest-only jobs and the pipelined executor
    at the bench's widths, through ``submit``/``collect``; the top-k run
    is this phase's main path (K1 and K7 must launch); then a host profile
    of one ``process`` call."""
    import cProfile
    import pstats

    import worker_rate
    from distributed_backtesting_exploration_tpu_torch.ops.metrics import (
        metric_sign)

    backend = compute.TorchSweepBackend(device="cuda")
    sma = _jobs_from_panel(pb, data,
                           data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7))
    pairs = _jobs(pb, data, "pairs", AXES["pairs"],
                  _pairs_legs(data, N_PAIRS, N_BARS, 1))
    full = {c.job_id: wire.metrics_from_bytes(c.metrics)
            for c in backend.process(sma + pairs)}

    kernels_mod.reset_launch_counts()
    topk_s, blocks = {}, {}
    for label, base, metric in (("sma sharpe", sma, "sharpe"),
                                ("sma max_drawdown", sma, "max_drawdown"),
                                ("pairs sharpe", pairs, "sharpe")):
        jobs = _with(base, top_k=TOP_K, rank_metric=metric)
        done, topk_s[label] = _submit_collect(backend, jobs)
        _check_topk(wire, f"top-k {label}", jobs, done, full, metric,
                    metric_sign(metric))
        blocks[label] = (len(done[0].metrics),
                         len(wire.metrics_to_bytes(full[base[0].id])))
    launches = dict(kernels_mod.LAUNCHES)
    print(f"top-k main path launches {launches}")
    for entry in ("fused_sma", "pairs", "pairs_tables"):
        _check(launches.get(entry, 0) > 0,
               f"the top-k main path launched {entry} no time")
    print(f"top-k, k={TOP_K}, {len(sma)} sma jobs x "
          f"{FAST_AXIS.size * SLOW_AXIS.size} combos and {len(pairs)} pairs "
          f"jobs x {wire.grid_n_combos(pairs[0].grid)}: every index that of "
          "the numpy total order, every row bit-equal; first batch s "
          + ", ".join(f"{k} {v:.4f}" for k, v in topk_s.items()))
    # Batch times on the host's clock vary between identical calls: five
    # more of each, beside five of the same jobs' full blocks.
    for label, base, fields in (
            ("sma full", sma, {}),
            ("sma top-k sharpe", sma, {"top_k": TOP_K}),
            ("pairs full", pairs, {}),
            ("pairs top-k sharpe", pairs, {"top_k": TOP_K})):
        jobs = _with(base, **fields)
        print("batch " + _secs(label, [_submit_collect(backend, jobs)[1]
                                       for _ in range(5)]))
    print("bytes a job, DBXS vs DBXM: " + ", ".join(
        f"{k} {s} vs {m}" for k, (s, m) in blocks.items()))
    stack, run = _route(compute, fused, "sma_crossover",
                        {"fast": FAST_AXIS, "slow": SLOW_AXIS})
    m = run(stack([(data.from_wire_bytes(j.ohlcv),) for j in sma]))
    for metric in ("sharpe", "max_drawdown"):
        k = min(TOP_K, m.sharpe.shape[1])
        ms = _cuda_ms(lambda: compute._topk_reduce(m, metric, k), 20)
        print(f"top-k reduce {metric} at {tuple(m.sharpe.shape)}, k={k}: "
              f"{ms:.4f} ms")

    # Best-returns: closes on a 1/32 tick grid, so every cumsum is exact
    # and a ticker repriced alone gives the group's bits.
    k = 64
    small = data.synthetic_ohlcv(k, N_BARS, seed=11)
    small = data.OHLCV(*(np.round(f * 32) / np.float32(32) for f in small))
    _check(float(small.close.sum(axis=1).max()) * 32 < 2 ** 24,
           "tick-grid closes too large for an exact f32 cumsum")
    bjobs = _with(_jobs_from_panel(pb, data, small), best_returns=True,
                  rank_metric="sharpe")
    done, best_s = _submit_collect(backend, bjobs)
    best_more = [_submit_collect(backend, bjobs)[1] for _ in range(3)]
    _check(len(done) == k, f"best-returns: {len(done)} completions")
    series = [data.from_wire_bytes(j.ohlcv) for j in bjobs]
    batch, _, mask = data.pad_and_stack(series)
    grid = sweep.product_grid(fast=FAST_AXIS, slow=SLOW_AXIS)
    strategy = models.get_strategy("sma_crossover")
    gm = sweep.run_sweep(batch, strategy, grid, cost=COST, bar_mask=mask,
                         device="cuda")
    _, _, gidx = sweep.best_params(gm.sharpe, grid, metric="sharpe",
                                   return_index=True)
    gidx = gidx.cpu().numpy()
    gm = {f: getattr(gm, f).cpu().numpy() for f in gm._fields}
    for i, c in enumerate(done):
        g, row, ret, _ = wire.best_returns_from_bytes(c.metrics)
        _check(g == int(gidx[i]), f"best-returns {c.job_id}: index {g} != "
               f"best_params {gidx[i]}")
        _check(np.array_equal(_u32([float(x) for x in row]),
                              _u32([gm[f][i, g] for f in gm])),
               f"best-returns {c.job_id}: row not bit-equal")
        one = series[i]
        fields = data.OHLCV(*(torch.tensor(f, device=backend.device)[
            None, None, :] for f in one))
        params = {n: torch.tensor([[float(v[g])]], device=backend.device)
                  for n, v in grid.items()}
        plain = pnl.backtest_prefix(fields.close,
                                    strategy.positions(fields, params),
                                    cost=COST).returns[0, 0].cpu().numpy()
        _check(ret.shape == (one.n_bars,) and np.array_equal(
            _u32(ret), _u32(plain)), f"best-returns {c.job_id}: returns "
            "not bit-equal to a plain repricing")
    print(f"best-returns: {k} sma jobs x {grid['fast'].numel()} combos, "
          f"first group {best_s:.4f} s, "
          + _secs("three more", best_more)
          + "; every index, row and series bit-equal")

    # Digest-only: the same jobs inline, then by digest alone.
    djobs = _jobs_from_panel(pb, data,
                             data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=13))
    for j in djobs:
        j.panel_digest = panel_store.panel_digest(j.ohlcv)
        j.panel_bytes_len = len(j.ohlcv)
    only = _with(djobs, ohlcv=b"")
    inline = None
    miss_s, host_s = [], []
    reps = 10
    for _ in range(reps):
        # A miss: a fresh cache. A host hit: a fresh cache whose host
        # level the prefetch filled (untimed); its device level is empty.
        done, s = _submit_collect(compute.TorchSweepBackend(device="cuda"),
                                  djobs)
        miss_s.append(s)
        inline = inline or [c.metrics for c in done]
        host = compute.TorchSweepBackend(device="cuda")
        _check(host.prefetch(djobs) == len(djobs), "prefetch decoded too few")
        done, s = _submit_collect(host, only)
        host_s.append(s)
        st = host.panel_cache.stats()
        _check(host.decodes == 0 and st["misses"]["device"] == len(djobs)
               and [c.metrics for c in done] == inline,
               f"host-hit batch decoded, hit the device level or differs: "
               f"{st}")
    cached = host
    decodes, st0 = cached.decodes, cached.panel_cache.stats()
    dev_s = []
    for _ in range(reps):
        again, s = _submit_collect(cached, only)
        dev_s.append(s)
        _check([c.metrics for c in again] == inline,
               "digest-only blocks differ from the inline batch's")
    st1 = cached.panel_cache.stats()
    _check(cached.decodes == decodes, "digest-only batch decoded")
    _check(st1["hits"]["device"] - st0["hits"]["device"] == reps * len(djobs)
           and st1["misses"]["device"] == st0["misses"]["device"],
           f"digest-only batch missed the device level: {st0} -> {st1}")
    # The device level's bytes on the card: a cache with room for half the
    # panels, filled by one batch of misses (one upload), keeps alive only
    # the blocks it charges.
    half = compute.PanelCache(max_bytes=len(djobs) // 2 * 5 * N_BARS * 4)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    compute.TorchSweepBackend(device="cuda", panel_cache=half).process(djobs)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    st = half.stats()
    held = {b.untyped_storage().data_ptr(): b.untyped_storage().nbytes()
            for b, _ in half._device._entries.values()}
    _check(0 < st["device_panels"] < len(djobs)
           and sum(held.values()) == st["device_bytes"],
           f"the device level holds {sum(held.values())} bytes on the card "
           f"and charges {st['device_bytes']} ({st['device_panels']} "
           "panels)")
    print(f"device level after a partial eviction: {st['device_panels']} of "
          f"{len(djobs)} panels, {sum(held.values())} bytes held = "
          f"{st['device_bytes']} charged; allocated on the card "
          f"+{grown} bytes")
    try:
        cached.process(_with(djobs[:1], ohlcv=b"", panel_digest="0" * 32))
        _fail("a digest neither cached nor fetchable did not raise")
    except ValueError as e:
        print(f"unfetchable digest raised: {e}")
    print(f"digest-only, {len(djobs)} sma jobs: "
          + _secs("inline (cache miss)", miss_s) + "; "
          + _secs("host hit", host_s) + "; " + _secs("device hit", dev_s)
          + "; no decode on a hit, the same bytes")

    # The pipeline: process against the executor at depth 2 (worker_rate).
    batches = worker_rate.sma_batches(pb, data, roofline, 8, N_TICKERS)
    runs = worker_rate.measure(compute, executor, batches, reps=5)
    n_bt = 8 * N_TICKERS * FAST_AXIS.size * SLOW_AXIS.size
    for mode, secs in runs.items():
        med = statistics.median(secs)
        print(f"pipeline {mode}: 8 batches of {N_TICKERS} jobs, runs "
              f"{[round(x, 4) for x in secs]} s, median {8 / med:.2f} "
              f"batches/s ({n_bt / med:.1f} backtests/s)")
    print("pipeline: depth-2 blocks identical to process's")

    # Host profile of one process call.
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(backend.process, sma)
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    print(f"host profile of one process call ({len(sma)} sma jobs, "
          f"{wall:.4f} s under cProfile), top frames by own time:")
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]
    for (path, line, func), (_, ncalls, tottime, cumtime, _) in rows:
        print(f"  {tottime:.4f} s own, {cumtime:.4f} s total, {ncalls} "
              f"calls: {Path(path).name}:{line} {func}")


# --- walk-forward, portfolio composition and checkpoints ------------------

# The reference bench's walk-forward settings (bench.py configs[4]): the
# bars' second half less 30 as the train span, 12 refit windows.
WF_TRAIN = N_BARS // 2 - 30                           # 600
WF_TEST = (N_BARS - WF_TRAIN) // 12                   # 55
WF_WINDOWS = (N_BARS - WF_TRAIN) // WF_TEST           # 12
WF_KW = {"train": WF_TRAIN, "test": WF_TEST, "cost": COST}
# The cost a JobSpec carries (a proto float), for runs held bit-equal to
# the backend's blocks.
JOB_COST = float(np.float32(COST))
# The flip-aware rule of the reference's walk-forward wire tests
# (tests/test_walkforward_fused_wire.py), and the jobs of 16 that may flip.
WF_RTOL, WF_ATOL, WF_MAX_FLIPS = 2e-3, 2e-4, 2
# The pairs walk-forward jobs (the first quarter of phase 4's 1000 pairs,
# which keeps the script inside its time), and how many may flip against
# the f64 refit: at the bench shape no f32 pairs path
# meets the 2-of-16 budget (on the H100 138 of 1000 flipped, and 76 of
# the first 500 in three runs), so this bound, a fifth of the jobs (50),
# catches a regression, not the f32 drift.
WF_PAIRS = 250
PAIRS_F64_MAX_FLIPS = WF_PAIRS // 5
# Each kernel entry's dispatch (ops/fused.py) and its plain version.
PLAIN = {"fused_sma": "fused_sma_plain", "obv": "obv_plain",
         "band_inline": "band_inline_plain",
         "band_table": "band_machine_plain",
         "band_stoch": "band_stoch_plain", "momentum": "momentum_plain",
         "donchian": "donchian_plain", "macd": "macd_plain",
         "trix": "trix_plain", "pairs": "pairs_plain"}


@contextlib.contextmanager
def _plain_entries(fused):
    """Every kernel entry's dispatch bound to its plain version, so a sweep
    runs the plain versions on the card's tensors. The tables still come
    from their kernels, which phase 3 holds bit-equal to theirs."""
    saved = {name: getattr(fused, name) for name in PLAIN}

    def as_entry(plain):
        # The tile entries' CTA width (``lanes``) has no plain counterpart.
        return lambda *args, lanes=None, **kw: plain(*args, **kw)

    try:
        for name, plain in PLAIN.items():
            setattr(fused, name, as_entry(getattr(fused, plain)))
        yield
    finally:
        for name, fn in saved.items():
            setattr(fused, name, fn)


def _wf_jobs(pb, data, strategy, axes, panels) -> list:
    return _with(_jobs(pb, data, strategy, axes, panels), wf_train=WF_TRAIN,
                 wf_test=WF_TEST, wf_metric="sharpe")


def _oos_rows(wire, done, jobs) -> dict:
    """Each job's one stitched row, as a (jobs,) array a metric."""
    by_id = {c.job_id: wire.metrics_from_bytes(c.metrics) for c in done}
    _check(set(by_id) == {j.id for j in jobs},
           "walk-forward: completion ids differ")
    for jid, m in by_id.items():
        _check(all(f.shape == (1,) for f in m), f"{jid}: not one row")
    return {name: np.concatenate([getattr(by_id[j.id], name) for j in jobs])
            for name in wire.Metrics._fields}


def _wf_flips(label, got: dict, gold) -> int:
    """``got`` against ``gold`` (Metrics of (jobs,) tensors) under the
    flip-aware rule: a job whose sharpe is off by more than 0.01 + 1% is
    flipped, and every metric of the others agrees at WF_RTOL, WF_ATOL
    (cagr within :func:`_cagr_slack` more); NaN must meet NaN. Returns the
    flipped jobs' count."""
    ref = {name: getattr(gold, name).cpu().numpy() for name in gold._fields}
    flipped = (np.abs(got["sharpe"] - ref["sharpe"])
               > 0.01 + 0.01 * np.abs(ref["sharpe"]))
    slack = dict.fromkeys(ref, 0.0)
    slack["cagr"] = _cagr_slack(gold, WF_WINDOWS * WF_TEST, WF_RTOL, WF_ATOL)
    for name, b in ref.items():
        a = got[name]
        bad = ((np.abs(a - b) > WF_ATOL + WF_RTOL * np.abs(b) + slack[name])
               | (np.isnan(a) != np.isnan(b))) & ~flipped
        _check(not bad.any(), f"{label}: {name} off in {int(bad.sum())} "
               f"unflipped jobs, max abs err "
               f"{float(np.nanmax(np.abs(a - b)[~flipped], initial=0.0))}")
    return int(flipped.sum())


# Train metrics with NaN, ties, +-0 and +-inf for the refit's argmax rule.
WF_CRAFTED = np.float32([
    [-0., 0., 1., 1., -np.inf, 0., -0., -np.inf],
    [np.nan, 2., np.nan, -np.inf, np.inf, 2., -0., 0.],
    [3., 3., 3., 3., 3., 3., 3., 3.],
    [-1., -0., -2., 0., -1., -0., 0., -2.],
    [1., 2., 3., np.nan, 3., 2., 1., np.nan],
])


def _wf_argmax_rule(walkforward, sweep, dev) -> None:
    """The refit's argmax on the card, whole and across param chunks of
    every size: numpy's argmax, which is jnp.argmax's rule (the first NaN
    wins; among equal values the first index)."""
    rows = torch.as_tensor(WF_CRAFTED, device=dev)
    n, P = rows.shape
    grid = {"x": np.arange(P, dtype=np.float32)}
    saved = sweep._CHUNK_ELEMS
    try:
        for sign in (1.0, -1.0):
            want = np.argmax(sign * WF_CRAFTED, axis=-1)
            got = walkforward.argmax_nan_first(sign * rows).cpu().numpy()
            _check(np.array_equal(got, want), f"argmax rule: {got} != {want}")
            for chunk in (1, 3, P):
                sweep._CHUNK_ELEMS = chunk
                _, idx = walkforward._refit(
                    grid, 1, dev, sign,
                    lambda sub: (rows[:, sub["x"][:, 0].long()],))
                _check(np.array_equal(idx.cpu().numpy(), want),
                       f"argmax rule across chunks of {chunk}: "
                       f"{idx.cpu().numpy()} != {want}")
    finally:
        sweep._CHUNK_ELEMS = saved
    print("walk-forward argmax on the card: numpy's (jnp.argmax's) rule on "
          "crafted rows, whole and across chunks of 1, 3 and 8")


def _median_s(run, reps: int = 5) -> float:
    """Median host seconds of ``reps`` calls of ``run`` after one warm-up,
    each synchronized."""
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _wf_family(kernels_mod, backend, wire, pb, data, models, fused,
               walkforward, compute, strategy, axes, entry, seed):
    """One family's walk-forward main path, its kernel against its plain
    version on the stacked train windows, and 16 jobs against the generic
    refit; returns (launches, first batch s, median of 3 more)."""
    n_combos = int(np.prod([v.size for v in axes.values()]))
    _check(n_combos >= backend._WF_FUSED_MIN_COMBOS,
           f"{strategy}: {n_combos} combos stay below the fused-train route")
    panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=seed)
    jobs = _wf_jobs(pb, data, strategy, axes, (panel,))
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    done = backend.process(jobs)
    first = time.perf_counter() - t0
    launches = dict(kernels_mod.LAUNCHES)
    print(f"{strategy} walk-forward main path launches {launches}")
    _check(launches.get(entry, 0) > 0,
           f"the {strategy} walk-forward main path launched {entry} no time")
    if strategy in TABLE_KERNELS:
        _check(launches.get(TABLE_KERNELS[strategy], 0) > 0,
               f"the {strategy} walk-forward main path launched its table "
               "kernel no time")
    rows = _oos_rows(wire, done, jobs)
    _check(bool(np.isfinite(rows["sharpe"]).all()),
           f"{strategy}: stitched sharpe not finite")
    more = []
    for _ in range(3):
        t0 = time.perf_counter()
        backend.process(jobs)
        more.append(time.perf_counter() - t0)

    # The kernel against its plain version as the train sweep, on the
    # whole panel's W x 500 stacked train windows: the shape the main path
    # gave the kernel. The main path's blocks must be the plain run's rows.
    g = _flat_grid(axes)
    spec = compute._FUSED_STRATEGIES[strategy]
    strat = models.get_strategy(strategy)
    dev = backend.device
    tpanel = data.OHLCV(*(torch.as_tensor(f, device=dev) for f in panel))
    kw = dict(WF_KW, cost=JOB_COST)

    def train_fn(*fields):
        return spec.run(dict(zip(spec.fields, fields)), g, cost=JOB_COST,
                        periods_per_year=252, device=dev)

    def run():
        return walkforward.walk_forward_fused(
            tpanel, strat, g, train_fn, fields=spec.fields, device=dev, **kw)

    kern = run()
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    with _plain_entries(fused):
        plain = run()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(kernels_mod.LAUNCHES.get(entry, 0) == 0,
           f"{strategy} walk-forward: the plain run launched {entry}")
    for k in g:
        _check(torch.equal(kern.chosen[k], plain.chosen[k]),
               f"{strategy} walk-forward: kernel and plain version chose "
               f"other {k}")
    for name in kern.oos_metrics._fields:
        want = getattr(plain.oos_metrics, name)
        _check(_bits_equal(getattr(kern.oos_metrics, name), want),
               f"{strategy} walk-forward: {name} of the kernel's route not "
               "bit-equal to the plain version's")
        _check(np.array_equal(_u32(rows[name]), _u32(want.cpu())),
               f"{strategy} walk-forward: {name} of the main path's blocks "
               "not bit-equal to the plain run's")

    # 16 jobs through the backend against the generic refit on the card.
    small = data.synthetic_ohlcv(16, N_BARS, seed=seed + 100)
    if strategy == "sma_crossover":
        # Exact f32 cumsums whatever their association, as phase 4.
        small = data.OHLCV(*(np.round(f * 32) / np.float32(32)
                             for f in small))
    sjobs = _wf_jobs(pb, data, strategy, axes, (small,))
    got = _oos_rows(wire, backend.process(sjobs), sjobs)
    gold = walkforward.walk_forward(small, strat, g, device=dev,
                                    **WF_KW).oos_metrics
    n_flips = _wf_flips(f"{strategy} walk-forward vs the generic refit", got,
                        gold)
    _check(n_flips <= WF_MAX_FLIPS, f"{strategy} walk-forward: {n_flips} of "
           f"16 jobs flipped against the generic refit")
    print(f"{strategy} walk-forward: {N_TICKERS} jobs x {n_combos} combos x "
          f"{WF_WINDOWS} windows, first batch {first:.4f} s, 3 more "
          f"{[round(t, 4) for t in more]} s; kernel, plain version "
          f"({plain_s:.4f} s) and blocks bit-equal on "
          f"{N_TICKERS * WF_WINDOWS} stacked train rows; 16 jobs vs the "
          f"generic refit: {n_flips} flipped")
    return launches, first, statistics.median(more)


def _wf_pairs(backend, wire, pb, data, walkforward):
    """``WF_PAIRS`` pairs walk-forward jobs (the first of phase 4's pairs)
    through ``process``, bit-equal to ``walk_forward_pairs`` on the same
    stacked legs; the jobs flipped against the same refit in f64 are held
    at PAIRS_F64_MAX_FLIPS."""
    axes = AXES["pairs"]
    g = _flat_grid(axes)
    legs = tuple(data.OHLCV(*(f[:WF_PAIRS] for f in leg))
                 for leg in _pairs_legs(data, N_PAIRS, N_BARS, 1))
    jobs = _wf_jobs(pb, data, "pairs", axes, legs)
    t0 = time.perf_counter()
    done = backend.process(jobs)
    secs = time.perf_counter() - t0
    got = _oos_rows(wire, done, jobs)
    y, x = (leg.close for leg in legs)
    direct = walkforward.walk_forward_pairs(y, x, g, device=backend.device,
                                            **WF_KW).oos_metrics
    for name in direct._fields:
        _check(np.array_equal(_u32(got[name]),
                              _u32(getattr(direct, name).cpu())),
               f"pairs walk-forward: {name} of the blocks not bit-equal to "
               "walk_forward_pairs")
    y64, x64 = (torch.as_tensor(a, dtype=torch.float64, device=backend.device)
                for a in (y, x))
    f64 = {name: v.cpu().numpy() for name, v in zip(
        direct._fields,
        walkforward._walk_forward_pairs(y64, x64, g, **WF_KW).oos_metrics)}
    s64 = f64["sharpe"]
    flipped = np.abs(got["sharpe"] - s64) > 0.01 + 0.01 * np.abs(s64)
    flips = int(flipped.sum())
    _check(flips <= PAIRS_F64_MAX_FLIPS, f"pairs walk-forward: {flips} of "
           f"{WF_PAIRS} jobs flipped against the refit in f64")
    off = {name: int((((np.abs(got[name] - b)
                        > WF_ATOL + WF_RTOL * np.abs(b))
                       | (np.isnan(got[name]) != np.isnan(b)))
                      & ~flipped).sum())
           for name, b in f64.items()}
    print(f"pairs walk-forward: {WF_PAIRS} jobs x {g['lookback'].size} combos "
          f"x {WF_WINDOWS} windows, batch {secs:.4f} s, blocks bit-equal to "
          f"walk_forward_pairs; {flips} of {WF_PAIRS} jobs flipped against "
          f"the refit in f64 (at most {PAIRS_F64_MAX_FLIPS}); unflipped jobs "
          f"off rtol={WF_RTOL}, atol={WF_ATOL} of f64, a metric: {off}")
    return secs


def _np_book(close, pos, expo_card):
    """The equal-weight book of ``pos`` on ``close`` in numpy f64: (net,
    equity, exposure, metrics). hit_rate's active bars are those where the
    card's f32 exposure is nonzero: a bar with as many long as short
    tickers is exactly flat in f64 and may carry a rounding residue in
    f32."""
    from distributed_backtesting_exploration_tpu_torch.rpc import aggregate

    close = close.astype(np.float64)
    n = close.shape[0]
    r = np.zeros_like(close)
    r[:, 1:] = close[:, 1:] / close[:, :-1] - 1.0
    prev = np.concatenate([np.zeros((n, 1)), pos[:, :-1]], axis=1)
    net = (prev * r - COST * np.abs(pos - prev)).sum(axis=0) / n
    expo = pos.sum(axis=0) / n
    out = aggregate._np_portfolio_metrics(net)
    active = np.abs(np.concatenate([[0.0], expo_card[:-1]])) > 0
    out["hit_rate"] = float((active & (net > 0)).sum()
                            / (active.sum() + 1e-12))
    turnover = float(np.abs(np.diff(expo, prepend=0.0)).sum())
    out.update(n_trades=0.5 * turnover, turnover=turnover)
    return net, 1.0 + np.cumsum(net), expo, out


def _wf_portfolio(sweep, models, portfolio, checkpoint, data, dev) -> None:
    """``sweep_and_compose`` at 500 x 1260 on the sma bench grid against
    ``best_params`` and a numpy f64 book, ``correlation_matrix`` against
    numpy's, and a (500, 2000) Metrics checkpoint round trip."""
    import tempfile

    panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=0)
    tpanel = data.OHLCV(*(torch.as_tensor(f, device=dev) for f in panel))
    sma = models.get_strategy("sma_crossover")
    g = _flat_grid({"fast": FAST_AXIS, "slow": SLOW_AXIS})
    t0 = time.perf_counter()
    pm, chosen = portfolio.sweep_and_compose(tpanel, sma, g, cost=COST,
                                             device=dev)
    torch.cuda.synchronize()
    compose_s = time.perf_counter() - t0
    m = sweep.run_sweep(tpanel, sma, g, cost=COST, device=dev)
    _, want = sweep.best_params(m.sharpe, g, metric="sharpe")
    for k in g:
        _check(torch.equal(chosen[k], want[k]), f"sweep_and_compose: chosen "
               f"{k} is not best_params' of the generic sweep")
    pos = portfolio.per_ticker_positions(tpanel, sma, chosen, device=dev)
    net, equity, expo = portfolio.portfolio_returns(tpanel.close, pos,
                                                    cost=COST, device=dev)
    n64, e64, x64, m64 = _np_book(panel.close, pos.double().cpu().numpy(),
                                  expo.cpu().numpy())
    # The reference tests' tolerances (tests/test_portfolio.py).
    for label, a, b, rtol, atol in (("net", net, n64, 1e-4, 1e-6),
                                    ("equity", equity, e64, 1e-4, 1e-5),
                                    ("exposure", expo, x64, 1e-5, 1e-6)):
        a = a.cpu().numpy()
        _check(bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b))),
               f"portfolio {label} off the numpy f64 book by "
               f"{float(np.abs(a - b).max())}")
    for name, b in m64.items():
        a = float(getattr(pm, name))
        _check(abs(a - b) <= 1e-5 + 1e-4 * abs(b), f"portfolio {name} "
               f"{a} off the numpy f64 book's {b}")
    r = torch.cat([torch.zeros_like(tpanel.close[:, :1]),
                   tpanel.close[:, 1:] / tpanel.close[:, :-1] - 1.0], dim=1)
    corr = portfolio.correlation_matrix(r, device=dev).cpu().numpy()
    want_corr = np.corrcoef(r.double().cpu().numpy())
    err = float(np.abs(corr - want_corr).max())
    _check(bool(np.all(np.abs(corr - want_corr)
                       <= 1e-4 + 1e-4 * np.abs(want_corr))),
           f"correlation_matrix off numpy's f64 by {err}")
    corr_ms = _cuda_ms(lambda: portfolio.correlation_matrix(r, device=dev),
                       20)
    print(f"portfolio: sweep_and_compose {N_TICKERS} x {N_BARS} x "
          f"{g['fast'].size} combos in {compose_s:.4f} s (first call), "
          f"chosen = best_params, book sharpe {float(pm.sharpe):.6f} vs "
          f"numpy f64 {m64['sharpe']:.6f}; correlation_matrix "
          f"({N_TICKERS}, {N_TICKERS}) max abs err {err:.3g} vs numpy f64, "
          f"{corr_ms:.4f} ms")

    with tempfile.TemporaryDirectory() as root:
        ck = checkpoint.SweepCheckpointer(root)
        t0 = time.perf_counter()
        ck.add("sma", m, meta={"tickers": N_TICKERS})
        save_s = time.perf_counter() - t0
        _check(ck.done() == {"sma"}, "checkpoint: done() wrong")
        got, meta = ck.get("sma")
        _check(meta == {"tickers": N_TICKERS}, "checkpoint: meta lost")
        for name, a in zip(m._fields, got):
            _check(np.array_equal(_u32(a), _u32(getattr(m, name).cpu()))
                   and a.shape == (N_TICKERS, g["fast"].size),
                   f"checkpoint: {name} not bit-equal")
    print(f"checkpoint: {tuple(m.sharpe.shape)} Metrics round trip "
          f"bit-equal, save {save_s:.4f} s")


def phase_walkforward(kernels_mod, compute, wire, pb, data, sweep, models,
                      fused, bench, card: str) -> dict:
    """Walk-forward jobs of the 13 single-asset families on the fused-train
    route and of pairs on the generic refit, the walk-forward rates, the
    portfolio composition and a checkpoint; returns the launches per kernel
    entry summed over the families' main paths."""
    from distributed_backtesting_exploration_tpu_torch.parallel import (
        portfolio, walkforward)
    from distributed_backtesting_exploration_tpu_torch.utils import (
        checkpoint)

    backend = compute.TorchSweepBackend(device="cuda")
    _check(backend._WF_FUSED_MIN_COMBOS == 512, "the fused-train route's "
           "threshold is not the reference's 512")
    _wf_argmax_rule(walkforward, sweep, backend.device)
    total, batch_s = {}, {}
    families = {s: AXES[s] for s in ("sma_crossover", *FAMILIES)
                if s != "pairs"}
    for seed, (strategy, axes) in enumerate(families.items(), start=40):
        entry = roofline.ENTRY[strategy]
        launches, first, med = _wf_family(
            kernels_mod, backend, wire, pb, data, models, fused, walkforward,
            compute, strategy, axes, entry, seed)
        batch_s[strategy] = (first, med)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    kernels_mod.reset_launch_counts()
    pairs_s = _wf_pairs(backend, wire, pb, data, walkforward)
    print(f"pairs walk-forward launches {dict(kernels_mod.LAUNCHES)} (the "
          "reference has no fused route for it)")

    # The bench's walk-forward config (500 x 1260, 12 windows, cost 1e-3):
    # backtests/s = tickers x combos x windows over the median of 5 runs.
    dev = backend.device
    panel = data.OHLCV(*(torch.as_tensor(f, device=dev)
                         for f in data.synthetic_ohlcv(N_TICKERS, N_BARS,
                                                       seed=0)))
    sma = models.get_strategy("sma_crossover")
    g400 = _flat_grid({"fast": np.arange(5, 25, dtype=np.float32),
                       "slow": np.arange(30, 130, 5, dtype=np.float32)})
    g2000 = _flat_grid({"fast": FAST_AXIS, "slow": SLOW_AXIS})

    def generic(g):
        return lambda: walkforward.walk_forward(panel, sma, g, device=dev,
                                                **WF_KW)

    def fused_route(g):
        def train_fn(close):
            return fused.fused_sma_sweep(close, g["fast"], g["slow"],
                                         cost=COST, device=dev)
        return lambda: walkforward.walk_forward_fused(
            panel, sma, g, train_fn, device=dev, **WF_KW)

    rates = {}
    for label, g, run in (("generic P=400", g400, generic(g400)),
                          ("fused P=400", g400, fused_route(g400)),
                          ("fused P=2000", g2000, fused_route(g2000))):
        med = _median_s(run)
        rates[label] = N_TICKERS * g["fast"].size * WF_WINDOWS / med
        print(f"walk-forward {label}: median of 5 {med:.4f} s, "
              f"{rates[label]:.1f} backtests/s ({card})")
    for wf_fused in (False, True):
        out = bench.run(bench.Settings(configs=frozenset({"walkforward"}),
                                       wf_fused=wf_fused))
        print(f"port bench walkforward ({'fused' if wf_fused else 'generic'}"
              f" route): {out['configs']['walkforward']:.1f} backtests/s "
              f"({card})")
    print("walk-forward 500-job batches (s, first and median of 3 more): "
          + ", ".join(f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in
                      batch_s.items())
          + f", pairs ({N_PAIRS} jobs, generic) {pairs_s:.4f} ({card})")

    _wf_portfolio(sweep, models, portfolio, checkpoint, data, dev)
    return total


# --- streaming: carry checkpoints, carry_out=True, append jobs ------------

STREAM_DT = 16
# The phase's scale: half the bench's tickers and pairs, and about a
# quarter of phase 4's append jobs, so that the whole script stays well
# inside its time limit (the full reprices the append jobs are checked
# against are per-bar loops of torch ops).
STREAM_TICKERS, STREAM_PAIRS = 250, 500
STREAM_JOBS, STREAM_EMA_JOBS = 128, 16
# tests/test_streaming.py's cold-versus-append tolerances (pairs: its pairs
# budget) and the count metrics that are bit-equal where positions match.
STREAM_TOL = {"pairs": (5e-3, 5e-4)}
STREAM_RTOL, STREAM_ATOL = 2e-5, 2e-6
STREAM_COUNTS = ("turnover", "n_trades", "hit_rate")


def _carry_on(carry, dev: torch.device, label: str) -> None:
    """Every tensor of a carry is f32 on ``dev``'s kind of device."""
    for ns in ("tail", "state", "metric"):
        for k, v in getattr(carry, ns).items():
            _check(v.device.type == dev.type and v.dtype == torch.float32,
                   f"{label}: carry leaf {ns}/{k} is {v.dtype} on "
                   f"{v.device}, not float32 on {dev.type}")


def _np_metrics(m) -> dict:
    return {name: getattr(m, name).cpu().numpy() for name in m._fields}


def _off_tolerance(g: dict, w: dict, want, strategy: str,
                   n_bars: int) -> np.ndarray:
    """The lanes where a metric other than the counts is off the streaming
    tolerance (:func:`_stream_rule`); ``g``, ``w`` the numpy metrics."""
    rtol, atol = STREAM_TOL.get(strategy, (STREAM_RTOL, STREAM_ATOL))
    slack = _cagr_slack(want, n_bars, rtol, atol)
    off = np.zeros(w["turnover"].shape, dtype=bool)
    for name in want._fields:
        if name in STREAM_COUNTS:
            continue
        a, b = g[name], w[name]
        extra = slack if name == "cagr" else 0.0
        off |= ((np.abs(a - b) > atol + rtol * np.abs(b) + extra)
                | (np.isnan(a) != np.isnan(b)))
    return off


def _stream_rule(label, got, want, strategy: str, n_bars: int,
                 flipped=None, set_aside=None) -> int:
    """``tests/test_streaming.py``'s cold-versus-append rule with a 1%
    budget: on the lanes that did not flip, turnover, n_trades and
    hit_rate are bit-equal and every other metric agrees at rtol=2e-5,
    atol=2e-6 (pairs 5e-3, 5e-4), cagr within ``_cagr_slack``; at most
    max(1, 1%) of the lanes may flip, not counting those in ``set_aside``.
    ``flipped`` marks the lanes whose position paths differ; without it, a
    lane is flipped where its turnover or hit rate differs (both exact
    functions of the path, but an entry and an exit each a bar late keep
    them). For pairs, as in phase 4's pairs budget, a lane off the
    tolerance counts as flipped too, and so does one whose hit rate
    differs: its hedge ratio's windowed sums cancel in f32, and a bar's
    win is the sign of its hedged return. Returns the flipped lanes
    counted against the budget."""
    g, w = _np_metrics(got), _np_metrics(want)
    if flipped is None:
        flipped = ((g["turnover"] != w["turnover"])
                   | (g["hit_rate"] != w["hit_rate"]))
    off = _off_tolerance(g, w, want, strategy, n_bars)
    if strategy == "pairs":
        flipped = flipped | off | (g["hit_rate"] != w["hit_rate"])
    counted = flipped if set_aside is None else flipped & ~set_aside
    n_flips = int(counted.sum())
    _check(n_flips <= max(1, int(0.01 * flipped.size)),
           f"{label}: {n_flips}/{flipped.size} flipped lanes")
    ok = ~flipped
    for name in STREAM_COUNTS:
        _check(np.array_equal(g[name][ok], w[name][ok]), f"{label}: {name} "
               "not bit-equal on the unflipped lanes")
    bad = off & ok
    _check(not bad.any(), f"{label}: {int(bad.sum())} unflipped lanes off "
           f"the tolerance, max abs err of sharpe "
           f"{float(np.nanmax(np.abs(g['sharpe'] - w['sharpe'])[ok])):.3e}; "
           "on those lanes, (got, want) by metric: " + json.dumps(
               {k: list(zip(g[k][bad].tolist()[:4], w[k][bad].tolist()[:4]))
                for k in want._fields}))
    return n_flips


def _stream_fields(data, strategy, n, n_pairs, bars, dev):
    """A family's ``(N, T)`` fields on ``dev``: the bench's seed-0 panel,
    or pairs' (y, x) legs from ``2 n_pairs`` seed-1 tickers."""
    if strategy == "pairs":
        y, x = _pairs_legs(data, n_pairs, bars, 1)
        cols = {"close": y.close, "close2": x.close}
    else:
        panel = data.synthetic_ohlcv(n, bars, seed=0)
        cols = {f: getattr(panel, f) for f in data._FIELDS}
    return {k: torch.as_tensor(v, device=dev) for k, v in cols.items()}


def _wrapper(compute, fused, strategy, fields, g, dev, **kw):
    """The family's ``fused_*_sweep`` as the backend calls it."""
    if strategy == "pairs":
        return fused.fused_pairs_sweep(fields["close"], fields["close2"],
                                       g["lookback"], g["z_entry"],
                                       cost=COST, device=dev, **kw)
    return compute._FUSED_STRATEGIES[strategy].run(fields, g, cost=COST,
                                                   device=dev, **kw)


def _golden_sweep(sweep, models, data, strategy, fields, g, dev):
    if strategy == "pairs":
        return models.pairs.run_pairs_sweep(fields["close"],
                                            fields["close2"], g, cost=COST,
                                            device=dev)
    return sweep.run_sweep(data.OHLCV(*(fields[f] for f in data._FIELDS)),
                           models.get_strategy(strategy), g, cost=COST,
                           device=dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _stream_carry_out(kernels_mod, compute, fused, sweep, models, data,
                      recurrent, families, n, n_pairs, bars, dev) -> dict:
    """(a): each wrapper with ``carry_out=True`` at the main path's shape:
    the kernel's metrics bit-equal to the same call without it, the carry's
    metrics against the generic sweep under :func:`_stream_rule`. Returns
    the kernel launches of the carry_out calls."""
    launches: dict = {}
    for strategy, axes in families.items():
        fields = _stream_fields(data, strategy, n, n_pairs, bars, dev)
        g = _flat_grid(axes)
        plain = _wrapper(compute, fused, strategy, fields, g, dev)
        _sync(dev)
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        m, carry = _wrapper(compute, fused, strategy, fields, g, dev,
                            carry_out=True)
        _sync(dev)
        wrap_s = time.perf_counter() - t0
        for name, c in kernels_mod.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + c
        _check(sum(kernels_mod.LAUNCHES.values()) > 0 or dev.type != "cuda",
               f"{strategy} carry_out=True launched no kernel")
        for name in m._fields:
            _check(_bits_equal(getattr(m, name), getattr(plain, name)),
                   f"{strategy} carry_out=True moved the kernel's {name}")
        _carry_on(carry, dev, f"{strategy} carry_out")
        _check(carry.n_bars == bars and carry.strategy == strategy,
               f"{strategy} carry_out: carry of {carry.strategy} at "
               f"{carry.n_bars} bars")
        t0 = time.perf_counter()
        gold = _golden_sweep(sweep, models, data, strategy, fields, g, dev)
        _sync(dev)
        gold_s = time.perf_counter() - t0
        flips = _stream_rule(f"{strategy} carry_out finalize vs generic "
                             "sweep", recurrent.finalize(carry), gold,
                             strategy, bars)
        print(f"streaming (a) {strategy}: {carry.metric['s1'].shape[0]} x "
              f"{g[next(iter(g))].size} x {bars}: kernel metrics bit-equal "
              f"with carry_out; {flips} flipped lanes of "
              f"{carry.metric['s1'].numel()} against the generic sweep; "
              f"carry_out call {wrap_s:.4f} s, generic sweep {gold_s:.4f} s, "
              f"carry {carry.nbytes} bytes")
        del carry, m, plain, gold
    return launches


def _path_flips(recurrent, strategy, base, fields, bars, dev):
    """Where the cold build's position paths over ``bars + ΔT`` bars differ
    from the carry's followed by the append's, ``(N, P)`` bool each:
    ``hist``, on the first ``bars`` bars (the generic models at two
    lengths: those that center a series by its mean over the whole history
    round their windowed sums differently once it has more bars), where
    the positions differ or the metrics of those bars do (pairs' hedged
    returns move with the length too), and
    ``delta``, on the appended bars (the append's head, or the model
    replayed over the carry's tail window, against the models over the
    whole history). Also the append's positions, ``(N, P, ΔT)``, and the
    metrics of the carry advanced by the cold build's positions and
    returns on the appended bars: the cold path with the carry's history,
    the append's own yardstick."""
    spec = recurrent._STREAM_FAMILIES[strategy]
    K = base.tail["close"].shape[-1]
    win = {f: torch.cat([base.tail[f], fields[f][:, bars:]], dim=-1)[:, None]
           for f in base.tail}
    f3 = {f: fields[f][:, None] for f in base.tail}
    b3 = {f: v[..., :bars] for f, v in f3.items()}
    N, T = fields["close"].shape
    # The append's positions, in append_step's param chunks: on the card
    # a chunk's shape sets how torch sums its rows, so other chunks could
    # round the head's windowed sums otherwise.
    app = []
    for lo, hi, sub in recurrent._chunks(base.grid, N * (K + STREAM_DT),
                                         dev):
        if spec.head is None:
            app.append(recurrent._positions_full(strategy, win, sub)[0][
                ..., K:])
        else:
            app.append(spec.head(win, STREAM_DT, sub,
                                 recurrent._lane_slice(base.state, lo, hi),
                                 base.metric["pos_last"][..., lo:hi])[0])
    app = torch.cat(app, dim=1)
    # The base carry's history positions, in build_carry's chunks at
    # ``bars`` bars (int8: every position is -1, 0 or 1).
    P = app.shape[1]
    base_pos = torch.empty((N, P, bars), dtype=torch.int8, device=dev)
    for lo, hi, sub in recurrent._chunks(base.grid, N * bars, dev):
        base_pos[:, lo:hi] = recurrent._positions_full(
            strategy, b3, sub)[0].to(torch.int8)
    hist, delta, iso = [], [], []
    block = recurrent._block(STREAM_DT, None)
    for lo, hi, sub in recurrent._chunks(base.grid, N * T, dev):
        cold, ret = recurrent._positions_full(strategy, f3, sub)
        base_m = recurrent._lane_slice(base.metric, lo, hi)
        iso.append(recurrent._advance_metrics(
            base_m, cold[..., bars:], ret[..., bars:], cost=base.cost,
            block=block))
        # The cold build's first bars folded alone, against the base's.
        cold_m = recurrent._finalize(recurrent._advance_metrics(
            recurrent._metric_init(N, hi - lo, dev), cold[..., :bars],
            ret[..., :bars], cost=base.cost,
            block=recurrent._block(bars, None)), bars, base.ppy)
        base_f = recurrent._finalize(base_m, bars, base.ppy)
        g, w = _np_metrics(cold_m), _np_metrics(base_f)
        moved = (_off_tolerance(g, w, base_f, strategy, bars)
                 | (g["turnover"] != w["turnover"])
                 | (g["hit_rate"] != w["hit_rate"]))
        hist.append(torch.as_tensor(moved, device=dev)
                    | (cold[..., :bars].to(torch.int8)
                       != base_pos[:, lo:hi]).any(dim=-1))
        delta.append((cold[..., bars:] != app[:, lo:hi]).any(dim=-1))
        del cold, ret
    return (torch.cat(hist, dim=1).cpu().numpy(),
            torch.cat(delta, dim=1).cpu().numpy(), app,
            recurrent._finalize(recurrent._join(iso), T, base.ppy))


def _stream_append_vs_cold(data, recurrent, store_mod, families, n, n_pairs,
                           bars, dev) -> None:
    """(b): a carry at ``bars`` plus one ΔT append against the cold build at
    ``bars + ΔT``, per family; for sma 16 one-bar appends against the one
    16-bar append; and an append after a device-level eviction and a
    restore from the host level bit-equal to the append never evicted."""
    full = bars + STREAM_DT
    for strategy, axes in families.items():
        fields = _stream_fields(data, strategy, n, n_pairs, full, dev)
        g = _flat_grid(axes)
        base_f = {k: v[:, :bars] for k, v in fields.items()}
        delta = {k: v[:, bars:] for k, v in fields.items()}
        base = recurrent.build_carry(strategy, base_f, g, cost=COST,
                                     device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        stepped = recurrent.append_step(base, delta)
        got = recurrent.finalize(stepped)
        _sync(dev)
        append_s = time.perf_counter() - t0
        _carry_on(stepped, dev, f"{strategy} append")
        t0 = time.perf_counter()
        cold = recurrent.finalize(recurrent.build_carry(
            strategy, fields, g, cost=COST, device=dev))
        _sync(dev)
        cold_s = time.perf_counter() - t0
        hist, delta_f, app_pos, iso = _path_flips(recurrent, strategy, base,
                                                  fields, bars, dev)
        n_delta = _stream_rule(f"{strategy} append vs the cold path on the "
                               "appended bars", got, iso, strategy, full,
                               flipped=delta_f)
        # Against the cold build itself: the lanes whose history paths
        # differ (the generic models at two lengths) are set aside and
        # counted; the rest are held to the same rule.
        n_cold = _stream_rule(f"{strategy} append vs cold build", got, cold,
                              strategy, full, flipped=hist | delta_f,
                              set_aside=hist)
        print(f"streaming (b) {strategy}: carry@{bars} + {STREAM_DT}-bar "
              f"append: {n_delta} lanes of {cold.sharpe.numel()} flipped "
              f"against the cold path on the appended bars; against the "
              f"cold build@{full} {n_cold}, and {int(hist.sum())} set aside "
              f"whose first {bars} bars' positions or metrics differ "
              f"between the generic models at {bars} and at {full} bars; "
              "append "
              f"{append_s:.4f} s, cold build {cold_s:.4f} s")
        if strategy == "sma_crossover":
            c, path = base, []
            for t in range(STREAM_DT):
                c = recurrent.append_step(
                    c, {k: v[:, t:t + 1] for k, v in delta.items()})
                path.append(c.metric["pos_last"])     # the bar's position
            flipped = (torch.stack(path, dim=-1) != app_pos).any(dim=-1)
            flips = _stream_rule("sma 16 one-bar appends vs one 16-bar "
                                 "append", recurrent.finalize(c), got,
                                 strategy, full,
                                 flipped=flipped.cpu().numpy())
            print(f"streaming (b) sma_crossover: 16 one-bar appends vs one "
                  f"16-bar append: {flips} flipped lanes")
        if strategy in ("sma_crossover", "macd", "rsi"):
            store = store_mod.CarryStore(max_bytes=4 * base.nbytes + (1 << 20),
                                         device=dev)
            key = ("stream-smoke", recurrent.stream_key(strategy, g, COST,
                                                        252))
            store.put(key, base)
            store.evict_device(key)
            restored = store.get(key)
            _check(restored is not None and restored is not base
                   and store.hits["host"] == 1,
                   f"{strategy}: the host level did not restore the carry")
            _carry_on(restored, dev, f"{strategy} restored")
            again = recurrent.finalize(recurrent.append_step(restored,
                                                             delta))
            for name in got._fields:
                _check(_bits_equal(getattr(again, name), getattr(got, name)),
                       f"{strategy}: append after evict and restore moved "
                       f"{name}")
            print(f"streaming (b) {strategy}: append after a device-level "
                  "eviction and a host restore bit-equal")
        del base, stepped, got, cold, app_pos, iso


def _append_jobs(pb, data, panel_store, strategy, axes, panel, lo, hi, tag,
                 delta_only):
    """One append JobSpec a ticker of ``panel``: bars ``[lo, hi)`` appended
    to the first ``lo``, as the dispatcher makes them; ``delta_only`` ships
    only the appended bars (``ohlcv`` empty)."""
    grid = {k: pb.GridAxis(values=[float(v) for v in vals])
            for k, vals in axes.items()}
    jobs = []
    for i in range(panel.close.shape[0]):
        def cut(a, b, i=i):
            return data.to_wire_bytes(data.OHLCV(*(f[i, a:b] for f in panel)))
        ext = cut(0, hi)
        jobs.append(pb.JobSpec(
            id=f"{tag}-{i:04d}", strategy=strategy, grid=grid, cost=COST,
            periods_per_year=252, ohlcv=b"" if delta_only else ext,
            panel_digest=panel_store.panel_digest(ext),
            append_parent_digest=panel_store.panel_digest(cut(0, lo)),
            append_base_len=lo, append_delta=cut(lo, hi)))
    return jobs


def _timed(backend, jobs):
    t0 = time.perf_counter()
    done = backend.process(jobs)
    return done, time.perf_counter() - t0


def _stored_carries(wire, recurrent, sweep, backend, jobs, bars, dev,
                    label) -> list:
    """The carries ``jobs`` left in the backend's store, each at ``bars``
    bars with its tensors on ``dev``."""
    job0 = jobs[0]
    g = {k: v.numpy() for k, v in sweep.product_grid(
        **wire.grid_from_proto(job0.grid)).items()}
    skey = recurrent.stream_key(job0.strategy, g, COST, 252)
    out = []
    for job in jobs:
        carry = backend.carry_store.get((job.panel_digest, skey))
        _check(carry is not None and carry.n_bars == bars,
               f"{label}: the stored carry of job {job.id} is missing")
        _carry_on(carry, dev, label)
        out.append(carry)
    return out


def _direct_appends(recurrent, wire, bases, panel, jobs, bars, dev, label,
                    done) -> None:
    """Each round-2 block bit-equal to ``finalize(append_step(...))`` of
    the round-1 carry it advanced, called directly."""
    names = recurrent.stream_fields(jobs[0].strategy)
    for i, (job, c, base) in enumerate(zip(jobs, done, bases)):
        delta = {f: torch.as_tensor(getattr(panel, f)[i:i + 1,
                                                      bars:bars + STREAM_DT],
                                    device=dev) for f in names}
        want = recurrent.finalize(recurrent.append_step(base, delta))
        got = wire.metrics_from_bytes(c.metrics)
        for name in want._fields:
            _check(np.array_equal(getattr(got, name),
                                  getattr(want, name).cpu().numpy()[0],
                                  equal_nan=True),
                   f"{label}: job {job.id} {name} differs from the direct "
                   "append")


def _stream_worker_path(compute, wire, pb, data, sweep, recurrent, store_mod,
                        panel_store, axes, n_jobs, n_ema, bars, dev,
                        card) -> None:
    """(c): append jobs through ``TorchSweepBackend.process``."""
    strategy = "sma_crossover"
    panel = data.synthetic_ohlcv(n_jobs, bars + STREAM_DT, seed=70)
    r1 = _append_jobs(pb, data, panel_store, strategy, axes[strategy], panel,
                      bars - STREAM_DT, bars, "r1", False)
    r2 = _append_jobs(pb, data, panel_store, strategy, axes[strategy], panel,
                      bars, bars + STREAM_DT, "r2", True)
    times = {1: [], 2: [], 3: []}
    round2 = None
    for rep in range(3):
        backend = compute.TorchSweepBackend(device=dev)
        _check(backend.carry_store.max_bytes == 64 * 1024 * 1024,
               "the carry store's default budget is not 64 MB")
        d1, s1 = _timed(backend, r1)
        _check(backend.appends == {"carry_hit": 0, "full_reprice": n_jobs}
               and all(c.metrics for c in d1),
               f"round 1: {backend.appends}, expected {n_jobs} full "
               "reprices")
        st = backend.carry_store.stats()
        _check(st["device_carries"] == n_jobs == st["host_carries"],
               f"round 1 stored {st}")
        if rep == 0:
            bases = _stored_carries(wire, recurrent, sweep, backend, r1,
                                    bars, dev, "round 1")
            per_carry = bases[0].nbytes
        d2, s2 = _timed(backend, r2)
        _check(backend.appends == {"carry_hit": n_jobs,
                                   "full_reprice": n_jobs}
               and backend.advances == n_jobs,
               f"round 2: {backend.appends}, {backend.advances} advances; "
               f"expected {n_jobs} carry hits")
        _check(backend.decodes == n_jobs, f"round 2 decoded panels: "
               f"{backend.decodes} decodes (round 1's {n_jobs} only)")
        d3, s3 = _timed(backend, r2)
        _check(backend.appends["carry_hit"] == 2 * n_jobs
               and backend.advances == n_jobs,
               f"round 3 (a retried delivery) advanced: {backend.appends}, "
               f"{backend.advances} advances")
        _check([c.metrics for c in d3] == [c.metrics for c in d2],
               "round 3's blocks differ from round 2's")
        for k, s in zip((1, 2, 3), (s1, s2, s3)):
            times[k].append(s)
        st = backend.carry_store.stats()
        _check(st["device_carries"] == n_jobs == st["host_carries"],
               f"one carry a stream after round 3: {st}")
        if rep == 0:
            round2 = d2
            _direct_appends(recurrent, wire, bases, panel, r2, bars, dev,
                            "round 2", d2)
            _stored_carries(wire, recurrent, sweep, backend, r2,
                            bars + STREAM_DT, dev, "round 2")
            del bases
    print(f"streaming (c) {n_jobs} sma append jobs (1 ticker x {bars} bars "
          f"x {wire.grid_n_combos(r1[0].grid)} combos), median of 3 (s, "
          f"batch / a job): " + ", ".join(
              f"round {k} {statistics.median(v):.4f} / "
              f"{statistics.median(v) / n_jobs * 1e3:.4f} ms"
              for k, v in times.items())
          + f"; runs {times}; {per_carry} bytes a carry ({card})")

    # A budget for about half of the carries: every job completes, and the
    # evicted parents are counted full reprices.
    half = compute.TorchSweepBackend(
        device=dev, carry_store=store_mod.CarryStore(
            max_bytes=per_carry * n_jobs // 2, device=dev))
    half.process(r1)
    g = {k: v.numpy() for k, v in sweep.product_grid(
        **wire.grid_from_proto(r1[0].grid)).items()}
    skey = recurrent.stream_key(strategy, g, COST, 252)
    store = half.carry_store
    with store._lock:
        gone = sum((j.panel_digest, skey) not in store._device
                   and (j.panel_digest, skey) not in store._host
                   for j in r1)
    d2h = half.process(r2)
    hits, reprices = half.appends["carry_hit"], half.appends["full_reprice"]
    _check(len(d2h) == n_jobs and all(c.metrics for c in d2h),
           "half budget: a job did not complete")
    _check(hits + reprices == 2 * n_jobs and reprices - n_jobs >= gone > 0,
           f"half budget: {hits} hits, {reprices - n_jobs} round-2 full "
           f"reprices, {gone} parents evicted")
    # Each block is the append's (a hit) or the full reprice's (a miss):
    # bit-equal to the full budget's round 2 or to a store that keeps
    # nothing, and the full reprices' blocks are counted.
    none = compute.TorchSweepBackend(
        device=dev, panel_cache=half.panel_cache,
        carry_store=store_mod.CarryStore(max_bytes=0, device=dev))
    d2z = none.process(r2)
    _check(none.appends == {"carry_hit": 0, "full_reprice": n_jobs},
           f"a store that keeps nothing: {none.appends}")
    as_append = sum(h.metrics == a.metrics for h, a in zip(d2h, round2))
    as_reprice = sum(h.metrics == z.metrics and h.metrics != a.metrics
                     for h, a, z in zip(d2h, round2, d2z))
    _check(as_append + as_reprice == n_jobs
           and as_reprice <= reprices - n_jobs,
           f"half budget: {as_append} blocks of appends, {as_reprice} of "
           f"full reprices, {reprices - n_jobs} full reprices counted")
    print(f"streaming (c) half budget ({store.max_bytes} bytes): "
          f"{gone} parents evicted before round 2; round 2 {hits} carry "
          f"hits, {reprices - n_jobs} counted full reprices; blocks: "
          f"{as_append} the appends', {as_reprice} the full reprices' "
          "(the rest equal in both)")

    for strategy, seed in (("macd", 71), ("rsi", 72)):
        panel = data.synthetic_ohlcv(n_ema, bars + STREAM_DT, seed=seed)
        e1 = _append_jobs(pb, data, panel_store, strategy, axes[strategy],
                          panel, bars - STREAM_DT, bars, f"{strategy}-r1",
                          False)
        e2 = _append_jobs(pb, data, panel_store, strategy, axes[strategy],
                          panel, bars, bars + STREAM_DT, f"{strategy}-r2",
                          True)
        backend = compute.TorchSweepBackend(device=dev)
        _, s1 = _timed(backend, e1)
        bases = _stored_carries(wire, recurrent, sweep, backend, e1, bars,
                                dev, f"{strategy} round 1")
        d2, s2 = _timed(backend, e2)
        _check(backend.appends == {"carry_hit": n_ema, "full_reprice": n_ema}
               and backend.advances == n_ema,
               f"{strategy} append jobs: {backend.appends}")
        _direct_appends(recurrent, wire, bases, panel, e2, bars, dev,
                        f"{strategy} round 2", d2)
        print(f"streaming (c) {n_ema} {strategy} append jobs "
              f"({wire.grid_n_combos(e1[0].grid)} combos): round 1 (full "
              f"reprices) {s1:.4f} s, round 2 (carry hits) {s2:.4f} s; "
              f"round 2 bit-equal to the direct appends ({card})")


def phase_streaming(kernels_mod, compute, wire, pb, data, sweep, models,
                    fused, bench, panel_store, card: str, *, axes=AXES,
                    n: int = STREAM_TICKERS, n_pairs: int = STREAM_PAIRS,
                    bars: int = N_BARS, n_jobs: int = STREAM_JOBS,
                    n_ema: int = STREAM_EMA_JOBS,
                    dev=torch.device("cuda")) -> dict:
    """Streaming: ``carry_out=True`` on the 14 wrappers, appends against
    cold builds, append jobs through the backend, and the port bench's
    ``streaming_append``. Returns the kernel launches of the carry_out
    calls (the phase's main path)."""
    from distributed_backtesting_exploration_tpu_torch.streaming import (
        recurrent, store as store_mod)

    families = {s: axes[s] for s in ("sma_crossover", *CHECKS)}
    t0 = time.perf_counter()
    launches = _stream_carry_out(kernels_mod, compute, fused, sweep, models,
                                 data, recurrent, families, n, n_pairs, bars,
                                 dev)
    t_a = time.perf_counter()
    _stream_append_vs_cold(data, recurrent, store_mod, families, n, n_pairs,
                           bars, dev)
    t_b = time.perf_counter()
    _stream_worker_path(compute, wire, pb, data, sweep, recurrent, store_mod,
                        panel_store, axes, n_jobs, n_ema, bars, dev, card)
    t_c = time.perf_counter()
    if dev.type == "cuda":
        out = bench.run(bench.Settings(configs=frozenset({"streaming_append"})))
        print(f"streaming (d) port bench streaming_append: "
              f"{json.dumps(out['roofline']['streaming_append'])} ({card})")
    print(f"streaming phase wall (s): (a) {t_a - t0:.1f}, (b) {t_b - t_a:.1f}"
          f", (c) {t_c - t_b:.1f}, (d) {time.perf_counter() - t_c:.1f}")
    return launches


# --- paged mode and scenario batches ---------------------------------------

PAGED_JOBS = 500
# Families held to the flip-aware rule, not bit-equality, paged against
# the whole group's dense stack: none. Every family's prep is a function of
# a row's own bars (vwap's deviation is centered over them, fused.row_mean),
# so all 13 are held bit-equal.
FLIP_AWARE_PAGED = ()
PAGED_APPEND_JOBS = 16
SCENARIO_K = 500
SCENARIO_PARAMS = {"n_bars": N_BARS, "block": 16, "regimes": 3,
                   "vol_scale": 2.0, "shock": 0.01}


class _Soft:
    """Checks of phase 8 collected and failed together at its end, so one
    run on the card reports every one."""

    def __init__(self):
        self.failed: list[str] = []

    def check(self, cond: bool, msg: str) -> None:
        if not cond:
            print(f"phase 8 check failed: {msg}")
            self.failed.append(msg)

    def done(self) -> None:
        _check(not self.failed, f"{len(self.failed)} phase 8 checks failed: "
               f"{self.failed}")


def _mixed_lengths(n: int, bars: int, seed: int) -> np.ndarray:
    """``n`` history lengths in [64, bars], the first ``bars``."""
    lens = np.random.default_rng(seed).integers(64, bars + 1, n)
    lens[0] = bars
    return lens


def _cut_rows(data, panel, lens) -> list:
    return [data.OHLCV(*(np.asarray(f)[i, :t] for f in panel))
            for i, t in enumerate(lens)]


def _cells_off(got, want) -> tuple[int, int]:
    """Cells (ticker, combo) of two Metrics not bit-equal, and off the
    flip-aware budget's tolerance, in any metric."""
    diff = np.zeros(tuple(got.sharpe.shape), dtype=bool)
    off = diff.copy()
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        diff |= _u32(a) != _u32(b)
        off |= ~np.isclose(a, b, rtol=SHIFT_RTOL, atol=SHIFT_ATOL,
                           equal_nan=True)
    return int(diff.sum()), int(off.sum())


def _hold_rows(soft, label, got, want, flip_ok: bool) -> str:
    """``got`` against ``want``: bit-equal, or where ``flip_ok`` at most
    max(1, 1%) of the cells off the flip-aware tolerance."""
    diff, off = _cells_off(got, want)
    return _hold_counts(soft, label, diff, off,
                        int(np.prod(tuple(got.sharpe.shape))), flip_ok)


def _hold_counts(soft, label, diff: int, off: int, cells: int,
                 flip_ok: bool) -> str:
    if flip_ok:
        soft.check(off <= max(1, cells // 100),
                   f"{label}: {off} of {cells} cells off the flip-aware "
                   "tolerance")
    else:
        soft.check(diff == 0, f"{label}: {diff} of {cells} cells not "
                   "bit-equal")
    return f"{diff} of {cells} cells not bit-equal, {off} off tolerance"


def _not_bit_equal(a, b) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def _stack_shapes(soft, compute, fused, pnl, series, lens, bins, bars, axes,
                  dev) -> None:
    """Why rows stacked otherwise round otherwise on the card: the f32
    cumsum of the whole group's closes against the same cumsum of the
    first bars only or of the rows of each bin, and the same in f64 rounded
    once, printed; K1 on the whole group's own inputs cut to each bin's
    rows and bars held bit-equal to its rows of the whole group's run (the
    kernel reads nothing past a row's length)."""
    close = torch.as_tensor(compute._stack_field_ragged(series, bars),
                            device=dev)
    full, full64 = torch.cumsum(close, 1), torch.cumsum(close.double(), 1)
    B = fused.resolve_page_bars()
    cut_t = {T: (_not_bit_equal(torch.cumsum(close[:, :T].contiguous(), 1),
                                full[:, :T]),
                 _not_bit_equal(torch.cumsum(close[:, :T].double()
                                             .contiguous(), 1).float(),
                                full64[:, :T].float()), close.shape[0] * T)
             for T in (B, 2 * B)}
    cut_n = {}
    for idx in bins:
        rows = torch.as_tensor(idx, device=dev)
        cut_n[idx.size] = (
            _not_bit_equal(torch.cumsum(close[rows], 1), full[rows]),
            _not_bit_equal(torch.cumsum(close[rows].double(), 1).float(),
                           full64[rows].float()), idx.size * bars)
    print(f"paged (a) prefix sums of the whole group's closes ({bars} bars, "
          f"{close.shape[0]} rows) against the same of the first T bars "
          f"(f32, f64 rounded once, of): {cut_t}; of a bin's rows: {cut_n}")
    g = _flat_grid(axes["sma_crossover"])
    fast_w, slow_w, warm = fused._grid_setup(g["fast"], g["slow"])
    r = pnl.simple_returns(close).contiguous()
    whole = fused.fused_sma(full.contiguous(), r, *fused._to(
        dev, lens.astype(np.int32), fast_w, slow_w, warm), cost=COST,
        ppy=252)
    for idx in bins:
        rows = torch.as_tensor(idx, device=dev)
        T = int(lens[idx].max())
        part = fused.fused_sma(
            full[rows, :T].contiguous(), r[rows, :T].contiguous(),
            *fused._to(dev, lens[idx].astype(np.int32), fast_w, slow_w,
                       warm), cost=COST, ppy=252)
        soft.check(_not_bit_equal(part, whole[:, rows]) == 0,
                   f"paged (a): K1 on the group's inputs cut to {idx.size} "
                   f"rows and {T} bars differs from the whole group's run")
    print("paged (a) K1 on the whole group's inputs cut to each bin's rows "
          "and bars: bit-equal to the whole group's run")


def _paged_families(soft, kernels_mod, compute, fused, pnl, data, page_pool,
                    n, bars, axes, dev) -> dict:
    """(a): each family's paged sweep of one mixed-length group against the
    dense route. Returns the kernel launches of the paged sweeps."""
    panel = data.synthetic_ohlcv(n, bars, seed=0)
    lens = _mixed_lengths(n, bars, seed=8)
    series = _cut_rows(data, panel, lens)
    B = fused.resolve_page_bars()
    pages = -(-lens // B)
    bins = [np.flatnonzero(pages == p) for p in np.unique(pages)]
    _stack_shapes(soft, compute, fused, pnl, series, lens, bins, bars, axes,
                  dev)
    runs = {}
    kernels_mod.reset_launch_counts()
    for strategy in sorted(fused._PAGED_FAMILIES):
        fields = fused.paged_fields(strategy)
        g = _flat_grid(axes[strategy])
        pool = page_pool.PagePool(
            device=dev, max_bytes=n * len(fields) * int(pages.max()) * B * 4)
        with pool.lock:
            pool_arr, tables, _ = pool.prepare(
                [f"{strategy}-{i}" for i in range(n)], series, fields)
            before = dict(kernels_mod.LAUNCHES)
            _sync(dev)
            t0 = time.perf_counter()
            m = fused.fused_paged_sweep(strategy, pool_arr, tables, lens, g,
                                        cost=COST)
            _sync(dev)
        grew = {k: v - before.get(k, 0)
                for k, v in kernels_mod.LAUNCHES.items()}
        runs[strategy] = (m, g, time.perf_counter() - t0, grew)
    launches = dict(kernels_mod.LAUNCHES)
    for strategy, (m, g, paged_s, grew) in runs.items():
        fam = fused._PAGED_FAMILIES[strategy]
        fields, call = fam.fields, fam.call
        label = f"paged (a) {strategy}"
        entries = [roofline.ENTRY[strategy]] + (
            [TABLE_KERNELS[strategy]] if strategy in TABLE_KERNELS else [])
        if dev.type == "cuda":
            for e in entries:
                soft.check(grew.get(e, 0) == len(bins),
                           f"{label}: {e} launched {grew.get(e, 0)} times "
                           f"for {len(bins)} page-count bins")
        # The dense route of each bin's rows: the same rows and bars.
        for idx in bins:
            t_bin = lens[idx]
            arrays = [compute._stack_field_ragged([series[i] for i in idx],
                                                  int(t_bin.max()), f)
                      for f in fields]
            want = call(arrays, g, t_real=None if (t_bin == t_bin.max()).all()
                        else t_bin, cost=COST, device=dev)
            _hold_rows(soft, f"{label} bin of {idx.size} rows", type(m)(
                *(f[torch.as_tensor(idx, device=dev)] for f in m)), want,
                False)
        # The dense ragged route of the whole group (every row padded to
        # the longest): bit-equal, the preps' prefix sums and centering
        # being functions of a row's own bars.
        arrays = [compute._stack_field_ragged(series, bars, f)
                  for f in fields]
        _sync(dev)
        t0 = time.perf_counter()
        want = call(arrays, g, t_real=lens.astype(np.int32), cost=COST,
                    device=dev)
        _sync(dev)
        dense_s = time.perf_counter() - t0
        how = _hold_rows(soft, f"{label} vs the whole group's dense stack",
                         m, want, strategy in FLIP_AWARE_PAGED)
        print(f"{label}: {n} rows of 64..{bars} bars x {g[next(iter(g))].size}"
              f" combos, {len(bins)} bins ({[int(i.size) for i in bins]} "
              f"rows), launches {dict((e, grew.get(e, 0)) for e in entries)};"
              f" each bin bit-equal to its dense stack; vs the whole group's "
              f"dense stack {how}; paged {paged_s:.4f} s, dense "
              f"{dense_s:.4f} s (first calls)")
    return launches


def _hold_blocks(soft, wire, label, got: dict, want: dict,
                 flip_ok: bool = True) -> str:
    """Two routes' DBXM blocks by job id: bit-equal, or where ``flip_ok``
    under the flip-aware budget."""
    soft.check(set(got) == set(want) and all(got.values()),
               f"{label}: other jobs completed, or empty blocks")
    diff = off = cells = 0
    for job_id, blob in want.items():
        if job_id not in got:
            continue
        a = wire.metrics_from_bytes(got[job_id])
        b = wire.metrics_from_bytes(blob)
        d, o = _cells_off(type(a)(*(torch.as_tensor(f) for f in a)),
                          type(b)(*(torch.as_tensor(f) for f in b)))
        diff, off, cells = diff + d, off + o, cells + b.sharpe.size
    return _hold_counts(soft, label, diff, off, cells, flip_ok)


def _paged_jobs(pb, data, panel_store, panel, lens, tag, axes):
    grid = {k: pb.GridAxis(values=[float(v) for v in vals])
            for k, vals in axes.items()}
    jobs = []
    for i, t in enumerate(lens):
        raw = data.to_wire_bytes(data.OHLCV(*(f[i, :t] for f in panel)))
        jobs.append(pb.JobSpec(
            id=f"{tag}-{i:04d}", strategy="sma_crossover", grid=grid,
            cost=COST, periods_per_year=252, ohlcv=raw,
            panel_digest=panel_store.panel_digest(raw),
            panel_bytes_len=len(raw)))
    return jobs


def _paged_backend(soft, kernels_mod, compute, pb, data, panel_store, wire,
                   n_jobs, bars, dev, card) -> None:
    """(c): sma jobs with digests through ``process`` on the paged route
    (``use_paged``, ``DBX_PAGED=1``'s) and on the dense stacks (the
    default), of mixed lengths and of one length; an append-extended
    digest, and a pool too small for the group."""
    axes = {"fast": FAST_AXIS, "slow": SLOW_AXIS}
    panel = data.synthetic_ohlcv(n_jobs, bars + STREAM_DT, seed=81)
    lens = _mixed_lengths(n_jobs, bars, seed=9)
    jobs = _paged_jobs(pb, data, panel_store, panel, lens, "pg", axes)
    # The uniform batch's panels share no page with the mixed batch's, so
    # the extension check below sees only its own pages.
    uniform = _paged_jobs(pb, data, panel_store,
                          data.synthetic_ohlcv(n_jobs, bars, seed=82),
                          np.full(n_jobs, bars), "pu", axes)

    def backend(paged: bool):
        b = compute.TorchSweepBackend(device=dev)
        b.use_paged = paged
        return b

    paged, dense = backend(True), backend(False)
    for batch, what in ((jobs, f"of 64..{bars} bars"),
                        (uniform, f"of {bars} bars")):
        blocks, times = {}, {"paged": [], "dense": []}
        for rep in range(4):
            for label, b in (("paged", paged), ("dense", dense)):
                _sync(dev)
                kernels_mod.reset_launch_counts()
                t0 = time.perf_counter()
                pend = b.submit(batch)
                done = b.collect(pend)
                times[label].append(time.perf_counter() - t0)
                k1 = kernels_mod.LAUNCHES["fused_sma"]
                if rep == 0:
                    blocks[label] = {c.job_id: c.metrics for c in done}
                    print(f"paged (c) {label}: {len(batch)} sma jobs {what}"
                          f" in {len(pend)} groups, K1 launched {k1} times,"
                          f" first batch {times[label][0]:.4f} s")
        how = _hold_blocks(soft, wire, f"paged (c) {what}: paged route vs "
                           "dense route", blocks["paged"], blocks["dense"],
                           flip_ok=False)
        print(f"paged (c) {what}: blocks, paged against dense: {how}; "
              "batches after the first: " + _secs("paged", times["paged"][1:])
              + "; " + _secs("dense", times["dense"][1:]) + f" ({card})")
        if batch is jobs:
            mixed = blocks["dense"]
    st = paged.stats()
    print(f"paged (c) pool {st['panel_cache']['page_pool']}; pad bars paged "
          f"{st['pad_bars']['paged']}, dense {dense.stats()['pad_bars']}")
    # An append-extended digest: each of the first jobs' panels extended
    # by STREAM_DT bars uploads at most ceil(dt / B) + 1 pages a panel.
    B = paged.panel_cache.pages.page_bars
    ext_lens = lens[:PAGED_APPEND_JOBS] + STREAM_DT
    ext = _paged_jobs(pb, data, panel_store, panel, ext_lens, "pgx", axes)
    misses = paged.panel_cache.pages.stats()["misses"]["close"]
    got = {c.job_id: c.metrics for c in paged.process(ext)}
    new = paged.panel_cache.pages.stats()["misses"]["close"] - misses
    bound = len(ext) * (-(-STREAM_DT // B) + 1)
    soft.check(new <= bound, f"paged (c): {len(ext)} extended "
               f"panels uploaded {new} pages, more than {bound}")
    how = _hold_blocks(soft, wire, "paged (c) extended panels",
                       got, {c.job_id: c.metrics for c in dense.process(ext)},
                       flip_ok=False)
    print(f"paged (c) append-extended: {len(ext)} panels + {STREAM_DT} bars "
          f"uploaded {new} pages (bound {bound}); against the dense route "
          f"{how}")
    # A pool with room for half the group's pages falls back dense.
    half = int((-(-lens // B)).sum()) // 2
    with _env(DBX_PAGE_POOL_MB=str(half * B * 4 / 2**20)):
        small = backend(True)
        cap = small.panel_cache.pages.capacity
    got = {c.job_id: c.metrics for c in small.process(jobs)}
    st = small.stats()
    soft.check(st["paged_fallbacks"]["rejected"] == 1
               and st["panel_cache"]["page_pool"]["rejects"] == 1,
               f"paged (c): a pool of {cap} pages did not reject the group "
               f"once: {st['paged_fallbacks']}")
    soft.check(got == mixed, "paged (c): the rejected group's blocks "
               "differ from the dense route's")
    print(f"paged (c) a pool of {cap} pages: group rejected and served "
          f"dense, counted {st['paged_fallbacks']}, blocks bit-equal")


def _scenario_phase(soft, kernels_mod, compute, fused, pb, data, panel_store,
                    synth, axes, k, bars, dev, card) -> dict:
    """(d): the generator and the scenario route. Returns the kernel
    launches of the fused scenario sweeps."""
    one = data.synthetic_ohlcv(1, bars, seed=920)
    base = data.OHLCV(*(f[0] for f in one))
    blob = data.to_wire_bytes(base)
    digest = panel_store.panel_digest(blob)
    p0 = synth.ScenarioParams(**{**SCENARIO_PARAMS, "n_bars": bars})
    soft.check(synth.scenario_panel_bytes(blob, p0, device=dev)
               == synth.scenario_panel_bytes(blob, p0, device=dev),
               "scenarios (d): one spec generated twice gave other bytes")
    specs = [synth.ScenarioParams(**{**SCENARIO_PARAMS, "n_bars": bars},
                                  seed=i) for i in range(k)]
    words = [synth.seed_words(synth.scenario_seed(digest, p)) for p in specs]
    gen = ([w[0] for w in words], [w[1] for w in words],
           [p.vol_scale for p in specs], [p.shock for p in specs])
    shape = dict(n_bars=bars, block=SCENARIO_PARAMS["block"],
                 regimes=SCENARIO_PARAMS["regimes"])
    _sync(dev)
    t0 = time.perf_counter()
    chunks = list(synth.generate_rows(base._asdict(), *gen, **shape,
                                      device=dev))
    _sync(dev)
    gen_s = time.perf_counter() - t0
    rows = {f: torch.cat([c[f] for _, c in chunks]) for f in synth.FIELDS}
    o, h, lo, c = (rows[f] for f in ("open", "high", "low", "close"))
    ok = bool(((h >= torch.maximum(o, c)) & (torch.minimum(o, c) >= lo)
               & (lo > 0) & torch.isfinite(h)).all())
    soft.check(ok, "scenarios (d): a generated bar breaks high >= max(open,"
               " close) >= min(open, close) >= low > 0")
    print(f"scenarios (d) generator: {k} panels x {bars} bars in "
          f"{len(chunks)} chunk(s) of <= "
          f"{synth.chunk_rows(bars, SCENARIO_PARAMS['block'])} rows, "
          f"{gen_s:.4f} s (first call); invariants hold: {ok}; one spec "
          "twice: the same bytes")
    host = {f: t.cpu().numpy() for f, t in rows.items()}
    runs = {}
    kernels_mod.reset_launch_counts()
    for strategy in sorted(fused._PAGED_FAMILIES):
        g = _flat_grid(axes[strategy])
        before = dict(kernels_mod.LAUNCHES)
        _sync(dev)
        t0 = time.perf_counter()
        m = fused.fused_scenario_sweep(strategy, base._asdict(), *gen, g,
                                       **shape, cost=COST, device=dev)
        _sync(dev)
        grew = {n: v - before.get(n, 0)
                for n, v in kernels_mod.LAUNCHES.items()}
        runs[strategy] = (m, g, time.perf_counter() - t0, grew)
    launches = dict(kernels_mod.LAUNCHES)
    for strategy, (m, g, fused_s, grew) in runs.items():
        fam = fused._PAGED_FAMILIES[strategy]
        fields, call = fam.fields, fam.call
        label = f"scenarios (d) {strategy}"
        entry = roofline.ENTRY[strategy]
        if dev.type == "cuda":
            soft.check(grew.get(entry, 0) == len(chunks),
                       f"{label}: {entry} launched {grew.get(entry, 0)} "
                       f"times for {len(chunks)} chunk(s)")
        # The dense wrapper on the materialized panels (on the host and
        # back, as the materialized rung's inline jobs), one launch of all
        # K rows: the fused route's row count where K is one chunk.
        want = call([host[f] for f in fields], g, cost=COST, device=dev)
        how = _hold_rows(soft, f"{label} vs the dense wrapper on the "
                         "materialized panels", m, want, len(chunks) > 1)
        print(f"{label}: {k} scenarios x {g[next(iter(g))].size} combos, "
              f"{entry} launched {grew.get(entry, 0)}; vs the materialized "
              f"panels {how}; {fused_s:.4f} s")
    # A carrier of K specs through process, on the fused route and on the
    # materialized rung.
    grid = {n: pb.GridAxis(values=[float(v) for v in vals])
            for n, vals in axes["sma_crossover"].items()}
    job = pb.JobSpec(id="scn-0000", strategy="sma_crossover", ohlcv=blob,
                     grid=grid, cost=COST, periods_per_year=252,
                     panel_digest=digest, panel_bytes_len=len(blob))
    for i, p in enumerate(specs):
        job.scenario_batch.add(
            base_digest=digest, n_bars=p.n_bars, block=p.block,
            regimes=p.regimes, vol_scale=p.vol_scale, shock=p.shock,
            seed=synth.seed_to_int64(synth.scenario_seed(digest, p)),
            id=f"scn-{i:04d}", trace_id=f"t{i}")
    out = {}
    for route in ("fused", "materialized"):
        with _env(DBX_SCENARIO_FUSED="1" if route == "fused" else "0"):
            backend = compute.TorchSweepBackend(device=dev)
            secs = []
            for _ in range(3):
                done, s = _timed(backend, [job])
                secs.append(s)
        n_route = backend.stats()["scenarios"]
        soft.check(n_route == {"fused": 0, "materialized": 0,
                               route: 3 * k},
                   f"scenarios (d) carrier, {route}: routes counted "
                   f"{n_route}")
        soft.check([c.job_id for c in done] == [f"scn-{i:04d}"
                                                for i in range(k)]
                   and all(c.metrics for c in done),
                   f"scenarios (d) carrier, {route}: not every spec "
                   "completed under its id")
        out[route] = [c.metrics for c in done]
        print(f"scenarios (d) carrier of {k} specs, {route}: {k} of {k} "
              f"served on the {route} route ({n_route}); "
              + _secs("process", secs) + f" ({card})")
    soft.check(out["fused"] == out["materialized"],
               "scenarios (d) carrier: the fused route's blocks differ from "
               "the materialized rung's")
    return launches


def phase_paged_scenarios(kernels_mod, compute, fused, pnl, pb, data, bench,
                          panel_store, wire, card: str, *, axes=AXES,
                          n: int = N_TICKERS, n_jobs: int = PAGED_JOBS,
                          k: int = SCENARIO_K, bars: int = N_BARS,
                          dev=torch.device("cuda")) -> tuple[dict, dict]:
    """Paged mode and scenario batches: (a) every family's paged sweep, (b)
    the bench's ``ragged_paged``, (c) the paged route of the backend, (d)
    the generator and the scenario route, and the bench's
    ``scenario_megakernel`` and ``scenario_sweep``. Returns the kernel
    launches of (a)'s paged sweeps and of (d)'s scenario sweeps."""
    from distributed_backtesting_exploration_tpu_torch.rpc import page_pool
    from distributed_backtesting_exploration_tpu_torch.scenarios import synth

    soft = _Soft()
    t0 = time.perf_counter()
    paged = _paged_families(soft, kernels_mod, compute, fused, pnl, data,
                            page_pool, n, bars, axes, dev)
    t_a = time.perf_counter()
    if dev.type == "cuda":
        out = bench.run(bench.Settings(configs=frozenset({"ragged_paged"})))
        print(f"paged (b) port bench ragged_paged: "
              f"{json.dumps(out['roofline']['ragged_paged'])} ({card})")
    t_b = time.perf_counter()
    _paged_backend(soft, kernels_mod, compute, pb, data, panel_store, wire,
                   n_jobs, bars, dev, card)
    t_c = time.perf_counter()
    scen = _scenario_phase(soft, kernels_mod, compute, fused, pb, data,
                           panel_store, synth, axes, k, bars, dev, card)
    if dev.type == "cuda":
        out = bench.run(bench.Settings(configs=frozenset(
            {"scenario_megakernel", "scenario_sweep"})))
        for name in ("scenario_megakernel", "scenario_sweep"):
            print(f"scenarios (d) port bench {name}: "
                  f"{json.dumps(out['roofline'][name])} ({card})")
    print(f"paged and scenario phase wall (s): (a) {t_a - t0:.1f}, (b) "
          f"{t_b - t_a:.1f}, (c) {t_c - t_b:.1f}, (d) "
          f"{time.perf_counter() - t_c:.1f}")
    soft.done()
    return paged, scen


# --- multiple devices: the mesh route, time sharding, two processes -------

def _bits_off(a: np.ndarray, b: np.ndarray) -> int:
    """Cells of two f32 arrays whose bits differ."""
    return int((np.ascontiguousarray(a, np.float32).view(np.int32)
                != np.ascontiguousarray(b, np.float32).view(np.int32)).sum())


def _pairs_three_ways(fused, data, dev, i: int = 123) -> dict:
    """One pair's K7 block computed three ways: alone, inside the 1000-pair
    bench stack, and inside a ragged stack (lengths 64..1260, the pair kept
    at its 1260 bars, as the backend's pairs group stacks them). Returns the
    cells of the pair's (9, 500) block whose bits differ from the block
    alone, by way."""
    y, x = (leg.close for leg in _pairs_legs(data, N_PAIRS, N_BARS, 1))
    g = _flat_grid(AXES["pairs"])

    def block(yy, xx, tr=None):
        m = fused.fused_pairs_sweep(yy, xx, g["lookback"], g["z_entry"],
                                    t_real=tr, cost=COST, device=dev)
        return torch.stack(list(m)).cpu().numpy()

    lens = np.random.default_rng(8).integers(64, N_BARS + 1, N_PAIRS)
    lens[i] = N_BARS
    ry, rx = y.copy(), x.copy()
    for leg in (ry, rx):
        for j, n in enumerate(lens):
            leg[j, n:] = leg[j, n - 1]
    alone = block(y[i:i + 1], x[i:i + 1])[:, 0]
    out = {"stack": _bits_off(block(y, x)[:, i], alone),
           "ragged": _bits_off(block(ry, rx, lens)[:, i], alone)}
    print(f"multi-device (a) pairs block of pair {i} against the block "
          f"alone, cells with other bits of {alone.size}: in the "
          f"{N_PAIRS}-pair stack {out['stack']}, in the ragged stack "
          f"{out['ragged']}")
    return out


MESH_SHARDS = 4
TS_BARS = 8192
LC_BARS = 65537
# Each time-sharded family's function, fields and one combo (the
# parameters of the CPU tests, tests/test_torch_timeshard.py).
TS_FAMILIES = {
    "sma_crossover": ("sharded_sma_backtest", ("close",),
                      {"fast": 5, "slow": 21}),
    "bollinger": ("sharded_bollinger_backtest", ("close",),
                  {"window": 20, "k": 1.5}),
    "bollinger_touch": ("sharded_bollinger_touch_backtest", ("close",),
                        {"window": 20, "k": 1.5}),
    "rsi": ("sharded_rsi_backtest", ("close",), {"period": 14, "band": 15.0}),
    "donchian": ("sharded_donchian_backtest", ("close",), {"window": 20}),
    "donchian_hl": ("sharded_donchian_hl_backtest", ("close", "high", "low"),
                    {"window": 20}),
    "stochastic": ("sharded_stochastic_backtest", ("close", "high", "low"),
                   {"window": 14, "band": 30.0}),
    "trix": ("sharded_trix_backtest", ("close",), {"span": 8, "signal": 5}),
    "momentum": ("sharded_momentum_backtest", ("close",), {"lookback": 20}),
    "keltner": ("sharded_keltner_backtest", ("close", "high", "low"),
                {"window": 20, "k": 1.5}),
    "vwap_reversion": ("sharded_vwap_backtest", ("close", "volume"),
                       {"window": 20, "k": 1.5}),
    "macd": ("sharded_macd_backtest", ("close",),
             {"fast": 12, "slow": 26, "signal": 9}),
    "obv_trend": ("sharded_obv_backtest", ("close", "volume"),
                  {"window": 20}),
}
# The reference's flip-aware families (tests/test_timeshard.py): at most 2
# series flipped, the rest at SHIFT_RTOL, SHIFT_ATOL.
TS_FLIP_AWARE = ("macd", "trix", "pairs")
SLICE_CHILD_S = 150


def _mesh_batches(pb, data) -> list:
    """Phase 9 (a)'s batches: each of the 13 single-asset families' 500
    jobs and 1000 pairs jobs of 1260 bars on its bench grid, and one
    ragged batch of vwap_reversion (lengths 64..1260, phase 8 (a)'s rule),
    as (label, strategy, jobs)."""
    out = [(s, s, _jobs(pb, data, s, AXES[s], _panels(
        data, s, N_PAIRS if s == "pairs" else N_TICKERS, 40 + k)))
        for k, s in enumerate(sorted([*FAMILIES, "sma_crossover"]))]
    lens = np.random.default_rng(8).integers(64, N_BARS + 1, N_TICKERS)
    panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=60)
    grid = {k: pb.GridAxis(values=[float(v) for v in vals])
            for k, vals in AXES["vwap_reversion"].items()}
    ragged = [pb.JobSpec(id=f"ragged-{i:04d}", strategy="vwap_reversion",
                         grid=grid, cost=COST, periods_per_year=252,
                         ohlcv=data.to_wire_bytes(data.OHLCV(
                             *(f[i, :n] for f in panel))))
              for i, n in enumerate(lens)]
    return out + [("ragged vwap_reversion", "vwap_reversion", ragged)]


def _phase9_mesh(kernels_mod, compute, sharding, pb, data, card) -> dict:
    """(a) The mesh route: every batch through a backend on a mesh of the
    card four times and through the meshless backend; every block
    bit-equal, each entry (and its table kernel) launched 4 times a group.
    Returns the launches of the mesh runs."""
    mesh = compute.TorchSweepBackend(mesh=sharding.make_mesh(
        ["cuda:0"] * MESH_SHARDS))
    _check(mesh.chips == 1, f"a mesh of one card advertises {mesh.chips}")
    one = compute.TorchSweepBackend(device="cuda")
    total: dict = {}
    for label, strategy, jobs in _mesh_batches(pb, data):
        entry = roofline.ENTRY[strategy]
        groups = len({len(j.ohlcv).bit_length() for j in jobs})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = {c.job_id: c.metrics for c in one.process(jobs)}
        one_s = time.perf_counter() - t0
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        got = {c.job_id: c.metrics for c in mesh.process(jobs)}
        mesh_s = time.perf_counter() - t0
        grew = dict(kernels_mod.LAUNCHES)
        for k, v in grew.items():
            total[k] = total.get(k, 0) + v
        _check(set(got) == set(want) == {j.id for j in jobs},
               f"mesh (a) {label}: completion ids differ")
        off = [j for j in want if got[j] != want[j]]
        _check(not off, f"mesh (a) {label}: {len(off)} of {len(want)} blocks "
               "not bit-equal to the meshless backend's")
        # Second batches of both, alternating: the first calls above carry
        # the allocator's growth.
        again = []
        for backend in (one, mesh):
            t0 = time.perf_counter()
            backend.process(jobs)
            again.append(time.perf_counter() - t0)
        need = {entry: MESH_SHARDS * groups}
        if strategy in TABLE_KERNELS:
            need[TABLE_KERNELS[strategy]] = MESH_SHARDS * groups
        for e, n in need.items():
            _check(grew.get(e, 0) == n, f"mesh (a) {label}: {e} launched "
                   f"{grew.get(e, 0)} times, {n} expected ({groups} groups)")
        print(f"multi-device (a) {label}: {len(jobs)} jobs, {groups} groups, "
              f"mesh of {MESH_SHARDS} shards launches {grew}; every block "
              f"bit-equal to the meshless backend's; meshless batch "
              f"{one_s:.4f}, {again[0]:.4f} s, mesh batch {mesh_s:.4f}, "
              f"{again[1]:.4f} s (first, second) ({card})")
    return total


def _ts_compare(got, want, flip_aware: bool) -> tuple[int, float]:
    """``(series flipped, the worst error of the rest against its
    tolerance)``: a series flips where a metric is off by more than 0.01 +
    1% (only under ``flip_aware``); the rest are held at SHIFT_RTOL,
    SHIFT_ATOL where ``flip_aware``, else at RTOL, ATOL."""
    a = {n: getattr(got, n).cpu().numpy().reshape(-1) for n in want._fields}
    b = {n: getattr(want, n).cpu().numpy().reshape(-1) for n in want._fields}
    rtol, atol = (SHIFT_RTOL, SHIFT_ATOL) if flip_aware else (RTOL, ATOL)
    flipped = np.zeros(a["sharpe"].shape, bool)
    if flip_aware:
        for n in a:
            flipped |= np.abs(a[n] - b[n]) > 0.01 + 0.01 * np.abs(b[n])
    worst = 0.0
    for n in a:
        err = np.abs(a[n] - b[n])[~flipped] / (
            atol + rtol * np.abs(b[n])[~flipped])
        worst = max(worst, float(err.max(initial=0.0)))
    return int(flipped.sum()), worst


def _ts_hold(label, got, want, flip_aware: bool) -> str:
    """The reference's rule (tests/test_timeshard.py): every series at
    RTOL, ATOL; for the flip-aware families at most 2 series flipped, the
    rest at SHIFT_RTOL, SHIFT_ATOL."""
    flips, worst = _ts_compare(got, want, flip_aware)
    _check(flips <= 2, f"{label}: {flips} series flipped")
    _check(worst <= 1.0, f"{label}: off tolerance ({worst:.3f} x its "
           "tolerance)")
    return f"{flips} flipped, worst {worst:.4f} x tolerance"


def _median_timed(fn, reps: int = 3):
    """(result, median seconds) of ``fn`` on the card."""
    secs, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, statistics.median(secs)


def _phase9_timeshard(kernels_mod, compute, sharding, timeshard, fused, pb,
                      data, card) -> None:
    """(b) The time-sharded primitives bit-equal to their single-device
    forms, the 14 families against the generic path, the reference bench's
    long_context three ways, and one 8201-bar momentum job through the
    backend's route."""
    from distributed_backtesting_exploration_tpu_torch import models
    from distributed_backtesting_exploration_tpu_torch.models import pairs
    from distributed_backtesting_exploration_tpu_torch.ops import (
        rolling, signals)
    from distributed_backtesting_exploration_tpu_torch.parallel import sweep

    dev = torch.device("cuda")
    four = sharding.make_mesh(["cuda:0"] * MESH_SHARDS,
                              axis_name=timeshard.TIME_AXIS)
    one = sharding.make_mesh(["cuda:0"], axis_name=timeshard.TIME_AXIS)
    x = torch.as_tensor(data.synthetic_ohlcv(4, TS_BARS, seed=2).close,
                        device=dev)
    _check(torch.equal(timeshard.sharded_cumsum(four, x),
                       rolling.prefix_sum(x)),
           "sharded_cumsum differs from prefix_sum")
    _check(torch.equal(timeshard.sharded_ema(four, x, span=20),
                       timeshard.sharded_ema(one, x, span=20)),
           "sharded_ema on 4 shards differs from 1 shard")
    z = (x - x.mean(dim=1, keepdim=True)) / x.std(dim=1, keepdim=True)
    valid = torch.arange(TS_BARS, device=dev) >= 19
    _check(torch.equal(
        timeshard.sharded_band_positions(four, z, valid, 1.0, 0.0),
        signals.band_hysteresis_assoc(z, valid, 1.0, 0.0)),
        "sharded_band_positions differ from band_hysteresis_assoc")
    print(f"multi-device (b) sharded_cumsum, sharded_ema and "
          f"sharded_band_positions on 4 x {TS_BARS} bars over "
          f"{MESH_SHARDS} shards: bit-equal to prefix_sum, a one-shard mesh's "
          f"EMA and band_hysteresis_assoc")
    panel = data.synthetic_ohlcv(4, TS_BARS, seed=9)
    fields = data.OHLCV(*(torch.as_tensor(f, device=dev) for f in panel))
    for strategy, (fn, cols, params) in TS_FAMILIES.items():
        got, ts_s = _median_timed(lambda: getattr(timeshard, fn)(
            four, *(getattr(fields, c) for c in cols), *params.values(),
            cost=COST))
        want, gen_s = _median_timed(lambda: sweep.run_sweep(
            fields, models.get_strategy(strategy),
            {k: np.float32([v]) for k, v in params.items()}, cost=COST,
            device=dev), reps=1)
        how = _ts_hold(f"multi-device (b) {strategy}", got, want,
                       strategy in TS_FLIP_AWARE)
        print(f"multi-device (b) {fn} 4 x {TS_BARS} bars {params}: vs the "
              f"generic sweep {how}; time-sharded {ts_s:.4f} s (median of "
              f"3), generic {gen_s:.4f} s (one run) ({card})")
    legs = data.synthetic_ohlcv(8, TS_BARS, seed=9).close
    y, xl = (torch.as_tensor(a, device=dev) for a in (legs[:4], legs[4:]))
    got, ts_s = _median_timed(lambda: timeshard.sharded_pairs_backtest(
        four, y, xl, 20, 1.2, cost=COST))
    want, gen_s = _median_timed(lambda: pairs.run_pairs_sweep(
        y, xl, {"lookback": np.float32([20]), "z_entry": np.float32([1.2])},
        cost=COST, device=dev), reps=1)
    how = _ts_hold("multi-device (b) pairs", got, want, True)
    print(f"multi-device (b) sharded_pairs_backtest 4 x {TS_BARS} bars "
          f"lookback 20 z_entry 1.2: vs the generic sweep {how}; "
          f"time-sharded {ts_s:.4f} s (median of 3), generic {gen_s:.4f} s "
          f"(one run) ({card})")

    # The reference bench's long_context three ways.
    lc = data.synthetic_ohlcv(1, LC_BARS, seed=7)
    grid = sweep.product_grid(fast=np.arange(5, 13, dtype=np.float32),
                              slow=np.arange(30, 70, 10, dtype=np.float32))
    combos = [(int(f), int(s)) for f, s in zip(grid["fast"], grid["slow"])]
    T_pad = -(-LC_BARS // MESH_SHARDS) * MESH_SHARDS
    padded = torch.as_tensor(np.concatenate(
        [lc.close, np.repeat(lc.close[:, -1:], T_pad - LC_BARS, 1)], 1),
        device=dev)
    lc_fields = data.OHLCV(*(torch.as_tensor(f, device=dev) for f in lc))

    def sharded():
        ms = [timeshard.sharded_sma_backtest(four, padded, f, s, cost=COST,
                                             t_real=LC_BARS)
              for f, s in combos]
        return type(ms[0])(*(torch.stack(c, dim=-1) for c in zip(*ms)))

    ts_m, ts_s = _median_timed(sharded)
    gen_m, gen_s = _median_timed(lambda: sweep.run_sweep(
        lc_fields, models.get_strategy("sma_crossover"), grid, cost=COST,
        device=dev))
    kernels_mod.reset_launch_counts()
    k1_m, k1_s = _median_timed(lambda: fused.fused_sma_sweep(
        lc_fields.close, grid["fast"].numpy(), grid["slow"].numpy(),
        cost=COST, device=dev))
    _check(kernels_mod.LAUNCHES["fused_sma"] == 3, "long_context: K1 not "
           "launched")
    for m in (ts_m, gen_m, k1_m):
        _check(tuple(m.sharpe.shape) == (1, len(combos))
               and bool(torch.isfinite(m.sharpe).all()),
               "long_context: a route's sharpe is not finite (1, 32)")
    # The closes reach ~4.9e6 over 65537 bars: their f64 prefix sums are
    # not exact in every order, so the blocks' bits are counted, not held.
    cs_off = _bits_off(
        timeshard.sharded_cumsum(four, padded)[:, :LC_BARS].cpu().numpy(),
        rolling.prefix_sum(lc_fields.close).cpu().numpy())
    how_g = _ts_hold("long_context time-sharded vs generic", ts_m, gen_m,
                     False)
    how_k = _ts_hold("long_context time-sharded vs K1", ts_m, k1_m, False)
    print(f"multi-device (b) long_context 1 x {LC_BARS} bars x "
          f"{len(combos)} combos: time-sharded over {MESH_SHARDS} shards "
          f"{ts_s:.4f} s, generic sweep {gen_s:.4f} s, fused K1 sweep "
          f"{k1_s:.4f} s (medians of 3); prefix sums with other bits than "
          f"the whole row's: {cs_off} of {LC_BARS}; time-sharded vs generic "
          f"{how_g}, vs K1 {how_k} ({card})")

    # One 8201-bar momentum job through the backend's route.
    mom = data.synthetic_ohlcv(1, 8201, seed=150)
    axes = {"lookback": np.float32([20.0, 60.0])}
    jobs = _jobs(pb, data, "momentum", axes, (mom,))
    mesh_backend = compute.TorchSweepBackend(mesh=sharding.make_mesh(
        ["cuda:0"] * MESH_SHARDS))
    kernels_mod.reset_launch_counts()
    got = mesh_backend.process(jobs)
    routed = dict(kernels_mod.LAUNCHES)
    want = compute.TorchSweepBackend(device="cuda").process(jobs)
    _check(routed.get("momentum", 0) == 0, "the 8201-bar job launched K3: "
           "it did not take the time-sharded route")
    wire = compute.wire
    how = _ts_hold("multi-device (b) 8201-bar momentum job",
                   _metrics_on(wire, got[0].metrics),
                   _metrics_on(wire, want[0].metrics), True)
    print(f"multi-device (b) one 8201-bar momentum job (lookbacks 20, 60) "
          f"through the mesh backend's time-sharded route: vs the meshless "
          f"backend (K3) {how}")


def _metrics_on(wire, blob):
    m = wire.metrics_from_bytes(blob)
    return type(m)(*(torch.from_numpy(np.asarray(f)) for f in m))


def _slice_child(rank: int, port: int, out: str) -> None:
    """(c)'s process ``rank`` of two: a gloo group, a mesh of the card
    twice, ``host_shard``, the sharded sweep of its share of a 64-ticker
    panel gathered on rank 0, then one ``run`` and one ``run_ts`` round of
    the slice. Rank 0 holds every result against one process and writes
    ``out``."""
    from distributed_backtesting_exploration_tpu_torch import models
    from distributed_backtesting_exploration_tpu_torch.parallel import (
        multihost, sharding, sweep)
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        backtesting_pb2 as pb, compute, slice_worker)
    from distributed_backtesting_exploration_tpu_torch.utils import data

    report = {"rank": rank}
    try:
        n = multihost.initialize(f"tcp://127.0.0.1:{port}", world_size=2,
                                 rank=rank)
        mine = multihost.host_shard(64)
        report["world"], report["shard"] = n, [mine.start, mine.stop]
        mesh = sharding.make_mesh(["cuda:0"] * 2)
        panel = data.synthetic_ohlcv(64, N_BARS, seed=3)
        strategy = models.get_strategy("sma_crossover")
        grid = sweep.product_grid(fast=FAST_AXIS, slow=SLOW_AXIS)
        m = sharding.sharded_sweep(mesh, data.OHLCV(*(f[mine]
                                                      for f in panel)),
                                   strategy, grid, cost=COST)
        parts = slice_worker._gather(torch.stack(list(m)).cpu().numpy())
        runner = slice_worker.SliceRunner(mesh)
        mom = data.synthetic_ohlcv(1, 8201, seed=150)
        rounds = [("sma_crossover", {"fast": FAST_AXIS, "slow": SLOW_AXIS},
                   panel, 10),
                  ("momentum", {"lookback": np.float32([20.0, 60.0])}, mom,
                   1)]
        blocks = []
        for name, axes, src, k in rounds:
            msg = arrays = None
            if rank == 0:
                msg, arrays = slice_worker.group_message(
                    name, axes, float(np.float32(COST)), 252,
                    [data.OHLCV(*(f[i] for f in src)) for i in range(k)],
                    runner)
            hdr, got = runner.round(msg, arrays)
            blocks.append((hdr["op"], got))
        runner.round(slice_worker.STOP if rank == 0 else None)
        if rank == 0:
            one = sweep.run_sweep(panel, strategy, grid, cost=COST,
                                  device="cuda")
            report["sweep_bit_equal"] = bool(np.array_equal(
                np.concatenate(parts, axis=1),
                torch.stack(list(one)).cpu().numpy()))
            backend = compute.TorchSweepBackend(mesh=mesh)
            report["rounds"] = []
            for (op, got), (name, axes, src, k) in zip(blocks, rounds):
                want = backend.process(_jobs(pb, data, name, axes, (
                    data.OHLCV(*(f[:k] for f in src)),)))
                report["rounds"].append(
                    [op, got == [c.metrics for c in want]])
            report["chips"], report["shards"] = runner.chips, runner.shards
        report["ok"] = True
    finally:
        if rank == 0 or not report.get("ok"):
            Path(f"{out}.{rank}").write_text(json.dumps(report))


def _phase9_processes(card) -> None:
    """(c) Two processes on the card (spawned: CUDA does not survive a
    fork), each with a gloo group and a mesh of the card twice; each child
    has SLICE_CHILD_S seconds and is killed at them."""
    import multiprocessing as mp
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(prefix="dbx-slice-"), "report")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_slice_child, args=(r, port, out))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SLICE_CHILD_S
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    _check(not hung, f"multi-device (c): {len(hung)} process(es) did not "
           f"finish in {SLICE_CHILD_S} s")
    _check(all(p.exitcode == 0 for p in procs), f"multi-device (c): exit "
           f"codes {[p.exitcode for p in procs]}")
    report = json.loads(Path(f"{out}.0").read_text())
    _check(report.get("ok") and report["world"] == 2
           and report["shard"] == [0, 32], f"multi-device (c): {report}")
    _check(report["sweep_bit_equal"], "multi-device (c): the two-process "
           "sweep differs from one process's")
    _check(report["rounds"] == [["run", True], ["run_ts", True]],
           f"multi-device (c): rounds {report['rounds']}")
    print(f"multi-device (c) two processes on the card (gloo, a mesh of "
          f"the card twice each): initialize 2, host_shard(64) of rank 0 "
          f"{report['shard']}; the sharded sweep of 64 x {N_BARS} bars x "
          f"{FAST_AXIS.size * SLOW_AXIS.size} combos bit-equal to one "
          f"process's; a run round (10 sma_crossover jobs) and a run_ts round "
          f"(one 8201-bar momentum job) bit-equal to the single-host "
          f"backend's; the slice advertises {report['chips']} chip(s), "
          f"{report['shards']} shards; {time.perf_counter() - t0:.1f} s "
          f"({card})")


def phase_multi_device(kernels_mod, compute, fused, pb, data, card) -> dict:
    """Phase 9, multiple devices on the one card: (a) the mesh route, (b)
    the time-sharded route and primitives, (c) two processes. Returns the
    kernel launches of (a)'s mesh runs."""
    from distributed_backtesting_exploration_tpu_torch.parallel import (
        sharding, timeshard)

    t0 = time.perf_counter()
    _pairs_three_ways(fused, data, torch.device("cuda"))
    launches = _phase9_mesh(kernels_mod, compute, sharding, pb, data, card)
    t_a = time.perf_counter()
    _phase9_timeshard(kernels_mod, compute, sharding, timeshard, fused, pb,
                      data, card)
    t_b = time.perf_counter()
    _phase9_processes(card)
    print(f"multi-device phase wall (s): (a) {t_a - t0:.1f}, (b) "
          f"{t_b - t_a:.1f}, (c) {time.perf_counter() - t_b:.1f}")
    return launches


# --- tuning: the autotuner on the tile families, the compile cache ----------

TUNE_FAMILIES = ("sma_crossover", "bollinger", "macd", "trix", "obv_trend",
                 "pairs")
# Phase 10 (b)'s library: built cold, exchanged, loaded without nvcc.
TUNE_LIB = "ema_rows"


def _timed_batches(backends, jobs, reps: int = 3) -> list:
    """The median wall of ``reps`` ``process`` calls of each backend on
    ``jobs``, after one untimed call of each (a backend's first contact
    with a bucket may tune it), the backends alternating and each round
    led by the other one than the round before."""
    for b in backends:
        b.process(jobs)
    secs = [[] for _ in backends]
    for r in range(reps):
        order = list(enumerate(backends))
        for i, b in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            b.process(jobs)
            secs[i].append(time.perf_counter() - t0)
    return [statistics.median(x) for x in secs]


def _phase10_autotune(kernels_mod, compute, fused, obs, tune, pb, data,
                      sched_dir, card) -> dict:
    """(a) The autotuner on the six tile families' main-path batches.
    Returns the launches of the tuned backend's first batches."""
    reg = obs.get_registry()
    batches = {s: _jobs(pb, data, s, AXES[s], _panels(
        data, s, N_PAIRS if s == "pairs" else N_TICKERS, 70 + k))
        for k, s in enumerate(TUNE_FAMILIES)}
    with _env(DBX_AUTOTUNE="0", DBX_SCHEDULE_DIR=None):
        plain = compute.TorchSweepBackend(device="cuda")
        want = {s: {c.job_id: c.metrics for c in plain.process(jobs)}
                for s, jobs in batches.items()}
    cap = torch.cuda.get_device_capability(0)
    total: dict = {}
    with _env(DBX_AUTOTUNE="1", DBX_AUTOTUNE_REPS="3",
              DBX_SCHEDULE_DIR=sched_dir, DBX_LANES_CAP=None):
        tuned = compute.TorchSweepBackend(device="cuda")
        platform = f"torch-cuda-sm{cap[0]}{cap[1]}"
        _check(tuned.platform == platform, f"tune (a): platform "
               f"{tuned.platform}, the card's is {platform}")
        winners = {}
        for s, jobs in batches.items():
            entry = roofline.ENTRY[s]
            axes = _flat_grid(AXES[s])
            n_combos = len(next(iter(axes.values())))
            bucket = tune.group_bucket(N_BARS, n_combos, len(jobs))
            before = reg.peek("dbx_autotune_trials_total", family=s) or 0.0
            kernels_mod.reset_launch_counts()
            t0 = time.perf_counter()
            got = {c.job_id: c.metrics for c in tuned.process(jobs)}
            first_s = time.perf_counter() - t0
            grew = dict(kernels_mod.LAUNCHES)
            for k, v in grew.items():
                total[k] = total.get(k, 0) + v
            trials = (reg.peek("dbx_autotune_trials_total", family=s)
                      or 0.0) - before
            winner = tuned.schedule_registry.lookup(s, bucket, platform)
            _check(trials > 0, f"tune (a) {s}: no autotune trial counted")
            _check(grew.get(entry, 0) > 0, f"tune (a) {s}: {entry} launched "
                   "no time")
            _check(winner is not None, f"tune (a) {s}: no winner recorded "
                   f"under {platform} {bucket}")
            _check(set(got) == set(want[s]) == {j.id for j in jobs},
                   f"tune (a) {s}: completion ids differ")
            off = [j for j in got if got[j] != want[s][j]]
            _check(not off, f"tune (a) {s}: {len(off)} of {len(got)} blocks "
                   "not bit-equal to the untuned backend's")
            default_s, tuned_s = _timed_batches((plain, tuned), jobs)
            entry_rec = [e for e in tuned.schedule_registry.entries()
                         if (e["family"], e["bucket"], e["platform"])
                         == (s, bucket, platform)][0]
            n_rows = len(jobs)
            prior = dict(n_bars=N_BARS, n_combos=n_combos, n_rows=n_rows,
                         grid=axes)
            incumbent = tune.autotune.default_substrates(s)
            modeled = (tune.modeled_cost(s, incumbent, **prior)
                       / tune.modeled_cost(s, winner, **prior))
            winners[s] = (bucket, winner)
            cap = int(winner.get("lanes_cap", "0"))
            shipped = fused.shipped_lanes(s)
            print(f"tune (a) {s}: {n_rows} jobs x {n_combos} combos, bucket "
                  f"{bucket}, winner {winner} ({entry_rec['trials']} trials, "
                  f"best {entry_rec['best_us']} us a sweep; width "
                  f"{min(shipped, cap) if cap else shipped} of {shipped}), "
                  f"{int(trials)} trials counted; first batch {first_s:.4f} "
                  f"s with the tuning; default {default_s:.4f} s, tuned "
                  f"{tuned_s:.4f} s a batch (medians of 3): measured "
                  f"{default_s / tuned_s:.4f}x, modeled {modeled:.4f}x; "
                  f"launches {grew}; every block bit-equal to the untuned "
                  f"backend's ({card})")
        reopened = tune.ScheduleRegistry.open_default()
    for s, (bucket, winner) in winners.items():
        _check(reopened.lookup(s, bucket, platform) == winner,
               f"tune (a) {s}: the reopened journal holds "
               f"{reopened.lookup(s, bucket, platform)}, not {winner}")
    print(f"tune (a): {len(winners)} winners in the journal under "
          f"{platform}, the same after reopening it "
          f"({len(reopened)} entries, {reopened.corrupt_entries} corrupt)")
    return total


def _phase10_compile_cache(kernels_mod, tune, fused, data, root, card):
    """(b) One library built cold, offered to a store, installed by a
    second sync and loaded with nvcc unreachable; its kernel bit-equal to
    the plain version."""
    a, b, empty = (os.path.join(root, d) for d in ("a", "b", "no-cuda"))
    os.makedirs(empty)
    store = tune.CompileStore()
    sync_a = tune.CacheSync(a)
    prior_dir, prior_nvcc = kernels_mod.BUILD_DIR, kernels_mod._nvcc
    prior_lib = kernels_mod._LIBS.pop(TUNE_LIB, None)
    try:
        kernels_mod.BUILD_DIR = Path(a)
        t0 = time.perf_counter()
        built = kernels_mod.build(TUNE_LIB)
        ctypes.CDLL(str(built))
        cold_s = time.perf_counter() - t0
        offers = sync_a.poll_new()
        _check([o[1] for o in offers] == [built.name], f"tune (b): offers "
               f"{[o[1] for o in offers]}, built {built.name}")
        _check(all(store.offer(*o) for o in offers), "tune (b): the store "
               "refused the offer")
        t0 = time.perf_counter()
        sync_b = tune.CacheSync(b)
        miss = sync_b.missing(store.keys())
        installed = sync_b.install((k, *store.get(k)) for k in miss)
        install_s = time.perf_counter() - t0
        _check(installed == 1, f"tune (b): {installed} entries installed")

        def no_nvcc():
            raise RuntimeError("nvcc is unreachable in this check")

        with _env(CUDA_HOME=empty, CUDA_PATH=None, PATH=empty):
            _check(shutil.which("nvcc") is None, "tune (b): nvcc on PATH")
            kernels_mod._nvcc = no_nvcc
            kernels_mod.BUILD_DIR = Path(b)
            t0 = time.perf_counter()
            lib = kernels_mod.ema_rows_lib()
            load_s = time.perf_counter() - t0
            _check(Path(lib._name).parent == Path(b), f"tune (b): loaded "
                   f"{lib._name}, not the installed library")
            dev = torch.device("cuda")
            close = torch.as_tensor(data.synthetic_ohlcv(
                N_TICKERS, N_BARS, seed=0).close, device=dev).contiguous()
            spans = np.unique(AXES["trix"]["span"])
            kernels_mod.reset_launch_counts()
            got = fused.ema_rows_cuda(close, fused.ema_decay(dev, spans), 3)
            want = fused.trix_ema_table(close, spans)
            torch.cuda.synchronize()
            _check(kernels_mod.LAUNCHES.get(TUNE_LIB, 0) == 1,
                   "tune (b): the installed kernel launched no time")
            _check(_bits_equal(got, want), "tune (b): the installed "
                   "library's kernel is not bit-equal to trix_ema_table")
    finally:
        kernels_mod._nvcc = prior_nvcc
        kernels_mod.BUILD_DIR = prior_dir
        if prior_lib is not None:
            kernels_mod._LIBS[TUNE_LIB] = prior_lib
        else:
            kernels_mod._LIBS.pop(TUNE_LIB, None)
    warm_s = install_s + load_s
    print(f"tune (b): {built.name} ({built.stat().st_size} bytes) cold "
          f"(nvcc into an empty directory and load) {cold_s:.4f} s; "
          f"fleet-warm (install from the store {install_s:.4f} s + load "
          f"with nvcc unreachable {load_s:.4f} s) {warm_s:.4f} s "
          f"({cold_s / warm_s:.1f}x); the kernel on trix's {N_TICKERS}x"
          f"{N_BARS} table bit-equal to trix_ema_table ({card})")


def phase_tune(kernels_mod, compute, fused, pb, data, card) -> dict:
    """Phase 10, tuning: (a) the autotuner on the tile families' batches,
    (b) the compile cache. Returns (a)'s launches."""
    from distributed_backtesting_exploration_tpu_torch import obs, tune

    root = tempfile.mkdtemp(prefix="dbx-tune-")
    try:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, "schedule"))
        launches = _phase10_autotune(kernels_mod, compute, fused, obs, tune,
                                     pb, data, os.path.join(root, "schedule"),
                                     card)
        t_a = time.perf_counter()
        _phase10_compile_cache(kernels_mod, tune, fused, data, root, card)
        print(f"tune phase wall (s): (a) {t_a - t0:.1f}, (b) "
              f"{time.perf_counter() - t_a:.1f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# Phase 11: the dispatch loop. Phase 4's panel and grid as JobRecords with
# explicit ids; the stream and scenario sizes of parts (d) and (e).
LOOP_JOBS_PER_CHIP = 100
LOOP_POLL_S = 0.005
STREAMS, STREAM_ROUNDS = 8, 2
LOOP_SCENARIOS = 64


def _loop_records(dispatcher, data, panel, prefix: str, **kw) -> list:
    grid = {"fast": FAST_AXIS, "slow": SLOW_AXIS}
    return [dispatcher.JobRecord(
        id=f"{prefix}-{i:04d}", strategy="sma_crossover", grid=grid,
        cost=COST, ohlcv=data.to_wire_bytes(data.OHLCV(*(f[i]
                                                         for f in panel))),
        **kw) for i in range(panel.close.shape[0])]


def _loop_specs(pb, wire, recs) -> list:
    """The JobSpecs of ``recs`` as ``TorchSweepBackend.process`` takes
    them directly."""
    return [pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                       grid=wire.grid_to_proto(r.grid), cost=r.cost,
                       periods_per_year=252, top_k=r.top_k,
                       rank_metric=r.rank_metric) for r in recs]


def _loop_blocks(results_dir: str, recs) -> dict:
    """The dispatcher's stored block of each of ``recs`` (every kind of
    block is stored as ``<id>.dbxm``)."""
    out = {}
    for r in recs:
        path = os.path.join(results_dir, f"{r.id}.dbxm")
        _check(os.path.exists(path), f"dispatch loop: no block for {r.id}")
        with open(path, "rb") as fh:
            out[r.id] = fh.read()
    return out


def _hold_loop_blocks(label, got: dict, want: dict,
                      against: str = "the direct backend") -> None:
    """Every block of ``got`` bit-equal to ``want``'s block at the same
    position (``want`` holds the same jobs in the same order)."""
    _check(len(got) == len(want), f"{label}: {len(got)} blocks, "
           f"{len(want)} wanted")
    off = [g for (g, a), b in zip(got.items(), want.values()) if a != b]
    _check(not off, f"{label}: {len(off)} blocks not bit-equal to "
           f"{against} (first {off[:3]})")
    print(f"{label}: {len(got)} blocks bit-equal to {against}")


def _device_busy_s(trace_path: str) -> tuple:
    """(seconds, events): the union of the card's kernel, copy and set
    intervals in a ``torch.profiler`` Chrome trace, and how many there
    were."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, len(spans)


def _rpc_medians(disp) -> dict:
    return {m: h.summary().get("p50", 0.0)
            for m, h in disp._h_rpc.items() if h.count}


def _rpc_totals(disp) -> dict:
    """Each RPC's handler calls and seconds in all (``dbx_rpc_seconds``)."""
    return {m: [h.count, round(h.sum, 6)]
            for m, h in disp._h_rpc.items() if h.count}


def _timed_backend(compute):
    """The port's backend, adding the seconds of each ``process`` call
    (the serial executor's one call a batch) to ``process_s``."""
    class Timed(compute.TorchSweepBackend):
        process_s = 0.0

        def process(self, jobs):
            t0 = time.perf_counter()
            try:
                return super().process(jobs)
            finally:
                self.process_s += time.perf_counter() - t0

    return Timed(device="cuda")


def _loop_main(kernels_mod, compute, pb, wire, data, bench, journal_mod,
               root, card) -> tuple:
    """Parts (a), (b), (c) and (a'): one dispatcher and one worker, four
    drains. Returns (the blocks of (a), K1's launches in the drains)."""
    from distributed_backtesting_exploration_tpu_torch.obs import trace
    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher

    panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7)
    recs_a = _loop_records(dispatcher, data, panel, "a")
    recs_b = _loop_records(dispatcher, data, panel, "b")
    recs_c = _loop_records(dispatcher, data, panel, "c", top_k=TOP_K,
                           rank_metric="sharpe")
    recs_p = _loop_records(dispatcher, data,
                           data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=8),
                           "p")
    prof_dir = os.path.join(root, "profile")
    n_combos = FAST_AXIS.size * SLOW_AXIS.size
    jp = os.path.join(root, "a.jsonl")
    res = os.path.join(root, "res-a")
    launches = 0
    backend = _timed_backend(compute)
    with bench.DispatchLoop([backend],
                            device="cuda", jobs_per_chip=LOOP_JOBS_PER_CHIP,
                            poll_interval_s=LOOP_POLL_S, journal=jp,
                            results_dir=res) as loop:
        disp = loop.dispatcher
        digest_only = disp._c_payloads["digest_only"]
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        loop.drain(recs_a)
        wall_a = time.perf_counter() - t0
        k1_a = kernels_mod.LAUNCHES["fused_sma"]
        _check(k1_a > 0, "dispatch loop (a): fused_sma launched no time")
        launches += k1_a
        wire_a, batches_a = loop.wire_bytes(), loop.batches
        rpc_a, totals_a = _rpc_medians(disp), _rpc_totals(disp)
        enqueue_a, process_a = loop.enqueue_s, backend.process_s
        d0 = digest_only.value
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        loop.drain(recs_b)
        wall_b = time.perf_counter() - t0
        launches += kernels_mod.LAUNCHES["fused_sma"]
        d_only = int(digest_only.value - d0)
        _check(d_only == len(recs_b), f"dispatch loop (b): {d_only} "
               f"digest-only legs, {len(recs_b)} wanted")
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        loop.drain(recs_c)
        wall_c = time.perf_counter() - t0
        launches += kernels_mod.LAUNCHES["fused_sma"]
        wire_all = loop.wire_bytes()
        kernels_mod.reset_launch_counts()
        with trace.device_profile(prof_dir):
            t0 = time.perf_counter()
            loop.drain(recs_p)
            wall_p = time.perf_counter() - t0
        launches += kernels_mod.LAUNCHES["fused_sma"]
    busy_p, n_dev = _device_busy_s(os.path.join(prof_dir, "trace.json"))
    print(f"dispatch loop (a): {len(recs_a)} sma jobs x {n_combos} combos x "
          f"{N_BARS} bars through the port's dispatcher over loopback gRPC "
          f"and one port worker (jobs_per_chip={LOOP_JOBS_PER_CHIP}, poll "
          f"{LOOP_POLL_S} s): drain {wall_a:.4f} s, "
          f"{len(recs_a) / wall_a:.1f} jobs/s, "
          f"{len(recs_a) * n_combos / wall_a:.4e} backtests/s, "
          f"{batches_a} RequestJobs batches, K1 launches {k1_a}, "
          f"worker wire bytes a job {wire_a / len(recs_a):.1f} "
          f"(RequestJobs + CompleteJobs + FetchPayload, serialized), "
          f"median dbx_rpc_seconds by method {json.dumps(rpc_a)} "
          f"[{card}]")
    print(f"dispatch loop (a) attribution: enqueue (journal appends "
          f"included) {enqueue_a:.4f} s, the backend's process calls "
          f"{process_a:.4f} s, handler [calls, seconds] by RPC "
          f"{json.dumps(totals_a)}, of a {wall_a:.4f} s drain")
    print(f"dispatch loop (b): the same panels digest-only ({d_only} legs): "
          f"drain {wall_b:.4f} s, {len(recs_b) / wall_b:.1f} jobs/s; "
          f"(c) top-{TOP_K} by sharpe: drain {wall_c:.4f} s, "
          f"{len(recs_c) / wall_c:.1f} jobs/s; worker wire bytes a job "
          f"over (a)-(c) {wire_all / (3 * len(recs_a)):.1f} [{card}]")
    if n_dev:
        print(f"dispatch loop (a'): {len(recs_p)} jobs like (a) on another "
              f"panel under torch.profiler: drain {wall_p:.4f} s, the card "
              f"busy {busy_p:.6f} s in {n_dev} kernel, copy and set "
              f"intervals (their union), {100 * busy_p / wall_p:.4f}% of "
              f"the drain, idle {100 * (1 - busy_p / wall_p):.4f}% "
              f"[{card}]")
    else:
        print(f"dispatch loop (a'): drain {wall_p:.4f} s under "
              f"torch.profiler; the card's busy share not measured: the "
              f"trace holds no device interval [{card}]")
    st = journal_mod.Journal.replay(jp)
    done = len(recs_a) + len(recs_b) + len(recs_c) + len(recs_p)
    _check(len(st.completed) == done and not st.pending and not st.failed,
           f"dispatch loop: the journal replays to {len(st.completed)} "
           f"completed, {len(st.pending)} pending, {len(st.failed)} failed")
    print(f"dispatch loop: journal replays to {len(st.completed)} completed,"
          f" 0 pending")
    direct = compute.TorchSweepBackend(device="cuda")
    blocks_a = _loop_blocks(res, recs_a)
    want_a = {c.job_id: c.metrics for c in
              direct.process(_loop_specs(pb, wire, recs_a))}
    _hold_loop_blocks("dispatch loop (a)", blocks_a, want_a)
    _hold_loop_blocks("dispatch loop (b)", _loop_blocks(res, recs_b),
                      blocks_a, "(a)'s")
    want_c = {c.job_id: c.metrics for c in
              direct.process(_loop_specs(pb, wire, recs_c))}
    _hold_loop_blocks("dispatch loop (c)", _loop_blocks(res, recs_c), want_c)
    want_p = {c.job_id: c.metrics for c in
              direct.process(_loop_specs(pb, wire, recs_p))}
    _hold_loop_blocks("dispatch loop (a')", _loop_blocks(res, recs_p),
                      want_p)
    return blocks_a, launches


def _loop_streams(kernels_mod, compute, pb, wire, data, bench, service,
                  root, card):
    """Part (d): eight sma streams built cold through the loop, then
    ``STREAM_ROUNDS`` AppendBars rounds of 16 bars each; every block
    bit-equal to a fresh backend given the worker's batches in order."""
    import grpc

    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher

    class Recording(compute.TorchSweepBackend):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.batches = []

        def submit(self, jobs):
            copies = []
            for j in jobs:
                c = pb.JobSpec()
                c.CopyFrom(j)
                copies.append(c)
            self.batches.append(copies)
            return super().submit(jobs)

    full = data.synthetic_ohlcv(STREAMS, N_BARS + STREAM_ROUNDS * STREAM_DT,
                                seed=17)
    cold = _loop_records(dispatcher, data, data.OHLCV(
        *(f[:, :N_BARS] for f in full)), "d")
    backend = Recording(device="cuda")
    res = os.path.join(root, "res-d")
    tmpl = pb.JobSpec(strategy="sma_crossover",
                      grid=wire.grid_to_proto({"fast": FAST_AXIS,
                                               "slow": SLOW_AXIS}),
                      cost=COST, periods_per_year=252)
    kernels_mod.reset_launch_counts()
    ids = [r.id for r in cold]
    t0 = time.perf_counter()
    with bench.DispatchLoop([backend], device="cuda",
                            jobs_per_chip=LOOP_JOBS_PER_CHIP,
                            poll_interval_s=LOOP_POLL_S,
                            results_dir=res) as loop:
        loop.drain(cold)
        channel = grpc.insecure_channel(
            f"localhost:{loop.server.port}",
            options=service.default_channel_options())
        stub = service.DispatcherStub(channel)
        heads = {r.id: (r.panel_digest, N_BARS) for r in cold}
        try:
            for k in range(STREAM_ROUNDS):
                lo = N_BARS + k * STREAM_DT
                for i, r in enumerate(cold):
                    dig, n = heads[r.id]
                    delta = data.to_wire_bytes(data.OHLCV(
                        *(f[i, lo:lo + STREAM_DT] for f in full)))
                    reply = stub.AppendBars(pb.AppendRequest(
                        worker_id="feed", panel_digest=dig, base_len=n,
                        delta=delta, job=tmpl), timeout=30.0)
                    _check(reply.ok, f"dispatch loop (d): AppendBars "
                           f"refused: {reply.detail}")
                    heads[r.id] = (reply.panel_digest, reply.new_len)
                    ids.append(reply.job_id)
                deadline = time.monotonic() + 300.0
                while not loop.queue.drained:
                    _check(time.monotonic() < deadline,
                           f"dispatch loop (d): appends wedged "
                           f"{loop.queue.stats()}")
                    time.sleep(0.002)
        finally:
            channel.close()
    wall = time.perf_counter() - t0
    launches = dict(kernels_mod.LAUNCHES)
    got = {}
    for jid in ids:
        with open(os.path.join(res, f"{jid}.dbxm"), "rb") as fh:
            got[jid] = fh.read()
    fresh = compute.TorchSweepBackend(device="cuda")
    want = {}
    for batch in backend.batches:
        want.update((c.job_id, c.metrics) for c in fresh.process(batch))
    _check(set(want) == set(got), "dispatch loop (d): the worker's batches "
           "are not the jobs that completed")
    _hold_loop_blocks("dispatch loop (d)", got, {j: want[j] for j in got})
    _check(backend.appends == fresh.appends, f"dispatch loop (d): append "
           f"routes {backend.appends} against {fresh.appends} direct")
    _check(backend.appends.get("carry_hit", 0) > 0,
           f"dispatch loop (d): no carry hit ({backend.appends})")
    print(f"dispatch loop (d): {STREAMS} sma streams cold, then "
          f"{STREAM_ROUNDS} AppendBars rounds of {STREAM_DT} bars: "
          f"{len(ids)} jobs in {wall:.4f} s, appends {backend.appends}, "
          f"launches {launches} [{card}]")
    return launches


def _loop_scenarios(kernels_mod, compute, data, bench, root, card):
    """Part (e): one base panel and ``LOOP_SCENARIOS`` specs, drained on
    the worker's spec-batch route and on the materialized rung (the
    dispatcher generates each panel on the card); the rungs' blocks
    bit-equal, the panel store holding 1 and 1 + LOOP_SCENARIOS panels."""
    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher

    base_panel = data.synthetic_ohlcv(1, N_BARS, seed=920)
    (base,) = _loop_records(dispatcher, data, base_panel, "e-base")
    blocks, launches = {}, {}
    for fused_on in ("1", "0"):
        res = os.path.join(root, f"res-e{fused_on}")
        with _env(DBX_SCENARIO_FUSED=fused_on):
            kernels_mod.reset_launch_counts()
            t0 = time.perf_counter()
            with bench.DispatchLoop(
                    [compute.TorchSweepBackend(device="cuda")],
                    device="cuda", jobs_per_chip=LOOP_SCENARIOS + 1,
                    poll_interval_s=LOOP_POLL_S, results_dir=res) as loop:
                loop.drain([base])
                _check(bool(base.panel_digest), "dispatch loop (e): the "
                       "base job has no digest")
                specs = [dataclasses.replace(r, id=f"e-{i:03d}")
                         for i, r in enumerate(dispatcher.scenario_jobs(
                             base.panel_digest, LOOP_SCENARIOS,
                             "sma_crossover", base.grid, cost=COST,
                             params=dict(SCENARIO_PARAMS, seed=0)))]
                loop.drain(specs)
                panels = loop.queue.panel_store.stats()["panels"]
            wall = time.perf_counter() - t0
        launches[fused_on] = dict(kernels_mod.LAUNCHES)
        want = 1 if fused_on == "1" else 1 + LOOP_SCENARIOS
        _check(panels == want, f"dispatch loop (e) DBX_SCENARIO_FUSED="
               f"{fused_on}: the panel store holds {panels} panels, "
               f"{want} wanted")
        blocks[fused_on] = _loop_blocks(res, specs)
        print(f"dispatch loop (e) DBX_SCENARIO_FUSED={fused_on}: "
              f"{LOOP_SCENARIOS} specs in {wall:.4f} s, {panels} panels in "
              f"the store, launches {launches[fused_on]} [{card}]")
    _hold_loop_blocks("dispatch loop (e) materialized rung", blocks["0"],
                      blocks["1"], "the spec-batch route's")
    total = {}
    for part in launches.values():
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


def _loop_restart(kernels_mod, compute, data, journal_mod, root, blocks_a,
                  card) -> int:
    """Part (f): a 500-job drain stopped once the dispatcher has recorded
    its first CompleteJobs; a new dispatcher on the same port from
    ``JobQueue.restore`` of the journal; every job one block, bit-equal to
    (a)'s, and no job pending in the journal. Returns K1's launches."""
    import threading

    from distributed_backtesting_exploration_tpu_torch import obs
    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher
    from distributed_backtesting_exploration_tpu_torch.rpc.worker import (
        Worker)

    panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7)
    recs = _loop_records(dispatcher, data, panel, "f")
    jp = os.path.join(root, "f.jsonl")
    res = os.path.join(root, "res-f")

    def serve(port: int, restore: bool):
        q = dispatcher.JobQueue(journal_mod.Journal(jp), device="cuda")
        n = q.restore(jp) if restore else 0
        d = dispatcher.Dispatcher(
            q, dispatcher.PeerRegistry(prune_window_s=30.0),
            results_dir=res, registry=obs.Registry())
        srv = dispatcher.DispatcherServer(d, bind=f"localhost:{port}",
                                          prune_interval_s=0.5).start()
        return q, srv, n

    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    q1, srv1, _ = serve(0, False)
    port = srv1.port
    q1.enqueue_many(recs)
    w = Worker(f"localhost:{port}", compute.TorchSweepBackend(device="cuda"),
               worker_id="restart", poll_interval_s=LOOP_POLL_S,
               jobs_per_chip=LOOP_JOBS_PER_CHIP)
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    srv2 = None
    try:
        deadline = time.monotonic() + 300.0
        while q1.stats()["jobs_completed"] == 0:
            _check(time.monotonic() < deadline, "dispatch loop (f): no "
                   "completion before the stop")
            time.sleep(0.001)
        srv1.stop()
        q1._journal.close()
        done_before = q1.stats()["jobs_completed"]
        q2, srv2, restored = serve(port, True)
        deadline = time.monotonic() + 300.0
        while not q2.drained:
            _check(time.monotonic() < deadline, f"dispatch loop (f): the "
                   f"restored drain wedged {q2.stats()}")
            time.sleep(0.002)
    finally:
        w.stop()
        t.join(timeout=60)
        if srv2 is not None:
            srv2.stop()
            q2._journal.close()
    wall = time.perf_counter() - t0
    _check(not t.is_alive(), "dispatch loop (f): the worker did not stop")
    files = sorted(os.listdir(res))
    _check(files == sorted(f"{r.id}.dbxm" for r in recs), f"dispatch loop "
           f"(f): {len(files)} blocks for {len(recs)} jobs")
    got = _loop_blocks(res, recs)
    _hold_loop_blocks("dispatch loop (f)", got,
                      dict(zip(got, blocks_a.values())), "(a)'s")
    st = journal_mod.Journal.replay(jp)
    _check(not st.pending and st.completed == {r.id for r in recs},
           f"dispatch loop (f): the journal replays to "
           f"{len(st.completed)} completed, {len(st.pending)} pending")
    k1 = kernels_mod.LAUNCHES["fused_sma"]
    print(f"dispatch loop (f): stopped after {done_before} completions, "
          f"{restored} jobs restored from the journal on port {port}, "
          f"{len(recs)} blocks in {wall:.4f} s, K1 launches {k1} [{card}]")
    return k1


def phase_dispatch_loop(kernels_mod, compute, pb, wire, data, bench,
                        card) -> dict:
    """Phase 11, the dispatch loop on the card: (a)-(c) and (a') one
    dispatcher and worker, (d) streams, (e) scenarios, (f) a restart. Returns every
    entry's launches in the phase."""
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        journal, service)

    root = tempfile.mkdtemp(prefix="dbx-loop-")
    t0 = time.perf_counter()
    try:
        blocks_a, k1_abc = _loop_main(kernels_mod, compute, pb, wire, data,
                                      bench, journal, root, card)
        t_abc = time.perf_counter()
        streams = _loop_streams(kernels_mod, compute, pb, wire, data, bench,
                                service, root, card)
        t_d = time.perf_counter()
        scen = _loop_scenarios(kernels_mod, compute, data, bench, root,
                               card)
        t_e = time.perf_counter()
        k1_f = _loop_restart(kernels_mod, compute, data, journal, root,
                             blocks_a, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"dispatch loop phase wall (s): {wall:.1f} ((a)-(c), (a') "
          f"{t_abc - t0:.1f}, (d) {t_d - t_abc:.1f}, (e) {t_e - t_d:.1f}, "
          f"(f) {time.perf_counter() - t_e:.1f})")
    total = {"fused_sma": k1_abc + k1_f}
    for part in (streams, scen):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


OBS_WORKERS = 2
OBS_LEASE_S = 5.0             # (c): the failed batch's lease
OBS_FAIL_JOBS = 100           # (c): the batch whose collect raises
OBS_ORDER = ("queue_wait", "dispatch", "transport", "panel_cache_hit",
             "decode", "compile", "execute", "d2h", "report")


def _prom(text: str) -> dict:
    """``{"name{labels}": value}`` of a Prometheus text scrape."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _scrape(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
        return _prom(resp.read().decode())


def _obs_drain(kernels_mod, compute, bench, recs, res, *, workers: int,
               telemetry: bool, log: str | None, backends=None,
               lease_s: float | None = None, on_drained=None):
    """One drain of ``recs`` through the port's dispatcher and ``workers``
    port workers with ``TorchSweepBackend`` on the card (``backends``
    where given), fleet telemetry on or off, the span log to ``log`` or
    nowhere. Returns (the drain's wall seconds, K1's launches, the
    ``on_drained(loop)`` result, taken before the loop stops)."""
    from distributed_backtesting_exploration_tpu_torch.obs import events

    prior = events.configured_path()
    backends = backends or [compute.TorchSweepBackend(device="cuda")
                            for _ in range(workers)]
    with _env(DBX_FLEET_TELEMETRY=None if telemetry else "0",
              DBX_OBS_JSONL=log):
        events.configure(log)
        try:
            with bench.DispatchLoop(backends, device="cuda",
                                    jobs_per_chip=LOOP_JOBS_PER_CHIP,
                                    poll_interval_s=LOOP_POLL_S,
                                    results_dir=res) as loop:
                if lease_s is not None:
                    loop.queue.lease_s = lease_s
                kernels_mod.reset_launch_counts()
                t0 = time.perf_counter()
                loop.drain(recs)
                wall = time.perf_counter() - t0
                k1 = kernels_mod.LAUNCHES["fused_sma"]
                got = on_drained(loop) if on_drained else None
        finally:
            events.configure(prior)
    _check(k1 > 0, f"worker obs: a drain of {len(recs)} jobs launched K1 "
           "no time")
    return wall, k1, got


def _fleet_ready(loop, deadline_s: float = 30.0) -> dict:
    """The dispatcher's fleet document once every worker's frame carries
    the four stages (the frames ride the idle polls after the drain)."""
    from distributed_backtesting_exploration_tpu_torch.obs import fleet

    ids = {w.worker_id for w in loop.workers}
    deadline = time.monotonic() + deadline_s
    while True:
        doc = loop.dispatcher.fleet.snapshot()
        rows = doc["workers"]
        if ids <= set(rows) and all(
                not rows[w]["stale"] and all(
                    rows[w]["stages"].get(st, {}).get("n", 0) > 0
                    for st in fleet.TELEMETRY_STAGES) for w in ids):
            return doc
        _check(time.monotonic() < deadline, f"worker obs (a): the fleet "
               f"view lacks a worker or a stage: {json.dumps(rows)[:2000]}")
        time.sleep(0.05)


def _obs_a(kernels_mod, compute, pb, wire, data, bench, root, card):
    """Part (a) and (d): one drain with two workers, telemetry on, the span
    log on; the fleet view, the timeline, obs.dump and obs.why over the
    log, and a scrape of the workers' /metrics against their counts.
    Returns (the blocks, K1's launches)."""
    from distributed_backtesting_exploration_tpu_torch import obs
    from distributed_backtesting_exploration_tpu_torch.obs import (
        dump, timeline, why)
    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher

    panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7)
    recs = _loop_records(dispatcher, data, panel, "o")
    log = os.path.join(root, "obs-a.jsonl")
    res = os.path.join(root, "res-obs-a")
    backends = [compute.TorchSweepBackend(device="cuda")
                for _ in range(OBS_WORKERS)]
    metrics = obs.MetricsServer(0, bind="127.0.0.1").start()
    url = f"http://127.0.0.1:{metrics.port}"

    def drained(loop):
        # The decision plane samples (DBX_DECISIONS_RATE) and scores on its
        # own thread; a stopped dispatcher drops what it has not scored.
        # So obs.why's job has a record only with the budget off and the
        # queue scored before the loop stops.
        _check(loop.dispatcher.decisions.flush(timeout=30.0),
               "worker obs (a): the decision plane did not score its queue")
        return _fleet_ready(loop), _scrape(url)

    try:
        before = _scrape(url)
        with _env(DBX_DECISIONS_RATE="0"):
            wall, k1, (doc, after) = _obs_drain(
                kernels_mod, compute, bench, recs, res, workers=OBS_WORKERS,
                telemetry=True, log=log, backends=backends,
                on_drained=drained)
    finally:
        metrics.stop()
    blocks = _loop_blocks(res, recs)
    # (d) the scrape, before anything else in the process encodes.
    n_combos = FAST_AXIS.size * SLOW_AXIS.size

    def delta(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    for m in ("RequestJobs", "CompleteJobs"):
        _check(delta(f'dbx_worker_rpc_seconds_count{{method="{m}"}}') > 0,
               f"worker obs (d): no dbx_worker_rpc_seconds for {m}")
    enc = delta('dbx_wire_bytes_total{direction="encode",kind="metrics"}')
    _check(enc == sum(len(b) for b in blocks.values()), f"worker obs (d): "
           f"{enc} encoded bytes, {sum(len(b) for b in blocks.values())} "
           "in the stored blocks")
    bt = delta("dbx_backtests_total")
    _check(bt == len(recs) * n_combos, f"worker obs (d): "
           f"dbx_backtests_total grew {bt}, {len(recs) * n_combos} wanted")
    for kind in ("hits", "misses"):
        for lvl in ("host", "device"):
            want = sum(b.panel_cache.stats()[kind][lvl] for b in backends)
            got = delta(f'dbx_panel_cache_{kind}_total{{level="{lvl}"}}')
            _check(got == want, f"worker obs (d): dbx_panel_cache_{kind}"
                   f"_total{{level={lvl}}} grew {got}, the caches' stats() "
                   f"say {want}")
    rpcs = {m: delta(f'dbx_worker_rpc_seconds_count{{method="{m}"}}')
            for m in ("RequestJobs", "CompleteJobs", "SendStatus")}
    print(f"worker obs (d): /metrics scraped over HTTP, over the drain: "
          f"{enc:.0f} encoded DBXM bytes = the {len(blocks)} stored blocks', "
          f"dbx_backtests_total +{bt:.0f} = {len(recs)} x {n_combos}, the "
          f"panel-cache counters = the two caches' stats(), "
          f"dbx_worker_rpc_seconds calls {json.dumps(rpcs)} [{card}]")
    # (a) the fleet document.
    ids = {f"loop-{i}" for i in range(OBS_WORKERS)}
    _check(ids <= set(doc["workers"]), f"worker obs (a): fleet view "
           f"workers {sorted(doc['workers'])}")
    _check(bench.fleet_merge_exact(doc), "worker obs (a): the fleet's "
           "execute histogram is not the fold of the workers' rows")
    print(f"worker obs (a): {len(recs)} sma jobs x {n_combos} combos through "
          f"the port's dispatcher and {OBS_WORKERS} workers "
          f"(jobs_per_chip={LOOP_JOBS_PER_CHIP}, poll {LOOP_POLL_S} s, "
          f"telemetry and span log on): drain {wall:.4f} s, "
          f"{len(recs) / wall:.1f} jobs/s, K1 launches {k1}; fleet view "
          + json.dumps({w: {"stale": doc["workers"][w]["stale"],
                            "stages": {st: v["n"] for st, v in
                                       doc["workers"][w]["stages"].items()}}
                        for w in sorted(ids)})
          + f", execute histogram the fold of the rows [{card}]")
    # The timeline over the log.
    evs, bad = timeline.parse_events([log])
    tls = timeline.reconstruct([e for e in evs if e.get("ev") == "span"])
    summary = timeline.summarize(tls)
    jobs = {j["job"] for j in summary["per_job"] if j["e2e_s"] > 0}
    _check({r.id for r in recs} <= jobs, f"worker obs (a): the timeline "
           f"has {len(jobs & {r.id for r in recs})} of {len(recs)} jobs")
    e2e = summary["e2e_total_s"]
    shares = {st: summary["stages"][st]["total_s"] / e2e
              for st in OBS_ORDER}
    print(f"worker obs (a) critical path by stage, share of the jobs' "
          f"summed e2e ({e2e:.4f} s over {summary['jobs']} jobs, {len(evs)} "
          f"events, {bad} malformed): " + ", ".join(
              f"{st} {100 * v:.4f}%" for st, v in shares.items())
          + f", mean e2e a job {e2e / summary['jobs']:.4f} s [{card}]")
    for name, main, argv in (("obs.dump", dump.main, [log]),
                             ("obs.why", why.main, [recs[7].id, "--jsonl",
                                                    log])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        _check(rc == 0, f"worker obs (a): {name} exited {rc}")
        print(f"worker obs (a) {name}: exit 0, "
              f"{len(out.getvalue().splitlines())} lines; first: "
              f"{out.getvalue().splitlines()[0][:160]}")
    want = {c.job_id: c.metrics for c in compute.TorchSweepBackend(
        device="cuda").process(_loop_specs(pb, wire, recs))}
    _hold_loop_blocks("worker obs (a)", blocks, want)
    return blocks, k1


# ``--obs-split``: phase 12 (b)'s drain in four arms, in turns, each
# OBS_SPLIT_ROUNDS times.
OBS_SPLIT_ARMS = (("neither", False, False), ("frames", True, False),
                  ("log", False, True), ("both", True, True))
OBS_SPLIT_ROUNDS = 12


def obs_split(rounds: int = OBS_SPLIT_ROUNDS) -> None:
    """``python3 chip_smoke.py --obs-split``: the cost of fleet telemetry
    (the frames) and of the span log apart. Phase 12 (b)'s drain (500 sma
    jobs of ``synthetic_ohlcv(500, 1260, seed=7)``, two workers) in four
    arms, neither, frames only, log only, both, in turns (the order
    rotated a round), ``rounds`` drains each after one warm-up drain of
    each arm. Prints every drain, each arm's median, spread (min, max,
    and the middle half) and cost against the median of neither, the
    span-log records a drain writes and the time ``emit_record`` takes for
    one alone; one JSON line; no result line of the smoke run."""
    from distributed_backtesting_exploration_tpu_torch import bench
    from distributed_backtesting_exploration_tpu_torch.ops import _kernels
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        compute, dispatcher)
    from distributed_backtesting_exploration_tpu_torch.utils import data

    card = phase_card()
    phase_build(_kernels)
    panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7)
    root = tempfile.mkdtemp(prefix="dbx-obs-split-")
    walls: dict = {name: [] for name, _, _ in OBS_SPLIT_ARMS}
    records: list = []
    sample = None
    try:
        for r in range(-1, rounds):
            k = r % len(OBS_SPLIT_ARMS)
            for name, frames, logged in (OBS_SPLIT_ARMS[k:]
                                         + OBS_SPLIT_ARMS[:k]):
                tag = f"s{name}{r + 1}"
                recs = _loop_records(dispatcher, data, panel, tag)
                log = (os.path.join(root, f"{tag}.jsonl") if logged
                       else None)
                wall, _, _ = _obs_drain(
                    _kernels, compute, bench, recs,
                    os.path.join(root, f"res-{tag}"), workers=OBS_WORKERS,
                    telemetry=frames, log=log)
                if log is not None:
                    with open(log) as fh:
                        lines = fh.read().splitlines()
                    records.append(len(lines))
                    sample = sample or json.loads(lines[-1])
                    os.remove(log)
                shutil.rmtree(os.path.join(root, f"res-{tag}"),
                              ignore_errors=True)
                if r >= 0:
                    walls[name].append(wall)
                print(f"obs split round {r + 1} {name}: {wall:.4f} s"
                      + (" (warm-up)" if r < 0 else ""), flush=True)
        emit_us = _emit_cost(sample, os.path.join(root, "emit.jsonl"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    base = statistics.median(walls["neither"])
    summary = {"card": card, "jobs": N_TICKERS, "rounds": rounds,
               "log_records": statistics.median(records),
               "emit_us": emit_us, "arms": {}}
    print(f"obs split: {statistics.median(records):.0f} span-log records a "
          f"drain (median; {min(records)}-{max(records)}), "
          f"{emit_us:.2f} us a record written and flushed alone, "
          f"{statistics.median(records) * emit_us / 1e6:.4f} s a drain "
          f"[{card}]")
    for name, v in walls.items():
        q = statistics.quantiles(v, n=4)
        med = statistics.median(v)
        summary["arms"][name] = {
            "median_s": med, "min_s": min(v), "max_s": max(v),
            "q1_s": q[0], "q3_s": q[2],
            "cost_pct": 100 * (med - base) / base,
            "spread_pct": 100 * (q[2] - q[0]) / med, "walls_s": v}
        print(f"obs split {name}: median {med:.4f} s, min {min(v):.4f}, "
              f"max {max(v):.4f}, middle half {q[0]:.4f}-{q[2]:.4f} s "
              f"({100 * (q[2] - q[0]) / med:.2f}% of the median); cost "
              f"against neither {100 * (med - base) / base:+.2f}% [{card}]")
    print(json.dumps(summary))


class _CollectFailsOnce:
    """Makes a backend's ``collect`` raise on the first batch of
    ``OBS_FAIL_JOBS`` jobs it sees."""

    def __init__(self, backend):
        self.failed = 0
        inner = backend.collect

        def collect(pending):
            if not self.failed and sum(len(p.jobs)
                                       for p in pending) == OBS_FAIL_JOBS:
                self.failed += 1
                raise RuntimeError("injected collect failure")
            return inner(pending)

        backend.collect = collect


def _obs_flight(kernels_mod, compute, data, bench, root, blocks_a,
                card) -> int:
    """Part (c): one worker whose backend's collect raises once for a
    100-job batch, ``DBX_FLIGHT_DIR`` set: one ``collect_fail`` bundle
    (the dispatcher's lease expiry writes a ``requeue_expired`` one of its
    own), the batch re-served when its lease expires, every block
    bit-equal to (a)'s. Returns K1's launches."""
    from distributed_backtesting_exploration_tpu_torch.obs import flight
    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher

    panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7)
    recs = _loop_records(dispatcher, data, panel, "f")
    fdir = os.path.join(root, "flight")
    os.makedirs(fdir)
    backend = compute.TorchSweepBackend(device="cuda")
    fails = _CollectFailsOnce(backend)
    with _env(DBX_FLIGHT_DIR=fdir):
        flight.reset()
        try:
            wall, k1, stats = _obs_drain(
                kernels_mod, compute, bench, recs,
                os.path.join(root, "res-obs-c"), workers=1,
                telemetry=True, log=None, backends=[backend],
                lease_s=OBS_LEASE_S,
                on_drained=lambda loop: loop.queue.stats())
            _check(flight.get_recorder().flush(10.0), "worker obs (c): the "
                   "flight recorder did not flush")
        finally:
            flight.reset()
    bundles = sorted(f for f in os.listdir(fdir) if f.endswith(".json"))
    failed = [b for b in bundles if "-collect_fail-" in b]
    _check(fails.failed == 1, "worker obs (c): the collect never failed")
    _check(len(failed) == 1, f"worker obs (c): bundles {bundles}, one "
           "collect_fail wanted")
    _check(stats["jobs_requeued"] == OBS_FAIL_JOBS, f"worker obs (c): "
           f"{stats['jobs_requeued']} jobs re-queued, {OBS_FAIL_JOBS} "
           "wanted")
    got = _loop_blocks(os.path.join(root, "res-obs-c"), recs)
    _hold_loop_blocks("worker obs (c)", got,
                      dict(zip(got, blocks_a.values())), "(a)'s")
    print(f"worker obs (c): a collect failure on a {OBS_FAIL_JOBS}-job "
          f"batch: bundles {bundles}, {stats['jobs_requeued']} jobs "
          f"re-served after the {OBS_LEASE_S} s lease, drain {wall:.4f} s, "
          f"K1 launches {k1} [{card}]")
    return k1


def phase_worker_obs(kernels_mod, compute, pb, wire, data, bench,
                     card) -> int:
    """Phase 12, the worker's observability on the card: (a) and (d) a
    drain with two workers and the span log, (c) a forced collect failure
    ((b), the cost of telemetry and the log, is :func:`obs_split`).
    Returns K1's launches in the phase."""
    root = tempfile.mkdtemp(prefix="dbx-obs-")
    t0 = time.perf_counter()
    try:
        blocks_a, k1_a = _obs_a(kernels_mod, compute, pb, wire, data,
                                bench, root, card)
        t_a = time.perf_counter()
        k1_c = _obs_flight(kernels_mod, compute, data, bench, root,
                           blocks_a, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"worker obs phase wall (s): {time.perf_counter() - t0:.1f} "
          f"((a) and (d) {t_a - t0:.1f}, (c) "
          f"{time.perf_counter() - t_a:.1f})")
    return k1_a + k1_c


# Phase 13: the native worker shell. Phase 11's panel (seed 7) and grid as
# 500 jobs, drained by pairs of shells that poll as phase 11's worker does,
# after a warm-up drain of 200 jobs of another panel (seed 8).
SHELLS = 2
SHELL_WARM_JOBS = 200
SHELL_FUSED_OFF_JOBS = 16
SHELL_ROUNDS = 1              # timed drains of each channel kind
SHELL_TIMEOUT_S = 300.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shell_k1(port: int) -> int:
    """K1's launches so far in the shell serving ``/metrics`` on ``port``
    (``dbx_kernel_launches{kernel="fused_sma"}``: its wrappers' own
    count)."""
    rows = _scrape(f"http://127.0.0.1:{port}")
    return int(sum(v for k, v in rows.items()
                   if k.startswith("dbx_kernel_launches{")
                   and 'kernel="fused_sma"' in k))


def _log_tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as fh:
        return fh.read()[-n:]


@contextlib.contextmanager
def _shell_fleet(shell: str, target: str, root: str, tag: str, n: int,
                 env: dict, *args):
    """``n`` native worker shells polling ``target``, each serving
    ``/metrics`` on a port of its own, their output in ``root``. Yields
    (the processes, their metrics ports, their log paths); on exit each
    gets SIGTERM (the worker drains and returns) and must exit 0."""
    import signal

    procs, ports, logs = [], [_free_port() for _ in range(n)], []
    try:
        for i, port in enumerate(ports):
            path = os.path.join(root, f"shell-{tag}-{i}.log")
            logs.append(path)
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    [shell, "--connect", target, "--id", f"shell-{tag}-{i}",
                     "--backend", "torch", "--device", "cuda",
                     "--jobs-per-chip", str(LOOP_JOBS_PER_CHIP), "--poll-s",
                     str(LOOP_POLL_S), "--status-s", "0.5", "--metrics-port",
                     str(port), "--metrics-host", "127.0.0.1", *args],
                    cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT))
        yield procs, ports, logs
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p, path in zip(procs, logs):
            try:
                rc = p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rc = "killed after 60 s"
            _check(rc == 0, f"native shell {tag}: exit {rc}; its log ends:\n"
                   f"{_log_tail(path)}")


def _shell_loop(root: str, tag: str):
    """The port's dispatcher on ``localhost:0``, results under ``root``:
    (queue, dispatcher, server)."""
    from distributed_backtesting_exploration_tpu_torch import obs
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        dispatcher, journal)

    q = dispatcher.JobQueue(journal.Journal(None), device="cuda")
    disp = dispatcher.Dispatcher(
        q, dispatcher.PeerRegistry(prune_window_s=30.0),
        results_dir=os.path.join(root, f"res-{tag}"), registry=obs.Registry())
    srv = dispatcher.DispatcherServer(disp, bind="localhost:0",
                                      prune_interval_s=0.5).start()
    return q, disp, srv


def _wait_queue(q, label: str, procs=(), logs=()) -> None:
    deadline = time.monotonic() + SHELL_TIMEOUT_S
    while not q.drained:
        for p, path in zip(procs, logs):
            _check(p.poll() is None, f"{label}: a shell exited ({p.poll()}) "
                   f"before the drain ended; its log ends:\n"
                   f"{_log_tail(path)}")
        _check(time.monotonic() < deadline, f"{label}: drain wedged for "
               f"{SHELL_TIMEOUT_S:.0f} s: {q.stats()}")
        time.sleep(0.002)


def _wait_polling(fleets, t0: float) -> dict:
    """Seconds from ``t0`` until each fleet's dispatcher sees all its
    shells polling: ``{tag: seconds}``. ``fleets`` maps a tag to (the
    dispatcher, the processes, their logs)."""
    cold: dict = {}
    deadline = time.monotonic() + SHELL_TIMEOUT_S
    while len(cold) < len(fleets):
        for tag, (disp, procs, logs) in fleets.items():
            for p, path in zip(procs, logs):
                _check(p.poll() is None, f"native shell ({tag}): a shell "
                       f"exited ({p.poll()}) before polling; its log "
                       f"ends:\n{_log_tail(path)}")
            if tag not in cold and disp.peers.alive() >= len(procs):
                cold[tag] = time.perf_counter() - t0
        _check(time.monotonic() < deadline, f"native shell: shells not "
               f"polling after {SHELL_TIMEOUT_S:.0f} s ({sorted(cold)} "
               "ready)")
        time.sleep(0.02)
    return cold


def _timed_shell_drain(q, ports, procs, logs, recs, label) -> tuple:
    """One drain of ``recs``: (its wall seconds, K1's launches in the
    shells during it)."""
    k0 = sum(_shell_k1(p) for p in ports)
    t0 = time.perf_counter()
    q.enqueue_many(recs)
    _wait_queue(q, label, procs, logs)
    wall = time.perf_counter() - t0
    return wall, sum(_shell_k1(p) for p in ports) - k0


def _fused_off_check(got_blocks: dict, fused_blocks, wire, wall, card):
    """Part (b): the ``--fused off`` shell's blocks (the generic sweep)
    within the flip-aware budget of the fused route's blocks of the same
    tickers."""
    from distributed_backtesting_exploration_tpu_torch.ops.metrics import (
        Metrics)

    rows = [wire.metrics_from_bytes(b) for b in got_blocks.values()]
    gold_rows = [wire.metrics_from_bytes(b) for b in fused_blocks]
    got = {f: np.stack([getattr(r, f) for r in rows]) for f in Metrics._fields}
    gold = Metrics(*(torch.as_tensor(np.stack([getattr(r, f)
                                               for r in gold_rows]))
                     for f in Metrics._fields))
    same = sum(a == b for a, b in zip(got_blocks.values(), fused_blocks))
    n_flips = _golden_check("native shell --fused off", got, gold, "shift")
    print(f"native shell --fused off ({card}): {len(rows)} jobs through the "
          f"generic sweep drained in {wall:.4f} s; against the fused "
          f"route's blocks within the flip-aware budget, {n_flips} flipped "
          f"cells, {same} of {len(rows)} blocks bit-equal")


def phase_native_shell(kernels_mod, compute, pb, wire, data, bench,
                       card, rounds: int = SHELL_ROUNDS) -> int:
    """Phase 13, the native worker shell on the card: five shells started
    at once, each fleet on a dispatcher of its own: (a) two with native
    channels and two with python channels (``DBX_NO_NATIVE=1``, the
    core's existing switch), each pair warmed up and then draining phase
    11's 500 jobs ``rounds`` times, the pairs in turns, every block
    bit-equal to the direct ``process``; (b) one with ``--fused off`` on
    16 of the jobs; (c) the bench's ``pipeline`` and ``queue_machine``.
    Returns K1's launches read from the shells."""
    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher
    from distributed_backtesting_exploration_tpu_torch.runtime import _core

    root = tempfile.mkdtemp(prefix="dbx-shell-")
    t0 = time.perf_counter()
    loops = {}
    try:
        shell = _core.build_worker_shell()
        print(f"native shell: built in {time.perf_counter() - t0:.2f} s")
        lib = kernels_mod.library_path("fused_sma")
        _check(lib.exists(), f"native shell: {lib} was not built by phase 2")
        before = (lib.stat().st_ino, lib.stat().st_mtime_ns,
                  sorted(p.name for p in lib.parent.glob("libfused_sma*")))
        panel = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7)
        recs = _loop_records(dispatcher, data, panel, "n")
        warm = _loop_records(dispatcher, data, data.synthetic_ohlcv(
            SHELL_WARM_JOBS, N_BARS, seed=8), "w")
        direct = {c.job_id: c.metrics for c in compute.TorchSweepBackend(
            device="cuda").process(_loop_specs(pb, wire, recs))}
        off = [dataclasses.replace(r, id=f"f-{i:04d}")
               for i, r in enumerate(recs[:SHELL_FUSED_OFF_JOBS])]
        no_native = dict(os.environ, DBX_NO_NATIVE="1")
        for tag in ("native", "python", "fused-off"):
            loops[tag] = _shell_loop(root, tag)
        target = {tag: f"localhost:{srv.port}"
                  for tag, (_, _, srv) in loops.items()}
        walls: dict = {"native": [], "python": []}
        k1_timed: dict = {"native": [], "python": []}
        t_start = time.perf_counter()
        with _shell_fleet(shell, target["native"], root, "native", SHELLS,
                          dict(os.environ)) as nat, \
                _shell_fleet(shell, target["python"], root, "python",
                             SHELLS, no_native) as pyt, \
                _shell_fleet(shell, target["fused-off"], root, "fused-off",
                             1, dict(os.environ), "--fused", "off") as foff:
            fleets = {"native": nat, "python": pyt, "fused-off": foff}
            cold = _wait_polling({tag: (loops[tag][1], f[0], f[2])
                                  for tag, f in fleets.items()}, t_start)
            for tag in ("native", "python"):
                procs, ports, logs = fleets[tag]
                w_s, _ = _timed_shell_drain(loops[tag][0], ports, procs,
                                            logs, [dataclasses.replace(
                                                r, id=f"{tag}-{r.id}")
                                                for r in warm],
                                            f"native shell ({tag}) warm-up")
                print(f"native shell ({tag} channels): warm-up of "
                      f"{len(warm)} jobs {w_s:.4f} s")
            for rnd in range(rounds):
                # Either kind first in turn, so that neither always runs
                # on the host the other has just warmed.
                for tag in (("native", "python") if rnd % 2 == 0
                            else ("python", "native")):
                    procs, ports, logs = fleets[tag]
                    rr = [dataclasses.replace(r, id=f"{tag}{rnd}-{r.id}")
                          for r in recs]
                    wall, k1 = _timed_shell_drain(
                        loops[tag][0], ports, procs, logs, rr,
                        f"native shell ({tag})")
                    _check(k1 > 0, f"native shell ({tag}): the shells "
                           "launched K1 no time on a timed drain")
                    walls[tag].append(wall)
                    k1_timed[tag].append(k1)
                    _hold_loop_blocks(
                        f"native shell ({tag} channels, round {rnd + 1})",
                        _loop_blocks(os.path.join(root, f"res-{tag}"), rr),
                        direct)
            procs, ports, logs = foff
            off_wall, _ = _timed_shell_drain(loops["fused-off"][0], ports,
                                             procs, logs, off,
                                             "native shell --fused off")
            k1_all = {tag: sum(_shell_k1(p) for p in fleets[tag][1])
                      for tag in ("native", "python")}
        for tag in ("native", "python", "fused-off"):
            for path in fleets[tag][2]:
                text = _log_tail(path, 1 << 20)
                proto = re.search(r"proto selftest (\w+)", text)
                channel = "python" if tag == "python" else "native"
                _check("core selftest ok" in text and proto is not None
                       and proto.group(1) != "FAILED"
                       and f"channel={channel}" in text,
                       f"native shell ({tag}): the log does not show the "
                       f"selftests and {channel} channels:\n{text[-3000:]}")
        print(f"native shell: core selftest ok, proto selftest "
              f"{proto.group(1)} in every shell's log")
        after = (lib.stat().st_ino, lib.stat().st_mtime_ns,
                 sorted(p.name for p in lib.parent.glob("libfused_sma*")))
        _check(before == after, f"native shell: the shells rebuilt K1's "
               f"library ({before} -> {after})")
        n_combos = FAST_AXIS.size * SLOW_AXIS.size
        for tag in ("native", "python"):
            print(f"native shell ({tag} channels, {card}): {SHELLS} shells "
                  f"polling {cold[tag]:.2f} s after the five started (cold "
                  f"start); {len(recs)} jobs drained in "
                  f"{[round(w, 4) for w in walls[tag]]} s, "
                  f"{[round(len(recs) / w, 1) for w in walls[tag]]} jobs/s, "
                  f"{[round(len(recs) * n_combos / w) for w in walls[tag]]}"
                  f" backtests/s; K1 launches read from the shells: "
                  f"{k1_timed[tag]} on the timed drains, {k1_all[tag]} in "
                  "all")
        t_a = time.perf_counter()
        _fused_off_check(_loop_blocks(os.path.join(root, "res-fused-off"),
                                      off),
                         list(direct.values())[:SHELL_FUSED_OFF_JOBS], wire,
                         off_wall, card)
        t_b = time.perf_counter()
        out = bench.run(bench.settings_from_env(
            {"DBX_BENCH_CONFIGS": "pipeline,queue_machine"}))
        _check(all(out["configs"].get(k, 0) > 0 for k in (
            "pipeline", "queue_machine_python", "queue_machine_native",
            "queue_machine_native_cabi")),
            f"native shell (c): a bench key reported no rate: "
            f"{out['configs']}")
        print(f"native shell (c) bench ({card}): " + json.dumps(
            {"configs": out["configs"],
             "pipeline": out["roofline"]["pipeline"]}))
    finally:
        for _, _, srv in loops.values():
            srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    med = {tag: statistics.median(walls[tag]) for tag in walls}
    print(f"native shell ({card}): timed drains native {med['native']:.4f} "
          f"s against python {med['python']:.4f} s (medians of "
          f"{rounds}, in turns; python / native "
          f"{med['python'] / med['native']:.3f}); cold start native "
          f"{cold['native']:.2f} s, python {cold['python']:.2f} s, fused off "
          f"{cold['fused-off']:.2f} s; K1's library loaded from the build "
          "directory, not rebuilt")
    print(f"native shell phase wall (s): {time.perf_counter() - t0:.1f} "
          f"((a) {t_a - t0:.1f}, (b) {t_b - t_a:.1f}, (c) "
          f"{time.perf_counter() - t_b:.1f})")
    return k1_all["native"] + k1_all["python"]


# Run by phase 14 (a) and (b) in a process of its own in which jax and the
# JAX package cannot be imported: dbxlint over the port package as
# ``python -m ...analysis.lint --format json`` runs it, then
# ``--certify --format json`` in the same process (its certified rows
# traced once, by the first); one JSON line of both results and walls.
ANALYSIS_BLOCKED = r"""
import contextlib, io, json, sys, time
sys.modules["jax"] = None
sys.modules["distributed_backtesting_exploration_tpu"] = None
from distributed_backtesting_exploration_tpu_torch.analysis import lint

def run(argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = lint.main(argv)
    return rc, json.loads(buf.getvalue()), time.perf_counter() - t0

lint_rc, lint_res, lint_s = run(["--format", "json"])
cert_rc, cert_res, cert_s = run(["--certify", "--format", "json"])
print(json.dumps({"lint_rc": lint_rc, "lint": lint_res, "lint_s": lint_s,
                  "certify_rc": cert_rc, "certify": cert_res,
                  "certify_s": cert_s}))
"""

# Phase 14 (c): the entry of every kernel kernel-hygiene must launch on the
# card (K8 at its full stage, 128 lanes).
HYGIENE_LAUNCHES = ("fused_sma", "obv", "band_inline", "band_table",
                    "band_stoch", "momentum", "donchian", "macd", "trix",
                    "pairs", "ema_rows", "pairs_tables",
                    "sma_stage_full_l128", "boll_stage_full_l128")
# Phase 14 (d): the families held at the bench's shape; the rest at
# ANALYSIS_SMALL tickers.
ANALYSIS_FULL = ("sma_crossover", "bollinger")
ANALYSIS_SMALL = 32


def _substrate_bits(recurrent, certify, data, dev) -> dict:
    """Phase 14 (d): every output the port's table certifies exact,
    selection or int-exact in both substrates' build rows is bit-identical
    between the ``scan:8`` and ``ladder`` builds on the card. Returns
    {family: outputs compared}."""
    table = certify.load_contract()["rows"]
    checked = {}
    for fam in certify.stream_families():
        n = N_TICKERS if fam in ANALYSIS_FULL else ANALYSIS_SMALL
        if fam == "pairs":
            y, x = _pairs_legs(data, n, N_BARS, 7)
            cols = {"close": y.close, "close2": x.close}
        else:
            panel = data.synthetic_ohlcv(n, N_BARS, seed=7)
            cols = {f: getattr(panel, f)
                    for f in recurrent.stream_fields(fam)}
        fields = {k: torch.as_tensor(v, device=dev) for k, v in cols.items()}
        g = _flat_grid(AXES[fam])
        out = {}
        for sub in certify.SUBSTRATES:
            c = recurrent.build_carry(fam, fields, g, cost=COST,
                                      epilogue=sub, device=dev)
            m = recurrent.finalize(c)
            vals = {f"metrics/{k}": getattr(m, k) for k in m._fields}
            vals.update({f"metric/{k}": v for k, v in c.metric.items()})
            vals.update({f"state/{k}": v for k, v in c.state.items()})
            out[sub] = vals
            del c, m
        rows = [table[certify.row_key(fam, sub, "build_carry")]["outputs"]
                for sub in certify.SUBSTRATES]
        labels = [lab for lab in sorted(rows[0])
                  if all(r[lab]["class"] in ("exact", "selection",
                                             "int-exact") for r in rows)]
        _check(bool(labels), f"analysis (d): {fam} certifies no output "
               "exact, selection or int-exact")
        for lab in labels:
            a, b = (out[sub][lab] for sub in certify.SUBSTRATES)
            _check(_bits_equal(a, b), f"analysis (d): {fam} {lab}, "
                   f"certified {rows[0][lab]['class']}, differs between "
                   "the scan:8 and ladder builds")
        checked[fam] = len(labels)
        del out
    return checked


def phase_analysis(kernels_mod, card) -> dict:
    """Phase 14: (a) dbxlint (all fourteen rules: the certifier and
    kernel-hygiene run on the CPU there) over the port package in a
    process of its own that cannot import jax, exit 0 and clean; dbxmc at
    the bench size on every available substrate, zero violations; no
    kernel launch. (b) ``lint --certify`` in the same process: exit 0, 59
    rows, no drift. (c) kernel-hygiene on the card, its kernels really
    launching: no finding, every entry of ``HYGIENE_LAUNCHES`` launched.
    (d) :func:`_substrate_bits`. Returns the hygiene's launches by
    entry."""
    from distributed_backtesting_exploration_tpu_torch.analysis import core

    kernels_mod.reset_launch_counts()
    # (a) and (b)'s process runs on the host's CPU while this one runs
    # dbxmc, (c) and (d); it is read at the end.
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", ANALYSIS_BLOCKED],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        launches = _analysis_in_process(kernels_mod, card)
        out, err = proc.communicate(timeout=400)
    finally:
        proc.kill()
        proc.wait()
    t_proc = time.perf_counter() - t0
    _check(proc.returncode == 0, f"analysis: the dbxlint process exited "
           f"{proc.returncode}:\n{out[-3000:]}{err[-3000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    res = got["lint"]
    rules = [r.name for r in core.all_rules()]
    _check(got["lint_rc"] == 0 and res["clean"] and res["rules"] == rules
           and not res["rules_skipped"],
           f"analysis: dbxlint exited {got['lint_rc']}, ran {res['rules']}, "
           f"skipped {res['rules_skipped']}, findings "
           f"{res['findings'][:3]}; want {rules} clean")
    print(f"analysis (a) ({card}): dbxlint clean over the port package in "
          f"{got['lint_s']:.2f} s ({res['suppressed']} suppressed; rules "
          f"{', '.join(rules)}); the process {t_proc:.2f} s")
    cert = got["certify"]
    _check(got["certify_rc"] == 0 and cert["rows"] == 59
           and not cert["drift"] and not cert["findings"],
           f"analysis (b): lint --certify exited {got['certify_rc']}, "
           f"{cert['rows']} rows, drift {cert['drift'][:2]}, findings "
           f"{cert['findings'][:2]}")
    print(f"analysis (b) ({card}): lint --certify clean, {cert['rows']} rows "
          f"vs {os.path.basename(cert['contract'])}, no drift, in "
          f"{got['certify_s']:.2f} s after the lint's trace")
    return launches


def _analysis_in_process(kernels_mod, card) -> dict:
    """Phase 14's part in this process: (a)'s dbxmc, then (c) and (d).
    Returns (c)'s launches by entry."""
    from distributed_backtesting_exploration_tpu_torch.analysis import (
        certify, core, fx_rules, modelcheck)
    from distributed_backtesting_exploration_tpu_torch.streaming import (
        recurrent)
    from distributed_backtesting_exploration_tpu_torch.utils import data

    dev = torch.device("cuda")
    subs = modelcheck.available_substrates()
    mc = modelcheck.explore(modelcheck.MCConfig(ops=12, seed=0,
                                                schedules=120), subs)
    _check(mc["clean"] and not mc["violations"],
           f"analysis: dbxmc found violations: {mc['violations'][:2]}")
    for sub, r in mc["substrates"].items():
        _check(r["schedules"] == 120, f"analysis: dbxmc [{sub}] explored "
               f"{r['schedules']} schedules, want 120")
        print(f"analysis (a) ({card}): dbxmc [{sub}] "
              f"schedules={r['schedules']} crash_points={r['crash_points']} "
              f"boundaries={r['boundaries']} wall_s={r['wall_s']}")
    print(f"analysis (a) ({card}): dbxmc schedules={mc['schedules']} "
          f"crash_points={mc['crash_points']} wall_s={mc['wall_s']} on "
          f"{', '.join(subs)}, 0 violations")
    launched = sum(kernels_mod.LAUNCHES.values())
    _check(launched == 0, f"analysis: {launched} kernel launches in (a)")

    t0 = time.perf_counter()
    kernels_mod.reset_launch_counts()
    pkg = str(Path(certify.__file__).resolve().parent.parent)
    findings = fx_rules.KernelHygieneRule(device=dev).check(
        core.load_context(pkg))
    torch.cuda.synchronize()
    t_hyg = time.perf_counter() - t0
    launches = dict(kernels_mod.LAUNCHES)
    _check(not findings, "analysis (c): kernel-hygiene on the card:\n"
           + "\n".join(f.format() for f in findings[:10]))
    missing = [e for e in HYGIENE_LAUNCHES if not launches.get(e)]
    _check(not missing, f"analysis (c): kernel-hygiene launched no "
           f"{missing}; launches {launches}")
    print(f"analysis (c) ({card}): kernel-hygiene on the card clean in "
          f"{t_hyg:.2f} s; launches by entry {json.dumps(launches)}")

    t0 = time.perf_counter()
    checked = _substrate_bits(recurrent, certify, data, dev)
    print(f"analysis (d) ({card}): scan:8 and ladder builds bit-identical "
          f"on every exact/selection/int-exact output ({N_TICKERS} x "
          f"{N_BARS} for {', '.join(ANALYSIS_FULL)}, {ANALYSIS_SMALL} x "
          f"{N_BARS} for the rest; outputs a family "
          f"{json.dumps(checked)}) in {time.perf_counter() - t0:.2f} s")
    return launches


# --- the rest of the reference's public API -------------------------------

API_CHUNK = 100        # (a): combos a chunk of the 2000-combo SMA grid
API_CPU_ROWS = 64      # (a), (b): tickers held against a CPU copy
API_PAIRS_CHUNK = 50   # (d)
API_RTOL, API_ATOL = 1e-5, 1e-6       # against the CPU copy


def _standalone(metrics, res, mask) -> dict:
    """The eight standalone metrics of one backtest, by ``Metrics``
    field (``turnover_total`` as ``turnover``)."""
    r, eq, pos = res.returns, res.equity, res.positions
    kw = {} if mask is None else {"mask": mask}
    return {"sharpe": metrics.sharpe(r, **kw),
            "sortino": metrics.sortino(r, **kw),
            "max_drawdown": metrics.max_drawdown(eq),
            "total_return": metrics.total_return(eq),
            "cagr": metrics.cagr(eq, **kw),
            "hit_rate": metrics.hit_rate(r, pos, **kw),
            "turnover": metrics.turnover_total(pos),
            "n_trades": metrics.n_trades(pos)}


def _near_cpu(label, got: torch.Tensor, want: torch.Tensor) -> float:
    """``got`` (on the card) against ``want`` (the same call on a CPU
    copy) within API_RTOL, API_ATOL; returns the max abs error."""
    a, b = got.cpu().numpy(), want.numpy()
    _check(np.array_equal(np.isfinite(a), np.isfinite(b)),
           f"api {label}: finite on one device only")
    fin = np.isfinite(b)
    err = np.abs(a[fin] - b[fin])
    bad = err > API_ATOL + API_RTOL * np.abs(b[fin])
    _check(not bad.any(), f"api {label}: {int(bad.sum())} values off the "
           f"CPU copy, max abs err {float(err.max())}")
    return float(err.max()) if err.size else 0.0


def _api_metrics(metrics, pnl, models, data, b, card) -> None:
    """(a) and (b): the standalone metrics and ``compound=True``."""
    dev = b.dev
    fields = data.OHLCV(*(b.panel[f][:, None, :] for f in data._FIELDS))
    g = b.grid("sma_crossover")
    strat = models.get_strategy("sma_crossover")
    lens = np.random.default_rng(15).integers(N_BARS // 2, N_BARS + 1,
                                              N_TICKERS)
    mask = (torch.arange(N_BARS, device=dev)[None, None, :]
            < torch.as_tensor(lens, device=dev)[:, None, None])
    worst: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(g["fast"]), API_CHUNK):
        cols = {k: torch.as_tensor(v[lo:lo + API_CHUNK], device=dev)[:, None]
                for k, v in g.items()}
        res = pnl.backtest_prefix(fields.close, strat.positions(fields, cols),
                                  cost=COST)
        for m in (None, mask) if lo == 0 else (None,):
            summary = metrics.summary_metrics(*res, mask=m)
            got = _standalone(metrics, res, m)
            for name, v in got.items():
                _check(torch.equal(v, getattr(summary, name)),
                       f"api (a): {name} (mask {m is not None}, combos "
                       f"{lo}..) not bit-equal to summary_metrics' field")
            if lo:
                continue
            cpu = pnl.BacktestResult(*(t[:API_CPU_ROWS].cpu() for t in res))
            want = _standalone(metrics, cpu, None if m is None
                               else m[:API_CPU_ROWS].cpu())
            for name, v in got.items():
                worst[name] = max(worst.get(name, 0.0), _near_cpu(
                    f"(a) {name}", v[:API_CPU_ROWS], want[name]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"api (a) ({card}): the 8 standalone metrics bit-equal to "
          f"summary_metrics' fields on {N_TICKERS} x {len(g['fast'])} x "
          f"{N_BARS} sma positions ({API_CHUNK} combos a chunk; the first "
          f"chunk also with a ragged mask); against a CPU copy of "
          f"{API_CPU_ROWS} tickers x {API_CHUNK} combos (rtol={API_RTOL}, "
          f"atol={API_ATOL}) max abs err {json.dumps(worst)}; "
          f"{wall:.4f} s")

    cols = {k: torch.as_tensor(v[:API_CHUNK], device=dev)[:, None]
            for k, v in g.items()}
    pos = strat.positions(fields, cols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pnl.backtest_prefix(fields.close, pos, cost=COST, compound=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = pnl.backtest_prefix(fields.close[:API_CPU_ROWS].cpu(),
                              pos[:API_CPU_ROWS].cpu(), cost=COST,
                              compound=True)
    errs = {k: _near_cpu(f"(b) {k}", getattr(res, k)[:API_CPU_ROWS],
                         getattr(cpu, k)) for k in ("returns", "equity")}
    _check(bool(torch.isfinite(res.equity).all()),
           "api (b): compound equity not finite")
    print(f"api (b) ({card}): compound=True on {N_TICKERS} x {API_CHUNK} x "
          f"{N_BARS} in {wall:.4f} s; against a CPU copy of {API_CPU_ROWS} "
          f"tickers (rtol={API_RTOL}, atol={API_ATOL}) max abs err "
          f"{json.dumps(errs)}")


def _band_step(signals, z_entry, like: torch.Tensor):
    """``signals.band_hysteresis``'s bar (``z_exit`` 0) as a
    ``backtest_scan`` step over ``(z_t, valid_t)``."""
    ze = signals._per_series(z_entry, like)
    zx = signals._per_series(0.0, like)
    one = torch.ones((), dtype=like.dtype, device=like.device)
    zero = torch.zeros((), dtype=like.dtype, device=like.device)

    def step(pos, bar):
        zt, valid_t = bar
        entered = torch.where(zt < -ze, one, torch.where(zt > ze, -one, zero))
        exit_long = (pos > 0) & (zt >= -zx)
        exit_short = (pos < 0) & (zt <= zx)
        held = torch.where(exit_long | exit_short, zero, pos)
        pos = torch.where(valid_t, torch.where(pos == 0, entered, held), zero)
        return pos, pos
    return step


def _api_scan(pnl, signals, bollinger, data, b, card) -> None:
    """(c): ``backtest_scan`` with a band-hysteresis step on the
    bollinger bench grid's z."""
    dev = b.dev
    fields = data.OHLCV(*(b.panel[f][:, None, :] for f in data._FIELDS))
    cols = {k: torch.as_tensor(v, device=dev)[:, None]
            for k, v in b.grid("bollinger").items()}
    z, valid = bollinger._z_and_valid(fields, cols)
    step = _band_step(signals, cols["k"], z)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pnl.backtest_scan(step, torch.zeros(z.shape[:-1], device=dev),
                            (z, torch.broadcast_to(valid, z.shape)),
                            fields.close, cost=COST)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = signals.band_hysteresis(z, valid, cols["k"], 0.0)
    torch.cuda.synchronize()
    t_band = time.perf_counter() - t0
    _check(torch.equal(got.positions, want), "api (c): backtest_scan's "
           "positions differ from band_hysteresis'")
    ref = pnl.backtest_prefix(fields.close, want, cost=COST)
    _check(torch.equal(got.returns, ref.returns)
           and torch.equal(got.equity, ref.equity),
           "api (c): backtest_scan's returns or equity not bit-equal to "
           "backtest_prefix of its positions")
    print(f"api (c) ({card}): backtest_scan, a band-hysteresis step over "
          f"{tuple(z.shape)} bollinger z: positions identical to "
          f"band_hysteresis, returns and equity bit-equal to backtest_prefix;"
          f" the {N_BARS}-step loop and its pricing {t_scan:.4f} s, "
          f"band_hysteresis {t_band:.4f} s")


def _np_fields(m) -> dict:
    return {n: getattr(m, n).cpu().numpy() for n in m._fields}


def _timed_s(run) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _api_pairs(pairs, data, b, card):
    """(d): ``chunked_pairs_sweep`` against ``run_pairs_sweep``. Returns
    its Metrics and wall: the bench's generic pairs arm, the same call on
    the same legs."""
    y, x = (torch.as_tensor(leg.close, device=b.dev)
            for leg in _pairs_legs(data, N_PAIRS, N_BARS, 1))
    g = b.grid("pairs")
    got, t_chunked = _timed_s(lambda: pairs.chunked_pairs_sweep(
        y, x, g, param_chunk=API_PAIRS_CHUNK, cost=COST, device=b.dev))
    want, t_run = _timed_s(lambda: pairs.run_pairs_sweep(
        y, x, g, cost=COST, device=b.dev))
    flips = _golden_check("api (d) chunked_pairs_sweep vs run_pairs_sweep",
                          _np_fields(got), want, "flip")
    print(f"api (d) ({card}): chunked_pairs_sweep {N_PAIRS} pairs x "
          f"{len(g['lookback'])} combos x {N_BARS} bars, param_chunk="
          f"{API_PAIRS_CHUNK}: {flips} flipped cells against run_pairs_sweep"
          f" (the flip rule); chunked {t_chunked:.4f} s, run_pairs_sweep "
          f"{t_run:.4f} s")
    return got, t_chunked


def _pairs_witness(sweep, pairs, data, b):
    """The generic pairs sweep with its legs in f64 (phase 4's witness,
    :func:`_gold_f64`), in chunks of 2**27 elements: eight times phase
    4's, a tenth of the Python band loops."""
    y, x = (torch.as_tensor(leg.close, dtype=torch.float64,
                            device=b.dev)[:, None, :]
            for leg in _pairs_legs(data, N_PAIRS, N_BARS, 1))
    parts = [pairs.pair_backtest(y, x, sub, cost=COST)
             for _, sub in sweep.param_chunks(
                 b.grid("pairs"), y.shape[0] * y.shape[-1], b.dev,
                 chunk_elems=1 << 27)]
    return type(parts[0])(*(torch.cat(f, dim=-1) for f in zip(*parts)))


def _bench_arm(kernels_mod, b, name: str, generic: bool, reps: int):
    """One arm of the bench's A/B: the metrics of a call of its
    ``sweep_call``, the median wall of ``reps`` more, and the launches of
    the first call (the counts reset just before)."""
    b.s = b.s._replace(generic=generic)
    run = b.sweep_call(name)
    kernels_mod.reset_launch_counts()
    m, _ = _timed_s(run)
    launches = dict(kernels_mod.LAUNCHES)
    wall = statistics.median(_timed_s(run)[1] for _ in range(reps))
    b.s = b.s._replace(generic=False)
    return m, wall, launches


def _api_bench_ab(kernels_mod, bench, sweep, pairs, data, b, pairs_generic,
                  card) -> dict:
    """(e): the port bench's generic A/B (``DBX_BENCH_GENERIC=1``) through
    its own ``sweep_call``; the generic pairs arm is (d)'s
    ``chunked_pairs_sweep`` call (``pairs_generic``: its Metrics and
    wall), the bench's own call on the same legs. Returns the fused arms'
    launches."""
    _check(bench.GENERIC_PAIRS_CHUNK == API_PAIRS_CHUNK,
           "api (e): (d) is not the bench's generic pairs call")
    out, launches = {}, {}
    for name in ("sma_fused", "pairs"):
        fused_m, fused_s, lc = _bench_arm(kernels_mod, b, name, False, 5)
        launches.update(lc)
        if name == "pairs":
            gen_m, gen_s = pairs_generic
            gen_how = "its one call in (d)"
        else:
            gen_m, gen_s, lc = _bench_arm(kernels_mod, b, name, True, 3)
            _check(not lc, f"api (e) {name}: the generic arm launched "
                   f"kernels {lc}")
            gen_how = "3 warm calls"
        got = _np_fields(fused_m)
        if name == "pairs":
            # pairs' f32 generic path leaves the flip budget (its hedge
            # ratio's f32 windowed sums cancel): the fused arm is held to
            # the generic path in f64, as in phase 4.
            t0 = time.perf_counter()
            gold = _pairs_witness(sweep, pairs, data, b)
            t_gold = time.perf_counter() - t0
            off_f32 = int(_flipped(got, gen_m, "shift", _slack(gen_m)).sum())
            f32_f64 = int(_flipped(_np_fields(gen_m), gold, "shift",
                                   _slack(gold)).sum())
            flips = _golden_check(f"api (e) {name} fused vs generic in f64",
                                  got, gold, "shift")
            rule = (f"the flip-aware budget against the generic path in f64 "
                    f"({t_gold:.4f} s); against the generic arm in f32 "
                    f"{off_f32}, the f32 arm against f64 {f32_f64}")
        else:
            flips = _golden_check(f"api (e) {name} fused vs generic", got,
                                  gen_m, "flip")
            rule = "the flip rule against the generic arm"
        n_bt = int(fused_m.sharpe.numel())
        rates = (n_bt / fused_s, n_bt / gen_s)
        out[name] = {"fused_bt_s": rates[0], "generic_bt_s": rates[1],
                     "fused_over_generic": rates[0] / rates[1],
                     "flipped": flips}
        print(f"api (e) ({card}): bench {name} {n_bt} backtests: fused "
              f"{rates[0]:.1f} backtests/s (the median of 5 warm calls), "
              f"generic {rates[1]:.1f} backtests/s ({gen_how}), "
              f"fused/generic {rates[0] / rates[1]:.2f}x; {flips} flipped "
              f"cells ({rule})")
    for entry in ("fused_sma", "pairs", "pairs_tables"):
        _check(launches.get(entry, 0) > 0, f"api (e): {entry} launched no "
               "time in the fused arms")
    print(f"api (e) fused arms' launches {json.dumps(launches)}; "
          f"{json.dumps(out)}")
    return launches


def phase_api(kernels_mod, bench, card) -> dict:
    """Phase 15: the reference's public API that the port took over last,
    at full width on phase 4's panels. Returns (e)'s launches by entry."""
    from distributed_backtesting_exploration_tpu_torch import models
    from distributed_backtesting_exploration_tpu_torch.models import (
        bollinger, pairs)
    from distributed_backtesting_exploration_tpu_torch.ops import (
        metrics, pnl, signals)
    from distributed_backtesting_exploration_tpu_torch.parallel import sweep
    from distributed_backtesting_exploration_tpu_torch.utils import data

    b = bench._Bench(bench.Settings(), torch.device("cuda"))
    t0 = time.perf_counter()
    _api_metrics(metrics, pnl, models, data, b, card)
    t_a = time.perf_counter() - t0
    _api_scan(pnl, signals, bollinger, data, b, card)
    torch.cuda.empty_cache()
    t_c = time.perf_counter() - t0 - t_a
    pairs_generic = _api_pairs(pairs, data, b, card)
    t_d = time.perf_counter() - t0 - t_a - t_c
    launches = _api_bench_ab(kernels_mod, bench, sweep, pairs, data, b,
                             pairs_generic, card)
    t_e = time.perf_counter() - t0 - t_a - t_c - t_d
    print(f"api walls (s) ({card}): (a)+(b) {t_a:.2f}, (c) {t_c:.2f}, (d) "
          f"{t_d:.2f}, (e) {t_e:.2f}")
    return launches


def _phase_wall(walls: dict, name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in ``walls[name]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        walls[name] = round(time.perf_counter() - t0, 1)


def main() -> None:
    card = phase_card()
    from distributed_backtesting_exploration_tpu_torch import bench, models
    from distributed_backtesting_exploration_tpu_torch.ops import (
        _kernels, fused, pnl, stages)
    from distributed_backtesting_exploration_tpu_torch.parallel import sweep
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        backtesting_pb2 as pb, compute, executor, panel_store, wire)
    from distributed_backtesting_exploration_tpu_torch.utils import data

    walls: dict = {}
    timed = functools.partial(_phase_wall, walls)
    timed("build", phase_build, _kernels)
    k1 = timed("kernels", phase_kernels, _kernels, fused, pnl, data)
    new = timed("new_kernels", phase_new_kernels, fused, pnl, data)
    new.update(timed("tables", phase_tables, fused, data))
    k8 = timed("stages", phase_stages, _kernels, stages, bench, data)
    launches = timed("main_path", phase_main_path, _kernels, compute, wire,
                     pb, data, sweep, models, fused)
    k1["launches"] = launches.get("fused_sma", 0)
    new_launches = timed("new_main_paths", phase_new_main_paths, _kernels,
                         compute, wire, pb, data, sweep, models, fused)
    for entry, rec in new.items():
        rec["launches"] = new_launches.get(entry, 0)
        _check(rec["launches"] > 0, f"{entry} launched no time on the main "
               "paths")
    timed("bench", phase_bench, _kernels, bench, k8)
    timed("worker_path", phase_worker_path, _kernels, compute, executor,
          wire, pb, data, sweep, models, fused, pnl, panel_store)
    wf = timed("walkforward", phase_walkforward, _kernels, compute, wire, pb,
               data, sweep, models, fused, bench, card)
    k1["walkforward_launches"] = wf.get("fused_sma", 0)
    for entry, rec in new.items():
        rec["walkforward_launches"] = wf.get(entry, 0)
    stream = timed("streaming", phase_streaming, _kernels, compute, wire,
                   pb, data, sweep, models, fused, bench, panel_store, card)
    for rec in (k1, *new.values()):
        rec["streaming_launches"] = stream.get(rec["name"], 0)
        _check(rec["streaming_launches"] > 0, f"{rec['name']} launched no "
               "time on the streaming phase's carry_out calls")
    paged, scen = timed("paged_scenarios", phase_paged_scenarios, _kernels,
                        compute, fused, pnl, pb, data, bench, panel_store,
                        wire, card)
    for rec in (k1, *new.values(), *k8):
        rec["paged_launches"] = paged.get(rec["name"], 0)
        rec["scenario_launches"] = scen.get(rec["name"], 0)
    for rec in (k1, *new.values()):
        if rec["name"] not in ("pairs", "pairs_tables"):
            _check(rec["paged_launches"] > 0 and rec["scenario_launches"] > 0,
                   f"{rec['name']} launched no time on the paged or the "
                   "scenario sweeps")
    mesh = timed("multi_device", phase_multi_device, _kernels, compute,
                 fused, pb, data, card)
    for rec in (k1, *new.values()):
        rec["mesh_launches"] = mesh.get(rec["name"], 0)
        _check(rec["mesh_launches"] > 0, f"{rec['name']} launched no time on "
               "the mesh route")
    tuned = timed("tune", phase_tune, _kernels, compute, fused, pb, data,
                  card)
    for rec in (k1, *new.values()):
        rec["tune_launches"] = tuned.get(rec["name"], 0)
    loop = timed("dispatch_loop", phase_dispatch_loop, _kernels, compute,
                 pb, wire, data, bench, card)
    for rec in (k1, *new.values(), *k8):
        rec["dispatch_launches"] = loop.get(rec["name"], 0)
    _check(k1["dispatch_launches"] > 0, "fused_sma launched no time in the "
           "dispatch loop")
    k1["obs_launches"] = timed("worker_obs", phase_worker_obs, _kernels,
                               compute, pb, wire, data, bench, card)
    k1["native_launches"] = timed("native_shell", phase_native_shell,
                                  _kernels, compute, pb, wire, data, bench,
                                  card)
    _check(k1["native_launches"] > 0, "fused_sma launched no time in the "
           "native shells")
    hygiene = timed("analysis", phase_analysis, _kernels, card)
    for rec in (k1, *new.values(), *k8):
        rec["hygiene_launches"] = hygiene.get(rec["name"], 0)
    api = timed("api", phase_api, _kernels, bench, card)
    for rec in (k1, *new.values(), *k8):
        rec["api_launches"] = api.get(rec["name"], 0)
    print(f"phase walls (s): {json.dumps(walls)}")
    print(json.dumps({"kernels": [k1, *new.values(), *k8]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def sass_of(csrc: str) -> None:
    """``python3 chip_smoke.py --sass DIR``: the SASS instructions a bar of
    every kernel of LOOP_SASS built from the sources in ``DIR`` (another
    tree's ``csrc/``, such as a parent commit's), as phase 3 prints them for
    this tree. The libraries go to this tree's ``_build/``, keyed on their
    sources' hash as every build is; nothing is written beside ``DIR``.
    Needs nvcc and cuobjdump, no card."""
    from distributed_backtesting_exploration_tpu_torch.ops import _kernels
    _kernels.SRC_DIR = Path(csrc).resolve()
    for entry in LOOP_SASS:
        loops, per_bar = _loop_sass(_kernels, entry)
        print(f"sass of {csrc}: {entry} {per_bar} a bar; loops {loops}")


# Run in each tree by ``--parent`` (``python -c``, from the tree's root):
# the table kernels at their main paths' shapes, through the tree's own
# wrappers, CUDA events around 20 calls (after 2) and the device time of a
# CUDA graph of 20 calls; one JSON line.
TABLE_TIMES = r"""
import inspect, json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from distributed_backtesting_exploration_tpu_torch import roofline
from distributed_backtesting_exploration_tpu_torch.ops import fused
from distributed_backtesting_exploration_tpu_torch.utils import data

def times(fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    for _ in range(20):
        fn()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / 20
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(20):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return {"ms": ms, "device_ms": a.elapsed_time(b) / 20}

dev = torch.device("cuda")
axes = roofline.bench_axes()
close = torch.as_tensor(data.synthetic_ohlcv(500, 1260, seed=0).close,
                        device=dev).contiguous()
trix = fused.ema_decay(dev, np.unique(axes["trix"]["span"]))
macd = fused.ema_decay(dev, np.unique(np.concatenate(
    [axes["macd"]["fast"], axes["macd"]["slow"]])))
demeaned = (close - close[:, :1]).contiguous()
legs = data.synthetic_ohlcv(2000, 1260, seed=1).close
y, x = (torch.as_tensor(c, device=dev).contiguous()
        for c in (legs[:1000], legs[1000:]))
w = np.unique(axes["pairs"]["lookback"]).astype(np.int32)
args = (y, x, x.mean(dim=1), y.mean(dim=1), torch.from_numpy(w).to(dev))
kw = ({"max_window": int(w.max())} if "max_window" in
      inspect.signature(fused.pairs_tables_cuda).parameters else {})
print(json.dumps({
    "trix": times(lambda: fused.ema_rows_cuda(close, trix, 3)),
    "macd": times(lambda: fused.ema_rows_cuda(demeaned, macd, 1)),
    "pairs_tables": times(lambda: fused.pairs_tables_cuda(*args, **kw))}))
"""
PARENT_BENCH = "pairs,trix_fused,macd_fused"


def _tree_json(tree: Path, argv: list, env: dict | None = None) -> dict:
    """The last line of ``argv``'s stdout, run from ``tree``, as JSON."""
    proc = subprocess.run(argv, cwd=tree, capture_output=True, text=True,
                          env={**os.environ, **(env or {})}, timeout=900)
    _check(proc.returncode == 0, f"{argv[1:3]} in {tree} failed "
           f"(exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def parent_compare(tree: str) -> None:
    """``python3 chip_smoke.py --parent DIR``: the table kernels
    (``dbx_ema_rows`` at trix's and macd's main-path shapes,
    ``dbx_pairs_tables`` at the bench's 1000 pairs) and the port bench's
    pairs, trix_fused and macd_fused, run from another tree ``DIR`` (an
    unpacked earlier commit) and from this one in turns: parent, change,
    change, parent, parent, change, each leg a process of its own on the
    same card. Prints each leg, the medians and one JSON line; no result
    line of the smoke run."""
    card = phase_card()
    trees = {"parent": Path(tree).resolve(),
             "change": Path(__file__).resolve().parent}
    order = ["parent", "change", "change", "parent", "parent", "change"]
    legs: dict = {"parent": [], "change": []}
    for leg in order:
        t = _tree_json(trees[leg], [sys.executable, "-c", TABLE_TIMES])
        legs[leg].append(t)
        print(f"tables {leg}: {json.dumps(t)}", flush=True)
    rates: dict = {"parent": [], "change": []}
    for leg in order:
        out = _tree_json(trees[leg], [
            sys.executable, "-m",
            "distributed_backtesting_exploration_tpu_torch.bench"],
            {"DBX_BENCH_CONFIGS": PARENT_BENCH})
        rates[leg].append(out["configs"])
        print(f"bench {leg}: " + ", ".join(
            f"{k} {v / 1e6:.4f} M/s" for k, v in out["configs"].items()),
            flush=True)
    summary = {"card": card, "tables": {}, "bench_backtests_per_s": {}}
    for leg in legs:
        summary["tables"][leg] = {
            k: {m: statistics.median(t[k][m] for t in legs[leg])
                for m in ("ms", "device_ms")} for k in legs[leg][0]}
        summary["bench_backtests_per_s"][leg] = {
            k: statistics.median(r[k] for r in rates[leg])
            for k in rates[leg][0]}
    print(json.dumps(summary))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sass":
        sass_of(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--parent":
        parent_compare(sys.argv[2])
    elif len(sys.argv) == 2 and sys.argv[1] == "--obs-split":
        obs_split()
    else:
        main()
