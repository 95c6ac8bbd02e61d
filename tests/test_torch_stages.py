"""The port's roofline stage scaffolds (``ops/stages.py``, plain versions on
the CPU) against the reference's, stage by stage.

``bench.py`` keeps its scaffolds (``stage_call``, ``boll_stage_call``)
inside a closure of ``main``, so the reference of each stage is composed
here from the same JAX functions the scaffold calls, each beside the line
of ``bench.py`` it mirrors; ``full`` is also held against the reference's
``fused_sma_sweep`` / ``fused_bollinger_sweep`` with ``table="hbm"`` (Pallas
in interpret mode on the CPU).

Tolerances:
- ``prep``, ``touch``, ``matmul`` and the SMA ``signal``: rtol=1e-5, with an
  atol of 1e-6 x the sum of the absolute terms. They are long f32 sums,
  which the packages take in other orders (the reference's MXU contraction
  and ``jnp.sum``, the port's sequential per-lane loop), over tables whose
  cumsums also associate differently (``torch.cumsum`` vs ``jnp.cumsum``).
- SMA positions identical: the ``no_ladders`` turnover row is bit-equal.
- Bollinger ``signal``, ``no_ladders`` and ``full``, and SMA ``full``: the
  reference's budget of ``torch_parity`` (rtol=2e-4, atol=2e-5, at most
  max(1, 1%) flipped cells): the packages' cumsums associate differently,
  so a z-score or SMA difference at a band or crossing can round the other
  way (ROADMAP Queue 3).

The bollinger z-table itself does not take a sum tolerance across the
packages: its windowed variance ``s2 - s1*s1/w`` cancels at short windows,
so the two packages' cumsum orders move single z values by up to a few
percent (ROADMAP Queue 3). So the bollinger ``prep`` holds the port's table
against the reference's at the flip-aware budget ``chip_smoke.py`` uses for
the families with that variance (a cell off by more than rtol=2e-3,
atol=2e-4 counts as flipped, at most max(1, 1%)), and its sum on one table
at the sum tolerance; ``touch`` and ``matmul``, whose work is those sums,
read the port's table in both packages. In the pad bars, where the close
repeats, z is rounding noise over rounding noise (up to ~1e8) in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.ops import fused as F
from distributed_backtesting_exploration_tpu_torch.ops import fused, stages
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, assert_planes_match, to_np

SUM_RTOL, SUM_ATOL_SCALE = 1e-5, 1e-6
COST, PPY = 1e-3, 252
ROWS = tuple(f"row{i}" for i in range(9))


def _grid(a_axis, b_axis):
    a, b = np.meshgrid(np.float32(a_axis), np.float32(b_axis),
                       indexing="ij")
    return a.reshape(-1), b.reshape(-1)


def _dot(tbl, onehot):
    # bench.py:304-307 (SMA) and :526-529 (bollinger): the selection
    # contraction over the table's window axis at full f32 precision.
    return jax.lax.dot_general(tbl, onehot, (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)


def _no_ladder_rows(pos, r, t_idx, tr, sma: bool):
    # bench.py:335-360 (SMA) and :549-565 (bollinger).
    row_ok = t_idx < tr
    pos_last = F._row_at(pos, tr, t_idx, keepdims=True)
    pos = jnp.where(row_ok, pos, pos_last)
    prev = F._shift_down(pos, 1, 0.0)
    net = prev * r - 1e-3 * jnp.abs(pos - prev)
    n_f = jnp.asarray(tr, jnp.float32)
    s1 = jnp.sum(net, axis=0)
    s2 = jnp.sum(net * net, axis=0)
    meanv = s1 / n_f
    std = jnp.sqrt(jnp.maximum(s2 / n_f - meanv * meanv, 0.0))
    turnover = jnp.sum(jnp.abs(pos - prev), axis=0)
    if not sma:
        return jnp.stack([s1, s2, meanv, std, std, s1, turnover, std, s1])
    down = jnp.minimum(net, 0.0)
    dstd = jnp.sqrt(jnp.sum(down * down, axis=0) / n_f)
    active = (jnp.abs(prev) > 0) & row_ok
    wins = (net > 0) & active
    hit = jnp.sum(wins.astype(jnp.float32), axis=0) / (
        jnp.sum(active.astype(jnp.float32), axis=0) + 1e-12)
    return jnp.stack([s1, s2, meanv, std, dstd, hit, turnover, std, s1])


def _cell(stage, r, tbl, onehot, warm, k, tr):
    """One ticker's cell of ``stage_kernel`` (bench.py:287-360) or, with a
    per-lane ``k``, ``boll_stage_kernel`` (:509-565), over all padded lanes
    at once: the one-value stages as one row, the others as their rows."""
    if stage == "touch":                                   # :299-303, :519
        return jnp.full((1, onehot.shape[1]), jnp.sum(tbl), jnp.float32)
    x = _dot(tbl, onehot)
    t_idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
    if stage == "matmul":                                  # :309-312, :531
        return jnp.sum(x, axis=0)[None]
    valid = t_idx >= (warm[0, :][None, :].astype(jnp.int32) - 1)
    epi = "ladder" if stage.endswith("_ladder") else "scan"
    if k is None:
        pos = jnp.where(valid, jnp.sign(x), 0.0)           # :313-315
    else:
        pos = F._band_ladder(x, valid, k[0, :][None, :], 0.0, epi)  # :538
    if stage in ("signal", "signal_ladder"):               # :316-320, :539
        return jnp.sum(pos * r, axis=0)[None]
    if stage in ("full", "full_ladder"):                   # :322-333, :546
        return F._metrics_tail(pos, r, t_idx, tr, cost=COST, ppy=PPY,
                               epilogue=epi)[:9]
    return _no_ladder_rows(pos, r, t_idx, tr, sma=k is None)


def _ref_sma(close, fast, slow, stage):
    """The reference SMA scaffold's rows of ``stage``, ``(rows, N, P)``."""
    windows, onehot_d, warm = F._grid_setup(fast.tobytes(), slow.tobytes())
    T = close.shape[1]
    close_p = F._pad_last(jnp.asarray(close), F._round_up(T, 8))  # :364
    tbl = F._sma_table(close_p, windows, onehot_d.shape[0])       # :365
    r3 = F._rets3(close_p)                                        # :366
    P = fast.shape[0]
    if stage == "prep":                                           # :368-372
        out = jnp.sum(tbl, axis=(1, 2))[:, None] + r3[:, 0, :]
        return np.broadcast_to(np.asarray(out)[None], (1, out.shape[0], P))
    cells = [_cell(stage, r3[i], tbl[i], onehot_d, warm, None, T)
             for i in range(close.shape[0])]
    return np.stack([np.asarray(c)[:, :P] for c in cells], axis=1)


def _ref_boll(close, window, k, stage, table=None):
    """The reference bollinger scaffold's rows of ``stage``; with ``table``
    (the port's z-table), on that table instead of its own."""
    bwindows, onehot, klanes, warm = F._boll_grid_setup(
        window.tobytes(), k.tobytes())                            # :567
    T = close.shape[1]
    T_pad = F._round_up(T, 128)
    close_p = F._pad_last(jnp.asarray(close), T_pad)              # :571
    xc = close_p - jnp.mean(close_p[:, :T], axis=1, keepdims=True)
    w_col, w_f, t_row, windowed_sum, _ = F._cumsum_window_tools(
        bwindows, T_pad)                                          # :574
    m = windowed_sum(close_p) / w_f
    s1 = windowed_sum(xc)
    s2 = windowed_sum(xc * xc)
    var = jnp.maximum((s2 - s1 * s1 / w_f) / w_f, 0.0)
    z = (close_p[:, None, :] - m) / (jnp.sqrt(var) + 1e-12)
    z = F._pad_w(jnp.where((t_row >= w_col - 1)[None], z, 0.0),
                 onehot.shape[0])                                 # :581
    if stage == "table":
        return np.asarray(z)
    if table is not None:
        z = jnp.asarray(table)
    r3 = F._rets3(close_p)
    P = window.shape[0]
    if stage == "prep":                                           # :583-586
        out = jnp.sum(z, axis=(1, 2))[:, None] + r3[:, 0, :]
        return np.broadcast_to(np.asarray(out)[None], (1, out.shape[0], P))
    cells = [_cell(stage, r3[i], z[i], onehot, warm, klanes, T)
             for i in range(close.shape[0])]
    return np.stack([np.asarray(c)[:, :P] for c in cells], axis=1)


def _port(kind, close, a, b, stage):
    """The port's rows of ``stage`` (plain versions on the CPU) and its
    inputs."""
    make = stages.sma_stage_inputs if kind == "sma" else \
        stages.boll_stage_inputs
    inp = make(close, a, b, device="cpu")
    if stage == "prep":
        return to_np(stages.prep_value(inp))[None], inp
    run = stages.sma_stage if kind == "sma" else stages.boll_stage
    return to_np(run(inp, stage=stage)), inp


def _abs_terms(inp, stage):
    """Per-(ticker, lane) sum of the absolute terms of a summing stage."""
    tbl = inp.table.abs()
    if stage in ("prep", "touch"):
        P = inp.row_a.shape[0]
        return to_np(tbl.sum(dim=(1, 2)))[:, None].repeat(P, axis=1)
    a, b = inp.row_a.long(), inp.row_b
    x = inp.table[:, a] - inp.table[:, b.long()] if b is not None else \
        inp.table[:, a]
    if stage == "matmul":
        return to_np(x.abs().sum(dim=-1))
    t = torch.arange(x.shape[-1])
    live = t[None, :] >= inp.warm.long()[:, None] - 1            # (P, T)
    return to_np((x.sign() * inp.r[:, None] * live).abs().sum(dim=-1))


def _assert_sum_matches(got, want, inp, stage):
    atol = SUM_ATOL_SCALE * _abs_terms(inp, stage)
    assert got.shape[1:] == want.shape[1:]
    err = np.abs(got[0] - want[0])
    bad = err > atol + SUM_RTOL * np.abs(want[0])
    assert not bad.any(), (stage, float(err.max()))


SMA_CASES = [
    (3, 200, [3, 5, 8], [13, 21, 34], 0),          # T a multiple of 8
    (2, 251, [4, 6, 9, 12], [17, 29], 3),           # 5 pad bars
    (2, 64, [5, 30], [40, 90], 2),                  # windows beyond T
]
BOLL_CASES = [
    (3, 128, [5, 10, 20], [0.5, 1.0, 2.0], 0),
    (2, 256, [5, 8, 11, 14, 17], [0.75, 1.5], 4),   # 5 windows: W_pad 8
]
BOLL_PADDED = (2, 200, [5, 10, 20], [0.5, 1.0, 2.0], 6)


@pytest.mark.parametrize("n,T,fast_axis,slow_axis,seed", SMA_CASES)
@pytest.mark.parametrize("stage", stages.SMA_STAGES)
def test_sma_stage_matches_reference(stage, n, T, fast_axis, slow_axis,
                                     seed):
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    fast, slow = _grid(fast_axis, slow_axis)
    got, inp = _port("sma", close, fast, slow, stage)
    want = _ref_sma(close, fast, slow, stage)
    if stage in ("prep", "touch", "matmul", "signal"):
        _assert_sum_matches(got, want, inp, stage)
    elif stage == "no_ladders":
        np.testing.assert_array_equal(got[6], want[6], err_msg="turnover")
        assert_planes_match(list(got), list(want), ROWS)
    else:
        assert_planes_match(list(got), list(want), fused.Metrics._fields)


@pytest.mark.parametrize("n,T,window_axis,k_axis,seed",
                         BOLL_CASES + [BOLL_PADDED])
@pytest.mark.parametrize("stage", stages.BOLL_STAGES)
def test_boll_stage_matches_reference(stage, n, T, window_axis, k_axis,
                                      seed):
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    k, window = _grid(k_axis, window_axis)
    got, inp = _port("boll", close, window, k, stage)
    if stage in ("prep", "touch", "matmul"):
        table = to_np(inp.table)
        if stage == "prep":
            ref = _ref_boll(close, window, k, "table")
            assert_planes_match([table[..., :T]], [ref[..., :T]], ["z"],
                                rtol=2e-3, atol=2e-4, drift_counts=True)
        want = _ref_boll(close, window, k, stage, table=table)
        _assert_sum_matches(got, want, inp, stage)
    else:
        want = _ref_boll(close, window, k, stage)
        assert_planes_match(list(got), list(want), ROWS[:got.shape[0]])


@pytest.mark.parametrize("n,T,fast_axis,slow_axis,seed", SMA_CASES[:2])
def test_sma_full_matches_reference_sweep(n, T, fast_axis, slow_axis, seed):
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    fast, slow = _grid(fast_axis, slow_axis)
    got, _ = _port("sma", close, fast, slow, "full")
    want = F.fused_sma_sweep(jnp.asarray(close), fast, slow, cost=COST,
                             table="hbm")
    assert_metrics_match(fused.Metrics(*got), want)


@pytest.mark.parametrize("case", [BOLL_CASES[0], BOLL_PADDED])
def test_boll_full_matches_reference_sweep(case):
    n, T, window_axis, k_axis, seed = case
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    k, window = _grid(k_axis, window_axis)
    got, _ = _port("boll", close, window, k, "full")
    want = F.fused_bollinger_sweep(jnp.asarray(close), window, k, cost=COST,
                                   table="hbm")
    assert_metrics_match(fused.Metrics(*got), want)


def test_full_equals_the_ports_own_sweeps():
    # The full stage is the shipped kernel end to end: on an unpadded T it
    # equals the port's fused sweeps (both sequential, one table order).
    close = data.synthetic_ohlcv(2, 128, seed=8).close
    fast, slow = _grid([3, 5, 8], [13, 21])
    got = stages.sma_stage_call(close, fast, slow, stage="full", device="cpu")
    want = fused.fused_sma_sweep(close, fast, slow, cost=COST, device="cpu")
    np.testing.assert_array_equal(to_np(got), to_np(want.sharpe))
    k, window = _grid([0.5, 1.5], [5, 10, 20])
    inp = stages.boll_stage_inputs(close, window, k, device="cpu")
    got = stages.boll_stage(inp, stage="full")
    # The sweep centers and sums over the same 128 bars.
    want = fused.fused_bollinger_sweep(close, window, k, cost=COST,
                                       device="cpu")
    for i, name in enumerate(fused.Metrics._fields):
        np.testing.assert_array_equal(to_np(got[i]),
                                      to_np(getattr(want, name)), name)


def test_ladder_stages_run_the_same_design():
    close = data.synthetic_ohlcv(2, 100, seed=5).close
    fast, slow = _grid([3, 5], [13, 21])
    inp = stages.sma_stage_inputs(close, fast, slow, device="cpu")
    assert torch.equal(stages.sma_stage(inp, stage="full"),
                       stages.sma_stage(inp, stage="full_ladder"))
    k, window = _grid([0.5, 1.5], [5, 10])
    inp = stages.boll_stage_inputs(close, window, k, device="cpu")
    assert torch.equal(stages.boll_stage(inp, stage="signal"),
                       stages.boll_stage(inp, stage="signal_ladder"))


@pytest.mark.parametrize("lanes", stages.LANES)
def test_touch_plain_is_the_kernels_tree_sum(lanes):
    # The plain touch repeats the kernel's fixed order (64 chunks, four
    # float4 accumulators a lane, fixed trees), set by the table's shape
    # alone: every lane count gives the same bits, and against a float64
    # sum it holds at the f32 sum's bound.
    tbl = torch.from_numpy(
        np.random.default_rng(lanes).normal(100, 10, (2, 8, 200))
        .astype(np.float32))
    inp = stages.StageInputs(torch.zeros((2, 200)), tbl,
                             torch.zeros(3, dtype=torch.int32), None, None,
                             torch.ones(3, dtype=torch.int32), 200)
    got = stages.sma_stage_plain(inp, stage="touch", lanes=lanes)
    assert got.shape == (9, 2, 3)
    exact = tbl.double().sum(dim=(1, 2))
    n = tbl[0].numel()
    np.testing.assert_allclose(to_np(got[0, :, 0]), to_np(exact),
                               rtol=n * 2 ** -24)
    for lanes_b in stages.LANES:
        assert torch.equal(
            got, stages.boll_stage_plain(inp, stage="touch", lanes=lanes_b))


def _touch_walk(table: np.ndarray) -> np.float32:
    """csrc/stages.cu ``touch_sum`` on one (W, T) table, walked as its
    threads do, one float32 operation at a time."""
    f = np.float32
    flat = table.reshape(-1)
    m4 = flat.size // 4
    q = -(-m4 // stages.TOUCH_CHUNKS)
    passes = -(-q // (4 * 32))

    def butterfly(v):
        for off in (16, 8, 4, 2, 1):
            v = np.array([f(v[i] + v[i ^ off]) for i in range(32)], f)
        assert (v == v[0]).all()
        return v[0]

    sums = []
    for c in range(stages.TOUCH_CHUNKS):
        n_words = min(q, m4 - c * q)
        lanes = []
        for lane in range(32):
            acc = np.zeros((4, 4), f)
            for j in range(passes):
                for u in range(4):
                    i = (j * 4 + u) * 32 + lane
                    at = (c * q + i) * 4
                    x = flat[at:at + 4] if i < n_words else np.zeros(4, f)
                    acc[u] = acc[u] + x
            s = [f(f(a[0] + a[1]) + f(a[2] + a[3])) for a in acc]
            lanes.append(f(f(s[0] + s[1]) + f(s[2] + s[3])))
        sums.append(butterfly(np.array(lanes, f)))
    return butterfly(np.array([f(sums[i] + sums[i + 32]) for i in range(32)],
                              f))


@pytest.mark.parametrize("W,T", [(8, 200), (24, 128), (3, 4)])
def test_touch_plain_matches_the_kernels_walk(W, T):
    tbl = np.random.default_rng(W).normal(100, 10, (2, W, T)).astype(
        np.float32)
    got = to_np(stages._touch_plain(torch.from_numpy(tbl), 1))
    for n in range(2):
        assert got[n, 0].tobytes() == _touch_walk(tbl[n]).tobytes()


def test_stage_and_lanes_are_checked():
    close = data.synthetic_ohlcv(1, 40, seed=1).close
    with pytest.raises(ValueError, match="stage"):
        stages.sma_stage_call(close, [3.0], [10.0], stage="signal_ladder",
                              device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        stages.boll_stage_call(close, [5.0], [1.0], stage="full", lanes=64,
                               device="cpu")


def test_stage_calls_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    close = data.synthetic_ohlcv(1, 40, seed=1).close
    with pytest.raises(RuntimeError, match="cuda"):
        stages.sma_stage_call(close, [3.0], [10.0], stage="full")


@pytest.mark.parametrize("dispatch,plain,cuda", [
    ("sma_stage", "sma_stage_plain", "sma_stage_cuda"),
    ("boll_stage", "boll_stage_plain", "boll_stage_cuda"),
])
def test_stage_entries_never_take_the_plain_version_off_the_cpu(
        monkeypatch, dispatch, plain, cuda):
    calls = []
    monkeypatch.setattr(stages, cuda, lambda *a, **k: calls.append("cuda"))
    monkeypatch.setattr(stages, plain, lambda *a, **k: calls.append("plain"))
    for r in (torch.empty((2, 8), device="meta"), torch.empty((2, 8))):
        inp = stages.StageInputs(r, None, None, None, None, None, 8)
        getattr(stages, dispatch)(inp, stage="full")
    assert calls == ["cuda", "plain"]


@pytest.mark.parametrize("kind", ["sma", "boll"])
def test_stage_kernel_wrappers_refuse_cpu_tensors(kind):
    close = data.synthetic_ohlcv(1, 40, seed=1).close
    make = stages.sma_stage_inputs if kind == "sma" else \
        stages.boll_stage_inputs
    inp = make(close, [3.0], [10.0] if kind == "sma" else [1.0],
               device="cpu")
    wrapper = getattr(stages, f"{kind}_stage_cuda")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(inp, stage="full")
