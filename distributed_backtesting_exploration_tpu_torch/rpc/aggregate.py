"""Fleet-level result aggregation (the reference's ``rpc/aggregate.py``):
read stored result blocks back into decisions, the best parameters per job
and the fleet-wide top performers, and compose stored best-return series
into the fleet book.

It joins the blocks a dispatcher stores (``--results-dir``, one
``<job-id>.dbxm`` file a job: DBXM, DBXS or DBXP, read by :mod:`.wire`)
with the journal's job records (strategy, grid, source path; read by
:mod:`.journal`). NumPy only, on the host: it runs where there is no card.

Param order contract: DBXM rows are the cartesian product of grid axes
sorted by name (the worker builds ``product_grid`` over sorted axes), so
aggregation re-sorts the journaled axes the same way before indexing.

    python -m distributed_backtesting_exploration_tpu_torch.rpc.aggregate \
        --results-dir DIR --journal PATH [--metric sharpe] [--portfolio]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from ..ops.metrics import Metrics, metric_sign
from . import wire
from .journal import Journal

log = logging.getLogger("dbx.torch.aggregate")


def _np_product_grid(axes: dict) -> dict:
    """NumPy twin of :func:`~..parallel.sweep.product_grid` (the same
    row-major ``indexing="ij"`` order): aggregation touches no device."""
    names = list(axes)
    mesh = np.meshgrid(*(np.asarray(axes[n]) for n in names), indexing="ij")
    return {n: m.reshape(-1) for n, m in zip(names, mesh)}


def aggregate(results_dir: str, journal_path: str, *,
              metric: str = "sharpe", top: int = 10) -> dict:
    """Join stored DBXM blocks with journaled job records.

    Returns ``{"metric", "jobs_aggregated", "jobs_missing", "best"}`` where
    ``best`` is the fleet-wide top-``top`` list of
    ``{job, strategy, path, value, mode, params}`` rows sorted best-first
    in the metric's own direction (lower-is-better metrics sort
    ascending). ``mode`` is ``"sweep"`` (``params`` = the argmax combo) or
    ``"walkforward_oos"`` (the block is one stitched out-of-sample row;
    ``params`` is empty — each refit window chose its own).
    """
    if metric not in Metrics._fields:
        raise ValueError(f"unknown metric {metric!r}; one of "
                         f"{Metrics._fields}")
    state = Journal.replay(journal_path)
    rows = []
    missing = 0
    for jid, rec in state.jobs.items():
        path = os.path.join(results_dir, f"{jid}.dbxm")
        if not os.path.exists(path):
            if jid in state.completed:
                missing += 1   # completed per journal but block not stored
            continue
        with open(path, "rb") as fh:
            blob = fh.read()
        kind = wire.result_kind(blob)
        if kind == "empty":
            continue   # validated-bad job completed with no result
        grid_idx = None
        if kind == "topk":
            # DBXS block: the worker already reduced on-device; rows are
            # best-first by the block's own rank metric, and the stored
            # indices map back into the job's canonical grid order.
            grid_idx, m, block_metric = wire.topk_from_bytes(blob)
            if block_metric != metric:
                # Lossy comparison: only the k best-by-block_metric rows
                # survived the reduction, so "best by `metric`" below means
                # best among those — say so once, loudly.
                log.warning(
                    "job %s: DBXS block was reduced by %r but aggregation "
                    "ranks by %r — the reported best is best among the "
                    "retained top-k rows only", jid, block_metric, metric)
        elif kind == "returns":
            # DBXP block: one best row (k=1 by the block's own rank
            # metric) + the return series, which this ranking path does
            # not need (`--portfolio` is the series read path).
            gi, m_row, _ret, block_metric = wire.best_returns_from_bytes(
                blob)
            grid_idx = np.asarray([gi])
            m = Metrics(*(np.asarray([v], np.float32) for v in m_row))
            if block_metric != metric:
                log.warning(
                    "job %s: DBXP block kept only the best-by-%r combo; "
                    "ranking by %r compares those single survivors",
                    jid, block_metric, metric)
        else:
            m = wire.metrics_from_bytes(blob)
        values = np.asarray(getattr(m, metric)).reshape(-1)
        if values.size == 0:
            # A structurally-valid zero-row block (e.g. a job enqueued with
            # an empty grid axis): nothing to rank; skipping beats aborting
            # the whole fleet report on np.argmax of an empty array.
            log.warning("job %s: result block has zero param rows; skipped",
                        jid)
            continue
        sign_ = metric_sign(metric)
        # NaN ranks last (numpy argmax would rank it FIRST — NaN wins every
        # comparison), matching the worker-side _topk_reduce discipline; a
        # DBXS block where fewer than k combos have a finite metric must not
        # report a NaN row as the job's best while finite rows exist.
        score = np.where(np.isnan(values), -np.inf, sign_ * values)
        idx = int(np.argmax(score))
        row = {
            "job": jid,
            "strategy": rec.get("strategy"),
            "path": rec.get("path"),
            "value": float(values[idx]),
        }
        if rec.get("wf"):
            # Walk-forward block: ONE stitched out-of-sample row, not a
            # per-combo matrix — there is no single "best param" (each
            # refit window chose its own); labeling it with grid combo 0
            # would be wrong. No grid materialization needed either.
            row["mode"] = "walkforward_oos"
            row["params"] = {}
        else:
            axes = {k: np.asarray(v, np.float32)
                    for k, v in sorted(rec.get("grid", {}).items())}
            grid = _np_product_grid(axes) if axes else {}
            row["mode"] = {"metrics": "sweep", "topk": "sweep_topk",
                           "returns": "sweep_best_returns"}[kind]
            combo = int(grid_idx[idx]) if grid_idx is not None else idx
            row["params"] = {k: float(v[combo]) for k, v in grid.items()}
        rows.append(row)
    sign = metric_sign(metric)
    # Same NaN-last discipline fleet-wide: an all-NaN job sorts below every
    # finite job instead of landing at an arbitrary position (Python sort
    # with NaN keys is order-dependent).
    rows.sort(key=lambda r: -np.inf if np.isnan(r["value"])
              else sign * r["value"], reverse=True)
    return {
        "metric": metric,
        "jobs_aggregated": len(rows),
        "jobs_missing": missing,
        "best": rows[:top],
    }


def _np_portfolio_metrics(returns: np.ndarray,
                          periods_per_year: int = 252) -> dict:
    """NumPy twin of the returns/equity subset of
    ``ops.metrics.summary_metrics`` for ONE return series (same formulas:
    population moments, additive equity ``1 + cumsum``, peak-relative
    drawdown). Held to the sweep engine's in the tests. The position-derived
    fields (hit_rate, n_trades, turnover) need per-leg exposures that DBXP
    blocks deliberately do not carry, so they are absent here."""
    r = np.asarray(returns, np.float64)
    n = max(r.shape[-1], 1)
    eps = 1e-12
    mean = r.sum() / n
    std = np.sqrt(max(np.square(r).sum() / n - mean * mean, 0.0))
    downside = np.minimum(r, 0.0)
    dstd = np.sqrt(np.square(downside).sum() / n)
    ann = np.sqrt(periods_per_year)
    equity = 1.0 + np.cumsum(r)
    peak = np.maximum.accumulate(equity)
    mdd = float(np.max((peak - equity) / np.maximum(peak, eps)))
    years = max(n / periods_per_year, eps)
    final = max(equity[-1], eps)
    return {
        "sharpe": float(mean / (std + eps) * ann),
        "sortino": float(mean / (dstd + eps) * ann),
        "max_drawdown": mdd,
        "total_return": float(equity[-1] - 1.0),
        "cagr": float(final ** (1.0 / years) - 1.0),
        "volatility": float(std * ann),
    }


_MINVAR_SHRINK = 0.1   # covariance shrinkage toward the diagonal


def _min_variance_weights(R: np.ndarray, live: np.ndarray) -> np.ndarray:
    """Correlation-aware minimum-variance weights over leg return rows.

    The unconstrained minimum of ``w'Σw`` s.t. ``w'1 = 1`` is
    ``w ∝ Σ⁻¹1``; Σ is shrunk ``(1-λ)Σ + λ diag(Σ)`` (λ=0.1) so two
    near-duplicate legs cannot blow the solve up into huge offsetting
    ±weights. Dead legs (zero variance) get weight 0; fewer than two live
    legs degrades to inverse-vol/equal exactly like that scheme's
    fallbacks. Callers normalize to unit gross exposure afterwards."""
    n = R.shape[0]
    k = int(live.sum())
    if k >= 2:
        Rl = R[live]
        cov = np.cov(Rl)
        cov = (1.0 - _MINVAR_SHRINK) * cov + _MINVAR_SHRINK * np.diag(
            np.diag(cov))
        try:
            wl = np.linalg.solve(cov, np.ones(k))
        except np.linalg.LinAlgError:
            # Singular even after shrinkage (e.g. bit-identical legs):
            # inverse-vol is the diagonal-only special case.
            wl = 1.0 / (Rl.std(axis=-1) + 1e-12)
        w = np.zeros(n)
        w[live] = wl
        return w
    if live.any():
        return np.where(live, 1.0 / (R.std(axis=-1) + 1e-12), 0.0)
    return np.ones(n)


def portfolio(results_dir: str, journal_path: str, *,
              weights: str = "equal",
              periods_per_year: int = 252, top: int = 10) -> dict:
    """Compose stored DBXP best-return series into the true fleet book.

    This is the read-path half of ``JobSpec.best_returns``: each job shipped
    its winning combo's per-bar net returns, so the fleet-level portfolio —
    which per-job metric ROWS cannot produce (cross-ticker correlations are
    lost in a scalar) — is a weighted sum of stored series. ``weights`` is
    ``"equal"``, ``"inverse_vol"`` (per-leg 1/std of its net returns), or
    ``"min_variance"`` (correlation-aware: the inverse-covariance
    minimum-variance solution ``w ∝ Σ⁻¹1`` on the stored series, with the
    covariance shrunk 10%% toward its diagonal so a near-singular Σ from
    highly correlated legs cannot produce wild ±weights; legs may receive
    negative weight — shorting a leg's strategy — and the book is
    normalized to unit GROSS exposure either way, like
    ``parallel.portfolio._normalize_weights``). All legs must share one
    bar count (compose over a uniform fleet; ragged legs error loudly
    with the offending lengths). NumPy only.
    """
    if weights not in ("equal", "inverse_vol", "min_variance"):
        raise ValueError(f"unknown weights scheme {weights!r}; "
                         "one of: equal, inverse_vol, min_variance")
    state = Journal.replay(journal_path)
    legs = []
    skipped: dict[str, list] = {}
    for jid, rec in state.jobs.items():
        path = os.path.join(results_dir, f"{jid}.dbxm")
        if not os.path.exists(path):
            # Pending jobs have no block yet — routine. A job the journal
            # says COMPLETED with no stored block is a missing leg, the
            # same quietly-thinner-book failure as a wrong-kind block
            # (aggregate()'s jobs_missing discipline).
            if jid in state.completed:
                skipped.setdefault("missing", []).append(jid)
            continue
        with open(path, "rb") as fh:
            blob = fh.read()
        kind = wire.result_kind(blob)
        if kind != "returns":
            # A completed job whose stored block is not DBXP cannot
            # contribute a leg. This is NOT routine: a fleet run with
            # --best-returns should produce only DBXP blocks, so a DBXM/
            # DBXS/empty block here means some worker ran the job as the
            # wrong kind (e.g. a slice worker that predates the
            # best-returns triage) — a book quietly missing legs is the
            # exact silent failure this accounting exists to surface.
            skipped.setdefault(kind, []).append(jid)
            continue
        grid_idx, m_row, ret, rank_metric = wire.best_returns_from_bytes(blob)
        axes = {k: np.asarray(v, np.float32)
                for k, v in sorted(rec.get("grid", {}).items())}
        grid = _np_product_grid(axes) if axes else {}
        value = (float(getattr(m_row, rank_metric))
                 if rank_metric in Metrics._fields else None)
        if value is not None and not np.isfinite(value):
            # Sanitize BEFORE the sort below: a NaN sort key makes leg
            # ordering nondeterministic (NaN is truthy, so `value or 0.0`
            # stays NaN), and library callers should never see the
            # unsanitized dict either.
            value = None
        legs.append({
            "job": jid,
            "strategy": rec.get("strategy"),
            "path": rec.get("path"),
            "rank_metric": rank_metric,
            "value": value,
            "params": {k: float(v[grid_idx]) for k, v in grid.items()},
            "returns": ret,
        })
    for kind, jids in sorted(skipped.items()):
        if kind == "missing":
            log.warning(
                "portfolio: %d job(s) completed per the journal but have no "
                "stored block — the composed book is missing these jobs: "
                "%s. Was the dispatcher run without --results-dir, or were "
                "blocks deleted?", len(jids), ", ".join(sorted(jids)))
        else:
            log.warning(
                "portfolio: skipped %d stored block(s) of kind %r (not "
                "DBXP) — the composed book is missing these jobs: %s. "
                "Re-run them on a worker that implements --best-returns "
                "(single-host rpc/worker.py does; check for slice workers "
                "completing the wrong kind)", len(jids), kind,
                ", ".join(sorted(jids)))
    if not legs:
        raise ValueError(
            f"no DBXP best-returns blocks found under {results_dir!r} — "
            "was the fleet run with --best-returns?")
    lengths = {leg["returns"].shape[0] for leg in legs}
    if len(lengths) > 1:
        raise ValueError(
            "cannot compose ragged legs into one book: bar counts "
            f"{sorted(lengths)} differ across jobs")
    R = np.stack([leg["returns"] for leg in legs]).astype(np.float64)
    live = R.std(axis=-1) > 0
    if weights == "inverse_vol":
        # A never-traded leg (flat series, std = 0) must not receive
        # 1/eps ~ 1e12 weight and collapse the book to zero — dead legs
        # get weight 0 (all-dead falls back to equal).
        if live.any():
            w = np.where(live, 1.0 / (R.std(axis=-1) + 1e-12), 0.0)
        else:
            w = np.ones(R.shape[0])
    elif weights == "min_variance":
        w = _min_variance_weights(R, live)
    else:
        w = np.ones(R.shape[0])
    w = w / max(np.abs(w).sum(), 1e-12)
    port = w @ R
    # Diversification scalar: mean off-diagonal correlation. Zero-variance
    # legs produce NaN rows in corrcoef; exclude them rather than
    # poisoning the mean.
    if int(live.sum()) >= 2:
        corr = np.corrcoef(R[live])
        k = corr.shape[0]
        avg_corr = float((corr.sum() - np.trace(corr)) / (k * (k - 1)))
    else:
        avg_corr = None
    for leg, wi in zip(legs, w):
        leg["weight"] = float(wi)
        del leg["returns"]
    legs.sort(key=lambda r: (r["value"] is None, -(r["value"] or 0.0)))
    return {
        "weights": weights,
        "legs_composed": len(legs),
        "blocks_skipped": sum(len(v) for v in skipped.values()),
        "bars": int(R.shape[1]),
        "avg_pairwise_correlation": avg_corr,
        "portfolio": _np_portfolio_metrics(port, periods_per_year),
        "legs": legs[:top],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="dbx aggregate: best params per job from stored results")
    ap.add_argument("--results-dir", required=True,
                    help="directory of <job-id>.dbxm blocks (dispatcher "
                         "--results-dir)")
    ap.add_argument("--journal", required=True,
                    help="dispatcher journal (maps job ids to specs)")
    ap.add_argument("--metric", default="sharpe",
                    choices=list(Metrics._fields))
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--portfolio", nargs="?", const="equal", default=None,
                    choices=["equal", "inverse_vol", "min_variance"],
                    help="compose stored DBXP best-return series (jobs run "
                         "with --best-returns) into the fleet book with "
                         "this weighting; prints portfolio metrics + the "
                         "diversification scalar instead of the ranking")
    args = ap.parse_args(argv)
    if args.portfolio:
        out = portfolio(args.results_dir, args.journal,
                        weights=args.portfolio, top=args.top)
        # Same non-finite discipline as the ranking path: a NaN bar in any
        # stored series (NaN source prices) NaNs every composed metric, and
        # json.dumps(allow_nan=False) would raise instead of reporting.
        for leg in out["legs"]:
            if leg["value"] is not None and not np.isfinite(leg["value"]):
                leg["value"] = None
        out["portfolio"] = {k: (v if np.isfinite(v) else None)
                            for k, v in out["portfolio"].items()}
        ac = out["avg_pairwise_correlation"]
        if ac is not None and not np.isfinite(ac):
            out["avg_pairwise_correlation"] = None
        print(json.dumps(out, indent=2, allow_nan=False))
        return
    out = aggregate(args.results_dir, args.journal, metric=args.metric,
                    top=args.top)
    # All-NaN jobs are retained in `best` (ranked last); json.dumps would
    # emit non-standard NaN/Infinity tokens for them, breaking strict
    # parsers downstream — serialize non-finite values as null instead
    # (allow_nan=False rejects inf too, so isfinite is the right gate).
    for row in out["best"]:
        if not np.isfinite(row["value"]):
            row["value"] = None
    print(json.dumps(out, indent=2, allow_nan=False))


if __name__ == "__main__":
    main()
