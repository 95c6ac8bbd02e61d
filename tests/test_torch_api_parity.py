"""The port's public surface held against the JAX package's, read with ast.

For every module of ``distributed_backtesting_exploration_tpu`` the port
module at the same relative path (``MODULES`` maps the one that was
renamed) must have each public top-level function and class, each public
method (and ``__init__``) of those classes, each parameter name of those
functions and methods, and each name the package ``__init__`` exports
(its relative imports and ``__all__``; a submodule export is met by the
port's submodule). A name or keyword the port does not have must stand in
one of the two tables below, each entry with its reason:

- ``RENAMED``: the reference's name and where the port has it instead.
- ``JAX_ONLY``: a name or keyword with no meaning outside JAX, XLA or the
  TPU, or one the port dropped on purpose.

An entry is ``"module"``, ``"module:Name"``, ``"module:Class.method"`` or
any of those with ``"(param)"``. Stale entries fail too: a key the
reference no longer has, a ``RENAMED`` target the port lacks, or a
``JAX_ONLY`` entry the port has after all. Nothing here imports either
package: both are only parsed.
"""

from __future__ import annotations

import ast
import functools
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF_PKG = ROOT / "distributed_backtesting_exploration_tpu"
PORT_PKG = ROOT / "distributed_backtesting_exploration_tpu_torch"

# Reference module -> the port module that holds its surface.
MODULES = {"analysis/jaxpr_rules.py": "analysis/fx_rules.py"}

# Reference name -> (the port's name or names, why).
RENAMED = {
    "parallel/sweep.py:jit_sweep": (
        "parallel/sweep.py:run_sweep",
        "the port's sweep is not jitted; the name said it was"),
    "rpc/compute.py:JaxSweepBackend": (
        "rpc/compute.py:TorchSweepBackend",
        "the backend is the PyTorch one"),
    "ops/rolling.py:rolling_extrema_traced": (
        ("ops/rolling.py:rolling_max", "ops/rolling.py:rolling_min"),
        "a traced window is a tensor window, bounded by max_window"),
    "ops/rolling.py:rolling_extrema_traced(mode)": (
        ("ops/rolling.py:rolling_max", "ops/rolling.py:rolling_min"),
        "mode picks max or min: a function each"),
    "parallel/multihost.py:initialize(coordinator_address)": (
        "parallel/multihost.py:initialize(init_method)",
        "torch.distributed's rendezvous address"),
    "parallel/multihost.py:initialize(num_processes)": (
        "parallel/multihost.py:initialize(world_size)",
        "torch.distributed's name for it"),
    "parallel/multihost.py:initialize(process_id)": (
        "parallel/multihost.py:initialize(rank)",
        "torch.distributed's name for it"),
}

_INTERPRET = "Pallas interpret mode; a CUDA kernel has none (the CPU runs " \
             "the plain version)"
_AXIS_NAME = "a shard_map collective axis; the port passes its Mesh"
_FUSED = ("fused_sma_sweep", "fused_bollinger_sweep",
          "fused_bollinger_touch_sweep", "fused_momentum_sweep",
          "fused_donchian_sweep", "fused_donchian_hl_sweep",
          "fused_vwap_sweep", "fused_rsi_sweep", "fused_stochastic_sweep",
          "fused_keltner_sweep", "fused_macd_sweep", "fused_obv_sweep",
          "fused_trix_sweep", "fused_pairs_sweep", "fused_paged_sweep",
          "fused_scenario_sweep")
_TIMESHARD = ("sharded_cumsum", "sharded_linear_scan", "sharded_ema",
              "sharded_band_positions", *(
                  f"sharded_{f}_backtest" for f in (
                      "sma", "bollinger", "bollinger_touch", "rsi", "pairs",
                      "donchian", "donchian_hl", "stochastic", "trix",
                      "momentum", "keltner", "vwap", "macd", "obv")))

# Reference name or keyword -> why the port has none.
JAX_ONLY = {
    **{f"ops/fused.py:{f}(interpret)": _INTERPRET for f in _FUSED},
    **{f"parallel/timeshard.py:{f}(axis_name)": _AXIS_NAME
       for f in _TIMESHARD},
    "parallel/portfolio.py:sharded_portfolio_returns(axis)":
        "a shard_map psum axis; the port reduces over its Mesh",
    "parallel/timeshard.py:chunked_scan(unroll)":
        "a lax.scan compile knob; the port's loop is eager",
    "ops/signals.py:band_hysteresis(unroll)":
        "a lax.scan compile knob; the port's loop is eager",
    "ops/pnl.py:backtest_scan(unroll)":
        "a lax.scan compile knob; the port's loop is eager",
    "parallel/_shardmap_compat.py":
        "shims jax.shard_map across JAX versions",
    "analysis/dataflow.py:as_jaxprs":
        "walks jaxprs; the port walks torch.fx graphs",
    "analysis/dataflow.py:analyze(closed)":
        "a ClosedJaxpr; the port's analyze takes an fx graph",
    "tune/compile_cache.py:configure(min_compile_time_s)":
        "XLA's persistent compilation cache thresholds; nvcc builds are "
        "always kept",
    "tune/compile_cache.py:configure(min_entry_bytes)":
        "XLA's persistent compilation cache thresholds; nvcc builds are "
        "always kept",
    "parallel/sweep.py:map_param_chunks(param_chunk)":
        "the port sizes chunks by elements; the chunked_* sweeps take "
        "param_chunk",
    "ops/fused.py:route_substrates":
        "picks among TPU substrates; the port has one substrate and "
        "dropped it",
    "ops/fused.py:substrate_defaults":
        "the TPU substrates' defaults; the port has one substrate",
    "ops/fused.py:tuned_schedule_active":
        "reports a tuned TPU substrate; the port has one substrate",
    "ops/rolling.py:ema(fill)": "the reference's body never reads it",
}


def _params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    return [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)
            if x.arg not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__init__"


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _top_nodes(tree: ast.Module):
    """The module's top-level statements, with those under a top-level
    ``if`` or ``try`` (a conditional import or definition)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop(0)
        yield node
        if isinstance(node, (ast.If, ast.Try)):
            stack.extend(node.body + node.orelse
                         + getattr(node, "finalbody", [])
                         + [s for h in getattr(node, "handlers", [])
                            for s in h.body])


class _Module:
    """One module's surface: ``names`` every top-level binding (defs,
    classes, assignments, imports, ``__all__``); ``api`` the public
    functions and methods -> their parameter names (classes -> None);
    ``exports`` what a package ``__init__`` re-exports (relative imports
    and ``__all__``), ``submodules`` the exports that are submodules."""

    def __init__(self, text: str, is_package: bool):
        tree = ast.parse(text)
        self.names: set[str] = set()
        self.api: dict[str, list[str] | None] = {}
        self.exports: set[str] = set()
        self.submodules: set[str] = set()
        self.classes: dict[str, ast.ClassDef] = {}
        self.top = list(_top_nodes(tree))
        for node in self.top:
            if isinstance(node, _DEFS):
                self.names.add(node.name)
                if _public(node.name) and node.name != "__init__":
                    self.api.setdefault(node.name, []).extend(_params(node))
            elif isinstance(node, ast.ClassDef):
                self.names.add(node.name)
                self.classes[node.name] = node
                if not node.name.startswith("_"):
                    self.api[node.name] = None
                    for sub in node.body:
                        if isinstance(sub, _DEFS) and _public(sub.name):
                            # A property's setter adds its parameter.
                            self.api.setdefault(f"{node.name}.{sub.name}",
                                                []).extend(_params(sub))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.names.add(t.id)
                        if t.id == "__all__" and is_package and isinstance(
                                node.value, (ast.List, ast.Tuple)):
                            listed = {e.value for e in node.value.elts
                                      if isinstance(e, ast.Constant)}
                            self.exports |= listed
                            self.names |= listed
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    self.names.add(bound)
                    if (is_package and isinstance(node, ast.ImportFrom)
                            and node.level and not bound.startswith("_")):
                        self.exports.add(bound)
                        if node.module is None:
                            self.submodules.add(bound)

    def methods(self, cls: str) -> set[str]:
        """Methods of class ``cls``, with those of its bases defined in
        this module."""
        node = self.classes.get(cls)
        if node is None:
            return set()
        out = {s.name for s in node.body if isinstance(s, _DEFS)}
        for base in node.bases:
            if isinstance(base, ast.Name) and base.id != cls:
                out |= self.methods(base.id)
        return out

    def params_of(self, qual: str) -> list[str] | None:
        """The parameters of function or method ``qual`` (None where this
        module does not define it)."""
        cls, _, meth = qual.rpartition(".")
        if not cls:
            nodes = self.top
        elif cls in self.classes:
            nodes = self.classes[cls].body
        else:
            return None
        found = [p for n in nodes if isinstance(n, _DEFS) and n.name == meth
                 for p in _params(n)]
        if any(isinstance(n, _DEFS) and n.name == meth for n in nodes):
            return found
        if cls:
            for base in self.classes[cls].bases:
                if isinstance(base, ast.Name) and base.id in self.classes:
                    got = self.params_of(f"{base.id}.{meth}")
                    if got is not None:
                        return got
        return None

    def has(self, qual: str) -> bool:
        cls, _, meth = qual.rpartition(".")
        if not cls:
            return qual in self.names
        return meth in self.methods(cls)


@functools.lru_cache(maxsize=None)
def _parsed(text: str, is_package: bool) -> _Module:
    return _Module(text, is_package)


def _module(path: Path) -> _Module:
    """The surface of the module at ``path``, parsed once a content."""
    return _parsed(path.read_text(), path.name == "__init__.py")


def _split(entry: str) -> tuple[str, str, str]:
    """``"mod:Name(param)"`` -> ``("mod", "Name", "param")``; the parts
    absent are empty."""
    mod, _, rest = entry.partition(":")
    name, _, param = rest.partition("(")
    return mod, name, param.rstrip(")")


def _port_has(entry: str, port_root: Path) -> bool:
    mod, name, param = _split(entry)
    path = port_root / mod
    if not path.exists():
        return False
    if not name:
        return True
    m = _module(path)
    if not m.has(name):
        return False
    return not param or param in (m.params_of(name) or [])


def _ref_has(entry: str, ref_root: Path) -> bool:
    mod, name, param = _split(entry)
    path = ref_root / mod
    if not path.exists():
        return False
    if not name:
        return True
    m = _module(path)
    if param:
        return param in (m.api.get(name) or [])
    return name in m.api or name in m.exports


def _target(entry: str, renamed: dict) -> tuple[str, ...] | None:
    """Where ``renamed`` puts ``entry``: its own row, or (for a member of
    a renamed class or a keyword of a renamed function) its owner's."""
    if entry in renamed:
        tgt = renamed[entry][0]
        return (tgt,) if isinstance(tgt, str) else tuple(tgt)
    mod, name, param = _split(entry)
    owner = name.split(".")[0]
    if param and f"{mod}:{name}" in renamed:
        return tuple(f"{t}({param})" for t in
                     _target(f"{mod}:{name}", renamed))
    if "." in name and f"{mod}:{owner}" in renamed:
        (new_owner,) = _target(f"{mod}:{owner}", renamed)
        new_mod, new_name, _ = _split(new_owner)
        member = name.split(".", 1)[1]
        return (f"{new_mod}:{new_name}.{member}"
                + (f"({param})" if param else ""),)
    return None


def surface_gaps(rel: str, ref_root: Path = REF_PKG,
                 port_root: Path = PORT_PKG, renamed: dict = RENAMED,
                 jax_only: dict = JAX_ONLY) -> list[str]:
    """The entries of reference module ``rel`` that the port lacks and
    neither table accounts for."""
    if rel in jax_only:
        return []
    port_rel = MODULES.get(rel, rel)
    if not (port_root / port_rel).exists():
        return [rel]
    ref = _module(ref_root / rel)
    want = [f"{rel}:{name}" for name in ref.api]
    want += [f"{rel}:{name}({p})" for name, params in ref.api.items()
             for p in params or ()]
    want += [f"{rel}:{name}" for name in sorted(ref.exports - set(ref.api))]
    gaps = []
    for entry in want:
        if entry in jax_only:
            continue
        _, name, param = _split(entry)
        if f"{rel}:{name}" in jax_only or \
                f"{rel}:{name.split('.')[0]}" in jax_only:
            continue
        tgt = _target(entry, renamed)
        if tgt is not None:
            gaps += [f"{entry} -> {t}" for t in tgt
                     if not _port_has(t, port_root)]
            continue
        if name in ref.submodules and not param:
            present = (port_root / Path(port_rel).parent
                       / f"{name}.py").exists() or (
                port_root / Path(port_rel).parent / name).is_dir()
        else:
            present = _port_has(f"{port_rel}:{name}"
                                + (f"({param})" if param else ""), port_root)
        if not present:
            gaps.append(entry)
    return gaps


def stale_entries(ref_root: Path = REF_PKG, port_root: Path = PORT_PKG,
                  renamed: dict = RENAMED,
                  jax_only: dict = JAX_ONLY) -> list[str]:
    """Table entries that no longer hold: a key the reference lacks, a
    ``RENAMED`` target the port lacks, or a ``JAX_ONLY`` name the port
    has after all."""
    out = [f"{k}: not in the reference" for k in (*renamed, *jax_only)
           if not _ref_has(k, ref_root)]
    for k in renamed:
        out += [f"{k}: target {t} not in the port"
                for t in _target(k, renamed) if not _port_has(t, port_root)]
    for k in jax_only:
        mod, name, param = _split(k)
        port_entry = f"{MODULES.get(mod, mod)}:{name}" if name else \
            MODULES.get(mod, mod)
        if param:
            port_entry += f"({param})"
        if _port_has(port_entry, port_root):
            out.append(f"{k}: the port has it")
    return out


REF_MODULES = sorted(str(p.relative_to(REF_PKG))
                     for p in REF_PKG.rglob("*.py"))

# What the port took over from the reference's surface last: none of it may
# stand in either table, and the port must have each.
PORTED = (
    *(f"ops/metrics.py:{f}" for f in (
        "sharpe", "sortino", "max_drawdown", "total_return", "cagr",
        "hit_rate", "turnover_total", "n_trades")),
    "ops/pnl.py:log_returns", "ops/pnl.py:backtest_prefix(compound)",
    "ops/pnl.py:backtest_scan", "models/pairs.py:chunked_pairs_sweep",
    "parallel/walkforward.py:window_starts",
    "streaming/recurrent.py:keltner_true_range",
    "rpc/compute.py:ComputeBackend", "rpc/worker.py:pipeline_enabled",
    "rpc/worker.py:pipeline_depth",
    *(f"ops/__init__.py:{f}" for f in (
        "rolling_std", "rolling_var", "rolling_ols", "rolling_zscore", "ema",
        "rolling_max", "rolling_min", "band_hysteresis", "sharpe",
        "sortino", "max_drawdown", "total_return", "cagr", "hit_rate",
        "n_trades", "log_returns", "backtest_scan")),
    "streaming/__init__.py:metric_delta",
)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_port_module_has_the_reference_surface(rel):
    gaps = surface_gaps(rel)
    assert not gaps, (f"the port lacks {gaps}: port them, or add each to "
                      "RENAMED or JAX_ONLY with its reason")


def test_no_table_entry_is_stale():
    assert stale_entries() == []


@pytest.mark.parametrize("table", ["RENAMED", "JAX_ONLY"])
def test_every_table_entry_carries_its_reason(table):
    rows = globals()[table]
    reasons = {k: (v[1] if table == "RENAMED" else v)
               for k, v in rows.items()}
    blank = [k for k, why in reasons.items()
             if not isinstance(why, str) or len(why.split()) < 3]
    assert not blank, blank


@pytest.mark.parametrize("entry", PORTED)
def test_ported_name_is_in_the_port_and_in_neither_table(entry):
    mod, name, _ = _split(entry)
    assert entry not in RENAMED and entry not in JAX_ONLY
    assert f"{mod}:{name}" not in RENAMED and f"{mod}:{name}" not in JAX_ONLY
    assert _ref_has(entry, REF_PKG), entry
    assert _port_has(entry, PORT_PKG), entry


def _copy_tree(tmp_path: Path, rel: str) -> Path:
    """A reference tree in ``tmp_path`` holding module ``rel`` alone."""
    dst = tmp_path / "ref" / rel
    dst.parent.mkdir(parents=True)
    shutil.copy(REF_PKG / rel, dst)
    return tmp_path / "ref"


@pytest.mark.parametrize("addition,gap", [
    ("def brand_new_metric(returns, *, window=5):\n    return returns\n",
     "ops/metrics.py:brand_new_metric"),
    ("class Extra:\n    def run(self, jobs, *, budget=1):\n        pass\n",
     "ops/metrics.py:Extra"),
])
def test_a_new_reference_name_fails_the_check(tmp_path, addition, gap):
    ref_root = _copy_tree(tmp_path, "ops/metrics.py")
    assert surface_gaps("ops/metrics.py", ref_root=ref_root) == []
    path = ref_root / "ops/metrics.py"
    path.write_text(path.read_text() + "\n\n" + addition)
    got = surface_gaps("ops/metrics.py", ref_root=ref_root)
    assert gap in got, got


def test_a_new_reference_keyword_fails_the_check(tmp_path):
    ref_root = _copy_tree(tmp_path, "ops/pnl.py")
    path = ref_root / "ops/pnl.py"
    src = path.read_text()
    assert "    compound: bool = False,\n    unroll" in src
    path.write_text(src.replace("    compound: bool = False,\n    unroll",
                                "    compound: bool = False,\n"
                                "    carry_dtype=None,\n    unroll", 1))
    assert surface_gaps("ops/pnl.py", ref_root=ref_root) == [
        "ops/pnl.py:backtest_scan(carry_dtype)"]


def test_a_stale_entry_fails_the_check(tmp_path):
    renamed = {**RENAMED, "ops/pnl.py:backtest_scan": (
        "ops/pnl.py:scan_backtest", "a renamed engine")}
    jax_only = {**JAX_ONLY, "ops/pnl.py:not_a_function": "gone long ago"}
    got = stale_entries(renamed=renamed, jax_only=jax_only)
    assert got == ["ops/pnl.py:not_a_function: not in the reference",
                   "ops/pnl.py:backtest_scan: target "
                   "ops/pnl.py:scan_backtest not in the port"]
