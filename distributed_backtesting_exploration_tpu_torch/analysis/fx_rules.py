"""dbxlint traced-program rule: kernel hygiene for the fused sweeps, the
port of the reference's ``analysis/jaxpr_rules.py``.

The AST layer sees source; this layer sees what actually runs. Every
strategy of ``rpc.compute._FUSED_STRATEGIES`` (and the pairs sweep,
which routes outside it) runs over tiny synthetic inputs (the reference's
``_AXIS_VALUES`` and 32-bar ``_tiny_inputs``) at both epilogue
substrates, ``scan:8`` and ``ladder``, passed explicitly, and so do its
paged, scenario and streaming append-step variants and the two K8 stage
scaffolds. Each run is recorded by :func:`.dataflow.trace` and walked by
:func:`.dataflow.analyze` (the walker dbxcert rides) for:

- **host round trips** (``.item()``, ``int(t)``, a copy off the card):
  a sync inside a sweep stalls the card's stream;
- **outputs that are not float32**: the Metrics wire contract is f32;
- **weak outputs**: an output whose dtype follows torch's default dtype
  (it moves when the program runs under the float64 default), reported
  with the chain of the first op whose dtype moved.

**The launch boundary.** A traced program cannot see into a ``ctypes``
kernel, so the rule watches the boundary itself (``ops.fused._WATCH``):
every call that ``ops.fused._on_device`` resolves (the fused entries,
the EMA and pairs tables, ``ops.stages``' two) and every launch. On the
CPU the plain version runs, and it takes the arguments the kernel would:
the watch hands them to the kernel wrapper's own ``_check_launch`` first,
which checks each declared argument's dtype, shape and layout as on the
card and stops (``DryCheck``) before any CUDA work. On the card the
kernels really launch, and the watch reads the tensors at ``_launch``.
Any f64 tensor handed to an entry, a declared dtype or shape missed, or a
tensor that is not contiguous at a launch is a finding. The port sums in
f64 on purpose in its preps (``rolling.prefix_sum``, ``mean_f64``,
``fused.row_mean``), each rounded once to f32, so an f64 value inside the
program is no finding: the reference's "no f64 anywhere" would flag the
fix of a real fault.

A registry entry with no tiny-input template is a finding, reported once.
Outside the package the rule is reported as skipped, never as clean.

**Source pass.** The kernels' own sources are where no trace reaches:
:func:`check_csrc` flags ``printf`` in device code, ``atomicAdd`` on a
float or double (a nondet sum) and ``NVCC_FLAGS`` (``ops/_kernels.py``)
without ``-fmad=false``, ``-prec-div=true`` or ``-prec-sqrt=true``. It
sets no rule on ``double``: the f64 windowed sums of
``csrc/pairs_tables.cu`` are by design.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import inspect
import os
import re
import sys

import numpy as np
import torch

from . import dataflow
from .core import Finding, LintContext

# One representative value per grid-axis name used across the fused
# registry (windows/periods small integral bar counts; MACD/TRIX need
# fast < slow): the reference's.
_AXIS_VALUES = {
    "fast": [2.0], "slow": [5.0], "window": [3.0], "k": [1.0],
    "lookback": [2.0], "period": [3.0], "band": [20.0], "signal": [2.0],
    "span": [2.0],
}
_T_BARS = 32
SUBSTRATES = ("scan:8", "ladder")

_FUSED_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WATCH_FILES = tuple(os.path.join(_FUSED_DIR, "ops", f)
                     for f in ("fused.py", "stages.py"))


def _tiny_inputs(fields: tuple) -> list:
    """One-ticker OHLCV-ish panel, ``(1, _T_BARS)`` float32 per field."""
    t = np.arange(1, _T_BARS + 1, dtype=np.float32)
    close = 100.0 + np.sin(t) + 0.01 * t
    by_name = {
        "close": close,
        "high": close * 1.01,
        "low": close * 0.99,
        "open": close,
        "volume": np.full(_T_BARS, 1e4, np.float32),
        "close2": 50.0 + np.cos(t) + 0.02 * t,
    }
    return [by_name[f][None, :].astype(np.float32) for f in fields]


def _entry_name(fn) -> str:
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "__name__", repr(fn))


def _caller() -> str:
    """``file:line (function)`` of the nearest frame outside the boundary
    modules, torch and this one: where the program called the entry."""
    f = sys._getframe(2)
    skip = _WATCH_FILES + (os.path.abspath(__file__),
                           os.path.abspath(functools.__file__))
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn not in skip and not fn.startswith(dataflow._TORCH_DIR):
            return f"{fn}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "?"


class BoundaryWatch:
    """The watch ``ops.fused._WATCH`` holds while a program runs: records
    each problem at the boundary as ``(entry, message)``. The run under
    the float64 default (the weak test) only lets the kernels' own checks
    refuse what follows the default dtype."""

    def __init__(self):
        self.problems: list = []

    def _checking(self) -> bool:
        return torch.get_default_dtype() == torch.float32

    def entry(self, fn, plain, cuda, *args, **kwargs):
        from ..ops import fused

        name = _entry_name(cuda)
        checking = self._checking()
        at = _caller() if checking else "?"
        if checking:
            for path, x in dataflow._flatten((args, kwargs)):
                if isinstance(x, torch.Tensor) and x.dtype == torch.float64:
                    self.problems.append((name, (
                        f"argument {'/'.join(path)} is float64 at {at}: "
                        "the kernels take f32 (the port's f64 preps round "
                        "once to f32 before the boundary)")))
        if fn is plain:
            with dataflow.paused():
                try:
                    cuda(*args, **kwargs)
                except fused.DryCheck:
                    pass
                except Exception as e:
                    if not checking:
                        # The float64-default run fails here as the
                        # card's launch would.
                        raise
                    self.problems.append((name, (
                        f"the kernel's launch check refuses the arguments "
                        f"given at {at}: {e}")))
                else:
                    if checking:
                        self.problems.append((name, (
                            f"called at {at}, its wrapper returned without "
                            "a launch check")))
        return fn(*args, **kwargs)

    def launch(self, name: str, args) -> None:
        if not self._checking():
            return
        for i, x in enumerate(args):
            if not isinstance(x, torch.Tensor):
                continue
            if x.dtype == torch.float64:
                self.problems.append((name, (
                    f"launch argument {i} is float64")))
            if not x.is_contiguous():
                self.problems.append((name, (
                    f"launch argument {i} is not contiguous")))


def _producers(prog: dataflow.Program) -> dict:
    out = {}
    for n in prog.nodes:
        for vid in n.outs:
            out[vid] = f"{n.op} @ {n.frame}"
    return out


def check_traced(name: str, fn, args, *, path: str = "?", line: int = 0,
                 device: str | torch.device = "cpu") -> list:
    """Run ``fn(*args)`` under the recorder and the boundary watch and lint
    what ran. ``name`` labels the findings, ``path``/``line`` anchor them
    (the kernel's def site). The program runs as it is (not
    functionalized: a kernel reads its tensors' memory), on the card its
    kernels launching."""
    from ..ops import fused

    rule = KernelHygieneRule.name
    dev = torch.device(device)
    watch = BoundaryWatch()
    fused._WATCH.append(watch)
    try:
        prog = dataflow.trace(fn, *args, functional=False, device=dev)
    except Exception as e:   # a kernel that fails to run is finding #0
        return [Finding(rule, path, line,
                        f"kernel `{name}` failed to trace: {e!r}")]
    finally:
        fused._WATCH.remove(watch)
    # The lattice walk only where an output is weak (for its chain).
    an = dataflow.analyze(prog) if any(prog.out_weak) else None
    findings = []
    for op, frame in dataflow.host_round_trips(prog):
        findings.append(Finding(
            rule, path, line,
            f"kernel `{name}`: host round trip `{op}` in the traced "
            f"program ({frame}): a sync inside a sweep stalls the card's "
            "stream"))
    for entry, msg in watch.problems:
        findings.append(Finding(
            rule, path, line,
            f"kernel `{name}`: at the launch boundary of `{entry}`, {msg}"))
    if prog.alt_error:
        findings.append(Finding(
            rule, path, line,
            f"kernel `{name}`: fails under torch's float64 default dtype "
            f"({prog.alt_error}): a tensor on its path follows the "
            "default dtype; give it an explicit dtype=torch.float32"))
    made = _producers(prog)
    for i, (label, ref, dt) in enumerate(zip(prog.out_paths, prog.out_refs,
                                             prog.out_dtypes)):
        out = "/".join(label)
        if dt != "float32":
            via = made.get(ref[1], "?") if ref[0] == "v" else "a constant"
            findings.append(Finding(
                rule, path, line,
                f"kernel `{name}`: output `{out}` is {dt}, not float32 "
                f"(produced by: {via}); the Metrics wire contract is "
                "float32"))
        elif prog.out_weak[i] and not prog.alt_error:
            chain = (" -> ".join(an.out_vals[i].weak_chain)
                     or "(no chain recorded)")
            findings.append(Finding(
                rule, path, line,
                f"kernel `{name}`: output `{out}` follows torch's default "
                f"dtype (provenance: {chain}); give the tensor an explicit "
                "dtype=torch.float32"))
    return findings


# ---------------------------------------------------------------------------
# The source pass over csrc/
# ---------------------------------------------------------------------------

_REQUIRED_NVCC = ("-fmad=false", "-prec-div=true", "-prec-sqrt=true")
_DEVICE_FN = re.compile(r"__(?:global|device)__")
_FLOAT_DECL = r"(?:float|double)\s*\*?\s*(?:__restrict__\s*)?"


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"),
                 src, flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def _device_bodies(src: str):
    """``(start, end)`` offsets of the bodies of ``__global__`` and
    ``__device__`` functions (brace matched from the first ``{`` after the
    qualifier)."""
    for m in _DEVICE_FN.finditer(src):
        brace = src.find("{", m.end())
        semi = src.find(";", m.end())
        if brace < 0 or (0 <= semi < brace):
            continue                  # a declaration, not a definition
        depth = 0
        for i in range(brace, len(src)):
            c = src[i]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
                if depth == 0:
                    yield brace, i
                    break


def _is_float_target(src: str, expr: str) -> bool:
    """True when ``atomicAdd``'s target ``expr`` names a float or double
    (its identifier declared as one anywhere in the file, or cast so)."""
    if re.search(r"\(\s*(?:float|double)\s*\*\s*\)", expr):
        return True
    m = re.search(r"[A-Za-z_]\w*", expr.lstrip("&*( "))
    if m is None:
        return False
    ident = m.group(0)
    return re.search(_FLOAT_DECL + re.escape(ident) + r"\b", src) is not None


def check_csrc(csrc_dir: str, *, root: str, nvcc_flags=None) -> list:
    """The source pass over ``csrc_dir``'s ``*.cu`` and ``*.cuh``: findings
    anchored at the offending line, paths relative to ``root``."""
    rule = KernelHygieneRule.name
    findings = []
    names = sorted(n for n in os.listdir(csrc_dir)
                   if n.endswith((".cu", ".cuh"))) \
        if os.path.isdir(csrc_dir) else []
    for fname in names:
        full = os.path.join(csrc_dir, fname)
        rel = os.path.relpath(full, root)
        with open(full, encoding="utf-8", errors="replace") as fh:
            src = _strip_comments(fh.read())
        for lo, hi in _device_bodies(src):
            body = src[lo:hi]
            for m in re.finditer(r"\bprintf\s*\(", body):
                ln = src.count("\n", 0, lo + m.start()) + 1
                findings.append(Finding(
                    rule, rel, ln,
                    "printf in device code: a host round trip from every "
                    "thread that runs it"))
        for m in re.finditer(r"\batomicAdd\s*\(([^,]*),", src):
            if _is_float_target(src, m.group(1)):
                ln = src.count("\n", 0, m.start()) + 1
                findings.append(Finding(
                    rule, rel, ln,
                    f"atomicAdd on a float ({m.group(1).strip()}): the sum's "
                    "order, and so its bits, changes run to run"))
    if nvcc_flags is not None:
        for flag in _REQUIRED_NVCC:
            if flag not in nvcc_flags:
                findings.append(Finding(
                    rule, "ops/_kernels.py", 1,
                    f"NVCC_FLAGS lacks {flag}: the kernels must round as "
                    "their plain versions do"))
    return findings


def _nvcc_flags(ctx: LintContext):
    """``NVCC_FLAGS`` of the linted package's ``ops/_kernels.py`` and its
    line, read from the source (None where it is not a literal)."""
    for pf in ctx.files:
        if pf.rel.replace(os.sep, "/") != "ops/_kernels.py":
            continue
        for node in pf.tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "NVCC_FLAGS"
                    for t in node.targets):
                try:
                    return tuple(ast.literal_eval(node.value)), node.lineno
                except ValueError:
                    return None, node.lineno
    return None, 1


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

def _def_site(ctx: LintContext, target, fallback: str) -> tuple:
    target = inspect.unwrap(getattr(target, "__func__", target))
    try:
        src, line = (inspect.getsourcefile(target),
                     inspect.getsourcelines(target)[1])
        return os.path.relpath(src, ctx.root), line
    except (OSError, TypeError):
        return fallback, 0


class KernelHygieneRule:
    """Run every registered fused kernel; flag host round trips, non-f32
    and weak outputs, and what reaches the launch boundary. ``device``
    picks where the programs run: the CPU (plain versions, dry launch
    checks) unless the caller asks for the card."""

    name = "kernel-hygiene"
    doc = ("host round trips, f64 or undeclared tensors at the launch "
           "boundary, non-f32 and weak outputs in the fused kernels")

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)

    def applicable(self, ctx: LintContext) -> bool:
        # The kernel registry belongs to the installed package; an
        # arbitrary directory (fixtures) has none to run, and the engine
        # reports the rule as skipped rather than silently clean.
        return ctx.package

    def check(self, ctx: LintContext) -> list:
        if not self.applicable(ctx):
            return []
        findings = []
        for epilogue in SUBSTRATES:
            findings.extend(self._check_registry(ctx, epilogue))
        findings.extend(self._check_stages(ctx))
        flags, line = _nvcc_flags(ctx)
        csrc = check_csrc(os.path.join(ctx.root, "csrc"), root=ctx.root,
                          nvcc_flags=flags if flags is not None else ())
        findings.extend(
            dataclasses.replace(f, line=line)
            if f.path == "ops/_kernels.py" else f for f in csrc)
        return findings

    def _run(self, label, fn, args, rel, line) -> list:
        return check_traced(label, fn, args, path=rel, line=line,
                            device=self.device)

    def _check_registry(self, ctx: LintContext, epilogue: str) -> list:
        from ..ops import fused
        from ..rpc.compute import _FUSED_STRATEGIES

        findings = []
        suffix = "" if epilogue.startswith("scan") else f"@{epilogue}"
        for strategy, spec in sorted(_FUSED_STRATEGIES.items()):
            label = strategy + suffix
            rel, line = _def_site(ctx, spec.run, "rpc/compute.py")
            try:
                grid = {axis: np.asarray(_AXIS_VALUES[axis], np.float32)
                        for axis in sorted(spec.axes)}
                arrays = _tiny_inputs(spec.fields)
            except KeyError as e:
                # A newly registered kernel with an axis or field this rule
                # has no tiny-input template for is a loud finding, not a
                # crashed run; template gaps are substrate-independent, so
                # reported once, on the scan pass.
                if epilogue.startswith("scan"):
                    findings.append(Finding(
                        self.name, rel, line,
                        f"kernel `{label}`: no tiny-input template for "
                        f"grid axis/field {e.args[0]!r}: extend "
                        f"_AXIS_VALUES/_tiny_inputs in analysis/fx_rules.py "
                        f"so this kernel stays under kernel-hygiene "
                        f"coverage"))
                continue

            def fn(*arrs, _run=spec.run, _f=spec.fields, _g=grid):
                return _run(dict(zip(_f, arrs)), _g, cost=0.0,
                            periods_per_year=252, epilogue=epilogue,
                            device=arrs[0].device)

            findings.extend(self._run(label, fn, arrays, rel, line))
        findings.extend(self._check_pairs(ctx, epilogue, suffix))
        for strategy in sorted(_FUSED_STRATEGIES):
            findings.extend(self._check_probe(
                ctx, f"{strategy}.paged{suffix}", fused.fused_paged_sweep,
                "ops/fused.py", fused.paged_hygiene_probe, strategy,
                epilogue, suffix))
            if fused.scenario_supported(strategy):
                findings.extend(self._check_probe(
                    ctx, f"{strategy}.scenario{suffix}",
                    fused.fused_scenario_sweep, "ops/fused.py",
                    fused.scenario_hygiene_probe, strategy, epilogue,
                    suffix))
        findings.extend(self._check_append_steps(ctx, epilogue, suffix))
        return findings

    def _check_pairs(self, ctx: LintContext, epilogue: str,
                     suffix: str) -> list:
        """The pairs sweep (K7 and its tables), which the backend routes
        outside ``_FUSED_STRATEGIES``."""
        from ..ops import fused

        rel, line = _def_site(ctx, fused.fused_pairs_sweep, "ops/fused.py")
        grid = {a: np.asarray(_AXIS_VALUES[a], np.float32)
                for a in ("lookback",)}

        def fn(y, x):
            return fused.fused_pairs_sweep(
                y, x, grid["lookback"], np.asarray([1.0], np.float32),
                z_exit=0.0, epilogue=epilogue, device=y.device)

        return self._run(f"pairs{suffix}", fn,
                         _tiny_inputs(("close", "close2")), rel, line)

    def _check_probe(self, ctx, label, target, fallback, probe, strategy,
                     epilogue, suffix) -> list:
        """A paged or scenario variant through its probe: a probe that
        cannot build is a finding (on the scan pass: template gaps are
        substrate-independent), never a crashed run."""
        rel, line = _def_site(ctx, target, fallback)
        try:
            fn, args = probe(strategy, epilogue=epilogue)
        except Exception as e:
            if suffix:
                return []
            return [Finding(
                self.name, rel, line,
                f"kernel `{label}`: hygiene probe failed to build tiny "
                f"inputs: {e!r}: extend the probe in ops/fused.py so this "
                f"route stays under kernel-hygiene coverage")]
        return self._run(label, fn, args, rel, line)

    def _check_append_steps(self, ctx: LintContext, epilogue: str,
                            suffix: str) -> list:
        """The streaming append steps of every fused strategy with a
        streaming family, plus pairs (``streaming.recurrent
        .hygiene_probe``: a tiny carry and a ΔT slice)."""
        from ..rpc.compute import _FUSED_STRATEGIES
        from ..streaming import recurrent

        findings = []
        rel, line = _def_site(ctx, recurrent.append_step,
                              "streaming/recurrent.py")
        for strategy in sorted(set(_FUSED_STRATEGIES) | {"pairs"}):
            if not recurrent.supports_strategy(strategy):
                continue
            label = f"{strategy}._append_step{suffix}"
            try:
                fn, args = recurrent.hygiene_probe(strategy,
                                                   epilogue=epilogue)
            except Exception as e:
                findings.append(Finding(
                    self.name, rel, line,
                    f"kernel `{label}`: hygiene probe failed to build "
                    f"tiny inputs: {e!r}"))
                continue
            findings.extend(self._run(label, fn, args, rel, line))
        return findings

    def _check_stages(self, ctx: LintContext) -> list:
        """K8's two stage scaffolds (``ops.stages``), at their ``full``
        stage; they take no epilogue."""
        from ..ops import stages

        findings = []
        (close,) = _tiny_inputs(("close",))
        for label, call, grid in (
                ("sma_stage", stages.sma_stage_call,
                 (np.asarray([2.0], np.float32),
                  np.asarray([5.0], np.float32))),
                ("boll_stage", stages.boll_stage_call,
                 (np.asarray([3.0], np.float32),
                  np.asarray([1.0], np.float32)))):
            rel, line = _def_site(ctx, call, "ops/stages.py")

            def fn(c, _call=call, _g=grid):
                return _call(c, *_g, stage="full", device=c.device)

            findings.extend(self._run(label, fn, [close], rel, line))
        return findings
