"""Abstract interpretation over traced torch programs: the shared walker
and the numerics-provenance lattice behind dbxcert (:mod:`.certify`) and
the kernel-hygiene rule (:mod:`.fx_rules`). The port of the reference's
``analysis/dataflow.py``, which walks jaxprs.

The repo's distributed guarantees (content-addressed dispatch, journal
replay reproducing digests, carry-append parity, substrate-vs-substrate
equivalence) reduce to numerics contracts: "selection-only =>
bit-identical", "one association boundary", "f32 sums of exact small ints
merge bit-exactly". :func:`trace` records a program once and
:func:`analyze` assigns every value an :class:`AbsVal`, propagated through
every recorded op.

**The tracer.** The port has no jaxpr. :func:`trace` runs the program
once, eagerly, on small real tensors under ``torch.func.functionalize``
(``remove="mutations_and_views"``) with a ``TorchDispatchMode`` that
records every ATen op it dispatches: its operands (by schema argument
name), its outputs, their dtypes and devices. Functionalization makes
mutations and aliasing explicit: an in-place write becomes a
``select_scatter``/``slice_scatter``/``copy`` producing a new value and a
view becomes a ``*_copy``, so every recorded op is a pure function of its
operands and a value's identity is its tensor object (every tensor seen is
kept alive for the trace, so ids are never reused). ``make_fx`` records
the same ops, but took 1.8 s for a fused sweep that this recorder takes in
0.04 s (a 32-bar sma_crossover probe, 1266 ops, on a CPU), and the
certifier and kernel-hygiene trace a few hundred programs a run.

**Frames.** ``make_fx``'s ``stack_trace`` keeps only frames named
``forward`` and came back empty. The recorder reads the Python stack
itself at each dispatch: the frames between :func:`trace`'s call of the
program and the op, minus torch's own files. A frame is ``(code object,
instruction offset)``, its line read off the code's line table when a
chain or a site is printed. A value's *site* is the op and that stack: the
ops one Python instruction dispatches each time it runs (every iteration
of an unrolled loop) share a site, so the census below counts program
sites, not recorded ops, and does not grow with the probe's length.
Chains name the innermost frame inside the port package as ``op @
file:line (function)``, the reference's frame form, so
:func:`.certify.anchor_of` and the inline ``# dbxlint: disable=``
directive find the line.

Provenance classes, ordered by :data:`CLASS_NAMES` (join = max), the
reference's:

- **exact**: no float accumulation on the value path: data movement,
  elementwise float arithmetic in a fixed op order, integer/bool work.
- **selection**: float data reaches the value only through comparison
  operands, ``where`` predicates, gather/index indices or ``sign``.
- **int-exact**: f32 accumulation of provably integer-valued summands
  (bool casts, positions in {-1, 0, 1}, their abs/diffs).
- **float-accum**: real f32 accumulation; every accumulation *site* on
  the dependency cone is counted into the boundary census.
- **nondet**: order-nondeterministic for a fixed program and inputs
  (``scatter_add``, ``index_add``, an accumulating ``index_put``, the
  collectives). Never admissible on a digest path.

Association-boundary census (``AbsVal.sites``):

- a reassociating reduction op (table below), one site each;
- an ``add`` whose two operands share float lineage (a summation-tree
  merge: the shift-doubling ladders ``ops.fused._cumsum_last`` and the
  blocked equity carries of ``ops.fused._equity_advance``);
- a loop carry updated arithmetically from itself. The reference sees a
  ``scan`` equation; here the loop is unrolled, so a float arithmetic op
  whose operand derives from an earlier call of the same op at the same
  site (another iteration) marks its source line a carry site,
  ``<line>#carry``, once however many iterations ran.

Weak types. torch has no weak types; the counterpart is a dtype set by
torch's default dtype or by inference from a Python scalar, not by the
code. :func:`trace` with ``weak=True`` runs the program again under
``torch.set_default_dtype(torch.float64)`` and marks every op whose
output dtype differs between the two runs (ops paired by position, or by
op and occurrence where the runs differ); a weak output's
``weak_chain`` starts at the first such op on its cone. A run that
fails under the float64 default (a kernel's check refusing a tensor
whose dtype followed it) makes every float output weak.

The op tables (ATen overload packet names), each beside the reference's
primitives:

- host round trips, ``CALLBACK_OPS``: ``_local_scalar_dense`` (from
  ``.item()``, ``int(t)``, ``bool(t)``) and a copy off the card
  (``_to_copy``, ``copy``, ``_copy_from`` to the CPU); the reference's
  ``pure_callback``, ``io_callback``, ``debug_callback``, ``callback``,
  ``outside_call``;
- reassociating reductions: ``sum``, ``nansum``, ``mean``, ``prod``,
  ``cumsum``, ``cumprod``, ``logcumsumexp``, ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``dot``, ``mv``, ``var``, ``std``, ``var_mean``,
  ``std_mean``, ``linalg_vector_norm``, ``logsumexp``, ``convolution``,
  ``avg_pool1d``/``2d``; the reference's ``reduce_sum``,
  ``reduce_prod``, ``cumsum``, ``cumprod``, ``cumlogsumexp``,
  ``dot_general``, ``conv_general_dilated``, ``reduce_window_sum``;
- of them int-exact over integral summands: ``sum``, ``cumsum``,
  ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv``; the
  reference's ``reduce_sum``, ``cumsum``, ``dot_general``, ``add_any``;
- nondet: ``scatter_add``, ``index_add``, ``scatter_reduce``,
  ``index_reduce``, ``index_put``/``put`` with ``accumulate``,
  ``all_reduce``, ``reduce_scatter_tensor`` and their c10d forms (the
  port's ``parallel.sharding.psum`` reaches none: it sums the shards in
  shard order); the reference's ``scatter-add``, ``scatter-mul``,
  ``psum``, ``psum2``, ``all_reduce``, ``reduce_scatter``;
- comparisons: ``lt``, ``le``, ``gt``, ``ge``, ``eq``, ``ne``,
  ``isfinite``, ``isnan``, ``isinf``, ``signbit``; the reference's
  ``lt`` ... ``ne``, ``is_finite``;
- discretizers: ``sign``, ``sgn``; the reference's ``sign``;
- arg reductions: ``argmax``, ``argmin``, ``argsort``,
  ``searchsorted``, ``bucketize``; the reference's ``argmax``,
  ``argmin``;
- movement: views and their ``*_copy`` forms, ``cat``, ``stack``,
  ``slice``, ``select``, ``expand``, ``permute``, ``flip``, ``repeat``,
  ``clone``, ``_to_copy``, the ``*_scatter`` ops, ``constant_pad_nd``,
  ``maximum``, ``minimum``, ``amax``, ``amin``, ``max``, ``min``,
  ``cummax``, ``cummin``, ``clamp``, and the value-selecting ops
  (``where``, ``masked_fill``, ``gather``, ``index``, ``index_select``,
  ``index_put``, ``scatter``, ``copy``: their data operands by schema
  name, the rest selection edges); the reference's ``reshape``,
  ``broadcast_in_dim``, ``transpose``, ``concatenate``, ``slice``,
  ``dynamic_slice``, ``dynamic_update_slice``, ``pad``, ``gather``,
  ``select_n``, ``max``, ``min``, ``reduce_max``, ``reduce_min``,
  ``cummax``, ``cummin``, ``clamp`` and the rest;
- integer-preserving arithmetic: ``add``, ``sub``, ``rsub``, ``mul``,
  ``neg``, ``abs``, ``remainder``, ``fmod``, ``floor``, ``ceil``,
  ``round``, ``trunc``, ``floor_divide``, ``sort``; the reference's
  ``add``, ``sub``, ``mul``, ``neg``, ``abs``, ``rem``, ``add_any``,
  ``floor``, ``ceil``, ``round``, ``sort``.

Factory ops (``zeros``, ``full``, ``arange``, ``*_like``, ...) make
constants: exact, no lineage, integral when their fill is. ``nextafter``,
like every op not listed, is float arithmetic that breaks integrality.

The traversal is also the walker of kernel hygiene: host round trips, the
first f64 value, and nondet sites are collected on the :class:`Analysis`
in the same pass.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Provenance classes, join = max over this order.
EXACT, SELECTION, INT_EXACT, FLOAT_ACCUM, NONDET = range(5)
CLASS_NAMES = ("exact", "selection", "int-exact", "float-accum", "nondet")

_MAX_CHAIN = 6          # provenance frames kept per value (first + recent)
_MAX_CONST_CHECK = 4096  # integrality check cap for constant tensors

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_THIS_FILE = os.path.abspath(__file__)

# Host round trips inside a traced program (kernel-hygiene vocabulary); a
# copy counts only where it moves a value off the card.
CALLBACK_OPS = frozenset({"_local_scalar_dense", "item"})
_COPY_OPS = frozenset({"_to_copy", "copy", "_copy_from",
                       "_copy_from_and_resize"})

# Reassociating accumulation ops: one census site each. amax/amin and
# friends are absent: they return one of their operands bitwise.
_REDUCE_SITE_OPS = frozenset({
    "sum", "nansum", "mean", "prod", "cumsum", "cumprod", "logcumsumexp",
    "_logcumsumexp", "mm", "bmm", "addmm", "baddbmm", "dot", "mv", "var",
    "std", "var_mean", "std_mean", "linalg_vector_norm", "norm",
    "logsumexp", "convolution", "avg_pool1d", "avg_pool2d",
})
# Sum-shaped reductions stay exact when every summand is integer-valued.
_INT_EXACT_REDUCES = frozenset({"sum", "cumsum", "mm", "bmm", "addmm",
                                "baddbmm", "dot", "mv"})

# Order-nondeterministic ops, with their data operands (the rest are
# indices). ``index_put`` and ``put`` are nondet only when they
# accumulate.
_NONDET_OPS = {
    "scatter_add": ("self", "src"), "index_add": ("self", "source"),
    "scatter_reduce": ("self", "src"), "index_reduce": ("self", "source"),
    "index_put": ("self", "values"), "_index_put_impl": ("self", "values"),
    "put": ("self", "source"),
    "all_reduce": None, "all_reduce_coalesced": None,
    "reduce_scatter_tensor": None, "reduce_scatter_tensor_coalesced": None,
    "allreduce_": None, "allreduce_coalesced_": None,
    "reduce_scatter_": None, "_reduce_scatter_base_": None,
}
_ACCUMULATE_FLAG = frozenset({"index_put", "_index_put_impl", "put"})

_CMP_OPS = frozenset({"lt", "le", "gt", "ge", "eq", "ne", "isfinite",
                      "isnan", "isinf", "isposinf", "isneginf", "signbit"})
# Discretizers: float in, a member of a fixed set out.
_SIGN_OPS = frozenset({"sign", "sgn"})
_ARG_REDUCES = frozenset({"argmax", "argmin", "argsort", "searchsorted",
                          "bucketize", "nonzero"})

# Pure data movement / value selection: integral-preserving, no
# arithmetic applied to lineage.
_MOVE_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "view_copy", "_reshape_alias",
    "_reshape_alias_copy", "expand", "expand_copy", "permute",
    "permute_copy", "transpose", "transpose_copy", "t", "t_copy",
    "squeeze", "squeeze_copy", "unsqueeze", "unsqueeze_copy", "cat",
    "stack", "slice", "slice_copy", "select", "select_copy", "unbind",
    "unbind_copy", "split", "split_copy", "split_with_sizes",
    "split_with_sizes_copy", "narrow", "narrow_copy", "flip", "roll",
    "repeat", "clone", "contiguous", "alias", "alias_copy", "detach",
    "detach_copy", "lift", "lift_fresh", "lift_fresh_copy", "_to_copy",
    "maximum", "minimum", "fmax", "fmin", "amax", "amin", "max",
    "min", "cummax", "cummin", "_cummax_helper", "_cummin_helper", "clamp",
    "clamp_min", "clamp_max", "constant_pad_nd", "select_scatter",
    "slice_scatter", "diagonal_scatter", "as_strided", "as_strided_copy",
    "as_strided_scatter", "diagonal", "diagonal_copy", "tril", "triu",
    "_unique2", "unique_dim", "topk", "real", "imag",
})
# Arithmetic that maps integer-valued operands to integer values
# (nextafter is absent: nextafter(2.0, 3.0) is 2.0000002).
_INT_PRESERVING_ARITH = frozenset({
    "add", "sub", "rsub", "mul", "neg", "abs", "remainder", "fmod",
    "floor", "ceil", "round", "trunc", "floor_divide", "sort",
})
# Ops that make a constant: their tensor operands give only a shape.
_FACTORY_OPS = frozenset({
    "zeros", "ones", "full", "empty", "empty_strided", "arange",
    "scalar_tensor", "zeros_like", "ones_like", "full_like", "empty_like",
    "new_zeros", "new_ones", "new_full", "new_empty", "new_empty_strided",
    "linspace", "eye", "fill", "zero",
})
# Data operands of the value-selecting ops (the rest are predicates or
# indices: selection edges).
_VALUE_OPERANDS = {
    "gather": ("self",), "index": ("self",), "index_select": ("self",),
    "take": ("self",), "take_along_dim": ("self",),
    "embedding": ("weight",), "scatter": ("self", "src", "value"),
    "index_put": ("self", "values"), "_index_put_impl": ("self", "values"),
    "put": ("self", "source"), "index_copy": ("self", "source"),
    "index_fill": ("self", "value"), "masked_scatter": ("self", "source"),
    "masked_fill": ("self", "value"), "where": ("self", "other"),
    "copy": ("src",),
}


@dataclasses.dataclass(frozen=True)
class AbsVal:
    """Lattice value of one traced tensor.

    ``lineage`` holds float-source tokens reachable on the *value* path
    (cut at comparisons/discretizers and index/predicate edges).
    ``sites`` is the full-cone association census (it flows through
    every edge, predicates included: a selection output's census is its
    knife-edge exposure). ``carry`` maps each float arithmetic site on
    the value path to the first call that produced it there (the unrolled
    loop-carry test)."""

    dtype: str = ""
    weak: bool = False
    cls: int = EXACT
    integral: bool = False
    lineage: frozenset = frozenset()
    sites: frozenset = frozenset()
    chain: tuple = ()
    weak_chain: tuple = ()
    carry: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def class_name(self) -> str:
        return CLASS_NAMES[self.cls]

    @property
    def boundaries(self) -> int:
        return len(self.sites)


@dataclasses.dataclass
class Analysis:
    """One-walk result over a traced program: per-output lattice values
    plus the kernel-hygiene collections (host round trips, f64 values,
    nondet sites) gathered on the same traversal."""

    out_vals: list
    callbacks: list          # [(op, frame)], deduped by op name
    f64: list                # [(dtype, op, frame)], first site only
    nondet_sites: list       # [(op, frame)], deduped by site
    n_eqns: int = 0

    _callback_names: set = dataclasses.field(default_factory=set)
    _nondet_seen: set = dataclasses.field(default_factory=set)
    # (site, op) -> (census sites, class) of every op found accumulating
    # in some iteration (see :func:`analyze`).
    _accum: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# The recorded program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Node:
    """One recorded ATen op. ``operands`` maps each schema argument that
    carries data to its leaves: ``("v", id, device)`` a traced value, ``("c",
    dtype, integral, device)`` a constant (a tensor made outside the trace
    or a Python number)."""

    op: str                  # overload packet name, e.g. "add"
    target: str              # full overload, e.g. "aten.add.Tensor"
    operands: dict
    flags: dict              # the accumulate argument, where given
    outs: tuple              # value ids
    out_dtypes: tuple
    out_devices: tuple
    site: tuple              # ((code, lasti), ...) outermost first
    call: int                # the torch API call that dispatched it
    weak: tuple = ()         # per output: dtype differs under f64 default

    @property
    def frame(self) -> str:
        """``file:line (function)`` of the innermost frame inside the port
        package (else the innermost user frame): the chains' frame."""
        return _frame_str(self.site)


_LINES: dict = {}


def _line(code, lasti: int) -> int:
    """Source line of instruction ``lasti`` of ``code`` (cached)."""
    key = (code, lasti)
    line = _LINES.get(key)
    if line is None:
        line = 0
        for start, end, ln in code.co_lines():
            if start <= lasti < end and ln is not None:
                line = ln
                break
        _LINES[key] = line
    return line


_FRAMES: dict = {}


def _frame_str(site: tuple) -> str:
    label = _FRAMES.get(site)
    if label is None:
        pick = None
        for code, lasti in reversed(site):          # innermost first
            if code.co_filename.startswith(_PKG_DIR + os.sep):
                pick = (code, lasti)
                break
        if pick is None and site:
            pick = site[-1]
        label = "?" if pick is None else (
            f"{pick[0].co_filename}:{_line(*pick)} ({pick[0].co_name})")
        _FRAMES[site] = label
    return label


@dataclasses.dataclass
class Program:
    """A traced program: its ops in order, its flattened inputs and
    outputs (by pytree path), and the output dtypes."""

    nodes: list
    in_paths: list           # [path tuple] per flattened input tensor
    in_dtypes: list          # input i is value id i
    out_paths: list          # [path tuple] per flattened output leaf
    out_refs: list           # ("v", id) | ("c", dtype, integral, device)
    out_dtypes: list
    out_weak: list = dataclasses.field(default_factory=list)
    # Why the run under the float64 default dtype failed ("": it ran).
    alt_error: str = ""


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _dtype_integral(dtype: str) -> bool:
    return dtype.startswith(("int", "uint", "bool"))


def _is_float(dtype: str) -> bool:
    return dtype.startswith(("float", "bfloat", "complex"))


def _value_integral(value) -> bool:
    """True when a constant is provably integer-valued (small tensors
    only: a large table is conservatively non-integral)."""
    if isinstance(value, int):                 # bool too
        return True
    if isinstance(value, float):
        return bool(np.isfinite(value) and value == round(value))
    if not isinstance(value, torch.Tensor):
        return False
    if not (value.dtype.is_floating_point or value.dtype.is_complex):
        return True
    if value.numel() == 0 or value.numel() > _MAX_CONST_CHECK:
        return False
    if value.dtype.is_complex:
        return False
    try:
        a = value.detach().cpu().double().numpy()
    except Exception:
        return False
    return bool(np.all(np.isfinite(a)) and np.all(a == np.round(a)))


_SCHEMAS: dict = {}


def _schema(func) -> tuple:
    """``(op, target, [(name, kind)])`` of ``func``: its packet name, its
    overload's name, and its arguments, kind ``"t"`` a tensor or tensor
    list, ``"s"`` a Python number, ``"f"`` the ``accumulate`` flag,
    ``None`` anything else."""
    spec = _SCHEMAS.get(func)
    if spec is None:
        args = []
        for a in func._schema.arguments:
            ty = str(a.type)
            if "Tensor" in ty:
                kind = "t"
            elif ty in ("number", "Optional[number]", "float",
                        "Optional[float]"):
                kind = "s"
            elif a.name == "accumulate":
                kind = "f"
            else:
                kind = None
            args.append((a.name, kind))
        spec = (func.overloadpacket.__name__, str(func), args)
        _SCHEMAS[func] = spec
    return spec


class _Recorder(TorchDispatchMode):
    """Records every dispatched op into ``self.nodes`` (see :func:`trace`).
    ``ids`` maps ``id(tensor)`` to value ids; ``keep`` holds every tensor
    seen so that no id is reused while the trace runs."""

    def __init__(self, entry, ids: dict, keep: list, full: bool = True):
        super().__init__()
        self.entry = entry
        self.full = full
        self.ids = ids
        self.keep = keep
        self.nodes: list = []
        self.next_id = max(ids.values(), default=-1) + 1
        self.paused = 0
        self.call = 0
        self._skip: dict = {}

    def _user_frames(self) -> tuple:
        """The user frames between the trace's entry and the op, outermost
        first, each ``(code, instruction offset)``."""
        frames = []
        f = sys._getframe(2)
        entry = self.entry
        skip = self._skip
        while f is not None and f is not entry:
            code = f.f_code
            s = skip.get(code)
            if s is None:
                fn = code.co_filename
                s = fn.startswith(_TORCH_DIR) or fn == _THIS_FILE
                skip[code] = s
            if not s:
                frames.append((code, f.f_lasti))
            f = f.f_back
        frames.reverse()
        return tuple(frames)

    def _leaf(self, x):
        if isinstance(x, torch.Tensor):
            vid = self.ids.get(id(x))
            if vid is not None:
                return ("v", vid, x.device.type)
            self.keep.append(x)
            return ("c", _dtype_name(x.dtype), _value_integral(x),
                    x.device.type)
        if isinstance(x, (bool, int, float)):
            return ("c", "float32" if isinstance(x, float) else "int64",
                    _value_integral(x), "cpu")
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        if not self.full:
            # The float64-default pass of the weak test: ops and dtypes
            # only.
            self.nodes.append((_schema(func)[1], tuple(
                _dtype_name(t.dtype)
                for t in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(t, torch.Tensor))))
            return out
        operands: dict = {}
        flags: dict = {}
        op, target, spec = _schema(func)
        for i, (name, kind) in enumerate(spec):
            if i < len(args):
                v = args[i]
            elif name in kwargs:
                v = kwargs[name]
            else:
                continue
            if kind in ("t", "s"):
                items = v if isinstance(v, (list, tuple)) else [v]
                leaves = [lf for lf in (self._leaf(x) for x in items)
                          if lf is not None]
                if leaves:
                    operands[name] = leaves
            elif kind == "f":
                flags[name] = v
        outs, dts, devs = [], [], []
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if not isinstance(t, torch.Tensor):
                continue
            vid = self.next_id
            self.next_id += 1
            self.ids[id(t)] = vid
            self.keep.append(t)
            outs.append(vid)
            dts.append(_dtype_name(t.dtype))
            devs.append(t.device.type)
        self.nodes.append(Node(
            op=op, target=target,
            operands=operands, flags=flags, outs=tuple(outs),
            out_dtypes=tuple(dts), out_devices=tuple(devs),
            site=self._user_frames(), call=self.call))
        return out


class _Calls(torch.overrides.TorchFunctionMode):
    """Numbers the torch API calls, so that the ops one call dispatches
    (a composite op's decomposition) are told apart from the same op at
    the same site in another iteration."""

    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.rec.call += 1
        return func(*args, **(kwargs or {}))


class paused:
    """Context in which the active trace records nothing (a check that
    runs code of its own inside a traced program)."""

    def __init__(self):
        self.rec = _ACTIVE[-1] if _ACTIVE else None

    def __enter__(self):
        if self.rec is not None:
            self.rec.paused += 1
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.paused -= 1
        return False


_ACTIVE: list = []


def _flatten(tree, path=()):
    """``[(path, leaf)]`` of a pytree of dicts (sorted keys), lists,
    tuples and NamedTuples (field names)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for k, v in zip(tree._fields, tree):
            out.extend(_flatten(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, path + (str(i),)))
        return out
    return [(path, tree)]


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_tensors(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _trace_once(fn, args, *, functional: bool, device,
                full: bool = True):
    targs = _to_tensors(tuple(args), device)
    flat_in = [(p, x) for p, x in _flatten(targs)
               if isinstance(x, torch.Tensor)]
    ids = {id(x): i for i, (_, x) in enumerate(flat_in)}
    keep = [x for _, x in flat_in]
    entry = sys._getframe()
    rec = _Recorder(entry, ids, keep, full)
    run = (torch.func.functionalize(fn, remove="mutations_and_views")
           if functional else fn)
    _ACTIVE.append(rec)
    try:
        with rec, _Calls(rec):
            out = run(*targs)
    finally:
        _ACTIVE.pop()
    if not full:
        return rec.nodes, [_dtype_name(x.dtype) for _, x in _flatten(out)
                           if isinstance(x, torch.Tensor)]
    out_paths, out_refs, out_dtypes = [], [], []
    for path, leaf in _flatten(out):
        if isinstance(leaf, torch.Tensor):
            vid = rec.ids.get(id(leaf))
            ref = (("v", vid, leaf.device.type) if vid is not None
                   else ("c", _dtype_name(leaf.dtype),
                         _value_integral(leaf), leaf.device.type))
            out_dtypes.append(_dtype_name(leaf.dtype))
        else:
            ref = rec._leaf(leaf)
            if ref is None:
                continue
            out_dtypes.append(ref[1])
        out_paths.append(path)
        out_refs.append(ref)
    return Program(nodes=rec.nodes, in_paths=[p for p, _ in flat_in],
                   in_dtypes=[_dtype_name(x.dtype) for _, x in flat_in],
                   out_paths=out_paths,
                   out_refs=out_refs, out_dtypes=out_dtypes)


def _align(nodes, alt) -> list:
    """The output dtypes of ``alt``'s op (``(target, dtypes)`` pairs)
    paired with each op of ``nodes`` (None: unpaired): by position where
    the two runs dispatched the same ops, else by op and occurrence."""
    if [n.target for n in nodes] == [t for t, _ in alt]:
        return [d for _, d in alt]

    def keys(targets):
        seen: dict = {}
        out = []
        for t in targets:
            c = seen.get(t, 0)
            seen[t] = c + 1
            out.append((t, c))
        return out

    by_key = dict(zip(keys(t for t, _ in alt), (d for _, d in alt)))
    return [by_key.get(k) for k in keys(n.target for n in nodes)]


def trace(fn, *args, functional: bool = True, weak: bool = True,
          device: str | torch.device = "cpu") -> Program:
    """Run ``fn(*args)`` once and record it (see the module docstring).

    ``args`` is a pytree of numpy arrays or tensors, moved to ``device``
    (the CPU unless the caller asks for the card); ``fn`` returns a pytree
    of tensors. ``functional`` runs it under ``torch.func.functionalize``
    (in-place writes and views made explicit; off where the program hands
    a tensor's memory to a kernel, which a functional wrapper has none
    of). ``weak`` runs it a second time under the float64 default dtype
    and marks the ops and outputs whose dtype moved; where that run fails
    (a kernel's check refusing a tensor whose dtype followed the
    default), ``alt_error`` says why and every float output is weak."""
    # The recorder keeps every tensor a run makes alive; the cyclic
    # collector would rescan them over and over (it tripled the time of a
    # registry pass) and has nothing of them to free.
    gc_on = gc.isenabled()
    gc.disable()
    try:
        return _trace(fn, args, functional=functional, weak=weak,
                      device=device)
    finally:
        if gc_on:
            gc.enable()


def _trace(fn, args, *, functional: bool, weak: bool, device) -> Program:
    prog = _trace_once(fn, args, functional=functional, device=device)
    prog.out_weak = [False] * len(prog.out_refs)
    for n in prog.nodes:
        n.weak = (False,) * len(n.outs)
    if not weak:
        return prog
    prior = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        alt_nodes, alt_out = _trace_once(fn, args, functional=functional,
                                         device=device, full=False)
    except Exception as e:
        # A program that fails under the float64 default has a tensor on
        # its path whose dtype follows the default: every float output is
        # reported weak, with the failure as its chain.
        prog.alt_error = f"{type(e).__name__}: {e} (at {_raise_site(e)})"
        prog.out_weak = [_is_float(dt) for dt in prog.out_dtypes]
        return prog
    finally:
        torch.set_default_dtype(prior)
    for n, dts in zip(prog.nodes, _align(prog.nodes, alt_nodes)):
        if dts is not None and len(dts) == len(n.out_dtypes):
            n.weak = tuple(a != b for a, b in zip(n.out_dtypes, dts))
    if len(alt_out) == len(prog.out_dtypes):
        prog.out_weak = [a != b for a, b in zip(prog.out_dtypes, alt_out)]
    return prog


# ---------------------------------------------------------------------------
# The lattice walk
# ---------------------------------------------------------------------------

def _raise_site(e: BaseException) -> str:
    """``file:line (function)`` of the innermost frame of ``e``'s traceback
    in the program itself: not torch's, this package's analysis, nor a
    kernel's launch check (the caller of the check is what refused)."""
    skip = (os.path.dirname(_THIS_FILE) + os.sep,
            os.path.dirname(os.path.abspath(functools.__file__)) + os.sep)
    site = "?"
    tb = e.__traceback__
    while tb is not None:
        code = tb.tb_frame.f_code
        fn = os.path.abspath(code.co_filename)
        if not (fn.startswith(_TORCH_DIR) or fn.startswith(skip)
                or code.co_name == "_check_launch"):
            site = f"{fn}:{tb.tb_lineno} ({code.co_name})"
        tb = tb.tb_next
    return site


def _cap_chain(chain: tuple) -> tuple:
    if len(chain) <= _MAX_CHAIN:
        return chain
    return chain[:1] + chain[-(_MAX_CHAIN - 1):]


def _merge_carry(vals) -> dict:
    """Union of the operands' carry maps ((site, op) -> the first call that
    produced a value there), the smallest call per key. A map is never
    written once made."""
    maps = [v.carry for v in vals if v.carry]
    if not maps:
        return {}
    if len(maps) == 1 or all(m is maps[0] for m in maps[1:]):
        return maps[0]
    merged = dict(maps[0])
    for m in maps[1:]:
        for k, c in m.items():
            old = merged.get(k)
            if old is None or c < old:
                merged[k] = c
    return merged


def _join(vals, *, dtype: str, weak: bool) -> AbsVal:
    """Plain value-edge join: class max, integral and, set unions."""
    cls = EXACT
    integral = True
    lineage = frozenset()
    sites = frozenset()
    chain: tuple = ()
    weak_chain: tuple = ()
    for v in vals:
        if v.cls > cls:
            cls, chain = v.cls, v.chain
        integral = integral and v.integral
        lineage |= v.lineage
        sites |= v.sites
        if v.weak and not weak_chain:
            weak_chain = v.weak_chain
    return AbsVal(dtype=dtype, weak=weak, cls=cls, integral=integral,
                  lineage=lineage, sites=sites,
                  chain=chain, weak_chain=weak_chain,
                  carry=_merge_carry(vals))


def _selection_contrib(v: AbsVal) -> int:
    """Class a predicate/index operand contributes through a selection
    edge: nondet taints across, everything else launders to selection
    when float data is actually involved."""
    if v.cls == NONDET:
        return NONDET
    if v.lineage or v.cls > EXACT:
        return SELECTION
    return EXACT


def _const_val(leaf) -> AbsVal:
    _, dtype, integral, _ = leaf
    return AbsVal(dtype=dtype, integral=bool(integral
                                             or _dtype_integral(dtype)))


def analyze(program: Program, *, integral_inputs=None) -> Analysis:
    """Analyze a traced :class:`Program`: per-output :class:`AbsVal`\\ s
    plus the hygiene collections. ``integral_inputs`` optionally marks
    flattened inputs (by position) as provably integer-valued: the carry
    contract's hints (e.g. ``pos_last`` in {-1, 0, 1})."""
    an = Analysis(out_vals=[], callbacks=[], f64=[], nondet_sites=[])
    # Two passes, the unrolled counterpart of the reference's loop
    # fixpoint: the first finds every site that accumulates in some
    # iteration (a structural merge or a carry), the second gives each of
    # them its census at every iteration, the first included, as the
    # fixpoint's carry does. Without it a value read after the first
    # iterations only (a block's peak before the last block) would count
    # fewer sites on a short probe than on a long one.
    for _ in range(2):
        an = Analysis(out_vals=[], callbacks=[], f64=[], nondet_sites=[],
                      _accum=an._accum)
        vals = _walk(program, an, integral_inputs)
    out = []
    for ref, weak in zip(program.out_refs, program.out_weak):
        v = _const_val(ref) if ref[0] == "c" else vals[ref[1]]
        if weak != v.weak:
            v = dataclasses.replace(
                v, weak=weak, weak_chain=v.weak_chain if weak else ())
        if weak and program.alt_error and not v.weak_chain:
            v = dataclasses.replace(v, weak_chain=(
                f"fails under the float64 default dtype: "
                f"{program.alt_error}",))
        out.append(v)
    an.out_vals = out
    return an


def _walk(program: Program, an: Analysis, integral_inputs) -> dict:
    vals: dict = {}
    for i, dtype in enumerate(program.in_dtypes):
        hint = (integral_inputs is not None and i < len(integral_inputs)
                and bool(integral_inputs[i]))
        vals[i] = AbsVal(
            dtype=dtype, integral=hint or _dtype_integral(dtype),
            lineage=(frozenset({("in", i)}) if _is_float(dtype)
                     else frozenset()))
    an.n_eqns = len(program.nodes)
    for n in program.nodes:
        _transfer(n, vals, an)
    return vals


def _is_round_trip(n: Node) -> bool:
    return n.op in CALLBACK_OPS or (
        n.op in _COPY_OPS and "cpu" in n.out_devices
        and any(lf[-1] != "cpu" for lf in _operands(n)))


def host_round_trips(program: Program) -> list:
    """``[(op, frame)]`` of the program's host round trips, one per op
    name: the collection :func:`analyze` makes, without the lattice."""
    out, seen = [], set()
    for n in program.nodes:
        if n.op not in seen and _is_round_trip(n):
            seen.add(n.op)
            out.append((n.op, f"{n.op} @ {n.frame}"))
    return out


def _operands(n: Node, names=None) -> list:
    if names is None:
        return [lf for leaves in n.operands.values() for lf in leaves]
    return [lf for name in names for lf in n.operands.get(name, ())]


def _transfer(n: Node, vals: dict, an: Analysis) -> None:
    op = n.op
    frame = None

    def fr() -> str:
        nonlocal frame
        if frame is None:
            frame = f"{op} @ {n.frame}"
        return frame

    def get(leaf) -> AbsVal:
        return _const_val(leaf) if leaf[0] == "c" else vals[leaf[1]]

    all_leaves = _operands(n)
    # Hygiene collections ride the same walk regardless of class logic.
    if _is_round_trip(n):
        if op not in an._callback_names:
            an._callback_names.add(op)
            an.callbacks.append((op, fr()))
    if not an.f64:
        for dt in n.out_dtypes:
            if dt in ("float64", "complex128"):
                an.f64.append((dt, op, fr()))
                break

    invals = [get(lf) for lf in all_leaves]
    all_sites = (frozenset().union(*(x.sites for x in invals))
                 if invals else frozenset())
    for j, (vid, dtype) in enumerate(zip(n.outs, n.out_dtypes)):
        weak = bool(n.weak[j]) if j < len(n.weak) else False
        weak_chain: tuple = ()
        if weak:
            for v in invals:
                if v.weak:
                    weak_chain = _cap_chain(v.weak_chain + (fr(),))
                    break
            else:
                weak_chain = (fr(),)
        vals[vid] = _transfer_one(n, dtype, weak, weak_chain, get, invals,
                                  all_sites, fr, an)


def _transfer_one(n, dtype, weak, weak_chain, get, invals, all_sites, fr,
                  an) -> AbsVal:
    op = n.op
    if op in _FACTORY_OPS:
        fill = [get(lf) for name, leaves in n.operands.items()
                if name not in ("self", "input") for lf in leaves]
        integral = (_dtype_integral(dtype) or op.startswith(("empty",
                                                             "new_empty"))
                    or all(v.integral for v in fill))
        return AbsVal(dtype=dtype, weak=weak, integral=bool(integral),
                      weak_chain=weak_chain)

    if op in _CMP_OPS or op in _SIGN_OPS or op in _ARG_REDUCES:
        cls = max([_selection_contrib(x) for x in invals], default=EXACT)
        chain = ()
        for x in invals:
            if x.cls == NONDET:
                chain = x.chain
                break
        return AbsVal(dtype=dtype, weak=weak, cls=cls, integral=True,
                      sites=all_sites, chain=chain, weak_chain=weak_chain)

    if op in _NONDET_OPS and (op not in _ACCUMULATE_FLAG
                              or bool(n.flags.get("accumulate"))):
        names = _NONDET_OPS[op]
        data = ([get(lf) for lf in _operands(n, names)] if names
                else list(invals))
        base = _join(data, dtype=dtype, weak=weak)
        if _is_float(dtype) and not base.integral:
            skey = (n.site, op)
            if skey not in an._nondet_seen:
                an._nondet_seen.add(skey)
                an.nondet_sites.append((op, fr()))
            return dataclasses.replace(
                base, cls=NONDET, sites=all_sites,
                chain=_cap_chain(base.chain + (fr(),)),
                weak_chain=weak_chain)
        cls = max(base.cls, INT_EXACT if _is_float(dtype) else EXACT)
        return dataclasses.replace(base, cls=cls, sites=all_sites,
                                   weak_chain=weak_chain)

    if op in _REDUCE_SITE_OPS:
        base = _join(invals, dtype=dtype, weak=weak)
        if not _is_float(dtype):
            return dataclasses.replace(base, sites=all_sites,
                                       weak_chain=weak_chain)
        if base.integral and op in _INT_EXACT_REDUCES:
            return dataclasses.replace(
                base, cls=max(base.cls, INT_EXACT), sites=all_sites,
                weak_chain=weak_chain)
        return dataclasses.replace(
            base, cls=max(base.cls, FLOAT_ACCUM), integral=False,
            sites=all_sites | {f"{_site_str(n.site)}:{op}"},
            chain=_cap_chain(base.chain + (fr(),)), weak_chain=weak_chain)

    value_names = _VALUE_OPERANDS.get(op)
    if value_names is not None:
        data = [get(lf) for lf in _operands(n, value_names)]
        idx = [get(lf) for name, leaves in n.operands.items()
               if name not in value_names for lf in leaves]
        base = _join(data, dtype=dtype, weak=weak)
        cls = max([base.cls] + [_selection_contrib(x) for x in idx])
        integral = True if _dtype_integral(dtype) else base.integral
        return dataclasses.replace(base, cls=cls, integral=integral,
                                   sites=all_sites, weak_chain=weak_chain)

    # Default: value join. Moves preserve integrality and apply no
    # arithmetic; arithmetic marks every lineage token arith-crossed, an
    # `add` of overlapping float lineages is a structural reassociation
    # site, and an arithmetic op fed by an earlier call of itself (an
    # unrolled loop's previous iteration) is a carry site.
    base = _join(invals, dtype=dtype, weak=weak)
    if _dtype_integral(dtype):
        integral = True
    elif op in _MOVE_OPS or op in _INT_PRESERVING_ARITH:
        integral = base.integral
    else:
        integral = False
    if op in _MOVE_OPS or not _is_float(dtype):
        return dataclasses.replace(base, integral=integral,
                                   sites=all_sites, weak_chain=weak_chain)
    sites = all_sites
    cls = base.cls
    chain = base.chain
    carry = base.carry
    ckey = (n.site, op)
    own: set = set()          # the census sites this op adds itself
    own_cls = EXACT
    pair = [get(lf) for lf in _operands(n, ("self", "other"))]
    if op == "add" and len(pair) == 2 and not integral \
            and (pair[0].lineage & pair[1].lineage):
        own.add(f"{_site_str(n.site)}:{op}")
        own_cls = FLOAT_ACCUM
    first = carry.get(ckey)
    if first is None:
        carry = dict(carry)
        carry[ckey] = n.call
    elif first < n.call:
        if integral:
            own_cls = max(own_cls, INT_EXACT)
        else:
            own.add(f"{_line_str(n.site)}#carry")
            own_cls = FLOAT_ACCUM
    if own or own_cls > EXACT:
        prev = an._accum.get(ckey)
        an._accum[ckey] = (frozenset(own) | (prev[0] if prev else
                                             frozenset()),
                           max(own_cls, prev[1] if prev else EXACT))
    seen = an._accum.get(ckey)
    if seen is not None:
        new = seen[0] - sites
        if new:
            sites = sites | new
            # Every counted site joins the chain: a census change's
            # introducing op must be reportable even when the class was
            # already float-accum.
            chain = _cap_chain(chain + (fr(),))
        cls = max(cls, seen[1])
    return AbsVal(dtype=dtype, weak=weak, cls=cls, integral=integral,
                  lineage=base.lineage, sites=sites,
                  chain=chain, weak_chain=weak_chain, carry=carry)


def _site_str(key: tuple) -> str:
    return ">".join(f"{os.path.basename(code.co_filename)}:"
                    f"{_line(code, lasti)}@{lasti}" for code, lasti in key)


def _line_str(key: tuple) -> str:
    return ">".join(f"{os.path.basename(code.co_filename)}:"
                    f"{_line(code, lasti)}" for code, lasti in key)
