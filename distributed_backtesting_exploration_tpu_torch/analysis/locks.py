"""dbxlint concurrency layer: whole-package lock model + four rules (the
reference's ``analysis/locks.py`` over this package, with the card's
waits of :mod:`.ast_rules` as its device syncs).

The per-module, per-class lock rules (rounds 3-11) kept catching real
races one advisory pass late — the quota-charge check-then-act, the
PagePool scrape stall — because a per-function view provably cannot see
cross-module orderings (the same reason "Automatic Full Compilation …
to Cloud TPUs" insists on a whole-program view). This module
builds ONE model of the whole lint target and derives every concurrency
rule from it:

- a **cross-module call graph**: bare names resolve through the lexical
  scope tree, ``self.m()`` through the class (and bases), ``self.attr.m()``
  through attribute types inferred from ``self.attr = ClassName(...)``
  constructor assignments, ``alias.f()`` through the import map, local
  ``var = ClassName(...)`` through function-local typing. Unresolvable
  calls (dict methods, dynamic dispatch) are simply not edges — the
  resolver is precision-first, never name-splatter (``self._entries.pop``
  must not resolve to ``ByteLRU.pop``);
- **per-function held-lock sets**: a fixpoint over (function, entry
  held-set) contexts. ``with <lock>:`` adds the lock — identified at
  class level, like Linux lockdep's lock classes: ``threading.Lock/RLock``
  attributes key ``(module, class, attr)``, module-level locks
  ``(module, None, name)`` — and calls propagate the current held set
  into the callee as a new entry context. Public functions (no leading
  underscore on function or class) additionally get the empty context:
  anyone may call them lock-free. Private helpers get ONLY their real
  call sites' contexts — which is what turns "``prepare()`` holds the
  lock" suppressions into proofs;
- the **global lock-acquisition-order graph**: an edge ``A -> B`` for
  every site that acquires ``B`` while holding ``A`` (in any context).

Rules derived from the model:

- ``lock-order``: cycles in the order graph (ABBA deadlock risk) and
  nested re-acquisition of a non-reentrant ``Lock`` already held on a
  caller path (self-deadlock by construction);
- ``lock-discipline`` (interprocedural): a guarded field — mutated at
  least once with the owner's lock held, constructor bodies exempt —
  mutated on ANY reachable path that does not hold the lock. A helper
  whose every caller holds the lock is clean, provably;
- ``atomicity``: check-then-act across a lock release — a guarded field
  read into a local under the lock, a branch on that local outside it,
  and a re-acquired write to the same field (the quota-charge bug
  class). Re-validating the field under the second acquisition (the
  double-checked pattern) is the fix and reads as clean;
- ``lock-blocking``: a blocking or device-sync call (``sleep``,
  ``subprocess``, ``torch.cuda.synchronize`` and an event's or a
  stream's ``synchronize``,
  ``.result()``, ``.wait()``, ``open``/``makedirs``) executed while any
  lock is held, interprocedurally (the PagePool scrape-stall class:
  one slow syscall under an index lock starves every scrape).

The runtime twin (actual acquisition edges under ``DBX_LOCKDEP=1``)
lives in :mod:`.lockdep`.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from .ast_rules import (_DEVICE_SYNC, _FUNC_NODES, _MUTATORS, _build_scopes,
                        _dotted, _is_timeout_wait, _self_attr,
                        _terminal_name)
from .core import Finding, LintContext, PyFile

# Calls that block (or synchronize the device) and must never run under a
# lock: every other thread contending on it stalls for the full syscall /
# transfer, and a lock held across a wait can complete a deadlock cycle
# the order graph alone cannot see. File OPENS are included (path
# resolution / NFS under a hot-path lock); plain writes/fsync are not —
# the journal's serialized durable append is that discipline's point.
# Bounded queue/thread waits (`.get`/`.put`/`.join` with ``timeout=``,
# the pipeline handoff vocabulary) are detected by keyword in
# the leaf walk: a producer parking on a full handoff while holding an
# accounting lock stalls — or deadlocks against — its consumer.
_BLOCKING_UNDER_LOCK = ({"sleep", "input", "result", "wait", "open",
                         "makedirs"} | _DEVICE_SYNC)
_BLOCKING_MODULES = {"subprocess"}

# Per-function entry-context cap: past this the function is clearly on
# every path and more contexts add nothing but work.
_MAX_CONTEXTS = 12

# LockId: (module rel path, owning class name or None, attribute/name).
LockId = tuple


def _short_lock(lock: LockId) -> str:
    mod, cls, attr = lock
    stem = os.path.splitext(os.path.basename(mod))[0]
    return f"{stem}.{cls}.{attr}" if cls else f"{stem}.{attr}"


def _lock_kind(node: ast.AST) -> str | None:
    """``"Lock"``/``"RLock"`` when ``node`` is a lock-factory call."""
    if isinstance(node, ast.Call):
        t = _terminal_name(node.func)
        if t in ("Lock", "RLock"):
            return t
    return None


# ---------------------------------------------------------------------------
# Model data
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Func:
    idx: int
    pf: PyFile
    mod: "_Module"
    node: ast.AST
    qual: str
    cls: "_Class | None"
    scope: object                   # ast_rules._Scope (bare-name resolution)
    public: bool


@dataclasses.dataclass
class _Class:
    mod: "_Module"
    name: str
    node: ast.ClassDef
    methods: dict = dataclasses.field(default_factory=dict)
    locks: dict = dataclasses.field(default_factory=dict)   # attr -> kind
    # attr -> candidate constructor-call func exprs (resolved lazily).
    attr_ctors: dict = dataclasses.field(default_factory=dict)
    bases: list = dataclasses.field(default_factory=list)   # base exprs


@dataclasses.dataclass
class _Module:
    rel: str
    dotted: str
    pf: PyFile
    classes: dict = dataclasses.field(default_factory=dict)
    funcs: dict = dataclasses.field(default_factory=dict)   # top-level only
    locks: dict = dataclasses.field(default_factory=dict)   # name -> kind
    globals: set = dataclasses.field(default_factory=set)
    imports_mod: dict = dataclasses.field(default_factory=dict)
    imports_sym: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LockModel:
    modules: dict = dataclasses.field(default_factory=dict)  # dotted -> _Module
    funcs: list = dataclasses.field(default_factory=list)
    by_node: dict = dataclasses.field(default_factory=dict)  # id(ast) -> _Func
    # (lockA, lockB) -> list[(rel, line, qual)]: B acquired holding A.
    edges: dict = dataclasses.field(default_factory=dict)
    # (lock, rel, line, qual, origin): re-acquisition of a held plain Lock.
    self_nest: list = dataclasses.field(default_factory=list)
    # (func, kind, owner, field, line, heldset, origin)
    mutations: list = dataclasses.field(default_factory=list)
    # (func, line, call, heldset, origin)
    blocking: list = dataclasses.field(default_factory=list)
    entry: dict = dataclasses.field(default_factory=dict)    # idx -> set[ctx]
    origin: dict = dataclasses.field(default_factory=dict)   # (idx,ctx)->str
    # idx -> (local_types, local_shadows): body-only facts, computed once
    # per function however many entry contexts re-walk it.
    fn_cache: dict = dataclasses.field(default_factory=dict)
    guarded_attr: dict = dataclasses.field(default_factory=dict)
    guarded_global: dict = dataclasses.field(default_factory=dict)

    def add_edge(self, a: LockId, b: LockId, rel: str, line: int,
                 qual: str) -> None:
        self.edges.setdefault((a, b), []).append((rel, line, qual))


def _module_dotted(rel: str) -> str:
    parts = rel.replace(os.sep, "/").split("/")
    parts[-1] = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def get_model(ctx: LintContext) -> LockModel:
    """The (cached) lock model for this lint invocation — built once,
    shared by every concurrency rule."""
    model = getattr(ctx, "_lock_model", None)
    if model is None:
        model = _build_model(ctx)
        ctx._lock_model = model
    return model


# ---------------------------------------------------------------------------
# Build pass 1: modules, classes, functions, imports
# ---------------------------------------------------------------------------

def _build_model(ctx: LintContext) -> LockModel:
    from .core import PACKAGE_NAME

    model = LockModel()
    for pf in ctx.files:
        rel = pf.rel
        mod = _Module(rel=rel, dotted=_module_dotted(rel), pf=pf)
        model.modules[mod.dotted] = mod
        _scan_module(model, mod, PACKAGE_NAME)
    _resolve_imports(model)
    _fixpoint(model)
    _finalize_guarded(model)
    return model


def _scan_module(model: LockModel, mod: _Module, pkg_name: str) -> None:
    pf = mod.pf
    _, scopes = _build_scopes(pf.tree)
    scope_by_node = {id(s.node): s for s in scopes}

    # Imports (resolved against the module table in pass 2).
    is_init = os.path.basename(pf.rel) == "__init__.py"
    pkg_parts = mod.dotted.split(".") if mod.dotted else []
    if not is_init:
        pkg_parts = pkg_parts[:-1]
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.name
                if name == pkg_name or name.startswith(pkg_name + "."):
                    inner = name[len(pkg_name):].lstrip(".")
                    mod.imports_mod[alias.asname
                                    or name.split(".")[-1]] = inner
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[:len(pkg_parts) - (node.level - 1)] \
                    if node.level - 1 <= len(pkg_parts) else None
                if base is None:
                    continue
            elif node.module and (node.module == pkg_name
                                  or node.module.startswith(pkg_name + ".")):
                base = node.module[len(pkg_name):].lstrip(".").split(".")
                base = [p for p in base if p]
                for alias in node.names:
                    mod.imports_sym[alias.asname or alias.name] = (
                        ".".join(base), alias.name)
                continue
            else:
                continue
            target = base + (node.module.split(".") if node.module else [])
            for alias in node.names:
                local = alias.asname or alias.name
                # `from . import panel_store` imports a MODULE; `from
                # .tenancy import ByteLRU` a symbol. Disambiguated in
                # pass 2 once every module is known; record both forms.
                mod.imports_sym[local] = (".".join(target), alias.name)

    # Classes (EVERY ClassDef, nested-in-function/-class included — a
    # lock-owning class defined inside a factory must not lint blind),
    # top-level functions, module locks/globals. Only top-level classes
    # enter the name-resolution table; each class's attribute scan stops
    # at nested ClassDef subtrees so an inner class's `self._lock` is
    # never credited to the outer class's lock set.
    all_classes: list[_Class] = []
    top_level_cls = {id(s) for s in pf.tree.body
                     if isinstance(s, ast.ClassDef)}
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        cls = _Class(mod=mod, name=node.name, node=node,
                     bases=list(node.bases))
        all_classes.append(cls)
        if id(node) in top_level_cls:
            mod.classes[node.name] = cls
        for sub in _class_own_nodes(node):
            if isinstance(sub, ast.Assign):
                kind = _lock_kind(sub.value)
                for t in sub.targets:
                    a = _self_attr(t)
                    if a is None:
                        continue
                    if kind:
                        cls.locks[a] = kind
                    else:
                        ctors = _ctor_candidates(sub.value)
                        if ctors:
                            cls.attr_ctors.setdefault(a, []).extend(ctors)
    for stmt in pf.tree.body:
        if isinstance(stmt, ast.Assign):
            kind = _lock_kind(stmt.value)
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    if kind:
                        mod.locks[t.id] = kind
                    else:
                        mod.globals.add(t.id)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                            ast.Name):
            mod.globals.add(stmt.target.id)
    mod.globals -= set(mod.locks)

    # Every function-like scope becomes a _Func (nested defs included —
    # they are resolvable through the scope tree; lambdas are not
    # walked as functions of their own).
    class_of_method = {}
    for cls in all_classes:
        for m in cls.node.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                class_of_method[id(m)] = cls
    for scope in scopes:
        node = scope.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cls = class_of_method.get(id(node))
        public = not node.name.startswith("_") or (
            node.name.startswith("__") and node.name.endswith("__"))
        if cls is not None and cls.name.startswith("_"):
            public = False
        fi = _Func(idx=len(model.funcs), pf=pf, mod=mod, node=node,
                   qual=scope.qualname, cls=cls, scope=scope, public=public)
        model.funcs.append(fi)
        model.by_node[id(node)] = fi
        model.entry[fi.idx] = set()
        if cls is not None:
            cls.methods[node.name] = fi
        elif scope.parent is not None and getattr(
                scope.parent, "qualname", None) == "<module>":
            mod.funcs[node.name] = fi


def _class_own_nodes(cls_node: ast.ClassDef):
    """Walk a class's subtree WITHOUT descending into nested ClassDefs
    (their assignments belong to them) — function bodies are included
    (``__init__`` is where lock/attr assignments live)."""
    stack = list(ast.iter_child_nodes(cls_node))
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _ctor_candidates(value: ast.AST) -> list:
    """Constructor-call func exprs inside an attribute assignment's value
    — unwrapping the ``a or B()`` / ``a if c else B()`` idioms so
    ``self._journal = journal or Journal(None)`` still types."""
    out = []
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, ast.Call):
            out.append(v.func)
        elif isinstance(v, ast.BoolOp):
            stack.extend(v.values)
        elif isinstance(v, ast.IfExp):
            stack.extend([v.body, v.orelse])
    return out


def _resolve_imports(model: LockModel) -> None:
    """Split ``from X import name`` records into module vs symbol imports
    now that the module table is complete."""
    for mod in model.modules.values():
        for local, (target, name) in list(mod.imports_sym.items()):
            cand = f"{target}.{name}" if target else name
            if cand in model.modules:
                mod.imports_mod[local] = cand
                del mod.imports_sym[local]


def _resolve_symbol(model: LockModel, dotted: str, name: str,
                    depth: int = 0):
    """``("class", _Class)`` / ``("func", _Func)`` for ``dotted.name``,
    following re-export chains (package ``__init__``) a few hops."""
    if depth > 4:
        return None
    m = model.modules.get(dotted)
    if m is None:
        return None
    if name in m.classes:
        return ("class", m.classes[name])
    if name in m.funcs:
        return ("func", m.funcs[name])
    hit = m.imports_sym.get(name)
    if hit is not None:
        return _resolve_symbol(model, hit[0], hit[1], depth + 1)
    return None


# ---------------------------------------------------------------------------
# Resolution helpers (class members, locks, callees)
# ---------------------------------------------------------------------------

def _base_classes(model: LockModel, cls: _Class, depth: int = 0):
    for b in cls.bases:
        k = _class_of_expr(model, b, cls.mod)
        if k is not None and depth < 4:
            yield k
            yield from _base_classes(model, k, depth + 1)


def _class_of_expr(model: LockModel, expr: ast.AST,
                   mod: _Module) -> _Class | None:
    if isinstance(expr, ast.Name):
        if expr.id in mod.classes:
            return mod.classes[expr.id]
        hit = mod.imports_sym.get(expr.id)
        if hit is not None:
            r = _resolve_symbol(model, hit[0], hit[1])
            if r is not None and r[0] == "class":
                return r[1]
        return None
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        target = mod.imports_mod.get(expr.value.id)
        if target is not None:
            r = _resolve_symbol(model, target, expr.attr)
            if r is not None and r[0] == "class":
                return r[1]
    return None


def _method_of(model: LockModel, cls: _Class, name: str) -> _Func | None:
    m = cls.methods.get(name)
    if m is not None:
        return m
    for base in _base_classes(model, cls):
        m = base.methods.get(name)
        if m is not None:
            return m
    return None


def _lock_attr_of(model: LockModel, cls: _Class,
                  attr: str) -> tuple[_Class, str] | None:
    """The class DEFINING lock attribute ``attr`` (self or a base) — lock
    identity belongs to the defining class, Linux-lockdep style."""
    if attr in cls.locks:
        return (cls, cls.locks[attr])
    for base in _base_classes(model, cls):
        if attr in base.locks:
            return (base, base.locks[attr])
    return None


def _attr_type(model: LockModel, cls: _Class, attr: str) -> _Class | None:
    ctors = cls.attr_ctors.get(attr)
    if ctors:
        for f in ctors:
            k = _class_of_expr(model, f, cls.mod)
            if k is not None:
                return k
    for base in _base_classes(model, cls):
        k = _attr_type(model, base, attr)
        if k is not None:
            return k
    return None


def _class_has_locks(model: LockModel, cls: _Class) -> bool:
    if cls.locks:
        return True
    return any(base.locks for base in _base_classes(model, cls))


def _owner_locks(model: LockModel, cls: _Class) -> frozenset:
    out = {(cls.mod.rel, cls.name, a) for a in cls.locks}
    for base in _base_classes(model, cls):
        out |= {(base.mod.rel, base.name, a) for a in base.locks}
    return frozenset(out)


def _lock_in_expr(model: LockModel, expr: ast.AST,
                  fi: _Func) -> tuple[LockId, str] | None:
    a = _self_attr(expr)
    if a is not None and fi.cls is not None:
        hit = _lock_attr_of(model, fi.cls, a)
        if hit is not None:
            owner, kind = hit
            return ((owner.mod.rel, owner.name, a), kind)
        return None
    if isinstance(expr, ast.Name) and expr.id in fi.mod.locks:
        return ((fi.mod.rel, None, expr.id), fi.mod.locks[expr.id])
    return None


def _local_types(model: LockModel, fi: _Func) -> dict:
    """Function-local ``var = ClassName(...)`` typing (single pass; last
    binding wins, good enough for construction-then-use bodies)."""
    out: dict = {}
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            k = _class_of_expr(model, node.value.func, fi.mod)
            if k is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = k
    return out


def _callees(model: LockModel, call: ast.Call, fi: _Func,
             local_types: dict) -> list[_Func]:
    f = call.func
    if isinstance(f, ast.Name):
        hit = fi.scope.resolve(f.id)
        if hit is not None:
            target = model.by_node.get(id(hit.node))
            return [target] if target is not None else []
        k = _class_of_expr(model, f, fi.mod)
        if k is not None:
            init = _method_of(model, k, "__init__")
            return [init] if init is not None else []
        sym = fi.mod.imports_sym.get(f.id)
        if sym is not None:
            r = _resolve_symbol(model, sym[0], sym[1])
            if r is not None and r[0] == "func":
                return [r[1]]
        return []
    if not isinstance(f, ast.Attribute):
        return []
    base = f.value
    if isinstance(base, ast.Name):
        if base.id == "self" and fi.cls is not None:
            m = _method_of(model, fi.cls, f.attr)
            return [m] if m is not None else []
        k = local_types.get(base.id)
        if k is not None:
            m = _method_of(model, k, f.attr)
            return [m] if m is not None else []
        target = fi.mod.imports_mod.get(base.id)
        if target is not None:
            r = _resolve_symbol(model, target, f.attr)
            if r is not None and r[0] == "func":
                return [r[1]]
            if r is not None and r[0] == "class":
                init = _method_of(model, r[1], "__init__")
                return [init] if init is not None else []
        return []
    if (isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name)
            and base.value.id == "self" and fi.cls is not None):
        k = _attr_type(model, fi.cls, base.attr)
        if k is not None:
            m = _method_of(model, k, f.attr)
            return [m] if m is not None else []
    return []


# ---------------------------------------------------------------------------
# Build pass 2: (function, entry-held-set) fixpoint
# ---------------------------------------------------------------------------

def _local_shadows(fn: ast.AST) -> set:
    """Names any plain assignment makes function-local (Python scoping:
    mutations then target the shadow, not a guarded module global)."""
    declared_global = {
        name for node in ast.walk(fn)
        if isinstance(node, ast.Global) for name in node.names}
    return {
        t.id
        for node in ast.walk(fn)
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.For))
        for t in (node.targets if isinstance(node, ast.Assign)
                  else [node.target])
        if isinstance(t, ast.Name)
    } - declared_global


def _fixpoint(model: LockModel) -> None:
    work: list[tuple[_Func, frozenset]] = []

    def seed(fi: _Func, ctx: frozenset, origin: str):
        key = (fi.idx, ctx)
        if ctx in model.entry[fi.idx] \
                or len(model.entry[fi.idx]) >= _MAX_CONTEXTS:
            return
        model.entry[fi.idx].add(ctx)
        model.origin.setdefault(key, origin)
        work.append((fi, ctx))

    for fi in model.funcs:
        if fi.public:
            seed(fi, frozenset(), "a lock-free public entry")
    processed = 0
    while work:
        fi, ctx = work.pop()
        processed += 1
        if processed > 50000:     # runaway guard; never hit in practice
            break
        _walk_func(model, fi, ctx, seed)
    # Private functions with no in-package callers still get walked once
    # lock-free: their with-blocks must contribute order edges and their
    # mutations must be judged exactly like the pre-interprocedural rule.
    for fi in model.funcs:
        if not model.entry[fi.idx]:
            seed(fi, frozenset(), "a caller outside the analyzed package")
    while work:
        fi, ctx = work.pop()
        _walk_func(model, fi, ctx, seed)


def _walk_func(model: LockModel, fi: _Func, entry: frozenset, seed) -> None:
    cached = model.fn_cache.get(fi.idx)
    if cached is None:
        cached = model.fn_cache[fi.idx] = (_local_types(model, fi),
                                           _local_shadows(fi.node))
    local_types, shadows = cached
    origin = model.origin.get((fi.idx, entry), "")
    check_attrs = (fi.cls is not None
                   and _class_has_locks(model, fi.cls)
                   and fi.node.name != "__init__")
    check_globals = bool(fi.mod.locks)

    def record_mutation(kind, owner, field, line, held):
        model.mutations.append((fi, kind, owner, field, line,
                                frozenset(held), origin))

    def leaf(node, held):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.Delete)):
            targets = (node.targets if isinstance(node, (ast.Assign,
                                                         ast.Delete))
                       else [node.target])
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                a = _self_attr(base)
                if a is not None and check_attrs:
                    record_mutation("attr", fi.cls, a, node.lineno, held)
                elif (isinstance(base, ast.Name) and check_globals
                      and base.id in fi.mod.globals
                      and base.id not in shadows):
                    record_mutation("global", fi.mod, base.id, node.lineno,
                                    held)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                a = _self_attr(f.value)
                if a is not None and check_attrs:
                    record_mutation("attr", fi.cls, a, node.lineno, held)
                elif (isinstance(f.value, ast.Name) and check_globals
                      and f.value.id in fi.mod.globals
                      and f.value.id not in shadows):
                    record_mutation("global", fi.mod, f.value.id,
                                    node.lineno, held)
            if held:
                term = _terminal_name(f)
                dotted = _dotted(f) or ""
                if (term in _BLOCKING_UNDER_LOCK
                        or _is_timeout_wait(node, term)
                        or dotted.split(".")[0] in _BLOCKING_MODULES):
                    model.blocking.append((fi, node.lineno, dotted or term,
                                           frozenset(held), origin))
            for callee in _callees(model, node, fi, local_types):
                seed(callee, frozenset(held),
                     f"`{fi.qual}` "
                     + (f"holding {', '.join(sorted(_short_lock(h) for h in held))}"
                        if held else "lock-free"))

    def visit(node, held):
        if isinstance(node, _FUNC_NODES):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in node.items:
                # The context expressions evaluate (and may call) BEFORE
                # the locks they denote are taken.
                for sub in ast.walk(item.context_expr):
                    if not isinstance(sub, _FUNC_NODES):
                        leaf(sub, held)
                hit = _lock_in_expr(model, item.context_expr, fi)
                if hit is None:
                    continue
                lock, kind = hit
                line = item.context_expr.lineno
                if lock in held or lock in acquired:
                    if kind == "Lock":
                        model.self_nest.append(
                            (lock, fi.pf.rel, line, fi.qual, origin))
                    continue
                for h in held:
                    model.add_edge(h, lock, fi.pf.rel, line, fi.qual)
                for h in acquired:
                    model.add_edge(h, lock, fi.pf.rel, line, fi.qual)
                acquired.append(lock)
            inner = held | frozenset(acquired)
            for stmt in node.body:
                visit(stmt, inner)
            return
        leaf(node, held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fi.node.body:
        visit(stmt, entry)


def _finalize_guarded(model: LockModel) -> None:
    """Guardedness inference over the whole fixpoint: a field is guarded
    when SOME mutation of it ran with one of the owner's locks held —
    including mutations in helpers whose callers held the lock, which
    the per-function view could not credit."""
    for fi, kind, owner, field, _line, held, _origin in model.mutations:
        if kind == "attr":
            if held & _owner_locks(model, owner):
                model.guarded_attr.setdefault(
                    (owner.mod.rel, owner.name), set()).add(field)
        else:
            if held & {(owner.rel, None, n) for n in owner.locks}:
                model.guarded_global.setdefault(owner.rel, set()).add(field)


# ---------------------------------------------------------------------------
# Rule: lock-order
# ---------------------------------------------------------------------------

def _sccs(adj: dict) -> list[set]:
    """Tarjan strongly-connected components (iterative) over the lock
    order graph; only multi-node SCCs can carry cycles here (self-edges
    are filtered at edge insertion)."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    out: list[set] = []
    counter = [0]

    def strongconnect(v):
        call_stack = [(v, iter(adj.get(v, ())))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while call_stack:
            node, it = call_stack[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    call_stack.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            call_stack.pop()
            if call_stack:
                parent = call_stack[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                out.append(comp)

    for v in adj:
        if v not in index:
            strongconnect(v)
    return out


class LockOrderRule:
    """Cycles in the global lock-acquisition-order graph + re-acquisition
    of a held non-reentrant lock (module docstring)."""

    name = "lock-order"
    doc = "lock-acquisition-order cycle or nested re-acquisition"

    def check(self, ctx: LintContext) -> list[Finding]:
        model = get_model(ctx)
        out: list[Finding] = []
        adj: dict = {}
        for (a, b) in model.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        cyclic = [c for c in _sccs(adj) if len(c) > 1]
        for comp in cyclic:
            names = " <-> ".join(sorted(_short_lock(c) for c in comp))
            for (a, b), sites in sorted(model.edges.items(),
                                        key=lambda kv: str(kv[0])):
                if a not in comp or b not in comp:
                    continue
                rev = model.edges.get((b, a), [])
                rev_at = (f" (reverse order at {rev[0][0]}:{rev[0][1]})"
                          if rev else "")
                for rel, line, qual in sites:
                    out.append(Finding(
                        self.name, rel, line,
                        f"lock-order cycle [{names}]: `{_short_lock(b)}` "
                        f"is acquired in `{qual}` while "
                        f"`{_short_lock(a)}` is held{rev_at} — "
                        "inconsistent acquisition order can deadlock; "
                        "pick one global order and stick to it"))
        for lock, rel, line, qual, origin in model.self_nest:
            out.append(Finding(
                self.name, rel, line,
                f"`{_short_lock(lock)}` is re-acquired in `{qual}` while "
                f"already held (reached via {origin}) — threading.Lock "
                "is non-reentrant, this self-deadlocks; use RLock or "
                "hoist the acquisition"))
        # One finding per site (a site can participate in several
        # contexts; the report is per line, like every other rule).
        seen: set = set()
        deduped = []
        for f in out:
            key = (f.path, f.line, f.message)
            if key not in seen:
                seen.add(key)
                deduped.append(f)
        return deduped


# ---------------------------------------------------------------------------
# Rule: lock-discipline (interprocedural)
# ---------------------------------------------------------------------------

class LockDisciplineRule:
    """Guarded-field mutations on a lock-free reachable path.

    A field is *guarded* when the class (or module) that owns a
    ``threading.Lock``/``RLock`` mutates it at least once while that
    lock is held — directly or via a caller, constructor bodies exempt.
    Any mutation of the same field on a path that does NOT hold the lock
    is a discipline violation. Interprocedural: a helper
    whose every in-package caller holds the lock is PROVABLY clean (the
    PagePool ``prepare()`` helpers), while a helper reachable lock-free
    (a public name, or one lock-free caller) is flagged with the
    offending path.
    """

    name = "lock-discipline"
    doc = "guarded-field mutation on a lock-free path"

    def check(self, ctx: LintContext) -> list[Finding]:
        model = get_model(ctx)
        flagged: dict = {}
        for fi, kind, owner, field, line, held, origin in model.mutations:
            if kind == "attr":
                if field not in model.guarded_attr.get(
                        (owner.mod.rel, owner.name), ()):
                    continue
                if held & _owner_locks(model, owner):
                    continue
                key = (fi.pf.rel, line, field)
                via = (f" (reached via {origin})"
                       if fi.cls is not None and fi.qual and origin
                       and not fi.public else "")
                flagged.setdefault(key, Finding(
                    self.name, fi.pf.rel, line,
                    f"`self.{field}` is mutated under `{owner.name}`'s "
                    f"lock elsewhere but mutated here without holding "
                    f"it{via}"))
            else:
                if field not in model.guarded_global.get(owner.rel, ()):
                    continue
                if held & {(owner.rel, None, n) for n in owner.locks}:
                    continue
                key = (fi.pf.rel, line, field)
                flagged.setdefault(key, Finding(
                    self.name, fi.pf.rel, line,
                    f"module global `{field}` is mutated under the module "
                    f"lock elsewhere but mutated here without holding it"))
        return list(flagged.values())


# ---------------------------------------------------------------------------
# Rule: atomicity
# ---------------------------------------------------------------------------

class AtomicityRule:
    """Check-then-act on a guarded field across a lock release.

    The shape: a ``with lock:`` block reads a guarded field into a
    local, the lock is released, a branch tests that local, and a later
    ``with lock:`` block writes the same field — the written value may
    act on state another thread changed in the window (the
    quota-charge race: charge computed from a pre-window read let an
    at-quota tenant take one extra batch per concurrent poll). The
    double-checked fix — re-reading the field under the second
    acquisition — reads as clean.
    """

    name = "atomicity"
    doc = "check-then-act on a guarded field across lock release"

    def check(self, ctx: LintContext) -> list[Finding]:
        model = get_model(ctx)
        out: list[Finding] = []
        for fi in model.funcs:
            out.extend(self._check_func(model, fi))
        # dedupe (functions are walked once here, but stay defensive)
        seen: set = set()
        deduped = []
        for f in out:
            if (f.path, f.line) not in seen:
                seen.add((f.path, f.line))
                deduped.append(f)
        return deduped

    def _guarded_fields(self, model: LockModel, fi: _Func,
                        lock: LockId) -> set:
        if lock[1] is not None and fi.cls is not None:
            return model.guarded_attr.get((lock[0], lock[1]), set())
        if lock[1] is None:
            return model.guarded_global.get(lock[0], set())
        return set()

    def _field_of(self, node: ast.AST, fi: _Func, lock: LockId):
        if lock[1] is not None:
            return _self_attr(node)
        if isinstance(node, ast.Name):
            return node.id
        return None

    def _check_func(self, model: LockModel, fi: _Func) -> list[Finding]:
        regions: dict = {}   # lock -> [(with_node, start, end)]
        for node in ast.walk(fi.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    hit = _lock_in_expr(model, item.context_expr, fi)
                    if hit is None:
                        continue
                    end = max((getattr(n, "lineno", node.lineno)
                               for n in ast.walk(node)),
                              default=node.lineno)
                    regions.setdefault(hit[0], []).append(
                        (node, node.lineno, end))
        out: list[Finding] = []
        conds = None   # computed once per function, only when needed
        for lock, regs in regions.items():
            if len(regs) < 2:
                continue
            guarded = self._guarded_fields(model, fi, lock)
            if not guarded:
                continue
            regs.sort(key=lambda r: r[1])
            if conds is None:
                conds = [n for n in ast.walk(fi.node)
                         if isinstance(n, (ast.If, ast.While, ast.IfExp))]
            for i, (a_node, a_start, a_end) in enumerate(regs):
                reads = self._region_reads(a_node, fi, lock, guarded)
                if not reads:
                    continue
                for b_node, b_start, _b_end in regs[i + 1:]:
                    if b_start <= a_end:
                        continue   # nested/overlapping: same critical sect.
                    writes = self._region_writes(b_node, fi, lock, guarded)
                    common = {f for f in writes if f in
                              {fld for fld, _ in reads.values()}}
                    if not common:
                        continue
                    if self._revalidates(b_node, fi, lock, common):
                        continue
                    read_names = {n for n, (fld, _) in reads.items()
                                  if fld in common}
                    branch = self._deciding_branch(conds, read_names,
                                                   a_end, b_start, b_node)
                    if branch is None:
                        continue
                    field = sorted(common)[0]
                    rline = min(line for fld, line in reads.values()
                                if fld == field)
                    wline = writes[field]
                    prefix = "self." if lock[1] is not None else ""
                    out.append(Finding(
                        self.name, fi.pf.rel, wline,
                        f"check-then-act across `{_short_lock(lock)}` "
                        f"release in `{fi.qual}`: `{prefix}{field}` was "
                        f"read under the lock at line {rline}, the "
                        f"decision at line {branch.lineno} ran unlocked, "
                        f"and this re-acquired write may act on a stale "
                        f"value — hold the lock across the decision or "
                        f"re-validate `{prefix}{field}` under it"))
        return out

    def _region_reads(self, region: ast.AST, fi: _Func, lock: LockId,
                      guarded: set) -> dict:
        """name -> (field, line) for locals assigned inside the region
        from expressions reading a guarded field."""
        out: dict = {}
        for node in ast.walk(region):
            if isinstance(node, _FUNC_NODES):
                continue
            if not isinstance(node, ast.Assign):
                continue
            fields = [f for sub in ast.walk(node.value)
                      for f in [self._field_of(sub, fi, lock)]
                      if f in guarded]
            if not fields:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = (fields[0], node.lineno)
        return out

    def _region_writes(self, region: ast.AST, fi: _Func, lock: LockId,
                       guarded: set) -> dict:
        out: dict = {}
        for node in ast.walk(region):
            if isinstance(node, _FUNC_NODES):
                continue
            targets = []
            if isinstance(node, (ast.Assign, ast.Delete)):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _MUTATORS):
                targets = [node.func.value]
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                f = self._field_of(base, fi, lock)
                if f in guarded:
                    out.setdefault(f, node.lineno)
        return out

    def _revalidates(self, region: ast.AST, fi: _Func, lock: LockId,
                     fields: set) -> bool:
        """True when the region re-reads one of ``fields`` in a test
        (the double-checked pattern) before writing."""
        for node in ast.walk(region):
            if isinstance(node, (ast.If, ast.While, ast.IfExp,
                                 ast.Assert)):
                for sub in ast.walk(node.test):
                    if self._field_of(sub, fi, lock) in fields:
                        return True
        return False

    @staticmethod
    def _deciding_branch(conds, read_names: set, a_end: int, b_start: int,
                         b_node):
        """A conditional strictly after region A that tests a name bound
        from the guarded read, positioned before (or enclosing) region
        B."""
        if not read_names:
            return None
        b_ids = {id(n) for n in ast.walk(b_node)}
        for cnd in conds:
            if cnd.lineno <= a_end:
                continue
            if cnd.lineno > b_start and id(b_node) not in \
                    {id(x) for x in ast.walk(cnd)}:
                continue
            for sub in ast.walk(cnd.test):
                if isinstance(sub, ast.Name) and sub.id in read_names:
                    if id(cnd) not in b_ids:
                        return cnd
        return None


# ---------------------------------------------------------------------------
# Rule: lock-blocking
# ---------------------------------------------------------------------------

class LockBlockingRule:
    """Blocking / device-sync calls while a lock is held (module
    docstring) — interprocedural: a helper that sleeps is flagged when
    any caller path reaches it with a lock held."""

    name = "lock-blocking"
    doc = "blocking or device-sync call while holding a lock"

    def check(self, ctx: LintContext) -> list[Finding]:
        model = get_model(ctx)
        flagged: dict = {}
        for fi, line, call, held, origin in model.blocking:
            key = (fi.pf.rel, line)
            locks = ", ".join(sorted(_short_lock(h) for h in held))
            via = (f" (reached via {origin})"
                   if origin and not origin.startswith("a lock-free")
                   else "")
            flagged.setdefault(key, Finding(
                self.name, fi.pf.rel, line,
                f"blocking call `{call}` in `{fi.qual}` runs while "
                f"holding {locks}{via}: every contending thread stalls "
                "for its full duration (and a wait under a lock can "
                "complete a deadlock) — move it outside the critical "
                "section"))
        return list(flagged.values())
