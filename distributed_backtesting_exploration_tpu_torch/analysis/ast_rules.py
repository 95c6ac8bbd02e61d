"""dbxlint AST-layer rules: the reference's ``analysis/ast_rules.py`` with
the port's launch boundary in ``trace-time-env`` and the card's waits as
the device-sync vocabulary.

Five single-module rules over parsed source, all sharing one scope model
(:class:`_Scope`): a tree of function-like nodes (def / async def /
lambda) with bare-name resolution walking lexically outward. Class bodies
are transparent for scoping (names defined in a class body are NOT
visible inside its methods, matching Python), but methods are still
scanned as potential roots/targets. The concurrency rules
(``lock-discipline``, ``lock-order``, ``atomicity``, ``lock-blocking``)
need a whole-package view and live in :mod:`.locks`, built on the same
scope model.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from .core import Finding, LintContext, PyFile

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal_name(node: ast.AST) -> str | None:
    """Last component of a callee expression (``torch.cuda.synchronize``
    -> ``synchronize``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


@dataclasses.dataclass
class _Scope:
    """One function-like scope (or the module itself)."""

    node: ast.AST                       # Module / FunctionDef / Lambda
    parent: "_Scope | None"
    qualname: str
    defs: dict = dataclasses.field(default_factory=dict)  # name -> _Scope

    def resolve(self, name: str) -> "_Scope | None":
        scope = self
        while scope is not None:
            hit = scope.defs.get(name)
            if hit is not None:
                return hit
            scope = scope.parent
        return None

    def own_nodes(self):
        """AST nodes belonging directly to this scope — descent stops at
        nested function-like nodes (their bodies are their own scopes)."""
        stack = (list(ast.iter_child_nodes(self.node))
                 if isinstance(self.node, _FUNC_NODES + (ast.Module,))
                 else [self.node])
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, _FUNC_NODES):
                # Still yield decorators/defaults — they evaluate in THIS
                # scope — but not the nested body.
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    stack.extend(node.decorator_list)
                    stack.extend(node.args.defaults)
                    stack.extend(d for d in node.args.kw_defaults if d)
                continue
            stack.extend(ast.iter_child_nodes(node))


def _build_scopes(tree: ast.Module) -> tuple[_Scope, list[_Scope]]:
    """Scope tree + flat list of every function-like scope in the module."""
    module = _Scope(tree, None, "<module>")
    all_scopes: list[_Scope] = []

    def visit(node: ast.AST, scope: _Scope, in_class: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (f"{in_class}.{child.name}" if in_class
                        else child.name)
                sub = _Scope(child, scope, qual)
                if in_class is None:
                    # Methods are not bare-name-resolvable from peers.
                    scope.defs[child.name] = sub
                all_scopes.append(sub)
                visit(child, sub, None)
            elif isinstance(child, ast.Lambda):
                sub = _Scope(child, scope, f"{scope.qualname}.<lambda>")
                all_scopes.append(sub)
                visit(child, sub, None)
            elif isinstance(child, ast.ClassDef):
                visit(child, scope, child.name)
            else:
                visit(child, scope, in_class)

    visit(tree, module, None)
    return module, all_scopes


# ---------------------------------------------------------------------------
# Rule: trace-time-env
# ---------------------------------------------------------------------------

# The launch boundary: where a compiled kernel is built, loaded or
# launched. A function that loads a library (``ctypes.CDLL``) or names a C
# entry point (an attribute ``dbx_*``, or ``getattr(lib, f"dbx_...")``) is
# a root; ``ops/_kernels.py``'s ``build`` is reached from ``load``.
_LOAD_CALLS = {"CDLL"}
_ENTRY_PREFIX = "dbx_"


def _is_env_read(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return True
    if isinstance(node, ast.Call) and _terminal_name(node.func) == "getenv":
        return True
    return False


def _names_entry(node: ast.AST) -> bool:
    """True for a reference to a C entry point: ``lib.dbx_x`` or a
    ``getattr`` whose name is a string (or f-string) starting ``dbx_``."""
    if isinstance(node, ast.Attribute):
        return node.attr.startswith(_ENTRY_PREFIX)
    if (isinstance(node, ast.Call) and _terminal_name(node.func) == "getattr"
            and len(node.args) >= 2):
        name = node.args[1]
        if isinstance(name, ast.JoinedStr) and name.values:
            name = name.values[0]
        return (isinstance(name, ast.Constant) and isinstance(name.value, str)
                and name.value.startswith(_ENTRY_PREFIX))
    return False


class TraceTimeEnvRule:
    """``os.environ`` reads reachable from the launch boundary.

    The reference's rule keys on jit, pallas and shard_map entry points;
    the port has none of them. Its twin hazard is at the launch boundary:
    a library is built once under a key (``ops/_kernels.py``: the source,
    the shared headers and the flags) and loaded once a process, and a
    launch takes its settings from its arguments. An env read reachable
    from a function that builds, loads or launches a kernel picks a build
    or launch setting after the public call has resolved its own, outside
    that key: a later in-process change silently meets a stale library or
    splits one call's launches between two settings (the ``DBX_LANES_CAP``
    bug class). Reachability is same-module and over-approximate: a root
    reaches every module/nested function it references by name. The fix
    is to read the variable once in the public call and pass it down
    (``ops.fused.resolve_lanes_cap`` is the template: read once a public
    sweep call, never at the launch).
    """

    name = "trace-time-env"
    doc = "os.environ read reachable from a kernel's build, load or launch"

    def check(self, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for pf in ctx.files:
            out.extend(self._check_file(pf))
        return out

    def _roots(self, module: _Scope, scopes: list[_Scope]) -> list[_Scope]:
        roots: list[_Scope] = []
        for scope in scopes:
            for node in scope.own_nodes():
                if ((isinstance(node, ast.Call)
                     and _terminal_name(node.func) in _LOAD_CALLS)
                        or _names_entry(node)):
                    roots.append(scope)
                    break
        return roots

    def _check_file(self, pf: PyFile) -> list[Finding]:
        module, scopes = _build_scopes(pf.tree)
        reachable: dict[int, tuple[_Scope, str]] = {}   # id -> (scope, root)
        work = [(s, s.qualname) for s in self._roots(module, scopes)]
        while work:
            scope, root = work.pop()
            if id(scope) in reachable:
                continue
            reachable[id(scope)] = (scope, root)
            # Nested defs of a root run when it does; include them
            # outright (over-approximation is safe here).
            for sub in scope.defs.values():
                work.append((sub, root))
            for node in scope.own_nodes():
                if isinstance(node, ast.Name):
                    hit = scope.resolve(node.id)
                    if hit is not None:
                        work.append((hit, root))
        findings: dict[tuple, Finding] = {}
        for scope, root in reachable.values():
            for node in ast.walk(scope.node):
                if _is_env_read(node):
                    key = (pf.rel, node.lineno)
                    findings.setdefault(key, Finding(
                        self.name, pf.rel, node.lineno,
                        f"os.environ read at the launch boundary (reachable "
                        f"from `{root}`, which builds, loads or launches a "
                        f"compiled kernel); it is invisible to the "
                        f"library's key and the launch's arguments — read "
                        f"it once in the public call and pass it down"))
        return list(findings.values())


# ---------------------------------------------------------------------------
# Shared concurrency vocabulary (the lock rules in .locks build on these)
# ---------------------------------------------------------------------------

# Method names that mutate their receiver (dict/list/set/deque surface,
# plus `put` — the ByteLRU/store API every cache level here speaks).
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse", "push", "push_front", "put",
}

# Device-synchronizing calls: each blocks the calling host thread until
# the card drains — milliseconds to seconds on a loaded card, an eternity
# in a gRPC handler or under a lock (the PagePool scrape-stall class).
# They are the card's waits that the runtime twin (:mod:`.lockdep`)
# patches: ``torch.cuda.synchronize``, ``torch.cuda.Event.synchronize``
# and ``torch.cuda.Stream.synchronize``, all matched by their terminal
# name. The implicit syncs of a device tensor's ``.item()``, ``.cpu()``,
# ``.tolist()`` and ``.numpy()`` are not in the set: the same names are
# plain host calls on CPU tensors and numpy arrays, which is what the
# control plane calls them on.
_DEVICE_SYNC = {"synchronize"}

# Bounded queue/thread waits: `.get`/`.put`/`.join` with an
# explicit ``timeout=`` keyword. The keyword is the detector — it is what
# separates a queue/thread WAIT from the untimeouted `dict.get(k, d)` and
# `str.join(xs)` vocabulary that saturates ordinary code. A bounded wait
# is still a wait: in a servicer handler or under a lock it parks the
# caller exactly like a sleep of the timeout's length.
_WAIT_TERMINALS = {"get", "put", "join"}


def _is_timeout_wait(node: ast.Call, terminal: str | None) -> bool:
    """True for ``x.get(timeout=...)`` / ``x.put(..., timeout=...)`` /
    ``x.join(timeout=...)`` — the pipeline-queue wait vocabulary."""
    return (terminal in _WAIT_TERMINALS
            and any(kw.arg == "timeout" for kw in node.keywords))


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> ``X``."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


# ---------------------------------------------------------------------------
# Rule: import-time-config
# ---------------------------------------------------------------------------

class ImportTimeConfigRule:
    """Module-level env reads / file IO (configuration captured at import).

    Import-time capture freezes the value for the process regardless of
    later in-process changes, runs in an order the importer cannot see,
    and makes a module un-reimportable with different config (the
    ``DBX_OBS_JSONL`` import-time read this rule was cut from). Read
    config lazily at first use instead. ``if __name__ == "__main__"``
    blocks are runtime, not import time, and are exempt.
    """

    name = "import-time-config"
    doc = "module-level os.environ read or file IO"

    _IO_CALLS = {"open", "urlopen", "create_connection", "socket"}

    def check(self, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for pf in ctx.files:
            for node in self._import_time_nodes(pf.tree.body):
                if _is_env_read(node):
                    out.append(Finding(
                        self.name, pf.rel, node.lineno,
                        "module-level environment read: captured once at "
                        "import, frozen for the process — read it lazily "
                        "at first use"))
                elif (isinstance(node, ast.Call)
                      and _terminal_name(node.func) in self._IO_CALLS):
                    # Terminal-name match covers the attribute spellings
                    # these calls actually use (`socket.create_connection`,
                    # `urllib.request.urlopen`), not just bare `open(...)`.
                    out.append(Finding(
                        self.name, pf.rel, node.lineno,
                        f"module-level `{_terminal_name(node.func)}(...)`: "
                        "IO at import time runs before any caller can "
                        "configure or handle it"))
        return out

    @classmethod
    def _import_time_nodes(cls, body):
        """Walk statements executed at import: module body + class bodies,
        descending through If/Try/With/loops, pruning function bodies,
        lambdas, and `if __name__ == \"__main__\"` guards."""
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.ClassDef):
                yield from cls._import_time_nodes(stmt.body)
                continue
            if isinstance(stmt, ast.If) and cls._is_main_guard(stmt.test):
                continue
            stack = [stmt]
            while stack:
                node = stack.pop()
                if isinstance(node, _FUNC_NODES):
                    continue
                if isinstance(node, ast.ClassDef):
                    yield from cls._import_time_nodes(node.body)
                    continue
                yield node
                stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _is_main_guard(test: ast.AST) -> bool:
        return (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id == "__name__")


# ---------------------------------------------------------------------------
# Rule: blocking-call
# ---------------------------------------------------------------------------

class BlockingCallRule:
    """Sleeps / subprocesses / device syncs inside gRPC servicer handlers
    and the worker control loop.

    A dispatcher RPC handler runs on the shared gRPC thread pool — one
    sleeping handler steals a pool slot from every worker; the worker's
    control loop owns the liveness heartbeat — a sleep there starves
    SendStatus past the dispatcher's prune window and gets a healthy
    worker pruned mid-drain (the deferred-completion redesign exists
    because exactly that happened). Device syncs
    (``torch.cuda.synchronize``, an event's or a stream's ``synchronize``)
    and future waits
    (``.result()``) block the same way for as long as the accelerator
    (or the producing thread) takes — compute belongs on the compute
    thread, never in a handler or the heartbeat loop. File IO is
    deliberately allowed (journal/results persistence is the handlers'
    job). The poll-tick and bounded-drain sleeps are allowlisted by
    qualname below. The "while holding a lock" variant of this class is
    its own rule (``lock-blocking``, :mod:`.locks`) fed by the
    interprocedural held-lock sets.
    """

    name = "blocking-call"
    doc = "sleep/subprocess/device-sync in a servicer or the worker loop"

    # Control-plane classes scanned in addition to *Servicer subclasses.
    _CONTROL_PLANE_CLASSES = {"Worker", "SliceWorker"}

    # qualname -> why a SLEEP there is the design, not a bug. Only `sleep`
    # is exempted in these methods; any other blocking call (subprocess,
    # input, ...) added to them is still flagged.
    _ALLOW_SLEEP = {
        "Worker.run": "the poll tick itself (bounded by poll_interval_s)",
        "Worker._shutdown": "bounded exit-budget drain wait",
        "SliceWorker.run": "follower idle tick between broadcast rounds",
        "SliceWorker._leader_loop": "leader idle tick between empty polls",
    }

    # qualname -> why a bounded QUEUE/THREAD WAIT (`.get(timeout=...)`,
    # `.put(timeout=...)`, `.join(timeout=...)`) is the design there.
    # The pipeline threads exist to wait — their handoff gets
    # are the mechanism, not a stall — and the shutdown path's bounded
    # joins are the drain budget. Anywhere else in a servicer or the
    # control loop, a timeout'd wait parks the shared thread pool or the
    # heartbeat exactly like a sleep of the same length.
    _ALLOW_QUEUE_WAIT = {
        "Worker._collect_loop":
            "the pipeline handoff wait (collector thread, not the "
            "control loop)",
        "Worker._shutdown":
            "bounded joins of the prefetch + compute pipeline at exit",
    }

    _BLOCKING_TERMINAL = {"sleep", "input", "result"} | _DEVICE_SYNC
    _BLOCKING_MODULES = {"subprocess"}

    def check(self, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for pf in ctx.files:
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                servicer = any(
                    (_dotted(b) or "").split(".")[-1].endswith("Servicer")
                    for b in node.bases)
                if not servicer and (node.name
                                     not in self._CONTROL_PLANE_CLASSES):
                    continue
                for m in node.body:
                    if not isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        continue
                    out.extend(self._check_method(pf, node.name, m))
        return out

    def _check_method(self, pf: PyFile, cls: str, m) -> list[Finding]:
        out = []
        qual = f"{cls}.{m.name}"
        sleep_allowed = qual in self._ALLOW_SLEEP
        wait_allowed = qual in self._ALLOW_QUEUE_WAIT
        for node in ast.walk(m):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func) or ""
            terminal = _terminal_name(node.func)
            if terminal == "sleep" and sleep_allowed:
                continue
            is_wait = _is_timeout_wait(node, terminal)
            if is_wait and wait_allowed:
                continue
            blocking = (terminal in self._BLOCKING_TERMINAL
                        or is_wait
                        or dotted.split(".")[0] in self._BLOCKING_MODULES)
            if blocking:
                out.append(Finding(
                    self.name, pf.rel, node.lineno,
                    f"blocking call `{dotted or terminal}` inside "
                    f"`{cls}.{m.name}` (gRPC handler / worker control "
                    "loop): it stalls the shared thread pool or starves "
                    "the liveness heartbeat"))
        return out


# ---------------------------------------------------------------------------
# Rule: obs-cardinality
# ---------------------------------------------------------------------------

class ObsCardinalityRule:
    """Metric label values derived from unbounded runtime data.

    Every distinct label value is a NEW time series held forever by the
    registry, carried in every ``/metrics`` scrape, every ``/stats.json``
    snapshot, every GetStats ``obs_json`` payload and every BENCH obs
    blob. A label fed from job ids, file paths, peer addresses, trace ids
    or similar unbounded runtime data therefore grows the metric surface
    without bound over a fleet run — exactly the data that belongs in
    span/event ATTRS (the JSONL log and the span ring are per-event, not
    per-series) or in a bounded label like ``method``/``pool``/``kernel``.

    Detection is lexical + one assignment hop: a label value that is (or
    is built from — f-strings, concatenation, ``str(...)``/``format``
    wrappers) an identifier matching the unbounded-data vocabulary
    (``*_id``, ``jid``, ``path``, ``addr``, ``peer``, ``trace``,
    ``tenant`` ...), or a local name assigned from one
    (``wid = self.worker_id``). Values routed through a SANCTIONED
    bounded-map constructor (``tenant_bucket(...)`` — sched.tenancy's
    first-N-then-"other" label map) are bounded by construction and not
    flagged. Bounded exceptions that are real design decisions (e.g.
    per-worker gauges whose children are removed on worker exit) carry
    an inline suppression with the justification.
    """

    name = "obs-cardinality"
    doc = "metric label value derived from unbounded runtime data"

    _METRIC_CALLS = {"counter", "gauge", "histogram", "gauge_fn"}
    # Non-label kwargs of the registry constructors.
    _SKIP_KWARGS = {"help", "buckets", "fn"}
    # Calls whose RESULT is a bounded label by construction: the tenant
    # bucket map caps distinct values at DBX_TENANT_LABEL_MAX + "other",
    # so feeding it unbounded tenant ids is the sanctioned pattern (the
    # reason per-tenant obs can exist under this rule at all); the
    # autotuner's shape_bucket clamps (T, P) onto finite power-of-two
    # rails, so per-shape-bucket obs is bounded the same way (raw dims
    # would mint one series per shape); stream_bucket is the tenant map's
    # twin for the live fan-out tier's param-block digests
    # (DBX_STREAM_LABEL_MAX sticky prefixes + "other"); worker_bucket is
    # the fleet telemetry plane's twin for worker ids — worker-chosen
    # wire strings that churn per restart (DBX_WORKER_LABEL_MAX sticky
    # names + "other"); trigger_bucket folds flight-recorder trigger
    # kinds onto the closed _KINDS vocabulary + "other" (a total map,
    # not sticky-first-N — the catalogue is a code constant).
    _SANCTIONED_CALLS = {"tenant_bucket", "shape_bucket", "stream_bucket",
                         "worker_bucket", "trigger_bucket"}
    _UNBOUNDED = re.compile(
        r"(?:^|_)(?:id|ids|jid|uid|uuid|guid|key|token|path|paths|file|"
        r"filename|dir|addr|address|peer|host|hostname|port|url|uri|"
        r"target|trace|span|digest|digests|blake2b|checksum|hash|"
        r"tenant|tenants|stream|streams|sub|subs|subscriber|subscribers|"
        r"subscription|subscriptions|"
        # Flight-recorder incident identifiers: bundle names
        # embed content digests, triggers/incidents carry job/worker
        # subjects — all unbounded; metric labels must go through
        # trigger_bucket (or stay label-free).
        r"bundle|bundles|trigger|triggers|incident|incidents|subject|"
        r"subjects|"
        # Decision-plane record fields: candidate/actual
        # worker ids and per-decision regret are unbounded runtime data
        # (worker-chosen wire strings; a float per decision) — metric
        # labels must ride the bounded route/outcome vocabularies or
        # worker_bucket, with the raw ids in the decision record itself.
        r"candidate|candidates|worker|workers|regret)(?:$|_)")

    def check(self, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for pf in ctx.files:
            module, scopes = _build_scopes(pf.tree)
            for scope in [module] + scopes:
                assigns = self._scope_assigns(scope)
                for node in scope.own_nodes():
                    if not (isinstance(node, ast.Call)
                            and _terminal_name(node.func)
                            in self._METRIC_CALLS):
                        continue
                    for kw in node.keywords:
                        if kw.arg is None or kw.arg in self._SKIP_KWARGS:
                            # **splats are opaque here; the registry's own
                            # pass-through (`self.gauge(name, **labels)`)
                            # and dict-built label sets are judged at
                            # their construction site, not the splat.
                            continue
                        src = self._suspicious(kw.value, assigns)
                        if src is not None:
                            out.append(Finding(
                                self.name, pf.rel, node.lineno,
                                f"label `{kw.arg}` is fed from unbounded "
                                f"runtime data (`{src}`): every distinct "
                                "value becomes a permanent time series — "
                                "use a bounded label set, or carry the id "
                                "in span/event attrs instead"))
        return out

    @staticmethod
    def _scope_assigns(scope: _Scope) -> dict:
        """Simple ``name = expr`` bindings of this scope (last wins) —
        the one-hop alias map (`wid = self.worker_id`). ``own_nodes``
        yields in stack (reverse-source) order, so keep the binding with
        the greatest line number, not the last one yielded."""
        out: dict[str, ast.AST] = {}
        lines: dict[str, int] = {}
        for node in scope.own_nodes():
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) \
                            and node.lineno >= lines.get(t.id, -1):
                        lines[t.id] = node.lineno
                        out[t.id] = node.value
        return out

    @classmethod
    def _suspicious(cls, expr: ast.AST, assigns: dict,
                    depth: int = 0) -> str | None:
        """The offending identifier when ``expr`` derives from unbounded
        runtime data, else None. Constants are always clean; containers
        (f-strings, concatenation, str()/format calls) are scanned
        recursively; a bare local name follows ONE assignment hop."""
        if isinstance(expr, ast.Constant):
            return None
        if isinstance(expr, ast.Name):
            if cls._UNBOUNDED.search(expr.id):
                return expr.id
            if depth == 0 and expr.id in assigns:
                hit = cls._suspicious(assigns[expr.id], assigns, 1)
                if hit is not None:
                    return f"{expr.id} = {hit}"
            return None
        if isinstance(expr, ast.Attribute):
            if cls._UNBOUNDED.search(expr.attr):
                return _dotted(expr) or expr.attr
            return None
        if isinstance(expr, ast.JoinedStr):
            for v in expr.values:
                if isinstance(v, ast.FormattedValue):
                    hit = cls._suspicious(v.value, assigns, depth)
                    if hit is not None:
                        return hit
            return None
        if isinstance(expr, ast.BinOp):
            return (cls._suspicious(expr.left, assigns, depth)
                    or cls._suspicious(expr.right, assigns, depth))
        if isinstance(expr, ast.Call):
            # A sanctioned bounded-map constructor launders unbounded
            # input into a bounded label set — clean regardless of args.
            if _terminal_name(expr.func) in cls._SANCTIONED_CALLS:
                return None
            # str(x), "{}".format(x), "|".join(xs): judge the arguments.
            for a in list(expr.args) + [k.value for k in expr.keywords]:
                hit = cls._suspicious(a, assigns, depth)
                if hit is not None:
                    return hit
            return None
        return None


class JournalDisciplineRule:
    """Journaled-state mutation not preceded by its journal append.

    The dispatcher's recoverability contract is an ORDER: the publish
    side (enqueue records, `delta` chain links) journals FIRST, then
    mutates live state. A crash between the two merely re-enqueues a
    journaled-but-unpublished job; the reversed order opens a window
    where live state holds jobs (or chain links) no restart can restore
    — the exact loss dbxmc's `journal-append-first` invariant catches
    dynamically (analysis/modelcheck). This rule is the static half of
    that contract.

    Detection: within one function that BOTH appends a publish-side
    journal record (``*journal.append("enqueue" | "delta", ...)``) AND
    mutates journal-covered dispatcher state (``self._records[...]=``,
    ``self._delta_chain[...]=``, ``*._state.enqueue_n/register/``
    ``push_pending(...)``, ``*._sched.push(...)``), every such mutation
    must sit on a LATER line than the first append. Functions with no
    publish-side append (the replay/restore path, completion paths —
    where state legally leads the journal) are out of scope; reorderings
    that split across functions are dbxmc's job, not a lexical rule's.
    """

    name = "journal-discipline"
    doc = "journaled-state mutation precedes its journal append"

    _PUBLISH_EVENTS = {"enqueue", "delta"}
    _STATE_CALLS = {"enqueue_n", "register", "push_pending"}
    _MUTATED_MAPS = ("._records", "._delta_chain")

    def check(self, ctx: LintContext) -> list[Finding]:
        out: list[Finding] = []
        for pf in ctx.files:
            for fn in ast.walk(pf.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                append_line = self._first_publish_append(fn)
                if append_line is None:
                    continue
                for lineno, what in self._mutations(fn):
                    if lineno < append_line:
                        out.append(Finding(
                            self.name, pf.rel, lineno,
                            f"`{what}` mutates journal-covered state "
                            "BEFORE the publish-side journal append "
                            f"(line {append_line}): a crash in between "
                            "holds live jobs no restart can restore — "
                            "journal first, then publish"))
        return out

    @classmethod
    def _first_publish_append(cls, fn: ast.AST) -> int | None:
        first: int | None = None
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            dotted = _dotted(node.func) or ""
            if not dotted.endswith("journal.append"):
                continue
            ev = node.args[0]
            if (isinstance(ev, ast.Constant)
                    and ev.value in cls._PUBLISH_EVENTS
                    and (first is None or node.lineno < first)):
                first = node.lineno
        return first

    @classmethod
    def _mutations(cls, fn: ast.AST):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func) or ""
                parts = dotted.split(".")
                if (len(parts) >= 3 and parts[-2] == "_state"
                        and parts[-1] in cls._STATE_CALLS):
                    yield node.lineno, dotted
                elif dotted.endswith("._sched.push"):
                    yield node.lineno, dotted
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        base = _dotted(t.value) or ""
                        if base.endswith(cls._MUTATED_MAPS):
                            yield node.lineno, f"{base}[...] ="
