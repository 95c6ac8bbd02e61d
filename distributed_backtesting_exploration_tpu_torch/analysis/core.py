"""dbxlint engine: findings, the rule registry, suppressions, file loading.

A *rule* is a plain object with ``name``, ``doc`` and
``check(ctx) -> list[Finding]``. Rules are registered in ``all_rules()``
(import-cycle-free: the rule modules import this one, not vice versa at
import time). The engine is deliberately dependency-free — stdlib ``ast``
alone, plus, for the traced-program layer only, torch inside the rules
that run programs. It is the reference's ``analysis/core.py`` aimed at
this package.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import tokenize

PACKAGE_NAME = "distributed_backtesting_exploration_tpu_torch"

# Inline suppression directive: `# dbxlint: disable=<rule>[,<rule>...]`,
# placed on the finding's line or on a comment line directly above it.
# Policy (enforced by review, not the engine): always follow the directive
# with `-- <justification>`.
_DIRECTIVE = "dbxlint: disable="


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a file:line."""

    rule: str
    path: str       # relative to the linted root
    line: int       # 1-indexed
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class PyFile:
    """A parsed Python source file (shared by every AST rule)."""

    path: str       # absolute
    rel: str        # relative to the linted root
    source: str
    tree: ast.Module

    @property
    def lines(self) -> list[str]:
        return self.source.splitlines()


@dataclasses.dataclass
class LintContext:
    """Everything a rule may look at for one lint invocation."""

    root: str                 # absolute root (dir or single file)
    files: list[PyFile]
    package: bool = False     # True when root IS the dbx package itself
    skipped: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    # Filled by lint_path: rule names that ran vs. were not applicable to
    # this root (e.g. kernel-hygiene outside the package) — "skipped" must
    # never masquerade as "clean".
    rules_ran: list[str] = dataclasses.field(default_factory=list)
    rules_skipped: list[str] = dataclasses.field(default_factory=list)


def _iter_py_files(root: str):
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__" and not d.startswith("."))
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def load_context(root: str) -> LintContext:
    """Parse every ``.py`` under ``root`` (unparseable files are recorded
    in ``ctx.skipped``, never silently dropped — a syntax error in a lint
    target is itself a finding-worthy event the CLI surfaces)."""
    root = os.path.abspath(root)
    base = os.path.dirname(root) if os.path.isfile(root) else root
    ctx = LintContext(root=root, files=[],
                      package=os.path.basename(root) == PACKAGE_NAME)
    for path in _iter_py_files(root):
        try:
            with tokenize.open(path) as fh:   # honors coding cookies
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            ctx.skipped.append((os.path.relpath(path, base), str(e)))
            continue
        ctx.files.append(PyFile(path=path, rel=os.path.relpath(path, base),
                                source=source, tree=tree))
    return ctx


def _suppressed_rules(comment_text: str) -> set[str]:
    """Rule names named by a directive in ``comment_text`` (empty = none).

    Grammar: ``disable=<rule>[, <rule>...] [-- justification]`` — spaces
    after commas are fine; the ``--`` (or the first non-rule word) ends
    the list, so prose never suppresses by accident."""
    pos = comment_text.find(_DIRECTIVE)
    if pos < 0:
        return set()
    spec = comment_text[pos + len(_DIRECTIVE):].split("--", 1)[0]
    rules: set[str] = set()
    for part in spec.split(","):
        tokens = part.strip().split()
        if not tokens:
            break
        rules.add(tokens[0])
        if len(tokens) > 1:      # prose after a rule name: list is over
            break
    return rules


def _py_comments(source: str) -> dict[int, str] | None:
    """1-indexed line -> COMMENT token text, via the real tokenizer — a
    directive inside a string literal must never count (None = untokenizable,
    caller falls back to the line-tail heuristic)."""
    import io

    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return None
    return out


def _line_tail_comment(line: str) -> str:
    """Comment tail of a non-Python line (``# ...`` or proto ``// ...``);
    best-effort — non-Python sources have no tokenizer here."""
    for marker in ("#", "//"):
        pos = line.find(marker)
        if pos >= 0:
            return line[pos:]
    return ""


def apply_suppressions(findings: list[Finding], root: str,
                       ctx: "LintContext | None" = None
                       ) -> tuple[list[Finding], int]:
    """Drop findings suppressed by an inline directive in a COMMENT on the
    finding's line or on a comment-only line directly above. Returns
    ``(kept, n_suppressed)``. Python sources come from ``ctx`` (already in
    memory, decoded once by the tokenizer-aware loader) and are scanned at
    the token level; other files (``.proto``) fall back to a line-tail
    scan."""
    root = os.path.abspath(root)
    base = os.path.dirname(root) if os.path.isfile(root) else root
    by_rel = {pf.rel: pf for pf in (ctx.files if ctx is not None else [])}
    line_cache: dict[str, list[str]] = {}
    comment_cache: dict[str, dict[int, str] | None] = {}
    kept: list[Finding] = []
    suppressed = 0

    def load_lines(path: str, rel: str) -> list[str]:
        lines = line_cache.get(path)
        if lines is None:
            pf = by_rel.get(rel)
            if pf is not None:
                lines = pf.lines
            else:
                try:
                    with open(path, encoding="utf-8",
                              errors="replace") as fh:
                        lines = fh.read().splitlines()
                except OSError:
                    lines = []
            line_cache[path] = lines
        return lines

    def comment_at(path: str, rel: str, lines: list[str], lineno: int) -> str:
        if not (0 < lineno <= len(lines)):
            return ""
        if rel.endswith(".py"):
            comments = comment_cache.get(path, False)
            if comments is False:
                pf = by_rel.get(rel)
                source = pf.source if pf is not None else "\n".join(lines)
                comments = _py_comments(source)
                comment_cache[path] = comments
            if comments is not None:
                return comments.get(lineno, "")
            # untokenizable: fall through to the heuristic
        return _line_tail_comment(lines[lineno - 1])

    for f in findings:
        path = os.path.join(base, f.path)
        lines = load_lines(path, f.path)
        rules = set(_suppressed_rules(comment_at(path, f.path, lines,
                                                 f.line)))
        above = lines[f.line - 2] if 2 <= f.line <= len(lines) + 1 else ""
        if above.lstrip().startswith(("#", "//")):
            rules |= _suppressed_rules(comment_at(path, f.path, lines,
                                                  f.line - 1))
        if f.rule in rules or "all" in rules:
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


def all_rules() -> list:
    """The registered rule set, in catalogue order."""
    from . import ast_rules, certify, fx_rules, locks, proto_rules

    return [
        ast_rules.TraceTimeEnvRule(),
        locks.LockDisciplineRule(),
        locks.LockOrderRule(),
        locks.AtomicityRule(),
        locks.LockBlockingRule(),
        ast_rules.ImportTimeConfigRule(),
        ast_rules.BlockingCallRule(),
        ast_rules.ObsCardinalityRule(),
        ast_rules.JournalDisciplineRule(),
        fx_rules.KernelHygieneRule(),
        certify.SubstrateContractRule(),
        certify.WeakTypeProvenanceRule(),
        certify.DigestDeterminismRule(),
        proto_rules.ProtoDriftRule(),
    ]


def lint_path(root: str, rules=None) -> tuple[list[Finding], int, LintContext]:
    """Run ``rules`` (default: all) over ``root``. Returns
    ``(findings, n_suppressed, ctx)`` with findings sorted by location;
    ``ctx.rules_ran``/``ctx.rules_skipped`` record applicability (a rule
    whose ``applicable(ctx)`` is False is skipped and reported as such)."""
    ctx = load_context(root)
    findings: list[Finding] = []
    for rule in (rules if rules is not None else all_rules()):
        if not getattr(rule, "applicable", lambda _ctx: True)(ctx):
            ctx.rules_skipped.append(rule.name)
            continue
        ctx.rules_ran.append(rule.name)
        findings.extend(rule.check(ctx))
    findings, suppressed = apply_suppressions(findings, root, ctx)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed, ctx
