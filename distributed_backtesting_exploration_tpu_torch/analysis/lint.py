"""dbxlint CLI:
``python -m distributed_backtesting_exploration_tpu_torch.analysis.lint``.

Runs the registered rule set over the package (default) or over explicit
paths, prints findings as text or JSON, and exits non-zero when any
finding survives suppression — ``tests/test_torch_lint_clean.py`` drives
this entry point. The reference's ``--certify`` and ``--update-contract``
(the numerics certifier, which walks jaxprs) have no port yet and are
left out, and so are its jaxpr and certifier rules (``--list-rules``
names them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import core

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's rules that have no port: the jaxpr layer and the
# numerics certifier.
NOT_PORTED = ("kernel-hygiene", "substrate-contract", "weak-type-provenance",
              "digest-determinism")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dbxlint",
        description="static analysis for the dbx codebase "
                    "(AST, lock and proto layers)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: the "
                         "installed "
                         "distributed_backtesting_exploration_tpu_torch "
                         "package)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format (json is the CI-artifact form)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule names to run "
                         "(default: all; see --list-rules)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    return ap


def _select_rules(spec: str | None):
    rules = core.all_rules()
    if spec is None:
        return rules
    wanted = {r.strip() for r in spec.split(",") if r.strip()}
    known = {r.name for r in rules}
    unknown = wanted - known
    if unknown:
        raise SystemExit(
            f"unknown rule(s): {', '.join(sorted(unknown))}; "
            f"known: {', '.join(sorted(known))}")
    return [r for r in rules if r.name in wanted]


def run(paths, rules) -> dict:
    """Lint ``paths`` with ``rules``; returns the JSON-able result dict.

    ``rules`` lists only rules that actually RAN on at least one path;
    ``rules_skipped`` names the rest (e.g. proto-drift on a single file)
    — a skipped rule must never read as clean coverage."""
    all_findings: list[core.Finding] = []
    suppressed = 0
    skipped: list = []
    ran: set = set()
    for path in paths:
        findings, n_sup, ctx = core.lint_path(path, rules)
        all_findings.extend(findings)
        suppressed += n_sup
        skipped.extend(ctx.skipped)
        ran |= set(ctx.rules_ran)
    return {
        "clean": not all_findings and not skipped,
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message}
            for f in all_findings],
        "suppressed": suppressed,
        "unparseable": [{"path": p, "error": e} for p, e in skipped],
        "rules": [r.name for r in rules if r.name in ran],
        "rules_skipped": [r.name for r in rules if r.name not in ran],
    }


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    rules = _select_rules(args.rules)
    if args.list_rules:
        for r in rules:
            print(f"{r.name:20s} {r.doc}")
        print(f"not ported (they walk jaxprs): {', '.join(NOT_PORTED)}; "
              "--certify and --update-contract with them")
        return 0
    paths = args.paths or [_PACKAGE_DIR]
    result = run(paths, rules)
    if args.format == "json":
        print(json.dumps(result, indent=2))
    else:
        for f in result["findings"]:
            print(f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}")
        for s in result["unparseable"]:
            print(f"{s['path']}:1: [engine] unparseable: {s['error']}")
        n = len(result["findings"])
        tail = (f"{n} finding(s)" if n else "clean")
        if result["suppressed"]:
            tail += f" ({result['suppressed']} suppressed)"
        line = f"dbxlint: {tail} [rules: {', '.join(result['rules'])}]"
        if result["rules_skipped"]:
            line += (f" [skipped (not applicable here): "
                     f"{', '.join(result['rules_skipped'])}]")
        print(line)
    return 0 if result["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
