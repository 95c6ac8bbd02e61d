"""dbxlint CLI:
``python -m distributed_backtesting_exploration_tpu_torch.analysis.lint``.

Runs the registered rule set over the package (default) or over explicit
paths, prints findings as text or JSON, and exits non-zero when any
finding survives suppression — ``tests/test_torch_lint_clean.py`` drives
this entry point. ``--certify`` runs the numerics certifier alone
(:mod:`.certify`; ``--update-contract`` rewrites the port's table).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import core

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dbxlint",
        description="static analysis for the dbx codebase "
                    "(AST, lock, traced-program and proto layers)")
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
    ap.add_argument("--certify", action="store_true",
                    help="run the numerics certifier only (analysis."
                         "certify): exit 0 clean / 1 findings / 2 "
                         "contract drift")
    ap.add_argument("--update-contract", action="store_true",
                    help="with --certify: regenerate and write "
                         "numerics.torch.contract.json from the live trace")
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
    ``rules_skipped`` names the rest (e.g. kernel-hygiene outside the
    package) — a skipped rule must never read as clean coverage."""
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
    if args.certify:
        from . import certify

        # The certifier traces the installed package's registries; path
        # and rule selectors don't apply — reject them loudly rather
        # than silently running the full certifier anyway.
        if args.paths or args.rules or args.list_rules:
            raise SystemExit(
                "dbxlint --certify runs the whole certified registry of "
                "the installed package: positional paths, --rules and "
                "--list-rules do not apply (use plain dbxlint for "
                "scoped lint runs)")
        result = certify.run_certify(update=args.update_contract)
        if args.format == "json":
            print(json.dumps(result, indent=2))
        else:
            certify.render_text(result, prog="dbxlint --certify")
        return certify.exit_code(result)
    rules = _select_rules(args.rules)
    if args.list_rules:
        for r in rules:
            print(f"{r.name:20s} {r.doc}")
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
