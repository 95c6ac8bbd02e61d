"""dbxcert over the port: the numerics certifier, the port of the
reference's ``analysis/certify.py``.

The repo's numerics contracts ("selection-only => bit-identical across
substrates", "one association boundary", "f32 sums of exact small ints
merge bit-exactly", "scenario digests are pure functions of the spec")
are machine-checked here, the proto-drift pattern applied to numerics:

1. **Trace** every certified cone (:func:`.dataflow.trace`): all
   registered streaming families x epilogue substrates (``scan:8`` /
   ``ladder``) x both streaming forms (``build_carry`` / ``append_step``,
   the scan-form/recurrent-form pair that must not drift), plus the
   digest cones (scenario synthesis, the fused scenario route, the wire
   splice): 59 rows, the reference's row keys.
2. **Analyze** each trace (:func:`.dataflow.analyze`): every labeled
   output gets a provenance class (exact / selection / int-exact /
   float-accum / nondet), an association-boundary census and weak-type
   provenance.
3. **Pin** the result as a canonical table (sorted keys, no timestamps),
   committed as ``numerics.torch.contract.json`` at the repo root, and
   **diff** it: an edit that silently adds an association boundary, drops
   a selection-only guarantee or brings a nondet op onto a digest path
   fails the gate with the introducing op chain. The reference's own
   table (``numerics.contract.json``) is never read or written here: the
   port pins its own, and ``tests/test_torch_certify.py`` holds its
   classes to the reference's.

**Why certifying the plain versions is enough.** The streaming cones and
the digest cones are torch ops, so the trace sees all of them. Where a
cone reaches a ``dbx_*`` kernel (the fused scenario route reaches K1),
the trace on the CPU runs and sees the kernel's plain version, and
``chip_smoke.py``'s kernel phase holds the kernel to that plain version
on the card, on the same inputs: K1's every metric bit-equal, as every
tile entry's. A class proved of the plain version therefore holds of the
kernel's output.

Ships as three dbxlint rules on the shared engine:

- ``substrate-contract``: live classes/census vs the committed table (any
  mismatch, missing row or new row is a drift finding);
- ``weak-type-provenance``: outputs on certified cones whose dtype
  follows torch's default dtype, with the introducing op chain;
- ``digest-determinism``: no nondet op or class on a digest cone; the
  splice cone must stay pure data movement (*exact*, zero census);

and the ``dbxcert`` CLI / ``dbxlint --certify`` mode (exit 0 clean, 1
findings, 2 contract drift; ``--update`` regenerates the table).
Suppressions use the inline dbxlint directive at the finding's anchor
line (the chain's introducing op).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

from . import dataflow
from .core import Finding, LintContext

CONTRACT_BASENAME = "numerics.torch.contract.json"
# The reference package's committed table, beside this one: never this
# module's.
REFERENCE_BASENAME = "numerics.contract.json"
SCHEMA = 1
# "scan:8" pins the production multi-block equity carry; "ladder" is the
# one-block substrate: the pair kernel-hygiene runs.
SUBSTRATES = ("scan:8", "ladder")
FORMS = ("build_carry", "append_step")
DIGEST_KEYS = ("digest/scenario_synth", "digest/scenario_fused",
               "digest/splice")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)


def contract_path() -> str:
    """The port's committed contract table: ``DBX_TORCH_CONTRACT_PATH``
    where set, else ``numerics.torch.contract.json`` at the repo root
    (the package directory's parent). Never the reference's table: an
    override naming it raises ``ValueError``."""
    override = os.environ.get("DBX_TORCH_CONTRACT_PATH")
    if not override:
        return os.path.join(_REPO_ROOT, CONTRACT_BASENAME)
    if os.path.abspath(override) == os.path.join(_REPO_ROOT,
                                                 REFERENCE_BASENAME):
        raise ValueError(
            f"DBX_TORCH_CONTRACT_PATH={override!r} names the reference "
            "package's contract table; the port pins its own")
    return override


def row_key(family: str, substrate: str, form: str) -> str:
    return f"{family}@{substrate}#{form}"


@dataclasses.dataclass
class RowResult:
    """One certified cone: the contract-table row plus the reporting
    detail (lattice values with chains) that never enters the canonical
    bytes: chains carry file:line and would churn the table."""

    key: str
    outputs: dict        # label -> {"class","boundaries","dtype","weak"}
    vals: dict           # label -> dataflow.AbsVal
    nondet: list         # [(op, frame)]
    wall_s: float = 0.0


def certify_callable(key: str, fn, args, integral_keys=frozenset()
                     ) -> RowResult:
    """Trace ``fn(*args)`` on the CPU and classify every labeled output.
    ``fn`` returns a dict (stable labels for the table);
    ``integral_keys`` names input-dict keys the analyzer may assume
    integer-valued."""
    t0 = time.perf_counter()
    prog = dataflow.trace(fn, *args)
    labels = ["/".join(path) for path in prog.out_paths]
    integral_inputs = [bool(path) and path[-1] in integral_keys
                       for path in prog.in_paths]
    an = dataflow.analyze(prog, integral_inputs=integral_inputs)
    outputs = {}
    vals = {}
    for label, v in zip(labels, an.out_vals):
        outputs[label] = {"class": v.class_name,
                          "boundaries": v.boundaries,
                          "dtype": v.dtype, "weak": bool(v.weak)}
        vals[label] = v
    return RowResult(key=key, outputs=outputs, vals=vals,
                     nondet=list(an.nondet_sites),
                     wall_s=time.perf_counter() - t0)


def stream_families() -> list:
    from ..streaming import recurrent

    return sorted(recurrent._STREAM_FAMILIES)


def streaming_row(family: str, substrate: str, form: str) -> RowResult:
    from ..streaming import recurrent

    fn, args, integral_keys = recurrent.certify_probe(
        family, form=form, epilogue=substrate)
    return certify_callable(row_key(family, substrate, form), fn, args,
                            integral_keys)


def digest_rows() -> list:
    from ..ops import fused
    from ..scenarios import synth
    from ..utils import data as data_mod

    rows = []
    for key, probe in (("digest/scenario_synth", synth.certify_probe),
                       ("digest/scenario_fused",
                        fused.scenario_certify_probe),
                       ("digest/splice", data_mod.splice_cone_probe)):
        fn, args, integral_keys = probe()
        rows.append(certify_callable(key, fn, args, integral_keys))
    return rows


def timed_rows(families=None) -> tuple:
    """``(rows, walls)``: every certified row plus per-family certifier
    wall seconds (probe build + trace + analysis: the bench's
    ``certify_wall_s``). ``families=None`` is the full registry; the
    digest cones always run, timed under ``"digest"``."""
    rows = {}
    walls = {}
    for family in (families if families is not None
                   else stream_families()):
        t0 = time.perf_counter()
        for substrate in SUBSTRATES:
            for form in FORMS:
                r = streaming_row(family, substrate, form)
                rows[r.key] = r
        walls[family] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in digest_rows():
        rows[r.key] = r
    walls["digest"] = time.perf_counter() - t0
    return rows, walls


def build_rows(families=None) -> dict:
    return timed_rows(families)[0]


_CACHE: dict = {}


def cached_rows() -> dict:
    """The full certified row set, computed once a process: the three
    certify rules, the gate and the CLI share one trace pass."""
    if "rows" not in _CACHE:
        _CACHE["rows"] = build_rows()
    return _CACHE["rows"]


def clear_cache() -> None:
    _CACHE.clear()


# ---------------------------------------------------------------------------
# Canonical table + drift diff
# ---------------------------------------------------------------------------

def table_from_rows(rows: dict) -> dict:
    return {"schema": SCHEMA,
            "rows": {k: {"outputs": rows[k].outputs}
                     for k in sorted(rows)}}


def canonical_bytes(table: dict) -> bytes:
    """THE byte form of the committed table: sorted keys, fixed
    separators, trailing newline, no timestamps; identical traces give
    identical bytes across runs and processes."""
    return (json.dumps(table, sort_keys=True, indent=1,
                       separators=(",", ": ")) + "\n").encode()


def load_contract(path: str | None = None) -> dict | None:
    """Committed table, or ``None`` when MISSING. An unreadable or corrupt
    table raises ``ValueError``: it must never be taken for a missing one,
    or the "run --update" advice would overwrite the only record of what
    was pinned, silently re-baselining real drift."""
    path = path or contract_path()
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except FileNotFoundError:
        return None
    except OSError as e:     # exists but unreadable (perms, a directory)
        raise ValueError(f"{path}: {e}") from None
    try:
        return json.loads(raw.decode("utf-8"))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _fmt_chain(chain: tuple) -> str:
    return " -> ".join(chain) if chain else "(no chain recorded)"


_FRAME_RE = re.compile(r"@ (.+?):(\d+)")


def anchor_of(chain: tuple) -> tuple:
    """``(relpath, line)`` of the chain's introducing op when it points
    inside the package; ``(None, 0)`` otherwise. Findings anchor here so
    the inline suppression directive applies at the op that introduced
    the property."""
    for frame in chain:
        m = _FRAME_RE.search(frame)
        if not m:
            continue
        path, line = m.group(1), int(m.group(2))
        if os.path.isabs(path) and path.startswith(_PKG_DIR + os.sep):
            return os.path.relpath(path, _PKG_DIR), line
    return None, 0


def diff_rows(committed: dict, rows: dict, *, full: bool = False) -> list:
    """Structural diff of live ``rows`` against the ``committed`` table.
    Each entry: row key, output label, field, was/now, and (for
    escalations) the live introducing op chain. ``full`` also reports
    committed rows the live trace no longer produces and live rows the
    table does not pin."""
    out = []
    pinned = committed.get("rows", {})
    for key in sorted(rows):
        live = rows[key]
        if key not in pinned:
            out.append({"row": key, "output": None, "field": "row",
                        "was": None, "now": "present", "chain": (),
                        "message": f"row `{key}` is not pinned by the "
                                   f"committed contract table"})
            continue
        want = pinned[key].get("outputs", {})
        for label in sorted(set(want) | set(live.outputs)):
            if label not in live.outputs:
                out.append({"row": key, "output": label,
                            "field": "output", "was": "present",
                            "now": None, "chain": (),
                            "message": f"{key}: output `{label}` pinned "
                                       f"by the contract is gone"})
                continue
            now = live.outputs[label]
            if label not in want:
                out.append({"row": key, "output": label,
                            "field": "output", "was": None,
                            "now": "present",
                            "chain": live.vals[label].chain,
                            "message": f"{key}: output `{label}` is not "
                                       f"pinned by the contract"})
                continue
            pin = want[label]
            for field in ("class", "boundaries", "dtype", "weak"):
                if pin.get(field) != now.get(field):
                    v = live.vals[label]
                    chain = (v.weak_chain if field == "weak"
                             else v.chain)
                    out.append({
                        "row": key, "output": label, "field": field,
                        "was": pin.get(field), "now": now.get(field),
                        "chain": chain,
                        "message": (
                            f"{key}: output `{label}` {field} "
                            f"{pin.get(field)!r} -> {now.get(field)!r}"
                            f" — introduced by: {_fmt_chain(chain)}")})
    if full:
        for key in sorted(set(pinned) - set(rows)):
            out.append({"row": key, "output": None, "field": "row",
                        "was": "present", "now": None, "chain": (),
                        "message": f"committed contract row `{key}` is "
                                   f"no longer produced by the certifier"})
    return out


# ---------------------------------------------------------------------------
# The three dbxlint rules (shared engine, shared trace pass)
# ---------------------------------------------------------------------------

class _CertifyRule:
    def applicable(self, ctx: LintContext) -> bool:
        # Like kernel-hygiene: the certified registries belong to the
        # installed package; an arbitrary lint target has none, and the
        # engine reports the rule as skipped rather than silently clean.
        return ctx.package

    def _anchored(self, rule: str, chain: tuple, message: str,
                  ctx: LintContext) -> Finding:
        path, line = anchor_of(chain)
        if path is None:
            path = os.path.relpath(contract_path(), ctx.root)
            line = 1
        return Finding(rule, path, line, message)


class SubstrateContractRule(_CertifyRule):
    """Diff the live certified classes/census against the committed
    ``numerics.torch.contract.json``: the proto-drift pattern for
    numerics."""

    name = "substrate-contract"
    doc = ("certified provenance classes + association-boundary census "
           "vs the committed numerics.torch.contract.json")

    def check(self, ctx: LintContext) -> list:
        if not self.applicable(ctx):
            return []
        rel = os.path.relpath(contract_path(), ctx.root)
        try:
            committed = load_contract()
        except ValueError as e:
            return [Finding(self.name, rel, 1,
                            f"committed numerics contract table is "
                            f"unparseable ({e}) — restore it from git "
                            "history before touching `--update` (a "
                            "regenerate would silently re-baseline any "
                            "real drift)")]
        if committed is None:
            return [Finding(self.name, rel, 1,
                            "no committed numerics contract table at "
                            f"{contract_path()} — run `dbxcert --update` "
                            "(or `dbxlint --certify --update-contract`) "
                            "and commit the result")]
        return [self._anchored(self.name, d["chain"], d["message"], ctx)
                for d in diff_rows(committed, cached_rows(), full=True)]


class WeakTypeProvenanceRule(_CertifyRule):
    """Outputs on certified cones whose dtype follows torch's default
    dtype, with the introducing op chain."""

    name = "weak-type-provenance"
    doc = ("default-dtype-dependent outputs on certified cones, reported "
           "with the introducing op chain")

    def check(self, ctx: LintContext) -> list:
        if not self.applicable(ctx):
            return []
        findings = []
        rows = cached_rows()
        for key in sorted(rows):
            row = rows[key]
            for label in sorted(row.outputs):
                if not row.outputs[label]["weak"]:
                    continue
                v = row.vals[label]
                findings.append(self._anchored(
                    self.name, v.weak_chain,
                    f"{key}: output `{label}` follows torch's default "
                    f"dtype — introduced by: {_fmt_chain(v.weak_chain)}; "
                    f"give the tensor an explicit dtype", ctx))
        return findings


class DigestDeterminismRule(_CertifyRule):
    """Digest-relevant cones must stay deterministic: no nondet op or class
    anywhere, and the wire-splice cone must remain pure data movement
    (class *exact*, zero boundary census): the property that makes
    replayed chains reproduce the digests the first run stamped."""

    name = "digest-determinism"
    doc = ("nondet ops/classes on digest-relevant cones; splice must stay "
           "pure data movement")

    def check(self, ctx: LintContext) -> list:
        if not self.applicable(ctx):
            return []
        findings = []
        rows = cached_rows()
        for key in DIGEST_KEYS:
            row = rows.get(key)
            if row is None:
                findings.append(self._anchored(
                    self.name, (),
                    f"digest cone `{key}` was not certified — its probe "
                    f"failed to build or is unregistered", ctx))
                continue
            for op, frame in row.nondet:
                findings.append(self._anchored(
                    self.name, (frame,),
                    f"{key}: nondeterministic op `{op}` on a digest path "
                    f"({frame}) — content addresses would stop being "
                    f"pure functions of the spec", ctx))
            for label in sorted(row.outputs):
                rec = row.outputs[label]
                v = row.vals[label]
                if rec["class"] == "nondet":
                    findings.append(self._anchored(
                        self.name, v.chain,
                        f"{key}: output `{label}` is nondet-class — "
                        f"introduced by: {_fmt_chain(v.chain)}", ctx))
                elif key == "digest/splice" and (
                        rec["class"] != "exact" or rec["boundaries"]):
                    findings.append(self._anchored(
                        self.name, v.chain,
                        f"{key}: output `{label}` is "
                        f"{rec['class']}/{rec['boundaries']} boundaries "
                        f"— the splice must stay pure data movement "
                        f"(introduced by: {_fmt_chain(v.chain)})", ctx))
        return findings


def certify_rules() -> list:
    return [SubstrateContractRule(), WeakTypeProvenanceRule(),
            DigestDeterminismRule()]


# ---------------------------------------------------------------------------
# CLI (`dbxcert`, also `dbxlint --certify`)
# ---------------------------------------------------------------------------

def run_certify(*, update: bool = False) -> dict:
    """Run the certifier over the package: regenerate the table (written
    to :func:`contract_path` when ``update``), run the three certify rules
    with the standard suppressions, split drift (substrate-contract) from
    semantic findings. Exit-code contract: 0 clean / 1 findings / 2 table
    drift."""
    from . import core

    if update:
        data = canonical_bytes(table_from_rows(cached_rows()))
        with open(contract_path(), "wb") as fh:
            fh.write(data)
    findings, suppressed, _ctx = core.lint_path(_PKG_DIR, certify_rules())
    drift = [f for f in findings if f.rule == SubstrateContractRule.name]
    other = [f for f in findings if f.rule != SubstrateContractRule.name]
    return {
        "contract": contract_path(),
        "rows": len(cached_rows()),
        "updated": bool(update),
        "drift": [dataclasses.asdict(f) for f in drift],
        "findings": [dataclasses.asdict(f) for f in other],
        "suppressed": suppressed,
    }


def exit_code(result: dict) -> int:
    if result["drift"]:
        return 2
    if result["findings"]:
        return 1
    return 0


def render_text(result: dict, *, prog: str = "dbxcert") -> None:
    """THE text rendering of a ``run_certify`` result, shared by
    ``dbxcert`` and ``dbxlint --certify`` so that the two entry points to
    the same machinery cannot drift apart."""
    for f in result["drift"] + result["findings"]:
        print(f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}")
    state = ("drift" if result["drift"]
             else "findings" if result["findings"] else "clean")
    tail = f" ({result['suppressed']} suppressed)" \
        if result["suppressed"] else ""
    print(f"{prog}: {state} — {result['rows']} certified rows vs "
          f"{result['contract']}"
          f"{' (updated)' if result['updated'] else ''}{tail}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dbxcert",
        description="numerics certifier over traced torch programs: "
                    "machine-checked bit-exactness contracts, weak-type "
                    "provenance, and digest-determinism audit (exit 0 "
                    "clean / 1 findings / 2 contract drift)")
    ap.add_argument("--update", "-u", action="store_true",
                    help="regenerate numerics.torch.contract.json from the "
                         "live trace (then commit it)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)
    result = run_certify(update=args.update)
    if args.format == "json":
        print(json.dumps(result, indent=2))
    else:
        render_text(result)
    return exit_code(result)


if __name__ == "__main__":
    sys.exit(main())
