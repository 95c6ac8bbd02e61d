"""dbxcert over the port (``analysis.certify``): the port's committed
table (``numerics.torch.contract.json``) covers the reference's 59 rows in
canonical bytes, agrees with the reference's table class for class, and
the gate behaves as the reference's: substrate cross-check, drift caught
with a chain into the port, digest cones clean, exit codes 0/1/2, a
corrupt table told from a missing one, ``--update`` writing only where it
is pointed. The certifier traces once a process (``cached_rows``).
"""

import copy
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_backtesting_exploration_tpu_torch as dbxt
from distributed_backtesting_exploration_tpu_torch.analysis import (
    certify, core, lint)
from distributed_backtesting_exploration_tpu_torch.streaming import recurrent

REPO = Path(__file__).resolve().parent.parent
REF_TABLE = REPO / "numerics.contract.json"
PKG_DIR = os.path.dirname(os.path.abspath(dbxt.__file__))
ENV = "DBX_TORCH_CONTRACT_PATH"

# (row, label) -> reason, where the port's class differs from the
# reference's. Empty: every class agrees.
CLASS_EXCEPTIONS: dict = {}


def _committed() -> dict:
    table = certify.load_contract()
    assert table is not None, "numerics.torch.contract.json is committed"
    return table


# --- the table --------------------------------------------------------------

def test_committed_contract_covers_all_families_substrates_forms():
    committed = _committed()
    fams = certify.stream_families()
    assert len(fams) == 14
    expect = {certify.row_key(f, s, fo) for f in fams
              for s in certify.SUBSTRATES for fo in certify.FORMS}
    expect |= set(certify.DIGEST_KEYS)
    assert set(committed["rows"]) == expect and len(expect) == 59
    assert committed["schema"] == certify.SCHEMA
    assert set(committed) == {"schema", "rows"}
    raw = Path(certify.contract_path()).read_bytes()
    assert raw == certify.canonical_bytes(committed)


def test_live_rows_match_the_committed_table():
    committed = _committed()
    assert certify.diff_rows(committed, certify.cached_rows(),
                             full=True) == []
    assert certify.canonical_bytes(certify.table_from_rows(
        certify.cached_rows())) == Path(certify.contract_path()).read_bytes()


def test_contract_table_canonical_bytes_deterministic():
    def one_pass():
        rows = {}
        for sub in certify.SUBSTRATES:
            for form in certify.FORMS:
                r = certify.streaming_row("momentum", sub, form)
                rows[r.key] = r
        return certify.canonical_bytes(certify.table_from_rows(rows))

    assert one_pass() == one_pass()


def test_classes_agree_with_the_references_table():
    """Same row keys, same labels a row, same class a (row, label) as the
    reference's committed table (read only); boundaries are not compared
    across packages (the op sets differ)."""
    ref = json.loads(REF_TABLE.read_text())["rows"]
    port = _committed()["rows"]
    assert set(port) == set(ref)
    differ = {}
    for key in sorted(ref):
        assert set(port[key]["outputs"]) == set(ref[key]["outputs"]), key
        for label, rec in ref[key]["outputs"].items():
            mine = port[key]["outputs"][label]
            if mine["class"] != rec["class"]:
                differ[(key, label)] = (rec["class"], mine["class"])
            assert mine["dtype"] == rec["dtype"] == "float32"
            assert mine["weak"] is False
    assert set(differ) == set(CLASS_EXCEPTIONS), differ


def test_contract_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(ENV, raising=False)
    path = Path(certify.contract_path())
    assert path.name == "numerics.torch.contract.json"
    assert path.resolve() != REF_TABLE.resolve()
    assert path.parent.resolve() == REPO
    monkeypatch.setenv(ENV, str(REF_TABLE))
    with pytest.raises(ValueError, match="reference"):
        certify.contract_path()
    monkeypatch.setenv(ENV, str(tmp_path / "t.json"))
    assert certify.contract_path() == str(tmp_path / "t.json")


# --- the substrate cross-check and drift -----------------------------------

def test_selection_certified_outputs_bit_identical_across_substrates():
    """Every accumulator the table certifies at or below int-exact is
    bit-identical between the scan:8 and ladder builds on the CPU."""
    committed = _committed()
    _, _, grid, fields = recurrent._probe_inputs("bollinger")
    built = {sub: recurrent.build_carry("bollinger", fields, grid,
                                        epilogue=sub, device="cpu")
             for sub in certify.SUBSTRATES}
    row = committed["rows"][certify.row_key("bollinger", "scan:8",
                                            "build_carry")]["outputs"]
    checked = 0
    for label, rec in row.items():
        if not label.startswith("metric/") or rec["class"] not in (
                "exact", "selection", "int-exact"):
            continue
        name = label.split("/", 1)[1]
        assert torch.equal(built["scan:8"].metric[name],
                           built["ladder"].metric[name]), label
        checked += 1
    assert checked >= 3
    assert row["metric/pos_last"]["class"] == "selection"


def test_reassociated_edit_is_caught_with_a_chain_into_the_port(
        monkeypatch):
    orig = recurrent._advance_metrics

    def reassociated(metric, pos, ret, *, cost, block):
        out = orig(metric, pos, ret, cost=cost, block=block)
        # Split and remerge: a no-op in algebra, one more association
        # boundary on the moment sum's path.
        out["s1"] = (out["s1"] - metric["s1"]) + metric["s1"]
        return out

    monkeypatch.setattr(recurrent, "_advance_metrics", reassociated)
    key = certify.row_key("sma_crossover", "scan:8", "append_step")
    live = certify.streaming_row("sma_crossover", "scan:8", "append_step")
    diffs = certify.diff_rows(_committed(), {key: live})
    s1 = [d for d in diffs
          if d["output"] == "metric/s1" and d["field"] == "boundaries"]
    assert s1, diffs
    assert s1[0]["now"] == s1[0]["was"] + 1
    assert any(f.startswith("add @") for f in s1[0]["chain"])
    path, line = certify.anchor_of(s1[0]["chain"])
    assert path is not None and line > 0
    assert (Path(PKG_DIR) / path).exists()
    assert "introduced by" in s1[0]["message"]


def test_unpatched_row_matches_committed_contract():
    key = certify.row_key("sma_crossover", "scan:8", "append_step")
    live = certify.streaming_row("sma_crossover", "scan:8", "append_step")
    assert certify.diff_rows(_committed(), {key: live}) == []


# --- digest cones, rules, exit codes ----------------------------------------

def test_digest_cones_certified_deterministic():
    rows = {k: certify.cached_rows()[k] for k in certify.DIGEST_KEYS}
    for key, row in rows.items():
        assert not row.nondet, key
        assert all(rec["class"] != "nondet" for rec in row.outputs.values())
    assert all(rec["class"] == "exact" and rec["boundaries"] == 0
               for rec in rows["digest/splice"].outputs.values())


def _poisoned_row(key="digest/scenario_synth"):
    def poisoned(c):
        idx = torch.tensor([0, 1, 1, 2])
        return {"close": torch.zeros(4, dtype=torch.float32).index_add(
            0, idx, c[:4])}

    return certify.certify_callable(
        key, poisoned, [np.linspace(0.1, 2.3, 8).astype(np.float32)])


def _package_ctx():
    return core.load_context(PKG_DIR)


def test_digest_determinism_rule_flags_injected_index_add(monkeypatch):
    rows = dict(certify.cached_rows())
    rows["digest/scenario_synth"] = _poisoned_row()
    monkeypatch.setattr(certify, "cached_rows", lambda: rows)
    findings = certify.DigestDeterminismRule().check(_package_ctx())
    assert findings
    assert any("index_add" in f.message for f in findings)
    assert all(f.rule == "digest-determinism" for f in findings)


def test_weak_type_provenance_rule_reports_the_chain(monkeypatch):
    rows = dict(certify.cached_rows())
    rows["digest/splice"] = certify.certify_callable(
        "digest/splice", lambda c: {"close": torch.full(c.shape, 2.0) * c},
        [np.ones(8, np.float32)])
    monkeypatch.setattr(certify, "cached_rows", lambda: rows)
    (f,) = certify.WeakTypeProvenanceRule().check(_package_ctx())
    assert f.rule == "weak-type-provenance"
    assert "test_torch_certify.py" in f.message
    assert "default dtype" in f.message


def test_run_certify_exit_codes(monkeypatch, tmp_path):
    clean = certify.run_certify()
    assert certify.exit_code(clean) == 0
    assert clean["rows"] == 59

    doctored = copy.deepcopy(_committed())
    key = certify.row_key("sma_crossover", "scan:8", "append_step")
    doctored["rows"][key]["outputs"]["metric/s1"]["boundaries"] += 1
    p = tmp_path / "doctored.json"
    p.write_bytes(certify.canonical_bytes(doctored))
    monkeypatch.setenv(ENV, str(p))
    drifted = certify.run_certify()
    assert certify.exit_code(drifted) == 2
    assert any(d["rule"] == "substrate-contract" for d in drifted["drift"])

    rows = dict(certify.cached_rows())
    rows["digest/scenario_synth"] = _poisoned_row()
    monkeypatch.setattr(certify, "cached_rows", lambda: rows)
    match = tmp_path / "match.json"
    match.write_bytes(certify.canonical_bytes(certify.table_from_rows(rows)))
    monkeypatch.setenv(ENV, str(match))
    poisoned = certify.run_certify()
    assert certify.exit_code(poisoned) == 1
    assert poisoned["findings"] and not poisoned["drift"]


def test_corrupt_contract_table_is_not_missing(monkeypatch, tmp_path):
    p = tmp_path / "corrupt.json"
    p.write_bytes(b'{"schema": 1, "rows": {')
    monkeypatch.setenv(ENV, str(p))
    with pytest.raises(ValueError):
        certify.load_contract()
    res = certify.run_certify()
    assert certify.exit_code(res) == 2
    assert any("unparseable" in d["message"] for d in res["drift"])
    assert not any("no committed" in d["message"] for d in res["drift"])
    monkeypatch.setenv(ENV, str(tmp_path / "absent.json"))
    assert certify.load_contract() is None
    res = certify.run_certify()
    assert certify.exit_code(res) == 2
    assert any("no committed numerics contract" in d["message"]
               for d in res["drift"])


def test_update_writes_only_where_pointed(monkeypatch, tmp_path):
    committed = Path(certify.contract_path())
    before = committed.read_bytes(), committed.stat().st_mtime_ns
    ref_before = REF_TABLE.read_bytes(), REF_TABLE.stat().st_mtime_ns
    p = tmp_path / "regen.json"
    monkeypatch.setenv(ENV, str(p))
    res = certify.run_certify(update=True)
    assert certify.exit_code(res) == 0 and res["updated"]
    assert p.read_bytes() == before[0]
    assert (committed.read_bytes(), committed.stat().st_mtime_ns) == before
    assert (REF_TABLE.read_bytes(),
            REF_TABLE.stat().st_mtime_ns) == ref_before


def test_certify_rules_skipped_outside_package():
    fixtures = os.path.join(os.path.dirname(__file__), "fixtures",
                            "torch_lint")
    result = lint.run([fixtures], core.all_rules())
    for rule in ("substrate-contract", "weak-type-provenance",
                 "digest-determinism", "kernel-hygiene"):
        assert rule in result["rules_skipped"]
        assert rule not in result["rules"]


def test_cli_certify_json_shape(capsys):
    rc = certify.main(["--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert set(out) == {"contract", "rows", "updated", "drift", "findings",
                        "suppressed"}
    assert out["rows"] == 59
    assert out["drift"] == [] and out["findings"] == []
    assert out["contract"].endswith("numerics.torch.contract.json")
    assert lint.main(["--certify", "--format", "json"]) == 0
    again = json.loads(capsys.readouterr().out)
    assert again == out
