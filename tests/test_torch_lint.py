"""dbxlint's port against the reference's, rule by rule, on the reference's
seeded fixtures (``tests/fixtures/lint/``, read as they are) and on the
port's own (``tests/fixtures/torch_lint/``).

Every package-neutral rule (the lock layer, import-time-config,
blocking-call, obs-cardinality, journal-discipline, proto-drift) gives
the same findings (rule, file, line, message) and the same suppression
count in both packages. The named differences:

- the device-sync vocabulary: the reference's is ``jax.block_until_ready``
  and ``jax.device_get``, the port's the card's waits (``synchronize`` of
  ``torch.cuda``, an event or a stream), so the two lines of
  ``blocking_call.py`` that seed ``jax.block_until_ready`` are flagged by
  the reference alone, and the port's fixtures by the port alone;
- ``trace-time-env``: the reference's roots are jit/pallas entry points,
  the port's the launch boundary (a kernel's build, load or launch), so
  each flags only its own fixture.

The reference's ``test_kernel_hygiene_flags_float64_leak`` and the other
jaxpr rules have no counterpart: the port has no jaxpr layer.
"""

import json
import os

import pytest

from distributed_backtesting_exploration_tpu.analysis import (
    ast_rules as ref_ast_rules, core as ref_core, locks as ref_locks,
    proto_rules as ref_proto_rules)
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb2)
from distributed_backtesting_exploration_tpu_torch.analysis import (
    ast_rules, core, lint as lint_cli, locks, proto_rules)
from distributed_backtesting_exploration_tpu_torch.rpc import backtesting_pb2

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "lint")
PORT_FIXTURES = os.path.join(HERE, "fixtures", "torch_lint")

NEUTRAL = ("lock-discipline", "lock-order", "atomicity", "lock-blocking",
           "import-time-config", "blocking-call", "obs-cardinality",
           "journal-discipline", "proto-drift")

# The shared fixture lines that seed a jax device sync: (file, marker,
# the rule the reference flags there).
JAX_SYNC_LINES = (
    ("blocking_call.py", "jax.block_until_ready(request)", "blocking-call"),
    ("blocking_call.py", "jax.block_until_ready(page)", "lock-blocking"),
)


def _line(path: str, marker: str) -> int:
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh, 1):
            if marker in line:
                return i
    raise AssertionError(f"marker {marker!r} not in {path}")


def _rules(pkg_core, names):
    return [r for r in pkg_core.all_rules() if r.name in names]


def _lint(pkg_core, path, names=NEUTRAL):
    findings, suppressed, ctx = pkg_core.lint_path(path,
                                                   _rules(pkg_core, names))
    rows = [(f.rule, f.path, f.line, f.message) for f in findings]
    return rows, suppressed, ctx


def _targets():
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".py"))
    return names + ["proto_drift"]


def _jax_sync_rows(target: str) -> set:
    return {(rule, name, _line(os.path.join(FIXTURES, name), marker))
            for name, marker, rule in JAX_SYNC_LINES if name == target}


@pytest.mark.parametrize("target", _targets())
def test_neutral_rules_match_the_reference(target):
    path = os.path.join(FIXTURES, target)
    want, want_sup, want_ctx = _lint(ref_core, path)
    got, got_sup, got_ctx = _lint(core, path)
    named = _jax_sync_rows(target)
    assert {r[:3] for r in want} >= named
    want = [r for r in want if r[:3] not in named]
    assert got == want
    assert got_sup == want_sup
    assert got_ctx.rules_ran == want_ctx.rules_ran
    assert got_ctx.rules_skipped == want_ctx.rules_skipped
    assert got_ctx.skipped == want_ctx.skipped


def test_whole_fixture_tree_differs_only_at_the_jax_sync_lines():
    want, want_sup, _ = _lint(ref_core, FIXTURES)
    got, got_sup, _ = _lint(core, FIXTURES)
    named = set().union(*(_jax_sync_rows(t) for t in _targets()))
    assert len(named) == 2
    assert {r[:3] for r in set(want) - set(got)} == named
    assert set(got) <= set(want)
    assert got_sup == want_sup == 3


def test_trace_time_env_roots_are_each_packages_own():
    ref_fixture = os.path.join(FIXTURES, "trace_time_env.py")
    port_fixture = os.path.join(PORT_FIXTURES, "trace_time_env.py")
    ref_rows, _, _ = _lint(ref_core, ref_fixture, ("trace-time-env",))
    assert [r[2] for r in ref_rows] == [
        _line(ref_fixture, 'env = os.environ.get("DBX_LANES_CAP")'),
        _line(ref_fixture, 'return os.environ.get("DBX_SCHEDULE_DIR", "")')]
    # No launch boundary in the reference's fixture, no jit in the port's.
    assert _lint(core, ref_fixture, ("trace-time-env",))[0] == []
    assert _lint(ref_core, port_fixture, ("trace-time-env",))[0] == []


# (fixture, rule, the marker of its one finding)
PORT_CASES = (
    ("trace_time_env.py", "trace-time-env",
     'env = os.environ.get("DBX_LANES_CAP")'),
    ("blocking_call.py", "blocking-call", "torch.cuda.synchronize()"),
    ("lock_blocking.py", "lock-blocking", "done.synchronize()"),
)


@pytest.mark.parametrize("name,rule,marker", PORT_CASES,
                         ids=[c[0][:-3] for c in PORT_CASES])
def test_port_fixture_seeds_one_finding_and_a_suppressed_twin(name, rule,
                                                              marker):
    path = os.path.join(PORT_FIXTURES, name)
    findings, suppressed, _ = core.lint_path(path)
    assert [(f.rule, f.line) for f in findings] == [(rule, _line(path,
                                                                 marker))]
    assert suppressed == 1
    # Without its directive the twin is a second finding of the rule.
    (only,) = _rules(core, (rule,))
    assert len(only.check(core.load_context(path))) == 2


@pytest.mark.parametrize("name", ["blocking_call.py", "lock_blocking.py"])
def test_reference_rules_do_not_see_the_cards_waits(name):
    path = os.path.join(PORT_FIXTURES, name)
    assert _lint(ref_core, path, ("blocking-call", "lock-blocking"))[0] == []


def test_device_sync_vocabulary_is_the_cards_waits():
    assert ast_rules._DEVICE_SYNC == {"synchronize"}
    assert ref_ast_rules._DEVICE_SYNC == {"block_until_ready", "device_get"}
    # Everything else the blocking rules flag is the reference's.
    assert (ast_rules.BlockingCallRule._BLOCKING_TERMINAL
            - ast_rules._DEVICE_SYNC
            == ref_ast_rules.BlockingCallRule._BLOCKING_TERMINAL
            - ref_ast_rules._DEVICE_SYNC)
    assert (locks._BLOCKING_UNDER_LOCK - ast_rules._DEVICE_SYNC
            == ref_locks._BLOCKING_UNDER_LOCK - ref_ast_rules._DEVICE_SYNC)


def test_launch_boundary_accepts_the_public_calls_read():
    """``ops/fused.py`` reads ``DBX_LANES_CAP`` once a public call
    (``resolve_lanes_cap``) and passes the width down to the launch: no
    launch wrapper reaches the read, so the rule accepts it."""
    import distributed_backtesting_exploration_tpu_torch.ops.fused as fused

    path = fused.__file__
    rows, _, _ = _lint(core, path, ("trace-time-env",))
    assert rows == []
    module, scopes = ast_rules._build_scopes(core.load_context(path)
                                             .files[0].tree)
    roots = {s.qualname for s in ast_rules.TraceTimeEnvRule()._roots(
        module, scopes)}
    assert {"_launch_fused_sma", "_launch_macd", "_launch_pairs"} <= roots
    assert "resolve_lanes_cap" not in roots


def test_proto_drift_matches_the_reference_on_the_drifted_copy():
    path = os.path.join(FIXTURES, "proto_drift", "drifted.proto")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    got = proto_rules.diff_models(proto_rules.parse_proto_text(text),
                                  proto_rules.describe_pb2(backtesting_pb2),
                                  path="drifted.proto")
    want = ref_proto_rules.diff_models(
        ref_proto_rules.parse_proto_text(text),
        ref_proto_rules.describe_pb2(ref_pb2), path="drifted.proto")
    assert len(got) == 4
    assert [(f.rule, f.line, f.message) for f in got] == [
        (f.rule, f.line, f.message) for f in want]


def test_port_contract_is_clean():
    proto = os.path.join(os.path.dirname(backtesting_pb2.__file__),
                         "backtesting.proto")
    with open(proto, encoding="utf-8") as fh:
        model = proto_rules.parse_proto_text(fh.read())
    assert proto_rules.diff_models(
        model, proto_rules.describe_pb2(backtesting_pb2),
        path="backtesting.proto") == []
    assert model.messages["JobSpec"]["best_returns"] == 13


def test_suppression_directive_inside_string_literal_does_not_count(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text(
        'import os\n'
        '_X = os.environ.get("A", "see dbxlint: disable=all in docs")\n')
    got = core.lint_path(str(mod), [ast_rules.ImportTimeConfigRule()])[:2]
    want = ref_core.lint_path(str(mod),
                              [ref_ast_rules.ImportTimeConfigRule()])[:2]
    assert got[1] == want[1] == 0
    assert [(f.rule, f.line) for f in got[0]] == [
        (f.rule, f.line) for f in want[0]] == [("import-time-config", 2)]


def test_cli_json_format_and_exit_codes(capsys, tmp_path):
    rc = lint_cli.main([os.path.join(FIXTURES, "import_time_config.py"),
                        "--rules", "import-time-config", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert not out["clean"]
    assert {f["rule"] for f in out["findings"]} == {"import-time-config"}
    assert out["rules"] == ["import-time-config"]
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert lint_cli.main([str(clean), "--rules", "import-time-config"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_unknown_rule_and_certify_are_refused(capsys):
    """An unknown rule is refused, and so is ``--certify`` with a path or a
    rule selector (it runs the whole certified registry or nothing)."""
    with pytest.raises(SystemExit):
        lint_cli.main(["--rules", "no-such-rule"])
    with pytest.raises(SystemExit):
        lint_cli.main(["--certify", FIXTURES])
    with pytest.raises(SystemExit):
        lint_cli.main(["--certify", "--rules", "kernel-hygiene"])


def test_unparseable_file_is_loud(tmp_path):
    (tmp_path / "bad.py").write_text("def broken(:\n")
    findings, _, ctx = core.lint_path(str(tmp_path), core.all_rules())
    assert findings == []
    assert len(ctx.skipped) == 1 and ctx.skipped[0][0] == "bad.py"
    assert not lint_cli.run([str(tmp_path)], core.all_rules())["clean"]
