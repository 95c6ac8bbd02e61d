"""The port lints clean under every dbxlint rule (the gate of
``tests/test_lint_clean.py``, for the port).

The rules are the reference's fourteen: its jaxpr layer and its numerics
certifier (``kernel-hygiene``, ``substrate-contract``,
``weak-type-provenance``, ``digest-determinism``) run over traced torch
programs. The CLI runs where JAX cannot be imported, ``--certify`` too.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import distributed_backtesting_exploration_tpu_torch as dbxt
from distributed_backtesting_exploration_tpu.analysis import core as ref_core
from distributed_backtesting_exploration_tpu_torch.analysis import core, lint

REPO = Path(__file__).resolve().parent.parent
PKG_DIR = os.path.dirname(os.path.abspath(dbxt.__file__))
JAXPR_RULES = {"kernel-hygiene", "substrate-contract", "weak-type-provenance",
               "digest-determinism"}

# Run a module with jax and the JAX package unimportable.
_BLOCKED = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['distributed_backtesting_exploration_tpu'] = None\n"
            "sys.argv = [{mod!r}] + {argv!r}\n"
            "runpy.run_module({mod!r}, run_name='__main__')\n")


def _start_blocked(mod: str, argv: list[str]) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.Popen(
        [sys.executable, "-c", _BLOCKED.format(mod=mod, argv=argv)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc: subprocess.Popen) -> subprocess.CompletedProcess:
    out, err = proc.communicate(timeout=300)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


@pytest.fixture(scope="module")
def package_result():
    """One in-process lint of the port package under every rule."""
    return lint.run([PKG_DIR], core.all_rules())


def test_port_package_lints_clean(package_result):
    result = package_result
    assert result["unparseable"] == [], result["unparseable"]
    assert result["findings"] == [], "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in result["findings"])
    assert result["clean"]
    assert result["rules_skipped"] == []


def test_rules_are_the_references_less_the_jaxpr_and_certify_rules(
        package_result):
    """Named when the jaxpr and certify rules had no port: the rule set is
    now the reference's whole catalogue, those four included."""
    port = [r.name for r in core.all_rules()]
    ref = [r.name for r in ref_core.all_rules()]
    assert port == ref
    assert JAXPR_RULES <= set(port)
    assert not hasattr(lint, "NOT_PORTED")
    assert len(port) == 14
    assert package_result["rules"] == port


def test_cli_lists_rules_and_lints_clean_with_jax_blocked():
    mod = "distributed_backtesting_exploration_tpu_torch.analysis.lint"
    # The three runs at once: the full lint and the certifier each trace
    # the registry.
    procs = [_start_blocked(mod, argv) for argv in (
        ["--list-rules"], [], ["--certify", "--format", "json"])]
    try:
        listed, full, cert = (_finish(p) for p in procs)
    finally:
        for p in procs:
            p.kill()
    assert listed.returncode == 0, listed.stderr
    names = [ln.split()[0] for ln in listed.stdout.splitlines() if ln]
    assert names == [r.name for r in core.all_rules()]
    assert JAXPR_RULES <= set(names)
    assert full.returncode == 0, full.stdout + full.stderr
    tail = full.stdout.strip().splitlines()[-1]
    assert tail.startswith("dbxlint: clean") and "skipped" not in tail
    assert all(n in tail for n in JAXPR_RULES)
    assert cert.returncode == 0, cert.stdout + cert.stderr
    out = json.loads(cert.stdout)
    assert out["rows"] == 59 and out["drift"] == [] and not out["findings"]
