"""The port lints clean under every ported dbxlint rule (the gate of
``tests/test_lint_clean.py``, for the port).

The rules that run are the reference's less its jaxpr layer and its
numerics certifier (``kernel-hygiene``, ``substrate-contract``,
``weak-type-provenance``, ``digest-determinism``), which walk jaxprs and
have no port yet. The CLI runs where JAX cannot be imported.
"""

import os
import subprocess
import sys
from pathlib import Path

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


def _run_blocked(mod: str, argv: list[str]) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(mod=mod, argv=argv)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_port_package_lints_clean():
    result = lint.run([PKG_DIR], core.all_rules())
    assert result["unparseable"] == [], result["unparseable"]
    assert result["findings"] == [], "\n".join(
        f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in result["findings"])
    assert result["clean"]
    assert result["rules_skipped"] == []


def test_rules_are_the_references_less_the_jaxpr_and_certify_rules():
    port = [r.name for r in core.all_rules()]
    ref = [r.name for r in ref_core.all_rules()]
    assert port == [n for n in ref if n not in JAXPR_RULES]
    assert set(lint.NOT_PORTED) == JAXPR_RULES
    assert len(port) == 10
    result = lint.run([PKG_DIR], core.all_rules())
    assert result["rules"] == port


def test_cli_lists_rules_and_lints_clean_with_jax_blocked():
    mod = "distributed_backtesting_exploration_tpu_torch.analysis.lint"
    listed = _run_blocked(mod, ["--list-rules"])
    assert listed.returncode == 0, listed.stderr
    names = [ln.split()[0] for ln in listed.stdout.splitlines()
             if ln and not ln.startswith("not ported")]
    assert names == [r.name for r in core.all_rules()]
    assert all(n in listed.stdout.splitlines()[-1] for n in JAXPR_RULES)
    full = _run_blocked(mod, [])
    assert full.returncode == 0, full.stdout + full.stderr
    tail = full.stdout.strip().splitlines()[-1]
    assert tail.startswith("dbxlint: clean") and "skipped" not in tail
