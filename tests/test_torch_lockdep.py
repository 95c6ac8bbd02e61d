"""The port's runtime lockdep (``analysis/lockdep.py``).

Each case runs in a fresh interpreter that imports the port alone: the
shim patches process-wide factories (``threading.Lock``/``RLock``,
``time.sleep``, the card's waits), and the JAX package's lockdep, which
patches the same factories, must never be installed beside it. Checked:
only locks created by the port's modules are wrapped, one class a
creation site; an ABBA order across two sites is an ``order-cycle``; ``time.sleep`` and the
card's blocking waits (``torch.cuda.synchronize``, ``Event`` and
``Stream.synchronize``) under a held lock are ``blocking`` violations;
``uninstall`` restores every patched function; the dispatcher's flight
source reads the report.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = "distributed_backtesting_exploration_tpu_torch"

_PRELUDE = f"""
import sys, threading, time
sys.modules["jax"] = None
import torch
from {PKG}.analysis import lockdep
real = {{"Lock": threading.Lock, "RLock": threading.RLock,
        "sleep": time.sleep, "sync": torch.cuda.synchronize,
        "event": torch.cuda.Event.synchronize,
        "stream": torch.cuda.Stream.synchronize}}
ns = {{"__name__": "{PKG}.fake", "threading": threading}}
exec("def make():\\n    return threading.Lock()\\n"
     "def make2():\\n    return threading.Lock()\\n", ns)
lockdep.install()
lockdep.reset()
"""

_CASES = {
    "wraps_port_locks_only": """
a = ns["make"]()
b = threading.Lock()
assert isinstance(a, lockdep._LockdepLock), type(a)
assert not isinstance(b, lockdep._LockdepLock), type(b)
assert a.key.startswith("fake:"), a.key
""",
    "abba_is_an_order_cycle": """
a, b = ns["make"](), ns["make2"]()
with a:
    with b:
        pass
with b:
    with a:
        pass
kinds = [v["kind"] for v in lockdep.report()["violations"]]
assert kinds == ["order-cycle"], kinds
assert lockdep.report()["edges"] == 2
""",
    "card_waits_under_a_lock_are_blocking": """
a = ns["make"]()
assert torch.cuda.synchronize is not real["sync"]
with a:
    time.sleep(0)
    for call in (torch.cuda.synchronize,
                 lambda: torch.cuda.Event.synchronize(object()),
                 lambda: torch.cuda.Stream.synchronize(object())):
        try:
            call()
        except Exception:
            pass    # no card here: the real wait raises after the check
calls = sorted(v["call"] for v in lockdep.report()["violations"])
assert calls == ["time.sleep", "torch.cuda.Event.synchronize",
                 "torch.cuda.Stream.synchronize",
                 "torch.cuda.synchronize"], calls
""",
    "uninstall_restores_every_patch": """
lockdep.uninstall()
assert threading.Lock is real["Lock"] and threading.RLock is real["RLock"]
assert time.sleep is real["sleep"]
assert torch.cuda.synchronize is real["sync"]
assert torch.cuda.Event.synchronize is real["event"]
assert torch.cuda.Stream.synchronize is real["stream"]
assert not lockdep.active()
assert not isinstance(ns["make"](), lockdep._LockdepLock)
""",
    "dispatcher_source_reads_the_report": f"""
from {PKG}.rpc import dispatcher
a, b = ns["make"](), ns["make2"]()
with a:
    with b:
        pass
rep = dispatcher._lockdep_report()
assert rep["edges"] == 1 and rep["violations"] == [], rep
""",
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_port_lockdep(case):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DBX_LOCKDEP")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + _CASES[case] + "print('ok')\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
