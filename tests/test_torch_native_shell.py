"""The port's native worker shell (``csrc/worker_native.cc``) on the CPU.

- ``runtime._core.build_worker_shell`` builds ``_build/dbx_worker_native``
  with one g++ command and leaves no temporary file; six processes
  building at once (``build_core_bench`` into an empty directory) wait for
  one build, and every one gets a whole binary.
- ``--help`` three times: exit 0, the core selftest and (where ``protoc``
  and libprotobuf are present) the proto selftest on stderr, the worker
  CLI's usage on stdout; the shell finds the port from its own location,
  without ``PYTHONPATH``.
- The boot imports no ``jax`` and nothing of the JAX package (both
  blocked in the embedded interpreter by a ``sitecustomize``).
- A drain on the CPU: the port's dispatcher on ``localhost:0`` and the
  shell with ``--backend torch --device cpu``; its blocks bit-equal to
  the port's ``process`` of the same jobs, and within the flip rule of
  ``tests/torch_parity.py`` of the JAX ``JaxSweepBackend``'s.
- ``--device cuda`` on a host without a card is an error, not a CPU run.
"""

import glob
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire)
from distributed_backtesting_exploration_tpu_torch import obs as port_obs
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, compute, dispatcher, wire)
from distributed_backtesting_exploration_tpu_torch.runtime import _core

from torch_parity import assert_metrics_match

REPO = Path(__file__).resolve().parent.parent
REF = "distributed_backtesting_exploration_tpu"
HAVE_PROTO = (shutil.which("protoc") is not None
              and _core._run_text(["pkg-config", "--exists",
                                   "protobuf"]) is not None)
pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the native shell needs g++")


@pytest.fixture(scope="module")
def shell() -> str:
    return _core.build_worker_shell()


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_shell_builds_and_leaves_no_temporary_file(shell):
    assert shell == _core.SHELL_PATH and os.access(shell, os.X_OK)
    build = os.path.dirname(shell)
    assert not glob.glob(os.path.join(build, "*.tmp"))
    # Its key unchanged, a second call builds nothing.
    mtime = os.path.getmtime(shell)
    assert _core.build_worker_shell() == shell
    assert os.path.getmtime(shell) == mtime


@pytest.mark.parametrize("fault", ["protoc", "link"])
def test_a_protobuf_build_that_fails_is_an_error(fault, tmp_path,
                                                 monkeypatch):
    # protoc and libprotobuf found, then the build fails: no shell is
    # built without the proto selftest in its place.
    if fault == "protoc":
        protoc = tmp_path / "protoc"
        protoc.write_text("#!/bin/sh\necho broken >&2\nexit 1\n")
        protoc.chmod(0o755)
        found = (str(protoc), "libprotoc 0", [])
    else:
        if not HAVE_PROTO:
            pytest.skip("needs protoc")
        found = (shutil.which("protoc"), "libprotoc 0",
                 ["-lno_such_protobuf_library"])
    build = tmp_path / "build"
    monkeypatch.setattr(_core, "_BUILD_DIR", str(build))
    monkeypatch.setattr(_core, "SHELL_PATH", str(build / "dbx_worker_native"))
    monkeypatch.setattr(_core, "_PROTO_DIR", str(build / "proto"))
    monkeypatch.setattr(_core, "_protobuf", lambda: found)
    with pytest.raises(_core.ToolchainError):
        _core.build_worker_shell()
    assert not (build / "dbx_worker_native").exists()
    assert not glob.glob(str(build / "*.tmp"))


def test_six_processes_building_at_once_get_one_whole_binary(tmp_path):
    code = textwrap.dedent(f"""
        import os, sys
        from distributed_backtesting_exploration_tpu_torch.runtime import (
            _core)
        _core._BUILD_DIR = {str(tmp_path)!r}
        _core.CORE_BENCH_PATH = os.path.join(_core._BUILD_DIR,
                                             "dbx_core_bench")
        print(_core.build_core_bench())
    """)
    env = _env(PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    binary = str(tmp_path / "dbx_core_bench")
    assert {o.strip() for o, _ in outs} == {binary}
    assert sorted(os.listdir(tmp_path)) == [
        ".dbx_core_bench.lock", "dbx_core_bench", "dbx_core_bench.key"]
    run = subprocess.run([binary, "20000"], capture_output=True, text=True,
                         timeout=60)
    assert run.returncode == 0 and "jobs/s" in run.stdout


@pytest.mark.parametrize("run", range(3))
def test_help_runs_both_selftests_and_prints_the_usage(shell, tmp_path, run):
    proc = subprocess.run([shell, "--help"], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "dbx_worker_native: core selftest ok" in proc.stderr
    want = "ok" if HAVE_PROTO else "skipped"
    assert f"dbx_worker_native: proto selftest {want}" in proc.stderr
    assert proc.stdout.startswith("usage: ")
    for flag in ("--connect", "--backend", "--device", "--param-chunk",
                 "--fused", "--mesh", "--exit-after-idle"):
        assert flag in proc.stdout


def test_boot_imports_no_jax(shell, tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    out = tmp_path / "imported.txt"
    (site / "sitecustomize.py").write_text(textwrap.dedent(f"""
        import atexit, sys
        sys.modules["jax"] = None
        sys.modules[{REF!r}] = None

        def _report():
            bad = sorted(m for m, v in sys.modules.items()
                         if v is not None and (m.split(".")[0] == "jax"
                                               or m.split(".")[0] == {REF!r}))
            port = "distributed_backtesting_exploration_tpu_torch.rpc.worker"
            with open({str(out)!r}, "w") as fh:
                fh.write(repr((bad, port in sys.modules)))

        atexit.register(_report)
    """))
    proc = subprocess.run([shell, "--help"], cwd=tmp_path,
                          env=_env(PYTHONPATH=str(site)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    bad, loaded = eval(out.read_text())
    assert loaded and bad == []


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA card is present: --device cuda works")
def test_shell_with_cuda_and_no_card_is_an_error(shell, tmp_path):
    proc = subprocess.run([shell, "--connect", "localhost:1", "--device",
                           "cuda"], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr.lower()


def _blocks(results_dir, ids) -> dict:
    out = {}
    for jid in ids:
        (path,) = glob.glob(os.path.join(str(results_dir), f"{jid}.*"))
        out[jid] = Path(path).read_bytes()
    return out


def test_shell_drains_the_port_dispatcher_on_the_cpu(shell, tmp_path):
    grid = dispatcher.parse_grid("fast=3:5,slow=8:10")
    recs = dispatcher.synthetic_jobs(2, 48, "sma_crossover", grid)
    q = dispatcher.JobQueue(device="cpu")
    disp = dispatcher.Dispatcher(
        q, dispatcher.PeerRegistry(prune_window_s=30.0),
        results_dir=str(tmp_path / "res"), registry=port_obs.Registry())
    srv = dispatcher.DispatcherServer(disp, bind="localhost:0",
                                      prune_interval_s=0.2).start()
    try:
        q.enqueue_many(recs)
        proc = subprocess.run(
            [shell, "--connect", f"localhost:{srv.port}", "--backend",
             "torch", "--device", "cpu", "--poll-s", "0.02", "--status-s",
             "0.2", "--exit-after-idle", "10"], cwd=tmp_path, env=_env(),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert q.drained, q.stats()
    finally:
        srv.stop()
    ids = [r.id for r in recs]
    got = _blocks(tmp_path / "res", ids)
    specs = [pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                        grid=wire.grid_to_proto(r.grid), cost=r.cost,
                        periods_per_year=252) for r in recs]
    direct = {c.job_id: c.metrics
              for c in compute.TorchSweepBackend(device="cpu").process(specs)}
    assert got == direct
    ref_specs = [ref_pb.JobSpec.FromString(s.SerializeToString())
                 for s in specs]
    ref = {c.job_id: c.metrics
           for c in ref_compute.JaxSweepBackend().process(ref_specs)}
    for jid in ids:
        m = wire.metrics_from_bytes(got[jid])
        assert np.isfinite(m.sharpe).all()
        assert_metrics_match(m, ref_wire.metrics_from_bytes(ref[jid]))
