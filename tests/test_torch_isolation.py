"""The PyTorch port stands alone: no JAX, no module of the JAX package.

The port runs on machines without JAX, and importing any module of the
reference package runs its ``__init__`` and so imports JAX. These tests
import every module of the port (and the root scripts that drive it,
``chip_smoke.py`` and ``worker_rate.py``) with ``jax`` blocked, scan the
sources for forbidden imports, and check the device policy: ``cuda``
unless the caller asks for the CPU, and no silent fallback.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_backtesting_exploration_tpu_torch as dbxt
from distributed_backtesting_exploration_tpu_torch import device as device_mod
from distributed_backtesting_exploration_tpu_torch.ops import fused
from distributed_backtesting_exploration_tpu_torch.rpc import compute

REPO = Path(__file__).resolve().parent.parent
PKG = Path(dbxt.__file__).resolve().parent
REF = "distributed_backtesting_exploration_tpu"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


# The root scripts that drive the port on the card.
SCRIPTS = ("chip_smoke", "worker_rate")


def _sources() -> list[Path]:
    return sorted(PKG.rglob("*.py")) + [REPO / f"{s}.py" for s in SCRIPTS]


def _kernel_sources() -> list[Path]:
    return sorted(PKG.glob("csrc/*.cu")) + sorted(PKG.glob("csrc/*.cuh"))


def test_every_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert len(mods) >= 20, mods
    for m in ("ops.signals", "models.bollinger", "models.stochastic",
              "models.momentum", "models.donchian", "models.macd",
              "models.trix", "models.rsi", "models.keltner", "models.obv",
              "models.vwap", "models.pairs", "bench", "roofline",
              "ops.stages", "streaming", "streaming.recurrent",
              "streaming.store", "rpc.page_pool", "scenarios",
              "scenarios.synth", "scenarios.threefry", "parallel.sharding",
              "parallel.timeshard", "parallel.multihost",
              "rpc.slice_worker", "obs", "obs.registry", "tune",
              "tune.registry", "tune.autotune", "tune.compile_cache",
              "sched", "sched.tenancy", "sched.explain", "sched.wfq",
              "sched.placement", "obs.events", "obs.trace", "obs.http",
              "obs.timeline", "obs.flight", "obs.costmodel", "obs.fleet",
              "obs.decisions", "streaming.delta", "serve", "serve.registry",
              "analysis", "analysis.lockdep", "analysis.core",
              "analysis.ast_rules", "analysis.locks", "analysis.proto_rules",
              "analysis.lint", "analysis.schedules", "analysis.modelcheck",
              "analysis.dataflow", "analysis.fx_rules", "analysis.certify",
              "runtime", "runtime._core",
              "rpc.journal", "rpc.panel_store", "rpc.service",
              "rpc.dispatcher", "obs.dump", "obs.why", "utils.trace"):
        assert f"{dbxt.__name__}.{m}" in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {mods!r} + {list(SCRIPTS)!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m, v in sys.modules.items() if v is not "
            f"None and (m == 'jax' or m.startswith('jax.') or m == {REF!r} "
            f"or m.startswith({REF + '.'!r})))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", REF), (
                f"{path.name}:{node.lineno} imports {name}")


def test_kernel_sources_are_the_slices_and_include_nothing_else():
    names = {p.name for p in _kernel_sources()}
    assert {"fused_sma.cu", "band_machine.cu", "single_window.cu",
            "ema_cross.cu", "stages.cu", "metrics_tail.cuh",
            "band_next.cuh"} <= names


@pytest.mark.parametrize("path", _kernel_sources(), ids=lambda p: p.name)
def test_kernel_sources_include_only_cuda_and_their_own_headers(path):
    # A kernel source stands alone: system headers and its own csrc/
    # headers, nothing of JAX or of the reference package.
    text = path.read_text()
    assert "jax" not in text.replace(REF, "").lower()
    for line in text.splitlines():
        if line.startswith("#include"):
            target = line.split(None, 1)[1].strip()
            if target.startswith('"'):
                assert (path.parent / target.strip('"')).exists(), line
            else:
                assert target.startswith("<") and "/" not in target, line


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        compute.TorchSweepBackend(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        compute.TorchSweepBackend()
    with pytest.raises(RuntimeError, match="cuda"):
        fused.fused_sma_sweep(np.ones((1, 32), np.float32), [3.0], [10.0])


def test_make_mesh_needs_cuda_and_never_meshes_the_cpu_unasked():
    from distributed_backtesting_exploration_tpu_torch.parallel import (
        sharding)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: make_mesh() takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.make_mesh()
    # A CPU mesh only where the caller lists the CPU; the backend stays
    # meshless unless given one.
    assert sharding.make_mesh(["cpu"] * 2).devices == (
        torch.device("cpu"),) * 2
    assert compute.TorchSweepBackend(device="cpu").mesh is None
    assert compute.default_mesh("cuda") is None


def test_dispatcher_defaults_to_the_card_and_raises_without_it():
    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher
    assert dispatcher.JobQueue().device == "cuda"
    assert dispatcher.make_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    args = dispatcher.make_parser().parse_args(["--synthetic", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        dispatcher.build_dispatcher(args)


def test_device_policy():
    assert device_mod.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        device_mod.resolve("meta")
    assert compute.TorchSweepBackend(device="cpu").chips == 1


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    # The dispatch looks only at the tensor's device: a non-CPU tensor goes
    # to the kernel wrapper, which raises rather than falling back.
    calls = []
    monkeypatch.setattr(fused, "fused_sma_cuda",
                        lambda *a, **k: calls.append("cuda"))
    monkeypatch.setattr(fused, "fused_sma_plain",
                        lambda *a, **k: calls.append("plain"))
    meta = torch.empty((2, 8), device="meta")
    fused.fused_sma(meta, meta, None, None, None, None, cost=0.0, ppy=252)
    cpu = torch.empty((2, 8))
    fused.fused_sma(cpu, cpu, None, None, None, None, cost=0.0, ppy=252)
    assert calls == ["cuda", "plain"]


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 8))
    i = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_sma_cuda(x, x, i, i, i, i, cost=0.0, ppy=252)


@pytest.mark.parametrize("dispatch,plain,cuda,n_args", [
    ("band_inline", "band_inline_plain", "band_inline_cuda", 9),
    ("band_table", "band_machine_plain", "band_table_cuda", 6),
    ("band_stoch", "band_stoch_plain", "band_stoch_cuda", 8),
    ("momentum", "momentum_plain", "momentum_cuda", 5),
    ("donchian", "donchian_plain", "donchian_cuda", 7),
    ("macd", "macd_plain", "macd_cuda", 7),
    ("trix", "trix_plain", "trix_cuda", 6),
    ("obv", "obv_plain", "obv_cuda", 6),
    ("pairs", "pairs_plain", "pairs_cuda", 7),
])
def test_new_entries_never_take_the_plain_version_off_the_cpu(
        monkeypatch, dispatch, plain, cuda, n_args):
    calls = []
    monkeypatch.setattr(fused, cuda, lambda *a, **k: calls.append("cuda"))
    monkeypatch.setattr(fused, plain, lambda *a, **k: calls.append("plain"))
    kw = {"cost": 0.0, "ppy": 252}
    if dispatch.startswith("band"):
        kw.update(machine="hysteresis", z_exit=0.0)
    for x in (torch.empty((2, 8), device="meta"), torch.empty((2, 8))):
        getattr(fused, dispatch)(x, *([None] * (n_args - 1)), **kw)
    assert calls == ["cuda", "plain"]


@pytest.mark.parametrize("wrapper", ["band_inline_cuda", "band_table_cuda",
                                     "band_stoch_cuda",
                                     "momentum_cuda", "donchian_cuda",
                                     "macd_cuda", "trix_cuda", "obv_cuda",
                                     "pairs_cuda"])
def test_new_kernel_wrappers_refuse_cpu_tensors(wrapper):
    x = torch.zeros((1, 8))
    i = torch.zeros((1,), dtype=torch.int32)
    args = {"band_inline_cuda": (x, x, x, x, x, i, i, x[0, :1], i),
            "band_table_cuda": (x[None], x, i, i, x[0, :1], i),
            "band_stoch_cuda": (x, x, x, x, i, i, x[0, :1], i),
            "momentum_cuda": (x, x, i, i, i),
            "donchian_cuda": (x, x, x, x, i, i, i),
            "macd_cuda": (x[None], x, i, i, i, x[0, :1], i),
            "trix_cuda": (x[None], x, i, i, x[0, :1], i),
            "obv_cuda": (x, x, x, i, i, i),
            "pairs_cuda": (x[None], x[None], i, i, x[0, :1], x[0, :1],
                           i)}[wrapper]
    kw = {"cost": 0.0, "ppy": 252}
    if wrapper.startswith("band"):
        kw.update(machine="hysteresis", z_exit=0.0)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fused, wrapper)(*args, **kw)


def test_native_shell_boots_the_port_alone():
    # The shell's string literals (its boot code among them) name the
    # port's package and nothing of JAX or the reference; it includes
    # only system headers, the shared core's header and the C++ generated
    # from the port's own proto.
    import re

    text = (PKG / "csrc" / "worker_native.cc").read_text()
    literals = re.findall(r'"((?:[^"\\]|\\.)*)"', text)
    boot = [s for s in literals if "import" in s]
    assert any(f"from {dbxt.__name__}.rpc import worker" in s for s in boot)
    for s in literals:
        assert "jax" not in s.lower(), s
        assert not re.search(rf"{REF}(?!_torch)", s), s
    for line in text.splitlines():
        if line.startswith("#include"):
            target = line.split(None, 1)[1].strip()
            assert target.startswith("<") or target in (
                '"dbx_core.h"', '"backtesting.pb.h"'), line
