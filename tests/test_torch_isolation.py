"""The PyTorch port stands alone: no JAX, no module of the JAX package.

The port runs on machines without JAX, and importing any module of the
reference package runs its ``__init__`` and so imports JAX. These tests
import every module of the port (and ``chip_smoke.py``) with ``jax``
blocked, scan the sources for forbidden imports, and check the device
policy: ``cuda`` unless the caller asks for the CPU, and no silent
fallback.
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


def _sources() -> list[Path]:
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert len(mods) >= 15, mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
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


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        compute.TorchSweepBackend(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        compute.TorchSweepBackend()
    with pytest.raises(RuntimeError, match="cuda"):
        fused.fused_sma_sweep(np.ones((1, 32), np.float32), [3.0], [10.0])


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
