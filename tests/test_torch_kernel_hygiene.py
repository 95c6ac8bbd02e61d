"""kernel-hygiene over the port (``analysis.fx_rules``): the seeded
defects of ``tests/fixtures/torch_hygiene`` are each found with a chain
into the fixture, the whole registry (dense, pairs, paged, scenario,
append steps, the K8 stages) is clean at both substrates, a registry
entry without a template is a finding, the rule is skipped outside the
package, and the source pass flags the fixture's ``printf`` and float
``atomicAdd`` and an ``NVCC_FLAGS`` without the rounding flags.
"""

import importlib.util
import os

import numpy as np
import pytest

import distributed_backtesting_exploration_tpu_torch as dbxt
from distributed_backtesting_exploration_tpu_torch.analysis import (
    core, fx_rules, lint)
from distributed_backtesting_exploration_tpu_torch.ops import _kernels, fused
from distributed_backtesting_exploration_tpu_torch.rpc import compute

PKG_DIR = os.path.dirname(os.path.abspath(dbxt.__file__))
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "torch_hygiene")
X = [np.linspace(1.0, 2.0, 32, dtype=np.float32).reshape(2, 16)]


def _bad():
    spec = importlib.util.spec_from_file_location(
        "torch_hygiene_bad_kernels", os.path.join(FIXTURES,
                                                  "bad_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check(name, line=7):
    fn = getattr(_bad(), name)
    return fx_rules.check_traced(name, fn, X, path="bad_kernels.py",
                                 line=line)


def _fixture_line(marker: str) -> int:
    with open(os.path.join(FIXTURES, "bad_kernels.py")) as fh:
        for i, text in enumerate(fh, 1):
            if marker in text:
                return i
    raise AssertionError(marker)


@pytest.mark.parametrize("name, marker, words", [
    ("kernel_with_item", "x.abs().max().item()", ("host round trip",
                                                  "_local_scalar_dense")),
    ("kernel_f64_at_entry", "fused._on_device(_entry_plain",
     ("launch boundary of `_entry_cuda`", "float64")),
    ("kernel_f64_output", "x.double().cumsum(-1)", ("float64, not float32",
                                                    "cumsum")),
    ("kernel_default_dtype_at_entry", 'fused._check_launch("fixture_cuda"',
     ("fails under torch's float64 default dtype",
      "w must be torch.float32, got torch.float64")),
    ("kernel_weak_output", "torch.full(x.shape, 2.0)",
     ("default dtype", "provenance")),
])
def test_fixture_defect_is_found_with_a_chain_into_the_fixture(
        name, marker, words):
    findings = _check(name)
    assert findings, name
    assert all((f.rule, f.path, f.line) == ("kernel-hygiene",
                                            "bad_kernels.py", 7)
               for f in findings)
    text = " ".join(f.message for f in findings)
    for w in words:
        assert w in text, (w, text)
    assert f"bad_kernels.py:{_fixture_line(marker)}" in text, text


def test_f64_at_the_entry_is_refused_by_the_kernels_own_check():
    (f, *rest) = [f for f in _check("kernel_f64_at_entry")
                  if "launch check" in f.message]
    assert "must be torch.float32, got torch.float64" in f.message
    assert not fused._WATCH


def test_clean_fixture_kernel_passes():
    assert _check("kernel_clean") == []


def test_whole_registry_is_clean_at_both_substrates(monkeypatch):
    """Every variant of every family runs clean at both substrates, and on
    the CPU every entry of the launch boundary is resolved and
    dry-checked; nothing launches."""
    seen, entries = [], set()
    orig_check = fx_rules.check_traced
    orig_entry = fx_rules.BoundaryWatch.entry

    def counting(name, *a, **k):
        seen.append(name)
        return orig_check(name, *a, **k)

    def note(self, fn, plain, cuda, *args, **kwargs):
        entries.add(fx_rules._entry_name(cuda))
        return orig_entry(self, fn, plain, cuda, *args, **kwargs)

    monkeypatch.setattr(fx_rules, "check_traced", counting)
    monkeypatch.setattr(fx_rules.BoundaryWatch, "entry", note)
    _kernels.reset_launch_counts()
    findings = fx_rules.KernelHygieneRule().check(core.load_context(PKG_DIR))
    assert findings == [], "\n".join(f.format() for f in findings)
    for suffix in ("", "@ladder"):
        for fam in sorted(compute._FUSED_STRATEGIES):
            for variant in ("", ".paged", ".scenario", "._append_step"):
                assert f"{fam}{variant}{suffix}" in seen
        assert f"pairs{suffix}" in seen
        assert f"pairs._append_step{suffix}" in seen
    assert {"sma_stage", "boll_stage"} <= set(seen)
    assert {"fused_sma_cuda", "obv_cuda", "band_inline_cuda",
            "band_table_cuda", "band_stoch_cuda", "momentum_cuda",
            "donchian_cuda", "macd_cuda", "trix_cuda", "pairs_cuda",
            "_macd_table_cuda", "_trix_table_cuda", "_pairs_tables_of_legs",
            "sma_stage_cuda", "boll_stage_cuda"} <= entries, entries
    assert not fused._WATCH
    assert sum(_kernels.LAUNCHES.values()) == 0


def test_unknown_axis_is_a_finding_not_a_crash(monkeypatch):
    spec = compute._FusedSpec(frozenset({"threshold"}), ("threshold",),
                              lambda *a, **k: None)
    monkeypatch.setattr(compute, "_FUSED_STRATEGIES",
                        {"novel_strategy": spec})
    ctx = core.load_context(PKG_DIR)
    rule = fx_rules.KernelHygieneRule()
    findings = (rule._check_registry(ctx, "scan:8")
                + rule._check_registry(ctx, "ladder"))
    # One a coverage surface, on the scan pass only: the dense template
    # gap and the paged probe gap.
    assert len(findings) == 2, [f.message for f in findings]
    assert all(f.rule == "kernel-hygiene" and "novel_strategy" in f.message
               for f in findings)
    assert any("'threshold'" in f.message for f in findings)
    assert any("paged" in f.message for f in findings)


def test_skipped_outside_the_package_never_clean():
    result = lint.run([os.path.join(os.path.dirname(__file__), "fixtures",
                                    "torch_lint")], core.all_rules())
    assert "kernel-hygiene" in result["rules_skipped"]
    assert "kernel-hygiene" not in result["rules"]
    assert "trace-time-env" in result["rules"]


def test_csrc_pass_flags_the_fixture_and_passes_the_kernels():
    findings = fx_rules.check_csrc(os.path.join(FIXTURES, "csrc"),
                                   root=FIXTURES,
                                   nvcc_flags=_kernels.NVCC_FLAGS)
    got = sorted((f.path, f.line, f.message.split(":")[0].split(" (")[0])
                 for f in findings)
    src = os.path.join("csrc", "bad_kernel.cu")
    with open(os.path.join(FIXTURES, src)) as fh:
        lines = fh.read().splitlines()
    printf = next(i for i, t in enumerate(lines, 1)
                  if 'printf("thread' in t)
    atomic = next(i for i, t in enumerate(lines, 1)
                  if "atomicAdd(total" in t)
    assert got == [(src, printf, "printf in device code"),
                   (src, atomic, "atomicAdd on a float")], got
    real = fx_rules.check_csrc(os.path.join(PKG_DIR, "csrc"), root=PKG_DIR,
                               nvcc_flags=_kernels.NVCC_FLAGS)
    assert real == []


@pytest.mark.parametrize("flag", ["-fmad=false", "-prec-div=true",
                                  "-prec-sqrt=true"])
def test_csrc_pass_flags_nvcc_flags_without_rounding(flag):
    flags = tuple(f for f in _kernels.NVCC_FLAGS if f != flag)
    (f,) = fx_rules.check_csrc(os.path.join(PKG_DIR, "csrc"), root=PKG_DIR,
                               nvcc_flags=flags)
    assert flag in f.message and f.path == "ops/_kernels.py"
