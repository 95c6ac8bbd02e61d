"""dbxmc over the port's journaled dispatcher (the gate of
``tests/test_mc_clean.py`` and the mechanism tests of
``tests/test_modelcheck.py``, for the port), held to the reference's
checker where both run the same exploration.

- The gate: at least 500 distinct schedules and 100 crash-replay points
  on each substrate of the port (its pure-Python state machine and, where
  g++ builds it, its native core), zero violations of the invariant table.
- The seeded bug: the reference's ``journal_discipline`` fixture,
  monkeypatched over the port's ``JobQueue.enqueue_many``, is caught by
  the checker (minimized, and reproduced on replay) and by the static
  ``journal-discipline`` rule.
- Parity: on the Python substrate, for the same ``MCConfig``, the port's
  exploration counts the reference's schedules, crash points and journal
  boundaries, and generates the same op schedules.
"""

import importlib.util
import json
import os
import random

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu.analysis import (
    modelcheck as ref_mc, schedules as ref_scl)
from distributed_backtesting_exploration_tpu_torch.analysis import (
    ast_rules, core, lockdep, modelcheck as mc, schedules as scl)
from distributed_backtesting_exploration_tpu_torch.rpc import (
    panel_store as panel_store_mod)
from distributed_backtesting_exploration_tpu_torch.rpc.dispatcher import (
    JobQueue, JobRecord)
from distributed_backtesting_exploration_tpu_torch.rpc.journal import (
    Journal, JournalCorruptError)
from distributed_backtesting_exploration_tpu_torch.runtime import (
    _core as native_core)

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "lint",
                        "journal_discipline.py")


def _grid(n=2):
    return {"p": np.arange(n, dtype=np.float32)}


def _queue(journal=None, **kw):
    return JobQueue(journal, use_native=False, device="cpu", **kw)


def _need(substrate: str) -> None:
    # Decided in the test, not at collection: every test process must
    # collect the same cases.
    if substrate == "native" and not native_core.available():
        pytest.skip("the port's native core needs g++ to build")


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("substrate", ["python", "native"])
def test_mc_gate(substrate):
    _need(substrate)
    cfg = mc.MCConfig(ops=int(os.environ.get("DBX_MC_OPS", "12")),
                      seed=int(os.environ.get("DBX_MC_SEED", "0")),
                      schedules=500, substrate=substrate)
    r = mc.explore_substrate(cfg)
    assert r["violations"] == [], r["violations"]
    assert r["schedules"] >= 500
    assert r["crash_points"] >= 100
    assert r["boundaries"] > r["crash_points"]
    assert r["clean"]
    if substrate == "native":
        assert r["native_steps"] > 0


def test_available_substrates_follow_the_ports_core():
    subs = mc.available_substrates()
    assert subs[0] == "python"
    assert ("native" in subs) == native_core.available()


def _load_fixture():
    spec = importlib.util.spec_from_file_location("jd_fixture", _FIXTURE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_seeded_bug_caught_dynamically(monkeypatch, tmp_path):
    monkeypatch.setattr(JobQueue, "enqueue_many",
                        _load_fixture().buggy_enqueue_many)
    r = mc.explore_substrate(mc.MCConfig(ops=10, seed=1, schedules=10))
    assert not r["clean"]
    v = r["violations"][0]
    assert v["invariant"] == "journal-append-first"
    assert v["minimized_ops"] <= 2
    assert [o["name"] for o in v["script"]["ops"]].count("enqueue") >= 1
    assert mc.replay_script(v["script"])["reproduced"]
    path = tmp_path / "script.json"
    path.write_text(json.dumps(v["script"]))
    assert mc.main(["--replay", str(path)]) == 1


def test_seeded_bug_flagged_statically():
    findings, _, _ = core.lint_path(_FIXTURE,
                                    [ast_rules.JournalDisciplineRule()])
    assert len(findings) == 3
    assert all(f.rule == "journal-discipline" for f in findings)
    with open(_FIXTURE, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    marker = next(i + 1 for i, ln in enumerate(lines)
                  if "BUG: published before journaled" in ln)
    assert marker in {f.line for f in findings}


# ---------------------------------------------------------------------------
# Parity with the reference's checker
# ---------------------------------------------------------------------------

MC_CASES = [dict(ops=12, seed=0, schedules=120),
            dict(ops=8, seed=3, schedules=60),
            dict(ops=16, seed=5, schedules=40, crash_every=2)]


@pytest.mark.parametrize("kw", MC_CASES,
                         ids=[f"ops{c['ops']}-seed{c['seed']}"
                              for c in MC_CASES])
def test_counts_match_the_reference_on_python(kw):
    got = mc.explore(mc.MCConfig(**kw), ["python"])
    want = ref_mc.explore(ref_mc.MCConfig(**kw), ["python"])
    assert got["violations"] == want["violations"] == []
    for key in ("schedules", "crash_points", "boundaries"):
        assert got[key] == want[key], key
    assert (got["substrates"]["python"]["native_steps"]
            == want["substrates"]["python"]["native_steps"] == 0)


def test_schedules_are_the_references():
    programs = scl.build_programs(12, random.Random(0))
    ref_programs = ref_scl.build_programs(12, random.Random(0))
    assert ({t: [o.to_json() for o in p] for t, p in programs.items()}
            == {t: [o.to_json() for o in p]
                for t, p in ref_programs.items()})
    got = [[o.to_json() for o in s] for _k, s in
           scl.generate_schedules(programs, random.Random(1), 50)]
    want = [[o.to_json() for o in s] for _k, s in
            ref_scl.generate_schedules(ref_programs, random.Random(1), 50)]
    assert got == want
    assert mc.INVARIANTS == ref_mc.INVARIANTS


# ---------------------------------------------------------------------------
# Schedule combinatorics
# ---------------------------------------------------------------------------

def test_canonical_key_merges_commuting_interleavings():
    enq = scl.make_op("client", "enqueue", ids=("a",), combos=(2.0,))
    obs = scl.make_op("maint", "stats")
    assert scl.canonical_key([enq, obs]) == scl.canonical_key([obs, enq])
    take = scl.make_op("workerA", "take", worker="workerA", n=1)
    assert scl.canonical_key([enq, take]) != scl.canonical_key([take, enq])


def test_generate_schedules_distinct_and_deterministic():
    programs = scl.build_programs(12, random.Random(0))
    got = list(scl.generate_schedules(programs, random.Random(1), 50))
    keys = [k for k, _ in got]
    assert len(keys) == len(set(keys)) == 50
    assert keys == [k for k, _ in
                    scl.generate_schedules(programs, random.Random(1), 50)]
    for _key, sched in got[:5]:
        for t, prog in programs.items():
            assert [op for op in sched if op.thread == t] == prog


def test_enumerate_schedules_exhaustive_twin():
    programs = {
        "client": [scl.make_op("client", "enqueue", ids=("a",),
                               combos=(2.0,))],
        "workerA": [scl.make_op("workerA", "take", worker="workerA", n=1)],
        "maint": [scl.make_op("maint", "stats")],
    }
    keys = [k for k, _ in scl.enumerate_schedules(programs, 100)]
    assert len(keys) == len(set(keys)) == 2


def test_op_script_roundtrip_and_unknown_op_rejected():
    op = scl.make_op("client", "enqueue", ids=("a", "b"),
                     combos=(2.0, 3.0), tenant="tenantB")
    assert scl.Op.from_json(op.to_json()) == op
    with pytest.raises(ValueError):
        scl.make_op("client", "enqueue_and_pray", ids=("a",))


# ---------------------------------------------------------------------------
# The seams of the port's dispatcher
# ---------------------------------------------------------------------------

def test_virtual_clock_drives_lease_expiry():
    vclock = [0.0]
    q = _queue(lease_s=5.0, clock=lambda: vclock[0])
    q.enqueue_many([JobRecord(id="a", strategy="sma_crossover",
                              grid=_grid(), ohlcv=mc._panel_bytes("a"))])
    assert [rec.id for rec, _ in q.take(1, "w")] == ["a"]
    assert q.requeue_expired() == []
    vclock[0] = 10.0
    assert q.requeue_expired() == ["a"]
    assert q.stats()["jobs_pending"] == 1


def test_lockdep_schedule_hook_sees_acquire_release():
    events = []
    installed = not lockdep.active()
    if installed:
        lockdep.install()
    try:
        lockdep.set_schedule_hook(lambda ph, key: events.append(ph))
        _queue().stats()
    finally:
        lockdep.set_schedule_hook(None)
        if installed:
            lockdep.uninstall()
    assert {"acquire", "acquired", "release"} <= set(events)


def test_crash_hook_fires_both_sides_of_append(tmp_path):
    seen = []
    j = Journal(str(tmp_path / "j.jsonl"), fsync=False)
    j.crash_hook = lambda phase, event, rec: seen.append((phase, event))
    _queue(j).enqueue_many([JobRecord(id="a", strategy="sma_crossover",
                                      grid=_grid(),
                                      ohlcv=mc._panel_bytes("a"))])
    assert seen == [("pre", "enqueue"), ("post", "enqueue")]


def test_controlled_scheduler_preempts_and_stays_clean():
    r = mc.explore_substrate(mc.MCConfig(ops=10, seed=3, schedules=4,
                                         depth=3))
    assert r["violations"] == [], r["violations"]
    assert r["schedules"] >= 2
    assert r["preemptions"] > 0


def test_replay_script_clean_roundtrip(tmp_path):
    ops = [scl.make_op("client", "enqueue", ids=("j0",), combos=(2.0,)),
           scl.make_op("workerA", "take", worker="workerA", n=1),
           scl.make_op("workerA", "complete_taken", worker="workerA")]
    path = tmp_path / "script.json"
    path.write_text(json.dumps(mc.script_dump(mc.MCConfig(), ops)))
    res = mc.replay_script(json.loads(path.read_text()))
    assert res["violation"] is None and res["ops"] == 3
    assert mc.main(["--replay", str(path)]) == 0


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert mc.main(["--replay", str(bad)]) == 2
    notscript = tmp_path / "notscript.json"
    notscript.write_text('{"hello": 1}')
    assert mc.main(["--replay", str(notscript)]) == 2
    assert mc.main(["--list-invariants"]) == 0
    assert mc.main(["--schedules", "12", "--substrate", "python",
                    "--format", "json"]) == 0
    out = capsys.readouterr().out
    result = json.loads(out[out.index("{"):])
    assert result["clean"] and result["schedules"] == 12


# ---------------------------------------------------------------------------
# Journal compaction and corruption edge cases
# ---------------------------------------------------------------------------

def _mini_journal(path) -> JobQueue:
    q = _queue(Journal(str(path), fsync=False))
    q.enqueue_many([
        JobRecord(id="j0", strategy="sma_crossover", grid=_grid(),
                  ohlcv=mc._panel_bytes("j0")),
        JobRecord(id="j1", strategy="sma_crossover", grid=_grid(),
                  ohlcv=mc._panel_bytes("j1")),
    ])
    got = q.take(1, "w")
    q.complete_batch([rec.id for rec, _ in got], "w")
    return q


def test_crash_between_delta_and_enqueue(tmp_path):
    p = tmp_path / "j.jsonl"
    q = _queue(Journal(str(p), fsync=False))
    base = JobRecord(id="j0", strategy="sma_crossover", grid=_grid(),
                     ohlcv=mc._panel_bytes("j0"))
    q.enqueue_many([base])
    rec2, outcome, ndig, _n = q.append_bars(
        base.panel_digest, 0, mc._panel_bytes("d", 3),
        strategy="sma_crossover", grid=_grid())
    assert outcome == "extended" and rec2 is not None
    lines = p.read_text().splitlines()
    assert json.loads(lines[-1])["ev"] == "enqueue"
    assert json.loads(lines[-2])["ev"] == "delta"
    crash = tmp_path / "crash.jsonl"
    crash.write_text("\n".join(lines[:-1]) + "\n")
    replay = Journal.replay(str(crash))
    assert ndig in replay.deltas
    assert rec2.id not in replay.jobs
    q2 = _queue()
    assert q2.restore(str(crash)) == 1
    blob = q2.payload_for_digest(ndig)
    assert blob is not None
    assert panel_store_mod.panel_digest(blob) == ndig


def test_crash_mid_compaction_leaves_original_intact(tmp_path):
    p = tmp_path / "j.jsonl"
    _mini_journal(p)._journal.close()
    (tmp_path / f"j.jsonl.compact.{os.getpid()}").write_text("garbage{")
    (tmp_path / "j.jsonl.compact.99999").write_text("garbage{")
    before = Journal.replay(str(p))
    n_before, n_after = Journal.compact(str(p))
    assert n_after <= n_before
    after = Journal.replay(str(p))
    assert set(after.pending) == set(before.pending) == {"j1"}
    assert after.completed == before.completed == {"j0"}
    assert (tmp_path / "j.jsonl.compact.99999").exists()
    assert _queue().restore(str(p)) == 1


def test_truncated_tail_skipped_interior_counted(tmp_path):
    p = tmp_path / "j.jsonl"
    _mini_journal(p)._journal.close()
    torn = tmp_path / "torn.jsonl"
    torn.write_bytes(p.read_bytes() + b'{"ev": "enqueue", "id": "to')
    replay = Journal.replay(str(torn))
    assert set(replay.jobs) == {"j0", "j1"}
    assert replay.corrupt_lines == 0
    lines = p.read_text().splitlines()
    lines[0] = '{"ev": "enqueue", "id": "j0", CORRUPT'
    hurt = tmp_path / "hurt.jsonl"
    hurt.write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalCorruptError):
        Journal.replay(str(hurt))
    loose = Journal.replay(str(hurt), strict=False)
    assert loose.corrupt_lines == 1
    assert "j1" in loose.jobs


def test_scenario_base_root_survives_compaction(tmp_path):
    p = tmp_path / "j.jsonl"
    q = _queue(Journal(str(p), fsync=False))
    base = JobRecord(id="A", strategy="sma_crossover", grid=_grid(),
                     ohlcv=mc._panel_bytes("A"))
    q.enqueue_many([base])
    q.enqueue_many([JobRecord(id="B", strategy="sma_crossover",
                              grid=_grid(),
                              scenario={"base": base.panel_digest,
                                        "seed": 1})])
    assert [rec.id for rec, _ in q.take(1, "w")] == ["A"]
    q.complete_batch(["A"], "w")
    q._journal.close()
    Journal.compact(str(p))
    replay = Journal.replay(str(p))
    assert set(replay.pending) == {"B"}
    mc._check_scenario_roots(replay)
    lines = [json.loads(ln) for ln in p.read_text().splitlines()]
    for rec in lines:
        if rec.get("ev") == "enqueue" and rec.get("id") == "A":
            rec.pop("ohlcv_b64", None)
    p.write_text("".join(json.dumps(r) + "\n" for r in lines))
    with pytest.raises(mc._Violation) as ei:
        mc._check_scenario_roots(Journal.replay(str(p)))
    assert ei.value.invariant == "scenario-base-reachability"


def test_native_step_hook_counts_crossings():
    _need("native")
    nq = native_core.NativeJobQueue()
    steps = []
    nq.step_hook = lambda name, n: steps.append((name, n))
    try:
        nq.enqueue_n(["a", "b"], [1.0, 1.0])
        got = nq.take_begin_n(2)
        nq.take_commit_n(got, "w", 0.0)
        nq.complete_n(got)
        nq.requeue_expired()
    finally:
        nq.step_hook = None
    assert [s[0] for s in steps] == ["enqueue_n", "take_begin_n",
                                     "take_commit_n", "complete_n",
                                     "requeue_expired"]
    r = mc.explore_substrate(mc.MCConfig(ops=10, seed=2, schedules=5,
                                         substrate="native"))
    assert r["native_steps"] > 0
    assert r["violations"] == []
