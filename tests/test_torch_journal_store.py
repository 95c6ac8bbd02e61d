"""The port's journal writer and panel store against the reference's.

- The same queue history (enqueue, takes, completions, a duplicate, a
  failure, a requeue, an append chain) journaled by each package's
  ``JobQueue`` gives the same lines, on either state substrate.
- Each package's ``JobQueue.restore`` reads the other's journal to the
  same pending, completed and failed sets and the same append chain.
- ``Journal.compact`` rewrites one journal to the same lines.
- ``PanelStore`` evicts as the reference's does.

Trace ids are minted at random at enqueue and an append job's id is a
``uuid4``; both are replaced by their order of first appearance before
the lines are compared. Everything else is compared byte for byte.
"""

import json
import shutil

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu import obs as ref_obs
from distributed_backtesting_exploration_tpu.rpc import (
    dispatcher as ref_disp, journal as ref_journal,
    panel_store as ref_store)
from distributed_backtesting_exploration_tpu_torch import obs as port_obs
from distributed_backtesting_exploration_tpu_torch.rpc import (
    dispatcher as port_disp, journal as port_journal,
    panel_store as port_store)
from distributed_backtesting_exploration_tpu_torch.runtime import _core
from distributed_backtesting_exploration_tpu_torch.utils import data

GRID = {"fast": np.float32([3, 4]), "slow": np.float32([10, 12])}
PKGS = {"ref": (ref_disp, ref_journal), "port": (port_disp, port_journal)}


def _panel(seed: int, n_bars: int = 64) -> tuple[bytes, object]:
    full = data.synthetic_ohlcv(1, n_bars + 8, seed=seed)
    head = data.OHLCV(*(np.asarray(f[0, :n_bars]) for f in full))
    tail = data.OHLCV(*(np.asarray(f[0, n_bars:]) for f in full))
    return data.to_wire_bytes(head), data.to_wire_bytes(tail)


def _queue(disp, journal, path, native):
    """A queue journaling to ``path``; the reference's always on its
    pure-Python substrate (its own tests hold that to its native core,
    whose cmake build would race other test processes here)."""
    kw = {"device": "cpu"} if disp is port_disp else {}
    return disp.JobQueue(journal.Journal(path),
                         use_native=native and disp is port_disp, **kw)


def _records(disp, tmp_path) -> list:
    recs = []
    for i in range(6):
        blob, _ = _panel(i)
        recs.append(disp.JobRecord(
            id=f"job-{i}", strategy="sma_crossover", grid=GRID, cost=1e-3,
            ohlcv=blob, tenant="whale" if i == 4 else "default",
            top_k=2 if i == 5 else 0,
            rank_metric="sharpe" if i == 5 else ""))
    blob, _ = _panel(9)
    f = tmp_path / "panel9.dbx1"
    f.write_bytes(blob)
    recs.append(disp.JobRecord(id="job-file", strategy="sma_crossover",
                               grid=GRID, path=str(f)))
    recs.append(disp.JobRecord(id="job-missing", strategy="sma_crossover",
                               grid=GRID, path=str(tmp_path / "nope.csv")))
    recs.append(disp.JobRecord(id="job-wf", strategy="sma_crossover",
                               grid=GRID, ohlcv=_panel(0)[0], wf_train=20,
                               wf_test=10, wf_metric="sharpe"))
    return recs


def _history(disp, journal, path, tmp_path, native) -> object:
    q = _queue(disp, journal, path, native)
    q.enqueue_many(_records(disp, tmp_path))
    a = q.take(3, "w1")
    q.complete_batch([r.id for r, _ in a[:2]], "w1")
    q.complete(a[0][0].id, "w1")              # duplicate
    q.requeue_worker("w1")
    b = q.take(5, "w2")
    q.complete_batch([r.id for r, _ in b], "w2")
    base, delta = _panel(0)
    digest = port_store.panel_digest(base)
    rec, outcome, ndig, _ = q.append_bars(
        digest, 64, delta, strategy="sma_crossover", grid=GRID, cost=1e-3)
    assert outcome == "extended" and rec is not None
    q.append_bars(digest, 63, delta, strategy="sma_crossover", grid=GRID)
    q.append_bars("0" * 32, 64, delta, strategy="sma_crossover", grid=GRID)
    c = q.take(2, "w3")
    q.complete_batch([r.id for r, _ in c[:1]], "w3")
    q._journal.close()
    return q


def _canon_lines(path) -> list:
    ids: dict = {}
    out = []
    with open(path) as fh:
        for ln in fh:
            rec = json.loads(ln)
            for k in ("trace", "id"):
                v = rec.get(k)
                if v and (k == "trace" or len(v) == 36):
                    rec[k] = ids.setdefault(v, f"{k}{len(ids)}")
            out.append(rec)
    return out


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_writer_lines_match_the_reference(tmp_path, native):
    # The native substrate needs g++ to build ``libdbx_core.so``.
    assert not native or _core.available()
    lines = {}
    for name, (disp, journal) in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        _history(disp, journal, str(path), tmp_path, native)
        lines[name] = _canon_lines(path)
    assert lines["port"] == lines["ref"]
    evs = [r["ev"] for r in lines["port"]]
    assert {"enqueue", "complete", "fail", "digest", "delta"} <= set(evs)


def _state_of(q) -> dict:
    st = q.stats()
    return {"pending": st["jobs_pending"], "completed": sorted(
        q.completed_ids()), "failed": st["jobs_failed"],
        "chain": sorted(q._delta_chain),
        "known_paths": sorted(q.known_paths),
        "journaled": q.journaled_jobs}


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port")])
@pytest.mark.parametrize("compact", [False, True])
def test_restore_reads_the_other_packages_journal(tmp_path, writer, reader,
                                                  compact):
    disp, journal = PKGS[writer]
    src = tmp_path / "q.jsonl"
    _history(disp, journal, str(src), tmp_path, False)
    if compact:
        PKGS[writer][1].Journal.compact(str(src))
    states = {}
    for name in (writer, reader):
        path = tmp_path / f"copy-{name}.jsonl"
        shutil.copy(src, path)
        rdisp, rjournal = PKGS[name]
        q = _queue(rdisp, rjournal, str(path), False)
        n = q.restore(str(path))
        states[name] = (n, _state_of(q))
        # The restored queue serves the pending jobs it restored.
        taken = q.take(16, "after-restart")
        states[name] += (sorted(r.id for r, _ in taken),
                         sorted(port_store.panel_digest(p)
                                for _, p in taken if p),)
        q._journal.close()
    assert states[reader] == states[writer]
    assert states[reader][0] > 0


@pytest.mark.parametrize("extra", ["", "torn", "dups"])
def test_compact_gives_the_reference_lines(tmp_path, extra):
    src = tmp_path / "q.jsonl"
    _history(ref_disp, ref_journal, str(src), tmp_path, False)
    with open(src, "a") as fh:
        if extra == "dups":
            first = src.read_text().splitlines()[0]
            fh.write(first + "\n" + json.dumps(
                {"ev": "complete", "id": "job-0", "worker": "w9"}) + "\n")
        elif extra == "torn":
            fh.write('{"ev": "complete", "id": "jo')
    out = {}
    for name, (_, journal) in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        shutil.copy(src, path)
        counts = journal.Journal.compact(str(path))
        out[name] = (counts, path.read_text())
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("text", [
    '{"ev":"enqueue","id":"a"}\n{bad\n{"ev":"complete","id":"a"}\n',
    '{"ev":"enqueue","id":"a"}\n{"ev":"complete","id":"a"}\n{torn',
    ''])
@pytest.mark.parametrize("strict", [True, False])
def test_replay_of_damaged_journals_matches_the_reference(tmp_path, text,
                                                          strict):
    p = tmp_path / "j.jsonl"
    p.write_text(text)
    got = []
    for _, journal in PKGS.values():
        try:
            st = journal.Journal.replay(str(p), strict=strict)
            got.append(("ok", st.jobs, st.completed, st.failed,
                        st.corrupt_lines, st.total_lines, st.pending))
        except journal.JournalCorruptError as e:
            got.append(("corrupt", str(e)))
    assert got[1] == got[0]


def test_journal_counts_into_the_registry(tmp_path):
    reg = port_obs.get_registry()
    before = reg.counter("dbx_journal_appends_total").value
    j = port_journal.Journal(str(tmp_path / "j.jsonl"))
    seen = []
    j.crash_hook = lambda when, ev, rec: seen.append((when, ev))
    j.append("enqueue", id="a")
    j.append("complete", id="a", worker="w")
    j.close()
    assert reg.counter("dbx_journal_appends_total").value == before + 2
    assert seen == [("pre", "enqueue"), ("post", "enqueue"),
                    ("pre", "complete"), ("post", "complete")]
    assert not port_journal.Journal(None).enabled


def _store_history(store_mod, obs_mod, ops) -> list:
    reg = obs_mod.Registry()
    s = store_mod.PanelStore(max_bytes=1000, registry=reg)
    out = []
    for op, arg in ops:
        if op == "put":
            out.append(s.put(arg))
        elif op == "get":
            out.append(s.get(arg))
        elif op == "bound":
            s.max_bytes = arg
        out.append((s.stats(), s.evictions, arg in s if op == "get"
                    else None))
    out.append(sorted((k, v) for k, v in reg.summaries().items()
                      if k.startswith("dbx_panel_store")))
    out.append(s._lru.sizes())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_panel_store_eviction_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    blobs = [bytes(rng.integers(0, 255, size=int(n), dtype=np.uint8))
             for n in rng.integers(50, 700, size=10)]
    digests = [port_store.panel_digest(b) for b in blobs]
    ops = []
    for _ in range(60):
        r = rng.random()
        i = int(rng.integers(len(blobs)))
        if r < 0.45:
            ops.append(("put", blobs[i]))
        elif r < 0.95:
            ops.append(("get", digests[i]))
        else:
            ops.append(("bound", int(rng.integers(300, 2000))))
    got = [_store_history(m, o, ops)
           for m, o in ((ref_store, ref_obs), (port_store, port_obs))]
    assert got[1] == got[0]


@pytest.mark.parametrize("mb", [None, "1", "0.5"])
def test_store_bound_knob_matches_the_reference(monkeypatch, mb):
    if mb is None:
        monkeypatch.delenv("DBX_PANEL_STORE_MB", raising=False)
    else:
        monkeypatch.setenv("DBX_PANEL_STORE_MB", mb)
    assert port_store.store_max_bytes() == ref_store.store_max_bytes()
    assert (port_store.PanelStore(registry=port_obs.Registry()).max_bytes
            == port_store.store_max_bytes())
