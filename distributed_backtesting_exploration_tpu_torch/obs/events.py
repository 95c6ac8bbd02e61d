"""Opt-in JSONL event log for post-mortem trace reconstruction.

Spans (and any layer that wants durable breadcrumbs) emit one JSON object
per line. Disabled by default — :func:`emit` is a single ``is None`` check
once initialized — and enabled either explicitly (:func:`configure`) or by
exporting ``DBX_OBS_JSONL=/path/to/events.jsonl``.

The environment variable is read LAZILY at first use, not at import
(dbxlint *import-time-config*): an import-time read froze the setting for
the process, so a harness that imported ``obs`` before deciding on a log
path could never enable logging in-process. Now ``os.environ`` is
consulted on the first :func:`emit`/:func:`enabled` call, and an explicit
:func:`configure` always wins over (and stops further consultation of)
the environment.

Unlike the dispatcher's job journal (``rpc.journal``), this log is
diagnostic, not durable state: writes are flushed but not fsync'd, and a
lost tail loses nothing but trace detail.
"""

from __future__ import annotations

import json
import os
import threading
import time

_lock = threading.Lock()
_fh = None
_path: str | None = None
# False until the first configure()/first use: emit/enabled consult
# DBX_OBS_JSONL exactly once, lazily, so in-process toggling before first
# use works and importing this module never does IO.
_env_checked = False


def configure(path: str | None) -> None:
    """Open (or with ``None``, close) the process-wide event log.

    Explicit configuration wins: after any call — even one whose open
    RAISES — the environment variable is never consulted
    (``configure(None)`` therefore disables logging even with
    ``DBX_OBS_JSONL`` set, and a failed configure must not let the env
    fallback sneak logging back on). The open happens OUTSIDE the
    module lock (dbxlint lock-blocking: a slow open — NFS, a fifo —
    must not stall every concurrent ``emit``); an unopenable path
    raises without touching the current log."""
    global _fh, _path, _env_checked
    with _lock:
        _env_checked = True
    new_fh = open(path, "a", encoding="utf-8") if path else None
    with _lock:
        if _fh is not None:
            _fh.close()
        _fh = new_fh
        _path = path if new_fh is not None else None


def _check_env() -> None:
    """First-use environment opt-in: workers/dispatchers started with
    ``DBX_OBS_JSONL`` set begin logging without any code change. A bad
    path must not kill the process — this log is diagnostic, so degrade
    to disabled with a loud warning instead. The open runs OUTSIDE the
    module lock (dbxlint lock-blocking) with a re-check under the
    second acquisition: two first-use racers may both open, the loser
    closes and adopts the winner's state."""
    global _fh, _path, _env_checked
    with _lock:
        if _env_checked:
            return
    env_path = os.environ.get("DBX_OBS_JSONL")
    fh = None
    if env_path:
        try:
            fh = open(env_path, "a", encoding="utf-8")
        except OSError as e:
            import logging

            logging.getLogger("dbx.obs").warning(
                "DBX_OBS_JSONL=%s could not be opened (%s); event logging "
                "disabled", env_path, e)
    with _lock:
        if _env_checked:
            if fh is not None:
                fh.close()
            return
        _env_checked = True
        if fh is not None:
            _fh = fh
            _path = env_path


def configured_path() -> str | None:
    if not _env_checked:
        _check_env()
    return _path


def enabled() -> bool:
    if not _env_checked:
        _check_env()
    return _fh is not None


def emit(event: str, **payload) -> None:
    """Append one event line; no-op (one attribute read) when disabled."""
    emit_record({"ev": event, **payload})


def emit_record(rec: dict) -> None:
    """Append one pre-built record (must carry ``ev``); the writer stamps
    ``ts`` (wall clock at write) and ``pid`` — the timeline analyzer merges
    logs from many processes and needs a per-process identity even when the
    emitting layer (e.g. the compute backend) does not know its worker id.
    """
    if not _env_checked:
        _check_env()
    if _fh is None:
        return
    rec = {"ts": time.time(), "pid": os.getpid(), **rec}
    line = json.dumps(rec, separators=(",", ":"), default=str)
    with _lock:
        if _fh is None:
            return
        _fh.write(line + "\n")
        _fh.flush()
