"""ctypes bindings to the native runtime core (``libdbx_core.so``), the
reference's ``runtime/_core.py``, and the builds of the port's two native
binaries.

The boundary is a plain C ABI loaded with ctypes (see ``cpp/dbx_core.h``
for the contract). The port reads the shared ``cpp/`` sources in place and
builds the library alone, with one direct ``g++`` command, into the
package's ``_build/`` directory on first use; it never writes ``cpp/build/``
and never runs the cmake build, whose shell target drives the JAX engine.
Every consumer degrades to the pure-Python path when :func:`load` returns
None (no compiler), so the host code stays functional on machines without
one.

:func:`build_worker_shell` builds the port's native worker shell
(``csrc/worker_native.cc`` with ``cpp/dbx_core.cc`` compiled in, and the
C++ of the port's ``rpc/backtesting.proto`` where ``protoc`` and
libprotobuf are found) into ``_build/dbx_worker_native``;
:func:`build_core_bench` builds ``cpp/dbx_core_bench.cc`` into
``_build/dbx_core_bench``. Each is one ``g++`` command run under an
``fcntl`` lock on a file in ``_build/``, into a temporary name renamed
into place: processes that build at once wait for the first, and none
executes a binary being written. A binary is built again only when the
key beside it (``<binary>.key``: a hash of its sources, and for the shell
of the interpreter and the protobuf toolchain it was built against)
differs from this build's. Without ``g++`` or a python-config of the
running interpreter, or where a build fails (``protoc`` and the link
against libprotobuf included, once they are found), they raise
:class:`ToolchainError`.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

log = logging.getLogger("dbx.runtime")

_PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
_CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libdbx_core.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


class _Ohlcv(ctypes.Structure):
    _fields_ = [
        ("n_bars", ctypes.c_uint32),
        ("open", ctypes.POINTER(ctypes.c_float)),
        ("high", ctypes.POINTER(ctypes.c_float)),
        ("low", ctypes.POINTER(ctypes.c_float)),
        ("close", ctypes.POINTER(ctypes.c_float)),
        ("volume", ctypes.POINTER(ctypes.c_float)),
    ]


def _build() -> bool:
    """Compile ``cpp/dbx_core.cc`` alone into ``_LIB_PATH``. Runs under
    :func:`load`'s module lock, which serializes the once-per-process
    build; the library is written under a temporary name and renamed into
    place, so a process of another test worker that builds at the same
    time never loads a half-written file."""
    src = os.path.join(_CPP_DIR, "dbx_core.cc")
    if not os.path.exists(src) or not shutil.which("g++"):
        return False
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        # dbxlint: disable=lock-blocking -- build-serialization lock
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # dbxlint: disable=lock-blocking -- build-serialization lock
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native core build failed: %s", e)
        if os.path.exists(tmp):
            os.remove(tmp)
    return False


_PRUNED_CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)


class _JobqStats(ctypes.Structure):
    _fields_ = [
        ("pending", ctypes.c_int64),
        ("leased", ctypes.c_int64),
        ("completed", ctypes.c_int64),
        ("requeued", ctypes.c_int64),
        ("failed", ctypes.c_int64),
        ("combos_done", ctypes.c_double),
    ]


def _stale() -> bool:
    """True when the .so is missing or older than the core's sources."""
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    for name in ("dbx_core.cc", "dbx_core.h"):
        src = os.path.join(_CPP_DIR, name)
        if os.path.exists(src) and os.path.getmtime(src) > lib_mtime:
            return True
    return False


SHELL_PATH = os.path.join(_BUILD_DIR, "dbx_worker_native")
CORE_BENCH_PATH = os.path.join(_BUILD_DIR, "dbx_core_bench")
_SHELL_SRC = os.path.join(_PKG_DIR, "csrc", "worker_native.cc")
_PROTO = os.path.join(_PKG_DIR, "rpc", "backtesting.proto")
_PROTO_DIR = os.path.join(_BUILD_DIR, "proto")


class ToolchainError(RuntimeError):
    """A native binary could not be built (no compiler, or it failed)."""


@contextlib.contextmanager
def _build_lock(name: str):
    """An exclusive ``fcntl`` lock on ``_build/.<name>.lock``, across
    processes and threads."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, f".{name}.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build_key(srcs, *inputs) -> str:
    """A hash of the sources' bytes and the build's other inputs."""
    h = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(repr(inputs).encode())
    return h.hexdigest()[:32]


def _fresh(target: str, key: str) -> bool:
    """``target`` exists and was built with ``key``."""
    try:
        with open(f"{target}.key") as f:
            return os.path.exists(target) and f.read() == key
    except OSError:
        return False


def _stamp(target: str, key: str) -> None:
    tmp = f"{target}.key.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(key)
    os.replace(tmp, f"{target}.key")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise ToolchainError("g++ not found: the native binaries need a C++17 "
                         "compiler")
    return gxx


def _link(cmd: list, target: str) -> None:
    """Run the compiler command ``cmd`` with ``-o`` a temporary name, then
    rename the result onto ``target``."""
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        out = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise ToolchainError(f"building {os.path.basename(target)} failed "
                             f"({out.returncode}):\n{out.stderr[-4000:]}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _run_text(cmd: list) -> str | None:
    """``cmd``'s stdout, or None where it is missing or fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout if out.returncode == 0 else None


def _python_flags() -> tuple[list, list]:
    """(compile, link) flags that embed the interpreter running this
    build: ``python3-config --includes`` and ``--ldflags --embed`` of its
    own version. Raises :class:`ToolchainError` where no python-config of
    that version is found."""
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    for name in (os.path.join(sys.base_exec_prefix, "bin",
                              f"python{ver}-config"),
                 f"python{ver}-config", "python3-config"):
        inc = _run_text([name, "--includes"])
        ld = _run_text([name, "--ldflags", "--embed"])
        if inc and ld is not None and f"python{ver}" in inc:
            return inc.split(), ld.split()
    raise ToolchainError(f"no python{ver}-config found: the native shell "
                         f"embeds Python {ver}")


def _protobuf() -> tuple | None:
    """(``protoc``, its version, the ``pkg-config`` flags of libprotobuf,
    which name abseil where newer protobufs need it), or None where either
    is missing."""
    protoc = shutil.which("protoc")
    flags = _run_text(["pkg-config", "--cflags", "--libs", "protobuf"])
    if protoc is None or flags is None:
        return None
    return protoc, _run_text([protoc, "--version"]), flags.split()


def _proto_flags(protoc: str, flags: list) -> list:
    """Sources and flags of the C++ that ``protoc`` generates from the
    port's ``rpc/backtesting.proto`` into ``_build/proto/``. Raises
    :class:`ToolchainError` where ``protoc`` fails."""
    os.makedirs(_PROTO_DIR, exist_ok=True)
    out = subprocess.run(
        [protoc, f"-I{os.path.dirname(_PROTO)}", f"--cpp_out={_PROTO_DIR}",
         _PROTO], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise ToolchainError(f"protoc failed ({out.returncode}):\n"
                             f"{out.stderr[-4000:]}")
    return ["-DDBX_HAVE_PROTO", f"-I{_PROTO_DIR}",
            os.path.join(_PROTO_DIR, "backtesting.pb.cc"), *flags]


def build_worker_shell() -> str:
    """Build (where its key changed) the port's native worker shell and
    return its path, ``_build/dbx_worker_native``. Raises
    :class:`ToolchainError` without ``g++`` or when the build fails."""
    srcs = [_SHELL_SRC, _PROTO, os.path.join(_CPP_DIR, "dbx_core.cc"),
            os.path.join(_CPP_DIR, "dbx_core.h")]
    with _build_lock("dbx_worker_native"):
        inc, ld = _python_flags()
        protobuf = _protobuf()
        key = _build_key(srcs, sys.executable, inc, ld, protobuf)
        if _fresh(SHELL_PATH, key):
            return SHELL_PATH
        gxx = _gxx()
        base = [gxx, "-O2", "-std=c++17", "-pthread", "-rdynamic",
                f"-I{_CPP_DIR}", *inc,
                f'-DDBX_PYTHON_EXE="{sys.executable}"',
                _SHELL_SRC, srcs[2]]
        tail = [*ld, *(f"-Wl,-rpath,{f[2:]}" for f in ld
                       if f.startswith("-L"))]
        proto = (_proto_flags(protobuf[0], protobuf[2])
                 if protobuf is not None else [])
        _link(base + proto + tail, SHELL_PATH)
        _stamp(SHELL_PATH, key)
        return SHELL_PATH


def build_core_bench() -> str:
    """Build (where its sources changed) ``cpp/dbx_core_bench.cc``, the job
    queue's state machine timed at its C-ABI grain, and return its path,
    ``_build/dbx_core_bench``. Raises :class:`ToolchainError` without ``g++``
    or when the build fails."""
    srcs = [os.path.join(_CPP_DIR, n)
            for n in ("dbx_core_bench.cc", "dbx_core.cc", "dbx_core.h")]
    with _build_lock("dbx_core_bench"):
        key = _build_key(srcs)
        if not _fresh(CORE_BENCH_PATH, key):
            _link([_gxx(), "-O2", "-std=c++17", "-pthread",
                   f"-I{_CPP_DIR}", srcs[0], srcs[1]], CORE_BENCH_PATH)
            _stamp(CORE_BENCH_PATH, key)
        return CORE_BENCH_PATH


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dbx_csv_decode.restype = ctypes.c_int
    lib.dbx_csv_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_Ohlcv),
        ctypes.c_char_p, ctypes.c_size_t]
    lib.dbx_wire_decode.restype = ctypes.c_int
    lib.dbx_wire_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_Ohlcv),
        ctypes.c_char_p, ctypes.c_size_t]
    lib.dbx_ohlcv_to_wire.restype = ctypes.c_size_t
    lib.dbx_ohlcv_to_wire.argtypes = [
        ctypes.POINTER(_Ohlcv), ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.dbx_ohlcv_free.argtypes = [ctypes.POINTER(_Ohlcv)]
    lib.dbx_bytes_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.dbx_queue_new.restype = ctypes.c_void_p
    lib.dbx_queue_new.argtypes = [ctypes.c_size_t]
    lib.dbx_queue_push.restype = ctypes.c_int
    lib.dbx_queue_push.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int64]
    lib.dbx_queue_push_front.restype = ctypes.c_int
    lib.dbx_queue_push_front.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int64]
    lib.dbx_queue_pop.restype = ctypes.c_int
    lib.dbx_queue_pop.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int64]
    lib.dbx_queue_close.argtypes = [ctypes.c_void_p]
    lib.dbx_queue_size.restype = ctypes.c_size_t
    lib.dbx_queue_size.argtypes = [ctypes.c_void_p]
    lib.dbx_queue_free.argtypes = [ctypes.c_void_p]
    lib.dbx_jobq_new.restype = ctypes.c_void_p
    lib.dbx_jobq_new.argtypes = []
    lib.dbx_jobq_free.argtypes = [ctypes.c_void_p]
    lib.dbx_jobq_register.restype = ctypes.c_int
    lib.dbx_jobq_register.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double]
    lib.dbx_jobq_push_pending.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dbx_jobq_mark_completed.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dbx_jobq_mark_failed.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dbx_jobq_take_begin.restype = ctypes.c_int
    lib.dbx_jobq_take_begin.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.dbx_jobq_take_commit.restype = ctypes.c_int
    lib.dbx_jobq_take_commit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64]
    lib.dbx_jobq_fail.restype = ctypes.c_int
    lib.dbx_jobq_fail.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dbx_jobq_complete.restype = ctypes.c_int
    lib.dbx_jobq_complete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dbx_jobq_enqueue_n.restype = ctypes.c_int
    lib.dbx_jobq_enqueue_n.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.dbx_jobq_take_begin_idx_n.restype = ctypes.c_int
    lib.dbx_jobq_take_begin_idx_n.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.dbx_jobq_take_commit_idx_n.restype = ctypes.c_int
    lib.dbx_jobq_take_commit_idx_n.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    lib.dbx_jobq_complete_idx_n.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.dbx_jobq_requeue_expired.restype = ctypes.c_int
    lib.dbx_jobq_requeue_expired.argtypes = [
        ctypes.c_void_p, _PRUNED_CB, ctypes.c_void_p]
    lib.dbx_jobq_requeue_worker.restype = ctypes.c_int
    lib.dbx_jobq_requeue_worker.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _PRUNED_CB, ctypes.c_void_p]
    lib.dbx_jobq_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_JobqStats)]
    lib.dbx_jobq_drained.restype = ctypes.c_int
    lib.dbx_jobq_drained.argtypes = [ctypes.c_void_p]
    lib.dbx_registry_new.restype = ctypes.c_void_p
    lib.dbx_registry_new.argtypes = [ctypes.c_int64]
    lib.dbx_registry_touch.restype = ctypes.c_int
    lib.dbx_registry_touch.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dbx_registry_prune.restype = ctypes.c_int
    lib.dbx_registry_prune.argtypes = [
        ctypes.c_void_p, _PRUNED_CB, ctypes.c_void_p]
    lib.dbx_registry_alive.restype = ctypes.c_int
    lib.dbx_registry_alive.argtypes = [ctypes.c_void_p]
    lib.dbx_registry_free.argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native core; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # dbxlint: disable=trace-time-env -- kill switch, read at first load
        if os.environ.get("DBX_NO_NATIVE") == "1":
            return None
        if _stale() and not _build():
            log.info("native core unavailable; using pure-Python paths")
            return None
        try:
            _lib = _bind(ctypes.CDLL(_LIB_PATH))
        except AttributeError as e:
            # A prebuilt/copied .so whose mtime passes _stale() but predates
            # the current C ABI (missing symbol). Rebuild once from source,
            # then degrade gracefully like any other load failure.
            log.warning("stale ABI in %s (%s); rebuilding", _LIB_PATH, e)
            try:
                os.remove(_LIB_PATH)
            except OSError:
                pass
            _lib = None
            if _build():
                try:
                    _lib = _bind(ctypes.CDLL(_LIB_PATH))
                except (OSError, AttributeError) as e2:
                    log.warning("rebuild of %s did not load: %s",
                                _LIB_PATH, e2)
                    _lib = None
        except OSError as e:
            log.warning("failed to load %s: %s", _LIB_PATH, e)
            _lib = None
        return _lib


def available() -> bool:
    return load() is not None


def _take_fields(lib, o: _Ohlcv) -> tuple[np.ndarray, ...]:
    n = int(o.n_bars)
    out = tuple(
        np.ctypeslib.as_array(getattr(o, f), shape=(n,)).copy()
        for f in ("open", "high", "low", "close", "volume"))
    lib.dbx_ohlcv_free(ctypes.byref(o))
    return out


def csv_decode(data: bytes) -> tuple[np.ndarray, ...]:
    """Native CSV -> five float32 ``(T,)`` arrays. Raises ValueError."""
    lib = load()
    if lib is None:
        raise RuntimeError("native core not available")
    o = _Ohlcv()
    err = ctypes.create_string_buffer(256)
    rc = lib.dbx_csv_decode(data, len(data), ctypes.byref(o), err, len(err))
    if rc != 0:
        raise ValueError(err.value.decode() or "native CSV decode failed")
    return _take_fields(lib, o)


def wire_decode(data: bytes) -> tuple[np.ndarray, ...]:
    """Native DBX1 -> five float32 ``(T,)`` arrays. Raises ValueError."""
    lib = load()
    if lib is None:
        raise RuntimeError("native core not available")
    o = _Ohlcv()
    err = ctypes.create_string_buffer(256)
    rc = lib.dbx_wire_decode(data, len(data), ctypes.byref(o), err, len(err))
    if rc != 0:
        raise ValueError(err.value.decode() or "native wire decode failed")
    return _take_fields(lib, o)


class NativeQueue:
    """Bounded MPMC byte-blob queue backed by the C++ core.

    Mirrors the semantics of the worker's channel substrate; used by tests to
    validate the native queue and available as a drop-in for byte payloads.
    """

    def __init__(self, capacity: int = 1024):
        lib = load()
        if lib is None:
            raise RuntimeError("native core not available")
        self._lib = lib
        self._h = lib.dbx_queue_new(capacity)

    def push(self, data: bytes, timeout_ms: int = -1) -> bool:
        rc = self._lib.dbx_queue_push(self._h, data, len(data), timeout_ms)
        if rc == 2:
            raise ValueError("queue closed")
        return rc == 0

    def push_front(self, data: bytes, timeout_ms: int = -1) -> bool:
        """LIFO insert: the next pop returns ``data`` (requeue-at-front)."""
        rc = self._lib.dbx_queue_push_front(
            self._h, data, len(data), timeout_ms)
        if rc == 2:
            raise ValueError("queue closed")
        return rc == 0

    def pop(self, timeout_ms: int = -1) -> bytes | None:
        """None on timeout; raises ValueError once closed and drained."""
        buf = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_size_t()
        rc = self._lib.dbx_queue_pop(
            self._h, ctypes.byref(buf), ctypes.byref(ln), timeout_ms)
        if rc == 1:
            return None
        if rc == 2:
            raise ValueError("queue closed")
        out = ctypes.string_at(buf, ln.value)
        self._lib.dbx_bytes_free(buf)
        return out

    def close(self) -> None:
        self._lib.dbx_queue_close(self._h)

    def __len__(self) -> int:
        return self._lib.dbx_queue_size(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            # Close first so threads blocked in pop/push wake and return
            # before the underlying mutex/condvars are deleted. Callers are
            # responsible for joining consumers before dropping the queue.
            self._lib.dbx_queue_close(h)
            self._lib.dbx_queue_free(h)
            self._h = None


class NativeJobQueue:
    """The dispatcher's lease/tombstone/completion state machine, native.

    Owns the id-state hot path (pending FIFO, tombstone skip, lease table,
    completion idempotency, expiry/prune requeue) behind the C ABI in
    ``cpp/dbx_core.h``; callers keep the full job records (grids, payload
    paths) in Python keyed by the same ids. Method contracts mirror
    ``rpc/dispatcher.py``'s pure-Python fallback exactly — the parity tests
    in ``tests/test_rpc_unit.py`` run both substrates through the same
    scenarios. (The reference's whole dispatcher state is native, reference
    ``src/server/main.rs:20-190``; a C++ gRPC *server* is infeasible in this
    environment, so serving stays in Python and the state machine is the
    part that goes native.)
    """

    _ID_BUF = 512   # DBX_JOBQ_MAX_ID + NUL

    # Model-checker seam (analysis/modelcheck): when set, called as
    # ``step_hook(method, n)`` before each batched boundary crossing —
    # the native twin of the python substrate's per-op visibility, used
    # for transition counting/parity (the C state itself stays opaque).
    step_hook = None

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError("native core not available")
        self._lib = lib
        self._h = lib.dbx_jobq_new()
        # id<->index mirror of the core's intern table: every method that
        # can intern an id C-side interns it here in the SAME call order,
        # so the dense indices agree without ever crossing the boundary.
        self._ids: list[str] = []
        self._idx: dict[str, int] = {}

    def register(self, jid: str, combos: float) -> None:
        if self._lib.dbx_jobq_register(self._h, jid.encode(),
                                       float(combos)) != 0:
            raise ValueError(f"job id exceeds {self._ID_BUF - 1} bytes")
        self._intern(jid)

    def push_pending(self, jid: str) -> None:
        self._lib.dbx_jobq_push_pending(self._h, jid.encode())
        self._intern(jid)

    def mark_completed(self, jid: str) -> None:
        self._lib.dbx_jobq_mark_completed(self._h, jid.encode())
        self._intern(jid)

    def mark_failed(self, jid: str) -> None:
        self._lib.dbx_jobq_mark_failed(self._h, jid.encode())
        self._intern(jid)

    def take_begin(self) -> str | None:
        buf = ctypes.create_string_buffer(self._ID_BUF)
        rc = self._lib.dbx_jobq_take_begin(self._h, buf, len(buf))
        if rc == 0:
            return None
        if rc < 0:   # unreachable with this buffer; ids cap at register
            raise RuntimeError("take_begin buffer smaller than next job id")
        return buf.value.decode()

    def take_commit(self, jid: str, worker_id: str, lease_s: float) -> bool:
        """False when the job completed in the take window (not leased)."""
        rc = self._lib.dbx_jobq_take_commit(
            self._h, jid.encode(), worker_id.encode(),
            int(lease_s * 1000)) == 0
        self._intern(jid)
        return rc

    def fail(self, jid: str) -> bool:
        """False when the job completed in the take window (not failed)."""
        rc = self._lib.dbx_jobq_fail(self._h, jid.encode()) == 0
        self._intern(jid)
        return rc

    def complete(self, jid: str) -> str:
        rc = self._lib.dbx_jobq_complete(self._h, jid.encode())
        return ("new", "dup", "unknown")[rc]

    # -- batched transitions: ONE ctypes crossing per RPC-sized batch,
    # moving int32 HANDLES instead of strings (per-id string marshalling
    # made the string-keyed batch surface slower than the dict fallback).
    # The id<->index mirror lives here: the C core assigns dense indices
    # in first-registration order, and this class performs registrations
    # in the same order it appends to ``_ids``, so the index never has to
    # cross the boundary at registration time.

    def _intern(self, jid: str) -> int:
        idx = self._idx.get(jid)
        if idx is None:
            idx = self._idx[jid] = len(self._ids)
            self._ids.append(jid)
        return idx

    # Reusable per-instance scratch (every call arrives under
    # JobQueue._lock, so one set of buffers is safe): ctypes array
    # construction per call was a measurable share of the per-batch glue.
    _SCRATCH = 4096

    def _idx_buf(self, n: int, vals=None) -> "ctypes.Array":
        buf = self.__dict__.get("_idxs")
        if buf is None or len(buf) < n:
            buf = self._idxs = (ctypes.c_int32 * max(n, self._SCRATCH))()
        if vals is not None:
            buf[:n] = vals
        return buf

    def _u8_buf(self, n: int) -> "ctypes.Array":
        buf = self.__dict__.get("_u8s")
        if buf is None or len(buf) < n:
            buf = self._u8s = (ctypes.c_uint8 * max(n, self._SCRATCH))()
        return buf

    def enqueue_n(self, jids: list[str], combos: list[float]) -> None:
        """Register + push a batch in one crossing (the one call where
        the id strings DO cross — once per job lifetime). Ids pack
        NUL-separated (stride 0: the core walks strlen) — join beats any
        per-id buffer arithmetic."""
        if not jids:
            return
        if self.step_hook is not None:
            self.step_hook("enqueue_n", len(jids))
        import array as array_mod

        raws = [j.encode() for j in jids]
        if max(map(len, raws)) >= self._ID_BUF:
            raise ValueError(f"job id exceeds {self._ID_BUF - 1} bytes")
        if any(b"\0" in r for r in raws):
            # An embedded NUL would split the pack: the C side would
            # intern a truncated id while the mirror interns the full
            # one, desynchronizing every later index.
            raise ValueError("job ids must not contain NUL bytes")
        blob = b"\0".join(raws) + b"\0"
        arr = array_mod.array("d", combos)
        addr, _ = arr.buffer_info()
        # Mirror BEFORE the native call: the C side interns accepted ids
        # as a side effect, so raising between the call and the mirror
        # update would leave the id<->index translation permanently
        # desynced (every later take would return wrong ids). With the
        # mirror written first, the only divergent path is a C-side
        # reject — impossible while both sides enforce the same cap
        # (pre-validated above) — and that path raises below with the
        # substrate declared unusable rather than silently corrupt.
        idx, ids = self._idx, self._ids
        for jid in jids:            # inlined _intern: the per-id hot loop
            if jid not in idx:
                idx[jid] = len(ids)
                ids.append(jid)
        accepted = self._lib.dbx_jobq_enqueue_n(
            self._h, blob, 0,
            ctypes.cast(addr, ctypes.POINTER(ctypes.c_double)), len(jids))
        if accepted != len(jids):   # cap enforced above
            raise RuntimeError(
                "native enqueue_n rejected ids post-cap; the C intern "
                "table and the Python id mirror may now disagree — this "
                "queue instance must not be reused")

    def take_begin_n(self, n: int) -> list[str]:
        """Pop up to ``n`` live pending ids in one crossing."""
        if n <= 0:
            return []
        if self.step_hook is not None:
            self.step_hook("take_begin_n", int(n))
        out = self._idx_buf(min(int(n), 1 << 20))
        got = self._lib.dbx_jobq_take_begin_idx_n(
            self._h, out, min(int(n), len(out)))
        ids = self._ids
        return [ids[i] for i in out[:got]]

    def take_commit_n(self, jids: list[str], worker_id: str,
                      lease_s: float) -> list[bool]:
        """Lease a popped batch in one crossing; False entries completed
        in the take window (dropped, not leased)."""
        if not jids:
            return []
        if self.step_hook is not None:
            self.step_hook("take_commit_n", len(jids))
        idxs = self._idx_buf(len(jids), [self._idx[j] for j in jids])
        flags = self._u8_buf(len(jids))
        self._lib.dbx_jobq_take_commit_idx_n(
            self._h, idxs, len(jids), worker_id.encode(),
            int(lease_s * 1000), flags)
        return [bool(f) for f in flags[:len(jids)]]

    def complete_n(self, jids: list[str]) -> list[str]:
        """Record a completion batch in one crossing. Ids the queue has
        never seen (possible from a stray RPC) map to index -1, which the
        core reports "unknown"."""
        if not jids:
            return []
        if self.step_hook is not None:
            self.step_hook("complete_n", len(jids))
        get = self._idx.get
        idxs = self._idx_buf(len(jids), [get(j, -1) for j in jids])
        outcomes = self._u8_buf(len(jids))
        self._lib.dbx_jobq_complete_idx_n(
            self._h, idxs, len(jids), outcomes)
        kinds = ("new", "dup", "unknown")
        return [kinds[o] for o in outcomes[:len(jids)]]

    def _requeue(self, call, *args) -> list[str]:
        hit: list[str] = []

        @_PRUNED_CB
        def collect(jid, _ctx):
            hit.append(jid.decode())

        call(self._h, *args, collect, None)
        return hit

    def requeue_expired(self) -> list[str]:
        if self.step_hook is not None:
            self.step_hook("requeue_expired", 0)
        return self._requeue(self._lib.dbx_jobq_requeue_expired)

    def requeue_worker(self, worker_id: str) -> list[str]:
        if self.step_hook is not None:
            self.step_hook("requeue_worker", 0)
        return self._requeue(self._lib.dbx_jobq_requeue_worker,
                             worker_id.encode())

    def stats(self) -> dict:
        s = _JobqStats()
        self._lib.dbx_jobq_stats(self._h, ctypes.byref(s))
        return {"pending": int(s.pending), "leased": int(s.leased),
                "completed": int(s.completed), "requeued": int(s.requeued),
                "failed": int(s.failed), "combos_done": float(s.combos_done)}

    def drained(self) -> bool:
        return self._lib.dbx_jobq_drained(self._h) == 1

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.dbx_jobq_free(h)
            self._h = None


class NativeRegistry:
    """Peer liveness map backed by the C++ core (last-seen + windowed prune).

    Owns only the *timing* state; callers keep any per-peer metadata
    (status, capacity) in their own map keyed by the same ids.
    """

    def __init__(self, prune_window_s: float):
        lib = load()
        if lib is None:
            raise RuntimeError("native core not available")
        self._lib = lib
        self._h = lib.dbx_registry_new(int(prune_window_s * 1000))

    def touch(self, peer_id: str) -> bool:
        """Stamp alive-now; True if newly registered."""
        return self._lib.dbx_registry_touch(self._h, peer_id.encode()) == 1

    def prune(self) -> list[str]:
        """Drop peers silent past the window; return their ids."""
        dead: list[str] = []

        @_PRUNED_CB
        def collect(peer_id, _ctx):
            dead.append(peer_id.decode())

        self._lib.dbx_registry_prune(self._h, collect, None)
        return dead

    def alive(self) -> int:
        return self._lib.dbx_registry_alive(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.dbx_registry_free(h)
            self._h = None
