"""The compile cache of the port: the ``nvcc``-built kernel libraries,
shared across a fleet (the reference's ``tune/compile_cache.py``).

Two layers:

1. **The local cache** is the kernels' build directory
   (``ops/_kernels.py``): :func:`configure` points it at a directory
   (default :func:`default_cache_dir`: ``DBX_COMPILE_CACHE_DIR``, else the
   package's ``_build/``). A library there is named
   ``lib<name>-<16 hex>.so`` after a hash of its sources and flags, and
   ``_kernels.build`` loads a library of the name it computes without
   running ``nvcc``. A library is loaded once a process: a ``configure``
   after a library was loaded affects only the libraries loaded later.

2. **The fleet exchange** rides the dispatcher's ``OfferCompiled`` and
   ``FetchCompiled`` RPCs, the ones the JAX workers use for their XLA
   entries: a worker offers the libraries its own builds wrote
   (:meth:`CacheSync.poll_new`), fetches those it lacks and installs them
   (:meth:`CacheSync.install`) before its first build, so a cold worker
   skips the ``nvcc`` runs a peer already paid for. :class:`CompileStore`
   is the byte-bounded store of entries (the reference's, copied).

Wire keys are ``blake2b-128(file name | runtime tag)``. The port's runtime
tag folds in the torch version, ``torch.version.cuda``, the ``nvcc``
release (``nvcc none`` where there is none) and the target architecture,
and has four ``|``-separated fields where a JAX tag
(``"<jax version>|<platform>"``) has two: no key of one package is a key
of the other, so each package's :meth:`CacheSync.install` refuses the
other's entries and remembers the refusal. A library is code: only a name
of the form ``lib<name>-<16 hex>.so`` under a matching key is installed,
written to a temporary dot-name and renamed into place.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path

from .. import obs
from ..ops import _kernels

_DEFAULT_STORE_MB = 256
# Entries larger than this never cross the wire (a single pathological
# library must not evict the whole fleet store).
_MAX_ENTRY_BYTES = 64 * 1024 * 1024
# The names ops/_kernels.build gives its libraries.
_LIB_NAME = re.compile(r"^lib[A-Za-z0-9_]+-[0-9a-f]{16}\.so$")


def compile_store_max_bytes() -> int:
    """``DBX_COMPILE_CACHE_MB`` store bound (read when called, default
    256 MB)."""
    return int(float(os.environ.get("DBX_COMPILE_CACHE_MB",
                                    _DEFAULT_STORE_MB)) * 1024 * 1024)


def default_cache_dir() -> str:
    """``DBX_COMPILE_CACHE_DIR``, else the package's ``_build/``."""
    return (os.environ.get("DBX_COMPILE_CACHE_DIR")
            or str(_kernels.DEFAULT_BUILD_DIR))


def configure(path: str | None = None) -> str | None:
    """Point the kernels' build directory at ``path`` (default
    :func:`default_cache_dir`), made if missing. Returns the path, or None
    when it cannot be made (the build directory is then left as it was).
    Libraries loaded before keep their handles (``_kernels._LIBS``)."""
    path = path or default_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    _kernels.BUILD_DIR = Path(path)
    return path


def attach(registry: "obs.Registry | None" = None) -> "CacheSync | None":
    """A :class:`CacheSync` on the build directory in effect
    (``_kernels.build_dir()``: a directory already configured is kept),
    or None when it cannot be made."""
    path = str(_kernels.build_dir())
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    return CacheSync(path, registry=registry)


@functools.lru_cache(maxsize=None)
def _nvcc_release() -> str:
    """``nvcc <release>`` of the toolkit the build would use, or ``nvcc
    none`` where none is found; asked once a process."""
    try:
        out = subprocess.run([_kernels._nvcc(), "--version"],
                             capture_output=True, text=True,
                             timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "nvcc none"
    m = re.search(r"release ([0-9.]+)", out)
    return f"nvcc {m.group(1)}" if m else "nvcc none"


def _runtime_tag() -> str:
    import torch

    arch = _kernels.NVCC_FLAGS[_kernels.NVCC_FLAGS.index("-gencode") + 1]
    return (f"torch {torch.__version__}|cuda {torch.version.cuda}|"
            f"{_nvcc_release()}|{arch}")


def entry_key(name: str, runtime_tag: str | None = None) -> str:
    """Fleet wire key of one library: blake2b-128 over its file name (a
    hash of its sources and flags) and the runtime tag, so a library never
    travels to a worker of another torch, CUDA or ``nvcc`` release, nor to
    a JAX worker."""
    tag = _runtime_tag() if runtime_tag is None else runtime_tag
    return hashlib.blake2b(f"{name}|{tag}".encode(),
                           digest_size=16).hexdigest()


class CompileStore:
    """Byte-bounded LRU of fleet compile-cache entries (the reference's).

    Values are ``(name, payload)``: a worker installs an entry under its
    original file name. Thread-safe. Its size is also published as the
    gauges ``dbx_compile_store_bytes`` and ``dbx_compile_store_entries``.
    """

    def __init__(self, max_bytes: int | None = None,
                 registry: "obs.Registry | None" = None):
        from ..rpc.panel_store import ByteLRU

        self._lock = threading.Lock()
        self._lru = ByteLRU(compile_store_max_bytes()
                            if max_bytes is None else int(max_bytes),
                            nbytes_of=lambda v: len(v[1]))
        reg = registry or obs.get_registry()
        self._c_offers = reg.counter(
            "dbx_compile_offers_total",
            help="compile-cache entries accepted from workers")
        self._c_fetch = {
            outcome: reg.counter(
                "dbx_compile_fetches_total",
                help="FetchCompiled entry requests served, by outcome",
                outcome=outcome)
            for outcome in ("hit", "gone")}
        reg.gauge_fn("dbx_compile_store_bytes",
                     lambda: self.stats()["bytes"],
                     help="bytes resident in the fleet compile-cache store")
        reg.gauge_fn("dbx_compile_store_entries",
                     lambda: self.stats()["entries"],
                     help="compile-cache entries resident in the fleet "
                          "store")

    def offer(self, key: str, name: str, payload: bytes) -> bool:
        if not key or not name or not payload \
                or len(payload) > _MAX_ENTRY_BYTES:
            return False
        with self._lock:
            if key in self._lru:
                return False
            self._lru.put(key, (name, payload))
        self._c_offers.inc()
        return True

    def get(self, key: str):
        """``(name, payload)`` or None (evicted/never offered)."""
        with self._lock:
            v = self._lru.get(key)
        self._c_fetch["hit" if v is not None else "gone"].inc()
        return v

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._lru._entries.keys())

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._lru), "bytes": self._lru.bytes,
                    "evictions": self._lru.evictions,
                    "max_bytes": self._lru.max_bytes}


class CacheSync:
    """Worker-side scanner and installer of a build directory (control
    thread only).

    Counts (the ``dbx_compile_cache_{hits,misses}_total`` families):

    - ``hits{source="local"}``: libraries already there when the sync
      attached (a restart onto its own directory);
    - ``misses{source="local"}``: libraries this process's own builds
      wrote (an ``nvcc`` run paid here);
    - ``hits{source="fleet"}``: libraries installed from a peer (an
      ``nvcc`` run skipped);
    - ``misses{source="fleet"}``: libraries asked of the dispatcher that
      came back unservable.
    """

    def __init__(self, cache_dir: str | None = None,
                 registry: "obs.Registry | None" = None,
                 runtime_tag: str | None = None):
        self.cache_dir = cache_dir or default_cache_dir()
        self._tag = _runtime_tag() if runtime_tag is None else runtime_tag
        self._key_to_name: dict[str, str] = {}
        self._seen_names: set[str] = set()
        # Keys of entries this worker refused (another runtime, a JAX
        # worker's, a malformed name): remembered so missing() stops
        # asking for them on every tick.
        self._rejected_keys: set[str] = set()
        reg = registry or obs.get_registry()
        self._c = {
            (kind, source): reg.counter(
                f"dbx_compile_cache_{kind}_total",
                help=("persistent-compile-cache entries, by source "
                      "(local = this worker's own disk/compiles, fleet = "
                      "exchanged through the dispatcher)"),
                source=source)
            for kind in ("hits", "misses")
            for source in ("local", "fleet")}
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
        except OSError:
            pass
        for name, _ in self._scan():
            self._register(name)
            self._c[("hits", "local")].inc()

    def _scan(self):
        """The libraries in the directory: well-formed names only (a build
        in progress writes a dot-name; nothing else is offered)."""
        try:
            with os.scandir(self.cache_dir) as it:
                ents = [(e.name, e.stat().st_size) for e in it
                        if e.is_file() and _LIB_NAME.match(e.name)]
        except OSError:
            return []
        return sorted(ents)

    def _register(self, name: str) -> str:
        key = entry_key(name, self._tag)
        self._key_to_name[key] = name
        self._seen_names.add(name)
        return key

    def poll_new(self) -> list[tuple[str, str, bytes]]:
        """Libraries written since the last poll (this process's builds)
        as ``(key, name, payload)`` offers, counted as local misses."""
        out = []
        for name, size in self._scan():
            if name in self._seen_names or size > _MAX_ENTRY_BYTES:
                continue
            try:
                with open(os.path.join(self.cache_dir, name), "rb") as fh:
                    payload = fh.read()
            except OSError:
                continue
            key = self._register(name)
            self._c[("misses", "local")].inc()
            out.append((key, name, payload))
        return out

    def unmark(self, entries) -> None:
        """Forget offers whose RPC never reached the dispatcher, so the
        next poll offers them again."""
        for key, name, _payload in entries:
            self._seen_names.discard(name)
            self._key_to_name.pop(key, None)

    def missing(self, known_keys) -> list[str]:
        """The keys of a fleet listing this worker neither holds nor has
        refused."""
        return [k for k in known_keys
                if k and k not in self._key_to_name
                and k not in self._rejected_keys]

    def install(self, entries) -> int:
        """Write fetched ``(key, name, payload)`` entries into the
        directory (a temporary dot-name, then ``os.replace``); the next
        ``_kernels.build`` of that library loads it. Refuses, and
        remembers, an entry whose name is not ``lib<name>-<16 hex>.so`` or
        whose key is not this runtime's for that name. Returns the entries
        installed, each counted as a fleet hit."""
        n = 0
        for key, name, payload in entries:
            if name in self._seen_names:
                continue
            if (not name or not payload or not _LIB_NAME.match(name)
                    or key != entry_key(name, self._tag)):
                if len(self._rejected_keys) > 1 << 16:
                    self._rejected_keys.clear()
                self._rejected_keys.add(key)
                continue
            dest = os.path.join(self.cache_dir, name)
            try:
                fd, tmp = tempfile.mkstemp(dir=self.cache_dir,
                                           prefix=".dbx_fetch_")
                with os.fdopen(fd, "wb") as fh:
                    fh.write(payload)
                os.replace(tmp, dest)
            except OSError:
                continue
            self._register(name)
            self._c[("hits", "fleet")].inc()
            n += 1
        return n

    def count_fleet_misses(self, n: int) -> None:
        if n > 0:
            self._c[("misses", "fleet")].inc(n)
