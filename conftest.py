"""Session set-up for every pytest run of the repo: the JAX package's native
core is built once, before any test module is collected.

That package's ``runtime._core.load()`` builds ``cpp/build/libdbx_core.so``
at first use with an unlocked ``cmake --build`` and memoizes a failure for
the rest of the process. Under ``pytest -n`` every worker process collects
every test module, and some modules call ``load()`` while they are
collected (``tests/test_native_core.py`` skips on it,
``tests/test_mc_clean.py`` parametrizes on it). In a checkout without
``cpp/build/`` the workers then build at once: one that loses the race
collects other tests than its peers, and pytest-xdist stops the whole run
before any test runs.

Here each process takes an ``fcntl`` lock on ``cpp/build.lock`` and runs
that package's own loader once, so the first process builds and the
others find the library fresh. The loader module is imported by its path,
under a private name: importing the package would import jax before
``tests/conftest.py`` sets its flags. Nothing else of the package runs
here, and a missing toolchain (or ``DBX_NO_NATIVE=1``) leaves the run as
it was: every process then finds no library, alike.
"""

import fcntl
import importlib.util
import os

_ROOT = os.path.dirname(os.path.abspath(__file__))
_LOADER = os.path.join(_ROOT, "distributed_backtesting_exploration_tpu",
                       "runtime", "_core.py")


def pytest_configure(config):
    if not (os.path.exists(_LOADER)
            and os.path.isdir(os.path.join(_ROOT, "cpp"))):
        return
    spec = importlib.util.spec_from_file_location("_dbx_native_prebuild",
                                                  _LOADER)
    loader = importlib.util.module_from_spec(spec)
    with open(os.path.join(_ROOT, "cpp", "build.lock"), "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            spec.loader.exec_module(loader)
            loader.load()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
