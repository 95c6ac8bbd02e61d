"""Native runtime layer: ctypes bindings to the C++ core (``cpp/``), the
reference's ``runtime/``.

The host substrate around the sweep (OHLCV decoding, bounded inter-thread
queues, the dispatcher's job queue and peer liveness) has a native C++
implementation, loaded here via ctypes, with the pure-Python path used
when no compiler is present.
"""

from ._core import available, csv_decode, wire_decode, NativeQueue, load  # noqa: F401
