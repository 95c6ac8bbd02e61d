"""Streaming backtests: persistable carry checkpoints and O(ΔT) appends
(the reference's ``streaming`` package).

The cold sweep runs the scan form over the full T-bar panel once and
leaves a per-(panel digest, strategy, param block)
:class:`~.recurrent.StreamCarry`; each appended ΔT-bar slice then advances
that carry with the recurrent form (:func:`~.recurrent.append_step`) in
O(ΔT) work, with no full reprice. :class:`~.store.CarryStore` keeps the
carries by digest on the device, with a serialized host level that
outlives a device-level eviction.
"""

from .delta import metric_delta  # noqa: F401
from .recurrent import (  # noqa: F401
    StreamCarry, append_step, build_carry, carry_from_bytes, carry_to_bytes,
    finalize, stream_fields, stream_key, supports_strategy, tail_bars)
from .store import CarryStore, carry_cache_max_bytes  # noqa: F401
