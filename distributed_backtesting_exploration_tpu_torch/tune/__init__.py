"""tune/: the port's autotuner, schedule registry and fleet compile cache
(the reference's ``tune/``).

- :mod:`.registry` / :mod:`.autotune`: measure the substrate candidates
  once per (kernel family, shape bucket with the group's rows, platform)
  on the card, record the
  winner in a journal (``DBX_SCHEDULE_DIR``), gossip it through the
  dispatcher (``JobsRequest.schedule_json`` up, ``StatsReply.schedule_json``
  down). The sweeps resolve each knob as explicit argument > env > tuned
  schedule > default (``ops/fused.py``); on Hopper the knobs that select
  other code are the tile entries' CTA width and the page size.
- :mod:`.compile_cache`: the ``nvcc``-built kernel libraries as a cache
  directory, offered to and fetched from the dispatcher's store
  (``OfferCompiled``/``FetchCompiled``), so a cold worker skips the builds
  a peer already paid for.
"""

from .autotune import (Autotuner, autotune_mode, autotune_trials,
                       candidate_space, modeled_cost)
from .compile_cache import (CacheSync, CompileStore, attach, configure,
                            default_cache_dir, entry_key)
from .registry import (ScheduleRegistry, entry_line, group_bucket,
                       schedule_dir, shape_bucket)

__all__ = [
    "Autotuner", "CacheSync", "CompileStore", "ScheduleRegistry",
    "attach", "autotune_mode", "autotune_trials", "candidate_space",
    "configure", "default_cache_dir", "entry_key", "entry_line",
    "group_bucket", "modeled_cost", "schedule_dir", "shape_bucket",
]
