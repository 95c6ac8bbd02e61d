"""Digest-seeded scenario synthesis (reference ``scenarios/``): synthetic
OHLCV panels that are a pure function of ``(base panel digest, generator
params)``, generated on the device from the port's own threefry
(:mod:`.threefry`, bit-exact against JAX's)."""

from .synth import (  # noqa: F401
    ScenarioParams, generate, max_bars, scenario_panel_bytes,
    scenario_seed, seed_to_int64, seed_words)
