"""Strategy API and registry (mirrors the reference's ``models/base.py``).

A strategy maps OHLCV tensors and a parameter set to a position series in
``[-1, 1]``. Where the reference vmaps a scalar parameter set, the port
passes every parameter as a tensor that broadcasts against the series: the
sweep engine hands ``(P, 1)`` parameter columns and ``(N, 1, T)`` fields,
and the strategy returns ``(N, P, T)`` positions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

ParamSet = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """A named, registrable strategy.

    Attributes:
        name: registry key (also the wire-level strategy id in JobSpec).
        param_fields: ordered names of the parameters it consumes.
        positions_fn: ``(ohlcv, params) -> (..., T)`` target-exposure series.
        stateful: True if positions carry path dependence.
    """

    name: str
    param_fields: tuple[str, ...]
    positions_fn: Callable[[object, ParamSet], torch.Tensor]
    stateful: bool = False

    def positions(self, ohlcv, params: ParamSet) -> torch.Tensor:
        missing = [f for f in self.param_fields if f not in params]
        if missing:
            raise KeyError(f"strategy {self.name!r} missing params {missing}")
        return self.positions_fn(ohlcv, params)


_REGISTRY: dict[str, Strategy] = {}


def register(strategy: Strategy) -> Strategy:
    """Register a strategy under its name (last registration wins)."""
    _REGISTRY[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> Strategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {sorted(_REGISTRY)}") from None


def available_strategies() -> list[str]:
    return sorted(_REGISTRY)
