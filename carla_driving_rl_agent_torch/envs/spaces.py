"""Observation and action space descriptions.

Counterpart of carla_driving_rl_agent_tpu/envs/spaces.py: the reference
declares its contracts with `gym.spaces` (Box, Dict, MultiDiscrete,
Discrete; core/carla_env.py:18-24); these small dataclasses carry the same
information (bounds, shape, dtype), `sample` from an explicit numpy
generator and `contains`, and flatten into the spec dicts the agent
consumes (reference rl/utils.py:212-271).  They describe one world; the
env's tensors carry a leading (B,) axis of worlds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict as DictT

import numpy as np


class Space:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


@dataclass
class Box(Space):
    low: np.ndarray
    high: np.ndarray
    shape: tuple = None
    dtype: type = np.float32

    def __post_init__(self):
        if self.shape is None:
            self.shape = np.broadcast(np.asarray(self.low), np.asarray(self.high)).shape
        self.low = np.broadcast_to(np.asarray(self.low, dtype=self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(self.high, dtype=self.dtype), self.shape)

    def sample(self, rng: np.random.Generator):
        low = np.where(np.isfinite(self.low), self.low, -1.0)
        high = np.where(np.isfinite(self.high), self.high, 1.0)
        return rng.uniform(low, high, size=self.shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= self.low - 1e-6) and np.all(x <= self.high + 1e-6))

    def is_bounded(self) -> bool:
        return bool(np.all(np.isfinite(self.low)) and np.all(np.isfinite(self.high)))


@dataclass
class Discrete(Space):
    n: int
    shape: tuple = ()
    dtype: type = np.int32

    def sample(self, rng: np.random.Generator):
        return int(rng.integers(0, self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n


@dataclass
class MultiDiscrete(Space):
    nvec: np.ndarray = None

    def __post_init__(self):
        self.nvec = np.asarray(self.nvec, dtype=np.int32)
        self.shape = self.nvec.shape

    def sample(self, rng: np.random.Generator):
        return (rng.random(self.nvec.shape) * self.nvec).astype(np.int32)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= 0) and np.all(x < self.nvec))


@dataclass
class Dict(Space):
    spaces: DictT[str, Space] = field(default_factory=dict)

    def __init__(self, spaces=None, **kwargs):
        self.spaces = dict(spaces or {})
        self.spaces.update(kwargs)

    def sample(self, rng: np.random.Generator):
        return {k: s.sample(rng) for k, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return isinstance(x, dict) and all(k in x and s.contains(x[k]) for k, s in self.spaces.items())

    def items(self):
        return self.spaces.items()

    def keys(self):
        return self.spaces.keys()

    def __getitem__(self, k):
        return self.spaces[k]

    def __contains__(self, k):
        return k in self.spaces


def space_to_flat_spec(space: Space, name: str = "state") -> DictT[str, tuple]:
    """Flatten a (possibly nested) space into {name: shape} like the
    reference's gym-space->spec conversion (reference `rl/utils.py:212-271`)."""
    spec: DictT[str, tuple] = {}
    if isinstance(space, Dict):
        for k, sub in space.spaces.items():
            spec.update(space_to_flat_spec(sub, name=f"{name}_{k}"))
    elif isinstance(space, Box):
        spec[name] = tuple(space.shape)
    elif isinstance(space, MultiDiscrete):
        spec[name] = tuple(space.shape)
    elif isinstance(space, Discrete):
        spec[name] = (1,)
    else:
        raise TypeError(f"Unsupported space {space!r}")
    return spec
