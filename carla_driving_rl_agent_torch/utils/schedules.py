"""Dynamic step-dependent hyper-parameters (reference `rl/parameters/parameters.py`).

A copy of carla_driving_rl_agent_tpu/utils/schedules.py (plain Python; the
port imports nothing of the JAX package).  The scheduled scalar is computed
on the host and read once per update.  The step counter is advanced per episode
(`on_episode`, reference `rl/parameters/parameters.py:34-35`) and persisted
via serialize/load in the agent's config.json (reference `rl/agents/ppo.py:601-616`).
"""

from __future__ import annotations

import math
from typing import Union


class DynamicParameter:
    """A scalar hyper-parameter that may vary with the episode/update step."""

    def __init__(self):
        self.value = 0.0
        self.step = 0

    @staticmethod
    def create(value: Union[float, int, "DynamicParameter"], **kwargs) -> "DynamicParameter":
        if isinstance(value, (float, int)):
            return ConstantParameter(float(value))
        assert isinstance(value, DynamicParameter), type(value)
        return value

    def __call__(self, *args, **kwargs) -> float:
        return self.value

    def serialize(self) -> dict:
        return dict(step=int(self.step))

    def on_episode(self):
        self.step += 1

    def load(self, config: dict):
        self.step = int(config.get("step", 0))

    def get_config(self) -> dict:
        return {}


class ConstantParameter(DynamicParameter):
    def __init__(self, value: float):
        super().__init__()
        self.value = float(value)

    def serialize(self) -> dict:
        return {}


class ScheduleParameter(DynamicParameter):
    """Base for decaying schedules; evaluates at the current `step`
    and floors at `min_value` (reference ScheduleWrapper,
    `rl/parameters/parameters.py:45-58`)."""

    def __init__(self, min_value: float = 1e-4):
        super().__init__()
        self.min_value = float(min_value)

    def _compute(self, step: int) -> float:
        raise NotImplementedError

    def __call__(self, *args, **kwargs) -> float:
        self.value = max(self.min_value, self._compute(self.step))
        return self.value


class ExponentialDecay(ScheduleParameter):
    """value = initial * decay_rate^(step / decay_steps)
    (reference `rl/parameters/parameters.py:74-79`)."""

    def __init__(self, initial_value: float, decay_steps: int, decay_rate: float,
                 staircase: bool = False, min_value: float = 0.0):
        super().__init__(min_value=min_value)
        self.initial_value = float(initial_value)
        self.decay_steps = int(decay_steps)
        self.decay_rate = float(decay_rate)
        self.staircase = staircase
        self.value = self.initial_value

    def _compute(self, step: int) -> float:
        p = step / self.decay_steps
        if self.staircase:
            p = math.floor(p)
        return self.initial_value * (self.decay_rate ** p)

    def get_config(self) -> dict:
        return dict(initial_value=self.initial_value, decay_steps=self.decay_steps,
                    decay_rate=self.decay_rate, staircase=self.staircase)


class StepDecay(ExponentialDecay):
    """Staircase exponential decay (reference `rl/parameters/parameters.py:82-85`)."""

    def __init__(self, initial_value: float, decay_steps: int, decay_rate: float,
                 min_value: float = 1e-4):
        super().__init__(initial_value, decay_steps, decay_rate, staircase=True,
                         min_value=min_value)


class PolynomialDecay(ScheduleParameter):
    """Keras-style polynomial decay (reference `rl/parameters/parameters.py:88-92`)."""

    def __init__(self, initial_value: float, end_value: float, decay_steps: int,
                 power: float = 1.0, cycle: bool = False, min_value: float = 0.0):
        super().__init__(min_value=min_value)
        self.initial_value = float(initial_value)
        self.end_value = float(end_value)
        self.decay_steps = int(decay_steps)
        self.power = float(power)
        self.cycle = cycle
        self.value = self.initial_value

    def _compute(self, step: int) -> float:
        if self.cycle:
            decay_steps = self.decay_steps * max(1.0, math.ceil(step / self.decay_steps))
            frac = step / decay_steps
        else:
            frac = min(step, self.decay_steps) / self.decay_steps
        return (self.initial_value - self.end_value) * (1.0 - frac) ** self.power + self.end_value

    def get_config(self) -> dict:
        return dict(initial_value=self.initial_value, end_value=self.end_value,
                    decay_steps=self.decay_steps, power=self.power, cycle=self.cycle)


class LinearDecay(PolynomialDecay):
    def __init__(self, initial_value: float, end_value: float, decay_steps: int, **kwargs):
        super().__init__(initial_value, end_value, decay_steps, power=1.0, **kwargs)
