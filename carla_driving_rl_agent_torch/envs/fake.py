"""FakeCARLAEnvironment: build and summarise agents without a simulation.

Counterpart of carla_driving_rl_agent_tpu/envs/fake.py (reference
core/carla_agent.py:26-52): the CARLA observation and action spaces with
no-op step and reset, for constructing networks without a running world
(reference README.md:56-62).
"""

from __future__ import annotations

import torch

from carla_driving_rl_agent_torch.envs import spaces


class FakeCARLAEnvironment:
    """The spaces of CARLAEnv; no-op dynamics."""

    def __init__(self, time_horizon: int = 4, image_shape=(90, 360, 3),
                 num_waypoints: int = 5):
        self.time_horizon = time_horizon
        self.num_waypoints = num_waypoints
        self.action_space = spaces.Box(low=-1.0, high=1.0, shape=(2,))
        # past_control (throttle, brake, steer, reverse) and command (the
        # RoadOption one-hot) are the reference fake env's extra keys
        # (core/carla_agent.py:36-43); the network reads only its own keys
        self.observation_space = spaces.Dict(
            road=spaces.Box(low=0.0, high=1.0, shape=(9,)),
            vehicle=spaces.Box(low=0.0, high=1.0, shape=(4,)),
            past_control=spaces.Box(low=-1.0, high=1.0, shape=(4,)),
            command=spaces.Box(low=0.0, high=1.0, shape=(7,)),
            image=spaces.Box(low=-1.0, high=1.0, shape=image_shape),
            navigation=spaces.Box(low=0.0, high=25.0, shape=(num_waypoints,)),
        )

    def sample_stacked_obs(self, batch: int = 1, device=None) -> dict:
        """A zeros observation dict in the (B, T, ...) layout the agent's
        network takes, keys prefixed state_ as in the reference's batches,
        and a zeros (B, 2) action."""
        T = self.time_horizon
        out = {f"state_{name}": torch.zeros((batch, T) + tuple(space.shape), device=device)
               for name, space in self.observation_space.items()}
        out["action"] = torch.zeros((batch,) + tuple(self.action_space.shape), device=device)
        return out

    def step(self, action):
        pass

    def reset(self):
        pass

    def render(self, mode="human"):
        pass
