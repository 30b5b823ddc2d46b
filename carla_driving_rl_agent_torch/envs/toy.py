"""A tiny batched control env for the generic (non-CARLA) agents.

Counterpart of carla_driving_rl_agent_tpu/envs/toy.py: a 2D point mass must
reach a goal (the role of the gym environments the reference's generic
PPOAgent trains on, rl/agents/agents.py:22-25).  The state holds a batch of
environments, each row one of them.  The random draws stay apart from the
computation: `reset_draws` draws the fresh episodes' positions and goals
from an explicit generator, and `reset` and `step` take them, so that a
test can feed the draws the JAX env takes from each state's own key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from carla_driving_rl_agent_torch.envs import spaces


class PointNavState(NamedTuple):
    pos: torch.Tensor    # (B, 2)
    vel: torch.Tensor    # (B, 2)
    goal: torch.Tensor   # (B, 2)
    t: torch.Tensor      # (B,) int64


class PointNavDraws(NamedTuple):
    """The draws of fresh episodes: start position and goal, (B, 2) each,
    uniform in [-arena, arena)."""
    pos: torch.Tensor
    goal: torch.Tensor


class PointNavEnv:
    """Point mass with velocity control; reward = progress toward the goal
    (times 10), plus 10 on arrival within 0.3."""

    def __init__(self, max_steps: int = 100, arena: float = 5.0):
        self.max_steps = max_steps
        self.arena = arena
        self.action_space = spaces.Box(low=-1.0, high=1.0, shape=(2,))
        self.observation_space = spaces.Box(low=-arena, high=arena, shape=(6,))

    def _obs(self, s: PointNavState) -> torch.Tensor:
        return torch.cat([s.pos, s.goal - s.pos, s.vel], dim=-1)

    def reset_draws(self, gen: torch.Generator, n: int) -> PointNavDraws:
        """`n` fresh episodes' draws from `gen`, on its device."""
        u = torch.rand((2, n, 2), generator=gen, device=gen.device)
        lo, hi = -self.arena, self.arena
        return PointNavDraws(pos=lo + u[0] * (hi - lo), goal=lo + u[1] * (hi - lo))

    def reset(self, draws: PointNavDraws):
        """Fresh episodes from `draws`.  Returns (state, obs)."""
        state = PointNavState(pos=draws.pos, vel=torch.zeros_like(draws.pos),
                              goal=draws.goal,
                              t=torch.zeros(draws.pos.shape[0], dtype=torch.int64,
                                            device=draws.pos.device))
        return state, self._obs(state)

    def reset_batch(self, gen: torch.Generator, n: int):
        return self.reset(self.reset_draws(gen, n))

    def step(self, state: PointNavState, action: torch.Tensor,
             draws: Optional[PointNavDraws] = None, gen: Optional[torch.Generator] = None):
        """One step of every environment, with auto-reset: an environment
        that arrived or ran out of time restarts from its row of `draws`
        (drawn from `gen` when not given).  Returns (state', obs, reward,
        terminated, truncated, info {distance})."""
        vel = 0.8 * state.vel + 0.2 * torch.clamp(action, -1.0, 1.0)
        pos = torch.clamp(state.pos + vel * 0.5, -self.arena, self.arena)
        d_old = torch.linalg.vector_norm(state.goal - state.pos, dim=-1)
        d_new = torch.linalg.vector_norm(state.goal - pos, dim=-1)
        reward = (d_old - d_new) * 10.0
        arrived = d_new < 0.3
        reward = reward + torch.where(arrived, 10.0, 0.0)
        t = state.t + 1
        term = arrived
        trunc = (t >= self.max_steps) & ~term
        if draws is None:
            draws = self.reset_draws(gen, pos.shape[0])
        fresh, _ = self.reset(draws)
        done = term | trunc
        stepped = PointNavState(pos=pos, vel=vel, goal=state.goal, t=t)
        new_state = PointNavState(*(
            torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(fresh, stepped)))
        return new_state, self._obs(new_state), reward, term, trunc, dict(distance=d_new)
