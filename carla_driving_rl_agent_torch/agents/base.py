"""Agent base and the RandomAgent baseline.

Counterpart of carla_driving_rl_agent_tpu/agents/base.py (reference
rl/agents/agents.py: `Agent` — seeding :61-72, specs :31-32, config
persistence :181-203, `test()` :144-153 — and `RandomAgent` :218-298, the
untrained statistical baseline of the paper's evaluation).  Every random
draw comes from the agent's torch.Generator.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from carla_driving_rl_agent_torch import REPO_ROOT, resolve_device
from carla_driving_rl_agent_torch.envs import spaces
from carla_driving_rl_agent_torch.utils.summary import Summary

# the port's checkpoints; the tracked weights/ holds the JAX package's
DEFAULT_WEIGHTS_DIR = os.path.join(REPO_ROOT, "weights-torch")


class Agent:
    """Host-side base: seeding, spaces and specs, paths, config.json and
    the Summary.  Runs on CUDA unless `device` names another."""

    def __init__(self, env, name: str = "agent", batch_size: int = 64,
                 seed: Optional[int] = None, weights_dir: Optional[str] = None,
                 log_mode: Optional[str] = "summary", summary_keys=None,
                 log_dir: str = "logs", device=None, **kwargs):
        self.env = env
        self.name = name
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.base_path = os.path.join(weights_dir or DEFAULT_WEIGHTS_DIR, name)
        self.evaluation_path = os.path.join(self.base_path, "evaluation")
        self.config_path = os.path.join(self.base_path, "config.json")
        self.config_data: dict = {}  # the persisted config.json
        self.summary = Summary(mode=log_mode, name=name, log_dir=log_dir,
                               summary_keys=summary_keys)
        self.seed = None
        self.set_random_seed(seed if seed is not None else 42)
        self.state_spec = spaces.space_to_flat_spec(env.observation_space, "state")
        self.action_spec = spaces.space_to_flat_spec(env.action_space, "action")

    def set_random_seed(self, seed: int):
        """Seed the agent's generator (reference rl/agents/agents.py:61-72):
        one generator determines every draw of the agent."""
        self.seed = int(seed) % (2 ** 32)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def log(self, **kwargs):
        self.summary.log(**kwargs)

    def write_summaries(self):
        self.summary.write_summaries()

    def update_config(self, **kwargs):
        self.config_data.update(kwargs)

    def save_config(self):
        os.makedirs(self.base_path, exist_ok=True)
        with open(self.config_path, "w") as f:
            json.dump(self.config_data, f, indent=2)

    def load_config(self):
        if os.path.exists(self.config_path):
            with open(self.config_path) as f:
                self.config_data = json.load(f)

    @classmethod
    def test(cls, args: dict, network_summary: bool = False, **kwargs):
        """Rapid testing harness (reference rl/agents/agents.py:144-153)."""
        agent = cls(**args)
        if network_summary and hasattr(agent, "summary_str"):
            print(agent.summary_str())
        agent.learn(**kwargs)
        return agent


class RandomAgent(Agent):
    """Uniform-random baseline (reference rl/agents/agents.py:218-298), the
    'untrained' control agent of the paper's evaluation tables."""

    def __init__(self, env, name: str = "random-agent", **kwargs):
        super().__init__(env, name=name, **kwargs)

    def act(self, gen: torch.Generator, batch: int = 1) -> torch.Tensor:
        """`batch` actions uniform over the env's Box, from `gen`."""
        space = self.env.action_space
        low = torch.tensor(space.low, device=gen.device)
        high = torch.tensor(space.high, device=gen.device)
        u = torch.rand((batch,) + tuple(space.shape), generator=gen, device=gen.device)
        return low + u * (high - low)

    @torch.no_grad()
    def evaluate(self, episodes: int = 10, timesteps: int = 200, seed: int = 42) -> dict:
        """Random rollouts of `episodes` environments at once for
        `timesteps` steps, each environment's first episode scored; every
        draw (resets, actions) from a generator seeded with `seed`.
        Returns the per-episode total rewards, their mean and std."""
        env = self.env
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        states, _ = env.reset_batch(gen, episodes)
        total = torch.zeros(episodes, device=self.device)
        active = torch.ones(episodes, device=self.device)
        for _ in range(timesteps):
            actions = self.act(gen, episodes)
            states, _, reward, term, trunc, _ = env.step(states, actions, gen=gen)
            total = total + reward * active
            active = active * (1.0 - (term | trunc).to(torch.float32))
        rewards = total.cpu().numpy()
        return dict(episode_rewards=rewards.tolist(), mean=float(rewards.mean()),
                    std=float(rewards.std()))
