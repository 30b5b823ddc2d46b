"""carla_driving_rl_agent_torch — the PyTorch/CUDA port of
carla_driving_rl_agent_tpu for one NVIDIA H100.

The JAX package beside it is the reference; this package imports nothing of
it (nor jax, flax, optax or msgpack) and keeps its own copies of the numpy
host modules it needs (envs/town.py, native/route_planner.cpp).

Layout mirrors the JAX package so that each module has an obvious
counterpart:
  envs/       — towns, routes, weather, dynamics, the batched world, CARLAEnv
                and its variants, spaces, sensors; the toy and fake envs
  ops/        — the CUDA kernels' wrappers (render, physics, ShuffleNet unit)
                and their plain PyTorch versions; the analytic renderer
  models/     — ShuffleNetV2 + feature nets + GRUs + Beta policy; the
                generic MLP networks with Gaussian and Categorical heads
  augment/    — the image augmentations and the learner's training pipeline
  agents/     — CARLAgent: rollouts, the PPO learner, the evaluation; the
                generic PPOAgent and RandomAgent
  parallel/   — data parallelism over worlds (torch.distributed)
  curriculum/ — the five stages and the one-town evaluation
  utils/      — activations, checkpoints, kernel builds, math, optimizers,
                schedules, summaries, profiling, FLOP counts
  native/     — the C++ route planner (g++, ctypes)
  csrc/       — CUDA C++ kernels (nvcc, ctypes)

Entry points run on CUDA; the CPU is used only when the caller passes
device="cpu" (the tests do).  There is no fallback from one to the other.
"""

from __future__ import annotations

import os

import torch

__version__ = "0.1.0"

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when no GPU is present and none was asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def __getattr__(name):
    """Lazy top-level exports (the JAX package's __init__.py:59-81) without
    import-time cost."""
    lazy = {
        "CARLAgent": "carla_driving_rl_agent_torch.agents.carla_agent",
        "CARLAgentConfig": "carla_driving_rl_agent_torch.agents.carla_agent",
        "PPOAgent": "carla_driving_rl_agent_torch.agents.ppo",
        "PPOConfig": "carla_driving_rl_agent_torch.agents.ppo",
        "RandomAgent": "carla_driving_rl_agent_torch.agents.base",
        "Agent": "carla_driving_rl_agent_torch.agents.base",
        "CARLAEnv": "carla_driving_rl_agent_torch.envs.carla_env",
        "CARLAEnvConfig": "carla_driving_rl_agent_torch.envs.carla_env",
        "FakeCARLAEnvironment": "carla_driving_rl_agent_torch.envs.fake",
        "CARLACollectWrapper": "carla_driving_rl_agent_torch.envs.wrappers",
        "CARLAPlayWrapper": "carla_driving_rl_agent_torch.envs.wrappers",
        "CARLABenchmark": "carla_driving_rl_agent_torch.envs.wrappers",
        "CARLANetwork": "carla_driving_rl_agent_torch.models.carla_network",
        "PPONetwork": "carla_driving_rl_agent_torch.models.networks",
        "Stage": "carla_driving_rl_agent_torch.curriculum.stages",
        "DynamicParameter": "carla_driving_rl_agent_torch.utils.schedules",
    }
    if name in lazy:
        import importlib
        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
