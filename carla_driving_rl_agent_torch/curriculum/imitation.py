"""Imitation learning: the expert's trace collection, learning from traces,
and the steering-balanced sampling of traces.

Counterpart of carla_driving_rl_agent_tpu/curriculum/imitation.py
(reference core/learning.py:196-304).
"""

from __future__ import annotations

import os

import numpy as np

from carla_driving_rl_agent_torch.curriculum.stages import build_env, define_env
from carla_driving_rl_agent_torch.envs.wrappers import CARLACollectWrapper
from carla_driving_rl_agent_torch.utils import traces as trace_io


def collect_experience(episodes: int, timesteps: int, threshold: float = 0.0,
                       ignore_traffic_light: bool = True, traces_dir: str = "traces",
                       behaviour: str = "normal", name: str = "collect", num_envs: int = 8,
                       **env_kwargs) -> int:
    """The privileged expert drives `episodes` episodes into
    traces_dir/name (reference core/learning.py:196-212); episodes whose
    total reward is below timesteps * threshold are dropped.  `env_kwargs`
    go to define_env (e.g. town, spawn, device).  Returns the number of
    traces written."""
    if behaviour not in ("cautious", "normal", "aggressive"):
        raise ValueError(f"behaviour {behaviour!r}")
    if not 0.0 <= threshold <= 1.0:
        raise ValueError(f"threshold {threshold} is not in [0, 1]")
    env = build_env(**define_env(**env_kwargs))
    wrapper = CARLACollectWrapper(env, ignore_traffic_light=ignore_traffic_light,
                                  traces_dir=traces_dir, name=name, behaviour=behaviour,
                                  num_envs=num_envs)
    return wrapper.collect(episodes, timesteps, episode_reward_threshold=threshold)


def imitation_learning(batch_size: int = 64, lr: float = 1e-3, epochs: int = 1,
                       load: bool = False, name: str = "imitation", time_horizon: int = 4,
                       traces_dir: str = "traces", weights_dir=None, device=None,
                       **kwargs) -> list:
    """Train an agent `name` from the traces of traces_dir/name and save it
    (reference core/learning.py:215-227): the three learning rates `lr`,
    the other CARLAgentConfig fields from `kwargs`; `load` starts from the
    agent's checkpoint.  Checkpoints go under `weights_dir` (default
    weights-torch/).  Returns the losses of every step."""
    from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
    env = build_env(**define_env(time_horizon=time_horizon), device=device)
    cfg = CARLAgentConfig(batch_size=batch_size, policy_lr=lr, value_lr=lr, dynamics_lr=lr,
                          **{k: v for k, v in kwargs.items()
                             if k in CARLAgentConfig.__dataclass_fields__})
    agent = CARLAgent(env, cfg, name=name, weights_dir=weights_dir)
    if load:
        agent.load()
    losses = agent.imitate(epochs=epochs, batch_size=batch_size,
                           traces_dir=os.path.join(traces_dir, name))
    agent.save()
    return losses


def explore_traces(traces_dir: str, amount: int = 64, seed=None,
                   steering_threshold: float = 0.1) -> dict:
    """Up to `amount` samples each of left, centre and right steering with
    a forward throttle (reference core/learning.py:230-304): the traces in
    load_traces' shuffled order, each one's forward samples in a
    permutation of numpy.random.default_rng(seed).  Returns dict(state
    {state_*: ...}, action, reward)."""
    rng = np.random.default_rng(seed)
    amounts = dict(left=amount, right=amount, center=amount)
    buckets = {k: dict(state={}, action=[], reward=[]) for k in amounts}

    for trace in trace_io.load_traces(traces_dir, shuffle=True, seed=seed):
        if all(v <= 0 for v in amounts.values()):
            break
        actions = np.asarray(trace["action"])
        rewards = np.asarray(trace["reward"])
        state = {k: np.asarray(v) for k, v in trace.items() if k.startswith("state_")}
        # forward throttle only (filter_throttle, :235-240)
        idx_all = np.nonzero(actions[:, 0] >= 0.0)[0]
        rng.shuffle(idx_all)
        t = steering_threshold
        masks = dict(left=actions[:, 1] <= -t, right=actions[:, 1] >= t,
                     center=(actions[:, 1] > -t) & (actions[:, 1] < t))
        for k, mask in masks.items():
            take = [i for i in idx_all if mask[i]][:max(amounts[k], 0)]
            if not take:
                continue
            amounts[k] -= len(take)
            b = buckets[k]
            for sk, sv in state.items():
                b["state"].setdefault(sk, []).append(sv[take])
            b["action"].append(actions[take])
            b["reward"].append(rewards[take])

    out = dict(state={}, action=[], reward=[])
    for b in buckets.values():
        if not b["action"]:
            continue
        for sk, chunks in b["state"].items():
            out["state"].setdefault(sk, []).append(np.concatenate(chunks))
        out["action"].append(np.concatenate(b["action"]))
        out["reward"].append(np.concatenate(b["reward"]))
    out["state"] = {k: np.concatenate(v) for k, v in out["state"].items()}
    out["action"] = np.concatenate(out["action"]) if out["action"] else np.zeros((0, 2))
    out["reward"] = np.concatenate(out["reward"]) if out["reward"] else np.zeros(0)
    return out
