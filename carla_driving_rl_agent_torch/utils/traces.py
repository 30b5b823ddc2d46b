"""Experience traces: per-episode npz files of stacked observations,
actions, rewards and dones, written by the expert's collection
(envs/wrappers.CARLACollectWrapper) or the network's (CARLAgent.collect)
and read by the imitation (CARLAgent.imitate, curriculum/imitation.py).

Counterpart of carla_driving_rl_agent_tpu/utils/traces.py (reference
rl/utils.py:502-565), with the recording loop both writers share.  The file
names are `trace-{n}-{time}.npz`, read in the sorted order of their names
(so `trace-10` before `trace-2`), shuffled by random.Random(seed), as the
JAX package reads them.
"""

from __future__ import annotations

import os
import random as py_random
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch


def count_traces(traces_dir: str) -> int:
    if not os.path.isdir(traces_dir):
        return 0
    return len([f for f in os.listdir(traces_dir) if f.endswith(".npz")])


def load_traces(traces_dir: str, max_amount: Optional[int] = None,
                shuffle: bool = False, seed=None) -> Iterator[dict]:
    """The traces of `traces_dir` as dicts of numpy arrays: the sorted file
    names, shuffled by random.Random(seed) when asked, the first
    `max_amount`."""
    files = sorted(f for f in os.listdir(traces_dir) if f.endswith(".npz"))
    if shuffle:
        py_random.Random(seed).shuffle(files)
    if max_amount is not None:
        files = files[:max_amount]
    for fname in files:
        with np.load(os.path.join(traces_dir, fname)) as data:
            yield {k: data[k] for k in data.files}


def unpack_trace(trace: dict, unpack: bool = True):
    """(state, action, reward, done) of a trace, the state the dict of its
    `state_*` arrays (reference rl/utils.py:529-545)."""
    if not unpack:
        return trace
    state = {k: v for k, v in trace.items() if k.startswith("state_")}
    return state, trace.get("action"), trace.get("reward"), trace.get("done")


def record_steps(env, states, act: Callable, timesteps: int) -> Dict[str, np.ndarray]:
    """`timesteps` env steps of every world from `states`.  act(states,
    net_in) returns dict(env_action=the (B, A) action stepped, and the
    per-world records to keep, e.g. action, log_prob and value).  Returns
    (S, B, ...) numpy records: the observation before each step (the image
    as (obs * 255).astype(uint8), truncated, as the JAX package stores
    it), what act returned, the reward, done = terminated | truncated,
    speed and similarity."""
    recs = []
    obs = env.observe(states)
    for _ in range(timesteps):
        net_in = {f"state_{k}": v for k, v in obs.items()}
        net_in["action"] = states.last_action
        out = act(states, net_in)
        states, obs_next, reward, term, trunc, info = env.step(states, out.pop("env_action"))
        recs.append(dict(
            state_image=(obs["image"] * 255.0).to(torch.uint8),
            state_road=obs["road"], state_vehicle=obs["vehicle"],
            state_navigation=obs["navigation"], **out, reward=reward,
            done=(term | trunc).to(torch.float32), speed=info["speed"],
            similarity=info["similarity"]))
        obs = obs_next
    return {k: torch.stack([r[k] for r in recs]).cpu().numpy() for k in recs[0]}


def save_episodes(recs: Dict[str, np.ndarray], traces_dir: str, written: int,
                  episodes: int, keep: Callable[[float], bool]) -> int:
    """Each world's first episode of (S, B, ...) records, cut after its
    first done (or whole), written to `traces_dir` as
    trace-{n}-{time}.npz when keep(its total reward) holds, until
    `episodes` traces are written; `written` counts those before.  Returns
    the new count."""
    steps, n_worlds = recs["done"].shape
    for b in range(n_worlds):
        if written >= episodes:
            break
        done = recs["done"][:, b]
        end = int(np.argmax(done)) + 1 if done.any() else steps
        if not keep(float(recs["reward"][:end, b].sum())):
            continue
        trace = {k: np.asarray(v[:end, b]) for k, v in recs.items()}
        fname = f"trace-{written}-{time.strftime('%Y%m%d-%H%M%S')}.npz"
        np.savez_compressed(os.path.join(traces_dir, fname), **trace)
        written += 1
    return written
