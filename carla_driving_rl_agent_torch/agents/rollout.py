"""Rollouts: lock-step trajectory collection over a batch of worlds.

Counterpart of carla_driving_rl_agent_tpu/agents/rollout.py (the
reference's PPOMemory, rl/agents/ppo.py:629-754): Python loops take the
place of `lax.scan`, and the per-step records are stacked into (S, B, ...)
tensors at the end.

Image frames are stored once: the observation stack changes only when a
frame is pushed, so the trajectory keeps each pushed frame plus per-step
stack ids, and the minibatch assembly gathers the T frames of a sample
(gather_image_stacks).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from carla_driving_rl_agent_torch.envs.carla_env import (
    CARLAEnv, EnvState, convert_action, newest_frame, ordered_image_stack)


class Trajectory(NamedTuple):
    """Per-step rollout records, shapes (S, B, ...)."""
    road: torch.Tensor          # (S, B, T, 9)
    vehicle: torch.Tensor       # (S, B, T, 4)
    navigation: torch.Tensor    # (S, B, T, N)
    stack_ids: torch.Tensor     # (S, B, T) frame ids (-T..S)
    frames: torch.Tensor        # (F, B, C, SH, SW) uint8 planar, one per push
    init_stack: torch.Tensor    # (T, B, C, SH, SW) uint8 planar, the stacks at rollout start
    action: torch.Tensor        # (S, B, A) raw Beta samples in [0, 1]
    log_prob: torch.Tensor      # (S, B, A)
    value: torch.Tensor         # (S, B, 2) (base, exp)
    reward: torch.Tensor        # (S, B)
    terminated: torch.Tensor    # (S, B) float
    truncated: torch.Tensor     # (S, B) float
    speed: torch.Tensor         # (S, B) km/h (aux target, env info)
    similarity: torch.Tensor    # (S, B) (aux target, env info)
    # 1.0 where a block sub-step's recorded observation predates a mid-block
    # auto-reset: it pairs the old episode's observation with the new
    # episode's reward, and the learner zeroes its advantage
    # (CARLAgentConfig.mask_post_reset).  All zero on the per-step path.
    post_reset: torch.Tensor    # (S, B)


def _start(env: CARLAEnv, env_states: EnvState):
    """Normalise the circular stacks to their ordered, masked view and
    relabel their ids -T..-1, so that stored ids are rollout-local.  The
    ordered view is a fresh tensor the rollout owns (the block push writes
    into it); init_stack is a copy of it."""
    T = env.config.time_horizon
    ordered = ordered_image_stack(env_states.image_stack, env_states.stack_ids,
                                  env_states.stack_slot)
    init_stack = ordered.transpose(0, 1).contiguous()          # (T, B, C, SH, SW)
    B = ordered.shape[0]
    dev = ordered.device
    start_ids = torch.arange(-T, 0, device=dev).repeat(B, 1)
    return init_stack, env_states._replace(
        image_stack=ordered, stack_ids=start_ids,
        stack_slot=torch.full((B,), T - 1, dtype=torch.int64, device=dev))


def _net_input(env: CARLAEnv, states: EnvState):
    obs = env.observe(states)
    net_in = {f"state_{k}": v for k, v in obs.items()}
    net_in["action"] = states.last_action
    return obs, net_in


def _stack(records: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([r[k] for r in records]) for k in records[0]}


def run_rollout(env: CARLAEnv, predict_fn: Callable, env_states: EnvState,
                num_steps: int, expert_fn: Optional[Callable] = None):
    """`num_steps` lock-step transitions of all worlds, one network forward
    pass and one env step (one rendered frame) per step: the per-step path
    (JAX run_rollout, rollout.py:49).  predict_fn(net_in) returns a dict
    with action (B, A) in [0, 1], log_prob (B, A) and value (B, 2).

    With `expert_fn` (the device-resident imitation, JAX rollout.py:66-75),
    the actions come from the privileged expert: expert_fn(env_states)
    gives (B, 2) env actions in [-1, 1], the recorded action is
    (action + 1) / 2, and predict_fn(net_in, action01) returns the old
    policy's log_prob of it and the value; nothing is sampled.
    Returns (env_states', Trajectory, final_obs)."""
    init_stack, states = _start(env, env_states)
    records, frames = [], []
    for step in range(num_steps):
        obs, net_in = _net_input(env, states)
        if expert_fn is None:
            pred = predict_fn(net_in)
            action01 = pred["action"]
        else:
            action01 = (expert_fn(states) + 1.0) / 2.0
            pred = predict_fn(net_in, action01)
        new_states, _, reward, term, trunc, info = env.step(
            states, convert_action(action01), frame_id=step)
        new_states = new_states._replace(last_action=action01)
        frames.append(newest_frame(new_states.image_stack, new_states.stack_slot))
        records.append(dict(
            road=obs["road"], vehicle=obs["vehicle"], navigation=obs["navigation"],
            stack_ids=states.stack_ids, action=action01, log_prob=pred["log_prob"],
            value=pred["value"], reward=reward,
            terminated=term.to(torch.float32), truncated=trunc.to(torch.float32),
            speed=info["speed"], similarity=info["similarity"],
            post_reset=torch.zeros_like(reward)))
        states = new_states
    traj = Trajectory(init_stack=init_stack, frames=torch.stack(frames),
                      **_stack(records))
    return states, traj, env.observe(states)


def run_rollout_blocks(env: CARLAEnv, predict_fn: Callable, env_states: EnvState,
                       num_steps: int, block_size: Optional[int] = None):
    """Block rollout (JAX run_rollout_blocks, rollout.py:142-247): one
    network forward pass and one rendered frame per `block_size` steps
    (default past_obs_freq).  predict_fn(net_in, n) returns action and
    log_prob with a leading (n,) axis and value (B, 2): the stacked
    observation is constant between pushes, so n draws from one forward
    pass match n per-step predicts in distribution.

    Each block runs `block_size` physics ticks in one call
    (env.step_physics_block: one physics-kernel launch with fused_step, the
    block's reset draws in one generator call) and one push
    (env.push_block_frame_batch, one render launch).  Sub-steps after a
    mid-block auto-reset record the old episode's observation with the new
    episode's reward; they are flagged in Trajectory.post_reset.  Returns
    (env_states', Trajectory, final_obs) with (S, B) per-step records and
    one frame per block."""
    block = block_size or env.config.past_obs_freq
    if num_steps % block:
        raise ValueError(f"num_steps {num_steps} is not a multiple of the block {block}")
    T = env.config.time_horizon
    init_stack, states = _start(env, env_states)
    slot = T - 1                       # every world's newest frame, tracked on the host
    B = init_stack.shape[1]
    zero_row = torch.zeros((1, B), dtype=torch.float32, device=init_stack.device)
    records, frames = [], []
    for b in range(num_steps // block):
        obs_ids = states.stack_ids
        obs, net_in = _net_input(env, states)
        pred = predict_fn(net_in, block)
        action01 = pred["action"]                                  # (block, B, A)
        states, reward, term, trunc, info, did_reset = env.step_physics_block(
            states, convert_action(action01))
        states = states._replace(last_action=action01[-1])
        # a sub-step is mismatched iff a reset happened at an EARLIER
        # sub-step of this block
        seen = torch.cumsum(did_reset, dim=0) > 0
        per_block = lambda t: t.unsqueeze(0).expand((block,) + tuple(t.shape))
        records.append(dict(
            road=per_block(obs["road"]), vehicle=per_block(obs["vehicle"]),
            navigation=per_block(obs["navigation"]), stack_ids=per_block(obs_ids),
            action=action01, log_prob=pred["log_prob"], value=per_block(pred["value"]),
            reward=reward, terminated=term.to(torch.float32),
            truncated=trunc.to(torch.float32), speed=info["speed"],
            similarity=info["similarity"],
            post_reset=torch.cat([zero_row, seen[:-1].to(torch.float32)])))
        states = env.push_block_frame_batch(states, seen[-1], frame_ids=b, slot=slot)
        slot = (slot + 1) % T
        frames.append(newest_frame(states.image_stack, states.stack_slot))
    traj = Trajectory(init_stack=init_stack, frames=torch.stack(frames),
                      **{k: torch.cat([r[k] for r in records]) for k in records[0]})
    return states, traj, env.observe(states)


def frame_timeline(traj: Trajectory) -> torch.Tensor:
    """(T + F, B, C, SH, SW): the frames of ids -T..-1 (init_stack) then
    0..F-1 (frames), the table gather_image_stacks indexes."""
    return torch.cat([traj.init_stack, traj.frames], dim=0)


def gather_image_stacks(traj: Trajectory, sample_step: torch.Tensor,
                        sample_env: torch.Tensor,
                        timeline: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(mb, T, C, SH, SW) planar image stacks of the given samples.  Ids
    below -T are the zero-frame sentinel of episodes reset mid-rollout.
    `timeline` is frame_timeline(traj), computed once per update by the
    learner."""
    T = traj.init_stack.shape[0]
    frames_all = frame_timeline(traj) if timeline is None else timeline
    ids = traj.stack_ids[sample_step, sample_env]               # (mb, T)
    idx = torch.clamp(ids + T, 0, frames_all.shape[0] - 1)
    frames = frames_all[idx, sample_env[:, None]]               # (mb, T, C, SH, SW)
    keep = (ids >= -T).to(frames.dtype)
    return frames * keep[..., None, None, None]
