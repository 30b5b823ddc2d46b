"""Core RL math on PyTorch tensors.

Counterpart of carla_driving_rl_agent_tpu/utils/math.py (formulas from the
reference: GAE and returns rl/utils.py:57-84 and rl/agents/ppo.py:692-727,
decompose_number rl/utils.py:140-151, sp_norm rl/utils.py:344-349,
kl_divergence rl/utils.py:459-464, per-tensor gradient clipping
rl/utils.py:120-121, polyak averaging rl/utils.py:105-117, the
single-trajectory discount_cumsum / gae / rewards_to_go rl/utils.py:57-84,
normalize_tensor rl/utils.py:338-341, cosine_similarity
rl/environments/carla/tools/utils.py:30-67).  The recurrences run as Python
loops over the rollout's steps, in the JAX scans' operation order (the
JAX discount_cumsum is an associative scan: the same sums in another
order).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


EPSILON = 1e-7  # the reference's clip and normalisation bound


def discount_cumsum(x: torch.Tensor, discount: float) -> torch.Tensor:
    """Reverse discounted cumulative sum along axis 0:
    y[t] = x[t] + discount * y[t + 1]
    (scipy.signal.lfilter([1], [1, -discount], x[::-1])[::-1])."""
    x = torch.as_tensor(x, dtype=torch.float32)
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for t in range(x.shape[0] - 1, -1, -1):
        carry = x[t] + discount * carry
        out[t] = carry
    return out


def rewards_to_go(rewards: torch.Tensor, discount: float) -> torch.Tensor:
    """Discounted returns of `rewards` with the bootstrap value appended,
    the bootstrap element dropped (reference rl/utils.py:75-84)."""
    return discount_cumsum(rewards, discount)[:-1]


def gae(rewards: torch.Tensor, values: torch.Tensor, gamma: float, lambda_: float,
        normalize: bool = False) -> torch.Tensor:
    """Generalized Advantage Estimation over one trajectory: `rewards` and
    `values` of length T + 1, the bootstrap appended (reference
    rl/utils.py:62-72)."""
    deltas = rewards[:-1] + gamma * values[1:] - values[:-1]
    adv = deltas if lambda_ == 0.0 else discount_cumsum(deltas, gamma * lambda_)
    return normalize_tensor(adv) if normalize else adv


def normalize_tensor(x: torch.Tensor, eps: float = EPSILON) -> torch.Tensor:
    """Zero mean, unit (population) standard deviation."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return (x - torch.mean(x)) / (torch.std(x, correction=0) + eps)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """cos(a, b) along `dim`, the norms' product floored at eps."""
    na = torch.linalg.vector_norm(a, dim=dim)
    nb = torch.linalg.vector_norm(b, dim=dim)
    return torch.sum(a * b, dim=dim) / torch.clamp(na * nb, min=eps)


def batched_gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
                bootstrap_value: torch.Tensor, gamma: float,
                lambda_: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked GAE and lambda-returns over (S, B) rollouts whose episodes end
    mid-rollout:
        delta_t = r_t + gamma * V_{t+1} * (1 - done_t) - V_t
        A_t     = delta_t + gamma * lambda * (1 - done_t) * A_{t+1}
    Truncated episodes have gamma * V folded into r_t by the caller.
    Returns (advantages, advantages + values), both (S, B)."""
    done = dones.to(torch.float32)
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + gamma * next_values * (1.0 - done) - values
    adv = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    gl = gamma * lambda_
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gl * (1.0 - done[t]) * carry
        adv[t] = carry
    return adv, adv + values


def discounted_returns(rewards: torch.Tensor, dones: torch.Tensor,
                       bootstrap_value: torch.Tensor, gamma: float) -> torch.Tensor:
    """Rewards-to-go with per-step episode masks, bootstrapped after the
    last step: ret_t = r_t + gamma * (1 - done_t) * ret_{t+1}."""
    out = torch.empty_like(rewards)
    carry = bootstrap_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + gamma * (1.0 - dones[t]) * carry
        out[t] = carry
    return out


def sp_norm(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Sign-preserving max-normalisation: positives over max(x) + eps,
    negatives over -(min(x) - eps)."""
    positives = x * (x > 0.0)
    negatives = x * (x < 0.0)
    return positives / (torch.max(x) + eps) + negatives / -(torch.min(x) - eps)


def decompose_number(num: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """n = base * 10^exp with |base| <= 1: exp = max(0, ceil(log10|n|)),
    with log10 values within 1e-6 of an integer snapped to it."""
    mag = torch.abs(num)
    safe = torch.clamp(mag, min=1e-30)
    lg = torch.log10(safe)
    near_int = torch.abs(lg - torch.round(lg)) < 1e-6
    exp = torch.where(mag > 1.0, torch.where(near_int, torch.round(lg), torch.ceil(lg)),
                      torch.zeros_like(mag))
    return num / torch.pow(10.0, exp), exp


def compose_number(base: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """Inverse of decompose_number: base * 10^exp."""
    return base * torch.pow(10.0, exp)


def kl_divergence(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """The reference's pointwise KL surrogate."""
    return log_a * (log_a - log_b)


def clip_by_norm(x: torch.Tensor, norm: float) -> torch.Tensor:
    """One tensor scaled to Euclidean norm at most `norm`
    (tf.clip_by_norm)."""
    n = torch.linalg.vector_norm(x)
    scale = torch.clamp(norm / torch.clamp(n, min=1e-12), max=1.0)
    return x * scale


def clip_gradients(grads: Sequence[torch.Tensor], norm: float) -> List[torch.Tensor]:
    """Clip EACH gradient tensor to `norm` on its own (the reference clips
    per tensor, not by the global norm), after scrubbing non-finite entries
    to 0: a degenerate batch (a constant image stream through 16
    BatchNorms) can overflow the backward pass, and inf * 0 would poison
    the parameters.  Neither half may be simplified away (JAX
    utils/math.py:163-185)."""
    sizes = [g.numel() for g in grads]
    # one flat buffer, so that the scrub and the scaling are one launch each
    flat = torch.nan_to_num(torch.cat([g.reshape(-1) for g in grads]),
                            nan=0.0, posinf=0.0, neginf=0.0)
    norms = torch.stack(torch._foreach_norm(flat.split(sizes)))
    scales = torch.clamp(norm / torch.clamp(norms, min=1e-12), max=1.0)
    reps = torch.tensor(sizes, device=flat.device)
    flat = flat * torch.repeat_interleave(scales, reps, output_size=flat.numel())
    return [part.view_as(g) for part, g in zip(flat.split(sizes), grads)]


@torch.no_grad()
def polyak_average_(new: Sequence[torch.Tensor], old: Sequence[torch.Tensor],
                    alpha: float) -> None:
    """new <- alpha * new + (1 - alpha) * old, in place."""
    for n, o in zip(new, old):
        n.copy_(alpha * n + (1.0 - alpha) * o)
